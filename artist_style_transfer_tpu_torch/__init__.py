"""artist_style_transfer_tpu_torch — the PyTorch/CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``artist_style_transfer_tpu``,
with the same subpackage layout (``ops``, ``models``, ``infer``, ``train``,
``data``, ``parallel``, ``diffusion``, ``utils``) so that every module here has
exactly one counterpart there.
It imports ``torch`` and never ``jax`` or the JAX package.

Conventions:

- Public entry points take and return what the JAX package does: images
  are **NHWC**, **BGR**, [0, 255], float32 (uint8 accepted at the stylize
  entry). Inside, tensors are NCHW in the ``channels_last`` memory format,
  so a VGG tap's NHWC view is contiguous.
- Weights are torch-native (OIHW convs, IOHW transpose convs) under the
  reference state-dict key names, so loading a reference ``.pth`` is
  ``load_state_dict``.
- Every entry point takes ``device``: ``None`` means ``"cuda"`` and raises
  when CUDA is absent; the CPU is used only when the caller passes
  ``device="cpu"``.
- Data parallelism and row-sharded stylization run on ``torch.distributed``, one
  process a device (:mod:`artist_style_transfer_tpu_torch.parallel`): NCCL on the
  card, gloo where the caller names it; ``make_mesh`` is re-exported here.
- Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc``
  at first use (:mod:`artist_style_transfer_tpu_torch.ops.cuda.build`).
  A kernel wrapper launches its kernel on a CUDA tensor or raises; the
  plain PyTorch version runs only for CPU tensors or when asked for.
"""

from artist_style_transfer_tpu_torch.parallel import Mesh, make_mesh  # noqa: F401
from artist_style_transfer_tpu_torch.utils.config import InferenceConfig, TrainConfig  # noqa: F401

__version__ = "0.1.0"
