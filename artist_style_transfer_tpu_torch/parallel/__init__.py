"""Data parallelism and row-sharded stylization on ``torch.distributed`` (counterpart
of the JAX ``parallel`` package).

One process drives one device; a :class:`Mesh` is the process group its ranks form.
Data-parallel training and evaluation shard each global batch over the 'data' axis
and all-reduce what JAX's GSPMD all-reduces (gradients, losses, batch-norm
statistics, int8 scales, correct counts); :mod:`parallel.spatial` spreads one
image's rows over the ranks, with explicit halo exchanges and all-reduced
instance-norm statistics. NCCL on the card; gloo where the caller names it.
"""

from artist_style_transfer_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_multihost,
    make_global,
    per_host_batch_slice,
)
from artist_style_transfer_tpu_torch.parallel.launch import launch  # noqa: F401
from artist_style_transfer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_batch,
    spatial_size,
)
