"""Data pipeline (counterpart of the JAX ``data/``): host-side decode and rescale,
the corpus caches, the streamed corpus and device prefetch.

Decode is host work; after one host-to-device copy a resident corpus stays on
the device. The reference's six-pickle scheme (dataset.py:166-193) is one
``.npz`` per corpus, in the JAX package's format, and the reference pickles
are still read. Imports no JAX.
"""

from artist_style_transfer_tpu_torch.data.datasets import (  # noqa: F401
    get_avg_dataset,
    get_content_dataset,
    get_painting_dataset,
    load_artist_names,
    rescale_image,
)
from artist_style_transfer_tpu_torch.data.prefetch import device_prefetch  # noqa: F401
from artist_style_transfer_tpu_torch.data.stream import content_file_stream  # noqa: F401
