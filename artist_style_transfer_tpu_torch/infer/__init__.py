"""Feed-forward stylization, classifier evaluation and serving; the re-exports of the JAX
``infer`` package that exist in the port.

``stylize`` is not re-exported here: the name stays the submodule
``infer.stylize`` (a re-exported function would shadow it, as the JAX package
notes in ``infer/evaluate.py``); import the function from that module.
"""

from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier  # noqa: F401
from artist_style_transfer_tpu_torch.infer.serve import (  # noqa: F401
    ModelRegistry,
    StylizeServer,
)
from artist_style_transfer_tpu_torch.infer.stylize import (  # noqa: F401
    load_transfer_params,
    stylize_batched,
    stylize_int8,
    stylize_spatial,
    stylize_spatial_int8,
)
