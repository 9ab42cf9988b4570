"""Models of the port: TransformerNet, the VGG16 feature extractor and the ResNet-50
artist classifier, and their int8 forms; the re-exports of the JAX ``models`` package."""

from artist_style_transfer_tpu_torch.models.resnet import (  # noqa: F401
    ARTISTS_19,
    ResNet50Classifier,
    init_classifier,
    load_classifier,
)
from artist_style_transfer_tpu_torch.models.resnet_q import (  # noqa: F401
    QuantizedClassifier,
    classifier_apply_int8,
    quantize_classifier,
)
from artist_style_transfer_tpu_torch.models.transformer import (  # noqa: F401
    TRANSFORMER_PARAM_COUNT,
    TransformerNet,
    init_transformer,
)
from artist_style_transfer_tpu_torch.models.transformer_q import (  # noqa: F401
    QuantizedTransformerNet,
    calibrate_transformer,
    quantize_transformer,
    transformer_apply_int8,
)
from artist_style_transfer_tpu_torch.models.transformer_qat import transformer_apply_qat  # noqa: F401
from artist_style_transfer_tpu_torch.models.vgg import (  # noqa: F401
    VGG_LAYER_NAMES,
    QuantizedVGG16Features,
    VGG16Features,
    init_vgg16,
    quantize_vgg16_loss,
    vgg_is_quantized,
)
