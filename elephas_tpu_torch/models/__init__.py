"""Model constructors of the port: the reference's zoo
(``elephas_tpu/models/``) but for the Switch transformers."""

from elephas_tpu_torch.models.convnet import cifar10_cnn  # noqa: F401
from elephas_tpu_torch.models.lstm import imdb_lstm  # noqa: F401
from elephas_tpu_torch.models.mlp import mnist_mlp  # noqa: F401
from elephas_tpu_torch.models.resnet import resnet, resnet50  # noqa: F401
from elephas_tpu_torch.models.transformer import (  # noqa: F401
    FlashMHA,
    FusedLayerNorm,
    generate,
    transformer_classifier,
    transformer_lm,
)
