"""Model constructors of the port: the reference's zoo
(``elephas_tpu/models/``), the Switch mixture-of-experts transformers
included."""

from elephas_tpu_torch.models.convnet import cifar10_cnn  # noqa: F401
from elephas_tpu_torch.models.lstm import imdb_lstm  # noqa: F401
from elephas_tpu_torch.models.mlp import mnist_mlp  # noqa: F401
from elephas_tpu_torch.models.resnet import resnet, resnet50  # noqa: F401
from elephas_tpu_torch.models.switch import (  # noqa: F401
    MoeFFN,
    switch_transformer_classifier,
    switch_transformer_lm,
)
from elephas_tpu_torch.models.transformer import (  # noqa: F401
    FlashMHA,
    FusedLayerNorm,
    generate,
    transformer_classifier,
    transformer_lm,
)
