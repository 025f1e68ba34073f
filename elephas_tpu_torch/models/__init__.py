"""Model constructors of the port."""

from elephas_tpu_torch.models.transformer import (  # noqa: F401
    FlashMHA,
    FusedLayerNorm,
    generate,
    transformer_classifier,
    transformer_lm,
)
