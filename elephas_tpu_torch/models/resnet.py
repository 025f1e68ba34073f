"""ResNet — counterpart of ``elephas_tpu/models/resnet.py``: bottleneck-v1
blocks (``_bottleneck`` ``:21``) under a 7×7/2 stem and a 3×3/2
max-pool, four stages of ``depths`` blocks of ``width·2^stage`` filters
(``resnet`` ``:44``; ``resnet50`` ``:100``), global average pooling, a
Dense head and a float32 softmax. Keras's ``SGD(lr, momentum=0.9)``.

The layer names are the reference's (``stem_conv``, ``stem_bn``,
``s{stage}_b{block}_{c1,bn1,c2,bn2,c3,bn3,sc_conv,sc_bn}``, ``head``), so
the Keras weights, BatchNorm's moving statistics among them, load by
path. Under ``mixed_bfloat16`` the convolutions, the pooling and the
``head`` run in bf16, BatchNorm keeps float32 statistics, and the softmax
(``probs``) is float32, as in the reference (``:79-80``). "same" padding
is Keras's, uneven where Keras's is (the stem at 224 pads (2, 3), the
stride-2 convolutions and the max-pool at even sizes (0, 1))."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch import training
from elephas_tpu_torch.models.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    batch_norm_paths,
    build_module,
    cast,
    conv_paths,
    dense_paths,
    max_pool,
    zoo_builder,
)
from elephas_tpu_torch.optimizers import SGD


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (stride, "same") → 1×1 expand (×4), each with
    BatchNorm, ReLU after the first two and after the residual sum; a 1×1
    projection with BatchNorm on the shortcut when the stride or the width
    changes."""

    def __init__(self, in_channels: int, filters: int, stride: int):
        super().__init__()
        out = filters * 4
        self.project = stride != 1 or in_channels != out
        if self.project:
            self.sc_conv = Conv2D(in_channels, out, 1, stride, bias=False)
            self.sc_bn = BatchNorm(out)
        self.c1 = Conv2D(in_channels, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.c2 = Conv2D(filters, filters, 3, stride, padding="same", bias=False)
        self.bn2 = BatchNorm(filters)
        self.c3 = Conv2D(filters, out, 1, bias=False)
        self.bn3 = BatchNorm(out)

    def forward(self, x):
        shortcut = self.sc_bn(self.sc_conv(x)) if self.project else x
        y = F.relu(self.bn1(self.c1(x)))
        y = F.relu(self.bn2(self.c2(y)))
        y = self.bn3(self.c3(y))
        return F.relu(cast(shortcut, y.dtype) + y)

    def keras_paths(self, name: str) -> dict:
        # in Keras's ``model.weights`` order (the layers as the graph
        # creates them), which ``get_weights()`` lists
        paths = {}
        for i in (1, 2):
            paths.update(conv_paths(f"{name}_c{i}", getattr(self, f"c{i}")))
            paths.update(batch_norm_paths(f"{name}_bn{i}", getattr(self, f"bn{i}")))
        if self.project:
            paths.update(conv_paths(f"{name}_sc_conv", self.sc_conv))
        paths.update(conv_paths(f"{name}_c3", self.c3))
        if self.project:
            paths.update(batch_norm_paths(f"{name}_sc_bn", self.sc_bn))
        paths.update(batch_norm_paths(f"{name}_bn3", self.bn3))
        return paths


class ResNet(nn.Module):
    """``[B, H, W, C]`` images → ``[B, num_classes]`` float32
    probabilities."""

    def __init__(self, input_shape, num_classes, depths, width):
        super().__init__()
        channels = input_shape[-1]
        self.name = f"resnet{sum(depths) * 3 + 2}"
        self.stem_conv = Conv2D(channels, width, 7, 2, padding="same", bias=False)
        self.stem_bn = BatchNorm(width)
        blocks, cin = {}, width
        for stage, n in enumerate(depths):
            filters = width * 2 ** stage
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks[f"s{stage}_b{b}"] = Bottleneck(cin, filters, stride)
                cin = filters * 4
        self.blocks = nn.ModuleDict(blocks)
        self.head = Dense(cin, num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC data as a channels-last [B, C, H, W] view
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = max_pool(x, 3, 2, padding="same")
        for block in self.blocks.values():
            x = block(x)
        x = x.mean(dim=(2, 3))  # global average pooling, in the compute dtype
        return torch.softmax(self.head(x).float(), dim=-1)

    def keras_paths(self) -> dict:
        paths = {**conv_paths("stem_conv", self.stem_conv),
                 **batch_norm_paths("stem_bn", self.stem_bn)}
        for name, block in self.blocks.items():
            paths.update(block.keras_paths(name))
        paths.update(dense_paths("head", self.head))
        return paths


@zoo_builder
def resnet(
    input_shape: tuple[int, int, int] = (224, 224, 3),
    num_classes: int = 1000,
    depths: tuple[int, ...] = (3, 4, 6, 3),
    width: int = 64,
    lr: float = 0.1,
    momentum: float = 0.9,
    dtype_policy: str | None = None,
    sparse_labels: bool = True,
    seed: int = 0,
    compile_model: bool = True,
    device=None,
):
    """General bottleneck ResNet (``depths=(3, 4, 6, 3), width=64`` is
    ResNet-50), in eval mode on ``device`` (``cuda:0`` by default) under
    ``dtype_policy``; with ``compile_model`` compiled with Keras's
    ``SGD(lr, momentum)``, sparse categorical cross-entropy (categorical
    with ``sparse_labels=False``) and ``accuracy``."""
    model = build_module(lambda: ResNet(tuple(input_shape), num_classes, tuple(depths), width),
                         seed, dtype_policy, device)
    if not compile_model:
        return model
    return training.compile_model(model, SGD(model.parameters(), lr=lr, momentum=momentum),
                                  training.classification_loss(sparse_labels), ["accuracy"])


@zoo_builder
def resnet50(
    input_shape: tuple[int, int, int] = (224, 224, 3),
    num_classes: int = 1000,
    **kwargs,
):
    return resnet(input_shape, num_classes, depths=(3, 4, 6, 3), width=64, **kwargs)
