"""CIFAR-10 convnet — counterpart of ``elephas_tpu/models/convnet.py``
(``cifar10_cnn``): two blocks of two 3×3 convolutions (32, then 64
filters; the first of each "same", the second "valid") with ReLU, 2×2
max-pooling and ``Dropout(0.25)``, then ``Flatten``, ``Dense(512)``,
``Dropout(0.5)`` and a softmax Dense. Keras's ``Adam(1e-3)``.

The input is NHWC, as the reference's data is. The convolutions run on
a channels-last ``[B, C, H, W]`` view, and ``Flatten`` flattens in NHWC
order, so the Dense kernel's rows are the Keras kernel's rows."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.models.layers import (
    Conv2D,
    Dense,
    Dropout,
    build_module,
    conv_paths,
    dense_paths,
    max_pool,
    zoo_builder,
)
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import classification_loss, compile_model


class Cifar10CNN(nn.Module):
    """``[B, H, W, C]`` floats → ``[B, num_classes]`` probabilities. The
    reference is a Keras ``Sequential`` named ``cifar10_cnn`` (layers
    ``conv2d`` … ``conv2d_3``, ``dense``, ``dense_1`` in a fresh
    process)."""

    keras_sequential = "cifar10_cnn"

    def __init__(self, input_shape, num_classes, seed):
        super().__init__()
        h, w, c = input_shape
        self.conv2d = Conv2D(c, 32, 3, padding="same")
        self.conv2d_1 = Conv2D(32, 32, 3)
        self.drop = Dropout(0.25, seed)
        self.conv2d_2 = Conv2D(32, 64, 3, padding="same")
        self.conv2d_3 = Conv2D(64, 64, 3)
        self.drop_1 = Dropout(0.25, seed + 1)
        # same, valid, 2x2 pool; twice
        h, w = (h - 2) // 2, (w - 2) // 2
        h, w = (h - 2) // 2, (w - 2) // 2
        self.dense = Dense(h * w * 64, 512)
        self.drop_2 = Dropout(0.5, seed + 2)
        self.dense_1 = Dense(512, num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC data as a channels-last [B, C, H, W] view
        x = F.relu(self.conv2d_1(F.relu(self.conv2d(x))))
        x = self.drop(max_pool(x, 2))
        x = F.relu(self.conv2d_3(F.relu(self.conv2d_2(x))))
        x = self.drop_1(max_pool(x, 2))
        x = x.permute(0, 2, 3, 1).flatten(1)  # Keras's Flatten: NHWC order
        x = self.drop_2(F.relu(self.dense(x)))
        return torch.softmax(self.dense_1(x), dim=-1)

    def keras_paths(self) -> dict:
        paths = {}
        for name in ("conv2d", "conv2d_1", "conv2d_2", "conv2d_3"):
            paths.update(conv_paths(f"cifar10_cnn/{name}", getattr(self, name)))
        for name in ("dense", "dense_1"):
            paths.update(dense_paths(f"cifar10_cnn/{name}", getattr(self, name)))
        return paths


@zoo_builder
def cifar10_cnn(
    input_shape: tuple[int, int, int] = (32, 32, 3),
    num_classes: int = 10,
    lr: float = 1e-3,
    sparse_labels: bool = True,
    seed: int = 0,
    device=None,
):
    """The convnet in eval mode on ``device`` (``cuda:0`` by default),
    compiled with Keras's ``Adam(lr)``, sparse categorical cross-entropy
    (categorical with ``sparse_labels=False``) and ``accuracy``."""
    model = build_module(lambda: Cifar10CNN(tuple(input_shape), num_classes, seed),
                         seed, None, device)
    return compile_model(model, Adam(model.parameters(), lr=lr),
                         classification_loss(sparse_labels), ["accuracy"])
