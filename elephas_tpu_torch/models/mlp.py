"""MNIST-style MLP — counterpart of ``elephas_tpu/models/mlp.py``
(``mnist_mlp``): 784 → 128 → 128 → 10, ReLU, ``Dropout(0.2)``, softmax,
Keras's ``Adam(1e-3)``."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.models.layers import (
    Dense,
    Dropout,
    build_module,
    dense_paths,
    zoo_builder,
)
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import classification_loss, compile_model


class MnistMLP(nn.Module):
    """``[B, input_dim]`` floats → ``[B, num_classes]`` probabilities. The
    reference is a Keras ``Sequential`` named ``mnist_mlp`` whose Dense
    layers are ``dense``, ``dense_1``, ``dense_2`` in a fresh process."""

    keras_sequential = "mnist_mlp"

    def __init__(self, input_dim, num_classes, hidden, dropout, seed):
        super().__init__()
        self.dense = Dense(input_dim, hidden)
        self.drop = Dropout(dropout, seed)
        self.dense_1 = Dense(hidden, hidden)
        self.drop_1 = Dropout(dropout, seed + 1)
        self.dense_2 = Dense(hidden, num_classes)

    def forward(self, x):
        x = self.drop(F.relu(self.dense(x)))
        x = self.drop_1(F.relu(self.dense_1(x)))
        return torch.softmax(self.dense_2(x), dim=-1)

    def keras_paths(self) -> dict:
        paths = {}
        for name in ("dense", "dense_1", "dense_2"):
            paths.update(dense_paths(f"mnist_mlp/{name}", getattr(self, name)))
        return paths


@zoo_builder
def mnist_mlp(
    input_dim: int = 784,
    num_classes: int = 10,
    hidden: int = 128,
    dropout: float = 0.2,
    lr: float = 1e-3,
    sparse_labels: bool = True,
    seed: int = 0,
    device=None,
):
    """The MLP in eval mode on ``device`` (``cuda:0`` by default),
    compiled with Keras's ``Adam(lr)``, sparse categorical cross-entropy
    (categorical on one-hot labels with ``sparse_labels=False``) and
    ``accuracy``."""
    model = build_module(lambda: MnistMLP(input_dim, num_classes, hidden, dropout, seed),
                         seed, None, device)
    return compile_model(model, Adam(model.parameters(), lr=lr),
                         classification_loss(sparse_labels), ["accuracy"])
