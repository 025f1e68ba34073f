"""IMDB LSTM classifier — counterpart of ``elephas_tpu/models/lstm.py``
(``imdb_lstm``): Embedding → ``LSTM(units, dropout=0.2)`` → Dense(1,
sigmoid), Keras's ``Adam(1e-3)`` and binary cross-entropy.

The recurrence is ``nn.LSTM``'s: its gates i, f, g, o are Keras's i, f,
c, o, with sigmoid (not hard sigmoid) and tanh. Keras has one bias, so
``bias_hh_l0`` is zero and not trained. Keras's ``LSTM(dropout=)`` drops
the cell's input with one mask a sample and feature held over every
timestep (``nn.LSTM(dropout=)`` is dropout between stacked layers, a
different thing); :class:`~elephas_tpu_torch.models.layers.Dropout` with
the time axis shared does that before the recurrence."""

from __future__ import annotations

import torch
from torch import nn

from elephas_tpu_torch.models.layers import (
    DENSE_KERNEL,
    Dense,
    Dropout,
    build_module,
    dense_paths,
    zoo_builder,
)
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import compile_model


class ImdbLSTM(nn.Module):
    """``[B, maxlen]`` int tokens → ``[B, 1]`` probabilities. The reference
    is a Keras ``Sequential`` named ``imdb_lstm`` (``embedding``,
    ``lstm/lstm_cell``, ``dense`` in a fresh process)."""

    keras_sequential = "imdb_lstm"

    def __init__(self, vocab_size, embed_dim, units, seed):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.drop = Dropout(0.2, seed, shared_axes=(1,))
        self.lstm = nn.LSTM(embed_dim, units, batch_first=True)
        self.dense = Dense(units, 1)
        # Keras's LSTM initialisers: glorot-uniform kernel, orthogonal
        # recurrent kernel, zero bias with ones on the forget gate
        with torch.no_grad():
            nn.init.xavier_uniform_(self.lstm.weight_ih_l0)
            recurrent = torch.empty(units, 4 * units)
            nn.init.orthogonal_(recurrent)
            self.lstm.weight_hh_l0.copy_(recurrent.T)
            self.lstm.bias_ih_l0.zero_()
            self.lstm.bias_ih_l0[units:2 * units] = 1.0
            self.lstm.bias_hh_l0.zero_()
        self.lstm.bias_hh_l0.requires_grad_(False)

    def forward(self, tokens):
        x = self.drop(self.embedding(tokens))
        _, (h, _) = self.lstm(x)
        return torch.sigmoid(self.dense(h[-1]))

    def keras_paths(self) -> dict:
        cell = "imdb_lstm/lstm/lstm_cell"
        return {
            "imdb_lstm/embedding/embeddings": (self.embedding.weight, None),
            f"{cell}/kernel": (self.lstm.weight_ih_l0, DENSE_KERNEL),
            f"{cell}/recurrent_kernel": (self.lstm.weight_hh_l0, DENSE_KERNEL),
            f"{cell}/bias": (self.lstm.bias_ih_l0, None),
            **dense_paths("imdb_lstm/dense", self.dense),
        }


@zoo_builder
def imdb_lstm(
    vocab_size: int = 20000,
    maxlen: int = 80,
    embed_dim: int = 128,
    units: int = 128,
    lr: float = 1e-3,
    seed: int = 0,
    device=None,
):
    """The LSTM classifier in eval mode on ``device`` (``cuda:0`` by
    default), compiled with Keras's ``Adam(lr)`` over its trainable
    parameters, binary cross-entropy and ``accuracy``. ``maxlen`` is the
    input's length (the recurrence takes any)."""
    model = build_module(lambda: ImdbLSTM(vocab_size, embed_dim, units, seed),
                         seed, None, device)
    trainable = [p for p in model.parameters() if p.requires_grad]
    return compile_model(model, Adam(trainable, lr=lr), "binary_crossentropy", ["accuracy"])
