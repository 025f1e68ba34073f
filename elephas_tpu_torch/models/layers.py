"""Keras's layers and dtype policies as the port's builders use them.

Counterpart of the stock Keras layers that the JAX package's builders
stack (``elephas_tpu/models/{mlp,convnet,lstm,resnet,transformer}.py``)
and of the policy scope they build under (``_dtype_policy_scope``,
``elephas_tpu/models/transformer.py:36``).

A dtype policy names two types, as Keras's does. Variables (parameters,
BatchNorm's moving statistics, optimizer state) are always float32; each
layer computes in the policy's compute dtype:

- ``None`` or ``"float32"``: everything in float32;
- ``"mixed_bfloat16"``: every layer casts its input and its float32
  weights to bfloat16 at use, as Keras's autocast does, so gradients
  reach the float32 variables through the casts.

:func:`apply_policy` sets the compute dtype on every module of a built
model that has one (Keras sets it on every layer built under the scope),
except where the reference pins a layer to float32 (``Dense(...,
keep_float32=True)``: the transformers' heads). Normalisations follow
Keras: statistics in float32, the output in the compute dtype.

The builders' layout is Keras's NHWC at the model's input and output.
Inside, convolutions take ``[B, C, H, W]`` tensors whose memory is
channels-last (``x.permute(0, 3, 1, 2)`` of NHWC data is such a view),
so no copy changes the layout.
"""

from __future__ import annotations

import functools
import inspect

import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.device import resolve_device

POLICIES = {None: torch.float32, "float32": torch.float32,
            "mixed_bfloat16": torch.bfloat16}
_POLICY_TODO = (
    "dtype_policy={!r} is not ported yet: the port takes float32 and "
    "mixed_bfloat16 (ROADMAP.md, Queue A item 2: mixed_float16 needs "
    "Keras's loss scaling)"
)

# Keras array -> the port's tensor, as a permutation of the Keras axes:
# Dense kernels [in, out] -> nn.Linear [out, in]; conv kernels HWIO -> OIHW
DENSE_KERNEL = (1, 0)
CONV_KERNEL = (3, 2, 0, 1)


def compute_dtype(dtype_policy) -> torch.dtype:
    """The compute dtype of a Keras policy name; raises
    ``NotImplementedError`` for a policy the port does not take."""
    if dtype_policy not in POLICIES:
        raise NotImplementedError(_POLICY_TODO.format(dtype_policy))
    return POLICIES[dtype_policy]


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it already is, without the
    dispatcher call of ``t.to`` (a float32 model's layers cast nothing)."""
    return t if t.dtype == dtype else t.to(dtype)


def apply_policy(model: nn.Module, dtype_policy) -> nn.Module:
    """Set ``dtype_policy``'s compute dtype on every submodule that has a
    ``compute_dtype`` (but not on one with ``keep_float32``), and record
    the policy on ``model`` as ``dtype_policy`` (its name) and
    ``compute_dtype``."""
    dtype = compute_dtype(dtype_policy)
    for mod in model.modules():
        if hasattr(mod, "compute_dtype") and not getattr(mod, "keep_float32", False):
            mod.compute_dtype = dtype
    model.dtype_policy = dtype_policy or "float32"
    model.compute_dtype = dtype
    return model


class Dense(nn.Linear):
    """Keras's ``Dense`` without its activation: ``x @ kernel + bias`` in
    the compute dtype, the input and the float32 weights cast at use.
    Below float32 the product is rounded before the bias is added, as
    Keras's two ops round it (one fused rounding differs by one bf16 ulp
    in about a quarter of the outputs). ``keep_float32`` pins the layer
    to float32 whatever the policy, as ``Dense(..., dtype="float32")``
    does in the reference."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 keep_float32: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = torch.float32
        self.keep_float32 = keep_float32

    def forward(self, x):
        dtype = self.compute_dtype
        if dtype is torch.float32 or self.bias is None:
            return F.linear(cast(x, dtype), cast(self.weight, dtype), self.bias)
        return F.linear(cast(x, dtype), cast(self.weight, dtype)) + cast(self.bias, dtype)


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """Keras's (XLA's) ``padding="same"`` along one axis of length ``n``
    for a window ``k`` and stride ``s``: the output has ``ceil(n / s)``
    positions and the total padding ``(ceil(n/s) − 1)·s + k − n`` is split
    with the smaller half before. With stride 2 it is often uneven: the
    7×7/2 stem at 224 pads (2, 3), a 3×3/2 at 56 pads (0, 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """``x`` ``[B, C, H, W]`` padded for a "same" window, and the padding
    left to the op (the symmetric case: the op pads for free)."""
    (ht, hb), (wl, wr) = same_padding(x.shape[2], k, s), same_padding(x.shape[3], k, s)
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


class Conv2D(nn.Conv2d):
    """Keras's ``Conv2D`` without its activation, on ``[B, C, H, W]``
    tensors: square ``kernel`` and ``stride``, ``padding`` ``"valid"`` or
    ``"same"`` (Keras's, uneven where it is: :func:`same_padding`), in the
    compute dtype, the input and the float32 weights cast at use."""

    def __init__(self, in_channels: int, filters: int, kernel: int, stride: int = 1,
                 padding: str = "valid", bias: bool = True):
        if padding not in ("valid", "same"):
            raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")
        super().__init__(in_channels, filters, kernel, stride=stride, bias=bias)
        self.same = padding == "same"
        self.compute_dtype = torch.float32

    def forward(self, x):
        dtype = self.compute_dtype
        x, pad = cast(x, dtype), (0, 0)
        if self.same:
            x, pad = _pad_same(x, self.kernel_size[0], self.stride[0])
        bias = None if self.bias is None else cast(self.bias, dtype)
        return F.conv2d(x, cast(self.weight, dtype), bias, self.stride, pad)


def max_pool(x, k: int, s: int | None = None, padding: str = "valid"):
    """Keras's ``MaxPooling2D(k, s, padding)`` on ``[B, C, H, W]``; "same"
    pads with −∞, unevenly where Keras does."""
    s = s or k
    pad = (0, 0)
    if padding == "same":
        x, pad = _pad_same(x, k, s, value=-torch.inf)
    return F.max_pool2d(x, k, s, pad)


class BatchNorm(nn.Module):
    """Keras's ``BatchNormalization`` over axis 1 of ``[B, C, ...]``:
    ``momentum=0.99``, ``epsilon=1e-3``, trainable ``gamma``/``beta`` and
    the buffers ``moving_mean``/``moving_variance``.

    In ``train()`` mode it normalises by the batch's mean and biased
    variance (``ops.moments``) and moves the statistics as Keras does,
    ``moving = moving·momentum + batch·(1 − momentum)`` with the biased
    variance (``nn.BatchNorm2d`` keeps the unbiased one, with momentum
    0.1 and eps 1e-5). In ``eval()`` mode it uses the moving statistics.
    Statistics are float32 whatever the input's type (Keras upcasts a
    bf16 input); the output is in the compute dtype. The normalisation
    is PyTorch's batch norm: the reference's is XLA, not a kernel of its
    own."""

    def __init__(self, channels: int, momentum: float = 0.99, epsilon: float = 1e-3):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))
        self.compute_dtype = torch.float32

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x, self.moving_mean, self.moving_variance, self.gamma,
                             self.beta, False, 0.0, self.epsilon)
            return cast(y, self.compute_dtype)
        # f32 statistics of a bf16 input; the kernel returns the batch mean
        # and 1/sqrt(var + eps) of the biased variance it normalised by
        y, mean, invstd = torch.native_batch_norm(
            x, self.gamma, self.beta, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            m = self.momentum
            var = invstd.pow(-2) - self.epsilon
            self.moving_mean.copy_(self.moving_mean * m + mean * (1.0 - m))
            self.moving_variance.copy_(self.moving_variance * m + var * (1.0 - m))
        return cast(y, self.compute_dtype)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from its own ``torch.Generator``,
    seeded from the builder's seed. It draws other bits than Keras's
    dropout from the same seed: the same in distribution, not bit for
    bit. ``shared_axes`` hold one mask along those axes (the LSTM's input
    dropout: one mask a sample and feature for every timestep). Rate 0
    is the identity, as in Keras."""

    def __init__(self, rate: float, seed: int, shared_axes: tuple[int, ...] = ()):
        super().__init__()
        self.rate = float(rate)
        self.seed = int(seed)
        self.shared_axes = tuple(shared_axes)
        self._generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self._generator is None or self._generator.device != x.device:
            self._generator = torch.Generator(device=x.device).manual_seed(self.seed)
        shape = [1 if i in self.shared_axes else n for i, n in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self._generator, device=x.device) >= self.rate
        return x * keep / (1.0 - self.rate)


def keras_init(model: nn.Module) -> None:
    """Keras's default initialisers: glorot-uniform Dense and conv kernels
    (fans over the receptive field, as ``nn.init.xavier_uniform_`` takes
    them), zero biases, uniform(±0.05) embeddings; norms start at ones
    and zeros."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            nn.init.xavier_uniform_(mod.weight)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.uniform_(mod.weight, -0.05, 0.05)


def build_module(make, seed: int, dtype_policy, device) -> nn.Module:
    """``make()`` with weights from ``seed`` alone (Keras's initialisers,
    :func:`keras_init`, after any of the module's own), without touching
    the global generator; in eval mode on ``device`` (``cuda:0`` by
    default), conv kernels channels-last, under ``dtype_policy``."""
    compute_dtype(dtype_policy)  # refuses a policy the port does not take
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = make()
        keras_init(model)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    return apply_policy(model, dtype_policy)


# builder name -> builder, for rebuilding a saved model
# (elephas_tpu_torch.utils.serialization)
ZOO: dict = {}


def zoo_builder(fn):
    """Register a builder of the zoo, and record on each module it returns
    the builder's name and every argument but ``device`` (defaults
    filled in) as ``build_spec``, so that a saved model can be rebuilt."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def build(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = {}
        for name, value in bound.arguments.items():
            if sig.parameters[name].kind is inspect.Parameter.VAR_KEYWORD:
                arguments.update(value)
            elif name != "device":
                arguments[name] = value
        model = fn(*args, **kwargs)
        model.build_spec = {"builder": fn.__name__, "kwargs": arguments}
        return model

    ZOO[fn.__name__] = build
    return build


def dense_paths(prefix: str, lin: nn.Linear) -> dict:
    """Keras paths of a Dense layer: ``{path: (tensor, permutation)}``."""
    paths = {f"{prefix}/kernel": (lin.weight, DENSE_KERNEL)}
    if lin.bias is not None:
        paths[f"{prefix}/bias"] = (lin.bias, None)
    return paths


def conv_paths(prefix: str, conv: nn.Conv2d) -> dict:
    paths = {f"{prefix}/kernel": (conv.weight, CONV_KERNEL)}
    if conv.bias is not None:
        paths[f"{prefix}/bias"] = (conv.bias, None)
    return paths


def batch_norm_paths(prefix: str, bn: BatchNorm) -> dict:
    """The trainable ``gamma``/``beta`` and the non-trainable moving
    statistics, as Keras lists them."""
    return {f"{prefix}/{name}": (getattr(bn, name), None)
            for name in ("gamma", "beta", "moving_mean", "moving_variance")}

