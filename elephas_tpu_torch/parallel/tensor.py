"""Tensor-parallel training over a 2-D ``('data', 'model')`` mesh —
counterpart of ``elephas_tpu/parallel/tensor.py``.

The reference annotates each variable with a ``NamedSharding`` over the
``model`` axis and lets GSPMD place the collectives inside one jitted
step. The port runs single-controller over the port's
:class:`~elephas_tpu_torch.parallel.mesh.Mesh`: one process holds every
shard, each on the mesh's device for its position (a mesh may name
``cuda:0`` several times, as :func:`~elephas_tpu_torch.device.\
force_devices` offers several worker slots on one card), and the
collectives are copies between those devices (no copy on one device).

The planner is the reference's, decision for decision: :data:`DEFAULT_RULES`
and :func:`plan_sharding` read the Keras paths and Keras shapes that
``model.keras_paths()`` gives, test divisibility as the reference does and
log the same warning when nothing shards; its specs are this module's
:class:`PartitionSpec`, whose ``str()`` is JAX's. A spec's sharded Keras
axis is then mapped through the path's axis permutation onto the port's
tensor (a ``Dense`` kernel ``[in, out]`` is an ``nn.Linear`` weight
``[out, in]``).

Each planned variable lives as shards on the devices of the ``model``
axis, and the module computes what the unsharded module computes
(:func:`shard_module`):

- Megatron's pairing: a transformer's ``qkv`` is column-parallel and its
  ``proj`` row-parallel (:class:`TensorParallelMHA`), ``mlp1``
  column-parallel and ``mlp2`` row-parallel (:class:`TensorParallelBlock`);
  the row-parallel partial sums are added across the model axis. The
  fused ``qkv`` kernel is split by heads, not by contiguous columns: shard
  ``j`` holds the q, k and v columns of its own ``H/TP`` heads and runs
  the flash-attention forward on ``[B, S, 3, H/TP, Dh]`` with no reshard.
  The shards' contents therefore differ from the reference's contiguous
  blocks (the reference's GSPMD reshards before its attention); the
  function is the same.
- Embeddings and other ``Dense`` layers whose planned axis is the output
  are column-parallel (:class:`ColumnParallelEmbedding`,
  :class:`ColumnParallelDense`), those split on the input row-parallel
  (:class:`RowParallelDense`).
- Any other layer with a sharded variable (the catch-all ``/kernel$`` rule
  on a convolution, a ``Dense`` whose bias a custom rule shards, an LSTM)
  gathers the shards before its forward, and autograd slices the gradient
  back: the counterpart of GSPMD's "any layout is exact".

:class:`ShardedTrainer` keeps the reference's modes: ``synchronous`` with
``epoch`` or ``batch`` trains one copy over the global batch, on the
devices of the mesh's first data row; ``asynchronous``, ``hogwild`` and
``frequency="fit"`` keep one copy a data replica ``[DP, ...]``, each on
its own row of the mesh, and average the float state at the frequency's
boundary (optimizer slots stay local), as the data-parallel runner does.
Its sharded checkpoints write one file a shard of the canonical single
copy (:mod:`elephas_tpu_torch.utils.checkpoint`). The Switch models'
expert weights under a model axis are expert parallelism, not ported
(ROADMAP.md, Queue A item 5: 5e).

:class:`TensorParallelRunner` adapts the trainer to the runner interface
that :class:`~elephas_tpu_torch.SparkModel` drives, so
``SparkModel(model, model_parallel=N)`` routes fit (with checkpoints and
resume), streamed fits, evaluate and predict through it.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import re

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch import device as _device
from elephas_tpu_torch.data.streaming import prefetch_blocks
from elephas_tpu_torch.models.layers import Dense, cast
from elephas_tpu_torch.models.transformer import Block, FlashMHA, PreNormBlock
from elephas_tpu_torch.optimizers import hyperparameters
from elephas_tpu_torch.parallel.mesh import Mesh
from elephas_tpu_torch.training import MeanMetric, training_loss
from elephas_tpu_torch.utils import checkpoint as ckpt
from elephas_tpu_torch.worker import (FREQUENCIES, MODES, Runner, _mean_into,
                                      check_stream)

logger = logging.getLogger(__name__)

_EXPERT_TODO = (
    "model_parallel > 1 on a Switch model shards its expert weights over the "
    "model axis (expert parallelism), which is not ported yet (ROADMAP.md, "
    "Queue A item 5: 5e)"
)
_EXPERT_PATH = re.compile(r"/expert_[wb][12]$")


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry a leading axis
    of a variable, the mesh axis that splits it or ``None``; its ``str()``
    is JAX's (``PartitionSpec(None, 'model')``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec({', '.join(map(repr, self))})"

    __str__ = __repr__


P = PartitionSpec

# (variable-path regex, the partition spec as a function of the model-axis name),
# the reference's table: column-split the fan-out kernels (qkv, mlp up,
# embeddings, heads), row-split the fan-in kernels (attention proj, mlp
# down), and column-split any other rank-2 kernel
DEFAULT_RULES: list[tuple[str, callable]] = [
    (r"(qkv|mlp1|lm_head|head)/kernel$", lambda m: P(None, m)),
    (r"(proj|mlp2)/kernel$", lambda m: P(m, None)),
    (r"embedding.*/embeddings$|tok_embed.*/embeddings$", lambda m: P(None, m)),
    (r"/(query|key|value)/kernel$", lambda m: P(None, m, None)),
    (r"/(query|key|value)/bias$", lambda m: P(m, None)),
    (r"/attention_output/kernel$", lambda m: P(m, None, None)),
    (r"dense[^/]*/kernel$", lambda m: P(None, m)),
    (r"/expert_w[12]$", lambda m: P(m, None, None)),
    (r"/expert_b[12]$", lambda m: P(m, None)),
    (r"/kernel$", lambda m: P(None, m)),
]


# -- meshes ------------------------------------------------------------------


def second_axis_mesh(n: int, axis_name: str, data_parallel: int | None = None,
                     label: str | None = None, device=None) -> Mesh:
    """2-D ``('data', <axis_name>)`` mesh over this process's worker slots
    (:func:`~elephas_tpu_torch.device.slot_devices` on ``device``,
    ``cuda:0`` by default), with the reference's errors word for word.

    With explicit ``data_parallel`` the mesh is the leading ``dp×n`` slots
    (the slot count need not divide: 2×3 on 8 slots is a 6-slot mesh)."""
    label = label or f"{axis_name}_parallel"
    devices = _device.slot_devices(_device.resolve_device(device))
    if n <= 0:
        raise ValueError(f"{label} must be positive, got {n}")
    if data_parallel is None and len(devices) % n:
        raise ValueError(
            f"{label}={n} must divide the device count "
            f"({len(devices)}) — or pass data_parallel explicitly"
        )
    if data_parallel is not None and data_parallel <= 0:
        raise ValueError(f"data_parallel must be positive, got {data_parallel}")
    dp = data_parallel if data_parallel is not None else len(devices) // n
    if dp * n > len(devices):
        raise ValueError(
            f"data_parallel×{label} = {dp}×{n} exceeds {len(devices)} devices"
        )
    return Mesh([devices[r * n:(r + 1) * n] for r in range(dp)], ("data", axis_name))


def dp_tp_mesh(model_parallel: int = 1, data_parallel: int | None = None,
               device=None) -> Mesh:
    """2-D ``('data', 'model')`` mesh — see :func:`second_axis_mesh`."""
    return second_axis_mesh(model_parallel, "model", data_parallel,
                            label="model_parallel", device=device)


# -- the planner -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KerasVariable:
    """A variable as the reference's planner sees it: its Keras ``path``
    and Keras ``shape``; ``name`` is the module's qualified tensor name and
    ``axes`` the permutation of the Keras axes into the port's tensor."""

    path: str
    shape: tuple
    name: str
    axes: tuple | None
    trainable: bool


def keras_variables(model: nn.Module) -> list[KerasVariable]:
    """``model``'s variables in Keras's ``model.weights`` order, from its
    ``keras_paths()``; a module without Keras paths lists its parameters
    and persistent buffers by their own names and shapes."""
    names = {id(t): n for n, t in model.named_parameters()}
    persistent = model.state_dict(keep_vars=True)
    names.update({id(t): n for n, t in model.named_buffers() if n in persistent})
    if hasattr(model, "keras_paths"):
        paths = model.keras_paths()
    else:
        paths = {n: (t, None) for n, t in persistent.items()}
    out = []
    for path, (t, perm) in paths.items():
        shape = tuple(t.shape) if perm is None else tuple(
            t.shape[perm.index(k)] for k in range(len(perm)))
        trainable = isinstance(t, nn.Parameter) and t.requires_grad
        out.append(KerasVariable(path, shape, names[id(t)], perm, trainable))
    return out


def plan_sharding(variables, mesh: Mesh, model_axis: str = "model",
                  rules=None) -> list[PartitionSpec]:
    """Variable path → :class:`PartitionSpec`, first matching rule wins.

    A rule applies only when the spec's axes divide the variable's
    dimensions on this mesh; otherwise the variable replicates (with a
    debug log). When no variable shards on a model axis larger than 1, a
    warning names the largest replicated variables. ``rules=[]`` asks for
    every variable replicated, without the warning. ``variables`` carry
    ``path`` and ``shape`` (:func:`keras_variables`)."""
    rules = rules if rules is not None else DEFAULT_RULES
    axis_size = mesh.shape[model_axis]
    out = []
    for v in variables:
        path = getattr(v, "path", getattr(v, "name", ""))
        spec = P()
        for pattern, build in rules:
            if re.search(pattern, path):
                candidate = build(model_axis)
                ok = True
                for dim, axes in zip(v.shape, candidate):
                    if axes is not None and dim % axis_size:
                        ok = False
                if ok and len(candidate) <= len(v.shape):
                    spec = candidate
                else:
                    logger.debug("not sharding %s %s: %s does not tile", path,
                                 v.shape, candidate)
                break
        out.append(spec)
    if rules and axis_size > 1 and variables and all(s == P() for s in out):
        biggest = sorted(variables, key=lambda v: -int(np.prod(v.shape)))[:3]
        logger.warning(
            "tensor-parallel planner sharded NOTHING over the %d-way model "
            "axis — every variable replicates. Largest: %s. Pass custom "
            "`rules` matching your layer names (see DEFAULT_RULES).",
            axis_size,
            [(getattr(v, "path", "?"), tuple(v.shape)) for v in biggest],
        )
    return out


def refuse_expert_parallel(model: nn.Module) -> None:
    """Raise ``NotImplementedError`` (ROADMAP.md, Queue A item 5: 5e) for a
    model with Switch expert weights, whose model axis is expert
    parallelism."""
    if any(_EXPERT_PATH.search(v.path) for v in keras_variables(model)):
        raise NotImplementedError(_EXPERT_TODO)


def _port_dim(v: KerasVariable, spec: PartitionSpec, model_axis: str) -> int | None:
    """The port tensor's axis that ``spec`` splits over ``model_axis``, or
    None for a replicated variable."""
    split = [k for k, a in enumerate(spec) if a is not None]
    if not split:
        return None
    if len(split) > 1 or spec[split[0]] != model_axis:
        raise NotImplementedError(
            f"{v.path}: the port shards one axis over {model_axis!r}, not {spec} "
            f"(ROADMAP.md, Queue A item 5)")
    return split[0] if v.axes is None else v.axes.index(split[0])


# -- sharded storage ---------------------------------------------------------


class ShardedVariable:
    """One variable of a sharded module: its ``shards`` (one tensor, on the
    first model-axis device, when it replicates), split along the port
    tensor's axis ``dim`` into equal contiguous pieces; ``blocks=3`` splits
    each third of axis 0 alike (the fused ``qkv`` weight's q, k and v
    rows, so that a shard holds whole heads of each)."""

    def __init__(self, name: str, shards, dim: int | None = None, blocks: int = 1):
        self.name = name
        self.shards = list(shards)
        self.dim = dim
        self.blocks = blocks

    @property
    def layout(self) -> list:
        return [self.dim, self.blocks, len(self.shards)]

    def split(self, full: torch.Tensor, n: int) -> list[torch.Tensor]:
        if self.dim is None:
            return [full]
        if self.blocks > 1:
            rest = full.shape[1:]
            parts = full.reshape(self.blocks, -1, *rest).chunk(n, 1)
            return [p.reshape(-1, *rest) for p in parts]
        return list(full.chunk(n, self.dim))

    def join(self, parts, device) -> torch.Tensor:
        """The whole tensor from one piece a shard, on ``device``
        (differentiable: autograd slices a gradient back)."""
        parts = [p.to(device) for p in parts]
        if len(parts) == 1:
            return parts[0]
        if self.blocks > 1:
            rest = parts[0].shape[1:]
            whole = torch.cat([p.reshape(self.blocks, -1, *rest) for p in parts], 1)
            return whole.reshape(-1, *rest)
        return torch.cat(parts, self.dim)

    def full(self, device) -> torch.Tensor:
        return self.join(self.shards, device)


def _dense(x, w, b, dtype):
    """``Dense.forward``'s arithmetic on given tensors."""
    if dtype is torch.float32 or b is None:
        return F.linear(cast(x, dtype), cast(w, dtype), b)
    return F.linear(cast(x, dtype), cast(w, dtype)) + cast(b, dtype)


def _add_bias(out, b, dtype):
    return out if b is None else out + cast(b, dtype)


def _reduce(parts, device):
    """The sum of the partial results across the model axis, on ``device``
    (the row-parallel all-reduce), in shard order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def _param(t: torch.Tensor, device, requires_grad: bool) -> nn.Parameter:
    return nn.Parameter(t.detach().to(device).contiguous().clone(), requires_grad=requires_grad)


class ColumnParallelDense(nn.Module):
    """A ``Dense`` whose output features are split over the model axis:
    each shard computes its slice of the output, gathered in order."""

    def __init__(self, dense: Dense, shards, devices):
        super().__init__()
        self.weight_shards = nn.ParameterList(shards)
        self.bias = dense.bias
        self.compute_dtype = dense.compute_dtype
        self.keep_float32 = dense.keep_float32
        self.devices = devices

    @property
    def weight(self) -> torch.Tensor:
        """The whole weight gathered on the first device, for code that
        reads it (autograd slices a gradient back)."""
        return torch.cat([w.to(self.devices[0]) for w in self.weight_shards], dim=0)

    def forward(self, x):
        dev0, width = self.devices[0], self.weight_shards[0].shape[0]
        outs = []
        for j, (w, dev) in enumerate(zip(self.weight_shards, self.devices)):
            b = None if self.bias is None else self.bias[j * width:(j + 1) * width].to(dev)
            outs.append(_dense(x.to(dev), w, b, self.compute_dtype).to(dev0))
        return torch.cat(outs, dim=-1)


class RowParallelDense(nn.Module):
    """A ``Dense`` whose input features are split over the model axis: each
    shard multiplies its slice of the input, the partial products are
    added across the axis, then the bias."""

    def __init__(self, dense: Dense, shards, devices):
        super().__init__()
        self.weight_shards = nn.ParameterList(shards)
        self.bias = dense.bias
        self.compute_dtype = dense.compute_dtype
        self.keep_float32 = dense.keep_float32
        self.devices = devices

    @property
    def weight(self) -> torch.Tensor:
        """The whole weight gathered on the first device, for code that
        reads it (autograd slices a gradient back)."""
        return torch.cat([w.to(self.devices[0]) for w in self.weight_shards], dim=1)

    def forward(self, x):
        width = self.weight_shards[0].shape[1]
        parts = [_dense(x[..., j * width:(j + 1) * width].to(dev), w, None, self.compute_dtype)
                 for j, (w, dev) in enumerate(zip(self.weight_shards, self.devices))]
        return _add_bias(_reduce(parts, self.devices[0]), self.bias, self.compute_dtype)


class ColumnParallelEmbedding(nn.Module):
    """An embedding table ``[vocab, d]`` split over the model axis along
    ``d``: each shard looks up its slice of the features."""

    def __init__(self, shards, devices):
        super().__init__()
        self.weight_shards = nn.ParameterList(shards)
        self.devices = devices

    @property
    def weight(self) -> torch.Tensor:
        """The whole weight gathered on the first device, for code that
        reads it (autograd slices a gradient back)."""
        return torch.cat([w.to(self.devices[0]) for w in self.weight_shards], dim=1)

    def forward(self, tokens):
        dev0 = self.devices[0]
        return torch.cat([F.embedding(tokens.to(dev), w).to(dev0)
                          for w, dev in zip(self.weight_shards, self.devices)], dim=-1)


class TensorParallelMHA(nn.Module):
    """:class:`FlashMHA` over the model axis: shard ``j`` is a
    :class:`FlashMHA` of ``H/TP`` heads on the axis's ``j``-th device,
    holding the q, k and v columns of heads ``[j·H/TP, (j+1)·H/TP)`` (its
    forward runs the flash kernel on ``[B, S, 3, H/TP, Dh]``, its
    :meth:`decode` the span decode over its own K/V cache). ``proj`` is
    row-parallel: each shard also holds the ``proj`` input columns of its
    heads, and the shards' partial outputs are added, then the bias."""

    def __init__(self, attn: FlashMHA, shards, devices):
        super().__init__()
        self.num_heads = attn.num_heads
        self.head_dim = attn.head_dim
        self.causal = attn.causal
        self.shards = nn.ModuleList(shards)
        self.bias = attn.proj.bias
        self.compute_dtype = attn.proj.compute_dtype
        self.devices = devices

    def _combine(self, parts):
        return _add_bias(_reduce(parts, self.devices[0]), self.bias, self.compute_dtype)

    def forward(self, x, plain: bool = False):
        return self._combine([sh(x.to(dev), plain=plain)
                              for sh, dev in zip(self.shards, self.devices)])

    def decode(self, x, positions, cache_k, cache_v, active=None, attention: str = "flash",
               span: int | None = None):
        """:meth:`FlashMHA.decode` with ``cache_k`` / ``cache_v`` lists of
        one ``[B, maxlen, H/TP, Dh]`` cache a shard, on its device."""
        parts = []
        for sh, dev, ck, cv in zip(self.shards, self.devices, cache_k, cache_v):
            act = None if active is None else active.to(dev)
            parts.append(sh.decode(x.to(dev), positions.to(dev), ck, cv, act, attention, span))
        return self._combine(parts)


class TensorParallelBlock(PreNormBlock):
    """A transformer :class:`Block` whose ``mlp1`` is column-parallel and
    ``mlp2`` row-parallel, paired: shard ``j`` computes
    ``gelu(x·W1_j + b1_j)·W2_j``, the partials are added across the model
    axis, then ``mlp2``'s bias. Its norms, dropouts and attention are the
    block's own (the attention a :class:`TensorParallelMHA` where it is
    sharded)."""

    def __init__(self, block: Block, attn, w1_shards, w2_shards, devices):
        nn.Module.__init__(self)
        self.ln1, self.attn, self.ln2 = block.ln1, attn, block.ln2
        self.drop1, self.drop2 = block.drop1, block.drop2
        self.mlp1_shards = nn.ParameterList(w1_shards)
        self.mlp2_shards = nn.ParameterList(w2_shards)
        self.mlp1_bias, self.mlp2_bias = block.mlp1.bias, block.mlp2.bias
        self.dtype1, self.dtype2 = block.mlp1.compute_dtype, block.mlp2.compute_dtype
        self.devices = devices

    def ffn(self, x, plain: bool = False):
        width = self.mlp1_shards[0].shape[0]
        parts = []
        for j, (w1, w2, dev) in enumerate(zip(self.mlp1_shards, self.mlp2_shards, self.devices)):
            b1 = self.mlp1_bias[j * width:(j + 1) * width].to(dev)
            h = F.gelu(_dense(x.to(dev), w1, b1, self.dtype1))
            parts.append(_dense(h, w2, None, self.dtype2))
        return _add_bias(_reduce(parts, self.devices[0]), self.mlp2_bias, self.dtype2)


class _Gather:
    """Forward pre-hook of a module whose parameter ``attr`` is sharded in
    a way no parallel layer takes: the whole tensor is gathered onto the
    module's device before each forward (autograd slices the gradient
    back to the shards)."""

    def __init__(self, attr: str, var: ShardedVariable, device):
        self.attr, self.var, self.device = attr, var, device

    def __call__(self, module, args):
        setattr(module, self.attr, self.var.full(self.device))


def _copy_module(model: nn.Module, device) -> nn.Module:
    """A copy of ``model`` on ``device`` that shares its training spec (the
    copy's own optimizer is made by the caller)."""
    spec = getattr(model, "training_spec", None)
    memo = {} if spec is None else {id(spec): spec}
    return copy.deepcopy(model, memo).to(device)


def _set_module(root: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, attr, module)


def shard_module(model: nn.Module, dims: dict, devices) -> tuple[nn.Module, dict]:
    """A copy of ``model`` whose variables named in ``dims`` (the module's
    qualified tensor names → the port axis split over the model axis, or
    None) live as shards on ``devices`` (the model axis's devices, in
    order), with the parallel layers of this module in place of the
    layers that hold them. The rest of the copy lives on ``devices[0]``.

    Returns ``(copy, {name: ShardedVariable})`` over every parameter and
    persistent buffer of the copy."""
    n, dev0 = len(devices), devices[0]
    rep = _copy_module(model, dev0)
    persistent = rep.state_dict(keep_vars=True)
    variables = {name: ShardedVariable(name, [t]) for name, t in persistent.items()}

    def dim(name):
        return dims.get(name)

    def shards(name, d, blocks=1):
        var = ShardedVariable(name, [], d, blocks)
        whole = variables[name].shards[0]
        var.shards = [_param(p, dev, whole.requires_grad)
                      for p, dev in zip(var.split(whole, n), devices)]
        variables[name] = var
        return var.shards

    done = set()
    # Megatron attention: qkv split by heads, proj row-parallel beside it
    for mn, m in list(rep.named_modules()):
        pre = f"{mn}." if mn else ""
        if not (isinstance(m, FlashMHA) and dim(f"{pre}qkv.weight") == 0
                and dim(f"{pre}proj.weight") == 1 and m.num_heads % n == 0
                and dim(f"{pre}proj.bias") is None):
            continue
        heads, hd = m.num_heads // n, m.head_dim
        qkv = shards(f"{pre}qkv.weight", 0, blocks=3)
        proj = shards(f"{pre}proj.weight", 1)
        parts = []
        for j, dev in enumerate(devices):
            # built on the meta device: every tensor is replaced below
            with torch.device("meta"):
                sh = FlashMHA(qkv[j].shape[1], heads, hd, m.causal, m.rope,
                              m.rope_cos.shape[0] if m.rope else None)
                sh.proj = Dense(heads * hd, proj[j].shape[0], bias=False)
            sh.qkv.weight, sh.proj.weight = qkv[j], proj[j]
            sh.qkv.compute_dtype = m.qkv.compute_dtype
            sh.proj.compute_dtype = m.proj.compute_dtype
            if m.rope:
                sh.rope_cos, sh.rope_sin = m.rope_cos.to(dev), m.rope_sin.to(dev)
            parts.append(sh.train(m.training))
        _set_module(rep, mn, TensorParallelMHA(m, parts, devices).train(m.training))
        done |= {f"{pre}qkv.weight", f"{pre}proj.weight"}
    # Megatron feed-forward: mlp1 column-parallel, mlp2 row-parallel
    for mn, m in list(rep.named_modules()):
        pre = f"{mn}." if mn else ""
        if not (isinstance(m, Block) and dim(f"{pre}mlp1.weight") == 0
                and dim(f"{pre}mlp2.weight") == 1 and dim(f"{pre}mlp1.bias") is None
                and dim(f"{pre}mlp2.bias") is None):
            continue
        w1 = shards(f"{pre}mlp1.weight", 0)
        w2 = shards(f"{pre}mlp2.weight", 1)
        _set_module(rep, mn, TensorParallelBlock(m, m.attn, w1, w2, devices).train(m.training))
        done |= {f"{pre}mlp1.weight", f"{pre}mlp2.weight"}
    # every other sharded variable, by the module that holds it
    owners: dict[str, list[str]] = {}
    for name, d in dims.items():
        if d is not None and name not in done:
            owners.setdefault(name.rpartition(".")[0], []).append(name.rpartition(".")[2])
    for mn, attrs in owners.items():
        m = rep.get_submodule(mn)
        pre = f"{mn}." if mn else ""
        if isinstance(m, Dense) and attrs == ["weight"]:
            cls = ColumnParallelDense if dim(f"{pre}weight") == 0 else RowParallelDense
            _set_module(rep, mn, cls(m, shards(f"{pre}weight", dim(f"{pre}weight")), devices))
        elif isinstance(m, nn.Embedding) and attrs == ["weight"] and dim(f"{pre}weight") == 1:
            _set_module(rep, mn, ColumnParallelEmbedding(shards(f"{pre}weight", 1), devices))
        else:
            for attr in attrs:
                if attr not in m._parameters:
                    raise NotImplementedError(
                        f"{pre}{attr}: only trainable parameters shard (ROADMAP.md, "
                        f"Queue A item 5)")
                held = shards(f"{pre}{attr}", dim(f"{pre}{attr}"))
                del m._parameters[attr]
                m.add_module(f"{attr}_shards", nn.ParameterList(held))
                m.register_forward_pre_hook(_Gather(attr, variables[f"{pre}{attr}"], dev0))
    return rep, variables


# -- the trainer -------------------------------------------------------------


@dataclasses.dataclass
class _Replica:
    """One copy of the sharded model: its module, variables, optimizer and
    the devices of its mesh row."""

    module: nn.Module
    variables: dict
    optimizer: torch.optim.Optimizer
    devices: list

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _stage(arr, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return (t if t.is_floating_point() else t.long()).to(device)


class ShardedTrainer:
    """DP×TP trainer of a compiled module (counterpart of the reference's
    ``ShardedTrainer``): the port's training spec
    (:func:`~elephas_tpu_torch.training.compile_model`), the reference's
    modes and frequencies, parameters sharded over the ``model`` axis.

    ``fit`` takes ``batch_size`` as the global batch, rounded down to a
    multiple of the data axis; every row trains every epoch, the last
    partial batch wrap-padded with rows of zero weight, and the loss is
    the mean over valid rows (auxiliary losses the layers add ride
    unscaled). The master module holds the canonical weights and
    optimizer state at every epoch boundary and after a fit."""

    MODEL_AXIS = "model"

    def __init__(self, model: nn.Module, mesh: Mesh | None = None, model_parallel: int = 1,
                 rules=None, mode: str = "synchronous", frequency: str = "epoch"):
        if getattr(model, "training_spec", None) is None:
            raise ValueError("model must be compiled before sharded training")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if frequency not in FREQUENCIES:
            raise ValueError(f"frequency must be one of {FREQUENCIES}, got {frequency!r}")
        self.model = model
        self.mode = mode
        self.frequency = frequency
        self.mesh = mesh or dp_tp_mesh(model_parallel, device=next(model.parameters()).device)
        if "data" not in self.mesh.shape or self.MODEL_AXIS not in self.mesh.shape:
            raise ValueError(
                f"mesh must have ('data', {self.MODEL_AXIS!r}) axes, got {self.mesh.shape}")
        for dev in set(self.mesh.devices.reshape(-1)):
            _device.resolve_device(dev)  # a cuda mesh without CUDA raises
        self.per_replica = mode != "synchronous" or frequency == "fit"
        self.dp = self.mesh.shape["data"]
        self.tp = self.mesh.shape[self.MODEL_AXIS]
        variables = keras_variables(model)
        self._trainable = [v for v in variables if v.trainable]
        self._non_trainable = [v for v in variables if not v.trainable]
        self._tv_specs = plan_sharding(self._trainable, self.mesh, self.MODEL_AXIS, rules)
        self._ntv_specs = plan_sharding(self._non_trainable, self.mesh, self.MODEL_AXIS, rules)
        for v, spec in zip(self._trainable, self._tv_specs):
            if spec != P() and _EXPERT_PATH.search(v.path):
                raise NotImplementedError(_EXPERT_TODO)
        for v, spec in zip(self._non_trainable, self._ntv_specs):
            if spec != P():
                raise NotImplementedError(
                    f"{v.path}: only trainable parameters shard (ROADMAP.md, Queue A item 5)")
        self._dims = {v.name: _port_dim(v, s, self.MODEL_AXIS)
                      for v, s in zip(self._trainable, self._tv_specs)}
        self._replicas: list[_Replica] | None = None

    # -- replicas and the canonical copy ----------------------------------

    def _row(self, d: int) -> list:
        return [self.mesh.devices[d, j] for j in range(self.tp)]

    def _replica(self, d: int) -> _Replica:
        """A sharded copy of the master on data row ``d``, its optimizer
        the master's class and settings, starting from the master's
        optimizer state."""
        module, variables = shard_module(self.model, self._dims, self._row(d))
        master = self.model.training_spec.optimizer
        params = [p for p in module.parameters() if p.requires_grad]
        opt = type(master)(params, **hyperparameters(master))
        named = dict(self.model.named_parameters())
        for name, var in variables.items():
            state = master.state.get(named.get(name))
            if not state:
                continue
            for j, shard in enumerate(var.shards):
                opt.state[shard] = {
                    k: (var.split(s, len(var.shards))[j].to(shard.device).clone()
                        if torch.is_tensor(s) and s.shape == named[name].shape else copy.copy(s))
                    for k, s in state.items()}
        module.training_spec = dataclasses.replace(self.model.training_spec, optimizer=opt)
        return _Replica(module, variables, opt, self._row(d))

    def _ensure_replicas(self) -> list[_Replica]:
        if self._replicas is None:
            copies = self.dp if self.per_replica else 1
            self._replicas = [self._replica(d) for d in range(copies)]
        return self._replicas

    @torch.no_grad()
    def _canonical(self, name: str) -> list[torch.Tensor]:
        """The single-copy shards of variable ``name``: the mean over the
        replicas for float state, replica 0's otherwise."""
        reps = self._replicas
        own = reps[0].variables[name].shards
        if len(reps) == 1 or not own[0].is_floating_point():
            return list(own)
        return [torch.stack([r.variables[name].shards[j].to(s.device) for r in reps]).mean(0)
                for j, s in enumerate(own)]

    @torch.no_grad()
    def write_back(self) -> None:
        """Copy the canonical state into the master module: weights and
        float state averaged over the replicas, optimizer state replica
        0's (the reference's worker-0 write-back)."""
        if self._replicas is None:
            return
        rep0 = self._replicas[0]
        master = dict(self.model.state_dict(keep_vars=True))
        master.update(dict(self.model.named_parameters()))
        opt = self.model.training_spec.optimizer
        for name, var in rep0.variables.items():
            target = master[name]
            target.copy_(var.join(self._canonical(name), target.device))
            states = [rep0.optimizer.state.get(s) for s in var.shards]
            if states[0]:
                opt.state[target] = {
                    k: (var.join([st[k] for st in states], target.device).clone()
                        if torch.is_tensor(v) and v.dim() else copy.copy(v))
                    for k, v in states[0].items()}

    # -- training ----------------------------------------------------------

    def _round_batch(self, batch_size: int) -> int:
        return max(self.dp, (batch_size // self.dp) * self.dp)

    def _step(self, xb, yb, sw, metrics, losses) -> None:
        """One global step over the host batch ``xb`` / ``yb`` with row
        weights ``sw``: the one copy over all of it, or each replica over
        its contiguous ``1/DP`` of the rows, then the frequency's
        average."""
        reps = self._replicas
        chunks = [(xb, yb, sw)] if len(reps) == 1 else list(
            zip(np.split(xb, self.dp), np.split(yb, self.dp), np.split(sw, self.dp)))
        spec = self.model.training_spec
        for r, (rep, (x, y, sw_r)) in enumerate(zip(reps, chunks)):
            x, y, w = (_stage(a, rep.device) for a in (x, y, sw_r))
            loss, y_pred = training_loss(rep.module, spec, x, y, w)
            rep.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            rep.optimizer.step()
            losses.append((loss.detach(), float(sw_r.sum())))
            with torch.no_grad():
                for name, fn in spec.metrics.items():
                    metrics[r][name].update(fn(y, y_pred), w)
        if self.per_replica and self.frequency == "batch":
            self._average()

    def _average(self) -> None:
        """The local-SGD collective (the data-parallel runner's): every
        float parameter and float buffer shard of each replica becomes the
        mean over the replicas."""
        if len(self._replicas) > 1:
            _mean_into([[s for var in rep.variables.values() if var.shards[0].is_floating_point()
                         for s in var.shards] for rep in self._replicas])

    def _epoch(self, batches, epoch, epochs, verbose, callbacks, history) -> None:
        """Train one epoch over ``batches`` (host ``(x, y, sw)`` triples)
        and record its loss and metrics."""
        spec = self.model.training_spec
        metrics = [{n: MeanMetric(rep.device) for n in spec.metrics} for rep in self._replicas]
        losses: list = []
        for rep in self._replicas:
            rep.module.train()
        for xb, yb, sw in batches:
            self._step(xb, yb, sw, metrics, losses)
        if self.per_replica and self.frequency == "epoch":
            self._average()
        dev0 = self._replicas[0].device
        num = sum(loss.to(dev0) * w for loss, w in losses)
        epoch_loss = float(num) / max(sum(w for _, w in losses), 1.0)
        history["loss"].append(epoch_loss)
        for name in spec.metrics:
            total = MeanMetric(dev0)
            for m in metrics:
                total.total += m[name].total.to(dev0)
                total.count += m[name].count.to(dev0)
            history.setdefault(name, []).append(total.result())
        self.write_back()
        if verbose:
            logger.info("epoch %d/%d - loss %.4f", epoch + 1, epochs, epoch_loss)
        for cb in callbacks or ():
            cb(epoch, epoch_loss)

    def _fit_epochs(self, epoch_batches, epochs, verbose, callbacks) -> dict:
        self._ensure_replicas()
        was_training = self.model.training
        history: dict[str, list[float]] = {"loss": []}
        try:
            for epoch in range(epochs):
                self._epoch(epoch_batches(), epoch, epochs, verbose, callbacks, history)
            if self.per_replica and self.frequency == "fit":
                self._average()
                self.write_back()
        finally:
            for rep in self._replicas:
                rep.module.train(was_training)
        return history

    def fit(self, x, y, epochs: int = 1, batch_size: int = 32, verbose: int = 0,
            callbacks=None) -> dict:
        """Mini-batch training over the global batch; returns a Keras-style
        history (loss and each compiled metric). ``callbacks`` are
        ``cb(epoch, loss)``, called at epoch boundaries after the
        frequency's average, the master holding the canonical state."""
        x, y = np.asarray(x), np.asarray(y)
        n, dp = len(x), self.dp
        batch_size = self._round_batch(batch_size)
        nb_full = n // batch_size
        tail = n - nb_full * batch_size
        tail_padded = -(-tail // dp) * dp if tail else 0

        def batches():
            ones = np.ones(batch_size, np.float32)
            for b in range(nb_full):
                lo = b * batch_size
                yield x[lo:lo + batch_size], y[lo:lo + batch_size], ones
            if tail:
                xb, yb = x[nb_full * batch_size:], y[nb_full * batch_size:]
                pad = tail_padded - tail
                if pad:
                    xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
                    yb = np.concatenate([yb, np.repeat(yb[-1:], pad, axis=0)])
                sw = np.zeros(tail_padded, np.float32)
                sw[:tail] = 1.0
                yield xb, yb, sw

        return self._fit_epochs(batches, epochs, verbose, callbacks)

    def fit_stream(self, stream, epochs: int, verbose: int = 0, callbacks=None) -> dict:
        """Streamed training over a :class:`~elephas_tpu_torch.data.\
streaming.ShardedStream` of ``[DP, steps, B, ...]`` blocks: replica ``r``
        trains on row shard ``r`` (the one copy on all of them in order)."""
        check_stream(self.frequency, stream, self.dp,
                     "stream has {got} shards for a {want}-replica data axis")

        def batches():
            for xb, yb, steps in prefetch_blocks(stream.blocks()):
                for t in range(steps):
                    xt, yt = xb[:, t], yb[:, t]
                    flat = (len(xt) * xt.shape[1],)
                    yield (xt.reshape(flat + xt.shape[2:]), yt.reshape(flat + yt.shape[2:]),
                           np.ones(flat, np.float32))

        return self._fit_epochs(batches, epochs, verbose, callbacks)

    # -- evaluate and predict --------------------------------------------

    def _eval_module(self) -> nn.Module:
        """The canonical single copy for evaluation: replica 0, whose
        weights equal every replica's after each average."""
        return self._ensure_replicas()[0].module

    def evaluate(self, x, y, batch_size: int = 32) -> dict[str, float]:
        """``{'loss': ..., <metric>: ...}`` over every row, exactly: the
        data-parallel runner's evaluation
        (:meth:`~elephas_tpu_torch.worker.Runner.evaluate`) of the
        canonical copy, the last batch wrap-padded with rows of zero
        weight."""
        runner = Runner(self._eval_module(), "synchronous", "epoch")
        return runner.evaluate([(np.asarray(x), np.asarray(y))], self._round_batch(batch_size))

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """The outputs for every row, in order, as a host array; each
        wrap-padded batch is staged, run and fetched in turn, so a large
        input never lives on the device at once."""
        x = np.asarray(x)
        if len(x) == 0:
            raise ValueError("predict: no input rows")
        batch_size = self._round_batch(batch_size)
        idx = np.arange(-(-len(x) // batch_size) * batch_size) % len(x)
        module = self._eval_module()
        dev = self._replicas[0].device
        was_training = module.training
        module.eval()
        try:
            with torch.inference_mode():
                outs = [module(_stage(x[idx[lo:lo + batch_size]], dev)).cpu().numpy()
                        for lo in range(0, len(idx), batch_size)]
        finally:
            module.train(was_training)
        return np.concatenate(outs)[:len(x)]

    # -- sharded checkpoints ---------------------------------------------

    def _layouts(self) -> dict:
        return {name: var.layout for name, var in self._replicas[0].variables.items()}

    def save_checkpoint(self, directory: str, epoch: int, history=None) -> str:
        """One file a shard of the canonical single copy (parameters,
        persistent buffers and optimizer slots; a replicated variable in
        shard 0's file), and the ``meta.json`` sidecar
        (:func:`~elephas_tpu_torch.utils.checkpoint.save_sharded_checkpoint`).
        No file holds a sharded variable whole."""
        reps = self._ensure_replicas()
        files = [{} for _ in range(self.tp)]
        scalars = {}
        for name, var in reps[0].variables.items():
            for j, piece in enumerate(self._canonical(name)):
                files[j][name] = piece.detach()
            states = [reps[0].optimizer.state.get(s) for s in var.shards]
            for key, value in (states[0] or {}).items():
                if torch.is_tensor(value) and value.dim():
                    for j, st in enumerate(states):
                        files[j][f"{name}#{key}"] = st[key].detach()
                else:
                    scalars[f"{name}#{key}"] = value.item() if torch.is_tensor(value) else value
        meta = {"epoch": epoch, "history": history or {}, "model_parallel": self.tp,
                "layouts": self._layouts(), "scalars": scalars}
        return ckpt.save_sharded_checkpoint(directory, epoch, files, meta)

    @torch.no_grad()
    def restore_checkpoint(self, directory: str, custom_objects=None):
        """Load the newest sharded snapshot straight into each replica's
        shards, each file onto its shard's device, and into the master
        module. Returns its meta, or None when there is none."""
        found = ckpt.latest_sharded_checkpoint(directory)
        if found is None:
            return None
        path, meta = found
        reps = self._ensure_replicas()
        if meta.get("layouts") != self._layouts():
            raise ValueError(
                f"{path} was saved with other shard layouts than this trainer's "
                f"(model_parallel {meta.get('model_parallel')}, this mesh {self.tp})")
        for rep in reps:
            files = [ckpt.load_shard(path, j, dev) for j, dev in enumerate(rep.devices)]
            for name, var in rep.variables.items():
                for j, shard in enumerate(var.shards):
                    shard.copy_(files[j][name])
                    prefix = f"{name}#"
                    state = {k[len(prefix):]: v for k, v in files[j].items()
                             if k.startswith(prefix)}
                    state.update({k[len(prefix):]: v for k, v in meta["scalars"].items()
                                  if k.startswith(prefix)})
                    if state:
                        rep.optimizer.state[shard] = state
        self.write_back()
        return meta

    def sharding_summary(self) -> dict[str, str]:
        """Trainable variable path → partition spec, as the reference
        prints it."""
        return {v.path: str(s) for v, s in zip(self._trainable, self._tv_specs)}

    def shard_bytes(self) -> list[int]:
        """Bytes of parameters and persistent buffers of one copy held on
        each model-axis position (a replicated variable on position 0)."""
        out = [0] * self.tp
        for var in self._ensure_replicas()[0].variables.values():
            for j, s in enumerate(var.shards):
                out[j] += s.numel() * s.element_size()
        return out


class TensorParallelRunner:
    """The runner interface :class:`~elephas_tpu_torch.SparkModel` drives,
    over a :class:`ShardedTrainer`: RDD partitions are concatenated and
    re-split over the ``data`` axis (the row-shard → replica mapping takes
    the place of partition → worker)."""

    def __init__(self, model, mode: str, frequency: str, mesh: Mesh, rules=None):
        self.model = model
        self.mode = mode
        self.frequency = frequency
        self.mesh = mesh
        self.num_workers = mesh.shape["data"]
        self.trainer = ShardedTrainer(model, mesh=mesh, rules=rules, mode=mode,
                                      frequency=frequency)

    def _fit_partitions_to_mesh(self, partitions):
        # the trainer re-shards the rows itself: any partitioning goes
        return partitions

    @staticmethod
    def _concat(partitions):
        x = np.concatenate([np.asarray(p[0]) for p in partitions])
        y = np.concatenate([np.asarray(p[1]) for p in partitions])
        return x, y

    def run_epochs(self, partitions, epochs, batch_size, verbose=0, callbacks=()):
        x, y = self._concat(partitions)
        return self.trainer.fit(x, y, epochs=epochs, batch_size=batch_size, verbose=verbose,
                                callbacks=callbacks)

    def run_epochs_stream(self, stream, epochs, verbose=0, callbacks=()):
        return self.trainer.fit_stream(stream, epochs, verbose=verbose, callbacks=callbacks)

    def evaluate(self, partitions, batch_size=32):
        x, y = self._concat(partitions)
        return self.trainer.evaluate(x, y, batch_size=batch_size)

    def predict(self, feature_partitions, batch_size=32):
        x = np.concatenate([np.asarray(p) for p in feature_partitions if len(p)])
        return self.trainer.predict(x, batch_size=batch_size)

    def host_weights(self):
        """The canonical weights in Keras's ``get_weights()`` order (the
        parameter server's wire)."""
        from elephas_tpu_torch.utils.weights import get_weights

        self.trainer.write_back()
        return get_weights(self.model)

    def save_checkpoint(self, directory, epoch, history=None):
        return self.trainer.save_checkpoint(directory, epoch, history)

    def restore_checkpoint(self, directory, custom_objects=None):
        return self.trainer.restore_checkpoint(directory, custom_objects)


# -- decoding over a mesh ----------------------------------------------------


def decode_groups(mesh: Mesh, batch_axes, model_axis) -> list[list[torch.device]]:
    """For each batch shard of ``mesh`` (every index of ``batch_axes``, in
    row-major order; index 0 of any other axis), the devices along
    ``model_axis`` (only the first without one)."""
    names = mesh.axis_names
    lanes = [range(mesh.shape[a]) if a in batch_axes else [0] for a in names]
    groups = []
    for index in np.ndindex(*[len(r) for r in lanes]):
        pos = [lanes[i][k] for i, k in enumerate(index)]
        if model_axis in names:
            axis = names.index(model_axis)
            row = []
            for j in range(mesh.shape[model_axis]):
                pos[axis] = j
                row.append(mesh.devices[tuple(pos)])
            groups.append(row)
        else:
            groups.append([mesh.devices[tuple(pos)]])
    return groups


def decode_replicas(model, mesh: Mesh, batch_axes, model_axis, rules=None) -> list:
    """One copy of ``model`` a batch shard of ``mesh``: sharded over the
    model axis under the planner's layouts when ``model_axis`` is larger
    than 1 (the reference's ``_decode_shardings``), whole on the shard's
    device otherwise."""
    sharded = model_axis is not None and mesh.shape.get(model_axis, 1) > 1
    dims = {}
    if sharded:
        variables = [v for v in keras_variables(model) if v.trainable]
        specs = plan_sharding(variables, mesh, model_axis, rules)
        dims = {v.name: _port_dim(v, s, model_axis) for v, s in zip(variables, specs)}
    out = []
    for devices in decode_groups(mesh, batch_axes, model_axis if sharded else None):
        out.append(shard_module(model, dims, devices)[0].eval())
    return out


class ShardedSlotKVCache:
    """The slot arena of a copy from :func:`decode_replicas`: each
    attention layer's K/V caches, one a shard on the shard's device for a
    :class:`TensorParallelMHA` (its ``H/TP`` heads), one whole otherwise;
    ``layers()`` gives them in block order, as
    :func:`~elephas_tpu_torch.serving.kv_cache.token_decode_step` reads
    them."""

    def __init__(self, model, num_slots: int, max_len: int, device):
        from elephas_tpu_torch.serving.kv_cache import SlotKVCache

        self.caches = []
        for i, block in enumerate(model.blocks):
            attn = block.attn
            if isinstance(attn, TensorParallelMHA):
                parts = [SlotKVCache([(f"blk{i}_attn", sh)], num_slots, max_len, dev).layers()[0]
                         for sh, dev in zip(attn.shards, attn.devices)]
                self.caches.append(([k for k, _ in parts], [v for _, v in parts]))
            else:
                self.caches.append(SlotKVCache([(f"blk{i}_attn", attn)], num_slots, max_len,
                                               device).layers()[0])

    def layers(self):
        return self.caches
