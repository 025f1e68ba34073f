"""Flash attention on Hopper: a hand-written forward kernel, its plain
PyTorch version, and the backward in plain PyTorch.

Counterpart of ``elephas_tpu/ops/flash_attention.py`` with the same public
surface. A CUDA tensor goes through the hand-written kernel in
``csrc/flash_fwd.cu`` (one kernel for every layout: it reads q, k and v,
and writes out, through (batch, head, seq) strides); a CPU tensor goes
through :func:`flash_forward_reference`, the dense fp32 softmax with the
kernel's conventions. A tensor on any other device, or one the kernel does
not take, raises.

``block_q``/``block_k`` are validated exactly as the reference validates
them (:func:`_resolve_blocks`, on both devices); the kernel tiles with its
own blocks of 16 q rows a warp (:func:`launch_config` picks the warps a
block from the shape and the card's SM count) and masks its ragged edges
itself.

The backward (:func:`flash_backward`) is the reference's
``_flash_backward`` recurrence written densely per head in plain PyTorch,
one code path on both devices: the JAX package computes it with XLA
einsums, not a Pallas kernel, and a hand kernel for it is later work
(ROADMAP.md, Queue A).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from elephas_tpu_torch.ops import _native

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's blocks: 16 q rows a warp, 4 or 8 warps
ROWS_PER_WARP = 16
WARP_CHOICES = (4, 8)
# cp.async copies 16 bytes: base pointers and strides must be multiples
ALIGN_BYTES = 16

# kernel launches since the last reset (chip_smoke.py reads them), and
# those of them on the bf16 route
launches = 0
bf16_launches = 0

def _resolve_blocks(block_q, block_k, s_q, s_k):
    block_q = min(block_q, s_q)
    block_k = min(block_k, s_k)
    if s_q % block_q or s_k % block_k:
        raise ValueError(
            f"sequence lengths ({s_q}, {s_k}) must be multiples of the "
            f"block sizes ({block_q}, {block_k})"
        )
    return block_q, block_k


def packed_layout_supported(d: int, h: int) -> bool:
    """Whether the reference's packed-qkv TPU kernels take this
    (head_dim, heads). The port's kernel reads every layout through
    strides, so its dispatch does not depend on it."""
    return d % 128 == 0 or (d == 64 and h % 2 == 0)


def flash_forward_reference(q, k, v, scale: float, causal: bool):
    """Plain version of the kernel: ``[..., S, D]`` inputs →
    ``(out [..., Sq, D] in q's dtype, lse [..., Sq] fp32)``.

    Dense fp32 softmax with the kernel's conventions: masked scores are
    ``NEG_INF``, and a row with every score masked outputs zeros with
    lse ``NEG_INF``."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        rows = torch.arange(s_q, device=s.device)[:, None]
        cols = torch.arange(s_k, device=s.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p, vf) / safe_l
    return out.to(q.dtype), (m + torch.log(safe_l))[..., 0]


def attention_reference(q, k, v, causal: bool = False, scale: float | None = None):
    """Naive O(S²)-memory attention — the correctness oracle for tests."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        rows = torch.arange(s_q, device=s.device)[:, None]
        cols = torch.arange(s_k, device=s.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


class LaunchConfig(NamedTuple):
    warps: int
    block_q: int  # q rows of a block
    blocks: int  # blocks in the grid


def launch_config(b, h, s_q, s_k, d, dtype, sm_count) -> LaunchConfig:
    """The kernel's launch for a shape: 8 warps (128 q rows a block) where
    that grid fills at least half a wave of ``sm_count`` SMs, else 4
    warps (64 rows). A pure function of its arguments; ``s_k``, ``d`` and
    ``dtype`` do not change the choice today (every block fits each
    (dtype, D) in shared memory)."""
    if d not in HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"no launch for head_dim {d}, {dtype}")

    def blocks(warps):
        return -(-s_q // (ROWS_PER_WARP * warps)) * b * h

    warps = 8 if 2 * blocks(8) >= sm_count else 4
    return LaunchConfig(warps, ROWS_PER_WARP * warps, blocks(warps))


def _kernel():
    lib = _native.library("flash_fwd")
    fn = lib.elephas_flash_fwd
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ll] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.elephas_cuda_error_string.argtypes = [ctypes.c_int]
        lib.elephas_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_operands(q, k, v, out):
    # one pass over the operands: this runs on every call, on the host
    dev, dtype, item = q.device, q.dtype, q.element_size()
    misaligned = None
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        st = t.stride()
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {dtype}")
        if st[-1] != 1 or min(st) < 0:
            raise ValueError(
                f"{name} needs unit stride on head_dim and non-negative "
                f"strides, got {tuple(st)}"
            )
        # the base pointer and the (batch, head, seq) strides in bytes are
        # multiples of ALIGN_BYTES (a power of two) iff their OR is
        if misaligned is None and (t.data_ptr() | (st[0] | st[1] | st[2]) * item) % ALIGN_BYTES:
            misaligned = name, t
    if dtype not in _DTYPES:
        raise ValueError(
            f"the flash kernel takes float32 or bfloat16, got {dtype}"
        )
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS}, got {d}")
    b, h, s_q, _ = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[-1] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} does not match q {tuple(q.shape)}")
    if b * h > 65535:
        raise ValueError(f"batch·heads = {b * h} exceeds the kernel grid's 65535")
    if misaligned:
        name, t = misaligned
        raise ValueError(
            f"{name} needs a {ALIGN_BYTES}-byte-aligned base pointer and "
            f"(batch, head, seq) strides for the kernel's async copies, got "
            f"pointer {t.data_ptr()} and strides {tuple(t.stride())}"
        )


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _forward(q, k, v, out, scale: float, causal: bool):
    """Attention of ``[B, H, S, D]`` views (any strides with unit stride
    on D) into the ``[B, H, Sq, D]`` view ``out``; returns lse ``[B·H, Sq]``
    fp32. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    b, h, s_q, _ = q.shape
    if q.device.type == "cpu":
        o, lse = flash_forward_reference(q, k, v, scale, causal)
        out.copy_(o)
        return lse.reshape(b * h, s_q)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, k, v, out)
    cfg = launch_config(b, h, s_q, k.shape[2], q.shape[-1], q.dtype, _sm_count(q.device.index))
    return _launch(q, k, v, out, scale, causal, cfg.warps)


def _launch(q, k, v, out, scale: float, causal: bool, warps: int):
    """One launch of the kernel on checked CUDA operands with blocks of
    ``warps`` warps; returns lse ``[B·H, Sq]``."""
    global launches, bf16_launches
    b, h, s_q, _ = q.shape
    lse = torch.empty(b * h, s_q, dtype=torch.float32, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.elephas_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPES[q.dtype], b, h, s_q, k.shape[2], q.shape[-1],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), int(bool(causal)), warps,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            "flash kernel launch failed: "
            + lib.elephas_cuda_error_string(err).decode()
        )
    launches += 1
    bf16_launches += q.dtype is torch.bfloat16
    return lse


def _flash_forward(q, k, v, scale, causal, block_q, block_k):
    """``[B, H, S, D]`` inputs → (out ``[B, H, Sq, D]``, lse ``[B·H, Sq]``).
    The output is a view of sequence-major ``[B, Sq, H, D]`` storage."""
    b, h, s_q, d = q.shape
    _resolve_blocks(block_q, block_k, s_q, k.shape[2])
    out = torch.empty(b, s_q, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    return out, _forward(q, k, v, out, scale, causal)


def _flash_forward_packed(qkv, scale, causal, block_q, block_k):
    """Packed ``[B, S, 3, H, D]`` qkv → (out ``[B, S, H, D]``, lse
    ``[B·H, S]``). q, k and v are strided views of the one array, and the
    output is written sequence-major: no transpose is materialised."""
    b, s, _, h, d = qkv.shape
    _resolve_blocks(block_q, block_k, s, s)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = torch.empty(b, s, h, d, dtype=qkv.dtype, device=qkv.device)
    return out, _forward(q, k, v, out.transpose(1, 2), scale, causal)


def flash_backward(q, k, v, out, lse, grad_out, scale: float, causal: bool):
    """Gradients of attention from the forward's residuals: ``[..., S, D]``
    q, k, v, out and ``grad_out``, lse ``[..., Sq]`` f32 →
    ``(dq, dk, dv)`` in the inputs' dtypes.

    The reference's recurrence (``_flash_backward``), dense per head in
    fp32: P is recomputed from lse, ``Δ = rowsum(dO∘O)``,
    ``dS = P∘(dO·vᵀ − Δ)``; masked scores are ``NEG_INF``, and a row whose
    every score is masked (lse ``NEG_INF``) has P = 0."""
    qf, kf, vf = q.float(), k.float(), v.float()
    gf = grad_out.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        rows = torch.arange(s_q, device=s.device)[:, None]
        cols = torch.arange(s_k, device=s.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    lse = lse[..., None]
    p = torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(s), torch.exp(s - lse))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        out, lse = _flash_forward(q, k, v, scale, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, s_q, _ = q.shape
        grads = flash_backward(q, k, v, out, lse.view(b, h, s_q), grad_out,
                               ctx.scale, ctx.causal)
        return (*grads, None, None, None, None)


class _FlashAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale, causal, block_q, block_k):
        out, lse = _flash_forward_packed(qkv, scale, causal, block_q, block_k)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        """``d(qkv)`` ``[B, S, 3, H, D]`` in the packed layout."""
        qkv, out, lse = ctx.saved_tensors
        b, s, _, h, _ = qkv.shape
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        grads = flash_backward(q, k, v, out.transpose(1, 2), lse.view(b, h, s),
                               grad_out.transpose(1, 2), ctx.scale, ctx.causal)
        dqkv = torch.stack([g.transpose(1, 2) for g in grads], dim=2)
        return dqkv, None, None, None, None


def flash_attention_qkv(
    qkv,
    causal: bool = False,
    scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
):
    """Self-attention straight from a fused qkv projection.

    ``qkv``: ``[B, S, 3, H, D]`` — the packed output of one
    ``Linear(3·H·D)`` viewed, exactly as produced. Returns ``[B, S, H, D]``.
    The kernel reads q/k/v through strides over the one packed array and
    writes the output in the sequence-major layout the next projection
    consumes."""
    if block_q is None:
        block_q = DEFAULT_BLOCK_Q
    if block_k is None:
        block_k = DEFAULT_BLOCK_K
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    return _FlashAttentionQKV.apply(
        qkv, float(scale), bool(causal), int(block_q), int(block_k)
    )


def flash_attention(
    q,
    k,
    v,
    causal: bool = False,
    scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
):
    """Blockwise attention. ``q/k/v``: ``[batch, heads, seq, head_dim]``
    (or ``[bh, seq, head_dim]``); any strides with unit stride on
    head_dim. The result has q's shape; in 4-D it is a view of
    sequence-major storage, so ``out.transpose(1, 2)`` is contiguous.

    ``block_q``/``block_k`` default to the module-level
    ``DEFAULT_BLOCK_Q``/``DEFAULT_BLOCK_K``, resolved at call time."""
    if block_q is None:
        block_q = DEFAULT_BLOCK_Q
    if block_k is None:
        block_k = DEFAULT_BLOCK_K
    if scale is None:
        scale = q.shape[-1] ** -0.5
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[:, None], k[:, None], v[:, None]
    out = _FlashAttention.apply(
        q, k, v, float(scale), bool(causal), int(block_q), int(block_k)
    )
    return out[:, 0] if squeeze else out
