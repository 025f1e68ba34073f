"""Quantized paged-KV block codec.

Copy of ``elephas_tpu/serving/kv_quant.py`` on tensors, with its numpy
twins. Pool blocks store int8 codes, or int4 codes packed two to a byte,
with one float32 scale per (position, head): each token's write touches
only its own row, so quantize-on-write needs no read-modify-write of a
shared statistic, and an offloaded block is a self-contained byte string.

Symmetric quantization without a zero point::

    scale = max(|x|) / qmax        (qmax: 127 for int8, 7 for int4)
    q     = round(x / scale)  in [-qmax, qmax]   (round half to even)
    x'    = q * scale

An all-zero row quantizes to ``scale == 0`` and dequantizes to exact zeros.
int4 packs two signed nibbles per byte along the head axis: the even index
in the low nibble, the odd index in the high one (an odd head dim pads the
last high nibble with zero); unpacking sign-extends by shifts.

The tensor functions and the numpy twins make the same decisions bit for
bit: the same float32 division, the same rounding, the same nibble order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "KV_DTYPES",
    "QMAX",
    "check_kv_dtype",
    "packed_head_dim",
    "pool_bytes_per_pos",
    "quantize_rows",
    "dequantize_rows",
    "pack_int4",
    "unpack_int4",
    "quantize_rows_np",
    "dequantize_rows_np",
]

KV_DTYPES = ("fp", "int8", "int4")

QMAX = {"int8": 127.0, "int4": 7.0}


def check_kv_dtype(kv_dtype: str) -> str:
    """Validate a ``kv_dtype`` value (the reference's message)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
        )
    return kv_dtype


def packed_head_dim(head_dim: int, kv_dtype: str) -> int:
    """Stored last-axis width of one ``head_dim``-wide row: ``Dh`` bytes for
    int8 (and the fp width for ``"fp"``), ``ceil(Dh / 2)`` for int4."""
    if kv_dtype == "int4":
        return -(-int(head_dim) // 2)
    return int(head_dim)


def pool_bytes_per_pos(specs, kv_dtype: str) -> int:
    """Bytes one resident position costs over all layers, K and V: the KV
    price the equal-bytes concurrency comparisons divide by. ``specs`` is
    ``[(name, heads, head_dim), ...]``."""
    if kv_dtype == "fp":
        return sum(h * d for _, h, d in specs) * 2 * 4
    # quantized: one byte a stored value and one f32 scale a head
    return sum(
        h * packed_head_dim(d, kv_dtype) + h * 4 for _, h, d in specs
    ) * 2


def pack_int4(q):
    """Pack int4 values (int8 storage, range [-7, 7]) two a byte along the
    last axis: ``[..., D]`` int8 → ``[..., ceil(D/2)]`` int8."""
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    lo = q[..., 0::2].to(torch.int32)
    hi = q[..., 1::2].to(torch.int32)
    return (((lo & 0x0F) | (hi << 4)) & 0xFF).to(torch.uint8).view(torch.int8)


def unpack_int4(p, head_dim: int):
    """Inverse of :func:`pack_int4`: ``[..., ceil(D/2)]`` int8 →
    ``[..., head_dim]`` int8, each nibble sign-extended by shifts."""
    p = p.to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (2 * p.shape[-1],))
    return out[..., : int(head_dim)].to(torch.int8)


def quantize_rows(x, kv_dtype: str):
    """Quantize rows ``[..., H, Dh]`` → ``(q, scale)``: ``q`` int8 ``[..., H,
    Dhp]`` (int4 packed when asked), ``scale`` float32 ``[..., H]``."""
    qmax = QMAX[kv_dtype]
    x = x.float()
    amax = x.abs().amax(dim=-1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient the numpy
    # twin (and the reference) takes
    scale = amax / torch.full_like(amax, qmax)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None]), -qmax, qmax).to(torch.int8)
    if kv_dtype == "int4":
        q = pack_int4(q)
    return q, scale


def dequantize_rows(q, scale, kv_dtype: str, head_dim: int):
    """Inverse of :func:`quantize_rows`: ``(q [..., H, Dhp] int8, scale
    [..., H] f32)`` → float32 ``[..., H, head_dim]``, one ``code * scale``
    product a value."""
    if kv_dtype == "int4":
        q = unpack_int4(q, head_dim)
    return q.float() * scale.float()[..., None]


def quantize_rows_np(x, kv_dtype: str):
    """Numpy twin of :func:`quantize_rows`."""
    qmax = QMAX[kv_dtype]
    x = np.asarray(x, dtype=np.float32)
    amax = np.max(np.abs(x), axis=-1)
    scale = (amax / qmax).astype(np.float32)
    safe = np.where(scale > 0.0, scale, 1.0)
    q = np.clip(np.round(x / safe[..., None]), -qmax, qmax).astype(np.int8)
    if kv_dtype == "int4":
        d = q.shape[-1]
        if d % 2:
            pad = [(0, 0)] * (q.ndim - 1) + [(0, 1)]
            q = np.pad(q, pad)
        q = ((q[..., 0::2] & 0x0F) | (q[..., 1::2] << 4)).astype(np.int8)
    return q, scale


def dequantize_rows_np(q, scale, kv_dtype: str, head_dim: int):
    """Numpy twin of :func:`dequantize_rows`."""
    q = np.asarray(q, dtype=np.int8)
    if kv_dtype == "int4":
        lo = (q << 4) >> 4
        hi = q >> 4
        q = np.stack([lo, hi], axis=-1).reshape(
            q.shape[:-1] + (2 * q.shape[-1],)
        )[..., : int(head_dim)]
    return q.astype(np.float32) * np.asarray(scale, dtype=np.float32)[..., None]
