"""Serving attention on Hopper: decode over the fixed KV arena as a
hand-written kernel, beside the tiled online-softmax functions of the
reference.

Counterpart of ``elephas_tpu/ops/flash_serving.py`` (plain XLA in the
reference, not Pallas), with the same public functions:

- :func:`span_buckets` / :func:`span_bucket_for` — the attention-span
  ladder (host code, copied);
- :func:`flash_span_chunk` — tiled attention of chunk queries over a
  resident K/V span, in plain PyTorch (chunked prefill is a later slice:
  it has no kernel yet);
- :func:`flash_span_decode` — one query row per slot over the span. A
  CUDA tensor goes through the kernel in ``csrc/span_decode.cu`` (the
  slots' positions stay on the device; the arena views are read through
  their strides; the span is split over :func:`span_splits` blocks whose
  partials merge by lse), a CPU tensor through :func:`flash_span_chunk`
  with one query row. Anything the kernel does not take raises: there is
  no fallback. :func:`span_decode_split_reference` repeats the kernel's
  split-then-merge arithmetic in plain PyTorch for the tests;
- :func:`flash_causal_prefill` — causal attention of a prompt bucket from
  position 0: on CUDA the port's flash forward kernel
  (:func:`elephas_tpu_torch.ops.flash_attention.flash_attention`, the
  same function), on the CPU the reference's tile loop.

Numerics: the online softmax evaluates the same softmax as a dense one in
another association order, so outputs agree to float tolerance. Rows that
see no key output zeros.
"""

from __future__ import annotations

import ctypes

import torch

from elephas_tpu_torch.ops import _native
from elephas_tpu_torch.ops.flash_attention import _sm_count, flash_attention

NEG_INF = -1e30
DEFAULT_BLOCK = 128
SPAN_FLOOR = 64
HEAD_DIMS = (16, 32, 64, 128)
# the kernel reads K/V rows as float4: pointers and strides in multiples
ALIGN_BYTES = 16
# span_splits: blocks wanted on each SM, the fewest key positions a split
# covers, and the most splits
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MIN_KEYS = 16
SPLIT_MAX = 64

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0


def span_buckets(maxlen: int, floor: int = SPAN_FLOOR) -> tuple[int, ...]:
    """Power-of-two attention-span ladder ``[floor, 2·floor, ..]`` capped
    at (and always including) ``maxlen``: decode attends over
    ``cache[:, :span]`` for the smallest bucket covering the live
    residents, not over the whole ``maxlen`` row."""
    if maxlen <= 0:
        raise ValueError(f"maxlen must be positive, got {maxlen}")
    buckets, b = [], max(1, int(floor))
    while b < maxlen:
        buckets.append(b)
        b *= 2
    buckets.append(int(maxlen))
    return tuple(buckets)


def span_bucket_for(n: int, buckets) -> int:
    """Smallest span bucket covering ``n`` resident positions."""
    for b in buckets:
        if b >= n:
            return int(b)
    raise ValueError(
        f"span of {n} positions exceeds the largest bucket "
        f"{max(buckets)}"
    )


def _online_update(m, l, acc, s, vt):
    """Fold the masked score tile ``s`` (``[..., bk]``, NEG_INF where
    invisible) and its value tile ``vt`` into ``(m, l, acc)``; ``p`` is
    zero while a row has seen nothing but mask."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(m_new[..., None] <= NEG_INF * 0.5, 0.0, p)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhck,bkhd->bhcd", p, vt)
    return m_new, l, acc


def flash_span_chunk(q, gk, gv, pos_mat, scale=None, block_k: int = DEFAULT_BLOCK):
    """Tiled attention of chunk queries over a resident K/V span.

    ``q``: ``[B, H, C, Dh]`` queries at absolute positions ``pos_mat``
    (``[B, C]`` integers); ``gk``/``gv``: ``[B, S, H, Dh]``, the arena rows
    cut to a span. Key ``j`` is visible to a query at position ``p`` iff
    ``j <= p``. Returns ``[B, H, C, Dh]`` float32. The K/V axis streams in
    ``block_k`` tiles; a row that sees no key outputs zeros."""
    b, h, c, dh = q.shape
    s_len = int(gk.shape[1])
    if scale is None:
        scale = dh ** -0.5
    q = q.float()
    m = torch.full((b, h, c), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, c, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b, h, c, dh, dtype=torch.float32, device=q.device)
    for j0 in range(0, s_len, block_k):
        j1 = min(s_len, j0 + block_k)
        kt, vt = gk[:, j0:j1].float(), gv[:, j0:j1].float()  # [B, bk, H, Dh]
        s = torch.einsum("bhcd,bkhd->bhck", q, kt) * scale
        cols = torch.arange(j0, j1, device=q.device)
        vis = cols[None, None, None, :] <= pos_mat[:, None, :, None]
        s = torch.where(vis, s, NEG_INF)
        m, l, acc = _online_update(m, l, acc, s, vt)
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]


def span_splits(span: int, rows: int, sm_count: int) -> tuple[int, int]:
    """How the kernel splits a span of ``span`` key positions for ``rows``
    (batch × heads) query rows on a card of ``sm_count`` SMs: returns
    ``(splits, chunk)``, split ``i`` covering positions ``[i·chunk,
    (i+1)·chunk)``. Enough splits that the grid holds about
    SPLIT_BLOCKS_PER_SM blocks an SM, none shorter than SPLIT_MIN_KEYS
    positions, at most SPLIT_MAX; one split when ``rows`` alone fill the
    card. Host values only: never the positions, so a call's split (and
    its bits) do not depend on where the cursors stand."""
    if span < 1 or rows < 1 or sm_count < 1:
        raise ValueError(f"span_splits takes positive sizes, got {span}, {rows}, {sm_count}")
    want = -(-SPLIT_BLOCKS_PER_SM * sm_count // rows)
    n = max(1, min(want, -(-span // SPLIT_MIN_KEYS), SPLIT_MAX))
    chunk = -(-span // n)
    return -(-span // chunk), chunk


def span_decode_split_reference(q, gk, gv, positions, splits: int, chunk: int, scale=None):
    """The kernel's split-then-merge arithmetic in plain PyTorch (for the
    tests; the card's reference stays :func:`flash_span_chunk`): split
    ``i`` attends over the visible keys of positions ``[i·chunk,
    (i+1)·chunk)`` into an unnormalised partial ``(m, l, acc)``, the empty
    state ``(NEG_INF, 0, 0)`` when it sees none; the partials merge in
    split order by lse. Shapes as :func:`flash_span_decode`."""
    b, h, d = q.shape
    s_len = int(gk.shape[1])
    if splits * chunk < s_len:
        raise ValueError(f"{splits} splits of {chunk} do not cover a span of {s_len}")
    if scale is None:
        scale = d ** -0.5
    q = q.float()
    n = torch.clamp(positions.long() + 1, min=0, max=s_len)  # visible keys a slot
    parts = []
    for i in range(splits):
        j0, j1 = i * chunk, min(s_len, (i + 1) * chunk)
        kt, vt = gk[:, j0:j1].float(), gv[:, j0:j1].float()  # [B, c, H, D]
        s = torch.einsum("bhd,bkhd->bhk", q, kt) * scale
        vis = torch.arange(j0, j1, device=q.device)[None, None, :] < n[:, None, None]
        s = torch.where(vis, s, NEG_INF)
        m = torch.where(vis.any(-1), s.amax(-1), NEG_INF)
        p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bhk,bkhd->bhd", p, vt)))
    live = [pt[1] > 0 for pt in parts]
    mx = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    for (m, _, _), ok in zip(parts, live):
        mx = torch.where(ok, torch.maximum(mx, m), mx)
    l = torch.zeros(b, h, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b, h, d, dtype=torch.float32, device=q.device)
    for (m, ls, a), ok in zip(parts, live):
        e = torch.where(ok, torch.exp(m - mx), 0.0)
        l = l + ls * e
        acc = acc + a * e[..., None]
    return torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)


def _kernel():
    lib = _native.library("span_decode")
    fn = lib.elephas_span_decode
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ll] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.elephas_cuda_error_string.argtypes = [ctypes.c_int]
        lib.elephas_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_operands(q, gk, gv, positions):
    """Raise on what the kernel does not take: float32 only, q ``[B, H, D]``
    contiguous with D in HEAD_DIMS, K/V ``[B, S, H, D]`` views with unit
    stride on D and 16-byte aligned pointers and strides, positions
    ``[B]`` int32, all on one device."""
    if q.ndim != 3:
        raise ValueError(f"span_decode takes q [B, H, D], got {tuple(q.shape)}")
    b, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"span_decode takes head_dim in {HEAD_DIMS}, got {d}")
    if not q.is_contiguous():
        raise ValueError(f"span_decode takes a contiguous q, got strides {tuple(q.stride())}")
    for name, t in (("q", q), ("k", gk), ("v", gv)):
        if t.dtype != torch.float32:
            raise ValueError(f"span_decode takes float32, {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("k", gk), ("v", gv)):
        if t.ndim != 4 or t.shape[0] != b or t.shape[2:] != (h, d) or t.shape[1] < 1:
            raise ValueError(
                f"{name} must be [B, S, H, D] = [{b}, S >= 1, {h}, {d}], got {tuple(t.shape)}"
            )
        st = t.stride()
        if st[-1] != 1 or min(st) < 0:
            raise ValueError(f"{name} needs unit stride on head_dim, got strides {tuple(st)}")
        # pointer and strides in bytes are multiples of ALIGN_BYTES iff their OR is
        if (t.data_ptr() | (st[0] | st[1] | st[2]) * 4) % ALIGN_BYTES:
            raise ValueError(
                f"{name} needs a {ALIGN_BYTES}-byte-aligned base pointer and strides "
                f"for the kernel's float4 loads, got pointer {t.data_ptr()} and "
                f"strides {tuple(st)}"
            )
    if q.data_ptr() % ALIGN_BYTES:
        raise ValueError(f"q needs a {ALIGN_BYTES}-byte-aligned base pointer")
    if gk.shape[1] != gv.shape[1]:
        raise ValueError(f"k spans {gk.shape[1]} positions, v {gv.shape[1]}")
    if positions.dtype != torch.int32 or positions.shape != (b,) \
            or positions.device != q.device or not positions.is_contiguous():
        raise ValueError(
            f"positions must be contiguous int32 [{b}] on {q.device}, got "
            f"{positions.dtype} {tuple(positions.shape)} on {positions.device}"
        )
    if b > 65535 or h > 65535:
        raise ValueError(f"span_decode takes at most 65535 slots and heads, got {b} and {h}")


def _launch(q, gk, gv, positions, scale: float):
    """One call of the kernel on checked CUDA operands (with more than one
    split, the split kernel and then the merge kernel); returns
    ``[B, H, D]`` float32."""
    global launches
    b, h, d = q.shape
    span = gk.shape[1]
    splits, chunk = span_splits(span, b * h, _sm_count(q.device.index))
    out = torch.empty_like(q)
    # partials: acc [B·H, splits, D] and (m, l) [B·H, splits, 2]
    work = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.elephas_span_decode(
            q.data_ptr(), gk.data_ptr(), gv.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), b, h, d, span, splits, chunk,
            *gk.stride()[:3], *gv.stride()[:3], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            "span_decode launch failed: " + lib.elephas_cuda_error_string(err).decode()
        )
    launches += 1
    return out


def flash_span_decode(q, gk, gv, positions, scale=None, block_k: int = DEFAULT_BLOCK):
    """One-row decode attention over a K/V span: ``q`` ``[B, H, Dh]`` at
    per-slot ``positions`` ``[B]``, ``gk``/``gv`` ``[B, S, H, Dh]``
    (``cache[:, :span]`` views of the arena). Returns ``[B, H, Dh]``
    float32.

    A CUDA tensor launches the span-decode kernel (``positions`` int32 on
    the device; ``block_k`` is the CPU version's tile); a CPU tensor runs
    :func:`flash_span_chunk` with one query row."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _forward(q, gk, gv, positions, float(scale), block_k)


def _forward(q, gk, gv, positions, scale: float, block_k: int):
    """CPU tensors take the plain version; CUDA tensors are checked and
    launch the kernel."""
    if q.device.type == "cpu":
        out = flash_span_chunk(q[:, :, None], gk, gv, positions[:, None], scale, block_k)
        return out[:, :, 0]
    if q.device.type != "cuda":
        raise ValueError(f"span_decode runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, gk, gv, positions)
    return _launch(q, gk, gv, positions, scale)


def flash_causal_prefill(q, k, v, scale=None, block_q: int = DEFAULT_BLOCK,
                         block_k: int = DEFAULT_BLOCK):
    """Causal self-attention of a whole prompt bucket from position 0:
    ``q``/``k``/``v`` ``[B, H, S, Dh]`` (any strides with unit stride on
    Dh), returns ``[B, H, S, Dh]`` float32.

    Off the CPU this is the flash forward kernel with ``causal=True`` (its
    own tiling; ``block_q``/``block_k`` tile the CPU version only). On the
    CPU, the reference's tile loop: K/V tiles wholly in a query tile's
    future are skipped and only the diagonal-crossing tile is masked."""
    b, h, s_len, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    if q.device.type != "cpu":
        # the flash wrapper validates that its blocks divide S; the kernel
        # tiles with its own
        return flash_attention(q, k, v, causal=True, scale=scale,
                               block_q=s_len, block_k=s_len)
    q = q.float()
    out = []
    for i0 in range(0, s_len, block_q):
        i1 = min(s_len, i0 + block_q)
        qt = q[:, :, i0:i1]
        bq = i1 - i0
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32)
        l = torch.zeros(b, h, bq, dtype=torch.float32)
        acc = torch.zeros(b, h, bq, dh, dtype=torch.float32)
        for j0 in range(0, i1, block_k):  # j0 >= i1 is wholly future
            j1 = min(s_len, j0 + block_k)
            kt = k[:, :, j0:j1].transpose(1, 2).float()  # [B, bk, H, Dh]
            vt = v[:, :, j0:j1].transpose(1, 2).float()
            s = torch.einsum("bhcd,bkhd->bhck", qt, kt) * scale
            if j1 > i0:  # diagonal-crossing tile: mask the future half
                visible = torch.arange(j0, j1)[None, :] <= torch.arange(i0, i1)[:, None]
                s = torch.where(visible[None, None], s, NEG_INF)
            m, l, acc = _online_update(m, l, acc, s, vt)
        out.append(acc / torch.where(l == 0.0, 1.0, l)[..., None])
    return torch.cat(out, dim=2)
