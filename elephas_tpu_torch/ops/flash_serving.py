"""Serving attention on Hopper: decode and chunk attention over the fixed KV
arena as hand-written kernels, beside the tiled online-softmax functions of
the reference.

Counterpart of ``elephas_tpu/ops/flash_serving.py`` (plain XLA in the
reference, not Pallas), with the same public functions:

- :func:`span_buckets` / :func:`span_bucket_for` — the attention-span
  ladder (host code, copied);
- :func:`flash_span_chunk` — attention of chunk queries over a resident
  K/V span (chunked prefill, the suffix after a prefix-cache hit, the
  speculative verify pass). A CUDA tensor goes through the kernel in
  ``csrc/span_chunk.cu`` (3xTF32 tensor-core products; 64-key K/V tiles
  staged in shared memory serve a group of 64 chunk rows; the positions
  stay on the device; the span is split over :func:`span_chunk_splits`
  blocks whose partials merge by lse), a CPU tensor through
  :func:`span_chunk_reference`, the reference's tile loop. Anything the
  kernel does not take raises. :func:`span_chunk_split_reference` repeats
  the kernel's split-then-merge arithmetic in plain PyTorch for the tests;
- :func:`flash_span_decode` — one query row per slot over the span. A
  CUDA tensor goes through the kernel in ``csrc/span_decode.cu`` (the
  slots' positions stay on the device; the arena views are read through
  their strides; the span is split over :func:`span_splits` blocks whose
  partials merge by lse), a CPU tensor through :func:`span_chunk_reference`
  with one query row. Anything the kernel does not take raises: there is
  no fallback. :func:`span_decode_split_reference` repeats the kernel's
  split-then-merge arithmetic in plain PyTorch for the tests;
- :func:`flash_causal_prefill` — causal attention of a prompt bucket from
  position 0: on CUDA the port's flash forward kernel
  (:func:`elephas_tpu_torch.ops.flash_attention.flash_attention`, the
  same function), on the CPU the reference's tile loop;
- :func:`flash_paged_span_decode` / :func:`flash_paged_span_chunk` — the
  same two attentions over the paged KV pool: key ``j`` of row ``b`` lives
  in pool block ``tables[b, j // block_size]``, row ``j % block_size``, and
  the pool holds float32 rows (``kv_dtype="fp"``) or int8 / packed int4
  codes with per-(position, head) scales, dequantized as a tile lands. A
  CUDA tensor launches the block-table variants of the two kernels (the
  same split rules over the table span ``T · block_size``), a CPU tensor
  their plain versions :func:`paged_span_decode_reference` /
  :func:`paged_span_chunk_reference`: gather through the table, dequantize,
  then the tile loop above. The paged chunk merges up to
  CHUNK_CLUSTER_MAX splits inside a thread-block cluster, with no
  workspace and no second launch.

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
# the span-chunk kernel: keys a staged tile (a split is whole tiles), query
# rows a block, and the blocks an SM holds at once (141 KB of shared memory
# and 195 registers a thread at head_dim 128, 165 at 64: one)
CHUNK_TILE = 64
CHUNK_GROUP = 64
CHUNK_BLOCKS_PER_SM = 1
# the paged span chunk merges 2 to CHUNK_CLUSTER_MAX splits in a thread-block
# cluster (no workspace); more take a workspace and a merge kernel
CHUNK_CLUSTER_MAX = 8
LOG2E = 1.4426950408889634

# kernel launches since the last reset: span decode, span chunk and their
# paged variants (chip_smoke.py reads them)
launches = 0
chunk_launches = 0
paged_launches = 0
paged_chunk_launches = 0
# kv_dtype -> the C entries' code; the stored type of each pool
KV_CODES = {"fp": 0, "int8": 1, "int4": 2}
# kv_dtype -> (the pool's dtype, values a stored element)
_STORED = {"fp": (torch.float32, 1), "int8": (torch.int8, 1), "int4": (torch.int8, 2)}
_F32, _I32 = torch.float32, torch.int32
_CHUNK_LIB = None  # the span-chunk library, its argument types set (_chunk_kernel)
_PAGED_DECODE = {}  # device index -> the paged decode's C function, ready there
_PAGED_CHUNK = {}  # device index -> the paged chunk's C function, ready there
_SMS = {}  # device index -> SM count


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


def span_chunk_reference(q, gk, gv, pos_mat, scale=None, block_k: int = DEFAULT_BLOCK):
    """The plain version of :func:`flash_span_chunk`: the reference's tiled
    attention of chunk queries over a resident K/V span.

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
    tests; the card's reference stays :func:`span_chunk_reference`): scores
    in log2 units (scaled by ``scale · log2(e)``, the softmax in exp2);
    split ``i`` attends over the visible keys of positions ``[i·chunk,
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
        s = torch.einsum("bhd,bkhd->bhk", q, kt) * (scale * LOG2E)
        vis = torch.arange(j0, j1, device=q.device)[None, None, :] < n[:, None, None]
        s = torch.where(vis, s, NEG_INF)
        m = torch.where(vis.any(-1), s.amax(-1), NEG_INF)
        p = torch.where(vis, torch.exp2(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bhk,bkhd->bhd", p, vt)))
    live = [pt[1] > 0 for pt in parts]
    mx = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    for (m, _, _), ok in zip(parts, live):
        mx = torch.where(ok, torch.maximum(mx, m), mx)
    l = torch.zeros(b, h, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b, h, d, dtype=torch.float32, device=q.device)
    for (m, ls, a), ok in zip(parts, live):
        e = torch.where(ok, torch.exp2(m - mx), 0.0)
        l = l + ls * e
        acc = acc + a * e[..., None]
    return torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)


def span_chunk_splits(span: int, rows: int, c: int, head_dim: int,
                      sm_count: int) -> tuple[int, int]:
    """How the span-chunk kernel splits a span of ``span`` key positions
    for ``rows`` (batch × heads) slots' chunks of ``c`` query rows of
    ``head_dim`` on a card of ``sm_count`` SMs: returns ``(splits,
    chunk)``, split ``i`` covering positions ``[i·chunk, (i+1)·chunk)``,
    ``chunk`` a whole number of CHUNK_TILE-key tiles.

    Unsplit, the grid holds ``blocks = rows · groups`` blocks (``groups`` =
    ceil(c / CHUNK_GROUP) row groups a slot). The span is split only as far
    as the card needs more blocks: while the grid stays within one wave of
    CHUNK_BLOCKS_PER_SM blocks an SM (past that the blocks queue, and a
    split's partials and merge cost more than the wave gains: measured on
    an H100, PERF.md §6), and at most into its tiles. And only while the
    partials a block writes (``CHUNK_GROUP · (head_dim + 2)`` floats a
    split, read back by the merge) stay below the K and V floats its row
    group reads of the span that the split spreads (``2 · span ·
    head_dim``). One split writes the output directly: no workspace, no
    merge. Host values only: never the positions, so a call's split (and
    its bits) do not depend on where the cursors stand."""
    if min(span, rows, c, head_dim, sm_count) < 1:
        raise ValueError(
            f"span_chunk_splits takes positive sizes, got {span}, {rows}, {c}, "
            f"{head_dim}, {sm_count}"
        )
    tiles = -(-span // CHUNK_TILE)
    blocks = rows * -(-c // CHUNK_GROUP)
    want = CHUNK_BLOCKS_PER_SM * sm_count // blocks
    # the most splits whose partials stay below the K/V floats: n·P < K
    cap = (2 * span * head_dim - 1) // (CHUNK_GROUP * (head_dim + 2))
    n = max(1, min(want, tiles, cap))
    chunk = CHUNK_TILE * -(-tiles // n)
    return -(-span // chunk), chunk


def _fold(state, s, vt):
    """One step of the exp2 online softmax: the masked scores ``s`` (``[B,
    H, C, k]``, NEG_INF where invisible, already in log2 units) and their
    values ``vt`` (``[B, k, H, D]``) fold into ``state = (m, l, acc)``."""
    m, l, acc = state
    m_new = torch.maximum(m, s.amax(-1))
    dead = m_new <= NEG_INF * 0.5
    p = torch.where(dead[..., None], 0.0, torch.exp2(s - m_new[..., None]))
    alpha = torch.exp2(m - m_new)
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha[..., None] + torch.einsum("bhck,bkhd->bhcd", p, vt))


def _normalise(l, acc):
    return acc * torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)[..., None]


def span_chunk_split_reference(q, gk, gv, pos_mat, splits: int, chunk: int, scale=None,
                               slots=None):
    """The span-chunk kernel's arithmetic in plain PyTorch, in its order
    (for the tests; the card's reference stays :func:`span_chunk_reference`):
    q scaled by ``scale · log2(e)`` (the kernel's softmax is in exp2); in
    split ``i`` (positions ``[i·chunk, (i+1)·chunk)``) two online-softmax
    states, one folding the first CHUNK_TILE / 2 keys of every tile and one
    the last (keys past a row's visible count masked), the second folded
    into the first at the end; the split's partial ``(m, l, acc)`` is the
    empty state ``(NEG_INF, 0, 0)`` when it sees no key. One split gives
    ``acc · (1 / l)``; more merge in split order by lse. Shapes as
    :func:`flash_span_chunk`, ``slots`` too."""
    b, h, c, d = q.shape
    if slots is not None:
        gk, gv = gk[slots], gv[slots]
    s_len = int(gk.shape[1])
    if splits * chunk < s_len or chunk % CHUNK_TILE:
        raise ValueError(f"{splits} splits of {chunk} do not cover a span of {s_len} "
                         f"in whole {CHUNK_TILE}-key tiles")
    if scale is None:
        scale = d ** -0.5
    qs = q.float() * (scale * LOG2E)
    n = torch.clamp(pos_mat.long() + 1, min=0, max=s_len)  # visible keys a row, [B, C]
    step = CHUNK_TILE // 2

    def empty():
        return (torch.full((b, h, c), NEG_INF, dtype=torch.float32, device=q.device),
                torch.zeros(b, h, c, dtype=torch.float32, device=q.device),
                torch.zeros(b, h, c, d, dtype=torch.float32, device=q.device))

    parts = []
    for i in range(splits):
        halves = [empty(), empty()]
        for j0 in range(i * chunk, min(s_len, (i + 1) * chunk), step):
            j1 = min(s_len, j0 + step)
            kt, vt = gk[:, j0:j1].float(), gv[:, j0:j1].float()  # [B, k, H, D]
            s = torch.einsum("bhcd,bkhd->bhck", qs, kt)
            vis = torch.arange(j0, j1, device=q.device)[None, None, None, :] \
                < n[:, None, :, None]
            half = (j0 // step) % 2
            halves[half] = _fold(halves[half], torch.where(vis, s, NEG_INF), vt)
        (m0, l0, a0), (m1, l1, a1) = halves
        mt = torch.maximum(m0, m1)
        e0, e1 = torch.exp2(m0 - mt), torch.exp2(m1 - mt)
        l = l0 * e0 + l1 * e1
        parts.append((torch.where(l > 0, mt, NEG_INF), l,
                      a0 * e0[..., None] + a1 * e1[..., None]))
    if splits == 1:
        return _normalise(parts[0][1], parts[0][2])
    mx = torch.full((b, h, c), NEG_INF, dtype=torch.float32, device=q.device)
    for m, ls, _ in parts:
        mx = torch.where(ls > 0, torch.maximum(mx, m), mx)
    l = torch.zeros(b, h, c, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b, h, c, d, dtype=torch.float32, device=q.device)
    for m, ls, a in parts:
        e = torch.where(ls > 0, torch.exp2(m - mx), 0.0)
        l = l + ls * e
        acc = acc + a * e[..., None]
    return _normalise(l, acc)


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
    :func:`span_chunk_reference` with one query row."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _forward(q, gk, gv, positions, float(scale), block_k)


def _forward(q, gk, gv, positions, scale: float, block_k: int):
    """CPU tensors take the plain version; CUDA tensors are checked and
    launch the kernel."""
    if q.device.type == "cpu":
        out = span_chunk_reference(q[:, :, None], gk, gv, positions[:, None], scale, block_k)
        return out[:, :, 0]
    if q.device.type != "cuda":
        raise ValueError(f"span_decode runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, gk, gv, positions)
    return _launch(q, gk, gv, positions, scale)


def _chunk_kernel():
    global _CHUNK_LIB
    lib = _native.library("span_chunk")
    fn = lib.elephas_span_chunk
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ll] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.elephas_cuda_error_string.argtypes = [ctypes.c_int]
        lib.elephas_cuda_error_string.restype = ctypes.c_char_p
    _CHUNK_LIB = lib
    return lib


def _check_chunk_operands(q, gk, gv, pos_mat, slots):
    """Raise on what the span-chunk kernel does not take: float32 only, q
    ``[B, H, C, D]`` contiguous with D in HEAD_DIMS, K/V ``[slots, S, H,
    D]`` views with unit stride on D and 16-byte aligned pointers and
    strides (at least B slots unless ``slots`` maps q's rows to them),
    ``pos_mat`` contiguous ``[B, C]`` int32, ``slots`` contiguous ``[B]``
    int64, all on one device."""
    if q.ndim != 4:
        raise ValueError(f"span_chunk takes q [B, H, C, D], got {tuple(q.shape)}")
    b, h, c, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"span_chunk takes head_dim in {HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", gk), ("v", gv)):
        if t.dtype != torch.float32:
            raise ValueError(f"span_chunk takes float32, {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not q.is_contiguous() or q.data_ptr() % ALIGN_BYTES:
        raise ValueError("span_chunk takes a contiguous, 16-byte-aligned q")
    for name, t in (("k", gk), ("v", gv)):
        if t.ndim != 4 or t.shape[2:] != (h, d) or t.shape[1] < 1 or t.shape[0] < 1:
            raise ValueError(f"{name} must be [slots, S >= 1, {h}, {d}], got {tuple(t.shape)}")
        if slots is None and t.shape[0] < b:
            raise ValueError(f"{name} holds {t.shape[0]} slots for {b} rows and no slot map")
        st = t.stride()
        if st[-1] != 1 or min(st) < 0:
            raise ValueError(f"{name} needs unit stride on head_dim, got strides {tuple(st)}")
        if (t.data_ptr() | (st[0] | st[1] | st[2]) * 4) % ALIGN_BYTES:
            raise ValueError(
                f"{name} needs a {ALIGN_BYTES}-byte-aligned base pointer and strides "
                f"for the kernel's float4 loads, got pointer {t.data_ptr()} and "
                f"strides {tuple(st)}"
            )
    if gk.shape[:2] != gv.shape[:2]:
        raise ValueError(f"k is {tuple(gk.shape[:2])} slots x positions, v {tuple(gv.shape[:2])}")
    if pos_mat.dtype != torch.int32 or pos_mat.shape != (b, c) \
            or pos_mat.device != q.device or not pos_mat.is_contiguous():
        raise ValueError(
            f"pos_mat must be contiguous int32 [{b}, {c}] on {q.device}, got "
            f"{pos_mat.dtype} {tuple(pos_mat.shape)} on {pos_mat.device}"
        )
    if slots is not None and (slots.dtype != torch.int64 or slots.shape != (b,)
                              or slots.device != q.device or not slots.is_contiguous()):
        raise ValueError(
            f"slots must be contiguous int64 [{b}] on {q.device}, got "
            f"{slots.dtype} {tuple(slots.shape)} on {slots.device}"
        )
    if b > 65535 or h > 65535:
        raise ValueError(f"span_chunk takes at most 65535 rows and heads, got {b} and {h}")


def _launch_chunk(q, gk, gv, pos_mat, slots, scale: float):
    """One call of the span-chunk kernel on checked CUDA operands (with more
    than one split, the split kernel and then the merge kernel) on q's
    device and its current stream; returns ``[B, H, C, D]`` float32. The
    stream is taken as a raw handle, the device guard only off the current
    device, and the workspace only with more than one split."""
    global chunk_launches
    b, h, c, d = q.shape
    span = gk.shape[1]
    index = q.device.index
    splits, chunk = span_chunk_splits(span, b * h, c, d, _sm_count(index))
    out = torch.empty_like(q)
    # partials: acc [B·H, splits, C, D] and (m, l) [B·H, splits, C, 2]
    work = torch.empty(b * h * splits * c * (d + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    lib = _CHUNK_LIB or _chunk_kernel()
    args = (q.data_ptr(), gk.data_ptr(), gv.data_ptr(), pos_mat.data_ptr(),
            None if slots is None else slots.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), b, h, c, d, span, splits, chunk,
            gk.shape[0], *gk.stride()[:3], *gv.stride()[:3], scale,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        err = lib.elephas_span_chunk(*args)
    else:
        with torch.cuda.device(index):
            err = lib.elephas_span_chunk(*args)
    if err:
        raise RuntimeError(
            "span_chunk launch failed: " + lib.elephas_cuda_error_string(err).decode()
        )
    chunk_launches += 1
    return out


def flash_span_chunk(q, gk, gv, pos_mat, scale=None, block_k: int = DEFAULT_BLOCK,
                     slots=None):
    """Attention of chunk queries over a resident K/V span: ``q`` ``[B, H,
    C, Dh]`` at absolute positions ``pos_mat`` (``[B, C]``), ``gk``/``gv``
    ``[B, S, H, Dh]`` (``cache[:, :span]`` views of the arena). Key ``j`` is
    visible to a query at position ``p`` iff ``j <= p``. Returns ``[B, H, C,
    Dh]`` float32; a row that sees no key outputs zeros.

    ``slots`` (``[B]`` int64, optional) maps q's rows to arena slots: row
    ``b`` attends over ``gk[slots[b]]``, so ``gk``/``gv`` may be the whole
    arena's span view while ``q`` holds only this call's slots.

    A CUDA tensor launches the span-chunk kernel (``pos_mat`` int32 on the
    device; ``block_k`` is the CPU version's tile); a CPU tensor runs
    :func:`span_chunk_reference`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if slots is not None:
            gk, gv = gk[slots], gv[slots]
        return span_chunk_reference(q, gk, gv, pos_mat, scale, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"span_chunk runs on cuda or cpu, not {q.device}")
    _check_chunk_operands(q, gk, gv, pos_mat, slots)
    return _launch_chunk(q, gk, gv, pos_mat, slots, float(scale))


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


# -- the paged pool ------------------------------------------------------------

def paged_dense_span(pool_k, pool_v, tables, kv_dtype: str = "fp", kv_scales=None,
                     head_dim=None):
    """The keys and values of each table row as a dense float32 span: ``[B,
    T · block_size, H, D]`` each, gathered through ``tables`` (``[B, T]``
    block ids; the sentinel id reads the pool's sink block) and, for a
    quantized pool, dequantized with its scales (``kv_scales = (k_scale,
    v_scale)``, ``[N + 1, block_size, H]``; ``head_dim`` the unpacked
    width)."""
    from elephas_tpu_torch.serving.kv_quant import dequantize_rows

    b, t = tables.shape
    idx = tables.long()
    bs = pool_k.shape[1]

    def span(z):
        return z[idx].reshape(b, t * bs, *z.shape[2:])

    gk, gv = span(pool_k), span(pool_v)
    if kv_dtype == "fp":
        return gk.float(), gv.float()
    ks, vs = kv_scales
    d = head_dim if head_dim is not None else pool_k.shape[-1]
    return (dequantize_rows(gk, span(ks), kv_dtype, d),
            dequantize_rows(gv, span(vs), kv_dtype, d))


def paged_span_decode_reference(q, pool_k, pool_v, tables, positions, scale=None,
                                kv_dtype: str = "fp", kv_scales=None,
                                block_k: int = DEFAULT_BLOCK):
    """The plain version of :func:`flash_paged_span_decode`: the table span
    gathered and dequantized (:func:`paged_dense_span`), then
    :func:`span_chunk_reference` with one query row. Returns ``[B, H, D]``
    float32."""
    gk, gv = paged_dense_span(pool_k, pool_v, tables, kv_dtype, kv_scales, q.shape[-1])
    return span_chunk_reference(q[:, :, None], gk, gv, positions[:, None], scale,
                                block_k)[:, :, 0]


def paged_span_chunk_reference(q, pool_k, pool_v, tables, pos_mat, scale=None,
                               kv_dtype: str = "fp", kv_scales=None,
                               block_k: int = DEFAULT_BLOCK):
    """The plain version of :func:`flash_paged_span_chunk`: the table span
    gathered and dequantized, then :func:`span_chunk_reference`. Returns
    ``[B, H, C, D]`` float32."""
    gk, gv = paged_dense_span(pool_k, pool_v, tables, kv_dtype, kv_scales, q.shape[-1])
    return span_chunk_reference(q, gk, gv, pos_mat, scale, block_k)


def _paged_kernel(name):
    lib = _native.library(name)
    fn = getattr(lib, f"elephas_paged_{name}")
    if fn.argtypes is None:
        ints = 9 if name == "span_decode" else 10
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * ints \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.elephas_cuda_error_string.argtypes = [ctypes.c_int]
        lib.elephas_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _paged_fn(name: str, index: int, cache: dict):
    """The paged kernel ``name``'s C function on device ``index``, cached in
    ``cache``: the first call a device lets the kernel's instantiations take
    their shared memory there (``elephas_paged_<name>_init``, a runtime
    setting made once, outside any graph capture that later calls make)."""
    lib = _paged_kernel(name)
    with torch.cuda.device(index):
        err = getattr(lib, f"elephas_paged_{name}_init")()
    if err:
        raise RuntimeError(f"paged {name} set-up failed: "
                           + lib.elephas_cuda_error_string(err).decode())
    fn = cache[index] = getattr(lib, f"elephas_paged_{name}")
    return fn


def paged_chunk_merge_launches() -> int:
    """Merge-kernel launches the paged span chunk has made in this process
    (only calls of more than CHUNK_CLUSTER_MAX splits make one); 0 before
    its library is loaded."""
    if "span_chunk" not in _native._libs:
        return 0
    fn = _native._libs["span_chunk"].elephas_paged_span_chunk_merge_launches
    fn.restype = ctypes.c_ulonglong
    return int(fn())


def _check_paged_operands(what, q, rows, pool_k, pool_v, tables, pos, kv_dtype, kv_scales):
    """Raise on what the paged kernels do not take: q float32 contiguous
    ``[B, H, D]`` (decode) or ``[B, H, C, D]`` (chunk) with D in HEAD_DIMS;
    the pool contiguous ``[N + 1, block_size, H, Ds]``, float32 for ``"fp"``
    and int8 codes otherwise (``Ds`` = D, or D / 2 for int4), 16-byte
    aligned; scales float32 contiguous ``[N + 1, block_size, H]`` when
    quantized; ``tables`` contiguous int32 ``[B, T]``; ``pos`` contiguous
    int32 ``[B]`` or ``[B, C]``; all on one device."""
    if kv_dtype not in KV_CODES:
        raise ValueError(f"{what} takes kv_dtype in {tuple(KV_CODES)}, got {kv_dtype!r}")
    if q.ndim != (3 if rows is None else 4):
        raise ValueError(f"{what} takes q {'[B, H, D]' if rows is None else '[B, H, C, D]'}, "
                         f"got {tuple(q.shape)}")
    b, h, d = q.shape[0], q.shape[1], q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim in {HEAD_DIMS}, got {d}")
    if q.dtype != torch.float32 or not q.is_contiguous() or q.data_ptr() % ALIGN_BYTES:
        raise ValueError(f"{what} takes a contiguous, 16-byte-aligned float32 q")
    want, per = _STORED[kv_dtype]
    stored = d // per
    leaves = [("k", pool_k), ("v", pool_v)]
    if kv_dtype != "fp":
        if kv_scales is None:
            raise ValueError(f"{what} with kv_dtype={kv_dtype!r} needs kv_scales")
        leaves += [("k_scale", kv_scales[0]), ("v_scale", kv_scales[1])]
    n1, bs = pool_k.shape[:2]
    for name, t in leaves:
        dtype, shape = (want, (n1, bs, h, stored)) if name in "kv" \
            else (torch.float32, (n1, bs, h))
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != q.device or t.data_ptr() % ALIGN_BYTES:
            raise ValueError(
                f"{what}: {name} must be a contiguous, 16-byte-aligned {dtype} {shape} "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n1 < 2:
        raise ValueError(f"{what}: the pool needs a block and the sink, got {n1} blocks")
    if tables.dtype != torch.int32 or tables.ndim != 2 or tables.shape[0] != b \
            or not tables.is_contiguous() or tables.device != q.device:
        raise ValueError(f"{what}: tables must be contiguous int32 [{b}, T] on {q.device}, "
                         f"got {tables.dtype} {tuple(tables.shape)} on {tables.device}")
    want_pos = (b,) if rows is None else (b, rows)
    if pos.dtype != torch.int32 or tuple(pos.shape) != want_pos or not pos.is_contiguous() \
            or pos.device != q.device:
        raise ValueError(f"{what}: positions must be contiguous int32 {want_pos} on "
                         f"{q.device}, got {pos.dtype} {tuple(pos.shape)} on {pos.device}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{what} takes at most 65535 rows and heads, got {b} and {h}")


def _paged_decode_ready(q, pool_k, pool_v, tables, pos, kv_dtype, kv_scales) -> bool:
    """The paged decode's usual operands, in one predicate: everything
    :func:`_check_paged_operands` asks of a decode call holds (it runs, with
    its messages, only when this is False)."""
    return q.dim() == 3 and _paged_ready(q, pool_k, pool_v, tables, pos, kv_dtype, kv_scales,
                                         q.shape[:1])


def _paged_chunk_ready(q, pool_k, pool_v, tables, pos, kv_dtype, kv_scales) -> bool:
    """The paged chunk's usual operands, in one predicate: everything
    :func:`_check_paged_operands` asks of a chunk call holds (it runs, with
    its messages, only when this is False)."""
    return q.dim() == 4 and _paged_ready(q, pool_k, pool_v, tables, pos, kv_dtype, kv_scales,
                                         (q.shape[0], q.shape[2]))


def _paged_ready(q, pool_k, pool_v, tables, pos, kv_dtype, kv_scales, pos_shape) -> bool:
    stored = _STORED.get(kv_dtype)
    if stored is None or q.dtype is not _F32 or not q.is_contiguous():
        return False
    b, h, d = q.shape[0], q.shape[1], q.shape[-1]
    shape, index = pool_k.shape, q.get_device()
    if not (d in HEAD_DIMS and len(shape) == 4 and shape[0] >= 2 and shape[2] == h
            and shape[3] * stored[1] == d and pool_k.dtype is stored[0]
            and pool_v.dtype is stored[0] and pool_v.shape == shape
            and pool_k.is_contiguous() and pool_v.is_contiguous()
            and pool_k.get_device() == index and pool_v.get_device() == index
            and tables.dtype is _I32 and tables.dim() == 2 and tables.shape[0] == b
            and tables.is_contiguous() and tables.get_device() == index
            and pos.dtype is _I32 and pos.shape == pos_shape and pos.is_contiguous()
            and pos.get_device() == index and b <= 65535 and h <= 65535
            and (q.data_ptr() | pool_k.data_ptr() | pool_v.data_ptr()) % ALIGN_BYTES == 0):
        return False
    if kv_dtype == "fp":
        return True
    if kv_scales is None or len(kv_scales) != 2:
        return False
    ks, vs = kv_scales
    return (ks.dtype is _F32 and vs.dtype is _F32 and ks.shape == shape[:3]
            and vs.shape == shape[:3] and ks.is_contiguous() and vs.is_contiguous()
            and ks.get_device() == index and vs.get_device() == index
            and (ks.data_ptr() | vs.data_ptr()) % ALIGN_BYTES == 0)


def _launch_paged_decode(q, pool_k, pool_v, tables, pos, scale: float, kv_dtype, kv_scales):
    """One call of the paged decode kernel on checked CUDA operands (with
    more than one split, the split kernel and then the merge kernel), on
    q's device and its current stream, with the arena kernel's split over
    the table span. ``out`` and the partials share one allocation; the SM
    count and the C function are cached; the stream is taken as a raw
    handle and the device guard only off the current device."""
    global paged_launches
    b, h, d = q.shape
    n1, bs = pool_k.shape[:2]
    t = tables.shape[1]
    index = q.get_device()
    splits, chunk = span_splits(t * bs, b * h, _SMS.get(index) or _sm_count_of(index))
    if splits > 1:
        # out [B, H, D], then the partials: acc [B·H, splits, D] and (m, l)
        # [B·H, splits, 2]
        buf = q.new_empty(b * h * (d + splits * (d + 2)))
        out, work = buf.as_strided((b, h, d), (h * d, d, 1)), buf.data_ptr() + b * h * d * 4
    else:
        out, work = torch.empty_like(q), None
    ks, vs = (None, None) if kv_dtype == "fp" else (kv_scales[0].data_ptr(),
                                                    kv_scales[1].data_ptr())
    args = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), ks, vs, tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), work, b, h, d, KV_CODES[kv_dtype], bs, t, n1 - 1,
            splits, chunk, scale, torch._C._cuda_getCurrentRawStream(index))
    fn = _PAGED_DECODE.get(index) or _paged_fn("span_decode", index, _PAGED_DECODE)
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise RuntimeError("paged span_decode launch failed: "
                           + _paged_kernel("span_decode").elephas_cuda_error_string(err).decode())
    paged_launches += 1
    return out


def _sm_count_of(index: int) -> int:
    sms = _SMS[index] = _sm_count(index)
    return sms


def _launch_paged_chunk(q, pool_k, pool_v, tables, pos, scale: float, kv_dtype, kv_scales):
    """One call of the paged chunk kernel on checked CUDA operands, on q's
    device and its current stream, with the arena kernel's split over the
    table span: up to CHUNK_CLUSTER_MAX splits merge in the kernel's
    clusters, more in a merge kernel from partials that share ``out``'s
    allocation. One allocation; the SM count and the C function are cached;
    the stream is taken as a raw handle and the device guard only off the
    current device."""
    global paged_chunk_launches
    b, h, c, d = q.shape
    n1, bs = pool_k.shape[:2]
    t = tables.shape[1]
    index = q.get_device()
    sms = _SMS.get(index) or _sm_count_of(index)
    splits, chunk = span_chunk_splits(t * bs, b * h, c, d, sms)
    if splits > CHUNK_CLUSTER_MAX:
        # out [B, H, C, D], then the partials: acc [B·H, splits, C, D] and
        # (m, l) [B·H, splits, C, 2]
        buf = q.new_empty(b * h * c * (d + splits * (d + 2)))
        out = buf.as_strided((b, h, c, d), (h * c * d, c * d, d, 1))
        work = buf.data_ptr() + b * h * c * d * 4
    else:
        out, work = torch.empty_like(q), None
    ks, vs = (None, None) if kv_dtype == "fp" else (kv_scales[0].data_ptr(),
                                                    kv_scales[1].data_ptr())
    args = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), ks, vs, tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), work, b, h, c, d, KV_CODES[kv_dtype], bs, t, n1 - 1,
            splits, chunk, scale, torch._C._cuda_getCurrentRawStream(index))
    fn = _PAGED_CHUNK.get(index) or _paged_fn("span_chunk", index, _PAGED_CHUNK)
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise RuntimeError("paged span_chunk launch failed: "
                           + _paged_kernel("span_chunk").elephas_cuda_error_string(err).decode())
    paged_chunk_launches += 1
    return out


def flash_paged_span_decode(q, pool_k, pool_v, tables, positions, scale=None,
                            kv_dtype: str = "fp", kv_scales=None,
                            block_k: int = DEFAULT_BLOCK):
    """One-row decode attention over each slot's table span of the paged
    pool: ``q`` ``[B, H, Dh]`` at ``positions`` ``[B]``, ``pool_k`` /
    ``pool_v`` ``[N + 1, block_size, H, Ds]`` (block ``N`` the sink, which
    the sentinel id ``N`` reads), ``tables`` ``[B, T]`` block ids. Keys at
    positions ``<= positions[b]`` of the span ``T · block_size`` are
    visible. ``kv_dtype`` ``"int8"`` / ``"int4"`` takes int8 code pools and
    ``kv_scales = (k_scale, v_scale)`` ``[N + 1, block_size, H]``. Returns
    ``[B, H, Dh]`` float32.

    A CUDA tensor launches the paged span-decode kernel (int32 tables and
    positions on the device): the usual operands are accepted by one
    predicate (:func:`_paged_decode_ready`), any other call takes the full
    checks, which raise what the kernel does not take. A CPU tensor runs
    :func:`paged_span_decode_reference`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda and _paged_decode_ready(q, pool_k, pool_v, tables, positions, kv_dtype,
                                         kv_scales):
        return _launch_paged_decode(q, pool_k, pool_v, tables, positions, float(scale),
                                    kv_dtype, kv_scales)
    if q.device.type == "cpu":
        return paged_span_decode_reference(q, pool_k, pool_v, tables, positions, scale,
                                           kv_dtype, kv_scales, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"paged span_decode runs on cuda or cpu, not {q.device}")
    _check_paged_operands("paged span_decode", q, None, pool_k, pool_v, tables, positions,
                          kv_dtype, kv_scales)
    return _launch_paged_decode(q, pool_k, pool_v, tables, positions, float(scale), kv_dtype,
                                kv_scales)


def flash_paged_span_chunk(q, pool_k, pool_v, tables, pos_mat, scale=None,
                           kv_dtype: str = "fp", kv_scales=None,
                           block_k: int = DEFAULT_BLOCK):
    """Attention of chunk queries over each row's table span of the paged
    pool: ``q`` ``[B, H, C, Dh]`` at ``pos_mat`` ``[B, C]``, the pool and
    ``tables`` as in :func:`flash_paged_span_decode` (row ``b`` of q reads
    table row ``b``). Returns ``[B, H, C, Dh]`` float32; a row that sees no
    key outputs zeros.

    A CUDA tensor launches the paged span-chunk kernel: the usual operands
    are accepted by one predicate (:func:`_paged_chunk_ready`), any other
    call takes the full checks, which raise what the kernel does not take.
    A CPU tensor runs :func:`paged_span_chunk_reference`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda and _paged_chunk_ready(q, pool_k, pool_v, tables, pos_mat, kv_dtype,
                                        kv_scales):
        return _launch_paged_chunk(q, pool_k, pool_v, tables, pos_mat, float(scale), kv_dtype,
                                   kv_scales)
    if q.device.type == "cpu":
        return paged_span_chunk_reference(q, pool_k, pool_v, tables, pos_mat, scale,
                                          kv_dtype, kv_scales, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"paged span_chunk runs on cuda or cpu, not {q.device}")
    _check_paged_operands("paged span_chunk", q, q.shape[2], pool_k, pool_v, tables, pos_mat,
                          kv_dtype, kv_scales)
    return _launch_paged_chunk(q, pool_k, pool_v, tables, pos_mat, float(scale), kv_dtype,
                               kv_scales)
