"""The port's serving attention (``elephas_tpu_torch.ops.flash_serving``)
against the JAX package's, on the CPU: the span ladder, one-row decode
over an arena span, chunk attention and causal prefill, for ragged
positions, a span below ``maxlen`` and head dims 16 and 64; the span
kernels' split-then-merge arithmetic (decode and chunk) at every split
count the host can pick, and the split choices themselves; the span
kernel's operand checks, which run on CPU tensors; the arguments the
span-chunk wrapper would launch with, recorded on CPU tensors; and the
paged decode's one-predicate fast path against its full checks.

Inputs are numpy arrays made from a seed. Outputs agree within 1e-5: the
same online softmax, in another association order.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from elephas_tpu.ops import flash_serving as jfs
from elephas_tpu_torch.ops import flash_serving as fs

TOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("maxlen", [1, 32, 64, 100, 512, 1000])
def test_span_ladder_matches_jax(maxlen):
    assert fs.span_buckets(maxlen) == jfs.span_buckets(maxlen)
    assert fs.span_buckets(maxlen, floor=16) == jfs.span_buckets(maxlen, floor=16)
    for n in (1, maxlen // 2 + 1, maxlen):
        assert fs.span_bucket_for(n, fs.span_buckets(maxlen)) == \
            jfs.span_bucket_for(n, jfs.span_buckets(maxlen))


def test_span_ladder_errors_match_jax():
    for fn_t, fn_j, args in ((fs.span_buckets, jfs.span_buckets, (0,)),
                             (fs.span_bucket_for, jfs.span_bucket_for, (65, (16, 64)))):
        with pytest.raises(ValueError) as j_err:
            fn_j(*args)
        with pytest.raises(ValueError) as t_err:
            fn_t(*args)
        assert str(t_err.value) == str(j_err.value)


# positions: ragged, 0, the span's last row, and (lane 3) past the span
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("span,block_k", [(48, 16), (64, 128), (40, 32)])
def test_span_decode_matches_jax(d, span, block_k):
    rng = np.random.default_rng(d + span)
    b, h, maxlen = 5, 3, 96
    q = _randn(rng, b, h, d)
    arena_k, arena_v = _randn(rng, b, maxlen, h, d), _randn(rng, b, maxlen, h, d)
    pos = np.array([7, 0, span - 1, span + 20, span // 2], np.int32)
    want = np.asarray(jfs.flash_span_decode(
        q, arena_k[:, :span], arena_v[:, :span], pos, block_k=block_k))
    tk, tv = torch.from_numpy(arena_k), torch.from_numpy(arena_v)
    got = fs.flash_span_decode(torch.from_numpy(q), tk[:, :span], tv[:, :span],
                               torch.from_numpy(pos), block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_span_decode_sees_exactly_the_visible_keys():
    """Keys past a slot's position change nothing; a negative position
    (no visible key) outputs zeros."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_randn(rng, 2, 2, 16))
    k = torch.from_numpy(_randn(rng, 2, 32, 2, 16))
    v = torch.from_numpy(_randn(rng, 2, 32, 2, 16))
    pos = torch.tensor([5, -1], dtype=torch.int32)
    out = fs.flash_span_decode(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:], v2[:, 6:] = 1e3, -1e3
    torch.testing.assert_close(fs.flash_span_decode(q, k2, v2, pos), out, rtol=0, atol=0)
    assert torch.equal(out[1], torch.zeros(2, 16))
    dense = torch.softmax(torch.einsum("hd,shd->hs", q[0], k[0, :6]) * 0.25, -1)
    torch.testing.assert_close(out[0], torch.einsum("hs,shd->hd", dense, v[0, :6]),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("d", [16, 64])
def test_span_chunk_matches_jax(d):
    rng = np.random.default_rng(11 + d)
    b, h, c, span = 3, 2, 4, 56
    q = _randn(rng, b, h, c, d)
    k, v = _randn(rng, b, span, h, d), _randn(rng, b, span, h, d)
    pos = np.array([[10, 11, 12, 13], [0, 1, 2, 3], [50, 51, 52, 53]], np.int32)
    want = np.asarray(jfs.flash_span_chunk(q, k, v, pos, block_k=16))
    got = fs.flash_span_chunk(*(torch.from_numpy(a) for a in (q, k, v, pos)), block_k=16)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s,block", [(48, 16), (32, 128), (40, 16)])
def test_causal_prefill_matches_jax(d, s, block):
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, 2, 3, s, d) for _ in range(3))
    want = np.asarray(jfs.flash_causal_prefill(q, k, v, block_q=block, block_k=block))
    got = fs.flash_causal_prefill(*(torch.from_numpy(a) for a in (q, k, v)),
                                  block_q=block, block_k=block)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_causal_prefill_of_strided_views():
    """The engine's prefill hands q/k/v over as strided views of the
    packed qkv projection."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(_randn(rng, 2, 24, 3, 2, 16))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    want = fs.flash_causal_prefill(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(fs.flash_causal_prefill(q, k, v), want, rtol=0, atol=0)


def _pickable_splits(span, sm_counts=(132, 114, 78)):
    """Every (splits, chunk) that span_splits can pick at ``span``, over
    every row count up to a card's worth and a few SM counts."""
    return sorted({fs.span_splits(span, rows, sms)
                   for sms in sm_counts for rows in range(1, 2 * sms + 2)})


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("span", [64, 128, 256, 512])
def test_split_then_merge_matches_jax(d, span):
    """The kernel's split-then-merge arithmetic, at every split count the
    host can pick, against the JAX flash_span_decode within 1e-5; lanes at
    position 0 (every split but the first empty), past the span, at its
    last row, and a negative position (all splits empty: zeros)."""
    rng = np.random.default_rng(span + d)
    b, h, maxlen = 6, 3, 600
    q = _randn(rng, b, h, d)
    arena_k, arena_v = _randn(rng, b, maxlen, h, d), _randn(rng, b, maxlen, h, d)
    pos = np.array([0, span + 20, span - 1, span // 3, 5, -1], np.int32)
    want = np.asarray(jfs.flash_span_decode(q, arena_k[:, :span], arena_v[:, :span], pos))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, arena_k, arena_v))
    picks = _pickable_splits(span)
    assert picks[0] == (1, span) and len(picks) > 3
    for splits, chunk in picks:
        assert splits * chunk >= span > (splits - 1) * chunk
        got = fs.span_decode_split_reference(tq, tk[:, :span], tv[:, :span],
                                             torch.from_numpy(pos), splits, chunk)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"{splits} splits of {chunk}")
        assert torch.equal(got[5], torch.zeros(h, d))


def test_span_splits_fill_the_card_and_stop_at_one():
    """About two blocks an SM at the engine's 16 slots x 4 heads, no split
    shorter than SPLIT_MIN_KEYS positions, and one split once the rows
    alone fill the card."""
    for span in (64, 128, 256, 512):
        splits, chunk = fs.span_splits(span, 64, 132)
        assert 64 * splits >= min(2 * 132, 64 * span // fs.SPLIT_MIN_KEYS)
        assert chunk >= fs.SPLIT_MIN_KEYS
        assert fs.span_splits(span, 264, 132) == (1, span)
        assert fs.span_splits(span, 64 * 8, 132) == (1, span)
    assert fs.span_splits(8, 1, 132) == (1, 8)
    assert fs.span_splits(4096, 1, 132)[0] == fs.SPLIT_MAX
    with pytest.raises(ValueError, match="positive"):
        fs.span_splits(0, 1, 132)


def test_split_count_never_depends_on_the_positions(monkeypatch):
    """The wrapper picks splits and sizes its workspace from host values
    only: the same operands with other positions launch with the same
    arguments but the positions pointer (the launch is recorded, not run)."""
    import contextlib
    import inspect
    import types

    assert list(inspect.signature(fs.span_splits).parameters) == ["span", "rows", "sm_count"]
    calls = []

    class Lib:
        def elephas_span_decode(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fs, "_kernel", lambda: Lib())
    monkeypatch.setattr(fs, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v, _ = _operands(b=16, h=4, d=64, span=128, maxlen=128)
    for pos in ([0] * 16, [127] * 16, list(range(-1, 15)), [500] * 16):
        fs._launch(q, k, v, torch.tensor(pos, dtype=torch.int32), 0.125)
    # (q, k, v, positions, out, workspace) pointers, then the sizes and strides
    sizes = {args[6:] for args in calls}
    assert len(sizes) == 1
    b, h, d, span, splits, chunk = next(iter(sizes))[:6]
    assert (b, h, d, span) == (16, 4, 64, 128)
    assert (splits, chunk) == fs.span_splits(128, 64, 132) and splits > 1
    assert all(args[5] for args in calls)  # a workspace for the partials


def test_span_decode_refuses_other_devices():
    q = torch.zeros(1, 1, 16, device="meta")
    kv = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.flash_span_decode(q, kv, kv, torch.zeros(1, dtype=torch.int32, device="meta"))


def _operands(b=2, h=2, d=16, span=8, maxlen=12):
    arena = torch.zeros(b, maxlen, h, d)
    return (torch.zeros(b, h, d), arena[:, :span], arena[:, :span],
            torch.zeros(b, dtype=torch.int32))


def test_kernel_operand_check_takes_the_arena_views():
    """The checks the wrapper makes before a launch, on CPU tensors:
    ``cache[:, :span]`` views of the arena pass for every head dim."""
    for d in fs.HEAD_DIMS:
        fs._check_cuda_operands(*_operands(d=d))


@pytest.mark.parametrize("change,match", [
    (lambda o: (o[0].to(torch.bfloat16), *o[1:]), "float32"),
    (lambda o: (o[0], o[1].to(torch.bfloat16), *o[2:]), "float32"),
    (lambda o: (torch.zeros(2, 2, 48), torch.zeros(2, 8, 2, 48), torch.zeros(2, 8, 2, 48),
                o[3]), "head_dim"),
    (lambda o: (o[0].transpose(0, 1), *o[1:]), "contiguous q"),
    (lambda o: (o[0], o[1][:1], *o[2:]), r"\[B, S, H, D\]"),
    (lambda o: (o[0], o[1], o[2][:, :4], o[3]), "spans"),
    (lambda o: (o[0], torch.zeros(2, 8, 2, 17)[..., 1:], *o[2:]), "16-byte"),
    (lambda o: (o[0], torch.zeros(2, 8, 2, 32)[..., ::2], *o[2:]), "unit stride"),
    (lambda o: (*o[:3], o[3].long()), "int32"),
    (lambda o: (*o[:3], o[3][:1]), "int32"),
])
def test_kernel_operand_check_refuses(change, match):
    with pytest.raises(ValueError, match=match):
        fs._check_cuda_operands(*change(_operands()))


# (slots x heads, chunk rows, SMs) for the span-chunk split rule: the
# engine's launch, 16 slots, verify rows, a 512-row suffix, ragged widths,
# small and large cards
CHUNK_SPLIT_SHAPES = [(rows, c, sms)
                      for rows, c in ((4, 64), (64, 64), (64, 1), (4, 512), (6, 100), (512, 64))
                      for sms in (8, 132)]


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("span", [1, 64, 70, 100, 512, 4096])
def test_span_chunk_splits_cover_cap_and_fill_the_card(span, d):
    """Every split is a whole number of CHUNK_TILE-key tiles and the splits
    cover the span, none wholly past it; more than one split only while a
    block's partials (splits · CHUNK_GROUP · (D + 2) floats) stay below the
    2 · span · D floats of K and V its row group reads, and only as far as
    the card needs blocks: the split grid within one wave of
    CHUNK_BLOCKS_PER_SM blocks an SM, one split when the row groups alone
    fill half of that."""
    for rows, c, sms in CHUNK_SPLIT_SHAPES:
        splits, chunk = fs.span_chunk_splits(span, rows, c, d, sms)
        assert chunk % fs.CHUNK_TILE == 0 and chunk >= fs.CHUNK_TILE
        assert splits * chunk >= span > (splits - 1) * chunk
        blocks = rows * -(-c // fs.CHUNK_GROUP)
        if splits > 1:
            assert splits * fs.CHUNK_GROUP * (d + 2) < 2 * span * d
            assert blocks * splits <= fs.CHUNK_BLOCKS_PER_SM * sms
        if 2 * blocks > fs.CHUNK_BLOCKS_PER_SM * sms:
            assert splits == 1


def test_span_chunk_splits_cap_binds_on_a_ragged_last_tile():
    """A span a few keys into its second tile at head_dim 16: two splits'
    partials (2 · 64 · 18 floats) would outweigh the 2 · 70 · 16 floats of
    K and V, so the span stays whole though the card has room; at head_dim
    128 they do not (2 · 64 · 130 against 2 · 70 · 128)."""
    assert fs.span_chunk_splits(70, 1, 64, 16, 132) == (1, 128)
    assert fs.span_chunk_splits(70, 1, 64, 128, 132) == (2, 64)


def test_span_chunk_splits_at_the_engine_shapes():
    """On an H100's 132 SMs: the engine's launch (one slot, 4 heads of 128,
    64 rows) splits each span into its 64-key tiles; 16 slots (64 blocks)
    take two splits; a 512-row chunk of one slot (32 blocks) four; a span
    of one tile is not split."""
    assert [fs.span_chunk_splits(s, 4, 64, 128, 132) for s in (64, 128, 256, 512)] == \
        [(1, 64), (2, 64), (4, 64), (8, 64)]
    assert fs.span_chunk_splits(512, 64, 64, 128, 132) == (2, 256)
    assert fs.span_chunk_splits(512, 4, 512, 128, 132) == (4, 128)
    with pytest.raises(ValueError, match="positive"):
        fs.span_chunk_splits(64, 4, 0, 128, 132)


def _chunk_operands(b=3, h=2, d=32, c=64, span=128, slots=None, seed=0):
    """numpy chunk queries, an arena of ``slots`` (default ``b``) slots cut
    to ``span`` and int32 positions: row 0 from 0, row 1 running past the
    span, row 2 at a ragged offset with its first row at -1 (no key)."""
    rng = np.random.default_rng(seed)
    n = b if slots is None else slots
    q = _randn(rng, b, h, c, d)
    k, v = _randn(rng, n, span + 8, h, d)[:, :span], _randn(rng, n, span + 8, h, d)[:, :span]
    offs = rng.integers(0, max(1, span - c), b)
    offs[:2] = [0, span - c // 2][:b]
    pos = (offs[:, None] + np.arange(c)[None, :]).astype(np.int32)
    pos[2:, 0] = -1
    return q, np.ascontiguousarray(k), np.ascontiguousarray(v), pos


def _chunk_picks(span, rows, c, d):
    """Every (splits, chunk) the rule picks for this shape over a few SM
    counts, beside one split and the most (one a tile)."""
    tiles = -(-span // fs.CHUNK_TILE)
    return sorted({fs.span_chunk_splits(span, rows, c, d, sms) for sms in (1, 8, 78, 132, 4096)}
                  | {(1, tiles * fs.CHUNK_TILE), (tiles, fs.CHUNK_TILE)})


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [1, 7, 64, 100, 512])
def test_span_chunk_split_reference_matches_jax(c, mapped):
    """The kernel's split-then-merge arithmetic, in its order (two tile
    halves a split, exp2), at every split the rule can pick and at one and
    the most splits, against the JAX flash_span_chunk and the port's plain
    version within 1e-5 of max(1, |out|); through a slot map into a larger
    arena too; a row with no visible key outputs zeros."""
    b, h, d = 3, 2, 32
    span = 512 if c == 512 else 160
    slot_ids = np.array([4, 0, 2]) if mapped else None
    q, k, v, pos = _chunk_operands(b, h, d, c, span, 5 if mapped else None, seed=c)
    kj, vj = (k, v) if slot_ids is None else (k[slot_ids], v[slot_ids])
    want = np.asarray(jfs.flash_span_chunk(q, kj, vj, pos, block_k=span))
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pos))
    slots = None if slot_ids is None else torch.from_numpy(slot_ids)
    plain = fs.flash_span_chunk(tq, tk, tv, tp, slots=slots)
    np.testing.assert_allclose(plain.numpy(), want, atol=TOL, rtol=0)
    bound = np.maximum(1.0, np.abs(want))
    for splits, chunk in _chunk_picks(span, b * h, c, d):
        got = fs.span_chunk_split_reference(tq, tk, tv, tp, splits, chunk, slots=slots)
        assert (np.abs(got.numpy() - want) / bound).max() <= TOL, (splits, chunk)
        assert not got[2, :, 0].any()


def test_span_chunk_split_reference_refuses_partial_tiles():
    q, k, v, pos = (torch.from_numpy(a) for a in _chunk_operands())
    with pytest.raises(ValueError, match="whole 64-key tiles"):
        fs.span_chunk_split_reference(q, k, v, pos, 4, 32)
    with pytest.raises(ValueError, match="do not cover"):
        fs.span_chunk_split_reference(q, k, v, pos, 1, 64)


def _record_chunk_launches(monkeypatch):
    """Replace the span-chunk library, the SM count, the stream and the
    device query, so _launch_chunk runs on CPU tensors and records the
    arguments it would launch with."""
    calls = []

    class Lib:
        def elephas_span_chunk(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fs, "_CHUNK_LIB", Lib())
    monkeypatch.setattr(fs, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None, raising=False)
    return calls


def test_span_chunk_split_never_depends_on_the_positions(monkeypatch):
    """The wrapper picks the chunk's splits and sizes its workspace from
    host values only: the same operands with other positions launch with
    the same arguments but the positions pointer, on the raw stream handle
    (the launch is recorded, not run)."""
    import inspect

    assert list(inspect.signature(fs.span_chunk_splits).parameters) == \
        ["span", "rows", "c", "head_dim", "sm_count"]
    calls = _record_chunk_launches(monkeypatch)
    q, k, v, _ = (torch.from_numpy(a) for a in _chunk_operands(1, 4, 64, 64, 512, 16))
    slots = torch.tensor([9])
    before = fs.chunk_launches
    for pos in ([0] * 64, list(range(448, 512)), list(range(-1, 63)), [900] * 64):
        fs._launch_chunk(q, k, v, torch.tensor([pos], dtype=torch.int32), slots, 0.125)
    assert fs.chunk_launches == before + 4
    # (q, k, v, pos, slot map, out, workspace) pointers, then sizes, strides,
    # scale and stream
    assert len({args[7:] for args in calls}) == 1
    args = calls[0]
    assert args[7:15] == (1, 4, 64, 64, 512, *fs.span_chunk_splits(512, 4, 64, 64, 132), 16)
    assert args[12] > 1 and all(a[6] for a in calls)  # split: a workspace for the partials
    assert args[4] == slots.data_ptr() and args[-1] == 7


def test_span_chunk_one_split_takes_no_workspace(monkeypatch):
    """A span of one tile, and 512-row chunks of 16 slots (which fill the
    card without a split), run as one split: the launch gets no workspace
    (and the kernel then launches no merge)."""
    calls = _record_chunk_launches(monkeypatch)
    for b, d, c, span in ((1, 128, 64, 64), (16, 16, 512, 512)):
        q, k, v, pos = (torch.from_numpy(a) for a in _chunk_operands(b, 4, d, c, span))
        fs._launch_chunk(q, k, v, pos, None, 0.1)
        assert calls[-1][12] == 1 and calls[-1][6] is None


def _paged_decode_operands(kv_dtype, b=2, h=2, d=16, bs=4, t=12, c=None):
    """CPU operands of a paged decode (or, with ``c`` rows, a paged chunk):
    a pool of ``b·t`` blocks and the sink (codes and scales when quantized),
    tables, positions."""
    from elephas_tpu_torch.serving.kv_quant import quantize_rows

    rng = np.random.default_rng(0)
    n1 = b * t + 1
    rows = torch.from_numpy(_randn(rng, 2, n1, bs, h, d))
    q = torch.from_numpy(_randn(rng, b, h, d) if c is None else _randn(rng, b, h, c, d))
    tables = torch.arange(b * t, dtype=torch.int32).view(b, t)
    pos = torch.tensor([0, t * bs - 1], dtype=torch.int32)
    if c is not None:
        pos = (pos[:, None] + torch.arange(c, dtype=torch.int32)).contiguous()
    if kv_dtype == "fp":
        return q, rows[0].contiguous(), rows[1].contiguous(), tables, pos, None
    (kq, ks), (vq, vs) = (quantize_rows(r, kv_dtype) for r in rows)
    return q, kq, vq, tables, pos, (ks, vs)


def _misaligned(t):
    """``t``'s values in a view 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype)
    i = next(i for i in range(16) if (flat.data_ptr() + i * t.element_size()) % 16 == 4)
    view = flat[i:i + t.numel()].view(t.shape)
    view.copy_(t)
    return view


# what the paged kernels do not take: (kv_dtype, change to (q, pk, pv,
# tables, pos, scales), the full check's message)
PAGED_REFUSALS = [
    ("fp", lambda o: o, None),
    ("int8", lambda o: o, None),
    ("int4", lambda o: o, None),
    ("fp8", lambda o: o, "kv_dtype"),
    ("fp", lambda o: (o[0].double(), *o[1:]), "float32 q"),
    ("fp", lambda o: (o[0].transpose(0, 1), *o[1:]), "contiguous"),
    ("fp", lambda o: (o[0][:, :, None], *o[1:]), r"\[B, H, D\]"),
    ("fp", lambda o: (o[0][..., :8].contiguous(), o[1][..., :8].contiguous(),
                      o[2][..., :8].contiguous(), *o[3:]), "head_dim"),
    ("fp", lambda o: (o[0], o[1].to(torch.int8), *o[2:]), "k must be"),
    ("fp", lambda o: (o[0], o[1], o[2][:, :2].contiguous(), *o[3:]), "v must be"),
    ("fp", lambda o: (o[0], o[1][:1], o[2][:1], *o[3:]), "the sink"),
    ("fp", lambda o: (o[0], _misaligned(o[1]), *o[2:]), "16-byte"),
    ("fp", lambda o: (*o[:3], o[3].long(), *o[4:]), "tables"),
    ("fp", lambda o: (*o[:3], o[3][:1].contiguous(), *o[4:]), "tables"),
    ("fp", lambda o: (*o[:4], o[4].long(), o[5]), "positions"),
    ("fp", lambda o: (*o[:4], o[4][:, None], o[5]), "positions"),
    ("int8", lambda o: (*o[:5], None), "kv_scales"),
    ("int8", lambda o: (*o[:5], (o[5][0].double(), o[5][1])), "k_scale"),
    ("int4", lambda o: (*o[:5], (o[5][0], o[5][1][:, :1].contiguous())), "v_scale"),
    ("int4", lambda o: (o[0], o[1], o[2].view(torch.uint8), *o[3:]), "v must be"),
]


def _paged_chunk_fast_path(monkeypatch, q, pk, pv, tables, pos, kv_dtype, scales):
    """The paged chunk's launch, recorded: more than CHUNK_CLUSTER_MAX
    splits (a 576-key span) put the partials behind ``out`` in one
    allocation; 4 splits merge in the cluster and 1 writes ``out``, neither
    with a workspace."""
    calls = []
    monkeypatch.setitem(fs._PAGED_CHUNK, -1, lambda *args: calls.append(args) or 0)
    before = fs.paged_chunk_launches
    b, h, c, d = q.shape
    for t, want in ((144, 9), (64, 4), (3, 1)):
        tab = tables[:, :t].contiguous()
        out = fs._launch_paged_chunk(q, pk, pv, tab, pos, 0.25, kv_dtype, scales)
        assert out.shape == q.shape and out.is_contiguous()
        args = calls[-1]
        splits, chunk = fs.span_chunk_splits(4 * t, b * h, c, d, 132)
        assert splits == want
        assert args[9:20] == (b, h, c, d, fs.KV_CODES[kv_dtype], 4, t, 288, splits, chunk, 0.25)
        assert args[7] == out.data_ptr() and (args[3] is None) == (kv_dtype == "fp")
        assert args[-1] == 7
        if splits > fs.CHUNK_CLUSTER_MAX:
            assert args[8] == out.data_ptr() + b * h * c * d * 4
            assert out.untyped_storage().nbytes() == 4 * b * h * c * (d + splits * (d + 2))
        else:
            assert args[8] is None
    assert fs.paged_chunk_launches == before + 3


def _paged_fast_path_cases():
    """PAGED_REFUSALS for the decode, under pytest's own ids, then for the
    chunk (its q is [B, H, C, D]), the same ids ending in "-chunk"."""
    names = [f"{kv}-<lambda>-{match}" for kv, _, match in PAGED_REFUSALS]
    count, seen, ids = Counter(names), Counter(), []
    for n in names:
        ids.append(f"{n}{seen[n]}" if count[n] > 1 else n)
        seen[n] += 1
    chunk = [(kv, change, match.replace("H, D", "H, C, D") if match else match)
             for kv, change, match in PAGED_REFUSALS]
    return ([pytest.param(*case, "decode", id=i) for case, i in zip(PAGED_REFUSALS, ids)]
            + [pytest.param(*case, "chunk", id=f"{i}-chunk") for case, i in zip(chunk, ids)])


@pytest.mark.parametrize("kv_dtype,change,match,kernel", _paged_fast_path_cases())
def test_paged_decode_fast_path_takes_only_what_the_checks_pass(monkeypatch, kv_dtype, change,
                                                                match, kernel):
    """Each paged kernel's one predicate accepts the usual operands and
    nothing the full checks refuse (those raise their own messages); the
    launch it leads to makes one allocation (the decode's ``out`` and
    partials; the chunk's ``out``, with the partials behind it only past
    CHUNK_CLUSTER_MAX splits) and passes its arguments in the C entry's
    order (the launch is recorded on CPU tensors, not run)."""
    base = kv_dtype if kv_dtype in fs.KV_CODES else "fp"
    chunk = kernel == "chunk"
    operands = _paged_decode_operands(base, t=144, c=3) if chunk \
        else _paged_decode_operands(base)
    q, pk, pv, tables, pos, scales = change(operands)
    ready_fn = fs._paged_chunk_ready if chunk else fs._paged_decode_ready
    what, rows = ("paged span_chunk", 3) if chunk else ("paged span_decode", None)
    ready = ready_fn(q, pk, pv, tables, pos, kv_dtype, scales)
    if match is not None:
        assert not ready
        with pytest.raises(ValueError, match=match):
            fs._check_paged_operands(what, q, rows, pk, pv, tables, pos, kv_dtype, scales)
        return
    assert ready
    fs._check_paged_operands(what, q, rows, pk, pv, tables, pos, kv_dtype, scales)
    monkeypatch.setitem(fs._SMS, -1, 132)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: -1, raising=False)
    if chunk:
        _paged_chunk_fast_path(monkeypatch, q, pk, pv, tables, pos, kv_dtype, scales)
        return
    calls = []
    monkeypatch.setitem(fs._PAGED_DECODE, -1, lambda *args: calls.append(args) or 0)
    before = fs.paged_launches
    out = fs._launch_paged_decode(q, pk, pv, tables, pos, 0.25, kv_dtype, scales)
    assert fs.paged_launches == before + 1 and out.shape == q.shape and out.is_contiguous()
    args = calls[-1]
    b, h, d = q.shape
    splits, chunk = fs.span_splits(48, b * h, 132)
    assert args[9:19] == (b, h, d, fs.KV_CODES[kv_dtype], 4, 12, 24, splits, chunk, 0.25)
    assert splits > 1 and args[7] == out.data_ptr() and args[8] == out.data_ptr() + b * h * d * 4
    assert (args[3] is None) == (kv_dtype == "fp") and args[-1] == 7
    # a span of 3 blocks is one split: no partials
    out = fs._launch_paged_decode(q, pk, pv, tables[:, :3].contiguous(), pos, 0.25, kv_dtype,
                                  scales)
    assert calls[-1][16] == 1 and calls[-1][8] is None and calls[-1][7] == out.data_ptr()
