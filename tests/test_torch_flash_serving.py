"""The port's serving attention (``elephas_tpu_torch.ops.flash_serving``)
against the JAX package's, on the CPU: the span ladder, one-row decode
over an arena span, chunk attention and causal prefill, for ragged
positions, a span below ``maxlen`` and head dims 16 and 64; the span
kernel's split-then-merge arithmetic at every split count the host can
pick, and the split choice itself; and the span kernel's operand checks,
which run on CPU tensors.

Inputs are numpy arrays made from a seed. Outputs agree within 1e-5: the
same online softmax, in another association order.
"""

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
