"""The port's CUDA kernels (flash forward, LayerNorm forward and
backward, span decode, span chunk, and the paged span decode and span
chunk) against their plain versions, one SparkModel fit and the serving
engine (fixed and paged), on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu_torch.models.layers import Dropout
from elephas_tpu_torch.ops import flash_attention as fa
from elephas_tpu_torch.ops import flash_serving as fs
from elephas_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only on the GPU")
    # fp32 as the reference computes it: no TF32 in GEMMs or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_q,s_k", [(100, 100), (64, 192), (200, 72)])
def test_ragged_and_cross_lengths(cuda, dtype, tol, causal, s_q, s_k):
    """Sequence lengths that are not multiples of the kernel's 16-row
    fragments or its kv tiles, and q/k of different lengths (causal on
    absolute positions)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, 2, 3, s_q, 64, dtype=dtype)
    k = _randn(gen, 2, 3, s_k, 64, dtype=dtype)
    v = _randn(gen, 2, 3, s_k, 64, dtype=dtype)
    out, lse = fa._flash_forward(q, k, v, 0.125, causal, s_q, s_k)
    ref, ref_lse = fa.flash_forward_reference(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse.reshape(6, s_q)).abs().max().item() <= 1e-4


TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _check_case(cuda, layout, b, h, s_q, s_k, d, dtype, causal, seed=0):
    """One kernel call against the plain version: out within the type's
    tolerance, lse within 1e-4; returns (out, lse)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scale = d ** -0.5
    if layout == "packed":
        assert s_q == s_k
        qkv = _randn(gen, b, s_q, 3, h, d, dtype=dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out, lse = fa._flash_forward_packed(qkv, scale, causal, s_q, s_k)
        out = out.transpose(1, 2)
    else:
        q = _randn(gen, b, h, s_q, d, dtype=dtype)
        k = _randn(gen, b, h, s_k, d, dtype=dtype)
        v = _randn(gen, b, h, s_k, d, dtype=dtype)
        out, lse = fa._flash_forward(q, k, v, scale, causal, s_q, s_k)
    ref, ref_lse = fa.flash_forward_reference(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse.reshape(b * h, s_q)).abs().max().item() <= 1e-4
    return out, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout,s_q,s_k", [("packed", 300, 300), ("bhsd", 300, 300),
                                            ("bhsd", 300, 136), ("bhsd", 77, 300)])
def test_every_width_layout_and_type(cuda, layout, s_q, s_k, d, causal, dtype):
    """Every head_dim, both types, causal or not, packed qkv and bhsd, at
    a length that crosses the 16-row fragments and the kv tiles, and with
    q and k of different lengths."""
    _check_case(cuda, layout, 2, 3, s_q, s_k, d, dtype, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_long_sequence_wraps_the_stage_ring(cuda, d, dtype):
    """S = 2048: 32 to 64 kv tiles through the two-stage copy ring."""
    _check_case(cuda, "packed", 1, 2, 2048, 2048, d, dtype, True, seed=3)
    _check_case(cuda, "bhsd", 1, 2, 2048, 2048, d, dtype, False, seed=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [((1, 512, 4, 128), True),
                                          ((128, 256, 8, 128), False)])
def test_serving_batch_one_and_training_shapes(cuda, shape, causal, dtype):
    """Config A's generate shape (batch 1, four-warp blocks: 32 of them)
    and the training shape (batch 128, eight-warp blocks)."""
    b, s, h, d = shape
    _check_case(cuda, "packed", b, h, s, s, d, dtype, causal, seed=5)


def test_repeats_bit_for_bit(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = _randn(gen, 8, 512, 3, 4, 128, dtype=dtype)
        first = fa._flash_forward_packed(qkv, 128 ** -0.5, True, 128, 128)
        again = fa._flash_forward_packed(qkv, 128 ** -0.5, True, 128, 128)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_refuses_a_misaligned_view(cuda):
    """cp.async needs 16-byte-aligned operands: a view one element off
    raises, for fp32 and bf16, and nothing falls back."""
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(2 * 64 * 64 + 1, dtype=dtype, device=cuda)
        q = flat[1:].view(1, 2, 64, 64)
        ok = torch.zeros(1, 2, 64, 64, dtype=dtype, device=cuda)
        before = fa.launches
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(q, ok, ok)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(ok, ok, q)
        assert fa.launches == before


def test_counts_launches_and_matches_qkv(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = _randn(gen, 2, 128, 3, 4, 32)
    before = fa.launches
    out = fa.flash_attention_qkv(qkv, causal=True)
    assert fa.launches == before + 1
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    ref = fa.attention_reference(q, k, v, causal=True).transpose(1, 2)
    assert (out - ref).abs().max().item() <= 1e-4


def test_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, 1, 2, 64, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = _randn(gen, 1, 2, 64, 64).half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = _randn(gen, 1, 2, 64, 128)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q, q, q)


def _ln_case(gen, n, d, dtype):
    x = (_randn(gen, n, d) * 3 + 1.5).to(dtype)
    g, b = _randn(gen, d), _randn(gen, d)
    dy = _randn(gen, n, d, dtype=dtype)
    return x, g, b, dy


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d", [(1, 1), (7, 1), (1000, 200), (33, 1024), (5, 3000),
                                 (3, 8192)])
def test_layer_norm_kernels_match_plain(cuda, dtype, tol, n, d):
    """Ragged row counts, d of 1 and 200, and each row layout of the
    dispatch (one warp a row, and 2 to 8 warps)."""
    gen = torch.Generator(device=cuda).manual_seed(n * 10007 + d)
    x, g, b, dy = _ln_case(gen, n, d, dtype)
    f0, b0 = ln.fwd_launches, ln.bwd_launches
    y, mean, rstd = ln.layer_norm_forward(x, g, b, 1e-6)
    dx, dg, db = ln.layer_norm_backward(x, g, dy, mean, rstd)
    assert (ln.fwd_launches - f0, ln.bwd_launches - b0) == (1, 2)
    ry, rmean, rrstd = ln.layer_norm_forward_reference(x, g, b, 1e-6)
    rdx, rdg, rdb = ln.layer_norm_backward_reference(x, g, dy, rmean, rrstd)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype
    # bf16: one rounding, relative to max(1, |y|)
    scale = ry.float().abs().clamp_min(1) if dtype == torch.bfloat16 else 1.0
    assert ((y.float() - ry.float()).abs() / scale).max().item() <= tol
    assert ((mean - rmean).abs() / rmean.abs().clamp_min(1)).max().item() <= 1e-5
    assert ((rstd - rrstd).abs() / rrstd).max().item() <= 1e-5
    if dtype == torch.float32:
        assert (dx - rdx).abs().max().item() <= 1e-4
        for got, want in ((dg, rdg), (db, rdb)):
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().clamp_min(1).item()


def test_layer_norm_backward_repeats_bit_for_bit(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, g, _, dy = _ln_case(gen, 4096, 1024, torch.float32)
    _, mean, rstd = ln.layer_norm_forward(x, g, g, 1e-6)
    first = ln.layer_norm_backward(x, g, dy, mean, rstd)
    again = ln.layer_norm_backward(x, g, dy, mean, rstd)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_layer_norm_refuses_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, g, b, _ = _ln_case(gen, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ln.layer_norm(x.half(), g, b)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.layer_norm(_randn(gen, 8, 128)[:, :64], g, b)
    with pytest.raises(ValueError, match="gamma"):
        ln.layer_norm(x, g.double(), b)
    with pytest.raises(ValueError, match="d <= 8192"):
        ln.layer_norm(_randn(gen, 2, 8193), _randn(gen, 8193), _randn(gen, 8193))
    with pytest.raises(ValueError, match="on cpu"):
        ln.layer_norm(x, g.cpu(), b)


def _ln_served_case(gen, n, d, dtype, offset):
    """x, γ, β for n rows of width d; ``offset`` > 0 starts x that many
    elements into an aligned buffer: contiguous, not 16-byte aligned."""
    x, g, b, _ = _ln_case(gen, n, d, dtype)
    if offset:
        buf = torch.empty(n * d + offset, dtype=dtype, device=x.device)
        x = buf.view(-1)[offset:offset + n * d].view(n, d).copy_(x)
    return x, g, b


# (rows, width, offset, route): the engine's decode rows and generate's rows
# aligned (16-byte accesses), an odd width, and both row counts off
# alignment (column by column)
LN_SERVED = [(16, 512, 0, "vector"), (512, 512, 0, "vector"), (37, 333, 0, "scalar"),
             (16, 512, 1, "scalar"), (512, 512, 1, "scalar")]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d,offset,route", LN_SERVED)
def test_layer_norm_serving_rows_match_plain_on_both_routes(cuda, dtype, tol, n, d, offset,
                                                             route):
    """The serving route (inference_mode: no autograd, no statistics) and
    the training route's forward against the plain version at the serving
    rows, on the 16-byte route and the scalar one; the two routes' y are
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(n * 31 + d + offset)
    x, g, b = _ln_served_case(gen, n, d, dtype, offset)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(offset)
    assert ln.forward_route(x, g, b) == route
    with torch.inference_mode():
        served = ln.layer_norm(x, g, b, 1e-6)
    y, _, _ = ln.layer_norm_forward(x, g, b, 1e-6)
    ry = ln.layer_norm_forward_reference(x, g, b, 1e-6)[0]
    torch.cuda.synchronize()
    assert served.dtype == dtype and served.shape == (n, d)
    scale = ry.float().abs().clamp_min(1) if dtype == torch.bfloat16 else 1.0
    assert ((served.float() - ry.float()).abs() / scale).max().item() <= tol
    assert torch.equal(served, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(16, 512), (512, 512)])
def test_layer_norm_serving_route_repeats_and_replays_bit_for_bit(cuda, dtype, n, d):
    """The serving route's y equals the training route's (autograd
    Function, statistics written) bit for bit, on a second call and from
    a CUDA-graph replay."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x, g, b = _ln_served_case(gen, n, d, dtype, 0)
    gp, bp = g.clone().requires_grad_(), b.clone().requires_grad_()
    trained = ln.layer_norm(x, gp, bp, 1e-6)
    assert trained.grad_fn is not None
    with torch.inference_mode():
        served = ln.layer_norm(x, gp, bp, 1e-6)
        again = ln.layer_norm(x, gp, bp, 1e-6)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ln.layer_norm(x, gp, bp, 1e-6)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ln.layer_norm(x, gp, bp, 1e-6)
        graph.replay()
    torch.cuda.synchronize()
    assert served.grad_fn is None
    for got in (again, captured):
        assert torch.equal(got, served)
    assert torch.equal(trained.detach(), served)


def test_layer_norm_counts_one_launch_per_call_on_both_routes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, g, b = _ln_served_case(gen, 16, 512, torch.float32, 0)
    gp = g.clone().requires_grad_()
    f0 = ln.fwd_launches
    with torch.inference_mode():
        ln.layer_norm(x, gp, b)
    with torch.no_grad():
        ln.layer_norm(x, gp, b)
    assert ln.fwd_launches - f0 == 2
    y = ln.layer_norm(x, gp, b)
    assert ln.fwd_launches - f0 == 3
    b0 = ln.bwd_launches
    y.sum().backward()
    assert (ln.fwd_launches - f0, ln.bwd_launches - b0) == (3, 2)


def test_layer_norm_serving_route_allocates_y_only(cuda):
    """Under inference_mode the entry makes one allocation (y) and returns
    y alone; the training route's forward makes three (y, mean, rstd)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, g, b = _ln_served_case(gen, 16, 512, torch.float32, 0)
    gp = g.clone().requires_grad_()

    def allocations(fn):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
        out = fn()
        return torch.cuda.memory_stats(cuda)["allocation.all.allocated"] - before, out

    with torch.inference_mode():
        count, y = allocations(lambda: ln.layer_norm(x, gp, b))
    assert count == 1 and isinstance(y, torch.Tensor) and y.shape == x.shape
    count, out = allocations(lambda: ln.layer_norm_forward(x, g, b, 1e-6))
    assert count == 3 and out[1].shape == out[2].shape == (16,)


def test_spark_model_fit_on_cuda_matches_cpu(cuda):
    """A tiny classifier trained through the kernels on the card gives the
    history the plain versions give on the CPU (fp32, TF32 off)."""
    cfg = dict(vocab_size=61, maxlen=32, num_classes=2, d_model=64, num_heads=2,
               num_layers=2, dropout=0.0, seed=5)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 61, (40, 32)).astype(np.int32)
    y = rng.integers(0, 2, 40).astype(np.int32)
    hists = {}
    for dev in ("cpu", "cuda:0"):
        model = et.transformer_classifier(**cfg, device=dev)
        et.load_keras_weights(model, et.keras_weights(
            et.transformer_classifier(**cfg, device="cpu")))
        hists[dev] = et.SparkModel(model, device=dev).fit((x, y), epochs=2, batch_size=16)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(hists["cuda:0"][key], hists["cpu"][key], rtol=1e-4)


def _span_case(gen, d, span, b=16, h=4, maxlen=512):
    """q and an arena cut to ``span``, with ragged positions: 0 (every
    split but the first empty), the span's last row, a stale cursor past
    the span and the arena's last row."""
    q = _randn(gen, b, h, d)
    arena_k, arena_v = _randn(gen, b, maxlen, h, d), _randn(gen, b, maxlen, h, d)
    pos = torch.randint(0, span, (b,), generator=gen, device=gen.device, dtype=torch.int32)
    pos[:4] = torch.tensor([0, span - 1, span + 5, maxlen - 1], dtype=torch.int32)
    return q, arena_k[:, :span], arena_v[:, :span], pos


# (slots, heads, head_dim): the engine's 16 slots and 4 heads at every head
# dim, the span split over several blocks; and 64 slots of 8 heads, which
# fill the card with one split
SPAN_SHAPES = [(16, 4, 16), (16, 4, 32), (16, 4, 64), (16, 4, 128), (64, 8, 64)]
SPANS = [64, 128, 256, 512]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("b,h,d", SPAN_SHAPES)
def test_span_decode_matches_plain(cuda, b, h, d, span):
    """Every shape over the span ladder, against the plain version on the
    same operands, within 1e-5 of max(1, |out|); one launch counted a
    call, whatever the split."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + span + b)
    q, k, v, pos = _span_case(gen, d, span, b, h)
    before = fs.launches
    out = fs.flash_span_decode(q, k, v, pos)
    assert fs.launches == before + 1
    ref = fs.span_chunk_reference(q[:, :, None], k, v, pos[:, None])[:, :, 0]
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() / ref.abs().clamp_min(1)).max().item() <= 1e-5


def test_span_split_count_on_this_card(cuda):
    """The engine's shape splits the span over several blocks (about two
    an SM or more); 64 slots of 8 heads take one split."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for span in SPANS:
        splits, _ = fs.span_splits(span, 16 * 4, sms)
        assert splits > 1 and 16 * 4 * splits >= min(2 * sms, 16 * 4 * span // 16)
        assert fs.span_splits(span, 64 * 8, sms)[0] == 1


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("b,h,d", SPAN_SHAPES)
def test_span_decode_repeats_bit_for_bit(cuda, b, h, d, span):
    gen = torch.Generator(device=cuda).manual_seed(8 + span + d)
    q, k, v, pos = _span_case(gen, d, span, b, h)
    assert torch.equal(fs.flash_span_decode(q, k, v, pos), fs.flash_span_decode(q, k, v, pos))


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("b,h,d", [(16, 4, 128), (64, 8, 64)])
def test_span_decode_replays_in_a_cuda_graph(cuda, b, h, d, span):
    """A decode call captured in a CUDA graph and replayed gives the eager
    result bit for bit, twice: the workspace and the merge hold nothing
    over from one call to the next."""
    gen = torch.Generator(device=cuda).manual_seed(10 + span)
    q, k, v, pos = _span_case(gen, d, span, b, h)
    want = fs.flash_span_decode(q, k, v, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fs.flash_span_decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fs.flash_span_decode(q, k, v, pos)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_span_decode_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, pos = _span_case(gen, 64, 64, b=4, h=2, maxlen=80)
    before = fs.launches
    with pytest.raises(ValueError, match="float32"):
        fs.flash_span_decode(q.bfloat16(), k, v, pos)
    with pytest.raises(ValueError, match="float32"):
        fs.flash_span_decode(q, k.bfloat16(), v, pos)
    odd = torch.zeros(4, 80, 2, 65, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        fs.flash_span_decode(q, odd, v, pos)
    with pytest.raises(ValueError, match=r"\[B, S, H, D\]"):
        fs.flash_span_decode(q, k[:, :, :1], v, pos)
    with pytest.raises(ValueError, match="int32"):
        fs.flash_span_decode(q, k, v, pos.long())
    with pytest.raises(ValueError, match="head_dim"):
        fs.flash_span_decode(q[..., :48].contiguous(), k[..., :48], v[..., :48], pos)
    assert fs.launches == before


def _chunk_case(gen, d, span, c, b=16, h=4, maxlen=512, slots=None):
    """Chunk queries at ragged offsets over an arena cut to ``span``: one
    slot at offset 0 (rows past its first see later keys), one whose chunk
    ends on the span's last row, padded rows past the span and past the
    arena (clamped, as an engine's padded tail or an inactive lane), and a
    slot whose rows all sit before the first split's end."""
    q = _randn(gen, b, h, c, d)
    n = b if slots is None else slots
    arena_k, arena_v = _randn(gen, n, maxlen, h, d), _randn(gen, n, maxlen, h, d)
    offs = torch.randint(0, max(1, span - c), (b,), generator=gen, device=gen.device)
    special = torch.tensor([0, max(0, span - c), span + 3, maxlen - 1])[:b]
    offs[:len(special)] = special
    pos = (offs[:, None] + torch.arange(c, device=gen.device)[None, :]).to(torch.int32)
    return q, arena_k[:, :span], arena_v[:, :span], pos.contiguous()


CHUNK_SHAPES = [(16, 4, 128), (16, 4, 64), (16, 4, 16), (4, 2, 32), (64, 8, 64)]


# chunk widths: verify's 1, a width off the 16-row fragments, one row
# group, a ragged two groups, and a suffix bucket of config A's maxlen
CHUNK_WIDTHS = [1, 7, 64, 100, 512]


@pytest.mark.parametrize("c", CHUNK_WIDTHS)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("b,h,d", CHUNK_SHAPES)
def test_span_chunk_matches_plain(cuda, b, h, d, span, c):
    """Every shape over the span ladder at chunk widths 1 to 512, against
    the plain version on the same operands, within 1e-5 of max(1, |out|);
    one launch counted a call, whatever the split; bit for bit on a
    repeat."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + span + b + c)
    q, k, v, pos = _chunk_case(gen, d, span, c, b, h)
    before = fs.chunk_launches
    out = fs.flash_span_chunk(q, k, v, pos)
    assert fs.chunk_launches == before + 1
    ref = fs.span_chunk_reference(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() / ref.abs().clamp_min(1)).max().item() <= 1e-5
    assert torch.equal(fs.flash_span_chunk(q, k, v, pos), out)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("b", [1, 3])
def test_span_chunk_with_a_slot_map(cuda, b, span):
    """Rows of some arena slots (the engine's chunk of a few slots; one
    prefilling slot is the engine's launch at the default budget): row b
    reads slot slots[b] of the whole arena's span view, as the plain
    version reads the gathered slots."""
    gen = torch.Generator(device=cuda).manual_seed(span + b)
    q, k, v, pos = _chunk_case(gen, 128, span, 64, b=b, h=4, slots=16)
    slots = torch.tensor([5, 0, 15][:b], dtype=torch.long, device=cuda)
    out = fs.flash_span_chunk(q, k, v, pos, slots=slots)
    ref = fs.span_chunk_reference(q, k[slots], v[slots], pos)
    torch.cuda.synchronize()
    assert ((out - ref).abs() / ref.abs().clamp_min(1)).max().item() <= 1e-5


@pytest.mark.parametrize("span,c", [(128, 64), (512, 64), (512, 512), (256, 1)])
def test_span_chunk_replays_in_a_cuda_graph(cuda, span, c):
    """A chunk call captured in a CUDA graph (one slot through the slot
    map, as the engine launches it) and replayed gives the eager result bit
    for bit, twice: the workspace comes from the capturing stream and the
    merge holds nothing over from one call to the next."""
    gen = torch.Generator(device=cuda).manual_seed(20 + span + c)
    q, k, v, pos = _chunk_case(gen, 128, span, c, b=1, h=4, slots=16)
    slots = torch.tensor([7], dtype=torch.long, device=cuda)
    want = fs.flash_span_chunk(q, k, v, pos, slots=slots)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fs.flash_span_chunk(q, k, v, pos, slots=slots)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fs.flash_span_chunk(q, k, v, pos, slots=slots)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_span_chunk_rows_without_keys_are_zero(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, pos = _chunk_case(gen, 64, 128, 7, b=4, h=2)
    pos[1] = -1
    out = fs.flash_span_chunk(q, k, v, pos)
    torch.cuda.synchronize()
    assert not out[1].any() and out[0].abs().sum() > 0


def test_span_chunk_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, pos = _chunk_case(gen, 64, 64, 4, b=4, h=2, maxlen=80)
    before = fs.chunk_launches
    with pytest.raises(ValueError, match="float32"):
        fs.flash_span_chunk(q.bfloat16(), k, v, pos)
    with pytest.raises(ValueError, match="float32"):
        fs.flash_span_chunk(q, k.bfloat16(), v, pos)
    odd = torch.zeros(4, 80, 2, 65, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        fs.flash_span_chunk(q, odd, v, pos)
    with pytest.raises(ValueError, match="int32"):
        fs.flash_span_chunk(q, k, v, pos.long())
    with pytest.raises(ValueError, match="head_dim"):
        fs.flash_span_chunk(q[..., :48].contiguous(), k[..., :48], v[..., :48], pos)
    with pytest.raises(ValueError, match="int64"):
        fs.flash_span_chunk(q, k, v, pos, slots=torch.arange(4, device=cuda, dtype=torch.int32))
    with pytest.raises(ValueError, match="no slot map"):
        fs.flash_span_chunk(q, k[:2], v[:2], pos)
    assert fs.chunk_launches == before


def test_chunked_engine_on_cuda_matches_cpu(cuda):
    """Chunked prefill and the prefix cache on the card (span chunk, span
    decode and LayerNorm kernels) emit the CPU engine's tokens from the
    same random weights, wherever the plain path's top-2 margin is at least
    1e-3."""
    cfg = dict(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2, seed=3)
    cpu = et.transformer_lm(**cfg, device="cpu")
    card = et.transformer_lm(**cfg, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    rng = np.random.default_rng(0)
    shared = list(rng.integers(1, 64, 12))
    prompts = [shared + list(rng.integers(1, 64, n)) for n in (3, 9, 17, 5, 12, 30)]
    outs = {}
    before = fs.chunk_launches
    for name, model in (("cpu", cpu), ("cuda", card)):
        engine = et.InferenceEngine(model, num_slots=4, steps_per_sync=4, prefix_cache=True,
                                    prefill_chunk=8)
        first = engine.submit(prompts[0], 12)
        engine.run()
        reqs = [first] + [engine.submit(p, 12) for p in prompts[1:]]
        engine.run()
        outs[name] = [r.tokens for r in reqs]
        assert engine.stats()["prefix_cache"]["hits"] > 0
    assert fs.chunk_launches > before
    for prompt, got, want in zip(prompts, outs["cuda"], outs["cpu"]):
        if got == want:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = torch.tensor([list(prompt) + want[:i]])
        with torch.inference_mode():
            top2 = cpu(seq, plain=True)[0, -1].topk(2).values
        assert (top2[0] - top2[1]).item() < 1e-3, (prompt, got, want)


def test_engine_on_cuda_matches_cpu(cuda):
    """The engine on the card (flash forward, span decode and LayerNorm
    kernels) emits the CPU engine's tokens from the same random weights,
    wherever the plain path's top-2 margin is at least 1e-3: a first
    difference must sit at a near tie."""
    cfg = dict(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2, seed=3)
    cpu = et.transformer_lm(**cfg, device="cpu")
    card = et.transformer_lm(**cfg, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n) for n in (3, 9, 17, 5, 12, 30)]
    outs = {}
    counts = (fs.launches, fa.launches, ln.fwd_launches)
    for name, model in (("cpu", cpu), ("cuda", card)):
        engine = et.InferenceEngine(model, num_slots=4, steps_per_sync=4)
        reqs = [engine.submit(p, 12) for p in prompts]
        engine.run()
        outs[name] = [r.tokens for r in reqs]
    assert all(after > before for after, before in
               zip((fs.launches, fa.launches, ln.fwd_launches), counts))
    for prompt, got, want in zip(prompts, outs["cuda"], outs["cpu"]):
        if got == want:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = torch.tensor([list(prompt) + want[:i]])
        with torch.inference_mode():
            top2 = cpu(seq, plain=True)[0, -1].topk(2).values
        assert (top2[0] - top2[1]).item() < 1e-3, (prompt, got, want)


# -- mixed_bfloat16 training and the zoo on the card -------------------------

MIXED_CLF = dict(vocab_size=61, maxlen=64, num_classes=2, d_model=256, num_heads=2,
                 num_layers=2, dropout=0.0, seed=6)


def _bf16_counts():
    return (fa.launches, fa.bf16_launches, ln.fwd_launches, ln.fwd_bf16_launches,
            ln.bwd_launches, ln.bwd_bf16_launches)


def test_mixed_training_step_takes_the_bf16_routes(cuda):
    """One SparkModel step of a mixed classifier: the flash forward once a
    layer and each LayerNorm 2·layers+1 times (the backward as two
    launches), every launch on the bf16 route but the first norm's, which
    normalises the float32 sum of the embeddings and the position table
    (as the reference's stock LayerNormalization does); the variables stay
    float32."""
    model = et.transformer_classifier(**MIXED_CLF, dtype_policy="mixed_bfloat16", device=cuda)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 61, (8, 64)).astype(np.int32)
    y = rng.integers(0, 2, 8).astype(np.int32)
    before = _bf16_counts()
    hist = et.SparkModel(model, device=cuda).fit((x, y), epochs=1, batch_size=8)
    got = [a - b for a, b in zip(_bf16_counts(), before)]
    norms = 2 * MIXED_CLF["num_layers"] + 1
    assert got == [2, 2, norms, norms - 1, 2 * norms, 2 * (norms - 1)]
    assert np.isfinite(hist["loss"]).all()
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())


@pytest.mark.parametrize("rope", [False, True])
def test_mixed_step_gradients_kernel_against_plain(cuda, rope):
    """One batch's gradients of a mixed LM through the kernels against
    the plain path's, from the same weights: within 2e-2 of each tensor's
    largest plain gradient (a gradient the kernels lost reads 1)."""
    model = et.transformer_lm(vocab_size=64, maxlen=64, d_model=256, num_heads=2,
                              num_layers=2, rope=rope, dtype_policy="mixed_bfloat16",
                              device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randint(0, 64, (4, 64), generator=gen, device=cuda)
    y = torch.roll(x, -1, dims=1)
    grads = {}
    model.train()
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        model.training_spec.loss(y, model(x, plain=plain)).mean().backward()
        grads[plain] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for name, want in grads[True].items():
        got = grads[False][name]
        assert got.dtype == torch.float32
        assert want.abs().max() > 0, name
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= 2e-2, (name, err)


ZOO = {
    "mnist_mlp": (lambda dev, **kw: et.mnist_mlp(device=dev, **kw),
                  lambda rng: rng.normal(size=(8, 784)).astype(np.float32)),
    "cifar10_cnn": (lambda dev, **kw: et.cifar10_cnn(device=dev, **kw),
                    lambda rng: rng.normal(size=(8, 32, 32, 3)).astype(np.float32)),
    "imdb_lstm": (lambda dev, **kw: et.imdb_lstm(device=dev, **kw),
                  lambda rng: rng.integers(0, 20000, (8, 80)).astype(np.int64)),
    "resnet": (lambda dev, **kw: et.resnet(input_shape=(64, 64, 3), num_classes=10,
                                           depths=(1, 1, 1), width=16, device=dev, **kw),
               lambda rng: rng.normal(size=(8, 64, 64, 3)).astype(np.float32)),
}


@pytest.mark.parametrize("name,policy", [(name, None) for name in ZOO]
                         + [("resnet", "mixed_bfloat16")])
def test_zoo_forward_on_cuda_matches_cpu(cuda, name, policy):
    """Each zoo model from the same seed on the card and on the CPU, in
    eval and train mode (batch statistics; dropout off: the two devices'
    generators draw other masks): float32 within 1e-4, mixed (ResNet
    only: the others have no policy in the reference) within 2e-2 of
    max(1, |value|)."""
    build, make_x = ZOO[name]
    kwargs = {"dtype_policy": policy} if policy else {}
    cpu, card = build("cpu", **kwargs), build(cuda, **kwargs)
    for mod in (*cpu.modules(), *card.modules()):
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    x = torch.from_numpy(make_x(np.random.default_rng(3)))
    tol = 2e-2 if policy else 1e-4
    for train in (False, True):
        cpu.train(train)
        card.train(train)
        with torch.no_grad():
            want, got = cpu(x), card(x.to(cuda)).cpu()
        assert got.dtype == want.dtype == torch.float32
        err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
        assert err <= tol, (name, train, err)
    if policy:
        assert card.compute_dtype == torch.bfloat16


# -- streaming into the card -------------------------------------------------

STREAM_CLF = dict(vocab_size=61, maxlen=32, num_classes=2, d_model=64, num_heads=2,
                  num_layers=2, dropout=0.0, seed=5)


def _stream_data(rows=96):
    rng = np.random.default_rng(1)
    return (rng.integers(0, 61, (rows, 32)).astype(np.int32),
            rng.integers(0, 2, rows).astype(np.int32))


def test_streamed_fit_on_cuda_is_bit_equal_to_staged(cuda):
    """One step a block over 6 blocks an epoch at W = 2 (48 rows a worker,
    batch 8), so each of the two pinned buffers is refilled twice an epoch:
    a refill before its copy completed would corrupt a block. History,
    weights and Adam state bit for bit against the staged fit; one timed
    copy a block, int32 tokens crossing as int32."""
    from elephas_tpu_torch.device import force_devices

    x, y = _stream_data()
    previous = force_devices(2)
    try:
        fits = {}
        for name, kwargs in (("staged", {}), ("streamed", dict(stream_block_steps=1))):
            model = et.transformer_classifier(**STREAM_CLF, device=cuda)
            sm = et.SparkModel(model, num_workers=2, device=cuda)
            sm._runner.h2d_log = []
            hist = sm.fit((x, y), epochs=2, batch_size=8, **kwargs)
            fits[name] = (hist, model, sm._runner)
    finally:
        force_devices(previous)
    (h1, staged, _), (h2, streamed, runner) = fits["staged"], fits["streamed"]
    assert h1 == h2
    for (n, a), b in zip(staged.state_dict().items(), streamed.state_dict().values()):
        assert torch.equal(a, b), n
    sa = staged.training_spec.optimizer.state_dict()["state"]
    sb = streamed.training_spec.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in ("m", "v"))
    log = runner.h2d_log
    assert len(log) == 12
    assert all(e["bytes"] == 2 * 8 * (32 + 1) * 4 for e in log)
    torch.cuda.synchronize()
    assert all(e["start"].elapsed_time(e["end"]) >= 0 for e in log)
    assert runner.pinned_bytes == 2 * 2 * 8 * (32 + 1) * 4


def test_block_stager_takes_int32_tokens_to_int64_on_the_card(cuda):
    """The blocks of a stream of int32 tokens and float features, two epochs
    of five blocks through the two pinned buffers, the last block short (a
    view of a buffer): each equal to the host's block, tokens as int64, the
    copies logged at the int32 width, gathered in the reader thread."""
    from elephas_tpu_torch.data.streaming import ShardedStream
    from elephas_tpu_torch.worker import BlockStager

    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 2**31 - 1, (2 * 8 * 9, 5)).astype(np.int32)
    feats = rng.normal(size=(2 * 8 * 9, 7)).astype(np.float32)
    stream = ShardedStream(tokens, feats, 8, 2, block_steps=2)
    stager = BlockStager(cuda, log=[])
    want = list(stream.blocks())
    assert [s for _, _, s in want] == [2, 2, 2, 2, 1]
    got = [(t.cpu(), f.cpu(), s) for t, f, s in stager.blocks(stream, epochs=2)]
    for (t, f, s), (ht, hf, hs) in zip(got, want * 2, strict=True):
        assert s == hs and t.dtype == torch.int64 and f.dtype == torch.float32
        assert torch.equal(t, torch.from_numpy(ht).long())
        assert torch.equal(f, torch.from_numpy(hf))
    assert [e["bytes"] for e in stager.log] == [a.nbytes + b.nbytes for a, b, _ in want] * 2
    assert {e["gather_thread"] for e in stager.log} == {"block-prefetch"}
    assert stager.pinned_bytes == 2 * (want[0][0].nbytes + want[0][1].nbytes)


def test_streamed_fit_raises_on_a_failed_copy_or_pin(cuda, monkeypatch):
    """No synchronous fallback: a failed copy to the card, and a failed pin,
    raise out of the fit."""
    x, y = _stream_data(32)
    real_copy = torch.Tensor.copy_

    def failing_copy(self, src, non_blocking=False):
        if non_blocking and self.is_cuda and not src.is_cuda:
            raise RuntimeError("injected: host-to-device copy failed")
        return real_copy(self, src, non_blocking)

    model = et.transformer_classifier(**STREAM_CLF, device=cuda)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "copy_", failing_copy)
        with pytest.raises(RuntimeError, match="injected: host-to-device"):
            et.SparkModel(model, device=cuda).fit((x, y), epochs=1, batch_size=8,
                                                  stream_block_steps=1)
    real_empty = torch.empty

    def failing_empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("injected: cudaHostAlloc failed")
        return real_empty(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", failing_empty)
        with pytest.raises(RuntimeError, match="injected: cudaHostAlloc"):
            et.SparkModel(model, device=cuda).fit((x, y), epochs=1, batch_size=8,
                                                  stream_block_steps=1)


# -- the paged span kernels --------------------------------------------------

PAGED_DTYPES = ["fp", "int8", "int4"]
PAGED_DIMS = [16, 32, 64, 128]
TOL_PAGED = 1e-5  # of max(1, |out|), as the arena kernels


def _paged_pool(cuda, d, kv_dtype, b=16, h=4, bs=16, t=8, seed=0):
    """A pool of ``b · t + 5`` blocks and the sink, its rows random (codes
    and scales of them when quantized), and ``[b, t]`` tables of shuffled
    block ids, the last row's second half sentinel-padded. Returns ``(pool_k,
    pool_v, kv_scales, tables)``."""
    from elephas_tpu_torch.serving.kv_quant import quantize_rows

    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = b * t + 5
    ids = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[: b * t]
    tables = ids.view(b, t).to(torch.int32)
    tables[-1, t // 2:] = n
    rows = _randn(gen, 2, n + 1, bs, h, d)
    if kv_dtype == "fp":
        return rows[0].contiguous(), rows[1].contiguous(), None, tables.to(cuda)
    (kq, ks), (vq, vs) = (quantize_rows(r, kv_dtype) for r in rows)
    return kq, vq, (ks, vs), tables.to(cuda)


def _rel_err(out, ref):
    return ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


def _graph_replay(call):
    """``call()``'s output from the replay of a CUDA graph captured after a
    warm-up call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    graph.replay()
    return replayed


# (slots, heads, block_size, table length) of the paged decode cases: the
# engine's block of 16 over spans 128 and 512 (splits of 103 keys start
# mid-page), blocks of 1, 7 (splits of 58 keys start mid-page, every stage
# spans pages) and 64 (splits of 77 keys); and 512 rows at block 1 over a
# span of 600, one split, whose table outgrows one staged window
PAGED_DECODE_TABLES = [(16, 4, 16, 8), (16, 4, 16, 32), (16, 4, 1, 300), (16, 4, 7, 41),
                       (16, 4, 64, 6), (64, 8, 1, 600)]


@pytest.mark.parametrize("b,h,bs,t", PAGED_DECODE_TABLES)
@pytest.mark.parametrize("d", PAGED_DIMS)
@pytest.mark.parametrize("kv_dtype", PAGED_DTYPES)
def test_paged_span_decode_matches_plain_and_the_arena_kernel(cuda, kv_dtype, d, b, h, bs, t):
    """The paged decode over shuffled tables, the last row's tail
    sentinel-padded, with a position 0, the span's last row and a stale
    cursor past the span: within 1e-5 of max(1, |out|) of the plain version,
    bit-equal to the arena kernel over the gathered, dequantized span (the
    same split, the same order: only the addressing differs), and bit-equal
    on a second call and from a CUDA-graph replay."""
    pk, pv, scales, tables = _paged_pool(cuda, d, kv_dtype, b, h, bs, t, seed=d + t + bs)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, b, h, d)
    pos = torch.randint(0, t * bs, (b,), generator=gen, device=cuda, dtype=torch.int32)
    pos[:3] = torch.tensor([0, t * bs - 1, t * bs + 7], dtype=torch.int32)

    def call():
        return fs.flash_paged_span_decode(q, pk, pv, tables, pos, kv_dtype=kv_dtype,
                                          kv_scales=scales)

    before = fs.paged_launches
    out = call()
    assert fs.paged_launches == before + 1
    again, replayed = call(), _graph_replay(call)
    ref = fs.paged_span_decode_reference(q, pk, pv, tables, pos, kv_dtype=kv_dtype,
                                         kv_scales=scales)
    gk, gv = fs.paged_dense_span(pk, pv, tables, kv_dtype, scales, d)
    arena = fs.flash_span_decode(q, gk.contiguous(), gv.contiguous(), pos)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= TOL_PAGED
    assert torch.equal(out, arena)
    assert torch.equal(out, again) and torch.equal(out, replayed)


# (rows, block_size, table length) of the paged chunk cases: 16 rows of
# blocks of 16 over a span of 256 (2 splits, merged in a cluster), one row
# over 1,024 keys (16 splits: the workspace and the merge kernel), and
# blocks of 1 (a table entry a key) over 256 keys
PAGED_CHUNK_TABLES = [pytest.param(16, 16, 16, id="B16_block16_span256"),
                      pytest.param(1, 16, 64, id="B1_block16_span1024"),
                      pytest.param(16, 1, 256, id="B16_block1_span256")]


def _chunk_positions(gen, b, c, span):
    """int32 [b, c] positions offset + 0..c-1: ragged offsets, the first rows
    at 0, ending on the span's last row, and past the span."""
    offs = torch.randint(0, max(1, span - c), (b,), generator=gen, device=gen.device)
    offs[:3] = torch.tensor([0, max(0, span - c), span - c // 2])[:b]
    return (offs[:, None] + torch.arange(c, device=gen.device)[None, :]).to(torch.int32) \
        .contiguous()


@pytest.mark.parametrize("b,bs,t", PAGED_CHUNK_TABLES)
@pytest.mark.parametrize("c", [1, 64, 100])
@pytest.mark.parametrize("d", PAGED_DIMS)
@pytest.mark.parametrize("kv_dtype", PAGED_DTYPES)
def test_paged_span_chunk_matches_plain_and_the_arena_kernel(cuda, kv_dtype, d, c, b, bs, t):
    """The paged chunk over shuffled, sentinel-padded tables, with ragged
    offsets (0, the chunk ending on the span's last row, rows past the
    span): within 1e-5 of max(1, |out|) of the plain version, bit-equal to
    the arena kernel over the gathered, dequantized span, and a merge kernel
    launched only past CHUNK_CLUSTER_MAX splits."""
    h = 4
    pk, pv, scales, tables = _paged_pool(cuda, d, kv_dtype, b, h, bs, t, seed=d + c + bs)
    span = t * bs
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, b, h, c, d)
    pos = _chunk_positions(gen, b, c, span)
    before, merges = fs.paged_chunk_launches, fs.paged_chunk_merge_launches()
    out = fs.flash_paged_span_chunk(q, pk, pv, tables, pos, kv_dtype=kv_dtype, kv_scales=scales)
    assert fs.paged_chunk_launches == before + 1
    splits, _ = fs.span_chunk_splits(span, b * h, c, d, fs._sm_count(0))
    assert fs.paged_chunk_merge_launches() - merges == int(splits > fs.CHUNK_CLUSTER_MAX)
    ref = fs.paged_span_chunk_reference(q, pk, pv, tables, pos, kv_dtype=kv_dtype,
                                        kv_scales=scales)
    gk, gv = fs.paged_dense_span(pk, pv, tables, kv_dtype, scales, d)
    arena = fs.flash_span_chunk(q, gk.contiguous(), gv.contiguous(), pos)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= TOL_PAGED
    assert torch.equal(out, arena)


@pytest.mark.parametrize("b,t", [pytest.param(16, 32, id="B16_span512"),
                                 pytest.param(1, 64, id="B1_span1024")])
@pytest.mark.parametrize("kv_dtype", PAGED_DTYPES)
@pytest.mark.parametrize("decode", [True, False])
def test_paged_kernels_repeat_and_replay_bit_for_bit(cuda, kv_dtype, decode, b, t):
    """A second call and a CUDA-graph replay give the first call's bits (D
    128, blocks of 16, C 64 for the chunk: 2 splits merged in a cluster at
    16 rows over 512 keys, 16 splits and the merge kernel at one row over
    1,024)."""
    h, d, bs = 4, 128, 16
    pk, pv, scales, tables = _paged_pool(cuda, d, kv_dtype, b, h, bs, t)
    gen = torch.Generator(device=cuda).manual_seed(3)
    if decode:
        q = _randn(gen, b, h, d)
        pos = torch.randint(0, t * bs, (b,), generator=gen, device=cuda, dtype=torch.int32)
        fn = fs.flash_paged_span_decode
    else:
        q = _randn(gen, b, h, 64, d)
        offs = torch.randint(0, t * bs - 64, (b, 1), generator=gen, device=cuda)
        pos = (offs + torch.arange(64, device=cuda)).to(torch.int32).contiguous()
        fn = fs.flash_paged_span_chunk

    def call():
        return fn(q, pk, pv, tables, pos, kv_dtype=kv_dtype, kv_scales=scales)

    out, again = call(), call()
    replayed = _graph_replay(call)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, replayed)


@pytest.mark.parametrize("b,bs,t,c", [pytest.param(1, 16, 32, 64, id="B1_C64_span512"),
                                      pytest.param(1, 16, 64, 64, id="B1_C64_span1024"),
                                      pytest.param(4, 1, 300, 100, id="B4_C100_block1")])
@pytest.mark.parametrize("kv_dtype", PAGED_DTYPES)
def test_paged_span_chunk_reads_no_row_past_the_visible_keys(cuda, kv_dtype, b, bs, t, c):
    """A pool in which every row that no visible key maps to (past each
    table row's deepest position, in unleased blocks, in the sink) holds
    NaN (fp rows, or the scales of codes): the paged chunk's output is
    finite and bit-equal to its output over the same pool with those rows
    finite, which the plain version matches. A non-finite stale row never
    reaches p . v."""
    h, d = 4, 128
    pk, pv, scales, tables = _paged_pool(cuda, d, kv_dtype, b, h, bs, t, seed=c + bs)
    span = t * bs
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, b, h, c, d)
    offs = torch.randint(0, span - c, (b, 1), generator=gen, device=cuda)
    pos = (offs + torch.arange(c, device=cuda)).to(torch.int32).contiguous()
    # a pool row is read (visible) iff it holds key j <= its table row's
    # deepest position
    n1 = pk.shape[0]
    read = torch.zeros(n1, bs, dtype=torch.bool, device=cuda)
    keys = torch.arange(span, device=cuda)
    for i in range(b):
        seen = keys <= pos[i].max()
        read[tables[i, keys[seen] // bs].long(), keys[seen] % bs] = True
    leaves = [pk, pv] if kv_dtype == "fp" else list(scales)
    poisoned = [x.clone() for x in leaves]
    for x in poisoned:
        x[~read] = float("nan")
    nan_pool = (poisoned[0], poisoned[1], None) if kv_dtype == "fp" \
        else (pk, pv, tuple(poisoned))

    def call(k, v, sc):
        return fs.flash_paged_span_chunk(q, k, v, tables, pos, kv_dtype=kv_dtype, kv_scales=sc)

    out = call(*nan_pool)
    clean = call(pk, pv, scales)
    ref = fs.paged_span_chunk_reference(q, pk, pv, tables, pos, kv_dtype=kv_dtype,
                                        kv_scales=scales)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, clean)
    assert _rel_err(out, ref) <= TOL_PAGED


def test_paged_kernels_refuse_what_they_do_not_take(cuda):
    pk, pv, scales, tables = _paged_pool(cuda, 64, "int8")
    q = torch.zeros(16, 4, 64, device=cuda)
    pos = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="kv_scales"):
        fs.flash_paged_span_decode(q, pk, pv, tables, pos, kv_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        fs.flash_paged_span_decode(q, pk.float(), pv.float(), tables, pos, kv_dtype="int8",
                                   kv_scales=scales)
    with pytest.raises(ValueError, match="tables"):
        fs.flash_paged_span_decode(q, pk, pv, tables.long(), pos, kv_dtype="int8",
                                   kv_scales=scales)
    with pytest.raises(ValueError, match="positions"):
        fs.flash_paged_span_chunk(q[:, :, None], pk, pv, tables, pos, kv_dtype="int8",
                                  kv_scales=scales)
    with pytest.raises(ValueError, match="kv_dtype"):
        fs.flash_paged_span_decode(q, pk, pv, tables, pos, kv_dtype="fp8", kv_scales=scales)


@pytest.mark.parametrize("kv_dtype", PAGED_DTYPES)
def test_paged_engine_on_cuda_matches_cpu(cuda, kv_dtype):
    """The paged engine on the card (paged span chunk and span decode,
    LayerNorm), with preemption and a prefix hit, emits the CPU engine's
    tokens from the same random weights wherever the plain path's top-2
    margin is at least 1e-3, and launches no flash forward."""
    cfg = dict(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2, seed=3)
    cpu = et.transformer_lm(**cfg, device="cpu")
    card = et.transformer_lm(**cfg, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    rng = np.random.default_rng(0)
    shared = list(rng.integers(1, 64, 16))
    prompts = [shared + list(rng.integers(1, 64, n)) for n in (3, 9, 17, 5)]
    outs = {}
    counts = (fs.paged_launches, fs.paged_chunk_launches, fa.launches)
    for name, model in (("cpu", cpu), ("cuda", card)):
        engine = et.InferenceEngine(model, num_slots=4, steps_per_sync=4, paged=True,
                                    block_size=8, num_blocks=20, preemption=True,
                                    prefix_cache=True, kv_dtype=kv_dtype)
        first = engine.submit(prompts[0], 12)
        engine.run()
        reqs = [first] + [engine.submit(p, 12, priority=i % 2) for i, p in
                          enumerate(prompts[1:])]
        engine.run()
        outs[name] = [r.tokens for r in reqs]
        held = {b for e in engine.scheduler.prefix_index._entries.values() for b in e.blocks}
        assert engine.stats()["prefix_cache"]["hits"] > 0
        assert engine.stats()["blocks_free"] == engine.num_blocks - len(held)
    after = (fs.paged_launches, fs.paged_chunk_launches, fa.launches)
    assert after[0] > counts[0] and after[1] > counts[1] and after[2] == counts[2]
    for prompt, got, want in zip(prompts, outs["cuda"], outs["cpu"]):
        if got == want:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = torch.tensor([list(prompt) + want[:i]])
        with torch.inference_mode():
            top2 = cpu(seq, plain=True)[0, -1].topk(2).values
        assert (top2[0] - top2[1]).item() < 1e-3, (prompt, got, want)


# -- speculative decoding's verify window on the card ----------------------------------

# a verify round feeds W = spec_k + 1 = 5 rows for every slot of config A's
# 16-slot arena (4 heads of 128), at ragged cursors, over the span buckets
VERIFY_W = 5
VERIFY_SPANS = [128, 256, 512]


@pytest.mark.parametrize("span", VERIFY_SPANS)
def test_verify_window_matches_plain(cuda, span):
    """The span chunk at the verify window's shape: within 1e-5 of
    max(1, |out|) of its plain version, one launch a call, bit for bit on a
    repeat and from a CUDA-graph replay."""
    gen = torch.Generator(device=cuda).manual_seed(span + VERIFY_W)
    q, k, v, pos = _chunk_case(gen, 128, span, VERIFY_W, 16, 4)

    def call():
        return fs.flash_span_chunk(q, k, v, pos)

    before = fs.chunk_launches
    out = call()
    assert fs.chunk_launches == before + 1
    again, replayed = call(), _graph_replay(call)
    ref = fs.span_chunk_reference(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and _rel_err(out, ref) <= 1e-5
    assert torch.equal(out, again) and torch.equal(out, replayed)


@pytest.mark.parametrize("span", VERIFY_SPANS)
@pytest.mark.parametrize("kv_dtype", PAGED_DTYPES)
def test_paged_verify_window_matches_plain_and_the_arena_kernel(cuda, kv_dtype, span):
    """The paged chunk at the verify window's shape (16 rows of 5, blocks of
    16, shuffled and sentinel-padded tables): within 1e-5 of max(1, |out|)
    of the plain version, bit-equal to the arena kernel over the gathered,
    dequantized span and on a repeat."""
    b, h, d, bs = 16, 4, 128, 16
    pk, pv, scales, tables = _paged_pool(cuda, d, kv_dtype, b, h, bs, span // bs, seed=span)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, b, h, VERIFY_W, d)
    pos = _chunk_positions(gen, b, VERIFY_W, span)

    def call():
        return fs.flash_paged_span_chunk(q, pk, pv, tables, pos, kv_dtype=kv_dtype,
                                         kv_scales=scales)

    before = fs.paged_chunk_launches
    out = call()
    assert fs.paged_chunk_launches == before + 1
    again = call()
    ref = fs.paged_span_chunk_reference(q, pk, pv, tables, pos, kv_dtype=kv_dtype,
                                        kv_scales=scales)
    gk, gv = fs.paged_dense_span(pk, pv, tables, kv_dtype, scales, d)
    arena = fs.flash_span_chunk(q, gk.contiguous(), gv.contiguous(), pos)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= TOL_PAGED
    assert torch.equal(out, arena) and torch.equal(out, again)


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_engine_on_cuda_matches_cpu(cuda, paged):
    """The speculative engine on the card (verify rounds through the span
    chunk, fallback windows through the span decode), n-gram drafts and a
    draft model, emits the CPU engine's tokens from the same random
    weights wherever the plain path's top-2 margin is at least 1e-3, and
    counts one span-chunk launch a layer a verify round."""
    cfg = dict(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2, seed=3)
    cpu = et.transformer_lm(**cfg, device="cpu")
    card = et.transformer_lm(**cfg, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 8, n)) * 2 for n in (3, 5, 9, 4, 6)]
    kw = dict(paged=True, block_size=8) if paged else {}
    for drafter in ("ngram", "model"):
        outs = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            spec = model if drafter == "model" else "ngram"
            engine = et.InferenceEngine(model, num_slots=4, speculative=True, spec_k=4,
                                        spec_drafter=spec, **kw)
            before = fs.paged_chunk_launches if paged else fs.chunk_launches
            reqs = [engine.submit(p, 12) for p in prompts]
            engine.run()
            outs[name] = [r.tokens for r in reqs]
            rounds = engine.stats()["spec_verify_rounds"]
            if name == "cuda":
                assert rounds > 0
                launched = (fs.paged_chunk_launches if paged else fs.chunk_launches) - before
                # paged, every prefill is a chunk pass too; the draft model's
                # catch-up runs on its own fixed arena
                if not paged:
                    catchup = engine._drafter.catchup_passes if drafter == "model" else 0
                    assert launched == (rounds + catchup) * cfg["num_layers"]
                else:
                    assert launched > rounds * cfg["num_layers"]
        for prompt, got, want in zip(prompts, outs["cuda"], outs["cpu"]):
            if got == want:
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            seq = torch.tensor([list(prompt) + want[:i]])
            with torch.inference_mode():
                top2 = cpu(seq, plain=True)[0, -1].topk(2).values
            assert (top2[0] - top2[1]).item() < 1e-3, (prompt, got, want)


def test_policy_engine_on_cuda_matches_cpu(cuda):
    """A fair-share engine on the card emits the CPU engine's tokens and
    admission order (the policy is host code), and refuses the same
    request."""
    from elephas_tpu_torch.serving import AdmissionRejected, FairSharePolicy

    cfg = dict(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2, seed=3)
    cpu = et.transformer_lm(**cfg, device="cpu")
    card = et.transformer_lm(**cfg, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 64, n)) for n in (3, 9, 17, 5, 12, 30)]
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        engine = et.InferenceEngine(model, num_slots=2, policy=FairSharePolicy(
            {"a": 1.0, "b": 3.0}, max_queue_tokens=120))
        reqs = [engine.submit(p, 12, tenant="ab"[i % 2], ttft_deadline_ms=100.0 * (i % 3 + 1))
                for i, p in enumerate(prompts)]
        order = []
        while engine.scheduler.has_work:
            order += [r.rid - engine.scheduler.rid_base for r, _t, _d in engine.step()
                      if len(r.tokens) == 1]
        outs[name] = ([r.tokens for r in reqs], [type(r.error).__name__ for r in reqs], order)
        assert any(isinstance(r.error, AdmissionRejected) for r in reqs)
    assert outs["cuda"][1:] == outs["cpu"][1:]
    for prompt, got, want in zip(prompts, outs["cuda"][0], outs["cpu"][0]):
        if got == want:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = torch.tensor([list(prompt) + want[:i]])
        with torch.inference_mode():
            top2 = cpu(seq, plain=True)[0, -1].topk(2).values
        assert (top2[0] - top2[1]).item() < 1e-3, (prompt, got, want)


# -- the serving front door on the card: gateway, migration, telemetry --------------

FRONT_DOOR = dict(vocab_size=64, maxlen=128, d_model=64, num_heads=2, num_layers=2, seed=3)


def _front_door_prompts(n=4, seed=2):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 64, k)] for k in (5, 17, 9, 30)[:n]]


@pytest.mark.parametrize("paged", [False, True])
def test_gateway_on_cuda_serves_the_in_process_tokens(cuda, paged):
    """A Gateway over an engine on the card, the wrappers' per-device caches
    (SM counts, the paged kernels' set-up) emptied first, so the driver
    thread makes their first calls: a batch-form POST and an SSE stream
    give the tokens the same engine gives in process for the same
    submissions afterwards."""
    import http.client
    import json

    from elephas_tpu_torch.serving import Gateway

    options = dict(paged=True, block_size=16, num_blocks=64) if paged else {}
    engine = et.InferenceEngine(et.transformer_lm(**FRONT_DOOR, device=cuda), num_slots=4,
                                steps_per_sync=4, **options)
    prompts = _front_door_prompts()
    for cache in (fs._SMS, fs._PAGED_DECODE, fs._PAGED_CHUNK, ln._SMS):
        cache.clear()
    launches = (fs.launches, fs.paged_launches)
    with Gateway(engine) as gw:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompts": prompts, "max_new_tokens": 12, "stream": False}))
        results = json.loads(conn.getresponse().read())["results"]
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": prompts[1], "max_new_tokens": 12}))
        resp = conn.getresponse()
        rid = int(resp.getheader("X-Request-Id"))
        events = [json.loads(line[6:]) for line in resp.read().decode().splitlines()
                  if line.startswith("data: ")]
        conn.close()
    assert (fs.paged_launches if paged else fs.launches) > launches[paged]
    batch = [engine.submit(p, 12) for p in prompts]
    engine.run()
    alone = engine.submit(prompts[1], 12)
    engine.run()
    assert [r["tokens"] for r in results] == [r.tokens for r in batch]
    assert events[0]["rid"] == rid
    assert [e["token"] for e in events if "token" in e] == alone.tokens


def _rows_of(engine, blocks):
    from elephas_tpu_torch.serving.paged_kv import gather_blocks

    ids = torch.tensor(list(blocks), dtype=torch.long, device=engine.device)
    return {name: [z.cpu().numpy().tobytes() for z in leaves]
            for name, leaves in gather_blocks(engine.arena, ids).items()}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_migration_between_cuda_paged_engines_is_bit_exact(cuda, kv_dtype):
    """export_request → wire → import_request between two paged engines on
    the card: the migrated request's tokens are those of the same request
    run alone, and A's stored rows, the record's and B's resumed rows are
    the same bytes (fp rows, or int8 codes and scales); both pools whole."""
    from elephas_tpu_torch.fleet.migration import decode_record, encode_record
    from elephas_tpu_torch.serving.paged_kv import blocks_for

    model = et.transformer_lm(**FRONT_DOOR, device=cuda)
    opts = dict(num_slots=4, steps_per_sync=4, paged=True, block_size=16, num_blocks=64,
                kv_dtype=kv_dtype)
    prompt = _front_door_prompts()[3]
    ref = et.InferenceEngine(model, **opts)
    want = ref.submit(prompt, 40)
    ref.run()
    a, b = et.InferenceEngine(model, **opts), et.InferenceEngine(model, **opts)
    req = a.submit(prompt, 40)
    a.step()
    a.step()
    cur = len(prompt) + len(req.tokens) - 1
    held = _rows_of(a, a.scheduler.tables[req.slot][:blocks_for(cur, 16)])
    record = decode_record(encode_record(a.export_request(req.rid)))
    resumed = {}
    resume = b._resume

    def snapshot(adm):
        resume(adm)
        resumed.update(_rows_of(b, adm.blocks[:record["n_blocks"]]))

    b._resume = snapshot
    moved = b.import_request(record)
    b.run()
    assert moved.tokens == want.tokens
    sent = {name: [np.asarray(x).tobytes() for x in leaves]
            for name, leaves in record["rows"].items()}
    assert held == sent == resumed
    for e in (a, b):
        assert e.scheduler.allocator.free_count == e.num_blocks


def _sync_calls(fn):
    """The synchronizing CUDA calls of ``fn()``, by the Python line that made
    each (torch.cuda.set_sync_debug_mode's warnings)."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                               if "synchroniz" in str(w.message))


def test_telemetry_adds_no_synchronizing_call(cuda):
    """The same requests on an engine with the registry on and on one built
    under null mode make the same number of synchronizing CUDA calls:
    telemetry records host values only."""
    from elephas_tpu_torch import telemetry

    model = et.transformer_lm(**FRONT_DOOR, device=cuda)
    prompts = _front_door_prompts()
    was = telemetry.set_null(True)
    try:
        null = et.InferenceEngine(model, num_slots=4, steps_per_sync=4)
    finally:
        telemetry.set_null(was)
    on = et.InferenceEngine(model, num_slots=4, steps_per_sync=4)
    engines = (("on", on), ("null", null))
    for _name, engine in engines:  # warm
        engine.run([(p, 12) for p in prompts])
    # a process's first switch to the "warn" mode reports one synchronizing
    # call of its own (torch/cuda/__init__.py): make it before counting
    _sync_calls(lambda: None)
    counts = {name: _sync_calls(lambda e=engine: e.run([(p, 12) for p in prompts]))
              for name, engine in engines}
    assert counts["on"] == counts["null"] and sum(counts["on"].values()) > 0, counts
    assert null.scrape() == "" and on.scrape(full=False)


def test_driver_cuda_error_turns_healthz_503_and_stops_the_gateway(cuda):
    """A CUDA error raised in the gateway's driver thread (an allocation the
    card refuses) makes /healthz answer 503 driver-dead while the teardown
    runs, then the gateway stops and releases its port: nothing carries on."""
    import http.client
    import json
    import socket
    import threading
    import time

    from elephas_tpu_torch.serving import Gateway

    engine = et.InferenceEngine(et.transformer_lm(**FRONT_DOOR, device=cuda), num_slots=2)
    gw = Gateway(engine).start()
    port = gw.port

    def refused_allocation():
        return torch.empty(1 << 62, dtype=torch.uint8, device=cuda)

    engine.step = refused_allocation

    def submit():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", "/v1/generate", body=json.dumps(
                {"prompt": [2, 3, 4], "max_new_tokens": 4, "stream": False}))
            conn.getresponse().read()
        except (OSError, http.client.HTTPException):
            pass  # severed by the teardown

    with gw._stop_lock:  # the teardown waits here: /healthz answers meanwhile
        client = threading.Thread(target=submit)
        client.start()
        deadline = time.monotonic() + 30
        while True:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            if resp.status == 503:
                break
            assert time.monotonic() < deadline, body
            time.sleep(0.05)
        assert body["status"] == "driver-dead" and body["driver_alive"] is False
    client.join(60)
    assert isinstance(gw.driver_error, torch.OutOfMemoryError)
    deadline = time.monotonic() + 30
    while True:
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind(("127.0.0.1", port))
            break
        except OSError:
            assert time.monotonic() < deadline, "port still held after the driver died"
            time.sleep(0.1)
        finally:
            probe.close()
    gw._driver_thread.join(30)  # the teardown ran on the driver thread itself
    assert not gw._driver_thread.is_alive()
    gw.stop()  # idempotent after the crash teardown


# -- the parameter server on the card ------------------------------------


@pytest.mark.parametrize("store", ["http", "socket", "native"])
def test_ps_fit_on_cuda_publishes_the_master(cuda, store, tmp_path):
    """A fit with a live weight store on the card: the store's final
    weights are the master's host copy bit for bit, the journal holds
    them, and the fit ran the flash and LayerNorm kernels."""
    from elephas_tpu_torch.parameter import journal
    from elephas_tpu_torch.utils.weights import get_weights

    gen = np.random.default_rng(0)
    x = gen.integers(0, 64, size=(64, 32)).astype(np.int32)
    y = gen.integers(0, 2, size=64).astype(np.int32)
    model = et.transformer_classifier(vocab_size=64, maxlen=32, num_classes=2, d_model=64,
                                      num_heads=2, num_layers=2, device=cuda)
    sm = et.SparkModel(model, mode="asynchronous", parameter_server_mode=store, port=0,
                       ps_journal_dir=str(tmp_path), device=cuda)
    fwd0, ln0 = fa.launches, ln.fwd_launches
    hist = sm.fit((x, y), epochs=2, batch_size=16)
    assert np.isfinite(hist["loss"]).all()
    assert fa.launches > fwd0 and ln.fwd_launches > ln0
    stored, _, _ = journal.load_journal(str(tmp_path))
    master = get_weights(model)
    for got, want in zip(stored, master):
        np.testing.assert_array_equal(got, want)
    # the device-side Keras layout is the host-side one, bit for bit
    host = et.keras_weights(model)
    for got, path in zip(master, et.utils.weights.weight_paths(model)):
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, host[path])


@pytest.mark.parametrize("overlap", [False, True])
def test_async_worker_on_cuda_descends(cuda, overlap):
    """``AsynchronousSparkWorker`` trains on the card against a socket
    store (overlapped rounds too: the sync thread sees host arrays only)
    and the store's loss falls. Without overlap the rounds are in step,
    so the same worker on the CPU, against a store of its own, ends
    where the card's does."""
    from elephas_tpu_torch.fault.harness import _chaos_data, _chaos_model
    from elephas_tpu_torch.parameter import SocketServer
    from elephas_tpu_torch.utils.weights import get_weights, set_weights
    from elephas_tpu_torch.worker import AsynchronousSparkWorker, Runner

    x, y, d, k = _chaos_data(0, 256)
    model, model_json = _chaos_model(0, d, k, device=cuda)
    initial = get_weights(model)

    def train_on(device):
        server = SocketServer(initial, mode="asynchronous", port=0)
        server.start()
        try:
            worker = AsynchronousSparkWorker(
                model_json, train_config={"epochs": 3, "batch_size": 64}, frequency="batch",
                parameter_server_mode="socket", master=f"127.0.0.1:{server.port}",
                master_optimizer="adam", master_loss="sparse_categorical_crossentropy",
                overlap=overlap, device=device)
            (weights, _), = worker.train(iter(zip(x, y)))
            assert len(weights) == len(initial)
            return server.get_parameters()
        finally:
            server.stop()

    final = train_on(cuda)
    runner = Runner(model, "synchronous", "epoch", 1)
    losses = []
    for w in (initial, final):
        set_weights(model, w)
        losses.append(runner.evaluate([(x, y)], 64)["loss"])
    assert losses[1] < losses[0] * 0.9
    if not overlap:
        for a, b in zip(final, train_on("cpu")):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_chaos_training_on_cuda_loses_nothing(cuda, tmp_path):
    from elephas_tpu_torch.fault import FaultPlan, run_chaos_training

    plan = FaultPlan(seed=0, kill_ps_after_updates=2, restart_delay_s=0.3,
                     duplicate_fraction=0.25)
    out = run_chaos_training("socket", rows=192, epochs=2, batch_size=64, plan=plan,
                             journal_dir=str(tmp_path), journal_every=1, device=cuda)
    assert out["kills"] == 1 and out["restarts"] == 1
    assert out["updates_applied"] == 6 and out["updates_lost_final"] == 0
    assert out["duplicates_skipped"] >= out["duplicates_sent"] >= 1


# -- the serving fleet and weight deployment on the card --------------------------------

FLEET_ENGINE = dict(num_slots=4, steps_per_sync=4, paged=True, block_size=16, num_blocks=48,
                    preemption=True, prefix_cache=True)


def _assert_tokens_or_ties(cpu_model, prompts, got, want):
    """``got`` (card) equals ``want`` (CPU) request by request, except past a
    step where the CPU's plain path has a top-2 logit margin under 1e-3 (a
    tie either side may break)."""
    for prompt, g, w in zip(prompts, got, want):
        if g == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        seq = torch.tensor([list(prompt) + w[:i]])
        with torch.inference_mode():
            top2 = cpu_model(seq, plain=True)[0, -1].topk(2).values
        assert (top2[0] - top2[1]).item() < 1e-3, (prompt, g, w)


def test_router_on_cuda_serves_the_cpu_tokens(cuda):
    """Two paged replicas on the one card behind a Router: prefix affinity,
    a drain in the middle of the streams and a replica killed in the middle
    of the streams; every request's tokens are one CPU engine's on the same
    weights, and the killed replica's arena goes back to the allocator."""
    import threading
    import time

    from elephas_tpu_torch.fleet import Router

    cpu = et.transformer_lm(**FRONT_DOOR, device="cpu")
    card = et.transformer_lm(**FRONT_DOOR, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    prompts = [_front_door_prompts()[1] + p for p in _front_door_prompts()]
    ref = et.InferenceEngine(cpu, **FLEET_ENGINE)
    want = ref.run([(p, 24) for p in prompts])
    want = [seq.tolist()[len(p):] for p, seq in zip(prompts, want.values())]
    engines = {"a": et.InferenceEngine(card, **FLEET_ENGINE),
               "b": et.InferenceEngine(card, **FLEET_ENGINE)}
    router = Router(engines, min_affinity_tokens=16)
    with router:
        first = router.submit(prompts[0], 24)
        assert first.wait(120)
        # the first replica's steps stop once one of them has emitted, so
        # the drain finds its streams in flight, some tokens delivered
        victim = engines[first.replica]
        held = threading.Event()
        real_step = victim.step

        def step_then_hold():
            if held.is_set():
                time.sleep(0.001)
                return []
            out = real_step()
            if out:
                held.set()
            return out

        victim.step = step_then_hold
        reqs = [first] + [router.submit(p, 24) for p in prompts[1:]]
        assert held.wait(120)
        streamed = [len(r.tokens) for r in reqs]
        moved = router.drain(first.replica, timeout=120)
        del victim.step
        router.undrain(first.replica)
        assert moved >= 1 and router.stats()["migrated"] == moved
        assert any(r.migrations >= 1 and n > 0 for r, n in zip(reqs, streamed))
        assert all(r.wait(120) for r in reqs)
        assert router.stats()["placements"]["affinity"] >= 1
        _assert_tokens_or_ties(cpu, prompts, [r.tokens for r in reqs], want)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        arena = engines["a"].arena.nbytes()
        reqs = [router.submit(p, 24) for p in prompts]
        router.kill_replica("a")
        assert all(r.wait(120) for r in reqs)
        _assert_tokens_or_ties(cpu, prompts, [r.tokens for r in reqs], want)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda) <= before - arena
    router.release_telemetry()


def test_subscriber_applies_on_cuda(cuda):
    """A socket store holds the weights; a ledger publishes new ones; the
    subscriber pulls them over the wire (int8 pull compression off) into a
    card engine, which then serves a CPU engine's tokens on them."""
    from elephas_tpu_torch.deploy import VersionLedger, WeightSubscriber
    from elephas_tpu_torch.parameter.client import SocketClient
    from elephas_tpu_torch.parameter.server import SocketServer
    from elephas_tpu_torch.utils.weights import get_weights, set_weights

    cpu = et.transformer_lm(**FRONT_DOOR, device="cpu")
    card = et.transformer_lm(**FRONT_DOOR, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    store = SocketServer(get_weights(cpu), mode="asynchronous", port=0)
    store.start()
    client = SocketClient(master=f"127.0.0.1:{store.port}")
    engine = et.InferenceEngine(card, **FLEET_ENGINE)
    try:
        ledger = VersionLedger(store)
        sub = WeightSubscriber(engine, client)
        rng = np.random.default_rng(4)
        new = [w + rng.normal(0, 0.02, w.shape).astype(w.dtype) for w in get_weights(cpu)]
        version = ledger.publish(new)
        assert sub.poll_once() == version and sub.poll_once() is None
        assert engine.weight_version == version and sub.applies == 1
        for a, b in zip(get_weights(card), new):
            np.testing.assert_array_equal(a, b)
        set_weights(cpu, new)
        prompts = _front_door_prompts()
        got = engine.run([(p, 16) for p in prompts])
        want = et.InferenceEngine(cpu, **FLEET_ENGINE).run([(p, 16) for p in prompts])
        _assert_tokens_or_ties(cpu, prompts,
                               [s.tolist()[len(p):] for p, s in zip(prompts, got.values())],
                               [s.tolist()[len(p):] for p, s in zip(prompts, want.values())])
    finally:
        client.close()
        store.stop()


# -- the Switch mixture-of-experts family on the card ------------------------------------

# SW-A's MoE layer (d_model 512, 8 experts of 2,048, top-2, capacity factor 4):
# the engine's decode (16 slots) and a 512-token prefill
MOE_SHAPES = [pytest.param(16, id="decode_T16"), pytest.param(512, id="prefill_T512")]
MOE = dict(d=512, h=2048, e=8, k=2, cf=4.0)


def _moe_inputs(cuda, t, seed=0):
    from elephas_tpu_torch.ops import moe

    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = moe.init_moe_params(gen, MOE["d"], MOE["h"], MOE["e"])
    b1 = 0.1 * torch.randn(params[2].shape, generator=gen, device=cuda)
    b2 = 0.1 * torch.randn(params[4].shape, generator=gen, device=cuda)
    x = torch.randn(t, MOE["d"], generator=gen, device=cuda)
    return x, (params[0], params[1], b1, params[3], b2)


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["roomy", "drops"])
@pytest.mark.parametrize("t", MOE_SHAPES)
def test_moe_ffn_matches_its_plain_version(cuda, t, cf):
    """The index route against the dense plain version on the card: the
    same kept routing, outputs within 1e-6 of max(1, |out|), every gradient
    within 1e-5 of its tensor's largest."""
    from elephas_tpu_torch.ops import moe

    x, params = _moe_inputs(cuda, t)
    xs = [a.clone().requires_grad_() for a in (x, *params)]
    capacity = moe.capacity_for(t, MOE["e"], cf, MOE["k"])
    out, aux = moe.moe_ffn(*xs, capacity, MOE["k"], torch.nn.functional.gelu, return_aux=True)
    ref, ref_aux = moe.moe_ffn_reference(*xs, cf, torch.nn.functional.gelu, k=MOE["k"],
                                         return_aux=True)
    assert (out - ref).abs().max().item() <= 1e-6 * max(1.0, ref.abs().max().item())
    assert abs(aux.item() - ref_aux.item()) <= 1e-6
    grads = torch.autograd.grad((out ** 2).sum() + aux, xs)
    want = torch.autograd.grad((ref ** 2).sum() + ref_aux, xs)
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()
    experts, positions, _, _ = moe.topk_route(x, params[0], MOE["e"], capacity, MOE["k"])
    dispatch = moe._topk_dispatch(x, params[0], MOE["e"], capacity, MOE["k"])[0]
    kept = positions < capacity
    got = torch.stack([torch.arange(t, device=cuda).expand_as(experts)[kept], experts[kept],
                       positions[kept]], 1).tolist()
    assert sorted(got) == sorted(torch.nonzero(dispatch).tolist())


def test_moe_ffn_makes_no_synchronizing_call(cuda):
    """Forward and backward of the main path under
    torch.cuda.set_sync_debug_mode("error"): no call reads the card."""
    from elephas_tpu_torch.ops import moe

    x, params = _moe_inputs(cuda, 512)
    xs = [a.clone().requires_grad_() for a in (x, *params)]
    capacity = moe.capacity_for(512, MOE["e"], 1.5, MOE["k"])
    moe.moe_ffn(*xs, capacity, MOE["k"])  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.moe_ffn(*xs, capacity, MOE["k"], return_aux=True)
        torch.autograd.grad((out ** 2).sum() + aux, xs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("options", [dict(), dict(paged=True, block_size=8, num_blocks=64),
                                     dict(speculative=True, spec_k=3)],
                         ids=["fixed", "paged", "speculative"])
def test_switch_engine_on_cuda_matches_cached_generate(cuda, options):
    """The Switch LM (k · cf = E: nothing drops) serves on the card
    token-exact with generate(kv_cache=True) on the card, wherever the
    plain path's top-2 margin is at least 1e-3, and matches the CPU
    engine's tokens under the same rule."""
    cfg = dict(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2,
               num_experts=4, k=2, capacity_factor=2.0, seed=5)
    cpu = et.switch_transformer_lm(**cfg, device="cpu")
    card = et.switch_transformer_lm(**cfg, device=cuda)
    et.load_keras_weights(card, et.keras_weights(cpu))
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 64, n)) for n in (3, 9, 17, 5)]
    want = [et.generate(card, np.array([p]), 12, kv_cache=True)[0].tolist()[len(p):]
            for p in prompts]
    def served(model):
        out = et.InferenceEngine(model, num_slots=4, steps_per_sync=4, **options).run(
            [(np.array(p), 12) for p in prompts])
        return [out[rid].tolist()[len(p):] for p, rid in zip(prompts, sorted(out))]

    got = served(card)
    _assert_tokens_or_ties(cpu, prompts, got, want)
    _assert_tokens_or_ties(cpu, prompts, got, served(cpu))


# -- sequence-parallel attention and the SP prefill (PR 21) ----------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("w", [2, 4])
def test_ring_and_ulysses_launch_the_flash_forward(cuda, w, causal):
    """Ring attention and Ulysses over a mesh naming cuda:0 w times: every
    (query shard, chunk) pair, or head group, launches the flash forward,
    and the whole-sequence output is within 1e-5 of max(1, |out|) of the
    plain flash forward."""
    from elephas_tpu_torch.ops.ring_attention import ring_attention_sharded
    from elephas_tpu_torch.ops.ulysses import ulysses_attention_sharded
    from elephas_tpu_torch.parallel.mesh import Mesh

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, 1, 4, 256, 128) for _ in range(3))
    mesh = Mesh([cuda] * w, ("seq",))
    want = fa.flash_forward_reference(q, k, v, 128 ** -0.5, causal)[0]
    before = fa.launches
    ring = ring_attention_sharded(q[0], k[0], v[0], mesh, "seq", causal)
    assert fa.launches - before == (w * (w + 1) // 2 if causal else w * w)
    before = fa.launches
    uly = ulysses_attention_sharded(q, k, v, mesh, "seq", causal)
    assert fa.launches - before == w
    for got in (ring[None], uly):
        assert ((got - want).abs() / want.abs().clamp_min(1.0)).max().item() <= 1e-5


def test_sp_engine_on_cuda_matches_the_paged_engine(cuda):
    """The engine's SP prefill on the card: a long prompt over a mesh of
    cuda:0 twice decodes the paged engine's tokens, ring and Ulysses."""
    from elephas_tpu_torch.parallel.mesh import Mesh

    lm = et.transformer_lm(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2,
                           seed=0, device=cuda)
    prompt = np.arange(40) % 60 + 2
    kw = dict(num_slots=2, paged=True, block_size=16)
    want = et.InferenceEngine(lm, **kw).run([(prompt, 6)])
    for mechanism in ("ring", "ulysses"):
        engine = et.InferenceEngine(lm, sp_prefill=Mesh([cuda] * 2, ("seq",)),
                                    sp_threshold=32, sp_mechanism=mechanism, **kw)
        before = fa.launches
        got = engine.run([(prompt, 6)])
        assert fa.launches > before
        assert [list(s) for s in got.values()] == [list(s) for s in want.values()]


# -- tensor parallelism ------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,d", [(128, 256, 4, 128), (64, 256, 4, 128), (1, 512, 2, 128),
                                     (4, 512, 2, 128)])
def test_flash_at_the_tensor_parallel_shard_shapes(cuda, b, s, h, d, causal):
    """The packed flash forward (K1b) at the heads a shard of a 2-way model
    axis holds: T's 4 of 8 (the one copy's batch and a replica's half) and
    config A's 2 of 4 at generate's rows; fp32 out within 1e-4, lse 1e-4."""
    _check_case(cuda, "packed", b, h, s, s, d, torch.float32, causal)


def _tp_classifier(cuda):
    return et.transformer_classifier(vocab_size=256, maxlen=64, num_classes=2, d_model=128,
                                     num_heads=4, num_layers=2, dropout=0.0, seed=3,
                                     device=cuda)


def test_tensor_parallel_fit_on_cuda_matches_model_parallel_1(cuda, tmp_path):
    """A classifier on a 1 x 2 mesh naming cuda:0 twice against the same
    weights on a 1 x 1 mesh: history and weights within 1e-4, the flash
    forward launched at half the heads by each shard; then the sharded
    checkpoint: two files, restored after another epoch bit-equal."""
    from elephas_tpu_torch.parallel.mesh import Mesh
    from elephas_tpu_torch.parallel.tensor import ShardedTrainer

    rng = np.random.default_rng(0)
    x = rng.integers(1, 256, size=(96, 64))
    y = rng.integers(0, 2, size=96)
    a, b = _tp_classifier(cuda), _tp_classifier(cuda)
    two = ShardedTrainer(a, mesh=Mesh([[cuda, cuda]], ("data", "model")))
    one = ShardedTrainer(b, mesh=Mesh([[cuda]], ("data", "model")))
    before = fa.launches
    h2 = two.fit(x, y, epochs=2, batch_size=32)
    assert fa.launches - before == 2 * 2 * 2 * 3  # shards x layers x epochs x steps
    h1 = one.fit(x, y, epochs=2, batch_size=32)
    for key in h1:
        np.testing.assert_allclose(h2[key], h1[key], rtol=1e-4, atol=1e-4)
    wa, wb = et.keras_weights(a), et.keras_weights(b)
    for path in wb:
        np.testing.assert_allclose(wa[path], wb[path], rtol=1e-4, atol=1e-4, err_msg=path)
    path = two.save_checkpoint(str(tmp_path / "ck"), 2)
    assert sorted(p.name for p in (tmp_path / "ck" / "ckpt-00002.tp").iterdir()) == [
        "shard-000.pt", "shard-001.pt"]
    saved = {k: v.clone() for k, v in a.state_dict().items()}
    two.fit(x, y, epochs=1, batch_size=32)
    assert two.restore_checkpoint(str(tmp_path / "ck"))["epoch"] == 2
    for k, v in a.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert path.endswith("ckpt-00002.tp")


@pytest.mark.parametrize("kv_cache", [False, True])
def test_generate_on_a_cuda_mesh_matches_unmeshed(cuda, kv_cache):
    """generate over a 2 x 2 mesh naming cuda:0 four times, the heads sharded
    over 'model': the unmeshed tokens, the span decode (kv_cache) or the
    flash forward launched by every shard."""
    from elephas_tpu_torch.parallel.mesh import Mesh

    lm = et.transformer_lm(vocab_size=64, maxlen=64, d_model=64, num_heads=2, num_layers=2,
                           seed=0, device=cuda)
    prompt = (np.arange(30).reshape(3, 10) % 60 + 2).astype(np.int32)
    want = et.generate(lm, prompt, 8, kv_cache=kv_cache)
    mesh = Mesh([[cuda, cuda], [cuda, cuda]], ("data", "model"))
    before = fs.launches if kv_cache else fa.launches
    got = et.generate(lm, prompt, 8, kv_cache=kv_cache, mesh=mesh, model_axis="model")
    launched = (fs.launches if kv_cache else fa.launches) - before
    assert launched == 2 * 2 * 2 * ((10 + 8 - 1) if kv_cache else 8)
    np.testing.assert_array_equal(got, want)
