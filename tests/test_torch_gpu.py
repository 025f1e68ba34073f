"""The port's CUDA kernels (flash forward, LayerNorm forward and
backward, span decode) against their plain versions, one SparkModel fit
and the serving engine, on the card.

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
    ref = fs.flash_span_chunk(q[:, :, None], k, v, pos[:, None])[:, :, 0]
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
