"""The port's quantized paged KV (``elephas_tpu_torch.serving.kv_quant``,
``kv_dtype`` on the paged engine) and ``InferenceEngine.score`` against
the JAX package's, on the CPU. Mirrors ``tests/test_serving_quant.py``:

- ``TestCodec`` (``:85-174``): the port's tensor codec bit-identical to its
  numpy twins, and both bit-identical to the reference's (``quantize_rows``
  and its numpy twin) on the same inputs, ties at .5 included; int4
  packing, zero rows, the error bound, bf16 inputs, the byte arithmetic,
  the dtype check.
- The quantized engine (``:187-263``): flash and naive tokens equal within
  a dtype and equal to the JAX engine of the same ``kv_dtype``; refusals
  word for word; pool arity and bytes; int8 preempt / offload / resume
  identical to the unpreempted stream. Stored codes against the JAX
  engine's pool at the same (block, offset): equal, or one quantization
  step apart where the two frameworks' fp rows straddle a rounding
  boundary (the scales then agree within 1e-5 relative).
- ``TestScore`` (``:271-304``): greedy self-agreement, both arenas, the
  validation messages, and no perturbation of serving; log-probabilities
  within 1e-4 of the JAX engine's ``score``.

``:229`` (the quantized engine's series) and ``:321`` (the gateway's
``/v1/score`` route) run on the port in ``tests/test_torch_telemetry.py``;
the migration wire is held to v3 in ``tests/test_torch_gateway.py``
(``TestMigrationWireV2`` asserts v2 and is stale).
"""

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import kv_quant as jq
from elephas_tpu_torch.serving import InferenceEngine
from elephas_tpu_torch.serving import kv_quant as kq

VOCAB, MAXLEN = 16, 32
PROMPT = [2, 3, 4, 5, 2, 3]


@pytest.fixture(scope="module")
def pair():
    """An untrained LM in both packages from the same Keras weights (the
    within-dtype contracts are about determinism, as in the reference)."""
    ref = jax_lm(vocab_size=VOCAB, maxlen=MAXLEN, d_model=32, num_heads=2, num_layers=2,
                 dropout=0.0, seed=0)
    port = et.transformer_lm(vocab_size=VOCAB, maxlen=MAXLEN, d_model=32, num_heads=2,
                             num_layers=2, seed=0, device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in ref.weights})
    return ref, port


def make_engine(cls, model, **overrides):
    kw = dict(num_slots=2, paged=True, block_size=4, num_blocks=16, preemption=True)
    kw.update(overrides)
    return cls(model, **kw)


def greedy_tokens(eng, prompt, max_new):
    out = list(eng.run([(list(prompt), max_new)]).values())[0].tolist()
    return out[len(prompt):]


# -- the codec ------------------------------------------------------------------

def _tie_rows(seed):
    """Normal rows, and rows on a coarse grid whose quotients land on .5."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(size=(8, 2, 7)).astype(np.float32),
        (rng.integers(-10, 11, size=(8, 2, 7)) / 2.0).astype(np.float32),
        np.zeros((1, 2, 7), np.float32),
    ])


class TestCodec:
    def test_int4_pack_unpack_roundtrip(self):
        rng = np.random.default_rng(0)
        for dh in (1, 2, 7, 8, 16):  # odd widths zero-pad the tail
            q = rng.integers(-7, 8, size=(3, 5, 2, dh)).astype(np.int8)
            p = kq.pack_int4(torch.from_numpy(q))
            assert tuple(p.shape) == (3, 5, 2, kq.packed_head_dim(dh, "int4"))
            assert p.dtype == torch.int8
            np.testing.assert_array_equal(p.numpy(), np.asarray(jq.pack_int4(q)))
            np.testing.assert_array_equal(kq.unpack_int4(p, dh).numpy(), q)

    def test_all_zero_rows_roundtrip_to_exact_zeros(self):
        x = np.zeros((4, 2, 8), np.float32)
        for dt in ("int8", "int4"):
            q, s = kq.quantize_rows_np(x, dt)
            assert not s.any()
            back = kq.dequantize_rows_np(q, s, dt, 8)
            assert back.dtype == np.float32 and not back.any()
            qt, st = kq.quantize_rows(torch.from_numpy(x), dt)
            assert not kq.dequantize_rows(qt, st, dt, 8).any()

    def test_reconstruction_error_bounded(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(16, 4, 32)).astype(np.float32)
        for dt in ("int8", "int4"):
            q, s = kq.quantize_rows(torch.from_numpy(x), dt)
            back = kq.dequantize_rows(q, s, dt, 32).numpy()
            assert (np.abs(x - back) <= s.numpy()[..., None] * 0.5 + 1e-7).all(), dt

    def test_bf16_inputs(self):
        rng = np.random.default_rng(2)
        xb = torch.from_numpy(rng.normal(size=(3, 2, 16)).astype(np.float32)).bfloat16()
        q, s = kq.quantize_rows(xb, "int8")
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        back = kq.dequantize_rows(q, s, "int8", 16)
        assert (back - xb.float()).abs().max().item() < 0.05

    @pytest.mark.parametrize("dt", ["int8", "int4"])
    def test_twins_bit_identical_to_each_other_and_the_reference(self, dt):
        """The tensor codec, its numpy twin, the reference's jnp codec and
        the reference's numpy twin make the same decisions bit for bit."""
        x = _tie_rows(3)
        qt, st = kq.quantize_rows(torch.from_numpy(x), dt)
        qn, sn = kq.quantize_rows_np(x, dt)
        qj, sj = jq.quantize_rows(x, dt)
        qr, sr = jq.quantize_rows_np(x, dt)
        for q, s in ((qn, sn), (np.asarray(qj), np.asarray(sj)), (qr, sr)):
            np.testing.assert_array_equal(qt.numpy(), q)
            np.testing.assert_array_equal(st.numpy(), s)
        dt_ = kq.dequantize_rows(qt, st, dt, 7).numpy()
        np.testing.assert_array_equal(dt_, kq.dequantize_rows_np(qn, sn, dt, 7))
        np.testing.assert_array_equal(dt_, jq.dequantize_rows_np(qr, sr, dt, 7))
        np.testing.assert_array_equal(dt_, np.asarray(jq.dequantize_rows(qj, sj, dt, 7)))

    def test_byte_math(self):
        specs = [("a", 4, 32), ("b", 4, 7)]
        for dt in kq.KV_DTYPES:
            assert kq.pool_bytes_per_pos(specs, dt) == jq.pool_bytes_per_pos(specs, dt)
        assert kq.packed_head_dim(7, "int4") == 4 and kq.packed_head_dim(7, "int8") == 7
        assert kq.pool_bytes_per_pos(specs, "int4") == ((4 * 16 + 4 * 4) + (4 * 4 + 4 * 4)) * 2

    def test_kv_dtype_validation(self):
        for dt in kq.KV_DTYPES:
            assert kq.check_kv_dtype(dt) == dt
        with pytest.raises(ValueError) as t_err:
            kq.check_kv_dtype("int2")
        with pytest.raises(ValueError) as j_err:
            jq.check_kv_dtype("int2")
        assert str(t_err.value) == str(j_err.value)


# -- the quantized engine --------------------------------------------------------

def _pool_codes_match(jax_engine, engine):
    """The port's pool against the JAX engine's ``_caches`` at every (block,
    offset) of the reference's blocks: fp rows within 1e-5; codes equal,
    or one quantization step apart with scales within 1e-5 relative (fp
    rows of the two frameworks on either side of a rounding boundary)."""
    for name, want in jax_engine._caches.items():
        got = [z.numpy()[: engine.num_blocks] for z in engine.arena.caches[name]]
        want = [np.asarray(z) for z in want]
        assert len(got) == len(want)
        if len(want) == 2:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
            continue
        kq_, vq_, ks, vs = got
        for codes, scales, wc, ws in ((kq_, ks, want[0], want[2]), (vq_, vs, want[1], want[3])):
            np.testing.assert_allclose(scales, ws, rtol=1e-5, atol=1e-12)
            d = engine.arena.specs[0][2]
            a = kq.dequantize_rows_np(codes, scales, engine.kv_dtype, d)
            b = kq.dequantize_rows_np(wc, ws, engine.kv_dtype, d)
            step = np.broadcast_to(np.maximum(scales, ws)[..., None], a.shape)
            off = np.abs(a - b) > 1e-6 * np.maximum(1.0, np.abs(b))
            assert (np.abs(a - b)[off] <= step[off] * (1 + 1e-4)).all()


class TestQuantizedEngine:
    @pytest.mark.parametrize("dt", ["fp", "int8", "int4"])
    def test_flash_naive_parity_within_dtype_and_with_jax(self, pair, dt):
        """:187 — flash and naive read the same blocks: equal tokens; and
        equal to the JAX engine of the same dtype, its pool as
        `_pool_codes_match` describes (fp, the parity oracle, too)."""
        ref, port = pair
        f = make_engine(InferenceEngine, port, kv_dtype=dt)
        n = make_engine(InferenceEngine, port, kv_dtype=dt, attention="naive")
        j = make_engine(JaxEngine, ref, kv_dtype=dt)
        toks = greedy_tokens(f, PROMPT, 8)
        assert len(toks) == 8 and all(0 <= t < VOCAB for t in toks)
        assert f.stats()["kv_dtype"] == dt
        assert toks == greedy_tokens(n, PROMPT, 8) == greedy_tokens(j, PROMPT, 8)
        _pool_codes_match(j, f)

    def test_knob_refusals(self, pair):
        """:204, word for word."""
        ref, port = pair
        for kw in (dict(kv_dtype="fp8"), dict(paged=False, preemption=False,
                                              block_size=None, num_blocks=None,
                                              kv_dtype="int8")):
            with pytest.raises(ValueError) as j_err:
                make_engine(JaxEngine, ref, **kw)
            with pytest.raises(ValueError) as t_err:
                make_engine(InferenceEngine, port, **kw)
            assert str(t_err.value) == str(j_err.value)

    def test_pool_arity_and_bytes(self, pair):
        """:212 — fp pools hold (k, v), quantized ones (kq, vq, k_scale,
        v_scale); the same block count stores > 3x / > 5x fewer bytes, and
        nbytes() is the reference's figure."""
        ref, port = pair
        engines = {dt: make_engine(InferenceEngine, port, kv_dtype=dt)
                   for dt in ("fp", "int8", "int4")}
        for leaves in engines["fp"].arena.caches.values():
            assert len(leaves) == 2 and leaves[0].dtype == torch.float32
        for dt in ("int8", "int4"):
            for k_q, v_q, k_s, v_s in engines[dt].arena.caches.values():
                assert k_q.dtype == v_q.dtype == torch.int8
                assert k_s.dtype == v_s.dtype == torch.float32
            assert engines[dt].arena.nbytes() == make_engine(
                JaxEngine, ref, kv_dtype=dt).arena.nbytes()
        nb_fp = engines["fp"].arena.nbytes()
        assert nb_fp / engines["int8"].arena.nbytes() > 3.0
        assert nb_fp / engines["int4"].arena.nbytes() > 5.0

    def test_preempt_offload_resume_bit_exact_int8(self, pair):
        """:246 — a quantized request preempted to the host and resumed
        emits the unpreempted int8 stream, on the port and the reference."""
        ref, port = pair
        want = greedy_tokens(make_engine(InferenceEngine, port, kv_dtype="int8", num_blocks=64),
                             PROMPT, 16)
        streams = {}
        for cls, model in ((JaxEngine, ref), (InferenceEngine, port)):
            eng = make_engine(cls, model, kv_dtype="int8", num_blocks=10)
            low = eng.submit(PROMPT, 16, priority=0)
            eng.step()
            high = eng.submit([3, 4, 5, 2], 16, priority=5)
            while eng.scheduler.has_work:
                eng.step()
            st = eng.stats()
            assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
            assert low.done and list(low.tokens) == want
            assert st["kv_quant_offload_bytes"] > 0
            streams[cls] = (list(low.tokens), list(high.tokens), st["preemptions"],
                            st["kv_quant_offload_bytes"])
        assert streams[InferenceEngine] == streams[JaxEngine]


# -- score ------------------------------------------------------------------

class TestScore:
    def test_greedy_self_agreement_is_exact_and_matches_jax(self, pair):
        """:272, and the log-probabilities within 1e-4 of the JAX engine's."""
        ref, port = pair
        eng = make_engine(InferenceEngine, port)
        toks = greedy_tokens(eng, PROMPT, 8)
        out = eng.score(PROMPT, toks)
        assert out["agreement"] == 1.0 and out["greedy_tokens"] == toks
        assert len(out["logprobs"]) == len(toks) and all(x <= 0.0 for x in out["logprobs"])
        assert out["total_logprob"] == pytest.approx(sum(out["logprobs"]))
        want = make_engine(JaxEngine, ref).score(PROMPT, toks)
        np.testing.assert_allclose(out["logprobs"], want["logprobs"], atol=1e-4, rtol=0)
        assert out["greedy_tokens"] == want["greedy_tokens"]

    @pytest.mark.parametrize("attn", ["flash", "naive"])
    def test_score_on_fixed_arena(self, pair, attn):
        """:285."""
        _, port = pair
        eng = InferenceEngine(port, num_slots=2, attention=attn)
        toks = greedy_tokens(eng, [2, 3, 4, 5], 6)
        assert eng.score([2, 3, 4, 5], toks)["agreement"] == 1.0

    def test_score_validation(self, pair):
        """:293, word for word."""
        ref, port = pair
        ours, theirs = make_engine(InferenceEngine, port), make_engine(JaxEngine, ref)
        for args in (([], [1]), ([1], []), ([1] * MAXLEN, [1])):
            with pytest.raises(ValueError) as j_err:
                theirs.score(*args)
            with pytest.raises(ValueError) as t_err:
                ours.score(*args)
            assert str(t_err.value) == str(j_err.value)

    def test_score_does_not_perturb_serving(self, pair):
        """:304 — interleaved score() calls leave a request's tokens, the
        blocks and the cursors as they were."""
        _, port = pair
        want = greedy_tokens(make_engine(InferenceEngine, port), PROMPT, 8)
        eng = make_engine(InferenceEngine, port)
        req = eng.submit(PROMPT, 8)
        while eng.scheduler.has_work:
            free = eng.scheduler.allocator.free_count
            eng.step()
            eng.score([5, 4, 3], [2, 2])
            assert eng.scheduler.allocator.free_count >= free - 4
        assert list(req.tokens) == want
        assert eng.stats()["score_requests"] >= 5
        assert eng.stats()["blocks_free"] == eng.num_blocks
