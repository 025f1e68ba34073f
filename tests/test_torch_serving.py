"""The port's serving slice (``elephas_tpu_torch.serving``, cached
``generate``) against the JAX package's, on the CPU.

- ``prefill_forward`` / ``token_decode_step`` logits and arena rows
  against the JAX graph replays on the same Keras weights, rope on and off
  (within 1e-5: the same math in another summation order).
- ``InferenceEngine`` token-exact at temperature 0 with the JAX
  ``InferenceEngine`` and the JAX ``generate(kv_cache=True)`` on the
  shared ``serving_lm`` fixture (the trained periodic toy), and the engine's
  behaviour as ``tests/test_serving.py`` pins it for the reference:
  mid-flight admission and reclamation, EOS, a raising ``on_token``,
  ``stream()``'s done flag, seeded sampling; and its errors, word for
  word.

Prompts and tokens are numpy arrays made from a seed; weights cross as
``{v.path: np.asarray(v)}`` through ``load_keras_weights``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.models import generate as jax_generate
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.models.transformer import validate_token_decode_model as jax_validate
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving.kv_cache import SlotKVCache as JaxSlotKVCache
from elephas_tpu.serving.kv_cache import prefill_forward as jax_prefill_forward
from elephas_tpu.serving.kv_cache import token_decode_step as jax_token_decode_step
from elephas_tpu_torch import InferenceEngine, RequestCancelled
from elephas_tpu_torch.models.transformer import validate_token_decode_model
from elephas_tpu_torch.serving.kv_cache import SlotKVCache, prefill_forward, token_decode_step

TOL = 1e-5
MIXED_PROMPTS = [
    [2, 3, 4, 5],
    [4, 5],
    [3, 4, 5, 2, 3, 4, 5, 2],
    [5, 2, 3],
    [2, 3, 4, 5, 2, 3],
]
STEPS = 8


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


@pytest.fixture(scope="module")
def lm(serving_lm):
    """The port's LM on the trained ``serving_lm`` weights (CPU)."""
    port = et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2,
                             num_layers=2, device="cpu")
    et.load_keras_weights(port, _keras_weights(serving_lm))
    return port


@pytest.fixture(scope="module")
def jax_cached(serving_lm):
    """The JAX ``generate(kv_cache=True)`` continuation of each mixed
    prompt, ``STEPS`` tokens."""
    return {
        tuple(p): jax_generate(serving_lm, np.asarray(p, np.int32)[None], STEPS,
                               kv_cache=True)[0]
        for p in MIXED_PROMPTS
    }


def _cached(lm, prompt, steps):
    return et.generate(lm, np.asarray(prompt, np.int32)[None], steps, kv_cache=True)[0]


# -- the arena passes against the JAX graph replays ----------------------

@pytest.mark.parametrize("attention", ["flash", "naive"])
@pytest.mark.parametrize("rope", [False, True])
def test_prefill_and_decode_steps_match_jax(rope, attention):
    """A wave of ragged prompts into 3 of 4 slots, then three decode steps
    at per-slot positions over a span below maxlen: logits of the admitted
    and active slots, and their arena rows, against the JAX passes."""
    maxlen, slots, bucket = 64, 4, 16
    cfg = dict(vocab_size=61, maxlen=maxlen, d_model=64, num_heads=2, num_layers=2,
               rope=rope, seed=3)
    ref = jax_lm(**cfg)
    port = et.transformer_lm(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 61, (slots, bucket)).astype(np.int32)
    p_lens = np.array([5, 1, 16, 9], np.int32)
    admit = np.array([True, False, True, True])

    layers, _, _ = jax_validate(ref)
    j_caches = JaxSlotKVCache(layers, slots, maxlen).init()
    w = {v.path: v.value for v in ref.variables}
    span = 32 if attention == "flash" else None
    # jitted as the JAX engine runs them
    j_prefill = jax.jit(lambda w, rows, caches, admit: jax_prefill_forward(
        ref, w, rows, caches, admit, maxlen, attention=attention))
    j_decode = jax.jit(lambda w, tok, positions, caches, active: jax_token_decode_step(
        ref, w, tok, positions, caches, maxlen, active=active, attention=attention,
        span=span))
    j_logits, j_caches = j_prefill(w, rows, j_caches, admit)
    cache = SlotKVCache(validate_token_decode_model(port), slots, maxlen, "cpu")
    idx = np.flatnonzero(admit)
    with torch.inference_mode():
        logits = prefill_forward(port, torch.from_numpy(rows[idx]).long(), cache,
                                 torch.from_numpy(idx), attention)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits)[idx], atol=TOL, rtol=0)

    positions = p_lens.copy()
    for step in range(3):
        tok = rng.integers(0, 61, slots).astype(np.int32)
        j_logits, j_caches = j_decode(w, tok, positions, j_caches, admit)
        with torch.inference_mode():
            logits = token_decode_step(
                port, torch.from_numpy(tok).long(), torch.from_numpy(positions), cache,
                torch.from_numpy(admit), attention, span)
        np.testing.assert_allclose(logits.numpy()[idx], np.asarray(j_logits)[idx],
                                   atol=TOL, rtol=0)
        positions = positions + admit
    for name, (k, v) in cache.caches.items():
        jk, jv = (np.asarray(a) for a in j_caches[name])
        np.testing.assert_allclose(k.numpy()[idx], jk[idx], atol=TOL, rtol=0)
        np.testing.assert_allclose(v.numpy()[idx], jv[idx], atol=TOL, rtol=0)
    # the idle slot's rows were never written
    assert all(not k[1].any() and not v[1].any() for k, v in cache.caches.values())


# -- cached generate -----------------------------------------------------

def test_cached_generate_matches_jax(serving_lm, lm):
    rng = np.random.default_rng(7)
    starts = rng.integers(2, 6, size=4)
    prompt = ((starts[:, None] + np.arange(6)) % 4 + 2).astype(np.int32)
    want = jax_generate(serving_lm, prompt, 16, kv_cache=True)
    got = et.generate(lm, prompt, 16, kv_cache=True)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, et.generate(lm, prompt, 16))
    # top_k=1 leaves one token: sampling reproduces greedy
    np.testing.assert_array_equal(
        et.generate(lm, prompt, 16, temperature=0.7, top_k=1, seed=5, kv_cache=True), want)


@pytest.mark.parametrize("rope", [False, True])
def test_cached_generate_matches_recompute_on_random_weights(rope):
    cfg = dict(vocab_size=50, maxlen=64, d_model=64, num_heads=2, num_layers=2, rope=rope,
               seed=2)
    port = et.transformer_lm(**cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, 50, (3, 9))
    np.testing.assert_array_equal(et.generate(port, prompt, 20, kv_cache=True),
                                  et.generate(port, prompt, 20))


def test_cached_generate_refuses_what_jax_refuses():
    cfg = dict(vocab_size=8, maxlen=16, num_classes=2, d_model=32, num_heads=2, num_layers=1)
    prompt = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError) as j_err:
        jax_generate(jax_classifier(**cfg), prompt, 4, kv_cache=True)
    with pytest.raises(ValueError) as t_err:
        et.generate(et.transformer_classifier(**cfg, device="cpu"), prompt, 4, kv_cache=True)
    assert str(t_err.value) == str(j_err.value)
    port = et.transformer_lm(vocab_size=8, maxlen=16, d_model=32, num_heads=2, num_layers=1,
                             device="cpu")
    port.blocks[0].attn.causal = False
    with pytest.raises(ValueError, match="'blk0_attn' has causal=False; use kv_cache=False"):
        et.generate(port, prompt, 4, kv_cache=True)


# -- the engine ------------------------------------------------------------

@pytest.mark.parametrize("attention", ["flash", "naive"])
@pytest.mark.parametrize("steps_per_sync", [1, 4])
def test_engine_matches_jax_engine_and_cached_generate(serving_lm, lm, jax_cached,
                                                        steps_per_sync, attention):
    """Token-exact greedy parity on the mixed-length prompt set: the port's
    engine against the JAX engine (same options) and the JAX
    ``generate(kv_cache=True)``."""
    jax_engine = JaxEngine(serving_lm, num_slots=4, steps_per_sync=steps_per_sync,
                           attention=attention)
    j_reqs = [jax_engine.submit(p, max_new_tokens=STEPS) for p in MIXED_PROMPTS]
    j_out = jax_engine.run()
    engine = InferenceEngine(lm, num_slots=4, steps_per_sync=steps_per_sync,
                             attention=attention)
    reqs = [engine.submit(p, max_new_tokens=STEPS) for p in MIXED_PROMPTS]
    out = engine.run()
    for req, j_req, p in zip(reqs, j_reqs, MIXED_PROMPTS):
        np.testing.assert_array_equal(out[req.rid], j_out[j_req.rid])
        np.testing.assert_array_equal(out[req.rid], jax_cached[tuple(p)])
    assert engine.stats()["total_generated"] == jax_engine.stats()["total_generated"]


def test_slot_reclamation_and_midflight_admission(lm, jax_cached):
    """More requests than slots: finished slots reclaim at once and waiting
    requests admit mid-flight; one submitted while the engine streams
    joins the next wave. Every output stays token-exact."""
    engine = InferenceEngine(lm, num_slots=2)
    reqs = [engine.submit(p, max_new_tokens=STEPS) for p in MIXED_PROMPTS]
    late = None
    for i, _ in enumerate(engine.stream()):
        if i == 3:
            late = engine.submit([3, 4, 5], max_new_tokens=5)
    assert late is not None and late.done
    assert len(engine.finished) == len(MIXED_PROMPTS) + 1
    assert sorted(engine.scheduler._free) == list(range(engine.num_slots))
    assert not engine.scheduler.active and not engine.scheduler.waiting
    for req, p in zip(reqs, MIXED_PROMPTS):
        np.testing.assert_array_equal(req.full_sequence, jax_cached[tuple(p)])
    np.testing.assert_array_equal(late.full_sequence, _cached(lm, [3, 4, 5], 5))


def test_three_waves_reuse_the_arena(lm):
    """Three waves of mixed workloads through one engine: every slot comes
    back after each, and every output equals cached generate."""
    engine = InferenceEngine(lm, num_slots=4)
    waves = [
        [([2, 3], 4), ([4, 5, 2, 3, 4], 6)],
        [([3, 4, 5], 9), ([2, 3, 4, 5, 2, 3, 4], 3), ([5, 5], 5)],
        [([4, 3, 2], 7)],
    ]
    for wave in waves:
        out = engine.run(wave)
        assert len(out) == len(wave)
        for (prompt, steps), rid in zip(wave, sorted(out)):
            np.testing.assert_array_equal(out[rid], _cached(lm, prompt, steps))
        assert sorted(engine.scheduler._free) == list(range(4))


def test_raising_token_callback_reclaims_slot_and_engine_survives(lm):
    engine = InferenceEngine(lm, num_slots=2)

    def dying_consumer(token, done):
        raise RuntimeError("downstream consumer died")

    seen = []
    bad = engine.submit(MIXED_PROMPTS[0], max_new_tokens=6, on_token=dying_consumer)
    good = engine.submit(MIXED_PROMPTS[1], max_new_tokens=6,
                         on_token=lambda tok, done: seen.append(tok))
    engine.run()
    assert isinstance(bad.error, RuntimeError) and bad.done
    assert len(bad.tokens) == 1
    assert good.done and good.error is None and len(seen) == 6
    np.testing.assert_array_equal(good.full_sequence, _cached(lm, MIXED_PROMPTS[1], 6))
    assert sorted(engine.scheduler._free) == list(range(engine.num_slots))
    assert not engine.scheduler.active
    reqs = [engine.submit(p, max_new_tokens=4) for p in MIXED_PROMPTS[:2]]
    out = engine.run()
    assert all(r.rid in out and r.error is None for r in reqs)


def test_eos_reclaims_early(lm):
    ref = _cached(lm, [2, 3, 4], 10)
    continuation = ref[3:]
    eos = int(continuation[4])
    stop_at = int(np.argmax(continuation == eos)) + 1
    engine = InferenceEngine(lm, num_slots=1)
    r1 = engine.submit([2, 3, 4], max_new_tokens=10, eos_id=eos)
    r2 = engine.submit([4, 5], max_new_tokens=4)  # waits for the slot
    out = engine.run()
    np.testing.assert_array_equal(out[r1.rid], ref[: 3 + stop_at])
    np.testing.assert_array_equal(out[r2.rid], _cached(lm, [4, 5], 4))


def test_temperature_sampling_is_deterministic_per_seed(lm):
    """temp > 0 rides the same engine; a fresh engine with the same seed
    repeats the tokens, another seed draws others, and the greedy request
    is unaffected by its sampled neighbour."""
    def run_once(seed):
        engine = InferenceEngine(lm, num_slots=2, seed=seed)
        r_greedy = engine.submit([2, 3, 4], 12)
        r_hot = engine.submit([4, 5], 12, temperature=5.0)
        out = engine.run()
        return out[r_greedy.rid], out[r_hot.rid]

    g1, h1 = run_once(7)
    g2, h2 = run_once(7)
    g3, h3 = run_once(8)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(h1, h2)
    assert not np.array_equal(h1, h3)
    for g in (g1, g3):
        np.testing.assert_array_equal(g, _cached(lm, [2, 3, 4], 12))


def test_stream_done_flag_marks_only_final_token(lm):
    engine = InferenceEngine(lm, num_slots=2, steps_per_sync=4)
    r = engine.submit([2, 3, 4], max_new_tokens=3)
    got = [(tok, done) for rid, tok, done in engine.stream() if rid == r.rid]
    assert [d for _t, d in got] == [False, False, True], got
    np.testing.assert_array_equal([t for t, _d in got], r.tokens)


def test_cancel_frees_the_slot_and_ends_the_stream(lm):
    engine = InferenceEngine(lm, num_slots=1)
    ends = []
    active = engine.submit([2, 3, 4], 20, on_token=lambda tok, done: ends.append((tok, done)))
    waiting = engine.submit([4, 5], 4)
    engine.step()
    assert active.slot == 0 and not active.done
    assert engine.cancel(waiting.rid) and engine.cancel(active.rid)
    assert not engine.cancel(active.rid) and not engine.cancel(12345)
    assert isinstance(active.error, RequestCancelled) and active.done
    assert isinstance(waiting.error, RequestCancelled) and not waiting.tokens
    assert ends[-1] == (None, True)
    assert engine.scheduler._free == [0] and not engine.scheduler.has_work
    r = engine.submit([5, 2, 3], 5)
    engine.run()
    np.testing.assert_array_equal(r.full_sequence, _cached(lm, [5, 2, 3], 5))
    assert engine.stats()["cancelled"] == 2


def test_stats_count_tokens_and_latencies(lm):
    engine = InferenceEngine(lm, num_slots=2, steps_per_sync=2)
    with engine:
        engine.run([(p, 5) for p in MIXED_PROMPTS])
    stats = engine.stats()
    assert stats["total_generated"] == 5 * len(MIXED_PROMPTS)
    assert stats["finished"] == len(MIXED_PROMPTS) and stats["queue_depth"] == 0
    assert stats["ttft_s"]["n"] == len(MIXED_PROMPTS)
    assert stats["inter_token_s"]["n"] == 4 * len(MIXED_PROMPTS)
    assert 0 < stats["occupancy"] <= 1 and stats["attention"] == "flash"
    assert stats["ttft_s"]["p50"] <= stats["ttft_s"]["p99"]


def test_spark_model_serve(lm):
    sm = et.SparkModel(lm, device="cpu")
    engine = sm.serve(num_slots=2, steps_per_sync=2)
    assert isinstance(engine, InferenceEngine) and engine.device == torch.device("cpu")
    r = engine.submit([2, 3, 4, 5], 6)
    engine.run()
    np.testing.assert_array_equal(r.full_sequence, _cached(lm, [2, 3, 4, 5], 6))
    # the gateway is ported since (tests/test_torch_gateway.py): serve()
    # binds one, and leaving the engine's with block stops it
    with sm.serve(num_slots=2, gateway_port=0) as served:
        assert served.gateway is not None and served.gateway.port
    assert served.gateway is None


# -- errors, word for word ------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(top_k=0), dict(top_k=9), dict(top_p=0.0), dict(top_p=1.5), dict(num_slots=0),
    dict(buckets=(8, 64)), dict(attention="fused"),
])
def test_constructor_errors_match_jax(serving_lm, lm, kwargs):
    with pytest.raises(ValueError) as j_err:
        JaxEngine(serving_lm, **kwargs)
    with pytest.raises(ValueError) as t_err:
        InferenceEngine(lm, **kwargs)
    assert str(t_err.value) == str(j_err.value)


def test_engine_refuses_what_jax_refuses():
    cfg = dict(vocab_size=8, maxlen=16, num_classes=2, d_model=32, num_heads=2, num_layers=1)
    with pytest.raises(ValueError) as j_err:
        JaxEngine(jax_classifier(**cfg))
    with pytest.raises(ValueError) as t_err:
        InferenceEngine(et.transformer_classifier(**cfg, device="cpu"))
    assert str(t_err.value) == str(j_err.value)


@pytest.fixture(scope="module")
def engine_pair(serving_lm, lm):
    """A JAX and a port engine with a bucket ladder below maxlen."""
    return JaxEngine(serving_lm, num_slots=2, buckets=(8, 16)), \
        InferenceEngine(lm, num_slots=2, buckets=(8, 16))


@pytest.mark.parametrize("args,kwargs", [
    (([], 4), {}),
    (([2, 3], 0), {}),
    (([2] * 30, 3), {}),
    (([2, 3], 4), dict(temperature=-1.0)),
    (([2] * 20, 4), {}),
    (([2, 3], 4), dict(tenant="prod")),
    (([2, 3], 4), dict(ttft_deadline_ms=0)),
    (([2, 3], 4), dict(ttft_deadline_ms=500.0)),
])
def test_submit_errors_match_jax(engine_pair, args, kwargs):
    jax_engine, engine = engine_pair
    with pytest.raises(ValueError) as j_err:
        jax_engine.submit(*args, **kwargs)
    with pytest.raises(ValueError) as t_err:
        engine.submit(*args, **kwargs)
    assert str(t_err.value) == str(j_err.value)
    assert not engine.scheduler.waiting


# speculative decoding, policies (tests/test_torch_spec.py,
# tests/test_torch_policy.py) and the flight recorder (tests/test_torch_telemetry.py)
# are ported since: their cases now name other keywords the port still refuses
@pytest.mark.parametrize("kwargs", [
    dict(batch_axes=("data", "seq")), dict(rules={"qkv": "col"}), dict(batch_axes=("workers",)),
    dict(sp_threshold=16), dict(model_axis="model"), dict(sp_axis="ring"),
    dict(sp_mechanism="ulysses"), dict(sp_prefill="seq"), dict(mesh="mesh"),
])
def test_unported_engine_options_raise(lm, kwargs):
    """The decode meshes are still to port (item 5); the sequence-parallel
    prefill's knobs are ported (tests/test_torch_sp_prefill.py) and raise
    the reference's ValueError here: without ``sp_prefill`` they are
    refused, and ``sp_prefill`` needs the paged arena."""
    if any(name.startswith("sp_") for name in kwargs):
        with pytest.raises(ValueError) as t_err:
            InferenceEngine(lm, **kwargs)
        with pytest.raises(ValueError) as j_err:
            JaxEngine(_jax_lm(), **kwargs)
        assert str(t_err.value) == str(j_err.value)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue A item"):
        InferenceEngine(lm, **kwargs)


@functools.cache
def _jax_lm():
    """An untrained JAX LM of ``lm``'s widths: the refusals read only its
    shape."""
    return jax_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2)


def test_engine_runs_on_the_models_device(lm):
    with pytest.raises(ValueError, match="cuda or cpu"):
        InferenceEngine(lm, device="meta")
    assert InferenceEngine(lm, device="cpu").device == torch.device("cpu")


# -- every reference keyword: accepted where it changes nothing or is ported,
# else refused by name ------------------------------------------------------

# (entry point, keyword, the value that leaves the behaviour unchanged,
# another value, the ROADMAP.md Queue A item that ports it)
REFERENCE_KEYWORDS = [
    ("engine", "mesh", None, "mesh", 5),
    ("engine", "batch_axes", ("data",), ("data", "seq"), 5),
    ("engine", "model_axis", None, "model", 5),
    ("engine", "rules", None, {"qkv": "col"}, 5),
    ("engine", "prefix_cache", False, True, 1),
    ("engine", "prefix_min_reuse", 1, 8, 1),
    ("engine", "prefill_chunk", None, 4, 1),
    ("engine", "prefill_budget", None, 64, 1),
    ("engine", "paged", False, True, "3a"),
    ("engine", "block_size", None, 16, "3a"),
    ("engine", "num_blocks", None, 64, "3a"),
    ("engine", "preemption", False, True, "3a"),
    ("engine", "kv_dtype", "fp", "int8", "3a"),
    ("engine", "speculative", False, True, 3),
    ("engine", "spec_k", None, 3, 3),
    ("engine", "spec_drafter", None, "lookup", 3),
    ("engine", "policy", None, "fair", 3),
    ("engine", "flight_recorder", None, 256, 3),
    ("engine", "sp_prefill", None, "seq", "5b"),
    ("engine", "sp_axis", "seq", "ring", "5b"),
    ("engine", "sp_threshold", None, 16, "5b"),
    ("engine", "sp_mechanism", "ring", "ulysses", "5b"),
    ("generate", "mesh", None, "mesh", 5),
    ("generate", "batch_axes", ("data",), ("workers",), 5),
    ("generate", "model_axis", None, "model", 5),
    ("generate", "rules", None, {"qkv": "col"}, 5),
    ("serve", "tenants", None, {"prod": 1.0}, 3),
    ("serve", "gateway_port", None, 0, 3),
    ("serve", "gateway_host", "127.0.0.1", "0.0.0.0", 3),
    ("serve", "flight_recorder", None, 256, 3),
    ("serve", "prefill_budget", None, 64, 1),
    ("serve", "block_size", None, 16, "3a"),
]


@pytest.fixture(scope="module")
def small_lm():
    return et.transformer_lm(vocab_size=8, maxlen=16, d_model=32, num_heads=2, num_layers=1,
                             device="cpu")


def _call(where, model, **kwargs):
    if where == "engine":
        return InferenceEngine(model, **kwargs)
    if where == "generate":
        return et.generate(model, np.array([[2, 3, 4]], np.int32), 2, **kwargs)
    return et.SparkModel(model, device="cpu").serve(**kwargs)


# Queue A items ported since: their keywords take the other value too (a
# budget with the chunk it needs, the paged arena's knobs with paged=True).
# "3a" is the storage half of item 3: the paged arena, preemption, int8 /
# int4 KV
PORTED_ITEMS = {1, "3a"}
# item 3's keywords ported since: 3b (speculative decoding), 3c (SLO
# policies), telemetry's flight recorder and the gateway; the other value of
# the two the reference itself refuses raises the reference's error
PORTED_KEYWORDS = {"speculative", "spec_k", "spec_drafter", "policy", "tenants",
                   "flight_recorder", "gateway_port", "gateway_host"}
# item 5b (the sequence-parallel prefill) is ported: its other values
# alone raise the reference's own errors (an SP mesh needs the paged arena,
# the other knobs need an SP mesh; tests/test_torch_sp_prefill.py)
REFUSED = {"spec_drafter": (ValueError, "is not a drafter"),
           "policy": (TypeError, "policy must be a serving.policy.Policy"),
           "sp_prefill": (ValueError, "sp_prefill requires paged=True"),
           **{name: (ValueError, "require sp_prefill=")
              for name in ("sp_axis", "sp_threshold", "sp_mechanism")}}
NEEDS = {"prefill_budget": {"prefill_chunk": 4}, "spec_k": {"speculative": True},
         "spec_drafter": {"speculative": True},
         **{name: {"paged": True} for name in ("block_size", "num_blocks", "preemption",
                                               "kv_dtype")}}


@pytest.mark.parametrize("where,name,neutral,other,item", REFERENCE_KEYWORDS)
def test_reference_keywords_pass_or_name_their_item(small_lm, where, name, neutral, other,
                                                    item):
    _call(where, small_lm, **{name: neutral})
    if name in REFUSED:
        with pytest.raises(REFUSED[name][0], match=REFUSED[name][1]):
            _call(where, small_lm, **{name: other}, **NEEDS.get(name, {}))
        return
    if item in PORTED_ITEMS or name in PORTED_KEYWORDS:
        built = _call(where, small_lm, **{name: other}, **NEEDS.get(name, {}))
        if isinstance(built, InferenceEngine):
            built.close()  # a gateway_port engine serves until closed
        return
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md, Queue A item {item}\b"):
        _call(where, small_lm, **{name: other})


def test_reference_keyword_table_covers_every_reference_keyword():
    """The table above names every keyword of the reference's engine,
    generate and SparkModel.serve that the port does not otherwise take
    (the port's own, such as ``top_k``, are exercised elsewhere), and the
    port's signatures take each of them."""
    import inspect

    from elephas_tpu.spark_model import SparkModel as JaxSparkModel

    own = {"self", "model", "num_slots", "top_k", "top_p", "seed", "buckets",
           "steps_per_sync", "attention", "prompt", "steps", "temperature", "kv_cache"}
    refs = {"engine": JaxEngine.__init__, "generate": jax_generate,
            "serve": JaxSparkModel.serve}
    ports = {"engine": InferenceEngine.__init__, "generate": et.generate,
             "serve": et.SparkModel.serve}
    for where, ref in refs.items():
        keywords = set(inspect.signature(ref).parameters) - own
        table = {n for w, n, *_ in REFERENCE_KEYWORDS if w == where}
        assert table <= keywords, table - keywords
        port = inspect.signature(ports[where]).parameters
        if where == "serve":  # engine keywords pass through **engine_options
            keywords -= set(inspect.signature(JaxEngine.__init__).parameters)
            assert "engine_options" in port
        assert keywords <= set(port), keywords - set(port)
        assert keywords <= table, keywords - table


def test_serve_passes_engine_keywords_through(small_lm):
    """SparkModel.serve hands the reference's engine keywords to the
    engine: neutral values build an engine, the others raise there."""
    sm = et.SparkModel(small_lm, device="cpu")
    engine = sm.serve(num_slots=2, prefix_min_reuse=1, sp_axis="seq", flight_recorder=None)
    assert isinstance(engine, InferenceEngine)
    engine = sm.serve(num_slots=2, prefix_cache=True, prefix_min_reuse=4, prefill_chunk=4,
                      prefill_budget=8)
    assert engine.scheduler.prefix_min_reuse == 4 and engine.prefill_chunk == 4
    engine = sm.serve(num_slots=2, paged=True, block_size=8, num_blocks=12, preemption=True,
                      kv_dtype="int8")
    assert (engine.paged, engine.block_size, engine.num_blocks, engine.preemption,
            engine.kv_dtype) == (True, 8, 12, True, "int8")
    engine = sm.serve(num_slots=2, speculative=True, spec_k=3, spec_drafter="ngram")
    assert (engine.speculative, engine.spec_k) == (True, 3)
    engine = sm.serve(num_slots=2, flight_recorder=16)
    assert engine._flight.capacity == 16
    with pytest.raises(ValueError, match="sp_prefill requires paged=True"):
        sm.serve(sp_prefill="seq")
