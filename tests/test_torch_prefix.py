"""The port's prefix cache, chunked prefill and verify pass
(``elephas_tpu_torch.serving``) against the JAX package's, on the CPU.

- ``PrefixCache`` in the cases of ``tests/test_serving_prefix.py::
  TestPrefixCacheIndex``, and op for op against the reference's index on a
  random sequence of inserts, releases, lookups, hits, pins and evictions.
- ``chunked_prefill_forward`` and ``verify_forward`` logits within 1e-5 and
  arena rows within 2e-6 of the JAX passes on the same Keras weights (the
  same math in another summation order: the rows of the second layer read
  the first layer's attention, and their largest difference over these
  inputs is 1.6e-6, 16 ulps at their scale, with rope), rope
  on and off, flash and naive, over every slot or some slots (the port
  computes only those); ``prefix_copy`` bit-exact.
- The engine with ``prefix_cache``, ``prefix_min_reuse``,
  ``prefill_chunk`` and ``prefill_budget`` token-exact at temperature 0
  with the JAX engine in the scenarios of ``tests/test_serving_prefix.py``
  (each scenario runs on both engines and every observable is compared:
  tokens, reuse lengths, cache counters, chunk progress), and those
  scenarios' own claims checked on the port.
"""

import jax
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.models import generate as jax_generate
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.models.transformer import validate_token_decode_model as jax_validate
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import PrefixCache as JaxPrefixCache
from elephas_tpu.serving.kv_cache import SlotKVCache as JaxSlotKVCache
from elephas_tpu.serving.kv_cache import chunked_prefill_forward as jax_chunked
from elephas_tpu.serving.kv_cache import prefix_copy as jax_prefix_copy
from elephas_tpu.serving.kv_cache import verify_forward as jax_verify
from elephas_tpu_torch.models.transformer import validate_token_decode_model
from elephas_tpu_torch.serving import InferenceEngine, PrefixCache
from elephas_tpu_torch.serving.kv_cache import (
    SlotKVCache,
    chunked_prefill_forward,
    prefix_copy,
    verify_forward,
)
from tests.test_torch_serving import _keras_weights, lm  # noqa: F401  (lm: fixture)

TOL_LOGITS = 1e-5
TOL_ROWS = 2e-6
SHARED = [2, 3, 4, 5, 2, 3, 4, 5]  # the "system prompt"
LONG_A = SHARED + SHARED + [2, 3, 4]  # 19 tokens
LONG_B = SHARED + SHARED + [5, 4]  # 18 tokens


# -- the index ----------------------------------------------------------------

def test_longest_prefix_match_caps_below_prompt():
    c = PrefixCache()
    c.insert(0, [1, 2, 3, 4])
    assert c.match([1, 2, 3, 4]) == (0, 3)
    assert c.match([1, 2, 9, 9, 9]) == (0, 2)
    assert c.match([7, 8, 9]) == (None, 0)


def test_match_is_pure_counters_commit_only_on_admission():
    c = PrefixCache()
    c.insert(0, [1, 2, 3])
    for _ in range(5):
        assert c.match([1, 2, 9]) == (0, 2)
    assert c.stats()["hits"] == 0 and c.stats()["misses"] == 0
    c.commit_hit(0, 2)
    c.record_miss()
    st = c.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["reused_tokens"] == 2


def test_match_prefers_most_recent_then_slot_id():
    c = PrefixCache()
    c.insert(0, [1, 2, 3])
    c.insert(1, [1, 2, 3])
    assert c.match([1, 2, 9])[0] == 1
    c.commit_hit(0, 2)
    assert c.match([1, 2, 9])[0] == 0


def test_eviction_skips_leased_and_pinned():
    c = PrefixCache()
    c.insert(0, [1, 2])
    c.insert(1, [3, 4])
    assert c.evict_lru() is None
    c.release(0)
    c.release(1)
    c.pin(0)
    assert c.evict_lru() == 1
    c.unpin(0)
    assert c.evict_lru() == 0
    assert c.evict_lru() is None
    assert c.stats()["entries"] == 0


def test_remove_prunes_trie():
    c = PrefixCache()
    c.insert(0, [1, 2, 3])
    c.remove(0)
    assert not c._root.children
    assert c.match([1, 2, 3, 4]) == (None, 0)


def test_deterministic_logical_clock():
    def drive(c):
        out = []
        c.insert(0, [1, 2, 3]); c.release(0)  # noqa: E702
        c.insert(1, [1, 2, 4]); c.release(1)  # noqa: E702
        s, m = c.match([1, 2, 4, 7])
        c.commit_hit(s, m)
        out.append((s, m))
        out.append(c.evict_lru())
        out.append(c.evict_lru())
        return out

    assert drive(PrefixCache()) == drive(PrefixCache()) == drive(JaxPrefixCache())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_matches_the_reference_op_for_op(seed):
    """400 random operations on both indexes over 6 slots and a 3-token
    alphabet (deep shared prefixes): every return value, every entry and
    the counters agree."""
    rng = np.random.default_rng(seed)
    ours, theirs = PrefixCache(), JaxPrefixCache()
    for _ in range(400):
        op = rng.integers(8)
        slot = int(rng.integers(6))
        tokens = [int(t) for t in rng.integers(0, 3, rng.integers(1, 9))]
        if op == 0:
            calls = [("insert", slot, tokens)]
        elif op == 1:
            calls = [("release", slot)]
        elif op == 2:
            calls = [("remove", slot)]
        elif op == 3:
            calls = [("match", tokens, int(rng.integers(1, 8)) if rng.random() < .3 else None)]
        elif op == 4:
            hit = theirs.match(tokens)
            calls = [("commit_hit", *hit)] if hit[0] is not None else [("record_miss",)]
        elif op == 5:
            calls = [("pin", slot)] if theirs.entry(slot) is not None else [("unpin", slot)]
        elif op == 6:
            calls = [("evict_lru",)]
        else:
            calls = [("flush",)] if rng.random() < 0.05 else [("match_len", tokens)]
        for name, *args in calls:
            assert getattr(ours, name)(*args) == getattr(theirs, name)(*args), (name, args)
        assert ours.stats() == theirs.stats()
        assert ours.donor_slots == theirs.donor_slots
        for s in range(6):
            a, b = ours.entry(s), theirs.entry(s)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.slot, a.tokens, a.length, a.last_use, a.leased, a.pins) == \
                    (b.slot, b.tokens, b.length, b.last_use, b.leased, b.pins)


# -- the arena passes against the JAX graph replays ----------------------

@pytest.mark.parametrize("attention", ["flash", "naive"])
@pytest.mark.parametrize("rope", [False, True])
def test_chunk_and_verify_passes_match_jax(rope, attention):
    """Three slots of four: two chunks of ragged lengths from per-slot
    offsets (the second resuming where the first stopped, one slot
    inactive in it), then a verify window; logits of the active rows and
    the arena rows of every slot against the JAX passes, the port run once
    over every slot and once over the active slots alone."""
    maxlen, slots, c = 64, 4, 8
    cfg = dict(vocab_size=61, maxlen=maxlen, d_model=64, num_heads=2, num_layers=2,
               rope=rope, seed=3)
    ref = jax_lm(**cfg)
    port = et.transformer_lm(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    rng = np.random.default_rng(5)
    w = {v.path: v.value for v in ref.variables}
    layers, _, _ = jax_validate(ref)
    j_caches = JaxSlotKVCache(layers, slots, maxlen).init()
    chunk = jax.jit(lambda w, toks, caches, offs, lens, act: jax_chunked(
        ref, w, toks, caches, offs, lens, act, maxlen, attention=attention, span=32))
    verify = jax.jit(lambda w, toks, caches, offs, lens, act: jax_verify(
        ref, w, toks, caches, offs, lens, act, maxlen, attention=attention, span=32))
    calls = [  # (pass, offsets, lengths, active)
        ("chunk", [0, 0, 0, 0], [8, 5, 0, 3], [True, True, False, True]),
        ("chunk", [8, 5, 0, 3], [6, 8, 0, 0], [True, True, False, False]),
        ("verify", [14, 13, 0, 3], [4, 2, 0, 3], [True, True, False, True]),
    ]
    caches = {sub: SlotKVCache(validate_token_decode_model(port), slots, maxlen, "cpu")
              for sub in ("all", "some")}
    for kind, offs, lens, act in calls:
        toks = rng.integers(0, 61, (slots, c)).astype(np.int32)
        offs, lens, act = (np.asarray(a) for a in (offs, lens, act))
        offs, lens = offs.astype(np.int32), lens.astype(np.int32)
        fn_j, fn = (chunk, chunked_prefill_forward) if kind == "chunk" else \
            (verify, verify_forward)
        j_logits, j_caches = fn_j(w, toks, j_caches, offs, lens, act)
        idx = np.flatnonzero(act)
        with torch.inference_mode():
            t = {k: torch.from_numpy(a) for k, a in
                 dict(toks=toks.astype(np.int64), offs=offs, lens=lens, act=act).items()}
            every = fn(port, t["toks"], caches["all"], t["offs"], t["lens"], t["act"],
                       attention, 32)
            sub = torch.from_numpy(idx)
            some = fn(port, t["toks"][sub], caches["some"], t["offs"][sub], t["lens"][sub],
                      None, attention, 32, slots=sub)
        want = np.asarray(j_logits)
        for i in idx:  # the real rows of each active slot
            n = lens[i]
            np.testing.assert_allclose(every.numpy()[i, :n], want[i, :n], atol=TOL_LOGITS, rtol=0)
            j = int(np.flatnonzero(idx == i)[0])
            np.testing.assert_allclose(some.numpy()[j, :n], want[i, :n], atol=TOL_LOGITS, rtol=0)
        for name in j_caches:
            for got_cache in caches.values():
                for got, jw in zip(got_cache.caches[name], j_caches[name]):
                    np.testing.assert_allclose(got.numpy(), np.asarray(jw), atol=TOL_ROWS, rtol=0)


def test_prefix_copy_is_bit_exact():
    slots, maxlen = 5, 16
    rng = np.random.default_rng(2)
    port = et.transformer_lm(vocab_size=8, maxlen=maxlen, d_model=32, num_heads=2,
                             num_layers=2, device="cpu")
    cache = SlotKVCache(validate_token_decode_model(port), slots, maxlen, "cpu")
    j_caches = {}
    for name, (k, v) in cache.caches.items():
        k.copy_(torch.from_numpy(rng.normal(size=k.shape).astype(np.float32)))
        v.copy_(torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)))
        j_caches[name] = (k.numpy().copy(), v.numpy().copy())
    src = np.array([0, 0, 1, 4, 2], np.int32)
    mask = np.array([False, True, True, False, True])
    clen = np.array([3, 7, 16, 2, 0], np.int32)
    want = jax_prefix_copy(j_caches, src, mask, clen, maxlen)
    prefix_copy(cache, *(torch.from_numpy(a) for a in (src, mask, clen)))
    for name, (k, v) in cache.caches.items():
        np.testing.assert_array_equal(k.numpy(), np.asarray(want[name][0]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[name][1]))


# -- the engine: the reference's scenarios, on both engines ------------------

def _one_shot(serving_lm, prompt, steps):
    return jax_generate(serving_lm, np.asarray(prompt, np.int32)[None], steps=steps,
                        kv_cache=True)[0]


def _tokens(reqs):
    return [list(map(int, r.full_sequence)) for r in reqs]


def _prefix_hit(engine_cls, model):
    """:128 — a hit admitted through the donor copy and suffix prefill."""
    prompt_b = SHARED + [4, 5, 3]
    cold = engine_cls(model, num_slots=4)
    rb_cold = cold.submit(prompt_b, 7)
    cold.run()
    warm = engine_cls(model, num_slots=4, prefix_cache=True)
    warm.run([(SHARED + [2, 3], 7)])
    rb = warm.submit(prompt_b, 7)
    warm.run()
    rc = warm.submit(prompt_b, 7)
    warm.run()
    return dict(tokens=_tokens([rb_cold, rb, rc]), reused=[rb.reused_tokens, rc.reused_tokens],
                cache=warm.scheduler.prefix_cache.stats(),
                probe=warm.prefix_warm_probe(SHARED + [5]))


def _lru_eviction(engine_cls, model):
    """:178 — donors evicted LRU under slot pressure."""
    engine = engine_cls(model, num_slots=2, prefix_cache=True)
    reqs = [engine.submit([2, 3, 4], 3), engine.submit([5, 4, 3], 3)]
    engine.run()
    donors = list(engine.scheduler.prefix_cache.donor_slots)
    reqs += [engine.submit(p, 3) for p in ([2, 3, 4, 4], [6, 6, 6], [7, 7, 7])]
    engine.run()
    return dict(tokens=_tokens(reqs), donors=donors, reused=[r.reused_tokens for r in reqs],
                cache=engine.scheduler.prefix_cache.stats(), slots=[r.slot for r in reqs])


def _single_slot(engine_cls, model):
    """:205 — the only donor is the only evictable slot: a cold fallback."""
    engine = engine_cls(model, num_slots=1, prefix_cache=True)
    engine.run([(SHARED, 4)])
    r2 = engine.submit(SHARED + [2, 3], 5)
    engine.run()
    cache = engine.scheduler.prefix_cache
    return dict(tokens=_tokens([r2]), reused=r2.reused_tokens, cache=cache.stats(),
                donors=cache.donor_slots, pins=cache.entry(0).pins)


def _cache_off(engine_cls, model):
    """:231 — without the cache every slot returns to the free list."""
    engine = engine_cls(model, num_slots=2)
    out = engine.run([(SHARED, 3), ([2, 3], 3), ([4, 5, 2], 3)])
    return dict(tokens=[list(map(int, out[k])) for k in sorted(out)],
                free=sorted(engine.scheduler._free), cache=engine.scheduler.prefix_cache)


WORKLOAD = [(LONG_A, 6), ([4, 5], 6), (SHARED, 6)]


def _chunked_vs_unchunked(engine_cls, model):
    """:245 — chunked prefill token-identical to the unchunked engine."""
    outs = []
    for kwargs in (dict(), dict(prefill_chunk=4)):
        out = engine_cls(model, num_slots=4, **kwargs).run(list(WORKLOAD))
        outs.append([list(map(int, out[k])) for k in sorted(out)])
    return dict(tokens=outs)


def _interleave(engine_cls, model):
    """:263 — decoding requests get tokens while a long prompt prefills."""
    engine = engine_cls(model, num_slots=2, prefill_chunk=4)
    short = engine.submit([2, 3], 12)
    engine.step()
    before = len(short.tokens)
    late = engine.submit(LONG_A, 4)
    trace = []
    while not late.tokens:
        n0 = len(short.tokens)
        engine.step()
        trace.append((len(short.tokens) - n0, dict(
            (s, p) for s, (_a, p) in engine._prefilling.items())))
        assert len(trace) < 100, "long prefill never finished"
    engine.run()
    return dict(tokens=_tokens([short, late]), before=before, trace=trace)


def _budget(engine_cls, model):
    """:296 — the budget caps total prefill tokens a step."""
    out = {}
    for budget in (None, 8):
        engine = engine_cls(model, num_slots=4, prefill_chunk=4, prefill_budget=budget)
        ra, rb = engine.submit(LONG_A, 3), engine.submit(LONG_B, 3)
        engine.step()
        out[budget] = dict(progress={s: p for s, (_a, p) in engine._prefilling.items()},
                           slots=[ra.slot, rb.slot])
        engine.run()
        out[budget]["tokens"] = _tokens([ra, rb])
    return out


def _compose(engine_cls, model):
    """:327 — donor copy and budgeted suffix chunks together."""
    engine = engine_cls(model, num_slots=4, prefix_cache=True, prefill_chunk=4)
    engine.run([(SHARED + [2, 3], 6)])
    rb = engine.submit(SHARED + [4, 5, 2], 6)
    engine.run()
    return dict(tokens=_tokens([rb]), reused=rb.reused_tokens,
                cache=engine.scheduler.prefix_cache.stats())


def _min_reuse(engine_cls, model):
    """:463 — matches below prefix_min_reuse admit cold."""
    engine = engine_cls(model, num_slots=4, prefix_cache=True, prefix_min_reuse=4)
    engine.run([([2, 3, 4, 5, 2, 3], 3)])
    shallow = engine.submit([2, 3, 5, 5, 5], 3)
    deep = engine.submit([2, 3, 4, 5, 4], 3)
    engine.run()
    return dict(tokens=_tokens([shallow, deep]),
                reused=[shallow.reused_tokens, deep.reused_tokens],
                cache=engine.scheduler.prefix_cache.stats())


def _flush(engine_cls, model):
    """The scheduler's flush (what a weight refresh calls): every entry
    drops, the donors return to the free list, and a prefix-sharing request
    is served cold."""
    engine = engine_cls(model, num_slots=3, prefix_cache=True)
    engine.run([(SHARED + [2, 3], 4), ([4, 5, 2], 4)])
    before = (sorted(engine.scheduler._free), engine.scheduler.prefix_cache.stats())
    engine.scheduler.flush_prefix_cache()
    after = (sorted(engine.scheduler._free), engine.scheduler.prefix_cache.stats())
    r = engine.submit(SHARED + [4, 5], 4)
    engine.run()
    return dict(before=before, after=after, reused=r.reused_tokens, tokens=_tokens([r]))


SCENARIOS = {f.__name__[1:]: f for f in (_prefix_hit, _lru_eviction, _single_slot, _cache_off,
                                         _chunked_vs_unchunked, _interleave, _budget, _compose,
                                         _min_reuse, _flush)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_the_jax_engine(serving_lm, lm, name):  # noqa: F811
    want = SCENARIOS[name](JaxEngine, serving_lm)
    got = SCENARIOS[name](InferenceEngine, lm)
    assert got == want


def test_scenario_claims_hold_on_the_port(serving_lm, lm):  # noqa: F811
    """The reference scenarios' own claims, on the port's results (tokens
    against the JAX one-shot cached generate)."""
    hit = _prefix_hit(InferenceEngine, lm)
    assert hit["reused"] == [len(SHARED), len(SHARED) + 2]
    assert hit["tokens"][0] == hit["tokens"][1] == hit["tokens"][2]
    assert hit["tokens"][1] == list(_one_shot(serving_lm, SHARED + [4, 5, 3], 7))
    assert hit["cache"]["hits"] >= 1 and hit["probe"] == len(SHARED)

    lru = _lru_eviction(InferenceEngine, lm)
    assert len(lru["donors"]) == 2 and lru["reused"][2] == 3
    assert lru["cache"]["evictions"] >= 2

    single = _single_slot(InferenceEngine, lm)
    assert single["reused"] == 0 and single["donors"] == [0] and single["pins"] == 0
    assert single["cache"]["evictions"] == 1
    assert single["cache"]["hits"] == 0 and single["cache"]["misses"] == 2
    assert single["tokens"][0] == list(_one_shot(serving_lm, SHARED + [2, 3], 5))

    off = _cache_off(InferenceEngine, lm)
    assert off["free"] == [0, 1] and off["cache"] is None

    chunked = _chunked_vs_unchunked(InferenceEngine, lm)
    assert chunked["tokens"][0] == chunked["tokens"][1]

    inter = _interleave(InferenceEngine, lm)
    assert sum(1 for got, _p in inter["trace"] if got) >= 2
    assert inter["tokens"][1] == list(_one_shot(serving_lm, LONG_A, 4))

    budget = _budget(InferenceEngine, lm)
    (a, b) = budget[None]["slots"]
    assert budget[None]["progress"] == {a: 4, b: 0}
    assert budget[8]["progress"] == {a: 4, b: 4}
    assert budget[None]["tokens"][1] == list(_one_shot(serving_lm, LONG_B, 3))

    compose = _compose(InferenceEngine, lm)
    assert compose["reused"] == len(SHARED)

    floor = _min_reuse(InferenceEngine, lm)
    assert floor["reused"] == [0, 4]
    assert floor["cache"]["hits"] == 1 and floor["cache"]["misses"] == 2

    flush = _flush(InferenceEngine, lm)
    assert flush["before"][0] == [2] and flush["after"][0] == [0, 1, 2]
    assert flush["after"][1]["entries"] == 0 and flush["reused"] == 0


@pytest.mark.parametrize("kwargs", [dict(prefill_budget=8), dict(prefill_chunk=4, prefill_budget=0),
                                    dict(prefill_chunk=0), dict(prefill_chunk=33)])
def test_chunk_option_errors_match_jax(serving_lm, lm, kwargs):  # noqa: F811
    with pytest.raises(ValueError) as j_err:
        JaxEngine(serving_lm, num_slots=2, **kwargs)
    with pytest.raises(ValueError) as t_err:
        InferenceEngine(lm, num_slots=2, **kwargs)
    assert str(t_err.value) == str(j_err.value)


def test_stats_report_ttft_and_inter_token_percentiles(lm):  # noqa: F811
    """:546 on the port: TTFT and the inter-token gaps telescope to each
    request's latency; the prefix counters ride along when the cache is
    on."""
    engine = InferenceEngine(lm, num_slots=2, prefix_cache=True)
    reqs = [engine.submit(p, 5) for p in ([2, 3, 4], [4, 5])]
    engine.run()
    st = engine.stats()
    assert st["ttft_s"]["n"] == 2 and st["inter_token_s"]["n"] == 8
    assert 0 < st["ttft_s"]["p50"] <= st["ttft_s"]["p99"]
    assert st["prefix_cache"] == engine.scheduler.prefix_cache.stats()
    for r in reqs:
        assert len(r.token_times) == 5
        np.testing.assert_allclose(r.ttft + sum(r.inter_token_times),
                                   r.finish_time - r.submit_time, rtol=1e-6)


def test_cancel_mid_prefill_frees_the_slot(lm):  # noqa: F811
    engine = InferenceEngine(lm, num_slots=1, prefill_chunk=4, prefix_cache=True)
    r = engine.submit(LONG_A, 3)
    engine.step()
    assert engine._prefilling
    assert engine.cancel(r.rid)
    assert not engine._prefilling and engine.scheduler._free == [0]
    assert engine.scheduler.prefix_cache.stats()["entries"] == 0
    out = engine.run([(SHARED, 3)])
    assert list(out.values())[0].tolist() == _tokens([engine.finished[max(out)]])[0]
