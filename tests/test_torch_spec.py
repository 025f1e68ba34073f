"""The port's speculative decoding (``elephas_tpu_torch.serving.speculative``
and the engine's verify round) against the JAX package's, on the CPU.

- ``NgramDrafter`` in the cases of ``tests/test_serving_spec.py`` and
  proposal for proposal against the reference's on seeded random streams;
  ``AcceptanceThrottle`` in the reference's unit sequence and decision for
  decision against the reference's on a seeded trace; their errors word for
  word.
- The engine with ``speculative``, ``spec_k`` and ``spec_drafter`` in the
  scenarios of ``tests/test_serving_spec.py``, each run on both engines on
  the trained ``serving_lm`` (port on ``device="cpu"``) with every
  observable compared: tokens at temperature 0, the ``spec_*`` counters,
  each request's drafted and accepted tokens, drafter calls, free slots and
  blocks. Then each scenario's own claims on the port, tokens against the
  port's ``generate(kv_cache=True)``. The fixed arena and the paged arena
  (``block_size=4``, fp and int8); ``steps_per_sync`` with a mid-flight
  arrival; chunked prefill; the prefix cache; an EOS inside the window; a
  drafter whose guesses never land (collapse, fallback, re-probe: the
  plain decode window shown by counting the span-decode wrapper's calls);
  self-speculation through ``DraftModelDrafter``; an over-proposing drafter.
- ``DraftModelDrafter``'s proposals against the reference drafter's and
  the draft model's own greedy continuation; its errors and the engine's
  knob errors word for word.

Not mirrored: ``:153`` (a TP mesh: ROADMAP.md Queue A item 5), ``:222`` and
``:238`` (the compile set: JAX's compile cache, which the eager port does
not have). ``:464`` (``refresh_weights`` through the engine) runs on both
engines in ``tests/test_torch_deploy.py`` and ``:552`` (the metrics scrape)
on the port in ``tests/test_torch_telemetry.py``.
"""

import logging

import numpy as np
import pytest

import elephas_tpu_torch as et
from elephas_tpu import serving as jserving
from elephas_tpu.models import generate as jax_generate
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.serving import speculative as jspec
from elephas_tpu.serving.scheduler import Request as JaxRequest
from elephas_tpu_torch import serving as tserving
from elephas_tpu_torch.models import transformer
from elephas_tpu_torch.serving import speculative as tspec
from elephas_tpu_torch.serving.scheduler import Request
from tests.test_torch_serving import lm  # noqa: F401  (lm: fixture)

MIXED_PROMPTS = [
    [2, 3, 4, 5],
    [4, 5],
    [3, 4, 5, 2, 3, 4, 5, 2],
    [5, 2, 3],
    [2, 3, 4, 5, 2, 3],
]


def _req(cls, prompt, tokens=(), max_new=16, rid=0):
    r = cls(rid=rid, prompt=tuple(prompt), max_new_tokens=max_new)
    r.tokens = [int(t) for t in tokens]
    return r


# -- the n-gram drafter ---------------------------------------------------------

def test_ngram_reference_cases():
    """``tests/test_serving_spec.py:65-118`` on the port."""
    d = tspec.NgramDrafter(max_ngram=3)
    assert d.propose(_req(Request, [2, 3, 4, 5]), 4) == []
    assert d.propose(_req(Request, [7]), 4) == []
    r = _req(Request, [2, 3, 4, 5, 6, 7, 2, 3, 4])
    assert d.propose(r, 4) == [5, 6, 7, 2] and d.propose(r, 2) == [5, 6]
    assert d.propose(_req(Request, [2, 5, 6, 9, 4], tokens=[5, 6]), 2) == [9, 4]
    assert d.propose(_req(Request, [8, 3, 4, 9, 3], tokens=[4, 9]), 1) == [3]
    assert d.propose(_req(Request, [4, 5, 7, 4, 9, 6, 4]), 1) == [9]
    assert d.propose(_req(Request, [3, 7, 4, 9, 5, 7, 4]), 1) == [9]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_matches_the_reference_on_random_streams(seed):
    """200 random prompt / generated splits over a 3-token alphabet, random
    n-gram bounds and k: equal proposals."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        lo = int(rng.integers(1, 4))
        hi = int(rng.integers(lo, 6))
        seq = [int(t) for t in rng.integers(2, 5, rng.integers(1, 24))]
        cut = int(rng.integers(1, len(seq) + 1))
        k = int(rng.integers(1, 6))
        got = tspec.NgramDrafter(hi, lo).propose(_req(Request, seq[:cut], seq[cut:]), k)
        want = jspec.NgramDrafter(hi, lo).propose(_req(JaxRequest, seq[:cut], seq[cut:]), k)
        assert got == want


@pytest.mark.parametrize("kwargs", [dict(max_ngram=2, min_ngram=3), dict(max_ngram=0)])
def test_ngram_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as j_err:
        jspec.NgramDrafter(**kwargs)
    with pytest.raises(ValueError) as t_err:
        tspec.NgramDrafter(**kwargs)
    assert str(t_err.value) == str(j_err.value)


# -- the acceptance throttle ----------------------------------------------------

def test_throttle_unit_semantics():
    """``tests/test_serving_spec.py:319`` on the port."""
    t = tspec.AcceptanceThrottle(probe_window=4, min_rate=0.5, reprobe_rounds=2)
    assert t.should_draft(1)
    assert not t.note(1, proposed=2, accepted=2)
    assert not t.note(1, proposed=1, accepted=1)
    assert not t.note(1, proposed=2, accepted=0)
    assert not t.throttled(1)
    assert t.note(1, proposed=4, accepted=0)
    assert t.throttled(1)
    assert not t.should_draft(1)
    assert not t.should_draft(1)
    assert t.should_draft(1)
    t.forget(1)
    assert not t._state


@pytest.mark.parametrize("seed", [0, 1])
def test_throttle_matches_the_reference_on_a_seeded_trace(seed):
    """500 random consults, notes, reads and forgets over 4 requests: every
    return value and the state agree."""
    rng = np.random.default_rng(seed)
    kw = dict(probe_window=int(rng.integers(1, 9)), min_rate=float(rng.random()),
              reprobe_rounds=int(rng.integers(1, 5)))
    ours, theirs = tspec.AcceptanceThrottle(**kw), jspec.AcceptanceThrottle(**kw)
    for _ in range(500):
        op, rid = int(rng.integers(4)), int(rng.integers(4))
        if op == 0:
            assert ours.should_draft(rid) == theirs.should_draft(rid)
        elif op == 1:
            proposed = int(rng.integers(0, 5))
            accepted = int(rng.integers(0, proposed + 1))
            assert ours.note(rid, proposed, accepted) == theirs.note(rid, proposed, accepted)
        elif op == 2:
            assert ours.throttled(rid) == theirs.throttled(rid)
        elif rng.random() < 0.2:
            ours.forget(rid)
            theirs.forget(rid)
        assert ours._state == theirs._state


@pytest.mark.parametrize("kwargs", [dict(probe_window=0), dict(min_rate=1.5),
                                    dict(reprobe_rounds=0)])
def test_throttle_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as j_err:
        jspec.AcceptanceThrottle(**kwargs)
    with pytest.raises(ValueError) as t_err:
        tspec.AcceptanceThrottle(**kwargs)
    assert str(t_err.value) == str(j_err.value)


# -- the engine: the reference's scenarios, on both engines -------------------------

class _Api:
    """One package's serving names, so a scenario runs on either."""

    def __init__(self, pkg, spec, generate):
        self.engine, self.spec, self.generate = pkg.InferenceEngine, spec, generate


JAX = _Api(jserving, jspec, jax_generate)
PORT = _Api(tserving, tspec, et.generate)


def _one_shot(api, model, prompt, steps):
    return [int(t) for t in api.generate(model, np.asarray(prompt, np.int32)[None], steps,
                                         kv_cache=True)[0]]


def _spec_stats(engine):
    st = engine.stats()
    return {k: st[k] for k in ("spec_draft_tokens", "spec_accepted_tokens",
                               "spec_acceptance_rate", "spec_verify_rounds", "spec_throttled",
                               "decode_steps", "total_generated")}


def _observe(engine, reqs):
    out = dict(tokens=[[int(t) for t in r.full_sequence] for r in reqs],
               per_request=[(r.spec_drafted, r.spec_accepted, r.done) for r in reqs],
               stats=_spec_stats(engine), free=sorted(engine.scheduler._free),
               throttle=len(engine._spec_throttle._state))
    if engine.paged:
        out["blocks"] = (engine.scheduler.allocator.free_count, engine.num_blocks)
    return out


def _parity(api, model, **kw):
    engine = api.engine(model, speculative=True, spec_k=3, **kw)
    reqs = [engine.submit(p, max_new_tokens=8) for p in MIXED_PROMPTS]
    engine.run()
    return _observe(engine, reqs)


def _fixed(api, model):
    """:90 — the fixed slot arena."""
    return _parity(api, model, num_slots=4)


def _paged(api, model):
    """:108 — the paged block pool."""
    return _parity(api, model, num_slots=4, paged=True, block_size=4)


def _paged_int8(api, model):
    """:108 on an int8 pool (the reference's quantized verify)."""
    return _parity(api, model, num_slots=4, paged=True, block_size=4, kv_dtype="int8")


def _window_midflight(api, model):
    """:140 — ``steps_per_sync`` and a mid-flight arrival."""
    engine = api.engine(model, num_slots=2, speculative=True, spec_k=3, steps_per_sync=4)
    reqs = [engine.submit(p, max_new_tokens=6) for p in MIXED_PROMPTS[:3]]
    late = None
    for i, _ in enumerate(engine.stream()):
        if i == 3:
            late = engine.submit([3, 4, 5], max_new_tokens=5)
    return _observe(engine, reqs + [late])


def _chunked(api, model):
    """:168 — chunked prefill between speculative rounds."""
    return _parity(api, model, num_slots=4, prefill_chunk=4)


def _prefix(api, model):
    """:182 — the prefix cache's donors survive verify rounds."""
    engine = api.engine(model, num_slots=6, speculative=True, spec_k=3, prefix_cache=True,
                        prefix_min_reuse=3)
    shared = [2, 3, 4, 5, 2, 3]
    load = [(shared + [s], 6) for s in (2, 3)]
    reqs = [engine.submit(p, mn) for p, mn in load]
    engine.run()
    reqs += [engine.submit(p, mn) for p, mn in load]
    engine.run()
    out = _observe(engine, reqs)
    out["reused"] = [r.reused_tokens for r in reqs]
    return out


def _eos(api, model):
    """:206 — an EOS inside the accepted window."""
    ref = _one_shot(api, model, [2, 3, 4], 10)
    eos = int(ref[3:][4])
    engine = api.engine(model, num_slots=1, speculative=True, spec_k=4)
    reqs = [engine.submit([2, 3, 4], max_new_tokens=10, eos_id=eos),
            engine.submit([4, 5], max_new_tokens=4)]
    engine.run()
    return dict(_observe(engine, reqs), eos=eos)


def _collapse(api, model):
    """:271 — guesses that never land: the throttle trips, plain decode
    takes over, the drafter is consulted again after the cooldown."""
    calls = []

    class Wrong(api.spec.Drafter):
        def propose(self, req, k):
            calls.append(int(k))
            return [7] * int(k)

    engine = api.engine(model, num_slots=1, speculative=True, spec_k=3, spec_drafter=Wrong())
    engine._spec_throttle = api.spec.AcceptanceThrottle(probe_window=6, min_rate=0.5,
                                                        reprobe_rounds=3)
    reqs = [engine.submit([2, 3, 4, 5], max_new_tokens=24)]
    engine.run()
    return dict(_observe(engine, reqs), calls=calls)


def _self_spec(api, model):
    """:411 — the target as its own draft model."""
    return _parity(api, model, num_slots=2, spec_drafter=model)


def _overpropose(api, model):
    """:436 — more than k drafts, and drafts for a slot never asked."""

    class Greedy(api.spec.Drafter):
        def propose(self, req, k):
            return [7] * (int(k) * 2 + 3)

        def propose_batch(self, items):
            out = {slot: self.propose(r, k) for slot, r, k in items}
            out[99] = [7, 7]
            return out

    engine = api.engine(model, num_slots=2, speculative=True, spec_k=3, spec_drafter=Greedy())
    reqs = [engine.submit([2, 3, 4], max_new_tokens=8)]
    engine.run()
    return _observe(engine, reqs)


SCENARIOS = {f.__name__[1:]: f for f in (_fixed, _paged, _paged_int8, _window_midflight,
                                         _chunked, _prefix, _eos, _collapse, _self_spec,
                                         _overpropose)}


def _claims(name, got, model, decode_calls):
    """The reference scenario's own claims, on the port's results."""
    one = lambda p, n: _one_shot(PORT, model, p, n)  # noqa: E731
    st = got["stats"]
    if name in ("fixed", "paged", "paged_int8", "chunked"):
        want = [one(p, 8) for p in MIXED_PROMPTS]
        if name != "paged_int8":  # int8 KV is not held to the fp tokens
            assert got["tokens"] == want
        assert st["spec_draft_tokens"] > 0 and st["spec_accepted_tokens"] > 0
        assert st["spec_verify_rounds"] > 0
        if "blocks" in got:
            assert got["blocks"][0] == got["blocks"][1]  # the pool whole again
    elif name == "window_midflight":
        assert got["tokens"] == [one(p, 6) for p in MIXED_PROMPTS[:3]] + [one([3, 4, 5], 5)]
        assert got["per_request"][-1][2] and got["free"] == [0, 1]
    elif name == "prefix":
        assert any(r > 0 for r in got["reused"])
        shared = [2, 3, 4, 5, 2, 3]
        assert got["tokens"] == [one(shared + [s], 6) for s in (2, 3)] * 2
    elif name == "eos":
        ref = one([2, 3, 4], 10)
        cont = np.asarray(ref[3:])
        stop_at = int(np.argmax(cont == got["eos"])) + 1
        assert got["tokens"] == [ref[: 3 + stop_at], one([4, 5], 4)]
        drafted, accepted, _done = got["per_request"][0]
        assert accepted <= len(got["tokens"][0]) - 3
    elif name == "collapse":
        assert got["tokens"] == [one([2, 3, 4, 5], 24)]
        assert st["spec_throttled"] >= 2 and len(got["calls"]) >= 4
        assert decode_calls > 0  # the plain window ran: the span decode
        assert got["throttle"] == 0
    elif name == "self_spec":
        assert got["tokens"] == [one(p, 8) for p in MIXED_PROMPTS]
        assert st["spec_draft_tokens"] > 0 and st["spec_acceptance_rate"] > 0.9
    else:
        assert got["tokens"] == [one([2, 3, 4], 8)]
        drafted = got["per_request"][0][0]
        assert 0 < drafted <= st["spec_verify_rounds"] * 3


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_the_jax_engine(serving_lm, lm, monkeypatch, name):  # noqa: F811
    """Each scenario on both engines, every observable equal; then the
    scenario's own claims on the port's results."""
    want = SCENARIOS[name](JAX, serving_lm)
    calls = []
    decode = transformer.flash_span_decode

    def counted(*args, **kwargs):
        calls.append(1)
        return decode(*args, **kwargs)

    monkeypatch.setattr(transformer, "flash_span_decode", counted)
    got = SCENARIOS[name](PORT, lm)
    monkeypatch.undo()
    assert got == want
    _claims(name, got, lm, len(calls))


# -- the draft-model drafter ----------------------------------------------------------

def test_draft_model_drafter_matches_generate_and_the_reference(serving_lm, lm):  # noqa: F811
    """:339 and :366 on both drafters: a mid-stream request's catch-up and
    drafts, an incremental call after two accepted tokens, and a new
    occupant of the same slot; the port's proposals equal the reference
    drafter's and the draft model's own greedy continuation."""
    prompt = [2, 3, 4, 5, 2]
    ref = _one_shot(PORT, lm, prompt, 6)[len(prompt):]
    got, want = [], []
    for spec, cls, model, out in ((tspec, Request, lm, got),
                                  (jspec, JaxRequest, serving_lm, want)):
        d = spec.DraftModelDrafter(model, num_slots=2)
        req = _req(cls, prompt[:-1], tokens=[prompt[-1]], rid=1)
        out.append(d.propose_batch([(1, req, 4)]))
        req.tokens.extend(ref[:2])
        out.append(d.propose_batch([(1, req, 2)]))
        other = _req(cls, [4, 5, 2], tokens=[3], rid=2)
        out.append(d.propose_batch([(1, other, 3)]))
    assert got == want
    assert got[0][1] == ref[:4] and got[1][1] == ref[2:4]
    assert got[2][1] == _one_shot(PORT, lm, [4, 5, 2], 4)[4:]


def test_draft_model_catches_up_in_chunks(lm):  # noqa: F811
    """A prompt past ``CATCHUP_CHUNK`` catches up in several chunk passes,
    and the drafts still equal the greedy continuation."""
    d = tspec.DraftModelDrafter(lm, num_slots=1)
    d._chunk = 4
    prompt = [2, 3, 4, 5] * 3
    ref = _one_shot(PORT, lm, prompt, 3)[len(prompt):]
    got = d.propose_batch([(0, _req(Request, prompt[:-1], tokens=[prompt[-1]]), 3)])
    assert got[0] == ref and d.catchup_passes == 3 and d.draft_steps == 3


def test_draft_model_errors_match_jax(serving_lm, lm):  # noqa: F811
    """:389 on both packages, message for message."""
    cfg = dict(vocab_size=8, maxlen=16, d_model=16, num_heads=2, num_layers=1)
    cases = [
        (lambda s, m: s.DraftModelDrafter(m, num_slots=2, target_maxlen=64), {}),
        (lambda s, m: s.DraftModelDrafter(m, num_slots=2, target_vocab=16), {}),
        (lambda s, m: s.DraftModelDrafter(m, num_slots=0), {}),
    ]
    for make, _ in cases:
        with pytest.raises(ValueError) as j_err:
            make(jspec, serving_lm)
        with pytest.raises(ValueError) as t_err:
            make(tspec, lm)
        assert str(t_err.value) == str(j_err.value)
    short = (jax_lm(**cfg), et.transformer_lm(**cfg, device="cpu"))
    small = (jspec.DraftModelDrafter(serving_lm, num_slots=1),
             tspec.DraftModelDrafter(lm, num_slots=1))
    for drafter in (short, small):
        with pytest.raises(ValueError) as j_err:
            jserving.InferenceEngine(serving_lm, num_slots=2, speculative=True,
                                     spec_drafter=drafter[0])
        with pytest.raises(ValueError) as t_err:
            tserving.InferenceEngine(lm, num_slots=2, speculative=True,
                                     spec_drafter=drafter[1])
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kwargs", [
    dict(spec_k=4), dict(spec_drafter="ngram"), dict(speculative=True, spec_k=0),
    dict(speculative=True, spec_k=99), dict(speculative=True, spec_drafter="lookup"),
])
def test_spec_knob_errors_match_jax(serving_lm, lm, kwargs):  # noqa: F811
    """:486 on both engines, message for message."""
    with pytest.raises(ValueError) as j_err:
        jserving.InferenceEngine(serving_lm, num_slots=2, **kwargs)
    with pytest.raises(ValueError) as t_err:
        tserving.InferenceEngine(lm, num_slots=2, **kwargs)
    assert str(t_err.value) == str(j_err.value)


def test_priority_on_non_preemption_engine_warns(lm, caplog):  # noqa: F811
    """:502 on the port."""
    engine = tserving.InferenceEngine(lm, num_slots=2)
    with caplog.at_level(logging.WARNING, "elephas_tpu_torch.serving.engine"):
        r = engine.submit([2, 3], max_new_tokens=2, priority=5)
    assert any("IGNORED" in rec.message for rec in caplog.records)
    assert r.rid in engine.run()
    caplog.clear()
    pe = tserving.InferenceEngine(lm, num_slots=2, paged=True, block_size=4, preemption=True)
    with caplog.at_level(logging.WARNING, "elephas_tpu_torch.serving.engine"):
        pe.submit([2, 3], max_new_tokens=2, priority=5)
    assert not any("IGNORED" in rec.message for rec in caplog.records)


def test_spec_keys_on_a_plain_engine(lm):  # noqa: F811
    """:588 on the port: decode-only tokens/s, and the speculative keys
    present and zero on an engine without speculation."""
    engine = tserving.InferenceEngine(lm, num_slots=2)
    assert engine.stats()["decode_tok_s"] is None
    engine.run([(p, 6) for p in MIXED_PROMPTS[:3]])
    s = engine.stats()
    assert s["decode_tok_s"] > 0
    assert (s["spec_draft_tokens"], s["spec_accepted_tokens"], s["spec_verify_rounds"],
            s["spec_throttled"], s["spec_acceptance_rate"]) == (0, 0, 0, 0, None)


def test_verify_round_feeds_every_slot_one_window(lm, monkeypatch):  # noqa: F811
    """A verify round is one ``verify_forward`` over all ``num_slots`` rows at
    ``W = spec_k + 1``: the shape the span-chunk kernel takes on the card
    (its C5 case)."""
    from elephas_tpu_torch.serving import engine as engine_mod

    shapes = []
    verify = engine_mod.verify_forward

    def spy(model, tokens, *args, **kwargs):
        shapes.append(tuple(tokens.shape))
        return verify(model, tokens, *args, **kwargs)

    monkeypatch.setattr(engine_mod, "verify_forward", spy)
    engine = tserving.InferenceEngine(lm, num_slots=4, speculative=True, spec_k=4)
    engine.run([(p, 8) for p in MIXED_PROMPTS])
    assert shapes and set(shapes) == {(4, 5)}
    assert len(shapes) == engine.stats()["spec_verify_rounds"]
