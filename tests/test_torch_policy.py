"""The port's SLO admission policies (``elephas_tpu_torch.serving.policy``,
the scheduler's policy hooks, the engine's tenants, deadlines and admission
control, ``SparkModel.serve(policy=, tenants=)``) against the JAX package's,
on the CPU.

- The host-side cases of ``tests/test_serving_policy.py`` run on both
  packages' ``Scheduler`` and policies: admission orders, served counts,
  virtual counters, verdicts and ``retry_after_s`` equal, then the
  reference's own claims on the port's results; and seeded random event
  sequences (submits over tenants and deadline classes, admissions, tokens,
  finishes, verdicts under ``max_queue_tokens``) through both, fixed and
  paged with preemption, every decision and the policies' state equal.
- The engine cases on both engines on the trained ``serving_lm`` (port on
  ``device="cpu"``): knob errors word for word, the admission rejection
  and the per-tenant counts (``slo_*`` aside: they read the wall clock),
  temperature-0 tokens equal per request under no policy, FIFO and fair
  share, on the fixed and the paged arena.

Not mirrored: ``:342`` (a TP mesh: ROADMAP.md Queue A item 5). The
tenant series against ``stats()`` (``:361``) run on the port in
``tests/test_torch_telemetry.py``.
"""

import numpy as np
import pytest

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import policy as jpol
from elephas_tpu.serving.blocks import BlockAllocator as JaxAllocator
from elephas_tpu.serving.scheduler import Scheduler as JaxScheduler
from elephas_tpu_torch.serving import BlockAllocator, InferenceEngine, Scheduler
from elephas_tpu_torch.serving import policy as tpol
from elephas_tpu_torch.serving.scheduler import default_buckets
from tests.test_torch_serving import lm  # noqa: F401  (lm: fixture)

MIXED = [[2, 3, 4, 5], [4, 5], [3, 4, 5, 2, 3, 4, 5, 2], [5, 2, 3]]
# (policy module, Scheduler, BlockAllocator) of each package
PORT = (tpol, Scheduler, BlockAllocator)
JAX = (jpol, JaxScheduler, JaxAllocator)


def _drain_one(s, slot, budget):
    req = s.active[slot]
    for _ in range(budget):
        done = s.on_token(slot, 7)
    assert done and req.done
    s.reclaim(slot)
    return req


def _both(case):
    """``case(pkg)`` on the port and the reference: equal results."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


# -- the host-side cases --------------------------------------------------------------

def _alternate(pkg):
    pol, sched, _ = pkg
    p = pol.FairSharePolicy({"a": 1.0, "b": 1.0})
    s = sched(1, default_buckets(64), policy=p)
    for t in ("a",) * 3 + ("b",) * 3:
        s.submit(s.make_request([1] * 4, 4, tenant=t))
    order = []
    for _ in range(6):
        adm = s.admit()
        order.append(adm[0].req.tenant)
        for _t in range(4):
            p.on_token(s.active[adm[0].slot])
        _drain_one(s, adm[0].slot, 4)
    return order, p.stats()


def test_fair_share_alternates_between_backlogged_tenants():
    order, _ = _both(_alternate)
    assert order == ["a", "b", "a", "b", "a", "b"]


def _weights(pkg):
    pol, sched, _ = pkg
    p = pol.FairSharePolicy({"heavy": 2.0, "light": 1.0})
    s = sched(1, default_buckets(64), policy=p)
    for _ in range(8):
        s.submit(s.make_request([1] * 4, 4, tenant="heavy"))
        s.submit(s.make_request([1] * 4, 4, tenant="light"))
    served = {"heavy": 0, "light": 0}
    for _ in range(9):
        adm = s.admit()
        served[adm[0].req.tenant] += 1
        for _t in range(4):
            p.on_token(s.active[adm[0].slot])
        _drain_one(s, adm[0].slot, 4)
    return served, p.stats()


def test_fair_share_respects_weights():
    served, stats = _both(_weights)
    assert served == {"heavy": 6, "light": 3}
    v = stats["virtual_counters"]
    assert abs(v["heavy"] - v["light"]) <= 1.0 * 4 + 2.0 * 4


def _edf(pkg):
    pol, sched, _ = pkg
    s = sched(1, default_buckets(64), policy=pol.FairSharePolicy({"a": 1.0}))
    reqs = [s.submit(s.make_request([1] * 4, 2, tenant="a", ttft_deadline_ms=dl))
            for dl in (5000, None, 50)]
    order = []
    for _ in range(3):
        adm = s.admit()
        order.append(reqs.index(adm[0].req))
        _drain_one(s, adm[0].slot, 2)
    return order


def test_edf_orders_within_a_tenant():
    assert _both(_edf) == [2, 0, 1]


def _aging(pkg):
    pol, sched, _ = pkg
    p = pol.FairSharePolicy({"rich": 1.0, "poor": 1.0}, aging_waves=3)
    s = sched(1, default_buckets(64), policy=p)
    p._vtc["poor"] = 1e9
    starved = s.submit(s.make_request([1] * 4, 2, tenant="poor"))
    for wave in range(1, 8):
        s.submit(s.make_request([1] * 4, 2, tenant="rich"))
        adm = s.admit()
        if adm[0].req is starved:
            return wave, p.stats()
        _drain_one(s, adm[0].slot, 2)
    return None, p.stats()


def test_aging_promotes_starved_request():
    wave, _ = _both(_aging)
    assert wave is not None and wave <= 3 + 1


def _verdicts(pkg):
    pol, sched, _ = pkg
    p = pol.FairSharePolicy({"a": 1.0}, max_queue_tokens=20, retry_after_s=2.0)
    s = sched(1, default_buckets(64), policy=p)
    r1 = s.make_request([1] * 4, 8, tenant="a")
    v1 = p.admission_verdict(r1, s.queued_tokens, s.queued_tokens_for("a"))
    s.submit(r1)
    r2 = s.make_request([1] * 4, 8, tenant="a")
    v2 = p.admission_verdict(r2, s.queued_tokens, s.queued_tokens_for("a"))
    return [(v.admitted, v.retry_after_s, v.reason) for v in (v1, v2)], p.stats()


def test_admission_control_rejects_past_token_debt_bound():
    (v1, v2), _ = _both(_verdicts)
    assert v1[0] and not v2[0] and "admission bound" in v2[2]
    assert v2[1] == pytest.approx(4.0)


def _shares(pkg):
    pol, sched, _ = pkg
    p = pol.FairSharePolicy({"hog": 1.0, "light": 1.0}, max_queue_tokens=40)
    s = sched(1, default_buckets(64), policy=p)
    s.submit(s.make_request([1] * 8, 8, tenant="hog"))
    out = []
    for prompt, tenant in (([1] * 8, "hog"), ([1] * 4, "light")):
        v = p.admission_verdict(s.make_request(prompt, 8, tenant=tenant), s.queued_tokens,
                                s.queued_tokens_for(tenant))
        out.append((v.admitted, v.retry_after_s, v.reason))
    return out


def test_admission_control_shares_bound_by_tenant_weight():
    hog, light = _both(_shares)
    assert not hog[0] and "'hog'" in hog[2] and light[0]


def _preempt_priority(pkg):
    pol, sched, alloc = pkg
    p = pol.FairSharePolicy({"a": 1.0}, deadline_boost=1)
    s = sched(2, default_buckets(32), allocator=alloc(4, block_size=8), preemption=True,
              policy=p)
    best_effort = s.submit(s.make_request([1] * 8, 8, tenant="a"))
    adm1, pre1 = s.admit_paged()
    s.on_token(best_effort.slot, 7)
    urgent = s.submit(s.make_request([1] * 8, 24, tenant="a", ttft_deadline_ms=50))
    adm2, pre2 = s.admit_paged()
    s.on_token(urgent.slot, 7)
    rel = lambda r: r.rid - s.rid_base  # noqa: E731
    return ([rel(a.req) for a in adm1], [rel(v.req) for v in pre1],
            [rel(a.req) for a in adm2], [rel(v.req) for v in pre2],
            p.priority_of(urgent), p.stats())


def test_preemption_priority_derived_from_policy():
    adm1, pre1, adm2, pre2, prio, _ = _both(_preempt_priority)
    assert adm1 == [0] and not pre1 and pre2 == [0] and adm2 == [1] and prio == 0


def _fifo(pkg):
    pol, sched, _ = pkg
    s = sched(1, default_buckets(64), policy=pol.FifoPolicy({"a": 1.0, "b": 1.0}))
    rids = [s.submit(s.make_request([1] * 4, 2, tenant=t)).rid - s.rid_base
            for t in ("a", "a", "b", "a")]
    order = []
    for _ in range(4):
        adm = s.admit()
        order.append(adm[0].req.rid - s.rid_base)
        _drain_one(s, adm[0].slot, 2)
    return rids, order


def test_fifo_policy_keeps_submission_order():
    rids, order = _both(_fifo)
    assert order == rids


@pytest.mark.parametrize("call", [
    lambda pol: pol.normalize_tenants({"a": 0.0}),
    lambda pol: pol.FairSharePolicy(max_queue_tokens=0),
    lambda pol: pol.FairSharePolicy(aging_waves=0),
    lambda pol: pol.FairSharePolicy(retry_after_s=0),
    lambda pol: pol.FairSharePolicy(prefill_weight=-1),
    lambda pol: pol.resolve_policy("lifo"),
    lambda pol: pol.resolve_policy(42),
    lambda pol: pol.resolve_policy(pol.FairSharePolicy({"a": 1}), tenants={"b": 1}),
])
def test_policy_knob_errors_match_jax(call):
    with pytest.raises((ValueError, TypeError)) as j_err:
        call(jpol)
    with pytest.raises((ValueError, TypeError)) as t_err:
        call(tpol)
    assert (type(t_err.value), str(t_err.value)) == (type(j_err.value), str(j_err.value))


def test_policy_resolution_and_identity():
    """The rest of ``:229`` on the port."""
    assert tpol.resolve_policy(None) is None
    assert isinstance(tpol.resolve_policy(None, {"a": 1}), tpol.FairSharePolicy)
    assert isinstance(tpol.resolve_policy("fifo"), tpol.FifoPolicy)
    assert isinstance(tpol.resolve_policy("FAIR"), tpol.FairSharePolicy)
    base = tpol.Policy()
    assert base.knows(None) and base.knows(tpol.DEFAULT_TENANT)
    assert not tpol.FairSharePolicy({"a": 1}).knows("ghost")
    assert tpol.FairSharePolicy({"b": 2, "a": 1}).tenant_names == ("a", "b", "default")


def _random_traffic(pkg, seed, paged):
    """Seeded random submits (3 tenants of weights 1/2/3 and the default,
    deadline classes, priorities), verdicts under ``max_queue_tokens``,
    admission waves, tokens and finishes; every decision recorded."""
    pol, sched, alloc = pkg
    rng = np.random.default_rng(seed)
    p = pol.FairSharePolicy({"a": 1.0, "b": 2.0, "c": 3.0}, max_queue_tokens=90,
                            aging_waves=4, retry_after_s=0.5)
    kw = dict(allocator=alloc(12, block_size=4), preemption=True) if paged else {}
    s = sched(3, (16, 32, 64), policy=p, **kw)
    log = []
    rel = lambda r: r.rid - s.rid_base  # noqa: E731
    for _ in range(80):
        for _ in range(int(rng.integers(0, 3))):
            tenant = [None, "a", "b", "c"][int(rng.integers(4))]
            deadline = [None, 50.0, 500.0][int(rng.integers(3))]
            req = s.make_request([2] * int(rng.integers(1, 9)), int(rng.integers(1, 8)),
                                 priority=int(rng.integers(0, 2)), tenant=tenant,
                                 ttft_deadline_ms=deadline)
            v = p.admission_verdict(req, s.queued_tokens, s.queued_tokens_for(tenant))
            log.append(("verdict", rel(req), v.admitted, v.retry_after_s, v.reason))
            if v.admitted:
                s.submit(req)
        if paged:
            adm, pre = s.admit_paged()
            log.append(("preempt", [(rel(x.req), x.slot, x.cur_len) for x in pre]))
        else:
            adm = s.admit()
        log.append(("admit", [(rel(a.req), a.slot, a.resume is not None) for a in adm]))
        for slot in sorted(s.active):
            req = s.active[slot]
            p.on_token(req)
            if s.on_token(slot, 2):
                p.on_finish(req)
                s.reclaim(slot)
        log.append(("queue", [rel(r) for r in s.waiting], s.queued_tokens,
                    {t: s.waiting_count(t) for t in p.tenant_names}))
    return log, p.stats(), p.snapshot_counters()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_policy_decisions_match_the_reference_on_random_traffic(seed, paged):
    log, stats, _ = _both(lambda pkg: _random_traffic(pkg, seed, paged))
    assert any(e[0] == "verdict" and not e[2] for e in log)  # admission control bit
    assert stats["rejected"] > 0


# -- the engine ------------------------------------------------------------------------

@pytest.mark.parametrize("policy,kwargs", [
    (None, dict(tenant="a")),
    (None, dict(ttft_deadline_ms=100)),
    ("fair", dict(tenant="ghost")),
    ("fair", dict(tenant="a", ttft_deadline_ms=0)),
    ("fifo", dict(tenant="a", ttft_deadline_ms=100)),
])
def test_submit_slo_knob_errors_match_jax(serving_lm, lm, policy, kwargs):  # noqa: F811
    """:246 on both engines, message for message; nothing half-queued."""
    engines = []
    for pol, cls, model in ((jpol, JaxEngine, serving_lm), (tpol, InferenceEngine, lm)):
        p = None if policy is None else pol.resolve_policy(policy, {"a": 1.0})
        engines.append(cls(model, num_slots=2, policy=p))
    with pytest.raises(ValueError) as j_err:
        engines[0].submit([2, 3], 2, **kwargs)
    with pytest.raises(ValueError) as t_err:
        engines[1].submit([2, 3], 2, **kwargs)
    assert str(t_err.value) == str(j_err.value)
    assert not engines[1].scheduler.waiting


def test_engine_policy_type_error_matches_jax(serving_lm, lm):  # noqa: F811
    with pytest.raises(TypeError) as j_err:
        JaxEngine(serving_lm, num_slots=2, policy="fair")
    with pytest.raises(TypeError) as t_err:
        InferenceEngine(lm, num_slots=2, policy="fair")
    assert str(t_err.value) == str(j_err.value)


def _tenants(stats):
    """Per-tenant counts without the wall-clock SLO fields."""
    return {t: {k: v for k, v in row.items() if not k.startswith("slo_")}
            for t, row in stats["tenants"].items()}


def _engine_case(pol, cls, model, paged):
    """:273 and the counts of :311: an admission rejection at submit, then
    a three-tenant run with a refused heavy request; tokens, errors and the
    counters."""
    kw = dict(paged=True, block_size=4) if paged else {}
    engine = cls(model, num_slots=1, policy=pol.FairSharePolicy({"a": 1.0},
                                                                max_queue_tokens=14), **kw)
    ok = engine.submit([2, 3, 4, 5], 8, tenant="a")
    shed = engine.submit([2, 3, 4, 5], 8, tenant="a")
    shed_state = (shed.done, type(shed.error).__name__, shed.error.retry_after_s,
                  str(shed.error).split(" rejected by ", 1)[-1], len(engine.scheduler.waiting))
    out = engine.run()
    first = ([int(t) for t in out[ok.rid]], shed.rid in out, engine.stats()["admission_rejected"],
             _tenants(engine.stats()), engine.stats()["policy"])
    engine = cls(model, num_slots=2, policy=pol.FairSharePolicy(
        {"a": 1.0, "b": 1.0}, max_queue_tokens=40), **kw)
    reqs = [engine.submit(MIXED[0], 4, tenant="a", ttft_deadline_ms=60000),
            engine.submit(MIXED[1], 4, tenant="b"),
            engine.submit(MIXED[2], 20, tenant="b")]
    engine.run()
    st = engine.stats()
    second = ([[int(t) for t in r.full_sequence] for r in reqs], [r.error is None for r in reqs],
              st["admission_rejected"], _tenants(st), st["policy"],
              st["tenants"]["a"]["slo_met"] + st["tenants"]["a"]["slo_missed"])
    return shed_state, first, second, st["tenants"]["a"]["slo_met"]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_admission_and_tenant_counts_match_jax(serving_lm, lm, paged):  # noqa: F811
    got = _engine_case(tpol, InferenceEngine, lm, paged)
    want = _engine_case(jpol, JaxEngine, serving_lm, paged)
    assert got[:3] == want[:3]
    shed_state, first, second, slo_met = got
    assert shed_state[:2] == (True, "AdmissionRejected") and shed_state[2] > 0
    assert shed_state[4] == 1
    assert first[0] == [int(t) for t in et.generate(lm, np.asarray([[2, 3, 4, 5]]), 8,
                                                    kv_cache=True)[0]]
    assert not first[1] and first[2] == 1
    assert first[3]["a"]["rejected"] == 1 and first[3]["a"]["admitted"] == 1
    assert second[1] == [True, True, False] and second[2] == 1
    assert second[3]["b"]["rejected"] == 1 and second[3]["b"]["queue_depth"] == 0
    assert tpol.DEFAULT_TENANT in second[3]
    assert slo_met == 1  # a 60 s budget is always met


def _temp0(cls, pol, model, paged):
    kw = dict(paged=True, block_size=4) if paged else {}
    out = []
    for policy, with_slo in ((None, False), (pol.FifoPolicy({"a": 1, "b": 1}), False),
                             (pol.FairSharePolicy({"a": 1, "b": 2}), True)):
        engine = cls(model, num_slots=2, policy=policy, **kw)
        reqs = [engine.submit(p, 6, **(dict(tenant="a" if i % 2 else "b",
                                            ttft_deadline_ms=1000.0 * (i + 1))
                                       if with_slo else {}))
                for i, p in enumerate(MIXED)]
        engine.run()
        out.append([[int(t) for t in r.full_sequence] for r in reqs])
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_temp0_streams_bit_exact_under_any_policy(serving_lm, lm, paged):  # noqa: F811
    """:260 on both engines: tokens per request equal under no policy, FIFO
    and fair share with deadlines, and equal to the port's cached
    generate."""
    got = _temp0(InferenceEngine, tpol, lm, paged)
    assert got == _temp0(JaxEngine, jpol, serving_lm, paged)
    refs = [[int(t) for t in et.generate(lm, np.asarray([p]), 6, kv_cache=True)[0]]
            for p in MIXED]
    assert all(run == refs for run in got)


def test_policy_engine_has_zero_effect_when_unused(lm):  # noqa: F811
    """:360 on the port."""
    engine = InferenceEngine(lm, num_slots=2)
    engine.run([(p, 4) for p in MIXED[:2]])
    s = engine.stats()
    assert s["admission_rejected"] == 0 and s["tenants"] == {} and "policy" not in s


@pytest.mark.parametrize("kwargs", [
    dict(policy="lifo"), dict(policy=42),
    dict(policy=tpol.FairSharePolicy({"a": 1}), tenants={"b": 1}),
    dict(tenants={"a": 0.0}),
])
def test_serve_policy_errors_match_jax(serving_lm, lm, kwargs):  # noqa: F811
    """``SparkModel.serve(policy=, tenants=)`` refuses as the reference
    does."""
    jkw = dict(kwargs)
    if isinstance(jkw.get("policy"), tpol.Policy):
        jkw["policy"] = jpol.FairSharePolicy({"a": 1})
    with pytest.raises((ValueError, TypeError)) as j_err:
        JaxSparkModel(serving_lm).serve(num_slots=2, **jkw)
    with pytest.raises((ValueError, TypeError)) as t_err:
        et.SparkModel(lm, device="cpu").serve(num_slots=2, **kwargs)
    assert (type(t_err.value), str(t_err.value)) == (type(j_err.value), str(j_err.value))


def test_serve_installs_the_resolved_policy(lm):  # noqa: F811
    sm = et.SparkModel(lm, device="cpu")
    assert sm.serve(num_slots=2).policy is None
    engine = sm.serve(num_slots=2, tenants={"a": 1.0, "b": 3.0})
    assert isinstance(engine.policy, tpol.FairSharePolicy)
    assert engine.policy.tenants == {"a": 1.0, "b": 3.0}
    assert isinstance(sm.serve(num_slots=2, policy="fifo").policy, tpol.FifoPolicy)
    r = engine.submit([2, 3, 4, 5], 4, tenant="b", ttft_deadline_ms=5000.0)
    engine.run()
    assert r.done and engine.stats()["tenants"]["b"]["admitted"] == 1
