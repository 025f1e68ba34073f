"""The port's telemetry (``elephas_tpu_torch.telemetry``: the registry, the
Prometheus and OpenMetrics exposition, the event tracer, the flight
recorder) and the engine's series, records and introspection against the
JAX package's, on the CPU.

- ``tests/test_telemetry.py``'s ``TestRegistry``, ``TestEventTracer`` and
  the registry half of ``TestSeriesLifecycle`` run on the port as the
  reference wrote them (``tests/_port_cases.py``); the reference's file
  runs them on the JAX package. Its engine cases (``TestEngineScrape``,
  ``TestPrefillStallSemantics``, the engine half of ``TestSeriesLifecycle``,
  ``TestNullMode``) are written out here for the port's LM. The parameter
  server and chaos cases wait for ROADMAP.md Queue A item 4.
- The two registries side by side: the same series render byte for byte
  in both packages (Prometheus and OpenMetrics, escapes, edges, exemplars,
  ``only=`` filters, retirement), and the tracers keep the same logical
  seqs and the same ring.
- The same temperature-0 workload on both engines (fixed; paged with a
  prefix hit and a preemption; speculative; fair share with deadlines):
  every series that wall time does not set is equal by its whole name
  (the instance labels aside), each request's ``explain`` record and its
  traced event names are equal (sequence numbers and wall time aside), and
  ``debug_snapshot`` has the reference's keys but ``compile_stats`` and the
  reference's values mid-run.
- Null mode, checked by whole series names: nothing registers, the plain
  counts of ``stats()`` stay exact while the series read 0.
- The serving files' stats-against-scrape cases (paged, speculative,
  tenants, the quantized engine's families and ``/v1/score``) run on the
  port as the reference wrote them.
"""

import logging
import re
import threading

import numpy as np
import pytest

import elephas_tpu_torch as et
import tests.test_serving_paged as ref_paged
import tests.test_serving_policy as ref_policy
import tests.test_serving_quant as ref_quant
import tests.test_serving_spec as ref_spec
import tests.test_telemetry as ref_telemetry
from elephas_tpu import telemetry as jax_telemetry
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving.policy import FairSharePolicy as JaxFairShare
from elephas_tpu_torch import telemetry
from elephas_tpu_torch.serving import BlockAllocator, InferenceEngine, PrefixCache
from elephas_tpu_torch.fleet import migration
from elephas_tpu_torch.serving.policy import FairSharePolicy, FifoPolicy
from elephas_tpu_torch.serving.prefix_cache import PagedPrefixIndex
from tests._port_cases import port_class, port_namespace
from tests.test_torch_serving import lm  # noqa: F401  (module fixture: the port LM)

PACKAGES = {"jax": jax_telemetry, "torch": telemetry}


@pytest.fixture()
def not_null():
    assert not telemetry.null_mode()
    yield
    assert not telemetry.null_mode()


# -- the reference's registry and tracer cases, on the port -----------------------------

_NS = port_namespace(ref_telemetry, telemetry=telemetry)
TestRegistry = port_class(ref_telemetry.TestRegistry, _NS)
TestEventTracer = port_class(ref_telemetry.TestEventTracer, _NS)
# the component (a parameter server) and engine halves are below or wait for item 4
TestSeriesLifecycle = port_class(ref_telemetry.TestSeriesLifecycle, _NS, skip=(
    "test_component_release_telemetry_bounds_scrape", "test_engine_release_cascades"))


# the reference's stats-against-scrape cases of the serving files, on the port:
# tests/test_serving_paged.py:489, test_serving_spec.py:552,
# test_serving_policy.py:372, test_serving_quant.py:229 and :321 (/v1/score)
test_paged_stats_match_metrics_scrape = port_namespace(ref_paged)[
    "test_paged_stats_match_metrics_scrape"]
test_spec_stats_match_metrics_scrape = port_namespace(ref_spec)[
    "test_spec_stats_match_metrics_scrape"]
test_tenant_stats_match_metrics_scrape = port_namespace(
    ref_policy, FairSharePolicy=FairSharePolicy, FifoPolicy=FifoPolicy)[
    "test_tenant_stats_match_metrics_scrape"]
_QUANT_NS = port_namespace(ref_quant, encode_record=migration.encode_record,
                           decode_record=migration.decode_record)
TestQuantizedEngine = port_class(ref_quant.TestQuantizedEngine, _QUANT_NS,
                                 only=("test_quant_telemetry_exists_in_every_mode",))
TestScore = port_class(ref_quant.TestScore, _QUANT_NS, only=("test_gateway_score_route",))


def test_the_port_keeps_a_registry_and_tracer_of_its_own():
    """Two process-global registries and tracers side by side: a series or
    event of one package is never seen by the other."""
    assert telemetry.registry() is not jax_telemetry.registry()
    assert telemetry.default_tracer() is not jax_telemetry.default_tracer()
    telemetry.registry().counter("elephas_test_port_only_total", "x").inc()
    names = {f.name for f in jax_telemetry.default_registry().collect()}
    assert "elephas_test_port_only_total" not in names
    assert "elephas_test_port_only_total 1" in telemetry.scrape_text().splitlines()


# -- the same series, rendered by both packages -----------------------------------------

def _counters_and_gauges(tel):
    reg = tel.Registry()
    fam = reg.counter("elephas_t_requests_total", "Requests\nserved \\ here",
                      labels=("engine", "tenant"))
    fam.labels(engine="0", tenant='a"b\\c\nd').inc(4)
    fam.labels(engine="1", tenant="x").inc(2.5)
    reg.gauge("elephas_t_slots", "Slots").set(8)
    reg.gauge("elephas_t_ratio", "A float").set(1 / 3)
    reg.gauge("elephas_t_cb", "Callback", labels=("engine",)).labels(
        engine="0").set_function(lambda: 7.5)
    reg.gauge("elephas_t_nan", "Not a number").set(float("nan"))
    reg.gauge("elephas_t_inf", "Infinite").set(float("-inf"))
    reg.gauge("elephas_t_flag", "A bool").set(True)
    return reg


def _histograms(tel):
    reg = tel.Registry()
    h = reg.histogram("elephas_t_ttft_seconds", "TTFT", labels=("engine",))
    for i, v in enumerate((0.0004, 0.001, 0.0010001, 0.3, 12.0, 2.5)):
        h.labels(engine="0").observe(v, exemplar={"rid": str(i)})
    reg.histogram("elephas_t_tokens", "Prompt tokens", labels=("bucket",),
                  buckets=(16, 32, 64)).labels(bucket="32").observe(17)
    return reg


def _retired(tel):
    reg = _counters_and_gauges(tel)
    reg.remove_series(engine="0")
    return reg


SCENARIOS = {"counters_and_gauges": _counters_and_gauges, "histograms": _histograms,
             "retired": _retired}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_render_is_byte_identical_to_the_reference(scenario):
    """The same series render to the same bytes in both packages: the 0.0.4
    text, the OpenMetrics text with exemplars, and ``only=`` filters."""
    regs = {name: SCENARIOS[scenario](tel) for name, tel in PACKAGES.items()}
    for flavor in ("render", "render_openmetrics"):
        out = {name: getattr(PACKAGES[name], flavor)(reg) for name, reg in regs.items()}
        assert out["torch"] == out["jax"], flavor
    for only in ({"engine": "0"}, {"engine": "1", "tenant": "x"}, {"bucket": "32"}):
        out = {name: PACKAGES[name].render(reg, only=only) for name, reg in regs.items()}
        assert out["torch"] == out["jax"], only


def test_histogram_edges_and_snapshots_match_the_reference():
    """Observations on and beside every default bound land in the same
    buckets, with the same counts, sums and exemplars, in both packages."""
    values = []
    for b in telemetry.DEFAULT_TIME_BUCKETS:
        values += [b, b * (1 - 1e-9), b * (1 + 1e-9)]
    snaps = {}
    for name, tel in PACKAGES.items():
        h = tel.Registry().histogram("elephas_t_edges_seconds", "x")
        for i, v in enumerate(values):
            h.observe(v, exemplar={"rid": str(i)})
        snaps[name] = (h.snapshot(), h.exemplars())
    assert telemetry.DEFAULT_TIME_BUCKETS == jax_telemetry.DEFAULT_TIME_BUCKETS
    assert snaps["torch"] == snaps["jax"]


@pytest.mark.parametrize("capacity,n", [(8, 20), (64, 10)])
def test_tracer_seqs_and_ring_match_the_reference(capacity, n):
    """Instants, spans and completes get the same logical seqs and the ring
    keeps the same events in both packages (wall time and thread aside)."""
    out = {}
    for name, tel in PACKAGES.items():
        tr = tel.EventTracer(capacity=capacity)
        for i in range(n):
            tr.emit("e", i=i)
            with tr.span("s", i=i) as sp:
                sp.set(done=True)
            tr.complete("c", 0.5, i=i)
        out[name] = [(e["name"], e["ph"], e["seq"], e.get("seq_begin"), e["args"])
                     for e in tr.events()]
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) == min(capacity, 3 * n)


def test_trace_scope_is_thread_local():
    """A scope on one thread stamps only that thread's events; another
    thread's scope stamps its own, at the same time."""
    tr = telemetry.default_tracer()
    mark = tr.seq
    barrier = threading.Barrier(2)

    def work(trace_id):
        with telemetry.trace_scope(trace_id):
            barrier.wait()
            tr.emit("fleettest.scoped", who=trace_id)
            barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("t-a", "t-b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert telemetry.current_trace() is None
    events = tr.events(since_seq=mark, name="fleettest.scoped")
    assert sorted((e["args"]["who"], e["args"]["trace"]) for e in events) == [
        ("t-a", "t-a"), ("t-b", "t-b")]


def test_flight_recorder_matches_the_reference():
    """The bounded ring keeps the newest records in both packages, a
    re-filed rid moving to the end."""
    rings = {name: tel.FlightRecorder(3) for name, tel in PACKAGES.items()}
    for ring in rings.values():
        for rid in (1, 2, 3, 1, 4):
            ring.record(rid, {"rid": rid})
    assert rings["torch"].rids() == rings["jax"].rids() == [3, 1, 4]
    with pytest.raises(ValueError):
        telemetry.FlightRecorder(0)


# -- the engines' series, records and snapshots on the same workload ----------------------

WALL = re.compile(r"^elephas_serving_(ttft|inter_token)_seconds_(bucket|sum)\{")
PROMPT_A = [2, 3, 4, 5, 2, 3, 4, 5]
PROMPT_C = [3, 4, 5, 2, 3, 4, 5, 2]


def _fixed(engine):
    for p, n in (([2, 3, 4, 5], 6), ([4, 5], 3), ([3, 4, 5, 2, 3], 5), ([5, 2, 3], 4)):
        engine.submit(p, n)


def _paged(engine):
    engine.submit(PROMPT_A, 2)
    engine.run()
    engine.submit(PROMPT_A, 12, priority=0)
    engine.step()
    engine.step()
    engine.submit(PROMPT_C, 6, priority=1)


def _spec(engine):
    for p in (PROMPT_A, PROMPT_C[:5], [2, 3, 4]):
        engine.submit(p, 10)


def _fair(engine):
    for i, p in enumerate((PROMPT_A, [2, 3], PROMPT_C, [4, 5, 2], [3, 4, 5, 2, 3])):
        engine.submit(p, 6, tenant="ab"[i % 2], ttft_deadline_ms=60000.0 * (i % 2 + 1))
    engine.submit([2, 3, 4, 5] * 4, 14, tenant="a")  # past the queue bound: refused


CONFIGS = {
    "fixed": (dict(num_slots=2, steps_per_sync=2, prefix_cache=True, prefill_chunk=4), _fixed),
    "paged": (dict(num_slots=2, paged=True, block_size=4, num_blocks=8, preemption=True,
                   prefix_cache=True), _paged),
    "spec": (dict(num_slots=2, speculative=True, spec_k=2), _spec),
    "fair": (dict(num_slots=2, policy="fair"), _fair),
}


def _engine(package, model, options):
    options = dict(options)
    if options.get("policy") == "fair":
        policy = JaxFairShare if package == "jax" else FairSharePolicy
        options["policy"] = policy({"a": 1.0, "b": 3.0}, max_queue_tokens=60)
    return (JaxEngine if package == "jax" else InferenceEngine)(model, **options)


def _labels(engine):
    sched = engine.scheduler
    cache = sched.prefix_cache if sched.prefix_cache is not None else sched.prefix_index
    out = {"engine": engine.telemetry_label, "scheduler": sched.telemetry_label}
    if cache is not None:
        out["cache"] = cache.telemetry_label
    return out


def _series(engine, tel):
    """The engine's series (its engine=, scheduler= and cache= labels), the
    instance labels named by their kind, wall-time buckets and sums out."""
    labels = _labels(engine)
    text = engine.scrape(full=False)
    if "cache" in labels:
        text += tel.render(engine._telemetry_registry, only={"cache": labels["cache"]})
    out = []
    for line in text.splitlines():
        if WALL.match(line):
            continue
        for kind, value in labels.items():
            line = line.replace(f'{kind}="{value}"', f'{kind}="{kind}"')
        out.append(line)
    return out


def _strip(obj, base):
    """``obj`` with sequence numbers and wall time dropped and rids (values
    of ``rid``, keys of ``offloaded``, numbers in messages) taken relative to
    their scheduler's ``base``: each package's schedulers mint rids from
    their own count."""
    if isinstance(obj, dict):
        def key(k):  # slot numbers stay, rids (>= a nonzero base) move
            return str(int(k) - base) if k.isdigit() and int(k) >= base > 0 else k

        return {key(k): (v - base if k == "rid" and isinstance(v, int) else _strip(v, base))
                for k, v in obj.items() if k not in ("seq", "submit_seq", "ttft_s")}
    if isinstance(obj, (list, tuple)):
        return [_strip(v, base) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"\b\d{7,}\b", lambda m: str(int(m.group()) - base), obj)
    return obj


def _trace_names(tel, mark, rid):
    return [e["name"] for e in sorted(tel.default_tracer().events(since_seq=mark),
                                      key=lambda e: e["seq"])
            if e["args"].get("rid") == rid]


def _drive(package, model, config):
    """One engine of ``package`` through ``config``'s workload: its series,
    records, traced event names and a snapshot after its second step."""
    tel = PACKAGES[package]
    mark = tel.default_tracer().seq
    options, scenario = CONFIGS[config]
    engine = _engine(package, model, options)
    scenario(engine)
    snap = None
    steps = 0
    while engine.scheduler.has_work:
        engine.step()
        steps += 1
        if steps == 2:
            snap = engine.debug_snapshot()
    base = engine.scheduler.rid_base
    rids = sorted(set(engine.finished) | set(engine._flight_live))
    out = {
        "series": _series(engine, tel),
        "records": {rid - base: _strip(engine.explain(rid), base) for rid in rids},
        "events": {rid - base: _trace_names(tel, mark, rid) for rid in rids},
        "snapshot_keys": set(engine.debug_snapshot()),
        "snapshot": _strip({k: v for k, v in (snap or {}).items()
                            if k not in ("engine", "compile_stats", "backend_fallback")}, base),
        "stats": engine.stats(),
    }
    engine.release_telemetry()
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_series_records_and_snapshots_match_the_reference(serving_lm, lm, config):  # noqa: F811
    """The same temperature-0 workload on the JAX engine and the port's:
    every non-wall-clock series equal by its whole name, each request's
    lifecycle record and traced event names equal, and the mid-run
    ``debug_snapshot`` equal but for ``compile_stats`` (no counterpart) and
    ``backend_fallback`` (the port's is always None)."""
    want, got = _drive("jax", serving_lm, config), _drive("torch", lm, config)
    assert got["series"] == want["series"]
    assert got["records"] == want["records"]
    assert got["events"] == want["events"]
    assert got["snapshot_keys"] == want["snapshot_keys"] - {"compile_stats"}
    assert got["snapshot"] == want["snapshot"]
    for key in ("total_generated", "finished", "preemptions", "resumes", "rejected",
                "admission_rejected", "spec_draft_tokens", "spec_accepted_tokens",
                "kv_quant_offload_bytes", "migrated_out", "migrated_in", "weight_version"):
        assert got["stats"][key] == want["stats"][key], key
    assert any(r["finish"] is not None for r in got["records"].values())
    if config == "paged":
        assert any(r["preemptions"] for r in got["records"].values())
    if config == "spec":
        assert any(r["spec_rounds"] for r in got["records"].values())
    if config == "fair":
        assert any(r["finish"]["reason"] == "rejected_admission"
                   for r in got["records"].values())


# -- the reference's engine cases, on the port ------------------------------------------

def test_scrape_covers_serving_counters_no_drift(not_null, lm):  # noqa: F811
    """``tests/test_telemetry.py:359`` on the port."""
    engine = InferenceEngine(lm, num_slots=4, prefix_cache=True)
    out = engine.run([([2, 3, 4, 5], 6), ([2, 3, 4, 5], 6), ([3, 4, 5], 4)])
    assert len(out) == 3
    text = engine.scrape()
    eid = engine.telemetry_label
    assert (f'elephas_serving_tokens_generated_total{{engine="{eid}"}} '
            f"{engine.total_generated}") in text.splitlines()
    assert engine.total_generated == sum(len(s) for s in out.values()) - (4 + 4 + 3)
    assert f'elephas_serving_requests_finished_total{{engine="{eid}"}} 3' in text.splitlines()
    assert f'elephas_serving_ttft_seconds_count{{engine="{eid}"}} 3' in text.splitlines()
    stats = engine.stats()
    assert stats["total_generated"] == engine.total_generated and stats["finished"] == 3
    cache = engine.scheduler.prefix_cache
    assert cache.stats()["hits"] == cache.hits
    assert (f'elephas_prefix_cache_hits_total{{cache="{cache.telemetry_label}"}} '
            f"{cache.hits}") in text.splitlines()
    sid = engine.scheduler.telemetry_label
    admissions = sum(int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                     if line.startswith("elephas_serving_admissions_total{")
                     and f'scheduler="{sid}"' in line)
    assert admissions == 3
    engine.release_telemetry()


def test_spark_model_scrape(not_null, lm):  # noqa: F811
    """``tests/test_telemetry.py:406`` on the port: SparkModel.scrape()
    renders the port's registry."""
    marker = telemetry.registry().counter("elephas_test_spark_scrape_total", "marker")
    marker.inc()
    assert "elephas_test_spark_scrape_total 1" in \
        et.SparkModel(lm, device="cpu").scrape().splitlines()


def test_engine_release_cascades(not_null, lm):  # noqa: F811
    """``tests/test_telemetry.py:599`` on the port, paged too: the engine's,
    its scheduler's and its cache's series retire; the views still read."""
    for options in (dict(prefix_cache=True), dict(prefix_cache=True, paged=True, block_size=4)):
        engine = InferenceEngine(lm, num_slots=2, **options)
        engine.run([([2, 3, 4, 5], 4)])
        labels = [f'{k}="{v}"' for k, v in _labels(engine).items()]
        assert len(labels) == 3 and all(lbl in telemetry.scrape_text() for lbl in labels)
        engine.release_telemetry()
        text = telemetry.scrape_text()
        assert not any(lbl in text for lbl in labels)
        assert engine.total_generated > 0


def test_gateway_release_retires_its_series_and_its_watchdogs(lm):  # noqa: F811
    """A gateway's series and those of the watchdog it built retire with its
    release_telemetry; a watchdog passed in is the caller's to retire."""
    from elephas_tpu_torch.serving import Gateway

    engine = InferenceEngine(lm, num_slots=1)
    gw = Gateway(engine)
    mine = telemetry.Watchdog()
    other = Gateway(engine, watchdog=mine)
    labels = (f'gateway="{gw.telemetry_label}"', f'watchdog="{gw.watchdog.telemetry_label}"')
    assert all(lbl in telemetry.scrape_text() for lbl in labels)
    gw.release_telemetry()
    other.release_telemetry()
    text = telemetry.scrape_text()
    assert not any(lbl in text for lbl in labels)
    assert f'watchdog="{mine.telemetry_label}"' in text
    mine.release_telemetry()
    engine.release_telemetry()


def test_lone_long_prompt_never_counts_as_stalled(not_null, lm):  # noqa: F811
    """``tests/test_telemetry.py:618`` on the port."""
    engine = InferenceEngine(lm, num_slots=4, prefill_chunk=4, prefill_budget=4)
    assert len(engine.run([([2, 3, 4, 5] * 4, 4)])) == 1
    assert engine._m_prefill_stalls.value == 0
    engine.release_telemetry()


def test_concurrent_long_prompts_count_deferred_slots(not_null, lm):  # noqa: F811
    """``tests/test_telemetry.py:636`` on the port."""
    engine = InferenceEngine(lm, num_slots=4, prefill_chunk=4, prefill_budget=4)
    assert len(engine.run([([2, 3, 4, 5] * 4, 4), ([2, 3, 4, 5] * 4, 4)])) == 2
    assert engine._m_prefill_stalls.value > 0
    engine.release_telemetry()


def test_match_len_probe_is_pure_and_admission_consistent():
    """``tests/test_serving_trace.py:393`` on the port: the caches' pure
    warmth probes equal what admission would commit."""
    cache = PrefixCache()
    cache.insert(0, [2, 3, 4, 5, 2, 3])
    for probe, want in (([2, 3, 4, 5, 2, 3, 9, 9], 6), ([2, 3, 4, 9], 3), ([9, 9], 0),
                        ([2, 3, 4, 5, 2, 3], 5)):
        assert cache.match_len(probe) == want == cache.match(probe)[1]
    assert cache.stats()["hits"] == 0 and cache.stats()["misses"] == 0
    alloc = BlockAllocator(8, 4)
    idx = PagedPrefixIndex(alloc)
    idx.insert([2, 3, 4, 5, 2, 3, 4, 5], alloc.alloc(2))
    assert idx.match_len([2, 3, 4, 5, 2, 3, 4, 5, 9]) == 8
    assert idx.match_len([2, 3, 4, 5, 9]) == 4 == idx.match([2, 3, 4, 5, 9])[1]
    assert idx.match_len([2, 3, 4, 5]) == 0 and idx.match_len([9]) == 0
    assert idx.stats()["hits"] == 0 and idx.stats()["misses"] == 0


def test_tenant_queue_gauges_hold_no_engine_alive(lm):  # noqa: F811
    """The per-tenant queue gauges read the live queue through a weak
    reference: a dropped engine's scheduler is not kept by the registry,
    and its gauges then read 0."""
    import gc
    import weakref

    engine = InferenceEngine(lm, num_slots=1, policy=FairSharePolicy({"a": 1.0}))
    engine.submit([2, 3], 2, tenant="a")
    eid, sid = engine.telemetry_label, engine.scheduler.telemetry_label
    line = f'elephas_serving_tenant_queue_depth{{engine="{eid}",tenant="a"}} 1'
    assert line in telemetry.scrape_text().splitlines()
    sched = weakref.ref(engine.scheduler)
    del engine
    gc.collect()
    assert sched() is None
    assert line.replace("} 1", "} 0") in telemetry.scrape_text().splitlines()
    telemetry.remove_series(engine=eid)
    telemetry.remove_series(scheduler=sid)


# -- null mode, by whole series names ---------------------------------------------------

def test_null_metrics_and_tracer_are_noops(not_null):
    """``tests/test_telemetry.py:157`` on the port, the last check by the
    series' whole name (the reference's substring test also matches
    ``elephas_serving_migrated_in_total``)."""
    was = telemetry.set_null(True)
    try:
        assert was is False
        reg = telemetry.registry()
        c = reg.counter("n_total", "x")
        c.inc(100)
        assert c.value == 0
        reg.histogram("n_seconds", "x").observe(1.0)
        reg.gauge("n_g", "x").set(5)
        assert reg.render() == ""
        tr = telemetry.tracer()
        assert tr.emit("never") == -1
        with tr.span("never") as sp:
            sp.set(ok=True)
        assert tr.events() == []
    finally:
        telemetry.set_null(False)
    names = {f.name for f in telemetry.default_registry().collect()}
    assert not names & {"n_total", "n_seconds", "n_g"}


def test_null_engine_registers_nothing_and_keeps_exact_counts(not_null, lm):  # noqa: F811
    """``tests/test_telemetry.py:178`` on the port: an engine built under
    null mode registers no series (by whole name: none carries its label),
    scrapes empty, records no lifecycle, and its plain counts stay exact
    while its series read 0 (the reference's stats() reads the series, so
    its counts read 0 there)."""
    was = telemetry.set_null(True)
    try:
        engine = InferenceEngine(lm, num_slots=4, paged=True, block_size=4,
                                 policy=FairSharePolicy({"a": 1.0}))
    finally:
        telemetry.set_null(was)
    out = engine.run([([2, 3, 4], 4), ([3, 4, 5], 4)])
    assert len(out) == 2 and all(len(seq) == 7 for seq in out.values())
    assert engine.scrape() == "" and engine._flight is None
    assert engine.total_generated == 8 and engine.stats()["finished"] == 2
    assert engine._m_tokens.value == 0
    label = re.compile(rf'\b(engine|scheduler)="({engine.telemetry_label}|'
                       rf'{engine.scheduler.telemetry_label})"')
    for fam in telemetry.default_registry().collect():
        for values, _child in fam.series():
            assert not label.search(",".join(f'{k}="{v}"' for k, v in
                                             zip(fam.labelnames, values))), fam.name


def test_null_engine_eviction_warning_stays_rate_limited(not_null, lm, caplog):  # noqa: F811
    """``tests/test_telemetry.py:195`` on the port: the warning cadence runs
    on a plain count, so null mode cannot turn it into a flood."""
    was = telemetry.set_null(True)
    try:
        engine = InferenceEngine(lm, num_slots=2)
    finally:
        telemetry.set_null(was)
    engine._finished_bound = 2
    engine.finished = {rid: object() for rid in range(6)}
    with caplog.at_level(logging.WARNING, logger="elephas_tpu_torch.serving.engine"):
        engine._evict_finished()
    assert len(engine.finished) == 2 and engine.finished_evicted == 4
    assert sum("finished-request registry" in r.message for r in caplog.records) == 1


def test_flight_recorder_default_and_records_match_the_engines(serving_lm, lm):  # noqa: F811
    """Both engines record by default with the reference's capacity, 256."""
    port, ref = InferenceEngine(lm, num_slots=1), JaxEngine(serving_lm, num_slots=1)
    assert port._flight.capacity == ref._flight.capacity == 256
    assert np.all([port.debug_snapshot()["flight_recorder"]["capacity"] == 256])
    port.release_telemetry()
    ref.release_telemetry()
