"""The port's HTTP/SSE front door (``elephas_tpu_torch.serving.gateway``)
and its migration wire (``elephas_tpu_torch.fleet.migration``) against the
JAX package's, on the CPU.

- The reference's cases of ``tests/test_serving_gateway.py`` run on the
  port: each test function is the reference's own code, its globals
  rebound and its ``elephas_tpu`` imports resolved to ``elephas_tpu_torch``
  (``tests/_port_cases.py``), over a port engine on the trained ``serving_lm``
  weights. Two are written out here instead:
  ``test_serve_gateway_context_manager`` (the port's ``SparkModel`` needs
  ``device="cpu"``) and ``test_stop_severs_live_sse_and_releases_port``,
  which holds the stream live at ``stop()`` by parking the engine after
  its first token instead of racing the tokens (the reference's version
  fails when the 25 tokens outrun it).
- ``tests/test_serving_trace.py``'s cases, written out for the port: no
  ``jit.compile`` span (the port compiles no programs) and no
  ``compile_stats`` key in ``/debug/engine``.
- ``tests/test_telemetry_fleet.py``'s watchdog rule cases (``:534-757``)
  rebound to the port's telemetry, and its
  ``test_engine_stall_detected_and_cleared`` (``:848``) with a local
  engine staller (the reference's ``fault.harness.EngineStaller`` is
  ROADMAP.md Queue A item 4b, and so is the merged-trace case at ``:888``, which reads
  ``telemetry/merge.py``).
- SSE tokens equal the port's in-process engine and the JAX engine.
- Migration wire v3: ``encode_record`` of the same numpy record is the
  same bytes in both packages, each decodes the other's, a record exported
  from the JAX paged engine continues token-exact on the port's and the
  other way, and inside the port an export → import round trip keeps the
  stored bytes of the fp, int8 and int4 pools.
"""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import tests.test_serving_gateway as ref_gateway
import tests.test_telemetry_fleet as ref_fleet
from elephas_tpu.fleet import migration as jax_migration
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu_torch import telemetry
from elephas_tpu_torch.fleet import migration
from elephas_tpu_torch.serving import Drafter, Gateway, InferenceEngine
from elephas_tpu_torch.serving.paged_kv import blocks_for, gather_blocks
from elephas_tpu_torch.serving.policy import FairSharePolicy
from elephas_tpu_torch.telemetry import watch
from tests._port_cases import port_class, port_namespace
from tests.test_torch_serving import lm  # noqa: F401  (module fixture: the port LM)

# -- the reference's cases, rebound to the port -----------------------------

_GATEWAY_NS = port_namespace(ref_gateway, FairSharePolicy=FairSharePolicy)


def _port_case(name):
    """The reference's test function ``name`` of test_serving_gateway.py,
    run on the port."""
    return _GATEWAY_NS[name]


@pytest.fixture(scope="module")
def gw(lm):  # noqa: F811
    """One shared port engine and gateway for the read-mostly cases, as the
    reference's fixture builds them."""
    engine = InferenceEngine(lm, num_slots=2, policy=FairSharePolicy({"a": 1.0, "b": 1.0}))
    gateway = Gateway(engine, port=0).start()
    engine.gateway = gateway
    yield gateway
    engine.close()
    gateway.release_telemetry()
    engine.release_telemetry()


test_concurrent_sse_streams_token_exact_vs_inprocess = _port_case(
    "test_concurrent_sse_streams_token_exact_vs_inprocess")
test_nonstream_returns_one_json_document = _port_case("test_nonstream_returns_one_json_document")
test_validation_and_routing_errors_are_loud = _port_case(
    "test_validation_and_routing_errors_are_loud")
test_metrics_and_stats_routes = _port_case("test_metrics_and_stats_routes")
test_backpressure_429_with_retry_after = _port_case("test_backpressure_429_with_retry_after")
test_driver_crash_tears_gateway_down = _port_case("test_driver_crash_tears_gateway_down")
test_keepalive_serves_multiple_requests_per_connection = _port_case(
    "test_keepalive_serves_multiple_requests_per_connection")
test_keepalive_client_close_honored = _port_case("test_keepalive_client_close_honored")
test_keepalive_generate_json_then_stats_same_socket = _port_case(
    "test_keepalive_generate_json_then_stats_same_socket")
test_batch_generate_json_array = _port_case("test_batch_generate_json_array")
test_batch_generate_sse_multiplexed = _port_case("test_batch_generate_sse_multiplexed")
test_batch_generate_partial_failure_isolated = _port_case(
    "test_batch_generate_partial_failure_isolated")
test_batch_generate_validation = _port_case("test_batch_generate_validation")
test_oversized_body_still_answers_413 = _port_case("test_oversized_body_still_answers_413")
test_transfer_encoding_refused_loudly = _port_case("test_transfer_encoding_refused_loudly")
test_handler_crash_counts_a_500 = _port_case("test_handler_crash_counts_a_500")
test_get_with_body_keeps_framing = _port_case("test_get_with_body_keeps_framing")
test_batch_generate_bad_shared_field_is_400 = _port_case(
    "test_batch_generate_bad_shared_field_is_400")
test_batch_generate_one_token_requests_deliver = _port_case(
    "test_batch_generate_one_token_requests_deliver")
test_keepalive_ignores_blank_line_between_requests = _port_case(
    "test_keepalive_ignores_blank_line_between_requests")

_request = _GATEWAY_NS["_request"]
_one_shot = _GATEWAY_NS["_one_shot"]


def _released(port, within=15.0) -> bool:
    """Whether ``port`` can be bound again (even with SO_REUSEADDR a
    listening or half-open socket refuses) within ``within`` seconds."""
    deadline = time.monotonic() + within
    while True:
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind(("127.0.0.1", port))
            return True
        except OSError:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        finally:
            probe.close()


def test_stop_severs_live_sse_and_releases_port(lm):  # noqa: F811
    """The reference's case (``tests/test_serving_gateway.py:212``) with the
    stream held live by construction: after the request's first token every
    step of the engine waits for the gateway to stop, so ``engine.close()``
    meets a live stream whatever the speed of the host, severs it (no
    ``event: done``) and releases the port."""
    engine = InferenceEngine(lm, num_slots=1)
    gateway = Gateway(engine, port=0).start()
    engine.gateway = gateway
    port = gateway.port
    assert not _released(port, within=0.0)  # while listening, a rebind fails
    step = engine.step

    def step_until_first_token():
        if engine.total_generated:  # the stream is live: park until stop()
            gateway._stopping.wait()
            return []
        return step()

    engine.step = step_until_first_token
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/generate", body=json.dumps(
        {"prompt": [2, 3, 4], "max_new_tokens": 25}), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    head = b""
    while b'"token"' not in head:  # the first token event arrived
        head += resp.readline()
    engine.close()
    leftover = resp.read()  # severed: EOF, not a hang
    assert b"event: done" not in head + leftover  # cut mid-stream, not drained
    conn.close()
    assert _released(port)
    engine.close()  # idempotent
    gateway.release_telemetry()
    engine.release_telemetry()


def test_serve_gateway_context_manager(lm):  # noqa: F811
    """The reference's case (``:304``) on the port: SparkModel.serve(
    gateway_port=0, policy=, tenants=) returns an engine whose with block
    stops the gateway and frees the port."""
    import elephas_tpu_torch as et

    with et.SparkModel(lm, device="cpu").serve(
            num_slots=2, gateway_port=0, policy="fair", tenants={"a": 1.0}) as engine:
        assert engine.gateway is not None
        port = engine.gateway.port
        resp, raw = _request(port, "POST", "/v1/generate", {
            "prompt": [2, 3, 4], "max_new_tokens": 4, "tenant": "a",
            "ttft_deadline_ms": 60000, "stream": False})
        assert resp.status == 200
        np.testing.assert_array_equal(json.loads(raw)["full_sequence"],
                                      _one_shot(lm, [2, 3, 4], 4))
    assert engine.gateway is None
    assert _released(port, within=0.0)


def test_serve_gateway_start_failure_retires_series(lm):  # noqa: F811
    """A gateway that cannot bind (its port in use) raises from serve(),
    and neither the engine's nor the gateway's series stay behind."""
    import elephas_tpu_torch as et

    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    def series():
        return [line for line in telemetry.scrape_text().splitlines()
                if not line.startswith("#")]

    before = series()
    try:
        with pytest.raises(OSError):
            et.SparkModel(lm, device="cpu").serve(num_slots=1,
                                                  gateway_port=holder.getsockname()[1])
    finally:
        holder.close()
    assert len(series()) == len(before)


def test_sse_tokens_match_the_port_and_jax_engines(serving_lm, lm, gw):  # noqa: F811
    """SSE tokens over the wire equal the port engine's in process and the
    JAX engine's, at temperature 0 on the trained weights."""
    prompts = ref_gateway.PROMPTS
    jax_engine = JaxEngine(serving_lm, num_slots=2)
    want = [jax_engine.submit(p, 6) for p in prompts]
    jax_engine.run()
    port_engine = InferenceEngine(lm, num_slots=2)
    mine = [port_engine.submit(p, 6) for p in prompts]
    port_engine.run()
    for p, j, m in zip(prompts, want, mine):
        resp, raw = _request(gw.port, "POST", "/v1/generate", {"prompt": p, "max_new_tokens": 6})
        events = ref_gateway._sse_events(raw)
        tokens = [e["token"] for e in events if "token" in e]
        assert resp.status == 200 and events[0]["rid"] == int(resp.getheader("X-Request-Id"))
        assert tokens == list(m.tokens) == [int(t) for t in j.tokens]
    jax_engine.release_telemetry()
    port_engine.release_telemetry()


# -- tests/test_telemetry_fleet.py: the watchdog rules and a stall over a gateway --------

_FLEET_NS = port_namespace(
    ref_fleet, telemetry=telemetry, Registry=telemetry.Registry, Watchdog=watch.Watchdog,
    **{name: getattr(watch, name) for name in (
        "BlocksExhaustedRule", "DecodeStallRule", "HeartbeatStaleRule", "JournalLagRule",
        "PsUnreachableRule", "QueueStallRule", "SloBurnRule", "SpecCollapseRule")})


# tests/test_telemetry_fleet.py:533-760 on the port's watchdog (the fleet-scraper
# case waits for telemetry/aggregate.py, ROADMAP.md Queue A item 4b), and :51-108 on
# the port's tracer: the trace context is thread-local, scopes nest, events are stamped
TestWatchdogRules = port_class(ref_fleet.TestWatchdogRules, _FLEET_NS,
                               skip=("test_watchdog_over_fleet_scraper",))
TestTraceContext = port_class(ref_fleet.TestTraceContext, _FLEET_NS)


class _EngineStaller:
    """The reference's ``fault.harness.EngineStaller``: while active the
    engine's ``step`` does nothing, so queued work stays queued."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        def stalled_step():
            time.sleep(0.01)
            return []

        self.engine.step = stalled_step
        return self

    def __exit__(self, *exc):
        del self.engine.step


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


class _EngineSeries:
    """A watchdog source that reads one engine's series (its engine= and
    scheduler= labels) out of the port's registry: the process registry
    also holds the series of engines other tests left with queued requests,
    which would keep the process-wide stall rules firing (the reference's
    case is order-dependent for this reason)."""

    def __init__(self, engine):
        self.labels = {"engine": engine.telemetry_label,
                       "scheduler": engine.scheduler.telemetry_label}

    def series(self, name):
        for fam in telemetry.default_registry().collect():
            if fam.name == name and fam.kind != "histogram":
                rows = [dict(zip(fam.labelnames, values)) for values, _c in fam.series()]
                return [(labels, float(child.value))
                        for labels, (_v, child) in zip(rows, fam.series())
                        if all(labels.get(k, v) == v for k, v in self.labels.items())]
        return []


def test_engine_stall_detected_and_cleared(lm):  # noqa: F811
    """``tests/test_telemetry_fleet.py:848`` on the port: a stalled engine
    behind a gateway raises decode_stall or queue_stall in /healthz's
    anomalies, which clear once steps resume and the queue drains. The
    gateway's watchdog (the default rules) reads this engine's series
    only."""
    engine = InferenceEngine(lm, num_slots=2)
    gw = Gateway(engine, port=0,
                 watchdog=telemetry.Watchdog(source=_EngineSeries(engine))).start()
    try:
        done = threading.Event()
        with gw._engine_lock:
            engine.submit([2, 3, 4], 3, on_token=lambda t, d: done.set() if d else None)
        gw._work.set()
        assert done.wait(120)
        assert _get(gw.port, "/healthz")[1]["anomalies"]["critical"] == 0
        with _EngineStaller(engine):
            with gw._engine_lock:
                engine.submit([3, 4, 5], 3)  # queues; the step is stalled
            gw._work.set()
            deadline = time.monotonic() + 60
            rules = set()
            while time.monotonic() < deadline:
                rules = {a["rule"] for a in _get(gw.port, "/healthz")[1]["anomalies"]["active"]}
                if {"decode_stall", "queue_stall"} & rules:
                    break
                time.sleep(0.05)
            assert {"decode_stall", "queue_stall"} & rules, rules
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            report = _get(gw.port, "/healthz")[1]["anomalies"]
            if not report["active"]:
                break
            time.sleep(0.05)
        assert report["active"] == []
        assert gw.watchdog.report()["cleared_total"] >= 1
    finally:
        gw.stop()
        gw.release_telemetry()
        gw.watchdog.release_telemetry()
        engine.release_telemetry()


# -- tests/test_serving_trace.py on the port ------------------------------------------

# the serving_lm fixture trains on period-4 sequences over tokens 2..5
PROMPT_A = [2, 3, 4, 5, 2, 3, 4, 5]
PROMPT_C = [3, 4, 5, 2, 3, 4, 5, 2]


class PeriodicDrafter(Drafter):
    """The reference test's drafter: the next tokens of the period-4 cycle,
    so every round drafts."""

    def propose(self, req, k):
        last = req.full_sequence[-1]
        out = []
        for _ in range(k):
            last = (last - 2 + 1) % 4 + 2
            out.append(int(last))
        return out


@pytest.fixture(scope="module")
def traced(lm):  # noqa: F811
    """One paged + preemption + prefix + speculative + policy engine behind
    a gateway, as the reference's trace fixture builds it."""
    engine = InferenceEngine(
        lm, num_slots=2, paged=True, block_size=4, num_blocks=8, preemption=True,
        prefix_cache=True, speculative=True, spec_k=2, spec_drafter=PeriodicDrafter(),
        policy=FairSharePolicy({"t": 1.0}), flight_recorder=16,
    )
    gateway = Gateway(engine, port=0).start()
    engine.gateway = gateway
    yield engine, gateway
    engine.close()
    gateway.release_telemetry()
    engine.release_telemetry()


def _trace_request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    hdrs = dict(headers or {})
    if body is not None:
        hdrs.setdefault("Content-Type", "application/json")
    conn.request(method, path, body=None if body is None else json.dumps(body), headers=hdrs)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_gateway_lifecycle_trace_reconstruction(traced, tmp_path):
    """``tests/test_serving_trace.py:97`` on the port (less its jit.compile
    span): a prefix hit streamed to its first token, preempted by a
    higher-priority arrival, resumed and finished tells the same rid-stamped
    story in explain(), the wire trace route, the Chrome-trace export and a
    TTFT exemplar."""
    engine, gw = traced
    port = gw.port
    resp, raw = _trace_request(port, "POST", "/v1/generate", {
        "prompt": PROMPT_A, "max_new_tokens": 2, "tenant": "t", "stream": False})
    assert resp.status == 200
    assert resp.getheader("X-Request-Id") == str(json.loads(raw)["rid"])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/generate", body=json.dumps({
        "prompt": PROMPT_A, "max_new_tokens": 20, "tenant": "t", "priority": 0}),
        headers={"Content-Type": "application/json"})
    b_resp = conn.getresponse()
    assert b_resp.status == 200
    b_lines = []
    while True:
        line = b_resp.readline()
        assert line, "B's stream ended before its first token"
        b_lines.append(line)
        if line.startswith(b"data: ") and b"token" in line:
            break
    b_rid = int(b_resp.getheader("X-Request-Id"))
    resp, raw = _trace_request(port, "POST", "/v1/generate", {
        "prompt": PROMPT_C, "max_new_tokens": 8, "tenant": "t", "priority": 1, "stream": False})
    assert resp.status == 200
    c_rid = json.loads(raw)["rid"]
    assert resp.getheader("X-Request-Id") == str(c_rid)
    rest = b_resp.read()
    conn.close()
    events = ref_gateway._sse_events(b"".join(b_lines) + rest)
    assert events[0]["rid"] == b_rid
    b_tokens = [e["token"] for e in events if "token" in e]
    assert len(b_tokens) == 20 and events[-1]["error"] is None
    deadline = time.monotonic() + 10
    while True:
        rec = engine.explain(b_rid)
        if rec["finish"] is not None:
            break
        assert time.monotonic() < deadline, "record never finalized"
        time.sleep(0.01)
    assert rec["rid"] == b_rid and rec["tenant"] == "t"
    assert rec["verdict"]["admitted"] is True
    assert isinstance(rec["verdict"]["virtual_counters"], dict)
    assert rec["admission_kind"] == "prefix_hit" and rec["reuse_len"] == 4
    assert isinstance(rec["queue_wait_steps"], int)
    assert len(rec["preemptions"]) == 1 and len(rec["resumes"]) == 1
    kinds = [a["kind"] for a in rec["admissions"]]
    assert kinds[0] == "prefix_hit" and "resume" in kinds[1:]
    assert rec["spec_rounds"] and any(r["drafted"] >= 1 for r in rec["spec_rounds"])
    assert sum(r["accepted"] for r in rec["spec_rounds"]) == rec["spec_accepted"]
    assert rec["tokens"] == 20 and len(rec["token_steps"]) == 20
    assert rec["token_steps"] == sorted(rec["token_steps"])
    assert rec["chunks"] and rec["finish"]["reason"] == "budget"
    seqs = [rec["submit_seq"], rec["admissions"][0]["seq"], rec["chunks"][0]["seq"],
            rec["first_token"]["seq"], rec["preemptions"][0]["seq"], rec["resumes"][0]["seq"],
            rec["finish"]["seq"]]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs), seqs
    resp, raw = _trace_request(port, "GET", f"/v1/requests/{b_rid}/trace")
    assert resp.status == 200 and resp.getheader("X-Request-Id") == str(b_rid)
    assert json.loads(raw) == json.loads(json.dumps(rec))
    assert _trace_request(port, "GET", "/v1/requests/999999/trace")[0].status == 404
    path = tmp_path / "trace.json"
    telemetry.default_tracer().export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    mine = sorted((e for e in trace if e["args"].get("rid") == b_rid),
                  key=lambda e: e["args"]["seq"])
    names = [e["name"] for e in mine]
    for expected in ("serve.submit", "serve.admission_verdict", "serve.admit",
                     "serve.prefill_chunk", "serve.first_token", "serve.preempt",
                     "serve.resume", "serve.spec_verify", "serve.finish"):
        assert expected in names, (expected, names)
    assert names.index("serve.submit") < names.index("serve.admit") \
        < names.index("serve.preempt") < names.index("serve.resume") \
        < names.index("serve.finish")
    by_name = {e["name"]: e for e in mine}
    assert by_name["serve.finish"]["args"]["seq"] == rec["finish"]["seq"]
    assert by_name["serve.preempt"]["args"]["seq_begin"] == rec["preemptions"][0]["seq"]
    admits = [e for e in mine if e["name"] == "serve.admit"]
    assert admits[0]["args"]["kind"] == "prefix_hit" and admits[0]["args"]["reuse_len"] == 4
    assert admits[-1]["args"]["kind"] == "resume"
    # the reference also finds a jit.compile span here: the eager port
    # compiles no programs, so none is emitted
    assert not any(e["name"] == "jit.compile" for e in trace)
    resp, raw = _trace_request(port, "GET", "/metrics",
                               headers={"Accept": "application/openmetrics-text"})
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("application/openmetrics-text")
    text = raw.decode()
    assert text.rstrip().endswith("# EOF")
    ttft_ex = [line for line in text.splitlines()
               if line.startswith("elephas_serving_ttft_seconds_bucket")
               and f'engine="{engine.telemetry_label}"' in line and "# {rid=" in line]
    assert ttft_ex, "no TTFT exemplar in the OpenMetrics scrape"
    ex_rid = int(ttft_ex[-1].split('rid="')[1].split('"')[0])
    ex_val = float(ttft_ex[-1].rsplit("} ", 1)[1])
    assert engine.explain(ex_rid)["first_token"]["ttft_s"] == pytest.approx(ex_val, rel=1e-6)
    resp, raw = _trace_request(port, "GET", "/metrics")
    assert "# {rid=" not in raw.decode()
    crec = engine.explain(c_rid)
    assert crec["admission_kind"] == "cold" and crec["finish"]["reason"] == "budget"


def test_debug_engine_and_healthz(traced):
    """``tests/test_serving_trace.py:271`` on the port (``compile_stats`` has
    no counterpart: the module docstring of the engine lists it)."""
    engine, gw = traced
    port = gw.port
    resp, raw = _trace_request(port, "GET", "/debug/engine")
    assert resp.status == 200
    snap = json.loads(raw)
    for key in ("slots", "waiting", "queued_tokens", "offloaded", "policy", "flight_recorder",
                "blocks_total", "blocks_free", "prefix_index"):
        assert key in snap, key
    assert "compile_stats" not in snap and snap["backend_fallback"] is None
    assert snap["engine"] == engine.telemetry_label
    assert snap["weight_version"] == engine.weight_version
    assert snap["policy"]["name"] == "FairSharePolicy"
    assert snap["flight_recorder"]["capacity"] == 16 and snap["blocks_total"] == 8
    assert engine.debug_snapshot()["blocks_total"] == 8
    resp, raw = _trace_request(port, "GET", "/healthz")
    assert resp.status == 200
    hz = json.loads(raw)
    assert hz["status"] == "ok" and hz["driver_alive"] is True
    assert hz["weight_version"] == engine.weight_version and hz["backend_fallback"] is None
    grace = gw.health_stall_grace
    gw.health_stall_grace = -1.0
    gw._hz_anchor = (engine.scheduler._steps, time.monotonic())
    try:
        with gw._engine_lock:
            engine.scheduler.waiting.append(engine.scheduler.make_request([2, 3], 1))
            try:
                resp, raw = _trace_request(port, "GET", "/healthz")
                assert resp.status == 503 and json.loads(raw)["status"] == "stalled"
            finally:
                engine.scheduler.waiting.pop()
    finally:
        gw.health_stall_grace = grace


def test_healthz_driver_dead_is_503(lm):  # noqa: F811
    """``tests/test_serving_trace.py:320`` on the port, and the driver's own
    death: an engine error in the driver thread answers 503 driver-dead
    while the teardown runs (held here on its latch), then the port
    closes."""
    engine = InferenceEngine(lm, num_slots=1, flight_recorder=0)
    gateway = Gateway(engine, port=0).start()
    try:
        gateway._stopping.set()  # the driver exits; the loop keeps serving
        deadline = time.monotonic() + 10
        while gateway._driver_thread.is_alive():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        resp, raw = _trace_request(gateway.port, "GET", "/healthz")
        assert resp.status == 503 and json.loads(raw)["status"] == "driver-dead"
    finally:
        engine.close()
        gateway.stop()
    engine = InferenceEngine(lm, num_slots=1)
    gateway = Gateway(engine, port=0).start()
    port = gateway.port

    def boom():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    engine.step = boom
    with gateway._stop_lock:  # the crash's teardown waits on this latch
        with gateway._engine_lock:
            engine.submit([2, 3], 2)
        gateway._work.set()
        deadline = time.monotonic() + 30
        while True:
            resp, raw = _trace_request(port, "GET", "/healthz")
            if resp.status == 503:
                break
            assert time.monotonic() < deadline, raw
            time.sleep(0.02)
        assert json.loads(raw)["status"] == "driver-dead"
    assert _released(port, within=30.0)
    assert "illegal memory access" in str(gateway.driver_error)
    gateway.stop()
    gateway.release_telemetry()
    engine.release_telemetry()


def test_inflight_explain_and_chunked_fixed_arena(lm):  # noqa: F811
    """``tests/test_serving_trace.py:344`` on the port."""
    engine = InferenceEngine(lm, num_slots=2, prefix_cache=True, prefill_chunk=4,
                             flight_recorder=4)
    a = engine.submit(PROMPT_A, 2)
    engine.run()
    assert engine.explain(a.rid)["finish"]["reason"] == "budget"
    b = engine.submit(PROMPT_A, 4)
    engine.step()  # admission and the first budgeted chunk only
    rec = engine.explain(b.rid)
    assert rec["finish"] is None
    assert rec["admission_kind"] == "prefix_hit"
    assert rec["reuse_len"] == len(PROMPT_A) - 1
    engine.run()
    rec = engine.explain(b.rid)
    assert rec["finish"]["reason"] == "budget"
    assert rec["chunks"] and len(rec["token_steps"]) == 4
    stats_before = engine.scheduler.prefix_cache.stats()
    assert engine.prefix_warm_probe(PROMPT_A) == len(PROMPT_A) - 1
    assert engine.prefix_warm_probe([7, 7, 7]) == 0
    assert engine.scheduler.prefix_cache.stats() == stats_before
    engine.release_telemetry()


def test_flight_recorder_ring_bound(lm):  # noqa: F811
    """``tests/test_serving_trace.py:379`` on the port."""
    engine = InferenceEngine(lm, num_slots=1, flight_recorder=2)
    reqs = [engine.submit([2, 3], 1) for _ in range(4)]
    engine.run()
    assert len(engine._flight) == 2
    with pytest.raises(KeyError):
        engine.explain(reqs[0].rid)
    assert engine.explain(reqs[-1].rid)["tokens"] == 1
    engine.release_telemetry()


def test_null_mode_engine_records_nothing(lm):  # noqa: F811
    """``tests/test_serving_trace.py:425`` on the port."""
    tracer = telemetry.default_tracer()
    mark = tracer.seq
    was_null = telemetry.set_null(True)
    try:
        engine = InferenceEngine(lm, num_slots=1)
        req = engine.submit([2, 3, 4], 2)
        engine.run()
        assert len(req.tokens) == 2
        assert engine._flight is None
        with pytest.raises(RuntimeError, match="flight recorder is off"):
            engine.explain(req.rid)
        assert engine.scrape() == ""
    finally:
        telemetry.set_null(was_null)
    assert tracer.events(since_seq=mark) == []


def test_recorder_off_knob_raises_cleanly(lm):  # noqa: F811
    """``tests/test_serving_trace.py:447`` on the port."""
    engine = InferenceEngine(lm, num_slots=1, flight_recorder=0)
    assert engine._flight is None
    with pytest.raises(RuntimeError, match="flight recorder is off"):
        engine.explain(0)
    with pytest.raises(ValueError):
        InferenceEngine(lm, num_slots=1, flight_recorder=-1)
    engine.release_telemetry()


def test_rejected_submit_has_a_record_and_echoes_rid(lm):  # noqa: F811
    """``tests/test_serving_trace.py:461`` on the port."""
    engine = InferenceEngine(lm, num_slots=1, flight_recorder=4,
                             policy=FairSharePolicy({"t": 1.0}, max_queue_tokens=8))
    with Gateway(engine, port=0) as gw:
        resp, raw = _trace_request(gw.port, "POST", "/v1/generate", {
            "prompt": [2, 3, 4, 5], "max_new_tokens": 12, "tenant": "t"})
        assert resp.status == 429
        rid = int(resp.getheader("X-Request-Id"))
        rec = engine.explain(rid)
        assert rec["finish"]["reason"] == "rejected_admission"
        assert rec["verdict"]["admitted"] is False
        assert "admission bound" in rec["verdict"]["reason"]
        resp, raw = _trace_request(gw.port, "GET", f"/v1/requests/{rid}/trace")
        assert resp.status == 200
        assert json.loads(raw)["finish"]["reason"] == "rejected_admission"
    engine.release_telemetry()


def test_trace_route_501_when_recorder_off(lm):  # noqa: F811
    """``tests/test_serving_trace.py:488`` on the port."""
    engine = InferenceEngine(lm, num_slots=1, flight_recorder=None)
    with Gateway(engine, port=0) as gw:
        resp, raw = _trace_request(gw.port, "GET", "/v1/requests/0/trace")
        assert resp.status == 501 and b"flight recorder is off" in raw
    engine.release_telemetry()


# -- migration wire v3 -------------------------------------------------------------------


def _record(kv_dtype, n_blocks=2, seed=0):
    """A v3 export payload of numpy rows at ``kv_dtype``'s stored dtypes."""
    rng = np.random.default_rng(seed)

    def leaves():
        if kv_dtype == "fp":
            return tuple(rng.standard_normal((n_blocks, 4, 2, 16)).astype(np.float32)
                         for _ in range(2))
        dp = 16 if kv_dtype == "int8" else 8
        codes = [rng.integers(-127, 128, (n_blocks, 4, 2, dp)).astype(np.int8) for _ in range(2)]
        return (*codes, *(rng.random((n_blocks, 4, 2)).astype(np.float32) for _ in range(2)))

    return {"version": 3, "kv_dtype": kv_dtype, "weight_ver": 0, "rid": 7,
            "prompt": [2, 3, 4, 5, 2], "tokens": [3, 4], "max_new_tokens": 9,
            "temperature": 0.0, "eos_id": None, "priority": 0, "tenant": None,
            "ttft_deadline_ms": None, "trace": None, "block_size": 4, "cur_len": 6,
            "n_blocks": n_blocks,
            "rows": {"blk0_attn": leaves(), "blk1_attn": leaves()}}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_encode_record_bytes_match_the_reference(kv_dtype):
    """The same numpy record encodes to the same bytes in both packages, and
    each package decodes the other's bytes to the same header and rows."""
    record = _record(kv_dtype)
    mine, theirs = migration.encode_record(record), jax_migration.encode_record(record)
    assert mine == theirs
    assert mine[:4] == migration.MAGIC == jax_migration.MAGIC
    assert migration.VERSION == jax_migration.VERSION == 3
    for decoded in (migration.decode_record(theirs), jax_migration.decode_record(mine)):
        assert {k: v for k, v in decoded.items() if k != "rows"} == {
            k: v for k, v in record.items() if k != "rows"}
        for name, leaves in record["rows"].items():
            assert [np.asarray(a).tobytes() for a in decoded["rows"][name]] == \
                [a.tobytes() for a in leaves]


def test_decode_refuses_what_the_reference_refuses():
    """Bad magic, unknown versions, truncation and trailing bytes raise, as
    in the reference; legacy v1 and v2 frames decode; a bfloat16 row
    travels as its bit pattern and decodes to a torch bfloat16 tensor."""
    good = migration.encode_record(_record("fp"))
    for bad in (b"XXXX" + good[4:], good[:4] + b"\x09\x00" + good[6:], good[:-3],
                good + b"\x00"):
        with pytest.raises(ValueError) as mine:
            migration.decode_record(bad)
        with pytest.raises(ValueError) as theirs:
            jax_migration.decode_record(bad)
        assert str(mine.value) == str(theirs.value)
    head = json.loads(good[10:10 + int.from_bytes(good[6:10], "little")])
    head["version"] = 2
    del head["weight_ver"]
    hb = json.dumps(head).encode()
    v2 = good[:4] + (2).to_bytes(2, "little") + len(hb).to_bytes(4, "little") + hb \
        + good[10 + int.from_bytes(good[6:10], "little"):]
    assert migration.decode_record(v2)["weight_ver"] == 0
    bf = torch.randn(2, 4, 2, 16).to(torch.bfloat16)
    rec = dict(_record("fp"), rows={"blk0_attn": (bf, bf)})
    back = migration.decode_record(migration.encode_record(rec))["rows"]["blk0_attn"][0]
    assert back.dtype == torch.bfloat16 and torch.equal(back, bf)


@pytest.fixture(scope="module")
def paged_pair(serving_lm, lm):  # noqa: F811
    """A JAX and a port paged engine on the trained weights (blocks of 4),
    reused by both migration directions."""
    opts = dict(num_slots=2, paged=True, block_size=4, num_blocks=24)
    return JaxEngine(serving_lm, **opts), InferenceEngine(lm, **opts)


def _start(engine, prompt, budget, steps=2):
    req = engine.submit(prompt, budget)
    for _ in range(steps):
        engine.step()
    return req


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_records_migrate_between_packages_token_exact(paged_pair, direction):
    """A request started on one package's paged engine, exported over the
    wire bytes and imported into the other's, continues token-exact at
    temperature 0 against its run on the source engine left alone; both
    pools are whole after."""
    jax_engine, port_engine = paged_pair
    src, dst, enc, dec = ((jax_engine, port_engine, jax_migration.encode_record,
                           migration.decode_record) if direction == "jax_to_port" else
                          (port_engine, jax_engine, migration.encode_record,
                           jax_migration.decode_record))
    prompt = PROMPT_C[:5]
    alone = src.submit(prompt, 12)
    src.run()
    moved = _start(src, prompt, 12)
    assert 0 < len(moved.tokens) < 12
    record = dec(enc(src.export_request(moved.rid)))
    assert record["n_blocks"] > 0 and record["kv_dtype"] == "fp"
    adopted = dst.import_request(record)
    dst.run()
    assert [int(t) for t in adopted.tokens] == [int(t) for t in alone.tokens]
    for e in (src, dst):
        assert e.scheduler.allocator.free_count == e.num_blocks


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_port_round_trip_keeps_the_stored_bytes(lm, kv_dtype):  # noqa: F811
    """Inside the port: export → encode → decode → import keeps the pool's
    stored bytes (fp rows, or codes and scales) from A's blocks to B's,
    tokens as the request run alone, a cross-kv_dtype import refused."""
    opts = dict(num_slots=2, paged=True, block_size=4, num_blocks=24, kv_dtype=kv_dtype)
    ref, a, b = (InferenceEngine(lm, **opts) for _ in range(3))
    alone = ref.submit(PROMPT_A[:6], 10)
    ref.run()
    req = _start(a, PROMPT_A[:6], 10)
    n = blocks_for(len(req.prompt) + len(req.tokens) - 1, 4)
    ids = torch.tensor(a.scheduler.tables[req.slot][:n])
    held = {k: [z.numpy().tobytes() for z in v] for k, v in gather_blocks(a.arena, ids).items()}
    wire = migration.encode_record(a.export_request(req.rid))
    record = migration.decode_record(wire)
    assert a.stats()["kv_quant_export_bytes"] == sum(
        np.asarray(x).nbytes for leaves in record["rows"].values() for x in leaves)
    resumed = {}
    resume = b._resume

    def snapshot(adm):
        resume(adm)
        rows = gather_blocks(b.arena, torch.tensor(adm.blocks[:n]))
        resumed.update({k: [z.numpy().tobytes() for z in v] for k, v in rows.items()})

    b._resume = snapshot
    moved = b.import_request(record)
    b.run()
    sent = {k: [np.asarray(x).tobytes() for x in v] for k, v in record["rows"].items()}
    assert held == sent == resumed
    assert moved.tokens == alone.tokens
    other = InferenceEngine(lm, **dict(opts, kv_dtype="int8" if kv_dtype == "fp" else "fp"))
    with pytest.raises(ValueError, match="kv_dtype"):
        other.import_request(migration.decode_record(wire))
    for e in (ref, a, b, other):
        e.release_telemetry()


def test_export_import_refusals_match_the_reference(serving_lm, lm):  # noqa: F811
    """Export and import refuse what the reference refuses, with its
    messages: a fixed-arena warm export, an unknown rid, a record imported
    twice, a cold record with tokens, a foreign block size."""
    pairs = {"fixed": (JaxEngine(serving_lm, num_slots=2), InferenceEngine(lm, num_slots=2)),
             "paged": (JaxEngine(serving_lm, num_slots=2, paged=True, block_size=4,
                                 num_blocks=24),
                       InferenceEngine(lm, num_slots=2, paged=True, block_size=4,
                                       num_blocks=24))}
    messages = []
    for engines in pairs.values():
        out = []
        for e in engines:
            errs = []
            req = _start(e, PROMPT_A[:5], 8)
            try:
                e.export_request(req.rid)
            except ValueError as err:
                errs.append(str(err).replace(str(req.rid), "RID"))
            with pytest.raises(KeyError):
                e.export_request(req.rid + 999)
            e.run()
            cold = {"version": 3, "rid": 5, "prompt": [2, 3], "tokens": [4],
                    "max_new_tokens": 4, "n_blocks": 0}
            for bad in (cold, dict(cold, tokens=[], block_size=8, n_blocks=1, rows={}),
                        dict(cold, version=4)):
                try:
                    e.import_request(bad)
                except ValueError as err:
                    errs.append(str(err))
            out.append(errs)
        assert out[0] == out[1]
        messages.append(out[1])
    assert any("fixed-arena" in m for m in messages[0])
