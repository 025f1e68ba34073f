"""The port's fleet-wide telemetry (``elephas_tpu_torch.telemetry.aggregate``
and ``elephas_tpu_torch.telemetry.merge``) against the JAX package's, on
the CPU.

- ``parse_exposition`` reads the same families from the same text, and
  ``FleetScraper.render`` over the two packages' registries (the same
  series recorded in each) gives the same bytes; ``fleet_stats`` and
  ``value`` agree.
- ``merge_chrome_traces`` of the same trace files gives the same document
  (rows, offsets, trace ids), also over a real export of each package's
  tracer; the ``python -m`` CLI writes it.
- The reference's cases of ``tests/test_telemetry_fleet.py`` run on the
  port through ``tests/_port_cases.py``: wire propagation of a trace id
  (socket, HTTP, sharded), scrape parity of the stores, the merge and the
  fleet scraper, and the merged trace of a request from the gateway into
  the engine (``:888``, over the port's engine on the reference's tiny
  untrained LM).
"""

import json
import re
import subprocess
import sys

import numpy as np
import pytest

import elephas_tpu.telemetry as jax_telemetry
import tests.test_telemetry_fleet as ref_tf
from elephas_tpu.telemetry import aggregate as jax_aggregate
from elephas_tpu.telemetry import merge as jax_merge
from elephas_tpu_torch import telemetry
from elephas_tpu_torch.serving import Gateway, InferenceEngine
from elephas_tpu_torch.telemetry import aggregate, merge
from elephas_tpu_torch.telemetry.registry import Registry
from tests._port_cases import port_class, port_namespace
from tests.test_torch_fleet import jax_lm, lm  # noqa: F401  (fixtures)


def _record(reg):
    """The same series in either package's registry."""
    c = reg.counter("demo_requests_total", "Requests \"served\"\nby route",
                    labels=("route", "code"))
    c.labels(route="/v1/generate", code="200").inc(3)
    c.labels(route='/we"ird\\path', code="500").inc()
    g = reg.gauge("elephas_serving_blocks_free", "Unleased blocks", labels=("engine",))
    g.labels(engine="e0").set(12)
    reg.gauge("elephas_serving_waiting_requests", "Queue depth",
              labels=("engine",)).labels(engine="e0").set(2)
    reg.gauge("elephas_serving_weight_version", "Generation",
              labels=("engine",)).labels(engine="e0").set(4)
    reg.gauge("nan_gauge", "no data", labels=("instance",)).labels(instance="inner").set(
        float("nan"))
    h = reg.histogram("demo_latency_seconds", "Latency", labels=("engine",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.labels(engine="e0").observe(v)
    return reg


def _fleet_render(pkg_telemetry, pkg_aggregate, registry_cls):
    reg = _record(registry_cls())
    text = pkg_telemetry.render(reg)
    fleet = pkg_aggregate.FleetScraper(
        {"replica-b": lambda: text, "replica-a": lambda: text,
         "dead": lambda: (_ for _ in ()).throw(ConnectionError("down"))},
        poll_on_render=False)
    up = fleet.poll()
    out = (text, up, fleet.render(), fleet.fleet_stats(),
           fleet.value("demo_requests_total", instance="replica-a"),
           fleet.value("demo_requests_total", code="200"),
           fleet.series("demo_latency_seconds_bucket"))
    label = fleet.telemetry_label
    fleet.release_telemetry()
    return out, label


def test_fleet_render_is_byte_identical_to_the_reference():
    port, port_label = _fleet_render(telemetry, aggregate, Registry)
    ref, ref_label = _fleet_render(jax_telemetry, jax_aggregate, jax_telemetry.Registry)
    assert port[0] == ref[0]                      # the members' own text
    assert port[1] == ref[1] == {"dead": False, "replica-a": True, "replica-b": True}
    # the scraper's own meta series carry its instance label, which each
    # package counts on its own: compare them under one name
    norm = [re.sub(rf'fleet="{label}"', 'fleet="F"', out[2])
            for out, label in ((port, port_label), (ref, ref_label))]
    assert norm[0] == norm[1]
    assert 'instance="replica-a"' in norm[0] and 'exported_instance="inner"' in norm[0]
    assert port[3:] == ref[3:]
    assert port[3]["replica-a"]["blocks_free"] == 12.0
    assert port[3]["replica-a"]["weight_version"] == 4


def test_parse_exposition_equals_the_reference():
    text = telemetry.render(_record(Registry())) + (
        "# TYPE om_total counter\n"
        'om_total{a="1"} 2 # {rid="7"} 1.0\n'
        "untyped_sample 3\n"
        "bad_sample not-a-number\n"
        "# EOF\n")

    def flat(families):
        return {name: (f.kind, f.help, [(s, dict(sorted(lab.items())), repr(v))
                                        for s, lab, v in f.samples])
                for name, f in families.items()}

    assert flat(aggregate.parse_exposition(text)) == flat(jax_aggregate.parse_exposition(text))


def _trace_files(tmp_path):
    span = ref_tf._span
    skew = 1_000_000.0
    files = {
        "client.json": [span("ps.push", 10_000, 30_000, cid="w1", seq=5, client="0"),
                        span("ps.push", 50_000, 10_000, cid="w1", seq=6, client="0",
                             trace="deploy-3"),
                        {"name": "serve.submit", "ph": "i", "pid": 1, "tid": 2, "ts": 1.0,
                         "args": {"rid": 7}}],
        "server.json": [span("ps.apply", 20_000 + skew, 5_000, client_id="w1", seq=5,
                             server="1"),
                        span("ps.apply", 52_000 + skew, 1_000, client_id="w1", seq=6,
                             server="1", trace="deploy-3"),
                        span("ps.journal_write", 26_000 + skew, 1_000, server="1"),
                        {"name": "chaos.ps_kill", "ph": "i", "pid": 1, "tid": 3, "ts": 2.0,
                         "args": {"port": 1}}],
        "lone.json": [span("gateway.request", 0, 10, gateway="0", rid=9),
                      span("x", 0, 1, engine="1"),
                      {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "p"}}],
    }
    paths = []
    for name, events in files.items():
        p = tmp_path / name
        p.write_text(json.dumps({"traceEvents": events}))
        paths.append(str(p))
    return paths


def test_merge_equals_the_reference(tmp_path):
    paths = _trace_files(tmp_path)
    port = merge.merge_chrome_traces(paths, out=str(tmp_path / "port.json"))
    ref = jax_merge.merge_chrome_traces(paths, out=str(tmp_path / "jax.json"))
    assert port == ref
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert port["elephas_fleet"]["offsets_us"][1] != 0.0
    assert merge.align_offsets_us([merge.load_trace(p) for p in paths]) == \
        jax_merge.align_offsets_us([jax_merge.load_trace(p) for p in paths])
    labelled = merge.merge_chrome_traces(paths, labels=["w", "s", "g"])
    assert labelled == jax_merge.merge_chrome_traces(paths, labels=["w", "s", "g"])
    for mod in (merge, jax_merge):
        with pytest.raises(ValueError, match="2 labels for 3 traces"):
            mod.merge_chrome_traces(paths, labels=["a", "b"])


def test_merge_of_real_exports_equals_the_reference(tmp_path):
    """Each package's tracer exports a trace of the same calls; merged
    together by either package, the document is the same."""
    exports = []
    for tm, name in ((telemetry, "port.json"), (jax_telemetry, "jax.json")):
        tracer = tm.tracer()
        seq0 = tracer.seq
        with tm.trace_scope("deploy-7"):
            with tm.trace_span("ps.push", cid="w", seq=0, client="0"):
                tm.emit("serve.refresh_weights", engine="0", weight_version=1)
        path = str(tmp_path / name)
        tracer.export_chrome_trace(path, since_seq=seq0)
        exports.append(path)
    port = merge.merge_chrome_traces(exports, labels=["a", "b"])
    ref = jax_merge.merge_chrome_traces(exports, labels=["a", "b"])
    assert port == ref
    assert port["elephas_fleet"]["trace_ids"] == ["deploy-7"]


def test_merge_cli(tmp_path):
    """``python -m elephas_tpu_torch.telemetry.merge`` (the reference's CLI
    case, ``slow`` there, on the port's module)."""
    paths = _trace_files(tmp_path)
    out = tmp_path / "fleet.json"
    proc = subprocess.run(
        [sys.executable, "-m", "elephas_tpu_torch.telemetry.merge", *paths, "-o", str(out),
         "--labels", "w,s,g"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert "merged 3 trace(s)" in proc.stdout
    assert json.loads(out.read_text()) == jax_merge.merge_chrome_traces(paths,
                                                                         labels=["w", "s", "g"])


# -- the reference's cases, rebound to the port -------------------------------------------

_NS = port_namespace(ref_tf, telemetry=telemetry, trace_merge=merge,
                     FleetScraper=aggregate.FleetScraper,
                     parse_exposition=aggregate.parse_exposition, Registry=Registry)

TestWirePropagation = port_class(ref_tf.TestWirePropagation, _NS)
TestScrapeParity = port_class(ref_tf.TestScrapeParity, _NS)
TestMerge = port_class(ref_tf.TestMerge, _NS)
TestFleetScraper = port_class(ref_tf.TestFleetScraper, _NS)


@pytest.fixture(scope="module")
def gw(lm):  # noqa: F811
    """The reference class fixture's gateway, over a port engine."""
    engine = InferenceEngine(lm, num_slots=2)
    gateway = Gateway(engine, port=0).start()
    yield gateway
    gateway.stop()
    engine.close()
    gateway.release_telemetry()
    engine.release_telemetry()


TestGatewayWatchdogAndTrace = port_class(
    ref_tf.TestGatewayWatchdogAndTrace, _NS,
    only=("test_merged_trace_single_id_gateway_to_engine",))


def test_fleet_scraper_serves_a_router_view(lm):  # noqa: F811
    """Two port engines behind a router: the scraper the router ranks by
    reads each replica's own series only, with its instance label."""
    from elephas_tpu_torch.fleet import Router

    engines = {name: InferenceEngine(lm, num_slots=2, paged=True, block_size=4, num_blocks=16)
               for name in ("a", "b")}
    router = Router(engines)
    with router:
        assert router.submit([2, 3, 4], 3).wait(60)
        router.refresh_view()
        stats = router.scraper.fleet_stats()
        assert sorted(stats) == ["a", "b"] and all(row["up"] for row in stats.values())
        assert stats["a"]["blocks_free"] == engines["a"].stats()["blocks_free"]
        assert sum(row["tokens_generated"] for row in stats.values()) == 3
        text = router.scraper.render()
        for name, eng in engines.items():
            assert f'engine="{eng.telemetry_label}",instance="{name}"' not in text
            assert f'instance="{name}",engine="{eng.telemetry_label}"' in text
    router.release_telemetry()
    for eng in engines.values():
        eng.release_telemetry()
    assert np.isfinite(stats["a"]["blocks_free"])
