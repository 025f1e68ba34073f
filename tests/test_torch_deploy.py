"""The port's continuous deployment (``elephas_tpu_torch.deploy``: the
version ledger, the weight subscriber, the canary controller), the
engine's ``refresh_weights`` / ``load_weights``, and the deployment chaos
store, against the JAX package's, on the CPU.

- Ledger: the same publications, rollbacks and history bound give the same
  generations and statuses on both packages' stores and bit-equal journal
  files, and the port's ledger resumes from a journal the JAX store wrote.
- Subscriber: the same poll script (apply iff newer, never twice; a mixed
  cut and a torn pull skipped; wire errors, pins, staleness) gives the same
  statuses; a real port engine applies a generation bit-exactly.
- Canary: the same begin / evaluate / promote / rollback sequence under a
  scripted watchdog gives the same controller, ledger, subscriber and
  router states, and the same weights on every replica, in both packages.
- ``refresh_weights``: the reference's cases of ``tests/test_serving_prefix.py``
  (``:344``, ``:375``, ``:406``, ``:442``) and ``tests/test_serving_spec.py``
  (``:464``), each run on both engines with every observable compared, over
  the reference's tiny untrained LM of ``tests/test_fleet.py``.
- A step never reads two weight generations: ``load_weights`` from another
  thread while the driver steps, with every module's generation recorded
  as the step reads it.
- The reference's cases of ``tests/test_deploy.py`` that fit the port as
  written run on it through ``tests/_port_cases.py`` (the shard kill in the
  middle of a deployment, the generation on every surface, the migration
  wire's generation check, the ledger's and the subscriber's unit cases);
  its fake engine gains the port's ``load_weights``.
"""

import contextlib
import os
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

import elephas_tpu.deploy as jax_deploy
import elephas_tpu.fleet as jax_fleet
import elephas_tpu.parameter.server as jax_server
import elephas_tpu.serving as jax_serving
import elephas_tpu_torch as et
import tests.test_deploy as ref_deploy
from elephas_tpu.models import generate as jax_generate
from elephas_tpu_torch import deploy, fleet, serving
from elephas_tpu_torch.parameter import server
from elephas_tpu_torch.parameter.client import ShardedClient
from elephas_tpu_torch.utils.weights import get_weights, set_weights
from tests._port_cases import port_class, port_namespace
from tests.test_torch_fleet import ENGINE, jax_lm, lm  # noqa: F401  (fixtures)

SHARED = [2, 3, 4, 5, 2, 3, 4, 5]


class _FakeEngine(ref_deploy._FakeEngine):
    """The reference's fake engine with the port's ``load_weights``: the
    subscriber hands a pulled generation to the engine, which puts it in
    and refreshes between two steps."""

    def load_weights(self, weights, version=None):
        self.model.set_weights(weights)
        self.refresh_weights(version=version)


def _port_model(jax_model):
    port = et.transformer_lm(vocab_size=ref_deploy.VOCAB, maxlen=ref_deploy.MAXLEN, d_model=32,
                             num_heads=2, num_layers=2, device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in jax_model.weights})
    return port


# -- the ledger -------------------------------------------------------------------

def _ledger_script(ledger_cls, server_cls, journal_dir):
    w = ref_deploy._weights(seed=3)
    store = server_cls([x.copy() for x in w], mode="asynchronous", port=0,
                       journal_dir=journal_dir, journal_every=1)
    ledger = ledger_cls(store, keep_generations=3)
    out = [ledger.version]
    out.append(ledger.publish([x + 1.0 for x in w]))
    out.append(ledger.publish([x + 2.0 for x in w]))
    out.append(ledger.rollback(1))
    out.append(ledger.publish([x * 3.0 for x in w]))
    out.append(ledger.status())
    out.append(ledger.known_versions())
    status = {k: v for k, v in store.status().items() if k != "uptime_s"}
    status["journal"] = {k: v for k, v in status["journal"].items() if k != "dir"}
    out.append(status)
    out.append([a.tolist() for a in ledger.weights_of(3)])
    with pytest.raises(KeyError, match="generation 1"):
        ledger.weights_of(1)
    ledger.release_telemetry()
    store.release_telemetry()
    return out


def test_ledger_equals_the_reference_journals_bit_equal(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port = _ledger_script(deploy.VersionLedger, server.SocketServer, str(port_dir))
    ref = _ledger_script(jax_deploy.VersionLedger, jax_server.SocketServer, str(jax_dir))
    assert port == ref
    assert port[1:5] == [1, 2, 3, 4]
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) and names
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


def test_ledger_resumes_from_a_jax_journal(tmp_path):
    """A JAX store journals two generations; a port store over the same
    journal comes back into generation 2 with its weights bit-exact, and
    the port's ledger keeps minting above it."""
    w = ref_deploy._weights(seed=5)
    jd = str(tmp_path)
    jax_store = jax_server.SocketServer([x.copy() for x in w], port=0, journal_dir=jd,
                                        journal_every=1)
    jax_ledger = jax_deploy.VersionLedger(jax_store)
    jax_ledger.publish([x + 1.0 for x in w])
    w2 = [x - 2.0 for x in w]
    jax_ledger.publish(w2)
    port_store = server.SocketServer([np.zeros_like(x) for x in w], port=0, journal_dir=jd)
    assert port_store.restored_from_journal
    ledger = deploy.VersionLedger(port_store)
    assert ledger.version == 2 and ledger.status()["shard_versions"] == [2]
    for a, b in zip(port_store.get_parameters(), w2):
        np.testing.assert_array_equal(a, b)
    assert ledger.publish(w) == 3
    for obj in (jax_ledger, jax_store, ledger, port_store):
        obj.release_telemetry()


# -- the subscriber -----------------------------------------------------------------

def _subscriber_script(subscriber_cls, engine):
    client = ref_deploy._FakeClient(ref_deploy._weights(), version=1, shards=2)
    sub = subscriber_cls(engine, client, staleness_bound=1)
    out = []

    def poll():
        out.append((sub.poll_once(), engine.weight_version, sub.status()))

    poll()                                  # applies 1
    poll()                                  # same generation: no-op
    client.versions = [0, 0]
    poll()                                  # an older store never applies
    client.versions = [2, 1]
    poll()                                  # mixed cut
    orig = client.get_parameters

    def moving_pull():
        got = orig()
        client.versions = [3, 3]
        return got

    client.versions = [2, 2]
    client.get_parameters = moving_pull
    poll()                                  # torn pull: discarded
    client.get_parameters = orig
    client.status_error = ConnectionRefusedError("ps down")
    poll()                                  # wire error
    client.status_error = None
    client.pull_error = TimeoutError("pull hung")
    client.versions = [5, 5]
    poll()                                  # seen 5, applied 1: a violation
    client.pull_error = None
    sub.pin(3)
    poll()                                  # pinned
    sub.unpin()
    poll()                                  # applies 5
    out.append(engine.refreshes)
    out.append([w.tolist() for w in engine.model.weights])
    sub.release_telemetry()
    return out


def test_subscriber_equals_the_reference():
    assert _subscriber_script(deploy.WeightSubscriber, _FakeEngine()) == \
        _subscriber_script(jax_deploy.WeightSubscriber, ref_deploy._FakeEngine())


def test_live_engine_applies_generation_end_to_end(jax_lm):  # noqa: F811
    """``tests/test_deploy.py:305`` on the port: ledger → store → subscriber
    → ``load_weights`` on a port engine: the module's weights bit-exact,
    the engine stamped and serving afterwards, token-exact with a JAX
    engine on the same weights."""
    model = _port_model(jax_lm)
    engine = serving.InferenceEngine(model, num_slots=2)
    store = server.SocketServer(get_weights(model), mode="asynchronous", port=0)
    ledger = deploy.VersionLedger(store)
    sub = deploy.WeightSubscriber(engine, store)
    w2 = [w * 1.05 for w in get_weights(model)]
    version = ledger.publish(w2)
    assert sub.poll_once() == version
    assert engine.weight_version == version == engine.stats()["weight_version"]
    for a, b in zip(get_weights(model), w2):
        np.testing.assert_array_equal(a, b)
    out = engine.run([([2, 3, 4], 5)])
    jax_model = ref_deploy._lm(seed=0)
    jax_model.set_weights(w2)
    want = jax_serving.InferenceEngine(jax_model, num_slots=2).run([([2, 3, 4], 5)])
    assert [t.tolist() for t in out.values()] == [t.tolist() for t in want.values()]
    assert sub.status()["skips"] == {"wire_error": 0, "mixed_cut": 0, "pinned": 0,
                                     "torn_pull": 0}
    for obj in (sub, ledger, store, engine):
        obj.release_telemetry()


def test_int8_pull_applies_what_the_reference_client_pulls(jax_lm):  # noqa: F811
    """A subscriber pulling over a live socket store with int8 pull
    compression puts into the module exactly the arrays the JAX package's
    client decodes from the same store with the same compression (the
    codec is the reference's, byte for byte)."""
    from elephas_tpu.parameter.client import SocketClient as JaxSocketClient
    from elephas_tpu_torch.parameter.client import SocketClient

    model = _port_model(jax_lm)
    engine = serving.InferenceEngine(model, num_slots=2)
    store = server.SocketServer(get_weights(model), mode="asynchronous", port=0)
    store.start()
    client = SocketClient(master=f"127.0.0.1:{store.port}", pull_compression="int8")
    jax_client = JaxSocketClient(master=f"127.0.0.1:{store.port}", pull_compression="int8")
    try:
        ledger = deploy.VersionLedger(store)
        sub = deploy.WeightSubscriber(engine, client)
        new = [w * 0.5 + 0.25 for w in get_weights(model)]
        assert sub.poll_once() is None                  # generation 0: nothing newer
        version = ledger.publish(new)
        assert sub.poll_once() == version and sub.poll_once() is None
        want = jax_client.get_parameters()
        got = get_weights(model)
        assert any(not np.array_equal(w, n) for w, n in zip(want, new))  # quantized
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    finally:
        client.close()
        jax_client.close()
        store.stop()
    for obj in (sub, ledger, store, engine):
        obj.release_telemetry()


# -- the canary -----------------------------------------------------------------------

def _canary_script(pkg, models, get_w):
    """One promote and one rollback cycle through ``pkg`` (a namespace with
    the package's Router, InferenceEngine, VersionLedger, WeightSubscriber,
    CanaryController and SocketServer) under a scripted watchdog."""
    engines = {"stable": pkg.InferenceEngine(models[0], **ENGINE),
               "canary": pkg.InferenceEngine(models[1], **ENGINE)}
    store = pkg.SocketServer(get_w(models[0]), mode="asynchronous", port=0)
    ledger = pkg.VersionLedger(store)
    router = pkg.Router(engines, poll_every=50)
    subs = {name: pkg.WeightSubscriber(eng, store) for name, eng in engines.items()}
    wd = ref_deploy._ScriptedWatchdog()
    base = [w.copy() for w in store.get_parameters()]
    out = []
    with router:
        ctrl = pkg.CanaryController(router, ledger, subs, canary=["canary"], share=0.5,
                                    window=2, watchdog=wd)

        def snap(result):
            out.append((result, ctrl.status(), ledger.status(), router.canary_status(),
                        {n: s.status() for n, s in sorted(subs.items())},
                        {n: e.weight_version for n, e in sorted(engines.items())}))

        snap(ctrl.begin([w * 1.01 for w in base]))
        snap(ctrl.evaluate())
        snap(ctrl.evaluate())                # a clean window: promoted
        snap(ctrl.begin([w * 1.5 for w in base]))
        wd.burning = True
        snap(ctrl.evaluate())                # a burn: rolled back
        with pytest.raises(RuntimeError, match="roll back"):
            ctrl.rollback()
    weights = {n: [w.tolist() for w in get_w(e.model)] for n, e in sorted(engines.items())}
    promoted = [w.tolist() for w in ledger.weights_of(1)]
    for obj in (ctrl, router, ledger, store, *subs.values(), *engines.values()):
        obj.release_telemetry()
    return out, weights, promoted


def test_canary_equals_the_reference(jax_lm):  # noqa: F811
    jax_models = [ref_deploy._lm(seed=1), ref_deploy._lm(seed=1)]
    port_models = [_port_model(m) for m in jax_models]

    class _Port:
        Router, InferenceEngine = fleet.Router, serving.InferenceEngine
        VersionLedger, WeightSubscriber = deploy.VersionLedger, deploy.WeightSubscriber
        CanaryController, SocketServer = deploy.CanaryController, server.SocketServer

    class _Jax:
        Router, InferenceEngine = jax_fleet.Router, jax_serving.InferenceEngine
        VersionLedger, WeightSubscriber = jax_deploy.VersionLedger, jax_deploy.WeightSubscriber
        CanaryController, SocketServer = jax_deploy.CanaryController, jax_server.SocketServer

    port = _canary_script(_Port, port_models, get_weights)
    ref = _canary_script(_Jax, jax_models, lambda m: m.get_weights())
    assert port[0] == ref[0]
    assert [(r[0], r[1]["state"], r[1]["last_outcome"]) for r in port[0]] == [
        (1, "canary", None), ("canary", "canary", None), ("idle", "idle", "promoted"),
        (2, "canary", "promoted"), ("idle", "idle", "rolled_back")]
    # after the rollback every replica serves generation 1's content
    # (generation 3 re-serves it), bit for bit, in both packages
    assert port[1] == ref[1] == {"canary": port[2], "stable": port[2]}
    assert port[2] == ref[2]


# -- refresh_weights: the reference's cases on both engines ----------------------------

@contextlib.contextmanager
def _scaled(model, path, factor):
    """Scale one weight in place (the JAX model's variable or the port's
    tensor at the same Keras path) for the duration of the block."""
    if hasattr(model, "keras_paths"):
        t = model.keras_paths()[path][0]
        orig = t.detach().clone()
        with torch.no_grad():
            t.mul_(factor)
        try:
            yield
        finally:
            with torch.no_grad():
                t.copy_(orig)
    else:
        var = next(v for v in model.variables if v.path == path)
        orig = np.array(var.value)
        var.assign(orig * factor)
        try:
            yield
        finally:
            var.assign(orig)


def _one_shot(model, prompt, n):
    gen = et.generate if hasattr(model, "keras_paths") else jax_generate
    return np.asarray(gen(model, np.asarray(prompt, np.int32)[None], n, kv_cache=True))[0].tolist()


def _refresh_flushes_stale_donors(engine_cls, model):
    head = next(p for p in _paths(model) if "lm_head" in p and "kernel" in p)
    engine = engine_cls(model, num_slots=2, prefix_cache=True)
    engine.run([(SHARED + [2, 3], 4)])
    cache = engine.scheduler.prefix_cache
    out = [cache.stats()["entries"]]
    with _scaled(model, head, -1.0):      # "further training": logits flip
        engine.refresh_weights()
        out += [cache.stats()["entries"], sorted(engine.scheduler._free)]
        r2 = engine.submit(SHARED + [4, 5], 4)
        got = engine.run()
        out += [r2.reused_tokens, got[r2.rid].tolist(), _one_shot(model, SHARED + [4, 5], 4)]
    engine.release_telemetry()
    return out


def _refresh_midway_never_donates(engine_cls, model):
    engine = engine_cls(model, num_slots=2, prefix_cache=True, prefill_chunk=4)
    r1 = engine.submit(SHARED + SHARED + [2, 3, 4], 3)
    engine.step()                          # mid-prefill
    out = [sorted(engine._prefilling)]
    engine.refresh_weights()
    engine.run()
    cache = engine.scheduler.prefix_cache
    out += [r1.done, r1.tokens, cache.stats()["entries"]]
    engine.run([(SHARED, 3)])
    out.append(cache.stats()["entries"])
    r3 = engine.submit(SHARED + [4, 5], 3)
    got = engine.run()
    out += [r3.reused_tokens, got[r3.rid].tolist(), _one_shot(model, SHARED + [4, 5], 3)]
    engine.release_telemetry()
    return out


def _versioned_refresh_midprefill(engine_cls, model):
    engine = engine_cls(model, num_slots=2, prefix_cache=True, prefill_chunk=4,
                        flight_recorder=8)
    engine.refresh_weights(version=1)
    r1 = engine.submit(SHARED + SHARED + [2, 3, 4], 3)
    engine.step()
    out = [sorted(engine._prefilling)]
    engine.refresh_weights(version=2)
    engine.run()
    cache = engine.scheduler.prefix_cache
    out += [r1.done, cache.stats()["entries"], engine.weight_version,
            engine.explain(r1.rid)["weight_version"], engine.stats()["weight_version"],
            engine.debug_snapshot()["weight_version"]]
    r2 = engine.submit(SHARED, 3)
    engine.run()
    out += [engine.explain(r2.rid)["weight_version"], cache.stats()["entries"]]
    engine.release_telemetry()
    return out


def _versioned_refresh_cascades_to_draft_model(engine_cls, model):
    engine = engine_cls(model, num_slots=2, speculative=True, spec_k=3, spec_drafter=model)
    out = [engine._drafter.weight_version]
    engine.refresh_weights(version=3)
    out.append(engine._drafter.weight_version)
    got = engine.run([(SHARED + [4], 4)])
    out += [[t.tolist() for t in got.values()], _one_shot(model, SHARED + [4], 4)]
    engine.release_telemetry()
    return out


def _refresh_propagates_to_draft_model(engine_cls, model):
    engine = engine_cls(model, num_slots=2, speculative=True, spec_k=3, spec_drafter=model)
    engine.run([([2, 3, 4, 5], 8)])
    with _scaled(model, _paths(model)[0], 1.25):
        engine.refresh_weights()
        r = engine.submit([2, 3, 4, 5], max_new_tokens=8)
        got = engine.run()
        out = [got[r.rid].tolist(), _one_shot(model, [2, 3, 4, 5], 8),
               r.spec_accepted, r.spec_drafted]
    engine.release_telemetry()
    return out


def _paths(model):
    if hasattr(model, "keras_paths"):
        return list(model.keras_paths())
    return [v.path for v in model.variables]


REFRESH_CASES = {
    "test_serving_prefix.py:344": _refresh_flushes_stale_donors,
    "test_serving_prefix.py:375": _refresh_midway_never_donates,
    "test_serving_prefix.py:406": _versioned_refresh_midprefill,
    "test_serving_prefix.py:442": _versioned_refresh_cascades_to_draft_model,
    "test_serving_spec.py:464": _refresh_propagates_to_draft_model,
}


@pytest.mark.parametrize("case", sorted(REFRESH_CASES))
def test_refresh_weights_equals_the_jax_engine(case, lm, jax_lm):  # noqa: F811
    fn = REFRESH_CASES[case]
    port, ref = fn(serving.InferenceEngine, lm), fn(jax_serving.InferenceEngine, jax_lm)
    assert port == ref
    # the reference case's own claims, on the port
    if fn is _refresh_flushes_stale_donors:
        assert port[:3] == [1, 0, [0, 1]] and port[3] == 0 and port[4] == port[5]
    elif fn is _refresh_midway_never_donates:
        assert port[0] and port[1] and port[3] == 0 and port[4] == 1
        assert port[5] == len(SHARED) and port[6] == port[7]
    elif fn is _versioned_refresh_midprefill:
        assert port[0] and port[1] and port[2:7] == [0, 2, 1, 2, 2] and port[7:] == [2, 1]
    elif fn is _versioned_refresh_cascades_to_draft_model:
        assert port[:2] == [0, 3] and port[2] == [port[3]]
    else:
        assert port[0] == port[1] and port[2] == port[3] > 0


# -- a step never reads two generations ------------------------------------------------

def test_a_step_never_reads_two_weight_generations(jax_lm):  # noqa: F811
    """``load_weights`` from another thread while the driver steps: every
    module with parameters records, as the step calls it, which generation
    its parameters hold (generation ``g`` adds ``g`` to every weight). Each
    step must see one generation only; the loads land between steps."""
    model = _port_model(jax_lm)
    engine = serving.InferenceEngine(model, num_slots=2)
    base = get_weights(model)
    firsts = {}
    seen: dict[int, set] = {}
    step_no = [0]

    def record(module, _inputs):
        for p in module.parameters(recurse=False):
            g = round(float(p.detach().reshape(-1)[0]) - firsts[id(p)])
            seen.setdefault(step_no[0], set()).add(g)

    handles = []
    for m in model.modules():
        params = list(m.parameters(recurse=False))
        if params:
            for p in params:
                firsts[id(p)] = float(p.detach().reshape(-1)[0])
            handles.append(m.register_forward_pre_hook(record))
    inner = engine._step

    def counted():
        step_no[0] += 1
        return inner()

    engine._step = counted
    stop = threading.Event()

    def drive():
        while not stop.is_set():
            if not engine.scheduler.has_work:
                engine.submit([2, 3, 4, 5], 6)
            engine.step()

    driver = threading.Thread(target=drive, daemon=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        driver.start()
        for g in range(1, 41):
            engine.load_weights([w + float(g) for w in base], version=g)
        stop.set()
        driver.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        for h in handles:
            h.remove()
    assert not driver.is_alive()
    torn = {s: gens for s, gens in seen.items() if len(gens) > 1}
    assert not torn, torn
    assert len({g for gens in seen.values() for g in gens}) > 2  # loads ran while serving
    assert engine.weight_version == 40
    set_weights(model, base)
    engine.release_telemetry()


# -- the reference's cases, rebound to the port ------------------------------------------

_NS = port_namespace(ref_deploy, _FakeEngine=_FakeEngine, VersionLedger=deploy.VersionLedger,
                     WeightSubscriber=deploy.WeightSubscriber,
                     CanaryController=deploy.CanaryController, ShardedClient=ShardedClient,
                     SocketServer=server.SocketServer)

TestVersionLedger = port_class(ref_deploy.TestVersionLedger, _NS)
TestWeightSubscriber = port_class(ref_deploy.TestWeightSubscriber, _NS,
                                  skip=("test_live_engine_applies_generation_end_to_end",))
TestWeightVersionSurfaces = port_class(ref_deploy.TestWeightVersionSurfaces, _NS)
TestMigrationWeightVersion = port_class(ref_deploy.TestMigrationWeightVersion, _NS)
test_shard_kill_mid_deployment_converges_exactly_once = \
    _NS["test_shard_kill_mid_deployment_converges_exactly_once"]


def test_deploy_chaos_store_skips_dead_shards_loudly(caplog):
    """A publication past a dead shard lands on the live ones only, and the
    store's status lists the live shards (the mixed cut the subscribers
    refuse appears when the dead one rejoins)."""
    from elephas_tpu_torch.fault import DeployChaosStore, ShardedRestartablePS

    w = ref_deploy._weights(seed=7)
    with tempfile.TemporaryDirectory() as jd:
        ps = ShardedRestartablePS(server.SocketServer, w, 2, journal_dir=jd, journal_every=1)
        try:
            store = DeployChaosStore(ps)
            ledger = deploy.VersionLedger(store)
            assert ledger.publish([x + 1.0 for x in w]) == 1
            ps.kill(1)
            assert [s.status()["weight_version"] for s in store.servers] == [1]
            assert ledger.publish([x + 2.0 for x in w]) == 2
            assert "past dead shard(s) [1]" in caplog.text
            assert [st["weight_version"] for st in store.status()] == [2]
            ps.restart(1)
            assert [st["weight_version"] for st in store.status()] == [2, 1]
            assert not ledger.status()["converged"]
            assert ledger.publish([x + 2.0 for x in w]) == 3
            assert ledger.status()["converged"]
            ledger.release_telemetry()
        finally:
            ps.stop()
