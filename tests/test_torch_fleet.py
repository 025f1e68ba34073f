"""The port's serving fleet (``elephas_tpu_torch.fleet``: placement and the
router) against the JAX package's, on the CPU, over the reference's tiny
untrained LM (``tests/test_fleet.py:47-62``: vocab 16, maxlen 32, d_model
32, 2 heads, 2 layers) with its Keras weights carried into the port's.

- Placement: :func:`place` gives the same decision in both packages for
  the same snapshot (a ``hypothesis`` case, and the reference's
  across-processes case run on the port).
- Router parity: one scripted fleet run a package, the same calls in the
  same order (prefix affinity, the canary split, a replica killed
  mid-stream and re-driven, a restore), held
  request by request: the tokens equal between the two routers and equal
  to one JAX engine's on the same prompt (temperature 0, exact), the
  placements equal in order.
- The drain holds its streams live by construction (every replica parks
  after each request has tokens, so the drain meets them mid-stream
  whatever the speed of the host) and ends token-exact with one JAX
  engine. The reference's drain cases (``TestRouter.
  test_drain_zero_dropped_zero_doubled`` and ``test_failed_drain_
  restores_placement``) race wall-clock sleeps against the streams and
  starve on an idle host in the reference itself, so they are written
  out here with the streams parked by construction. A crashed driver's
  re-drive runs on the port through the reference's own case.
- The reference's other cases of ``tests/test_fleet.py`` run on the port
  through ``tests/_port_cases.py`` (their own code, the port's modules).
"""

import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import elephas_tpu.fleet as jax_fleet
import elephas_tpu.serving as jax_serving
import elephas_tpu.telemetry.watch as jax_watch
import elephas_tpu_torch as et
import tests.test_fleet as ref_fleet
from elephas_tpu_torch import fleet, serving
from elephas_tpu_torch.telemetry import watch
from tests._port_cases import port_class, port_namespace

VOCAB, MAXLEN = ref_fleet.VOCAB, ref_fleet.MAXLEN
ENGINE = dict(num_slots=2, paged=True, block_size=4, num_blocks=16, preemption=True,
              prefix_cache=True)


@pytest.fixture(scope="module")
def jax_lm():
    from elephas_tpu.models import transformer_lm

    return transformer_lm(vocab_size=VOCAB, maxlen=MAXLEN, d_model=32, num_heads=2,
                          num_layers=2, dropout=0.0, seed=0)


@pytest.fixture(scope="module")
def lm(jax_lm):
    """The port's LM on the reference's untrained weights."""
    port = et.transformer_lm(vocab_size=VOCAB, maxlen=MAXLEN, d_model=32, num_heads=2,
                             num_layers=2, device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in jax_lm.weights})
    return port


# -- placement --------------------------------------------------------------

_NAMES = ("a", "b", "c", "d")
_ROW = st.fixed_dictionaries({
    "up": st.booleans(),
    "blocks_free": st.integers(0, 6),
    "queue_depth": st.integers(0, 3),
})


@settings(max_examples=200, deadline=None, database=None)
@given(probes=st.dictionaries(st.sampled_from(_NAMES), st.integers(0, 12), min_size=1),
       view=st.dictionaries(st.sampled_from(_NAMES), _ROW),
       floor=st.integers(0, 10), cursor=st.integers(0, 9))
def test_place_equals_the_reference(probes, view, floor, cursor):
    """The same snapshot gives the same decision (replica and stage) in both
    packages, over snapshots with ties in warmth and in load, stale rows,
    missing rows and every stage."""
    assert tuple(fleet.place(probes, view, floor, cursor)) == \
        tuple(jax_fleet.place(probes, view, floor, cursor))


def test_place_across_processes_equals_the_reference():
    """``tests/test_fleet.py:504`` on the port: a fresh interpreter derives
    the reference's decision from the same snapshot."""
    probes, view = ref_fleet.SNAPSHOT_PROBES, ref_fleet.SNAPSHOT_VIEW
    code = (
        "from elephas_tpu_torch.fleet.placement import place\n"
        f"d = place({probes!r}, {view!r}, 8, 0)\n"
        "print(d.replica, d.kind)\n"
        "d2 = place({'a': 0, 'b': 0}, {}, 8, 5)\n"
        "print(d2.replica, d2.kind)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-1500:]
    want = [jax_fleet.place(probes, view, 8, 0), jax_fleet.place({"a": 0, "b": 0}, {}, 8, 5)]
    assert proc.stdout.split("\n")[:2] == [f"{d.replica} {d.kind}" for d in want]


# -- one scripted fleet run a package ---------------------------------------

SHARED = [2, 3, 4, 5, 2, 3, 4, 5]
PROMPTS = [[2, 3, 4, 5, 2, 3], [3, 4, 5, 2], [4, 5, 2, 3, 4], [5, 2, 3, 4, 5, 2, 3]]
MAX_NEW = 12


class _Gate:
    """Park an engine's driver: past ``after`` steps, once ``park_when()``
    holds (checked by the driver before each step, so no step runs past
    it), or while closed, its ``step`` does nothing, as the fault
    harness's staller does. ``parked`` is set on the first parked call, so
    a test acts on requests that are provably mid-stream whatever the speed
    of the host."""

    def __init__(self, engine, after=None, park_when=None):
        self.engine, self.after, self.calls = engine, after, 0
        self.park_when = park_when
        self.open = threading.Event()
        self.parked = threading.Event()
        if after is not None or park_when is not None:
            self.open.set()
        real = engine.step

        def step():
            self.calls += 1
            if self.after is not None and self.calls > self.after:
                self.open.clear()
            if self.park_when is not None and self.park_when():
                self.park_when = None
                self.open.clear()
            if not self.open.is_set():
                self.parked.set()
                time.sleep(0.002)
                return []
            return real()

        engine.step = step

    def release(self):
        self.after = None
        self.open.set()


class _RouterSeries:
    """A watchdog source reading one router's replica-up gauge only (the
    process registry also holds other routers' series)."""

    def __init__(self, router):
        self.gauge, self.label = router._mf_up, router.telemetry_label

    def series(self, name):
        if name != "elephas_router_replica_up":
            return []
        return [({"router": self.label, "replica": replica}, child.value)
                for (router, replica), child in self.gauge.series()
                if router == self.label]


def _wait_all(reqs, timeout=120.0):
    assert all(r.wait(timeout) for r in reqs), [(r.replica, r.tokens) for r in reqs]


def _fleet_run(fleet_mod, serving_mod, watch_mod, model) -> dict:
    """The same router calls on one package; returns what a client and an
    operator see, in order. Engine ``b`` serves both routers (a replica
    outlives a router), so the second meets a warm prefix cache."""
    def make(**kw):
        return serving_mod.InferenceEngine(model, **{**ENGINE, **kw})

    out = {}
    b = make()
    engines = {"a": make(), "b": b}
    router = fleet_mod.Router(engines, min_affinity_tokens=4, poll_every=2)
    with router:
        # prefix affinity: a cold request, then followers sharing its prompt
        reqs = []
        for t in (2, 3, 4, 5):
            reqs.append(router.submit(SHARED + [t], 6))
            _wait_all(reqs[-1:])
        out["affinity"] = [(r.replica, r.tokens) for r in reqs]
        out["placements"] = router.stats()["placements"]
        out["hits"] = engines[reqs[0].replica].stats()["prefix_cache"]["hits"]
        # the canary split: a deterministic walk over a share of placements
        router.set_canary(["b"], 0.5)
        reqs = []
        for i in range(6):
            reqs.append(router.submit([2 + i % 4, 3, 4], 3))
            _wait_all(reqs[-1:])
        out["canary"] = [(r.replica, r.tokens) for r in reqs]
        out["canary_status"] = router.canary_status()
        router.clear_canary()
    out["canary_placements"] = int(router._mf_placements.labels(
        router=router.telemetry_label, replica="b", kind="canary").value)
    router.release_telemetry()

    # a replica killed mid-stream: it parks after 3 steps, then dies. The
    # round-robin walk places the requests alike in both packages whatever
    # the speed of the drivers (a load view polled mid-admission need not)
    engines = {"a": make(), "b": b}
    gate = _Gate(engines["a"], after=3)
    router = fleet_mod.Router(engines, placement="round_robin")
    watchdog = watch_mod.Watchdog(source=_RouterSeries(router),
                                  rules=[watch_mod.ReplicaDownRule()])
    generated = b.total_generated
    with router:
        reqs = [router.submit(p, MAX_NEW) for p in PROMPTS]
        assert gate.parked.wait(60)
        out["on_killed"] = sorted(i for i, r in enumerate(reqs) if r.replica == "a")
        out["redriven"] = router.kill_replica("a")
        out["fired"] = [(a.rule, a.labels["replica"]) for a in watchdog.evaluate()]
        _wait_all(reqs)
        out["kill"] = [(r.replica, r.tokens, r.error) for r in reqs]
        st_ = router.stats()
        out["kill_counts"] = (st_["tokens_delivered"], st_["stale_tokens_dropped"],
                              st_["redriven"])
        out["generated"] = b.total_generated - generated + engines["a"].total_generated
        router.restore_replica("a", make())
        out["cleared"] = watchdog.evaluate()
        seen = set()
        for i in range(4):
            r = router.submit([3, 4, 5], 2)
            _wait_all([r])
            seen.add(r.replica)
        out["after_restore"] = sorted(seen)
        out["report"] = {k: watchdog.report()[k] for k in ("fired_total", "cleared_total")}
    watchdog.release_telemetry()
    router.release_telemetry()
    return out


@pytest.fixture(scope="module")
def jax_refs(jax_lm):
    """One JAX engine's tokens for every prompt the fleet runs serve (one
    batch: at temperature 0 a request's tokens do not depend on its
    neighbours)."""
    eng = jax_serving.InferenceEngine(jax_lm, **ENGINE)
    prompts = [(SHARED + [t], 6) for t in (2, 3, 4, 5)]
    prompts += [([2 + i % 4, 3, 4], 3) for i in range(4)]
    prompts += [(p, MAX_NEW) for p in PROMPTS]
    runs = eng.run([(list(p), n) for p, n in prompts])
    eng.release_telemetry()
    return {tuple(p): seq.tolist()[len(p):] for (p, _n), seq in zip(prompts, runs.values())}


@pytest.fixture(scope="module")
def jax_run(jax_lm):
    return _fleet_run(jax_fleet, jax_serving, jax_watch, jax_lm)


@pytest.fixture(scope="module")
def port_run(lm):
    return _fleet_run(fleet, serving, watch, lm)


def test_affinity_equals_the_jax_router(jax_run, port_run, jax_refs):
    """Shared-prefix followers land on the warm replica in both routers, by
    the same stages, and stream the JAX engine's tokens."""
    assert port_run["affinity"] == jax_run["affinity"]
    assert port_run["placements"] == jax_run["placements"]
    assert port_run["hits"] == jax_run["hits"] >= 3
    home = port_run["affinity"][0][0]
    assert all(replica == home for replica, _t in port_run["affinity"])
    for (_r, tokens), t in zip(port_run["affinity"], (2, 3, 4, 5)):
        assert tokens == jax_refs[tuple(SHARED + [t])]


def test_canary_split_equals_the_jax_router(jax_run, port_run, jax_refs):
    """The canary walk sends the same placements to the same pools."""
    assert port_run["canary"] == jax_run["canary"]
    assert port_run["canary_status"] == jax_run["canary_status"] == {
        "replicas": ["b"], "share": 0.5, "placements_seen": 6}
    assert port_run["canary_placements"] == jax_run["canary_placements"] == 3
    for (_r, tokens), i in zip(port_run["canary"], range(6)):
        assert tokens == jax_refs[(2 + i % 4, 3, 4)]


def test_kill_redrive_equals_the_jax_router(jax_run, port_run, jax_refs):
    """A replica killed mid-stream: its requests continue on the survivor
    token-exact with the JAX router and one JAX engine (nothing dropped or
    doubled), delivered tokens equal the survivor's and the dead replica's
    generated tokens, and ``replica_down`` fires, then clears on restore."""
    assert port_run["on_killed"] == jax_run["on_killed"] and port_run["on_killed"]
    assert port_run["redriven"] == jax_run["redriven"] >= 1
    assert [t for _r, t, _e in port_run["kill"]] == [t for _r, t, _e in jax_run["kill"]]
    for (replica, tokens, error), p in zip(port_run["kill"], PROMPTS):
        assert error is None and replica == "b"
        assert tokens == jax_refs[tuple(p)]
    delivered, stale, redriven = port_run["kill_counts"]
    assert delivered == sum(len(jax_refs[tuple(p)]) for p in PROMPTS)
    assert stale == 0 and redriven == port_run["redriven"]
    assert delivered == port_run["generated"] - stale
    assert port_run["fired"] == jax_run["fired"] == [("replica_down", "a")]
    assert port_run["cleared"] == jax_run["cleared"] == []
    assert port_run["report"] == jax_run["report"] == {"fired_total": 1, "cleared_total": 1}
    assert port_run["after_restore"] == jax_run["after_restore"]
    assert "a" in port_run["after_restore"]


def test_drain_is_live_and_token_exact(lm, jax_refs):
    """Both replicas park once every request has two tokens, so the drain
    meets every stream mid-flight: each migrates (warm, through the wire),
    the drained replica ends empty and out of placement, and every stream
    equals one JAX engine's. Four slots a replica: however the requests are
    placed, none waits for a slot while the others run to their end."""
    engines = {"a": serving.InferenceEngine(lm, **{**ENGINE, "num_slots": 4}),
               "b": serving.InferenceEngine(lm, **{**ENGINE, "num_slots": 4})}
    reqs = []

    def ready(name):
        # every request submitted, and this replica's all with two tokens
        return len(reqs) == len(PROMPTS) and all(
            len(r.tokens) >= 2 for r in reqs if r.replica == name)

    gates = {name: _Gate(eng, park_when=lambda name=name: ready(name))
             for name, eng in engines.items()}
    for g in gates.values():
        g.open.clear()  # no step until every request is in
    router = fleet.Router(engines, poll_every=2)
    with router:
        reqs.extend([router.submit(p, MAX_NEW) for p in PROMPTS])
        for g in gates.values():
            g.open.set()
            g.parked.clear()  # a parked call sets it again: each call while parked does
        deadline = time.monotonic() + 60
        while not all(g.parked.is_set() for g in gates.values()):
            assert time.monotonic() < deadline, [r.tokens for r in reqs]
            time.sleep(0.001)
        assert all(len(r.tokens) >= 2 and not r.done for r in reqs), [r.tokens for r in reqs]
        counts = {name: sum(r.replica == name for r in reqs) for name in engines}
        victim = max(sorted(counts), key=lambda n: counts[n])
        moved = router.drain(victim)
        assert moved == counts[victim] >= 1
        assert all(r.replica != victim for r in reqs)
        for g in gates.values():
            g.release()
        _wait_all(reqs)
        for r, p in zip(reqs, PROMPTS):
            assert r.error is None and r.tokens == jax_refs[tuple(p)]
        sched = engines[victim].scheduler
        assert not sched.active and not sched.waiting
        nxt = router.submit([2, 3], 2)
        assert nxt.wait(60) and nxt.replica != victim
        stats = router.stats()
        assert stats["migrated"] == moved and stats["drains"] == 1
        assert stats["tokens_delivered"] == int(router._m_tokens.value)
        assert stats["stale_tokens_dropped"] == 0
    router.release_telemetry()
    for eng in engines.values():
        eng.release_telemetry()


def test_failed_drain_restores_placement(lm):
    """``tests/test_fleet.py:792`` with the streams parked by construction:
    an incomplete drain (here a timeout) re-admits the replica to
    placement; only a completed drain keeps it out until ``undrain``."""
    engines = {"a": serving.InferenceEngine(lm, **ENGINE),
               "b": serving.InferenceEngine(lm, **ENGINE)}
    gates = {name: _Gate(eng, after=2) for name, eng in engines.items()}
    router = fleet.Router(engines, poll_every=2)
    with router:
        reqs = [router.submit([2, 3, 4, 5, 2, 3], 12) for _ in range(3)]
        busy = reqs[0].replica
        assert gates[busy].parked.wait(60)
        with pytest.raises(TimeoutError):
            router.drain(busy, timeout=-1.0)
        assert router.stats()["replicas"][busy]["draining"] is False
        for g in gates.values():
            g.release()
        _wait_all(reqs)
    router.release_telemetry()
    for eng in engines.values():
        eng.release_telemetry()


def test_killed_replica_releases_its_arena(lm):
    """``kill_replica`` drops the dead engine's KV pool before it returns:
    nothing keeps the pool's tensors alive, so a successor reuses the
    memory instead of stacking a second arena beside a dead one."""
    engines = {"a": serving.InferenceEngine(lm, **ENGINE),
               "b": serving.InferenceEngine(lm, **ENGINE)}
    pool = weakref.ref(engines["a"].arena)
    router = fleet.Router(engines)
    with router:
        r = router.submit([2, 3, 4], 4)
        assert r.wait(60)
        router.kill_replica("a")
        assert engines["a"].arena is None and pool() is None
        router.restore_replica("a", serving.InferenceEngine(lm, **ENGINE))
        assert router.replicas["a"].engine.arena is not None
    router.release_telemetry()


def test_engine_lock_hands_over_between_steps():
    """The engine's hand-off lock: reentrant in the thread that holds it
    (a handler holding it calls ``score()``, which takes it again), a
    no-op yield there, and a caller waiting while the driver steps goes
    in before the driver's next step."""
    from elephas_tpu_torch.serving.locks import HandoffLock

    lock = HandoffLock()
    with lock:
        with lock:
            lock.yield_to_waiters(timeout=5.0)  # returns at once: no waiter can get in
    order = []

    def caller():
        with lock:
            order.append("caller")

    for _ in range(5):
        order.clear()
        with lock:  # the driver's step
            waiter = threading.Thread(target=caller, daemon=True)
            waiter.start()
            deadline = time.monotonic() + 10
            while lock._waiting == 0:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        lock.yield_to_waiters(timeout=10.0)
        with lock:  # the driver's next step
            order.append("step")
        waiter.join(timeout=10)
        assert order == ["caller", "step"]


# -- the reference's cases, rebound to the port ---------------------------------

_NS = port_namespace(ref_fleet, Router=fleet.Router, PlacementDecision=fleet.PlacementDecision,
                     place=fleet.place, encode_record=fleet.encode_record,
                     decode_record=fleet.decode_record)

TestRidMinting = port_class(ref_fleet.TestRidMinting, _NS)
TestMigrationCodec = port_class(ref_fleet.TestMigrationCodec, _NS)
TestLiveMigration = port_class(ref_fleet.TestLiveMigration, _NS)
TestCancel = port_class(ref_fleet.TestCancel, _NS)
TestPlacementDeterminism = port_class(ref_fleet.TestPlacementDeterminism, _NS,
                                      skip=("test_across_processes",))
TestRouter = port_class(ref_fleet.TestRouter, _NS,
                        skip=("test_drain_zero_dropped_zero_doubled",
                              "test_failed_drain_restores_placement"))
