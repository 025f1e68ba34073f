"""Chaos-injection harness.

Executable fault machinery around a :class:`~elephas_tpu_torch.fault.plan.
FaultPlan`: a :class:`RestartablePS` that can crash-and-recover a live
parameter server on its original port (journal replay), a
:class:`PSKiller` that triggers the crash mid-training and measures
recovery from real server counters, and :func:`run_chaos_training`,
which drives a real ``AsynchronousSparkWorker`` (on ``device``)
against all of it — shared by the chaos tests and ``chip_smoke.py`` so
the tested faults and the faults run on the card are the same code path.

Everything here is deterministic given ``(plan.seed, data seed)`` up to
scheduler timing: the data, the model init, the duplicate schedule, and
the kill trigger (an applied-update count, not a wall-clock timer) are
all seeded; only the exact interleaving of the kill with the worker's
in-flight op varies, which is precisely the nondeterminism the
recovery machinery must absorb. Every ``run_*`` function takes
``initial_weights`` (Keras's ``get_weights()`` order): the reference's
seeded network's weights make a run start where the reference's run at
the same seed starts; without them the port draws its own (see
:func:`_chaos_model`).
"""

from __future__ import annotations

import itertools
import json
import logging
import tempfile
import threading
import time

import numpy as np

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.fault.plan import FaultPlan
from elephas_tpu_torch.utils import sockets
from elephas_tpu_torch.utils.weights import get_weights

logger = logging.getLogger(__name__)

# per-run trace ids for the chaos harness: the harness is
# the "edge" of a chaos training run the way the gateway is for a
# request — one deterministic id per run (process-monotonic counter,
# no pids/wall time), propagated over the PS wire so worker pushes,
# server applies, and journal writes merge into one causal story
_chaos_run_ids = itertools.count()


def _chaos_trace_id(kind: str, transport: str, seed: int) -> str:
    return f"chaos-{kind}-{transport}-s{seed}-r{next(_chaos_run_ids)}"


def _require_telemetry(what: str) -> None:
    """The chaos machinery reads registry-backed counters for its kill
    trigger and recovery stamps (``updates_applied`` polling) — under
    telemetry null mode those read 0 and the killer would never fire.
    Refuse loudly instead of hanging."""
    if telemetry.null_mode():
        raise RuntimeError(
            f"{what} requires telemetry: the kill trigger and recovery "
            f"detection poll registry-backed counters, which read 0 "
            f"under null mode — call telemetry.set_null(False) first"
        )


def recovery_windows_from_trace(
    tracer=None, since_seq: int = 0, shard: int | None = None
) -> list:
    """Kill→first-post-restart-apply windows (seconds) read from the
    trace stream — the ``chaos.recovery`` spans :class:`PSKiller` /
    :class:`ShardKiller` record, filtered to those that actually
    observed recovery. With ``shard`` set, only that shard's spans
    (the ``shard`` arg the sharded killer stamps) are returned: the
    same stream an operator's trace viewer shows, not bespoke harness
    counters."""
    tracer = tracer or telemetry.tracer()
    return [
        float(e["dur"])
        for e in tracer.events(since_seq=since_seq, name="chaos.recovery")
        if e["args"].get("recovered")
        and (shard is None or e["args"].get("shard") == int(shard))
    ]


class RestartablePS:
    """Owns a (journaled) parameter server that can be killed like a
    crash — no terminal journal flush — and restarted on the SAME port,
    replaying the journal.

    Counters (`updates_applied`, `updates_duplicate`) accumulate across
    incarnations so callers read totals, not just the survivor's.
    """

    def __init__(
        self,
        server_cls,
        weights,
        mode: str = "asynchronous",
        journal_dir: str | None = None,
        journal_every: int = 2,
        lease_timeout: float = 30.0,
    ):
        _require_telemetry("RestartablePS")
        self._server_cls = server_cls
        self._weights = [np.asarray(w) for w in weights]
        self._mode = mode
        self._journal_dir = journal_dir
        self._journal_every = journal_every
        self._lease_timeout = lease_timeout
        self._dead_counts = {"updates_applied": 0, "updates_duplicate": 0}
        self.kills = 0
        self.restarts = 0
        self.t_killed: float | None = None
        self.t_recovered: float | None = None
        self.server = self._spawn(port=0)
        self.server.start()
        self.port = self.server.port

    def _spawn(self, port: int):
        return self._server_cls(
            self._weights,
            mode=self._mode,
            port=port,
            journal_dir=self._journal_dir,
            journal_every=self._journal_every,
            lease_timeout=self._lease_timeout,
        )

    def _absorb_counts(self, server) -> None:
        self._dead_counts["updates_applied"] += server.updates_applied
        self._dead_counts["updates_duplicate"] += server.updates_duplicate

    def kill(self) -> None:
        """Crash the server: stop serving WITHOUT a terminal journal
        flush, so recovery replays the last periodic snapshot (the
        honest crash case — a clean ``stop()`` would hide journal lag)."""
        server, self.server = self.server, None
        if server is None:
            return
        self.t_killed = time.monotonic()
        self.kills += 1
        telemetry.emit("chaos.ps_kill", port=self.port, kills=self.kills)
        server.stop(flush_journal=False)
        # absorb AFTER stop: an op in flight at the kill may still
        # complete its apply while connections sever
        self._absorb_counts(server)
        logger.info("chaos: parameter server killed on port %d", self.port)

    def restart(self) -> None:
        server = self._spawn(port=self.port)
        server.start()
        self.server = server
        self.restarts += 1
        telemetry.emit(
            "chaos.ps_restart", port=self.port,
            journal_restored=server.restored_from_journal,
        )
        logger.info(
            "chaos: parameter server restarted on port %d (journal "
            "restored: %s)", self.port, server.restored_from_journal,
        )

    def counters(self) -> dict[str, int]:
        out = dict(self._dead_counts)
        if self.server is not None:
            out["updates_applied"] += self.server.updates_applied
            out["updates_duplicate"] += self.server.updates_duplicate
        return out

    @property
    def recovery_s(self) -> float | None:
        """Kill → first post-restart applied update, from real
        timestamps (None until both happened)."""
        if self.t_killed is None or self.t_recovered is None:
            return None
        return self.t_recovered - self.t_killed

    def get_parameters(self):
        return self.server.get_parameters()

    def stop(self) -> None:
        if self.server is not None:
            self._absorb_counts(self.server)
            self.server.stop()
            self.server = None


class PSKiller(threading.Thread):
    """Kills the PS once it has applied ``after_updates`` more updates
    (beyond ``baseline``), restarts it after ``restart_delay_s``, and
    stamps ``ps.t_recovered`` at the first update the reborn server
    applies."""

    def __init__(
        self,
        ps: RestartablePS,
        after_updates: int,
        restart_delay_s: float = 0.5,
        baseline: int = 0,
        poll_s: float = 0.01,
    ):
        super().__init__(name="elephas-chaos-pskiller", daemon=True)
        self.ps = ps
        self.after_updates = int(after_updates)
        self.restart_delay_s = float(restart_delay_s)
        self.baseline = int(baseline)
        self.poll_s = float(poll_s)
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    def _wait_for_updates(self, threshold: int) -> bool:
        while not self._cancel.is_set():
            server = self.ps.server
            if server is not None and server.updates_applied >= threshold:
                return True
            time.sleep(self.poll_s)
        return False

    def run(self) -> None:
        if not self._wait_for_updates(self.baseline + self.after_updates):
            return
        # the kill→first-post-restart-apply window is ONE span on the
        # shared trace timeline: the bench and tests read the
        # recovery number from the same stream an operator's trace
        # viewer shows. `recovered` is stamped on the span so a
        # cancelled run never masquerades as a measured recovery.
        with telemetry.trace_span(
            "chaos.recovery", port=self.ps.port,
            after_updates=self.after_updates,
            restart_delay_s=self.restart_delay_s,
        ) as span:
            self.ps.kill()
            time.sleep(self.restart_delay_s)
            self.ps.restart()
            recovered = self._wait_for_updates(1)
            span.set(recovered=recovered)
        if recovered:
            self.ps.t_recovered = time.monotonic()


class WatchdogPoller:
    """Evaluate a watchdog at a fixed cadence on a daemon thread for
    the duration of a chaos run — the end-to-end wiring (shard kill ⇒ anomaly with the right label ⇒
    clear on recovery), shared by ``run_sharded_chaos_training`` and
    the tests so the tested detection is the benchmarked detection."""

    def __init__(self, watchdog, interval_s: float = 0.05):
        self.watchdog = watchdog
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="elephas-watchdog-poll", daemon=True
        )

    def _run(self) -> None:
        while not self._stop.is_set():
            self.watchdog.evaluate()
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "WatchdogPoller":
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


class ShardedRestartablePS:
    """N per-shard restartable servers — the sharded sibling of
    :class:`RestartablePS`: each shard can be crash-killed (no terminal
    journal flush) and restarted on its original port, replaying ONLY
    its own journal (``journal_dir/shard-<i>/``).

    **Hot-standby mode** (``standby_delay_s``): a daemon watcher
    restarts any killed shard automatically after the delay — the
    kill/restart decision decouples from whoever killed it (the
    production shape: a supervisor reschedules the dead shard while
    clients park that slice's sequenced pushes and resend on return).

    Counters accumulate across incarnations per shard, so callers read
    totals — and can read the OTHER shards' totals mid-outage, which is
    the partial-progress evidence the acceptance criteria ask for.
    """

    def __init__(
        self,
        server_cls,
        weights,
        num_shards: int,
        mode: str = "asynchronous",
        journal_dir: str | None = None,
        journal_every: int = 2,
        lease_timeout: float = 30.0,
        standby_delay_s: float | None = None,
        host: str = "127.0.0.1",
    ):
        from elephas_tpu_torch.parameter.sharding import (
            ShardMap,
            shard_journal_dir,
        )

        _require_telemetry("ShardedRestartablePS")
        self._server_cls = server_cls
        self.shard_map = ShardMap.from_weights(weights, num_shards)
        self._slices = self.shard_map.scatter(
            [np.asarray(w) for w in weights]
        )
        self._mode = mode
        self._journal_dirs = [
            shard_journal_dir(journal_dir, i) if journal_dir else None
            for i in range(num_shards)
        ]
        self._journal_every = journal_every
        self._lease_timeout = lease_timeout
        self.host = host
        self.num_shards = num_shards
        self.kills = [0] * num_shards
        self.restarts = [0] * num_shards
        # per-shard kill/recovery timestamps — the counters-side
        # cross-check for the trace-span recovery windows
        self.t_killed: list[float | None] = [None] * num_shards
        self.t_recovered: list[float | None] = [None] * num_shards
        self._dead_counts = [
            {"updates_applied": 0, "updates_duplicate": 0}
            for _ in range(num_shards)
        ]
        self._lock = threading.Lock()
        self.servers: list = [None] * num_shards
        for i in range(num_shards):
            self.servers[i] = self._spawn(i, port=0)
            self.servers[i].start()
        self.ports = [s.port for s in self.servers]
        self._standby_delay = standby_delay_s
        self._standby_stop = threading.Event()
        self._standby = None
        if standby_delay_s is not None:
            self._standby = threading.Thread(
                target=self._standby_loop,
                name="elephas-chaos-shard-standby", daemon=True,
            )
            self._standby.start()

    def _spawn(self, shard: int, port: int):
        return self._server_cls(
            self._slices[shard],
            mode=self._mode,
            port=port,
            journal_dir=self._journal_dirs[shard],
            journal_every=self._journal_every,
            lease_timeout=self._lease_timeout,
            shard_id=shard,
            num_shards=self.num_shards,
            shard_signature=self.shard_map.signature(),
        )

    @property
    def endpoints(self) -> str:
        return ",".join(f"{self.host}:{p}" for p in self.ports)

    def kill(self, shard: int) -> None:
        """Crash shard ``shard``: sever its connections, skip the
        terminal journal flush (recovery must replay the last periodic
        snapshot — the honest crash case)."""
        with self._lock:
            server, self.servers[shard] = self.servers[shard], None
        if server is None:
            return
        self.t_killed[shard] = time.monotonic()
        self.kills[shard] += 1
        telemetry.emit(
            "chaos.ps_kill", port=self.ports[shard], shard=shard,
            kills=self.kills[shard],
        )
        server.stop(flush_journal=False)
        # absorb AFTER stop: an op in flight at the kill may still
        # complete its apply while connections sever
        self._absorb(shard, server)
        logger.info(
            "chaos: shard %d killed on port %d", shard, self.ports[shard]
        )

    def restart(self, shard: int) -> None:
        server = self._spawn(shard, port=self.ports[shard])
        server.start()
        with self._lock:
            self.servers[shard] = server
        self.restarts[shard] += 1
        telemetry.emit(
            "chaos.ps_restart", port=self.ports[shard], shard=shard,
            journal_restored=server.restored_from_journal,
        )
        logger.info(
            "chaos: shard %d restarted on port %d (journal restored: "
            "%s)", shard, self.ports[shard],
            server.restored_from_journal,
        )

    def _standby_loop(self) -> None:
        """Hot standby: bring any killed shard back after the delay."""
        while not self._standby_stop.is_set():
            for i in range(self.num_shards):
                if self.servers[i] is None and self.kills[i] > self.restarts[i]:
                    if self._standby_stop.wait(self._standby_delay):
                        return
                    if self.servers[i] is None:
                        self.restart(i)
            self._standby_stop.wait(0.01)

    def _absorb(self, shard: int, server) -> None:
        self._dead_counts[shard]["updates_applied"] += server.updates_applied
        self._dead_counts[shard]["updates_duplicate"] += (
            server.updates_duplicate
        )

    def shard_counters(self, shard: int) -> dict[str, int]:
        out = dict(self._dead_counts[shard])
        server = self.servers[shard]
        if server is not None:
            out["updates_applied"] += server.updates_applied
            out["updates_duplicate"] += server.updates_duplicate
        return out

    def counters(self) -> dict[str, int]:
        totals = {"updates_applied": 0, "updates_duplicate": 0}
        for i in range(self.num_shards):
            for k, v in self.shard_counters(i).items():
                totals[k] += v
        return totals

    def get_parameters(self, timeout_s: float = 30.0):
        """Gather the full weight list. A shard awaiting its hot-standby
        restart is waited for (bounded) rather than crashing a caller
        who raced the watcher; a dead shard nobody will restart is a
        loud error, not an AttributeError on ``None``."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                servers = list(self.servers)
            down = [i for i, s in enumerate(servers) if s is None]
            if not down:
                return self.shard_map.gather(
                    [s.get_parameters() for s in servers]
                )
            if self._standby is None or time.monotonic() >= deadline:
                raise RuntimeError(
                    f"shard(s) {down} are killed and not restarted — "
                    f"cannot gather the full weight list (restart them, "
                    f"or run hot standby and retry)"
                )
            time.sleep(0.01)

    def stop(self) -> None:
        self._standby_stop.set()
        if self._standby is not None:
            self._standby.join(timeout=10)
        for i, server in enumerate(self.servers):
            if server is not None:
                self._absorb(i, server)
                server.stop()
                self.servers[i] = None


class ShardKiller(threading.Thread):
    """Kills ONE shard once it has applied ``after_updates`` more
    updates (beyond ``baseline``), then waits for its recovery —
    restarting it itself after ``restart_delay_s`` unless the
    :class:`ShardedRestartablePS` runs hot standby (then the standby
    owns the restart and this thread only observes). The
    kill→first-post-restart-apply window lands as ONE
    ``chaos.recovery`` span stamped with ``shard=``, and the OTHER
    shards' applied counts are snapshotted at kill and at recovery —
    ``other_progress`` is the partial-progress proof."""

    def __init__(
        self,
        ps: ShardedRestartablePS,
        shard: int,
        after_updates: int,
        restart_delay_s: float = 0.5,
        baseline: int = 0,
        poll_s: float = 0.01,
    ):
        super().__init__(name="elephas-chaos-shardkiller", daemon=True)
        self.ps = ps
        self.shard = int(shard)
        self.after_updates = int(after_updates)
        self.restart_delay_s = float(restart_delay_s)
        self.baseline = int(baseline)
        self.poll_s = float(poll_s)
        self.other_progress: dict[int, int] | None = None
        self.recovered = False
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    def _applied(self) -> int:
        return self.ps.shard_counters(self.shard)["updates_applied"]

    def _wait_applied(self, threshold: int) -> bool:
        while not self._cancel.is_set():
            if self._applied() >= threshold:
                return True
            time.sleep(self.poll_s)
        return False

    def _wait_reborn_applied(self) -> bool:
        # Recovery = the REBORN incarnation's OWN first apply (its
        # counter starts at zero; the journal meta is informational).
        # Waiting on the absorbed per-shard total instead would race:
        # an apply in flight at the kill still lands while connections
        # sever and is absorbed into the dead counts, satisfying an
        # at-kill+1 threshold with no post-restart apply at all — and
        # the trace-vs-counters cross-check could not catch it, both
        # sides deriving from the same too-early event.
        while not self._cancel.is_set():
            server = self.ps.servers[self.shard]
            if server is not None and server.updates_applied >= 1:
                return True
            time.sleep(self.poll_s)
        return False

    def _others(self) -> dict[int, int]:
        return {
            i: self.ps.shard_counters(i)["updates_applied"]
            for i in range(self.ps.num_shards)
            if i != self.shard
        }

    def run(self) -> None:
        if not self._wait_applied(self.baseline + self.after_updates):
            return
        standby = self.ps._standby is not None
        with telemetry.trace_span(
            "chaos.recovery", shard=self.shard,
            port=self.ps.ports[self.shard],
            after_updates=self.after_updates,
            restart_delay_s=self.restart_delay_s,
            standby=standby,
        ) as span:
            others_at_kill = self._others()
            self.ps.kill(self.shard)
            if not standby:
                time.sleep(self.restart_delay_s)
                self.ps.restart(self.shard)
            # recovery = the REBORN shard applies (resent/parked
            # updates land); under standby the restart itself is the
            # watcher's, we only observe
            self.recovered = self._wait_reborn_applied()
            span.set(recovered=self.recovered)
        if self.recovered:
            self.ps.t_recovered[self.shard] = time.monotonic()
            self.other_progress = {
                i: n - others_at_kill[i]
                for i, n in self._others().items()
            }


def run_sharded_chaos_training(
    transport: str = "socket",
    num_shards: int = 2,
    rows: int = 256,
    epochs: int = 2,
    batch_size: int = 64,
    seed: int = 0,
    plan: FaultPlan | None = None,
    journal_dir: str | None = None,
    journal_every: int = 1,
    mode: str = "asynchronous",
    ps_retries: int = 8,
    standby: bool = False,
    trace_export: str | None = None,
    watch: bool = False,
    device=None,
    initial_weights=None,
) -> dict:
    """One real async-worker run against a SHARDED restartable PS —
    the multi-shard sibling of :func:`run_chaos_training`, shared by
    the sharded chaos tests.

    Under a plan with ``kill_ps_after_updates``, shard
    ``plan.kill_shard`` is crash-killed mid-run and recovers from its
    own journal (hot standby when ``standby=True``); the worker's
    sharded client parks that slice's pushes and keeps the other
    shards served. Returns per-shard counters, the per-shard recovery
    window read from the shard-stamped ``chaos.recovery`` trace span,
    and ``other_shards_progress_during_outage`` — updates the
    surviving shards applied inside the recovery window (the
    acceptance criterion's partial-progress proof).

    The whole run executes under one minted trace id
    (``trace_id`` in the result) which the sharded client forwards
    over the wire — worker sync spans, per-shard applies, and journal
    writes share it on the exported timeline. ``watch=True``
    additionally runs a default-rule
    :class:`~elephas_tpu_torch.telemetry.watch.Watchdog` at 50ms cadence for
    the run's duration: the shard kill must surface as a
    ``ps_unreachable`` anomaly labeled with the killed shard, then
    clear once the parked pushes replay — the fired/cleared event
    streams and the final report ride back in the result
    (``watch_anomalies`` / ``watch_cleared`` / ``watch_report``).
    """
    from elephas_tpu_torch.parameter.server import HttpServer, SocketServer
    from elephas_tpu_torch.worker import AsynchronousSparkWorker

    _require_telemetry("run_sharded_chaos_training")
    trace_seq0 = telemetry.tracer().seq
    x, y, d, k = _chaos_data(seed, rows)
    model, model_json = _chaos_model(seed, d, k, device, initial_weights)
    server_cls = {"socket": SocketServer, "http": HttpServer}[transport]
    plan = plan or FaultPlan(seed=seed)
    ps = ShardedRestartablePS(
        server_cls,
        get_weights(model),
        num_shards,
        mode=mode,
        journal_dir=journal_dir,
        journal_every=journal_every,
        standby_delay_s=plan.restart_delay_s if standby else None,
    )
    worker = AsynchronousSparkWorker(
        model_json,
        train_config={"epochs": epochs, "batch_size": batch_size},
        frequency="batch",
        parameter_server_mode=transport,
        master=ps.endpoints,
        master_optimizer="adam",
        master_loss="sparse_categorical_crossentropy",
        device=device,
        ps_retries=ps_retries,
    )
    clients: list = []
    real_client = worker._client

    def chaotic_client(model=None):
        client = real_client(model)
        if plan.duplicate_fraction > 0.0:
            client.chaos_duplicate = plan.duplicate
        clients.append(client)
        return client

    worker._client = chaotic_client

    trace_id = _chaos_trace_id("sharded", transport, seed)
    watchdog = poller = None
    if watch:
        from elephas_tpu_torch.telemetry.watch import Watchdog

        watchdog = Watchdog()
        poller = WatchdogPoller(watchdog)

    killer = None
    try:
        if poller is not None:
            poller.__enter__()
        with telemetry.trace_scope(trace_id):
            # warmup outside the timed window and before any chaos
            list(worker.train(iter(zip(x[:batch_size], y[:batch_size]))))
            baseline = ps.shard_counters(plan.kill_shard)[
                "updates_applied"
            ]
            if plan.kill_ps_after_updates is not None:
                killer = ShardKiller(
                    ps,
                    plan.kill_shard,
                    plan.kill_ps_after_updates,
                    restart_delay_s=plan.restart_delay_s,
                    baseline=baseline,
                )
                killer.start()
            t0 = time.perf_counter()
            list(worker.train(iter(zip(x, y))))
            dt = time.perf_counter() - t0
    finally:
        if killer is not None:
            if ps.kills[plan.kill_shard]:
                # the kill fired: the killer exits on its own at the
                # reborn shard's first apply — give it time to OBSERVE
                # before cancelling. On a fast box the whole post-kill
                # training can fit inside restart_delay_s, leaving the
                # final flush's replay as the recovery signal; an
                # eager cancel here raced that last ~10ms poll and
                # discarded a recovery that actually happened.
                killer.join(timeout=15)
            killer.cancel()
            killer.join(timeout=30)
        if poller is not None:
            poller.stop()
    if watchdog is not None:
        # a few post-run evaluations: PsUnreachableRule clears after
        # `clear_after` quiet looks, and the run may have ended inside
        # its hysteresis window
        for _ in range(4):
            watchdog.evaluate()
    try:
        per_shard = [ps.shard_counters(i) for i in range(num_shards)]
        final_weights = ps.get_parameters()
    finally:
        ps.stop()

    shard_windows = {
        i: recovery_windows_from_trace(since_seq=trace_seq0, shard=i)
        for i in range(num_shards)
    }
    if trace_export:
        n_events = telemetry.tracer().export_chrome_trace(
            trace_export, since_seq=trace_seq0
        )
        logger.info(
            "sharded chaos trace: %d events exported to %s",
            n_events, trace_export,
        )
    tracer = telemetry.tracer()
    watch_out = {}
    if watchdog is not None:
        watch_out = {
            "watch_anomalies": [
                dict(e["args"])
                for e in tracer.events(
                    since_seq=trace_seq0, name="watch.anomaly"
                )
            ],
            "watch_cleared": [
                dict(e["args"])
                for e in tracer.events(
                    since_seq=trace_seq0, name="watch.clear"
                )
            ],
            "watch_report": watchdog.report(),
        }
    killed = plan.kill_shard
    return {
        "transport": transport,
        "num_shards": num_shards,
        "rows": rows,
        "epochs": epochs,
        "seed": seed,
        "trace_id": trace_id,
        **watch_out,
        "dt_s": dt,
        "samples_per_s": rows * epochs / dt,
        "killed_shard": killed if plan.kill_ps_after_updates else None,
        "kills": list(ps.kills),
        "restarts": list(ps.restarts),
        "standby": standby,
        "recovery_s_by_shard": {
            i: (w[-1] if w else None) for i, w in shard_windows.items()
        },
        # counters-side cross-check (kill/recovery timestamp pair per
        # shard) for the trace-span windows above
        "recovery_s_counters_by_shard": {
            i: (
                None
                if ps.t_killed[i] is None or ps.t_recovered[i] is None
                else ps.t_recovered[i] - ps.t_killed[i]
            )
            for i in range(num_shards)
        },
        "updates_applied_by_shard": [
            c["updates_applied"] for c in per_shard
        ],
        "duplicates_skipped_by_shard": [
            c["updates_duplicate"] for c in per_shard
        ],
        "other_shards_progress_during_outage": (
            killer.other_progress if killer is not None else None
        ),
        "updates_resent": sum(c.updates_resent for c in clients),
        "duplicates_sent": sum(c.chaos_dups_sent for c in clients),
        "pending_final": [
            n for c in clients
            for n in getattr(c, "pending_counts", [])
        ],
        "updates_lost_final": sum(
            getattr(c, "updates_lost", 0) for c in clients
        ),
        "final_weights": final_weights,
        "data": (x, y),
    }


def run_elastic_membership(
    transport: str = "socket",
    num_shards: int = 2,
    rows: int = 192,
    batch_size: int = 32,
    seed: int = 0,
    join_after_periods: int = 2,
    journal_dir: str | None = None,
    device=None,
    initial_weights=None,
) -> dict:
    """Elastic data-parallel membership against a (sharded) PS: one
    worker runs the whole dataset, a second LEAVES mid-run (it trains
    only a head slice, flushes, closes — its lease then goes stale),
    and a third JOINS mid-run (starts after the early worker's
    departure, pulls the then-current weights, contributes the tail).
    No coordinator round-trip anywhere: registration is implicit in
    the first sequenced update and departure is just lease staleness —
    the membership machinery carrying elastic data parallelism.

    Returns the final per-shard membership view, applied/duplicate
    totals, and the final weights for convergence assertions.
    """
    from elephas_tpu_torch.parameter.server import HttpServer, SocketServer
    from elephas_tpu_torch.worker import AsynchronousSparkWorker

    _require_telemetry("run_elastic_membership")
    x, y, d, k = _chaos_data(seed, rows)
    model, model_json = _chaos_model(seed, d, k, device, initial_weights)
    server_cls = {"socket": SocketServer, "http": HttpServer}[transport]
    ps = ShardedRestartablePS(
        server_cls, get_weights(model), num_shards,
        journal_dir=journal_dir,
    )

    def make_worker(client_id: str):
        return AsynchronousSparkWorker(
            model_json,
            train_config={"epochs": 1, "batch_size": batch_size},
            frequency="batch",
            parameter_server_mode=transport,
            master=ps.endpoints,
            master_optimizer="adam",
            master_loss="sparse_categorical_crossentropy",
            client_id=client_id,
            device=device,
        )

    third = rows // 3
    joined = threading.Event()
    errors: list = []

    def steady():
        try:
            list(make_worker("steady").train(iter(zip(x, y))))
        except BaseException as e:  # surfaced below, never swallowed
            errors.append(("steady", e))

    def leaver():
        try:
            # trains only the head slice then closes: a mid-run
            # departure — flush() inside train() confirms delivery
            # first, so nothing it pushed is lost
            list(make_worker("leaver").train(
                iter(zip(x[:third], y[:third]))
            ))
        except BaseException as e:
            errors.append(("leaver", e))
        finally:
            joined.set()  # the joiner enters once the leaver is gone

    def joiner():
        joined.wait(timeout=60)
        try:
            list(make_worker("joiner").train(
                iter(zip(x[third:], y[third:]))
            ))
        except BaseException as e:
            errors.append(("joiner", e))

    threads = [
        threading.Thread(target=fn, daemon=True, name=f"elastic-{fn.__name__}")
        for fn in (steady, leaver, joiner)
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors:
            raise RuntimeError(f"elastic workers failed: {errors!r}")
        members = [s.members() for s in ps.servers]
        counters = ps.counters()
        final_weights = ps.get_parameters()
    finally:
        ps.stop()
    return {
        "members_by_shard": members,
        "updates_applied": counters["updates_applied"],
        "updates_duplicate": counters["updates_duplicate"],
        "final_weights": final_weights,
        "data": (x, y),
    }


# -- end-to-end chaos training -------------------------------------------


def _chaos_data(seed: int, rows: int, d: int = 16, k: int = 3):
    """Seeded separable blobs (the conftest recipe, self-contained so
    bench runs outside pytest)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 2.0
    y = rng.integers(0, k, size=rows)
    x = (centers[y] + rng.normal(size=(rows, d)) * 0.6).astype(np.float32)
    return x, y.astype(np.int32), d, k


def _chaos_model_json(d: int, k: int) -> str:
    """Keras's JSON text of the reference's chaos network,
    ``Sequential([Input((d,)), Dense(32, relu), Dense(k, softmax)])``."""
    def layer(kind, **config):
        return {"module": "keras.layers", "class_name": kind, "config": config,
                "registered_name": None}

    return json.dumps({"module": "keras", "class_name": "Sequential", "registered_name": None,
                       "config": {"name": "sequential", "layers": [
                           layer("InputLayer", batch_shape=[None, d], name="input_layer"),
                           layer("Dense", name="dense", units=32, activation="relu"),
                           layer("Dense", name="dense_1", units=k, activation="softmax"),
                       ]}})


def _chaos_model(seed: int, d: int, k: int, device=None, weights=None):
    """The reference's chaos network as a module of the port, compiled
    with Keras's Adam and sparse categorical cross-entropy. ``weights``
    (a list in Keras's ``get_weights()`` order, such as the reference's
    seeded network gives) are loaded as they are; without them the
    weights are drawn from ``seed`` by numpy (Glorot-uniform kernels,
    zero biases: Keras's initialisers, not Keras's random stream).
    Returns the module and its Keras JSON text (what the workers build
    from)."""
    from elephas_tpu_torch.models.keras_config import model_from_json
    from elephas_tpu_torch.optimizers import Adam
    from elephas_tpu_torch.training import compile_model
    from elephas_tpu_torch.utils.weights import load_keras_weights, set_weights

    text = _chaos_model_json(d, k)
    model = model_from_json(text, device=device)
    if weights is not None:
        set_weights(model, weights)
    else:
        rng = np.random.default_rng(seed)
        drawn = {}
        for name, (n_in, n_out) in (("dense", (d, 32)), ("dense_1", (32, k))):
            limit = np.sqrt(6.0 / (n_in + n_out))
            drawn[f"sequential/{name}/kernel"] = rng.uniform(
                -limit, limit, (n_in, n_out)).astype(np.float32)
            drawn[f"sequential/{name}/bias"] = np.zeros(n_out, np.float32)
        load_keras_weights(model, drawn)
    compile_model(model, Adam(model.parameters()), "sparse_categorical_crossentropy")
    return model, text


def run_chaos_training(
    transport: str = "socket",
    rows: int = 256,
    epochs: int = 2,
    batch_size: int = 64,
    seed: int = 0,
    plan: FaultPlan | None = None,
    journal_dir: str | None = None,
    journal_every: int = 2,
    mode: str = "asynchronous",
    ps_retries: int = 8,
    trace_export: str | None = None,
    device=None,
    initial_weights=None,
) -> dict:
    """One real async-worker training run under ``plan`` (or fault-free
    when ``plan`` is None) against a restartable, journaled PS.

    Returns real counters and timings: wall-clock + samples/sec of the
    timed (post-warmup) window, kill/restart/recovery timestamps,
    applied/duplicate counts aggregated across server incarnations, and
    the worker clients' lost/resent counters — plus the final server
    weights so callers can evaluate convergence. ``recovery_s_trace``
    is the kill→recovery window read from the trace stream (the
    ``chaos.recovery`` span), and ``trace_export`` dumps this run's
    events as Chrome-trace JSON — the kill, restart, recovery span,
    worker retries, and PS round-trips on one timeline.
    """
    from elephas_tpu_torch.parameter.server import HttpServer, SocketServer
    from elephas_tpu_torch.worker import AsynchronousSparkWorker

    _require_telemetry("run_chaos_training")
    trace_seq0 = telemetry.tracer().seq
    x, y, d, k = _chaos_data(seed, rows)
    model, model_json = _chaos_model(seed, d, k, device, initial_weights)
    server_cls = {"socket": SocketServer, "http": HttpServer}[transport]
    ps = RestartablePS(
        server_cls,
        get_weights(model),
        mode=mode,
        journal_dir=journal_dir,
        journal_every=journal_every,
    )
    worker = AsynchronousSparkWorker(
        model_json,
        train_config={"epochs": epochs, "batch_size": batch_size},
        frequency="batch",
        parameter_server_mode=transport,
        master=f"127.0.0.1:{ps.port}",
        master_optimizer="adam",
        master_loss="sparse_categorical_crossentropy",
        device=device,
        ps_retries=ps_retries,
    )
    clients: list = []
    real_client = worker._client

    def chaotic_client(model=None):
        client = real_client(model)
        if plan is not None and plan.duplicate_fraction > 0.0:
            client.chaos_duplicate = plan.duplicate
        clients.append(client)
        return client

    worker._client = chaotic_client

    killer = None
    previous_hook = None
    hook_installed = False
    # one trace id for the whole run: worker sync spans,
    # wire pushes, server applies, and journal writes merge into one
    # causal story on the exported timeline
    trace_id = _chaos_trace_id("single", transport, seed)
    try:
        with telemetry.trace_scope(trace_id):
            # warmup OUTSIDE the timed window and BEFORE any chaos:
            # keras compile + wire negotiation must not pollute
            # throughput or the kill trigger
            list(worker.train(iter(zip(x[:batch_size], y[:batch_size]))))
            baseline_updates = ps.counters()["updates_applied"]

            if plan is not None and plan.kill_ps_after_updates is not None:
                killer = PSKiller(
                    ps,
                    plan.kill_ps_after_updates,
                    restart_delay_s=plan.restart_delay_s,
                    baseline=baseline_updates,
                )
                killer.start()
            if plan is not None:
                hook = plan.make_socket_hook()
                if hook is not None:
                    previous_hook = sockets.set_fault_hook(hook)
                    hook_installed = True

            t0 = time.perf_counter()
            list(worker.train(iter(zip(x, y))))
            dt = time.perf_counter() - t0
    finally:
        if hook_installed:
            sockets.set_fault_hook(previous_hook)
        if killer is not None:
            if ps.kills:
                # fired: let the killer observe the reborn server's
                # first apply before cancelling (see the sharded
                # harness — eager cancel raced the final flush's
                # replay on fast boxes)
                killer.join(timeout=15)
            killer.cancel()
            killer.join(timeout=30)
    try:
        counters = ps.counters()
        final_weights = ps.get_parameters()
    finally:
        ps.stop()

    trace_windows = recovery_windows_from_trace(since_seq=trace_seq0)
    if trace_export:
        n_events = telemetry.tracer().export_chrome_trace(
            trace_export, since_seq=trace_seq0
        )
        logger.info(
            "chaos trace: %d events exported to %s", n_events, trace_export
        )

    return {
        "transport": transport,
        "rows": rows,
        "epochs": epochs,
        "seed": seed,
        "trace_id": trace_id,
        "dt_s": dt,
        "samples_per_s": rows * epochs / dt,
        # kill→recovery read from the trace stream: the
        # number the bench reports, sourced from the same events an
        # operator's trace viewer shows
        "recovery_s_trace": trace_windows[-1] if trace_windows else None,
        "updates_applied": counters["updates_applied"] - baseline_updates,
        "duplicates_skipped": counters["updates_duplicate"],
        "updates_resent": sum(c.updates_resent for c in clients),
        "duplicates_sent": sum(c.chaos_dups_sent for c in clients),
        "updates_lost_final": sum(
            getattr(c, "updates_lost", 0) for c in clients
        ),
        "kills": ps.kills,
        "restarts": ps.restarts,
        "recovery_s": ps.recovery_s,
        "journal_restored": (
            ps.restarts > 0 and journal_dir is not None
        ),
        "final_weights": final_weights,
        "data": (x, y),
    }


def measure_faults(
    transport: str = "socket",
    rows: int = 256,
    epochs: int = 2,
    batch_size: int = 64,
    seed: int = 0,
    kill_after_updates: int | None = None,
    restart_delay_s: float = 0.75,
    duplicate_fraction: float = 0.25,
    trace_export: str | None = None,
    device=None,
):
    """One fault-free run and one
    chaos run (PS kill+restart mid-epoch, a seeded fraction of update
    frames duplicated on the wire, periodic wire delays) on the same
    seeded data/model. Returns ``(clean, faulted, plan)`` — the caller
    owns the JSON contract and the credibility gate."""
    from elephas_tpu_torch.fault.plan import SocketFaults

    clean = run_chaos_training(
        transport, rows=rows, epochs=epochs, batch_size=batch_size,
        seed=seed, plan=None, device=device,
    )
    if kill_after_updates is None:
        # land the kill mid-epoch, around a third into the sync stream
        periods = max(1, -(-rows // batch_size)) * epochs
        kill_after_updates = max(2, periods // 3)
    plan = FaultPlan(
        seed=seed,
        kill_ps_after_updates=kill_after_updates,
        restart_delay_s=restart_delay_s,
        duplicate_fraction=duplicate_fraction,
        socket_faults=SocketFaults(delay_every=13, delay_ms=4.0),
    )
    with tempfile.TemporaryDirectory(prefix="elephas-faults-") as jdir:
        faulted = run_chaos_training(
            transport,
            rows=rows,
            epochs=epochs,
            batch_size=batch_size,
            seed=seed,
            plan=plan,
            journal_dir=jdir,
            trace_export=trace_export,
            device=device,
        )
    return clean, faulted, plan


def measure_sharded_faults(
    transport: str = "socket",
    num_shards: int = 2,
    rows: int = 256,
    epochs: int = 2,
    batch_size: int = 64,
    seed: int = 0,
    kill_after_updates: int | None = None,
    restart_delay_s: float = 0.75,
    duplicate_fraction: float = 0.25,
    kill_shard: int = 0,
    standby: bool = False,
    trace_export: str | None = None,
    device=None,
):
    """One fault-free SHARDED run and one chaos run on the same
    seeded data/model, where only shard ``kill_shard`` is crash-killed
    mid-run (plus a seeded fraction of duplicated update frames on
    every shard) and recovers from its own journal. Returns
    ``(clean, faulted, plan)``; the caller owns the JSON contract and
    the credibility gates (per-shard trace-vs-counters agreement,
    surviving-shard progress, exactly-once totals)."""
    clean = run_sharded_chaos_training(
        transport, num_shards=num_shards, rows=rows, epochs=epochs,
        batch_size=batch_size, seed=seed, plan=None, device=device,
    )
    if kill_after_updates is None:
        # land the kill mid-epoch, around a third into the sync stream
        # (every sync period touches every shard, so per-shard applied
        # counts track the period count)
        periods = max(1, -(-rows // batch_size)) * epochs
        kill_after_updates = max(2, periods // 3)
    plan = FaultPlan(
        seed=seed,
        kill_ps_after_updates=kill_after_updates,
        restart_delay_s=restart_delay_s,
        duplicate_fraction=duplicate_fraction,
        kill_shard=kill_shard,
    )
    with tempfile.TemporaryDirectory(prefix="elephas-shard-faults-") as jdir:
        faulted = run_sharded_chaos_training(
            transport,
            num_shards=num_shards,
            rows=rows,
            epochs=epochs,
            batch_size=batch_size,
            seed=seed,
            plan=plan,
            journal_dir=jdir,
            standby=standby,
            trace_export=trace_export,
            device=device,
        )
    return clean, faulted, plan
