"""Serving fleet: replicated engines behind one router (counterpart of
``elephas_tpu/fleet/router.py``).

One :class:`~elephas_tpu_torch.serving.engine.InferenceEngine` is the
ceiling on the north-star's "millions of users"; the :class:`Router`
is the tier above it. It fronts N engine **replicas** — each serving
identical weights with its own arena, driver thread, and lock — and
spreads ``/v1/generate`` traffic across them with deterministic
two-stage placement (:mod:`elephas_tpu_torch.fleet.placement`):

1. **prefix affinity** — probe every live replica's
   ``prefix_warm_probe(prompt)`` (pure host work) and route to
   the warmest match above ``min_affinity_tokens``, so requests
   sharing a system prompt land where its K/V already lives;
2. **load balance** the rest by blocks-free / queue-depth read
   through a :class:`~elephas_tpu_torch.telemetry.aggregate.FleetScraper`
   view (no new metrics plumbing — each replica's ``scrape(
   full=False)`` is a scrape target); a stale view (every scrape
   failing) degrades to round-robin, counted.

The killer feature is **cross-replica live migration**: a request's
preemption offload record (blocks + cursor + last token)
serializes over the wire (:mod:`elephas_tpu_torch.fleet.migration`) and
resumes **bit-exact at temperature 0** on a different replica. That
powers :meth:`Router.drain` (empty a replica for deploys — zero
dropped, zero doubled tokens) and rebalancing under tenant skew.

Fault story: :meth:`Router.kill_replica` (driven by the chaos
harness's ``ReplicaKiller``) abandons a replica mid-stream; the
router **re-drives** its in-flight requests on the survivors from
their last delivered token (continuation prompt = prompt + delivered
tokens, remaining budget — at temperature 0 the continuation is the
identical stream, so clients see zero double tokens), and the
``replica_down`` watchdog rule fires off the router's
``elephas_router_replica_up`` gauge until the replica is restored.

Thread model: each replica runs its own driver thread behind its
engine's hand-off lock (the gateway's model, per replica); the router
serializes placement under one lock and token bookkeeping under another
(leaf — never held while taking an engine's lock). The optional HTTP front door
is the same asyncio HTTP/1.1 + SSE idiom as ``serving/gateway.py``.
On a card, every replica's driver launches on the engine's device in the
current stream, as one engine does; a killed replica's engine releases
its KV arena (``InferenceEngine.release_arena``) before the router
returns from ``kill_replica``, so a restored successor reuses that
memory instead of stacking a second arena beside a dead one.

Determinism contracts carried over: placement is a pure function of
the snapshot (tested same-process and cross-process); liveness is the
router's own host state — the telemetry view only RANKS, it never
vetoes (telemetry never drives control flow); wall clock appears
nowhere in a placement or re-drive decision.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import threading
import time

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.fleet.migration import decode_record, encode_record
from elephas_tpu_torch.fleet.placement import PlacementDecision, place
from elephas_tpu_torch.serving.gateway import (
    READ_TIMEOUT,
    _HttpError,
    _json_response,
    _response,
    _sse_event,
)

logger = logging.getLogger(__name__)

__all__ = ["Replica", "Router", "RouterRequest"]


class Replica:
    """One engine replica behind the router: the engine and its own
    driver thread (the gateway's threading model, one instance per
    replica). Submit, step, probe and a drain's export serialize on the
    engine's hand-off lock (``engine.lock``): the driver lets every
    waiting caller in before its next step, where a plain lock, taken
    again right after each step, would keep a drain waiting until the
    streams end.
    ``kill()`` is the chaos path — abrupt death, state abandoned;
    ``stop()`` is the graceful one (drain first if you care)."""

    def __init__(self, name: str, engine):
        self.name = str(name)
        self.engine = engine
        self._work = threading.Event()
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        # host-truth liveness: the router's placement reads THIS, not
        # any metric (telemetry never drives control flow)
        self.alive = True
        # router-installed crash hook: a driver that DIES (engine
        # error mid-step) must not strand its in-flight requests —
        # the router re-drives them exactly like a chaos kill
        self.on_death = None

    def start(self) -> "Replica":
        if self._thread is not None:
            raise RuntimeError(f"replica {self.name} already started")
        self._thread = threading.Thread(
            target=self._drive, name=f"replica-{self.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def _drive(self) -> None:
        try:
            while not self._stopping.is_set():
                self.engine.lock.yield_to_waiters()
                with self.engine.lock:
                    has_work = self.engine.scheduler.has_work
                    if has_work:
                        self.engine.step()
                if not has_work:
                    self._work.wait(timeout=0.02)
                    self._work.clear()
        except Exception:
            # a dead driver is a dead replica — loud, and visible to
            # the router's next placement (alive flips False); the
            # crash hook re-drives stranded work on the survivors
            logger.exception(
                "replica %s driver died mid-step", self.name
            )
            self.alive = False
            self.engine.release_arena()
            hook = self.on_death
            if hook is not None:
                try:
                    hook(self.name)
                except Exception:
                    logger.exception(
                        "replica %s crash hook failed — in-flight "
                        "requests on it are stranded", self.name,
                    )

    def submit(self, *args, **kwargs):
        with self.engine.lock:
            req = self.engine.submit(*args, **kwargs)
        self._work.set()
        return req

    def probe(self, prompt) -> int:
        """Prefix warmth of ``prompt`` on this replica — under the
        engine's lock, per the probe's synchronization contract."""
        with self.engine.lock:
            return int(self.engine.prefix_warm_probe(prompt))

    def scrape(self) -> str:
        """FleetScraper target: this replica's OWN series only
        (``full=False`` — N replicas share one process registry).
        Raises once dead, so the fleet view's ``up`` flag and the
        stale-degradation path behave exactly like a dead remote
        ``/metrics`` endpoint."""
        if not self.alive:
            raise ConnectionError(f"replica {self.name} is down")
        return self.engine.scrape(full=False)

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful stop: finish the current step, join the driver."""
        self._stopping.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def kill(self, timeout: float = 30.0) -> None:
        """Chaos death: mark dead FIRST (scrapes start failing, no new
        placements), then stop the driver. The engine's state is
        abandoned where it stood — exactly what a crashed process
        leaves behind."""
        self.alive = False
        self._stopping.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        # what a crashed process leaves is gone with its process: the
        # arena's device memory goes back before any successor is built
        self.engine.release_arena()


class RouterRequest:
    """The router's client-facing handle for one request: a STABLE
    rid (the first engine's mint — preserved across migration), the
    delivered-token list, and the bookkeeping re-drive/migration need.
    ``gen`` guards against straggler tokens from an abandoned replica:
    every re-drive bumps it, and the token shim drops emissions
    stamped with an older generation (counted, never delivered
    twice)."""

    __slots__ = (
        "rid", "prompt", "max_new_tokens", "temperature", "eos_id",
        "priority", "tenant", "ttft_deadline_ms", "tokens", "done",
        "error", "replica", "engine_rid", "gen", "redrives",
        "migrations", "on_token", "_done_event", "submit_time",
        "first_token_time",
    )

    def __init__(self, prompt, max_new_tokens, temperature, eos_id,
                 priority, tenant, ttft_deadline_ms, on_token):
        self.rid: int | None = None
        self.prompt = tuple(int(t) for t in prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.priority = int(priority)
        self.tenant = tenant
        self.ttft_deadline_ms = ttft_deadline_ms
        self.tokens: list[int] = []
        self.done = False
        self.error: BaseException | None = None
        self.replica: str | None = None
        self.engine_rid: int | None = None
        self.gen = 0
        self.redrives = 0
        self.migrations = 0
        self.on_token = on_token
        self._done_event = threading.Event()
        self.submit_time: float | None = None
        self.first_token_time: float | None = None

    @property
    def full_sequence(self) -> list:
        return list(self.prompt) + self.tokens

    @property
    def ttft(self) -> float | None:
        if self.first_token_time is None or self.submit_time is None:
            return None
        return self.first_token_time - self.submit_time

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the request finishes (or errors). True when
        done inside the timeout."""
        return self._done_event.wait(timeout)


class Router:
    """N engine replicas behind prefix- and load-aware placement.

    ``engines`` is ``{name: InferenceEngine}`` (or a list — names
    default to ``replica-<i>``); every replica must serve identical
    weights (the migration/re-drive bit-exactness contract rides on
    it). ``placement`` selects the strategy: ``"affinity"`` (default —
    the full two-stage algorithm), ``"load"`` (skip the prefix
    probes), or ``"round_robin"`` (the bench's control arm).
    ``poll_every`` sets how many placements ride one fleet-view poll
    (the view is ranking information — a few placements of staleness
    cost balance, never correctness). ``port`` arms the HTTP front
    door on :meth:`start` (``0`` = ephemeral; ``None`` = in-process
    only).

    Use as a context manager, or pair :meth:`start`/:meth:`stop`.
    """

    _PLACEMENTS = ("affinity", "load", "round_robin")

    def __init__(self, engines, *, min_affinity_tokens: int = 8,
                 placement: str = "affinity", poll_every: int = 8,
                 host: str = "127.0.0.1", port: int | None = None,
                 read_timeout: float = READ_TIMEOUT,
                 max_body: int = 1 << 20):
        if placement not in self._PLACEMENTS:
            raise ValueError(
                f"placement must be one of {self._PLACEMENTS}, got "
                f"{placement!r}"
            )
        if not isinstance(engines, dict):
            engines = {
                f"replica-{i}": e for i, e in enumerate(engines)
            }
        if not engines:
            raise ValueError("a router needs at least one replica")
        self.replicas: dict[str, Replica] = {
            str(name): Replica(name, engine)
            for name, engine in engines.items()
        }
        self.min_affinity_tokens = max(1, int(min_affinity_tokens))
        self.placement = placement
        self.poll_every = max(1, int(poll_every))
        self.host = host
        self._want_port = port
        self.port: int | None = None
        self.read_timeout = float(read_timeout)
        self.max_body = int(max_body)
        # placement state: serialized under _lock (rr cursor, view,
        # poll countdown, draining set)
        self._lock = threading.Lock()
        self._rr = 0
        self._view: dict = {}
        self._placements_since_poll = self.poll_every  # poll on first
        self._draining: set[str] = set()
        # canary split: replicas running the NEXT weight
        # generation plus the traffic share routed to them. The split
        # is a deterministic counter walk (int(seq*share) increments),
        # not a random draw — same submit sequence, same canary
        # assignment, on every process (and no wall clock / RNG in a
        # placement decision, per the standing contract)
        self._canary: set[str] = set()
        self._canary_share = 0.0
        self._canary_seq = 0
        # token bookkeeping: LEAF lock — taken from driver threads'
        # on_token shims and from re-drive/drain; never held while
        # acquiring an engine's lock
        self._emit_lock = threading.Lock()
        self._inflight: dict[int, RouterRequest] = {}
        self._by_engine_rid: dict[int, RouterRequest] = {}
        self._completed = 0
        # serializes whole re-drive SWEEPS: a chaos kill racing the
        # submit-time dead-replica check (or a crashed driver's hook)
        # must not run two overlapping sweeps — both would bump a
        # victim's generation and then both resubmit under the final
        # gen, double-delivering its tokens. Under this lock the
        # second sweep re-snapshots and finds the victims already
        # moved (replica no longer the dead one).
        self._redrive_lock = threading.Lock()
        # plain host counters — control-flow-safe truth the chaos
        # trigger and the bench cross-check read (the registry series
        # below are the report-only views; a test pins them equal)
        self._tokens_delivered = 0
        self._stale_tokens = 0
        self._started = False
        self._stopped = False
        # HTTP front door plumbing (gateway idiom)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._loop_thread: threading.Thread | None = None
        self._tasks: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()
        # telemetry captured at construction (standing null contract)
        reg = telemetry.registry()
        self._tracer = telemetry.tracer()
        rid_label = telemetry.instance_label()
        self.telemetry_label = rid_label
        self._registry = reg
        self._m_requests = reg.counter(
            "elephas_router_requests_total",
            "HTTP requests served by the fleet router, by route and "
            "status",
            labels=("router", "route", "code"),
        )
        self._mf_placements = reg.counter(
            "elephas_router_placements_total",
            "Requests placed onto a replica, by replica and placement "
            "kind (affinity / load / round_robin)",
            labels=("router", "replica", "kind"),
        )
        self._m_stale = reg.counter(
            "elephas_router_stale_placements_total",
            "Placements that degraded to round-robin because the "
            "whole fleet view was stale",
            labels=("router",),
        ).labels(router=rid_label)
        self._m_tokens = reg.counter(
            "elephas_router_tokens_delivered_total",
            "Tokens the router delivered to clients (each exactly "
            "once, across migrations and re-drives)",
            labels=("router",),
        ).labels(router=rid_label)
        self._m_stale_tokens = reg.counter(
            "elephas_router_stale_tokens_dropped_total",
            "Straggler tokens from an abandoned replica generation "
            "dropped by the delivery guard (never sent twice)",
            labels=("router",),
        ).labels(router=rid_label)
        self._m_redrives = reg.counter(
            "elephas_router_redriven_requests_total",
            "In-flight requests re-driven onto a survivor after their "
            "replica died",
            labels=("router",),
        ).labels(router=rid_label)
        self._m_migrations = reg.counter(
            "elephas_router_migrated_requests_total",
            "Requests live-migrated between replicas (drain / "
            "rebalance), wire round-trip included",
            labels=("router",),
        ).labels(router=rid_label)
        self._m_drains = reg.counter(
            "elephas_router_drains_total",
            "Replica drains completed",
            labels=("router",),
        ).labels(router=rid_label)
        self._g_canary_share = reg.gauge(
            "elephas_router_canary_share",
            "Traffic share routed to the canary replica pool (0 = no "
            "canary active)",
            labels=("router",),
        ).labels(router=rid_label)
        self._g_canary_share.set(0.0)
        self._mf_up = reg.gauge(
            "elephas_router_replica_up",
            "1 while the router considers the replica alive (the "
            "replica_down watchdog rule fires on 0)",
            labels=("router", "replica"),
        )
        for name in sorted(self.replicas):
            self._mf_up.labels(router=rid_label, replica=name).set(1)
            self.replicas[name].on_death = self._on_replica_death
        # the fleet view: every replica's own series under one
        # instance-labeled exposition (poll-on-render off — the router
        # polls at ITS cadence; /metrics re-renders the last view)
        from elephas_tpu_torch.telemetry.aggregate import FleetScraper

        self.scraper = FleetScraper(
            targets={
                name: rep.scrape
                for name, rep in sorted(self.replicas.items())
            },
            poll_on_render=False,
        )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Router":
        if self._started:
            raise RuntimeError("router already started")
        self._started = True
        for name in sorted(self.replicas):
            self.replicas[name].start()
        self.refresh_view()
        if self._want_port is not None:
            self._start_http()
        logger.info(
            "router fronting %d replica(s)%s: %s",
            len(self.replicas),
            "" if self.port is None else f" on {self.host}:{self.port}",
            sorted(self.replicas),
        )
        return self

    def stop(self) -> None:
        """Graceful teardown: stop the HTTP front door (severing live
        SSE streams), then every replica driver. Idempotent."""
        if not self._started or self._stopped:
            return
        self._stopped = True
        self._stop_http()
        for name in sorted(self.replicas):
            self.replicas[name].stop()
        logger.info("router stopped (%d replicas)", len(self.replicas))

    def __enter__(self) -> "Router":
        return self.start() if not self._started else self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def release_telemetry(self) -> None:
        """Retire this router's labeled series and its scraper's
        (explicit-only, the standing retirement contract). Replica
        engines retire their own."""
        telemetry.remove_series(router=self.telemetry_label)
        self.scraper.release_telemetry()

    # -- fleet view -----------------------------------------------------

    def refresh_view(self) -> dict:
        """Poll every replica's scrape target and rebuild the load
        view placement ranks by. Called on start, every
        ``poll_every`` placements, and after membership changes."""
        self.scraper.poll()
        view = self.scraper.fleet_stats()
        with self._lock:
            self._view = view
            self._placements_since_poll = 0
        return view

    # -- placement ------------------------------------------------------

    def _alive_names(self, exclude=()) -> list[str]:
        return [
            name for name in sorted(self.replicas)
            if self.replicas[name].alive
            and name not in self._draining
            and name not in exclude
        ]

    def _place(self, prompt, exclude=()) -> PlacementDecision:
        """One placement decision: probe + rank under the placement
        lock (the rr cursor and stale counter are shared state).

        With a canary active, the fleet first splits into
        canary / stable pools and the deterministic counter walk picks
        which pool serves this request; the normal two-stage placement
        then runs WITHIN the pool. Placements into the canary pool are
        counted (and traced) as kind ``"canary"``. If either pool has
        no live member the split is skipped — a dead canary must not
        take the whole fleet down with it."""
        names = self._alive_names(exclude)
        if not names:
            raise RuntimeError(
                "no live replica to place on — the fleet is down"
            )
        canary_pick = False
        with self._lock:
            if self._canary and self._canary_share > 0.0:
                cpool = [n for n in names if n in self._canary]
                spool = [n for n in names if n not in self._canary]
                if cpool and spool:
                    self._canary_seq += 1
                    seq, share = self._canary_seq, self._canary_share
                    canary_pick = (
                        int(seq * share) != int((seq - 1) * share)
                    )
                    names = cpool if canary_pick else spool
        if self.placement == "round_robin":
            # the bench's control arm: placement ignores warmth and
            # load entirely (counted as its own kind, not as stale)
            with self._lock:
                pick = names[self._rr % len(names)]
                self._rr += 1
            decision = PlacementDecision(pick, "round_robin")
        elif len(names) == 1:
            decision = PlacementDecision(names[0], "load")
        else:
            probes = {
                name: (
                    self.replicas[name].probe(prompt)
                    if self.placement == "affinity" else 0
                )
                for name in names
            }
            with self._lock:
                decision = place(
                    probes, self._view, self.min_affinity_tokens,
                    self._rr,
                )
                self._placements_since_poll += 1
                need_poll = (
                    self._placements_since_poll >= self.poll_every
                )
                if decision.kind == "round_robin":
                    # degraded floor: the whole view was stale
                    self._rr += 1
                    self._m_stale.inc()
            if need_poll:
                self.refresh_view()
        if canary_pick:
            decision = PlacementDecision(decision.replica, "canary")
        return decision

    # -- canary ---------------------------------------------------------

    def set_canary(self, names, share: float) -> None:
        """Route ``share`` (0..1) of subsequent placements to the
        ``names`` replica pool (the replicas serving the candidate
        weight generation). Validates loudly: unknown replicas and a
        canary pool that swallows the whole fleet are configuration
        bugs, not conditions to limp through. Replaces any previous
        canary; the deterministic split counter restarts."""
        if isinstance(names, str):
            names = [names]
        names = {str(n) for n in names}
        if not names:
            raise ValueError("a canary needs at least one replica")
        unknown = names - set(self.replicas)
        if unknown:
            raise ValueError(
                f"canary names {sorted(unknown)} are not replicas of "
                f"this router (have {sorted(self.replicas)})"
            )
        if not names < set(self.replicas):
            raise ValueError(
                "canary pool covers every replica — there would be no "
                "stable pool to roll back to"
            )
        share = float(share)
        if not 0.0 < share <= 1.0:
            raise ValueError(
                f"canary share must be in (0, 1], got {share}"
            )
        with self._lock:
            self._canary = names
            self._canary_share = share
            self._canary_seq = 0
        self._g_canary_share.set(share)
        self._tracer.emit(
            "router.canary", router=self.telemetry_label,
            replicas=",".join(sorted(names)), share=share,
        )

    def clear_canary(self) -> None:
        """End the canary split (promotion or rollback both land
        here): every placement sees the full fleet again."""
        with self._lock:
            self._canary = set()
            self._canary_share = 0.0
            self._canary_seq = 0
        self._g_canary_share.set(0.0)
        self._tracer.emit(
            "router.canary", router=self.telemetry_label,
            replicas="", share=0.0,
        )

    def canary_status(self) -> dict:
        """The live canary split, for supervisors and tests."""
        with self._lock:
            return {
                "replicas": sorted(self._canary),
                "share": self._canary_share,
                "placements_seen": self._canary_seq,
            }

    # -- submission -----------------------------------------------------

    def _forget(self, rreq: RouterRequest) -> None:
        """Drop a finished request from BOTH rid maps (caller holds
        ``_emit_lock``). ``rreq.rid`` is the stable first-engine rid;
        ``engine_rid`` the current one after re-drives — popping both
        keeps ``_by_engine_rid`` from growing without bound."""
        self._inflight.pop(rreq.rid, None)
        self._by_engine_rid.pop(rreq.engine_rid, None)
        self._by_engine_rid.pop(rreq.rid, None)

    def _shim(self, rreq: RouterRequest, gen: int):
        """Engine-facing ``on_token``: deliver each token EXACTLY once
        to the client, guarded by the request's generation (a
        straggler from an abandoned replica is dropped and counted).
        ``token=None`` is the engine's stream-end sentinel (a cancel —
        no final token exists): terminal bookkeeping runs, nothing is
        counted as delivered, and the sentinel forwards to the client
        callback so a blocking consumer unblocks."""

        def on_token(token, done):
            with self._emit_lock:
                if rreq.gen != gen or rreq.done:
                    if token is not None:
                        self._stale_tokens += 1
                        self._m_stale_tokens.inc()
                    return
                if token is not None:
                    rreq.tokens.append(int(token))
                    self._tokens_delivered += 1
                    if rreq.first_token_time is None:
                        rreq.first_token_time = time.perf_counter()
                if done:
                    rreq.done = True
                    self._forget(rreq)
                    self._completed += 1
            if token is not None:
                self._m_tokens.inc()
            cb = rreq.on_token
            if cb is not None:
                # a raising client callback propagates into the
                # ENGINE's callback-error path (fails that engine-side
                # request cleanly); mirror the failure on the handle
                try:
                    cb(token, done)
                except BaseException as e:
                    with self._emit_lock:
                        rreq.error = e
                        rreq.done = True
                        self._forget(rreq)
                    rreq._done_event.set()
                    raise
            if done:
                rreq._done_event.set()

        return on_token

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, eos_id: int | None = None,
               priority: int = 0, tenant: str | None = None,
               ttft_deadline_ms: float | None = None,
               on_token=None) -> RouterRequest:
        """Place and submit one generation request; returns the
        router-level handle (stable rid, delivered tokens,
        ``wait()``). ``on_token(token, done)`` streams tokens as the
        owning replica emits them — across migrations and re-drives,
        each token exactly once."""
        rreq = RouterRequest(
            prompt, max_new_tokens, temperature, eos_id, priority,
            tenant, ttft_deadline_ms, on_token,
        )
        decision = self._place(rreq.prompt)
        rep = self.replicas[decision.replica]
        rreq.submit_time = time.perf_counter()
        ereq = rep.submit(
            list(rreq.prompt), rreq.max_new_tokens,
            temperature=rreq.temperature, eos_id=rreq.eos_id,
            priority=rreq.priority, tenant=rreq.tenant,
            ttft_deadline_ms=rreq.ttft_deadline_ms,
            on_token=self._shim(rreq, rreq.gen),
        )
        rreq.rid = ereq.rid
        rreq.engine_rid = ereq.rid
        rreq.replica = decision.replica
        self._mf_placements.labels(
            router=self.telemetry_label, replica=decision.replica,
            kind=decision.kind,
        ).inc()
        self._tracer.emit(
            "router.place", rid=ereq.rid, replica=decision.replica,
            kind=decision.kind,
        )
        if ereq.error is not None:
            # rejected at submit (admission control / never-fit):
            # surface on the handle, nothing in flight
            rreq.error = ereq.error
            rreq.done = True
            rreq._done_event.set()
            return rreq
        with self._emit_lock:
            if not rreq.done:  # tiny prompts can finish mid-submit
                self._inflight[rreq.rid] = rreq
                self._by_engine_rid[ereq.rid] = rreq
        if not rep.alive:
            # the replica died between placement and registration —
            # the kill's re-drive sweep may have missed this request;
            # sweep again (idempotent: already-moved requests are no
            # longer marked on the dead replica)
            self._redrive(decision.replica)
        return rreq

    # -- failure: re-drive ----------------------------------------------

    def kill_replica(self, name: str) -> int:
        """Chaos entry (the fault harness's ``ReplicaKiller`` calls
        this): abandon ``name`` mid-stream — driver stopped, engine
        state lost, exactly a crashed process — then RE-DRIVE its
        in-flight requests on the survivors from their last delivered
        token. Returns the number of requests re-driven. Clients see
        zero dropped and zero doubled tokens: the continuation prompt
        is (prompt + delivered tokens) with the remaining budget, and
        the generation guard drops any straggler the dying driver
        managed to emit."""
        rep = self._replica(name)
        rep.kill()
        return self._mark_down(name)

    def _mark_down(self, name: str) -> int:
        """Shared death path (chaos kill AND crashed driver): flip the
        liveness gauge, surface the event, refresh the fleet view (the
        dead scrape flips ``elephas_fleet_up``), then re-drive."""
        self._mf_up.labels(
            router=self.telemetry_label, replica=name
        ).set(0)
        self._tracer.emit("router.replica_down", replica=name)
        logger.warning(
            "replica %s is down — re-driving its in-flight requests",
            name,
        )
        self.refresh_view()
        return self._redrive(name)

    def _on_replica_death(self, name: str) -> None:
        """Crash hook, called from the DYING driver thread itself (its
        engine's lock is released — the ``with`` unwound on the
        exception). Same path as a chaos kill, minus ``kill()``: the
        driver is already gone."""
        self._mark_down(name)

    def restore_replica(self, name: str, engine) -> None:
        """Bring a dead replica back with a FRESH engine (the deploy
        shape: the process restarted). Placement resumes; the
        ``replica_down`` watchdog rule clears on its next evaluation."""
        rep = self._replica(name)
        if rep.alive:
            raise ValueError(f"replica {name} is not down")
        fresh = Replica(name, engine)
        fresh.on_death = self._on_replica_death
        self.replicas[name] = fresh
        with self._lock:
            # a replica that died while (or after) draining comes
            # back SERVING — leaving it in the draining set would
            # exclude the fresh engine from placement forever
            self._draining.discard(name)
        self.scraper.remove_target(name)
        self.scraper.add_target(name, fresh.scrape)
        if self._started and not self._stopped:
            fresh.start()
        self._mf_up.labels(
            router=self.telemetry_label, replica=name
        ).set(1)
        self._tracer.emit("router.replica_restored", replica=name)
        self.refresh_view()

    def _notify_terminal(self, rreq: RouterRequest) -> None:
        """Forward the stream-end sentinel to the client callback for
        a terminal reached WITHOUT a final engine token (re-drive
        resubmission rejected, lost-done recovery): an HTTP handler
        blocking on the token stream must unblock, not hang."""
        cb = rreq.on_token
        if cb is not None:
            try:
                cb(None, True)
            except BaseException:
                logger.exception(
                    "stream-end notification for %d failed", rreq.rid
                )

    def _redrive(self, dead: str) -> int:
        # one sweep at a time: two overlapping sweeps (a chaos kill
        # racing submit()'s dead-replica check, or a crashed driver's
        # hook) would EACH bump a victim's generation and then both
        # resubmit reading the final gen — double delivery. Under the
        # lock the later sweep re-snapshots and finds the victims
        # already moved to a survivor (replica != dead), so it skips
        # them; the sweep is idempotent.
        with self._redrive_lock:
            return self._redrive_locked(dead)

    def _redrive_locked(self, dead: str) -> int:
        with self._emit_lock:
            victims = [
                r for r in self._inflight.values()
                if r.replica == dead and not r.done
            ]
            for r in victims:
                r.gen += 1  # straggler guard arms BEFORE resubmission
        count = 0
        for rreq in sorted(victims, key=lambda r: r.rid):
            with self._emit_lock:
                emitted = list(rreq.tokens)
                gen = rreq.gen
            finished = (
                len(emitted) >= rreq.max_new_tokens
                or (
                    rreq.eos_id is not None and emitted
                    and emitted[-1] == rreq.eos_id
                )
            )
            if finished:
                # the final token was already delivered — only the
                # done flag was lost with the replica
                with self._emit_lock:
                    rreq.done = True
                    self._forget(rreq)
                    self._completed += 1
                self._notify_terminal(rreq)
                rreq._done_event.set()
                continue
            continuation = list(rreq.prompt) + emitted
            remaining = rreq.max_new_tokens - len(emitted)
            try:
                decision = self._place(continuation, exclude=(dead,))
                rep = self.replicas[decision.replica]
                ereq = rep.submit(
                    continuation, remaining,
                    temperature=rreq.temperature, eos_id=rreq.eos_id,
                    priority=rreq.priority, tenant=rreq.tenant,
                    # the TTFT deadline belonged to the FIRST token;
                    # only a request that never got one carries it on
                    ttft_deadline_ms=(
                        rreq.ttft_deadline_ms if not emitted else None
                    ),
                    on_token=self._shim(rreq, gen),
                )
            except Exception as e:
                # no placement target (every survivor draining/dead)
                # or a refused resubmission: THIS victim fails loudly
                # — done+error+sentinel, never a silent forever-wait —
                # and the sweep continues; stranding the REMAINING
                # victims behind one failure would hang their clients
                logger.exception(
                    "re-drive of %d after %s died failed",
                    rreq.rid, dead,
                )
                with self._emit_lock:
                    rreq.error = e
                    rreq.done = True
                    self._forget(rreq)
                self._notify_terminal(rreq)
                rreq._done_event.set()
                continue
            with self._emit_lock:
                rreq.replica = decision.replica
                # the old engine rid died with its replica — retire
                # its map entry as the new one takes over
                self._by_engine_rid.pop(rreq.engine_rid, None)
                rreq.engine_rid = ereq.rid
                rreq.redrives += 1
                self._by_engine_rid[ereq.rid] = rreq
                if ereq.error is not None:
                    rreq.error = ereq.error
                    rreq.done = True
                    self._forget(rreq)
            if ereq.error is not None:
                self._notify_terminal(rreq)
                rreq._done_event.set()
            self._m_redrives.inc()
            self._tracer.emit(
                "router.redrive", rid=rreq.rid,
                replica=decision.replica, emitted=len(emitted),
                remaining=remaining,
            )
            count += 1
        return count

    # -- drain: live migration ------------------------------------------

    def drain(self, name: str, timeout: float = 120.0) -> int:
        """Empty one LIVE replica by migrating every queued and
        in-flight request to the survivors — the deploy/rebalance
        path. Requests with resident K/V travel WARM (preempt →
        offload record → wire round-trip → resume bit-exact);
        waiting/mid-prefill ones travel cold. New placements stop
        landing on the replica the moment the drain starts (it stays
        excluded until :meth:`undrain`). Returns the number of
        requests migrated; the replica is idle when this returns —
        zero dropped, zero doubled tokens (the streams' shims move
        with the records)."""
        rep = self._replica(name)
        if not rep.alive:
            raise ValueError(
                f"cannot drain dead replica {name} — re-drive already "
                f"owns its work"
            )
        others = self._alive_names(exclude=(name,))
        if not others:
            raise RuntimeError(
                f"cannot drain {name}: no other live replica to "
                f"migrate onto"
            )
        with self._lock:
            self._draining.add(name)
        try:
            migrated = self._drain_locked(rep, name, timeout)
        except BaseException:
            # an incomplete drain must not silently shrink placement
            # capacity forever — the replica is still live and still
            # owns its leftovers, so re-admit it, then surface the
            # failure (a COMPLETED drain keeps the replica excluded
            # until undrain(): that is the deploy semantic)
            self.undrain(name)
            raise
        self._m_drains.inc()
        return migrated

    def _drain_locked(self, rep: Replica, name: str,
                      timeout: float) -> int:
        migrated = 0
        deadline = time.monotonic() + float(timeout)
        with self._tracer.span("router.drain", replica=name) as span:
            while True:
                with rep.engine.lock:
                    sched = rep.engine.scheduler
                    rids = [r.rid for r in list(sched.waiting)]
                    rids += [
                        r.rid
                        for _s, r in sorted(sched.active.items())
                    ]
                if not rids:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"drain of {name} still has {len(rids)} "
                        f"request(s) after {timeout}s"
                    )
                progressed = False
                for erid in rids:
                    try:
                        with rep.engine.lock:
                            payload = rep.engine.export_request(erid)
                    except KeyError:
                        continue  # finished since the snapshot
                    except ValueError:
                        continue  # unexportable here — let it finish
                    # the WIRE round-trip, even in-process: every
                    # drain exercises the serialization format
                    record = decode_record(encode_record(payload))
                    try:
                        migrated += self._import_record(
                            record, exclude=(name,)
                        )
                    except Exception:
                        # a refused import (heterogeneous replica
                        # slipped into the fleet?) must NOT lose the
                        # request mid-drain — put it back where it
                        # was, stream re-attached, then fail loudly
                        undo_rreq = self._by_engine_rid.get(
                            int(record["rid"])
                        )
                        undo_shim = None
                        if undo_rreq is not None:
                            with self._emit_lock:
                                undo_shim = self._shim(
                                    undo_rreq, undo_rreq.gen
                                )
                        with rep.engine.lock:
                            rep.engine.import_request(
                                record, on_token=undo_shim
                            )
                        rep._work.set()
                        raise
                    progressed = True
                if not progressed:
                    time.sleep(0.005)  # unexportable leftovers decode
            span.set(migrated=migrated)
        return migrated

    def undrain(self, name: str) -> None:
        """Re-admit a drained replica to placement."""
        with self._lock:
            self._draining.discard(name)

    def _import_record(self, record: dict, exclude=()) -> int:
        """Place one decoded migration record on a survivor and
        re-attach its stream. Returns 1 (count convenience)."""
        erid = int(record["rid"])
        rreq = self._by_engine_rid.get(erid)
        decision = self._place(
            list(record["prompt"]) + list(record["tokens"]),
            exclude=exclude,
        )
        target = self.replicas[decision.replica]
        shim = None
        if rreq is not None:
            with self._emit_lock:
                shim = self._shim(rreq, rreq.gen)
        with target.engine.lock:
            target.engine.import_request(record, on_token=shim)
        target._work.set()
        if rreq is not None:
            with self._emit_lock:
                rreq.replica = decision.replica
                rreq.migrations += 1
        self._m_migrations.inc()
        self._tracer.emit(
            "router.migrate", rid=erid, replica=decision.replica,
            warm=int(record.get("n_blocks") or 0) > 0,
        )
        return 1

    # -- introspection --------------------------------------------------

    def _replica(self, name: str) -> Replica:
        rep = self.replicas.get(str(name))
        if rep is None:
            raise KeyError(
                f"unknown replica {name!r} — have "
                f"{sorted(self.replicas)}"
            )
        return rep

    @property
    def tokens_delivered(self) -> int:
        """Plain host-truth delivered-token count (control-flow safe:
        the chaos trigger and the bench cross-check read this; the
        registry counter is its report-only twin)."""
        return self._tokens_delivered

    def stats(self) -> dict:
        """Fleet-level counters: placements by kind and replica,
        delivery/redrive/migration totals (registry-backed — stats
        and a scrape can never drift), per-replica liveness, and the
        last fleet view."""
        kinds = {"affinity": 0, "load": 0, "round_robin": 0}
        per_replica: dict[str, dict] = {}
        label = self.telemetry_label
        for name in sorted(self.replicas):
            rep = self.replicas[name]
            placed = 0
            for kind in kinds:
                v = int(self._mf_placements.labels(
                    router=label, replica=name, kind=kind
                ).value)
                kinds[kind] += v
                placed += v
            per_replica[name] = {
                "alive": rep.alive,
                "draining": name in self._draining,
                "placements": placed,
            }
        with self._emit_lock:
            in_flight = len(self._inflight)
            completed = self._completed
        return {
            "replicas": per_replica,
            "placements": kinds,
            "placement_mode": self.placement,
            "min_affinity_tokens": self.min_affinity_tokens,
            "stale_placements": int(self._m_stale.value),
            "tokens_delivered": self._tokens_delivered,
            "stale_tokens_dropped": self._stale_tokens,
            "redriven": int(self._m_redrives.value),
            "migrated": int(self._m_migrations.value),
            "drains": int(self._m_drains.value),
            "in_flight": in_flight,
            "completed": completed,
            "fleet": self.scraper.fleet_stats(),
        }

    # -- HTTP front door (gateway idiom) --------------------------------

    _DRAIN_PATH = re.compile(r"^/v1/replicas/([A-Za-z0-9._-]+)/drain$")

    def _route_label(self, method: str, path: str) -> str:
        bare = path.split("?", 1)[0]
        if method == "POST" and self._DRAIN_PATH.match(bare):
            return "POST /v1/replicas/:name/drain"
        route = f"{method} {bare}"
        if route in (
            "POST /v1/generate", "GET /metrics", "GET /fleet",
            "GET /healthz",
        ):
            return route
        return "other"

    def _start_http(self) -> None:
        ready = threading.Event()
        boot_err: list[BaseException] = []

        def loop_main():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(
                        self._handle, self.host, self._want_port
                    )
                )
            except OSError as e:
                boot_err.append(e)
                loop.close()
                ready.set()
                return
            self.port = self._server.sockets[0].getsockname()[1]
            ready.set()
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._loop_thread = threading.Thread(
            target=loop_main, name="router-loop", daemon=True
        )
        self._loop_thread.start()
        ready.wait()
        if boot_err:
            raise boot_err[0]

    def _stop_http(self) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        done = threading.Event()
        loop.call_soon_threadsafe(
            lambda: loop.create_task(self._shutdown(done))
        )
        done.wait(timeout=30)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=30)

    async def _shutdown(self, done: threading.Event) -> None:
        loop = asyncio.get_running_loop()
        try:
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
            for w in list(self._writers):
                try:
                    w.close()
                except OSError:
                    pass  # fault-lint: allow — already-dead transport
            for t in list(self._tasks):
                t.cancel()
            if self._tasks:
                await asyncio.gather(
                    *list(self._tasks), return_exceptions=True
                )
        finally:
            done.set()
            loop.stop()

    async def _handle(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        self._writers.add(writer)
        route, code = "other", 500
        try:
            try:
                method, path, body = await asyncio.wait_for(
                    self._read_request(reader), self.read_timeout
                )
                route = self._route_label(method, path)
                code = await self._route(method, path, body, writer)
            except _HttpError as e:
                code = e.code
                await self._write(writer, _json_response(
                    e.code, {"error": str(e)}, e.extra_headers
                ))
            except asyncio.TimeoutError:
                code = 408
                await self._write(writer, _json_response(
                    408, {"error": "request read timed out"}
                ))
        except (ConnectionError, OSError) as e:
            logger.info("router connection dropped (%r)", e)
        except asyncio.CancelledError:
            pass  # fault-lint: allow — deliberate sever on stop()
        except Exception:
            logger.exception("router handler failed")
            code = 500
        finally:
            self._m_requests.labels(
                router=self.telemetry_label, route=route,
                code=str(code),
            ).inc()
            self._writers.discard(writer)
            self._tasks.discard(task)
            try:
                writer.close()
            except OSError:
                pass  # fault-lint: allow — already-severed transport

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            raise _HttpError(400, "empty request")
        try:
            method, path, _version = line.decode("ascii").split()
        except ValueError:
            raise _HttpError(400, f"malformed request line {line!r}")
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= 128:
                raise _HttpError(400, "too many headers")
            if b":" in h:
                k, v = h.split(b":", 1)
                headers[k.strip().lower().decode("ascii")] = (
                    v.strip().decode("latin-1")
                )
        body = b""
        if method == "POST":
            try:
                n = int(headers.get("content-length", "0"))
            except ValueError:
                raise _HttpError(400, "bad Content-Length")
            if n > self.max_body:
                raise _HttpError(
                    413, f"body of {n} bytes exceeds {self.max_body}"
                )
            if n:
                body = await reader.readexactly(n)
        return method, path, body

    async def _write(self, writer, data: bytes) -> None:
        writer.write(data)
        await writer.drain()

    async def _route(self, method, path, body, writer) -> int:
        path = path.split("?", 1)[0]
        if path == "/v1/generate":
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._http_generate(body, writer)
        if path == "/metrics":
            if method != "GET":
                raise _HttpError(405, "GET only")
            loop = asyncio.get_running_loop()

            def render():
                self.scraper.poll()
                return (
                    self.scraper.render()
                    + telemetry.render(
                        self._registry,
                        only={"router": self.telemetry_label},
                    )
                ).encode("utf-8")

            text = await loop.run_in_executor(None, render)
            await self._write(writer, _response(
                200, text, telemetry.CONTENT_TYPE
            ))
            return 200
        if path == "/fleet":
            if method != "GET":
                raise _HttpError(405, "GET only")
            loop = asyncio.get_running_loop()
            body_bytes = await loop.run_in_executor(
                None,
                lambda: json.dumps(
                    self.stats(), default=float
                ).encode("utf-8") + b"\n",
            )
            await self._write(writer, _response(
                200, body_bytes, "application/json"
            ))
            return 200
        if path == "/healthz":
            if method != "GET":
                raise _HttpError(405, "GET only")
            replicas = {
                name: {
                    "alive": rep.alive,
                    "draining": name in self._draining,
                }
                for name, rep in sorted(self.replicas.items())
            }
            n_up = sum(1 for r in replicas.values() if r["alive"])
            status = (
                "ok" if n_up == len(replicas)
                else "degraded" if n_up else "down"
            )
            await self._write(writer, _json_response(
                200 if n_up else 503,
                {"status": status, "replicas": replicas},
            ))
            return 200 if n_up else 503
        m = self._DRAIN_PATH.match(path)
        if m is not None:
            if method != "POST":
                raise _HttpError(405, "POST only")
            name = m.group(1)
            loop = asyncio.get_running_loop()
            try:
                migrated = await loop.run_in_executor(
                    None, lambda: self.drain(name)
                )
            except KeyError as e:
                raise _HttpError(404, str(e).strip("'\""))
            except (ValueError, RuntimeError, TimeoutError) as e:
                raise _HttpError(409, str(e))
            await self._write(writer, _json_response(
                200, {"replica": name, "migrated": migrated}
            ))
            return 200
        raise _HttpError(404, f"no route {path}")

    def _parse_generate(self, body: bytes) -> dict:
        try:
            spec = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _HttpError(400, f"bad JSON body: {e}")
        if not isinstance(spec, dict):
            raise _HttpError(400, "body must be a JSON object")
        unknown = set(spec) - {
            "prompt", "max_new_tokens", "temperature", "eos_id",
            "tenant", "ttft_deadline_ms", "priority", "stream",
        }
        if unknown:
            raise _HttpError(400, f"unknown fields {sorted(unknown)}")
        if "prompt" not in spec or "max_new_tokens" not in spec:
            raise _HttpError(
                400, "prompt and max_new_tokens are required"
            )
        return spec

    async def _http_generate(self, body, writer) -> int:
        spec = self._parse_generate(body)
        stream = bool(spec.pop("stream", True))
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(token, done):
            # token None = stream-end sentinel (cancel / re-drive
            # rejection): forward it, the consumer loops end cleanly
            loop.call_soon_threadsafe(
                q.put_nowait,
                (None if token is None else int(token), bool(done)),
            )

        def do_submit():
            return self.submit(
                spec["prompt"], spec["max_new_tokens"],
                temperature=float(spec.get("temperature", 0.0)),
                eos_id=spec.get("eos_id"),
                tenant=spec.get("tenant"),
                ttft_deadline_ms=spec.get("ttft_deadline_ms"),
                priority=int(spec.get("priority", 0)),
                on_token=on_token,
            )

        try:
            rreq = await loop.run_in_executor(None, do_submit)
        except (ValueError, TypeError) as e:
            raise _HttpError(400, str(e))
        except RuntimeError as e:
            raise _HttpError(503, str(e))
        if rreq.error is not None:
            from elephas_tpu_torch.serving.policy import AdmissionRejected

            rid_hdr = ("X-Request-Id", str(rreq.rid))
            if isinstance(rreq.error, AdmissionRejected):
                raise _HttpError(
                    429, str(rreq.error),
                    extra_headers=(
                        ("Retry-After", str(max(1, round(
                            rreq.error.retry_after_s
                        )))),
                        rid_hdr,
                    ),
                )
            raise _HttpError(
                422, str(rreq.error), extra_headers=(rid_hdr,)
            )
        if stream:
            return await self._stream_sse(rreq, q, writer)
        tokens = []
        while True:
            token, done = await q.get()
            if token is not None:
                tokens.append(token)
            if done:
                break
        payload = {
            "rid": rreq.rid,
            "replica": rreq.replica,
            "tokens": tokens,
            "full_sequence": rreq.full_sequence,
            "error": None if rreq.error is None else str(rreq.error),
        }
        await self._write(writer, _json_response(
            200, payload,
            extra_headers=(("X-Request-Id", str(rreq.rid)),),
        ))
        return 200

    async def _stream_sse(self, rreq, q, writer) -> int:
        head = (
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"X-Request-Id: " + str(rreq.rid).encode("ascii") + b"\r\n"
            b"Connection: close\r\n\r\n"
        )
        try:
            await self._write(writer, head)
            await self._write(writer, _sse_event(
                {"rid": rreq.rid, "replica": rreq.replica}
            ))
            while True:
                token, done = await q.get()
                if token is not None:
                    await self._write(
                        writer,
                        _sse_event({"token": token, "done": done}),
                    )
                if done:
                    break
            await self._write(writer, _sse_event({
                "rid": rreq.rid,
                "n_tokens": len(rreq.tokens),
                "replica": rreq.replica,
                "redrives": rreq.redrives,
                "migrations": rreq.migrations,
                "error": (
                    None if rreq.error is None else str(rreq.error)
                ),
            }, event="done"))
        except (ConnectionError, OSError) as e:
            # client went away: cancel wherever the request currently
            # lives (its replica may have changed since submit)
            logger.info(
                "router SSE client for %d disconnected (%r) — "
                "cancelling", rreq.rid, e,
            )
            loop = asyncio.get_running_loop()

            def do_cancel():
                # the request may MOVE (drain / re-drive) between the
                # identity snapshot and the engine cancel — a failed
                # cancel re-snapshots and retries at the new home, so
                # a migrated request cannot keep decoding its full
                # budget into the stale-token guard
                for _ in range(4):
                    with self._emit_lock:
                        if rreq.done:
                            return
                        name = rreq.replica
                        erid = rreq.engine_rid
                    rep = self.replicas.get(name)
                    cancelled = False
                    if rep is not None and rep.alive:
                        # engine.cancel fires the end sentinel
                        # through the shim, which runs the terminal
                        # bookkeeping (done + _forget)
                        with rep.engine.lock:
                            cancelled = rep.engine.cancel(erid)
                    with self._emit_lock:
                        if rreq.done:
                            return
                        if not cancelled and rreq.engine_rid == erid \
                                and rreq.replica == name:
                            # not live under this identity and it did
                            # not move: dead replica / just finished —
                            # close out the handle ourselves
                            rreq.done = True
                            self._forget(rreq)
                            return
                    # identity changed mid-cancel (or we cancelled an
                    # abandoned incarnation): retry at the new home
                with self._emit_lock:
                    rreq.done = True
                    self._forget(rreq)

            await loop.run_in_executor(None, do_cancel)
        return 200
