"""Serving-side weight puller: PS generations → ``refresh_weights``
(counterpart of ``elephas_tpu/deploy/subscriber.py``).

The :class:`WeightSubscriber` is the half of train-while-serving that
lives next to an :class:`~elephas_tpu_torch.serving.engine.InferenceEngine`.
Each ``poll_once()``:

1. reads the PS ``status`` surface for a **consistent version cut** —
   every shard reporting the SAME ``weight_version``. A deployment in
   flight (or a dead shard) shows a mixed cut; the poll skips,
   counted, and retries next round. Serving never tears.
2. pulls the full weight list over the existing PS wire — the PS
   codec, so ``pull_compression="int8"`` shrinks the transfer 4x —
   then re-reads the cut: if any shard moved (or died) mid-pull the
   gather may mix generations, so the poll discards it and skips.
3. applies through ``engine.load_weights(weights, version=N)``: the
   values go to the engine's device first, then between two engine steps
   they are copied into the module and ``refresh_weights(version=N)``
   runs — the one entry point that flushes the prefix cache, quarantines
   straddling prefills, and cascades the stamp to draft models. The
   module's parameters are updated in place, so the step boundary is
   what keeps a step on one generation.

**Idempotence is the double-apply guard**: a generation applies iff
``remote > applied`` (plain host ints — telemetry never drives the
decision). Kill a shard mid-deployment, restart it from its journal,
poll again — the version compare makes the retry a no-op or a clean
first apply, never a second one.

**Staleness bound**: ``staleness_bound`` is the number of generations
the engine may run behind the newest generation the subscriber has
*seen* before the lag is a counted, logged-at-error violation.
Report-only (a PS outage must degrade serving to "stale", never to
"down"), but loud — the watchdog/scrape surface shows exactly how far
behind each replica is via ``elephas_deploy_staleness_generations``.

``pin(version)`` holds the engine at a generation during a canary
(the stable pool must not chase the candidate); ``unpin()`` releases.
A background thread (:meth:`start`/:meth:`stop`) polls on an interval
for production shapes; tests and the rollout controller drive
``poll_once()`` deterministically.
"""

from __future__ import annotations

import logging
import threading

from elephas_tpu_torch import telemetry

__all__ = ["WeightSubscriber"]

logger = logging.getLogger(__name__)

# the wire failures a poll absorbs as a counted skip — anything else
# (template mismatch, a raising apply) is a bug and propagates
_WIRE_ERRORS = (ConnectionError, TimeoutError, OSError)

_SKIP_REASONS = (
    "wire_error", "mixed_cut", "pinned", "torn_pull",
)


class WeightSubscriber:
    """Staleness-bounded puller from a PS store into one engine.

    ``client`` is anything speaking the PS client surface —
    :class:`~elephas_tpu_torch.parameter.client.ShardedClient`, a single
    transport client, or a server/group object directly (in-process
    deployments): it needs ``status()`` (dict or per-shard list) and
    ``get_parameters()``. Pulled weights, a Keras-ordered list
    (``utils.weights.set_weights``'s order), reach the model through the
    engine's ``load_weights(weights, version=)``: a staged copy put in
    between two engine steps, then ``refresh_weights(version=)``.
    """

    def __init__(self, engine, client, staleness_bound: int = 1):
        if staleness_bound < 0:
            raise ValueError(
                f"staleness_bound must be >= 0, got {staleness_bound}"
            )
        self.engine = engine
        self.client = client
        self.staleness_bound = int(staleness_bound)
        # plain host state — every control decision reads these, never
        # a telemetry counter (the standing contract)
        self.applied_version = int(engine.weight_version)
        self.seen_version = self.applied_version
        self._pin: int | None = None
        self.pulls = 0
        self.applies = 0
        self.skips = {reason: 0 for reason in _SKIP_REASONS}
        self.violations = 0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

        # telemetry captured at construction (standing null contract)
        reg = telemetry.registry()
        self._tracer = telemetry.tracer()
        label = telemetry.instance_label()
        self.telemetry_label = label
        self._m_pulls = reg.counter(
            "elephas_deploy_pulls_total",
            "Weight lists pulled from the PS store by the subscriber",
            labels=("deploy",),
        ).labels(deploy=label)
        self._m_applies = reg.counter(
            "elephas_deploy_applies_total",
            "Generations applied into the engine via "
            "refresh_weights(version=) — at most once per generation",
            labels=("deploy",),
        ).labels(deploy=label)
        self._mf_skips = reg.counter(
            "elephas_deploy_skipped_polls_total",
            "Subscriber polls that applied nothing, by reason "
            "(wire_error / mixed_cut / pinned / torn_pull)",
            labels=("deploy", "reason"),
        )
        for reason in _SKIP_REASONS:
            self._mf_skips.labels(deploy=label, reason=reason)
        self._m_violations = reg.counter(
            "elephas_deploy_staleness_violations_total",
            "Polls that left the engine more than staleness_bound "
            "generations behind the newest generation seen",
            labels=("deploy",),
        ).labels(deploy=label)
        self._g_staleness = reg.gauge(
            "elephas_deploy_staleness_generations",
            "Generations the engine currently lags the newest "
            "generation the subscriber has seen",
            labels=("deploy",),
        ).labels(deploy=label)
        self._g_staleness.set(0)

    # -- canary pinning ------------------------------------------------

    def pin(self, version: int) -> None:
        """Hold the engine at ``version``: generations above it are
        seen (and count toward staleness) but not applied — the
        stable pool's stance while a canary runs."""
        self._pin = int(version)

    def unpin(self) -> None:
        self._pin = None

    @property
    def pinned(self) -> int | None:
        return self._pin

    # -- the poll ------------------------------------------------------

    def _skip(self, reason: str) -> None:
        self.skips[reason] += 1
        self._mf_skips.labels(
            deploy=self.telemetry_label, reason=reason
        ).inc()

    def _consistent_cut(self) -> int | None:
        """Every shard's self-reported generation, iff they agree."""
        status = self.client.status()
        if isinstance(status, dict):
            status = [status]
        versions = {
            int(st.get("weight_version", 0)) for st in status
        }
        if len(versions) != 1:
            self._skip("mixed_cut")
            logger.info(
                "subscriber %s: mixed version cut %s — deployment in "
                "flight, retrying next poll",
                self.telemetry_label, sorted(versions),
            )
            return None
        return versions.pop()

    def _note_staleness(self) -> None:
        """Update the lag view and count/log a bound violation —
        report-only, after the poll's outcome is already decided."""
        lag = self.seen_version - self.applied_version
        self._g_staleness.set(lag)
        if lag > self.staleness_bound and self._pin is None:
            self.violations += 1
            self._m_violations.inc()
            logger.error(
                "subscriber %s is %d generation(s) behind (bound %d): "
                "engine serves %d, newest seen %d",
                self.telemetry_label, lag, self.staleness_bound,
                self.applied_version, self.seen_version,
            )

    def poll_once(self) -> int | None:
        """One pull-and-apply attempt. Returns the generation applied,
        or ``None`` when nothing changed (fresh, pinned, or a counted
        skip). Never raises on wire failure — a PS outage leaves the
        engine serving its current (possibly stale) generation.
        Serialized: a manual poll (rollout controller) and the
        background thread must not interleave one apply."""
        with self._lock:
            return self._poll_locked()

    def _poll_locked(self) -> int | None:
        try:
            remote = self._consistent_cut()
        except _WIRE_ERRORS as e:
            self._skip("wire_error")
            logger.warning(
                "subscriber %s: status poll failed (%r) — engine "
                "keeps serving generation %d",
                self.telemetry_label, e, self.applied_version,
            )
            self._note_staleness()
            return None
        if remote is None:
            self._note_staleness()
            return None
        if remote > self.seen_version:
            self.seen_version = remote
        if remote <= self.applied_version:
            self._note_staleness()
            return None
        if self._pin is not None and remote > self._pin:
            self._skip("pinned")
            self._note_staleness()
            return None
        try:
            weights = self.client.get_parameters()
            self.pulls += 1
            self._m_pulls.inc()
            # re-read the cut: a shard that moved (or died into the
            # stale-slice fallback) mid-pull may have handed us a
            # gather mixing generations — discard rather than tear
            confirm = self._consistent_cut()
        except _WIRE_ERRORS as e:
            self._skip("wire_error")
            logger.warning(
                "subscriber %s: pull of generation %d failed (%r)",
                self.telemetry_label, remote, e,
            )
            self._note_staleness()
            return None
        if confirm != remote:
            self._skip("torn_pull")
            logger.warning(
                "subscriber %s: store moved mid-pull (%s != %s) — "
                "discarding the gather",
                self.telemetry_label, confirm, remote,
            )
            self._note_staleness()
            return None
        self._apply_weights(weights, remote)
        self._note_staleness()
        return remote

    def _apply_weights(self, weights, version: int) -> None:
        self.engine.load_weights(weights, version=version)
        self.applied_version = version
        self.applies += 1
        self._m_applies.inc()
        self._tracer.emit(
            "deploy.apply", deploy=self.telemetry_label,
            engine=self.engine.telemetry_label, weight_version=version,
        )
        logger.info(
            "subscriber %s applied generation %d into engine %s",
            self.telemetry_label, version, self.engine.telemetry_label,
        )

    # -- background polling --------------------------------------------

    def start(self, interval_s: float = 0.25) -> "WeightSubscriber":
        """Poll on a daemon thread every ``interval_s`` seconds (the
        interval paces I/O, it never decides correctness — decisions
        are version compares inside ``poll_once``)."""
        if self._thread is not None:
            raise RuntimeError("subscriber already started")
        self._stop.clear()

        def run():
            while not self._stop.wait(interval_s):
                self.poll_once()

        self._thread = threading.Thread(
            target=run, name="weight-subscriber", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "WeightSubscriber":
        return self if self._thread is not None else self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        """Plain-state view for supervisors and tests."""
        return {
            "applied_version": self.applied_version,
            "seen_version": self.seen_version,
            "staleness": self.seen_version - self.applied_version,
            "staleness_bound": self.staleness_bound,
            "pinned": self._pin,
            "pulls": self.pulls,
            "applies": self.applies,
            "skips": dict(self.skips),
            "violations": self.violations,
        }

    def release_telemetry(self) -> None:
        """Retire this subscriber's labeled series (explicit-only)."""
        telemetry.remove_series(deploy=self.telemetry_label)
