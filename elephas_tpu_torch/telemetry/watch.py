"""Rule-based anomaly watchdogs: the port's copy of
``elephas_tpu/telemetry/watch.py``.

The registry answers "what is the value"; operators need "is this
wrong". A :class:`Watchdog` evaluates a catalog of **pure rules** over
registry series (or any source with the registry's ``collect()``) and
maintains an active-anomaly set:

- a rule that starts holding **fires** — one structured
  ``watch.anomaly`` instant on the trace stream (rule, severity,
  identifying labels, observed value) plus a counter increment;
- a rule that stops holding **clears** — a ``watch.clear`` instant;
- :meth:`Watchdog.report` returns the active set severity-ranked,
  which is what the gateway's ``/healthz`` detail embeds.

Standing contracts, and the two that make watchdogs SAFE to attach to
a production engine:

- **Telemetry never drives control flow.** A watchdog only reports;
  nothing in the serving runtime reads its verdicts. (Tests read
  them — that is the point.)
- **Off the per-step hot path.** Rules are evaluated when *you* call
  :meth:`evaluate` — the gateway does so at ``/healthz`` probe
  cadence — never per decode step or per token. Evaluation is pure host reads of counter/gauge values.
- **Null mode inert.** The watchdog captures the registry and tracer
  at construction: built under null mode it sees an empty series
  space, evaluates to nothing, and emits nothing.

Deltas ("queue grew", "no tokens since last look") are computed
between consecutive :meth:`evaluate` calls, so a rule's window IS the
evaluation cadence; ``patience`` knobs count consecutive evaluations,
not seconds — no wall clock anywhere (the standing determinism
contract).

The parameter-server rules (journal lag, stale heartbeats, unreachable
shards) read the series of :mod:`elephas_tpu_torch.parameter`'s servers
and clients (``elephas_ps_journal_lag_updates``,
``elephas_ps_oldest_heartbeat_age_seconds``,
``elephas_ps_client_shard_pauses_total``,
``elephas_ps_client_updates_lost``). The router's replica rule reads
:class:`~elephas_tpu_torch.fleet.router.Router`'s
``elephas_router_replica_up`` gauge.
"""

from __future__ import annotations

import logging
import math

from elephas_tpu_torch import telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "Anomaly",
    "Rule",
    "Watchdog",
    "QueueStallRule",
    "DecodeStallRule",
    "SloBurnRule",
    "JournalLagRule",
    "HeartbeatStaleRule",
    "BlocksExhaustedRule",
    "SpecCollapseRule",
    "PsUnreachableRule",
    "ReplicaDownRule",
    "default_rules",
]

_SEVERITY_RANK = {"critical": 2, "warn": 1}


class Anomaly:
    """One active finding: which rule, how bad, on what (labels), and
    the observed value vs the rule's threshold."""

    __slots__ = ("rule", "severity", "labels", "value", "threshold",
                 "message")

    def __init__(self, rule: str, severity: str, labels: dict,
                 value, threshold, message: str):
        if severity not in _SEVERITY_RANK:
            raise ValueError(
                f"severity must be one of {sorted(_SEVERITY_RANK)}, "
                f"got {severity!r}"
            )
        self.rule = rule
        self.severity = severity
        self.labels = dict(labels)
        self.value = value
        self.threshold = threshold
        self.message = message

    @property
    def key(self) -> tuple:
        return (self.rule, tuple(sorted(self.labels.items())))

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "labels": dict(self.labels),
            "value": self.value,
            "threshold": self.threshold,
            "message": self.message,
        }

    def __repr__(self) -> str:
        return (
            f"Anomaly({self.rule}, {self.severity}, {self.labels}, "
            f"value={self.value})"
        )


def _finite(value) -> bool:
    try:
        return math.isfinite(float(value))
    except (TypeError, ValueError):
        return False


class Rule:
    """One pure evaluator. ``read(name)`` hands rules the current
    ``[(labels, value)]`` samples of a family; rules keep their own
    per-series memory (previous counter values, consecutive-hit
    streaks) across calls, which is how growth/stall semantics exist
    without any clock."""

    name = "rule"
    severity = "warn"

    def evaluate(self, read) -> list[Anomaly]:  # pragma: no cover
        raise NotImplementedError

    # -- shared delta helpers -------------------------------------------

    def _delta(self, mem: dict, key, value: float) -> float | None:
        """value − previous (None on first sighting; the first look at
        a counter must never read as a burst)."""
        prev = mem.get(key)
        mem[key] = value
        if prev is None:
            return None
        return value - prev


def _by_label(samples, label: str) -> dict[str, float]:
    """Fold ``[(labels, value)]`` to ``{label_value: sum}`` (finite
    samples only — a NaN pull gauge is "no data", not zero)."""
    out: dict[str, float] = {}
    for labels, value in samples:
        if not _finite(value):
            continue
        key = labels.get(label)
        if key is None:
            continue
        out[key] = out.get(key, 0.0) + float(value)
    return out


class QueueStallRule(Rule):
    """Queue depth positive and not shrinking while admissions stopped
    — arrivals are piling up behind an intake that went quiet (a
    wedged admission path, a dead driver). Per scheduler instance."""

    name = "queue_stall"
    severity = "critical"

    def __init__(self, patience: int = 3):
        self.patience = max(1, int(patience))
        self._adm: dict = {}
        self._depth: dict = {}
        self._streak: dict = {}

    def evaluate(self, read) -> list[Anomaly]:
        waiting = _by_label(
            read("elephas_serving_waiting_requests"), "scheduler"
        )
        admissions = _by_label(
            read("elephas_serving_admissions_total"), "scheduler"
        )
        out = []
        for sched, depth in sorted(waiting.items()):
            adm_delta = self._delta(
                self._adm, sched, admissions.get(sched, 0.0)
            )
            prev_depth = self._depth.get(sched)
            self._depth[sched] = depth
            stalled = (
                depth > 0
                and adm_delta is not None and adm_delta == 0
                and prev_depth is not None and depth >= prev_depth
            )
            streak = self._streak.get(sched, 0) + 1 if stalled else 0
            self._streak[sched] = streak
            if streak >= self.patience:
                out.append(Anomaly(
                    self.name, self.severity, {"scheduler": sched},
                    value=depth, threshold=self.patience,
                    message=(
                        f"queue depth {depth:.0f} with zero admissions "
                        f"for {streak} consecutive evaluations"
                    ),
                ))
        return out


class DecodeStallRule(Rule):
    """Work exists but no tokens are landing — the decode loop froze
    (dead driver thread, wedged dispatch). Process-wide: the waiting
    gauge and token counter carry different instance label families
    (scheduler vs engine), so the join is over totals; per-instance
    resolution comes from running one watchdog per process, which is
    the fleet shape anyway."""

    name = "decode_stall"
    severity = "critical"

    def __init__(self, patience: int = 3):
        self.patience = max(1, int(patience))
        self._mem: dict = {}
        self._streak = 0

    def evaluate(self, read) -> list[Anomaly]:
        tokens = sum(
            v for labels, v in
            read("elephas_serving_tokens_generated_total")
            if _finite(v)
        )
        waiting = sum(
            v for labels, v in
            read("elephas_serving_waiting_requests") if _finite(v)
        )
        delta = self._delta(self._mem, "tokens", tokens)
        stalled = waiting > 0 and delta is not None and delta == 0
        self._streak = self._streak + 1 if stalled else 0
        if self._streak >= self.patience:
            return [Anomaly(
                self.name, self.severity, {},
                value=waiting, threshold=self.patience,
                message=(
                    f"{waiting:.0f} request(s) waiting but no tokens "
                    f"generated for {self._streak} consecutive "
                    f"evaluations"
                ),
            )]
        return []


class SloBurnRule(Rule):
    """TTFT-deadline miss rate over the evaluation window crossed the
    burn threshold — the SLO budget is burning faster than it can
    recover. Per (engine, tenant)."""

    name = "slo_burn"
    severity = "warn"

    def __init__(self, threshold: float = 0.5, min_events: int = 4):
        self.threshold = float(threshold)
        self.min_events = max(1, int(min_events))
        self._met: dict = {}
        self._missed: dict = {}

    def evaluate(self, read) -> list[Anomaly]:
        met = read("elephas_serving_slo_met_total")
        missed = read("elephas_serving_slo_missed_total")

        def fold(samples):
            out = {}
            for labels, v in samples:
                if not _finite(v):
                    continue
                key = (
                    labels.get("engine", ""), labels.get("tenant", "")
                )
                out[key] = out.get(key, 0.0) + v
            return out

        met_now, missed_now = fold(met), fold(missed)
        out = []
        for key in sorted(set(met_now) | set(missed_now)):
            d_met = self._delta(self._met, key, met_now.get(key, 0.0))
            d_missed = self._delta(
                self._missed, key, missed_now.get(key, 0.0)
            )
            if d_met is None or d_missed is None:
                continue
            total = d_met + d_missed
            if total < self.min_events:
                continue
            rate = d_missed / total
            if rate >= self.threshold:
                engine, tenant = key
                out.append(Anomaly(
                    self.name, self.severity,
                    {"engine": engine, "tenant": tenant},
                    value=round(rate, 4), threshold=self.threshold,
                    message=(
                        f"tenant {tenant!r} missed {d_missed:.0f} of "
                        f"{total:.0f} TTFT deadlines this window "
                        f"({rate:.0%})"
                    ),
                ))
        return out


class JournalLagRule(Rule):
    """Applied updates not yet covered by a journal snapshot exceed
    the budget — a crash NOW loses more than the operator signed up
    for. Per PS server."""

    name = "journal_lag"
    severity = "warn"

    def __init__(self, max_lag: int = 128):
        self.max_lag = int(max_lag)

    def evaluate(self, read) -> list[Anomaly]:
        lags = _by_label(
            read("elephas_ps_journal_lag_updates"), "server"
        )
        return [
            Anomaly(
                self.name, self.severity, {"server": server},
                value=lag, threshold=self.max_lag,
                message=(
                    f"PS server {server} holds {lag:.0f} applied "
                    f"updates beyond its last journal snapshot"
                ),
            )
            for server, lag in sorted(lags.items())
            if lag >= self.max_lag
        ]


class HeartbeatStaleRule(Rule):
    """A worker lease went stale beyond the threshold — a member died
    or is partitioned. Per PS server (the gauge reports the OLDEST
    lease)."""

    name = "heartbeat_stale"
    severity = "warn"

    def __init__(self, max_age_s: float = 30.0):
        self.max_age_s = float(max_age_s)

    def evaluate(self, read) -> list[Anomaly]:
        ages = _by_label(
            read("elephas_ps_oldest_heartbeat_age_seconds"), "server"
        )
        return [
            Anomaly(
                self.name, self.severity, {"server": server},
                value=round(age, 3), threshold=self.max_age_s,
                message=(
                    f"PS server {server}'s least-recent worker lease "
                    f"is {age:.1f}s stale"
                ),
            )
            for server, age in sorted(ages.items())
            if age >= self.max_age_s
        ]


class BlocksExhaustedRule(Rule):
    """The paged KV pool ran out of free blocks — admission pressure
    has nowhere to go; escalates to critical once requests are
    actually being rejected. Per engine."""

    name = "blocks_exhausted"
    severity = "warn"

    def __init__(self, free_frac: float = 0.02):
        self.free_frac = float(free_frac)
        self._rejected: dict = {}

    def evaluate(self, read) -> list[Anomaly]:
        free = _by_label(
            read("elephas_serving_blocks_free"), "engine"
        )
        total = _by_label(read("elephas_serving_kv_blocks"), "engine")
        rejected = _by_label(
            read("elephas_serving_rejected_total"), "engine"
        )
        out = []
        for engine, n_total in sorted(total.items()):
            if n_total <= 0:
                continue
            n_free = free.get(engine)
            if n_free is None:
                continue
            frac = n_free / n_total
            d_rej = self._delta(
                self._rejected, engine, rejected.get(engine, 0.0)
            )
            if frac > self.free_frac:
                continue
            severity = (
                "critical" if d_rej is not None and d_rej > 0
                else self.severity
            )
            out.append(Anomaly(
                self.name, severity, {"engine": engine},
                value=round(frac, 4), threshold=self.free_frac,
                message=(
                    f"engine {engine} has {n_free:.0f}/{n_total:.0f} "
                    f"KV blocks free"
                    + (
                        f" and rejected {d_rej:.0f} request(s) this "
                        f"window" if severity == "critical" else ""
                    )
                ),
            ))
        return out


class SpecCollapseRule(Rule):
    """Speculative acceptance collapsed over the window — drafts are
    being paid for and thrown away (hostile text, a stale draft
    model). Per engine; needs enough drafted tokens to mean
    anything."""

    name = "spec_collapse"
    severity = "warn"

    def __init__(self, floor: float = 0.1, min_drafted: int = 64):
        self.floor = float(floor)
        self.min_drafted = int(min_drafted)
        self._drafted: dict = {}
        self._accepted: dict = {}

    def evaluate(self, read) -> list[Anomaly]:
        drafted = _by_label(
            read("elephas_serving_spec_draft_tokens_total"), "engine"
        )
        accepted = _by_label(
            read("elephas_serving_spec_accepted_tokens_total"),
            "engine",
        )
        out = []
        for engine in sorted(drafted):
            d_draft = self._delta(
                self._drafted, engine, drafted[engine]
            )
            d_acc = self._delta(
                self._accepted, engine, accepted.get(engine, 0.0)
            )
            if d_draft is None or d_acc is None:
                continue
            if d_draft < self.min_drafted:
                continue
            rate = d_acc / d_draft
            if rate < self.floor:
                out.append(Anomaly(
                    self.name, self.severity, {"engine": engine},
                    value=round(rate, 4), threshold=self.floor,
                    message=(
                        f"engine {engine} accepted {d_acc:.0f} of "
                        f"{d_draft:.0f} drafted tokens this window "
                        f"({rate:.0%})"
                    ),
                ))
        return out


class PsUnreachableRule(Rule):
    """A parameter-server (shard) stopped taking this process's
    pushes: the sharded client is parking pushes behind the outage
    (``shard_pauses`` rising, labeled with the EXACT shard), or a
    plain client holds in-doubt pushes (``updates_lost`` > 0). Stays
    active until the signal has been quiet for ``clear_after``
    consecutive evaluations — recovery (parked pushes replayed, lost
    gauge drained) clears it."""

    name = "ps_unreachable"
    severity = "critical"

    def __init__(self, clear_after: int = 2):
        self.clear_after = max(1, int(clear_after))
        self._pauses: dict = {}
        self._quiet: dict = {}
        self._last: dict = {}

    def evaluate(self, read) -> list[Anomaly]:
        out = []
        active_keys = set()
        for labels, value in read(
            "elephas_ps_client_shard_pauses_total"
        ):
            if not _finite(value):
                continue
            key = (labels.get("client", ""), labels.get("shard", ""))
            delta = self._delta(self._pauses, key, float(value))
            if delta is not None and delta > 0:
                self._quiet[key] = 0
                self._last[key] = float(value)
            elif key in self._quiet:
                self._quiet[key] += 1
            if key in self._quiet and \
                    self._quiet[key] < self.clear_after:
                active_keys.add(key)
                out.append(Anomaly(
                    self.name, self.severity,
                    {"client": key[0], "shard": key[1]},
                    value=self._last.get(key, value),
                    threshold=0,
                    message=(
                        f"client {key[0]} is parking pushes for dead "
                        f"shard {key[1]} ({value:.0f} parked total)"
                    ),
                ))
        # drop cleared streak state so a later outage re-fires fresh
        for key in [
            k for k in self._quiet
            if k not in active_keys and self._quiet[k] >= self.clear_after
        ]:
            del self._quiet[key]
        for labels, value in read("elephas_ps_client_updates_lost"):
            if _finite(value) and value > 0:
                client = labels.get("client", "")
                out.append(Anomaly(
                    self.name, self.severity, {"client": client},
                    value=value, threshold=0,
                    message=(
                        f"client {client} holds {value:.0f} push(es) "
                        f"in doubt on a dead PS connection"
                    ),
                ))
        return out


class ReplicaDownRule(Rule):
    """A fleet router considers one of its serving replicas dead:
    the router's ``elephas_router_replica_up`` gauge —
    host-truth liveness the router maintains itself, set to 0 by
    ``kill_replica``/a crashed driver and back to 1 by
    ``restore_replica`` — reads 0. Active for exactly as long as the
    gauge stays down, labeled with the precise replica, so the
    fire/clear transitions bracket the outage on the anomaly
    timeline. (Pure and stateless: the gauge IS the state.)"""

    name = "replica_down"
    severity = "critical"

    def evaluate(self, read) -> list[Anomaly]:
        out = []
        for labels, value in read("elephas_router_replica_up"):
            if not _finite(value) or value > 0:
                continue
            router = labels.get("router", "")
            replica = labels.get("replica", "")
            out.append(Anomaly(
                self.name, self.severity,
                {"router": router, "replica": replica},
                value=value, threshold=1,
                message=(
                    f"router {router} lost replica {replica} — "
                    f"placement is down to the survivors"
                ),
            ))
        return out


def default_rules() -> list[Rule]:
    """A fresh default catalog (rules are stateful — never share one
    list across watchdogs). Thresholds are the documented defaults;
    build your own list to tune them."""
    return [
        QueueStallRule(),
        DecodeStallRule(),
        SloBurnRule(),
        JournalLagRule(),
        HeartbeatStaleRule(),
        BlocksExhaustedRule(),
        SpecCollapseRule(),
        PsUnreachableRule(),
        ReplicaDownRule(),
    ]


class Watchdog:
    """Evaluate a rule catalog over a metrics source and maintain the
    active-anomaly set (fire/clear events, severity-ranked report).

    ``source``: None = this process's registry, captured at
    construction (null mode ⇒ permanently inert); a ``Registry``; or
    anything with a ``series(name) -> [(labels, value)]`` method (a
    :class:`~elephas_tpu_torch.telemetry.aggregate.FleetScraper`)."""

    def __init__(self, source=None, rules=None):
        self._source = source if source is not None \
            else telemetry.registry()
        self.rules = list(rules) if rules is not None \
            else default_rules()
        seen = set()
        for rule in self.rules:
            if id(rule) in seen:
                raise ValueError(
                    f"rule instance {rule.name!r} appears twice — "
                    f"rules are stateful and must not be shared"
                )
            seen.add(id(rule))
        self._active: dict[tuple, Anomaly] = {}
        self._evaluations = 0
        self._fired_total = 0
        self._cleared_total = 0
        # meta series + tracer captured at construction (null-mode
        # contract: a null-built watchdog records nothing, ever)
        reg = telemetry.registry()
        self._tracer = telemetry.tracer()
        wid = telemetry.instance_label()
        self.telemetry_label = wid
        self._mf_fired = reg.counter(
            "elephas_watch_anomalies_total",
            "Anomalies fired (transition inactive -> active), by rule "
            "and severity",
            labels=("watchdog", "rule", "severity"),
        )
        self._m_evals = reg.counter(
            "elephas_watch_evaluations_total",
            "Watchdog rule-catalog evaluations",
            labels=("watchdog",),
        ).labels(watchdog=wid)
        self._m_active = reg.gauge(
            "elephas_watch_active_anomalies",
            "Currently-active anomalies",
            labels=("watchdog",),
        ).labels(watchdog=wid)

    # -- source reading -------------------------------------------------

    def _read_fn(self):
        source = self._source
        series = getattr(source, "series", None)
        if series is not None and not hasattr(source, "collect"):
            return series  # a fleet-scraper-shaped source
        families = {fam.name: fam for fam in source.collect()}

        def read(name: str):
            fam = families.get(name)
            if fam is None or fam.kind == "histogram":
                return []
            out = []
            for values, child in fam.series():
                try:
                    v = child.value
                except Exception:  # callback gauges may die mid-read
                    continue
                out.append(
                    (dict(zip(fam.labelnames, values)), float(v))
                )
            return out

        return read

    # -- evaluation -----------------------------------------------------

    def evaluate(self) -> list[Anomaly]:
        """Run every rule once; fire/clear transitions against the
        active set; return the now-active anomalies severity-ranked.
        Call this at scrape/probe cadence — NEVER per step (the
        hot-path contract)."""
        self._evaluations += 1
        self._m_evals.inc()
        read = self._read_fn()
        now: dict[tuple, Anomaly] = {}
        for rule in self.rules:
            for anomaly in rule.evaluate(read):
                now[anomaly.key] = anomaly
        for key, anomaly in now.items():
            if key not in self._active:
                self._fired_total += 1
                self._mf_fired.labels(
                    watchdog=self.telemetry_label, rule=anomaly.rule,
                    severity=anomaly.severity,
                ).inc()
                self._tracer.emit(
                    "watch.anomaly", watchdog=self.telemetry_label,
                    rule=anomaly.rule, severity=anomaly.severity,
                    value=anomaly.value, **anomaly.labels,
                )
                logger.warning(
                    "watchdog anomaly [%s/%s] %s",
                    anomaly.severity, anomaly.rule, anomaly.message,
                )
        for key, anomaly in self._active.items():
            if key not in now:
                self._cleared_total += 1
                self._tracer.emit(
                    "watch.clear", watchdog=self.telemetry_label,
                    rule=anomaly.rule, **anomaly.labels,
                )
                logger.info(
                    "watchdog cleared [%s] %s",
                    anomaly.rule, dict(anomaly.labels),
                )
        self._active = now
        self._m_active.set(len(now))
        return self.active()

    @staticmethod
    def _rank(anomaly: Anomaly) -> tuple:
        return (
            -_SEVERITY_RANK[anomaly.severity], anomaly.rule,
            tuple(sorted(anomaly.labels.items())),
        )

    def active(self) -> list[Anomaly]:
        """The active set, severity-ranked (critical first)."""
        return sorted(self._active.values(), key=self._rank)

    def report(self) -> dict:
        """Severity-ranked structured report — what ``/healthz``
        embeds and tests assert on. Counts are plain
        views of the watchdog's own transitions (the registry
        counters carry the same story for scrapes)."""
        active = self.active()
        return {
            "active": [a.as_dict() for a in active],
            "critical": sum(
                1 for a in active if a.severity == "critical"
            ),
            "warn": sum(1 for a in active if a.severity == "warn"),
            "evaluations": self._evaluations,
            "fired_total": self._fired_total,
            "cleared_total": self._cleared_total,
        }

    def release_telemetry(self) -> None:
        """Retire this watchdog's meta series (explicit-only)."""
        telemetry.remove_series(watchdog=self.telemetry_label)
