"""Canary rollout through the fleet Router (counterpart of
``elephas_tpu/deploy/rollout.py``).

The :class:`CanaryController` is the deployment brain: it publishes a
candidate weight generation to a subset of replicas, steers a
configurable traffic share onto them through the Router's
deterministic canary split, watches the ``slo_burn`` watchdog rule
over the router's FleetScraper view, and either promotes the
generation fleet-wide or auto-rolls-back to the previous generation's
content from the ledger (whose journals make that durable).

State machine (all transitions are counted and traced)::

    IDLE --begin(weights)--> CANARY --clean window--> IDLE (promoted)
                               |
                               +--- slo_burn fires --> IDLE (rolled_back)

Windows are **evaluation counts**, never wall clock: ``evaluate()``
runs one watchdog evaluation and the window is "``window`` consecutive
evaluations with no active ``slo_burn``" — the same logical-clock
stance every control path in this repo takes (a 1-CPU CI box must
reach the same verdict as a fast workstation). The caller owns the
evaluation cadence (the fault harness's ``WatchdogPoller``, a gateway
``/healthz`` probe loop, or a bench loop driving it directly).

Division of labor during a canary:

- **stable** replicas' subscribers are *pinned* at the baseline
  generation — they see the candidate on the PS but refuse to chase
  it (a canary where the stable pool upgrades itself is just a
  deployment);
- **canary** replicas' subscribers pull and apply the candidate;
- the Router splits traffic deterministically (placements into the
  canary pool are counted with kind ``"canary"``);
- on **promote**: stable unpins, pulls, applies; the split clears.
- on **rollback**: the ledger re-publishes the baseline content as a
  new generation; EVERY subscriber (canary included) converges onto
  it; the split clears. The candidate generation is abandoned.
"""

from __future__ import annotations

import logging

from elephas_tpu_torch import telemetry

__all__ = ["CanaryController"]

logger = logging.getLogger(__name__)

_STATES = ("idle", "canary")
_OUTCOMES = ("promoted", "rolled_back")


class CanaryController:
    """Drive one canary-deployment cycle at a time over a fleet.

    ``subscribers`` maps replica name →
    :class:`~elephas_tpu_torch.deploy.subscriber.WeightSubscriber` (every
    router replica needs one — a replica without a subscriber could
    never converge); ``canary`` names the subset serving candidates.
    ``watchdog`` defaults to a fresh
    :class:`~elephas_tpu_torch.telemetry.watch.Watchdog` with one
    ``slo_burn`` rule over the router's scraper; pass your own to
    share an existing fleet watchdog (the controller only *reads*
    ``slo_burn`` anomalies — other rules ride along untouched).
    """

    def __init__(self, router, ledger, subscribers, *, canary,
                 share: float = 0.25, window: int = 4,
                 watchdog=None):
        if isinstance(canary, str):
            canary = [canary]
        canary = {str(n) for n in canary}
        missing = set(router.replicas) - set(subscribers)
        if missing:
            raise ValueError(
                f"replicas {sorted(missing)} have no subscriber — "
                f"every replica needs one to converge on a generation"
            )
        unknown = canary - set(router.replicas)
        if unknown:
            raise ValueError(
                f"canary names {sorted(unknown)} are not replicas of "
                f"the router (have {sorted(router.replicas)})"
            )
        if not canary or not canary < set(router.replicas):
            raise ValueError(
                "the canary pool must be a non-empty PROPER subset of "
                "the fleet (a stable pool must remain)"
            )
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.router = router
        self.ledger = ledger
        self.subscribers = dict(subscribers)
        self.canary_names = canary
        self.stable_names = set(router.replicas) - canary
        self.share = float(share)
        self.window = int(window)
        if watchdog is None:
            from elephas_tpu_torch.telemetry.watch import SloBurnRule, Watchdog

            watchdog = Watchdog(
                source=router.scraper, rules=[SloBurnRule()]
            )
        self.watchdog = watchdog
        # plain host state — the state machine never reads telemetry
        self.state = "idle"
        self.baseline: int | None = None
        self.candidate: int | None = None
        self.last_outcome: str | None = None
        self._clean_evals = 0
        self.promotions = 0
        self.rollbacks = 0

        # telemetry captured at construction (standing null contract)
        reg = telemetry.registry()
        self._tracer = telemetry.tracer()
        label = telemetry.instance_label()
        self.telemetry_label = label
        self._mf_outcomes = reg.counter(
            "elephas_deploy_canary_outcomes_total",
            "Canary cycles concluded, by outcome "
            "(promoted / rolled_back)",
            labels=("deploy", "outcome"),
        )
        for outcome in _OUTCOMES:
            self._mf_outcomes.labels(deploy=label, outcome=outcome)
        self._g_state = reg.gauge(
            "elephas_deploy_canary_active",
            "1 while a canary cycle is in flight",
            labels=("deploy",),
        ).labels(deploy=label)
        self._g_state.set(0)

    # -- transitions ---------------------------------------------------

    def _drive(self, names, expect: int) -> None:
        """Poll the named replicas' subscribers until each reports the
        expected generation — loudly, not best-effort: a replica that
        cannot converge is a failed deployment step, and the caller's
        retry/abort must know NOW, not at SLO-burn time."""
        for name in sorted(names):
            sub = self.subscribers[name]
            applied = sub.poll_once()
            if applied != expect and sub.applied_version != expect:
                raise RuntimeError(
                    f"replica {name!r} did not converge on generation "
                    f"{expect} (applied={sub.applied_version}, "
                    f"status={sub.status()}) — aborting the transition"
                )

    def begin(self, weights) -> int:
        """Publish ``weights`` as the candidate generation, apply it
        to the canary pool, and start splitting traffic. Returns the
        candidate generation number."""
        if self.state != "idle":
            raise RuntimeError(
                f"a canary cycle is already in flight "
                f"(state={self.state!r}, candidate={self.candidate})"
            )
        self.baseline = self.ledger.version
        # pin stable FIRST: the instant the candidate hits the PS,
        # any background-polling stable subscriber would otherwise
        # chase it
        for name in self.stable_names:
            self.subscribers[name].pin(self.baseline)
        self.candidate = self.ledger.publish(weights)
        self._drive(self.canary_names, self.candidate)
        self.router.set_canary(sorted(self.canary_names), self.share)
        self.state = "canary"
        self._clean_evals = 0
        self._g_state.set(1)
        self._tracer.emit(
            "deploy.canary_begin", deploy=self.telemetry_label,
            weight_version=self.candidate, baseline=self.baseline,
            share=self.share,
        )
        logger.info(
            "canary began: generation %d on %s at share %.2f "
            "(baseline %d)",
            self.candidate, sorted(self.canary_names), self.share,
            self.baseline,
        )
        return self.candidate

    def evaluate(self) -> str:
        """One watchdog evaluation + window bookkeeping. Returns the
        state after the evaluation (``"canary"`` while undecided,
        ``"idle"`` once promoted or rolled back — read
        ``last_outcome`` for which)."""
        if self.state != "canary":
            return self.state
        self.watchdog.evaluate()
        burning = any(
            a["rule"] == "slo_burn"
            for a in self.watchdog.report()["active"]
        )
        if burning:
            self.rollback()
        else:
            self._clean_evals += 1
            if self._clean_evals >= self.window:
                self.promote()
        return self.state

    def promote(self) -> int:
        """Candidate goes fleet-wide: unpin the stable pool, converge
        it onto the candidate, clear the traffic split."""
        if self.state != "canary":
            raise RuntimeError("no canary cycle in flight to promote")
        for name in self.stable_names:
            self.subscribers[name].unpin()
        self._drive(self.stable_names, self.candidate)
        self.router.clear_canary()
        promoted = self.candidate
        self._conclude("promoted")
        logger.info("canary promoted: generation %d fleet-wide",
                    promoted)
        return promoted

    def rollback(self) -> int:
        """Abandon the candidate: re-publish the baseline content as a
        new generation, converge EVERY replica onto it, clear the
        split. Returns the new (rollback) generation."""
        if self.state != "canary":
            raise RuntimeError(
                "no canary cycle in flight to roll back"
            )
        restored = self.ledger.rollback(self.baseline)
        for name in self.stable_names | self.canary_names:
            self.subscribers[name].unpin()
        self._drive(self.stable_names | self.canary_names, restored)
        self.router.clear_canary()
        self._conclude("rolled_back")
        logger.warning(
            "canary rolled back: generation %d re-serves generation "
            "%d's content fleet-wide", restored, self.baseline,
        )
        return restored

    def _conclude(self, outcome: str) -> None:
        self.state = "idle"
        self.last_outcome = outcome
        if outcome == "promoted":
            self.promotions += 1
        else:
            self.rollbacks += 1
        self._clean_evals = 0
        self._g_state.set(0)
        self._mf_outcomes.labels(
            deploy=self.telemetry_label, outcome=outcome
        ).inc()
        self._tracer.emit(
            "deploy.canary_end", deploy=self.telemetry_label,
            outcome=outcome, weight_version=self.ledger.version,
        )

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        return {
            "state": self.state,
            "baseline": self.baseline,
            "candidate": self.candidate,
            "canary": sorted(self.canary_names),
            "share": self.share,
            "window": self.window,
            "clean_evaluations": self._clean_evals,
            "last_outcome": self.last_outcome,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
        }

    def release_telemetry(self) -> None:
        """Retire this controller's labeled series (explicit-only).
        The watchdog retires its own only if this controller built it
        — a shared watchdog belongs to its owner."""
        telemetry.remove_series(deploy=self.telemetry_label)
