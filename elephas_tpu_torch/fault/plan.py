"""Deterministic, seedable fault plans.

A :class:`FaultPlan` is pure data + seeded decision functions — it
holds *what goes wrong and when*, never any injection machinery, so the
same plan object drives a unit test, the chaos suite, and
``chip_smoke.py``, and reproduces the identical fault
schedule from the same seed. Decisions are pure functions of
``(seed, event key)`` — independent of call order, so two runs that
push the same sequence IDs see the same duplicates even if unrelated
ops interleave differently.

Injection surfaces (the harness wires these up):

- **PS crash/restart**: ``kill_ps_after_updates`` — the harness stops
  the server once it has applied that many updates and restarts it
  (journal replay) after ``restart_delay_s``.
- **Wire faults**: :class:`SocketFaults` drives the injectable hook in
  :mod:`elephas_tpu_torch.utils.sockets` (``set_fault_hook``) — delay every
  Nth socket op, drop (raise ``ConnectionError``) every Nth, or sever
  everything for a window.
- **Duplicate update frames**: ``duplicate(seq)`` — the client's
  ``chaos_duplicate`` hook resends the identical sequenced frame,
  exercising the server's idempotent apply.
- **Worker loss**: ``failed_partitions`` — the driver's failure-budget
  path (:meth:`SparkModel.fit`) drops those partitions as if their
  executors died, and raises once the budget is exceeded.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


class WorkerFault(RuntimeError):
    """An injected worker-partition loss (one dead executor)."""


class FaultBudgetExceeded(RuntimeError):
    """More workers were lost than ``failure_budget`` allows."""


@dataclass(frozen=True)
class SocketFaults:
    """Wire-level fault schedule for the :mod:`utils.sockets` hook.

    Ops are counted globally across connect/send/recv in injection
    order; ``drop_every=N`` raises ``ConnectionError`` on every Nth op,
    ``delay_every=N`` sleeps ``delay_ms`` on every Nth, and
    ``sever_at``/``sever_for_s`` fail ALL ops inside the window
    ``[sever_at, sever_at + ...)`` measured from when the window opens
    (the op count that first crosses ``sever_at`` starts the clock) —
    a network partition rather than a single lost packet.
    """

    drop_every: int = 0
    delay_every: int = 0
    delay_ms: float = 0.0
    sever_at: int = 0
    sever_for_s: float = 0.0


class FaultPlan:
    """One seeded chaos schedule; see the module docstring."""

    def __init__(
        self,
        seed: int = 0,
        kill_ps_after_updates: int | None = None,
        restart_delay_s: float = 0.5,
        duplicate_fraction: float = 0.0,
        failed_partitions: tuple[int, ...] = (),
        socket_faults: SocketFaults | None = None,
        kill_shard: int = 0,
    ):
        if not 0.0 <= duplicate_fraction <= 1.0:
            raise ValueError(
                f"duplicate_fraction must be in [0, 1], got "
                f"{duplicate_fraction}"
            )
        self.seed = int(seed)
        self.kill_ps_after_updates = kill_ps_after_updates
        self.restart_delay_s = float(restart_delay_s)
        self.duplicate_fraction = float(duplicate_fraction)
        self.failed_partitions = tuple(int(i) for i in failed_partitions)
        self.socket_faults = socket_faults
        # Which shard of a sharded PS topology the kill
        # targets (ignored by the single-PS harness, where the one
        # server is implicitly shard 0)
        self.kill_shard = int(kill_shard)

    # -- per-event decisions (order-independent, seeded) ---------------

    def duplicate(self, seq: int) -> bool:
        """Should the frame with this sequence ID be duplicated on the
        wire? A seed-shifted stride rather than a coin flip: every
        ``round(1/fraction)``-th sequence ID duplicates, so a short run
        still provably exercises ≥ ``duplicate_fraction`` of its frames
        (a Bernoulli draw can produce zero duplicates on small runs),
        while the seed moves WHICH frames are hit."""
        if self.duplicate_fraction <= 0.0:
            return False
        stride = max(1, int(round(1.0 / self.duplicate_fraction)))
        return (seq + self.seed) % stride == 0

    def fails_partition(self, index: int) -> bool:
        return index in self.failed_partitions

    # -- socket hook ---------------------------------------------------

    def make_socket_hook(self):
        """A ``hook(op)`` closure for ``sockets.set_fault_hook``
        implementing this plan's :class:`SocketFaults` (None when the
        plan has no wire faults). Thread-safe; op counting is global."""
        faults = self.socket_faults
        if faults is None:
            return None
        from elephas_tpu_torch import telemetry

        injected = telemetry.registry().counter(
            "elephas_chaos_wire_faults_total",
            "Wire faults injected by the active chaos plan, by kind",
            labels=("kind",),
        )
        m_drop = injected.labels(kind="drop")
        m_sever = injected.labels(kind="sever")
        m_delay = injected.labels(kind="delay")
        lock = threading.Lock()
        state = {"n": 0, "severed_until": None}

        def hook(op: str) -> None:
            with lock:
                state["n"] += 1
                n = state["n"]
                if (
                    faults.sever_at
                    and state["severed_until"] is None
                    and n >= faults.sever_at
                ):
                    state["severed_until"] = (
                        time.monotonic() + faults.sever_for_s
                    )
                    # the window OPENING is the interesting timeline
                    # event; per-op failures inside it would flood the
                    # ring without adding information
                    telemetry.emit(
                        "chaos.wire_severed", op=op,
                        for_s=faults.sever_for_s,
                    )
                severed_until = state["severed_until"]
            if severed_until is not None and time.monotonic() < severed_until:
                m_sever.inc()
                raise ConnectionError(
                    f"chaos: network severed ({op} inside the partition "
                    f"window)"
                )
            if faults.delay_every and n % faults.delay_every == 0:
                m_delay.inc()
                time.sleep(faults.delay_ms / 1e3)
            if faults.drop_every and n % faults.drop_every == 0:
                m_drop.inc()
                telemetry.emit("chaos.wire_drop", op=op, n=n)
                raise ConnectionError(f"chaos: injected {op} drop (op {n})")

        return hook


# -- driver-side active plan (worker-loss injection) ---------------------

_ACTIVE: FaultPlan | None = None
_ACTIVE_LOCK = threading.Lock()


def active_plan() -> FaultPlan | None:
    return _ACTIVE


class use_plan:
    """Context manager installing a plan for the driver's partition
    staging (``SparkModel.fit`` consults it through
    :func:`check_partition`)."""

    def __init__(self, plan: FaultPlan | None):
        self.plan = plan
        self._previous: FaultPlan | None = None

    def __enter__(self) -> FaultPlan | None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            self._previous = _ACTIVE
            _ACTIVE = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = self._previous


def check_partition(index: int) -> None:
    """Raise :class:`WorkerFault` when the active plan (if any) fails
    this worker partition — the injection point the driver's
    failure-budget supervision catches."""
    plan = _ACTIVE
    if plan is not None and plan.fails_partition(index):
        raise WorkerFault(
            f"chaos: worker partition {index} lost (seeded fault plan "
            f"seed={plan.seed})"
        )
