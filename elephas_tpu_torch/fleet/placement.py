"""Deterministic two-stage request placement (counterpart of
``elephas_tpu/fleet/placement.py``, the same decisions for the same
snapshot).

Pure host-side decision logic, zero I/O: the router gathers its
inputs — per-replica prefix-warmth probes (the engine's pure
``prefix_warm_probe``) and the load view a
:class:`~elephas_tpu_torch.telemetry.aggregate.FleetScraper` last polled —
and :func:`place` turns them into ONE replica name. Keeping the
function pure is what makes placement testable for the contract the
fleet needs: **same snapshot + same prompt ⇒ same replica**, on every
call and on every process (no wall clock, no dict-order dependence —
candidates iterate in sorted-name order, every tie breaks by value
then name).

Two stages, then a degraded floor:

1. **Prefix affinity** — the replica whose prefix cache already holds
   the longest warm match wins, provided the match reaches
   ``min_affinity_tokens`` (a 1-2 token coincidental match is not
   worth skewing load for — the same floor reasoning as the engine's
   ``prefix_min_reuse``). Equally-warm replicas tie-break toward the
   lighter one (more blocks free, then shallower queue, then name).
2. **Load balance** — no warm match anywhere: the replica with the
   most free KV blocks wins (queue depth, then name, break ties),
   considering only replicas whose last scrape SUCCEEDED (``up``).
3. **Round-robin floor** — the whole view is stale (every scrape
   failing, or never polled): degrade to round-robin over the sorted
   candidate names at the caller's cursor. The router counts these
   (``elephas_router_stale_placements_total``) — a rising rate means
   the fleet view is blind, not that placement is broken.

The view never VETOES a candidate: liveness is the router's own
host-side knowledge (telemetry never drives control flow — a dead
scrape only downgrades ranking information, it cannot kill a replica
the router knows is alive).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PlacementDecision", "place"]


class PlacementDecision(NamedTuple):
    """One placement: the chosen replica and which stage chose it
    (``"affinity"`` | ``"load"`` | ``"round_robin"``)."""

    replica: str
    kind: str


def _load_key(name: str, view: dict):
    """Sort key: most blocks free first, then shallowest queue, then
    name — missing/stale entries rank as zero-capacity (chosen last,
    never skipped)."""
    stats = view.get(name) or {}
    return (
        -float(stats.get("blocks_free") or 0.0),
        float(stats.get("queue_depth") or 0.0),
        name,
    )


def place(probes: dict, view: dict, min_affinity_tokens: int = 8,
          rr_cursor: int = 0) -> PlacementDecision:
    """Choose one replica. ``probes`` maps candidate replica name →
    warm prefix length for THIS prompt (only candidates the caller
    considers alive belong here); ``view`` maps replica name → the
    fleet-stats row (``up`` / ``blocks_free`` / ``queue_depth``) from
    the last scrape — stale or missing rows are fine. ``rr_cursor`` is
    the caller's round-robin state, consumed only on the degraded
    floor. Deterministic: a pure function of its arguments."""
    names = sorted(str(n) for n in probes)
    if not names:
        raise ValueError("place() needs at least one candidate replica")
    floor = max(1, int(min_affinity_tokens))
    best = max(int(probes[n]) for n in names)
    if best >= floor:
        warm = [n for n in names if int(probes[n]) == best]
        return PlacementDecision(
            min(warm, key=lambda n: _load_key(n, view)), "affinity"
        )
    fresh = [n for n in names if (view.get(n) or {}).get("up")]
    if fresh:
        return PlacementDecision(
            min(fresh, key=lambda n: _load_key(n, view)), "load"
        )
    return PlacementDecision(
        names[int(rr_cursor) % len(names)], "round_robin"
    )
