"""Bounded per-request flight recorder: the port's copy of
``elephas_tpu/telemetry/flight.py``.

The metrics registry answers *aggregate* questions (p99 TTFT, counter
totals); this module keeps the *per-request* story: a bounded ring of
finished request lifecycles, each a plain structured dict the serving
engine assembles as the request moves through submit → admission →
prefill → preempt/resume → spec rounds → finish. The engine's
``explain(rid)`` and the gateway's ``GET /v1/requests/{rid}/trace``
read records back out of here.

Same standing contracts as the rest of the telemetry layer:

- **Telemetry never drives control flow.** Records are write-only from
  the serving path's perspective; nothing in the engine reads one back
  to make a decision, so gang schedules cannot fork on them.
- **Ordering is logical.** Records carry scheduler step indices and
  tracer sequence numbers; any wall-derived field (``ttft_s``) is
  export-only, exactly like the event tracer's timestamps.
- **Bounded.** The ring keeps the newest ``capacity`` finished
  lifecycles (insertion order, oldest evicted first) — a server alive
  for millions of requests must not grow host memory linearly.

Null mode: the engine simply does not construct a recorder when built
under telemetry null mode (or with ``flight_recorder=0``), so the
record path costs nothing — there is no "null recorder" singleton to
call through.
"""

from __future__ import annotations

from collections import OrderedDict


class FlightRecorder:
    """Last-N finished request lifecycles, keyed by request id.

    Records are mutable dicts owned by the writer (the engine keeps
    appending late entries — e.g. the spec round that finished the
    request — after filing); :meth:`get` hands back the live object,
    and readers that need isolation copy (``engine.explain`` does).
    """

    def __init__(self, capacity: int):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._records: OrderedDict[int, dict] = OrderedDict()

    def record(self, rid: int, record: dict) -> None:
        """File one finished lifecycle; re-filing an rid refreshes its
        ring position. Oldest records evict past ``capacity``."""
        rid = int(rid)
        if rid in self._records:
            self._records.move_to_end(rid)
        self._records[rid] = record
        while len(self._records) > self.capacity:
            self._records.popitem(last=False)

    def get(self, rid: int) -> dict | None:
        return self._records.get(int(rid))

    def rids(self) -> list[int]:
        """Resident request ids, oldest first."""
        return list(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def clear(self) -> None:
        self._records.clear()
