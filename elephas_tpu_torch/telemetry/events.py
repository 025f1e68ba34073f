"""Logical-clock event tracing: the port's copy of
``elephas_tpu/telemetry/events.py``.

A bounded ring buffer of events, each stamped with a monotonic
**logical sequence number** (the ordering authority) plus a wall-clock
capture that exists ONLY for export — Chrome-trace timelines and
recovery-window measurement. Nothing in the runtime reads an event's
wall time to make a decision; this preserves the gang/SPMD determinism
contract the serving scheduler and prefix cache already carry (their
logical clocks stay the only clocks on control paths).

Two event shapes:

- **instants** (:meth:`EventTracer.emit`): one point on the timeline —
  a submit, an admission, a first token;
- **spans** (:meth:`EventTracer.span` / :func:`trace_span`): a
  ``with``-scoped duration — a prefill wave, a decode window, a
  kill→recovery window. A span records ONE complete event at exit
  (single ring append — atomic under the GIL), carrying its begin/end
  sequence numbers and its wall duration.

The ring (``collections.deque(maxlen=...)``) keeps the NEWEST events
under overflow; export renders whatever survived. The Chrome-trace
exporter (:meth:`export_chrome_trace`) writes the standard
``traceEvents`` JSON consumable by ``chrome://tracing`` / Perfetto, so
serving waves, gateway requests and request lifecycles land on one
timeline.

Null mode (:func:`~elephas_tpu_torch.telemetry.registry.set_null`) swaps
:func:`tracer` for a no-op tracer, same as the metrics registry.

**Cross-process trace context.** A *trace id* is a plain
string minted once at the edge of a causal story and carried along so
every event the story touches lands stamped with the same id (a
migration record carries it from one engine to the next). The context
is **thread-
local** (:func:`trace_scope` / :func:`set_trace` /
:func:`current_trace`): any event appended while a scope is active
gains a ``trace=<id>`` arg automatically, unless the call site already
stamped its own. Like everything here, the context is report-only —
nothing reads it to make a decision — and ids must contain no wall
time or pids (the label-determinism contract), so gang processes
driving identical schedules mint identical ids.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

from elephas_tpu_torch.telemetry import registry as _registry_mod

DEFAULT_CAPACITY = 8192

# -- cross-process trace context ------------------------------------------

_trace_tls = threading.local()


def current_trace() -> str | None:
    """The thread's active trace id (None outside any scope)."""
    return getattr(_trace_tls, "trace", None)


def set_trace(trace_id: str | None) -> str | None:
    """Set (or clear, with None) this thread's trace context; returns
    the previous value so callers can restore it. Prefer
    :func:`trace_scope` — explicit set/restore is for wire handlers
    whose scope boundary is a protocol op, not a ``with`` block."""
    previous = current_trace()
    _trace_tls.trace = trace_id if trace_id else None
    return previous


@contextlib.contextmanager
def trace_scope(trace_id: str | None):
    """``with trace_scope("fit-0"): ...`` — every event appended by
    THIS thread inside the block carries ``trace="fit-0"``. Scopes nest (the inner id
    wins, the outer is restored on exit); ``trace_scope(None)`` is a
    no-op passthrough — the ambient scope (if any) stays active — so
    call sites need no conditional (use :func:`set_trace` to clear
    explicitly)."""
    if trace_id is None:
        yield None
        return
    previous = set_trace(trace_id)
    try:
        yield trace_id
    finally:
        set_trace(previous)


class _Span:
    """Reusable span context manager: captures begin seq/wall on enter,
    appends one complete event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_seq0", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._seq0 = 0
        self._t0 = 0.0

    def __enter__(self):
        self._seq0 = self._tracer._next_seq()
        # wall time: EXPORT-ONLY (never control flow) — see module doc
        self._t0 = time.time()
        return self

    @property
    def begin_seq(self) -> int:
        """The span's begin sequence number (valid after ``__enter__``)
        — flight-recorder entries correlate on it."""
        return self._seq0

    def set(self, **kw) -> None:
        """Attach/overwrite span args mid-flight (e.g. an outcome flag
        only known at the end of the spanned work)."""
        self._args.update(kw)

    def __exit__(self, *exc):
        self._tracer._append(
            name=self._name,
            ph="X",
            seq=self._tracer._next_seq(),
            seq_begin=self._seq0,
            ts=self._t0,
            dur=time.time() - self._t0,
            args=dict(self._args),
        )
        return False


class EventTracer:
    """Bounded ring of instants and spans; see the module docstring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._ring: deque = deque(maxlen=int(capacity))
        self._seq_lock = threading.Lock()
        self._seq_next = 0

    # -- recording -----------------------------------------------------

    def _next_seq(self) -> int:
        with self._seq_lock:
            seq = self._seq_next
            self._seq_next += 1
            return seq

    @property
    def seq(self) -> int:
        """The next sequence number to be assigned — snapshot this
        before a run to filter :meth:`events` to that run only."""
        with self._seq_lock:
            return self._seq_next

    def _append(self, *, name, ph, seq, ts, args, dur=None,
                seq_begin=None):
        # cross-process trace context: an active scope
        # stamps every event appended by this thread — call sites that
        # stamped their own `trace` arg win (a wire handler may carry
        # a peer's id while a local scope is also live)
        trace = current_trace()
        if trace is not None and "trace" not in args:
            args["trace"] = trace
        event = {
            "name": name,
            "ph": ph,
            "seq": seq,
            "ts": ts,
            "tid": threading.get_ident(),
            "args": args,
        }
        if dur is not None:
            event["dur"] = dur
            event["seq_begin"] = seq_begin
        self._ring.append(event)  # deque(maxlen): atomic, drops oldest

    def emit(self, name: str, **args) -> int:
        """Record one instant event; returns its logical sequence
        number (callers may correlate on it — it is the only ordering
        a consumer should trust)."""
        seq = self._next_seq()
        self._append(name=name, ph="i", seq=seq, ts=time.time(), args=args)
        return seq

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("prefill", req=rid): ...`` — records one
        complete event at exit with begin/end sequence numbers and the
        wall duration."""
        return _Span(self, name, args)

    def complete(self, name: str, dur: float, **args) -> int:
        """Record one already-measured span: the caller timed the work
        and only afterwards learned it deserved an event — the shape of
        a dispatch that turned out to be slow. Appends a
        single ``ph="X"`` event whose wall start is reconstructed as
        now − ``dur`` (export-only, like all wall time here); returns
        its end sequence number."""
        seq0 = self._next_seq()
        seq = self._next_seq()
        self._append(
            name=name, ph="X", seq=seq, seq_begin=seq0,
            ts=time.time() - dur, dur=float(dur), args=args,
        )
        return seq

    # -- reading / export ----------------------------------------------

    def events(self, since_seq: int = 0, name: str | None = None) -> list:
        """Snapshot of surviving events with ``seq >= since_seq`` (and
        matching ``name``, when given), in ring order."""
        return [
            dict(e)
            for e in list(self._ring)
            if e["seq"] >= since_seq and (name is None or e["name"] == name)
        ]

    def clear(self) -> None:
        self._ring.clear()

    def export_chrome_trace(self, path: str, since_seq: int = 0) -> int:
        """Write the surviving events as Chrome-trace ``traceEvents``
        JSON (load in ``chrome://tracing`` / Perfetto / TensorBoard's
        trace viewer). Spans become ``ph="X"`` complete events with
        microsecond ``ts``/``dur``; instants become ``ph="i"``. Returns
        the number of events written."""
        pid = os.getpid()
        out = []
        for e in self.events(since_seq):
            rec = {
                "name": e["name"],
                "ph": e["ph"],
                "pid": pid,
                "tid": e["tid"],
                "ts": e["ts"] * 1e6,
                "args": dict(e["args"], seq=e["seq"]),
            }
            if e["ph"] == "X":
                rec["dur"] = e["dur"] * 1e6
                rec["args"]["seq_begin"] = e["seq_begin"]
            else:
                rec["s"] = "t"  # instant scope: thread
            out.append(rec)
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return len(out)


class _NullSpan:
    """Reusable no-op span (still usable as ``with ... as sp``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        pass

    @property
    def begin_seq(self) -> int:
        return -1


class NullTracer:
    """No-op tracer handed out under null mode."""

    _NULL_SPAN = _NullSpan()

    def emit(self, name, **args):
        return -1

    def span(self, name, **args):
        return self._NULL_SPAN

    def complete(self, name, dur, **args):
        return -1

    @property
    def seq(self) -> int:
        return 0

    def events(self, since_seq=0, name=None):
        return []

    def clear(self):
        pass

    def export_chrome_trace(self, path, since_seq=0):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        return 0


_default_tracer = EventTracer()
_null_tracer = NullTracer()


def tracer():
    """The process tracer (or the no-op tracer under null mode)."""
    if _registry_mod.null_mode():
        return _null_tracer
    return _default_tracer


def default_tracer() -> EventTracer:
    """The real default tracer regardless of null mode (export
    surfaces read through this)."""
    return _default_tracer


def trace_span(name: str, **args):
    """Module-level convenience: ``with trace_span("prefill", req=3):``
    on the default tracer (no-op under null mode)."""
    return tracer().span(name, **args)


def emit(name: str, **args) -> int:
    """Module-level convenience for one instant event."""
    return tracer().emit(name, **args)
