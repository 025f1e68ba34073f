"""Process-local metrics registry: the port's copy of
``elephas_tpu/telemetry/registry.py``, a registry of its own.

Prometheus-shaped primitives — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` — behind a thread-safe, namespaced
:class:`Registry`. Design constraints, in order:

- **Hot-path cheap.** ``Counter.inc`` / ``Histogram.observe`` on the
  serving decode loop and the gateway must cost a dict probe plus an
  int add. Each metric child keeps ONE mutable cell per recording
  thread (keyed by thread id): after a thread's first record, its
  increments touch only its own cell — no lock, no container
  allocation, no cross-thread write contention. Reads (``value``,
  rendering) sum the cells under the registry lock; threaded
  increments therefore sum exactly once the writers are quiescent
  (the usual scrape/assert shape).
- **Null mode.** ``set_null(True)`` makes :func:`registry` hand out a
  :class:`NullRegistry` whose metrics are shared no-op singletons —
  telemetry-off code pays one no-op method call per record site.
  Consequence, and the contract the rest of the codebase follows:
  **telemetry values never drive control flow.** Anything correctness-
  bearing (scheduler queues, slot bookkeeping, policy counts) keeps
  its own plain variables; registry counters are report-only views.
- **Determinism.** Nothing here reads wall time; instance labels come
  from a process-local monotonic counter, so gang processes driving
  identical schedules mint identical label sets.

Names follow Prometheus conventions (``elephas_<subsystem>_..._total``
for counters, base units in seconds/bytes), the reference's names, so
a dashboard reads both packages alike.
"""

from __future__ import annotations

import itertools
import re
import threading
from bisect import bisect_left
from threading import get_ident

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# shared default latency ladder (seconds) — wide enough for host-loop
# TTFT on CPU CI and per-token ITL on real accelerators alike
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_instance_ids = itertools.count()


def instance_label() -> str:
    """Process-monotonic instance id for metric labels: the Nth
    component constructed in this process gets ``"N"`` — deterministic
    across gang processes running identical schedules (no pids, no
    wall time)."""
    return str(next(_instance_ids))


class _Child:
    """One labeled series. Per-thread cells make records lock-free
    after a thread's first touch; see the module docstring. ``_fast``
    caches the most recent ``(thread id, cell)`` pair as ONE tuple —
    an atomic attribute swap, so a concurrent writer can never pair
    one thread's id with another's cell — skipping even the dict probe
    on the (overwhelmingly common) single-recording-thread hot path."""

    __slots__ = ("_cells", "_lock", "_fast")

    def __init__(self, lock: threading.Lock):
        self._cells: dict = {}  # thread id -> mutable cell
        self._lock = lock
        self._fast = (-1, None)

    def _cell(self):
        tid = get_ident()
        fast = self._fast
        if fast[0] == tid:
            return fast[1]
        cell = self._cells.get(tid)
        if cell is None:
            with self._lock:
                cell = self._cells.setdefault(tid, self._new_cell())
        self._fast = (tid, cell)
        return cell

    def _new_cell(self):  # pragma: no cover - abstract
        raise NotImplementedError


class CounterChild(_Child):
    """Monotonic counter series."""

    __slots__ = ()

    def _new_cell(self):
        return [0]

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self._cell()[0] += n

    @property
    def value(self):
        with self._lock:
            return sum(c[0] for c in self._cells.values())


class GaugeChild:
    """Settable gauge series (last write wins); ``set_function`` makes
    it a pull-time callback gauge — the natural shape for staleness/
    lag values that change with time, not with events."""

    __slots__ = ("_lock", "_v", "_fn")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0
        self._fn = None

    def set(self, v):
        self._v = v  # single STORE_ATTR: atomic under the GIL

    def inc(self, n=1):
        with self._lock:
            self._v += n

    def dec(self, n=1):
        self.inc(-n)

    def set_function(self, fn) -> None:
        """Evaluate ``fn()`` at read/render time instead of storing."""
        self._fn = fn

    @property
    def value(self):
        fn = self._fn
        if fn is not None:
            return fn()
        return self._v


class HistogramChild(_Child):
    """Fixed-bucket histogram series. ``observe`` is a bisect over the
    (small, fixed) bound ladder plus two in-place adds on this thread's
    cell — no allocation, no lock.

    ``observe(v, exemplar={...})`` additionally attaches an
    **exemplar** — a tiny label set (typically ``{"rid": "42"}``)
    identifying the observed event — to the bucket the observation
    landed in, last write wins (one list-slot assignment: atomic under
    the GIL, no lock, and a ``None`` exemplar costs nothing). The
    OpenMetrics renderer (:func:`~elephas_tpu_torch.telemetry.expose.\
render_openmetrics`) emits them after the bucket lines, so a p99 TTFT
    spike on a dashboard links straight to the request that caused it.
    No wall time is captured — exemplars render without
    timestamps, keeping this module's determinism contract intact."""

    __slots__ = ("_bounds", "_ex")

    def __init__(self, lock: threading.Lock, bounds):
        super().__init__(lock)
        self._bounds = bounds
        self._ex = None  # per-bucket (labels, value), lazily created

    def _new_cell(self):
        # per-bucket counts (+1 overflow bucket for +Inf), sum
        return [[0] * (len(self._bounds) + 1), 0.0]

    def observe(self, v, exemplar=None):
        cell = self._cell()
        idx = bisect_left(self._bounds, v)
        cell[0][idx] += 1
        cell[1] += v
        if exemplar is not None:
            ex = self._ex
            if ex is None:
                ex = self._ex = [None] * (len(self._bounds) + 1)
            ex[idx] = (exemplar, v)  # one slot store: GIL-atomic

    def exemplars(self):
        """Per-bucket ``(labels_dict, observed_value)`` (or ``None``)
        aligned with :meth:`snapshot`'s bucket order, ``None`` when no
        exemplar was ever attached."""
        ex = self._ex
        return list(ex) if ex is not None else None

    def snapshot(self):
        """``(per_bucket_counts, total_count, total_sum)`` — counts are
        per-bucket here; rendering cumulates them into Prometheus
        ``le`` semantics."""
        with self._lock:
            counts = [0] * (len(self._bounds) + 1)
            total = 0.0
            for cell in self._cells.values():
                for i, c in enumerate(cell[0]):
                    counts[i] += c
                total += cell[1]
        return counts, sum(counts), total

    @property
    def count(self):
        return self.snapshot()[1]

    @property
    def sum(self):
        return self.snapshot()[2]


class _Family:
    """One named metric with a label schema; children are the series."""

    def __init__(self, name, help_, labels, kind, lock, **kw):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labels)
        self.kind = kind
        self._lock = lock
        self._kw = kw
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._default = self._make_child()

    def _make_child(self):
        if self.kind == "counter":
            return CounterChild(self._lock)
        if self.kind == "gauge":
            return GaugeChild(self._lock)
        return HistogramChild(self._lock, self._kw["buckets"])

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def __getattr__(self, name):
        # only reached when _default was never created (labeled family
        # used without .labels()) — fail with the fix, not AttributeError
        if name == "_default":
            raise ValueError(
                f"metric {self.name} has labels {self.labelnames}; "
                f"call .labels(...) to get a series first"
            )
        raise AttributeError(name)

    # label-less families act as their own single child
    def inc(self, n=1):
        return self._default.inc(n)

    def set(self, v):
        return self._default.set(v)

    def dec(self, n=1):
        return self._default.dec(n)

    def set_function(self, fn):
        return self._default.set_function(fn)

    def observe(self, v, exemplar=None):
        return self._default.observe(v, exemplar=exemplar)

    def exemplars(self):
        return self._default.exemplars()

    def snapshot(self):
        return self._default.snapshot()

    @property
    def value(self):
        return self._default.value

    @property
    def count(self):
        return self._default.count

    @property
    def sum(self):
        return self._default.sum

    def series(self):
        """``[(label_values_tuple, child)]`` snapshot for rendering."""
        with self._lock:
            if not self.labelnames:
                return [((), self._default)]
            return sorted(self._children.items())

    def remove(self, **kv) -> int:
        """Drop every child series matching ``kv`` (a subset of the
        label schema); returns how many were dropped. Children handed
        out earlier keep working for whoever holds them — removal only
        unlinks them from rendering, so retired components' read-back
        views stay valid."""
        unknown = set(kv) - set(self.labelnames)
        if unknown:
            raise ValueError(
                f"metric {self.name} has labels {self.labelnames}; "
                f"cannot remove by {sorted(unknown)}"
            )
        pairs = [
            (self.labelnames.index(n), str(v)) for n, v in kv.items()
        ]
        with self._lock:
            doomed = [
                key for key in self._children
                if all(key[i] == v for i, v in pairs)
            ]
            for key in doomed:
                del self._children[key]
        return len(doomed)


class Registry:
    """Thread-safe name → metric-family store.

    ``counter``/``gauge``/``histogram`` are get-or-create: the same
    name returns the same family (so module-level and instance-level
    call sites cannot fork state), and a kind/label-schema mismatch on
    an existing name raises instead of silently shadowing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, name, help_, labels, kind, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labels:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                if kind != "counter" and name.endswith("_total"):
                    # OpenMetrics reserves the _total suffix for
                    # counters; a gauge/histogram carrying it makes
                    # the exemplar-bearing exposition
                    # unparseable to spec-strict scrapers — fail at
                    # registration, not at scrape time. (Checked only
                    # on CREATE so a kind-mismatched re-registration
                    # still gets the clearer error below.)
                    raise ValueError(
                        f"{kind} {name!r} uses the counter-reserved "
                        f"_total suffix — rename it (OpenMetrics "
                        f"scrapers reject the whole exposition "
                        f"otherwise)"
                    )
                fam = _Family(
                    name, help_, labels, kind, threading.Lock(), **kw
                )
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name} already registered as {fam.kind} with "
                f"labels {fam.labelnames}; cannot re-register as {kind} "
                f"with labels {tuple(labels)}"
            )
        if kind == "histogram" and fam._kw["buckets"] != kw["buckets"]:
            raise ValueError(
                f"histogram {name} already registered with buckets "
                f"{fam._kw['buckets']}; cannot re-register with "
                f"{kw['buckets']} (observations would silently land in "
                f"the first ladder)"
            )
        return fam

    def counter(self, name, help_="", labels=()):
        return self._get_or_create(name, help_, labels, "counter")

    def gauge(self, name, help_="", labels=()):
        return self._get_or_create(name, help_, labels, "gauge")

    def histogram(self, name, help_="", labels=(), buckets=None):
        bounds = tuple(
            sorted(float(b) for b in (buckets or DEFAULT_TIME_BUCKETS))
        )
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        return self._get_or_create(
            name, help_, labels, "histogram", buckets=bounds
        )

    def remove_series(self, **labels) -> int:
        """Retire every labeled series matching ``labels`` across all
        families that carry those label names; returns the number of
        series dropped. This is the unbounded-growth escape hatch for
        long-lived hosts that churn components (engines built in a
        loop, gateways restarted): each construction mints a
        fresh instance label, and without retirement the registry —
        and every scrape — grows monotonically. Components expose it
        as ``release_telemetry()``; it is never called implicitly on
        ``close()``/``stop()`` because scraping AFTER teardown (a
        stopped engine's final counters) is a supported shape."""
        if not labels:
            raise ValueError(
                "remove_series needs at least one label to match "
                "(removing everything is never retirement)"
            )
        with self._lock:
            families = list(self._families.values())
        removed = 0
        for fam in families:
            if set(labels) <= set(fam.labelnames):
                removed += fam.remove(**labels)
        return removed

    def collect(self):
        """Family snapshot (sorted by name) for the text renderer."""
        with self._lock:
            families = sorted(self._families.items())
        return [fam for _name, fam in families]

    def render(self) -> str:
        """Prometheus text exposition of everything registered (the
        actual formatting lives in :mod:`elephas_tpu_torch.telemetry.expose`
        so the wire format has one home)."""
        from elephas_tpu_torch.telemetry import expose

        return expose.render(self)


class _NullMetric:
    """Shared no-op stand-in for every metric kind: one method call of
    overhead per record site, nothing stored, nothing rendered."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def set_function(self, fn):
        pass

    def observe(self, v, exemplar=None):
        pass

    def exemplars(self):
        return None

    def labels(self, **kv):
        return self

    value = 0
    count = 0
    sum = 0.0

    def series(self):
        return []


NULL_METRIC = _NullMetric()


class NullRegistry:
    """The registry handed out under null mode — every metric is the
    shared no-op singleton and rendering is empty."""

    def counter(self, name, help_="", labels=()):
        return NULL_METRIC

    def gauge(self, name, help_="", labels=()):
        return NULL_METRIC

    def histogram(self, name, help_="", labels=(), buckets=None):
        return NULL_METRIC

    def collect(self):
        return []

    def remove_series(self, **labels) -> int:
        return 0

    def render(self) -> str:
        return ""


_default_registry = Registry()
_null_registry = NullRegistry()
_null = False


def registry():
    """The process registry — the real one, or the no-op null registry
    when :func:`set_null` turned telemetry off. Components capture this
    at construction, so flipping null mode affects components built
    AFTER the flip (the on-vs-null comparison shape)."""
    return _null_registry if _null else _default_registry


def default_registry() -> Registry:
    """The real default registry, regardless of null mode (rendering
    surfaces — ``/metrics``, ``scrape()`` — read through this so a
    scrape during a null window still shows what was recorded before)."""
    return _default_registry


def set_null(flag: bool) -> bool:
    """Toggle global null mode; returns the previous value (so callers
    can restore). Under null mode every metric handed out by
    :func:`registry` is a shared no-op and every tracer from
    :func:`~elephas_tpu_torch.telemetry.events.tracer` drops its events."""
    global _null
    previous = _null
    _null = bool(flag)
    return previous


def null_mode() -> bool:
    return _null


def remove_series(**labels) -> int:
    """Retire labeled series from the DEFAULT registry (see
    :meth:`Registry.remove_series`). Always targets the real registry —
    a component built during a null window registered nothing, so
    retiring its label is a harmless no-op either way."""
    return _default_registry.remove_series(**labels)
