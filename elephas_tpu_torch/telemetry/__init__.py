"""Telemetry of the port: metrics registry, logical-clock event tracing,
the per-request flight recorder, anomaly watchdogs and Prometheus
exposition (counterpart of ``elephas_tpu/telemetry``).

The registry and tracer here are the port's own process-global
singletons, separate from the reference's: a process that imports both
packages holds two registries side by side. Series carry the
reference's names, label schemas and help texts, so a dashboard reads
both packages alike and the same series render byte for byte.

Quick tour::

    from elephas_tpu_torch import telemetry

    reg = telemetry.registry()                 # no-op under null mode
    tokens = reg.counter(
        "elephas_serving_tokens_generated_total",
        "Tokens emitted by the serving engine", labels=("engine",),
    ).labels(engine="0")
    tokens.inc()

    with telemetry.trace_span("prefill", req=42):
        ...                                    # wall time export-only

    print(telemetry.scrape_text())             # Prometheus text
    telemetry.tracer().export_chrome_trace("trace.json")

    telemetry.set_null(True)                   # everything above ~free

Two contracts the serving stack leans on:

- **Telemetry never drives control flow.** Scheduler queues, slot
  bookkeeping, policy counts and ``stats()`` keep plain variables;
  registry series are report-only mirrors of them, which is what makes
  null mode safe to flip (the counts stay exact, the series read 0).
- **Wall time is export-only**, and nothing here reads the device:
  every value recorded is a host value already at hand.

The parameter server's and the workers' series (``elephas_ps_*``,
``elephas_worker_*``) are registered by :mod:`elephas_tpu_torch.parameter`
and :mod:`elephas_tpu_torch.worker` themselves, under the reference's
names. Fleet-wide: :class:`~elephas_tpu_torch.telemetry.aggregate.FleetScraper`
scrapes several processes' expositions into one instance-labelled view
(the fleet router ranks replicas by it), and
:mod:`elephas_tpu_torch.telemetry.merge` merges their Chrome traces onto one
aligned timeline (``python -m elephas_tpu_torch.telemetry.merge``).
"""

from elephas_tpu_torch.telemetry.aggregate import FleetScraper  # noqa: F401
from elephas_tpu_torch.telemetry.events import (  # noqa: F401
    EventTracer,
    NullTracer,
    current_trace,
    default_tracer,
    emit,
    set_trace,
    trace_scope,
    trace_span,
    tracer,
)
from elephas_tpu_torch.telemetry.expose import (  # noqa: F401
    CONTENT_TYPE,
    CONTENT_TYPE_OPENMETRICS,
    render,
    render_openmetrics,
    scrape_text,
)
from elephas_tpu_torch.telemetry.flight import FlightRecorder  # noqa: F401
from elephas_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    NULL_METRIC,
    NullRegistry,
    Registry,
    default_registry,
    instance_label,
    null_mode,
    registry,
    remove_series,
    set_null,
)
from elephas_tpu_torch.telemetry.watch import (  # noqa: F401
    Anomaly,
    Watchdog,
    default_rules,
)

__all__ = [
    "Registry",
    "NullRegistry",
    "EventTracer",
    "NullTracer",
    "FlightRecorder",
    "FleetScraper",
    "Watchdog",
    "Anomaly",
    "default_rules",
    "DEFAULT_TIME_BUCKETS",
    "NULL_METRIC",
    "CONTENT_TYPE",
    "CONTENT_TYPE_OPENMETRICS",
    "render_openmetrics",
    "registry",
    "default_registry",
    "instance_label",
    "set_null",
    "null_mode",
    "remove_series",
    "tracer",
    "default_tracer",
    "trace_span",
    "trace_scope",
    "current_trace",
    "set_trace",
    "emit",
    "render",
    "scrape_text",
]
