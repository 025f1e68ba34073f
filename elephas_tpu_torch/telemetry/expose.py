"""Prometheus text-format exposition: the port's copy of
``elephas_tpu/telemetry/expose.py``.

One renderer for every scrape surface: the gateway's ``GET /metrics``,
``InferenceEngine.scrape()``, and ``SparkModel.scrape()`` all emit the
text produced here, so the wire format has exactly one home (and the
same series render byte for byte as the reference's). The format is Prometheus exposition
version 0.0.4 (``# HELP`` / ``# TYPE`` comments, ``le``-cumulative
histogram buckets, ``_sum``/``_count`` series).

The **OpenMetrics** flavor
(:func:`render_openmetrics`): identical lines, plus histogram bucket
samples carry their attached exemplars (`` # {rid="42"} 0.37`` — the
request id of the observation that landed in that bucket, no
timestamp: the registry never captures wall time) and the mandatory
``# EOF`` trailer. The gateway's ``GET /metrics`` serves it when the
client's ``Accept`` header asks for ``application/openmetrics-text``;
the 0.0.4 default stays exemplar-free because its parsers treat a
``#`` after the value as garbage.
"""

from __future__ import annotations

from elephas_tpu_torch.telemetry import registry as _registry_mod

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels_str(names, values, extra=()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ]
    pairs.extend(f'{n}="{_escape_label(v)}"' for n, v in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _exemplar_str(labels_dict, value) -> str:
    """OpenMetrics exemplar suffix: `` # {rid="42"} 0.37`` (no
    timestamp — the registry captures none)."""
    pairs = ",".join(
        f'{n}="{_escape_label(str(v))}"'
        for n, v in sorted(labels_dict.items())
    )
    return f" # {{{pairs}}} {_fmt(value)}"


def render(registry=None, exemplars: bool = False,
           only: dict | None = None) -> str:
    """The registry's current state as Prometheus exposition text.

    Defaults to the REAL process registry (not the null stand-in), so
    a scrape during a null-mode window still shows everything recorded
    while telemetry was on. ``exemplars=True`` (the OpenMetrics
    flavor; use :func:`render_openmetrics` for the full surface)
    appends each histogram bucket's attached exemplar to its sample
    line.

    ``only`` filters to series matching every given
    ``label=value`` pair; families that lack one of the label NAMES
    are skipped entirely. This is how a single component scrapes
    *itself* out of the shared process registry (e.g.
    ``InferenceEngine.scrape(full=False)`` passes its own ``engine=``
    label) — the unit a fleet aggregator relabels per instance.
    """
    if registry is None:
        registry = _registry_mod.default_registry()
    only_items = (
        None if only is None
        else [(str(k), str(v)) for k, v in sorted(only.items())]
    )
    lines: list[str] = []
    for fam in registry.collect():
        kind = fam.kind
        if only_items is not None:
            if any(k not in fam.labelnames for k, _v in only_items):
                continue
            idx = [(fam.labelnames.index(k), v) for k, v in only_items]
            series = [
                (values, child) for values, child in fam.series()
                if all(values[i] == v for i, v in idx)
            ]
            if not series:
                continue
        else:
            series = None
        meta_name = fam.name
        if exemplars and kind == "counter" \
                and meta_name.endswith("_total"):
            # OpenMetrics names a counter FAMILY without the _total
            # suffix (samples keep it: family + "_total") — this
            # repo's counters register with _total in the name, so
            # the OpenMetrics flavor strips it from HELP/TYPE or a
            # spec-compliant scraper rejects the whole exposition
            meta_name = meta_name[: -len("_total")]
        lines.append(f"# HELP {meta_name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {meta_name} {kind}")
        for values, child in (
            fam.series() if series is None else series
        ):
            labels = _labels_str(fam.labelnames, values)
            if kind in ("counter", "gauge"):
                try:
                    v = child.value
                except Exception as e:  # callback gauges may die
                    lines.append(
                        f"# callback for {fam.name}{labels} failed: {e!r}"
                    )
                    continue
                lines.append(f"{fam.name}{labels} {_fmt(v)}")
                continue
            counts, total_count, total_sum = child.snapshot()
            ex = child.exemplars() if exemplars else None
            cumulative = 0
            for i, (bound, c) in enumerate(zip(child._bounds, counts)):
                cumulative += c
                le = _labels_str(
                    fam.labelnames, values, extra=(("le", _fmt(bound)),)
                )
                line = f"{fam.name}_bucket{le} {cumulative}"
                if ex is not None and ex[i] is not None:
                    line += _exemplar_str(*ex[i])
                lines.append(line)
            inf = _labels_str(
                fam.labelnames, values, extra=(("le", "+Inf"),)
            )
            line = f"{fam.name}_bucket{inf} {total_count}"
            if ex is not None and ex[-1] is not None:
                line += _exemplar_str(*ex[-1])
            lines.append(line)
            lines.append(f"{fam.name}_sum{labels} {_fmt(total_sum)}")
            lines.append(f"{fam.name}_count{labels} {total_count}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_openmetrics(registry=None) -> str:
    """The OpenMetrics flavor: the same sample lines as
    :func:`render` with histogram exemplars attached, terminated by
    the mandatory ``# EOF`` marker. This is what a TTFT p99 dashboard
    scrapes to jump from a latency spike to the rid that caused it
    (resolve the rid via ``GET /v1/requests/{rid}/trace``)."""
    return render(registry, exemplars=True) + "# EOF\n"


def scrape_text() -> str:
    """The default registry rendered — what ``GET /metrics`` serves."""
    return render()
