"""Fleet trace merge (counterpart of ``elephas_tpu/telemetry/merge.py``:
the same merged document and offsets from the same exports).

Each process's :meth:`~elephas_tpu_torch.telemetry.events.EventTracer.\
export_chrome_trace` writes ONE timeline — fine for one engine, but a
weight push that travels worker → PS shard → serving engine, or a
request that enters at the gateway and decodes in the engine, is a
story spread across N exports. This module aligns those exports into
ONE Chrome trace (`chrome://tracing` / Perfetto):

- **Per-instance rows.** Every input file becomes one Chrome ``pid``
  with a ``process_name`` metadata row; within it, events group into
  ``tid`` rows by *component* (``ps-server-3``, ``ps-client-1``,
  ``worker-0``, ``engine-2``, ``gateway-0``, ``chaos``), derived from
  the instance labels the emitting components stamp into their event
  args — so even a single-process export reads as a fleet.

- **Clock alignment.** Wall timestamps are export-only and per-process
  (the standing telemetry contract: ordering authority is the logical
  seq, which never crosses processes). To place N exports on one time
  axis the merger uses the wire's request/ack pairs as alignment
  edges, Dapper-style: a client-side ``ps.push`` span (args ``cid``,
  ``seq``) and the server-side ``ps.apply`` span for the same
  ``(client_id, seq)`` bound each other — the apply happened INSIDE
  the push's round-trip window, so the peer's clock offset must lie in
  ``[push_start - apply_start, push_end - apply_end]``. Intersecting
  the intervals over every matched pair (and walking the edge graph
  breadth-first from instance 0) yields one offset per instance;
  instances with no edges keep offset 0 (same-host exports share a
  clock anyway).

- **Trace-id normalization.** Events carrying an explicit ``trace``
  arg (the propagated context) keep it; rid-stamped serving events and
  the gateway's rid-stamped request span gain ``trace="rid-<rid>"`` —
  so one trace id spans gateway → engine for a request, and
  worker → PS shard → journal write for a push, on the SAME merged
  timeline.

CLI::

    python -m elephas_tpu_torch.telemetry.merge a.json b.json -o fleet.json

Pure host tooling: nothing here touches the live registry or tracer,
and nothing in the runtime reads a merged trace back — observability
stays report-only.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = [
    "load_trace",
    "align_offsets_us",
    "merge_chrome_traces",
    "main",
]

# args keys that identify the emitting component, checked in order —
# the first present key names the event's merged-timeline row
_COMPONENT_KEYS = (
    ("gateway", "gateway-{}"),
    ("server", "ps-server-{}"),
    ("client", "ps-client-{}"),
    ("worker", "worker-{}"),
    ("engine", "engine-{}"),
    ("scheduler", "scheduler-{}"),
    ("cache", "prefix-cache-{}"),
)

# event-name prefixes that land on dedicated rows when no component
# label identifies them (chaos injections carry port/shard args only;
# serve.* request-lifecycle events carry rid)
_NAME_ROWS = (
    ("chaos.", "chaos"),
    ("watch.", "watchdog"),
    ("serve.", "serving"),
    ("fit.", "training"),
)


def component_row(event: dict) -> str:
    """The merged-timeline row (Chrome ``tid`` name) for one event."""
    args = event.get("args") or {}
    for key, fmt in _COMPONENT_KEYS:
        if key in args:
            return fmt.format(args[key])
    name = str(event.get("name", ""))
    for prefix, row in _NAME_ROWS:
        if name.startswith(prefix):
            return row
    return f"thread-{event.get('tid', 0)}"


def trace_id_of(event: dict) -> str | None:
    """The event's trace identity: the propagated ``trace`` arg when
    present, else ``rid-<rid>`` for request-scoped events (the rid IS
    the per-request trace context)."""
    args = event.get("args") or {}
    trace = args.get("trace")
    if trace is not None:
        return str(trace)
    rid = args.get("rid")
    if rid is not None:
        return f"rid-{rid}"
    return None


def load_trace(path: str) -> list[dict]:
    """The ``traceEvents`` list of one Chrome-trace JSON export."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events


def _edge_windows(events: list[dict], name: str,
                  cid_key: str) -> dict[tuple, tuple[float, float]]:
    """Alignment edges: ``(cid, seq) -> (t0, t1)`` µs windows of the
    sequenced spans named ``name``. A ``(cid, seq)`` pair that appears
    MORE THAN ONCE in one export is dropped as ambiguous — the sharded
    client shares one worker ``client_id`` across shards while each
    shard keeps its own seq counter, so a multi-shard export holds one
    push per shard under the same pair; pairing either against a
    single shard's apply would silently corrupt the offset, whereas
    skipping the key just falls back to the export's unambiguous edges
    (or offset 0). Seq -1 = unsequenced: no server-side pair exists."""
    out: dict[tuple, tuple[float, float] | None] = {}
    for e in events:
        if e.get("name") != name or e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        cid, seq = args.get(cid_key), args.get("seq", -1)
        if not cid or seq is None or int(seq) < 0:
            continue
        key = (str(cid), int(seq))
        if key in out:
            out[key] = None  # ambiguous: poison, filter below
            continue
        out[key] = (
            float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        )
    return {k: v for k, v in out.items() if v is not None}


def _push_windows(events: list[dict]) -> dict[tuple, tuple[float, float]]:
    return _edge_windows(events, "ps.push", "cid")


def _apply_windows(events: list[dict]) -> dict[tuple, tuple[float, float]]:
    return _edge_windows(events, "ps.apply", "client_id")


def _pair_offset_interval_us(pushes, applies) -> tuple[float, float] | None:
    """The feasible clock-offset interval (µs, add to the APPLY side's
    clock to land on the PUSH side's) across every matched
    ``(cid, seq)`` pair — the intersection of per-pair nesting bounds.
    None when the two instances share no pair."""
    keys = set(pushes) & set(applies)
    if not keys:
        return None
    lo, hi = float("-inf"), float("inf")
    for k in keys:
        p0, p1 = pushes[k]
        a0, a1 = applies[k]
        lo = max(lo, p0 - a0)
        hi = min(hi, p1 - a1)
    if lo > hi:
        # clock noise squeezed the intersection shut — the midpoint of
        # the crossed bounds is still the least-bad single estimate
        lo, hi = hi, lo
    return lo, hi


def align_offsets_us(traces: list[list[dict]]) -> list[float]:
    """One wall-clock offset (µs) per input, anchored at input 0,
    walking the push↔apply edge graph breadth-first. Unreachable
    inputs keep 0.0 (same-host exports already share a clock)."""
    n = len(traces)
    pushes = [_push_windows(t) for t in traces]
    applies = [_apply_windows(t) for t in traces]
    offsets = [0.0] * n
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for i in frontier:
            for j in range(n):
                if j in seen:
                    continue
                # j's applies inside i's pushes: offset shifts j → i
                interval = _pair_offset_interval_us(pushes[i], applies[j])
                if interval is not None:
                    off = (interval[0] + interval[1]) / 2.0
                else:
                    # i's applies inside j's pushes: the reverse edge
                    interval = _pair_offset_interval_us(
                        pushes[j], applies[i]
                    )
                    if interval is None:
                        continue
                    off = -(interval[0] + interval[1]) / 2.0
                offsets[j] = offsets[i] + off
                seen.add(j)
                nxt.append(j)
        frontier = nxt
    return offsets


def merge_chrome_traces(paths: list[str], out: str | None = None,
                        labels: list[str] | None = None) -> dict:
    """Merge N Chrome-trace exports into one fleet timeline; returns
    the merged document (and writes it to ``out`` when given). See the
    module docstring for row layout, clock alignment, and trace-id
    normalization."""
    if not paths:
        raise ValueError("need at least one trace file")
    if labels is None:
        labels = [_default_label(p, i) for i, p in enumerate(paths)]
    if len(labels) != len(paths):
        raise ValueError(
            f"{len(labels)} labels for {len(paths)} traces"
        )
    traces = [load_trace(p) for p in paths]
    offsets = align_offsets_us(traces)
    merged: list[dict] = []
    trace_ids: set[str] = set()
    for pid, (events, label, off) in enumerate(
        zip(traces, labels, offsets)
    ):
        merged.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        rows: dict[str, int] = {}
        for e in events:
            if e.get("ph") == "M":
                continue  # input metadata: re-derived here
            row = component_row(e)
            tid = rows.setdefault(row, len(rows) + 1)
            args = dict(e.get("args") or {})
            tid_of = trace_id_of(e)
            if tid_of is not None:
                args["trace"] = tid_of
                trace_ids.add(tid_of)
            args["instance"] = label
            out_ev = dict(e)
            out_ev.update(
                pid=pid, tid=tid,
                ts=float(e.get("ts", 0.0)) + off, args=args,
            )
            merged.append(out_ev)
        for row, tid in rows.items():
            merged.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": row},
            })
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        # provenance block for the bench's merged-view cross-checks —
        # a consumer can re-derive the alignment without re-running
        "elephas_fleet": {
            "inputs": list(labels),
            "offsets_us": [round(o, 3) for o in offsets],
            "trace_ids": sorted(trace_ids),
        },
    }
    if out:
        with open(out, "w") as f:
            json.dump(doc, f)
    return doc


def _default_label(path: str, index: int) -> str:
    stem = path.rsplit("/", 1)[-1]
    if stem.endswith(".json"):
        stem = stem[: -len(".json")]
    return f"{index}:{stem}"


def spans(doc: dict, name: str) -> list[dict]:
    """Convenience for consumers (bench cross-checks, tests): the
    merged document's complete-span events with ``name``."""
    return [
        e for e in doc.get("traceEvents", [])
        if e.get("name") == name and e.get("ph") == "X"
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m elephas_tpu_torch.telemetry.merge",
        description=(
            "Merge N per-process Chrome-trace exports into one "
            "aligned fleet timeline (pid/tid rows per instance/"
            "component, wire request/ack clock alignment, trace-id "
            "normalization)."
        ),
    )
    p.add_argument("traces", nargs="+", help="Chrome-trace JSON files")
    p.add_argument("-o", "--out", default="fleet-trace.json",
                   help="merged output path (default: %(default)s)")
    p.add_argument("--labels", default=None,
                   help="comma-separated instance labels, one per input")
    args = p.parse_args(argv)
    labels = args.labels.split(",") if args.labels else None
    doc = merge_chrome_traces(args.traces, out=args.out, labels=labels)
    meta = doc["elephas_fleet"]
    n_events = sum(
        1 for e in doc["traceEvents"] if e.get("ph") != "M"
    )
    print(
        f"merged {len(args.traces)} trace(s) -> {args.out}: "
        f"{n_events} events, offsets_us={meta['offsets_us']}, "
        f"{len(meta['trace_ids'])} distinct trace id(s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
