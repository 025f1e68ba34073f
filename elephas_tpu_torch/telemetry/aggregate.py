"""Fleet metrics aggregation (counterpart of
``elephas_tpu/telemetry/aggregate.py``: the same parse and the same
rendered bytes).

One serving replica exposes ``/metrics``; a fleet exposes N of them,
and the cache- and load-aware router needs ONE view of every
replica's blocks-free, queue-depth, and prefix-warmth gauges — the
Prometheus-federation / Monarch shape, scaled to this repo.

:class:`FleetScraper` polls N scrape *targets* — an HTTP ``/metrics``
URL (gateway, HTTP PS), any object with a ``scrape()`` method (engine,
Socket/Native PS, ``SparkModel``),
or a plain callable returning exposition text — parses each exposition
with :func:`parse_exposition`, re-labels every series with
``instance=<target label>`` (a pre-existing ``instance`` label is
renamed ``exported_instance``, the Prometheus federation convention),
and re-renders the union as ONE exposition via :meth:`FleetScraper.\
render` (plus :meth:`FleetScraper.serve` for a single HTTP
``/metrics`` endpoint that scrapes *through* on every GET).

Contracts, inherited from the rest of the telemetry layer:

- **Sources are never mutated.** Aggregation is parse + re-render of
  each target's text; nothing writes into a source registry, and the
  fleet view lives in plain host snapshots. The scraper's own meta
  series (``elephas_fleet_up``, scrape counters) live in THIS
  process's registry, labeled by the scraper instance.
- **Telemetry never drives control flow.** ``fleet_stats()`` is the
  read surface a router or watchdog consumes; the scraper itself
  decides nothing.
- **Wall time export-only.** Polling cadence is the caller's; nothing
  here stamps or compares wall clocks.
"""

from __future__ import annotations

import http.client
import logging
import re
import threading
import urllib.parse

from elephas_tpu_torch import telemetry

logger = logging.getLogger(__name__)

__all__ = ["Family", "parse_exposition", "FleetScraper"]

_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)"
)
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _unescape(value: str) -> str:
    return (
        value.replace("\\n", "\n").replace('\\"', '"')
        .replace("\\\\", "\\")
    )


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


class Family:
    """One parsed metric family: ``kind``/``help`` plus raw samples —
    ``(sample_name, labels_dict, value)`` with histogram ``_bucket``/
    ``_sum``/``_count`` sample names preserved verbatim, so re-
    rendering is lossless."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str = "untyped", help_: str = ""):
        self.name = name
        self.kind = kind
        self.help = help_
        self.samples: list[tuple[str, dict, float]] = []


def parse_exposition(text: str) -> dict[str, Family]:
    """Parse Prometheus text exposition (0.0.4; OpenMetrics inputs
    tolerated — exemplar suffixes and ``# EOF`` are dropped) into
    ``{family_name: Family}``. Histogram/summary child samples fold
    into their parent family by name-prefix matching on the preceding
    ``# TYPE`` line, the same convention every Prometheus parser
    uses."""
    families: dict[str, Family] = {}
    current: Family | None = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = Family(name)
                if parts[1] == "TYPE":
                    fam.kind = parts[3] if len(parts) > 3 else "untyped"
                else:
                    fam.help = parts[3] if len(parts) > 3 else ""
                current = fam
            continue
        # strip an OpenMetrics exemplar (` # {...} v`) if present
        bare = line.split(" # ", 1)[0]
        m = _SAMPLE.match(bare)
        if m is None:
            continue
        sample_name, labels_raw, value_raw = m.groups()
        fam_name = sample_name
        if current is not None and current.kind in ("histogram", "summary"):
            for suffix in _HIST_SUFFIXES:
                if sample_name == current.name + suffix:
                    fam_name = current.name
                    break
        fam = families.get(fam_name)
        if fam is None:
            fam = families[fam_name] = Family(fam_name)
        labels = {
            k: _unescape(v)
            for k, v in _LABEL_PAIR.findall(labels_raw or "")
        }
        try:
            value = _parse_value(value_raw)
        except ValueError:
            continue  # unparsable sample: skip, never poison the poll
        fam.samples.append((sample_name, labels, value))
        current = fam if fam_name == fam.name else current
    return families


def _fetch_url(url: str, timeout: float) -> str:
    """GET one ``/metrics`` URL over stdlib http.client (the repo has
    no requests dependency; the PS clients set the same precedent)."""
    parsed = urllib.parse.urlsplit(url)
    if parsed.scheme != "http":
        raise ValueError(f"only http:// targets are supported, got {url}")
    conn = http.client.HTTPConnection(
        parsed.hostname, parsed.port or 80, timeout=timeout
    )
    try:
        path = parsed.path or "/metrics"
        if parsed.query:
            path += "?" + parsed.query
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise ConnectionError(f"GET {url} -> {resp.status}")
        return body.decode("utf-8", "replace")
    finally:
        conn.close()


class FleetScraper:
    """Poll N scrape targets into one relabeled fleet view.

    ``targets`` maps an instance label (the value the merged series
    carry as ``instance=``) to a target: an ``http://host:port/path``
    URL, an object with ``scrape()``, or a callable returning
    exposition text. Targets can be added later with
    :meth:`add_target`.

    A failed poll keeps the target's LAST view (stale-but-present, the
    same degrade the sharded PS client serves for a dead shard's
    pull) and flips its ``elephas_fleet_up`` gauge to 0 — exactly the
    signal a watchdog or router should read instead of an exception.
    """

    def __init__(self, targets=None, timeout: float = 5.0,
                 poll_on_render: bool = True):
        self.timeout = float(timeout)
        # poll-through on render()/GET /metrics: the federation shape
        # (each fleet scrape re-reads every member). False = render
        # only what poll() last gathered (tests, manual cadence).
        self.poll_on_render = bool(poll_on_render)
        self._targets: dict[str, object] = {}
        self._lock = threading.Lock()
        self._snap: dict[str, dict[str, Family]] = {}
        self._up: dict[str, bool] = {}
        self._httpd = None
        self._http_thread = None
        self.port: int | None = None
        # meta series (registry-backed, captured at construction —
        # the standing null-mode contract)
        reg = telemetry.registry()
        self._registry = reg
        self._tracer = telemetry.tracer()
        fid = telemetry.instance_label()
        self.telemetry_label = fid
        self._mf_up = reg.gauge(
            "elephas_fleet_up",
            "1 while the instance's last scrape succeeded, else 0",
            labels=("fleet", "instance"),
        )
        self._mf_scrapes = reg.counter(
            "elephas_fleet_scrapes_total",
            "Fleet-scraper polls of a member instance",
            labels=("fleet", "instance"),
        )
        self._mf_errors = reg.counter(
            "elephas_fleet_scrape_errors_total",
            "Failed fleet-scraper polls (stale view served)",
            labels=("fleet", "instance"),
        )
        for label, target in dict(targets or {}).items():
            self.add_target(label, target)

    # -- targets --------------------------------------------------------

    def add_target(self, label: str, target) -> None:
        label = str(label)
        if not label:
            raise ValueError("instance label must be non-empty")
        with self._lock:
            if label in self._targets:
                raise ValueError(
                    f"duplicate fleet instance label {label!r} — two "
                    f"targets under one label would silently merge "
                    f"their series"
                )
            self._targets[label] = target
        # materialize the up/scrape series now so a fleet scrape shows
        # every declared member from the first render
        self._mf_up.labels(fleet=self.telemetry_label, instance=label)
        self._mf_scrapes.labels(fleet=self.telemetry_label, instance=label)
        self._mf_errors.labels(fleet=self.telemetry_label, instance=label)

    def remove_target(self, label: str) -> None:
        """Forget one member: its target, snapshot, and up-state drop,
        and its meta series retire from the registry — the membership-
        change shape (the fleet router swaps a replica's
        scrape target when a dead replica is restored with a fresh
        engine). Unknown labels raise loudly."""
        label = str(label)
        with self._lock:
            if label not in self._targets:
                raise KeyError(
                    f"unknown fleet instance label {label!r} — have "
                    f"{sorted(self._targets)}"
                )
            del self._targets[label]
            self._snap.pop(label, None)
            self._up.pop(label, None)
        self._registry.remove_series(
            fleet=self.telemetry_label, instance=label
        )

    @property
    def instances(self) -> list[str]:
        with self._lock:
            return sorted(self._targets)

    def _scrape_one(self, target) -> str:
        if isinstance(target, str):
            return _fetch_url(target, self.timeout)
        scrape = getattr(target, "scrape", None)
        if scrape is not None:
            return scrape()
        if callable(target):
            return target()
        raise TypeError(
            f"fleet target must be a URL, a scrape()-bearing object, "
            f"or a callable, got {type(target).__name__}"
        )

    # -- polling --------------------------------------------------------

    def poll(self) -> dict[str, bool]:
        """Scrape every target once; returns ``{instance: up}``. A
        failing target keeps its previous families (stale view) and
        reads ``up=False`` until a later poll succeeds."""
        with self._lock:
            targets = dict(self._targets)
        result: dict[str, bool] = {}
        for label, target in sorted(targets.items()):
            self._mf_scrapes.labels(
                fleet=self.telemetry_label, instance=label
            ).inc()
            try:
                families = parse_exposition(self._scrape_one(target))
            except (ConnectionError, TimeoutError, OSError, ValueError,
                    TypeError) as e:
                self._mf_errors.labels(
                    fleet=self.telemetry_label, instance=label
                ).inc()
                self._mf_up.labels(
                    fleet=self.telemetry_label, instance=label
                ).set(0)
                with self._lock:
                    self._up[label] = False
                result[label] = False
                logger.warning(
                    "fleet scrape of %r failed (%r) — serving its "
                    "last view", label, e,
                )
                continue
            with self._lock:
                self._snap[label] = families
                self._up[label] = True
            self._mf_up.labels(
                fleet=self.telemetry_label, instance=label
            ).set(1)
            result[label] = True
        return result

    # -- fleet view -----------------------------------------------------

    def _snapshot(self) -> dict[str, dict[str, Family]]:
        with self._lock:
            return dict(self._snap)

    @staticmethod
    def _relabel(labels: dict, instance: str) -> dict:
        out = dict(labels)
        if "instance" in out:
            # federation convention: the member's own notion of
            # "instance" survives under exported_instance
            out["exported_instance"] = out.pop("instance")
        return {"instance": instance, **out}

    def render(self) -> str:
        """ONE Prometheus exposition of every member's series, each
        re-labeled ``instance=<label>`` — plus this scraper's own
        ``elephas_fleet_*`` meta series. Sources are read-only; a
        family whose TYPE disagrees across members is rendered under
        the first member's kind with a warning comment (re-typing a
        live family is a member bug this view must surface, not
        hide)."""
        from elephas_tpu_torch.telemetry import expose

        if self.poll_on_render:
            self.poll()
        snap = self._snapshot()
        # family union, sorted for stable scrapes
        names: dict[str, Family] = {}
        conflicts: list[str] = []
        for label in sorted(snap):
            for name, fam in snap[label].items():
                head = names.get(name)
                if head is None:
                    names[name] = fam
                elif head.kind != fam.kind:
                    conflicts.append(
                        f"# WARNING family {name} kind differs across "
                        f"instances ({head.kind} vs {fam.kind} from "
                        f"{label})"
                    )
        lines: list[str] = []
        for name in sorted(names):
            head = names[name]
            if head.help:
                lines.append(
                    f"# HELP {name} "
                    f"{head.help.replace(chr(10), ' ')}"
                )
            lines.append(f"# TYPE {name} {head.kind}")
            for label in sorted(snap):
                fam = snap[label].get(name)
                if fam is None:
                    continue
                for sample_name, labels, value in fam.samples:
                    merged = self._relabel(labels, label)
                    pairs = ",".join(
                        f'{k}="{expose._escape_label(str(v))}"'
                        for k, v in merged.items()
                    )
                    lines.append(
                        f"{sample_name}{{{pairs}}} {expose._fmt(value)}"
                    )
        lines.extend(conflicts)
        body = "\n".join(lines) + ("\n" if lines else "")
        # the scraper's own meta series ride along (real registry,
        # filtered to this scraper instance)
        body += telemetry.render(
            self._registry, only={"fleet": self.telemetry_label}
        )
        return body

    # -- read surface (router / watchdog substrate) --------------------

    def series(self, name: str) -> list[tuple[dict, float]]:
        """All instances' samples of family ``name`` (exact sample
        name for scalars; histogram children by their full sample
        name), instance-labeled — the reader surface
        :class:`~elephas_tpu_torch.telemetry.watch.Watchdog` accepts as a
        source."""
        out: list[tuple[dict, float]] = []
        for label, families in sorted(self._snapshot().items()):
            fam = families.get(name)
            samples = fam.samples if fam is not None else []
            if fam is None:
                # scalar samples may live under their family name
                # without a TYPE comment upstream — fall through
                for f in families.values():
                    samples = [
                        s for s in f.samples if s[0] == name
                    ]
                    if samples:
                        break
            for sample_name, labels, value in samples:
                if sample_name != name:
                    continue
                out.append((self._relabel(labels, label), value))
        return out

    def value(self, name: str, instance: str | None = None,
              **labels) -> float:
        """Sum of matching samples (0.0 when none) — the quick router
        probe: ``fleet.value("elephas_serving_blocks_free",
        instance="replica-1")``."""
        total = 0.0
        for sample_labels, value in self.series(name):
            if instance is not None and \
                    sample_labels.get("instance") != str(instance):
                continue
            if any(
                sample_labels.get(k) != str(v)
                for k, v in labels.items()
            ):
                continue
            if value == value:  # NaN-guard: dead pull gauges
                total += value
        return total

    def fleet_stats(self) -> dict:
        """Structured per-instance summary — the blocks-free /
        queue-depth substrate the fleet router reads:
        ``{instance: {up, families, blocks_free, queue_depth,
        tokens_generated, requests_finished}}``."""
        snap = self._snapshot()
        with self._lock:
            up = dict(self._up)
        out = {}
        for label in sorted(set(snap) | set(up)):
            families = snap.get(label, {})
            n_samples = sum(
                len(f.samples) for f in families.values()
            )

            def total(name, label=label, families=families):
                fam = families.get(name)
                if fam is None:
                    return 0.0
                return sum(
                    v for s, _l, v in fam.samples
                    if s == name and v == v
                )

            out[label] = {
                "up": bool(up.get(label, False)),
                "families": len(families),
                "samples": n_samples,
                "blocks_free": total("elephas_serving_blocks_free"),
                "queue_depth": total("elephas_serving_waiting_requests"),
                "tokens_generated": total(
                    "elephas_serving_tokens_generated_total"
                ),
                "requests_finished": total(
                    "elephas_serving_requests_finished_total"
                ),
                # the weight generation each instance serves
                # — the rollout controller's convergence read (one
                # gauge per engine, so a multi-engine instance sums;
                # fleet replicas are one engine each)
                "weight_version": int(total(
                    "elephas_serving_weight_version"
                )),
            }
        return out

    # -- single /metrics re-exposure ------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> "FleetScraper":
        """Expose the fleet view as one HTTP endpoint: ``GET
        /metrics`` renders the merged exposition (scrape-through when
        ``poll_on_render``), ``GET /fleet`` returns
        :meth:`fleet_stats` as JSON. ``port=0`` binds an ephemeral
        port (read :attr:`port`); :meth:`stop` severs and releases
        it."""
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if self._httpd is not None:
            raise RuntimeError("fleet scraper already serving")
        scraper = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/metrics":
                    payload = scraper.render().encode("utf-8")
                    ctype = telemetry.CONTENT_TYPE
                elif path == "/fleet":
                    payload = _json.dumps(
                        scraper.fleet_stats(), default=float
                    ).encode("utf-8") + b"\n"
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="elephas-fleet-metrics", daemon=True,
        )
        self._http_thread.start()
        logger.info("fleet /metrics serving on %s:%d", host, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._http_thread is not None:
                self._http_thread.join(timeout=10)
                self._http_thread = None

    def __enter__(self) -> "FleetScraper":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def release_telemetry(self) -> None:
        """Retire this scraper's meta series (explicit-only, the
        standing retirement contract)."""
        telemetry.remove_series(fleet=self.telemetry_label)
