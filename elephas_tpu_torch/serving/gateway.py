"""Async HTTP/SSE front door over the serving engine: the port's copy of
``elephas_tpu/serving/gateway.py``, with the same routes, status codes,
headers, JSON shapes and metric names.

One :class:`Gateway` puts one wire in front of one
:class:`~elephas_tpu_torch.serving.engine.InferenceEngine`:

- ``POST /v1/generate`` — JSON body ``{"prompt": [ints],
  "max_new_tokens": n, "temperature": t, "eos_id": e, "tenant": name,
  "ttft_deadline_ms": ms, "priority": p, "stream": true}``. With
  ``stream`` (the default) the response is Server-Sent Events riding the
  engine's per-request ``on_token`` callback: an opening
  ``data: {"rid": id}`` event, one ``data: {"token": t, "done": d}`` event
  per generated token, then an ``event: done`` summary, and the
  connection closes. ``stream: false`` buffers and returns one JSON
  document. The batch form carries ``"prompts": [[...], ...]`` instead of
  ``prompt``: every prompt is a normal ``submit()`` (the policy judges
  each), answered as one ``results`` JSON array or one rid-multiplexed SSE
  stream.
- **HTTP keep-alive**: a ``Connection: keep-alive`` client (HTTP/1.1
  default) gets its next request served off the same socket under a
  bounded idle timeout (``keepalive_idle_timeout``, default 5 s), counted
  in ``elephas_gateway_connections_reused_total``. SSE responses own their
  connection to the end.
- ``GET /metrics`` — the port's registry as Prometheus text (what
  ``engine.scrape()`` returns); an ``Accept: application/openmetrics-text``
  client gets the OpenMetrics flavor with rid exemplars.
- ``GET /stats`` — ``engine.stats()`` as JSON.
- ``GET /healthz`` — liveness for a fleet router: 200 while the driver
  thread is alive and steps advance when there is work, 503 otherwise,
  with the watchdog's report. Never waits on the engine lock.
- ``GET /debug/engine`` — ``engine.debug_snapshot()`` as JSON.
- ``GET /v1/requests/{rid}/trace`` — ``engine.explain(rid)``;
  ``POST /v1/requests/{rid}/cancel`` — ``engine.cancel(rid)``;
  ``POST /v1/requests/{rid}/export`` — the request leaves as a migration
  record (:mod:`elephas_tpu_torch.fleet.migration`, wire v3);
  ``POST /v1/migrate`` — adopt such a record; ``POST /v1/score`` —
  ``engine.score``.

Every ``/v1/generate`` response, the 429 and 422 refusals included, echoes
the engine-minted request id as an ``X-Request-Id`` header (and in the SSE
opening event or JSON body). A submit the policy refuses answers **429**
with a ``Retry-After`` header; a validation error 400; the paged
never-fit refusal 422 (retrying cannot help). Every read sits under a
deadline, every write is drained, a body over ``max_body`` answers 413, a
``Transfer-Encoding`` body is refused (501), and :meth:`Gateway.stop`
severs live SSE connections and releases the port.

Threading: the asyncio loop runs in one daemon thread (socket I/O only,
never a tensor), a driver thread steps the engine whenever the scheduler
has work, and one lock serializes ``submit()`` / ``step()`` on the engine.
The driver thread runs under ``torch.cuda.device(engine.device)`` for its
whole life (PyTorch's current device is per thread), and the kernels are
built before it starts, never under the lock on a first request. Tokens
cross from the driver thread into the loop via ``call_soon_threadsafe``
onto per-request queues. An error in the driver thread (a CUDA error
included) tears the gateway down: ``/healthz`` answers 503
``driver-dead`` until the port closes, and nothing carries on elsewhere.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import re
import threading
import time

import torch

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.serving.policy import AdmissionRejected

logger = logging.getLogger(__name__)

#: Read deadline for request line / headers / body — a dead or
#: dribbling client is cut loose instead of pinning a handler task
#: (connections get deadlines, period).
READ_TIMEOUT = 30.0
#: Largest accepted request body; a prompt is a list of ints, so even
#: maxlen-scale prompts sit far below this.
MAX_BODY = 1 << 20

_STATUS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


def _response(code: int, body: bytes, content_type: str,
              extra_headers=(), close: bool = True) -> bytes:
    head = [
        f"HTTP/1.1 {code} {_STATUS.get(code, 'Unknown')}",
        f"Content-Type: {content_type}",
        f"Content-Length: {len(body)}",
        "Connection: close" if close else "Connection: keep-alive",
    ]
    head.extend(f"{k}: {v}" for k, v in extra_headers)
    return ("\r\n".join(head) + "\r\n\r\n").encode("ascii") + body


def _json_response(code: int, obj, extra_headers=(),
                   close: bool = True) -> bytes:
    return _response(
        code, json.dumps(obj).encode("utf-8") + b"\n",
        "application/json", extra_headers, close=close,
    )


class _Conn:
    """Per-connection keep-alive state: whether
    the CURRENT response may leave the connection open. Handlers that
    must own the socket to its end (SSE streams) flip ``persist``
    off; everything else answers ``Connection: keep-alive`` when the
    client asked for it and reads the next request off the same
    socket under a bounded idle timeout."""

    __slots__ = ("persist", "served")

    def __init__(self):
        self.persist = False
        self.served = 0

    def close_header(self) -> bool:
        return not self.persist


class _ConnectionClosed(Exception):
    """EOF where a request line should start — a 400 on a fresh
    connection, a clean goodbye on an idle keep-alive one."""


class _HttpError(Exception):
    """Maps straight to one non-200 response."""

    def __init__(self, code: int, message: str, extra_headers=()):
        super().__init__(message)
        self.code = code
        self.extra_headers = tuple(extra_headers)


class Gateway:
    """One HTTP/SSE front door over one engine. ``port=0`` binds an
    ephemeral port (read :attr:`port` after :meth:`start`). Use as a
    context manager, or pair :meth:`start`/:meth:`stop` — stop severs
    live SSE connections and releases the port."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 read_timeout: float = READ_TIMEOUT,
                 max_body: int = MAX_BODY,
                 max_migrate_body: int = 1 << 28,
                 health_stall_grace: float = 120.0,
                 keepalive_idle_timeout: float = 5.0,
                 max_batch_prompts: int = 64,
                 watchdog=None):
        self.engine = engine
        self.host = host
        self._want_port = int(port)
        self.port: int | None = None
        self.read_timeout = float(read_timeout)
        self.max_body = int(max_body)
        # HTTP keep-alive: a
        # client that asks for it (HTTP/1.1 default) gets its next
        # request served off the SAME connection, bounded by this idle
        # timeout between requests (0 disables persistence outright).
        # SSE streams still own their socket to the end.
        self.keepalive_idle_timeout = float(keepalive_idle_timeout)
        # /v1/generate batch form: one POST may carry up to this many
        # prompts (each a NORMAL submit — policy/admission see them
        # individually); bounded so a single request cannot flood the
        # queue past what admission control can see coming
        self.max_batch_prompts = int(max_batch_prompts)
        # migration records carry dense K/V blocks — orders of
        # magnitude bigger than a generate body; own bound
        self.max_migrate_body = int(max_migrate_body)
        # /healthz stall detection: grace window before "has work but
        # steps are not advancing" reports 503. The reference's default
        # (2 min) is kept; the kernels build in start(), so a first
        # request never stalls behind a build
        self.health_stall_grace = float(health_stall_grace)
        # (steps, monotonic-time) of the last observed step progress;
        # time.monotonic is a LOCAL duration clock — wall clock stays
        # banned on serving control paths (telemetry lint)
        self._hz_anchor: tuple[int, float] | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._loop_thread: threading.Thread | None = None
        self._driver_thread: threading.Thread | None = None
        # serializes engine.submit() (loop thread) vs engine.step()
        # (driver thread) — both are host bookkeeping; device dispatch
        # stays on the driver side of this lock
        self._work = threading.Event()
        self._stopping = threading.Event()
        # _stopping means "no new work" (the driver's crash path sets
        # it too); _stopped is the one-shot teardown latch — stop()
        # must still run its full teardown after a driver crash, or
        # the port and live handlers would leak exactly the way the
        # module docstring promises they cannot
        self._stopped = False
        self._stop_lock = threading.Lock()
        # the exception that killed the driver thread, if one did
        self.driver_error: BaseException | None = None
        self._started = False
        # live handler tasks + writers, so stop() can sever them
        self._tasks: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()
        # telemetry (engine-label family set: release_telemetry on the
        # gateway retires only its own series)
        reg = telemetry.registry()
        self._tracer = telemetry.tracer()
        gid = telemetry.instance_label()
        self.telemetry_label = gid
        self._m_requests = reg.counter(
            "elephas_gateway_requests_total",
            "HTTP requests served by the gateway, by route and status",
            labels=("gateway", "route", "code"),
        )
        self._m_sse_active = reg.gauge(
            "elephas_gateway_sse_active",
            "SSE token streams currently open",
            labels=("gateway",),
        ).labels(gateway=gid)
        self._m_conn_reused = reg.counter(
            "elephas_gateway_connections_reused_total",
            "Requests served off an already-open keep-alive "
            "connection (the handshake they did not pay)",
            labels=("gateway",),
        ).labels(gateway=gid)
        # anomaly watchdog: rules evaluate at /healthz
        # PROBE cadence — never per step/token, the hot-path contract
        # — and the report embeds as healthz detail so a fleet router
        # reads liveness AND the why in one probe. None under null
        # mode (inert by construction); pass watchdog=False to opt
        # out, or a prebuilt Watchdog (e.g. with tuned rules).
        from elephas_tpu_torch.telemetry.watch import Watchdog

        # a watchdog the gateway builds is the gateway's: its series retire
        # with the gateway's
        self._own_watchdog = watchdog is None
        if watchdog is None:
            watchdog = (
                Watchdog() if not telemetry.null_mode() else None
            )
        elif watchdog is False or watchdog == 0:
            watchdog = None
        elif not isinstance(watchdog, Watchdog):
            raise TypeError(
                f"watchdog must be a telemetry.watch.Watchdog, None "
                f"(auto), or False (off), got "
                f"{type(watchdog).__name__}"
            )
        self.watchdog = watchdog

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Gateway":
        """Build the engine's kernels (on a card), bind the port, start the
        loop and driver threads. Raises what binding raises (a port in
        use) with nothing left running."""
        if self._started:
            raise RuntimeError("gateway already started")
        if self.engine.device.type == "cuda":
            # every kernel library of the engine's path exists before the
            # first request: a build under the engine lock would stall the
            # driver past health_stall_grace
            from elephas_tpu_torch.ops import _native

            _native.build()
        self._started = True
        ready = threading.Event()
        boot_err: list[BaseException] = []

        def loop_main():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(
                        self._handle, self.host, self._want_port
                    )
                )
            except OSError as e:  # port in use, bad host, ...
                boot_err.append(e)
                loop.close()  # else the selector fd leaks until GC
                ready.set()
                return
            self.port = self._server.sockets[0].getsockname()[1]
            ready.set()
            try:
                loop.run_forever()
            finally:
                # loop.stop() ran inside _shutdown(); the server and
                # every transport are already closed there
                loop.close()

        self._loop_thread = threading.Thread(
            target=loop_main, name="gateway-loop", daemon=True
        )
        self._loop_thread.start()
        ready.wait()
        if boot_err:
            self._started = False
            raise boot_err[0]
        self._driver_thread = threading.Thread(
            target=self._drive, name="gateway-driver", daemon=True
        )
        self._driver_thread.start()
        logger.info(
            "gateway listening on %s:%d (engine %s)",
            self.host, self.port, self.engine.telemetry_label,
        )
        return self

    def stop(self) -> None:
        """Sever everything: stop the driver, close the listener and
        EVERY live connection (SSE streams included), stop the loop,
        join both threads, release the port. Idempotent — and runs
        its full teardown even when the driver already crashed (the
        crash path only flags ``_stopping``; this is the half that
        actually releases the port)."""
        if not self._started:
            return
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._stopping.set()
        self._work.set()  # wake the driver so it can observe stopping
        dt = self._driver_thread
        if dt is not None and dt is not threading.current_thread():
            dt.join(timeout=30)
        loop = self._loop
        if loop is not None and not loop.is_closed():
            done = threading.Event()
            loop.call_soon_threadsafe(
                lambda: loop.create_task(self._shutdown(done))
            )
            done.wait(timeout=30)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=30)
        logger.info("gateway on port %s stopped", self.port)

    async def _shutdown(self, done: threading.Event) -> None:
        loop = asyncio.get_running_loop()
        try:
            if self._server is not None:
                self._server.close()  # no new connections from here
            # sever live SSE connections: a handler mid-stream must not
            # outlive the gateway (nor a zombie keep-alive hold the port)
            for w in list(self._writers):
                try:
                    w.close()
                except OSError:
                    pass  # fault-lint: allow — already-dead transport
            for t in list(self._tasks):
                t.cancel()
            if self._tasks:
                await asyncio.gather(
                    *list(self._tasks), return_exceptions=True
                )
            if self._server is not None:
                # only after the sever: Server.wait_closed() waits for
                # every live connection to close (Python 3.12), so
                # awaiting it first would wait out each client's own
                # timeout
                await self._server.wait_closed()
        finally:
            done.set()
            loop.stop()

    def release_telemetry(self) -> None:
        """Retire this gateway's labeled series, and those of the watchdog
        it built (explicit-only, same contract as the engine's)."""
        telemetry.remove_series(gateway=self.telemetry_label)
        if self._own_watchdog and self.watchdog is not None:
            self.watchdog.release_telemetry()

    def __enter__(self) -> "Gateway":
        return self.start() if not self._started else self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- engine driver --------------------------------------------------

    def _drive(self) -> None:
        """Step the engine whenever the scheduler has work; park on an
        event otherwise (a submit sets it), on the engine's device for the
        thread's whole life. Any engine error (a CUDA error included) severs
        the gateway LOUDLY — serving garbage quietly, or carrying on
        anywhere else, is the one thing a front door must never do."""
        dev = self.engine.device
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                while not self._stopping.is_set():
                    self.engine.lock.yield_to_waiters()
                    with self.engine.lock:
                        has_work = self.engine.scheduler.has_work
                        if has_work:
                            self.engine.step()
                    if not has_work:
                        self._work.wait(timeout=0.05)
                        self._work.clear()
        except Exception as e:
            logger.exception(
                "gateway driver died mid-step — severing the gateway "
                "(in-flight streams will close)"
            )
            self.driver_error = e
            # no new work from here: /healthz answers 503 driver-dead
            # until the teardown below closes the port
            self._stopping.set()
            # run the REAL teardown, not just the flag: in-flight
            # handlers are parked on queues no tokens will ever reach
            # again, and the port must come back. stop() skips joining
            # the current (driver) thread.
            self.stop()

    # -- request handling (loop thread) ---------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        self._writers.add(writer)
        conn = _Conn()
        try:
            # keep-alive request loop: one
            # connection may carry many requests; the first read sits
            # under the full read deadline, subsequent ones under the
            # bounded IDLE timeout (an open-but-silent keep-alive
            # socket must not pin a handler task forever)
            while await self._serve_one(reader, writer, conn):
                conn.served += 1
        except (ConnectionError, OSError) as e:
            logger.info("gateway connection dropped (%r)", e)
        except asyncio.CancelledError:
            # stop() severing us — close fast, propagate nothing
            pass  # fault-lint: allow — deliberate sever on stop()
        except Exception:
            logger.exception("gateway handler failed")
        finally:
            self._writers.discard(writer)
            self._tasks.discard(task)
            try:
                writer.close()
            except OSError:
                pass  # fault-lint: allow — already-severed transport

    async def _serve_one(self, reader, writer, conn: _Conn) -> bool:
        """Read and answer ONE request off the connection. Returns
        True when the connection persists for another request (client
        asked for keep-alive, the response could honor it, and the
        gateway is not stopping)."""
        route, code = "other", None
        first = conn.served == 0
        try:
            try:
                if first:
                    # ONE deadline over the whole request read: the
                    # per-line timeouts inside cannot bound a client
                    # that dribbles a header every few seconds forever
                    (method, path, body, headers,
                     version) = await asyncio.wait_for(
                        self._read_request(reader), self.read_timeout
                    )
                else:
                    # the idle timeout governs only the WAIT for the
                    # next request LINE; once bytes arrive the full
                    # read deadline takes over (a large migrate body
                    # on a reused connection must not race the short
                    # idle clock)
                    try:
                        line = await asyncio.wait_for(
                            reader.readline(),
                            min(self.read_timeout,
                                self.keepalive_idle_timeout),
                        )
                        # RFC 7230 §3.5: ignore blank line(s) before
                        # the next request line (bounded — a blank
                        # flood must not pin the handler)
                        skipped = 0
                        while line in (b"\r\n", b"\n") and skipped < 4:
                            skipped += 1
                            line = await asyncio.wait_for(
                                reader.readline(),
                                min(self.read_timeout,
                                    self.keepalive_idle_timeout),
                            )
                    except asyncio.TimeoutError:
                        return False  # idle expiry: just close
                    if not line or line in (b"\r\n", b"\n"):
                        return False  # clean close between requests
                    # this request rode an already-open connection —
                    # the handshake it did not pay
                    self._m_conn_reused.inc()
                    (method, path, body, headers,
                     version) = await asyncio.wait_for(
                        self._read_request(reader, first_line=line),
                        self.read_timeout,
                    )
            except _ConnectionClosed:
                if first:
                    code = 400
                    await self._write(writer, _json_response(
                        400, {"error": "empty request"}
                    ))
                return False
            except _HttpError as e:
                # a read-side refusal (malformed line, oversized or
                # chunked body) still gets its response — and always
                # closes: the connection's framing cannot be trusted
                # past a failed read
                code = e.code
                await self._write(writer, _json_response(
                    e.code, {"error": str(e)}, e.extra_headers
                ))
                return False
            except asyncio.TimeoutError:
                code = 408
                await self._write(writer, _json_response(
                    408, {"error": "request read timed out"}
                ))
                return False
            try:
                conn_hdr = headers.get("connection", "").lower()
                conn.persist = (
                    self.keepalive_idle_timeout > 0
                    and "close" not in conn_hdr
                    and (version == "HTTP/1.1"
                         or "keep-alive" in conn_hdr)
                    and not self._stopping.is_set()
                )
                route = self._route_label(method, path)
                # gateway label + (for /v1/generate, set below) the
                # engine-minted rid ride the span args: the trace-merge
                # tool keys the request's trace id off the
                # rid, so the gateway half of the story joins the
                # engine half under ONE id on the merged timeline
                with self._tracer.span(
                    "gateway.request", route=route,
                    gateway=self.telemetry_label,
                ) as span:
                    code = await self._route(
                        method, path, body, headers, writer, span,
                        conn,
                    )
            except _HttpError as e:
                code = e.code
                await self._write(writer, _json_response(
                    e.code, {"error": str(e)}, e.extra_headers,
                    close=conn.close_header(),
                ))
            except Exception:
                # an unexpected handler failure must still land in the
                # request metric as a 500 before _handle logs it and
                # severs the connection — a fleet watching the 5xx
                # rate cannot be blind to crashing handlers
                code = 500
                raise
        finally:
            if code is not None:
                self._m_requests.labels(
                    gateway=self.telemetry_label, route=route,
                    code=str(code),
                ).inc()
        return conn.persist

    _TRACE_PATH = re.compile(r"^/v1/requests/(\d+)/trace$")
    _CANCEL_PATH = re.compile(r"^/v1/requests/(\d+)/cancel$")
    _EXPORT_PATH = re.compile(r"^/v1/requests/(\d+)/export$")

    @classmethod
    def _route_label(cls, method: str, path: str) -> str:
        """Metric label for the route — KNOWN (method, path) pairs
        only, everything else collapses to "other": no part of the
        label value may be client-controlled, or a scanner walking
        paths (or inventing METHOD tokens on real paths) mints
        unbounded registry series. The per-request trace route
        collapses its rid into the ``:rid`` template for the same
        reason."""
        bare = path.split("?", 1)[0]
        if method == "GET" and cls._TRACE_PATH.match(bare):
            return "GET /v1/requests/:rid/trace"
        if method == "POST" and cls._CANCEL_PATH.match(bare):
            return "POST /v1/requests/:rid/cancel"
        if method == "POST" and cls._EXPORT_PATH.match(bare):
            return "POST /v1/requests/:rid/export"
        route = f"{method} {bare}"
        if route in (
            "POST /v1/generate", "POST /v1/score", "GET /metrics",
            "GET /stats", "GET /healthz", "GET /debug/engine",
            "POST /v1/migrate",
        ):
            return route
        return "other"

    async def _read_request(self, reader, first_line=None):
        # no per-read deadlines here: the caller wraps this WHOLE
        # coroutine in one wait_for(read_timeout), which is the bound
        # that actually governs (per-line timeouts could never cut a
        # client dribbling one header per interval loose).
        # ``first_line`` — a request line the keep-alive loop already
        # read under the idle timeout.
        line = first_line
        if line is None:
            line = await reader.readline()
        if not line:
            raise _ConnectionClosed()
        try:
            method, path, version = line.decode("ascii").split()
        except ValueError:
            raise _HttpError(400, f"malformed request line {line!r}")
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= 128:
                raise _HttpError(400, "too many headers")
            if b":" in h:
                k, v = h.split(b":", 1)
                headers[k.strip().lower().decode("ascii")] = (
                    v.strip().decode("latin-1")
                )
        body = b""
        if "transfer-encoding" in headers:
            # bodies arrive via Content-Length ONLY. Silently reading
            # a 0-byte body under keep-alive would leave the chunked
            # payload buffered on the socket and parse it as the NEXT
            # request line — attacker-controlled request smuggling
            # behind any validating front proxy. Refuse, and the
            # caller closes (framing past this point is untrusted).
            raise _HttpError(
                501, "Transfer-Encoding is not supported — send a "
                     "Content-Length body"
            )
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise _HttpError(400, "bad Content-Length")
        limit = (
            self.max_migrate_body
            if path.split("?", 1)[0] == "/v1/migrate"
            else self.max_body
        )
        if n > limit:
            raise _HttpError(
                413, f"body of {n} bytes exceeds {limit}"
            )
        if n:
            # consume the declared body for EVERY method: a GET with
            # a Content-Length body left unread would desync the
            # keep-alive framing — the body bytes would parse as the
            # next request line (same smuggling class as the
            # Transfer-Encoding refusal above)
            body = await reader.readexactly(n)
        return method, path, body, headers, version

    async def _write(self, writer, data: bytes) -> None:
        # drain after every write — a slow
        # consumer backpressures the handler, never silently truncates
        writer.write(data)
        await writer.drain()

    async def _route(self, method, path, body, headers, writer,
                     span=None, conn=None) -> int:
        if conn is None:
            conn = _Conn()
        path = path.split("?", 1)[0]
        if path == "/v1/generate":
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._generate(body, writer, span, conn)
        if path == "/metrics":
            if method != "GET":
                raise _HttpError(405, "GET only")
            # content negotiation: an OpenMetrics-aware
            # scraper gets histogram exemplars (rid-stamped TTFT/ITL
            # observations); the 0.0.4 default stays exemplar-free
            # because its parsers reject a '#' after the value
            if _wants_openmetrics(headers.get("accept", "")):
                text = telemetry.render_openmetrics().encode("utf-8")
                ctype = telemetry.CONTENT_TYPE_OPENMETRICS
            else:
                text = telemetry.render().encode("utf-8")
                ctype = telemetry.CONTENT_TYPE
            await self._write(writer, _response(
                200, text, ctype, close=conn.close_header()
            ))
            return 200
        if path == "/stats":
            if method != "GET":
                raise _HttpError(405, "GET only")
            return await self._json_snapshot(
                writer, lambda: self.engine.stats(), conn
            )
        if path == "/healthz":
            if method != "GET":
                raise _HttpError(405, "GET only")
            return await self._healthz(writer, conn)
        if path == "/debug/engine":
            if method != "GET":
                raise _HttpError(405, "GET only")
            return await self._json_snapshot(
                writer, lambda: self.engine.debug_snapshot(), conn
            )
        m = self._TRACE_PATH.match(path)
        if m is not None:
            if method != "GET":
                raise _HttpError(405, "GET only")
            return await self._request_trace(
                int(m.group(1)), writer, conn
            )
        m = self._CANCEL_PATH.match(path)
        if m is not None:
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._cancel(int(m.group(1)), writer, conn)
        m = self._EXPORT_PATH.match(path)
        if m is not None:
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._export(int(m.group(1)), writer, conn)
        if path == "/v1/migrate":
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._migrate(body, writer, conn)
        if path == "/v1/score":
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._score(body, writer, conn)
        raise _HttpError(404, f"no route {path}")

    async def _score(self, body: bytes, writer, conn) -> int:
        """``POST /v1/score`` — log-probabilities of a given completion
        under the served model in ONE forward pass: body is
        ``{"prompt": [tokens], "completion": [tokens]}``, response
        carries per-token logprobs, their sum, the greedy (argmax)
        token at each position, and the completion-vs-greedy agreement
        fraction. This is the quality oracle the quant bench gates
        consume: score the same completion on an fp and a quantized
        engine and compare. Scoring never perturbs in-flight serving
        state (the engine forward is discard-after-read), but it DOES
        take the engine lock for its forward, like any submit."""
        try:
            spec = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _HttpError(400, f"bad JSON body: {e}")
        if not isinstance(spec, dict):
            raise _HttpError(400, "body must be a JSON object")
        unknown = set(spec) - {"prompt", "completion"}
        if unknown:
            raise _HttpError(400, f"unknown fields {sorted(unknown)}")
        for key in ("prompt", "completion"):
            if not isinstance(spec.get(key), list):
                raise _HttpError(
                    400, f"{key} must be a list of token ids"
                )
        loop = asyncio.get_running_loop()

        def do_score():
            with self.engine.lock:
                if self._stopping.is_set():
                    raise _HttpError(503, "gateway is stopping")
                return self.engine.score(
                    spec["prompt"], spec["completion"]
                )

        try:
            result = await loop.run_in_executor(None, do_score)
        except (ValueError, TypeError) as e:
            raise _HttpError(400, str(e))
        await self._write(writer, _json_response(
            200, result, close=conn.close_header(),
        ))
        return 200

    async def _cancel(self, rid: int, writer, conn) -> int:
        """``POST /v1/requests/{rid}/cancel`` — abort one in-flight
        request and reclaim its slot/blocks. 404 when the
        rid is unknown or already finished (nothing to reclaim)."""
        loop = asyncio.get_running_loop()

        def do_cancel():
            with self.engine.lock:
                return self.engine.cancel(rid)

        if not await loop.run_in_executor(None, do_cancel):
            raise _HttpError(
                404, f"request {rid} is not in flight on this engine"
            )
        await self._write(writer, _json_response(
            200, {"rid": rid, "cancelled": True},
            extra_headers=(("X-Request-Id", str(rid)),),
            close=conn.close_header(),
        ))
        return 200

    async def _export(self, rid: int, writer, conn) -> int:
        """``POST /v1/requests/{rid}/export`` — freeze one live
        request and return its migration record as the v1 binary wire
        format: the request LEAVES this engine; POST the
        bytes to another replica's ``/v1/migrate`` to resume it
        there. 404 for a rid that is not live here, 409 when the
        request cannot be exported (fixed-arena warm export)."""
        from elephas_tpu_torch.fleet.migration import encode_record

        loop = asyncio.get_running_loop()

        def do_export():
            with self.engine.lock:
                # notify_stream: the request leaves THIS engine for
                # good over the wire — a local SSE/JSON handler
                # blocking on its token stream must end, not hang
                record = self.engine.export_request(
                    rid, notify_stream=True
                )
            # the encode is pure host work over an already-detached
            # record — serializing potentially hundreds of MB of K/V
            # rows must not stall the decode driver behind the lock
            return encode_record(record)

        try:
            payload = await loop.run_in_executor(None, do_export)
        except KeyError as e:
            raise _HttpError(404, str(e).strip("'\""))
        except ValueError as e:
            raise _HttpError(409, str(e))
        await self._write(writer, _response(
            200, payload, "application/octet-stream",
            extra_headers=(("X-Request-Id", str(rid)),),
            close=conn.close_header(),
        ))
        return 200

    async def _migrate(self, body: bytes, writer, conn) -> int:
        """``POST /v1/migrate`` — adopt a migration record exported by
        another replica (the drain/rebalance wire). The body
        is the v1 binary record; the response confirms the adopted rid
        and whether the K/V resumed warm. No token stream re-attaches
        over this route (callbacks never travel) — the in-process
        fleet router re-wires streams itself; a wire-migrated request
        accumulates tokens readable via its trace/stats surfaces.

        Passthrough validation: the record's ``weight_ver``
        rides the decoded header into ``import_request``, whose
        generation-mismatch refusal surfaces here as 409 — a warm
        record from another weight generation must never resume as
        silent garbage over the wire either."""
        from elephas_tpu_torch.fleet.migration import decode_record

        loop = asyncio.get_running_loop()

        def do_import():
            record = decode_record(body)
            with self.engine.lock:
                req = self.engine.import_request(record)
                return req.rid, int(record.get("n_blocks") or 0) > 0

        try:
            rid, warm = await loop.run_in_executor(None, do_import)
        except ValueError as e:
            raise _HttpError(409, str(e))
        self._work.set()  # wake the driver: the adoptee needs steps
        await self._write(writer, _json_response(
            200, {"rid": rid, "warm": warm},
            extra_headers=(("X-Request-Id", str(rid)),),
            close=conn.close_header(),
        ))
        return 200

    async def _json_snapshot(self, writer, fn, conn) -> int:
        """Serve ``fn()`` (engine introspection under the engine lock)
        as one JSON document, computed off-loop: the lock may be held
        by a long engine step and must not freeze the event loop."""
        loop = asyncio.get_running_loop()

        def snapshot():
            with self.engine.lock:
                return json.dumps(
                    fn(), default=float
                ).encode("utf-8") + b"\n"

        body = await loop.run_in_executor(None, snapshot)
        await self._write(writer, _response(
            200, body, "application/json",
            close=conn.close_header(),
        ))
        return 200

    async def _request_trace(self, rid: int, writer, conn) -> int:
        """``GET /v1/requests/{rid}/trace`` — the engine's flight-
        recorder record for one request. 404 for an
        unknown/evicted rid, 501 when the recorder is off (retrying
        cannot help; the engine must be rebuilt with
        ``flight_recorder=N``)."""
        loop = asyncio.get_running_loop()

        def lookup():
            with self.engine.lock:
                return self.engine.explain(rid)

        try:
            record = await loop.run_in_executor(None, lookup)
        except KeyError as e:
            raise _HttpError(404, str(e).strip("'\""))
        except RuntimeError as e:
            raise _HttpError(501, str(e))
        await self._write(writer, _json_response(
            200, record,
            extra_headers=(("X-Request-Id", str(rid)),),
            close=conn.close_header(),
        ))
        return 200

    async def _healthz(self, writer, conn) -> int:
        """Cheap liveness for the fleet router:
        200 when the engine driver thread is alive, the gateway is not
        stopping, and — when there is work — steps are advancing;
        answering at all proves the event loop responsive. Reads a
        couple of ints without the engine lock (GIL-atomic loads): a
        health probe must never queue behind a long step."""
        driver = self._driver_thread
        alive = (
            driver is not None and driver.is_alive()
            and not self._stopping.is_set()
        )
        sched = self.engine.scheduler
        steps = sched._steps
        has_work = sched.has_work
        now = time.monotonic()
        anchor = self._hz_anchor
        if not has_work or anchor is None or anchor[0] != steps:
            self._hz_anchor = anchor = (steps, now)
        stalled = (
            has_work and now - anchor[1] > self.health_stall_grace
        )
        status = (
            "driver-dead" if not alive
            else "stalled" if stalled else "ok"
        )
        body = {
            "status": status,
            "steps": steps,
            "queue_has_work": has_work,
            "driver_alive": alive,
            # the weight generation this replica serves — a
            # GIL-atomic int read, so a mixed-version fleet is visible
            # from health probes alone (report-only, never flips the
            # verdict: an old generation is stale, not dead)
            "weight_version": self.engine.weight_version,
            # the reference's backend-probe report: the port has no
            # fallback, so the key stays for the wire shape, always null
            "backend_fallback": None,
        }
        if self.watchdog is not None:
            # anomaly detail: evaluated HERE, at probe
            # cadence. Report-only — anomalies never flip the 200/503
            # verdict (that would let telemetry drive routing; the
            # stall/driver checks above are the liveness authority) —
            # but the router gets the why alongside the what.
            # Off-loop like every other registry walk: evaluation
            # reads pull-time callback gauges whose cost grows with
            # tenants/series, and a probe must never stall in-flight
            # SSE streams (the handler's own never-block design).
            loop = asyncio.get_running_loop()

            def evaluate():
                self.watchdog.evaluate()
                return self.watchdog.report()

            report = await loop.run_in_executor(None, evaluate)
            body["anomalies"] = {
                "critical": report["critical"],
                "warn": report["warn"],
                "active": report["active"],
            }
        await self._write(writer, _json_response(
            200 if status == "ok" else 503, body,
            close=conn.close_header(),
        ))
        return 200 if status == "ok" else 503

    def _parse_generate(self, body: bytes) -> dict:
        try:
            spec = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _HttpError(400, f"bad JSON body: {e}")
        if not isinstance(spec, dict):
            raise _HttpError(400, "body must be a JSON object")
        unknown = set(spec) - {
            "prompt", "prompts", "max_new_tokens", "temperature",
            "eos_id", "tenant", "ttft_deadline_ms", "priority",
            "stream",
        }
        if unknown:
            raise _HttpError(400, f"unknown fields {sorted(unknown)}")
        if ("prompt" in spec) == ("prompts" in spec):
            raise _HttpError(
                400, "exactly one of prompt / prompts is required"
            )
        if "max_new_tokens" not in spec:
            raise _HttpError(
                400, "prompt and max_new_tokens are required"
            )
        if "prompts" in spec:
            prompts = spec["prompts"]
            if not isinstance(prompts, list) or not prompts or not all(
                isinstance(p, list) for p in prompts
            ):
                raise _HttpError(
                    400, "prompts must be a non-empty list of "
                         "token lists"
                )
            if len(prompts) > self.max_batch_prompts:
                raise _HttpError(
                    413,
                    f"{len(prompts)} prompts exceed the batch bound "
                    f"{self.max_batch_prompts} — split the POST",
                )
        return spec

    def _submit_kwargs(self, spec) -> dict:
        return dict(
            temperature=float(spec.get("temperature", 0.0)),
            eos_id=spec.get("eos_id"),
            tenant=spec.get("tenant"),
            ttft_deadline_ms=spec.get("ttft_deadline_ms"),
            priority=int(spec.get("priority", 0)),
        )

    async def _generate(self, body, writer, span=None,
                        conn=None) -> int:
        if conn is None:
            conn = _Conn()
        spec = self._parse_generate(body)
        if "prompts" in spec:
            return await self._generate_batch(spec, writer, span, conn)
        stream = bool(spec.pop("stream", True))
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(token, done):
            # token None is the stream-END sentinel (cancelled /
            # migrated away without a final token) — forward it, the
            # consumer loops end without appending
            loop.call_soon_threadsafe(
                q.put_nowait,
                (None if token is None else int(token), bool(done)),
            )

        def do_submit():
            # off-loop: the engine lock may be held by a long step()
            # — waiting for it must block
            # THIS request only, not the whole event loop
            with self.engine.lock:
                if self._stopping.is_set():
                    raise _HttpError(503, "gateway is stopping")
                return self.engine.submit(
                    spec["prompt"], spec["max_new_tokens"],
                    on_token=on_token, **self._submit_kwargs(spec),
                )

        try:
            req = await loop.run_in_executor(None, do_submit)
        except (ValueError, TypeError) as e:
            raise _HttpError(400, str(e))
        if span is not None:
            # the request's trace identity on the gateway span — rid
            # is minted by the engine, so it only exists post-submit
            span.set(rid=req.rid)
        if req.error is not None:
            # rejected at submit — backpressure on the wire. The rid
            # still echoes: the rejection has a flight
            # record too, and the client can fetch its trace.
            rid_hdr = ("X-Request-Id", str(req.rid))
            if isinstance(req.error, AdmissionRejected):
                raise _HttpError(
                    429, str(req.error),
                    extra_headers=(
                        ("Retry-After",
                         str(max(1, round(req.error.retry_after_s)))),
                        rid_hdr,
                    ),
                )
            raise _HttpError(422, str(req.error), extra_headers=(rid_hdr,))
        self._work.set()  # wake the driver
        if stream:
            conn.persist = False  # the SSE stream owns this socket
            return await self._stream_sse(req, q, writer)
        return await self._respond_once(req, q, writer, conn)

    async def _generate_batch(self, spec, writer, span, conn) -> int:
        """The ``prompts`` batch form: one POST carries N prompts, amortizing the handshake
        and request parse. Each prompt is a NORMAL ``submit()`` —
        admission control, policy accounting, and the paged never-fit
        rejection see them individually, so one shed prompt comes
        back as ITS entry's error while the rest serve.

        ``stream: false`` answers one JSON document with a
        ``results`` array (index-aligned with ``prompts``);
        ``stream: true`` multiplexes every request onto ONE SSE
        stream: an opening ``data: {"rids": [...]}`` event, then
        ``data: {"rid": r, "token": t, "done": d}`` per token in
        arrival order, then an ``event: done`` summary."""
        prompts = spec.pop("prompts")
        stream = bool(spec.pop("stream", True))
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        try:
            # batch-WIDE fields (shared by every prompt) fail the
            # whole request as a clean 400, exactly like the
            # single-prompt form's do_submit mapping — an uncaught
            # float("hot") here would sever the connection with no
            # response at all
            kwargs = self._submit_kwargs(spec)
        except (ValueError, TypeError) as e:
            raise _HttpError(400, str(e))
        max_new = spec["max_new_tokens"]

        def make_cb(i):
            def on_token(token, done):
                loop.call_soon_threadsafe(
                    q.put_nowait,
                    (i, None if token is None else int(token),
                     bool(done)),
                )

            return on_token

        def do_submit():
            out = []
            with self.engine.lock:
                if self._stopping.is_set():
                    raise _HttpError(503, "gateway is stopping")
                for i, p in enumerate(prompts):
                    try:
                        r = self.engine.submit(
                            p, max_new, on_token=make_cb(i), **kwargs
                        )
                    except (ValueError, TypeError) as e:
                        out.append((e, True))
                    else:
                        # classify HERE, under the engine lock: done
                        # at this instant can only mean a submit-time
                        # reject (shed / never-fit — it never feeds
                        # its queue). Snapshotting done AFTER the lock
                        # releases raced the driver thread: a 1-token
                        # request it finished in between looked like a
                        # reject and its queued tokens were never
                        # drained.
                        out.append((r, r.done))
            return out

        submitted = await loop.run_in_executor(None, do_submit)
        if span is not None:
            span.set(batch=len(prompts))
        entries = []
        pending: set[int] = set()
        for i, (r, rejected) in enumerate(submitted):
            if isinstance(r, BaseException):
                entries.append({
                    "index": i, "rid": None, "tokens": [],
                    "error": str(r),
                })
            else:
                entries.append({
                    "index": i, "rid": r.rid, "tokens": [],
                    "error": (
                        None if r.error is None else str(r.error)
                    ),
                })
                if not rejected:
                    pending.add(i)
        submitted = [r for r, _rejected in submitted]
        self._work.set()
        if stream:
            conn.persist = False
            return await self._stream_batch_sse(
                entries, pending, submitted, q, writer
            )
        while pending:
            i, token, done = await q.get()
            if token is not None:
                entries[i]["tokens"].append(token)
            if done:
                pending.discard(i)
                r = submitted[i]
                entries[i]["error"] = (
                    None if r.error is None else str(r.error)
                )
        for i, r in enumerate(submitted):
            if not isinstance(r, BaseException):
                entries[i]["full_sequence"] = (
                    list(r.prompt) + list(r.tokens)
                )
        await self._write(writer, _json_response(
            200, {"results": entries}, close=conn.close_header(),
        ))
        return 200

    async def _stream_batch_sse(self, entries, pending, submitted, q,
                                writer) -> int:
        head = (
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        self._m_sse_active.inc()
        try:
            await self._write(writer, head)
            await self._write(writer, _sse_event({
                "rids": [e["rid"] for e in entries],
                "errors": {
                    str(e["index"]): e["error"]
                    for e in entries if e["error"] is not None
                },
            }))
            while pending:
                i, token, done = await q.get()
                rid = entries[i]["rid"]
                if token is not None:
                    await self._write(writer, _sse_event(
                        {"rid": rid, "token": token, "done": done}
                    ))
                if done:
                    pending.discard(i)
            final = {
                "rids": [e["rid"] for e in entries],
                "n_tokens": {
                    str(e["rid"]): len(submitted[e["index"]].tokens)
                    for e in entries if e["rid"] is not None
                },
                "errors": {
                    str(e["rid"]):
                        None if submitted[e["index"]].error is None
                        else str(submitted[e["index"]].error)
                    for e in entries if e["rid"] is not None
                },
            }
            await self._write(writer, _sse_event(final, event="done"))
        except (ConnectionError, OSError) as e:
            # client went away mid-stream: cancel every still-live
            # request of the batch (the single-stream disconnect rule,
            # batch-wide)
            logger.info(
                "batch SSE client disconnected mid-stream (%r) — "
                "cancelling %d live requests", e, len(pending),
            )
            if not self._stopping.is_set() and pending:
                loop = asyncio.get_running_loop()
                rids = [
                    entries[i]["rid"] for i in pending
                    if entries[i]["rid"] is not None
                ]

                def do_cancel():
                    with self.engine.lock:
                        for rid in rids:
                            self.engine.cancel(rid)

                await loop.run_in_executor(None, do_cancel)
        finally:
            self._m_sse_active.dec()
        return 200

    async def _drain_tokens(self, req, q) -> list:
        tokens = []
        while True:
            token, done = await q.get()
            if token is not None:
                tokens.append(token)
            if done:
                return tokens

    async def _respond_once(self, req, q, writer, conn=None) -> int:
        tokens = await self._drain_tokens(req, q)
        payload = {
            "rid": req.rid,
            "tokens": tokens,
            "full_sequence": list(req.prompt) + list(req.tokens),
            "error": None if req.error is None else str(req.error),
        }
        await self._write(writer, _json_response(
            200, payload,
            extra_headers=(("X-Request-Id", str(req.rid)),),
            close=True if conn is None else conn.close_header(),
        ))
        return 200

    async def _stream_sse(self, req, q, writer) -> int:
        # trace-context echo on the wire: the engine-minted
        # rid rides a header (greppable by proxies) AND the opening
        # data event (greppable by SSE consumers)
        head = (
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"X-Request-Id: " + str(req.rid).encode("ascii") + b"\r\n"
            b"Connection: close\r\n\r\n"
        )
        self._m_sse_active.inc()
        try:
            await self._write(writer, head)
            await self._write(writer, _sse_event({"rid": req.rid}))
            while True:
                token, done = await q.get()
                if token is not None:
                    await self._write(
                        writer,
                        _sse_event({"token": token, "done": done}),
                    )
                if done:
                    break
            final = {
                "rid": req.rid,
                "n_tokens": len(req.tokens),
                "error": None if req.error is None else str(req.error),
            }
            await self._write(writer, _sse_event(final, event="done"))
        except (ConnectionError, OSError) as e:
            # client went away mid-stream: CANCEL the request so its
            # slot/blocks reclaim now. Off-loop like
            # every engine call; skipped during stop(), whose sever
            # path also lands here — teardown must not queue cancels
            # behind a lock the driver is about to release for good.
            logger.info(
                "SSE client for request %d disconnected mid-stream "
                "(%r) — cancelling", req.rid, e,
            )
            if not self._stopping.is_set():
                loop = asyncio.get_running_loop()

                def do_cancel():
                    with self.engine.lock:
                        return self.engine.cancel(req.rid)

                await loop.run_in_executor(None, do_cancel)
        finally:
            self._m_sse_active.dec()
        return 200


def _wants_openmetrics(accept: str) -> bool:
    """Does this ``Accept`` header prefer the OpenMetrics exposition?
    Media types compare case-insensitively (RFC 9110) and q-values are
    honored, so ``application/openmetrics-text;q=0.1, text/plain``
    stays on 0.0.4 while ``Application/OpenMetrics-Text`` gets
    exemplars — a substring test got both wrong."""

    def _q(params) -> float:
        for p in params:
            k, _, v = p.partition("=")
            if k.strip() == "q":
                try:
                    return float(v.strip())
                except ValueError:
                    return 0.0
        return 1.0

    om_q, plain_q = 0.0, 0.0
    for media_range in accept.lower().split(","):
        mtype, *params = media_range.split(";")
        mtype = mtype.strip()
        q = _q(params)
        if mtype == "application/openmetrics-text":
            om_q = max(om_q, q)
        elif mtype in ("text/plain", "text/*", "*/*"):
            plain_q = max(plain_q, q)
    return om_q > 0.0 and om_q >= plain_q


def _sse_event(obj, event: str | None = None) -> bytes:
    prefix = f"event: {event}\n" if event else ""
    return (prefix + "data: " + json.dumps(obj) + "\n\n").encode("utf-8")
