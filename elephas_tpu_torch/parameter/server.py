"""Parameter servers: HTTP and raw-socket weight stores.

Reference surface: ``[U] elephas/parameter/server.py`` — ``HttpServer``
(Flask app in a daemon thread; ``GET /parameters`` → pickled weights,
``POST /update`` → apply delta, with a ``threading.Lock`` iff
mode='asynchronous' and lock-free for 'hogwild' — that lock is the entire
difference between the modes) and ``SocketServer`` (TCP op-code protocol).

Rebuilt on the stdlib (`http.server`, `socketserver`) — Flask is not a
dependency. The hot path is the **binary codec**
(:mod:`elephas_tpu_torch.parameter.codec` — versioned frames, dtype-preserving,
optional int8 get) streamed chunk-by-chunk, so peak transient memory
stays bounded at one chunk. The pickled endpoints/op-codes remain as the
negotiated legacy fallback; do not expose these ports to untrusted
networks.

Fault tolerance: both servers are **journaled and
restartable** — ``journal_dir`` snapshots weights + the per-client
sequence table atomically every ``journal_every`` applied updates (and
on ``stop()``), and a server constructed over an existing journal
replays it, so a crashed PS restarts where it left off. Updates carry
**client-assigned monotonic sequence IDs** (op ``b'S'`` / the
``X-Elephas-Seq`` header): an update whose ``(client, seq)`` was
already applied is skipped, which makes the clients' at-least-once
retries effectively-once. Workers **register and heartbeat** on their
existing keep-alive connections (op ``b'H'`` / ``POST /heartbeat``);
the ``b's'`` op / ``GET /status`` expose membership, staleness, and
update/duplicate counters as JSON.

Sequenced updates dedup-then-apply under the sequence lock even in
hogwild mode — exactly-once beats the lock-free race for updates that
ask for it; the legacy unsequenced ops keep hogwild's documented
torn-apply behavior.

Socket op-codes: ``b'?'`` capability probe (reply: protocol version
byte), ``b'G'`` binary get (+1 request byte: 0 dense / 1 int8),
``b'U'`` binary update (frames in, ``b'k'`` ack out), ``b'S'``
sequenced binary update (u16 id-length + client id + u64 seq + frames
in; ``b'k'`` applied / ``b'd'`` duplicate-skipped out), ``b'H'``
heartbeat (u16 id-length + client id; ``b'k'`` out), ``b's'`` status
(u32 length + JSON out), ``b'T'`` trace context (protocol 3:
u16 length + trace-id bytes, no reply — sets the connection's
current trace id; empty clears it), and the legacy ``b'g'`` /
``b'u'`` / ``b'q'`` pickle trio.

HTTP: ``GET /parameters.bin[?comp=int8]`` streams codec frames with
chunked transfer-encoding; ``POST /update.bin`` carries codec frames in
the body (optional ``X-Elephas-Client`` + ``X-Elephas-Seq`` headers
enable idempotent apply; the reply's ``X-Elephas-Applied`` is ``0`` for
a duplicate); ``POST /heartbeat`` refreshes the client's lease;
``GET /status`` returns the status JSON; legacy ``/parameters`` /
``/update`` stay pickled. Responses are HTTP/1.1 so clients reuse one
connection across sync rounds.

Cross-process tracing: clients forward their active trace
context — the ``b'T'`` socket op, or an ``X-Elephas-Trace`` header on
the HTTP ops — and the server evaluates every op under that scope, so
the ``ps.apply`` span, the dedup decision, and any journal write the
apply triggers all land on this process's trace stream stamped with
the SAME trace id the worker-side push span carries. Guarded both
ways: a protocol-2 server never receives the op (clients gate on the
probed version), a legacy client never sends it, and an HTTP server
that predates the header simply ignores it — clean no-ops on every
legacy pairing.
"""

from __future__ import annotations

import json
import logging
import pickle
import socket
import socketserver
import struct
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.parameter import codec as wire
from elephas_tpu_torch.parameter import journal as journal_io
from elephas_tpu_torch.utils import sockets
from elephas_tpu_torch.utils.functional_utils import add_params

logger = logging.getLogger(__name__)

# version 2: sequenced updates (S), heartbeats (H), status (s)
# version 3: trace-context forwarding (T / X-Elephas-Trace)
PROTOCOL_VERSION = 3

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _weak_gauge_fn(obj, method):
    """A pull-time gauge callback that does not pin ``obj`` (servers
    come and go in one process; the registry must not keep dead ones —
    and their weight lists — alive). NaN once the server is gone."""
    ref = weakref.ref(obj)

    def call():
        server = ref()
        return float("nan") if server is None else method(server)

    return call


class BaseParameterServer:
    """Holds the mutable master weight list.

    ``mode='asynchronous'`` serializes updates under a lock;
    ``mode='hogwild'`` applies them lock-free (torn reads/writes are
    accepted, as in the reference). With ``journal_dir`` the server is
    restartable: state snapshots to disk every ``journal_every``
    applied updates and a new server over the same directory replays
    the snapshot (weights AND the sequence table, so post-restart
    resends still deduplicate).
    """

    def __init__(
        self,
        weights,
        mode: str = "asynchronous",
        port: int = 4000,
        journal_dir: str | None = None,
        journal_every: int = 50,
        lease_timeout: float = 30.0,
        restore_journal: bool = True,
        shard_id: int | None = None,
        num_shards: int | None = None,
        shard_signature: str | None = None,
    ):
        self.mode = mode
        self.port = port
        # shard identity: when this server holds one slice of
        # a sharded topology, it says so in status() so clients can
        # fail fast on cross-wired endpoints; None (the default) keeps
        # the single-server shape and legacy wires untouched
        if (shard_id is None) != (num_shards is None):
            raise ValueError(
                f"shard_id and num_shards come together, got shard_id="
                f"{shard_id!r} num_shards={num_shards!r}"
            )
        if shard_id is not None and not 0 <= shard_id < num_shards:
            raise ValueError(
                f"shard_id={shard_id} out of range for num_shards="
                f"{num_shards}"
            )
        if shard_signature is not None and shard_id is None:
            raise ValueError(
                "shard_signature needs a shard identity (shard_id/"
                "num_shards) to ride on"
            )
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shard_signature = shard_signature
        self.lock = threading.Lock()
        self.weights = [np.asarray(w) for w in weights]
        # monotonic weight generation: 0 = "unversioned"
        # (training deltas mutate in place without minting); the deploy
        # ledger stamps a new generation on each publication via
        # set_weights(weight_version=...) and the journal carries it so
        # a restore knows which generation it resumed
        self.weight_version = 0
        self._started = False
        self._dense_codec = wire.WireCodec()
        self._int8_codec = wire.WireCodec(compression="int8")

        # -- fault-tolerance state ---------------------------
        self.journal_dir = journal_dir
        self.journal_every = max(1, int(journal_every))
        self.lease_timeout = float(lease_timeout)
        self.seq_table: dict[str, int] = {}  # client id -> last applied seq
        self.leases: dict[str, float] = {}  # client id -> last heartbeat
        self.restored_from_journal = False
        self._seq_lock = threading.Lock()
        self._journal_lock = threading.Lock()
        # journal cadence runs on this PLAIN count, never the telemetry
        # counter below — under telemetry null mode metrics read 0, and
        # snapshot cadence is correctness, not reporting
        # (telemetry never drives control flow)
        self._applied_seen = 0
        self._last_journal_at = 0  # _applied_seen at the last snapshot
        self._created_at = time.monotonic()

        # -- telemetry: counters are the single store for the
        # reported values; `updates_applied` etc. read them back
        reg = telemetry.registry()
        self._telemetry_registry = reg
        sid = telemetry.instance_label()
        self.telemetry_label = sid
        self._tracer = telemetry.tracer()

        def _c(name, help_):
            return reg.counter(
                name, help_, labels=("server",)
            ).labels(server=sid)

        self._m_updates_applied = _c(
            "elephas_ps_updates_applied_total",
            "Weight deltas applied by the parameter server",
        )
        self._m_updates_duplicate = _c(
            "elephas_ps_updates_duplicate_total",
            "Sequenced updates skipped as already-applied duplicates",
        )
        self._m_journal_writes = _c(
            "elephas_ps_journal_writes_total",
            "Journal snapshots written (periodic + terminal)",
        )
        self._m_heartbeats = _c(
            "elephas_ps_heartbeats_total",
            "Worker lease refreshes received",
        )
        if shard_id is not None:
            # info-style gauge (value 1): joins this server instance's
            # existing per-`server` series to its shard identity, so a
            # scrape tells shards apart WITHOUT re-labeling the
            # counter families (the registry refuses label-schema
            # changes on an existing name — by design)
            reg.gauge(
                "elephas_ps_shard_info",
                "Shard identity of a parameter-server instance "
                "(value 1; join on the server label)",
                labels=("server", "shard", "num_shards"),
            ).labels(
                server=sid, shard=str(shard_id),
                num_shards=str(num_shards),
            ).set(1)
        # pull-time gauges: lag/staleness change with time, not events
        reg.gauge(
            "elephas_ps_weight_version",
            "Weight generation currently served (0 = unversioned)",
            labels=("server",),
        ).labels(server=sid).set_function(_weak_gauge_fn(
            self, lambda s: s.weight_version
        ))
        reg.gauge(
            "elephas_ps_journal_lag_updates",
            "Applied updates not yet covered by a journal snapshot",
            labels=("server",),
        ).labels(server=sid).set_function(_weak_gauge_fn(
            self, lambda s: s._applied_seen - s._last_journal_at
        ))
        reg.gauge(
            "elephas_ps_live_members",
            "Workers whose lease is within lease_timeout",
            labels=("server",),
        ).labels(server=sid).set_function(_weak_gauge_fn(
            self, lambda s: sum(
                1 for m in s.members().values() if m["live"]
            )
        ))
        reg.gauge(
            "elephas_ps_oldest_heartbeat_age_seconds",
            "Staleness of the least-recently-heard worker lease",
            labels=("server",),
        ).labels(server=sid).set_function(_weak_gauge_fn(
            self, lambda s: max(
                (m["age_s"] for m in s.members().values()), default=0.0
            )
        ))
        # live client connections: stdlib shutdown() only stops the
        # ACCEPT loop — established keep-alive connections would keep
        # being served by zombie handler threads after stop(), so a
        # "stopped" server would silently keep applying updates. Track
        # them so stop() severs them too.
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # stop() raises this FIRST: handlers refuse further ops, so no
        # zombie service rides the gap until the accept loop notices
        # (its poll interval is whole tenths of a second — long enough
        # for a fast client to slip many ops through otherwise)
        self._closing = False
        self._lease_lock = threading.Lock()
        # restore_journal=False serves a journaled store WITHOUT
        # replaying an existing journal (a fresh, non-resumed fit must
        # not silently continue from a previous run's state); the
        # journal is then overwritten as this run snapshots
        if journal_dir and restore_journal:
            self._restore_journal(journal_dir)

    def _restore_journal(self, journal_dir: str) -> None:
        state = journal_io.load_journal(journal_dir)
        if state is None:
            return
        restored, seq_table, meta = state
        if len(restored) != len(self.weights) or any(
            r.shape != w.shape or r.dtype != w.dtype
            for r, w in zip(restored, self.weights)
        ):
            raise ValueError(
                f"journal under {journal_dir} holds "
                f"{[(w.dtype.name, w.shape) for w in restored]} but the "
                f"server was constructed with "
                f"{[(w.dtype.name, w.shape) for w in self.weights]} — "
                f"refusing to mix states from different models"
            )
        self.weights = restored
        self.seq_table = seq_table
        # restore resumes the journaled generation — a restarted shard
        # must not re-serve generation N while claiming version 0, or
        # the deploy subscriber would re-apply N as if it were new
        self.weight_version = int(meta.get("weight_version", 0))
        self.restored_from_journal = True
        logger.info(
            "parameter server restored from journal %s (%d client "
            "sequence entries, snapshot meta %s)",
            journal_dir, len(seq_table), meta,
        )

    # -- telemetry views -------------------------------------
    # The registry counters are the only store; these read them back so
    # status(), /metrics, and the chaos harness can never drift apart.
    # Under null mode they read 0 — the chaos harness (which polls
    # `updates_applied` as its kill trigger) refuses to run there.

    @property
    def updates_applied(self) -> int:
        return int(self._m_updates_applied.value)

    @property
    def updates_duplicate(self) -> int:
        return int(self._m_updates_duplicate.value)

    @property
    def journal_writes(self) -> int:
        return int(self._m_journal_writes.value)

    def release_telemetry(self) -> None:
        """Retire this server's labeled series (counters AND the
        pull-time gauges) from the process registry. NOT called by
        ``stop()``: a killed PS's final counters staying scrapeable is
        part of the chaos-timeline contract — retirement is for hosts
        that restart servers in a loop and want scrape output bounded.
        The counter-backed properties above keep reading their own
        series after retirement."""
        telemetry.remove_series(server=self.telemetry_label)

    def scrape(self, full: bool = False) -> str:
        """This server's series as Prometheus exposition text — the
        in-process scrape surface every transport shares (the HTTP
        server also exposes ``/metrics``). Default: ONLY this instance's
        ``server=``-labeled series — the right unit for
        :class:`~elephas_tpu_torch.telemetry.aggregate.FleetScraper`, whose
        ``instance=`` relabeling is meaningless if every in-process
        target returns the whole shared registry. ``full=True``
        returns the entire process registry (the HTTP ``/metrics``
        behavior). Empty when the server was constructed under
        telemetry null mode."""
        if full:
            return telemetry.render(self._telemetry_registry)
        return telemetry.render(
            self._telemetry_registry,
            only={"server": self.telemetry_label},
        )

    # -- weight store --------------------------------------------------

    def get_parameters(self) -> list[np.ndarray]:
        if self.mode == "asynchronous":
            with self.lock:
                return [w.copy() for w in self.weights]
        return [w.copy() for w in self.weights]

    def update_parameters(self, delta) -> None:
        if self.mode == "asynchronous":
            with self.lock:
                self.weights = add_params(self.weights, delta)
        else:  # hogwild: deliberately lock-free
            self.weights = add_params(self.weights, delta)

    def apply_update(
        self, delta, client_id: str | None = None, seq: int | None = None
    ) -> bool:
        """Apply one delta, idempotently when ``(client_id, seq)`` is
        given: a sequence ID at or below the client's last applied one
        is skipped (the at-least-once wire resend case). Returns True
        iff the delta was applied.

        The whole apply — dedup decision included, and any journal
        write ``_note_update`` triggers — runs inside one ``ps.apply``
        span carrying ``(client_id, seq)``, so it pairs with the
        worker-side ``ps.push`` span across process trace exports
        (the merge tool's alignment edge); a forwarded
        trace context stamps it via the ambient scope."""
        with self._tracer.span(
            "ps.apply", server=self.telemetry_label,
            client_id="" if client_id is None else str(client_id),
            seq=-1 if seq is None else int(seq),
        ) as span:
            if client_id is None or seq is None:
                self.update_parameters(delta)
                self._note_update()
                span.set(applied=True)
                return True
            with self._seq_lock:
                if seq <= self.seq_table.get(client_id, -1):
                    self._m_updates_duplicate.inc()
                    span.set(applied=False)
                    return False
                self.update_parameters(delta)
                self.seq_table[client_id] = int(seq)
            self.heartbeat(client_id)
            self._note_update()
            span.set(applied=True)
            return True

    def set_weights(self, weights, weight_version: int | None = None) -> None:
        """Replace the full weight list, optionally stamping the
        generation (a deployment's versioned publication). Unstamped callers
        (training-side full syncs) leave the version untouched."""
        with self.lock:
            self.weights = [np.asarray(w) for w in weights]
            if weight_version is not None:
                self.weight_version = int(weight_version)

    def encode_parameters(self, compression: str = "none"):
        """Current weights as codec frames (the binary get path)."""
        enc = self._int8_codec if compression == "int8" else self._dense_codec
        return enc.encode_frames(self.get_parameters())

    # -- liveness / membership -------------------------------

    def heartbeat(self, client_id: str) -> None:
        """Refresh ``client_id``'s lease (registration is implicit:
        the first heartbeat or sequenced update creates it)."""
        with self._lease_lock:
            self.leases[client_id] = time.monotonic()
        self._m_heartbeats.inc()

    def members(self) -> dict[str, dict]:
        """Known workers with lease staleness: ``{id: {age_s, live}}``.
        A worker is live while its last heartbeat is within
        ``lease_timeout`` seconds."""
        with self._lease_lock:
            # copy: handler threads register members concurrently
            leases = list(self.leases.items())
        now = time.monotonic()
        return {
            cid: {
                "age_s": round(now - t, 3),
                "live": (now - t) <= self.lease_timeout,
            }
            for cid, t in sorted(leases)
        }

    def status(self) -> dict:
        """The ``status`` op payload: mode, membership, update and
        journal counters — everything a supervisor needs to decide
        whether training is healthy."""
        with self._seq_lock:
            seq_table = dict(self.seq_table)
        shard = (
            {}
            if self.shard_id is None
            # Shard identity rides the existing v2 status
            # payload — a guarded no-op on legacy wires (v1 servers
            # have no status op at all; un-sharded v2 servers simply
            # omit the keys, which clients treat as "cannot verify")
            else {"shard_id": self.shard_id, "num_shards": self.num_shards}
        )
        if self.shard_signature is not None:
            # slice-boundary digest (ShardMap.signature()) — lets a
            # client catch a template mismatch (different model/dtypes)
            # that position/count checks alone cannot see
            shard["shard_signature"] = self.shard_signature
        return {
            "protocol_version": PROTOCOL_VERSION,
            "mode": self.mode,
            **shard,
            "weight_version": self.weight_version,
            "uptime_s": round(time.monotonic() - self._created_at, 3),
            "updates_applied": self.updates_applied,
            "updates_duplicate": self.updates_duplicate,
            "members": self.members(),
            "seq_table": seq_table,
            "journal": {
                "dir": self.journal_dir,
                "every": self.journal_every,
                "writes": self.journal_writes,
                "restored": self.restored_from_journal,
            },
        }

    # -- connection tracking ---------------------------------

    def _track(self, sock) -> bool:
        """Register a live connection; returns False (connection
        refused) when the server is already stopping."""
        with self._conns_lock:
            if self._closing:
                return False
            self._conns.add(sock)
        return True

    def _untrack(self, sock) -> None:
        with self._conns_lock:
            self._conns.discard(sock)

    def _close_connections(self) -> None:
        """Sever every live client connection — part of stop(): a
        stopped (or chaos-killed) server must stop SERVING, not just
        stop accepting."""
        with self._conns_lock:
            self._closing = True
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- journaling ------------------------------------------

    def _note_update(self) -> None:
        self._m_updates_applied.inc()
        with self._seq_lock:  # concurrent clients: no lost increments
            self._applied_seen += 1
            due = bool(self.journal_dir) and (
                self._applied_seen - self._last_journal_at
                >= self.journal_every
            )
        if due:  # outside _seq_lock: write_journal re-acquires it
            self.write_journal()

    def write_journal(self) -> str | None:
        """Snapshot weights + sequence table now (atomic replace).
        No-op without ``journal_dir``."""
        if not self.journal_dir:
            return None
        with self._journal_lock, self._tracer.span(
            "ps.journal_write", server=self.telemetry_label
        ):
            with self._seq_lock:
                seq_table = dict(self.seq_table)
                weights = self.get_parameters()
                applied = self._applied_seen
                weight_version = self.weight_version
            path = journal_io.save_journal(
                self.journal_dir,
                weights,
                seq_table,
                meta={
                    "mode": self.mode,
                    "updates_applied": applied,
                    "weight_version": weight_version,
                },
            )
            self._m_journal_writes.inc()
            self._last_journal_at = applied
            return path

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError


class HttpServer(BaseParameterServer):
    """``GET /parameters[.bin]`` / ``POST /update[.bin]`` over stdlib HTTP."""

    def __init__(self, weights, mode: str = "asynchronous", port: int = 4000,
                 **ft_kwargs):
        super().__init__(weights, mode, port, **ft_kwargs)
        self._httpd = None
        self._thread = None

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # connection reuse across syncs
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                if not server._track(self.connection):
                    self.close_connection = True
                    raise ConnectionAbortedError("server stopping")

            def finish(self):
                server._untrack(self.connection)
                super().finish()

            def log_message(self, *args):  # silence request logging
                pass

            def _trace_scope(self):
                """Evaluate this request under the client's forwarded
                trace context — absent header = no scope,
                so legacy clients cost nothing."""
                from elephas_tpu_torch.telemetry import trace_scope

                return trace_scope(
                    self.headers.get("X-Elephas-Trace") or None
                )

            def do_GET(self):
                with self._trace_scope():
                    self._do_get()

            def do_POST(self):
                with self._trace_scope():
                    self._do_post()

            def _do_get(self):
                path, _, query = self.path.partition("?")
                if path == "/parameters.bin":
                    comp = "int8" if "comp=int8" in query else "none"
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/octet-stream"
                    )
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self.wfile.flush()

                    # one TE chunk per codec piece, written through the
                    # coalescing sender: size lines and small frames
                    # batch up, large payload memoryviews pass through
                    # zero-copy (wfile would concat-copy them)
                    def te_pieces():
                        for piece in server.encode_parameters(comp):
                            yield f"{len(piece):x}\r\n".encode()
                            yield piece
                            yield b"\r\n"
                        yield b"0\r\n\r\n"

                    sockets.send_frames(self.connection, te_pieces())
                    return
                if path == "/status":
                    payload = json.dumps(server.status()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if path == "/metrics":
                    # The whole process's registry (serving +
                    # PS + fault counters), Prometheus text format. A
                    # plain extra route — legacy pickle clients never
                    # touch it, so old wires are unaffected; renders
                    # through the REAL registry even under null mode
                    # (everything recorded before the flip stays
                    # scrapeable).
                    payload = telemetry.scrape_text().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", telemetry.CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if path != "/parameters":
                    self.send_error(404)
                    return
                payload = pickle.dumps(server.get_parameters())
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _read_exact(self, n: int) -> bytes:
                chunks, got = [], 0
                while got < n:
                    chunk = self.rfile.read(min(n - got, 1 << 20))
                    if not chunk:
                        raise ConnectionError("client closed mid-frame")
                    chunks.append(chunk)
                    got += len(chunk)
                return b"".join(chunks)

            def _do_post(self):
                if self.path == "/heartbeat":
                    cid = self.headers.get("X-Elephas-Client")
                    length = int(self.headers.get("Content-Length", 0))
                    if length:
                        self._read_exact(length)  # drain any body
                    if cid:
                        server.heartbeat(cid)
                    self.send_response(200 if cid else 400)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if self.path == "/update.bin":
                    # frames are self-delimiting; decode straight off the
                    # body so only one chunk is transient at a time
                    delta = wire.decode_stream(
                        self._read_exact, self.rfile.readinto
                    )
                    cid = self.headers.get("X-Elephas-Client")
                    seq = self.headers.get("X-Elephas-Seq")
                    applied = server.apply_update(
                        delta, cid, int(seq) if seq is not None else None
                    )
                    self.send_response(200)
                    self.send_header(
                        "X-Elephas-Applied", "1" if applied else "0"
                    )
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if self.path != "/update":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                # legacy-pickle fallback endpoint
                delta = pickle.loads(self._read_exact(length))
                server.apply_update(delta)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        class Httpd(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                if _is_connection_error():
                    logger.debug(
                        "http connection %s dropped", client_address
                    )
                    return
                super().handle_error(request, client_address)

        self._httpd = Httpd(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolves port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        self._started = True

    def stop(self, flush_journal: bool = True) -> None:
        if self._httpd is not None:
            # sever FIRST: the accept loop's poll interval is long
            # enough for a fast client to slip ops through a still-
            # serving handler after "stop" otherwise
            self._close_connections()
            self._httpd.shutdown()
            if flush_journal:
                # terminal snapshot: clean stops resume exactly; the
                # chaos harness passes False to simulate a CRASH (the
                # restart then replays the last periodic snapshot)
                self.write_journal()
            self._httpd.server_close()
            self._httpd = None
            self._started = False


class SocketServer(BaseParameterServer):
    """Raw-TCP op-code protocol (binary codec fast path + pickle legacy)."""

    def __init__(self, weights, mode: str = "asynchronous", port: int = 4000,
                 **ft_kwargs):
        super().__init__(weights, mode, port, **ft_kwargs)
        self._server = None
        self._thread = None

    def start(self) -> None:
        ps = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                if not ps._track(sock):
                    return  # stopping: refuse the zombie connection
                try:
                    self._serve(sock)
                finally:
                    ps._untrack(sock)

            def _serve(self, sock):
                from elephas_tpu_torch.telemetry import trace_scope

                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                # connection-sticky trace context: the
                # b'T' op sets it, every later op on this connection
                # evaluates under it until changed/cleared — mirrors
                # the per-request HTTP header with one op per trace
                # CHANGE instead of per push
                conn_trace = None
                while True:
                    op = sock.recv(1)
                    if not op or op == b"q" or ps._closing:
                        return
                    if op == b"T":
                        (tlen,) = _U16.unpack(
                            sockets.read_exact(sock, 2)
                        )
                        raw = (
                            sockets.read_exact(sock, tlen) if tlen
                            else b""
                        )
                        conn_trace = (
                            raw.decode("utf-8", "replace") or None
                        )
                        continue
                    with trace_scope(conn_trace):
                        if not self._one_op(sock, op):
                            return

            def _one_op(self, sock, op) -> bool:
                """Serve one op; False = unknown op, sever the
                connection (the protocol-2 loop's `else: return`)."""
                if op == b"?":
                    sock.sendall(bytes([PROTOCOL_VERSION]))
                elif op == b"G":
                    comp = sockets.read_exact(sock, 1)
                    frames = ps.encode_parameters(
                        "int8" if comp == b"\x01" else "none"
                    )
                    sockets.send_frames(sock, frames)
                elif op == b"U":
                    delta = wire.decode_stream(
                        sockets.reader(sock), sockets.reader_into(sock)
                    )
                    ps.apply_update(delta)
                    sock.sendall(b"k")
                elif op == b"S":
                    # sequenced update: id + seq header, then frames;
                    # the frames are always consumed (self-delimiting
                    # stream), the dedup decision follows
                    cid = _read_client_id(sock)
                    (seq,) = _U64.unpack(sockets.read_exact(sock, 8))
                    delta = wire.decode_stream(
                        sockets.reader(sock), sockets.reader_into(sock)
                    )
                    applied = ps.apply_update(delta, cid, seq)
                    sock.sendall(b"k" if applied else b"d")
                elif op == b"H":
                    ps.heartbeat(_read_client_id(sock))
                    sock.sendall(b"k")
                elif op == b"s":
                    payload = json.dumps(ps.status()).encode()
                    sock.sendall(_U32.pack(len(payload)) + payload)
                elif op == b"g":  # legacy-pickle fallback
                    sockets.send(sock, ps.get_parameters())
                elif op == b"u":  # legacy-pickle fallback
                    delta = sockets.receive(sock)
                    ps.apply_update(delta)
                else:
                    return False
                return True

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def handle_error(self, request, client_address):
                # dropped/severed connections are expected under chaos
                # and during stop(); anything else still gets the
                # stdlib traceback
                if _is_connection_error():
                    logger.debug(
                        "socket connection %s dropped", client_address
                    )
                    return
                super().handle_error(request, client_address)

        self._server = Server(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        self._started = True

    def stop(self, flush_journal: bool = True) -> None:
        if self._server is not None:
            # sever FIRST — see HttpServer.stop
            self._close_connections()
            self._server.shutdown()
            if flush_journal:
                # terminal snapshot: clean stops resume exactly; the
                # chaos harness passes False to simulate a CRASH (the
                # restart then replays the last periodic snapshot)
                self.write_journal()
            self._server.server_close()
            self._server = None
            self._started = False


def _read_client_id(sock) -> str:
    (idlen,) = _U16.unpack(sockets.read_exact(sock, 2))
    return sockets.read_exact(sock, idlen).decode("utf-8")


def _is_connection_error() -> bool:
    import sys

    return isinstance(sys.exc_info()[1], (ConnectionError, OSError))
