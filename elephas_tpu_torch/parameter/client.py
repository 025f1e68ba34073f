"""Parameter clients — worker-side counterparts of the servers.

Reference surface: ``[U] elephas/parameter/client.py`` —
``BaseParameterClient`` with ``get_parameters()`` / ``update_parameters``;
``HttpClient`` over urllib, ``SocketClient`` over raw TCP.

Both clients speak the binary codec
(:mod:`elephas_tpu_torch.parameter.codec`) on the hot path — dtype-preserving
frames, optional int8 pulls, optional int8/top-k delta pushes with
error-feedback residuals — over ONE reused connection with connect/read
timeouts and capped-exponential-backoff retries. Pickle survives only as
the negotiated fallback against legacy servers (detected per client on
first use: a 404 on ``/parameters.bin``, or a closed socket after the
``b'?'`` capability probe).

Fault tolerance: every client owns a ``client_id`` and stamps
each push with a **monotonic sequence ID** when the server speaks
protocol ≥ 2 — the server skips any ``(client, seq)`` it already
applied, so the at-least-once retry/resend machinery below becomes
effectively-once end to end. On a version-2 socket server, pushes that
were in flight when a connection died are **resent** (bounded by
``MAX_RESEND``) instead of merely counted: ``updates_lost`` rises when
a connection drops with unacked pushes and drains back as the resends
are acked (``updates_resent`` counts them). Unsequenced (legacy)
connections keep the old counted-and-logged behavior — resending there
could double-apply. ``heartbeat()`` refreshes this worker's lease and
``status()`` fetches the server's membership/counters JSON.

``bytes_sent`` / ``bytes_received`` count payload bytes on the wire so
callers can report the bytes each sync moves.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import pickle
import socket
import struct
import uuid
from collections import deque

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.parameter import codec as wire
from elephas_tpu_torch.utils import sockets

logger = logging.getLogger(__name__)

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# a reconnect may carry at most this many unacked pushes over for
# resend; anything beyond stays lost (and counted) — an unbounded
# resend queue would let a long outage buffer arbitrary memory
MAX_RESEND = 64


def _split_master(master: str | None, port: int) -> tuple[str, int]:
    master = master or sockets.determine_master(port)
    if "//" in master:
        master = master.split("//", 1)[1]
    host, _, p = master.partition(":")
    return host or "127.0.0.1", int(p or port)


def default_client_id() -> str:
    """Stable-enough worker identity: host + pid + random tail (two
    workers in one process stay distinct; a restarted worker PROCESS
    gets a fresh id on purpose — its sequence counter restarts at 0,
    and reusing the old id would make the server drop everything)."""
    return f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"


class BaseParameterClient:
    """Shared wire-codec state: compression knobs, error feedback,
    byte counters, sequence IDs, and the legacy-fallback flag."""

    def __init__(
        self,
        compression: str = "none",
        topk: float | None = None,
        pull_compression: str | None = None,
        client_id: str | None = None,
    ):
        for c in (compression, pull_compression):
            if c is not None and c not in wire.COMPRESSIONS:
                raise ValueError(
                    f"compression must be one of {wire.COMPRESSIONS}, "
                    f"got {c!r}"
                )
        self.compression = compression
        self.topk = topk
        # pushes and pulls compress independently: DGC-style setups
        # quantize/sparsify the pushed deltas (error feedback keeps them
        # honest) while pulling dense weights — pull quantization has no
        # feedback loop, so it defaults to following `compression` only
        # when explicitly unset
        self.pull_compression = (
            compression if pull_compression is None else pull_compression
        )
        self._update_codec = wire.WireCodec(compression=compression, topk=topk)
        self._feedback = (
            wire.ErrorFeedback()
            if (compression != "none" or topk is not None)
            else None
        )
        self._binary: bool | None = None  # None until negotiated
        self.client_id = client_id or default_client_id()
        self._seq = 0  # next sequence ID to assign (monotonic, PLAIN —
        # it drives the dedup protocol, so it must never ride telemetry)
        # chaos-injection hook (elephas_tpu_torch.fault): when set, called as
        # hook(seq) after a successful sequenced push; returning True
        # makes the client resend the identical frame — the harness's
        # wire-level duplicate, exercising the server's dedup path
        self.chaos_duplicate = None
        self.chaos_dups_sent = 0

        # -- telemetry: wire counters live in the registry;
        # the same-named attributes below are read-back views, so the
        # bench's bytes-per-sync and a Prometheus scrape can never
        # disagree. Labeled by a process-monotonic instance id, not
        # client_id (which embeds a uuid — scrapes should be stable
        # across identically-driven gang processes).
        reg = telemetry.registry()
        label = telemetry.instance_label()
        self.telemetry_label = label
        self._tracer = telemetry.tracer()

        def _c(name, help_):
            return reg.counter(
                name, help_, labels=("client",)
            ).labels(client=label)

        self._m_bytes_sent = _c(
            "elephas_ps_client_bytes_sent_total",
            "Payload bytes pushed to the parameter server",
        )
        self._m_bytes_received = _c(
            "elephas_ps_client_bytes_received_total",
            "Payload bytes pulled from the parameter server",
        )
        self._m_updates_resent = _c(
            "elephas_ps_client_updates_resent_total",
            "Unacked pushes safely replayed after a reconnect",
        )
        self._m_updates_duplicate = _c(
            "elephas_ps_client_updates_duplicate_total",
            "Pushes the server dedup-skipped as already applied",
        )
        self._m_updates_lost = reg.gauge(
            "elephas_ps_client_updates_lost",
            "Pushes in doubt on a dead connection (drains as resends "
            "are acked)",
            labels=("client",),
        ).labels(client=label)
        # reset_counters() baselines (counters are monotonic)
        self._bytes_sent_base = 0
        self._bytes_received_base = 0

    def _next_seq(self) -> int:
        seq = self._seq
        self._seq += 1
        return seq

    # -- telemetry views ---------------------------

    @property
    def bytes_sent(self) -> int:
        return int(self._m_bytes_sent.value) - self._bytes_sent_base

    @property
    def bytes_received(self) -> int:
        return int(self._m_bytes_received.value) - self._bytes_received_base

    @property
    def updates_resent(self) -> int:
        return int(self._m_updates_resent.value)

    @property
    def updates_duplicate(self) -> int:
        return int(self._m_updates_duplicate.value)

    def reset_counters(self) -> None:
        """Re-baseline the byte VIEWS (``bytes_sent``/``bytes_received``
        read as 0 from here). The underlying registry counters stay
        monotonic, as Prometheus counters must."""
        self._bytes_sent_base = int(self._m_bytes_sent.value)
        self._bytes_received_base = int(self._m_bytes_received.value)

    def release_telemetry(self) -> None:
        """Retire this client's labeled series from the process
        registry. NOT called by ``close()``: scraping after teardown is
        a supported shape, so retirement is the host's explicit call —
        long-lived processes that churn clients (one per partition per
        fit) call this to keep scrape output bounded. The object-held
        views (``bytes_sent`` etc.) keep reading their own series."""
        telemetry.remove_series(client=self.telemetry_label)

    def _encode_update(self, delta) -> bytes:
        """Encode ONCE per update — the error-feedback residual mutates
        at encode time, so retries must resend these bytes, never
        re-encode."""
        return self._update_codec.encode(delta, self._feedback)

    def get_parameters(self):
        raise NotImplementedError

    def update_parameters(self, delta) -> None:
        raise NotImplementedError

    # -- sharded scatter/gather hooks ------------------------
    # The sharded client must encode ONCE and own the (seq, body) pair
    # across pause/resend cycles — a re-encode would re-absorb the
    # error-feedback residual and a re-assigned seq would break the
    # server-side dedup ordering.

    def prepare_push(self, delta) -> tuple[int | None, bytes]:
        """Encode one push and assign its sequence ID (None when this
        connection is unsequenced — such pushes must never be buffered
        for resend, a replay could double-apply)."""
        raise NotImplementedError

    def push_encoded(self, seq: int | None, body: bytes) -> None:
        """Send an already-prepared push (idempotent to retry when
        ``seq`` is not None — the server dedups)."""
        raise NotImplementedError


class HttpClient(BaseParameterClient):
    def __init__(
        self,
        master: str | None = None,
        port: int = 4000,
        compression: str = "none",
        topk: float | None = None,
        pull_compression: str | None = None,
        timeout: float = sockets.IO_TIMEOUT,
        retries: int = 3,
        client_id: str | None = None,
    ):
        super().__init__(compression, topk, pull_compression, client_id)
        self.host, self.port = _split_master(master, port)
        self.master_url = f"http://{self.host}:{self.port}"
        self.timeout = timeout
        self.retries = retries
        self._conn: http.client.HTTPConnection | None = None

    # -- connection management ----------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            self._conn.connect()
            # headers and body go out as separate writes; without
            # NODELAY each POST eats a Nagle/delayed-ACK stall
            self._conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        return self._conn

    def _reset(self, *_args) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def close(self) -> None:
        self._reset()

    def _retry(self, fn):
        return sockets.retry_call(
            fn, retries=self.retries, on_retry=self._reset
        )

    def _resp_reader(self, resp):
        def read_exact(n: int) -> bytes:
            chunks, got = [], 0
            while got < n:
                chunk = resp.read(n - got)
                if not chunk:
                    raise ConnectionError("server closed mid-frame")
                chunks.append(chunk)
                got += len(chunk)
            self._m_bytes_received.inc(n)
            return b"".join(chunks)

        def readinto(mv: memoryview) -> int:
            got = resp.readinto(mv)
            self._m_bytes_received.inc(got or 0)
            return got

        return read_exact, readinto

    # -- protocol ------------------------------------------------------

    def get_parameters(self):
        with self._tracer.span("ps.pull", client=self.telemetry_label):
            return self._retry(self._get_once)

    @staticmethod
    def _trace_headers(headers: dict | None = None) -> dict:
        """Attach the active trace context as ``X-Elephas-Trace``
       . Header-only, so every legacy HTTP server is a
        clean no-op — it never reads the header."""
        headers = dict(headers or {})
        trace = telemetry.current_trace()
        if trace is not None:
            headers["X-Elephas-Trace"] = trace
        return headers

    def _get_once(self):
        if self._binary is not False:
            conn = self._connection()
            path = "/parameters.bin" + (
                "?comp=int8" if self.pull_compression == "int8" else ""
            )
            conn.request("GET", path, headers=self._trace_headers())
            resp = conn.getresponse()
            if resp.status == 200:
                self._binary = True
                out = wire.decode_stream(*self._resp_reader(resp))
                resp.read()  # drain to keep the connection reusable
                return out
            resp.read()
            if resp.status != 404:
                raise ConnectionError(f"GET {path} -> {resp.status}")
            self._binary = False  # legacy server: pickle from here on
        conn = self._connection()
        conn.request("GET", "/parameters")
        resp = conn.getresponse()
        if resp.status != 200:
            resp.read()
            raise ConnectionError(f"GET /parameters -> {resp.status}")
        payload = resp.read()
        self._m_bytes_received.inc(len(payload))
        return pickle.loads(payload)  # legacy-pickle fallback path

    def update_parameters(self, delta) -> None:
        """Push one delta. Retries make the wire at-least-once; the
        sequence-ID headers make the APPLY idempotent against a
        version-2 server (a resent POST whose first copy landed is
        skipped server-side) — effectively-once end to end. Against a
        protocol-1 binary server the headers are ignored and the old
        double-apply caveat stands."""
        # cid/seq on the span args: the merge tool's push↔apply
        # clock-alignment edge, like the socket client's
        with self._tracer.span(
            "ps.push", client=self.telemetry_label, cid=self.client_id,
        ) as span:
            if self._binary is False and self._feedback is None:
                # known-legacy server + lossless push: pickle the delta
                # directly, skipping a pointless codec encode+decode pass
                self._retry(
                    lambda: self._legacy_update(pickle.dumps(delta))
                )
                return
            body = self._encode_update(delta)
            seq = self._next_seq()
            span.set(seq=seq)
            self._retry(lambda: self._update_once(body, seq))

    def _update_once(self, body: bytes, seq: int | None = None) -> None:
        if self._binary is not False:
            applied = self._post_update_bin(body, seq)
            if applied is not None:
                if not applied:
                    self._m_updates_duplicate.inc()
                elif self.chaos_duplicate is not None and seq is not None \
                        and self.chaos_duplicate(seq):
                    # chaos harness: wire-level duplicate of this frame
                    self.chaos_dups_sent += 1
                    if self._post_update_bin(body, seq) is False:
                        self._m_updates_duplicate.inc()
                return
            self._binary = False
        # Legacy server: ship the delta AS THE SERVER WILL SEE IT — the
        # locally-decoded frames — so the error-feedback residual
        # (absorbed at encode time) stays exact.
        self._legacy_update(pickle.dumps(wire.decode(body)))

    def prepare_push(self, delta) -> tuple[int | None, bytes]:
        # A sequence ID is a promise of dedup-protected replay (the
        # sharded client parks and replays only sequenced pushes). A
        # known-legacy server ignores the sequence headers, so hand
        # back seq=None — the park path then refuses to buffer instead
        # of replaying an update the server would apply twice.
        body = self._encode_update(delta)
        if self._binary is False:
            return None, body
        return self._next_seq(), body

    def push_encoded(self, seq: int | None, body: bytes) -> None:
        with self._tracer.span(
            "ps.push", client=self.telemetry_label, cid=self.client_id,
            seq=-1 if seq is None else seq,
        ):
            self._retry(lambda: self._update_once(body, seq))

    def _post_update_bin(self, body: bytes, seq: int | None) -> bool | None:
        """POST /update.bin once. Returns applied?, or None on a 404
        (legacy server — caller falls back)."""
        conn = self._connection()
        headers = self._trace_headers(
            {"Content-Type": "application/octet-stream"}
        )
        if seq is not None:
            headers["X-Elephas-Client"] = self.client_id
            headers["X-Elephas-Seq"] = str(seq)
        conn.request("POST", "/update.bin", body=body, headers=headers)
        resp = conn.getresponse()
        resp.read()
        if resp.status == 200:
            self._binary = True
            self._m_bytes_sent.inc(len(body))
            return resp.getheader("X-Elephas-Applied", "1") != "0"
        if resp.status != 404:
            raise ConnectionError(f"POST /update.bin -> {resp.status}")
        return None

    def _legacy_update(self, payload: bytes) -> None:
        conn = self._connection()
        conn.request(
            "POST",
            "/update",
            body=payload,
            headers={"Content-Type": "application/octet-stream"},
        )
        resp = conn.getresponse()
        resp.read()
        if resp.status != 200:
            raise ConnectionError(f"POST /update -> {resp.status}")
        self._m_bytes_sent.inc(len(payload))

    # -- liveness -------------------------------------------

    def flush(self) -> None:
        """Confirm delivery of every push. HTTP POSTs are synchronous
        request/response — nothing can be outstanding — so this is the
        no-op half of the socket client's contract."""

    def heartbeat(self) -> None:
        """Refresh this worker's lease on the server. No-op against a
        known-legacy server (it has no /heartbeat; a 404 per sync
        period would just churn)."""
        if self._binary is False:
            return

        def once():
            conn = self._connection()
            conn.request(
                "POST", "/heartbeat",
                headers={"X-Elephas-Client": self.client_id,
                         "Content-Length": "0"},
            )
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise ConnectionError(f"POST /heartbeat -> {resp.status}")

        self._retry(once)

    def status(self) -> dict:
        """The server's status JSON (membership, counters, journal)."""

        def once():
            conn = self._connection()
            conn.request("GET", "/status")
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise ConnectionError(f"GET /status -> {resp.status}")
            return json.loads(payload)

        return self._retry(once)


class SocketClient(BaseParameterClient):
    def __init__(
        self,
        master: str | None = None,
        port: int = 4000,
        compression: str = "none",
        topk: float | None = None,
        pull_compression: str | None = None,
        connect_timeout: float = sockets.CONNECT_TIMEOUT,
        io_timeout: float = sockets.IO_TIMEOUT,
        retries: int = 3,
        client_id: str | None = None,
    ):
        super().__init__(compression, topk, pull_compression, client_id)
        self.host, self.port = _split_master(master, port)
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self.retries = retries
        self._sock = None
        self._proto_version = 0
        # pipelined pushes awaiting their ack: (seq, body) — body kept
        # only for sequenced pushes, where a post-reconnect resend is
        # made safe by the server-side dedup
        self._unacked: deque[tuple[int | None, bytes | None]] = deque()
        self._resend: deque[tuple[int, bytes]] = deque()
        # trace id last forwarded on THIS connection: the
        # b'T' op is sticky server-side, so it resends only on change
        self._conn_trace: str | None = None
        self._connect()

    @property
    def updates_lost(self) -> int:
        """Unacked pushes in doubt on a dead conn — a registry GAUGE
        (it drains back down as resends ack), read-back view like the
        counters."""
        return int(self._m_updates_lost.value)

    @property
    def _sequenced(self) -> bool:
        return self._proto_version >= 2

    @property
    def _traceful(self) -> bool:
        """Does the peer understand the trace-context op? Gated on the
        probed protocol version — a version-2 server would treat b'T'
        as an unknown op and sever the connection, so legacy peers
        must simply never see it (the clean-no-op contract)."""
        return self._proto_version >= 3

    # -- connection management ----------------------------------------

    def _sync_trace(self) -> None:
        """Forward this thread's trace context when it
        changed since the last op on this connection. Fire-and-forget
        (no ack: it rides the ordered TCP stream ahead of the op it
        scopes); no-op against pre-protocol-3 servers and outside any
        scope."""
        if not self._traceful:
            return
        trace = telemetry.current_trace()
        if trace == self._conn_trace:
            return
        raw = (trace or "").encode("utf-8")
        self._sock.sendall(b"T" + _U16.pack(len(raw)) + raw)
        self._conn_trace = trace

    def _connect(self) -> None:
        self._sock = sockets.connect(
            self.host, self.port, self.connect_timeout, self.io_timeout
        )
        self._conn_trace = None  # fresh connection: no forwarded trace
        if self._binary is None:
            # capability probe: a binary server answers with its protocol
            # version; a legacy server closes the connection on the
            # unknown op (we reconnect and stay on pickle)
            try:
                self._sock.sendall(b"?")
                ver = sockets.read_exact(self._sock, 1)
                self._proto_version = ver[0]
                self._binary = ver[0] >= 1
            except (ConnectionError, OSError):
                self._binary = False
                self._sock = sockets.connect(
                    self.host, self.port, self.connect_timeout,
                    self.io_timeout,
                )

    def _reconnect(self, *_args) -> None:
        self._close_sock()
        if self._unacked:
            # pushes died on the wire before their acks: the server may
            # or may not have applied them. Sequenced frames are queued
            # for a BOUNDED resend (dedup makes the replay exactly-once
            # either way) and `updates_lost` drains as their resends are
            # acked; unsequenced frames stay lost — resending those
            # could double-apply — and are surfaced loudly, not fatally.
            resendable = [
                (s, b) for s, b in self._unacked
                if s is not None and b is not None
            ]
            overflow = max(
                0, len(self._resend) + len(resendable) - MAX_RESEND
            )
            if overflow:
                resendable = resendable[overflow:]
            self._resend.extend(resendable)
            self._m_updates_lost.inc(len(self._unacked))
            logger.warning(
                "connection lost with %d unacked update(s); %d queued "
                "for sequence-deduplicated resend, %d unrecoverable "
                "(updates_lost=%d drains as resends are acked)",
                len(self._unacked), len(resendable),
                len(self._unacked) - len(resendable), self.updates_lost,
            )
            self._unacked.clear()
        self._connect()

    def _ensure_sock(self) -> None:
        """Reopen the connection when a previous failed reconnect left
        it closed (the outer supervised retry re-enters ops here)."""
        if self._sock is None:
            self._connect()

    def _seq_head(self, seq: int) -> bytes:
        cid = self.client_id.encode("utf-8")
        return b"S" + _U16.pack(len(cid)) + cid + _U64.pack(seq)

    def _flush_resends(self) -> None:
        """Replay queued unacked pushes (synchronously — ack per frame;
        the queue is short and this path is the recovery path, not the
        hot path). Each ack, applied or duplicate-skipped, drains one
        unit of ``updates_lost``."""
        while self._resend:
            seq, body = self._resend[0]
            self._sock.sendall(self._seq_head(seq) + body)
            ack = sockets.read_exact(self._sock, 1)
            if ack not in (b"k", b"d"):
                raise ConnectionError(f"bad resend ack {ack!r}")
            self._resend.popleft()
            self._m_updates_lost.set(max(0, self.updates_lost - 1))
            self._m_updates_resent.inc()
            if ack == b"d":
                self._m_updates_duplicate.inc()
            self._m_bytes_sent.inc(len(body))

    def _drain_acks(self) -> None:
        """Collect outstanding update acks. Pushes are PIPELINED — the
        legacy pickle update is fire-and-forget, so blocking a full
        round-trip per binary push would regress it; instead the ack is
        read before the next op on this connection (the server answers
        ops in order), keeping error detection without the stall."""
        while self._unacked:
            ack = sockets.read_exact(self._sock, 1)
            seq, _body = self._unacked.popleft()
            if ack == b"d":
                self._m_updates_duplicate.inc()
            elif ack != b"k":
                raise ConnectionError(f"bad update ack {ack!r}")

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _retry(self, fn):
        return sockets.retry_call(
            fn, retries=self.retries, on_retry=self._reconnect
        )

    def _counting_reader(self):
        read = sockets.reader(self._sock)
        recv_into = sockets.reader_into(self._sock)

        def read_exact(n: int) -> bytes:
            buf = read(n)
            self._m_bytes_received.inc(n)
            return buf

        def readinto(mv: memoryview) -> int:
            got = recv_into(mv)
            self._m_bytes_received.inc(got or 0)
            return got

        return read_exact, readinto

    # -- protocol ------------------------------------------------------

    def get_parameters(self):
        with self._tracer.span("ps.pull", client=self.telemetry_label):
            return self._retry(self._get_once)

    def _get_once(self):
        self._ensure_sock()
        if self._binary:
            self._sync_trace()
            self._flush_resends()
            self._drain_acks()
            comp = b"\x01" if self.pull_compression == "int8" else b"\x00"
            self._sock.sendall(b"G" + comp)
            return wire.decode_stream(*self._counting_reader())
        self._sock.sendall(b"g")
        # legacy-pickle fallback path
        out, nbytes = sockets.receive_with_size(self._sock)
        if out is None:
            raise ConnectionError("server closed during get")
        self._m_bytes_received.inc(nbytes)
        return out

    def update_parameters(self, delta) -> None:
        """Push one delta. Against a version-2 server each push carries
        a monotonic sequence ID, so retries/resends after a reconnect
        are deduplicated server-side — effectively-once. Against a
        version-1 server the old at-least-once caveat stands (a resend
        can double-apply), and a push whose connection dies before its
        pipelined ack is counted in ``updates_lost`` without resend."""
        # cid/seq ride the span args so a worker-side ps.push pairs
        # with the server-side ps.apply across trace exports — the
        # merge tool's clock-alignment edge
        with self._tracer.span(
            "ps.push", client=self.telemetry_label, cid=self.client_id,
        ) as span:
            if self._binary:
                body = self._encode_update(delta)  # once: feedback mutates
                seq = self._next_seq() if self._sequenced else None
                span.set(seq=-1 if seq is None else seq)
                self._retry(lambda: self._push_once(seq, body))
            else:
                self._retry(lambda: self._push_pickle(delta))

    def _push_once(self, seq: int | None, body: bytes) -> None:
        self._ensure_sock()
        self._sync_trace()
        self._flush_resends()
        self._drain_acks()
        if seq is not None:
            self._sock.sendall(self._seq_head(seq) + body)
            self._unacked.append((seq, body))
        else:
            self._sock.sendall(b"U" + body)
            self._unacked.append((None, None))
        self._m_bytes_sent.inc(len(body))
        if seq is not None and self.chaos_duplicate is not None \
                and self.chaos_duplicate(seq):
            # chaos harness: duplicate the identical frame on the wire
            # (kept resendable — replaying a duplicate is still a dedup)
            self.chaos_dups_sent += 1
            self._sock.sendall(self._seq_head(seq) + body)
            self._unacked.append((seq, body))

    def _push_pickle(self, delta) -> None:
        self._ensure_sock()
        self._sock.sendall(b"u")
        # legacy-pickle fallback path
        self._m_bytes_sent.inc(sockets.send(self._sock, delta))

    def prepare_push(self, delta) -> tuple[int | None, bytes]:
        if not self._binary:
            raise ConnectionError(
                "sharded pushes need the binary protocol; this "
                "connection negotiated the legacy pickle wire"
            )
        seq = self._next_seq() if self._sequenced else None
        return seq, self._encode_update(delta)

    def push_encoded(self, seq: int | None, body: bytes) -> None:
        if not self._binary:
            raise ConnectionError(
                "sharded pushes need the binary protocol; this "
                "connection negotiated the legacy pickle wire"
            )
        with self._tracer.span(
            "ps.push", client=self.telemetry_label, cid=self.client_id,
            seq=-1 if seq is None else seq,
        ):
            self._retry(lambda: self._push_once(seq, body))

    # -- liveness -------------------------------------------

    def flush(self) -> None:
        """Confirm delivery of every push: replay queued resends and
        drain every pipelined ack, reconnect-retrying on failure. The
        worker calls this under its supervised retry before reporting a
        partition done — without it, a connection that dies holding the
        FINAL pushes of a run would lose them silently in close()."""
        if not self._binary:
            return

        def once():
            self._ensure_sock()
            self._flush_resends()
            self._drain_acks()

        self._retry(once)

    def heartbeat(self) -> None:
        """Refresh this worker's lease over the existing connection.
        No-op against pre-version-2 servers (no leases) and on
        legacy-pinned connections (an unknown op closes those)."""
        if not self._sequenced or not self._binary:
            return

        def once():
            self._ensure_sock()
            self._sync_trace()
            self._flush_resends()
            self._drain_acks()
            cid = self.client_id.encode("utf-8")
            self._sock.sendall(b"H" + _U16.pack(len(cid)) + cid)
            if sockets.read_exact(self._sock, 1) != b"k":
                raise ConnectionError("bad heartbeat ack")

        self._retry(once)

    def status(self) -> dict:
        """The server's status JSON (membership, counters, journal).
        Raises against pre-version-2 servers."""
        if not self._sequenced:
            raise ConnectionError(
                f"server protocol version {self._proto_version} has no "
                f"status op (needs >= 2)"
            )

        def once():
            self._ensure_sock()
            self._flush_resends()
            self._drain_acks()
            self._sock.sendall(b"s")
            (n,) = _U32.unpack(sockets.read_exact(self._sock, 4))
            return json.loads(sockets.read_exact(self._sock, n))

        return self._retry(once)

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._flush_resends()
            self._drain_acks()  # surface in-flight update failures
            self._sock.sendall(b"q")
        except OSError as e:
            # a best-effort close must not raise, but pushes dying HERE
            # are real losses — count and log them, never swallow
            # silently (callers that need certainty call flush() first)
            in_doubt = len(self._unacked) + len(self._resend)
            if in_doubt:
                self._m_updates_lost.inc(len(self._unacked))
                logger.warning(
                    "close() with %d unconfirmed update(s) on a dead "
                    "connection (%r) — call flush() before close() for "
                    "confirmed delivery (updates_lost=%d)",
                    in_doubt, e, self.updates_lost,
                )
        self._close_sock()


# -- sharded scatter/gather client ------------


_WIRE_ERRORS = (ConnectionError, TimeoutError, OSError)

# a paused shard may buffer at most this many prepared pushes; beyond
# it the push raises (backpressure into the worker's supervised retry)
# instead of letting a long outage buffer unbounded encoded deltas
MAX_SHARD_PENDING = 64


class ShardedClient:
    """Scatter/gather client over N per-shard parameter servers.

    One logical ``get_parameters``/``update_parameters`` surface (the
    exact :class:`BaseParameterClient` contract the workers drive),
    fanned across the shard topology a
    :class:`~elephas_tpu_torch.parameter.sharding.ShardMap` defines. Each
    shard gets its own inner transport client sharing this worker's
    ``client_id`` but keeping an **independent sequence counter** — the
    per-shard servers each hold their own ``(client, seq)`` dedup
    table, so effectively-once holds per shard (there is NO cross-shard
    ordering guarantee; see docs/API.md).

    **Partial-failure isolation**: a push whose shard is unreachable
    (even after the inner client's reconnect retries) is parked —
    encoded once, sequence ID already assigned — in that shard's
    bounded pending queue and replayed IN ORDER when the shard returns
    (out-of-order delivery would be mis-deduplicated: the server skips
    any seq at or below the last applied). Other shards keep serving;
    only the dead shard's slice pauses. A pull against a dead shard
    falls back to that shard's last successfully pulled slice (stale,
    Hogwild-style — counted loudly) so training on the live slices
    continues. ``flush()`` is the strict path: it replays every pending
    push and confirms delivery on every shard, raising if any shard is
    still down — the worker calls it (under supervised retry) before
    reporting a partition done.
    """

    def __init__(
        self,
        master,
        shard_map,
        transport: str = "socket",
        client_id: str | None = None,
        validate: bool = True,
        **client_kwargs,
    ):
        from elephas_tpu_torch.parameter.sharding import shard_endpoints

        endpoints = (
            shard_endpoints(master) if isinstance(master, str)
            else list(master)
        )
        if len(endpoints) != shard_map.num_shards:
            raise ValueError(
                f"shard map expects {shard_map.num_shards} shards but "
                f"got {len(endpoints)} endpoint(s) {endpoints!r} — a "
                f"mis-sized endpoint list would silently cross-wire "
                f"tensor slices"
            )
        cls = {"http": HttpClient, "socket": SocketClient}.get(transport)
        if cls is None:
            raise ValueError(
                f"transport must be 'http' or 'socket', got {transport!r}"
            )
        self.shard_map = shard_map
        self.client_id = client_id or default_client_id()
        # every inner client shares the worker identity; sequence
        # counters stay per-inner (= per-shard), matching the per-shard
        # server dedup tables
        self._parts = [
            cls(master=e, client_id=self.client_id, **client_kwargs)
            for e in endpoints
        ]
        self.endpoints = endpoints
        self._pending: list[deque[tuple[int, bytes]]] = [
            deque() for _ in endpoints
        ]
        # last successfully pulled slice per shard — the stale fallback
        # a dead shard's pull serves so live slices keep training
        self._last_slice: list[list | None] = [None] * len(endpoints)

        reg = telemetry.registry()
        label = telemetry.instance_label()
        self.telemetry_label = label
        self._tracer = telemetry.tracer()
        self._m_shard_pauses = reg.counter(
            "elephas_ps_client_shard_pauses_total",
            "Pushes parked because their shard was unreachable",
            labels=("client", "shard"),
        )
        self._m_stale_pulls = reg.counter(
            "elephas_ps_client_shard_stale_pulls_total",
            "Pulls served from a dead shard's last-known slice",
            labels=("client", "shard"),
        )
        if validate:
            self.validate_topology()

    # -- topology validation -----------------------

    def validate_topology(self) -> None:
        """Cross-check every server's self-reported shard identity
        against this client's map — fail fast on mis-wiring (shard 0's
        endpoint actually serving shard 1 would scatter slices into the
        wrong dedup tables and journals). Servers that predate shard
        identity (plain v2) or the status op (legacy v1) report
        nothing; absence is tolerated with a warning — only a
        CONFLICTING identity is fatal."""
        n = self.shard_map.num_shards
        for i, inner in enumerate(self._parts):
            try:
                st = inner.status()
            except _WIRE_ERRORS as e:
                raise ConnectionError(
                    f"shard {i} ({self.endpoints[i]}) failed topology "
                    f"validation — no status op (legacy server, or "
                    f"down): {e!r}; sharded topologies need protocol-2 "
                    f"servers"
                ) from e
            sid, num = st.get("shard_id"), st.get("num_shards")
            if sid is None and num is None:
                logger.warning(
                    "shard %d (%s) reports no shard identity — cannot "
                    "verify the topology (server started without "
                    "shard_id/num_shards?)", i, self.endpoints[i],
                )
                continue
            if sid != i or num != n:
                raise ValueError(
                    f"shard topology mismatch: endpoint "
                    f"{self.endpoints[i]} (position {i} of {n}) "
                    f"identifies as shard {sid} of {num} — endpoint "
                    f"order must match the server group's shard order"
                )
            sig = st.get("shard_signature")
            if sig is not None and sig != self.shard_map.signature():
                # position and count agree but the SLICE BOUNDARIES do
                # not — client and servers derived their maps from
                # different weight templates (different model, dtype,
                # or layer order); scattering would land tensors in the
                # wrong shards' dedup tables and journals
                raise ValueError(
                    f"shard map signature mismatch on shard {i} "
                    f"({self.endpoints[i]}): server built its slices "
                    f"from a different weight template (server "
                    f"{sig}, client {self.shard_map.signature()})"
                )

    # -- aggregated counters / views -----------------------------------

    @property
    def num_shards(self) -> int:
        return self.shard_map.num_shards

    @property
    def bytes_sent(self) -> int:
        return sum(p.bytes_sent for p in self._parts)

    @property
    def bytes_received(self) -> int:
        return sum(p.bytes_received for p in self._parts)

    @property
    def updates_resent(self) -> int:
        return sum(p.updates_resent for p in self._parts)

    @property
    def updates_duplicate(self) -> int:
        return sum(p.updates_duplicate for p in self._parts)

    @property
    def updates_lost(self) -> int:
        return sum(getattr(p, "updates_lost", 0) for p in self._parts)

    @property
    def pending_counts(self) -> list[int]:
        """Parked pushes per shard (nonzero = that shard's slice is
        paused behind an outage)."""
        return [len(q) for q in self._pending]

    @property
    def chaos_duplicate(self):
        return self._parts[0].chaos_duplicate

    @chaos_duplicate.setter
    def chaos_duplicate(self, hook) -> None:
        for p in self._parts:
            p.chaos_duplicate = hook

    @property
    def chaos_dups_sent(self) -> int:
        return sum(p.chaos_dups_sent for p in self._parts)

    def reset_counters(self) -> None:
        for p in self._parts:
            p.reset_counters()

    def release_telemetry(self) -> None:
        for p in self._parts:
            p.release_telemetry()
        telemetry.remove_series(client=self.telemetry_label)

    # -- scatter/gather protocol ---------------------------------------

    def get_parameters(self):
        """Gather the full weight list. A shard that stays unreachable
        through its client's retries serves its LAST pulled slice
        (stale — the paused-slice degrade, counted in
        ``elephas_ps_client_shard_stale_pulls_total``); with no slice
        cached yet the failure propagates (serving made-up weights is
        the one unacceptable outcome)."""
        slices = []
        for i, inner in enumerate(self._parts):
            try:
                part = inner.get_parameters()
                self._last_slice[i] = part
            except _WIRE_ERRORS as e:
                part = self._last_slice[i]
                if part is None:
                    raise
                self._m_stale_pulls.labels(
                    client=self.telemetry_label, shard=str(i)
                ).inc()
                logger.warning(
                    "shard %d (%s) unreachable on pull (%r) — serving "
                    "its last-known slice; only this slice is stale",
                    i, self.endpoints[i], e,
                )
            slices.append(part)
        return self.shard_map.gather(slices)

    def _drain_pending(self, i: int) -> None:
        """Replay shard ``i``'s parked pushes in seq order (the server
        dedups at-or-below the last applied seq, so order is
        load-bearing)."""
        q = self._pending[i]
        while q:
            seq, body = q[0]
            self._parts[i].push_encoded(seq, body)
            q.popleft()

    def _park(self, i: int, seq: int | None, body: bytes, cause) -> None:
        """Queue one prepared push behind shard ``i``'s outage —
        bounded, sequenced-only (replaying an unsequenced push could
        double-apply, so those failures propagate instead)."""
        if seq is None:
            raise cause
        q = self._pending[i]
        if len(q) >= MAX_SHARD_PENDING:
            raise ConnectionError(
                f"shard {i} ({self.endpoints[i]}) unreachable with "
                f"{len(q)} pushes already parked (MAX_SHARD_PENDING="
                f"{MAX_SHARD_PENDING}) — refusing to buffer more"
            ) from cause
        q.append((seq, body))
        self._m_shard_pauses.labels(
            client=self.telemetry_label, shard=str(i)
        ).inc()

    def update_parameters(self, delta) -> None:
        """Scatter one delta. Live shards apply their slices now; a
        dead shard's slice parks (encoded once, sequence ID already
        assigned) behind its bounded pending queue — one dead shard
        pauses only its slice. Queue overflow re-raises the shard's
        error so the caller's supervised retry owns the backpressure."""
        paused = []
        for i, (inner, part) in enumerate(
            zip(self._parts, self.shard_map.scatter(list(delta)))
        ):
            # the NEW slice is always prepared (encode + seq assign) so
            # that even when the shard is down, its queue keeps strict
            # seq order for the eventual replay — the server dedups
            # at-or-below the last applied seq, so order is load-bearing
            seq, body = inner.prepare_push(part)
            try:
                self._drain_pending(i)
                inner.push_encoded(seq, body)
            except _WIRE_ERRORS as e:
                self._park(i, seq, body, e)
                paused.append(i)
        if paused:
            logger.warning(
                "update parked on paused shard(s) %s — other shards "
                "applied their slices; flush() will confirm delivery",
                paused,
            )

    def flush(self) -> None:
        """Strict delivery confirmation across every shard: replay all
        parked pushes and drain every pipelined ack. Raises (listing
        the shards) if any shard is still unreachable — callers that
        must not lose updates (the worker before reporting a partition
        done) run this under their supervised retry; shards flushed on
        an earlier attempt are cheap no-ops on the next."""
        errors = []
        for i, inner in enumerate(self._parts):
            try:
                self._drain_pending(i)
                inner.flush()
            except _WIRE_ERRORS as e:
                errors.append((i, e))
        if errors:
            raise ConnectionError(
                "flush incomplete on shard(s) "
                + ", ".join(
                    f"{i} ({self.endpoints[i]}): {e!r}" for i, e in errors
                )
            )

    def heartbeat(self) -> None:
        """Best-effort lease refresh on every reachable shard (liveness
        is advisory; a dead shard's lease staying stale is exactly what
        its membership view should show)."""
        for i, inner in enumerate(self._parts):
            try:
                inner.heartbeat()
            except _WIRE_ERRORS as e:
                logger.debug(
                    "heartbeat to shard %d failed (non-fatal): %r", i, e
                )

    def status(self) -> list[dict]:
        """Per-shard status JSON, in shard order."""
        return [p.status() for p in self._parts]

    def close(self) -> None:
        parked = sum(self.pending_counts)
        if parked:
            logger.warning(
                "close() with %d parked push(es) on paused shards %s — "
                "call flush() before close() for confirmed delivery",
                parked,
                [i for i, n in enumerate(self.pending_counts) if n],
            )
        for p in self._parts:
            if hasattr(p, "close"):
                p.close()
