"""Socket primitives: master discovery, hardened framing, retries.

Reference surface: ``[U] elephas/utils/sockets.py`` — ``determine_master``,
``send``, ``receive``. Used by the parameter server/client
(:mod:`elephas_tpu_torch.parameter`).

Every read loops until the exact byte count arrives
(short reads), ``sendall`` covers short writes, connections get
connect/read timeouts, and :func:`retry_call` gives the clients capped
exponential backoff on transient errors. The pickled ``send``/``receive``
pair remains only as the negotiated legacy fallback — the hot path is
the binary codec (:mod:`elephas_tpu_torch.parameter.codec`).
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import time

_LEN = struct.Struct(">Q")

# connect/read deadlines for parameter-sync sockets: long enough for a
# multi-hundred-MB weight pull over DCN, short enough that a dead peer
# fails the worker instead of hanging it
CONNECT_TIMEOUT = 10.0
IO_TIMEOUT = 120.0

# chaos-injection hook (:mod:`elephas_tpu_torch.fault`): when set,
# called as ``hook(op)`` with ``op in ('connect', 'send', 'recv')`` at
# the head of every socket primitive below. The hook may sleep (delay
# injection), raise ``ConnectionError`` (drop/sever injection), or
# no-op. Production code never sets it; the fault harness installs a
# deterministic, seeded plan through :func:`set_fault_hook`.
_FAULT_HOOK = None


def set_fault_hook(hook):
    """Install (or clear, with None) the chaos hook; returns the
    previous hook so harnesses can restore it."""
    global _FAULT_HOOK
    previous = _FAULT_HOOK
    _FAULT_HOOK = hook
    return previous


def _fault(op: str) -> None:
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(op)


def determine_master(port: int = 4000) -> str:
    """Resolve the coordinator host:port.

    Order mirrors the reference (env override, then hostname lookup) with
    the JAX-world env names first.
    """
    host = (
        os.environ.get("ELEPHAS_MASTER_IP")
        or os.environ.get("SPARK_LOCAL_IP")
        or _local_ip()
    )
    return f"{host}:{port}"


def _local_ip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def connect(
    host: str,
    port: int,
    connect_timeout: float = CONNECT_TIMEOUT,
    io_timeout: float = IO_TIMEOUT,
) -> socket.socket:
    """TCP connection with a connect deadline, a read/write deadline,
    and Nagle off (sync round-trips are latency-bound)."""
    _fault("connect")
    sock = socket.create_connection((host, port), timeout=connect_timeout)
    sock.settimeout(io_timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def retry_call(
    fn,
    *,
    retries: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: tuple = (ConnectionError, TimeoutError, OSError),
    on_retry=None,
):
    """``fn()`` with capped exponential backoff on transient errors.

    ``on_retry(attempt, exc)`` runs before each re-attempt (clients use
    it to reconnect a broken socket). The last failure propagates.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            time.sleep(delay * (0.5 + random.random() / 2))  # jittered
            if on_retry is not None:
                on_retry(attempt, e)


def send_frames(sock: socket.socket, frames, coalesce: int = 1 << 18) -> int:
    """Stream codec frame pieces, coalescing small ones (a per-piece
    ``sendall`` of tiny meta/terminator frames interacts badly with
    Nagle/delayed-ACK on the round-trip path) while passing large
    memoryview payloads straight through — zero copies for the bulk
    bytes. Returns total bytes written; peak buffering stays ~one
    coalesce window."""
    _fault("send")
    buf: list[bytes] = []
    size = total = 0
    for piece in frames:
        n = len(piece)
        if n >= coalesce:
            if buf:
                sock.sendall(b"".join(buf))
                total += size
                buf, size = [], 0
            sock.sendall(piece)
            total += n
            continue
        buf.append(bytes(piece) if isinstance(piece, memoryview) else piece)
        size += n
        if size >= coalesce:
            sock.sendall(b"".join(buf))
            total += size
            buf, size = [], 0
    if buf:
        sock.sendall(b"".join(buf))
        total += size
    return total


def send(sock: socket.socket, obj) -> int:
    """Send one length-prefixed pickled frame (legacy-pickle fallback).
    Returns the payload byte count (callers keep wire accounting)."""
    _fault("send")
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)
    return len(payload)


def receive(sock: socket.socket):
    """Receive one length-prefixed pickled frame (None on clean EOF).

    Legacy-pickle fallback — only speak this with trusted peers.
    """
    obj, _ = receive_with_size(sock)
    return obj


def receive_with_size(sock: socket.socket):
    """Like :func:`receive` but returns ``(obj, payload_bytes)``."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None, 0
    (length,) = _LEN.unpack(header)
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ConnectionError("peer closed mid-frame")
    return pickle.loads(payload), length  # legacy-pickle fallback path


def read_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly ``n`` bytes or ``ConnectionError`` — the strict variant
    the binary codec decodes through (EOF is never clean mid-message)."""
    buf = _recv_exact(sock, n)
    if buf is None:
        raise ConnectionError("peer closed mid-frame")
    return buf


def reader(sock: socket.socket):
    """``read_exact(n)`` closure for :func:`parameter.codec.decode_stream`."""
    return lambda n: read_exact(sock, n)


def reader_into(sock: socket.socket):
    """``readinto(memoryview) -> int`` closure — zero-copy receive for
    the codec's raw tensor payloads."""
    return sock.recv_into


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    _fault("recv")
    if n == 0:
        return b""
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if chunks:
                raise ConnectionError("peer closed mid-frame")
            return None  # clean EOF at a frame boundary
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
