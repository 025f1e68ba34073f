"""ctypes bindings for the native (C++) parameter-server weight store.

Same public surface as the pure-Python servers/clients in
:mod:`elephas_tpu_torch.parameter.server`/``client`` (get/update/set, start/
stop), but the store, the update loop, and the wire format are native:
raw float32 buffers over TCP, in-place vectorized adds, a mutex for
``asynchronous`` mode and none for ``hogwild`` — the reference's
semantics without the reference's pickle tax.

The C++ source is the package's own copy, ``csrc/ps_server.cpp`` (the
reference's ``native/ps_server.cpp``, byte for byte). It compiles at first
use with the system ``g++`` into ``build/native/`` beside the package (a
directory ``.gitignore`` lists), named by a hash of the source and flags,
so a checkout builds what it needs and an edited source rebuilds. Without
``g++`` the server raises; nothing switches to another transport.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "ps_server.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lib = None
_lib_lock = threading.Lock()


def _lib_path() -> Path:
    """The library's path in :data:`BUILD_DIR`, keyed on the hash of the
    source and flags (an edited source never loads a stale binary)."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libeps-{platform.machine()}-{digest}.so"


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib_path = _lib_path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build beside the target, then rename: a concurrent process
            # sees no library or the whole one
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(
                    "native parameter server needs g++; use the Python "
                    "servers (parameter_server_mode='http'/'socket') instead"
                ) from e
            except subprocess.CalledProcessError as e:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"native build failed:\n{e.stderr}") from e
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.eps_server_create.restype = ctypes.c_void_p
        lib.eps_server_create.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ]
        lib.eps_server_port.restype = ctypes.c_int
        lib.eps_server_port.argtypes = [ctypes.c_void_p]
        lib.eps_server_set.restype = ctypes.c_int
        lib.eps_server_set.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ]
        lib.eps_server_get.restype = ctypes.c_int
        lib.eps_server_get.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ]
        lib.eps_server_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class _Flattener:
    """Weight list <-> one contiguous float32 vector.

    The wire/store format is float32 only; anything float32 can't carry
    exactly (float64, int tensors) is rejected loudly rather than
    silently rounded — the binary-codec Python servers
    (:mod:`elephas_tpu_torch.parameter.codec`) preserve those dtypes.
    ``float16``/``bfloat16`` embed exactly in float32, so they pass
    (the codec's float-likeness test covers bf16, which numpy's
    ``issubdtype`` does not recognize as floating).
    """

    def __init__(self, weights):
        from elephas_tpu_torch.parameter.codec import _is_floatlike

        self.shapes = [np.asarray(w).shape for w in weights]
        self.dtypes = [np.asarray(w).dtype for w in weights]
        bad = [
            str(d)
            for d in self.dtypes
            if not (_is_floatlike(d) and d.itemsize <= 4)
        ]
        if bad:
            raise ValueError(
                f"native parameter server stores float32 only; weight "
                f"dtypes {bad} would lose precision — use "
                f"parameter_server_mode='http' or 'socket' for this model"
            )
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.total = sum(self.sizes)

    def flatten(self, weights) -> np.ndarray:
        return np.concatenate(
            [np.asarray(w, dtype=np.float32).ravel() for w in weights]
        ) if weights else np.zeros(0, np.float32)

    def unflatten(self, flat: np.ndarray):
        out, offset = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            out.append(flat[offset : offset + size].reshape(shape).astype(dtype))
            offset += size
        return out


class NativeParameterServer:
    """Drop-in for ``HttpServer``/``SocketServer`` with a native core.

    ``journal_dir`` makes the store restartable — the weight
    vector snapshots through the shared journal format on ``stop()``
    and on :meth:`write_journal`, and a new server over the same
    directory replays it. The native wire has NO sequence IDs (the C++
    protocol carries raw f32 frames only), so resends can still
    double-apply here; use the Python servers when effectively-once
    matters. The journal's sequence table is therefore always empty.
    """

    def __init__(self, weights, mode: str = "asynchronous", port: int = 0,
                 journal_dir: str | None = None,
                 restore_journal: bool = True):
        self._lib = _load_library()
        self._flat = _Flattener(weights)
        use_lock = 0 if mode == "hogwild" else 1
        self._handle = self._lib.eps_server_create(
            self._flat.total, use_lock, port
        )
        if not self._handle:
            raise OSError(f"native parameter server failed to bind port {port}")
        self.port = self._lib.eps_server_port(self._handle)
        # telemetry identity: the native core has
        # no Python-visible update counters, but the store is still a
        # fleet member — it joins the same `server=` label family as
        # the Python servers with a pull-time store-size gauge, and
        # scrape() makes it readable by the aggregator like any other
        # transport
        from elephas_tpu_torch import telemetry

        reg = telemetry.registry()
        self._telemetry_registry = reg
        self.telemetry_label = telemetry.instance_label()
        total_bytes = float(self._flat.total * 4)  # f32 store
        reg.gauge(
            "elephas_ps_store_bytes",
            "Bytes held by the parameter-server weight store",
            labels=("server",),
        ).labels(server=self.telemetry_label).set(total_bytes)
        self.journal_dir = journal_dir
        self.restored_from_journal = False
        if journal_dir and restore_journal:
            from elephas_tpu_torch.parameter import journal as journal_io

            state = journal_io.load_journal(journal_dir)
            if state is not None:
                restored, _seq_table, _meta = state
                weights = restored  # shapes re-checked by set_weights
                self.restored_from_journal = True
        self.set_weights(weights)

    def write_journal(self) -> str | None:
        if not self.journal_dir:
            return None
        from elephas_tpu_torch.parameter import journal as journal_io

        return journal_io.save_journal(
            self.journal_dir, self.get_parameters(), {}, meta={"mode": "native"}
        )

    def start(self) -> None:  # the C++ accept loop starts at create
        pass

    def scrape(self, full: bool = False) -> str:
        """This server's ``server=``-labeled series as Prometheus
        exposition text (``full=True`` = the whole process registry) —
        scrape parity with the Python servers, so
        a FleetScraper can target any transport."""
        from elephas_tpu_torch import telemetry

        if full:
            return telemetry.render(self._telemetry_registry)
        return telemetry.render(
            self._telemetry_registry,
            only={"server": self.telemetry_label},
        )

    def release_telemetry(self) -> None:
        """Retire this server's labeled series (explicit-only, same
        contract as the Python servers')."""
        from elephas_tpu_torch import telemetry

        telemetry.remove_series(server=self.telemetry_label)

    def set_weights(self, weights) -> None:
        flat = np.ascontiguousarray(self._flat.flatten(weights))
        rc = self._lib.eps_server_set(
            self._handle,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            flat.size,
        )
        if rc != 0:
            raise ValueError(
                f"set_weights size mismatch: got {flat.size} floats, "
                f"server stores {self._flat.total}"
            )

    def get_parameters(self):
        flat = np.empty(self._flat.total, np.float32)
        rc = self._lib.eps_server_get(
            self._handle,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            flat.size,
        )
        if rc != 0:
            raise ValueError(
                f"get_parameters size mismatch: requested {flat.size} "
                f"floats, server stores {self._flat.total}"
            )
        return self._flat.unflatten(flat)

    def update_parameters(self, delta) -> None:
        client = NativeClient("127.0.0.1", self.port, self._flat)
        try:
            client.update_parameters(delta)
        finally:
            client.close()

    def stop(self) -> None:
        if self._handle:
            self.write_journal()  # terminal snapshot: clean stops resume
            self._lib.eps_server_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:  # fault-lint: allow — interpreter-teardown destructor
            pass


class NativeClient:
    """Binary-protocol client (usable against the C++ server from any
    host; carries a ``_Flattener`` built from the model's weight spec).

    Ops retry with capped backoff and reconnect on a
    dead socket (``utils.sockets.retry_call``), so a native-PS restart
    pauses the worker instead of killing it. The native wire has no
    sequence IDs — a retried update that did land double-applies (at-least-once
    delivery).
    """

    def __init__(self, host: str, port: int, flattener: _Flattener,
                 retries: int = 3):
        from elephas_tpu_torch.utils import sockets

        self._flat = flattener
        self._host, self._port = host, port
        self.retries = retries
        # hardened connect: deadline + NODELAY (utils.sockets)
        self._sock = sockets.connect(host, port)

    def _reconnect(self, *_args) -> None:
        from elephas_tpu_torch.utils import sockets

        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = sockets.connect(self._host, self._port)

    def _retry(self, fn):
        from elephas_tpu_torch.utils import sockets

        return sockets.retry_call(
            fn, retries=self.retries, on_retry=self._reconnect
        )

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("native PS connection closed")
            buf.extend(chunk)
        return bytes(buf)

    def get_parameters(self):
        def once():
            self._sock.sendall(b"g")
            (nbytes,) = struct.unpack("<Q", self._recv_exact(8))
            flat = np.frombuffer(self._recv_exact(nbytes), dtype=np.float32)
            return self._flat.unflatten(flat)

        return self._retry(once)

    def _send_buffer(self, op: bytes, weights) -> None:
        flat = np.ascontiguousarray(self._flat.flatten(weights))
        payload = op + struct.pack("<Q", flat.nbytes) + flat.tobytes()

        def once():
            self._sock.sendall(payload)
            if self._recv_exact(1) != b"k":
                raise ConnectionError("bad native update ack")

        self._retry(once)

    def update_parameters(self, delta) -> None:
        self._send_buffer(b"u", delta)

    def set_parameters(self, weights) -> None:
        self._send_buffer(b"s", weights)

    def close(self) -> None:
        try:
            self._sock.sendall(b"q")
        except OSError:
            pass
        self._sock.close()
