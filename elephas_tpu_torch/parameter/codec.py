"""Binary wire codec for parameter-server sync: the port's copy of
``elephas_tpu.parameter.codec``, byte for byte on the wire.

The upstream elephas transports pickle the full weight list on every get/update
(SURVEY.md §3.2 — its main scalability cliff). This codec replaces that
with a versioned, dtype-preserving frame stream:

- **meta frame**: magic/version/flags plus each tensor's dtype and shape
  (dtypes round-trip exactly — including ``bfloat16`` via ml_dtypes —
  fixing the float32-only caveat of the native store's wire format);
- **data frames**: per-chunk payloads, so neither encoder nor decoder
  ever materializes more than one chunk beyond the tensors themselves
  (``chunk_bytes`` bounds peak transient memory);
- **int8 quantization** (optional): per-chunk symmetric scale, with
  worker-side error-feedback residuals (:class:`ErrorFeedback`) so the
  quantization error of pushed deltas re-enters the next push instead
  of accumulating as bias — Deep Gradient Compression (Lin et al.,
  2018) / 1-bit SGD style;
- **top-k delta sparsification** (optional): only the largest-magnitude
  ``topk`` fraction of each float tensor's delta ships (indices +
  values, values optionally int8); the dropped mass feeds back through
  the same residuals.

Integer tensors always travel raw (quantizing a step counter corrupts
it); sub-f32 floats quantize via an exact f32 upcast. No pickle
anywhere in this module — the frame stream is pure struct/numpy. The
port's own weights are float32 on the wire (Keras's ``get_weights()``);
``ml_dtypes`` is imported only to decode a ``bfloat16`` frame that
another sender wrote.
"""

from __future__ import annotations

import struct
from typing import Callable, Iterator

import numpy as np

MAGIC = b"EPSC"
VERSION = 1

FLAG_INT8 = 1
FLAG_TOPK = 2

KIND_RAW = 0
KIND_Q8 = 1
KIND_TOPK = 2

_META_HEAD = struct.Struct("<4sBBH")  # magic, version, flags, ntensors
_FRAME_LEN = struct.Struct("<I")
_RAW_HEAD = struct.Struct("<BHQ")  # kind, tensor_idx, byte_offset
_Q8_HEAD = struct.Struct("<BHQIf")  # kind, tensor_idx, elem_offset, n, scale
_TOPK_HEAD = struct.Struct("<BHIBf")  # kind, tensor_idx, k, quantized?, scale

COMPRESSIONS = ("none", "int8")


def _named_dtype(name: str) -> np.dtype:
    """dtype from its ``.name`` — imports ml_dtypes lazily for bf16 etc."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes  # noqa: F401  (registers bfloat16 & friends)

        return np.dtype(name)


def _is_floatlike(dtype: np.dtype) -> bool:
    """Floats as far as quantization is concerned — ``np.issubdtype``
    says False for ml_dtypes' bfloat16, but it embeds exactly in f32."""
    return np.issubdtype(dtype, np.floating) or dtype.name == "bfloat16"


def _quantize(chunk_f32: np.ndarray) -> tuple[float, np.ndarray]:
    """Symmetric per-chunk int8: ``scale = max|x|/127``; an all-zero
    chunk keeps scale 0 (decoder multiplies by 0 — exact)."""
    peak = float(np.max(np.abs(chunk_f32))) if chunk_f32.size else 0.0
    if peak == 0.0:
        return 0.0, np.zeros(chunk_f32.shape, np.int8)
    scale = peak / 127.0
    q = np.clip(np.rint(chunk_f32 / scale), -127, 127).astype(np.int8)
    return scale, q


class ErrorFeedback:
    """Worker-side residual store for lossy pushes.

    ``compensate`` folds the accumulated residual into the outgoing
    delta; the codec then records what the receiver will actually
    decode, and ``absorb`` keeps the difference for the next round —
    so compression error is delayed, never lost (DGC-style).
    """

    def __init__(self):
        self._residuals: list[np.ndarray] | None = None

    def compensate(self, tensors: list[np.ndarray]) -> list[np.ndarray]:
        if self._residuals is None:
            self._residuals = [
                np.zeros(np.asarray(t).shape, np.float32) for t in tensors
            ]
        if len(self._residuals) != len(tensors):
            raise ValueError(
                f"error-feedback state holds {len(self._residuals)} "
                f"tensors, got {len(tensors)}"
            )
        return [
            np.asarray(t, np.float32) + r
            for t, r in zip(tensors, self._residuals)
        ]

    def absorb(self, compensated: list[np.ndarray], decoded: list[np.ndarray]):
        self._residuals = [
            np.asarray(c, np.float32) - np.asarray(d, np.float32)
            for c, d in zip(compensated, decoded)
        ]


class WireCodec:
    """Encode/decode a weight list as a self-delimiting frame stream.

    ``compression='int8'`` quantizes float payload chunks;
    ``topk`` (a fraction in (0, 1]) keeps only the largest-magnitude
    entries of each float tensor — meant for *deltas*, where most mass
    concentrates in few coordinates. Both are lossy: pair pushes with
    an :class:`ErrorFeedback` so the loss re-enters later rounds.
    """

    def __init__(
        self,
        compression: str = "none",
        topk: float | None = None,
        chunk_bytes: int = 1 << 20,
    ):
        if compression not in COMPRESSIONS:
            raise ValueError(
                f"compression must be one of {COMPRESSIONS}, got "
                f"{compression!r}"
            )
        if topk is not None and not (0.0 < topk <= 1.0):
            raise ValueError(f"topk must be in (0, 1], got {topk!r}")
        self.compression = compression
        self.topk = topk
        self.chunk_bytes = max(4096, int(chunk_bytes))

    # -- encoding ------------------------------------------------------

    def _flags(self) -> int:
        return (FLAG_INT8 if self.compression == "int8" else 0) | (
            FLAG_TOPK if self.topk is not None else 0
        )

    def encode_frames(
        self, tensors, feedback: ErrorFeedback | None = None
    ) -> Iterator[bytes]:
        """Yield the frame stream as byte-like pieces (``bytes`` or
        zero-copy ``memoryview`` for raw tensor payloads); a zero-length
        frame terminates. Pieces are a byte STREAM, not one-per-frame —
        consumers concatenate or stream them as-is.

        With ``feedback``, the tensors are treated as a lossy *delta*:
        residuals are folded in first and the post-decode error is
        absorbed back as the frames are produced (no decode pass).
        """
        # ascontiguousarray alone would promote 0-d arrays to 1-d
        arrays = [
            np.ascontiguousarray(np.asarray(t)).reshape(np.shape(t))
            for t in tensors
        ]
        if feedback is not None and (self._flags()):
            compensated = feedback.compensate(arrays)
            decoded_acc: list[np.ndarray] = []
        else:
            feedback = None
            compensated = None

        meta = [_META_HEAD.pack(MAGIC, VERSION, self._flags(), len(arrays))]
        for a in arrays:
            name = a.dtype.name.encode("ascii")
            meta.append(struct.pack("<B", len(name)) + name)
            meta.append(struct.pack("<B", a.ndim))
            meta.append(struct.pack(f"<{a.ndim}I", *a.shape))
        yield self._frame(b"".join(meta))

        for idx, a in enumerate(arrays):
            lossy = self._flags() and _is_floatlike(a.dtype)
            src = compensated[idx] if (feedback is not None and lossy) else a
            if not lossy:
                yield from self._raw_frames(idx, a)
                if feedback is not None:
                    # raw tensors decode exactly; zero residual
                    decoded_acc.append(np.asarray(a, np.float32))
                continue
            flat = np.asarray(src, np.float32).ravel()
            if self.topk is not None:
                frame, dec = self._topk_frame(idx, flat)
                yield frame
            else:
                frames, dec = self._q8_frames(idx, flat)
                yield from frames
            if feedback is not None:
                decoded_acc.append(dec.reshape(a.shape))
        if feedback is not None:
            feedback.absorb(compensated, decoded_acc)
        yield _FRAME_LEN.pack(0)

    def encode(self, tensors, feedback: ErrorFeedback | None = None) -> bytes:
        return b"".join(self.encode_frames(tensors, feedback))

    @staticmethod
    def _frame(payload: bytes) -> bytes:
        return _FRAME_LEN.pack(len(payload)) + payload

    def _raw_frames(self, idx: int, a: np.ndarray) -> Iterator[bytes]:
        if a.nbytes == 0:
            yield self._frame(_RAW_HEAD.pack(KIND_RAW, idx, 0))
            return
        # zero-copy payloads: the chunk rides as a memoryview of the
        # array itself — the transport writes it straight to the socket
        raw = memoryview(a.reshape(-1).view(np.uint8))
        for off in range(0, a.nbytes, self.chunk_bytes):
            chunk = raw[off : off + self.chunk_bytes]
            yield _FRAME_LEN.pack(_RAW_HEAD.size + len(chunk)) + _RAW_HEAD.pack(
                KIND_RAW, idx, off
            )
            yield chunk

    def _q8_frames(
        self, idx: int, flat_f32: np.ndarray
    ) -> tuple[list[bytes], np.ndarray]:
        frames, dec = [], np.empty(flat_f32.size, np.float32)
        step = max(1, self.chunk_bytes)  # elems per chunk (1B each on wire)
        if flat_f32.size == 0:
            frames.append(
                self._frame(_Q8_HEAD.pack(KIND_Q8, idx, 0, 0, 0.0))
            )
            return frames, dec
        for off in range(0, flat_f32.size, step):
            chunk = flat_f32[off : off + step]
            scale, q = _quantize(chunk)
            frames.append(
                self._frame(
                    _Q8_HEAD.pack(KIND_Q8, idx, off, chunk.size, scale)
                    + q.tobytes()
                )
            )
            dec[off : off + step] = q.astype(np.float32) * scale
        return frames, dec

    def _topk_frame(
        self, idx: int, flat_f32: np.ndarray
    ) -> tuple[bytes, np.ndarray]:
        n = flat_f32.size
        dec = np.zeros(n, np.float32)
        quantized = 1 if self.compression == "int8" else 0
        if n == 0:
            return (
                self._frame(_TOPK_HEAD.pack(KIND_TOPK, idx, 0, quantized, 0.0)),
                dec,
            )
        k = max(1, int(np.ceil(self.topk * n)))
        if k >= n:
            sel = np.arange(n, dtype=np.uint32)
        else:
            sel = np.argpartition(np.abs(flat_f32), n - k)[n - k :].astype(
                np.uint32
            )
        vals = flat_f32[sel]
        if quantized:
            scale, q = _quantize(vals)
            payload = sel.tobytes() + q.tobytes()
            dec[sel] = q.astype(np.float32) * scale
        else:
            scale = 0.0
            payload = sel.tobytes() + vals.astype("<f4").tobytes()
            dec[sel] = vals
        return (
            self._frame(
                _TOPK_HEAD.pack(KIND_TOPK, idx, int(k), quantized, scale)
                + payload
            ),
            dec,
        )


# -- decoding ------------------------------------------------------------


def decode_stream(
    read_exact: Callable[[int], bytes],
    readinto: Callable | None = None,
) -> list[np.ndarray]:
    """Decode one frame stream into a weight list.

    ``read_exact(n)`` must return exactly ``n`` bytes (socket loop, HTTP
    body reader, ...). With ``readinto(memoryview) -> int`` raw tensor
    payloads land directly in the output arrays (zero-copy receive).
    Memory stays bounded at the output tensors plus one frame.
    """
    meta = _read_frame(read_exact)
    if meta is None:
        raise ConnectionError("codec stream ended before the meta frame")
    if len(meta) < _META_HEAD.size:
        raise ValueError("codec meta frame truncated")
    magic, version, _flags, ntensors = _META_HEAD.unpack_from(meta, 0)
    if magic != MAGIC:
        raise ValueError(f"bad codec magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"unsupported codec version {version}")
    off = _META_HEAD.size
    out: list[np.ndarray] = []
    for _ in range(ntensors):
        (nlen,) = struct.unpack_from("<B", meta, off)
        off += 1
        dtype = _named_dtype(meta[off : off + nlen].decode("ascii"))
        off += nlen
        (ndim,) = struct.unpack_from("<B", meta, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}I", meta, off)
        off += 4 * ndim
        out.append(np.zeros(shape, dtype))

    while True:
        (length,) = _FRAME_LEN.unpack(read_exact(_FRAME_LEN.size))
        if length == 0:
            return out
        head = read_exact(min(length, _RAW_HEAD.size))
        if head and head[0] == KIND_RAW and length > _RAW_HEAD.size:
            _, idx, byte_off = _RAW_HEAD.unpack(head)
            n = length - _RAW_HEAD.size
            target = out[idx]
            # reshape before the u8 view: a 0-d array can't re-dtype
            dest = memoryview(target.reshape(-1).view(np.uint8))[
                byte_off : byte_off + n
            ]
            if readinto is not None:
                _readinto_exact(readinto, dest)
            else:
                dest[:] = read_exact(n)
        else:
            _apply_frame(head + read_exact(length - len(head)), out)


def _readinto_exact(readinto, dest: memoryview) -> None:
    while len(dest):
        got = readinto(dest)
        if not got:
            raise ConnectionError("peer closed mid-frame")
        dest = dest[got:]


def decode(data: bytes) -> list[np.ndarray]:
    view, pos = memoryview(data), [0]

    def read_exact(n: int) -> bytes:
        chunk = view[pos[0] : pos[0] + n]
        if len(chunk) != n:
            raise ConnectionError("codec buffer truncated")
        pos[0] += n
        return bytes(chunk)

    return decode_stream(read_exact)


def _read_frame(read_exact) -> bytes | None:
    (length,) = _FRAME_LEN.unpack(read_exact(_FRAME_LEN.size))
    if length == 0:
        return None
    return read_exact(length)


def _apply_frame(frame: bytes, out: list[np.ndarray]) -> None:
    kind = frame[0]
    if kind == KIND_RAW:
        _, idx, byte_off = _RAW_HEAD.unpack_from(frame, 0)
        payload = frame[_RAW_HEAD.size :]
        target = out[idx]
        if payload:
            # reshape before the u8 view: a 0-d array can't re-dtype
            flat = target.reshape(-1).view(np.uint8)
            flat[byte_off : byte_off + len(payload)] = np.frombuffer(
                payload, np.uint8
            )
    elif kind == KIND_Q8:
        _, idx, elem_off, n, scale = _Q8_HEAD.unpack_from(frame, 0)
        q = np.frombuffer(frame, np.int8, count=n, offset=_Q8_HEAD.size)
        target = out[idx]
        vals = (q.astype(np.float32) * scale).astype(target.dtype)
        target.reshape(-1)[elem_off : elem_off + n] = vals
    elif kind == KIND_TOPK:
        _, idx, k, quantized, scale = _TOPK_HEAD.unpack_from(frame, 0)
        base = _TOPK_HEAD.size
        sel = np.frombuffer(frame, np.uint32, count=k, offset=base)
        base += 4 * k
        if quantized:
            q = np.frombuffer(frame, np.int8, count=k, offset=base)
            vals = q.astype(np.float32) * scale
        else:
            vals = np.frombuffer(frame, "<f4", count=k, offset=base)
        target = out[idx]
        target.reshape(-1)[sel] = vals.astype(target.dtype)
    else:
        raise ValueError(f"unknown codec frame kind {kind}")
