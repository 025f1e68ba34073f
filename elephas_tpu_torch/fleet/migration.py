"""Cross-replica live-migration wire format: the port's copy of
``elephas_tpu/fleet/migration.py``, wire v3.

A preemption offload record (per-layer K/V block rows at the pool's
stored dtype, with the cursor that makes greedy resume a pure function)
is what travels: ``engine.export_request`` → :func:`encode_record` →
wire → :func:`decode_record` → ``engine.import_request`` on another
engine serving the same weights, which resumes bit-exact at
temperature 0. The bytes are the reference's, so records cross between
the two packages in both directions.

Layout (little-endian)::

    b"EMIG" | u16 version | u32 header_len | header JSON | array bytes

The header is the export payload minus the arrays: request identity
(rid, trace context), prompt and generated tokens, budget, sampling and
tenant knobs, the resume cursor state (``cur_len``, ``n_blocks``,
``block_size``), ``kv_dtype`` (so an importer refuses a dtype its arena
does not store before touching bytes), ``weight_ver`` (the weight
generation of the K/V; 0 is "cannot verify") and per-layer array specs
in sorted-name order. The arrays follow as raw bytes in that order, so
decoding is a reinterpretation: a bitwise round trip, and no pickle.

v1 (a fixed fp ``(k, v)`` pair a layer) and v2 (no ``weight_ver``)
records still decode; any other version is refused loudly. Cold records
(``n_blocks == 0``) carry no arrays: the target re-prefills.

Rows may be numpy arrays or host torch tensors. Dtype names resolve
through numpy; ``bfloat16``, which numpy lacks, travels as its 16-bit
pattern and decodes to a torch ``bfloat16`` tensor over the same bytes.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

__all__ = ["MAGIC", "VERSION", "encode_record", "decode_record"]

MAGIC = b"EMIG"
VERSION = 3

_HEAD = struct.Struct("<HI")  # version, header length


def _as_bytes(a) -> tuple[str, list, bytes]:
    """``(dtype name, shape, raw bytes)`` of one row array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy().tobytes()
        a = t.numpy()
    a = np.ascontiguousarray(a)
    return a.dtype.name, list(a.shape), a.tobytes()


def _from_bytes(mv, name: str, shape: tuple, off: int, layer: str):
    """One array of ``shape`` and dtype ``name`` read from ``mv`` at
    ``off``: a numpy view, or for ``bfloat16`` a torch tensor over the
    same bytes. Returns ``(array, bytes consumed)``."""
    count = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":
        need = 2 * count
        _check_room(mv, off, need, layer)
        bits = np.frombuffer(mv, dtype=np.int16, count=count, offset=off).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16), need
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"migration record array dtype {name!r} unknown") from None
    need = count * dt.itemsize
    _check_room(mv, off, need, layer)
    return np.frombuffer(mv, dtype=dt, count=count, offset=off).reshape(shape), need


def _check_room(mv, off, need, layer) -> None:
    if off + need > len(mv):
        raise ValueError(
            f"truncated migration record: layer {layer!r} needs {need} "
            f"more bytes"
        )


def encode_record(record: dict) -> bytes:
    """Serialize one engine export payload (the dict
    :meth:`~elephas_tpu_torch.serving.engine.InferenceEngine.export_request`
    returns) into the v3 wire format. Per-layer rows may be any tuple of
    arrays — fp ``(k, v)`` pairs or quantized ``(kq, vq, k_scale,
    v_scale)`` 4-tuples — and travel at their stored dtype."""
    rows = record.get("rows") or {}
    layers = []
    blobs: list[bytes] = []
    for name in sorted(rows):
        specs = []
        for a in rows[name]:
            dtype, shape, blob = _as_bytes(a)
            specs.append({"shape": shape, "dtype": dtype})
            blobs.append(blob)
        layers.append({"name": str(name), "arrays": specs})
    header = {key: val for key, val in record.items() if key != "rows"}
    header["version"] = VERSION
    header.setdefault("kv_dtype", "fp")
    # records of exporters that stamp no generation travel as 0 ("cannot
    # verify"), one shape for the importer's mismatch check
    header.setdefault("weight_ver", 0)
    header["layers"] = layers
    hb = json.dumps(header).encode("utf-8")
    out = bytearray(MAGIC)
    out += _HEAD.pack(VERSION, len(hb))
    out += hb
    for blob in blobs:
        out += blob
    return bytes(out)


def _layer_array_specs(version: int, spec: dict) -> list[dict]:
    """One layer's array specs in the v2/v3 ``arrays`` form (v1 had a
    fixed ``k_shape``/``v_shape`` pair)."""
    if version == 1:
        return [
            {"shape": spec["k_shape"], "dtype": spec["k_dtype"]},
            {"shape": spec["v_shape"], "dtype": spec["v_dtype"]},
        ]
    return list(spec["arrays"])


def decode_record(data) -> dict:
    """Parse wire bytes (v3, or legacy v1/v2) back into the engine's
    import payload. Raises ``ValueError`` on a bad magic, an unknown
    version, or a truncated or oversized array section: a torn migration
    must never resume as silent garbage. Legacy records come back with
    ``kv_dtype="fp"`` and ``weight_ver=0``."""
    mv = memoryview(data)
    if len(mv) < 4 + _HEAD.size or bytes(mv[:4]) != MAGIC:
        raise ValueError(
            "not a migration record (bad magic — expected EMIG)"
        )
    version, hlen = _HEAD.unpack_from(mv, 4)
    if version not in (1, 2, VERSION):
        raise ValueError(
            f"migration record version {version} unsupported (this "
            f"codec speaks v1..v{VERSION})"
        )
    off = 4 + _HEAD.size
    if off + hlen > len(mv):
        raise ValueError("truncated migration record header")
    try:
        header = json.loads(bytes(mv[off:off + hlen]).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt migration record header: {e}")
    off += hlen
    rows = {}
    for spec in header.pop("layers", []):
        arrs = []
        for aspec in _layer_array_specs(version, spec):
            shape = tuple(int(s) for s in aspec["shape"])
            arr, used = _from_bytes(mv, aspec["dtype"], shape, off, spec["name"])
            arrs.append(arr)
            off += used
        rows[spec["name"]] = tuple(arrs)
    if off != len(mv):
        raise ValueError(
            f"migration record carries {len(mv) - off} trailing "
            f"bytes — torn write or mismatched header"
        )
    header.setdefault("kv_dtype", "fp")
    header.setdefault("weight_ver", 0)
    header["rows"] = rows
    return header
