"""Parameter-server journal: crash-recoverable weights + sequence table.

A journaled server periodically snapshots its
entire recoverable state — the master weights AND the per-client
sequence table — into ONE file, written atomically
(:func:`elephas_tpu_torch.utils.checkpoint.atomic_write`: temp + fsync +
``os.replace``), so a server killed mid-write replays the previous
intact snapshot and a resent update that was already journaled is still
deduplicated after the restart.

On-disk format, version 1 (a single self-contained file)::

    magic   b"EPSJ"                     4 bytes
    version u8                          1 byte
    mlen    u32 LE                      4 bytes
    meta    JSON (utf-8)                mlen bytes
    frames  WireCodec dense stream      (dtype-preserving, bf16 incl.)

``meta`` carries ``{"seq": {client_id: last_applied_seq}, ...}`` plus
anything the caller adds (mode, update counters). Weights ride the same
binary codec as the wire (:mod:`elephas_tpu_torch.parameter.codec`), so every
dtype that syncs also journals, bit-exactly. No pickle anywhere.

The journal is deliberately a snapshot, not a write-ahead log: updates
between the last snapshot and a crash are lost server-side (workers
re-pull the rolled-back weights and training continues — async/hogwild
tolerate that statistically), while the sequence table guarantees that
an update journaled as applied can never be applied twice by a
post-restart resend. ``journal_every`` trades snapshot I/O for the
width of that loss window.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import struct

import numpy as np

from elephas_tpu_torch.parameter import codec as wire
from elephas_tpu_torch.utils.checkpoint import atomic_write

JOURNAL_MAGIC = b"EPSJ"
JOURNAL_VERSION = 1
JOURNAL_NAME = "ps-journal.bin"

_HEAD = struct.Struct("<4sBI")  # magic, version, meta byte length

logger = logging.getLogger(__name__)


def journal_path(directory: str) -> str:
    return os.path.join(directory, JOURNAL_NAME)


def clean_orphaned_tmp(directory: str) -> int:
    """Remove ``atomic_write`` temp files a crash left behind.
    ``atomic_write`` is torn-write safe — a kill between
    the tmp write and the ``os.replace`` leaves the previous journal
    intact — but the orphaned ``.tmp-ps-journal.bin-*`` file itself
    stays on disk forever, and a chaos-restart loop accumulates one per
    crash. Called on every :func:`load_journal` (i.e. every recovery);
    returns how many orphans were removed. Unlink races (two shards'
    recoveries sharing a directory) are tolerated."""
    removed = 0
    for tmp in glob.glob(
        os.path.join(directory, ".tmp-" + JOURNAL_NAME + "-*")
    ):
        try:
            os.unlink(tmp)
            removed += 1
        except FileNotFoundError:
            continue  # a concurrent recovery won the unlink
    if removed:
        logger.warning(
            "removed %d orphaned journal temp file(s) under %s (left "
            "by a crash mid-snapshot; the journal itself is intact)",
            removed, directory,
        )
    return removed


def save_journal(
    directory: str,
    weights,
    seq_table: dict[str, int] | None = None,
    meta: dict | None = None,
) -> str:
    """Atomically snapshot ``weights`` + ``seq_table`` under
    ``directory``; returns the journal path."""
    meta = dict(meta or {})
    meta["seq"] = {str(k): int(v) for k, v in (seq_table or {}).items()}
    meta_bytes = json.dumps(meta).encode("utf-8")
    payload = b"".join(
        (
            _HEAD.pack(JOURNAL_MAGIC, JOURNAL_VERSION, len(meta_bytes)),
            meta_bytes,
            wire.WireCodec().encode([np.asarray(w) for w in weights]),
        )
    )
    return atomic_write(journal_path(directory), payload)


def load_journal(directory: str):
    """Load the journal under ``directory``.

    Returns ``(weights, seq_table, meta)``, or ``None`` when no journal
    exists. A corrupt or future-versioned journal raises ``ValueError``
    loudly — silently restarting from initial weights when an operator
    expected recovery is the one unacceptable outcome.
    """
    path = journal_path(directory)
    if os.path.isdir(directory):
        clean_orphaned_tmp(directory)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEAD.size:
        raise ValueError(f"journal {path} truncated ({len(data)} bytes)")
    magic, version, mlen = _HEAD.unpack_from(data, 0)
    if magic != JOURNAL_MAGIC:
        raise ValueError(f"journal {path}: bad magic {magic!r}")
    if version != JOURNAL_VERSION:
        raise ValueError(
            f"journal {path}: unsupported version {version} "
            f"(this build reads version {JOURNAL_VERSION})"
        )
    body = _HEAD.size
    if len(data) < body + mlen:
        raise ValueError(f"journal {path}: meta truncated")
    try:
        meta = json.loads(data[body : body + mlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"journal {path}: corrupt meta block") from e
    try:
        weights = wire.decode(data[body + mlen :])
    except (ConnectionError, ValueError, struct.error) as e:
        raise ValueError(f"journal {path}: corrupt weight frames") from e
    seq_table = {str(k): int(v) for k, v in (meta.pop("seq", {}) or {}).items()}
    return weights, seq_table, meta
