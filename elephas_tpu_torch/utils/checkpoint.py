"""Mid-training checkpoint and resume (counterpart of the data-parallel
half of ``elephas_tpu/utils/checkpoint.py``).

``SparkModel.fit(checkpoint_dir=..., resume=True)`` snapshots the master
module and its optimizer at epoch boundaries and resumes from the newest
snapshot. A snapshot is ``ckpt-<epoch:05d>.pt``, a ``torch.save`` of the
module's ``state_dict`` (BatchNorm's moving statistics included) and the
optimizer's, beside a ``ckpt-<epoch:05d>.json`` sidecar (``epoch``,
``history``) as the reference writes it. The reference's ``.keras``
archives are not read: the port has no Keras.

In a process gang the replicas are identical after every sync, so one
snapshot is the state: only the coordinator writes it, and every rank
waits at a barrier after (:func:`coordinator_writes`), so none resumes
from a snapshot still being written; every rank restores from it.
"""

from __future__ import annotations

import io
import json
import os
import re
import tempfile

import torch

SUFFIX = ".pt"
_CKPT_RE = re.compile(r"ckpt-(\d+)\.pt$")


def atomic_write(path: str, data: bytes) -> str:
    """Crash-safe byte write: temp file in the target directory, fsync,
    ``os.replace``. A process killed mid-write never leaves a torn file
    at ``path``: readers see either the old content or the new, whole."""
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=".tmp-" + os.path.basename(path) + "-"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"ckpt-{epoch:05d}{SUFFIX}")


def coordinator_writes(tag: str, write, *args) -> None:
    """``write(*args)`` on the gang's coordinator only (every process
    outside a gang), then a gang-wide barrier. The barrier is in a
    ``finally``: a failed write on the coordinator still releases the
    others (and then raises)."""
    from elephas_tpu_torch.parallel import distributed

    try:
        if distributed.is_coordinator():
            write(*args)
    finally:
        distributed.sync_global_devices(tag)


def save_checkpoint(model, directory: str, epoch: int, history: dict | None = None) -> str:
    """Snapshot ``model`` (with its optimizer's state) after ``epoch``
    epochs; in a gang, on the coordinator only (:func:`coordinator_writes`)."""
    path = checkpoint_path(directory, epoch)
    coordinator_writes(f"ckpt-save-{epoch}", _write_checkpoint, model, path, epoch, history)
    return path


def _write_checkpoint(model, path: str, epoch: int, history: dict | None) -> None:
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(),
                "optimizer": model.training_spec.optimizer.state_dict()}, buf)
    atomic_write(path, buf.getvalue())
    atomic_write(
        path[: -len(SUFFIX)] + ".json",
        json.dumps({"epoch": epoch, "history": history or {}}).encode(),
    )


def latest_checkpoint(directory: str) -> tuple[str, dict] | None:
    """Newest ``(path, meta)`` under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    best: tuple[int, str] | None = None
    for name in os.listdir(directory):
        m = _CKPT_RE.search(name)
        if m:
            epoch = int(m.group(1))
            if best is None or epoch > best[0]:
                best = (epoch, os.path.join(directory, name))
    if best is None:
        return None
    meta_path = best[1][: -len(SUFFIX)] + ".json"
    meta = {"epoch": best[0], "history": {}}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return best[1], meta


def restore_checkpoint(model, directory: str) -> dict | None:
    """Load the newest snapshot's weights, buffers and optimizer state into
    ``model``. Returns the checkpoint meta (``{'epoch': ..., 'history':
    ...}``) or None when no checkpoint exists."""
    found = latest_checkpoint(directory)
    if found is None:
        return None
    path, meta = found
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    model.training_spec.optimizer.load_state_dict(state["optimizer"])
    return meta
