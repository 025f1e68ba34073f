"""Device choice and worker placement for the port's entry points.

Counterpart of ``elephas_tpu/utils/backend_guard.py`` without its
fallback (the port runs on the GPU, and the CPU only when the caller
names it) and of ``elephas_tpu/parallel/mesh.py::num_available_workers``
/ ``worker_mesh``: the reference's workers are the devices of a
``('workers',)`` mesh, and :func:`force_devices` is the counterpart of
``force_cpu_devices``, which gives one host that many virtual devices.

In a process gang (:mod:`elephas_tpu_torch.parallel.distributed`, started
by ``python -m elephas_tpu_torch.launch``) the workers span the ranks: a
gang of P ranks with L worker slots each offers P·L workers, and rank r
owns the global workers ``[r·L, (r+1)·L)`` (:func:`local_worker_indices`,
the counterpart of ``MeshRunner._local_worker_indices``). Each rank runs
on its own device, ``cuda:{local rank}`` or the CPU, as the launcher
named it; :func:`resolve_device` gives that device to an entry point that
names none.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

_SEVERAL_CARDS = (
    "{} workers on {} CUDA devices in one process are not supported: start one "
    "rank a card with `python -m elephas_tpu_torch.launch` (each rank then "
    "drives its own card), or force_devices(n) to place n workers on cuda:0"
)
# worker slots offered by every device kind, set by force_devices (None:
# the physical devices)
_forced: int | None = None


@dataclass(frozen=True)
class Gang:
    """This process's place in a gang: its rank among ``size`` ranks and
    the device it runs on."""

    rank: int
    size: int
    device: torch.device


# set by distributed.initialize (None: one process)
_gang: Gang | None = None


def gang() -> Gang | None:
    """The gang this process joined, or None outside one."""
    return _gang


def set_gang(value: Gang | None) -> None:
    """Record (or, with None, forget) the gang this process joined; called
    by :func:`elephas_tpu_torch.parallel.distributed.initialize`."""
    global _gang
    _gang = value


def force_devices(n: int | None) -> int | None:
    """Offer ``n`` worker slots on the device kind the port runs on, all on
    the one physical device (the CPU, or ``cuda:0``; in a gang, each rank's
    own device), for this process; ``None`` goes back to the physical
    devices. Returns the previous value, so a caller can restore it. Off by
    default: unforced, :func:`worker_count` clamps to the physical devices
    as the reference does."""
    global _forced
    if n is not None and n < 1:
        raise ValueError(f"force_devices needs n >= 1, got {n}")
    previous, _forced = _forced, n
    return previous


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0`` (in a gang, the rank's own device); ``"cpu"``
    (or any explicit device) as asked.

    Raises ``RuntimeError`` when a CUDA device is wanted and CUDA is not
    available: there is no silent move to the CPU."""
    if device is None and _gang is not None:
        return _gang.device
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"elephas_tpu_torch runs on CUDA by default, and CUDA is not "
            f"available here (asked for {dev}); pass device='cpu' to run "
            f"the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"elephas_tpu_torch runs on cuda or cpu, not {dev}")
    return dev


def local_worker_slots(device) -> int:
    """Worker slots of this process on ``device``'s kind: the slots of
    :func:`force_devices` when forced; else one in a gang (one rank a
    card), the CUDA device count for ``cuda`` and one for the CPU."""
    if _forced is not None:
        return _forced
    if _gang is not None:
        return 1
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def num_available_workers(device) -> int:
    """Workers the port can place on ``device``'s kind: every rank's
    :func:`local_worker_slots` (counterpart of
    ``elephas_tpu/parallel/mesh.py::num_available_workers``, which counts
    the devices of every process)."""
    return local_worker_slots(device) * (_gang.size if _gang is not None else 1)


def local_worker_indices(num_workers: int) -> list[int]:
    """The global workers this process owns among ``num_workers``: all of
    them in one process, ``[r·L, (r+1)·L)`` on rank r of a gang whose
    ranks hold L workers each."""
    if _gang is None:
        return list(range(num_workers))
    if num_workers % _gang.size:
        raise ValueError(
            f"{num_workers} workers do not split over a gang of {_gang.size} ranks"
        )
    per = num_workers // _gang.size
    return list(range(_gang.rank * per, (_gang.rank + 1) * per))


def worker_count(num_workers: int | None, device, local: bool = False) -> int:
    """``num_workers`` clamped as the reference's ``worker_mesh`` clamps
    it: ``None`` or ``<= 0`` takes every available worker; more than
    there are is cut down, with the reference's warning. ``local`` counts
    this process's slots only (the hyperparameter search's trials are
    per-process work). More than one worker over several physical CUDA
    devices in one process raises ``NotImplementedError``: each card needs
    its own rank. In a gang, a fit spans every rank's workers, so a count
    the ranks do not share evenly raises ``ValueError``."""
    available = local_worker_slots(device) if local else num_available_workers(device)
    if num_workers is None or num_workers <= 0:
        count = available
    elif num_workers > available:
        logger.warning(
            "requested %d workers but only %d devices are addressable; "
            "clamping (mesh workers are physical devices, not task slots)",
            num_workers,
            available,
        )
        count = available
    else:
        count = num_workers
    if count > 1 and _forced is None and _gang is None:
        raise NotImplementedError(_SEVERAL_CARDS.format(count, available))
    if not local and _gang is not None and count != available:
        raise ValueError(
            f"a gang of {_gang.size} ranks trains on all of its {available} "
            f"workers; got num_workers={num_workers}"
        )
    return count
