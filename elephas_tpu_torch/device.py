"""Device choice and worker placement for the port's entry points.

Counterpart of ``elephas_tpu/utils/backend_guard.py`` without its
fallback (the port runs on the GPU, and the CPU only when the caller
names it) and of ``elephas_tpu/parallel/mesh.py::num_available_workers``
/ ``worker_mesh``: the reference's workers are the devices of a
``('workers',)`` mesh, and :func:`force_devices` is the counterpart of
``force_cpu_devices``, which gives one host that many virtual devices.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)

_SEVERAL_CARDS_TODO = (
    "{} workers on {} CUDA devices are not ported yet (ROADMAP.md, Queue A "
    "item 9: several physical GPUs, one rank per card over torch.distributed); "
    "force_devices(n) places n workers on cuda:0"
)
# worker slots offered by every device kind, set by force_devices (None:
# the physical devices)
_forced: int | None = None


def force_devices(n: int | None) -> int | None:
    """Offer ``n`` worker slots on the device kind the port runs on, all on
    the one physical device (the CPU, or ``cuda:0``), for this process;
    ``None`` goes back to the physical devices. Returns the previous value,
    so a caller can restore it. Off by default: unforced,
    :func:`worker_count` clamps to the physical devices as the reference
    does."""
    global _forced
    if n is not None and n < 1:
        raise ValueError(f"force_devices needs n >= 1, got {n}")
    previous, _forced = _forced, n
    return previous


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``; ``"cpu"`` (or any explicit device) as asked.

    Raises ``RuntimeError`` when a CUDA device is wanted and CUDA is not
    available: there is no silent move to the CPU."""
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


def num_available_workers(device) -> int:
    """Workers the port can place on ``device``'s kind: the slots of
    :func:`force_devices` when forced, else the CUDA device count for
    ``cuda`` and one for the CPU (counterpart of
    ``elephas_tpu/parallel/mesh.py::num_available_workers``)."""
    if _forced is not None:
        return _forced
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def worker_count(num_workers: int | None, device) -> int:
    """``num_workers`` clamped as the reference's ``worker_mesh`` clamps
    it: ``None`` or ``<= 0`` takes every available worker; more than
    there are is cut down, with the reference's warning. More than one
    worker over several physical CUDA devices raises
    ``NotImplementedError``: each worker would need its own card."""
    available = num_available_workers(device)
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
    if count > 1 and _forced is None:
        raise NotImplementedError(_SEVERAL_CARDS_TODO.format(count, available))
    return count
