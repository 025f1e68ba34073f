"""Device choice for the port's entry points.

Counterpart of ``elephas_tpu/utils/backend_guard.py`` without its
fallback: the port runs on the GPU, and the CPU only when the caller
names it.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


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
    """Workers the port can place on ``device``'s kind: the CUDA device
    count for ``cuda``, one for the CPU (counterpart of
    ``elephas_tpu/parallel/mesh.py::num_available_workers``)."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def worker_count(num_workers: int | None, device) -> int:
    """``num_workers`` clamped as the reference's ``worker_mesh`` clamps
    it: ``None`` or ``<= 0`` takes every available worker; more than
    there are is cut down, with the reference's warning."""
    available = num_available_workers(device)
    if num_workers is None or num_workers <= 0:
        return available
    if num_workers > available:
        logger.warning(
            "requested %d workers but only %d devices are addressable; "
            "clamping (mesh workers are physical devices, not task slots)",
            num_workers,
            available,
        )
        return available
    return num_workers
