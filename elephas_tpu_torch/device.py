"""Device choice for the port's entry points.

Counterpart of ``elephas_tpu/utils/backend_guard.py`` without its
fallback: the port runs on the GPU, and the CPU only when the caller
names it.
"""

from __future__ import annotations

import torch


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
