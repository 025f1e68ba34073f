"""The process gang — counterpart of ``elephas_tpu/parallel/distributed.py``.

The reference joins one process a host into JAX's coordination service;
the port joins one process a card (a rank) into a ``torch.distributed``
process group over ``tcp://``: NCCL when the ranks run on ``cuda``, gloo
on the CPU. The same user script then runs on every rank (SPMD at the
process level), and ``SparkModel.fit`` spans every rank's workers
(:mod:`elephas_tpu_torch.device`).

Environment-driven as the reference is: ``ELEPHAS_COORDINATOR`` (host:port
of rank 0, or ``SPARK_LOCAL_IP`` and a port), ``ELEPHAS_NUM_PROCESSES``
and ``ELEPHAS_PROCESS_ID``. Without a coordinator :func:`initialize` stays
single-process and returns ``False``.

:data:`SLOTS_KEY` (``ELEPHAS_WORKER_SLOTS``) gives a rank its device and
its worker slots as ``"<slots>@<device>"``: ``"4@cpu"`` runs the rank on
the CPU with 4 worker slots (``device.force_devices(4)``; the launcher's
``--cpu-devices-per-process 4``), ``"2@cuda:1"`` on card 1 with 2 slots
(``--cuda-slots-per-process 2``). Without it a rank runs on
``cuda:{LOCAL_RANK}`` with one worker. The backend follows the device
(NCCL on ``cuda``, gloo on the CPU) unless ``ELEPHAS_DIST_BACKEND`` names
one (the launcher's ``--backend``): gloo over CUDA tensors is how several
ranks share one card, which NCCL refuses. Nothing changes device or
backend silently: a device that contradicts :data:`SLOTS_KEY`, or NCCL on
the CPU, raises.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from elephas_tpu_torch import device as _device

logger = logging.getLogger(__name__)

SLOTS_KEY = "ELEPHAS_WORKER_SLOTS"
BACKEND_KEY = "ELEPHAS_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")
# rank 0's group timeout: a rank that dies leaves the others in a
# collective until the launcher kills them
_TIMEOUT_S = 600


def determine_coordinator(port: int = 8476) -> str | None:
    """Coordinator address from the environment (the ``determine_master``
    analogue): ``ELEPHAS_COORDINATOR`` or ``SPARK_LOCAL_IP`` + port."""
    addr = os.environ.get("ELEPHAS_COORDINATOR")
    if addr:
        return addr if ":" in addr else f"{addr}:{port}"
    host = os.environ.get("SPARK_LOCAL_IP")
    if host:
        return f"{host}:{port}"
    return None


def parse_slots(value: str) -> tuple[int, torch.device]:
    """``"<slots>@<device>"`` (:data:`SLOTS_KEY`) → ``(slots, device)``."""
    slots, sep, dev = value.partition("@")
    if not sep or not slots.strip().isdigit() or int(slots) < 1:
        raise ValueError(
            f"{SLOTS_KEY} must read '<slots>@<device>', such as '4@cpu' or "
            f"'2@cuda:0', got {value!r}"
        )
    return int(slots), torch.device(dev.strip())


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Join the gang. Idempotent; a no-op without a coordinator.

    Returns True when running in a gang. Call once in every process,
    before any fit. ``device`` (default: :data:`SLOTS_KEY`'s device, else
    ``cuda:{LOCAL_RANK}``) is the rank's device from then on
    (:func:`elephas_tpu_torch.device.resolve_device`); the collectives run
    over ``ELEPHAS_DIST_BACKEND``, else NCCL on ``cuda`` and gloo on the
    CPU."""
    if _device.gang() is not None:
        return True
    coordinator_address = coordinator_address or determine_coordinator()
    if num_processes is None:
        num_processes = _env_int("ELEPHAS_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("ELEPHAS_PROCESS_ID")
    if coordinator_address is None:
        logger.info("no coordinator configured; staying single-process")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "a gang needs its size and this process's rank: set "
            "ELEPHAS_NUM_PROCESSES and ELEPHAS_PROCESS_ID (the launcher does)"
        )
    slots, slot_device = None, None
    if os.environ.get(SLOTS_KEY):
        slots, slot_device = parse_slots(os.environ[SLOTS_KEY])
    if device is None:
        device = slot_device or f"cuda:{_env_int('LOCAL_RANK') or 0}"
    dev = _device.resolve_device(device)
    if slot_device is not None and dev != slot_device:
        raise ValueError(
            f"initialize(device={device!r}) contradicts {SLOTS_KEY}="
            f"{os.environ[SLOTS_KEY]!r}"
        )
    backend = os.environ.get(BACKEND_KEY) or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend runs on cuda devices, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import datetime

    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=_TIMEOUT_S),
        **({"device_id": dev} if backend == "nccl" else {}),
    )
    _device.set_gang(_device.Gang(rank=int(process_id), size=int(num_processes), device=dev))
    if slots is not None:
        _device.force_devices(slots)
    logger.info("joined gang: rank %d/%d on %s over %s, %d workers", process_id,
                num_processes, dev, backend, _device.num_available_workers(dev))
    return True


def process_count() -> int:
    g = _device.gang()
    return 1 if g is None else g.size


def process_index() -> int:
    g = _device.gang()
    return 0 if g is None else g.rank


def is_coordinator() -> bool:
    return process_index() == 0


def backend() -> str | None:
    """The gang's backend, or None outside a gang."""
    return dist.get_backend() if _device.gang() is not None else None


def sync_global_devices(tag: str = "barrier") -> None:
    """Gang-wide barrier (``dist.barrier``); a no-op outside a gang."""
    g = _device.gang()
    if g is None:
        return
    logger.debug("barrier %s", tag)
    if backend() == "nccl":
        dist.barrier(device_ids=[g.device.index])
    else:
        dist.barrier()


def broadcast_from_coordinator(obj):
    """Rank 0's host value on every rank (``broadcast_object_list``): the
    broadcast-variable analogue for configs and initial weights."""
    if _device.gang() is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``t`` (``[k, ...]``, the same shape on every rank) from every rank,
    concatenated in rank order: ``[P·k, ...]`` on ``t``'s device; ``t``
    itself outside a gang. Exact (a copy, no arithmetic). Gloo gathers
    only host tensors, so a CUDA tensor under gloo is staged through host
    memory explicitly; NCCL gathers only CUDA tensors, so a host tensor
    under NCCL goes through the rank's card."""
    g = _device.gang()
    if g is None:
        return t
    t = t.contiguous()
    if backend() == "nccl":
        on_card = t.to(g.device)
        out = on_card.new_empty((g.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, on_card)
        return out.to(t.device)
    host = t.cpu()
    parts = [torch.empty_like(host) for _ in range(g.size)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(t.device)
