"""Chaos injection and fault-model primitives (counterpart of
``elephas_tpu/fault``).

``plan`` is the declarative side: deterministic, seedable
:class:`FaultPlan` objects describing PS crashes, wire faults,
duplicated update frames, and worker-partition loss. ``harness`` is the
executable side: :class:`RestartablePS`, :class:`PSKiller`, their sharded
siblings, and :func:`run_chaos_training`, which drive real servers and
workers under a plan; :class:`EngineStaller` (a serving engine that stops
stepping), :class:`ReplicaKiller` (a fleet replica killed mid-stream) and
:class:`DeployChaosStore` (a ledger publishing through a sharded store
whose shards can die mid-deployment).

The fault-tolerance machinery itself lives where the failures happen:
journaled restartable servers in :mod:`elephas_tpu_torch.parameter.server`,
sequence-ID idempotent clients in :mod:`elephas_tpu_torch.parameter.client`,
the supervised worker retry in :mod:`elephas_tpu_torch.worker`, and the
driver's failure budget in :mod:`elephas_tpu_torch.spark_model`, the
router's re-drive in :mod:`elephas_tpu_torch.fleet.router`. This package
only *injects* faults.
"""

from elephas_tpu_torch.fault.plan import (  # noqa: F401
    FaultBudgetExceeded,
    FaultPlan,
    SocketFaults,
    WorkerFault,
    active_plan,
    check_partition,
    use_plan,
)
from elephas_tpu_torch.fault.harness import (  # noqa: F401
    DeployChaosStore,
    EngineStaller,
    PSKiller,
    ReplicaKiller,
    RestartablePS,
    ShardKiller,
    ShardedRestartablePS,
    WatchdogPoller,
    measure_faults,
    measure_sharded_faults,
    run_chaos_training,
    run_elastic_membership,
    run_sharded_chaos_training,
)
