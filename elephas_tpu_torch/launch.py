"""Process launcher — the ``spark-submit`` analogue for a gang of ranks.

Counterpart of ``elephas_tpu/launch.py``. One Python process a card (a
rank) joins a ``torch.distributed`` gang
(:mod:`elephas_tpu_torch.parallel.distributed`) and runs the SAME user
script as every other rank: SPMD at the process level.

Two ways to use it:

1. A cluster: start the same script on every host yourself (or through
   your scheduler) with ``ELEPHAS_COORDINATOR=host0:port``,
   ``ELEPHAS_NUM_PROCESSES=N`` and ``ELEPHAS_PROCESS_ID=i`` exported, and
   call ``elephas_tpu_torch.parallel.distributed.initialize()`` first.

2. One machine: ``python -m elephas_tpu_torch.launch --num-processes 2
   script.py`` starts one rank a card (rank i on ``cuda:i``, NCCL).
   ``--cuda-slots-per-process N`` gives each rank N worker slots on its
   card, ``--ranks-per-card R`` puts R ranks on each card (then with
   ``--backend gloo``: NCCL refuses two ranks on one device), and
   ``--cpu-devices-per-process N`` runs every rank on the CPU with N
   worker slots over gloo (the tests' gang). Each reaches the ranks through
   one environment key, ``ELEPHAS_WORKER_SLOTS`` (``"<slots>@<device>"``),
   which ``initialize`` reads.

The launcher streams each child's output (prefixed) and exits non-zero if
any child fails — the same contract as ``spark-submit``.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time

from elephas_tpu_torch.parallel.distributed import BACKEND_KEY, BACKENDS, SLOTS_KEY


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(
    process_id: int,
    num_processes: int,
    coordinator: str,
    cpu_devices_per_process: int = 0,
    restart_from: str | None = None,
    attempt: int = 0,
    cuda_slots_per_process: int = 0,
    ranks_per_card: int = 1,
    backend: str | None = None,
) -> dict:
    """Environment for one gang member (the exported keys are the public
    launcher contract; see the module docstring)."""
    if cpu_devices_per_process and cuda_slots_per_process:
        raise ValueError(
            "cpu_devices_per_process and cuda_slots_per_process exclude each "
            "other: a gang runs on the CPU or on the cards"
        )
    if ranks_per_card < 1:
        raise ValueError(f"ranks_per_card must be >= 1, got {ranks_per_card}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    env = dict(os.environ)
    env["ELEPHAS_COORDINATOR"] = coordinator
    env["ELEPHAS_NUM_PROCESSES"] = str(num_processes)
    env["ELEPHAS_PROCESS_ID"] = str(process_id)
    if restart_from:
        env["ELEPHAS_CHECKPOINT_DIR"] = restart_from
    # scripts pass resume=ELEPHAS_RESUME=="1" straight through to fit();
    # a restore from an empty checkpoint dir is a fresh start, so "only on
    # restart" just keeps attempt 0's logs free of resume-probe noise
    env["ELEPHAS_RESTART_COUNT"] = str(attempt)
    env["ELEPHAS_RESUME"] = "1" if attempt else "0"
    card = process_id // ranks_per_card
    env["LOCAL_RANK"] = str(card)
    if cpu_devices_per_process:
        env[SLOTS_KEY] = f"{cpu_devices_per_process}@cpu"
    elif cuda_slots_per_process:
        env[SLOTS_KEY] = f"{cuda_slots_per_process}@cuda:{card}"
    else:
        env.pop(SLOTS_KEY, None)
    if backend:
        env[BACKEND_KEY] = backend
    else:
        env.pop(BACKEND_KEY, None)
    return env


def _run_gang_once(
    script: str,
    script_args: list[str] | None,
    num_processes: int,
    coordinator: str,
    cpu_devices_per_process: int,
    timeout: float | None,
    restart_from: str | None = None,
    attempt: int = 0,
    **env_options,
) -> int:
    """One gang generation: spawn, stream prefixed output, fail fast.

    On failure the FIRST child to exit non-zero kills the whole generation
    at once (the others would wait in a collective until the group's
    timeout), so the launcher can start everyone again promptly."""
    envs = [
        child_env(i, num_processes, coordinator, cpu_devices_per_process,
                  restart_from=restart_from, attempt=attempt, **env_options)
        for i in range(num_processes)
    ]
    procs = [
        subprocess.Popen(
            [sys.executable, script, *(script_args or [])],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for env in envs
    ]

    def stream(i: int, p: subprocess.Popen) -> None:
        for line in p.stdout:
            if not line.endswith("\n"):
                # an unterminated final line would merge with another
                # child's next line in the combined stream
                line += "\n"
            sys.stdout.write(f"[proc {i}] {line}")
            sys.stdout.flush()

    threads = [
        threading.Thread(target=stream, args=(i, p), daemon=True)
        for i, p in enumerate(procs)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout if timeout else None
    rcs = []
    try:
        while True:
            polled = [p.poll() for p in procs]
            if all(rc is not None for rc in polled):
                rcs = polled
                break
            failed = [i for i, rc in enumerate(polled) if rc not in (None, 0)]
            if failed:
                sys.stdout.write(
                    f"[launch] proc {failed[0]} exited rc={polled[failed[0]]}; "
                    f"killing the gang\n"
                )
                # the FIRST failing child's code is the gang's: the
                # siblings' -9 must not mask it
                rcs = [polled[failed[0]]]
                break
            if deadline and time.monotonic() > deadline:
                sys.stdout.write("[launch] gang timed out; killing children\n")
                rcs = [124]
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    for t in threads:
        t.join(timeout=5)
    return max(abs(rc) for rc in rcs) if rcs else 1


def launch(
    script: str,
    script_args: list[str] | None = None,
    num_processes: int = 2,
    coordinator: str | None = None,
    cpu_devices_per_process: int = 0,
    timeout: float | None = None,
    max_restarts: int = 0,
    restart_from: str | None = None,
    cuda_slots_per_process: int = 0,
    ranks_per_card: int = 1,
    backend: str | None = None,
) -> int:
    """Spawn the gang; stream prefixed output; return the gang's exit code
    (0, the first failing child's code, or 124 on ``timeout``).

    With ``max_restarts > 0`` the launcher is the failure-recovery loop the
    reference leaves to Spark (``spark.task.maxFailures``): any child's
    death kills the whole generation and a fresh gang starts, up to
    ``max_restarts`` times, with ``ELEPHAS_RESUME=1`` exported so the
    script's ``fit(checkpoint_dir=os.environ["ELEPHAS_CHECKPOINT_DIR"],
    resume=...)`` continues from the newest snapshot under
    ``restart_from``. Each generation gets a fresh coordinator port
    (unless pinned), so a half-dead group cannot wedge the next."""
    env_options = dict(cuda_slots_per_process=cuda_slots_per_process,
                       ranks_per_card=ranks_per_card, backend=backend)
    # refuse a contradictory configuration before any child starts
    child_env(0, num_processes, "127.0.0.1:0", cpu_devices_per_process, **env_options)
    for attempt in range(max_restarts + 1):
        rc = _run_gang_once(
            script, script_args, num_processes,
            coordinator or f"127.0.0.1:{free_port()}",
            cpu_devices_per_process, timeout,
            restart_from=restart_from, attempt=attempt, **env_options,
        )
        if rc == 0 or attempt == max_restarts:
            return rc
        sys.stdout.write(
            f"[launch] gang generation {attempt} failed (rc={rc}); "
            f"restarting ({attempt + 1}/{max_restarts})"
            + (f" from {restart_from}\n" if restart_from else "\n")
        )
        sys.stdout.flush()
    return rc


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m elephas_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default=None, help="host:port of rank 0")
    p.add_argument(
        "--cpu-devices-per-process", type=int, default=0,
        help="run every rank on the CPU with N worker slots (gloo)",
    )
    p.add_argument(
        "--cuda-slots-per-process", type=int, default=0,
        help="give every rank N worker slots on its card",
    )
    p.add_argument(
        "--ranks-per-card", type=int, default=1,
        help="ranks sharing each card (rank i runs on cuda:i // R); more "
             "than one needs --backend gloo",
    )
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="collectives' backend (default: nccl on cuda, gloo on the CPU)")
    p.add_argument("--timeout", type=float, default=None,
                   help="kill the gang after this many seconds (exit code 124)")
    p.add_argument(
        "--max-restarts", type=int, default=0,
        help="relaunch the whole gang up to N times after a child failure "
             "(elastic checkpoint-restart; pair with --restart-from)",
    )
    p.add_argument(
        "--restart-from", default=None, metavar="CKPT_DIR",
        help="checkpoint dir exported to children as ELEPHAS_CHECKPOINT_DIR; "
             "restarted generations also get ELEPHAS_RESUME=1 so fit() "
             "resumes from the newest snapshot",
    )
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    return launch(
        args.script,
        args.script_args,
        num_processes=args.num_processes,
        coordinator=args.coordinator,
        cpu_devices_per_process=args.cpu_devices_per_process,
        timeout=args.timeout,
        max_restarts=args.max_restarts,
        restart_from=args.restart_from,
        cuda_slots_per_process=args.cuda_slots_per_process,
        ranks_per_card=args.ranks_per_card,
        backend=args.backend,
    )


if __name__ == "__main__":
    sys.exit(main())
