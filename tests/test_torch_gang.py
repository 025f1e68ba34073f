"""The port's process gang (``parallel/distributed.py``, ``launch.py``, the
gang's ``SparkModel`` and ``HyperParamModel``) on the CPU.

Gangs of real OS processes join over gloo through
``python -m elephas_tpu_torch.launch``'s ``launch()``, two ranks of 4 CPU
worker slots each, and their results are held to the one-process fit with
``force_devices(8)`` in this process: a gang's fit must be bit-identical
across ranks and bit-equal to the one-process fit (weights, history).
``tests/test_torch_workers.py`` holds that one-process fit to the JAX
``SparkModel`` over 8 devices, so the chain reaches the reference without
a JAX gang (the reference's own gang tests, ``tests/test_multihost.py``,
are ``slow``). Also: the launcher's environment against the reference's,
the gang's hyperparameter search, the elastic restart and the launcher's
exit codes.
"""

import contextlib
import io
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.launch import child_env as jax_child_env
from elephas_tpu_torch.device import force_devices, gang
from elephas_tpu_torch.launch import child_env, launch
from elephas_tpu_torch.parallel import distributed
from elephas_tpu_torch.parallel.distributed import SLOTS_KEY, parse_slots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [("synchronous", "epoch"), ("hogwild", "batch")]

# the same data and model on every rank (the SPMD contract), and in the
# one-process fit below
COMMON = textwrap.dedent(
    """
    import hashlib, json, os, sys
    import numpy as np
    import elephas_tpu_torch as et

    def data():
        rng = np.random.default_rng(7)
        return (rng.integers(0, 16, (100, 8)).astype(np.int32),
                rng.integers(0, 2, 100).astype(np.int32))

    def model():
        return et.transformer_classifier(vocab_size=16, maxlen=8, num_classes=2, d_model=16,
                                         num_heads=2, num_layers=1, seed=3, device="cpu")

    def digest(m):
        return hashlib.sha256(b"".join(p.detach().cpu().numpy().tobytes()
                                       for p in m.parameters())).hexdigest()
    """
)

FIT_SCRIPT = COMMON + textwrap.dedent(
    """
    from elephas_tpu_torch.parallel import distributed
    assert distributed.initialize(), "gang init failed"
    out = sys.argv[1]
    x, y = data()
    for i, (mode, frequency) in enumerate(MODES):
        m = model()
        sm = et.SparkModel(m, mode=mode, frequency=frequency, device="cpu")
        log = os.path.join(out, f"history-{i}.jsonl")
        h = sm.fit((x, y), epochs=2, batch_size=8, history_log=log,
                   checkpoint_dir=os.path.join(out, f"ckpt-{i}"))
        print("RESULT " + json.dumps({"rank": distributed.process_index(), "mode": mode,
                                      "workers": sm.num_workers, "digest": digest(m),
                                      "history": h}), flush=True)
    """
).replace("MODES", repr(MODES))

HPO_SCRIPT = COMMON + textwrap.dedent(
    """
    from elephas_tpu_torch.parallel import distributed
    assert distributed.initialize()
    from elephas_tpu_torch.hyperparam import HyperParamModel, choice, loguniform

    rng = np.random.default_rng(11)
    n, d, k = 160, 6, 2
    y = rng.integers(0, k, size=n)
    x = (y[:, None] * 2.0 + rng.normal(size=(n, d))).astype(np.float32)
    y = y.astype(np.int32)

    def build(params):
        return et.mnist_mlp(input_dim=d, num_classes=k, hidden=int(params["units"]),
                            dropout=0.0, lr=params["lr"], seed=1, device="cpu")

    hp = HyperParamModel(num_workers=2, seed=5, device="cpu")
    hp.minimize(build, (x[:128], y[:128], x[128:], y[128:]), max_evals=4,
                search_space={"units": choice([8, 16]), "lr": loguniform(1e-3, 1e-1)},
                epochs=2, batch_size=32)
    print("HPO " + json.dumps({"rank": distributed.process_index(),
                               "best_params": hp.best_model_params(),
                               "best_loss": hp.best_trial().loss,
                               "trials": len(hp.trials)}), flush=True)
    """
)

ELASTIC_SCRIPT = COMMON + textwrap.dedent(
    """
    from elephas_tpu_torch.parallel import distributed
    assert distributed.initialize(), "gang init failed"
    ckdir = os.environ["ELEPHAS_CHECKPOINT_DIR"]
    attempt = int(os.environ["ELEPHAS_RESTART_COUNT"])
    resume = os.environ["ELEPHAS_RESUME"] == "1"
    rank = distributed.process_index()
    x, y = data()
    m = model()
    sm = et.SparkModel(m, device="cpu")
    # phase 1: two snapshotted epochs; then rank 1 of generation 0 dies
    # hard, and the launcher must kill the gang and start it again
    h1 = sm.fit((x, y), epochs=2, batch_size=8, checkpoint_dir=ckdir, resume=resume)
    if attempt == 0 and rank == 1:
        os._exit(17)
    # phase 2, reached only by the restarted generation: on to 4 epochs
    h2 = sm.fit((x, y), epochs=4, batch_size=8, checkpoint_dir=ckdir, resume=True)
    print("ELASTIC " + json.dumps({"rank": rank, "attempt": attempt,
                                   "phase1_epochs": len(h1["loss"]),
                                   "phase2_epochs": len(h2["loss"]),
                                   "losses": h1["loss"] + h2["loss"],
                                   "digest": digest(m)}), flush=True)
    """
)


def _run_gang(tmp_path, monkeypatch, body, *script_args, **launch_kwargs):
    monkeypatch.setenv("PYTHONPATH", REPO)
    script = tmp_path / "gang_script.py"
    script.write_text(body)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch(str(script), [str(a) for a in script_args], num_processes=2,
                    cpu_devices_per_process=4, timeout=300, **launch_kwargs)
    return rc, buf.getvalue()


def _results(output, tag):
    return sorted((json.loads(line.split(tag + " ", 1)[1])
                   for line in output.splitlines() if tag + " " in line),
                  key=lambda r: (r.get("mode", ""), r["rank"]))


def test_child_env_keys_match_the_reference():
    """The launcher's public keys are the reference's, and the worker slots
    reach every rank through the one key ``initialize`` reads."""
    for cpu in (0, 4):
        want = jax_child_env(1, 2, "127.0.0.1:1234", cpu, restart_from="/ck", attempt=1)
        got = child_env(1, 2, "127.0.0.1:1234", cpu, restart_from="/ck", attempt=1)
        for key in ("ELEPHAS_COORDINATOR", "ELEPHAS_NUM_PROCESSES", "ELEPHAS_PROCESS_ID",
                    "ELEPHAS_CHECKPOINT_DIR", "ELEPHAS_RESTART_COUNT", "ELEPHAS_RESUME"):
            assert got[key] == want[key], key
    assert parse_slots(child_env(1, 2, "h:1", 4)[SLOTS_KEY]) == (4, torch.device("cpu"))
    env = child_env(3, 4, "h:1", cuda_slots_per_process=2, ranks_per_card=2, backend="gloo")
    assert (env[SLOTS_KEY], env["LOCAL_RANK"], env["ELEPHAS_DIST_BACKEND"]) == (
        "2@cuda:1", "1", "gloo")
    assert SLOTS_KEY not in child_env(0, 2, "h:1")
    with pytest.raises(ValueError, match="exclude each other"):
        child_env(0, 2, "h:1", 4, cuda_slots_per_process=2)
    with pytest.raises(ValueError, match="<slots>@<device>"):
        parse_slots("cpu")
    # outside a gang: one process, nothing joined
    assert gang() is None
    assert not distributed.initialize()


def _one_process_fit(mode, frequency):
    namespace = {}
    exec(COMMON, namespace)
    previous = force_devices(8)
    try:
        x, y = namespace["data"]()
        m = namespace["model"]()
        sm = et.SparkModel(m, mode=mode, frequency=frequency, device="cpu")
        h = sm.fit((x, y), epochs=2, batch_size=8)
    finally:
        force_devices(previous)
    return namespace["digest"](m), h


def test_gang_fit_is_bit_equal_to_one_process(tmp_path, monkeypatch):
    """Two ranks × 4 workers: each mode's weights are bit-identical across
    the ranks and bit-equal to one process's 8-worker fit, with the same
    history; only the coordinator wrote the history log and the
    checkpoints."""
    rc, output = _run_gang(tmp_path, monkeypatch, FIT_SCRIPT, tmp_path)
    assert rc == 0, output[-3000:]
    results = _results(output, "RESULT")
    assert len(results) == 2 * len(MODES), output[-3000:]
    for i, (mode, frequency) in enumerate(MODES):
        a, b = [r for r in results if r["mode"] == mode]
        assert (a["rank"], b["rank"]) == (0, 1)
        assert a["workers"] == b["workers"] == 8
        assert a["digest"] == b["digest"], mode
        assert a["history"] == b["history"], mode
        want_digest, want_history = _one_process_fit(mode, frequency)
        assert a["digest"] == want_digest, mode
        assert a["history"] == want_history, mode
        lines = (tmp_path / f"history-{i}.jsonl").read_text().splitlines()
        assert len(lines) == 3 and json.loads(lines[-1])["final"], lines
        assert sorted(os.listdir(tmp_path / f"ckpt-{i}")) == [
            "ckpt-00001.json", "ckpt-00001.pt", "ckpt-00002.json", "ckpt-00002.pt"]


def test_gang_hpo_agrees_on_best(tmp_path, monkeypatch):
    """Trials divide across the ranks, every round is gathered, and both
    ranks name the same best params and loss
    (``tests/test_multihost.py:272``)."""
    rc, output = _run_gang(tmp_path, monkeypatch, HPO_SCRIPT)
    assert rc == 0, output[-3000:]
    a, b = _results(output, "HPO")
    assert a["best_params"] == b["best_params"], (a, b)
    assert abs(a["best_loss"] - b["best_loss"]) < 1e-9
    # 4 trials over 2 ranks of 2 slots: one round, two trials a rank, plus
    # the winner trained again on the rank that lost
    assert sorted((a["trials"], b["trials"])) in ([2, 3], [2, 2])


def test_gang_elastic_restart_from_checkpoint(tmp_path, monkeypatch):
    """A rank dies mid-run; ``launch(max_restarts=1, restart_from=ckdir)``
    kills the gang, starts it again with ELEPHAS_RESUME=1, and training
    ends from the last snapshot with equal weights on both ranks
    (``tests/test_multihost.py:729``)."""
    ckdir = tmp_path / "elastic_ckpt"
    ckdir.mkdir()
    rc, output = _run_gang(tmp_path, monkeypatch, ELASTIC_SCRIPT, max_restarts=1,
                           restart_from=str(ckdir))
    assert rc == 0, output[-3000:]
    assert "exited rc=17; killing the gang" in output, output[-3000:]
    assert "restarting (1/1)" in output, output[-3000:]
    a, b = _results(output, "ELASTIC")
    assert a["attempt"] == b["attempt"] == 1, (a, b)
    # generation 1 resumed at epoch 2: phase 1 is done, phase 2 runs 3-4
    assert (a["phase1_epochs"], a["phase2_epochs"]) == (0, 2), a
    assert a["digest"] == b["digest"], (a, b)
    assert a["losses"] == b["losses"] and np.all(np.isfinite(a["losses"]))


def test_first_failing_childs_code_is_the_gangs(tmp_path, monkeypatch):
    """Fail-fast: the first child to fail sets the gang's exit code (its
    sibling, killed, does not mask it), and a gang past its timeout exits
    124."""
    body = textwrap.dedent(
        """
        import os, sys, time
        if os.environ["ELEPHAS_PROCESS_ID"] == "1":
            sys.exit(int(sys.argv[1]))
        time.sleep(float(sys.argv[2]))
        """
    )
    rc, output = _run_gang(tmp_path, monkeypatch, body, 3, 60)
    assert rc == 3, output
    assert "[launch] proc 1 exited rc=3; killing the gang" in output
    script = tmp_path / "sleep.py"
    script.write_text("import time\ntime.sleep(60)\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launch(str(script), num_processes=2, timeout=1) == 124
    assert "gang timed out" in buf.getvalue()
    assert sys.stdout is not buf
