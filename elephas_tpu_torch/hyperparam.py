"""HyperParamModel — hyperparameter search over the port's worker slots.

Counterpart of ``elephas_tpu/hyperparam.py``: the search-space DSL
(:func:`choice`, :func:`uniform`, :func:`loguniform`, :func:`quniform`,
:func:`sample_space`), the TPE-style :class:`TpeSampler` and :class:`Trial`
are its numpy host code, copied as they are, so the sampled params are
bit-equal to the reference's for the same seed and history.

``HyperParamModel(sc, num_workers, seed, device).minimize(model, data,
max_evals, search_space, ...)`` runs trials of a builder ``params ->
compiled module`` (:func:`elephas_tpu_torch.training.compile_model`, as
every builder of the zoo returns it). Trials lease groups of
``devices_per_trial`` worker slots from a free queue, one thread a group;
each trial trains data-parallel over its group on the module's device
(:class:`elephas_tpu_torch.worker.Runner`, ``synchronous``, ``epoch``) and
is scored by its validation loss. The worker slots are the port's
(:func:`elephas_tpu_torch.device.num_available_workers`:
:func:`~elephas_tpu_torch.device.force_devices` offers several on the one
card). One process only: gathering rounds across processes
(:meth:`HyperParamModel._sync_round`) waits for several cards (ROADMAP.md,
Queue A item 9).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from elephas_tpu_torch.device import num_available_workers, resolve_device, worker_count
from elephas_tpu_torch.worker import Runner

logger = logging.getLogger(__name__)

_SYNC_TODO = (
    "HyperParamModel._sync_round is not ported yet (ROADMAP.md, Queue A item 9: "
    "several processes, one a card, over torch.distributed)"
)


# -- search space DSL --------------------------------------------------


@dataclass
class _Dist:
    kind: str
    args: tuple = ()

    def sample(self, rng: np.random.Generator):
        if self.kind == "choice":
            options = self.args[0]
            return options[int(rng.integers(len(options)))]
        if self.kind == "uniform":
            lo, hi = self.args
            return float(rng.uniform(lo, hi))
        if self.kind == "loguniform":
            lo, hi = self.args
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        if self.kind == "quniform":
            lo, hi, q = self.args
            value = round(rng.uniform(lo, hi) / q) * q
            # integral q keeps hyperopt's int-like behavior; fractional q
            # must stay float (int() would truncate 0.5 -> 0)
            return int(value) if float(q).is_integer() else float(value)
        raise ValueError(f"unknown distribution {self.kind}")


def choice(options) -> _Dist:
    return _Dist("choice", (list(options),))


def uniform(low: float, high: float) -> _Dist:
    return _Dist("uniform", (low, high))


def loguniform(low: float, high: float) -> _Dist:
    return _Dist("loguniform", (low, high))


def quniform(low: float, high: float, q: float = 1) -> _Dist:
    return _Dist("quniform", (low, high, q))


def sample_space(space: dict, rng: np.random.Generator) -> dict:
    return {
        k: (v.sample(rng) if isinstance(v, _Dist) else v) for k, v in space.items()
    }


# -- adaptive (TPE-style) sampling -------------------------------------


class TpeSampler:
    """Factorized Tree-of-Parzen-Estimators sampler (hyperopt's
    ``tpe.suggest`` shape, reimplemented small: ``[U]
    elephas/hyperparam.py`` delegates to hyperopt; this framework carries
    the strategy natively).

    Completed trials split into good (best ``gamma`` quantile) and bad;
    numeric dimensions draw candidates from a Parzen mixture over the
    good values (log-transformed for ``loguniform``) and keep the
    candidate maximizing ``density_good / density_bad``; ``choice``
    dimensions sample from add-one-smoothed good counts. Falls back to
    random sampling until ``min_observations`` trials complete.
    """

    def __init__(
        self,
        space: dict,
        seed: int | None = None,
        gamma: float = 0.25,
        n_candidates: int = 24,
        min_observations: int = 4,
    ):
        self.space = space
        self.keys = sorted(space)
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.min_observations = min_observations

    # numeric transform: TPE operates in the distribution's natural space
    def _transform(self, dist: _Dist, value):
        return float(np.log(value)) if dist.kind == "loguniform" else float(value)

    def _untransform(self, dist: _Dist, value: float):
        if dist.kind == "loguniform":
            return float(np.exp(value))
        if dist.kind == "quniform":
            lo, hi, q = dist.args
            value = round(np.clip(value, lo, hi) / q) * q
            return int(value) if float(q).is_integer() else float(value)
        lo, hi = dist.args
        return float(np.clip(value, lo, hi))

    @staticmethod
    def _parzen_logdensity(x, points: np.ndarray, bw: np.ndarray) -> float:
        """log of a normalized Gaussian-mixture density with per-kernel
        bandwidths (hyperopt's adaptive Parzen estimator shape)."""
        z = (x - points) / bw
        logk = -0.5 * z * z - np.log(bw)
        m = np.max(logk)
        return float(m + np.log(np.mean(np.exp(logk - m))))

    @staticmethod
    def _adaptive_bw(points: np.ndarray, lo: float, hi: float) -> np.ndarray:
        """Per-point bandwidth = distance to the farther neighbor (range
        bounds count as neighbors), clipped. Edge points get wide kernels,
        so candidate draws keep probing beyond the incumbent cluster —
        the piece that prevents premature collapse."""
        span = max(hi - lo, 1e-9)
        order = np.argsort(points)
        srt = points[order]
        left = np.diff(srt, prepend=lo)
        right = np.diff(srt, append=hi)
        bw_sorted = np.clip(
            np.maximum(left, right), span / min(100.0, 1.0 + 10 * len(srt)), span
        )
        bw = np.empty_like(bw_sorted)
        bw[order] = bw_sorted
        return bw

    def _bounds(self, dist: _Dist) -> tuple[float, float]:
        lo, hi = dist.args[0], dist.args[1]
        if dist.kind == "loguniform":
            return float(np.log(lo)), float(np.log(hi))
        return float(lo), float(hi)

    def _sample_numeric(self, dist: _Dist, good: np.ndarray, bad: np.ndarray):
        lo, hi = self._bounds(dist)
        bw_good = self._adaptive_bw(good, lo, hi)
        bw_bad = self._adaptive_bw(bad, lo, hi)
        # candidates drawn from the good mixture plus a uniform prior
        # slice; winner maximizes the expected-improvement surrogate
        # density_good / density_bad (hyperopt's selection rule)
        n_prior = max(1, self.n_candidates // 4)
        pick = self.rng.integers(len(good), size=self.n_candidates - n_prior)
        candidates = np.concatenate(
            [
                good[pick] + self.rng.normal(size=len(pick)) * bw_good[pick],
                self.rng.uniform(lo, hi, size=n_prior),
            ]
        )
        candidates = np.clip(candidates, lo, hi)
        scores = [
            self._parzen_logdensity(c, good, bw_good)
            - self._parzen_logdensity(c, bad, bw_bad)
            for c in candidates
        ]
        return float(candidates[int(np.argmax(scores))])

    def sample_batch(self, n: int, history: list[tuple[dict, float]]) -> list[dict]:
        """``n`` new parameter dicts, informed by completed ``(params,
        loss)`` history (NaN losses count as bad)."""
        finite = [(p, l) for p, l in history if np.isfinite(l)]
        if len(finite) < self.min_observations:
            return [sample_space(self.space, self.rng) for _ in range(n)]
        # the good quantile is taken over FINITE trials only — when
        # divergent (NaN/inf) trials outnumber finite ones, an over-full
        # quantile of the mixed ordering would pull known-bad params into
        # the 'good' Parzen estimator and steer toward divergence
        order = sorted(finite, key=lambda t: t[1])
        n_good = min(
            max(2, int(np.ceil(self.gamma * len(order)))), len(order)
        )
        diverged = [(p, l) for p, l in history if not np.isfinite(l)]
        good, bad = order[:n_good], order[n_good:] + diverged
        if len(bad) < 2:
            return [sample_space(self.space, self.rng) for _ in range(n)]

        out = []
        for _ in range(n):
            params = {}
            for key in self.keys:
                dist = self.space[key]
                if not isinstance(dist, _Dist):
                    params[key] = dist
                    continue
                if dist.kind == "choice":
                    options = dist.args[0]
                    counts = np.ones(len(options))
                    for p, _l in good:
                        if p[key] in options:
                            counts[options.index(p[key])] += 1
                    params[key] = options[
                        int(self.rng.choice(len(options), p=counts / counts.sum()))
                    ]
                else:
                    gv = np.array([self._transform(dist, p[key]) for p, _l in good])
                    bv = np.array([self._transform(dist, p[key]) for p, _l in bad])
                    params[key] = self._untransform(
                        dist, self._sample_numeric(dist, gv, bv)
                    )
            out.append(params)
        return out


def _encode_params(params: dict, space: dict) -> list[float]:
    """Params → float32-safe vector (choice dims ride as option index)."""
    vec = []
    for key in sorted(space):
        dist = space[key]
        if not isinstance(dist, _Dist):  # constant: rides as placeholder
            vec.append(np.float32(0.0))
        elif dist.kind == "choice":
            vec.append(np.float32(dist.args[0].index(params[key])))
        else:
            vec.append(np.float32(params[key]))
    return vec


def _decode_params(vec, space: dict) -> dict:
    params = {}
    for j, key in enumerate(sorted(space)):
        dist = space[key]
        if not isinstance(dist, _Dist):  # constant lives in the space
            params[key] = dist
        elif dist.kind == "choice":
            params[key] = dist.args[0][int(vec[j])]
        elif dist.kind == "quniform":
            q = dist.args[2]
            params[key] = int(vec[j]) if float(q).is_integer() else float(vec[j])
        else:
            params[key] = float(vec[j])
    return params


# -- trials ------------------------------------------------------------


@dataclass
class Trial:
    params: dict
    loss: float
    metrics: dict = field(default_factory=dict)


class HyperParamModel:
    """Hyperparameter search over model builders.

    ``strategy='adaptive'`` (default, the hyperopt-TPE analogue) samples
    each round informed by completed trials; ``'random'`` reproduces the
    reference's ``rand.suggest`` behavior. ``num_workers`` worker slots
    (default: every slot of ``device``'s kind, clamped to them as the
    reference clamps its local devices) run the trials; ``device``
    (``cuda:0`` by default, ``"cpu"`` on request) names where the slots
    are counted, and the builder puts its modules there.
    """

    def __init__(self, sc=None, num_workers: int | None = None, seed: int | None = None,
                 device=None):
        self.sc = sc  # accepted for API parity; search needs no RDDs
        self.device = resolve_device(device)
        available = num_available_workers(self.device)
        # several physical cards raise there (item 9)
        self.num_workers = worker_count(min(num_workers or available, available), self.device)
        self.seed = seed
        self.trials: list[Trial] = []
        self.best_models: list = []

    def minimize(
        self,
        model: Callable[[dict], Any],
        data,
        max_evals: int = 16,
        search_space: dict | None = None,
        epochs: int = 5,
        batch_size: int = 32,
        verbose: int = 0,
        strategy: str = "adaptive",
        devices_per_trial: int = 1,
    ):
        """Run ``max_evals`` trials; returns the best trained module.

        ``model(params)`` must return a *compiled* module; ``data`` is
        ``(x_train, y_train, x_val, y_val)`` or a callable producing it.
        Per-trial validation loss decides the winner (ties: the first to
        finish wins).

        ``devices_per_trial``: each trial trains data-parallel on a group of
        that many worker slots. Concurrency becomes ``num_workers //
        devices_per_trial`` groups.
        """
        if strategy not in ("adaptive", "random"):
            raise ValueError(
                f"strategy must be 'adaptive' or 'random', got {strategy!r}"
            )
        if devices_per_trial < 1 or devices_per_trial > self.num_workers:
            raise ValueError(
                f"devices_per_trial={devices_per_trial} must be in "
                f"[1, {self.num_workers}]"
            )
        if callable(data):
            data = data()
        x_train, y_train, x_val, y_val = data
        self._best_index = None  # a failed search must not pair a stale index
        # with freshly assigned trials
        search_space = search_space or {}
        # one process: the reference's process count and index
        n_proc, pid = 1, 0
        # distinct stream per process so gang members explore, not repeat
        base_seed = (self.seed if self.seed is not None else 0) * 1009 + pid
        rng = np.random.default_rng(base_seed)
        sampler = (
            TpeSampler(search_space, seed=base_seed)
            if strategy == "adaptive"
            else None
        )

        # modules are built one at a time under a lock, inside each trial, so
        # only in-flight trials hold live modules; within a round, trials train
        # and evaluate concurrently, one thread a group of worker slots
        build_lock = threading.Lock()
        best_lock = threading.Lock()
        best_state: dict = {"loss": float("inf"), "model": None, "index": None}
        # groups are leased from a free queue, not indexed by trial number:
        # trials of different lengths would otherwise double-book a group
        n_groups = self.num_workers // devices_per_trial
        leftover = self.num_workers - n_groups * devices_per_trial
        if leftover:
            logger.warning(
                "devices_per_trial=%d does not divide %d workers; %d "
                "device(s) will sit idle",
                devices_per_trial, self.num_workers, leftover,
            )
        free_groups: queue.Queue = queue.Queue()
        for g in range(n_groups):
            free_groups.put(list(range(g * devices_per_trial, (g + 1) * devices_per_trial)))

        def run_trial(arg) -> Trial:
            i, params = arg
            with build_lock:
                trial_model = model(params)
            if getattr(trial_model, "training_spec", None) is None:
                raise ValueError(
                    "model builder must return a compiled keras model"
                )
            group = free_groups.get()
            try:
                return _train_on(group, i, params, trial_model)
            finally:
                free_groups.put(group)

        def _train_on(group, i: int, params: dict, trial_model) -> Trial:
            runner = Runner(trial_model, "synchronous", "epoch", num_workers=len(group))
            runner.run_epochs(
                runner._fit_partitions_to_mesh([(x_train, y_train)]),
                epochs=epochs,
                batch_size=batch_size,
            )
            results = runner.evaluate([(x_val, y_val)], batch_size=batch_size)
            trial = Trial(params=params, loss=results["loss"], metrics=results)
            with best_lock:
                # keep only the running-best trained module (ties: first wins)
                if trial.loss < best_state["loss"]:
                    best_state["loss"] = trial.loss
                    best_state["model"] = trial_model
                    best_state["index"] = i
            if verbose:
                logger.info(
                    "trial %d/%d: params=%s val_loss=%.4f",
                    i + 1,
                    max_evals,
                    params,
                    trial.loss,
                )
            return trial

        # round-based: sample (informed) → run concurrently → repeat
        self.trials = []
        completed: list[tuple[dict, float]] = []
        evals_done = 0
        while evals_done < max_evals:
            global_batch = min(max_evals - evals_done, n_groups * n_proc)
            my_slots = list(range(pid, global_batch, n_proc))
            if sampler is not None:
                batch_params = sampler.sample_batch(len(my_slots), completed)
            else:
                batch_params = [
                    sample_space(search_space, rng) for _ in my_slots
                ]
            local_base = len(self.trials)
            indexed = [
                (local_base + j, params)
                for j, params in enumerate(batch_params)
            ]
            with ThreadPoolExecutor(max_workers=n_groups) as pool:
                round_trials = list(pool.map(run_trial, indexed))
            self.trials.extend(round_trials)
            completed.extend((t.params, t.loss) for t in round_trials)
            evals_done += global_batch

        best_model = best_state["model"]
        if best_model is None:
            raise RuntimeError(
                f"no trial produced a finite validation loss "
                f"(losses: {[t.loss for t in self.trials]}); the search "
                f"space likely diverges — narrow the learning-rate range"
            )
        self.best_models = [best_model]
        # the winning trial index is recorded at update time so that
        # best_trial()/best_model_params() name the same trial the
        # returned module came from, even on tied or NaN losses
        self._best_index = best_state["index"]
        return best_model

    def _sync_round(self, local_results, my_k: int, global_batch: int, space: dict):
        """All-gather one round's ``(params, loss)`` across processes: the
        reference's multi-host path, which several cards bring (item 9)."""
        raise NotImplementedError(_SYNC_TODO)

    def best_trial(self) -> Trial:
        if not self.trials:
            raise ValueError("no trials run yet")
        index = getattr(self, "_best_index", None)
        if index is not None:
            return self.trials[index]
        return min(self.trials, key=lambda t: t.loss)

    def best_model_params(self) -> dict:
        return self.best_trial().params
