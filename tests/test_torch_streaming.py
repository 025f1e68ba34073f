"""The port's streaming input path and its data layer against the JAX
package's, on the CPU.

The port runs under ``force_devices(8)`` on ``device="cpu"``; the JAX
``SparkModel`` on conftest's 8 virtual CPU devices. Data is numpy from a
seed (the ``blobs`` fixture), weights cross by Keras path. Tolerances:
- blocks of ``ShardedStream`` (either gather), ``Rdd``, ``rdd_utils`` and
  ``mllib`` results: equal, array for array;
- a streamed fit against the port's staged fit of the same rows: bit for
  bit (history, weights, optimizer state);
- a streamed fit against the JAX streamed fit from the same weights: per
  epoch history within 1e-4 relative, every final weight within 1e-4
  (fp32, other summation orders); ``SparkMLlibModel`` the same.
"""

import threading
import time

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu import SparkMLlibModel as JaxMLlibModel
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.data import SparkContext as JaxSparkContext
from elephas_tpu.data import streaming as jax_streaming
from elephas_tpu.data.linalg import DenseMatrix as JaxDenseMatrix
from elephas_tpu.data.linalg import DenseVector as JaxDenseVector
from elephas_tpu.data.rdd import LazyRows as JaxLazyRows
from elephas_tpu.data.rdd import Rdd as JaxRdd
from elephas_tpu.mllib import adapter as jax_mllib
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu.utils import rdd_utils as jax_rdd_utils
from elephas_tpu_torch import training, worker
from elephas_tpu_torch.data import SparkContext, streaming
from elephas_tpu_torch.data.linalg import DenseMatrix, DenseVector, LabeledPoint, Vectors
from elephas_tpu_torch.data.rdd import LazyRows, Rdd
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.mllib import adapter as mllib
from elephas_tpu_torch.utils import rdd_utils
from elephas_tpu_torch.utils.weights import canonical_keras_names
from tests.conftest import make_mlp
from tests.test_torch_workers import _keras_weights, _mlp_pair

W = 8
ROWS, BATCH, EPOCHS = 1280, 32, 2
TOL = 1e-4


@pytest.fixture(autouse=True)
def eight_workers():
    previous = force_devices(W)
    yield
    force_devices(previous)


@pytest.fixture
def memmaps(tmp_path, blobs):
    """The blobs written to memmaps, opened read-only."""
    x, y, _, _ = blobs
    out = []
    for name, a in (("x", x), ("y", y)):
        path = str(tmp_path / f"{name}.dat")
        m = np.memmap(path, dtype=a.dtype, mode="w+", shape=a.shape)
        m[:] = a
        m.flush()
        out.append(np.memmap(path, dtype=a.dtype, mode="r", shape=a.shape))
    return tuple(out)


class StrictSource:
    """An h5py-like source: eager reads, point selection only with strictly
    increasing indices; counts the ranged (slice) and point reads."""

    def __init__(self, a):
        self._a, self.ndim, self.dtype, self.shape = a, a.ndim, a.dtype, a.shape
        self.slices = self.points = 0

    def __len__(self):
        return len(self._a)

    def __getitem__(self, idx):
        if isinstance(idx, np.ndarray) and len(idx) > 1 and not (np.diff(idx) > 0).all():
            raise TypeError("Indexing elements must be in increasing order")
        if isinstance(idx, slice):
            self.slices += 1
        elif isinstance(idx, np.ndarray):
            self.points += 1
        return np.array(self._a[idx])


def _weights_close(port, ref, tol=TOL):
    want = _keras_weights(ref)
    got = et.keras_weights(port)
    names = canonical_keras_names(port, want)
    for path, w in want.items():
        np.testing.assert_allclose(got[names[path]], w, atol=tol, rtol=0, err_msg=path)


def _history_close(got, want):
    assert list(got) == list(want), (got, want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, err_msg=key)


# -- ShardedStream and prefetch_blocks -------------------------------------


@pytest.mark.parametrize("source", ["h5py_like", "memmap"])
@pytest.mark.parametrize("workers", [1, 3, 8])
def test_sharded_stream_blocks_equal_the_reference(blobs, memmaps, workers, source):
    """The port's blocks are the reference's, array for array: with and
    without ``num_rows`` and ``steps_per_epoch``, over a row count that no
    worker count divides (so ranges wrap), for every worker and for a
    subset (``worker_indices``), from an h5py-like source and a memmap. A
    worker's run that does not wrap is one slice read; one that wraps reads
    the reference's strictly increasing unique rows (both counted on the
    h5py-like source)."""
    x, y, _, _ = blobs
    x, y = x[:1501], y[:1501]
    for opts in (dict(), dict(num_rows=1203), dict(steps_per_epoch=3),
                 dict(num_rows=999, steps_per_epoch=5)):
        theirs = jax_streaming.ShardedStream(x, y, 32, workers, block_steps=2, **opts)
        if source == "h5py_like":
            sx, sy = StrictSource(x), StrictSource(y)
        else:
            sx, sy = memmaps[0][:1501], memmaps[1][:1501]
        ours = streaming.ShardedStream(sx, sy, 32, workers, block_steps=2, **opts)
        assert (ours.steps, ours.num_rows, ours.num_blocks, ours.starts, ours.counts) == \
            (theirs.steps, theirs.num_rows, theirs.num_blocks, theirs.starts, theirs.counts)
        for subset in (None, [workers - 1] if workers > 1 else None):
            want = list(theirs.blocks(worker_indices=subset))
            got = list(ours.blocks(worker_indices=subset))
            assert len(got) == len(want) == theirs.num_blocks
            for (gx, gy, gs), (wx, wy, ws) in zip(got, want):
                assert gs == ws and gx.dtype == wx.dtype and gy.dtype == wy.dtype
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
        if source == "h5py_like":
            assert sx.slices > 0
            assert (sx.points > 0) == (ours.steps * 32 > min(ours.counts))


def test_prefetch_releases_the_reader_when_abandoned():
    produced = []

    def slow_blocks():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    gen = streaming.prefetch_blocks(slow_blocks(), depth=2)
    assert next(gen) == 0
    gen.close()  # what an exception in the consumer does
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "reader thread leaked"
    assert len(produced) < 100, "reader ran to completion despite abandonment"


def test_prefetch_keeps_order_and_reraises_reader_errors():
    assert list(streaming.prefetch_blocks(iter(range(7)), depth=3)) == list(range(7))

    def failing():
        yield 1
        raise OSError("disk gone")

    gen = streaming.prefetch_blocks(failing())
    assert next(gen) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(gen)


def test_concat_rows_and_lazy_sources_match_the_reference(memmaps):
    xm, ym = memmaps
    bounds = [(0, 100), (100, 350), (350, 1600)]
    ours = streaming.ConcatRows([(xm, lo, hi) for lo, hi in bounds])
    theirs = jax_streaming.ConcatRows([(xm, lo, hi) for lo, hi in bounds])
    assert len(ours) == len(theirs) and ours.ndim == theirs.ndim and ours.dtype == theirs.dtype
    idx = np.array([0, 5, 99, 100, 349, 350, 1599])
    for key in (idx, slice(90, 360), slice(0, 1600, 7), 0, 350, 1599):
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours[5:5].shape == (0, xm.shape[1])
    assert streaming.is_lazy_source(xm) and not streaming.is_lazy_source(np.asarray(xm))
    assert streaming.estimate_nbytes(xm, ym) == jax_streaming.estimate_nbytes(xm, ym)
    assert streaming.estimate_nbytes(StrictSource(np.zeros((10, 4), np.float32)),
                                     np.zeros(10, np.int32)) == 10 * 16 + 40


def test_block_stager_on_the_cpu_takes_int32_tokens_to_int64():
    tokens = np.arange(7 * 5, dtype=np.int32).reshape(7, 5)
    labels = np.arange(7, dtype=np.int32)
    stream = streaming.ShardedStream(tokens, labels, 2, 2, block_steps=1)
    stager = worker.BlockStager(torch.device("cpu"))
    got = list(stager.blocks(stream))
    want = list(stream.blocks())
    assert len(got) == len(want) == 2
    for (t, y, s), (ht, hy, hs) in zip(got, want):
        assert s == hs and t.dtype == y.dtype == torch.int64
        assert torch.equal(t, torch.from_numpy(ht).long()) and torch.equal(
            y, torch.from_numpy(hy).long())
    assert stager.pinned_bytes == 0


def test_gather_into_given_arrays_equals_the_stacked_block(blobs):
    x, y, _, _ = blobs
    stream = streaming.ShardedStream(x[:301], y[:301], 16, 3, block_steps=4)
    for lo, hi in stream.step_ranges():
        want = stream.gather(lo, hi)
        out = [np.full_like(a, -1) for a in want]
        assert stream.gather(lo, hi, out=out) is out
        for g, w in zip(out, want):
            np.testing.assert_array_equal(g, w)


# -- streamed fits ----------------------------------------------------------


def test_streamed_fit_is_bit_equal_to_the_staged_fit(blobs):
    """1,280 rows at W = 8: 160 rows a worker, 5 steps of 32, in blocks of
    2 steps (3 blocks, the last short)."""
    x, y, d, k = blobs
    x, y = x[:ROWS], y[:ROWS]
    (_, staged), (_, streamed) = _mlp_pair(d, k, seed=13), _mlp_pair(d, k, seed=13)
    h1 = et.SparkModel(staged, num_workers=W, device="cpu").fit(
        (x, y), epochs=3, batch_size=BATCH)
    h2 = et.SparkModel(streamed, num_workers=W, device="cpu").fit(
        (x, y), epochs=3, batch_size=BATCH, stream_block_steps=2)
    assert h1 == h2
    for (n, a), b in zip(staged.state_dict().items(), streamed.state_dict().values()):
        assert torch.equal(a, b), n
    sa = staged.training_spec.optimizer.state_dict()["state"]
    sb = streamed.training_spec.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("m", "v"):
            assert torch.equal(sa[i][key], sb[i][key])


STREAM_CASES = {
    # name: (rows, fit keywords, source)
    "memmap_validation": (1600, dict(validation_split=0.2), "memmap"),
    "lazy_rdd": (1600, dict(stream_block_steps=2), "lazy_rdd"),
    "steps_per_epoch": (1600, dict(steps_per_epoch=3), "array"),
    "non_divisible": (1501, dict(stream_block_steps=2), "array"),
    "validation_tail_in_blocks": (1600, dict(validation_split=0.2, stream_block_steps=1),
                                  "strict"),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streamed_fit_matches_jax(case, blobs, memmaps):
    """The port's streamed fit against the JAX package's from the same
    Keras weights: a memmap with validation, a lazy RDD over memmaps,
    ``steps_per_epoch``, a row count W does not divide (ceil split, a
    wrapping last range: not the staged split) and the validation tail
    evaluated in blocks of 256 rows from an h5py-like source."""
    x, y, d, k = blobs
    rows, kwargs, source = STREAM_CASES[case]
    if source == "memmap":
        data = ((memmaps[0], memmaps[1]),) * 2
    elif source == "lazy_rdd":
        data = (jax_rdd_utils.to_simple_rdd(JaxSparkContext("local[3]"), *memmaps),
                rdd_utils.to_simple_rdd(SparkContext("local[3]"), *memmaps))
        assert data[1].is_lazy() and data[0].is_lazy()
    elif source == "strict":
        data = ((StrictSource(x), StrictSource(y)),) * 2
    else:
        data = ((x[:rows], y[:rows]),) * 2
    ref, port = _mlp_pair(d, k, seed=17)
    streamed = []
    real = worker.Runner.run_epochs_stream

    def spy(self, *args, **kw):
        streamed.append(True)
        return real(self, *args, **kw)

    worker.Runner.run_epochs_stream = spy
    try:
        t_hist = et.SparkModel(port, num_workers=W, device="cpu").fit(
            data[1], epochs=EPOCHS, batch_size=BATCH, **kwargs)
    finally:
        worker.Runner.run_epochs_stream = real
    j_hist = JaxSparkModel(ref, num_workers=W).fit(data[0], epochs=EPOCHS, batch_size=BATCH,
                                                   **kwargs)
    assert streamed
    _history_close(t_hist, j_hist)
    _weights_close(port, ref)


def test_streamed_transformer_matches_jax():
    """A 1-layer transformer classifier streamed at W = 2: the plain
    versions of the flash forward and both LayerNorm kernels on the
    streamed path, against the JAX streamed fit (Pallas in interpret
    mode)."""
    cfg = dict(vocab_size=61, maxlen=16, num_classes=2, d_model=32, num_heads=2,
               num_layers=1, dropout=0.0, seed=5)
    rng = np.random.default_rng(11)
    x = rng.integers(0, cfg["vocab_size"], (48, cfg["maxlen"])).astype(np.int32)
    y = rng.integers(0, 2, 48).astype(np.int32)
    ref = jax_classifier(**cfg)
    port = et.transformer_classifier(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    kwargs = dict(epochs=EPOCHS, batch_size=4, stream_block_steps=2)
    j_hist = JaxSparkModel(ref, num_workers=2).fit((x, y), **kwargs)
    t_hist = et.SparkModel(port, num_workers=2, device="cpu").fit((x, y), **kwargs)
    _history_close(t_hist, j_hist)
    _weights_close(port, ref)


def test_metric_counts_stay_exact_across_blocks(blobs, monkeypatch):
    """Each block's accuracy total and count merge into the epoch's as
    exact integers: 5 one-step blocks of 8 × 32 rows give the staged
    epoch's counts and result bit for bit."""
    x, y, d, k = blobs
    x, y = x[:ROWS], y[:ROWS]
    merged = []
    real = training.MeanMetric.merge

    def spy(self, other):
        real(self, other)
        merged.append((self.total.item(), self.count.item()))

    monkeypatch.setattr(training.MeanMetric, "merge", spy)
    hist = {}
    for name, kwargs in (("staged", {}), ("streamed", dict(stream_block_steps=1))):
        merged.clear()
        _, port = _mlp_pair(d, k, seed=23)
        hist[name] = et.SparkModel(port, num_workers=W, device="cpu").fit(
            (x, y), epochs=1, batch_size=BATCH, **kwargs)
        counts = list(merged)
    assert len(counts) == 5
    assert [c for _, c in counts] == [float(W * BATCH * (i + 1)) for i in range(5)]
    assert all(t == int(t) for t, _ in counts)
    assert hist["staged"] == hist["streamed"]
    assert np.float32(counts[-1][0]) / np.float32(ROWS) == \
        np.float32(hist["streamed"]["accuracy"][0])


def test_streaming_triggers_by_threshold(blobs, monkeypatch):
    x, y, d, k = blobs
    seen = []
    real = worker.Runner.run_epochs_stream
    monkeypatch.setattr(worker.Runner, "run_epochs_stream",
                        lambda self, stream, *a, **kw: seen.append(stream) or real(
                            self, stream, *a, **kw))
    _, port = _mlp_pair(d, k)
    sm = et.SparkModel(port, num_workers=W, device="cpu")
    sm.fit((x, y), epochs=1, batch_size=BATCH)
    assert not seen
    sm.STREAM_THRESHOLD_BYTES = x.nbytes  # x and y together exceed it
    sm.fit((x, y), epochs=1, batch_size=BATCH)
    # the reference's default block: 16 worker steps, so the 7 steps of
    # 200 rows a worker make one block
    assert len(seen) == 1 and seen[0].block_steps == 16
    assert seen[0].steps == 7 and seen[0].num_blocks == 1
    assert et.SparkModel.STREAM_THRESHOLD_BYTES == 1 << 30


def test_lazy_rdd_with_frequency_fit_stages_and_matches_jax(blobs, memmaps, monkeypatch):
    """``frequency="fit"`` does not stream: the lazy RDD's partitions are
    read in one ranged read each and staged, as in the reference."""
    x, y, d, k = blobs
    sx, sy = StrictSource(x), StrictSource(y)
    lazy = rdd_utils.to_simple_rdd(SparkContext("local[3]"), sx, sy)
    monkeypatch.setattr(worker.Runner, "run_epochs_stream", None)  # must not be reached
    ref, port = _mlp_pair(d, k, seed=19)
    t_hist = et.SparkModel(port, frequency="fit", num_workers=W, device="cpu").fit(
        lazy, epochs=EPOCHS, batch_size=BATCH)
    assert sx.slices == 3 and sy.slices == 3
    j_rdd = jax_rdd_utils.to_simple_rdd(JaxSparkContext("local[3]"), *memmaps)
    j_hist = JaxSparkModel(ref, frequency="fit", num_workers=W).fit(
        j_rdd, epochs=EPOCHS, batch_size=BATCH)
    _history_close(t_hist, j_hist)
    _weights_close(port, ref)


def test_frequency_fit_refuses_to_stream_with_the_reference_message(blobs):
    x, y, d, k = blobs
    _, port = _mlp_pair(d, k)
    sm = et.SparkModel(port, frequency="fit", num_workers=W, device="cpu")
    with pytest.raises(ValueError) as ours:
        sm.fit((x, y), epochs=1, batch_size=BATCH, stream_block_steps=2)
    with pytest.raises(ValueError) as theirs:
        JaxSparkModel(make_mlp(d, k), frequency="fit", num_workers=W).fit(
            (x, y), epochs=1, batch_size=BATCH, stream_block_steps=2)
    assert str(ours.value) == str(theirs.value)


def test_streamed_resume_and_history_log_equal_the_uninterrupted_fit(blobs, tmp_path):
    """Checkpoints, resume, the history log and the profiler directory on
    the streamed path: 1 + 1 epochs bit-equal to 2."""
    x, y, d, k = blobs
    x, y = x[:ROWS], y[:ROWS]
    kwargs = dict(batch_size=BATCH, stream_block_steps=2)
    _, whole = _mlp_pair(d, k, seed=29)
    et.SparkModel(whole, num_workers=W, device="cpu").fit((x, y), epochs=2, **kwargs)
    ckpt = str(tmp_path / "ckpt")
    _, first = _mlp_pair(d, k, seed=29)
    et.SparkModel(first, num_workers=W, device="cpu").fit((x, y), epochs=1,
                                                          checkpoint_dir=ckpt, **kwargs)
    _, resumed = _mlp_pair(d, k, seed=31)  # other weights: the checkpoint wins
    log, prof = str(tmp_path / "log.jsonl"), tmp_path / "prof"
    hist = et.SparkModel(resumed, num_workers=W, device="cpu").fit(
        (x, y), epochs=2, checkpoint_dir=ckpt, resume=True, history_log=log,
        profile_dir=str(prof), **kwargs)
    assert len(hist["loss"]) == 1
    for (n, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n
    assert len(open(log).read().splitlines()) == 2
    assert list(prof.glob("*.pt.trace.json"))


# -- Rdd, rdd_utils and mllib ----------------------------------------------


def test_rdd_methods_match_the_reference():
    data = [np.float32(i) for i in range(11)]
    ours = SparkContext("local[3]").parallelize(data)
    theirs = JaxSparkContext("local[3]").parallelize(data)
    pairs = [
        (lambda r: r.filter(lambda v: v % 2 == 0).collect()),
        (lambda r: r.mapPartitions(lambda it: [sum(it)]).collect()),
        (lambda r: r.zip(r.map(lambda v: v * 2)).collect()),
        (lambda r: r.first()),
        (lambda r: r.take(4)),
        (lambda r: r.cache().unpersist().persist().count()),
        (lambda r: r.repartition(4).partitions()),
        (lambda r: r.getNumPartitions()),
    ]
    for fn in pairs:
        assert fn(ours) == fn(theirs)
    with pytest.raises(ValueError, match="partition counts differ"):
        ours.zip(ours.repartition(2))
    with pytest.raises(ValueError, match="empty"):
        Rdd([[]]).first()


def test_lazy_rows_and_to_simple_rdd_match_the_reference(memmaps):
    xm, ym = memmaps
    ours = rdd_utils.to_simple_rdd(SparkContext("local[3]"), xm, list(ym))
    theirs = jax_rdd_utils.to_simple_rdd(JaxSparkContext("local[3]"), xm, list(ym))
    assert ours.is_lazy() and theirs.is_lazy()
    assert [(p.lo, p.hi) for p in ours.partitions()] == \
        [(p.lo, p.hi) for p in theirs.partitions()]
    assert isinstance(ours.partitions()[0], LazyRows) and len(ours.partitions()[0]) == 534
    for (gx, gy), (wx, wy) in zip(rdd_utils.partition_arrays(ours),
                                  jax_rdd_utils.partition_arrays(theirs)):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    for (gx, gy), (wx, wy) in zip(LazyRows(xm, ym, 3, 5), JaxLazyRows(xm, ym, 3, 5)):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert not LazyRows(xm, ym, 4, 4) and not Rdd([]).is_lazy()
    assert ours.count() == 1600 and not Rdd([[1], LazyRows(xm, ym, 0, 1)]).is_lazy()
    with pytest.raises(ValueError, match="bad row range"):
        LazyRows(xm, ym, 5, 4)


def test_labeled_point_helpers_match_the_reference(blobs):
    x, y, _, k = blobs
    x, y = x[:30], y[:30]
    onehot = np.eye(k, dtype=np.float32)[y]
    np.testing.assert_array_equal(rdd_utils.encode_label(2, 4), jax_rdd_utils.encode_label(2, 4))
    np.testing.assert_array_equal(rdd_utils.encode_labels(y), jax_rdd_utils.encode_labels(y))
    for categorical, labels in ((False, y.astype(np.float32)), (True, onehot)):
        ours = rdd_utils.to_labeled_point(SparkContext("local[2]"), x, labels, categorical)
        theirs = jax_rdd_utils.to_labeled_point(JaxSparkContext("local[2]"), x, labels,
                                                categorical)
        assert [(p.label, p.features.toArray().tolist()) for p in ours.collect()] == \
            [(p.label, p.features.toArray().tolist()) for p in theirs.collect()]
        for got, want in zip(rdd_utils.from_labeled_point(ours, categorical, k),
                             jax_rdd_utils.from_labeled_point(theirs, categorical, k)):
            np.testing.assert_array_equal(got, want)
        for (gx, gy), (wx, wy) in zip(
                rdd_utils.lp_to_simple_rdd(ours, categorical).collect(),
                jax_rdd_utils.lp_to_simple_rdd(theirs, categorical).collect()):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert gx.dtype == wx.dtype and np.asarray(gy).dtype == np.asarray(wy).dtype


def test_linalg_and_mllib_adapter_match_the_reference():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    m, jm = mllib.to_matrix(a), jax_mllib.to_matrix(a)
    assert isinstance(m, DenseMatrix) and isinstance(jm, JaxDenseMatrix)
    np.testing.assert_array_equal(m.values, jm.values)
    np.testing.assert_array_equal(mllib.from_matrix(m), jax_mllib.from_matrix(jm))
    np.testing.assert_array_equal(mllib.from_matrix(m), a)
    v, jv = mllib.to_vector(a[0]), jax_mllib.to_vector(a[0])
    assert isinstance(v, DenseVector) and isinstance(jv, JaxDenseVector)
    np.testing.assert_array_equal(mllib.from_vector(v), jax_mllib.from_vector(jv))
    assert v == Vectors.dense(a[0]) == Vectors.dense(*a[0]) and len(v) == 4
    assert repr(v) == repr(jv) and repr(m) == repr(jm)
    assert m == DenseMatrix(3, 4, a.T.reshape(-1)) and m != DenseMatrix(4, 3, a.reshape(-1))
    assert repr(LabeledPoint(1, [0.5])) == "LabeledPoint(1.0, DenseVector([0.5]))"
    for bad in (lambda: mllib.to_matrix(a[0]), lambda: mllib.to_vector(a),
                lambda: DenseMatrix(2, 2, [1.0])):
        with pytest.raises(ValueError):
            bad()


def test_spark_mllib_model_matches_jax(blobs):
    x, y, d, k = blobs
    x, y = x[:640], y[:640]
    ref, port = _mlp_pair(d, k, seed=37)
    points = rdd_utils.to_labeled_point(SparkContext("local[4]"), x, y)
    j_points = jax_rdd_utils.to_labeled_point(JaxSparkContext("local[4]"), x, y)
    t_sm = et.SparkMLlibModel(port, num_workers=W, device="cpu")
    j_sm = JaxMLlibModel(ref, num_workers=W)
    _history_close(t_sm.train(points, epochs=EPOCHS, batch_size=BATCH),
                   j_sm.train(j_points, epochs=EPOCHS, batch_size=BATCH))
    _weights_close(port, ref)
    vectors = [DenseVector(r) for r in x[:10]]
    got = t_sm.predict(Rdd([vectors[:6], vectors[6:]]))
    want = j_sm.predict(JaxRdd([[JaxDenseVector(r) for r in x[:6]],
                                [JaxDenseVector(r) for r in x[6:10]]]))
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(t_sm.predict(vectors[0]), j_sm.predict(JaxDenseVector(x[0])),
                               atol=TOL)
