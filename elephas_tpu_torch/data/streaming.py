"""Out-of-core input streaming: the port's copy of
``elephas_tpu/data/streaming.py``.

A dataset stays in its backing store (``np.ndarray``, ``np.memmap``, an
h5py-like dataset: anything sliceable by rows) and an epoch streams as
**blocks** of ``block_steps`` worker steps:

- each worker owns a contiguous row range (the reference's ceil split),
  and a short range wraps within itself, as the staged path pads;
- :func:`prefetch_blocks` gathers the next blocks on the host in a reader
  thread, while the device runs the current one;
- :meth:`elephas_tpu_torch.worker.Runner.run_epochs_stream` takes each
  block through the same worker steps as the staged epoch, so a streamed
  fit is bit-equal to a staged one over the same row order. On ``cuda``
  the reader thread gathers each block straight into one of two reused
  pinned host buffers (:meth:`ShardedStream.gather` with ``out``), and
  the block crosses on a side stream (the reference's JAX dispatch hid
  the next ``device_put`` for free; a synchronous copy from pageable
  memory would not).

:class:`ShardedStream` gathers a worker's rows of a block with one slice
read where its index run does not wrap, and otherwise as the reference
does: the sorted unique rows, then their inverse.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator

import numpy as np


class ShardedStream:
    """Blockwise iterator over a worker-sharded dataset.

    ``x``/``y`` are row-aligned sliceable sources. Worker ``w`` owns rows
    ``[w·per_w, (w+1)·per_w)`` with ``per_w = ceil(n / W)`` (the last
    range may be short and wraps within itself). ``steps_per_epoch``
    truncates the epoch; ``num_rows`` restricts the stream to the first
    ``num_rows`` rows without slicing the source (a ``validation_split``
    over an h5py dataset must not read the training span just to drop the
    tail)."""

    def __init__(
        self,
        x,
        y,
        batch_size: int,
        num_workers: int,
        block_steps: int = 16,
        steps_per_epoch: int | None = None,
        num_rows: int | None = None,
    ):
        if len(x) != len(y):
            raise ValueError(f"x/y row mismatch: {len(x)} vs {len(y)}")
        if len(x) == 0:
            raise ValueError("cannot stream an empty dataset")
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.block_steps = max(1, block_steps)
        n = len(x)
        if num_rows is not None:
            if not 0 < num_rows <= n:
                raise ValueError(f"num_rows={num_rows} outside (0, {n}]")
            n = num_rows
        self.num_rows = n
        per_w = math.ceil(n / num_workers)
        self.starts = [min(w * per_w, n - 1) for w in range(num_workers)]
        self.counts = [max(1, min((w + 1) * per_w, n) - w * per_w) for w in range(num_workers)]
        full_steps = math.ceil(max(self.counts) / batch_size)
        self.steps = min(full_steps, steps_per_epoch) if steps_per_epoch else full_steps

    @property
    def num_blocks(self) -> int:
        return math.ceil(self.steps / self.block_steps)

    def _gather_rows(self, source, w: int, step_lo: int, step_hi: int) -> np.ndarray:
        """Rows of worker ``w`` for steps ``[step_lo, step_hi)``, wrap-padded
        within its own range: ``[steps, B, ...]``."""
        count, start = self.counts[w], self.starts[w]
        lo, hi = step_lo * self.batch_size, step_hi * self.batch_size
        if hi <= count:
            # no wrap: one ranged read (a view of an ndarray or memmap)
            rows = np.asarray(source[start + lo:start + hi])
        else:
            idx = start + (np.arange(lo, hi) % count)
            # wrap-padding repeats rows out of order; h5py's point selection
            # takes strictly increasing unique indices: read those, remap
            uniq, inverse = np.unique(idx, return_inverse=True)
            rows = np.asarray(source[uniq])[inverse]
        return rows.reshape((step_hi - step_lo, self.batch_size) + rows.shape[1:])

    def step_ranges(self) -> Iterator[tuple[int, int]]:
        """Each block's steps ``[lo, hi)``, in order."""
        for b in range(self.num_blocks):
            lo = b * self.block_steps
            yield lo, min(self.steps, lo + self.block_steps)

    def gather(self, step_lo: int, step_hi: int, out=None,
               worker_indices: list[int] | None = None) -> tuple[np.ndarray, np.ndarray]:
        """The block of steps ``[step_lo, step_hi)``: ``(x [W', s, B, ...],
        y [W', s, B, ...])``, stacked into new arrays, or written into
        ``out`` (a pair of arrays of those shapes, such as views of reused
        pinned buffers: no fresh allocation to fault in)."""
        workers = list(range(self.num_workers)) if worker_indices is None else list(worker_indices)
        parts = [[self._gather_rows(src, w, step_lo, step_hi) for w in workers]
                 for src in (self.x, self.y)]
        if out is None:
            return np.stack(parts[0]), np.stack(parts[1])
        for dst, rows in zip(out, parts):
            for i, r in enumerate(rows):
                dst[i] = r
        return out

    def blocks(self, worker_indices: list[int] | None = None
               ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        """Yields ``(x_block [W', s, B, ...], y_block, s)``, ``s`` the block's
        steps. ``worker_indices`` gathers only those workers' rows
        (``W' = len(worker_indices)``)."""
        for lo, hi in self.step_ranges():
            xb, yb = self.gather(lo, hi, worker_indices=worker_indices)
            yield xb, yb, hi - lo

    def nbytes_per_block(self) -> int:
        """Host bytes of one full block over every worker."""
        row = np.asarray(self.x[0:1]).nbytes + np.asarray(self.y[0:1]).nbytes
        return row * self.batch_size * self.block_steps * self.num_workers


def prefetch_blocks(block_iter, depth: int = 1):
    """Iterate ``block_iter`` from a reader thread through a bounded queue,
    so the next blocks are gathered while the consumer works. Peak host
    memory is ``depth + 2`` blocks (queued, gathering, consumed). An
    exception of the reader re-raises at the consumer; a consumer that
    quits (an exception in its step, the generator closed) releases the
    reader, which gathers no further block."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    errors: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def reader():
        try:
            it = iter(block_iter)
            while not stop.is_set():  # before each gather
                try:
                    item = next(it)
                except StopIteration:
                    break
                put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            errors.append(e)
        finally:
            put(sentinel)  # a lost sentinel would block the consumer

    thread = threading.Thread(target=reader, daemon=True, name="block-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                thread.join()
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5)


class ConcatRows:
    """Sliceable concatenation of row ranges of backing stores: the bridge
    from a lazy :class:`~elephas_tpu_torch.data.rdd.Rdd` (partitions as
    ``LazyRows``) to :class:`ShardedStream`'s flat row index.

    ``pieces``: ``(source, lo, hi)`` triples. Takes ``len``, an int, a
    slice and a sorted index array, without reading the whole range."""

    def __init__(self, pieces: list[tuple]):
        if not pieces:
            raise ValueError("no pieces")
        self.pieces = [(src, int(lo), int(hi)) for src, lo, hi in pieces]
        self.bounds = np.cumsum([0] + [hi - lo for _, lo, hi in self.pieces])
        # the array protocol of is_lazy_source, from a one-row probe
        src, lo, _ = self.pieces[0]
        probe = np.asarray(src[lo:lo + 1])
        self.ndim = probe.ndim
        self.dtype = probe.dtype

    def __len__(self) -> int:
        return int(self.bounds[-1])

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            if step == 1:
                return self._range(start, stop)
            idx = np.arange(start, stop, step)
        idx = np.asarray(idx)
        if idx.ndim == 0:
            p = int(np.searchsorted(self.bounds, idx, "right")) - 1
            src, lo, _ = self.pieces[p]
            return np.asarray(src[int(idx) - int(self.bounds[p]) + lo])
        out = []
        splits = np.searchsorted(idx, self.bounds[1:-1], "left")
        for p, grp in enumerate(np.split(idx, splits)):
            if len(grp):
                src, lo, _ = self.pieces[p]
                out.append(np.asarray(src[grp - int(self.bounds[p]) + lo]))
        return np.concatenate(out)

    def _range(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)``: one ranged read of each piece it spans."""
        out = []
        for p, (src, lo, _) in enumerate(self.pieces):
            a = max(start, int(self.bounds[p]))
            b = min(stop, int(self.bounds[p + 1]))
            if a < b:
                off = lo - int(self.bounds[p])
                out.append(np.asarray(src[a + off:b + off]))
        if len(out) == 1:
            return out[0]
        if not out:
            return np.asarray(self.pieces[0][0][0:0])
        return np.concatenate(out)


def lazy_rdd_sources(rdd) -> tuple[ConcatRows, ConcatRows]:
    """``(x, y)`` sliceable views over a lazy Rdd's partitions, in order."""
    parts = rdd.partitions()
    return (ConcatRows([(p.x, p.lo, p.hi) for p in parts]),
            ConcatRows([(p.y, p.lo, p.hi) for p in parts]))


def is_lazy_source(a) -> bool:
    """An out-of-core row store (memmap, h5py, zarr: an array-like with
    ``ndim``, ``dtype`` and row ``__getitem__``). A plain ndarray is
    eager; lists lack the array protocol; pandas objects are excluded
    (``df[i]`` indexes columns)."""
    if type(a) is np.ndarray or hasattr(a, "iloc"):
        return False
    return all(hasattr(a, name) for name in ("__getitem__", "__len__", "ndim", "dtype"))


def estimate_nbytes(x, y) -> int:
    """The dataset's size, without reading a lazy source."""
    total = 0
    for a in (x, y):
        nb = getattr(a, "nbytes", None)
        total += int(nb) if nb is not None else np.asarray(a[0:1]).nbytes * len(a)
    return total
