"""The port's paged KV arena (``elephas_tpu_torch.serving``: ``blocks``,
``paged_kv``, ``PagedPrefixIndex``, paged admission with preemption, the
paged engine) against the JAX package's, on the CPU.

- ``BlockAllocator`` and ``PagedPrefixIndex`` in the cases of
  ``tests/test_serving_paged.py`` (``:57``, ``:79``, ``:107``) and op for op
  against the reference's on random sequences; the paged scheduler's plans
  (slots, block tables, preemptions, their order) against the reference
  scheduler's on random request traffic, with no device work.
- ``paged_token_decode_step`` and ``paged_chunk_forward`` logits within 1e-5
  (the same math in another summation order) and pool rows within 1e-5 of
  the JAX passes on the same Keras weights (rope off with the flash
  attention, on with the naive one); the plain paged kernels against the JAX ``flash_span_decode`` /
  ``flash_span_chunk`` with ``kv_dtype`` / ``kv_scales`` on the gathered
  span, within 1e-5 of max(1, |out|).
- The engine with ``paged``, ``block_size``, ``num_blocks``, ``preemption``
  in the scenarios of ``tests/test_serving_paged.py``, each run on both
  engines with every observable compared (tokens at temperature 0, block
  tables, reuse, preemption counters, free blocks), then held to the
  scenario's own claims, tokens against the port's fixed arena.

Not mirrored: ``:188`` (a TP mesh: ROADMAP.md Queue A item 5), ``:204``
(the compile set: JAX's compile cache, which the eager port does not
have), ``:544`` and ``:588`` (the bench smokes, item 7). ``:490`` (the
telemetry series against ``stats()``) runs on the port in
``tests/test_torch_telemetry.py``.
"""

import jax
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.models.transformer import validate_token_decode_model as jax_validate
from elephas_tpu.ops import flash_serving as jfs
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import paged_kv as jpk
from elephas_tpu.serving.blocks import BlockAllocator as JaxAllocator
from elephas_tpu.serving.kv_quant import quantize_rows_np
from elephas_tpu.serving.prefix_cache import PagedPrefixIndex as JaxIndex
from elephas_tpu.serving.scheduler import Scheduler as JaxScheduler
from elephas_tpu_torch.models.transformer import validate_token_decode_model
from elephas_tpu_torch.ops import flash_serving as fs
from elephas_tpu_torch.serving import (
    BlockAllocator,
    InferenceEngine,
    PagedKVPool,
    PagedPrefixIndex,
    Scheduler,
    blocks_for,
    table_buckets,
)
from elephas_tpu_torch.serving.paged_kv import paged_chunk_forward, paged_token_decode_step

TOL = 1e-5
MIXED_PROMPTS = [[2, 3, 4, 5], [4, 5], [3, 4, 5, 2, 3, 4, 5, 2], [5, 2, 3], [2, 3, 4, 5, 2, 3]]
SHARED = [2, 3, 4, 5, 2, 3, 4, 5]  # two full blocks at block_size 4


@pytest.fixture(scope="module")
def pair():
    """An untrained LM (d_model 32, 2 layers, maxlen 64) in both packages
    from the same Keras weights."""
    cfg = dict(vocab_size=16, maxlen=64, d_model=32, num_heads=2, num_layers=2, seed=0)
    ref = jax_lm(**cfg, dropout=0.0)
    port = et.transformer_lm(**cfg, device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in ref.weights})
    return ref, port


# -- host-side bookkeeping --------------------------------------------------------

def test_block_allocator_refcounts():
    """:57 on the port."""
    a = BlockAllocator(4, 8)
    assert a.alloc(2) == [0, 1] and a.free_count == 2
    assert a.alloc(3) is None
    assert a.alloc(2) == [2, 3] and a.free_count == 0 and a.leased_count == 4
    a.ref([0])
    assert a.deref([0, 1]) == [1]
    assert a.deref([0]) == [0]
    assert a.free_count == 2 and a.alloc(2) == [0, 1]
    with pytest.raises(ValueError, match="unleased"):
        a.ref([97])
    with pytest.raises(ValueError, match="unleased"):
        a.deref([95])
    for bad in ((0, 8), (4, 0)):
        with pytest.raises(ValueError) as t_err:
            BlockAllocator(*bad)
        with pytest.raises(ValueError) as j_err:
            JaxAllocator(*bad)
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_and_index_match_the_reference_op_for_op(seed):
    """300 random allocations, references, releases, inserts, matches, hits
    and evictions on both allocators and indexes: every return value, the
    free lists, the refcounts and the index statistics agree."""
    rng = np.random.default_rng(seed)
    ours_a, theirs_a = BlockAllocator(24, 4), JaxAllocator(24, 4)
    ours, theirs = PagedPrefixIndex(ours_a), JaxIndex(theirs_a)
    tables = []  # live leases, as lists of block ids
    for _ in range(300):
        op = rng.integers(6)
        tokens = [int(t) for t in rng.integers(0, 3, rng.integers(1, 14))]
        if op == 0:
            n = int(rng.integers(0, 5))
            got, want = ours_a.alloc(n), theirs_a.alloc(n)
            assert got == want
            if got:
                tables.append(got)
        elif op == 1 and tables:
            t = tables.pop(int(rng.integers(len(tables))))
            assert ours_a.deref(t) == theirs_a.deref(t)
        elif op == 2 and tables:
            t = tables[int(rng.integers(len(tables)))]
            ours.insert(tokens[: 4 * len(t)], t)
            theirs.insert(tokens[: 4 * len(t)], t)
        elif op == 3:
            hit = theirs.match(tokens)
            assert ours.match(tokens) == hit and ours.match_len(tokens) == hit[1]
            if hit[0] is not None:
                shared = theirs.commit_hit(*hit)
                assert ours.commit_hit(*hit) == shared
                tables.append(shared)
            else:
                ours.record_miss()
                theirs.record_miss()
        elif op == 4:
            n = int(rng.integers(1, 6))
            assert ours.evict_for(n) == theirs.evict_for(n)
        elif op == 5 and rng.random() < 0.1:
            ours.flush()
            theirs.flush()
        assert ours_a.free_count == theirs_a.free_count
        assert all(ours_a.ref_count(b) == theirs_a.ref_count(b) for b in range(24))
        assert ours.stats() == theirs.stats()


def test_paged_prefix_index_full_block_matching():
    """:79 on the port."""
    a = BlockAllocator(8, 4)
    idx = PagedPrefixIndex(a)
    blocks = a.alloc(3)
    idx.insert(tuple(range(2, 12)), blocks)
    assert a.ref_count(blocks[0]) == 2 and a.ref_count(blocks[2]) == 1
    eid, reuse = idx.match(tuple(range(2, 12)) + (7,))
    assert eid is not None and reuse == 8
    assert idx.hits == 0 and idx.misses == 0
    assert idx.commit_hit(eid, reuse) == blocks[:2] and idx.shared_blocks == 2
    assert a.ref_count(blocks[0]) == 3
    assert idx.match(tuple(range(2, 10)))[1] == 4
    assert idx.match((2, 3, 4)) == (None, 0)


def test_paged_prefix_index_eviction_frees_only_unreferenced():
    """:107 on the port."""
    a = BlockAllocator(8, 4)
    idx = PagedPrefixIndex(a)
    t1 = a.alloc(2)
    idx.insert(tuple(range(10, 18)), t1)
    a.deref(t1)
    t2 = a.alloc(2)
    idx.insert(tuple(range(30, 38)), t2)
    assert a.free_count == 4
    assert idx.evict_for(2) == 2 and a.free_count == 6
    assert idx.evict_for(1) == 0
    assert idx.stats()["entries"] == 1 and a.ref_count(t2[0]) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_scheduler_decisions_match_the_reference(seed):
    """Random traffic (ragged prompts over a 3-token alphabet, priorities,
    budgets) through both paged schedulers with preemption and the prefix
    index, tokens fed by hand and prefills completed at random: every
    admission's slot, table, shared length and resume, every preemption's
    victim, blocks and cursor, and the queue order agree, step by step."""
    rng = np.random.default_rng(seed)
    scheds = []
    for cls, alloc in ((Scheduler, BlockAllocator), (JaxScheduler, JaxAllocator)):
        scheds.append(cls(3, (16, 32, 64), prefix_cache=True, prefix_min_reuse=2,
                          allocator=alloc(14, 4), preemption=True))
    ours, theirs = scheds
    reqs = ({}, {})
    prefilling = [set(), set()]
    for _ in range(60):
        if rng.random() < 0.5:
            prompt = [int(t) for t in rng.integers(2, 5, rng.integers(2, 14))]
            kw = dict(max_new_tokens=int(rng.integers(1, 10)), priority=int(rng.integers(0, 3)))
            for s, r in zip(scheds, reqs):
                req = s.submit(s.make_request(prompt, **kw))
                r[req.rid - s.rid_base] = req
        plans = [s.admit_paged(prefilling=frozenset(p)) for s, p in zip(scheds, prefilling)]
        for (adms, pres), s, p in zip(plans, scheds, prefilling):
            for pre in pres:
                p.discard(pre.slot)
            for a in adms:
                if a.resume is None:
                    p.add(a.slot)
        (a0, p0), (a1, p1) = plans
        assert [(a.req.rid - ours.rid_base, a.slot, list(a.blocks), a.shared_len,
                 a.resume is not None) for a in a0] == \
            [(a.req.rid - theirs.rid_base, a.slot, list(a.blocks), a.shared_len,
              a.resume is not None) for a in a1]
        assert [(x.req.rid - ours.rid_base, x.slot, tuple(x.blocks), x.cur_len) for x in p0] == \
            [(x.req.rid - theirs.rid_base, x.slot, tuple(x.blocks), x.cur_len) for x in p1]
        # a prefill completes on some slots; decode tokens on the others
        done_prefill = [slot for slot in sorted(prefilling[0]) if rng.random() < 0.6]
        tokens = {slot: int(rng.integers(2, 5)) for slot in sorted(ours.active)}
        for s, p in zip(scheds, prefilling):
            for slot in done_prefill:
                s.on_prefill_complete(s.active[slot])
                p.discard(slot)
            for slot, tok in tokens.items():
                if slot in p:
                    continue
                if s.on_token(slot, tok):
                    s.reclaim(slot)
        assert ours.tables == theirs.tables
        assert [r.rid - ours.rid_base for r in ours.waiting] == \
            [r.rid - theirs.rid_base for r in theirs.waiting]
        assert ours.prefix_index.stats() == {k: v for k, v in theirs.prefix_index.stats().items()}
        assert ours.allocator.free_count == theirs.allocator.free_count


# -- the paged passes against the JAX graph replays --------------------------------

def _pool_close(pool, j_pool, n):
    for name, leaves in j_pool.items():
        for got, want in zip(pool.caches[name], leaves):
            np.testing.assert_allclose(got.numpy()[:n], np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("rope,attention", [(False, "flash"), (True, "naive")])
def test_paged_passes_match_jax(pair, rope, attention):
    """Three rows of four over shuffled block tables (block 4, sentinel
    padding): two chunks (the second resuming where the first stopped, one
    row inactive), then three decode steps with an inactive lane; logits
    of the live rows and every pool row against the JAX passes."""
    maxlen, bs, n_blocks, slots = 64, 4, 24, 4
    if rope:
        cfg = dict(vocab_size=16, maxlen=maxlen, d_model=32, num_heads=2, num_layers=2,
                   rope=True, seed=3)
        ref = jax_lm(**cfg)
        port = et.transformer_lm(**cfg, device="cpu")
        et.load_keras_weights(port, {v.path: np.asarray(v) for v in ref.weights})
    else:
        ref, port = pair
    w = {v.path: v.value for v in ref.variables}
    layers, _, _ = jax_validate(ref)
    j_pool = jpk.PagedKVPool(layers, n_blocks, bs).init()
    pool = PagedKVPool(validate_token_decode_model(port), n_blocks, bs, "cpu")
    rng = np.random.default_rng(7)
    tables = np.full((slots, 8), n_blocks, np.int32)
    ids = rng.permutation(n_blocks)
    for s, n in enumerate((6, 5, 0, 4)):
        tables[s, :n] = ids[6 * s: 6 * s + n]
    chunk = jax.jit(lambda w, toks, pool, tables, offs, lens, act: jpk.paged_chunk_forward(
        ref, w, toks, pool, tables, offs, lens, act, bs, maxlen, local=True,
        attention=attention))
    decode = jax.jit(lambda w, tok, positions, pool, tables, act: jpk.paged_token_decode_step(
        ref, w, tok, positions, pool, tables, bs, maxlen, act, local=True,
        attention=attention))
    t_tables = torch.from_numpy(tables)
    for offs, lens, act in (([0, 0, 0, 0], [8, 5, 0, 3], [True, True, False, True]),
                            ([8, 5, 0, 3], [6, 8, 0, 0], [True, True, False, False])):
        toks = rng.integers(0, 16, (slots, 8)).astype(np.int32)
        offs, lens = np.asarray(offs, np.int32), np.asarray(lens, np.int32)
        act = np.asarray(act)
        j_logits, j_pool = chunk(w, toks, j_pool, tables, offs, lens, act)
        with torch.inference_mode():
            logits = paged_chunk_forward(port, torch.from_numpy(toks).long(), pool, t_tables,
                                         torch.from_numpy(offs), torch.from_numpy(lens),
                                         torch.from_numpy(act), attention)
        for i in np.flatnonzero(act):
            np.testing.assert_allclose(logits.numpy()[i, :lens[i]],
                                       np.asarray(j_logits)[i, :lens[i]], atol=TOL, rtol=0)
    _pool_close(pool, j_pool, n_blocks)
    positions = np.array([14, 13, 30, 3], np.int32)
    act = np.array([True, True, False, True])
    for _ in range(3):
        tok = rng.integers(0, 16, slots).astype(np.int32)
        j_logits, j_pool = decode(w, tok, positions, j_pool, tables, act)
        with torch.inference_mode():
            logits = paged_token_decode_step(port, torch.from_numpy(tok).long(),
                                             torch.from_numpy(positions), pool, t_tables,
                                             torch.from_numpy(act), attention)
        np.testing.assert_allclose(logits.numpy()[act], np.asarray(j_logits)[act], atol=TOL,
                                   rtol=0)
        positions = positions + act
    _pool_close(pool, j_pool, n_blocks)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_plain_paged_kernels_match_jax_on_the_gathered_span(kv_dtype, d=32):
    """``paged_span_decode_reference`` / ``paged_span_chunk_reference`` on a
    pool with shuffled, sentinel-padded tables against the JAX
    ``flash_span_decode`` / ``flash_span_chunk`` with ``kv_dtype`` and
    ``kv_scales`` over the span gathered from the same pool, within 1e-5
    of max(1, |out|); positions ragged, one past the span."""
    rng = np.random.default_rng(d)
    b, h, bs, t, c = 4, 3, 4, 6, 5
    n = b * t + 2
    rows = rng.standard_normal((2, n + 1, bs, h, d)).astype(np.float32)
    tables = rng.permutation(n)[: b * t].reshape(b, t).astype(np.int32)
    tables[-1, t // 2:] = n
    if kv_dtype == "fp":
        leaves = [rows[0], rows[1]]
        scales = None
    else:
        (kq_, ks), (vq_, vs) = (quantize_rows_np(r, kv_dtype) for r in rows)
        leaves, scales = [kq_, vq_], (ks, vs)
    span = t * bs

    def gather(z):
        return z[tables].reshape(b, span, *z.shape[2:])

    j_scales = None if scales is None else tuple(gather(s) for s in scales)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    pos = np.array([0, span - 1, span + 3, 9], np.int32)
    want = np.asarray(jfs.flash_span_decode(q, gather(leaves[0]), gather(leaves[1]), pos,
                                            kv_dtype=kv_dtype, kv_scales=j_scales))
    tt = [torch.from_numpy(z) for z in leaves]
    ts = None if scales is None else tuple(torch.from_numpy(s) for s in scales)
    got = fs.paged_span_decode_reference(torch.from_numpy(q), *tt, torch.from_numpy(tables),
                                         torch.from_numpy(pos), kv_dtype=kv_dtype,
                                         kv_scales=ts).numpy()
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= TOL
    qc = rng.standard_normal((b, h, c, d)).astype(np.float32)
    pm = (np.array([0, span - c, span - 2, 7])[:, None] + np.arange(c)).astype(np.int32)
    want = np.asarray(jfs.flash_span_chunk(qc, gather(leaves[0]), gather(leaves[1]), pm,
                                           kv_dtype=kv_dtype, kv_scales=j_scales))
    got = fs.paged_span_chunk_reference(torch.from_numpy(qc), *tt, torch.from_numpy(tables),
                                        torch.from_numpy(pm), kv_dtype=kv_dtype,
                                        kv_scales=ts).numpy()
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= TOL


def test_table_ladder_matches_jax():
    for m in (1, 2, 5, 8, 33):
        assert table_buckets(m) == jpk.table_buckets(m)
        assert blocks_for(m, 4) == jpk.blocks_for(m, 4)
    assert blocks_for(0, 4) == 0


# -- the engine: the reference's scenarios, on both engines --------------------------

def _tokens(reqs):
    return [list(map(int, r.full_sequence)) for r in reqs]


def _drain(engine, reqs):
    while engine.scheduler.has_work:
        engine.step()
    return _tokens(reqs)


def _paged_vs_fixed(engine_cls, model):
    """:136 — the paged engine's tokens (the claims hold them to the port's
    fixed arena, itself token-exact with the JAX one)."""
    engine = engine_cls(model, num_slots=4, paged=True, block_size=8)
    return dict(tokens=_drain(engine, [engine.submit(p, 8) for p in MIXED_PROMPTS]))


def _window_and_chunks(engine_cls, model):
    """:155 — steps_per_sync > 1 and chunked prefill compose with paging."""
    engine = engine_cls(model, num_slots=4, paged=True, block_size=8, steps_per_sync=4,
                        prefill_chunk=4)
    return dict(tokens=_drain(engine, [engine.submit(p, 7) for p in MIXED_PROMPTS]))


def _reclamation(engine_cls, model):
    """:167 — a tight pool: blocks and slots recycle mid-flight."""
    engine = engine_cls(model, num_slots=2, paged=True, block_size=4, num_blocks=8)
    reqs = [engine.submit(p, 6) for p in MIXED_PROMPTS]
    tables = []
    while engine.scheduler.has_work:
        engine.step()
        tables.append({s: list(t) for s, t in engine.scheduler.tables.items()})
    return dict(tokens=_tokens(reqs), tables=tables,
                free=engine.scheduler.allocator.free_count,
                slots=sorted(engine.scheduler._free), live=dict(engine.scheduler.tables))


def _prefix_splice(engine_cls, model):
    """:238 — a hit splices two full blocks copy-free."""
    engine = engine_cls(model, num_slots=4, paged=True, block_size=4, prefix_cache=True)
    cold = engine.submit(SHARED + [2], 6)
    engine.run()
    warm = engine.submit(SHARED + [3], 6)
    engine.run()
    st = engine.stats()
    return dict(tokens=_tokens([cold, warm]), reused=[cold.reused_tokens, warm.reused_tokens],
                shared=st["prefix_blocks_shared"], cache=st["prefix_cache"],
                probe=engine.prefix_warm_probe(SHARED + [5]))


def _shared_survive(engine_cls, model):
    """:263 — shared blocks survive index eviction under pool pressure."""
    engine = engine_cls(model, num_slots=2, paged=True, block_size=4, num_blocks=10,
                        prefix_cache=True)
    engine.run([(SHARED + [2], 4)])
    idx = engine.scheduler.prefix_index
    seeded = (idx.stats()["entries"], engine.scheduler.allocator.free_count)
    warm = engine.submit(SHARED + [3], 8)
    churn = [engine.submit([4, 5, 2, 3, 4, 5, 2, t], 8) for t in (3, 4, 5)]
    tokens = _drain(engine, [warm] + churn)
    held = sorted({b for e in idx._entries.values() for b in e.blocks})
    return dict(seeded=seeded, tokens=tokens, reused=warm.reused_tokens, held=held,
                free=engine.scheduler.allocator.free_count, cache=idx.stats())


def _preempt_resume(engine_cls, model):
    """:307 — a priority arrival preempts; the victim resumes bit-exact."""
    engine = engine_cls(model, num_slots=4, paged=True, block_size=4, num_blocks=8,
                        preemption=True)
    victim = engine.submit([2, 3, 4, 5], 12)
    for _ in range(3):
        engine.step()
    before = len(victim.tokens)
    hi = engine.submit([3, 4, 5, 2, 3, 4, 5, 2], 12, priority=1)
    tokens = _drain(engine, [victim, hi])
    st = engine.stats()
    return dict(before=before, tokens=tokens, preemptions=st["preemptions"],
                resumes=st["resumes"], offloaded=st["offloaded_blocks"],
                pending=len(engine._offloaded), free=engine.scheduler.allocator.free_count)


def _equal_priority(engine_cls, model):
    """:342 — an equal-priority arrival waits."""
    engine = engine_cls(model, num_slots=4, paged=True, block_size=4, num_blocks=4,
                        preemption=True)
    first = engine.submit([2, 3, 4, 5], 8)
    engine.step()
    second = engine.submit([3, 4, 5, 2], 8)
    engine.step()
    waiting = (second.slot, first.slot, engine.stats()["preemptions"])
    return dict(waiting=waiting, tokens=_drain(engine, [first, second]),
                preemptions=engine.stats()["preemptions"])


def _same_wave(engine_cls, model):
    """:404 — a request admitted by a wave is never that wave's victim."""
    engine = engine_cls(model, num_slots=4, paged=True, block_size=4, num_blocks=6,
                        preemption=True)
    low = engine.submit([2, 3, 4, 5], 12)
    hi = engine.submit([3, 4, 5, 2, 3, 4], 10, priority=1)
    engine.step()
    first = (low.slot, len(low.tokens), hi.slot, engine.stats()["preemptions"])
    return dict(first=first, tokens=_drain(engine, [low, hi]),
                free=engine.scheduler.allocator.free_count)


def _unfittable(engine_cls, model):
    """:446 — rejected at submit, never queued; later traffic serves."""
    engine = engine_cls(model, num_slots=2, paged=True, block_size=4, num_blocks=4)
    bad = engine.submit(list(range(2, 12)) * 2, 10)
    # the message after the rid (each package mints rids from its own base)
    state = (type(bad.error).__name__, str(bad.error).split(" needs ", 1)[-1], bad.done,
             len(engine.scheduler.waiting), engine.stats()["rejected"])
    ok = engine.submit([2, 3], 3)
    return dict(state=state, tokens=_drain(engine, [ok]))


SCENARIOS = {f.__name__[1:]: f for f in (_paged_vs_fixed, _window_and_chunks, _reclamation,
                                         _prefix_splice, _shared_survive, _preempt_resume,
                                         _equal_priority, _same_wave, _unfittable)}


def _claims(name, got, fixed):
    """The reference scenario's own claims, on the port's results; tokens
    against the port's fixed arena (``fixed(pairs)``: the full sequences of
    ``(prompt, max_new_tokens)`` pairs served by one fixed-arena engine)."""
    if name == "paged_vs_fixed":
        assert got["tokens"] == fixed([(p, 8) for p in MIXED_PROMPTS])
    elif name == "window_and_chunks":
        assert got["tokens"] == fixed([(p, 7) for p in MIXED_PROMPTS])
    elif name == "reclamation":
        assert got["tokens"] == fixed([(p, 6) for p in MIXED_PROMPTS])
        assert got["free"] == 8 and got["slots"] == [0, 1] and not got["live"]
    elif name == "prefix_splice":
        assert got["reused"] == [0, 8] and got["shared"] == 2 and got["cache"]["hits"] == 1
        assert got["tokens"] == fixed([(SHARED + [2], 6), (SHARED + [3], 6)])
        assert got["probe"] == 8
    elif name == "shared_survive":
        assert got["seeded"] == (1, 8) and got["reused"] == 8
        assert got["free"] == 10 - len(got["held"])
        assert got["tokens"] == fixed([(SHARED + [3], 8)] + [([4, 5, 2, 3, 4, 5, 2, t], 8)
                                                             for t in (3, 4, 5)])
    elif name == "preempt_resume":
        assert got["before"] >= 3 and got["preemptions"] == 1 and got["resumes"] == 1
        assert got["offloaded"] >= 1 and got["pending"] == 0 and got["free"] == 8
        assert got["tokens"] == fixed([([2, 3, 4, 5], 12), ([3, 4, 5, 2, 3, 4, 5, 2], 12)])
    elif name == "equal_priority":
        assert got["waiting"][0] is None and got["waiting"][1] is not None
        assert got["waiting"][2] == 0 and got["preemptions"] == 0
        assert got["tokens"] == fixed([([2, 3, 4, 5], 8), ([3, 4, 5, 2], 8)])
    elif name == "same_wave":
        assert got["first"][0] is not None and got["first"][1] >= 1 and got["first"][3] == 0
        assert got["free"] == 6
        assert got["tokens"] == fixed([([2, 3, 4, 5], 12), ([3, 4, 5, 2, 3, 4], 10)])
    else:
        assert got["state"][0] == "RuntimeError" and "can never be admitted" in got["state"][1]
        assert got["state"][2:] == (True, 0, 1)
        assert got["tokens"] == fixed([([2, 3], 3)])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_the_jax_engine(pair, name):
    """Each scenario on both engines, every observable equal; then the
    scenario's own claims on the port's results."""
    ref, port = pair
    want = SCENARIOS[name](JaxEngine, ref)
    got = SCENARIOS[name](InferenceEngine, port)
    assert got == want

    def fixed(pairs):
        engine = InferenceEngine(port, num_slots=4)
        return _drain(engine, [engine.submit(p, n) for p, n in pairs])

    _claims(name, got, fixed)


def test_window_overrun_never_clobbers_block_zero(pair):
    """:366 — a finished slot that runs out its window past the whole table
    bucket writes to the sink, not block 0: the owner's blocks are bitwise
    the same with and without the overrunning neighbour, and within 1e-5 of
    the JAX engine's."""
    ref, port = pair

    def owner_blocks(engine_cls, model, with_runner):
        engine = engine_cls(model, num_slots=2, paged=True, block_size=4, steps_per_sync=8)
        owner = engine.submit([2, 3], 6)
        if with_runner:
            engine.submit([4, 5, 2, 3, 4, 5], 2)
        engine.run()
        pool = engine._caches if engine_cls is JaxEngine else engine.arena.caches
        k = next(iter(pool.values()))[0]
        return list(map(int, owner.full_sequence)), np.asarray(k)[:2].copy()

    seq0, alone = owner_blocks(InferenceEngine, port, False)
    seq1, crowded = owner_blocks(InferenceEngine, port, True)
    np.testing.assert_array_equal(alone, crowded)
    j_seq, j_crowded = owner_blocks(JaxEngine, ref, True)
    assert seq0 == seq1 == j_seq
    np.testing.assert_allclose(crowded, j_crowded, atol=TOL, rtol=0)


@pytest.mark.parametrize("kwargs", [dict(block_size=8), dict(num_blocks=4),
                                    dict(paged=True, block_size=0),
                                    dict(paged=True, block_size=999), dict(preemption=True),
                                    dict(paged=True, num_blocks=0)])
def test_paged_knobs_require_paged_word_for_word(pair, kwargs):
    """:436 and :474: the knobs need paged=True, block_size inside (0,
    maxlen], preemption the paged arena; the messages are the reference's."""
    ref, port = pair
    with pytest.raises(ValueError) as j_err:
        JaxEngine(ref, num_slots=2, **kwargs)
    with pytest.raises(ValueError) as t_err:
        InferenceEngine(port, num_slots=2, **kwargs)
    assert str(t_err.value) == str(j_err.value)


def test_paged_stats_and_cancel(pair):
    """stats() reads the allocator (free, leased) and the index (shared
    blocks) directly; cancelling a preempted request drops its offload."""
    _, port = pair
    engine = InferenceEngine(port, num_slots=2, paged=True, block_size=4, num_blocks=8,
                             prefix_cache=True, preemption=True)
    engine.run([(SHARED + [2], 4)])
    engine.run([(SHARED + [3], 4)])
    st = engine.stats()
    alloc = engine.scheduler.allocator
    assert st["blocks_total"] == 8 and st["blocks_free"] == alloc.free_count
    assert st["blocks_leased"] == alloc.leased_count == 2
    assert st["prefix_blocks_shared"] == 2 == st["prefix_cache"]["shared_blocks"]
    victim = engine.submit([2, 3, 4, 5], 12)
    engine.step()
    engine.step()
    engine.submit([3, 4, 5, 2, 3, 4, 5, 2], 12, priority=1)
    engine.step()
    assert engine.stats()["preemptions"] == 1 and victim.rid in engine._offloaded
    assert engine.cancel(victim.rid) and victim.rid not in engine._offloaded
    engine.run()
    assert engine.stats()["blocks_free"] == 8 - alloc.leased_count
