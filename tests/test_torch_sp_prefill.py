"""The port's sequence-parallel prefill (``serving/sp_prefill.py`` and the
engine's ``sp_prefill``) against the JAX package's, on the CPU.

Mirrors ``tests/test_serving_flash.py``'s SP cases. The token-exact cases
run on the shared ``serving_lm`` fixture (the trained periodic toy), its
Keras weights loaded into the port; the others on an untrained LM of its
widths (their checks read no trained margins). With ``sp_prefill`` over a
mesh of 2 positions (the JAX
engine over 2 of the conftest's virtual devices, the port's over a
:class:`~elephas_tpu_torch.parallel.mesh.Mesh` naming the CPU twice) the
port's engine is token-exact with the JAX engine with ``sp_prefill`` and
with its own paged engine, ring and Ulysses, fp and int8 pools; the long
prompt's prefill observation carries ``bucket="sp32"`` and the trace a
``serve.sp_prefill`` span; every validation message matches the
reference's word for word. ``sp_prefill_forward``'s logits and K/V rows
agree with the single-device prefill within 1e-5.
"""

import functools
import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import elephas_tpu_torch as et
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu_torch import InferenceEngine, telemetry
from elephas_tpu_torch.ops import ring_attention as ra
from elephas_tpu_torch.parallel.mesh import Mesh
from elephas_tpu_torch.serving.sp_prefill import sp_pad_len, sp_prefill_forward

LONG = np.random.default_rng(0).integers(2, 6, size=20).astype(np.int32)
SHORT = np.array([2, 3, 4], np.int32)
WORKLOAD = [(LONG, 8), (SHORT, 5)]


def _drain(engine, workload):
    out = engine.run([(p, mn) for p, mn in workload])
    return [np.asarray(seq).tolist() for _rid, seq in sorted(out.items())]


@pytest.fixture(scope="module")
def lm(serving_lm):
    port = et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2,
                             device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in serving_lm.weights})
    return port


@pytest.fixture(scope="module")
def small_lm():
    """An untrained port LM of serving_lm's widths."""
    return et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2,
                             seed=0, device="cpu")


@functools.cache
def _small_jax_lm():
    """An untrained JAX LM of serving_lm's widths: the refusals read only
    its shape."""
    return jax_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2)


def _jax_mesh(w):
    return JaxMesh(np.array(jax.devices()[:w]), ("seq",))


def _mesh(w):
    return Mesh(["cpu"] * w, ("seq",))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("mechanism", ["ring", "ulysses"])
def test_sp_prefill_token_exact(serving_lm, lm, mechanism, kv_dtype, monkeypatch):
    """A long prompt prefilled over the SP mesh decodes the JAX SP
    engine's tokens and the port's own paged engine's; the short prompt
    below the threshold keeps the normal path. The long prompt's
    attention went through the flash forward over the mesh."""
    kw = dict(num_slots=2, paged=True, block_size=8, kv_dtype=kv_dtype)
    ref = InferenceEngine(lm, **kw)
    want = _drain(ref, WORKLOAD)
    ref.release_telemetry()
    jax_eng = JaxEngine(serving_lm, sp_prefill=_jax_mesh(2), sp_threshold=16,
                        sp_mechanism=mechanism, **kw)
    try:
        assert _drain(jax_eng, WORKLOAD) == want
    finally:
        jax_eng.release_telemetry()
    launched = []
    real = ra._flash_forward
    monkeypatch.setattr(ra, "_flash_forward",
                        lambda *a: launched.append(a[0].shape) or real(*a))
    calls = []
    import elephas_tpu_torch.serving.engine as engine_mod

    monkeypatch.setattr(engine_mod, "sp_prefill_forward",
                        lambda *a: calls.append(a[1].shape) or sp_prefill_forward(*a))
    eng = InferenceEngine(lm, sp_prefill=_mesh(2), sp_threshold=16, sp_mechanism=mechanism,
                          **kw)
    try:
        assert _drain(eng, WORKLOAD) == want
        assert calls == [(1, 32)]  # the long prompt only, padded to 32
        # the ring's 3 causal pairs a layer; Ulysses runs the flash
        # attention of its head groups instead
        assert len(launched) == (3 * 2 if mechanism == "ring" else 0)
        assert 'bucket="sp32"' in eng.scrape()
        eng.run([(LONG, 8)])  # a second long prompt takes the same path
        assert calls == [(1, 32)] * 2
    finally:
        eng.release_telemetry()


def test_sp_prefill_trace_span_and_flight_record(small_lm):
    """The SP forward records a ``serve.sp_prefill`` span, and ``explain``
    names its padded length, shards and mechanism."""
    eng = InferenceEngine(small_lm, num_slots=2, paged=True, block_size=8, sp_prefill=_mesh(2),
                          sp_threshold=16)
    try:
        r = eng.submit(LONG, 4)
        eng.run()
        names = [e["name"] for e in telemetry.tracer().events()]
        assert "serve.sp_prefill" in names
        rec = eng.explain(r.rid)["sp_prefill"]
        assert (rec["padded"], rec["shards"], rec["mechanism"]) == (32, 2, "ring")
    finally:
        eng.release_telemetry()


def test_sp_prefill_forward_matches_the_single_device_prefill(small_lm):
    """Logits and each layer's K/V rows of the SP forward (the ring at
    W = 2 and 4, Ulysses at W = 2: the model has 2 heads) against the plain
    whole-prompt forward."""
    lm = small_lm
    tokens = torch.from_numpy(np.resize(LONG, 32).astype(np.int64))[None]
    with torch.inference_mode():
        want = lm(tokens, plain=True)
        x = lm.tok_embed(tokens) + lm.positions[:32]
        rows = []
        for block in lm.blocks:
            h = block.ln1(x)
            qkv = block.attn.qkv(h).view(1, 32, 3, 2, 16)
            rows.append((qkv[0, :, 1], qkv[0, :, 2]))
            x = block(x, plain=True)
        for w, mechanism in ((2, "ring"), (4, "ring"), (2, "ulysses")):
            logits, kv = sp_prefill_forward(lm, tokens, _mesh(w), "seq", mechanism)
            np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
            for (k, v), (kr, vr) in zip(kv.values(), rows):
                np.testing.assert_allclose(k.numpy(), kr.numpy(), atol=1e-5, rtol=1e-5)
                np.testing.assert_allclose(v.numpy(), vr.numpy(), atol=1e-5, rtol=1e-5)


def test_sp_pad_len_matches_the_reference():
    from elephas_tpu.serving.sp_prefill import sp_pad_len as jax_sp_pad_len

    for p in (1, 7, 16, 17, 300, 500, 513):
        for sp in (1, 2, 4, 8):
            for maxlen in (32, 512, 1024):
                assert sp_pad_len(p, sp, maxlen) == jax_sp_pad_len(p, sp, maxlen)


def test_sp_prefill_falls_back_loudly_without_a_pad_length(caplog):
    """A prompt whose power-of-two pad length exceeds ``maxlen`` takes the
    single-device path, with the reference's warning, and decodes the
    paged engine's tokens."""
    small = et.transformer_lm(vocab_size=8, maxlen=24, d_model=32, num_heads=2, num_layers=1,
                              device="cpu")
    kw = dict(num_slots=2, paged=True, block_size=8)
    want = _drain(InferenceEngine(small, **kw), [(LONG, 3)])
    eng = InferenceEngine(small, sp_prefill=_mesh(2), sp_threshold=16, **kw)
    with caplog.at_level(logging.WARNING, logger="elephas_tpu_torch.serving.engine"):
        assert _drain(eng, [(LONG, 3)]) == want
    assert "no power-of-two pad length inside maxlen=24" in caplog.text
    assert 'bucket="sp' not in eng.scrape()
    eng.release_telemetry()


@pytest.mark.parametrize("kwargs", [
    dict(sp_prefill="mesh2"),
    dict(paged=True, sp_prefill="mesh2", sp_axis="workers"),
    dict(paged=True, sp_prefill="mesh2", sp_mechanism="tree"),
    dict(paged=True, sp_prefill="mesh4", sp_mechanism="ulysses"),
    dict(paged=True, sp_prefill="mesh3"),
    dict(paged=True, sp_prefill="mesh2", sp_threshold=0),
    dict(sp_threshold=8),
    dict(sp_axis="ring"),
    dict(sp_mechanism="ulysses"),
])
def test_sp_prefill_knob_validation(small_lm, kwargs):
    """Every refusal of the reference's, word for word (the LMs have 2
    heads, so a 4-wide axis cannot run Ulysses; a 3-wide axis divides no
    power-of-two pad length). A decode mesh beside the SP mesh, which the
    reference refuses as not UNMESHED, is refused by the port as an
    unported option (ROADMAP.md, Queue A item 5)."""
    def build(engine, mesh):
        args = dict(kwargs, num_slots=2)
        if "sp_prefill" in args:
            args["sp_prefill"] = mesh(int(args["sp_prefill"][-1]))
        return engine(_small_jax_lm() if engine is JaxEngine else small_lm, **args)

    with pytest.raises(ValueError) as j_err:
        build(JaxEngine, _jax_mesh)
    with pytest.raises(ValueError) as t_err:
        build(InferenceEngine, _mesh)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue A item 5\b"):
        InferenceEngine(small_lm, num_slots=2, paged=True, mesh="mesh", sp_prefill=_mesh(2))
