"""The ``mixed_bfloat16`` policy of the port against the JAX package's, on
the CPU: ``transformer_classifier``, ``transformer_lm`` and a small
``resnet`` from the same Keras weights, their float32 variables and
heads, greedy ``generate``, and the refusal of a mixed model by the
cached decode and the engine.

The JAX side runs as its own tests run it (Pallas in interpret mode). The
two sides round bf16 in different places (XLA fuses elementwise chains
and keeps some intermediates in float32; PyTorch rounds after each op),
so values differ by a few bf16 units in the last place. Tolerances:
- forward, relative to max(1, |value|) (``_close``): 2e-2 for
  probabilities (seen: 1e-3), 4e-2 for the LM's logits (seen: 2.5e-2):
  one bf16 unit of the final LayerNorm's outputs, which reach 3, is
  0.016, and the float32 head sums d_model of them;
- one batch's gradients against JAX's taken op by op, each tensor
  relative to its largest gradient (``TOL_GRAD``): 5e-2 for the
  transformers (seen: 3.0e-2 and 3.2e-2, at a bias: the sum of 128 bf16
  rows; kernels and LayerNorm parameters 1.9e-2 at most) and 1e-2 for
  ResNet (seen: 4.4e-3);
- a 2-epoch fit (:func:`test_mixed_fit_matches_jax`): history against
  the reference's ``SparkModel.fit`` within ``TOL_FIT`` of max(1,
  |value|), and each tensor's update ``w_final − w_init`` against the
  reference's op by op (``_reference_fit``), relative to that update
  (``TOL_UPDATE``).
"""

import jax
import keras
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.models import resnet as jax_resnet
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.models.transformer import generate as jax_generate
from elephas_tpu.serving import InferenceEngine as JaxInferenceEngine
from elephas_tpu_torch.models.layers import Dense, apply_policy
from elephas_tpu_torch.utils.weights import _keras_paths

MIXED = "mixed_bfloat16"
TOL = 2e-2
TOL_LOGITS = 4e-2
TOL_GRAD = {"classifier": 5e-2, "lm": 5e-2, "resnet": 1e-2}
TOL_FIT = {"classifier": 1e-2, "lm": 1e-2, "resnet": 5e-2}
# update error: Adam's (the transformers) as ||Δ_port − Δ_ref|| / ||Δ_ref||,
# SGD's (ResNet) as max|Δ_port − Δ_ref| / max|Δ_ref|, per tensor
TOL_UPDATE = {"classifier": 0.3, "lm": 0.15, "resnet": 5e-2}
# the top-2 margin of chip_smoke.py: tokens must agree where it is cleared
MARGIN = 1e-3

CASES = {
    "classifier": (jax_classifier, et.transformer_classifier,
                   dict(vocab_size=61, maxlen=16, num_classes=3, d_model=32, num_heads=2,
                        num_layers=2, dropout=0.0, seed=1)),
    "lm": (jax_lm, et.transformer_lm,
           dict(vocab_size=17, maxlen=16, d_model=32, num_heads=2, num_layers=2, seed=2)),
    "lm_rope": (jax_lm, et.transformer_lm,
                dict(vocab_size=17, maxlen=16, d_model=32, num_heads=2, num_layers=2,
                     rope=True, seed=3)),
    "resnet": (jax_resnet, et.resnet,
               dict(input_shape=(16, 16, 3), num_classes=5, depths=(1, 1), width=8, seed=4)),
}


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


def _pair(name, **overrides):
    j_build, t_build, cfg = CASES[name]
    cfg = {**cfg, **overrides}
    ref = j_build(**cfg, dtype_policy=MIXED)
    port = t_build(**cfg, dtype_policy=MIXED, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    return ref, port


def _data(name, rows, seed=0):
    rng = np.random.default_rng(seed)
    if name == "resnet":
        x = rng.normal(size=(rows, 16, 16, 3)).astype(np.float32)
        return x, rng.integers(0, 5, rows).astype(np.int32)
    vocab, maxlen = CASES[name][2]["vocab_size"], CASES[name][2]["maxlen"]
    x = rng.integers(0, vocab, (rows, maxlen)).astype(np.int32)
    if name == "classifier":
        return x, rng.integers(0, 3, rows).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _close(got, want, tol, what):
    """|got − want| ≤ tol·max(1, |want|) elementwise; returns the largest
    ratio of the error to max(1, |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())
    assert err <= tol, f"{what}: {err} > {tol}"
    return err


def _torch_in(x):
    t = torch.from_numpy(x)
    return t.long() if not t.is_floating_point() else t


@pytest.mark.parametrize("name", list(CASES))
def test_mixed_forward_matches_jax(name):
    ref, port = _pair(name)
    x, _ = _data(name, 6)
    with torch.inference_mode():
        got = port(_torch_in(x))
    assert got.dtype == torch.float32  # float32 head / softmax, as the reference's
    want = np.asarray(ref(x, training=False))
    assert want.dtype == np.float32
    _close(got.numpy(), want, TOL_LOGITS if name.startswith("lm") else TOL, name)


def _jax_loss(model):
    """The reference's training loss of ``model`` as a function of its
    trainable and non-trainable variables, with the updated non-trainable
    ones (BatchNorm's moving statistics) as its aux."""
    def loss_fn(tv, ntv, x, y):
        y_pred, ntv = model.stateless_call(tv, ntv, x, training=True)
        return model.compute_loss(x=x, y=y, y_pred=y_pred), ntv
    return loss_fn


def _reference_fit(model, x, y, epochs, batch):
    """The reference's training step taken op by op (``jax.grad`` of the
    Keras model's loss, its own optimizer's ``stateless_apply``), over the
    batches in order as ``fit`` takes them: the final variables by path
    and each epoch's mean loss. Jitted on the CPU, XLA keeps some bf16
    intermediates in float32, so the reference's own ``SparkModel.fit``
    parts from this by far more than the port does."""
    opt = model.optimizer
    opt.build(model.trainable_variables)
    tv = [v.value for v in model.trainable_variables]
    ntv = [v.value for v in model.non_trainable_variables]
    ov = [v.value for v in opt.variables]
    step = jax.value_and_grad(_jax_loss(model), has_aux=True)
    losses = []
    for _ in range(epochs):
        batch_losses = []
        for i in range(0, len(x), batch):
            (loss, ntv), grads = step(tv, ntv, x[i:i + batch], y[i:i + batch])
            tv, ov = opt.stateless_apply(ov, grads, tv)
            batch_losses.append(float(loss))
        losses.append(float(np.mean(batch_losses)))
    variables = list(model.trainable_variables) + list(model.non_trainable_variables)
    return {v.path: np.asarray(a) for v, a in zip(variables, list(tv) + list(ntv))}, losses


def _update_err(got, want, start, adam):
    """The error of the update ``got − start`` against ``want − start``:
    relative to the reference update's norm for Adam, to its largest
    element otherwise (``nan`` where the reference did not move)."""
    d_got, d_want = got - start, want - start
    if adam:
        return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))
    return float(np.abs(d_got - d_want).max() / np.abs(d_want).max())


@pytest.mark.parametrize("name", ["classifier", "lm", "resnet"])
def test_mixed_fit_matches_jax(name):
    """Two epochs of three batches from the same weights. The history
    against the reference's ``SparkModel.fit`` and against its step taken
    op by op (:func:`_reference_fit`, seen: 8e-4 at most); each
    variable's update (BatchNorm's moving statistics included) against
    the op-by-op reference's within ``TOL_UPDATE``; ``predict``; the
    variables stay float32.

    Seen: Adam's updates 0.18 (classifier) and 0.065 (LM) of the
    reference update's norm; ResNet's (SGD) 1.3e-2 of its largest
    element. Adam's largest elements part by up to 0.64 of the largest
    update: a weight whose gradient is near zero moves by about ±lr
    whichever side its noise falls, so the norm is held. Planted faults
    fail: a LayerNorm backward with dγ zeroed reads 1.0 at
    ``blk0_ln1/gamma``'s update (and its gradient 1.0 in
    :func:`test_mixed_transformer_gradients_match_jax`); an Adam that
    never steps fails the history first (loss 0.107 and 0.071 away, over
    1e-2), and its updates read 1.0.

    ResNet trains at lr 0.01: at its default 0.1 with momentum 0.9 a
    bf16 unit's difference grows over six steps (0.38 of the largest
    update against the op-by-op reference; its own ``SparkModel.fit``
    parts from that by more still). The first step's gradients at the
    defaults are held to JAX in :func:`test_mixed_resnet_gradients_match_jax`."""
    ref, port = _pair(name, **(dict(lr=0.01) if name == "resnet" else {}))
    start = _keras_weights(ref)
    x, y = _data(name, 24, seed=1)
    want, ref_losses = _reference_fit(ref, x, y, epochs=2, batch=8)
    for v in ref.weights:  # back to the start for the reference's own fit
        v.assign(start[v.path])
    j_sm, t_sm = JaxSparkModel(ref, num_workers=1), et.SparkModel(port, device="cpu")
    j_hist = j_sm.fit((x, y), epochs=2, batch_size=8)
    t_hist = t_sm.fit((x, y), epochs=2, batch_size=8)
    assert list(t_hist) == list(j_hist) == ["loss", "accuracy"]
    for key in j_hist:
        _close(t_hist[key], j_hist[key], TOL_FIT[name], key)
    _close(t_hist["loss"], ref_losses, TOL_FIT[name], "loss, op by op")
    got = et.keras_weights(port)
    assert set(got) == set(want) == set(start)
    adam = name != "resnet"
    moved = 0
    for path, value in want.items():
        if np.array_equal(value, start[path]):
            continue
        moved += 1
        err = _update_err(got[path], value, start[path], adam)
        assert err <= TOL_UPDATE[name], f"update of {path}: {err} > {TOL_UPDATE[name]}"
    assert moved >= len(list(port.parameters()))
    assert all(t.dtype == torch.float32 for t in port.state_dict().values())
    opt = port.training_spec.optimizer
    assert all(v.dtype == torch.float32 for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v))
    _close(t_sm.predict(x[:5], batch_size=8), j_sm.predict(x[:5], batch_size=8),
           TOL_LOGITS if name == "lm" else max(TOL, TOL_FIT[name]), "predict")


def _jax_grads(model, x, y):
    tv = [v.value for v in model.trainable_variables]
    ntv = [v.value for v in model.non_trainable_variables]
    grads, _ = jax.grad(_jax_loss(model), has_aux=True)(tv, ntv, x, y)
    return {v.path: np.asarray(g) for v, g in zip(model.trainable_variables, grads)}


def _check_gradients(name, **overrides):
    """One batch's gradients of the mixed ``name`` through the port
    against JAX's taken op by op, from the same weights: each within
    ``TOL_GRAD`` of its tensor's largest JAX gradient, float32."""
    ref, port = _pair(name, **overrides)
    x, y = _data(name, 8, seed=1)
    want = _jax_grads(ref, x, y)
    port.train()
    port.training_spec.loss(torch.from_numpy(y).long(), port(_torch_in(x))).mean().backward()
    checked = 0
    for path, (tensor, perm) in _keras_paths(port).items():
        if path in want:
            got = tensor.grad.numpy().transpose(np.argsort(perm)) if perm else tensor.grad.numpy()
            assert tensor.grad.dtype == torch.float32
            scale = np.abs(want[path]).max()
            assert scale > 0, path
            err = float(np.abs(got - want[path]).max() / scale)
            assert err <= TOL_GRAD[name], f"gradient of {path}: {err} > {TOL_GRAD[name]}"
            checked += 1
    assert checked == len(want)


@pytest.mark.parametrize("name", ["classifier", "lm"])
def test_mixed_transformer_gradients_match_jax(name):
    """The bf16 training path of the transformers (Dense casts, the flash
    attention and LayerNorm backwards): one batch's gradients within 5e-2
    of each tensor's largest (seen: 3.0e-2 classifier, 3.2e-2 LM, at the
    MLP's biases; a LayerNorm backward with dγ zeroed reads 1.0)."""
    _check_gradients(name)


def test_mixed_resnet_gradients_match_jax():
    """One batch's gradients of the mixed ResNet at the builder's
    defaults, against JAX's taken op by op: within 1e-2 of each tensor's
    largest (seen: 4.4e-3; bf16 against float32 gradients differ by up
    to 45 % here)."""
    _check_gradients("resnet")


@pytest.mark.parametrize("name", ["classifier", "lm", "resnet"])
def test_mixed_policy_keeps_variables_and_heads_float32(name):
    ref, port = _pair(name)
    assert port.dtype_policy == ref.dtype_policy.name == MIXED
    assert port.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype == torch.float32 for b in port.buffers())
    dense = {n: m for n, m in port.named_modules() if isinstance(m, Dense)}
    heads = {"head", "lm_head"} & set(dense)
    assert len(heads) == 1
    head = heads.pop()
    # the transformers' heads are float32 (Dense(dtype="float32")); ResNet's
    # head is bf16 and its softmax float32, as in the reference
    want_head = "float32" if name != "resnet" else "bfloat16"
    assert ref.get_layer(head).dtype_policy.compute_dtype == want_head
    assert dense[head].compute_dtype == getattr(torch, want_head)
    assert all(m.compute_dtype == torch.bfloat16 for n, m in dense.items() if n != head)
    assert et.transformer_lm(**CASES["lm"][2], device="cpu").compute_dtype == torch.float32


def test_policies_the_port_does_not_take_raise():
    for build, cfg in ((et.transformer_lm, CASES["lm"][2]),
                       (et.transformer_classifier, CASES["classifier"][2]),
                       (et.resnet, CASES["resnet"][2])):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build(**cfg, dtype_policy="mixed_float16", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        apply_policy(torch.nn.Linear(2, 2), "float16")


def _mixed_serving_pair(serving_lm):
    """The trained float32 LM of the ``serving_lm`` fixture rebuilt in
    mixed_bfloat16 on both sides with its weights: trained logits have
    margins well above bf16's rounding."""
    cfg = dict(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2, dropout=0.0)
    ref = jax_lm(**cfg, dtype_policy=MIXED)
    ref.set_weights(serving_lm.get_weights())
    port = et.transformer_lm(**cfg, dtype_policy=MIXED, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    return ref, port


def test_mixed_generate_matches_jax(serving_lm):
    """Greedy ``generate(kv_cache=False)`` on a mixed LM: the port's tokens
    equal the JAX ones wherever the reference's top-2 margin clears
    MARGIN (after a token where it does not, the two may part)."""
    ref, port = _mixed_serving_pair(serving_lm)
    prompts = np.array([[2, 3, 4, 5], [3, 4, 5, 2], [5, 2, 3, 4]], np.int32)
    steps = 12
    want = np.asarray(jax_generate(ref, prompts, steps))
    got = et.generate(port, prompts, steps)
    assert got.shape == want.shape and got.dtype == np.int32
    for row in range(len(prompts)):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size:
            t = diff[0]
            padded = np.zeros((1, 32), np.int32)
            padded[0, :want.shape[1]] = want[row]
            top2 = np.sort(np.asarray(ref(padded, training=False))[0, t - 1])[-2:]
            assert top2[1] - top2[0] < MARGIN, (row, t)


def test_mixed_model_refused_by_cached_decode_and_engine(serving_lm):
    """The reference refuses a model whose policy computes below float32
    for the cached decode and the engine; the port reads the compute
    dtype (its variables are float32) and refuses it with the same
    message. One-shot generate runs (test above)."""
    ref, port = _mixed_serving_pair(serving_lm)
    prompt = np.array([[2, 3, 4]], np.int32)
    with pytest.raises(ValueError) as j_err:
        jax_generate(ref, prompt, 2, kv_cache=True)
    with pytest.raises(ValueError) as t_err:
        et.generate(port, prompt, 2, kv_cache=True)
    assert str(t_err.value) == str(j_err.value)
    assert "bfloat16 forward" in str(t_err.value)
    with pytest.raises(ValueError) as j_err:
        JaxInferenceEngine(ref, num_slots=2)
    with pytest.raises(ValueError) as t_err:
        et.InferenceEngine(port, num_slots=2)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="bfloat16 forward"):
        et.SparkModel(port, device="cpu").serve(num_slots=2)
    assert keras.config.dtype_policy().name == "float32"  # the scope did not leak
