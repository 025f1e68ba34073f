"""The port's checkpoints, ``resume``, ``save`` / ``load_spark_model`` and
the reference's keywords, on the CPU under ``force_devices(8)``.

A resumed fit is held to an uninterrupted one bit for bit, and a loaded
wrapper's predictions to the saved one's bit for bit (the same float32
operations in the same order on the same device). The checkpoint cadence,
the sidecar config and the keyword surface are held to the JAX
package's.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import elephas_tpu
import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.utils.checkpoint import latest_checkpoint as jax_latest_checkpoint
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import compile_config, compile_model
from elephas_tpu_torch.utils.checkpoint import latest_checkpoint
from tests.conftest import make_mlp

W = 4


@pytest.fixture(autouse=True)
def eight_workers():
    previous = force_devices(8)
    yield
    force_devices(previous)


def _mlp(d, k):
    return et.mnist_mlp(input_dim=d, num_classes=k, hidden=16, dropout=0.0, seed=1,
                        device="cpu")


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    oa = a.training_spec.optimizer.state_dict()["state"]
    ob = b.training_spec.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        for key, value in oa[i].items():
            same = torch.equal(value, ob[i][key]) if torch.is_tensor(value) \
                else value == ob[i][key]
            assert same, (i, key)


def test_resume_equals_an_uninterrupted_fit(tmp_path, blobs):
    x, y, d, k = blobs
    rdd = et.to_simple_rdd(SparkContext("local[4]"), x, y)
    ckpt_dir = str(tmp_path / "ckpts")
    full = _mlp(d, k)
    full_hist = et.SparkModel(full, num_workers=W, device="cpu").fit(
        rdd, epochs=4, batch_size=64)

    et.SparkModel(_mlp(d, k), num_workers=W, device="cpu").fit(
        rdd, epochs=2, batch_size=64, checkpoint_dir=ckpt_dir)
    assert latest_checkpoint(ckpt_dir)[1]["epoch"] == 2
    # "restart": a fresh module and wrapper, resumed to epoch 4
    resumed = _mlp(d, k)
    sm = et.SparkModel(resumed, num_workers=W, device="cpu")
    history = sm.fit(rdd, epochs=4, batch_size=64, checkpoint_dir=ckpt_dir, resume=True)
    assert len(history["loss"]) == 2  # only the remaining epochs ran
    assert history["loss"] == full_hist["loss"][2:]
    _, meta = latest_checkpoint(ckpt_dir)
    assert meta["epoch"] == 4 and meta["history"]["loss"] == history["loss"]
    _assert_same_state(resumed, full)
    # resuming a finished run trains nothing
    assert sm.fit(rdd, epochs=4, batch_size=64, checkpoint_dir=ckpt_dir,
                  resume=True) == {"loss": []}
    assert sm.training_histories[-1] == {"loss": []}


def test_checkpoint_every_matches_the_reference(tmp_path, blobs):
    """Which snapshots exist (every ``checkpoint_every`` epochs and a
    terminal one), and what their sidecars hold."""
    x, y, d, k = blobs
    x, y = x[:256], y[:256]
    epochs = {}
    for name, sm in (("jax", JaxSparkModel(make_mlp(d, k), num_workers=W)),
                     ("port", et.SparkModel(_mlp(d, k), num_workers=W, device="cpu"))):
        directory = tmp_path / name
        sm.fit((x, y), epochs=5, batch_size=64, checkpoint_dir=str(directory),
               checkpoint_every=2)
        files = sorted(os.listdir(directory))
        epochs[name] = sorted(int(f[5:10]) for f in files if f.endswith(".json"))
        assert len(files) == 2 * len(epochs[name])
        metas = [json.load(open(directory / f)) for f in files if f.endswith(".json")]
        epochs[name + "_meta"] = [(sorted(m), m["epoch"], sorted(m["history"])) for m in metas]
    assert epochs["port"] == epochs["jax"] == [2, 4, 5]
    assert epochs["port_meta"] == epochs["jax_meta"]
    assert jax_latest_checkpoint(str(tmp_path / "jax"))[1]["epoch"] == \
        latest_checkpoint(str(tmp_path / "port"))[1]["epoch"] == 5


def test_save_and_load_spark_model(tmp_path, blobs):
    x, y, d, k = blobs
    rdd = et.to_simple_rdd(SparkContext("local[4]"), x, y)
    sm = et.SparkModel(_mlp(d, k), mode="asynchronous", num_workers=W, device="cpu")
    sm.fit(rdd, epochs=1, batch_size=32)
    path = str(tmp_path / "model.pt")
    sm.save(path)
    restored = et.load_spark_model(path, device="cpu")
    assert restored.mode == "asynchronous" and restored.num_workers == W
    np.testing.assert_array_equal(restored.predict(x[:16]), sm.predict(x[:16]))
    _assert_same_state(restored.master_network, sm.master_network)
    # the sidecar holds the reference's config for the same arguments
    with open(path + ".elephas.json") as f:
        sidecar = json.load(f)
    want = JaxSparkModel(make_mlp(d, k), mode="asynchronous", num_workers=W).get_config()
    assert sidecar == want == restored.get_config()
    # the optimizer state came back: one more epoch of each stays equal
    sm.fit(rdd, epochs=1, batch_size=32)
    restored.fit(rdd, epochs=1, batch_size=32)
    _assert_same_state(restored.master_network, sm.master_network)


ZOO = {
    "transformer_lm": dict(vocab_size=17, maxlen=16, d_model=32, num_heads=2, num_layers=1,
                           rope=True, seed=2),
    "resnet": dict(input_shape=(16, 16, 3), num_classes=3, depths=(1,), width=4, lr=0.05),
    "imdb_lstm": dict(vocab_size=30, maxlen=8, embed_dim=8, units=8),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_save_rebuilds_zoo_models(name, tmp_path):
    """Builder, arguments, compile spec (the LM's loss from logits, SGD's
    momentum, the LSTM's trainable subset), buffers and optimizer state
    come back; the file loads with ``weights_only=True``."""
    model = getattr(et, name)(**ZOO[name], device="cpu")
    rng = np.random.default_rng(0)
    if name == "resnet":
        x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 3, 8).astype(np.int32)
    else:
        x = rng.integers(0, ZOO[name]["vocab_size"], (8, ZOO[name]["maxlen"])).astype(np.int32)
        y = np.roll(x, -1, axis=1) if name == "transformer_lm" else \
            rng.integers(0, 2, 8).astype(np.int32)
    sm = et.SparkModel(model, num_workers=2, device="cpu")
    sm.fit((x, y), epochs=1, batch_size=4)
    path = str(tmp_path / "m.pt")
    sm.save(path)
    assert torch.load(path, weights_only=True)["builder"] == name
    restored = et.load_spark_model(path, device="cpu").master_network
    assert restored.build_spec == model.build_spec
    assert compile_config(restored) == compile_config(model)
    _assert_same_state(restored, model)
    np.testing.assert_array_equal(et.SparkModel(restored, device="cpu").predict(x), sm.predict(x))


def test_save_refuses_a_module_outside_the_zoo(tmp_path):
    model = torch.nn.Linear(2, 2)
    compile_model(model, Adam(model.parameters()), "sparse_categorical_crossentropy")
    with pytest.raises(ValueError, match="builder of the zoo"):
        et.SparkModel(model, device="cpu").save(str(tmp_path / "m.pt"))


# -- the reference's keywords ----------------------------------------------

# keyword -> (a value that changes the behaviour, the ROADMAP item it names;
# None for the parameter-server keywords, which item 4a ported)
UNPORTED_INIT = {
    "parameter_server_mode": ("http", None), "port": (4001, None), "ps_overlap": (True, None),
    "ps_journal_dir": ("journal", None), "ps_shards": (2, None), "failure_budget": (1, None),
    "reassign_orphans": (False, None), "model_parallel": (2, 5), "pipeline_parallel": (2, 5),
    "pipeline_microbatches": (8, 5), "sequence_parallel": (2, 5),
    "sequence_attention": ("ulysses", 5),
}
# fit keywords that make the reference stream its input
STREAMED_FIT = {"steps_per_epoch": 2, "stream_block_steps": 2}


def _keywords(fn, skip=("self", "model", "rdd", "args", "kwargs")):
    return {name: p.default for name, p in inspect.signature(fn).parameters.items()
            if name not in skip}


def test_every_reference_keyword_is_accepted():
    for ours, theirs in ((et.SparkModel.__init__, elephas_tpu.SparkModel.__init__),
                         (et.SparkModel.fit, elephas_tpu.SparkModel.fit),
                         (et.SparkModel.evaluate, elephas_tpu.SparkModel.evaluate),
                         (et.SparkModel.save, elephas_tpu.SparkModel.save),
                         (et.load_spark_model, elephas_tpu.load_spark_model)):
        missing = set(_keywords(theirs)) - set(_keywords(ours))
        assert not missing, (theirs.__qualname__, missing)
    # at the reference's defaults every keyword passes
    model = _mlp(4, 2)
    defaults = _keywords(elephas_tpu.SparkModel.__init__)
    # custom_objects has nothing to resolve in the port: any value passes
    sm = et.SparkModel(model, **dict(defaults, custom_objects={"Any": object}), device="cpu")
    assert sm.num_workers == 8
    assert et.SparkModel(model, mode="hogwild", ps_overlap=True, device="cpu").ps_overlap
    x, y = np.zeros((8, 4), np.float32), np.zeros(8, np.int32)
    fit_defaults = _keywords(elephas_tpu.SparkModel.fit)
    fit_defaults.update(epochs=1, batch_size=4)
    assert len(sm.fit((x, y), **fit_defaults)["loss"]) == 1
    sm.evaluate(x, y, **_keywords(elephas_tpu.SparkModel.evaluate,
                                  skip=("self", "x_test", "y_test", "kwargs")))


@pytest.mark.parametrize("name", list(UNPORTED_INIT))
def test_unported_init_values_name_their_item(name):
    value, item = UNPORTED_INIT[name]
    if item is None:
        # ported: the value is taken and kept in the config
        assert et.SparkModel(_mlp(4, 2), **{name: value}, device="cpu").get_config()[name] == value
        return
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}"):
        et.SparkModel(_mlp(4, 2), **{name: value}, device="cpu")


def test_streamed_inputs_name_item_2(tmp_path, monkeypatch):
    """Inputs the reference streams stream in the port too (ROADMAP item 2
    ported them): the two keywords, a memmap and an array over the
    instance's threshold; ``frequency="fit"`` refuses to stream."""
    streams = []
    real = et.worker.Runner.run_epochs_stream
    monkeypatch.setattr(et.worker.Runner, "run_epochs_stream",
                        lambda self, stream, *a, **kw: streams.append(stream) or real(
                            self, stream, *a, **kw))
    sm = et.SparkModel(_mlp(4, 2), device="cpu")
    x, y = np.zeros((8, 4), np.float32), np.zeros(8, np.int32)
    for name, value in STREAMED_FIT.items():
        assert len(sm.fit((x, y), epochs=1, batch_size=2, **{name: value})["loss"]) == 1
    mm = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+", dtype=np.float32,
                                   shape=(8, 4))
    sm.fit((mm, y), epochs=1)
    sm.STREAM_THRESHOLD_BYTES = 64
    sm.fit((x, y), epochs=1)
    assert len(streams) == 4
    with pytest.raises(ValueError, match="contradicts streaming"):
        et.SparkModel(_mlp(4, 2), frequency="fit", device="cpu").fit((mm, y), epochs=1)


