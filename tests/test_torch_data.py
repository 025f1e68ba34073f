"""The port's package surface against the JAX package's, on the CPU.

- ``SparkContext.broadcast`` / ``stop`` and ``Broadcast`` as
  ``tests/test_data_layer.py::test_broadcast`` holds the reference to them;
- every name that the reference's ``serving``, ``utils`` and ``data``
  packages export for a module the port has resolves in the port's
  package of the same name (the names of modules still to port are listed
  with their ROADMAP.md item);
- ``ShardedStream.nbytes_per_block`` equal to the reference's.
"""

import importlib

import numpy as np
import pytest

import elephas_tpu_torch as et
from elephas_tpu.data import streaming as jax_streaming
from elephas_tpu_torch.data import Broadcast, SparkContext
from elephas_tpu_torch.data import streaming


def test_broadcast_and_stop():
    sc = SparkContext("local[2]")
    b = sc.broadcast({"a": 1})
    assert isinstance(b, Broadcast)
    assert b.value == {"a": 1}
    b.unpersist()
    assert b.value == {"a": 1}
    b.destroy()
    assert b.value is None
    assert sc.stop() is None
    # the context stays usable, as the reference's does
    assert sc.parallelize(range(4)).count() == 4


# (package, exported name): the reference's exports for modules still to
# port, with the ROADMAP.md Queue A item that brings them
WAITING = {
    ("serving", "PPEngine"): 5,
    ("utils", "add_params"): 4, ("utils", "subtract_params"): 4,
    ("utils", "divide_by"): 4, ("utils", "scale_params"): 4, ("utils", "get_neutral"): 4,
}


def _public(module):
    return sorted(n for n in vars(module) if not n.startswith("_")
                  and not isinstance(getattr(module, n), type(np))
                  and n not in ("annotations",))


@pytest.mark.parametrize("package", ["serving", "utils", "data"])
def test_every_reference_export_of_a_ported_module_resolves(package):
    ref = importlib.import_module(f"elephas_tpu.{package}")
    port = importlib.import_module(f"elephas_tpu_torch.{package}")
    names = _public(ref)
    assert names
    missing = [n for n in names if (package, n) not in WAITING and not hasattr(port, n)]
    assert not missing, missing
    # a name waits only while the port lacks it
    landed = [n for n in names if (package, n) in WAITING and hasattr(port, n)]
    assert not landed, landed


def test_top_level_exports():
    assert et.__version__
    for name in ("HyperParamModel", "InferenceEngine", "SparkModel"):
        assert name in et.__all__ and hasattr(et, name)


def test_version_matches_the_reference():
    import elephas_tpu

    assert et.__version__ == elephas_tpu.__version__
    assert "__version__" in et.__all__ and "__version__" in elephas_tpu.__all__


@pytest.mark.parametrize("workers,block_steps", [(1, 2), (3, 4), (8, 16)])
def test_nbytes_per_block_matches_the_reference(blobs, workers, block_steps):
    x, y, _, _ = blobs
    want = jax_streaming.ShardedStream(x, y, 32, workers, block_steps=block_steps)
    got = streaming.ShardedStream(x, y, 32, workers, block_steps=block_steps)
    assert got.nbytes_per_block() == want.nbytes_per_block()
