"""The port's parameter-server wire (``elephas_tpu_torch.parameter``, the
socket helpers, the weight algebra and the fault plans) against the JAX
package's, on the CPU.

- The codec's bytes equal the reference's for float32, bfloat16, integer
  and boolean lists, int8 with a three-step error-feedback sequence,
  top-k (float and int8 values) and every chunking, and each package
  decodes the other's stream, also frame by frame through
  ``decode_stream``.
- A journal written by one package is read by the other bit for bit,
  sequence table included, and the files are byte-identical.
- Cross traffic: a client of one package against a server of the other
  over HTTP, the socket protocol and the native store, and a two-shard
  group: pulls are bit-equal and a sequenced push sent twice is applied
  once.
- The reference's own cases of ``test_parameter_server.py``,
  ``test_ps_codec.py``, ``test_ps_overlap.py`` (the window),
  ``test_ps_sharding.py``, ``test_fault_tolerance.py``,
  ``test_native_ps.py`` and ``test_telemetry.py``'s PS metrics, chaos
  trace and worker-retry classes and its component-release case run on
  the port as written
  (``tests/_port_cases.py``); the cases that build a Keras model are
  written out for the port in ``tests/test_torch_ps_fit.py`` and
  ``tests/test_torch_ps_workers.py``.

Every server binds port 0.
"""

import functools
import os
import shutil

import numpy as np
import pytest

import tests.test_fault_tolerance as ref_ft
import tests.test_native_ps as ref_native
import tests.test_parameter_server as ref_ps
import tests.test_ps_codec as ref_codec
import tests.test_ps_overlap as ref_overlap
import tests.test_ps_sharding as ref_sharding
import tests.test_telemetry as ref_telemetry
from elephas_tpu import parameter as jax_parameter
from elephas_tpu.parameter import codec as jax_codec
from elephas_tpu.parameter import journal as jax_journal
from elephas_tpu.parameter import native as jax_native
from elephas_tpu.utils import functional_utils as jax_fu
from elephas_tpu_torch import fault, parameter, telemetry
from elephas_tpu_torch.parameter import codec, journal, native
from elephas_tpu_torch.utils import functional_utils, sockets
from elephas_tpu_torch.worker import OverlappedSync
from tests._port_cases import port_class, port_namespace

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.fixture()
def not_null():
    assert not telemetry.null_mode()


def _port_cases(module, names, only=None, skip=()):
    """The reference module's ``test_*`` functions rebound to the port."""
    g = port_namespace(module, **names)
    return {k: v for k, v in g.items()
            if k.startswith("test_") and callable(v) and k not in skip
            and (only is None or k in only)}


# -- the reference's cases, on the port ----------------------------------

_SERVERS = dict(HttpClient=parameter.HttpClient, HttpServer=parameter.HttpServer,
                SocketClient=parameter.SocketClient, SocketServer=parameter.SocketServer)
globals().update(_port_cases(ref_ps, dict(_SERVERS, sockets=sockets,
                                          add_params=functional_utils.add_params)))
globals().update(_port_cases(ref_codec, dict(wire=codec, _HOT_PATH_FILES=[
    f"elephas_tpu_torch/{rel}" for rel in ("parameter/codec.py", "parameter/client.py",
                                          "parameter/server.py", "parameter/native.py",
                                          "utils/sockets.py")])))
globals().update(_port_cases(ref_overlap, dict(OverlappedSync=OverlappedSync,
                                               add_params=functional_utils.add_params),
                             only=("test_staleness_bound_under_slow_server",
                                   "test_submit_does_not_block_on_the_wire",
                                   "test_freshest_skips_stale_pulls",
                                   "test_sync_errors_surface_on_submit_or_drain")))
_SHARDING = dict(_SERVERS, ShardedClient=parameter.ShardedClient,
                 ShardMap=parameter.ShardMap, ShardedServerGroup=parameter.ShardedServerGroup,
                 shard_endpoints=parameter.shard_endpoints,
                 shard_journal_dir=parameter.shard_journal_dir)
for _name in ("FaultBudgetExceeded", "FaultPlan", "ShardedRestartablePS", "ShardKiller",
              "RestartablePS", "PSKiller", "use_plan", "run_sharded_chaos_training",
              "run_elastic_membership", "SocketFaults", "run_chaos_training"):
    _SHARDING[_name] = getattr(fault, _name)
for _name in ("run_chaos_training", "run_sharded_chaos_training", "run_elastic_membership"):
    # the workers train on the CPU here
    _SHARDING[_name] = functools.partial(getattr(fault, _name), device="cpu")
globals().update(_port_cases(
    ref_sharding, {k: v for k, v in _SHARDING.items() if k in vars(ref_sharding)},
    # written out for the port: the two runs that are slow in the reference
    # in test_torch_ps_workers.py, the Keras-model case in test_torch_ps_fit.py
    skip=("test_elastic_workers_join_and_leave_mid_run",
          "test_sharded_chaos_partial_progress_and_recovery",
          "test_orphaned_partitions_reassigned_under_budget")))
globals().update(_port_cases(
    ref_ft, dict({k: v for k, v in _SHARDING.items() if k in vars(ref_ft)}, journal=journal),
    only=("test_journal_roundtrip_bit_exact_with_seq_table",
          "test_journal_missing_returns_none_corrupt_raises",
          "test_crash_mid_snapshot_recovers_and_cleans_tmp",
          "test_duplicate_updates_apply_exactly_once_bit_exact",
          "test_unacked_push_resent_and_lost_counter_drains",
          "test_flush_confirms_final_pushes",
          "test_heartbeat_membership_and_status_counters",
          "test_kill_restart_replays_journal_and_still_dedups",
          "test_worker_survives_injected_socket_drops")))
globals().update(_port_cases(
    ref_native, {},
    only=("test_native_roundtrip_and_update", "test_native_concurrent_updates",
          "test_native_faster_than_pickle_server", "test_native_rejects_lossy_dtypes",
          "test_native_stop_with_open_connections", "test_size_mismatch_raises")))

_TELEMETRY_NS = port_namespace(ref_telemetry, telemetry=telemetry)
TestHttpPsMetricsEndpoint = port_class(ref_telemetry.TestHttpPsMetricsEndpoint, _TELEMETRY_NS)
TestChaosTrace = port_class(ref_telemetry.TestChaosTrace, _TELEMETRY_NS)
TestWorkerRetryTelemetry = port_class(ref_telemetry.TestWorkerRetryTelemetry, _TELEMETRY_NS)
TestPsSeriesLifecycle = port_class(ref_telemetry.TestSeriesLifecycle, _TELEMETRY_NS,
                                   only=("test_component_release_telemetry_bounds_scrape",))


# -- codec bytes ---------------------------------------------------------


def _lists(seed=0):
    """Seeded weight lists by kind."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    return {
        "fp32": [rng.normal(size=(37, 19)).astype(np.float32),
                 rng.normal(size=(19,)).astype(np.float32),
                 np.float32(rng.normal())],
        "bf16": [rng.normal(size=(64, 8)).astype(ml_dtypes.bfloat16),
                 rng.normal(size=(8,)).astype(np.float32)],
        "int_bool": [rng.integers(-5, 5, size=(6, 7)).astype(np.int32),
                     rng.integers(0, 1 << 40, size=(5,)).astype(np.int64),
                     rng.random((4, 3)) > 0.5,
                     np.zeros((0, 3), np.float32)],
        "mixed": [rng.normal(size=(300, 40)).astype(np.float32),
                  rng.integers(0, 9, size=(3,)).astype(np.int32),
                  rng.normal(size=(5000,)).astype(np.float16)],
    }


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int_bool", "mixed"])
@pytest.mark.parametrize("comp,topk,chunk", [
    ("none", None, 1 << 20), ("none", None, 4096), ("int8", None, 1 << 20),
    ("int8", None, 4096), ("none", 0.1, 1 << 20), ("int8", 0.25, 4096),
])
def test_codec_bytes_equal_the_reference(kind, comp, topk, chunk):
    tensors = _lists()[kind]
    ours = codec.WireCodec(comp, topk, chunk).encode(tensors)
    theirs = jax_codec.WireCodec(comp, topk, chunk).encode(tensors)
    assert ours == theirs
    for got, want in zip(codec.decode(theirs), jax_codec.decode(ours)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("comp,topk", [("int8", None), ("none", 0.2), ("int8", 0.3)])
def test_error_feedback_sequence_bit_equal(comp, topk):
    """Three pushes of seeded deltas through each package's codec and its
    own ErrorFeedback: every push's bytes and every residual equal."""
    rng = np.random.default_rng(3)
    ours_fb, theirs_fb = codec.ErrorFeedback(), jax_codec.ErrorFeedback()
    enc, jenc = codec.WireCodec(comp, topk, 4096), jax_codec.WireCodec(comp, topk, 4096)
    for _ in range(3):
        delta = [rng.normal(size=(40, 30)).astype(np.float32) * 1e-2,
                 rng.integers(0, 3, size=(4,)).astype(np.int32),
                 rng.normal(size=(7,)).astype(np.float32)]
        assert enc.encode(delta, ours_fb) == jenc.encode(delta, theirs_fb)
        for a, b in zip(ours_fb._residuals, theirs_fb._residuals):
            np.testing.assert_array_equal(a, b)


def test_decode_stream_framing_both_ways():
    """The frame stream read piecewise (``read_exact`` and ``readinto`` as
    a socket gives them) decodes to the other package's tensors."""
    tensors = _lists(1)["mixed"]
    for enc_mod, dec_mod in ((codec, jax_codec), (jax_codec, codec)):
        data = enc_mod.WireCodec(chunk_bytes=4096).encode(tensors)
        view, pos = memoryview(data), [0]

        def read_exact(n):
            out = bytes(view[pos[0]:pos[0] + n])
            pos[0] += n
            return out

        def readinto(dest):
            n = min(len(dest), 1000, len(data) - pos[0])
            dest[:n] = view[pos[0]:pos[0] + n]
            pos[0] += n
            return n

        out = dec_mod.decode_stream(read_exact, readinto)
        assert pos[0] == len(data)
        for got, want in zip(out, tensors):
            np.testing.assert_array_equal(got, want)


def test_weight_algebra_bit_equal():
    rng = np.random.default_rng(5)
    a = [rng.normal(size=(4, 3)).astype(np.float32), (rng.normal(size=2),)]
    b = [rng.normal(size=(4, 3)).astype(np.float32), (rng.normal(size=2),)]
    for name in ("add_params", "subtract_params"):
        ours, theirs = getattr(functional_utils, name)(a, b), getattr(jax_fu, name)(a, b)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1][0], theirs[1][0])
    for ours, theirs in ((functional_utils.divide_by(a, 3), jax_fu.divide_by(a, 3)),
                         (functional_utils.scale_params(a, 0.5), jax_fu.scale_params(a, 0.5)),
                         (functional_utils.get_neutral(a), jax_fu.get_neutral(a)),
                         (functional_utils.average_params([a, b, a]),
                          jax_fu.average_params([a, b, a]))):
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1][0], theirs[1][0])
    with pytest.raises(ValueError, match="empty"):
        functional_utils.average_params([])


# -- journal -------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(jax_journal, journal), (journal, jax_journal)])
def test_journal_crosses_bit_exact(tmp_path, writer, reader):
    weights = _lists(2)["fp32"] + _lists(2)["int_bool"]
    table = {"w0": 7, "worker-b": 12}
    path = writer.save_journal(str(tmp_path / "a"), weights, table,
                               meta={"mode": "hogwild", "updates_applied": 19})
    got, seq, meta = reader.load_journal(str(tmp_path / "a"))
    assert seq == table and meta == {"mode": "hogwild", "updates_applied": 19}
    for g, w in zip(got, weights):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    other = reader.save_journal(str(tmp_path / "b"), weights, table,
                                meta={"mode": "hogwild", "updates_applied": 19})
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


# -- cross traffic -------------------------------------------------------

_PACKAGES = {"jax": jax_parameter, "torch": parameter}


def _wire_weights():
    rng = np.random.default_rng(11)
    return [rng.normal(size=(48, 16)).astype(np.float32),
            rng.normal(size=(16,)).astype(np.float32),
            rng.normal(size=(16, 5)).astype(np.float32)]


@pytest.mark.parametrize("transport", ["http", "socket"])
@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "jax"), ("jax", "torch")])
def test_cross_traffic_python_servers(transport, server_pkg, client_pkg):
    srv_mod, cli_mod = _PACKAGES[server_pkg], _PACKAGES[client_pkg]
    server_cls = {"http": srv_mod.HttpServer, "socket": srv_mod.SocketServer}[transport]
    client_cls = {"http": cli_mod.HttpClient, "socket": cli_mod.SocketClient}[transport]
    weights = _wire_weights()
    server = server_cls(weights, mode="asynchronous", port=0)
    server.start()
    client = client_cls(master=f"127.0.0.1:{server.port}", client_id="cross")
    try:
        for got, want in zip(client.get_parameters(), weights):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        delta = [np.full_like(w, 0.25) for w in weights]
        client.chaos_duplicate = lambda seq: True  # every push sent twice
        client.update_parameters(delta)
        client.update_parameters(delta)
        client.flush()
        expected = [(w + d) + d for w, d in zip(weights, delta)]
        for got, want in zip(client.get_parameters(), expected):
            np.testing.assert_array_equal(got, want)
        assert server.updates_applied == 2
        assert server.updates_duplicate == 2
        assert server.seq_table["cross"] == 1
    finally:
        client.close()
        server.stop()


@needs_gxx
@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "jax"), ("jax", "torch")])
def test_cross_traffic_native(server_pkg, client_pkg):
    srv = {"jax": jax_native, "torch": native}[server_pkg]
    cli = {"jax": jax_native, "torch": native}[client_pkg]
    weights = _wire_weights()
    server = srv.NativeParameterServer(weights, mode="asynchronous", port=0)
    try:
        client = cli.NativeClient("127.0.0.1", server.port, cli._Flattener(weights))
        for got, want in zip(client.get_parameters(), weights):
            np.testing.assert_array_equal(got, want)
        delta = [np.full_like(w, -0.5) for w in weights]
        client.update_parameters(delta)
        for got, want in zip(client.get_parameters(), [w + d for w, d in zip(weights, delta)]):
            np.testing.assert_array_equal(got, want)
        client.close()
    finally:
        server.stop()


@needs_gxx
def test_native_library_builds_from_the_package_copy():
    """The port builds its own copy of the C++ store, byte-identical to
    the reference's, into ``build/native`` beside the package."""
    ref_src = os.path.join(os.path.dirname(jax_native.__file__), "..", "..", "native",
                           "ps_server.cpp")
    with open(ref_src, "rb") as f, open(native._SRC, "rb") as g:
        assert f.read() == g.read()
    native._load_library()
    assert native._lib_path().parent == native.BUILD_DIR
    assert native._lib_path().exists()


@pytest.mark.parametrize("transport", ["http", "socket"])
@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "jax"), ("jax", "torch")])
def test_cross_traffic_sharded_group(transport, server_pkg, client_pkg):
    srv_mod, cli_mod = _PACKAGES[server_pkg], _PACKAGES[client_pkg]
    server_cls = {"http": srv_mod.HttpServer, "socket": srv_mod.SocketServer}[transport]
    weights = _wire_weights()
    group = srv_mod.ShardedServerGroup(server_cls, weights, 2)
    group.start()
    client = cli_mod.ShardedClient(group.endpoints,
                                   cli_mod.ShardMap.from_weights(weights, 2),
                                   transport=transport, client_id="sharded")
    try:
        assert (cli_mod.ShardMap.from_weights(weights, 2).signature()
                == group.shard_map.signature())
        for got, want in zip(client.get_parameters(), weights):
            np.testing.assert_array_equal(got, want)
        delta = [np.full_like(w, 0.125) for w in weights]
        client.chaos_duplicate = lambda seq: True
        client.update_parameters(delta)
        client.flush()
        for got, want in zip(client.get_parameters(), [w + d for w, d in zip(weights, delta)]):
            np.testing.assert_array_equal(got, want)
        assert [s.updates_applied for s in group.servers] == [1, 1]
        assert [s.updates_duplicate for s in group.servers] == [1, 1]
    finally:
        client.close()
        group.stop()


def test_journal_lag_rule_reads_the_port_store(not_null, tmp_path):
    """The port's watchdog PS rules find the port's series: a store whose
    applied updates outrun its journal fires ``journal_lag`` for it."""
    from elephas_tpu_torch.telemetry.watch import JournalLagRule, Watchdog

    server = parameter.SocketServer([np.zeros((4,), np.float32)], port=0,
                                    journal_dir=str(tmp_path), journal_every=100)
    try:
        for seq in range(3):
            server.apply_update([np.ones((4,), np.float32)], "w0", seq)
        def fired():
            # other stores of this process may fire too: keep this one's
            return [a.rule for a in Watchdog(rules=[JournalLagRule(max_lag=3)]).evaluate()
                    if a.labels["server"] == server.telemetry_label]

        assert fired() == ["journal_lag"]
        server.write_journal()
        assert fired() == []
    finally:
        server.release_telemetry()
