"""The port's multi-host launch path (`repro_torch.launch.multihost`) on
JAX's data (CPU; the port's shards on `devices=["cpu"] * 8`, JAX's on the 8
emulated host devices of `fed_devices`).

Ported from the reference's multihost-marked suites:
  * tests/test_async_runtime.py `TestMultiHostGather`: the gathered bytes
    of every round equal `expected_gather_bytes` and m x the payload share
    of `measured_bytes_per_round` (and here also JAX's `wire_log`); exact
    GT matches the sync runner within rtol 1e-9 / atol 1e-12; the two
    rejections with JAX's messages; `init_distributed`'s no-op;
  * tests/test_obs.py `TestMultiHostTelemetry`: a sink changes no iterate,
    its counters equal `wire_log`, the round and phase spans.

Added: per round, the port's runner against JAX's `MultiHostRunner` within
rtol 1e-9 / atol 1e-12 for GT, CompressedGT and QuantizedGT over the wire
(the per-shard folded keys are JAX's, so the draws are too); those keys'
words; `payload_structs` and `expected_gather_bytes` against JAX's; the
pod-aligned shard count; the decode pin (a shard's own decode equals the
server's, bitwise); the dense gather of strategies without the wire;
`devices=None` raising without CUDA; and `init_distributed` bringing up a
one-process gloo world on 127.0.0.1.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import sim as jsim
from repro.launch import multihost as jmh
from repro_torch import fed, obs, sim
from repro_torch.fed.transport import dense_payload_bytes, measured_bytes_per_round
from repro_torch.launch import multihost as mh

from test_torch_elastic import _problems
from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

ETA, K, ROUNDS = 1e-3, 4, 6
DIM, M = 16, 8
#: the reference's tolerance (tests/test_async_runtime.py)
RTOL, ATOL = 1e-9, 1e-12
CPU8 = ["cpu"] * M

WIRE = {
    "topk25": lambda F: F.CompressedGT(compression_ratio=0.25, wire_transport=True),
    "q8": lambda F: F.QuantizedGT(bits=8, wire_transport=True),
    "q4_top25": lambda F: F.QuantizedGT(bits=4, ratio=0.25, wire_transport=True),
}
#: against JAX's MultiHostRunner, round by round
AGAINST_JAX = {
    "gradient_tracking": lambda F: F.GradientTracking(),
    "compressed_gt": WIRE["topk25"],
    "quantized_gt": WIRE["q8"],
}
#: every strategy family the gather prices
PRICED = {
    **WIRE,
    "gradient_tracking": lambda F: F.GradientTracking(),
    "compressed_dense": lambda F: F.CompressedGT(compression_ratio=0.25),
    "q8_randk": lambda F: F.QuantizedGT(bits=8, ratio=0.1, mode="randk",
                                        wire_transport=True),
}


@pytest.fixture(scope="module")
def probs():
    return _problems(m=M, dim=DIM, samples=60)


def _x0():
    return torch.ones(DIM, dtype=torch.float64), -torch.ones(DIM, dtype=torch.float64)


def _jx0():
    return jnp.ones(DIM), -jnp.ones(DIM)


def _close(got, want, tag=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=tag)


def _payload_share(strategy, x, y) -> int:
    """One agent's correction payload a round: `measured_bytes_per_round`
    less the dense model up and down, halved (up and down)."""
    meas = measured_bytes_per_round(strategy, x, y, K, include_headers=False)
    return (meas - 2 * dense_payload_bytes((x, y))) // 2


def _per_round(runner, x, y, rounds):
    out = []
    for _ in range(rounds):
        x, y = runner.run(x, y, 1)
        out.append((x, y))
    return out


class TestMultiHostGather:
    @pytest.mark.parametrize("name", sorted(WIRE))
    def test_gathered_bytes_equal_measured_payload(self, probs, name, fed_devices):
        jp, tp = probs
        x0, y0 = _x0()
        strategy = WIRE[name](fed)
        runner = mh.MultiHostRunner(tp.loss, strategy, tp.agent_data, K, ETA,
                                    devices=CPU8)
        x1, y1 = runner.run(x0, y0, 2)
        assert bool(torch.isfinite(x1).all() and torch.isfinite(y1).all())
        assert len(runner.wire_log) == 2
        expected = mh.expected_gather_bytes(strategy, x0, y0, M)
        share = _payload_share(strategy, x0, y0)
        for entry in runner.wire_log:
            # (a) the LeafSpec expectation, (b) the m-agent payload share
            assert entry["gathered_payload_bytes"] == expected == M * share
        jr = jmh.MultiHostRunner(jp.loss, WIRE[name](jfed), jp.agent_data, K, ETA,
                                 devices=fed_devices)
        jr.run(*_jx0(), 2)
        assert runner.wire_log == jr.wire_log

    def test_exact_gt_multihost_matches_sync(self, probs):
        _, tp = probs
        x0, y0 = _x0()
        sync = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                                 tp.agent_data, K, ETA)
        xs, ys = sync.run(x0, y0, ROUNDS)
        runner = mh.MultiHostRunner(tp.loss, fed.GradientTracking(), tp.agent_data,
                                    K, ETA, devices=CPU8)
        xm, ym = runner.run(x0, y0, ROUNDS)
        assert runner._n_shards == M
        _close(xm, xs.numpy(), "x vs sync")
        _close(ym, ys.numpy(), "y vs sync")

    def test_rejects_payload_free_strategies(self, probs):
        _, tp = probs
        with pytest.raises(ValueError, match="gathers correction payloads"):
            mh.MultiHostRunner(tp.loss, fed.LocalOnly(), tp.agent_data, K, ETA,
                               devices=CPU8)
        with pytest.raises(ValueError, match="full-participation"):
            mh.MultiHostRunner(tp.loss, fed.PartialParticipation(participation=0.5),
                               tp.agent_data, K, ETA, devices=CPU8)

    def test_init_distributed_noop_single_process(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        assert mh.init_distributed() is False
        assert not torch.distributed.is_initialized()


class TestMultiHostAgainstJax:
    @pytest.mark.parametrize("name", sorted(AGAINST_JAX))
    def test_iterates_match_jax_multihost_per_round(self, probs, name, fed_devices):
        jp, tp = probs
        runner = mh.MultiHostRunner(tp.loss, AGAINST_JAX[name](fed), tp.agent_data,
                                    K, ETA, devices=CPU8)
        got = _per_round(runner, *_x0(), ROUNDS)
        jr = jmh.MultiHostRunner(jp.loss, AGAINST_JAX[name](jfed), jp.agent_data, K,
                                 ETA, devices=fed_devices)
        want = _per_round(jr, *_jx0(), ROUNDS)
        for t, ((xa, ya), (xj, yj)) in enumerate(zip(got, want)):
            _close(xa, xj, f"{name} x round {t} vs JAX")
            _close(ya, yj, f"{name} y round {t} vs JAX")
        assert runner.wire_log == jr.wire_log

    @pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
    def test_shard_keys_are_jax_fold_in(self, probs, seed, fed_devices):
        """Each shard's selection / rounding key is JAX's fold_in of the
        strategy key by shard index, word for word, before and after a
        round (one split a round on each shard)."""
        jp, tp = probs
        make = lambda F: F.QuantizedGT(bits=8, ratio=0.25, mode="randk", seed=seed,
                                       wire_transport=True)
        runner = mh.MultiHostRunner(tp.loss, make(fed), tp.agent_data, K, ETA,
                                    devices=CPU8)
        jr = jmh.MultiHostRunner(jp.loss, make(jfed), jp.agent_data, K, ETA,
                                 devices=fed_devices)
        for rounds in (0, 1):
            runner.run(*_x0(), rounds)
            jr.run(*_jx0(), rounds)
            assert len(runner._state_s) == len(jr._state_s) == M
            for i, (s, js) in enumerate(zip(runner._state_s, jr._state_s)):
                want = np.asarray(jax.random.key_data(js["key"])
                                  if jnp.issubdtype(js["key"].dtype, jax.dtypes.prng_key)
                                  else js["key"]).astype(np.int64)
                assert s["key"].device.type == "cpu"
                np.testing.assert_array_equal(s["key"].numpy() & 0xFFFFFFFF, want,
                                              err_msg=f"shard {i} after {rounds}")

    @pytest.mark.parametrize("name", sorted(PRICED))
    def test_expected_gather_bytes_equal_jax(self, probs, name):
        x0, y0 = _x0()
        for m in (1, 3, M):
            assert (mh.expected_gather_bytes(PRICED[name](fed), x0, y0, m)
                    == jmh.expected_gather_bytes(PRICED[name](jfed), *_jx0(), m))

    @pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
    @pytest.mark.parametrize("name", sorted(PRICED))
    def test_payload_structs_equal_jax(self, name, dtype):
        tree = {"w": np.zeros((3, 37)), "b": np.zeros((130,))}
        tt = {k: torch.zeros(v.shape, dtype=getattr(torch, dtype)) for k, v in tree.items()}
        jt = {k: jnp.zeros(v.shape, dtype=getattr(jnp, dtype)) for k, v in tree.items()}
        specs = mh.leaf_specs(PRICED[name](fed), tt, 5)
        jspecs = jmh.leaf_specs(PRICED[name](jfed), jt, 5)
        assert [(s.rows, s.cols, s.k, s.encoding) for s in specs] == [
            (s.rows, s.cols, s.k, s.encoding) for s in jspecs]
        got, want = mh.payload_structs(specs), jmh.payload_structs(jspecs)
        assert len(got) == len(want)
        for p, jp in zip(got, want):
            for a, b in zip(p, jp):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.device.type == "meta"
                    assert tuple(a.shape) == tuple(b.shape)
                    assert str(a.dtype).replace("torch.", "") == str(b.dtype)

    @pytest.mark.parametrize("pods", [2, 4, 8])
    def test_pod_aligned_shard_count_equals_jax(self, probs, pods, fed_devices):
        jp, tp = probs
        for n_dev in (3, 4, 8):
            runner = mh.MultiHostRunner(tp.loss, fed.GradientTracking(), tp.agent_data,
                                        K, ETA, devices=["cpu"] * n_dev,
                                        pod_map=sim.PodMap(M, pods))
            jr = jmh.MultiHostRunner(jp.loss, jfed.GradientTracking(), jp.agent_data,
                                     K, ETA, devices=fed_devices[:n_dev],
                                     pod_map=jsim.PodMap(M, pods))
            assert runner._n_shards == jr._n_shards
        with pytest.raises(ValueError, match="does not align"):
            mh.MultiHostRunner(tp.loss, fed.GradientTracking(), tp.agent_data, K, ETA,
                               devices=CPU8, pod_map=sim.PodMap(M, 3))


class TestDecodeAndDevices:
    @pytest.mark.parametrize("name", sorted(WIRE))
    def test_shard_decode_equals_server_decode_bitwise(self, probs, name):
        _, tp = probs
        runner = mh.MultiHostRunner(tp.loss, WIRE[name](fed), tp.agent_data, K, ETA,
                                    devices=["cpu"] * 4)
        for _ in range(2):
            runner.run(*_x0(), 1)
            own_x, own_y = runner.decode_on_shards()
            cx, cy = runner.last_exchange["decoded"]
            assert own_x.shape == cx.shape == (M, DIM)
            assert torch.equal(own_x, cx) and torch.equal(own_y, cy)
            enc = runner.last_exchange["encoded"]
            assert len(enc) == 4 and all(isinstance(e[0], fed.PackedTree) for e in enc)
            # the wire is the payloads alone: their bytes are the log's
            assert sum(e[0].wire_bytes() + e[1].wire_bytes() for e in enc) == \
                runner.wire_log[-1]["gathered_payload_bytes"]

    @pytest.mark.parametrize("name", ["gradient_tracking", "compressed_dense"])
    def test_dense_gather_is_the_correction_stack(self, probs, name, fed_devices):
        jp, tp = probs
        x0, y0 = _x0()
        strategy = PRICED[name](fed)
        runner = mh.MultiHostRunner(tp.loss, strategy, tp.agent_data, K, ETA,
                                    devices=CPU8)
        runner.run(x0, y0, 2)
        dense = 2 * M * DIM * 8
        assert [e["gathered_payload_bytes"] for e in runner.wire_log] == [dense] * 2
        assert dense == M * _payload_share(strategy, x0, y0)
        with pytest.raises(ValueError, match="no packed exchange"):
            runner.decode_on_shards()
        jr = jmh.MultiHostRunner(jp.loss, PRICED[name](jfed), jp.agent_data, K, ETA,
                                 devices=fed_devices)
        jr.run(*_jx0(), 2)
        assert runner.wire_log == jr.wire_log

    def test_devices_none_raises_without_cuda(self, probs, monkeypatch):
        _, tp = probs
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mh.MultiHostRunner(tp.loss, fed.GradientTracking(), tp.agent_data, K, ETA)

    def test_init_distributed_brings_up_a_gloo_world(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist = torch.distributed
        assert mh.init_distributed(f"127.0.0.1:{port}", 1, 0) is True
        try:
            assert dist.is_initialized()
            assert dist.get_backend() == "gloo"
            assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
            t = torch.arange(4.0)
            dist.all_reduce(t)
            assert torch.equal(t, torch.arange(4.0))
        finally:
            dist.destroy_process_group()
        assert not dist.is_initialized()


class TestMultiHostTelemetry:
    def test_wire_log_absorbed_and_bitwise(self, probs):
        _, tp = probs
        make = WIRE["topk25"]
        off = mh.MultiHostRunner(tp.loss, make(fed), tp.agent_data, 4, ETA,
                                 devices=CPU8)
        xa, ya = off.run(*_x0(), 2)
        tm = obs.Telemetry()
        on = mh.MultiHostRunner(tp.loss, make(fed), tp.agent_data, 4, ETA,
                                devices=CPU8, telemetry=tm)
        xb, yb = on.run(*_x0(), 2)
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
        # wire_log stays; the sink absorbs it as counters
        gathered = [e["value"] for e in tm.series("counter", "gathered_payload_bytes")]
        assert gathered == [w["gathered_payload_bytes"] for w in on.wire_log]
        totals = [e["total_bytes"]
                  for e in tm.series("counter", "gathered_payload_bytes")]
        assert totals == [w["gathered_total_bytes"] for w in on.wire_log]
        rounds = tm.series("span", "round")
        assert [e["runtime"] for e in rounds] == ["multihost"] * 2
        assert [e["n_shards"] for e in rounds] == [M] * 2
        for phase in ("broadcast", "exchange_corrections", "local_steps",
                      "aggregate"):
            assert len(tm.series("span", phase)) == 2
