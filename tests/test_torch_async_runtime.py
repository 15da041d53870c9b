"""The port's asynchronous runtime (`repro_torch.fed.async_runtime`),
tests/test_async_runtime.py's `TestAsyncRunnerParity` ported (the
multi-host gather is in tests/test_torch_multihost.py, its census in
tests/test_torch_dryrun.py), on JAX's data (CPU; the port's shards on `devices=["cpu"] * 8`,
JAX's on the 8 emulated host devices of `fed_devices`):

  * for the six scenario strategies the async runner's iterates equal the
    port's sync runner's and, round by round, JAX's async runner's within
    rtol 1e-9 / atol 1e-12, with one agent a shard; so do a noisy SAGDA run
    and a pod-aligned run;
  * per-agent error-feedback state lives as per-agent slices on the shards,
    the RNG key stays server-side, and gathered back they equal the sync
    runner's state;
  * history and `metric_series`; the caller's tensors are never written;
  * pod-aligned shard counts equal JAX's;
  * under a flaky schedule absent agents' shards are skipped (the
    `shard_skipped` events equal JAX's) and the elastic iterates match the
    sync elastic runner and JAX's async runner;
  * `devices=None` raises without CUDA (the port never falls back to the
    CPU quietly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import obs as jobs
from repro import sim as jsim
from repro_torch import fed, obs, sim

from test_torch_elastic import _problems
from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

ETA, K, ROUNDS = 1e-3, 4, 6
DIM, M = 16, 8
#: async against sync and against JAX, as tests/test_async_runtime.py
RTOL, ATOL = 1e-9, 1e-12
CPU8 = ["cpu"] * M

SCENARIOS = {
    "full_sync": lambda F: F.FullSync(),
    "local_only": lambda F: F.LocalOnly(),
    "gradient_tracking": lambda F: F.GradientTracking(),
    "partial_gt": lambda F: F.PartialParticipation(participation=0.5, seed=0),
    "compressed_gt": lambda F: F.CompressedGT(compression_ratio=0.25,
                                              wire_transport=True),
    "quantized_gt": lambda F: F.QuantizedGT(bits=8, wire_transport=True),
}


@pytest.fixture(scope="module")
def probs():
    return _problems(m=M, dim=DIM, samples=60)


def _x0():
    return torch.ones(DIM, dtype=torch.float64), -torch.ones(DIM, dtype=torch.float64)


def _close(got, want, tag=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=tag)


def _per_round(runner, x, y, rounds, **kw):
    """Iterates after each of `rounds` one-round runs (the runner's state
    carries across runs, so this is one run observed per round)."""
    out = []
    for _ in range(rounds):
        x, y = runner.run(x, y, 1, **kw)
        out.append((x, y))
    return out


class TestAsyncRunnerParity:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_matches_sync_runner_and_jax(self, probs, name, fed_devices):
        jp, tp = probs
        x0, y0 = _x0()
        sync = fed.FederatedRunner.from_strategy(tp.loss, SCENARIOS[name](fed),
                                                 tp.agent_data, K, ETA)
        xs, ys = sync.run(x0, y0, ROUNDS)
        runner = fed.AsyncFederatedRunner(tp.loss, SCENARIOS[name](fed),
                                          tp.agent_data, K, ETA, devices=CPU8)
        got = _per_round(runner, x0, y0, ROUNDS)
        assert runner._n_shards == M  # one agent a shard
        _close(got[-1][0], xs.numpy(), f"{name} x vs sync")
        _close(got[-1][1], ys.numpy(), f"{name} y vs sync")
        jr = jfed.AsyncFederatedRunner(jp.loss, SCENARIOS[name](jfed), jp.agent_data,
                                       K, ETA, devices=fed_devices)
        want = _per_round(jr, jnp.ones(DIM), -jnp.ones(DIM), ROUNDS)
        for t, ((xa, ya), (xj, yj)) in enumerate(zip(got, want)):
            _close(xa, xj, f"{name} x round {t} vs JAX")
            _close(ya, yj, f"{name} y round {t} vs JAX")

    def test_noisy_and_pod_aligned_match_sync_and_jax(self, probs, fed_devices):
        """A noisy SAGDA run (per-agent keys sliced per shard) and a
        pod-aligned run (4 pods on 8 devices: 4 shards of 2 agents)."""
        jp, tp = probs
        x0, y0 = _x0()
        for tag, make, kw in (
            ("sagda", lambda F: F.resolve_strategy("sagda", noise_sigma=0.1), {}),
            ("gt_pods", lambda F: F.GradientTracking(), {"pods": 4}),
        ):
            tkw = {"pod_map": sim.PodMap(M, kw["pods"])} if kw else {}
            jkw = {"pod_map": jsim.PodMap(M, kw["pods"])} if kw else {}
            sync = fed.FederatedRunner.from_strategy(tp.loss, make(fed), tp.agent_data,
                                                     K, ETA)
            xs, ys = sync.run(x0, y0, ROUNDS)
            runner = fed.AsyncFederatedRunner(tp.loss, make(fed), tp.agent_data, K,
                                              ETA, devices=CPU8, **tkw)
            xa, ya = runner.run(x0, y0, ROUNDS)
            jr = jfed.AsyncFederatedRunner(jp.loss, make(jfed), jp.agent_data, K, ETA,
                                           devices=fed_devices, **jkw)
            xj, yj = jr.run(jnp.ones(DIM), -jnp.ones(DIM), ROUNDS)
            assert runner._n_shards == jr._n_shards
            assert runner.pods_per_shard == jr.pods_per_shard
            _close(xa, xs.numpy(), f"{tag} x vs sync")
            _close(ya, ys.numpy(), f"{tag} y vs sync")
            _close(xa, xj, f"{tag} x vs JAX")
            _close(ya, yj, f"{tag} y vs JAX")

    def test_error_feedback_state_shards_and_matches_sync(self, probs):
        _, tp = probs
        x0, y0 = _x0()
        make = SCENARIOS["quantized_gt"]
        sync = fed.FederatedRunner.from_strategy(tp.loss, make(fed), tp.agent_data,
                                                 K, ETA)
        sync.run(x0, y0, ROUNDS)
        runner = fed.AsyncFederatedRunner(tp.loss, make(fed), tp.agent_data, K, ETA,
                                          devices=CPU8)
        runner.run(x0, y0, ROUNDS)
        # EF buffers live as per-agent slices on the shards' devices...
        assert runner._sharded_keys == ("ex", "ey")
        for i, shard in enumerate(runner._shard_state):
            assert set(shard) == {"ex", "ey"}
            assert shard["ex"].shape[0] == M // runner._n_shards
            assert shard["ex"].device == runner._shard_devices[i]
        # ...the RNG key stays server-side...
        assert set(runner._server_state) == {"key"}
        # ...and gathered back together they equal the sync state
        gathered = runner._gather_state()
        for k in ("ex", "ey"):
            _close(gathered[k], sync._state[k].numpy(), k)
        assert torch.equal(gathered["key"], sync._state["key"])

    def test_history_and_metric_series(self, probs):
        _, tp = probs
        x0, y0 = _x0()
        runner = fed.AsyncFederatedRunner(
            tp.loss, fed.GradientTracking(), tp.agent_data, K, ETA, devices=CPU8,
            metric_fn=lambda x, y: {"gap": torch.sum(x ** 2)})
        runner.run(x0, y0, 3)
        assert runner.metric_series("gap").shape == (3,)
        assert [s.round_index for s in runner.history] == [0, 1, 2]
        with pytest.raises(ValueError, match="available metric keys"):
            runner.metric_series("loss")

    def test_caller_tensors_unchanged(self, probs):
        """The per-shard broadcast buffers are copies: the caller's x0 / y0
        and agent data stay as they were, and a second run from them equals
        the first (a fresh runner's)."""
        _, tp = probs
        x0, y0 = _x0()
        keep = (x0.clone(), y0.clone(), tp.agent_data["G"].clone())
        runner = fed.AsyncFederatedRunner(tp.loss, fed.GradientTracking(),
                                          tp.agent_data, K, ETA, devices=CPU8)
        xa, _ = runner.run(x0, y0, 2)
        xb, _ = runner.run(x0, y0, 2)
        assert torch.equal(x0, keep[0]) and torch.equal(y0, keep[1])
        assert torch.equal(tp.agent_data["G"], keep[2])
        assert torch.equal(xa, xb)

    @pytest.mark.parametrize("m,pods,devices", [(8, 4, 8), (8, 8, 3), (12, 6, 4),
                                                (16, 4, 16), (8, 2, 1)])
    def test_pod_aligned_shard_counts_equal_jax(self, m, pods, devices):
        data = {"G": torch.zeros(m, 2, 2, dtype=torch.float64),
                "Ab": torch.zeros(m, 2, dtype=torch.float64)}
        runner = fed.AsyncFederatedRunner(lambda x, y, d: x @ x, "fedgda_gt", data, K,
                                          ETA, devices=["cpu"] * devices,
                                          pod_map=sim.PodMap(m, pods))
        jdata = {k: jnp.zeros(v.shape) for k, v in data.items()}
        import jax

        jr = jfed.AsyncFederatedRunner(lambda x, y, d: x @ x, "fedgda_gt", jdata, K,
                                       ETA, devices=[jax.devices()[0]] * devices,
                                       pod_map=jsim.PodMap(m, pods))
        assert (runner._n_shards, runner.pods_per_shard) == \
            (jr._n_shards, jr.pods_per_shard)
        with pytest.raises(ValueError, match="pod_map is for"):
            fed.AsyncFederatedRunner(lambda x, y, d: x @ x, "fedgda_gt", data, K, ETA,
                                     devices=["cpu"], pod_map=sim.PodMap(m + 1, 1))

    @pytest.mark.parametrize("name", ["gradient_tracking", "compressed_gt",
                                      "full_sync"])
    def test_elastic_skips_absent_shards(self, probs, name, fed_devices):
        jp, tp = probs
        x0, y0 = _x0()
        sched = sim.make_population("flaky", M).schedule(0, ROUNDS, K, device="cpu")
        jsched = jsim.make_population("flaky", M).schedule(0, ROUNDS, K)
        assert np.array_equal(sched.active, np.asarray(jsched.active))
        sync = fed.FederatedRunner.from_strategy(tp.loss, SCENARIOS[name](fed),
                                                 tp.agent_data, K, ETA)
        xs, ys = sync.run(x0, y0, ROUNDS, schedule=sched)
        tm = obs.Telemetry()
        runner = fed.AsyncFederatedRunner(tp.loss, SCENARIOS[name](fed),
                                          tp.agent_data, K, ETA, devices=CPU8,
                                          telemetry=tm)
        xa, ya = runner.run(x0, y0, ROUNDS, schedule=sched)
        jtm = jobs.Telemetry()
        jr = jfed.AsyncFederatedRunner(jp.loss, SCENARIOS[name](jfed), jp.agent_data,
                                       K, ETA, devices=fed_devices, telemetry=jtm)
        xj, yj = jr.run(jnp.ones(DIM), -jnp.ones(DIM), ROUNDS, schedule=jsched)
        skipped = [(e["round"], e["shard"]) for e in tm.series("event", "shard_skipped")]
        assert skipped, "the flaky schedule should leave some agent out"
        # one agent a shard: a skipped shard is an absent agent
        assert skipped == [(t, i) for t in range(ROUNDS) for i in range(M)
                           if not sched.active[t, i]]
        assert skipped == [(e["round"], e["shard"])
                           for e in jtm.series("event", "shard_skipped")]
        _close(xa, xs.numpy(), f"{name} x vs sync elastic")
        _close(ya, ys.numpy(), f"{name} y vs sync elastic")
        _close(xa, xj, f"{name} x vs JAX")
        _close(ya, yj, f"{name} y vs JAX")
        assert [e["runtime"] for e in tm.series("span", "round")] == \
            ["elastic async round"] * ROUNDS

    def test_default_devices_need_cuda(self, probs, monkeypatch):
        _, tp = probs
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fed.AsyncFederatedRunner(tp.loss, "fedgda_gt", tp.agent_data, K, ETA)
