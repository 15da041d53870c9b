"""The port's synchronous runner and checkpoints (`repro_torch.fed.runtime`,
`repro_torch.checkpoint`) against the JAX package's (CPU):

  * `RoundStats`, the history and `metric_series` (ValueError on an
    unknown key, also on an empty history);
  * checkpoints round-trip exactly (f64, int64 key words, bf16 and fp8
    through their bits), `latest_checkpoint`, and CPU leaves stay on the
    CPU;
  * resume from a checkpoint equals the uninterrupted run bit for bit for
    stateful strategies (error-feedback buffers, an RNG key);
  * the runner's final iterates equal `run_rounds'` bit for bit, and
    JAX's runner's to 1e-12;
  * `wire_report` equals JAX's runner's for the same strategies;
  * the `telemetry=` path and the pod / O(active) parts of the elastic
    path raise NotImplementedError naming their ROADMAP Queue 1 items
    (the elastic runs themselves: tests/test_torch_elastic.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fed as jfed
from repro.problems.quadratic import _loss as jax_quadratic_loss
from repro_torch import core
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.convert import problem_from_numpy
from repro_torch.fed import FederatedRunner, RoundStats, resolve_strategy
from repro_torch.fixtures import RUNS, load_compressed_rounds

pytestmark = pytest.mark.torch

K, ETA = 4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quad6():
    """The d=6, m=8 quadratic of the compressed fixture (JAX's data):
    (JAX agent data, the port's problem)."""
    f = load_compressed_rounds()
    data = {"G": f["quad6_G"], "Ab": f["quad6_Ab"]}
    return ({k: jnp.asarray(v) for k, v in data.items()},
            problem_from_numpy("quadratic", data, "cpu"))


def _zeros():
    return torch.zeros(6, dtype=torch.float64)


def _gap(x, y):
    return {"norm": torch.sum(x**2) + torch.sum(y**2), "x0": x[0]}


class TestHistory:
    def test_round_stats_and_metric_series(self, quad6):
        _, prob = quad6
        runner = FederatedRunner(core.make_fedgda_gt_round(prob.loss, K, ETA),
                                 prob.agent_data, metric_fn=_gap)
        with pytest.raises(ValueError, match="unknown metric 'norm'"):
            runner.metric_series("norm")  # empty history
        x, y = runner.run(_zeros(), _zeros(), 5)
        assert [s.round_index for s in runner.history] == list(range(5))
        assert all(isinstance(s, RoundStats) and s.seconds > 0 for s in runner.history)
        assert all(type(v) is float for s in runner.history for v in s.metrics.values())
        series = runner.metric_series("norm")
        assert series.shape == (5,)
        assert series[-1] == float(torch.sum(x**2) + torch.sum(y**2))
        with pytest.raises(ValueError, match=r"available metric keys: \['norm', 'x0'\]"):
            runner.metric_series("gap")

    def test_runner_equals_run_rounds_bitwise_and_jax(self, quad6):
        jdata, prob = quad6
        rnd = core.make_fedgda_gt_round(prob.loss, K, ETA)
        x, y = FederatedRunner(rnd, prob.agent_data).run(_zeros(), _zeros(), 50)
        (xw, yw), _ = core.run_rounds(rnd, _zeros(), _zeros(), prob.agent_data, 50)
        assert torch.equal(x, xw) and torch.equal(y, yw)
        jr = jfed.FederatedRunner(jcore.make_fedgda_gt_round(jax_quadratic_loss, K, ETA),
                                  jdata)
        jx, jy = jr.run(jnp.zeros(6), jnp.zeros(6), 50)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-12)

    def test_log_every_prints_the_rounds(self, quad6, capsys):
        _, prob = quad6
        runner = FederatedRunner(core.make_fedgda_gt_round(prob.loss, K, ETA),
                                 prob.agent_data, metric_fn=_gap)
        runner.run(_zeros(), _zeros(), 3, log_every=2)
        out = capsys.readouterr().out.splitlines()
        assert [ln.split("]")[0] for ln in out] == ["[round     0", "[round     2"]


class TestCheckpoint:
    def test_round_trip_is_exact(self, tmp_path):
        rng = np.random.default_rng(0)
        tree = {
            "x": torch.tensor(rng.standard_normal(7)),
            "state": {
                "key": torch.tensor([3, 2**32 - 1], dtype=torch.int64),
                "ex": [torch.tensor(rng.standard_normal((2, 5))).to(torch.bfloat16),
                       (torch.tensor(rng.standard_normal(9) * 100).to(torch.float8_e4m3fn),
                        None)],
                "e5": torch.tensor(rng.standard_normal(4)).to(torch.float8_e5m2),
            },
            "f32": torch.tensor(rng.standard_normal(3), dtype=torch.float32),
        }
        path = save_checkpoint(str(tmp_path), 7, tree)
        assert path.endswith("ckpt_00000007.npz")
        got = restore_checkpoint(path, "cpu")
        assert set(got) == set(tree) and got["state"]["ex"][1][1] is None
        assert isinstance(got["state"]["ex"], list)
        assert isinstance(got["state"]["ex"][1], tuple)
        pairs = [(got["x"], tree["x"]), (got["f32"], tree["f32"]),
                 (got["state"]["key"], tree["state"]["key"]),
                 (got["state"]["ex"][0], tree["state"]["ex"][0]),
                 (got["state"]["ex"][1][0], tree["state"]["ex"][1][0]),
                 (got["state"]["e5"], tree["state"]["e5"])]
        for g, w in pairs:
            assert g.dtype == w.dtype and g.shape == w.shape
            iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
            assert torch.equal(g.view(iv[g.element_size()]),
                               w.view(iv[w.element_size()]))

    def test_latest_and_atomic_layout(self, tmp_path):
        assert latest_checkpoint(str(tmp_path / "none")) is None
        for step in (10, 2, 30):
            save_checkpoint(str(tmp_path), step, {"x": torch.zeros(1)})
        (tmp_path / "ckpt_00000099.npz.tmp").write_bytes(b"partial")
        step, path = latest_checkpoint(str(tmp_path))
        assert step == 30 and path.endswith("ckpt_00000030.npz")

    def test_leaves_come_back_where_they_lived(self, tmp_path, monkeypatch):
        """CPU leaves (the port's PRNG keys) stay on the CPU; without CUDA
        and without a device the restore raises instead of falling back."""
        path = save_checkpoint(str(tmp_path), 1, {"key": torch.tensor([0, 1])})
        assert restore_checkpoint(path, "cpu")["key"].device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            restore_checkpoint(path)

    def test_unsupported_trees_raise(self, tmp_path):
        with pytest.raises(TypeError, match="str"):
            save_checkpoint(str(tmp_path), 1, {1: torch.zeros(1)})
        with pytest.raises(TypeError, match="leaf of type"):
            save_checkpoint(str(tmp_path), 1, {"a": 1.0})


@pytest.mark.parametrize("run", ["cgt_topk_ef", "cgt_randk", "qgt4_topk_wire"])
def test_resume_equals_uninterrupted_bitwise(quad6, tmp_path, run):
    """20 rounds with a checkpoint every 10, against 10 rounds, restore of
    ckpt_00000010.npz, 10 more: x, y and the whole strategy state (feedback
    buffers, the rand-k / rounding key) bit for bit."""
    _, prob = quad6
    name, kw = RUNS[run]

    def runner(sub=None):
        return FederatedRunner.from_strategy(
            prob.loss, resolve_strategy(name, **kw), prob.agent_data, K, ETA,
            checkpoint_dir=None if sub is None else str(tmp_path / sub),
            checkpoint_every=0 if sub is None else 10)

    full = runner("full")
    xf, yf = full.run(_zeros(), _zeros(), 20)
    runner("part").run(_zeros(), _zeros(), 10)
    step, path = latest_checkpoint(str(tmp_path / "part"))
    assert step == 10
    ck = restore_checkpoint(path, "cpu")
    assert set(ck) == {"x", "y", "strategy_state"}
    resumed = runner()
    xr, yr = resumed.run(ck["x"], ck["y"], 10, state=ck["strategy_state"])
    assert torch.equal(xf, xr) and torch.equal(yf, yr)
    assert set(full._state) == set(resumed._state)
    for k in full._state:
        assert torch.equal(full._state[k], resumed._state[k]), k
    if "randk" in run or "qgt" in run:
        assert "key" in full._state
    # the uninterrupted run's last checkpoint holds its final state
    last = restore_checkpoint(latest_checkpoint(str(tmp_path / "full"))[1], "cpu")
    assert torch.equal(last["x"], xf) and torch.equal(last["y"], yf)


@pytest.mark.parametrize("name,kw,keys", [
    ("sagda", dict(noise_sigma=0.1, noise_seed=3), {"noise_key"}),
    ("partial_gt", dict(participation=0.5, seed=2), {"key"}),
    ("partial_gt", dict(participation=0.5, seed=2, noise_sigma=0.05),
     {"key", "noise_key"}),
], ids=["sagda_noisy", "partial_gt", "partial_gt_noisy"])
def test_stochastic_resume_equals_uninterrupted_bitwise(quad6, tmp_path, name, kw, keys):
    """`from_strategy(loss, name, ..., noise_sigma=...)` builds the noisy
    strategy; 20 rounds against 10, restore, 10: the noise key and the
    sampling key travel in the state, so the resumed run draws what the
    uninterrupted one draws, bit for bit."""
    _, prob = quad6

    def runner(sub=None):
        return FederatedRunner.from_strategy(
            prob.loss, name, prob.agent_data, K, ETA,
            checkpoint_dir=None if sub is None else str(tmp_path / sub),
            checkpoint_every=0 if sub is None else 10, **kw)

    full = runner("full")
    assert full._strategy == resolve_strategy(name, **kw)
    xf, yf = full.run(_zeros(), _zeros(), 20)
    runner("part").run(_zeros(), _zeros(), 10)
    ck = restore_checkpoint(latest_checkpoint(str(tmp_path / "part"))[1], "cpu")
    assert set(ck["strategy_state"]) == keys
    resumed = runner()
    xr, yr = resumed.run(ck["x"], ck["y"], 10, state=ck["strategy_state"])
    assert torch.equal(xf, xr) and torch.equal(yf, yr)
    for k in keys:
        assert torch.equal(full._state[k], resumed._state[k]), k
    # and not by accident: the noise moves the run
    if "noise_sigma" in kw:
        plain = FederatedRunner.from_strategy(
            prob.loss, name, prob.agent_data, K, ETA,
            **{k: v for k, v in kw.items() if not k.startswith("noise")})
        assert not torch.equal(plain.run(_zeros(), _zeros(), 20)[0], xf)


def test_from_strategy_rejects_knobs_with_a_built_strategy(quad6):
    _, prob = quad6
    with pytest.raises(TypeError, match="strategy name"):
        FederatedRunner.from_strategy(prob.loss, resolve_strategy("sagda"),
                                      prob.agent_data, K, ETA, noise_sigma=0.1)


def test_stateless_runner_checkpoints_x_and_y(quad6, tmp_path):
    _, prob = quad6
    runner = FederatedRunner.from_strategy(prob.loss, "fedgda_gt", prob.agent_data,
                                           K, ETA, checkpoint_dir=str(tmp_path),
                                           checkpoint_every=3)
    x, y = runner.run(_zeros(), _zeros(), 7)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000003.npz", "ckpt_00000006.npz"]
    assert set(restore_checkpoint(str(tmp_path / "ckpt_00000006.npz"), "cpu")) == {"x", "y"}


@pytest.mark.parametrize("name,kw", [
    ("fedgda_gt", {}), ("local_sgda", {}), ("gda", {}),
    ("compressed_gt", dict(compression_ratio=0.25)),
    ("quantized_gt", dict(quantization_bits=4, compression_ratio=0.25,
                          wire_transport=True)),
    ("quantized_gt", dict(quantization_bits=8)),
])
def test_wire_report_equals_jax(quad6, name, kw):
    jdata, prob = quad6
    x = {"w": torch.zeros(4, 37, dtype=torch.float64), "b": _zeros()}
    y = torch.zeros(6, dtype=torch.float64)
    jx = {"w": jnp.zeros((4, 37)), "b": jnp.zeros(6)}
    jy = jnp.zeros(6)
    want = jfed.FederatedRunner.from_strategy(
        lambda x, y, d: jnp.sum(x["b"]) + jnp.sum(y), jfed.resolve_strategy(name, **kw),
        jdata, K, ETA).wire_report(jx, jy, K)
    got = FederatedRunner.from_strategy(
        prob.loss, resolve_strategy(name, **kw), prob.agent_data, K,
        ETA).wire_report(x, y, K)
    assert got == want


def test_unported_paths_raise_naming_their_items(quad6):
    _, prob = quad6
    rnd = core.make_fedgda_gt_round(prob.loss, K, ETA)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        FederatedRunner(rnd, prob.agent_data, telemetry=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        FederatedRunner.from_strategy(prob.loss, "fedgda_gt", prob.agent_data, K,
                                      ETA, telemetry=object())
    from repro_torch import sim

    runner = FederatedRunner.from_strategy(prob.loss, "fedgda_gt", prob.agent_data,
                                           K, ETA)
    flaky = sim.make_population("flaky", 8).schedule(0, 2, K, device="cpu")
    with pytest.raises(ValueError, match="from_strategy"):
        FederatedRunner(rnd, prob.agent_data).run(_zeros(), _zeros(), 2,
                                                  schedule=flaky)
    # pods price the pod edge of a schedule's rounds, as JAX's report
    # does; without a schedule there is no pod edge to price
    plain = runner.wire_report(_zeros(), _zeros(), K, pods=object())
    assert "scheduled_total_bytes" not in plain
    rep = runner.wire_report(_zeros(), _zeros(), K, schedule=flaky,
                             pods=sim.PodMap(8, 2))
    jrunner = jfed.FederatedRunner.from_strategy(
        jax_quadratic_loss, "fedgda_gt", {"G": jnp.zeros((8, 6, 6)),
                                          "Ab": jnp.zeros((8, 6))}, K, ETA)
    from repro import sim as jsim

    jrep = jrunner.wire_report(jnp.zeros(6), jnp.zeros(6), K,
                               schedule=jsim.make_population("flaky", 8)
                               .schedule(0, 2, K), pods=jsim.PodMap(8, 2))
    assert rep == jrep
    # the runner densifies small sparse schedules only; the O(active)
    # engine runs the mega preset (and refuses a registry it has no data for)
    mega = sim.make_population("mega", 8).sparse_schedule(0, 1, K, device="cpu")
    with pytest.raises(ValueError, match="sim.SparseElasticEngine"):
        runner.run(_zeros(), _zeros(), 1, schedule=mega)
    eng = sim.SparseElasticEngine(prob.loss, "fedgda_gt",
                                  sim.ArrayDataSource(prob.agent_data), K, ETA)
    with pytest.raises(ValueError, match="m=1000000"):
        eng.run(_zeros(), _zeros(), mega)
    with pytest.raises(ValueError, match="from_strategy"):
        FederatedRunner(rnd, prob.agent_data).wire_report(_zeros(), _zeros(), K)
