"""Elastic correctness of the port (`repro_torch.sim.elastic`, the
elastic path of `fed.runtime.FederatedRunner`), tests/test_elastic.py
ported (all but the asynchronous runner's parity, ROADMAP Queue 1 item
10), on JAX's data (CPU):

  * a full-participation population reproduces the plain runner bit for
    bit for all six strategy families (static-full takes the plain loop);
  * under flaky Markov churn FedGDA-GT with tracker rebasing reaches
    eps = 1e-6 while the naive no-rebase server never does, each per round
    within GAP_RTOL of JAX's gaps;
  * the tracker table keeps the GT invariant on a partial round;
  * budgets gate local steps exactly (plain and momentum steps);
  * EF rows of non-continuing agents are zeroed, an elastic resume (in
    memory, from a checkpoint, or from a JAX run's state) equals the
    uninterrupted run, departed agents move no bytes and a partial
    strategy's bytes are not discounted twice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import sim as jsim
from repro.core import tree_sq_dist as jtree_sq_dist
from repro.problems import make_quadratic_problem
from repro.problems import quadratic_minimax_point as jminimax
from repro_torch import core, fed, sim
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.convert import (
    elastic_state_from_numpy,
    problem_from_numpy,
    strategy_state_from_numpy,
)
from repro_torch.core.engine import agent_mean
from repro_torch.problems import quadratic_minimax_point

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

ETA = 1e-4
#: per-round gaps against JAX's, relative, on rounds whose gap is above
#: GAP_FLOOR: the engines sum in other orders, and near the minimax point
#: one ulp of |x*| is a relative gap difference of ~2 ulp / sqrt(gap)
GAP_RTOL, GAP_FLOOR = 1e-5, 1e-14

STRATEGIES = [
    ("full_sync", "gda", {}, 1),
    ("local_only", "local_sgda", {}, 5),
    ("gradient_tracking", "fedgda_gt", {}, 5),
    ("partial_participation", "partial_gt", {"participation": 0.5, "seed": 0}, 5),
    ("compressed_gt", "compressed_gt", {"compression_ratio": 0.25, "seed": 0}, 5),
    ("quantized_gt", "quantized_gt", {"quantization_bits": 8, "seed": 0}, 5),
]


def _problems(m=8, dim=16, samples=40):
    """(JAX problem, the port's problem on JAX's data)."""
    jp = make_quadratic_problem(jax.random.PRNGKey(0), dim=dim,
                                num_samples=samples, num_agents=m)
    tp = problem_from_numpy("quadratic",
                            {k: np.asarray(v) for k, v in jp.agent_data.items()}, "cpu")
    return jp, tp


def _zeros(d=16):
    return torch.zeros(d, dtype=torch.float64)


def _gap_fns(jp, tp):
    jxs, jys = jminimax(jp)
    txs, tys = quadratic_minimax_point(tp)
    return (lambda x, y: {"gap": jtree_sq_dist(x, jxs) + jtree_sq_dist(y, jys)},
            lambda x, y: {"gap": core.tree_sq_dist(x, txs) + core.tree_sq_dist(y, tys)})


def _assert_gaps_track(got, want):
    assert got.shape == want.shape
    sel = want > GAP_FLOOR
    np.testing.assert_allclose(got[sel], want[sel], rtol=GAP_RTOL, atol=0)


# ------------------------------------------- full participation == bitwise
@pytest.mark.parametrize("name,alias,kw,K", STRATEGIES, ids=[s[0] for s in STRATEGIES])
def test_stable_population_bitwise_equals_plain_runner(name, alias, kw, K):
    _, tp = _problems()
    plain = fed.FederatedRunner.from_strategy(tp.loss, alias, tp.agent_data, K, ETA, **kw)
    xa, ya = plain.run(_zeros(), _zeros(), 7)
    sched = sim.make_population("stable", tp.num_agents).schedule(0, 7, K, device="cpu")
    assert sched.is_static_full
    elastic = fed.FederatedRunner.from_strategy(tp.loss, alias, tp.agent_data, K, ETA,
                                                **kw)
    xb, yb = elastic.run(_zeros(), _zeros(), 7, schedule=sched)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert elastic.elastic_state is None  # the plain loop ran


def test_full_round_elastic_math_matches_engine_round():
    """`make_elastic_round` on an all-active round is the engine's GT round
    up to rounding (the table holds this round's fresh gradients)."""
    _, tp = _problems()
    m, K = tp.num_agents, 4
    strat = fed.GradientTracking()
    rnd = core.make_round(tp.loss, strat, K, ETA)
    ernd = sim.make_elastic_round(tp.loss, strat, K, ETA)
    x, y = torch.ones(16, dtype=torch.float64), -torch.ones(16, dtype=torch.float64)
    tracker = sim.init_tracker(tp.loss, strat, x, y, tp.agent_data)
    active = torch.ones(m, dtype=torch.bool)
    x1, y1 = rnd(x, y, tp.agent_data)
    xe, ye, _, _ = ernd(x, y, tp.agent_data, {}, tracker,
                        sim.renormalized_weights(active),
                        torch.full((m,), K, dtype=torch.int32), active, active)
    np.testing.assert_allclose(xe.numpy(), x1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(ye.numpy(), y1.numpy(), rtol=1e-12)


# ------------------------------------------------------ rebase vs naive
def _flaky_runs(rebase, T=500):
    """(port gaps, JAX gaps) of FedGDA-GT under MarkovChurn(0.25, 0.6)."""
    jp, tp = _problems(m=8, dim=16, samples=100)
    jgap, tgap = _gap_fns(jp, tp)
    pop = dict(p_leave=0.25, p_join=0.6)
    jsched = jsim.Population(8, jsim.MarkovChurn(**pop)).schedule(0, T, 10)
    sched = sim.Population(8, sim.MarkovChurn(**pop)).schedule(0, T, 10, device="cpu")
    assert not sched.is_static_full and sched.churn_events() > 0
    jr = jfed.FederatedRunner.from_strategy(jp.loss, jfed.GradientTracking(),
                                            jp.agent_data, 10, ETA, metric_fn=jgap)
    jr.run(jnp.zeros(16), jnp.zeros(16), T, schedule=jsched, rebase=rebase)
    r = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                          tp.agent_data, 10, ETA, metric_fn=tgap)
    r.run(_zeros(), _zeros(), T, schedule=sched, rebase=rebase)
    n_active = r.metric_series("n_active")
    np.testing.assert_array_equal(n_active, sched.active.sum(axis=1))
    return r.metric_series("gap"), np.asarray(jr.metric_series("gap"))


def test_rebase_recovers_exact_convergence_under_churn():
    gaps, jgaps = _flaky_runs(rebase=True)
    _assert_gaps_track(gaps, jgaps)
    assert gaps.min() <= 1e-6 and gaps[-1] <= 1e-6, f"min gap {gaps.min():.3e}"


def test_no_rebase_ablation_stalls():
    gaps, jgaps = _flaky_runs(rebase=False)
    _assert_gaps_track(gaps, jgaps)
    assert gaps.min() > 1e-3, f"min gap {gaps.min():.3e}"


def test_tracker_keeps_gt_invariant_each_round():
    """On a partial round gbar == mean(table) by construction: the uniform
    corrections sum to zero; absent agents keep their old rows."""
    _, tp = _problems(m=6)
    strat = fed.GradientTracking()
    x, y = torch.ones(16, dtype=torch.float64), -torch.ones(16, dtype=torch.float64)
    tracker0 = sim.init_tracker(tp.loss, strat, x, y, tp.agent_data)
    active = torch.tensor([True, False, True, True, False, False])
    ernd = sim.make_elastic_round(tp.loss, strat, 3, ETA)
    x1, y1, _, tracker = ernd(
        x, y, tp.agent_data, {}, tracker0, sim.renormalized_weights(active),
        torch.where(active, 3, 0), active, torch.ones(6, dtype=torch.bool))
    gbar = agent_mean(tracker["gx"], None)
    corr_sum = torch.mean(gbar[None] - tracker["gx"], dim=0)
    np.testing.assert_allclose(corr_sum.numpy(), np.zeros(16), atol=1e-12)
    assert torch.equal(tracker["gx"][~active], tracker0["gx"][~active])
    # the next round re-anchors the active rows at the new iterate
    fresh = sim.init_tracker(tp.loss, strat, x1, y1, tp.agent_data)
    _, _, _, t2 = ernd(x1, y1, tp.agent_data, {}, tracker,
                       sim.renormalized_weights(active), torch.where(active, 3, 0),
                       active, active)
    assert torch.equal(t2["gx"][active], fresh["gx"][active])


# ---------------------------------------------------------- step budgets
def test_budget_gates_local_steps_exactly():
    """LocalOnly with per-agent budgets: agent i's iterate is exactly
    budget_i GDA steps from the broadcast point; absent agents never move."""
    _, tp = _problems(m=4)
    K = 4
    x, y = torch.ones(16, dtype=torch.float64), -torch.ones(16, dtype=torch.float64)
    active = torch.tensor([True, True, True, False])
    budgets = torch.tensor([4, 1, 2, 0], dtype=torch.int32)
    weights = sim.renormalized_weights(active)
    ernd = sim.make_elastic_round(tp.loss, fed.LocalOnly(), K, ETA)
    x1, y1, _, _ = ernd(x, y, tp.agent_data, {}, {}, weights, budgets, active, None)
    g = core.grad_xy(tp.loss)
    xs_exp, ys_exp = [], []
    for i in range(4):
        data_i = {k: v[i] for k, v in tp.agent_data.items()}
        xi, yi = x, y
        for _ in range(int(budgets[i])):
            gi = g(xi, yi, data_i)
            xi, yi = xi - ETA * gi.gx, yi + ETA * gi.gy
        xs_exp.append(xi)
        ys_exp.append(yi)
    x_exp = sum(float(weights[i]) * xs_exp[i] for i in range(4))
    y_exp = sum(float(weights[i]) * ys_exp[i] for i in range(4))
    np.testing.assert_allclose(x1.numpy(), x_exp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(y1.numpy(), y_exp.numpy(), rtol=1e-10)


@pytest.mark.parametrize("alias,kw", [
    ("local_sgda_plus", {"momentum": 0.5}),
    ("local_sgda_plus", {"momentum": 0.5, "noise_sigma": 0.1, "noise_seed": 2}),
    ("sagda", {"noise_sigma": 0.1, "noise_seed": 1}),
], ids=["momentum", "momentum_noisy", "sagda_noisy"])
def test_gated_momentum_and_noisy_rounds_equal_jax(alias, kw):
    """Budget gating of the heavy-ball branch (iterates and velocities)
    and of the noisy steps: 20 straggler-heavy rounds per round against
    JAX's, iterates within 1e-12 relative (normals within a few ulp)."""
    jp, tp = _problems(m=6)
    K, T = 4, 20
    jsched = jsim.make_population("straggler_heavy", 6).schedule(1, T, K)
    sched = sim.make_population("straggler_heavy", 6).schedule(1, T, K, device="cpu")
    assert (sched.budgets[sched.active] < K).any()
    def coords(x, y):  # every coordinate as a metric, in both packages
        return {**{f"x{i}": x[i] for i in range(16)},
                **{f"y{i}": y[i] for i in range(16)}}

    jr = jfed.FederatedRunner.from_strategy(
        jp.loss, jfed.resolve_strategy(alias, **kw), jp.agent_data, K, 1e-3,
        metric_fn=coords)
    jr.run(jnp.zeros(16), jnp.zeros(16), T, schedule=jsched)
    r = fed.FederatedRunner.from_strategy(tp.loss, alias, tp.agent_data, K, 1e-3,
                                          metric_fn=coords, **kw)
    r.run(_zeros(), _zeros(), T, schedule=sched)
    for z in "xy":
        got = np.stack([r.metric_series(f"{z}{i}") for i in range(16)], 1)
        want = np.stack([jr.metric_series(f"{z}{i}") for i in range(16)], 1)
        err = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
        assert err.max() <= 1e-12, (z, int(err.argmax()), err.max())


def test_straggler_run_still_converges_exactly():
    _, tp = _problems(m=8, dim=16, samples=100)
    xs, ys = quadratic_minimax_point(tp)
    sched = sim.Population(
        8, sim.AlwaysOn(), sim.UniformStragglers(p_straggle=0.7, min_frac=0.25)
    ).schedule(0, 600, 10, device="cpu")
    r = fed.FederatedRunner.from_strategy(
        tp.loss, fed.GradientTracking(), tp.agent_data, 10, ETA,
        metric_fn=lambda x, y: {"gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)})
    r.run(_zeros(), _zeros(), 600, schedule=sched)
    assert r.metric_series("gap")[-1] <= 1e-6


# ----------------------------------------------- EF rebasing + wire bytes
def test_rebase_state_zeroes_non_continuing_ef_rows():
    strat = fed.CompressedGT(compression_ratio=0.25)
    m = 6
    state = strat.init_state(_zeros(), _zeros(), m)
    state["ex"] = torch.ones(m, 16, dtype=torch.float64)
    state["ey"] = 2.0 * torch.ones(m, 16, dtype=torch.float64)
    active = torch.tensor([True, True, False, True, False, True])
    prev = torch.tensor([True, False, True, True, False, False])
    out = strat.rebase_state(state, active, prev)
    keep = (active & prev).numpy()
    assert (out["ex"].numpy()[keep] == 1.0).all()
    assert (out["ex"].numpy()[~keep] == 0.0).all()
    assert (out["ey"].numpy()[~keep] == 0.0).all()
    fresh = strat.rebase_state(state, active, None)  # keep = active
    assert (fresh["ex"].numpy()[active.numpy()] == 1.0).all()
    untouched = sim.ElasticAggregator(strat, rebase=False).rebase_state(
        dict(state), active, prev)
    assert torch.equal(untouched["ex"], state["ex"])
    rebased = sim.ElasticAggregator(strat).rebase_state(dict(state), active, prev)
    assert torch.equal(rebased["ex"], out["ex"])


def _compressed_flaky():
    _, tp = _problems(m=6)
    strat = fed.CompressedGT(compression_ratio=0.5, seed=0)
    sched = sim.Population(6, sim.MarkovChurn(p_leave=0.3, p_join=0.5)).schedule(
        1, 12, 4, device="cpu")
    assert not sched.is_static_full
    return tp, strat, sched


def test_elastic_resume_matches_uninterrupted_run(tmp_path):
    """Continuing with the saved tracker and prev_active (and the schedule's
    tail) reproduces the uninterrupted run bit for bit, in memory and from
    a checkpoint; resuming without the elastic state does not."""
    tp, strat, sched = _compressed_flaky()

    def runner(ckpt=None):
        return fed.FederatedRunner.from_strategy(
            tp.loss, strat, tp.agent_data, 4, ETA,
            checkpoint_dir=None if ckpt is None else str(tmp_path / ckpt),
            checkpoint_every=0 if ckpt is None else 6)

    full = runner("full")
    xf, yf = full.run(_zeros(), _zeros(), 12, schedule=sched)
    part = runner()
    xm, ym = part.run(_zeros(), _zeros(), 6, schedule=sched)
    xr, yr = part.run(xm, ym, 6, schedule=sched.tail(6),
                      elastic_state=part.elastic_state)
    assert torch.equal(xf, xr) and torch.equal(yf, yr)
    assert torch.equal(full._state["ex"], part._state["ex"])
    # from the uninterrupted run's checkpoint at round 6
    ck = restore_checkpoint(str(tmp_path / "full" / "ckpt_00000006.npz"), "cpu")
    assert set(ck) == {"x", "y", "elastic_state", "strategy_state"}
    assert set(ck["elastic_state"]) == {"tracker", "prev_active"}
    resumed = runner()
    xc, yc = resumed.run(ck["x"], ck["y"], 6, state=ck["strategy_state"],
                         schedule=sched.tail(6), elastic_state=ck["elastic_state"])
    assert torch.equal(xf, xc) and torch.equal(yf, yc)
    last = restore_checkpoint(latest_checkpoint(str(tmp_path / "full"))[1], "cpu")
    assert torch.equal(last["x"], xf)
    assert torch.equal(last["elastic_state"]["prev_active"],
                       torch.from_numpy(sched.active[-1]))
    naive = runner()
    xm2, ym2 = naive.run(_zeros(), _zeros(), 6, schedule=sched)
    xn, _ = naive.run(xm2, ym2, 6, schedule=sched.tail(6))
    assert not torch.equal(xf, xn)


def test_jax_elastic_state_resumes_in_the_port():
    """A JAX elastic run's `elastic_state` and strategy state, carried over
    by `convert`, continue in the port as JAX continues (1e-12)."""
    jp, tp = _problems(m=6)
    kw = {"compression_ratio": 0.5, "seed": 0}
    pop = dict(p_leave=0.3, p_join=0.5)
    jsched = jsim.Population(6, jsim.MarkovChurn(**pop)).schedule(1, 12, 4)
    sched = sim.Population(6, sim.MarkovChurn(**pop)).schedule(1, 12, 4, device="cpu")
    jr = jfed.FederatedRunner.from_strategy(
        jp.loss, jfed.CompressedGT(**kw), jp.agent_data, 4, ETA)
    jxm, jym = jr.run(jnp.zeros(16), jnp.zeros(16), 6, schedule=jsched)
    jstate = jax.tree.map(np.asarray, jr._state)
    jel = jax.tree.map(np.asarray, jr.elastic_state)
    jxf, jyf = jr.run(jxm, jym, 6, schedule=jsched.tail(6),
                      elastic_state=jr.elastic_state)
    r = fed.FederatedRunner.from_strategy(tp.loss, fed.CompressedGT(**kw),
                                          tp.agent_data, 4, ETA)
    el = elastic_state_from_numpy(jel, "cpu")
    assert el["prev_active"].dtype == torch.bool
    xf, yf = r.run(torch.from_numpy(np.array(jxm)), torch.from_numpy(np.array(jym)),
                   6, state=strategy_state_from_numpy(jstate, "cpu"),
                   schedule=sched.tail(6), elastic_state=el)
    np.testing.assert_allclose(xf.numpy(), np.asarray(jxf), rtol=1e-12)
    np.testing.assert_allclose(yf.numpy(), np.asarray(jyf), rtol=1e-12)
    assert elastic_state_from_numpy({"tracker": {}, "prev_active": None}, "cpu") == {
        "tracker": {}, "prev_active": None}


def test_runner_rejects_wrong_population_size():
    _, tp = _problems(m=4)
    sched = sim.make_population("flaky", 6).schedule(0, 5, 3, device="cpu")
    r = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                          tp.agent_data, 3, ETA)
    with pytest.raises(ValueError, match="m=6"):
        r.run(_zeros(), _zeros(), 5, schedule=sched)
    with pytest.raises(ValueError, match="covers 5 rounds"):
        r.run(_zeros(), _zeros(), 6,
              schedule=sim.make_population("flaky", 4).schedule(0, 5, 3, device="cpu"))


def test_partial_participation_bytes_not_double_discounted():
    sched = sim.make_population("stable", 4).schedule(0, 2, 3, device="cpu")
    pp = sim.schedule_bytes(fed.PartialParticipation(participation=0.5),
                            _zeros(), _zeros(), 3, sched)
    gt = sim.schedule_bytes(fed.GradientTracking(), _zeros(), _zeros(), 3, sched)
    assert pp == gt
    # the pod edge (two live pods a round, each a partial up and a
    # broadcast down) prices as JAX's
    pods = sim.schedule_bytes(fed.GradientTracking(), _zeros(), _zeros(), 3, sched,
                              pods=sim.PodMap(4, 2))
    jx = jnp.zeros(16)
    assert pods == jsim.schedule_bytes(
        jfed.GradientTracking(), jx, jx, 3, jsim.make_population("stable", 4)
        .schedule(0, 2, 3), pods=jsim.PodMap(4, 2))
    assert pods == [g + 2 * 2 * (2 * (16 * 8 + 16)) for g in gt]


def test_gradient_tracking_rebase_state_is_noop():
    state = {"anything": torch.ones(3)}
    assert fed.GradientTracking().rebase_state(state, torch.tensor([True, False])) \
        is state


def test_departed_agents_contribute_zero_bytes():
    strat, K = fed.GradientTracking(), 5
    full = sim.make_population("stable", 4).schedule(0, 3, K, device="cpu")
    per_round_full = sim.schedule_bytes(strat, _zeros(), _zeros(), K, full)
    active = np.array([[1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 1, 0]], bool)
    part = sim.RoundSchedule(active, np.where(active, K, 0), K)
    per_agent = per_round_full[0] // 4
    assert sim.schedule_bytes(strat, _zeros(), _zeros(), K, part) == [
        4 * per_agent, 2 * per_agent, per_agent]
    assert per_agent == sim.per_agent_bytes(strat, _zeros(), _zeros(), K)
    # and as JAX prices them
    jpart = jsim.RoundSchedule(active, np.where(active, K, 0), K)
    assert jsim.schedule_bytes(jfed.GradientTracking(), jnp.zeros(16), jnp.zeros(16),
                               K, jpart) == [4 * per_agent, 2 * per_agent, per_agent]


@pytest.mark.parametrize("alias,kw", [
    ("fedgda_gt", {}), ("partial_gt", {"participation": 0.5}),
    ("compressed_gt", {"compression_ratio": 0.25}),
    ("quantized_gt", {"quantization_bits": 4, "compression_ratio": 0.25,
                      "wire_transport": True}),
])
def test_wire_report_with_a_schedule_equals_jax(alias, kw):
    jp, tp = _problems(m=6)
    jsched = jsim.make_population("flaky", 6).schedule(0, 9, 3)
    sched = sim.make_population("flaky", 6).schedule(0, 9, 3, device="cpu")
    jr = jfed.FederatedRunner.from_strategy(
        jp.loss, jfed.resolve_strategy(alias, **kw), jp.agent_data, 3, ETA)
    r = fed.FederatedRunner.from_strategy(tp.loss, alias, tp.agent_data, 3, ETA, **kw)
    want = jr.wire_report(jnp.zeros(16), jnp.zeros(16), 3, schedule=jsched)
    assert r.wire_report(_zeros(), _zeros(), 3, schedule=sched) == want
    # the runner remembers the schedule it ran
    r.run(_zeros(), _zeros(), 2, schedule=sched)
    assert r.wire_report(_zeros(), _zeros(), 3) == want


@pytest.mark.skipif(__import__("importlib").util.find_spec("hypothesis") is None,
                    reason="needs hypothesis")
def test_bytes_scale_with_active_count_property():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    strat = fed.QuantizedGT(bits=8)
    per_agent = sim.per_agent_bytes(strat, _zeros(), _zeros(), 3)

    @given(rows=st.lists(st.integers(0, 2 ** 6 - 1), min_size=1, max_size=8))
    @settings(max_examples=25, deadline=None)
    def inner(rows):
        active = np.array([[(r >> i) & 1 for i in range(6)] for r in rows], bool)
        active[:, 0] |= ~active.any(axis=1)  # keep rounds nonempty
        sched = sim.RoundSchedule(active, np.where(active, 3, 0), 3)
        assert sim.schedule_bytes(strat, _zeros(), _zeros(), 3, sched) == [
            per_agent * int(a.sum()) for a in active]

    inner()


def test_sparse_schedule_densifies_through_the_runner(capsys):
    """A small-m SparseRoundSchedule runs densified, as its densified
    schedule does, bit for bit (and logs its rounds)."""
    _, tp = _problems(m=8)
    pop = sim.Population(8, sim.UniformActiveSubset(size=4),
                         sim.UniformStragglers(p_straggle=0.5, min_frac=0.4))
    sp = pop.sparse_schedule(0, 6, 5, device="cpu")
    a = fed.FederatedRunner.from_strategy(tp.loss, "fedgda_gt", tp.agent_data, 5, ETA)
    b = fed.FederatedRunner.from_strategy(tp.loss, "fedgda_gt", tp.agent_data, 5, ETA)
    xa, ya = a.run(_zeros(), _zeros(), 6, schedule=sp, log_every=3)
    xb, yb = b.run(_zeros(), _zeros(), 6, schedule=sp.densify())
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert a.metric_series("n_active").tolist() == [4.0] * 6
    logged = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in logged] == [
        f"[elastic round {t:5d}" for t in (0, 3, 5)]


def test_replace_keeps_strategy_identity():
    """`per_agent_bytes` prices a partial strategy at participation 1
    without changing the caller's strategy."""
    pp = fed.PartialParticipation(participation=0.5)
    sim.per_agent_bytes(pp, _zeros(), _zeros(), 3)
    assert pp.participation == 0.5
    assert dataclasses.replace(pp, participation=1.0).bytes_per_round(
        _zeros(), _zeros(), 3) == fed.GradientTracking().bytes_per_round(
        _zeros(), _zeros(), 3)
