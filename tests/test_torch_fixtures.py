"""The committed fixtures under `src/repro_torch/fixtures/` are what the
JAX package builds:

  * `paper_quadratic.npz`: the paper's quadratic problems drawn from
    PRNGKey(0) and JAX's FedGDA-GT gap trajectories on them;
  * `compressed_rounds.npz`: JAX's gap trajectories of the
    communication-efficient rounds (CompressedGT / QuantizedGT, the
    fixture package's `RUNS`) on the Theorem 1 problem and on the d=6,
    m=8 quadratic, with that problem's data;
  * `robust_agnostic.npz`: the Fig 2 robust-regression problems (alpha 1,
    5, 20) with JAX's stepsizes, iterates every 10th round and robust
    losses, and the Appendix A.2 agnostic problem with JAX's final
    lambda and per-agent risks;
  * `stochastic_rounds.npz`: the Section 4 separation's problem and JAX's
    four gap trajectories, PartialParticipation's masks and gaps, the
    noisy robust-regression and compressed runs, and the two Dirichlet
    problems with JAX's rows of the stochastic generalization table;
  * `elastic_rounds.npz`: the elastic benchmark's problem, the four
    scenarios' schedules, JAX's per-round gaps of the five flaky rows and
    JAX's whole table.

They are the one place where the port's card run (`chip_smoke.py`) meets
JAX's numbers.  Run this file as a script to rewrite all five:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import (
    make_fedgda_gt_round,
    make_local_sgda_round,
    make_round,
    run_rounds,
    run_strategy_rounds,
    tree_sq_dist,
)
from repro.fed import resolve_strategy
from repro.problems import (
    make_agnostic_problem,
    make_quadratic_problem,
    make_robust_regression_problem,
    per_agent_risks,
    quadratic_minimax_point,
    robust_loss,
    uniform_lambda,
)
import benchmarks.elastic as jel
import benchmarks.generalization as jgen
from repro.sim import make_population, schedule_bytes
from repro_torch.fixtures import (
    AGNOSTIC,
    COMPRESSED_ROUNDS,
    DIRICHLET,
    ELASTIC,
    ELASTIC_ROUNDS,
    ELASTIC_ROWS,
    ELASTIC_SCENARIOS,
    ELASTIC_TABLE_COLS,
    GEN_ROWS,
    NOISY_RUNS,
    PARTIAL,
    PARTIAL_KW,
    SEC4,
    SEC4_RUNS,
    STOCHASTIC_ROUNDS,
    PAPER_QUADRATIC,
    QUAD6,
    QUAD6_ROUNDS,
    QUAD6_RUNS,
    ROBUST,
    ROBUST_AGNOSTIC,
    ROBUST_ALPHAS,
    ROBUST_EVERY,
    ROBUST_RUNS,
    RUNS,
    THM1_ROUNDS,
    THM1_RUNS,
    dirichlet_key,
    elastic_rounds_keys,
    elastic_table_keys,
    load_compressed_rounds,
    load_elastic_rounds,
    load_paper_quadratic,
    load_robust_agnostic,
    load_stochastic_rounds,
    robust_agnostic_keys,
    robust_key,
    stochastic_rounds_keys,
)

pytestmark = pytest.mark.torch

#: (prefix, dim, num_samples, num_agents, K, eta, rounds): the Theorem 1
#: case of tests/test_paper_claims.py and the paper's Sec 5.1 scale
CASES = (
    ("thm1", 20, 100, 8, 10, 2e-4, 4000),
    ("sec51", 50, 500, 20, 20, 1e-4, 1500),
)


def _gap_metric(prob):
    xs, ys = quadratic_minimax_point(prob)

    def metric(x, y):
        return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

    return metric


def build_fixture() -> dict:
    out = {}
    for name, dim, n, m, K, eta, rounds in CASES:
        prob = make_quadratic_problem(
            jax.random.PRNGKey(0), dim=dim, num_samples=n, num_agents=m
        )
        x0 = jnp.zeros(dim)
        rnd = jax.jit(make_fedgda_gt_round(prob.loss, K, eta))
        _, met = run_rounds(rnd, x0, x0, prob.agent_data, rounds,
                            _gap_metric(prob))
        out[f"{name}_G"] = np.asarray(prob.agent_data["G"])
        out[f"{name}_Ab"] = np.asarray(prob.agent_data["Ab"])
        out[f"{name}_gap"] = np.asarray(met["gap"])
    return out


def compressed_gaps(prob, run: str, K: int, eta: float, rounds: int):
    """JAX's per-round gaps of fixture run `run` on `prob` (x0 = y0 = 0)."""
    name, kw = RUNS[run]
    strategy = resolve_strategy(name, **kw)
    dim = prob.agent_data["Ab"].shape[1]
    x0 = jnp.zeros(dim)
    rnd = jax.jit(make_round(prob.loss, strategy, K, eta, explicit_state=True))
    state0 = strategy.init_state(x0, x0, prob.num_agents)
    _, met = run_strategy_rounds(rnd, x0, x0, prob.agent_data, rounds, state0,
                                 _gap_metric(prob))
    return np.asarray(met["gap"])


def build_compressed_fixture() -> dict:
    out = {}
    thm1 = make_quadratic_problem(
        jax.random.PRNGKey(0), dim=20, num_samples=100, num_agents=8
    )
    for run in THM1_RUNS:
        out[f"thm1_{run}_gap"] = compressed_gaps(thm1, run, 10, 2e-4, THM1_ROUNDS)
    dim, n, m, K, eta = QUAD6
    quad6 = make_quadratic_problem(
        jax.random.PRNGKey(0), dim=dim, num_samples=n, num_agents=m
    )
    out["quad6_G"] = np.asarray(quad6.agent_data["G"])
    out["quad6_Ab"] = np.asarray(quad6.agent_data["Ab"])
    for run in QUAD6_RUNS:
        out[f"quad6_{run}_gap"] = compressed_gaps(quad6, run, K, eta, QUAD6_ROUNDS)
    return out


def stable_eta(prob) -> float:
    """`benchmarks/fig2_robust_regression.py` `_stable_eta`: 0.1 / L."""
    a = prob.agent_data["a"]
    dim = a.shape[-1]
    H = 2 * jnp.einsum("mnd,mne->de", a, a) / (a.shape[0] * a.shape[1])
    return 0.1 / float(jnp.linalg.eigvalsh(H + jnp.eye(dim))[-1])


def robust_trajectory(rnd, data, dim, rounds, every):
    """x at rounds 0, every, 2*every, ..., rounds (x0 = y0 = 0)."""
    x = y = jnp.zeros(dim)
    xs = [x]
    for t in range(1, rounds + 1):
        x, y = rnd(x, y, data)
        if t % every == 0:
            xs.append(x)
    return np.stack([np.asarray(v) for v in xs])


def build_robust_agnostic_fixture() -> dict:
    """`benchmarks/fig2_robust_regression.py` at its own size for each
    alpha, and `examples/agnostic_federated.py`'s setup."""
    out = {}
    dim, n, m, K, T = ROBUST
    for alpha in ROBUST_ALPHAS:
        prob = make_robust_regression_problem(
            jax.random.PRNGKey(0), dim=dim, num_samples=n, num_agents=m,
            alpha=alpha)
        eta = stable_eta(prob)
        rounds = {
            "gt": (make_fedgda_gt_round(prob.loss, K, eta, proj_y=prob.proj_y), T),
            "ls": (make_local_sgda_round(prob.loss, K, eta, eta,
                                         proj_y=prob.proj_y), T),
            "c": (make_local_sgda_round(prob.loss, 1, eta, eta,
                                        proj_y=prob.proj_y), T * K),
        }
        pre = robust_key(alpha)
        out[f"{pre}_a"] = np.asarray(prob.agent_data["a"])
        out[f"{pre}_b"] = np.asarray(prob.agent_data["b"])
        out[f"{pre}_eta"] = np.asarray(eta)
        for run in ROBUST_RUNS:
            rnd, rounds_of = rounds[run]
            xs = robust_trajectory(jax.jit(rnd), prob.agent_data, dim, rounds_of,
                                   ROBUST_EVERY)
            out[f"{pre}_{run}_x"] = xs
            out[f"{pre}_{run}_robust_loss"] = np.asarray(
                robust_loss(prob, jnp.asarray(xs[-1])))
    dim, n, m, shift, K, eta, T = AGNOSTIC
    prob = make_agnostic_problem(jax.random.PRNGKey(0), dim=dim, num_samples=n,
                                 num_agents=m, shift=shift)
    out["agnostic_a"] = np.asarray(prob.agent_data["a"])
    out["agnostic_b"] = np.asarray(prob.agent_data["b"])
    for run, proj_y in (("agnostic", prob.proj_y),
                        ("uniform", lambda y: uniform_lambda(m))):
        rnd = jax.jit(make_fedgda_gt_round(prob.loss, K, eta, proj_y=proj_y))
        x, y = jnp.zeros(dim), uniform_lambda(m)
        for _ in range(T):
            x, y = rnd(x, y, prob.agent_data)
        out[f"{run}_x"] = np.asarray(x)
        out[f"{run}_lambda"] = np.asarray(y)
        out[f"{run}_risks"] = np.asarray(per_agent_risks(prob, x))
    return out


def strategy_run(prob, strategy, K, eta, rounds, metric=None, proj_y=None):
    """JAX's run of `strategy` from x0 = y0 = 0 with its own initial state:
    per-round gaps under `metric`, else x every ROBUST_EVERY-th round."""
    dim = prob.agent_data["Ab" if "Ab" in prob.agent_data else "a"].shape[-1]
    x0 = jnp.zeros(dim)
    kw = {} if proj_y is None else {"proj_y": proj_y}
    rnd = jax.jit(make_round(prob.loss, strategy, K, eta, explicit_state=True,
                             **kw))
    state = strategy.init_state(x0, x0, prob.num_agents)
    if metric is not None:
        _, met = run_strategy_rounds(rnd, x0, x0, prob.agent_data, rounds,
                                     state, metric)
        return np.asarray(met["gap"])
    x = y = x0
    xs = [x]
    for t in range(1, rounds + 1):
        x, y, state = rnd(x, y, prob.agent_data, state)
        if t % ROBUST_EVERY == 0:
            xs.append(x)
    return np.stack([np.asarray(v) for v in xs])


def build_stochastic_fixture() -> dict:
    out = {}
    dim, n, m, K, eta, T = SEC4
    sec4 = make_quadratic_problem(jax.random.PRNGKey(0), dim=dim,
                                  num_samples=n, num_agents=m)
    out["sec4_G"] = np.asarray(sec4.agent_data["G"])
    out["sec4_Ab"] = np.asarray(sec4.agent_data["Ab"])
    for run, (name, kw) in SEC4_RUNS.items():
        out[f"sec4_{run}_gap"] = strategy_run(
            sec4, resolve_strategy(name, **kw), K, eta, T, _gap_metric(sec4))
    thm1 = make_quadratic_problem(jax.random.PRNGKey(0), dim=20,
                                  num_samples=100, num_agents=8)
    K, eta, T = PARTIAL
    pp = resolve_strategy("partial_gt", **PARTIAL_KW)
    state, masks = pp.init_state(jnp.zeros(20), jnp.zeros(20), 8), []
    for _ in range(T):
        w, state = pp.sample_weights(state, 8)
        masks.append(np.asarray(w) > 0)
    out["partial_mask"] = np.stack(masks)
    out["partial_gap"] = strategy_run(thm1, pp, K, eta, T, _gap_metric(thm1))
    for run, (which, name, kw, K, eta, T) in NOISY_RUNS.items():
        strategy = resolve_strategy(name, **kw)
        if which == "thm1":
            out[f"noisy_{run}_gap"] = strategy_run(thm1, strategy, K, eta, T,
                                                   _gap_metric(thm1))
            continue
        rdim, rn, rm = ROBUST[:3]
        prob = make_robust_regression_problem(
            jax.random.PRNGKey(0), dim=rdim, num_samples=rn, num_agents=rm,
            alpha=float(which[len("robust"):]))
        out[f"noisy_{run}_x"] = strategy_run(prob, strategy, K, stable_eta(prob),
                                             T, proj_y=prob.proj_y)
    out.update(build_dirichlet_rows())
    return out


def build_dirichlet_rows() -> dict:
    """`benchmarks/generalization.py` `stochastic_rows`, as numbers: the
    problems it draws from PRNGKey(7) and, per (strategy, noise) of
    GEN_ROWS, rounds to eps, the final distance and the generalization gap
    of the trained iterates."""
    from repro.core import generalization_gap
    from repro.problems import make_dirichlet_quadratic_problem

    dim, n, m, comps, alphas = DIRICHLET
    out = {}
    for alpha in alphas:
        prob, test, w = make_dirichlet_quadratic_problem(
            jax.random.PRNGKey(7), dim=dim, num_samples=n, num_agents=m,
            alpha=alpha, num_components=comps, test_samples=n)
        x_star, y_star = quadratic_minimax_point(prob)
        gap_fn = jax.jit(generalization_gap(prob.loss, prob.agent_data, test))
        strategies = {noise: dict(jgen._stoch_strategies(noise))
                      for noise in ("none", "gaussian")}
        rows = []
        for name, noise in GEN_ROWS:
            r_eps, final, x, y = jgen._stoch_one(
                prob, strategies[noise][name], x_star, y_star)
            rows.append([r_eps, final, float(gap_fn(x, y))])
        pre = dirichlet_key(alpha)
        out[f"{pre}_G"] = np.asarray(prob.agent_data["G"])
        out[f"{pre}_Ab"] = np.asarray(prob.agent_data["Ab"])
        out[f"{pre}_test_G"] = np.asarray(test["G"])
        out[f"{pre}_test_Ab"] = np.asarray(test["Ab"])
        out[f"{pre}_weights"] = np.asarray(w)
        out[f"{pre}_rows"] = np.asarray(rows, np.float64)
    return out


@pytest.fixture(scope="module")
def rebuilt():
    return build_fixture()


@pytest.fixture(scope="module")
def rebuilt_compressed():
    return build_compressed_fixture()


@pytest.fixture(scope="module")
def rebuilt_robust_agnostic():
    return build_robust_agnostic_fixture()


def test_fixture_has_the_expected_arrays():
    got = load_paper_quadratic()
    for name, dim, n, m, K, eta, rounds in CASES:
        assert got[f"{name}_G"].shape == (m, dim, dim)
        assert got[f"{name}_Ab"].shape == (m, dim)
        assert got[f"{name}_gap"].shape == (rounds + 1,)
        assert all(v.dtype == np.float64 for v in got.values())


def test_compressed_fixture_has_the_expected_arrays():
    got = load_compressed_rounds()
    dim, n, m, K, eta = QUAD6
    assert got["quad6_G"].shape == (m, dim, dim)
    assert got["quad6_Ab"].shape == (m, dim)
    for run in THM1_RUNS:
        assert got[f"thm1_{run}_gap"].shape == (THM1_ROUNDS + 1,)
    for run in QUAD6_RUNS:
        assert got[f"quad6_{run}_gap"].shape == (QUAD6_ROUNDS + 1,)
    assert all(v.dtype == np.float64 for v in got.values())


def test_robust_agnostic_fixture_has_the_expected_arrays():
    got = load_robust_agnostic()
    assert sorted(got) == robust_agnostic_keys()
    dim, n, m, K, T = ROBUST
    for alpha in ROBUST_ALPHAS:
        pre = robust_key(alpha)
        assert got[f"{pre}_a"].shape == (m, n, dim)
        assert got[f"{pre}_b"].shape == (m, n)
        assert got[f"{pre}_eta"].shape == ()
        for run in ROBUST_RUNS:
            rounds = T * K if run == "c" else T
            assert got[f"{pre}_{run}_x"].shape == (rounds // ROBUST_EVERY + 1, dim)
            assert got[f"{pre}_{run}_robust_loss"].shape == ()
    dim, n, m = AGNOSTIC[:3]
    assert got["agnostic_a"].shape == (m, n, dim)
    for run in ("agnostic", "uniform"):
        assert got[f"{run}_lambda"].shape == got[f"{run}_risks"].shape == (m,)
    assert all(v.dtype == np.float64 for v in got.values())
    assert ROBUST_AGNOSTIC.stat().st_size < 1.5e6


def _assert_fixture_equal(key, got, want):
    """Equal up to f64 rounding: XLA's CPU reductions may order sums by
    the host's vector width.  1e-12 relative on the data; on the gaps
    above the 1e-14 floor, 1e-5 relative, the tolerance the port's own
    trajectories are held to (another summation order moves a gap of
    1e-14 by ~4e-7 relative, as torch's does on this problem)."""
    assert got.shape == want.shape
    if key.endswith("_gap"):
        sel = want > 1e-14
        np.testing.assert_allclose(got[sel], want[sel], rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("key", [f"{c[0]}_{k}" for c in CASES for k in ("G", "Ab", "gap")])
def test_fixture_equals_the_jax_package(rebuilt, key):
    _assert_fixture_equal(key, load_paper_quadratic()[key], rebuilt[key])


@pytest.mark.parametrize(
    "key",
    ["quad6_G", "quad6_Ab"]
    + [f"thm1_{r}_gap" for r in THM1_RUNS]
    + [f"quad6_{r}_gap" for r in QUAD6_RUNS],
)
def test_compressed_fixture_equals_the_jax_package(rebuilt_compressed, key):
    _assert_fixture_equal(key, load_compressed_rounds()[key],
                          rebuilt_compressed[key])


@pytest.mark.parametrize("key", robust_agnostic_keys())
def test_robust_agnostic_fixture_equals_the_jax_package(
        rebuilt_robust_agnostic, key):
    """Data, stepsizes, iterates, losses, lambda and risks: 1e-12
    relative, the data's tolerance above (XLA's CPU sums may follow the
    host's vector width; iterates and losses run a few thousand
    contracting rounds of them)."""
    got, want = load_robust_agnostic()[key], rebuilt_robust_agnostic[key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def rebuilt_stochastic():
    return build_stochastic_fixture()


def test_stochastic_fixture_has_the_expected_arrays():
    got = load_stochastic_rounds()
    assert sorted(got) == stochastic_rounds_keys()
    dim, n, m, K, eta, T = SEC4
    assert got["sec4_G"].shape == (m, dim, dim)
    for run in SEC4_RUNS:
        assert got[f"sec4_{run}_gap"].shape == (T + 1,)
    assert got["partial_mask"].shape == (PARTIAL[2], 8)
    assert got["partial_mask"].dtype == bool
    assert (got["partial_mask"].sum(axis=1) == 4).all()
    assert got["partial_gap"].shape == (PARTIAL[2] + 1,)
    assert got["noisy_robust5_minibatch_x"].shape == (
        NOISY_RUNS["robust5_minibatch"][5] // ROBUST_EVERY + 1, ROBUST[0])
    assert got["noisy_thm1_cgt_randk_gap"].shape == (
        NOISY_RUNS["thm1_cgt_randk"][5] + 1,)
    dim, n, m, comps, alphas = DIRICHLET
    # the generalization benchmark's own sizes
    assert (dim, n, m, alphas) == (jgen.S_DIM, jgen.S_N, jgen.S_M, jgen.S_ALPHAS)
    for alpha in alphas:
        pre = dirichlet_key(alpha)
        assert got[f"{pre}_G"].shape == got[f"{pre}_test_G"].shape == (m, dim, dim)
        assert got[f"{pre}_weights"].shape == (m, comps)
        assert got[f"{pre}_rows"].shape == (len(GEN_ROWS), 3)
    assert STOCHASTIC_ROUNDS.stat().st_size < 1e6


@pytest.mark.parametrize("key", stochastic_rounds_keys())
def test_stochastic_fixture_equals_the_jax_package(rebuilt_stochastic, key):
    """Masks and rounds-to-eps exactly; gaps as the other fixtures' gaps
    (1e-5 relative above 1e-14); data, iterates, distances and
    generalization gaps 1e-12 relative (XLA's CPU sums may follow the
    host's vector width)."""
    got, want = load_stochastic_rounds()[key], rebuilt_stochastic[key]
    assert got.shape == want.shape
    if key == "partial_mask":
        assert np.array_equal(got, want)
    elif key.endswith("_rows"):
        assert np.array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-9, atol=1e-15)
    else:
        _assert_fixture_equal(key, got, want)


def build_elastic_fixture() -> dict:
    """`benchmarks/elastic.py` `run()` as numbers: its problem, the
    scenarios' schedules, the flaky rows' per-round gaps and every row of
    its table (participation, rounds to eps, mean and total bytes to eps,
    final gap)."""
    dim, n, m, K, eta, T, seed = ELASTIC
    assert (dim, m, K, eta, T, seed) == (jel.DIM, jel.M, jel.K, jel.ETA, jel.T,
                                         jel.SEED)
    assert tuple(ELASTIC_ROWS) == tuple(r[0] for r in jel._strategies())
    prob, metric = jel._problem()
    assert prob.agent_data["G"].shape == (m, dim, dim)
    x0 = jnp.zeros(dim)
    out = {"G": np.asarray(prob.agent_data["G"]),
           "Ab": np.asarray(prob.agent_data["Ab"])}
    table = []
    for scenario in ELASTIC_SCENARIOS:
        schedule = make_population(scenario, m).schedule(seed, T, K)
        out[f"{scenario}_active"] = schedule.active
        out[f"{scenario}_budgets"] = schedule.budgets
        for name, strategy, rebase in jel._strategies():
            if scenario == "stable" and not rebase:
                continue
            gaps = jel._run_one(prob, metric, strategy, schedule, rebase)
            if scenario == "flaky":
                out[f"flaky_{name}_gap"] = gaps
            r_eps = jel._rounds_to_eps(gaps)
            per_round = schedule_bytes(strategy, x0, x0, K, schedule)
            total = (np.inf if np.isinf(r_eps)
                     else float(sum(per_round[: int(r_eps) + 1])))
            table.append([schedule.participation_rate(), r_eps,
                          float(int(np.mean(per_round))), total, float(gaps[-1])])
    out["table"] = np.asarray(table, np.float64)
    out["table_keys"] = np.asarray(elastic_table_keys())
    assert out["table"].shape == (len(out["table_keys"]), len(ELASTIC_TABLE_COLS))
    return out


@pytest.fixture(scope="module")
def rebuilt_elastic():
    return build_elastic_fixture()


def test_elastic_fixture_has_the_expected_arrays():
    got = load_elastic_rounds()
    assert sorted(got) == elastic_rounds_keys()
    dim, n, m, K, eta, T, seed = ELASTIC
    assert got["G"].shape == (m, dim, dim) and got["Ab"].shape == (m, dim)
    for scenario in ELASTIC_SCENARIOS:
        assert got[f"{scenario}_active"].shape == (T, m)
        assert got[f"{scenario}_active"].dtype == bool
        assert got[f"{scenario}_budgets"].dtype == np.int32
    assert got["stable_active"].all()
    for row in ELASTIC_ROWS:
        assert got[f"flaky_{row}_gap"].shape == (T,)
    assert list(got["table_keys"]) == elastic_table_keys()
    assert ELASTIC_ROUNDS.stat().st_size < 5e5


@pytest.mark.parametrize("key", elastic_rounds_keys())
def test_elastic_fixture_equals_the_jax_package(rebuilt_elastic, key):
    """Schedules, keys, rounds to eps and bytes exactly; gaps as the other
    fixtures' (1e-5 relative above 1e-14); data, participation and final
    gaps 1e-12 relative above 1e-14."""
    got, want = load_elastic_rounds()[key], rebuilt_elastic[key]
    assert got.shape == want.shape
    if key.endswith(("_active", "_budgets", "table_keys")):
        assert np.array_equal(got, want)
    elif key == "table":
        assert np.array_equal(got[:, 1:4], want[:, 1:4])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-15)
        sel = want[:, 4] > 1e-14
        np.testing.assert_allclose(got[sel, 4], want[sel, 4], rtol=1e-5)
    else:
        _assert_fixture_equal(key, got, want)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    PAPER_QUADRATIC.parent.mkdir(parents=True, exist_ok=True)
    np.savez(PAPER_QUADRATIC, **build_fixture())
    print(f"wrote {PAPER_QUADRATIC}")
    np.savez(COMPRESSED_ROUNDS, **build_compressed_fixture())
    print(f"wrote {COMPRESSED_ROUNDS}")
    np.savez(ROBUST_AGNOSTIC, **build_robust_agnostic_fixture())
    print(f"wrote {ROBUST_AGNOSTIC}")
    np.savez(STOCHASTIC_ROUNDS, **build_stochastic_fixture())
    print(f"wrote {STOCHASTIC_ROUNDS}")
    np.savez_compressed(ELASTIC_ROUNDS, **build_elastic_fixture())
    print(f"wrote {ELASTIC_ROUNDS}")
