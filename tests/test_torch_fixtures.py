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
    lambda and per-agent risks.

They are the one place where the port's card run (`chip_smoke.py`) meets
JAX's numbers.  Run this file as a script to rewrite all three:
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
from repro_torch.fixtures import (
    AGNOSTIC,
    COMPRESSED_ROUNDS,
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
    load_compressed_rounds,
    load_paper_quadratic,
    load_robust_agnostic,
    robust_agnostic_keys,
    robust_key,
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


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    PAPER_QUADRATIC.parent.mkdir(parents=True, exist_ok=True)
    np.savez(PAPER_QUADRATIC, **build_fixture())
    print(f"wrote {PAPER_QUADRATIC}")
    np.savez(COMPRESSED_ROUNDS, **build_compressed_fixture())
    print(f"wrote {COMPRESSED_ROUNDS}")
    np.savez(ROBUST_AGNOSTIC, **build_robust_agnostic_fixture())
    print(f"wrote {ROBUST_AGNOSTIC}")
