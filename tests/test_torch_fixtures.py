"""The committed fixtures under `src/repro_torch/fixtures/` are what the
JAX package builds:

  * `paper_quadratic.npz`: the paper's quadratic problems drawn from
    PRNGKey(0) and JAX's FedGDA-GT gap trajectories on them;
  * `compressed_rounds.npz`: JAX's gap trajectories of the
    communication-efficient rounds (CompressedGT / QuantizedGT, the
    fixture package's `RUNS`) on the Theorem 1 problem and on the d=6,
    m=8 quadratic, with that problem's data.

They are the one place where the port's card run (`chip_smoke.py`) meets
JAX's numbers.  Run this file as a script to rewrite both:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import (
    make_fedgda_gt_round,
    make_round,
    run_rounds,
    run_strategy_rounds,
    tree_sq_dist,
)
from repro.fed import resolve_strategy
from repro.problems import make_quadratic_problem, quadratic_minimax_point
from repro_torch.fixtures import (
    COMPRESSED_ROUNDS,
    PAPER_QUADRATIC,
    QUAD6,
    QUAD6_ROUNDS,
    QUAD6_RUNS,
    RUNS,
    THM1_ROUNDS,
    THM1_RUNS,
    load_compressed_rounds,
    load_paper_quadratic,
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


@pytest.fixture(scope="module")
def rebuilt():
    return build_fixture()


@pytest.fixture(scope="module")
def rebuilt_compressed():
    return build_compressed_fixture()


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


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    PAPER_QUADRATIC.parent.mkdir(parents=True, exist_ok=True)
    np.savez(PAPER_QUADRATIC, **build_fixture())
    print(f"wrote {PAPER_QUADRATIC}")
    np.savez(COMPRESSED_ROUNDS, **build_compressed_fixture())
    print(f"wrote {COMPRESSED_ROUNDS}")
