"""The committed fixture `src/repro_torch/fixtures/paper_quadratic.npz` is
what the JAX package builds: the paper's quadratic problems drawn from
PRNGKey(0) and JAX's FedGDA-GT gap trajectories on them.  It is the one
place where the port's card run (`chip_smoke.py`) meets JAX's numbers.

Run this file as a script to rewrite the fixture:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fixtures.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import make_fedgda_gt_round, run_rounds, tree_sq_dist
from repro.problems import make_quadratic_problem, quadratic_minimax_point
from repro_torch.fixtures import PAPER_QUADRATIC, load_paper_quadratic

pytestmark = pytest.mark.torch

#: (prefix, dim, num_samples, num_agents, K, eta, rounds): the Theorem 1
#: case of tests/test_paper_claims.py and the paper's Sec 5.1 scale
CASES = (
    ("thm1", 20, 100, 8, 10, 2e-4, 4000),
    ("sec51", 50, 500, 20, 20, 1e-4, 1500),
)


def build_fixture() -> dict:
    out = {}
    for name, dim, n, m, K, eta, rounds in CASES:
        prob = make_quadratic_problem(
            jax.random.PRNGKey(0), dim=dim, num_samples=n, num_agents=m
        )
        xs, ys = quadratic_minimax_point(prob)

        def metric(x, y):
            return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

        x0 = jnp.zeros(dim)
        rnd = jax.jit(make_fedgda_gt_round(prob.loss, K, eta))
        _, met = run_rounds(rnd, x0, x0, prob.agent_data, rounds, metric)
        out[f"{name}_G"] = np.asarray(prob.agent_data["G"])
        out[f"{name}_Ab"] = np.asarray(prob.agent_data["Ab"])
        out[f"{name}_gap"] = np.asarray(met["gap"])
    return out


@pytest.fixture(scope="module")
def rebuilt():
    return build_fixture()


def test_fixture_has_the_expected_arrays():
    got = load_paper_quadratic()
    for name, dim, n, m, K, eta, rounds in CASES:
        assert got[f"{name}_G"].shape == (m, dim, dim)
        assert got[f"{name}_Ab"].shape == (m, dim)
        assert got[f"{name}_gap"].shape == (rounds + 1,)
        assert all(v.dtype == np.float64 for v in got.values())


@pytest.mark.parametrize("key", [f"{c[0]}_{k}" for c in CASES for k in ("G", "Ab", "gap")])
def test_fixture_equals_the_jax_package(rebuilt, key):
    """Equal up to f64 rounding: XLA's CPU reductions may order sums by
    the host's vector width.  1e-12 relative on the data; on the gaps
    above the 1e-14 floor, 1e-5 relative, the tolerance the port's own
    trajectories are held to (another summation order moves a gap of
    1e-14 by ~4e-7 relative, as torch's does on this problem)."""
    got = load_paper_quadratic()[key]
    want = rebuilt[key]
    assert got.shape == want.shape
    if key.endswith("_gap"):
        sel = want > 1e-14
        np.testing.assert_allclose(got[sel], want[sel], rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    PAPER_QUADRATIC.parent.mkdir(parents=True, exist_ok=True)
    np.savez(PAPER_QUADRATIC, **build_fixture())
    print(f"wrote {PAPER_QUADRATIC}")
