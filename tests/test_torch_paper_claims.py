"""The paper's claims on the port (CPU, f64, plain update path), beside
the JAX package's own gates in tests/test_paper_claims.py.

  * Theorem 1 at its real size: d=20, m=8, K=10, eta=2e-4, 4000 rounds;
    final gap < 1e-18, steady negative log-gap rates, and the per-round
    gaps within rtol 1e-5 of JAX's stored trajectory on rounds with gap
    > 1e-14 (f64 round-off in another summation order: ~4e-7 measured
    near the 1e-14 cut, ~1e-15 at the start).
  * Sec 5.1 at the paper's scale for 100 rounds, per round against JAX.
  * Proposition 1 through the closed-form residual, and K=1 GDA reaching
    the Appendix C minimax point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.problems import make_appendix_c_problem as jax_toy
from repro.problems import make_quadratic_problem as jax_quadratic
from repro.problems import quadratic_minimax_point as jax_point
from repro_torch import core
from repro_torch.convert import problem_from_numpy
from repro_torch.fixtures import load_paper_quadratic
from repro_torch.problems import make_appendix_c_problem, quadratic_minimax_point

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small problems are bound by per-op host overhead; extra
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GAP_RTOL = 1e-5


def _gap_metric(xs, ys):
    def metric(x, y):
        return {"gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)}

    return metric


def _port(jp):
    data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
    return problem_from_numpy("quadratic", data, device="cpu")


def _gaps(prob, rnd, dim, rounds):
    xs, ys = quadratic_minimax_point(prob)
    x0 = torch.zeros(dim, dtype=torch.float64)
    _, m = core.run_rounds(rnd, x0, x0, prob.agent_data, rounds, _gap_metric(xs, ys))
    return m["gap"].numpy()


def test_theorem1_linear_convergence_exact_limit(rng):
    jp = jax_quadratic(rng, dim=20, num_samples=100, num_agents=8)
    prob = _port(jp)
    gap = _gaps(prob, core.make_fedgda_gt_round(prob.loss, 10, 2e-4), 20, 4000)
    assert gap[-1] < 1e-18, gap[-1]
    seg = gap[(gap > 1e-14) & (gap < 1e2)]
    rates = np.diff(np.log(seg))
    assert np.all(rates < 0)
    assert np.std(rates) < 0.25 * abs(np.mean(rates))
    want = load_paper_quadratic()["thm1_gap"]
    sel = want > 1e-14
    np.testing.assert_allclose(gap[sel], want[sel], rtol=GAP_RTOL)


def test_sec51_paper_scale_round_by_round(rng):
    """d=50, n=500, m=20, eta=1e-4: FedGDA-GT (K=20), Local SGDA (K=20)
    and GDA (K=1), each per round against JAX for 100 rounds."""
    jp = jax_quadratic(rng, dim=50, num_samples=500, num_agents=20)
    prob = _port(jp)
    jxs, jys = jax_point(jp)

    def jgap(x, y):
        return {"gap": jcore.tree_sq_dist(x, jxs) + jcore.tree_sq_dist(y, jys)}

    eta, T = 1e-4, 100
    x0 = jnp.zeros(50)
    runs = {
        "gt": (jcore.make_fedgda_gt_round(jp.loss, 20, eta),
               core.make_fedgda_gt_round(prob.loss, 20, eta)),
        "ls": (jcore.make_local_sgda_round(jp.loss, 20, eta, eta),
               core.make_local_sgda_round(prob.loss, 20, eta, eta)),
        "gda": (jcore.make_local_sgda_round(jp.loss, 1, eta, eta),
                core.make_local_sgda_round(prob.loss, 1, eta, eta)),
    }
    final = {}
    for name, (jr, tr) in runs.items():
        _, jm = jcore.run_rounds(jax.jit(jr), x0, x0, jp.agent_data, T, jgap)
        got = _gaps(prob, tr, 50, T)
        want = np.asarray(jm["gap"])
        np.testing.assert_allclose(got, want, rtol=GAP_RTOL, err_msg=name)
        final[name] = got[-1]
    # FedGDA-GT is already well ahead of both baselines after 100 rounds
    assert final["gt"] < final["ls"] and final["gt"] < final["gda"]


class TestProposition1:
    K, ETA = 10, 1e-3

    def test_residual_zero_at_closed_form_fixed_point(self):
        prob = make_appendix_c_problem(device="cpu")
        fx, fy = core.appendix_c_fixed_point(self.K, self.ETA, self.ETA)
        x = torch.tensor(fx, dtype=torch.float64)
        y = torch.tensor(fy, dtype=torch.float64)
        r_fp = core.prop1_residual(prob.loss, x, y, prob.agent_data, self.K,
                                   self.ETA, self.ETA)
        assert float(r_fp) < 1e-10
        xm = torch.tensor(3.3, dtype=torch.float64)
        r_mm = core.prop1_residual(prob.loss, xm, xm, prob.agent_data, self.K,
                                   self.ETA, self.ETA)
        assert float(r_mm) > 1e-3

    @pytest.mark.parametrize("point", [(0.0, 0.0), (3.3, 3.3), (1.5, -2.0)])
    def test_residual_against_jax(self, point):
        tp = make_appendix_c_problem(device="cpu")
        jp = jax_toy()
        x, y = point
        got = core.prop1_residual(
            tp.loss, torch.tensor(x, dtype=torch.float64),
            torch.tensor(y, dtype=torch.float64), tp.agent_data, self.K,
            self.ETA, self.ETA,
        )
        want = jcore.prop1_residual(
            jp.loss, jnp.asarray(x), jnp.asarray(y), jp.agent_data, self.K,
            self.ETA, self.ETA,
        )
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)

    def test_closed_form_matches_the_reference(self):
        for K in (1, 2, 10, 50):
            assert core.appendix_c_fixed_point(K, 1e-3, 1e-3) == \
                jcore.appendix_c_fixed_point(K, 1e-3, 1e-3)

    def test_k1_gda_reaches_the_minimax_point(self):
        prob = make_appendix_c_problem(device="cpu")
        rnd = core.make_local_sgda_round(prob.loss, 1, 0.1, 0.1)
        x0 = torch.tensor(0.0, dtype=torch.float64)
        (x, y), _ = core.run_rounds(rnd, x0, x0, prob.agent_data, 200)
        np.testing.assert_allclose(float(x), 3.3, rtol=1e-9)
        np.testing.assert_allclose(float(y), 3.3, rtol=1e-9)
