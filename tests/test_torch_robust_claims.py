"""The paper's Section 5.2 claims on the port, at the reference's sizes
(tests/test_paper_claims.py:260 and :286), on the JAX builder's robust
regression data handed over as numpy (CPU, f64, plain update path).  The
per-round parity of these rounds with JAX is in
tests/test_torch_robust_regression.py."""
import pytest
import torch

from repro_torch import core
from repro_torch.problems import robust_loss
from test_torch_robust_regression import DIM, K, problems, stable_eta

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(rnd, data, T):
    x = y = torch.zeros(DIM, dtype=torch.float64)
    for _ in range(T):
        x, y = rnd(x, y, data)
    return x


def test_fig2c_high_heterogeneity_gt_at_least_as_good():
    """tests/test_paper_claims.py:260: at alpha 20, FedGDA-GT's robust
    loss is no worse than Local SGDA's (stepsize 0.1 / L, 2000 rounds)."""
    _, tp = problems(20.0)
    eta, T = stable_eta(tp), 2000
    xg = _solve(core.make_fedgda_gt_round(tp.loss, K, eta, proj_y=tp.proj_y),
                tp.agent_data, T)
    xl = _solve(core.make_local_sgda_round(tp.loss, K, eta, eta, proj_y=tp.proj_y),
                tp.agent_data, T)
    rl_gt, rl_ls = float(robust_loss(tp, xg)), float(robust_loss(tp, xl))
    assert rl_gt <= rl_ls * 1.001, (rl_gt, rl_ls)


def test_fig2a_gt_matches_centralized_gda_local_sgda_biased():
    """tests/test_paper_claims.py:286: at alpha 1 (eta 5e-3, K 10, 600
    rounds) FedGDA-GT lands on centralized projected GDA's solution (same
    gradient budget), Local SGDA does not, and GT's robust loss is within
    1% of centralized GDA's."""
    _, tp = problems(1.0)
    eta, T = 5e-3, 600
    xg = _solve(core.make_fedgda_gt_round(tp.loss, K, eta, proj_y=tp.proj_y),
                tp.agent_data, T)
    xl = _solve(core.make_local_sgda_round(tp.loss, K, eta, eta, proj_y=tp.proj_y),
                tp.agent_data, T)
    xc = _solve(core.make_local_sgda_round(tp.loss, 1, eta, eta, proj_y=tp.proj_y),
                tp.agent_data, T * K)
    d_gt = float(torch.linalg.norm(xg - xc))
    d_ls = float(torch.linalg.norm(xl - xc))
    assert d_gt < 0.2, d_gt
    assert d_ls > 1.0, d_ls
    assert d_gt < 0.15 * d_ls
    rl_gt, rl_c = float(robust_loss(tp, xg)), float(robust_loss(tp, xc))
    assert abs(rl_gt - rl_c) / rl_c < 0.01
