"""The paper's tradeoff, both branches, on the port: constant-stepsize
Local SGDA stalls at the Proposition-1 bias floor, a diminishing schedule
[25, 26] converges past it (slowly), FedGDA-GT gets exactness AND speed at
constant eta (tests/test_scheduled_sgda.py's claim on the JAX builder's
data; CPU, f64).  It is taken at 2000 rounds of the reference's 4000,
which keeps this file near 50 s: in JAX's run every inequality already
holds there by orders of magnitude (diminishing / constant gap 2.7e-3 at
round 2000, 7.2e-4 at 4000, against 0.5; FedGDA-GT / diminishing 1.3e-20
and 5.0e-20, against 1e-3)."""
import numpy as np
import pytest
import torch

from repro.problems import make_quadratic_problem as jax_quadratic
from repro_torch import core
from repro_torch.convert import problem_from_numpy
from repro_torch.optim import diminishing_schedule
from repro_torch.problems import quadratic_minimax_point

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_diminishing_schedule_breaks_the_bias_floor(rng):
    jp = jax_quadratic(rng, dim=12, num_samples=60, num_agents=6)
    data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
    prob = problem_from_numpy("quadratic", data, "cpu")
    xs, ys = quadratic_minimax_point(prob)
    K, eta0, T = 10, 2e-4, 2000

    const = core.make_local_sgda_round(prob.loss, K, eta0, eta0)
    sched_round = core.make_scheduled_local_sgda_round(prob.loss, K)
    sched = diminishing_schedule(eta0, decay=0.01)
    gt = core.make_fedgda_gt_round(prob.loss, K, eta0)

    x0 = torch.zeros(12, dtype=torch.float64)
    xc, yc = x0, x0
    xd, yd = x0, x0
    xg, yg = x0, x0
    for t in range(T):
        xc, yc = const(xc, yc, prob.agent_data)
        xd, yd = sched_round(xd, yd, prob.agent_data, sched(t))
        xg, yg = gt(xg, yg, prob.agent_data)

    def gap(x, y):
        return float(core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys))

    g_const, g_dim, g_gt = gap(xc, yc), gap(xd, yd), gap(xg, yg)
    assert g_const > 1e-8, g_const
    assert g_dim < g_const * 0.5, (g_dim, g_const)
    assert g_gt < g_dim * 1e-3, (g_gt, g_dim)
