"""tests/test_fused_k0.py in the port: the fused k=0 anchor step of
`core.make_fedgda_gt_round` (every agent moves by gbar, the k=0 gradient
not recomputed) against verbatim Algorithm 2 (K inner steps, each
evaluating the local gradient, the redundant k=0 evaluation included), at
K 1, 2 and 5 over 5 rounds, to the reference's tolerance (rtol 1e-12,
atol 0), on the reference's problem (JAX's `make_quadratic_problem` with
PRNGKey(0), handed over as numpy).  The only difference is rounding: the
literal form computes g + (gbar - g) where the fused form uses gbar.  The
port's fused round is also held to JAX's fused round to the same
tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_fedgda_gt_round as jax_fedgda_gt_round
from repro.problems import make_quadratic_problem
from repro_torch.convert import problem_from_numpy
from repro_torch.core import (
    make_fedgda_gt_round,
    tree_broadcast_agents,
    tree_map,
    tree_mean_over_agents,
)
from repro_torch.core.types import vmap_grad_xy

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

DIM, ETA, ROUNDS = 10, 1e-4, 5
RTOL = 1e-12  # the reference's (tests/test_fused_k0.py), atol 0


def _literal_algorithm2_round(loss, K, eta):
    """Verbatim Algorithm 2 in torch: K inner steps, each evaluating the
    local gradient, including the redundant k=0 evaluation at the anchor."""
    vgrad = vmap_grad_xy(loss)

    def rnd(x, y, agent_data):
        m = next(iter(agent_data.values())).shape[0]
        xs = tree_broadcast_agents(x, m)
        ys = tree_broadcast_agents(y, m)
        g0 = vgrad(xs, ys, agent_data)
        gbar_x = tree_map(lambda u: torch.mean(u, dim=0), g0.gx)
        gbar_y = tree_map(lambda u: torch.mean(u, dim=0), g0.gy)
        cx = tree_map(lambda gb, gi: gb[None] - gi, gbar_x, g0.gx)
        cy = tree_map(lambda gb, gi: gb[None] - gi, gbar_y, g0.gy)
        for _ in range(K):
            g = vgrad(xs, ys, agent_data)
            xs = tree_map(lambda u, gv, cv: u - eta * (gv + cv), xs, g.gx, cx)
            ys = tree_map(lambda u, gv, cv: u + eta * (gv + cv), ys, g.gy, cy)
        return tree_mean_over_agents(xs), tree_mean_over_agents(ys)

    return rnd


@pytest.fixture(scope="module")
def probs():
    jp = make_quadratic_problem(jax.random.PRNGKey(0), dim=DIM, num_samples=40,
                                num_agents=6)
    tp = problem_from_numpy("quadratic",
                            {k: np.asarray(v) for k, v in jp.agent_data.items()}, "cpu")
    return jp, tp


def _x0():
    return torch.ones(DIM, dtype=torch.float64), -torch.ones(DIM, dtype=torch.float64)


@pytest.mark.parametrize("K", [1, 2, 5])
def test_fused_round_bitwise_equals_literal_algorithm2(probs, K):
    _, tp = probs
    fused = make_fedgda_gt_round(tp.loss, K, ETA)
    literal = _literal_algorithm2_round(tp.loss, K, ETA)
    x, y = _x0()
    for _ in range(ROUNDS):  # several rounds so divergence would compound
        xf, yf = fused(x, y, tp.agent_data)
        xl, yl = literal(x, y, tp.agent_data)
        np.testing.assert_allclose(xf.numpy(), xl.numpy(), rtol=RTOL, atol=0)
        np.testing.assert_allclose(yf.numpy(), yl.numpy(), rtol=RTOL, atol=0)
        x, y = xf, yf


@pytest.mark.parametrize("K", [1, 2, 5])
def test_fused_round_matches_jax_fused_round(probs, K):
    jp, tp = probs
    fused = make_fedgda_gt_round(tp.loss, K, ETA)
    jfused = jax.jit(jax_fedgda_gt_round(jp.loss, K, ETA))
    x, y = _x0()
    jx, jy = jnp.ones(DIM), -jnp.ones(DIM)
    for t in range(ROUNDS):
        x, y = fused(x, y, tp.agent_data)
        jx, jy = jfused(jx, jy, jp.agent_data)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL, atol=0,
                                   err_msg=f"x round {t}")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=0,
                                   err_msg=f"y round {t}")
