"""Heavy-ball momentum in the port (`optim/momentum.py`, the engine's
momentum local steps) against the JAX package: `TestServerMomentum` of
tests/test_optim.py ported, the server-momentum round per round against
JAX's, and the Local SGDA+ momentum round (no noise) per round."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro.core import make_round as jmake_round
from repro.optim import heavy_ball as jheavy_ball
from repro.optim import make_momentum_fedgda_gt_round as jmomentum_round
from repro.problems import make_quadratic_problem
from repro_torch import core, fed, optim
from repro_torch.convert import problem_from_numpy
from repro_torch.problems import quadratic_minimax_point

from test_torch_parity import one_torch_thread  # noqa: F401

# the small draws and rounds are bound by per-op host overhead; intra-op
# threads only contend with the other test workers
pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

#: per round against JAX, relative (max-norm): the engines sum the matvecs
#: in different orders (measured below 1e-13 over 50 rounds)
ROUND_RTOL = 1e-11


def _problem(dim, n, m):
    jp = make_quadratic_problem(jax.random.PRNGKey(0), dim=dim, num_samples=n,
                                num_agents=m)
    tp = problem_from_numpy("quadratic", jax.tree.map(np.asarray, jp.agent_data), "cpu")
    return jp, tp


def _rel(want, got):
    want = np.asarray(want)
    return float(np.max(np.abs(want - got.numpy())) / np.max(np.abs(want)))


class TestServerMomentum:
    def test_momentum_converges_and_accelerates(self):
        _, prob = _problem(12, 60, 6)
        xs, ys = quadratic_minimax_point(prob)
        eta, K, T = 5e-5, 10, 400
        base = core.make_fedgda_gt_round(prob.loss, K, eta)
        mom = optim.make_momentum_fedgda_gt_round(prob.loss, K, eta, beta=0.8)
        x0 = torch.zeros(12, dtype=torch.float64)
        xb, yb = x0, x0
        state = (x0, x0, mom.init_velocity(x0, x0))
        for _ in range(T):
            xb, yb = base(xb, yb, prob.agent_data)
            state = mom(state, prob.agent_data)
        xm, ym, _ = state
        gap_base = float(core.tree_sq_dist(xb, xs) + core.tree_sq_dist(yb, ys))
        gap_mom = float(core.tree_sq_dist(xm, xs) + core.tree_sq_dist(ym, ys))
        assert np.isfinite(gap_mom)
        assert gap_mom <= gap_base * 1.05, (gap_mom, gap_base)

    def test_velocity_zero_init_matches_first_round_direction(self):
        _, prob = _problem(6, 30, 3)
        eta, K = 1e-4, 5
        base = core.make_fedgda_gt_round(prob.loss, K, eta)
        mom = optim.make_momentum_fedgda_gt_round(prob.loss, K, eta, beta=0.9)
        x0 = torch.ones(6, dtype=torch.float64)
        xb, yb = base(x0, x0, prob.agent_data)
        x1, y1, _ = mom((x0, x0, mom.init_velocity(x0, x0)), prob.agent_data)
        np.testing.assert_allclose(x1.numpy(), xb.numpy(), rtol=1e-10)
        np.testing.assert_allclose(y1.numpy(), yb.numpy(), rtol=1e-10)


def test_heavy_ball_equals_jax_bitwise():
    rng = np.random.default_rng(0)
    v = {"a": rng.standard_normal(5), "b": rng.standard_normal((2, 3))}
    g = {"a": rng.standard_normal(5), "b": rng.standard_normal((2, 3))}
    want = jheavy_ball(jax.tree.map(jnp.asarray, v), jax.tree.map(jnp.asarray, g), 0.9)
    got = optim.heavy_ball({k: torch.tensor(u) for k, u in v.items()},
                           {k: torch.tensor(u) for k, u in g.items()}, 0.9)
    for k in v:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy())


def test_server_momentum_round_against_jax_per_round():
    jp, tp = _problem(12, 60, 6)
    eta, K = 5e-5, 10
    jr = jax.jit(jmomentum_round(jp.loss, K, eta, beta=0.8))
    tr = optim.make_momentum_fedgda_gt_round(tp.loss, K, eta, beta=0.8)
    jx = jnp.zeros(12)
    tx = torch.zeros(12, dtype=torch.float64)
    js = (jx, jx, jmomentum_round(jp.loss, K, eta).init_velocity(jx, jx))
    ts = (tx, tx, tr.init_velocity(tx, tx))
    for t in range(50):
        js = jr(js, jp.agent_data)
        ts = tr(ts, tp.agent_data)
        for w, g in ((js[0], ts[0]), (js[1], ts[1]), (js[2][0], ts[2][0])):
            assert _rel(w, g) <= ROUND_RTOL, t


@pytest.mark.parametrize("K", [1, 4])
def test_local_sgda_plus_momentum_round_against_jax(K):
    jp, tp = _problem(10, 40, 6)
    jr = jax.jit(jmake_round(jp.loss, jfed.LocalSGDAPlus(momentum=0.9), K, 1e-3, 2e-3))
    tr = core.make_round(tp.loss, fed.LocalSGDAPlus(momentum=0.9), K, 1e-3, 2e-3)
    jx, jy = jnp.ones(10), -jnp.ones(10)
    tx, ty = torch.ones(10, dtype=torch.float64), -torch.ones(10, dtype=torch.float64)
    for t in range(30):
        jx, jy = jr(jx, jy, jp.agent_data)
        tx, ty = tr(tx, ty, tp.agent_data)
        assert _rel(jx, tx) <= ROUND_RTOL and _rel(jy, ty) <= ROUND_RTOL, t
