"""Property tests (hypothesis) of tests/test_properties.py in the port, at
the reference's own settings and tolerances (ROADMAP Queue 1 item 14):

  * `TestProjections`: the l2 ball's membership, idempotence and
    non-expansiveness, the box's and the simplex's membership and
    idempotence;
  * `TestFedGdaGtStructure`: the tracking corrections average to zero;
    one agent's round is K centralized GDA steps; homogeneous agents move
    in lockstep (a round is K GDA steps); Local SGDA at K=1 is one GDA
    step; each on the reference's problems (JAX's generator with the drawn
    seed, handed over as numpy);
  * `TestCompressionInvariants::test_sent_plus_residual_is_raw_correction`
    (the drawn corrections are JAX's normals, handed over as numpy);
  * `TestCommAccounting::test_orderings`;
  * `TestNoiseModels`: the Gaussian and minibatch oracles are unbiased, the
    Gaussian one with its configured sigma (the port's seeded keys).
"""
import jax
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis",
    reason="property tests need the optional `hypothesis` extra; "
    "the rest of tier-1 runs without it",
)
from hypothesis import given, settings, strategies as st

from repro.problems import make_quadratic_problem
from repro_torch import prng
from repro_torch.convert import problem_from_numpy
from repro_torch.core import (
    box_proj,
    communication_bytes_per_round,
    grad_xy,
    l2_ball_proj,
    make_fedgda_gt_round,
    make_gda_step,
    make_local_sgda_round,
    simplex_proj,
    tree_leaves,
)
from repro_torch.core.types import vmap_grad_xy
from repro_torch.fed import QuantizedGT

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

SETTINGS = dict(max_examples=25, deadline=None)

vec = st.integers(min_value=1, max_value=24).flatmap(
    lambda d: st.lists(
        st.floats(-1e3, 1e3, allow_nan=False, allow_subnormal=False, width=32),
        min_size=d,
        max_size=d,
    )
)


def _t(v, dtype):
    return torch.tensor(v, dtype=dtype)


# ------------------------------------------------------------- projections
class TestProjections:
    @given(v=vec, radius=st.floats(0.1, 10.0))
    @settings(**SETTINGS)
    def test_l2_ball_membership_and_idempotence(self, v, radius):
        p = l2_ball_proj(radius)
        y = p(_t(v, torch.float32))
        assert float(torch.linalg.norm(y)) <= radius * (1 + 1e-5)
        np.testing.assert_allclose(p(y).numpy(), y.numpy(), rtol=1e-6)

    @given(v=vec, w=vec, radius=st.floats(0.1, 10.0))
    @settings(**SETTINGS)
    def test_l2_ball_nonexpansive(self, v, w, radius):
        d = min(len(v), len(w))
        x, y = _t(v[:d], torch.float32), _t(w[:d], torch.float32)
        p = l2_ball_proj(radius)
        dp = float(torch.linalg.norm(p(x) - p(y)))
        d0 = float(torch.linalg.norm(x - y))
        assert dp <= d0 * (1 + 1e-5) + 1e-6

    @given(v=vec, lo=st.floats(-5, 0), hi=st.floats(0.1, 5))
    @settings(**SETTINGS)
    def test_box_membership_idempotence(self, v, lo, hi):
        p = box_proj(lo, hi)
        y = p(_t(v, torch.float32))
        assert float(torch.min(y)) >= lo - 1e-6
        assert float(torch.max(y)) <= hi + 1e-6
        np.testing.assert_allclose(p(y).numpy(), y.numpy())

    @given(v=vec)
    @settings(**SETTINGS)
    def test_simplex_membership(self, v):
        p = simplex_proj()
        y = p(_t(v, torch.float64))
        assert float(torch.min(y)) >= -1e-9
        np.testing.assert_allclose(float(torch.sum(y)), 1.0, rtol=1e-6)
        # idempotence
        np.testing.assert_allclose(p(y).numpy(), y.numpy(), rtol=1e-6, atol=1e-9)


# --------------------------------------------------- FedGDA-GT invariants
def _quadratic(seed, dim=6, m=4):
    """The reference's problem for `seed` (JAX's generator), on the CPU."""
    jp = make_quadratic_problem(jax.random.PRNGKey(seed), dim=dim, num_samples=20,
                                num_agents=m)
    return problem_from_numpy("quadratic",
                              {k: np.asarray(v) for k, v in jp.agent_data.items()},
                              "cpu")


def _zeros(d):
    return torch.zeros(d, dtype=torch.float64)


class TestFedGdaGtStructure:
    @given(seed=st.integers(0, 10_000))
    @settings(**SETTINGS)
    def test_correction_terms_average_to_zero(self, seed):
        """sum_i (gbar - g_i) = 0: the defining property of gradient
        tracking, the average local step direction is the global one."""
        prob = _quadratic(seed)
        g = torch.func.vmap(grad_xy(prob.loss), in_dims=(None, None, 0))(
            torch.ones(6, dtype=torch.float64), torch.ones(6, dtype=torch.float64),
            prob.agent_data)
        for leaf in tree_leaves(tuple(g)):
            corr = torch.mean(leaf, dim=0)[None] - leaf  # c_i per agent
            np.testing.assert_allclose(torch.mean(corr, dim=0).numpy(),
                                       np.zeros(leaf.shape[1:]), atol=1e-8)

    @given(seed=st.integers(0, 10_000), K=st.integers(1, 6))
    @settings(max_examples=10, deadline=None)
    def test_single_agent_reduces_to_k_gda_steps(self, seed, K):
        prob = _quadratic(seed, dim=5, m=1)
        eta = 1e-3
        rnd = make_fedgda_gt_round(prob.loss, K, eta)
        step = make_gda_step(prob.loss, eta, eta)
        x0 = _zeros(5)
        xg, yg = rnd(x0, x0, prob.agent_data)
        xc, yc = x0, x0
        for _ in range(K):
            xc, yc = step(xc, yc, prob.agent_data)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-8)
        np.testing.assert_allclose(yg.numpy(), yc.numpy(), rtol=1e-8)

    @given(seed=st.integers(0, 10_000), m=st.integers(2, 5))
    @settings(max_examples=10, deadline=None)
    def test_homogeneous_agents_lockstep(self, seed, m):
        """Identical local objectives: the K local trajectories coincide, so
        one FedGDA-GT round == K centralized GDA steps (Appendix D.4)."""
        base = _quadratic(seed, dim=5, m=1)
        hom = {k: u.expand((m,) + tuple(u.shape[1:])) for k, u in
               base.agent_data.items()}
        eta, K = 1e-3, 4
        rnd = make_fedgda_gt_round(base.loss, K, eta)
        step = make_gda_step(base.loss, eta, eta)
        x0 = _zeros(5)
        xg, yg = rnd(x0, x0, hom)
        xc, yc = x0, x0
        for _ in range(K):
            xc, yc = step(xc, yc, base.agent_data)
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), rtol=1e-7)

    @given(seed=st.integers(0, 10_000))
    @settings(max_examples=10, deadline=None)
    def test_local_sgda_k1_equals_gda(self, seed):
        prob = _quadratic(seed)
        eta = 1e-3
        rnd = make_local_sgda_round(prob.loss, 1, eta, eta)
        step = make_gda_step(prob.loss, eta, eta)
        x0 = _zeros(6)
        xr, yr = rnd(x0, x0, prob.agent_data)
        xs, ys = step(x0, x0, prob.agent_data)
        np.testing.assert_allclose(xr.numpy(), xs.numpy(), rtol=1e-9)
        np.testing.assert_allclose(yr.numpy(), ys.numpy(), rtol=1e-9)


# ------------------------------------------- compression invariants
def _correction_trees(seed, m, d1, d2):
    """The reference's drawn corrections (JAX's normals), as tensors."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    cx = {"a": t(jax.random.normal(k1, (m, d1))),
          "b": t(jax.random.normal(k2, (m, 2, d2)))}
    cy = {"d": t(jax.random.normal(k3, (m, d2)))}
    return cx, cy


def _x0(tree):
    return {k: u[0] for k, u in tree.items()}


class TestCompressionInvariants:
    @given(
        seed=st.integers(0, 10_000),
        ratio=st.floats(0.05, 0.9),
        bits=st.sampled_from([4, 8, 32]),
        mode=st.sampled_from(["topk", "randk"]),
    )
    @settings(max_examples=15, deadline=None)
    def test_sent_plus_residual_is_raw_correction(self, seed, ratio, bits, mode):
        """With error feedback, what compression drops is exactly what
        lands in the feedback buffer: chat + e' == c + e (here e = 0)."""
        m = 3
        cx, cy = _correction_trees(seed, m, 9, 5)
        s = QuantizedGT(bits=bits, ratio=ratio, mode=mode, seed=seed,
                        error_feedback=True)
        state = s.init_state(_x0(cx), _x0(cy), m)
        cx2, cy2, state2 = s.transform_correction(cx, cy, state)
        pairs = [(cx2, state2["ex"], cx), (cy2, state2["ey"], cy)]
        for sent_t, resid_t, raw_t in pairs:
            for k in raw_t:
                np.testing.assert_allclose((sent_t[k] + resid_t[k]).numpy(),
                                           raw_t[k].numpy(), rtol=0, atol=1e-10)


# ---------------------------------------------------- comm accounting
class TestCommAccounting:
    @given(p=st.integers(1, 4096), q=st.integers(1, 256), K=st.integers(1, 64))
    @settings(**SETTINGS)
    def test_orderings(self, p, q, K):
        x = torch.zeros((p,), dtype=torch.float32)
        y = torch.zeros((q,), dtype=torch.float32)
        ls = communication_bytes_per_round(x, y, "local_sgda", K)
        gt = communication_bytes_per_round(x, y, "fedgda_gt", K)
        gda = communication_bytes_per_round(x, y, "gda", K)
        assert 0 < ls < gt  # GT pays extra for the tracked gradient
        assert gt == 2 * ls  # exactly 2x (paper's cost model)
        if K > 2:
            assert gda > gt  # sync GDA communicates every inner step


# ---------------------------------------------- stochastic noise models
class TestNoiseModels:
    """fed.noise: unbiasedness, with the configured spread for the
    Gaussian oracle.  The Monte Carlo replicas are the agent axis of one
    draw ([n_mc, 2] keys)."""

    @given(
        seed=st.integers(0, 2**16),
        sigma=st.floats(0.05, 0.5, allow_nan=False),
    )
    @settings(max_examples=10, deadline=None)
    def test_gaussian_noise_unbiased_with_configured_sigma(self, seed, sigma):
        from repro_torch.fed.noise import GaussianNoise

        d, n_mc = 4, 2048
        loss = lambda x, y, data: 0.5 * x @ x - 0.5 * y @ y
        x = torch.arange(1.0, d + 1.0, dtype=torch.float64)
        y = -x
        g0 = grad_xy(loss)(x, y, {})
        keys = prng.split(prng.PRNGKey(seed), n_mc)
        xs, ys = x.expand(n_mc, d), y.expand(n_mc, d)
        gs = GaussianNoise(sigma=sigma).grad(vmap_grad_xy(loss), keys, xs, ys, {})
        tol = 8.0 * sigma / np.sqrt(n_mc)
        for u, u0 in ((gs.gx, g0.gx), (gs.gy, g0.gy)):
            np.testing.assert_allclose(torch.mean(u, dim=0).numpy(), u0.numpy(),
                                       atol=tol)
            # the reference's jnp.std: the population (ddof 0) deviation
            std = float(torch.std(u, dim=0, correction=0).mean())
            assert abs(std - sigma) < 0.2 * sigma

    @given(seed=st.integers(0, 2**16))
    @settings(max_examples=10, deadline=None)
    def test_minibatch_noise_unbiased_for_mean_losses(self, seed):
        from repro_torch.fed.noise import MinibatchNoise

        n, d, n_mc = 32, 3, 2048
        a = torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.PRNGKey(42), (n, d))).copy())
        # grad_x of mean_i <a_i, x> is mean(a) regardless of x
        loss = lambda x, y, data: torch.mean(data["a"] @ x) - 0.5 * y @ y
        x, y = torch.ones(d, dtype=a.dtype), torch.ones(d, dtype=a.dtype)
        keys = prng.split(prng.PRNGKey(seed), n_mc)
        data = {"a": a.expand(n_mc, n, d)}
        gs = MinibatchNoise(fraction=0.25).grad(
            vmap_grad_xy(loss), keys, x.expand(n_mc, d), y.expand(n_mc, d), data)
        # std of an 8-sample mean of unit normals ~ 0.35; 2048 MC reps
        tol = 8.0 * float(torch.std(a, correction=0)) / np.sqrt(8) / np.sqrt(n_mc)
        np.testing.assert_allclose(torch.mean(gs.gx, dim=0).numpy(),
                                   torch.mean(a, dim=0).numpy(), atol=tol)
        # y is untouched by subsampling (no sample axis in its grad)
        np.testing.assert_array_equal(gs.gy[0].numpy(),
                                      grad_xy(loss)(x, y, {"a": a}).gy.numpy())
