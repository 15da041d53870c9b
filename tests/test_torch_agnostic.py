"""Agnostic federated learning (paper Appendix A.2) solved with FedGDA-GT
on the port: the three claims of tests/test_agnostic.py on the JAX
builder's data handed over as numpy, and the agnostic and uniform models'
x, lambda and per-agent risks against JAX's (CPU, f64, plain update path;
1e-12 relative: the simplex projection is f64 throughout, 1e-15 measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.problems.agnostic import make_agnostic_problem as jax_agnostic
from repro.problems.agnostic import per_agent_risks as jax_risks
from repro.problems.agnostic import uniform_lambda as jax_uniform
from repro_torch import core
from repro_torch.convert import problem_from_numpy
from repro_torch.core.types import vmap_grad_xy
from repro_torch.fixtures import AGNOSTIC, load_robust_agnostic
from repro_torch.problems import make_agnostic_problem, per_agent_risks, uniform_lambda

pytestmark = pytest.mark.torch

DIM, N, M, SHIFT, K, ETA, T = AGNOSTIC
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(shift):
    jp = jax_agnostic(jax.random.PRNGKey(0), dim=DIM, num_samples=N,
                      num_agents=M, shift=shift)
    data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
    tp = problem_from_numpy("agnostic", data, "cpu")
    assert tp.agent_data["agent_index"].dtype == torch.int32
    return jp, tp


def _solve(tp, proj_y, T):
    rnd = core.make_fedgda_gt_round(tp.loss, K, ETA, proj_y=proj_y)
    x, y = torch.zeros(DIM, dtype=torch.float64), uniform_lambda(M, device="cpu")
    for _ in range(T):
        x, y = rnd(x, y, tp.agent_data)
    return x, y


@pytest.fixture(scope="module")
def shifted():
    """(JAX problem, port problem, {run: (x, lambda)}) at shift 4, T=1500:
    the agnostic model and the uniform one (lambda frozen at uniform)."""
    jp, tp = _problems(SHIFT)
    lam0 = uniform_lambda(M, device="cpu")
    runs = {"agnostic": _solve(tp, tp.proj_y, T),
            "uniform": _solve(tp, lambda y: lam0, T)}
    return jp, tp, runs


def test_lambda_stays_on_simplex_and_converges():
    _, tp = _problems(2.0)
    x, y = _solve(tp, tp.proj_y, 800)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(float(y.sum()), 1.0, rtol=1e-8)
    assert float(y.min()) >= -1e-12


def test_risks_equalize_at_saddle(shifted):
    _, tp, runs = shifted
    ra = per_agent_risks(tp, runs["agnostic"][0]).numpy()
    ru = per_agent_risks(tp, runs["uniform"][0]).numpy()
    assert (ra.max() - ra.min()) <= (ru.max() - ru.min()) + 1e-9


def test_agnostic_beats_uniform_on_worst_agent(shifted):
    _, tp, runs = shifted
    worst_a = float(per_agent_risks(tp, runs["agnostic"][0]).max())
    worst_u = float(per_agent_risks(tp, runs["uniform"][0]).max())
    assert worst_a <= worst_u * 1.01, (worst_a, worst_u)


@pytest.mark.parametrize("run", ["agnostic", "uniform"])
def test_x_lambda_and_risks_match_jax(shifted, run):
    """Against the fixture (JAX's values of this very run) and against
    JAX's per_agent_risks on the port's x."""
    jp, tp, runs = shifted
    x, lam = runs[run]
    fix = load_robust_agnostic()
    risks = per_agent_risks(tp, x)
    for name, got in (("x", x), ("lambda", lam), ("risks", risks)):
        want = fix[f"{run}_{name}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose(
        risks.numpy(), np.asarray(jax_risks(jp, jnp.asarray(x.numpy()))), rtol=RTOL)


def test_rounds_follow_jax_per_round():
    """FedGDA-GT with the simplex projection, 100 rounds, per round."""
    jp, tp = _problems(SHIFT)
    jr = jax.jit(jcore.make_fedgda_gt_round(jp.loss, K, ETA, proj_y=jp.proj_y))
    tr = core.make_fedgda_gt_round(tp.loss, K, ETA, proj_y=tp.proj_y)
    jx, jy = jnp.zeros(DIM), jax_uniform(M)
    tx, ty = torch.zeros(DIM, dtype=torch.float64), uniform_lambda(M, device="cpu")
    for _ in range(100):
        jx, jy = jr(jx, jy, jp.agent_data)
        tx, ty = tr(tx, ty, tp.agent_data)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=1e-14)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=1e-14)


def test_per_agent_grads_index_each_agents_lambda():
    """`y[agent_index]` under vmap: agent i's gradient in y is nonzero in
    entry i only, and equals JAX's."""
    jp, tp = _problems(SHIFT)
    rng = np.random.default_rng(3)
    xs, ys = rng.standard_normal((M, DIM)), rng.random((M, M))
    jg = jax.vmap(jcore.grad_xy(jp.loss))(jnp.asarray(xs), jnp.asarray(ys),
                                          jp.agent_data)
    tg = vmap_grad_xy(tp.loss)(torch.tensor(xs), torch.tensor(ys), tp.agent_data)
    np.testing.assert_allclose(tg.gx.numpy(), np.asarray(jg.gx), rtol=RTOL)
    np.testing.assert_allclose(tg.gy.numpy(), np.asarray(jg.gy), rtol=RTOL)
    off = tg.gy.numpy() * (1 - np.eye(M))
    assert not off.any()


def test_the_ports_builder():
    gen = torch.Generator().manual_seed(0)
    prob = make_agnostic_problem(gen, dim=DIM, num_samples=N, num_agents=M,
                                 shift=SHIFT, device="cpu")
    d = prob.agent_data
    assert d["a"].shape == (M, N, DIM) and d["b"].shape == (M, N)
    assert d["agent_index"].dtype == torch.int32
    assert torch.equal(d["m"], torch.full((M,), float(M), dtype=torch.float64))
    lam = prob.proj_y(torch.tensor([3.0, -1.0, 0.5, 0.2, 0.1], dtype=torch.float64))
    assert abs(float(lam.sum()) - 1.0) < 1e-12 and float(lam.min()) >= 0.0
    assert per_agent_risks(prob, torch.zeros(DIM, dtype=torch.float64)).shape == (M,)


def test_a_dtype_cast_keeps_agent_index_integral():
    jp, _ = _problems(SHIFT)
    data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
    tp = problem_from_numpy("agnostic", data, "cpu", torch.float32)
    assert tp.agent_data["a"].dtype == torch.float32
    assert tp.agent_data["agent_index"].dtype == torch.int32
    assert torch.equal(tp.agent_data["agent_index"], torch.arange(M, dtype=torch.int32))
