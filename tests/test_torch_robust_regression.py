"""Sec 5.2 robust regression (Eq. 14) on the port against the JAX package,
on the JAX builder's data handed over as numpy (CPU, f64, plain update
path).

  * `_loss` and its per-agent gradients within 1e-12 relative.
  * FedGDA-GT, Local SGDA and centralized projected GDA per round against
    JAX for 100 rounds.  Where y reaches the unit ball's boundary the
    reference's `l2_ball_proj` scales by a norm summed in f32, in an order
    XLA and torch choose differently (~6e-8 of the scale per projection):
    those runs are held to BALL_RTOL (1.81e-7 measured), and the same runs
    with an f64 norm on both sides agree to 1e-12, so that f32 norm is
    the whole difference.  Runs whose y stays inside the ball (alpha 20)
    are f64 throughout and held to 1e-12.
  * `robust_loss` against JAX's on the same x (7.3e-8 measured: 2000
    ascent steps through the same f32 norm).

The paper's claims on this problem (tests/test_paper_claims.py:260 and
:286) are in tests/test_torch_robust_claims.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.problems import make_robust_regression_problem as jax_robust
from repro.problems import robust_loss as jax_robust_loss
from repro_torch import core
from repro_torch.convert import problem_from_numpy
from repro_torch.core.types import vmap_grad_xy
from repro_torch.fixtures import ROBUST_RUNS, load_robust_agnostic, robust_key
from repro_torch.problems import make_robust_regression_problem, robust_loss

pytestmark = pytest.mark.torch

DIM, N, M, K = 20, 100, 10, 10
#: relative tolerance of iterates where y reaches the unit ball (see above)
BALL_RTOL = 5e-7
F64_RTOL = 1e-12
#: robust losses: 2000 ascent steps, each through the f32 norm
LOSS_RTOL = 3e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small problems are bound by per-op host overhead; extra
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PROBLEMS = {}


def problems(alpha):
    """(JAX problem, the port's problem on its data) at Fig 2's size."""
    if alpha not in _PROBLEMS:
        jp = jax_robust(jax.random.PRNGKey(0), dim=DIM, num_samples=N,
                        num_agents=M, alpha=alpha)
        data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
        _PROBLEMS[alpha] = jp, problem_from_numpy("robust_regression", data, "cpu")
    return _PROBLEMS[alpha]


def stable_eta(tp) -> float:
    a = tp.agent_data["a"]
    H = 2 * torch.einsum("mnd,mne->de", a, a) / (a.shape[0] * a.shape[1])
    eye = torch.eye(a.shape[-1], dtype=a.dtype)
    return 0.1 / float(torch.linalg.eigvalsh(H + eye)[-1])


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-300))


@pytest.mark.parametrize("alpha", [1.0, 20.0])
def test_loss_and_per_agent_grads_against_jax(alpha):
    jp, tp = problems(alpha)
    rng = np.random.default_rng(int(alpha))
    xs, ys = rng.standard_normal((M, DIM)), 0.3 * rng.standard_normal((M, DIM))
    want = jax.vmap(jp.loss)(jnp.asarray(xs), jnp.asarray(ys), jp.agent_data)
    got = torch.vmap(tp.loss)(torch.tensor(xs), torch.tensor(ys), tp.agent_data)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    jg = jax.vmap(jcore.grad_xy(jp.loss))(jnp.asarray(xs), jnp.asarray(ys),
                                          jp.agent_data)
    tg = vmap_grad_xy(tp.loss)(torch.tensor(xs), torch.tensor(ys), tp.agent_data)
    np.testing.assert_allclose(tg.gx.numpy(), np.asarray(jg.gx), rtol=1e-12)
    np.testing.assert_allclose(tg.gy.numpy(), np.asarray(jg.gy), rtol=1e-12)


def test_the_kind_brings_the_unit_ball():
    jp, tp = problems(1.0)
    v = np.arange(1.0, DIM + 1.0)
    got, want = tp.proj_y(torch.tensor(v)), jp.proj_y(jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.0 ** -22)
    assert abs(float(got.norm()) - 1.0) < 1e-6
    inside = torch.tensor(v / (2 * np.linalg.norm(v)))
    assert torch.equal(tp.proj_y(inside), inside)


def _rounds(jp, tp, run, eta, jproj=None, tproj=None):
    jproj = jp.proj_y if jproj is None else jproj
    tproj = tp.proj_y if tproj is None else tproj
    k = 1 if run == "c" else K
    if run == "gt":
        return (jcore.make_fedgda_gt_round(jp.loss, k, eta, proj_y=jproj),
                core.make_fedgda_gt_round(tp.loss, k, eta, proj_y=tproj))
    return (jcore.make_local_sgda_round(jp.loss, k, eta, eta, proj_y=jproj),
            core.make_local_sgda_round(tp.loss, k, eta, eta, proj_y=tproj))


def _per_round_err(jr, tr, jp, tp, rounds=100):
    jr = jax.jit(jr)
    jx = jy = jnp.zeros(DIM)
    tx = ty = torch.zeros(DIM, dtype=torch.float64)
    err = 0.0
    for _ in range(rounds):
        jx, jy = jr(jx, jy, jp.agent_data)
        tx, ty = tr(tx, ty, tp.agent_data)
        err = max(err, rel(tx, jx), rel(ty, jy))
    return err, float(jnp.linalg.norm(jy))


@pytest.mark.parametrize("run", ROBUST_RUNS)
@pytest.mark.parametrize("alpha", [1.0, 20.0])
def test_rounds_follow_jax_per_round(alpha, run):
    """Fig 2's stepsize (0.1 / L, JAX's value from the fixture), x0 = y0 =
    0, 100 rounds, x and y compared every round."""
    jp, tp = problems(alpha)
    eta = float(load_robust_agnostic()[f"{robust_key(alpha)}_eta"])
    err, y_norm = _per_round_err(*_rounds(jp, tp, run, eta), jp, tp)
    on_ball = y_norm > 1.0 - 1e-6  # the f32 scale lands within 1e-7 of 1
    assert err <= (BALL_RTOL if on_ball else F64_RTOL), (err, y_norm)
    if alpha == 20.0:  # y stays inside the ball: f64 throughout
        assert not on_ball


def _f64_norm_projections():
    def jproj(y):
        n = jnp.sqrt(jnp.maximum(jnp.sum(y**2), 1e-30))
        return y * jnp.minimum(1.0, 1.0 / n)

    def tproj(y):
        n = torch.sqrt(torch.clamp(torch.sum(y**2), min=1e-30))
        return y * torch.clamp(1.0 / n, max=1.0)

    return jproj, tproj


@pytest.mark.parametrize("run", ["gt", "ls"])
def test_with_an_f64_norm_the_rounds_agree_to_1e_12(run):
    """The BALL_RTOL runs again, with the unit ball's norm in f64 on both
    sides: the f32 norm of the reference is the whole difference."""
    jp, tp = problems(1.0)
    jproj, tproj = _f64_norm_projections()
    eta = float(load_robust_agnostic()["robust1_eta"])
    err, y_norm = _per_round_err(*_rounds(jp, tp, run, eta, jproj, tproj), jp, tp)
    assert y_norm > 1.0 - 1e-6  # the ball binds
    assert err <= F64_RTOL, err


@pytest.mark.parametrize("alpha", [1.0, 20.0])
def test_robust_loss_against_jax(alpha):
    """On the same x (JAX's final FedGDA-GT iterate of Fig 2), against
    JAX's robust_loss and the fixture's stored value."""
    jp, tp = problems(alpha)
    pre = robust_key(alpha)
    fix = load_robust_agnostic()
    x = fix[f"{pre}_gt_x"][-1]
    got = float(robust_loss(tp, torch.tensor(x)))
    want = float(jax_robust_loss(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, float(fix[f"{pre}_gt_robust_loss"]),
                               rtol=LOSS_RTOL)


def test_the_ports_builder_draws_the_papers_distribution():
    """The port's own draws (a torch.Generator): the shapes, the unit
    ball, and a_ij's spread around its agent's mean, K_i = i^-1.3 I."""
    gen = torch.Generator().manual_seed(0)
    prob = make_robust_regression_problem(gen, dim=8, num_samples=4000,
                                          num_agents=4, alpha=5.0, device="cpu")
    a, b = prob.agent_data["a"], prob.agent_data["b"]
    assert a.shape == (4, 4000, 8) and b.shape == (4, 4000)
    assert a.dtype == b.dtype == torch.float64
    std = (a - a.mean(dim=1, keepdim=True)).std(dim=(1, 2))
    want = torch.arange(1, 5, dtype=torch.float64) ** -0.65
    np.testing.assert_allclose(std.numpy(), want.numpy(), rtol=0.05)
    big = torch.full((8,), 3.0, dtype=torch.float64)
    assert abs(float(prob.proj_y(big).norm()) - 1.0) < 1e-6
