"""Robust linear regression — paper Section 5.2, Eq. (14) (port of
`repro/problems/robust_regression.py`).

  f_i(x, y) = (1/n_i) sum_j (x^T (a_ij + y) - b_ij)^2 + 1/2 ||x||^2,
  solved as  min_x max_{||y|| <= 1} (1/m) sum_i f_i(x, y).

Data generation follows the paper: local model x_i* ~ MVN(0, I);
b_ij = x_i*^T a_ij + eps_j, eps ~ N(0,1); a_ij ~ N(mu_i, K_i) with
mu_i ~ N(c_i, I), K_i = i^{-1.3} I, c_i entries ~ N(0, alpha^2).
alpha controls heterogeneity (paper uses alpha in {1, 5, 20}).

The draws come from a `torch.Generator`: the same distribution as the JAX
builder, not the same numbers.  To run on the JAX builder's data, pass
its arrays through `convert.problem_from_numpy("robust_regression", ...)`,
which attaches the same l2-ball projection of y.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..core.projections import l2_ball_proj
from ..core.types import MinimaxProblem
from ..device import DeviceLike, resolve_device


def _loss(x, y, data):
    a, b = data["a"], data["b"]
    pred = (a + y[None, :]) @ x
    return torch.mean((pred - b) ** 2) + 0.5 * torch.sum(x**2)


def make_robust_regression_problem(
    generator: torch.Generator,
    dim: int = 50,
    num_samples: int = 200,
    num_agents: int = 20,
    alpha: float = 5.0,
    noise_radius: float = 1.0,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
) -> MinimaxProblem:
    """Draw the Sec 5.2 problem on `generator`'s device and place its data
    a [m, n, d], b [m, n] on `device` (default CUDA; raises without CUDA
    unless a device is given)."""
    device = resolve_device(device)
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=gdev)

    x_star = normal(num_agents, dim)
    c = alpha * normal(num_agents, dim)
    mu = c + normal(num_agents, dim)
    # sqrt(i^-1.3)
    cov_scale = torch.arange(1, num_agents + 1, dtype=dtype, device=gdev) ** (-0.65)
    a = normal(num_agents, num_samples, dim)
    a.mul_(cov_scale[:, None, None]).add_(mu[:, None, :])
    eps = normal(num_agents, num_samples)
    a, x_star, eps = a.to(device), x_star.to(device), eps.to(device)
    b = torch.einsum("mnd,md->mn", a, x_star) + eps
    return MinimaxProblem(
        loss=_loss,
        agent_data={"a": a, "b": b},
        num_agents=num_agents,
        proj_y=l2_ball_proj(noise_radius),
    )


def robust_loss(
    problem: MinimaxProblem,
    x: torch.Tensor,
    num_ascent_steps: int = 2000,
    eta: float = 1e-3,
    noise_radius: float = 1.0,
) -> torch.Tensor:
    """Worst-case robust loss  max_{||y||<=1} sum_i f_i(x, y)  (the paper's
    metric; it sums rather than averages over agents).  Solved by projected
    gradient ascent from y0 = 0, step by step as the reference: Eq. (14) is
    convex in y, so the ball has several boundary maxima and the path from
    y0 decides which one the ascent reaches."""
    proj = l2_ball_proj(noise_radius)

    vloss = vmap(problem.loss, in_dims=(None, None, 0))

    def total(y):
        return torch.sum(vloss(x, y, problem.agent_data))

    def g(y):
        # the values of torch.func.grad(total), at a third of its host
        # time (as `core.types.vmap_grad_xy`)
        with torch.enable_grad():
            yr = y.detach().requires_grad_()
            return torch.autograd.grad(total(yr), yr)[0]

    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for _ in range(num_ascent_steps):
        y = proj(y + eta * g(y))
    return total(y)
