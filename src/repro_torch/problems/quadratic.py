"""Uncoupled quadratic minimax game — paper Section 5.1, Eq. (13)
(port of `repro/problems/quadratic.py`).

  f_i(x, y) = 1/2 x^T A_i^T A_i x - 1/2 y^T A_i^T A_i y + (A_i^T b_i)^T (2x - y)

Data generation follows the paper:
  [A_i]_kl ~ N(0, (0.5 i)^-2);  theta_i ~ N(mu_i, I);  mu_i entries ~ N(alpha, 1)
  with alpha ~ N(0, 100);  b_i = A_i theta_i + eps_i,  eps_i ~ N(0, 0.25 I).
Defaults: d = 50, n_i = 500, m = 20 agents.

The draws come from a `torch.Generator`, so they are the port's own: the
same distribution as the JAX builder, not the same numbers.  To run on
the JAX builder's data, pass its arrays through `convert.problem_from_numpy`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.types import MinimaxProblem
from ..device import DeviceLike, resolve_device


def _loss(x, y, data):
    G, Ab = data["G"], data["Ab"]
    return (
        0.5 * x @ G @ x
        - 0.5 * y @ G @ y
        + Ab @ (2.0 * x - y)
    )


def make_quadratic_problem(
    generator: torch.Generator,
    dim: int = 50,
    num_samples: int = 500,
    num_agents: int = 20,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
) -> MinimaxProblem:
    """Draw the Sec 5.1 problem on `generator`'s device and place its
    sufficient statistics G_i = A_i^T A_i, Ab_i = A_i^T b_i on `device`
    (default CUDA; raises without CUDA unless a device is given)."""
    device = resolve_device(device)
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=gdev)

    alpha = 10.0 * normal()  # N(0, 100)
    mu = alpha + normal(num_agents, dim)
    theta = mu + normal(num_agents, dim)
    std = 2.0 / torch.arange(1, num_agents + 1, dtype=dtype, device=gdev)
    A = normal(num_agents, num_samples, dim) * std[:, None, None]
    eps = 0.5 * normal(num_agents, num_samples)
    A, theta, eps = A.to(device), theta.to(device), eps.to(device)
    b = torch.einsum("mnd,md->mn", A, theta) + eps
    G = torch.einsum("mnd,mne->mde", A, A)  # A_i^T A_i, [m, d, d]
    Ab = torch.einsum("mnd,mn->md", A, b)  # A_i^T b_i,   [m, d]
    return MinimaxProblem(
        loss=_loss, agent_data={"G": G, "Ab": Ab}, num_agents=num_agents
    )


def quadratic_minimax_point(
    problem: MinimaxProblem,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form minimax point:
    grad_x f = Gbar x + 2 Abbar = 0  ->  x* = -2 Gbar^{-1} Abbar
    grad_y f = -Gbar y - Abbar = 0   ->  y* = -  Gbar^{-1} Abbar
    """
    Gbar = torch.mean(problem.agent_data["G"], dim=0)
    Abbar = torch.mean(problem.agent_data["Ab"], dim=0)
    sol = torch.linalg.solve(Gbar, Abbar)
    return -2.0 * sol, -sol
