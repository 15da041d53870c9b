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


def _sufficient_stats(A, b):
    """Per-agent per-sample-MEAN sufficient statistics G_i = A_i^T A_i / n,
    Ab_i = A_i^T b_i / n: the loss is an empirical risk, so train and
    held-out risks are on one scale."""
    n = A.shape[1]
    G = torch.einsum("mnd,mne->mde", A, A) / n
    Ab = torch.einsum("mnd,mn->md", A, b) / n
    return G, Ab


def make_dirichlet_quadratic_problem(
    generator: torch.Generator,
    dim: int = 20,
    num_samples: int = 100,
    num_agents: int = 10,
    alpha: float = 1.0,
    num_components: int = 4,
    test_samples: int = 0,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
):
    """Dirichlet-heterogeneous quadratic game with a held-out split: agent
    i draws its mixture over `num_components` latent targets theta_c from
    Dirichlet(alpha) (`data.dirichlet_partition_weights`), then each of
    its samples picks a component from that mixture (`torch.multinomial`)
    and draws row A ~ N(0, I), b = A theta_c + eps, eps ~ N(0, 0.25).
    Sufficient statistics are per-sample means, so the train risk and the
    held-out risk of `test_data` are comparable.

    Returns (problem, test_data, weights) on `device` (default CUDA);
    `test_data` is None when `test_samples == 0`, `weights` the [m, C]
    mixture matrix."""
    from ..data.synthetic import dirichlet_partition_weights

    device = resolve_device(device)
    gdev = generator.device
    weights = dirichlet_partition_weights(generator, num_agents,
                                          num_components, alpha, dtype=dtype)
    theta = torch.randn((num_components, dim), generator=generator,
                        dtype=dtype, device=gdev)

    def sample_split(n):
        comp = torch.multinomial(weights, n, replacement=True,
                                 generator=generator)  # [m, n]
        A = torch.randn((num_agents, n, dim), generator=generator,
                        dtype=dtype, device=gdev)
        eps = 0.5 * torch.randn((num_agents, n), generator=generator,
                                dtype=dtype, device=gdev)
        b = torch.einsum("mnd,mnd->mn", A, theta[comp]) + eps
        G, Ab = _sufficient_stats(A.to(device), b.to(device))
        return {"G": G, "Ab": Ab}

    agent_data = sample_split(num_samples)
    test_data = sample_split(test_samples) if test_samples else None
    problem = MinimaxProblem(loss=_loss, agent_data=agent_data,
                             num_agents=num_agents)
    return problem, test_data, weights.to(device)


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
