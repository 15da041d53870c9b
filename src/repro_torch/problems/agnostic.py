"""Agnostic Federated Learning — paper Appendix A.2 (Mohri et al. [13]),
port of `repro/problems/agnostic.py`.

  min_theta  max_{lambda in simplex}  sum_i lambda_i R_i(theta)

cast into the paper's average form (Eq. 1) via  f_i(x, y) = m * y_i * R_i(x)
so that (1/m) sum_i f_i = sum_i y_i R_i.  x = theta (model), y = lambda
(mixture weights on the m-simplex, Proj_Y = simplex projection).  The
adversary upweights the worst-off agent; the solution is the minimax-fair
model over agent distributions.

Local risks here are ridge-regularized linear regression on per-agent data
(strongly convex in x; linear — concave — in y, so the projected ascent is
exact on the simplex).  The draws come from a `torch.Generator`: the same
distribution as the JAX builder, not the same numbers (for JAX's data, use
`convert.problem_from_numpy("agnostic", ...)`).
"""
from __future__ import annotations

import torch
from torch.func import vmap

from ..core.projections import simplex_proj
from ..core.types import MinimaxProblem
from ..device import DeviceLike, resolve_device


def _risk(x, a, b):
    pred = a @ x
    return torch.mean((pred - b) ** 2) + 0.05 * torch.sum(x**2)


def _loss(x, y, data):
    # agent_index is int32, as in JAX; under vmap each agent indexes its
    # own entry of y
    return data["m"] * y[data["agent_index"]] * _risk(x, data["a"], data["b"])


def make_agnostic_problem(
    generator: torch.Generator,
    dim: int = 10,
    num_samples: int = 100,
    num_agents: int = 5,
    shift: float = 2.0,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
) -> MinimaxProblem:
    """Heterogeneous agents with CONFLICTING true models: agent i labels
    with x_true + (i/m)*shift*e_0, so no single model fits everyone and a
    uniform average underserves the extreme agents — the setting where
    agnostic reweighting matters (Mohri et al. §1).  Drawn on
    `generator`'s device, placed on `device` (default CUDA)."""
    device = resolve_device(device)
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=gdev)

    x_true = normal(dim)
    disagree = torch.zeros(num_agents, dim, dtype=dtype, device=gdev)
    disagree[:, 0] = torch.arange(num_agents, dtype=dtype, device=gdev) * (
        shift / num_agents)
    x_agents = x_true[None, :] + disagree  # [m, dim]
    a = normal(num_agents, num_samples, dim)
    b = torch.einsum("mnd,md->mn", a, x_agents)
    b = b + 0.1 * normal(num_agents, num_samples)
    data = {
        "a": a,
        "b": b,
        "agent_index": torch.arange(num_agents, dtype=torch.int32, device=gdev),
        "m": torch.full((num_agents,), float(num_agents), dtype=dtype, device=gdev),
    }
    return MinimaxProblem(
        loss=_loss,
        agent_data={k: v.to(device) for k, v in data.items()},
        num_agents=num_agents,
        proj_y=simplex_proj(),
    )


def per_agent_risks(problem: MinimaxProblem, x: torch.Tensor) -> torch.Tensor:
    """R_i(x) for every agent (the quantities lambda* weights)."""
    data = problem.agent_data
    return vmap(_risk, in_dims=(None, 0, 0))(x, data["a"], data["b"])


def uniform_lambda(num_agents: int, dtype: torch.dtype = torch.float64,
                   device: DeviceLike = None) -> torch.Tensor:
    return torch.full((num_agents,), 1.0 / num_agents, dtype=dtype,
                      device=resolve_device(device))
