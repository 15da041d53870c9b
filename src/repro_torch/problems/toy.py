"""Appendix-C two-agent scalar example (port of `repro/problems/toy.py`).

  f_1(x, y) = x^2 - y^2 - (x - y)
  f_2(x, y) = 4x^2 - 4y^2 - 32(x - y)

i.e. f_i = a_i x^2 - a_i y^2 - c_i (x - y) with a = (1, 4), c = (1, 32).
True minimax point: x* = y* = 3.3.  Local SGDA's constant-stepsize fixed
point is given in closed form by `core.fixed_point.appendix_c_fixed_point`.
"""
from __future__ import annotations

import torch

from ..core.types import MinimaxProblem
from ..device import DeviceLike, resolve_device


def _loss(x, y, data):
    a, c = data["a"], data["c"]
    return a * x**2 - a * y**2 - c * (x - y)


def make_appendix_c_problem(
    dtype: torch.dtype = torch.float64, device: DeviceLike = None
) -> MinimaxProblem:
    device = resolve_device(device)
    data = {
        "a": torch.tensor([1.0, 4.0], dtype=dtype, device=device),
        "c": torch.tensor([1.0, 32.0], dtype=dtype, device=device),
    }
    return MinimaxProblem(loss=_loss, agent_data=data, num_agents=2)
