"""Centralized (projected) Gradient Descent Ascent — the paper's baseline
(port of `repro/core/gda.py`).

x^{t+1} = Proj_X(x^t - eta_x * grad_x f(x^t, y^t))
y^{t+1} = Proj_Y(y^t + eta_y * grad_y f(x^t, y^t))

with f(x,y) = (1/m) sum_i f_i(x,y).  Equivalent to Local SGDA with K=1.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from .engine import make_round, stack_metrics
from .types import LossFn, ProjFn, Pytree, grad_xy, identity_proj, tree_map


def make_gda_step(
    loss: LossFn,
    eta_x: float,
    eta_y: float,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
) -> Callable:
    """One centralized GDA step over agent-stacked data — a one-step
    `FullSync` round of the engine."""
    from ..fed.strategies import FullSync

    return make_round(
        loss, FullSync(), 1, eta_x, eta_y, proj_x=proj_x, proj_y=proj_y
    )


def make_gda_step_reference(
    loss: LossFn,
    eta_x: float,
    eta_y: float,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
) -> Callable:
    """The pre-engine implementation, the differential-test oracle for the
    engine's FullSync path."""
    gfn = grad_xy(loss)

    def step(x: Pytree, y: Pytree, agent_data: Pytree):
        g = vmap(gfn, in_dims=(None, None, 0))(x, y, agent_data)
        gx = tree_map(lambda u: torch.mean(u, dim=0), g.gx)
        gy = tree_map(lambda u: torch.mean(u, dim=0), g.gy)
        x1 = proj_x(tree_map(lambda u, v: u - eta_x * v, x, gx))
        y1 = proj_y(tree_map(lambda u, v: u + eta_y * v, y, gy))
        return x1, y1

    return step


def run_rounds(
    round_fn: Callable,
    x0: Pytree,
    y0: Pytree,
    agent_data: Pytree,
    num_rounds: int,
    metric_fn: Optional[Callable] = None,
):
    """Run `round_fn(x, y, agent_data) -> (x, y)` for num_rounds.

    Returns final (x, y) and the per-round metrics (metric_fn(x, y),
    evaluated on the *input* of each round, plus once at the end), stacked
    on the device: no per-round host sync."""
    x, y = x0, y0
    history = []
    for _ in range(num_rounds):
        if metric_fn is not None:
            history.append(metric_fn(x, y))
        x, y = round_fn(x, y, agent_data)
    if metric_fn is None:
        return (x, y), None
    history.append(metric_fn(x, y))
    return (x, y), stack_metrics(history)
