"""Heavy-ball momentum (port of `repro/optim/momentum.py`): the shared
velocity primitive and the server variant.

`heavy_ball` is the one leafwise recurrence ``v <- beta * v + g`` that both
momentum schedules run on: the local steps of Local SGDA+ (the engine's
momentum branch imports it lazily, only when `strategy.momentum` is
nonzero) and the server update below, a FedAvgM-style acceleration of the
round increment that leaves the inner gradient-tracking loop untouched.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.fedgda_gt import make_fedgda_gt_round
from ..core.types import LossFn, ProjFn, Pytree, identity_proj, tree_map


def heavy_ball(v: Pytree, g: Pytree, beta: float) -> Pytree:
    """One leafwise heavy-ball velocity update: ``v <- beta * v + g``."""
    return tree_map(lambda vv, gg: beta * vv + gg, v, g)


def make_momentum_fedgda_gt_round(
    loss: LossFn,
    num_local_steps: int,
    eta: float,
    beta: float = 0.9,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
) -> Callable:
    """Returns round((x, y, vel), agent_data) -> (x, y, vel), vel the pair
    (vx, vy) of server-side velocities (`round.init_velocity(x, y)` gives
    zeros).  The inner round is FedGDA-GT through the `gt_update` kernel,
    unprojected; the server adds the velocity and projects."""
    base = make_fedgda_gt_round(loss, num_local_steps, eta)

    def round(state, agent_data):
        x, y, (vx, vy) = state
        x1, y1 = base(x, y, agent_data)
        vx = heavy_ball(vx, tree_map(torch.sub, x1, x), beta)
        vy = heavy_ball(vy, tree_map(torch.sub, y1, y), beta)
        x2 = proj_x(tree_map(torch.add, x, vx))
        y2 = proj_y(tree_map(torch.add, y, vy))
        return (x2, y2, (vx, vy))

    def init_velocity(x: Pytree, y: Pytree):
        return tree_map(torch.zeros_like, x), tree_map(torch.zeros_like, y)

    round.init_velocity = init_velocity
    return round
