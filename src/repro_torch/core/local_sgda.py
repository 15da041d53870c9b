"""Local SGDA (Algorithm 1, Deng & Mahdavi 2021) with full local gradients
(port of `repro/core/local_sgda.py`).

One communication round: each agent starts from the server model and
performs K local GDA steps using ONLY its own gradient; the server then
averages.  With constant stepsizes this has *incorrect* fixed points for
K >= 2 (Proposition 1).
"""
from __future__ import annotations

from typing import Callable

from torch.func import vmap

from ..device import not_ported
from .engine import make_round
from .types import (
    LossFn,
    ProjFn,
    Pytree,
    grad_xy,
    identity_proj,
    tree_broadcast_agents,
    tree_leaves,
    tree_map,
    tree_mean_over_agents,
)


def make_local_sgda_round(
    loss: LossFn,
    num_local_steps: int,
    eta_x: float,
    eta_y: float,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
) -> Callable:
    """Returns round(x, y, agent_data) -> (x, y) implementing Algorithm 1 —
    a `LocalOnly` round of the engine."""
    from ..fed.strategies import LocalOnly

    return make_round(
        loss, LocalOnly(), num_local_steps, eta_x, eta_y,
        proj_x=proj_x, proj_y=proj_y,
    )


def make_local_sgda_round_reference(
    loss: LossFn,
    num_local_steps: int,
    eta_x: float,
    eta_y: float,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
) -> Callable:
    """The pre-engine implementation, the differential-test oracle for the
    engine's LocalOnly path."""
    vgrad = vmap(grad_xy(loss), in_dims=(0, 0, 0))

    def round(x: Pytree, y: Pytree, agent_data: Pytree):
        m = tree_leaves(agent_data)[0].shape[0]
        xs = tree_broadcast_agents(x, m)
        ys = tree_broadcast_agents(y, m)
        for _ in range(num_local_steps):
            g = vgrad(xs, ys, agent_data)
            xs = tree_map(lambda u, v: u - eta_x * v, xs, g.gx)
            ys = tree_map(lambda u, v: u + eta_y * v, ys, g.gy)
        return proj_x(tree_mean_over_agents(xs)), proj_y(tree_mean_over_agents(ys))

    return round


def make_scheduled_local_sgda_round(*args, **kwargs) -> Callable:
    """Local SGDA with a call-time stepsize: not ported yet."""
    raise not_ported("make_scheduled_local_sgda_round", "Queue 1 item 2")
