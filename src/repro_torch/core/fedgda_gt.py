"""FedGDA-GT (Algorithm 2) — the paper's contribution (port of
`repro/core/fedgda_gt.py`).

One communication round t:
  1. server broadcasts (x^t, y^t)
  2. agents compute grad f_i(x^t, y^t), server averages  [ONE exchange]
  3. K local steps with gradient-tracking correction:
       x_{i,k+1} = x_{i,k} - eta*(gx_i(x_{i,k},y_{i,k}) - gx_i(x^t,y^t) + gx(x^t,y^t))
       y_{i,k+1} = y_{i,k} + eta*(gy_i(x_{i,k},y_{i,k}) - gy_i(x^t,y^t) + gy(x^t,y^t))
  4. server averages and projects                        [ONE exchange]

Theorem 1: linear convergence to the exact minimax point with constant eta.
Local steps 2..K go through `update_fn`, by default the hand-written CUDA
`gt_update` kernel (`kernels.make_gt_update_fn`), x and y in one launch
a step (its `pair`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from .engine import default_update as _default_update
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


def make_fedgda_gt_round(
    loss: LossFn,
    num_local_steps: int,
    eta: float,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
    correction_dtype=None,
    update_fn: Optional[Callable] = None,
) -> Callable:
    """Returns round(x, y, agent_data) -> (x, y) implementing Algorithm 2 —
    a `GradientTracking` round of the engine (`update_fn` defaults to the
    kernel-backed update, see `engine.make_phases`).

    When m == 1 the correction is identically zero and is elided (the
    algorithm reduces to centralized GDA)."""
    from ..fed.strategies import GradientTracking

    return make_round(
        loss,
        GradientTracking(correction_dtype=correction_dtype),
        num_local_steps,
        eta,
        eta,
        proj_x=proj_x,
        proj_y=proj_y,
        update_fn=update_fn,
    )


def make_fedgda_gt_round_reference(
    loss: LossFn,
    num_local_steps: int,
    eta: float,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
    correction_dtype=None,
    update_fn: Callable = _default_update,
) -> Callable:
    """The pre-engine implementation, the differential-test oracle: the
    engine's GradientTracking path with the same `update_fn` reproduces
    its iterates BITWISE."""
    vgrad = vmap(grad_xy(loss), in_dims=(0, 0, 0))
    # the kernel-backed update_fn updates x and y in one launch
    pair = getattr(update_fn, "pair", None)

    def round(x: Pytree, y: Pytree, agent_data: Pytree):
        m = tree_leaves(agent_data)[0].shape[0]
        xs = tree_broadcast_agents(x, m)
        ys = tree_broadcast_agents(y, m)

        if m > 1:
            # local gradients at the broadcast point + global average
            g0 = vgrad(xs, ys, agent_data)
            gbar_x = tree_map(lambda u: u.mean(dim=0), g0.gx)
            gbar_y = tree_map(lambda u: u.mean(dim=0), g0.gy)

            def corr(gbar, gi):
                c = gbar[None] - gi
                if correction_dtype is not None:
                    c = c.to(correction_dtype)
                return c

            cx = tree_map(corr, gbar_x, g0.gx)
            cy = tree_map(corr, gbar_y, g0.gy)

            # fused step k=0: the correction cancels exactly at the
            # anchor point, so the step is z <- z -/+ eta * gbar
            def bstep(zs, gbar, sign):
                return tree_map(
                    lambda u, gb: u + sign * eta * gb[None].to(u.dtype),
                    zs, gbar,
                )

            xs = bstep(xs, gbar_x, -1.0)
            ys = bstep(ys, gbar_y, +1.0)
            inner_steps = num_local_steps - 1
        else:
            cx = tree_map(torch.zeros_like, xs)
            cy = tree_map(torch.zeros_like, ys)
            inner_steps = num_local_steps

        for _ in range(inner_steps):
            g = vgrad(xs, ys, agent_data)
            if pair is not None:  # x and y in one launch
                xs, ys = pair(xs, g.gx, cx, eta, ys, g.gy, cy, eta)
            else:
                xs = update_fn(xs, g.gx, cx, eta, -1.0)
                ys = update_fn(ys, g.gy, cy, eta, +1.0)
        return proj_x(tree_mean_over_agents(xs)), proj_y(tree_mean_over_agents(ys))

    return round


def communication_bytes_per_round(
    x: Pytree, y: Pytree, algorithm, num_local_steps: int
) -> int:
    """Analytic bytes exchanged with the server per communication round
    (one agent's up/download payload; see the strategies' models)."""
    from ..fed.strategies import resolve_strategy

    return resolve_strategy(algorithm).bytes_per_round(x, y, num_local_steps)
