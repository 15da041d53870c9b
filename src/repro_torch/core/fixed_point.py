"""Fixed-point characterization of Local SGDA (Proposition 1, Appendix C;
port of `repro/core/fixed_point.py`).

Proposition 1: if Local SGDA (constant steps, full gradients) converges to
(x*, y*), then  (1/m) sum_i sum_{k<K} grad f_i(D_i^k(x*,y*), A_i^k(x*,y*)) = 0,
where D_i / A_i are the per-agent descent/ascent operators.  For K >= 2 this
differs from the true minimax condition grad f(x*,y*) = 0.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import vmap

from .types import LossFn, Pytree, grad_xy, tree_map, tree_reduce


def local_operators(loss: LossFn, eta_x: float, eta_y: float) -> Callable:
    """Returns ops(x, y, data_i, k) -> (D_i^k(x,y), A_i^k(x,y))."""
    gfn = grad_xy(loss)

    def ops(x: Pytree, y: Pytree, data_i: Pytree, k: int):
        xk, yk = x, y
        for _ in range(k):
            g = gfn(xk, yk, data_i)
            xk = tree_map(lambda u, v: u - eta_x * v, xk, g.gx)
            yk = tree_map(lambda u, v: u + eta_y * v, yk, g.gy)
        return xk, yk

    return ops


def prop1_residual(
    loss: LossFn,
    x: Pytree,
    y: Pytree,
    agent_data: Pytree,
    num_local_steps: int,
    eta_x: float,
    eta_y: float,
) -> torch.Tensor:
    """|| (1/m) sum_i sum_k grad f_i(D^k, A^k) ||  at (x, y).

    Zero exactly at fixed points of Local SGDA (Proposition 1)."""
    gfn = grad_xy(loss)

    def per_agent(data_i):
        xk, yk = x, y
        accx = tree_map(torch.zeros_like, x)
        accy = tree_map(torch.zeros_like, y)
        for _ in range(num_local_steps):
            g = gfn(xk, yk, data_i)
            accx = tree_map(torch.add, accx, g.gx)
            accy = tree_map(torch.add, accy, g.gy)
            xk = tree_map(lambda u, v: u - eta_x * v, xk, g.gx)
            yk = tree_map(lambda u, v: u + eta_y * v, yk, g.gy)
        return accx, accy

    accx, accy = vmap(per_agent)(agent_data)
    sq = 0.0
    for acc in (accx, accy):
        mean = tree_map(lambda u: torch.mean(u, dim=0), acc)
        sq = sq + tree_reduce(torch.add, tree_map(lambda u: torch.sum(u**2), mean))
    return torch.sqrt(sq)


def appendix_c_fixed_point(
    num_local_steps: int, eta_x: float, eta_y: float
) -> Tuple[float, float]:
    """Closed-form Local-SGDA fixed point for the Appendix-C example.

    f_1 = x^2 - y^2 - (x - y),  f_2 = 4x^2 - 4y^2 - 32(x - y):
      x*_LSGDA = [sum_i sum_k 2 i^2 (1-2 eta_x i^2)^k]^{-1}
                 [sum_i sum_k (31 i - 30)(1-2 eta_x i^2)^k]
    (analogous for y).  True minimax point is x* = y* = 3.3.
    """

    def fp(eta: float) -> float:
        num = 0.0
        den = 0.0
        for i in (1, 2):
            for k in range(num_local_steps):
                w = (1.0 - 2.0 * eta * i * i) ** k
                den += 2.0 * i * i * w
                num += (31.0 * i - 30.0) * w
        return num / den

    return fp(eta_x), fp(eta_y)


APPENDIX_C_MINIMAX_POINT = (3.3, 3.3)
