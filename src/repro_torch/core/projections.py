"""Projection operators Proj_X / Proj_Y (Assumption 3 feasible sets;
port of `repro/core/projections.py`)."""
from __future__ import annotations

import torch

from .types import Pytree, tree_map, tree_reduce


def l2_ball_proj(radius: float):
    """Projection onto {p : ||p||_2 <= radius} over the *whole* pytree."""

    def proj(p: Pytree) -> Pytree:
        sq = tree_reduce(
            torch.add,
            tree_map(lambda u: torch.sum(u.to(torch.float32) ** 2), p),
        )
        norm = torch.sqrt(torch.clamp(sq, min=1e-30))
        scale = torch.clamp(radius / norm, max=1.0)
        return tree_map(lambda u: (u * scale).to(u.dtype), p)

    return proj


def box_proj(lo: float, hi: float):
    """Per-coordinate clipping onto [lo, hi]^d."""

    def proj(p: Pytree) -> Pytree:
        return tree_map(lambda u: torch.clamp(u, lo, hi), p)

    return proj


def simplex_proj():
    """Projection of a single 1-D tensor onto the probability simplex
    (used for agnostic-FL style mixture weights, Appendix A.2)."""

    def proj_vec(v: torch.Tensor) -> torch.Tensor:
        n = v.shape[0]
        u = torch.flip(torch.sort(v).values, dims=(0,))
        css = torch.cumsum(u, dim=0)
        ks = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
        cond = u - (css - 1.0) / ks > 0
        idx = torch.arange(n, device=v.device)
        rho = torch.max(torch.where(cond, idx, torch.full_like(idx, -1)))
        theta = (css[rho] - 1.0) / (rho + 1.0)
        return torch.clamp(v - theta, min=0.0)

    def proj(p: Pytree) -> Pytree:
        return tree_map(proj_vec, p)

    return proj
