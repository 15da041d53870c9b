"""Generalization bounds for distributed minimax learning (Section 4),
port of `repro/core/generalization.py`.

Implements:
  * Monte-Carlo estimation of the distributed Rademacher complexity (Eq. 8)
      R(X, y) = E_sigma sup_{x in X} (1/mn) sum_ij sigma_ij l(x, y; xi_ij)
    with the sup taken over a finite candidate set of x's (exact for finite
    hypothesis classes; a lower bound otherwise).  The signs sigma are
    JAX's draws bit for bit (`prng.rademacher` under `prng.split` keys).
  * The Theorem-2 high-probability bound assembly.
  * The Lemma-3 VC-dimension bound on R(X, Y).
  * `generalization_gap` — the MEASURED train/held-out risk gap the
    bounds control.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch.func import vmap

from .. import prng


def empirical_rademacher(
    loss_matrix_fn: Callable[[torch.Tensor], torch.Tensor],
    num_candidates: int,
    m: int,
    n: int,
    key: torch.Tensor,
    num_mc: int = 256,
) -> torch.Tensor:
    """E_sigma sup_x (1/mn) sum_ij sigma_ij l(x, y; xi_ij).

    loss_matrix_fn(candidate_index_batch) must return the loss matrix
    [num_candidates, m, n] evaluated at fixed y over the dataset; it is
    called once, with int64 indices on the CPU.  The signs are drawn on
    the matrix's device, one draw of m*n per key of `prng.split(key,
    num_mc)`, as JAX draws them.
    """
    L = loss_matrix_fn(torch.arange(num_candidates))  # [C, m, n]
    L = L.reshape(num_candidates, m * n)
    # one draw per key of the split, all keys in one threefry pass
    sigma = prng.rademacher(prng.split(key, num_mc), (m * n,), L.dtype,
                            L.device)  # [num_mc, m*n]
    corr = sigma @ L.T / (m * n)  # [num_mc, C]
    return torch.mean(torch.max(corr, dim=1).values)


def theorem2_bound(
    empirical_risk: float,
    rademacher: float,
    M_i: Sequence[float],
    n: int,
    cover_size: int,
    delta: float,
    L_y: float,
    eps: float,
) -> float:
    """RHS of Eq. (10):  f + 2 R(X,y) + sqrt(sum_i M_i^2/(2 m^2 n) log(|Y_eps|/delta)) + 2 L_y eps."""
    m = len(M_i)
    conc = math.sqrt(
        sum(Mi**2 for Mi in M_i) / (2.0 * m * m * n) * math.log(cover_size / delta)
    )
    return float(empirical_risk + 2.0 * rademacher + conc + 2.0 * L_y * eps)


def lemma3_vc_bound(M_i: Sequence[float], n: int, vc_dim: int) -> float:
    """RHS of Eq. (12):  sqrt(2 d max_y sum_i M_i^2/(m^2 n) (1 + log(mn/d)))."""
    m = len(M_i)
    s = sum(Mi**2 for Mi in M_i) / (m * m * n)
    return math.sqrt(2.0 * vc_dim * s * (1.0 + math.log(m * n / vc_dim)))


def generalization_gap(loss: Callable, train_data, test_data) -> Callable:
    """Measured counterpart of the Section-4 bounds: returns
    gap(x, y) = R_test(x, y) - R_train(x, y), where each risk is the
    mean over agents of the per-agent loss on that split.

    Only meaningful when the loss is an empirical RISK on both splits
    (same per-sample-mean scale).  Both data pytrees must be
    agent-stacked ([m, ...] leaves) with the same m."""
    vloss = vmap(loss, in_dims=(None, None, 0))

    def gap(x, y):
        return torch.mean(vloss(x, y, test_data)) - torch.mean(
            vloss(x, y, train_data)
        )

    return gap


def l2_cover_size(radius: float, eps: float, dim: int) -> int:
    """Standard covering-number upper bound |Y_eps| <= (1 + 2 radius/eps)^dim
    for an l2 ball of given radius in R^dim."""
    return int(math.ceil((1.0 + 2.0 * radius / eps) ** dim))
