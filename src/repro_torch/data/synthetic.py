"""Federated heterogeneous synthetic data (port of
`repro/data/synthetic.py`).

Two heterogeneity dials coexist here:

  * the integer `heterogeneity` knob of `federated_token_batches` — a
    deterministic per-agent vocabulary shift, on seed-exact token draws
    (`data/tokens.py`);
  * Dirichlet mixture weights (`dirichlet_partition_weights`) are the
standard federated non-iid model (Hsu et al. 2019): each agent draws its
component mixture from Dirichlet(alpha), so alpha -> 0 gives near-one-hot
(maximally heterogeneous) agents and alpha -> inf the iid limit;
`heterogeneity_index` scores a weight matrix on [0, 1).  Its draws come
from a `torch.Generator`: the same distribution as the JAX package's,
not the same numbers (as in `problems/quadratic.py`).  To run on JAX's
draws, carry them over as numpy (`convert.py`).
"""
from __future__ import annotations

import torch

from .. import prng
from ..core.types import tree_map
from ..device import DeviceLike
from .tokens import synthetic_lm_batch


def federated_token_batches(
    key: torch.Tensor,
    num_agents: int,
    per_agent_batch: int,
    seq_len: int,
    vocab_size: int,
    heterogeneity: int = 0,
    device: DeviceLike = None,
) -> dict:
    """Agent-stacked LM batches: leaves shaped [m, B_local, S] on `device`
    (default CUDA), equal to JAX's for the same `prng` key.

    heterogeneity shifts each agent's token marginal by
    `agent_index * heterogeneity` vocabulary slots (0 = iid agents)."""
    keys = prng.split(key, num_agents)
    batches = [
        synthetic_lm_batch(keys[i], per_agent_batch, seq_len, vocab_size,
                           skew=i * heterogeneity, device=device)
        for i in range(num_agents)
    ]
    return tree_map(lambda *xs: torch.stack(xs), *batches)


def dirichlet_partition_weights(
    generator: torch.Generator,
    num_agents: int,
    num_components: int,
    alpha: float,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Per-agent mixture weights over `num_components` latent data
    components: rows of a [m, C] matrix on the generator's device, each an
    independent draw from Dirichlet(alpha * ones(C)); every row sums to 1
    for any alpha > 0."""
    if alpha <= 0:
        raise ValueError(f"Dirichlet concentration must be > 0, got {alpha}")
    conc = torch.full((num_agents, num_components), float(alpha), dtype=dtype,
                      device=generator.device)
    return torch._sample_dirichlet(conc, generator=generator)


def heterogeneity_index(weights: torch.Tensor) -> torch.Tensor:
    """Mean total-variation distance between each agent's mixture and the
    population mixture (the column mean): 0 for identical agents,
    approaching (C-1)/C as rows become one-hot on distinct components."""
    weights = torch.as_tensor(weights)
    mix = torch.mean(weights, dim=0)
    return 0.5 * torch.mean(torch.sum(torch.abs(weights - mix[None, :]), dim=1))


def partition_among_agents(data: dict, num_agents: int) -> dict:
    """Split the leading batch axis of every leaf into [m, B/m, ...]."""
    def split(u):
        b = u.shape[0]
        assert b % num_agents == 0, (b, num_agents)
        return u.reshape((num_agents, b // num_agents) + tuple(u.shape[1:]))

    return tree_map(split, data)
