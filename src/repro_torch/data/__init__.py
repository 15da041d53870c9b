"""Federated data helpers (port of `repro.data`): seed-exact synthetic
token batches, the Dirichlet partition of mixture weights, its
heterogeneity index and the agent split."""
from .synthetic import (
    dirichlet_partition_weights,
    federated_token_batches,
    heterogeneity_index,
    partition_among_agents,
)
from .tokens import synthetic_lm_batch

__all__ = [
    "dirichlet_partition_weights",
    "federated_token_batches",
    "heterogeneity_index",
    "partition_among_agents",
    "synthetic_lm_batch",
]
