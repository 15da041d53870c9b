"""Federated data helpers (port of `repro.data`): the Dirichlet partition
of mixture weights, its heterogeneity index and the agent split.  The
token batches need `data/tokens.py` (ROADMAP Queue 1 item 12)."""
from .synthetic import (
    dirichlet_partition_weights,
    federated_token_batches,
    heterogeneity_index,
    partition_among_agents,
)

__all__ = [
    "dirichlet_partition_weights",
    "federated_token_batches",
    "heterogeneity_index",
    "partition_among_agents",
]
