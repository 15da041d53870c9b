"""Federated layer of the port: communication strategies (the runtimes
are ROADMAP Queue 1 items 3 and 10)."""
from .strategies import (
    CommStrategy,
    FullSync,
    GradientTracking,
    LocalOnly,
    resolve_strategy,
)

__all__ = [
    "CommStrategy",
    "FullSync",
    "GradientTracking",
    "LocalOnly",
    "resolve_strategy",
]
