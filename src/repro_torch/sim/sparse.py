"""O(active) elastic execution (port of `repro/sim/sparse.py`): only the
dense-fallback bound is ported.

`DENSE_FALLBACK_MAX_M` is how far the runner densifies a
`SparseRoundSchedule` and runs it through the dense elastic round.  The
sparse engine itself (`SparseElasticEngine`: the running-sum
`SparseTracker`, per-id data sources, the pod tree) is ROADMAP Queue 1
item 9: its classes raise NotImplementedError naming it.
"""
from __future__ import annotations

from ..device import not_ported

#: populations at or below this size run densified through the dense
#: elastic machinery; above it the O(active) engine applies
DENSE_FALLBACK_MAX_M = 4096


class _NotPorted:
    """Base of the sparse engine's classes: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise not_ported(f"sim.sparse.{type(self).__name__}", "Queue 1 item 9")


class AgentDataSource(_NotPorted):
    """O(active) access to per-agent data (not ported)."""


class ArrayDataSource(AgentDataSource):
    """Per-agent rows of dense arrays (not ported)."""


class SyntheticDataSource(AgentDataSource):
    """Per-agent data synthesized from the global id (not ported)."""


class SparseTracker(_NotPorted):
    """Running-sum tracker of the O(active) round (not ported)."""


class SparseElasticEngine(_NotPorted):
    """The O(active) driver of `SparseRoundSchedule`s (not ported)."""
