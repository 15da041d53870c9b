"""Named population scenarios, the benchmark axis for churn (port of
`repro/sim/scenarios.py`):

  stable           all m agents, every round, full K budgets: static-full,
                   so the runner takes its plain loop
  flaky            Markov join / leave churn (~3/4 of agents present in
                   stationarity): FedGDA-GT with tracker rebasing keeps its
                   exact limit, the naive no-rebase server stalls
  diurnal          participation waves between 40% and 100%, period 50
  straggler_heavy  5% dropout, 60% of agent-rounds straggle through a
                   uniform 1/4..all of their K local steps
  mega             m = 1e6 registered agents, a uniform 256-agent active
                   subset a round (`UniformActiveSubset`: only
                   `sparse_schedule` applies), light stragglers, 1024 pods.
                   The m argument is ignored; `SparseElasticEngine`
                   runs it (`benchmarks.elastic --population mega`)
"""
from __future__ import annotations

from typing import Callable, Dict

from .population import (
    AlwaysOn,
    BernoulliAvailability,
    DiurnalAvailability,
    MarkovChurn,
    NoStragglers,
    Population,
    UniformActiveSubset,
    UniformStragglers,
)

#: the mega preset's pinned scale (the m argument is ignored)
MEGA_AGENTS = 1_000_000
MEGA_ACTIVE = 256
MEGA_PODS = 1024

SCENARIOS: Dict[str, Callable[[int], Population]] = {
    "stable": lambda m: Population(m, AlwaysOn(), NoStragglers()),
    "flaky": lambda m: Population(
        m, MarkovChurn(p_leave=0.2, p_join=0.6), NoStragglers()
    ),
    "diurnal": lambda m: Population(
        m, DiurnalAvailability(period=50, low=0.4, high=1.0), NoStragglers()
    ),
    "straggler_heavy": lambda m: Population(
        m,
        BernoulliAvailability(p=0.95),
        UniformStragglers(p_straggle=0.6, min_frac=0.25),
    ),
    "mega": lambda m: Population(
        MEGA_AGENTS,
        UniformActiveSubset(size=MEGA_ACTIVE),
        UniformStragglers(p_straggle=0.3, min_frac=0.5),
        pods=MEGA_PODS,
    ),
}


def make_population(name: str, m: int) -> Population:
    """Resolve a scenario name to a Population of m agents."""
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown population scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None
    return factory(m)
