"""Client-population simulation: churn, stragglers, elastic rounds (port
of `repro.sim`, the same exported names).

  population  availability processes (Bernoulli dropout, Markov churn,
              diurnal waves, fixed-size sampling, sparse uniform subsets),
              straggler models, `Population` and `PodMap`
  schedule    `RoundSchedule` ([T, m] on the host), `ChunkedRoundSchedule`
              (lazy windows, the same rounds bit for bit) and
              `SparseRoundSchedule` (O(active) id lists), all from a
              dedicated fold of the run seed, drawn as JAX draws them
  elastic     `ElasticAggregator` (re-normalized weights, tracker / EF
              rebase) and `make_elastic_round` (the membership-aware round
              over the engine's phases and the port's kernels)
  sparse      `SparseElasticEngine`: the O(active) driver (running-sum
              `SparseTracker`, per-id data sources, EF row realignment,
              the two-level pod tree), densifying up to
              `DENSE_FALLBACK_MAX_M` agents
  scenarios   named presets: stable / flaky / diurnal / straggler_heavy /
              mega
"""
from .elastic import (
    ElasticAggregator,
    init_tracker,
    make_elastic_round,
    per_agent_bytes,
    schedule_bytes,
    tracker_exchange,
)
from .population import (
    AlwaysOn,
    AvailabilityProcess,
    BernoulliAvailability,
    DeterministicLag,
    DiurnalAvailability,
    FixedSizeSampling,
    MarkovChurn,
    NoStragglers,
    PodMap,
    Population,
    SparseAvailability,
    StragglerModel,
    UniformActiveSubset,
    UniformStragglers,
    fixed_size_mask,
    renormalized_weights,
)
from .scenarios import SCENARIOS, make_population
from .schedule import (
    AVAILABILITY_STREAM,
    ChunkedRoundSchedule,
    RoundEvent,
    RoundSchedule,
    SparseRoundEvent,
    SparseRoundSchedule,
    availability_key,
)
from .sparse import (
    AgentDataSource,
    ArrayDataSource,
    SparseElasticEngine,
    SparseTracker,
    SyntheticDataSource,
)

__all__ = [
    "AVAILABILITY_STREAM",
    "AgentDataSource",
    "AlwaysOn",
    "ArrayDataSource",
    "AvailabilityProcess",
    "BernoulliAvailability",
    "ChunkedRoundSchedule",
    "DeterministicLag",
    "DiurnalAvailability",
    "ElasticAggregator",
    "FixedSizeSampling",
    "MarkovChurn",
    "NoStragglers",
    "PodMap",
    "Population",
    "RoundEvent",
    "RoundSchedule",
    "SCENARIOS",
    "SparseAvailability",
    "SparseElasticEngine",
    "SparseRoundEvent",
    "SparseRoundSchedule",
    "SparseTracker",
    "StragglerModel",
    "SyntheticDataSource",
    "UniformActiveSubset",
    "UniformStragglers",
    "availability_key",
    "fixed_size_mask",
    "init_tracker",
    "make_elastic_round",
    "make_population",
    "per_agent_bytes",
    "renormalized_weights",
    "schedule_bytes",
    "tracker_exchange",
]
