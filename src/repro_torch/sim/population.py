"""Client-population model: who is available each round, and how slow
(port of `repro/sim/population.py`).

  * `AvailabilityProcess`: a deterministic, seedable process emitting a
    [num_rounds, m] boolean availability matrix: `AlwaysOn` (the paper's
    setting), `BernoulliAvailability` (i.i.d. dropout), `MarkovChurn`
    (per-agent join / leave chain), `DiurnalAvailability` (participation
    waves), `FixedSizeSampling` (exactly-S uniform subsets, the draw
    `fed.strategies.PartialParticipation` shares) and the sparse
    `UniformActiveSubset` (a round's active id list in O(size) work);
  * `StragglerModel`: per-agent-round local-step budgets capping how many
    of the K local steps a slow agent completes: `NoStragglers`,
    `UniformStragglers`, `DeterministicLag`;
  * `PodMap`: the contiguous agent -> pod partition (data only);
  * `Population`: m, an availability process, a straggler model and the
    `min_active` floor; `schedule`, `chunked_schedule` and
    `sparse_schedule` build the `sim.schedule` representations.

Every draw is JAX's, bit for bit (`prng`): each round's rows come from a
per-round fold of the process key, so a window [t0, t1) equals the same
rows of the full materialization.  A window's keys are one batch
([t1 - t0, 2], hashed on the host) and its draws one threefry pass on
`device` (default CUDA), in the dtypes the reference draws under
`jax_enable_x64`: f64 uniforms (`MarkovChurn`, `DiurnalAvailability`, a
Python-float `bernoulli`), int32 `randint` in `UniformStragglers`' rows and
int64 in `budgets_for_ids`.  The schedules themselves are numpy on the
host, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng
from ..core.engine import fixed_size_mask, renormalized_weights  # noqa: F401
from ..device import DeviceLike, resolve_device


def _round_keys(key: torch.Tensor, num_rounds: int) -> torch.Tensor:
    """One independent key per round, by fold: [num_rounds, 2]."""
    return _round_keys_window(key, 0, num_rounds)


def _round_keys_window(key: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """Per-round keys of the window [t0, t1): the ABSOLUTE round index is
    folded in, so row t's key never depends on where chunks start."""
    return prng.fold_in(key, np.arange(t0, t1))


def _ceil_frac(frac: float, num_local_steps: int) -> int:
    """max(1, ceil(frac * K)), computed as the reference does."""
    return max(1, int(-(-frac * num_local_steps // 1)))


# ------------------------------------------------------ availability processes
class AvailabilityProcess:
    """Base: emit the availability matrix of one run.

    The primitive is `sample_rounds(key, m, t0, t1, carry, device)`: the
    rows of the half-open window [t0, t1) as numpy bool [t1 - t0, m], each
    drawn from a per-round fold of `key`, plus the carry a stateful
    process threads between consecutive windows.  Splitting [0, T) into
    windows and threading the carry gives the rows of one full-range call,
    bit for bit.  `sample` is the dense convenience wrapper."""

    def sample_rounds(self, key, m: int, t0: int, t1: int, carry=None,
                      device: DeviceLike = None):
        """Rows for rounds [t0, t1) -> ([t1 - t0, m] bool, carry')."""
        raise NotImplementedError

    def sample(self, key, m: int, num_rounds: int, device: DeviceLike = None):
        rows, _ = self.sample_rounds(key, m, 0, num_rounds, None, device)
        return rows


class SparseAvailability(AvailabilityProcess):
    """Marker base of processes that emit a round's active id list
    directly in O(active) work (`SparseRoundSchedule`).  Stateless per
    round: each round is a pure function of (key, m, t)."""

    def sample_active_ids(self, key, m: int, t: int,
                          device: DeviceLike = None) -> np.ndarray:
        """Sorted unique int64 ids of the agents active in round t."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AlwaysOn(AvailabilityProcess):
    """Full synchronous participation, the paper's setting.  A schedule
    built from it is static-full and the runner takes its plain loop."""

    def sample_rounds(self, key, m, t0, t1, carry=None, device=None):
        del key, device
        return np.ones((t1 - t0, m), bool), carry


@dataclasses.dataclass(frozen=True)
class BernoulliAvailability(AvailabilityProcess):
    """i.i.d. per-agent-round dropout: active with probability `p`."""

    p: float = 0.9

    def sample_rounds(self, key, m, t0, t1, carry=None, device=None):
        keys = _round_keys_window(key, t0, t1)
        rows = prng.bernoulli(keys, self.p, (m,), device)
        return rows.cpu().numpy(), carry


@dataclasses.dataclass(frozen=True)
class MarkovChurn(AvailabilityProcess):
    """Per-agent two-state join / leave chain: an active agent leaves with
    `p_leave`, an inactive one (re)joins with `p_join`.  Absences are
    correlated across rounds; the stationary active fraction is p_join /
    (p_join + p_leave).

    The only stateful process: its carry is the [m] chain state after the
    last emitted round.  The reference's `lax.scan` draws one f64 uniform
    row per round from the round's key; the draws depend on the keys only,
    so the window's rows are one batched draw, and the chain is a
    sequential [m]-wide boolean loop over them on the host."""

    p_leave: float = 0.2
    p_join: float = 0.6
    start_active: float = 1.0

    def sample_rounds(self, key, m, t0, t1, carry=None, device=None):
        device = resolve_device(device)
        keys = prng.split(key)
        k0, kt = keys[0], keys[1]
        if carry is None:
            if t0 != 0:
                raise ValueError(
                    "MarkovChurn is stateful: windows starting at "
                    f"t0={t0} > 0 need the carry from the previous "
                    "window (thread the second return value)"
                )
            carry = prng.bernoulli(k0, self.start_active, (m,), device).cpu().numpy()
        u = prng.uniform(_round_keys_window(kt, t0, t1), (m,), torch.float64, device)
        stay = (u >= self.p_leave).cpu().numpy()
        join = (u < self.p_join).cpu().numpy()
        rows = np.empty((t1 - t0, m), bool)
        s = np.asarray(carry, bool)
        for i in range(t1 - t0):
            s = np.where(s, stay[i], join[i])
            rows[i] = s
        return rows, s.copy()


@dataclasses.dataclass(frozen=True)
class DiurnalAvailability(AvailabilityProcess):
    """Participation probability oscillating between `low` and `high` with
    `period` rounds per cycle:
    p_t = low + (high-low) * (1 + cos(2 pi t / period + phase)) / 2.
    p is formed on the host in f64 in the reference's order (numpy's cos),
    and u < p compares each round's f64 uniforms with it."""

    period: int = 100
    low: float = 0.3
    high: float = 1.0
    phase: float = 0.0

    def sample_rounds(self, key, m, t0, t1, carry=None, device=None):
        device = resolve_device(device)
        t = np.arange(t0, t1)
        p = self.low + (self.high - self.low) * 0.5 * (
            1.0 + np.cos(2.0 * np.pi * t / self.period + self.phase)
        )
        u = prng.uniform(_round_keys_window(key, t0, t1), (m,), torch.float64, device)
        rows = u < torch.from_numpy(p).to(device)[:, None]
        return rows.cpu().numpy(), carry


@dataclasses.dataclass(frozen=True)
class FixedSizeSampling(AvailabilityProcess):
    """Exactly S = max(1, round(participation * m)) uniformly sampled
    agents per round: `PartialParticipation`'s draw (`fixed_size_mask`) as
    a population process, i.i.d. across rounds.  The window's permutations
    are one batched draw (`prng.permutation` of a key batch)."""

    participation: float = 0.5

    def subset_size(self, m: int) -> int:
        return max(1, int(round(self.participation * m)))

    def sample_rounds(self, key, m, t0, t1, carry=None, device=None):
        size = self.subset_size(m)
        if size >= m:
            return np.ones((t1 - t0, m), bool), carry
        sel = prng.permutation(_round_keys_window(key, t0, t1), m, device)[:, :size]
        rows = np.zeros((t1 - t0, m), bool)
        np.put_along_axis(rows, sel.cpu().numpy(), True, axis=1)
        return rows, carry


@dataclasses.dataclass(frozen=True)
class UniformActiveSubset(SparseAvailability):
    """Exactly `size` uniformly sampled agents per round, drawn in O(size)
    work: rejection sampling of uniform int64 ids, deduplicated in draw
    order, with the attempt counter folded into the round key, so the ids
    are a pure function of (key, m, t).  The attempts are a host loop over
    small draws."""

    size: int = 256

    def sample_active_ids(self, key, m, t, device=None):
        if self.size >= m:
            return np.arange(m, dtype=np.int64)
        kt = prng.fold_in(key, t)
        seen: dict = {}
        attempt = 0
        # about 2x oversampling per attempt: for size << m one attempt
        # almost always suffices (collision probability ~ size^2 / m)
        block = max(2 * self.size, 64)
        while len(seen) < self.size:
            ka = prng.fold_in(kt, attempt)
            draw = prng.randint(ka, (block,), 0, m, torch.int64, device).cpu().numpy()
            for i in draw:
                seen.setdefault(int(i), None)
                if len(seen) >= self.size:
                    break
            attempt += 1
        ids = np.fromiter(seen.keys(), np.int64, self.size)
        ids.sort()
        return ids

    def sample_rounds(self, key, m, t0, t1, carry=None, device=None):
        # dense rows (small m only), scattered from the sparse draw, so
        # dense == sparse by construction
        rows = np.zeros((t1 - t0, m), bool)
        for i, t in enumerate(range(t0, t1)):
            rows[i, self.sample_active_ids(key, m, t, device)] = True
        return rows, carry


# ----------------------------------------------------------- straggler models
class StragglerModel:
    """Base: per-agent-round local-step budgets in [0, K].  The schedule
    builder zeroes the budgets of inactive agents and floors active ones
    at 1 step, so a model only decides how slow an active agent is.

    The primitive is windowed (`budgets_rounds`, one key fold per absolute
    round); `budgets_for_ids` is the O(active) variant of sparse events, a
    pure function of (key, t, global id)."""

    def budgets_rounds(self, key, active, t0: int, num_local_steps: int,
                       device: DeviceLike = None) -> np.ndarray:
        """Budgets for rounds [t0, t0 + active.shape[0]) -> [c, m] int32."""
        raise NotImplementedError

    def budgets(self, key, active, num_local_steps: int, device: DeviceLike = None):
        return self.budgets_rounds(key, active, 0, num_local_steps, device)

    def budgets_for_ids(self, key, ids, t: int, num_local_steps: int,
                        device: DeviceLike = None) -> np.ndarray:
        """Budgets of the global agent `ids` in round t -> [n] int32.
        Base: no stragglers, the full budget."""
        return np.full(len(ids), num_local_steps, np.int32)


@dataclasses.dataclass(frozen=True)
class NoStragglers(StragglerModel):
    """Every active agent completes all K local steps."""

    def budgets_rounds(self, key, active, t0, num_local_steps, device=None):
        del key, device
        return np.full(np.shape(active), num_local_steps, np.int32)


@dataclasses.dataclass(frozen=True)
class UniformStragglers(StragglerModel):
    """With probability `p_straggle` an agent-round is slow and completes a
    uniform number of steps in [ceil(min_frac * K), K]; otherwise all K."""

    p_straggle: float = 0.5
    min_frac: float = 0.25

    def budgets_rounds(self, key, active, t0, num_local_steps, device=None):
        c, m = np.shape(active)
        lo = _ceil_frac(self.min_frac, num_local_steps)
        keys = prng.split(_round_keys_window(key, t0, t0 + c))  # [c, 2, 2]
        slow = prng.bernoulli(keys[:, 0], self.p_straggle, (m,), device)
        b = prng.randint(keys[:, 1], (m,), lo, num_local_steps + 1, torch.int32,
                         device)
        return torch.where(slow, b, num_local_steps).to(torch.int32).cpu().numpy()

    def budgets_for_ids(self, key, ids, t, num_local_steps, device=None):
        # O(n): one (round, global id) fold per active agent
        k_sel, k_cnt = prng.split(prng.fold_in(key, t))
        lo = _ceil_frac(self.min_frac, num_local_steps)
        ids = np.asarray(ids, np.int64)
        slow = prng.bernoulli(prng.fold_in(k_sel, ids), self.p_straggle, (), device)
        b = prng.randint(prng.fold_in(k_cnt, ids), (), lo, num_local_steps + 1,
                         torch.int64, device)
        return torch.where(slow, b, num_local_steps).to(torch.int32).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class DeterministicLag(StragglerModel):
    """A fixed slow cohort: every `slow_every`-th agent completes only
    ceil(budget_frac * K) steps, every round."""

    slow_every: int = 4
    budget_frac: float = 0.25

    def _slow_budget(self, num_local_steps):
        return _ceil_frac(self.budget_frac, num_local_steps)

    def budgets_rounds(self, key, active, t0, num_local_steps, device=None):
        del key, device
        c, m = np.shape(active)
        slow = (np.arange(m) % self.slow_every) == 0
        b = self._slow_budget(num_local_steps)
        row = np.where(slow, b, num_local_steps).astype(np.int32)
        return np.broadcast_to(row, (c, m)).copy()

    def budgets_for_ids(self, key, ids, t, num_local_steps, device=None):
        del key, device
        ids = np.asarray(ids)
        slow = (ids % self.slow_every) == 0
        b = self._slow_budget(num_local_steps)
        return np.where(slow, b, num_local_steps).astype(np.int32)


# -------------------------------------------------------------------- pods
@dataclasses.dataclass(frozen=True)
class PodMap:
    """Contiguous partition of the m agents into `num_pods` pods: agent i
    belongs to pod i // pod_size, the last pod may be short.  Pure
    arithmetic, no [m] table; the sparse engine's two-level aggregate
    (`core.engine.pod_weighted_sums`) reads it."""

    m: int
    num_pods: int

    def __post_init__(self):
        if not 1 <= self.num_pods <= self.m:
            raise ValueError(
                f"num_pods must be in [1, m={self.m}], got {self.num_pods}"
            )

    @property
    def pod_size(self) -> int:
        return -(-self.m // self.num_pods)  # ceil

    def pod_of(self, ids):
        """Pod index of each agent id (numpy arrays or tensors alike)."""
        return ids // self.pod_size

    def live_pods(self, ids) -> np.ndarray:
        """Sorted unique pods with at least one of `ids`."""
        return np.unique(np.asarray(self.pod_of(np.asarray(ids))))

    def agents_of(self, pod: int) -> np.ndarray:
        lo = pod * self.pod_size
        return np.arange(lo, min(lo + self.pod_size, self.m), dtype=np.int64)


# ---------------------------------------------------------------- population
@dataclasses.dataclass(frozen=True)
class Population:
    """The client registry: m agents, an availability process and a
    straggler model.  `min_active` is the server's liveness floor: a round
    the process left with fewer agents gets that many force-activated
    (from the schedule's own key stream).  `pods > 0` opts into the
    two-level aggregation tree (`pod_map()`); 0 is flat aggregation.

    The builders draw on `device` (default CUDA, as every entry point of
    the port; pass "cpu" to draw there) and return host schedules."""

    m: int
    availability: AvailabilityProcess = AlwaysOn()
    stragglers: StragglerModel = NoStragglers()
    min_active: int = 1
    pods: int = 0

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"population needs m >= 1, got {self.m}")
        if not 1 <= self.min_active <= self.m:
            raise ValueError(
                f"min_active must be in [1, m={self.m}], got {self.min_active}"
            )
        if self.pods and not 1 <= self.pods <= self.m:
            raise ValueError(
                f"pods must be 0 (flat) or in [1, m={self.m}], got {self.pods}"
            )

    def pod_map(self):
        return PodMap(self.m, self.pods) if self.pods else None

    @property
    def supports_sparse(self) -> bool:
        return isinstance(self.availability, SparseAvailability)

    def schedule(self, seed: int, num_rounds: int, num_local_steps: int,
                 device: DeviceLike = None):
        """Materialize the per-round active sets and step budgets of one
        run (`sim.schedule.RoundSchedule`)."""
        from .schedule import RoundSchedule

        return RoundSchedule.build(self, seed, num_rounds, num_local_steps,
                                   device=device)

    def chunked_schedule(self, seed: int, num_rounds: int, num_local_steps: int,
                         *, chunk_rounds: int = 128, device: DeviceLike = None):
        """Lazy schedule drawing [chunk_rounds, m] blocks on demand: the
        rounds of `schedule(...)` bit for bit, O(chunk * m) memory."""
        from .schedule import ChunkedRoundSchedule

        return ChunkedRoundSchedule(self, seed, num_rounds, num_local_steps,
                                    chunk_rounds=chunk_rounds, device=device)

    def sparse_schedule(self, seed: int, num_rounds: int, num_local_steps: int,
                        device: DeviceLike = None):
        """O(active)-per-round schedule of `SparseRoundEvent`s; needs a
        `SparseAvailability` process (e.g. `UniformActiveSubset`)."""
        from .schedule import SparseRoundSchedule

        if not self.supports_sparse:
            raise TypeError(
                "sparse schedules need a SparseAvailability process, got "
                f"{type(self.availability).__name__}"
            )
        return SparseRoundSchedule(self, seed, num_rounds, num_local_steps,
                                   device=device)
