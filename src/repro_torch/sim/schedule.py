"""RoundSchedule: the per-round (active set, step budgets) of one run (port
of `repro/sim/schedule.py`).

A schedule is built once from (population, seed, num_rounds, K) and then
consumed by the runner.  The availability stream is a dedicated fold of
the run seed (`availability_key`), so the schedule depends only on the
population and the seed, never on how many draws another consumer of the
seed takes.  Its draws are JAX's, bit for bit, made on `device` (default
CUDA); the schedule itself is numpy on the host.

Three representations share one event contract:

  * `RoundSchedule`: the dense [T, m] materialization;
  * `ChunkedRoundSchedule`: the same rounds bit for bit, drawn lazily in
    [chunk_rounds, m] blocks from the per-round key folds, O(chunk * m)
    resident;
  * `SparseRoundSchedule`: O(active) per round, events carry the active id
    list (`SparseRoundEvent`); needs a `SparseAvailability` process, and
    `densify()` scatters it into a `RoundSchedule` for small m.

The statistics (`participation_rate`, `churn_events`, `summary_trace`)
stream over events, so they work alike for all three.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator, Optional

import numpy as np
import torch

from .. import prng
from ..device import DeviceLike, resolve_device

#: the dedicated fold of the run seed that the availability stream hangs off
AVAILABILITY_STREAM = 0x5E_D0_AC  # "seed-0-active"


def availability_key(seed: int) -> torch.Tensor:
    """The availability PRNG stream of a run: a dedicated fold of the run
    seed, so schedules are a pure function of (population, seed)."""
    return prng.fold_in(prng.PRNGKey(seed), AVAILABILITY_STREAM)


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One round's membership facts, as the runner consumes them."""

    index: int
    active: np.ndarray    # [m] bool: who participates this round
    budgets: np.ndarray   # [m] int32: local-step cap (0 where inactive)
    joined: np.ndarray    # [m] bool: newly active against the previous round
    departed: np.ndarray  # [m] bool: newly absent against the previous round
    full: bool            # all active with their full K budget

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    @property
    def churned(self) -> bool:
        return bool(self.joined.any() or self.departed.any())

    @property
    def active_ids(self) -> np.ndarray:
        """Sorted global ids of this round's active agents."""
        return np.nonzero(self.active)[0].astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SparseRoundEvent:
    """One round's membership facts in O(active): the sorted active id list
    and per-active budgets.  `prev_ids` None means a fresh start; joins and
    departures then report empty."""

    index: int
    m: int
    active_ids: np.ndarray           # [n] int64, sorted unique
    budgets: np.ndarray              # [n] int32 (>= 1), aligned to active_ids
    prev_ids: Optional[np.ndarray]   # previous round's ids, or None
    full: bool

    @property
    def num_active(self) -> int:
        return len(self.active_ids)

    @property
    def joined_ids(self) -> np.ndarray:
        if self.prev_ids is None:
            return np.empty(0, np.int64)
        return np.setdiff1d(self.active_ids, self.prev_ids)

    @property
    def departed_ids(self) -> np.ndarray:
        if self.prev_ids is None:
            return np.empty(0, np.int64)
        return np.setdiff1d(self.prev_ids, self.active_ids)

    @property
    def churned(self) -> bool:
        return self.prev_ids is not None and not np.array_equal(
            self.active_ids, self.prev_ids
        )

    def to_dense(self, num_local_steps: int) -> RoundEvent:
        """Scatter into the dense event (small m only); a None `prev_ids`
        densifies to the all-present convention of a dense round 0."""
        active = np.zeros(self.m, bool)
        active[self.active_ids] = True
        budgets = np.zeros(self.m, np.int32)
        budgets[self.active_ids] = self.budgets
        if self.prev_ids is None:
            prev = np.ones(self.m, bool)
        else:
            prev = np.zeros(self.m, bool)
            prev[self.prev_ids] = True
        return _dense_event(self.index, active, budgets, prev, num_local_steps)


def _dense_event(t: int, active, budgets, prev, num_local_steps: int) -> RoundEvent:
    """Round t's event from its rows and the row before it."""
    return RoundEvent(
        index=t, active=active, budgets=budgets,
        joined=active & ~prev, departed=prev & ~active,
        full=bool(active.all() and (budgets == num_local_steps).all()),
    )


class ScheduleStats:
    """Streaming per-round statistics shared by every schedule flavour: one
    pass over events, never [T, m].  Needs `__iter__`, `__len__`, `.m`,
    `.num_local_steps` and `.seed`."""

    def participation_rate(self) -> float:
        total = 0
        for ev in self:
            total += ev.num_active
        return total / (len(self) * self.m)

    def churn_events(self) -> int:
        """Rounds whose active set differs from the previous round's (round
        0 never counts)."""
        count = 0
        prev = None
        for ev in self:
            ids = ev.active_ids
            if prev is not None and not np.array_equal(ids, prev):
                count += 1
            prev = ids
        return count

    def summary_trace(self) -> dict:
        """Per-round membership summary without the [T, m] mask: active
        counts, budget totals and a CRC of each round's sorted active ids
        (a dense and a sparse schedule of the same rounds digest alike)."""
        n_active = np.zeros(len(self), np.int64)
        budget_total = np.zeros(len(self), np.int64)
        digest = np.zeros(len(self), np.uint32)
        for t, ev in enumerate(self):
            n_active[t] = ev.num_active
            budget_total[t] = int(np.asarray(ev.budgets).sum())
            digest[t] = zlib.crc32(np.ascontiguousarray(ev.active_ids).tobytes())
        return {
            "num_active": n_active,
            "budget_total": budget_total,
            "active_digest": digest,
            "seed": self.seed,
            "num_local_steps": self.num_local_steps,
        }


class RoundSchedule(ScheduleStats):
    """Iterator over `RoundEvent`s of one run.  `is_static_full` flags the
    degenerate all-on, no-straggler schedule: the runner given one takes
    its plain loop, so full participation equals running without a
    schedule bit for bit."""

    def __init__(self, active, budgets, num_local_steps: int, seed: int = 0,
                 population=None, prev_active=None):
        self.active = np.asarray(active, bool)
        self.budgets = np.asarray(budgets, np.int32)
        #: the active set of the round before this schedule's first; None
        #: is a fresh start (all present).  `tail()` carries the true row
        self.prev_active = (
            None if prev_active is None else np.asarray(prev_active, bool)
        )
        if self.active.shape != self.budgets.shape or self.active.ndim != 2:
            raise ValueError(
                f"active {self.active.shape} and budgets "
                f"{self.budgets.shape} must both be [num_rounds, m]"
            )
        if (self.budgets[~self.active] != 0).any():
            raise ValueError("inactive agents must have a zero step budget")
        if (self.budgets[self.active] < 1).any():
            raise ValueError("active agents need a budget of >= 1 steps")
        empty = ~self.active.any(axis=1)
        if empty.any():
            # the weights' "sum to 1 for any nonempty active set" contract
            # assumes this: an empty round would renormalize 0/0 into NaN
            raise ValueError(
                f"rounds {np.nonzero(empty)[0].tolist()} have no active "
                "agents; every round needs at least one (Population "
                "enforces min_active when building schedules)"
            )
        self.num_local_steps = int(num_local_steps)
        self.seed = int(seed)
        self.population = population

    @classmethod
    def build(cls, population, seed: int, num_rounds: int, num_local_steps: int,
              device: DeviceLike = None) -> "RoundSchedule":
        device = resolve_device(device)
        m = population.m
        k_avail, k_strag, k_force = prng.split(availability_key(seed), 3)
        # one full-range window of the primitives the chunked schedule
        # streams, so chunked == dense by construction
        active, _ = population.availability.sample_rounds(
            k_avail, m, 0, num_rounds, None, device)
        active = _force_min_active(active, population.min_active, k_force, 0,
                                   device)
        budgets = population.stragglers.budgets_rounds(
            k_strag, active, 0, num_local_steps, device)
        budgets = _clamp_budgets(active, budgets, num_local_steps)
        return cls(active, budgets, num_local_steps, seed=seed,
                   population=population)

    # ------------------------------------------------------------ access
    @property
    def num_rounds(self) -> int:
        return self.active.shape[0]

    @property
    def m(self) -> int:
        return self.active.shape[1]

    @property
    def is_static_full(self) -> bool:
        return bool(
            self.active.all() and (self.budgets == self.num_local_steps).all()
        )

    def __len__(self) -> int:
        return self.num_rounds

    def __getitem__(self, t: int) -> RoundEvent:
        if not 0 <= t < self.num_rounds:
            raise IndexError(t)
        if t > 0:
            prev = self.active[t - 1]
        elif self.prev_active is not None:
            prev = self.prev_active
        else:
            prev = np.ones((self.m,), bool)
        return _dense_event(t, self.active[t], self.budgets[t], prev,
                            self.num_local_steps)

    def __iter__(self) -> Iterator[RoundEvent]:
        return (self[t] for t in range(self.num_rounds))

    def tail(self, start: int) -> "RoundSchedule":
        """The schedule from round `start` on, for resuming a checkpointed
        elastic run (with the checkpoint's `elastic_state`); round 0 of the
        tail reports churn against the round that actually ran before it."""
        if not 0 <= start <= self.num_rounds:
            raise IndexError(start)
        return RoundSchedule(
            self.active[start:], self.budgets[start:], self.num_local_steps,
            seed=self.seed, population=self.population,
            prev_active=(self.active[start - 1] if start > 0
                         else self.prev_active),
        )

    # --------------------------------------------------------- diagnostics
    def trace(self) -> dict:
        """The full membership record (only the dense schedule has the
        [T, m] arrays; `summary_trace()` is representation-independent)."""
        return {
            "active": self.active.copy(),
            "budgets": self.budgets.copy(),
            "seed": self.seed,
            "num_local_steps": self.num_local_steps,
        }


class ChunkedRoundSchedule(ScheduleStats):
    """The rounds of `RoundSchedule.build(population, seed, ...)`, bit for
    bit, drawn lazily in [chunk_rounds, m] blocks.  A row's draw depends
    only on its absolute round index; `MarkovChurn` threads its carry
    across blocks, and random access behind the last checkpoint replays
    forward from the nearest one."""

    def __init__(self, population, seed: int, num_rounds: int,
                 num_local_steps: int, *, chunk_rounds: int = 128, start: int = 0,
                 prev_active=None, device: DeviceLike = None, _carry0=None):
        if num_rounds < 1:
            raise ValueError(f"need >= 1 round, got {num_rounds}")
        self.population = population
        self.seed = int(seed)
        self.num_local_steps = int(num_local_steps)
        self.chunk_rounds = max(1, int(chunk_rounds))
        self.device = resolve_device(device)
        self._T = int(num_rounds)
        self._start = int(start)  # absolute round of our index 0
        self.prev_active = (
            None if prev_active is None else np.asarray(prev_active, bool)
        )
        self._k_avail, self._k_strag, self._k_force = prng.split(
            availability_key(seed), 3)
        # checkpoints: absolute round -> (carry entering it, row before it)
        self._carries = {self._start: _carry0}
        self._prev_rows = {self._start: self.prev_active}
        self._cache = None  # (abs_t0, active[c, m], budgets[c, m], prev_row)

    # ------------------------------------------------------------ access
    @property
    def num_rounds(self) -> int:
        return self._T

    @property
    def m(self) -> int:
        return self.population.m

    @property
    def is_static_full(self) -> bool:
        # from the configuration: only the all-on, no-straggler population
        from .population import AlwaysOn, NoStragglers

        return isinstance(self.population.availability, AlwaysOn) and isinstance(
            self.population.stragglers, NoStragglers)

    def __len__(self) -> int:
        return self._T

    def __iter__(self) -> Iterator[RoundEvent]:
        return (self[t] for t in range(self._T))

    def __getitem__(self, t: int) -> RoundEvent:
        if not 0 <= t < self._T:
            raise IndexError(t)
        abs0, active, budgets, prev_row = self._block(t // self.chunk_rounds)
        i = t - (abs0 - self._start)
        if i > 0:
            prev = active[i - 1]
        elif prev_row is not None:
            prev = prev_row
        else:
            prev = np.ones((self.m,), bool)
        return _dense_event(t, active[i], budgets[i], prev, self.num_local_steps)

    def tail(self, start: int) -> "ChunkedRoundSchedule":
        """The rounds from `start` on, still chunked: the availability carry
        is advanced to the cut, so the tail continues the same trajectory."""
        if not 0 <= start <= self._T:
            raise IndexError(start)
        carry, prev_row = self._advance_to(self._start + start)
        return ChunkedRoundSchedule(
            self.population, self.seed, self._T - start, self.num_local_steps,
            chunk_rounds=self.chunk_rounds, start=self._start + start,
            prev_active=prev_row, device=self.device, _carry0=carry,
        )

    def materialize(self) -> RoundSchedule:
        """Densify into a `RoundSchedule` (small m only)."""
        blocks_a, blocks_b = [], []
        for b in range(-(-self._T // self.chunk_rounds)):
            _, active, budgets, _ = self._block(b)
            blocks_a.append(active)
            blocks_b.append(budgets)
        return RoundSchedule(
            np.concatenate(blocks_a), np.concatenate(blocks_b),
            self.num_local_steps, seed=self.seed, population=self.population,
            prev_active=self.prev_active,
        )

    def trace(self) -> dict:
        return self.summary_trace()

    # --------------------------------------------------------- generation
    def _sample_window(self, t0: int, t1: int, carry, with_budgets=True):
        pop = self.population
        rows, carry1 = pop.availability.sample_rounds(
            self._k_avail, pop.m, t0, t1, carry, self.device)
        rows = _force_min_active(rows, pop.min_active, self._k_force, t0,
                                 self.device)
        if not with_budgets:
            return rows, None, carry1
        budgets = pop.stragglers.budgets_rounds(
            self._k_strag, rows, t0, self.num_local_steps, self.device)
        return rows, _clamp_budgets(rows, budgets, self.num_local_steps), carry1

    def _advance_to(self, abs_t: int):
        """Carry and preceding row entering absolute round `abs_t`, replayed
        forward from the nearest checkpoint at or before it."""
        s = max(cp for cp in self._carries if cp <= abs_t)
        carry = self._carries[s]
        prev_row = self._prev_rows[s]
        while s < abs_t:
            e = min(abs_t, s + self.chunk_rounds)
            rows, _, carry = self._sample_window(s, e, carry, with_budgets=False)
            prev_row = rows[-1]
            s = e
            self._carries[s] = carry
            self._prev_rows[s] = prev_row
        return carry, prev_row

    def _block(self, b: int):
        abs0 = self._start + b * self.chunk_rounds
        abs1 = min(self._start + self._T, abs0 + self.chunk_rounds)
        if self._cache is not None and self._cache[0] == abs0:
            return self._cache
        carry, prev_row = self._advance_to(abs0)
        active, budgets, carry1 = self._sample_window(abs0, abs1, carry)
        self._carries[abs1] = carry1
        self._prev_rows[abs1] = active[-1]
        self._cache = (abs0, active, budgets, prev_row)
        return self._cache


class SparseRoundSchedule(ScheduleStats):
    """O(active)-per-round schedule: every event is a `SparseRoundEvent`
    with the active id list, drawn statelessly from the per-round fold of
    the availability stream; nothing allocates an [m] row.  `densify()`
    scatters the same draws into a dense `RoundSchedule`."""

    def __init__(self, population, seed: int, num_rounds: int,
                 num_local_steps: int, *, start: int = 0, prev_ids=None,
                 device: DeviceLike = None):
        from .population import SparseAvailability

        if not isinstance(population.availability, SparseAvailability):
            raise TypeError(
                "SparseRoundSchedule needs a SparseAvailability process, "
                f"got {type(population.availability).__name__}"
            )
        size = getattr(population.availability, "size", None)
        if size is not None and size < population.min_active:
            raise ValueError(
                f"subset size {size} is below the population's "
                f"min_active={population.min_active} floor"
            )
        if num_rounds < 1:
            raise ValueError(f"need >= 1 round, got {num_rounds}")
        self.population = population
        self.seed = int(seed)
        self.num_local_steps = int(num_local_steps)
        self.device = resolve_device(device)
        self._T = int(num_rounds)
        self._start = int(start)
        self.prev_ids = None if prev_ids is None else np.asarray(prev_ids, np.int64)
        # the dense builder's stream split; a sparse process guarantees a
        # nonempty draw itself, so the force key goes unused
        self._k_avail, self._k_strag, _ = prng.split(availability_key(seed), 3)
        self._ids_cache: dict = {}

    # ------------------------------------------------------------ access
    @property
    def num_rounds(self) -> int:
        return self._T

    @property
    def m(self) -> int:
        return self.population.m

    @property
    def is_static_full(self) -> bool:
        return False

    def __len__(self) -> int:
        return self._T

    def __iter__(self) -> Iterator[SparseRoundEvent]:
        return (self[t] for t in range(self._T))

    def _ids(self, abs_t: int) -> np.ndarray:
        ids = self._ids_cache.get(abs_t)
        if ids is None:
            ids = self.population.availability.sample_active_ids(
                self._k_avail, self.m, abs_t, self.device)
            # a sliding window: round t's ids serve as round t+1's prev
            if len(self._ids_cache) > 2:
                self._ids_cache.pop(min(self._ids_cache))
            self._ids_cache[abs_t] = ids
        return ids

    def __getitem__(self, t: int) -> SparseRoundEvent:
        if not 0 <= t < self._T:
            raise IndexError(t)
        abs_t = self._start + t
        ids = self._ids(abs_t)
        if len(ids) == 0:
            raise ValueError(f"round {t} has no active agents")
        budgets = np.clip(
            self.population.stragglers.budgets_for_ids(
                self._k_strag, ids, abs_t, self.num_local_steps, self.device),
            1, self.num_local_steps,
        ).astype(np.int32)
        prev = self._ids(abs_t - 1) if t > 0 else self.prev_ids
        return SparseRoundEvent(
            index=t, m=self.m, active_ids=ids, budgets=budgets, prev_ids=prev,
            full=bool(len(ids) == self.m
                      and (budgets == self.num_local_steps).all()),
        )

    def tail(self, start: int) -> "SparseRoundSchedule":
        """The rounds from `start` on; round 0 of the tail reports churn
        against the ids that ran before the cut."""
        if not 0 <= start <= self._T:
            raise IndexError(start)
        prev = (self._ids(self._start + start - 1) if start > 0
                else self.prev_ids)
        return SparseRoundSchedule(
            self.population, self.seed, self._T - start, self.num_local_steps,
            start=self._start + start, prev_ids=prev, device=self.device,
        )

    def densify(self) -> RoundSchedule:
        """Scatter into the dense representation (small m only): its events
        equal `ev.to_dense()` of the sparse ones by construction."""
        active = np.zeros((self._T, self.m), bool)
        budgets = np.zeros((self._T, self.m), np.int32)
        for t, ev in enumerate(self):
            active[t, ev.active_ids] = True
            budgets[t, ev.active_ids] = ev.budgets
        prev_active = None
        if self.prev_ids is not None:
            prev_active = np.zeros(self.m, bool)
            prev_active[self.prev_ids] = True
        return RoundSchedule(active, budgets, self.num_local_steps, seed=self.seed,
                             population=self.population, prev_active=prev_active)

    def trace(self) -> dict:
        return self.summary_trace()


def _force_min_active(active: np.ndarray, min_active: int, key, t0: int = 0,
                      device: DeviceLike = None) -> np.ndarray:
    """At least `min_active` agents a round: a deficient round gets its
    top-priority agents force-activated, the priorities f64 uniforms from a
    per-round fold of the schedule's own key (row t depends on its absolute
    index only) ranked by a stable double argsort, as the reference ranks
    them.  Rounds at the floor stay what the process drew (and, when no
    round is deficient, no priority is drawn: the draws would go unused)."""
    T, m = active.shape
    deficit = active.sum(axis=1) < min_active
    if not deficit.any():
        return active
    pri = prng.uniform(prng.fold_in(key, np.arange(t0, t0 + T)), (m,),
                       torch.float64, device)
    rank = torch.argsort(torch.argsort(-pri, dim=1, stable=True), dim=1, stable=True)
    forced = (rank < min_active).cpu().numpy()
    return np.where(deficit[:, None], active | forced, active)


def _clamp_budgets(active: np.ndarray, budgets, num_local_steps: int) -> np.ndarray:
    """The membership contract: 0 where inactive, in [1, K] where active."""
    b = np.clip(budgets, 1, num_local_steps)
    return np.where(active, b, 0).astype(np.int32)
