"""Synchronous federated round orchestration (port of
`repro/fed/runtime.py`, the single-host `FederatedRunner`).

`FederatedRunner` drives any round function produced by `repro_torch.core`
— the legacy constructors or the phase-split engine (`make_round`) with
any `CommStrategy` — records per-round metrics on the host, and
periodically checkpoints.  Stateful strategies (error-feedback buffers,
RNG keys) have their state initialized lazily on the first round and
threaded across rounds; build via `FederatedRunner.from_strategy` for
that path, and resume with `run(..., state=...)` from a checkpoint's
`strategy_state`.

The runner also consumes a `sim.RoundSchedule` (`run(..., schedule=...)`):
per-round active sets and local-step budgets of a seeded client
population.  Its rounds run the membership-aware elastic round
(`sim.make_elastic_round`: re-normalized weights, tracker-table
corrections, budget-gated local steps, EF re-anchoring through the
strategy's `rebase_state`; `rebase=False` is the naive-server ablation).  A
static-full schedule takes the plain loop, so full participation equals
running without a schedule bit for bit; a `SparseRoundSchedule` is
densified up to `sim.sparse.DENSE_FALLBACK_MAX_M` agents (beyond, its
O(active) runs belong to `sim.SparseElasticEngine`).

The reference jits each round into one XLA program; here the round runs
eagerly, as every round of the port does, its local updates through the
`gt_update` kernel on the card.  Each round's metrics are read as Python
floats, so a run with a `metric_fn` syncs with the device once a round,
as the reference does; an elastic round adds no other sync (its active
set, budgets and weights reach the card as one non-blocking copy).

Not ported yet (raises NotImplementedError naming its ROADMAP queue
item): the telemetry sink and its phase spans (`telemetry=`, item 11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..checkpoint import save_checkpoint
from ..core.types import tree_leaves
from ..device import not_ported

Pytree = Any

#: keyword arguments of `core.engine.make_round` that `from_strategy` forwards
_ROUND_KWARGS = ("proj_x", "proj_y", "update_fn", "constrain_agents")


@dataclasses.dataclass
class RoundStats:
    round_index: int
    metrics: Dict[str, float]
    seconds: float


class RunnerHistoryMixin:
    """Per-round history and the wire report."""

    history: List[RoundStats]
    _strategy = None
    #: remembered by `run(..., schedule=...)`, so `wire_report` defaults to
    #: the schedule the run executed
    _last_schedule = None

    def metric_series(self, name: str) -> np.ndarray:
        available = sorted({k for s in self.history for k in s.metrics})
        if name not in available:
            # also on an EMPTY history: a silent empty array for any
            # name hides typos exactly when a run produced nothing
            raise ValueError(
                f"unknown metric {name!r}; available metric keys: "
                f"{available}"
            )
        return np.array([s.metrics[name] for s in self.history])

    def wire_report(
        self,
        x: Pytree,
        y: Pytree,
        num_local_steps: int,
        schedule=None,
        pods=None,
    ) -> Dict:
        """Priced vs measured per-round communication for this runner's
        strategy: the analytic `bytes_per_round` next to the probe of the
        actual packed buffer lengths (`transport.measured_bytes_per_round`,
        headers included).  Requires a strategy-built runner.

        With a schedule (passed, or remembered from the last `run(...,
        schedule=...)`) that is not static-full, the report adds the
        active-set account of `sim.schedule_bytes`: the per-active-agent
        payload (`sim.per_agent_bytes`) and the scheduled totals; with a
        `pods` `sim.PodMap` those totals add the live pods' edge."""
        if self._strategy is None:
            raise ValueError("wire_report needs a runner built from_strategy")
        from .transport import measured_bytes_per_round

        report = {
            "bytes_per_round": int(
                self._strategy.bytes_per_round(x, y, num_local_steps)
            ),
            "measured_bytes_per_round": measured_bytes_per_round(
                self._strategy, x, y, num_local_steps
            ),
        }
        if schedule is None:
            schedule = self._last_schedule
        if schedule is not None and not getattr(schedule, "is_static_full", False):
            from ..sim.elastic import per_agent_bytes, schedule_bytes

            totals = schedule_bytes(self._strategy, x, y, num_local_steps,
                                    schedule, pods=pods)
            report["scheduled_per_agent_bytes"] = per_agent_bytes(
                self._strategy, x, y, num_local_steps)
            report["scheduled_total_bytes"] = int(np.sum(totals))
            report["scheduled_mean_bytes_per_round"] = float(np.mean(totals))
        return report

    def _drive_elastic(self, x, y, num_rounds: int, schedule, rebase: bool,
                       log_every: int, elastic_state, init_tracker_fn: Callable,
                       round_fn: Callable, checkpoint_fn: Callable,
                       num_agents: int):
        """The elastic run loop: schedule validation, the
        `ElasticAggregator`, the tracker and prev_active continuation
        (`elastic_state`: resuming without it re-anchors absent agents'
        trackers at the resume iterate and forgets who took part last
        round), per-round `n_active` metrics, history, logging and
        checkpoints.  `round_fn(x, y, ev, agg, tracker, prev_active) -> (x,
        y, tracker, active)` runs one round (`active`: its mask on the
        device, next round's prev_active)."""
        from ..sim.elastic import ElasticAggregator

        if len(schedule) < num_rounds:
            raise ValueError(
                f"schedule covers {len(schedule)} rounds, need {num_rounds}")
        if schedule.m != num_agents:
            # a larger-m schedule would renormalize weights over agents that
            # do not exist and then lose their mass: the naive failure
            raise ValueError(
                f"schedule is for m={schedule.m} agents, runner has {num_agents}")
        agg = ElasticAggregator(self._strategy, rebase=rebase)
        if elastic_state is not None:
            tracker = elastic_state["tracker"]
            prev_active = elastic_state.get("prev_active")
        else:
            tracker = init_tracker_fn(x, y)
            prev_active = None
        for t in range(num_rounds):
            t0 = time.perf_counter()
            ev = schedule[t]
            x, y, tracker, prev_active = round_fn(x, y, ev, agg, tracker,
                                                  prev_active)
            metrics = {"n_active": float(ev.num_active)}
            if self._metric_fn is not None:
                metrics.update(
                    {k: float(v) for k, v in self._metric_fn(x, y).items()})
            dt = time.perf_counter() - t0
            self.history.append(RoundStats(t, metrics, dt))
            if log_every and (t % log_every == 0 or t == num_rounds - 1):
                msg = " ".join(f"{k}={v:.3e}" for k, v in metrics.items())
                print(f"[elastic round {t:5d}] {msg} ({dt*1e3:.1f} ms)")
            checkpoint_fn(t, x, y, tracker, prev_active)
        #: where the run left off, for continuation:
        #: run(..., elastic_state=runner.elastic_state, schedule=tail)
        self.elastic_state = {"tracker": tracker, "prev_active": prev_active}
        return x, y


class FederatedRunner(RunnerHistoryMixin):
    def __init__(
        self,
        round_fn: Callable,
        agent_data: Pytree,
        metric_fn: Optional[Callable] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        strategy=None,
        elastic_round_fn: Optional[Callable] = None,
        tracker_init_fn: Optional[Callable] = None,
        telemetry=None,
    ):
        if telemetry is not None:
            raise not_ported("runner telemetry", "Queue 1 item 11")
        self._round = round_fn
        self._agent_data = agent_data
        self._metric_fn = metric_fn
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = checkpoint_every
        # non-None strategy with state => round_fn was built with
        # explicit_state=True and is called as round(x, y, data, state)
        self._strategy = strategy
        self._state: Optional[Pytree] = None
        # the membership-aware round round(x, y, data, state, tracker,
        # weights, budgets, active, prev_active) and the tracker-table
        # initializer (x, y, data) -> tracker, built by from_strategy; a
        # raw-round runner cannot run a schedule
        self._elastic = elastic_round_fn
        self._tracker_init = tracker_init_fn
        #: set by an elastic run: {"tracker", "prev_active"} where it left
        #: off (also checkpointed as "elastic_state")
        self.elastic_state: Optional[Dict] = None
        self.history: List[RoundStats] = []

    @classmethod
    def from_strategy(
        cls,
        loss: Callable,
        strategy,
        agent_data: Pytree,
        num_local_steps: int,
        eta_x: float,
        eta_y: Optional[float] = None,
        *,
        metric_fn: Optional[Callable] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        telemetry=None,
        **kwargs,
    ) -> "FederatedRunner":
        """Build the round for `strategy` (name or CommStrategy) via the
        unified engine and wrap it in a runner.  The keyword arguments of
        `make_round` (proj_x, proj_y, update_fn) go to the round; any other
        goes to `resolve_strategy` with a strategy name, so
        `from_strategy(loss, "sagda", ..., noise_sigma=0.1)` builds the
        noisy strategy (the reference passes every extra keyword to the
        round)."""
        import functools

        from ..core.engine import make_round
        from ..sim.elastic import init_tracker, make_elastic_round
        from .strategies import resolve_strategy

        if telemetry is not None:
            raise not_ported("runner telemetry and phase spans",
                             "Queue 1 item 11")
        round_kwargs = {k: v for k, v in kwargs.items() if k in _ROUND_KWARGS}
        strategy_kwargs = {k: v for k, v in kwargs.items()
                           if k not in _ROUND_KWARGS}
        if strategy_kwargs and not isinstance(strategy, str):
            raise TypeError(f"strategy knobs {sorted(strategy_kwargs)} need a "
                            "strategy name, not a built strategy")
        strategy = resolve_strategy(strategy, **strategy_kwargs)
        rnd = make_round(
            loss,
            strategy,
            num_local_steps,
            eta_x,
            eta_y,
            explicit_state=strategy.stateful,
            **round_kwargs,
        )
        elastic = make_elastic_round(
            loss, strategy, num_local_steps, eta_x, eta_y, **round_kwargs)
        return cls(
            rnd,
            agent_data,
            metric_fn=metric_fn,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            strategy=strategy,
            elastic_round_fn=elastic,
            tracker_init_fn=functools.partial(init_tracker, loss, strategy),
        )

    @property
    def _stateful(self) -> bool:
        return self._strategy is not None and getattr(
            self._strategy, "stateful", False
        )

    def run(
        self,
        x: Pytree,
        y: Pytree,
        num_rounds: int,
        log_every: int = 0,
        state: Optional[Pytree] = None,
        schedule=None,
        rebase: bool = True,
        elastic_state: Optional[Dict] = None,
    ):
        if state is not None:  # resume from a checkpointed strategy_state
            self._state = state
        if self._stateful and self._state is None:
            m = tree_leaves(self._agent_data)[0].shape[0]
            self._state = self._strategy.init_state(x, y, m)
        if schedule is not None and hasattr(schedule, "densify"):
            # a SparseRoundSchedule: this runner's round is m-dense, so it
            # densifies, up to the size where [T, m] masks defeat the
            # sparse representation (the O(active) engine's regime)
            from ..sim.sparse import DENSE_FALLBACK_MAX_M

            if schedule.m > DENSE_FALLBACK_MAX_M:
                raise ValueError(
                    f"sparse schedule over m={schedule.m} agents is too large "
                    f"to densify (> {DENSE_FALLBACK_MAX_M}); use "
                    "sim.SparseElasticEngine for O(active) runs")
            schedule = schedule.densify()
        if schedule is not None and schedule.is_static_full:
            # all agents, full budgets, every round: the plain loop below
            # is that run, bit for bit
            schedule = None
        self._last_schedule = schedule
        if schedule is not None:
            return self._run_elastic(x, y, num_rounds, schedule, rebase,
                                     log_every, elastic_state)
        for t in range(num_rounds):
            t0 = time.perf_counter()
            if self._stateful:
                x, y, self._state = self._round(
                    x, y, self._agent_data, self._state
                )
            else:
                x, y = self._round(x, y, self._agent_data)
            metrics = {}
            if self._metric_fn is not None:
                metrics = {
                    k: float(v) for k, v in self._metric_fn(x, y).items()
                }
            dt = time.perf_counter() - t0
            self.history.append(RoundStats(t, metrics, dt))
            if log_every and (t % log_every == 0 or t == num_rounds - 1):
                msg = " ".join(f"{k}={v:.3e}" for k, v in metrics.items())
                print(f"[round {t:5d}] {msg} ({dt*1e3:.1f} ms)")
            if (
                self._ckpt_dir
                and self._ckpt_every
                and (t + 1) % self._ckpt_every == 0
            ):
                payload = {"x": x, "y": y}
                if self._state is not None:
                    # resuming without this replays RNG draws / zeroes the
                    # error-feedback buffers
                    payload["strategy_state"] = self._state
                save_checkpoint(self._ckpt_dir, t + 1, payload)
        return x, y

    def _run_elastic(self, x, y, num_rounds, schedule, rebase, log_every,
                     elastic_state=None):
        """Drive `num_rounds` through the membership-aware elastic round
        (`sim.elastic`).  Checkpoints on this path carry an `elastic_state`
        entry ({"tracker", "prev_active"}) beside the strategy state:
        resume with `run(..., state=ckpt["strategy_state"],
        elastic_state=ckpt["elastic_state"], schedule=schedule.tail(t))`."""
        if self._elastic is None or self._strategy is None:
            raise ValueError("elastic schedules need a runner built via "
                             "from_strategy")
        state = self._state if self._state is not None else {}
        device = tree_leaves(x)[0].device

        def round_fn(x, y, ev, agg, tracker, prev_active):
            nonlocal state
            weights, budgets, active = agg.round_inputs(ev.active, ev.budgets,
                                                        device)
            x, y, state, tracker = self._elastic(
                x, y, self._agent_data, state, tracker, weights, budgets,
                active, agg.round_prev_active(active, prev_active))
            if self._stateful:
                self._state = state
            return x, y, tracker, active

        def checkpoint_fn(t, x, y, tracker, prev_active):
            if not (self._ckpt_dir and self._ckpt_every
                    and (t + 1) % self._ckpt_every == 0):
                return
            # resuming without elastic_state re-anchors absent agents'
            # trackers at the resume iterate and forgets the previous
            # active set
            payload = {"x": x, "y": y, "elastic_state": {
                "tracker": tracker, "prev_active": prev_active}}
            if self._stateful:
                payload["strategy_state"] = state
            save_checkpoint(self._ckpt_dir, t + 1, payload)

        return self._drive_elastic(
            x, y, num_rounds, schedule, rebase, log_every, elastic_state,
            lambda xx, yy: self._tracker_init(xx, yy, self._agent_data),
            round_fn, checkpoint_fn,
            num_agents=tree_leaves(self._agent_data)[0].shape[0])
