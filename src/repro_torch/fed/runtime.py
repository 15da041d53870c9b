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

The runner emits into an optional `obs.Telemetry` sink (`telemetry=...`):
per-round spans, wire-byte counters (the active-set account `wire_report`
prices) and sampled invariant probes (`obs.probes`).  `telemetry=None`
(the default) runs the code without the sink, and a sink changes no
iterate, bit for bit (tests/test_torch_obs.py): it lives on the host and
adds no sync.  `Telemetry(phase_spans=True)` runs a strategy-built
runner's round as the four engine phases one after another, each in its
span and each ended by a `torch.cuda.synchronize` on a card, so the spans
are device time; they are the phases the fused round composes, so the
iterates equal its bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..core.types import tree_leaves

Pytree = Any

#: keyword arguments of `core.engine.make_round` that `from_strategy` forwards
_ROUND_KWARGS = ("proj_x", "proj_y", "update_fn", "constrain_agents")


@dataclasses.dataclass
class RoundStats:
    round_index: int
    metrics: Dict[str, float]
    seconds: float


class RunnerHistoryMixin:
    """Per-round history, the wire report, telemetry emission and the
    elastic run loop shared by the sync and async runners."""

    history: List[RoundStats]
    _strategy = None
    #: optional `obs.Telemetry` sink, public so a test can switch it on for
    #: a built runner; None runs the code without the sink
    telemetry = None
    #: remembered by `run(..., schedule=...)`, so `wire_report` defaults to
    #: the schedule the run executed
    _last_schedule = None
    _num_local_steps: Optional[int] = None
    _loss: Optional[Callable] = None

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

    # ------------------------------------------------------- telemetry
    def _telemetry_state(self) -> Optional[Dict]:
        """The strategy-state dict probes read (EF residual buffers);
        overridden by runners that hold it elsewhere (sharded)."""
        return getattr(self, "_state", None)

    def _wire_counter_args(self, x, y, scheduled: bool = True) -> Optional[int]:
        """Per-agent payload of the "wire_bytes" counter; None without the
        strategy / K context (raw-round runners).  On a scheduled run the
        schedule sets membership, so the payload is `sim.per_agent_bytes`
        (participation 1), the account `wire_report` and
        `sim.schedule_bytes` price; unscheduled, the strategy's own client
        sampling governs and the payload is `measured_bytes_per_round`."""
        if self._strategy is None or self._num_local_steps is None:
            return None
        if scheduled:
            from ..sim.elastic import per_agent_bytes

            return per_agent_bytes(self._strategy, x, y, self._num_local_steps)
        from .transport import measured_bytes_per_round

        return int(measured_bytes_per_round(self._strategy, x, y,
                                            self._num_local_steps))

    def _emit_wire_probe(self, tm, x, y) -> None:
        """The one priced-vs-measured probe, at run start."""
        if (self._strategy is None or self._num_local_steps is None
                or not tm.probe_due("priced_vs_measured", 0)):
            return
        from ..obs import probes as _p

        tm.probe_value("priced_vs_measured", 0, _p.priced_vs_measured(
            self._strategy, x, y, self._num_local_steps))

    def _emit_probes(self, tm, t, x, y, tracker=None) -> None:
        """Sampled invariant probes of both runners (`obs.probes.emit_probes`).
        `tracker` is the elastic tracker table on an elastic round; without
        one the GT residual recomputes the anchor corrections from the loss
        (full participation)."""
        from ..core.types import grad_xy
        from ..obs.probes import anchor_corrections, emit_probes

        anchor_fn = None
        if (tracker is None and self._loss is not None
                and getattr(self._strategy, "use_correction", False)
                and getattr(self, "_agent_data", None) is not None):
            anchor_fn = lambda: anchor_corrections(grad_xy(self._loss), x, y,
                                                   self._agent_data)
        emit_probes(tm, t, x, y, self._telemetry_state, tracker, anchor_fn)

    def _drive_elastic(self, x, y, num_rounds: int, schedule, rebase: bool,
                       log_every: int, elastic_state, init_tracker_fn: Callable,
                       round_fn: Callable, checkpoint_fn: Optional[Callable],
                       num_agents: int, label: str = "elastic round"):
        """The elastic run loop of both runners: schedule validation, the
        `ElasticAggregator`, the tracker and prev_active continuation
        (`elastic_state`: resuming without it re-anchors absent agents'
        trackers at the resume iterate and forgets who took part last
        round), per-round `n_active` metrics, history, telemetry, logging
        and checkpoints.  `round_fn(x, y, ev, agg, tracker, prev_active) ->
        (x, y, tracker, active)` runs one round (`active`: its mask on the
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
        tm = self.telemetry
        per_agent = None
        if tm is not None:
            self._emit_wire_probe(tm, x, y)
            per_agent = self._wire_counter_args(x, y)
        for t in range(num_rounds):
            t0 = time.perf_counter()
            ev = schedule[t]
            if tm is not None:
                tm.begin_round(t)
            x, y, tracker, prev_active = round_fn(x, y, ev, agg, tracker,
                                                  prev_active)
            metrics = {"n_active": float(ev.num_active)}
            if self._metric_fn is not None:
                metrics.update(
                    {k: float(v) for k, v in self._metric_fn(x, y).items()})
            dt = time.perf_counter() - t0
            self.history.append(RoundStats(t, metrics, dt))
            if tm is not None:
                n = int(ev.num_active)
                tm.round_event(t, runtime=label, seconds=dt, n_active=n)
                if per_agent is not None:
                    tm.counter("wire_bytes", per_agent * n, per_agent=per_agent,
                               n_active=n)
                self._emit_probes(tm, t, x, y, tracker=tracker)
                tm.end_round(t)
            if log_every and (t % log_every == 0 or t == num_rounds - 1):
                msg = " ".join(f"{k}={v:.3e}" for k, v in metrics.items())
                print(f"[{label} {t:5d}] {msg} ({dt*1e3:.1f} ms)")
            if checkpoint_fn is not None:
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
        self._round = round_fn
        self._agent_data = agent_data
        self._metric_fn = metric_fn
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = checkpoint_every
        # non-None strategy with state => round_fn was built with
        # explicit_state=True and is called as round(x, y, data, state)
        self._strategy = strategy
        self._state: Optional[Pytree] = None
        #: obs.Telemetry sink or None (None: the code without the sink);
        #: public, so a test can switch it on for a built runner
        self.telemetry = telemetry
        # set by from_strategy: they feed the wire counters and probes, and
        # the phases that Telemetry(phase_spans=True) runs one by one (the
        # same phases the fused round composes)
        self._loss: Optional[Callable] = None
        self._num_local_steps: Optional[int] = None
        self._phases = None
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

        from ..core.engine import make_phases, round_from_phases
        from ..sim.elastic import init_tracker, make_elastic_round
        from .strategies import resolve_strategy

        round_kwargs = {k: v for k, v in kwargs.items() if k in _ROUND_KWARGS}
        strategy_kwargs = {k: v for k, v in kwargs.items()
                           if k not in _ROUND_KWARGS}
        if strategy_kwargs and not isinstance(strategy, str):
            raise TypeError(f"strategy knobs {sorted(strategy_kwargs)} need a "
                            "strategy name, not a built strategy")
        strategy = resolve_strategy(strategy, **strategy_kwargs)
        phases = make_phases(loss, strategy, num_local_steps, eta_x, eta_y,
                             **round_kwargs)
        rnd = round_from_phases(phases, explicit_state=strategy.stateful)
        elastic = make_elastic_round(
            loss, strategy, num_local_steps, eta_x, eta_y, **round_kwargs)
        runner = cls(
            rnd,
            agent_data,
            metric_fn=metric_fn,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            strategy=strategy,
            elastic_round_fn=elastic,
            tracker_init_fn=functools.partial(init_tracker, loss, strategy),
            telemetry=telemetry,
        )
        runner._loss = loss
        runner._num_local_steps = num_local_steps
        runner._phases = phases
        return runner

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
        tm = self.telemetry
        per_agent = None
        round_dispatch = None
        if tm is not None:
            self._emit_wire_probe(tm, x, y)
            per_agent = self._wire_counter_args(x, y, scheduled=False)
            if tm.phase_spans and self._phases is not None:
                round_dispatch = self._phase_round(tm)
        for t in range(num_rounds):
            t0 = time.perf_counter()
            if tm is not None:
                tm.begin_round(t)
            if round_dispatch is not None:
                x, y, new_state = round_dispatch(
                    x, y, self._agent_data,
                    self._state if self._stateful else {})
                if self._stateful:
                    self._state = new_state
            elif self._stateful:
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
            if tm is not None:
                tm.round_event(t, runtime="sync", seconds=dt)
                if per_agent is not None:
                    m = tree_leaves(self._agent_data)[0].shape[0]
                    tm.counter("wire_bytes", per_agent * m, per_agent=per_agent,
                               n_active=m)
                self._emit_probes(tm, t, x, y)
                tm.end_round(t)
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

    def _phase_round(self, tm):
        """The `Telemetry(phase_spans=True)` round: the four engine phases
        one after another, each in its span and, on a card, ended by a
        `torch.cuda.synchronize` of the iterates' device, so each span is
        the phase's device time.  The phases are the fused round's own, so
        the iterates equal its bit for bit."""
        if self._phases is None:
            raise ValueError("phase_spans needs a runner built via from_strategy")
        ph = self._phases
        device = tree_leaves(self._agent_data)[0].device

        def done(out):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return out

        def dispatch(x, y, data, state):
            with tm.span("broadcast"):
                rs = done(ph.broadcast(x, y, data, state))
            with tm.span("exchange_corrections"):
                rs = done(ph.exchange_corrections(rs, data))
            with tm.span("local_steps"):
                rs = done(ph.local_steps(rs, data))
            with tm.span("aggregate"):
                return done(ph.aggregate(rs))

        return dispatch
