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

The reference jits each round into one XLA program; here the round runs
eagerly, as every round of the port does, its local updates through the
`gt_update` kernel on the card.  Each round's metrics are read as Python
floats, so a run with a `metric_fn` syncs with the device once a round,
as the reference does.

Not ported yet (each raises NotImplementedError naming its ROADMAP queue
item): elastic schedules and their checkpoints (`schedule=`,
`elastic_state=`, item 8), the telemetry sink and its phase spans
(`telemetry=`, item 11), and the pods argument of `wire_report` (item 9).
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


@dataclasses.dataclass
class RoundStats:
    round_index: int
    metrics: Dict[str, float]
    seconds: float


class RunnerHistoryMixin:
    """Per-round history and the wire report."""

    history: List[RoundStats]
    _strategy = None

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
        headers included).  Requires a strategy-built runner."""
        if self._strategy is None:
            raise ValueError("wire_report needs a runner built from_strategy")
        if schedule is not None:
            raise not_ported("the scheduled wire report", "Queue 1 item 8")
        if pods is not None:
            raise not_ported("the pod wire report", "Queue 1 item 9")
        from .transport import measured_bytes_per_round

        return {
            "bytes_per_round": int(
                self._strategy.bytes_per_round(x, y, num_local_steps)
            ),
            "measured_bytes_per_round": measured_bytes_per_round(
                self._strategy, x, y, num_local_steps
            ),
        }


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
        if elastic_round_fn is not None or tracker_init_fn is not None:
            raise not_ported("the elastic round", "Queue 1 item 8")
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
        **round_kwargs,
    ) -> "FederatedRunner":
        """Build the round for `strategy` (name or CommStrategy) via the
        unified engine and wrap it in a runner."""
        from ..core.engine import make_round
        from .strategies import resolve_strategy

        if telemetry is not None:
            raise not_ported("runner telemetry and phase spans",
                             "Queue 1 item 11")
        strategy = resolve_strategy(strategy)
        rnd = make_round(
            loss,
            strategy,
            num_local_steps,
            eta_x,
            eta_y,
            explicit_state=strategy.stateful,
            **round_kwargs,
        )
        return cls(
            rnd,
            agent_data,
            metric_fn=metric_fn,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            strategy=strategy,
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
        if schedule is not None or elastic_state is not None:
            raise not_ported("elastic schedules", "Queue 1 item 8")
        if state is not None:  # resume from a checkpointed strategy_state
            self._state = state
        if self._stateful and self._state is None:
            m = tree_leaves(self._agent_data)[0].shape[0]
            self._state = self._strategy.init_state(x, y, m)
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
