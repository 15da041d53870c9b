"""Communication strategies for the round engine (port of
`repro/fed/strategies.py`: the base protocol plus FullSync, LocalOnly and
GradientTracking).

A `CommStrategy` says WHAT the agents communicate each round and HOW
local drift is corrected; `core.engine.make_round` reads only these hooks:

  sync_every_step    aggregate after EVERY local step (centralized GDA)
  use_correction     add a gradient-tracking correction to local steps
  exact_correction   correction cancels exactly at the anchor point, so
                     the fused-k0 step applies (saves one grad eval)
  correction_dtype   optional reduced storage dtype for the correction
  stateful           round carries persistent cross-round state
  init_state(x,y,m)  build that state
  sample_weights(state, m) -> (weights | None, state)
  transform_correction(cx, cy, state) -> (cx, cy, state)
  bytes_per_round(x, y, K)  analytic star-topology payload per agent

The other families of the reference (client sampling, compressed and
quantized corrections, the stochastic family) raise NotImplementedError
from `resolve_strategy`, naming their ROADMAP queue item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core.types import Pytree, tree_leaves
from ..device import not_ported

Weights = Optional[torch.Tensor]
State = dict


def _payload_bytes(tree: Pytree) -> int:
    """Dense payload bytes of one model copy (`fed/transport.py`
    `dense_payload_bytes` of the reference)."""
    return sum(u.numel() * u.element_size() for u in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class CommStrategy:
    """Base strategy: hook defaults shared by all concrete strategies."""

    name = "base"
    sync_every_step = False
    use_correction = False
    correction_dtype: Any = None

    @property
    def exact_correction(self) -> bool:
        return True

    @property
    def stateful(self) -> bool:
        return False

    def init_state(self, x: Pytree, y: Pytree, m: int) -> State:
        return {}

    def sample_weights(self, state: State, m: int) -> Tuple[Weights, State]:
        """None means exact uniform averaging over all m agents."""
        return None, state

    def transform_correction(
        self, cx: Pytree, cy: Pytree, state: State
    ) -> Tuple[Pytree, Pytree, State]:
        return cx, cy, state

    def bytes_per_round(self, x: Pytree, y: Pytree, num_local_steps: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FullSync(CommStrategy):
    """Centralized GDA: agents exchange gradients EVERY local step, so one
    'round' of K local steps costs K model up/downloads."""

    name = "full_sync"
    sync_every_step = True

    def bytes_per_round(self, x, y, num_local_steps):
        return 2 * _payload_bytes((x, y)) * num_local_steps


@dataclasses.dataclass(frozen=True)
class LocalOnly(CommStrategy):
    """Local SGDA (Deng & Mahdavi 2021): K uncorrected local steps, then
    one model up/download.  Cheap but biased for K >= 2 (Proposition 1)."""

    name = "local_only"

    def bytes_per_round(self, x, y, num_local_steps):
        return 2 * _payload_bytes((x, y))


@dataclasses.dataclass(frozen=True)
class GradientTracking(CommStrategy):
    """FedGDA-GT (Algorithm 2): one gradient exchange per round buys the
    tracking correction c_i = gbar - g_i; linear convergence to the exact
    minimax point (Theorem 1).  `correction_dtype` optionally stores c_i
    reduced (e.g. torch.float8_e4m3fn)."""

    correction_dtype: Any = None
    name = "gradient_tracking"
    use_correction = True

    def bytes_per_round(self, x, y, num_local_steps):
        # up: grad + local model; down: global grad + averaged model
        return 4 * _payload_bytes((x, y))


def _stochastic(kw) -> bool:
    """Whether the kwargs ask for a noise model (`fed/noise.py`
    `resolve_noise` of the reference: a model name or a nonzero scale)."""
    return (
        kw.get("noise") not in (None, "", "none")
        or bool(kw.get("noise_sigma"))
        or bool(kw.get("noise_fraction"))
    )


_ALIASES = {
    "gda": lambda kw: FullSync(),
    "sync_gda": lambda kw: FullSync(),
    "full_sync": lambda kw: FullSync(),
    "local_sgda": lambda kw: LocalOnly(),
    "local_only": lambda kw: LocalOnly(),
    "fedgda_gt": lambda kw: GradientTracking(
        correction_dtype=kw.get("correction_dtype"),
    ),
    "gradient_tracking": lambda kw: GradientTracking(
        correction_dtype=kw.get("correction_dtype"),
    ),
}

#: families of the reference not ported yet -> their ROADMAP item
_NOT_PORTED = {
    "partial_gt": "Queue 1 item 5",
    "partial_participation": "Queue 1 item 5",
    "compressed_gt": "Queue 1 item 5",
    "quantized_gt": "Queue 1 item 5",
    "sagda": "Queue 1 item 7",
    "local_sgda_plus": "Queue 1 item 7",
}


def resolve_strategy(spec, **kwargs) -> CommStrategy:
    """Map an algorithm name (or a ready strategy) to a CommStrategy.

    Ported names: "gda" / "sync_gda" / "full_sync", "local_sgda" /
    "local_only", "fedgda_gt" / "gradient_tracking" (kwarg
    `correction_dtype`).  The reference's other names raise
    NotImplementedError; unknown names raise ValueError."""
    if isinstance(spec, CommStrategy):
        return spec
    if isinstance(spec, str) and spec in _NOT_PORTED:
        raise not_ported(f"strategy {spec!r}", _NOT_PORTED[spec])
    if spec in ("fedgda_gt", "gradient_tracking") and _stochastic(kwargs):
        raise not_ported("stochastic gradient tracking", "Queue 1 item 7")
    try:
        factory = _ALIASES[spec]
    except (KeyError, TypeError):
        raise ValueError(f"unknown algorithm {spec!r}") from None
    return factory(kwargs)
