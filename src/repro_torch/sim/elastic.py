"""Membership-aware aggregation and gradient-tracking rebase (port of
`repro/sim/elastic.py`).

**Weights.**  A naive server keeps averaging with 1/m over the registry; on
a round where only a subset A takes part, sum_{i in A} x_i / m loses
(m - |A|)/m of the iterate's mass.  `ElasticAggregator` re-normalizes over
the active set (sum 1 for any nonempty A); `rebase=False` keeps the naive
1/m weighting, the ablation that shows the failure.

**Trackers.**  The corrections c_i = gbar - g_i cancel drift only if gbar
tracks the whole population's gradient.  The elastic round keeps a
per-agent table of each agent's last exchanged anchor gradient: active
agents re-anchor their row at the current server iterate every round,
absent agents stand in with their last row, and gbar is the full-table
mean, so the uniform corrections sum to zero every round (the GT
invariant) and FedGDA-GT keeps its exact limit under churn.

**Error feedback.**  A departed agent's EF residual describes corrections
it never applied: the strategy's `rebase_state` hook zeroes the rows of
agents that did not take part both last round and this one, inside the
round, before the transform.  Departed agents move no wire bytes
(`schedule_bytes`).

`make_elastic_round` composes the engine's phases (`core.engine`) with the
tracker-table exchange:

    round(x, y, agent_data, state, tracker, weights, budgets, active,
          prev_active) -> (x1, y1, state, tracker)

The round runs eagerly on the iterates' device, through the same kernels
as the static round: `gt_update` on every gated local step (its output is
a fresh tensor, so the select after it is exact), `compress_correction` or
`pack_payload` / `unpack_payload` in the strategy's transform.  The gates
add one select per leaf per step (`core.engine.agent_where`).  Absent
agents still compute their anchor gradient, as in the reference, and the
table keeps their old rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.engine import (
    RoundPhases,
    agent_mean,
    agent_where,
    make_phases,
    renormalized_weights,
    tracking_corrections,
)
from ..core.types import (
    LossFn,
    Pytree,
    identity_proj,
    tree_broadcast_agents,
    tree_leaves,
    vmap_grad_xy,
)
from ..device import DeviceLike, host_to_device, resolve_device


def init_tracker(loss: LossFn, strategy, x: Pytree, y: Pytree,
                 agent_data: Pytree) -> dict:
    """The tracker table at round 0: every agent's anchor gradient at the
    initial server iterate (every agent starts freshly re-anchored, as a
    joiner does later).  Strategies without corrections carry no table
    ({}).  Noiseless even for stochastic strategies, as in the reference."""
    if not getattr(strategy, "use_correction", False):
        return {}
    m = tree_leaves(agent_data)[0].shape[0]
    g = vmap_grad_xy(loss)(tree_broadcast_agents(x, m),
                           tree_broadcast_agents(y, m), agent_data)
    return {"gx": g.gx, "gy": g.gy}


def tracker_exchange(strategy, gx, gy, state, active, tab_x, tab_y, cdt=None,
                     prev_active=None):
    """The membership-aware exchange: active agents re-anchor their tracker
    row with their fresh anchor gradient, absent agents keep their last
    row, gbar is the full-table mean, then the strategy's transform (and a
    wire payload's decode) runs as on the all-present path.

    `prev_active` not None first re-anchors the strategy's
    membership-dependent state (EF residual rows) through its
    `rebase_state` hook; None is the naive no-rebase ablation.

    Returns (cx, cy, gbar_x, gbar_y, state, tab_x, tab_y)."""
    if prev_active is not None:
        hook = getattr(strategy, "rebase_state", None)
        if hook is not None and state:
            state = hook(state, active, prev_active)
    tab_x = agent_where(active, gx, tab_x)
    tab_y = agent_where(active, gy, tab_y)
    gbar_x = agent_mean(tab_x, None)
    gbar_y = agent_mean(tab_y, None)
    cx, cy = tracking_corrections(tab_x, tab_y, gbar_x, gbar_y, cdt)
    cx, cy, state = strategy.transform_correction(cx, cy, state)
    if hasattr(cx, "decode"):
        cx = cx.decode()
    if hasattr(cy, "decode"):
        cy = cy.decode()
    return cx, cy, gbar_x, gbar_y, state, tab_x, tab_y


@dataclasses.dataclass
class ElasticAggregator:
    """Membership-aware server policy of one run.

    rebase=True   re-normalized weights and tracker / EF re-anchoring;
    rebase=False  the naive-server ablation: 1/m weights over the whole
                  registry and stale EF residuals."""

    strategy: Any
    rebase: bool = True

    def weights(self, active) -> torch.Tensor:
        """f64 weights of a [m] mask (JAX's default float under x64)."""
        active = torch.as_tensor(active)
        if self.rebase:
            return renormalized_weights(active)
        return active.to(torch.float64) / active.shape[0]

    def round_inputs(self, active: np.ndarray, budgets: np.ndarray,
                     device: DeviceLike = None):
        """(weights, budgets, active) of one round on `device` (default
        CUDA) from the event's host arrays: f64 weights (`weights`, formed
        on the host), int64 budgets and the bool mask travel as one buffer,
        one pinned, non-blocking copy, and come apart as views."""
        device = resolve_device(device)
        active = np.asarray(active, bool)
        m = active.shape[0]
        a = active.astype(np.float64)
        w = a / a.sum() if self.rebase else a / m
        buf = np.empty(17 * m, np.uint8)
        buf[:8 * m].view(np.float64)[:] = w
        buf[8 * m:16 * m].view(np.int64)[:] = budgets
        buf[16 * m:] = active
        t = host_to_device(buf, device)
        return (t[:8 * m].view(torch.float64), t[8 * m:16 * m].view(torch.int64),
                t[16 * m:].view(torch.bool))

    def rebase_state(self, state, active, prev_active=None):
        """Re-anchor the strategy's membership-dependent state (EF residual
        rows) for this round's active set, eagerly (the runner does it
        inside the round, through `tracker_exchange`)."""
        if not self.rebase or not state:
            return state
        hook = getattr(self.strategy, "rebase_state", None)
        if hook is None:
            return state
        return hook(state, active, prev_active)

    def round_prev_active(self, active, prev_active):
        """What `tracker_exchange`'s rebase gets: None when rebasing is off,
        the previous round's active set when continuing, and all-present on
        the very first round (fresh EF buffers are zero, so keep = active
        is the from-scratch semantics)."""
        if not self.rebase:
            return None
        if prev_active is not None:
            return prev_active
        return torch.ones_like(active)


def make_elastic_round(
    loss: LossFn,
    strategy,
    num_local_steps: int,
    eta_x: float,
    eta_y: Optional[float] = None,
    *,
    proj_x: Callable = identity_proj,
    proj_y: Callable = identity_proj,
    update_fn: Optional[Callable] = None,
    constrain_agents: Optional[Callable] = None,
) -> Callable:
    """The membership-aware round of `strategy`:

        round(x, y, agent_data, state, tracker, weights, budgets, active,
              prev_active) -> (x1, y1, state, tracker)

    `weights`, `budgets` and `active` come from
    `ElasticAggregator.round_inputs`, `prev_active` from
    `ElasticAggregator.round_prev_active` (None: the no-rebase ablation),
    `tracker` from `init_tracker` ({} without corrections).  The phases are
    the engine's own (`update_fn` defaults to the `gt_update` kernel); only
    the exchange differs: the tracker table replaces the all-present anchor
    exchange.  Strategies without corrections (FullSync included) skip it,
    and membership enters through weights and budgets alone."""
    phases: RoundPhases = make_phases(
        loss, strategy, num_local_steps, eta_x, eta_y, proj_x=proj_x,
        proj_y=proj_y, update_fn=update_fn, constrain_agents=constrain_agents,
    )
    use_corr = bool(getattr(strategy, "use_correction", False))
    cdt = getattr(strategy, "correction_dtype", None)
    noise = getattr(strategy, "noise", None)
    momentum = float(getattr(strategy, "momentum", 0.0) or 0.0)
    vgrad = vmap_grad_xy(loss)

    def elastic_round(x, y, agent_data, state, tracker, weights, budgets,
                      active, prev_active):
        rs = phases.broadcast(x, y, agent_data, state, weights=weights,
                              step_budgets=budgets, active=active)
        if use_corr:
            # the anchor gradients at the broadcast iterate (a stochastic
            # strategy's at eval index 0 of the round's draws); absent
            # agents' rows are discarded in favour of their table rows
            if rs.noise_draws is None:
                g = vgrad(rs.xs, rs.ys, agent_data)
            else:
                g = noise.apply(vgrad, rs.noise_draws[0], rs.xs, rs.ys, agent_data)
            cx, cy, gbar_x, gbar_y, state, tab_x, tab_y = tracker_exchange(
                strategy, g.gx, g.gy, rs.state, active, tracker["gx"],
                tracker["gy"], cdt, prev_active)
            rs = dataclasses.replace(
                rs, cx=cx, cy=cy, gbar_x=gbar_x, gbar_y=gbar_y,
                fused=bool(strategy.exact_correction) and not momentum,
                state=state,
            )
            tracker = {"gx": tab_x, "gy": tab_y}
        rs = phases.local_steps(rs, agent_data)
        x1, y1, state = phases.aggregate(rs)
        return x1, y1, state, tracker

    return elastic_round


def per_agent_bytes(strategy, x: Pytree, y: Pytree, num_local_steps: int, *,
                    measured: bool = True) -> int:
    """One active agent's payload a round under an external schedule (the
    packed buffers' bytes by default, the analytic price with
    measured=False).  Membership comes from the schedule, bypassing the
    strategy's own client sampling, so the price is taken at
    participation 1 (a participation-discounted price would discount
    twice)."""
    from ..fed.transport import measured_bytes_per_round

    if getattr(strategy, "participation", 1.0) < 1.0:
        strategy = dataclasses.replace(strategy, participation=1.0)
    return (int(measured_bytes_per_round(strategy, x, y, num_local_steps))
            if measured else int(strategy.bytes_per_round(x, y, num_local_steps)))


def schedule_bytes(strategy, x: Pytree, y: Pytree, num_local_steps: int,
                   schedule, *, measured: bool = True, pods=None) -> list:
    """Per-round total wire bytes of a run under `schedule`: the per-agent
    payload (`per_agent_bytes`) times the round's active count (departed
    agents move nothing), streamed over the events, so dense, chunked and
    sparse schedules price alike.

    With a `pods` `sim.PodMap` the two-level tree adds the pod edge: each
    LIVE pod (>= 1 active agent) moves one partial payload up and one
    broadcast down a round (`fed.pods.pod_payload_bytes`), and the
    per-agent payloads become agent <-> pod traffic."""
    per_agent = per_agent_bytes(strategy, x, y, num_local_steps,
                                measured=measured)
    per_pod = 0
    if pods is not None:
        from ..fed.pods import pod_payload_bytes

        per_pod = pod_payload_bytes(x, y, measured=measured)
    totals = []
    for ev in schedule:
        total = per_agent * ev.num_active
        if pods is not None:
            total += per_pod * len(pods.live_pods(ev.active_ids))
        totals.append(total)
    return totals
