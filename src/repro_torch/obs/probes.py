"""Invariant probes: pure functions over round state, shared by every
runtime (port of `repro/obs/probes.py`).

FedGDA-GT's linear rate rests on the gradient-tracking identity
`sum_i c_i = 0` holding every round (PAPER.md, Theorem 1), error-feedback
compressors must keep their residual mass bounded, and the wire accounting
must price what the buffers carry.  Each probe is a pure function of
explicit inputs (correction stacks, tracker tables, strategy state,
iterates), so the sync, async and sparse runtimes evaluate the same
function on the state they hold, and a mismatch points at the faulty
layer.

Probe names (what runners emit under `Telemetry(probes=(...))`):

  gt_residual         ||sum_i c_i|| over both correction trees
                      (`gt_residual`, `corrections_from_table`,
                      `anchor_corrections`)
  tracker_drift       ||column-sum(dense table) - running sum||: the
                      `SparseTracker`'s running sums against the table they
                      stand for (`tracker_drift`, `sparse_tracker_table`)
  ef_residual         per-buffer norms of the strategy's error-feedback
                      state ("ex" / "ey") (`ef_residual_norms`)
  priced_vs_measured  analytic `bytes_per_round` beside the packed-buffer
                      probe (`priced_vs_measured`)
  duality_gap         a caller-supplied gap oracle at the current iterate
                      (`duality_gap`)

Probes read materialized values on the host (each is a host sync); they
never alter a round, so sampling them cannot change iterates.  Stochastic
strategies are probed with the noiseless anchor oracle, as `sim.init_tracker`
does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.types import tree_leaves, tree_map
from ..device import host_to_device

Pytree = Any


def _global_norm(*trees) -> float:
    """l2 norm over every leaf of every tree, as one scalar, accumulated on
    the host in numpy f64 (the reference's accumulation, whatever the
    leaves' dtype)."""
    total = 0.0
    for t in trees:
        for u in tree_leaves(t):
            a = u.detach().to("cpu", torch.float64).numpy()
            total += float(np.sum(np.square(a)))
    return float(np.sqrt(total))


def _vmap_agents(gfn: Callable) -> Callable:
    """gfn over agent-stacked data at one shared (x, y)."""
    return torch.func.vmap(gfn, in_dims=(None, None, 0))


# ------------------------------------------------------------ GT invariant
def gt_residual(cx: Pytree, cy: Pytree, weights=None) -> float:
    """The gradient-tracking residual `||sum_i c_i||` over both correction
    trees (weighted when `weights` is given).  Exact corrections sum to
    zero; anything above fp-reduction noise means the exchange (tracker
    table, re-anchoring, transform) broke the identity."""
    if weights is None:
        s = lambda t: tree_map(lambda u: torch.sum(u, dim=0), t)
    else:
        s = lambda t: tree_map(
            lambda u: torch.tensordot(torch.as_tensor(weights).to(u), u, dims=1), t)
    return _global_norm(s(cx), s(cy))


def corrections_from_table(tab_x: Pytree, tab_y: Pytree) -> Tuple[Pytree, Pytree]:
    """The uniform GT corrections a tracker table implies: `c_i =
    mean_j(table_j) - table_i`, the exchange identity
    `sim.elastic.tracker_exchange` builds (before any strategy transform).
    The sync and async elastic runners hold the table, the sparse engine
    materializes it through `sparse_tracker_table`."""
    sub = lambda t: tree_map(lambda u: torch.mean(u, dim=0)[None] - u, t)
    return sub(tab_x), sub(tab_y)


def anchor_corrections(gfn: Callable, x: Pytree, y: Pytree,
                       agent_data: Pytree) -> Tuple[Pytree, Pytree]:
    """The full-participation corrections at the current server iterate,
    recomputed with the noiseless oracle (`gfn = core.grad_xy(loss)`):
    `c_i = gbar - g_i(x, y)`.  The probe input of rounds without a tracker
    table."""
    g = _vmap_agents(gfn)(x, y, agent_data)
    sub = lambda t: tree_map(lambda u: torch.mean(u, dim=0)[None] - u, t)
    return sub(g.gx), sub(g.gy)


# ------------------------------------------------------- tracker vs sparse
def tracker_drift(tab_x: Pytree, tab_y: Pytree, sum_gx: Pytree,
                  sum_gy: Pytree) -> float:
    """||column-sum(table) - running sum|| over both trees: how far a
    `SparseTracker`'s incremental sums have drifted from the dense table
    they stand for (fp noise when its bookkeeping is right)."""
    diff = lambda tab, s: tree_map(lambda u, v: torch.sum(u, dim=0) - v, tab, s)
    return _global_norm(diff(tab_x, sum_gx), diff(tab_y, sum_gy))


def sparse_tracker_table(tracker, source, gfn: Callable,
                         chunk: int = 8192) -> Tuple[Pytree, Pytree]:
    """The dense tracker table a `sim.SparseTracker` stands for: touched
    agents' stored rows, untouched agents' anchor gradient recomputed at
    the tracker's init iterate (x0, y0), the noiseless oracle
    `SparseTracker.init` summed.  O(m) compute and memory in chunks of
    `chunk` ids: a probe, never a runtime path."""
    m = tracker.m
    vgrad0 = _vmap_agents(gfn)
    dev = tree_leaves(tracker.x0)[0].device
    tabs_x, tabs_y = [], []
    chunk = max(1, min(int(chunk), m))
    for lo in range(0, m, chunk):
        ids = np.arange(lo, min(lo + chunk, m), dtype=np.int64)
        touched, rows_gx, rows_gy = tracker.lookup(ids)
        g0 = vgrad0(tracker.x0, tracker.y0, source.gather(ids))
        mask = host_to_device(touched, dev)
        sel = lambda rows, anchors: tree_map(
            lambda r, a: torch.where(mask.reshape((-1,) + (1,) * (r.dim() - 1)),
                                     r, a),
            rows, anchors)
        tabs_x.append(sel(rows_gx, g0.gx))
        tabs_y.append(sel(rows_gy, g0.gy))
    cat = lambda parts: tree_map(lambda *u: torch.cat(u, dim=0), *parts)
    return cat(tabs_x), cat(tabs_y)


# ----------------------------------------------------------- EF residuals
def ef_residual_norms(state: Optional[Dict]) -> Dict[str, float]:
    """Per-buffer l2 norms of the strategy's error-feedback residuals (the
    "ex" / "ey" entries of compressing strategies); empty for strategies
    without them."""
    out: Dict[str, float] = {}
    for k in ("ex", "ey"):
        if state and k in state:
            out[k] = _global_norm(state[k])
    return out


# --------------------------------------------------------- wire accounting
def priced_vs_measured(strategy, x: Pytree, y: Pytree,
                       num_local_steps: int) -> Dict[str, int]:
    """The analytic per-round price beside the packed-buffer probe: the two
    byte accounts that must never drift apart (`fed.transport`)."""
    from ..fed.transport import measured_bytes_per_round

    return {
        "priced": int(strategy.bytes_per_round(x, y, num_local_steps)),
        "measured": int(measured_bytes_per_round(strategy, x, y,
                                                 num_local_steps)),
    }


# -------------------------------------------------------------- optimality
def duality_gap(gap_fn: Callable, x: Pytree, y: Pytree) -> float:
    """Caller-supplied duality-gap oracle at the current iterate (e.g. the
    squared distance to a known saddle of the quadratic game)."""
    return float(gap_fn(x, y))


def emit_probes(tm, t: int, x: Pytree, y: Pytree, state_fn: Callable,
                tracker: Optional[Dict] = None,
                anchor_fn: Optional[Callable] = None) -> None:
    """The sampled probes every runtime emits after round t: gt_residual
    from a tracker table {"gx", "gy"} (without one, from `anchor_fn()`'s
    recomputed anchor corrections, where given), ef_residual over
    `state_fn()`'s strategy state, and duality_gap through the sink's gap
    oracle.  Each input is read only when its probe is due."""
    if tm.probe_due("gt_residual", t):
        if tracker is not None:
            if tracker.get("gx") is not None:
                cx, cy = corrections_from_table(tracker["gx"], tracker["gy"])
                tm.probe_value("gt_residual", t, gt_residual(cx, cy))
        elif anchor_fn is not None:
            tm.probe_value("gt_residual", t, gt_residual(*anchor_fn()))
    if tm.probe_due("ef_residual", t):
        norms = ef_residual_norms(state_fn())
        if norms:
            tm.probe_value("ef_residual", t, norms)
    if tm.gap_fn is not None and tm.probe_due("duality_gap", t):
        tm.probe_value("duality_gap", t, duality_gap(tm.gap_fn, x, y))
