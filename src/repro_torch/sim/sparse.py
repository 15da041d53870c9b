"""O(active) elastic execution: sparse tracker state and the sparse round
(port of `repro/sim/sparse.py`).

The dense elastic path (`sim.elastic`) carries one row per POPULATION
member: the tracker table, the broadcast stacks, the EF buffers.  Here
everything scales with the ACTIVE set:

**SparseTracker.**  gbar is the dense tracker table's MEAN, and only active
agents' rows change in a round.  So the tracker is (a) the running SUM of
the full table (gradient-shaped, on the device), (b) explicit rows only for
agents that have been active since init ("touched"; a numpy K/V store on
the host, as in the reference), and (c) the anchor iterate (x0, y0) at
which every untouched agent's row is its init-time anchor gradient,
recomputed from its data when needed.  A round adds sum_active (g_new -
g_old) to the sum and stores the active rows; gbar = sum / m equals the
dense table's mean up to summation order.

**SparseElasticEngine.**  Drives `SparseRoundSchedule`s through rounds
whose shapes are [n_active, ...]: data rows are gathered from an
`AgentDataSource` (dense arrays, or synthesized per id for populations too
large to hold), strategy EF rows are re-gathered between rounds
(`CommStrategy.realign_state_rows`), and noise keys fold GLOBAL agent ids
(`broadcast(..., active_indices=ids)`), so an agent's draws do not depend
on the layout.  With a `sim.PodMap` the aggregate is the two-level tree
(`core.engine.pod_weighted_sums` -> `pods_total`); `wire_pods` also packs
the live pods' partials (`fed.pods.encode_pod_partials`, dense payloads
through the `pack_payload` kernel on the card) and records their bytes.
The rounds run eagerly, through the same kernels as every round of the
port: `gt_update` in the local steps, `compress_correction` or
`pack_payload` / `unpack_payload` in a compressor's transform.

**Dense fallback.**  For m <= `dense_fallback_max_m` the engine densifies
the schedule and runs the dense elastic machinery (`FederatedRunner` and
`sim.make_elastic_round`): bitwise a dense elastic run.  The sparse path
matches it to fp tolerance (only summation orders differ).

Each round of the sparse path syncs the host with the device where the
reference does: the touched rows come back to the host store (`commit`),
and a metric is read as floats.

With an `obs.Telemetry` sink (`telemetry=`) the engine emits the
`dense_fallback` event of each run, per sparse round a "sparse" round span
(active count, live pods, pod wire bytes), the `realign` event of the EF
rows and the wire-bytes counter, and the sampled probes; the GT and
tracker-drift probes materialize the dense table the tracker stands for
(`obs.probes.sparse_tracker_table`, O(m): a probe cost only).  The dense
fallback hands the sink to its runner.  A sink changes no iterate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.engine import (
    RoundPhases,
    agent_where,
    make_phases,
    pod_weighted_sums,
    pods_total,
    renormalized_weights,
    tracking_corrections,
)
from ..core.types import (
    LossFn,
    Pytree,
    grad_xy,
    identity_proj,
    tree_broadcast_agents,
    tree_flatten,
    tree_leaves,
    tree_map,
    vmap_grad_xy,
)
from ..device import host_to_device

#: populations at or below this size run densified through the dense
#: elastic machinery; above it the O(active) path applies
DENSE_FALLBACK_MAX_M = 4096


def _device_of(tree: Pytree) -> torch.device:
    return tree_leaves(tree)[0].device


# ----------------------------------------------------------- data sources
class AgentDataSource:
    """O(active) access to per-agent data: the sparse round gathers only
    the active agents' rows, so a huge population's data never needs to
    exist as one [m, ...] stack."""

    m: int

    def gather(self, ids: np.ndarray) -> Pytree:
        """Rows (leading axis len(ids)) for the given GLOBAL ids."""
        raise NotImplementedError


class ArrayDataSource(AgentDataSource):
    """Dense [m, ...] per-agent tensors as a source (simulation scale); a
    gather copies the rows, as the reference's `take` does."""

    def __init__(self, agent_data: Pytree):
        self.agent_data = agent_data
        self.m = int(tree_leaves(agent_data)[0].shape[0])

    def gather(self, ids):
        idx = host_to_device(np.asarray(ids, np.int64), _device_of(self.agent_data))
        return tree_map(lambda u: torch.index_select(u, 0, idx), self.agent_data)

    def materialize(self) -> Pytree:
        return self.agent_data


class SyntheticDataSource(AgentDataSource):
    """Per-agent data synthesized from the global id on demand:
    `row_fn(ids[n]) -> rows [n, ...]` (ids as host int64) must be a pure
    function of the ids (typically a fold of a data key), so any subset of
    agents can be made at any time in O(n) memory."""

    def __init__(self, m: int, row_fn: Callable):
        self.m = int(m)
        self._row_fn = row_fn

    def gather(self, ids):
        return self._row_fn(np.asarray(ids, np.int64))

    def materialize(self) -> Pytree:
        # dense fallback and tests only: deliberately O(m)
        return self.gather(np.arange(self.m, dtype=np.int64))


# ---------------------------------------------------------- sparse tracker
class SparseTracker:
    """Running-sum plus touched-rows form of the dense tracker table (module
    docstring).  The sums stay on the device; the rows live on the host
    (numpy), a per-agent K/V store rather than a tensor a round scans."""

    def __init__(self, m: int, sum_gx: Pytree, sum_gy: Pytree,
                 x0: Pytree, y0: Pytree):
        self.m = int(m)
        self.sum_gx = sum_gx
        self.sum_gy = sum_gy
        self.x0 = x0
        self.y0 = y0
        self._index: Dict[int, int] = {}
        self._gx_leaves: Optional[List[np.ndarray]] = None
        self._gy_leaves: Optional[List[np.ndarray]] = None
        self._gx_def = None
        self._gy_def = None
        self._cap = 0
        self._n = 0

    @classmethod
    def init(cls, loss: LossFn, x0: Pytree, y0: Pytree, source: AgentDataSource,
             chunk: int = 8192) -> "SparseTracker":
        """sum_i g_i(x0, y0) over ALL m agents, in id chunks: O(m) compute
        once, O(chunk) resident memory, never an [m, ...] stack.  Equal
        chunks, then the remainder, summed in the reference's order."""
        vgrad = vmap_grad_xy(loss)

        def chunk_sums(data):
            n = tree_leaves(data)[0].shape[0]
            g = vgrad(tree_broadcast_agents(x0, n), tree_broadcast_agents(y0, n),
                      data)
            s = lambda t: tree_map(lambda u: torch.sum(u, dim=0), t)
            return s(g.gx), s(g.gy)

        m = source.m
        chunk = max(1, min(chunk, m))
        sum_gx = sum_gy = None
        add = lambda a, b: b if a is None else tree_map(torch.add, a, b)
        bounds = [(lo, lo + chunk) for lo in range(0, m - m % chunk, chunk)]
        if m % chunk:
            bounds.append((m - m % chunk, m))
        for lo, hi in bounds:
            sx, sy = chunk_sums(source.gather(np.arange(lo, hi, dtype=np.int64)))
            sum_gx, sum_gy = add(sum_gx, sx), add(sum_gy, sy)
        return cls(m, sum_gx, sum_gy, x0, y0)

    @property
    def num_touched(self) -> int:
        return self._n

    def lookup(self, ids: np.ndarray):
        """(touched [n] bool numpy, rows_gx, rows_gy) for the given ids, the
        rows on the iterates' device; rows of never-touched agents are
        zeros (the round replaces them with the recomputed anchor
        gradient)."""
        ids = np.asarray(ids)
        pos = np.array([self._index.get(int(i), -1) for i in ids], np.int64)
        touched = pos >= 0
        safe = np.where(touched, pos, 0)
        n = len(ids)

        def take(leaves, unflatten, like):
            if leaves is None:
                return tree_map(
                    lambda u: torch.zeros((n,) + tuple(u.shape), dtype=u.dtype,
                                          device=u.device), like)
            dev = _device_of(like)
            rows = []
            for leaf in leaves:
                r = leaf[safe]
                r[~touched] = 0
                rows.append(host_to_device(r, dev))
            return unflatten(rows)

        return (touched, take(self._gx_leaves, self._gx_def, self.x0),
                take(self._gy_leaves, self._gy_def, self.y0))

    def commit(self, ids: np.ndarray, new_gx: Pytree, new_gy: Pytree,
               sum_gx: Pytree, sum_gy: Pytree) -> None:
        """Store this round's fresh anchor rows (copied to the host) and
        adopt the running sums the round computed."""
        gx_leaves, gx_def = tree_flatten(new_gx)
        gy_leaves, gy_def = tree_flatten(new_gy)
        gx_np = [u.cpu().numpy() for u in gx_leaves]
        gy_np = [u.cpu().numpy() for u in gy_leaves]
        if self._gx_leaves is None:
            self._gx_def, self._gy_def = gx_def, gy_def
            self._gx_leaves = [np.empty((0,) + u.shape[1:], u.dtype) for u in gx_np]
            self._gy_leaves = [np.empty((0,) + u.shape[1:], u.dtype) for u in gy_np]
        # assign row slots (growing geometrically on demand)
        pos = np.empty(len(ids), np.int64)
        for j, i in enumerate(np.asarray(ids)):
            i = int(i)
            p = self._index.get(i)
            if p is None:
                p = self._n
                self._index[i] = p
                self._n += 1
            pos[j] = p
        if self._n > self._cap:
            new_cap = max(16, self._cap * 2, self._n)
            grow = lambda leaves: [
                np.concatenate([u, np.empty((new_cap - len(u),) + u.shape[1:],
                                            u.dtype)])
                for u in leaves]
            self._gx_leaves = grow(self._gx_leaves)
            self._gy_leaves = grow(self._gy_leaves)
            self._cap = new_cap
        for store, rows in zip(self._gx_leaves, gx_np):
            store[pos] = rows
        for store, rows in zip(self._gy_leaves, gy_np):
            store[pos] = rows
        self.sum_gx, self.sum_gy = sum_gx, sum_gy


# ----------------------------------------------------------- sparse engine
class SparseElasticEngine:
    """The O(active) driver of `SparseRoundSchedule`s (module docstring).

    Always membership-aware (1/n_active weights, the tracker's running-sum
    exchange, EF row realignment); the naive-server `rebase=False` ablation
    exists only on the dense path.

    `update_fn` (default the `gt_update` kernel) is the corrected local
    step, as in `core.engine.make_phases`; `use_kernel` (default True)
    packs the pod partials through `pack_payload` on the card (False: its
    plain version), so `update_fn=core.default_update, use_kernel=False`
    with a strategy's own `use_kernel=False` is the plain path."""

    def __init__(
        self,
        loss: LossFn,
        strategy,
        source: AgentDataSource,
        num_local_steps: int,
        eta_x: float,
        eta_y: Optional[float] = None,
        *,
        proj_x: Callable = identity_proj,
        proj_y: Callable = identity_proj,
        pod_map=None,
        wire_pods: bool = False,
        metric_fn: Optional[Callable] = None,
        init_chunk: int = 8192,
        dense_fallback_max_m: int = DENSE_FALLBACK_MAX_M,
        telemetry=None,
        update_fn: Optional[Callable] = None,
        use_kernel: bool = True,
    ):
        from ..fed.strategies import resolve_strategy

        self._loss = loss
        #: obs.Telemetry sink or None (None: the code without the sink)
        self.telemetry = telemetry
        self._strategy = resolve_strategy(strategy)
        self._source = source
        self._K = int(num_local_steps)
        self._eta_x = eta_x
        self._eta_y = eta_x if eta_y is None else eta_y
        self._proj_x = proj_x
        self._proj_y = proj_y
        self._pods = pod_map
        self._wire_pods = bool(wire_pods)
        if self._wire_pods and pod_map is None:
            raise ValueError("wire_pods needs a pod_map")
        self._metric_fn = metric_fn
        self._init_chunk = int(init_chunk)
        self._fallback_m = int(dense_fallback_max_m)
        self._update_fn = update_fn
        self._use_kernel = bool(use_kernel)
        self._use_corr = bool(getattr(self._strategy, "use_correction", False))
        self._phases: RoundPhases = make_phases(
            loss, self._strategy, self._K, self._eta_x, self._eta_y,
            proj_x=proj_x, proj_y=proj_y, update_fn=update_fn,
        )
        self._vgrad = vmap_grad_xy(loss)
        self._noise = getattr(self._strategy, "noise", None)
        self._momentum = float(getattr(self._strategy, "momentum", 0.0) or 0.0)
        # cross-run continuation (resume=True)
        self._tracker: Optional[SparseTracker] = None
        self._state: Optional[Pytree] = None
        self._prev_ids: Optional[np.ndarray] = None
        self._dense_runner = None
        self.history: List[Dict] = []
        #: the last sparse round's live-pod partials and their packed
        #: payload (with `wire_pods`), for a round-trip check
        self.last_pod_wire = None

    def resume_from(self, tracker: SparseTracker, state: Optional[Pytree] = None,
                    prev_ids=None) -> None:
        """Adopt another run's continuation (its tracker, strategy state and
        last round's ids; `convert.sparse_tracker_from_numpy` carries a JAX
        run's), so `run(..., schedule.tail(t), resume=True)` continues it."""
        self._tracker = tracker
        self._state = state
        self._prev_ids = None if prev_ids is None else np.asarray(prev_ids, np.int64)

    # ----------------------------------------------------- round program
    def _round_program(self, x, y, data, ids, budgets, touched, st_gx, st_gy,
                       sum_gx, sum_gy, state, pod_ids, x0, y0):
        """One sparse round over the n active rows of `data`."""
        n = tree_leaves(data)[0].shape[0]
        active = torch.ones((n,), dtype=torch.bool, device=_device_of(x))
        weights = renormalized_weights(active)
        rs = self._phases.broadcast(
            x, y, data, state, weights=weights, step_budgets=budgets,
            active=active, active_indices=ids,
        )
        new_gx = new_gy = None
        if self._use_corr:
            if rs.noise_draws is None:
                g = self._vgrad(rs.xs, rs.ys, data)
            else:
                g = self._noise.apply(self._vgrad, rs.noise_draws[0], rs.xs,
                                      rs.ys, data)
            # an untouched agent's last table row is its init anchor
            # gradient: recompute it at (x0, y0) (noiseless, as the init)
            # and select it under the mask
            g0 = self._vgrad(tree_broadcast_agents(x0, n),
                             tree_broadcast_agents(y0, n), data)
            old_gx = agent_where(touched, st_gx, g0.gx)
            old_gy = agent_where(touched, st_gy, g0.gy)
            upd = lambda s, gn, go: tree_map(
                lambda sv, nv, ov: sv + torch.sum(nv - ov, dim=0).to(sv.dtype),
                s, gn, go)
            sum_gx = upd(sum_gx, g.gx, old_gx)
            sum_gy = upd(sum_gy, g.gy, old_gy)
            m = self._source.m
            gbar_x = tree_map(lambda s: s / m, sum_gx)
            gbar_y = tree_map(lambda s: s / m, sum_gy)
            cdt = getattr(self._strategy, "correction_dtype", None)
            cx, cy = tracking_corrections(g.gx, g.gy, gbar_x, gbar_y, cdt)
            cx, cy, state2 = self._strategy.transform_correction(cx, cy, rs.state)
            from ..fed.transport import decode_corrections

            cx, cy = decode_corrections(cx, cy)
            rs = dataclasses.replace(
                rs, cx=cx, cy=cy, gbar_x=gbar_x, gbar_y=gbar_y,
                fused=bool(self._strategy.exact_correction) and not self._momentum,
                state=state2,
            )
            new_gx, new_gy = g.gx, g.gy
        else:
            rs = self._phases.exchange_corrections(rs, data)
        rs = self._phases.local_steps(rs, data)
        pod_px = pod_py = None
        if self._pods is not None and not getattr(
                self._strategy, "sync_every_step", False):
            # agent rows -> per-pod partial weighted sums -> server total
            pod_px = pod_weighted_sums(rs.xs, rs.weights, pod_ids,
                                       self._pods.num_pods)
            pod_py = pod_weighted_sums(rs.ys, rs.weights, pod_ids,
                                       self._pods.num_pods)
            x1 = self._proj_x(pods_total(pod_px))
            y1 = self._proj_y(pods_total(pod_py))
            state3 = rs.state
        else:
            x1, y1, state3 = self._phases.aggregate(rs)
        return (x1, y1, state3, new_gx, new_gy, sum_gx, sum_gy, pod_px, pod_py)

    # --------------------------------------------------------------- run
    def run(self, x, y, schedule, num_rounds: Optional[int] = None,
            log_every: int = 0, resume: bool = False):
        """Drive `num_rounds` (default: all) of `schedule`.  `resume=True`
        continues the engine's previous run (tracker sums and rows,
        strategy state, previous ids): pass `schedule.tail(t)`."""
        T = len(schedule) if num_rounds is None else int(num_rounds)
        if len(schedule) < T:
            raise ValueError(f"schedule covers {len(schedule)} rounds, need {T}")
        if schedule.m != self._source.m:
            raise ValueError(f"schedule is for m={schedule.m}, source has "
                             f"{self._source.m}")
        dense = bool(self._fallback_m and self._source.m <= self._fallback_m
                     and hasattr(schedule, "densify")
                     and hasattr(self._source, "materialize"))
        if self.telemetry is not None:
            self.telemetry.emit("event", "dense_fallback", round=None,
                                value=dense, m=self._source.m,
                                max_m=self._fallback_m)
        if dense:
            return self._run_dense(x, y, schedule, T, log_every, resume)
        return self._run_sparse(x, y, schedule, T, log_every, resume)

    def _run_dense(self, x, y, schedule, T, log_every, resume):
        """Small m: densify and run the dense elastic machinery
        (`FederatedRunner` + `make_elastic_round`), bitwise a dense elastic
        run."""
        from ..fed.runtime import FederatedRunner

        if self._dense_runner is None:
            self._dense_runner = FederatedRunner.from_strategy(
                self._loss, self._strategy, self._source.materialize(),
                self._K, self._eta_x, self._eta_y, metric_fn=self._metric_fn,
                proj_x=self._proj_x, proj_y=self._proj_y,
                update_fn=self._update_fn,
            )
        runner = self._dense_runner
        # every call, so a sink switched on for the engine reaches a runner
        # built before
        runner.telemetry = self.telemetry
        prev_n = len(runner.history)
        x, y = runner.run(
            x, y, T, log_every=log_every, schedule=schedule.densify(),
            elastic_state=runner.elastic_state if resume else None,
        )
        for s in runner.history[prev_n:]:
            self.history.append({"round": s.round_index, "path": "dense-fallback",
                                 **s.metrics})
        return x, y

    def _run_sparse(self, x, y, schedule, T, log_every, resume):
        from ..fed.pods import encode_pod_partials

        strategy = self._strategy
        dev = _device_of(x)
        tm = self.telemetry
        per_agent = None
        if tm is not None:
            from ..obs import probes as _p
            from .elastic import per_agent_bytes

            if tm.probe_due("priced_vs_measured", 0):
                tm.probe_value("priced_vs_measured", 0,
                               _p.priced_vs_measured(strategy, x, y, self._K))
            # the per-active-agent payload, as schedule_bytes and the
            # runners' wire_report price it
            per_agent = per_agent_bytes(strategy, x, y, self._K)
        if resume and self._tracker is None:
            raise ValueError("resume=True but no previous sparse run")
        if not resume:
            self._tracker = (
                SparseTracker.init(self._loss, x, y, self._source,
                                   self._init_chunk)
                if self._use_corr
                else SparseTracker(self._source.m, tree_map(torch.zeros_like, x),
                                   tree_map(torch.zeros_like, y), x, y))
            self._state = None
            self._prev_ids = None
        tracker = self._tracker
        for t in range(T):
            t0 = time.perf_counter()
            ev = schedule[t]
            ids = ev.active_ids
            n = len(ids)
            if tm is not None:
                tm.begin_round(t)
            data = self._source.gather(ids)
            if self._state is None:
                self._state = (strategy.init_state(x, y, n)
                               if getattr(strategy, "stateful", False) else {})
            else:
                # continuing agents keep their per-agent state rows (EF
                # residuals), everyone else restarts at zero: the dense
                # rebase rule over id lists
                self._state = strategy.realign_state_rows(self._state,
                                                          self._prev_ids, ids)
                if tm is not None:
                    tm.emit("event", "realign",
                            n_continuing=int(len(np.intersect1d(self._prev_ids,
                                                                ids))),
                            n_active=n)
            touched, st_gx, st_gy = tracker.lookup(ids)
            pod_ids = (self._pods.pod_of(ids) if self._pods is not None
                       else np.zeros(n, np.int64))
            (x, y, self._state, new_gx, new_gy, sum_gx, sum_gy, pod_px,
             pod_py) = self._round_program(
                x, y, data, ids, host_to_device(ev.budgets, dev),
                host_to_device(touched, dev), st_gx, st_gy, tracker.sum_gx,
                tracker.sum_gy, self._state, pod_ids, tracker.x0, tracker.y0)
            if self._use_corr:
                tracker.commit(ids, new_gx, new_gy, sum_gx, sum_gy)
            rec = {"round": t, "path": "sparse", "n_active": n}
            if self._pods is not None:
                live = self._pods.live_pods(ids)
                rec["live_pods"] = len(live)
                if self._wire_pods and pod_px is not None:
                    rows = host_to_device(live, dev)
                    partials = tree_map(lambda u: torch.index_select(u, 0, rows),
                                        (pod_px, pod_py))
                    packed = encode_pod_partials(partials,
                                                 use_kernel=self._use_kernel)
                    rec["pod_wire_bytes"] = packed.total_bytes()
                    self.last_pod_wire = (partials, packed)
            if self._metric_fn is not None:
                rec.update({k: float(v) for k, v in self._metric_fn(x, y).items()})
            rec["seconds"] = time.perf_counter() - t0
            self.history.append(rec)
            if tm is not None:
                tm.round_event(t, runtime="sparse", seconds=rec["seconds"],
                               n_active=n, **{k: rec[k] for k in (
                                   "live_pods", "pod_wire_bytes") if k in rec})
                if per_agent is not None:
                    tm.counter("wire_bytes",
                               per_agent * n + rec.get("pod_wire_bytes", 0),
                               per_agent=per_agent, n_active=n)
                self._emit_sparse_probes(tm, t, x, y)
                tm.end_round(t)
            if log_every and (t % log_every == 0 or t == T - 1):
                msg = " ".join(
                    f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in rec.items() if k not in ("round", "path"))
                print(f"[sparse round {t:5d}] {msg}")
            self._prev_ids = ids
        return x, y

    def _emit_sparse_probes(self, tm, t, x, y) -> None:
        """Sampled invariant probes of the O(active) path.  The GT and drift
        probes materialize the dense table (`obs.probes.sparse_tracker_table`,
        O(m), a probe cost), so the probe evaluated is the one the dense
        runtimes feed their tables to (`obs.probes.emit_probes`)."""
        from ..obs import probes as _p

        table = None
        if self._use_corr and (tm.probe_due("gt_residual", t)
                               or tm.probe_due("tracker_drift", t)):
            tab_x, tab_y = _p.sparse_tracker_table(self._tracker, self._source,
                                                   grad_xy(self._loss))
            table = {"gx": tab_x, "gy": tab_y}
        _p.emit_probes(tm, t, x, y, lambda: self._state, table)
        if table is not None and tm.probe_due("tracker_drift", t):
            tm.probe_value("tracker_drift", t, _p.tracker_drift(
                tab_x, tab_y, self._tracker.sum_gx, self._tracker.sum_gy))
