"""Asynchronous federated round driver over agent shards (port of
`repro/fed/async_runtime.py`).

`AsyncFederatedRunner` runs the same round phases as the fused engine
(`core.engine.make_phases`), dispatched per agent SHARD, each shard on its
own device and CUDA stream, so the schedule changes and the math does not:

  * the m agents are split into contiguous shards, one per entry of
    `devices`; a list may repeat a device (the reference's emulated host
    devices), and each shard gets its own `torch.cuda.Stream` on its
    device, so on one card four shards are four streams.  A shard's
    `agent_data` rows and its per-agent strategy state (error-feedback
    buffers, `strategy.sharded_state_keys`) live on its device;
  * each shard broadcasts the iterates to its agents and computes their
    anchor gradients on its stream (the up half of the exchange); every
    shard's work is enqueued before the server waits for any;
  * the server half of the exchange (gbar, c_i = gbar - g_i, the
    strategy's `transform_correction` with the sync path's draws, the
    packed payload's decode) runs on the server device's current stream
    over the gathered gradients;
  * `local_steps` runs per shard with its correction slice, so the
    `gt_update` kernel of every local step launches on its shard's stream;
    a shard returns a weighted PARTIAL aggregate
    (`core.agent_weighted_sum`), and the server sums and projects;
  * the next round's broadcast buffers are filled (one copy per shard) as
    soon as the aggregate is enqueued.  The reference donates them into
    its local-step program; eager torch has nothing to donate.

Every hand-off between streams is explicit: a consumer stream waits for
its producer (`wait_stream`), and a tensor made on one stream and read on
another is recorded on the reader (`record_stream`), so the caching
allocator does not hand its memory out before the reader is done.  A round
waits for nothing on the host: schedules, weights and budgets reach the
card as pinned non-blocking copies (`device.host_to_device`), and a
shard's membership is read from the schedule's host mask.  On the CPU
(`devices=["cpu"] * n`) the shards run one after another.

FullSync (sync_every_step) has nothing to overlap: its K communicated
steps are K (per-shard gradients, then a server step) exchanges a round,
which is why it costs K times more on the wire (`benchmarks.comm_efficiency
--overlap`).

An elastic `sim.RoundSchedule` (`run(..., schedule=...)`) skips a shard
whose agents are all absent this round (its programs do not run; stale
tracker rows stand in server-side, and a `shard_skipped` event says so),
and partially present shards run budget-gated local steps with their
weight slice re-normalized over the global active set; the server exchange
is `sim.tracker_exchange`, the sync elastic round's.

Iterates match `FederatedRunner`'s to fp tolerance (rtol 1e-9 / atol
1e-12, tests/test_torch_async_runtime.py): per-agent gradients and local
steps are the same computations on shard slices, every random draw
(participation sampling, rand-k scores, rounding uniforms, the per-agent
noise keys, sliced per shard) happens once, server-side, through the same
strategy code, and only the aggregate's summation order differs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.engine import (
    agent_mean,
    agent_weighted_sum,
    make_phases,
    tracking_corrections,
)
from ..core.types import (
    Pytree,
    identity_proj,
    tree_broadcast_agents,
    tree_leaves,
    tree_map,
    vmap_grad_xy,
)
from ..device import host_to_device, resolve_device
from ..obs.telemetry import maybe_span
from ..sim.elastic import tracker_exchange
from .runtime import RoundStats, RunnerHistoryMixin
from .strategies import resolve_strategy
from .transport import decode_corrections


def _num_agents(agent_data: Pytree) -> int:
    return tree_leaves(agent_data)[0].shape[0]


def _slice_agents(tree: Pytree, lo: int, hi: int) -> Pytree:
    return tree_map(lambda u: u[lo:hi], tree)


def _device(d) -> torch.device:
    """`d` as a torch.device with its CUDA index filled in, so a repeated
    device compares equal however it was named."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def largest_shard_count(m: int, n_devices: int) -> int:
    """Most shards that fit: the largest divisor of m no larger than the
    device count (equal contiguous shards keep every shard's shapes
    alike)."""
    for n in range(min(m, n_devices), 0, -1):
        if m % n == 0:
            return n
    return 1


def concat_on_device(parts: List[Pytree], device) -> Pytree:
    """Gather per-shard pytrees onto one device and re-stack the agent axis
    (the up-link of a sharded round).  The caller orders the streams."""
    parts = [tree_map(lambda u: u.to(device, non_blocking=True), p) for p in parts]
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *u: torch.cat(u, dim=0), *parts)


def shard_devices(devices: Optional[Sequence]) -> List[torch.device]:
    """A runner's device list as torch.devices: None means every CUDA
    device, and raises without CUDA (no quiet CPU fallback); pass
    `["cpu"] * n` for n shards on the CPU."""
    if devices is None:
        resolve_device(None)  # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [_device(d) for d in devices]


class ShardStreams:
    """Agent shards on a device list, one CUDA stream each, and the
    hand-offs between them and the server (module docstring): the layout
    and stream discipline shared by `AsyncFederatedRunner` and
    `launch.multihost.MultiHostRunner`."""

    def _place_shards(self, agent_data: Pytree, devices: List[torch.device],
                      n_shards: int) -> None:
        """`n_shards` contiguous shards of the m agents on the first devices,
        each with its stream on a card and its rows of `agent_data`."""
        self._n_shards = n_shards
        self._per = self._m // n_shards
        #: the server device: the exchange's server half and the aggregate
        #: run there, on its current stream; it also hosts shard 0
        self._server = devices[0]
        self._shard_devices = devices[:n_shards]
        #: one stream per shard on a card; None on the CPU (shards in order)
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                         for d in self._shard_devices]
        self._sstream = None
        # a shard's rows: views on a shard that shares the data's device
        self._data_s = [
            tree_map(lambda u: u.to(d),
                     _slice_agents(agent_data, i * self._per, (i + 1) * self._per))
            for i, d in enumerate(self._shard_devices)
        ]

    def _start(self) -> None:
        """At the top of a run: the server's current stream, and the shards'
        streams after what the caller enqueued (data, x, y)."""
        self._sstream = (torch.cuda.current_stream(self._server)
                         if self._server.type == "cuda" else None)
        self._fan_out()

    def _on(self, i: int):
        """Shard i's stream as the current one (nothing on the CPU)."""
        s = self._streams[i]
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    @staticmethod
    def _record(tree: Pytree, stream) -> None:
        """Mark every leaf as read on `stream`: its memory is not reused
        before `stream`'s work so far is done."""
        if stream is not None:
            for u in tree_leaves(tree):
                if u.is_cuda:
                    u.record_stream(stream)

    def _fan_out(self, shards=None) -> None:
        """The shards' streams wait for what the server has enqueued."""
        for i in range(self._n_shards) if shards is None else shards:
            if self._streams[i] is not None:
                self._streams[i].wait_stream(self._sstream)

    def _down(self, i: int, tree: Pytree) -> Pytree:
        """A server tensor handed to shard i (inside `_on(i)`, after
        `_fan_out`): recorded on its stream where it shares the server's
        device, copied on that stream otherwise."""
        d = self._shard_devices[i]
        if d == self._server:
            self._record(tree, self._streams[i])
            return tree
        return tree_map(lambda u: u.to(d, non_blocking=True), tree)

    def _up(self, parts: List[Pytree], shards: Sequence[int]) -> Pytree:
        """Per-shard pytrees (made on the `shards`' streams) stacked on the
        server's stream: the server waits for those streams and records the
        parts as read there."""
        if self._sstream is not None:
            for i in shards:
                if self._streams[i] is not None:
                    self._sstream.wait_stream(self._streams[i])
            for p in parts:
                self._record(p, self._sstream)
        return concat_on_device(parts, self._server)

    def _bcast(self, x, y) -> List:
        """Fresh per-shard (x, y) buffers for the round about to run, one
        copy per shard made on its stream (every shard gets its own copy,
        also where it shares the server's device)."""
        self._fan_out()
        out = []
        for i, d in enumerate(self._shard_devices):
            with self._on(i):
                if d == self._server:
                    self._record((x, y), self._streams[i])
                    out.append((tree_map(torch.clone, x), tree_map(torch.clone, y)))
                else:
                    out.append(tuple(tree_map(lambda u: u.to(d, non_blocking=True), t)
                                     for t in (x, y)))
        return out

    # a shard's phases (`_phases`, `_vgrad`, `_noise` and `_fused` are the
    # runner's)
    def _shard_broadcast(self, i: int, bx, by, nk=None, budgets=None):
        """Shard i's broadcast (its agents' iterates and, with noise keys,
        the round's draws), on its stream."""
        with self._on(i):
            return self._phases.broadcast(bx, by, self._data_s[i], {},
                                          weights=None, step_budgets=budgets,
                                          noise_keys=nk)

    def _shard_grads(self, i: int, rs):
        """Per-shard anchor gradients (the up half of the exchange): the
        draw at eval index 0 when the round is noisy, the exact oracle
        otherwise (and for the tracker's init)."""
        with self._on(i):
            data = self._data_s[i]
            if rs.noise_draws is None:
                g = self._vgrad(rs.xs, rs.ys, data)
            else:
                g = self._noise.apply(self._vgrad, rs.noise_draws[0], rs.xs,
                                      rs.ys, data)
            return g.gx, g.gy

    def _shard_steps(self, i: int, rs, cx, cy, gbar_x, gbar_y, w):
        """Shard i's local steps and its weighted partial aggregate."""
        with self._on(i):
            rs = dataclasses.replace(rs, cx=cx, cy=cy, gbar_x=gbar_x,
                                     gbar_y=gbar_y, fused=self._fused)
            rs = self._phases.local_steps(rs, self._data_s[i])
            return agent_weighted_sum(rs.xs, w), agent_weighted_sum(rs.ys, w)

    def _corrections_down(self, cx, cy, gbar_x, gbar_y, shards) -> List:
        """The down-link: each shard's correction rows and the global anchor
        gradient, on its stream."""
        self._fan_out(shards)
        out = [(None, None, None, None)] * self._n_shards
        per = self._per
        for i in shards:
            with self._on(i):
                out[i] = tuple(self._down(i, t) for t in (
                    _slice_agents(cx, i * per, (i + 1) * per),
                    _slice_agents(cy, i * per, (i + 1) * per), gbar_x, gbar_y))
        return out


class AsyncFederatedRunner(ShardStreams, RunnerHistoryMixin):
    """Federated rounds dispatched per agent shard, each shard on its own
    device and stream (module docstring).

    Mirrors `FederatedRunner`'s surface: `run(x, y, num_rounds)` returns
    the final iterates, `history` / `metric_series` record per-round
    metrics, `wire_report` prices the strategy.  It takes the loss and the
    strategy (it owns the phase schedule).  `devices=None` means every CUDA
    device (`torch.device("cuda", i)`), and raises without CUDA; pass
    `devices=["cpu"] * n` for n shards on the CPU."""

    def __init__(
        self,
        loss: Callable,
        strategy,
        agent_data: Pytree,
        num_local_steps: int,
        eta_x: float,
        eta_y: Optional[float] = None,
        *,
        proj_x: Callable = identity_proj,
        proj_y: Callable = identity_proj,
        metric_fn: Optional[Callable] = None,
        devices: Optional[Sequence] = None,
        pod_map=None,
        telemetry=None,
        **strategy_kwargs,
    ):
        self._strategy = resolve_strategy(strategy, **strategy_kwargs)
        self._K = num_local_steps
        #: obs.Telemetry sink or None (None: the code without the sink)
        self.telemetry = telemetry
        self._loss = loss
        self._num_local_steps = num_local_steps
        self._eta_x = eta_x
        self._eta_y = eta_x if eta_y is None else eta_y
        self._proj_x = proj_x
        self._proj_y = proj_y
        self._m = _num_agents(agent_data)

        devices = shard_devices(devices)
        self._pod_map = pod_map
        if pod_map is not None:
            # pod-aligned sharding: a shard count dividing the pod count, so
            # every shard holds whole pods and skipping absent shards also
            # skips quiet pods (fed.pods)
            from .pods import pod_aligned_shard_count

            if pod_map.m != self._m:
                raise ValueError(f"pod_map is for m={pod_map.m}, runner has "
                                 f"{self._m}")
            if self._m % pod_map.num_pods != 0:
                raise ValueError(
                    f"pod-aligned sharding needs m divisible by the pod "
                    f"count, got m={self._m}, pods={pod_map.num_pods}")
            n_shards = pod_aligned_shard_count(pod_map.num_pods, len(devices))
        else:
            n_shards = largest_shard_count(self._m, len(devices))
        self._place_shards(agent_data, devices, n_shards)
        self._phases = make_phases(loss, self._strategy, num_local_steps, eta_x,
                                   eta_y, proj_x=proj_x, proj_y=proj_y)
        self._vgrad = vmap_grad_xy(loss)
        self._use_corr = bool(getattr(self._strategy, "use_correction", False))
        self._sync_every = bool(getattr(self._strategy, "sync_every_step", False))
        self._cdt = getattr(self._strategy, "correction_dtype", None)
        self._noise = getattr(self._strategy, "noise", None)
        self._fused = (
            self._use_corr
            and self._m > 1
            and bool(self._strategy.exact_correction)
            # momentum folds the correction into a velocity, so the first
            # step is no longer the plain anchor update
            and not getattr(self._strategy, "momentum", 0.0)
        )
        self._metric_fn = metric_fn
        self._server_state: Dict = {}
        self._shard_state: Optional[List[Dict]] = None
        self._sharded_keys = ()
        #: set by an elastic run: {"tracker", "prev_active"} where it left
        #: off (as FederatedRunner.elastic_state)
        self.elastic_state: Optional[Dict] = None
        self.history: List[RoundStats] = []

    @property
    def pods_per_shard(self) -> Optional[int]:
        """Whole pods per agent shard under pod-aligned sharding (None
        without a pod_map): a quiet run of this many consecutive pods skips
        its shard."""
        if self._pod_map is None:
            return None
        return self._pod_map.num_pods // self._n_shards

    def _host_slices(self, a: np.ndarray, shards=None) -> List:
        """Per-shard slices of a host array, each a pinned non-blocking copy
        on its shard's stream."""
        out = [None] * self._n_shards
        for i in range(self._n_shards) if shards is None else shards:
            with self._on(i):
                out[i] = host_to_device(
                    np.ascontiguousarray(a[i * self._per:(i + 1) * self._per]),
                    self._shard_devices[i])
        return out

    def _combine(self, sums: List, shards: Sequence[int]):
        """Sum the shards' partial aggregates on the server and project (the
        partials carry the weights, so the combine is a plain sum)."""
        xs = [self._up([a], [i]) for (a, _), i in zip(sums, shards)]
        ys = [self._up([b], [i]) for (_, b), i in zip(sums, shards)]
        x1 = tree_map(lambda *u: sum(u), *xs)
        y1 = tree_map(lambda *u: sum(u), *ys)
        return self._proj_x(x1), self._proj_y(y1)

    def _zero_shard_rows(self, x, y):
        """One shard's zero gradient rows on the server: the stand-in for a
        shard that did not run this round (the active mask or its zero
        weights discard them)."""
        z = lambda t: tree_map(
            lambda u: torch.zeros((self._per,) + tuple(u.shape), dtype=u.dtype,
                                  device=u.device), t)
        return z(x), z(y)

    # ------------------------------------------------------- state plumbing
    def _init_state(self, x: Pytree, y: Pytree) -> None:
        strategy = self._strategy
        if not getattr(strategy, "stateful", False):
            self._server_state = {}
            self._shard_state = [{} for _ in range(self._n_shards)]
            return
        full = strategy.init_state(x, y, self._m)
        self._sharded_keys = tuple(
            k for k in getattr(strategy, "sharded_state_keys", ()) if k in full)
        self._shard_state = [{} for _ in range(self._n_shards)]
        self._scatter_state(dict(full))

    def _gather_state(self) -> Dict:
        """The full strategy state on the server: sharded entries gathered
        (on the server's stream, where they are made and read), the rest
        already there."""
        state = dict(self._server_state)
        for k in self._sharded_keys:
            state[k] = concat_on_device([s[k] for s in self._shard_state],
                                        self._server)
        return state

    def _scatter_state(self, state: Dict) -> None:
        """Split the transform's updated state back: per-agent entries to
        their shards' devices (a copy each), the rest stays server-side."""
        per = self._per
        for k in self._sharded_keys:
            full = state.pop(k)
            for i, (s, d) in enumerate(zip(self._shard_state, self._shard_devices)):
                s[k] = tree_map(lambda u: u.to(d, copy=True),
                                _slice_agents(full, i * per, (i + 1) * per))
        self._server_state = state

    # ----------------------------------------------------------- round loop
    def _round_weights(self):
        """Participation sampling, once a round, server-side: the server's
        weights (None: uniform) and each shard's slice of them."""
        weights, self._server_state = self._strategy.sample_weights(
            self._server_state, self._m)
        if weights is None:
            w = np.full((self._m,), 1.0 / self._m)
        else:
            w = weights.cpu().numpy()
            weights = host_to_device(w, self._server)
        return weights, self._host_slices(w)

    def _round_noise_keys(self) -> List:
        """Per-agent noise keys, once a round, server-side; each shard gets
        its slice (keys fold the global agent index, so the draws do not
        depend on the sharding)."""
        if self._noise is None:
            return [None] * self._n_shards
        keys, self._server_state = self._strategy.sample_noise_keys(
            self._server_state, self._m)
        per = self._per
        return [keys[i * per:(i + 1) * per] for i in range(self._n_shards)]

    def _server_exchange(self, gx, gy, state, weights):
        """The server half of exchange_corrections: gbar, corrections, the
        strategy's transform (the sync path's draws) and the decode."""
        gbar_x = agent_mean(gx, weights)
        gbar_y = agent_mean(gy, weights)
        cx, cy = tracking_corrections(gx, gy, gbar_x, gbar_y, self._cdt)
        cx, cy, state = self._strategy.transform_correction(cx, cy, state)
        cx, cy = decode_corrections(cx, cy)
        return cx, cy, gbar_x, gbar_y, state

    def _run_fullsync_round(self, x, y, weights=None, shard_live=None):
        """FullSync: K communicated steps, each per-shard gradients at the
        shared iterate, then one server GDA step.  `weights` None is the
        uniform mean; an elastic round passes its active-set weights and
        `shard_live`, and absent shards do not run (zero rows stand in)."""
        live = [i for i in range(self._n_shards)
                if shard_live is None or shard_live[i]]
        zx = zy = None
        if len(live) < self._n_shards:
            zx, zy = self._zero_shard_rows(x, y)
        for _ in range(self._K):
            self._fan_out(live)
            gs = [None] * self._n_shards
            for i in live:
                with self._on(i):
                    bx, by = self._down(i, x), self._down(i, y)
                    g = self._vgrad(tree_broadcast_agents(bx, self._per),
                                    tree_broadcast_agents(by, self._per),
                                    self._data_s[i])
                    gs[i] = (g.gx, g.gy)
            gx = self._up([g[0] if g is not None else zx for g in gs], live)
            gy = self._up([g[1] if g is not None else zy for g in gs], live)
            gxm, gym = agent_mean(gx, weights), agent_mean(gy, weights)
            x = self._proj_x(tree_map(lambda u, v: u - self._eta_x * v, x, gxm))
            y = self._proj_y(tree_map(lambda u, v: u + self._eta_y * v, y, gym))
        return x, y

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
        x = tree_map(lambda u: u.to(self._server), x)
        y = tree_map(lambda u: u.to(self._server), y)
        self._start()
        if self._shard_state is None:
            self._init_state(x, y)
            if state is not None:
                # resume: split a checkpointed full state
                self._scatter_state(dict(state))
        if schedule is not None and schedule.is_static_full:
            # all agents, full budgets, every round: the loop below is
            # that run
            schedule = None
        self._last_schedule = schedule
        if schedule is not None:
            return self._run_elastic(x, y, num_rounds, schedule, rebase,
                                     log_every, elastic_state)
        tm = self.telemetry
        per_agent = None
        if tm is not None:
            self._emit_wire_probe(tm, x, y)
            per_agent = self._wire_counter_args(x, y, scheduled=False)
        # the per-shard (x, y) copies of the round about to run, refilled as
        # soon as the aggregate making the next iterates is enqueued;
        # FullSync has no local phase to feed
        bcast = None if self._sync_every else self._bcast(x, y)
        for t in range(num_rounds):
            t0 = time.perf_counter()
            if tm is not None:
                tm.begin_round(t)
            if self._sync_every:
                x, y = self._run_fullsync_round(x, y)
            else:
                x, y, bcast = self._run_round(x, y, bcast)
            metrics = {}
            if self._metric_fn is not None:
                metrics = {k: float(v) for k, v in self._metric_fn(x, y).items()}
            dt = time.perf_counter() - t0
            self.history.append(RoundStats(t, metrics, dt))
            if tm is not None:
                tm.round_event(t, runtime="async", seconds=dt,
                               n_shards=self._n_shards)
                if per_agent is not None:
                    tm.counter("wire_bytes", per_agent * self._m,
                               per_agent=per_agent, n_active=self._m)
                self._emit_probes(tm, t, x, y)
                tm.end_round(t)
            if log_every and (t % log_every == 0 or t == num_rounds - 1):
                msg = " ".join(f"{k}={v:.3e}" for k, v in metrics.items())
                print(f"[async round {t:5d}] {msg} ({dt*1e3:.1f} ms)")
        return x, y

    def _run_round(self, x, y, bcast):
        tm = self.telemetry
        n = self._n_shards
        shards = range(n)
        weights, w_slices = self._round_weights()
        nk_slices = self._round_noise_keys()
        rs = [None] * n
        down = [(None, None, None, None)] * n
        if self._use_corr and self._m > 1:
            # fan-out: every shard's gradients are enqueued before the
            # server waits for any
            with maybe_span(tm, "exchange_corrections", dispatches=n):
                rs = [self._shard_broadcast(i, *bcast[i], nk_slices[i])
                      for i in shards]
                gs = [self._shard_grads(i, rs[i]) for i in shards]
                gx = self._up([g[0] for g in gs], shards)
                gy = self._up([g[1] for g in gs], shards)
                cx, cy, gbar_x, gbar_y, new_state = self._server_exchange(
                    gx, gy, self._gather_state(), weights)
                self._scatter_state(dict(new_state))
                down = self._corrections_down(cx, cy, gbar_x, gbar_y, shards)
        with maybe_span(tm, "local_steps", dispatches=n):
            sums = []
            for i in shards:
                if rs[i] is None:
                    rs[i] = self._shard_broadcast(i, *bcast[i], nk_slices[i])
                cx_i, cy_i, gbx_i, gby_i = down[i]
                if self._use_corr and self._m == 1:
                    # the correction is identically zero and elided
                    with self._on(i):
                        cx_i = tree_map(torch.zeros_like, rs[i].xs)
                        cy_i = tree_map(torch.zeros_like, rs[i].ys)
                sums.append(self._shard_steps(i, rs[i], cx_i, cy_i, gbx_i,
                                              gby_i, w_slices[i]))
        with maybe_span(tm, "aggregate"):
            x1, y1 = self._combine(sums, shards)
        # the next round's broadcast, enqueued at once behind the local
        # steps still running on the shards' streams
        with maybe_span(tm, "broadcast", dispatches=n):
            bcast = self._bcast(x1, y1)
        return x1, y1, bcast

    # ------------------------------------------------------- elastic rounds
    def _run_elastic(self, x, y, num_rounds, schedule, rebase, log_every,
                     elastic_state=None):
        """Drive `num_rounds` through the membership-aware schedule with the
        shared elastic loop (`RunnerHistoryMixin._drive_elastic`): fully
        absent shards do not run, budgets gate local steps, the tracker
        table lives server-side and starts from the first round's
        broadcast."""
        return self._drive_elastic(
            x, y, num_rounds, schedule, rebase, log_every, elastic_state,
            lambda xx, yy: None,  # built from the first round's broadcast
            self._run_elastic_round, None, num_agents=self._m,
            label="elastic async round")

    def _init_tracker(self, bcast) -> Dict:
        """The tracker table at the first elastic round: every agent's
        anchor gradient at the broadcast iterate (noiseless), gathered from
        all shards (`sim.init_tracker` on the sync path)."""
        n = self._n_shards
        gs = [self._shard_grads(i, self._shard_broadcast(i, *bcast[i]))
              for i in range(n)]
        return {"gx": self._up([g[0] for g in gs], range(n)),
                "gy": self._up([g[1] for g in gs], range(n))}

    def _run_elastic_round(self, x, y, ev, agg, tracker, prev_active):
        tm = self.telemetry
        per, n = self._per, self._n_shards
        active_np = np.asarray(ev.active, bool)
        weights, budgets, active = agg.round_inputs(active_np, ev.budgets,
                                                    self._server)
        # membership from the host mask: no device read
        live = [i for i in range(n) if active_np[i * per:(i + 1) * per].any()]
        if tm is not None:
            for i in range(n):
                if i not in live:
                    tm.emit("event", "shard_skipped", shard=i)
        if self._sync_every:
            x, y = self._run_fullsync_round(x, y, weights,
                                            [i in live for i in range(n)])
            return x, y, tracker, active
        # one noise draw a round, server-side, as the sync elastic round's
        # broadcast samples it (absent agents' keys are drawn and dropped)
        nk_slices = self._round_noise_keys()
        with maybe_span(tm, "broadcast", dispatches=n):
            bcast = self._bcast(x, y)
        w_slices = self._host_slices(agg.host_weights(active_np), live)
        b_slices = self._host_slices(np.asarray(ev.budgets, np.int64), live)
        rs = [None] * n
        for i in live:
            rs[i] = self._shard_broadcast(i, *bcast[i], nk_slices[i], b_slices[i])
        down = [(None, None, None, None)] * n
        if self._use_corr:
            t_exch = time.perf_counter()
            if tracker is None:
                tracker = self._init_tracker(bcast)
            else:
                # a resume may hand over another device's table
                tracker = tree_map(lambda u: u.to(self._server), tracker)
            gs = [self._shard_grads(i, rs[i]) if i in live else None
                  for i in range(n)]
            zx = zy = None
            if len(live) < n:
                zx, zy = self._zero_shard_rows(x, y)
            gx = self._up([g[0] if g is not None else zx for g in gs], live)
            gy = self._up([g[1] if g is not None else zy for g in gs], live)
            cx, cy, gbar_x, gbar_y, new_state, tab_x, tab_y = tracker_exchange(
                self._strategy, gx, gy, self._gather_state(), active,
                tracker["gx"], tracker["gy"], self._cdt,
                agg.round_prev_active(active, prev_active))
            tracker = {"gx": tab_x, "gy": tab_y}
            self._scatter_state(dict(new_state))
            down = self._corrections_down(cx, cy, gbar_x, gbar_y, live)
            if tm is not None:
                # emitted after the fact: host time of the live shards'
                # exchange
                tm.emit("span", "exchange_corrections",
                        seconds=time.perf_counter() - t_exch,
                        dispatches=len(live))
        # a shard that left this round runs nothing: its weights are zero,
        # so it has no share of the aggregate either
        with maybe_span(tm, "local_steps", dispatches=len(live)):
            sums = [self._shard_steps(i, rs[i], *down[i], w_slices[i])
                    for i in live]
        with maybe_span(tm, "aggregate"):
            x1, y1 = self._combine(sums, live)
        return x1, y1, tracker, active

    # ------------------------------------------------------------ reporting
    # `wire_report` comes from RunnerHistoryMixin; probes read the gathered
    # state
    def _telemetry_state(self) -> Dict:
        return self._gather_state()
