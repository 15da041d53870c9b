"""Multi-host federated launch path: agent shards on devices, packed wire
gather (port of `repro/launch/multihost.py`).

The sync round moves corrections between agents and server inside one
process's tensors, so the bytes that `fed.transport` packs never cross an
interconnect.  This module is the launch path where they are shipped:

  * `init_distributed` — a gated `torch.distributed` bootstrap: a no-op
    returning False when no coordinator is given and torchrun's
    environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK) is unset, so
    the same entry point serves one process and many.  The runner below
    does not use the process group: like the reference's, it is one
    process with its shards on a device list; spanning processes with
    collectives is the SPMD layer's (`launch.steps`);
  * `MultiHostRunner` — each agent shard lives on its own device and CUDA
    stream (`fed.async_runtime.ShardStreams`; a device may repeat, so on
    one card four shards are four streams) with its own strategy-state
    slice: error-feedback buffers AND the selection / rounding key, folded
    by shard index (`prng.fold_in(key, i)`, as the reference folds it), so
    each shard's draws equal the reference's bit for bit.  Per round,
    shards compute anchor gradients, the server forms gbar, each shard
    ENCODES its correction on its stream (`transform_correction` with its
    own state) and ships only its packed buffers (`PackedTree.payloads`);
    the server gathers them, rebuilds the `PackedTree`s from the specs and
    DECODES every shard's cx and cy in one call, each shard's leaves
    straight into its rows of the stacked agent axis.  The decoded
    correction slices ride the down-link into per-shard local steps, and
    the server combines the partial sums.  Every round's gathered byte count (counted from the
    buffers) lands in `wire_log`, and in a telemetry sink as the
    "gathered_payload_bytes" counter;
  * `leaf_specs` / `payload_structs` / `expected_gather_bytes` — the wire
    layout the runner rebuilds the `PackedTree`s from, the packed buffers'
    shapes and dtypes (from running the plain encoder on meta tensors),
    and the payload bytes the gather must move a round.

`build_gather_decode_step` is the same gather as one SPMD step on a
`DeviceMesh`, for the dry-run's census: every agent's packed buffers,
concatenated as bytes into one row per agent, sharded over the fed axes
(flattened into one mesh dim), gathered by ONE all-gather whose bytes are
the packed payload, and decoded replicated through `unpack_payload`.

Unlike `fed.async_runtime` (whose exchange transform runs server-side with
the sync path's draws), the multi-host path draws per shard: iterates are
statistically equivalent to the sync runner's, not equal, but they equal
the reference's `MultiHostRunner` to fp tolerance.  What is pinned: the
server's decode of the gathered payloads equals each shard's own decode
bit for bit (`decode_on_shards`), and the gathered size equals the priced
payload (tests/test_torch_multihost.py).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import prng
from ..core.engine import agent_mean, make_phases, tracking_corrections
from ..core.types import (
    Pytree,
    identity_proj,
    tree_flatten,
    tree_leaves,
    tree_map,
    vmap_grad_xy,
)
from ..fed.async_runtime import (
    ShardStreams,
    largest_shard_count,
    shard_devices,
)
from ..fed.strategies import resolve_strategy
from ..fed.transport import (
    LeafPayload,
    LeafSpec,
    PackedTree,
    decode_corrections,
    decode_leaf,
    decode_payloads,
    encode_leaf,
)
from ..obs.telemetry import maybe_span

__all__ = [
    "MultiHostRunner",
    "build_gather_decode_step",
    "expected_gather_bytes",
    "init_distributed",
    "leaf_specs",
    "payload_structs",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the default `torch.distributed` process group when a
    multi-process launch is configured (explicit arguments, or torchrun's
    MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK), and no-op otherwise.
    Returns True when it brought a group up.  The backend is NCCL where
    the process has a CUDA card, gloo otherwise.  `coordinator_address`
    is "host:port"."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


# --------------------------------------------------------------------------
# packed-payload layout
# --------------------------------------------------------------------------
def leaf_specs(strategy, tree: Pytree, m: int) -> List[LeafSpec]:
    """The stacked wire layout of every leaf of one correction tree for `m`
    agents, in the reference's leaf order: exactly the specs
    `transform_correction` builds, so the runner's server-side `PackedTree`
    reconstruction and the shards' encode cannot disagree."""
    cdt = getattr(strategy, "correction_dtype", None)
    ratio = getattr(strategy, "_ratio", 1.0)
    bits = getattr(strategy, "_bits", 32)
    mode = getattr(strategy, "mode", "topk")
    return [
        LeafSpec.build(tuple(u.shape), cdt or u.dtype, ratio, bits, mode).stacked(m)
        for u in tree_flatten(tree)[0]
    ]


def payload_structs(specs: Sequence[LeafSpec]) -> List[LeafPayload]:
    """Each spec's packed buffers as meta tensors (their shapes and dtypes),
    from running the plain encoder on meta tensors of the spec's shape:
    the layout arithmetic is never trusted for them."""
    out = []
    for spec in specs:
        c = torch.zeros((spec.rows, spec.cols), dtype=spec.dtype, device="meta")
        u = torch.zeros((spec.rows, spec.cols), dtype=torch.float64, device="meta")
        out.append(encode_leaf(c, None, u, u, spec, use_kernel=False)[0])
    return out


def expected_gather_bytes(strategy, x: Pytree, y: Pytree, m: int) -> int:
    """Packed payload bytes the server gathers a round (both correction
    trees, all m agents, headers excluded): the number the runner's
    `wire_log` must track."""
    return sum(s.wire_bytes() for s in leaf_specs(strategy, (x, y), m))


def _nbytes(tree: Pytree) -> int:
    return sum(u.numel() * u.element_size() for u in tree_leaves(tree))


# --------------------------------------------------------------------------
# multi-host rounds
# --------------------------------------------------------------------------
class MultiHostRunner(ShardStreams):
    """Federated rounds with per-device agent shards and a packed-payload
    gather (module docstring).  Requires a correction strategy (the GT
    family: there is no payload to gather otherwise) at full
    participation.  `devices=None` means every CUDA device and raises
    without CUDA; `devices=["cpu"] * n` is n shards on the CPU, in order.
    `update_fn` is the round engine's local update (default the
    `gt_update` kernel; `core.default_update` is its plain version)."""

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
        devices: Optional[Sequence] = None,
        pod_map=None,
        telemetry=None,
        update_fn: Optional[Callable] = None,
        **strategy_kwargs,
    ):
        self._strategy = resolve_strategy(strategy, **strategy_kwargs)
        if not getattr(self._strategy, "use_correction", False):
            raise ValueError(
                "MultiHostRunner gathers correction payloads; strategy "
                f"{self._strategy.name!r} exchanges none (use "
                "fed.async_runtime.AsyncFederatedRunner for it)"
            )
        if getattr(self._strategy, "participation", 1.0) < 1.0:
            raise ValueError(
                "MultiHostRunner is a full-participation path; client "
                "sampling needs the async runtime's server-side draw"
            )
        if getattr(self._strategy, "noise", None) is not None:
            raise ValueError(
                "MultiHostRunner draws no gradient noise; stochastic "
                "strategies run on the async runtime"
            )
        self._proj_x, self._proj_y = proj_x, proj_y
        self._m = tree_leaves(agent_data)[0].shape[0]
        devices = shard_devices(devices)
        if pod_map is not None:
            # pod-aligned shards (the async runtime's rule): whole pods per
            # device shard, so the per-shard packed payloads double as
            # pod-level partial payloads
            from ..fed.pods import pod_aligned_shard_count

            if pod_map.m != self._m or self._m % pod_map.num_pods != 0:
                raise ValueError(
                    f"pod_map ({pod_map.m} agents, {pod_map.num_pods} "
                    f"pods) does not align with m={self._m}"
                )
            n = pod_aligned_shard_count(pod_map.num_pods, len(devices))
        else:
            n = largest_shard_count(self._m, len(devices))
        self._place_shards(agent_data, devices, n)
        self._phases = make_phases(loss, self._strategy, num_local_steps, eta_x,
                                   eta_y, proj_x=proj_x, proj_y=proj_y,
                                   update_fn=update_fn)
        self._vgrad = vmap_grad_xy(loss)
        self._noise = None
        self._cdt = getattr(self._strategy, "correction_dtype", None)
        self._fused = self._m > 1 and bool(self._strategy.exact_correction)
        self._wire = bool(getattr(self._strategy, "wire_transport", False))
        self._use_kernel = bool(getattr(self._strategy, "use_kernel", True))
        self._state_s: Optional[List[Dict]] = None
        self._specs: Optional[Tuple[List[LeafSpec], List[LeafSpec]]] = None
        #: obs.Telemetry sink or None; every wire_log append also lands in
        #: it as a "gathered_payload_bytes" counter
        self.telemetry = telemetry
        #: per-round wire accounting: gathered payload / total bytes
        self.wire_log: List[Dict[str, int]] = []
        #: the last round's exchange: each shard's encoded corrections
        #: ("encoded", PackedTree pairs over the wire, dense trees
        #: otherwise) and the server's re-stacked decode ("decoded")
        self.last_exchange: Optional[Dict] = None

    # ------------------------------------------------------------- plumbing
    def _init_state(self, x: Pytree, y: Pytree) -> None:
        """Each shard's strategy state for its agents, its per-agent entries
        on its device (made on the server's stream, recorded on the
        shard's), its key folded by shard index and kept on the host."""
        strategy = self._strategy
        stateful = getattr(strategy, "stateful", False)
        sharded = getattr(strategy, "sharded_state_keys", ())
        self._state_s = []
        for i in range(self._n_shards):
            s = dict(strategy.init_state(x, y, self._per)) if stateful else {}
            if "key" in s:
                # independent draws per shard: each agent group owns its
                # selection / rounding randomness, nothing is replicated
                s["key"] = prng.fold_in(s["key"], i)
            with self._on(i):
                for k in sharded:
                    if k in s:
                        s[k] = self._down(i, s[k])
            self._state_s.append(s)
        self._specs = (leaf_specs(strategy, x, self._per),
                       leaf_specs(strategy, y, self._per))
        self._unflatten = (tree_flatten(x)[1], tree_flatten(y)[1])
        self._shapes = tuple(
            [(self._per,) + tuple(u.shape) for u in tree_flatten(t)[0]]
            for t in (x, y))

    def _shard_encode(self, i: int, g, gbar_x, gbar_y):
        """Shard i forms its corrections and ENCODES them on its stream with
        its own state: over the wire the up-link is the packed buffers."""
        with self._on(i):
            cx, cy = tracking_corrections(g[0], g[1], gbar_x, gbar_y, self._cdt)
            cx, cy, self._state_s[i] = self._strategy.transform_correction(
                cx, cy, self._state_s[i])
        return cx, cy

    def _gather_decode(self, enc: List[Tuple[PackedTree, PackedTree]]
                       ) -> Tuple[Tuple[Pytree, Pytree], int, int]:
        """Server side of the exchange: pull every shard's packed buffers of
        cx and cy to the server (the wire transfer: its size is the
        payload), rebuild the `PackedTree`s from the specs, and decode
        them on the server's stream in one call (one launch on the card),
        each shard's leaves straight into its rows of the stacked [m, ...]
        outputs.  Returns ((cx, cy), payload bytes, payload + header
        bytes)."""
        payloads, specs, outs, stacked = [], [], [], []
        payload_bytes = total_bytes = 0
        for which in (0, 1):
            leaves = [torch.empty((self._m,) + shape[1:], dtype=spec.dtype,
                                  device=self._server)
                      for shape, spec in zip(self._shapes[which], self._specs[which])]
            stacked.append(leaves)
            for i, e in enumerate(enc):
                tree = PackedTree(list(self._up([e[which].payloads], [i])),
                                  self._specs[which], self._unflatten[which],
                                  self._shapes[which], use_kernel=self._use_kernel,
                                  headers=e[which].headers)
                payload_bytes += tree.wire_bytes()
                total_bytes += tree.total_bytes()
                payloads += tree.payloads
                specs += tree.specs
                outs += [u[i * self._per:(i + 1) * self._per].view(spec.rows, spec.cols)
                         for u, spec in zip(leaves, tree.specs)]
        decode_payloads(payloads, specs, use_kernel=self._use_kernel, outs=outs)
        return ((self._unflatten[0](stacked[0]), self._unflatten[1](stacked[1])),
                payload_bytes, total_bytes)

    def _log_wire(self, payload_bytes: int, total_bytes: int) -> None:
        """The one owner of the per-round wire record: the `wire_log` entry
        and, with a sink attached, the "gathered_payload_bytes" counter
        carrying the same numbers."""
        self.wire_log.append({"gathered_payload_bytes": payload_bytes,
                              "gathered_total_bytes": total_bytes})
        if self.telemetry is not None:
            self.telemetry.counter("gathered_payload_bytes", payload_bytes,
                                   total_bytes=total_bytes)

    def decode_on_shards(self) -> Tuple[Pytree, Pytree]:
        """Each shard's own decode of its last round's packed payloads, on
        its stream, re-stacked on the server: equal bit for bit to the
        server's decode of the gathered buffers (`last_exchange["decoded"]`)."""
        if not self._wire or self.last_exchange is None:
            raise ValueError("no packed exchange to decode: run a wire-transport "
                             "strategy first")
        xs, ys = [], []
        for i, (ex, ey) in enumerate(self.last_exchange["encoded"]):
            with self._on(i):
                dx, dy = decode_corrections(ex, ey)
            xs.append(dx)
            ys.append(dy)
        shards = range(self._n_shards)
        return self._up(xs, shards), self._up(ys, shards)

    # ------------------------------------------------------------- run loop
    def run(self, x: Pytree, y: Pytree, num_rounds: int):
        x = tree_map(lambda u: u.to(self._server), x)
        y = tree_map(lambda u: u.to(self._server), y)
        self._start()
        if self._state_s is None:
            self._init_state(x, y)
        n, tm = self._n_shards, self.telemetry
        shards = range(n)
        for t in range(num_rounds):
            t0 = time.perf_counter()
            if tm is not None:
                tm.begin_round(t)
            with maybe_span(tm, "broadcast", dispatches=n):
                bcast = self._bcast(x, y)
            with maybe_span(tm, "exchange_corrections", dispatches=n):
                rs = [self._shard_broadcast(i, *bcast[i]) for i in shards]
                gs = [self._shard_grads(i, rs[i]) for i in shards]
                gbar_x = agent_mean(self._up([g[0] for g in gs], shards), None)
                gbar_y = agent_mean(self._up([g[1] for g in gs], shards), None)
                self._fan_out()
                enc = []
                for i in shards:
                    with self._on(i):
                        gb = (self._down(i, gbar_x), self._down(i, gbar_y))
                    enc.append(self._shard_encode(i, gs[i], *gb))
                if self._wire:
                    (cx, cy), payload_bytes, total_bytes = self._gather_decode(enc)
                    self._log_wire(payload_bytes, total_bytes)
                else:
                    # dense strategies: the gathered "payload" is the dense
                    # correction stack itself
                    cx = self._up([e[0] for e in enc], shards)
                    cy = self._up([e[1] for e in enc], shards)
                    dense = _nbytes((cx, cy))
                    self._log_wire(dense, dense)
                self.last_exchange = {"encoded": enc, "decoded": (cx, cy)}
            with maybe_span(tm, "local_steps", dispatches=n):
                down = self._corrections_down(cx, cy, gbar_x, gbar_y, shards)
                sums = [self._shard_steps(i, rs[i], *down[i], None) for i in shards]
            with maybe_span(tm, "aggregate"):
                xs = [self._up([a], [i]) for (a, _), i in zip(sums, shards)]
                ys = [self._up([b], [i]) for (_, b), i in zip(sums, shards)]
                x = self._proj_x(tree_map(lambda *u: sum(u) / self._m, *xs))
                y = self._proj_y(tree_map(lambda *u: sum(u) / self._m, *ys))
            if tm is not None:
                tm.round_event(t, runtime="multihost",
                               seconds=time.perf_counter() - t0, n_shards=n)
                tm.end_round(t)
        return x, y


# --------------------------------------------------------------------------
# the gather as one SPMD step (the dry-run's census, --runtime async)
# --------------------------------------------------------------------------
def _buffers(payload: LeafPayload) -> List[torch.Tensor]:
    return [b for b in payload if b is not None]


def build_gather_decode_step(strategy, x: Pytree, y: Pytree, mesh,
                             fed_axes: Tuple[str, ...]):
    """The multi-host payload gather as one SPMD step on `mesh`: per-agent
    packed buffers arrive sharded over `fed_axes` (agent i's rows of every
    buffer on the i-th fed rank), are gathered to every rank and decoded
    there.  Each rank concatenates its agent's buffers as bytes into one
    row, so the gather is ONE all-gather over the fed axes (flattened into
    one mesh dim, `DeviceMesh._flatten`) whose result holds exactly the
    packed payload.

    Returns (step, arg_structs, expected_bytes): `step(payloads)` takes
    one `LeafPayload` per leaf (DTensors on the fed mesh, their rows
    sharded, or plain tensors that every rank holds whole) and returns
    the decoded dense [m * rows, cols] corrections, replicated DTensors
    (`use_kernel=False`: decoded by the plain version, as the dry-run on
    `meta` must); `arg_structs` is `(payload_structs(specs),)` on `meta`."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m = 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for a in fed_axes:
        m *= sizes[a]
    m = max(m, 1)
    specs = leaf_specs(strategy, (x, y), m)
    structs = payload_structs(specs)
    if not fed_axes:
        fed_mesh = mesh[mesh.mesh_dim_names[0]]
    elif len(fed_axes) == 1:
        fed_mesh = mesh[fed_axes[0]]
    else:
        fed_mesh = mesh[tuple(fed_axes)]._flatten()
    # per agent: each buffer's rows as bytes, in leaf order
    widths = [[b.numel() * b.element_size() // m for b in _buffers(s)]
              for s in structs]

    def local_rows(b: torch.Tensor) -> torch.Tensor:
        if isinstance(b, DTensor):  # on the fed mesh
            return b.redistribute(fed_mesh, [Shard(0)]).to_local()
        n = b.shape[0] // fed_mesh.size()
        r = fed_mesh.get_local_rank()
        return b[r * n:(r + 1) * n]

    def rep(u: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(u, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    def step(payloads: List[LeafPayload], use_kernel: bool = True
             ) -> List[torch.Tensor]:
        rows = [local_rows(b).contiguous() for p in payloads for b in _buffers(p)]
        per_rank = m // fed_mesh.size()
        mine = torch.cat([u.view(torch.uint8).reshape(per_rank, -1) for u in rows],
                         dim=1)
        wire = DTensor.from_local(mine, fed_mesh, [Shard(0)], run_check=False)
        gathered = wire.redistribute(fed_mesh, [Replicate()]).to_local()  # [m, bytes]
        out, at = [], 0
        for p, spec, ws in zip(structs, specs, widths):
            bufs = []
            for b, w in zip(_buffers(p), ws):
                bufs.append(gathered[:, at:at + w].contiguous().view(b.dtype)
                            .reshape(b.shape))
                at += w
            it = iter([rep(u) for u in bufs] if use_kernel else bufs)
            full = LeafPayload(*(None if b is None else next(it) for b in p))
            dense = decode_leaf(full, spec, use_kernel=use_kernel)
            # the kernel decodes the replicated DTensors on each rank; the
            # plain version (the dry-run on `meta`) the local buffers
            out.append(dense if use_kernel else rep(dense))
        return out

    expected = sum(s.wire_bytes() for s in specs)
    return step, (structs,), expected
