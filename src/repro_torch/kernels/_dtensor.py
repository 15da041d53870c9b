"""The kernels on DTensors: each entry point that reaches a kernel runs it
on the local shards through `torch.distributed.tensor.experimental.
local_map`, under placements for which that kernel is shard-local, so no
DTensor ever reaches `data_ptr()` and no path gives way to the plain
version.

A call names a leader operand and, for it, the tensor dims that may stay
sharded (`keep`).  The leader's placements keep `Shard(d)` for d in `keep`
where the size divides evenly and become `Replicate()` elsewhere (a
`Partial` is reduced).  Every other operand and every output follows the
leader through a map {leader dim: its dim}: `Shard` of the mapped dim,
`Replicate` where the dim is missing or has size 1 (a broadcast operand).
An output that sums over a sharded leader dim it lacks or broadcasts is
`Partial()` (`reduces`).  Operands are redistributed to those placements
(`redistribute_inputs`).  `gt_update_many` and `unpack_payload_many`,
whose one launch takes many leaves, place each leaf by the same rule
through `local_operands` and `local_rows` instead."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

DimMap = Dict[int, int]


def is_dtensor(*ts) -> bool:
    """Any of `ts` is a DTensor (without importing the distributed package
    where no tensor could be one)."""
    if not any(type(t).__name__ == "DTensor" for t in ts if t is not None):
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def _follow(lead, shape, dmap: DimMap, reduces: bool = False):
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for p in lead:
        if isinstance(p, Shard) and p.dim in dmap and (
                shape is None or shape[dmap[p.dim]] > 1):
            out.append(Shard(dmap[p.dim]))
        elif isinstance(p, Shard) and reduces:
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


def _leader_placements(lead, keep: Sequence[int], gqa=None, gqa_heads=None):
    """The leader's placements under the rule above: `Shard(d)` kept for d
    in `keep` where the size divides evenly (and, for `gqa`, the kv heads
    split alike), `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = lead.device_mesh
    lead_pl = []
    for i, p in enumerate(lead.placements):
        n = mesh.size(i)
        ok = isinstance(p, Shard) and p.dim in keep and lead.shape[p.dim] % n == 0
        if ok and gqa is not None and p.dim == 1:
            ok = gqa_heads % n == 0
        lead_pl.append(Shard(p.dim) if ok else Replicate())
    return lead_pl


def local_operands(operands: Sequence[torch.Tensor]):
    """Operands of one shape for an elementwise kernel, the first a
    DTensor: their local shards under `local_call(..., keep=every dim)`'s
    placements (each operand placed as the leader), and wrap(out), which
    makes a local output of the leader's shape the DTensor that
    `local_call` would return.  Plain operands pass through as they
    are."""
    from torch.distributed.tensor import DTensor

    lead = operands[0]
    mesh = lead.device_mesh
    lead_pl = _leader_placements(lead, range(lead.dim()))
    pl = _follow(lead_pl, lead.shape, {d: d for d in range(lead.dim())})
    local = tuple(t.redistribute(mesh, pl).to_local() if is_dtensor(t) else t
                  for t in operands)

    def wrap(out: torch.Tensor):
        return DTensor.from_local(out, mesh, pl, run_check=False)

    return local, wrap


def local_rows(operands: Sequence[Optional[torch.Tensor]], out_shape: Sequence[int]):
    """Operands of a row-wise kernel, the first a DTensor: their local
    shards under `local_call(..., keep=(0,))`'s placements, each operand's
    dim 0 following the leader's (None and plain tensors pass through),
    and wrap(out), which makes a local output the DTensor of global
    `out_shape` that `local_call` would return."""
    from torch.distributed.tensor import DTensor

    lead = operands[0]
    mesh = lead.device_mesh
    lead_pl = _leader_placements(lead, (0,))
    local = tuple(t.redistribute(mesh, _follow(lead_pl, t.shape, {0: 0})).to_local()
                  if is_dtensor(t) else t for t in operands)
    out_pl = _follow(lead_pl, out_shape, {0: 0})

    def wrap(out: torch.Tensor):
        return DTensor.from_local(out, mesh, out_pl, run_check=False)

    return local, wrap


def local_call(fn: Callable, operands: Sequence[Optional[torch.Tensor]],
               maps: Sequence[DimMap], keep: Sequence[int],
               out_maps: Sequence[DimMap],
               out_shapes: Optional[Sequence[Sequence[int]]] = None,
               out_reduces: Optional[Sequence[bool]] = None,
               gqa: Optional[tuple] = None):
    """fn(*local shards) over DTensor `operands` (the first is the leader;
    None and plain tensors pass through as they are), its outputs DTensors
    placed by `out_maps` over the global `out_shapes` (None: no size-1
    dims).  `keep=()` replicates every operand: each rank then runs the
    whole kernel, beside plain operands (uniform draws) that every rank
    holds whole.  `gqa` = (index of
    the kv operand, its heads dim): the leader's heads stay sharded only
    where the kv heads split alike."""
    from torch.distributed.tensor.experimental import local_map

    lead = operands[0]
    mesh = lead.device_mesh
    lead_pl = _leader_placements(
        lead, keep, gqa, None if gqa is None else operands[gqa[0]].shape[gqa[1]])
    in_pl = tuple(
        _follow(lead_pl, t.shape, m) if is_dtensor(t) else None
        for t, m in zip(operands, maps))
    reduces = out_reduces or [False] * len(out_maps)
    shapes = out_shapes or [None] * len(out_maps)
    out_pl = [_follow(lead_pl, s, m, r) for s, m, r in zip(shapes, out_maps, reduces)]
    run = local_map(fn, out_placements=tuple(out_pl) if len(out_pl) > 1 else out_pl[0],
                    in_placements=in_pl, device_mesh=mesh, redistribute_inputs=True)
    return run(*operands)
