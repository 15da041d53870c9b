"""Executed-op census of a step (the port's counterpart of
`repro/launch/hlo_census.py`).

`Census` is a `TorchDispatchMode`: every aten op the step executes on
this rank passes through it, below DTensor (an op on DTensors is handed on
to DTensor, whose local ops and collectives then come through) and below
`torch.func`'s transforms.  It counts

  * matmul FLOPs: 2*M*N*K over `mm` / `bmm` / `addmm` / `baddbmm` (an
    einsum or a matmul reaches one of them), on this rank's local shapes;
  * collectives per kind (all-reduce, all-gather, reduce-scatter,
    all-to-all), their count and bytes, the bytes of the collective's
    result on one rank (the convention of `HloCensus`'s result shapes);
  * duplicate matmul shapes (the remat / redundancy smell test).

The port runs every loop of a step eagerly (layers, local steps, chunks),
so its counts are executed counts by construction: the trip-count
propagation through while bodies, fusions and calls that `HloCensus`
needs for XLA's static HLO has no counterpart, nor has its upper bound on
conditionals (the zamba2 shared block is a plain `if` here).  Elementwise
FLOPs are ignored, as there.

Only what this rank executes counts.  DTensor's sharding propagation runs
each new op signature once on `FakeTensor`s at the global shapes, under a
fake mode; those ops pass through the mode too and count toward nothing
(no FLOPs, no collectives, no duplicate shapes), so an op's first call
counts as its cached calls do.  On a CPU mesh DTensor stands in an
all-gather and a chunk for the all-to-all of a shard-to-shard
redistribution (gloo has no all-to-all); the census counts it as the
all-to-all it is on a device mesh, with its result's bytes.
"""
from __future__ import annotations

import math
import sys
from collections import defaultdict
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
#: functional and c10d collectives by kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


def _dtype_str(dt: torch.dtype) -> str:
    return {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
            torch.float16: "f16"}.get(dt, str(dt).replace("torch.", ""))


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _alltoall_fallback() -> bool:
    """The all-gather runs inside DTensor's `shard_dim_alltoall`, which on
    a CPU mesh gathers and keeps its own chunk (gloo has no all-to-all)."""
    f = sys._getframe(2)
    for _ in range(60):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _propagating(types) -> bool:
    """The op runs on `FakeTensor`s, or under a fake mode: DTensor's
    sharding propagation tracing an op's global shapes (once per new op
    signature), which this rank never executes."""
    return (any(issubclass(t, FakeTensor) for t in types)
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
            is not None)


class Census(TorchDispatchMode):
    """Counts what runs inside `with Census() as c:`; `c.summary()` gives
    JAX's keys: executed_dot_flops, collectives_executed
    ({kind: {count, bytes}}) and duplicate_dot_shapes (the 12 most
    repeated result shapes)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.shape_counts: Dict[str, int] = defaultdict(int)
        self.collectives: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # let DTensor lower the op to local ops and collectives first
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating(types):
            return out
        name = func._overloadpacket.__name__
        if name in _MATMULS:
            a, b = args[_MATMULS[name]], args[_MATMULS[name] + 1]
            batch = math.prod(a.shape[:-2])
            self.dot_flops += 2 * batch * a.shape[-2] * b.shape[-1] * a.shape[-1]
            key = f"{_dtype_str(out.dtype)}[{','.join(str(d) for d in out.shape)}]"
            self.shape_counts[key] += 1
        elif name in _COLLECTIVES:
            kind, nbytes = _COLLECTIVES[name], _nbytes(out)
            if kind == "all-gather" and _alltoall_fallback():
                # DTensor's stand-in on a CPU mesh for the all-to-all of a
                # shard-to-shard redistribution: counted as that all-to-all
                kind, nbytes = "all-to-all", _nbytes(args[0])
            s = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            s["count"] += 1
            s["bytes"] += nbytes
        return out

    def summary(self) -> Dict:
        dup = {s: c for s, c in self.shape_counts.items() if c > 1}
        return {
            "executed_dot_flops": self.dot_flops,
            "collectives_executed": {k: dict(v) for k, v in self.collectives.items()},
            "duplicate_dot_shapes": dict(
                sorted(dup.items(), key=lambda kv: -kv[1])[:12]),
        }
