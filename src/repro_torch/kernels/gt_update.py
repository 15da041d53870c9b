"""Fused FedGDA-GT inner-loop update: z <- z + sign*eta*(g + c), over
every leaf of a tree in one launch.

Port of `repro/kernels/gt_update.py` `gt_update_2d`.  The CUDA kernel
(`csrc/gt_update.cu`) streams z, g and the correction c (which may be
stored narrower: bf16 or fp8 e4m3) once and writes the update, computing
in `ref.compute_dtype(z.dtype)`.  It takes any shape, and a table of up to
`TABLE_CAP` leaves per launch, each with its own scale s = sign * eta:
`gt_update_many` groups the leaves by (device, z dtype, c dtype) and makes
one launch per group and table (`plan_launches`), so that the engine's
local step updates x and y in one launch (`ops.make_gt_update_fn`'s
`pair`).  A thread moves 16 bytes of z per access where a leaf's pointers
are aligned; a ragged tail or a misaligned leaf runs scalar accesses.

On a CPU tensor a leaf runs the plain version (`ref.gt_update_ref`); on a
CUDA tensor it goes to the kernel or raises — there is no fallback.
`gt_update.launches` counts kernel launches and `gt_update.leaf_updates`
the leaves they updated (never plain-version calls), so a run can show
its main path went through the kernel; set both to 0 to start a count.
On DTensors each leaf runs on its local shards, under z's placements
(`_dtensor.local_operands`): the update is elementwise, so any placement
is shard-local, and g and c are brought to z's.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import struct
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build
from ._dtensor import is_dtensor, local_operands
from .ref import gt_update_ref

#: dtype codes of the C launcher (`csrc/gt_update.cu` `DType`)
_CODES = {
    torch.float64: 0,
    torch.float32: 1,
    torch.bfloat16: 2,
    torch.float8_e4m3fn: 3,
}

#: (z/g dtype) -> correction dtypes the kernel takes
SUPPORTED = {
    torch.float64: (
        torch.float64, torch.float32, torch.bfloat16, torch.float8_e4m3fn
    ),
    torch.float32: (torch.float32, torch.bfloat16, torch.float8_e4m3fn),
    torch.bfloat16: (torch.bfloat16, torch.float8_e4m3fn),
}

#: the kernel's threads per block and leaves per launch
#: (`csrc/gt_update.cu` kThreads, kLargeCap)
THREADS = 256
TABLE_CAP = 256
#: bytes of z one vector access moves
VEC_BYTES = 16
#: blocks one leaf may take, per SM: one wave of 2048 threads an SM (a
#: leaf's blocks walk it grid-stride beyond that)
BLOCKS_PER_SM = 2048 // THREADS
#: one leaf of the launch table as the C launcher reads it (`Leaf`):
#: z, g, c, out, numel, s, blocks, vec
_LEAF = "4Qqdii"

_lib = None
_max_blocks: Dict[int, int] = {}
_raw_stream = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("gt_update")
        fn = lib.gt_update_many_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gt_update_error_string.argtypes = [ctypes.c_int]
        lib.gt_update_error_string.restype = ctypes.c_char_p
        for name, want in (("gt_update_table_capacity", TABLE_CAP),
                           ("gt_update_threads", THREADS)):
            got = getattr(lib, name)()
            if got != want:
                raise RuntimeError(f"gt_update: the library's {name} is {got}, "
                                   f"the wrapper's {want}")
        _lib = lib
    return _lib


def _stream(index: int) -> int:
    """The current CUDA stream of device `index` as a raw handle."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def _blocks_cap(index: int) -> int:
    cap = _max_blocks.get(index)
    if cap is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cap = _max_blocks[index] = sms * BLOCKS_PER_SM
    return cap


@functools.lru_cache(maxsize=None)
def _table(count: int) -> struct.Struct:
    """The packed launch table of `count` leaves."""
    return struct.Struct("<" + _LEAF * count)


def _check(z: torch.Tensor, g: torch.Tensor, c: torch.Tensor) -> None:
    """Raise on what the kernel does not take (device indices compared
    first: a CUDA leaf's check is on the engine's hot path)."""
    dev = z.get_device()
    if g.get_device() != dev or c.get_device() != dev or (
            dev < 0 and not z.device == g.device == c.device):
        raise ValueError(
            f"gt_update: z, g, c on different devices "
            f"({z.device}, {g.device}, {c.device})"
        )
    if z.shape != g.shape or z.shape != c.shape:
        raise ValueError(
            f"gt_update: shapes differ: z {tuple(z.shape)}, "
            f"g {tuple(g.shape)}, c {tuple(c.shape)}"
        )
    zdt = z.dtype
    if g.dtype != zdt or c.dtype not in SUPPORTED.get(zdt, ()):
        raise TypeError(
            f"gt_update: unsupported dtypes z={z.dtype}, g={g.dtype}, "
            f"c={c.dtype}; supported (z=g, c): "
            + ", ".join(f"{k}: {v}" for k, v in SUPPORTED.items())
        )
    if not (z.is_contiguous() and g.is_contiguous() and c.is_contiguous()):
        raise ValueError("gt_update: z, g and c must be contiguous")


def leaf_record(z: int, g: int, c: int, out: int, numel: int, z_size: int,
                c_size: int, s: float, max_blocks: int) -> tuple:
    """One leaf's table entry (z, g, c, out, numel, s, blocks, vec) from its
    pointers, numel and item sizes.  vec: z, g and out are 16-byte aligned
    and c is aligned to its V values (V = 16 / z_size); the kernel then
    moves numel // V vectors and numel % V scalars, else numel scalars.
    blocks: one per THREADS units, at most `max_blocks`."""
    v = VEC_BYTES // z_size
    vec = not ((z | g | out) & (VEC_BYTES - 1) or c & (v * c_size - 1))
    units = numel - (numel // v) * (v - 1) if vec else numel
    blocks = min(-(-units // THREADS), max_blocks)
    return (z, g, c, out, numel, s, blocks, int(vec))


def plan_launches(leaves: Sequence[tuple], max_blocks: int,
                  cap: int = TABLE_CAP) -> List[Tuple[object, list]]:
    """The launches of one `gt_update_many` call: leaves = (key, z, g, c,
    out, numel, z_size, c_size, s) with key the (device, z dtype, c dtype)
    a launch holds.  Returns [(key, [leaf_record, ...])], one entry per
    launch: the leaves grouped by key in order of first appearance, each
    group cut into tables of at most `cap`; empty leaves take no entry."""
    groups: Dict[object, list] = {}
    for key, z, g, c, out, numel, z_size, c_size, s in leaves:
        if numel:
            groups.setdefault(key, []).append(
                leaf_record(z, g, c, out, numel, z_size, c_size, s, max_blocks))
    return [(key, recs[i:i + cap]) for key, recs in groups.items()
            for i in range(0, len(recs), cap)]


def _launch(plan, lib) -> None:
    for (index, zdt, cdt), recs in plan:
        table = _table(len(recs)).pack(*itertools.chain.from_iterable(recs))
        err = lib.gt_update_many_launch(table, len(recs), _CODES[zdt], _CODES[cdt],
                                        index, _stream(index))
        if err != 0:
            raise RuntimeError("gt_update kernel launch failed: "
                               + lib.gt_update_error_string(err).decode())
        gt_update.launches += 1
        gt_update.leaf_updates += len(recs)


def gt_update_many(
    zs: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
    cs: Sequence[torch.Tensor], scales: Sequence[float],
) -> List[torch.Tensor]:
    """[z + s*(g + c) for each leaf] in `compute_dtype(z)`, each returned in
    its z's dtype; s = scales[i] is the leaf's sign * eta.  Each leaf
    follows `gt_update`'s rules; the CUDA leaves of one (device, z dtype,
    c dtype) go to one launch per table of `TABLE_CAP` leaves."""
    n = len(zs)
    if not (len(gs) == len(cs) == len(scales) == n):
        raise ValueError(f"gt_update_many: {n} z, {len(gs)} g, {len(cs)} c and "
                         f"{len(scales)} scales")
    outs: List = [None] * n
    leaves, wraps = [], []
    tensor = torch.Tensor
    for i in range(n):
        z, g, c, s = zs[i], gs[i], cs[i], float(scales[i])
        if not (type(z) is tensor and type(g) is tensor and type(c) is tensor) \
                and is_dtensor(z, g, c):
            (z, g, c), wrap = local_operands((z, g, c))  # checked as local shards
            wraps.append((i, wrap))
        _check(z, g, c)
        if not z.is_cuda:
            if z.device.type != "cpu":
                raise ValueError(f"gt_update: no kernel for device {z.device}")
            outs[i] = gt_update_ref(z, g, c, s, 1.0)
            continue
        out = outs[i] = torch.empty_like(z)
        leaves.append(((z.get_device(), z.dtype, c.dtype), z.data_ptr(), g.data_ptr(),
                       c.data_ptr(), out.data_ptr(), z.numel(), z.element_size(),
                       c.element_size(), s))
    if leaves:
        plan = plan_launches(leaves, _blocks_cap(leaves[0][0][0]))
        if plan:
            _launch(plan, _library())
    for i, wrap in wraps:
        outs[i] = wrap(outs[i])
    return outs


def gt_update(
    z: torch.Tensor, g: torch.Tensor, c: torch.Tensor, *, eta: float,
    sign: float,
) -> torch.Tensor:
    """z + sign*eta*(g + c) in `compute_dtype(z)`, returned in z's dtype:
    `gt_update_many`'s one-leaf case.

    z and g share a dtype (f64, f32 or bf16); c is f64/f32/bf16/fp8 e4m3
    per `SUPPORTED`.  All three are contiguous, of one shape, on one
    device."""
    return gt_update_many((z,), (g,), (c,), (float(sign) * float(eta),))[0]


gt_update.launches = 0
gt_update.leaf_updates = 0
