"""Fused compressed-correction kernel: select + quantize + error feedback.

Port of `repro/kernels/compress_correction.py`.  The CompressedGT /
QuantizedGT strategies transform each tracking-correction leaf (flattened
to [R, C], a row per agent and quantization group) per round: inject the
feedback residual (ceff = c + e), keep exactly k entries (the largest
|ceff|, or a random k through the largest u_sel), quantize the kept values
stochastically to `bits` bits with a per-row scale, and hand back the
dropped mass as the new residual.  The CUDA kernels
(`csrc/compress_correction.cu`) stage a row in shared memory and select
there: a few rows each over a cluster of up to 8 CTAs (the strategies'
leaves have R = 16 rows), many rows one CTA a row;
`ref.compress_correction_ref` is their plain version.

The TPU kernel needed C % 128 == 0 (`fusable_leaf`) and tiled rows in
blocks; neither rule applies here: the kernels take every row length
(rows too long for shared memory stream from global memory).

Randomness arrives as U[0,1) inputs, as in the reference: the strategies
draw them with `repro_torch.prng` (JAX's threefry, bit for bit), so kernel,
plain version and JAX agree exactly on the same draws.

On a CPU tensor `compress_correction_2d` runs the plain version; on a CUDA
tensor it launches the kernel or raises, with no fallback.
`compress_correction_2d.launches` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref
from ._dtensor import is_dtensor, local_call

#: storage dtype codes of the C launchers (`csrc/row_select.cuh` `DType`)
DTYPE_CODES = {
    torch.float64: 0,
    torch.float32: 1,
    torch.bfloat16: 2,
    torch.float8_e4m3fn: 3,
}
#: dtype codes of the uniform draws
UNIFORM_CODES = {torch.float64: 0, torch.float32: 1}


#: the routes of the C launcher's plan (`csrc/compress_correction.cu` `Route`)
ROUTES = ("streaming", "staged", "cluster")
#: cluster sizes a caller may ask for (1: one CTA a row)
CLUSTER_SIZES = (1, 2, 4, 8)
_ERRORS = {
    -2: "the card admits no cluster of {cs} CTAs for this row "
        "(cudaOccupancyMaxActiveClusters = 0)",
    -3: "a row of {C} split over {cs} CTAs does not fit their shared memory",
}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("compress_correction")
        fn = lib.compress_correction_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i,
                       ctypes.c_double, ctypes.c_double, i, p, ctypes.POINTER(i)]
        fn.restype = i
        lib.compress_correction_staged.argtypes = [i, i, i]
        lib.compress_correction_staged.restype = i
        lib.compress_correction_auto_cluster.argtypes = [ctypes.c_longlong, i]
        lib.compress_correction_auto_cluster.restype = i
        lib.compress_correction_error_string.argtypes = [i]
        lib.compress_correction_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_leaf(name: str, c, e, u_sel, u_rnd, *, k: int, bits: int,
               mode: str) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Check one leaf's operands; returns the uniforms the kernel reads:
    (u_sel for rand-k with k < C else None, u_rnd for bits < 32 else
    None).  Raises on anything the kernel does not take."""
    if c.dim() != 2:
        raise ValueError(f"{name}: c must be [R, C], got shape {tuple(c.shape)}")
    if c.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {c.dtype}; supported: "
                        + ", ".join(map(str, DTYPE_CODES)))
    if mode not in ("topk", "randk"):
        raise ValueError(f"{name}: unknown mode {mode!r}")
    R, C = c.shape
    if C < 1 or int(k) < 1:
        raise ValueError(f"{name}: needs C >= 1 and k >= 1, got C={C}, k={k}")
    if int(bits) < 2:
        raise ValueError(f"{name}: quantization needs bits >= 2, got {bits}")
    us = u_sel if (mode == "randk" and k < C) else None
    ur = u_rnd if bits < 32 else None
    if mode == "randk" and k < C and u_sel is None:
        raise ValueError(f"{name}: rand-k selection needs u_sel")
    if bits < 32 and u_rnd is None:
        raise ValueError(f"{name}: stochastic rounding (bits < 32) needs u_rnd")
    if e is not None and (e.shape != c.shape or e.dtype != c.dtype):
        raise ValueError(f"{name}: e must match c's shape and dtype")
    for t, what in ((us, "u_sel"), (ur, "u_rnd")):
        if t is None:
            continue
        if t.shape != c.shape or t.dtype not in UNIFORM_CODES:
            raise ValueError(f"{name}: {what} must be f64 or f32 of c's shape, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if us is not None and ur is not None and us.dtype != ur.dtype:
        raise TypeError(f"{name}: u_sel and u_rnd must share a dtype")
    tensors = [t for t in (c, e, us, ur) if t is not None]
    if any(t.device != c.device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return us, ur


def quant_constants(bits: int) -> Tuple[float, float]:
    """(s, 1/s) as the host's doubles; the kernels round each once to the
    compute type, as JAX's weak-typed scalars are."""
    if bits >= 32:
        return 0.0, 0.0
    s = float(2 ** (bits - 1) - 1)
    return s, 1.0 / s


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def compress_correction_2d(
    c: torch.Tensor,
    e: Optional[torch.Tensor],
    u_sel: Optional[torch.Tensor],
    u_rnd: Optional[torch.Tensor],
    *,
    k: int,
    bits: int = 32,
    mode: str = "topk",
    cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chat, resid), both in c's dtype, of one [R, C] leaf (see the module
    docstring); bitwise equal to `ref.compress_correction_ref` on the same
    inputs.  c is f64 / f32 / bf16 / fp8 e4m3; e (or None) matches it; the
    uniforms are f64 or f32.

    `cluster` (CUDA only): None lets the launcher choose (`auto_cluster`),
    1 runs one CTA a row, 2 / 4 / 8 a cluster of that many CTAs a row,
    which raises where the card admits no such cluster or the row's
    slices do not fit their shared memory.  The route a launch took is
    in `compress_correction_2d.last_plan` (route, CTAs a row, threads a
    CTA)."""
    k, bits = int(k), int(bits)
    us, ur = check_leaf("compress_correction", c, e, u_sel, u_rnd,
                        k=k, bits=bits, mode=mode)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"compress_correction: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    if c.device.type == "cpu":
        return ref.compress_correction_ref(c, e, u_sel, u_rnd, k=k, bits=bits,
                                           mode=mode)
    if c.device.type != "cuda":
        raise ValueError(f"compress_correction: no kernel for device {c.device}")
    chat = torch.empty_like(c)
    resid = torch.empty_like(c)
    R, C = c.shape
    if R == 0:
        return chat, resid
    u = us if us is not None else ur
    s, inv_s = quant_constants(bits)
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(c.device):
        err = lib.compress_correction_launch(
            c.data_ptr(), ptr(e), ptr(us), ptr(ur), chat.data_ptr(),
            resid.data_ptr(), R, C, k, bits, int(mode == "topk"),
            DTYPE_CODES[c.dtype], UNIFORM_CODES[u.dtype] if u is not None else 0,
            s, inv_s, int(cluster or 0), stream_of(c), plan,
        )
    if err != 0:
        msg = _ERRORS.get(err)
        raise RuntimeError(
            "compress_correction kernel launch failed: "
            + (msg.format(cs=cluster or auto_cluster(R, C), C=C) if msg
               else lib.compress_correction_error_string(err).decode())
        )
    compress_correction_2d.launches += 1
    compress_correction_2d.last_plan = {"route": ROUTES[plan[0]], "cluster": plan[1],
                                        "threads": plan[2]}
    return chat, resid


compress_correction_2d.launches = 0
compress_correction_2d.last_plan = None


def auto_cluster(R: int, C: int) -> int:
    """The cluster size the launcher takes for R rows of C on this card:
    the largest of 8, 4, 2 with R x size <= SMs and C >= 128 x size, else
    1.  Needs the card."""
    return int(_library().compress_correction_auto_cluster(int(R), int(C)))


def staged_in_shared_memory(C: int, dtype: torch.dtype, randk: bool) -> bool:
    """Whether one CTA stages a row of C entries in shared memory on this
    card (longer rows stream from global memory).  Needs the card."""
    return bool(_library().compress_correction_staged(
        int(C), int(randk), DTYPE_CODES[dtype]))


def fusable_leaf(flat: torch.Tensor) -> bool:
    """The kernel takes every 2D leaf with a non-empty row: the TPU rule
    C % 128 == 0 of the reference does not apply on Hopper."""
    return flat.dim() == 2 and flat.shape[-1] > 0


def compress_leaf(
    c: torch.Tensor,
    e: Optional[torch.Tensor],
    u_sel: Optional[torch.Tensor],
    u_rnd: Optional[torch.Tensor],
    *,
    k: int,
    bits: int = 32,
    mode: str = "topk",
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strategy-facing dispatcher: `compress_correction_2d` (the kernel on
    a CUDA tensor, the plain version on a CPU one) unless `use_kernel` is
    off, which runs the plain version on any device.  Both are the same
    bits.  On DTensors either runs replicated on every rank (a row's k is
    chosen over the whole row), beside the draws each rank holds whole."""
    if is_dtensor(c, e):
        return local_call(
            lambda c, e, us, ur: compress_leaf(c, e, us, ur, k=k, bits=bits,
                                               mode=mode, use_kernel=use_kernel),
            (c, e, u_sel, u_rnd), ({},) * 4, keep=(), out_maps=({}, {}))
    if use_kernel and fusable_leaf(c):
        return compress_correction_2d(c, e, u_sel, u_rnd, k=k, bits=bits,
                                      mode=mode)
    return ref.compress_correction_ref(c, e, u_sel, u_rnd, k=k, bits=bits,
                                       mode=mode)
