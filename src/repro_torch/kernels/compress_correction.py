"""Fused compressed-correction kernel: select + quantize + error feedback.

Port of `repro/kernels/compress_correction.py`.  The CompressedGT /
QuantizedGT strategies transform each tracking-correction leaf (flattened
to [R, C], a row per agent and quantization group) per round: inject the
feedback residual (ceff = c + e), keep exactly k entries (the largest
|ceff|, or a random k through the largest u_sel), quantize the kept values
stochastically to `bits` bits with a per-row scale, and hand back the
dropped mass as the new residual.  The CUDA kernel
(`csrc/compress_correction.cu`) does it in one pass per row, one CTA per
row; `ref.compress_correction_ref` is its plain version.

The TPU kernel needed C % 128 == 0 (`fusable_leaf`) and tiled rows in
blocks; neither rule applies here: the kernel takes every row length
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


def _library() -> ctypes.CDLL:
    lib = _build.load("compress_correction")
    fn = lib.compress_correction_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i,
                       ctypes.c_double, ctypes.c_double, p]
        fn.restype = i
        lib.compress_correction_staged.argtypes = [i, i, i]
        lib.compress_correction_staged.restype = i
        lib.compress_correction_error_string.argtypes = [i]
        lib.compress_correction_error_string.restype = ctypes.c_char_p
    return lib


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chat, resid), both in c's dtype, of one [R, C] leaf (see the module
    docstring); bitwise equal to `ref.compress_correction_ref` on the same
    inputs.  c is f64 / f32 / bf16 / fp8 e4m3; e (or None) matches it; the
    uniforms are f64 or f32."""
    k, bits = int(k), int(bits)
    us, ur = check_leaf("compress_correction", c, e, u_sel, u_rnd,
                        k=k, bits=bits, mode=mode)
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
    with torch.cuda.device(c.device):
        err = lib.compress_correction_launch(
            c.data_ptr(), ptr(e), ptr(us), ptr(ur), chat.data_ptr(),
            resid.data_ptr(), R, C, k, bits, int(mode == "topk"),
            DTYPE_CODES[c.dtype], UNIFORM_CODES[u.dtype] if u is not None else 0,
            s, inv_s, stream_of(c),
        )
    if err != 0:
        raise RuntimeError(
            "compress_correction kernel launch failed: "
            + lib.compress_correction_error_string(err).decode()
        )
    compress_correction_2d.launches += 1
    return chat, resid


compress_correction_2d.launches = 0


def staged_in_shared_memory(C: int, dtype: torch.dtype, randk: bool) -> bool:
    """Whether a row of C entries runs staged in shared memory on this
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
