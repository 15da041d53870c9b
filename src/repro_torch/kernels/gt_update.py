"""Fused FedGDA-GT inner-loop update: z <- z + sign*eta*(g + c).

Port of `repro/kernels/gt_update.py` `gt_update_2d`.  The CUDA kernel
(`csrc/gt_update.cu`) streams z, g and the correction c (which may be
stored narrower: bf16 or fp8 e4m3) once and writes the update, computing
in `ref.compute_dtype(z.dtype)`.  It takes any shape: a flat loop over
numel that masks its own ragged tail, so the TPU's [rows, 128] padding
is gone.

On a CPU tensor `gt_update` runs the plain version (`ref.gt_update_ref`);
on a CUDA tensor it launches the kernel or raises — there is no fallback.
`gt_update.launches` counts kernel launches (never plain-version calls),
so a run can show its main path went through the kernel; set it to 0 to
start a count.  On DTensors it runs on the local shards (`_dtensor`),
under z's placements: the update is elementwise, so any placement is
shard-local, and g and c are brought to z's.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._dtensor import is_dtensor, local_call
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


def _library() -> ctypes.CDLL:
    lib = _build.load("gt_update")
    fn = lib.gt_update_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.gt_update_error_string.argtypes = [ctypes.c_int]
        lib.gt_update_error_string.restype = ctypes.c_char_p
    return lib


def _check(z: torch.Tensor, g: torch.Tensor, c: torch.Tensor) -> None:
    if not (z.device == g.device == c.device):
        raise ValueError(
            f"gt_update: z, g, c on different devices "
            f"({z.device}, {g.device}, {c.device})"
        )
    if z.shape != g.shape or z.shape != c.shape:
        raise ValueError(
            f"gt_update: shapes differ: z {tuple(z.shape)}, "
            f"g {tuple(g.shape)}, c {tuple(c.shape)}"
        )
    if g.dtype != z.dtype or c.dtype not in SUPPORTED.get(z.dtype, ()):
        raise TypeError(
            f"gt_update: unsupported dtypes z={z.dtype}, g={g.dtype}, "
            f"c={c.dtype}; supported (z=g, c): "
            + ", ".join(f"{k}: {v}" for k, v in SUPPORTED.items())
        )
    if not (z.is_contiguous() and g.is_contiguous() and c.is_contiguous()):
        raise ValueError("gt_update: z, g and c must be contiguous")


def gt_update(
    z: torch.Tensor, g: torch.Tensor, c: torch.Tensor, *, eta: float,
    sign: float,
) -> torch.Tensor:
    """z + sign*eta*(g + c) in `compute_dtype(z)`, returned in z's dtype.

    z and g share a dtype (f64, f32 or bf16); c is f64/f32/bf16/fp8 e4m3
    per `SUPPORTED`.  All three are contiguous, of one shape, on one
    device."""
    _check(z, g, c)
    if is_dtensor(z, g, c):
        ident = {d: d for d in range(z.dim())}
        return local_call(
            lambda z, g, c: gt_update(z, g, c, eta=eta, sign=sign), (z, g, c),
            (ident,) * 3, keep=range(z.dim()), out_maps=(ident,),
            out_shapes=(z.shape,))
    if z.device.type == "cpu":
        return gt_update_ref(z, g, c, eta, sign)
    if z.device.type != "cuda":
        raise ValueError(f"gt_update: no kernel for device {z.device}")
    out = torch.empty_like(z)
    if z.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.gt_update_launch(
            z.data_ptr(), g.data_ptr(), c.data_ptr(), out.data_ptr(),
            z.numel(), _CODES[z.dtype], _CODES[c.dtype],
            float(sign) * float(eta), stream,
        )
    if err != 0:
        raise RuntimeError(
            "gt_update kernel launch failed: "
            + lib.gt_update_error_string(err).decode()
        )
    gt_update.launches += 1
    return out


gt_update.launches = 0
