"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in `repro/kernels/ref.py`).  The CPU path of every kernel wrapper
runs these, and the chip check holds each kernel against them."""
from __future__ import annotations

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 in, f64 math; anything narrower (f32/bf16/f16/float8) runs in
    f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def gt_update_ref(
    z: torch.Tensor, g: torch.Tensor, c: torch.Tensor, eta: float, sign: float
) -> torch.Tensor:
    """Fused FedGDA-GT inner update: z + sign*eta*(g + c).

    The arithmetic runs in `compute_dtype(z.dtype)`, one rounding per
    operation and in this order: s = sign*eta rounded once to the compute
    type, then g + c, then s * (g + c), then z + that, cast back to z's
    dtype (round to nearest).  c is read in its stored type and converted
    exactly.  For f64 and f32 leaves this is `engine.default_update`'s
    math; for bf16 leaves it is the Pallas kernel's (f32 math, cast back),
    and the CUDA kernel reproduces it bit for bit."""
    ct = compute_dtype(z.dtype)
    # a Python float times a tensor rounds the scalar to the tensor's
    # (compute) type first, on the CPU and on CUDA alike
    upd = (g.to(ct) + c.to(ct)) * (float(sign) * float(eta))
    return (z.to(ct) + upd).to(z.dtype)
