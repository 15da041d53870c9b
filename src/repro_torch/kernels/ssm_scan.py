"""Selective scan: h_t = da_t * h_{t-1} + dbx_t,  y_t = <h_t, c_t>.

Port of `repro/kernels/ssm_scan.py` `ssm_scan`.  The CUDA kernel
(`csrc/ssm_scan.cu`) gives each (batch, head, channel) row a group of
lanes of one warp that holds its N states in registers and runs the whole
sequence as a loop, reducing <h_t, c_t> with warp shuffles.  It returns y
and the final state, from `state0` or zero (the TPU kernel returned y
alone, from zero; the serving path fills its SSM cache with the final
state).  `da` is read through its strides, so Mamba-2's per-head decay
[B, S, H, 1, 1] is never expanded to dbx's size.

On a CPU tensor `ssm_scan` runs the plain version (`ref.ssm_scan_ref`);
on a CUDA tensor it launches the kernel or raises.  `ssm_scan.launches`
counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref

MAX_STATE = 256
_INT32 = 2**31 - 1


def _library() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ll, ll, p]
        fn.restype = i
        lib.ssm_scan_error_string.argtypes = [i]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _as_5d(da, dbx, c_coef, state0):
    """The operands in the kernel's layout: dbx [B, S, H, P, N], da a
    broadcast view of dbx's shape (stride 0 where it broadcasts, never
    copied), c [B, S, N], state0 [B, H, P, N] or None."""
    nd = dbx.dim()
    if nd not in (3, 4, 5):
        raise ValueError("ssm_scan: dbx must be [S, D, N], [B, S, D, N] or "
                         f"[B, S, H, P, N], got {tuple(dbx.shape)}")
    try:
        da = da.broadcast_to(dbx.shape)
    except RuntimeError as e:
        raise ValueError(f"ssm_scan: da {tuple(da.shape)} does not broadcast "
                         f"to dbx {tuple(dbx.shape)}") from e
    if nd == 3:  # one sequence, as the TPU kernel takes it
        da, dbx, c_coef = da[None], dbx[None], c_coef[None]
        state0 = None if state0 is None else state0[None]
    if dbx.dim() == 4:  # [B, S, D, N]: D channels of one state row each
        da, dbx = da.unsqueeze(3), dbx.unsqueeze(3)
        state0 = None if state0 is None else state0.unsqueeze(2)
    B, S, H, P, N = dbx.shape
    if tuple(c_coef.shape) != (B, S, N):
        raise ValueError(f"ssm_scan: c_coef {tuple(c_coef.shape)} must be "
                         f"[B, S, N] = {(B, S, N)}")
    if state0 is not None and tuple(state0.shape) != (B, H, P, N):
        raise ValueError(f"ssm_scan: state0 {tuple(state0.shape)} must be "
                         f"{(B, H, P, N)}")
    return da, dbx, c_coef, state0


def _check(da, dbx, c, state0) -> None:
    ts = [t for t in (da, dbx, c, state0) if t is not None]
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssm_scan: da, dbx, c_coef and state0 must be f32, got "
                        + ", ".join(str(t.dtype) for t in ts))
    if any(t.device != dbx.device for t in ts):
        raise ValueError("ssm_scan: operands on different devices")
    if not dbx.is_contiguous() or (state0 is not None and not state0.is_contiguous()):
        raise ValueError("ssm_scan: dbx and state0 must be contiguous")
    B, S, H, P, N = dbx.shape
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size {N} outside 1..{MAX_STATE}")
    if max(B, S, H, P) > _INT32:
        raise ValueError("ssm_scan: sizes beyond int32")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("ssm_scan: forward only (no backward kernel)")


def ssm_scan(
    da: torch.Tensor, dbx: torch.Tensor, c_coef: torch.Tensor,
    state0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the scan, all f32, in one of three layouts:

      dbx [S, D, N], c_coef [S, N], state0 [D, N] -> y [S, D] (one
        sequence: the TPU kernel's signature, plus the state);
      dbx [B, S, D, N], c_coef [B, S, N], state0 [B, D, N] -> y [B, S, D];
      dbx [B, S, H, P, N], c_coef [B, S, N], state0 [B, H, P, N]
        -> y [B, S, H, P] (Mamba-2's heads).

    da broadcasts to dbx and is read through its strides; dbx and state0
    are contiguous; state0 None starts from zero."""
    if dbx.device.type == "cpu":
        return plain_ssm_scan(da, dbx, c_coef, state0)
    if dbx.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {dbx.device}")
    return _in_layout(_launch, da, dbx, c_coef, state0)


def plain_ssm_scan(
    da: torch.Tensor, dbx: torch.Tensor, c_coef: torch.Tensor,
    state0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version (`ref.ssm_scan_ref`) in `ssm_scan`'s layouts, on
    any device."""
    return _in_layout(ref.ssm_scan_ref, da, dbx, c_coef, state0)


def _in_layout(scan, da, dbx, c_coef, state0):
    """`scan` over the operands in the kernel's [B, S, H, P, N] layout,
    its outputs back in the caller's."""
    shape = dbx.shape
    da5, dbx5, c5, s05 = _as_5d(da, dbx, c_coef, state0)
    _check(da5, dbx5, c5, s05)
    y, state = scan(da5, dbx5, c5, s05)
    return y.reshape(shape[:-1]), state.reshape(_state_shape(shape))


def _state_shape(shape) -> tuple:
    """The final state's shape for dbx of `shape`: dbx's without the
    sequence axis."""
    if len(shape) == 3:
        return tuple(shape[1:])
    return (shape[0], *shape[2:])


def _launch(da, dbx, c, state0):
    B, S, H, P, N = dbx.shape
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=dbx.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=dbx.device)
    if B * H * P == 0:
        return y, state
    if S == 0:
        state.copy_(state0 if state0 is not None else torch.zeros_like(state))
        return y, state
    da_strides = (ctypes.c_longlong * 5)(*da.stride())
    c_strides = (ctypes.c_longlong * 3)(*c.stride())
    lib = _library()
    with torch.cuda.device(dbx.device):
        stream = torch.cuda.current_stream(dbx.device).cuda_stream
        err = lib.ssm_scan_launch(
            da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
            None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N,
            da_strides, c_strides, stream,
        )
    if err != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    ssm_scan.launches += 1
    return y, state


ssm_scan.launches = 0
