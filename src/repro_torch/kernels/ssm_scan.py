"""Selective scan: h_t = da_t * h_{t-1} + dbx_t,  y_t = <h_t, c_t>, and
its gradient.

Port of `repro/kernels/ssm_scan.py` `ssm_scan`.  The CUDA kernel
(`csrc/ssm_scan.cu`) gives each (batch, head, channel) row a group of
lanes of one warp that holds its N states in registers and runs the whole
sequence as a loop, reducing <h_t, c_t> with warp shuffles.  It returns y
and the final state, from `state0` or zero (the TPU kernel returned y
alone, from zero; the serving path fills its SSM cache with the final
state).  `da` is read through its strides, so Mamba-2's per-head decay
[B, S, H, 1, 1] is never expanded to dbx's size.

The gradient is the kernel of `csrc/ssm_scan_bwd.cu` (`ssm_scan_bwd`),
which has no TPU counterpart: JAX differentiates its plain scan.  The
forward then also stores the state entering every chunk of T steps
(`chunk_len`), from which the backward recomputes h_{t-1}; d da comes
back in da's own shape, reduced inside the kernel where da broadcasts.
`ssm_scan` is a `torch.autograd.Function` wherever a gradient may be
asked for (an input that requires one, or a `torch.func.vmap` over it):
its `vmap` rule folds the mapped axis into the batch axis, so the kernels
see plain tensors.  Without either it calls the forward directly.

On a CPU tensor every function here runs its plain version
(`ref.ssm_scan_ref`; the backward is `torch.func.vjp` of it); on a CUDA
tensor it launches the kernel or raises.  `ssm_scan.launches` and
`ssm_scan_bwd.launches` count kernel launches only.

On DTensors each function runs on the local shards (`_dtensor`): batch,
heads and channels may stay sharded, time and states are replicated; a
gradient that sums over a sharded axis (d c, a broadcast d da) comes back
`Partial`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref
from ._dtensor import is_dtensor, local_call
from ._functorch import fold, traced, unfold

#: {dbx [B, S, H, P, N] dim: the operand's dim}: batch, heads and channels
#: may stay sharded
_FULL = {d: d for d in range(5)}
_ROWS = {0: 0, 2: 2, 3: 3}      # y [B, S, H, P], chunk states [B, n, H, P, N]
_STATE = {0: 0, 2: 1, 3: 2}     # state [B, H, P, N]
_BATCH = {0: 0}                 # c [B, S, N]
_KEEP = (0, 2, 3)


def _local(fn, dbx, da, rest, rest_maps, out_maps, out_shapes, reduces=None):
    """fn(da, dbx, *rest) on the local shards of DTensor operands, dbx
    leading."""
    return local_call(lambda dbx, da, *rest: fn(da, dbx, *rest), (dbx, da, *rest),
                      (_FULL, _FULL, *rest_maps), _KEEP, out_maps, out_shapes,
                      reduces)

MAX_STATE = 256
_INT32 = 2**31 - 1


def _library() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ll, ll, p]
        fn.restype = i
        lib.ssm_scan_error_string.argtypes = [i]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def chunk_len(N: int) -> int:
    """Steps per chunk of the backward for N states: the forward
    (`csrc/ssm_scan.cu`) stores the state entering every chunk, and the
    backward (`csrc/ssm_scan_bwd.cu` `chunk_len`) stages a chunk's dbx in
    shared memory, 16 steps up to 128 states and 8 above."""
    return 16 if N <= 128 else 8


def _as_5d(da, dbx, c_coef, state0, expand: bool = True):
    """The operands in the kernel's layout: dbx [B, S, H, P, N], da of
    dbx's rank with each axis 1 or dbx's (with `expand`, a stride-0 view
    of dbx's shape, never copied), c [B, S, N], state0 [B, H, P, N] or
    None."""
    nd = dbx.dim()
    if nd not in (3, 4, 5):
        raise ValueError("ssm_scan: dbx must be [S, D, N], [B, S, D, N] or "
                         f"[B, S, H, P, N], got {tuple(dbx.shape)}")
    if da.dim() > nd or any(a not in (1, b) for a, b in zip(
            da.shape[::-1], dbx.shape[::-1])):
        raise ValueError(f"ssm_scan: da {tuple(da.shape)} does not broadcast "
                         f"to dbx {tuple(dbx.shape)}")
    da = da.reshape((1,) * (nd - da.dim()) + tuple(da.shape))
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
    if expand:
        da = da.expand(dbx.shape)
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
    are contiguous; state0 None starts from zero.  Differentiable in all
    four (the final state's cotangent seeds the reverse recurrence),
    under `torch.func.vmap` too."""
    if dbx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: no kernel for device {dbx.device}")
    operands = [t for t in (da, dbx, c_coef, state0) if t is not None]
    if traced(*operands):
        shape = dbx.shape
        da5, dbx5, c5, s05 = _as_5d(da, dbx, c_coef, state0, expand=False)
        _check(da5.expand(dbx5.shape), dbx5, c5, s05)
        y, state, _ = _SSMScan.apply(da5, dbx5, c5, s05)
        return y.reshape(shape[:-1]), state.reshape(_state_shape(shape))
    if dbx.device.type == "cpu":
        return plain_ssm_scan(da, dbx, c_coef, state0)
    return _in_layout(_launch, da, dbx, c_coef, state0)


def plain_ssm_scan(
    da: torch.Tensor, dbx: torch.Tensor, c_coef: torch.Tensor,
    state0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version (`ref.ssm_scan_ref`) in `ssm_scan`'s layouts, on
    any device.  On `meta` under `torch.func` (the dry-run's training
    step) it runs as `ssm_scan`'s autograd Function does: the agent axis
    folded into the batch and, on DTensors, the recurrence and its vjp on
    the local shards, not op by op through DTensor's dispatch at every
    position."""
    operands = [t for t in (da, dbx, c_coef, state0) if t is not None]
    if dbx.device.type == "meta" and traced(*operands):
        shape = dbx.shape
        da5, dbx5, c5, s05 = _as_5d(da, dbx, c_coef, state0, expand=False)
        y, state, _ = _SSMScan.apply(da5, dbx5, c5, s05)
        return y.reshape(shape[:-1]), state.reshape(_state_shape(shape))
    return _in_layout(ref.ssm_scan_ref, da, dbx, c_coef, state0)


def _in_layout(scan, da, dbx, c_coef, state0):
    """`scan` over the operands in the kernel's [B, S, H, P, N] layout,
    its outputs back in the caller's."""
    shape = dbx.shape
    da5, dbx5, c5, s05 = _as_5d(da, dbx, c_coef, state0)
    _check(da5, dbx5, c5, s05)
    if is_dtensor(da5, dbx5, c5, s05):
        B, S, H, P, N = dbx5.shape
        y, state = _local(scan, dbx5, da5, (c5, s05), (_BATCH, _STATE),
                          (_ROWS, _STATE), ((B, S, H, P), (B, H, P, N)))
    else:
        y, state = scan(da5, dbx5, c5, s05)
    return y.reshape(shape[:-1]), state.reshape(_state_shape(shape))


def _state_shape(shape) -> tuple:
    """The final state's shape for dbx of `shape`: dbx's without the
    sequence axis."""
    if len(shape) == 3:
        return tuple(shape[1:])
    return (shape[0], *shape[2:])


def _launch(da, dbx, c, state0, chunks: bool = False):
    """(y, state), and with `chunks` the states entering every chunk of
    `chunk_len(N)` steps [B, ceil(S / T), H, P, N], from the kernel."""
    B, S, H, P, N = dbx.shape
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=dbx.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=dbx.device)
    T = chunk_len(N)
    saved = (torch.empty(B, -(-S // T), H, P, N, dtype=torch.float32,
                         device=dbx.device) if chunks else None)
    out = (y, state) if not chunks else (y, state, saved)
    if B * H * P == 0:
        return out
    if S == 0:
        state.copy_(state0 if state0 is not None else torch.zeros_like(state))
        return out
    da_strides = (ctypes.c_longlong * 5)(*da.stride())
    c_strides = (ctypes.c_longlong * 3)(*c.stride())
    lib = _library()
    with torch.cuda.device(dbx.device):
        stream = torch.cuda.current_stream(dbx.device).cuda_stream
        err = lib.ssm_scan_launch(
            da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
            None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            None if saved is None else saved.data_ptr(), B, S, H, P, N,
            da_strides, c_strides, stream,
        )
    if err != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0


class _SSMScan(torch.autograd.Function):
    """(y, state, chunk states) over the 5-D layout with da of dbx's rank
    (each axis 1 or dbx's); differentiable in da, dbx, c and state0."""

    @staticmethod
    def forward(da, dbx, c, state0):
        if is_dtensor(da, dbx, c, state0):
            B, S, H, P, N = dbx.shape
            on_card = dbx.device.type == "cuda"
            chunks = (B, -(-S // chunk_len(N)), H, P, N) if on_card else (0,)
            return _local(_SSMScan.forward, dbx, da, (c, state0), (_BATCH, _STATE),
                          (_ROWS, _STATE, _ROWS if on_card else {}),
                          ((B, S, H, P), (B, H, P, N), chunks))
        dae = da.expand(dbx.shape)
        if dbx.device.type in ("cpu", "meta"):
            y, state = ref.ssm_scan_ref(dae, dbx, c, state0)
            return y, state, torch.empty(0, device=dbx.device)
        return _launch(dae, dbx, c, state0, chunks=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        da, dbx, c, state0 = inputs
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(da, dbx, c, state0, output[2])

    @staticmethod
    def backward(ctx, dy, dstate, _dchunks):
        da, dbx, c, state0, chunks = ctx.saved_tensors
        dda, ddbx, dc, ds0 = ssm_scan_bwd(da, dbx, c, state0, dy, dstate,
                                          chunks=chunks)
        return dda, ddbx, dc, (None if state0 is None else ds0)

    @staticmethod
    def vmap(info, in_dims, da, dbx, c, state0):
        n = info.batch_size
        d_da, d_dbx, d_c, d_s0 = in_dims
        dbx_f = fold(dbx, d_dbx, n)
        B = dbx_f.shape[0] // n
        da = da.expand(n, *da.shape) if d_da is None else da.movedim(d_da, 0)
        # a broadcast da's batch axis may be 1: repeat it to B, then fold
        da = da.expand(n, B, *da.shape[2:]).reshape(n * B, *da.shape[2:])
        y, state, chunks = _SSMScan.apply(da, dbx_f, fold(c, d_c, n),
                                          fold(state0, d_s0, n))
        if chunks.dim() == 1:  # the plain version saves none
            return (unfold(y, n), unfold(state, n), chunks), (0, 0, None)
        return (unfold(y, n), unfold(state, n), unfold(chunks, n)), (0, 0, 0)


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("ssm_scan_bwd")
    fn = lib.ssm_scan_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p] * 12 + [i] * 7 + [ll, ll, p]
        fn.restype = i
        lib.ssm_scan_bwd_plan.argtypes = [i] * 6 + [ll]
        lib.ssm_scan_bwd_plan.restype = i
        lib.ssm_scan_bwd_error_string.argtypes = [i]
        lib.ssm_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_plan(B: int, H: int, P: int, N: int, da_mode: int, reduce_p: bool) -> dict:
    """The backward's plan (from the built library) for dbx [B, S, H, P, N],
    da full over the states (da_mode 0) or broadcast over them (1), and
    d da wanted summed over P (`reduce_p`): rows a CTA, CTAs over a
    batch's rows (dc's partials), heads whose d da a CTA sums over P (0:
    a second pass does), steps per chunk, threads per CTA and dynamic
    shared memory in bytes."""
    out = (ctypes.c_longlong * 6)()
    lib = _bwd_library()
    err = lib.ssm_scan_bwd_plan(B, H, P, N, da_mode, int(reduce_p), out)
    if err != 0:
        raise ValueError("ssm_scan_bwd: no plan: "
                         + lib.ssm_scan_bwd_error_string(err).decode())
    keys = ("rows_per_cta", "parts", "heads_per_cta", "chunk_len", "threads",
            "smem_bytes")
    return dict(zip(keys, out))


def plain_ssm_scan_bwd(da, dbx, c, state0, dy, dstate=None):
    """(d da, d dbx, d c, d state0) of the plain version
    (`ref.ssm_scan_ref` over the 5-D layout, da of dbx's rank broadcast)
    for the cotangents dy [B, S, H, P] and dstate [B, H, P, N] (None:
    zero), by `torch.func.vjp`; d da in da's shape, d state0 zero-based
    when state0 is None."""
    s0 = torch.zeros(dbx.shape[0], *dbx.shape[2:], dtype=torch.float32,
                     device=dbx.device) if state0 is None else state0
    if dbx.device.type == "meta":  # shapes only (`ref.ssm_scan_ref`)
        return tuple(torch.empty(t.shape, dtype=torch.float32, device="meta")
                     for t in (da, dbx, c, s0))

    def fwd(da, dbx, c, s0):
        return ref.ssm_scan_ref(da.expand(dbx.shape), dbx, c, s0)

    (y, state), vjp = torch.func.vjp(fwd, da, dbx, c, s0)
    dy = torch.zeros_like(y) if dy is None else dy
    dstate = torch.zeros_like(state) if dstate is None else dstate
    return vjp((dy, dstate))


def ssm_scan_bwd(da, dbx, c, state0, dy, dstate=None, *, chunks=None):
    """(d da, d dbx, d c, d state0) of the scan over the 5-D layout (da of
    dbx's rank, each axis 1 or dbx's) for the cotangents dy [B, S, H, P]
    and dstate [B, H, P, N] (None: zero); d da comes back in da's shape,
    d state0 is the state's whether or not state0 was given.  On a CPU
    tensor the plain version's (`plain_ssm_scan_bwd`); on a CUDA tensor
    the kernel, which sums in a fixed order (two calls give the same
    bits), or raises.  `chunks` are the forward's chunk states
    (`_launch(..., chunks=True)`), which the kernel needs."""
    if is_dtensor(da, dbx, c, state0, dy, dstate, chunks):
        B, S, H, P, N = dbx.shape
        on_card = chunks is not None and chunks.dim() == 5
        return _local(
            lambda *ts: ssm_scan_bwd(*ts[:6], chunks=ts[6]), dbx, da,
            (c, state0, dy, dstate, chunks),
            (_BATCH, _STATE, _ROWS, _STATE, _ROWS if on_card else {}),
            (_FULL, _FULL, _BATCH, _STATE),
            (da.shape, dbx.shape, (B, S, N), (B, H, P, N)),
            reduces=(True, False, True, False))
    if dbx.device.type in ("cpu", "meta"):
        return plain_ssm_scan_bwd(da, dbx, c, state0, dy, dstate)
    if dbx.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd: no kernel for device {dbx.device}")
    B, S, H, P, N = dbx.shape
    if da.dim() != 5 or any(a not in (1, b) for a, b in zip(da.shape, dbx.shape)):
        raise ValueError(f"ssm_scan_bwd: da {tuple(da.shape)} must have dbx's "
                         f"rank, each axis 1 or dbx's {tuple(dbx.shape)}")
    dae = da.expand(dbx.shape)
    _check(dae, dbx, c, state0)
    nch = -(-S // chunk_len(N))
    if chunks is None or tuple(chunks.shape) != (B, nch, H, P, N):
        raise ValueError(f"ssm_scan_bwd: the forward's chunk states [B, {nch}, H, P, N] "
                         "are needed on a card")
    dev = dbx.device
    if dy is None:
        dy = torch.zeros(B, S, H, P, dtype=torch.float32, device=dev)
    dy = dy.contiguous()
    dstate = None if dstate is None else dstate.contiguous()
    if tuple(dy.shape) != (B, S, H, P) or (
            dstate is not None and tuple(dstate.shape) != (B, H, P, N)):
        raise ValueError("ssm_scan_bwd: cotangents of the wrong shape")
    mode = 0 if da.shape[4] == N else 1  # da full over the states, or not
    reduce_p = mode == 1 and da.shape[3] == 1 and P > 1
    empty = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)
    ddbx = empty(B, S, H, P, N)
    dda_heads = empty(B, S, H) if reduce_p else None
    dc = empty(B, S, N)
    ds0 = empty(B, H, P, N)
    if B * H * P * S == 0:
        return (torch.zeros_like(da), ddbx.zero_(), dc.zero_(),
                ds0.copy_(torch.zeros_like(ds0) if dstate is None else dstate))
    lib = _bwd_library()
    plan = bwd_plan(B, H, P, N, mode, reduce_p)
    # d da a row: none where the kernel's CTAs sum whole heads over P
    dda = (empty(B, S, H, P, N) if mode == 0 else
           None if reduce_p and plan["heads_per_cta"] else empty(B, S, H, P))
    dc_part = empty(B, plan["parts"], S, N)
    da_strides = (ctypes.c_longlong * 5)(*dae.stride())
    c_strides = (ctypes.c_longlong * 3)(*c.stride())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssm_scan_bwd_launch(
            dae.data_ptr(), dbx.data_ptr(), c.data_ptr(), chunks.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            ddbx.data_ptr(), None if dda is None else dda.data_ptr(),
            None if dda_heads is None else dda_heads.data_ptr(), dc.data_ptr(),
            dc_part.data_ptr(), ds0.data_ptr(), B, S, H, P, N, mode,
            int(reduce_p), da_strides, c_strides, stream,
        )
    if err != 0:
        raise RuntimeError("ssm_scan_bwd kernel launch failed: "
                           + lib.ssm_scan_bwd_error_string(err).decode())
    ssm_scan_bwd.launches += 1
    if reduce_p:
        dda = dda_heads.view(B, S, H, 1, 1)
    elif mode == 1:
        dda = dda.view(B, S, H, P, 1)
    return dda.sum_to_size(da.shape), ddbx, dc, ds0


ssm_scan_bwd.launches = 0
