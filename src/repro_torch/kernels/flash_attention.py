"""Blocked online-softmax (flash) attention, and its gradient.

Port of `repro/kernels/flash_attention.py` `flash_attention`.  The CUDA
kernel (`csrc/flash_attention.cu`) computes both products on Hopper's
tensor cores with `mma.sync`: f32 inputs as 3xTF32 (each operand split
into two TF32 parts, three products accumulated in f32, which keeps f32's
accuracy), bf16 inputs as bf16 products with f32 accumulation and P
rounded to bf16.  One warp owns 16 query rows and a CTA 64; K/V tiles of
64 or 32 keys (`plan`) stream through a ring of shared-memory stages
filled by `cp.async`; the running max, denominator and accumulator stay
in registers in f32.  Its bound is the tensor cores' rate (bf16 989
TFLOP/s, f32 as three TF32 products 165 TFLOP/s), and it skips the
tiles the causal / window masks exclude, as the TPU kernel does.  Unlike
the TPU kernel it takes any Sq, Skv and head_dim up to 256 (ragged ends
are masked inside), reads q/k/v through their strides, and does
grouped-query attention natively: k/v carry KV heads and q-head h reads
kv-head h // (H // KV), with no repeated K/V.

The gradient (f32 only; the JAX package trains in f32) is the kernel of
`csrc/flash_attention_bwd.cu` (`flash_attention_bwd`), which has no TPU
counterpart: JAX differentiates its plain attention.  The forward then
also leaves each row's log-sum-exp, from which the backward recomputes
P.  `flash_attention` is a `torch.autograd.Function` wherever a gradient
may be asked for (an input that requires one, or a `torch.func.vmap`
over it): its `vmap` rule folds the mapped axis into the batch axis, so
the kernels see plain tensors and the backward is an ordinary autograd
node.  Without either it calls the forward directly (the serving path).

On a CPU tensor every function here runs its plain version
(`ref.flash_attention_ref`; the backward is `torch.func.vjp` of it); on a
CUDA tensor it launches the kernel or raises.  `flash_attention.launches`
and `flash_attention_bwd.launches` count kernel launches only.

On DTensors each function runs on the local shards (`_dtensor`): batch and
heads may stay sharded (a q-head and its kv-head split alike), sequence
and head dim are replicated.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build, ref
from ._dtensor import is_dtensor, local_call
from ._functorch import fold, traced, unfold

#: the dims of [B, H, S, hd] operands a shard may split: batch and heads
_SHARDED = {0: 0, 1: 1}

#: dtype codes of the C launcher (`csrc/flash_attention.cu` `DType`)
DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 256
_INT32 = 2**31 - 1


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i,
                       ctypes.c_float, ctypes.c_float, i, p]
        fn.restype = i
        lib.flash_attention_plan.argtypes = [i, i, ctypes.POINTER(i)]
        lib.flash_attention_plan.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def plan(hd: int, dtype: torch.dtype) -> dict:
    """The kernel's tiling for head_dim `hd` and `dtype` (from the built
    library): the padded head dim, query rows per CTA, keys per tile, ring
    stages, threads per CTA and dynamic shared memory in bytes."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    out = (ctypes.c_int * 6)()
    lib = _library()
    err = lib.flash_attention_plan(int(hd), DTYPE_CODES[dtype], out)
    if err != 0:
        raise ValueError("flash_attention: no tiling for head_dim "
                         f"{hd}: " + lib.flash_attention_error_string(err).decode())
    keys = ("head_dim_padded", "rows_per_cta", "keys_per_tile", "stages",
            "threads", "smem_bytes")
    return dict(zip(keys, out))


def _check(q, k, v, window: int, softcap: float) -> None:
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash_attention: q, k, v must be [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    KV, Skv = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {KV} kv heads do not divide {H} "
                         "q heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    if Skv < 1:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{list(DTYPE_CODES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    _check_layout(q, k, v)
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be >= 0")


def _check_layout(*ts) -> None:
    """What the kernels need of the tensors' layout: unit stride over hd,
    sizes within int32 (checked again on what a `vmap` rule unwraps)."""
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention: head_dim must have unit stride")
    B, H, Sq = ts[0].shape[:3]
    if max(B * H, Sq, ts[1].shape[2]) > _INT32:
        raise ValueError("flash_attention: sizes beyond int32")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int = 0, softcap: float = 0.0,
) -> torch.Tensor:
    """softmax(mask(cap(q k^T / sqrt(hd)))) v over q [B, H, Sq, hd] and
    k/v [B, KV, Skv, hd] (f32 or bf16, one dtype; unit stride over hd, any
    other strides), in f32, returned in q's dtype with q's layout.
    Masks use tile-index positions (query i at i, key j at j): causal
    i >= j, window i - j < window (window > 0); softcap > 0 caps the
    logits as softcap * tanh(s / softcap).  Differentiable in f32 (bf16
    raises TypeError where a gradient may be asked for), under
    `torch.func.vmap` too.

    A query that no key may see (with a window, when
    i >= Skv + window - 1) gets an answer that depends on the tiling, as
    the TPU kernel's does, and not the plain version's uniform average:
    the mean of v over the keys j < Skv of the key tiles its warp of 16
    queries processes, or zero when there are none.  A CTA of 64 queries
    from q0 processes the tiles of `plan(hd, dtype)["keys_per_tile"]`
    keys from the one holding key max(0, q0 - window + 1) through the one
    holding Skv - 1 (under causal: its last query), and a warp skips
    those wholly after its last query (causal) or before its first
    query's first key (window).  No model path asks for such a row, and
    such rows are outside the gradient's contract: the backward gives
    them dq = 0 and no share of dk / dv."""
    window, softcap = int(window), float(softcap)
    _check(q, k, v, window, softcap)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if traced(q, k, v):
        if q.dtype != torch.float32:
            raise TypeError("flash_attention: the gradient is f32 only (the JAX "
                            f"package trains in f32), got {q.dtype}")
        return _FlashAttention.apply(q, k, v, bool(causal), window, softcap)[0]
    return _forward(q, k, v, causal, window, softcap, with_lse=False)[0]


def _forward(q, k, v, causal, window, softcap, with_lse: bool):
    """(out, lse or None): the plain version on the CPU, the kernel on a
    card."""
    if is_dtensor(q, k, v):
        def local(q, k, v):
            out, lse = _forward(q, k, v, causal, window, softcap, with_lse)
            return (out, lse) if with_lse else out

        shapes = (q.shape, q.shape[:3]) if with_lse else (q.shape,)
        outs = local_call(local, (q, k, v), (_SHARDED,) * 3, keep=(0, 1),
                          out_maps=(_SHARDED,) * len(shapes), out_shapes=shapes,
                          gqa=(1, 1))
        return tuple(outs) if with_lse else (outs, None)
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = ref.flash_attention_ref(q, k, v, **kw)
        return out, (ref.flash_attention_lse_ref(q, k, v, **kw) if with_lse else None)
    _check_layout(q, k, v)
    out = torch.empty_like(q)  # q's strides when q is dense
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, H, Sq, hd = q.shape
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * H * Sq == 0:
        return out, lse
    KV, Skv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KV, Sq, Skv, hd, strides, int(bool(causal)), window,
            softcap, 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(out, lse) of the forward, differentiable in q, k, v; lse (the
    rows' log-sum-exp, saved for the backward) is not."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap):
        return _forward(q, k, v, causal, window, softcap, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap):
        n = info.batch_size
        qf, kf, vf = (fold(t, d, n) for t, d in zip((q, k, v), in_dims[:3]))
        out, lse = _FlashAttention.apply(qf, kf, vf, causal, window, softcap)
        return (unfold(out, n), unfold(lse, n)), (0, 0)


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), i, i, ctypes.c_float,
            ctypes.c_float, p]
        fn.restype = i
        lib.flash_attention_bwd_plan.argtypes = [i, ctypes.POINTER(i)]
        lib.flash_attention_bwd_plan.restype = i
        lib.flash_attention_bwd_scratch.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.flash_attention_bwd_scratch.restype = i
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_plan(hd: int) -> dict:
    """The backward's tiling for head_dim `hd` (from the built library):
    the padded head dim, keys per CTA, query rows per tile, stages,
    threads per CTA and dynamic shared memory in bytes."""
    out = (ctypes.c_int * 6)()
    lib = _bwd_library()
    err = lib.flash_attention_bwd_plan(int(hd), out)
    if err != 0:
        raise ValueError("flash_attention_bwd: no tiling for head_dim "
                         f"{hd}: " + lib.flash_attention_bwd_error_string(err).decode())
    keys = ("head_dim_padded", "keys_per_cta", "rows_per_tile", "stages", "threads",
            "smem_bytes")
    return dict(zip(keys, out))


def bwd_scratch(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int) -> dict:
    """The backward's scratch for these shapes (from the built library):
    floats of dq's per-key-tile partials (0 where one key tile writes dq
    in place), floats of dk / dv's per-chunk partials (0 where each key
    tile's query tiles run in one CTA), and the CTAs that share a key
    tile's query tiles (split-Q, where B * KV key tiles would not fill the
    card)."""
    out = (ctypes.c_longlong * 3)()
    lib = _bwd_library()
    err = lib.flash_attention_bwd_scratch(B, H, KV, Sq, Skv, hd, out)
    if err != 0:
        raise ValueError("flash_attention_bwd: " + lib.flash_attention_bwd_error_string(err).decode())
    return dict(zip(("dq_partial_floats", "dkv_partial_floats", "ctas_a_key_tile"), out))


def plain_flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, *,
    causal: bool = True, window: int = 0, softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the plain version (`ref.flash_attention_ref`) for
    the cotangent dout, by `torch.func.vjp`, on any device."""
    def fwd(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)

    return torch.func.vjp(fwd, q, k, v)[1](dout)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
    window: int = 0, softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` at q, k, v (f32, its layouts)
    for the cotangent dout [B, H, Sq, hd], given the forward's out and
    lse [B, H, Sq].  On a CPU tensor the plain version's gradient
    (`plain_flash_attention_bwd`, which needs neither out nor lse); on a
    CUDA tensor the kernel, which sums in a fixed order (two calls give
    the same bits), or raises.  dq / dk / dv come back contiguous."""
    window, softcap = int(window), float(softcap)
    _check(q, k, v, window, softcap)
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: f32 only, got {q.dtype}")
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)} and out "
                         f"{tuple(out.shape)} must be q's {tuple(q.shape)}")
    if is_dtensor(q, k, v, out, lse, dout):
        return local_call(
            lambda *ts: flash_attention_bwd(*ts, causal=causal, window=window,
                                            softcap=softcap),
            (q, k, v, out, lse, dout), (_SHARDED,) * 6, keep=(0, 1),
            out_maps=(_SHARDED,) * 3, out_shapes=(q.shape, k.shape, v.shape),
            gqa=(1, 1))
    if q.device.type == "cpu":
        return plain_flash_attention_bwd(q, k, v, dout, causal=causal,
                                         window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} "
                         f"must be f32 {(B, H, Sq)}")
    dout = dout if dout.stride(-1) == 1 else dout.contiguous()
    out = out if out.stride(-1) == 1 else out.contiguous()
    lse = lse.contiguous()
    _check_layout(q, k, v, out, dout)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=q.device)
                  for t in (q, k, v))
    if B * H * Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    # scratch: each key tile's share of dq, and each chunk's of dk / dv;
    # the library sums them in order (none where it writes in place)
    scratch = bwd_scratch(B, H, KV, Sq, Skv, hd)
    dq_part, dkv_part = (torch.empty(n, dtype=torch.float32, device=q.device) if n else None
                         for n in (scratch["dq_partial_floats"], scratch["dkv_partial_floats"]))
    lib = _bwd_library()
    ts = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(s for t in ts for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv, delta)),
            *(None if t is None else t.data_ptr() for t in (dq_part, dkv_part)),
            B, H, KV, Sq, Skv, hd, strides, int(bool(causal)), window, softcap,
            1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           + lib.flash_attention_bwd_error_string(err).decode())
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
