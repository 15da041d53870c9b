"""Mamba-1 (selective scan) and Mamba-2 (SSD, scalar-per-head decay)
blocks (port of `repro/models/mamba.py`).

Unified state layout [B, n_heads, head_p, d_state]:
  * mamba1: n_heads = d_inner, head_p = 1, A in R^{d_inner x N} (per-channel).
  * mamba2: n_heads = d_inner/head_p, A scalar per head.

A multi-token step scans through `kernels.ops.batched_ssm_scan` (the
`ssm_scan` kernel on the card) in place of JAX's chunked associative
scan: the kernel carries the state in registers over the whole sequence,
so no chunking is needed, computes y_t = <h_t, c_t> itself (JAX's y
einsum) and returns the final state that fills the cache.  Mamba-2's
per-head decay is handed over unexpanded.  The one-token decode step stays
plain, as in JAX.  Training differentiates the same call: the wrapper is
an autograd Function whose backward is the scan's backward kernel on the
card, d da reduced to the per-head shape inside it.

The depthwise causal convolution is written as W shifted multiply-adds:
no cuDNN, so no TF32 on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import batched_ssm_scan
from .layers import gen_device, normal, param
from .placement import pinned


def init_mamba(
    gen: torch.Generator,
    d: int,
    d_inner: int,
    d_state: int,
    conv_width: int,
    variant: str,
    dtype,
    head_p: int = 64,
    dt_rank: Optional[int] = None,
) -> nn.ParameterDict:
    dev = gen_device(gen)
    s_in = 1.0 / math.sqrt(d)
    s_inner = 1.0 / math.sqrt(d_inner)
    dt_rank = dt_rank or max(1, d // 16)
    nh = d_inner if variant == "mamba1" else d_inner // head_p
    zeros = lambda *shape, dt=dtype: torch.zeros(*shape, dtype=dt, device=dev)
    p = {
        "in_proj": normal(gen, (d, 2 * d_inner), s_in, dtype, dev),
        "conv_w": normal(gen, (conv_width, d_inner), 0.5, dtype, dev),
        "conv_b": zeros(d_inner),
        "out_proj": normal(gen, (d_inner, d), s_inner, dtype, dev),
        "D": torch.ones(d_inner, dtype=dtype, device=dev),
        "norm": zeros(d_inner),
    }
    if variant == "mamba1":
        p["x_proj"] = normal(gen, (d_inner, dt_rank + 2 * d_state), s_inner, dtype, dev)
        p["dt_proj"] = normal(gen, (dt_rank, d_inner), 1.0 / math.sqrt(dt_rank), dtype, dev)
        p["dt_bias"] = zeros(d_inner)
        a = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
        p["A_log"] = torch.log(a).expand(d_inner, d_state).contiguous()
    elif variant == "mamba2":
        p["bcdt_proj"] = normal(gen, (d, 2 * d_state + nh), s_in, dtype, dev)
        p["dt_bias"] = zeros(nh)
        p["A_log"] = zeros(nh, dt=torch.float32)
    else:
        raise ValueError(variant)
    return nn.ParameterDict({k: param(t) for k, t in p.items()})


def _conv_valid(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise valid conv over the sequence axis: xp [B, S+W-1, di],
    w [W, di] -> [B, S, di]."""
    W = w.shape[0]
    S = xp.shape[1] - W + 1
    out = xp[:, 0:S] * w[0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * w[k]
    return out + b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; x [B,S,di], w [W,di].  The W-1 zero rows
    ahead of x are concatenated, not padded: the same values, through
    ops DTensor propagates under `vmap` (its `F.pad` there does not, in
    some torch releases)."""
    zero = torch.zeros_like(x[:, :1])
    return _conv_valid(torch.cat([zero] * (w.shape[0] - 1) + [x], dim=1), w, b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as jax.nn.softplus computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block(
    params,
    u: torch.Tensor,  # [B, S, d]
    *,
    variant: str,
    d_state: int,
    head_p: int = 64,
    cache: Optional[Dict] = None,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (output [B,S,d], updated cache or None).

    cache (decode): {"conv": [B, W-1, di], "ssm": [B, nh, p, N]}.
    use_kernel=False scans with the kernel's plain version instead."""
    B, S, d = u.shape
    d_inner = params["in_proj"].shape[1] // 2
    nh = d_inner if variant == "mamba1" else d_inner // head_p
    p_dim = 1 if variant == "mamba1" else head_p

    xz = pinned(u @ params["in_proj"])
    x, z = xz[..., :d_inner], xz[..., d_inner:]

    W = params["conv_w"].shape[0]
    if cache is not None:
        xw = torch.cat([cache["conv"], x], dim=1)  # [B, W-1+S, di]
        new_conv = xw[:, -(W - 1):].clone()  # not a view pinning all of xw
        # S == 1 is JAX's einsum over the last W inputs: the same sum
        x = _conv_valid(xw, params["conv_w"], params["conv_b"])
    else:
        new_conv = None
        x = _causal_conv(x, params["conv_w"], params["conv_b"])
    x = F.silu(x)

    if variant == "mamba1":
        dbl = x @ params["x_proj"]
        dt_rank = params["dt_proj"].shape[0]
        dt_raw, Bc, Cc = torch.split(dbl, [dt_rank, d_state, d_state], dim=-1)
        dt = _softplus(dt_raw @ params["dt_proj"] + params["dt_bias"])
        A = -torch.exp(params["A_log"])  # [di, N]
        da = torch.exp(dt.float()[..., None] * A)  # [B,S,di,N]
        da = da.reshape(B, S, nh, 1, d_state)
        dbx = dt[..., None] * x[..., None] * Bc[:, :, None, :]  # [B,S,di,N]
        dbx = dbx.reshape(B, S, nh, 1, d_state)
    elif variant == "mamba2":
        bcd = u @ params["bcdt_proj"]
        Bc, Cc, dt_raw = torch.split(bcd, [d_state, d_state, nh], dim=-1)
        dt = _softplus(dt_raw + params["dt_bias"])  # [B,S,nh]
        A = -torch.exp(params["A_log"])  # [nh]
        da = torch.exp(dt.float() * A)[..., None, None]  # [B,S,nh,1,1]
        xh = x.reshape(B, S, nh, head_p)
        dbx = (dt[..., None] * xh)[..., None] * Bc[:, :, None, None, :]
    else:
        raise ValueError(variant)

    state0 = cache["ssm"] if cache is not None else None
    if S == 1:
        if state0 is None:
            state0 = torch.zeros(B, nh, p_dim, d_state, dtype=torch.float32,
                                 device=u.device)
        state = da[:, 0] * state0 + dbx[:, 0]
        y = torch.einsum("bnpN,bN->bnp", state, Cc[:, 0].float())[:, None]
    else:
        y, state = batched_ssm_scan(da, dbx.float(), Cc.float(), state0,
                                    use_kernel=use_kernel)
    del da, dbx
    y = y.reshape(B, S, d_inner)
    y = y.to(u.dtype) + params["D"] * x.reshape(B, S, d_inner)
    # gated RMSNorm (Mamba-2 style; harmless for mamba1)
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * (1.0 + params["norm"].float())
    out = yf.to(u.dtype) @ params["out_proj"]

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": state}
    return out, new_cache


def init_mamba_cache(
    batch: int, d_inner: int, d_state: int, conv_width: int, variant: str, dtype,
    device, head_p: int = 64,
) -> Dict:
    nh = d_inner if variant == "mamba1" else d_inner // head_p
    p_dim = 1 if variant == "mamba1" else head_p
    return {
        "conv": torch.zeros(batch, conv_width - 1, d_inner, dtype=dtype, device=device),
        "ssm": torch.zeros(batch, nh, p_dim, d_state, dtype=torch.float32, device=device),
    }
