"""GQA attention with RoPE, sliding windows, the Gemma-2 logit softcap and
a ring-buffer KV cache (port of `repro/models/attention.py`).

Every call with more than one query (prefill, or a forward without a
cache) attends through `kernels.ops.grouped_flash_attention`: the flash
kernel on the card, which bounds its own memory, so JAX's q-blocking
(a memory bound for its jnp path) is gone.  The kernel places query i at
position i and key j at position j, and knows no cache, so it attends
over the new K/V alone.  That is JAX's function wherever prefill fills an
empty cache from one contiguous run of positions: JAX attends over the
whole cache with the empty slots masked, and a masked score weighs
exactly zero.  A one-token decode step against the cache stays plain
(`_attend`), as JAX computes it outside any Pallas kernel.  Training
differentiates the same call: the wrapper is an autograd Function whose
backward is the flash backward kernel on the card.

Caches are updated in place: the K/V/pos buffers a cache holds are
written, and the returned cache holds the same buffers (JAX returns
updated copies).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.ops import grouped_flash_attention
from ..kernels.ref import NEG_INF
from .layers import gen_device, normal, param
from .placement import reduced, rows_proj


def init_attention(gen: torch.Generator, d: int, heads: int, kv_heads: int,
                   head_dim: int, dtype) -> nn.ParameterDict:
    dev = gen_device(gen)
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(heads * head_dim)
    return nn.ParameterDict({
        "wq": param(normal(gen, (d, heads, head_dim), s, dtype, dev)),
        "wk": param(normal(gen, (d, kv_heads, head_dim), s, dtype, dev)),
        "wv": param(normal(gen, (d, kv_heads, head_dim), s, dtype, dev)),
        "wo": param(normal(gen, (heads, head_dim, d), so, dtype, dev)),
    })


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] (shared across batch)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]  # [S, half]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    dt = x.dtype
    return torch.cat([(x1 * cos - x2 * sin).to(dt), (x2 * cos + x1 * sin).to(dt)], dim=-1)


def _attend(
    q: torch.Tensor,  # [B, Sq, H, hd] (already rope'd)
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [Sq]
    kv_positions: torch.Tensor,  # [Skv]
    kv_valid: Optional[torch.Tensor],  # [Skv] bool or None
    causal: bool,
    window: int,
    softcap: float,
) -> torch.Tensor:
    """Plain attention over explicit positions (the decode step)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    # a sum over a sharded head dim is reduced here, once (GSPMD's
    # all-reduce), not scattered and gathered again for the softmax
    scores = reduced(torch.einsum("bskgh,btkh->bkgst", qg, k).float())
    scores = scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    # out of place: an operand may be a DTensor (a placed cache's positions)
    mask = torch.ones(Sq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_positions[:, None] >= kv_positions[None, :])
    if window > 0:
        mask = mask & (q_positions[:, None] - kv_positions[None, :] < window)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(B, Sq, H, hd)


def multihead_attention(
    params,
    h: torch.Tensor,  # [B, Sq, d]
    *,
    q_positions: torch.Tensor,  # [Sq], consecutive when Sq > 1
    rope_theta: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    cache: Optional[Dict] = None,
    cache_index: int = 0,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (output [B, Sq, d], the cache after this step or None).

    cache: {"k": [B, C, KV, hd], "v": same, "pos": [C] int32 positions
    stored in each slot (-1 = empty), "used": a host bool, True once a
    step has written it}, written in place.  cache_index:
    slot offset at which to write the new K/V (ring for windows).
    use_kernel=False runs the flash kernel's plain version instead."""
    B, Sq, d = h.shape
    q = torch.einsum("bsd,dnh->bsnh", h, params["wq"])
    k_new = torch.einsum("bsd,dnh->bsnh", h, params["wk"])
    v_new = torch.einsum("bsd,dnh->bsnh", h, params["wv"])
    q = apply_rope(q, q_positions, rope_theta)
    k_new = apply_rope(k_new, q_positions, rope_theta)

    k, v, kv_positions, kv_valid = k_new, v_new, q_positions, None
    new_cache = None
    if cache is not None and Sq >= cache["k"].shape[1]:
        # prefill longer than a ring (sliding-window) cache: attend over the
        # full new K/V; store only the last C entries, rotated so slot i
        # holds the position p with p % C == i (decode continues the ring)
        C = cache["k"].shape[1]
        tail_pos = q_positions[-C:].to(torch.int32)
        order = torch.argsort(tail_pos % C)
        cache["k"].copy_(k_new[:, -C:][:, order])
        cache["v"].copy_(v_new[:, -C:][:, order])
        cache["pos"].copy_(tail_pos[order])
        cache["used"] = True
        new_cache = cache
    elif cache is not None:
        if Sq > 1 and cache["used"]:
            raise ValueError(
                "multihead_attention: a multi-token step into a cache that "
                "holds other entries; the flash kernel attends over the new "
                "K/V only, so prefill must fill an empty cache"
            )
        C = cache["k"].shape[1]
        # JAX's dynamic_update_slice clamps the start so the update fits
        slot = min(int(cache_index) % C, C - Sq)
        cache["k"][:, slot:slot + Sq] = k_new
        cache["v"][:, slot:slot + Sq] = v_new
        cache["pos"][slot:slot + Sq] = q_positions.to(torch.int32)
        cache["used"] = True
        new_cache = cache
        if Sq == 1:
            k, v = cache["k"], cache["v"]
            kv_positions, kv_valid = cache["pos"], cache["pos"] >= 0

    if Sq > 1:
        out = grouped_flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap, use_kernel=use_kernel)
    else:
        out = _attend(q, k, v, q_positions, kv_positions, kv_valid, causal,
                      window, softcap)
    out = rows_proj("bsnh,nhd->bsd", out, params["wo"])
    return out, new_cache


def init_cache(batch: int, capacity: int, kv_heads: int, head_dim: int, dtype,
               device) -> Dict:
    return {
        "k": torch.zeros(batch, capacity, kv_heads, head_dim, dtype=dtype, device=device),
        "v": torch.zeros(batch, capacity, kv_heads, head_dim, dtype=dtype, device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
        "used": False,
    }
