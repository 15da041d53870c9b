"""Mixture-of-Experts FFN: a top-k router and capacity-based dispatch
(port of `repro/models/moe.py`).

JAX has two dispatches, selected per config (`moe_dispatch`): one-hot
einsums over a [B, S, E, C] slot matrix, and a scatter / gather by
expert id.  They compute the same function, and so does the one body
here, which runs for both: tokens are scattered by (expert, row, slot)
into an [E, B, C + 1, d] buffer, whose spare slot C takes every token
past capacity and is cut off before the experts run (JAX's
`mode="drop"`), then gathered back and masked with `where`, as JAX's
scatter does.  Each slot of the one-hot einsums sums exactly one
non-zero term, so the gather equals them bit for bit.

It works under `torch.func.vmap` (the round engine maps the loss over
agents): no boolean-mask indexing, no `.item()`, and every shape comes
from static sizes.  The capacity C = max(1, int(S * top_k *
capacity_factor) // E) is JAX's.  The expert SwiGLU is three batched
products outside any kernel, as JAX's are outside any Pallas kernel.

`jax.lax.top_k` breaks ties towards the lower expert index; `torch.topk`
leaves the order among ties unspecified, so the router takes its top k
from a stable descending sort.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import gen_device, normal, param


def init_moe(gen: torch.Generator, d: int, ff: int, num_experts: int,
             dtype) -> nn.ParameterDict:
    """JAX's distributions and scales; the router stays in f32."""
    dev = gen_device(gen)
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    E = num_experts
    return nn.ParameterDict({
        "router": param(normal(gen, (d, E), s_in, torch.float32, dev)),
        "gate": param(normal(gen, (E, d, ff), s_in, dtype, dev)),
        "up": param(normal(gen, (E, d, ff), s_in, dtype, dev)),
        "down": param(normal(gen, (E, ff, d), s_ff, dtype, dev)),
    })


def _expert_ffn(params, x: torch.Tensor) -> torch.Tensor:
    """x: [E, G, C, d] -> [E, G, C, d] (per-expert SwiGLU)."""
    gate = F.silu(torch.einsum("egcd,edf->egcf", x, params["gate"]))
    up = torch.einsum("egcd,edf->egcf", x, params["up"])
    return torch.einsum("egcf,efd->egcd", gate * up, params["down"])


def router_probs(params, h: torch.Tensor) -> torch.Tensor:
    """softmax(h W_router) in f32: [B, S, E]."""
    logits = (h.float() @ params["router"]).float()
    return torch.softmax(logits, dim=-1)


def router_decisions(params, h: torch.Tensor, top_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (expert_index [B, S, K], gate_weight [B, S, K], aux_loss
    scalar)."""
    probs = router_probs(params, h)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp_min(torch.sum(gate, dim=-1, keepdim=True), 1e-9)
    # Switch-style load-balance auxiliary: E * <fraction routed> . <mean prob>
    E = probs.shape[-1]
    frac = torch.mean(_one_hot(idx[..., 0], E).float(), dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return idx, gate.to(h.dtype), aux


def capacity(S: int, top_k: int, capacity_factor: float, E: int) -> int:
    """Slots per (expert, batch row): JAX's, from static sizes."""
    return max(1, int(S * top_k * capacity_factor) // E)


def moe_ffn(params, h: torch.Tensor, *, top_k: int = 1,
            capacity_factor: float = 1.25, dispatch: str = "einsum"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], load-balance aux loss)."""
    B, S, d = h.shape
    E = params["gate"].shape[0]
    if dispatch not in ("einsum", "scatter"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    idx, gate, aux = router_decisions(params, h, top_k)
    C = capacity(S, top_k, capacity_factor, E)
    return _dispatch(params, h, idx, gate, top_k, C, E), aux


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] int64, 1 where the last axis equals i (`F.one_hot` checks
    its input's range on the host, which `vmap` refuses)."""
    return (i[..., None] == torch.arange(n, device=i.device)).long()


def _slot_positions(e_id: torch.Tensor, E: int) -> torch.Tensor:
    """Each token's slot within its expert (0-based, in sequence order
    along S), [B, S]."""
    onehot = _one_hot(e_id, E)  # [B, S, E]
    pos = torch.cumsum(onehot, dim=1) * onehot
    return torch.take_along_dim(pos, e_id[..., None], dim=-1)[..., 0] - 1


def _dispatch(params, h, idx, gate, top_k, C, E):
    B, S, d = h.shape
    out = torch.zeros_like(h)
    b_ix = torch.arange(B, device=h.device)[:, None].expand(B, S)
    for k in range(top_k):
        e_id = idx[..., k]  # [B, S]
        pos = _slot_positions(e_id, E)
        valid = pos < C
        # past capacity: the spare slot C, cut off before the experts run
        buf = torch.zeros(E, B, C + 1, d, dtype=h.dtype, device=h.device)
        buf = buf.index_put((e_id, b_ix, torch.clamp_max(pos, C)), h)
        xout = _expert_ffn(params, buf[:, :, :C])
        gathered = xout[e_id, b_ix, torch.clamp_max(pos, C - 1)]  # [B, S, d]
        out = out + torch.where(valid[..., None], gathered * gate[..., k][..., None],
                                torch.zeros_like(gathered))
    return out
