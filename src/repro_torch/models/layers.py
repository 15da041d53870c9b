"""Shared building blocks (port of `repro/models/layers.py`): plain
functions on tensors and parameter dicts, with JAX's names and math.

Parameters live in `nn.ParameterDict`s (see `transformer.init_params`),
or in plain dicts of tensors (`ModelParams.tree()`, what training
differentiates); the functions read both like JAX's dicts."""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn
from torch._C._functorch import is_functorch_wrapped_tensor

from .placement import lookup, rows_scattered, sharded, split_dims


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter of the model's modules, with no gradient of its own:
    training differentiates the engine's copies of the tensors
    (`ModelParams.tree()`), not the modules."""
    return nn.Parameter(t, requires_grad=False)


def gen_device(gen) -> torch.device:
    """Where a model's parameters are built: `gen`'s device, or `meta`
    without a generator (the abstract shapes of `launch.steps`)."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 from `gen` on `device`, cast to `dtype`
    (JAX's inits draw f32 normals, scale, then cast).  Without a generator
    an empty tensor of the shape on `meta`: no draw."""
    if gen is None:
        return torch.empty(*shape, dtype=dtype, device="meta")
    t = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
    return (t * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": param(torch.zeros(d, dtype=dtype, device=device))})


def swiglu(x: torch.Tensor, w) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W_gate) * (x W_up)) W_down."""
    gate = F.silu(x @ w["gate"])
    up = x @ w["up"]
    return (gate * up) @ w["down"]


def init_swiglu(gen: torch.Generator, d: int, ff: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "gate": param(normal(gen, (d, ff), 1.0 / math.sqrt(d), dtype, device)),
        "up": param(normal(gen, (d, ff), 1.0 / math.sqrt(d), dtype, device)),
        "down": param(normal(gen, (ff, d), 1.0 / math.sqrt(ff), dtype, device)),
    })


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """table[tokens] (scaled by sqrt(d)).  A vocab-sharded DTensor table is
    read through `F.embedding`, whose sharding rule looks the tokens up on
    each vocab shard and sums the masked rows (a reduction of the
    embeddings), where indexing would gather the whole table; under
    `torch.func` (a table per agent, the train step's) each rank looks its
    agents' tokens up in their tables (`placement.lookup`)."""
    split = split_dims(table)
    if split and 0 in split and not is_functorch_wrapped_tensor(table):
        # its masked partial sum is reduced at once, and once: a reduction
        # applies the shards' masks and drops them
        h = rows_scattered(F.embedding(tokens, table))
    elif is_functorch_wrapped_tensor(table) and sharded(table):
        h = lookup(table, tokens)
    else:
        h = table[tokens]
    if scale:
        h = h * torch.tensor(math.sqrt(table.shape[-1]), dtype=h.dtype)
    return h


def unembed(h: torch.Tensor, table: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = torch.einsum("...d,vd->...v", h, table).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE; logits [..., V] float32, labels [...] int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(logz - gold)
