"""Model assembly: pattern-cycled blocks, KV/SSM caches (port of
`repro/models/transformer.py`).

JAX stacks each pattern slot's parameters [num_periods, ...] and scans
one period body; here the layers are a Python loop over an
`nn.ModuleList`, layer `gi` of kind `cfg.layer_types[gi]` (JAX's period
gi // len(pattern), slot gi % len(pattern)).  The zamba2 shared attention
block (JAX's `lax.cond` inside the scan) is a plain `if` after every
`shared_attn_every`-th layer, with JAX's shared-cache index.

Ported: the text frontend and the dense, local, Mamba-1 and Mamba-2
layer kinds, forward only.  The `moe` kind and the audio and vision_text
frontends raise `not_ported` (ROADMAP Queue 1 item 12).  `forward` has no
`remat` or `h_sharding` argument and the port has no `chunked_lm_loss`:
the LM training path (Queue 1 item 12) and the SPMD layer (item 13) bring
them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import not_ported
from .attention import init_attention, init_cache, multihead_attention
from .layers import (
    embed_tokens,
    init_rms_norm,
    init_swiglu,
    normal,
    param,
    rms_norm,
    swiglu,
    unembed,
)
from .mamba import init_mamba, init_mamba_cache, mamba_block

SSM_KINDS = ("mamba1", "mamba2")


def _check_ported(cfg: ModelConfig) -> None:
    if "moe" in cfg.pattern:
        raise not_ported(f"the moe layer kind ({cfg.name})", "Queue 1 item 12")
    if cfg.frontend != "text":
        raise not_ported(f"the {cfg.frontend} frontend ({cfg.name})", "Queue 1 item 12")


def as_module(tree):
    """A nested dict of tensors as modules: dicts of tensors become
    `nn.ParameterDict`s, dicts of dicts `nn.ModuleDict`s; both read like
    JAX's parameter dicts (`p["attn"]["wq"]`)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: param(v) for k, v in tree.items()})
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


class ModelParams(nn.Module):
    """The parameters of one model: `layers` (one module per layer, in
    order), `final_norm`, `embed` (the token table, also the
    unembedding) and, for zamba2, `shared_attn`.  Built by `init_params`
    (random, from a generator) or, through `from_tree`, by
    `convert.model_params_from_numpy` (the JAX package's weights); the
    model functions below read it."""

    def __init__(self, cfg: ModelConfig, layers: List[nn.Module],
                 final_norm: nn.Module, embed: torch.Tensor,
                 shared_attn: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.embed = param(embed)
        self.shared_attn = shared_attn

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: Dict) -> "ModelParams":
        """From nested dicts of tensors: {"layers": [one dict per layer],
        "final_norm", "embed", "shared_attn" (zamba2)}."""
        _check_ported(cfg)
        shared = tree.get("shared_attn")
        return cls(cfg, [as_module(t) for t in tree["layers"]],
                   as_module(tree["final_norm"]), tree["embed"],
                   None if shared is None else as_module(shared))


# --------------------------------------------------------------------------
# parameter construction
# --------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype) -> nn.Module:
    dev = gen.device
    if kind in ("attn", "local"):
        return nn.ModuleDict({
            "ln1": init_rms_norm(cfg.d_model, dtype, dev),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, dtype),
            "ln2": init_rms_norm(cfg.d_model, dtype, dev),
            "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev),
        })
    if kind in SSM_KINDS:
        return nn.ModuleDict({
            "ln1": init_rms_norm(cfg.d_model, dtype, dev),
            "mamba": init_mamba(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                cfg.conv_width, kind, dtype, head_p=cfg.head_p),
        })
    raise ValueError(kind)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> ModelParams:
    """Random parameters with JAX's distributions (not its numbers), drawn
    from `gen` on `gen.device`."""
    _check_ported(cfg)
    assert cfg.num_layers % len(cfg.pattern) == 0, (cfg.name, cfg.num_layers)
    dev = gen.device
    layers = [_init_layer(gen, kind, cfg, dtype) for kind in cfg.layer_types]
    final_norm = init_rms_norm(cfg.d_model, dtype, dev)
    embed = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype, dev)
    shared = None
    if cfg.shared_attn_every:
        shared = nn.ModuleDict({
            "ln": init_rms_norm(cfg.d_model, dtype, dev),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, dtype),
        })
    return ModelParams(cfg, layers, final_norm, embed, shared)


def num_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def _layer_cache_capacity(kind: str, cfg: ModelConfig, capacity: int) -> int:
    if kind == "local":
        return min(capacity, cfg.sliding_window)
    return capacity


def init_caches(cfg: ModelConfig, batch: int, capacity: int, dtype,
                device) -> Dict:
    """{"layers": one cache per layer, "shared": one per application of
    the shared block} (JAX stacks them per pattern slot)."""
    _check_ported(cfg)
    layers: List[Dict] = []
    for kind in cfg.layer_types:
        cap = _layer_cache_capacity(kind, cfg, capacity)
        if kind in ("attn", "local"):
            layers.append(init_cache(batch, cap, cfg.num_kv_heads, cfg.head_dim,
                                     dtype, device))
        else:
            layers.append(init_mamba_cache(
                batch, cfg.d_inner, cfg.ssm_state, cfg.conv_width, kind, dtype,
                device, head_p=cfg.head_p))
    out = {"layers": layers}
    if cfg.shared_attn_every:
        n_shared = cfg.num_layers // cfg.shared_attn_every
        out["shared"] = [
            init_cache(batch, capacity, cfg.num_kv_heads, cfg.head_dim, dtype, device)
            for _ in range(n_shared)
        ]
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _apply_layer(
    kind: str,
    p,
    cfg: ModelConfig,
    h: torch.Tensor,
    cache: Optional[Dict],
    q_positions: torch.Tensor,
    cache_index: int,
    use_kernel: bool,
):
    aux = 0.0
    if kind in ("attn", "local"):
        hn = rms_norm(h, p["ln1"]["scale"])
        out, new_c = multihead_attention(
            p["attn"],
            hn,
            q_positions=q_positions,
            rope_theta=cfg.rope_theta,
            causal=cfg.causal,
            window=cfg.sliding_window if kind == "local" else 0,
            softcap=cfg.logit_softcap,
            cache=cache,
            cache_index=cache_index,
            use_kernel=use_kernel,
        )
        h = h + out
        hn2 = rms_norm(h, p["ln2"]["scale"])
        return h + swiglu(hn2, p["mlp"]), new_c, aux
    if kind in SSM_KINDS:
        hn = rms_norm(h, p["ln1"]["scale"])
        out, new_c = mamba_block(
            p["mamba"],
            hn,
            variant=kind,
            d_state=cfg.ssm_state,
            head_p=cfg.head_p,
            cache=cache,
            use_kernel=use_kernel,
        )
        return h + out, new_c, aux
    if kind == "moe":
        raise not_ported("the moe layer kind", "Queue 1 item 12")
    raise ValueError(kind)


def embed_inputs(params: ModelParams, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """batch: {"tokens": [B, St]} (the text frontend)."""
    _check_ported(cfg)
    return embed_tokens(batch["tokens"], params.embed)


def forward(
    params: ModelParams,
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, S, d] embedded inputs (see embed_inputs)
    *,
    caches: Optional[Dict] = None,
    position: Optional[int] = None,  # decode: current absolute position
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict], float]:
    """Returns (final hidden [B,S,d], updated caches, aux loss).

    Prefill (position None) runs positions 0..S-1 into empty caches; a
    decode step (position p) runs one token at p.  use_kernel=False runs
    the flash-attention and scan kernels' plain versions instead."""
    _check_ported(cfg)
    B, S, _ = h.shape
    per = len(cfg.pattern)
    assert cfg.num_layers % per == 0, (cfg.name, cfg.num_layers, per)
    if position is not None:
        q_positions = torch.tensor([int(position)], dtype=torch.int32, device=h.device)
        cache_index = int(position)
    else:
        q_positions = torch.arange(S, dtype=torch.int32, device=h.device)
        cache_index = 0

    shared_p = params.shared_attn
    shared = list(caches["shared"]) if caches and cfg.shared_attn_every else None
    new_layers = []
    aux = 0.0
    for gi, kind in enumerate(cfg.layer_types):
        c = caches["layers"][gi] if caches else None
        h, new_c, a = _apply_layer(kind, params.layers[gi], cfg, h, c,
                                   q_positions, cache_index, use_kernel)
        aux = aux + a
        new_layers.append(new_c)
        if cfg.shared_attn_every and (gi + 1) % cfg.shared_attn_every == 0:
            s_idx = (gi + 1) // cfg.shared_attn_every - 1
            hn = rms_norm(h, shared_p["ln"]["scale"])
            out, new_cs = multihead_attention(
                shared_p["attn"],
                hn,
                q_positions=q_positions,
                rope_theta=cfg.rope_theta,
                causal=cfg.causal,
                softcap=cfg.logit_softcap,
                cache=shared[s_idx] if shared is not None else None,
                cache_index=cache_index,
                use_kernel=use_kernel,
            )
            if shared is not None:
                shared[s_idx] = new_cs
            h = h + out
    h = rms_norm(h, params.final_norm["scale"])
    new_caches = None
    if caches is not None:
        new_caches = {"layers": new_layers}
        if cfg.shared_attn_every:
            new_caches["shared"] = shared
    return h, new_caches, aux


def logits_from_hidden(params: ModelParams, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    _check_ported(cfg)
    return unembed(h, params.embed, cfg.final_softcap)
