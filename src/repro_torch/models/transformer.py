"""Model assembly: pattern-cycled blocks, KV/SSM caches, the chunked LM
loss (port of `repro/models/transformer.py`).

JAX stacks each pattern slot's parameters [num_periods, ...] and scans
one period body; here the layers are a Python loop over an
`nn.ModuleList`, layer `gi` of kind `cfg.layer_types[gi]` (JAX's period
gi // len(pattern), slot gi % len(pattern)).  The zamba2 shared attention
block (JAX's `lax.cond` inside the scan) is a plain `if` after every
`shared_attn_every`-th layer, with JAX's shared-cache index.

The model functions take a `ModelParams` (the serving path) or its tree
of plain tensors (`ModelParams.tree()`, {"layers": [one dict per layer],
"final_norm", "embed", "shared_attn"}), which is what training
differentiates: the round engine vmaps the loss over agent-stacked copies
of that tree, and a vmapped tensor is never wrapped in a parameter.

`remat` is JAX's `jax.checkpoint`: `forward(..., remat=True)` recomputes
each pattern period (with the shared block where it applies) in the
backward, as JAX checkpoints its scan body, and `chunked_lm_loss` each
chunk.  `torch.utils.checkpoint` does not compose with `torch.func.vmap`
(its recompute runs outside the vmap, on escaped batched tensors), so
`remat` is an autograd Function of its own whose `vmap` rule recomputes
under a `vmap` of the body.

Ported: the text frontend and the dense, local, Mamba-1 and Mamba-2
layer kinds.  The `moe` kind and the audio and vision_text frontends
raise `not_ported` (ROADMAP Queue 1 item 12); `forward` has no
`h_sharding` (the SPMD layer, item 13).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.types import tree_flatten, tree_leaves
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

    def tree(self) -> Dict:
        """The parameters as nested dicts and lists of plain tensors
        (sharing storage): {"layers": [one dict per layer], "final_norm",
        "embed", "shared_attn" (zamba2)}, the round engine's x."""
        def plain(m):
            if isinstance(m, nn.ParameterDict):
                return {k: v.detach() for k, v in m.items()}
            return {k: plain(v) for k, v in m.items()}

        out = {"layers": [plain(m) for m in self.layers],
               "final_norm": plain(self.final_norm), "embed": self.embed.detach()}
        if self.shared_attn is not None:
            out["shared_attn"] = plain(self.shared_attn)
        return out

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


def num_params(params) -> int:
    """Elements over the leaves of a `ModelParams` or its tree."""
    return sum(u.numel() for u in tree_leaves(_tree(params)))


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


def _tree(params) -> Dict:
    """A `ModelParams` or its tree, as the tree."""
    return params.tree() if isinstance(params, ModelParams) else params


def embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """batch: {"tokens": [B, St]} (the text frontend)."""
    _check_ported(cfg)
    return embed_tokens(batch["tokens"], _tree(params)["embed"])


def forward(
    params,
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, S, d] embedded inputs (see embed_inputs)
    *,
    caches: Optional[Dict] = None,
    position: Optional[int] = None,  # decode: current absolute position
    remat: bool = False,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict], float]:
    """Returns (final hidden [B,S,d], updated caches, aux loss).

    Prefill (position None) runs positions 0..S-1 into empty caches; a
    decode step (position p) runs one token at p.  remat=True recomputes
    each pattern period in the backward (JAX's `jax.checkpoint(body)`);
    it applies to a forward without caches, the training path.
    use_kernel=False runs the flash-attention and scan kernels' plain
    versions instead."""
    _check_ported(cfg)
    if remat and caches is not None:
        raise ValueError("forward: remat is for the cacheless (training) path")
    tree = _tree(params)
    B, S, _ = h.shape
    per = len(cfg.pattern)
    assert cfg.num_layers % per == 0, (cfg.name, cfg.num_layers, per)
    if position is not None:
        q_positions = torch.tensor([int(position)], dtype=torch.int32, device=h.device)
        cache_index = int(position)
    else:
        q_positions = torch.arange(S, dtype=torch.int32, device=h.device)
        cache_index = 0

    shared_p = tree.get("shared_attn")
    shared = list(caches["shared"]) if caches and cfg.shared_attn_every else None
    new_layers = []

    def apply_shared(h, sp, cache):
        hn = rms_norm(h, sp["ln"]["scale"])
        out, new_cs = multihead_attention(
            sp["attn"],
            hn,
            q_positions=q_positions,
            rope_theta=cfg.rope_theta,
            causal=cfg.causal,
            softcap=cfg.logit_softcap,
            cache=cache,
            cache_index=cache_index,
            use_kernel=use_kernel,
        )
        return h + out, new_cs

    def period(h, layer_ps, sp, i_per):
        """Pattern period i_per: its layers, then the shared block after
        each layer where it applies."""
        new_cs = []
        for j, kind in enumerate(cfg.pattern):
            gi = i_per * per + j
            c = caches["layers"][gi] if caches else None
            h, new_c, _ = _apply_layer(kind, layer_ps[j], cfg, h, c, q_positions,
                                       cache_index, use_kernel)
            new_cs.append(new_c)
            if cfg.shared_attn_every and (gi + 1) % cfg.shared_attn_every == 0:
                s_idx = (gi + 1) // cfg.shared_attn_every - 1
                h, cs = apply_shared(h, sp, shared[s_idx] if shared is not None else None)
                if shared is not None:
                    shared[s_idx] = cs
        return h, new_cs

    for i_per in range(cfg.num_layers // per):
        layer_ps = tree["layers"][i_per * per:(i_per + 1) * per]
        if not remat:
            h, new_cs = period(h, layer_ps, shared_p, i_per)
            new_layers.extend(new_cs)
            continue
        gis = range(i_per * per, (i_per + 1) * per)
        uses_shared = cfg.shared_attn_every and any(
            (gi + 1) % cfg.shared_attn_every == 0 for gi in gis)
        leaves, unflatten = tree_flatten(
            {"layers": list(layer_ps), "shared": shared_p if uses_shared else None})

        def body(h, *leaves, i_per=i_per, unflatten=unflatten):
            p = unflatten(list(leaves))
            return period(h, p["layers"], p["shared"], i_per)[0]

        h = checkpoint(body, h, *leaves)
    h = rms_norm(h, tree["final_norm"]["scale"])
    new_caches = None
    if caches is not None:
        new_caches = {"layers": new_layers}
        if cfg.shared_attn_every:
            new_caches["shared"] = shared
    return h, new_caches, 0.0


def logits_from_hidden(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    _check_ported(cfg)
    return unembed(h, _tree(params)["embed"], cfg.final_softcap)


def chunked_lm_loss(
    params,
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, S, d]
    labels: torch.Tensor,  # [B, S] int, -1 = ignore
    chunk: int = 512,
) -> torch.Tensor:
    """Token CE without materializing [B, S, V]: checkpointed chunks over
    S, summed in f32 as JAX's scan sums them."""
    _check_ported(cfg)
    B, S, _ = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    embed = _tree(params)["embed"]

    def one(hb, lb, embed):
        logits = unembed(hb, embed, cfg.final_softcap)
        logz = torch.logsumexp(logits, dim=-1)
        safe = torch.clamp_min(lb, 0).long()
        gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
        return torch.sum(torch.where(lb >= 0, logz - gold, torch.zeros_like(logz)))

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        lb = labels[:, c0:c0 + chunk]
        tot = tot + checkpoint(one, h[:, c0:c0 + chunk], lb, embed)
        cnt = cnt + torch.sum(lb >= 0).float()
    return tot / torch.clamp_min(cnt, 1.0)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------
def checkpoint(fn: Callable, *tensors: torch.Tensor) -> torch.Tensor:
    """fn(*tensors), one tensor out, its activations recomputed in the
    backward instead of kept (JAX's `jax.checkpoint`).  Every tensor fn
    differentiates must come in `tensors`: under `torch.func.vmap` a
    closed-over mapped tensor would escape the map."""
    return _Checkpoint.apply(fn, *tensors)


class _Checkpoint(torch.autograd.Function):
    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(t.requires_grad) for t in saved]
            out = ctx.fn(*args)
            need = [a for a in args if a.requires_grad]
            grads = iter(torch.autograd.grad(out, need, grad, allow_unused=True))
        return (None,) + tuple(next(grads) if a.requires_grad else None for a in args)

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        mapped = torch.func.vmap(fn, in_dims=tuple(in_dims[1:]),
                                 randomness=info.randomness)
        return _Checkpoint.apply(mapped, *tensors), 0
