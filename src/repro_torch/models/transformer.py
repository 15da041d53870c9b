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
"final_norm", and as the config has them "embed", "frontend_proj",
"out_head", "shared_attn"}), which is what training differentiates: the
round engine vmaps the loss over agent-stacked copies of that tree, and
a vmapped tensor is never wrapped in a parameter.

`remat` is JAX's `jax.checkpoint`: `forward(..., remat=True)` recomputes
each pattern period (with the shared block where it applies) in the
backward, as JAX checkpoints its scan body, and `chunked_lm_loss` each
chunk.  `torch.utils.checkpoint` does not compose with `torch.func.vmap`
(its recompute runs outside the vmap, on escaped batched tensors), so
`remat` is an autograd Function of its own whose `vmap` rule recomputes
under a `vmap` of the body.

Ported: every layer kind (dense, local, moe, Mamba-1, Mamba-2) and
every frontend (text; audio: frames through `frontend_proj`, logits
through `out_head`; vision_text: projected patches before the token
embeddings), so all ten architectures.  `forward` returns the MoE
layers' load-balance aux summed in f32, as JAX's scan sums it.

`h_sharding`, a pair (DeviceMesh, DTensor placements) that the launch
layer resolves from its sharding rules, redistributes the residual stream
at every pattern-period boundary, as JAX constrains its scan carry: the
stored activations are then sharded (sequence parallelism when it maps S
to the model axis).  It is an autograd Function whose backward places the
cotangent alike and whose `vmap` rule keeps the mapped (agent) axis where
it lies.  On a plain tensor it raises.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.types import tree_flatten, tree_leaves
from .attention import init_attention, init_cache, multihead_attention
from .layers import (
    embed_tokens,
    gen_device,
    init_rms_norm,
    init_swiglu,
    normal,
    param,
    rms_norm,
    swiglu,
    unembed,
)
from .mamba import init_mamba, init_mamba_cache, mamba_block
from .moe import init_moe, moe_ffn
from .placement import batch_only, constrain, contracting, logsumexp, rows_scattered

SSM_KINDS = ("mamba1", "mamba2")
ATTN_KINDS = ("attn", "local", "moe")
#: the top-level tensors a model may have beside its layers
TOP_TENSORS = ("embed", "frontend_proj", "out_head")


def as_module(tree):
    """A nested dict of tensors as modules: dicts of tensors become
    `nn.ParameterDict`s, dicts of dicts `nn.ModuleDict`s; both read like
    JAX's parameter dicts (`p["attn"]["wq"]`)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: param(v) for k, v in tree.items()})
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


class ModelParams(nn.Module):
    """The parameters of one model: `layers` (one module per layer, in
    order), `final_norm`, and as its frontend has them `embed` (the token
    table, also the unembedding; not audio), `frontend_proj` (audio and
    vision_text: frame / patch embeddings to d_model) and `out_head`
    (audio: the unembedding), and for zamba2 `shared_attn`.  Built by
    `init_params` (random, from a generator) or, through `from_tree`, by
    `convert.model_params_from_numpy` (the JAX package's weights); the
    model functions below read it."""

    def __init__(self, cfg: ModelConfig, layers: List[nn.Module],
                 final_norm: nn.Module, embed: Optional[torch.Tensor],
                 shared_attn: Optional[nn.Module] = None, *,
                 frontend_proj: Optional[torch.Tensor] = None,
                 out_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        for name, t in zip(TOP_TENSORS, (embed, frontend_proj, out_head)):
            setattr(self, name, None if t is None else param(t))
        self.shared_attn = shared_attn

    def tree(self) -> Dict:
        """The parameters as nested dicts and lists of plain tensors
        (sharing storage): {"layers": [one dict per layer], "final_norm",
        then those of "embed", "frontend_proj", "out_head", "shared_attn"
        the model has}, the round engine's x."""
        def plain(m):
            if isinstance(m, nn.ParameterDict):
                return {k: v.detach() for k, v in m.items()}
            return {k: plain(v) for k, v in m.items()}

        out = {"layers": [plain(m) for m in self.layers],
               "final_norm": plain(self.final_norm)}
        for name in TOP_TENSORS:
            if getattr(self, name) is not None:
                out[name] = getattr(self, name).detach()
        if self.shared_attn is not None:
            out["shared_attn"] = plain(self.shared_attn)
        return out

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: Dict) -> "ModelParams":
        """From nested dicts of tensors, `tree()`'s layout."""
        shared = tree.get("shared_attn")
        return cls(cfg, [as_module(t) for t in tree["layers"]],
                   as_module(tree["final_norm"]), tree.get("embed"),
                   None if shared is None else as_module(shared),
                   frontend_proj=tree.get("frontend_proj"),
                   out_head=tree.get("out_head"))


# --------------------------------------------------------------------------
# parameter construction
# --------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype) -> nn.Module:
    dev = gen_device(gen)
    if kind in ATTN_KINDS:
        p = {
            "ln1": init_rms_norm(cfg.d_model, dtype, dev),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, dtype),
            "ln2": init_rms_norm(cfg.d_model, dtype, dev),
        }
        if kind == "moe":
            p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, dtype)
        else:
            p["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev)
        return nn.ModuleDict(p)
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
    from `gen` on `gen.device`; `gen=None` builds them on `meta`, with no
    draw (the abstract parameters of `launch.steps`)."""
    assert cfg.num_layers % len(cfg.pattern) == 0, (cfg.name, cfg.num_layers)
    dev = gen_device(gen)
    layers = [_init_layer(gen, kind, cfg, dtype) for kind in cfg.layer_types]
    final_norm = init_rms_norm(cfg.d_model, dtype, dev)
    embed = frontend_proj = out_head = None
    if cfg.frontend != "audio":
        embed = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype, dev)
    if cfg.frontend in ("audio", "vision_text"):
        frontend_proj = normal(gen, (cfg.frontend_dim, cfg.d_model),
                               1.0 / math.sqrt(cfg.frontend_dim), dtype, dev)
    if cfg.frontend == "audio":
        out_head = normal(gen, (cfg.d_model, cfg.vocab_size),
                          1.0 / math.sqrt(cfg.d_model), dtype, dev)
    shared = None
    if cfg.shared_attn_every:
        shared = nn.ModuleDict({
            "ln": init_rms_norm(cfg.d_model, dtype, dev),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, dtype),
        })
    return ModelParams(cfg, layers, final_norm, embed, shared,
                       frontend_proj=frontend_proj, out_head=out_head)


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
    layers: List[Dict] = []
    for kind in cfg.layer_types:
        cap = _layer_cache_capacity(kind, cfg, capacity)
        if kind in ATTN_KINDS:
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
    """(h, the layer's new cache, its aux loss or None: MoE layers only)."""
    aux = None
    if kind in ATTN_KINDS:
        hn = contracting(rms_norm(h, p["ln1"]["scale"]), p["attn"]["wq"])
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
        hn2 = batch_only(rms_norm(h, p["ln2"]["scale"]))
        if kind == "moe":
            mo, aux = moe_ffn(p["moe"], hn2, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              dispatch=cfg.moe_dispatch)
        else:
            mo = rows_scattered(swiglu(hn2, p["mlp"]))
        return h + mo, new_c, aux
    if kind in SSM_KINDS:
        hn = batch_only(rms_norm(h, p["ln1"]["scale"]))
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
    raise ValueError(kind)


def _tree(params) -> Dict:
    """A `ModelParams` or its tree, as the tree."""
    return params.tree() if isinstance(params, ModelParams) else params


def embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """batch: {"tokens": [B, St]}, with "patches" [B, P, frontend_dim]
    (vision_text: projected and placed before the tokens), or {"frames":
    [B, S, frontend_dim]} (audio)."""
    tree = _tree(params)
    if cfg.frontend == "audio":
        if "frames" not in batch:
            raise ValueError(f"{cfg.name}: the audio frontend takes a batch of "
                             "'frames', not tokens")
        return batch["frames"] @ tree["frontend_proj"]
    h = embed_tokens(batch["tokens"], tree["embed"])
    if cfg.frontend == "vision_text" and "patches" in batch:
        ph = batch["patches"] @ tree["frontend_proj"]
        h = torch.cat([ph.to(h.dtype), h], dim=1)
    return h


def forward(
    params,
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, S, d] embedded inputs (see embed_inputs)
    *,
    caches: Optional[Dict] = None,
    position: Optional[int] = None,  # decode: current absolute position
    remat: bool = False,
    use_kernel: bool = True,
    h_sharding=None,  # placement of h at each period boundary (DTensors)
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (final hidden [B,S,d], updated caches, aux loss: an f32
    scalar, the sum over the MoE layers, 0 without them).

    Prefill (position None) runs positions 0..S-1 into empty caches; a
    decode step (position p) runs one token at p.  remat=True recomputes
    each pattern period in the backward (JAX's `jax.checkpoint(body)`);
    it applies to a forward without caches, the training path.
    use_kernel=False runs the flash-attention and scan kernels' plain
    versions instead.  h_sharding: module docstring."""
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
        hn = contracting(rms_norm(h, sp["ln"]["scale"]), sp["attn"]["wq"])
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
        each layer where it applies; (h, the period's aux or None without
        MoE layers, new caches)."""
        new_cs = []
        aux = None
        for j, kind in enumerate(cfg.pattern):
            gi = i_per * per + j
            c = caches["layers"][gi] if caches else None
            h, new_c, a = _apply_layer(kind, layer_ps[j], cfg, h, c, q_positions,
                                       cache_index, use_kernel)
            aux = _add(aux, a)
            new_cs.append(new_c)
            if cfg.shared_attn_every and (gi + 1) % cfg.shared_attn_every == 0:
                s_idx = (gi + 1) // cfg.shared_attn_every - 1
                h, cs = apply_shared(h, sp, shared[s_idx] if shared is not None else None)
                if shared is not None:
                    shared[s_idx] = cs
        return h, aux, new_cs

    has_moe = "moe" in cfg.pattern
    aux = None
    for i_per in range(cfg.num_layers // per):
        layer_ps = tree["layers"][i_per * per:(i_per + 1) * per]
        if h_sharding is not None:
            h = constrain(h, h_sharding)
        if not remat:
            h, a, new_cs = period(h, layer_ps, shared_p, i_per)
            aux = _add(aux, a)
            new_layers.extend(new_cs)
            continue
        gis = range(i_per * per, (i_per + 1) * per)
        uses_shared = cfg.shared_attn_every and any(
            (gi + 1) % cfg.shared_attn_every == 0 for gi in gis)
        leaves, unflatten = tree_flatten(
            {"layers": list(layer_ps), "shared": shared_p if uses_shared else None})

        def body(h, *leaves, i_per=i_per, unflatten=unflatten):
            p = unflatten(list(leaves))
            h, a, _ = period(h, p["layers"], p["shared"], i_per)
            return (h, a) if has_moe else h

        out = checkpoint(body, h, *leaves)
        h, aux = (out[0], _add(aux, out[1])) if has_moe else (out, aux)
    h = rms_norm(h, tree["final_norm"]["scale"])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = None
    if caches is not None:
        new_caches = {"layers": new_layers}
        if cfg.shared_attn_every:
            new_caches["shared"] = shared
    return h, new_caches, aux


def _add(total: Optional[torch.Tensor], a: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    """total + a, where None stands for no term yet (a layer without aux)."""
    if a is None:
        return total
    return a if total is None else total + a


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    """The unembedding: `out_head` [d, V] (audio) or `embed` [V, d]."""
    return _tree(params)["out_head" if cfg.frontend == "audio" else "embed"]


def _logits(cfg: ModelConfig, head: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    if cfg.frontend != "audio":
        return unembed(h, head, cfg.final_softcap)
    logits = (h @ head).float()
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def logits_from_hidden(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return _logits(cfg, _head(params, cfg), h)


def chunked_lm_loss(
    params,
    cfg: ModelConfig,
    h: torch.Tensor,  # [B, S, d]
    labels: torch.Tensor,  # [B, S] int, -1 = ignore
    chunk: int = 512,
) -> torch.Tensor:
    """Token CE without materializing [B, S, V]: checkpointed chunks over
    S, summed in f32 as JAX's scan sums them."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    head = _head(params, cfg)
    h = batch_only(h)  # gathered once, not once a chunk

    def one(hb, lb, head):
        logits = _logits(cfg, head, hb)
        logz = logsumexp(logits)
        safe = torch.clamp_min(lb, 0).long()
        # the gold logit as a masked sum: exactly the one kept term, and
        # clean on vocab-sharded DTensor logits under vmap, where a gather
        # is not
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(safe[..., None] == vocab, logits,
                                     torch.zeros_like(logits)), dim=-1)
        return torch.sum(torch.where(lb >= 0, logz - gold, torch.zeros_like(logz)))

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        lb = labels[:, c0:c0 + chunk]
        tot = tot + checkpoint(one, h[:, c0:c0 + chunk], lb, head)
        cnt = cnt + torch.sum(lb >= 0).float()
    return tot / torch.clamp_min(cnt, 1.0)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------
def checkpoint(fn: Callable, *tensors: torch.Tensor):
    """fn(*tensors), a tensor or a tuple of tensors out, its activations
    recomputed in the backward instead of kept (JAX's `jax.checkpoint`).
    Every tensor fn differentiates must come in `tensors`: under
    `torch.func.vmap` a closed-over mapped tensor would escape the map."""
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
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(t.requires_grad) for t in saved]
            out = ctx.fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            # an output that needs no gradient (none of its inputs does)
            # takes no part
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            need = [a for a in args if a.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], need,
                                           [g for _, g in pairs], allow_unused=True))
        return (None,) + tuple(next(got) if a.requires_grad else None for a in args)

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        mapped = torch.func.vmap(fn, in_dims=tuple(in_dims[1:]),
                                 randomness=info.randomness)
        out = _Checkpoint.apply(mapped, *tensors)
        return out, ((0,) * len(out) if isinstance(out, tuple) else 0)
