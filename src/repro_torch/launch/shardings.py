"""Sharding rules: parameters, agent-stacked state, batches and caches
(port of `repro/launch/shardings.py`).

Rules:
  * params: largest >=2-D dim divisible by the model-axis size -> "model";
    MoE expert dim -> "data" (expert parallelism, fed mode B);
    embed table vocab dim -> "model";  1-D leaves replicated.
  * agent-stacked training state: leading agent axis -> fed axes
    (("pod","data") mode A, ("pod",) mode B).
  * batches: train — agent axis over fed axes, per-agent batch over the
    within-agent data axis (mode B);  serve — batch over ("pod","data").
  * KV caches: batch dim over ("pod","data") when divisible, else the
    capacity (sequence) dim over "data" (context parallelism, long_500k).

A rule returns a spec, the port of `PartitionSpec`: a tuple with one entry
per tensor dim, each None, an axis name or a tuple of axis names (a spec
shorter than the tensor leaves the rest replicated).  `placements` turns a
spec into DTensor placements on a `DeviceMesh`: `Shard(d)` on every mesh
dim named in entry d, `Replicate()` elsewhere; a tuple entry names its
axes in mesh order, so DTensor splits them major to minor as JAX does.

The port's trees hold one module per layer (`layers/<i>/...`) where JAX
stacks each pattern slot's periods (`blocks/<slot>/...`, its leading stack
axis replicated), so a port leaf's spec is the JAX stacked leaf's without
that entry; `param_pspec` keeps JAX's `blocks/` offset for JAX's paths.
Caches likewise: JAX's [n_layers, B, C, KV, hd] is the port's per-layer
[B, C, KV, hd].
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .mesh import axis_names, axis_sizes, fed_axes

Pytree = Any
Spec = Tuple  # entries: None | axis name | tuple of axis names


def _entry(axes: Tuple[str, ...]):
    """A spec entry for mesh axes: None, one name, or a tuple of two or
    more (`PartitionSpec` writes a 1-tuple as its name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _largest_divisible(shape, start: int, size: int) -> Optional[int]:
    best, best_dim = None, -1
    for i in range(start, len(shape)):
        if shape[i] % size == 0 and shape[i] > best_dim:
            best, best_dim = i, shape[i]
    return best


def _baseline_pspec(path_str, shape, cfg, mesh, off) -> Spec:
    """Paper-faithful first cut: largest >=2-D dim divisible by the model
    axis.  It leaves contraction dims sharded, which the step resolves
    with per-layer activation collectives."""
    sizes = axis_sizes(mesh)
    model_n, data_n = sizes["model"], sizes.get("data", 1)
    entries = [None] * len(shape)
    is_expert = "/moe/" in path_str and path_str.rsplit("/", 1)[-1] in (
        "gate", "up", "down")
    if is_expert and cfg.fed_mode == "B" and shape[off] % data_n == 0:
        entries[off] = "data"
        j = _largest_divisible(shape, off + 1, model_n)
        if j is not None:
            entries[j] = "model"
        return tuple(entries)
    j = _largest_divisible(shape, off, model_n)
    if j is not None:
        entries[j] = "model"
    return tuple(entries)


def _megatron_pspec(path_str, shape, cfg, mesh, off) -> Spec:
    """Column/row pairing, so every matmul is local and the only model-axis
    collective is one activation reduction per block half:

      wq      [d, H, hd]   -> column on H (heads); replicate if H % n != 0
      wk/wv   [d, KV, hd]  -> column on KV, else replicate
      wo      [H, hd, d]   -> row on H
      gate/up [d, ff]      -> column on ff;  down [ff, d] -> row on ff
      embed   [V, d]       -> vocab-sharded
      MoE     [E, d, ff]   -> E over data (mode B) + column/row on ff
      mamba   in_proj column on 2*d_inner, out_proj row on d_inner,
              x/dt/conv/norm replicated
    """
    sizes = axis_sizes(mesh)
    model_n, data_n = sizes["model"], sizes.get("data", 1)
    name = path_str.rsplit("/", 1)[-1]
    entries = [None] * len(shape)
    if len(shape) - off < 2:
        return tuple(entries)

    def put(i, ok=True) -> Spec:
        if ok:
            entries[i] = "model"
        return tuple(entries)

    if "/moe/" in path_str and name in ("gate", "up", "down"):
        if cfg.fed_mode == "B" and shape[off] % data_n == 0:
            entries[off] = "data"  # expert parallelism
        ff_dim = off + 2 if name in ("gate", "up") else off + 1
        return put(ff_dim, shape[ff_dim] % model_n == 0)
    column = ("wq", "wk", "wv", "gate", "up", "in_proj", "frontend_proj", "out_head")
    row = ("wo", "down", "embed", "out_proj")
    if name in column:
        return put(off + 1, shape[off + 1] % model_n == 0)
    if name in row:
        return put(off, shape[off] % model_n == 0)
    # router / x_proj / dt_proj / conv / norms / biases: replicated (tiny)
    return tuple(entries)


def param_pspec(path_str: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh,
                variant: str = "baseline") -> Spec:
    """The spec of one parameter leaf at `path_str` ("layers/3/attn/wq" in
    the port; JAX's stacked "blocks/..." paths skip their stack axis)."""
    off = 1 if path_str.startswith("blocks/") else 0
    if len(shape) - off < 2:
        return (None,) * len(shape)  # replicate 1-D / scalar leaves
    if variant == "megatron":
        return _megatron_pspec(path_str, shape, cfg, mesh, off)
    if variant != "baseline":
        raise ValueError(f"unknown sharding variant {variant!r}")
    return _baseline_pspec(path_str, shape, cfg, mesh, off)


def agent_pspec(path_str: str, shape, cfg: ModelConfig, mesh,
                variant: str = "baseline") -> Spec:
    """Spec for agent-stacked ([m, ...]) training state."""
    base = param_pspec(path_str, tuple(shape[1:]), cfg, mesh, variant)
    return (_entry(fed_axes(mesh, cfg.fed_mode)), *base)


def train_batch_shardings(cfg: ModelConfig, mesh) -> Callable[[int], Spec]:
    """Agent-stacked batch [m, B_local, ...]: agent axis over fed axes;
    mode B additionally shards B_local over the within-agent data axis.
    Returns spec_for(leaf_ndim)."""
    fa = fed_axes(mesh, cfg.fed_mode)
    inner = "data" if (cfg.fed_mode == "B" and "data" in axis_names(mesh)) else None

    def spec_for(leaf_ndim: int) -> Spec:
        return (_entry(fa), inner) + (None,) * (leaf_ndim - 2)

    return spec_for


def _dp_axes(mesh) -> Tuple[Tuple[str, ...], int]:
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    sizes = axis_sizes(mesh)
    return axes, math.prod(sizes[a] for a in axes)


def serve_batch_sharding(mesh, batch: int, leaf_ndim: int) -> Spec:
    axes, n = _dp_axes(mesh)
    first = _entry(axes) if batch % n == 0 else None
    return (first,) + (None,) * (leaf_ndim - 1)


def cache_pspec(path_str: str, shape, cfg: ModelConfig, mesh) -> Spec:
    """Per-layer cache leaves: [B, C, KV, hd] (attention k / v), [C]
    (pos), [B, W-1, di] (conv), [B, nh, p, N] (ssm)."""
    sizes = axis_sizes(mesh)
    model_n = sizes["model"]
    dp_axes, dp_n = _dp_axes(mesh)
    name = path_str.rsplit("/", 1)[-1]
    entries = [None] * len(shape)
    batch_ok = bool(dp_axes) and shape and shape[0] % dp_n == 0
    if name in ("k", "v"):
        B, C, KV, hd = shape
        if batch_ok:
            entries[0] = _entry(dp_axes)
        elif "data" in sizes and C % sizes["data"] == 0:
            entries[1] = "data"  # context parallelism over the KV sequence
        if KV % model_n == 0:
            entries[2] = "model"
        elif hd % model_n == 0:
            entries[3] = "model"
    elif name == "conv":
        if batch_ok:
            entries[0] = _entry(dp_axes)
        if shape[2] % model_n == 0:
            entries[2] = "model"
    elif name == "ssm":
        if batch_ok:
            entries[0] = _entry(dp_axes)
        if shape[1] % model_n == 0:
            entries[1] = "model"
    # "pos": replicated slot-position metadata
    return tuple(entries)


def replicated(mesh) -> Spec:
    return ()


# --------------------------------------------------------------------------
# specs on DeviceMeshes
# --------------------------------------------------------------------------
def placements(spec: Spec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: Shard(d) on each mesh dim
    that entry d names, Replicate() on the rest.  A mesh dim of one rank
    replicates what it would shard (the same layout), which keeps
    DTensor's propagation off such dims (a one-rank mesh's steps run as
    replicated tensors)."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None and sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return out


def tree_map_with_path(fn: Callable, tree: Pytree, prefix: str = "") -> Pytree:
    """fn(path, leaf) over the port's trees of dicts and lists ("layers/3/
    attn/wq"); leaves that are not tensors (a cache's "used" flag) pass
    through."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    if tree is None or not isinstance(tree, torch.Tensor):
        return tree
    return fn(prefix, tree)


def param_shardings(params: Pytree, cfg: ModelConfig, mesh,
                    variant: str = "baseline") -> Pytree:
    """Placements for the global (server) parameter tree."""
    return tree_map_with_path(
        lambda p, u: placements(param_pspec(p, tuple(u.shape), cfg, mesh, variant),
                                mesh), params)


def cache_shardings(caches: Pytree, cfg: ModelConfig, mesh) -> Pytree:
    return tree_map_with_path(
        lambda p, u: placements(cache_pspec(p, tuple(u.shape), cfg, mesh), mesh),
        caches)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """`t` as a DTensor placed by `spec`: a DTensor is redistributed; a
    plain tensor holding the whole value on every rank is cut to its local
    shards (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def distribute_tree(tree: Pytree, mesh, spec_fn: Callable) -> Pytree:
    """Every tensor leaf placed by spec_fn(path, leaf)."""
    return tree_map_with_path(lambda p, u: distribute(u, mesh, spec_fn(p, u)), tree)


def make_agent_constraint(cfg: ModelConfig, mesh, variant: str = "baseline"):
    """The `constrain_agents` hook of the round engine: redistributes each
    agent-stacked DTensor of xs to its `agent_pspec` and of ys to the fed
    axes, the counterpart of `with_sharding_constraint`.  A plain tensor
    raises: it has no placement to anchor."""
    from torch.distributed.tensor import DTensor

    fa = fed_axes(mesh, cfg.fed_mode)

    def anchor(u, spec):
        if not isinstance(u, DTensor):
            raise TypeError("constrain_agents: a plain tensor reached the SPMD "
                            "constraint; the step takes DTensors")
        pl = placements(spec, mesh)
        return u if tuple(u.placements) == tuple(pl) else u.redistribute(mesh, pl)

    def constrain(xs, ys):
        xs = tree_map_with_path(
            lambda p, u: anchor(u, agent_pspec(p, tuple(u.shape), cfg, mesh, variant)),
            xs)
        ys = tree_map_with_path(lambda p, u: anchor(u, (_entry(fa),)), ys)
        return xs, ys

    return constrain
