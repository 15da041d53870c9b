"""Core type definitions for federated minimax optimization
(port of `repro/core/types.py`).

A minimax problem is  min_{x in X} max_{y in Y} (1/m) sum_i f_i(x, y)
where f_i is agent i's private objective.  Agent data is "agent-stacked":
every leaf carries a leading axis of size m.  Pytrees are tensors, dicts,
lists, tuples and NamedTuples of tensors, mapped by the small helpers
below (the counterpart of `jax.tree`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple

import torch
from torch.func import grad, vmap

Pytree = Any
# loss(x, y, agent_data) -> scalar.  agent_data is ONE agent's slice.
LossFn = Callable[[Pytree, Pytree, Pytree], torch.Tensor]
# projection(p) -> p projected onto the feasible set.
ProjFn = Callable[[Pytree], Pytree]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply `fn` leafwise over trees of the same structure (None stays
    None, as an empty subtree in JAX)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(
            *(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
        )
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, *leaves) for leaves in zip(tree, *rest)
        )
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_flatten(tree: Pytree):
    """(leaves, unflatten) in JAX's leaf order, where dict keys are
    visited sorted (`tree_leaves` follows insertion order).  Code that
    numbers leaves the way the JAX package does, such as the per-leaf
    seed folds of the compressors, flattens with this;
    `unflatten(new_leaves)` rebuilds the original structure."""
    leaves = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: walk(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return len(leaves) - 1

    skeleton = walk(tree)

    def unflatten(new_leaves):
        return tree_map(lambda i: new_leaves[i], skeleton)

    return leaves, unflatten


def leaf_groups(tree: Pytree, period: int = 0) -> List[List[int]]:
    """JAX's leaves of `tree`, in JAX's order, each as the indices of the
    `tree_flatten(tree)` leaves it holds.  A plain tree maps leaf for
    leaf.  A model tree ({"layers": [one dict per layer], ...}) of a
    config whose pattern has `period` slots is held by JAX with each
    slot's layers stacked ([n_per, ...] under "blocks/{j}_{kind}", the
    map of `convert.model_tree_from_numpy`): one group per (slot, path),
    the slot's layers in order, the slots in JAX's key order, all before
    the other top-level leaves (`"blocks"` sorts first)."""
    leaves, unflatten = tree_flatten(tree)
    layers = tree.get("layers") if isinstance(tree, dict) else None
    if not period or not isinstance(layers, list) or not layers:
        return [[i] for i in range(len(leaves))]
    if len(layers) % period:
        raise ValueError(f"{len(layers)} layers do not fill a pattern of {period}")
    ids = unflatten(list(range(len(leaves))))
    groups = []
    for j in sorted(range(period), key=lambda j: f"{j}_"):  # "{j}_{kind}" keys
        per_layer = [tree_flatten(ids["layers"][i])[0]
                     for i in range(j, len(layers), period)]
        groups.extend(list(g) for g in zip(*per_layer))
    rest = {k: v for k, v in ids.items() if k != "layers"}
    groups.extend([i] for i in tree_flatten(rest)[0])
    return groups


def tree_reduce(fn: Callable, tree: Pytree):
    leaves = tree_leaves(tree)
    out = leaves[0]
    for leaf in leaves[1:]:
        out = fn(out, leaf)
    return out


def identity_proj(p: Pytree) -> Pytree:
    return p


@dataclasses.dataclass(frozen=True)
class MinimaxProblem:
    """min_x max_y (1/m) sum_i loss(x, y, agent_data_i).

    Attributes:
      loss: per-agent loss; pure function of (x, y, agent_data).
      agent_data: pytree whose leaves have leading axis m (one slice/agent).
      num_agents: m.
      proj_x / proj_y: projections onto X and Y (identity = unconstrained).
    """

    loss: LossFn
    agent_data: Pytree
    num_agents: int
    proj_x: ProjFn = identity_proj
    proj_y: ProjFn = identity_proj

    def agent_slice(self, i: int) -> Pytree:
        return tree_map(lambda a: a[i], self.agent_data)

    def global_loss(self, x: Pytree, y: Pytree) -> torch.Tensor:
        per_agent = vmap(self.loss, in_dims=(None, None, 0))(
            x, y, self.agent_data
        )
        return torch.mean(per_agent)


class SaddleField(NamedTuple):
    """F(z) = (grad_x f, -grad_y f) evaluated per agent and globally."""

    gx: Pytree
    gy: Pytree  # NOTE: stores +grad_y; ascent applies the + sign.


def grad_xy(loss: LossFn) -> Callable[[Pytree, Pytree, Pytree], SaddleField]:
    """Returns a function computing (grad_x, grad_y) of the loss."""
    g = grad(loss, argnums=(0, 1))

    def f(x: Pytree, y: Pytree, data: Pytree) -> SaddleField:
        gx, gy = g(x, y, data)
        return SaddleField(gx=gx, gy=gy)

    return f


def vmap_grad_xy(loss: LossFn) -> Callable[[Pytree, Pytree, Pytree], SaddleField]:
    """Per-agent (grad_x, grad_y) over agent-stacked (xs, ys, data): the
    values of `torch.func.vmap(grad_xy(loss))`, computed as ONE backward
    pass through the sum of the vmapped per-agent losses.  The agents'
    losses are independent, so d(sum)/d(xs[i]) is agent i's gradient, bit
    for bit (tests/test_torch_engine.py pins it); in eager mode this costs
    about 0.6x the host time of vmapping `torch.func.grad`, which is what
    bounds the small paper problems."""
    vloss = vmap(loss, in_dims=(0, 0, 0))

    def f(xs: Pytree, ys: Pytree, data: Pytree) -> SaddleField:
        with torch.enable_grad():
            xr = tree_map(lambda u: u.detach().requires_grad_(), xs)
            yr = tree_map(lambda u: u.detach().requires_grad_(), ys)
            leaves = tree_leaves(xr) + tree_leaves(yr)
            grads = torch.autograd.grad(
                vloss(xr, yr, data).sum(), leaves, allow_unused=True
            )
        # contiguous, as the fused update kernel takes them (a model's
        # einsum gradients can come back permuted; a no-op elsewhere)
        grads = iter(
            torch.zeros_like(u) if gv is None else gv.contiguous()
            for u, gv in zip(leaves, grads)
        )
        gx = tree_map(lambda _: next(grads), xs)
        gy = tree_map(lambda _: next(grads), ys)
        return SaddleField(gx=gx, gy=gy)

    return f


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Pytree, s) -> Pytree:
    return tree_map(lambda u: u * s, a)


def tree_mean_over_agents(a: Pytree) -> Pytree:
    """Mean over the leading (agent) axis of every leaf."""
    return tree_map(lambda u: torch.mean(u, dim=0), a)


def tree_broadcast_agents(a: Pytree, m: int) -> Pytree:
    """Stack m copies along a new leading axis.

    The copies are materialized (contiguous), unlike JAX's broadcast_to:
    a stride-0 `expand` view would reach the fused update kernel on the
    m == 1 path, which takes contiguous tensors only."""
    return tree_map(
        lambda u: u.unsqueeze(0).expand((m,) + tuple(u.shape)).contiguous(), a
    )


def tree_sq_dist(a: Pytree, b: Pytree) -> torch.Tensor:
    """||a - b||^2 summed over all leaves."""
    d = tree_map(lambda u, v: torch.sum((u - v) ** 2), a, b)
    return tree_reduce(torch.add, d)


def tree_cast(a: Pytree, dtype) -> Pytree:
    return tree_map(lambda u: u.to(dtype), a)
