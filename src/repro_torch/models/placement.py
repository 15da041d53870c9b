"""Layout hints for the SPMD steps: where the model's code places a
DTensor so that DTensor's own choice of collectives is the one GSPMD makes
for JAX's jitted step.

Each hint is the identity on a plain tensor (and on a `torch.func`
transform's wrapper of one), so the plain path runs op for op as without
it.  On a DTensor, or a wrapper of one, it redistributes to placements
that a rule derives from the tensor's own:

  * `constrain(h, (mesh, placements))`: JAX's `with_sharding_constraint`
    (the residual stream at every period boundary); the cotangent is
    placed alike.  A plain tensor raises: it cannot be placed.
  * `batch_only(h)`: every shard but the batch dim's gathered, once per
    block, so that the projections which read the block's input share one
    all-gather (DTensor would gather a sequence-sharded input once per
    projection); the backward reduce-scatters the cotangent back.
  * `contracting(h, w)`: h's feature dim sharded as the weights'
    contraction dim is, for the attention's q / k / v projections.
  * `pinned(t)`: t unchanged, its cotangent placed as t is.
  * `reduced(t)`: a `Partial` reduced in place (an all-reduce), where
    DTensor would reduce-scatter it and gather it again.
  * `rows_scattered(t)`: a partial sum (a block's output, an embedding
    looked up on vocab shards) reduced once, scattered over the sequence.
  * `queries_local(q, k, v)`: attention whose query rows are sharded over
    the sequence and whose keys and values are whole, so no score is a
    partial sum over a sharded head dim.
  * `rows_proj(eq, x, w)`: a projection of a sequence-sharded x that keeps
    its rows where they are (the weight is gathered instead).
  * `lookup(table, tokens)`: an agent-stacked embedding lookup on each
    rank's own agents' tables.
  * `logsumexp(t)`: over a sharded last dim, a max and a sum each reduced
    across the shards, where DTensor would gather t.

A hint is an autograd Function whose `vmap` rule hides the mapped (agent)
axis from the rule and keeps its shards, as the round engine vmaps the
loss over agent-stacked DTensors.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor

Rule = Callable[[Sequence, Tuple[int, ...]], list]


def _base(t: torch.Tensor) -> torch.Tensor:
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t


def split_dims(t: torch.Tensor):
    """{dim of `t`: the mesh dims of more than one rank that shard it}
    where `t`, or the tensor that `torch.func` transforms wrap, is a
    DTensor (a wrapper's own dims, its mapped axes left out); None for a
    plain tensor."""
    from torch._C._functorch import is_batchedtensor, maybe_get_bdim

    bdims = []
    while is_functorch_wrapped_tensor(t):
        if is_batchedtensor(t):
            bdims.append(maybe_get_bdim(t))
        t = get_unwrapped(t)
    if not on_dtensor(t):
        return None
    from torch.distributed.tensor import Shard

    out = {}
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and t.device_mesh.size(i) > 1:
            d = p.dim
            for b in reversed(bdims):  # innermost wrapper first
                d = None if d is None or d == b else d - (d > b)
            if d is not None:
                out.setdefault(d, []).append(i)
    return out


def sharded(t: torch.Tensor) -> bool:
    """`t`, or the tensor `torch.func` transforms wrap, is a DTensor that a
    mesh dim of more than one rank shards or sums (a mapped axis too)."""
    b = _base(t)
    if not on_dtensor(b):
        return False
    from torch.distributed.tensor import Replicate

    return any(not isinstance(p, Replicate) and b.device_mesh.size(i) > 1
               for i, p in enumerate(b.placements))


def on_dtensor(t: torch.Tensor) -> bool:
    """`t`, or the tensor a `torch.func` transform wraps, is a DTensor."""
    b = _base(t)
    if type(b).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(b, DTensor)


def place(t: torch.Tensor, rule: Rule, alike: bool = False) -> torch.Tensor:
    """`t` redistributed to rule(its placements, its shape) where it is a
    DTensor; `t` itself otherwise.  The cotangent goes back to `t`'s own
    placements (a `Partial` one replicated), or with `alike` to the
    rule's."""
    if not on_dtensor(t):
        return t
    return _Place.apply(t, rule, alike)


def _redistribute(t, pl):
    return t if tuple(t.placements) == tuple(pl) else t.redistribute(t.device_mesh, pl)


class _Place(torch.autograd.Function):
    @staticmethod
    def forward(t, rule, alike):
        # a fresh output, not `t`; `detach` keeps the strides (DTensor's
        # `view_as` of a transposed tensor rebuilds them contiguous)
        return _redistribute(t, rule(tuple(t.placements), tuple(t.shape))).detach()

    @staticmethod
    def setup_context(ctx, inputs, output):
        from torch.distributed.tensor import Partial, Replicate

        t, rule, alike = inputs
        ctx.target = (tuple(output.placements) if alike else tuple(
            Replicate() if isinstance(p, Partial) else p for p in t.placements))

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.target), None, None

    @staticmethod
    def vmap(info, in_dims, t, rule, alike):
        if in_dims[0] is None:
            return _Place.apply(t, rule, alike), None
        return _Place.apply(t.movedim(in_dims[0], 0), _lift(rule), alike), 0


def _lift(rule: Rule) -> Rule:
    """`rule` for a tensor with a leading mapped axis: the rule sees the
    mapped tensor's placements and shape; a mesh dim that shards the
    mapped axis keeps that shard."""
    from torch.distributed.tensor import Replicate, Shard

    def lifted(pl, shape):
        mapped = [isinstance(p, Shard) and p.dim == 0 for p in pl]
        inner = [Replicate() if m else (Shard(p.dim - 1) if isinstance(p, Shard) else p)
                 for p, m in zip(pl, mapped)]
        out = rule(tuple(inner), tuple(shape[1:]))
        return [Shard(0) if m else (Shard(p.dim + 1) if isinstance(p, Shard) else p)
                for p, m in zip(out, mapped)]

    return lifted


# ------------------------------------------------------------------ rules
def constrain(h: torch.Tensor, sharding) -> torch.Tensor:
    """h (a DTensor, or a `torch.func.vmap` over one) redistributed to
    `sharding` = (mesh, placements) (JAX's `with_sharding_constraint`)."""
    if not on_dtensor(h):
        raise TypeError("h_sharding: h is a plain tensor, so it cannot be "
                        "placed; the SPMD steps take DTensors")
    _, target = sharding
    return _Place.apply(h, lambda pl, shape: list(target), True)


def batch_only(h: torch.Tensor) -> torch.Tensor:
    """h sharded on its batch dim (0) alone: its other shards gathered."""
    from torch.distributed.tensor import Replicate, Shard

    return place(h, lambda pl, shape: [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate() if isinstance(
            p, Shard) else p for p in pl])


def contracting(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [B, ..., d] placed for products with weights w [d, ...] whose
    contraction dim a mesh dim may shard: on such a mesh dim h's feature
    dim is sharded alike (an all-to-all from a sequence shard), so each
    rank contracts its own slice and the products are partial sums; on
    the others h is sharded on its batch dim alone.  In the backward, the
    weights' gradients are then products of sharded slices, not of
    replicated operands whose product DTensor would form whole on every
    rank."""
    from torch.distributed.tensor import Replicate, Shard

    ws = split_dims(w)
    if ws is None:
        return h
    by_contraction = set(ws.get(0, ()))

    def rule(pl, shape):
        return [Shard(len(shape) - 1) if i in by_contraction else
                p if isinstance(p, Shard) and p.dim == 0 else
                Replicate() if isinstance(p, Shard) else p
                for i, p in enumerate(pl)]

    return place(h, rule)


def pinned(t: torch.Tensor) -> torch.Tensor:
    """t as it is, its cotangent placed as t is (a `Partial` replicated):
    the products that formed t then take their gradients from shards as
    their forward did, where a cotangent arriving replicated would let
    DTensor form a weight's gradient whole on every rank."""
    return place(t, lambda pl, shape: list(pl))


def reduced(t: torch.Tensor) -> torch.Tensor:
    """t with its `Partial` placements reduced to `Replicate`."""
    from torch.distributed.tensor import Partial, Replicate

    return place(t, lambda pl, shape: [Replicate() if isinstance(p, Partial) else p
                                       for p in pl])


def rows_scattered(t: torch.Tensor) -> torch.Tensor:
    """t [B, S, ...] with its `Partial` placements reduced once: scattered
    over the sequence dim where S splits evenly, as the residual stream of
    a sequence-parallel block holds it, else all-reduced (a decode step's
    one position).  The backward gathers the cotangent once for the
    products that formed t."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = _base(t).device_mesh if on_dtensor(t) else None
    return place(t, lambda pl, shape: [
        (Shard(1) if shape[1] % mesh.size(i) == 0 else Replicate())
        if isinstance(p, Partial) else p for i, p in enumerate(pl)])


def queries_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q [B, Sq, H, hd] sharded on its batch dim and, where a mesh dim
    shards or sums anything else, on its sequence dim (replicated where
    Sq does not split evenly); k and v [B, Skv, KV, hd] sharded on their
    batch dim alone."""
    from torch.distributed.tensor import Replicate, Shard

    def q_rule(pl, shape):
        b = _base(q)
        mesh = b.device_mesh
        return [p if isinstance(p, Shard) and p.dim == 0 else
                Replicate() if isinstance(p, Replicate) else
                Shard(1) if shape[1] % mesh.size(i) == 0 else Replicate()
                for i, p in enumerate(pl)]

    def kv_rule(pl, shape):
        return [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]

    return place(q, q_rule), place(k, kv_rule), place(v, kv_rule)


def rows_proj(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """torch.einsum(eq, x, w) for x [B, S, *k] contracted with w [*k, *n]
    over k.  Where a mesh dim shards x's sequence dim, the product keeps
    the rows on their ranks and gathers the (smaller) weight, where the
    einsum's flattening of (B, S) would gather x (DTensor keeps a
    flattened dim sharded only on its leading part): with B whole, one
    `mm` over the rows flattened as (S, B); with B sharded too, a `bmm`
    over the batch with the rows as its M dim.  Elsewhere (plain tensors,
    a one-rank mesh) it is the plain einsum."""
    split = split_dims(x)
    if not split or 1 not in split:
        return torch.einsum(eq, x, w)
    nk = x.dim() - 2
    B, S = x.shape[:2]
    K = math.prod(x.shape[2:])
    out = w.shape[nk:]
    w2 = w.reshape(K, math.prod(out))
    if 0 in split:
        y = torch.bmm(x.reshape(B, S, K), w2.unsqueeze(0).expand(B, *w2.shape))
        return y.reshape(B, S, *out)
    y = torch.mm(x.transpose(0, 1).reshape(S * B, K), w2)
    return y.reshape(S, B, *out).transpose(0, 1)


def logsumexp(t: torch.Tensor) -> torch.Tensor:
    """torch.logsumexp(t, -1).  Where a mesh dim shards the last dim, the
    shifted form max + log(sum(exp(t - max))), whose max and sum reduce
    across the shards (two small all-reduces; the max is a constant of
    the gradient); elsewhere the plain function."""
    split = split_dims(t)
    if not split or (t.dim() - 1) not in split:
        return torch.logsumexp(t, dim=-1)
    m = t.detach().amax(dim=-1, keepdim=True)
    total = reduced(torch.sum(torch.exp(t - m), dim=-1, keepdim=True))
    return (m + torch.log(total))[..., 0]


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens] where the table is a `torch.func.vmap` over agent-
    stacked DTensor tables (the train step's per-agent embeddings): each
    rank looks its own agents' tokens up in their tables, gathered whole
    over the mesh dims that split anything but the agents (the vocab), and
    scatters the cotangent into its own rows in the backward.  DTensor's
    own batched index / scatter would need its strategies for them, which
    torch 2.11 lacks for an agent-sharded index (and 2.13 meets with a
    gather of the cotangent)."""
    return _Lookup.apply(table, tokens)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(table, tokens):
        return table[tokens]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("lookup: differentiated outside torch.func.vmap")

    @staticmethod
    def vmap(info, in_dims, table, tokens):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        if in_dims[0] is None or in_dims[1] is None or not isinstance(table, DTensor):
            raise TypeError("lookup: takes agent-stacked DTensor tables and tokens")
        table = table.movedim(in_dims[0], 0)
        tokens = tokens.movedim(in_dims[1], 0)
        agents = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
        t_pl = [Shard(0) if a else Replicate() for a in agents]
        # the tokens, and the rows looked up, keep their own shards
        k_pl = [Shard(0) if a else p for a, p in zip(agents, tokens.placements)]

        def local(t, k):
            rows = torch.arange(t.shape[0], device=t.device).reshape(
                (-1,) + (1,) * (k.dim() - 1))
            return t[rows, k]

        run = local_map(local, out_placements=k_pl, in_placements=(t_pl, k_pl),
                        device_mesh=table.device_mesh, redistribute_inputs=True)
        return run(table, tokens), 0
