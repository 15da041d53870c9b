"""Phase-split federated minimax round engine (port of
`repro/core/engine.py`).

One communication round is four phases over an explicit `RoundState`:

  broadcast             server ships (x^t, y^t) to the agents; a strategy
                        may sample participants (client-sampling weights)
                        and, when stochastic, the round's per-agent noise
                        keys
  exchange_corrections  (if the strategy corrects drift) agents exchange
                        gradients once at the anchor point and form the
                        tracking correction c_i = gbar - g_i, optionally
                        stored in a reduced dtype, then transformed by the
                        strategy (compressed, quantized; a packed wire
                        payload comes back with a `decode` hook and is
                        decoded here)
  local_steps           K local GDA steps, each adding c_i to the local
                        gradient (fused-k0 anchor step when the correction
                        is exact)
  aggregate             server averages and projects

`make_round` is their composition.  Each `jax.lax.scan` of the reference
is a Python loop here.  Per-agent gradients are autodiff, as the
reference's `jax.vmap(jax.grad)`: `types.vmap_grad_xy` gives the values
of `torch.func.vmap(torch.func.grad)` in one backward pass.

Fused k=0 (exact): when the correction is exact, the first local gradient
is evaluated at the same point as the tracking gradient, so g_i + c_i ==
gbar and the first step is z <- z -/+ eta * gbar (`anchor_step`), saving
one gradient evaluation and one update per round.

Stochastic rounds: a strategy with a `noise` model draws each gradient
from a seeded oracle (the fold tree is documented in `fed/noise.py`): the
anchor exchange at eval index 0, local step k at 1 + k, and the fused
anchor step is off (the tracked gbar and the first local step see
different draws).  A draw depends on its keys and the leaves' shapes
only, so broadcast draws a round's evaluations, and those of the rounds
after it on the strategy's key chain, in one pass (`NoiseModel.draws`,
`rounds_ahead`), and each gradient applies its share
(`NoiseModel.apply`).  With `momentum` the local steps are
heavy-ball steps (Local SGDA+; `optim.momentum.heavy_ball`).  With
neither, the round is the deterministic trace, op for op.

Elastic rounds (`sim.elastic.make_elastic_round`): `broadcast` takes an
elastic schedule's per-agent local-step budgets and availability mask, and
`local_steps` advances agent i at step k only while k < budget_i (the
fused anchor step only where the budget is >= 1; momentum gates iterates
and velocities alike), through `agent_where`.  Without budgets the round
has no gating op at all.

Sparse rounds (`sim.sparse.SparseElasticEngine`): the rows are an active
subset of the registry, `broadcast(..., active_indices=ids)` carries their
global ids, and a noisy strategy folds those ids into the round's noise
keys (`sample_noise_keys_ids`), so an agent draws the same stream in either
layout.  The two-level aggregate (`pod_weighted_sums` -> `pods_total`)
sums agents into their pods, then pods at the server.

SPMD rounds (`launch.steps`): `constrain_agents` re-anchors the placement
of the agent-stacked iterates where JAX's engine constrains them (after
broadcast, after the fused anchor step and after every corrected or
heavy-ball local step); `launch.shardings.make_agent_constraint` builds it
for DTensors.  Without it the round has no such op.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, host_to_device
from .types import (
    LossFn,
    ProjFn,
    Pytree,
    identity_proj,
    tree_broadcast_agents,
    tree_leaves,
    tree_map,
    vmap_grad_xy,
)

#: sentinel distinguishing "no override" from an explicit None weight
#: override in `broadcast` (None means uniform averaging)
_UNSET = object()


def default_update(z: Pytree, g: Pytree, c: Pytree, eta, sign: float) -> Pytree:
    """z <- z + sign*eta*(g + c); sign=-1 descent (x), +1 ascent (y).

    The plain op-by-op update of the reference engine, in the leaves'
    own dtype.  `make_phases` defaults to the kernel-backed
    `kernels.make_gt_update_fn()` instead, which equals this bit for bit
    on f64 and f32 leaves."""
    return tree_map(
        lambda u, gv, cv: u + sign * eta * (gv + cv.to(gv.dtype)), z, g, c
    )


def agent_mean(tree: Pytree, weights) -> Pytree:
    """Uniform mean over the agent axis (weights None) or a weighted sum
    with participation weights.  A DTensor leaf is reduced on each rank's
    own agents and the partial results combined across the ranks
    (`_agent_reduce`)."""
    if weights is None:
        return tree_map(lambda u: _agent_reduce(
            lambda v: torch.mean(v, dim=0), u, None), tree)
    return tree_map(lambda u: _agent_reduce(
        lambda v, w: torch.tensordot(w.to(v.dtype), v, dims=1), u, weights), tree)


def _agent_reduce(fn, u, weights):
    """fn(u[, weights]) over the agent axis (dim 0).  On a DTensor, fn runs
    on each rank's local shard (its own agents, and the weights' slice for
    them) and the result is a `Partial` over the mesh dims that split the
    agents (an average for the mean, a sum for the weighted sum), keeping
    the leaf's other placements: a reduction, where DTensor would gather
    the agents of a leaf that is a partial sum elsewhere.  On a mesh whose
    dims are all replicated, fn runs on the whole tensor as it does on a
    plain one."""
    from ..kernels._dtensor import is_dtensor

    if not is_dtensor(u):
        return fn(u) if weights is None else fn(u, weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = u.device_mesh
    agents = [isinstance(p, Shard) and p.dim == 0 for p in u.placements]
    out = [Partial("avg" if weights is None else "sum") if a else
           Shard(p.dim - 1) if isinstance(p, Shard) else p
           for p, a in zip(u.placements, agents)]
    in_pl = (tuple(u.placements),)
    args = (u,)
    if weights is not None:
        if not isinstance(weights, DTensor):
            weights = DTensor.from_local(weights, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
        in_pl += (tuple(Shard(0) if a else Replicate() for a in agents),)
        args += (weights,)
    return local_map(fn, out_placements=out, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def agent_weighted_sum(tree: Pytree, weights) -> Pytree:
    """Partial aggregate of one agent SHARD: the weighted sum (weights
    None: plain sum — divide by the global m after combining shards)."""
    if weights is None:
        return tree_map(lambda u: torch.sum(u, dim=0), tree)
    return tree_map(
        lambda u: torch.tensordot(weights.to(u.dtype), u, dims=1), tree
    )


def anchor_step(zs: Pytree, gbar: Pytree, eta, sign: float) -> Pytree:
    """The fused k=0 local step: every agent moves by the global gradient."""
    return tree_map(
        lambda u, gb: u + sign * eta * gb[None].to(u.dtype), zs, gbar
    )


def tracking_corrections(
    gx: Pytree, gy: Pytree, gbar_x: Pytree, gbar_y: Pytree, cdt=None
):
    """The raw tracking corrections c_i = gbar - g_i per agent, optionally
    stored reduced (`cdt`): fp8 e4m3 overflow gives NaN keeping the sign on
    every device, as in JAX and in torch's CUDA cast (some torch CPU builds
    saturate to +-448 instead; ROADMAP Queue 3)."""
    # lazy: the kernels package imports core
    from ..kernels.ref import cast_to

    def corr(gbar, gi):
        c = gbar[None] - gi
        if cdt is not None:
            c = cast_to(c, cdt)
        return c

    return tree_map(corr, gbar_x, gx), tree_map(corr, gbar_y, gy)


def agent_where(mask, a: Pytree, b: Pytree) -> Pytree:
    """Per-agent select: leaves of `a` where the [m] mask holds, else
    `b`'s (the membership / budget gate of the elastic schedules; the mask
    broadcasts over every trailing leaf dimension)."""
    return tree_map(
        lambda u, v: torch.where(mask.reshape(mask.shape + (1,) * (u.dim() - 1)),
                                 u, v),
        a, b,
    )


def pod_weighted_sums(tree: Pytree, weights, pod_ids, num_pods: int) -> Pytree:
    """Level one of the agent -> pod -> server aggregation tree: each pod's
    partial weighted sum of its agents' rows (`pod_ids`: [n] pod of each
    row, any order, e.g. `sim.PodMap.pod_of` of the active ids).  Leaves
    gain a leading [num_pods] axis; quiet pods are exact zero rows.

    The segment sum is deterministic on every device: rows are placed, in
    their order, into a zero-padded [num_pods, most rows in a pod, ...]
    buffer (one index_put with distinct targets, no atomics) and summed
    over the padding axis, so the same round gives the same bits and a
    NaN row stays in its own pod (the reference's `segment_sum`; a one-hot
    matmul would carry 0 * NaN into every pod)."""
    # the layout on the host: row i goes to (pod_ids[i], its rank in pod)
    ids = (pod_ids if torch.is_tensor(pod_ids)
           else torch.as_tensor(np.asarray(pod_ids))).to("cpu", torch.int64)
    n = ids.shape[0]
    if n and not (0 <= int(ids.min()) and int(ids.max()) < num_pods):
        raise ValueError(f"pod ids must lie in [0, {num_pods})")
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=num_pods)
    slot = torch.empty_like(ids)
    slot[order] = torch.arange(n) - (torch.cumsum(counts, 0) - counts)[ids[order]]
    width = max(1, int(counts.max()) if n else 0)
    places = {}

    def seg(u):
        dev = u.device
        if dev not in places:
            places[dev] = (host_to_device(ids, dev), host_to_device(slot, dev))
        uw = u * weights.to(u.dtype).reshape((-1,) + (1,) * (u.dim() - 1))
        buf = torch.zeros((num_pods, width) + tuple(u.shape[1:]), dtype=u.dtype,
                          device=dev)
        buf[places[dev]] = uw
        return torch.sum(buf, dim=1)

    return tree_map(seg, tree)


def pods_total(pod_tree: Pytree) -> Pytree:
    """Level two: the server's sum over the pod axis of the partial
    aggregates (quiet pods add exact zeros)."""
    return tree_map(lambda u: torch.sum(u, dim=0), pod_tree)


def fixed_size_mask(key: torch.Tensor, m: int, size: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """Boolean [m] mask with exactly `size` uniformly chosen agents active
    (uniform without replacement via `prng.permutation`), JAX's bit for
    bit.  Drawn on `device` (default CUDA)."""
    from .. import prng

    sel = prng.permutation(key, m, device)[:size]
    mask = torch.zeros((m,), dtype=torch.bool, device=sel.device)
    mask[sel] = True
    return mask


def renormalized_weights(active, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Uniform aggregation weights over the active set, re-normalized to
    sum to 1 for any nonempty active set (a boolean mask or 0/1 floats;
    f64 by default, JAX's default float under x64)."""
    a = torch.as_tensor(active).to(dtype or torch.float64)
    return a / torch.sum(a)


def noise_eval_keys(noise_keys: torch.Tensor, idx) -> torch.Tensor:
    """Per-agent evaluation keys of a stochastic gradient call: fold the
    in-round call index (0 = the anchor exchange, 1 + k = local step k)
    into each agent's per-round noise key ([m, 2] keys, on the CPU).  An
    index array broadcasts against the keys' leading axes."""
    from .. import prng

    return prng.fold_in(noise_keys, idx)


def round_eval_keys(noise_keys: torch.Tensor, num_evals: int) -> torch.Tensor:
    """`noise_eval_keys` at the indices 0 .. num_evals - 1 in one fold:
    [..., num_evals, m, 2] for the [..., m, 2] noise keys of one round or
    more."""
    return noise_eval_keys(noise_keys[..., None, :, :],
                           np.arange(num_evals)[:, None])


#: a noisy broadcast draws at most this many rounds in one pass, and at
#: most this many bytes of draws: a pass's threefry words (twice the bytes
#: of f64 draws) then stay within an H100's 50 MB L2.  A round of the
#: d=4096, m=16 main path (11 MiB) draws alone; at 5 rounds a pass its
#: draw took 2.41 ms of device time a round, against 1.76 ms alone
#: (chip_smoke's stochastic_main_path and device_draws)
DRAW_AHEAD_ROUNDS = 64
DRAW_AHEAD_BYTES = 16 << 20


def rounds_ahead(noise, num_evals: int, xs: Pytree, ys: Pytree,
                 agent_data: Pytree) -> int:
    """The rounds one pass of a noisy broadcast draws: the round's own and
    those after it, within DRAW_AHEAD_ROUNDS and DRAW_AHEAD_BYTES."""
    per_round = num_evals * noise.draw_bytes(xs, ys, agent_data)
    return max(1, min(DRAW_AHEAD_ROUNDS, DRAW_AHEAD_BYTES // max(1, per_round)))


def make_noise_vgrad(vgrad: Callable, noise) -> Callable:
    """The per-agent stochastic gradient oracle of a noise model:
    `(keys[m], xs, ys, agent_data) -> SaddleField`, the stochastic
    counterpart of `vgrad(xs, ys, agent_data)`, one evaluation of
    `noise.grad` (`fed.noise.NoiseModel`).  The reference vmaps the
    model's one-agent `grad` over the agents; here the model takes the
    agent batch and the vmapped oracle `vgrad`, so each draw covers every
    agent in one pass.  The round uses the same draws and applies them
    (`make_phases`)."""

    def nvgrad(keys, xs, ys, agent_data):
        return noise.grad(vgrad, keys, xs, ys, agent_data)

    return nvgrad


@dataclasses.dataclass
class RoundState:
    """Explicit state threaded through the round phases.

    Populated progressively: `broadcast` fills xs/ys/weights (and an
    elastic schedule's step_budgets / active when a runner passes them),
    `exchange_corrections` fills cx/cy/gbar_x/gbar_y/fused,
    `local_steps` advances xs/ys, `aggregate` consumes the lot."""

    x: Pytree                      # global iterates at round start
    y: Pytree
    state: Pytree                  # strategy state
    xs: Pytree = None              # per-agent iterates [m, ...]
    ys: Pytree = None
    weights: Optional[torch.Tensor] = None  # participation weights (None=uniform)
    cx: Pytree = None              # tracking corrections [m, ...]
    cy: Pytree = None
    gbar_x: Pytree = None          # anchor-point global gradients
    gbar_y: Pytree = None
    noise_keys: Optional[torch.Tensor] = None  # [m, 2] per-round noise keys
    noise_draws: Optional[list] = None  # the round's draws, by eval index
    step_budgets: Optional[torch.Tensor] = None  # [m] local-step caps (None=K)
    active: Optional[torch.Tensor] = None        # [m] availability mask
    fused: bool = False            # anchor shortcut applies
    active_indices: Optional[np.ndarray] = None  # global ids of sparse rows


class RoundPhases(NamedTuple):
    """The four phase functions for one strategy (see module docstring).

    broadcast(x, y, agent_data, state, *, weights=..., step_budgets=None,
              active=None, noise_keys=..., active_indices=None) -> RoundState
    exchange_corrections(rs, agent_data) -> RoundState
    local_steps(rs, agent_data) -> RoundState
    aggregate(rs) -> (x1, y1, state)"""

    broadcast: Callable
    exchange_corrections: Callable
    local_steps: Callable
    aggregate: Callable


def _num_agents(agent_data: Pytree) -> int:
    return tree_leaves(agent_data)[0].shape[0]


def _step_gates(budgets, num_local_steps: int):
    """[K, m] masks, row k: the agents whose budget still covers step k
    (k < budget), in one op for the whole round."""
    k = torch.arange(num_local_steps, dtype=budgets.dtype, device=budgets.device)
    return k[:, None] < budgets[None, :]


def make_phases(
    loss: LossFn,
    strategy,
    num_local_steps: int,
    eta_x: float,
    eta_y: Optional[float] = None,
    *,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
    update_fn: Optional[Callable] = None,
    constrain_agents: Optional[Callable] = None,
) -> RoundPhases:
    """Build the four round phases for `strategy` (see RoundPhases).

    `update_fn` (the corrected local step) defaults to the kernel-backed
    `kernels.make_gt_update_fn()`: on f64 and f32 leaves its math is
    exactly `default_update`'s (bit for bit); on narrower leaves it
    follows the Pallas kernel (f32 math, cast back to the leaf dtype).
    `constrain_agents(xs, ys) -> (xs, ys)` re-anchors the agent-stacked
    iterates' placement (module docstring)."""
    if eta_y is None:
        eta_y = eta_x
    if update_fn is None:
        # lazy: kernels.ops maps pytrees with core.types
        from ..kernels.ops import make_gt_update_fn

        update_fn = make_gt_update_fn()
    # the kernel-backed default updates x and y together (one launch a
    # local step); a caller's own update_fn keeps its two calls
    pair = getattr(update_fn, "pair", None)
    vgrad = vmap_grad_xy(loss)

    if getattr(strategy, "sync_every_step", False):
        # FullSync: K communicated steps, each a centralized GDA update;
        # broadcast/exchange are identities and the whole round lives in
        # local_steps (each "local" step IS a global aggregate).
        def gda_step(x, y, agent_data, weights=None):
            m = _num_agents(agent_data)
            g = vgrad(
                tree_broadcast_agents(x, m), tree_broadcast_agents(y, m),
                agent_data,
            )
            gx = agent_mean(g.gx, weights)
            gy = agent_mean(g.gy, weights)
            x1 = proj_x(tree_map(lambda u, v: u - eta_x * v, x, gx))
            y1 = proj_y(tree_map(lambda u, v: u + eta_y * v, y, gy))
            return x1, y1

        def broadcast(x, y, agent_data, state, *, weights=_UNSET,
                      step_budgets=None, active=None, noise_keys=_UNSET,
                      active_indices=None):
            # every "local" step is a global aggregate, so there is no
            # per-agent divergence to budget: step_budgets is ignored and an
            # elastic schedule's membership enters through `weights`.
            # FullSync is a deterministic baseline: noise_keys accepted for
            # signature uniformity, never consumed
            del agent_data, step_budgets, noise_keys
            w = None if weights is _UNSET else weights
            return RoundState(x=x, y=y, state=state, weights=w, active=active,
                              active_indices=active_indices)

        def exchange_corrections(rs, agent_data):
            del agent_data
            return rs

        def local_steps(rs, agent_data):
            x, y = rs.x, rs.y
            for _ in range(num_local_steps):
                x, y = gda_step(x, y, agent_data, rs.weights)
            return dataclasses.replace(rs, x=x, y=y)

        def aggregate(rs):
            return rs.x, rs.y, rs.state

        return RoundPhases(broadcast, exchange_corrections, local_steps, aggregate)

    use_corr = bool(getattr(strategy, "use_correction", False))
    cdt = getattr(strategy, "correction_dtype", None)
    # stochastic knobs: None / 0.0 keep the deterministic trace op for op
    # (no zeroed noise, no 0-scaled velocity)
    noise = getattr(strategy, "noise", None)
    momentum = float(getattr(strategy, "momentum", 0.0) or 0.0)
    if momentum:
        # lazy: optim.momentum imports core
        from ..optim.momentum import heavy_ball
    # rounds drawn ahead, by their noise keys (`round_draws`)
    ahead: dict = {}

    def round_draws(noise_keys, state, xs, ys, agent_data):
        """The round's draws by eval index: the anchor exchange (0) and the
        K local steps (1 + k).  `state` (the strategy state after this
        round's keys; None where the caller gave the keys) continues the
        key chain: one pass draws the rounds after this one too, and
        those rounds find their draws in `ahead`."""
        tag = noise_keys.cpu().numpy().tobytes()
        if tag in ahead:
            return ahead.pop(tag)
        ahead.clear()
        m, evals = noise_keys.shape[0], num_local_steps + 1
        keys = [noise_keys]
        if state is not None:
            for _ in range(rounds_ahead(noise, evals, xs, ys, agent_data) - 1):
                k, state = strategy.sample_noise_keys(state, m)
                keys.append(k)
        flat = noise.draws(round_eval_keys(torch.stack(keys), evals).reshape(-1, m, 2),
                           xs, ys, agent_data)
        for r in range(1, len(keys)):
            ahead[keys[r].cpu().numpy().tobytes()] = flat[r * evals:(r + 1) * evals]
        return flat[:evals]

    def broadcast(x, y, agent_data, state, *, weights=_UNSET,
                  step_budgets=None, active=None, noise_keys=_UNSET,
                  active_indices=None):
        m = _num_agents(agent_data)
        if weights is _UNSET:
            weights, state = strategy.sample_weights(state, m)
        chain = None
        if noise_keys is _UNSET:
            noise_keys = None
            if noise is not None and active_indices is not None:
                # sparse rows: fold the global ids, so each agent draws
                # the stream it would draw in the dense [m] layout (the
                # next rounds' ids are unknown here: no draw ahead)
                noise_keys, state = strategy.sample_noise_keys_ids(
                    state, active_indices)
            elif noise is not None:
                noise_keys, state = strategy.sample_noise_keys(state, m)
                chain = state
        if weights is not None:
            # sampled on the host; the aggregates run where the iterates are
            weights = weights.to(tree_leaves(x)[0].device)
        xs, ys = tree_broadcast_agents(x, m), tree_broadcast_agents(y, m)
        if constrain_agents is not None:
            xs, ys = constrain_agents(xs, ys)
        draws = None
        if noise is not None and noise_keys is not None:
            draws = round_draws(noise_keys, chain, xs, ys, agent_data)
        return RoundState(x=x, y=y, state=state, xs=xs, ys=ys, weights=weights,
                          noise_keys=noise_keys, noise_draws=draws,
                          step_budgets=step_budgets, active=active,
                          active_indices=active_indices)

    def exchange_corrections(rs, agent_data):
        if not use_corr:
            return rs
        m = _num_agents(agent_data)
        if m > 1:
            # one gradient exchange at the anchor point (eval index 0 of
            # the noise stream when stochastic)
            if rs.noise_draws is None:
                g0 = vgrad(rs.xs, rs.ys, agent_data)
            else:
                g0 = noise.apply(vgrad, rs.noise_draws[0], rs.xs, rs.ys,
                                 agent_data)
            gbar_x = agent_mean(g0.gx, rs.weights)
            gbar_y = agent_mean(g0.gy, rs.weights)
            cx, cy = tracking_corrections(g0.gx, g0.gy, gbar_x, gbar_y, cdt)
            cx, cy, state = strategy.transform_correction(cx, cy, rs.state)
            # wire-transport strategies hand back packed payloads
            # (`fed.transport.PackedTree`, duck-typed on its `decode`
            # hook): scatter them back to dense corrections
            if hasattr(cx, "decode"):
                cx = cx.decode()
            if hasattr(cy, "decode"):
                cy = cy.decode()
            # momentum folds the correction into a velocity, so the first
            # step is no longer the plain anchor update
            fused = bool(strategy.exact_correction) and not momentum
            return dataclasses.replace(
                rs, cx=cx, cy=cy, gbar_x=gbar_x, gbar_y=gbar_y,
                fused=fused, state=state,
            )
        # m == 1: the correction is identically zero and elided
        cx = tree_map(torch.zeros_like, rs.xs)
        cy = tree_map(torch.zeros_like, rs.ys)
        return dataclasses.replace(rs, cx=cx, cy=cy)

    def local_steps(rs, agent_data):
        xs, ys = rs.xs, rs.ys
        # elastic budgets: gates[k] holds the agents still stepping at step
        # k; a spent (or absent, budget 0) agent's iterate is frozen, so its
        # weighted share of the aggregate (and an absent agent's zero
        # weight) stays exact.  None is the round without any gating op
        gates = (None if rs.step_budgets is None
                 else _step_gates(rs.step_budgets, num_local_steps))

        def grads(xs, ys, k):
            # k is the in-round step index; the stochastic oracle draws at
            # eval index 1 + k (0 belongs to the anchor exchange)
            if rs.noise_draws is None:
                return vgrad(xs, ys, agent_data)
            return noise.apply(vgrad, rs.noise_draws[1 + k], xs, ys, agent_data)

        start = 0
        if rs.fused:
            xs1 = anchor_step(xs, rs.gbar_x, eta_x, -1.0)
            ys1 = anchor_step(ys, rs.gbar_y, eta_y, +1.0)
            if constrain_agents is not None:
                xs1, ys1 = constrain_agents(xs1, ys1)
            if gates is None:
                xs, ys = xs1, ys1
            else:  # budget >= 1
                xs = agent_where(gates[0], xs1, xs)
                ys = agent_where(gates[0], ys1, ys)
            start = 1
        if momentum:
            # heavy-ball local steps (Local SGDA+): per-round velocities,
            # zero-initialized, carrying the corrected step direction;
            # budget gating freezes iterate and velocity alike, so a spent
            # agent's round contribution is exactly its last live step
            def eff(g, c):
                if not use_corr:
                    return g
                return tree_map(lambda gv, cv: gv + cv.to(gv.dtype), g, c)

            vx = tree_map(torch.zeros_like, xs)
            vy = tree_map(torch.zeros_like, ys)
            for k in range(start, num_local_steps):
                g = grads(xs, ys, k)
                vx1 = heavy_ball(vx, eff(g.gx, rs.cx), momentum)
                vy1 = heavy_ball(vy, eff(g.gy, rs.cy), momentum)
                xs1 = tree_map(lambda u, v: u - eta_x * v, xs, vx1)
                ys1 = tree_map(lambda u, v: u + eta_y * v, ys, vy1)
                if constrain_agents is not None:
                    xs1, ys1 = constrain_agents(xs1, ys1)
                if gates is None:
                    xs, ys, vx, vy = xs1, ys1, vx1, vy1
                else:
                    live = gates[k]
                    xs, ys = agent_where(live, xs1, xs), agent_where(live, ys1, ys)
                    vx, vy = agent_where(live, vx1, vx), agent_where(live, vy1, vy)
            return dataclasses.replace(rs, xs=xs, ys=ys)
        for k in range(start, num_local_steps):
            g = grads(xs, ys, k)
            if use_corr:
                if pair is not None:  # x and y in one launch
                    xs1, ys1 = pair(xs, g.gx, rs.cx, eta_x, ys, g.gy, rs.cy, eta_y)
                else:
                    xs1 = update_fn(xs, g.gx, rs.cx, eta_x, -1.0)
                    ys1 = update_fn(ys, g.gy, rs.cy, eta_y, +1.0)
                if constrain_agents is not None:
                    # re-anchor the carry's placement every step
                    xs1, ys1 = constrain_agents(xs1, ys1)
            else:
                xs1 = tree_map(lambda u, v: u - eta_x * v, xs, g.gx)
                ys1 = tree_map(lambda u, v: u + eta_y * v, ys, g.gy)
            if gates is None:
                xs, ys = xs1, ys1
            else:
                xs = agent_where(gates[k], xs1, xs)
                ys = agent_where(gates[k], ys1, ys)
            # freed before the next step's gradients are formed: each is
            # m copies of the model
            del g, xs1, ys1
        return dataclasses.replace(rs, xs=xs, ys=ys)

    def aggregate(rs):
        x1 = proj_x(agent_mean(rs.xs, rs.weights))
        y1 = proj_y(agent_mean(rs.ys, rs.weights))
        return x1, y1, rs.state

    return RoundPhases(broadcast, exchange_corrections, local_steps, aggregate)


def make_round(
    loss: LossFn,
    strategy,
    num_local_steps: int,
    eta_x: float,
    eta_y: Optional[float] = None,
    *,
    proj_x: ProjFn = identity_proj,
    proj_y: ProjFn = identity_proj,
    update_fn: Optional[Callable] = None,
    constrain_agents: Optional[Callable] = None,
    explicit_state: Optional[bool] = None,
) -> Callable:
    """Build one communication round for `strategy`: the composition of
    the four phases (`make_phases`; `update_fn` defaults as there).

    Returns `round(x, y, agent_data) -> (x, y)` for stateless strategies;
    `explicit_state=True` gives `round(x, y, agent_data, state) ->
    (x, y, state)`."""
    stateful = bool(getattr(strategy, "stateful", False))
    if explicit_state is None:
        explicit_state = stateful
    if stateful and not explicit_state:
        raise ValueError(
            f"strategy {strategy!r} carries cross-round state; build with "
            "explicit_state=True and thread `state` through the rounds"
        )
    phases = make_phases(
        loss,
        strategy,
        num_local_steps,
        eta_x,
        eta_y,
        proj_x=proj_x,
        proj_y=proj_y,
        update_fn=update_fn,
        constrain_agents=constrain_agents,
    )
    return round_from_phases(phases, explicit_state)


def round_from_phases(phases: RoundPhases, explicit_state: bool) -> Callable:
    """`make_round`'s round over phases already built: broadcast,
    exchange_corrections, local_steps, aggregate in order."""

    def core(x, y, agent_data, state):
        rs = phases.broadcast(x, y, agent_data, state)
        rs = phases.exchange_corrections(rs, agent_data)
        rs = phases.local_steps(rs, agent_data)
        return phases.aggregate(rs)

    if explicit_state:
        return core

    def round(x, y, agent_data):
        x1, y1, _ = core(x, y, agent_data, {})
        return x1, y1

    return round


def stack_metrics(history: list) -> Pytree:
    """Stack a list of per-round metric trees along a new leading axis,
    on the device (no host sync)."""
    return tree_map(lambda *vals: torch.stack(vals), *history)


def run_strategy_rounds(
    round_fn: Callable,
    x0: Pytree,
    y0: Pytree,
    agent_data: Pytree,
    num_rounds: int,
    state0: Optional[Pytree] = None,
    metric_fn: Optional[Callable] = None,
):
    """Run a stateful round (built with `explicit_state=True`) for
    `num_rounds`, threading the strategy state.

    Returns ((x, y, state), metrics) with metrics evaluated on the input
    of each round plus once at the end, stacked on the device."""
    x, y, s = x0, y0, ({} if state0 is None else state0)
    history = []
    for _ in range(num_rounds):
        if metric_fn is not None:
            history.append(metric_fn(x, y))
        x, y, s = round_fn(x, y, agent_data, s)
    if metric_fn is None:
        return (x, y, s), None
    history.append(metric_fn(x, y))
    return (x, y, s), stack_metrics(history)
