"""Seeded stochastic-gradient noise models for the round engine (port of
`repro/fed/noise.py`).

A `NoiseModel` wraps the exact per-agent gradient oracle into a seeded
stochastic one, so every run is replayable bit for bit.

Noise-fold contract (the reference's, pinned by
tests/test_torch_stochastic.py): the noise stream hangs off a DEDICATED
fold of the run key, never off the raw `PRNGKey(seed)` chains that client
sampling (`PartialParticipation.init_state`) and correction compression
(`_CorrectionCompressor.init_state`) split from, so toggling noise on
leaves every compression / participation draw unchanged.

  stream  : ``noise_key(seed) = fold_in(PRNGKey(seed), NOISE_STREAM)``
  round   : ``round_key, sub = split(state["noise_key"])``
  agent i : ``agent_key = fold_in(sub, i)``          (index in 0..m-1)
  eval    : ``fold_in(agent_key, 0)``                 anchor exchange
            ``fold_in(agent_key, 1 + k)``             local step k
  leaf    : ``kx, ky = split(eval_key)``, then ``fold_in(kx, i)`` for
            leaf i of the x gradient (``ky`` for y)

The reference vmaps a one-agent `grad` over the agents and draws once per
evaluation.  Here a model draws the randomness of every agent and of a
batch of evaluations in one threefry pass (`prng`'s key batches): the
engine draws a round's K + 1 evaluations, and those of the rounds after
it, at broadcast, then applies each evaluation's share
(`NoiseModel.draws` / `apply`).  The draws are JAX's:
the discrete ones (`MinibatchNoise`'s indices) bit for bit, the normals
to a few ulp (`prng.normal`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import prng
from ..core.types import SaddleField, tree_flatten, tree_leaves, tree_map

#: Dedicated stream constant for the gradient-noise fold (the reference's).
NOISE_STREAM = 0x5A_6D_A0  # "sagda-0"


def noise_key(seed: int) -> torch.Tensor:
    """Root key of the dedicated gradient-noise stream for `seed`."""
    return prng.fold_in(prng.PRNGKey(seed), NOISE_STREAM)


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """A seeded stochastic gradient oracle, in two steps: `draws` takes
    the randomness of a batch of evaluations at once, `apply` makes one
    evaluation's noisy gradient from its share.

    `draws(keys, xs, ys, data)` takes [E, m, 2] per-evaluation keys (E
    evaluations of m agents, the keys of the contract above) and returns a
    list of E draws; `apply(vgrad, draw, xs, ys, data)` returns the noisy
    per-agent `SaddleField` for the agent-stacked (xs, ys, data), given
    `vgrad`, the exact vmapped oracle (`core.types.vmap_grad_xy(loss)`).
    A draw depends on its key and the leaves' shapes only, never on the
    iterates, so the engine draws rounds of evaluations in one pass,
    equal to drawing each on its own (`grad`); `draw_bytes` is the device
    memory one evaluation's draw holds.  Models are unbiased:
    E_key[grad] == vgrad(xs, ys, data)."""

    def draws(self, keys: torch.Tensor, xs: Any, ys: Any, data: Any) -> list:
        raise NotImplementedError

    def draw_bytes(self, xs: Any, ys: Any, data: Any) -> int:
        raise NotImplementedError

    def apply(self, vgrad: Callable, draw: Any, xs: Any, ys: Any,
              data: Any) -> SaddleField:
        raise NotImplementedError

    def grad(self, vgrad: Callable, keys: torch.Tensor, xs: Any, ys: Any,
             data: Any) -> SaddleField:
        """One evaluation, [m, 2] keys: the reference's vmapped `grad`."""
        return self.apply(vgrad, self.draws(keys[None], xs, ys, data)[0],
                          xs, ys, data)


@dataclasses.dataclass(frozen=True)
class GaussianNoise(NoiseModel):
    """Additive oracle noise: ``g + sigma * N(0, I)`` per leaf.  The x and
    y components, and every leaf within each, draw from disjoint folds of
    the eval key, so pytree layout never correlates draws.  Every leaf of
    one shape and dtype, x and y together, is one `prng.normal` pass, and
    a draw holds sigma * N(0, I), so `apply` adds it in one op (the same
    bits as adding sigma times the normal)."""

    sigma: float = 0.1

    def draws(self, keys, xs, ys, data):
        kxy = prng.split(keys)  # [E, m, 2, 2]: kx, ky per agent
        groups = {}
        for side, tree in enumerate((xs, ys)):
            for i, u in enumerate(tree_flatten(tree)[0]):
                groups.setdefault((tuple(u.shape[1:]), u.dtype, u.device),
                                  []).append((side, i))
        per_leaf = {}
        for (shape, dtype, device), members in groups.items():
            sides = [side for side, _ in members]
            leaves = np.array([i for _, i in members])
            # fold_in(k_side, i) for every member at once: [E, m, L, 2]
            leaf_keys = prng.fold_in(kxy[..., sides, :], leaves).movedim(-2, 0)
            z = prng.normal(leaf_keys, shape, dtype, device) * self.sigma
            per_leaf.update(zip(members, z))
        return [{leaf: z[e] for leaf, z in per_leaf.items()}
                for e in range(keys.shape[0])]

    def draw_bytes(self, xs, ys, data):
        return sum(u.numel() * u.element_size() for u in tree_leaves((xs, ys)))

    def apply(self, vgrad, draw, xs, ys, data):
        g = vgrad(xs, ys, data)
        out = []
        for side, tree in enumerate((g.gx, g.gy)):
            leaves, unflatten = tree_flatten(tree)
            out.append(unflatten([u + draw[(side, i)]
                                  for i, u in enumerate(leaves)]))
        return SaddleField(gx=out[0], gy=out[1])


@dataclasses.dataclass(frozen=True)
class MinibatchNoise(NoiseModel):
    """Subsampling noise: the exact oracle on a minibatch of
    ``round(fraction * n)`` samples drawn WITH replacement along each
    agent's sample axis (axis 1 of every agent-stacked data leaf), so the
    estimator stays unbiased for any loss that is a mean over samples.
    The indices are JAX's `randint` draws (int64 under x64), bit for bit.
    Needs per-sample agent data: the quadratic game's sufficient
    statistics have no sample axis left (use `GaussianNoise` there)."""

    fraction: float = 0.5

    def _batch(self, data) -> int:
        return max(1, int(round(self.fraction * tree_leaves(data)[0].shape[1])))

    def draws(self, keys, xs, ys, data):
        u = tree_leaves(data)[0]
        idx = prng.randint(keys, (self._batch(data),), 0, u.shape[1],
                           device=u.device)  # [E, m, b]
        return list(idx)

    def draw_bytes(self, xs, ys, data):
        return tree_leaves(data)[0].shape[0] * self._batch(data) * 8

    def apply(self, vgrad, draw, xs, ys, data):
        rows = torch.arange(draw.shape[0], device=draw.device)[:, None]
        return vgrad(xs, ys, tree_map(lambda u: u[rows, draw], data))


def resolve_noise(
    spec: Any = None, sigma: Optional[float] = None,
    fraction: Optional[float] = None,
) -> Optional[NoiseModel]:
    """Map a noise spec to a `NoiseModel` (or None = deterministic):
    a `NoiseModel` passes through; None / "none" is deterministic unless a
    scale knob is set, which implies the matching model; "gaussian" or
    "minibatch"."""
    if isinstance(spec, NoiseModel):
        return spec
    if spec in (None, "", "none"):
        if sigma:
            return GaussianNoise(sigma=float(sigma))
        if fraction:
            return MinibatchNoise(fraction=float(fraction))
        return None
    if spec == "gaussian":
        return GaussianNoise(sigma=float(sigma) if sigma is not None else 0.1)
    if spec == "minibatch":
        return MinibatchNoise(
            fraction=float(fraction) if fraction is not None else 0.5)
    raise ValueError(
        f"unknown noise model {spec!r} (none | gaussian | minibatch)")
