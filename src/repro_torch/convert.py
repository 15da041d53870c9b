"""Carry state across from the JAX package, as numpy.

`np.asarray` of a JAX array gives numpy, except that bf16 and fp8 arrays
come back as `ml_dtypes` arrays, which `torch.from_numpy` rejects: those
are reinterpreted bit for bit through uint16 / uint8 views.  Nothing here
imports JAX or the JAX package: callers hand over numpy arrays.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .core.types import MinimaxProblem, identity_proj, tree_map
from .device import DeviceLike, resolve_device

#: ml_dtypes names -> (same-width unsigned view, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(
    a, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """One numpy (or ml_dtypes) array as a tensor on `device` (default
    CUDA), optionally cast to `dtype`.  The values are copied exactly."""
    device = resolve_device(device)
    a = np.asarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        t = torch.from_numpy(np.ascontiguousarray(a).view(view[0]).copy())
        t = t.view(view[1])
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def tree_from_numpy(
    tree: Any, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Any:
    """Every leaf of `tree` (dicts / lists / tuples of numpy arrays) as a
    tensor on `device`, optionally cast to `dtype`."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device, dtype), tree)


def _problem_kind(kind: str):
    """(loss, proj_y) of a problem kind: the projection travels with it."""
    from .core.projections import l2_ball_proj, simplex_proj
    from .problems import agnostic, quadratic, robust_regression, toy

    kinds = {
        "quadratic": (quadratic._loss, identity_proj),
        "toy": (toy._loss, identity_proj),
        "robust_regression": (robust_regression._loss, l2_ball_proj(1.0)),
        "agnostic": (agnostic._loss, simplex_proj()),
    }
    if kind not in kinds:
        raise ValueError(f"unknown problem kind {kind!r} ({' | '.join(kinds)})")
    return kinds[kind]


def problem_from_numpy(
    kind: str,
    agent_data: Any,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> MinimaxProblem:
    """The port's `MinimaxProblem` of `kind` ("quadratic" | "toy" |
    "robust_regression" | "agnostic") on the JAX package's agent data
    (numpy), e.g. the `repro.problems` builders' `agent_data` after
    `np.asarray`.  The kind brings its Proj_Y: the unit l2 ball for
    robust regression (the builder's default radius), the simplex for
    agnostic FL.  `dtype` casts the floating leaves only (agnostic's int32
    `agent_index` stays integral)."""
    loss, proj_y = _problem_kind(kind)
    device = resolve_device(device)

    def leaf(a):
        t = tensor_from_numpy(a, device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    data = tree_map(leaf, dict(agent_data))
    m = int(next(iter(data.values())).shape[0])
    return MinimaxProblem(loss=loss, agent_data=data, num_agents=m, proj_y=proj_y)


def strategy_state_from_numpy(state: dict, device: DeviceLike = None) -> dict:
    """A strategy state of the JAX package (as numpy) as the port's: the
    per-agent trees ("ex" / "ey" error-feedback buffers, bf16 / fp8 kept
    bit for bit) on `device` (default CUDA), and an RNG "key" (uint32[2])
    as the port's `prng` key (int64 words, on the CPU).  Both sides then
    start a round from the same state."""
    out = {}
    for name, value in state.items():
        if name == "key":
            words = np.asarray(value).astype(np.int64)
            if words.shape != (2,):
                raise ValueError(f"a key is uint32[2], got shape {words.shape}")
            out[name] = torch.from_numpy(words.copy())
        else:
            out[name] = tree_from_numpy(value, device)
    return out


def model_params_from_numpy(cfg, tree: Any, device: DeviceLike = None,
                            dtype: Optional[torch.dtype] = None):
    """The JAX package's model parameters (`jax.tree.map(np.asarray,
    params)` of `repro.models.init_params`) as the port's `ModelParams` on
    `device` (default CUDA).  JAX stacks each pattern slot's layers
    ([n_per, ...] under "blocks/{j}_{kind}"); layer gi of the port is
    period gi // len(pattern) of slot gi % len(pattern)."""
    from .models.transformer import ModelParams

    device = resolve_device(device)
    per = len(cfg.pattern)
    layers = []
    for gi, kind in enumerate(cfg.layer_types):
        i_per, j = divmod(gi, per)
        stacked = tree["blocks"][f"{j}_{kind}"]
        layers.append(tree_map(
            lambda a: tensor_from_numpy(np.asarray(a)[i_per], device, dtype), stacked))
    out = {"layers": layers,
           "final_norm": tree_from_numpy(tree["final_norm"], device, dtype),
           "embed": tensor_from_numpy(tree["embed"], device, dtype)}
    if "shared_attn" in tree:
        out["shared_attn"] = tree_from_numpy(tree["shared_attn"], device, dtype)
    return ModelParams.from_tree(cfg, out)
