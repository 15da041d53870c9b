"""SPMD step builders: the federated minimax train step and the prefill /
decode serve steps on a `DeviceMesh` (port of `repro/launch/steps.py`).

A train step is ONE federated communication round (`core.engine.
make_round`, any `CommStrategy`; stateful strategies thread their state)
run eagerly on DTensors: the iterates are agent-stacked by the engine and
re-anchored to the agent specs by `constrain_agents`, the residual stream
is placed at every layer boundary by `h_sharding`, and DTensor resolves
every other layout with collectives, as GSPMD does for JAX's jitted
round.  A builder returns JAX's pair `(step_for(shape), specs_fn)`: where
JAX's `jit` has `in_shardings` / `out_shardings`, a step places its inputs
by the rules (`shardings.distribute`: a DTensor is redistributed where it
differs, a plain tensor that every rank holds whole is cut to its shards)
and returns its outputs so placed.  Donation has no counterpart: the round
builds its own copies, and a serve step writes the caches it is given in
place, as the serving path does.

Each step body runs under `implicit_replication()`, so constants made as
plain tensors count as replicated, as they do in JAX.  The kernels on the
path run on their operands' local shards (`kernels._dtensor`).

`specs_fn(shape)` gives the inputs' shapes as `meta` tensors: the abstract
parameters are built by `init_params(None, ...)`, which draws nothing.

The async runtime's server-side gather is `build_gather_decode_train_step`
(`multihost.build_gather_decode_step`): payload buffers sharded over the
fed axes, one all-gather, a replicated decode, so the dry-run can census
its bytes against `expected_gather_bytes`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.engine import default_update, make_round
from ..core.types import tree_map
from ..fed.strategies import CommStrategy, resolve_strategy
from ..models import batch_struct, init_caches, init_params
from ..models.transformer import embed_inputs, forward, logits_from_hidden
from ..problems.adversarial import delta_projection, make_adversarial_loss
from .mesh import agents_mesh, fed_axes, num_agents
from .shardings import (
    agent_pspec,
    cache_pspec,
    distribute_tree,
    make_agent_constraint,
    param_pspec,
    placements,
    serve_batch_sharding,
    train_batch_shardings,
)

Pytree = Any

_CORRECTION_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn,
                      "bfloat16": torch.bfloat16}


def abstract_params(cfg: ModelConfig, dtype) -> Pytree:
    """The parameter tree's shapes and dtypes on `meta` (no draw)."""
    return init_params(None, cfg, dtype).tree()


def abstract_caches(cfg: ModelConfig, batch: int, capacity: int, dtype) -> Pytree:
    return init_caches(cfg, batch, capacity, dtype, "meta")


def delta_struct(cfg: ModelConfig, dtype) -> Dict:
    return {"delta": torch.empty(cfg.d_model, dtype=dtype, device="meta")}


def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


# --------------------------------------------------------------------------
# placements of a step's inputs and outputs
# --------------------------------------------------------------------------
def _params_spec(cfg, mesh, variant):
    return lambda p, u: param_pspec(p, tuple(u.shape), cfg, mesh, variant)


def _replicated(p, u):
    return ()


def _replicate_dtensors(tree: Pytree, mesh) -> Pytree:
    """A strategy state's DTensor leaves replicated (JAX's replicated state);
    its plain leaves (PRNG keys on the host) stay as they are."""
    from ..kernels._dtensor import is_dtensor

    return tree_map(lambda u: distribute_tree(u, mesh, _replicated)
                    if is_dtensor(u) else u, tree)


def _placed(mesh, spec: tuple) -> tuple:
    """`forward`'s h_sharding: the mesh and the spec's placements on it."""
    return mesh, tuple(placements(spec, mesh))


def _h_sharding(cfg: ModelConfig, mesh, h_shard: str, sequence_parallel: bool):
    if h_shard is None:
        h_shard = "seq" if sequence_parallel else "none"
    inner = "data" if cfg.fed_mode == "B" else None
    if h_shard == "seq":
        return _placed(mesh, (inner, "model", None))
    if h_shard == "batch":
        return _placed(mesh, ("model", None, None))
    if h_shard == "none":
        return None
    raise ValueError(f"unknown h_shard {h_shard!r}")


# --------------------------------------------------------------------------
# training (one federated communication round)
# --------------------------------------------------------------------------
def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      dtype=torch.bfloat16) -> Dict:
    """Meta tensors for (x_global, y_global, agent_batches)."""
    m = num_agents(mesh, cfg.fed_mode)
    assert shape.global_batch % m == 0, (shape.global_batch, m)
    b_local = shape.global_batch // m
    one = batch_struct(cfg, b_local, shape.seq_len, dtype)
    return {
        "x": abstract_params(cfg, dtype),
        "y": delta_struct(cfg, dtype),
        "batch": tree_map(lambda s: torch.empty((m,) + tuple(s.shape), dtype=s.dtype,
                                                device="meta"), one),
    }


def _resolve_cfg_strategy(cfg: ModelConfig, algorithm,
                          use_kernel: bool = True) -> CommStrategy:
    """One owner for the cfg-knob -> strategy resolution, shared by the
    train step and the gather-census step (`use_kernel=False`: the
    compressors' plain versions).  The strategy numbers the model's leaves
    per stacked pattern slot, as JAX's (`layer_period`), a ready one too
    where it has not been told otherwise."""
    if isinstance(algorithm, CommStrategy):
        if getattr(algorithm, "layer_period", None) == 0:
            return dataclasses.replace(algorithm, layer_period=len(cfg.pattern))
        return algorithm
    kw = dict(
        use_kernel=use_kernel,
        correction_dtype=_CORRECTION_DTYPES.get(cfg.correction_dtype),
        participation=cfg.participation,
        compression_ratio=cfg.compression_ratio,
        quantization_bits=cfg.quantization_bits,
        wire_transport=cfg.wire_transport,
        momentum=cfg.momentum,
        layer_period=len(cfg.pattern),
    )
    # gate on the cfg knob, not on sigma/fraction: a bare nonzero sigma
    # would make every config stochastic
    if cfg.noise != "none":
        kw.update(noise=cfg.noise, noise_sigma=cfg.noise_sigma,
                  noise_fraction=cfg.noise_fraction, noise_seed=cfg.noise_seed)
    return resolve_strategy(algorithm, **kw)


def _train_loss(cfg, mesh, remat, sequence_parallel, h_shard, q_block, use_kernel):
    if q_block:
        cfg = dataclasses.replace(cfg, q_block=q_block)
    h_sh = _h_sharding(cfg, mesh, h_shard, sequence_parallel)
    return cfg, make_adversarial_loss(cfg, remat=remat, h_sharding=h_sh,
                                      use_kernel=use_kernel)


def build_train_step(
    cfg: ModelConfig,
    mesh,
    *,
    algorithm="fedgda_gt",  # legacy name or a CommStrategy instance
    num_local_steps: int = 4,
    eta: float = 1e-3,
    delta_radius: float = 1.0,
    dtype=torch.bfloat16,
    remat: bool = True,
    sequence_parallel: bool = True,
    sharding_variant: str = "baseline",
    h_shard: Optional[str] = None,  # overrides sequence_parallel: seq|batch|none
    q_block: Optional[int] = None,  # overrides cfg.q_block
    use_kernel: bool = True,
) -> Tuple[Callable, Callable]:
    """Returns (step_for(shape), specs_fn): step(x, y, batch[, state]) ->
    (x, y[, state]), the state for stateful strategies.  use_kernel=False
    runs every kernel's plain version (the dry-run on `meta`, whose
    tensors have no device).  The step runs on `agents_mesh(mesh)`, where
    its DTensor inputs must lie (plain ones are cut to their shards)."""
    mesh = agents_mesh(mesh, cfg.fed_mode)
    cfg, loss = _train_loss(cfg, mesh, remat, sequence_parallel, h_shard,
                            q_block, use_kernel)
    strategy = _resolve_cfg_strategy(cfg, algorithm, use_kernel)
    stateful = strategy.stateful
    rnd = make_round(loss, strategy, num_local_steps, eta,
                     proj_y=delta_projection(delta_radius),
                     update_fn=None if use_kernel else default_update,
                     constrain_agents=make_agent_constraint(cfg, mesh, sharding_variant),
                     explicit_state=stateful)
    x_spec = _params_spec(cfg, mesh, sharding_variant)
    bsh = train_batch_shardings(cfg, mesh)

    def specs_fn(shape: ShapeConfig, dt=dtype):
        sp = train_input_specs(cfg, shape, mesh, dt)
        if stateful:
            # the strategy state (sampling key, error-feedback buffers)
            # rides along as a fourth, replicated step input
            sp["state"] = strategy.init_state(sp["x"], sp["y"],
                                              num_agents(mesh, cfg.fed_mode))
        return sp

    def step_for(shape: ShapeConfig):
        def step(x, y, batch, state=None):
            x = distribute_tree(x, mesh, x_spec)
            y = distribute_tree(y, mesh, _replicated)
            batch = distribute_tree(batch, mesh, lambda p, u: bsh(u.dim()))
            with _implicit_replication():
                if stateful:
                    x1, y1, state = rnd(x, y, batch, state)
                else:
                    x1, y1 = rnd(x, y, batch)
            x1 = distribute_tree(x1, mesh, x_spec)
            y1 = distribute_tree(y1, mesh, _replicated)
            if stateful:
                return x1, y1, _replicate_dtensors(state, mesh)
            return x1, y1

        return step

    return step_for, specs_fn


def build_elastic_train_step(
    cfg: ModelConfig,
    mesh,
    *,
    algorithm="fedgda_gt",
    num_local_steps: int = 4,
    eta: float = 1e-3,
    delta_radius: float = 1.0,
    dtype=torch.bfloat16,
    remat: bool = True,
    sequence_parallel: bool = True,
    sharding_variant: str = "baseline",
    h_shard: Optional[str] = None,
    q_block: Optional[int] = None,
    use_kernel: bool = True,
) -> Tuple[Callable, Callable]:
    """The membership-aware elastic round (`sim.make_elastic_round`) as one
    SPMD step: `build_train_step`'s inputs plus the schedule's: the tracker
    table (per-agent anchor gradients, agent axis over the fed axes like
    the batch) and the [m] weights / budgets / active / prev_active
    (replicated).  step(x, y, batch, state, tracker, weights, budgets,
    active, prev_active) -> (x, y, state, tracker).  It runs on
    `agents_mesh(mesh)`, as `build_train_step`."""
    from ..sim.elastic import make_elastic_round

    mesh = agents_mesh(mesh, cfg.fed_mode)
    cfg, loss = _train_loss(cfg, mesh, remat, sequence_parallel, h_shard,
                            q_block, use_kernel)
    strategy = _resolve_cfg_strategy(cfg, algorithm, use_kernel)
    rnd = make_elastic_round(loss, strategy, num_local_steps, eta,
                             proj_y=delta_projection(delta_radius),
                             update_fn=None if use_kernel else default_update,
                             constrain_agents=make_agent_constraint(
                                 cfg, mesh, sharding_variant))
    m = num_agents(mesh, cfg.fed_mode)
    x_spec = _params_spec(cfg, mesh, sharding_variant)
    bsh = train_batch_shardings(cfg, mesh)

    def tracker_spec(p, u):  # "gx/<x's path>", "gy/delta"
        return agent_pspec(p[3:], tuple(u.shape), cfg, mesh, sharding_variant)

    def specs_fn(shape: ShapeConfig, dt=dtype):
        sp = train_input_specs(cfg, shape, mesh, dt)
        sp["state"] = strategy.init_state(sp["x"], sp["y"], m)
        stack = lambda t: tree_map(lambda s: torch.empty(
            (m,) + tuple(s.shape), dtype=s.dtype, device="meta"), t)
        sp["tracker"] = ({"gx": stack(sp["x"]), "gy": stack(sp["y"])}
                         if getattr(strategy, "use_correction", False) else {})
        meta = lambda dt: torch.empty((m,), dtype=dt, device="meta")
        sp["weights"] = meta(torch.float32)
        sp["budgets"] = meta(torch.int32)
        sp["active"] = meta(torch.bool)
        sp["prev_active"] = meta(torch.bool)
        return sp

    def step_for(shape: ShapeConfig):
        def step(x, y, batch, state, tracker, weights, budgets, active,
                 prev_active):
            x = distribute_tree(x, mesh, x_spec)
            y = distribute_tree(y, mesh, _replicated)
            batch = distribute_tree(batch, mesh, lambda p, u: bsh(u.dim()))
            tracker = distribute_tree(tracker, mesh, tracker_spec)
            with _implicit_replication():
                x1, y1, state, tracker = rnd(x, y, batch, state, tracker, weights,
                                             budgets, active, prev_active)
            return (distribute_tree(x1, mesh, x_spec),
                    distribute_tree(y1, mesh, _replicated),
                    _replicate_dtensors(state, mesh),
                    distribute_tree(tracker, mesh, tracker_spec))

        return step

    return step_for, specs_fn


def pod_aggregation_plan(cfg: ModelConfig, mesh, num_pods: int) -> Dict:
    """The two-level aggregation tree's placement on a launch mesh: agents
    (the fed-axes device product) split into `num_pods` contiguous rank
    groups (`mesh.pod_device_groups`), each owning the level-one partial
    sum of its agents; only the per-pod partials cross group boundaries.
    Returns num_pods / agents_per_pod / devices_per_pod, pod_payload_bytes
    (one pod's per-round price on the pod <-> server edge,
    `fed.pods.pod_payload_bytes`) and groups (per-pod rank lists)."""
    from ..fed.pods import pod_payload_bytes
    from .mesh import pod_device_groups

    m = num_agents(mesh, cfg.fed_mode)
    groups = pod_device_groups(mesh, cfg.fed_mode, num_pods)
    x = abstract_params(cfg, torch.bfloat16)
    y = delta_struct(cfg, torch.bfloat16)
    return {
        "num_pods": num_pods,
        "agents_per_pod": m // num_pods,
        "devices_per_pod": len(groups[0]),
        "pod_payload_bytes": pod_payload_bytes(x, y, measured=False,
                                               period=len(cfg.pattern)),
        "groups": groups,
    }


def build_gather_decode_train_step(cfg: ModelConfig, mesh, *,
                                   algorithm="fedgda_gt", dtype=torch.bfloat16):
    """The async runtime's server-side exchange as one SPMD step on the
    mesh: all-gather the per-agent packed correction payloads over the fed
    axes and decode them replicated.  Returns (step, arg_structs,
    expected_gather_bytes), as `multihost.build_gather_decode_step`."""
    from .multihost import build_gather_decode_step

    strategy = _resolve_cfg_strategy(cfg, algorithm)
    return build_gather_decode_step(strategy, abstract_params(cfg, dtype),
                                    delta_struct(cfg, dtype), mesh,
                                    fed_axes(mesh, cfg.fed_mode))


# --------------------------------------------------------------------------
# serving (prefill builds the KV cache; decode extends it one token)
# --------------------------------------------------------------------------
def _serve_placers(cfg, mesh, batch: int, variant: str):
    return (_params_spec(cfg, mesh, variant),
            lambda p, u: cache_pspec(p, tuple(u.shape), cfg, mesh),
            lambda p, u: serve_batch_sharding(mesh, batch, u.dim()))


def build_prefill_step(cfg: ModelConfig, mesh, *, dtype=torch.bfloat16,
                       sequence_parallel: bool = True,
                       sharding_variant: str = "baseline",
                       use_kernel: bool = True):
    """step(params, batch, caches) -> (last-position logits [B, 1, V],
    caches); an encoder-only config's step(params, batch) -> logits
    [B, S, V].  The caches are written in place."""
    dp = fed_axes(mesh, "A")  # ("pod", "data") as the mesh has them
    h_sh = (_placed(mesh, (dp if dp else None, "model", None))
            if sequence_parallel else None)

    def specs_fn(shape: ShapeConfig):
        sp = {"params": abstract_params(cfg, dtype),
              "batch": batch_struct(cfg, shape.global_batch, shape.seq_len, dtype)}
        if cfg.supports_decode:
            sp["caches"] = abstract_caches(cfg, shape.global_batch, shape.seq_len,
                                           dtype)
        return sp

    def step_for(shape: ShapeConfig):
        B = shape.global_batch
        p_spec, c_spec, b_spec = _serve_placers(cfg, mesh, B, sharding_variant)

        def encoder_fwd(params, batch):
            params = distribute_tree(params, mesh, p_spec)
            batch = distribute_tree(batch, mesh, b_spec)
            with _implicit_replication():
                h = embed_inputs(params, cfg, batch)
                h, _, _ = forward(params, cfg, h, h_sharding=h_sh,
                                  use_kernel=use_kernel)
                logits = logits_from_hidden(params, cfg, h)
            return distribute_tree(logits, mesh, b_spec)

        def prefill(params, batch, caches):
            params = distribute_tree(params, mesh, p_spec)
            batch = distribute_tree(batch, mesh, b_spec)
            caches = distribute_tree(caches, mesh, c_spec)
            with _implicit_replication():
                h = embed_inputs(params, cfg, batch)
                h, caches, _ = forward(params, cfg, h, caches=caches,
                                       h_sharding=h_sh, use_kernel=use_kernel)
                logits = logits_from_hidden(params, cfg, h[:, -1:])
            return (distribute_tree(logits, mesh, b_spec),
                    distribute_tree(caches, mesh, c_spec))

        return prefill if cfg.supports_decode else encoder_fwd

    return step_for, specs_fn


def build_decode_step(cfg: ModelConfig, mesh, *, dtype=torch.bfloat16,
                      sharding_variant: str = "baseline",
                      use_kernel: bool = True):
    """One new token against a seq_len cache: step(params, caches, tokens
    [B, 1], position) -> (logits [B, 1, V], caches)."""

    def specs_fn(shape: ShapeConfig):
        B = shape.global_batch
        return {
            "params": abstract_params(cfg, dtype),
            "caches": abstract_caches(cfg, B, shape.seq_len, dtype),
            "tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"),
            "position": 0,
        }

    def step_for(shape: ShapeConfig):
        p_spec, c_spec, b_spec = _serve_placers(cfg, mesh, shape.global_batch,
                                                sharding_variant)

        def decode(params, caches, tokens, position):
            params = distribute_tree(params, mesh, p_spec)
            caches = distribute_tree(caches, mesh, c_spec)
            tokens = distribute_tree(tokens, mesh, b_spec)
            with _implicit_replication():
                h = embed_inputs(params, cfg, {"tokens": tokens})
                h, caches, _ = forward(params, cfg, h, caches=caches,
                                       position=int(position),
                                       use_kernel=use_kernel)
                logits = logits_from_hidden(params, cfg, h)
            return (distribute_tree(logits, mesh, b_spec),
                    distribute_tree(caches, mesh, c_spec))

        return decode

    return step_for, specs_fn


def step_builder_for(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw):
    """Dispatch on the input-shape kind; kw goes to that kind's builder."""
    if shape.kind == "train":
        return build_train_step(cfg, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, **kw)
    return build_decode_step(cfg, mesh, **kw)
