"""Production-mesh dry-run: a step traced on a fake world, with its
executed-op census (port of `repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k [--multi-pod | --both-meshes | --all] \\
        [--telemetry DIR] ...

JAX lowers and compiles each step for 256 or 512 emulated host devices
and reads its HLO.  Here the production mesh (`mesh.make_production_mesh`)
lies over a fake process group of 256 or 512 ranks in this one process
(`torch.testing`'s `FakeStore`: collectives return at once, with their
results' shapes), the inputs are `meta` DTensors placed by the rules, and
the step runs eagerly under `census.Census`, so the census counts the ops
that rank 0 executes.  Meta tensors have no device, so every kernel runs
its plain version (the record says `"kernels": "plain (meta)"`).

One JSON record per tag goes to `--out` (default experiments/dryrun_torch),
under JAX's tag scheme.  It keeps JAX's fields that have a counterpart:
the knobs, `pod_plan`, `collectives` and `census` (executed counts, so the
two agree), `argument_bytes_per_rank` (the step's inputs' local shards on
one rank, the counterpart of `argument_size_in_bytes`), and for
`--runtime async` `gather_census`, `expected_gather_bytes` and `wire`.
`trace_s` (the eager run's seconds) replaces `lower_s` / `compile_s`.
`hlo_bytes` and `cost_analysis` are dropped: there is no compiled module
to measure, and the census's matmul FLOPs are the executed counterpart of
the cost analysis's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict

import torch

from ..configs import ARCHS, INPUT_SHAPES, get_config, supported_shapes
from ..core.types import tree_leaves
from .census import Census
from .mesh import make_production_mesh, num_agents
from .shardings import distribute_tree


def fake_world(size: int) -> None:
    """A fake default process group of `size` ranks in this process (this
    process is rank 0), replacing any other fake one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
        # DTensor caches its propagation by mesh shape and names: entries of
        # the old world's meshes name groups that are gone
        from torch.distributed.tensor.debug import _clear_sharding_prop_cache

        _clear_sharding_prop_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(u.to_local().numel() * u.to_local().element_size()
               if isinstance(u, DTensor) else u.numel() * u.element_size()
               for u in tree_leaves(tree) if isinstance(u, torch.Tensor))


def _with_knobs(cfg, **knobs):
    repl = {k: v for k, v in knobs.items() if v not in (None, False)}
    return dataclasses.replace(cfg, **repl) if repl else cfg


def run_one(arch: str, shape_name: str, multi_pod: bool, algorithm: str = "fedgda_gt",
            num_local_steps: int = 4, sharding_variant: str = "baseline",
            sequence_parallel: bool = True, h_shard=None, q_block=None,
            moe_dispatch=None, participation=None, compression_ratio=None,
            quantization_bits=None, wire_transport=False, runtime="sync",
            population=None, noise=None, noise_sigma=None, momentum=None,
            pods=None, gather_only: bool = False, cfg=None) -> Dict:
    """One record.  `gather_only` traces only the async gather step of a
    train shape (not the round); `cfg` overrides the registry's config
    (the tests' cut sizes)."""
    from . import steps

    cfg = _with_knobs(cfg or get_config(arch), moe_dispatch=moe_dispatch,
                      participation=participation,
                      compression_ratio=compression_ratio,
                      quantization_bits=quantization_bits,
                      wire_transport=wire_transport, noise=noise,
                      noise_sigma=noise_sigma, momentum=momentum, pods=pods)
    if runtime != "sync":
        cfg = dataclasses.replace(cfg, runtime=runtime)
    if population:
        from ..sim.scenarios import SCENARIOS

        if population not in SCENARIOS:
            raise ValueError(f"unknown population scenario {population!r}; "
                             f"known: {sorted(SCENARIOS)}")
        cfg = dataclasses.replace(cfg, population=population)
    elastic = cfg.population != "stable"
    shape = INPUT_SHAPES[shape_name]
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    train = shape.kind == "train"
    rec: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "kind": shape.kind,
        "algorithm": algorithm if train else None,
        "num_local_steps": num_local_steps if train else None,
        **{k: (getattr(cfg, k) if train else None) for k in (
            "participation", "compression_ratio", "quantization_bits",
            "wire_transport", "runtime", "population", "noise", "noise_sigma",
            "momentum", "pods")},
        "sharding_variant": sharding_variant,
        "sequence_parallel": sequence_parallel,
        "h_shard": h_shard, "q_block_override": q_block,
        "kernels": "plain (meta)",
    }
    if train and cfg.pods:
        rec["pod_plan"] = steps.pod_aggregation_plan(cfg, mesh, cfg.pods)
    t0 = time.perf_counter()
    census = Census()
    if train and not gather_only:
        kw = dict(algorithm=algorithm, num_local_steps=num_local_steps,
                  sharding_variant=sharding_variant,
                  sequence_parallel=sequence_parallel, h_shard=h_shard,
                  q_block=q_block, use_kernel=False)
        build = steps.build_elastic_train_step if elastic else steps.build_train_step
        step_for, specs_fn = build(cfg, mesh, **kw)
        sp = specs_fn(shape)
        names = (["x", "y", "batch", "state", "tracker", "weights", "budgets",
                  "active", "prev_active"] if elastic else
                 ["x", "y", "batch"] + (["state"] if "state" in sp else []))
        args = [sp[k] for k in names]
        step = step_for(shape)
        with census:
            step(*args)
        placed = args[:3]
    elif shape.kind == "prefill":
        step_for, specs_fn = steps.build_prefill_step(
            cfg, mesh, sharding_variant=sharding_variant, use_kernel=False)
        sp = specs_fn(shape)
        args = [sp["params"], sp["batch"]] + ([sp["caches"]] if cfg.supports_decode
                                              else [])
        with census:
            step_for(shape)(*args)
        placed = args
    elif shape.kind == "decode":
        step_for, specs_fn = steps.build_decode_step(
            cfg, mesh, sharding_variant=sharding_variant, use_kernel=False)
        sp = specs_fn(shape)
        args = [sp["params"], sp["caches"], sp["tokens"], sp["position"]]
        with census:
            step_for(shape)(*args)
        placed = args[:3]
    else:
        placed = []
    rec["trace_s"] = time.perf_counter() - t0
    rec["argument_bytes_per_rank"] = _argument_bytes(cfg, mesh, shape, placed,
                                                     sharding_variant)
    rec["census"] = census.summary()
    rec["collectives"] = rec["census"]["collectives_executed"]
    if cfg.runtime == "async" and train:
        _gather_record(rec, cfg, mesh, algorithm, num_local_steps)
    return rec


def _argument_bytes(cfg, mesh, shape, placed, variant) -> int:
    """Bytes of the step's inputs on one rank, placed by the rules."""
    from .shardings import cache_pspec, param_pspec, serve_batch_sharding, \
        train_batch_shardings

    if not placed:
        return 0
    p_spec = lambda p, u: param_pspec(p, tuple(u.shape), cfg, mesh, variant)
    if shape.kind == "train":
        bsh = train_batch_shardings(cfg, mesh)
        specs = [p_spec, lambda p, u: (), lambda p, u: bsh(u.dim())]
    else:
        b_spec = lambda p, u: serve_batch_sharding(mesh, shape.global_batch, u.dim())
        c_spec = lambda p, u: cache_pspec(p, tuple(u.shape), cfg, mesh)
        specs = ([p_spec, b_spec, c_spec] if shape.kind == "prefill"
                 else [p_spec, c_spec, b_spec])
    return sum(_local_bytes(distribute_tree(t, mesh, f))
               for t, f in zip(placed, specs))


def _gather_record(rec: Dict, cfg, mesh, algorithm: str, num_local_steps: int) -> None:
    """The async runtime's packed-payload all-gather, traced and censused
    on its own: its bytes must equal the wire payload.  Only correction
    strategies at full participation gather a payload."""
    from ..fed.transport import dense_payload_bytes, measured_bytes_per_round
    from .steps import (
        _resolve_cfg_strategy,
        abstract_params,
        build_gather_decode_train_step,
        delta_struct,
    )

    strategy = _resolve_cfg_strategy(cfg, algorithm, use_kernel=False)
    if not (getattr(strategy, "use_correction", False)
            and getattr(strategy, "participation", 1.0) >= 1.0):
        return
    step, (structs,), expected = build_gather_decode_train_step(
        cfg, mesh, algorithm=algorithm)
    census = Census()
    with census:
        step(structs, use_kernel=False)
    rec["gather_census"] = census.summary()["collectives_executed"]
    rec["expected_gather_bytes"] = int(expected)
    x = abstract_params(cfg, torch.bfloat16)
    y = delta_struct(cfg, torch.bfloat16)
    meas = int(measured_bytes_per_round(strategy, x, y, num_local_steps,
                                        include_headers=False))
    dense = int(dense_payload_bytes((x, y)))
    rec["wire"] = {
        "measured_bytes_per_round": meas,
        "payload_share_per_agent": max(0, (meas - 2 * dense) // 2),
        "num_agents": num_agents(mesh, cfg.fed_mode),
    }


def combos(archs=None):
    for name, cfg in ARCHS.items():
        if archs and name not in archs:
            continue
        for shape in supported_shapes(cfg):
            yield name, shape.name


def tag_for(args, arch: str, shape: str, multi_pod: bool) -> str:
    """JAX's tag scheme."""
    tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    if args.algorithm != "fedgda_gt":
        tag += f"__{args.algorithm}"
    if args.participation is not None:
        tag += f"__p{args.participation:g}"
    if args.compression_ratio is not None:
        tag += f"__r{args.compression_ratio:g}"
    if args.quantization_bits is not None:
        tag += f"__q{args.quantization_bits:d}"
    if args.wire_transport:
        tag += "__wire"
    if args.noise and args.noise != "none":
        tag += f"__n{args.noise}"
        if args.noise_sigma is not None:
            tag += f"{args.noise_sigma:g}"
    if args.momentum is not None:
        tag += f"__m{args.momentum:g}"
    if args.runtime != "sync":
        tag += f"__{args.runtime}"
    if args.population and args.population != "stable":
        tag += f"__pop{args.population}"
    if args.pods:
        tag += f"__pods{args.pods}"
    if args.variant != "baseline":
        tag += f"__{args.variant}"
    if args.no_seq_parallel:
        tag += "__nosp"
    if args.h_shard:
        tag += f"__h{args.h_shard}"
    if args.q_block:
        tag += f"__qb{args.q_block}"
    if args.moe_dispatch:
        tag += f"__{args.moe_dispatch}"
    return tag


def parse_args(argv=None):
    from ..sim.scenarios import SCENARIOS

    ap = argparse.ArgumentParser(description="production-mesh dry-run on a "
                                 "fake world, with an executed-op census")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--algorithm", default="fedgda_gt")
    ap.add_argument("--num-local-steps", type=int, default=4)
    ap.add_argument("--participation", type=float, default=None)
    ap.add_argument("--compression-ratio", type=float, default=None)
    ap.add_argument("--quantization-bits", type=int, default=None)
    ap.add_argument("--wire-transport", action="store_true")
    ap.add_argument("--noise", default=None, choices=["none", "gaussian", "minibatch"])
    ap.add_argument("--noise-sigma", type=float, default=None)
    ap.add_argument("--momentum", type=float, default=None)
    ap.add_argument("--runtime", default="sync", choices=["sync", "async"],
                    help="async also censuses the packed-payload all-gather")
    ap.add_argument("--gather-only", action="store_true",
                    help="with --runtime async, trace the gather step alone "
                         "(not the round)")
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--population", default=None, choices=sorted(SCENARIOS))
    ap.add_argument("--variant", default="baseline", choices=["baseline", "megatron"])
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--h-shard", default=None, choices=["seq", "batch", "none"])
    ap.add_argument("--q-block", type=int, default=None)
    ap.add_argument("--moe-dispatch", default=None, choices=["einsum", "scatter"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write a run ledger (repro_torch.obs.RunLedger) under "
                         "DIR: a manifest of the resolved flags and one "
                         "'dryrun' event a tag (trace seconds, collectives, "
                         "argument bytes a rank)")
    args = ap.parse_args(argv)
    # an unset knob falls back to the strategy's active default, as JAX's
    if args.algorithm == "quantized_gt" and args.quantization_bits is None:
        args.quantization_bits = 8
    if args.algorithm == "compressed_gt" and args.compression_ratio is None:
        args.compression_ratio = 0.1
    if (args.algorithm in ("partial_gt", "partial_participation")
            and args.participation is None):
        args.participation = 0.5
    if args.algorithm == "sagda" and args.noise is None:
        args.noise = "gaussian"
    if args.algorithm == "local_sgda_plus" and args.momentum is None:
        args.momentum = 0.9
    return args


def main(argv=None) -> Dict[str, Dict]:
    """Writes one record per tag; returns them by tag."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        pairs = list(combos([args.arch] if args.arch else None))
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    ledger = None
    if args.telemetry:
        from ..obs import RunLedger, run_manifest

        ledger = RunLedger(args.telemetry)
        ledger.write_manifest(run_manifest(config=vars(args)))
    out, failures = {}, 0
    for arch, shape in pairs:
        for mp in meshes:
            tag = tag_for(args, arch, shape, mp)
            path = os.path.join(args.out, tag + ".json")
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_one(
                    arch, shape, mp, algorithm=args.algorithm,
                    num_local_steps=args.num_local_steps,
                    sharding_variant=args.variant,
                    sequence_parallel=not args.no_seq_parallel,
                    h_shard=args.h_shard, q_block=args.q_block,
                    moe_dispatch=args.moe_dispatch,
                    participation=args.participation,
                    compression_ratio=args.compression_ratio,
                    quantization_bits=args.quantization_bits,
                    wire_transport=args.wire_transport, runtime=args.runtime,
                    population=args.population, noise=args.noise,
                    noise_sigma=args.noise_sigma, momentum=args.momentum,
                    pods=args.pods, gather_only=args.gather_only)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if ledger is not None:
                    # JAX's event, its lower / compile seconds and memory
                    # analysis as the eager trace's seconds and the inputs'
                    # bytes a rank
                    ledger.write({"kind": "event", "name": "dryrun", "tag": tag,
                                  "trace_s": rec["trace_s"],
                                  "collectives": rec["collectives"],
                                  "argument_bytes_per_rank":
                                      rec["argument_bytes_per_rank"]})
                out[tag] = rec
                print(f"  ok trace={rec['trace_s']:.1f}s "
                      f"args={rec['argument_bytes_per_rank'] / 2**30:.2f}GiB "
                      f"flops={rec['census']['executed_dot_flops']:.3e} "
                      f"coll={rec['collectives']}"
                      + (f" gather={rec['gather_census']} expected="
                         f"{rec['expected_gather_bytes']}"
                         if "gather_census" in rec else ""), flush=True)
            except Exception:
                failures += 1
                print(f"  FAILED {tag}\n{traceback.format_exc()}", flush=True)
    if ledger is not None:
        ledger.close()
    if failures:
        raise SystemExit(f"{failures} dry-run failures")
    return out


if __name__ == "__main__":
    main()
