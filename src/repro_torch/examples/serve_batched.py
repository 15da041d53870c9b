"""Serving path: batched prefill + autoregressive decode with a KV cache,
through the SPMD step builders (port of `examples/serve_batched.py`).

It serves through the same `build_prefill_step` / `build_decode_step` the
dry-run traces on the production mesh, here run on a one-rank host mesh
(`make_host_mesh(1, 1)`: NCCL on the card, gloo with `--device cpu`), so
one set of step builders serves both the dry-run and a real runtime.  The
parameters become DTensors placed by the rules without a copy
(`DTensor.from_local`), and the kernels run on their local shards.
Weights come from a `torch.Generator` seeded 0 and the prompts from one
seeded 1: JAX's distributions, not its numbers.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch gemma2-2b] [--reduced] [--device cpu] [--batch 4] \\
        [--prompt-len 64] [--new-tokens 32]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from ..configs import ShapeConfig, get_config
from ..device import resolve_device
from ..launch.mesh import make_host_mesh
from ..launch.serve import _since, launch_counts
from ..launch.shardings import param_pspec, placements, tree_map_with_path
from ..launch.steps import build_decode_step, build_prefill_step
from ..models import init_caches, init_params, num_params, random_batch


def place_params(params: Dict, cfg, mesh) -> Dict:
    """The parameter tree as DTensors placed by the rules, wrapping each
    tensor as this rank's shard (`DTensor.from_local`, no copy): on a
    one-rank mesh every shard is the whole tensor."""
    from torch.distributed.tensor import DTensor

    return tree_map_with_path(
        lambda p, u: DTensor.from_local(
            u, mesh, placements(param_pspec(p, tuple(u.shape), cfg, mesh), mesh),
            run_check=False), params)


def serve(cfg, mesh, params: Dict, prompts: Dict, decode_tokens: int, *,
          forced: Optional[torch.Tensor] = None) -> Dict:
    """Prefill `prompts` ({"tokens": [B, S]}) into fresh f32 caches of
    capacity S + decode_tokens, then greedy decode (`forced` [B,
    decode_tokens]: teacher forcing) through the step builders on `mesh`,
    with the kernels.  `params` are placed DTensors (`place_params`).
    Returns the tokens, the logits that chose each [B, decode_tokens, V]
    (plain tensors), the prefill's and the decode loop's host ms (each
    ending in a device synchronize) and the kernel launches of each."""
    tokens = prompts["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    capacity = S + decode_tokens
    prefill_for, _ = build_prefill_step(cfg, mesh, dtype=torch.float32)
    decode_for, _ = build_decode_step(cfg, mesh, dtype=torch.float32)
    prefill = prefill_for(ShapeConfig("serve_prefill", S, B, "prefill"))
    step = decode_for(ShapeConfig("serve_decode", capacity, B, "decode"))
    caches = init_caches(cfg, B, capacity, torch.float32, dev)
    # no_grad, not inference_mode: DTensor's dispatch sets version counters
    with torch.no_grad():
        sync()
        before = launch_counts()
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompts, caches)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = _since(before)
        pick = lambda i, lg: (forced[:, i:i + 1] if forced is not None else
                              torch.argmax(lg[:, -1], dim=-1)[:, None])
        logits = logits.full_tensor()
        steps, toks = [logits[:, -1]], [pick(0, logits)]
        before = launch_counts()
        t0 = time.perf_counter()
        for i in range(decode_tokens - 1):
            logits, caches = step(params, caches, toks[-1], S + i)
            logits = logits.full_tensor()
            steps.append(logits[:, -1])
            toks.append(pick(i + 1, logits))
        sync()
        decode_s = time.perf_counter() - t0
    n = decode_tokens - 1
    return {
        "tokens": torch.cat(toks, dim=1),
        "step_logits": torch.stack(steps, dim=1),
        "prefill_ms": prefill_ms,
        "decode_steps": n,
        "decode_ms_per_step": decode_s / n * 1e3 if n else None,
        "launches": {"prefill": prefill_launches, "decode": _since(before)},
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the example; returns `serve`'s dict plus "cfg"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced (CPU-sized) variant")
    ap.add_argument("--batch", type=int, default=4, help="requests in flight")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    if not cfg.supports_decode or cfg.frontend != "text":
        raise SystemExit(f"{args.arch}: this example serves text decoders")
    mesh = make_host_mesh(1, 1, device=device)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         torch.float32).tree()
    print(f"arch={cfg.name} params={num_params(params) / 1e6:.1f}M "
          f"batch={args.batch} prompt={args.prompt_len} new={args.new_tokens}")
    prompts = {"tokens": random_batch(torch.Generator(device=device).manual_seed(1),
                                      cfg, args.batch, args.prompt_len)["tokens"]}
    out = serve(cfg, mesh, place_params(params, cfg, mesh), prompts,
                args.new_tokens)
    print(f"prefill: {out['prefill_ms']:.0f} ms logits="
          f"{tuple(out['step_logits'][:, :1].shape)}")
    print(f"decode: {out['decode_steps']} steps x {args.batch} requests "
          f"({out['decode_ms_per_step']:.1f} ms/token)")
    print("generated token ids (request 0):", out["tokens"][0, :16].tolist(), "...")
    out["cfg"] = cfg
    return out


if __name__ == "__main__":
    main()
