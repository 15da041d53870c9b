"""Serving entry point (port of `repro/launch/serve.py`): prefill a batch of
prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --reduced --device cpu --batch 2 --prompt-len 32 --decode-tokens 8

It runs on CUDA unless given `--device`; without a card and without
`--device cpu` it raises.  Weights and prompts are random, from `--seed`
(weights) and `--seed + 1` (prompts), as JAX's entry point draws them from
PRNGKey(0) and PRNGKey(1).  `--decode-tokens n` generates n tokens per
sequence: the first from the prefill's logits, the rest from n - 1 decode
steps at positions prompt_len + i, over caches of capacity
prompt_len + n.  On the card, prefill runs through the `flash_attention`
and `ssm_scan` kernels and decode stays plain; both TF32 switches are set
off, so the f32 products and the convolution run in full f32.

A vision_text model (pixtral-12b) prefills its whole `random_batch`:
`--prompt-len` positions, the `num_patches` projected patches first and
the text tokens after them, as JAX's entry point prefills its batch;
decode steps take tokens only.  An encoder-only model (hubert-xlarge) has
no decode path and is refused, as JAX refuses it.

`main()` returns what it measured (see `generate`), with the parameters
and the batch, so that a caller can rerun the same tokens through the
plain versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels import flash_attention, ssm_scan
from ..models import (
    embed_inputs,
    forward,
    init_caches,
    init_params,
    logits_from_hidden,
    num_params,
    random_batch,
)

#: the kernels of the serving path, whose launches `generate` reports
KERNELS = {"flash_attention": flash_attention, "ssm_scan": ssm_scan}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


def prompt_length(prompts: Dict) -> int:
    """Positions a prefill of the prompt batch `prompts` ({"tokens": [B,
    St]}, + "patches" [B, P, frontend_dim] for vision_text) fills: its
    tokens, and before them its patches."""
    n = prompts["tokens"].shape[1]
    return n + (prompts["patches"].shape[1] if "patches" in prompts else 0)


def prefill(params, cfg, prompts: Dict, caches: Dict, *, use_kernel: bool = True):
    """Logits of the last prompt position [B, 1, V] and the filled caches
    of the prompt batch `prompts` (see `prompt_length`)."""
    h = embed_inputs(params, cfg, prompts)
    h, caches, _ = forward(params, cfg, h, caches=caches, use_kernel=use_kernel)
    return logits_from_hidden(params, cfg, h[:, -1:]), caches


def decode(params, cfg, caches: Dict, tok: torch.Tensor, pos: int, *,
           use_kernel: bool = True):
    """Logits [B, 1, V] of one token per sequence at position `pos`."""
    h = embed_inputs(params, cfg, {"tokens": tok})
    h, caches, _ = forward(params, cfg, h, caches=caches, position=pos,
                           use_kernel=use_kernel)
    return logits_from_hidden(params, cfg, h), caches


def generate(params, cfg, prompts: Dict, caches: Dict,
             decode_tokens: int, *, use_kernel: bool = True,
             forced: Optional[torch.Tensor] = None) -> Dict:
    """Prefill the prompt batch `prompts` (filling S = `prompt_length`
    positions) into empty `caches`, then greedy decode at positions S + i
    (`forced` [B, decode_tokens] feeds those tokens instead: teacher
    forcing).  Returns the tokens [B, decode_tokens], the logits that
    chose each [B, decode_tokens, V], the host times of the prefill and of
    the decode loop (each ending in a device synchronize), and the kernel
    launches of each."""
    tokens = prompts["tokens"]
    sync = torch.cuda.synchronize if tokens.device.type == "cuda" else (lambda: None)
    B, S = tokens.shape[0], prompt_length(prompts)
    with torch.inference_mode():
        sync()
        before = launch_counts()
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, prompts, caches, use_kernel=use_kernel)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_launches = _since(before)

        steps: List[torch.Tensor] = [logits[:, -1]]
        pick = lambda i, lg: (forced[:, i:i + 1] if forced is not None
                              else torch.argmax(lg[:, -1], dim=-1)[:, None])
        tok = pick(0, logits)
        toks = [tok]
        before = launch_counts()
        t0 = time.perf_counter()
        for i in range(decode_tokens - 1):
            logits, caches = decode(params, cfg, caches, tok, S + i,
                                    use_kernel=use_kernel)
            steps.append(logits[:, -1])
            tok = pick(i + 1, logits)
            toks.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
        decode_launches = _since(before)
    n_steps = decode_tokens - 1
    return {
        "tokens": torch.cat(toks, dim=1),
        "step_logits": torch.stack(steps, dim=1),
        "prefill_ms": prefill_s * 1e3,
        "decode_steps": n_steps,
        "decode_ms_per_step": decode_s / n_steps * 1e3 if n_steps else None,
        "decode_tokens_per_s": B * n_steps / decode_s if n_steps else None,
        "launches": {"prefill": prefill_launches, "decode": decode_launches},
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted so that repro.launch.serve's command lines "
                         "run unchanged; only 0 (greedy) is served")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    if args.temperature != 0.0:
        raise SystemExit("only greedy decoding (--temperature 0) is served; "
                         "repro.launch.serve decodes greedily at any temperature")
    if args.decode_tokens < 1:
        raise SystemExit("--decode-tokens must be >= 1")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)

    with torch.inference_mode():
        params = init_params(torch.Generator(device=device).manual_seed(args.seed),
                             cfg, torch.float32)
        batch = random_batch(torch.Generator(device=device).manual_seed(args.seed + 1),
                             cfg, args.batch, args.prompt_len)
        caches = init_caches(cfg, args.batch, args.prompt_len + args.decode_tokens,
                             torch.float32, device)
    prompts = {k: v for k, v in batch.items() if k != "labels"}
    out = generate(params, cfg, prompts, caches, args.decode_tokens)
    del caches
    out.update(
        cfg=cfg, params=params, prompts=prompts, device=str(device),
        num_params=num_params(params),
        peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
    )
    print(f"prefill [{args.batch}x{args.prompt_len}] {out['prefill_ms']:.1f} ms")
    if out["decode_steps"]:
        print(f"decoded {args.decode_tokens} tokens/seq ({out['decode_steps']} "
              f"steps) at {out['decode_ms_per_step']:.2f} ms/step "
              f"({out['decode_tokens_per_s']:.1f} tok/s)")
    print("sample:", out["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main()
