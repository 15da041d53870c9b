"""End-to-end driver: federated adversarial training of a language model
with FedGDA-GT (port of `examples/train_federated_lm.py`).

x = transformer parameters, y = universal adversarial embedding
perturbation with ||y|| <= 1 (the paper's Eq.-14 robustness structure
lifted to sequence models).  Heterogeneous agents hold synthetic token
streams with shifted vocabularies (JAX's draws, bit for bit).

Defaults train a ~25M-parameter granite-family model for 60 rounds;
`--full` switches to the ~100M model / 300 rounds configuration.  It
runs on the card unless given `--device cpu`.  Weights come from a
`torch.Generator` seeded 0 (`init_model`): JAX's distributions, not its
numbers.  `--ckpt-dir` checkpoints every 50 rounds and resumes from the
latest checkpoint there (JAX's example writes under /tmp by default;
this one checkpoints only when asked).

    PYTHONPATH=src python -m repro_torch.examples.train_federated_lm \
        [--device cpu] [--rounds 60] [--full] [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from .. import prng
from ..checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..core import communication_bytes_per_round, make_fedgda_gt_round
from ..data import federated_token_batches
from ..device import resolve_device
from ..models import init_params, num_params
from ..problems.adversarial import delta_projection, init_delta, make_adversarial_loss


def model_config(full: bool):
    base = get_config("granite-8b")  # llama-family block structure
    if full:  # ~100M params
        return dataclasses.replace(
            base, name="granite-100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32768, q_block=512,
        )
    return dataclasses.replace(  # ~25M params
        base, name="granite-25m", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=16384, q_block=256,
    )


def init_model(cfg, device) -> Dict:
    """The model's tree of tensors, random from seed 0."""
    return init_params(torch.Generator(device=device).manual_seed(0), cfg,
                       torch.float32).tree()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the example; returns {"cfg", "log": [(round, global loss,
    |delta|)], "params", "delta"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-agent batch")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--eta", type=float, default=5e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    rounds = args.rounds or (300 if args.full else 60)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = model_config(args.full)
    params = init_model(cfg, device)
    delta = init_delta(cfg, device=device)
    print(f"model={cfg.name} params={num_params(params) / 1e6:.1f}M "
          f"agents={args.agents} K={args.local_steps} rounds={rounds}")
    mib = communication_bytes_per_round(params, delta, "fedgda_gt",
                                        args.local_steps) / 2**20
    print(f"bytes/round (star-topology model): {mib:.1f} MiB")

    data = federated_token_batches(
        prng.PRNGKey(1), args.agents, args.batch, args.seq_len, cfg.vocab_size,
        heterogeneity=cfg.vocab_size // (2 * args.agents), device=device)
    loss = make_adversarial_loss(cfg, remat=False)
    rnd = make_fedgda_gt_round(loss, args.local_steps, args.eta,
                               proj_y=delta_projection(1.0))

    def global_loss(x, y):
        with torch.no_grad():
            per = torch.func.vmap(loss, in_dims=(None, None, 0))(x, y, data)
        return torch.mean(per)

    start = 0
    found = latest_checkpoint(args.ckpt_dir) if args.ckpt_dir else None
    if found:
        start, path = found
        state = restore_checkpoint(path, device)
        params, delta = state["x"], state["y"]
        print(f"resumed from round {start}")

    log = []
    t0 = time.time()
    for t in range(start, rounds):
        params, delta = rnd(params, delta, data)
        if t % 10 == 0 or t == rounds - 1:
            lv = float(global_loss(params, delta))
            dn = float(torch.linalg.norm(delta["delta"]))
            log.append((t, lv, dn))
            print(f"[round {t:4d}] global_loss={lv:.4f} |delta|={dn:.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if args.ckpt_dir and (t + 1) % 50 == 0:
            save_checkpoint(args.ckpt_dir, t + 1, {"x": params, "y": delta})
    print("done — adversarially-robust LM trained with 2 model-sized")
    print("messages per round instead of K (Theorem 1's schedule).")
    return {"cfg": cfg, "log": log, "params": params, "delta": delta}


if __name__ == "__main__":
    main()
