"""End-to-end federated minimax training driver (port of
`repro/launch/train.py`).

Runs FedGDA-GT (or a baseline / scenario strategy — any
`resolve_strategy` name: local_sgda, sync_gda, partial_gt, compressed_gt,
quantized_gt, and the stochastic family sagda / local_sgda_plus with
`--noise` / `--momentum`) over one of the assigned architectures, with
synthetic heterogeneous federated data, metrics and checkpointing.  x is
the model's tree of tensors, y the universal embedding perturbation
{"delta": [d_model]} on the unit ball (`problems/adversarial.py`).  Three
routes, as JAX's driver has them:

  * `--runtime async`: `fed.AsyncFederatedRunner` (agent shards on the
    card's streams; on the CPU one shard after another);
  * `--population NAME`: `fed.FederatedRunner` under the scenario's
    seeded schedule (`--no-rebase` is the naive-membership ablation);
  * otherwise the fused `make_round` loop, with strategy state threaded
    through the rounds and into the checkpoints (`--ckpt-dir`, every 50
    rounds), and `--telemetry DIR` for the run ledger.

It runs on CUDA unless given `--device`; without a card and without
`--device cpu` it raises.  On the card the model's attention and scan run
through the `flash_attention` / `ssm_scan` kernels forward and their
backward kernels, and every local step through `gt_update`; both TF32
switches are off.  Weights come from a `torch.Generator` seeded 0 (JAX's
distributions, not its numbers); the token batches are JAX's, bit for
bit (`data.federated_token_batches` on `prng.PRNGKey(1)`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --device cpu --rounds 6 --local-steps 3 --agents 4 \
        --per-agent-batch 2 --seq-len 32 --log-every 2

`train(args, cfg)` is the loop itself, for a caller that sets the
configuration (a cut depth, say) and the loss's `remat` (JAX's driver
builds its loss with remat=False), or passes a `setup(...)` it built
itself as `run`; it returns the final iterates, the logged losses and
the rounds' wall times.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import prng
from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.engine import make_round
from ..data import federated_token_batches
from ..device import resolve_device
from ..fed.strategies import resolve_strategy
from ..models import init_params, num_params
from ..problems.adversarial import delta_projection, init_delta, make_adversarial_loss

#: rounds between checkpoints of the fused and population routes (JAX's)
CKPT_EVERY = 50


def build_parser() -> argparse.ArgumentParser:
    from ..sim.scenarios import SCENARIOS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--per-agent-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--eta", type=float, default=2e-3)
    ap.add_argument("--heterogeneity", type=int, default=7)
    ap.add_argument("--algorithm", default="fedgda_gt",
                    help="any repro_torch.fed.resolve_strategy name")
    ap.add_argument("--participation", type=float, default=None,
                    help="client fraction per round (partial_gt)")
    ap.add_argument("--compression-ratio", type=float, default=None,
                    help="kept fraction of sparsified corrections "
                         "(compressed_gt / quantized_gt)")
    ap.add_argument("--quantization-bits", type=int, default=None,
                    help="stochastic-quantization bit-width "
                         "(quantized_gt; >=32 disables)")
    ap.add_argument("--wire-transport", action="store_true",
                    help="move compressed corrections as packed "
                         "(value, index, scale) payloads "
                         "(compressed_gt / quantized_gt)")
    ap.add_argument("--noise", default=None, choices=["gaussian", "minibatch"],
                    help="stochastic-gradient noise model (sagda / "
                         "local_sgda_plus and the noise-capable GT aliases); "
                         "unset = the deterministic oracle")
    ap.add_argument("--noise-sigma", type=float, default=None,
                    help="gaussian noise scale (default 0.1)")
    ap.add_argument("--noise-fraction", type=float, default=None,
                    help="minibatch subsampling fraction (default 0.5)")
    ap.add_argument("--noise-seed", type=int, default=None,
                    help="seed of the dedicated noise stream")
    ap.add_argument("--momentum", type=float, default=None,
                    help="local heavy-ball momentum (local_sgda_plus)")
    ap.add_argument("--runtime", default="sync", choices=["sync", "async"],
                    help="sync: one round program per step; async: agent "
                         "shards (fed.async_runtime) on the card's streams")
    ap.add_argument("--population", default=None, choices=sorted(SCENARIOS),
                    help="client-population scenario (repro_torch.sim)")
    ap.add_argument("--population-seed", type=int, default=0,
                    help="seed of the availability stream")
    ap.add_argument("--no-rebase", action="store_true",
                    help="ablation: naive membership handling (expected to "
                         "stall under churn)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write a structured run ledger (events.jsonl + "
                         "manifest.json) under DIR and emit per-round spans / "
                         "wire-byte counters")
    ap.add_argument("--telemetry-probes", default="",
                    help="comma-separated invariant probes to sample")
    ap.add_argument("--telemetry-probe-every", type=int, default=1,
                    help="sample the enabled probes every N rounds")
    ap.add_argument("--profile-rounds", default="",
                    help="comma-separated round indices to wrap in a "
                         "torch.profiler trace (under DIR/profile; requires "
                         "--telemetry)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "versions)")
    return ap


def resolve(args) -> Any:
    """The strategy of `args`: only the knobs the user set (unset flags
    must not override the registry defaults)."""
    knobs = {
        "participation": args.participation,
        "compression_ratio": args.compression_ratio,
        "quantization_bits": args.quantization_bits,
        "wire_transport": args.wire_transport or None,
        "noise": args.noise,
        "noise_sigma": args.noise_sigma,
        "noise_fraction": args.noise_fraction,
        "noise_seed": args.noise_seed,
        "momentum": args.momentum,
        # a model's leaves are numbered per stacked pattern slot, as JAX's
        "layer_period": len(config_of(args).pattern),
    }
    return resolve_strategy(
        args.algorithm, **{k: v for k, v in knobs.items() if v is not None})


def config_of(args) -> ModelConfig:
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


@dataclasses.dataclass
class Setup:
    """What a run trains on: the strategy, the model's tree (x), delta
    (y), the agents' token batches and the per-agent loss."""

    cfg: ModelConfig
    device: torch.device
    strategy: Any
    params: Dict
    delta: Dict
    data: Dict
    loss: Any

    def global_loss(self, x, y) -> torch.Tensor:
        """The mean of the agents' losses at (x, y), without gradients."""
        with torch.no_grad():
            per = torch.func.vmap(self.loss, in_dims=(None, None, 0))(x, y, self.data)
        return torch.mean(per)


def setup(args, cfg: Optional[ModelConfig] = None, *, remat: bool = False) -> Setup:
    """The strategy first (a bad --algorithm fails before the model is
    built), then weights from seed 0, delta = 0 and the batches."""
    strategy = resolve(args)
    cfg = config_of(args) if cfg is None else cfg
    if cfg.frontend == "audio":
        # JAX's train.py fails here with a KeyError in embed_inputs
        raise ValueError(f"{cfg.name} has the audio frontend: it trains on "
                         "frames, and this entry point draws token batches")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         torch.float32).tree()
    data = federated_token_batches(
        prng.PRNGKey(1), args.agents, args.per_agent_batch, args.seq_len,
        cfg.vocab_size, heterogeneity=args.heterogeneity, device=device)
    return Setup(cfg, device, strategy, params, init_delta(cfg, device=device), data,
                 make_adversarial_loss(cfg, remat=remat))


def train(args, cfg: Optional[ModelConfig] = None, *, remat: bool = False,
          run: Optional[Setup] = None, start: Optional[Dict] = None,
          ckpt_every: int = CKPT_EVERY) -> Dict[str, Any]:
    """Run `args`' rounds (module docstring); returns {"params", "delta",
    "state" (the fused route's strategy state), "log": [(round, loss,
    |delta|)], "round_s": each round's wall seconds (the fused route),
    "setup"}.  `run` reuses a `setup(...)` in place of `cfg` and `remat`,
    which then must be left unset; `start` ({"x", "y", "strategy_state",
    "round"}, a checkpoint's) resumes the fused route from a saved round."""
    from .multihost import init_distributed

    if run is not None and (cfg is not None or remat):
        raise TypeError("train: give either run or (cfg, remat), not both")
    init_distributed()  # no-op unless a multi-process launch is configured
    run = setup(args, cfg, remat=remat) if run is None else run
    cfg, strategy, device = run.cfg, run.strategy, run.device
    params, delta = run.params, run.delta
    print(f"arch={cfg.name} params={num_params(params) / 1e6:.1f}M "
          f"agents={args.agents} K={args.local_steps} algo={args.algorithm} "
          f"device={device}")

    def metric_fn(x, y):
        return {"loss": run.global_loss(x, y), "delta_norm": torch.linalg.norm(y["delta"])}

    schedule = None
    rebase = not args.no_rebase
    if args.population:
        from ..sim import make_population

        pop = make_population(args.population, args.agents)
        schedule = pop.schedule(args.population_seed, args.rounds,
                                args.local_steps, device=device)
        print(f"population={args.population} seed={args.population_seed} "
              f"participation={schedule.participation_rate():.2f} "
              f"churn_events={schedule.churn_events()} rebase={rebase}")

    telemetry = ledger = None
    if args.telemetry:
        from ..obs import RunLedger, Telemetry, run_manifest

        ledger = RunLedger(args.telemetry)
        probes = tuple(p for p in args.telemetry_probes.split(",") if p)
        prof = tuple(int(r) for r in args.profile_rounds.split(",") if r)
        telemetry = Telemetry(
            ledger=ledger, probes=probes, probe_every=args.telemetry_probe_every,
            profile_dir=(os.path.join(args.telemetry, "profile") if prof else None),
            profile_rounds=prof,
        )
        ledger.write_manifest(run_manifest(
            config=vars(args), strategy=strategy, noise_seed=args.noise_seed,
            availability_seed=args.population_seed if args.population else None,
            schedule=schedule,
        ))
        print(f"telemetry: ledger at {args.telemetry}")

    out: Dict[str, Any] = {"setup": run, "log": [], "round_s": [], "state": None}
    kw = dict(proj_y=delta_projection(1.0), metric_fn=metric_fn, telemetry=telemetry)
    if args.runtime == "async":
        from ..fed import AsyncFederatedRunner

        runner = AsyncFederatedRunner(
            run.loss, strategy, run.data, args.local_steps, args.eta,
            devices=[device] if device.type == "cpu" else None, **kw)
        params, delta = runner.run(params, delta, args.rounds,
                                   log_every=args.log_every, schedule=schedule,
                                   rebase=rebase)
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, args.rounds, {"x": params, "y": delta})
        out["log"] = _runner_log(runner)
    elif schedule is not None:
        from ..fed import FederatedRunner

        runner = FederatedRunner.from_strategy(
            run.loss, strategy, run.data, args.local_steps, args.eta,
            checkpoint_dir=args.ckpt_dir,
            checkpoint_every=ckpt_every if args.ckpt_dir else 0, **kw)
        params, delta = runner.run(params, delta, args.rounds,
                                   log_every=args.log_every, schedule=schedule,
                                   rebase=rebase)
        out["log"] = _runner_log(runner)
    else:
        params, delta, out["state"] = _fused(args, run, params, delta, telemetry,
                                             out, start, ckpt_every)
    if ledger is not None:
        ledger.close()
    out.update(params=params, delta=delta)
    print("done.")
    return out


def _runner_log(runner) -> List[tuple]:
    return [(s.round_index, s.metrics.get("loss"), s.metrics.get("delta_norm"))
            for s in getattr(runner, "history", [])]


def _fused(args, run: Setup, params, delta, telemetry, out, start, ckpt_every):
    """The fused `make_round` loop of the sync route."""
    strategy, device = run.strategy, run.device
    stateful = strategy.stateful
    rnd = make_round(run.loss, strategy, args.local_steps, args.eta,
                     proj_y=delta_projection(1.0), explicit_state=stateful)
    t_start, state = 0, None
    if start is not None:
        params, delta = start["x"], start["y"]
        state, t_start = start.get("strategy_state"), int(start["round"])
    if stateful and state is None:
        state = strategy.init_state(params, delta, args.agents)
    per_agent = None
    if telemetry is not None:
        from ..fed.transport import measured_bytes_per_round

        per_agent = int(measured_bytes_per_round(strategy, params, delta,
                                                 args.local_steps))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.time()
    for t in range(t_start, args.rounds):
        sync()
        rt0 = time.perf_counter()
        if telemetry is not None:
            telemetry.begin_round(t)
        if stateful:
            params, delta, state = rnd(params, delta, run.data, state)
        else:
            params, delta = rnd(params, delta, run.data)
        sync()
        seconds = time.perf_counter() - rt0
        out["round_s"].append(seconds)
        if telemetry is not None:
            telemetry.round_event(t, runtime="fused", seconds=seconds)
            telemetry.counter("wire_bytes", per_agent * args.agents,
                              per_agent=per_agent, n_active=args.agents)
            telemetry.end_round(t)
        if t % args.log_every == 0 or t == args.rounds - 1:
            lv = float(run.global_loss(params, delta))
            dn = float(torch.linalg.norm(delta["delta"]))
            out["log"].append((t, lv, dn))
            print(f"[round {t:4d}] loss={lv:.4f} |delta|={dn:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (t + 1) % ckpt_every == 0:
            payload = {"x": params, "y": delta}
            if state is not None:
                # resuming without this replays RNG draws / zeroes the
                # error-feedback buffers
                payload["strategy_state"] = state
            save_checkpoint(args.ckpt_dir, t + 1, payload)
    return params, delta, state


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
