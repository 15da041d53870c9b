"""Churn robustness, the elastic-population benchmark axis (port of
`benchmarks/elastic.py`).

On the Section 5.1 quadratic game (m=10, d=30, 200 samples, JAX's data
from PRNGKey(0), the `elastic_rounds` fixture): rounds to optimality gap
<= eps and wire bytes under each population scenario (`sim.scenarios`:
stable / flaky / diurnal / straggler_heavy) for Local SGDA, FedGDA-GT with
membership-aware tracker rebasing, the naive no-rebase ablation, and the
compressed / quantized tracking variants.  Per-round bytes count the
active agents only (`sim.schedule_bytes`).  The schedules are drawn on
`--device` (default CUDA), as JAX draws them, and the rounds run there
through the port's kernels.

The headline rows: under `flaky` Markov churn FedGDA-GT with rebasing
reaches eps, the no-rebase ablation (1/m weights over the registry)
stalls orders of magnitude above it, Local SGDA stalls at its bias floor.

`--check` is the reference's gate (400 rounds of each row): a non-zero exit
if the stable-scenario elastic path needs more than 5% more rounds to eps
than the plain runner (a stable schedule is static-full, so the runner
takes its plain loop and the honest expectation is equality).

`--population mega` and `--check-pods` (the O(active) engine at 1e6
agents and its memory gate) are ROADMAP Queue 1 item 9.

    python -m repro_torch.benchmarks.elastic [--check] [--device cpu]
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..device import not_ported, resolve_device
from ..fed import resolve_strategy
from ..fixtures import (
    ELASTIC,
    ELASTIC_EPS,
    ELASTIC_ROWS,
    ELASTIC_SCENARIOS,
    elastic_run_gaps,
)
from ..sim import make_population, schedule_bytes
from .common import arg_parser, emit

DIM, _, M, K, ETA, T, SEED = ELASTIC
EPS = ELASTIC_EPS
CHECK_TOL = 0.05  # stable elastic may need at most 5% more rounds
CHECK_ROUNDS = 400


def _rounds_to_eps(gaps: np.ndarray) -> float:
    hit = np.nonzero(gaps <= EPS)[0]
    return float(hit[0]) if hit.size else math.inf


def run(rows=None, device=None, rounds: int = T):
    device = resolve_device(device)
    x0 = torch.zeros(DIM, dtype=torch.float64, device=device)
    rows = [] if rows is None else rows
    for scenario in ELASTIC_SCENARIOS:
        schedule = make_population(scenario, M).schedule(SEED, rounds, K, device)
        for row, (name, kw, rebase) in ELASTIC_ROWS.items():
            if scenario == "stable" and not rebase:
                # the ablation differs only on non-full rounds: under the
                # static-full stable schedule it is the fedgda_gt row
                continue
            gaps = elastic_run_gaps(row, schedule, device, rounds)
            r_eps = _rounds_to_eps(gaps)
            per_round = schedule_bytes(resolve_strategy(name, **kw), x0, x0, K,
                                       schedule)
            total = ("inf" if math.isinf(r_eps)
                     else int(sum(per_round[: int(r_eps) + 1])))
            rows.append({"scenario": scenario, "algorithm": row,
                         "participation": f"{schedule.participation_rate():.2f}",
                         f"rounds_to_{EPS:g}": r_eps,
                         "bytes_per_round": int(np.mean(per_round)),
                         "total_bytes_to_eps": total,
                         "final_gap": f"{gaps[-1]:.2e}"})
    emit(rows, ["scenario", "algorithm", "participation", f"rounds_to_{EPS:g}",
                "bytes_per_round", "total_bytes_to_eps", "final_gap"],
         f"rounds + active-set wire bytes to gap<={EPS:g} under population "
         f"scenarios (quadratic game, m={M}, K={K})")
    by_key = {(r["scenario"], r["algorithm"]): r for r in rows}
    flaky_gt = by_key[("flaky", "fedgda_gt")][f"rounds_to_{EPS:g}"]
    flaky_naive = by_key[("flaky", "fedgda_gt_norebase")][f"rounds_to_{EPS:g}"]
    print(f"# flaky churn: fedgda_gt(rebase) reaches eps at round {flaky_gt}; "
          "the naive no-rebase server "
          f"{'NEVER reaches it' if math.isinf(flaky_naive) else flaky_naive}")
    return rows


def check(tol: float = CHECK_TOL, device=None) -> int:
    """The gate: the stable-scenario elastic path against the plain runner
    (rounds to eps within `tol`; equal by construction).  Returns the
    number of violations (0 = the gate holds)."""
    device = resolve_device(device)
    bad = 0
    schedule = make_population("stable", M).schedule(SEED, CHECK_ROUNDS, K, device)
    for row, (_, _, rebase) in ELASTIC_ROWS.items():
        if not rebase:
            continue  # the ablation differs only on non-full rounds
        r_seed = _rounds_to_eps(elastic_run_gaps(row, None, device, CHECK_ROUNDS))
        r_elastic = _rounds_to_eps(
            elastic_run_gaps(row, schedule, device, CHECK_ROUNDS))
        if math.isinf(r_seed):
            ok = math.isinf(r_elastic)  # neither converges (local_sgda)
            drift = "n/a"
        else:
            ok = r_elastic <= r_seed * (1.0 + tol)
            drift = f"{r_elastic / r_seed - 1.0:+.2%}"
        bad += not ok
        print(f"[{'ok' if ok else 'SLOW'}] stable/{row}: seed_rounds={r_seed} "
              f"elastic_rounds={r_elastic} ({drift})")
    return bad


def main(argv=None) -> int:
    ap = arg_parser(__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="gate the stable-scenario elastic path against the "
                    f"plain runner (> {CHECK_TOL:.0%} more rounds to eps exits "
                    "non-zero); skips the scenario sweep")
    ap.add_argument("--check-pods", action="store_true",
                    help="the mega preset's memory gate (not ported)")
    ap.add_argument("--population", default=None, choices=["mega"],
                    help="the mega preset through the O(active) engine "
                    "(not ported)")
    args = ap.parse_args(argv)
    if args.check_pods or args.population == "mega":
        raise not_ported("the mega preset and its memory gate (sim.sparse's "
                         "O(active) engine)", "Queue 1 item 9")
    if args.check:
        return 1 if check(device=args.device) else 0
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
