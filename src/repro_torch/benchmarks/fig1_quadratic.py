"""Paper Figure 1 — uncoupled quadratic game (Eq. 13), port of
`benchmarks/fig1_quadratic.py`.

d=50, n_i=500, m=20 agents, eta=1e-4 (the paper's own setup) on the JAX
builder's data from PRNGKey(0) (the `sec51` fixture); Local SGDA vs
FedGDA-GT at K in {20, 50}, centralized GDA (K=1) baseline.  Reports the
optimality gap ||x-x*||^2 + ||y-y*||^2 after T rounds and the number of
rounds to reach gap <= 1e-6 (inf if the bias floor is above it).

    python -m repro_torch.benchmarks.fig1_quadratic [--device cpu]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import (
    make_fedgda_gt_round,
    make_local_sgda_round,
    run_rounds,
    tree_sq_dist,
)
from ..fixtures import fixture_problem
from .common import arg_parser, emit

ETA = 1e-4
T = 3000


def rounds_to(gaps: np.ndarray, eps: float) -> float:
    hit = np.nonzero(gaps <= eps)[0]
    return float(hit[0]) if hit.size else math.inf


def run(rows=None, device=None, rounds: int = T):
    prob, xs, ys = fixture_problem("sec51", device)

    def metric(x, y):
        return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

    x0 = torch.zeros_like(xs)
    algos = [("gda(K=1)", make_local_sgda_round(prob.loss, 1, ETA, ETA))]
    for K in (20, 50):
        algos.append(
            (f"local_sgda(K={K})", make_local_sgda_round(prob.loss, K, ETA, ETA))
        )
        algos.append((f"fedgda_gt(K={K})", make_fedgda_gt_round(prob.loss, K, ETA)))

    rows = [] if rows is None else rows
    for name, rnd in algos:
        (_, _), m = run_rounds(rnd, x0, x0, prob.agent_data, rounds, metric)
        gaps = m["gap"].cpu().numpy()
        rows.append(
            {
                "algorithm": name,
                "final_gap": f"{gaps[-1]:.3e}",
                "rounds_to_1e-6": rounds_to(gaps, 1e-6),
                "rounds_to_1e-10": rounds_to(gaps, 1e-10),
            }
        )
    emit(
        rows,
        ["algorithm", "final_gap", "rounds_to_1e-6", "rounds_to_1e-10"],
        "fig1: uncoupled quadratic game (d=50, m=20, eta=1e-4)",
    )
    return rows


if __name__ == "__main__":
    run(device=arg_parser(__doc__.splitlines()[0]).parse_args().device)
