"""Paper Figure 3 / Appendix C — Local SGDA's constant-stepsize fixed-point
bias as a function of the number of local steps K (port of
`benchmarks/fig3_fixed_point.py`).

For each K: the closed-form fixed point (Proposition 1 algebra), the
empirically converged iterate, the Prop-1 residual at both the fixed point
(must be ~0) and the true minimax point (must be > 0 for K >= 2).

    python -m repro_torch.benchmarks.fig3_fixed_point [--device cpu] [--k K ...]

`--k` (repeatable) runs only those rows, so the K's can run as separate
processes side by side.
"""
from __future__ import annotations

import torch

from ..core import (
    APPENDIX_C_MINIMAX_POINT,
    appendix_c_fixed_point,
    make_local_sgda_round,
    prop1_residual,
    run_rounds,
)
from ..problems import make_appendix_c_problem
from .common import arg_parser, emit

T = 30_000
KS = (1, 10, 20, 50)


def run(rows=None, device=None, rounds: int = T, ks=KS):
    prob = make_appendix_c_problem(device=device)
    dev = prob.agent_data["a"].device
    xm = APPENDIX_C_MINIMAX_POINT[0]
    rows = [] if rows is None else rows
    for K in ks:
        eta = 0.1 if K == 1 else 0.001  # the paper's own stepsizes
        rnd = make_local_sgda_round(prob.loss, K, eta, eta)
        x0 = torch.tensor(0.0, dtype=torch.float64, device=dev)
        (x, y), _ = run_rounds(rnd, x0, x0, prob.agent_data, rounds)
        fx, _ = appendix_c_fixed_point(K, eta, eta)
        r_fp = float(
            prop1_residual(prob.loss, x, y, prob.agent_data, K, eta, eta)
        )
        xmt = torch.tensor(xm, dtype=torch.float64, device=dev)
        r_mm = float(
            prop1_residual(prob.loss, xmt, xmt, prob.agent_data, K, eta, eta)
        )
        rows.append(
            {
                "K": K,
                "eta": eta,
                "x_empirical": f"{float(x):.8f}",
                "x_closed_form": f"{fx:.8f}",
                "bias_|x-3.3|": f"{abs(float(x) - xm):.3e}",
                "prop1_residual_at_fp": f"{r_fp:.2e}",
                "prop1_residual_at_minimax": f"{r_mm:.2e}",
            }
        )
    emit(
        rows,
        [
            "K",
            "eta",
            "x_empirical",
            "x_closed_form",
            "bias_|x-3.3|",
            "prop1_residual_at_fp",
            "prop1_residual_at_minimax",
        ],
        "fig3/appendix-C: Local SGDA fixed-point bias vs K",
    )
    return rows


if __name__ == "__main__":
    parser = arg_parser(__doc__.splitlines()[0])
    parser.add_argument("--k", type=int, action="append",
                        help="a K of the table (repeatable; default all of KS)")
    args = parser.parse_args()
    run(device=args.device, ks=tuple(args.k) if args.k else KS)
