"""Paper Section 5.2: robust linear regression under gross contamination
(port of `examples/robust_regression.py`).

Figure 2's comparison: FedGDA-GT against Local SGDA at three
heterogeneity levels alpha in {1, 5, 20}, printing robust-loss
trajectories and each method's distance from the centralized
projected-GDA solution with the same step budget.  The data is the port's
own draw (a CPU `torch.Generator` seeded 0); the signal is the
reference's: FedGDA-GT lands far closer to the centralized solution than
Local SGDA at every alpha.

    PYTHONPATH=src python -m repro_torch.examples.robust_regression
        [--device cpu] [--rounds 400]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from ..core import make_fedgda_gt_round, make_local_sgda_round
from ..device import resolve_device
from ..problems import make_robust_regression_problem, robust_loss

DIM, N, M, K = 20, 100, 10, 10
ALPHAS = (1.0, 5.0, 20.0)


def stable_eta(prob) -> float:
    a = prob.agent_data["a"]
    H = 2 * torch.einsum("mnd,mne->de", a, a) / (a.shape[0] * a.shape[1])
    eye = torch.eye(DIM, dtype=a.dtype, device=a.device)
    return 0.1 / float(torch.linalg.eigvalsh(H + eye)[-1])


def main(argv: Optional[Sequence[str]] = None) -> Dict[float, Dict[str, float]]:
    """Run the example; returns, per alpha, each method's distance to the
    centralized solution and its last robust loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    ap.add_argument("--rounds", type=int, default=400)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    T = args.rounds
    shown = sorted({0, T // 4, T // 2, 3 * T // 4, T})
    out = {}
    for alpha in ALPHAS:
        prob = make_robust_regression_problem(
            torch.Generator().manual_seed(0), dim=DIM, num_samples=N, num_agents=M,
            alpha=alpha, device=dev)
        eta = stable_eta(prob)
        r_gt = make_fedgda_gt_round(prob.loss, K, eta, proj_y=prob.proj_y)
        r_ls = make_local_sgda_round(prob.loss, K, eta, eta, proj_y=prob.proj_y)
        z = torch.zeros(DIM, dtype=torch.float64, device=dev)
        xg, yg, xl, yl = z, z, z, z
        print(f"\n== alpha={alpha} (eta={eta:.2e}, device={dev}) ==")
        print(f"{'round':>6} {'robust_loss GT':>16} {'robust_loss LS':>16}")
        for t in range(T + 1):
            if t in shown:
                lg = float(robust_loss(prob, xg))
                ll = float(robust_loss(prob, xl))
                print(f"{t:6d} {lg:16.4f} {ll:16.4f}")
            if t < T:
                xg, yg = r_gt(xg, yg, prob.agent_data)
                xl, yl = r_ls(xl, yl, prob.agent_data)
        # reference: centralized projected GDA with the same step budget
        r_c = make_local_sgda_round(prob.loss, 1, eta, eta, proj_y=prob.proj_y)
        xc, yc = z, z
        for _ in range(T * K):
            xc, yc = r_c(xc, yc, prob.agent_data)
        dg = float(torch.linalg.norm(xg - xc))
        dl = float(torch.linalg.norm(xl - xc))
        print(f"   dist to centralized solution: GT={dg:.2e}  LS={dl:.2e}")
        out[alpha] = {"dist_gt": dg, "dist_ls": dl, "robust_loss_gt": lg,
                      "robust_loss_ls": ll}
    return out


if __name__ == "__main__":
    main()
