"""Paper Figure 2 — robust linear regression (Eq. 14) under heterogeneity
alpha in {1, 5, 20} (port of `benchmarks/fig2_robust_regression.py`).

Reports the final robust loss max_{||y||<=1} sum_i f_i(x, y) for Local SGDA
and FedGDA-GT with the same constant stepsize, plus the distance of each
solution from the centralized projected-GDA reference (the paper's notion of
the correct solution; see tests/test_paper_claims.py for why the distance is
the seed-robust criterion).  Each run is a `FederatedRunner` over the JAX
builder's data from PRNGKey(0) (the `robust<alpha>` fixtures).

    python -m repro_torch.benchmarks.fig2_robust_regression [--device cpu]
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..core import make_fedgda_gt_round, make_local_sgda_round
from ..fed import FederatedRunner
from ..fixtures import ROBUST, fixture_problem, robust_key
from ..problems import robust_loss
from .common import arg_parser, emit

DIM, N, M, K = ROBUST[:4]
T = ROBUST[4]
ALPHAS = (1.0, 5.0, 20.0)
HEADER = [
    "alpha",
    "eta",
    "robust_loss_fedgda_gt",
    "robust_loss_local_sgda",
    "robust_loss_centralized",
    "dist_gt_to_centralized",
    "dist_ls_to_centralized",
]


def _stable_eta(prob) -> float:
    a = prob.agent_data["a"]
    H = 2 * torch.einsum("mnd,mne->de", a, a) / (a.shape[0] * a.shape[1])
    eye = torch.eye(DIM, dtype=a.dtype, device=a.device)
    L = float(torch.linalg.eigvalsh(H + eye)[-1])
    return 0.1 / L


def _drive(runner: FederatedRunner, dim: int, rounds: int,
           every: Optional[int], device) -> Dict:
    """Run `rounds` from x0 = y0 = 0; with `every`, keep x at rounds 0,
    every, 2*every, ... (stacked, on the device)."""
    x = y = torch.zeros(dim, dtype=torch.float64, device=device)
    if every is None:
        x, y = runner.run(x, y, rounds)
        return {"x": x, "y": y}
    snaps = [x]
    for _ in range(rounds // every):
        x, y = runner.run(x, y, every)
        snaps.append(x)
    return {"x": x, "y": y, "snapshots": torch.stack(snaps)}


def solve(alpha: float, device=None, rounds: int = T,
          every: Optional[int] = None) -> Dict:
    """FedGDA-GT and Local SGDA (K local steps, `rounds` rounds) and
    centralized projected GDA (K=1, rounds * K) on the alpha problem, each
    through a `FederatedRunner`: {"eta", "gt" | "ls" | "c": {"x", "y"
    [, "snapshots"], "robust_loss", "run_s", "robust_loss_s"}} (host
    seconds of the run and of the robust loss, each ending in a sync)."""
    prob = fixture_problem(robust_key(alpha), device)[0]
    dev = prob.agent_data["a"].device
    eta = _stable_eta(prob)
    runs = {
        "gt": (make_fedgda_gt_round(prob.loss, K, eta, proj_y=prob.proj_y),
               rounds),
        "ls": (make_local_sgda_round(prob.loss, K, eta, eta,
                                     proj_y=prob.proj_y), rounds),
        "c": (make_local_sgda_round(prob.loss, 1, eta, eta,
                                    proj_y=prob.proj_y), rounds * K),
    }
    out: Dict = {"eta": eta}
    for name, (rnd, n) in runs.items():
        t0 = time.perf_counter()
        res = _drive(FederatedRunner(rnd, prob.agent_data), DIM, n, every, dev)
        float(res["x"].sum())  # waits for the device
        t1 = time.perf_counter()
        res["robust_loss"] = float(robust_loss(prob, res["x"]))
        res.update(run_s=t1 - t0, robust_loss_s=time.perf_counter() - t1)
        out[name] = res
    return out


def row(alpha: float, res: Dict) -> Dict:
    xg, xl, xc = (res[k]["x"] for k in ("gt", "ls", "c"))
    return {
        "alpha": alpha,
        "eta": f"{res['eta']:.2e}",
        "robust_loss_fedgda_gt": f"{res['gt']['robust_loss']:.4f}",
        "robust_loss_local_sgda": f"{res['ls']['robust_loss']:.4f}",
        "robust_loss_centralized": f"{res['c']['robust_loss']:.4f}",
        "dist_gt_to_centralized": f"{float(torch.linalg.norm(xg - xc)):.3e}",
        "dist_ls_to_centralized": f"{float(torch.linalg.norm(xl - xc)):.3e}",
    }


def run(rows=None, device=None, rounds: int = T):
    rows = [] if rows is None else rows
    for alpha in ALPHAS:
        rows.append(row(alpha, solve(alpha, device, rounds)))
    emit(rows, HEADER, "fig2: robust linear regression under heterogeneity")
    return rows


if __name__ == "__main__":
    run(device=arg_parser(__doc__.splitlines()[0]).parse_args().device)
