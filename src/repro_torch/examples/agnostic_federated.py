"""Agnostic Federated Learning (paper Appendix A.2, Mohri et al.) with
FedGDA-GT: learn a model that is minimax-fair over agent distributions
(port of `examples/agnostic_federated.py`).

x = regression model, y = mixture weights lambda on the simplex; the
adversary shifts weight onto the worst-served agents, and the saddle point
equalizes their risks.  The data is the port's own draw (a CPU
`torch.Generator` seeded 0), so the numbers are not the reference
example's; the signal is: the agnostic model's worst-agent risk and risk
spread are below the uniform model's.

    PYTHONPATH=src python -m repro_torch.examples.agnostic_federated
        [--device cpu] [--rounds 1500]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from ..core import make_fedgda_gt_round
from ..device import resolve_device
from ..problems import make_agnostic_problem, per_agent_risks, uniform_lambda

M, DIM = 5, 8


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """Run the example; returns the per-agent risks of both models and the
    agnostic lambda (on the host)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    ap.add_argument("--rounds", type=int, default=1500)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prob = make_agnostic_problem(torch.Generator().manual_seed(0), dim=DIM,
                                 num_samples=80, num_agents=M, shift=4.0, device=dev)
    uniform = uniform_lambda(M, device=dev)
    rnd = make_fedgda_gt_round(prob.loss, 5, 2e-3, proj_y=prob.proj_y)
    frozen = make_fedgda_gt_round(prob.loss, 5, 2e-3, proj_y=lambda y: uniform)
    x0, y0 = torch.zeros(DIM, dtype=torch.float64, device=dev), uniform
    xa, ya = x0, y0
    xu, yu = x0, y0
    for _ in range(args.rounds):
        xa, ya = rnd(xa, ya, prob.agent_data)
        xu, yu = frozen(xu, yu, prob.agent_data)
    ra = per_agent_risks(prob, xa).cpu()
    ru = per_agent_risks(prob, xu).cpu()
    lam = ya.cpu()
    print(f"rounds={args.rounds}  device={dev}")
    print("agents have CONFLICTING true models (disagreement grows with i)\n")
    print(f"{'agent':>6} {'uniform-FL risk':>16} {'agnostic risk':>14} {'lambda*':>9}")
    for i in range(M):
        print(f"{i:6d} {float(ru[i]):16.4f} {float(ra[i]):14.4f} {float(lam[i]):9.4f}")
    print(f"\nworst-agent risk:  uniform={float(ru.max()):.4f}  "
          f"agnostic={float(ra.max()):.4f}")
    print(f"risk spread:       uniform={float(ru.max() - ru.min()):.4f}  "
          f"agnostic={float(ra.max() - ra.min()):.4f}")
    print("\nthe agnostic model trades mean risk for worst-case fairness,")
    print("solved by the SAME FedGDA-GT round as every other problem here.")
    return {"uniform_risks": ru, "agnostic_risks": ra, "lambda": lam}


if __name__ == "__main__":
    main()
