"""Section 4: the generalization bound against the measured
generalization gap (port of `benchmarks/generalization.py`).

The first table: a finite threshold-classifier class over heterogeneous
per-agent Gaussians; as the per-agent sample size n grows, the Theorem-2
bound and the measured sup_x |R - f| decay ~ 1/sqrt(n), the bound above
the measurement, next to the Lemma-3 VC upper bound on the Rademacher
complexity and its Monte-Carlo estimate.  The Gaussians are the port's
`prng.normal` draws from the reference's keys (JAX's to a few ulp), the
Rademacher signs JAX's bit for bit.

The second table: the MEASURED generalization gap of trained iterates
for the stochastic family, strategy x noise x Dirichlet heterogeneity on
the held-out-split quadratic game, on the two problems the reference
draws from PRNGKey(7) (`fixtures.dirichlet_problem`): rounds to eps
against the closed-form minimax point, the final distance and the final
train/test risk gap.  `--check` gates the claims the table makes
(noiseless SAGDA converges linearly at both heterogeneity levels, plain
Local SGDA stalls at its drift floor under strong heterogeneity, every
gap stays bounded).

    python -m repro_torch.benchmarks.generalization [--check] [--device cpu]
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import prng
from ..core import (
    empirical_rademacher,
    generalization_gap,
    lemma3_vc_bound,
    theorem2_bound,
)
from ..device import resolve_device
from .common import arg_parser, emit

M_AGENTS, C = 6, 64
DELTA = 0.05


def _loss_matrix(key, m, n, num_candidates, device):
    kd, _ = prng.split(key)
    shifts = 0.3 * torch.arange(m, dtype=torch.float64, device=device)
    xi = prng.normal(kd, (m, n), torch.float64, device) + shifts[:, None]
    labels = (xi > 0.0).to(torch.float64)
    ths = torch.linspace(-2.0, 2.0, num_candidates, dtype=torch.float64,
                         device=device)

    def matrix(idx):
        pred = (xi[None] > ths[idx.to(device)][:, None, None]).to(torch.float64)
        return torch.abs(pred - labels[None])

    return matrix


def run(rows=None, device=None):
    device = resolve_device(device)
    rows = [] if rows is None else rows
    pop_mat = _loss_matrix(prng.PRNGKey(999), M_AGENTS, 50_000, C, device)
    pop = pop_mat(torch.arange(C)).mean(dim=(1, 2)).cpu().numpy()
    for n in (50, 200, 800):
        mat = _loss_matrix(prng.PRNGKey(0), M_AGENTS, n, C, device)
        emp = mat(torch.arange(C)).mean(dim=(1, 2)).cpu().numpy()
        rad = float(empirical_rademacher(mat, C, M_AGENTS, n, prng.PRNGKey(1),
                                         num_mc=256))
        vc_ub = lemma3_vc_bound([1.0] * M_AGENTS, n, vc_dim=1)
        gap = float(np.max(pop - emp))
        bound_margin = theorem2_bound(
            empirical_risk=0.0, rademacher=rad, M_i=[1.0] * M_AGENTS,
            n=n, cover_size=1, delta=DELTA, L_y=0.0, eps=0.0,
        )
        rows.append({
            "n_per_agent": n,
            "measured_sup_gap": f"{gap:.4f}",
            "thm2_margin(2R+conc)": f"{bound_margin:.4f}",
            "rademacher_mc": f"{rad:.4f}",
            "lemma3_vc_upper": f"{vc_ub:.4f}",
            "bound_holds": bool(gap <= bound_margin),
        })
    emit(rows, ["n_per_agent", "measured_sup_gap", "thm2_margin(2R+conc)",
                "rademacher_mc", "lemma3_vc_upper", "bound_holds"],
         "generalization: Theorem-2 bound vs measured gap (threshold class)")
    return rows


# -- stochastic family: strategy x noise x heterogeneity, held-out split --
S_DIM, S_N, S_M, S_ALPHAS = 12, 60, 6, (0.1, 100.0)
S_ETA, S_K, S_ROUNDS, S_EPS = 0.02, 4, 600, 1e-2
S_SIGMA = 0.05
#: --check bounds (the reference's)
CHECK_MAX_SAGDA_ROUNDS = {0.1: 300, 100.0: 300}
CHECK_MAX_ABS_GAP = 3.5


def _stoch_strategies(noise_name):
    from ..fed import SAGDA, LocalSGDAPlus
    from ..fed.noise import GaussianNoise

    nz = ({"noise": GaussianNoise(sigma=S_SIGMA)}
          if noise_name == "gaussian" else {})
    return [
        ("local_sgda", LocalSGDAPlus(momentum=0.0, **nz)),
        ("local_sgda_plus", LocalSGDAPlus(momentum=0.9, **nz)),
        ("sagda", SAGDA(**nz)),
    ]


def _stoch_one(prob, strategy, x_star, y_star, rounds: int = S_ROUNDS):
    """(rounds to S_EPS (inf if never), final distance, x, y) of one run
    from x0 = y0 = 0."""
    from ..core import make_round, run_strategy_rounds

    rnd = make_round(prob.loss, strategy, S_K, S_ETA, explicit_state=True)
    x0 = torch.zeros_like(x_star)
    state0 = strategy.init_state(x0, x0, prob.num_agents)

    def metric(x, y):
        return {"dist": torch.sqrt(torch.sum((x - x_star) ** 2)
                                   + torch.sum((y - y_star) ** 2))}

    (x, y, _), metrics = run_strategy_rounds(
        rnd, x0, x0, prob.agent_data, rounds, state0, metric)
    dist = metrics["dist"].cpu().numpy()
    hit = np.nonzero(dist <= S_EPS)[0]
    return float(hit[0]) if hit.size else math.inf, float(dist[-1]), x, y


def stochastic_rows(rows=None, device=None, rounds: int = S_ROUNDS):
    from ..data import heterogeneity_index
    from ..fixtures import dirichlet_problem
    from ..problems import quadratic_minimax_point

    rows = [] if rows is None else rows
    for alpha in S_ALPHAS:
        prob, test_data, w = dirichlet_problem(alpha, device)
        het = float(heterogeneity_index(w))
        x_star, y_star = quadratic_minimax_point(prob)
        gap_fn = generalization_gap(prob.loss, prob.agent_data, test_data)
        for noise_name in ("none", "gaussian"):
            for name, strategy in _stoch_strategies(noise_name):
                r_eps, final, x, y = _stoch_one(prob, strategy, x_star, y_star,
                                                rounds)
                g = float(gap_fn(x, y))
                rows.append({
                    "strategy": name, "noise": noise_name,
                    "alpha": f"{alpha:g}", "het_index": f"{het:.3f}",
                    f"rounds_to_{S_EPS:g}": ("inf" if math.isinf(r_eps)
                                             else int(r_eps)),
                    "final_dist": f"{final:.2e}", "gen_gap": f"{g:+.4f}",
                    "_r_eps": r_eps, "_final": final, "_gap": g,
                    "_alpha": alpha,
                })
    emit(rows, ["strategy", "noise", "alpha", "het_index",
                f"rounds_to_{S_EPS:g}", "final_dist", "gen_gap"],
         "generalization: stochastic family — strategy x noise x "
         "Dirichlet(alpha), rounds-to-eps + measured gen gap")
    return rows


def check(device=None) -> int:
    """The gate over the stochastic table's standing claims; returns the
    number of violations (0 = the gate holds):

      1. noiseless SAGDA (exactly FedGDA-GT) reaches eps within the pinned
         round budget at both heterogeneity levels;
      2. noiseless plain Local SGDA under strong heterogeneity (alpha =
         0.1) never reaches eps (its drift floor);
      3. every measured generalization gap stays within the pinned cap."""
    rows = stochastic_rows(device=device)
    by = {(r["strategy"], r["noise"], r["_alpha"]): r for r in rows}
    bad = 0
    for alpha in S_ALPHAS:
        r = by[("sagda", "none", alpha)]["_r_eps"]
        ok = r <= CHECK_MAX_SAGDA_ROUNDS[alpha]
        bad += not ok
        print(f"[{'ok' if ok else 'FAIL'}] sagda/none alpha={alpha:g}: "
              f"rounds={r} (max {CHECK_MAX_SAGDA_ROUNDS[alpha]})")
    r = by[("local_sgda", "none", 0.1)]["_r_eps"]
    ok = math.isinf(r)
    bad += not ok
    print(f"[{'ok' if ok else 'FAIL'}] local_sgda/none alpha=0.1 stalls: "
          f"rounds={r} (expected inf)")
    for r in rows:
        ok = abs(r["_gap"]) <= CHECK_MAX_ABS_GAP
        bad += not ok
        if not ok:
            print(f"[FAIL] gap blow-up: {r['strategy']}/{r['noise']}"
                  f"/alpha={r['alpha']}: {r['_gap']:+.4f}")
    all_ok = all(abs(r["_gap"]) <= CHECK_MAX_ABS_GAP for r in rows)
    print(f"# gen-gap cap |gap| <= {CHECK_MAX_ABS_GAP}: "
          f"{'ok' if all_ok else 'FAIL'}")
    return bad


def main(argv=None) -> int:
    ap = arg_parser(__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="gate the stochastic table's claims (SAGDA linear "
                    "rounds, Local SGDA drift floor, bounded gen gaps); exits "
                    "non-zero on violation")
    args = ap.parse_args(argv)
    if args.check:
        return 1 if check(args.device) else 0
    run(device=args.device)
    stochastic_rows(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
