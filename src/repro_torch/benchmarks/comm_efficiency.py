"""Communication efficiency, the paper's headline claim quantified (port
of `benchmarks/comm_efficiency.py`).

On the Section 5.1 quadratic game (JAX's data from PRNGKey(0), the `sec51`
fixture): rounds and total exchanged bytes (star-topology cost model,
Section 3) to reach optimality gap <= eps for centralized GDA, Local SGDA,
FedGDA-GT and the scenario strategies (client sampling, sparsified
corrections with error feedback, stochastically quantized corrections at
8 bit and at 4 bit with top-10% sparsification).  Per-round payloads are
strategy-derived (`CommStrategy.bytes_per_round`), and every row also
reports the MEASURED per-round bytes of the packed wire buffers (the
compressed strategies run with wire_transport=True).

`--check` skips the convergence runs and audits the accounting: a
non-zero exit when the measured packed payload bytes (headers excluded)
differ from the priced bytes by more than 5%, for every row.  It also
encodes one round's corrections of each wire row on the device and holds
the `PackedTree`'s bytes to the price.

`--overlap` (the asynchronous runtime's round time) is ROADMAP Queue 1
item 10.

    python -m repro_torch.benchmarks.comm_efficiency [--check] [--device cpu]
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..core import make_round, run_strategy_rounds, tree_sq_dist
from ..device import not_ported, resolve_device
from ..fed import (
    CompressedGT,
    FullSync,
    GradientTracking,
    LocalOnly,
    PartialParticipation,
    QuantizedGT,
    comm_table,
    measured_bytes_per_round,
)
from ..fixtures import fixture_problem
from .common import arg_parser, emit

ETA, K, T = 1e-4, 20, 3000
EPS = 1e-8
DIM = 50
AGENTS = 20
CHECK_TOL = 0.05  # measured may differ from priced by at most 5%


def _runs():
    return {
        "gda": (FullSync(), 1),
        "local_sgda": (LocalOnly(), K),
        "fedgda_gt": (GradientTracking(), K),
        "partial_gt_50": (PartialParticipation(participation=0.5, seed=0), K),
        "compressed_gt_10": (
            CompressedGT(compression_ratio=0.1, wire_transport=True), K),
        "quantized_gt_8bit": (QuantizedGT(bits=8, wire_transport=True), K),
        "quantized_gt_4bit_top10": (
            QuantizedGT(bits=4, ratio=0.1, wire_transport=True), K),
    }


def check(tol: float = CHECK_TOL, device=None) -> int:
    """Audit priced against measured bytes without training; returns the
    number of drifting rows (0 = the accounting holds).  The probe leaves
    out the fixed per-leaf headers, so all of `tol` is drift margin."""
    device = resolve_device(device)
    x0 = torch.zeros(DIM, dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    bad = 0
    for name, (strategy, _) in _runs().items():
        priced = strategy.bytes_per_round(x0, x0, K)
        payload = measured_bytes_per_round(strategy, x0, x0, K,
                                           include_headers=False)
        drift = payload / priced - 1.0
        ok = abs(drift) <= tol
        line = (f"{name}: priced={priced} measured_payload={payload} "
                f"({drift:+.2%})")
        if getattr(strategy, "wire_transport", False):
            # one round's corrections of AGENTS agents, packed on the device
            c = torch.randn((AGENTS, DIM), generator=gen, dtype=torch.float64,
                            device=device)
            px, py, _ = strategy.transform_correction(
                c, -c, strategy.init_state(x0, x0, AGENTS))
            dense = 2 * x0.numel() * x0.element_size() * 2
            live = dense + 2 * (px.wire_bytes() + py.wire_bytes()) // AGENTS
            ok = ok and live == priced
            line += f" packed_on_{device.type}={live}"
        bad += not ok
        print(f"[{'ok' if ok else 'DRIFT'}] {line}")
    return bad


def run(rows=None, device=None, rounds: int = T):
    """The table: each row's rounds to gap <= EPS in `rounds` rounds (GDA:
    rounds * K single-step rounds, the same gradient-step budget)."""
    prob, xs, ys = fixture_problem("sec51", device)

    def metric(x, y):
        return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

    x0 = torch.zeros_like(xs)
    rounds_to_eps, strategies = {}, {}
    for name, (strategy, k) in _runs().items():
        n = rounds * K if name == "gda" else rounds
        rnd = make_round(prob.loss, strategy, k, ETA, explicit_state=True)
        _, met = run_strategy_rounds(
            rnd, x0, x0, prob.agent_data, n,
            strategy.init_state(x0, x0, prob.num_agents), metric)
        gaps = met["gap"].cpu().numpy()
        hit = np.nonzero(gaps <= EPS)[0]
        rounds_to_eps[strategy] = float(hit[0]) if hit.size else math.inf
        strategies[strategy] = name
    table = comm_table(x0, x0, K, rounds_to_eps)
    rows = [] if rows is None else rows
    # comm_table keeps insertion order and keys colliding names by their
    # knob signature, so rows pair by order
    for name, entry in zip(strategies.values(), table.values()):
        rows.append({
            "algorithm": name,
            "bytes_per_round": int(entry["bytes_per_round"]),
            "measured_bytes_per_round": int(entry["measured_bytes_per_round"]),
            f"rounds_to_{EPS:g}": entry["rounds_to_eps"],
            "total_bytes": entry["total_bytes"],
        })
    emit(rows, ["algorithm", "bytes_per_round", "measured_bytes_per_round",
                f"rounds_to_{EPS:g}", "total_bytes"],
         f"communication to reach gap<={EPS:g} (quadratic game, K={K})")
    return rows


def main(argv=None) -> int:
    ap = arg_parser(__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="audit measured packed bytes against the analytic "
                    f"price (> {CHECK_TOL:.0%} drift exits non-zero); skips "
                    "training")
    ap.add_argument("--overlap", action="store_true",
                    help="sync vs async round latency (not ported)")
    args = ap.parse_args(argv)
    if args.overlap:
        raise not_ported("comm_efficiency --overlap (the async runtime)",
                         "Queue 1 item 10")
    if args.check:
        return 1 if check(device=args.device) else 0
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
