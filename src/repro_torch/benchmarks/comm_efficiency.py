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

`--overlap` times a round of each row's strategy through the sync runner
and through the asynchronous runtime (`fed.AsyncFederatedRunner`) at dim
200 with 8 agents in 8 shards: the reference's 8 emulated host devices
are here the one device given 8 times, one CUDA stream a shard on a card.

    python -m repro_torch.benchmarks.comm_efficiency [--check | --overlap]
        [--device cpu]
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from ..core import make_round, run_strategy_rounds, tree_sq_dist
from ..device import resolve_device
from ..fed import (
    AsyncFederatedRunner,
    CompressedGT,
    FederatedRunner,
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
#: --overlap's problem: the reference's dim, agents and shards
OVERLAP_DIM, OVERLAP_AGENTS, OVERLAP_SHARDS = 200, 8, 8


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


def overlap(rows=None, device=None, rounds: int = 20):
    """Wall-clock ms per round, sync against async runtime, per strategy
    (each after 2 warm-up rounds, ending in a synchronize on a card).

    The async column buys its overlap from per-shard dispatch: while one
    shard runs its trailing local steps, the others' partial aggregates
    and the next round's broadcast are already enqueued.  FullSync is the
    anti-case: K communicated steps leave nothing to overlap.  With every
    shard on one device the shards share its bandwidth and its host
    thread, so the async column is the dispatch cost the overlap must beat
    (the reference's emulated host devices share one host alike)."""
    from ..problems import make_quadratic_problem

    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    prob = make_quadratic_problem(gen, dim=OVERLAP_DIM, num_samples=500,
                                  num_agents=OVERLAP_AGENTS, device=device)
    x0 = torch.zeros(OVERLAP_DIM, dtype=torch.float64, device=device)

    def per_round_ms(runner) -> float:
        runner.run(x0, x0, 2)  # first-call setup
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        runner.run(x0, x0, rounds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / rounds * 1e3

    rows = [] if rows is None else rows
    for name, (strategy, k) in _runs().items():
        sync_ms = per_round_ms(FederatedRunner.from_strategy(
            prob.loss, strategy, prob.agent_data, k, ETA))
        ar = AsyncFederatedRunner(prob.loss, strategy, prob.agent_data, k, ETA,
                                  devices=[device] * OVERLAP_SHARDS)
        async_ms = per_round_ms(ar)
        rows.append({"algorithm": name, "sync_round_ms": f"{sync_ms:.3f}",
                     "async_round_ms": f"{async_ms:.3f}",
                     "async_vs_sync": f"{sync_ms / async_ms:.2f}x",
                     "shards": ar._n_shards})
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    emit(rows, ["algorithm", "sync_round_ms", "async_round_ms", "async_vs_sync",
                "shards"],
         f"round latency, sync vs async runtime ({OVERLAP_SHARDS} shards on one "
         f"{device.type} device, {card}; dim={OVERLAP_DIM}, K={K})")
    return rows


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
                    help="sync vs async runtime round latency, "
                    f"{OVERLAP_SHARDS} shards on the device")
    args = ap.parse_args(argv)
    if args.overlap:
        overlap(device=args.device)
        return 0
    if args.check:
        return 1 if check(device=args.device) else 0
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
