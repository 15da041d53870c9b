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

`--population mega` runs the `mega` preset (1e6 registered agents, 256
active a round, 1024 pods) through the O(active) engine
(`sim.SparseElasticEngine`, per-id synthesized data, the pod tree with
its wire payloads) beside a 100x smaller registry with the same active
set; `--check-pods` is the reference's memory gate on that pair: the 1e6
run's peak (host trace plus, on a card, `max_memory_allocated`, on the
CPU a census of the torch tensors it leaves) within 1.5x the 1e4 run's
plus 24 MiB.  Any m-dense structure (a tracker table is ~128 MiB at 1e6)
trips it.

    python -m repro_torch.benchmarks.elastic [--check | --check-pods |
        --population mega] [--device cpu]
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from ..fed import GradientTracking, resolve_strategy
from ..fixtures import (
    ELASTIC,
    ELASTIC_EPS,
    ELASTIC_ROWS,
    ELASTIC_SCENARIOS,
    elastic_run_gaps,
)
from ..sim import (
    Population,
    SparseElasticEngine,
    SyntheticDataSource,
    UniformActiveSubset,
    UniformStragglers,
    make_population,
    schedule_bytes,
)
from ..sim.scenarios import MEGA_ACTIVE, MEGA_AGENTS, MEGA_PODS
from .common import arg_parser, emit, peak_memory

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


# ------------------------------------------------- mega: O(active) at 1e6
MEGA_DIM, MEGA_SAMPLES, MEGA_T = 8, 8, 4
MEGA_MEM_FACTOR = 1.5  # the 1e6 run's peak within this factor of the
MEGA_MEM_SLACK = 24 * 2**20  # 100x smaller registry's, plus the slack


def _mega_loss(x, y, data):
    # the Section 5.1 quadratic over per-agent sufficient statistics
    G, Ab = data["G"], data["Ab"]
    return 0.5 * x @ G @ x - 0.5 * y @ G @ y + Ab @ (2.0 * x - y)


def _mega_source(m, dim=MEGA_DIM, samples=MEGA_SAMPLES, seed=7, device=None):
    """Per-agent sufficient statistics synthesized from the GLOBAL agent id
    as the reference does (`fold_in(PRNGKey(seed), id)`, split in three,
    f64 normals A [samples, dim], theta [dim], noise [samples]): any
    subset of the registry in O(n) memory, a batch of ids in one draw.
    The normals are within a few ulp of JAX's (`prng.normal`)."""
    device = resolve_device(device)
    data_key = prng.PRNGKey(seed)

    def rows(ids):
        keys = prng.split(prng.fold_in(data_key, ids), 3)
        A = prng.normal(keys[:, 0], (samples, dim), device=device)
        theta = prng.normal(keys[:, 1], (dim,), device=device)
        e = prng.normal(keys[:, 2], (samples,), device=device)
        b = torch.einsum("nsd,nd->ns", A, theta) + 0.5 * e
        return {"G": torch.einsum("nsi,nsj->nij", A, A) / samples,
                "Ab": torch.einsum("nsi,ns->ni", A, b) / samples}

    return SyntheticDataSource(m, rows)


def _mega_engine_run(m, active, pods, T=MEGA_T, device=None) -> dict:
    """The mega preset's engine run (FedGDA-GT, wire_pods, the sparse path
    forced at every m), a round at a time (`resume` on the schedule's tail:
    bitwise the uninterrupted run) to read the tracker's touched count
    after each round.  Returns {"engine", "x", "y", "tracker_touched"}."""
    device = resolve_device(device)
    pop = Population(m, UniformActiveSubset(size=active),
                     UniformStragglers(p_straggle=0.3, min_frac=0.5), pods=pods)
    eng = SparseElasticEngine(_mega_loss, GradientTracking(),
                              _mega_source(m, device=device), K, ETA,
                              pod_map=pop.pod_map(), wire_pods=True,
                              dense_fallback_max_m=0)
    sched = pop.sparse_schedule(SEED, T, K, device)
    x = y = torch.zeros(MEGA_DIM, dtype=torch.float64, device=device)
    touched = []
    for t in range(T):
        x, y = eng.run(x, y, sched.tail(t), num_rounds=1, resume=t > 0)
        touched.append(eng._tracker.num_touched)
    return {"engine": eng, "x": x, "y": y, "tracker_touched": touched}


def _mega_pair(device) -> dict:
    """The 1e4 reference registry then the 1e6 mega one (same active set
    and pods rule), each under `peak_memory`."""
    out = {}
    for label, m in (("ref_1e4", MEGA_AGENTS // 100), ("mega_1e6", MEGA_AGENTS)):
        pods = MEGA_PODS if m >= MEGA_PODS else max(1, m // 64)
        out[label] = dict(peak_memory(_mega_engine_run, m, MEGA_ACTIVE, pods,
                                      device=device), m=m, pods=pods)
    return out


def _total_bytes(mem: dict) -> int:
    """Host peak plus the device's true peak (a card) or the census of the
    tensors left alive (the CPU, where torch's allocator is untraced)."""
    dev = mem["device_peak_bytes"]
    return mem["host_peak_bytes"] + (mem["live_buffer_bytes"] if dev is None else dev)


def run_pods(rows=None, device=None):
    """The mega preset through the sparse engine with peak-memory and
    pod-wire columns, beside a 100x smaller registry with the same active
    set: the side by side that makes O(active + pods) visible."""
    device = resolve_device(device)
    rows = [] if rows is None else rows
    for label, mem in _mega_pair(device).items():
        run = mem["result"]
        last = run["engine"].history[-1]
        dev = mem["device_peak_bytes"]
        rows.append({
            "population": label, "m": mem["m"], "active": MEGA_ACTIVE,
            "pods": mem["pods"], "rounds": len(run["engine"].history),
            "host_peak_mib": f"{mem['host_peak_bytes'] / 2**20:.1f}",
            "live_buf_mib": f"{mem['live_buffer_bytes'] / 2**20:.1f}",
            "device_peak_mib": "" if dev is None else f"{dev / 2**20:.1f}",
            "live_pods": last["live_pods"], "pod_wire_bytes": last["pod_wire_bytes"],
            "tracker_touched": run["tracker_touched"][-1]})
    emit(rows, ["population", "m", "active", "pods", "rounds", "host_peak_mib",
                "live_buf_mib", "device_peak_mib", "live_pods", "pod_wire_bytes",
                "tracker_touched"],
         f"O(active) sparse engine at registry scale (K={K}, T={MEGA_T} rounds, "
         "two-level pod aggregation)")
    return rows


def pods_peaks(device=None, factor: float = MEGA_MEM_FACTOR,
               slack: int = MEGA_MEM_SLACK) -> dict:
    """The memory gate's numbers: each run's host, census and device peaks
    and totals (bytes), the budget and whether the mega run is within it;
    "runs" holds the two runs (`_mega_engine_run`'s records)."""
    pair = _mega_pair(resolve_device(device))
    out = {"runs": {}}
    for label, mem in pair.items():
        out[label] = {k: mem[k] for k in ("m", "pods", "host_peak_bytes",
                                          "live_buffer_bytes", "device_peak_bytes")}
        out[label]["total_bytes"] = _total_bytes(mem)
        out["runs"][label] = mem["result"]
    out["budget_bytes"] = int(out["ref_1e4"]["total_bytes"] * factor) + slack
    out["ok"] = out["mega_1e6"]["total_bytes"] <= out["budget_bytes"]
    return out


def check_pods(device=None, factor: float = MEGA_MEM_FACTOR,
               slack: int = MEGA_MEM_SLACK) -> int:
    """The gate of the million-agent memory claim: the 1e6 run's total
    within `factor` x the 1e4 run's plus `slack`.  Returns the number of
    violations (0 = the gate holds)."""
    p = pods_peaks(device, factor, slack)
    mib = lambda b: f"{b / 2**20:.1f}MiB"
    parts = lambda r: (f"host={mib(r['host_peak_bytes'])} "
                       + (f"census={mib(r['live_buffer_bytes'])}"
                          if r["device_peak_bytes"] is None
                          else f"device={mib(r['device_peak_bytes'])}"))
    print(f"[{'ok' if p['ok'] else 'FAIL'}] elastic_pods: mega(m={MEGA_AGENTS:.0e}) "
          f"peak={mib(p['mega_1e6']['total_bytes'])} ({parts(p['mega_1e6'])}) vs "
          f"ref(m={MEGA_AGENTS // 100:.0e}) peak={mib(p['ref_1e4']['total_bytes'])} "
          f"({parts(p['ref_1e4'])}) budget={mib(p['budget_bytes'])}")
    return 0 if p["ok"] else 1


def main(argv=None) -> int:
    ap = arg_parser(__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="gate the stable-scenario elastic path against the "
                    f"plain runner (> {CHECK_TOL:.0%} more rounds to eps exits "
                    "non-zero); skips the scenario sweep")
    ap.add_argument("--check-pods", action="store_true",
                    help="gate the mega preset's peak memory: the 1e6-agent "
                    "sparse run must not scale with m (see check_pods)")
    ap.add_argument("--population", default=None, choices=["mega"],
                    help="run the named population instead of the scenario "
                    "sweep (mega: 1e6 agents / 256 active / 1024 pods through "
                    "the sparse engine)")
    args = ap.parse_args(argv)
    if args.check_pods:
        return 1 if check_pods(device=args.device) else 0
    if args.check:
        return 1 if check(device=args.device) else 0
    if args.population == "mega":
        run_pods(device=args.device)
        return 0
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
