"""Telemetry overhead, the observability suite's cost gate (port of
`benchmarks/obs.py`).

The telemetry sink (`obs.Telemetry`) lives on the host: a runner given
`telemetry=None` runs the code without it, and an attached sink adds a few
dict appends and one `perf_counter` pair a round, no device sync.  This
driver measures that cost on the Section 5.1 quadratic game (dim 256, m=8,
K=10, FedGDA-GT through the sync `FederatedRunner` and the `gt_update`
kernel) in three modes:

  disabled   telemetry=None (the baseline);
  enabled    an in-memory `Telemetry()` sink, no probes: spans and
             wire-byte counters only;
  ledger     the same sink streaming every event to a JSONL run ledger
             (`obs.RunLedger`), read back from disk afterwards: the
             table's byte column comes from the ledger file.

Timing: the sink costs deterministic microseconds a round, while a shared
host's scheduler noise comes in bursts that can straddle whole runs.  So
the modes are timed as many short interleaved chunks (rotating every
chunk, each ending in a synchronize on a card), and each mode is scored by
the mean of its `LOW_K` fastest chunks.

`--check` is the gate: non-zero exit when enabled-without-probes costs
more than `CHECK_TOL` (3%) wall clock over disabled.  Probes are outside
the gate: a sampled `gt_residual` does real device work and syncs.

    python -m repro_torch.benchmarks.obs [--check] [--device cpu]
"""
from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..fed import FederatedRunner, GradientTracking
from ..obs import RunLedger, Telemetry
from .common import arg_parser, emit

ETA, K = 1e-4, 10
DIM, M = 256, 8
CHUNKS = 24  # interleaved timing chunks a mode
T_CHUNK = 25  # rounds a chunk, well below the noise bursts' scale
LOW_K = 6  # score = mean of each mode's LOW_K fastest chunks
CHECK_TOL = 0.03  # enabled-without-probes may cost at most 3% wall clock


def _runner(device):
    from ..problems import make_quadratic_problem

    gen = torch.Generator(device="cpu").manual_seed(0)
    prob = make_quadratic_problem(gen, dim=DIM, num_samples=200, num_agents=M,
                                  device=device)
    return FederatedRunner.from_strategy(prob.loss, GradientTracking(),
                                         prob.agent_data, K, ETA)


def _time_chunk(runner, telemetry, device) -> float:
    x0 = torch.zeros(DIM, dtype=torch.float64, device=device)
    runner.telemetry = telemetry
    t0 = time.perf_counter()
    runner.run(x0, x0, T_CHUNK)
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # completion, not enqueue, time
    return time.perf_counter() - t0


def _measure(runner, sinks, device):
    """Chunk-interleaved low-quantile timing: every mode (one sink or None
    each) runs CHUNKS chunks, rotating mode every chunk so noise bursts hit
    all modes alike, and is scored by the mean of its LOW_K fastest."""
    _time_chunk(runner, None, device)  # first-call setup, shared by all modes
    _time_chunk(runner, None, device)
    times = [[] for _ in sinks]
    for _ in range(CHUNKS):
        for mode, tm in enumerate(sinks):
            times[mode].append(_time_chunk(runner, tm, device))
    return [float(np.mean(sorted(ts)[:LOW_K])) for ts in times]


def _where(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(rows=None, device=None):
    device = resolve_device(device)
    rows = [] if rows is None else rows
    runner = _runner(device)
    # ledger mode streams to JSONL, then the table reads the file back
    with tempfile.TemporaryDirectory() as d:
        ledger = RunLedger(d)
        tm_on = Telemetry()
        off_s, on_s, led_s = _measure(runner, [None, tm_on, Telemetry(ledger=ledger)],
                                      device)
        ledger.close()
        events = RunLedger.events(d)
    runner.telemetry = None
    led_bytes = sum(e["value"] for e in events
                    if e["kind"] == "counter" and e["name"] == "wire_bytes")

    def row(mode, secs, n_events, bytes_=""):
        return {"mode": mode, "rounds": CHUNKS * T_CHUNK, "chunk_s": f"{secs:.4f}",
                "per_round_us": f"{secs / T_CHUNK * 1e6:.1f}",
                "overhead_pct": f"{(secs / off_s - 1) * 100:.2f}",
                "events": n_events, "ledger_wire_bytes": bytes_}

    rows.append(row("disabled", off_s, 0))
    rows.append(row("enabled", on_s, len(tm_on.events)))
    rows.append(row("ledger", led_s, len(events), led_bytes))
    emit(rows, ["mode", "rounds", "chunk_s", "per_round_us", "overhead_pct",
                "events", "ledger_wire_bytes"],
         f"telemetry overhead, sync quadratic round (dim={DIM}, m={M}, K={K}, "
         f"{_where(device)}; gate: enabled <= {CHECK_TOL:.0%} over disabled)")
    return rows


def check(tol: float = CHECK_TOL, device=None) -> int:
    device = resolve_device(device)
    runner = _runner(device)
    off_s, on_s = _measure(runner, [None, Telemetry()], device)
    ratio = on_s / off_s
    ok = ratio <= 1.0 + tol
    print(f"[{'ok' if ok else 'FAIL'}] obs: enabled/disabled wall-clock ratio "
          f"{ratio:.4f} (disabled {off_s:.4f}s, enabled {on_s:.4f}s per "
          f"{T_CHUNK}-round chunk, budget {1.0 + tol:.2f}; {_where(device)})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = arg_parser(__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="gate: exit non-zero if the enabled-without-probes sink "
                    f"costs > {CHECK_TOL:.0%} wall clock over disabled")
    args = ap.parse_args(argv)
    if args.check:
        return check(device=args.device)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
