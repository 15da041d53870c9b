#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the
port's main path — FedGDA-GT rounds (Algorithm 2) with the hand-written
`gt_update` kernel — on the paper's problems and at a width where the
card does real work.  Every phase prints one JSON line; any failed check
exits non-zero without the final line.  The last two lines are the
card's `nvidia-smi` name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases:
  setup      card, power limit, torch / CUDA versions, kernel build time
  gt_update  kernel vs plain version, bit for bit, at 2^27-2^28 elements
             (every dtype pair, both signs) and a ragged 2^20+17; times
             with CUDA events against the HBM bound
  theorem1   d=20, m=8, K=10, eta=2e-4, 4000 rounds through the kernel in
             f64 on the committed JAX fixture: final gap < 1e-18, steady
             linear rate, per-round gaps within rtol 1e-5 of JAX's
  sec51      the paper's Sec 5.1 scale (d=50, n=500, m=20, K=20, eta=1e-4,
             1500 rounds): FedGDA-GT's gap < 1e-8 x Local SGDA's and GDA's
  prop1      Appendix C toy: Local SGDA (K=10, eta=1e-3) reaches the
             closed-form fixed point, where the Prop 1 residual vanishes;
             K=1 GDA (eta=0.1) reaches the minimax point 3.3
  main_path  d=4096, n=8192, m=16 in f64 (G is 2.1 GB), K=10, 10 rounds,
             eta = 1/lambda_max: iterates through the kernel equal those
             through the plain default_update bit for bit, and the kernel
             launches exactly rounds*(K-1)*2 times
  profile    device time by kernel over one main-path round, and the
             device's busy share of it
  kernels    one entry per ported kernel (launches on the main path, error
             against the plain version, times and bound at the main
             path's shapes)
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL_GAP_RTOL = 1e-5        # per-round gap vs JAX, on rounds with gap > 1e-14


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gt_update_bytes(z, c) -> int:
    """HBM bytes of one update: z, g, c read once, out written once."""
    return z.numel() * (3 * z.element_size() + c.element_size())


def gap_metric(core, xs, ys):
    def metric(x, y):
        return {"gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)}

    return metric


# --------------------------------------------------------------- phases
def phase_setup(torch, card: str) -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build("gt_update")
    build_s = time.perf_counter() - t0
    ptxas = [
        ln.strip() for ln in _build.build_logs.get("gt_update", "").splitlines()
        if "registers" in ln or "spill" in ln
    ]
    return {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "kernel_build_s": build_s,
        "libraries": {k: str(p.relative_to(ROOT)) for k, p in paths.items()},
        "ptxas": ptxas[:12],
    }


def phase_gt_update(torch, card: str, cases) -> list:
    from repro_torch.kernels import gt_update, ref

    dt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
          "fp8": torch.float8_e4m3fn}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    eta = 3e-3
    rows = []
    for zdt, cdt, numel in cases:
        z, g, c = (
            torch.randn(numel, generator=gen, device=DEVICE, dtype=torch.float32)
            for _ in range(3)
        )
        z, g, c = z.to(dt[zdt]), g.to(dt[zdt]), c.to(dt[cdt])
        for sign in (-1.0, 1.0):
            got = gt_update(z, g, c, eta=eta, sign=sign)
            want = ref.gt_update_ref(z, g, c, eta, sign)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            check(same, f"gt_update {zdt}/{cdt} n={numel} sign={sign}: "
                        "kernel differs from the plain version")
        del got, want
        ms = time_ms(torch, lambda: gt_update(z, g, c, eta=eta, sign=-1.0))
        plain_ms = time_ms(
            torch, lambda: ref.gt_update_ref(z, g, c, eta, -1.0), reps=10
        )
        nbytes = gt_update_bytes(z, c)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "z": zdt, "c": cdt, "numel": numel, "bitwise_both_signs": True,
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "GB_per_s": nbytes / (ms * 1e-3) / 1e9,
            "bound_ms": bound_ms, "share_of_3.35TB_s": bound_ms / ms,
            "card": card,
        })
        del z, g, c
        torch.cuda.empty_cache()
    return rows


def fixture_problem(name: str, fix: dict):
    from repro_torch.convert import problem_from_numpy

    return problem_from_numpy(
        "quadratic", {"G": fix[f"{name}_G"], "Ab": fix[f"{name}_Ab"]}, DEVICE
    )


def run_gaps(torch, core, prob, rnd, rounds: int):
    from repro_torch.problems import quadratic_minimax_point

    xs, ys = quadratic_minimax_point(prob)
    x0 = torch.zeros(xs.shape[0], dtype=torch.float64, device=DEVICE)
    _, met = core.run_rounds(rnd, x0, x0, prob.agent_data, rounds,
                             gap_metric(core, xs, ys))
    return met["gap"].cpu().numpy()


def trajectory_error(np, got, want) -> float:
    sel = want > 1e-14
    return float(np.max(np.abs(got[sel] - want[sel]) / want[sel]))


def phase_theorem1(torch, np, fix: dict) -> dict:
    from repro_torch import core
    from repro_torch.kernels import gt_update

    prob = fixture_problem("thm1", fix)
    rnd = core.make_fedgda_gt_round(prob.loss, 10, 2e-4)
    gt_update.launches = 0
    t0 = time.perf_counter()
    gap = run_gaps(torch, core, prob, rnd, 4000)
    wall = time.perf_counter() - t0
    launches = gt_update.launches
    seg = gap[(gap > 1e-14) & (gap < 1e2)]
    rates = np.diff(np.log(seg))
    err = trajectory_error(np, gap, fix["thm1_gap"])
    check(launches == 4000 * 9 * 2, f"theorem1: {launches} kernel launches")
    check(gap[-1] < 1e-18, f"theorem1: final gap {gap[-1]:.3e} >= 1e-18")
    check(bool(np.all(rates < 0)), "theorem1: a log-gap rate is not negative")
    check(np.std(rates) < 0.25 * abs(np.mean(rates)), "theorem1: rate not steady")
    check(err <= TOL_GAP_RTOL, f"theorem1: gap off JAX's by {err:.3e} relative")
    return {
        "final_gap": float(gap[-1]), "jax_final_gap": float(fix["thm1_gap"][-1]),
        "mean_log_rate": float(np.mean(rates)), "rate_std": float(np.std(rates)),
        "max_rel_err_vs_jax": err, "tolerance": TOL_GAP_RTOL,
        "gt_update_launches": launches, "wall_s": wall,
        "ms_per_round": wall / 4000 * 1e3,
    }


def phase_sec51(torch, np, fix: dict) -> dict:
    from repro_torch import core

    prob = fixture_problem("sec51", fix)
    eta, K, T = 1e-4, 20, 1500
    rounds = {
        "gt": core.make_fedgda_gt_round(prob.loss, K, eta),
        "ls": core.make_local_sgda_round(prob.loss, K, eta, eta),
        "gda": core.make_local_sgda_round(prob.loss, 1, eta, eta),
    }
    gaps, walls = {}, {}
    for name, rnd in rounds.items():
        t0 = time.perf_counter()
        gaps[name] = run_gaps(torch, core, prob, rnd, T)
        walls[name] = time.perf_counter() - t0
    final = {k: float(v[-1]) for k, v in gaps.items()}
    err = trajectory_error(np, gaps["gt"], fix["sec51_gap"])
    check(final["gt"] < 1e-8 * final["ls"], f"sec51: gt {final['gt']:.3e} vs ls {final['ls']:.3e}")
    check(final["gt"] < 1e-8 * final["gda"], f"sec51: gt {final['gt']:.3e} vs gda {final['gda']:.3e}")
    check(err <= TOL_GAP_RTOL, f"sec51: gt gap off JAX's by {err:.3e} relative")
    return {"final_gap": final, "gt_max_rel_err_vs_jax": err,
            "tolerance": TOL_GAP_RTOL, "wall_s": walls}


def phase_prop1(torch) -> dict:
    from repro_torch import core
    from repro_torch.problems import make_appendix_c_problem

    prob = make_appendix_c_problem(device=DEVICE)
    K, eta = 10, 1e-3
    x0 = torch.tensor(0.0, dtype=torch.float64, device=DEVICE)
    # the averaged local map contracts by ~0.95 a round: 800 rounds is
    # ~1e-17 relative
    (x, y), _ = core.run_rounds(
        core.make_local_sgda_round(prob.loss, K, eta, eta), x0, x0,
        prob.agent_data, 800,
    )
    fx, fy = core.appendix_c_fixed_point(K, eta, eta)
    r_fp = float(core.prop1_residual(prob.loss, x, y, prob.agent_data, K, eta, eta))
    xm = torch.tensor(3.3, dtype=torch.float64, device=DEVICE)
    r_mm = float(core.prop1_residual(prob.loss, xm, xm, prob.agent_data, K, eta, eta))
    (xg, yg), _ = core.run_rounds(
        core.make_local_sgda_round(prob.loss, 1, 0.1, 0.1), x0, x0,
        prob.agent_data, 200,
    )
    x, y, xg, yg = (float(v) for v in (x, y, xg, yg))
    check(abs(x - fx) <= 1e-10 * abs(fx) and abs(y - fy) <= 1e-10 * abs(fy),
          f"prop1: Local SGDA at ({x}, {y}), closed form ({fx}, {fy})")
    check(r_fp < 1e-10, f"prop1: residual {r_fp:.3e} at the fixed point")
    check(r_mm > 1e-3, f"prop1: residual {r_mm:.3e} at the minimax point")
    check(abs(xg - 3.3) <= 1e-9 * 3.3 and abs(yg - 3.3) <= 1e-9 * 3.3,
          f"prop1: K=1 GDA at ({xg}, {yg})")
    return {"local_sgda": [x, y], "closed_form": [fx, fy],
            "residual_at_fixed_point": r_fp, "residual_at_minimax": r_mm,
            "gda_k1": [xg, yg], "bias": x - 3.3}


def lambda_max(torch, G, iters: int = 30) -> float:
    """Largest eigenvalue over the agents' G_i by power iteration."""
    gen = torch.Generator(device=G.device).manual_seed(1)
    v = torch.randn(G.shape[:2], generator=gen, dtype=G.dtype, device=G.device)
    for _ in range(iters):
        v = torch.einsum("mde,me->md", G, v)
        v = v / v.norm(dim=1, keepdim=True)
    lam = torch.einsum("md,mde,me->m", v, G, v)
    return float(lam.max())


def phase_main_path(torch, card: str, shared: dict, dim: int, samples: int,
                    agents: int, K: int, rounds: int) -> dict:
    """Fills shared["launches"] (the kernels' counts over this run) and
    shared["state"] (operands at the main path's shapes)."""
    from repro_torch import core
    from repro_torch.kernels import gt_update
    from repro_torch.problems import make_quadratic_problem, quadratic_minimax_point

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    prob = make_quadratic_problem(gen, dim=dim, num_samples=samples,
                                  num_agents=agents, device=DEVICE)
    G = prob.agent_data["G"]
    eta = 1.0 / lambda_max(torch, G)
    xs, ys = quadratic_minimax_point(prob)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def record(x, y):
        return {"x": x, "y": y,
                "gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)}

    x0 = torch.zeros(dim, dtype=torch.float64, device=DEVICE)
    kernel_round = core.make_fedgda_gt_round(prob.loss, K, eta)
    plain_round = core.make_fedgda_gt_round(
        prob.loss, K, eta, update_fn=core.default_update
    )
    # one warm-up round each (first-call setup of the autodiff machinery)
    kernel_round(x0, x0, prob.agent_data)
    plain_round(x0, x0, prob.agent_data)
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    gt_update.launches = 0
    t0 = time.perf_counter()
    _, got = core.run_rounds(kernel_round, x0, x0, prob.agent_data, rounds, record)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {"gt_update": gt_update.launches}
    shared.update(launches=launches, round=kernel_round,
                  data=prob.agent_data, x0=x0)

    t0 = time.perf_counter()
    _, want = core.run_rounds(plain_round, x0, x0, prob.agent_data, rounds, record)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    gap = got["gap"].cpu().numpy()
    bitwise = all(torch.equal(got[k], want[k]) for k in ("x", "y"))
    check(bitwise, "main_path: kernel iterates differ from default_update's")
    check(launches["gt_update"] == rounds * (K - 1) * 2,
          f"main_path: {launches['gt_update']} gt_update launches, "
          f"expected {rounds * (K - 1) * 2}")
    check(bool(torch.isfinite(got["x"]).all() and torch.isfinite(got["y"]).all()),
          "main_path: non-finite iterates")
    check(gap[-1] < gap[0], f"main_path: gap {gap[0]:.3e} -> {gap[-1]:.3e}")
    info = {
        "dim": dim, "num_samples": samples, "num_agents": agents, "K": K,
        "rounds": rounds, "eta": eta, "G_bytes": G.numel() * G.element_size(),
        "setup_s": setup_s, "ms_per_round_kernel": kernel_s / rounds * 1e3,
        "ms_per_round_plain_update": plain_s / rounds * 1e3,
        "gap_first": float(gap[0]), "gap_last": float(gap[-1]),
        "bitwise_kernel_vs_plain": bitwise, "launches": launches, "card": card,
    }
    # the kernel's operands at the main path's shapes: one agent-stacked
    # leaf [m, d] in f64 with its f64 correction
    shared["state"] = {"z": got["x"][-1].expand(agents, dim).contiguous(),
             "g": torch.randn(agents, dim, generator=gen, dtype=torch.float64,
                              device=DEVICE),
             "c": torch.randn(agents, dim, generator=gen, dtype=torch.float64,
                              device=DEVICE),
             "eta": eta}
    return info


def phase_profile(torch, shared: dict) -> dict:
    """Device time by kernel over one main-path round (torch.profiler);
    busy share = summed kernel time over the round's wall time, both under
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rnd, data, x0 = shared["round"], shared["data"], shared["x0"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rnd(x0, x0, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append({"name": ev.key[:90], "count": ev.count, "ms": us / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    busy_ms = sum(k["ms"] for k in kernels)
    gt_ms = sum(k["ms"] for k in kernels if "gt_update_kernel" in k["name"])
    if not kernels:
        return {"device_time": "not measured (the profiler saw no CUDA kernel)",
                "round_wall_ms": wall_ms}
    return {
        "round_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "gt_update_ms": gt_ms, "gt_update_share_of_busy": gt_ms / busy_ms,
        "kernel_launches": sum(k["count"] for k in kernels),
        "top": kernels[:8],
    }


def kernel_entries(torch, launches: dict, state: dict, card: str) -> list:
    from repro_torch.kernels import gt_update, ref

    z, g, c, eta = state["z"], state["g"], state["c"], state["eta"]
    got = gt_update(z, g, c, eta=eta, sign=-1.0)
    want = ref.gt_update_ref(z, g, c, eta, -1.0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0.0, f"gt_update at the main path's shape: max |err| {err}")
    ms = time_ms(torch, lambda: gt_update(z, g, c, eta=eta, sign=-1.0), reps=200)
    plain_ms = time_ms(torch, lambda: ref.gt_update_ref(z, g, c, eta, -1.0), reps=200)
    return [{
        "name": "gt_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gt_update.cu",
        "replaces": "src/repro/kernels/gt_update.py:26",
        "launches": launches["gt_update"], "max_abs_err": err,
        "tolerance": 0.0, "bitwise_vs_plain": err == 0.0,
        "shape": list(z.shape), "dtypes": [str(z.dtype), str(c.dtype)],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": gt_update_bytes(z, c) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # no single PyTorch call computes z + s*(g + c)
        "library_ms": None, "card": card,
    }]


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this runs on a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.fixtures import load_paper_quadratic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    card = card_line()
    print(card, flush=True)
    fix = load_paper_quadratic()
    big, big64, ragged = 1 << 28, 1 << 27, (1 << 20) + 17
    cases = [("f32", "f32", big), ("f32", "bf16", big), ("f32", "fp8", big),
             ("bf16", "bf16", big), ("bf16", "fp8", big), ("f64", "f64", big64),
             ("f32", "f32", ragged), ("f64", "fp8", ragged)]

    ok = True
    shared = {}
    t_start = time.perf_counter()

    def run(name, fn):
        nonlocal ok
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # a failed phase is reported, then exits 1
            ok = False
            emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
            return None
        emit({"phase": name, "ok": True, "s": time.perf_counter() - t0,
              "result": out})
        return out

    run("setup", lambda: phase_setup(torch, card))
    run("gt_update", lambda: phase_gt_update(torch, card, cases))
    run("theorem1", lambda: phase_theorem1(torch, np, fix))
    run("sec51", lambda: phase_sec51(torch, np, fix))
    run("prop1", lambda: phase_prop1(torch))
    run("main_path", lambda: phase_main_path(
        torch, card, shared, dim=4096, samples=8192, agents=16, K=10, rounds=10))
    if "state" in shared:
        run("profile", lambda: phase_profile(torch, shared))
        kernels = run("kernels", lambda: kernel_entries(
            torch, shared["launches"], shared["state"], card))
        if kernels is not None:
            emit({"kernels": kernels})
    emit({"phase": "total", "ok": ok, "s": time.perf_counter() - t_start})
    if not ok:
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
