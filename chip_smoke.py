#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, started together), holds each against its plain PyTorch
version on the card, then drives the port's main paths: FedGDA-GT rounds
(Algorithm 2) with the hand-written `gt_update` kernel, the
communication-efficient rounds (CompressedGT / QuantizedGT, the packed
wire transport) with the `compress_correction`, `pack_payload` and
`unpack_payload` kernels, on the paper's problems and at a width where the
card does real work, the rest of the paper's experiments (Fig 2's
robust regression, agnostic FL) through the `FederatedRunner` with a
checkpoint resume, and the serving path of zamba2-7b at full width
(`python -m repro_torch.launch.serve`) with the `flash_attention` and
`ssm_scan` kernels.  Every phase prints one JSON line (fig2 also the
reference's CSV table); any failed check
exits non-zero without the final line.  The last two lines are the card's
`nvidia-smi` name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases:
  setup      card, power limit, torch / CUDA versions, kernel build time
  gt_update  kernel vs plain version, bit for bit, at 2^27-2^28 elements
             (every dtype pair, both signs) and a ragged 2^20+17; times
             with CUDA events against the HBM bound
  compress_correction, pack_payload, unpack_payload
             each kernel vs its plain version, bit for bit: every
             correction dtype, top-k and rand-k, bits 2-32, every
             encoding, at the main path's [16, 4096] f64, ragged rows,
             rows longer than shared memory and rows with NaN; pack also
             on all-tie, one-exponent and split-tie rows at odd lengths,
             more rows than twice the SMs and unaligned operands; times at
             [16, 4096] f64 and [16384, 4096] f32 (pack: top-k and rand-k
             8-bit) against the HBM bound and `torch.topk` of the scores
             (the library yardstick); pack's main-shape device time per
             call (profiler) beside its wall time, and each `pack_kernel`
             instantiation's registers, spills and shared memory
  flash_attention
             kernel vs plain version (tolerance 1e-5 in f32; in bf16 one
             rounding, 2^-7 of the largest |output|), and both vs an f64
             computation, at the serving shape [4, 32, 512, 112] causal
             in f32 and bf16, gemma2-2b's local layer (H=8, KV=4, hd=256,
             S=8192, window 4096, softcap 50) in f32 and bf16, a ragged
             S=1000 and a non-causal grouped Sq=256 < Skv=1024; times
             against the larger of the bytes and the operations bound (at
             the rate of the route the kernel takes: f32 as 3xTF32 on the
             tensor cores, 495/3 TFLOP/s, bf16 989 TFLOP/s), and SDPA
             where one call computes the same function (its kernels named
             from a profile); each instantiation's registers, spills and
             shared memory, and a check of the library's SASS that the
             f32 route issues TF32 and the bf16 route bf16 MMAs
  ssm_scan   kernel vs plain version (y and final state, tolerance 1e-4) at
             the serving shape (B=4, S=512, D=7168, N=64, Mamba-2's
             per-head decay unexpanded), a Mamba-1 shape (S=2048, D=8192,
             N=16, full decay), ragged sizes and a non-zero state0; times
             against the bytes bound
  theorem1   d=20, m=8, K=10, eta=2e-4, 1000 rounds through the kernel in
             f64 on the committed JAX fixture: final gap < 1e-18, steady
             linear rate, per-round gaps within rtol 1e-5 of JAX's
  sec51      the paper's Sec 5.1 scale (d=50, n=500, m=20, K=20, eta=1e-4,
             750 rounds): FedGDA-GT's gap < 1e-8 x Local SGDA's and GDA's
  prop1      Appendix C toy: Local SGDA (K=10, eta=1e-3) reaches the
             closed-form fixed point, where the Prop 1 residual vanishes;
             K=1 GDA (eta=0.1) reaches the minimax point 3.3
  compressed_claims
             the compressed fixture runs through the kernels: per-round
             gaps within rtol 1e-5 of JAX's (Theorem 1 problem, 300
             rounds; d=6 quadratic, 1000 rounds) and the JAX package's
             claims (error feedback tightens the floor tenfold, 8-bit
             floor < 1e-4, the others < 1e-1)
  main_path  d=4096, n=8192, m=16 in f64 (G is 2.1 GB), K=10, 10 rounds,
             eta = 1/lambda_max: iterates through the kernel equal those
             through the plain default_update bit for bit, and the kernel
             launches exactly rounds*(K-1)*2 times
  profile    device time by kernel over one main-path round, and the
             device's busy share of it
  compressed_main_path
             the same problem, 10 rounds each of (a) CompressedGT top-k
             0.1 with error feedback (compress_correction) and (b)
             QuantizedGT 8-bit top-k 0.25 over the packed wire
             (pack_payload / unpack_payload): iterates equal the
             use_kernel=False run's bit for bit, each kernel launches
             exactly rounds x 2 times, the gap falls, and the PackedTree
             moves exactly the LeafSpec price
  compressed_profile
             device time by kernel over one round of (b)
  fig2       the paper's Sec 5.2 at its own size (d=20, n=100, m=10,
             K=10, T=800, alpha 1, 5, 20) through the port's Fig 2 driver
             (`FederatedRunner` over JAX's data), one alpha after
             another: FedGDA-GT, Local SGDA and centralized projected GDA
             (K=1, T*K rounds); x every 10th round and the robust losses against
             JAX's (ROBUST_X_RTOL, ROBUST_LOSS_RTOL), the claims of
             tests/test_paper_claims.py:260 and :286, gt_update launches
             T*(K-1)*2 an alpha; prints the reference's table
  agnostic   Appendix A.2 on JAX's data (M=5, dim 8, n=80, shift 4, K=5,
             eta=2e-3, 1500 rounds): lambda on the simplex, the worst
             agent's risk below uniform FL's, lambda and risks within
             1e-12 of JAX's
  runner_resume
             `FederatedRunner.from_strategy` with CompressedGT (top-k 0.5
             with error feedback, and rand-k 0.5, which carries a key) on
             the Theorem 1 problem: 20 rounds checkpointed every 10 against
             10 rounds, `restore_checkpoint`, 10 more: x, y, feedback
             buffers and key bitwise equal, through the kernels
  robust_main_path
             robust regression from the port's generator at d=n=4096,
             m=16, alpha 5, f64 (a is 2.15 GB), FedGDA-GT K=10 for 10
             rounds through `FederatedRunner`, eta = 0.1/lambda_max:
             iterates through the kernel equal default_update's bit for
             bit, 180 gt_update launches; ms per round, peak memory and
             the device's busy share under the profiler
  serve      zamba2-7b at full width and depth in f32 (6.48 B parameters):
             seed 0, batch 4, prompt 512, 32 tokens (a prefill and 31
             greedy decode steps) through `repro_torch.launch.serve`, then
             the same prompts and tokens teacher-forced through the plain
             versions: every logit finite; exactly 13 flash_attention and
             81 ssm_scan launches per prefill and none in decode.  The
             random 81-layer model amplifies f32-level differences ~1e4
             times (so does JAX's at 81 layers: tests/test_torch_models.py
             test_full_depth_zamba2_matches_jax_within_its_own_sensitivity),
             so at full depth the kernels' logits may differ from the
             plain path's by no more than the plain path's own differ
             when the embeddings are perturbed by 1e-6 (relative), the
             least over three perturbation seeds; at full width cut to 6
             layers (one shared block) they agree within 1e-4 of max
             |logit|
  serve_profile
             device time by kernel over one prefill and one decode step,
             and the device's busy share of each
  kernels    one entry per ported kernel (launches on its main path, error
             against the plain version, times and bound at the main
             path's shapes)
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL_GAP_RTOL = 1e-5        # per-round gap vs JAX, on rounds with gap > 1e-14
#: rounds of the fixture runs, cut from the fixtures' lengths to keep the
#: whole script near half its 1200 s limit on a one-card machine; every
#: gap reaches its floor well before (JAX's trajectories: Theorem 1 by
#: round 500, Sec 5.1 FedGDA-GT by 500, the compressed floors by 750 on
#: the d=6 quadratic and by 250 on the Theorem 1 problem)
THEOREM1_ROUNDS = 1000   # of 4000
SEC51_ROUNDS = 750       # of 1500
COMPRESSED_ROUNDS = {"thm1": 300, "quad6": 1000}  # of 500 and 1500
#: the large leaf of the compressed-correction kernel timings: 256 MB per
#: f32 operand
LARGE = (16384, 4096)
#: the CUDA sources the port builds (src/repro_torch/kernels/csrc/<name>.cu)
KERNEL_SOURCES = ("gt_update", "compress_correction", "pack_payload",
                  "flash_attention", "ssm_scan")
#: H100 SXM dense peak rates by input type (data sheet): f32 outside the
#: tensor cores, bf16 on them; the bound of the model kernels' operations
PEAK_FLOPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
#: the flash kernel's operations bound, by the route it takes: f32 inputs
#: run as 3xTF32 on the tensor cores (three TF32 products at 495 TFLOP/s
#: per f32-accurate product), bf16 as bf16 products
FLASH_PEAK_FLOPS_PER_S = {"torch.float32": 495e12 / 3, "torch.bfloat16": 989e12}
#: the tensor-core instruction each flash route must compile to (SASS)
FLASH_MMA = {"float": "HMMA.1688.F32.TF32", "__nv_bfloat16": "HMMA.16816.F32.BF16"}
#: the model kernels against their plain versions: f32 sums taken in
#: another order (rtol = atol); both compute a bf16 case in f32 and round
#: once, so a bf16 output may differ by one unit in the last place, at
#: most 2^-7 of the largest |output|
FLASH_TOL_F32 = 1e-5
FLASH_REL_BF16 = 2.0 ** -7
SCAN_TOL = 1e-4
#: the serving path's logits against the plain path's, relative to the
#: largest |logit|, at full width cut to 6 layers.  At all 81 layers the
#: randomly initialised model amplifies f32-level differences ~1e4-fold
#: (a 1e-6 perturbation of the embeddings reaches 1e-2 of max |logit|),
#: so there the kernels are held to what such a perturbation does
SERVE_CUT_TOL = 1e-4
PERTURB_REL = 1e-6
PERTURB_SEEDS = (2, 3, 4)
#: Fig 2's iterates against JAX's (largest ||dx|| / ||x|| over the stored
#: rounds).  Where y reaches the unit ball's boundary (alpha 1 and 5) the
#: reference's `l2_ball_proj` scales by a norm summed in f32, whose order
#: XLA and torch choose differently: ~6e-8 of the scale per projection;
#: 3.65e-8 of x measured on the H100, 4.3e-8 on the CPU
#: (tests/test_torch_robust_regression.py holds the same runs with an f64
#: norm to 1e-12).  At alpha 20 y stays inside the ball and all arithmetic
#: is f64: 1.1e-14 measured on the H100, 5e-14 on the CPU
ROBUST_X_RTOL = {1.0: 2e-7, 5.0: 2e-7, 20.0: 1e-10}
#: the robust losses: each runs 2000 projected-ascent steps to the ball's
#: boundary, through the same f32 norm (9.9e-8 measured on the H100)
ROBUST_LOSS_RTOL = 3e-7
AGNOSTIC_RTOL = 1e-12
#: the serve phase's run of `python -m repro_torch.launch.serve`
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = "zamba2-7b", 4, 512, 32


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
    paths = _build.build(*KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
               if "registers" in ln or "spill" in ln][:16]
        for name in KERNEL_SOURCES
    }
    return {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "kernel_build_s": build_s,
        "libraries": {k: str(p.relative_to(ROOT)) for k, p in paths.items()},
        "ptxas": ptxas,
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


# ------------------------------------------ compressed-correction kernels
IVIEW_BYTES = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}
ENCODINGS = ("quant", "quant_dense", "sparse", "dense")
#: bit-packing needs bits < 32
PACK_CASES = [(enc, b) for enc in ENCODINGS for b in (2, 4, 8, 16, 32)
              if b < 32 or not enc.startswith("quant")]


def dtypes_of(torch) -> dict:
    return {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
            "fp8": torch.float8_e4m3fn}


def bitwise(torch, a, b) -> bool:
    """a and b are the same bits (NaN payloads included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = getattr(torch, IVIEW_BYTES[a.element_size()])
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def max_abs_err(torch, got, want) -> float:
    """max |got - want| over float outputs (NaN against NaN counts 0);
    inf where an integer output or a NaN position differs."""
    err = 0.0
    for g, w in zip(got, want):
        if not g.is_floating_point() or g.element_size() == 1:
            if not bitwise(torch, g, w):
                return float("inf")
            continue
        gd, wd = g.double(), w.double()
        d = torch.where(torch.isnan(gd) & torch.isnan(wd), 0.0, (gd - wd).abs())
        d = torch.nan_to_num(d, nan=float("inf"))
        if d.numel():
            err = max(err, float(d.max()))
    return err


def make_leaf(torch, R, C, dt, feedback, seed, nan_every=0, udt=None):
    """One correction leaf on the card: c with a row of ties and an
    all-zero row, optional feedback, f64 (or udt) uniforms."""
    from repro_torch.kernels import ref

    udt = udt or torch.float64
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    scale = 50.0 if dt == "fp8" else 100.0
    c = torch.randn(R, C, generator=gen, device=DEVICE, dtype=torch.float64) * scale
    c[0, : min(5, C)] = 3.0
    if R > 1:
        c[1] = 0.0
    if nan_every:
        c[-1, ::nan_every] = float("nan")
    c = ref.cast_to(c, dtypes_of(torch)[dt])
    e = None
    if feedback:
        e = torch.randn(R, C, generator=gen, device=DEVICE, dtype=torch.float64)
        e = ref.cast_to(e * (scale * 0.1), c.dtype)
    us = torch.rand(R, C, generator=gen, device=DEVICE, dtype=torch.float64).to(udt)
    ur = torch.rand(R, C, generator=gen, device=DEVICE, dtype=torch.float64).to(udt)
    return c, e, us, ur


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def compress_cases(torch):
    """(tag, leaf args, k, bits, mode) of the compress_correction matrix:
    every dtype x mode x bits x feedback at the main path's [16, 4096],
    ragged rows, rows with NaN, f32 uniforms and rows longer than shared
    memory (streamed)."""
    for dt, mode, bits, fb in itertools.product(
            dtypes_of(torch), ("topk", "randk"), (2, 4, 8, 16, 32), (True, False)):
        for k in (1, 410, 2048, 4096):
            yield f"{dt} {mode} b{bits} fb{fb} 16x4096 k{k}", (16, 4096, dt, fb, 1), k, bits, mode
    for (R, C), dt, mode, bits in itertools.product(
            [(5, 4097), (3, 1000), (2, 37)], ("f64", "f32", "bf16"),
            ("topk", "randk"), (4, 32)):
        for k in sorted({1, max(1, C // 10), C}):
            yield f"{dt} {mode} b{bits} {R}x{C} k{k}", (R, C, dt, True, 2), k, bits, mode
    for dt, mode in itertools.product(("f64", "f32", "bf16"), ("topk", "randk")):
        yield f"{dt} {mode} nan-row", (3, 1000, dt, True, 3, 3), 250, 8, mode
        yield f"{dt} {mode} f32-uniforms", (3, 1000, dt, True, 4, 0, "f32"), 250, 8, mode
    for (R, C, dt, mode) in [(4, 40000, "f64", "randk"), (2, 60000, "f32", "topk")]:
        for bits in (4, 32):
            yield f"{dt} {mode} b{bits} {R}x{C} streamed", (R, C, dt, True, 5), C // 10, bits, mode


def pack_cases(torch):
    """(tag, leaf args, k, bits, mode, encoding, index dtype) of the
    pack_payload / unpack_payload matrix, shaped as compress_cases'."""
    for dt, (enc, bits), mode in itertools.product(
            dtypes_of(torch), PACK_CASES, ("topk", "randk")):
        for j, k in enumerate((410, 1024, 4096)):
            idt = (torch.uint16, torch.int32)[j % 2]
            yield (f"{dt} {mode} b{bits} {enc} 16x4096 k{k}", (16, 4096, dt, True, 6),
                   k, bits, mode, enc, idt)
    for (R, C), dt, (enc, bits) in itertools.product(
            [(5, 4097), (3, 1000), (2, 37)], ("f64", "f32"), PACK_CASES):
        for k in sorted({1, max(1, C // 4), C}):
            yield (f"{dt} b{bits} {enc} {R}x{C} k{k}", (R, C, dt, False, 7), k, bits,
                   "topk", enc, torch.int32)
    for dt, enc, mode in itertools.product(("f64", "f32", "bf16"), ENCODINGS,
                                           ("topk", "randk")):
        yield (f"{dt} {mode} {enc} nan-row", (3, 1000, dt, True, 8, 3), 250, 8,
               mode, enc, torch.int32)
    for (R, C, dt, mode), (enc, bits) in itertools.product(
            [(4, 40000, "f64", "randk"), (2, 60000, "f32", "topk")],
            [("quant", 4), ("quant_dense", 4), ("sparse", 32), ("dense", 8)]):
        yield (f"{dt} {mode} b{bits} {enc} {R}x{C} streamed", (R, C, dt, True, 9),
               C // 10, bits, mode, enc, torch.uint16)


def _leaf_from(torch, args):
    R, C, dt, fb, seed, *rest = args
    nan_every = rest[0] if rest else 0
    udt = torch.float32 if len(rest) > 1 and rest[1] == "f32" else None
    return make_leaf(torch, R, C, dt, fb, seed, nan_every, udt)


def time_case(torch, run, plain, library, nbytes_moved, reps, plain_reps, card):
    """Times of one kernel case: CUDA-event means of the kernel, its plain
    version and the library yardstick, against the HBM bound."""
    ms = time_ms(torch, run, reps=reps)
    plain_ms = time_ms(torch, plain, reps=plain_reps, warmup=1)
    library_ms = None if library is None else time_ms(torch, library, reps=reps)
    bound_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": nbytes_moved, "bound_ms": bound_ms,
            "share_of_3.35TB_s": bound_ms / ms, "card": card}


def phase_compress_correction(torch, card: str, shared: dict) -> dict:
    from repro_torch.kernels import compress_correction_2d, ref
    from repro_torch.kernels.compress_correction import staged_in_shared_memory

    n = 0
    for tag, args, k, bits, mode in compress_cases(torch):
        c, e, us, ur = _leaf_from(torch, args)
        got = compress_correction_2d(c, e, us, ur, k=k, bits=bits, mode=mode)
        want = ref.compress_correction_ref(c, e, us, ur, k=k, bits=bits, mode=mode)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("chat", "resid")):
            check(bitwise(torch, g, w), f"compress_correction {tag}: {name} differs "
                                        "from the plain version")
        n += 1
    check(not staged_in_shared_memory(40000, torch.float64, True)
          and staged_in_shared_memory(4096, torch.float64, True),
          "compress_correction: shared-memory staging not as expected")
    timing = {}
    # (a)'s shape: [16, 4096] f64, top-k 0.1, error feedback, no quantization;
    # and a large f32 leaf, top-k and rand-k 8-bit
    for name, (R, C, dt), k, bits, mode, reps in [
            ("main", (16, 4096, "f64"), 410, 32, "topk", 200),
            ("large_topk", (*LARGE, "f32"), 410, 32, "topk", 10),
            ("large_randk8", (*LARGE, "f32"), 410, 8, "randk", 10)]:
        c, e, us, ur = make_leaf(torch, R, C, dt, True, 10)
        us_k = us if mode == "randk" else None
        ur_k = ur if bits < 32 else None
        ceff_abs = (c.to(ref.compute_dtype(c.dtype)) + e.to(ref.compute_dtype(c.dtype))).abs()
        got = compress_correction_2d(c, e, us_k, ur_k, k=k, bits=bits, mode=mode)
        want = ref.compress_correction_ref(c, e, us_k, ur_k, k=k, bits=bits, mode=mode)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, f"compress_correction {name}: max |err| {err}")
        timing[name] = {
            "shape": [R, C], "dtype": dt, "k": k, "bits": bits, "mode": mode,
            "max_abs_err": err,
            **time_case(
                torch,
                lambda: compress_correction_2d(c, e, us_k, ur_k, k=k, bits=bits, mode=mode),
                lambda: ref.compress_correction_ref(c, e, us_k, ur_k, k=k, bits=bits, mode=mode),
                lambda: torch.topk(ceff_abs, k, dim=-1),
                nbytes(c, e, us_k, ur_k) + 2 * nbytes(c), reps,
                20 if R == 16 else 3, card),
        }
        del c, e, us, ur, ceff_abs, got, want
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["compress_correction"] = timing
    return {"cases_bitwise": n, "timing": timing,
            "library": "torch.topk(|c + e|, k) (the select alone)"}


def select_rows(torch, R, C, dt, seed):
    """A leaf whose rows the staged pack's select must take apart, cycled
    over R: all equal, one exponent byte (|v| in [1, 2)), a block of ties
    below a few larger values (tied rand-k scores too), NaN every third
    column (NaN rand-k scores too), zeros and Gaussian; feedback only
    where it keeps the ties; f64 uniforms."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    f64 = dict(generator=gen, device=DEVICE, dtype=torch.float64)
    scale = 50.0 if dt == "fp8" else 100.0
    c = torch.randn(R, C, **f64) * scale
    e = torch.randn(R, C, **f64) * (scale * 0.1)
    us, ur = torch.rand(R, C, **f64), torch.rand(R, C, **f64)
    big = max(1, C // 10)
    kinds = torch.arange(R, device=DEVICE) % 6
    c[kinds == 0], us[kinds == 0] = 2.5, 0.5
    c[kinds == 1] = 1.0 + torch.rand(int((kinds == 1).sum()), C, **f64)
    two = kinds == 2
    c[two] = torch.rand(int(two.sum()), C, **f64) - 2.0
    c[two.nonzero()[:, None], torch.arange(0, C, 3, device=DEVICE)] = 7.0
    us[two.nonzero()[:, None], torch.arange(0, C, 3, device=DEVICE)] = 0.75
    c[two.nonzero()[:, None], torch.arange(big, device=DEVICE)] = 50.0
    three = (kinds == 3).nonzero()[:, None]
    c[three, torch.arange(0, C, 3, device=DEVICE)] = float("nan")
    us[three, torch.arange(0, C, 3, device=DEVICE)] = float("nan")
    c[kinds == 4] = 0.0
    e[(kinds == 0) | (kinds == 1) | (kinds == 2) | (kinds == 4)] = 0.0
    dtype = dtypes_of(torch)[dt]
    return ref.cast_to(c, dtype), ref.cast_to(e, dtype), us, ur


def pack_select_cases(torch, sms: int):
    """(tag, leaf, k, bits, mode, encoding, index dtype, shifted) of the
    staged pack's own matrix: select rows at odd lengths (rows starting
    off a vector boundary) in every dtype, more rows than twice the SMs
    (the 256-thread CTAs; fewer take 512) and operands one element off an
    aligned base (scalar accesses)."""
    payloads = [("quant", 8), ("quant_dense", 4), ("sparse", 32), ("dense", 2)]
    for dt, mode, C in itertools.product(dtypes_of(torch), ("topk", "randk"),
                                         (37, 1001, 4097)):
        for j, k in enumerate(sorted({1, C // 3, C - 1, C})):
            for enc, bits in payloads:
                yield (f"{dt} {mode} {enc} select-rows 6x{C} k{k}", (6, C, dt, C), k,
                       bits, mode, enc, (torch.int32, torch.uint16)[j % 2], False)
    R = 2 * sms + 7
    for dt, mode, enc in itertools.product(("f64", "f32", "bf16"), ("topk", "randk"),
                                           ENCODINGS):
        bits = 32 if enc == "sparse" else 8
        yield (f"{dt} {mode} {enc} {R}x4096", (R, 4096, dt, 3), 1024, bits, mode, enc,
               torch.uint16, False)
        yield (f"{dt} {mode} {enc} 5x1000 shifted", (5, 1000, dt, 5), 250, bits, mode,
               enc, torch.int32, True)


def shifted(torch, t):
    """A contiguous copy of t one element past an aligned base."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def pack_kernel_report() -> list:
    """Each staged `pack_kernel` instantiation's registers, spills and
    static shared memory (the ptxas report of this process's build)."""
    import re

    from repro_torch.kernels import _build

    names = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "fp8"}
    out = []
    for u in _build.ptxas_usage("pack_payload"):
        m = re.search(r"11pack_kernelI(d|f|13__nv_bfloat16|13__nv_fp8_e4m3)(d|f)(d|f)Li(\d+)E",
                      u["function"])
        if m:
            out.append({"c": names[m.group(1)], "uniforms": names[m.group(3)],
                        "threads": int(m.group(4)), "registers": u.get("registers"),
                        "spill_store_bytes": u.get("spill_store_bytes"),
                        "spill_load_bytes": u.get("spill_load_bytes"),
                        "static_smem_bytes": u.get("static_smem_bytes")})
    return out


def device_ms_per_call(torch, run, kernel: str, calls: int = 50) -> float:
    """Device time of `kernel` per call of run(), from the profiler (None
    if the profiler saw no such kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = [getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
          for ev in prof.key_averages()
          if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    return sum(us) / 1e3 / calls if us else None


def phase_pack_payload(torch, card: str, shared: dict) -> dict:
    from repro_torch.kernels import pack_payload_2d, ref
    from repro_torch.kernels.pack_payload import pack_staged

    n = 0
    for tag, args, k, bits, mode, enc, idt in pack_cases(torch):
        c, e, us, ur = _leaf_from(torch, args)
        kw = dict(k=k, bits=bits, mode=mode, encoding=enc, index_dtype=idt)
        got = pack_payload_2d(c, e, us, ur, **kw)
        want = ref.pack_payload_ref(c, e, us, ur, **kw)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("data", "idx", "scale", "resid")):
            check(bitwise(torch, g, w), f"pack_payload {tag}: {name} differs from "
                                        "the plain version")
        n += 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, (R, C, dt, seed), k, bits, mode, enc, idt, off in pack_select_cases(torch, sms):
        leaf = select_rows(torch, R, C, dt, seed)
        if off:
            leaf = tuple(shifted(torch, t) for t in leaf)
        kw = dict(k=k, bits=bits, mode=mode, encoding=enc, index_dtype=idt)
        got = pack_payload_2d(*leaf, **kw)
        want = ref.pack_payload_ref(*leaf, **kw)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("data", "idx", "scale", "resid")):
            check(bitwise(torch, g, w), f"pack_payload {tag}: {name} differs from "
                                        "the plain version")
        n += 1
    check(pack_staged(4096, 1024, "topk", "quant", 256, torch.float64, torch.uint16)
          and not pack_staged(60000, 15000, "topk", "quant", 3750, torch.float32),
          "pack_payload: shared-memory staging not as expected")
    timing = {}
    # (b)'s shape: [16, 4096] f64, 8-bit, top-k 0.25, quant with uint16
    # indices; and a large f32 leaf, top-k and rand-k (with u_sel)
    for name, (R, C, dt), mode, reps in [("main", (16, 4096, "f64"), "topk", 200),
                                         ("large", (*LARGE, "f32"), "topk", 10),
                                         ("large_randk8", (*LARGE, "f32"), "randk", 10)]:
        c, e, us, ur = make_leaf(torch, R, C, dt, True, 11)
        us = us if mode == "randk" else None
        k = C // 4
        kw = dict(k=k, bits=8, mode=mode, encoding="quant", index_dtype=torch.uint16)
        ct = ref.compute_dtype(c.dtype)
        score = us.to(ct) if mode == "randk" else (c.to(ct) + e.to(ct)).abs()
        got = pack_payload_2d(c, e, us, ur, **kw)
        want = ref.pack_payload_ref(c, e, us, ur, **kw)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, f"pack_payload {name}: max |err| {err}")
        run = lambda: pack_payload_2d(c, e, us, ur, **kw)
        timing[name] = {
            "shape": [R, C], "dtype": dt, "k": k, "bits": 8, "mode": mode,
            "encoding": "quant", "max_abs_err": err,
            "threads_per_cta": 256 if R >= 2 * sms else 512,
            **time_case(
                torch, run, lambda: ref.pack_payload_ref(c, e, us, ur, **kw),
                lambda: torch.topk(score, k, dim=-1),
                nbytes(c, e, us, ur, *got), reps, 20 if R == 16 else 3, card),
        }
        if name == "main":
            # wall per call (back-to-back calls, CUDA events) against the
            # kernel's own device time: their difference is the host's
            dev = device_ms_per_call(torch, run, "pack_kernel")
            timing[name].update(device_ms_per_call=dev, host_ms_per_call=(
                None if dev is None else timing[name]["ms"] - dev))
        if name != "large_randk8":
            shared.setdefault("payloads", {})[name] = (want[:3], C, c.dtype, k)
        del c, e, us, ur, score, got, want
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["pack_payload"] = timing
    return {"cases_bitwise": n, "timing": timing, "pack_kernel": pack_kernel_report(),
            "library": "torch.topk(score, k) (the select alone; score = |c + e| "
                       "for top-k, u_sel for rand-k)"}


def phase_unpack_payload(torch, card: str, shared: dict) -> dict:
    from repro_torch.kernels import ref, unpack_payload_2d

    n = 0
    for tag, args, k, bits, mode, enc, idt in pack_cases(torch):
        c, e, us, ur = _leaf_from(torch, args)
        payload = ref.pack_payload_ref(c, e, us, ur, k=k, bits=bits, mode=mode,
                                       encoding=enc, index_dtype=idt)[:3]
        dk = dict(cols=c.shape[1], dtype=c.dtype, k=k, bits=bits, encoding=enc)
        got = unpack_payload_2d(*payload, **dk)
        want = ref.decode_payload_ref(*payload, **dk)
        torch.cuda.synchronize()
        check(bitwise(torch, got, want), f"unpack_payload {tag}: differs from the "
                                         "plain version")
        n += 1
    timing = {}
    for name, reps in (("main", 200), ("large", 10)):
        payload, C, dtype, k = shared["payloads"][name]
        dk = dict(cols=C, dtype=dtype, k=k, bits=8, encoding="quant")
        got = unpack_payload_2d(*payload, **dk)
        want = ref.decode_payload_ref(*payload, **dk)
        err = max_abs_err(torch, (got,), (want,))
        check(err == 0.0, f"unpack_payload {name}: max |err| {err}")
        timing[name] = {
            "shape": [payload[0].shape[0], C], "dtype": str(dtype), "k": k,
            "bits": 8, "encoding": "quant", "max_abs_err": err,
            # no single PyTorch call unpacks bit-packed levels
            **time_case(torch, lambda: unpack_payload_2d(*payload, **dk),
                        lambda: ref.decode_payload_ref(*payload, **dk), None,
                        nbytes(*payload, got), reps, 20 if name == "main" else 3,
                        card),
        }
        del got, want
    shared.pop("payloads")
    torch.cuda.empty_cache()
    shared.setdefault("timing", {})["unpack_payload"] = timing
    return {"cases_bitwise": n, "timing": timing}


def _kernel_fns() -> dict:
    from repro_torch import kernels

    return {"gt_update": kernels.gt_update,
            "compress_correction": kernels.compress_correction_2d,
            "pack_payload": kernels.pack_payload_2d,
            "unpack_payload": kernels.unpack_payload_2d,
            "flash_attention": kernels.flash_attention,
            "ssm_scan": kernels.ssm_scan}


def kernel_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def zero_counts() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0


# ------------------------------------------------- the model kernels
def attention_pairs(np, Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep (tile-index positions): the work
    this run's data needs."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cases(torch):
    """(tag, B, H, KV, Sq, Skv, hd, dtype, causal, window, softcap): the
    serving shape first (zamba2-7b's shared block at prefill), the same in
    bf16, gemma2-2b's local layer at 8k in f32 and bf16, a ragged length
    and a non-causal grouped Sq < Skv."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("serve_zamba2", 4, 32, 32, 512, 512, 112, f32, True, 0, 0.0),
        ("serve_zamba2_bf16", 4, 32, 32, 512, 512, 112, bf16, True, 0, 0.0),
        ("gemma2_local_f32", 1, 8, 4, 8192, 8192, 256, f32, True, 4096, 50.0),
        ("gemma2_local_bf16", 1, 8, 4, 8192, 8192, 256, bf16, True, 4096, 50.0),
        ("ragged_1000", 2, 16, 16, 1000, 1000, 112, f32, True, 0, 0.0),
        ("noncausal_gqa", 2, 8, 2, 256, 1024, 64, f32, False, 0, 0.0),
    ]


def flash_build_report(torch) -> dict:
    """Each flash instantiation's registers, spills and shared memory (the
    ptxas report of this process's build and the kernel's plan), and the
    tensor-core instructions its SASS holds (`cuobjdump -sass`): the f32
    route must issue TF32 MMAs, the bf16 route bf16 MMAs."""
    import re
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import plan

    def tiling(fn):  # flash_kernel<float | __nv_bfloat16, Tiling<T, HDP, BK, NS>>
        m = re.search(r"flash_kernelI(f|13__nv_bfloat16)NS_6TilingI(?:f|S\d*_|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)ELi(\d+)E", fn)
        if not m:
            return None
        dt = "float" if m.group(1) == "f" else "__nv_bfloat16"
        return dt, int(m.group(2)), int(m.group(3)), int(m.group(4))

    report = {}
    for u in _build.ptxas_usage("flash_attention"):
        t = tiling(u["function"])
        if t is None:
            continue
        dt, hdp, bk, ns = t
        tdt = torch.float32 if dt == "float" else torch.bfloat16
        report[f"{dt}/hd{hdp}"] = {
            "keys_per_tile": bk, "stages": ns, "registers": u.get("registers"),
            "spill_store_bytes": u.get("spill_store_bytes"),
            "spill_load_bytes": u.get("spill_load_bytes"),
            "smem_bytes": plan(hdp, tdt)["smem_bytes"]}
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"flash_attention: cuobjdump failed: {sass.stderr[-500:]}")
    mma, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = tiling(m.group(1))
            if fn is not None:
                mma[fn] = {}
            continue
        m = re.search(r"\b(HMMA\.\S+)", line)
        if fn is not None and m:
            op = m.group(1).rstrip(";")
            mma[fn][op] = mma[fn].get(op, 0) + 1
    check(len(mma) > 0, "flash_attention: no flash_kernel in the library's SASS")
    for (dt, hdp, _, _), ops in mma.items():
        check(ops.get(FLASH_MMA[dt], 0) > 0 and set(ops) == {FLASH_MMA[dt]},
              f"flash_attention {dt}/hd{hdp}: tensor-core instructions {ops}, "
              f"want {FLASH_MMA[dt]}")
        report.setdefault(f"{dt}/hd{hdp}", {})["sass_mma"] = ops
    return report


def sdpa_kernel_names(torch, run) -> list:
    """The CUDA kernels that one call of `run` (SDPA) launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted({ev.key[:120] for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA})


def phase_flash_attention(torch, np, card: str, shared: dict) -> dict:
    """The flash kernel against its plain version on the card, each also
    against an f64 computation, timed with CUDA events against its bound
    (at the rate of the route it takes) and SDPA (the library yardstick,
    where one call computes the same function)."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import plan
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {"build": flash_build_report(torch)}
    for tag, B, H, KV, Sq, Skv, hd, dt, causal, window, cap in flash_cases(torch):
        q = torch.randn(B, H, Sq, hd, generator=gen, device=DEVICE).to(dt)
        k = torch.randn(B, KV, Skv, hd, generator=gen, device=DEVICE).to(dt)
        v = torch.randn(B, KV, Skv, hd, generator=gen, device=DEVICE).to(dt)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()), f"flash_attention {tag}: non-finite")
        if dt == torch.bfloat16:
            tol = FLASH_REL_BF16 * float(want.float().abs().max())
            within = err <= tol
        else:
            tol = FLASH_TOL_F32
            within = bool(torch.allclose(got, want, rtol=tol, atol=tol))
        check(within, f"flash_attention {tag}: max |err| {err:.3e} beyond {tol:.3e}")
        exact = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
        err_f64 = {"kernel": float((got.double() - exact).abs().max()),
                   "plain": float((want.double() - exact).abs().max())}
        del got, want, exact
        torch.cuda.empty_cache()
        library, why = None, "null: the softcap and the window have no SDPA argument"
        if cap == 0.0 and window == 0:
            sdpa_kw = dict(is_causal=causal, enable_gqa=KV != H)
            library = lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw)
            why = (f"torch.nn.functional.scaled_dot_product_attention("
                   f"is_causal={causal}, enable_gqa={KV != H})")
        moved = nbytes(q, k, v) + q.numel() * q.element_size()  # out = q's size
        flops = 4 * hd * B * H * attention_pairs(np, Sq, Skv, causal, window)
        t = time_case(torch, lambda: flash_attention(q, k, v, **kw),
                      lambda: ref.flash_attention_ref(q, k, v, **kw), library,
                      moved, reps=10, plain_reps=3, card=card)
        t.update(bound_from(moved, flops, FLASH_PEAK_FLOPS_PER_S[str(dt)]))
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        if library is not None:
            t["library_kernels"] = sdpa_kernel_names(torch, library)
        t.update(tag=tag, shape={"B": B, "H": H, "KV": KV, "Sq": Sq, "Skv": Skv,
                                 "hd": hd},
                 dtypes=[str(dt)], causal=causal, window=window, softcap=cap,
                 max_abs_err=err, tolerance=tol, max_abs_err_vs_f64=err_f64,
                 route="3xTF32" if dt == torch.float32 else "bf16",
                 peak_flops_per_s=FLASH_PEAK_FLOPS_PER_S[str(dt)],
                 tiling=plan(hd, dt), library=why)
        out[tag] = t
        del q, k, v
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["flash_attention"] = out
    return out


def ssm_cases():
    """(tag, B, S, H, P, N, decay, state0): the serving shape first
    (zamba2-7b's Mamba-2 at prefill, per-head decay [B, S, H, 1, 1]), a
    Mamba-1 shape (falcon-mamba-7b's d_inner and N, full decay), ragged
    sizes, and a non-zero state0."""
    return [
        ("serve_zamba2", 4, 512, 112, 64, 64, "head", False),
        ("mamba1_falcon", 1, 2048, 8192, 1, 16, "full", False),
        ("ragged", 3, 333, 101, 7, 50, "head", False),
        ("state0", 2, 256, 56, 64, 64, "head", True),
    ]


def phase_ssm_scan(torch, card: str, shared: dict) -> dict:
    """The scan kernel against its plain version (y and the final state),
    timed against the bytes bound; no single PyTorch call computes it."""
    from repro_torch.kernels import ref, ssm_scan

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    out = {}
    for tag, B, S, H, P, N, decay, with_state in ssm_cases():
        da_shape = (B, S, H, 1, 1) if decay == "head" else (B, S, H, P, N)
        da = torch.sigmoid(torch.randn(*da_shape, generator=gen, device=DEVICE))
        dbx = 0.1 * torch.randn(B, S, H, P, N, generator=gen, device=DEVICE)
        c = torch.randn(B, S, N, generator=gen, device=DEVICE)
        s0 = (torch.randn(B, H, P, N, generator=gen, device=DEVICE)
              if with_state else None)
        y, st = ssm_scan(da, dbx, c, s0)
        want_y, want_st = ref.ssm_scan_ref(da.expand(dbx.shape), dbx, c, s0)
        torch.cuda.synchronize()
        err = max(float((y - want_y).abs().max()), float((st - want_st).abs().max()))
        ok = all(bool(torch.allclose(a, b, rtol=SCAN_TOL, atol=SCAN_TOL))
                 for a, b in ((y, want_y), (st, want_st)))
        check(ok, f"ssm_scan {tag}: max |err| {err:.3e} beyond {SCAN_TOL}")
        del want_y, want_st
        moved = nbytes(da, dbx, c, s0, y, st)
        flops = 4 * B * S * H * P * N
        t = time_case(torch, lambda: ssm_scan(da, dbx, c, s0),
                      lambda: ref.ssm_scan_ref(da.expand(dbx.shape), dbx, c, s0),
                      None, moved, reps=10, plain_reps=1, card=card)
        t.update(bound_from(moved, flops, PEAK_FLOPS_PER_S["torch.float32"]))
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t.update(tag=tag, shape={"B": B, "S": S, "H": H, "P": P, "N": N},
                 da_shape=list(da_shape), dtypes=["torch.float32"],
                 state0=with_state, max_abs_err=err, tolerance=SCAN_TOL,
                 library="null: no single PyTorch call computes the scan")
        out[tag] = t
        del da, dbx, c, s0, y, st
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["ssm_scan"] = out
    return out


def bound_from(moved: int, flops: int, flops_per_s: float) -> dict:
    """The least time for the work: the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return {"flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def phase_serve(torch, card: str, shared: dict) -> dict:
    """zamba2-7b at full width and depth in f32 through the serving entry
    point (seed 0, batch 4, prompt 512, 32 tokens), then the same prompts
    and tokens, teacher-forced, through the plain versions on the same
    parameters."""
    from repro_torch.launch import serve
    from repro_torch.models import ModelParams, init_caches

    batch, prompt, n = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    argv = ["--arch", SERVE_ARCH, "--batch", str(batch), "--prompt-len",
            str(prompt), "--decode-tokens", str(n), "--seed", "0"]
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = kernel_counts()
    cfg, params = res["cfg"], res["params"]
    check(res["device"].startswith(DEVICE), f"serve ran on {res['device']}")
    want_prefill = {"flash_attention": 13, "ssm_scan": 81}
    check(want_prefill == {"flash_attention": cfg.num_layers // cfg.shared_attn_every,
                           "ssm_scan": cfg.num_layers},
          f"serve: {cfg.name}'s layout")
    check(res["launches"]["prefill"] == want_prefill,
          f"serve: prefill launched {res['launches']['prefill']}")
    check(res["launches"]["decode"] == {"flash_attention": 0, "ssm_scan": 0},
          f"serve: decode launched {res['launches']['decode']}")
    check({k: launches[k] for k in want_prefill} == want_prefill
          and all(launches[k] == 0 for k in launches if k not in want_prefill),
          f"serve: launches over the run {launches}")
    got = res["step_logits"]
    finite = bool(torch.isfinite(got).all())
    check(finite, "serve: non-finite logits through the kernels")

    def teacher_forced(model, model_cfg, use_kernel):
        caches = init_caches(model_cfg, batch, prompt + n, torch.float32, DEVICE)
        return serve.generate(model, model_cfg, res["prompts"], caches, n,
                              use_kernel=use_kernel, forced=res["tokens"])

    def rel_err(a, b):
        scale = float(b.abs().max())
        return (float((a - b).abs().max()) / scale,
                ((a - b).abs().amax(dim=(0, 2)) / scale).tolist())

    # the same tokens through the plain versions, at full depth
    plain = teacher_forced(params, cfg, False)
    want = plain["step_logits"]
    check(bool(torch.isfinite(want).all()), "serve: non-finite plain logits")
    rel, rel_by_step = rel_err(got, want)
    # how far f32-level noise carries at full depth: the plain path again,
    # every embedding entry scaled by (1 + 1e-6 z), for a few draws of z;
    # the kernels (each within ~1e-6 of its plain version) may move the
    # logits no further than the least of them
    rel_pert, rel_pert_by_step = [], []
    for seed in PERTURB_SEEDS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        with torch.inference_mode():
            noisy = params.embed * (1 + PERTURB_REL * torch.randn(
                params.embed.shape, generator=gen, device=DEVICE))
        perturbed = teacher_forced(
            ModelParams(cfg, list(params.layers), params.final_norm, noisy,
                        params.shared_attn), cfg, False)
        del noisy
        r, by_step = rel_err(perturbed["step_logits"], want)
        rel_pert.append(r)
        rel_pert_by_step.append(by_step)
        del perturbed
    check(rel <= min(rel_pert), f"serve: kernels move the logits by {rel:.3e} of "
          f"max |logit|, more than a {PERTURB_REL} input perturbation "
          f"({min(rel_pert):.3e}, the least of {len(rel_pert)})")
    # full width cut to one period of the shared block (6 layers), where
    # the noise has not grown: kernels against plain within SERVE_CUT_TOL
    cut_cfg = dataclasses.replace(cfg, num_layers=cfg.shared_attn_every)
    cut = ModelParams(cut_cfg, list(params.layers[:cut_cfg.num_layers]),
                      params.final_norm, params.embed, params.shared_attn)
    cut_k, cut_p = teacher_forced(cut, cut_cfg, True), teacher_forced(cut, cut_cfg, False)
    rel_cut, rel_cut_by_step = rel_err(cut_k["step_logits"], cut_p["step_logits"])
    check(rel_cut <= SERVE_CUT_TOL, f"serve, {cut_cfg.num_layers} layers: logits "
          f"differ from the plain path by {rel_cut:.3e} of max |logit|")
    want_cut = {"flash_attention": 1, "ssm_scan": cut_cfg.num_layers}
    check(cut_k["launches"]["prefill"] == want_cut,
          f"serve, {cut_cfg.num_layers} layers: prefill launched "
          f"{cut_k['launches']['prefill']}")
    same_argmax = float((want.argmax(-1) == res["tokens"]).float().mean())
    shared["serve"] = res
    shared["serve_launches"] = launches
    return {
        "arch": cfg.name, "batch": batch, "prompt_len": prompt,
        "decode_tokens": n, "decode_steps": res["decode_steps"], "dtype": "f32",
        "num_params": res["num_params"],
        "prefill_ms": res["prefill_ms"],
        "decode_ms_per_step": res["decode_ms_per_step"],
        "decode_tokens_per_s": res["decode_tokens_per_s"],
        "plain_prefill_ms": plain["prefill_ms"],
        "plain_decode_ms_per_step": plain["decode_ms_per_step"],
        "peak_memory_bytes": res["peak_memory_bytes"],
        "memory_before_serve_bytes": baseline,
        "launches_per_prefill": res["launches"]["prefill"],
        "launches_over_decode": res["launches"]["decode"],
        "launches_over_run": launches,
        "logits_finite": finite, "max_abs_logit": float(want.abs().max()),
        "rel_err_vs_plain": rel, "rel_err_vs_plain_by_step": rel_by_step,
        "perturbation_rel": PERTURB_REL, "perturbation_seeds": list(PERTURB_SEEDS),
        "rel_err_perturbed_plain": rel_pert,
        "rel_err_perturbed_plain_by_step": rel_pert_by_step,
        "cut_layers": cut_cfg.num_layers, "cut_rel_err_vs_plain": rel_cut,
        "cut_rel_err_by_step": rel_cut_by_step, "cut_tolerance_rel": SERVE_CUT_TOL,
        "cut_launches_per_prefill": cut_k["launches"]["prefill"],
        "plain_argmax_equals_tokens": same_argmax,
        "sample": res["tokens"][0].tolist(), "card": card,
    }


def phase_serve_profile(torch, shared: dict) -> dict:
    """Device time by kernel over one full-width prefill and one decode
    step (torch.profiler), and the device's busy share of each."""
    from repro_torch.launch import serve
    from repro_torch.models import init_caches

    res = shared["serve"]
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    names = {"flash_attention": "flash_kernel", "ssm_scan": "ssm_scan_kernel",
             "gemm": "gemm"}
    state = {}

    def run_prefill(caches):  # empty caches, as prefill requires
        with torch.inference_mode():
            logits, state["caches"] = serve.prefill(params, cfg, prompts, caches)
            state["tok"] = logits[:, -1].argmax(-1)[:, None]

    def empty_caches():
        return init_caches(cfg, prompts.shape[0], prompts.shape[1] + 2,
                           torch.float32, DEVICE)

    def run_decode():
        with torch.inference_mode():
            serve.decode(params, cfg, state["caches"], state["tok"],
                         prompts.shape[1])

    run_prefill(empty_caches())  # warm
    caches = empty_caches()
    out = {"prefill": profile_round(torch, lambda: run_prefill(caches), names)}
    out["decode_step"] = profile_round(torch, run_decode, names)
    return out


def parting_round(np, got, want, rtol: float):
    """First round where got leaves want by more than rtol (on rounds with
    gap > 1e-14), or None."""
    want = want[: len(got)]
    rel = np.abs(got - want) / np.where(want > 1e-14, want, 1.0)
    bad = np.nonzero((want > 1e-14) & (rel > rtol))[0]
    return int(bad[0]) if bad.size else None


def phase_compressed_claims(torch, np) -> dict:
    from repro_torch.fixtures import (
        QUAD6_RUNS, RUNS, THM1_RUNS, compressed_run_gaps, load_compressed_rounds)

    fix = load_compressed_rounds()
    out, final = {}, {}
    for which, runs in (("thm1", THM1_RUNS), ("quad6", QUAD6_RUNS)):
        for run in runs:
            zero_counts()
            t0 = time.perf_counter()
            gap = compressed_run_gaps(run, which, DEVICE,
                                      rounds=COMPRESSED_ROUNDS[which])
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            want = fix[f"{which}_{run}_gap"][: len(gap)]
            sel = want > 1e-14
            err = float(np.max(np.abs(gap[sel] - want[sel]) / want[sel]))
            part = parting_round(np, gap, want, TOL_GAP_RTOL)
            wire = RUNS[run][1].get("wire_transport", False)
            used = (counts["pack_payload"] and counts["unpack_payload"]) if wire \
                else counts["compress_correction"]
            check(used, f"compressed_claims {which} {run}: kernels not launched "
                        f"({counts})")
            check(part is None, f"compressed_claims {which} {run}: gap parts from "
                                f"JAX's at round {part}: {gap[part]!r} vs "
                                f"{want[part]!r}")
            out[f"{which}_{run}"] = {
                "final_gap": float(gap[-1]), "jax_final_gap": float(want[-1]),
                "max_rel_err_vs_jax": err, "rounds": len(gap) - 1,
                "ms_per_round": wall / (len(gap) - 1) * 1e3, "launches": counts}
            final[f"{which}_{run}"] = (float(gap[0]), float(gap[-1]))
    q = {k[len("quad6_"):]: v for k, v in final.items() if k.startswith("quad6_")}
    claims = {
        "cgt_error_feedback_tenfold": q["cgt_topk_ef"][1] < q["cgt_topk_noef"][1] / 10,
        "qgt_error_feedback_tenfold": q["qgt4_topk_wire"][1] < q["qgt4_topk_noef"][1] / 10,
        "qgt8_floor_below_1e-4": q["qgt8"][0] > 1e2 and q["qgt8"][1] < 1e-4,
    }
    for run in ("cgt_topk_ef", "cgt_randk", "qgt4_half_topk", "qgt4_half_randk"):
        claims[f"{run}_below_1e-1"] = q[run][0] > 1e2 and q[run][1] < 1e-1
    for name, ok in claims.items():
        check(ok, f"compressed_claims: claim {name} fails")
    return {"runs": out, "claims": claims, "tolerance": TOL_GAP_RTOL,
            "cut": "300 of the fixture's 500 rounds (Theorem 1 problem), 1000 "
                   "of 1500 (d=6; the claims are checked at round 1000)"}


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
    from repro_torch.fixtures import fixture_problem
    from repro_torch.kernels import gt_update

    prob = fixture_problem("thm1", DEVICE)[0]
    rnd = core.make_fedgda_gt_round(prob.loss, 10, 2e-4)
    gt_update.launches = 0
    t0 = time.perf_counter()
    gap = run_gaps(torch, core, prob, rnd, THEOREM1_ROUNDS)
    wall = time.perf_counter() - t0
    launches = gt_update.launches
    seg = gap[(gap > 1e-14) & (gap < 1e2)]
    rates = np.diff(np.log(seg))
    want = fix["thm1_gap"][: len(gap)]
    err = trajectory_error(np, gap, want)
    check(launches == THEOREM1_ROUNDS * 9 * 2, f"theorem1: {launches} kernel launches")
    check(gap[-1] < 1e-18, f"theorem1: final gap {gap[-1]:.3e} >= 1e-18")
    check(bool(np.all(rates < 0)), "theorem1: a log-gap rate is not negative")
    check(np.std(rates) < 0.25 * abs(np.mean(rates)), "theorem1: rate not steady")
    check(err <= TOL_GAP_RTOL, f"theorem1: gap off JAX's by {err:.3e} relative")
    return {
        "rounds": THEOREM1_ROUNDS, "cut": "1000 of the fixture's 4000 rounds",
        "final_gap": float(gap[-1]), "jax_final_gap": float(want[-1]),
        "mean_log_rate": float(np.mean(rates)), "rate_std": float(np.std(rates)),
        "max_rel_err_vs_jax": err, "tolerance": TOL_GAP_RTOL,
        "gt_update_launches": launches, "wall_s": wall,
        "ms_per_round": wall / THEOREM1_ROUNDS * 1e3,
    }


def phase_sec51(torch, np, fix: dict) -> dict:
    from repro_torch import core
    from repro_torch.fixtures import fixture_problem

    prob = fixture_problem("sec51", DEVICE)[0]
    eta, K, T = 1e-4, 20, SEC51_ROUNDS
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
    err = trajectory_error(np, gaps["gt"], fix["sec51_gap"][: T + 1])
    check(final["gt"] < 1e-8 * final["ls"], f"sec51: gt {final['gt']:.3e} vs ls {final['ls']:.3e}")
    check(final["gt"] < 1e-8 * final["gda"], f"sec51: gt {final['gt']:.3e} vs gda {final['gda']:.3e}")
    check(err <= TOL_GAP_RTOL, f"sec51: gt gap off JAX's by {err:.3e} relative")
    return {"rounds": T, "cut": "750 of the fixture's 1500 rounds",
            "final_gap": final, "gt_max_rel_err_vs_jax": err,
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
                  data=prob.agent_data, x0=x0, problem=prob, eta=eta,
                  minimax=(xs, ys), K=K)

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


def profile_round(torch, run_round, kernel_names) -> dict:
    """Device time by kernel over one round (torch.profiler); busy share =
    summed kernel time over the round's wall time, both under the
    profiler.  `kernel_names` maps a report key to a substring of the
    CUDA kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_round()
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
    if not kernels:
        return {"device_time": "not measured (the profiler saw no CUDA kernel)",
                "round_wall_ms": wall_ms}
    out = {"round_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms}
    for key, sub in kernel_names.items():
        ms = sum(k["ms"] for k in kernels if sub in k["name"])
        out[f"{key}_ms"] = ms
        out[f"{key}_share_of_busy"] = ms / busy_ms
    out.update(kernel_launches=sum(k["count"] for k in kernels), top=kernels[:10])
    return out


def phase_profile(torch, shared: dict) -> dict:
    """One main-path round (FedGDA-GT through gt_update) under the profiler."""
    rnd, data, x0 = shared["round"], shared["data"], shared["x0"]
    return profile_round(torch, lambda: rnd(x0, x0, data),
                         {"gt_update": "gt_update_kernel"})


def phase_compressed_main_path(torch, card: str, shared: dict, rounds: int) -> dict:
    """10 rounds of (a) CompressedGT top-k 0.1 with error feedback and (b)
    QuantizedGT 8-bit top-k 0.25 over the packed wire, on the main path's
    problem, through the kernels and through their plain versions."""
    from repro_torch import core
    from repro_torch.fed import CompressedGT, LeafSpec, PackedTree, QuantizedGT
    from repro_torch.fed.transport import measured_bytes_per_round

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m, dim = prob.agent_data, prob.num_agents, x0.shape[0]

    def record(x, y):
        return {"x": x, "y": y,
                "gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)}

    runs = {
        "a_compressed_topk": (CompressedGT(compression_ratio=0.1, mode="topk"),
                              {"compress_correction": 2 * rounds,
                               "pack_payload": 0, "unpack_payload": 0}),
        "b_quantized_wire": (QuantizedGT(bits=8, ratio=0.25, mode="topk",
                                         wire_transport=True),
                             {"compress_correction": 0,
                              "pack_payload": 2 * rounds,
                              "unpack_payload": 2 * rounds}),
    }
    out = {}
    for tag, (strategy, expected) in runs.items():
        plain = dataclasses.replace(strategy, use_kernel=False)
        rnd = core.make_round(prob.loss, strategy, K, eta, explicit_state=True)
        rnd_plain = core.make_round(prob.loss, plain, K, eta, explicit_state=True)
        # one warm-up round each
        rnd(x0, x0, data, strategy.init_state(x0, x0, m))
        rnd_plain(x0, x0, data, plain.init_state(x0, x0, m))
        # the main path: counts at 0 just before, read just after
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        (_, _, st), got = core.run_strategy_rounds(
            rnd, x0, x0, data, rounds, strategy.init_state(x0, x0, m), record)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = kernel_counts()
        t0 = time.perf_counter()
        (_, _, st_plain), want = core.run_strategy_rounds(
            rnd_plain, x0, x0, data, rounds, plain.init_state(x0, x0, m), record)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same = all(torch.equal(got[k], want[k]) for k in ("x", "y")) and all(
            torch.equal(st[k].cpu(), st_plain[k].cpu()) for k in st)
        gap = got["gap"].cpu().numpy()
        check(same, f"compressed_main_path {tag}: kernel iterates differ from "
                    "the plain versions'")
        for name, n in expected.items():
            check(launches[name] == n, f"compressed_main_path {tag}: "
                  f"{launches[name]} {name} launches, expected {n}")
        check(bool(torch.isfinite(got["x"]).all() and torch.isfinite(got["y"]).all()),
              f"compressed_main_path {tag}: non-finite iterates")
        check(gap[-1] < gap[0], f"compressed_main_path {tag}: gap {gap[0]:.3e} -> "
                                f"{gap[-1]:.3e}")
        info = {"strategy": repr(strategy), "rounds": rounds, "K": K,
                "ms_per_round_kernels": kernel_s / rounds * 1e3,
                "ms_per_round_plain": plain_s / rounds * 1e3,
                "gap_first": float(gap[0]), "gap_last": float(gap[-1]),
                "bitwise_kernels_vs_plain": same, "launches": launches,
                "card": card}
        if strategy.wire_transport:
            spec = LeafSpec.build((dim,), x0.dtype, 0.25, 8, "topk")
            check(spec.encoding == "quant" and spec.index_dtype == torch.uint16,
                  f"compressed_main_path {tag}: LeafSpec {spec}")
            c = torch.randn(m, dim, dtype=x0.dtype, device=DEVICE)
            px, py, _ = strategy.transform_correction(
                c, c, strategy.init_state(x0, x0, m))
            check(isinstance(px, PackedTree), f"compressed_main_path {tag}: no wire")
            price = spec.stacked(m).wire_bytes()
            check(px.wire_bytes() == price == m * spec.wire_bytes()
                  and py.wire_bytes() == price,
                  f"compressed_main_path {tag}: wire {px.wire_bytes()} B, "
                  f"price {price} B")
            measured = measured_bytes_per_round(strategy, x0, x0, K,
                                                include_headers=False)
            check(measured == strategy.bytes_per_round(x0, x0, K),
                  f"compressed_main_path {tag}: measured {measured} B per round")
            info.update(encoding=spec.encoding, index_dtype=str(spec.index_dtype),
                        wire_bytes_per_leaf=px.wire_bytes(), price_bytes=price,
                        dense_bytes_per_leaf=m * dim * x0.element_size(),
                        bytes_per_round_per_agent=measured)
            shared["compressed_round"] = (rnd, strategy)
        out[tag] = info
    return out


def phase_compressed_profile(torch, shared: dict) -> dict:
    """One round of the wire run (b) under the profiler."""
    rnd, strategy = shared["compressed_round"]
    x0, data, m = shared["x0"], shared["data"], shared["problem"].num_agents
    st = strategy.init_state(x0, x0, m)
    return profile_round(torch, lambda: rnd(x0, x0, data, st), {
        "pack_payload": "pack_kernel", "unpack_payload": "unpack_kernel",
        "gt_update": "gt_update_kernel"})


# ----------------------------------------- the rest of the paper's claims
def robust_rel_err(np, got, want) -> float:
    """Largest ||got - want|| / ||want|| over the rows (iterates); a zero
    row of want (round 0) counts absolutely."""
    den = np.linalg.norm(want, axis=-1)
    return float(np.max(np.linalg.norm(got - want, axis=-1)
                        / np.where(den > 0, den, 1.0)))


def phase_fig2(np, card: str) -> dict:
    """Fig 2 at its own size through the port's Fig 2 driver
    (`FederatedRunner` over JAX's data), one alpha after another, each
    with its kernel counts set to 0 just before and read just after;
    against JAX's stored iterates and robust losses, and the paper's
    claims on it."""
    from repro_torch.benchmarks import fig2_robust_regression as fig2
    from repro_torch.benchmarks.common import emit as emit_table
    from repro_torch.fixtures import (
        ROBUST, ROBUST_EVERY, ROBUST_RUNS, load_robust_agnostic, robust_key)

    fix = load_robust_agnostic()
    K, T = ROBUST[3], ROBUST[4]
    out, rows = {}, []
    for alpha in fig2.ALPHAS:
        zero_counts()
        t0 = time.perf_counter()
        res = fig2.solve(alpha, DEVICE, every=ROBUST_EVERY)
        wall, launches = time.perf_counter() - t0, kernel_counts()
        rows.append(fig2.row(alpha, res))
        pre = robust_key(alpha)
        info = {"eta": res["eta"], "jax_eta": float(fix[f"{pre}_eta"]),
                "wall_s": wall, "launches": launches}
        check(abs(info["eta"] / info["jax_eta"] - 1) <= 1e-12,
              f"fig2 alpha={alpha}: eta {info['eta']!r} vs JAX's {info['jax_eta']!r}")
        for run in ROBUST_RUNS:
            r = res[run]
            x_err = robust_rel_err(np, r["snapshots"].cpu().numpy(),
                                   fix[f"{pre}_{run}_x"])
            want = float(fix[f"{pre}_{run}_robust_loss"])
            rl_err = abs(r["robust_loss"] / want - 1)
            check(x_err <= ROBUST_X_RTOL[alpha],
                  f"fig2 alpha={alpha} {run}: x off JAX's by {x_err:.3e}")
            check(rl_err <= ROBUST_LOSS_RTOL,
                  f"fig2 alpha={alpha} {run}: robust loss {r['robust_loss']!r} "
                  f"vs JAX's {want!r}")
            rounds = T * K if run == "c" else T
            info[run] = {"x_max_rel_err_vs_jax": x_err, "robust_loss": r["robust_loss"],
                         "jax_robust_loss": want, "robust_loss_rel_err": rl_err,
                         "rounds": rounds, "run_s": r["run_s"],
                         "ms_per_round": r["run_s"] / rounds * 1e3,
                         "robust_loss_s": r["robust_loss_s"]}
        check(launches["gt_update"] == T * (K - 1) * 2,
              f"fig2 alpha={alpha}: {launches['gt_update']} gt_update launches, "
              f"expected {T * (K - 1) * 2}")
        xg, xl, xc = (res[k]["x"].cpu().numpy() for k in ("gt", "ls", "c"))
        info.update(d_gt=float(np.linalg.norm(xg - xc)),
                    d_ls=float(np.linalg.norm(xl - xc)))
        out[f"alpha_{alpha:g}"] = info
    emit_table(rows, fig2.HEADER, "fig2: robust linear regression under heterogeneity")
    a1, a20 = out["alpha_1"], out["alpha_20"]
    rl = {k: a1[k]["robust_loss"] for k in ("gt", "c")}
    claims = {  # tests/test_paper_claims.py:286 at alpha 1, :260 at alpha 20
        "d_gt_below_0.2": a1["d_gt"] < 0.2,
        "d_ls_above_1": a1["d_ls"] > 1.0,
        "d_gt_below_0.15_d_ls": a1["d_gt"] < 0.15 * a1["d_ls"],
        "rl_gt_within_1pct_of_centralized": abs(rl["gt"] - rl["c"]) / rl["c"] < 0.01,
        "rl_gt_at_most_1.001_rl_ls_alpha20":
            a20["gt"]["robust_loss"] <= 1.001 * a20["ls"]["robust_loss"],
    }
    for name, ok in claims.items():
        check(ok, f"fig2: claim {name} fails")
    return {"alphas": out, "claims": claims, "table": rows,
            "x_rtol": {f"{a:g}": v for a, v in ROBUST_X_RTOL.items()},
            "robust_loss_rtol": ROBUST_LOSS_RTOL, "card": card}


def phase_agnostic(torch, np, card: str) -> dict:
    """Appendix A.2 on JAX's data (`examples/agnostic_federated.py`'s
    setup): the agnostic model against the uniform (lambda frozen) one."""
    from repro_torch import core
    from repro_torch.fed import FederatedRunner
    from repro_torch.fixtures import AGNOSTIC, fixture_problem, load_robust_agnostic
    from repro_torch.problems import per_agent_risks, uniform_lambda

    fix = load_robust_agnostic()
    dim, n, m, shift, K, eta, T = AGNOSTIC
    prob = fixture_problem("agnostic", DEVICE)[0]
    lam0 = uniform_lambda(m, device=DEVICE)
    out = {}
    for run, proj_y in (("agnostic", prob.proj_y), ("uniform", lambda y: lam0)):
        rnd = core.make_fedgda_gt_round(prob.loss, K, eta, proj_y=proj_y)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        x, lam = FederatedRunner(rnd, prob.agent_data).run(
            torch.zeros(dim, dtype=torch.float64, device=DEVICE), lam0, T)
        risks = per_agent_risks(prob, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        check(launches["gt_update"] == T * (K - 1) * 2,
              f"agnostic {run}: {launches['gt_update']} gt_update launches")
        got = {"lambda": lam.cpu().numpy(), "risks": risks.cpu().numpy(),
               "x": x.cpu().numpy()}
        errs = {k: float(np.max(np.abs(got[k] - fix[f"{run}_{k}"]))
                         / np.max(np.abs(fix[f"{run}_{k}"]))) for k in got}
        for k, e in errs.items():
            check(e <= AGNOSTIC_RTOL, f"agnostic {run}: {k} off JAX's by {e:.3e}")
        check(bool(np.all(np.isfinite(got["x"]))), f"agnostic {run}: non-finite x")
        out[run] = {"lambda": got["lambda"].tolist(), "risks": got["risks"].tolist(),
                    "max_rel_err_vs_jax": errs, "wall_s": wall,
                    "ms_per_round": wall / T * 1e3, "launches": launches}
    lam = np.asarray(out["agnostic"]["lambda"])
    worst = {k: max(out[k]["risks"]) for k in out}
    spread = {k: max(out[k]["risks"]) - min(out[k]["risks"]) for k in out}
    check(abs(lam.sum() - 1.0) <= 1e-8 and lam.min() >= -1e-12,
          f"agnostic: lambda {lam} off the simplex")
    check(worst["agnostic"] <= 1.01 * worst["uniform"],
          f"agnostic: worst risk {worst}")
    check(spread["agnostic"] <= spread["uniform"] + 1e-9, f"agnostic: spread {spread}")
    return {"runs": out, "worst_risk": worst, "risk_spread": spread,
            "rtol": AGNOSTIC_RTOL, "rounds": T, "K": K, "card": card}


def phase_runner_resume(torch, card: str) -> dict:
    """A stateful `FederatedRunner.from_strategy` run checkpointed at
    round 10 and resumed equals the uninterrupted run, bit for bit."""
    import shutil

    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
    from repro_torch.fed import FederatedRunner, resolve_strategy
    from repro_torch.fixtures import RUNS, fixture_problem

    prob = fixture_problem("thm1", DEVICE)[0]
    K, eta, dim = 10, 2e-4, prob.agent_data["Ab"].shape[1]
    x0 = torch.zeros(dim, dtype=torch.float64, device=DEVICE)
    base = ROOT / "build" / "chip_smoke_checkpoints"
    out = {}
    for run in ("cgt_topk_ef", "cgt_randk"):
        name, kw = RUNS[run]
        shutil.rmtree(base, ignore_errors=True)

        def runner(sub=None):
            return FederatedRunner.from_strategy(
                prob.loss, resolve_strategy(name, **kw), prob.agent_data, K, eta,
                checkpoint_dir=None if sub is None else str(base / sub),
                checkpoint_every=0 if sub is None else 10)

        zero_counts()
        full = runner("full")
        xf, yf = full.run(x0, x0, 20)
        runner("part").run(x0, x0, 10)
        step, path = latest_checkpoint(str(base / "part"))
        ck = restore_checkpoint(path, DEVICE)
        resumed = runner()
        xr, yr = resumed.run(ck["x"], ck["y"], 10, state=ck["strategy_state"])
        torch.cuda.synchronize()
        launches = kernel_counts()
        saved = restore_checkpoint(latest_checkpoint(str(base / "full"))[1], DEVICE)
        sf, sr = full._state, resumed._state
        same = {
            "x": torch.equal(xf, xr), "y": torch.equal(yf, yr),
            **{k: torch.equal(sf[k].cpu(), sr[k].cpu()) for k in sf},
            "checkpoint_20": torch.equal(saved["x"], xf) and all(
                torch.equal(saved["strategy_state"][k].cpu(), sf[k].cpu()) for k in sf),
        }
        check(step == 10, f"runner_resume {run}: latest checkpoint at {step}")
        check(all(same.values()), f"runner_resume {run}: resumed != uninterrupted "
                                  f"({same})")
        check(launches["compress_correction"] == 40 * 2,
              f"runner_resume {run}: {launches['compress_correction']} "
              "compress_correction launches, expected 80")
        out[run] = {"state_keys": sorted(sf), "bitwise": same, "launches": launches,
                    "rounds": "20 uninterrupted; 10, restore, 10"}
    shutil.rmtree(base, ignore_errors=True)
    return {"runs": out, "card": card}


def robust_lambda_max(torch, a, iters: int = 30) -> float:
    """Largest eigenvalue of H = 2/(mn) sum_i A_i^T A_i + I (Fig 2's
    `_stable_eta`) by power iteration on matvecs over a [m, n, d]."""
    m, n, d = a.shape
    gen = torch.Generator(device=a.device).manual_seed(1)
    v = torch.randn(d, generator=gen, dtype=a.dtype, device=a.device)

    def hv(v):
        return 2.0 / (m * n) * torch.einsum(
            "mnd,mn->d", a, torch.einsum("mnd,d->mn", a, v)) + v

    for _ in range(iters):
        v = hv(v)
        v = v / v.norm()
    return float(v @ hv(v))


def phase_robust_main_path(torch, card: str, dim: int, samples: int,
                           agents: int, alpha: float, K: int, rounds: int) -> dict:
    """Robust regression at a width where the card works: FedGDA-GT through
    `FederatedRunner`, the kernel against default_update, under the
    profiler once."""
    from repro_torch import core
    from repro_torch.fed import FederatedRunner
    from repro_torch.problems import make_robust_regression_problem

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    prob = make_robust_regression_problem(gen, dim=dim, num_samples=samples,
                                          num_agents=agents, alpha=alpha,
                                          device=DEVICE)
    a = prob.agent_data["a"]
    eta = 0.1 / robust_lambda_max(torch, a)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x0 = torch.zeros(dim, dtype=torch.float64, device=DEVICE)
    rounds_of = {
        "kernel": core.make_fedgda_gt_round(prob.loss, K, eta, proj_y=prob.proj_y),
        "plain": core.make_fedgda_gt_round(prob.loss, K, eta, proj_y=prob.proj_y,
                                           update_fn=core.default_update),
    }
    for rnd in rounds_of.values():  # one warm-up round each
        rnd(x0, x0, prob.agent_data)
    iterates, wall, peak, launches = {}, {}, {}, {}
    for tag, rnd in rounds_of.items():
        runner = FederatedRunner(rnd, prob.agent_data)
        x, y, its = x0, x0, []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(rounds):
            x, y = runner.run(x, y, 1)
            its.append((x, y))
        torch.cuda.synchronize()
        wall[tag] = time.perf_counter() - t0
        launches[tag] = kernel_counts()
        peak[tag] = torch.cuda.max_memory_allocated()
        iterates[tag] = its
    same = all(torch.equal(u, v) for (pk, pp) in zip(iterates["kernel"], iterates["plain"])
               for u, v in zip(pk, pp))
    xk, yk = iterates["kernel"][-1]
    check(same, "robust_main_path: kernel iterates differ from default_update's")
    check(launches["kernel"]["gt_update"] == rounds * (K - 1) * 2,
          f"robust_main_path: {launches['kernel']['gt_update']} gt_update launches, "
          f"expected {rounds * (K - 1) * 2}")
    check(launches["plain"]["gt_update"] == 0, "robust_main_path: plain run launched")
    check(bool(torch.isfinite(xk).all() and torch.isfinite(yk).all()),
          "robust_main_path: non-finite iterates")
    check(float(yk.norm()) <= 1.0 + 1e-6, f"robust_main_path: |y| = {float(yk.norm())}")
    prof = profile_round(torch, lambda: rounds_of["kernel"](xk, yk, prob.agent_data),
                         {"gt_update": "gt_update_kernel"})
    return {
        "dim": dim, "num_samples": samples, "num_agents": agents, "alpha": alpha,
        "K": K, "rounds": rounds, "eta": eta, "a_bytes": a.numel() * a.element_size(),
        "setup_s": setup_s, "ms_per_round_kernel": wall["kernel"] / rounds * 1e3,
        "ms_per_round_plain_update": wall["plain"] / rounds * 1e3,
        "peak_bytes": peak, "launches": launches["kernel"],
        "bitwise_kernel_vs_plain": same, "y_norm": float(yk.norm()),
        "profile": prof, "card": card,
    }


#: the compressed-correction kernels: (source, TPU kernel it replaces,
#: the main-path run whose launches it reports, library yardstick or why
#: there is none)
COMPRESSED_KERNELS = {
    "compress_correction": (
        "src/repro_torch/kernels/csrc/compress_correction.cu",
        "src/repro/kernels/compress_correction.py:85", "a_compressed_topk",
        "torch.topk(|c + e|, k): the select alone"),
    "pack_payload": (
        "src/repro_torch/kernels/csrc/pack_payload.cu",
        "src/repro/kernels/pack_payload.py:66", "b_quantized_wire",
        "torch.topk(|c + e|, k): the select alone"),
    "unpack_payload": (
        "src/repro_torch/kernels/csrc/pack_payload.cu",
        "src/repro/kernels/pack_payload.py:141", "b_quantized_wire",
        "null: no single PyTorch call unpacks bit-packed levels"),
}


def kernel_entries(torch, launches: dict, state: dict, card: str,
                   shared: dict) -> list:
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
        "library_ms": None, "library": "null: no single PyTorch call computes "
                                       "z + s*(g + c)", "card": card,
    }] + [compressed_entry(name, shared, card) for name in COMPRESSED_KERNELS] + [
        model_entry(name, shared, card) for name in MODEL_KERNELS]


def compressed_entry(name: str, shared: dict, card: str) -> dict:
    """The kernels-line entry of one compressed-correction kernel: its
    launches on its main-path run, and its error and times at that run's
    shape ([16, 4096] f64), measured in its own phase."""
    source, replaces, run, library = COMPRESSED_KERNELS[name]
    t = shared["timing"][name]["main"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": shared["compressed"][run]["launches"][name],
        "max_abs_err": t["max_abs_err"], "tolerance": 0.0,
        "bitwise_vs_plain": t["max_abs_err"] == 0.0, "shape": t["shape"],
        "dtypes": [t["dtype"]], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": t["library_ms"], "library": library, "card": card,
    }


#: the model kernels: (source, TPU kernel it replaces); their launches
#: come from the serve run, their times from their phase's serving shape
MODEL_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:75"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:40"),
}


def model_entry(name: str, shared: dict, card: str) -> dict:
    """The kernels-line entry of a model kernel: its launches on the serve
    run (zamba2-7b, one prefill and 31 decode steps), its error and times
    at the serving shape, measured in its own phase."""
    source, replaces = MODEL_KERNELS[name]
    t = shared["timing"][name]["serve_zamba2"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": shared["serve_launches"][name],
        "max_abs_err": t["max_abs_err"], "tolerance": t["tolerance"],
        "shape": t["shape"], "dtypes": t["dtypes"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": t["library"], "card": card,
    }


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
    run("compress_correction", lambda: phase_compress_correction(torch, card, shared))
    run("pack_payload", lambda: phase_pack_payload(torch, card, shared))
    if "payloads" in shared:
        run("unpack_payload", lambda: phase_unpack_payload(torch, card, shared))
    run("flash_attention", lambda: phase_flash_attention(torch, np, card, shared))
    run("ssm_scan", lambda: phase_ssm_scan(torch, card, shared))
    run("theorem1", lambda: phase_theorem1(torch, np, fix))
    run("sec51", lambda: phase_sec51(torch, np, fix))
    run("prop1", lambda: phase_prop1(torch))
    run("compressed_claims", lambda: phase_compressed_claims(torch, np))
    run("main_path", lambda: phase_main_path(
        torch, card, shared, dim=4096, samples=8192, agents=16, K=10, rounds=10))
    if "state" in shared:
        run("profile", lambda: phase_profile(torch, shared))
        compressed = run("compressed_main_path", lambda: phase_compressed_main_path(
            torch, card, shared, rounds=10))
        if compressed is not None:
            shared["compressed"] = compressed
            run("compressed_profile", lambda: phase_compressed_profile(torch, shared))
        for key in ("problem", "data", "round", "compressed_round"):  # G: 2.1 GB
            shared.pop(key, None)
    run("fig2", lambda: phase_fig2(np, card))
    run("agnostic", lambda: phase_agnostic(torch, np, card))
    run("runner_resume", lambda: phase_runner_resume(torch, card))
    run("robust_main_path", lambda: phase_robust_main_path(
        torch, card, dim=4096, samples=4096, agents=16, alpha=5.0, K=10, rounds=10))
    torch.cuda.empty_cache()
    served = run("serve", lambda: phase_serve(torch, card, shared))
    if served is not None:
        run("serve_profile", lambda: phase_serve_profile(torch, shared))
        del shared["serve"]  # the parameters (26 GB)
        torch.cuda.empty_cache()
    if ("state" in shared and "compressed" in shared and served is not None
            and len(shared.get("timing", {})) == 5):
        kernels = run("kernels", lambda: kernel_entries(
            torch, shared["launches"], shared["state"], card, shared))
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
