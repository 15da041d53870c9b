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
card does real work, the stochastic and client-sampling rounds (SAGDA,
PartialParticipation, noisy QuantizedGT) through the same kernels with
seeded draws on the card, the rest of the paper's experiments (Fig 2's
robust regression, agnostic FL) through the `FederatedRunner` with a
checkpoint resume, the elastic client population (churn and straggler
schedules drawn on the card, membership-aware FedGDA-GT) through the same
runner and kernels, the O(active) sparse engine and the two-level pod tree
(`sim.SparseElasticEngine`, at the mega preset's 1e6-agent registry and at
the main path's width), the asynchronous runtime (agent shards on CUDA
streams of the card) and the telemetry sink on the main path, the
serving path of zamba2-7b at full width
(`python -m repro_torch.launch.serve`) with the `flash_attention` and
`ssm_scan` kernels, the other model families on that path (pixtral-12b's
vision_text frontend, llama4-scout's MoE layers, hubert-xlarge's
encoder) through `flash_attention`, and federated adversarial LM training of zamba2-7b
at full width (`repro_torch.launch.train`) through those kernels, their
backward kernels `flash_attention_bwd` and `ssm_scan_bwd`, and
`gt_update`.  Every phase prints one JSON line (fig2 also the
reference's CSV table); any failed check
exits non-zero without the final line.  The last two lines are the card's
`nvidia-smi` name and power limit, then

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

    python3 chip_smoke.py --claims 1
    python3 chip_smoke.py --claims 2

run, after setup, only the host-bound phases on JAX's numbers, which a
run without arguments leaves out to stay well inside a 1,200 s call:
`--claims 1` theorem1, sec51, prop1, compressed_claims and fig2,
`--claims 2` agnostic, stochastic_claims, elastic_claims and
sparse_claims (together 12-19 minutes on an H100, hence two calls); all
three runs end with the same two lines.

Phases (in this order, but for runner_resume and device_draws, which run
right after setup, before any profiler session slows the host; the
phases of `--claims 1` and `--claims 2` are marked so):
  setup      card, power limit, torch / CUDA versions, kernel build time
  gt_update  kernel vs plain version, bit for bit, at 2^27-2^28 elements
             (every dtype pair, both signs) and a ragged 2^20+17; the main
             path's step (x and y [16, 4096] f64 in one `pair` launch, and
             as two one-leaf calls) and zamba2-7b's training step (its 68
             leaves in one launch, and as 68 calls); wall times with CUDA
             events against the HBM bound
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
             instantiation's registers, spills and shared memory.
             compress_correction's matrix runs at the launcher's cluster
             size and again at one CTA a row, and its main shape is timed
             both ways
  kernel_device_times
             device time per call (profiler) of gt_update's main and
             training steps and compress_correction's main shape (cluster
             and one CTA a row) beside their wall times; the cluster must
             take less device time than one CTA a row
  flash_attention
             kernel vs plain version (tolerance 1e-5 in f32; in bf16 one
             rounding, 2^-7 of the largest |output|), and both vs an f64
             computation, at the serving shape [4, 32, 512, 112] causal
             in f32 and bf16, pixtral-12b's prefill [4, 32 / 8, 512, 128]
             causal and hubert-xlarge's encoder [4, 16, 512, 80]
             non-causal in f32, gemma2-2b's local layer (H=8, KV=4, hd=256,
             S=8192, window 4096, softcap 50) in f32 and bf16, a ragged
             S=1000 and a non-causal grouped Sq=256 < Skv=1024; times
             against the larger of the bytes and the operations bound (at
             the rate of the route the kernel takes: f32 as 3xTF32 on the
             tensor cores, 495/3 TFLOP/s, bf16 989 TFLOP/s), and SDPA
             where one call computes the same function (its kernels named
             from a profile); each instantiation's registers, spills and
             shared memory, and a check of the library's SASS that the
             f32 route issues TF32 and the bf16 route bf16 MMAs
  flash_attention_bwd
             the backward kernel vs autograd of the plain version (each
             gradient within 1e-4 of its max |value|, two calls bitwise
             equal, the forward bitwise unchanged by its LSE output) at
             zamba2-7b's training shape [16, 32, 128, 112] causal, gemma2-2b's
             local layer (hd 256, window 4096, softcap 50) at S 1024 and a
             GQA case; times against the operations bound (10 hd flops a
             pair at 67 TFLOP/s) and SDPA's backward without softcap or
             window
  ssm_scan   kernel vs plain version (y and final state, tolerance 1e-4) at
             the serving shape (B=4, S=512, D=7168, N=64, Mamba-2's
             per-head decay unexpanded), a Mamba-1 shape (S=2048, D=8192,
             N=16, full decay), ragged sizes and a non-zero state0; times
             against the bytes bound
  ssm_scan_bwd
             the backward kernel vs autograd of the plain version, as
             above, at zamba2-7b's training shape [16, 128, 112, 64, 64]
             (per-head decay, d da reduced in the kernel) and
             falcon-mamba-7b's Mamba-1 layout at S 2048; times against the
             bytes bound
  theorem1   [--claims 1] d=20, m=8, K=10, eta=2e-4, 1000 rounds through the kernel in
             f64 on the committed JAX fixture: final gap < 1e-18, steady
             linear rate, per-round gaps within rtol 1e-5 of JAX's
  sec51      [--claims 1] the paper's Sec 5.1 scale (d=50, n=500, m=20, K=20, eta=1e-4,
             750 rounds): FedGDA-GT's gap < 1e-8 x Local SGDA's and GDA's
  prop1      [--claims 1] Appendix C toy: Local SGDA (K=10, eta=1e-3) reaches the
             closed-form fixed point, where the Prop 1 residual vanishes;
             K=1 GDA (eta=0.1) reaches the minimax point 3.3
  compressed_claims [--claims 1]
             the compressed fixture runs through the kernels: per-round
             gaps within rtol 1e-5 of JAX's (Theorem 1 problem, 300
             rounds; d=6 quadratic, 1000 rounds) and the JAX package's
             claims (error feedback tightens the floor tenfold, 8-bit
             floor < 1e-4, the others < 1e-1)
  main_path  d=4096, n=8192, m=16 in f64 (G is 2.1 GB), K=10, 10 rounds,
             eta = 1/lambda_max: iterates through the kernel equal those
             through the plain default_update bit for bit, and the kernel
             launches exactly rounds*(K-1) times (x and y in one launch a
             local step), updating rounds*(K-1)*2 leaves
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
  fig2       [--claims 1] the paper's Sec 5.2 at its own size (d=20, n=100, m=10,
             K=10, T=800, alpha 1, 5, 20) through the port's Fig 2 driver
             (`FederatedRunner` over JAX's data), one alpha after
             another: FedGDA-GT, Local SGDA and centralized projected GDA
             (K=1, T*K rounds); x every 10th round and the robust losses against
             JAX's (ROBUST_X_RTOL, ROBUST_LOSS_RTOL), the claims of
             tests/test_paper_claims.py:260 and :286, gt_update launches
             T*(K-1) an alpha (T*(K-1)*2 leaf updates); prints the
             reference's table
  agnostic   [--claims 2] Appendix A.2 on JAX's data (M=5, dim 8, n=80, shift 4, K=5,
             eta=2e-3, 1500 rounds): lambda on the simplex, the worst
             agent's risk below uniform FL's, lambda and risks within
             1e-12 of JAX's
  runner_resume
             `FederatedRunner.from_strategy` with CompressedGT (top-k 0.5
             with error feedback, and rand-k 0.5, which carries a key) on
             the Theorem 1 problem: 20 rounds checkpointed every 10 against
             10 rounds, `restore_checkpoint`, 10 more: x, y, feedback
             buffers and key bitwise equal, through the kernels
  device_draws
             the seeded draws on the card against the port's CPU draws:
             randint (int64 and int32, spans that are and are not powers
             of 2, maxval <= minval) and permutation (16, 2000, 2^20) bit
             for bit, normal within DRAW_ULP (CUDA's log1p is another
             implementation), key batches equal to stacked single-key
             draws; the time of one noisy main-path round's draw
  stochastic_claims [--claims 2]
             on JAX's fixture data: Section 4's separation (d=10, m=6,
             K=10, eta=5e-4, 1500 rounds; noiseless SAGDA, Local SGDA,
             SAGDA at sigma 0.1 and 0.01) per round within rtol 1e-5 of
             JAX's gaps with the claim's own assertions
             (tests/test_paper_claims.py:198-256);
             PartialParticipation(0.5, seed 0) on the Theorem 1 problem
             (K=10, eta=2e-4, 500 rounds): masks bit for bit, gaps within
             rtol 1e-5; SAGDA with MinibatchNoise(0.5) on Fig 2's alpha-5
             problem (200 rounds) at the Fig 2 gate; noisy rand-k
             CompressedGT (300 rounds) within rtol 1e-5
  stochastic_main_path
             the main path's problem (d=4096, m=16, f64, K=10, 10 rounds)
             under SAGDA with Gaussian noise (sigma 0.1),
             PartialParticipation 0.5 and QuantizedGT 8-bit top-k 0.25
             over the wire with sigma 0.1: iterates and state through the
             kernels equal the plain path's bit for bit; gt_update
             100 launches over 200 leaves (noisy: no fused anchor step)
             and 90 over 180 (partial), x and y in one launch a step,
             pack / unpack 20; ms per round, the device's busy share and
             launches of a round under the profiler, and the draws' share
             of them and of the device time (one broadcast draws several
             rounds in one pass: per round is a pass over its rounds)
  elastic_claims [--claims 2]
             the elastic benchmark on JAX's fixture (m=10, d=30, K=10,
             eta=1e-4, seed 0): the four scenarios' schedules (1200
             rounds) drawn on the card equal JAX's bit for bit, and a
             chunked build (chunk 64) equals the dense one; the flaky rows
             FedGDA-GT with and without rebasing and Local SGDA at 1200
             rounds through the runner, per round within rtol 1e-5 of
             JAX's gaps above 1e-14 (the error between 1e-18 and 1e-14
             printed), with the headline: rebase reaches 1e-6 at JAX's
             round 138 and ends below 1e-18, no-rebase ends above 1e+2,
             Local SGDA never reaches 1e-6; a flaky CompressedGT run
             checkpointed at round 100 and resumed with its elastic_state
             and strategy_state equals 200 uninterrupted rounds bit for
             bit; every table row's active-set bytes equal JAX's
  sparse_claims [--claims 2]
             the O(active) engine on JAX's fixture (`sparse_rounds.npz`):
             the m=8 runs of the six families (d=16, K=5, 4 active, T=6,
             seed 0; schedules bitwise JAX's): the dense fallback bitwise
             the dense elastic runner, forced sparse within rtol 1e-8 /
             atol 1e-10 of it (QuantizedGT excepted: its rounding draws
             follow the rows), each within 1e-10 of JAX's final iterates; a
             sparse resume via tail(3) bitwise; the 4-pod engine's live
             pods and pod wire bytes JAX's; the mega preset (m = 1e6, 256
             active, 1024 pods, dim 8, K=10, T=4, per-id synthesized data,
             the tracker's init over every agent on the card) beside its
             1e4 reference: ids, budgets, live pods, pod wire bytes and
             tracker counts JAX's, iterates within 1e-9, and the memory
             gate (host peak + device peak of the 1e6 run within 1.5x the
             1e4 run's + 24 MiB), both peaks printed
  elastic_main_path
             the main path's problem (d=4096, m=16, f64, K=10, 10 rounds)
             under a flaky schedule (seed 0) through `FederatedRunner`:
             FedGDA-GT with rebasing (gt_update, 90 launches over 180
             leaves) and CompressedGT top-k 0.1 over the wire (gt_update
             100 over 200, pack /
             unpack 20), each bitwise equal to the plain path (iterates,
             state, tracker); ms and kernel launches per round beside the
             static FedGDA-GT round's, one round of each under the
             profiler; a stable round forced through the elastic round
             within 1e-12 of `make_round`'s
  sparse_main_path
             the main path's problem (G as an `ArrayDataSource`) through
             the O(active) engine, forced sparse: 8 of 16 active a round,
             uniform stragglers (0.3, 0.5), 4 pods, seed 0, 10 rounds of
             FedGDA-GT with the pod partials packed (gt_update 90 over
             180 leaves, pack_payload 20) and CompressedGT top-k 0.1 with
             EF rows realigned (gt_update 100 over 200, compress_correction
             20): bitwise
             equal to the plain path (iterates, state, tracker), within
             rtol 1e-8 / atol 1e-10 of the dense elastic runner on the
             densified schedule; ms a round beside that runner's, launches
             and host syncs a round, one profiled round, peak memory, and
             the last pod payload decoded through unpack_payload bitwise
  async_main_path
             the main path's problem (d=4096, m=16, f64, K=10, 10 rounds)
             through `AsyncFederatedRunner(devices=[cuda] * 4)`: 4 shards,
             one CUDA stream each, for FedGDA-GT (gt_update 360 launches:
             4 shards x 9 x 10, over 720 leaves), CompressedGT top-k 0.1
             over the wire (400 over 800, pack /
             unpack 20), FullSync, and FedGDA-GT under a flaky schedule
             (MarkovChurn 0.6 / 0.4, stragglers 0.3 / 0.5, seed 0) that
             skips whole shards (the shard_skipped events as the host mask
             says); each within rtol 1e-9 / atol 1e-12 of the sync runner
             in the same run, a full telemetry sink bitwise-free; ms a
             round (sync, async, async, sync), host syncs and CUDA launches
             a round, and the streams of the gt_update launches (4
             distinct, the runner's, at the launch site and in the
             profiler's trace)
  telemetry_main_path
             the sync main path with telemetry=None and with a full sink
             (probes, gap oracle, `RunLedger`, a `profile_rounds` Chrome
             trace): iterates bitwise equal, the ledger read back with
             wire_bytes = measured_bytes_per_round x m each round, the
             trace written; the sink's overhead (interleaved runs); and
             `phase_spans=True`: each phase's device ms a round, their sum
             against the fused round, iterates bitwise the fused round's
  robust_main_path
             robust regression from the port's generator at d=n=4096,
             m=16, alpha 5, f64 (a is 2.15 GB), FedGDA-GT K=10 for 10
             rounds through `FederatedRunner`, eta = 0.1/lambda_max:
             iterates through the kernel equal default_update's bit for
             bit, 90 gt_update launches over 180 leaves; ms per round,
             peak memory and
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
  serve_vlm  pixtral-12b at full width and depth in f32 (11.58 B
             parameters), seed 0, batch 4, prompt 512 (256 patches, 256
             text tokens), 32 tokens through `repro_torch.launch.serve`:
             40 flash_attention launches a prefill, none a decode step;
             the logits against the same tokens teacher-forced through
             the plain versions within max(1e-4, the least of three 1e-6
             perturbations of embed and frontend_proj), a 2-layer cut
             within 1e-4; prefill, decode, tokens/s, peak memory beside
             its prediction, a profiled prefill and decode step
  serve_moe  llama4-scout-17b-a16e at full width cut to 6 layers (13.49 B
             parameters) through `serve.generate`, as serve_vlm with its
             text prompts (6 launches a prefill; embed perturbed); every
             routing decision that differs from the plain path's a
             near-tie (top-1/top-2 gap under NEAR_TIE_GAP), the tokens
             each expert dropped at capacity 40
  encode_audio
             hubert-xlarge at full width and depth (48 layers, non-causal)
             on 4 x 512 random frames through embed_inputs, forward and
             logits_from_hidden: 48 flash_attention launches; the logits
             against the plain versions within max(1e-4, the least of
             three 1e-6 perturbations of the frames); encode ms
  train_main_path
             zamba2-7b at full width cut to 6 layers (634 M parameters),
             seed 0, 4 agents x batch 4 x seq 128, K 8, eta 2e-3, remat, 3
             FedGDA-GT rounds through `launch.train.train`: round-0
             gradients through the kernels vs the plain versions, leaf by
             leaf (1e-4 of the leaf's max |g|, or the least of three 1e-6
             embedding perturbations' effect on that leaf where larger),
             loss finite and falling, |delta| <= 1, launches a round
             exactly `train_launch_prediction`'s; ms a round, the training
             run's peak memory beside its prediction from the round-0 gate
             (agents cut to 2 before training where the prediction at 4
             passes 72 GB) and the gate's, and one profiled round
  spmd_serve (after serve_profile, on serve's parameters wrapped as DTensors
             without a copy) `examples/serve_batched`'s path, the SPMD
             prefill / decode step builders on `make_host_mesh(1, 1)` over a
             one-rank NCCL group, serve's prompts and tokens teacher-forced:
             logits bitwise `launch.serve.generate`'s, 13 flash_attention
             and 81 ssm_scan launches a prefill, none a decode step;
             prefill and decode ms (a cold run, then a warm one) beside the
             plain entry point's in the same run, peak memory
  spmd_train (after train_main_path) `launch.steps.build_train_step` on the
             one-rank mesh (m = 1 agent, the fed axes' product), zamba2-7b
             at full width cut to 6 layers, batch 4 x seq 128, K 8, eta
             2e-3, remat, one round (then a warm one, timed): iterates
             bitwise the engine's round without a constraint on the same
             data, launches exactly `spmd_train_prediction`'s
  dryrun     (CPU and `meta` only) `launch.dryrun` on a fake world of 256
             ranks: granite-8b decode_32k on 16x16 (the whole decode step's
             census: executed matmul FLOPs a rank within 1% of JAX's
             1.7717e10, `JAX_DECODE_FLOPS`), zamba2-7b train_4k
             compressed_gt 0.1 over the wire under the async runtime (the
             gather step alone: one all-gather whose bytes equal
             `expected_gather_bytes`), and on a fake world of 512 ranks a
             FedGDA-GT round (K 4) of the reduced granite-8b train_4k on
             2x16x16 (32 agents over ("pod", "data") flattened)
  kernels    one entry per ported kernel (launches on its main path, error
             against the plain version, times and bound at the main
             path's shapes; its launches on each stochastic_main_path,
             elastic_main_path, sparse_main_path, async_main_path,
             multihost_main_path, train_main_path and telemetry_main_path
             run)
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
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
                  "flash_attention", "flash_attention_bwd", "ssm_scan",
                  "ssm_scan_bwd")
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
#: the backward kernels against autograd of the plain versions, each
#: gradient within this share of its largest |value| (f32 sums in another
#: order; the kernels' own sums run in a fixed order, so two calls agree
#: bit for bit)
GRAD_REL = 1e-4
#: the LM training main path: zamba2-7b at full width, cut to the one
#: depth that applies its shared attention block once, with JAX
#: train.py's defaults, 3 rounds of FedGDA-GT, remat on
#: (`make_adversarial_loss`'s default); agents cut to 2, before
#: training, only where `train_peak_prediction` at 4 passes
#: TRAIN_MEMORY_CUT bytes of device memory
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_ROUNDS = "zamba2-7b", 6, 3
TRAIN_MEMORY_CUT = 72e9
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
#: the serving phases of the other model families, each at serve's batch,
#: prompt and tokens: pixtral-12b (vision_text, 256 patches of the 512
#: prompt positions) at full width and depth through the entry point,
#: llama4-scout (MoE) at full width cut to 6 layers (48 are 403 GB in
#: f32; 6 are 54 GB, the depth the training path runs) through
#: `serve.generate`, and hubert-xlarge's encoder (48 layers, 512 frames)
VLM_ARCH, MOE_ARCH, AUDIO_ARCH = "pixtral-12b", "llama4-scout-17b-a16e", "hubert-xlarge"
MOE_LAYERS = 6
#: the full-width cuts of serve_vlm and serve_moe held to SERVE_CUT_TOL
CUT_LAYERS = 2
#: The three phases' full runs hold the kernels' logits to PERTURB_FACTOR
#: times the least of three PERTURB_REL input perturbations' effect on the
#: plain path.  These models barely amplify f32 noise, so the kernels' f32
#: rounding and a 1e-6 input perturbation move the logits by the same
#: ~1e-7-1e-6, and which is larger is chance (0.69-1.16 of the least
#: perturbation on an H100: llama4-scout at 6 layers read 2.648e-7
#: against 2.290e-7); 3 leaves room for that, while a fault in a kernel
#: moves the logits by orders of magnitude more.  Each phase reports the
#: ratio as `rel_err_over_least_perturbation`.
PERTURB_FACTOR = 3
#: a routing decision of the MoE's kernel path may differ from the plain
#: path's only at a near-tie: the plain path's top-1 minus top-2 router
#: probability below this.  The kernels move a layer's input by f32
#: rounding (~1e-6 of its scale), which moves a router probability by
#: ~1e-7; 1e-4 is a thousand times that, and a gap of a few percent is
#: typical between two of 16 experts
NEAR_TIE_GAP = 1e-4


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


def phase_gt_update(torch, card: str, cases, shared: dict) -> dict:
    """gt_update against its plain version, bit for bit, and its wall time
    (CUDA events over back-to-back calls) against the bytes bound: the
    large single leaves of `cases`; the main path's local step, x and y
    [16, 4096] f64 with f64 corrections, as one `pair` launch and as the
    two one-leaf calls it replaced; and zamba2-7b's training step, its 68
    leaves (TRAIN_LAYERS layers, 4 agents, f32, built on the card from
    the config) as one `gt_update_many` call and as 68 one-leaf calls.
    The main step's and the training step's calls are kept in
    shared["device_time_runs"] for `phase_kernel_device_times`."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import gt_update, gt_update_many, make_gt_update_fn, ref
    from repro_torch.models import init_params

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

    def bitwise_all(got, want):
        return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, want))

    def counted(run) -> dict:
        zero_counts()
        run()
        torch.cuda.synchronize()
        return {k: kernel_counts()[k] for k in ("gt_update", "gt_update_leaves")}

    # the main path's local step (Sec 5.1: m = 16, d = 4096, f64)
    fn = make_gt_update_fn()
    x, gx, cx, y, gy, cy = (torch.randn(16, 4096, generator=gen, device=DEVICE,
                                        dtype=torch.float64) for _ in range(6))
    pair = lambda: fn.pair(x, gx, cx, eta, y, gy, cy, eta)
    two = lambda: (gt_update(x, gx, cx, eta=eta, sign=-1.0),
                   gt_update(y, gy, cy, eta=eta, sign=1.0))
    plain = lambda: (ref.gt_update_ref(x, gx, cx, eta, -1.0),
                     ref.gt_update_ref(y, gy, cy, eta, 1.0))
    want = plain()
    check(bitwise_all(pair(), want) and bitwise_all(two(), want),
          "gt_update main step: the kernel differs from the plain version")
    check(counted(pair) == gt_counts(1) and counted(two) == gt_counts(2, 1),
          "gt_update main step: not one launch for x and y")
    nbytes = gt_update_bytes(x, cx) + gt_update_bytes(y, cy)
    main = {"shape": [16, 4096], "dtype": "f64", "leaves": 2, "max_abs_err": 0.0,
            "pair_ms": time_ms(torch, pair, reps=200),
            "two_calls_ms": time_ms(torch, two, reps=200),
            "plain_ms": time_ms(torch, plain, reps=200), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "card": card}
    # zamba2-7b's training step: every leaf of x (the model) and y (delta)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    shapes = [tuple(t.shape) for t in tree_leaves(init_params(None, cfg).tree())]
    agents = 4  # train.py's default
    mk = lambda sh: torch.randn(agents, *sh, generator=gen, device=DEVICE)
    xs = [mk(sh) for sh in shapes]
    ys = [mk((cfg.d_model,))]
    gxs, gys = [mk(t.shape[1:]) for t in xs], [mk(t.shape[1:]) for t in ys]
    cxs, cys = [mk(t.shape[1:]) for t in xs], [mk(t.shape[1:]) for t in ys]
    eta_t = 2e-3
    step = lambda: fn.pair(xs, gxs, cxs, eta_t, ys, gys, cys, eta_t)
    per_leaf = lambda: [gt_update(z, g, c, eta=eta_t, sign=sign)
                        for zz, gg, cc, sign in ((xs, gxs, cxs, -1.0), (ys, gys, cys, 1.0))
                        for z, g, c in zip(zz, gg, cc)]
    leaves = len(xs) + len(ys)
    got = step()
    want = ([ref.gt_update_ref(z, g, c, eta_t, -1.0) for z, g, c in zip(xs, gxs, cxs)]
            + [ref.gt_update_ref(z, g, c, eta_t, 1.0) for z, g, c in zip(ys, gys, cys)])
    check(bitwise_all(got[0] + got[1], want) and bitwise_all(per_leaf(), want),
          "gt_update zamba2-7b step: the kernel differs from the plain version")
    del got, want
    check(counted(step) == gt_counts(1, leaves) and counted(per_leaf) == gt_counts(leaves, 1),
          f"gt_update zamba2-7b step: not one launch for its {leaves} leaves")
    nbytes = sum(gt_update_bytes(z, c) for z, c in zip(xs + ys, cxs + cys))
    train_step = {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "agents": agents,
                  "leaves": leaves, "dtype": "f32", "numel": sum(t.numel() for t in xs + ys),
                  "max_abs_err": 0.0, "one_call_ms": time_ms(torch, step, reps=10),
                  "per_leaf_calls_ms": time_ms(torch, per_leaf, reps=10),
                  "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "card": card}
    for t in (main, train_step):
        fast = t.get("pair_ms", t.get("one_call_ms"))
        t["share_of_3.35TB_s"] = t["bound_ms"] / fast
    shared.setdefault("timing", {})["gt_update"] = {"main": main, "train_step": train_step}
    shared["device_time_runs"] = {
        "gt_update_main_pair": ("gt_update_kernel", pair, main["pair_ms"]),
        "gt_update_main_two_calls": ("gt_update_kernel", two, main["two_calls_ms"]),
        "gt_update_train_step": ("gt_update_kernel", step, train_step["one_call_ms"]),
        "gt_update_train_per_leaf_calls": ("gt_update_kernel", per_leaf,
                                           train_step["per_leaf_calls_ms"]),
    }
    return {"large": rows, "main": main, "train_step": train_step}


def phase_kernel_device_times(torch, shared: dict) -> dict:
    """Device time per call (the profiler, `device_ms_per_call`) of the
    calls gt_update's and compress_correction's phases kept, beside their
    wall time per call (CUDA events, measured there before any profiler
    session): the difference is the host's.  Gate: compress_correction's
    cluster at [16, 4096] f64 takes less device time than one CTA a row."""
    out = {}
    for name, (kernel, run, wall_ms) in shared.pop("device_time_runs").items():
        dev = device_ms_per_call(torch, run, kernel, calls=20)
        out[name] = {"kernel": kernel, "wall_ms_per_call": wall_ms,
                     "device_ms_per_call": dev,
                     "host_ms_per_call": None if dev is None else wall_ms - dev}
    torch.cuda.empty_cache()
    timing = shared.get("timing", {})
    if "gt_update" in timing:
        timing["gt_update"]["main"]["device_ms_per_call"] = \
            out["gt_update_main_pair"]["device_ms_per_call"]
    for name in ("main", "main_cluster1", "main_cluster4"):
        if f"compress_{name}" in out and "compress_correction" in timing:
            timing["compress_correction"][name]["device_ms_per_call"] = \
                out[f"compress_{name}"]["device_ms_per_call"]
    cl, one = (out.get(k, {}).get("device_ms_per_call")
               for k in ("compress_main", "compress_main_cluster1"))
    if cl is not None and one is not None:
        check(cl < one, f"compress_correction main: the cluster's device time {cl} ms "
                        f"is not below one CTA a row's {one} ms")
        out["compress_main_cluster_over_cluster1"] = cl / one
    return out


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
    """compress_correction against its plain version, bit for bit, over
    `compress_cases` at the cluster size the launcher takes and again at
    one CTA a row; wall times (CUDA events) at the main path's [16, 4096]
    f64 with the launcher's cluster, with one CTA a row and with 4 CTAs a
    row, and at the large f32 leaf, beside the bytes bound and torch.topk of the select's
    scores (|c + e| for top-k, u_sel for rand-k).  The main-shape calls are
    kept in shared["device_time_runs"]."""
    from repro_torch.kernels import compress_correction_2d, ref
    from repro_torch.kernels.compress_correction import auto_cluster, staged_in_shared_memory

    n, plans = 0, collections.Counter()
    for cluster in (None, 1):
        for tag, args, k, bits, mode in compress_cases(torch):
            c, e, us, ur = _leaf_from(torch, args)
            got = compress_correction_2d(c, e, us, ur, k=k, bits=bits, mode=mode,
                                         cluster=cluster)
            plan = compress_correction_2d.last_plan
            plans[f"{plan['route']} x{plan['cluster']} {plan['threads']} threads"] += 1
            want = ref.compress_correction_ref(c, e, us, ur, k=k, bits=bits, mode=mode)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("chat", "resid")):
                check(bitwise(torch, g, w), f"compress_correction {tag} cluster={cluster}: "
                                            f"{name} differs from the plain version")
            n += 1
    check(not staged_in_shared_memory(40000, torch.float64, True)
          and staged_in_shared_memory(4096, torch.float64, True),
          "compress_correction: shared-memory staging not as expected")
    check(auto_cluster(16, 4096) == 8, "compress_correction: the strategies' 16 rows "
                                       f"take {auto_cluster(16, 4096)} CTAs a row, not 8")
    timing = {}
    # (a)'s shape: [16, 4096] f64, top-k 0.1, error feedback, no quantization,
    # with the launcher's cluster and with one CTA a row; and a large f32
    # leaf, top-k and rand-k 8-bit
    for name, (R, C, dt), k, bits, mode, reps, cluster in [
            ("main", (16, 4096, "f64"), 410, 32, "topk", 200, None),
            ("main_cluster1", (16, 4096, "f64"), 410, 32, "topk", 200, 1),
            ("main_cluster4", (16, 4096, "f64"), 410, 32, "topk", 200, 4),
            ("large_topk", (*LARGE, "f32"), 410, 32, "topk", 10, None),
            ("large_randk8", (*LARGE, "f32"), 410, 8, "randk", 10, None)]:
        c, e, us, ur = make_leaf(torch, R, C, dt, True, 10)
        us_k = us if mode == "randk" else None
        ur_k = ur if bits < 32 else None
        ct = ref.compute_dtype(c.dtype)
        score = us.to(ct) if mode == "randk" else (c.to(ct) + e.to(ct)).abs()
        got = compress_correction_2d(c, e, us_k, ur_k, k=k, bits=bits, mode=mode,
                                     cluster=cluster)
        plan = compress_correction_2d.last_plan
        want = ref.compress_correction_ref(c, e, us_k, ur_k, k=k, bits=bits, mode=mode)
        err = max_abs_err(torch, got, want)
        check(err == 0.0, f"compress_correction {name}: max |err| {err}")
        run = (lambda c=c, e=e, us_k=us_k, ur_k=ur_k, k=k, bits=bits, mode=mode,
               cluster=cluster: compress_correction_2d(c, e, us_k, ur_k, k=k, bits=bits,
                                                       mode=mode, cluster=cluster))
        timing[name] = {
            "shape": [R, C], "dtype": dt, "k": k, "bits": bits, "mode": mode,
            "plan": plan, "max_abs_err": err,
            **time_case(
                torch, run,
                lambda: ref.compress_correction_ref(c, e, us_k, ur_k, k=k, bits=bits, mode=mode),
                lambda: torch.topk(score, k, dim=-1),
                nbytes(c, e, us_k, ur_k) + 2 * nbytes(c), reps,
                20 if R == 16 else 3, card),
        }
        if R == 16:
            shared.setdefault("device_time_runs", {})[f"compress_{name}"] = (
                "compress_staged_kernel", run, timing[name]["ms"])
        else:
            del c, e, us, ur, score, got, want, run
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["compress_correction"] = timing
    return {"cases_bitwise": n, "plans": dict(plans), "timing": timing,
            "library": "torch.topk(score, k) (the select alone; score = |c + e| for "
                       "top-k, u_sel for rand-k)"}


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
            "flash_attention_bwd": kernels.flash_attention_bwd,
            "ssm_scan": kernels.ssm_scan,
            "ssm_scan_bwd": kernels.ssm_scan_bwd}


def kernel_counts() -> dict:
    """Each kernel's launches, and gt_update's leaf updates (one launch
    updates every leaf of x and y) as "gt_update_leaves"."""
    from repro_torch import kernels

    return {**{name: fn.launches for name, fn in _kernel_fns().items()},
            "gt_update_leaves": kernels.gt_update.leaf_updates}


def zero_counts() -> None:
    from repro_torch import kernels

    for fn in _kernel_fns().values():
        fn.launches = 0
    kernels.gt_update.leaf_updates = 0


def gt_counts(steps: int, leaves: int = 2) -> dict:
    """gt_update's counts over `steps` corrected local steps: one launch a
    step (every leaf of x and y in one table), `leaves` leaves a step."""
    return {"gt_update": steps, "gt_update_leaves": steps * leaves}


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
    bf16, pixtral-12b's prefill (32 query heads over 8 KV heads, hd 128),
    hubert-xlarge's encoder (non-causal, hd 80), gemma2-2b's local layer
    at 8k in f32 and bf16, a ragged length and a non-causal grouped
    Sq < Skv."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("serve_zamba2", 4, 32, 32, 512, 512, 112, f32, True, 0, 0.0),
        ("serve_zamba2_bf16", 4, 32, 32, 512, 512, 112, bf16, True, 0, 0.0),
        ("serve_pixtral", 4, 32, 8, 512, 512, 128, f32, True, 0, 0.0),
        ("encode_hubert", 4, 16, 16, 512, 512, 80, f32, False, 0, 0.0),
        ("gemma2_local_f32", 1, 8, 4, 8192, 8192, 256, f32, True, 4096, 50.0),
        ("gemma2_local_bf16", 1, 8, 4, 8192, 8192, 256, bf16, True, 4096, 50.0),
        ("ragged_1000", 2, 16, 16, 1000, 1000, 112, f32, True, 0, 0.0),
        ("noncausal_gqa", 2, 8, 2, 256, 1024, 64, f32, False, 0, 0.0),
    ]


def sass_ops(name: str, pattern: str = r"\b((?:HMMA|RED|ATOM[GS]?)\.\S+)") -> dict:
    """{entry function (mangled): {instruction: count}} of the library
    built from `csrc/<name>.cu`, for the instructions `pattern` matches
    (`cuobjdump -sass`; by default the tensor-core products and the
    atomics)."""
    import re
    import shutil

    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"{name}: cuobjdump failed: {sass.stderr[-500:]}")
    ops, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            ops[fn] = {}
            continue
        m = re.search(pattern, line)
        if fn is not None and m:
            op = m.group(1).rstrip(";")
            ops[fn][op] = ops[fn].get(op, 0) + 1
    return ops


def bwd_build_report(name: str, kernel: str) -> dict:
    """A backward library's ptxas report (registers, spills, static shared
    memory of each entry function) and its SASS's tensor-core and atomic
    instructions; fails on a spill store or any float atomic.  `kernel`
    names its main entry function."""
    from repro_torch.kernels import _build

    usage = _build.ptxas_usage(name)
    ptxas = [{k: u.get(k) for k in ("function", "registers", "spill_store_bytes",
                                    "spill_load_bytes", "static_smem_bytes")}
             for u in usage]
    check(len(ptxas) > 0 and all(u["spill_store_bytes"] == 0 for u in ptxas),
          f"{name}: ptxas spills {[(u['function'], u['spill_store_bytes']) for u in ptxas]}")
    ops = sass_ops(name)
    atomics = {fn: o for fn, o in ops.items() if any(not k.startswith("HMMA") for k in o)}
    check(not atomics, f"{name}: atomic instructions {atomics}")
    main = {fn: o for fn, o in ops.items() if kernel in fn}
    check(len(main) > 0, f"{name}: no {kernel} in the library's SASS")
    return {"ptxas": ptxas, "sass_mma": main, "atomics": 0}


def flash_build_report(torch) -> dict:
    """Each flash instantiation's registers, spills and shared memory (the
    ptxas report of this process's build and the kernel's plan), and the
    tensor-core instructions its SASS holds (`cuobjdump -sass`): the f32
    route must issue TF32 MMAs, the bf16 route bf16 MMAs."""
    import re

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
    mma = {tiling(fn): o for fn, o in sass_ops("flash_attention", r"\b(HMMA\.\S+)").items()
           if tiling(fn) is not None}
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
    and y and the state bitwise unchanged where the launch also stores the
    backward's chunk states; timed against the bytes bound; no single
    PyTorch call computes it."""
    from repro_torch.kernels import ref, ssm_scan
    from repro_torch.kernels.ssm_scan import _launch

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
        y2, st2, _ = _launch(da.expand(dbx.shape), dbx, c, s0, chunks=True)
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"ssm_scan {tag}: storing the chunk states moved y or the state")
        del want_y, want_st, y2, st2
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
                 forward_bitwise_with_chunks=True,
                 library="null: no single PyTorch call computes the scan")
        out[tag] = t
        del da, dbx, c, s0, y, st
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["ssm_scan"] = out
    return out


# ------------------------------------------------- the backward kernels
def flash_bwd_cases():
    """(tag, B, H, KV, S, hd, causal, window, softcap): zamba2-7b's shared
    block at the training shape (4 agents x batch 4), gemma2-2b's local
    layer at S 1024 and a grouped case."""
    return [
        ("train_zamba2", 16, 32, 32, 128, 112, True, 0, 0.0),
        ("gemma2_local", 2, 8, 4, 1024, 256, True, 4096, 50.0),
        ("gqa", 2, 16, 4, 512, 64, True, 0, 0.0),
    ]


def grad_errors(torch, got, want) -> list:
    """Each gradient's max |got - want| over its max |want|."""
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


def phase_flash_attention_bwd(torch, np, card: str, shared: dict) -> dict:
    """The flash backward kernel against autograd of the plain version
    (`torch.func.vjp`), each gradient within GRAD_REL of its max |value|,
    two calls bitwise equal; the forward's outputs bitwise unchanged by
    its LSE output; ptxas with no spill, the SASS with TF32 tensor-core
    products in the main kernel and no atomics; times against the
    operations bound (10 hd flops per unmasked pair at the 3xTF32 route's
    rate) and SDPA's backward where one call computes the same
    function."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        _forward,
        bwd_plan,
        bwd_scratch,
        flash_attention_bwd,
        plain_flash_attention_bwd,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    out = {"build": bwd_build_report("flash_attention_bwd", "flash_bwd_kernel")}
    for fn, ops in out["build"]["sass_mma"].items():
        mma = FLASH_MMA["float"]
        check(ops.get(mma, 0) > 0 and set(ops) == {mma},
              f"flash_attention_bwd {fn}: tensor-core instructions {ops}, want {mma}")
    for tag, B, H, KV, S, hd, causal, window, cap in flash_bwd_cases():
        q = torch.randn(B, H, S, hd, generator=gen, device=DEVICE)
        k, v = (torch.randn(B, KV, S, hd, generator=gen, device=DEVICE) for _ in range(2))
        dout = torch.randn(B, H, S, hd, generator=gen, device=DEVICE)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = _forward(q, k, v, causal, window, cap, with_lse=True)
        o_plain = _forward(q, k, v, causal, window, cap, with_lse=False)[0]
        check(torch.equal(o, o_plain), f"flash {tag}: the LSE output moved the forward")
        got = flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        want = plain_flash_attention_bwd(q, k, v, dout, **kw)
        torch.cuda.synchronize()
        errs = grad_errors(torch, got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(max(errs) <= GRAD_REL, f"flash_attention_bwd {tag}: relative errors "
                                      f"{errs} beyond {GRAD_REL}")
        check(same, f"flash_attention_bwd {tag}: two calls differ")
        max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        del got, again, want
        library, why = None, "null: the softcap and the window have no SDPA argument"
        if cap == 0.0 and window == 0:
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(
                qr, kr, vr, is_causal=causal, enable_gqa=KV != H)
            library = lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), dout,
                                                  retain_graph=True)
            why = (f"the backward of torch.nn.functional.scaled_dot_product_attention("
                   f"is_causal={causal}, enable_gqa={KV != H}) (autograd.grad)")
        moved = nbytes(q, k, v, o, dout, lse) + nbytes(q, k, v)  # dq, dk, dv
        flops = 10 * hd * B * H * attention_pairs(np, S, S, causal, window)
        t = time_case(torch, lambda: flash_attention_bwd(q, k, v, o, lse, dout, **kw),
                      lambda: plain_flash_attention_bwd(q, k, v, dout, **kw), library,
                      moved, reps=10, plain_reps=3, card=card)
        t.update(bound_from(moved, flops, FLASH_PEAK_FLOPS_PER_S["torch.float32"]))
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        if library is not None:
            t["library_kernels"] = sdpa_kernel_names(torch, library)
        plan = bwd_plan(hd)
        t.update(tag=tag, shape={"B": B, "H": H, "KV": KV, "S": S, "hd": hd},
                 dtypes=["torch.float32"], causal=causal, window=window, softcap=cap,
                 max_abs_err=max_abs, rel_err_dq_dk_dv=errs, tolerance_rel=GRAD_REL,
                 bitwise_repeat=same, forward_bitwise_with_lse=True, route="3xTF32",
                 peak_flops_per_s=FLASH_PEAK_FLOPS_PER_S["torch.float32"], tiling=plan,
                 scratch=bwd_scratch(B, H, KV, S, S, hd),
                 library=why)
        out[tag] = t
        del q, k, v, dout, o, lse, o_plain
        library = None
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["flash_attention_bwd"] = out
    return out


def scan_bwd_cases():
    """(tag, B, S, H, P, N, decay): zamba2-7b's Mamba-2 at the training
    shape (per-head decay [B, S, H, 1, 1]) and falcon-mamba-7b's Mamba-1
    layout at S 2048 (full decay)."""
    return [
        ("train_zamba2", 16, 128, 112, 64, 64, "head"),
        ("mamba1_falcon", 1, 2048, 8192, 1, 16, "full"),
    ]


def phase_ssm_scan_bwd(torch, card: str, shared: dict) -> dict:
    """The scan backward kernel against autograd of the plain version
    (`torch.func.vjp` through its sequential loop), each gradient within
    GRAD_REL of its max |value|, two calls bitwise equal; ptxas with no
    spill and no atomics in the SASS; times against the bytes bound; no
    single PyTorch call computes it."""
    from repro_torch.kernels.ssm_scan import (
        _launch,
        bwd_plan,
        plain_ssm_scan_bwd,
        ssm_scan_bwd,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    out = {"build": bwd_build_report("ssm_scan_bwd", "ssm_scan_bwd_kernel")}
    for tag, B, S, H, P, N, decay in scan_bwd_cases():
        da_shape = (B, S, H, 1, 1) if decay == "head" else (B, S, H, P, N)
        da = torch.sigmoid(torch.randn(*da_shape, generator=gen, device=DEVICE))
        dbx = 0.1 * torch.randn(B, S, H, P, N, generator=gen, device=DEVICE)
        c = torch.randn(B, S, N, generator=gen, device=DEVICE)
        dy = torch.randn(B, S, H, P, generator=gen, device=DEVICE)
        dstate = torch.randn(B, H, P, N, generator=gen, device=DEVICE)
        # the forward's chunk states, as the training path hands them over
        chunks = (_launch(da.expand(dbx.shape), dbx, c, None, chunks=True)[2]
                  if dbx.is_cuda else None)
        got = ssm_scan_bwd(da, dbx, c, None, dy, dstate, chunks=chunks)
        again = ssm_scan_bwd(da, dbx, c, None, dy, dstate, chunks=chunks)
        want = plain_ssm_scan_bwd(da, dbx, c, None, dy, dstate)
        torch.cuda.synchronize()
        errs = grad_errors(torch, got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(max(errs) <= GRAD_REL, f"ssm_scan_bwd {tag}: relative errors "
                                      f"{errs} beyond {GRAD_REL}")
        check(same, f"ssm_scan_bwd {tag}: two calls differ")
        check(tuple(got[0].shape) == da_shape, f"ssm_scan_bwd {tag}: d da "
                                                f"{tuple(got[0].shape)}")
        max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        del again, want
        torch.cuda.empty_cache()
        moved = nbytes(da, dbx, c, dy, dstate, *got)
        flops = 10 * B * S * H * P * N
        t = time_case(torch, lambda: ssm_scan_bwd(da, dbx, c, None, dy, dstate,
                                                  chunks=chunks),
                      lambda: plain_ssm_scan_bwd(da, dbx, c, None, dy, dstate),
                      None, moved, reps=10, plain_reps=1, card=card)
        t.update(bound_from(moved, flops, PEAK_FLOPS_PER_S["torch.float32"]))
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        mode = 0 if decay == "full" else 1
        plan = bwd_plan(B, H, P, N, mode, mode == 1 and P > 1)
        t.update(tag=tag, shape={"B": B, "S": S, "H": H, "P": P, "N": N},
                 da_shape=list(da_shape), dtypes=["torch.float32"],
                 max_abs_err=max_abs, rel_err_da_dbx_c_state0=errs,
                 tolerance_rel=GRAD_REL, bitwise_repeat=same, plan=plan,
                 dc_partial_bytes=4 * B * plan["parts"] * S * N,
                 chunk_states_bytes=None if chunks is None else nbytes(chunks),
                 library="null: no single PyTorch call computes the scan's gradient")
        out[tag] = t
        del da, dbx, c, dy, dstate, chunks, got
        torch.cuda.empty_cache()
    shared.setdefault("timing", {})["ssm_scan_bwd"] = out
    return out


def train_launch_prediction(cfg, K: int, leaves: int) -> dict:
    """Kernel launches a FedGDA-GT round of the training main path makes
    (written down in PERF.md before the first run): K gradient
    evaluations (the anchor exchange and local steps 1..K-1; the fused
    anchor step needs none), each a forward, remat's recompute and the
    backward, plus one forward of the logged global loss; gt_update once
    in each of the K - 1 local steps after the anchor step, over every
    leaf of x and y (one table: the leaves share f32 and fit
    `gt_update.TABLE_CAP`)."""
    shared_blocks = cfg.num_layers // cfg.shared_attn_every
    return {"flash_attention": (2 * K + 1) * shared_blocks,
            "flash_attention_bwd": K * shared_blocks,
            "ssm_scan": (2 * K + 1) * cfg.num_layers,
            "ssm_scan_bwd": K * cfg.num_layers,
            **gt_counts(K - 1, leaves),
            "compress_correction": 0, "pack_payload": 0, "unpack_payload": 0}


def phase_train_main_path(torch, np, card: str, shared: dict) -> dict:
    """The LM training path through its entry point's loop
    (`repro_torch.launch.train.train`): zamba2-7b at full width cut to 6
    Mamba-2 layers and one shared attention block, f32 weights from seed
    0, JAX train.py's defaults (4 agents, batch 4, seq 128, K 8, eta 2e-3,
    heterogeneity 7), remat on, 3 rounds of FedGDA-GT.  Gates: at round 0
    each agent's (gx, gy) through the kernels, leaf by leaf, within
    GRAD_REL of the leaf's max |g| through the plain versions or, for a
    leaf whose own f32 sensitivity is larger, within the least of what
    three 1e-6 perturbations of the embeddings do to that same leaf's
    plain gradients (the serve gate's rule; every leaf's error and the
    perturbations' are reported); loss finite and falling, |delta| <= 1;
    launches a round equal to `train_launch_prediction`.  The agents are
    cut to 2 before training where `train_peak_prediction` at 4 passes
    TRAIN_MEMORY_CUT."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    argv = ["--arch", TRAIN_ARCH, "--rounds", str(TRAIN_ROUNDS), "--log-every", "1",
            "--device", DEVICE]
    torch.cuda.empty_cache()
    args = train.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    run = train.setup(args, cfg, remat=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gate = _train_gate(torch, cfg, run, args.agents)
    predicted = {m: train_peak_prediction(gate, m) for m in (args.agents, 2)}
    if predicted[args.agents] > TRAIN_MEMORY_CUT:
        del run
        torch.cuda.empty_cache()
        args = train.build_parser().parse_args(argv + ["--agents", "2"])
        t0 = time.perf_counter()
        run = train.setup(args, cfg, remat=True)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    res = _train_run(torch, np, train, cfg, args, run, shared)
    res.update(setup_s=setup_s, **gate["report"],
               predicted_peak_memory_bytes=predicted[args.agents],
               predicted_peak_memory_bytes_by_agents=predicted,
               agents_cut_to_2=args.agents == 2, card=card)
    return res


def spmd_train_prediction(cfg, K: int, leaves: int) -> dict:
    """Kernel launches of spmd_train's round (written down in PERF.md
    before its first run).  With m = 1 agent the engine elides the anchor
    exchange (the correction is identically zero), so there is no fused
    anchor step: K gradient evaluations (local steps 0..K-1), each a
    forward, remat's recompute and the backward, and gt_update once in
    each of the K steps, over every leaf of x and y."""
    shared_blocks = cfg.num_layers // cfg.shared_attn_every
    return {"flash_attention": 2 * K * shared_blocks,
            "flash_attention_bwd": K * shared_blocks,
            "ssm_scan": 2 * K * cfg.num_layers, "ssm_scan_bwd": K * cfg.num_layers,
            **gt_counts(K, leaves),
            "compress_correction": 0, "pack_payload": 0, "unpack_payload": 0}


def phase_spmd_train(torch, card: str) -> dict:
    """`launch.steps.build_train_step` on a one-rank NCCL mesh (m = 1): one
    FedGDA-GT round of zamba2-7b at full width cut to TRAIN_LAYERS, batch
    4 x seq 128, K 8, eta 2e-3, remat, on DTensors through the kernels,
    against the engine's round without a constraint on the same data."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.engine import make_round
    from repro_torch.core.types import tree_leaves
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    K, eta, batch, seq = 8, 2e-3, 4, 128
    args = train.build_parser().parse_args(
        ["--arch", TRAIN_ARCH, "--agents", "1", "--per-agent-batch", str(batch),
         "--seq-len", str(seq), "--local-steps", str(K), "--eta", str(eta),
         "--device", DEVICE])
    torch.cuda.empty_cache()
    run = train.setup(args, cfg, remat=True)
    mesh = make_host_mesh(1, 1)
    step_for, _ = build_train_step(cfg, mesh, algorithm="fedgda_gt", num_local_steps=K,
                                   eta=eta, dtype=torch.float32, remat=True)
    step = step_for(ShapeConfig("spmd_train", seq, batch, "train"))
    leaves = len(tree_leaves(run.params)) + len(tree_leaves(run.delta))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    x1, y1 = step(run.params, run.delta, run.data)
    torch.cuda.synchronize()
    spmd_s = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    want = spmd_train_prediction(cfg, K, leaves)
    check(launches == want, f"spmd_train: launches {launches}, predicted {want}")
    got = [u.full_tensor() for u in tree_leaves((x1, y1))]
    placements = sorted({str(tuple(u.placements)) for u in tree_leaves((x1, y1))})
    del x1, y1
    # again, warm: DTensor's sharding propagation caches each op
    # signature on its first call, which the first round pays
    t0 = time.perf_counter()
    x2, y2 = step(run.params, run.delta, run.data)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(all(torch.equal(a.full_tensor(), b) for a, b in zip(tree_leaves((x2, y2)), got)),
          "spmd_train: a second round differs from the first")
    del x2, y2
    rnd = make_round(run.loss, run.strategy, K, eta, proj_y=train.delta_projection(1.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xr, yr = rnd(run.params, run.delta, run.data)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ref = tree_leaves((xr, yr))
    same = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(got, ref))
    check(all(same), f"spmd_train: {same.count(False)} of {len(same)} leaves differ "
          f"from the engine's round (worst {worst:.3e} of the leaf's max)")
    del got, ref, xr, yr, run
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers, "mesh": "1x1 (nccl)",
            "agents": 1, "batch": batch, "seq_len": seq, "K": K, "eta": eta,
            "remat": True, "dtype": "f32", "leaves_x_y": leaves,
            "round_s": warm_s, "cold_round_s": spmd_s, "plain_round_s": plain_s,
            "bitwise_leaves": f"{sum(same)} of {len(same)}",
            "worst_rel_err": worst, "output_placements": placements,
            "launches": launches, "predicted_launches": want,
            "peak_memory_bytes": peak, "card": card}


#: JAX's executed matmul FLOPs a device of granite-8b's full decode_32k on
#: the 16x16 mesh (`repro.launch.dryrun.run_one`, trip-count scaled; jax
#: 0.9.0 on the CPU), the figure tests/test_torch_dryrun.py holds the
#: port's census to within 1%
JAX_DECODE_FLOPS = 1.7717e10


def phase_dryrun(card: str) -> dict:
    """The production-mesh dry-run on fake worlds (CPU and `meta` only):
    granite-8b decode_32k on 16x16, whose executed FLOPs a rank must be
    JAX's within 1%; the async gather of zamba2-7b train_4k with
    compressed_gt 0.1 over the wire; and a reduced granite-8b train_4k
    round on 2x16x16.  Ends the one-rank NCCL group
    (`dryrun.fake_world`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    out_dir = ROOT / "build" / "chip_smoke" / "dryrun_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    decode = dryrun.run_one("granite-8b", "decode_32k", False)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather = dryrun.run_one("zamba2-7b", "train_4k", False, algorithm="compressed_gt",
                            compression_ratio=0.1, wire_transport=True,
                            runtime="async", gather_only=True)
    gather_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pods = dryrun.run_one("granite-8b", "train_4k", True,
                          cfg=get_config("granite-8b").reduced())
    pods_s = time.perf_counter() - t0
    for tag, rec in (("granite-8b__decode_32k__16x16", decode),
                     ("zamba2-7b__train_4k__16x16__compressed_gt__r0.1__wire__async",
                      gather),
                     ("granite-8b-reduced__train_4k__2x16x16", pods)):
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    ag = gather["gather_census"].get("all-gather", {})
    check(ag == {"count": 1, "bytes": gather["expected_gather_bytes"]},
          f"dryrun: the gather's census {gather['gather_census']} against "
          f"{gather['expected_gather_bytes']} expected bytes")
    flops = decode["census"]["executed_dot_flops"]
    check(abs(flops - JAX_DECODE_FLOPS) <= 0.01 * JAX_DECODE_FLOPS,
          f"dryrun: decode's executed matmul FLOPs a rank {flops:.4e}, JAX's "
          f"{JAX_DECODE_FLOPS:.4e}")
    check(pods["census"]["executed_dot_flops"] > 0 and pods["collectives"],
          f"dryrun: the 2x16x16 train round's census {pods['census']}")
    return {"world": 256, "mesh": "16x16", "torch": torch.__version__, "decode_32k": {
                "arch": "granite-8b", "s": decode_s, "trace_s": decode["trace_s"],
                "argument_bytes_per_rank": decode["argument_bytes_per_rank"],
                "executed_dot_flops": flops, "jax_executed_dot_flops": JAX_DECODE_FLOPS,
                "collectives": decode["collectives"]},
            "async_gather": {
                "arch": "zamba2-7b", "s": gather_s, "gather_census": gather["gather_census"],
                "expected_gather_bytes": gather["expected_gather_bytes"],
                "wire": gather["wire"]},
            "train_4k_2x16x16": {
                "arch": "granite-8b (reduced)", "world": 512, "s": pods_s,
                "trace_s": pods["trace_s"], "num_local_steps": pods["num_local_steps"],
                "argument_bytes_per_rank": pods["argument_bytes_per_rank"],
                "executed_dot_flops": pods["census"]["executed_dot_flops"],
                "collectives": pods["collectives"]},
            "records": str(out_dir.relative_to(ROOT)), "card": card}


def train_peak_prediction(gate: dict, m: int) -> float:
    """The training run's peak device memory at m agents, predicted from
    the round-0 gate (written down in PERF.md before the first run that
    tests it).  A FedGDA-GT local step (`core.engine.make_phases`) holds
    the broadcast iterates, the current ones and the corrections (3 copies
    a agent) and the server's point, the round's input and the mean
    anchor gradient (3 copies).  On top comes, while the step's gradients
    are formed, one gradient evaluation's own bytes (its activations,
    remat's recompute and the m gradients it returns; measured at the
    gate's agent count and scaled to m), or, while `gt_update` runs, the
    gradients and the new iterates (2 copies a agent)."""
    copy = gate["copy_bytes"]
    return (3 * m + 3) * copy + max(gate["grad_bytes"] * m / gate["agents"], 2 * m * copy)


def _train_gate(torch, cfg, run, m: int) -> dict:
    """Round 0: every agent's gradients through the kernels and the plain
    versions at the broadcast point, held leaf by leaf; and the bytes one
    gradient evaluation of the kernels' path takes."""
    from repro_torch.core.types import tree_broadcast_agents, tree_leaves, vmap_grad_xy
    from repro_torch.problems import make_adversarial_loss

    xs = tree_broadcast_agents(run.params, m)
    ys = tree_broadcast_agents(run.delta, m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    g_kernel = vmap_grad_xy(run.loss)(xs, ys, run.data)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_bytes = torch.cuda.max_memory_allocated() - before
    grad_launches = kernel_counts()
    plain_loss = make_adversarial_loss(cfg, remat=True, use_kernel=False)
    t0 = time.perf_counter()
    g_plain = vmap_grad_xy(plain_loss)(xs, ys, run.data)
    torch.cuda.synchronize()
    plain_grad_s = time.perf_counter() - t0
    flat_p = tree_leaves(g_plain.gx) + tree_leaves(g_plain.gy)
    names = leaf_names(run.params) + ["delta"]
    rel_k = leaf_rel_errors(tree_leaves(g_kernel.gx) + tree_leaves(g_kernel.gy), flat_p, m)
    del g_kernel
    # how far f32-level noise carries into these gradients: the plain path
    # again with every embedding entry scaled by (1 + 1e-6 z), for a few
    # draws of z (the serve gate's yardstick, PERTURB_*)
    rel_pert = []
    for seed in PERTURB_SEEDS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        with torch.no_grad():
            noisy = xs["embed"] * (1 + PERTURB_REL * torch.randn(
                xs["embed"].shape, generator=gen, device=DEVICE))
        g_pert = vmap_grad_xy(plain_loss)(dict(xs, embed=noisy), ys, run.data)
        del noisy
        rel_pert.append(leaf_rel_errors(tree_leaves(g_pert.gx) + tree_leaves(g_pert.gy),
                                        flat_p, m))
        del g_pert
    del xs, ys, g_plain, flat_p
    gate_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    # each leaf against its own bound: GRAD_REL, or the least of what the
    # perturbations do to that same leaf where that is larger
    pert_min = [min(r[i] for r in rel_pert) for i in range(len(names))]
    bound = [max(GRAD_REL, p) for p in pert_min]
    over = [f"{names[i]} {rel_k[i]:.3e} > {bound[i]:.3e}"
            for i in range(len(names)) if rel_k[i] > bound[i]]
    check(not over, f"train_main_path: round-0 gradients through the kernels off the "
                    f"plain versions' beyond each leaf's bound (max({GRAD_REL}, the least "
                    f"of {len(PERTURB_SEEDS)} 1e-6 embedding perturbations' effect on "
                    f"that leaf)): {over}")
    past = {names[i]: {"kernel": rel_k[i], "bound": bound[i]}
            for i in range(len(names)) if rel_k[i] > GRAD_REL}
    worst = max(rel_k)
    # the gate's margin: the leaf nearest its own bound
    share = [rel_k[i] / bound[i] for i in range(len(names))]
    copy_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(run.params))
    return {
        "agents": m, "grad_bytes": grad_bytes, "copy_bytes": copy_bytes,
        "report": {
            "round0_grad_s": grad_s, "round0_plain_grad_s": plain_grad_s,
            "round0_grad_launches": grad_launches,
            "round0_grad_rel_err_max": worst,
            "round0_grad_worst_leaf": names[rel_k.index(worst)],
            "round0_worst_share_of_bound": max(share),
            "round0_worst_share_leaf": names[share.index(max(share))],
            "round0_grad_rel_err_by_leaf": dict(zip(names, rel_k)),
            "round0_perturbed_plain_rel_err_min_by_leaf": dict(zip(names, pert_min)),
            "round0_perturbed_plain_rel_err_max": [max(r) for r in rel_pert],
            "round0_leaves_past_tolerance_rel": past,
            "round0_leaves_within_tolerance_rel":
                f"{len(names) - len(past)} of {len(names)}",
            "round0_shared_attn_rel_err": {
                n: {"kernel": rel_k[i], "perturbed_min": pert_min[i]}
                for i, n in enumerate(names) if n.startswith("shared_attn.")},
            "tolerance_rel": GRAD_REL,
            "round0_gate_agents": m, "round0_grad_bytes": grad_bytes,
            "round0_gate_peak_memory_bytes": gate_peak,
        },
    }


def _train_run(torch, np, train, cfg, args, run, shared) -> dict:
    """The main path's 3 rounds through `launch.train.train`, its gates,
    and one more round under the profiler."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.models import num_params

    n_params = num_params(run.params)
    leaves = len(tree_leaves(run.params)) + len(tree_leaves(run.delta))
    loss0 = float(run.global_loss(run.params, run.delta))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    zero_counts()
    res = train.train(args, run=run)
    torch.cuda.synchronize()
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    want = train_launch_prediction(cfg, args.local_steps, leaves)
    per_round = {k: n / args.rounds for k, n in launches.items()}
    losses = [lv for _, lv, _ in res["log"]]
    dnorm = float(torch.linalg.norm(res["delta"]["delta"]))
    check(all(np.isfinite(losses)) and np.isfinite(loss0), f"train: losses {losses}")
    check(losses[-1] < loss0, f"train: loss {loss0} -> {losses}")
    check(dnorm <= 1.0 + 1e-6, f"train: |delta| = {dnorm}")
    check(per_round == {k: float(v) for k, v in want.items()},
          f"train: launches a round {per_round}, predicted {want}")
    # one more round under the profiler: device time by kernel, busy share
    rnd = train.make_round(run.loss, run.strategy, args.local_steps, args.eta,
                           proj_y=train.delta_projection(1.0))
    prof = profile_round(torch, lambda: rnd(res["params"], res["delta"], run.data),
                         {"flash_attention": "flash_kernel",
                          "flash_attention_bwd": "flash_bwd_kernel",
                          "flash_attention_bwd_dq_reduce": "dq_reduce_kernel",
                          "ssm_scan": "ssm_scan_kernel",
                          "ssm_scan_bwd": "ssm_scan_bwd_kernel",
                          "ssm_scan_bwd_dc_reduce": "dc_reduce_kernel",
                          "gt_update": "gt_update_kernel", "gemm": "gemm"})
    shared["train"] = {"launches": launches}
    del res["params"], res["delta"], run, rnd
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "d_inner": cfg.d_inner, "num_params": n_params, "leaves_x_y": leaves,
        "agents": args.agents, "per_agent_batch": args.per_agent_batch,
        "seq_len": args.seq_len, "K": args.local_steps, "eta": args.eta,
        "rounds": args.rounds, "remat": True, "dtype": "f32",
        "loss0": loss0, "losses": losses,
        "delta_norm": dnorm, "ms_per_round": [s * 1e3 for s in res["round_s"]],
        "launches": launches, "launches_per_round": per_round,
        "predicted_launches_per_round": want, "peak_memory_bytes": peak,
        "profile": prof,
    }


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of a tree's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def leaf_rel_errors(got: list, want: list, m: int) -> list:
    """Per leaf, the largest over the m agents of max |got - want| over
    the agent's max |want|."""
    return [max(float((a[i] - b[i]).abs().max()) / max(float(b[i].abs().max()), 1e-30)
                for i in range(m)) for a, b in zip(got, want)]


def bwd_entry(name: str, shared: dict, card: str) -> dict:
    """The kernels-line entry of a backward kernel: its launches on the
    training main path, its error and times at that path's shape, measured
    in its own phase.  No TPU kernel: the JAX package differentiates its
    plain attention and scan."""
    source, replaces = BWD_KERNELS[name]
    t = shared["timing"][name]["train_zamba2"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": shared["train"]["launches"][name],
        "max_abs_err": t["max_abs_err"], "tolerance": t["tolerance_rel"],
        "tolerance_is": "relative to each gradient's max |value|",
        "shape": t["shape"], "dtypes": t["dtypes"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": t["library"], "card": card,
    }


#: the backward kernels: (source, what they stand beside)
BWD_KERNELS = {
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none: no TPU backward kernel; JAX differentiates its plain attention "
        "(src/repro/models/attention.py:51 _attend)"),
    "ssm_scan_bwd": (
        "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "none: no TPU backward kernel; JAX differentiates its plain scan "
        "(src/repro/models/mamba.py:66 _chunked_scan)"),
}


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


def phase_spmd_serve(torch, card: str, shared: dict) -> dict:
    """`examples/serve_batched`'s path on serve's parameters: the SPMD
    prefill and decode steps on a one-rank NCCL mesh, serve's prompts and
    tokens teacher-forced, against `serve.generate` in the same run."""
    from repro_torch.examples.serve_batched import place_params, serve as spmd_serve
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_caches

    res = shared["serve"]
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    batch, n = prompts["tokens"].shape[0], res["tokens"].shape[1]
    mesh = make_host_mesh(1, 1)
    placed = place_params(params.tree(), cfg, mesh)  # views: no second copy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    zero_counts()
    got = spmd_serve(cfg, mesh, placed, prompts, n, forced=res["tokens"])
    torch.cuda.synchronize()
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    # again, warm: DTensor's sharding propagation caches each op
    # signature on its first call, which the first run pays
    warm = spmd_serve(cfg, mesh, placed, prompts, n, forced=res["tokens"])
    check(torch.equal(warm["step_logits"], got["step_logits"]),
          "spmd_serve: a second run's logits differ")
    want_prefill = {"flash_attention": cfg.num_layers // cfg.shared_attn_every,
                    "ssm_scan": cfg.num_layers}
    check(got["launches"]["prefill"] == want_prefill,
          f"spmd_serve: prefill launched {got['launches']['prefill']}")
    check(got["launches"]["decode"] == {"flash_attention": 0, "ssm_scan": 0},
          f"spmd_serve: decode launched {got['launches']['decode']}")
    # the plain entry point's function, the same tokens, in this run
    caches = init_caches(cfg, batch, prompts["tokens"].shape[1] + n, torch.float32,
                         DEVICE)
    plain = serve.generate(params, cfg, prompts, caches, n, forced=res["tokens"])
    del caches
    bitwise = bool(torch.equal(got["step_logits"], plain["step_logits"]))
    err = float((got["step_logits"] - plain["step_logits"]).abs().max())
    check(bitwise, f"spmd_serve: logits differ from serve.generate's by {err:.3e}")
    check(torch.equal(got["step_logits"], res["step_logits"]),
          "spmd_serve: logits differ from the serve phase's")
    return {"arch": cfg.name, "mesh": "1x1 (nccl)", "batch": batch,
            "prompt_len": prompts["tokens"].shape[1], "decode_tokens": n,
            "prefill_ms": warm["prefill_ms"],
            "decode_ms_per_step": warm["decode_ms_per_step"],
            "cold_prefill_ms": got["prefill_ms"],
            "cold_decode_ms_per_step": got["decode_ms_per_step"],
            "plain_prefill_ms": plain["prefill_ms"],
            "plain_decode_ms_per_step": plain["decode_ms_per_step"],
            "logits_bitwise_generate": bitwise, "max_abs_err": err,
            "launches_per_prefill": got["launches"]["prefill"],
            "launches_over_decode": got["launches"]["decode"],
            "launches_over_run": launches, "peak_memory_bytes": peak,
            "card": card}


def phase_serve_profile(torch, shared: dict) -> dict:
    """Device time by kernel over one full-width prefill and one decode
    step (torch.profiler), and the device's busy share of each."""
    return serving_profile(torch, shared["serve"])


def serving_profile(torch, res: dict) -> dict:
    """`phase_serve_profile` of a serving run `res` (what `serve.generate`
    returned, with "cfg", "params", "prompts")."""
    from repro_torch.launch import serve
    from repro_torch.models import init_caches

    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    names = {"flash_attention": "flash_kernel", "ssm_scan": "ssm_scan_kernel",
             "gemm": "gemm"}
    state = {}

    def run_prefill(caches):  # empty caches, as prefill requires
        with torch.inference_mode():
            logits, state["caches"] = serve.prefill(params, cfg, prompts, caches)
            state["tok"] = logits[:, -1].argmax(-1)[:, None]

    B, S = prompts["tokens"].shape[0], serve.prompt_length(prompts)

    def empty_caches():
        return init_caches(cfg, B, S + 2, torch.float32, DEVICE)

    def run_decode():
        with torch.inference_mode():
            serve.decode(params, cfg, state["caches"], state["tok"], S)

    run_prefill(empty_caches())  # warm
    caches = empty_caches()
    out = {"prefill": profile_round(torch, lambda: run_prefill(caches), names)}
    out["decode_step"] = profile_round(torch, run_decode, names)
    return out


def model_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.parameters())


def with_tops(params, cfg=None, layers=None, **tops):
    """`params` (a `ModelParams`) with some of its top-level tensors
    ("embed", "frontend_proj", "out_head") or its layers replaced; the
    rest shared."""
    from repro_torch.models import ModelParams

    t = {name: getattr(params, name) for name in ("embed", "frontend_proj", "out_head")}
    t.update(tops)
    return ModelParams(cfg or params.cfg, list(params.layers if layers is None else layers),
                       params.final_norm, t["embed"], params.shared_attn,
                       frontend_proj=t["frontend_proj"], out_head=t["out_head"])


def perturbed(torch, t, seed: int):
    """t * (1 + PERTURB_REL z), z ~ N(0, 1) from `seed`, on the card,
    formed in place in z's buffer: one copy of t's size, no temporary."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.inference_mode():
        z = torch.randn(t.shape, generator=gen, device=DEVICE)
        return z.mul_(PERTURB_REL).add_(1).mul_(t)


def logit_rel_err(a, b):
    """(max |a - b| over max |b|, the same per decode step)."""
    scale = float(b.abs().max())
    return (float((a - b).abs().max()) / scale,
            ((a - b).abs().amax(dim=(0, 2)) / scale).tolist())


def serve_peak_prediction(cfg, params, batch: int, capacity: int, perturb: tuple,
                          baseline: int) -> dict:
    """Device bytes a serving phase should peak at: what the earlier
    phases still hold (`baseline`), the weights, one set of the perturbed
    copies of the `perturb` tensors, and the KV caches of two runs (the
    kernel path's and the plain path's)."""
    attn_layers = sum(k in ("attn", "local", "moe") for k in cfg.layer_types)
    caches = 2 * attn_layers * 2 * batch * capacity * cfg.num_kv_heads * cfg.head_dim * 4
    weights = model_bytes(params)
    copy = sum(getattr(params, name).numel() * getattr(params, name).element_size()
               for name in perturb)
    return {"weights_bytes": weights, "perturbed_copy_bytes": copy,
            "caches_bytes": caches,
            "predicted_peak_bytes": baseline + weights + copy + caches}


def serve_gates(torch, res: dict, perturb: tuple, n: int) -> dict:
    """The serving gates of `res` (what `serve.generate` returned, with
    "cfg", "params", "prompts"): the logits through the kernels against
    the same tokens teacher-forced through the plain versions, within
    PERTURB_FACTOR times the least of what three PERTURB_REL perturbations
    of the `perturb` tensors do to the plain path's; and a CUT_LAYERS-layer
    cut at full width, kernels against plain within SERVE_CUT_TOL.
    Returns the plain run, its routing decisions ("plain_routing": each
    `moe_ffn` call's, recorded around that run alone) and the gates'
    numbers."""
    from repro_torch.launch import serve
    from repro_torch.models import init_caches

    cfg, params, prompts, tokens = res["cfg"], res["params"], res["prompts"], res["tokens"]
    B, S = tokens.shape[0], serve.prompt_length(prompts)

    def teacher_forced(model, model_cfg, use_kernel):
        caches = init_caches(model_cfg, B, S + n, torch.float32, DEVICE)
        return serve.generate(model, model_cfg, prompts, caches, n,
                              use_kernel=use_kernel, forced=tokens)

    got = res["step_logits"]
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite logits through the kernels")
    plain, plain_routing = routed(lambda: teacher_forced(params, cfg, False))
    want = plain["step_logits"]
    check(bool(torch.isfinite(want).all()), f"{cfg.name}: non-finite plain logits")
    check(plain["launches"]["prefill"]["flash_attention"] == 0,
          f"{cfg.name}: the plain path launched {plain['launches']}")
    rel, rel_by_step = logit_rel_err(got, want)
    rel_pert, rel_pert_by_step = [], []
    for seed in PERTURB_SEEDS:
        noisy = {name: perturbed(torch, getattr(params, name), seed) for name in perturb}
        r, by_step = logit_rel_err(
            teacher_forced(with_tops(params, **noisy), cfg, False)["step_logits"], want)
        del noisy
        rel_pert.append(r)
        rel_pert_by_step.append(by_step)
    bound = PERTURB_FACTOR * min(rel_pert)
    check(rel <= bound, f"{cfg.name}: kernels move the logits by {rel:.3e} of max |logit|, "
          f"beyond {PERTURB_FACTOR} x the least effect of a {PERTURB_REL} perturbation "
          f"of {perturb} ({min(rel_pert):.3e})")
    cut_cfg = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    cut = with_tops(params, cut_cfg, params.layers[:CUT_LAYERS])
    cut_k, cut_p = teacher_forced(cut, cut_cfg, True), teacher_forced(cut, cut_cfg, False)
    rel_cut, rel_cut_by_step = logit_rel_err(cut_k["step_logits"], cut_p["step_logits"])
    check(rel_cut <= SERVE_CUT_TOL, f"{cfg.name}, {CUT_LAYERS} layers: logits differ "
          f"from the plain path by {rel_cut:.3e} of max |logit|")
    check(cut_k["launches"]["prefill"]["flash_attention"] == CUT_LAYERS,
          f"{cfg.name}, {CUT_LAYERS} layers: prefill launched {cut_k['launches']['prefill']}")
    return {
        "plain": plain, "plain_routing": plain_routing,
        "gates": {
            "logits_finite": True, "max_abs_logit": float(want.abs().max()),
            "rel_err_vs_plain": rel, "rel_err_vs_plain_by_step": rel_by_step,
            "perturbed": list(perturb), "perturbation_rel": PERTURB_REL,
            "perturbation_seeds": list(PERTURB_SEEDS),
            "rel_err_perturbed_plain": rel_pert,
            "rel_err_perturbed_plain_by_step": rel_pert_by_step,
            "rel_err_over_least_perturbation": rel / min(rel_pert),
            "perturbation_factor": PERTURB_FACTOR, "rel_err_bound": bound,
            "cut_layers": CUT_LAYERS, "cut_rel_err_vs_plain": rel_cut,
            "cut_rel_err_by_step": rel_cut_by_step, "cut_tolerance_rel": SERVE_CUT_TOL,
            "cut_launches_per_prefill": cut_k["launches"]["prefill"],
            "plain_argmax_equals_tokens": float((want.argmax(-1) == tokens).float().mean()),
        }}


def routed(run):
    """run()'s result and each MoE router call's (expert index [B, S, K],
    router probabilities [B, S, E]) over it, in call order (a spy on
    `repro_torch.models.moe.router_decisions`, which `moe_ffn` calls)."""
    from repro_torch.models import moe

    real, log = moe.router_decisions, []

    def spy(params, h, top_k):
        out = real(params, h, top_k)
        log.append((out[0], moe.router_probs(params, h)))
        return out

    moe.router_decisions = spy
    try:
        return run(), log
    finally:
        moe.router_decisions = real


def check_serve_launches(cfg, res: dict, launches: dict, flash_per_prefill: int) -> None:
    """flash_attention launches once per attention layer in the prefill,
    never in decode, and no other kernel launches."""
    want = {"flash_attention": flash_per_prefill, "ssm_scan": 0}
    check(res["launches"]["prefill"] == want,
          f"{cfg.name}: prefill launched {res['launches']['prefill']}")
    check(res["launches"]["decode"] == {"flash_attention": 0, "ssm_scan": 0},
          f"{cfg.name}: decode launched {res['launches']['decode']}")
    check(launches["flash_attention"] == flash_per_prefill
          and all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"{cfg.name}: launches over the run {launches}")


def serve_record(res: dict, plain: dict, peak: dict, baseline: int, card: str) -> dict:
    """A serving phase's times, memory and launches beside its predictions."""
    measured = res["peak_memory_bytes"]
    return {
        "arch": res["cfg"].name, "num_layers": res["cfg"].num_layers,
        "batch": res["tokens"].shape[0], "prompt_positions": res["prompt_positions"],
        "decode_tokens": res["tokens"].shape[1], "decode_steps": res["decode_steps"],
        "dtype": "f32", "num_params": res["num_params"],
        "prefill_ms": res["prefill_ms"], "decode_ms_per_step": res["decode_ms_per_step"],
        "decode_tokens_per_s": res["decode_tokens_per_s"],
        "plain_prefill_ms": plain["prefill_ms"],
        "plain_decode_ms_per_step": plain["decode_ms_per_step"],
        "peak_memory_bytes": measured, "memory_before_bytes": baseline, **peak,
        "peak_over_prediction": measured / peak["predicted_peak_bytes"],
        "launches_per_prefill": res["launches"]["prefill"],
        "launches_over_decode": res["launches"]["decode"],
        "sample": res["tokens"][0].tolist(), "card": card,
    }


def phase_serve_vlm(torch, card: str, shared: dict) -> dict:
    """pixtral-12b at full width and depth in f32 through the serving entry
    point (seed 0, batch 4, prompt 512 = 256 patches + 256 text tokens, 32
    tokens): 40 flash_attention launches a prefill, none a decode step;
    the gates of `serve_gates`, perturbing `embed` and `frontend_proj`."""
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    argv = ["--arch", VLM_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(SERVE_PROMPT), "--decode-tokens", str(SERVE_TOKENS), "--seed", "0"]
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = kernel_counts()
    cfg, params = res["cfg"], res["params"]
    check(res["device"].startswith(DEVICE), f"serve ran on {res['device']}")
    check(cfg.num_layers == 40 and cfg.d_model == 5120 and cfg.frontend == "vision_text",
          f"serve_vlm: {cfg.name}'s layout")
    res["prompt_positions"] = serve.prompt_length(res["prompts"])
    check(res["prompt_positions"] == SERVE_PROMPT
          and res["prompts"]["patches"].shape[1] == cfg.num_patches,
          f"serve_vlm: prompt {res['prompt_positions']} positions")
    check_serve_launches(cfg, res, launches, cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    gated = serve_gates(torch, res, ("embed", "frontend_proj"), SERVE_TOKENS)
    res["peak_memory_bytes"] = max(res["peak_memory_bytes"], torch.cuda.max_memory_allocated())
    peak = serve_peak_prediction(cfg, params, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                                 ("embed", "frontend_proj"), baseline)
    shared["serve_vlm"] = {"launches": launches}
    out = serve_record(res, gated["plain"], peak, baseline, card)
    out.update(gated["gates"], launches_over_run=launches,
               profile=serving_profile(torch, res))
    return out


def routing_diffs(torch, got: list, want: list, layers: int, E: int, C: int) -> dict:
    """The MoE's routing on the kernel path (`got`) against the plain
    path's (`want`), each the (expert_index, probs) of every `moe_ffn`
    call of a prefill and its decode steps (layers calls each, in order):
    per layer, the decisions that differ, the plain path's top-1/top-2
    probability gap of each differing token (each must lie below
    NEAR_TIE_GAP), and the tokens each expert dropped at the prefill's
    capacity C on the kernel path."""
    check(len(got) == len(want) and len(got) % layers == 0,
          f"routing records {len(got)} and {len(want)} over {layers} layers")
    differ, gaps, decisions = [0] * layers, [[] for _ in range(layers)], [0] * layers
    max_dprob = [0.0] * layers
    for call, ((gi, gp), (wi, wp)) in enumerate(zip(got, want)):
        layer = call % layers
        decisions[layer] += wi.numel()
        bad = (gi != wi).any(-1)  # [B, S]
        top2 = torch.topk(wp, 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1])[bad]
        differ[layer] += int(bad.sum())
        gaps[layer] += gap.tolist()
        same = ~bad
        if bool(same.any()):
            max_dprob[layer] = max(max_dprob[layer],
                                   float((gp - wp).abs().amax(-1)[same].max()))
    worst = max((g for lg in gaps for g in lg), default=0.0)
    check(worst < NEAR_TIE_GAP, f"serve_moe: a routing decision differs at a top-1/top-2 "
          f"gap of {worst:.3e} (not a near-tie: {NEAR_TIE_GAP})")
    dropped = []
    for layer in range(layers):
        idx = got[layer][0][..., 0]  # the prefill's call of this layer, [B, S]
        counts = torch.stack([(idx == e).sum(-1) for e in range(E)], -1)  # [B, E]
        dropped.append(torch.clamp_min(counts - C, 0).sum(0).tolist())
    return {"decisions_per_layer": decisions, "differing_per_layer": differ,
            "differing_plain_gaps_per_layer": gaps, "near_tie_gap": NEAR_TIE_GAP,
            "max_abs_dprob_same_decision_per_layer": max_dprob,
            "prefill_capacity": C, "prefill_dropped_per_layer_expert": dropped}


def phase_serve_moe(torch, card: str, shared: dict) -> dict:
    """llama4-scout-17b-a16e at full width cut to MOE_LAYERS layers in f32
    through `serve.generate` (seed 0 weights, seed 1 prompts, batch 4,
    prompt 512, 32 tokens): one flash_attention launch per layer a
    prefill, none a decode step; the gates of `serve_gates` (perturbing
    `embed`), and every routing decision that differs from the plain
    path's a near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_caches, init_params, num_params, random_batch
    from repro_torch.models.moe import capacity

    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    with torch.inference_mode():
        params = init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
        batch = random_batch(torch.Generator(device=DEVICE).manual_seed(1), cfg,
                             SERVE_BATCH, SERVE_PROMPT)
        prompts = {"tokens": batch["tokens"]}
        caches = init_caches(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                             torch.float32, DEVICE)
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    zero_counts()
    res, routing = routed(lambda: serve.generate(params, cfg, prompts, caches, SERVE_TOKENS))
    torch.cuda.synchronize()
    launches = kernel_counts()
    del caches
    check_serve_launches(cfg, res, launches, cfg.num_layers)
    res.update(cfg=cfg, params=params, prompts=prompts, num_params=num_params(params),
               prompt_positions=SERVE_PROMPT)
    gated = serve_gates(torch, res, ("embed",), SERVE_TOKENS)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    C = capacity(SERVE_PROMPT, cfg.top_k, cfg.capacity_factor, cfg.num_experts)
    routes = routing_diffs(torch, routing, gated["plain_routing"], cfg.num_layers,
                           cfg.num_experts, C)
    peak = serve_peak_prediction(cfg, params, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                                 ("embed",), baseline)
    shared["serve_moe"] = {"launches": launches}
    out = serve_record(res, gated["plain"], peak, baseline, card)
    out.update(gated["gates"], routing=routes, launches_over_run=launches,
               profile=serving_profile(torch, res),
               cut_from_layers=get_config(MOE_ARCH).num_layers,
               experts=cfg.num_experts, top_k=cfg.top_k, dispatch=cfg.moe_dispatch)
    return out


def phase_encode_audio(torch, card: str, shared: dict) -> dict:
    """hubert-xlarge at full width and depth in f32 (seed 0 weights, seed 1
    frames, batch 4, 512 frames) through `embed_inputs` -> `forward` ->
    `logits_from_hidden`: 48 non-causal flash_attention launches an
    encode; the logits against the plain versions within PERTURB_FACTOR
    times the least of what three PERTURB_REL perturbations of the frames
    do."""
    from repro_torch.configs import get_config
    from repro_torch.models import (embed_inputs, forward, init_params,
                                    logits_from_hidden, num_params, random_batch)

    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(AUDIO_ARCH)
    with torch.inference_mode():
        params = init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
        frames = random_batch(torch.Generator(device=DEVICE).manual_seed(1), cfg,
                              SERVE_BATCH, SERVE_PROMPT)["frames"]

    def encode(frames, use_kernel=True):
        with torch.inference_mode():
            h, caches, _ = forward(params, cfg, embed_inputs(params, cfg, {"frames": frames}),
                                   use_kernel=use_kernel)
            return logits_from_hidden(params, cfg, h)

    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    got = encode(frames)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel_counts()
    check(launches["flash_attention"] == cfg.num_layers == 48
          and all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"encode_audio: launches {launches}")
    check(got.shape == (SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(got).all()), "encode_audio: logits")
    want = encode(frames, use_kernel=False)
    check(bool(torch.isfinite(want).all()), "encode_audio: non-finite plain logits")
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    rel_pert = [float((encode(perturbed(torch, frames, seed), False) - want).abs().max())
                / scale for seed in PERTURB_SEEDS]
    bound = PERTURB_FACTOR * min(rel_pert)
    check(rel <= bound, f"encode_audio: kernels move the logits by {rel:.3e} of max "
          f"|logit|, beyond {PERTURB_FACTOR} x the least effect of a {PERTURB_REL} "
          f"perturbation of the frames ({min(rel_pert):.3e})")
    ms = time_ms(torch, lambda: encode(frames), reps=3, warmup=1)
    plain_ms = time_ms(torch, lambda: encode(frames, False), reps=3, warmup=1)
    weights = model_bytes(params)
    shared["encode_audio"] = {"launches": launches}
    return {
        "arch": cfg.name, "num_layers": cfg.num_layers, "batch": SERVE_BATCH,
        "frames": SERVE_PROMPT, "causal": cfg.causal, "dtype": "f32",
        "num_params": num_params(params), "launches_per_encode": launches,
        "encode_ms": ms, "first_encode_wall_ms": first_ms, "plain_encode_ms": plain_ms,
        "frames_per_s": SERVE_BATCH * SERVE_PROMPT / ms * 1e3,
        "max_abs_logit": scale, "rel_err_vs_plain": rel, "perturbed": ["frames"],
        "perturbation_rel": PERTURB_REL, "perturbation_seeds": list(PERTURB_SEEDS),
        "rel_err_perturbed_plain": rel_pert,
        "rel_err_over_least_perturbation": rel / min(rel_pert),
        "perturbation_factor": PERTURB_FACTOR, "rel_err_bound": bound,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "memory_before_bytes": baseline, "weights_bytes": weights, "card": card,
    }


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
    gt_update.launches = gt_update.leaf_updates = 0
    t0 = time.perf_counter()
    gap = run_gaps(torch, core, prob, rnd, THEOREM1_ROUNDS)
    wall = time.perf_counter() - t0
    launches, leaf_updates = gt_update.launches, gt_update.leaf_updates
    seg = gap[(gap > 1e-14) & (gap < 1e2)]
    rates = np.diff(np.log(seg))
    want = fix["thm1_gap"][: len(gap)]
    err = trajectory_error(np, gap, want)
    check((launches, leaf_updates) == (THEOREM1_ROUNDS * 9, THEOREM1_ROUNDS * 9 * 2),
          f"theorem1: {launches} kernel launches, {leaf_updates} leaf updates")
    check(gap[-1] < 1e-18, f"theorem1: final gap {gap[-1]:.3e} >= 1e-18")
    check(bool(np.all(rates < 0)), "theorem1: a log-gap rate is not negative")
    check(np.std(rates) < 0.25 * abs(np.mean(rates)), "theorem1: rate not steady")
    check(err <= TOL_GAP_RTOL, f"theorem1: gap off JAX's by {err:.3e} relative")
    return {
        "rounds": THEOREM1_ROUNDS, "cut": "1000 of the fixture's 4000 rounds",
        "final_gap": float(gap[-1]), "jax_final_gap": float(want[-1]),
        "mean_log_rate": float(np.mean(rates)), "rate_std": float(np.std(rates)),
        "max_rel_err_vs_jax": err, "tolerance": TOL_GAP_RTOL,
        "gt_update_launches": launches, "gt_update_leaf_updates": leaf_updates,
        "wall_s": wall,
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
    zero_counts()
    t0 = time.perf_counter()
    _, got = core.run_rounds(kernel_round, x0, x0, prob.agent_data, rounds, record)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {k: kernel_counts()[k] for k in ("gt_update", "gt_update_leaves")}
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
    check(launches == gt_counts(rounds * (K - 1)),
          f"main_path: gt_update {launches}, expected {gt_counts(rounds * (K - 1))} "
          "(x and y in one launch a local step)")
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


# ------------------------------------- stochastic and client-sampling rounds
#: normal draws on the card against the port's CPU draws, in ulp: CUDA's
#: log1p is another implementation than the CPU's (each within ~1 ulp), and
#: erf_inv's polynomial carries the difference (the CPU against JAX: 3 and
#: 30 ulp, tests/test_torch_prng.py)
DRAW_ULP = {"torch.float32": 8, "torch.float64": 64}


def ulp_diff(np, a, b) -> int:
    """Largest distance in units in the last place of two float arrays of
    one dtype (same-sign finite values)."""
    ut = {4: np.int32, 8: np.int64}[a.dtype.itemsize]
    return int(np.max(np.abs(a.view(ut).astype(np.int64) - b.view(ut).astype(np.int64))))


def phase_device_draws(torch, np, card: str) -> dict:
    """The seeded draws on the card against the port's CPU draws: randint and
    permutation bit for bit, normal within DRAW_ULP; key batches equal to
    stacked single-key draws; the time of a noisy main-path round's draw."""
    from repro_torch import prng

    key = prng.PRNGKey(11)
    batch = prng.fold_in(prng.split(key, 16), 3)  # [16, 2]
    evals = prng.fold_in(batch[None], np.arange(11)[:, None])  # [11, 16, 2]
    out = {"randint": {}, "permutation": {}, "normal": {}}
    for dt in (torch.int64, torch.int32):
        for lo, hi in ((0, 8192), (0, 1000), (-5, 2 ** 31 - 7), (3, 3)):
            got = prng.randint(evals, (4096,), lo, hi, dt, DEVICE).cpu()
            want = prng.randint(evals, (4096,), lo, hi, dt, "cpu")
            same = torch.equal(got, want)
            check(same, f"device_draws: randint {dt} [{lo}, {hi}) differs")
            out["randint"][f"{dt}[{lo},{hi})"] = same
    for n in (16, 2000, 1 << 20):
        same = torch.equal(prng.permutation(key, n, DEVICE).cpu(),
                           prng.permutation(key, n, "cpu"))
        check(same, f"device_draws: permutation of {n} differs")
        out["permutation"][str(n)] = same
    leaf_keys = prng.fold_in(prng.split(evals)[..., 0, :][None], np.arange(2)[:, None, None])
    for dt in (torch.float32, torch.float64):
        got = prng.normal(leaf_keys, (4096,), dt, DEVICE).cpu().numpy()
        want = prng.normal(leaf_keys, (4096,), dt, "cpu").numpy()
        ulp = ulp_diff(np, got, want)
        share = float(np.mean(got != want))
        check(ulp <= DRAW_ULP[str(dt)], f"device_draws: normal {dt} {ulp} ulp off "
                                        f"the CPU's (bound {DRAW_ULP[str(dt)]})")
        check(abs(float(got.mean())) < 0.01 and abs(float(got.std()) - 1) < 0.01,
              f"device_draws: normal {dt} moments {got.mean()} {got.std()}")
        out["normal"][str(dt)] = {"max_ulp_vs_cpu": ulp, "share_differing": share,
                                  "bound_ulp": DRAW_ULP[str(dt)],
                                  "draws": int(got.size)}
    stacked = torch.stack([prng.normal(k, (4096,), torch.float64, DEVICE)
                           for k in evals[0]])
    check(torch.equal(stacked, prng.normal(evals[0], (4096,), torch.float64, DEVICE)),
          "device_draws: a key batch differs from stacked single-key draws")
    # one noisy main-path round's draw: x and y, 11 evaluations, 16 agents
    ms = time_ms(torch, lambda: prng.normal(leaf_keys, (4096,), torch.float64,
                                            DEVICE), reps=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        prng.normal(leaf_keys, (4096,), torch.float64, DEVICE)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    out["round_draw"] = {"shape": [2, 11, 16, 4096], "dtype": "torch.float64",
                         "device_ms": ms, "wall_ms": wall_ms, "card": card}
    return out


def phase_stochastic_claims(torch, np) -> dict:
    """Section 4's separation, PartialParticipation on the Theorem 1 problem
    and the noisy fixture runs, on the card against JAX's numbers."""
    from repro_torch.fixtures import (
        SEC4, load_stochastic_rounds, noisy_run, partial_run, sec4_run_gaps)

    fix = load_stochastic_rounds()
    rounds = SEC4[-1]
    out, gaps = {}, {}
    for run in ("gt", "ls", "hi", "lo"):
        zero_counts()
        t0 = time.perf_counter()
        gaps[run] = sec4_run_gaps(run, DEVICE)
        wall = time.perf_counter() - t0
        want = fix[f"sec4_{run}_gap"]
        part = parting_round(np, gaps[run], want, TOL_GAP_RTOL)
        check(part is None, f"stochastic_claims sec4 {run}: gap parts from JAX's "
                            f"at round {part}")
        out[f"sec4_{run}"] = {"final_gap": float(gaps[run][-1]),
                              "jax_final_gap": float(want[-1]),
                              "max_rel_err_vs_jax": trajectory_error(np, gaps[run], want),
                              "ms_per_round": wall / rounds * 1e3,
                              "launches": kernel_counts()}
    g_gt = gaps["gt"]
    seg = g_gt[(g_gt > 1e-14) & (g_gt < 1e2)]
    rates = np.diff(np.log(seg))
    floor = {run: float(gaps[run][-100:].mean()) for run in ("ls", "hi", "lo")}
    claims = {
        "noiseless_below_1e-20": bool(g_gt[-1] < 1e-20),
        "noiseless_linear": bool(np.all(rates < 0)
                                 and np.std(rates) < 0.25 * abs(np.mean(rates))),
        "local_sgda_floor_above_1e-2": floor["ls"] > 1e-2,
        "sagda_floor_below_1e-4_of_local": floor["hi"] < 1e-4 * floor["ls"],
        "variance_floor_ratio_30_300": 30.0 < floor["hi"] / floor["lo"] < 300.0,
        "variance_floor_above_noiseless": floor["lo"] > float(g_gt[-1]),
    }
    for name, ok in claims.items():
        check(ok, f"stochastic_claims: Section 4 claim {name} fails ({floor})")
    zero_counts()
    t0 = time.perf_counter()
    masks, pgap = partial_run(DEVICE)
    wall = time.perf_counter() - t0
    same_masks = bool(np.array_equal(masks, fix["partial_mask"]))
    part = parting_round(np, pgap, fix["partial_gap"], TOL_GAP_RTOL)
    check(same_masks, "stochastic_claims: participation masks differ from JAX's")
    check(part is None, f"stochastic_claims: partial gap parts from JAX's at {part}")
    out["partial_thm1"] = {"masks_bitwise": same_masks, "rounds": len(masks),
                           "final_gap": float(pgap[-1]),
                           "max_rel_err_vs_jax": trajectory_error(
                               np, pgap, fix["partial_gap"]),
                           "ms_per_round": wall / len(masks) * 1e3,
                           "launches": kernel_counts()}
    zero_counts()
    t0 = time.perf_counter()
    xr = noisy_run("robust5_minibatch", DEVICE)
    wall = time.perf_counter() - t0
    err = robust_rel_err(np, xr, fix["noisy_robust5_minibatch_x"])
    check(err <= ROBUST_X_RTOL[5.0], f"stochastic_claims: minibatch robust5 x off "
                                     f"JAX's by {err:.3e}")
    out["robust5_minibatch"] = {"x_rel_err_vs_jax": err,
                                "rtol": ROBUST_X_RTOL[5.0], "wall_s": wall,
                                "launches": kernel_counts()}
    zero_counts()
    cgap = noisy_run("thm1_cgt_randk", DEVICE)
    part = parting_round(np, cgap, fix["noisy_thm1_cgt_randk_gap"], TOL_GAP_RTOL)
    check(part is None, f"stochastic_claims: noisy rand-k gap parts at {part}")
    out["thm1_cgt_randk_noisy"] = {
        "max_rel_err_vs_jax": trajectory_error(np, cgap, fix["noisy_thm1_cgt_randk_gap"]),
        "launches": kernel_counts()}
    return {"runs": out, "claims": claims, "floors": floor,
            "tolerance": TOL_GAP_RTOL, "sec4_rounds": rounds}


def phase_stochastic_main_path(torch, card: str, shared: dict, rounds: int) -> dict:
    """The main path's problem (d=4096, m=16, f64) under SAGDA with Gaussian
    noise, PartialParticipation 0.5 and noisy QuantizedGT over the wire:
    iterates through the kernels equal the plain path's bit for bit (the
    same draws feed both), with the kernels' launches, ms per round, the
    device's busy share and the draws' share of launches and time."""
    from repro_torch import core
    from repro_torch.core.engine import round_eval_keys, rounds_ahead
    from repro_torch.fed import (
        SAGDA, GaussianNoise, PartialParticipation, QuantizedGT)

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m = prob.agent_data, prob.num_agents
    noise = GaussianNoise(sigma=0.1)
    runs = {
        "sagda_gaussian": (SAGDA(noise=noise), gt_counts(K * rounds)),
        "partial_gt_50": (PartialParticipation(participation=0.5, seed=0),
                          gt_counts((K - 1) * rounds)),
        "quantized_wire_gaussian": (
            QuantizedGT(bits=8, ratio=0.25, mode="topk", wire_transport=True,
                        noise=noise),
            {**gt_counts(K * rounds), "pack_payload": 2 * rounds,
             "unpack_payload": 2 * rounds}),
    }

    def record(x, y):
        return {"x": x, "y": y,
                "gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)}

    out = {}
    for tag, (strategy, expected) in runs.items():
        plain = (dataclasses.replace(strategy, use_kernel=False)
                 if hasattr(strategy, "use_kernel") else strategy)
        rnd = core.make_round(prob.loss, strategy, K, eta, explicit_state=True)
        rnd_plain = core.make_round(prob.loss, plain, K, eta, explicit_state=True,
                                    update_fn=core.default_update)
        rnd(x0, x0, data, strategy.init_state(x0, x0, m))  # warm-up rounds
        rnd_plain(x0, x0, data, plain.init_state(x0, x0, m))
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
        check(same, f"stochastic_main_path {tag}: kernel iterates differ from "
                    "the plain path's")
        for name, n in expected.items():
            check(launches[name] == n, f"stochastic_main_path {tag}: "
                  f"{launches[name]} {name} launches, expected {n}")
        check(bool(torch.isfinite(got["x"]).all() and torch.isfinite(got["y"]).all()),
              f"stochastic_main_path {tag}: non-finite iterates")
        gap = got["gap"].cpu().numpy()
        # the profiled round is the second: its draws come from the first
        # round's pass (a pass's cost is in "draws" below)
        st0 = strategy.init_state(x0, x0, m)
        x1, y1, st1 = rnd(x0, x0, data, st0)
        prof = profile_round(torch, lambda: rnd(x1, y1, data, st1), {
            "gt_update": "gt_update_kernel", "pack_payload": "pack_kernel",
            "unpack_payload": "unpack_kernel"})
        info = {"strategy": repr(strategy), "rounds": rounds, "K": K,
                "ms_per_round_kernels": kernel_s / rounds * 1e3,
                "ms_per_round_plain": plain_s / rounds * 1e3,
                "gap_first": float(gap[0]), "gap_last": float(gap[-1]),
                "bitwise_kernels_vs_plain": same, "launches": launches,
                "profile": prof, "card": card}
        if strategy.noise is not None:
            # one broadcast's pass: this round's draws and the next ones'
            xs0 = core.tree_broadcast_agents(x0, m)
            ahead = rounds_ahead(strategy.noise, K + 1, xs0, xs0, data)
            keys, s = [], st0
            for _ in range(ahead):
                k, s = strategy.sample_noise_keys(s, m)
                keys.append(k)
            evals = round_eval_keys(torch.stack(keys), K + 1).reshape(-1, m, 2)
            dprof = profile_round(
                torch, lambda: strategy.noise.draws(evals, xs0, xs0, data), {})
            per = {"launches": dprof.get("kernel_launches", 0) / ahead,
                   "device_ms": dprof.get("device_busy_ms", 0.0) / ahead,
                   "wall_ms": dprof["round_wall_ms"] / ahead}
            info["draws"] = {
                "rounds_per_pass": ahead,
                "launches_per_pass": dprof.get("kernel_launches"),
                "device_ms_per_pass": dprof.get("device_busy_ms"),
                "wall_ms_per_pass": dprof["round_wall_ms"],
                "launches_per_round": per["launches"],
                "device_ms_per_round": per["device_ms"],
                "wall_ms_per_round": per["wall_ms"],
                "share_of_round_launches": per["launches"] / max(
                    1, prof.get("kernel_launches", 1) + per["launches"]),
                "share_of_round_device_ms": per["device_ms"] / max(
                    1e-9, prof.get("device_busy_ms", 1.0) + per["device_ms"])}
        out[tag] = info
    return out


# ------------------------------------------------- the elastic population
#: flaky rows of the elastic benchmark held to JAX's per-round gaps at its
#: full T (1200 rounds), and the headline each must keep
ELASTIC_ROWS_HELD = ("fedgda_gt", "fedgda_gt_norebase", "local_sgda")
ELASTIC_RESUME = 100  # CompressedGT: 100 rounds + tail(100) against 200


def gap_band_error(np, got, want, lo: float, hi: float) -> float:
    """Largest relative gap difference on rounds with lo < JAX's gap <= hi
    (0 when there is none): measured, not gated, below the gates' floor."""
    sel = (want > lo) & (want <= hi)
    return float(np.max(np.abs(got[sel] - want[sel]) / want[sel])) if sel.any() else 0.0


def phase_elastic_claims(torch, np) -> dict:
    """The elastic benchmark on JAX's numbers (the `elastic_rounds`
    fixture): the four scenarios' schedules drawn on the card bit for bit
    (dense and chunked), the flaky headline rows per round against JAX's
    gaps, a checkpointed CompressedGT resume bit for bit, and the table's
    bytes."""
    import math
    import shutil

    from repro_torch import sim
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.fed import FederatedRunner, resolve_strategy
    from repro_torch.fixtures import (
        ELASTIC, ELASTIC_ROWS, ELASTIC_SCENARIOS, ELASTIC_TABLE_COLS,
        elastic_problem, elastic_run_gaps, load_elastic_rounds)

    fix = load_elastic_rounds()
    dim, _, m, K, eta, T, seed = ELASTIC
    out = {"schedules": {}, "rows": {}}
    schedules = {}
    for scenario in ELASTIC_SCENARIOS:
        t0 = time.perf_counter()
        sched = sim.make_population(scenario, m).schedule(seed, T, K, device=DEVICE)
        dense_s = time.perf_counter() - t0
        chunked = sim.make_population(scenario, m).chunked_schedule(
            seed, T, K, chunk_rounds=64, device=DEVICE).materialize()
        same = {"active": bool(np.array_equal(sched.active, fix[f"{scenario}_active"])),
                "budgets": bool(np.array_equal(sched.budgets,
                                               fix[f"{scenario}_budgets"])),
                "chunked": bool(np.array_equal(chunked.active, sched.active)
                                and np.array_equal(chunked.budgets, sched.budgets))}
        check(all(same.values()), f"elastic_claims: {scenario} schedule differs "
                                  f"from JAX's ({same})")
        schedules[scenario] = sched
        out["schedules"][scenario] = {"bitwise": same, "draw_s": dense_s,
                                      "participation": sched.participation_rate()}
    gaps = {}
    for row in ELASTIC_ROWS_HELD:
        zero_counts()
        t0 = time.perf_counter()
        gaps[row] = elastic_run_gaps(row, schedules["flaky"], DEVICE)
        wall = time.perf_counter() - t0
        want = fix[f"flaky_{row}_gap"]
        part = parting_round(np, gaps[row], want, TOL_GAP_RTOL)
        check(part is None, f"elastic_claims flaky {row}: gap parts from JAX's at "
                            f"round {part}")
        hit = np.nonzero(gaps[row] <= 1e-6)[0]
        out["rows"][row] = {
            "rounds": T, "final_gap": float(gaps[row][-1]),
            "jax_final_gap": float(want[-1]),
            "rounds_to_1e-6": int(hit[0]) if hit.size else None,
            "max_rel_err_vs_jax": trajectory_error(np, gaps[row], want),
            "max_rel_err_gap_1e-18_to_1e-14": gap_band_error(np, gaps[row], want,
                                                             1e-18, 1e-14),
            "ms_per_round": wall / T * 1e3, "launches": kernel_counts()}
    gt = gaps["fedgda_gt"]
    claims = {
        "rebase_reaches_1e-6_at_jax_round_138":
            out["rows"]["fedgda_gt"]["rounds_to_1e-6"] == 138,
        "rebase_ends_below_1e-18": bool(gt[-1] < 1e-18),
        "norebase_ends_above_1e+2": bool(gaps["fedgda_gt_norebase"][-1] > 1e2),
        "local_sgda_never_reaches_1e-6": bool((gaps["local_sgda"] > 1e-6).all()),
    }
    for name, ok in claims.items():
        check(ok, f"elastic_claims: headline {name} fails")
    # a checkpointed CompressedGT run resumed from round 100 with its
    # elastic_state and strategy_state equals the uninterrupted 200 rounds
    prob, _, _ = elastic_problem(DEVICE)
    flaky = sim.RoundSchedule(schedules["flaky"].active[:2 * ELASTIC_RESUME],
                              schedules["flaky"].budgets[:2 * ELASTIC_RESUME], K)
    base = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(base, ignore_errors=True)
    name, kw, _ = ELASTIC_ROWS["compressed_gt_25"]
    x0 = torch.zeros(dim, dtype=torch.float64, device=DEVICE)
    zero_counts()
    full = FederatedRunner.from_strategy(
        prob.loss, resolve_strategy(name, **kw), prob.agent_data, K, eta,
        checkpoint_dir=str(base), checkpoint_every=ELASTIC_RESUME)
    xf, yf = full.run(x0, x0, 2 * ELASTIC_RESUME, schedule=flaky)
    ck = restore_checkpoint(str(base / f"ckpt_{ELASTIC_RESUME:08d}.npz"), DEVICE)
    resumed = FederatedRunner.from_strategy(
        prob.loss, resolve_strategy(name, **kw), prob.agent_data, K, eta)
    xr, yr = resumed.run(ck["x"], ck["y"], ELASTIC_RESUME, state=ck["strategy_state"],
                         schedule=flaky.tail(ELASTIC_RESUME),
                         elastic_state=ck["elastic_state"])
    torch.cuda.synchronize()
    launches = kernel_counts()
    shutil.rmtree(base, ignore_errors=True)
    same = {"x": torch.equal(xf, xr), "y": torch.equal(yf, yr),
            **{k: torch.equal(full._state[k].cpu(), resumed._state[k].cpu())
               for k in full._state},
            **{f"tracker_{k}": torch.equal(full.elastic_state["tracker"][k],
                                           resumed.elastic_state["tracker"][k])
               for k in full.elastic_state["tracker"]}}
    check(all(same.values()), f"elastic_claims: resumed CompressedGT != "
                              f"uninterrupted ({same})")
    check(launches["compress_correction"] == 2 * 3 * ELASTIC_RESUME,
          f"elastic_claims: {launches['compress_correction']} compress_correction "
          f"launches in the resume check, expected {6 * ELASTIC_RESUME}")
    out["resume"] = {"rounds": f"{2 * ELASTIC_RESUME} uninterrupted; "
                               f"checkpoint at {ELASTIC_RESUME}, restore, "
                               f"{ELASTIC_RESUME} more",
                     "bitwise": same, "launches": launches}
    # the table's active-set bytes and participation against JAX's
    cols = {c: i for i, c in enumerate(ELASTIC_TABLE_COLS)}
    bad = []
    for key, want in zip(fix["table_keys"], fix["table"]):
        scenario, row = str(key).split("/")
        name, kw, _ = ELASTIC_ROWS[row]
        per_round = sim.schedule_bytes(resolve_strategy(name, **kw), x0, x0, K,
                                       schedules[scenario])
        r_eps = want[cols["rounds_to_eps"]]
        total = math.inf if math.isinf(r_eps) else sum(per_round[: int(r_eps) + 1])
        if (int(np.mean(per_round)) != want[cols["bytes_per_round"]]
                or total != want[cols["total_bytes_to_eps"]]
                or schedules[scenario].participation_rate()
                != want[cols["participation"]]):
            bad.append(str(key))
    check(not bad, f"elastic_claims: table bytes differ from JAX's for {bad}")
    out["table_rows_equal"] = len(fix["table_keys"])
    return {"runs": out, "claims": claims, "tolerance": TOL_GAP_RTOL,
            "gap_floor": 1e-14}


def phase_elastic_main_path(torch, np, card: str, shared: dict, rounds: int) -> dict:
    """The main path's problem (d=4096, m=16, f64) under a flaky schedule
    (seed 0, K=10) through `FederatedRunner`: FedGDA-GT with rebasing
    through gt_update and CompressedGT top-k 0.1 over the wire through
    pack / unpack, each bitwise equal to the plain path; a stable round
    forced through `make_elastic_round` against `make_round` (rtol 1e-12);
    ms and launches per round beside the static FedGDA-GT round's."""
    from repro_torch import core, sim
    from repro_torch.fed import CompressedGT, FederatedRunner, GradientTracking

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m = prob.agent_data, prob.num_agents
    t0 = time.perf_counter()
    sched = sim.make_population("flaky", m).schedule(0, rounds, K, device=DEVICE)
    draw_s = time.perf_counter() - t0
    check(not sched.is_static_full, "elastic_main_path: the flaky schedule is full")
    runs = {
        "gt_rebase": (GradientTracking(), None, gt_counts((K - 1) * rounds)),
        "compressed_wire": (
            CompressedGT(compression_ratio=0.1, mode="topk", wire_transport=True),
            CompressedGT(compression_ratio=0.1, mode="topk", wire_transport=True,
                         use_kernel=False),
            {**gt_counts(K * rounds), "pack_payload": 2 * rounds,
             "unpack_payload": 2 * rounds}),
    }
    out = {"schedule": {"n_active": sched.active.sum(axis=1).tolist(),
                        "draw_s": draw_s}}

    def counted_run(strategy, schedule, **kw):
        """A runner's rounds with each round's kernel launches (snapshots
        taken by the metric, which also syncs the round)."""
        per_round, last = [], {}

        def metric(x, y):
            nonlocal last
            now = kernel_counts()
            per_round.append({k: now[k] - last.get(k, 0) for k in now if now[k]})
            last = now
            return {"gap": core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)}

        runner = FederatedRunner.from_strategy(prob.loss, strategy, data, K, eta,
                                               metric_fn=metric, **kw)
        torch.cuda.synchronize()
        zero_counts()
        x, y = runner.run(x0, x0, rounds, schedule=schedule)
        torch.cuda.synchronize()
        return runner, x, y, per_round

    for tag, (strategy, plain, expected) in runs.items():
        # one warm-up round each side
        FederatedRunner.from_strategy(prob.loss, strategy, data, K, eta).run(
            x0, x0, 1, schedule=sched)
        kr, xk, yk, per_round = counted_run(strategy, sched)
        launches = kernel_counts()
        if plain is None:
            pr, xp, yp, _ = counted_run(strategy, sched, update_fn=core.default_update)
        else:
            pr, xp, yp, _ = counted_run(plain, sched)
        same = {"x": torch.equal(xk, xp), "y": torch.equal(yk, yp),
                **{k: torch.equal(kr._state[k].cpu(), pr._state[k].cpu())
                   for k in (kr._state or {})},
                **{f"tracker_{k}": torch.equal(v, pr.elastic_state["tracker"][k])
                   for k, v in kr.elastic_state["tracker"].items()}}
        check(all(same.values()), f"elastic_main_path {tag}: kernel iterates "
                                  f"differ from the plain path's ({same})")
        for name, n in expected.items():
            check(launches[name] == n, f"elastic_main_path {tag}: {launches[name]} "
                                       f"{name} launches, expected {n}")
        gap = kr.metric_series("gap")
        check(bool(np.isfinite(gap).all()) and gap[-1] < gap[0],
              f"elastic_main_path {tag}: gap {gap[0]:.3e} -> {gap[-1]:.3e}")
        ms = [h.seconds * 1e3 for h in kr.history]
        plain_ms = [h.seconds * 1e3 for h in pr.history]
        out[tag] = {"strategy": repr(strategy), "rounds": rounds, "K": K,
                    "ms_per_round": ms, "ms_per_round_plain": plain_ms,
                    "launches_per_round": per_round, "launches": launches,
                    "gap_first": float(gap[0]), "gap_last": float(gap[-1]),
                    "bitwise_kernels_vs_plain": same, "card": card}
    # the static FedGDA-GT round of the same run, and one round of each
    # under the profiler (all launches, busy share)
    sr, _, _, static_per_round = counted_run(GradientTracking(), None)
    out["static_gt"] = {"ms_per_round": [h.seconds * 1e3 for h in sr.history],
                        "launches_per_round": list(static_per_round)}
    er = FederatedRunner.from_strategy(prob.loss, GradientTracking(), data, K, eta)
    x1, y1 = er.run(x0, x0, 1, schedule=sched)
    tail, el = sched.tail(1), er.elastic_state
    out["profile_elastic_gt"] = profile_round(
        torch, lambda: er.run(x1, y1, 1, schedule=tail, elastic_state=el),
        {"gt_update": "gt_update_kernel", "where": "where"})
    out["profile_static_gt"] = profile_round(
        torch, lambda: sr.run(x1, y1, 1), {"gt_update": "gt_update_kernel"})
    # a stable round forced through the elastic round against make_round
    strat = GradientTracking()
    ernd = sim.make_elastic_round(prob.loss, strat, K, eta)
    active = torch.ones(m, dtype=torch.bool, device=DEVICE)
    tracker = sim.init_tracker(prob.loss, strat, x0, x0, data)
    xe, ye, _, _ = ernd(x0, x0, data, {}, tracker, sim.renormalized_weights(active),
                        torch.full((m,), K, dtype=torch.int64, device=DEVICE),
                        active, active)
    xm, ym = core.make_round(prob.loss, strat, K, eta)(x0, x0, data)
    rel = max(float((xe - xm).abs().max() / xm.abs().max()),
              float((ye - ym).abs().max() / ym.abs().max()))
    check(rel <= 1e-12, f"elastic_main_path: forced stable round off make_round's "
                        f"by {rel:.3e}")
    out["stable_forced_vs_make_round"] = {"max_rel_err": rel, "rtol": 1e-12}
    return out


# ------------------------------------------- the O(active) sparse engine
#: the sparse runs on the card against JAX's final iterates (the CPU test
#: holds them per round to 1e-12), relative to max |JAX iterate|
SPARSE_JAX_RTOL = 1e-10
#: forced sparse against the dense elastic runner: JAX's own tolerance
SPARSE_DENSE_RTOL, SPARSE_DENSE_ATOL = 1e-8, 1e-10
#: the mega's iterates against JAX's (synthesized from normals within a
#: few ulp of JAX's)
MEGA_RTOL = 1e-9


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want| (want as numpy)."""
    want = torch.from_numpy(want)
    return float((got.cpu() - want).abs().max() / want.abs().max())


def dense_close(torch, a, b) -> bool:
    return bool(torch.allclose(a, b, rtol=SPARSE_DENSE_RTOL, atol=SPARSE_DENSE_ATOL))


def phase_sparse_claims(torch, np) -> dict:
    """The O(active) engine on JAX's numbers (`sparse_rounds` fixture): the
    m=8 runs of the six families (the schedule bitwise JAX's; the dense
    fallback bitwise the dense elastic runner, forced sparse within rtol
    1e-8 / atol 1e-10 of it, each within SPARSE_JAX_RTOL of JAX's final
    iterates), a sparse resume via tail(3) bitwise, the pod engine's live
    pods and wire bytes equal JAX's, and the mega preset at 1e6 agents
    beside its 1e4 reference (`benchmarks.elastic.pods_peaks`): ids,
    budgets, live pods, pod wire bytes and tracker counts equal JAX's, the
    iterates within MEGA_RTOL, the memory gate held."""
    from repro_torch import sim
    from repro_torch.benchmarks import elastic as bench
    from repro_torch.fed import FederatedRunner, GradientTracking, resolve_strategy
    from repro_torch.fixtures import (
        MEGA, MEGA_COUNTS, SPARSE, SPARSE_FAMILIES, SPARSE_PODS, load_sparse_rounds,
        sparse_population, sparse_problem)

    fix = load_sparse_rounds()
    dim, _, m, _, K, eta, T, seed = SPARSE
    prob = sparse_problem(DEVICE)
    src = sim.ArrayDataSource(prob.agent_data)
    x0 = torch.zeros(dim, dtype=torch.float64, device=DEVICE)
    scheds = {}
    for k in (1, K):
        scheds[k] = sparse_population().sparse_schedule(seed, T, k, device=DEVICE)
        same = (np.array_equal(np.stack([ev.active_ids for ev in scheds[k]]),
                               fix["m8_ids"])
                and np.array_equal(np.stack([ev.budgets for ev in scheds[k]]),
                                   fix[f"m8_budgets_k{k}"]))
        check(same, f"sparse_claims: the m=8 schedule (K={k}) differs from JAX's")
    out = {"families": {}}
    launches = {}
    for fam, (name, kw, Kf) in SPARSE_FAMILIES.items():
        sched = scheds[Kf]
        ref = FederatedRunner.from_strategy(prob.loss, resolve_strategy(name, **kw),
                                            prob.agent_data, Kf, eta)
        xr, yr = ref.run(x0, x0, T, schedule=sched.densify())
        res = {}
        for path, fallback in (("dense", 4096), ("sparse", 0)):
            eng = sim.SparseElasticEngine(prob.loss, resolve_strategy(name, **kw),
                                          src, Kf, eta, dense_fallback_max_m=fallback)
            zero_counts()
            x, y = eng.run(x0, x0, sched)
            torch.cuda.synchronize()
            launches[f"{path}_{fam}"] = kernel_counts()
            err = max(rel_err(torch, x, fix[f"{path}_{fam}_x"]),
                      rel_err(torch, y, fix[f"{path}_{fam}_y"]))
            check(err <= SPARSE_JAX_RTOL, f"sparse_claims {fam} {path}: "
                                          f"{err:.3e} off JAX's iterates")
            res[path] = {"max_rel_err_vs_jax": err,
                         "ms_per_round": [h["seconds"] * 1e3 for h in eng.history]
                         if path == "sparse" else None}
            if path == "dense":
                res[path]["bitwise_vs_dense_runner"] = bool(
                    torch.equal(x, xr) and torch.equal(y, yr))
                check(res[path]["bitwise_vs_dense_runner"],
                      f"sparse_claims {fam}: the dense fallback != the dense runner")
            elif fam != "quantized_gt":  # its rounding draws [n rows], not [m]
                res[path]["close_to_dense_runner"] = dense_close(torch, x, xr) \
                    and dense_close(torch, y, yr)
                check(res[path]["close_to_dense_runner"],
                      f"sparse_claims {fam}: forced sparse off the dense runner")
        out["families"][fam] = res
    # a sparse resume via tail(3) equals the uninterrupted run bit for bit
    mk = lambda: sim.SparseElasticEngine(prob.loss, GradientTracking(), src, K, eta,
                                         dense_fallback_max_m=0)
    xf, yf = mk().run(x0, x0, scheds[K])
    split = mk()
    xm, ym = split.run(x0, x0, scheds[K], num_rounds=3)
    xs, ys = split.run(xm, ym, scheds[K].tail(3), resume=True)
    out["resume_tail_bitwise"] = bool(torch.equal(xf, xs) and torch.equal(yf, ys))
    check(out["resume_tail_bitwise"], "sparse_claims: sparse resume != uninterrupted")
    # the pod engine: live pods and packed partial bytes a round, JAX's
    pop = sparse_population(SPARSE_PODS)
    eng = sim.SparseElasticEngine(prob.loss, GradientTracking(), src, K, eta,
                                  pod_map=pop.pod_map(), wire_pods=True,
                                  dense_fallback_max_m=0)
    zero_counts()
    x, y = eng.run(x0, x0, pop.sparse_schedule(seed, T, K, device=DEVICE))
    torch.cuda.synchronize()
    launches["pods"] = kernel_counts()
    counts = {w: [h[w] for h in eng.history] for w in ("live_pods", "pod_wire_bytes")}
    same = all(counts[w] == fix[f"pods_{w}"].tolist() for w in counts)
    err = max(rel_err(torch, x, fix["pods_x"]), rel_err(torch, y, fix["pods_y"]))
    check(same, f"sparse_claims: pod counts {counts} differ from JAX's")
    check(err <= SPARSE_JAX_RTOL, f"sparse_claims pods: {err:.3e} off JAX's")
    out["pods"] = {**counts, "max_rel_err_vs_jax": err}
    # the mega preset at 1e6 agents beside its 1e4 reference, under the
    # memory gate's measurement (host trace, device max_memory_allocated)
    t0 = time.perf_counter()
    zero_counts()
    peaks = bench.pods_peaks(DEVICE)
    torch.cuda.synchronize()
    launches["mega_pair"] = kernel_counts()
    out["mega_pair_s"] = time.perf_counter() - t0
    for label, run in peaks.pop("runs").items():
        key = label.split("_")[0]
        mm, active, n_pods, rounds = MEGA[key]
        pop = sim.Population(mm, sim.UniformActiveSubset(size=active),
                             sim.UniformStragglers(0.3, 0.5), pods=n_pods)
        sched = pop.sparse_schedule(bench.SEED, rounds, bench.K, device=DEVICE)
        same_sched = (np.array_equal(np.stack([ev.active_ids for ev in sched]),
                                     fix[f"{key}_ids"])
                      and np.array_equal(np.stack([ev.budgets for ev in sched]),
                                         fix[f"{key}_budgets"]))
        got = {"live_pods": [h["live_pods"] for h in run["engine"].history],
               "pod_wire_bytes": [h["pod_wire_bytes"] for h in run["engine"].history],
               "tracker_touched": run["tracker_touched"]}
        same = all(got[w] == fix[f"{key}_{w}"].tolist() for w in MEGA_COUNTS)
        err = max(rel_err(torch, run["x"], fix[f"{key}_x"]),
                  rel_err(torch, run["y"], fix[f"{key}_y"]))
        check(same_sched, f"sparse_claims {label}: schedule differs from JAX's")
        check(same, f"sparse_claims {label}: counts {got} differ from JAX's")
        check(err <= MEGA_RTOL, f"sparse_claims {label}: {err:.3e} off JAX's")
        out[label] = {**got, **peaks[label], "max_rel_err_vs_jax": err,
                      "schedule_bitwise": same_sched,
                      "ms_per_round": [h["seconds"] * 1e3
                                       for h in run["engine"].history]}
    out["gate"] = {"budget_bytes": peaks["budget_bytes"], "ok": peaks["ok"],
                   "rule": "mega total <= 1.5 x ref total + 24 MiB (host + device)"}
    check(peaks["ok"], f"sparse_claims: the memory gate fails ({out['gate']})")
    print(f"sparse_claims peaks: ref host {out['ref_1e4']['host_peak_bytes']} B "
          f"device {out['ref_1e4']['device_peak_bytes']} B; mega host "
          f"{out['mega_1e6']['host_peak_bytes']} B device "
          f"{out['mega_1e6']['device_peak_bytes']} B; budget "
          f"{peaks['budget_bytes']} B", flush=True)
    return {"runs": out, "launches": launches,
            "tolerance": {"vs_jax": SPARSE_JAX_RTOL, "mega_vs_jax": MEGA_RTOL,
                          "vs_dense": [SPARSE_DENSE_RTOL, SPARSE_DENSE_ATOL]}}


def count_syncs(torch, fn) -> int:
    """fn() under CUDA's sync debug mode: the number of host-device
    synchronizations torch reports (its one-time notice that the mode is a
    prototype is not one)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
               for w in seen)


class DrawnSchedule:
    """A sparse schedule's events drawn up front (what the engine reads:
    len, [t], m, tail), so a timed run measures the engine, not the
    schedule's per-round draws on the card (measured apart)."""

    def __init__(self, m: int, events: list):
        self.m, self.events = m, events

    def __len__(self) -> int:
        return len(self.events)

    def __getitem__(self, t: int):
        return self.events[t]

    def tail(self, start: int) -> "DrawnSchedule":
        return DrawnSchedule(self.m, self.events[start:])


def phase_sparse_main_path(torch, np, card: str, shared: dict, rounds: int) -> dict:
    """The main path's problem (d=4096, m=16, f64, G 2.1 GB as an
    `ArrayDataSource`, K=10) through the O(active) engine, forced sparse:
    8 of 16 active a round (`UniformActiveSubset`, `UniformStragglers(0.3,
    0.5)`, 4 pods, seed 0), 10 rounds of (i) FedGDA-GT with the pod
    partials over the wire (gt_update, pack_payload) and (ii) CompressedGT
    top-k 0.1 with its EF rows realigned each round (gt_update,
    compress_correction): each bitwise equal to the plain path (iterates,
    state, tracker) and within rtol 1e-8 / atol 1e-10 of the dense
    elastic runner on `schedule.densify()`; ms a round beside that
    runner's, launches and host syncs a round, one profiled round, peak
    memory."""
    from repro_torch import core, sim
    from repro_torch.fed import CompressedGT, FederatedRunner, GradientTracking
    from repro_torch.fed import pods as fpods

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m = prob.agent_data, prob.num_agents
    pop = sim.Population(m, sim.UniformActiveSubset(size=m // 2),
                         sim.UniformStragglers(p_straggle=0.3, min_frac=0.5), pods=4)
    # the schedule's own cost: each event drawn on the card as the engine
    # reads it (ids, then budgets), timed and profiled apart
    lazy = pop.sparse_schedule(0, rounds, K, device=DEVICE)
    lazy[0]  # first-call setup
    lazy = pop.sparse_schedule(0, rounds, K, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = [lazy[t] for t in range(rounds)]
    draw_ms = (time.perf_counter() - t0) / rounds * 1e3
    draw_syncs = count_syncs(torch, lambda: pop.sparse_schedule(
        0, rounds, K, device=DEVICE)[rounds - 1])
    draw_prof = profile_round(torch, lambda: pop.sparse_schedule(
        0, rounds, K, device=DEVICE)[rounds - 1], {})
    sched = DrawnSchedule(m, events)
    dense_sched = lazy.densify()
    src = sim.ArrayDataSource(data)
    runs = {
        "gt_wire_pods": (GradientTracking(), GradientTracking(), True,
                         {**gt_counts((K - 1) * rounds), "pack_payload": 2 * rounds}),
        "compressed_topk": (
            CompressedGT(compression_ratio=0.1, mode="topk"),
            CompressedGT(compression_ratio=0.1, mode="topk", use_kernel=False), False,
            {**gt_counts(K * rounds), "compress_correction": 2 * rounds}),
    }
    out = {"schedule": {"ids": [ev.active_ids.tolist() for ev in events],
                        "live_pods": [len(pop.pod_map().live_pods(ev.active_ids))
                                      for ev in events],
                        "draw_ms_per_round": draw_ms,
                        "draw_host_syncs_per_round": draw_syncs,
                        "draw_profile": {k: draw_prof.get(k) for k in (
                            "round_wall_ms", "device_busy_ms", "kernel_launches")}}}
    gap = lambda x, y: float(core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys))

    def engine(strategy, wire, plain=False):
        kw = {"update_fn": core.default_update, "use_kernel": False} if plain else {}
        return sim.SparseElasticEngine(prob.loss, strategy, src, K, eta,
                                       pod_map=pop.pod_map(), wire_pods=wire,
                                       dense_fallback_max_m=0, **kw)

    for tag, (strategy, plain, wire, expected) in runs.items():
        # one warm-up round each side
        engine(strategy, wire).run(x0, x0, sched, num_rounds=1)
        engine(plain, wire, plain=True).run(x0, x0, sched, num_rounds=1)
        ke = engine(strategy, wire)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        xk, yk = ke.run(x0, x0, sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() - base
        pe = engine(plain, wire, plain=True)
        xp, yp = pe.run(x0, x0, sched)
        torch.cuda.synchronize()
        tk, tp = ke._tracker, pe._tracker
        same = {"x": torch.equal(xk, xp), "y": torch.equal(yk, yp),
                "sum_gx": torch.equal(tk.sum_gx, tp.sum_gx),
                "sum_gy": torch.equal(tk.sum_gy, tp.sum_gy),
                "rows": all(np.array_equal(a[:tk.num_touched], b[:tp.num_touched])
                            for a, b in zip(tk._gx_leaves + tk._gy_leaves,
                                            tp._gx_leaves + tp._gy_leaves)),
                **{k: torch.equal(ke._state[k].cpu(), pe._state[k].cpu())
                   for k in ke._state}}
        check(all(same.values()), f"sparse_main_path {tag}: kernel path differs "
                                  f"from the plain path ({same})")
        for name, n in expected.items():
            check(launches[name] == n, f"sparse_main_path {tag}: {launches[name]} "
                                       f"{name} launches, expected {n}")
        # the dense elastic runner on the densified schedule, same run
        dr = FederatedRunner.from_strategy(prob.loss, strategy, data, K, eta)
        dr.run(x0, x0, 1, schedule=dense_sched)  # warm-up
        dr = FederatedRunner.from_strategy(prob.loss, strategy, data, K, eta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd, yd = dr.run(x0, x0, rounds, schedule=dense_sched)
        torch.cuda.synchronize()
        dense_wall = time.perf_counter() - t0
        close = dense_close(torch, xk, xd) and dense_close(torch, yk, yd)
        rel = max(float((xk - xd).abs().max() / xd.abs().max()),
                  float((yk - yd).abs().max() / yd.abs().max()))
        check(close, f"sparse_main_path {tag}: {rel:.3e} off the dense elastic runner")
        g0, g1 = gap(x0, x0), gap(xk, yk)
        check(np.isfinite(g1) and g1 < g0, f"sparse_main_path {tag}: gap {g0:.3e} -> "
                                           f"{g1:.3e}")
        # host syncs of a round (sync debug mode), and one profiled round
        syncs = count_syncs(torch, lambda: engine(strategy, wire).run(
            x0, x0, sched, num_rounds=2))
        init = engine(strategy, wire)
        init_syncs = count_syncs(torch, lambda: init.run(x0, x0, sched, num_rounds=1))
        x1, y1 = init.run(x0, x0, sched, num_rounds=1)
        prof = profile_round(torch, lambda: init.run(
            x1, y1, sched.tail(1), num_rounds=1, resume=True),
            {"gt_update": "gt_update_kernel", "pack_payload": "pack_kernel",
             "compress_correction": "compress_"})
        info = {"strategy": repr(strategy), "rounds": rounds, "K": K,
                "ms_per_round": [h["seconds"] * 1e3 for h in ke.history],
                "ms_per_round_wall": wall / rounds * 1e3,
                "dense_elastic_ms_per_round": [h.seconds * 1e3 for h in dr.history],
                "dense_elastic_ms_per_round_wall": dense_wall / rounds * 1e3,
                "launches": launches,
                "launches_per_round": {k: v / rounds for k, v in launches.items() if v},
                "host_syncs_per_round": syncs - init_syncs,
                "host_syncs_first_round_with_init": init_syncs,
                "bitwise_kernels_vs_plain": same, "max_rel_err_vs_dense": rel,
                "gap_first": g0, "gap_last": g1, "peak_bytes": peak,
                "live_pods": [h["live_pods"] for h in ke.history],
                "profile": prof, "card": card}
        if wire:
            info["pod_wire_bytes"] = [h["pod_wire_bytes"] for h in ke.history]
            partials, packed = ke.last_pod_wire
            unpacks = kernel_counts()["unpack_payload"]
            back = fpods.decode_pod_partials(packed)
            torch.cuda.synchronize()
            info["pod_roundtrip"] = {
                "bitwise": all(torch.equal(a, b) for a, b in zip(partials, back)),
                "unpack_payload_launches": kernel_counts()["unpack_payload"] - unpacks}
            check(info["pod_roundtrip"]["bitwise"],
                  f"sparse_main_path {tag}: pod partials do not round-trip")
        out[tag] = info
    return out


# -------------------------------- the async runtime and the telemetry sink
#: the async runtime's shards on the one card: one CUDA stream each
ASYNC_SHARDS = 4
#: async against sync iterates (tests/test_async_runtime.py's tolerance)
ASYNC_RTOL, ASYNC_ATOL = 1e-9, 1e-12
#: where the telemetry phase writes its ledger and profile trace
#: (inside the checkout's ignored build directory)
SMOKE_OUT = ROOT / "build" / "chip_smoke"


def allclose_err(torch, got, want, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 is numpy's
    allclose."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def kernel_streams_by(torch, run, matchers: dict) -> dict:
    """The streams (profiler ids) that CUDA kernels ran on over one run(),
    with their counts, from the Chrome trace of a profiler session:
    {key: {stream: count}} for each (key, predicate on the kernel's name),
    {} for a key whose kernels the trace puts on no stream."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    SMOKE_OUT.mkdir(parents=True, exist_ok=True)
    path = SMOKE_OUT / "streams.pt.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    counts = {key: {} for key in matchers}
    for ev in trace.get("traceEvents", []):
        stream = ev.get("args", {}).get("stream")
        if ev.get("cat") != "kernel" or stream is None:
            continue
        for key, match in matchers.items():
            if match(ev.get("name", "")):
                counts[key][str(stream)] = counts[key].get(str(stream), 0) + 1
    return counts


#: the launch sites the round engine and the strategies call, by kernel:
#: (module, attribute), patched with a spy that reads the current stream
#: (the callers' names: a wrapper counts its launches through its own;
#: the engine's local step is one `gt_update_many` call over x and y)
LAUNCH_SITES = {"gt_update": ("repro_torch.kernels.ops", "gt_update_many"),
                "pack_payload": ("repro_torch.fed.transport", "pack_payload_2d"),
                "compress_correction": ("repro_torch.fed.strategies", "compress_leaf")}
#: the kernels' names in the profiler's trace (unpack_kernel also holds
#: "pack_kernel")
TRACE_NAMES = {
    "gt_update": lambda n: "gt_update_kernel" in n,
    "pack_payload": lambda n: ("pack_kernel" in n or "pack_stream_kernel" in n)
    and "unpack" not in n,
    "compress_correction": lambda n: "compress_kernel" in n or "compress_staged_kernel" in n,
}


def launch_streams(torch, run, names) -> dict:
    """The current stream at each launch site of `names` over one run():
    {name: {stream handle: calls}} (a spy on the wrapper its caller calls)."""
    import importlib

    seen = {name: collections.Counter() for name in names}
    saved = []
    for name in names:
        mod, attr = LAUNCH_SITES[name]
        mod = importlib.import_module(mod)
        real = getattr(mod, attr)

        def spy(z, *a, _real=real, _name=name, **kw):
            lead = z[0] if isinstance(z, (list, tuple)) else z
            seen[_name][torch.cuda.current_stream(lead.device).cuda_stream] += 1
            return _real(z, *a, **kw)

        saved.append((mod, attr, real))
        setattr(mod, attr, spy)
    try:
        run()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return {name: dict(c) for name, c in seen.items()}


def phase_async_main_path(torch, np, card: str, shared: dict, rounds: int) -> dict:
    """The main path's problem (d=4096, m=16, f64, K=10) through
    `AsyncFederatedRunner(devices=[cuda] * 4)`: 4 shards of 4 agents, one
    CUDA stream each, for FedGDA-GT, CompressedGT top-k 0.1 over the wire,
    FullSync and FedGDA-GT under a flaky schedule (MarkovChurn 0.6 / 0.4,
    uniform stragglers 0.3 / 0.5, seed 0) that leaves whole shards out.
    Each against `FederatedRunner` in the same run: iterates within rtol
    1e-9 / atol 1e-12, ms a round (sync, async, async, sync), the kernels'
    launches, host syncs and all CUDA launches a round, and the streams the
    gt_update launches ran on (4 distinct, the runner's own, read at the
    launch site and in the profiler's trace; either missing fails).  A
    second async run with a full telemetry sink equals the first bit for
    bit (the disabled-equals-enabled pin)."""
    from repro_torch import core, sim
    from repro_torch.fed import (
        AsyncFederatedRunner,
        CompressedGT,
        FederatedRunner,
        FullSync,
        GradientTracking,
    )
    from repro_torch.obs import Telemetry

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m = prob.agent_data, prob.num_agents
    devices = [torch.device(DEVICE, 0)] * ASYNC_SHARDS
    per = m // ASYNC_SHARDS
    pop = sim.Population(m, sim.MarkovChurn(p_leave=0.6, p_join=0.4),
                         sim.UniformStragglers(p_straggle=0.3, min_frac=0.5))
    sched = pop.schedule(0, rounds, K, device=DEVICE)
    live = [[bool(sched.active[t, i * per:(i + 1) * per].any())
             for i in range(ASYNC_SHARDS)] for t in range(rounds)]
    n_live = sum(map(sum, live))
    check(n_live < ASYNC_SHARDS * rounds,
          "async_main_path: the flaky schedule skips no shard")
    S = ASYNC_SHARDS
    runs = {
        "gt": (GradientTracking, None, gt_counts(S * (K - 1) * rounds)),
        "compressed_wire": (
            lambda: CompressedGT(compression_ratio=0.1, mode="topk",
                                 wire_transport=True), None,
            {**gt_counts(S * K * rounds), "pack_payload": 2 * rounds,
             "unpack_payload": 2 * rounds}),
        "full_sync": (FullSync, None, gt_counts(0)),
        "gt_flaky": (GradientTracking, sched, gt_counts(n_live * (K - 1))),
    }
    gap = lambda x, y: core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)
    out = {"shards": S, "devices": [str(d) for d in devices],
           "flaky_schedule": {"n_active": sched.active.sum(axis=1).tolist(),
                              "live_shards": live}}

    def timed(runner, kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, y = runner.run(x0, x0, rounds, **kw)
        torch.cuda.synchronize()
        return x, y, (time.perf_counter() - t0) / rounds * 1e3

    def make_async(make, tm=None):
        return AsyncFederatedRunner(prob.loss, make(), data, K, eta, devices=devices,
                                    telemetry=tm)

    for tag, (make, schedule, expected) in runs.items():
        kw = {} if schedule is None else {"schedule": schedule}
        # one warm-up round each side
        make_async(make).run(x0, x0, 1, **kw)
        FederatedRunner.from_strategy(prob.loss, make(), data, K, eta).run(
            x0, x0, 1, **kw)
        xs1, ys1, sync_ms = timed(
            FederatedRunner.from_strategy(prob.loss, make(), data, K, eta), kw)
        # the main path: counts at 0 just before, read just after
        tm = Telemetry()
        ar = make_async(make, tm)
        handles = [s.cuda_stream for s in ar._streams if s is not None]
        check(len(set(handles)) == S and ar._n_shards == S,
              f"async_main_path {tag}: not {S} streams")
        torch.cuda.synchronize()
        zero_counts()
        xa, ya, async_ms = timed(ar, kw)
        launches = kernel_counts()
        # the disabled-equals-enabled pin: a full sink (every probe, a gap
        # oracle) on a second runner
        full = Telemetry(probes=("gt_residual", "ef_residual", "priced_vs_measured",
                                 "duality_gap"), gap_fn=gap)
        xb, yb, async2_ms = timed(make_async(make, full), kw)
        _, _, sync2_ms = timed(
            FederatedRunner.from_strategy(prob.loss, make(), data, K, eta), kw)
        pin = torch.equal(xa, xb) and torch.equal(ya, yb)
        check(pin, f"async_main_path {tag}: a telemetry sink moved the iterates "
                   f"(max |diff| {float((xa - xb).abs().max()):.3e})")
        err = max(allclose_err(torch, xa, xs1, ASYNC_RTOL, ASYNC_ATOL),
                  allclose_err(torch, ya, ys1, ASYNC_RTOL, ASYNC_ATOL))
        rel = max(float((xa - xs1).abs().max() / xs1.abs().max()),
                  float((ya - ys1).abs().max() / ys1.abs().max()))
        check(err <= 1.0, f"async_main_path {tag}: {rel:.3e} off the sync runner "
                          f"(allclose ratio {err:.3e})")
        for name, n in expected.items():
            check(launches[name] == n, f"async_main_path {tag}: {launches[name]} "
                                       f"{name} launches, expected {n}")
        g0, g1 = float(gap(x0, x0)), float(gap(xa, ya))
        check(np.isfinite(g1) and g1 < g0, f"async_main_path {tag}: gap {g0:.3e} -> "
                                           f"{g1:.3e}")
        skipped = [(e["round"], e["shard"]) for e in tm.series("event", "shard_skipped")]
        if schedule is not None:
            check(skipped == [(t, i) for t in range(rounds) for i in range(S)
                              if not live[t][i]],
                  f"async_main_path {tag}: skipped shards {skipped}")
        # host syncs a round (two rounds less one), one profiled round of
        # each runtime, and the streams of the gt_update launches
        r1, r2 = make_async(make), make_async(make)
        syncs = count_syncs(torch, lambda: r2.run(x0, x0, 2, **kw)) - count_syncs(
            torch, lambda: r1.run(x0, x0, 1, **kw))
        s1 = FederatedRunner.from_strategy(prob.loss, make(), data, K, eta)
        s2 = FederatedRunner.from_strategy(prob.loss, make(), data, K, eta)
        sync_syncs = count_syncs(torch, lambda: s2.run(x0, x0, 2, **kw)) - \
            count_syncs(torch, lambda: s1.run(x0, x0, 1, **kw))
        names = {"gt_update": "gt_update_kernel", "pack_payload": "pack_kernel",
                 "gemv": "gemv"}
        prof = profile_round(torch, lambda: make_async(make).run(x0, x0, 1, **kw),
                             names)
        sync_prof = profile_round(torch, lambda: FederatedRunner.from_strategy(
            prob.loss, make(), data, K, eta).run(x0, x0, 1, **kw), names)
        # the launch site's current stream (a spy on the wrapper the round
        # engine calls) and the profiler's stream ids, over one round
        sr = make_async(make)
        gt_trace = {"gt_update": TRACE_NAMES["gt_update"]}
        traced = {}
        launched = launch_streams(torch, lambda: traced.update(kernel_streams_by(
            torch, lambda: sr.run(x0, x0, 1, **kw), gt_trace)), ["gt_update"])
        launched, streams = launched["gt_update"], traced["gt_update"]
        sync_streams = kernel_streams_by(torch, lambda: FederatedRunner.from_strategy(
            prob.loss, make(), data, K, eta).run(x0, x0, 1, **kw),
            gt_trace)["gt_update"]
        if expected["gt_update"]:
            want = S if schedule is None else sum(live[0])
            per_shard = expected["gt_update"] // (rounds * S if schedule is None
                                                  else n_live)
            own = {s.cuda_stream for s in sr._streams}
            check(set(launched) <= own and len(launched) == want
                  and set(launched.values()) == {per_shard},
                  f"async_main_path {tag}: gt_update launched on streams "
                  f"{launched}, expected {want} of the runner's "
                  f"{sorted(own)} with {per_shard} each")
            check(len(streams) == want, f"async_main_path {tag}: the trace puts "
                                        f"gt_update on {len(streams)} streams "
                                        f"({streams}), expected {want}")
        out[tag] = {
            "strategy": repr(make()), "rounds": rounds, "K": K,
            "ms_per_round_sync_async_async_sync": [sync_ms, async_ms, async2_ms,
                                                   sync2_ms],
            "launches": launches,
            "launches_per_round": {k: v / rounds for k, v in launches.items() if v},
            "cuda_launches_per_round": {"async": prof.get("kernel_launches"),
                                        "sync": sync_prof.get("kernel_launches")},
            "host_syncs_per_round": {"async": syncs, "sync": sync_syncs},
            "gt_update_streams": streams or "none (no gt_update launch)",
            "gt_update_launch_streams": {str(k): v for k, v in launched.items()},
            "gt_update_streams_sync": sync_streams or "not measured",
            "runner_streams": handles,
            "max_rel_diff_vs_sync": rel, "allclose_ratio": err,
            "rtol": ASYNC_RTOL, "atol": ASYNC_ATOL, "sink_pin_bitwise": pin,
            "shard_skipped": skipped, "gap_first": g0, "gap_last": g1,
            "profile_async": prof, "profile_sync": sync_prof, "card": card}
    return out


def phase_telemetry_main_path(torch, np, card: str, shared: dict, rounds: int) -> dict:
    """The sync main path (FedGDA-GT, d=4096, m=16, f64, K=10) with
    telemetry=None and with a full sink (every probe, a gap oracle, a
    `RunLedger`, a `profile_rounds` trace of the last round): iterates
    bitwise equal; the ledger read back, its wire_bytes measured_bytes_per_round
    x m each round; the trace written.  Then the sink's overhead (enabled
    without probes against disabled, interleaved runs) and
    `Telemetry(phase_spans=True)`: each phase's device ms a round and their
    sum against the fused round, iterates bitwise the fused round's."""
    import shutil

    from repro_torch import core
    from repro_torch.fed import FederatedRunner, GradientTracking
    from repro_torch.fed.transport import measured_bytes_per_round
    from repro_torch.obs import RunLedger, Telemetry

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m = prob.agent_data, prob.num_agents
    out_dir = SMOKE_OUT / "telemetry"
    shutil.rmtree(out_dir, ignore_errors=True)
    strategy = GradientTracking()
    runner = FederatedRunner.from_strategy(prob.loss, strategy, data, K, eta)
    runner.run(x0, x0, 1)  # warm-up

    def timed(tm):
        runner.telemetry = tm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, y = runner.run(x0, x0, rounds)
        torch.cuda.synchronize()
        return x, y, (time.perf_counter() - t0) / rounds * 1e3

    xa, ya, off_ms = timed(None)
    ledger = RunLedger(str(out_dir / "ledger"))
    gap = lambda x, y: core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)
    full = Telemetry(ledger=ledger, probes=("gt_residual", "ef_residual",
                                            "priced_vs_measured", "duality_gap"),
                     gap_fn=gap, profile_dir=str(out_dir / "profile"),
                     profile_rounds=(rounds - 1,))
    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    zero_counts()
    xb, yb, full_ms = timed(full)
    launches = kernel_counts()
    ledger.close()
    pin = torch.equal(xa, xb) and torch.equal(ya, yb)
    check(pin, "telemetry_main_path: the sink moved the iterates")
    gt_launches = {k: launches[k] for k in ("gt_update", "gt_update_leaves")}
    check(gt_launches == gt_counts(rounds * (K - 1)),
          f"telemetry_main_path: gt_update {gt_launches}")
    events = RunLedger.events(str(out_dir / "ledger"))
    check(events == json.loads(json.dumps(full.events, default=str)),
          "telemetry_main_path: the ledger does not read back the sink's events")
    measured = int(measured_bytes_per_round(strategy, x0, x0, K))
    wire = [e["value"] for e in events
            if e["kind"] == "counter" and e["name"] == "wire_bytes"]
    check(wire == [measured * m] * rounds,
          f"telemetry_main_path: ledger wire_bytes {wire}, expected "
          f"{measured} x {m} a round")
    traces = full.series("event", "profile_trace")
    check(len(traces) == 1 and os.path.getsize(traces[0]["path"]) > 0,
          f"telemetry_main_path: profile traces {traces}")
    residuals = full.probe_series("gt_residual")
    check(len(residuals) == rounds and max(residuals) < 1e-6,
          f"telemetry_main_path: GT residuals {residuals}")
    # the sink's overhead: disabled / enabled-without-probes chunks in turns
    chunks = {"disabled": [], "enabled": []}
    for _ in range(4):
        for mode, tm in (("disabled", None), ("enabled", Telemetry())):
            chunks[mode].append(timed(tm)[2])
    low = {k: float(np.mean(sorted(v)[:2])) for k, v in chunks.items()}
    # per-phase device time: each phase span ends in a synchronize
    tm = Telemetry(phase_spans=True)
    xc, yc, phase_ms = timed(tm)
    runner.telemetry = None
    check(torch.equal(xa, xc) and torch.equal(ya, yc),
          "telemetry_main_path: the phase-by-phase round differs from the fused one")
    phases = {p: [e["seconds"] * 1e3 for e in tm.series("span", p)]
              for p in ("broadcast", "exchange_corrections", "local_steps",
                        "aggregate")}
    per_round_sum = [sum(v) for v in zip(*phases.values())]
    return {
        "strategy": repr(strategy), "rounds": rounds, "K": K,
        "bitwise_disabled_vs_full_sink": pin, "launches": launches,
        "ms_per_round": {"disabled": off_ms, "full_sink": full_ms,
                         "phase_spans": phase_ms},
        "overhead": {"chunks_ms_per_round": chunks, "low2_mean": low,
                     "enabled_over_disabled": low["enabled"] / low["disabled"] - 1},
        "phase_ms_per_round": phases,
        "phase_sum_ms_per_round": per_round_sum,
        "phase_sum_over_fused_round": float(np.median(per_round_sum)) / low["disabled"],
        "ledger": {"events": len(events), "wire_bytes_per_round": wire[0],
                   "measured_bytes_per_round": measured, "agents": m},
        "profile_trace": {"path": str(Path(traces[0]["path"]).relative_to(ROOT)),
                          "bytes": os.path.getsize(traces[0]["path"])},
        "gt_residual_max": max(residuals),
        "duality_gap_last": full.probe_series("duality_gap")[-1], "card": card}


# ------------------------------------------------ the multi-host launch path
#: the multi-host runner's shards on the one card: one CUDA stream each
MULTIHOST_SHARDS = 4
def phase_multihost_main_path(torch, np, card: str, shared: dict, rounds: int) -> dict:
    """The main path's problem (d=4096, m=16, f64, K=10) through
    `launch.multihost.MultiHostRunner(devices=[cuda] * 4)`: 4 shards of 4
    agents, one CUDA stream each, every shard encoding its own corrections.
    Runs: (a) FedGDA-GT, (b) CompressedGT top-k 0.1 over the wire, (c)
    QuantizedGT 8-bit rand-k 0.25 over the wire (per-shard folded draws),
    (d) CompressedGT top-k 0.1 without the wire (compress_correction on the
    shards' streams).  Gates: (a) within rtol 1e-9 / atol 1e-12 of
    `FederatedRunner`; every round's gathered bytes equal m x the payload
    share of `measured_bytes_per_round`, and `expected_gather_bytes` where
    the payload is packed (b, c; a's dense stack prices as its dense
    LeafSpec); each shard's own decode equals the server's bit for bit (b,
    c); each run through the kernels equals the same run through the plain
    versions bit for bit (iterates, shard states, wire log); the kernels'
    launches; gt_update, pack_payload and compress_correction on the
    runner's 4 streams at the launch site and in the profiler's trace.
    Prints ms a round (sync, multihost, multihost, sync), CUDA launches,
    host syncs and device busy a round."""
    from repro_torch import core
    from repro_torch.fed import (
        CompressedGT,
        FederatedRunner,
        GradientTracking,
        QuantizedGT,
    )
    from repro_torch.fed.transport import dense_payload_bytes, measured_bytes_per_round
    from repro_torch.launch.multihost import MultiHostRunner, expected_gather_bytes

    prob, eta, K, x0 = shared["problem"], shared["eta"], shared["K"], shared["x0"]
    xs, ys = shared["minimax"]
    data, m, dim = prob.agent_data, prob.num_agents, x0.shape[0]
    S = MULTIHOST_SHARDS
    devices = [torch.device(DEVICE, 0)] * S
    dense = 2 * m * dim * x0.element_size()
    steps = gt_counts(S * K * rounds)
    runs = {
        "a_gt": (GradientTracking, gt_counts(S * (K - 1) * rounds)),
        "b_compressed_wire": (
            lambda **kw: CompressedGT(compression_ratio=0.1, mode="topk",
                                      wire_transport=True, **kw),
            {**steps, "pack_payload": 2 * S * rounds,
             "unpack_payload": 2 * S * rounds}),
        "c_quantized_randk_wire": (
            lambda **kw: QuantizedGT(bits=8, ratio=0.25, mode="randk",
                                     wire_transport=True, **kw),
            {**steps, "pack_payload": 2 * S * rounds,
             "unpack_payload": 2 * S * rounds}),
        "d_compressed_dense": (
            lambda **kw: CompressedGT(compression_ratio=0.1, mode="topk", **kw),
            {**steps, "compress_correction": 2 * S * rounds}),
    }
    gap = lambda x, y: core.tree_sq_dist(x, xs) + core.tree_sq_dist(y, ys)
    out = {"shards": S, "devices": [str(d) for d in devices]}

    def timed(runner):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, y = runner.run(x0, x0, rounds)
        torch.cuda.synchronize()
        return x, y, (time.perf_counter() - t0) / rounds * 1e3

    def make_mh(make, plain=False):
        if plain:
            strategy = make() if make is GradientTracking else make(use_kernel=False)
            return MultiHostRunner(prob.loss, strategy, data, K, eta, devices=devices,
                                   update_fn=core.default_update)
        return MultiHostRunner(prob.loss, make(), data, K, eta, devices=devices)

    def make_sync(make):
        return FederatedRunner.from_strategy(prob.loss, make(), data, K, eta)

    for tag, (make, expected) in runs.items():
        strategy = make()
        wire = bool(getattr(strategy, "wire_transport", False))
        # one warm-up round each side
        make_mh(make).run(x0, x0, 1)
        make_sync(make).run(x0, x0, 1)
        xs1, ys1, sync_ms = timed(make_sync(make))
        # the main path: counts at 0 just before, read just after
        mr = make_mh(make)
        handles = [s.cuda_stream for s in mr._streams]
        check(len(set(handles)) == S and mr._n_shards == S,
              f"multihost_main_path {tag}: not {S} streams")
        torch.cuda.synchronize()
        zero_counts()
        xm, ym, mh_ms = timed(mr)
        launches = kernel_counts()
        for name in ("gt_update", "gt_update_leaves", "compress_correction",
                     "pack_payload", "unpack_payload", "flash_attention", "ssm_scan"):
            want = expected.get(name, 0)
            check(launches[name] == want, f"multihost_main_path {tag}: "
                  f"{launches[name]} {name} launches, expected {want}")
        # bytes, every round
        gathered = [e["gathered_payload_bytes"] for e in mr.wire_log]
        share = (measured_bytes_per_round(strategy, x0, x0, K, include_headers=False)
                 - 2 * dense_payload_bytes((x0, x0))) // 2
        priced = expected_gather_bytes(strategy, x0, x0, m)
        check(gathered == [m * share] * rounds,
              f"multihost_main_path {tag}: gathered {gathered}, expected m x "
              f"{share} a round")
        if wire or tag == "a_gt":
            check(gathered == [priced] * rounds, f"multihost_main_path {tag}: "
                  f"gathered {gathered}, expected_gather_bytes {priced}")
        else:
            check(gathered == [dense] * rounds, f"multihost_main_path {tag}: "
                  f"gathered {gathered}, the dense stack is {dense}")
        # the decode pin: each shard's own decode on its stream
        pin = None
        if wire:
            own_x, own_y = mr.decode_on_shards()
            cx, cy = mr.last_exchange["decoded"]
            torch.cuda.synchronize()
            pin = bool(torch.equal(own_x, cx) and torch.equal(own_y, cy))
            check(pin, f"multihost_main_path {tag}: a shard's decode differs from "
                       "the server's")
        # kernels against plain versions, bitwise
        pr = make_mh(make, plain=True)
        zero_counts()
        xp, yp, plain_ms = timed(pr)
        plain_launches = {k: v for k, v in kernel_counts().items() if v}
        check(not plain_launches, f"multihost_main_path {tag}: the plain run "
                                  f"launched {plain_launches}")
        same = {"x": torch.equal(xm, xp), "y": torch.equal(ym, yp),
                "wire_log": mr.wire_log == pr.wire_log,
                **{f"shard{i}_{k}": torch.equal(a[k], b[k])
                   for i, (a, b) in enumerate(zip(mr._state_s, pr._state_s))
                   for k in a if k != "key"},
                **{f"shard{i}_key": torch.equal(a["key"], b["key"])
                   for i, (a, b) in enumerate(zip(mr._state_s, pr._state_s))
                   if "key" in a}}
        check(all(same.values()), f"multihost_main_path {tag}: kernels differ from "
                                  f"the plain versions ({same})")
        xm2, ym2, mh2_ms = timed(make_mh(make))
        check(torch.equal(xm, xm2) and torch.equal(ym, ym2),
              f"multihost_main_path {tag}: two runs differ")
        _, _, sync2_ms = timed(make_sync(make))
        err = max(allclose_err(torch, xm, xs1, ASYNC_RTOL, ASYNC_ATOL),
                  allclose_err(torch, ym, ys1, ASYNC_RTOL, ASYNC_ATOL))
        rel = max(float((xm - xs1).abs().max() / xs1.abs().max()),
                  float((ym - ys1).abs().max() / ys1.abs().max()))
        if tag == "a_gt":
            check(err <= 1.0, f"multihost_main_path {tag}: {rel:.3e} off the sync "
                              f"runner (allclose ratio {err:.3e})")
        g0, g1 = float(gap(x0, x0)), float(gap(xm, ym))
        check(np.isfinite(g1) and g1 < g0, f"multihost_main_path {tag}: gap "
                                           f"{g0:.3e} -> {g1:.3e}")
        # host syncs a round (two rounds less one), one profiled round of
        # each runtime
        r1, r2 = make_mh(make), make_mh(make)
        syncs = count_syncs(torch, lambda: r2.run(x0, x0, 2)) - count_syncs(
            torch, lambda: r1.run(x0, x0, 1))
        s1, s2 = make_sync(make), make_sync(make)
        sync_syncs = count_syncs(torch, lambda: s2.run(x0, x0, 2)) - count_syncs(
            torch, lambda: s1.run(x0, x0, 1))
        names = {"gt_update": "gt_update_kernel", "gemv": "gemv",
                 "compress_correction": "compress_", "unpack": "unpack_kernel"}
        prof = profile_round(torch, lambda: make_mh(make).run(x0, x0, 1), names)
        sync_prof = profile_round(torch, lambda: make_sync(make).run(x0, x0, 1), names)
        # the shards' kernels: the current stream at the launch site and the
        # profiler's stream ids, over one round
        shard_kernels = [k for k in ("gt_update", "pack_payload", "compress_correction")
                         if expected.get(k)]
        sr = make_mh(make)
        own = {s.cuda_stream for s in sr._streams}
        traced = {}
        spied = launch_streams(torch, lambda: traced.update(kernel_streams_by(
            torch, lambda: sr.run(x0, x0, 1),
            {k: TRACE_NAMES[k] for k in shard_kernels})), shard_kernels)
        for k in shard_kernels:
            per_stream = expected[k] // (rounds * S)
            check(set(spied[k]) <= own and len(spied[k]) == S
                  and set(spied[k].values()) == {per_stream},
                  f"multihost_main_path {tag}: {k} launched on streams {spied[k]}, "
                  f"expected the runner's {sorted(own)} with {per_stream} each")
            check(len(traced[k]) == S, f"multihost_main_path {tag}: the trace puts "
                                       f"{k} on {len(traced[k])} streams "
                                       f"({traced[k]}), expected {S}")
        out[tag] = {
            "strategy": repr(strategy), "rounds": rounds, "K": K,
            "ms_per_round_sync_multihost_multihost_sync": [sync_ms, mh_ms, mh2_ms,
                                                           sync2_ms],
            "ms_per_round_plain": plain_ms,
            "launches": launches,
            "launches_per_round": {k: v / rounds for k, v in launches.items() if v},
            "cuda_launches_per_round": {"multihost": prof.get("kernel_launches"),
                                        "sync": sync_prof.get("kernel_launches")},
            "host_syncs_per_round": {"multihost": syncs, "sync": sync_syncs},
            "device_busy_ms": {"multihost": prof.get("device_busy_ms"),
                               "sync": sync_prof.get("device_busy_ms")},
            "gathered_payload_bytes_per_round": gathered[0],
            "expected_gather_bytes": priced, "payload_share_per_agent": share,
            "dense_stack_bytes": dense,
            "gathered_total_bytes_per_round": mr.wire_log[0]["gathered_total_bytes"],
            "decode_pin_bitwise": pin, "bitwise_kernels_vs_plain": same,
            "launch_streams": {k: {str(s): n for s, n in v.items()}
                               for k, v in spied.items()},
            "trace_streams": traced, "runner_streams": handles,
            "max_rel_diff_vs_sync": rel, "allclose_ratio_vs_sync": err,
            "rtol": ASYNC_RTOL, "atol": ASYNC_ATOL, "gap_first": g0, "gap_last": g1,
            "profile_multihost": prof, "profile_sync": sync_prof, "card": card}
    return out


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
        gt_launches = {k: launches[k] for k in ("gt_update", "gt_update_leaves")}
        check(gt_launches == gt_counts(T * (K - 1)),
              f"fig2 alpha={alpha}: gt_update {gt_launches}, expected "
              f"{gt_counts(T * (K - 1))}")
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
        gt_launches = {k: launches[k] for k in ("gt_update", "gt_update_leaves")}
        check(gt_launches == gt_counts(T * (K - 1)),
              f"agnostic {run}: gt_update {gt_launches}")
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
    gt_launches = {k: launches["kernel"][k] for k in ("gt_update", "gt_update_leaves")}
    check(gt_launches == gt_counts(rounds * (K - 1)),
          f"robust_main_path: gt_update {gt_launches}, expected "
          f"{gt_counts(rounds * (K - 1))}")
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
    from repro_torch.kernels import make_gt_update_fn, ref

    z, g, c, eta = state["z"], state["g"], state["c"], state["eta"]
    xy = make_gt_update_fn().pair(z, g, c, eta, z, c, g, eta)
    want = (ref.gt_update_ref(z, g, c, eta, -1.0), ref.gt_update_ref(z, c, g, eta, 1.0))
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(xy, want))
    check(err == 0.0, f"gt_update at the main path's shape: max |err| {err}")
    # times of the main path's step (x and y [16, 4096] f64, one launch),
    # measured in gt_update's phase before any profiler session
    t = shared["timing"]["gt_update"]["main"]
    entries = [{
        "name": "gt_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gt_update.cu",
        "replaces": "src/repro/kernels/gt_update.py:26",
        "launches": launches["gt_update"],
        "leaf_updates": launches["gt_update_leaves"], "max_abs_err": err,
        "tolerance": 0.0, "bitwise_vs_plain": err == 0.0,
        "shape": [2] + t["shape"], "dtypes": [str(z.dtype), str(c.dtype)],
        "ms": t["pair_ms"], "plain_ms": t["plain_ms"],
        "two_one_leaf_calls_ms": t["two_calls_ms"],
        "device_ms_per_call": t.get("device_ms_per_call"),
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        # no single PyTorch call computes z + s*(g + c)
        "library_ms": None, "library": "null: no single PyTorch call computes "
                                       "z + s*(g + c)", "card": card,
    }] + [compressed_entry(name, shared, card) for name in COMPRESSED_KERNELS] + [
        model_entry(name, shared, card) for name in MODEL_KERNELS] + [
        bwd_entry(name, shared, card) for name in BWD_KERNELS]
    # the stochastic and elastic main paths' runs: each kernel's launches
    for entry in entries:
        entry["stochastic_main_path_launches"] = {
            tag: run["launches"][entry["name"]]
            for tag, run in shared.get("stochastic", {}).items()}
        entry["elastic_main_path_launches"] = {
            tag: shared["elastic"][tag]["launches"][entry["name"]]
            for tag in ("gt_rebase", "compressed_wire") if tag in shared.get("elastic", {})}
        entry["sparse_main_path_launches"] = {
            tag: shared["sparse"][tag]["launches"][entry["name"]]
            for tag in ("gt_wire_pods", "compressed_topk")
            if tag in shared.get("sparse", {})}
        entry["async_main_path_launches"] = {
            tag: run["launches"][entry["name"]]
            for tag, run in shared.get("async", {}).items()
            if isinstance(run, dict) and "launches" in run}
        entry["multihost_main_path_launches"] = {
            tag: run["launches"][entry["name"]]
            for tag, run in shared.get("multihost", {}).items()
            if isinstance(run, dict) and "launches" in run}
        entry["train_main_path_launches"] = shared["train"]["launches"][entry["name"]]
        for tag in ("serve_vlm", "serve_moe", "encode_audio"):
            entry[f"{tag}_launches"] = (shared[tag]["launches"][entry["name"]]
                                        if tag in shared else None)
        entry["telemetry_main_path_launches"] = (
            shared["telemetry"]["launches"][entry["name"]]
            if "telemetry" in shared else None)
    return entries


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


#: the host-bound phases on JAX's numbers, in two calls of their own
#: (`--claims 1`, `--claims 2`), each well inside the 1,200 s cut
CLAIMS = {"1": ("theorem1", "sec51", "prop1", "compressed_claims", "fig2"),
          "2": ("agnostic", "stochastic_claims", "elastic_claims", "sparse_claims")}


def main(argv: list) -> int:
    if argv not in ([], *(["--claims", k] for k in CLAIMS)):
        print("usage: python3 chip_smoke.py [--claims 1 | --claims 2]", file=sys.stderr)
        return 2
    claims = CLAIMS[argv[1]] if argv else ()
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
    if claims:
        phases = {
            "theorem1": lambda: phase_theorem1(torch, np, fix),
            "sec51": lambda: phase_sec51(torch, np, fix),
            "prop1": lambda: phase_prop1(torch),
            "compressed_claims": lambda: phase_compressed_claims(torch, np),
            "fig2": lambda: phase_fig2(np, card),
            "agnostic": lambda: phase_agnostic(torch, np, card),
            "stochastic_claims": lambda: phase_stochastic_claims(torch, np),
            "elastic_claims": lambda: phase_elastic_claims(torch, np),
            "sparse_claims": lambda: phase_sparse_claims(torch, np),
        }
        for name in claims:
            run(name, phases[name])
        return finish(ok, t_start, card)
    # the host-bound phases first: a torch.profiler session (pack_payload's
    # device time, flash's library kernels, the profile phases) leaves
    # every later launch ~20% slower on the host (PERF.md §6)
    run("runner_resume", lambda: phase_runner_resume(torch, card))
    run("device_draws", lambda: phase_device_draws(torch, np, card))
    run("gt_update", lambda: phase_gt_update(torch, card, cases, shared))
    run("compress_correction", lambda: phase_compress_correction(torch, card, shared))
    run("pack_payload", lambda: phase_pack_payload(torch, card, shared))
    if "payloads" in shared:
        run("unpack_payload", lambda: phase_unpack_payload(torch, card, shared))
    if "device_time_runs" in shared:
        run("kernel_device_times", lambda: phase_kernel_device_times(torch, shared))
    run("flash_attention", lambda: phase_flash_attention(torch, np, card, shared))
    run("flash_attention_bwd", lambda: phase_flash_attention_bwd(torch, np, card, shared))
    run("ssm_scan", lambda: phase_ssm_scan(torch, card, shared))
    run("ssm_scan_bwd", lambda: phase_ssm_scan_bwd(torch, card, shared))
    run("main_path", lambda: phase_main_path(
        torch, card, shared, dim=4096, samples=8192, agents=16, K=10, rounds=10))
    if "state" in shared:
        run("profile", lambda: phase_profile(torch, shared))
        compressed = run("compressed_main_path", lambda: phase_compressed_main_path(
            torch, card, shared, rounds=10))
        if compressed is not None:
            shared["compressed"] = compressed
            run("compressed_profile", lambda: phase_compressed_profile(torch, shared))
        stochastic = run("stochastic_main_path", lambda: phase_stochastic_main_path(
            torch, card, shared, rounds=10))
        if stochastic is not None:
            shared["stochastic"] = stochastic
        elastic = run("elastic_main_path", lambda: phase_elastic_main_path(
            torch, np, card, shared, rounds=10))
        if elastic is not None:
            shared["elastic"] = elastic
        sparse = run("sparse_main_path", lambda: phase_sparse_main_path(
            torch, np, card, shared, rounds=10))
        if sparse is not None:
            shared["sparse"] = sparse
        asynced = run("async_main_path", lambda: phase_async_main_path(
            torch, np, card, shared, rounds=10))
        if asynced is not None:
            shared["async"] = asynced
        multihost = run("multihost_main_path", lambda: phase_multihost_main_path(
            torch, np, card, shared, rounds=10))
        if multihost is not None:
            shared["multihost"] = multihost
        telemetry = run("telemetry_main_path", lambda: phase_telemetry_main_path(
            torch, np, card, shared, rounds=10))
        if telemetry is not None:
            shared["telemetry"] = telemetry
        for key in ("problem", "data", "round", "compressed_round"):  # G: 2.1 GB
            shared.pop(key, None)
    run("robust_main_path", lambda: phase_robust_main_path(
        torch, card, dim=4096, samples=4096, agents=16, alpha=5.0, K=10, rounds=10))
    torch.cuda.empty_cache()
    served = run("serve", lambda: phase_serve(torch, card, shared))
    if served is not None:
        run("serve_profile", lambda: phase_serve_profile(torch, shared))
        run("spmd_serve", lambda: phase_spmd_serve(torch, card, shared))
        del shared["serve"]  # the parameters (26 GB)
        torch.cuda.empty_cache()
    # one model at a time: each phase frees its parameters on return
    run("serve_vlm", lambda: phase_serve_vlm(torch, card, shared))
    torch.cuda.empty_cache()
    run("serve_moe", lambda: phase_serve_moe(torch, card, shared))
    torch.cuda.empty_cache()
    run("encode_audio", lambda: phase_encode_audio(torch, card, shared))
    torch.cuda.empty_cache()
    trained = run("train_main_path", lambda: phase_train_main_path(torch, np, card, shared))
    torch.cuda.empty_cache()
    run("spmd_train", lambda: phase_spmd_train(torch, card))
    run("dryrun", lambda: phase_dryrun(card))
    if ("state" in shared and "compressed" in shared and served is not None
            and trained is not None and len(shared.get("timing", {})) == 8):
        kernels = run("kernels", lambda: kernel_entries(
            torch, shared["launches"], shared["state"], card, shared))
        if kernels is not None:
            emit({"kernels": kernels})
    return finish(ok, t_start, card)


def finish(ok: bool, t_start: float, card: str) -> int:
    """The total's line; if every phase passed, the card's line and the
    result line last."""
    import torch

    emit({"phase": "total", "ok": ok, "s": time.perf_counter() - t_start})
    if not ok:
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
