"""Committed data shared with the JAX package.

`paper_quadratic.npz` holds the Theorem 1 problem (d=20, n=100, m=8) and
the Sec 5.1 problem (d=50, n=500, m=20) exactly as the JAX builders draw
them from PRNGKey(0) (`thm1_G`, `thm1_Ab`, `sec51_G`, `sec51_Ab`), and the
JAX FedGDA-GT per-round gap trajectories on them (`thm1_gap`: K=10,
eta=2e-4, 4000 rounds; `sec51_gap`: K=20, eta=1e-4, 1500 rounds; each
with the final gap appended).

`compressed_rounds.npz` holds JAX's per-round gaps of the
communication-efficient rounds (CompressedGT / QuantizedGT, `RUNS` below)
on two problems, both from x0 = y0 = 0 with an explicit strategy state:
the Theorem 1 problem above (K=10, eta=2e-4, `THM1_ROUNDS` rounds, keys
`thm1_<run>_gap`) and the d=6, m=8 quadratic of the JAX package's
convergence tests (`quad6_G`, `quad6_Ab`; K=4, eta=2e-4, `QUAD6_ROUNDS`
rounds, keys `quad6_<run>_gap`), each with the final gap appended.

`tests/test_torch_fixtures.py` rebuilds both files from the JAX package;
run that file as a script to rewrite them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

PAPER_QUADRATIC = Path(__file__).resolve().parent / "paper_quadratic.npz"
COMPRESSED_ROUNDS = Path(__file__).resolve().parent / "compressed_rounds.npz"

#: run name -> (`resolve_strategy` name, kwargs); the same names and
#: kwargs build the strategy in the JAX package and in the port
RUNS = {
    "cgt_topk_ef": ("compressed_gt", dict(compression_ratio=0.5,
                                          compression_mode="topk")),
    "cgt_topk_noef": ("compressed_gt", dict(compression_ratio=0.5,
                                            compression_mode="topk",
                                            error_feedback=False)),
    "cgt_randk": ("compressed_gt", dict(compression_ratio=0.5,
                                        compression_mode="randk", seed=0)),
    "qgt8": ("quantized_gt", dict(quantization_bits=8, seed=0)),
    "qgt4_topk_wire": ("quantized_gt", dict(quantization_bits=4,
                                            compression_ratio=0.25,
                                            compression_mode="topk", seed=0,
                                            wire_transport=True)),
    "qgt4_topk_noef": ("quantized_gt", dict(quantization_bits=4,
                                            compression_ratio=0.25,
                                            compression_mode="topk", seed=0,
                                            error_feedback=False)),
    "qgt4_half_topk": ("quantized_gt", dict(quantization_bits=4,
                                            compression_ratio=0.5,
                                            compression_mode="topk", seed=0)),
    "qgt4_half_randk": ("quantized_gt", dict(quantization_bits=4,
                                             compression_ratio=0.5,
                                             compression_mode="randk", seed=0)),
}
#: the runs of each problem
THM1_RUNS = ("cgt_topk_ef", "cgt_topk_noef", "cgt_randk", "qgt8",
             "qgt4_topk_wire")
QUAD6_RUNS = tuple(RUNS)
THM1_ROUNDS = 500
QUAD6_ROUNDS = 1500
#: (dim, num_samples, num_agents, K, eta) of the d=6 quadratic
QUAD6 = (6, 40, 8, 4, 2e-4)


def load_paper_quadratic() -> Dict[str, np.ndarray]:
    with np.load(PAPER_QUADRATIC) as f:
        return {k: f[k] for k in f.files}


def load_compressed_rounds() -> Dict[str, np.ndarray]:
    with np.load(COMPRESSED_ROUNDS) as f:
        return {k: f[k] for k in f.files}


def fixture_problem(which: str, device=None):
    """(problem, x*, y*) of fixture problem `which` ("thm1" | "sec51" |
    "quad6"), the JAX-drawn data as the port's `MinimaxProblem` on
    `device` (default CUDA)."""
    from ..convert import problem_from_numpy
    from ..problems import quadratic_minimax_point

    fix = load_compressed_rounds() if which == "quad6" else load_paper_quadratic()
    prob = problem_from_numpy(
        "quadratic", {"G": fix[f"{which}_G"], "Ab": fix[f"{which}_Ab"]}, device
    )
    xs, ys = quadratic_minimax_point(prob)
    return prob, xs, ys


def compressed_run_gaps(run: str, which: str, device=None,
                        rounds: Optional[int] = None,
                        use_kernel: bool = True) -> np.ndarray:
    """The port's per-round gaps of fixture run `run` on problem `which`,
    the counterpart of the stored `<which>_<run>_gap` (x0 = y0 = 0, the
    strategy's own initial state; `rounds` defaults to the stored count).
    `use_kernel=False` runs the plain versions of the kernels."""
    import torch

    from ..core import make_round, run_strategy_rounds, tree_sq_dist
    from ..fed import resolve_strategy

    prob, xs, ys = fixture_problem(which, device)
    if which == "thm1":
        K, eta, default_rounds = 10, 2e-4, THM1_ROUNDS
    else:
        K, eta, default_rounds = QUAD6[3], QUAD6[4], QUAD6_ROUNDS
    name, kw = RUNS[run]
    strategy = resolve_strategy(name, use_kernel=use_kernel, **kw)
    x0 = torch.zeros(xs.shape[0], dtype=torch.float64, device=xs.device)
    rnd = make_round(prob.loss, strategy, K, eta, explicit_state=True)

    def gap(x, y):
        return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

    _, met = run_strategy_rounds(
        rnd, x0, x0, prob.agent_data, default_rounds if rounds is None else rounds,
        strategy.init_state(x0, x0, prob.num_agents), gap,
    )
    return met["gap"].cpu().numpy()
