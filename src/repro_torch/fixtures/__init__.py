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

`robust_agnostic.npz` holds, for each alpha of `ROBUST_ALPHAS`, the Sec
5.2 robust-regression problem exactly as the JAX builder draws it from
PRNGKey(0) at Fig 2's size (`ROBUST`: d=20, n=100, m=10; keys
`robust<alpha>_a`, `_b`), JAX's stepsize 0.1 / L (`_eta`) and, for each
run of `ROBUST_RUNS` (FedGDA-GT and Local SGDA with K=10 for T=800
rounds, centralized projected GDA for T*K rounds, all from x0 = y0 = 0),
x at every `ROBUST_EVERY`-th round from round 0 to the end (`_<run>_x`)
and the robust loss of the last x (`_<run>_robust_loss`).  It also holds
the Appendix A.2 agnostic problem of `examples/agnostic_federated.py`
(`AGNOSTIC`; `agnostic_a`, `agnostic_b`) and JAX's final x, lambda and
per-agent risks of FedGDA-GT from x0 = 0, lambda0 uniform, with the
simplex projection (`agnostic_*`) and with lambda frozen at uniform
(`uniform_*`).

`stochastic_rounds.npz` holds the stochastic and client-sampling rounds:
  * the Section 4 separation of tests/test_paper_claims.py
    (`TestStochasticSeparation`; `SEC4`: d=10, n=40, m=6, K=10, eta=5e-4,
    T=1500, x0 = y0 = 0) on the quadratic the JAX builder draws from
    PRNGKey(0) (`sec4_G`, `sec4_Ab`), with JAX's gap trajectories of the
    four runs of `SEC4_RUNS` (`sec4_<run>_gap`: noiseless SAGDA, Local
    SGDA, SAGDA at sigma 0.1 and 0.01, each with the final gap appended);
  * PartialParticipation(0.5, seed 0) on the Theorem 1 problem
    (`PARTIAL`: K=10, eta=2e-4, 500 rounds from x0 = y0 = 0): JAX's
    per-round participation masks (`partial_mask`, [500, 8] bool) and gaps
    (`partial_gap`);
  * the noisy runs of `NOISY_RUNS`: SAGDA with MinibatchNoise(0.5) on Fig
    2's alpha-5 robust regression (the `robust5` data of
    `robust_agnostic.npz`, its stepsize, the unit ball; x every
    `ROBUST_EVERY`-th round, `noisy_<run>_x`) and rand-k CompressedGT with
    Gaussian noise on the Theorem 1 problem (gaps, `noisy_<run>_gap`);
  * the two Dirichlet quadratics of `benchmarks/generalization.py`'s
    stochastic table (`DIRICHLET`: d=12, n=60, m=6, four components, a
    held-out split of 60, from PRNGKey(7), alpha 0.1 and 100), train and
    test sufficient statistics and mixture weights (`dirichlet<alpha>_G`,
    `_Ab`, `_test_G`, `_test_Ab`, `_weights`) and JAX's rows of that table
    (`dirichlet<alpha>_rows`: per strategy x noise of `GEN_ROWS`, rounds to
    eps (inf if never), final distance and generalization gap).

`elastic_rounds.npz` holds the elastic population of
`benchmarks/elastic.py` (`ELASTIC`: m=10, d=30, 200 samples from
PRNGKey(0), K=10, eta=1e-4, T=1200, seed 0): the quadratic's data (`G`,
`Ab`), each scenario's schedule (`<scenario>_active` [T, m] bool,
`<scenario>_budgets` [T, m] int32, `ELASTIC_SCENARIOS`), JAX's per-round
gaps of the five flaky rows (`flaky_<row>_gap`, the runner's metric after
each of the T rounds; rows `ELASTIC_ROWS`) and JAX's whole table
(`table` [rows, 5] f64 in the columns of `ELASTIC_TABLE_COLS`, inf where
eps is never reached; `table_keys` "scenario/row").

`tests/test_torch_fixtures.py` rebuilds the five files from the JAX
package; run that file as a script to rewrite them.

`sparse_rounds.npz` holds the O(active) engine's runs
(`tests/test_sparse_elastic.py`'s sizes, `SPARSE`: the quadratic d=16, 40
samples, m=8 from PRNGKey(0) (`G`, `Ab`), 4 active a round, uniform
stragglers (0.5, 0.4), K=5 (K=1 for FullSync), eta=1e-4, T=6, seed 0,
x0 = y0 = 0): the schedule's ids (`m8_ids` [T, 4]) and budgets
(`m8_budgets_k1`, `m8_budgets_k5`), JAX's final x and y of each family of
`SPARSE_FAMILIES` forced sparse (`sparse_<family>_x` / `_y`) and through
the dense fallback (`dense_<family>_x` / `_y`), and of FedGDA-GT over 4
pods with `wire_pods` (`pods_x` / `_y`, per round `pods_live_pods` and
`pods_pod_wire_bytes`).  It also holds the mega preset's engine run of
`benchmarks/elastic.py` (`MEGA`: m = 1e6, 256 active, 1024 pods, dim 8,
8 samples synthesized per id from PRNGKey(7), K=10, eta=1e-4, T=4, seed
0) and of its 1e4 reference registry (prefixes `mega_` and `ref_`): each
round's ids and budgets, live pods, pod wire bytes and tracker touched
count, and the final x and y.  `tests/test_torch_sparse_fixture.py`
rebuilds it (run as a script to rewrite it).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

PAPER_QUADRATIC = Path(__file__).resolve().parent / "paper_quadratic.npz"
COMPRESSED_ROUNDS = Path(__file__).resolve().parent / "compressed_rounds.npz"
ROBUST_AGNOSTIC = Path(__file__).resolve().parent / "robust_agnostic.npz"
STOCHASTIC_ROUNDS = Path(__file__).resolve().parent / "stochastic_rounds.npz"
ELASTIC_ROUNDS = Path(__file__).resolve().parent / "elastic_rounds.npz"
SPARSE_ROUNDS = Path(__file__).resolve().parent / "sparse_rounds.npz"

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


#: (dim, num_samples, num_agents, K, rounds) of Fig 2
#: (`benchmarks/fig2_robust_regression.py`)
ROBUST = (20, 100, 10, 10, 800)
ROBUST_ALPHAS = (1.0, 5.0, 20.0)
#: FedGDA-GT, Local SGDA, centralized projected GDA (K=1, rounds * K)
ROBUST_RUNS = ("gt", "ls", "c")
ROBUST_EVERY = 10
#: (dim, num_samples, num_agents, shift, K, eta, rounds) of the agnostic run
AGNOSTIC = (8, 80, 5, 4.0, 5, 2e-3, 1500)


#: (dim, num_samples, num_agents, K, eta, rounds) of the Section 4 runs
SEC4 = (10, 40, 6, 10, 5e-4, 1500)
#: run -> (`resolve_strategy` name, kwargs), in the port and in JAX
SEC4_RUNS = {
    "gt": ("sagda", {}),
    "ls": ("local_sgda_plus", {}),
    "hi": ("sagda", {"noise_sigma": 0.1}),
    "lo": ("sagda", {"noise_sigma": 0.01}),
}
#: (K, eta, rounds) of PartialParticipation(0.5, seed 0) on "thm1"
PARTIAL = (10, 2e-4, 500)
PARTIAL_KW = {"participation": 0.5, "seed": 0}
#: run -> (problem, strategy name, kwargs, K, eta (None: the fixture's
#: stepsize), rounds)
NOISY_RUNS = {
    "robust5_minibatch": ("robust5", "sagda",
                          {"noise": "minibatch", "noise_fraction": 0.5,
                           "noise_seed": 0}, 10, None, 200),
    "thm1_cgt_randk": ("thm1", "compressed_gt",
                       {"compression_ratio": 0.5, "compression_mode": "randk",
                        "seed": 0, "noise_sigma": 0.1, "noise_seed": 1},
                       10, 2e-4, 300),
}
#: (dim, num_samples, num_agents, num_components, alphas) of the
#: generalization benchmark's stochastic table, drawn from PRNGKey(7)
DIRICHLET = (12, 60, 6, 4, (0.1, 100.0))
#: (strategy, noise) of each row of `dirichlet<alpha>_rows`, in order
GEN_ROWS = tuple((s, n) for n in ("none", "gaussian")
                 for s in ("local_sgda", "local_sgda_plus", "sagda"))


def robust_key(alpha: float) -> str:
    """Key prefix of the alpha problem: "robust1", "robust5", "robust20"."""
    return f"robust{alpha:g}"


def robust_agnostic_keys() -> list:
    """The arrays `robust_agnostic.npz` holds, sorted."""
    keys = ["agnostic_a", "agnostic_b"] + [
        f"{run}_{what}" for run in ("agnostic", "uniform")
        for what in ("x", "lambda", "risks")]
    for alpha in ROBUST_ALPHAS:
        pre = robust_key(alpha)
        keys += [f"{pre}_a", f"{pre}_b", f"{pre}_eta"] + [
            f"{pre}_{run}_{what}" for run in ROBUST_RUNS
            for what in ("x", "robust_loss")]
    return sorted(keys)


def dirichlet_key(alpha: float) -> str:
    """Key prefix of a Dirichlet problem: "dirichlet0.1", "dirichlet100"."""
    return f"dirichlet{alpha:g}"


def stochastic_rounds_keys() -> list:
    """The arrays `stochastic_rounds.npz` holds, sorted."""
    keys = ["sec4_G", "sec4_Ab", "partial_mask", "partial_gap",
            "noisy_robust5_minibatch_x", "noisy_thm1_cgt_randk_gap"]
    keys += [f"sec4_{run}_gap" for run in SEC4_RUNS]
    for alpha in DIRICHLET[4]:
        pre = dirichlet_key(alpha)
        keys += [f"{pre}_{what}" for what in
                 ("G", "Ab", "test_G", "test_Ab", "weights", "rows")]
    return sorted(keys)


def load_stochastic_rounds() -> Dict[str, np.ndarray]:
    with np.load(STOCHASTIC_ROUNDS) as f:
        return {k: f[k] for k in f.files}


def dirichlet_problem(alpha: float, device=None):
    """(problem, test_data, weights) of the Dirichlet quadratic at `alpha`
    as JAX draws it from PRNGKey(7), on `device` (default CUDA)."""
    from ..convert import problem_split_from_numpy, tensor_from_numpy

    fix = load_stochastic_rounds()
    pre = dirichlet_key(alpha)
    prob, test = problem_split_from_numpy(
        "quadratic", {"G": fix[f"{pre}_G"], "Ab": fix[f"{pre}_Ab"]},
        {"G": fix[f"{pre}_test_G"], "Ab": fix[f"{pre}_test_Ab"]}, device)
    return prob, test, tensor_from_numpy(fix[f"{pre}_weights"], device)


def load_paper_quadratic() -> Dict[str, np.ndarray]:
    with np.load(PAPER_QUADRATIC) as f:
        return {k: f[k] for k in f.files}


def load_compressed_rounds() -> Dict[str, np.ndarray]:
    with np.load(COMPRESSED_ROUNDS) as f:
        return {k: f[k] for k in f.files}


def load_robust_agnostic() -> Dict[str, np.ndarray]:
    with np.load(ROBUST_AGNOSTIC) as f:
        return {k: f[k] for k in f.files}


def fixture_problem(which: str, device=None):
    """(problem, x*, y*) of fixture problem `which`, the JAX-drawn data as
    the port's `MinimaxProblem` on `device` (default CUDA): the quadratics
    "thm1" | "sec51" | "quad6" | "sec4" with their closed-form minimax point, and
    "robust1" | "robust5" | "robust20" | "agnostic", which have none
    (x*, y* are None; the robust problems carry Proj_Y = the unit ball,
    the agnostic one the simplex)."""
    from ..convert import problem_from_numpy
    from ..problems import quadratic_minimax_point

    if which.startswith("robust") or which == "agnostic":
        fix = load_robust_agnostic()
        kind = "agnostic" if which == "agnostic" else "robust_regression"
        data = {"a": fix[f"{which}_a"], "b": fix[f"{which}_b"]}
        if kind == "agnostic":
            m = data["a"].shape[0]
            data["agent_index"] = np.arange(m, dtype=np.int32)
            data["m"] = np.full((m,), float(m))
        return problem_from_numpy(kind, data, device), None, None
    fix = {"quad6": load_compressed_rounds,
           "sec4": load_stochastic_rounds}.get(which, load_paper_quadratic)()
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


def _strategy_gaps(prob, xs, ys, strategy, K: int, eta: float, rounds: int,
                   record_x: bool = False) -> np.ndarray:
    """Per-round gaps (or, with `record_x`, x every ROBUST_EVERY-th round)
    of `strategy` on `prob` from x0 = y0 = 0 with its own initial state."""
    import torch

    from ..core import make_round, run_strategy_rounds, tree_sq_dist

    # x and y live in R^d for the quadratic (Ab) and robust regression (a)
    lead = prob.agent_data["Ab" if "Ab" in prob.agent_data else "a"]
    x0 = y0 = torch.zeros(lead.shape[-1], dtype=torch.float64, device=lead.device)
    rnd = make_round(prob.loss, strategy, K, eta, proj_y=prob.proj_y,
                     explicit_state=True)
    state = strategy.init_state(x0, y0, prob.num_agents)
    if record_x:
        x, y, out = x0, y0, [x0]
        for t in range(1, rounds + 1):
            x, y, state = rnd(x, y, prob.agent_data, state)
            if t % ROBUST_EVERY == 0:
                out.append(x)
        return torch.stack(out).cpu().numpy()

    def gap(x, y):
        return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

    _, met = run_strategy_rounds(rnd, x0, y0, prob.agent_data, rounds, state, gap)
    return met["gap"].cpu().numpy()


def sec4_run_gaps(run: str, device=None) -> np.ndarray:
    """The port's per-round gaps of Section 4 run `run` (`SEC4_RUNS`) on
    the `sec4` problem, the counterpart of `sec4_<run>_gap`."""
    from ..fed import resolve_strategy

    prob, xs, ys = fixture_problem("sec4", device)
    _, _, _, K, eta, T = SEC4
    name, kw = SEC4_RUNS[run]
    return _strategy_gaps(prob, xs, ys, resolve_strategy(name, **kw), K, eta, T)


def partial_run(device=None, rounds: Optional[int] = None):
    """(masks, gaps) of the port's PartialParticipation(0.5, seed 0) run on
    the Theorem 1 problem: the counterparts of `partial_mask` (the
    strategy's per-round draws, [rounds, m] bool) and `partial_gap`."""
    from ..fed import PartialParticipation

    prob, xs, ys = fixture_problem("thm1", device)
    K, eta, T = PARTIAL
    rounds = T if rounds is None else rounds
    strategy = PartialParticipation(**PARTIAL_KW)
    x0 = xs.new_zeros(xs.shape)
    state, masks = strategy.init_state(x0, x0, prob.num_agents), []
    for _ in range(rounds):
        w, state = strategy.sample_weights(state, prob.num_agents)
        masks.append((w > 0).numpy())
    gaps = _strategy_gaps(prob, xs, ys, strategy, K, eta, rounds)
    return np.stack(masks), gaps


def noisy_run(run: str, device=None) -> np.ndarray:
    """The port's noisy fixture run `run` (`NOISY_RUNS`): x every
    ROBUST_EVERY-th round on a robust problem, per-round gaps on a
    quadratic, the counterparts of `noisy_<run>_x` / `noisy_<run>_gap`."""
    from ..fed import resolve_strategy

    which, name, kw, K, eta, T = NOISY_RUNS[run]
    prob, xs, ys = fixture_problem(which, device)
    if eta is None:
        eta = float(load_robust_agnostic()[f"{which}_eta"])
    return _strategy_gaps(prob, xs, ys, resolve_strategy(name, **kw), K, eta, T,
                          record_x=xs is None)


#: (dim, num_samples, num_agents, K, eta, rounds, seed) of the elastic
#: benchmark (`benchmarks/elastic.py`)
ELASTIC = (30, 200, 10, 10, 1e-4, 1200, 0)
ELASTIC_EPS = 1e-6
ELASTIC_SCENARIOS = ("stable", "flaky", "diurnal", "straggler_heavy")
#: the benchmark's rows, in its order: (strategy name, kwargs, rebase), the
#: same in the JAX package and in the port
ELASTIC_ROWS = {
    "local_sgda": ("local_sgda", {}, True),
    "fedgda_gt": ("fedgda_gt", {}, True),
    "fedgda_gt_norebase": ("fedgda_gt", {}, False),
    "compressed_gt_25": ("compressed_gt", {"compression_ratio": 0.25}, True),
    "quantized_gt_8bit": ("quantized_gt", {"quantization_bits": 8}, True),
}
#: the numeric columns of the table
ELASTIC_TABLE_COLS = ("participation", "rounds_to_eps", "bytes_per_round",
                      "total_bytes_to_eps", "final_gap")


def elastic_table_keys() -> list:
    """The table's rows in the benchmark's order ("scenario/row"; the
    no-rebase ablation is skipped under the static-full stable schedule)."""
    return [f"{sc}/{row}" for sc in ELASTIC_SCENARIOS for row in ELASTIC_ROWS
            if not (sc == "stable" and not ELASTIC_ROWS[row][2])]


def elastic_rounds_keys() -> list:
    """The arrays `elastic_rounds.npz` holds, sorted."""
    keys = ["G", "Ab", "table", "table_keys"]
    keys += [f"{sc}_{what}" for sc in ELASTIC_SCENARIOS
             for what in ("active", "budgets")]
    keys += [f"flaky_{row}_gap" for row in ELASTIC_ROWS]
    return sorted(keys)


def load_elastic_rounds() -> Dict[str, np.ndarray]:
    with np.load(ELASTIC_ROUNDS) as f:
        return {k: f[k] for k in f.files}


def elastic_problem(device=None):
    """(problem, x*, y*) of the elastic benchmark's quadratic as JAX draws
    it from PRNGKey(0), on `device` (default CUDA)."""
    from ..convert import problem_from_numpy
    from ..problems import quadratic_minimax_point

    fix = load_elastic_rounds()
    prob = problem_from_numpy("quadratic", {"G": fix["G"], "Ab": fix["Ab"]}, device)
    xs, ys = quadratic_minimax_point(prob)
    return prob, xs, ys


def elastic_run_gaps(row: str, schedule, device=None,
                     rounds: Optional[int] = None, **strategy_kwargs) -> np.ndarray:
    """The port's per-round gaps of benchmark row `row` (`ELASTIC_ROWS`)
    under `schedule` through `FederatedRunner` (x0 = y0 = 0; `rounds`
    defaults to the schedule's length), the counterpart of the stored
    `flaky_<row>_gap`.  `strategy_kwargs` go to `resolve_strategy` (e.g.
    use_kernel=False)."""
    import torch

    from ..core import tree_sq_dist
    from ..fed import FederatedRunner, resolve_strategy

    prob, xs, ys = elastic_problem(device)
    dim, _, _, K, eta, _, _ = ELASTIC
    name, kw, rebase = ELASTIC_ROWS[row]

    def gap(x, y):
        return {"gap": tree_sq_dist(x, xs) + tree_sq_dist(y, ys)}

    runner = FederatedRunner.from_strategy(
        prob.loss, resolve_strategy(name, **kw, **strategy_kwargs),
        prob.agent_data, K, eta, metric_fn=gap)
    x0 = torch.zeros(dim, dtype=torch.float64, device=xs.device)
    runner.run(x0, x0, len(schedule) if rounds is None else rounds,
               schedule=schedule, rebase=rebase)
    return runner.metric_series("gap")


#: (dim, num_samples, num_agents, active, K, eta, rounds, seed) of the
#: sparse engine's m=8 runs (tests/test_sparse_elastic.py)
SPARSE = (16, 40, 8, 4, 5, 1e-4, 6, 0)
#: the six families: name -> (strategy name, kwargs, K), the same on both
#: sides
SPARSE_FAMILIES = {
    "full_sync": ("full_sync", {}, 1),
    "local_only": ("local_sgda", {}, 5),
    "gradient_tracking": ("fedgda_gt", {}, 5),
    "partial_participation": ("partial_gt", {"participation": 0.5, "seed": 0}, 5),
    "compressed_gt": ("compressed_gt", {"compression_ratio": 0.25, "seed": 0}, 5),
    "quantized_gt": ("quantized_gt", {"quantization_bits": 8, "seed": 0}, 5),
}
SPARSE_PODS = 4
#: (m, active, pods, T) of the mega preset's engine run and its reference
MEGA = {"mega": (1_000_000, 256, 1024, 4), "ref": (10_000, 256, 1024, 4)}
MEGA_COUNTS = ("live_pods", "pod_wire_bytes", "tracker_touched")


def sparse_rounds_keys() -> list:
    """The arrays `sparse_rounds.npz` holds, sorted."""
    keys = ["G", "Ab", "m8_ids", "m8_budgets_k1", "m8_budgets_k5", "pods_x",
            "pods_y", "pods_live_pods", "pods_pod_wire_bytes"]
    keys += [f"{path}_{f}_{v}" for path in ("sparse", "dense")
             for f in SPARSE_FAMILIES for v in ("x", "y")]
    keys += [f"{run}_{what}" for run in MEGA
             for what in ("ids", "budgets", "x", "y") + MEGA_COUNTS]
    return sorted(keys)


def load_sparse_rounds() -> Dict[str, np.ndarray]:
    with np.load(SPARSE_ROUNDS) as f:
        return {k: f[k] for k in f.files}


def sparse_problem(device=None):
    """The m=8 quadratic of the sparse runs as JAX draws it from
    PRNGKey(0), as the port's `MinimaxProblem` on `device` (default
    CUDA)."""
    from ..convert import problem_from_numpy

    fix = load_sparse_rounds()
    return problem_from_numpy("quadratic", {"G": fix["G"], "Ab": fix["Ab"]}, device)


def sparse_population(pods: int = 0):
    """The m=8 population of the sparse runs (4 active a round, uniform
    stragglers 0.5 / 0.4), flat or over `pods` pods."""
    from ..sim import Population, UniformActiveSubset, UniformStragglers

    _, _, m, active, _, _, _, _ = SPARSE
    return Population(m, UniformActiveSubset(size=active),
                      UniformStragglers(p_straggle=0.5, min_frac=0.4), pods=pods)
