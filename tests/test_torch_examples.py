"""The port's examples (`repro_torch.examples`) on the CPU at reduced
rounds, on the JAX examples' own data: each example's problem constructor
is replaced by `convert.problem_from_numpy` of the JAX builder's
`PRNGKey(0)` draw at the arguments the JAX example passes (the replacement
checks them).  Each example runs once; two tests read its result:

  * `test_<example>_signals`: the signals its counterpart in `examples/`
    prints.  quickstart: FedGDA-GT's gap falls geometrically (on the sync
    engine, on the async runtime, and under the flaky population with
    tracker rebasing), while Local SGDA's settles at its Proposition 1
    bias and never below it (the bias is the gap of the Local SGDA round
    map's fixed point, found by solving the affine map; `prop1_residual`
    vanishes there).  agnostic_federated: the agnostic model's worst-agent
    risk and risk spread are below the uniform model's, lambda on the
    simplex.  robust_regression: at every alpha FedGDA-GT lands far closer
    to the centralized projected-GDA solution than Local SGDA.
  * `test_<example>_equals_the_reference`: every series, risk, distance
    and loss the example returns equals the JAX example's computation at
    the same rounds on the same data (its strategies, step sizes, printed
    rounds and centralized reference, written out here with `repro`'s public
    API; robust regression's `stable_eta` and constants are taken from
    `examples/robust_regression.py` itself) within the reference's rtol
    1e-9 / atol 1e-12 (tests/test_async_runtime.py).  The seeded draws
    (client sampling, the quantizer, the flaky schedule) are JAX's bit for
    bit, so the stochastic runs compare at the same tolerance.  Robust
    regression's iterates go through the reference's `l2_ball_proj`, whose
    norm is summed in f32: they are held as in
    tests/test_torch_robust_regression.py (each iterate to BALL_RTOL, so a
    distance between two iterates to BALL_RTOL times their norms; the
    robust losses to LOSS_RTOL).
"""
import contextlib
import functools
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import fed as jfed
from repro import problems as jproblems
from repro import sim as jsim
from repro_torch.convert import problem_from_numpy
from repro_torch.core import make_local_sgda_round, prop1_residual
from repro_torch.examples import agnostic_federated, quickstart, robust_regression
from repro_torch.problems import quadratic_minimax_point, robust_loss

from test_torch_parity import one_torch_thread  # noqa: F401
from test_torch_robust_regression import BALL_RTOL, LOSS_RTOL

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

CPU = ["--device", "cpu"]
#: the reference's tolerance (tests/test_async_runtime.py)
RTOL, ATOL = 1e-9, 1e-12
QUICKSTART_ROUNDS, AGNOSTIC_ROUNDS, ROBUST_ROUNDS = 60, 300, 40
#: robust regression's loss evaluations at reduced depth (the example's
#: default is robust_loss's own, 2000 ascent steps)
ASCENT_STEPS = 200


def _jax_example(name):
    """A module of the top-level `examples/` (the JAX examples), loaded
    from its file."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _on_jax_data(kind, jax_builder, expected):
    """A stand-in for the port's problem constructor that checks the
    example's arguments against `expected` (the JAX example's) and returns
    the port's problem on JAX's `PRNGKey(0)` draw; each call appends
    (JAX's problem, the port's) to `build.made`."""
    def build(gen, **kw):
        device = kw.pop("device")
        assert kw == expected, (kw, expected)
        jp = jax_builder(jax.random.PRNGKey(0), **kw)
        data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
        prob = problem_from_numpy(kind, data, device)
        build.made.append((jp, prob))
        return prob
    build.made = []
    return build


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _run(module, argv, **patches):
    """Run the example's main with `patches` set on its module; returns
    (its result, its printout, the problems it built)."""
    text = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, _one_thread(), \
            contextlib.redirect_stdout(text):
        for name, value in patches.items():
            mp.setattr(module, name, value)
        out = module.main(CPU + argv)
    made = next(v.made for v in patches.values() if hasattr(v, "made"))
    return out, text.getvalue(), made


def _close(port, ref, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# --------------------------------------------------------------- quickstart

@pytest.fixture(scope="module")
def quickstart_run():
    build = _on_jax_data("quadratic", jproblems.make_quadratic_problem,
                         {"dim": 50, "num_samples": 500, "num_agents": 20})
    return _run(quickstart, ["--rounds", str(QUICKSTART_ROUNDS)],
                make_quadratic_problem=build)


def _jax_quickstart(jp, T):
    """The JAX quickstart's computation at T rounds: every strategy's gap
    series, then the flaky population's two runs."""
    x_star, y_star = jproblems.quadratic_minimax_point(jp)

    def gap(x, y):
        return {"gap": jcore.tree_sq_dist(x, x_star) + jcore.tree_sq_dist(y, y_star)}

    K, eta = 20, 1e-4
    runs = {
        "gda": (jfed.FullSync(), 1),
        "local_sgda": (jfed.LocalOnly(), K),
        "fedgda_gt": (jfed.GradientTracking(), K),
        "partial_gt": (jfed.PartialParticipation(participation=0.5, seed=0), K),
        "compressed_gt": (jfed.CompressedGT(compression_ratio=0.1, mode="topk",
                                            wire_transport=True), K),
        "quantized_gt": (jfed.QuantizedGT(bits=8, seed=0, wire_transport=True), K),
    }
    x0 = jnp.zeros(50)
    m = jp.num_agents
    out = {}
    for key, (strategy, k) in runs.items():
        rnd = jcore.make_round(jp.loss, strategy, k, eta, explicit_state=True)
        _, mtr = jcore.run_strategy_rounds(jax.jit(rnd), x0, x0, jp.agent_data, T,
                                           strategy.init_state(x0, x0, m), gap)
        out[key] = np.asarray(mtr["gap"])
    schedule = jsim.make_population("flaky", m).schedule(0, T, K)
    for key, strategy in (("flaky_fedgda_gt", jfed.GradientTracking()),
                          ("flaky_local_sgda", jfed.LocalOnly())):
        er = jfed.FederatedRunner.from_strategy(jp.loss, strategy, jp.agent_data, K,
                                                eta, metric_fn=gap)
        er.run(x0, x0, T, schedule=schedule)
        out[key] = np.asarray(er.metric_series("gap"))
    return out


def _local_sgda_bias(prob, K=20, eta=1e-4):
    """The squared distance of Local SGDA's fixed point from the minimax
    point on the quickstart's problem: the round map z -> A z + b is
    affine on the quadratic game, so the fixed point solves (I - A) z = b."""
    d = prob.agent_data["Ab"].shape[-1]
    xs, ys = quadratic_minimax_point(prob)
    rnd = make_local_sgda_round(prob.loss, K, eta, eta)

    def R(z):
        x, y = rnd(z[:d], z[d:], prob.agent_data)
        return torch.cat([x, y])

    eye = torch.eye(2 * d, dtype=torch.float64)
    b = R(torch.zeros(2 * d, dtype=torch.float64))
    A = torch.stack([R(e) - b for e in eye], dim=1)
    z = torch.linalg.solve(eye - A, b)
    res = [float(prop1_residual(prob.loss, p[:d], p[d:], prob.agent_data, K, eta,
                                eta)) for p in (z, torch.zeros_like(z))]
    return float(((z - torch.cat([xs, ys])) ** 2).sum()), res


def _geometric(g, start, every=10, factor=0.1):
    for t in range(start, len(g) - every, every):
        assert g[t + every] < factor * g[t], (t, float(g[t]), float(g[t + every]))


def test_quickstart_signals(quickstart_run):
    T = QUICKSTART_ROUNDS
    out, text, made = quickstart_run
    assert "FedGDA-GT   K=20  (this paper)" in text and "flaky population" in text
    gt = out["fedgda_gt"]
    assert len(gt) == T + 1
    _geometric(gt, 10)
    assert gt[-1] < 1e-10 * gt[0]
    # the async runtime: the same gaps to fp tolerance (its series starts
    # after round 1)
    np.testing.assert_allclose(out["async_fedgda_gt"].numpy(), gt[1:].numpy(),
                               rtol=1e-6)
    # Local SGDA settles at its Proposition 1 bias, from above
    bias, (residual, residual_at_0) = _local_sgda_bias(made[0][1])
    assert residual < 1e-9 * residual_at_0
    ls = out["local_sgda"]
    assert bias > 1.0 and float(ls.min()) >= bias and ls[-1] <= 1.01 * bias
    assert gt[-1] < 1e-8 * bias
    # under churn: GT with rebasing keeps converging, Local SGDA stalls
    flaky = out["flaky_fedgda_gt"]
    _geometric(flaky, 10)
    assert flaky[-1] < 1e-10 * flaky[0]
    assert out["flaky_local_sgda"][-1] > 1.0
    for key in ("gda", "partial_gt", "compressed_gt", "quantized_gt"):
        assert bool(torch.isfinite(out[key]).all()) and out[key][-1] < out[key][0]


def test_quickstart_equals_the_reference(quickstart_run):
    out, _, made = quickstart_run
    # the JAX example prints rounds 0, 100, 500, 1000 and T - 1 of 2000
    assert quickstart.marks(2000) == [0, 100, 500, 1000, 1999]
    ref = _jax_quickstart(made[0][0], QUICKSTART_ROUNDS)
    for key, series in ref.items():
        assert len(out[key]) == len(series), key
        _close(out[key], series, key)
    # the async finale against the JAX sync engine's GT (its series starts
    # after round 1)
    _close(out["async_fedgda_gt"], ref["fedgda_gt"][1:], "async_fedgda_gt")


# ------------------------------------------------------- agnostic_federated

@pytest.fixture(scope="module")
def agnostic_run():
    build = _on_jax_data("agnostic", jproblems.make_agnostic_problem,
                         {"dim": agnostic_federated.DIM, "num_samples": 80,
                          "num_agents": agnostic_federated.M, "shift": 4.0})
    return _run(agnostic_federated, ["--rounds", str(AGNOSTIC_ROUNDS)],
                make_agnostic_problem=build)


def test_agnostic_federated_signals(agnostic_run):
    out, text, _ = agnostic_run
    assert "worst-agent risk" in text
    ru, ra, lam = out["uniform_risks"], out["agnostic_risks"], out["lambda"]
    assert float(ra.max()) < float(ru.max())
    assert float(ra.max() - ra.min()) < float(ru.max() - ru.min())
    assert float(lam.min()) >= 0.0 and abs(float(lam.sum()) - 1.0) < 1e-9


def test_agnostic_federated_equals_the_reference(agnostic_run):
    """The JAX example's computation (its M, DIM, K = 5, eta = 2e-3, the
    frozen uniform lambda) at the same rounds."""
    out, _, made = agnostic_run
    jp = made[0][0]
    ref = _jax_example("agnostic_federated")
    assert (ref.M, ref.DIM) == (agnostic_federated.M, agnostic_federated.DIM)
    uniform = jproblems.uniform_lambda(ref.M)
    rnd = jax.jit(jcore.make_fedgda_gt_round(jp.loss, 5, 2e-3, proj_y=jp.proj_y))
    frozen = jax.jit(jcore.make_fedgda_gt_round(jp.loss, 5, 2e-3,
                                                proj_y=lambda y: uniform))
    xa = xu = jnp.zeros(ref.DIM)
    ya = yu = uniform
    for _ in range(AGNOSTIC_ROUNDS):
        xa, ya = rnd(xa, ya, jp.agent_data)
        xu, yu = frozen(xu, yu, jp.agent_data)
    _close(out["agnostic_risks"], jproblems.per_agent_risks(jp, xa), "agnostic risks")
    _close(out["uniform_risks"], jproblems.per_agent_risks(jp, xu), "uniform risks")
    _close(out["lambda"], ya, "lambda")


# -------------------------------------------------------- robust_regression

@pytest.fixture(scope="module")
def robust_run():
    ref = _jax_example("robust_regression")
    expected = {"dim": ref.DIM, "num_samples": ref.N, "num_agents": ref.M}
    made = []

    def build(gen, *, alpha, **kw):
        b = _on_jax_data("robust_regression", functools.partial(
            jproblems.make_robust_regression_problem, alpha=alpha), expected)
        prob = b(gen, **kw)
        made.append((alpha,) + b.made[0])
        return prob
    build.made = made
    return _run(robust_regression, ["--rounds", str(ROBUST_ROUNDS)],
                make_robust_regression_problem=build,
                robust_loss=functools.partial(robust_loss,
                                              num_ascent_steps=ASCENT_STEPS))


def test_robust_regression_signals(robust_run):
    out, text, _ = robust_run
    assert "dist to centralized solution" in text
    assert sorted(out) == [1.0, 5.0, 20.0]
    for alpha, r in out.items():
        assert r["dist_gt"] < 0.2 * r["dist_ls"], (alpha, r)
        assert np.isfinite(r["robust_loss_gt"]) and np.isfinite(r["robust_loss_ls"])


def test_robust_regression_equals_the_reference(robust_run):
    """The JAX example's computation (its DIM, N, M, K, alphas and
    `stable_eta`, the centralized GDA over T x K steps) at the same
    rounds, the robust losses at the same ascent steps."""
    out, _, made = robust_run
    ref = _jax_example("robust_regression")
    assert (robust_regression.DIM, robust_regression.N, robust_regression.M,
            robust_regression.K) == (ref.DIM, ref.N, ref.M, ref.K)
    assert [alpha for alpha, _, _ in made] == [1.0, 5.0, 20.0]
    T, K = ROBUST_ROUNDS, ref.K
    for alpha, jp, prob in made:
        eta = ref.stable_eta(jp)
        _close(robust_regression.stable_eta(prob), eta, f"eta alpha={alpha}")
        r_gt = jax.jit(jcore.make_fedgda_gt_round(jp.loss, K, eta, proj_y=jp.proj_y))
        r_ls = jax.jit(jcore.make_local_sgda_round(jp.loss, K, eta, eta,
                                                   proj_y=jp.proj_y))
        r_c = jax.jit(jcore.make_local_sgda_round(jp.loss, 1, eta, eta,
                                                  proj_y=jp.proj_y))
        z = jnp.zeros(ref.DIM)
        xg, yg, xl, yl, xc, yc = z, z, z, z, z, z
        for _ in range(T):
            xg, yg = r_gt(xg, yg, jp.agent_data)
            xl, yl = r_ls(xl, yl, jp.agent_data)
        for _ in range(T * K):
            xc, yc = r_c(xc, yc, jp.agent_data)
        r = out[alpha]
        norm = jnp.linalg.norm
        for key, x in (("dist_gt", xg), ("dist_ls", xl)):
            _close(r[key], norm(x - xc), f"{key} alpha={alpha}", rtol=0,
                   atol=BALL_RTOL * float(norm(x) + norm(xc)))
        for key, x in (("robust_loss_gt", xg), ("robust_loss_ls", xl)):
            _close(r[key], jproblems.robust_loss(jp, x, num_ascent_steps=ASCENT_STEPS),
                   f"{key} alpha={alpha}", rtol=LOSS_RTOL)
