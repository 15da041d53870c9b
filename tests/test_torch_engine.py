"""The port's round engine against the JAX package's, and the reference's
own pins re-pinned inside torch.

  * Per round against JAX (`repro.core.make_round`) on the same numpy
    data in f64: GradientTracking, LocalOnly and FullSync at K in
    {1, 2, 10} for 50 rounds, GT with bf16 / fp8 corrections, and m = 1.
    Tolerance rtol 1e-10: the two frameworks order the sums of `mean` and
    of the matvecs differently, so iterates differ by f64 round-off.
  * Bitwise inside torch: hand-composed phases == `make_round`
    (tests/test_phases.py), engine == `make_fedgda_gt_round_reference`
    (tests/test_engine_parity.py), the kernel-backed default update ==
    `default_update`, `vmap_grad_xy` == `vmap(grad_xy)`.
  * The package rules: no jax / repro import, no silent CPU, and
    NotImplementedError naming the ROADMAP item for what is not ported.
"""
import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import repro.core as jcore
import repro.core.projections as jproj
import repro.fed as jfed
from repro.problems import make_quadratic_problem as jax_quadratic
from repro_torch import core, resolve_device
from repro_torch.convert import problem_from_numpy, tree_from_numpy
from repro_torch.core import engine
from repro_torch.fed import (
    FullSync,
    GradientTracking,
    LocalOnly,
    resolve_strategy,
)
from repro_torch.problems import make_appendix_c_problem, make_quadratic_problem

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small problems are bound by per-op host overhead; extra
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = pathlib.Path(__file__).resolve().parents[1]
ETA = 1e-4
RTOL = 1e-10

STRATEGIES = {
    "gradient_tracking": (GradientTracking(), jfed.GradientTracking()),
    "local_only": (LocalOnly(), jfed.LocalOnly()),
    "full_sync": (FullSync(), jfed.FullSync()),
}


def _problems(m=8, dim=20, num_samples=40):
    """The same data on both sides: drawn by the JAX builder, handed to
    the port as numpy."""
    jp = jax_quadratic(
        jax.random.PRNGKey(0), dim=dim, num_samples=num_samples, num_agents=m
    )
    data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
    return jp, problem_from_numpy("quadratic", data, device="cpu")


@pytest.fixture(scope="module")
def probs():
    return _problems()


def _start(dim=20):
    x = np.ones(dim)
    y = -np.ones(dim)
    return (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x), torch.from_numpy(y))


def _assert_close(t, j, what):
    j = np.asarray(j)
    np.testing.assert_allclose(
        t.numpy(), j, rtol=RTOL, atol=RTOL * np.max(np.abs(j)), err_msg=what
    )


def _per_round_against_jax(jround, tround, jdata, tdata, rounds, dim=20):
    (jx, jy), (tx, ty) = _start(dim)
    jround = jax.jit(jround)
    for t in range(rounds):
        jx, jy = jround(jx, jy, jdata)
        tx, ty = tround(tx, ty, tdata)
        _assert_close(tx, jx, f"x, round {t}")
        _assert_close(ty, jy, f"y, round {t}")


class TestAgainstJax:
    @pytest.mark.parametrize("K", [1, 2, 10])
    @pytest.mark.parametrize("name", sorted(STRATEGIES))
    def test_round_by_round(self, probs, name, K):
        jp, tp = probs
        ts, js = STRATEGIES[name]
        _per_round_against_jax(
            jcore.make_round(jp.loss, js, K, ETA),
            core.make_round(tp.loss, ts, K, ETA),
            jp.agent_data, tp.agent_data, 50,
        )

    @pytest.mark.parametrize("cdt", ["bf16", "fp8"])
    def test_gt_with_reduced_correction_dtype(self, probs, cdt):
        """On data scaled by 2^-8 (eta by 2^8: the same iterates in exact
        arithmetic, and every correction inside fp8 e4m3's +-448 range)."""
        jp, tp = probs
        jdt = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}[cdt]
        tdt = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}[cdt]
        scale = 2.0 ** -8
        jdata = {k: v * scale for k, v in jp.agent_data.items()}
        tdata = {k: v * scale for k, v in tp.agent_data.items()}
        _per_round_against_jax(
            jcore.make_fedgda_gt_round(jp.loss, 4, ETA / scale, correction_dtype=jdt),
            core.make_fedgda_gt_round(tp.loss, 4, ETA / scale, correction_dtype=tdt),
            jdata, tdata, 50,
        )

    def test_fp8_correction_overflow_gives_nan_as_in_jax(self, probs):
        """A correction beyond fp8 e4m3's range (|c| > 464) casts to NaN in
        JAX, and so in the port on every device (some torch CPU builds
        saturate to +-448; ROADMAP Queue 3): on the unscaled data both
        rounds are NaN from round 0."""
        jp, tp = probs
        v = np.array([-600.0, -464.1, -464.0, 448.0, 460.0, 464.0, 464.01, 600.0])
        z = np.zeros_like(v)
        jc, _ = jcore.tracking_corrections(
            jnp.asarray(v)[None], jnp.asarray(z)[None], jnp.asarray(z),
            jnp.asarray(z), jnp.float8_e4m3fn,
        )
        tc, _ = engine.tracking_corrections(
            torch.from_numpy(v)[None], torch.from_numpy(z)[None],
            torch.from_numpy(z), torch.from_numpy(z), torch.float8_e4m3fn,
        )
        want = np.asarray(jc).astype(np.float64)
        got = tc.double().numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isnan(want).sum() == 4
        (jx, jy), (tx, ty) = _start()
        jx1, _ = jax.jit(jcore.make_fedgda_gt_round(
            jp.loss, 4, ETA, correction_dtype=jnp.float8_e4m3fn))(jx, jy, jp.agent_data)
        tx1, _ = core.make_fedgda_gt_round(
            tp.loss, 4, ETA, correction_dtype=torch.float8_e4m3fn)(tx, ty, tp.agent_data)
        assert np.all(np.isnan(np.asarray(jx1)))
        assert bool(torch.isnan(tx1).all())

    def test_single_agent(self):
        jp, tp = _problems(m=1, dim=8, num_samples=30)
        _per_round_against_jax(
            jcore.make_fedgda_gt_round(jp.loss, 3, ETA),
            core.make_fedgda_gt_round(tp.loss, 3, ETA),
            jp.agent_data, tp.agent_data, 50, dim=8,
        )

    def test_global_loss_and_minimax_point(self, probs):
        jp, tp = probs
        from repro.problems import quadratic_minimax_point as jmp
        from repro_torch.problems import quadratic_minimax_point as tmp

        (jx, jy), (tx, ty) = _start()
        np.testing.assert_allclose(
            float(tp.global_loss(tx, ty)), float(jp.global_loss(jx, jy)),
            rtol=1e-12,
        )
        for t, j in zip(tmp(tp), jmp(jp)):
            _assert_close(t, j, "minimax point")


def _iterate(rnd, x, y, data, rounds=5):
    out = []
    for _ in range(rounds):
        x, y = rnd(x, y, data)
        out.append((x, y))
    return out


def _assert_bitwise(a, b):
    for t, ((xa, ya), (xb, yb)) in enumerate(zip(a, b)):
        assert torch.equal(xa, xb), f"x diverges at round {t}"
        assert torch.equal(ya, yb), f"y diverges at round {t}"


class TestBitwisePins:
    @pytest.mark.parametrize("name", sorted(STRATEGIES))
    def test_composed_phases_equal_make_round(self, probs, name):
        _, tp = probs
        strategy = STRATEGIES[name][0]
        ph = core.make_phases(tp.loss, strategy, 4, ETA)

        def composed(x, y, data):
            rs = ph.broadcast(x, y, data, {})
            rs = ph.exchange_corrections(rs, data)
            rs = ph.local_steps(rs, data)
            return ph.aggregate(rs)[:2]

        _, (x, y) = _start()
        _assert_bitwise(
            _iterate(core.make_round(tp.loss, strategy, 4, ETA), x, y, tp.agent_data),
            _iterate(composed, x, y, tp.agent_data),
        )

    @pytest.mark.parametrize("K", [1, 2, 5])
    @pytest.mark.parametrize("update", ["kernel", "default"])
    def test_engine_equals_frozen_reference(self, probs, K, update):
        """With the kernel-backed default update_fn or with the plain
        default_update, the engine reproduces the reference's iterates
        bit for bit (the reference applies default_update)."""
        _, tp = probs
        kw = {} if update == "kernel" else {"update_fn": core.default_update}
        _, (x, y) = _start()
        _assert_bitwise(
            _iterate(core.make_round(tp.loss, GradientTracking(), K, ETA, **kw),
                     x, y, tp.agent_data),
            _iterate(core.make_fedgda_gt_round_reference(tp.loss, K, ETA),
                     x, y, tp.agent_data),
        )

    def test_engine_equals_reference_with_bf16_correction(self, probs):
        _, tp = probs
        _, (x, y) = _start()
        _assert_bitwise(
            _iterate(core.make_fedgda_gt_round(
                tp.loss, 4, ETA, correction_dtype=torch.bfloat16),
                x, y, tp.agent_data),
            _iterate(core.make_fedgda_gt_round_reference(
                tp.loss, 4, ETA, correction_dtype=torch.bfloat16),
                x, y, tp.agent_data),
        )

    @pytest.mark.parametrize("K", [1, 3])
    def test_m1_reduces_to_k_gda_steps(self, K):
        """Single agent: the correction is zero, the unfused update runs
        on broadcast iterates (contiguous copies), and one round IS K
        centralized GDA steps."""
        _, tp = _problems(m=1, dim=8, num_samples=30)
        x, y = torch.ones(8, dtype=torch.float64), -torch.ones(8, dtype=torch.float64)
        eng = core.make_round(tp.loss, GradientTracking(), K, ETA)
        _assert_bitwise(
            _iterate(eng, x, y, tp.agent_data),
            _iterate(core.make_fedgda_gt_round_reference(tp.loss, K, ETA),
                     x, y, tp.agent_data),
        )
        xe, ye = eng(x, y, tp.agent_data)
        step = core.make_gda_step_reference(tp.loss, ETA, ETA)
        xc, yc = x, y
        for _ in range(K):
            xc, yc = step(xc, yc, tp.agent_data)
        torch.testing.assert_close(xe, xc, rtol=1e-12, atol=0)
        torch.testing.assert_close(ye, yc, rtol=1e-12, atol=0)

    @pytest.mark.parametrize("K", [1, 2, 5])
    def test_local_only_equals_reference(self, probs, K):
        _, tp = probs
        _, (x, y) = _start()
        _assert_bitwise(
            _iterate(core.make_local_sgda_round(tp.loss, K, ETA, 2 * ETA),
                     x, y, tp.agent_data),
            _iterate(core.make_local_sgda_round_reference(tp.loss, K, ETA, 2 * ETA),
                     x, y, tp.agent_data),
        )

    @pytest.mark.parametrize("K", [1, 4])
    def test_full_sync_round_equals_k_gda_steps(self, probs, K):
        _, tp = probs
        _, (x, y) = _start()
        rnd = core.make_round(tp.loss, FullSync(), K, ETA, 2 * ETA)
        step_pub = core.make_gda_step(tp.loss, ETA, 2 * ETA)
        step_ref = core.make_gda_step_reference(tp.loss, ETA, 2 * ETA)
        for _ in range(3):
            x1, y1 = rnd(x, y, tp.agent_data)
            xp, yp, xr, yr = x, y, x, y
            for _ in range(K):
                xp, yp = step_pub(xp, yp, tp.agent_data)
                xr, yr = step_ref(xr, yr, tp.agent_data)
            _assert_bitwise([(x1, y1), (x1, y1)], [(xp, yp), (xr, yr)])
            x, y = x1, y1

    def test_vmap_grad_xy_equals_vmap_of_grad(self, probs):
        _, tp = probs
        rng = np.random.default_rng(0)
        xs = torch.from_numpy(rng.standard_normal((8, 20)))
        ys = torch.from_numpy(rng.standard_normal((8, 20)))
        a = core.types.vmap_grad_xy(tp.loss)(xs, ys, tp.agent_data)
        b = vmap(core.grad_xy(tp.loss))(xs, ys, tp.agent_data)
        assert torch.equal(a.gx, b.gx) and torch.equal(a.gy, b.gy)
        toy = make_appendix_c_problem(device="cpu")
        z = torch.tensor([0.3, -1.7], dtype=torch.float64)
        a = core.types.vmap_grad_xy(toy.loss)(z, -z, toy.agent_data)
        b = vmap(core.grad_xy(toy.loss))(z, -z, toy.agent_data)
        assert torch.equal(a.gx, b.gx) and torch.equal(a.gy, b.gy)

    def test_run_strategy_rounds_equals_run_rounds(self, probs):
        _, tp = probs
        _, (x, y) = _start()

        def metric(x, y):
            return {"n": torch.sum(x * x + y * y)}

        rnd = core.make_round(tp.loss, GradientTracking(), 3, ETA, explicit_state=True)
        (xa, ya, _), ma = core.run_strategy_rounds(rnd, x, y, tp.agent_data, 4, metric_fn=metric)
        plain = core.make_fedgda_gt_round(tp.loss, 3, ETA)
        (xb, yb), mb = core.run_rounds(plain, x, y, tp.agent_data, 4, metric)
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
        assert ma["n"].shape == (5,) and torch.equal(ma["n"], mb["n"])


class TestStrategies:
    @pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
    @pytest.mark.parametrize("K", [1, 10])
    def test_bytes_per_round_equal_the_reference(self, dtype, K):
        shapes = {"w": (7, 3), "b": (5,)}
        tx = {k: torch.zeros(s, dtype=getattr(torch, dtype)) for k, s in shapes.items()}
        jx = {k: jnp.zeros(s, dtype=getattr(jnp, dtype)) for k, s in shapes.items()}
        for name in ("gda", "local_sgda", "fedgda_gt"):
            assert core.communication_bytes_per_round(tx, tx, name, K) == \
                jcore.communication_bytes_per_round(jx, jx, name, K)

    def test_resolve_ported_names(self):
        for name, cls in [("gda", FullSync), ("sync_gda", FullSync),
                          ("full_sync", FullSync), ("local_sgda", LocalOnly),
                          ("local_only", LocalOnly), ("fedgda_gt", GradientTracking),
                          ("gradient_tracking", GradientTracking)]:
            assert type(resolve_strategy(name)) is cls
        s = resolve_strategy("fedgda_gt", correction_dtype=torch.float8_e4m3fn)
        assert s.correction_dtype == torch.float8_e4m3fn
        assert resolve_strategy(s) is s

    @pytest.mark.parametrize("name", ["partial_gt", "compressed_gt", "quantized_gt",
                                      "sagda", "local_sgda_plus"])
    def test_unported_names_raise_not_implemented(self, name):
        # every name resolves, noisy too, and draws the sparse layout's
        # noise keys as JAX's strategy does, bit for bit
        s = resolve_strategy(name, noise="gaussian")
        js = jfed.resolve_strategy(name, noise="gaussian")
        st = s.init_state(torch.zeros(3), torch.zeros(3), 4)
        jst = js.init_state(jnp.zeros(3), jnp.zeros(3), 4)
        keys, st = s.sample_noise_keys_ids(st, [0, 2])
        jkeys, jst = js.sample_noise_keys_ids(jst, np.array([0, 2]))
        assert np.array_equal(np.asarray(jkeys).astype(np.int64), keys.numpy())
        assert np.array_equal(np.asarray(jst["noise_key"]).astype(np.int64),
                              st["noise_key"].numpy())

    def test_unknown_name_and_noise(self):
        with pytest.raises(ValueError, match="unknown algorithm"):
            resolve_strategy("nope")
        with pytest.raises(ValueError, match="unknown noise model"):
            resolve_strategy("fedgda_gt", noise="laplace")
        s = resolve_strategy("fedgda_gt", noise="gaussian")
        assert type(s) is GradientTracking and s.noise is not None


class TestProjections:
    def test_against_jax(self):
        rng = np.random.default_rng(0)
        tree = {"a": rng.standard_normal(6) * 3, "b": rng.standard_normal((2, 3))}
        jt = {k: jnp.asarray(v) for k, v in tree.items()}
        tt = tree_from_numpy(tree, "cpu")
        for tproj, jp in [(core.l2_ball_proj(1.5), jproj.l2_ball_proj(1.5)),
                          (core.box_proj(-0.5, 0.7), jproj.box_proj(-0.5, 0.7))]:
            got, want = tproj(tt), jp(jt)
            for k in tree:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12)
        v = rng.standard_normal(9)
        got = core.simplex_proj()({"v": torch.from_numpy(v)})["v"]
        want = jproj.simplex_proj()({"v": jnp.asarray(v)})["v"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)
        assert abs(float(got.sum()) - 1.0) < 1e-12


class TestPackageRules:
    def test_import_loads_no_jax_and_no_repro(self):
        code = (
            "import sys, repro_torch, repro_torch.core, repro_torch.fed, "
            "repro_torch.kernels, repro_torch.problems, repro_torch.convert, "
            "repro_torch.fixtures, repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.core.generalization, repro_torch.fed.runtime, "
            "repro_torch.benchmarks.fig1_quadratic, "
            "repro_torch.benchmarks.fig2_robust_regression, "
            "repro_torch.benchmarks.fig3_fixed_point, repro_torch.data, "
            "repro_torch.fed.noise, repro_torch.fed.comm, repro_torch.optim.momentum, "
            "repro_torch.benchmarks.comm_efficiency, "
            "repro_torch.benchmarks.generalization\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
        )
        subprocess.run(
            [sys.executable, "-c", code], check=True, cwd=REPO,
            env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
            timeout=120,
        )

    def test_chip_smoke_imports_neither(self):
        tree = ast.parse((REPO / "chip_smoke.py").read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").split(".")[0])
        assert not names & {"jax", "jaxlib", "repro"}, names
        assert "repro_torch" in names

    def test_no_silent_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_quadratic_problem(torch.Generator().manual_seed(0), dim=4,
                                   num_samples=8, num_agents=2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_appendix_c_problem()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tree_from_numpy({"a": np.zeros(3)})
        assert resolve_device("cpu") == torch.device("cpu")

    def test_unported_engine_features_raise(self, probs):
        _, tp = probs
        # constrain_agents is ported (launch.shardings): on plain tensors
        # an identity hook leaves the round bit for bit, and it runs where
        # JAX's engine runs it (broadcast, the fused anchor step, each of
        # the K - 1 corrected steps after it)
        calls = []

        def hook(xs, ys):
            calls.append(1)
            return xs, ys

        x0 = torch.ones(20, dtype=torch.float64)
        K = 3
        with_hook = core.make_round(tp.loss, GradientTracking(), K, ETA,
                                    constrain_agents=hook)(x0, -x0, tp.agent_data)
        plain = core.make_round(tp.loss, GradientTracking(), K, ETA)(x0, -x0,
                                                                      tp.agent_data)
        assert all(torch.equal(a, b) for a, b in zip(with_hook, plain))
        assert len(calls) == 1 + 1 + (K - 1)
        ph = core.make_phases(tp.loss, GradientTracking(), 2, ETA)
        x = torch.zeros(20, dtype=torch.float64)
        # elastic budgets and masks are ported (sim): broadcast carries them
        rs = ph.broadcast(x, x, tp.agent_data, {}, step_budgets=torch.ones(8),
                          active=torch.ones(8, dtype=torch.bool))
        assert rs.step_budgets is not None and rs.active is not None
        # the pod tree and the sparse broadcast are ported (sim.sparse):
        # two pods' partial sums add up to the flat weighted sum, and the
        # broadcast carries the rows' global ids
        u = torch.arange(24.0, dtype=torch.float64).reshape(8, 3)
        w = torch.full((8,), 0.125, dtype=torch.float64)
        parts = engine.pod_weighted_sums(u, w, np.arange(8) // 4, 2)
        assert torch.equal(parts, torch.stack([w[:4] @ u[:4], w[4:] @ u[4:]]))
        assert torch.equal(engine.pods_total(parts), parts[0] + parts[1])
        ids = np.array([3, 5, 9, 11, 20, 21, 30, 40])
        rs = ph.broadcast(x, x, tp.agent_data, {}, active_indices=ids)
        assert rs.active_indices is ids and rs.noise_keys is None
