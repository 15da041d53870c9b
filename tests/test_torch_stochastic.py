"""The stochastic family in the port (`fed/noise.py`, SAGDA, Local SGDA+,
the noisy branches of `core/engine.py`) against the JAX package.

The cases of tests/test_stochastic_parity.py that need no async runtime,
re-pinned inside torch: SAGDA(noise=None) is GradientTracking and
LocalSGDAPlus(0, None) is LocalOnly, bit for bit; the state layouts of
the noise-fold tree; participation (tests/test_torch_sampling.py) and
quantization draws unchanged when noise is toggled; a seed replays its run
bit for bit; the noise key advances every round.  Then the keys of the
fold tree bit for bit against JAX's, and per-round parity with JAX's
rounds: SAGDA sigma 0.1, Local SGDA+ (momentum 0.9, sigma 0.05),
MinibatchNoise(0.5) on Fig 2's robust regression and noisy rand-k
CompressedGT, each from a problem JAX drew, carried over as numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro.core import engine as jengine
from repro.core import make_round as jmake_round
from repro.fed import noise as jnoise
from repro.problems import make_quadratic_problem, make_robust_regression_problem
from repro_torch import core, fed, prng
from repro_torch.convert import problem_from_numpy, strategy_state_from_numpy
from repro_torch.core import engine
from repro_torch.fed import noise as tnoise
from repro_torch.fixtures import fixture_problem, load_robust_agnostic

from test_torch_parity import one_torch_thread  # noqa: F401

# the small draws and rounds are bound by per-op host overhead; intra-op
# threads only contend with the other test workers
pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

ETA = 1e-4
ROUNDS = 6
#: noisy iterates against JAX's per round, relative (max-norm): the
#: normals differ by a few ulp (tests/test_torch_prng.py) and the matvecs
#: sum in another order (measured: below 1e-15 over 20 rounds)
NOISY_RTOL = 1e-12
#: where the unit ball binds (robust regression), the reference's f32 norm
#: bounds agreement (tests/test_torch_robust_regression.py)
BALL_RTOL = 5e-7


@pytest.fixture(scope="module")
def probs():
    jp = make_quadratic_problem(jax.random.PRNGKey(0), dim=10, num_samples=40,
                                num_agents=6)
    tp = problem_from_numpy("quadratic", jax.tree.map(np.asarray, jp.agent_data),
                            "cpu")
    return jp, tp


def _ones(d=10):
    return torch.ones(d, dtype=torch.float64), -torch.ones(d, dtype=torch.float64)


def _trace(rnd, data, rounds=ROUNDS, state=None):
    x, y = _ones()
    out = []
    for _ in range(rounds):
        if state is None:
            x, y = rnd(x, y, data)
        else:
            x, y, state = rnd(x, y, data, state)
        out.append((x, y))
    return out, state


def _assert_bitwise(a, b):
    for t, ((xa, ya), (xb, yb)) in enumerate(zip(a, b)):
        assert torch.equal(xa, xb) and torch.equal(ya, yb), f"round {t}"


class TestZeroNoiseDegeneration:
    @pytest.mark.parametrize("K", [1, 2, 5])
    def test_sagda_bitwise_equals_gradient_tracking(self, probs, K):
        _, tp = probs
        _assert_bitwise(
            _trace(core.make_round(tp.loss, fed.SAGDA(), K, ETA), tp.agent_data)[0],
            _trace(core.make_round(tp.loss, fed.GradientTracking(), K, ETA),
                   tp.agent_data)[0])

    @pytest.mark.parametrize("K", [1, 2, 5])
    def test_local_sgda_plus_zero_momentum_bitwise_equals_local_only(self, probs, K):
        _, tp = probs
        _assert_bitwise(
            _trace(core.make_round(tp.loss, fed.LocalSGDAPlus(), K, ETA, 2 * ETA),
                   tp.agent_data)[0],
            _trace(core.make_round(tp.loss, fed.LocalOnly(), K, ETA, 2 * ETA),
                   tp.agent_data)[0])

    def test_zero_noise_strategies_are_stateless(self):
        assert not fed.SAGDA().stateful
        assert not fed.LocalSGDAPlus().stateful
        assert not fed.LocalSGDAPlus(momentum=0.9).stateful
        assert fed.SAGDA(noise=fed.GaussianNoise(sigma=0.1)).stateful
        assert fed.LocalSGDAPlus(noise=fed.MinibatchNoise(fraction=0.5)).stateful
        assert fed.SAGDA().exact_correction
        assert not fed.SAGDA(noise=fed.GaussianNoise()).exact_correction


class TestNoiseFoldContract:
    def test_streams_do_not_alias(self):
        assert tnoise.NOISE_STREAM == jnoise.NOISE_STREAM
        for seed in (0, 1, 2 ** 33):
            k = tnoise.noise_key(seed)
            assert np.array_equal(np.asarray(jnoise.noise_key(seed)).astype(np.int64),
                                  k.numpy())
            assert not torch.equal(k, prng.PRNGKey(seed))

    def test_state_layouts_pin_the_fold_tree(self):
        x = torch.ones(4)
        noise = fed.GaussianNoise(sigma=0.1)
        assert set(fed.SAGDA(noise=noise).init_state(x, x, 3)) == {"noise_key"}
        st = fed.PartialParticipation(participation=0.5, seed=0,
                                      noise=noise).init_state(x, x, 3)
        assert set(st) == {"key", "noise_key"}
        assert not torch.equal(st["key"], st["noise_key"])
        cg = fed.CompressedGT(compression_ratio=0.5, noise=noise, seed=0)
        assert set(cg.init_state(x, x, 3)) == {"ex", "ey", "noise_key"}
        qg = fed.QuantizedGT(bits=4, noise=noise, seed=0)
        st = qg.init_state(x, x, 3)
        assert set(st) == {"ex", "ey", "key", "noise_key"}
        assert not torch.equal(st["key"], st["noise_key"])
        assert set(fed.LocalSGDAPlus(momentum=0.9, noise=noise).init_state(x, x, 3)) \
            == {"noise_key"}

    def test_quantization_draws_unchanged_by_noise_toggle(self):
        m, d = 4, 12
        g = torch.Generator().manual_seed(5)
        cx = torch.randn(m, d, generator=g, dtype=torch.float64)
        cy = torch.randn(m, d, generator=g, dtype=torch.float64)
        for wire in (False, True):
            det = fed.QuantizedGT(bits=4, seed=1, wire_transport=wire)
            sto = fed.QuantizedGT(bits=4, seed=1, wire_transport=wire,
                                  noise=fed.GaussianNoise(sigma=0.1))
            s_det, s_sto = det.init_state(cx[0], cy[0], m), sto.init_state(cx[0], cy[0], m)
            qx_d, qy_d, s_det = det.transform_correction(cx, cy, s_det)
            qx_s, qy_s, s_sto = sto.transform_correction(cx, cy, s_sto)
            for a, b in ((qx_d, qx_s), (qy_d, qy_s)):
                if hasattr(a, "decode"):
                    a, b = a.decode(), b.decode()
                assert torch.equal(a, b)
            assert torch.equal(s_det["key"], s_sto["key"])

    def test_noise_key_advances_every_round(self, probs):
        _, tp = probs
        strat = fed.SAGDA(noise=fed.GaussianNoise(sigma=0.1), noise_seed=0)
        rnd = core.make_round(tp.loss, strat, 2, ETA, explicit_state=True)
        x, y = _ones()
        state = strat.init_state(x, y, tp.num_agents)
        k0 = state["noise_key"].clone()
        _, state = _trace(rnd, tp.agent_data, 1, state)
        assert not torch.equal(k0, state["noise_key"])

    def test_resolve_noise_gating(self):
        assert tnoise.resolve_noise(None) is None
        assert tnoise.resolve_noise("none") is None
        assert isinstance(tnoise.resolve_noise("gaussian"), fed.GaussianNoise)
        assert isinstance(tnoise.resolve_noise("minibatch"), fed.MinibatchNoise)
        assert tnoise.resolve_noise(None, sigma=0.2) == fed.GaussianNoise(0.2)
        assert tnoise.resolve_noise(None, fraction=0.3) == fed.MinibatchNoise(0.3)
        n = fed.GaussianNoise(sigma=0.3)
        assert tnoise.resolve_noise(n) is n
        with pytest.raises(ValueError):
            tnoise.resolve_noise("laplace")

    def test_keys_of_the_fold_tree_bitwise(self):
        """sample_noise_keys (split, fold_in of each agent's index) and the
        eval folds, round after round, against JAX's; the round's [E, m]
        grid at once equals each eval's fold."""
        m = 7
        js = jfed.SAGDA(noise=jnoise.GaussianNoise(0.1), noise_seed=4)
        ts = fed.SAGDA(noise=fed.GaussianNoise(0.1), noise_seed=4)
        jst = js.init_state(jnp.zeros(2), jnp.zeros(2), m)
        tst = ts.init_state(torch.zeros(2), torch.zeros(2), m)
        for _ in range(3):
            jk, jst = js.sample_noise_keys(jst, m)
            tk, tst = ts.sample_noise_keys(tst, m)
            assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
            grid = engine.round_eval_keys(tk, 5)
            for e in range(5):
                want = np.asarray(jengine.noise_eval_keys(jk, e)).astype(np.int64)
                assert np.array_equal(want, engine.noise_eval_keys(tk, e).numpy())
                assert np.array_equal(want, grid[e].numpy())
        # the sparse layout folds global ids into the same round subkeys
        ids = np.array([0, 3, 999_999])
        jk, jst = js.sample_noise_keys_ids(jst, ids)
        tk, tst = ts.sample_noise_keys_ids(tst, ids)
        assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())

    def test_noise_models_against_jax_per_agent(self, probs):
        """A model's draw for m agents, against JAX's one-agent `grad`
        vmapped: Gaussian noise on a pytree of several leaves (x and y
        from disjoint folds) within the normals' ulp, minibatch indices
        bit for bit (so the gradients agree to the oracle's round-off)."""
        jp, tp = probs
        jgfn = jax.vmap(lambda k, x, y, d: jnoise.GaussianNoise(0.3).grad(
            _jgrad_tree, k, x, y, d), in_axes=(0, 0, 0, 0))
        keys = prng.fold_in(prng.split(prng.PRNGKey(2))[1], np.arange(6))
        rng = np.random.default_rng(0)
        xt = {"b": rng.standard_normal((6, 3)), "a": rng.standard_normal((6, 4, 2))}
        yt = rng.standard_normal((6, 5))
        jx, jy = jax.tree.map(jnp.asarray, xt), jnp.asarray(yt)
        want = jgfn(jnp.asarray(keys.numpy().astype(np.uint32)), jx, jy, jp.agent_data)
        tx = {k: torch.tensor(v) for k, v in xt.items()}
        nvgrad = engine.make_noise_vgrad(_tgrad_tree, fed.GaussianNoise(0.3))
        got = nvgrad(keys, tx, torch.tensor(yt), tp.agent_data)
        for w, g in zip(jax.tree.leaves((want.gx, want.gy)),
                        core.types.tree_flatten((got.gx, got.gy))[0]):
            np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-13, atol=1e-14)
        # the batched draws of a round equal per-eval draws
        grid = engine.round_eval_keys(keys, 3)
        draws = fed.GaussianNoise(0.3).draws(grid, tx, torch.tensor(yt), None)
        one = fed.GaussianNoise(0.3).draws(grid[2][None], tx, torch.tensor(yt), None)[0]
        assert all(torch.equal(draws[2][k], one[k]) for k in one)

    def test_minibatch_indices_bitwise(self):
        jr = make_robust_regression_problem(jax.random.PRNGKey(1), dim=5,
                                            num_samples=30, num_agents=4, alpha=2.0)
        keys = prng.fold_in(prng.PRNGKey(8), np.arange(4))
        jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
        want = jax.vmap(lambda k: jax.random.randint(k, (15,), 0, 30))(jkeys)
        got = fed.MinibatchNoise(0.5).draws(keys[None], None, None,
                                            {"a": torch.zeros(4, 30, 5)})[0]
        assert np.array_equal(np.asarray(want), got.numpy())
        del jr


def _jgrad_tree(x, y, data):
    """A one-agent gradient field shaped like (x, y), for the noise test."""
    from repro.core.types import SaddleField

    return SaddleField(gx=jax.tree.map(lambda u: 2.0 * u, x), gy=-y)


def _tgrad_tree(xs, ys, data):
    from repro_torch.core.types import SaddleField, tree_map

    return SaddleField(gx=tree_map(lambda u: 2.0 * u, xs), gy=-ys)


class TestStochasticDeterminism:
    def _trace(self, tp, strat, rounds=3, K=2):
        rnd = core.make_round(tp.loss, strat, K, ETA, explicit_state=True)
        x, y = _ones()
        return _trace(rnd, tp.agent_data, rounds,
                      strat.init_state(x, y, tp.num_agents))[0]

    def test_same_seed_is_bitwise_reproducible(self, probs):
        _, tp = probs
        strat = fed.SAGDA(noise=fed.GaussianNoise(sigma=0.1), noise_seed=7)
        _assert_bitwise(self._trace(tp, strat), self._trace(tp, strat))

    def test_noise_seed_changes_the_draws(self, probs):
        _, tp = probs
        a = self._trace(tp, fed.SAGDA(noise=fed.GaussianNoise(0.1), noise_seed=0))
        b = self._trace(tp, fed.SAGDA(noise=fed.GaussianNoise(0.1), noise_seed=1))
        assert not torch.equal(a[0][0], b[0][0])

    def test_noisy_round_differs_from_deterministic_and_stays_finite(self, probs):
        _, tp = probs
        det = self._trace(tp, fed.SAGDA())
        sto = self._trace(tp, fed.SAGDA(noise=fed.GaussianNoise(sigma=0.1)))
        assert not torch.equal(det[-1][0], sto[-1][0])
        assert torch.isfinite(sto[-1][0]).all() and torch.isfinite(sto[-1][1]).all()

    def test_momentum_changes_the_trace_without_noise(self, probs):
        _, tp = probs
        lsp = core.make_round(tp.loss, fed.LocalSGDAPlus(momentum=0.9), 4, ETA, 2 * ETA)
        lo = core.make_round(tp.loss, fed.LocalOnly(), 4, ETA, 2 * ETA)
        a, b = _trace(lsp, tp.agent_data, 2)[0], _trace(lo, tp.agent_data, 2)[0]
        assert not torch.equal(a[-1][0], b[-1][0])
        assert torch.isfinite(a[-1][0]).all()

    @pytest.mark.parametrize("noise", [fed.GaussianNoise(0.1), fed.MinibatchNoise(0.5)],
                             ids=["gaussian", "minibatch"])
    def test_draws_ahead_equal_round_by_round_draws(self, probs, noise, monkeypatch):
        """A broadcast that draws the rounds after its own in one pass gives
        the iterates of drawing round by round, and so does a round whose
        caller passes its noise keys; the byte budget bounds the pass."""
        tp = probs[1]
        if isinstance(noise, fed.MinibatchNoise):
            tp = fixture_problem("robust5", "cpu")[0]
        strat = fed.SAGDA(noise=noise, noise_seed=3)
        lead = tp.agent_data["Ab" if "Ab" in tp.agent_data else "a"]
        x = y = lead.new_ones(lead.shape[-1])
        m = tp.num_agents
        xs = core.tree_broadcast_agents(x, m)
        per_round = 4 * noise.draw_bytes(xs, xs, tp.agent_data)
        assert engine.rounds_ahead(noise, 4, xs, xs, tp.agent_data) == min(
            engine.DRAW_AHEAD_ROUNDS, engine.DRAW_AHEAD_BYTES // per_round)
        monkeypatch.setattr(engine, "DRAW_AHEAD_BYTES", 5 * per_round)
        assert engine.rounds_ahead(noise, 4, xs, xs, tp.agent_data) == 5

        def run(phases, keyed):
            st, xt, yt, out = strat.init_state(x, y, m), x, y, []
            for _ in range(7):  # crosses a pass of 5 rounds
                kw = {}
                if keyed:
                    kw["noise_keys"], st = strat.sample_noise_keys(st, m)
                rs = phases.broadcast(xt, yt, tp.agent_data, st, **kw)
                rs = phases.local_steps(phases.exchange_corrections(
                    rs, tp.agent_data), tp.agent_data)
                xt, yt, st = phases.aggregate(rs)
                out.append((xt, yt))
            return out

        ahead = run(core.make_phases(tp.loss, strat, 3, ETA), False)
        keyed = run(core.make_phases(tp.loss, strat, 3, ETA), True)
        monkeypatch.setattr(engine, "DRAW_AHEAD_ROUNDS", 1)
        _assert_bitwise(ahead, run(core.make_phases(tp.loss, strat, 3, ETA), False))
        _assert_bitwise(ahead, keyed)

    def test_noisy_round_takes_no_fused_step_and_kernel_path_equals_plain(self, probs):
        """Under noise every local step is a corrected update (the anchor
        step is off), and the kernel-backed update gives the plain update's
        iterates bit for bit."""
        _, tp = probs
        strat = fed.SAGDA(noise=fed.GaussianNoise(sigma=0.1))
        calls = []

        def counting(z, g, c, eta, sign):
            calls.append(sign)
            return core.default_update(z, g, c, eta, sign)

        ph = core.make_phases(tp.loss, strat, 3, ETA)
        x, y = _ones()
        st = strat.init_state(x, y, tp.num_agents)
        rs = ph.exchange_corrections(ph.broadcast(x, y, tp.agent_data, st),
                                     tp.agent_data)
        assert not rs.fused and len(rs.noise_draws) == 4
        core.make_round(tp.loss, strat, 3, ETA, explicit_state=True,
                        update_fn=counting)(x, y, tp.agent_data, st)
        assert len(calls) == 2 * 3
        a = _trace(core.make_round(tp.loss, strat, 3, ETA, explicit_state=True),
                   tp.agent_data, 3, st)[0]
        b = _trace(core.make_round(tp.loss, strat, 3, ETA, explicit_state=True,
                                   update_fn=core.default_update),
                   tp.agent_data, 3, st)[0]
        _assert_bitwise(a, b)


def _run_both(jprob, tprob, js, ts, K, eta, rounds, dim, rtol, proj=False):
    """Per-round iterates of JAX's and the port's rounds from x0 = 1,
    y0 = -1 (0, 0 with a projection) and the same initial state."""
    kw = {"proj_y": jprob.proj_y} if proj else {}
    tkw = {"proj_y": tprob.proj_y} if proj else {}
    jr = jax.jit(jmake_round(jprob.loss, js, K, eta, explicit_state=True, **kw))
    tr = core.make_round(tprob.loss, ts, K, eta, explicit_state=True, **tkw)
    s = 0.0 if proj else 1.0
    x, y = s * jnp.ones(dim), -s * jnp.ones(dim)
    tx, ty = s * torch.ones(dim, dtype=torch.float64), -s * torch.ones(dim, dtype=torch.float64)
    jst = js.init_state(x, y, jprob.num_agents)
    tst = strategy_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    worst = 0.0
    for t in range(rounds):
        x, y, jst = jr(x, y, jprob.agent_data, jst)
        tx, ty, tst = tr(tx, ty, tprob.agent_data, tst)
        for w, g in ((x, tx), (y, ty)):
            w = np.asarray(w)
            err = float(np.max(np.abs(w - g.numpy())) / max(np.max(np.abs(w)), 1e-300))
            worst = max(worst, err)
            assert err <= rtol, f"round {t}: {err:.3e}"
        assert np.array_equal(np.asarray(jst["noise_key"]).astype(np.int64),
                              tst["noise_key"].numpy())
    return worst


class TestAgainstJax:
    def test_sagda_gaussian_per_round(self, probs):
        jp, tp = probs
        _run_both(jp, tp, jfed.SAGDA(noise=jnoise.GaussianNoise(0.1), noise_seed=3),
                  fed.SAGDA(noise=fed.GaussianNoise(0.1), noise_seed=3),
                  4, 1e-3, 20, 10, NOISY_RTOL)

    def test_local_sgda_plus_momentum_noise_per_round(self, probs):
        jp, tp = probs
        _run_both(jp, tp, jfed.LocalSGDAPlus(momentum=0.9, noise=jnoise.GaussianNoise(0.05)),
                  fed.LocalSGDAPlus(momentum=0.9, noise=fed.GaussianNoise(0.05)),
                  4, 1e-3, 20, 10, NOISY_RTOL)

    def test_minibatch_noise_on_fig2_robust_regression(self):
        """Fig 2's alpha-5 problem (JAX's data, its stepsize, K=10, the unit
        ball) with SAGDA under MinibatchNoise(0.5): the indices are JAX's bit
        for bit; the iterates meet the ball's f32-norm floor."""
        tp = fixture_problem("robust5", "cpu")[0]
        fix = load_robust_agnostic()
        jp = make_robust_regression_problem(jax.random.PRNGKey(0), dim=20,
                                            num_samples=100, num_agents=10, alpha=5.0)
        assert np.array_equal(np.asarray(jp.agent_data["a"]), fix["robust5_a"])
        _run_both(jp, tp, jfed.SAGDA(noise=jnoise.MinibatchNoise(0.5)),
                  fed.SAGDA(noise=fed.MinibatchNoise(0.5)), 10,
                  float(fix["robust5_eta"]), 30, 20, BALL_RTOL, proj=True)

    @pytest.mark.parametrize("wire", [False, True])
    def test_noisy_compressed_randk_per_round(self, probs, wire):
        jp, tp = probs
        kw = dict(compression_ratio=0.5, mode="randk", seed=2)
        _run_both(jp, tp, jfed.CompressedGT(**kw, noise=jnoise.GaussianNoise(0.1),
                                            wire_transport=wire),
                  fed.CompressedGT(**kw, noise=fed.GaussianNoise(0.1),
                                   wire_transport=wire),
                  4, 1e-3, 20, 10, NOISY_RTOL)

    def test_noisy_quantized_wire_equals_dense(self, probs):
        """Noisy QuantizedGT over the packed wire and densely give the same
        iterates bit for bit (the same draws feed both)."""
        _, tp = probs
        q = fed.QuantizedGT(bits=8, ratio=0.25, noise=fed.GaussianNoise(0.1))
        a = _trace(core.make_round(tp.loss, q, 3, ETA, explicit_state=True),
                   tp.agent_data, 4, q.init_state(*_ones(), 6))[0]
        w = dataclasses.replace(q, wire_transport=True)
        b = _trace(core.make_round(tp.loss, w, 3, ETA, explicit_state=True),
                   tp.agent_data, 4, w.init_state(*_ones(), 6))[0]
        _assert_bitwise(a, b)


def test_resolve_stochastic_names():
    for name, cls in [("sagda", fed.SAGDA), ("local_sgda_plus", fed.LocalSGDAPlus),
                      ("fedgda_gt", fed.GradientTracking),
                      ("compressed_gt", fed.CompressedGT),
                      ("quantized_gt", fed.QuantizedGT),
                      ("partial_gt", fed.PartialParticipation)]:
        s = fed.resolve_strategy(name, noise_sigma=0.2, noise_seed=5)
        assert type(s) is cls and s.noise == fed.GaussianNoise(0.2)
        assert s.noise_seed == 5
        assert fed.resolve_strategy(name) == fed.resolve_strategy(name, noise="none")
    assert fed.resolve_strategy("local_sgda_plus", momentum=0.9).momentum == 0.9
    assert fed.resolve_strategy("gda", noise_sigma=0.1) == fed.FullSync()
    assert fed.resolve_strategy("sagda", noise="minibatch").noise == fed.MinibatchNoise(0.5)
