"""Client sampling in the port (`core/engine.py` `fixed_size_mask`,
`renormalized_weights`; `fed/strategies.py` `PartialParticipation`)
against the JAX package: the masks and the per-round weights bit for bit
(`permutation` under `split` keys), participation >= 1 exactly
GradientTracking, and the partial rounds per round against JAX's.  The
reference's pins of tests/test_population.py and test_stochastic_parity.py
that need no population module are re-pinned here inside torch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro.core import engine as jengine
from repro.core import make_round as jmake_round
from repro.fed.noise import GaussianNoise as JGaussianNoise
from repro.problems import make_quadratic_problem
from repro_torch import core, fed, prng
from repro_torch.convert import problem_from_numpy
from repro_torch.core import engine
from repro_torch.fixtures import PARTIAL, load_stochastic_rounds, partial_run

from test_torch_parity import one_torch_thread  # noqa: F401

# the small draws and rounds are bound by per-op host overhead; intra-op
# threads only contend with the other test workers
pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

#: iterates against JAX's per round, relative (max-norm): the engines sum
#: the matvecs in different orders (measured below 1e-15 over 20 rounds)
ROUND_RTOL = 1e-12
ETA = 1e-3


@pytest.mark.parametrize("m,size", [(1, 1), (2, 1), (8, 4), (20, 7), (100, 50),
                                    (2000, 1000), (2000, 1)])
def test_fixed_size_mask_bitwise(m, size):
    for seed in (0, 3, 2 ** 32 + 1):
        want = np.asarray(jengine.fixed_size_mask(jax.random.PRNGKey(seed), m, size))
        got = engine.fixed_size_mask(prng.PRNGKey(seed), m, size, "cpu")
        assert got.dtype == torch.bool and np.array_equal(want, got.numpy())
        assert int(got.sum()) == size


def test_renormalized_weights_bitwise():
    rng = np.random.default_rng(0)
    for m in (3, 7, 64):
        mask = rng.random(m) < 0.4
        mask[0] = True
        for jdt, tdt in ((None, None), (jnp.float32, torch.float32)):
            want = np.asarray(jengine.renormalized_weights(jnp.asarray(mask), jdt))
            got = engine.renormalized_weights(torch.tensor(mask), tdt)
            assert want.dtype == got.numpy().dtype
            assert np.array_equal(want, got.numpy())
        floats = mask.astype(np.float64)
        assert np.array_equal(np.asarray(jengine.renormalized_weights(jnp.asarray(floats))),
                              engine.renormalized_weights(torch.tensor(floats)).numpy())


@pytest.mark.parametrize("participation,m,seed", [(0.5, 8, 0), (0.3, 10, 3),
                                                  (0.25, 2000, 1), (0.9, 5, 7)])
def test_partial_participation_weights_bitwise(participation, m, seed):
    js = jfed.PartialParticipation(participation=participation, seed=seed)
    ts = fed.PartialParticipation(participation=participation, seed=seed)
    x = jnp.zeros(3)
    jst, tst = js.init_state(x, x, m), ts.init_state(torch.zeros(3), torch.zeros(3), m)
    assert np.array_equal(np.asarray(jst["key"]).astype(np.int64), tst["key"].numpy())
    for _ in range(5):
        jw, jst = js.sample_weights(jst, m)
        tw, tst = ts.sample_weights(tst, m)
        assert np.array_equal(np.asarray(jw), tw.numpy())
        assert np.array_equal(np.asarray(jst["key"]).astype(np.int64), tst["key"].numpy())


def test_participation_draws_unchanged_by_noise_toggle():
    m = 8
    det = fed.PartialParticipation(participation=0.5, seed=3)
    sto = fed.PartialParticipation(participation=0.5, seed=3,
                                   noise=fed.GaussianNoise(sigma=0.1))
    x = torch.ones(4)
    s_det, s_sto = det.init_state(x, x, m), sto.init_state(x, x, m)
    assert set(s_sto) == {"key", "noise_key"}
    for _ in range(4):
        w_det, s_det = det.sample_weights(s_det, m)
        w_sto, s_sto = sto.sample_weights(s_sto, m)
        assert torch.equal(w_det, w_sto)


@pytest.fixture(scope="module")
def probs():
    jp = make_quadratic_problem(jax.random.PRNGKey(0), dim=10, num_samples=40,
                                num_agents=6)
    tp = problem_from_numpy("quadratic", jax.tree.map(np.asarray, jp.agent_data), "cpu")
    return jp, tp


@pytest.mark.parametrize("K", [1, 3])
def test_full_participation_is_gradient_tracking_bitwise(probs, K):
    _, tp = probs
    pp = core.make_round(tp.loss, fed.PartialParticipation(participation=1.0), K, ETA)
    gt = core.make_round(tp.loss, fed.GradientTracking(), K, ETA)
    assert not fed.PartialParticipation(participation=1.0).stateful
    x, y = torch.ones(10, dtype=torch.float64), -torch.ones(10, dtype=torch.float64)
    xa, ya, xb, yb = x, y, x, y
    for _ in range(5):
        xa, ya = pp(xa, ya, tp.agent_data)
        xb, yb = gt(xb, yb, tp.agent_data)
        assert torch.equal(xa, xb) and torch.equal(ya, yb)


def _rel(want, got):
    want = np.asarray(want)
    return float(np.max(np.abs(want - got.numpy())) / np.max(np.abs(want)))


@pytest.mark.parametrize("kw", [dict(participation=0.5, seed=0),
                                dict(participation=0.34, seed=5),
                                dict(participation=0.5, seed=2, sigma=0.1)],
                         ids=["half", "third", "half_noisy"])
def test_partial_rounds_against_jax_per_round(probs, kw):
    jp, tp = probs
    kw = dict(kw)
    sigma = kw.pop("sigma", None)
    js = jfed.PartialParticipation(
        **kw, **({"noise": JGaussianNoise(sigma)} if sigma else {}))
    ts = fed.PartialParticipation(
        **kw, **({"noise": fed.GaussianNoise(sigma)} if sigma else {}))
    jr = jax.jit(jmake_round(jp.loss, js, 4, ETA, explicit_state=True))
    tr = core.make_round(tp.loss, ts, 4, ETA, explicit_state=True)
    x, y = jnp.ones(10), -jnp.ones(10)
    tx, ty = torch.ones(10, dtype=torch.float64), -torch.ones(10, dtype=torch.float64)
    jst, tst = js.init_state(x, y, 6), ts.init_state(tx, ty, 6)
    for t in range(20):
        x, y, jst = jr(x, y, jp.agent_data, jst)
        tx, ty, tst = tr(tx, ty, tp.agent_data, tst)
        assert _rel(x, tx) <= ROUND_RTOL and _rel(y, ty) <= ROUND_RTOL, t
        for key in jst:
            assert np.array_equal(np.asarray(jst[key]).astype(np.int64),
                                  tst[key].numpy()), (t, key)


def test_partial_gt_aliases_and_bytes():
    for name in ("partial_gt", "partial_participation"):
        s = fed.resolve_strategy(name, participation=0.25, seed=4)
        assert s == fed.PartialParticipation(participation=0.25, seed=4)
        j = jfed.resolve_strategy(name, participation=0.25, seed=4)
        x = torch.zeros(50, dtype=torch.float64)
        assert s.bytes_per_round(x, x, 20) == j.bytes_per_round(jnp.zeros(50), jnp.zeros(50), 20)


def test_fixture_masks_and_gaps_are_the_ports():
    """The committed JAX run of PartialParticipation(0.5, seed 0) on the
    Theorem 1 problem: the port draws the same masks, bit for bit, and its
    gaps follow JAX's (first 100 of the fixture's rounds)."""
    fix = load_stochastic_rounds()
    masks, gaps = partial_run("cpu", rounds=100)
    assert np.array_equal(masks, fix["partial_mask"][:100])
    want = fix["partial_gap"][:101]
    np.testing.assert_allclose(gaps, want, rtol=1e-9)
    assert PARTIAL[2] == len(fix["partial_mask"])
