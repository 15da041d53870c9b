"""The port's client population (`repro_torch.sim.population`,
`sim.schedule.RoundSchedule`) against the JAX package's (CPU), a port of
tests/test_population.py:

  * every availability process x straggler model gives JAX's `active` and
    `budgets` bit for bit (f64 uniforms, int32 / int64 randint, batched
    permutations, the stable double argsort of the min-active forcing);
  * the O(active) draws (`UniformActiveSubset.sample_active_ids`,
    `budgets_for_ids`) equal JAX's;
  * schedules are a pure function of (population, seed); the availability
    stream is a dedicated fold of the run seed, equal to JAX's key;
  * the membership contract (budgets 0 iff inactive, in [1, K] when
    active, `min_active` survives every round), joins / departures, and
    `tail` at the seam;
  * the server weights (re-normalized and the naive 1/m) equal JAX's, and
    one round's inputs reach the device as the event's values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro_torch import prng, sim
from repro_torch.fed import GradientTracking, PartialParticipation

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

M, T, K = 12, 40, 7

#: (class name, kwargs), built alike in both packages
PROCESSES = [
    ("AlwaysOn", {}),
    ("BernoulliAvailability", {"p": 0.6}),
    ("MarkovChurn", {"p_leave": 0.3, "p_join": 0.5}),
    ("DiurnalAvailability", {"period": 10, "low": 0.2, "high": 0.9}),
    ("FixedSizeSampling", {"participation": 0.4}),
    ("UniformActiveSubset", {"size": 5}),
]
STRAGGLERS = [
    ("NoStragglers", {}),
    ("UniformStragglers", {"p_straggle": 0.7, "min_frac": 0.3}),
    ("DeterministicLag", {"slow_every": 3, "budget_frac": 0.3}),
]


def _pops(avail, strag, m=M, **kw):
    """(JAX population, port population) of one configuration."""
    (an, ak), (sn, sk) = avail, strag
    return (jsim.Population(m, getattr(jsim, an)(**ak), getattr(jsim, sn)(**sk), **kw),
            sim.Population(m, getattr(sim, an)(**ak), getattr(sim, sn)(**sk), **kw))


def _schedules(avail, strag, seed=0, rounds=T, **kw):
    jp, tp = _pops(avail, strag, **kw)
    return jp.schedule(seed, rounds, K), tp.schedule(seed, rounds, K, device="cpu")


def _same(a, b):
    assert b.active.dtype == bool and b.budgets.dtype == np.int32
    np.testing.assert_array_equal(a.active, b.active)
    np.testing.assert_array_equal(a.budgets, b.budgets)


# ------------------------------------------------------------- bit for bit
@pytest.mark.parametrize("avail", PROCESSES, ids=lambda p: p[0])
@pytest.mark.parametrize("strag", STRAGGLERS, ids=lambda s: s[0])
def test_schedule_equals_jax_bitwise(avail, strag):
    """Every process x straggler model, two seeds, a min_active floor of
    2 (so the forcing draws too): active and budgets bit for bit."""
    for seed in (0, 7):
        a, b = _schedules(avail, strag, seed, min_active=2)
        _same(a, b)
        assert b.is_static_full == a.is_static_full


@pytest.mark.parametrize("scenario", ["stable", "flaky", "diurnal", "straggler_heavy"])
def test_scenarios_equal_jax_bitwise(scenario):
    """The benchmark's presets at its size (m=10, K=10, 1200 rounds)."""
    a = jsim.make_population(scenario, 10).schedule(0, 1200, 10)
    b = sim.make_population(scenario, 10).schedule(0, 1200, 10, device="cpu")
    _same(a, b)
    assert b.participation_rate() == a.participation_rate()
    assert b.churn_events() == a.churn_events()


def test_min_active_forcing_equals_jax():
    """Near-empty Bernoulli rounds: the forced agents are JAX's (the
    priorities' stable double argsort), and the floor holds."""
    for min_active in (1, 2, 5):
        a, b = _schedules(("BernoulliAvailability", {"p": 0.01}),
                          ("NoStragglers", {}), rounds=200, min_active=min_active)
        _same(a, b)
        assert (b.active.sum(axis=1) >= min_active).all()


@pytest.mark.parametrize("m,size", [(50, 7), (1000, 256), (1_000_000, 256),
                                    (12, 12), (70, 64)])
def test_sparse_active_ids_equal_jax(m, size):
    """UniformActiveSubset's O(size) rejection draws: JAX's ids."""
    key = jsim.availability_key(3)
    tkey = sim.availability_key(3)
    for t in (0, 1, 17):
        want = jsim.UniformActiveSubset(size=size).sample_active_ids(key, m, t)
        got = sim.UniformActiveSubset(size=size).sample_active_ids(tkey, m, t, "cpu")
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strag", STRAGGLERS[1:], ids=lambda s: s[0])
def test_budgets_for_ids_equal_jax(strag):
    name, kw = strag
    ids = np.array([0, 3, 5, 11, 4096, 999_999], np.int64)
    for t in (0, 9):
        want = getattr(jsim, name)(**kw).budgets_for_ids(
            jsim.availability_key(1), ids, t, K)
        got = getattr(sim, name)(**kw).budgets_for_ids(
            sim.availability_key(1), ids, t, K, "cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want))


def test_windows_thread_the_markov_carry():
    """Consecutive windows with the carry threaded equal one full window;
    a window after 0 without it raises, as in JAX."""
    proc = sim.MarkovChurn(p_leave=0.3, p_join=0.5)
    key = prng.PRNGKey(4)
    full, _ = proc.sample_rounds(key, M, 0, 30, None, "cpu")
    a, carry = proc.sample_rounds(key, M, 0, 11, None, "cpu")
    b, _ = proc.sample_rounds(key, M, 11, 30, carry, "cpu")
    np.testing.assert_array_equal(np.concatenate([a, b]), full)
    want, _ = jsim.MarkovChurn(p_leave=0.3, p_join=0.5).sample_rounds(
        jax.random.PRNGKey(4), M, 0, 30)
    np.testing.assert_array_equal(full, np.asarray(want))
    with pytest.raises(ValueError, match="stateful"):
        proc.sample_rounds(key, M, 5, 9, None, "cpu")


def test_batched_permutation_equals_stacked_and_jax():
    """`prng.permutation` of a key batch (FixedSizeSampling's rounds in one
    pass) equals the single-key permutations and JAX's vmapped draw, also
    past n = 1,626 where it takes two rounds."""
    keys = prng.fold_in(prng.PRNGKey(2), np.arange(5))
    jkeys = jax.vmap(lambda t: jax.random.fold_in(jax.random.PRNGKey(2), t))(
        jnp.arange(5))
    for n in (1, 12, 2000):
        got = prng.permutation(keys, n, "cpu")
        assert got.shape == (5, n)
        for i in range(5):
            assert torch.equal(got[i], prng.permutation(keys[i], n, "cpu"))
        want = jax.vmap(lambda k: jax.random.permutation(k, n))(jkeys)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- determinism
def test_rebuild_and_seed():
    avail, strag = PROCESSES[2], STRAGGLERS[1]
    _, tp = _pops(avail, strag)
    a, b = tp.schedule(0, T, K, device="cpu"), tp.schedule(0, T, K, device="cpu")
    _same(a, b)
    c = tp.schedule(1, T, K, device="cpu")
    assert (a.active != c.active).any()


def test_availability_stream_is_jax_dedicated_fold():
    for seed in (0, 7, 2 ** 40 + 3):
        k = sim.availability_key(seed)
        assert np.array_equal(np.asarray(jsim.availability_key(seed)).astype(np.int64),
                              k.numpy())
        assert not torch.equal(k, prng.PRNGKey(seed))
    assert sim.AVAILABILITY_STREAM == jsim.AVAILABILITY_STREAM


def _config(pop):
    """A population's configuration as plain data (class names, knobs)."""
    return (pop.m, pop.min_active, pop.pods,
            type(pop.availability).__name__, dataclasses.asdict(pop.availability),
            type(pop.stragglers).__name__, dataclasses.asdict(pop.stragglers))


def test_scenario_presets_resolve_and_build():
    """The presets are JAX's configurations, and the mega preset pins its
    own scale."""
    assert sorted(sim.SCENARIOS) == sorted(jsim.SCENARIOS)
    for name in sim.SCENARIOS:
        assert _config(sim.make_population(name, M)) == _config(
            jsim.make_population(name, M))
    for name in ("stable", "flaky", "diurnal", "straggler_heavy"):
        s = sim.make_population(name, M).schedule(0, T, K, device="cpu")
        assert len(s) == T and s.m == M
    mega = sim.make_population("mega", M)
    assert (mega.m, mega.pods, mega.supports_sparse) == (1_000_000, 1024, True)
    with pytest.raises(ValueError, match="unknown population scenario"):
        sim.make_population("nope", M)


# ------------------------------------------------------- membership contract
@pytest.mark.parametrize("avail", PROCESSES, ids=lambda p: p[0])
def test_budget_bounds(avail):
    for strag in STRAGGLERS:
        s = _pops(avail, strag)[1].schedule(0, T, K, device="cpu")
        assert (s.budgets[~s.active] == 0).all()
        assert (s.budgets[s.active] >= 1).all()
        assert (s.budgets[s.active] <= K).all()


def test_static_full_and_stragglers():
    s = sim.Population(M).schedule(0, T, K, device="cpu")
    assert s.is_static_full and s.churn_events() == 0
    assert s[0].full and not s[0].churned
    s = sim.Population(M, sim.AlwaysOn(), sim.DeterministicLag(slow_every=2)).schedule(
        0, T, K, device="cpu")
    assert not s.is_static_full and s[0].full is False


def test_events_report_joins_and_departures():
    active = np.array([[1, 1, 0], [1, 0, 1]], bool)
    s = sim.RoundSchedule(active, np.where(active, K, 0).astype(np.int32), K)
    ev = s[1]
    np.testing.assert_array_equal(ev.joined, [False, False, True])
    np.testing.assert_array_equal(ev.departed, [False, True, False])
    assert ev.churned and ev.num_active == 2
    np.testing.assert_array_equal(ev.active_ids, [0, 2])
    # round 0 churns against the implicit all-present start
    assert s[0].departed[2] and not s[0].joined.any()


def test_schedule_validates_contract():
    active = np.ones((2, 3), bool)
    bad = np.full((2, 3), K, np.int32)
    bad[0, 1] = 0
    with pytest.raises(ValueError, match="budget of >= 1"):
        sim.RoundSchedule(active, bad, K)
    with pytest.raises(ValueError, match="zero step budget"):
        sim.RoundSchedule(~active, np.full((2, 3), 1, np.int32), K)
    with pytest.raises(ValueError, match="no active agents"):
        sim.RoundSchedule(np.array([[1, 1], [0, 0]], bool),
                          np.array([[3, 3], [0, 0]], np.int32), 3)
    with pytest.raises(ValueError, match="min_active"):
        sim.Population(3, min_active=4)
    with pytest.raises(ValueError, match="pods"):
        sim.Population(3, pods=4)


def test_tail_preserves_churn_provenance_at_the_seam():
    """Round 0 of `tail(t)` reports churn against the true round t-1, as
    JAX's tail does."""
    active = np.array([[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], bool)
    budgets = np.where(active, K, 0).astype(np.int32)
    s = sim.RoundSchedule(active, budgets, K)
    js = jsim.RoundSchedule(active, budgets, K)
    for start in (0, 1, 2, 3, 4):
        t, jt = s.tail(start), js.tail(start)
        assert len(t) == len(jt)
        for i in range(len(t)):
            for f in ("active", "budgets", "joined", "departed"):
                np.testing.assert_array_equal(getattr(t[i], f), getattr(jt[i], f))
            assert t[i].full == jt[i].full
    assert s[0].joined.sum() == 0


def test_fixed_size_sampling_exact_count_and_shared_draw():
    """Exactly S active a round, and each round is `fixed_size_mask` of
    that round's key (the one owner PartialParticipation shares)."""
    proc = sim.FixedSizeSampling(participation=0.4)
    S = proc.subset_size(M)
    key = prng.PRNGKey(5)
    rows, _ = proc.sample_rounds(key, M, 3, 9, None, "cpu")
    assert (rows.sum(axis=1) == S).all()
    for i, t in enumerate(range(3, 9)):
        mask = sim.fixed_size_mask(prng.fold_in(key, t), M, S, "cpu")
        np.testing.assert_array_equal(rows[i], mask.numpy())
    pp = PartialParticipation(participation=0.5, seed=3)
    w, _ = pp.sample_weights(pp.init_state(None, None, M), M)
    assert int((w > 0).sum()) == 6


# -------------------------------------------------------------- weights
def test_weights_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        mask = rng.random(M) < 0.5
        mask[0] = True
        for rebase in (True, False):
            want = jsim.ElasticAggregator(None, rebase=rebase).weights(jnp.asarray(mask))
            agg = sim.ElasticAggregator(GradientTracking(), rebase=rebase)
            got = agg.weights(torch.tensor(mask))
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            budgets = np.where(mask, 3, 0).astype(np.int32)
            w, b, a = agg.round_inputs(mask, budgets, "cpu")
            assert torch.equal(w, got)
            assert b.dtype == torch.int64 and np.array_equal(b.numpy(), budgets)
            assert a.dtype == torch.bool and np.array_equal(a.numpy(), mask)
        assert float(sim.renormalized_weights(torch.tensor(mask)).sum()) == \
            pytest.approx(1.0, abs=1e-12)
    agg = sim.ElasticAggregator(GradientTracking(), rebase=False)
    w = agg.weights(torch.arange(M) < 3)
    assert float(w.sum()) == pytest.approx(3 / M, abs=1e-12)


def test_round_prev_active_conventions():
    agg = sim.ElasticAggregator(GradientTracking())
    a = torch.tensor([True, False, True])
    assert torch.equal(agg.round_prev_active(a, None), torch.ones(3, dtype=torch.bool))
    p = torch.tensor([False, True, True])
    assert agg.round_prev_active(a, p) is p
    assert sim.ElasticAggregator(GradientTracking(), rebase=False).round_prev_active(
        a, p) is None


def test_pod_map_partition():
    pm, jpm = sim.PodMap(10, 3), jsim.PodMap(10, 3)
    assert pm.pod_size == jpm.pod_size == 4
    ids = np.array([0, 3, 4, 9])
    np.testing.assert_array_equal(pm.live_pods(ids), jpm.live_pods(ids))
    for p in range(3):
        np.testing.assert_array_equal(pm.agents_of(p), jpm.agents_of(p))
    with pytest.raises(ValueError, match="num_pods"):
        sim.PodMap(3, 4)
    assert sim.Population(10, pods=3).pod_map() == pm
    assert sim.Population(10).pod_map() is None


# ----------------------------------------------------- hypothesis properties
_HAS_HYPOTHESIS = __import__("importlib").util.find_spec("hypothesis") is not None


@pytest.mark.skipif(not _HAS_HYPOTHESIS, reason="needs hypothesis")
def test_markov_schedules_respect_contract_and_equal_jax():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(seed=st.integers(0, 2 ** 16), p_leave=st.floats(0.05, 0.95),
           p_join=st.floats(0.05, 0.95))
    @settings(max_examples=10, deadline=None)
    def inner(seed, p_leave, p_join):
        kw = {"p_leave": p_leave, "p_join": p_join}
        jp, tp = _pops(("MarkovChurn", kw), STRAGGLERS[1], m=8)
        a, s = jp.schedule(seed, 25, 6), tp.schedule(seed, 25, 6, device="cpu")
        _same(a, s)
        assert (s.active.sum(axis=1) >= 1).all()
        assert (s.budgets[~s.active] == 0).all()
        assert ((s.budgets[s.active] >= 1) & (s.budgets[s.active] <= 6)).all()

    inner()
