"""The port's schedule representations (`repro_torch.sim.schedule`)
against the JAX package's (CPU), the schedule tests of
tests/test_sparse_elastic.py ported:

  * `ChunkedRoundSchedule` equals the dense `RoundSchedule` bit for bit
    (chunk boundaries that do not divide T, so the Markov carry crosses
    them), and JAX's chunked events; random access behind the carry, the
    chunked `tail` and `materialize`;
  * the streaming statistics (participation, churn events, the
    representation-independent `summary_trace`) equal JAX's and agree
    dense against chunked against sparse;
  * `SparseRoundSchedule`: events scatter to the densified schedule, the
    ids and budgets are JAX's, the event contract, the tail's churn at the
    seam, and dense processes are refused.
"""
import numpy as np
import pytest

from repro import sim as jsim
from repro_torch import sim

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

M, T, K = 8, 6, 5
ACTIVE = 4


def _sparse_pops(m=M, size=ACTIVE):
    strag = {"p_straggle": 0.5, "min_frac": 0.4}
    return (jsim.Population(m, jsim.UniformActiveSubset(size=size),
                            jsim.UniformStragglers(**strag)),
            sim.Population(m, sim.UniformActiveSubset(size=size),
                           sim.UniformStragglers(**strag)))


def _events_equal(a, b):
    for f in ("active", "budgets", "joined", "departed"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert a.full == b.full and a.index == b.index


def _churn_pop(avail):
    name, kw = avail
    return (jsim.Population(12, getattr(jsim, name)(**kw), jsim.UniformStragglers(0.7, 0.3)),
            sim.Population(12, getattr(sim, name)(**kw), sim.UniformStragglers(0.7, 0.3)))


CHURN = [("MarkovChurn", {"p_leave": 0.3, "p_join": 0.5}),
         ("BernoulliAvailability", {"p": 0.6})]


# ------------------------------------------------- chunked == dense bitwise
@pytest.mark.parametrize("avail", CHURN, ids=lambda p: p[0])
def test_chunked_rounds_match_dense_and_jax_bitwise(avail):
    jpop, pop = _churn_pop(avail)
    dense = pop.schedule(0, 40, K, device="cpu")
    ch = pop.chunked_schedule(0, 40, K, chunk_rounds=7, device="cpu")
    jch = jpop.chunked_schedule(0, 40, K, chunk_rounds=7)
    assert len(ch) == len(dense) == 40 and ch.m == dense.m
    assert not ch.is_static_full
    for t in range(40):
        _events_equal(ch[t], dense[t])
        _events_equal(ch[t], jch[t])


def test_chunked_random_access_replays_from_checkpoints():
    pop = sim.Population(10, sim.MarkovChurn(0.2, 0.6), sim.UniformStragglers())
    dense = pop.schedule(3, 30, K, device="cpu")
    ch = pop.chunked_schedule(3, 30, K, chunk_rounds=4, device="cpu")
    for t in (27, 2, 15, 16, 0):
        _events_equal(ch[t], dense[t])
    with pytest.raises(IndexError):
        ch[30]


def test_chunked_tail_continues_the_trajectory():
    jpop, pop = _churn_pop(CHURN[0])
    dense = pop.schedule(0, 40, K, device="cpu")
    tail = pop.chunked_schedule(0, 40, K, chunk_rounds=7, device="cpu").tail(13)
    jtail = jpop.chunked_schedule(0, 40, K, chunk_rounds=7).tail(13)
    dtail = dense.tail(13)
    assert len(tail) == len(dtail) == len(jtail) == 27
    for t in range(len(tail)):
        _events_equal(tail[t], dtail[t])
        _events_equal(tail[t], jtail[t])


def test_chunked_materialize_equals_dense_trace():
    _, pop = _churn_pop(CHURN[0])
    a = pop.schedule(0, 40, K, device="cpu").trace()
    b = pop.chunked_schedule(0, 40, K, chunk_rounds=9, device="cpu").materialize().trace()
    np.testing.assert_array_equal(a["active"], b["active"])
    np.testing.assert_array_equal(a["budgets"], b["budgets"])
    assert (a["seed"], a["num_local_steps"]) == (b["seed"], b["num_local_steps"])


def test_stable_chunked_is_static_full_from_the_configuration():
    ch = sim.Population(5).chunked_schedule(0, 10, K, device="cpu")
    assert ch.is_static_full
    with pytest.raises(ValueError, match=">= 1 round"):
        sim.Population(5).chunked_schedule(0, 0, K, device="cpu")


# ----------------------------------------------- streaming statistics parity
def test_stats_agree_dense_chunked_and_jax():
    jpop, pop = _churn_pop(CHURN[0])
    dense = pop.schedule(0, 40, K, device="cpu")
    ch = pop.chunked_schedule(0, 40, K, chunk_rounds=7, device="cpu")
    jdense = jpop.schedule(0, 40, K)
    assert ch.participation_rate() == dense.participation_rate() == \
        jdense.participation_rate()
    assert ch.churn_events() == dense.churn_events() == jdense.churn_events()
    a, b, c = dense.summary_trace(), ch.summary_trace(), jdense.summary_trace()
    for k in ("num_active", "budget_total", "active_digest"):
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])
    assert ch.trace()["num_active"].shape == (40,)


def test_sparse_summary_matches_densified_and_jax():
    jpop, pop = _sparse_pops()
    sp = pop.sparse_schedule(0, T, K, device="cpu")
    de = sp.densify()
    jsp = jpop.sparse_schedule(0, T, K)
    a, b, c = sp.summary_trace(), de.summary_trace(), jsp.summary_trace()
    for k in ("num_active", "budget_total", "active_digest"):
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])
    assert sp.participation_rate() == pytest.approx(ACTIVE / M, abs=1e-15)
    assert sp.churn_events() == de.churn_events() == jsp.churn_events()


# ----------------------------------------------- sparse schedule contract
def test_sparse_events_equal_jax_and_scatter_to_the_densified_schedule():
    jpop, pop = _sparse_pops()
    sp = pop.sparse_schedule(0, T, K, device="cpu")
    jsp = jpop.sparse_schedule(0, T, K)
    de, jde = sp.densify(), jsp.densify()
    np.testing.assert_array_equal(de.active, jde.active)
    np.testing.assert_array_equal(de.budgets, jde.budgets)
    for t in range(T):
        np.testing.assert_array_equal(sp[t].active_ids, jsp[t].active_ids)
        np.testing.assert_array_equal(sp[t].budgets, jsp[t].budgets)
        _events_equal(sp[t].to_dense(K), de[t])


def test_sparse_event_contract():
    _, pop = _sparse_pops()
    sp = pop.sparse_schedule(0, T, K, device="cpu")
    assert not sp.is_static_full and len(sp) == T and sp.m == M
    for ev in sp:
        ids = ev.active_ids
        assert ids.dtype == np.int64 and (np.diff(ids) > 0).all()
        assert ev.num_active == ACTIVE
        assert ev.budgets.dtype == np.int32
        assert (ev.budgets >= 1).all() and (ev.budgets <= K).all()


def test_sparse_tail_reports_churn_at_the_seam():
    _, pop = _sparse_pops()
    sp = pop.sparse_schedule(0, T, K, device="cpu")
    tail = sp.tail(3)
    np.testing.assert_array_equal(tail[0].active_ids, sp[3].active_ids)
    np.testing.assert_array_equal(tail[0].prev_ids, sp[2].active_ids)
    np.testing.assert_array_equal(
        tail[0].joined_ids, np.setdiff1d(sp[3].active_ids, sp[2].active_ids))
    np.testing.assert_array_equal(
        tail[0].departed_ids, np.setdiff1d(sp[2].active_ids, sp[3].active_ids))
    assert tail[0].churned == (not np.array_equal(sp[3].active_ids, sp[2].active_ids))
    assert sp[0].prev_ids is None and len(sp[0].joined_ids) == 0
    assert not sp[0].churned
    # the densified tail baselines round 0 against the true previous ids
    prev = np.zeros(M, bool)
    prev[sp[2].active_ids] = True
    np.testing.assert_array_equal(tail.densify().prev_active, prev)


def test_dense_process_is_rejected_and_small_subsets_checked():
    pop = sim.Population(M, sim.MarkovChurn(), sim.UniformStragglers())
    with pytest.raises(TypeError, match="SparseAvailability"):
        pop.sparse_schedule(0, T, K, device="cpu")
    with pytest.raises(TypeError, match="SparseAvailability"):
        sim.SparseRoundSchedule(pop, 0, T, K, device="cpu")
    small = sim.Population(M, sim.UniformActiveSubset(size=2), min_active=3)
    with pytest.raises(ValueError, match="min_active"):
        small.sparse_schedule(0, T, K, device="cpu")


def test_mega_schedule_draws_in_o_active():
    """The mega preset's sparse schedule at 1e6 agents: each round's ids
    and budgets are JAX's; nothing allocates an [m] row."""
    jsp = jsim.make_population("mega", 0).sparse_schedule(0, 2, 10)
    sp = sim.make_population("mega", 0).sparse_schedule(0, 2, 10, device="cpu")
    for t in range(2):
        assert sp[t].num_active == 256 and sp[t].m == 1_000_000
        np.testing.assert_array_equal(sp[t].active_ids, jsp[t].active_ids)
        np.testing.assert_array_equal(sp[t].budgets, jsp[t].budgets)
