"""The committed `src/repro_torch/fixtures/sparse_rounds.npz` is what the
JAX package builds: the O(active) engine's m=8 runs of the six families
(forced sparse and through the dense fallback, and FedGDA-GT over 4 pods
with its wire payloads) and the mega preset's engine run at 1e6 agents and
at its 1e4 reference registry (`benchmarks/elastic.py`).  The card has no
JAX, so `chip_smoke.py`'s sparse phases meet JAX's numbers here.  Run this
file as a script to rewrite it:
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_sparse_fixture.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import benchmarks.elastic as jel
from repro import sim as jsim
from repro.fed import GradientTracking, resolve_strategy
from repro.problems import make_quadratic_problem
from repro_torch.fixtures import (
    MEGA,
    MEGA_COUNTS,
    SPARSE,
    SPARSE_FAMILIES,
    SPARSE_PODS,
    SPARSE_ROUNDS,
    load_sparse_rounds,
    sparse_rounds_keys,
)

pytestmark = pytest.mark.torch


def _population(pods=0):
    _, _, m, active, _, _, _, _ = SPARSE
    return jsim.Population(m, jsim.UniformActiveSubset(size=active),
                           jsim.UniformStragglers(p_straggle=0.5, min_frac=0.4),
                           pods=pods)


def _mega_run(m, active, pods, T):
    """`benchmarks/elastic.py`'s `_mega_engine_run`, a round at a time
    (resume on the tail, bitwise the uninterrupted run) for the tracker's
    touched count after each round."""
    pop = jsim.Population(m, jsim.UniformActiveSubset(size=active),
                          jsim.UniformStragglers(p_straggle=0.3, min_frac=0.5),
                          pods=pods)
    eng = jsim.SparseElasticEngine(
        jel._mega_loss, GradientTracking(), jel._mega_source(m), jel.K, jel.ETA,
        pod_map=pop.pod_map(), wire_pods=True, dense_fallback_max_m=0)
    sched = pop.sparse_schedule(jel.SEED, T, jel.K)
    x = y = jnp.zeros(jel.MEGA_DIM)
    touched = []
    for t in range(T):
        x, y = eng.run(x, y, sched.tail(t), num_rounds=1, resume=t > 0)
        touched.append(eng._tracker.num_touched)
    hist = eng.history
    return {
        "ids": np.stack([ev.active_ids for ev in sched]),
        "budgets": np.stack([ev.budgets for ev in sched]),
        "live_pods": np.asarray([h["live_pods"] for h in hist], np.int64),
        "pod_wire_bytes": np.asarray([h["pod_wire_bytes"] for h in hist], np.int64),
        "tracker_touched": np.asarray(touched, np.int64),
        "x": np.asarray(x), "y": np.asarray(y),
    }


def build_sparse_fixture() -> dict:
    jax.config.update("jax_enable_x64", True)
    dim, n, m, active, K, eta, T, seed = SPARSE
    assert (jel.MEGA_DIM, jel.MEGA_SAMPLES, jel.MEGA_T) == (8, 8, 4)
    prob = make_quadratic_problem(jax.random.PRNGKey(0), dim=dim, num_samples=n,
                                  num_agents=m)
    out = {"G": np.asarray(prob.agent_data["G"]),
           "Ab": np.asarray(prob.agent_data["Ab"])}
    scheds = {k: _population().sparse_schedule(seed, T, k) for k in (1, K)}
    out["m8_ids"] = np.stack([ev.active_ids for ev in scheds[K]])
    assert np.array_equal(out["m8_ids"], np.stack([ev.active_ids for ev in scheds[1]]))
    for k in (1, K):
        out[f"m8_budgets_k{k}"] = np.stack([ev.budgets for ev in scheds[k]])
    x0 = jnp.zeros(dim)
    source = jsim.ArrayDataSource(prob.agent_data)
    for fam, (name, kw, Kf) in SPARSE_FAMILIES.items():
        for path, fallback in (("sparse", 0), ("dense", 4096)):
            eng = jsim.SparseElasticEngine(prob.loss, resolve_strategy(name, **kw),
                                           source, Kf, eta,
                                           dense_fallback_max_m=fallback)
            x, y = eng.run(x0, x0, scheds[Kf])
            out[f"{path}_{fam}_x"], out[f"{path}_{fam}_y"] = np.asarray(x), np.asarray(y)
    pop = _population(SPARSE_PODS)
    eng = jsim.SparseElasticEngine(prob.loss, GradientTracking(), source, K, eta,
                                   pod_map=pop.pod_map(), wire_pods=True,
                                   dense_fallback_max_m=0)
    x, y = eng.run(x0, x0, pop.sparse_schedule(seed, T, K))
    out["pods_x"], out["pods_y"] = np.asarray(x), np.asarray(y)
    for what in ("live_pods", "pod_wire_bytes"):
        out[f"pods_{what}"] = np.asarray([h[what] for h in eng.history], np.int64)
    for run, (mm, act, pods, TT) in MEGA.items():
        for what, v in _mega_run(mm, act, pods, TT).items():
            out[f"{run}_{what}"] = v
    return out


@pytest.fixture(scope="module")
def rebuilt():
    return build_sparse_fixture()


def test_sparse_fixture_has_the_expected_arrays():
    got = load_sparse_rounds()
    assert sorted(got) == sparse_rounds_keys()
    dim, _, m, active, K, _, T, _ = SPARSE
    assert got["G"].shape == (m, dim, dim) and got["Ab"].shape == (m, dim)
    assert got["m8_ids"].shape == got["m8_budgets_k5"].shape == (T, active)
    assert (got["m8_budgets_k1"] == 1).all()
    for run, (mm, act, pods, TT) in MEGA.items():
        ids = got[f"{run}_ids"]
        assert ids.shape == (TT, act) and ids.dtype == np.int64
        assert (np.diff(ids, axis=1) > 0).all() and ids.max() < mm
        for what in MEGA_COUNTS:
            assert got[f"{run}_{what}"].shape == (TT,)
        assert (got[f"{run}_live_pods"] <= pods).all()
    assert SPARSE_ROUNDS.stat().st_size < 1e6


@pytest.mark.parametrize("key", sparse_rounds_keys())
def test_sparse_fixture_equals_the_jax_package(rebuilt, key):
    """Ids, budgets and counts exactly; data and iterates 1e-12 relative
    (XLA's CPU reductions may order sums by the host's vector width)."""
    got, want = load_sparse_rounds()[key], rebuilt[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind in "iub":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


if __name__ == "__main__":
    SPARSE_ROUNDS.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(SPARSE_ROUNDS, **build_sparse_fixture())
    print(f"wrote {SPARSE_ROUNDS}")
