"""The O(active) sparse elastic engine and the two-level pod tree of the
port (`repro_torch.sim.sparse`, `core.engine.pod_weighted_sums` /
`pods_total`, `fed.pods`), tests/test_sparse_elastic.py ported
(`TestPodDeviceGroups`, on the SPMD launch layer, is in
tests/test_torch_shardings.py), each case on the same seeded inputs
through JAX and the port (CPU):

  * for the six strategy families at m=8 the dense fallback equals the
    dense elastic runner bit for bit, forced sparse matches it to rtol
    1e-8 / atol 1e-10 (QuantizedGT's rounding draws [n_active rows], not
    [m rows], so it is held to JAX's sparse run only), and the port's
    sparse run matches JAX's per round within 1e-12 (f64); so does a noisy
    SAGDA run, whose keys fold global ids bit for bit;
  * resume via `schedule.tail(t)` is bitwise, and a JAX run's tracker and
    state carried across (`convert.sparse_tracker_from_numpy`) continue in
    the port within 1e-12 of JAX's uninterrupted run;
  * the pod tree equals the flat weighted sum (seeded sweep and a
    hypothesis property, against JAX's partials), quiet pods are exact
    zeros, a NaN stays in its pod, the dense pod payloads round-trip
    bitwise and price as JAX's; `schedule_bytes(pods=)` and
    `wire_report(pods=)` equal JAX's;
  * `realign_state_rows` re-gathers EF rows as JAX's does, bit for bit;
  * the mega preset at its 1e4 reference registry gives JAX's ids,
    budgets, live pods, pod wire bytes and tracker counts exactly, its
    iterates within 1e-9 relative (the synthesized data's normals are
    within a few ulp of JAX's), and `peak_memory` covers what it measured.
"""
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import sim as jsim
from repro.core.engine import pod_weighted_sums as jpod_weighted_sums
from repro.core.engine import pods_total as jpods_total
from repro.fed import pods as jpods
from repro_torch import fed, sim
from repro_torch.benchmarks import elastic as bench
from repro_torch.benchmarks.common import peak_memory
from repro_torch.convert import (
    sparse_tracker_from_numpy,
    strategy_state_from_numpy,
)
from repro_torch.core import engine
from repro_torch.fed import pods
from repro_torch.fixtures import (
    MEGA,
    MEGA_COUNTS,
    SPARSE,
    SPARSE_FAMILIES,
    SPARSE_PODS,
    load_sparse_rounds,
    sparse_population,
    sparse_problem,
)

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

DIM, _, M, ACTIVE, K, ETA, T, SEED = SPARSE
#: port against JAX per round, relative to max |JAX iterate| (f64; the
#: engines sum in other orders)
RTOL_JAX = 1e-12
#: the mega's iterates against JAX's: its data are synthesized from
#: normals within a few ulp of JAX's, not bit for bit
RTOL_MEGA = 1e-9
FAMILIES = list(SPARSE_FAMILIES)
SPARSE_PARITY = [f for f in FAMILIES if f != "quantized_gt"]
_HAS_HYPOTHESIS = importlib.util.find_spec("hypothesis") is not None


@pytest.fixture(scope="module")
def probs():
    fix = load_sparse_rounds()
    jdata = {"G": jnp.asarray(fix["G"]), "Ab": jnp.asarray(fix["Ab"])}
    from repro.problems.quadratic import _loss as jloss

    return (jloss, jdata), sparse_problem("cpu")


def _strategies(fam):
    name, kw, Kf = SPARSE_FAMILIES[fam]
    return jfed.resolve_strategy(name, **kw), fed.resolve_strategy(name, **kw), Kf


def _jpop(pods=0):
    return jsim.Population(M, jsim.UniformActiveSubset(size=ACTIVE),
                           jsim.UniformStragglers(p_straggle=0.5, min_frac=0.4),
                           pods=pods)


def _zeros():
    return torch.zeros(DIM, dtype=torch.float64)


def _close(got, want, rtol=RTOL_JAX, tag=""):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rtol, f"{tag}: {err:.3e} relative"


# ------------------------------------------------- engine parity + resume
class TestSparseEngineParity:
    def _reference(self, tp, strategy, Kf, sched):
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   Kf, ETA)
        return runner.run(_zeros(), _zeros(), len(sched), schedule=sched.densify())

    @pytest.mark.parametrize("fam", FAMILIES)
    def test_dense_fallback_bitwise_equals_dense_elastic(self, probs, fam):
        _, tp = probs
        _, ts, Kf = _strategies(fam)
        sched = sparse_population().sparse_schedule(SEED, T, Kf, device="cpu")
        xr, yr = self._reference(tp, ts, Kf, sched)
        eng = sim.SparseElasticEngine(tp.loss, ts, sim.ArrayDataSource(tp.agent_data),
                                      Kf, ETA)
        xe, ye = eng.run(_zeros(), _zeros(), sched)
        assert torch.equal(xr, xe) and torch.equal(yr, ye)
        assert all(r["path"] == "dense-fallback" for r in eng.history)

    @pytest.mark.parametrize("fam", SPARSE_PARITY)
    def test_forced_sparse_matches_dense_to_fp_tolerance(self, probs, fam):
        _, tp = probs
        _, ts, Kf = _strategies(fam)
        sched = sparse_population().sparse_schedule(SEED, T, Kf, device="cpu")
        xr, yr = self._reference(tp, ts, Kf, sched)
        eng = sim.SparseElasticEngine(tp.loss, ts, sim.ArrayDataSource(tp.agent_data),
                                      Kf, ETA, dense_fallback_max_m=0)
        xe, ye = eng.run(_zeros(), _zeros(), sched)
        np.testing.assert_allclose(xe.numpy(), xr.numpy(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(ye.numpy(), yr.numpy(), rtol=1e-8, atol=1e-10)
        assert all(r["path"] == "sparse" for r in eng.history)

    @pytest.mark.parametrize("fam", FAMILIES)
    @pytest.mark.parametrize("fallback", [0, 4096], ids=["sparse", "dense-fallback"])
    def test_port_matches_jax_per_round(self, probs, fam, fallback):
        """The port's run against JAX's, a round at a time, within
        RTOL_JAX of JAX's iterates (QuantizedGT too: its rounding uniforms
        are JAX's bit for bit); the schedules are equal."""
        (jloss, jdata), tp = probs
        js, ts, Kf = _strategies(fam)
        jsched = _jpop().sparse_schedule(SEED, T, Kf)
        tsched = sparse_population().sparse_schedule(SEED, T, Kf, device="cpu")
        for t in range(T):
            assert np.array_equal(jsched[t].active_ids, tsched[t].active_ids)
            assert np.array_equal(jsched[t].budgets, tsched[t].budgets)
        je = jsim.SparseElasticEngine(jloss, js, jsim.ArrayDataSource(jdata), Kf,
                                      ETA, dense_fallback_max_m=fallback)
        te = sim.SparseElasticEngine(tp.loss, ts, sim.ArrayDataSource(tp.agent_data),
                                     Kf, ETA, dense_fallback_max_m=fallback)
        jx = jy = jnp.zeros(DIM)
        tx = ty = _zeros()
        for t in range(T):
            jx, jy = je.run(jx, jy, jsched.tail(t), num_rounds=1, resume=t > 0)
            tx, ty = te.run(tx, ty, tsched.tail(t), num_rounds=1, resume=t > 0)
            _close(tx, jx, tag=f"{fam} x round {t}")
            _close(ty, jy, tag=f"{fam} y round {t}")
        assert [r["path"] for r in te.history] == [r["path"] for r in je.history]
        fix = load_sparse_rounds()
        path = "sparse" if fallback == 0 else "dense"
        _close(tx, fix[f"{path}_{fam}_x"], tag="fixture x")
        _close(ty, fix[f"{path}_{fam}_y"], tag="fixture y")

    def test_noisy_sagda_sparse_matches_jax_per_round(self, probs):
        """SAGDA at sigma 0.1 through the sparse path: the round's noise
        keys fold the active ids (JAX's bit for bit), the Gaussian draws
        are within a few ulp of JAX's, so per round within RTOL_JAX."""
        (jloss, jdata), tp = probs
        js = jfed.resolve_strategy("sagda", noise_sigma=0.1, noise_seed=3)
        ts = fed.resolve_strategy("sagda", noise_sigma=0.1, noise_seed=3)
        jsched = _jpop().sparse_schedule(SEED, T, K)
        tsched = sparse_population().sparse_schedule(SEED, T, K, device="cpu")
        je = jsim.SparseElasticEngine(jloss, js, jsim.ArrayDataSource(jdata), K, ETA,
                                      dense_fallback_max_m=0)
        te = sim.SparseElasticEngine(tp.loss, ts, sim.ArrayDataSource(tp.agent_data),
                                     K, ETA, dense_fallback_max_m=0)
        jx = jy = jnp.zeros(DIM)
        tx = ty = _zeros()
        for t in range(T):
            jx, jy = je.run(jx, jy, jsched.tail(t), num_rounds=1, resume=t > 0)
            tx, ty = te.run(tx, ty, tsched.tail(t), num_rounds=1, resume=t > 0)
            _close(tx, jx, tag=f"sagda x round {t}")
            _close(ty, jy, tag=f"sagda y round {t}")
        assert np.array_equal(np.asarray(je._state["noise_key"]).astype(np.int64),
                              te._state["noise_key"].numpy())
        # noise moves the run off the deterministic one
        det = sim.SparseElasticEngine(tp.loss, fed.SAGDA(),
                                      sim.ArrayDataSource(tp.agent_data), K, ETA,
                                      dense_fallback_max_m=0)
        xd, _ = det.run(_zeros(), _zeros(), tsched)
        assert not torch.equal(xd, tx)

    @pytest.mark.parametrize("ids", [[0, 3, 7], [5, 999_999, 2**31 + 1],
                                     list(range(0, 8192 * 120, 120))],
                             ids=["small", "large", "chunk"])
    def test_noise_keys_of_global_ids_bitwise(self, ids):
        """`sample_noise_keys_ids` folds the ids as JAX's uint32 words,
        three rounds on; a batch of 8192 ids (the tracker's init chunk) in
        one pass."""
        js = jfed.SAGDA(noise=jfed.GaussianNoise(0.1), noise_seed=1)
        ts = fed.SAGDA(noise=fed.GaussianNoise(0.1), noise_seed=1)
        jst = js.init_state(jnp.zeros(2), jnp.zeros(2), 1)
        tst = ts.init_state(torch.zeros(2), torch.zeros(2), 1)
        ids = np.asarray(ids, np.int64)
        for _ in range(3):
            jk, jst = js.sample_noise_keys_ids(jst, ids)
            tk, tst = ts.sample_noise_keys_ids(tst, ids)
            assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
        assert fed.GradientTracking().sample_noise_keys_ids({}, ids) == (None, {})

    @pytest.mark.parametrize("fallback", [0, 4096], ids=["sparse", "dense-fallback"])
    @pytest.mark.parametrize("name", ["fedgda_gt", "compressed_gt"])
    def test_resume_via_tail_is_bitwise(self, probs, fallback, name):
        _, tp = probs
        sched = sparse_population().sparse_schedule(SEED, T, K, device="cpu")
        mk = lambda: sim.SparseElasticEngine(
            tp.loss, fed.resolve_strategy(name), sim.ArrayDataSource(tp.agent_data),
            K, ETA, dense_fallback_max_m=fallback)
        full = mk()
        xf, yf = full.run(_zeros(), _zeros(), sched)
        split = mk()
        xm, ym = split.run(_zeros(), _zeros(), sched, num_rounds=3)
        xs, ys = split.run(xm, ym, sched.tail(3), resume=True)
        assert torch.equal(xf, xs) and torch.equal(yf, ys)
        assert len(split.history) == len(full.history) == T

    def test_resume_from_a_jax_run(self, probs):
        """JAX runs 3 rounds of CompressedGT; its tracker (sums, anchor,
        touched rows), strategy state (EF rows, key) and last ids carry
        across as numpy; the port runs the tail: within RTOL_JAX of JAX's
        uninterrupted run, and the touched counts agree."""
        (jloss, jdata), tp = probs
        js, ts, _ = _strategies("compressed_gt")
        jsched = _jpop().sparse_schedule(SEED, T, K)
        full = jsim.SparseElasticEngine(jloss, js, jsim.ArrayDataSource(jdata), K,
                                        ETA, dense_fallback_max_m=0)
        jxf, jyf = full.run(jnp.zeros(DIM), jnp.zeros(DIM), jsched)
        part = jsim.SparseElasticEngine(jloss, js, jsim.ArrayDataSource(jdata), K,
                                        ETA, dense_fallback_max_m=0)
        jx, jy = part.run(jnp.zeros(DIM), jnp.zeros(DIM), jsched, num_rounds=3)
        tr = part._tracker
        slots = sorted(tr._index, key=tr._index.get)
        rows = lambda leaves, treedef: jax.tree.unflatten(
            treedef, [leaf[:tr.num_touched] for leaf in leaves])
        tracker = sparse_tracker_from_numpy({
            "m": tr.m, "sum_gx": np.asarray(tr.sum_gx), "sum_gy": np.asarray(tr.sum_gy),
            "x0": np.asarray(tr.x0), "y0": np.asarray(tr.y0),
            "ids": np.asarray(slots, np.int64),
            "rows_gx": rows(tr._gx_leaves, tr._gx_def),
            "rows_gy": rows(tr._gy_leaves, tr._gy_def)}, "cpu")
        assert tracker.num_touched == tr.num_touched
        te = sim.SparseElasticEngine(tp.loss, ts, sim.ArrayDataSource(tp.agent_data),
                                     K, ETA, dense_fallback_max_m=0)
        te.resume_from(tracker, strategy_state_from_numpy(
            jax.tree.map(np.asarray, part._state), "cpu"), part._prev_ids)
        tsched = sparse_population().sparse_schedule(SEED, T, K, device="cpu")
        tx, ty = te.run(torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy)),
                        tsched.tail(3), resume=True)
        _close(tx, jxf, tag="x")
        _close(ty, jyf, tag="y")
        assert te._tracker.num_touched == full._tracker.num_touched

    def test_sparse_resume_without_a_run_raises(self, probs):
        _, tp = probs
        eng = sim.SparseElasticEngine(tp.loss, fed.GradientTracking(),
                                      sim.ArrayDataSource(tp.agent_data), K, ETA,
                                      dense_fallback_max_m=0)
        sched = sparse_population().sparse_schedule(SEED, T, K, device="cpu")
        with pytest.raises(ValueError, match="resume"):
            eng.run(_zeros(), _zeros(), sched, resume=True)

    def test_schedule_population_mismatch_raises(self, probs):
        _, tp = probs
        eng = sim.SparseElasticEngine(tp.loss, fed.GradientTracking(),
                                      sim.ArrayDataSource(tp.agent_data), K, ETA)
        sched = sim.Population(12, sim.UniformActiveSubset(size=4)).sparse_schedule(
            SEED, T, K, device="cpu")
        with pytest.raises(ValueError, match="m=12"):
            eng.run(_zeros(), _zeros(), sched)

    def test_telemetry_and_wire_without_pods_raise(self, probs):
        _, tp = probs
        src = sim.ArrayDataSource(tp.agent_data)
        # the sink is ported (Queue 1 item 11): the engine takes one, emits
        # its fallback decision and sparse rounds, and moves no iterate
        from repro_torch.obs import Telemetry

        sched = sparse_population().sparse_schedule(SEED, T, K, device="cpu")
        tm = Telemetry(probes=("tracker_drift",))
        on = sim.SparseElasticEngine(tp.loss, "fedgda_gt", src, K, ETA,
                                     dense_fallback_max_m=0, telemetry=tm)
        off = sim.SparseElasticEngine(tp.loss, "fedgda_gt", src, K, ETA,
                                      dense_fallback_max_m=0)
        for a, b in zip(on.run(_zeros(), _zeros(), sched),
                        off.run(_zeros(), _zeros(), sched)):
            assert torch.equal(a, b)
        assert [e["value"] for e in tm.series("event", "dense_fallback")] == [False]
        assert [e["runtime"] for e in tm.series("span", "round")] == ["sparse"] * T
        assert len(tm.probe_series("tracker_drift")) == T
        with pytest.raises(ValueError, match="pod_map"):
            sim.SparseElasticEngine(tp.loss, "fedgda_gt", src, K, ETA, wire_pods=True)


# ------------------------------------------------------- pod aggregation
class TestPodAggregation:
    def test_pod_engine_matches_flat_jax_and_records_wire(self, probs):
        """The two-level aggregate changes only the summation order; the
        history's live pods and packed partial bytes equal JAX's."""
        (jloss, jdata), tp = probs
        pop = sparse_population(SPARSE_PODS)
        sched = pop.sparse_schedule(SEED, T, K, device="cpu")
        mk = lambda pm, wire: sim.SparseElasticEngine(
            tp.loss, fed.GradientTracking(), sim.ArrayDataSource(tp.agent_data), K,
            ETA, pod_map=pm, wire_pods=wire, dense_fallback_max_m=0)
        xf, yf = mk(None, False).run(_zeros(), _zeros(), sched)
        eng = mk(pop.pod_map(), True)
        xp, yp = eng.run(_zeros(), _zeros(), sched)
        np.testing.assert_allclose(xp.numpy(), xf.numpy(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(yp.numpy(), yf.numpy(), rtol=1e-8, atol=1e-10)
        jpop = _jpop(SPARSE_PODS)
        je = jsim.SparseElasticEngine(jloss, jfed.GradientTracking(),
                                      jsim.ArrayDataSource(jdata), K, ETA,
                                      pod_map=jpop.pod_map(), wire_pods=True,
                                      dense_fallback_max_m=0)
        jx, jy = je.run(jnp.zeros(DIM), jnp.zeros(DIM), jpop.sparse_schedule(SEED, T, K))
        _close(xp, jx, tag="x")
        _close(yp, jy, tag="y")
        for rec, jrec in zip(eng.history, je.history):
            assert 1 <= rec["live_pods"] <= SPARSE_PODS and rec["pod_wire_bytes"] > 0
            assert (rec["live_pods"], rec["pod_wire_bytes"]) == (
                jrec["live_pods"], jrec["pod_wire_bytes"])
        # the last round's partials round-trip bitwise through their payload
        partials, packed = eng.last_pod_wire
        back = pods.decode_pod_partials(packed)
        assert all(torch.equal(a, b) for a, b in zip(partials, back))

    @pytest.mark.parametrize("seed,n,P", [(0, 5, 2), (1, 16, 4), (2, 7, 7), (3, 24, 3)])
    def test_pod_tree_equals_flat_weighted_mean(self, seed, n, P):
        """Seeded sweep: pods_total . pod_weighted_sums is the flat weighted
        sum, and each pod's partial is JAX's, for any assignment."""
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        u = {"a": np.asarray(jax.random.normal(k1, (n, 3))),
             "b": np.asarray(jax.random.normal(k2, (n,)))}
        w = np.asarray(jax.nn.softmax(jax.random.normal(k3, (n,))))
        pod_ids = np.asarray(jax.random.randint(k3, (n,), 0, P, jnp.int32))
        tu = {k: torch.from_numpy(v.copy()) for k, v in u.items()}
        tw = torch.from_numpy(w.copy())
        parts = engine.pod_weighted_sums(tu, tw, pod_ids, P)
        jparts = jpod_weighted_sums({k: jnp.asarray(v) for k, v in u.items()},
                                    jnp.asarray(w), jnp.asarray(pod_ids), P)
        total = engine.pods_total(parts)
        for k in u:
            np.testing.assert_allclose(parts[k].numpy(), np.asarray(jparts[k]),
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(total[k].numpy(),
                                       np.tensordot(w, u[k], axes=1),
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(total[k].numpy(),
                                       np.asarray(jpods_total(jparts)[k]),
                                       rtol=1e-12, atol=1e-14)

    def test_quiet_pods_are_exact_zero_rows(self):
        u = torch.arange(12.0, dtype=torch.float64).reshape(4, 3)
        w = torch.full((4,), 0.25, dtype=torch.float64)
        part = engine.pod_weighted_sums(u, w, np.zeros(4, np.int32), 3)
        assert torch.equal(part[1:], torch.zeros(2, 3, dtype=torch.float64))
        # no rows at all: every pod is quiet
        empty = engine.pod_weighted_sums(u[:0], w[:0], np.zeros(0, np.int64), 2)
        assert torch.equal(empty, torch.zeros(2, 3, dtype=torch.float64))

    def test_nan_stays_in_its_pod_and_repeats_bitwise(self):
        """A NaN row reaches its own pod only (no 0 * NaN into the others),
        and the same call gives the same bits."""
        g = torch.Generator().manual_seed(5)
        u = torch.randn(9, 4, dtype=torch.float64, generator=g)
        u[4, 1] = float("nan")
        w = torch.rand(9, dtype=torch.float64, generator=g)
        pod_ids = np.array([2, 0, 1, 2, 1, 0, 2, 0, 1])  # row 4 in pod 1
        a = engine.pod_weighted_sums(u, w, pod_ids, 4)
        b = engine.pod_weighted_sums(u, w, torch.from_numpy(pod_ids), 4)
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))
        nan_rows = a.isnan().any(dim=1)
        assert nan_rows.tolist() == [False, True, False, False]
        with pytest.raises(ValueError, match="pod ids"):
            engine.pod_weighted_sums(u, w, pod_ids + 2, 4)

    @pytest.mark.skipif(not _HAS_HYPOTHESIS, reason="needs hypothesis")
    def test_pod_tree_property_hypothesis(self):
        from hypothesis import given, settings
        from hypothesis import strategies as st

        @given(seed=st.integers(0, 2**16), n=st.integers(1, 32),
               num_pods=st.integers(1, 8))
        @settings(max_examples=40, deadline=None)
        def inner(seed, n, num_pods):
            # numpy draws: JAX's would compile anew for every shape
            rng = np.random.default_rng(seed)
            u = rng.standard_normal((n, 4))
            w = np.exp(rng.standard_normal(n))
            w /= w.sum()
            pod_ids = rng.integers(0, num_pods, n, dtype=np.int32)
            total = engine.pods_total(engine.pod_weighted_sums(
                torch.from_numpy(u), torch.from_numpy(w), pod_ids, num_pods))
            np.testing.assert_allclose(total.numpy(), np.tensordot(w, u, axes=1),
                                       rtol=1e-10, atol=1e-12)

        inner()

    def test_encode_decode_roundtrip_is_bitwise(self):
        k = jax.random.PRNGKey(9)
        partials = {"x": np.asarray(jax.random.normal(k, (3, 16))),
                    "y": np.asarray(jax.random.normal(k, (3, 5))).astype(np.float32)}
        tpart = {key: torch.from_numpy(v.copy()) for key, v in partials.items()}
        packed = pods.encode_pod_partials(tpart)
        out = pods.decode_pod_partials(packed)
        for key in partials:
            assert out[key].dtype == tpart[key].dtype
            assert torch.equal(out[key], tpart[key])
        jpacked = jpods.encode_pod_partials(
            {key: jnp.asarray(v) for key, v in partials.items()})
        assert packed.total_bytes() == jpacked.total_bytes() > 0
        plain = pods.encode_pod_partials(tpart, use_kernel=False)
        assert plain.total_bytes() == packed.total_bytes()
        assert torch.equal(pods.decode_pod_partials(plain)["x"], tpart["x"])

    @pytest.mark.parametrize("shape", [(16,), (4, 6)])
    def test_pod_payload_priced_equals_measured(self, shape):
        x = torch.zeros(shape, dtype=torch.float64)
        y = torch.zeros(16, dtype=torch.float32)
        got = pods.pod_payload_bytes(x, y, measured=True)
        assert got == pods.pod_payload_bytes(x, y, measured=False)
        assert got == jpods.pod_payload_bytes(jnp.zeros(shape),
                                              jnp.zeros(16, jnp.float32))

    def test_pod_aligned_shard_count(self):
        for num_pods in range(1, 25):
            for max_shards in range(1, 10):
                d = pods.pod_aligned_shard_count(num_pods, max_shards)
                assert d == jpods.pod_aligned_shard_count(num_pods, max_shards)
                assert 1 <= d <= max_shards and num_pods % d == 0
                assert not any(num_pods % e == 0 for e in range(d + 1, max_shards + 1))
        with pytest.raises(ValueError):
            pods.pod_aligned_shard_count(0, 4)

    def test_pod_map_partition(self):
        pm = sim.PodMap(10, 3)  # pod_size = ceil(10/3) = 4: pods 4/4/2
        got = np.concatenate([pm.agents_of(p) for p in range(3)])
        np.testing.assert_array_equal(got, np.arange(10))
        np.testing.assert_array_equal(pm.pod_of(np.array([0, 3, 4, 9])), [0, 0, 1, 2])
        np.testing.assert_array_equal(pm.live_pods(np.array([9, 1, 0])), [0, 2])


# --------------------------------------------------- wire accounting (pods)
class TestScheduleBytesWithPods:
    def _setup(self):
        pop = sparse_population(SPARSE_PODS)
        return (pop.sparse_schedule(SEED, T, K, device="cpu"), pop.pod_map(),
                _jpop(SPARSE_PODS))

    def test_streaming_price_matches_hand_account_and_jax(self):
        from repro_torch.fed.transport import measured_bytes_per_round

        sp, pm, jpop = self._setup()
        x = _zeros()
        strat = fed.GradientTracking()
        got = sim.schedule_bytes(strat, x, x, K, sp, pods=pm)
        per_agent = measured_bytes_per_round(strat, x, x, K)
        per_pod = pods.pod_payload_bytes(x, x)
        assert got == [per_agent * ev.num_active
                       + per_pod * len(pm.live_pods(ev.active_ids)) for ev in sp]
        jx = jnp.zeros(DIM)
        assert got == jsim.schedule_bytes(jfed.GradientTracking(), jx, jx, K,
                                          jpop.sparse_schedule(SEED, T, K),
                                          pods=jpop.pod_map())

    def test_sparse_and_densified_price_identically(self):
        sp, pm, _ = self._setup()
        x = _zeros()
        a = sim.schedule_bytes(fed.GradientTracking(), x, x, K, sp, pods=pm)
        assert a == sim.schedule_bytes(fed.GradientTracking(), x, x, K, sp.densify(),
                                       pods=pm)

    def test_priced_equals_measured(self):
        sp, pm, _ = self._setup()
        x = _zeros()
        strat = fed.GradientTracking()
        assert sim.schedule_bytes(strat, x, x, K, sp, pods=pm, measured=True) == \
            sim.schedule_bytes(strat, x, x, K, sp, pods=pm, measured=False)

    @pytest.mark.parametrize("measured", [True, False])
    def test_compressed_wire_prices_as_jax(self, measured):
        """A packed per-agent payload (headers in the measured count only)
        plus the dense pod edge, as JAX prices them."""
        sp, pm, jpop = self._setup()
        x, jx = _zeros(), jnp.zeros(DIM)
        got = sim.schedule_bytes(fed.CompressedGT(wire_transport=True), x, x, K, sp,
                                 pods=pm, measured=measured)
        assert got == jsim.schedule_bytes(
            jfed.CompressedGT(wire_transport=True), jx, jx, K,
            jpop.sparse_schedule(SEED, T, K), pods=jpop.pod_map(), measured=measured)

    def test_wire_report_with_pods_equals_jax(self, probs):
        (jloss, jdata), tp = probs
        sp, pm, jpop = self._setup()
        runner = fed.FederatedRunner.from_strategy(tp.loss, "fedgda_gt",
                                                   tp.agent_data, K, ETA)
        jrunner = jfed.FederatedRunner.from_strategy(jloss, "fedgda_gt", jdata, K, ETA)
        rep = runner.wire_report(_zeros(), _zeros(), K, schedule=sp, pods=pm)
        jx = jnp.zeros(DIM)
        assert rep == jrunner.wire_report(jx, jx, K,
                                          schedule=jpop.sparse_schedule(SEED, T, K),
                                          pods=jpop.pod_map())
        flat = runner.wire_report(_zeros(), _zeros(), K, schedule=sp)
        assert rep["scheduled_total_bytes"] > flat["scheduled_total_bytes"]


# ------------------------------------------------------- EF row realignment
class TestRealignStateRows:
    def test_continuing_rows_carry_others_restart_at_zero(self):
        strat = fed.CompressedGT(compression_ratio=0.25, seed=0)
        state = strat.init_state(_zeros(), _zeros(), 3)
        assert set(strat.sharded_state_keys) <= set(state)
        # row j of the previous layout filled with its own GLOBAL id
        prev_ids = np.array([2, 5, 9])
        for k in strat.sharded_state_keys:
            state[k] = torch.from_numpy(prev_ids.astype(np.float64))[:, None] \
                * torch.ones_like(state[k])
        out = strat.realign_state_rows(state, prev_ids, np.array([5, 7, 9]))
        for k in strat.sharded_state_keys:
            rows = out[k].numpy()
            np.testing.assert_array_equal(rows[0], 5.0)  # continued
            np.testing.assert_array_equal(rows[1], 0.0)  # new agent
            np.testing.assert_array_equal(rows[2], 9.0)  # continued

    def test_none_prev_zeroes_everything(self):
        strat = fed.CompressedGT(compression_ratio=0.25, seed=0)
        state = strat.init_state(torch.zeros(4), torch.zeros(4), 2)
        for k in strat.sharded_state_keys:
            state[k] = state[k] + 1.0
        out = strat.realign_state_rows(state, None, np.array([0, 1]))
        for k in strat.sharded_state_keys:
            assert torch.equal(out[k], torch.zeros(2, 4))
        # strategies without per-agent rows pass their state through
        st = {"noise_key": torch.zeros(2, dtype=torch.int64)}
        assert fed.GradientTracking().realign_state_rows(st, None, [0]) is st

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_jax_on_random_layouts(self, seed):
        rng = np.random.default_rng(seed)
        prev_ids = np.sort(rng.choice(1000, 12, replace=False))
        ids = np.sort(np.concatenate([rng.choice(prev_ids, 5, replace=False),
                                      rng.choice(np.arange(1000, 1100), 4,
                                                 replace=False)]))
        ex = rng.standard_normal((12, 3, 7))
        ey = rng.standard_normal((12, 7)).astype(np.float32)
        strat = fed.CompressedGT(compression_ratio=0.25)
        jstrat = jfed.CompressedGT(compression_ratio=0.25)
        out = strat.realign_state_rows({"ex": torch.from_numpy(ex),
                                        "ey": torch.from_numpy(ey)}, prev_ids, ids)
        jout = jstrat.realign_state_rows({"ex": jnp.asarray(ex), "ey": jnp.asarray(ey)},
                                         prev_ids, ids)
        for k in ("ex", "ey"):
            assert out[k].dtype == torch.from_numpy(np.asarray(jout[k])).dtype
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k]))


# ------------------------------------------------ mega preset at 1e4
class TestMegaReference:
    @pytest.fixture(scope="class")
    def ref_run(self):
        m, active, n_pods, rounds = MEGA["ref"]
        return bench._mega_engine_run(m, active, n_pods, rounds, device="cpu")

    def test_schedule_equals_jax(self):
        m, active, n_pods, rounds = MEGA["ref"]
        fix = load_sparse_rounds()
        pop = sim.Population(m, sim.UniformActiveSubset(size=active),
                             sim.UniformStragglers(p_straggle=0.3, min_frac=0.5),
                             pods=n_pods)
        sched = pop.sparse_schedule(bench.SEED, rounds, bench.K, device="cpu")
        assert np.array_equal(np.stack([ev.active_ids for ev in sched]), fix["ref_ids"])
        assert np.array_equal(np.stack([ev.budgets for ev in sched]), fix["ref_budgets"])

    @pytest.mark.parametrize("what", MEGA_COUNTS)
    def test_counts_equal_jax(self, ref_run, what):
        fix = load_sparse_rounds()
        hist = ref_run["engine"].history
        got = (ref_run["tracker_touched"] if what == "tracker_touched"
               else [h[what] for h in hist])
        assert list(got) == fix[f"ref_{what}"].tolist()

    def test_iterates_within_tolerance_of_jax(self, ref_run):
        fix = load_sparse_rounds()
        _close(ref_run["x"], fix["ref_x"], RTOL_MEGA, "x")
        _close(ref_run["y"], fix["ref_y"], RTOL_MEGA, "y")

    def test_synthesized_rows_match_jax(self):
        """Per-id data, any subset in any order, within a few ulp of JAX's
        `_mega_source` (its normals)."""
        import benchmarks.elastic as jel

        ids = np.array([999_999, 3, 512_000, 17], np.int64)
        got = bench._mega_source(10**6, device="cpu").gather(ids)
        want = jel._mega_source(10**6).gather(ids)
        for k in ("G", "Ab"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-13, atol=1e-13)


# --------------------------------------------------------- peak-memory gate
class TestPeakMemoryHelper:
    def test_reports_cover_the_allocation(self):
        n = 400_000  # 3.2 MB of float64

        def work():
            buf = np.ones(n, np.float64)
            return float(buf.sum())

        rec = peak_memory(work)
        assert rec["result"] == float(n)
        assert rec["host_peak_bytes"] >= n * 8
        assert rec["live_buffer_bytes"] >= 0 and rec["device_peak_bytes"] is None

    def test_census_sees_the_torch_tensors_left_alive(self):
        keep = []
        rec = peak_memory(lambda: keep.append(torch.ones(1 << 20, dtype=torch.float64)))
        assert rec["live_buffer_bytes"] >= 8 << 20
        assert rec["host_peak_bytes"] < 8 << 20  # torch's allocator is untraced

    def test_gate_trips_on_an_m_dense_structure(self, monkeypatch):
        """A run that keeps an [m] tracker table alive fails the gate that
        the O(active) run passes."""
        monkeypatch.setattr(bench, "MEGA_AGENTS", 20_000)
        assert bench.check_pods(device="cpu") == 0
        real = bench._mega_engine_run
        tables = []

        def dense(m, *args, **kwargs):
            tables.append(torch.zeros((m, 4096), dtype=torch.float64))
            return real(m, *args, **kwargs)

        monkeypatch.setattr(bench, "_mega_engine_run", dense)
        assert bench.check_pods(device="cpu") == 1
