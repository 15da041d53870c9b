"""The port's observability (`repro_torch.obs`) and the runtimes' telemetry,
tests/test_obs.py ported (`TestMultiHostTelemetry` waits for the
multi-host runtime, ROADMAP Queue 1 item 10), on JAX's data (CPU; the
port's async shards on `devices=["cpu"] * 8`, JAX's on `fed_devices`):

  * a sink changes no iterate: `telemetry=None` and a full sink (every
    probe, a gap oracle) give bitwise-equal iterates for the six strategy
    families on the sync runner (plain and elastic), the async runner and
    the sparse engine (dense fallback and forced sparse);
  * `Telemetry(phase_spans=True)` runs the four phases one by one, one span
    each, and equals the fused round bit for bit (the same composition);
  * the probe functions equal JAX's on the same inputs: byte accounts
    exactly, norms and gaps within PROBE_RTOL, residuals at fp noise;
  * the probes agree across the sync-elastic, async-elastic and forced
    sparse runtimes, and with JAX's runtimes on a shared seed;
  * "wire_bytes" counters equal `sim.schedule_bytes` and JAX's counters
    exactly; `wire_report` is schedule-aware as JAX's;
  * the sparse engine's realign / active-set / fallback events equal JAX's;
  * the run ledger round-trips, and the manifest equals JAX's key for key;
  * `profile_rounds` writes a Chrome trace (torch.profiler) per listed
    round; `maybe_span`; `metric_series` on an empty history raises;
  * `peak_memory` lives in `obs` (`benchmarks.common` re-exports the same
    function) and lands in a sink as a "peak_memory" counter.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import obs as jobs
from repro import sim as jsim
from repro.core import tree_sq_dist as jtree_sq_dist
from repro.core.types import grad_xy as jgrad_xy
from repro.obs.ledger import _jsonable as jjsonable
from repro.problems import quadratic_minimax_point as jminimax
from repro_torch import core, fed, sim
from repro_torch.core.types import grad_xy
from repro_torch.obs import (
    RunLedger,
    Telemetry,
    maybe_span,
    peak_memory,
    probes,
    run_manifest,
)
from repro_torch.obs.ledger import _jsonable
from repro_torch.problems import quadratic_minimax_point

from test_torch_elastic import _problems
from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

ETA = 1e-4
DIM, M, T = 16, 8, 5
SEED = 0
CPU8 = ["cpu"] * M
#: probe floats (norms, gaps) against JAX's on the same data, relative
#: (f64; the engines sum in other orders)
PROBE_RTOL = 1e-9
#: a GT residual is fp-reduction noise when the tracker math is right
RESIDUAL_MAX = 1e-8

STRATEGIES = [
    ("full_sync", lambda F: F.FullSync(), 1),
    ("local_only", lambda F: F.LocalOnly(), 5),
    ("gradient_tracking", lambda F: F.GradientTracking(), 5),
    ("partial_participation",
     lambda F: F.PartialParticipation(participation=0.5, seed=0), 5),
    ("compressed_gt", lambda F: F.CompressedGT(compression_ratio=0.25, seed=0), 5),
    ("quantized_gt", lambda F: F.QuantizedGT(bits=8, seed=0), 5),
]
IDS = [s[0] for s in STRATEGIES]
ALL_PROBES = ("gt_residual", "tracker_drift", "ef_residual", "priced_vs_measured",
              "duality_gap")


@pytest.fixture(scope="module")
def probs():
    return _problems(m=M, dim=DIM, samples=40)


def _x0():
    return torch.ones(DIM, dtype=torch.float64), -torch.ones(DIM, dtype=torch.float64)


def _jx0():
    return jnp.ones(DIM), -jnp.ones(DIM)


def _full_telemetry(tp, **kw):
    xs, ys = quadratic_minimax_point(tp)
    return Telemetry(probes=ALL_PROBES, gap_fn=lambda x, y: core.tree_sq_dist(x, xs)
                     + core.tree_sq_dist(y, ys), **kw)


def _jfull_telemetry(jp):
    xs, ys = jminimax(jp)
    return jobs.Telemetry(probes=ALL_PROBES, gap_fn=lambda x, y: jtree_sq_dist(x, xs)
                          + jtree_sq_dist(y, ys))


def _fresh_state(strategy, x, y, m):
    return strategy.init_state(x, y, m) if strategy.stateful else None


def _flaky(K, S=sim):
    kw = {"device": "cpu"} if S is sim else {}
    return S.make_population("flaky", M).schedule(SEED, T, K, **kw)


def _sparse(K, S=sim):
    kw = {"device": "cpu"} if S is sim else {}
    pop = S.Population(M, S.UniformActiveSubset(size=4),
                       S.UniformStragglers(p_straggle=0.5, min_frac=0.4))
    return pop.sparse_schedule(SEED, T, K, **kw)


def _same(a, b):
    assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# ------------------------------------------------- disabled == bitwise pin
class TestBitwisePins:
    """telemetry=None against a full sink on the same runner (or engine
    pair): bitwise-equal iterates.  The sink lives on the host, and the
    probes read state without writing it."""

    @pytest.mark.parametrize("name,make,K", STRATEGIES, ids=IDS)
    def test_sync_plain(self, probs, name, make, K):
        _, tp = probs
        x0, y0 = _x0()
        strategy = make(fed)
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   K, ETA)
        xa, ya = runner.run(x0, y0, T, state=_fresh_state(strategy, x0, y0, M))
        runner.telemetry = _full_telemetry(tp)
        xb, yb = runner.run(x0, y0, T, state=_fresh_state(strategy, x0, y0, M))
        _same(xa, xb)
        _same(ya, yb)
        assert len(runner.telemetry.series("span", "round")) == T

    @pytest.mark.parametrize("name,make,K", STRATEGIES, ids=IDS)
    def test_sync_elastic(self, probs, name, make, K):
        _, tp = probs
        x0, y0 = _x0()
        strategy, sched = make(fed), _flaky(K)
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   K, ETA)
        xa, ya = runner.run(x0, y0, T, schedule=sched,
                            state=_fresh_state(strategy, x0, y0, M))
        runner.telemetry = _full_telemetry(tp)
        xb, yb = runner.run(x0, y0, T, schedule=sched,
                            state=_fresh_state(strategy, x0, y0, M))
        _same(xa, xb)
        _same(ya, yb)
        assert len(runner.telemetry.series("span", "round")) == T

    @pytest.mark.parametrize("name,make,K", STRATEGIES, ids=IDS)
    def test_async(self, probs, name, make, K):
        # two runners (the shards' state starts once per runner); same
        # devices, same phases: only the sink differs
        _, tp = probs
        x0, y0 = _x0()
        off = fed.AsyncFederatedRunner(tp.loss, make(fed), tp.agent_data, K, ETA,
                                       devices=CPU8)
        xa, ya = off.run(x0, y0, T)
        on = fed.AsyncFederatedRunner(tp.loss, make(fed), tp.agent_data, K, ETA,
                                      devices=CPU8, telemetry=_full_telemetry(tp))
        xb, yb = on.run(x0, y0, T)
        _same(xa, xb)
        _same(ya, yb)
        assert len(on.telemetry.series("span", "round")) == T

    @pytest.mark.parametrize("name,make,K", STRATEGIES, ids=IDS)
    @pytest.mark.parametrize("fallback", [True, False],
                             ids=["dense-fallback", "sparse"])
    def test_sparse_engine(self, probs, name, make, K, fallback):
        _, tp = probs
        x0, y0 = _x0()
        sched = _sparse(K)
        kw = {} if fallback else {"dense_fallback_max_m": 0}

        def build(tm):
            return sim.SparseElasticEngine(tp.loss, make(fed),
                                           sim.ArrayDataSource(tp.agent_data), K,
                                           ETA, telemetry=tm, **kw)

        xa, ya = build(None).run(x0, y0, sched)
        tm = _full_telemetry(tp)
        xb, yb = build(tm).run(x0, y0, sched)
        _same(xa, xb)
        _same(ya, yb)
        fb = tm.series("event", "dense_fallback")
        assert len(fb) == 1 and fb[0]["value"] is fallback


# ----------------------------------------------------- phase-span dispatch
class TestPhaseSpans:
    @pytest.mark.parametrize("name,make,K", STRATEGIES, ids=IDS)
    def test_equals_fused_round(self, probs, name, make, K):
        """phase_spans=True runs the four phases one by one: the same
        composition as `make_round`, so bitwise the fused round (JAX holds
        its separately jitted phases to rtol 1e-12), one span per phase."""
        _, tp = probs
        x0, y0 = _x0()
        strategy = make(fed)
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   K, ETA)
        xa, ya = runner.run(x0, y0, T, state=_fresh_state(strategy, x0, y0, M))
        tm = Telemetry(phase_spans=True)
        runner.telemetry = tm
        xb, yb = runner.run(x0, y0, T, state=_fresh_state(strategy, x0, y0, M))
        _same(xa, xb)
        _same(ya, yb)
        for phase in ("broadcast", "exchange_corrections", "local_steps",
                      "aggregate"):
            spans = tm.series("span", phase)
            assert len(spans) == T and all(s["seconds"] >= 0 for s in spans)

    def test_needs_strategy_built_runner(self, probs):
        _, tp = probs
        rnd = core.make_round(tp.loss, fed.GradientTracking(), 2, ETA)
        runner = fed.FederatedRunner(rnd, tp.agent_data)
        runner.telemetry = Telemetry(phase_spans=True)
        with pytest.raises(ValueError, match="from_strategy"):
            runner._phase_round(runner.telemetry)


# ------------------------------------------------------------- probe units
class TestProbeFunctions:
    """Each probe function on the same numpy inputs as JAX's."""

    def test_anchor_corrections_satisfy_gt_invariant(self, probs):
        jp, tp = probs
        x0, y0 = _x0()
        cx, cy = probes.anchor_corrections(grad_xy(tp.loss), x0, y0, tp.agent_data)
        jcx, jcy = jobs.probes.anchor_corrections(jgrad_xy(jp.loss), *_jx0(),
                                                   jp.agent_data)
        assert _rel(cx.numpy(), jcx) <= PROBE_RTOL
        assert _rel(cy.numpy(), jcy) <= PROBE_RTOL
        assert probes.gt_residual(cx, cy) < 1e-10
        w = torch.full((M,), 1.0 / M, dtype=torch.float64)
        assert probes.gt_residual(cx, cy, w) < 1e-10

    def test_table_corrections_and_drift(self, probs):
        jp, tp = probs
        x0, y0 = _x0()
        g = torch.func.vmap(grad_xy(tp.loss), in_dims=(None, None, 0))(
            x0, y0, tp.agent_data)
        cx, cy = probes.corrections_from_table(g.gx, g.gy)
        jg = jax.vmap(jgrad_xy(jp.loss), in_axes=(None, None, 0))(*_jx0(),
                                                                  jp.agent_data)
        jcx, _ = jobs.probes.corrections_from_table(jg.gx, jg.gy)
        assert _rel(cx.numpy(), jcx) <= PROBE_RTOL
        assert probes.gt_residual(cx, cy) < 1e-10
        colsum = (g.gx.sum(0), g.gy.sum(0))
        assert probes.tracker_drift(g.gx, g.gy, *colsum) == 0.0
        # a perturbed running sum reads as drift, JAX's value
        got = probes.tracker_drift(g.gx, g.gy, colsum[0] + 1.0, colsum[1])
        want = jobs.probes.tracker_drift(jg.gx, jg.gy, jg.gx.sum(0) + 1.0,
                                         jg.gy.sum(0))
        assert got > 1.0 and abs(got - want) <= PROBE_RTOL * want

    def test_ef_residual_norms(self):
        assert probes.ef_residual_norms(None) == {}
        assert probes.ef_residual_norms({"rng": 0}) == {}
        ex = np.linspace(-2.0, 3.0, 12).reshape(3, 4)
        norms = probes.ef_residual_norms({"ex": torch.from_numpy(ex),
                                          "ey": torch.zeros(3)})
        want = jobs.probes.ef_residual_norms({"ex": jnp.asarray(ex),
                                              "ey": jnp.zeros(3)})
        assert norms == want  # both accumulate in numpy f64 on the host

    @pytest.mark.parametrize("name,make,K", STRATEGIES, ids=IDS)
    def test_priced_vs_measured_equals_jax(self, name, make, K):
        x0, y0 = _x0()
        pv = probes.priced_vs_measured(make(fed), x0, y0, K)
        assert pv == jobs.probes.priced_vs_measured(make(jfed), *_jx0(), K)
        assert pv["priced"] > 0

    def test_duality_gap_uses_oracle(self):
        x0, y0 = _x0()
        assert probes.duality_gap(lambda x, y: 7.5, x0, y0) == 7.5


# -------------------------------------------- probe parity across runtimes
class TestProbeParity:
    """The same pure probes over the state each runtime holds, on a shared
    seed: the GT residual is fp noise everywhere, the byte account is one
    dict, and gaps agree with JAX's runtimes'."""

    K = 5

    def _run_sync(self, tp):
        tm = _full_telemetry(tp)
        runner = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                                   tp.agent_data, self.K, ETA,
                                                   telemetry=tm)
        runner.run(*_x0(), T, schedule=_flaky(self.K))
        return tm

    def _jrun_sync(self, jp):
        tm = _jfull_telemetry(jp)
        runner = jfed.FederatedRunner.from_strategy(jp.loss, jfed.GradientTracking(),
                                                    jp.agent_data, self.K, ETA,
                                                    telemetry=tm)
        runner.run(*_jx0(), T, schedule=_flaky(self.K, jsim))
        return tm

    def _agree(self, tm, jtm, tag):
        res = tm.probe_series("gt_residual")
        assert len(res) == T and max(res) < RESIDUAL_MAX, tag
        assert tm.probe_series("priced_vs_measured") == \
            jtm.probe_series("priced_vs_measured"), tag
        gaps, jgaps = tm.probe_series("duality_gap"), jtm.probe_series("duality_gap")
        assert len(gaps) == T and _rel(gaps, jgaps) <= PROBE_RTOL, tag
        assert [e["round"] for e in tm.series("probe")] == \
            [e["round"] for e in jtm.series("probe")], tag

    def test_sync_elastic_probes(self, probs):
        jp, tp = probs
        self._agree(self._run_sync(tp), self._jrun_sync(jp), "sync elastic")

    def test_async_elastic_agrees_with_sync_and_jax(self, probs, fed_devices):
        jp, tp = probs
        sync_tm = self._run_sync(tp)
        tm = _full_telemetry(tp)
        runner = fed.AsyncFederatedRunner(tp.loss, fed.GradientTracking(),
                                          tp.agent_data, self.K, ETA, devices=CPU8,
                                          telemetry=tm)
        runner.run(*_x0(), T, schedule=_flaky(self.K))
        jtm = _jfull_telemetry(jp)
        jr = jfed.AsyncFederatedRunner(jp.loss, jfed.GradientTracking(),
                                       jp.agent_data, self.K, ETA,
                                       devices=fed_devices, telemetry=jtm)
        jr.run(*_jx0(), T, schedule=_flaky(self.K, jsim))
        self._agree(tm, jtm, "async elastic")
        assert tm.probe_series("priced_vs_measured") == \
            sync_tm.probe_series("priced_vs_measured")
        assert _rel(tm.probe_series("duality_gap"),
                    sync_tm.probe_series("duality_gap")) <= PROBE_RTOL

    def test_forced_sparse_agrees(self, probs):
        jp, tp = probs
        sync_tm = self._run_sync(tp)
        tm = _full_telemetry(tp)
        eng = sim.SparseElasticEngine(tp.loss, fed.GradientTracking(),
                                      sim.ArrayDataSource(tp.agent_data), self.K, ETA,
                                      dense_fallback_max_m=0, telemetry=tm)
        eng.run(*_x0(), _sparse(self.K))
        jtm = _jfull_telemetry(jp)
        jeng = jsim.SparseElasticEngine(jp.loss, jfed.GradientTracking(),
                                        jsim.ArrayDataSource(jp.agent_data), self.K,
                                        ETA, dense_fallback_max_m=0, telemetry=jtm)
        jeng.run(*_jx0(), _sparse(self.K, jsim))
        self._agree(tm, jtm, "forced sparse")
        drift = tm.probe_series("tracker_drift")
        assert len(drift) == T and max(drift) < RESIDUAL_MAX
        assert tm.probe_series("priced_vs_measured") == \
            sync_tm.probe_series("priced_vs_measured")

    def test_ef_residual_probe_sees_compressor_state(self, probs):
        jp, tp = probs
        tm = _full_telemetry(tp)
        runner = fed.FederatedRunner.from_strategy(
            tp.loss, fed.CompressedGT(compression_ratio=0.25, seed=0),
            tp.agent_data, self.K, ETA, telemetry=tm)
        runner.run(*_x0(), T)
        jtm = _jfull_telemetry(jp)
        jfed.FederatedRunner.from_strategy(
            jp.loss, jfed.CompressedGT(compression_ratio=0.25, seed=0),
            jp.agent_data, self.K, ETA, telemetry=jtm).run(*_jx0(), T)
        norms, jnorms = tm.probe_series("ef_residual"), jtm.probe_series("ef_residual")
        assert len(norms) == T
        # top-k residuals are non-zero after the first compression
        assert norms[-1]["ex"] > 0.0
        for got, want in zip(norms, jnorms):
            assert set(got) == set(want)
            assert _rel([got[k] for k in got], [want[k] for k in got]) <= PROBE_RTOL


# ------------------------------------------------------------- wire truth
class TestWireCounters:
    def test_scheduled_counter_equals_schedule_bytes_and_jax(self, probs):
        jp, tp = probs
        K = 5
        strategy, sched = fed.GradientTracking(), _flaky(K)
        tm = Telemetry()
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   K, ETA, telemetry=tm)
        x0, y0 = _x0()
        runner.run(x0, y0, T, schedule=sched)
        counters = tm.series("counter", "wire_bytes")
        totals = sim.schedule_bytes(strategy, x0, y0, K, sched)
        assert [e["value"] for e in counters] == [int(v) for v in totals[:T]]
        pa = sim.per_agent_bytes(strategy, x0, y0, K)
        assert all(e["per_agent"] == pa for e in counters)
        assert [e["value"] // pa for e in counters] == [e["n_active"] for e in counters]
        jtm = jobs.Telemetry()
        jfed.FederatedRunner.from_strategy(jp.loss, jfed.GradientTracking(),
                                           jp.agent_data, K, ETA, telemetry=jtm).run(
            *_jx0(), T, schedule=_flaky(K, jsim))
        assert counters == jtm.series("counter", "wire_bytes")

    def test_unscheduled_counter_is_measured_times_m(self, probs):
        jp, tp = probs
        K = 5
        strategy = fed.CompressedGT(compression_ratio=0.25, seed=0)
        tm = Telemetry(probes=("priced_vs_measured",))
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   K, ETA, telemetry=tm)
        x0, y0 = _x0()
        runner.run(x0, y0, T)
        meas = int(fed.measured_bytes_per_round(strategy, x0, y0, K))
        for e in tm.series("counter", "wire_bytes"):
            assert e["per_agent"] == meas and e["value"] == meas * M
        (pv,) = tm.probe_series("priced_vs_measured")
        assert pv["measured"] == meas
        jtm = jobs.Telemetry(probes=("priced_vs_measured",))
        jfed.FederatedRunner.from_strategy(
            jp.loss, jfed.CompressedGT(compression_ratio=0.25, seed=0),
            jp.agent_data, K, ETA, telemetry=jtm).run(*_jx0(), T)
        assert tm.series("counter") == jtm.series("counter")
        assert tm.series("probe") == jtm.series("probe")

    def test_wire_report_is_schedule_aware(self, probs):
        _, tp = probs
        K = 5
        strategy, sched = fed.GradientTracking(), _flaky(K)
        runner = fed.FederatedRunner.from_strategy(tp.loss, strategy, tp.agent_data,
                                                   K, ETA)
        x0, y0 = _x0()
        runner.run(x0, y0, T, schedule=sched)
        # remembered from run(..., schedule=...)
        rep = runner.wire_report(x0, y0, K)
        totals = sim.schedule_bytes(strategy, x0, y0, K, sched)
        assert rep["scheduled_per_agent_bytes"] == sim.per_agent_bytes(strategy, x0,
                                                                       y0, K)
        assert rep["scheduled_total_bytes"] == int(np.sum(totals))
        assert rep["scheduled_mean_bytes_per_round"] == pytest.approx(
            float(np.mean(totals)))
        assert runner.wire_report(x0, y0, K, schedule=sched) == rep

    def test_wire_report_static_full_has_no_scheduled_keys(self, probs):
        _, tp = probs
        K = 5
        runner = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                                   tp.agent_data, K, ETA)
        sched = sim.make_population("stable", M).schedule(SEED, T, K, device="cpu")
        x0, y0 = _x0()
        runner.run(x0, y0, T, schedule=sched)
        assert set(runner.wire_report(x0, y0, K)) == {"bytes_per_round",
                                                      "measured_bytes_per_round"}

    def test_async_wire_report_mirrors_sync_and_jax(self, probs, fed_devices):
        jp, tp = probs
        K = 5
        strategy, sched = fed.GradientTracking(), _flaky(K)
        tm = Telemetry()
        runner = fed.AsyncFederatedRunner(tp.loss, strategy, tp.agent_data, K, ETA,
                                          devices=CPU8, telemetry=tm)
        x0, y0 = _x0()
        runner.run(x0, y0, T, schedule=sched)
        rep = runner.wire_report(x0, y0, K)
        totals = sim.schedule_bytes(strategy, x0, y0, K, sched)
        assert rep["scheduled_total_bytes"] == int(np.sum(totals))
        jtm = jobs.Telemetry()
        jr = jfed.AsyncFederatedRunner(jp.loss, jfed.GradientTracking(), jp.agent_data,
                                       K, ETA, devices=fed_devices, telemetry=jtm)
        jsched = _flaky(K, jsim)
        jr.run(*_jx0(), T, schedule=jsched)
        assert rep == jr.wire_report(*_jx0(), K)
        assert tm.series("counter") == jtm.series("counter")


# ---------------------------------------------------------- sparse events
class TestSparseEvents:
    def test_realign_and_active_set_events_equal_jax(self, probs):
        jp, tp = probs
        K = 5
        tm = Telemetry()
        eng = sim.SparseElasticEngine(tp.loss, fed.CompressedGT(compression_ratio=0.25),
                                      sim.ArrayDataSource(tp.agent_data), K, ETA,
                                      dense_fallback_max_m=0, telemetry=tm)
        eng.run(*_x0(), _sparse(K))
        rounds = tm.series("span", "round")
        assert [e["runtime"] for e in rounds] == ["sparse"] * T
        # the fixed-size sampler keeps 4 agents active every round
        assert all(e["n_active"] == 4 for e in rounds)
        realigns = tm.series("event", "realign")
        assert len(realigns) == T - 1  # every round after the first
        assert all(0 <= e["n_continuing"] <= 4 for e in realigns)
        jtm = jobs.Telemetry()
        jsim.SparseElasticEngine(jp.loss, jfed.CompressedGT(compression_ratio=0.25),
                                 jsim.ArrayDataSource(jp.agent_data), K, ETA,
                                 dense_fallback_max_m=0, telemetry=jtm).run(
            *_jx0(), _sparse(K, jsim))
        strip = lambda evs: [{k: v for k, v in e.items() if k != "seconds"}
                             for e in evs]
        assert strip(tm.events) == strip(jtm.events)


# ---------------------------------------------------------- ledger + seeds
class TestRunLedger:
    def test_events_round_trip_jsonl(self, probs, tmp_path):
        _, tp = probs
        d = str(tmp_path / "ledger")
        ledger = RunLedger(d)
        tm = Telemetry(ledger=ledger, probes=("priced_vs_measured",))
        runner = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                                   tp.agent_data, 4, ETA, telemetry=tm)
        runner.run(*_x0(), T)
        ledger.close()
        back = RunLedger.events(d)
        assert back == json.loads(json.dumps(tm.events, default=_jsonable))
        assert sum(1 for e in back if e["name"] == "round") == T

    def test_manifest_equals_jax_key_for_key(self, tmp_path):
        K = 5
        d = str(tmp_path / "ledger")
        ledger = RunLedger(d)
        ledger.write_manifest(run_manifest(
            config={"rounds": T}, strategy=fed.QuantizedGT(bits=8, seed=0),
            seed=SEED, noise_seed=3, availability_seed=SEED, schedule=_flaky(K),
            extra={"note": "parity"}))
        man = RunLedger.manifest(d)
        want = jobs.run_manifest(
            config={"rounds": T}, strategy=jfed.QuantizedGT(bits=8, seed=0),
            seed=SEED, noise_seed=3, availability_seed=SEED,
            schedule=_flaky(K, jsim), extra={"note": "parity"})
        assert man == json.loads(json.dumps(want, default=jjsonable))
        assert man["seeds"]["noise_stream"] == fed.noise.NOISE_STREAM
        assert man["seeds"]["availability_stream"] == sim.AVAILABILITY_STREAM
        assert man["strategy"]["class"] == "QuantizedGT"

    def test_maybe_span_disabled_is_nullcontext(self):
        with maybe_span(None, "anything"):
            pass
        tm = Telemetry()
        with maybe_span(tm, "phase", dispatches=3):
            pass
        (ev,) = tm.series("span", "phase")
        assert ev["dispatches"] == 3 and ev["seconds"] >= 0.0

    def test_profile_rounds_write_a_chrome_trace(self, probs, tmp_path):
        _, tp = probs
        d = str(tmp_path / "prof")
        tm = Telemetry(profile_dir=d, profile_rounds=(1,))
        fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                          tp.agent_data, 2, ETA,
                                          telemetry=tm).run(*_x0(), 3)
        (ev,) = tm.series("event", "profile_trace")
        assert ev["round"] == 1 and ev["dir"] == d
        with open(ev["path"]) as f:
            trace = json.load(f)
        assert trace["traceEvents"]
        assert os.listdir(d) == [os.path.basename(ev["path"])]


# -------------------------------------------------- metric_series contract
class TestMetricSeries:
    def test_empty_history_raises_with_available_keys(self, probs):
        _, tp = probs
        runner = fed.FederatedRunner.from_strategy(tp.loss, fed.GradientTracking(),
                                                   tp.agent_data, 2, ETA)
        with pytest.raises(ValueError, match=r"available metric keys: \[\]"):
            runner.metric_series("gap")

    def test_unknown_key_still_names_available(self, probs):
        _, tp = probs
        runner = fed.FederatedRunner.from_strategy(
            tp.loss, fed.GradientTracking(), tp.agent_data, 2, ETA,
            metric_fn=lambda x, y: {"gap": torch.sum(x * x)})
        runner.run(*_x0(), 2)
        with pytest.raises(ValueError, match=r"\['gap'\]"):
            runner.metric_series("loss")
        assert runner.metric_series("gap").shape == (2,)


# ------------------------------------------------------------- peak memory
class TestPeakMemory:
    def test_benchmarks_shim_is_the_same_function(self):
        from repro_torch.benchmarks.common import peak_memory as shim

        assert shim is peak_memory

    def test_emits_counter_into_sink(self):
        tm = Telemetry()
        rec = peak_memory(lambda: np.zeros(100_000), telemetry=tm, label="alloc")
        assert rec["host_peak_bytes"] > 0
        (ev,) = tm.series("counter", "peak_memory")
        assert ev["value"] == rec["host_peak_bytes"]
        assert ev["label"] == "alloc"
        assert ev["live_buffer_bytes"] == rec["live_buffer_bytes"]
        assert ev["device_peak_bytes"] == rec["device_peak_bytes"]
