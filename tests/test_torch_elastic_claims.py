"""The elastic benchmark's flaky headline in the port, at a reduced T, on
JAX's data and schedules (the `elastic_rounds` fixture, CPU):

  * FedGDA-GT with tracker rebasing reaches gap 1e-6 at JAX's round (138)
    and keeps falling; the naive no-rebase server never reaches it and
    ends above 1e+2; Local SGDA never reaches it;
  * each row's per-round gaps within GAP_RTOL of JAX's on rounds above
    GAP_FLOOR (the compressed and quantized rows too);
  * the schedules drawn by the port equal the fixture's, and the table's
    bytes (mean per round, total to eps) are JAX's;
  * the benchmark's `--check` gate holds (at a reduced round count).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import sim
from repro_torch.fed import resolve_strategy
from repro_torch.benchmarks import elastic as bench
from repro_torch.fixtures import (
    ELASTIC,
    ELASTIC_ROWS,
    ELASTIC_SCENARIOS,
    ELASTIC_TABLE_COLS,
    elastic_run_gaps,
    elastic_table_keys,
    load_elastic_rounds,
)

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

_, _, M, K, _, T, SEED = ELASTIC
ROUNDS = 300
#: the fixture gates' tolerance: 1e-5 relative above 1e-14 (below, one ulp
#: of |x*| = 211 is a relative gap difference of ~2 ulp / sqrt(gap))
GAP_RTOL, GAP_FLOOR = 1e-5, 1e-14


@pytest.fixture(scope="module")
def fix():
    return load_elastic_rounds()


@pytest.fixture(scope="module")
def flaky(fix):
    return sim.RoundSchedule(fix["flaky_active"], fix["flaky_budgets"], K)


def _tracks(got, want):
    sel = want > GAP_FLOOR
    np.testing.assert_allclose(got[sel], want[sel], rtol=GAP_RTOL, atol=0)


@pytest.mark.parametrize("scenario", ELASTIC_SCENARIOS)
def test_port_draws_the_fixture_schedules(fix, scenario):
    s = sim.make_population(scenario, M).schedule(SEED, T, K, device="cpu")
    np.testing.assert_array_equal(s.active, fix[f"{scenario}_active"])
    np.testing.assert_array_equal(s.budgets, fix[f"{scenario}_budgets"])


def test_flaky_headline(fix, flaky):
    gaps = {row: elastic_run_gaps(row, flaky, "cpu", ROUNDS)
            for row in ("fedgda_gt", "fedgda_gt_norebase", "local_sgda")}
    for row, g in gaps.items():
        _tracks(g, fix[f"flaky_{row}_gap"][:ROUNDS])
    gt = gaps["fedgda_gt"]
    assert int(np.nonzero(gt <= 1e-6)[0][0]) == 138
    assert gt[-1] < 1e-16
    naive = gaps["fedgda_gt_norebase"]
    assert (naive > 1e-6).all() and naive[-1] > 1e2
    assert (gaps["local_sgda"] > 1e-6).all()


@pytest.mark.parametrize("row", ["compressed_gt_25", "quantized_gt_8bit"])
def test_compressed_rows_track_jax(fix, flaky, row):
    got = elastic_run_gaps(row, flaky, "cpu", 150)
    _tracks(got, fix[f"flaky_{row}_gap"][:150])


def test_table_bytes_and_participation_equal_jax(fix):
    table = dict(zip(fix["table_keys"], fix["table"]))
    assert list(table) == elastic_table_keys()
    cols = {c: i for i, c in enumerate(ELASTIC_TABLE_COLS)}
    x0 = torch.zeros(bench.DIM, dtype=torch.float64)
    for key, want in table.items():
        scenario, row = key.split("/")
        s = sim.RoundSchedule(fix[f"{scenario}_active"], fix[f"{scenario}_budgets"], K)
        name, kw, _ = ELASTIC_ROWS[row]
        per_round = sim.schedule_bytes(resolve_strategy(name, **kw), x0, x0, K, s)
        r_eps = want[cols["rounds_to_eps"]]
        total = math.inf if math.isinf(r_eps) else sum(per_round[: int(r_eps) + 1])
        assert s.participation_rate() == want[cols["participation"]]
        assert int(np.mean(per_round)) == want[cols["bytes_per_round"]]
        assert total == want[cols["total_bytes_to_eps"]]


def test_benchmark_check_gate_holds(monkeypatch, capsys):
    """`python -m repro_torch.benchmarks.elastic --check --device cpu`, at
    150 rounds (the stable rows reach eps by round 142); `--population
    mega` and `--check-pods` at a registry of 2e4 (the 1e6 run is the
    card's and the driver's own)."""
    monkeypatch.setattr(bench, "CHECK_ROUNDS", 150)
    assert bench.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[ok]") == 4 and "(+0.00%)" in out
    monkeypatch.setattr(bench, "MEGA_AGENTS", 20_000)
    assert bench.main(["--population", "mega", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mega_1e6,20000,256,1024,4," in out and "ref_1e4,200,256,3,4," in out
    assert bench.main(["--check-pods", "--device", "cpu"]) == 0
    assert "[ok] elastic_pods" in capsys.readouterr().out
