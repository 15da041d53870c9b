"""Communication accounting in the port (`fed/comm.py` `comm_table`,
`knob_signature`; `benchmarks/comm_efficiency.py --check`) against the JAX
package: the cases of tests/test_comm_accounting.py's comm table, and the
table of the comm-efficiency driver's strategies equal to JAX's row for
row (names, priced and measured bytes, totals)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.comm_efficiency as jce
from repro import fed as jfed
from repro_torch import fed
from repro_torch.benchmarks import comm_efficiency
from repro_torch.fed import comm

from test_torch_parity import one_torch_thread  # noqa: F401

# the small draws and rounds are bound by per-op host overhead; intra-op
# threads only contend with the other test workers
pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

P, Q, K = 1000, 10, 16


@pytest.fixture(scope="module")
def xy():
    return torch.zeros(P, dtype=torch.float64), torch.zeros(Q, dtype=torch.float64)


def _z(x, y):
    return x.numel() * x.element_size() + y.numel() * y.element_size()


def test_string_and_strategy_keys(xy):
    x, y = xy
    z = _z(x, y)
    table = fed.comm_table(x, y, K, {"fedgda_gt": 50.0, "local_sgda": math.inf,
                                     fed.CompressedGT(compression_ratio=0.1): 80.0})
    assert table["fedgda_gt"]["total_bytes"] == 50.0 * 4 * z
    assert table["local_sgda"]["total_bytes"] == math.inf
    cgt = table["compressed_gt"]
    assert cgt["bytes_per_round"] < 4 * z
    assert cgt["total_bytes"] == cgt["bytes_per_round"] * 80.0


def test_measured_bytes_reported_per_row(xy):
    x, y = xy
    table = fed.comm_table(x, y, K, {
        "fedgda_gt": 10.0, fed.QuantizedGT(bits=8, wire_transport=True): 10.0})
    gt = table["fedgda_gt"]
    assert gt["measured_bytes_per_round"] == gt["bytes_per_round"]
    qt = table["quantized_gt"]
    overhead = qt["measured_bytes_per_round"] - qt["bytes_per_round"]
    assert 0 <= overhead <= fed.wire_header_overhead(x, y)


def test_collision_keys_are_order_independent(xy):
    x, y = xy
    a = fed.CompressedGT(compression_ratio=0.1)
    b = fed.CompressedGT(compression_ratio=0.25)
    t_ab = fed.comm_table(x, y, K, {a: 10.0, b: 20.0, "fedgda_gt": 5.0})
    t_ba = fed.comm_table(x, y, K, {"fedgda_gt": 5.0, b: 20.0, a: 10.0})
    assert set(t_ab) == set(t_ba)
    key_a = next(k for k in t_ab if "0.1" in k)
    assert "compression_ratio=0.1" in key_a
    for k in t_ab:
        assert t_ab[k]["bytes_per_round"] == t_ba[k]["bytes_per_round"]
        assert t_ab[k]["rounds_to_eps"] == t_ba[k]["rounds_to_eps"]
    assert "fedgda_gt" in t_ab


def test_legacy_string_keys_survive_collisions(xy):
    x, y = xy
    t = fed.comm_table(x, y, K, {"quantized_gt": 10.0, fed.QuantizedGT(bits=4): 20.0})
    assert "quantized_gt" in t and t["quantized_gt"]["rounds_to_eps"] == 10.0
    inst = next(k for k in t if k.startswith("quantized_gt["))
    assert "bits=4" in inst and t[inst]["rounds_to_eps"] == 20.0
    t2 = fed.comm_table(x, y, K, {"quantized_gt": 10.0, fed.QuantizedGT(bits=8): 20.0})
    assert set(t2) == {"quantized_gt", "quantized_gt+"}


def test_partial_participation_scales_expected_payload(xy):
    x, y = xy
    z = _z(x, y)
    assert fed.PartialParticipation(participation=1.0).bytes_per_round(x, y, K) == 4 * z
    assert fed.PartialParticipation(participation=0.5).bytes_per_round(x, y, K) == 2 * z
    assert fed.PartialParticipation(participation=0.25).bytes_per_round(x, y, K) == z


@pytest.mark.parametrize("strategies", [
    lambda F, N: {"gda": 3.0, "local_sgda": math.inf, F.GradientTracking(): 7.0,
                  F.PartialParticipation(participation=0.5, seed=0): 12.0,
                  F.SAGDA(noise=N.GaussianNoise(0.1)): 9.0,
                  F.LocalSGDAPlus(momentum=0.9): math.inf},
    lambda F, N: {F.CompressedGT(compression_ratio=0.1, wire_transport=True): 20.0,
                  F.QuantizedGT(bits=8, wire_transport=True): 30.0,
                  F.QuantizedGT(bits=4, ratio=0.1, wire_transport=True): 40.0,
                  F.QuantizedGT(bits=4, ratio=0.1): 41.0},
], ids=["dense_and_stochastic", "compressed_collisions"])
def test_comm_table_equals_jax(strategies):
    """The same strategies in both packages: the same row keys (the knob
    signatures of colliding names included) and the same numbers."""
    from repro.fed import noise as jnoise

    want = jfed.comm_table(jnp.zeros(50), jnp.zeros(7), 20, strategies(jfed, jnoise))
    x0 = torch.zeros(50, dtype=torch.float64)
    got = fed.comm_table(x0, torch.zeros(7, dtype=torch.float64), 20,
                         strategies(fed, fed))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_knob_signature_equals_jax():
    for make in (lambda F: F.QuantizedGT(bits=4, ratio=0.1, wire_transport=True),
                 lambda F: F.PartialParticipation(participation=0.3, seed=2),
                 lambda F: F.LocalSGDAPlus(momentum=0.9)):
        assert comm.knob_signature(make(fed)) == jfed.comm.knob_signature(make(jfed))
    assert comm.knob_signature(fed.QuantizedGT(bits=4), {"bits", "ratio"}) == \
        "bits=4,ratio=1.0"


def test_driver_runs_equal_the_references():
    """The port's driver prices the reference driver's rows (partial_gt_50
    included) at the reference's bytes, and its --check passes."""
    x0 = torch.zeros(comm_efficiency.DIM, dtype=torch.float64)
    jx = jnp.zeros(jce.DIM)
    jruns, truns = jce._runs(), comm_efficiency._runs()
    assert list(jruns) == list(truns)
    for name in jruns:
        js, jk = jruns[name]
        ts, tk = truns[name]
        assert jk == tk
        assert ts.bytes_per_round(x0, x0, jce.K) == js.bytes_per_round(jx, jx, jce.K)
        assert fed.measured_bytes_per_round(ts, x0, x0, jce.K, include_headers=False) \
            == jfed.measured_bytes_per_round(js, jx, jx, jce.K, include_headers=False)
    assert comm_efficiency.main(["--check", "--device", "cpu"]) == 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        comm_efficiency.main(["--overlap", "--device", "cpu"])


def test_driver_table_rows_and_bytes(capsys):
    """The table at 30 of its 3000 rounds (no row reaches 1e-8 so soon):
    the reference's rows in its order, bytes as priced and measured."""
    rows = comm_efficiency.run(device="cpu", rounds=30)
    names = [r["algorithm"] for r in rows]
    assert names == list(comm_efficiency._runs())
    by = {r["algorithm"]: r for r in rows}
    assert by["fedgda_gt"]["bytes_per_round"] == 2 * by["local_sgda"]["bytes_per_round"]
    assert by["partial_gt_50"]["bytes_per_round"] == by["local_sgda"]["bytes_per_round"]
    for r in rows:
        assert r["measured_bytes_per_round"] >= r["bytes_per_round"]
        if math.isfinite(r["rounds_to_1e-08"]):
            assert r["total_bytes"] == r["bytes_per_round"] * r["rounds_to_1e-08"]
    assert "communication to reach gap<=1e-08" in capsys.readouterr().out
