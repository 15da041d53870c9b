"""The convergence claims of the JAX package for dense QuantizedGT
(`tests/test_quantization.py:138-200`), held by the port on the same
d=6, m=8 quadratic (K=4, eta=2e-4, 1500 rounds from 0), with every run's
per-round gap following JAX's stored trajectory within GAP_RTOL:

  * 8-bit quantization (unbiased, with error feedback) reaches a tight
    floor (< 1e-4);
  * error feedback tightens the 4-bit top-k 0.25 floor more than tenfold
    (the feedback run moves over the packed wire, which is bitwise the
    dense path).
"""
import pytest

from repro_torch.fixtures import compressed_run_gaps, load_compressed_rounds
from test_torch_parity import assert_gaps_follow_jax, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

RUNS = ("qgt8", "qgt4_topk_wire", "qgt4_topk_noef")


@pytest.fixture(scope="module")
def gaps():
    cache = {}

    def get(run):
        if run not in cache:
            cache[run] = compressed_run_gaps(run, "quad6", "cpu")
        return cache[run]

    return get


@pytest.mark.parametrize("run", RUNS)
def test_gaps_follow_jax(gaps, run):
    assert_gaps_follow_jax(gaps(run), load_compressed_rounds()[f"quad6_{run}_gap"], run)


def test_8bit_dense_converges_to_tight_floor(gaps):
    g = gaps("qgt8")
    assert g[0] > 1e2 and g[-1] < 1e-4


def test_error_feedback_tightens_the_floor(gaps):
    assert gaps("qgt4_topk_wire")[-1] < gaps("qgt4_topk_noef")[-1] / 10.0
