"""The convergence claims of the JAX package for CompressedGT
(`tests/test_strategy_convergence.py:100-126`), held by the port on the
same d=6, m=8 quadratic (K=4, eta=2e-4, 1500 rounds from 0), with every
run's per-round gap following JAX's stored trajectory within GAP_RTOL:

  * top-k and rand-k at ratio 0.5 converge to a small floor (< 1e-1);
  * error feedback tightens the top-k floor more than tenfold.

The QuantizedGT claims are `test_torch_quantized*_claims.py`.
"""
import pytest

from repro_torch.fixtures import compressed_run_gaps, load_compressed_rounds
from test_torch_parity import assert_gaps_follow_jax, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

RUNS = ("cgt_topk_ef", "cgt_topk_noef", "cgt_randk")


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


@pytest.mark.parametrize("run", ["cgt_topk_ef", "cgt_randk"], ids=["topk", "randk"])
def test_compressed_gt_converges(gaps, run):
    g = gaps(run)
    assert g[0] > 1e2 and g[-1] < 1e-1


def test_error_feedback_tightens_the_floor(gaps):
    assert gaps("cgt_topk_ef")[-1] < gaps("cgt_topk_noef")[-1] / 10.0
