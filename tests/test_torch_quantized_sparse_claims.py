"""The JAX package's claim that quantized plus sparsified corrections
still converge (`tests/test_quantization.py:195`, 4 bits at ratio 0.5,
top-k and rand-k: gap < 1e-1 from > 1e2), held by the port on the same
d=6, m=8 quadratic (K=4, eta=2e-4, 1500 rounds from 0), with each run's
per-round gap following JAX's stored trajectory within GAP_RTOL."""
import pytest

from repro_torch.fixtures import compressed_run_gaps, load_compressed_rounds
from test_torch_parity import assert_gaps_follow_jax, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]


@pytest.mark.parametrize("mode", ["topk", "randk"])
def test_quantized_plus_sparsified_converges(mode):
    run = f"qgt4_half_{mode}"
    g = compressed_run_gaps(run, "quad6", "cpu")
    assert_gaps_follow_jax(g, load_compressed_rounds()[f"quad6_{run}_gap"], run)
    assert g[0] > 1e2 and g[-1] < 1e-1
