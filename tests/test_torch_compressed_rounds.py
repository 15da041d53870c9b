"""Communication-efficient rounds of the port against JAX's on the
Theorem 1 problem (d=20, n=100, m=8, K=10, eta=2e-4, x0 = y0 = 0): per
round, the port's gap follows JAX's stored trajectory
(`fixtures/compressed_rounds.npz`) within GAP_RTOL on rounds with gap
> 1e-14, for CompressedGT (top-k with and without error feedback, rand-k)
and QuantizedGT (8-bit; 4-bit top-k 0.25 over the packed wire).  The CPU
runs the first 300 of the stored 500 rounds (the floors are reached by
round ~250); `chip_smoke.py` runs all 500 through the kernels.

The claims on the d=6 quadratic are `test_torch_*_claims.py`.
"""
import pytest

from repro_torch.fixtures import THM1_RUNS, compressed_run_gaps, load_compressed_rounds
from test_torch_parity import assert_gaps_follow_jax, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

ROUNDS = 300


@pytest.mark.parametrize("run", THM1_RUNS)
def test_gaps_follow_jax_on_the_theorem1_problem(run):
    got = compressed_run_gaps(run, "thm1", "cpu", rounds=ROUNDS)
    want = load_compressed_rounds()[f"thm1_{run}_gap"]
    assert got.shape == (ROUNDS + 1,)
    assert_gaps_follow_jax(got, want, run)
