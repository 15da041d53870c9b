"""Section 4's stochastic separation (tests/test_paper_claims.py
`TestStochasticSeparation`) on the port, with the claim's own assertions,
against JAX's gaps from the committed fixture
(`fixtures/stochastic_rounds.npz`: the same problem, drawn by JAX from
PRNGKey(0), and JAX's four trajectories): at one shared constant stepsize
Local SGDA stalls at a drift floor that no noise reduction removes, while
SAGDA drives its noiseless component linearly to machine precision and
under noise has only a variance floor, which scales with sigma^2."""
import numpy as np
import pytest

from repro_torch.fixtures import SEC4, load_stochastic_rounds, sec4_run_gaps

from test_torch_parity import assert_gaps_follow_jax, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def gaps(one_torch_thread):  # noqa: F811
    return {run: sec4_run_gaps(run, "cpu") for run in ("gt", "ls", "hi", "lo")}


@pytest.mark.parametrize("run", ["gt", "ls", "hi", "lo"])
def test_gaps_follow_jax(gaps, run):
    """Per-round gaps within 1e-5 of JAX's above 1e-14 (measured: 3.4e-7
    noiseless, where the gap reaches 1e-24; 2.2e-9 under noise)."""
    want = load_stochastic_rounds()[f"sec4_{run}_gap"]
    assert len(gaps[run]) == SEC4[5] + 1
    assert_gaps_follow_jax(gaps[run], want, f"sec4 {run}")


def test_drift_floor_vs_linear_noiseless_component(gaps):
    g_gt, g_ls, g_hi, g_lo = (gaps[r] for r in ("gt", "ls", "hi", "lo"))
    assert g_gt[-1] < 1e-20, g_gt[-1]
    seg = g_gt[(g_gt > 1e-14) & (g_gt < 1e2)]
    rates = np.diff(np.log(seg))
    assert np.all(rates < 0)
    assert np.std(rates) < 0.25 * abs(np.mean(rates))
    floor_ls = float(g_ls[-100:].mean())
    floor_hi = float(g_hi[-100:].mean())
    floor_lo = float(g_lo[-100:].mean())
    assert floor_ls > 1e-2, floor_ls
    assert floor_hi < 1e-4 * floor_ls
    assert 30.0 < floor_hi / floor_lo < 300.0
    assert floor_lo > float(g_gt[-1])
