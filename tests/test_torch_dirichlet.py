"""Dirichlet-heterogeneous data in the port (`data/synthetic.py`,
`problems/quadratic.py` `make_dirichlet_quadratic_problem`,
`benchmarks/generalization.py`'s stochastic table).

The port draws from a `torch.Generator`: the same distribution as the JAX
package, not the same numbers, so its draws are held to the distribution
properties of tests/test_properties.py:476-520.  On JAX's own Dirichlet
problems (the fixture, drawn from PRNGKey(7)) the port's stochastic
generalization rows equal JAX's table: rounds to eps exactly, the final
distance and the generalization gap within the stated tolerance."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import heterogeneity_index as jheterogeneity_index
from repro_torch import data
from repro_torch.benchmarks import generalization
from repro_torch.fixtures import (
    DIRICHLET,
    GEN_ROWS,
    dirichlet_key,
    dirichlet_problem,
    load_stochastic_rounds,
)
from repro_torch.problems import make_dirichlet_quadratic_problem

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

SETTINGS = dict(max_examples=25, deadline=None)
#: the final distance and the generalization gap of the port's runs
#: against JAX's, relative: the iterates agree to f64 round-off in the
#: noiseless runs and to the normals' few ulp under noise (measured below
#: 1e-10)
ROW_RTOL = 1e-8


class TestDirichletPartitions:
    @given(seed=st.integers(0, 2 ** 16), m=st.integers(2, 12), c=st.integers(2, 8),
           alpha=st.floats(0.05, 50.0, allow_nan=False))
    @settings(**SETTINGS)
    def test_weights_are_a_distribution(self, seed, m, c, alpha):
        w = data.dirichlet_partition_weights(torch.Generator().manual_seed(seed),
                                             m, c, alpha)
        assert w.shape == (m, c) and w.dtype == torch.float64
        assert (w >= 0).all()
        np.testing.assert_allclose(w.sum(dim=1).numpy(), np.ones(m), rtol=1e-9)

    @given(seed=st.integers(0, 2 ** 16))
    @settings(**SETTINGS)
    def test_heterogeneity_monotone_in_alpha(self, seed):
        m, c = 12, 4
        het_lo = data.heterogeneity_index(data.dirichlet_partition_weights(
            torch.Generator().manual_seed(seed), m, c, 0.05))
        het_hi = data.heterogeneity_index(data.dirichlet_partition_weights(
            torch.Generator().manual_seed(seed), m, c, 50.0))
        assert float(het_lo) > float(het_hi)

    def test_index_extremes(self):
        assert float(data.heterogeneity_index(torch.full((6, 4), 0.25))) == 0.0
        np.testing.assert_allclose(
            float(data.heterogeneity_index(torch.eye(4, dtype=torch.float64))),
            0.75, rtol=1e-12)

    def test_index_equals_jax_on_the_same_weights(self):
        w = np.random.default_rng(0).dirichlet(np.full(4, 0.3), size=7)
        assert float(data.heterogeneity_index(torch.tensor(w))) == float(
            jheterogeneity_index(jnp.asarray(w)))

    def test_bad_alpha_and_token_batches(self):
        with pytest.raises(ValueError, match="> 0"):
            data.dirichlet_partition_weights(torch.Generator(), 3, 2, 0.0)
        # the token batches are ported (Queue 1 item 12's training path):
        # agent-stacked, JAX's draws (tests/test_torch_train.py)
        from repro_torch import prng

        tb = data.federated_token_batches(prng.PRNGKey(0), 2, 2, 8, 16, device="cpu")
        assert tb["tokens"].shape == tb["labels"].shape == (2, 2, 8)
        parts = data.partition_among_agents({"t": torch.arange(12).reshape(6, 2)}, 3)
        assert parts["t"].shape == (3, 2, 2)


def test_dirichlet_problem_shapes_and_split():
    prob, test, w = make_dirichlet_quadratic_problem(
        torch.Generator().manual_seed(1), dim=5, num_samples=40, num_agents=4,
        alpha=0.5, num_components=3, test_samples=20, device="cpu")
    assert prob.agent_data["G"].shape == (4, 5, 5) and test["Ab"].shape == (4, 5)
    assert w.shape == (4, 3)
    # per-sample means: G_i is PSD with trace ~ d (rows A ~ N(0, I))
    G = prob.agent_data["G"]
    assert torch.allclose(G, G.transpose(1, 2))
    assert (torch.linalg.eigvalsh(G) > -1e-12).all()
    assert 0.3 * 5 < float(G.diagonal(dim1=1, dim2=2).sum(-1).mean()) < 3 * 5
    none = make_dirichlet_quadratic_problem(torch.Generator().manual_seed(1), dim=5,
                                            num_samples=10, num_agents=2,
                                            device="cpu")[1]
    assert none is None


def test_fixture_problems_are_jaxs():
    """The committed Dirichlet problems are what the JAX builder draws."""
    from repro.problems import make_dirichlet_quadratic_problem as jmake

    dim, n, m, comps, alphas = DIRICHLET
    fix = load_stochastic_rounds()
    for alpha in alphas:
        jp, jt, jw = jmake(jax.random.PRNGKey(7), dim=dim, num_samples=n,
                           num_agents=m, alpha=alpha, num_components=comps,
                           test_samples=n)
        pre = dirichlet_key(alpha)
        np.testing.assert_allclose(fix[f"{pre}_G"], np.asarray(jp.agent_data["G"]),
                                   rtol=1e-12)
        np.testing.assert_allclose(fix[f"{pre}_test_Ab"], np.asarray(jt["Ab"]),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(fix[f"{pre}_weights"], np.asarray(jw), rtol=1e-12)
        prob, test, w = dirichlet_problem(alpha, "cpu")
        assert float(data.heterogeneity_index(w)) == pytest.approx(
            float(jheterogeneity_index(jw)), rel=1e-12)


@pytest.fixture(scope="module")
def rows(one_torch_thread):  # noqa: F811
    return generalization.stochastic_rows(device="cpu")


@pytest.mark.parametrize("alpha", DIRICHLET[4])
def test_stochastic_rows_equal_jaxs_table(rows, alpha):
    want = load_stochastic_rounds()[f"{dirichlet_key(alpha)}_rows"]
    got = [r for r in rows if r["_alpha"] == alpha]
    assert [(r["strategy"], r["noise"]) for r in got] == list(GEN_ROWS)
    for r, (r_eps, final, gap) in zip(got, want):
        tag = f"{r['strategy']}/{r['noise']}"
        assert r["_r_eps"] == r_eps or (math.isinf(r["_r_eps"]) and math.isinf(r_eps)), tag
        assert r["_final"] == pytest.approx(final, rel=ROW_RTOL), tag
        assert r["_gap"] == pytest.approx(gap, rel=ROW_RTOL), tag


def test_generalization_check_gate(rows, capsys, monkeypatch):
    """The port's `generalization --check` passes (on the rows above)."""
    monkeypatch.setattr(generalization, "stochastic_rows", lambda device=None: rows)
    assert generalization.main(["--check", "--device", "cpu"]) == 0
    assert "[ok] local_sgda/none alpha=0.1 stalls" in capsys.readouterr().out

