"""Section-4 generalization machinery on the port: the eight tests of
tests/test_generalization.py (Rademacher estimation, Theorem-2 bound
assembly, Lemma-3 VC bound, the bound holding empirically) on the same
data, drawn by JAX and handed over as numpy, plus:

  * `empirical_rademacher` within 1e-15 of JAX's on the same key, its
    signs `prng.rademacher` under `prng.split` keys, bit for bit;
  * `generalization_gap` on a train/test split of JAX's robust-regression
    data against JAX's, 1e-12 relative.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.generalization import generalization_gap as jax_gap
from repro_torch import prng
from repro_torch.convert import tree_from_numpy
from repro_torch.core import (
    empirical_rademacher,
    generalization_gap,
    lemma3_vc_bound,
    theorem2_bound,
)
from repro_torch.core.generalization import l2_cover_size
from repro_torch.fixtures import load_robust_agnostic
from repro_torch.problems.robust_regression import _loss

pytestmark = pytest.mark.torch


def _threshold_loss_matrix(key, m, n, num_candidates, y_shift=0.0):
    """tests/test_generalization.py's finite class: 1-D threshold
    classifiers on agent-shifted Gaussians (0/1 losses).  The samples are
    JAX's draws (the port has no normal draw yet); the matrix is torch."""
    kd, _ = jax.random.split(key)
    shifts = 0.3 * jnp.arange(m, dtype=jnp.float64)
    xi = torch.tensor(np.asarray(
        jax.random.normal(kd, (m, n), jnp.float64) + shifts[:, None]))
    labels = (xi + y_shift > 0.0).to(torch.float64)
    thresholds = torch.linspace(-2.0, 2.0, num_candidates, dtype=torch.float64)

    def matrix(idx):
        th = thresholds[idx]  # [C]
        pred = (xi[None] > th[:, None, None]).to(torch.float64)
        return torch.abs(pred - labels[None])  # 0/1 loss, [C, m, n]

    return matrix, xi, labels, thresholds


def _key(seed):
    return prng.PRNGKey(seed)


class TestRademacher:
    def test_nonnegative_and_bounded(self):
        m, n, C = 4, 50, 32
        mat, *_ = _threshold_loss_matrix(jax.random.PRNGKey(0), m, n, C)
        r = float(empirical_rademacher(mat, C, m, n, _key(1), num_mc=128))
        assert 0.0 <= r <= 1.0

    def test_decreases_with_sample_size(self):
        m, C = 4, 64
        rs = {}
        for n in (25, 400):
            mat, *_ = _threshold_loss_matrix(jax.random.PRNGKey(2), m, n, C)
            rs[n] = float(empirical_rademacher(mat, C, m, n, _key(3), num_mc=256))
        assert rs[400] < rs[25]
        ratio = rs[25] / max(rs[400], 1e-9)
        assert 2.0 < ratio < 8.0

    def test_richer_class_bigger_complexity(self):
        m, n = 4, 50
        mat_small, *_ = _threshold_loss_matrix(jax.random.PRNGKey(4), m, n, 2)
        mat_big, *_ = _threshold_loss_matrix(jax.random.PRNGKey(4), m, n, 128)
        r_small = float(empirical_rademacher(mat_small, 2, m, n, _key(5), 256))
        r_big = float(empirical_rademacher(mat_big, 128, m, n, _key(5), 256))
        assert r_big >= r_small - 1e-6

    @pytest.mark.parametrize("seed,m,n,C,num_mc", [(1, 4, 50, 32, 128),
                                                   (7, 4, 100, 64, 256),
                                                   (9, 3, 37, 5, 17)])
    def test_equals_jax_on_the_same_key(self, seed, m, n, C, num_mc):
        """The same loss matrix (as numpy) into both; the estimates agree
        to 1e-15 and each key's signs are JAX's bit for bit."""
        L = np.random.default_rng(seed).random((C, m, n))
        want = jcore.empirical_rademacher(lambda idx: jnp.asarray(L)[idx], C, m, n,
                                          jax.random.PRNGKey(seed), num_mc)
        got = empirical_rademacher(lambda idx: torch.tensor(L)[idx], C, m, n,
                                   _key(seed), num_mc)
        assert abs(float(got) - float(want)) <= 1e-15
        jkeys = jax.random.split(jax.random.PRNGKey(seed), num_mc)
        tkeys = prng.split(_key(seed), num_mc)
        for jk, tk in zip(jkeys, tkeys):
            js = np.asarray(jax.random.rademacher(jk, (m * n,), dtype=jnp.float64))
            ts = prng.rademacher(tk, (m * n,), torch.float64, "cpu").numpy()
            assert np.array_equal(js.view(np.uint64), ts.view(np.uint64))


class TestBoundAssembly:
    def test_theorem2_terms(self):
        b = theorem2_bound(
            empirical_risk=0.5, rademacher=0.1, M_i=[1.0] * 8, n=100,
            cover_size=1000, delta=0.05, L_y=1.0, eps=0.01,
        )
        conc = math.sqrt(8 / (2 * 64 * 100) * math.log(1000 / 0.05))
        np.testing.assert_allclose(b, 0.5 + 0.2 + conc + 0.02, rtol=1e-12)

    def test_bound_decreases_in_n_and_increases_in_cover(self):
        kw = dict(
            empirical_risk=0.0, rademacher=0.0, M_i=[1.0] * 4,
            delta=0.1, L_y=1.0, eps=0.0,
        )
        assert theorem2_bound(n=400, cover_size=100, **kw) < theorem2_bound(
            n=100, cover_size=100, **kw
        )
        assert theorem2_bound(n=100, cover_size=10_000, **kw) > theorem2_bound(
            n=100, cover_size=100, **kw
        )

    def test_lemma3_dominates_mc_estimate(self):
        m, n, C = 4, 100, 64
        mat, *_ = _threshold_loss_matrix(jax.random.PRNGKey(6), m, n, C)
        r = float(empirical_rademacher(mat, C, m, n, _key(7), 256))
        ub = lemma3_vc_bound([1.0] * m, n, vc_dim=1)
        assert r <= ub, (r, ub)

    def test_recovers_agnostic_fl_special_case(self):
        m, n, M = 5, 80, 2.0
        yw = np.array([0.4, 0.3, 0.1, 0.1, 0.1])
        M_i = [m * w * M for w in yw]
        b = theorem2_bound(
            empirical_risk=0.0, rademacher=0.0, M_i=M_i, n=n,
            cover_size=100, delta=0.05, L_y=0.0, eps=0.0,
        )
        want = math.sqrt(
            M * M * float(np.sum(yw**2)) / (2 * n) * math.log(100 / 0.05)
        )
        np.testing.assert_allclose(b, want, rtol=1e-12)

    def test_cover_size_formula(self):
        assert l2_cover_size(1.0, 0.5, 2) == math.ceil(5.0**2)
        assert l2_cover_size(1.0, 0.1, 3) >= l2_cover_size(1.0, 0.5, 3)

    def test_the_bounds_equal_the_references(self):
        kw = dict(empirical_risk=0.3, rademacher=0.05, M_i=[1.0, 2.0, 0.5],
                  n=60, cover_size=77, delta=0.1, L_y=2.0, eps=0.01)
        assert theorem2_bound(**kw) == jcore.theorem2_bound(**kw)
        assert lemma3_vc_bound([1.0, 2.0], 50, 3) == jcore.lemma3_vc_bound(
            [1.0, 2.0], 50, 3)


class TestBoundHoldsEmpirically:
    def test_population_risk_below_bound(self):
        m, n, C = 4, 200, 32
        mat, *_ = _threshold_loss_matrix(jax.random.PRNGKey(8), m, n, C)
        emp = mat(torch.arange(C)).mean(dim=(1, 2)).numpy()
        rad = float(empirical_rademacher(mat, C, m, n, _key(9), 512))
        mat_pop, *_ = _threshold_loss_matrix(jax.random.PRNGKey(123), m, 20_000, C)
        pop = mat_pop(torch.arange(C)).mean(dim=(1, 2)).numpy()
        for c in range(C):
            bound = theorem2_bound(
                empirical_risk=float(emp[c]), rademacher=rad, M_i=[1.0] * m,
                n=n, cover_size=1, delta=0.1, L_y=0.0, eps=0.0,
            )
            assert pop[c] <= bound + 1e-9, (c, pop[c], bound)


def test_generalization_gap_on_a_robust_regression_split():
    """JAX's alpha-5 robust-regression data split 70 / 30 per agent into
    train and test; the measured gap at a few (x, y) against JAX's."""
    fix = load_robust_agnostic()
    a, b = fix["robust5_a"], fix["robust5_b"]
    train = {"a": a[:, :70], "b": b[:, :70]}
    test = {"a": a[:, 70:], "b": b[:, 70:]}
    from repro.problems.robust_regression import _loss as jax_loss

    jfn = jax_gap(jax_loss, jax.tree.map(jnp.asarray, train),
                  jax.tree.map(jnp.asarray, test))
    tfn = generalization_gap(_loss, tree_from_numpy(train, "cpu"),
                             tree_from_numpy(test, "cpu"))
    rng = np.random.default_rng(0)
    for _ in range(3):
        x, y = rng.standard_normal(20), 0.2 * rng.standard_normal(20)
        want = float(jfn(jnp.asarray(x), jnp.asarray(y)))
        got = float(tfn(torch.tensor(x), torch.tensor(y)))
        np.testing.assert_allclose(got, want, rtol=1e-12)
