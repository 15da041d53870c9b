"""The port's benchmark drivers (`repro_torch.benchmarks.fig1_quadratic`,
`fig2_robust_regression`, `fig3_fixed_point`) on the CPU at reduced
rounds, through their `run(...)` arguments, against the JAX drivers cut to
the same rounds: the same title and header, the same rows (the discrete
cells exactly, the numbers to the printed digits, as far as the f64
round-off and the reference's f32 ball norm allow)."""
import io
import contextlib

import jax
import numpy as np
import pytest
import torch

import benchmarks.fig1_quadratic as jfig1
import benchmarks.fig2_robust_regression as jfig2
import benchmarks.fig3_fixed_point as jfig3
from repro_torch.benchmarks import fig1_quadratic, fig2_robust_regression, fig3_fixed_point

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = fn()
    lines = buf.getvalue().strip().splitlines()
    return lines[0], lines[1], rows


def _close(got: dict, want: dict, rtol: float):
    assert list(got) == list(want)
    for k in got:
        g, w = got[k], want[k]
        if isinstance(w, str) and isinstance(g, str):
            try:
                gf, wf = float(g), float(w)
            except ValueError:
                assert g == w, k
                continue
        else:
            gf, wf = float(g), float(w)
        assert gf == wf or abs(gf - wf) <= rtol * max(abs(wf), 1e-300), (k, g, w)


def test_fig1_matches_the_reference(monkeypatch):
    monkeypatch.setattr(jfig1, "T", 30)
    jt, jh, jrows = _table(jfig1.run)
    tt, th, trows = _table(lambda: fig1_quadratic.run(device="cpu", rounds=30))
    assert (tt, th) == (jt, jh)
    assert th == "algorithm,final_gap,rounds_to_1e-6,rounds_to_1e-10"
    for g, w in zip(trows, jrows):
        _close(g, w, rtol=2e-3)  # final_gap printed to 4 digits


def test_fig2_matches_the_reference(monkeypatch):
    monkeypatch.setattr(jfig2, "T", 3)
    jt, jh, jrows = _table(jfig2.run)
    tt, th, trows = _table(lambda: fig2_robust_regression.run(device="cpu", rounds=3))
    assert (tt, th) == (jt, jh)
    assert th.split(",") == fig2_robust_regression.HEADER
    for g, w in zip(trows, jrows):
        _close(g, w, rtol=2e-3)


def test_fig3_matches_the_reference(monkeypatch):
    real = jfig3.run_rounds

    def cut(rnd, x0, y0, data, rounds, *a, **k):  # 30,000 -> 200 rounds
        return real(rnd, x0, y0, data, min(rounds, 200), *a, **k)

    monkeypatch.setattr(jfig3, "run_rounds", cut)
    jt, jh, jrows = _table(jfig3.run)
    tt, th, trows = _table(lambda: fig3_fixed_point.run(device="cpu", rounds=200))
    assert (tt, th) == (jt, jh)
    for g, w in zip(trows, jrows):
        # the residuals are ~1e-15 at K=1, printed to 3 digits: absolute there
        g, w = dict(g), dict(w)
        for k in ("prop1_residual_at_fp", "prop1_residual_at_minimax"):
            gf, wf = float(g.pop(k)), float(w.pop(k))
            assert abs(gf - wf) <= 1e-12 + 1e-2 * abs(wf), (k, gf, wf)
        _close(g, w, rtol=1e-7)
