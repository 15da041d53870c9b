"""The port's elastic rounds against JAX's, per round, at the elastic
benchmark's size (m=10, d=30, K=10, eta=1e-4; JAX's data and schedules of
the `elastic_rounds` fixture), on the CPU: FedGDA-GT with and without
rebasing, Local SGDA, CompressedGT and QuantizedGT under the flaky,
diurnal and straggler-heavy scenarios, and client sampling and
centralized GDA under flaky churn.  Every round's x and y agree with
JAX's to ROUND_RTOL (max-norm, relative): the engines sum the matvecs in
other orders, nothing else differs (the schedules, the compressors'
selections and draws are bit for bit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro import sim as jsim
from repro.problems.quadratic import _loss as jax_quadratic_loss
from repro_torch import fed, sim
from repro_torch.fixtures import ELASTIC, ELASTIC_ROWS, elastic_problem, load_elastic_rounds

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

DIM, _, M, K, ETA, _, SEED = ELASTIC
ROUNDS = 60
#: measured at most 1.2e-15 over these rounds (CPU)
ROUND_RTOL = 1e-12


def _coords(x, y):
    """Every coordinate of x and y as a metric, in both packages."""
    return {**{f"x{i}": x[i] for i in range(DIM)}, **{f"y{i}": y[i] for i in range(DIM)}}


def _iterates(runner):
    return {z: np.stack([runner.metric_series(f"{z}{i}") for i in range(DIM)], 1)
            for z in "xy"}


def _runs(scenario, alias, kw, rebase):
    fix = load_elastic_rounds()
    jdata = {"G": jnp.asarray(fix["G"]), "Ab": jnp.asarray(fix["Ab"])}
    jsched = jsim.make_population(scenario, M).schedule(SEED, ROUNDS, K)
    sched = sim.RoundSchedule(fix[f"{scenario}_active"][:ROUNDS],
                              fix[f"{scenario}_budgets"][:ROUNDS], K)
    np.testing.assert_array_equal(jsched.active, sched.active)
    jr = jfed.FederatedRunner.from_strategy(
        jax_quadratic_loss, jfed.resolve_strategy(alias, **kw), jdata, K, ETA,
        metric_fn=_coords)
    jr.run(jnp.zeros(DIM), jnp.zeros(DIM), ROUNDS, schedule=jsched, rebase=rebase)
    prob, _, _ = elastic_problem("cpu")
    r = fed.FederatedRunner.from_strategy(prob.loss, alias, prob.agent_data, K, ETA,
                                          metric_fn=_coords, **kw)
    x0 = torch.zeros(DIM, dtype=torch.float64)
    r.run(x0, x0, ROUNDS, schedule=sched, rebase=rebase)
    np.testing.assert_array_equal(r.metric_series("n_active"),
                                  sched.active.sum(axis=1))
    return _iterates(r), _iterates(jr)


def _assert_rounds_track(got, want):
    for z in "xy":
        err = np.abs(got[z] - want[z]).max(axis=1) / np.abs(want[z]).max(axis=1)
        assert err.max() <= ROUND_RTOL, (z, int(err.argmax()), float(err.max()))


@pytest.mark.parametrize("scenario", ["flaky", "diurnal", "straggler_heavy"])
@pytest.mark.parametrize("row", list(ELASTIC_ROWS))
def test_benchmark_rows_track_jax_per_round(scenario, row):
    alias, kw, rebase = ELASTIC_ROWS[row]
    _assert_rounds_track(*_runs(scenario, alias, kw, rebase))


@pytest.mark.parametrize("alias,kw", [("partial_gt", {"participation": 0.5}),
                                      ("gda", {})], ids=["partial_gt", "gda"])
def test_sampling_and_gda_track_jax_per_round(alias, kw):
    """A partial strategy's own sampling is bypassed (membership comes from
    the schedule); GDA ignores budgets, membership enters by weights."""
    _assert_rounds_track(*_runs("flaky", alias, kw, True))
