"""Diminishing-stepsize Local SGDA on the port: the schedules of
tests/test_optim.py `TestSchedules`, and the scheduled round against JAX's
per round (CPU, f64).  The paper's tradeoff that the schedule serves
(tests/test_scheduled_sgda.py) is in tests/test_torch_scheduled_claims.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.optim as joptim
from repro.problems import make_quadratic_problem as jax_quadratic
from repro_torch import core, optim
from repro_torch.convert import problem_from_numpy
from repro_torch.optim import constant_schedule, diminishing_schedule
from repro_torch.problems import quadratic_minimax_point

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(rng):
    jp = jax_quadratic(rng, dim=12, num_samples=60, num_agents=6)
    data = {k: np.asarray(v) for k, v in jp.agent_data.items()}
    return jp, problem_from_numpy("quadratic", data, "cpu")


class TestSchedules:
    def test_constant(self):
        s = constant_schedule(3e-4)
        assert float(s(0)) == float(s(10_000)) == 3e-4

    def test_diminishing_is_o_1_over_t(self):
        s = diminishing_schedule(1e-2, decay=1.0)
        assert float(s(0)) == 1e-2
        np.testing.assert_allclose(float(s(99)), 1e-2 / 100.0)
        vals = [float(s(t)) for t in range(0, 50, 5)]
        assert all(a > b for a, b in zip(vals, vals[1:]))

    @pytest.mark.parametrize("make", [
        lambda m: m.constant_schedule(3e-4),
        lambda m: m.diminishing_schedule(2e-4, decay=0.01),
        lambda m: m.diminishing_schedule(1e-2),
    ])
    def test_python_floats_equal_to_jax_f64(self, make):
        """A schedule gives a Python float, JAX's f64 value, bit for bit:
        a round reads its stepsize without a device sync."""
        s, js = make(optim), make(joptim)
        for t in (0, 1, 7, 99, 3999):
            assert type(s(t)) is float
            assert s(t) == float(np.float64(js(t)))

    def test_momentum_is_not_ported_yet(self):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            optim.heavy_ball()


def test_scheduled_round_against_jax_per_round(rng):
    """The same diminishing schedule into JAX's round (a traced eta) and
    the port's (a Python float), 100 rounds, per round."""
    jp, prob = _problems(rng)
    K = 10
    sched = diminishing_schedule(2e-4, decay=0.01)
    jr = jax.jit(jcore.make_scheduled_local_sgda_round(jp.loss, K))
    tr = core.make_scheduled_local_sgda_round(prob.loss, K)
    jx = jy = jnp.zeros(12)
    tx = ty = torch.zeros(12, dtype=torch.float64)
    for t in range(100):
        jx, jy = jr(jx, jy, jp.agent_data, sched(t))
        tx, ty = tr(tx, ty, prob.agent_data, sched(t))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-12)
    # a constant eta gives Local SGDA's round (the engine's LocalOnly)
    x1, y1 = tr(tx, ty, prob.agent_data, 2e-4)
    x2, y2 = core.make_local_sgda_round(prob.loss, K, 2e-4, 2e-4)(tx, ty, prob.agent_data)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-13)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-13)
