"""The strategies' `transform_correction` of the port against the JAX
package's, bit for bit: the gate that holds the discrete choices (kept
entries, rounding decisions) of CompressedGT and QuantizedGT.

Given the same corrections and state, every output and the new state
(feedback buffers, RNG key) are the same bits, round after round, with the
wire on and off, for every corrections dtype (CompressedGT here,
QuantizedGT in `test_torch_transform_quantized.py`).  JAX runs eagerly,
one XLA op at a time, as its oracle is written.  Also: the JAX strategy
state converts exactly, and a few whole rounds of both engines agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fed as jfed
from repro.problems import make_quadratic_problem
from repro_torch import core, fed
from repro_torch.convert import problem_from_numpy, strategy_state_from_numpy
from repro_torch.fixtures import QUAD6
from test_torch_parity import STRATEGIES, _assert_trees, check_transform

pytestmark = pytest.mark.torch

M, DIM, K, ETA = 8, 6, 4, 2e-4


# --------------------------------------- the strategies' transform gate
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
@pytest.mark.parametrize("wire", [False, True], ids=["dense", "wire"])
@pytest.mark.parametrize("name", [n for n in STRATEGIES if n.startswith("cgt")])
def test_transform_correction_equals_jax(name, wire, dt):
    check_transform(jfed, fed, name, wire, dt)


def test_strategy_state_from_numpy_is_exact():
    js = jfed.QuantizedGT(bits=8, correction_dtype=jnp.bfloat16, seed=2 ** 32 + 7)
    x = {"a": jnp.ones((4,)), "b": jnp.ones((2, 3))}
    st = js.init_state(x, jnp.ones(5), 3)
    st["ex"] = jax.tree.map(lambda u: u + jnp.asarray(1.25, u.dtype), st["ex"])
    got = strategy_state_from_numpy(jax.tree.map(np.asarray, st), "cpu")
    assert got["key"].dtype == torch.int64
    np.testing.assert_array_equal(got["key"].numpy(),
                                  np.asarray(st["key"]).astype(np.int64))
    _assert_trees(st["ex"], got["ex"], "ex")
    assert got["ex"]["a"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="uint32"):
        strategy_state_from_numpy({"key": np.zeros(3, np.uint32)}, "cpu")


@pytest.mark.parametrize("wire", [False, True], ids=["dense", "wire"])
def test_port_round_equals_jax_round_per_round(wire):
    """A few rounds of QuantizedGT through the port's engine against the
    JAX engine on the same data: the iterates agree to f64 round-off (the
    matvecs sum in another order), and the strategy states bitwise until
    a round-off difference flips a discrete choice (none does here)."""
    jprob = make_quadratic_problem(jax.random.PRNGKey(0), dim=QUAD6[0],
                                   num_samples=QUAD6[1], num_agents=QUAD6[2])
    quad = problem_from_numpy(
        "quadratic", {k: np.asarray(v) for k, v in jprob.agent_data.items()}, "cpu")
    js = jfed.QuantizedGT(bits=4, ratio=0.5, wire_transport=wire)
    ts = fed.QuantizedGT(bits=4, ratio=0.5, wire_transport=wire)
    jr = jax.jit(jcore.make_round(jprob.loss, js, K, ETA, explicit_state=True))
    tr = core.make_round(quad.loss, ts, K, ETA, explicit_state=True)
    jx = jy = jnp.ones(DIM)
    tx = ty = torch.ones(DIM, dtype=torch.float64)
    jst = js.init_state(jx, jy, M)
    tst = ts.init_state(tx, ty, M)
    for _ in range(6):
        jx, jy, jst = jr(jx, jy, jprob.agent_data, jst)
        tx, ty, tst = tr(tx, ty, quad.agent_data, tst)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-12)
        np.testing.assert_array_equal(tst["key"].numpy(),
                                      np.asarray(jst["key"]).astype(np.int64))


