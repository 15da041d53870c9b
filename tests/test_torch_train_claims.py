"""The LM training path's claims in the port:
`tests/test_system.py::TestEndToEndTraining` ported.  On JAX's fixture
(gemma2-2b reduced from JAX's `PRNGKey(0)` weights, 4 agents, batch 2,
seq 32, heterogeneity 11, JAX's tokens bit for bit), 15 FedGDA-GT rounds
(K 4, eta 5e-3) cut the global loss by more than 0.05, and after 10
rounds of K 8 the GT aggregate's global loss is no worse than Local
SGDA's + 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import federated_token_batches as jfederated_token_batches
from repro.models import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.convert import model_tree_from_numpy, tree_from_numpy
from repro_torch.core import make_fedgda_gt_round, make_local_sgda_round
from repro_torch.problems import delta_projection, init_delta, make_adversarial_loss

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]


@pytest.fixture(scope="module")
def small():
    """The port's side of `tests/test_system.py`'s `small` fixture."""
    jcfg, cfg = jget_config("gemma2-2b").reduced(), get_config("gemma2-2b").reduced()
    jp = jax.jit(jinit_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                                      jnp.float32)
    jdata = jfederated_token_batches(jax.random.PRNGKey(1), num_agents=4,
                                     per_agent_batch=2, seq_len=32,
                                     vocab_size=jcfg.vocab_size, heterogeneity=11)
    params = model_tree_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    data = tree_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    return cfg, params, data


def _global_loss(loss, data):
    def gl(x, y):
        with torch.no_grad():
            return float(torch.mean(torch.func.vmap(loss, in_dims=(None, None, 0))(
                x, y, data)))
    return gl


class TestEndToEndTraining:
    """Port of `tests/test_system.py::TestEndToEndTraining`."""

    def test_fedgda_gt_reduces_loss(self, small):
        cfg, params, data = small
        loss = make_adversarial_loss(cfg, remat=False)
        rnd = make_fedgda_gt_round(loss, 4, 5e-3, proj_y=delta_projection(1.0))
        gl = _global_loss(loss, data)
        x, y = params, init_delta(cfg, device="cpu")
        l0 = gl(x, y)
        for _ in range(15):
            x, y = rnd(x, y, data)
        l1 = gl(x, y)
        assert np.isfinite(l0) and np.isfinite(l1)
        assert l1 < l0 - 0.05, (l0, l1)

    def test_gt_tracks_global_not_local_descent(self, small):
        """Heterogeneous agents: after rounds of equal budget, the GT
        aggregate's GLOBAL loss should not be worse than Local SGDA's
        (whose aggregate drifts toward local optima)."""
        cfg, params, data = small
        loss = make_adversarial_loss(cfg, remat=False)
        K, eta = 8, 5e-3
        r_gt = make_fedgda_gt_round(loss, K, eta, proj_y=delta_projection(1.0))
        r_ls = make_local_sgda_round(loss, K, eta, eta, proj_y=delta_projection(1.0))
        gl = _global_loss(loss, data)
        y0 = init_delta(cfg, device="cpu")
        xg, yg = params, y0
        xl, yl = params, y0
        for _ in range(10):
            xg, yg = r_gt(xg, yg, data)
            xl, yl = r_ls(xl, yl, data)
        assert gl(xg, yg) <= gl(xl, yl) + 0.02
