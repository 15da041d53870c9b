"""`repro_torch.examples.train_federated_lm` against JAX's computation:
two rounds on JAX's weights (the example's `init_model` replaced by JAX's
`PRNGKey(0)` draw at the example's configuration, granite-25m), the
logged global loss and |delta| within 1e-4 of the JAX example's
computation (`make_fedgda_gt_round` over the same data, bit for bit,
written out here with `repro`'s public API).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import make_fedgda_gt_round as jmake_fedgda_gt_round
from repro.data import federated_token_batches as jfederated_token_batches
from repro.models import init_params as jinit_params
from repro.problems.adversarial import delta_projection as jdelta_projection
from repro.problems.adversarial import init_delta as jinit_delta
from repro.problems.adversarial import make_adversarial_loss as jmake_adversarial_loss
from repro_torch.convert import model_tree_from_numpy
from repro_torch.examples import train_federated_lm

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]


def test_train_federated_lm_example_equals_the_reference(monkeypatch, capsys):
    rounds = 2
    cfg = train_federated_lm.model_config(False)
    jcfg = type(jget_config("granite-8b"))(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = jax.jit(jinit_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                                      jnp.float32)

    def init_model(c, device):
        assert c == cfg and str(device) == "cpu"
        return model_tree_from_numpy(c, jax.tree.map(np.asarray, jp), device)

    monkeypatch.setattr(train_federated_lm, "init_model", init_model)
    got = train_federated_lm.main(["--device", "cpu", "--rounds", str(rounds)])
    assert "done" in capsys.readouterr().out

    # the example's computation in the JAX package: agents 4, K 4, batch 2,
    # seq 128, eta 5e-3, heterogeneity vocab // (2 * agents)
    agents, K = 4, 4
    data = jfederated_token_batches(jax.random.PRNGKey(1), agents, 2, 128,
                                    jcfg.vocab_size,
                                    heterogeneity=jcfg.vocab_size // (2 * agents))
    loss = jmake_adversarial_loss(jcfg, remat=False)
    rnd = jax.jit(jmake_fedgda_gt_round(loss, K, 5e-3, proj_y=jdelta_projection(1.0)))
    gl = jax.jit(lambda x, y: jnp.mean(jax.vmap(loss, in_axes=(None, None, 0))(x, y, data)))
    x, y = jp, jinit_delta(jcfg)
    want = []
    for t in range(rounds):
        x, y = rnd(x, y, data)
        if t % 10 == 0 or t == rounds - 1:
            want.append((t, float(gl(x, y)), float(jnp.linalg.norm(y["delta"]))))
    assert [t for t, _, _ in got["log"]] == [t for t, _, _ in want]
    for (_, lv, dn), (_, wl, wd) in zip(got["log"], want):
        assert abs(lv - wl) <= 1e-4 * abs(wl), (lv, wl)
        assert abs(dn - wd) <= 1e-4 * abs(wd), (dn, wd)
