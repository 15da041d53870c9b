"""`transform_correction` of QuantizedGT in the port against the JAX
package's, bit for bit (the CompressedGT half of this gate is
`test_torch_transform.py`): the same corrections and state in, the same
bits of every output and of the new state out, round after round, with
the wire on and off, for every corrections dtype; then on model trees,
whose leaves the port numbers as JAX's stacked tree does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed as jfed
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro_torch import fed
from repro_torch.configs import get_config
from repro_torch.convert import model_tree_from_numpy, strategy_state_from_numpy
from repro_torch.core.types import tree_flatten
from test_torch_parity import STRATEGIES, assert_same, check_transform, seed_of

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
@pytest.mark.parametrize("wire", [False, True], ids=["dense", "wire"])
@pytest.mark.parametrize("name", [n for n in STRATEGIES if n.startswith("qgt")])
def test_transform_correction_equals_jax(name, wire, dt):
    check_transform(jfed, fed, name, wire, dt)


# ------------------------------------------------ model trees (JAX's leaves)
def _model_corrections(name, layers, m, rng):
    """A random agent-stacked correction of the model's x in JAX's layout
    ([m, n_per, ...] under "blocks") and in the port's (one [m, ...] leaf
    per layer), f32."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), num_layers=layers)
    cfg = dataclasses.replace(get_config(name).reduced(), num_layers=layers)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg,
                                                 jnp.float32))
    cx = jax.tree.map(lambda s: rng.standard_normal((m,) + s.shape).astype(np.float32),
                      shapes)
    return cfg, cx, _to_port(cfg, cx)


@pytest.mark.parametrize("name,layers", [
    ("gemma2-2b", 4), ("zamba2-7b", 4), ("llama4-scout-17b-a16e", 2), ("granite-8b", 2)])
def test_leaf_groups_are_jax_leaves(name, layers):
    """`core.types.leaf_groups` of the port's model tree: JAX's leaves in
    JAX's order, each the port's leaves of one (pattern slot, path)
    stacked in layer order: gemma2-2b's two slots ("0_local", "1_attn"),
    zamba2-7b's shared block beside its slot, llama4's experts."""
    from repro_torch.core.types import leaf_groups

    cfg, cx, tx = _model_corrections(name, layers, 1, np.random.default_rng(0))
    want = jax.tree.leaves(cx)
    got = tree_flatten(tx)[0]
    groups = leaf_groups(tx, len(cfg.pattern))
    assert len(groups) == len(want)
    for g, w in zip(groups, want):
        stacked = np.stack([got[i].numpy() for i in g], axis=1)
        assert np.array_equal(stacked.reshape(w.shape), w)
    assert leaf_groups(tx, 0) == [[i] for i in range(len(got))]


def _to_port(cfg, jtree):
    """A JAX agent-stacked model tree (a correction, a feedback buffer)
    in the port's layout, as numpy."""
    t = jax.tree.map(np.asarray, jtree)
    t["blocks"] = jax.tree.map(lambda a: np.moveaxis(a, 1, 0), t["blocks"])
    return model_tree_from_numpy(cfg, t, "cpu")


# rand-k selection and stochastic rounding in one strategy; JAX's eager
# oracle compiles each op at each leaf shape, so one case, and the wire's
# headers on the port's side alone
@pytest.mark.parametrize("kind,wire", [("qgt4_randk", False)])
def test_model_tree_draws_equal_jax(kind, wire):
    """On a model tree x the port numbers leaves as JAX's stacked tree
    does: QuantizedGT's levels and rand-k's kept indices come out bit for
    bit JAX's, round after round (the feedback buffers and key too), and
    a wire round, equal to the dense one, carries one header a JAX leaf."""
    rng = np.random.default_rng(seed_of(kind, wire))
    m = 2
    # two layers stacked in one pattern slot (the leaf mapping of every
    # pattern is `test_leaf_groups_are_jax_leaves`'s)
    cfg, jx, tx = _model_corrections("granite-8b", 2, m, rng)
    jx = jax.tree.map(jnp.asarray, jx)
    js = STRATEGIES[kind](jfed, wire)
    ts = dataclasses.replace(STRATEGIES[kind](fed, wire), layer_period=len(cfg.pattern))
    cy = rng.standard_normal((m, 5)).astype(np.float32)
    jy, ty = {"delta": jnp.asarray(cy)}, {"delta": torch.from_numpy(cy.copy())}
    jstate = js.init_state(jax.tree.map(lambda u: u[0], jx),
                           jax.tree.map(lambda u: u[0], jy), m)
    tstate = strategy_state_from_numpy(
        {k: v for k, v in jax.tree.map(np.asarray, jstate).items() if k != "ex"}, "cpu")
    if "ex" in jstate:
        tstate["ex"] = _to_port(cfg, jstate["ex"])
    for rnd in range(2):
        want = js.transform_correction(jx, jy, jstate)
        got = ts.transform_correction(tx, ty, tstate)
        if wire:
            assert got[0].total_bytes() == want[0].total_bytes()
            assert got[0].headers == len(jax.tree.leaves(jx))
            want_x, got_x = want[0].decode(), got[0].decode()
        else:
            want_x, got_x = want[0], got[0]
        wl = tree_flatten(_to_port(cfg, want_x))[0]
        for i, (w, g) in enumerate(zip(wl, tree_flatten(got_x)[0])):
            assert_same(w.numpy(), g, f"round {rnd} cx leaf {i}")
        if "ex" in want[2]:
            for i, (w, g) in enumerate(zip(tree_flatten(_to_port(cfg, want[2]["ex"]))[0],
                                           tree_flatten(got[2]["ex"])[0])):
                assert_same(w.numpy(), g, f"round {rnd} ex leaf {i}")
        np.testing.assert_array_equal(np.asarray(want[2]["key"]).astype(np.int64),
                                      got[2]["key"].numpy())
        if not wire:
            packed = dataclasses.replace(ts, wire_transport=True).transform_correction(
                tx, ty, tstate)[0]
            assert packed.headers == len(jax.tree.leaves(jx))
            for i, (w, g) in enumerate(zip(tree_flatten(got_x)[0],
                                           tree_flatten(packed.decode())[0])):
                assert torch.equal(w, g), f"round {rnd} wire leaf {i}"
        jstate, tstate = want[2], got[2]
