"""The port's sharding rules (`repro_torch.launch.shardings`, `mesh`)
against JAX's (`repro.launch.shardings`, `mesh`), without device state.

For every leaf of all ten architectures' full configs (JAX's shapes from
`jax.eval_shape`, the port's on `meta`), on both production meshes, under
both variants and both fed modes, the port's spec is JAX's with the stack
entry removed (JAX stacks each pattern slot's periods, the port keeps one
module per layer); likewise the caches, the agent-stacked state and the
serve batch.  Then the cases of tests/test_shardings.py in the port's
paths, `TestPodDeviceGroups`, and `pod_aggregation_plan` against JAX's on
an 8-device mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import shardings as jsh
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro_torch.configs import ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.core.types import tree_leaves
from repro_torch.launch.steps import abstract_caches, abstract_params

pytestmark = pytest.mark.torch


class _Mesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class _PodMesh:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = {"16x16": _Mesh(), "2x16x16": _PodMesh()}
_JAX_PARAMS, _JAX_CACHES = {}, {}


def _jax_leaves(tree):
    return {jsh._path_str(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(name):
    if name not in _JAX_PARAMS:
        cfg = JAX_ARCHS[name]
        _JAX_PARAMS[name] = _jax_leaves(jax.eval_shape(
            lambda: jax_init_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16)))
    return _JAX_PARAMS[name]


def _port_leaves(tree):
    out = {}
    tsh.tree_map_with_path(lambda p, u: out.__setitem__(p, tuple(u.shape)), tree)
    return out


def _jax_path(cfg, path):
    """The JAX leaf of a port parameter path, and whether it is stacked:
    layers/<gi>/rest -> blocks/<gi % per>_<kind>/rest."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, False
    j = int(parts[1]) % len(cfg.pattern)
    return "/".join([f"blocks/{j}_{cfg.pattern[j]}"] + parts[2:]), True


def _drop_stack(spec, stacked):
    return tuple(spec)[1:] if stacked else tuple(spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_param_specs_equal_jax_for_every_leaf(name, mesh_name):
    mesh = MESHES[mesh_name]
    jax_leaves = _jax_params(name)
    port = _port_leaves(abstract_params(ARCHS[name], torch.bfloat16))
    seen = set()
    for fed_mode in ("A", "B"):
        cfg = dataclasses.replace(ARCHS[name], fed_mode=fed_mode)
        jcfg = dataclasses.replace(JAX_ARCHS[name], fed_mode=fed_mode)
        for variant in ("baseline", "megatron"):
            for path, shape in port.items():
                jpath, stacked = _jax_path(cfg, path)
                jshape = jax_leaves[jpath]
                assert (jshape[1:] if stacked else jshape) == shape, (path, jpath)
                seen.add(jpath)
                want = _drop_stack(jsh.param_pspec(jpath, jshape, jcfg, mesh, variant),
                                   stacked)
                got = tsh.param_pspec(path, shape, cfg, mesh, variant)
                assert got == want, (name, path, fed_mode, variant, got, want)
                # the agent-stacked state: JAX's [m, n_per, ...] spec
                # without its stack entry
                m = tmesh.num_agents(mesh, fed_mode)
                jagent = jsh.agent_pspec(jpath, (m,) + jshape, jcfg, mesh, variant)
                jagent = tuple(jagent)[:1] + _drop_stack(tuple(jagent)[1:], stacked)
                assert tsh.agent_pspec(path, (m,) + shape, cfg, mesh, variant) == jagent
    assert seen == set(jax_leaves)  # and every JAX leaf has a port leaf


def _jax_cache_path(cfg, path):
    parts = path.split("/")
    if parts[0] == "layers":
        j = int(parts[1]) % len(cfg.pattern)
        return f"layers/{j}_{cfg.pattern[j]}/{parts[2]}"
    return f"shared/{parts[2]}"


@pytest.mark.parametrize("shape_name,batch,capacity", [
    ("decode_32k", 128, 32768), ("long_500k", 1, 524288), ("prefill", 32, 4096)])
@pytest.mark.parametrize("name", [n for n, c in ARCHS.items() if c.supports_decode])
def test_cache_specs_equal_jax(name, shape_name, batch, capacity):
    cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
    key = (name, batch, capacity)
    if key not in _JAX_CACHES:
        _JAX_CACHES[key] = _jax_leaves(jax.eval_shape(
            lambda: jax_init_caches(jcfg, batch, capacity, jnp.bfloat16)))
    jleaves = _JAX_CACHES[key]
    port = _port_leaves(abstract_caches(cfg, batch, capacity, torch.bfloat16))
    for mesh in MESHES.values():
        for path, shape in port.items():
            jpath = _jax_cache_path(cfg, path)
            jshape = jleaves[jpath]
            assert jshape[1:] == shape, (path, jpath)
            want = tuple(jsh.cache_pspec(jpath, jshape, jcfg, mesh))[1:]
            assert tsh.cache_pspec(path, shape, cfg, mesh) == want, (path, want)


@pytest.mark.parametrize("batch", [1, 4, 16, 32, 128, 512])
@pytest.mark.parametrize("ndim", [2, 3])
def test_serve_and_train_batch_specs_equal_jax(batch, ndim):
    for mesh in MESHES.values():
        jmesh = jax.sharding.AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        want = tuple(jsh.serve_batch_sharding(jmesh, batch, ndim).spec)
        assert tsh.serve_batch_sharding(mesh, batch, ndim) == want
        for fed_mode in ("A", "B"):
            cfg = dataclasses.replace(ARCHS["granite-8b"], fed_mode=fed_mode)
            jcfg = dataclasses.replace(JAX_ARCHS["granite-8b"], fed_mode=fed_mode)
            want = tuple(jsh.train_batch_shardings(jcfg, jmesh)(ndim + 1).spec)
            assert tsh.train_batch_shardings(cfg, mesh)(ndim + 1) == want


# ---------------------------------------- tests/test_shardings.py, ported
MESH = _Mesh()


def _axes_used(spec):
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return out


class TestMegatronRules:
    def test_no_contraction_dim_sharding_for_attention(self):
        for cfg in ARCHS.values():
            for name in ("wq", "wk", "wv"):
                shape = (cfg.d_model, cfg.num_heads, cfg.head_dim)
                spec = tsh.param_pspec(f"layers/0/attn/{name}", shape, cfg, MESH,
                                       "megatron")
                assert spec[0] is None, (cfg.name, name, spec)

    def test_heads_sharded_when_divisible(self):
        for cfg in ARCHS.values():
            shape = (cfg.d_model, cfg.num_heads, cfg.head_dim)
            spec = tsh.param_pspec("layers/0/attn/wq", shape, cfg, MESH, "megatron")
            if cfg.num_heads % 16 == 0:
                assert spec[1] == "model", (cfg.name, spec)
            else:
                assert _axes_used(spec) == [], (cfg.name, spec)

    def test_mlp_column_row_pairing(self):
        for cfg in ARCHS.values():
            if not cfg.d_ff:
                continue
            up = tsh.param_pspec("layers/0/mlp/up", (cfg.d_model, cfg.d_ff), cfg, MESH,
                                 "megatron")
            down = tsh.param_pspec("layers/0/mlp/down", (cfg.d_ff, cfg.d_model), cfg,
                                   MESH, "megatron")
            if cfg.d_ff % 16 == 0:
                assert up[1] == "model" and down[0] == "model", (cfg.name,)

    def test_moe_expert_dim_over_data_in_mode_b(self):
        for cfg in ARCHS.values():
            if not cfg.num_experts:
                continue
            spec = tsh.param_pspec("layers/0/moe/up",
                                   (cfg.num_experts, cfg.d_model, cfg.d_ff), cfg, MESH,
                                   "megatron")
            if cfg.fed_mode == "B" and cfg.num_experts % 16 == 0:
                assert spec[0] == "data", (cfg.name, spec)
            assert spec[2] == "model"

    def test_mamba_column_row(self):
        cfg = ARCHS["falcon-mamba-7b"]
        in_p = tsh.param_pspec("layers/0/mamba/in_proj", (cfg.d_model, 2 * cfg.d_inner),
                               cfg, MESH, "megatron")
        out_p = tsh.param_pspec("layers/0/mamba/out_proj", (cfg.d_inner, cfg.d_model),
                                cfg, MESH, "megatron")
        assert in_p[1] == "model" and out_p[0] == "model"

    def test_scalars_and_vectors_replicated(self):
        cfg = ARCHS["granite-8b"]
        for variant in ("baseline", "megatron"):
            spec = tsh.param_pspec("layers/0/ln1/scale", (cfg.d_model,), cfg, MESH,
                                   variant)
            assert _axes_used(spec) == [], spec


class TestBaselineRules:
    def test_largest_divisible_dim(self):
        cfg = ARCHS["granite-8b"]
        spec = tsh.param_pspec("layers/0/mlp/up", (4096, 14336), cfg, MESH, "baseline")
        assert spec[1] == "model"

    def test_same_rules_on_multipod_mesh(self):
        cfg = ARCHS["granite-8b"]
        for variant in ("baseline", "megatron"):
            spec = tsh.param_pspec("layers/0/attn/wq", (4096, 32, 128), cfg,
                                   _PodMesh(), variant)
            assert len(spec) == 3

    def test_jax_stacked_paths_keep_their_offset(self):
        cfg = ARCHS["granite-8b"]
        for variant in ("baseline", "megatron"):
            path, shape = "blocks/0_attn/attn/wq", (8, 4096, 32, 128)
            assert tsh.param_pspec(path, shape, cfg, MESH, variant) == tuple(
                jsh.param_pspec(path, shape, JAX_ARCHS["granite-8b"], MESH, variant))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _PodMesh()
    assert tsh.placements(((("pod", "data")), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    assert tsh.placements(tsh.replicated(mesh), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        tsh.param_pspec("layers/0/attn/wq", (8, 4, 2), ARCHS["granite-8b"], mesh, "x")


def test_shardings_trees_place_each_leaf_by_its_spec():
    cfg = ARCHS["zamba2-7b"]
    params = abstract_params(cfg, torch.bfloat16)
    got = tsh.param_shardings(params, cfg, _PodMesh(), "megatron")
    for path, shape in _port_leaves(params).items():
        node = got
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        assert node == tsh.placements(
            tsh.param_pspec(path, shape, cfg, _PodMesh(), "megatron"), _PodMesh())
    caches = abstract_caches(cfg, 64, 1024, torch.bfloat16)
    cgot = tsh.cache_shardings(caches, cfg, MESH)
    assert cgot["layers"][0]["ssm"] == tsh.placements(
        tsh.cache_pspec("layers/0/ssm", tuple(caches["layers"][0]["ssm"].shape), cfg,
                        MESH), MESH)
    assert cgot["layers"][0]["ssm"][0].dim == 0  # the batch over "data"


# ------------------------------------------------ meshes and pod groups
class _DataMesh:
    shape = {"data": 8, "model": 1}
    axis_names = ("data", "model")


class TestPodDeviceGroups:
    def test_groups_partition_the_fed_devices(self):
        groups = tmesh.pod_device_groups(_DataMesh(), "A", 4)
        assert len(groups) == 4 and all(len(g) == 2 for g in groups)
        flat = [d for g in groups for d in g]
        assert flat == sorted(flat) and len(set(flat)) == 8

    def test_non_dividing_pod_count_is_rejected(self):
        with pytest.raises(ValueError, match="divide"):
            tmesh.pod_device_groups(_DataMesh(), "A", 3)

    def test_no_fed_axes_is_rejected(self):
        with pytest.raises(ValueError, match="no federated axes"):
            tmesh.pod_device_groups(_DataMesh(), "B", 1)

    @pytest.mark.parametrize("mesh_name", list(MESHES))
    @pytest.mark.parametrize("num_pods", [1, 2, 4, 8, 16])
    def test_groups_equal_jax_on_production_meshes(self, mesh_name, num_pods):
        from repro.launch.mesh import pod_device_groups

        mesh = MESHES[mesh_name]
        jmesh = jax.sharding.Mesh(
            np.arange(np.prod(list(mesh.shape.values()))).reshape(
                tuple(mesh.shape.values())), mesh.axis_names)

        class _Dev(int):
            id = property(int)

        jmesh = type("M", (), {"axis_names": mesh.axis_names, "shape": mesh.shape,
                               "devices": np.vectorize(_Dev, otypes=[object])(
                                   jmesh.devices)})()
        want = pod_device_groups(jmesh, "A", num_pods)
        assert tmesh.pod_device_groups(mesh, "A", num_pods) == [
            [int(d) for d in g] for g in want]


@pytest.mark.parametrize("num_pods", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["granite-8b", "zamba2-7b"])
def test_pod_aggregation_plan_equals_jax(fed_devices, name, num_pods):
    from repro.launch.steps import pod_aggregation_plan as jax_plan
    from repro_torch.launch.steps import pod_aggregation_plan

    cfg, jcfg = ARCHS[name].reduced(), JAX_ARCHS[name].reduced()
    jmesh = jax.sharding.Mesh(np.array(fed_devices).reshape(8, 1), ("data", "model"))
    want = jax_plan(jcfg, jmesh, num_pods)
    want["groups"] = [[d - fed_devices[0].id for d in g] for g in want["groups"]]
    got = pod_aggregation_plan(cfg, _DataMesh(), num_pods)
    # the port's per-layer leaves are priced as JAX's stacked slot leaves:
    # one header per JAX leaf and direction
    assert got == want


# ------------------------------ the model lines made DTensor-clean: pins
def test_causal_conv_equals_the_padded_conv_bit_for_bit():
    import torch.nn.functional as F

    from repro_torch.models.mamba import _causal_conv, _conv_valid

    gen = torch.Generator().manual_seed(3)
    for S in (1, 2, 5, 40):
        x = torch.randn(2, S, 24, generator=gen)
        w, b = torch.randn(4, 24, generator=gen), torch.randn(24, generator=gen)
        want = _conv_valid(F.pad(x, (0, 0, 3, 0)), w, b)
        assert torch.equal(_causal_conv(x, w, b), want)


def test_gold_logit_masked_sum_equals_the_gather_bit_for_bit():
    """`chunked_lm_loss`'s masked sum against the `take_along_dim` it
    replaced: the same loss bits, the same gradient values."""
    from repro_torch.models.transformer import chunked_lm_loss

    cfg = ARCHS["granite-8b"].reduced()
    gen = torch.Generator().manual_seed(4)
    h = torch.randn(2, 16, cfg.d_model, generator=gen, requires_grad=True)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen) * 0.02
    labels = torch.randint(-1, cfg.vocab_size, (2, 16), generator=gen)

    def old(h):
        logits = torch.einsum("...d,vd->...v", h, table).float()
        logz = torch.logsumexp(logits, dim=-1)
        safe = torch.clamp_min(labels, 0).long()
        gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
        tot = torch.sum(torch.where(labels >= 0, logz - gold, torch.zeros_like(logz)))
        return tot / torch.clamp_min(torch.sum(labels >= 0).float(), 1.0)

    got = chunked_lm_loss({"embed": table}, cfg, h, labels, chunk=16)
    want = old(h)
    assert torch.equal(got, want)
    g_got, = torch.autograd.grad(got, h)
    g_want, = torch.autograd.grad(want, h)
    assert torch.equal(g_got, g_want)


def test_decode_mask_out_of_place_bit_for_bit():
    from repro_torch.models.attention import _attend

    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 16, generator=gen)
    k, v = torch.randn(2, 10, 2, 16, generator=gen), torch.randn(2, 10, 2, 16, generator=gen)
    pos = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1, -1, -1], dtype=torch.int32)
    qp = torch.tensor([6], dtype=torch.int32)
    got = _attend(q, k, v, qp, pos, pos >= 0, True, 4, 0.0)
    # the in-place mask it replaced
    mask = torch.ones(1, 10, dtype=torch.bool)
    mask &= qp[:, None] >= pos[None, :]
    mask &= qp[:, None] - pos[None, :] < 4
    mask &= (pos >= 0)[None, :]
    qg = q.reshape(2, 1, 2, 2, 16)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() / torch.sqrt(torch.tensor(16.0))
    from repro_torch.kernels.ref import NEG_INF

    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    want = torch.einsum("bkgst,btkh->bskgh", torch.softmax(scores, -1), v).reshape(2, 1, 4, 16)
    assert torch.equal(got, want)


def test_meta_parameters_draw_nothing_and_seeded_draws_stay():
    """`init_params(None, ...)` builds meta tensors of the seeded build's
    shapes without drawing; a seeded build is unchanged by it."""
    from repro_torch.models import init_params

    cfg = ARCHS["zamba2-7b"].reduced()
    a = init_params(torch.Generator().manual_seed(0), cfg).tree()
    meta = init_params(None, cfg).tree()
    b = init_params(torch.Generator().manual_seed(0), cfg).tree()
    for u, m, w in zip(tree_leaves(a), tree_leaves(meta), tree_leaves(b)):
        assert m.device.type == "meta" and m.shape == u.shape and m.dtype == u.dtype
        assert torch.equal(u, w)


def test_plain_tensors_refuse_the_spmd_constraints():
    """Nobody should believe a tensor was placed when it was not: the
    agent constraint and `h_sharding` raise on plain tensors."""
    from repro_torch.models.transformer import constrain

    cfg = ARCHS["granite-8b"]
    hook = tsh.make_agent_constraint(cfg, MESH)
    with pytest.raises(TypeError, match="plain tensor"):
        hook({"w": torch.zeros(16, 4, 4)}, {"delta": torch.zeros(16, 4)})
    with pytest.raises(TypeError, match="plain tensor"):
        constrain(torch.zeros(2, 8, 4),
                  (MESH, tsh.placements((None, "model", None), MESH)))


@pytest.fixture
def one_rank_gloo():
    """The one-process gloo group `make_host_mesh` starts, ended after the
    test (the group is process-wide)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield tmesh.make_host_mesh(1, 1, device="cpu")
    dist.destroy_process_group()
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    _clear_sharding_prop_cache()  # its entries name this group


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b"])
def test_serve_batched_equals_jax_examples_computation(one_rank_gloo, arch):
    """`examples.serve_batched.serve` on the one-rank mesh against
    `examples/serve_batched.py`'s computation (JAX's step builders on
    `make_host_mesh(1, 1)`, greedy decode) on JAX's weights: the same
    tokens, logits within 1e-4 of their max.  JAX's example fills its
    caches with zeros, so every empty slot claims position 0 and its
    prefill attends over them (0.34 of max |logit| off its own uncached
    forward at gemma2-2b's reduced size); here, as in the port's example
    and both serving entry points, the caches come from `init_caches`
    (empty slots at position -1)."""
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.launch.steps import build_decode_step, build_prefill_step
    from repro.models import random_batch as jrandom_batch
    from repro_torch.convert import model_tree_from_numpy
    from repro_torch.examples.serve_batched import place_params, serve

    B, S, N = 2, 16, 5
    cfg, jcfg = ARCHS[arch].reduced(), JAX_ARCHS[arch].reduced()
    mesh = jmake_host_mesh(1, 1)
    with jax.set_mesh(mesh):
        params = jax_init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        jit_p, specs_p = build_prefill_step(jcfg, mesh, dtype=jnp.float32)
        sp = specs_p(JShapeConfig("serve_prefill", S + N, B, "prefill"))
        caches = jax_init_caches(jcfg, B, S + N, jnp.float32)
        assert all(jax.tree.leaves(jax.tree.map(lambda c, s: c.shape == s.shape,
                                                caches, sp["caches"])))
        batch = jrandom_batch(jax.random.PRNGKey(1), jcfg, B, S, jnp.float32)
        logits, caches = jit_p(JShapeConfig("p", S, B, "prefill"))(params, batch, caches)
        step = build_decode_step(jcfg, mesh, dtype=jnp.float32)[0](
            JShapeConfig("serve_decode", S + N, B, "decode"))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks, steps = [tok], [np.asarray(logits[:, -1])]
        for i in range(N - 1):
            logits, caches = step(params, caches, tok, jnp.int32(S + i))
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            toks.append(tok)
            steps.append(np.asarray(logits[:, -1]))
    want_tokens = np.concatenate([np.asarray(t) for t in toks], axis=1)
    tree = model_tree_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    prompts = {"tokens": torch.from_numpy(np.asarray(batch["tokens"]).astype(np.int64))}
    got = serve(cfg, one_rank_gloo, place_params(tree, cfg, one_rank_gloo), prompts, N)
    assert np.array_equal(got["tokens"].numpy(), want_tokens)
    want = np.stack(steps, axis=1)
    err = float(np.abs(got["step_logits"].numpy() - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
