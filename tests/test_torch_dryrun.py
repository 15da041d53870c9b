"""The executed-op census (`repro_torch.launch.census`, the counterpart of
`repro.launch.hlo_census`) and the production-mesh dry-run on a fake
world (`repro_torch.launch.dryrun`), on the CPU.

The census cases mirror tests/test_hlo_census.py: a K-step loop of
matmuls (the port runs every loop, so its counts are executed counts
with no trip-count scaling), one matmul, collectives in a loop, duplicate
shapes.  Then reduced configs on the fake 16x16 world for a train, a
prefill and a decode step, and the async gather's census against
`expected_gather_bytes` (and JAX's) on both production meshes.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.census import Census

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def fake_world():
    """A fake 256-rank default group for this module, ended after it."""
    dryrun.fake_world(256)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    _clear_sharding_prop_cache()  # its entries name this world's groups


def test_nested_loop_flops_exact():
    x = torch.ones(64, 64)
    with Census() as c:
        y = x
        for _ in range(8):
            y = y @ y
        for _ in range(5):
            for _ in range(3):
                y = y @ y
    assert c.summary()["executed_dot_flops"] == 2 * 64 ** 3 * (8 + 15)


def test_one_matmul_counted_once():
    with Census() as c:
        torch.ones(32, 128) @ torch.ones(128, 16)
    assert c.summary()["executed_dot_flops"] == 2 * 32 * 128 * 16


def test_batched_and_fused_matmuls():
    a, b = torch.ones(3, 8, 5), torch.ones(3, 5, 7)
    with Census() as c:
        torch.bmm(a, b)
        torch.baddbmm(torch.zeros(3, 8, 7), a, b)
        torch.addmm(torch.zeros(8, 7), a[0], b[0])
        torch.einsum("bij,bjk->bik", a, b)
    assert c.summary()["executed_dot_flops"] == 2 * 8 * 5 * 7 * (3 + 3 + 1 + 3)


def test_duplicate_dot_detection():
    x = torch.ones(32, 32)
    with Census() as c:
        x @ x + (x * 2) @ (x * 3)
    s = c.summary()
    assert s["duplicate_dot_shapes"] == {"f32[32,32]": 2}


def test_collectives_counted_every_trip(fake_world):
    """Collectives inside a loop are counted every trip, with the bytes of
    their result on one rank; DTensor's own collectives come through."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu")
    t = torch.zeros(4, 16, device="meta")
    with Census() as c:
        for _ in range(6):
            funcol.all_reduce(t, "sum", mesh["model"])
        for _ in range(2):
            funcol.all_gather_tensor(t, 0, mesh["data"])
    coll = c.summary()["collectives_executed"]
    assert coll["all-reduce"] == {"count": 6, "bytes": 6 * 4 * 16 * 4}
    assert coll["all-gather"] == {"count": 2, "bytes": 2 * 16 * 4 * 16 * 4}
    from torch.distributed.tensor import DTensor

    d = DTensor.from_local(t, mesh, [Shard(0), Replicate()], run_check=False)
    with Census() as c:
        d.redistribute(mesh, [Replicate(), Replicate()])
    assert c.summary()["collectives_executed"]["all-gather"] == {
        "count": 1, "bytes": 16 * 4 * 16 * 4}


def _reduced(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), **kw)


@pytest.mark.parametrize("name,shapes", [
    ("granite-8b", ("prefill_32k", "decode_32k")),
    # the plain scan steps through 32k positions on meta: decode alone
    ("zamba2-7b", ("decode_32k",))])
def test_reduced_dryrun_serve_steps(fake_world, name, shapes):
    cfg = _reduced(name)
    recs = {}
    for shape in shapes:
        rec = dryrun.run_one(name, shape, False, cfg=cfg)
        assert rec["mesh"] == "16x16" and rec["kernels"] == "plain (meta)"
        census = rec["census"]
        assert census["executed_dot_flops"] > 0
        assert rec["collectives"] == census["collectives_executed"]
        # the step ran sharded: its inputs on one rank are a share of the
        # whole, and DTensor moved activations between ranks
        assert 0 < rec["argument_bytes_per_rank"]
        assert census["collectives_executed"], census
        recs[shape] = census["executed_dot_flops"]
    if len(recs) == 2:  # decode runs one position of a 32k prefill's
        assert recs["decode_32k"] * 1000 < recs["prefill_32k"]


def test_reduced_dryrun_train_round(fake_world):
    """One FedGDA-GT round of a reduced model, m = 16 agents over the data
    axis: the census counts K steps' gradients (the agent-stacked loss's
    matmuls) and the agent mean's all-reduce."""
    cfg = _reduced("granite-8b", num_layers=2)
    rec = dryrun.run_one("granite-8b", "train_4k", False, num_local_steps=2, cfg=cfg)
    c = rec["census"]["collectives_executed"]
    assert rec["census"]["executed_dot_flops"] > 0
    assert c.get("all-reduce", {}).get("count", 0) > 0 or c.get("reduce-scatter")
    assert rec["argument_bytes_per_rank"] > 0 and rec["num_local_steps"] == 2


def _jax_expected(name, algorithm, cfg_kw, m):
    """JAX's `expected_gather_bytes` for m agents (its `leaf_specs` over
    its abstract parameters; no 256-device mesh needed)."""
    from repro.configs import get_config as jax_get_config
    from repro.launch.multihost import leaf_specs
    from repro.launch.steps import _resolve_cfg_strategy, abstract_params, delta_struct

    cfg = dataclasses.replace(jax_get_config(name).reduced(), **cfg_kw)
    strategy = _resolve_cfg_strategy(cfg, algorithm)
    specs = leaf_specs(strategy, (abstract_params(cfg, jnp.bfloat16),
                                  delta_struct(cfg, jnp.bfloat16)), m)
    return sum(s.wire_bytes() for s in specs)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name,algorithm,knobs", [
    ("zamba2-7b", "compressed_gt", dict(compression_ratio=0.1)),
    ("granite-8b", "quantized_gt", dict(quantization_bits=8)),
])
def test_gather_census_equals_expected_bytes(fake_world, name, algorithm, knobs,
                                            multi_pod):
    cfg = _reduced(name)
    rec = dryrun.run_one(name, "train_4k", multi_pod, algorithm=algorithm,
                         wire_transport=True, runtime="async", gather_only=True,
                         cfg=cfg, **knobs)
    m = 32 if multi_pod else 16  # the fed axes' product
    assert rec["wire"]["num_agents"] == m
    assert rec["gather_census"] == {"all-gather": {
        "count": 1, "bytes": rec["expected_gather_bytes"]}}
    jax_kw = dict(wire_transport=True, **knobs)
    assert rec["expected_gather_bytes"] == _jax_expected(name, algorithm, jax_kw, m)


def test_tags_follow_jax_scheme():
    args = dryrun.parse_args(["--arch", "zamba2-7b", "--shape", "train_4k",
                              "--algorithm", "compressed_gt", "--wire-transport",
                              "--runtime", "async", "--both-meshes"])
    assert args.compression_ratio == 0.1  # the strategy's active default
    assert dryrun.tag_for(args, "zamba2-7b", "train_4k", False) == \
        "zamba2-7b__train_4k__16x16__compressed_gt__r0.1__wire__async"
    args = dryrun.parse_args(["--arch", "granite-8b", "--shape", "decode_32k",
                              "--multi-pod", "--variant", "megatron"])
    assert dryrun.tag_for(args, "granite-8b", "decode_32k", True) == \
        "granite-8b__decode_32k__2x16x16__megatron"


def test_main_writes_one_record_per_tag(fake_world, tmp_path, monkeypatch):
    """`main` on a reduced config (the registry's full ones are the chip's
    dryrun phase)."""
    monkeypatch.setattr(dryrun, "get_config", lambda name: _reduced(name))
    out = dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                       "--out", str(tmp_path)])
    tag = "gemma2-2b__decode_32k__16x16"
    assert list(out) == [tag] and (tmp_path / f"{tag}.json").exists()
