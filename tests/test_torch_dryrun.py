"""The executed-op census (`repro_torch.launch.census`, the counterpart of
`repro.launch.hlo_census`) and the production-mesh dry-run on a fake
world (`repro_torch.launch.dryrun`), on the CPU.

The census cases mirror tests/test_hlo_census.py: a K-step loop of
matmuls (the port runs every loop, so its counts are executed counts
with no trip-count scaling), one matmul, collectives in a loop, duplicate
shapes; and a DTensor op's first call, whose sharding propagation runs
it on `FakeTensor`s, counted as its cached calls are.  Then records held
to JAX's `run_one` of the same cells: granite-8b's full `decode_32k`, its
reduced `train_4k` (K 4), `prefill_32k` and `decode_32k` and zamba2-7b's
reduced `decode_32k` on the fake 16x16 world, and the reduced `train_4k`
on the 2x16x16 one: executed matmul FLOPs a rank within 1% (the full
record) or 5%, and collective result bytes a rank no more than 1.25x
JAX's, both printed beside JAX's.  JAX's records come from one
subprocess, as `repro.launch.dryrun` sets its 512-device `XLA_FLAGS` at
import.  Then the async gather's census against `expected_gather_bytes`
(and JAX's) on both production meshes, and `--telemetry`.
"""
import dataclasses
import json
import os
import subprocess
import sys

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


def test_census_counts_a_cached_op_as_its_first_call(fake_world):
    """DTensor propagates a new op signature by running the op on
    `FakeTensor`s at its global shapes (once; later calls hit its cache):
    the census counts only the local op, so both calls count alike."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu")
    # shapes no other test propagates, so the first call is uncached
    a = distribute_tensor(torch.empty(96, 40, device="meta"), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    b = distribute_tensor(torch.empty(40, 32, device="meta"), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    counts = []
    for _ in range(2):
        with Census() as c:
            torch.mm(a, b)
        counts.append(c.summary())
    assert counts[0] == counts[1]
    assert counts[0]["executed_dot_flops"] == 2 * (96 // 16) * 40 * (32 // 16)


def _reduced(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), **kw)


#: (arch, shape, full config, multi-pod) of the records held to JAX's
RECORDS = {
    "granite_decode_full": ("granite-8b", "decode_32k", True, False),
    "granite_train": ("granite-8b", "train_4k", False, False),
    "granite_prefill": ("granite-8b", "prefill_32k", False, False),
    "granite_decode": ("granite-8b", "decode_32k", False, False),
    # the plain scan steps through 32k positions on meta: decode alone
    "zamba2_decode": ("zamba2-7b", "decode_32k", False, False),
    "granite_train_2x16x16": ("granite-8b", "train_4k", False, True),
}
#: JAX's census counts a conditional's branches at every trip (an upper
#: bound, `HloCensus`), so its zamba2 record counts the shared attention
#: block at every layer, where the reduced model (2 layers, the block
#: after every 2nd) runs it once: the port's record held to it runs the
#: block after every layer (`shared_attn_every` 1); the port's own record
#: (`zamba2_decode_as_run`) stays below that bound
PORT_KNOBS = {"zamba2_decode": {"shared_attn_every": 1}}
#: executed matmul FLOPs a rank against JAX's, relative; collective result
#: bytes a rank at most this multiple of JAX's
FLOPS_RTOL = {"granite_decode_full": 0.01}
FLOPS_RTOL_REDUCED = 0.05
BYTES_FACTOR = 1.25

_JAX_RECORDS = """
import json, sys
import repro.launch.dryrun as jd
from repro.configs import get_config
records = json.loads(sys.argv[1])
out = {}
for key, (arch, shape, full, multi_pod) in records.items():
    jd.get_config = get_config if full else (lambda n: get_config(n).reduced())
    rec = jd.run_one(arch, shape, multi_pod)
    out[key] = {"flops": rec["census"]["executed_dot_flops"],
                "collectives": rec["census"]["collectives_executed"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_and_port_records(fake_world):
    """JAX's records from one subprocess (started first, run meanwhile) and
    the port's, by RECORDS key."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RECORDS, json.dumps(RECORDS)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    port = {}
    try:
        for key, (arch, shape, full, multi_pod) in RECORDS.items():
            cfg = get_config(arch) if full else _reduced(arch)
            port[key] = dryrun.run_one(
                arch, shape, multi_pod,
                cfg=dataclasses.replace(cfg, **PORT_KNOBS.get(key, {})))
            if key in PORT_KNOBS:
                port[key + "_as_run"] = dryrun.run_one(arch, shape, multi_pod, cfg=cfg)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    dryrun.fake_world(256)  # the module's world again
    assert proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), port


def _bytes(coll):
    return sum(v["bytes"] for v in coll.values())


def _check_record(records, key):
    """Executed matmul FLOPs a rank within FLOPS_RTOL of JAX's, collective
    result bytes a rank at most BYTES_FACTOR of JAX's (both printed beside
    JAX's), the record's own fields consistent."""
    jax_recs, port = records
    rec, want = port[key], jax_recs[key]
    arch, shape, full, multi_pod = RECORDS[key]
    got_flops = rec["census"]["executed_dot_flops"]
    got_bytes, want_bytes = _bytes(rec["collectives"]), _bytes(want["collectives"])
    print(f"\n{key}: flops {got_flops:.4e} (JAX {want['flops']:.4e}); collective "
          f"bytes {got_bytes:.4e} (JAX {want_bytes:.4e}); port "
          f"{rec['collectives']}; JAX {want['collectives']}")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["kernels"] == "plain (meta)" and rec["argument_bytes_per_rank"] > 0
    assert rec["collectives"] == rec["census"]["collectives_executed"]
    rtol = FLOPS_RTOL.get(key, FLOPS_RTOL_REDUCED)
    assert abs(got_flops - want["flops"]) <= rtol * want["flops"]
    assert 0 < got_bytes <= BYTES_FACTOR * want_bytes
    if key in PORT_KNOBS:
        assert 0 < port[key + "_as_run"]["census"]["executed_dot_flops"] < got_flops


def test_full_decode_dryrun_equals_jax(jax_and_port_records):
    """granite-8b's full decode_32k: its executed FLOPs a rank are JAX's
    within 1% (the census once counted DTensor's propagation too: 10x)."""
    _check_record(jax_and_port_records, "granite_decode_full")


@pytest.mark.parametrize("name,keys", [
    ("granite-8b", ("granite_prefill", "granite_decode")),
    ("zamba2-7b", ("zamba2_decode",))])
def test_reduced_dryrun_serve_steps(jax_and_port_records, name, keys):
    for key in keys:
        _check_record(jax_and_port_records, key)
    port = jax_and_port_records[1]
    if len(keys) == 2:  # decode runs one position of a 32k prefill's
        assert (port["granite_decode"]["census"]["executed_dot_flops"] * 1000
                < port["granite_prefill"]["census"]["executed_dot_flops"])


def test_reduced_dryrun_train_round(jax_and_port_records):
    """One FedGDA-GT round (K 4) of the reduced granite-8b, m = 16 agents
    over the data axis."""
    _check_record(jax_and_port_records, "granite_train")
    assert jax_and_port_records[1]["granite_train"]["num_local_steps"] == 4


def test_reduced_dryrun_train_round_on_2x16x16(jax_and_port_records):
    """The same round on the 2x16x16 mesh, m = 32 agents over ("pod",
    "data") flattened into one mesh dim (`mesh.agents_mesh`)."""
    _check_record(jax_and_port_records, "granite_train_2x16x16")


def test_decode_looks_tokens_up_on_the_vocab_shards(jax_and_port_records):
    """The full decode step moves no embedding table: its largest
    all-gather is far below the vocab-sharded table's bytes (49152 x 4096
    in bf16), which a lookup by indexing would gather."""
    _, port = jax_and_port_records
    coll = port["granite_decode_full"]["collectives"]
    ag = coll.get("all-gather", {"count": 0, "bytes": 0})
    assert ag["bytes"] < 49152 * 4096 * 2 // 16


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


def test_main_telemetry_writes_a_manifest_and_one_event_a_tag(fake_world, tmp_path,
                                                              monkeypatch):
    """`--telemetry DIR` (JAX's dryrun.py flag): a `RunLedger` manifest of
    the resolved flags and one "dryrun" event a tag, with the port's
    counterparts of JAX's fields (trace seconds for lower / compile
    seconds, the inputs' bytes a rank for the memory analysis)."""
    from repro_torch.obs import RunLedger

    monkeypatch.setattr(dryrun, "get_config", lambda name: _reduced(name))
    tel = str(tmp_path / "tel")
    out = dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--both-meshes",
                       "--out", str(tmp_path / "recs"), "--telemetry", tel])
    manifest = RunLedger.manifest(tel)
    assert manifest["config"]["arch"] == "gemma2-2b"
    assert manifest["config"]["both_meshes"] and manifest["config"]["telemetry"] == tel
    events = RunLedger.events(tel)
    assert [e["tag"] for e in events] == list(out) == [
        "gemma2-2b__decode_32k__16x16", "gemma2-2b__decode_32k__2x16x16"]
    for e in events:
        rec = out[e["tag"]]
        assert e["kind"] == "event" and e["name"] == "dryrun"
        assert e["trace_s"] == rec["trace_s"] > 0
        assert e["collectives"] == rec["collectives"]
        assert e["argument_bytes_per_rank"] == rec["argument_bytes_per_rank"] > 0
