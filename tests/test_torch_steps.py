"""The SPMD step builders (`repro_torch.launch.steps`) on real gloo worlds
of CPU ranks, against the port's unsharded round and JAX's builders.

One `torch.multiprocessing.spawn`ed world of 8 ranks, a (2, 2, 2) mesh
over ("pod", "data", "model"), runs every step of this module once,
module-scoped.  Each pod's (2, 2) submesh over ("data", "model") runs
half of the steps, the two halves at once; then all 8 ranks run the pod
cases: a FedGDA-GT round of 4 agents on the whole mesh (the train step
runs it on `agents_mesh`, ("pod", "data") flattened into one agents'
dim), and the async gather over the fed axes ("pod", "data") as one
flattened mesh dim, a real all-gather of the packed payloads, decoded
against JAX's `build_gather_decode_step` bit for bit, its census one
all-gather of `expected_gather_bytes`.  The ranks meet on a
`FileStore` under the test's tmp_path, never on a TCP port, so
concurrent test workers cannot collide, and they import no JAX: the
parent hands them JAX's weights (`convert.model_tree_from_numpy`) and
data as plain tensors that every rank holds whole.  Each step places
them by the rules and returns its outputs gathered (`full_tensor`).
Held against:

  * the port's own round without sharding, on the same inputs (isolates
    the sharding: the sharded reductions sum in another order);
  * JAX's builders on `make_host_mesh(2, 2)` (the pod case:
    `jax.make_mesh((2, 2, 2), ("pod", "data", "model"))`) over the
    conftest's 8 emulated devices, one round from the same iterate, each
    leaf within RTOL of its max |value| (tests/test_torch_train.py's);
  * strategy state bit for bit (the quantizer's key), its error-feedback
    buffers within RTOL.

Steps: FedGDA-GT rounds of reduced granite-8b and zamba2-7b (a Mamba-2
hybrid with its shared attention block), QuantizedGT's stateful round,
CompressedGT's top-k and rand-k rounds, the elastic round (tracker table,
budgets, weights), and prefill plus two decode steps of granite-8b and
zamba2-7b.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import model_tree_from_numpy, strategy_state_from_numpy
from repro_torch.core.engine import default_update, make_round
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.problems import delta_projection, make_adversarial_loss

pytestmark = pytest.mark.torch

RTOL = 1e-4  # of each leaf's max |value| (tests/test_torch_train.py's)
K, ETA, B_LOCAL, SEQ = 2, 2e-3, 1, 8
REMAT = False  # the chip's spmd_train runs remat; here fewer ops, a faster world
SERVE_B, SERVE_S, SERVE_N = 2, 16, 3
#: key -> (config, algorithm: a name or a strategy made from the module
#: `F` (the JAX package's `repro.fed` or the port's `repro_torch.fed`),
#: config knobs)
TRAIN = {"train_granite": ("granite-8b", "fedgda_gt", {}),
         "train_zamba2": ("zamba2-7b", "fedgda_gt", {}),
         "train_quantized": ("granite-8b", "quantized_gt", {"quantization_bits": 8}),
         "train_compressed": ("granite-8b", "compressed_gt", {"compression_ratio": 0.25}),
         "train_randk": ("granite-8b", lambda F: F.CompressedGT(
             compression_ratio=0.25, mode="randk", seed=2), {}),
         "elastic_granite": ("granite-8b", "fedgda_gt", {})}
#: the rounds held to JAX's iterates: the port numbers a model tree's
#: leaves as JAX's stacked tree does, so QuantizedGT's rounding and
#: rand-k's kept indices are JAX's draws
JAX_ROUNDS = ("train_granite", "train_zamba2", "train_compressed", "train_quantized",
              "train_randk", "elastic_granite")
#: top-k picks by magnitude, so an f32 difference can swap a near-tie; in
#: f64 none of these rows' ties falls within rounding noise.  The flash
#: kernel takes f32 / bf16, so the f64 round runs the plain versions
#: (`use_kernel=False`, on both sides)
DTYPES = {"train_compressed": "float64"}
SERVE = {"serve_granite": "granite-8b", "serve_zamba2": "zamba2-7b"}
#: the steps each pod's (2, 2) submesh runs, split so the halves take
#: about as long (each pod's first round of a dtype pays DTensor's
#: sharding propagation for its ops)
POD_STEPS = (("train_granite", "train_quantized", "elastic_granite", "serve_granite"),
             ("train_compressed", "train_randk", "train_zamba2", "serve_zamba2"))
POD_M = 4  # agents: the ("pod", "data") product of the (2, 2, 2) mesh
#: the round all 8 ranks run on the (2, 2, 2) mesh, POD_M agents
POD_TRAIN = ("granite-8b", "fedgda_gt", {})


def _cfg(name, knobs):
    return dataclasses.replace(get_config(name).reduced(), **knobs)


def _spec(key):
    """A train key's (config, algorithm, knobs); "train_pod" is POD_TRAIN."""
    return POD_TRAIN if key == "train_pod" else TRAIN[key]


def _alg(algorithm, F):
    """A TRAIN algorithm for the fed module F: a name, or the strategy."""
    return algorithm(F) if callable(algorithm) else algorithm


def _cfgs(name, knobs):
    from repro.configs import get_config as jget_config

    return _cfg(name, knobs), dataclasses.replace(jget_config(name).reduced(), **knobs)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _train_inputs(name, m, knobs, algorithm, dtype="float32"):
    """JAX's weights and zero delta, token batches [m, B, S] from a seed,
    and for a stateful strategy JAX's initial state (numpy)."""
    import jax
    import jax.numpy as jnp

    import repro.fed as jfed
    from repro.launch import steps as jsteps
    from repro.models import init_params as jinit_params

    _, jcfg = _cfgs(name, knobs)
    algorithm = _alg(algorithm, jfed)
    x = _np(jinit_params(jax.random.PRNGKey(0), jcfg, getattr(jnp, dtype)))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jcfg.vocab_size, (m, B_LOCAL, SEQ)).astype(np.int32)
    out = {"x": x, "y": {"delta": np.zeros(jcfg.d_model, dtype)},
           "batch": {"tokens": tok, "labels": np.roll(tok, -1, -1)}}
    strategy = jsteps._resolve_cfg_strategy(jcfg, algorithm)
    if strategy.stateful:
        out["state"] = _np(strategy.init_state(jax.tree.map(jnp.asarray, x),
                                               jax.tree.map(jnp.asarray, out["y"]), m))
    return out


def _elastic_extra(m):
    return {"weights": np.full(m, 1.0 / m, np.float32),
            "budgets": np.arange(m, dtype=np.int32) % K + 1,
            "active": np.ones(m, bool), "prev_active": np.ones(m, bool)}


def _serve_inputs(name):
    import jax
    import jax.numpy as jnp

    from repro.models import init_params as jinit_params

    _, jcfg = _cfgs(name, {})
    x = _np(jinit_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(6)
    tok = rng.integers(0, jcfg.vocab_size, (SERVE_B, SERVE_S + SERVE_N)).astype(np.int32)
    return {"x": x, "tokens": tok}


def _port_tree(cfg, x):
    return model_tree_from_numpy(cfg, x, "cpu")


def _agents_to_port(cfg, tree):
    """A JAX agent-stacked model tree ([m, n_per, ...] under "blocks") in
    the port's layout (one [m, ...] leaf per layer)."""
    t = dict(tree)
    t["blocks"] = tree_map(lambda a: np.moveaxis(np.asarray(a), 1, 0), tree["blocks"])
    return _port_tree(cfg, t)


def _state_to_port(cfg, state):
    """A JAX strategy state (numpy) as the port's: keys as `prng` keys,
    the error-feedback buffer of x in the port's layout."""
    out = strategy_state_from_numpy({k: v for k, v in state.items() if k != "ex"},
                                    "cpu")
    if "ex" in state:
        out["ex"] = _agents_to_port(cfg, state["ex"])
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ------------------------------------------------------------ the ranks
def _rank_inputs(key, inp):
    """A step's numpy inputs as the port's plain tensors, made before the
    spawn so that the ranks need no JAX."""
    if key == "gather_pod":
        from repro_torch.fed.transport import LeafPayload

        return [LeafPayload(*(None if b is None else _t(b) for b in p))
                for p in inp["payloads"]]
    if key in SERVE:
        return {"x": _port_tree(_cfg(SERVE[key], {}), inp["x"]), "tokens": _t(inp["tokens"])}
    name, _, knobs = _spec(key)
    cfg = _cfg(name, knobs)
    out = {"x": _port_tree(cfg, inp["x"]), "y": tree_map(_t, inp["y"]),
           "batch": tree_map(_t, inp["batch"])}
    if "state" in inp:
        out["state"] = _state_to_port(cfg, inp["state"])
    if "tracker" in inp:
        out["tracker"] = {"gx": _agents_to_port(cfg, inp["tracker"]["gx"]),
                          "gy": tree_map(_t, inp["tracker"]["gy"])}
        out["extra"] = {k: _t(v) for k, v in inp["extra"].items()}
    return out


def _run_world(rank, world, store_path, inputs, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import steps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    pod = mesh.get_coordinate()[0]
    sub = mesh["data", "model"]  # this pod's (2, 2) mesh
    full = lambda tree: tree_map(lambda u: u.full_tensor() if hasattr(u, "full_tensor")
                                 else u, tree)
    results = {}
    for key in POD_STEPS[pod]:
        t0 = time.perf_counter()
        inp = inputs[key]
        if key in SERVE:
            results[key] = _serve_on(steps, _cfg(SERVE[key], {}), sub, inp, full)
        else:
            results[key] = full(_train_on(steps, key, sub, inp))
        if tuple(sub.get_coordinate()) == (0, 0):
            print(f"[spmd] pod {pod} {key} {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    results["train_pod"] = full(_train_on(steps, "train_pod", mesh, inputs["train_pod"]))
    if mesh.get_rank() == 0:
        print(f"[spmd] (2, 2, 2) train_pod {time.perf_counter() - t0:.1f}s", flush=True)
    results["gather_pod"] = _gather_on(mesh, inputs["gather_pod"])
    if tuple(sub.get_coordinate()) == (0, 0):  # one rank of each pod writes its half
        torch.save(results, f"{out_path}.{pod}")
    dist.barrier()
    dist.destroy_process_group()


def _train_on(steps, key, mesh, inp):
    from repro_torch import fed

    name, algorithm, knobs = _spec(key)
    cfg = _cfg(name, knobs)
    kw = dict(algorithm=_alg(algorithm, fed), num_local_steps=K, eta=ETA,
              dtype=getattr(torch, DTYPES.get(key, "float32")), remat=REMAT,
              use_kernel=key not in DTYPES)
    if key.startswith("elastic"):
        step_for, _ = steps.build_elastic_train_step(cfg, mesh, **kw)
        ex = inp["extra"]
        return step_for(None)(inp["x"], inp["y"], inp["batch"], {}, inp["tracker"],
                              ex["weights"], ex["budgets"], ex["active"],
                              ex["prev_active"])
    step_for, _ = steps.build_train_step(cfg, mesh, **kw)
    args = (inp["x"], inp["y"], inp["batch"])
    if "state" in inp:
        args += (inp["state"],)
    return step_for(None)(*args)


def _serve_on(steps, cfg, mesh, inp, full):
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import init_caches

    params, tok = inp["x"], inp["tokens"]
    cap = SERVE_S + SERVE_N
    prefill_for, _ = steps.build_prefill_step(cfg, mesh, dtype=torch.float32)
    decode_for, _ = steps.build_decode_step(cfg, mesh, dtype=torch.float32)
    batch = {"tokens": tok[:, :SERVE_S], "labels": tok[:, :SERVE_S]}
    with torch.no_grad():
        logits, caches = prefill_for(ShapeConfig("p", SERVE_S, SERVE_B, "prefill"))(
            params, batch, init_caches(cfg, SERVE_B, cap, torch.float32, "cpu"))
        out = [full(logits)]
        step = decode_for(ShapeConfig("d", cap, SERVE_B, "decode"))
        for i in range(SERVE_N - 1):
            logits, caches = step(params, caches, tok[:, SERVE_S + i:SERVE_S + i + 1],
                                  SERVE_S + i)
            out.append(full(logits))
    return out


# the pod case: the async gather on the (2, 2, 2) mesh
GATHER_X = {"a": (32, 40), "b": (40,)}
GATHER_Y = {"delta": (24,)}
GATHER_KW = dict(compression_ratio=0.25, wire_transport=True)


def _gather_inputs():
    """JAX's packed payloads of random corrections for POD_M agents
    (compressed_gt 0.25 over the wire, top-k: no uniforms), as numpy."""
    import jax.numpy as jnp

    from repro.fed.strategies import resolve_strategy
    from repro.fed.transport import encode_leaf
    from repro.launch.multihost import leaf_specs

    strategy = resolve_strategy("compressed_gt", **GATHER_KW)
    x = {k: jnp.zeros(v, jnp.float32) for k, v in GATHER_X.items()}
    y = {k: jnp.zeros(v, jnp.float32) for k, v in GATHER_Y.items()}
    rng = np.random.default_rng(9)
    payloads = []
    for spec in leaf_specs(strategy, (x, y), POD_M):
        c = jnp.asarray(rng.standard_normal((spec.rows, spec.cols)).astype(np.float32))
        payload, _ = encode_leaf(c, None, None, None, spec)
        payloads.append(tuple(None if b is None else np.asarray(b) for b in payload))
    return {"payloads": payloads}


def _port_gather(mesh):
    from repro_torch.fed.strategies import resolve_strategy
    from repro_torch.launch.multihost import build_gather_decode_step

    strategy = resolve_strategy("compressed_gt", **GATHER_KW)
    x = {k: torch.zeros(v) for k, v in GATHER_X.items()}
    y = {k: torch.zeros(v) for k, v in GATHER_Y.items()}
    return build_gather_decode_step(strategy, x, y, mesh, ("pod", "data"))


def _gather_on(mesh, payloads):
    from repro_torch.launch.census import Census

    step, _, expected = _port_gather(mesh)
    with Census() as census:
        out = step(payloads)
    return {"decoded": [u.full_tensor() for u in out], "expected": expected,
            "census": census.summary()["collectives_executed"]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every step's inputs (numpy) and the world's outputs."""
    import jax
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("spmd")
    inputs = {}
    for key, (name, algorithm, knobs) in TRAIN.items():
        inputs[key] = _train_inputs(name, 2, knobs, algorithm, DTYPES.get(key, "float32"))
    inputs["train_pod"] = _train_inputs(POD_TRAIN[0], POD_M, POD_TRAIN[2], POD_TRAIN[1])
    m = 2
    x = inputs["elastic_granite"]["x"]
    # a nonzero tracker table: the agents' anchor gradients of an earlier round
    rng = np.random.default_rng(8)
    stack = lambda t: jax.tree.map(
        lambda a: (rng.standard_normal((m,) + a.shape) * 1e-3).astype(np.float32), t)
    inputs["elastic_granite"]["tracker"] = {"gx": stack(x),
                                            "gy": stack(inputs["elastic_granite"]["y"])}
    inputs["elastic_granite"]["extra"] = _elastic_extra(m)
    for key, name in SERVE.items():
        inputs[key] = _serve_inputs(name)
    inputs["gather_pod"] = _gather_inputs()
    rank_inputs = {k: _rank_inputs(k, v) for k, v in inputs.items()}
    out_path = str(tmp / "world8.pt")
    world = mp.start_processes(_run_world, nprocs=8, join=False, start_method="spawn",
                               args=(8, str(tmp / "world8.store"), rank_inputs, out_path))
    try:  # JAX's builders run here while the ranks run theirs
        want = {key: _jax_round(key, inputs[key]) for key in JAX_ROUNDS}
        want.update({key: _jax_serve(SERVE[key], inputs[key]) for key in SERVE})
    finally:
        while not world.join():
            pass
    out = {}
    for pod in (0, 1):
        out.update(torch.load(f"{out_path}.{pod}", weights_only=False))
    return {"inputs": inputs, "out": out, "jax": want}


# ----------------------------------------------------------- reference
def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |err| {err:.3e} > {RTOL} x {scale:.3e}"


def _port_round(key, inp):
    from repro_torch import fed
    from repro_torch.launch.steps import _resolve_cfg_strategy

    name, algorithm, knobs = _spec(key)
    cfg, _ = _cfgs(name, knobs)
    strategy = _resolve_cfg_strategy(cfg, _alg(algorithm, fed), use_kernel=key not in DTYPES)
    loss = make_adversarial_loss(cfg, remat=REMAT, use_kernel=key not in DTYPES)
    x, y = _port_tree(cfg, inp["x"]), tree_map(_t, inp["y"])
    batch = tree_map(_t, inp["batch"])
    if key.startswith("elastic"):
        from repro_torch.sim.elastic import make_elastic_round

        rnd = make_elastic_round(loss, strategy, K, ETA, proj_y=delta_projection(1.0))
        ex = {k: _t(v) for k, v in inp["extra"].items()}
        tracker = {"gx": _agents_to_port(cfg, inp["tracker"]["gx"]),
                   "gy": tree_map(_t, inp["tracker"]["gy"])}
        return rnd(x, y, batch, {}, tracker, ex["weights"], ex["budgets"], ex["active"],
                   ex["prev_active"])
    rnd = make_round(loss, strategy, K, ETA, proj_y=delta_projection(1.0),
                     update_fn=None if key not in DTYPES else default_update,
                     explicit_state=strategy.stateful)
    if strategy.stateful:
        return rnd(x, y, batch, _state_to_port(cfg, inp["state"]))
    return rnd(x, y, batch)


def _jax_round(key, inp):
    import jax
    import jax.numpy as jnp

    import repro.fed as jfed
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh

    name, algorithm, knobs = TRAIN[key]
    _, jcfg = _cfgs(name, knobs)
    mesh = jmake_host_mesh(2, 2)
    shape = JShapeConfig("t", SEQ, B_LOCAL * inp["batch"]["tokens"].shape[0], "train")
    kw = dict(algorithm=_alg(algorithm, jfed), num_local_steps=K, eta=ETA,
              dtype=getattr(jnp, DTYPES.get(key, "float32")), remat=REMAT)
    arr = lambda t: jax.tree.map(jnp.asarray, t)
    with jax.set_mesh(mesh):
        if key.startswith("elastic"):
            jit_for, _ = jsteps.build_elastic_train_step(jcfg, mesh, **kw)
            ex = inp["extra"]
            out = jit_for(shape)(arr(inp["x"]), arr(inp["y"]), arr(inp["batch"]), {},
                                 arr(inp["tracker"]), jnp.asarray(ex["weights"]),
                                 jnp.asarray(ex["budgets"]), jnp.asarray(ex["active"]),
                                 jnp.asarray(ex["prev_active"]))
        else:
            jit_for, _ = jsteps.build_train_step(jcfg, mesh, **kw)
            args = [arr(inp["x"]), arr(inp["y"]), arr(inp["batch"])]
            if "state" in inp:
                args.append(arr(inp["state"]))
            out = jit_for(shape)(*args)
    return _np(out)


def _jax_x_leaves(key, jx):
    """JAX's x as the port's tree's leaves (unstacked, port order)."""
    name, _, knobs = TRAIN[key]
    cfg, _ = _cfgs(name, knobs)
    return tree_leaves(_port_tree(cfg, jx))


@pytest.mark.parametrize("key", [*TRAIN, "train_pod"])
def test_train_step_equals_the_unsharded_round(worlds, key):
    """Each round on a pod's (2, 2) mesh, and train_pod's on the (2, 2, 2)
    mesh (its agents over the flattened ("pod", "data")), against the
    port's round on the same inputs without sharding."""
    got = worlds["out"][key]
    want = _port_round(key, worlds["inputs"][key])
    for i, (g, w) in enumerate(zip(tree_leaves(got[:2]), tree_leaves(want[:2]))):
        _close(g, w, f"{key} leaf {i}")
    if key.startswith("elastic"):  # the updated tracker table
        for i, (g, w) in enumerate(zip(tree_leaves(got[3]), tree_leaves(want[3]))):
            _close(g, w, f"{key} tracker leaf {i}")


@pytest.mark.parametrize("key", JAX_ROUNDS)
def test_train_step_equals_jax_builders(worlds, key):
    got = worlds["out"][key]
    want = worlds["jax"][key]
    gx = tree_leaves(got[0])
    wx = _jax_x_leaves(key, want[0])
    assert len(gx) == len(wx)
    for i, (g, w) in enumerate(zip(gx, wx)):
        _close(g, w, f"{key} x leaf {i}")
    _close(got[1]["delta"], want[1]["delta"], f"{key} delta")
    if key.startswith("elastic"):  # the tracker table, in the port's layout
        name, _, knobs = TRAIN[key]
        cfg, _ = _cfgs(name, knobs)
        wt = tree_leaves(_agents_to_port(cfg, want[3]["gx"])) + tree_leaves(
            tree_map(_t, want[3]["gy"]))
        for i, (g, w) in enumerate(zip(tree_leaves(got[3]), wt)):
            _close(g, w, f"{key} tracker leaf {i}")


@pytest.mark.parametrize("key", ["train_compressed", "train_randk"])
def test_stateful_step_state_equals_jax(worlds, key):
    """The stateful rounds' state after the sharded round: QuantizedGT's
    and rand-k's keys bit for bit; CompressedGT's error-feedback buffers
    within RTOL and its kept entries (where the feedback is zero) bit for
    bit, for rand-k the positions of JAX's draws."""
    cfg, _ = _cfgs("granite-8b", {"quantization_bits": 8})
    got = worlds["out"]["train_quantized"][2]
    want = _state_to_port(cfg, worlds["jax"]["train_quantized"][2])
    assert set(got) == set(want)
    assert torch.equal(got["key"], want["key"])
    name, _, knobs = TRAIN[key]
    cfg, _ = _cfgs(name, knobs)
    got = worlds["out"][key][2]
    want = _state_to_port(cfg, worlds["jax"][key][2])
    assert set(got) == set(want) >= {"ex", "ey"}
    if "key" in want:
        assert torch.equal(got["key"], want["key"])
    for name in ("ex", "ey"):
        for i, (g, w) in enumerate(zip(tree_leaves(got[name]), tree_leaves(want[name]))):
            _close(g, w, f"{name} leaf {i}")
            assert torch.equal(g == 0, w == 0), f"{name} leaf {i}: kept entries"


def _jax_serve(name, inp):
    import jax
    import jax.numpy as jnp

    from repro.configs import ShapeConfig as JShapeConfig
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.models import init_caches as jinit_caches

    _, jcfg = _cfgs(name, {})
    mesh = jmake_host_mesh(2, 2)
    cap = SERVE_S + SERVE_N
    # numpy inputs: uncommitted, so jit places them
    tok = np.asarray(inp["tokens"])
    x = inp["x"]
    caches = _np(jinit_caches(jcfg, SERVE_B, cap, jnp.float32))
    with jax.set_mesh(mesh):
        jit_p, specs_p = jsteps.build_prefill_step(jcfg, mesh, dtype=jnp.float32)
        batch = {"tokens": tok[:, :SERVE_S], "labels": tok[:, :SERVE_S]}
        logits, caches = jit_p(JShapeConfig("p", SERVE_S, SERVE_B, "prefill"))(
            x, batch, caches)
        out = [np.asarray(logits)]
        jit_d, _ = jsteps.build_decode_step(jcfg, mesh, dtype=jnp.float32)
        step = jit_d(JShapeConfig("d", cap, SERVE_B, "decode"))
        for i in range(SERVE_N - 1):
            logits, caches = step(x, caches, tok[:, SERVE_S + i:SERVE_S + i + 1],
                                  np.int32(SERVE_S + i))
            out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("key", list(SERVE))
def test_serve_steps_equal_jax_and_the_plain_path(worlds, key):
    """Prefill and decode on the 2x2 mesh against JAX's builders and the
    port's serving path without sharding (`launch.serve`), logits within
    RTOL of their max."""
    from repro_torch.launch import serve
    from repro_torch.models import init_caches

    got = worlds["out"][key]
    inp = worlds["inputs"][key]
    want = worlds["jax"][key]
    cfg, _ = _cfgs(SERVE[key], {})
    tok = _t(inp["tokens"])
    plain = serve.generate(_port_tree(cfg, inp["x"]), cfg, {"tokens": tok[:, :SERVE_S]},
                           init_caches(cfg, SERVE_B, SERVE_S + SERVE_N, torch.float32,
                                       "cpu"),
                           SERVE_N, forced=tok[:, SERVE_S:SERVE_S + SERVE_N])
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{key} step {i} vs JAX")
        _close(g[:, -1], plain["step_logits"][:, i], f"{key} step {i} vs plain")


def test_pod_gather_equals_jax_and_moves_the_payload_once(worlds):
    """The (2, 2, 2) world's gather: one all-gather over the flattened
    ("pod", "data") dim whose result is the packed payload, decoded bit
    for bit as JAX's gather step decodes the same payloads."""
    import jax
    import jax.numpy as jnp

    from repro.fed.strategies import resolve_strategy
    from repro.launch.multihost import build_gather_decode_step

    got = worlds["out"]["gather_pod"]
    assert got["census"] == {"all-gather": {"count": 1, "bytes": got["expected"]}}
    strategy = resolve_strategy("compressed_gt", **GATHER_KW)
    x = {k: jnp.zeros(v, jnp.float32) for k, v in GATHER_X.items()}
    y = {k: jnp.zeros(v, jnp.float32) for k, v in GATHER_Y.items()}
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    jitted, (structs,), expected = build_gather_decode_step(strategy, x, y, mesh,
                                                            ("pod", "data"))
    assert expected == got["expected"]
    payloads = [type(s)(*(None if b is None else jnp.asarray(b) for b in p))
                for s, p in zip(structs, worlds["inputs"]["gather_pod"]["payloads"])]
    want = jitted(payloads)
    assert len(want) == len(got["decoded"])
    for g, w in zip(got["decoded"], want):
        assert torch.equal(g, _t(np.asarray(w)))


def test_spawned_world_left_no_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
