"""The LM training path's data and rounds against the JAX package, and the
port's training entry point (`python -m repro_torch.launch.train`).

  * `synthetic_lm_batch` and `federated_token_batches` equal JAX's bit
    for bit over several seeds and shapes (the Gumbel draw is JAX's
    uniforms under torch's two logs: a near-tie could flip a token, and
    none does on these draws); `tests/test_system.py::TestDataPipeline`
    ported.
  * Three FedGDA-GT rounds at K = 2 per architecture (gemma2-2b,
    zamba2-7b, falcon-mamba-7b, granite-8b, llama4-scout (MoE),
    pixtral-12b (vision_text) and hubert-xlarge (audio) reduced, remat
    on) from JAX's weights on JAX's data, against JAX's `make_round`,
    round by round from JAX's iterates: each leaf of x and y within 1e-4
    of its max |value|.  The data is JAX's token batches, or for the two
    frontends JAX's `random_batch` per agent (frames; patches before
    tokens), as `tests/test_archs_smoke.py` TestTrainRound trains them.
  * `launch.train --reduced --device cpu` through its sync, async,
    population and telemetry routes, and a checkpointed run resumed
    equal to the uninterrupted one, bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.engine import make_round as jmake_round
from repro.data import federated_token_batches as jfederated_token_batches
from repro.data import partition_among_agents as jpartition
from repro.data.tokens import synthetic_lm_batch as jsynthetic_lm_batch
from repro.fed.strategies import resolve_strategy as jresolve_strategy
from repro.models import init_params as jinit_params
from repro.models import random_batch as jrandom_batch
from repro.problems.adversarial import delta_projection as jdelta_projection
from repro.problems.adversarial import init_delta as jinit_delta
from repro.problems.adversarial import make_adversarial_loss as jmake_adversarial_loss
from repro_torch import prng
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import model_tree_from_numpy, tree_from_numpy
from repro_torch.core.engine import make_round
from repro_torch.core.types import tree_leaves
from repro_torch.data import (
    federated_token_batches,
    partition_among_agents,
    synthetic_lm_batch,
)
from repro_torch.fed.strategies import resolve_strategy
from repro_torch.launch import train
from repro_torch.problems import delta_projection, make_adversarial_loss

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

RTOL = 1e-4  # of each leaf's max |value|, every round
ARCHS = ["gemma2-2b", "zamba2-7b", "falcon-mamba-7b", "granite-8b",
         "llama4-scout-17b-a16e", "pixtral-12b", "hubert-xlarge"]


def close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |err| {err:.3e} > {RTOL} x {scale:.3e}"


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,shape", [
    (0, (2, 16, 97)), (1, (3, 33, 512)), (7, (4, 128, 512)), (3, (1, 8, 32000)),
    (11, (2, 5, 1)), (12, (5, 2, 3)),
])
def test_synthetic_lm_batch_equals_jax_bit_for_bit(seed, shape):
    b, s, v = shape
    want = jsynthetic_lm_batch(jax.random.PRNGKey(seed), b, s, v, skew=5)
    got = synthetic_lm_batch(prng.PRNGKey(seed), b, s, v, skew=5, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        flips = int((got[k].numpy() != np.asarray(want[k])).sum())
        assert flips == 0, f"{k}: {flips} of {b * s} tokens differ"


@pytest.mark.parametrize("seed,m,het", [(1, 4, 11), (5, 3, 0), (9, 2, 7)])
def test_federated_token_batches_equal_jax_bit_for_bit(seed, m, het):
    want = jfederated_token_batches(jax.random.PRNGKey(seed), m, 2, 24, 256,
                                    heterogeneity=het)
    got = federated_token_batches(prng.PRNGKey(seed), m, 2, 24, 256,
                                  heterogeneity=het, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


class TestDataPipeline:
    """Port of `tests/test_system.py::TestDataPipeline`."""

    def test_federated_batches_shape_and_heterogeneity(self):
        d = federated_token_batches(prng.PRNGKey(0), num_agents=4, per_agent_batch=3,
                                    seq_len=16, vocab_size=97, heterogeneity=5,
                                    device="cpu")
        assert d["tokens"].shape == (4, 3, 16)
        assert d["labels"].shape == (4, 3, 16)
        # heterogeneity shifts marginals: agent histograms must differ
        h0 = np.bincount(d["tokens"][0].numpy().ravel(), minlength=97)
        h3 = np.bincount(d["tokens"][3].numpy().ravel(), minlength=97)
        assert np.argmax(h0) != np.argmax(h3)

    def test_partition_among_agents(self):
        data = {"a": torch.arange(12).reshape(12, 1)}
        part = partition_among_agents(data, 4)
        assert part["a"].shape == (4, 3, 1)
        np.testing.assert_array_equal(part["a"].reshape(12, 1).numpy(),
                                      data["a"].numpy())
        want = jpartition({"a": jnp.arange(12).reshape(12, 1)}, 4)
        np.testing.assert_array_equal(part["a"].numpy(), np.asarray(want["a"]))


# ------------------------------------------------------------ the rounds
@pytest.mark.parametrize("name", ARCHS)
def test_fedgda_gt_rounds_match_jax(name):
    """3 rounds of JAX's `make_round` (K = 2, 2 agents, JAX train.py's eta
    2e-3, remat on, from JAX's weights); each round of the port starts
    from JAX's iterate of the round before, and every leaf of x and delta
    lands within 1e-4 of its max |value| of JAX's next one.  (Chained, the
    port's rounds leave JAX's as fast as JAX's own rounds leave themselves
    under a 1e-6 perturbation of the weights, which the reduced Mamba
    models amplify about tenfold a round: Queue 3 item 5.)"""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    K, eta, rounds = 2, 2e-3, 3
    jp = jax.jit(jinit_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                                      jnp.float32)
    if jcfg.frontend == "text":
        jdata = jfederated_token_batches(jax.random.PRNGKey(1), 2, 2, 16,
                                         jcfg.vocab_size, heterogeneity=7)
    else:  # tests/test_archs_smoke.py's _stacked_batches
        bs = [jrandom_batch(k, jcfg, 2, 16, jnp.float32)
              for k in jax.random.split(jax.random.PRNGKey(1), 2)]
        jdata = jax.tree.map(lambda *xs: jnp.stack(xs), *bs)
    jrnd = jax.jit(jmake_round(jmake_adversarial_loss(jcfg, remat=True),
                               jresolve_strategy("fedgda_gt"), K, eta,
                               proj_y=jdelta_projection(1.0)))
    rnd = make_round(make_adversarial_loss(cfg, remat=True), resolve_strategy("fedgda_gt"),
                     K, eta, proj_y=delta_projection(1.0))
    data = tree_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")

    def port(jx, jy):
        return (model_tree_from_numpy(cfg, jax.tree.map(np.asarray, jx), "cpu"),
                tree_from_numpy(jax.tree.map(np.asarray, jy), "cpu"))

    jx, jy = jp, jinit_delta(jcfg)
    for t in range(rounds):
        x, y = rnd(*port(jx, jy), data)
        jx, jy = jrnd(jx, jy, jdata)
        want_x, want_y = port(jx, jy)
        for i, (a, b) in enumerate(zip(tree_leaves(x), tree_leaves(want_x))):
            close(a, b.numpy(), f"round {t}, x leaf {i}")
        close(y["delta"], want_y["delta"].numpy(), f"round {t}, delta")
        assert float(torch.linalg.norm(y["delta"])) > 0


# ------------------------------------------------------- the entry point
TINY = ["--reduced", "--device", "cpu", "--rounds", "2", "--local-steps", "2",
        "--agents", "2", "--per-agent-batch", "2", "--seq-len", "16",
        "--log-every", "1"]


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(u).all()) for u in tree_leaves(tree))


@pytest.mark.parametrize("route", [
    ["--arch", "gemma2-2b"],
    ["--arch", "zamba2-7b", "--runtime", "async"],
    ["--arch", "falcon-mamba-7b", "--population", "flaky"],
    ["--arch", "granite-8b", "--population", "flaky", "--no-rebase"],
    ["--arch", "gemma2-2b", "--algorithm", "quantized_gt", "--wire-transport"],
    # two layers in one pattern slot: one stacked leaf each in JAX's tree
    ["--arch", "granite-8b", "--algorithm", "quantized_gt", "--wire-transport"],
    ["--arch", "llama4-scout-17b-a16e"],
    ["--arch", "pixtral-12b", "--runtime", "async"],
], ids=["sync", "async", "population", "no-rebase", "quantized-wire",
        "quantized-wire-stacked", "moe", "vision-text-async"])
def test_launch_train_routes(route, capsys, tmp_path):
    """Each route trains two finite rounds; the wire route's `wire_bytes`
    counter equals JAX's train.py's (`measured_bytes_per_round` over JAX's
    stacked parameters, one header per JAX leaf, times the agents)."""
    wire = "--wire-transport" in route
    tel = ["--telemetry", str(tmp_path / "tel")] if wire else []
    out = train.main(TINY + route + tel)
    assert _finite(out["params"]) and _finite(out["delta"])
    assert float(torch.linalg.norm(out["delta"]["delta"])) <= 1.0 + 1e-6
    assert len(out["log"]) == 2 and all(np.isfinite(lv) for _, lv, _ in out["log"])
    assert "done." in capsys.readouterr().out
    if wire:
        from repro.fed.transport import measured_bytes_per_round as jmeasured

        events = [json.loads(ln) for ln in open(tmp_path / "tel" / "events.jsonl")]
        got = [e["value"] for e in events if e.get("name") == "wire_bytes"]
        jcfg = jget_config(route[1]).reduced()
        jstrategy = jresolve_strategy("quantized_gt", wire_transport=True)
        params = jinit_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        per_agent = int(jmeasured(jstrategy, params, jinit_delta(jcfg),
                                  int(TINY[TINY.index("--local-steps") + 1])))
        agents = int(TINY[TINY.index("--agents") + 1])
        assert got == [per_agent * agents] * 2


def test_launch_train_refuses_the_audio_frontend():
    """hubert-xlarge trains on frames; the entry point draws token
    batches (JAX's train.py fails there with a KeyError)."""
    with pytest.raises(ValueError, match="audio frontend"):
        train.main(TINY + ["--arch", "hubert-xlarge"])


def test_launch_train_telemetry_route(tmp_path):
    d = str(tmp_path / "tel")
    train.main(TINY + ["--arch", "zamba2-7b", "--telemetry", d])
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    assert manifest["config"]["arch"] == "zamba2-7b"
    events = [json.loads(ln) for ln in open(os.path.join(d, "events.jsonl"))]
    rounds = [e for e in events if e.get("kind") == "span" and e.get("name") == "round"]
    wire = [e for e in events if e.get("name") == "wire_bytes"]
    assert len(rounds) == 2 and len(wire) == 2
    assert all(e["runtime"] == "fused" for e in rounds)
    assert all(e["value"] == wire[0]["value"] > 0 for e in wire)


def test_launch_train_resume_equals_the_uninterrupted_run(tmp_path):
    """4 rounds of a stateful strategy (CompressedGT rand-k carries a key
    and error-feedback buffers) against 2, a checkpoint, and 2 more from
    it: bitwise equal."""
    argv = TINY + ["--arch", "gemma2-2b", "--rounds", "4", "--algorithm",
                   "compressed_gt", "--compression-ratio", "0.5"]
    full = train.train(train.build_parser().parse_args(argv))
    d = str(tmp_path / "ck")
    args = train.build_parser().parse_args(argv + ["--ckpt-dir", d])
    args.rounds = 2
    train.train(args, ckpt_every=2)
    step, path = latest_checkpoint(d)
    assert step == 2
    ck = restore_checkpoint(path, "cpu")
    args.rounds, args.ckpt_dir = 4, None
    resumed = train.train(args, start={**ck, "round": step})
    for a, b in zip(tree_leaves(full["params"]) + tree_leaves(full["delta"]),
                    tree_leaves(resumed["params"]) + tree_leaves(resumed["delta"])):
        assert torch.equal(a, b)
    for k in full["state"]:
        for a, b in zip(tree_leaves(full["state"][k]), tree_leaves(resumed["state"][k])):
            assert torch.equal(a, b), k


def test_launch_train_takes_a_setup_in_place_of_its_config():
    """`train(args, run=setup(...))` runs the setup it is given and equals
    `train(args)`; a setup given beside a config or remat is refused."""
    args = train.build_parser().parse_args(TINY + ["--arch", "gemma2-2b", "--rounds", "1"])
    run = train.setup(args)
    got = train.train(args, run=run)
    assert got["setup"] is run
    want = train.train(args)
    for a, b in zip(tree_leaves(got["params"]) + tree_leaves(got["delta"]),
                    tree_leaves(want["params"]) + tree_leaves(want["delta"])):
        assert torch.equal(a, b)
    for kw in ({"cfg": run.cfg}, {"remat": True}):
        with pytest.raises(TypeError, match="either run or"):
            train.train(args, run=run, **kw)
