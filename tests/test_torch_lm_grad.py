"""The LM training path's gradients (`repro_torch.kernels` flash_attention
/ ssm_scan as autograd Functions, `models` cross_entropy, chunked_lm_loss
and remat, `problems.adversarial`) against the JAX package on the same
numpy inputs.

  * The two model kernels' plain backward (`plain_*_bwd`, and the
    Functions through autograd on the CPU, where their backward is
    `torch.func.vjp` of the plain version) against `jax.vjp` of JAX's
    oracles `kernels/ref.py` `flash_attention_ref` and `ssm_scan_ref`,
    each gradient within 1e-5 of its max |value|: causal, window, softcap,
    grouped heads (JAX takes them repeated, so its dk / dv are summed over
    each group), both scan layouts, Mamba-2's broadcast decay (JAX's
    repeated over the channels, summed back), state0 and the final
    state's cotangent.
  * `cross_entropy`, `chunked_lm_loss` (with several chunks) and the
    adversarial loss with its (gx, gy), on gemma2-2b, zamba2-7b,
    falcon-mamba-7b, granite-8b, llama4-scout and pixtral-12b reduced,
    from JAX's weights and JAX's tokens, within 1e-4 of each leaf's max
    |value| (f32 sums in other orders, through several layers); the MoE
    model also with the load-balance aux in the loss (`aux_weight`).
  * `torch.func.vmap` over each Function, one backward, equals a loop
    over the agents; remat changes no gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import federated_token_batches as jfederated_token_batches
from repro.kernels import ref as jref
from repro.models import chunked_lm_loss as jchunked_lm_loss
from repro.models import embed_inputs as jembed_inputs
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.problems.adversarial import make_adversarial_loss as jmake_adversarial_loss
from repro_torch.configs import get_config
from repro_torch.convert import model_tree_from_numpy, tree_from_numpy
from repro_torch.core.types import tree_broadcast_agents, tree_leaves, vmap_grad_xy
from repro_torch.kernels import flash_attention, ref, ssm_scan
from repro_torch.kernels.flash_attention import plain_flash_attention_bwd
from repro_torch.kernels.ssm_scan import plain_ssm_scan_bwd
from repro_torch.models import chunked_lm_loss, cross_entropy, embed_inputs, forward
from repro_torch.problems import make_adversarial_loss

from test_torch_parity import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

KERNEL_REL = 1e-5
MODEL_REL = 1e-4
ARCHS = ["gemma2-2b", "zamba2-7b", "falcon-mamba-7b", "granite-8b",
         "llama4-scout-17b-a16e", "pixtral-12b"]
MOE = "llama4-scout-17b-a16e"


def close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("case", [
    # (B, H, KV, Sq, Skv, hd, causal, window, softcap)
    (2, 4, 4, 33, 33, 16, True, 0, 0.0),
    (1, 4, 2, 40, 40, 32, True, 7, 0.0),      # window, GQA
    (2, 2, 2, 24, 24, 8, True, 0, 5.0),       # softcap
    (1, 6, 2, 9, 30, 16, False, 0, 3.0),      # Sq < Skv, not causal
    (1, 4, 1, 50, 50, 24, True, 12, 20.0),    # everything, multi-query
], ids=["causal", "window-gqa", "softcap", "noncausal", "all"])
def test_flash_attention_bwd_matches_jax_vjp(case):
    B, H, KV, Sq, Skv, hd, causal, window, softcap = case
    q, k, v = (_normal(i, s) for i, s in enumerate(
        [(B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)]))
    dout = _normal(9, (B, H, Sq, hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    G = H // KV

    def jfwd(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, G, axis=1),
                                        jnp.repeat(v, G, axis=1), **kw)

    @jax.jit
    def jgrads(q, k, v, dout):
        out, vjp = jax.vjp(jfwd, q, k, v)
        return out, vjp(dout)

    out, want = jgrads(*(jnp.asarray(a) for a in (q, k, v, dout)))
    got = plain_flash_attention_bwd(_t(q), _t(k), _t(v), _t(dout), **kw)
    leaves = [_t(q, True), _t(k, True), _t(v, True)]
    o = flash_attention(*leaves, **kw)
    close(o, out, KERNEL_REL, "out")
    via_autograd = torch.autograd.grad(o, leaves, _t(dout))
    for name, g, a, w in zip(("dq", "dk", "dv"), got, via_autograd, want):
        close(g, w, KERNEL_REL, name)
        close(a, w, KERNEL_REL, name + " (Function)")


def test_flash_attention_bf16_gradient_raises():
    q = torch.zeros(1, 1, 4, 8, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(TypeError, match="f32"):
        flash_attention(q, q, q)


# --------------------------------------------------------------------- scan
def _jax_scan(da, dbx, c, s0):
    """JAX's one-sequence oracle over the [B, S, d, N] layout."""
    return jax.vmap(jref.ssm_scan_ref)(da, dbx, c, s0)


@pytest.mark.parametrize("layout", ["mamba2_head", "mamba1_full", "one_sequence"])
@pytest.mark.parametrize("start", ["zero", "state0"])
def test_ssm_scan_bwd_matches_jax_vjp(layout, start):
    """dy and the final state's cotangent through both sides; Mamba-2's
    per-head decay [B, S, H, 1, 1] is JAX's [B, S, H*P, 1] repeated over
    the channels, its gradient summed back over them."""
    B, S, H, P, N = 2, 13, 3, 4, 5
    if layout == "mamba1_full":
        H, P = 7, 1
    d = H * P
    rng = np.random.default_rng(hash(layout) % 1000)
    dbx = (0.3 * rng.standard_normal((B, S, d, N))).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, d, N)).astype(np.float32) if start == "state0"
          else np.zeros((B, d, N), np.float32))
    dy = rng.standard_normal((B, S, d)).astype(np.float32)
    dstate = rng.standard_normal((B, d, N)).astype(np.float32)
    if layout == "mamba2_head":
        da_head = (0.9 / (1 + np.exp(-rng.standard_normal((B, S, H))))).astype(np.float32)
        da_j = np.repeat(da_head, P, axis=2)[..., None]  # [B, S, d, 1]
    else:
        da_j = (0.9 / (1 + np.exp(-rng.standard_normal((B, S, d, N))))).astype(np.float32)
    @jax.jit
    def jgrads(da, dbx, c, s0, dy, dstate):
        out, vjp = jax.vjp(_jax_scan, da, dbx, c, s0)
        return out, vjp((dy, dstate))

    (y, state), (w_da, w_dbx, w_c, w_s0) = jgrads(
        *(jnp.asarray(a) for a in (da_j, dbx, c, s0, dy, dstate)))

    if layout == "mamba2_head":
        da5 = da_head.reshape(B, S, H, 1, 1)
        w_da = np.asarray(w_da)[..., 0].reshape(B, S, H, P).sum(-1).reshape(B, S, H, 1, 1)
    else:
        da5 = da_j.reshape(B, S, H, P, N)
        w_da = np.asarray(w_da).reshape(da5.shape)
    shape5 = (B, S, H, P, N)
    s05 = None if start == "zero" else _t(s0.reshape(B, H, P, N))
    got = plain_ssm_scan_bwd(_t(da5), _t(dbx.reshape(shape5)), _t(c), s05,
                             _t(dy.reshape(B, S, H, P)), _t(dstate.reshape(B, H, P, N)))
    close(got[0], w_da, KERNEL_REL, "d da")
    close(got[1].reshape(B, S, d, N), w_dbx, KERNEL_REL, "d dbx")
    close(got[2], w_c, KERNEL_REL, "dc")
    close(got[3].reshape(B, d, N), w_s0, KERNEL_REL, "d state0")

    # the Function in the caller's layout, through autograd
    if layout == "one_sequence":
        args = [_t(da_j[0], True), _t(dbx[0], True), _t(c[0], True)]
        s0_t = None if start == "zero" else _t(s0[0], True)
        y_t, st_t = ssm_scan(*args, s0_t)
        close(y_t, y[0], KERNEL_REL, "y")
        leaves = args + ([] if s0_t is None else [s0_t])
        grads = torch.autograd.grad((y_t * _t(dy[0])).sum() + (st_t * _t(dstate[0])).sum(),
                                    leaves)
        for g, w in zip(grads, (w_da, w_dbx, w_c, w_s0)):
            close(g, np.asarray(w)[0].reshape(g.shape), KERNEL_REL, "one sequence")
    else:
        args = [_t(da5, True), _t(dbx.reshape(shape5), True), _t(c, True)]
        s0_t = None if start == "zero" else _t(s0.reshape(B, H, P, N), True)
        y_t, st_t = ssm_scan(*args, s0_t)
        close(y_t.reshape(B, S, d), y, KERNEL_REL, "y")
        close(st_t.reshape(B, d, N), state, KERNEL_REL, "state")
        leaves = args + ([] if s0_t is None else [s0_t])
        grads = torch.autograd.grad(
            (y_t * _t(dy.reshape(B, S, H, P))).sum()
            + (st_t * _t(dstate.reshape(B, H, P, N))).sum(), leaves)
        for g, w in zip(grads, (w_da, w_dbx, w_c, w_s0)):
            close(g.reshape(np.shape(w)), w, KERNEL_REL, layout)


# ------------------------------------------------------------ vmap, remat
def test_flash_function_under_vmap_equals_a_loop():
    A, B, H, KV, S, hd = 3, 2, 4, 2, 17, 8
    q = _t(_normal(0, (A, B, H, S, hd)), True)
    k, v = (_t(_normal(i, (A, B, KV, S, hd)), True) for i in (1, 2))
    w = _t(_normal(3, (A, B, H, S, hd)))

    def loss(q, k, v, w):
        return (flash_attention(q, k, v, causal=True, window=5, softcap=4.0) * w).sum()

    got = torch.autograd.grad(torch.func.vmap(loss)(q, k, v, w).sum(), (q, k, v))
    for i in range(A):
        one = [t[i].detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(loss(*one, w[i]), one)
        for g, wv in zip(got, want):
            torch.testing.assert_close(g[i], wv, rtol=1e-6, atol=1e-7)


def test_scan_function_under_vmap_equals_a_loop():
    A, B, S, H, P, N = 3, 2, 11, 3, 4, 5
    da = _t(0.9 * np.random.default_rng(0).random((A, B, S, H, 1, 1)).astype(np.float32), True)
    dbx = _t(_normal(1, (A, B, S, H, P, N), 0.3), True)
    c = _t(_normal(2, (A, B, S, N)), True)
    wy, ws = _t(_normal(3, (A, B, S, H, P))), _t(_normal(4, (A, B, H, P, N)))

    def loss(da, dbx, c, wy, ws):
        y, st = ssm_scan(da, dbx, c)
        return (y * wy).sum() + (st * ws).sum()

    got = torch.autograd.grad(torch.func.vmap(loss)(da, dbx, c, wy, ws).sum(), (da, dbx, c))
    for i in range(A):
        one = [t[i].detach().requires_grad_() for t in (da, dbx, c)]
        want = torch.autograd.grad(loss(*one, wy[i], ws[i]), one)
        for g, wv in zip(got, want):
            torch.testing.assert_close(g[i], wv, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- the LM
@pytest.fixture(scope="module")
def lm_inputs():
    """Per arch: JAX's reduced config, weights and 2 agents' tokens
    (seq 16), as JAX's and as the port's."""
    out = {}
    for name in ARCHS:
        jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
        jp = jax.jit(jinit_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), jcfg,
                                                          jnp.float32)
        data = jfederated_token_batches(jax.random.PRNGKey(1), 2, 2, 16,
                                        jcfg.vocab_size, heterogeneity=7)
        y = {"delta": jnp.asarray(_normal(5, (jcfg.d_model,), 0.05))}
        x = model_tree_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
        out[name] = (jcfg, cfg, jp, data, y, x,
                     tree_from_numpy(jax.tree.map(np.asarray, data), "cpu"),
                     tree_from_numpy(jax.tree.map(np.asarray, y), "cpu"))
    return out


def test_cross_entropy_and_its_gradient_match_jax():
    logits = _normal(0, (3, 7, 50), 3.0)
    labels = np.random.default_rng(1).integers(0, 50, (3, 7)).astype(np.int32)
    val, grad = jax.value_and_grad(jlayers.cross_entropy)(jnp.asarray(logits),
                                                          jnp.asarray(labels))
    lt = _t(logits, True)
    got = cross_entropy(lt, _t(labels))
    close(got, val, 1e-6, "cross_entropy")
    close(torch.autograd.grad(got, lt)[0], grad, 1e-6, "its gradient")


@pytest.mark.parametrize("name", ARCHS)
def test_chunked_lm_loss_matches_jax(lm_inputs, name):
    """Several chunks (chunk 4 of S 16) and one, with ignored labels."""
    jcfg, cfg, jp, data, _, x, d, _ = lm_inputs[name]
    batch = jax.tree.map(lambda a: a[0], data)
    h = jax.jit(lambda p, b: jforward(p, jcfg, jembed_inputs(p, jcfg, b))[0])(jp, batch)
    labels = np.array(batch["labels"])
    labels[0, 3] = labels[1, 9] = -1
    ht = _t(np.asarray(h), True)
    for chunk in (4, 512):
        want, jgrad = jax.jit(jax.value_and_grad(
            lambda p, h, lb: jchunked_lm_loss(p, jcfg, h, lb, chunk), argnums=(0, 1)))(
            jp, h, jnp.asarray(labels))
        got = chunked_lm_loss(x, cfg, ht, _t(labels), chunk)
        close(got, want, MODEL_REL, f"chunk {chunk}")
        close(torch.autograd.grad(got, ht)[0], jgrad[1], MODEL_REL, f"dh, chunk {chunk}")


@pytest.mark.parametrize("name,aux_weight", [(a, 0.0) for a in ARCHS] + [(MOE, 0.01)])
def test_adversarial_loss_and_gradients_match_jax(lm_inputs, name, aux_weight):
    """Each agent's loss and (gx, gy) through the engine's vmapped
    gradient (remat on, the Functions' CPU path), leaf by leaf."""
    jcfg, cfg, jp, data, y, x, d, yt = lm_inputs[name]
    jl = jmake_adversarial_loss(jcfg, remat=True, aux_weight=aux_weight)
    jv, (jgx, jgy) = jax.jit(jax.vmap(jax.value_and_grad(jl, argnums=(0, 1)),
                                      in_axes=(None, None, 0)))(jp, y, data)
    loss = make_adversarial_loss(cfg, remat=True, aux_weight=aux_weight)
    with torch.no_grad():
        v = torch.func.vmap(loss, in_dims=(None, None, 0))(x, yt, d)
    close(v, jv, MODEL_REL, "loss")
    g = vmap_grad_xy(loss)(tree_broadcast_agents(x, 2), tree_broadcast_agents(yt, 2), d)
    # a top-1 router's gate is p / p = 1: without the aux in the loss its
    # gradient is zero but for rounding, on both sides
    zero_router = cfg.num_experts and cfg.top_k == 1 and not aux_weight
    for agent in range(2):
        want = model_tree_from_numpy(
            cfg, jax.tree.map(lambda a: np.asarray(a)[agent], jgx), "cpu")
        scale = max(float(u.abs().max()) for u in tree_leaves(want))
        for path, a, b in zip(_paths(g.gx), tree_leaves(g.gx), tree_leaves(want)):
            if zero_router and path.endswith("moe.router"):
                assert max(float(a[agent].abs().max()), float(b.abs().max())) <= 1e-6 * scale
                continue
            close(a[agent], b, MODEL_REL, f"gx {path}, agent {agent}")
        close(g.gy["delta"][agent], np.asarray(jgy["delta"])[agent], MODEL_REL, "gy")


def _paths(tree, prefix=""):
    """Dotted names of a tree's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


@pytest.mark.parametrize("name", ["zamba2-7b", "gemma2-2b", MOE])
def test_remat_changes_no_gradient(lm_inputs, name):
    """The MoE model with the aux in its loss: remat carries each period's
    aux out of the checkpoint and its gradient back in."""
    _, cfg, _, _, _, x, d, yt = lm_inputs[name]
    xs, ys = tree_broadcast_agents(x, 2), tree_broadcast_agents(yt, 2)
    aux_weight = 0.01 if cfg.num_experts else 0.0
    with_remat, without = (
        vmap_grad_xy(make_adversarial_loss(cfg, remat=r, aux_weight=aux_weight))(xs, ys, d)
        for r in (True, False))
    for a, b in zip(tree_leaves(with_remat), tree_leaves(without)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    # and the forward alone, with and without remat
    batch = {"tokens": d["tokens"][0]}
    h = embed_inputs(x, cfg, batch)
    for a, b in zip(forward(x, cfg, h, remat=True), forward(x, cfg, h)):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
