"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
(`repro.models.moe`) at the same weights and inputs, made from a seed
with numpy: the router's expert indices bit for bit (ties included), its
gates and aux within 1e-6, `moe_ffn` through both dispatches within 1e-5
of the largest |output| (with tokens dropped past capacity, and at
top-2), the port's index dispatch equal bit for bit to JAX's one-hot
einsums written in torch, and a `torch.func.vmap` over agents equal to
a loop over them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

pytestmark = pytest.mark.torch

D, FF, E = 32, 48, 4
MOE_REL = 1e-5
ROUTER_TOL = 1e-6


def _weights(seed, d=D, ff=FF, e=E):
    rng = np.random.default_rng(seed)
    n = lambda *s, scale: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"router": n(d, e, scale=1 / np.sqrt(d)),
            "gate": n(e, d, ff, scale=1 / np.sqrt(d)),
            "up": n(e, d, ff, scale=1 / np.sqrt(d)),
            "down": n(e, ff, d, scale=1 / np.sqrt(ff))}


def _both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _h(seed, B=3, S=20, d=D):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _close(got, want, rel, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |err| {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("top_k", [1, 2])
def test_router_decisions_match_jax(seed, top_k):
    jw, tw = _both(_weights(seed))
    h = _h(10 + seed)
    jidx, jgate, jaux = jmoe.router_decisions(jw, jnp.asarray(h), top_k)
    idx, gate, aux = moe.router_decisions(tw, torch.from_numpy(h), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=0, atol=ROUTER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=ROUTER_TOL)
    assert gate.dtype == torch.float32 and idx.shape == (3, 20, top_k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_router_ties_go_to_the_lowest_experts(top_k):
    """A zero router gives uniform probabilities: every token ties across
    all experts, and JAX's top_k takes experts 0 (and 1)."""
    w = _weights(3)
    w["router"][:] = 0.0
    jw, tw = _both(w)
    h = _h(4)
    jidx, jgate, jaux = jmoe.router_decisions(jw, jnp.asarray(h), top_k)
    idx, gate, aux = moe.router_decisions(tw, torch.from_numpy(h), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == np.arange(top_k)).all()
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=0, atol=ROUTER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=ROUTER_TOL)
    for dispatch in ("einsum", "scatter"):
        jout, _ = jmoe.moe_ffn(jw, jnp.asarray(h), top_k=top_k, dispatch=dispatch)
        out, _ = moe.moe_ffn(tw, torch.from_numpy(h), top_k=top_k, dispatch=dispatch)
        _close(out, jout, MOE_REL, f"tied moe_ffn {dispatch}")


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(dispatch, capacity_factor, top_k):
    jw, tw = _both(_weights(5))
    h = _h(6)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, dispatch=dispatch)
    jout, jaux = jmoe.moe_ffn(jw, jnp.asarray(h), **kw)
    out, aux = moe.moe_ffn(tw, torch.from_numpy(h), **kw)
    _close(out, jout, MOE_REL, "moe_ffn")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=ROUTER_TOL)
    if capacity_factor < 1:
        # tokens past capacity come out as exact zeros on both sides
        dropped = np.all(np.asarray(jout) == 0, axis=-1)
        assert dropped.any()
        np.testing.assert_array_equal(np.all(out.numpy() == 0, axis=-1), dropped)


@pytest.mark.parametrize("S,top_k,cf,n_exp,want", [
    (512, 1, 1.25, 16, 40),  # llama4-scout's prefill at 512
    (1, 1, 1.25, 16, 1),     # a decode step
    (20, 2, 0.5, 4, 5), (7, 1, 1.0, 4, 1),
])
def test_capacity_is_jaxs(S, top_k, cf, n_exp, want):
    assert moe.capacity(S, top_k, cf, n_exp) == want


def _one_hot_einsum_dispatch(params, h, idx, gate, top_k, C, E):
    """JAX's `_dispatch_einsum` in torch: one-hot dispatch and combine
    einsums over a [B, S, E, C] slot matrix."""
    out = torch.zeros_like(h)
    for k in range(top_k):
        onehot = moe._one_hot(idx[..., k], E)  # [B, S, E]
        pos = torch.cumsum(onehot, dim=1) * onehot - 1  # slot within expert
        # jax.nn.one_hot(pos, C): a zero row for -1 and for pos >= C
        dm = (pos[..., None] == torch.arange(C)).to(h.dtype)  # [B, S, E, C]
        xout = moe._expert_ffn(params, torch.einsum("bsec,bsd->ebcd", dm, h))
        comb = dm * gate[..., k][..., None, None]
        out = out + torch.einsum("bsec,ebcd->bsd", comb, xout)
    return out


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 0.1])
@pytest.mark.parametrize("top_k", [1, 2])
def test_einsum_and_scatter_dispatch_are_bitwise_equal(capacity_factor, top_k):
    """Both values of `moe_dispatch` run the index dispatch; each slot of
    the one-hot einsums sums exactly one non-zero term, so they equal it
    bit for bit."""
    _, tw = _both(_weights(7))
    h = torch.from_numpy(_h(8, B=2, S=33))
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    idx, gate, aux = moe.router_decisions(tw, h, top_k)
    C = moe.capacity(33, top_k, capacity_factor, E)
    want = _one_hot_einsum_dispatch(tw, h, idx, gate, top_k, C, E)
    for dispatch in ("einsum", "scatter"):
        got, got_aux = moe.moe_ffn(tw, h, dispatch=dispatch, **kw)
        assert torch.equal(got, want) and torch.equal(got_aux, aux), dispatch


def test_a_dropped_token_never_leaks():
    """The dispatch: a token past capacity lands in the spare
    slot, which the experts never see, and its output is masked with
    `where`, so even a non-finite input of a dropped token stays out."""
    _, tw = _both(_weights(9))
    h = torch.from_numpy(_h(11, B=1, S=16))
    idx, _, _ = moe.router_decisions(tw, h, 1)
    pos = moe._slot_positions(idx[..., 0], E)
    C = moe.capacity(16, 1, 0.25, E)
    dropped = pos >= C
    assert dropped.any()
    # the decisions as routed from h, the dropped tokens' inputs made inf
    h_bad = torch.where(dropped[..., None], torch.full_like(h, float("inf")), h)
    gate = torch.ones(idx.shape, dtype=h.dtype)
    out = moe._dispatch(tw, h_bad, idx, gate, 1, C, E)
    assert torch.isfinite(out[~dropped]).all()
    assert (out[dropped] == 0).all()


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_ffn_under_vmap_equals_the_loop(dispatch):
    """The round engine vmaps the loss over agents: agent-stacked weights
    and inputs through `torch.func.vmap`, and their gradients, equal a
    loop over the agents."""
    m = 3
    ws = [_both(_weights(20 + i))[1] for i in range(m)]
    stacked = {k: torch.stack([w[k] for w in ws]) for k in ws[0]}
    hs = torch.stack([torch.from_numpy(_h(30 + i, B=2, S=12)) for i in range(m)])
    kw = dict(top_k=2, capacity_factor=0.75, dispatch=dispatch)

    def f(w, h):
        out, aux = moe.moe_ffn(w, h, **kw)
        return (out ** 2).sum() + aux

    got = torch.func.vmap(f)(stacked, hs)
    got_g = torch.func.vmap(torch.func.grad(f))(stacked, hs)
    for i in range(m):
        w_i = {k: v[i] for k, v in stacked.items()}
        assert torch.allclose(got[i], f(w_i, hs[i]), rtol=1e-6, atol=0)
        want_g = torch.func.grad(f)(w_i, hs[i])
        for k in want_g:
            torch.testing.assert_close(got_g[k][i], want_g[k], rtol=1e-5, atol=1e-6)


def test_unknown_dispatch_raises():
    _, tw = _both(_weights(0))
    with pytest.raises(ValueError, match="unknown dispatch"):
        moe.moe_ffn(tw, torch.zeros(1, 2, D), dispatch="ragged")
