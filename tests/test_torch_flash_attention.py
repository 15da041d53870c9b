"""The port's `flash_attention` / `grouped_flash_attention` (their plain
versions, which a CPU tensor runs) against JAX's Pallas kernel in
interpret mode and its `ref.flash_attention_ref`, on the same numpy
inputs, in the cases of `tests/test_kernels.py` (TestFlashAttention),
with its tolerances (f32 1e-5, bf16 2e-2).  Beyond them: native GQA
without repeated heads, ragged lengths and head_dim 112 / 256, against
JAX's reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import grouped_flash_attention as jgrouped
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, grouped_flash_attention, ref

pytestmark = pytest.mark.torch

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, qshape, kshape, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (scale * rng.standard_normal(qshape)).astype(np.float32)
    k = (scale * rng.standard_normal(kshape)).astype(np.float32)
    v = rng.standard_normal(kshape).astype(np.float32)
    return q, k, v


def _both(arrays, name):
    jdt, tdt = DT[name]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


# test_kernels' (Sq, Skv) x causal grid, less causal with Sq < Skv (the
# cache case, which it skips)
@pytest.mark.parametrize("Sq,Skv,causal", [
    (128, 128, True), (128, 128, False), (256, 256, True), (256, 256, False),
    (128, 384, False),
])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_matches_jax_kernel_and_ref(Sq, Skv, causal, name):
    (jq, jk, jv), (q, k, v) = _both(_qkv(0, (1, 2, Sq, 64), (1, 2, Skv, 64)), name)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    want_kernel = jflash(jq, jk, jv, causal=causal, interpret=True)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **_tol(name))
    np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(name))


@pytest.mark.parametrize("window", [128, 256])
def test_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, (1, 2, 512, 64), (1, 2, 512, 64)), "f32")
    got = flash_attention(q, k, v, causal=True, window=window)
    want = jflash(jq, jk, jv, causal=True, window=window, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(got), _np(jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)),
        rtol=1e-5, atol=1e-5)


def test_logit_softcap():
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, (1, 1, 256, 64), (1, 1, 256, 64), 4.0), "f32")
    got = flash_attention(q, k, v, causal=True, softcap=50.0)
    want = jflash(jq, jk, jv, causal=True, softcap=50.0, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    uncapped = flash_attention(q, k, v, causal=True)
    assert float((got - uncapped).abs().max()) > 1e-3


@pytest.mark.parametrize("block_q,block_kv", [(64, 128), (128, 64), (64, 64)])
def test_block_shape_invariance(block_q, block_kv):
    """JAX's kernel at every tiling equals the port (which has its own)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(3, (1, 1, 256, 64), (1, 1, 256, 64)), "f32")
    want = jflash(jq, jk, jv, causal=True, block_q=block_q, block_kv=block_kv,
                  interpret=True)
    got = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_gqa_adapter():
    """grouped_flash_attention (model layout, H=8 over KV=2) against JAX's
    adapter, which repeats the KV heads."""
    B, S, H, KV, hd = 2, 128, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _both(_qkv(4, (B, S, H, hd), (B, S, KV, hd)), "f32")
    got = grouped_flash_attention(q, k, v, causal=True)
    assert got.shape == (B, S, H, hd)
    want = jgrouped(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    plain = grouped_flash_attention(q, k, v, causal=True, use_kernel=False)
    np.testing.assert_allclose(_np(plain), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    # (B, H, KV, Sq, Skv, hd, causal, window, softcap)
    (2, 8, 2, 100, 100, 112, True, 0, 0.0),     # ragged, zamba2's head_dim
    (1, 8, 4, 200, 200, 256, True, 64, 50.0),   # gemma2's local layer
    (1, 4, 1, 37, 300, 32, False, 0, 0.0),      # Sq < Skv, multi-query
    (1, 4, 4, 130, 130, 48, False, 40, 20.0),   # window without causal
], ids=["ragged-hd112", "gemma2-local", "sq<skv-mqa", "window-noncausal"])
def test_native_gqa_and_ragged_against_jax_ref(case):
    """The port takes KV heads as they are; JAX's reference gets them
    repeated.  Lengths and head dims the TPU kernel refuses."""
    B, H, KV, Sq, Skv, hd, causal, window, softcap = case
    q, k, v = _qkv(5, (B, H, Sq, hd), (B, KV, Skv, hd), 2.0)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window,
                          softcap=softcap)
    rep = lambda a: jnp.repeat(jnp.asarray(a), H // KV, axis=1)
    want = jref.flash_attention_ref(jnp.asarray(q), rep(k), rep(v), causal=causal,
                                    window=window, softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_plain_version_is_the_kernels_function_on_cpu():
    """A CPU tensor runs `ref.flash_attention_ref` itself (no launch)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, (1, 2, 70, 16), (1, 1, 70, 16)))
    flash_attention.launches = 0
    got = flash_attention(q, k, v, causal=True, window=9)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True, window=9))
    assert flash_attention.launches == 0


def test_raises_on_what_it_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 1, 8, 300)
        flash_attention(z, z, z)
    with pytest.raises(TypeError):
        z = torch.zeros(1, 1, 8, 16, dtype=torch.float64)
        flash_attention(z, z, z)
    with pytest.raises(ValueError, match="unit stride"):
        z = torch.zeros(1, 1, 16, 8).transpose(2, 3)
        flash_attention(z, z, z)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention(q, torch.zeros(1, 4, 0, 16), torch.zeros(1, 4, 0, 16))
