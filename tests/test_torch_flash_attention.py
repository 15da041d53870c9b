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


# ------------------------------------- the CUDA kernel's arithmetic, emulated
# `csrc/flash_attention.cu` computes both products on the tensor cores: f32
# as 3xTF32 (each operand split into hi = rna(x), lo = rna(x - hi), both
# TF32, and hi*hi + hi*lo + lo*hi accumulated in f32), bf16 with P rounded
# to bf16 before the PV product (its row sum from the f32 values).  The
# emulation below repeats that arithmetic on the CPU, tile by tile, in log2
# units as the kernel does; the products themselves are exact here (f64),
# as a TF32 x TF32 product is on the card, so what it pins is the rounding
# of the operands.
LOG2E = 1.4426950408889634


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: round to 10 mantissa bits, ties away from zero,
    by bit masking (add half of the dropped unit to the magnitude bits,
    then clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """a @ b (f32 operands) as the kernel's tensor-core route takes it."""
    if route == "3xtf32":
        ah, bh = _tf32_rna(a), _tf32_rna(b)
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
        out = (al.double() @ bh.double() + ah.double() @ bl.double()
               + ah.double() @ bh.double())
    elif route == "1xtf32":
        out = _tf32_rna(a).double() @ _tf32_rna(b).double()
    else:  # bf16: the operands are bf16 values already
        out = a.double() @ b.double()
    return out.float()


def _emulate(q, k, v, *, causal, window, softcap, route, bk):
    """The kernel's online softmax over key tiles of `bk`, in f32 on the
    CPU (q/k/v [B, H, S, hd] f32 tensors, H == KV)."""
    Sq, Skv, hd = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / np.sqrt(hd)
    qp = torch.arange(Sq)[:, None]
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape)
    for k0 in range(0, Skv, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = _product(q, kt.transpose(-1, -2), route)
        if softcap > 0:
            x = np.float32(softcap * LOG2E) * torch.tanh(s * np.float32(scale / softcap))
        else:
            x = s * np.float32(scale * LOG2E)
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        keep = torch.ones(Sq, kt.shape[2], dtype=torch.bool)
        if causal:
            keep &= qp >= kp
        if window > 0:
            keep &= qp - kp < window
        x = torch.where(keep, x, torch.full_like(x, -1e30))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if route == "bf16":
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + _product(p, vt, route)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


#: (causal, window, softcap); a softcap of 5 bites at these unit-variance
#: logits as Gemma-2's 50 does at a trained model's
EMULATED = {
    "causal": (True, 0, 0.0), "window": (True, 48, 0.0), "softcap": (True, 0, 5.0),
}


def _emulation_inputs(hd, name, seed):
    """[1, 2, 192, hd] q/k/v from numpy, in `name`'s precision, as f32
    numpy arrays."""
    q, k, v = _qkv(seed, (1, 2, 192, hd), (1, 2, 192, hd))
    if name == "bf16":
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in (q, k, v))
    return q, k, v


def _jax_ref(q, k, v, case):
    causal, window, softcap = EMULATED[case]
    return _np(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window, softcap=softcap))


@pytest.mark.parametrize("case", list(EMULATED))
@pytest.mark.parametrize("hd", [64, 112, 256])
def test_3xtf32_arithmetic_within_the_f32_tolerance(hd, case):
    """The f32 route (3xTF32; 32-key tiles at hd 256 as the kernel takes
    them in f32, 64 below) against JAX's f32 reference: within 1e-5."""
    q, k, v = _emulation_inputs(hd, "f32", 10 + hd)
    causal, window, softcap = EMULATED[case]
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                   window=window, softcap=softcap, route="3xtf32",
                   bk=32 if hd > 128 else 64)
    np.testing.assert_allclose(_np(got), _jax_ref(q, k, v, case), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [64, 112, 256])
def test_1xtf32_arithmetic_misses_the_f32_tolerance(hd):
    """Why the f32 route splits each operand: one TF32 product per f32
    product lands outside the 1e-5 the kernel is held to."""
    q, k, v = _emulation_inputs(hd, "f32", 10 + hd)
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=0,
                   softcap=0.0, route="1xtf32", bk=64)
    err = float(np.abs(_np(got) - _jax_ref(q, k, v, "causal")).max())
    assert err > 1e-5, err


@pytest.mark.parametrize("case", list(EMULATED))
@pytest.mark.parametrize("hd", [64, 112, 256])
def test_bf16_p_arithmetic_within_one_bf16_rounding(hd, case):
    """The bf16 route (P rounded to bf16 for PV, the output rounded to
    bf16) against JAX's reference on the same bf16 values computed in f32:
    within 2^-7 of the largest |output|."""
    q, k, v = _emulation_inputs(hd, "bf16", 20 + hd)
    causal, window, softcap = EMULATED[case]
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                   window=window, softcap=softcap, route="bf16", bk=64)
    got = got.to(torch.bfloat16)
    want = _jax_ref(q, k, v, case)
    err = float(np.abs(_np(got) - want).max())
    assert err <= 2.0 ** -7 * float(np.abs(want).max()), err
