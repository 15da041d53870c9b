"""The arithmetic of the port's flash backward kernel
(`csrc/flash_attention_bwd.cu`), emulated on the CPU, against JAX's
gradient of its `ref.flash_attention_ref` (`jax.vjp`) on the same numpy
inputs, within the card gate's GRAD_REL (1e-4 of each gradient's max
|value|).

The kernel forms its five products on the tensor cores as 3xTF32 with
`split_tf32_fast`: hi = x truncated to TF32, lo = x - hi in f32 with its
13 low bits left for the tensor core to drop, and lo*hi + hi*lo + hi*hi
in f32.  It walks key tiles of 64 and query tiles of 16 or 32 rows (the
plan by head dim), recomputes P from the forward's log-sum-exp in log2
units, folds each query tile's dV / dK products into its running sums
with one f32 add, forms dS from P o (1 - tanh^2) (what one warp hands
the other), and sums dQ's per-key-tile partials in key-tile order.  The emulation repeats that, tile by tile; the products
themselves are exact here (f64), as a TF32 x TF32 product is on the
card, so what it pins is the rounding of the operands and the order of
the f32 sums.  One TF32 product per f32 product (no split) misses the
gate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch

GRAD_REL = 1e-4  # chip_smoke's and the card tests' gate
LOG2E = 1.4426950408889634
BC = 64  # keys a CTA


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64)


def _from_bits(bits: torch.Tensor) -> torch.Tensor:
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`tf32_rna`: 10 mantissa bits, to nearest, ties away from zero (a
    single TF32 product's rounding)."""
    return _from_bits((_bits(x) + 0x1000) & 0xFFFFE000)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a TF32 operand: its top 19 bits."""
    return _from_bits(_bits(x) & 0xFFFFE000)


def _product(a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """a @ b (f32 operands) as the kernel's tensor cores take it."""
    if route == "1xtf32":
        return (_tf32_rna(a).double() @ _tf32_rna(b).double()).float()
    ah, bh = _tf32_trunc(a), _tf32_trunc(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    small = (al.double() @ bh.double() + ah.double() @ bl.double()).float()
    return ((ah.double() @ bh.double()).float() + small)


def _emulate(q, k, v, dout, *, causal, window, softcap, route, br):
    """(dq, dk, dv) of one (batch, head): q / dout [Sq, hd], k / v [Skv,
    hd] f32, as the kernel's tiles compute them."""
    Sq, Skv, hd = q.shape[0], k.shape[0], q.shape[1]
    scale = np.float32(1.0 / np.sqrt(hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ref.flash_attention_ref(q[None, None], k[None, None], v[None, None], **kw)[0, 0]
    lse = ref.flash_attention_lse_ref(q[None, None], k[None, None], v[None, None], **kw)[0, 0]
    delta = (dout * out).sum(-1)
    dk, dv = torch.zeros(Skv, hd), torch.zeros(Skv, hd)
    parts = []
    for k0 in range(0, Skv, BC):
        kt, vt = k[k0:k0 + BC], v[k0:k0 + BC]
        q_lo = k0 if causal else 0
        q_hi = min(Sq, k0 + BC - 1 + window) if window > 0 else Sq
        part = torch.zeros(Sq, hd)
        for q0 in range(q_lo // br * br, q_hi, br):
            qt, gt = q[q0:q0 + br], dout[q0:q0 + br]
            s_t = _product(kt, qt.T, route) * scale
            dp_t = _product(vt, gt.T, route)
            if softcap > 0:
                th = torch.tanh(s_t / np.float32(softcap))
                x = np.float32(softcap) * th
            else:
                x = s_t
            p_t = torch.exp2((x - lse[q0:q0 + br][None, :]) * np.float32(LOG2E))
            # the dS warp's share of P: P o (1 - tanh^2) under a softcap
            pw_t = p_t * (1 - th * th) if softcap > 0 else p_t
            ds_t = pw_t * (dp_t - delta[q0:q0 + br][None, :])
            qi = torch.arange(q0, q0 + qt.shape[0])[None, :]
            kj = torch.arange(k0, k0 + kt.shape[0])[:, None]
            keep = torch.ones_like(p_t, dtype=torch.bool)
            if causal:
                keep &= qi >= kj
            if window > 0:
                keep &= qi - kj < window
            p_t = torch.where(keep, p_t, torch.zeros_like(p_t))
            ds_t = torch.where(keep, ds_t, torch.zeros_like(ds_t)) * scale
            dv[k0:k0 + BC] += _product(p_t, gt, route)
            dk[k0:k0 + BC] += _product(ds_t, qt, route)
            part[q0:q0 + br] = _product(ds_t.T, kt, route)
        parts.append(part)
    dq = torch.zeros(Sq, hd)
    for part in parts:  # key-tile order
        dq += part
    return dq, dk, dv


def _jax_grads(q, k, v, dout, kw):
    def f(q, k, v):
        return jref.flash_attention_ref(q, k, v, **kw)

    _, vjp = jax.vjp(f, *(jnp.asarray(a[None, None]) for a in (q, k, v)))
    return [np.asarray(g)[0, 0] for g in vjp(jnp.asarray(dout[None, None]))]


#: (causal, window, softcap); a softcap of 5 bites at these unit-variance
#: logits as Gemma-2's 50 does at a trained model's
CASES = {
    "causal": (True, 0, 0.0), "window": (True, 48, 0.0), "softcap": (True, 0, 5.0),
    "full": (False, 0, 0.0),
}

#: query rows a tile by head dim (`flash_attention_bwd_plan`)
ROWS = {64: 32, 112: 16, 256: 16}


def _inputs(hd, seed, S=160):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((S, hd)).astype(np.float32) for _ in range(4)]


def _rel_errors(got, want):
    return [float(np.abs(g.numpy() - w).max() / np.abs(w).max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hd", [64, 112, 256])
def test_3xtf32_backward_within_the_gradient_gate(hd, case):
    """dq, dk, dv of the kernel's arithmetic (a ragged last key tile: S =
    160) against JAX's vjp of its reference: within GRAD_REL of each
    gradient's max."""
    q, k, v, dout = _inputs(hd, 30 + hd)
    causal, window, softcap = CASES[case]
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v, dout)), causal=causal,
                   window=window, softcap=softcap, route="3xtf32", br=ROWS[hd])
    want = _jax_grads(q, k, v, dout, dict(causal=causal, window=window, softcap=softcap))
    errs = _rel_errors(got, want)
    assert max(errs) <= GRAD_REL, errs


@pytest.mark.parametrize("hd", [64, 112, 256])
def test_1xtf32_backward_misses_the_gradient_gate(hd):
    """Why every product splits its operands: one TF32 product per f32
    product lands outside GRAD_REL."""
    q, k, v, dout = _inputs(hd, 30 + hd)
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v, dout)), causal=True,
                   window=0, softcap=0.0, route="1xtf32", br=ROWS[hd])
    want = _jax_grads(q, k, v, dout, dict(causal=True, window=0, softcap=0.0))
    assert max(_rel_errors(got, want)) > GRAD_REL
