"""The port's scan backward (`csrc/ssm_scan_bwd.cu`) on the CPU: its chunk
length against the forward's chunk-state output, and its algorithm,
emulated in f32 numpy, against JAX's gradient of its `ref.ssm_scan_ref`
(`jax.vjp`) on the same inputs, within the card gate's GRAD_REL (1e-4
of each gradient's max |value|).

The kernel walks the sequence backwards chunk by chunk: from the state
the forward stored entering each chunk of `chunk_len(N)` steps it
recomputes the chunk's states (in place of dbx, in shared memory), then
runs dh_t = c_t dy_t + da_{t+1} dh_{t+1} over the chunk with h_{t-1} at
hand: d dbx_t = dh_t, d da_t = dh_t o h_{t-1} (summed over the states,
and over P for a per-head decay, where da broadcasts), dc_t = the sum
over rows of h_t dy_t, and d state0 = da_0 dh_0 after the first chunk.
The emulation repeats those steps; the card tests hold the kernel to the
plain version."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels.ssm_scan import _launch, chunk_len

pytestmark = pytest.mark.torch

GRAD_REL = 1e-4  # chip_smoke's and the card tests' gate


@pytest.mark.parametrize("N", [1, 5, 16, 64, 100, 128, 129, 256])
@pytest.mark.parametrize("S", [1, 8, 16, 37])
def test_chunk_len_is_the_forwards_chunk_state_shape(S, N):
    """16 steps a chunk up to 128 states, 8 above; `_launch(...,
    chunks=True)` (an empty problem, which launches nothing) hands the
    backward [B, ceil(S / T), H, P, N] chunk states of that T."""
    T = chunk_len(N)
    assert T == (16 if N <= 128 else 8)
    dbx = torch.zeros(2, S, 0, 3, N)
    y, state, chunks = _launch(torch.zeros_like(dbx), dbx, torch.zeros(2, S, N), None,
                               chunks=True)
    assert tuple(chunks.shape) == (2, math.ceil(S / T), 0, 3, N)
    assert tuple(y.shape) == (2, S, 0, 3) and tuple(state.shape) == (2, 0, 3, N)


def _emulate(da, dbx, c, s0, dy, dstate, decay):
    """(d da, d dbx, d c, d state0) of one sequence (dbx [S, H, P, N], da
    [S, H, 1, 1] ("head"), [S, H, P, 1] ("chan") or dbx's shape ("full"),
    c [S, N], state0 / dstate [H, P, N], dy [S, H, P]; f32 numpy) by the
    kernel's chunked algorithm."""
    S = dbx.shape[0]
    T = chunk_len(dbx.shape[-1])
    a = np.broadcast_to(da, dbx.shape)
    h, chunks = s0.copy(), []
    for t in range(S):  # the forward, storing the state entering each chunk
        if t % T == 0:
            chunks.append(h.copy())
        h = a[t] * h + dbx[t]
    ddbx = np.zeros_like(dbx)
    dda = np.zeros(dbx.shape if decay == "full" else dbx.shape[:3], np.float32)
    dc = np.zeros_like(c)
    dh = dstate.copy()
    for k in reversed(range(len(chunks))):
        t0 = k * T
        hs = [chunks[k]]  # h_{t0 - 1}, then the chunk's recomputed states
        for t in range(t0, min(S, t0 + T)):
            hs.append(a[t] * hs[-1] + dbx[t])
        for t in reversed(range(t0, min(S, t0 + T))):
            dh = dh + c[t] * dy[t][..., None]
            ddbx[t] = dh
            prod = dh * hs[t - t0]
            dda[t] = prod if decay == "full" else prod.sum(-1)
            dc[t] = (hs[t - t0 + 1] * dy[t][..., None]).sum((0, 1))
            dh = dh * a[t]
    if decay == "head":
        dda = dda.sum(-1)[..., None, None]
    elif decay == "chan":
        dda = dda[..., None]
    return dda, ddbx, dc, dh


def _jax_grads(da, dbx, c, s0, dy, dstate):
    S, H, P, N = dbx.shape

    def f(da, dbx, c, s0):
        y, state = jref.ssm_scan_ref(jnp.broadcast_to(da, dbx.shape).reshape(S, H * P, N),
                                     dbx.reshape(S, H * P, N), c, s0.reshape(H * P, N))
        return y.reshape(S, H, P), state.reshape(H, P, N)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (da, dbx, c, s0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dstate)))]


@pytest.mark.parametrize("case", [
    # (S, H, P, N, decay)
    (37, 3, 12, 16, "head"),   # S not a multiple of 16, Mamba-2's per-head decay
    (21, 2, 4, 256, "head"),   # N 256: chunks of 8
    (33, 5, 1, 20, "full"),    # Mamba-1's decay, full over the states
    (40, 4, 2, 64, "chan"),    # da per channel, broadcast over the states
    (16, 2, 3, 130, "full"),   # two chunks of 8 steps at N > 128
], ids=["head-s37", "head-n256", "full-n20", "chan-n64", "full-n130"])
def test_emulated_backward_matches_jax_vjp(case):
    S, H, P, N, decay = case
    rng = np.random.default_rng(S * N + H)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    da_shape = {"head": (S, H, 1, 1), "chan": (S, H, P, 1), "full": (S, H, P, N)}[decay]
    da = (0.95 / (1 + np.exp(-f32(*da_shape)))).astype(np.float32)
    dbx, c, s0 = 0.1 * f32(S, H, P, N), f32(S, N), f32(H, P, N)
    dy, dstate = f32(S, H, P), f32(H, P, N)
    got = _emulate(da, dbx, c, s0, dy, dstate, decay)
    want = _jax_grads(da, dbx, c, s0, dy, dstate)
    for name, g, w in zip(("dda", "ddbx", "dc", "dstate0"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = float(np.abs(g - w).max()) / float(np.abs(w).max())
        assert err <= GRAD_REL, (name, err)
