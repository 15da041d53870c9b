"""The port's `ssm_scan` / `batched_ssm_scan` (their plain versions, which
a CPU tensor runs) against JAX's Pallas `ssm_scan` in interpret mode and
its `ref.ssm_scan_ref`, on the same numpy inputs: y and the final state,
from a zero and from a non-zero state0, with Mamba-2's per-head decay
[B, S, H, 1, 1] and Mamba-1's full decay handed over unexpanded.
Tolerance rtol = atol = 1e-4, as in `tests/test_kernels.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import batched_ssm_scan as jbatched
from repro.kernels import ref as jref
from repro.kernels import ssm_scan as jscan
from repro_torch.kernels import batched_ssm_scan, ref, ssm_scan

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-4, atol=1e-4)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _inputs(seed, da_shape, dbx_shape, c_shape, decay=0.95):
    """Decay in (0, 1) for stability, like exp(-softplus) in mamba."""
    rng = np.random.default_rng(seed)
    da = (_sigmoid(rng.standard_normal(da_shape)) * decay).astype(np.float32)
    dbx = (rng.standard_normal(dbx_shape) * 0.1).astype(np.float32)
    c = rng.standard_normal(c_shape).astype(np.float32)
    return da, dbx, c


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("S,D,N", [(64, 128, 16), (128, 128, 8), (256, 256, 16)])
def test_one_sequence_matches_jax_kernel_and_ref(S, D, N):
    da, dbx, c = _inputs(0, (S, D, N), (S, D, N), (S, N))
    y, state = ssm_scan(_t(da), _t(dbx), _t(c))
    assert y.shape == (S, D) and state.shape == (D, N)
    want_y = jscan(jnp.asarray(da), jnp.asarray(dbx), jnp.asarray(c), chunk=32,
                   interpret=True)
    ref_y, ref_state = jref.ssm_scan_ref(jnp.asarray(da), jnp.asarray(dbx),
                                         jnp.asarray(c), jnp.zeros((D, N)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), **TOL)


def test_nonzero_state0():
    S, D, N = 96, 64, 16
    da, dbx, c = _inputs(1, (S, D, N), (S, D, N), (S, N))
    s0 = np.random.default_rng(2).standard_normal((D, N)).astype(np.float32)
    y, state = ssm_scan(_t(da), _t(dbx), _t(c), _t(s0))
    ref_y, ref_state = jref.ssm_scan_ref(jnp.asarray(da), jnp.asarray(dbx),
                                         jnp.asarray(c), jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), **TOL)
    y0, _ = ssm_scan(_t(da), _t(dbx), _t(c))
    assert float((y - y0).abs().max()) > 1e-2  # state0 reaches y


def test_batched_wrapper_matches_jax():
    B, S, D, N = 2, 64, 128, 8
    da, dbx, c = _inputs(2, (B, S, D, N), (B, S, D, N), (B, S, N), decay=0.9)
    want = jbatched(jnp.asarray(da), jnp.asarray(dbx), jnp.asarray(c), chunk=32,
                    interpret=True)
    for use_kernel in (True, False):
        y, state = batched_ssm_scan(_t(da), _t(dbx), _t(c), use_kernel=use_kernel)
        assert y.shape == (B, S, D) and state.shape == (B, D, N)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


def _jax_scan_5d(da, dbx, c, s0):
    """JAX's reference over [B, S, H, P, N] with da broadcast to dbx."""
    B, S, H, P, N = dbx.shape
    da = jnp.broadcast_to(jnp.asarray(da), dbx.shape).reshape(B, S, H * P, N)
    fn = jax.vmap(jref.ssm_scan_ref)
    y, st = fn(da, jnp.asarray(dbx).reshape(B, S, H * P, N), jnp.asarray(c),
               jnp.asarray(s0).reshape(B, H * P, N))
    return np.asarray(y).reshape(B, S, H, P), np.asarray(st).reshape(B, H, P, N)


@pytest.mark.parametrize("variant", ["mamba2", "mamba1"])
def test_broadcast_decay_of_both_mamba_shapes(variant):
    """Mamba-2's decay [B, S, H, 1, 1] (scalar per head) and Mamba-1's
    [B, S, D, 1, N] (per channel and state), unexpanded, from a non-zero
    state, against JAX's reference on the expanded decay."""
    B, S, N = 2, 48, 16
    H, P = (6, 8) if variant == "mamba2" else (40, 1)
    da_shape = (B, S, H, 1, 1) if variant == "mamba2" else (B, S, H, 1, N)
    da, dbx, c = _inputs(3, da_shape, (B, S, H, P, N), (B, S, N))
    s0 = np.random.default_rng(4).standard_normal((B, H, P, N)).astype(np.float32)
    y, state = batched_ssm_scan(_t(da), _t(dbx), _t(c), _t(s0))
    want_y, want_state = _jax_scan_5d(da, dbx, c, s0)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(state.numpy(), want_state, **TOL)


def test_strided_c_and_ragged_shapes():
    """c as a strided column slice (as the model's split gives it), D and N
    not powers of two."""
    B, S, D, N = 1, 33, 37, 12
    da, dbx, _ = _inputs(5, (B, S, D, 1), (B, S, D, N), (B, S, N))
    wide = np.random.default_rng(6).standard_normal((B, S, 3 * N)).astype(np.float32)
    c = _t(wide)[..., N:2 * N]
    assert not c.is_contiguous()
    y, state = ssm_scan(_t(da), _t(dbx), c)
    want_y, want_state = _jax_scan_5d(da[..., None], dbx[:, :, :, None],
                                      wide[..., N:2 * N], np.zeros((B, D, N), np.float32))
    np.testing.assert_allclose(y.numpy(), want_y[..., 0], **TOL)
    np.testing.assert_allclose(state.numpy(), want_state[:, :, 0], **TOL)


def test_plain_version_runs_on_cpu_without_a_launch():
    B, S, H, P, N = 1, 9, 2, 3, 4
    da, dbx, c = _inputs(7, (B, S, H, 1, 1), (B, S, H, P, N), (B, S, N))
    ssm_scan.launches = 0
    y, state = ssm_scan(_t(da), _t(dbx), _t(c))
    want = ref.ssm_scan_ref(_t(da).expand(B, S, H, P, N), _t(dbx), _t(c))
    assert torch.equal(y, want[0]) and torch.equal(state, want[1])
    assert ssm_scan.launches == 0


def test_raises_on_what_it_does_not_take():
    S, D, N = 4, 3, 2
    z = torch.zeros(S, D, N)
    with pytest.raises(TypeError):
        ssm_scan(z.double(), z.double(), torch.zeros(S, N, dtype=torch.float64))
    with pytest.raises(ValueError, match="broadcast"):
        ssm_scan(torch.zeros(S, D + 1, N), z, torch.zeros(S, N))
    with pytest.raises(ValueError, match="c_coef"):
        ssm_scan(z, z, torch.zeros(S, N + 1))
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(z, torch.zeros(S, N, D).transpose(1, 2), torch.zeros(S, N))
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros(S, D, 300)
        ssm_scan(big, big, torch.zeros(S, 300))
    with pytest.raises(ValueError, match="state0"):
        ssm_scan(z, z, torch.zeros(S, N), torch.zeros(D + 1, N))
