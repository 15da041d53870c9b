"""The port's `gt_update` against the JAX package's.

On the CPU the wrapper runs its plain version (`repro_torch.kernels.ref.
gt_update_ref`); these tests hold it against the Pallas kernel in
interpret mode and the JAX oracle on the same numpy inputs:

  * f32 / bf16 leaves, c in f32 / bf16 / fp8 e4m3: within 1 ulp of the
    output type at the operands' scale (max |z|, |eta (g + c)|, |out|).
    Both compute in f32, but XLA contracts the Pallas body's multiply-add
    into an FMA and torch rounds each operation, so they differ by at
    most one rounding of the sum (max 2.4e-7 in f32 on N(0, 1) data).
  * f64: bit for bit equal to `ref.gt_update_ref` (the Pallas body
    downcasts f64 to f32; the port computes in f64).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py
holds it against the plain version there (bit for bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gt_update_2d, make_gt_update_fn as jax_make_update
from repro.kernels import ref as jax_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import default_update
from repro_torch.kernels import gt_update, make_gt_update_fn, ref

pytestmark = pytest.mark.torch

ETA = 3e-3
JDT = {
    "f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16,
    "fp8": jnp.float8_e4m3fn,
}
TDT = {
    "f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}
NARROW_PAIRS = [
    ("f32", "f32"), ("f32", "bf16"), ("f32", "fp8"),
    ("bf16", "bf16"), ("bf16", "fp8"),
]


def _inputs(shape, zdt, cdt, seed=0):
    """Seeded numpy draws cast by JAX; the torch side gets the same bits
    through `convert.tensor_from_numpy`."""
    rng = np.random.default_rng(seed)
    z, g, c = (rng.standard_normal(shape) for _ in range(3))
    jz = jnp.asarray(z).astype(JDT[zdt])
    jg = jnp.asarray(g).astype(JDT[zdt])
    jc = jnp.asarray(c).astype(JDT[cdt])
    tz, tg, tc = (tensor_from_numpy(np.asarray(a), "cpu") for a in (jz, jg, jc))
    return (jz, jg, jc), (tz, tg, tc)


def _as_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _assert_within_one_ulp(got, want, dtype: str, z, g, c):
    """|got - want| <= 1 ulp of `dtype` at the scale of the operands: an
    FMA and a separately rounded multiply-add differ by one rounding of
    the sum, which cancellation can make large against a tiny result."""
    g64, w = _as_f64(got), _as_f64(want)
    scale = np.maximum.reduce([
        np.abs(_as_f64(z)), ETA * (np.abs(_as_f64(g)) + np.abs(_as_f64(c))),
        np.abs(g64), np.abs(w),
    ])
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    if dtype == "bf16":
        ulp *= 2.0 ** 16  # 8 significant bits instead of f32's 24
    err = np.abs(g64 - w)
    assert np.all(err <= ulp), (dtype, float(np.max(err / ulp)))


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("shape", [(8, 128), (256, 384)])
    @pytest.mark.parametrize("pair", NARROW_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_within_one_ulp_of_the_interpret_kernel(self, shape, pair, sign):
        zdt, cdt = pair
        (jz, jg, jc), (tz, tg, tc) = _inputs(shape, zdt, cdt)
        want = gt_update_2d(
            jz, jg, jc, eta=ETA, sign=sign, block_rows=min(128, shape[0]),
            interpret=True,
        )
        got = gt_update(tz, tg, tc, eta=ETA, sign=sign)
        assert got.dtype == TDT[zdt] and tuple(got.shape) == shape
        _assert_within_one_ulp(got, want, zdt, tz, tg, tc)

    @pytest.mark.parametrize("cdt", ["f64", "f32", "bf16", "fp8"])
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_f64_bitwise_equals_the_jax_oracle(self, cdt, sign):
        (jz, jg, jc), (tz, tg, tc) = _inputs((33, 70), "f64", cdt, seed=1)
        want = np.asarray(jax_ref.gt_update_ref(jz, jg, jc, ETA, sign))
        got = gt_update(tz, tg, tc, eta=ETA, sign=sign)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want)

    def test_f64_keeps_precision_the_pallas_body_drops(self):
        """The Pallas body computes f64 leaves in f32 (~1e-7 off the
        oracle); the port's f64 path is exact to the oracle."""
        (jz, jg, jc), (tz, tg, tc) = _inputs((8, 128), "f64", "f64", seed=2)
        want = np.asarray(jax_ref.gt_update_ref(jz, jg, jc, ETA, -1.0))
        pallas = np.asarray(
            gt_update_2d(jz, jg, jc, eta=ETA, sign=-1.0, interpret=True)
        )
        got = gt_update(tz, tg, tc, eta=ETA, sign=-1.0).numpy()
        assert np.max(np.abs(pallas - want)) > 1e-9
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("pair", NARROW_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
    def test_ragged_pytree_leaves_within_one_ulp(self, pair):
        """The JAX wrapper pads leaves to [rows, 128]; the port takes any
        shape.  Same values on ragged leaves (c is cast up by the JAX
        wrapper and read in its stored type by the port: both exact)."""
        zdt, cdt = pair
        shapes = [(17,), (3, 5), (130, 7)]
        leaves = [_inputs(s, zdt, cdt, seed=10 + i) for i, s in enumerate(shapes)]
        jtrees = [{f"l{i}": lv[0][j] for i, lv in enumerate(leaves)} for j in range(3)]
        ttrees = [{f"l{i}": lv[1][j] for i, lv in enumerate(leaves)} for j in range(3)]
        want = jax_make_update(interpret=True, use_kernel=True)(*jtrees, ETA, 1.0)
        got = make_gt_update_fn()(*ttrees, ETA, 1.0)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            _assert_within_one_ulp(
                got[k], want[k], zdt, ttrees[0][k], ttrees[1][k], ttrees[2][k]
            )


class TestWrapper:
    @pytest.mark.parametrize("zdt", ["f64", "f32"])
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_bitwise_equals_default_update_on_wide_leaves(self, zdt, sign):
        """The kernel-backed update_fn is exactly the engine's plain
        default_update on f64 and f32 leaves."""
        _, (tz, tg, tc) = _inputs((6, 31), zdt, zdt, seed=3)
        got = make_gt_update_fn()({"a": tz}, {"a": tg}, {"a": tc}, ETA, sign)
        want = default_update({"a": tz}, {"a": tg}, {"a": tc}, ETA, sign)
        assert torch.equal(got["a"], want["a"])

    def test_rejects_what_the_kernel_does_not_take(self):
        z = torch.zeros(4, 8, dtype=torch.float32)
        with pytest.raises(ValueError, match="shapes"):
            gt_update(z, z, torch.zeros(4, 7), eta=ETA, sign=1.0)
        with pytest.raises(TypeError, match="unsupported dtypes"):
            gt_update(z, z.double(), z, eta=ETA, sign=1.0)
        with pytest.raises(TypeError, match="unsupported dtypes"):
            bf = z.to(torch.bfloat16)
            gt_update(bf, bf, z, eta=ETA, sign=1.0)
        with pytest.raises(ValueError, match="contiguous"):
            zt = torch.zeros(8, 4).t()
            gt_update(zt, zt, zt, eta=ETA, sign=1.0)

    def test_plain_path_launches_no_kernel(self):
        gt_update.launches = 0
        z = torch.ones(5, dtype=torch.float64)
        gt_update(z, z, z, eta=ETA, sign=-1.0)
        assert gt_update.launches == 0

    def test_plain_version_dtype_rules(self):
        assert ref.compute_dtype(torch.float64) == torch.float64
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            assert ref.compute_dtype(dt) == torch.float32
