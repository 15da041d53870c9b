"""`repro_torch.prng` against `jax.random`, bit for bit (jax 0.9's
threefry2x32 with `jax_threefry_partitionable=True`, the default).

Keys, `split` (both outputs), `fold_in`, 32- and 64-bit draws, f32 /
f64 uniforms, Bernoulli and Rademacher draws on a table of seeds and
shapes, and the exact key chain the
compressors draw from (`repro/fed/strategies.py` `transform_correction`:
split, fold_in(sub, 2i + tag), fold_in(leaf_key, 0 | 1), uniform).
`randint` (int32 and int64), `permutation` and the scaled uniforms bit for
bit; `normal` within the ulp bound stated below; key batches equal to the
vmapped JAX functions and to stacked single-key draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

from test_torch_parity import one_torch_thread  # noqa: F401

# the small draws and rounds are bound by per-op host overhead; intra-op
# threads only contend with the other test workers
pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("one_torch_thread")]

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5]
SHAPES = [(), (7,), (3, 130), (16, 4096)]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _same_bits(a: np.ndarray, b: torch.Tensor) -> bool:
    a = np.asarray(a).reshape(-1)
    b = b.numpy().reshape(-1)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_words(jk), tk.numpy())
    for num in (2, 3):
        assert np.array_equal(_words(jax.random.split(jk, num)),
                              prng.split(tk, num).numpy())
    for i in range(4):
        for tag in (0, 1):
            d = 2 * i + tag
            assert np.array_equal(_words(jax.random.fold_in(jk, d)),
                                  prng.fold_in(tk, d).numpy())
    assert np.array_equal(_words(jax.random.fold_in(jk, 2 ** 32 - 1)),
                          prng.fold_in(tk, 2 ** 32 - 1).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_uniform_bitwise(seed, shape, dtype):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jdt)
    got = prng.uniform(prng.PRNGKey(seed), shape, tdt, device="cpu")
    assert tuple(got.shape) == shape
    assert _same_bits(want, got)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_32_and_64(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    b32 = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(b32, prng.random_bits(tk, 32, shape, "cpu").numpy())
    b64 = np.asarray(jax.random.bits(jk, shape, jnp.uint64)).view(np.int64)
    assert np.array_equal(b64, prng.random_bits(tk, 64, shape, "cpu").numpy())


def test_default_uniform_is_f64_as_under_x64():
    """The strategies call `jax.random.uniform(key, shape)` with no dtype;
    with `jax_enable_x64` (every experiment of the repository) that is an
    f64 draw, the port's default."""
    want = jax.random.uniform(jax.random.PRNGKey(3), (5, 9))
    assert want.dtype == jnp.float64
    assert _same_bits(want, prng.uniform(prng.PRNGKey(3), (5, 9), device="cpu"))


@pytest.mark.parametrize("seed", [0, 7])
def test_the_compressors_key_chain(seed):
    """`strategies.py:453-481`: one split per round, then per leaf i and
    side tag the selection and rounding uniforms, over three rounds."""
    jkey, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    shape = (8, 20)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        assert np.array_equal(_words(jkey), tkey.numpy())
        assert np.array_equal(_words(jsub), tsub.numpy())
        for i in range(2):
            for tag in (0, 1):
                jl = jax.random.fold_in(jsub, 2 * i + tag)
                tl = prng.fold_in(tsub, 2 * i + tag)
                for which in (0, 1):
                    want = jax.random.uniform(jax.random.fold_in(jl, which), shape)
                    got = prng.uniform(prng.fold_in(tl, which), shape, device="cpu")
                    assert _same_bits(want, got)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_bitwise(seed, shape):
    """p = 0.5 as a Python float (weakly typed: f64 uniforms under x64),
    and f32 / f64 p arrays (the uniforms take p's dtype)."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.bernoulli(jk, 0.5, shape))
    got = prng.bernoulli(tk, 0.5, shape, device="cpu")
    assert got.dtype == torch.bool and np.array_equal(want, got.numpy())
    n = int(np.prod(shape))
    p = np.linspace(0.0, 1.0, n).reshape(shape)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = np.asarray(jax.random.bernoulli(jk, jnp.asarray(p, jdt)))
        got = prng.bernoulli(tk, torch.tensor(p, dtype=tdt))
        assert tuple(got.shape) == shape
        assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["f64", "f32", "int"])
def test_rademacher_bitwise(seed, shape, dtype):
    """+1 / -1 in the target dtype; JAX's default under x64 is int64."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32),
                "int": (None, torch.int64)}[dtype]
    want = np.asarray(jax.random.rademacher(jax.random.PRNGKey(seed), shape, jdt))
    got = prng.rademacher(prng.PRNGKey(seed), shape, tdt, device="cpu").numpy()
    assert want.dtype == got.dtype
    assert np.array_equal(want.reshape(-1).view(np.uint8), got.reshape(-1).view(np.uint8))


def test_threefry_on_tensors_equals_on_ints():
    """The hash is one function of Python ints and of int64 tensors."""
    rng = np.random.default_rng(0)
    k1, k2 = (int(v) for v in rng.integers(0, 2 ** 32, 2))
    x0 = rng.integers(0, 2 ** 32, 50)
    x1 = rng.integers(0, 2 ** 32, 50)
    t0, t1 = prng.threefry2x32(k1, k2, torch.tensor(x0), torch.tensor(x1))
    for i in range(50):
        assert prng.threefry2x32(k1, k2, int(x0[i]), int(x1[i])) == (
            int(t0[i]), int(t1[i]))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="float64 or float32"):
        prng.uniform(prng.PRNGKey(0), (3,), torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="32 or 64"):
        prng.random_bits(prng.PRNGKey(0), 16, (3,), "cpu")
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.fold_in(torch.zeros(3, dtype=torch.int64), 1)


# ------------------------------------------------ randint, permutation, normal
#: (minval, maxval): spans that are and are not powers of 2, maxval <=
#: minval (always minval), and, for int32, maxval above the dtype's range
#: (one larger span; 2^32 wraps to 0)
RANDINT_RANGES = [(0, 10), (0, 1024), (-5, 1000), (0, 3), (7, 7), (9, 2),
                  (-(2 ** 20), 2 ** 20 + 3), (0, 2 ** 31 - 1), (0, 2 ** 31),
                  (-(2 ** 31), 2 ** 31), (-7, 2 ** 32)]


@pytest.mark.parametrize("lo,hi", RANDINT_RANGES, ids=str)
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_randint_bitwise(lo, hi, dtype):
    jdt, tdt = {"int64": (jnp.int64, torch.int64), "int32": (jnp.int32, torch.int32)}[dtype]
    if dtype == "int64" and hi - lo > 2 ** 32:
        with pytest.raises(ValueError, match="above 2\\^32"):
            prng.randint(prng.PRNGKey(0), (3,), lo, hi, tdt, "cpu")
        return
    for seed in SEEDS[:3]:
        for shape in [(), (7,), (3, 130)]:
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                                 lo, hi, jdt))
            got = prng.randint(prng.PRNGKey(seed), shape, lo, hi, tdt, "cpu")
            assert got.dtype == tdt and tuple(got.shape) == shape
            assert np.array_equal(want, got.numpy()), (seed, shape)


def test_randint_narrow_dtype_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        prng.randint(prng.PRNGKey(0), (3,), 0, 5, torch.int16, "cpu")


@pytest.mark.parametrize("n", [1, 2, 8, 1000, 2000])
def test_permutation_bitwise(n):
    """n = 2000 takes two rounds of sort keys (n > 1,625)."""
    for seed in SEEDS:
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = prng.permutation(prng.PRNGKey(seed), n, "cpu")
        assert got.dtype == torch.int64
        assert np.array_equal(want, got.numpy())
    x = np.arange(n * 3).reshape(n, 3) * 1.5
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(5), jnp.asarray(x)))
    assert np.array_equal(want, prng.permutation(prng.PRNGKey(5), torch.tensor(x)).numpy())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_scaled_uniform_bitwise(dtype):
    """minval / maxval as JAX computes them: normal's (nextafter(-1, 0), 1)
    and ranges whose multiply-add rounds (XLA fuses it)."""
    jdt, tdt, npdt = {"f64": (jnp.float64, torch.float64, np.float64),
                      "f32": (jnp.float32, torch.float32, np.float32)}[dtype]
    lo = float(np.nextafter(npdt(-1.0), npdt(0.0)))
    for a, b in [(lo, 1.0), (-3.0, 5.5), (0.1, 0.3)]:
        for seed in SEEDS[:3]:
            want = jax.random.uniform(jax.random.PRNGKey(seed), (40, 129), jdt, a, b)
            got = prng.uniform(prng.PRNGKey(seed), (40, 129), tdt, "cpu", a, b)
            assert _same_bits(want, got), (a, b, seed)


#: the largest distance of the port's normals from JAX's, in ulp, over
#: the seeds and shapes below (measured: 3 in f32, 30 in f64; 4.6% and 11%
#: of the draws differ at all): XLA's erf_inv polynomial is followed op
#: for op, but torch's log1p is another implementation than XLA's and
#: XLA fuses multiply-adds
NORMAL_ULP = {"f32": 3, "f64": 30}


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    it = {4: np.int32, 8: np.int64}[a.dtype.itemsize]
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_normal_within_its_ulp_bound(dtype):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    worst = 0
    for seed in SEEDS:
        for shape in [(7,), (3, 130), (16, 4096)]:
            want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jdt))
            got = prng.normal(prng.PRNGKey(seed), shape, tdt, "cpu").numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            worst = max(worst, int(_ulp(want, got).max()))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (200_000,), jdt))
    got = prng.normal(prng.PRNGKey(3), (200_000,), tdt, "cpu").numpy()
    worst = max(worst, int(_ulp(want, got).max()))
    assert worst <= NORMAL_ULP[dtype], worst


def test_normal_narrow_dtype_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        prng.normal(prng.PRNGKey(0), (3,), torch.bfloat16, "cpu")


def test_erf_inv_edges():
    """+-1 map to +-inf, 0 to 0, and the f64 branches (w < 6.25, < 16 and
    beyond) meet JAX's erf_inv within the normal's bound."""
    x = np.array([-1.0, -0.999999999, -0.9999, -0.5, 0.0, 0.25, 0.99, 1 - 1e-15, 1.0])
    got = prng.erf_inv(torch.tensor(x)).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[-1]) and got[-1] > 0
    assert got[4] == 0.0
    assert int(_ulp(want[1:-1], got[1:-1]).max()) <= NORMAL_ULP["f64"]


def test_batched_keys_equal_vmapped_jax_and_stacked_draws():
    jsub = jax.random.split(jax.random.PRNGKey(9))[1]
    tsub = prng.split(prng.PRNGKey(9))[1]
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jsub, jnp.arange(6))
    tk = prng.fold_in(tsub, np.arange(6))
    assert np.array_equal(_words(jk), tk.numpy())
    je = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, 3)
    te = prng.fold_in(tk, 3)
    assert np.array_equal(_words(je), te.numpy())
    assert np.array_equal(_words(jax.vmap(jax.random.split)(je)), prng.split(te).numpy())
    # [E, m] at once: eval indices against agent keys
    grid = prng.fold_in(tk[None], np.arange(4)[:, None])
    assert torch.equal(grid[2], prng.fold_in(tk, 2))
    for name, draw in [
        ("normal", lambda k: prng.normal(k, (5, 3), torch.float64, "cpu")),
        ("normal32", lambda k: prng.normal(k, (5,), torch.float32, "cpu")),
        ("uniform", lambda k: prng.uniform(k, (4,), torch.float64, "cpu")),
        ("randint", lambda k: prng.randint(k, (6,), 0, 37, torch.int64, "cpu")),
        ("randint32", lambda k: prng.randint(k, (6,), -3, 9, torch.int32, "cpu")),
        ("bits", lambda k: prng.random_bits(k, 64, (3,), "cpu")),
        ("rademacher", lambda k: prng.rademacher(k, (8,), torch.float64, "cpu")),
    ]:
        stacked = torch.stack([draw(k) for k in te])
        assert torch.equal(draw(te), stacked), name
        nested = torch.stack([torch.stack([draw(k) for k in row]) for row in grid])
        assert torch.equal(draw(grid), nested), name
    want = jax.vmap(lambda k: jax.random.randint(k, (6,), 0, 37))(je)
    assert np.array_equal(np.asarray(want), prng.randint(te, (6,), 0, 37, device="cpu").numpy())
    want = jax.vmap(lambda k: jax.random.normal(k, (5,)))(je)
    got = prng.normal(te, (5,), device="cpu").numpy()
    assert int(_ulp(np.asarray(want), got).max()) <= NORMAL_ULP["f64"]
