"""`repro_torch.prng` against `jax.random`, bit for bit (jax 0.9's
threefry2x32 with `jax_threefry_partitionable=True`, the default).

Keys, `split` (both outputs), `fold_in`, 32- and 64-bit draws and f32 /
f64 uniforms on a table of seeds and shapes, and the exact key chain the
compressors draw from (`repro/fed/strategies.py` `transform_correction`:
split, fold_in(sub, 2i + tag), fold_in(leaf_key, 0 | 1), uniform).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

pytestmark = pytest.mark.torch

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
