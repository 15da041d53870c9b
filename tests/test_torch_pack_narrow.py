"""The wire-payload plain versions of the port against the JAX package's
oracles, bit for bit, for bf16 and fp8 corrections (f64 and f32 are
`test_torch_pack.py`): every encoding and bit width, both index widths,
top-k and rand-k; and the uint32 word packer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from test_torch_parity import BITS, PACK_CASES, assert_same, check_pack_and_decode

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("encoding,bits", PACK_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("dt", ["bf16", "fp8"])
def test_pack_and_decode_ref_equal_jax(dt, encoding, bits):
    check_pack_and_decode(dt, encoding, bits)


def test_word_packing_equals_jax():
    rng = np.random.default_rng(2)
    for bits in BITS[:-1] + [20]:
        sb = ref.storage_bits(bits)
        assert sb == jref.storage_bits(bits)
        for k in (1, 5, 33, 100):
            assert ref.word_layout(k, bits) == jref.word_layout(k, bits)
            lv = rng.integers(0, 2 ** sb, (3, k), dtype=np.int64)
            want = jref.pack_words(jnp.asarray(lv.astype(np.uint32)), bits)
            got = ref.pack_words(torch.tensor(lv), bits)
            assert_same(want, got)
            np.testing.assert_array_equal(
                ref.unpack_words(got, k, bits).numpy(), lv)


