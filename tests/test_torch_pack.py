"""The wire-payload plain versions of the port (`ref.pack_payload_ref`,
`ref.decode_payload_ref`) against the JAX package's
oracles, bit for bit, on the same numpy inputs: f64 and f32 corrections
here (bf16 and fp8, and the word packer, in `test_torch_pack_narrow.py`),
every encoding and bit width, both index widths, top-k and rand-k, and
rows with NaN (which keep fewer than k entries and pad their payload as
JAX does)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from test_torch_parity import (
    DT,
    ENCODINGS,
    PACK_CASES,
    assert_same,
    check_pack_and_decode,
    make_leaf,
)

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("encoding,bits", PACK_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_pack_and_decode_ref_equal_jax(dt, encoding, bits):
    check_pack_and_decode(dt, encoding, bits)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_pack_ref_with_nan_rows_equals_jax(encoding):
    """A NaN row keeps fewer than k entries; its payload pads like JAX's
    (indices C + j, level 0, value NaN) and decodes like it."""
    rng = np.random.default_rng(5)
    for dt, mode in itertools.product(["f64", "f32"], ["topk", "randk"]):
        jdt, tdt = DT[dt]
        jx, tx = make_leaf(rng, 3, 37, dt, True, nan_every=3)
        for k in (4, 18):
            kw = dict(k=k, bits=8, mode=mode, encoding=encoding)
            want = jref.pack_payload_ref(*jx, index_dtype=jnp.int32, **kw)
            got = ref.pack_payload_ref(*tx, index_dtype=torch.int32, **kw)
            for w, g, name in zip(want, got, ("data", "idx", "scale", "resid")):
                assert_same(w, g, f"{name} {dt} {mode} k={k}")
            dk = dict(cols=37, k=k, bits=8, encoding=encoding)
            assert_same(jref.decode_payload_ref(*want[:3], dtype=jdt, **dk),
                        ref.decode_payload_ref(*got[:3], dtype=tdt, **dk))
