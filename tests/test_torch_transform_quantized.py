"""`transform_correction` of QuantizedGT in the port against the JAX
package's, bit for bit (the CompressedGT half of this gate is
`test_torch_transform.py`): the same corrections and state in, the same
bits of every output and of the new state out, round after round, with
the wire on and off, for every corrections dtype."""
import pytest

import repro.fed as jfed
from repro_torch import fed
from test_torch_parity import STRATEGIES, check_transform

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
@pytest.mark.parametrize("wire", [False, True], ids=["dense", "wire"])
@pytest.mark.parametrize("name", [n for n in STRATEGIES if n.startswith("qgt")])
def test_transform_correction_equals_jax(name, wire, dt):
    check_transform(jfed, fed, name, wire, dt)
