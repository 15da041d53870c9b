"""The packed wire transport of the port (`repro_torch.fed.transport`)
against the JAX package's (`repro.fed.transport`):

  * layout: `LeafSpec` (encoding, k, widths, bytes) equal to JAX's over a
    table of shapes, dtypes, ratios and bits, including the uint16 indices
    of rows between 2^15 and 2^16 columns (`test_transport.py:188`);
  * round trip: decode(encode(c)) is the dense compressed correction bit
    for bit (a kept -0.0 lands as +0.0, as in JAX's scatter-add) in every
    encoding, and the residuals of the two paths are the same bits;
  * engine: wire on and wire off give the same iterates bit for bit
    through whole rounds (`test_transport.py:360`), and the identity
    configuration is GradientTracking;
  * bytes: a PackedTree moves exactly the LeafSpec price, and
    `measured_bytes_per_round` equals JAX's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fed as jfed
from repro.fed import transport as jtransport
from repro_torch import core, fed
from repro_torch.convert import problem_from_numpy
from repro_torch.fed import transport
from repro_torch.fixtures import load_compressed_rounds
from repro_torch.kernels import compress_leaf
from test_torch_parity import DT, ENCODINGS, assert_same, seed_of

pytestmark = pytest.mark.torch

SHAPES = [(256,), (37,), (4, 32), (2, 3, 64), (), (3,), (10,), (100,),
          (1000,), (40000,), (2 ** 16,), (2 ** 16 + 1,), (2 ** 17, 8)]
CONFIGS = [  # (ratio, bits, mode)
    (0.25, 32, "topk"), (0.25, 8, "topk"), (0.5, 4, "randk"),
    (1.0, 8, "topk"), (1.0, 2, "topk"), (0.1, 16, "randk"),
    (0.9, 8, "topk"), (0.001, 32, "topk"),
]


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("ratio,bits,mode", CONFIGS)
def test_leaf_spec_equals_jax(ratio, bits, mode, dt):
    jdt, tdt = DT[dt]
    for shape in SHAPES:
        want = jtransport.LeafSpec.build(shape, jdt, ratio, bits, mode)
        got = transport.LeafSpec.build(shape, tdt, ratio, bits, mode)
        tag = f"{shape}"
        assert (got.rows, got.cols, got.k, got.bits, got.mode, got.encoding) == (
            want.rows, want.cols, want.k, want.bits, want.mode, want.encoding), tag
        assert got.dtype == tdt
        assert got.index_dtype.itemsize == np.dtype(want.index_dtype).itemsize, tag
        assert got.index_dtype.is_signed == np.issubdtype(want.index_dtype,
                                                          np.signedinteger)
        assert got.scale_dtype.itemsize == np.dtype(want.scale_dtype).itemsize
        assert got.words_per_row == want.words_per_row, tag
        assert got.wire_bytes() == want.wire_bytes(), tag
        assert got.total_bytes() == want.total_bytes(), tag
        assert got.stacked(5).wire_bytes() == want.stacked(5).wire_bytes()
        assert transport.wire_rows_cols(shape) == jtransport.wire_rows_cols(shape)


def test_index_width_derives_from_row_length():
    F32 = torch.float32
    assert transport.LeafSpec.build((100,), F32, 0.1, 32).index_dtype == torch.uint16
    assert transport.LeafSpec.build((2 ** 16,), F32, 0.1, 32).index_dtype == torch.uint16
    assert transport.LeafSpec.build((2 ** 16 + 1,), F32, 0.1, 32).index_dtype == torch.int32
    assert transport.LeafSpec.build((2 ** 17, 8), F32, 0.5, 32).index_dtype == torch.uint16


def test_halfword_indices_above_int16_range_round_trip():
    """Rows between 2^15 and 2^16 columns keep 2-byte UNSIGNED indices;
    kept entries past column 32768 survive the wire."""
    cols = 40_000
    spec = transport.LeafSpec.build((cols,), torch.float32, 0.001, 32)
    assert spec.index_dtype == torch.uint16 and spec.encoding == "sparse"
    c = torch.zeros((1, cols))
    c[0, cols - 2] = 7.0
    payload, _ = transport.encode_leaf(c, None, None, None, spec)
    assert int(payload.indices.to(torch.int64).max()) == cols - 2
    assert torch.equal(transport.decode_leaf(payload, spec), c)


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("dt", list(DT))
def test_decode_encode_is_dense_compress(dt, encoding):
    """decode(encode(c)) is the chat of the dense compress path on the same
    draws, bit for bit (0 + v for kept slots of the scattered encodings),
    and the two residuals are the same bits."""
    _, tdt = DT[dt]
    rng = np.random.default_rng(seed_of(dt, encoding))
    for shape, (ratio, bits, mode) in [((256,), (0.25, 8, "topk")),
                                       ((37,), (0.5, 4, "randk")),
                                       ((4, 32), (0.25, 2, "topk")),
                                       ((100,), (0.1, 16, "randk")),
                                       ((64,), (0.5, 32, "topk"))]:
        if bits >= 32 and encoding.startswith("quant"):
            continue
        m = 3
        spec = dataclasses.replace(
            transport.LeafSpec.build(shape, tdt, ratio, bits, mode),
            encoding=encoding).stacked(m)
        c = torch.tensor(rng.standard_normal((spec.rows, spec.cols)) * 4).to(tdt)
        c[0, :3] = -0.0  # kept -0.0 decodes to +0.0 on the scattered paths
        e = torch.tensor(rng.standard_normal(c.shape) * 0.1).to(tdt)
        us = torch.tensor(rng.random(c.shape))
        ur = torch.tensor(rng.random(c.shape))
        payload, resid = transport.encode_leaf(c, e, us, ur, spec)
        decoded = transport.decode_leaf(payload, spec)
        chat, resid_dense = compress_leaf(c, e, us, ur, k=spec.k, bits=bits,
                                          mode=mode)
        want = chat
        if encoding in ("sparse", "quant"):
            want = (chat.to(torch.float64) + 0.0).to(tdt)
        assert_same(want, decoded, f"{shape} {encoding}")
        assert_same(resid_dense, resid, f"{shape} {encoding} resid")
        assert payload.nbytes == spec.wire_bytes()
        assert transport.probe_leaf_bytes(spec) == spec.wire_bytes()


@pytest.fixture(scope="module")
def quad():
    f = load_compressed_rounds()
    return problem_from_numpy("quadratic", {"G": f["quad6_G"], "Ab": f["quad6_Ab"]},
                              "cpu")


@pytest.mark.parametrize(
    "mk",
    [
        lambda w: fed.CompressedGT(compression_ratio=0.25, wire_transport=w),
        lambda w: fed.QuantizedGT(bits=8, wire_transport=w),
        lambda w: fed.QuantizedGT(bits=4, ratio=0.5, mode="randk",
                                  wire_transport=w),
        lambda w: fed.CompressedGT(compression_ratio=0.25, error_feedback=False,
                                   wire_transport=w),
    ],
    ids=["compressed", "quantized", "quantized_randk", "no_feedback"],
)
def test_wire_and_dense_paths_are_bitwise_identical(quad, mk):
    x0 = torch.zeros(6, dtype=torch.float64)
    outs = {}
    for w in (False, True):
        s = mk(w)
        rnd = core.make_round(quad.loss, s, 4, 1e-3, explicit_state=True)
        (xT, yT, st), _ = core.run_strategy_rounds(
            rnd, x0, x0, quad.agent_data, 8, s.init_state(x0, x0, 8))
        outs[w] = (xT, yT, st)
    assert torch.equal(outs[False][0], outs[True][0])
    assert torch.equal(outs[False][1], outs[True][1])
    for key in outs[False][2]:
        assert torch.equal(outs[False][2][key], outs[True][2][key])


def test_identity_config_degenerates_to_dense_gt(quad):
    s = fed.QuantizedGT(bits=32, ratio=1.0, wire_transport=True)
    ra = core.make_round(quad.loss, s, 4, 1e-3)
    rb = core.make_round(quad.loss, fed.GradientTracking(), 4, 1e-3)
    xa = xb = torch.ones(6, dtype=torch.float64)
    ya = yb = -torch.ones(6, dtype=torch.float64)
    for t in range(4):
        xa, ya = ra(xa, ya, quad.agent_data)
        xb, yb = rb(xb, yb, quad.agent_data)
        assert torch.equal(xa, xb) and torch.equal(ya, yb), t


def test_packed_tree_moves_the_price_and_decodes_to_the_dense_transform():
    m = 3
    rng = np.random.default_rng(8)
    cx = {"a": torch.tensor(rng.standard_normal((m, 128))),
          "b": torch.tensor(rng.standard_normal((m, 4, 32)))}
    cy = {"d": torch.tensor(rng.standard_normal((m, 37)))}
    s_wire = fed.QuantizedGT(bits=8, ratio=0.25, wire_transport=True)
    s_dense = fed.QuantizedGT(bits=8, ratio=0.25)
    x = {k: v[0] for k, v in cx.items()}
    y = {k: v[0] for k, v in cy.items()}
    px, py, st_w = s_wire.transform_correction(cx, cy, s_wire.init_state(x, y, m))
    dx, dy, st_d = s_dense.transform_correction(cx, cy, s_dense.init_state(x, y, m))
    assert isinstance(px, fed.PackedTree) and isinstance(py, fed.PackedTree)
    per_agent = sum(transport.LeafSpec.build(tuple(v.shape[1:]), torch.float64,
                                             0.25, 8).wire_bytes()
                    for v in cx.values())
    assert px.wire_bytes() == m * per_agent
    assert px.total_bytes() == px.wire_bytes() + fed.HEADER_BYTES * 2
    for k, v in px.decode().items():
        assert torch.equal(v, dx[k] + 0.0)
    for k in st_w["ex"]:
        assert torch.equal(st_w["ex"][k], st_d["ex"][k])


@pytest.mark.parametrize(
    "name,kw",
    [
        ("compressed_gt", dict(compression_ratio=0.1)),
        ("compressed_gt", dict(compression_ratio=0.1, wire_transport=True)),
        ("quantized_gt", dict(quantization_bits=8, wire_transport=True)),
        ("quantized_gt", dict(quantization_bits=4, compression_ratio=0.25,
                              compression_mode="randk", wire_transport=True)),
        ("quantized_gt", dict(quantization_bits=8, wire_transport=True,
                              correction_dtype="bf16")),
        ("fedgda_gt", {}),
    ],
    ids=["cgt_dense", "cgt_wire", "qgt8_wire", "qgt4_randk_wire",
         "qgt8_bf16_wire", "gt"],
)
def test_bytes_equal_jax(name, kw):
    """bytes_per_round and measured_bytes_per_round (with and without
    headers) equal JAX's; with the wire on, the measurement without
    headers is the price and the headers are the documented overhead."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("correction_dtype") == "bf16":
        jkw["correction_dtype"], tkw["correction_dtype"] = jnp.bfloat16, torch.bfloat16
    js, ts = jfed.resolve_strategy(name, **jkw), fed.resolve_strategy(name, **tkw)
    jx = {"w": jnp.zeros((64, 32)), "b": jnp.zeros((300,))}
    jy = jnp.zeros((7,))
    tx = {"w": torch.zeros((64, 32), dtype=torch.float64),
          "b": torch.zeros((300,), dtype=torch.float64)}
    ty = torch.zeros((7,), dtype=torch.float64)
    assert ts.bytes_per_round(tx, ty, 5) == js.bytes_per_round(jx, jy, 5)
    for headers in (True, False):
        assert transport.measured_bytes_per_round(
            ts, tx, ty, 5, include_headers=headers
        ) == jtransport.measured_bytes_per_round(
            js, jx, jy, 5, include_headers=headers)
    if getattr(ts, "wire_transport", False):
        priced = ts.bytes_per_round(tx, ty, 5)
        assert transport.measured_bytes_per_round(
            ts, tx, ty, 5, include_headers=False) == priced
        assert transport.measured_bytes_per_round(ts, tx, ty, 5) == (
            priced + transport.wire_header_overhead(tx, ty))
    assert transport.wire_header_overhead(tx, ty) == jtransport.wire_header_overhead(jx, jy)
