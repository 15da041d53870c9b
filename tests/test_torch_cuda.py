"""The port's CUDA kernels on the card, held against their plain versions
(`gt_update`, `compress_correction_2d`, `pack_payload_2d`,
`unpack_payload_2d`, bit for bit; `flash_attention` and `ssm_scan`, to a
tolerance), rounds through them against rounds through the plain
versions, and a reduced model's prefill and decode through the kernels
against the plain path.

Every test here needs a CUDA card and skips without one (a skip is not a
pass).  The file imports torch and the port only — no JAX — so it runs on
a machine without JAX, without the repository's JAX conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import itertools

import pytest
import torch

from repro_torch import core
from repro_torch.fed import CompressedGT, GradientTracking, PackedTree, QuantizedGT
from repro_torch.configs import get_config
from repro_torch.kernels import (
    compress_correction_2d,
    flash_attention,
    grouped_flash_attention,
    gt_update,
    pack_payload_2d,
    ref,
    ssm_scan,
    unpack_payload_2d,
)
from repro_torch.kernels.compress_correction import staged_in_shared_memory
from repro_torch.kernels.pack_payload import pack_staged, payload_data_shape
from repro_torch.launch import serve
from repro_torch.models import init_caches, init_params
from repro_torch.problems import make_quadratic_problem

pytestmark = pytest.mark.torch

ETA = 3e-3
DT = {
    "f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}
PAIRS = [
    ("f64", "f64"), ("f64", "f32"), ("f64", "bf16"), ("f64", "fp8"),
    ("f32", "f32"), ("f32", "bf16"), ("f32", "fp8"),
    ("bf16", "bf16"), ("bf16", "fp8"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("numel", [1, 1000, (1 << 20) + 17])
def test_cuda_gt_update_bitwise_equals_plain(cuda_device, pair, numel):
    zdt, cdt = pair
    gen = torch.Generator(device=cuda_device).manual_seed(numel)
    z, g, c = (
        torch.randn(numel, generator=gen, device=cuda_device) * 4
        for _ in range(3)
    )
    z, g, c = z.to(DT[zdt]), g.to(DT[zdt]), c.to(DT[cdt])
    gt_update.launches = 0
    for sign in (-1.0, 1.0):
        got = gt_update(z, g, c, eta=ETA, sign=sign)
        want = ref.gt_update_ref(z, g, c, ETA, sign)
        torch.cuda.synchronize()
        assert got.dtype == z.dtype and got.shape == z.shape
        assert torch.equal(_bits(got), _bits(want))
    assert gt_update.launches == 2


def test_cuda_gt_update_takes_any_shape_and_no_empty_launch(cuda_device):
    z = torch.randn(3, 5, 7, device=cuda_device, dtype=torch.float64)
    got = gt_update(z, z, z, eta=ETA, sign=1.0)
    assert torch.equal(got, ref.gt_update_ref(z, z, z, ETA, 1.0))
    gt_update.launches = 0
    e = torch.empty(0, device=cuda_device)
    assert gt_update(e, e, e, eta=ETA, sign=1.0).numel() == 0
    assert gt_update.launches == 0


def test_cuda_gt_update_raises_on_what_it_does_not_take(cuda_device):
    z = torch.zeros(8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gt_update(z.t(), z.t(), z.t(), eta=ETA, sign=1.0)
    with pytest.raises(TypeError, match="unsupported dtypes"):
        gt_update(z.half(), z.half(), z.half(), eta=ETA, sign=1.0)
    with pytest.raises(ValueError, match="different devices"):
        gt_update(z, z, z.cpu(), eta=ETA, sign=1.0)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16, torch.float8_e4m3fn])
def test_cuda_round_through_kernel_equals_default_update(cuda_device, cdt):
    """FedGDA-GT rounds through the kernel reproduce the plain
    default_update's iterates bit for bit in f64, with (K-1)*2 launches
    per round.  The data are scaled by 2^-8 (eta by 2^8) so that every
    correction lies inside fp8 e4m3's +-448 range."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    prob = make_quadratic_problem(gen, dim=32, num_samples=64, num_agents=6,
                                  device=cuda_device)
    scale = 2.0 ** -8
    data = {k: v * scale for k, v in prob.agent_data.items()}
    eta, K = 1e-5 / scale, 5
    kernel = core.make_fedgda_gt_round(prob.loss, K, eta, correction_dtype=cdt)
    plain = core.make_fedgda_gt_round(prob.loss, K, eta, correction_dtype=cdt,
                                      update_fn=core.default_update)
    x = y = torch.zeros(32, dtype=torch.float64, device=cuda_device)
    xp, yp = x, y
    gt_update.launches = 0
    for _ in range(4):
        x, y = kernel(x, y, data)
        xp, yp = plain(xp, yp, data)
        assert bool(torch.isfinite(x).all() and torch.isfinite(y).all())
        assert torch.equal(x, xp) and torch.equal(y, yp)
    assert gt_update.launches == 4 * (K - 1) * 2


def test_cuda_fp8_correction_overflow_is_nan(cuda_device):
    """Beyond fp8 e4m3's range (|c| > 464) a correction is NaN, as in JAX:
    torch's own cast on the card does so, and the port's correction cast
    gives the same bits on the card as on the CPU."""
    v = torch.tensor([-600.0, -464.1, -464.0, 448.0, 464.0, 464.01, 600.0],
                     dtype=torch.float64)
    raw = v.to(cuda_device).to(torch.float8_e4m3fn).double().cpu()
    assert raw.isnan().tolist() == [True, True, False, False, False, True, True]
    z = torch.zeros_like(v)
    on_cpu, _ = core.tracking_corrections(v[None], z[None], z, z, torch.float8_e4m3fn)
    d = [t.to(cuda_device) for t in (v[None], z[None], z, z)]
    on_card, _ = core.tracking_corrections(*d, torch.float8_e4m3fn)
    assert torch.equal(_bits(on_card.cpu()), _bits(on_cpu))
    assert on_card[0].double().isnan().cpu().tolist() == raw.isnan().tolist()


def test_cuda_engine_uses_the_kernel_by_default(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    prob = make_quadratic_problem(gen, dim=8, num_samples=16, num_agents=1,
                                  device=cuda_device)
    x = torch.zeros(8, dtype=torch.float64, device=cuda_device)
    gt_update.launches = 0
    core.make_round(prob.loss, GradientTracking(), 3, 1e-4)(x, x, prob.agent_data)
    # m == 1: no fused anchor step, every local step is an update
    assert gt_update.launches == 3 * 2


# ------------------------------------------- compressed-correction kernels
IVIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
ENCODINGS = ["quant", "quant_dense", "sparse", "dense"]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN payloads included)."""
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(IVIEW[a.element_size()]),
        b.contiguous().view(IVIEW[b.element_size()])))


def _leaf(dev, R, C, dt, feedback, seed, nan_every=0, udt=torch.float64):
    """c with a row of ties and an all-zero row, feedback, uniforms."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 50.0 if dt == "fp8" else 100.0
    c = torch.randn(R, C, generator=gen, device=dev, dtype=torch.float64) * scale
    c[0, : min(5, C)] = 3.0
    if R > 1:
        c[1] = 0.0
    if nan_every:
        c[-1, ::nan_every] = float("nan")
    c = ref.cast_to(c, DT[dt])
    e = None
    if feedback:
        e = torch.randn(R, C, generator=gen, device=dev, dtype=torch.float64)
        e = ref.cast_to(e * scale * 0.1, DT[dt])
    us = torch.rand(R, C, generator=gen, device=dev, dtype=torch.float64).to(udt)
    ur = torch.rand(R, C, generator=gen, device=dev, dtype=torch.float64).to(udt)
    return c, e, us, ur


def _check_compress(c, e, us, ur, k, bits, mode):
    got = compress_correction_2d(c, e, us, ur, k=k, bits=bits, mode=mode)
    want = ref.compress_correction_ref(c, e, us, ur, k=k, bits=bits, mode=mode)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("chat", "resid")):
        assert _same(g, w), f"{name} k={k}"


def _check_pack(c, e, us, ur, k, bits, mode, encoding, idx_dtype):
    kw = dict(k=k, bits=bits, mode=mode, encoding=encoding, index_dtype=idx_dtype)
    got = pack_payload_2d(c, e, us, ur, **kw)
    want = ref.pack_payload_ref(c, e, us, ur, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("data", "idx", "scale", "resid")):
        assert _same(g, w), f"{name} {encoding} k={k}"
    dk = dict(cols=c.shape[1], dtype=c.dtype, k=k, bits=bits, encoding=encoding)
    out = unpack_payload_2d(*want[:3], **dk)
    assert _same(out, ref.decode_payload_ref(*want[:3], **dk)), f"unpack {encoding}"


@pytest.mark.parametrize("feedback", [True, False], ids=["ef", "noef"])
@pytest.mark.parametrize("bits", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_compress_correction_bitwise_equals_plain(cuda_device, dt, mode,
                                                       bits, feedback):
    for (R, C), seed in zip([(16, 4096), (3, 1000), (2, 37)], itertools.count()):
        c, e, us, ur = _leaf(cuda_device, R, C, dt, feedback, seed)
        for k in sorted({1, max(1, C // 10), max(1, C // 2), C}):
            _check_compress(c, e, us, ur, k, bits, mode)


#: bit-packing needs bits < 32
PACK_CASES = [(enc, bits) for enc in ENCODINGS for bits in (2, 4, 8, 16, 32)
              if bits < 32 or not enc.startswith("quant")]


@pytest.mark.parametrize("encoding,bits", PACK_CASES, ids=str)
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_pack_and_unpack_bitwise_equal_plain(cuda_device, dt, encoding, bits):
    for (R, C), mode in itertools.product([(16, 4096), (3, 1000), (2, 37)],
                                          ["topk", "randk"]):
        c, e, us, ur = _leaf(cuda_device, R, C, dt, True, R + C)
        for j, k in enumerate(sorted({1, max(1, C // 4), C})):
            idx_dtype = (torch.int32, torch.uint16)[j % 2]
            _check_pack(c, e, us, ur, k, bits, mode, encoding, idx_dtype)


@pytest.mark.parametrize("case", [("f64", "randk", 4, 16000), ("f32", "topk", 2, 60000)],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}")
def test_cuda_rows_longer_than_shared_memory_stream(cuda_device, case):
    dt, mode, R, C = case
    assert not staged_in_shared_memory(C, DT[dt], mode == "randk")
    assert staged_in_shared_memory(4096, DT[dt], mode == "randk")
    for enc in ENCODINGS:
        words = payload_data_shape(enc, R, C, C // 4, 4)[1] if enc.startswith("quant") else 0
        assert not pack_staged(C, C // 4, mode, enc, words, DT[dt])
    c, e, us, ur = _leaf(cuda_device, R, C, dt, True, 7)
    for bits in (4, 32):
        _check_compress(c, e, us, ur, C // 4, bits, mode)
        for enc in (["quant", "quant_dense"] if bits < 32 else []) + ["sparse", "dense"]:
            _check_pack(c, e, us, ur, C // 4, bits, mode, enc, torch.int32)


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("mode", ["topk", "randk"])
def test_cuda_nan_rows_and_f32_uniforms(cuda_device, dt, mode):
    """Rows with NaN keep what the plain version keeps (NaN ranks above
    every score and compares false), and pad their payload the same way;
    f32 uniforms are taken as well as f64."""
    for udt in (torch.float64, torch.float32):
        c, e, us, ur = _leaf(cuda_device, 3, 1000, dt, True, 3, nan_every=3, udt=udt)
        for k in (250, 500):
            for bits in (8, 32):
                _check_compress(c, e, us, ur, k, bits, mode)
            for enc in ENCODINGS:
                _check_pack(c, e, us, ur, k, 8, mode, enc, torch.int32)


def _select_rows(dev, R, C, dt, seed):
    """Rows the staged pack's select must take apart, cycled over R: all
    equal, one exponent byte (|v| in [1, 2)), a block of ties below a few
    larger values (tied rand-k scores too), NaN every third column (NaN
    rand-k scores too), zeros and Gaussian; feedback only where it keeps
    the ties; f64 uniforms."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    scale = 50.0 if dt == "fp8" else 100.0
    c = torch.randn(R, C, **f64) * scale
    e = torch.randn(R, C, **f64) * (scale * 0.1)
    us, ur = torch.rand(R, C, **f64), torch.rand(R, C, **f64)
    sign = torch.where(torch.rand(R, C, **f64) < 0.5, -1.0, 1.0)
    big = max(1, C // 10)
    for r in range(R):
        kind = r % 6
        if kind == 0:
            c[r], us[r] = 2.5, 0.5
        elif kind == 1:
            c[r] = (1.0 + torch.rand(C, **f64)) * sign[r]
        elif kind == 2:
            c[r] = torch.rand(C, **f64) - 2.0
            c[r, ::3], us[r, ::3] = 7.0, 0.75
            c[r, :big] = 50.0
        elif kind == 3:
            c[r, ::3], us[r, ::3] = float("nan"), float("nan")
        elif kind == 4:
            c[r] = 0.0
        if kind in (0, 1, 2, 4):
            e[r] = 0.0
    return ref.cast_to(c, DT[dt]), ref.cast_to(e, DT[dt]), us, ur


@pytest.mark.parametrize("C", [37, 1001, 4097])
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_pack_select_rows_and_unaligned_starts(cuda_device, dt, mode, C):
    """All-tie, one-exponent, split-tie, NaN and zero rows, at odd row
    lengths (so most rows start off a vector boundary), k from 1 to C."""
    c, e, us, ur = _select_rows(cuda_device, 6, C, dt, C)
    for j, k in enumerate(sorted({1, C // 3, C - 1, C})):
        idx_dtype = (torch.int32, torch.uint16)[j % 2]
        for enc, bits in [("quant", 8), ("quant_dense", 4), ("sparse", 32), ("dense", 2)]:
            _check_pack(c, e, us, ur, k, bits, mode, enc, idx_dtype)


@pytest.mark.parametrize("R", [3, 600], ids=["few_rows", "many_rows"])
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16"])
def test_cuda_pack_launch_routes(cuda_device, dt, R):
    """Rows fewer and more than twice the SMs take the 512- and 128-thread
    CTAs; both equal the plain version, one launch per call."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert R < 2 * sms if R == 3 else R >= 2 * sms
    for C, mode in [(4096, "topk"), (1000, "randk")]:
        c, e, us, ur = _select_rows(cuda_device, R, C, dt, R + C)
        pack_payload_2d.launches = 0
        for enc in ENCODINGS:
            _check_pack(c, e, us, ur, C // 4, 8 if enc != "sparse" else 32, mode, enc,
                        torch.uint16)
        assert pack_payload_2d.launches == len(ENCODINGS)


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_pack_unaligned_base_pointers(cuda_device, dt):
    """Operands whose base is off a 16-byte boundary take the scalar
    accesses of the staged route (and the same bits)."""
    R, C = 5, 1000
    c, e, us, ur = _select_rows(cuda_device, R, C, dt, 11)

    def shifted(t):  # a contiguous copy one element past an aligned base
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    cs, es, uss, urs = map(shifted, (c, e, us, ur))
    assert cs.data_ptr() % 16 and uss.data_ptr() % 16
    for mode in ("topk", "randk"):
        for enc in ENCODINGS:
            _check_pack(cs, es, uss, urs, C // 4, 8 if enc != "sparse" else 32, mode,
                        enc, torch.int32)


def test_cuda_pack_stages_rows_that_fit(cuda_device):
    """The main path's rows are staged in shared memory, so no scratch row
    is allocated for them; rows past the card's shared memory stream."""
    for dt in DT.values():
        for mode in ("topk", "randk"):
            assert pack_staged(4096, 1024, mode, "quant", 256, dt)
    assert not pack_staged(60000, 15000, "topk", "quant", 3750, torch.float32)


def test_cuda_compress_kernels_count_launches_and_raise(cuda_device):
    c, e, us, ur = _leaf(cuda_device, 4, 256, "f32", True, 1)
    compress_correction_2d.launches = pack_payload_2d.launches = 0
    unpack_payload_2d.launches = 0
    compress_correction_2d(c, e, us, ur, k=8, bits=8)
    data, idx, scale, _ = pack_payload_2d(c, e, us, ur, k=8, bits=8)
    unpack_payload_2d(data, idx, scale, cols=256, dtype=c.dtype, k=8, bits=8)
    assert (compress_correction_2d.launches, pack_payload_2d.launches,
            unpack_payload_2d.launches) == (1, 1, 1)
    with pytest.raises(TypeError, match="unsupported dtype"):
        compress_correction_2d(c.half(), None, None, ur, k=8, bits=8)
    with pytest.raises(ValueError, match="different devices"):
        compress_correction_2d(c, e.cpu(), None, ur, k=8, bits=8)
    with pytest.raises(ValueError, match="contiguous"):
        compress_correction_2d(c.t().contiguous().t(), None, None, None, k=8)
    with pytest.raises(ValueError, match="different devices"):
        unpack_payload_2d(data, idx.cpu(), scale, cols=256, dtype=c.dtype, k=8, bits=8)
    assert (compress_correction_2d.launches, pack_payload_2d.launches,
            unpack_payload_2d.launches) == (1, 1, 1)


@pytest.mark.parametrize("mk", [
    lambda w, u: CompressedGT(compression_ratio=0.1, wire_transport=w, use_kernel=u),
    lambda w, u: CompressedGT(compression_ratio=0.25, mode="randk",
                              wire_transport=w, use_kernel=u),
    lambda w, u: QuantizedGT(bits=8, ratio=0.25, wire_transport=w, use_kernel=u),
    lambda w, u: QuantizedGT(bits=4, wire_transport=w, use_kernel=u),
], ids=["cgt_topk", "cgt_randk", "qgt8_topk", "qgt4_dense"])
@pytest.mark.parametrize("wire", [False, True], ids=["dense", "wire"])
def test_cuda_compressed_rounds_through_kernels_equal_plain(cuda_device, mk, wire):
    """Rounds with use_kernel=True equal those with use_kernel=False bit
    for bit, state included, and launch each kernel once per leaf per
    side per round."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    prob = make_quadratic_problem(gen, dim=64, num_samples=128, num_agents=8,
                                  device=cuda_device)
    rounds, K = 4, 5
    out = {}
    for use in (True, False):
        s = mk(wire, use)
        rnd = core.make_round(prob.loss, s, K, 1e-4, explicit_state=True)
        x0 = torch.zeros(64, dtype=torch.float64, device=cuda_device)
        compress_correction_2d.launches = pack_payload_2d.launches = 0
        unpack_payload_2d.launches = 0
        (x, y, st), _ = core.run_strategy_rounds(
            rnd, x0, x0, prob.agent_data, rounds, s.init_state(x0, x0, 8))
        out[use] = (x, y, st, compress_correction_2d.launches,
                    pack_payload_2d.launches, unpack_payload_2d.launches)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for key in out[True][2]:
        assert torch.equal(out[True][2][key].cpu(), out[False][2][key].cpu())
    want = (0, 2 * rounds, 2 * rounds) if wire else (2 * rounds, 0, 0)
    assert out[True][3:] == want
    assert out[False][3:] == (0, 0, 0)


def test_cuda_wire_transform_returns_packed_trees(cuda_device):
    s = QuantizedGT(bits=8, ratio=0.25, wire_transport=True)
    c = torch.randn(4, 4096, dtype=torch.float64, device=cuda_device)
    st = s.init_state(c[0], c[0], 4)
    px, py, _ = s.transform_correction(c, c, st)
    assert isinstance(px, PackedTree)
    assert px.payloads[0].indices.dtype == torch.uint16
    assert px.wire_bytes() == px.specs[0].wire_bytes()


# --------------------------------------- stochastic and sampling rounds
#: normal draws on the card against the port's CPU draws, in ulp (CUDA's
#: log1p is another implementation; chip_smoke's DRAW_ULP)
DRAW_ULP = {torch.float32: 8, torch.float64: 64}


def _ulp(a, b):
    it = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.view(it).to(torch.int64) - b.view(it).to(torch.int64)).abs().max())


@pytest.mark.parametrize("dt", [torch.int64, torch.int32], ids=["i64", "i32"])
def test_cuda_randint_and_permutation_equal_cpu(cuda_device, dt):
    from repro_torch import prng

    keys = prng.fold_in(prng.split(prng.PRNGKey(4), 8), 2)
    for lo, hi in ((0, 8192), (0, 1000), (-5, 2 ** 31 - 7), (9, 2)):
        got = prng.randint(keys, (513,), lo, hi, dt, cuda_device)
        assert torch.equal(got.cpu(), prng.randint(keys, (513,), lo, hi, dt, "cpu"))
    for n in (1, 16, 2000, 70000):
        assert torch.equal(prng.permutation(prng.PRNGKey(n), n, cuda_device).cpu(),
                           prng.permutation(prng.PRNGKey(n), n, "cpu"))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_normal_within_its_ulp_of_cpu(cuda_device, dt):
    from repro_torch import prng

    keys = prng.fold_in(prng.split(prng.PRNGKey(6), 16), 1)
    got = prng.normal(keys, (4096,), dt, cuda_device)
    want = prng.normal(keys, (4096,), dt, "cpu")
    assert _ulp(got.cpu(), want) <= DRAW_ULP[dt]
    stacked = torch.stack([prng.normal(k, (4096,), dt, cuda_device) for k in keys])
    assert torch.equal(got, stacked)
    u = prng.uniform(keys, (999,), dt, cuda_device, -3.0, 5.5)
    assert torch.equal(u.cpu(), prng.uniform(keys, (999,), dt, "cpu", -3.0, 5.5))


@pytest.mark.parametrize("tag", ["sagda_gaussian", "partial_gt_50",
                                 "quantized_wire_gaussian", "minibatch_robust"])
def test_cuda_stochastic_rounds_through_kernels_equal_plain(cuda_device, tag):
    """chip_smoke's stochastic main path at a reduced size: iterates and
    state through the kernels equal the plain path's bit for bit (the same
    draws feed both), with gt_update launched K x 2 times a noisy round
    ((K - 1) x 2 with the fused anchor step) and pack / unpack twice."""
    import dataclasses

    from repro_torch.fed import (
        SAGDA, GaussianNoise, MinibatchNoise, PartialParticipation)
    from repro_torch.problems import make_robust_regression_problem

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rounds, K, m, d = 3, 4, 8, 256
    if tag == "minibatch_robust":
        prob = make_robust_regression_problem(gen, dim=64, num_samples=96,
                                              num_agents=m, alpha=5.0,
                                              device=cuda_device)
        d = 64
    else:
        prob = make_quadratic_problem(gen, dim=d, num_samples=512, num_agents=m,
                                      device=cuda_device)
    strategy, launches = {
        "sagda_gaussian": (SAGDA(noise=GaussianNoise(0.1)), (2 * K, 0)),
        "partial_gt_50": (PartialParticipation(participation=0.5, seed=1),
                          (2 * (K - 1), 0)),
        "quantized_wire_gaussian": (
            QuantizedGT(bits=8, ratio=0.25, wire_transport=True,
                        noise=GaussianNoise(0.1)), (2 * K, 2)),
        "minibatch_robust": (SAGDA(noise=MinibatchNoise(0.5)), (2 * K, 0)),
    }[tag]
    plain = (dataclasses.replace(strategy, use_kernel=False)
             if hasattr(strategy, "use_kernel") else strategy)
    out = {}
    for name, s, kw in (("kernels", strategy, {}),
                        ("plain", plain, {"update_fn": core.default_update})):
        rnd = core.make_round(prob.loss, s, K, 1e-4, explicit_state=True,
                              proj_y=prob.proj_y, **kw)
        x0 = torch.zeros(d, dtype=torch.float64, device=cuda_device)
        gt_update.launches = pack_payload_2d.launches = unpack_payload_2d.launches = 0
        (x, y, st), _ = core.run_strategy_rounds(
            rnd, x0, x0, prob.agent_data, rounds, s.init_state(x0, x0, m))
        out[name] = (x, y, st, gt_update.launches, pack_payload_2d.launches,
                     unpack_payload_2d.launches)
    assert torch.equal(out["kernels"][0], out["plain"][0])
    assert torch.equal(out["kernels"][1], out["plain"][1])
    for key in out["kernels"][2]:
        assert torch.equal(out["kernels"][2][key].cpu(), out["plain"][2][key].cpu())
    gt, packs = launches
    assert out["kernels"][3:] == (gt * rounds, packs * rounds, packs * rounds)
    assert out["plain"][3:] == (0, 0, 0)


# ------------------------------------------------------ elastic population
_PROCESSES = [("AlwaysOn", {}), ("BernoulliAvailability", {"p": 0.6}),
              ("MarkovChurn", {"p_leave": 0.3, "p_join": 0.5}),
              ("DiurnalAvailability", {"period": 10, "low": 0.2, "high": 0.9}),
              ("FixedSizeSampling", {"participation": 0.4}),
              ("UniformActiveSubset", {"size": 5})]
_STRAGGLERS = [("NoStragglers", {}),
               ("UniformStragglers", {"p_straggle": 0.7, "min_frac": 0.3}),
               ("DeterministicLag", {"slow_every": 3, "budget_frac": 0.3})]


@pytest.mark.parametrize("avail", _PROCESSES, ids=lambda p: p[0])
def test_cuda_schedules_equal_cpu(cuda_device, avail):
    """Schedules drawn on the card (dense, chunked, min_active forcing)
    equal the CPU's bit for bit, for every straggler model."""
    from repro_torch import sim

    name, kw = avail
    for sname, skw in _STRAGGLERS:
        pop = sim.Population(12, getattr(sim, name)(**kw),
                             getattr(sim, sname)(**skw), min_active=2)
        a = pop.schedule(3, 70, 7, device=cuda_device)
        b = pop.schedule(3, 70, 7, device="cpu")
        assert (a.active == b.active).all() and (a.budgets == b.budgets).all()
        c = pop.chunked_schedule(3, 70, 7, chunk_rounds=16, device=cuda_device)
        m = c.materialize()
        assert (m.active == b.active).all() and (m.budgets == b.budgets).all()


def test_cuda_scenario_and_sparse_schedules_equal_cpu(cuda_device):
    from repro_torch import sim

    for name in ("flaky", "diurnal", "straggler_heavy"):
        a = sim.make_population(name, 16).schedule(0, 1200, 10, device=cuda_device)
        b = sim.make_population(name, 16).schedule(0, 1200, 10, device="cpu")
        assert (a.active == b.active).all() and (a.budgets == b.budgets).all()
    a = sim.make_population("mega", 0).sparse_schedule(0, 3, 10, device=cuda_device)
    b = sim.make_population("mega", 0).sparse_schedule(0, 3, 10, device="cpu")
    for t in range(3):
        assert (a[t].active_ids == b[t].active_ids).all()
        assert (a[t].budgets == b[t].budgets).all()


@pytest.mark.parametrize("tag", ["gt_rebase", "gt_norebase", "cgt_wire",
                                 "qgt_dense", "local_sgda"])
def test_cuda_elastic_rounds_through_kernels_equal_plain(cuda_device, tag):
    """Flaky elastic rounds through `FederatedRunner`: iterates, strategy
    state and tracker through the kernels equal the plain path's bit for
    bit; gt_update launches (K - 1) x 2 a round (K x 2 without the fused
    anchor step), compress / pack / unpack 2 a round."""
    import dataclasses

    from repro_torch import sim
    from repro_torch.fed import FederatedRunner, LocalOnly

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rounds, K, m, d = 6, 4, 8, 256
    prob = make_quadratic_problem(gen, dim=d, num_samples=512, num_agents=m,
                                  device=cuda_device)
    strategy, rebase, (gt, comp, packs) = {
        "gt_rebase": (GradientTracking(), True, (2 * (K - 1), 0, 0)),
        "gt_norebase": (GradientTracking(), False, (2 * (K - 1), 0, 0)),
        "cgt_wire": (CompressedGT(compression_ratio=0.1, wire_transport=True), True,
                     (2 * K, 0, 2)),
        "qgt_dense": (QuantizedGT(bits=8, ratio=0.25), True, (2 * K, 2, 0)),
        "local_sgda": (LocalOnly(), True, (0, 0, 0)),
    }[tag]
    sched = sim.make_population("flaky", m).schedule(0, rounds, K, device=cuda_device)
    assert not sched.is_static_full
    plain = (dataclasses.replace(strategy, use_kernel=False)
             if hasattr(strategy, "use_kernel") else strategy)
    out = {}
    for name, s, kw in (("kernels", strategy, {}),
                        ("plain", plain, {"update_fn": core.default_update})):
        runner = FederatedRunner.from_strategy(prob.loss, s, prob.agent_data, K,
                                               1e-4, **kw)
        x0 = torch.zeros(d, dtype=torch.float64, device=cuda_device)
        gt_update.launches = compress_correction_2d.launches = 0
        pack_payload_2d.launches = unpack_payload_2d.launches = 0
        x, y = runner.run(x0, x0, rounds, schedule=sched, rebase=rebase)
        torch.cuda.synchronize()
        out[name] = (x, y, runner._state or {}, runner.elastic_state,
                     (gt_update.launches, compress_correction_2d.launches,
                      pack_payload_2d.launches, unpack_payload_2d.launches))
    k, p = out["kernels"], out["plain"]
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for key in k[2]:
        assert torch.equal(k[2][key].cpu(), p[2][key].cpu())
    for key in k[3]["tracker"]:
        assert torch.equal(k[3]["tracker"][key], p[3]["tracker"][key])
    assert k[4] == (gt * rounds, comp * rounds, packs * rounds, packs * rounds)
    assert p[4] == (0, 0, 0, 0)


# ------------------------------------------- sparse engine and pod tree
def test_cuda_pod_segment_sum_is_deterministic_and_confines_nan(cuda_device):
    """The pod tree's segment sum on the card: the same call twice gives
    the same bits, pods in any order and quiet pods (exact zeros), a NaN
    row reaches its own pod only, and the finite pods agree with the
    CPU's within 1e-12."""
    from repro_torch.core import engine

    gen = torch.Generator().manual_seed(11)
    n, P = 64, 9
    u = torch.randn(n, 4096, dtype=torch.float64, generator=gen)
    w = torch.rand(n, dtype=torch.float64, generator=gen)
    pod_ids = torch.randint(0, P - 2, (n,), generator=gen)  # pods 7, 8 quiet
    u[5, 17] = float("nan")
    nan_pod = int(pod_ids[5])
    ud, wd = u.to(cuda_device), w.to(cuda_device)
    a = engine.pod_weighted_sums(ud, wd, pod_ids, P)
    b = engine.pod_weighted_sums(ud, wd, pod_ids.numpy(), P)
    torch.cuda.synchronize()
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(torch.nan_to_num(a).view(torch.int64),
                       torch.nan_to_num(b).view(torch.int64))
    assert a.isnan().any(dim=1).cpu().tolist() == [p == nan_pod for p in range(P)]
    assert torch.equal(a[P - 2:], torch.zeros_like(a[P - 2:]))
    cpu = engine.pod_weighted_sums(u, w, pod_ids, P)
    keep = [p for p in range(P) if p != nan_pod]
    torch.testing.assert_close(a[keep].cpu(), cpu[keep], rtol=1e-12, atol=1e-12)


def _sparse_setup(cuda_device, m=16, d=256, pods=4, rounds=5, K=4):
    from repro_torch import sim

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    prob = make_quadratic_problem(gen, dim=d, num_samples=512, num_agents=m,
                                  device=cuda_device)
    pop = sim.Population(m, sim.UniformActiveSubset(size=m // 2),
                         sim.UniformStragglers(0.3, 0.5), pods=pods)
    return prob, pop, pop.sparse_schedule(0, rounds, K, device=cuda_device)


@pytest.mark.parametrize("tag", ["gt_wire_pods", "cgt_wire", "qgt_dense"])
def test_cuda_sparse_engine_through_kernels_equals_plain(cuda_device, tag):
    """The O(active) engine (forced sparse, 8 of 16 active, 4 pods): x, y,
    strategy state and the tracker's sums and rows through the kernels
    equal the plain path's bit for bit; gt_update launches (K - 1) x 2 a
    round with the fused anchor step (K x 2 without), the compressors' and
    the pod partials' kernels 2 a round."""
    import dataclasses

    from repro_torch import sim

    rounds, K = 5, 4
    prob, pop, sched = _sparse_setup(cuda_device, rounds=rounds, K=K)
    strategy, wire_pods, launches = {
        "gt_wire_pods": (GradientTracking(), True, (2 * (K - 1), 0, 2, 0)),
        "cgt_wire": (CompressedGT(compression_ratio=0.1, wire_transport=True), False,
                     (2 * K, 0, 2, 2)),
        "qgt_dense": (QuantizedGT(bits=8, ratio=0.25), False, (2 * K, 2, 0, 0)),
    }[tag]
    plain = (dataclasses.replace(strategy, use_kernel=False)
             if hasattr(strategy, "use_kernel") else strategy)
    out = {}
    for name, s, kw in (("kernels", strategy, {}),
                        ("plain", plain, {"update_fn": core.default_update,
                                          "use_kernel": False})):
        eng = sim.SparseElasticEngine(
            prob.loss, s, sim.ArrayDataSource(prob.agent_data), K, 1e-4,
            pod_map=pop.pod_map(), wire_pods=wire_pods, dense_fallback_max_m=0, **kw)
        x0 = torch.zeros(prob.agent_data["Ab"].shape[1], dtype=torch.float64,
                         device=cuda_device)
        gt_update.launches = compress_correction_2d.launches = 0
        pack_payload_2d.launches = unpack_payload_2d.launches = 0
        x, y = eng.run(x0, x0, sched)
        torch.cuda.synchronize()
        out[name] = (x, y, eng._state, eng._tracker,
                     (gt_update.launches, compress_correction_2d.launches,
                      pack_payload_2d.launches, unpack_payload_2d.launches))
    k, p = out["kernels"], out["plain"]
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for key in k[2]:
        assert torch.equal(k[2][key].cpu(), p[2][key].cpu())
    assert torch.equal(k[3].sum_gx, p[3].sum_gx) and torch.equal(k[3].sum_gy, p[3].sum_gy)
    for a, b in zip(k[3]._gx_leaves, p[3]._gx_leaves):
        assert (a[:k[3].num_touched] == b[:p[3].num_touched]).all()
    assert k[4] == tuple(n * rounds for n in launches)
    assert p[4] == (0, 0, 0, 0)


def test_cuda_pod_partials_roundtrip_through_pack_and_unpack(cuda_device):
    """Dense pod payloads: encode through `pack_payload` and decode through
    `unpack_payload` give the partials back bit for bit, the packed
    buffers equal the plain encoder's, one launch per leaf each way."""
    from repro_torch.fed import pods

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    partials = (torch.randn(37, 4096, dtype=torch.float64, generator=gen,
                            device=cuda_device),
                {"a": torch.randn(37, 3, 5, generator=gen, device=cuda_device)})
    pack_payload_2d.launches = unpack_payload_2d.launches = 0
    packed = pods.encode_pod_partials(partials)
    back = pods.decode_pod_partials(packed)
    torch.cuda.synchronize()
    assert (pack_payload_2d.launches, unpack_payload_2d.launches) == (2, 2)
    assert torch.equal(back[0], partials[0]) and torch.equal(back[1]["a"],
                                                             partials[1]["a"])
    plain = pods.encode_pod_partials(partials, use_kernel=False)
    for a, b in zip(packed.payloads, plain.payloads):
        assert torch.equal(a.data, b.data)
    assert packed.total_bytes() == plain.total_bytes() == (
        37 * 4096 * 8 + 37 * 15 * 4 + 2 * 16)


def test_cuda_mega_schedule_and_rounds_equal_the_fixture(cuda_device):
    """The mega preset on the card (1e6 agents, 256 active, 1024 pods, the
    tracker's init over every agent): its 4 rounds' ids and budgets equal
    JAX's, and the engine's live pods, pod wire bytes and tracker counts;
    x and y within 1e-9 of JAX's (synthesized normals within a few ulp)."""
    from repro_torch.benchmarks import elastic as bench
    from repro_torch.fixtures import MEGA, load_sparse_rounds

    fix = load_sparse_rounds()
    m, active, pods, rounds = MEGA["mega"]
    run = bench._mega_engine_run(m, active, pods, rounds, device=cuda_device)
    sched = run["engine"]  # the history carries the counts
    assert [h["live_pods"] for h in sched.history] == fix["mega_live_pods"].tolist()
    assert [h["pod_wire_bytes"] for h in sched.history] == \
        fix["mega_pod_wire_bytes"].tolist()
    assert run["tracker_touched"] == fix["mega_tracker_touched"].tolist()
    from repro_torch import sim

    pop = sim.Population(m, sim.UniformActiveSubset(size=active),
                         sim.UniformStragglers(0.3, 0.5), pods=pods)
    s = pop.sparse_schedule(bench.SEED, rounds, bench.K, device=cuda_device)
    for t in range(rounds):
        assert (s[t].active_ids == fix["mega_ids"][t]).all()
        assert (s[t].budgets == fix["mega_budgets"][t]).all()
    for v in ("x", "y"):
        want = torch.from_numpy(fix[f"mega_{v}"])
        err = float((run[v].cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-9, (v, err)


# ------------------------------------------------------ model kernels
#: flash attention's tolerance against its plain version: f32 sums in
#: another order (rtol = atol); both compute a bf16 case in f32 and round
#: once, so a bf16 output may differ by one unit in the last place, at
#: most 2^-7 of the largest |output|
FLASH_TOL_F32 = 1e-5
FLASH_REL_BF16 = 2.0 ** -7
SCAN_TOL = 1e-4


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _close_flash(got, want):
    if want.dtype != torch.bfloat16:
        return _close(got, want, FLASH_TOL_F32)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_REL_BF16 * float(want.float().abs().max()), err


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    # (B, H, KV, Sq, Skv, hd, causal, window, softcap)
    (2, 4, 4, 128, 128, 64, True, 0, 0.0),
    (1, 8, 2, 1000, 1000, 112, True, 0, 0.0),     # ragged, zamba2's hd, GQA
    (1, 8, 4, 777, 777, 256, True, 200, 50.0),    # gemma2's local layer
    (2, 4, 1, 37, 300, 32, False, 0, 0.0),        # Sq < Skv, multi-query
    (1, 2, 2, 150, 130, 48, False, 40, 20.0),     # window without causal
    (1, 1, 1, 1, 5, 8, True, 0, 0.0),             # one query
    (1, 4, 2, 200, 200, 33, True, 0, 0.0),        # hd not a multiple of 8
    (2, 2, 2, 150, 333, 100, False, 0, 0.0),      # ... and Sq < Skv
    (1, 2, 1, 4096, 4096, 64, True, 512, 0.0),    # many turns of the ring
    (1, 2, 2, 200, 333, 256, False, 0, 0.0),      # hd 256: f32's 32-key tiles
    (2, 4, 4, 1, 1000, 112, False, 0, 0.0),       # one query, many keys
    (1, 2, 2, 1, 1, 256, True, 0, 0.0),           # one query, one key
], ids=["square", "ragged-gqa", "gemma2-local", "sq<skv", "window", "one-query",
        "hd33", "hd100", "s4096-window", "hd256", "sq1", "sq1-skv1"])
def test_cuda_flash_attention_equals_plain(cuda_device, dt, case):
    B, H, KV, Sq, Skv, hd, causal, window, softcap = case
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + hd)
    q = torch.randn(B, H, Sq, hd, generator=gen, device=cuda_device).to(dt)
    k = torch.randn(B, KV, Skv, hd, generator=gen, device=cuda_device).to(dt)
    v = torch.randn(B, KV, Skv, hd, generator=gen, device=cuda_device).to(dt)
    flash_attention.launches = 0
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    _close_flash(got, want)
    assert flash_attention.launches == 1


def test_cuda_flash_attention_model_layout_and_masked_first_tile(cuda_device):
    """The model's [B, S, H, hd] tensors through transposed views (no
    copy), and causal+window rows whose first needed key tile is fully
    masked (the -1e30 average that alpha = 0 wipes)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    B, S, H, KV, hd = 2, 300, 8, 2, 112
    q = torch.randn(B, S, H, hd, generator=gen, device=cuda_device)
    k = torch.randn(B, S, KV, hd, generator=gen, device=cuda_device)
    v = torch.randn(B, S, KV, hd, generator=gen, device=cuda_device)
    for window in (0, 70):
        got = grouped_flash_attention(q, k, v, causal=True, window=window)
        assert got.is_contiguous()
        want = grouped_flash_attention(q, k, v, causal=True, window=window,
                                       use_kernel=False)
        _close(got, want.contiguous(), 1e-5)
        assert torch.isfinite(got).all()


def test_cuda_flash_attention_counts_launches_and_raises(cuda_device):
    q = torch.randn(1, 4, 16, 32, device=cuda_device)
    flash_attention.launches = 0
    flash_attention(q, q, q)
    assert flash_attention.launches == 1
    assert flash_attention(q[:, :, :0], q, q).numel() == 0  # no launch
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 1, 4, 320, device=cuda_device)
        flash_attention(z, z, z)
    with pytest.raises(ValueError, match="kv heads"):
        z = torch.zeros(1, 3, 16, 32, device=cuda_device)
        flash_attention(q, z, z)
    assert flash_attention.launches == 1


def _flash_qkv(dev, dt, B, H, KV, Sq, Skv, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, Sq, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(B, KV, Skv, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(B, KV, Skv, hd, generator=gen, device=dev).to(dt)
    return q, k, v


def _flash_once(q, k, v, **kw):
    """The kernel against its plain version, in one launch."""
    flash_attention.launches = 0
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == 1
    _close_flash(got, ref.flash_attention_ref(q, k, v, **kw))
    return got


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width,lo,hd", [
    (33, 0, 33),   # f32 rows 4-byte aligned, bf16 2-byte: plain loads
    (34, 0, 32),   # f32 8-byte, bf16 4-byte
    (36, 1, 32),   # the base pointer one element past a 16-byte boundary
])
def test_cuda_flash_attention_unaligned_rows(cuda_device, dt, width, lo, hd):
    """Seq strides and base addresses that are not 16-byte aligned take
    the narrower copies (or plain loads), with the same answer."""
    gen = torch.Generator(device=cuda_device).manual_seed(width + lo)
    B, H, S = 2, 3, 130
    q, k, v = (torch.randn(B, H, S, width, generator=gen, device=cuda_device)
               .to(dt)[..., lo:lo + hd] for _ in range(3))
    assert q.stride(2) == width
    _flash_once(q, k, v, causal=True, window=0, softcap=0.0)
    _flash_once(q, k, v, causal=False, window=20, softcap=30.0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 112, 256])
def test_cuda_flash_attention_masked_first_tile_rows(cuda_device, dt, hd):
    """Causal windows whose first key straddles a key-tile boundary inside
    one warp's 16 rows: the warp processes the tile, which is fully masked
    for its later rows (their -1e30 average, wiped at their first real
    key)."""
    from repro_torch.kernels.flash_attention import plan

    bk = plan(hd, dt)["keys_per_tile"]
    window, S = bk + 7, 6 * bk
    # rows 16c .. 16c+15 of a warp with 16c = bk * n: first keys
    # bk(n-1) - 6 .. bk(n-1) + 9, across the boundary at bk(n-1)
    first = [i - window + 1 for i in range(2 * bk, 2 * bk + 16)]
    assert min(first) < bk <= max(first)
    q, k, v = _flash_qkv(cuda_device, dt, 1, 4, 2, S, S, hd, hd)
    got = _flash_once(q, k, v, causal=True, window=window, softcap=0.0)
    assert torch.isfinite(got).all()


def test_cuda_flash_attention_rows_no_key_may_see(cuda_device):
    """The documented, tiling-dependent answer of a query that no key may
    see (no causal mask, window w, i >= Skv + w - 1): the mean of v over
    the keys j < Skv of the tiles its warp processes."""
    from repro_torch.kernels.flash_attention import plan

    hd, Skv, window, Sq = 64, 100, 10, 192
    bk = plan(hd, torch.float32)["keys_per_tile"]
    q, k, v = _flash_qkv(cuda_device, torch.float32, 1, 1, 1, Sq, Skv, hd, 7)
    got = flash_attention(q, k, v, causal=False, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=False, window=window)
    torch.cuda.synchronize()
    t_hi = -(-Skv // bk)
    for i in range(Sq):
        if i < Skv + window - 1:  # sees a key: the plain version's answer
            torch.testing.assert_close(got[0, 0, i], want[0, 0, i], rtol=1e-5, atol=1e-5)
            continue
        q0, qw = i // 64 * 64, i // 16 * 16
        t_lo = max(0, q0 - window + 1) // bk
        tiles = [t for t in range(t_lo, t_hi) if t * bk + bk - 1 >= qw - window + 1]
        keys = [j for t in tiles for j in range(t * bk, min(t * bk + bk, Skv))]
        mean = v[0, 0, keys].mean(0) if keys else torch.zeros_like(v[0, 0, 0])
        torch.testing.assert_close(got[0, 0, i], mean, rtol=1e-5, atol=1e-5)


def test_cuda_flash_attention_plan_fits_shared_memory(cuda_device):
    """Every head-dim bucket and dtype has a tiling that fits the card's
    227 KB of shared memory per CTA, and the serving head size (112)
    fits two CTAs per SM."""
    from repro_torch.kernels.flash_attention import plan

    for dt in (torch.float32, torch.bfloat16):
        for hd in range(1, 257):
            p = plan(hd, dt)
            assert p["head_dim_padded"] >= hd and p["head_dim_padded"] % 16 == 0
            assert p["smem_bytes"] <= 227 * 1024, (hd, dt, p)
        assert plan(112, dt)["smem_bytes"] <= 113 * 1024


def _scan_inputs(dev, B, S, H, P, N, da_shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    da = torch.sigmoid(torch.randn(*da_shape, generator=gen, device=dev)) * 0.95
    dbx = torch.randn(B, S, H, P, N, generator=gen, device=dev) * 0.1
    c = torch.randn(B, S, N, generator=gen, device=dev)
    s0 = torch.randn(B, H, P, N, generator=gen, device=dev)
    return da, dbx, c, s0


@pytest.mark.parametrize("case", [
    # (B, S, H, P, N, decay): "head" [B,S,H,1,1], "full" [B,S,H,P,N]
    (2, 64, 12, 64, 64, "head"),    # Mamba-2 (zamba2's head_p and N)
    (1, 130, 300, 1, 16, "full"),   # Mamba-1, ragged S
    (1, 33, 7, 3, 5, "full"),       # ragged everything, N < 32
    (2, 9, 5, 2, 100, "head"),      # N > 64
    (1, 17, 3, 4, 256, "head"),     # the largest state
    (3, 5, 2, 2, 1, "full"),        # one state
], ids=["mamba2", "mamba1", "ragged", "n100", "n256", "n1"])
@pytest.mark.parametrize("start", ["zero", "state0"])
def test_cuda_ssm_scan_equals_plain(cuda_device, case, start):
    B, S, H, P, N, decay = case
    da_shape = (B, S, H, 1, 1) if decay == "head" else (B, S, H, P, N)
    da, dbx, c, s0 = _scan_inputs(cuda_device, B, S, H, P, N, da_shape, S * N)
    s0 = s0 if start == "state0" else None
    ssm_scan.launches = 0
    y, state = ssm_scan(da, dbx, c, s0)
    want_y, want_state = ref.ssm_scan_ref(da.expand(dbx.shape), dbx, c, s0)
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)
    assert ssm_scan.launches == 1


def test_cuda_ssm_scan_reads_strides_without_copies(cuda_device):
    """A strided c (the model's split) and the 3-D / 4-D layouts."""
    B, S, D, N = 2, 40, 96, 16
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    da = torch.rand(B, S, D, 1, generator=gen, device=cuda_device)
    dbx = torch.randn(B, S, D, N, generator=gen, device=cuda_device)
    wide = torch.randn(B, S, 3 * N, generator=gen, device=cuda_device)
    c = wide[..., N:2 * N]
    y, state = ssm_scan(da, dbx, c)
    want = ref.ssm_scan_ref(da.unsqueeze(3).expand(B, S, D, 1, N),
                            dbx.unsqueeze(3), c.contiguous())
    _close(y, want[0].reshape(B, S, D), SCAN_TOL)
    _close(state, want[1].reshape(B, D, N), SCAN_TOL)
    y1, s1 = ssm_scan(da[0], dbx[0], c[0])
    _close(y1, y[0], SCAN_TOL)
    _close(s1, state[0], SCAN_TOL)


def test_cuda_ssm_scan_counts_launches_and_raises(cuda_device):
    z = torch.zeros(2, 4, 3, 8, device=cuda_device)
    c = torch.zeros(2, 4, 8, device=cuda_device)
    ssm_scan.launches = 0
    ssm_scan(z, z, c)
    assert ssm_scan.launches == 1
    with pytest.raises(TypeError):
        ssm_scan(z.double(), z.double(), c.double())
    with pytest.raises(ValueError, match="different devices"):
        ssm_scan(z, z.cpu(), c)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(z, z.transpose(2, 3).contiguous().transpose(2, 3), c)
    assert ssm_scan.launches == 1


@pytest.mark.parametrize("arch,prompt_len", [
    ("zamba2-7b", 64), ("gemma2-2b", 128), ("falcon-mamba-7b", 48)])
def test_cuda_reduced_model_through_kernels_equals_plain(cuda_device, arch,
                                                         prompt_len):
    """Prefill and teacher-forced decode of a reduced model through the
    kernels against the same tokens through the plain versions: logits
    within 1e-4 of their largest magnitude, and the kernels launched once
    per layer that needs them in prefill, never in decode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0), cfg)
    B, n = 2, 6
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len), generator=gen,
                            device=cuda_device)
    runs = {}
    for use in (True, False):
        caches = init_caches(cfg, B, prompt_len + n, torch.float32, cuda_device)
        runs[use] = serve.generate(params, cfg, prompts, caches, n, use_kernel=use,
                                   forced=runs[True]["tokens"] if not use else None)
    got, want = runs[True]["step_logits"], runs[False]["step_logits"]
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_types)
    n_attn += cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    n_ssm = sum(k.startswith("mamba") for k in cfg.layer_types)
    assert runs[True]["launches"]["prefill"] == {"flash_attention": n_attn,
                                                 "ssm_scan": n_ssm}
    zero = {"flash_attention": 0, "ssm_scan": 0}
    assert runs[True]["launches"]["decode"] == zero
    assert runs[False]["launches"] == {"prefill": zero, "decode": zero}


# ------------------------------------ the async runtime and the telemetry sink
ASYNC_SHARDS = 4


def _async_setup(cuda_device, m=16, d=128):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    prob = make_quadratic_problem(gen, dim=d, num_samples=2 * d, num_agents=m,
                                  device=cuda_device)
    return prob, torch.zeros(d, dtype=torch.float64, device=cuda_device)


def _full_sink():
    from repro_torch.obs import Telemetry

    return Telemetry(probes=("gt_residual", "ef_residual", "priced_vs_measured"))


@pytest.mark.parametrize("name,kw,flaky", [
    ("fedgda_gt", {}, False), ("compressed_gt", {"compression_ratio": 0.25}, False),
    ("quantized_gt", {"quantization_bits": 8, "wire_transport": True}, False),
    ("gda", {}, False), ("partial_gt", {"participation": 0.5}, False),
    ("fedgda_gt", {}, True), ("compressed_gt", {"compression_ratio": 0.25}, True),
], ids=["gt", "cgt", "qgt_wire", "gda", "partial", "gt_flaky", "cgt_flaky"])
def test_cuda_async_on_4_streams_matches_sync(cuda_device, name, kw, flaky):
    """`AsyncFederatedRunner(devices=[card] * 4)`: 4 shards on 4 distinct
    streams of one card, iterates within rtol 1e-9 / atol 1e-12 of the sync
    runner's on the card (the reference's tolerance), plain and under a
    flaky schedule."""
    from repro_torch import fed, sim

    prob, x0 = _async_setup(cuda_device)
    K, rounds = 4, 5
    run = {}
    if flaky:
        pop = sim.Population(16, sim.MarkovChurn(p_leave=0.6, p_join=0.4),
                             sim.UniformStragglers(0.3, 0.5))
        run["schedule"] = pop.schedule(0, rounds, K, device=cuda_device)
    xs, ys = fed.FederatedRunner.from_strategy(prob.loss, name, prob.agent_data, K,
                                               1e-4, **kw).run(x0, x0, rounds, **run)
    ar = fed.AsyncFederatedRunner(prob.loss, name, prob.agent_data, K, 1e-4,
                                  devices=[cuda_device] * ASYNC_SHARDS, **kw)
    xa, ya = ar.run(x0, x0, rounds, **run)
    torch.cuda.synchronize()
    assert ar._n_shards == ASYNC_SHARDS
    assert len({s.cuda_stream for s in ar._streams}) == ASYNC_SHARDS
    torch.testing.assert_close(xa, xs, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(ya, ys, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name,kw", [
    ("fedgda_gt", {}), ("compressed_gt", {"compression_ratio": 0.25}),
    ("quantized_gt", {"quantization_bits": 8, "wire_transport": True}),
    ("partial_gt", {"participation": 0.5})], ids=["gt", "cgt", "qgt_wire", "partial"])
def test_cuda_telemetry_is_bitwise_free(cuda_device, name, kw):
    """telemetry=None against a full sink (probes included) on the card:
    bitwise-equal iterates on the sync runner (one runner, the sink
    switched on) and on the async runner (two runners, 4 streams)."""
    from repro_torch import fed

    prob, x0 = _async_setup(cuda_device)
    K, rounds = 4, 5
    runner = fed.FederatedRunner.from_strategy(prob.loss, name, prob.agent_data, K,
                                               1e-4, **kw)
    fresh = lambda: runner._strategy.init_state(x0, x0, 16) or None
    xa, ya = runner.run(x0, x0, rounds, state=fresh())
    runner.telemetry = _full_sink()
    xb, yb = runner.run(x0, x0, rounds, state=fresh())
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    runs = []
    for tm in (None, _full_sink()):
        ar = fed.AsyncFederatedRunner(prob.loss, name, prob.agent_data, K, 1e-4,
                                      devices=[cuda_device] * ASYNC_SHARDS,
                                      telemetry=tm, **kw)
        runs.append(ar.run(x0, x0, rounds))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_cuda_phase_spans_equal_the_fused_round(cuda_device):
    """Telemetry(phase_spans=True) runs the four phases one by one, each
    ended by a synchronize: the same iterates as the fused round, bit for
    bit, and one positive span per phase a round."""
    from repro_torch import fed
    from repro_torch.obs import Telemetry

    prob, x0 = _async_setup(cuda_device)
    runner = fed.FederatedRunner.from_strategy(prob.loss, "fedgda_gt",
                                               prob.agent_data, 4, 1e-4)
    xa, ya = runner.run(x0, x0, 3)
    tm = Telemetry(phase_spans=True)
    runner.telemetry = tm
    xb, yb = runner.run(x0, x0, 3)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    for phase in ("broadcast", "exchange_corrections", "local_steps", "aggregate"):
        spans = tm.series("span", phase)
        assert len(spans) == 3 and all(s["seconds"] > 0 for s in spans)


def test_cuda_async_gt_update_launches_on_the_shard_streams(cuda_device, monkeypatch):
    """Every gt_update launch of an async run goes to its shard's stream:
    (K - 1) x 2 a round on each of the 4 shard streams, none on the
    server's."""
    import collections

    from repro_torch import fed
    from repro_torch.kernels import ops

    seen = []
    real = ops.gt_update

    def spy(z, g, c, **kw):
        seen.append(torch.cuda.current_stream(z.device).cuda_stream)
        return real(z, g, c, **kw)

    monkeypatch.setattr(ops, "gt_update", spy)
    prob, x0 = _async_setup(cuda_device)
    K, rounds = 4, 3
    ar = fed.AsyncFederatedRunner(prob.loss, "fedgda_gt", prob.agent_data, K, 1e-4,
                                  devices=[cuda_device] * ASYNC_SHARDS)
    gt_update.launches = 0
    ar.run(x0, x0, rounds)
    torch.cuda.synchronize()
    handles = [s.cuda_stream for s in ar._streams]
    assert collections.Counter(seen) == {h: (K - 1) * 2 * rounds for h in handles}
    assert gt_update.launches == len(seen)
    assert torch.cuda.current_stream(cuda_device).cuda_stream not in handles
