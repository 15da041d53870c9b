"""The port's CUDA kernels on the card, held against their plain versions
(`gt_update`, `compress_correction_2d`, `pack_payload_2d`,
`unpack_payload_2d` and its table `unpack_payload_many`, bit for bit; `flash_attention` and `ssm_scan`, to a
tolerance), rounds through them against rounds through the plain
versions, and a reduced model's prefill and decode through the kernels
against the plain path.

Every test here needs a CUDA card and skips without one (a skip is not a
pass).  The file imports torch and the port only — no JAX — so it runs on
a machine without JAX, without the repository's JAX conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import itertools
import math

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
    gt_update_many,
    make_gt_update_fn,
    pack_payload_2d,
    ref,
    ssm_scan,
    unpack_payload_2d,
)
from repro_torch.kernels.compress_correction import (
    CLUSTER_SIZES,
    auto_cluster,
    staged_in_shared_memory,
)
from repro_torch.kernels.gt_update import TABLE_CAP
from repro_torch.kernels.pack_payload import (
    UnpackSpec,
    pack_staged,
    payload_data_shape,
    unpack_payload_many,
)
from repro_torch.kernels.pack_payload import TABLE_CAP as UNPACK_TABLE_CAP
from repro_torch.launch import serve
from repro_torch.models import init_caches, init_params, random_batch
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
    per round (x and y in one launch, (K-1) launches).  The data are scaled by 2^-8 (eta by 2^8) so that every
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
    gt_update.launches = gt_update.leaf_updates = 0
    for _ in range(4):
        x, y = kernel(x, y, data)
        xp, yp = plain(xp, yp, data)
        assert bool(torch.isfinite(x).all() and torch.isfinite(y).all())
        assert torch.equal(x, xp) and torch.equal(y, yp)
    # x and y in one launch a local step
    assert (gt_update.launches, gt_update.leaf_updates) == (4 * (K - 1), 4 * (K - 1) * 2)


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
    gt_update.launches = gt_update.leaf_updates = 0
    core.make_round(prob.loss, GradientTracking(), 3, 1e-4)(x, x, prob.agent_data)
    # m == 1: no fused anchor step, every local step is an update of x and
    # y in one launch
    assert (gt_update.launches, gt_update.leaf_updates) == (3, 3 * 2)


def _many_leaves(dev, zdt, cdt, numels, seed, shift=()):
    """Leaves z, g, c of the given sizes; those whose index is in `shift`
    are contiguous views one element past an aligned base."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i, n in enumerate(numels):
        trip = []
        for dt in (zdt, zdt, cdt):
            t = (torch.randn(n + 1, generator=gen, device=dev) * 4).to(DT[dt])
            trip.append(t[1:] if i in shift else t[:n].clone())
        out.append(trip)
    return [t[0] for t in out], [t[1] for t in out], [t[2] for t in out]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_cuda_gt_update_many_bitwise_over_a_tree(cuda_device, pair):
    """One launch over leaves of every size class: aligned (vectors and a
    ragged tail), misaligned views (scalar accesses), an empty leaf, a
    leaf of one element and one past a wave of blocks; each leaf's own
    scale; every output bitwise the plain version."""
    zdt, cdt = pair
    numels = [1, 7, 1000, 4097, 0, (1 << 22) + 3, 333, 64]
    zs, gs, cs = _many_leaves(cuda_device, zdt, cdt, numels, 3, shift={2, 6})
    assert zs[2].data_ptr() % 16 and zs[6].data_ptr() % 16
    scales = [(-1.0) ** i * ETA * (i + 1) for i in range(len(numels))]
    gt_update.launches = gt_update.leaf_updates = 0
    got = gt_update_many(zs, gs, cs, scales)
    torch.cuda.synchronize()
    assert (gt_update.launches, gt_update.leaf_updates) == (1, len(numels) - 1)
    for z, g, c, s, o in zip(zs, gs, cs, scales, got):
        want = ref.gt_update_ref(z, g, c, s, 1.0)
        assert o.dtype == z.dtype and o.shape == z.shape
        assert torch.equal(_bits(o), _bits(want))


def test_cuda_gt_update_many_more_leaves_than_a_table(cuda_device):
    """More leaves than one launch's table: ceil(leaves / TABLE_CAP)
    launches, every leaf bitwise."""
    n = TABLE_CAP + 45
    zs, gs, cs = _many_leaves(cuda_device, "f32", "bf16", [(i * 37) % 300 + 1
                                                           for i in range(n)], 5)
    gt_update.launches = gt_update.leaf_updates = 0
    got = gt_update_many(zs, gs, cs, [ETA] * n)
    torch.cuda.synchronize()
    assert (gt_update.launches, gt_update.leaf_updates) == (2, n)
    for z, g, c, o in zip(zs, gs, cs, got):
        assert torch.equal(_bits(o), _bits(ref.gt_update_ref(z, g, c, ETA, 1.0)))


def test_cuda_gt_update_many_mixed_pairs_in_one_tree(cuda_device):
    """Leaves of three (z, c) dtype pairs interleaved: one launch a pair,
    outputs in the leaves' order; an all-empty call launches nothing."""
    pairs = [("f64", "f64"), ("f32", "fp8"), ("bf16", "bf16")] * 3
    zs, gs, cs = [], [], []
    for i, (zdt, cdt) in enumerate(pairs):
        z, g, c = _many_leaves(cuda_device, zdt, cdt, [100 + 31 * i], 20 + i,
                               shift={0} if i % 4 == 1 else ())
        zs += z
        gs += g
        cs += c
    gt_update.launches = gt_update.leaf_updates = 0
    got = gt_update_many(zs, gs, cs, [-ETA] * len(zs))
    torch.cuda.synchronize()
    assert (gt_update.launches, gt_update.leaf_updates) == (3, len(zs))
    for z, g, c, o in zip(zs, gs, cs, got):
        assert torch.equal(_bits(o), _bits(ref.gt_update_ref(z, g, c, ETA, -1.0)))
    e = torch.empty(0, device=cuda_device)
    assert gt_update_many([e, e], [e, e], [e, e], [ETA, ETA])[1].numel() == 0
    assert (gt_update.launches, gt_update.leaf_updates) == (3, len(zs))


@pytest.mark.parametrize("cdt", ["f64", "bf16", "fp8"])
def test_cuda_gt_update_pair_is_one_launch(cuda_device, cdt):
    """`make_gt_update_fn().pair` updates the leaves of x and y in one
    launch, bitwise the engine's plain `default_update` (f64 corrections)
    or the kernel's per-leaf plain version (narrow ones)."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    rn = lambda *s, dt="f64": torch.randn(*s, generator=gen, device=cuda_device,
                                          dtype=torch.float64).to(DT[dt])
    xs = {"w": rn(8, 33), "b": rn(8, 5)}
    ys = [rn(8, 1000), rn(8, 2)]
    gx, gy = {k: rn(*v.shape) for k, v in xs.items()}, [rn(*v.shape) for v in ys]
    cx = {k: rn(*v.shape, dt=cdt) for k, v in xs.items()}
    cy = [rn(*v.shape, dt=cdt) for v in ys]
    fn = make_gt_update_fn()
    gt_update.launches = gt_update.leaf_updates = 0
    x1, y1 = fn.pair(xs, gx, cx, 2e-3, ys, gy, cy, 3e-3)
    torch.cuda.synchronize()
    assert (gt_update.launches, gt_update.leaf_updates) == (1, 4)
    if cdt == "f64":
        wx = core.default_update(xs, gx, cx, 2e-3, -1.0)
        wy = core.default_update(ys, gy, cy, 3e-3, 1.0)
    else:
        wx = {k: ref.gt_update_ref(xs[k], gx[k], cx[k], 2e-3, -1.0) for k in xs}
        wy = [ref.gt_update_ref(a, b, c, 3e-3, 1.0) for a, b, c in zip(ys, gy, cy)]
    assert all(torch.equal(x1[k], wx[k]) for k in xs)
    assert all(torch.equal(a, b) for a, b in zip(y1, wy))


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


# ------------------------------------------------------- the unpack table
def _unpack_cases(dev, dt):
    """(tag, data, idx, scale, spec, want) of chip_smoke.py's `pack_cases`
    matrix for one dtype, packed by the plain version: the main path's
    [16, 4096] at k 410 / 1024 / 4096 with uint16 / int32 indices, every
    encoding and bits, top-k and rand-k; ragged 5x4097 / 3x1000 / 2x37
    rows (f64, f32); rows of NaN whose padding indices fall past the row
    (f64, f32, bf16); the streamed 4x40000 / 2x60000 rows.  want is
    `ref.decode_payload_ref`'s."""
    def case(tag, R, C, fb, seed, k, bits, mode, enc, idt, nan_every=0):
        c, e, us, ur = _leaf(dev, R, C, dt, fb, seed, nan_every)
        data, idx, scale = ref.pack_payload_ref(c, e, us, ur, k=k, bits=bits, mode=mode,
                                                encoding=enc, index_dtype=idt)[:3]
        spec = UnpackSpec(C, DT[dt], k, bits, enc)
        return (f"{dt} {tag} {mode} b{bits} {enc} {R}x{C} k{k}", data, idx, scale, spec,
                ref.decode_payload_ref(data, idx, scale, **spec._asdict()))

    for (enc, bits), mode in itertools.product(PACK_CASES, ("topk", "randk")):
        for j, k in enumerate((410, 1024, 4096)):
            yield case("main", 16, 4096, True, 6, k, bits, mode, enc,
                       (torch.uint16, torch.int32)[j % 2])
    if dt in ("f64", "f32"):
        for (R, C), (enc, bits) in itertools.product([(5, 4097), (3, 1000), (2, 37)],
                                                     PACK_CASES):
            for k in sorted({1, max(1, C // 4), C}):
                yield case("ragged", R, C, False, 7, k, bits, "topk", enc, torch.int32)
    if dt != "fp8":
        for enc, mode in itertools.product(ENCODINGS, ("topk", "randk")):
            yield case("nan-row", 3, 1000, True, 8, 250, 8, mode, enc, torch.int32, 3)
    streamed = {"f64": (4, 40000, "randk"), "f32": (2, 60000, "topk")}
    if dt in streamed:
        R, C, mode = streamed[dt]
        for enc, bits in [("quant", 4), ("quant_dense", 4), ("sparse", 32), ("dense", 8)]:
            yield case("streamed", R, C, True, 9, C // 10, bits, mode, enc, torch.uint16)


def _wire_nulls(data, idx, scale, spec):
    """The operands as the transport passes them: no indices where they
    are the iota (k == cols) or the encoding has none, no scale where the
    encoding has none."""
    no_idx = spec.k == spec.cols or spec.encoding in ("quant_dense", "dense")
    return (data, None if no_idx else idx,
            scale if spec.encoding.startswith("quant") else None)


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_unpack_table_bitwise_over_the_pack_matrix(cuda_device, dt):
    """Each case alone, then the dtype's whole matrix in one
    `unpack_payload_many` call with the transport's null indices and
    scales (one launch a table of TABLE_CAP leaves: every encoding, spec
    and index width mixed), bit for bit."""
    cases = list(_unpack_cases(cuda_device, dt))
    for tag, data, idx, scale, spec, want in cases:
        assert _same(unpack_payload_2d(data, idx, scale, **spec._asdict()), want), tag
    unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
    leaves = [_wire_nulls(*c[1:5]) for c in cases]
    got = unpack_payload_many(*zip(*leaves), [c[4] for c in cases])
    torch.cuda.synchronize()
    assert (unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (
        -(-len(cases) // UNPACK_TABLE_CAP), len(cases))
    for c, g in zip(cases, got):
        assert _same(g, c[5]), c[0]


def test_cuda_unpack_one_table_mixes_encodings_and_specs(cuda_device):
    """Leaves of every encoding, bits, k, index width, null indices and
    scale, row count and length in one call: one launch, each leaf bit
    for bit."""
    leaves = []
    for j, ((R, C), (enc, bits)) in enumerate(itertools.product(
            [(16, 4096), (3, 1000), (1, 37), (130, 64)], PACK_CASES)):
        c, e, us, ur = _leaf(cuda_device, R, C, "f32", j % 2 == 0, j)
        k = max(1, C // (2 + j % 5))
        idt = (torch.uint16, torch.int32)[j % 2]
        data, idx, scale = ref.pack_payload_ref(c, e, us, ur, k=k, bits=bits,
                                                encoding=enc, index_dtype=idt)[:3]
        spec = UnpackSpec(C, torch.float32, k, bits, enc)
        leaves.append((_wire_nulls(data, idx, scale, spec), spec,
                       ref.decode_payload_ref(data, idx, scale, **spec._asdict())))
    unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
    got = unpack_payload_many(*zip(*[lv[0] for lv in leaves]), [lv[1] for lv in leaves])
    torch.cuda.synchronize()
    assert (unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (1, len(leaves))
    for (_, spec, want), g in zip(leaves, got):
        assert _same(g, want), spec


def test_cuda_unpack_more_leaves_than_a_table(cuda_device):
    n = UNPACK_TABLE_CAP + 7
    c, e, us, ur = _leaf(cuda_device, 2 * n, 96, "bf16", True, 5)
    spec = UnpackSpec(96, torch.bfloat16, 24, 4, "quant")
    data, idx, scale = ref.pack_payload_ref(c, e, us, ur, k=24, bits=4,
                                            index_dtype=torch.uint16)[:3]
    want = ref.decode_payload_ref(data, idx, scale, **spec._asdict())
    rows = [slice(2 * i, 2 * i + 2) for i in range(n)]
    unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
    got = unpack_payload_many([data[r] for r in rows], [idx[r] for r in rows],
                              [scale[r] for r in rows], [spec] * n)
    torch.cuda.synchronize()
    assert (unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (2, n)
    assert _same(torch.cat(got), want)


@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_unpack_out_view_at_a_misaligned_offset(cuda_device, dt):
    """Out views one or more values past an aligned base, with a row
    stride off the 16-byte grid: the tile's columns before the first
    boundary and after the last take scalar stores; the padding around
    the view is left as it was."""
    for (R, C), enc, off in [((16, 4096), "quant", 1), ((3, 1000), "sparse", 3),
                             ((5, 4097), "quant_dense", 5), ((2, 37), "dense", 1),
                             ((4, 600), "quant", 7)]:
        c, e, us, ur = _leaf(cuda_device, R, C, dt, True, R + off)
        k = max(1, C // 4)
        data, idx, scale = ref.pack_payload_ref(c, e, us, ur, k=k, bits=8, encoding=enc)[:3]
        spec = UnpackSpec(C, DT[dt], k, 8, enc)
        want = ref.decode_payload_ref(data, idx, scale, **spec._asdict())
        buf = torch.empty((R, C + off + 2), dtype=DT[dt], device=cuda_device)
        buf.view(torch.uint8).fill_(0x55)
        out = buf[:, off:off + C]
        res = unpack_payload_2d(*_wire_nulls(data, idx, scale, spec), out=out,
                                **spec._asdict())
        torch.cuda.synchronize()
        assert res.data_ptr() == out.data_ptr() and _same(out, want), (R, C, enc)
        rest = torch.cat([buf[:, :off], buf[:, off + C:]], dim=1)
        assert bool((rest.view(torch.uint8) == 0x55).all()), (R, C, enc)


@pytest.mark.parametrize("enc", ["quant", "sparse"])
@pytest.mark.parametrize("idt", [torch.uint16, torch.int32], ids=["u16", "i32"])
def test_cuda_unpack_unique_indices_in_any_order(cuda_device, enc, idt):
    """Each row's (index, slot) pairs shuffled: the kernel takes no sorted
    order.  Indices past the row (and, as int32, below 0) are dropped."""
    R, C, k, bits = 16, 4096, 1024, 8
    c, e, us, ur = _leaf(cuda_device, R, C, "f64", True, 21)
    data, idx, scale = ref.pack_payload_ref(c, e, us, ur, k=k, bits=bits, encoding=enc,
                                            index_dtype=idt)[:3]
    spec = UnpackSpec(C, torch.float64, k, bits, enc)
    want = ref.decode_payload_ref(data, idx, scale, **spec._asdict())
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    perm = torch.argsort(torch.rand(R, k, generator=gen, device=cuda_device), dim=1)
    sidx = torch.gather(idx.to(torch.int64), 1, perm)
    if enc == "sparse":
        sdata = torch.gather(data, 1, perm)
    else:
        levels = ref.unpack_words(data, k, bits)
        sdata = ref.pack_words(torch.gather(levels, 1, perm), bits)
    # drop a few slots: past the row, and below 0 where the indices are signed
    past = torch.zeros((R, k), dtype=torch.bool, device=cuda_device)
    past[:, ::97] = True
    want = ref.decode_payload_ref(sdata, torch.where(past, C + 3, sidx).to(idt), scale,
                                  **spec._asdict())
    bad = -2 if idt == torch.int32 else C + 3
    got = unpack_payload_2d(sdata, torch.where(past, bad, sidx).to(idt), scale,
                            **spec._asdict())
    torch.cuda.synchronize()
    assert _same(got, want)
    assert not _same(want, ref.decode_payload_ref(data, idx, scale, **spec._asdict()))


def test_cuda_unpack_null_idx_and_scale_equal_the_materialized(cuda_device):
    """The implicit iota (k == cols) and the zero scale the transport no
    longer makes give the bits the made ones give."""
    for dt in ("f64", "bf16"):
        c, e, us, ur = _leaf(cuda_device, 16, 4096, dt, True, 2)
        for enc, bits in [("quant", 8), ("sparse", 32), ("dense", 32), ("quant_dense", 4)]:
            data, idx, scale = ref.pack_payload_ref(c, e, us, ur, k=4096, bits=bits,
                                                    encoding=enc)[:3]
            spec = UnpackSpec(4096, DT[dt], 4096, bits, enc)
            iota = torch.arange(4096, dtype=torch.int32, device=cuda_device).expand(16, 4096)
            zero = torch.zeros_like(scale)
            made = unpack_payload_2d(data, iota.contiguous(),
                                     scale if enc.startswith("quant") else zero,
                                     **spec._asdict())
            null = unpack_payload_2d(data, None, scale if enc.startswith("quant") else None,
                                     **spec._asdict())
            assert _same(made, null) and _same(null, ref.decode_payload_ref(
                data, idx, scale, **spec._asdict())), (dt, enc)


def _tied_rows(dev, R, C, dt, seed):
    """R rows cycling Gaussian, all equal, a block of ties below a few
    larger values (tied rand-k scores too), NaN every third column (NaN
    rand-k scores too) and zeros; feedback only where it keeps the ties."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    scale = 50.0 if dt == "fp8" else 100.0
    c = torch.randn(R, C, **f64) * scale
    e = torch.randn(R, C, **f64) * (scale * 0.1)
    us, ur = torch.rand(R, C, **f64), torch.rand(R, C, **f64)
    kind = torch.arange(R, device=dev) % 5
    col = torch.arange(C, device=dev)
    third = (col % 3 == 0)[None]
    c = torch.where((kind == 1)[:, None], 2.5, c)
    us = torch.where((kind == 1)[:, None], 0.5, us)
    two = (kind == 2)[:, None]
    c = torch.where(two, torch.where(third, 7.0, 1.0), c)
    c = torch.where(two & (col < max(1, C // 10))[None], 50.0, c)
    us = torch.where(two & third, 0.75, us)
    nan = (kind == 3)[:, None] & third
    c = torch.where(nan, float("nan"), c)
    us = torch.where(nan, float("nan"), us)
    c = torch.where((kind == 4)[:, None], 0.0, c)
    e = torch.where(((kind == 1) | (kind == 2) | (kind == 4))[:, None], 0.0, e)
    return ref.cast_to(c, DT[dt]), ref.cast_to(e, DT[dt]), us, ur


@pytest.mark.parametrize("R", [1, 3, 16, 17, 33, 132, 16384])
@pytest.mark.parametrize("dt", ["f64", "f32", "bf16", "fp8"])
def test_cuda_compress_correction_clusters_bitwise(cuda_device, dt, R):
    """Every cluster size (1: one CTA a row; 2, 4, 8 CTAs a row joined
    through distributed shared memory) and the launcher's own choice,
    bitwise the plain version over rows of many equal scores, NaN rows
    and zero rows, odd row lengths (rows starting off a vector boundary),
    k from 1 to C, both modes, 8-bit and no quantization; the route each
    call took is recorded."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    shapes = [(R, 255)] if R > 2 * sms else [(R, 4096), (R, 1001)]
    for (rows, C), cs in itertools.product(shapes, CLUSTER_SIZES + (None,)):
        c, e, us, ur = _tied_rows(cuda_device, rows, C, dt, rows + C)
        for mode, k, bits in itertools.product(("topk", "randk"),
                                               sorted({1, C // 10, C // 3, C - 1, C}),
                                               (8, 32)):
            got = compress_correction_2d(c, e, us, ur, k=k, bits=bits, mode=mode,
                                         cluster=cs)
            plan = compress_correction_2d.last_plan
            want = ref.compress_correction_ref(c, e, us, ur, k=k, bits=bits, mode=mode)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want, ("chat", "resid")):
                assert _same(g, w), f"{name} {rows}x{C} cluster={cs} {mode} k={k} b{bits}"
            size = auto_cluster(rows, C) if cs is None else cs
            assert plan == {"route": "cluster" if size > 1 else "staged",
                            "cluster": size,
                            "threads": 256 if size > 1 or rows >= 2 * sms else 512}


def test_cuda_compress_correction_cluster_choice_and_unaligned(cuda_device):
    """The launcher's cluster size fills the SMs (8 CTAs a row at the
    strategies' 16 rows, 1 at many), asks at least 128 columns a CTA, and
    takes operands one element off an aligned base (scalar accesses) at
    every size; a size outside 1, 2, 4, 8 is refused."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert auto_cluster(16, 4096) == 8 and auto_cluster(sms // 4, 4096) == 4
    assert auto_cluster(2 * sms, 4096) == 1 and auto_cluster(16, 300) == 2
    c, e, us, ur = _tied_rows(cuda_device, 5, 1000, "f32", 9)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    leaf = tuple(map(shifted, (c, e, us, ur)))
    assert leaf[0].data_ptr() % 16
    for cs, mode in itertools.product(CLUSTER_SIZES, ("topk", "randk")):
        got = compress_correction_2d(*leaf, k=250, bits=8, mode=mode, cluster=cs)
        want = ref.compress_correction_ref(*leaf, k=250, bits=8, mode=mode)
        assert all(_same(g, w) for g, w in zip(got, want)), (cs, mode)
    with pytest.raises(ValueError, match="cluster must be one of"):
        compress_correction_2d(c, e, us, ur, k=8, bits=8, cluster=3)


def test_cuda_compress_kernels_count_launches_and_raise(cuda_device):
    c, e, us, ur = _leaf(cuda_device, 4, 256, "f32", True, 1)
    compress_correction_2d.launches = pack_payload_2d.launches = 0
    unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
    compress_correction_2d(c, e, us, ur, k=8, bits=8)
    data, idx, scale, _ = pack_payload_2d(c, e, us, ur, k=8, bits=8)
    unpack_payload_2d(data, idx, scale, cols=256, dtype=c.dtype, k=8, bits=8)
    assert (compress_correction_2d.launches, pack_payload_2d.launches,
            unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (1, 1, 1, 1)
    with pytest.raises(TypeError, match="unsupported dtype"):
        compress_correction_2d(c.half(), None, None, ur, k=8, bits=8)
    with pytest.raises(ValueError, match="different devices"):
        compress_correction_2d(c, e.cpu(), None, ur, k=8, bits=8)
    with pytest.raises(ValueError, match="contiguous"):
        compress_correction_2d(c.t().contiguous().t(), None, None, None, k=8)
    with pytest.raises(ValueError, match="different devices"):
        unpack_payload_2d(data, idx.cpu(), scale, cols=256, dtype=c.dtype, k=8, bits=8)
    assert (compress_correction_2d.launches, pack_payload_2d.launches,
            unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (1, 1, 1, 1)


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
        unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
        (x, y, st), _ = core.run_strategy_rounds(
            rnd, x0, x0, prob.agent_data, rounds, s.init_state(x0, x0, 8))
        out[use] = (x, y, st, compress_correction_2d.launches,
                    pack_payload_2d.launches, unpack_payload_2d.launches,
                    unpack_payload_2d.leaf_decodes)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for key in out[True][2]:
        assert torch.equal(out[True][2][key].cpu(), out[False][2][key].cpu())
    # the wire: x and y decoded in one launch a round, two leaves
    want = (0, 2 * rounds, rounds, 2 * rounds) if wire else (2 * rounds, 0, 0, 0)
    assert out[True][3:] == want
    assert out[False][3:] == (0, 0, 0, 0)


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
    draws feed both), with gt_update updating K x 2 leaves a noisy round
    ((K - 1) x 2 with the fused anchor step), x and y in one launch a
    step, pack twice and unpack once (x and y in one launch)."""
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
        gt_update.leaf_updates = unpack_payload_2d.leaf_decodes = 0
        (x, y, st), _ = core.run_strategy_rounds(
            rnd, x0, x0, prob.agent_data, rounds, s.init_state(x0, x0, m))
        out[name] = (x, y, st, gt_update.launches, gt_update.leaf_updates,
                     pack_payload_2d.launches, unpack_payload_2d.launches,
                     unpack_payload_2d.leaf_decodes)
    assert torch.equal(out["kernels"][0], out["plain"][0])
    assert torch.equal(out["kernels"][1], out["plain"][1])
    for key in out["kernels"][2]:
        assert torch.equal(out["kernels"][2][key].cpu(), out["plain"][2][key].cpu())
    gt, packs = launches
    assert out["kernels"][3:] == (gt // 2 * rounds, gt * rounds, packs * rounds,
                                  packs // 2 * rounds, packs * rounds)
    assert out["plain"][3:] == (0, 0, 0, 0, 0)


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
    bit; gt_update updates (K - 1) x 2 leaves a round (K x 2 without the
    fused anchor step) in one launch a step, compress / pack 2 a round,
    unpack 1 (x and y in one launch, 2 leaves)."""
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
        gt_update.leaf_updates = unpack_payload_2d.leaf_decodes = 0
        x, y = runner.run(x0, x0, rounds, schedule=sched, rebase=rebase)
        torch.cuda.synchronize()
        out[name] = (x, y, runner._state or {}, runner.elastic_state,
                     (gt_update.launches, gt_update.leaf_updates,
                      compress_correction_2d.launches,
                      pack_payload_2d.launches, unpack_payload_2d.launches,
                      unpack_payload_2d.leaf_decodes))
    k, p = out["kernels"], out["plain"]
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for key in k[2]:
        assert torch.equal(k[2][key].cpu(), p[2][key].cpu())
    for key in k[3]["tracker"]:
        assert torch.equal(k[3]["tracker"][key], p[3]["tracker"][key])
    assert k[4] == (gt // 2 * rounds, gt * rounds, comp * rounds, packs * rounds,
                    packs // 2 * rounds, packs * rounds)
    assert p[4] == (0, 0, 0, 0, 0, 0)


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
    equal the plain path's bit for bit; gt_update updates (K - 1) x 2
    leaves a round with the fused anchor step (K x 2 without) in one launch
    a step, the compressors' and the pod partials' kernels 2 a round, and
    unpack 1 (x and y in one launch, 2 leaves)."""
    import dataclasses

    from repro_torch import sim

    rounds, K = 5, 4
    prob, pop, sched = _sparse_setup(cuda_device, rounds=rounds, K=K)
    strategy, wire_pods, launches = {
        "gt_wire_pods": (GradientTracking(), True, (2 * (K - 1), 0, 2, 0, 0)),
        "cgt_wire": (CompressedGT(compression_ratio=0.1, wire_transport=True), False,
                     (2 * K, 0, 2, 1, 2)),
        "qgt_dense": (QuantizedGT(bits=8, ratio=0.25), False, (2 * K, 2, 0, 0, 0)),
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
        gt_update.leaf_updates = unpack_payload_2d.leaf_decodes = 0
        x, y = eng.run(x0, x0, sched)
        torch.cuda.synchronize()
        out[name] = (x, y, eng._state, eng._tracker,
                     (gt_update.launches, gt_update.leaf_updates,
                      compress_correction_2d.launches,
                      pack_payload_2d.launches, unpack_payload_2d.launches,
                      unpack_payload_2d.leaf_decodes))
    k, p = out["kernels"], out["plain"]
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for key in k[2]:
        assert torch.equal(k[2][key].cpu(), p[2][key].cpu())
    assert torch.equal(k[3].sum_gx, p[3].sum_gx) and torch.equal(k[3].sum_gy, p[3].sum_gy)
    for a, b in zip(k[3]._gx_leaves, p[3]._gx_leaves):
        assert (a[:k[3].num_touched] == b[:p[3].num_touched]).all()
    assert k[4] == tuple(n * rounds for n in (launches[0] // 2, *launches))
    assert p[4] == (0, 0, 0, 0, 0, 0)


def test_cuda_pod_partials_roundtrip_through_pack_and_unpack(cuda_device):
    """Dense pod payloads: encode through `pack_payload` and decode through
    `unpack_payload` give the partials back bit for bit, the packed
    buffers equal the plain encoder's, one pack launch per leaf and one
    unpack launch a dtype (the partials hold an f64 and an f32 leaf; two
    f64 leaves share one launch)."""
    from repro_torch.fed import pods

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    partials = (torch.randn(37, 4096, dtype=torch.float64, generator=gen,
                            device=cuda_device),
                {"a": torch.randn(37, 3, 5, generator=gen, device=cuda_device)})
    pack_payload_2d.launches = unpack_payload_2d.launches = 0
    unpack_payload_2d.leaf_decodes = 0
    packed = pods.encode_pod_partials(partials)
    back = pods.decode_pod_partials(packed)
    torch.cuda.synchronize()
    assert (pack_payload_2d.launches, unpack_payload_2d.launches,
            unpack_payload_2d.leaf_decodes) == (2, 2, 2)
    assert torch.equal(back[0], partials[0]) and torch.equal(back[1]["a"],
                                                             partials[1]["a"])
    same = (partials[0], partials[0][:5])
    unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
    back = pods.decode_pod_partials(pods.encode_pod_partials(same))
    torch.cuda.synchronize()
    assert (unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (1, 2)
    assert torch.equal(back[0], same[0]) and torch.equal(back[1], same[1])
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
    (4, 32, 8, 512, 512, 128, True, 0, 0.0),      # pixtral-12b's prefill
    (4, 16, 16, 512, 512, 80, False, 0, 0.0),     # hubert-xlarge's encoder
], ids=["square", "ragged-gqa", "gemma2-local", "sq<skv", "window", "one-query",
        "hd33", "hd100", "s4096-window", "hd256", "sq1", "sq1-skv1", "pixtral",
        "hubert"])
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
    ("zamba2-7b", 64), ("gemma2-2b", 128), ("falcon-mamba-7b", 48),
    ("llama4-scout-17b-a16e", 128), ("pixtral-12b", 64)])
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
    batch = random_batch(torch.Generator(device=cuda_device).manual_seed(1), cfg, B,
                         prompt_len)
    prompts = {k: v for k, v in batch.items() if k != "labels"}  # pixtral: patches
    runs = {}
    for use in (True, False):
        caches = init_caches(cfg, B, prompt_len + n, torch.float32, cuda_device)
        runs[use] = serve.generate(params, cfg, prompts, caches, n, use_kernel=use,
                                   forced=runs[True]["tokens"] if not use else None)
    got, want = runs[True]["step_logits"], runs[False]["step_logits"]
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    n_attn = sum(k in ("attn", "local", "moe") for k in cfg.layer_types)
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
    K - 1 a round (x and y in one launch a step) on each of the 4 shard
    streams, none on the server's."""
    import collections

    from repro_torch import fed
    from repro_torch.kernels import ops

    seen = []
    real = ops.gt_update_many

    def spy(zs, gs, cs, scales):
        seen.append(torch.cuda.current_stream(zs[0].device).cuda_stream)
        return real(zs, gs, cs, scales)

    monkeypatch.setattr(ops, "gt_update_many", spy)
    prob, x0 = _async_setup(cuda_device)
    K, rounds = 4, 3
    ar = fed.AsyncFederatedRunner(prob.loss, "fedgda_gt", prob.agent_data, K, 1e-4,
                                  devices=[cuda_device] * ASYNC_SHARDS)
    gt_update.launches = gt_update.leaf_updates = 0
    ar.run(x0, x0, rounds)
    torch.cuda.synchronize()
    handles = [s.cuda_stream for s in ar._streams]
    assert collections.Counter(seen) == {h: (K - 1) * rounds for h in handles}
    assert gt_update.launches == len(seen)
    assert gt_update.leaf_updates == 2 * len(seen)
    assert torch.cuda.current_stream(cuda_device).cuda_stream not in handles


# --------------------------------------------------- the multi-host runner
def _multihost(prob, strategy, devices, **kw):
    from repro_torch.launch.multihost import MultiHostRunner

    return MultiHostRunner(prob.loss, strategy, prob.agent_data, 4, 1e-4,
                           devices=devices, **kw)


@pytest.mark.parametrize("mk", [
    lambda **kw: CompressedGT(compression_ratio=0.25, wire_transport=True, **kw),
    lambda **kw: QuantizedGT(bits=8, wire_transport=True, **kw),
    lambda **kw: QuantizedGT(bits=4, ratio=0.25, mode="randk", wire_transport=True,
                             **kw),
], ids=["cgt_topk25", "qgt8", "qgt4_randk25"])
def test_cuda_multihost_bytes_decode_pin_and_plain(cuda_device, mk):
    """`MultiHostRunner(devices=[card] * 4)`: every round's gathered bytes
    equal `expected_gather_bytes` and m x the payload share of
    `measured_bytes_per_round`; each shard's own decode on its stream
    equals the server's decode bit for bit; the run through the kernels
    equals the run through the plain versions bit for bit."""
    from repro_torch.fed.transport import dense_payload_bytes, measured_bytes_per_round
    from repro_torch.launch.multihost import expected_gather_bytes

    prob, x0 = _async_setup(cuda_device)
    rounds, m = 3, 16
    mr = _multihost(prob, mk(), [cuda_device] * ASYNC_SHARDS)
    xm, ym = mr.run(x0, x0, rounds)
    assert len({s.cuda_stream for s in mr._streams}) == ASYNC_SHARDS
    meas = measured_bytes_per_round(mk(), x0, x0, 4, include_headers=False)
    share = (meas - 2 * dense_payload_bytes((x0, x0))) // 2
    assert [e["gathered_payload_bytes"] for e in mr.wire_log] == [
        expected_gather_bytes(mk(), x0, x0, m)] * rounds == [m * share] * rounds
    own_x, own_y = mr.decode_on_shards()
    cx, cy = mr.last_exchange["decoded"]
    torch.cuda.synchronize()
    assert torch.equal(own_x, cx) and torch.equal(own_y, cy)
    pr = _multihost(prob, mk(use_kernel=False), [cuda_device] * ASYNC_SHARDS,
                    update_fn=core.default_update)
    xp, yp = pr.run(x0, x0, rounds)
    torch.cuda.synchronize()
    assert torch.equal(xm, xp) and torch.equal(ym, yp)
    assert mr.wire_log == pr.wire_log


def test_cuda_multihost_exact_gt_matches_sync(cuda_device):
    """FedGDA-GT through the multi-host runner on 4 streams within rtol
    1e-9 / atol 1e-12 of the sync runner on the card; its gather is the
    dense correction stack."""
    from repro_torch import fed

    prob, x0 = _async_setup(cuda_device)
    xs, ys = fed.FederatedRunner.from_strategy(prob.loss, "fedgda_gt",
                                               prob.agent_data, 4, 1e-4).run(x0, x0, 5)
    mr = _multihost(prob, GradientTracking(), [cuda_device] * ASYNC_SHARDS)
    xm, ym = mr.run(x0, x0, 5)
    torch.cuda.synchronize()
    torch.testing.assert_close(xm, xs, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(ym, ys, rtol=1e-9, atol=1e-12)
    assert [e["gathered_payload_bytes"] for e in mr.wire_log] == [2 * 16 * 128 * 8] * 5


@pytest.mark.parametrize("wire", [False, True], ids=["dense", "wire"])
def test_cuda_multihost_kernels_launch_on_the_shard_streams(cuda_device, monkeypatch,
                                                            wire):
    """Every shard's gt_update (x and y in one launch a step), and its
    compress_correction (dense) or
    pack_payload (wire) launches, go to its own stream: 4 distinct streams
    of the runner, the same count on each, none on the server's; the
    server's unpack_payload launches stay on the server's stream, one a
    round for every shard's x and y.  The spies sit at the callers' names
    (a wrapper counts its launches through its own)."""
    import collections

    from repro_torch.fed import strategies, transport
    from repro_torch.kernels import ops

    seen = collections.defaultdict(list)

    def spying(mod, attr):
        real = getattr(mod, attr)

        def spy(z, *a, **kw):
            lead = z[0] if isinstance(z, (list, tuple)) else z
            seen[attr].append(torch.cuda.current_stream(lead.device).cuda_stream)
            return real(z, *a, **kw)

        monkeypatch.setattr(mod, attr, spy)

    spying(ops, "gt_update_many")
    spying(strategies, "compress_leaf")
    spying(transport, "pack_payload_2d")
    spying(transport, "unpack_payload_many")
    prob, x0 = _async_setup(cuda_device)
    K, rounds = 4, 2
    mr = _multihost(prob, CompressedGT(compression_ratio=0.25, wire_transport=wire),
                    [cuda_device] * ASYNC_SHARDS)
    mr.run(x0, x0, rounds)
    torch.cuda.synchronize()
    handles = [s.cuda_stream for s in mr._streams]
    assert len(set(handles)) == ASYNC_SHARDS
    server = torch.cuda.current_stream(cuda_device).cuda_stream
    assert server not in handles
    assert collections.Counter(seen["gt_update_many"]) == {h: K * rounds
                                                           for h in handles}
    shard_kernel = "pack_payload_2d" if wire else "compress_leaf"
    assert collections.Counter(seen[shard_kernel]) == {h: 2 * rounds for h in handles}
    assert collections.Counter(seen["unpack_payload_many"]) == (
        {server: rounds} if wire else {})


# ------------------------------------------------- the backward kernels
GRAD_REL = 1e-4  # of each gradient's max |value|


def _grad_close(got, want, what="", floor=0.0):
    """got within GRAD_REL of want's max |value|; where the exact gradient
    is 0 throughout (a causal row that sees one key has dq = dk = 0), of
    `floor`, the gradient's size as its operands set it."""
    torch.cuda.synchronize()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(want.abs().max()) or max(floor, 1e-30)
    err = float((got - want).abs().max())
    assert err <= GRAD_REL * scale, f"{what}: max |err| {err:.3e} > {GRAD_REL} x {scale:.3e}"


def _flash_grads(q, k, v, dout, kw):
    from repro_torch.kernels.flash_attention import _forward, flash_attention_bwd

    out, lse = _forward(q, k, v, kw["causal"], kw["window"], kw["softcap"], with_lse=True)
    return flash_attention_bwd(q, k, v, out, lse, dout, **kw)


@pytest.mark.parametrize("case", [
    # (B, H, KV, Sq, Skv, hd, causal, window, softcap, layout)
    (2, 4, 4, 128, 128, 112, True, 0, 0.0, "dense"),       # zamba2's hd
    (1, 8, 4, 300, 300, 256, True, 4096, 50.0, "dense"),   # gemma2's local
    (1, 8, 2, 200, 200, 64, True, 50, 0.0, "model"),        # GQA, strided
    (2, 2, 1, 37, 100, 32, False, 0, 0.0, "dense"),         # Sq < Skv, MQA
    (1, 2, 2, 150, 130, 48, False, 40, 20.0, "model"),      # window, softcap
    (1, 4, 2, 77, 77, 33, True, 0, 5.0, "dense"),           # ragged hd
    (1, 2, 2, 1, 9, 160, True, 0, 0.0, "dense"),            # one query, one key
    (1, 2, 2, 1, 9, 160, False, 0, 0.0, "dense"),           # one query
    (1, 4, 4, 1024, 1024, 64, True, 0, 0.0, "dense"),       # 8 key tiles' dq partials, split-Q
    (1, 2, 1, 256, 1024, 64, False, 0, 0.0, "dense"),       # ... none masked
    (2, 4, 4, 200, 200, 112, True, 0, 0.0, "dense"),        # Skv off the 64-key tiles
    (1, 16, 2, 256, 256, 64, True, 0, 0.0, "model"),        # G = 8 grouped heads
    (1, 4, 2, 130, 260, 256, False, 0, 20.0, "model"),      # hd 256, Sq < Skv, softcap
    (1, 8, 4, 300, 300, 256, True, 64, 0.0, "dense"),       # hd 256, window
], ids=["zamba2", "gemma2-local", "gqa-model", "mqa", "window-cap", "hd33", "sq1",
        "sq1-full", "s1024", "s1024-full", "skv200", "g8", "hd256-full", "hd256-window"])
def test_cuda_flash_attention_bwd_equals_plain(cuda_device, case):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd,
        plain_flash_attention_bwd,
    )

    B, H, KV, Sq, Skv, hd, causal, window, softcap, layout = case
    gen = torch.Generator(device=cuda_device).manual_seed(Sq * hd)

    def make(heads, S):
        if layout == "model":  # [B, S, heads, hd] read through a transpose
            return torch.randn(B, S, heads, hd, generator=gen, device=cuda_device).transpose(1, 2)
        return torch.randn(B, heads, S, hd, generator=gen, device=cuda_device)

    q, k, v, dout = make(H, Sq), make(KV, Skv), make(KV, Skv), make(H, Sq)
    kw = dict(causal=causal, window=window, softcap=softcap)
    flash_attention_bwd.launches = 0
    got = _flash_grads(q, k, v, dout, kw)
    again = _flash_grads(q, k, v, dout, kw)
    assert flash_attention_bwd.launches == 2
    want = plain_flash_attention_bwd(q, k, v, dout, **kw)
    big = lambda t: float(t.abs().max())
    floor = big(dout) * big(v) * max(big(q), big(k)) / math.sqrt(hd)
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        _grad_close(g, w, name, floor)
        assert torch.equal(g, g2), f"{name}: two calls differ"


def test_cuda_flash_attention_lse_leaves_the_output_bitwise(cuda_device):
    from repro_torch.kernels.flash_attention import _forward

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for hd, dt, window, softcap in ((112, torch.float32, 0, 0.0),
                                    (256, torch.float32, 64, 50.0),
                                    (64, torch.bfloat16, 0, 0.0)):
        q, k, v = (torch.randn(2, 4, 333, hd, generator=gen, device=cuda_device).to(dt)
                   for _ in range(3))
        plain, none = _forward(q, k, v, True, window, softcap, with_lse=False)
        got, lse = _forward(q, k, v, True, window, softcap, with_lse=True)
        assert none is None and torch.equal(plain, got)
        want = ref.flash_attention_lse_ref(q.float(), k.float(), v.float(), causal=True,
                                           window=window, softcap=softcap)
        _close(lse, want, 1e-5)


def test_cuda_flash_attention_bwd_offsets_past_int32(cuda_device):
    """q, k, v, out and dout as views of one buffer of more than 2^31
    floats, the second batch entry past element 2^31."""
    from repro_torch.kernels.flash_attention import plain_flash_attention_bwd

    B, H, S, hd = 2, 2, 64, 64
    per = H * S * hd
    bstride = (1 << 31) + 64
    try:
        buf = torch.empty(bstride + 5 * per, device=cuda_device)
    except torch.cuda.OutOfMemoryError:
        pytest.skip("needs 8.6 GB of device memory")
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    views = []
    for i in range(5):
        t = buf.as_strided((B, H, S, hd), (bstride, S * hd, hd, 1), i * per)
        t.copy_(torch.randn(B, H, S, hd, generator=gen, device=cuda_device))
        views.append(t)
    q, k, v, _, dout = views
    kw = dict(causal=True, window=0, softcap=0.0)
    got = _flash_grads(q, k, v, dout, kw)
    want = plain_flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                     dout.contiguous(), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _grad_close(g, w, name)
    del buf, views, q, k, v, dout


def test_cuda_flash_attention_function_under_vmap_equals_a_loop(cuda_device):
    """The agents' losses vmapped and one backward: the Function folds
    the agent axis into the batch, equal to each agent's own gradient."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    A, B, S, H, KV, hd = 3, 2, 96, 4, 2, 112
    q, k, v, w = (torch.randn(A, B, S, n, hd, generator=gen, device=cuda_device)
                  for n in (H, KV, KV, H))

    def loss(q, k, v, w):
        return (grouped_flash_attention(q, k, v, causal=True, window=40) * w).sum()

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention.launches = flash_attention_bwd.launches = 0
    got = torch.autograd.grad(torch.func.vmap(loss)(*leaves, w).sum(), leaves)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (1, 1)
    for i in range(A):
        one = [t[i].clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(loss(*one, w[i]), one)
        for g, wv in zip(got, want):
            _grad_close(g[i], wv)
    with pytest.raises(TypeError, match="f32"):
        b = q[0].bfloat16().requires_grad_()
        grouped_flash_attention(b, b, b)


@pytest.mark.parametrize("case", [
    # (B, S, H, P, N, decay, layout)
    (4, 128, 12, 64, 64, "head", 5),    # Mamba-2 (zamba2's head_p and N)
    (1, 300, 200, 1, 16, "full", 5),    # Mamba-1, ragged S
    (2, 33, 7, 3, 5, "full", 5),        # ragged, N < 32
    (2, 19, 5, 2, 100, "head", 5),      # N > 64
    (1, 17, 3, 4, 256, "head", 5),      # the largest state
    (2, 40, 96, 1, 16, "chan", 4),      # 4-D layout, da [B, S, D, 1]
    (1, 50, 6, 1, 8, "full", 3),        # one sequence
    (2, 37, 5, 24, 64, "head", 5),      # S not a multiple of 16; a head = 3 row groups
    (2, 50, 3, 12, 64, "head", 5),      # row groups end mid-head (d da over P apart)
    (2, 45, 4, 32, 16, "head", 5),      # N 16, a head a row group
    (1, 21, 2, 12, 256, "head", 5),     # N 256: chunks of 8, a head = 3 row groups
    (2, 30, 3, 5, 256, "full", 5),      # N 256, da full over the states
], ids=["mamba2", "mamba1", "ragged", "n100", "n256", "4d", "3d", "s37-p24",
        "p12-midhead", "n16-head", "n256-p12", "n256-full"])
@pytest.mark.parametrize("start", ["zero", "state0"])
def test_cuda_ssm_scan_bwd_equals_plain(cuda_device, case, start):
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    B, S, H, P, N, decay, nd = case
    gen = torch.Generator(device=cuda_device).manual_seed(S * N + nd)
    shapes = {5: (B, S, H, P, N), 4: (B, S, H, N), 3: (S, H, N)}
    dbx_shape = shapes[nd]
    da_shape = {"head": (B, S, H, 1, 1), "full": dbx_shape,
                "chan": (B, S, H, 1)}[decay]
    da = torch.sigmoid(torch.randn(*da_shape, generator=gen, device=cuda_device)) * 0.95
    dbx = torch.randn(*dbx_shape, generator=gen, device=cuda_device) * 0.1
    c = torch.randn(*((B, S, N) if nd > 3 else (S, N)), generator=gen, device=cuda_device)
    s0 = (torch.randn(*_state(dbx_shape), generator=gen, device=cuda_device)
          if start == "state0" else None)
    leaves = [t.clone().requires_grad_() for t in (da, dbx, c) + ((s0,) if s0 is not None else ())]
    wy = torch.randn(*dbx_shape[:-1], generator=gen, device=cuda_device)
    ws = torch.randn(*_state(dbx_shape), generator=gen, device=cuda_device)

    def grads(scan):
        args = leaves + ([None] if s0 is None else [])
        y, st = scan(*args)
        return torch.autograd.grad((y * wy).sum() + (st * ws).sum(), leaves)

    from repro_torch.kernels.ssm_scan import plain_ssm_scan

    ssm_scan_bwd.launches = 0
    got, again = grads(ssm_scan), grads(ssm_scan)
    assert ssm_scan_bwd.launches == 2
    want = grads(plain_ssm_scan)
    for name, g, g2, w in zip(("dda", "ddbx", "dc", "dstate0"), got, again, want):
        _grad_close(g, w, name)
        assert torch.equal(g, g2), f"{name}: two calls differ"


def test_cuda_scan_and_flash_bwd_plans(cuda_device):
    """The backward kernels' plans at the training shapes: the scan's CTAs
    cover a whole head of zamba2-7b (64 rows, d da summed over P in the
    CTA, 112 dc partials a batch); flash's CTAs of 8 warps on key tiles
    of 64 with query tiles of 16 at hd 112 (two CTAs an SM), of 16 warps
    on 128 keys with query tiles of 32 at hd 64."""
    from repro_torch.kernels.flash_attention import bwd_plan as flash_plan
    from repro_torch.kernels.ssm_scan import bwd_plan, chunk_len

    got = bwd_plan(16, 112, 64, 64, 1, True)
    assert (got["rows_per_cta"], got["parts"], got["heads_per_cta"], got["chunk_len"]) == (
        64, 112, 1, chunk_len(64))
    assert got["smem_bytes"] <= 113 * 1024
    assert bwd_plan(2, 3, 12, 64, 1, True)["heads_per_cta"] == 0  # 12 rows: mid-group
    assert bwd_plan(1, 8192, 1, 16, 0, False)["chunk_len"] == chunk_len(16) == 16
    assert bwd_plan(1, 3, 4, 256, 1, True)["chunk_len"] == chunk_len(256) == 8
    f = flash_plan(112)
    assert (f["keys_per_cta"], f["rows_per_tile"], f["threads"]) == (64, 16, 256)
    assert f["smem_bytes"] <= 113 * 1024
    f = flash_plan(64)
    assert (f["keys_per_cta"], f["rows_per_tile"], f["threads"]) == (128, 32, 512)
    f = flash_plan(256)
    assert (f["keys_per_cta"], f["threads"]) == (64, 256)
    assert all(flash_plan(hd)["smem_bytes"] <= 227 * 1024 for hd in (16, 64, 96, 112, 128, 256))


def _state(dbx_shape):
    """The final state's shape for dbx of `dbx_shape`."""
    return dbx_shape[1:] if len(dbx_shape) == 3 else (dbx_shape[0], *dbx_shape[2:])


def test_cuda_ssm_scan_function_under_vmap_equals_a_loop(cuda_device):
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    A, B, S, H, P, N = 3, 2, 64, 6, 64, 64
    da = torch.sigmoid(torch.randn(A, B, S, H, 1, 1, generator=gen, device=cuda_device))
    dbx = torch.randn(A, B, S, H, P, N, generator=gen, device=cuda_device) * 0.1
    c = torch.randn(A, B, S, N, generator=gen, device=cuda_device)
    w = torch.randn(A, B, S, H, P, generator=gen, device=cuda_device)

    def loss(da, dbx, c, w):
        return (ssm_scan(da, dbx, c)[0] * w).sum()

    leaves = [t.clone().requires_grad_() for t in (da, dbx, c)]
    ssm_scan.launches = ssm_scan_bwd.launches = 0
    got = torch.autograd.grad(torch.func.vmap(loss)(*leaves, w).sum(), leaves)
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == (1, 1)
    for i in range(A):
        one = [t[i].clone().requires_grad_() for t in (da, dbx, c)]
        want = torch.autograd.grad(loss(*one, w[i]), one)
        for g, wv in zip(got, want):
            _grad_close(g[i], wv)


# ------------------------------- the SPMD layer: the kernels on DTensors
@pytest.fixture(scope="module")
def one_rank_mesh():
    """A (1, 1) mesh over a one-process NCCL group (`make_host_mesh`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(1, 1)


def _on_mesh(t, mesh, *pl):
    """t as this rank's shard of a DTensor (default: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, list(pl) or [Replicate(), Replicate()],
                              run_check=False)


def _kernel_calls(name, device):
    """(the kernel wrapper, a call on given operands, the operands, which
    placements the operands take): each kernel at a small shape."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.flash_attention import _forward, flash_attention_bwd
    from repro_torch.kernels.ssm_scan import _launch, ssm_scan_bwd

    gen = torch.Generator(device=device).manual_seed(11)
    rn = lambda *s: torch.randn(*s, generator=gen, device=device)
    batch_and_heads = [Shard(0), Shard(1)]
    if name == "gt_update":
        ops = (rn(64, 48), rn(64, 48), rn(64, 48))
        return gt_update, lambda z, g, c: gt_update(z, g, c, eta=ETA, sign=-1.0), ops, \
            [Shard(0), Shard(1)]
    if name == "flash_attention":
        ops = (rn(2, 4, 96, 64), rn(2, 2, 96, 64), rn(2, 2, 96, 64))
        return flash_attention, lambda q, k, v: flash_attention(q, k, v, causal=True), \
            ops, batch_and_heads
    if name == "flash_attention_bwd":
        q, k, v, dout = rn(2, 4, 96, 64), rn(2, 2, 96, 64), rn(2, 2, 96, 64), rn(2, 4, 96, 64)
        out, lse = _forward(q, k, v, True, 0, 0.0, True)
        return flash_attention_bwd, lambda *ts: flash_attention_bwd(*ts, causal=True), \
            (q, k, v, out, lse, dout), batch_and_heads
    da = torch.sigmoid(rn(2, 40, 6, 1, 1)) * 0.95
    dbx, c, s0 = rn(2, 40, 6, 8, 16) * 0.1, rn(2, 40, 16), rn(2, 6, 8, 16)
    if name == "ssm_scan":
        return ssm_scan, ssm_scan, (da, dbx, c, s0), [Shard(0), Replicate()]
    if name == "ssm_scan_bwd":
        _, _, chunks = _launch(da.expand(dbx.shape), dbx, c, s0, chunks=True)
        dy, ds = rn(2, 40, 6, 8), rn(2, 6, 8, 16)
        return ssm_scan_bwd, lambda *ts: ssm_scan_bwd(*ts[:6], chunks=ts[6]), \
            (da, dbx, c, s0, dy, ds, chunks), [Shard(0), Replicate()]
    spec = dict(cols=40, dtype=torch.float32, k=10, bits=32, encoding="sparse")
    data, idx, scale, _ = pack_payload_2d(rn(24, 40), None, None, None, k=10, bits=32,
                                          encoding="sparse")
    return unpack_payload_2d, lambda d, i, s: unpack_payload_2d(d, i, s, **spec), \
        (data, idx, scale), [Shard(0), Replicate()]


@pytest.mark.parametrize("name", ["gt_update", "flash_attention", "flash_attention_bwd",
                                  "ssm_scan", "ssm_scan_bwd", "unpack_payload"])
@pytest.mark.parametrize("placed", ["replicated", "sharded"])
def test_cuda_kernels_on_dtensors_equal_plain_tensors(one_rank_mesh, name, placed):
    """Each kernel's entry on DTensors of a one-rank NCCL mesh runs the
    kernel on the local shard (one launch, no plain version) and gives the
    bits of the kernel on the plain tensors, which the tests above hold
    against the plain versions."""
    from torch.distributed.tensor import DTensor

    wrapper, call, ops, pl = _kernel_calls(name, one_rank_mesh.device_type)
    want = call(*ops)
    wrapper.launches = 0
    got = call(*(_on_mesh(t, one_rank_mesh, *(pl if placed == "sharded" else ()))
                 for t in ops))
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert isinstance(g, DTensor)
        assert torch.equal(g.full_tensor(), w)


@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma2-2b"])
def test_cuda_spmd_serve_equals_the_serving_path(one_rank_mesh, arch):
    """`examples.serve_batched` through the step builders on the one-rank
    mesh: logits bitwise the plain serving path's (`serve.generate`), the
    same launches."""
    from repro_torch.examples.serve_batched import place_params
    from repro_torch.examples.serve_batched import serve as spmd_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg).tree()
    prompts = {"tokens": random_batch(torch.Generator(device=dev).manual_seed(1), cfg, 2,
                                      64)["tokens"]}
    want = serve.generate(params, cfg, prompts, init_caches(cfg, 2, 70, torch.float32, dev), 6)
    got = spmd_serve(cfg, one_rank_mesh, place_params(params, cfg, one_rank_mesh), prompts,
                     6, forced=want["tokens"])
    assert torch.equal(got["step_logits"], want["step_logits"])
    assert got["launches"]["prefill"] == want["launches"]["prefill"]
    assert got["launches"]["decode"]["flash_attention"] == 0


def test_cuda_spmd_train_step_equals_the_round(one_rank_mesh):
    """`build_train_step` on the one-rank mesh (m = 1 agent): one round's
    iterates bitwise the engine's round without a constraint, through the
    kernels."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import flash_attention_bwd, ssm_scan_bwd
    from repro_torch.launch.steps import build_train_step
    from repro_torch.problems.adversarial import (
        delta_projection,
        init_delta,
        make_adversarial_loss,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("zamba2-7b").reduced()
    x = init_params(torch.Generator(device=dev).manual_seed(0), cfg).tree()
    y = init_delta(cfg, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (1, 2, 32),
                        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    step_for, _ = build_train_step(cfg, one_rank_mesh, num_local_steps=3, eta=2e-3,
                                   dtype=torch.float32, remat=True)
    for fn in (gt_update, flash_attention, flash_attention_bwd, ssm_scan, ssm_scan_bwd):
        fn.launches = 0
    x1, y1 = step_for(ShapeConfig("t", 32, 2, "train"))(x, y, batch)
    launched = [fn.launches for fn in (gt_update, flash_attention, flash_attention_bwd,
                                        ssm_scan, ssm_scan_bwd)]
    assert all(n > 0 for n in launched), launched
    rnd = core.make_round(make_adversarial_loss(cfg, remat=True), GradientTracking(), 3,
                          2e-3, proj_y=delta_projection(1.0))
    xr, yr = rnd(x, y, batch)
    for a, b in zip(core.tree_leaves((x1, y1)), core.tree_leaves((xr, yr))):
        assert torch.equal(a.full_tensor(), b)
