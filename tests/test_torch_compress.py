"""The compressed-correction plain versions of the port against the JAX
package, bit for bit, on the same numpy inputs, and the reference's own
pins re-pinned inside torch.

  * `ref.compress_correction_ref` against JAX's oracle (what its Pallas
    kernel computes): f64, f32, bf16 and fp8 corrections; top-k and
    rand-k; bits 2-32; feedback on and off; rows of ties, all-zero rows,
    k = C, and rows with NaN (the order `jax.lax.top_k` gives NaN pinned);
  * dense compression and bits=32 + ratio=1 are GradientTracking bit for
    bit (`test_strategy_convergence.py:69`, `test_quantization.py:152`),
    and the top-k feedback mechanics (`test_strategy_convergence.py:141,
    157`);
  * the kernel wrappers on CPU tensors: they run the plain versions, count
    no launch, and raise on what the kernels do not take;
  * a numpy model of the cluster route's select (`csrc/row_select.cuh`
    `Staged` with kCluster: a row cut into contiguous slices of 4-column
    groups over 1, 2, 4 or 8 CTAs, the slices' min / max keys and
    histograms summed each pass, the last <= 32 candidates gathered in
    rank order, each CTA's tie allowance k - #gt less the ties of the
    lower ranks, the scale a NaN-propagating max over the CTAs) held
    bitwise against the plain version's kept set and scale.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import core, fed
from repro_torch.convert import problem_from_numpy
from repro_torch.fixtures import load_compressed_rounds
from repro_torch.kernels import (
    compress_correction_2d,
    compress_leaf,
    fusable_leaf,
    pack_payload_2d,
    ref,
    unpack_payload_2d,
)
from test_torch_pack_select import GROUP, RANK, UINT, from_okey, max_nan, okeys
from test_torch_parity import BITS, DT, SHAPES, assert_same, ks_of, make_leaf, seed_of

pytestmark = pytest.mark.torch


# ------------------------------------------------ plain versions vs JAX
@pytest.mark.parametrize("feedback", [True, False], ids=["ef", "noef"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("dt", list(DT))
def test_compress_ref_equals_jax(dt, mode, bits, feedback):
    rng = np.random.default_rng(seed_of(dt, mode, bits, feedback))
    for R, C in SHAPES:
        jx, tx = make_leaf(rng, R, C, dt, feedback)
        for k in ks_of(C):
            want = jref.compress_correction_ref(*jx, k=k, bits=bits, mode=mode)
            got = ref.compress_correction_ref(*tx, k=k, bits=bits, mode=mode)
            for w, g, name in zip(want, got, ("chat", "resid")):
                assert_same(w, g, f"{name} {R}x{C} k={k}")


@pytest.mark.parametrize("bits", [8, 32])
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("dt", list(DT))
def test_compress_ref_with_nan_rows_equals_jax(dt, mode, bits):
    """NaN corrections are real (an fp8 correction overflows to NaN):
    NaN ranks above every score, as in `jax.lax.top_k`, and compares
    false, so such a row keeps what JAX keeps."""
    rng = np.random.default_rng(11)
    for R, C, every in [(3, 37, 3), (2, 130, 1), (4, 64, 20)]:
        jx, tx = make_leaf(rng, R, C, dt, True, nan_every=every)
        for k in ks_of(C):
            want = jref.compress_correction_ref(*jx, k=k, bits=bits, mode=mode)
            got = ref.compress_correction_ref(*tx, k=k, bits=bits, mode=mode)
            for w, g, name in zip(want, got, ("chat", "resid")):
                assert_same(w, g, f"{name} {R}x{C} k={k}")


def test_topk_order_of_nan_is_pinned():
    """The k-th largest score and the exact-k mask with NaN scores, as
    `jax.lax.top_k` orders them (NaN above +inf)."""
    s = np.array([[1.0, np.nan, 3.0, 2.0, np.nan, np.inf],
                  [np.nan] * 6,
                  [0.0, 0.0, 1.0, 1.0, 1.0, np.nan]])
    for k in range(1, 6):
        want_thr = np.asarray(jax.lax.top_k(jnp.asarray(s), k)[0])[:, -1:]
        got_thr = ref.kth_largest(torch.tensor(s), k).numpy()
        np.testing.assert_array_equal(got_thr, want_thr)
        want = np.asarray(jref.exact_k_mask(jnp.asarray(s), k))
        got = ref.exact_k_mask(torch.tensor(s), k).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------ the reference's pins, in torch
M, DIM, K, ETA = 8, 6, 4, 2e-4


@pytest.fixture(scope="module")
def quad():
    f = load_compressed_rounds()
    return problem_from_numpy("quadratic", {"G": f["quad6_G"], "Ab": f["quad6_Ab"]},
                              "cpu")


def _rounds_equal(prob, a, b, rounds=5):
    ra = core.make_round(prob.loss, a, K, ETA)
    rb = core.make_round(prob.loss, b, K, ETA)
    xa = xb = torch.ones(DIM, dtype=torch.float64)
    ya = yb = -torch.ones(DIM, dtype=torch.float64)
    for t in range(rounds):
        xa, ya = ra(xa, ya, prob.agent_data)
        xb, yb = rb(xb, yb, prob.agent_data)
        assert torch.equal(xa, xb), f"x diverges at round {t}"
        assert torch.equal(ya, yb), f"y diverges at round {t}"


@pytest.mark.parametrize("mode", ["topk", "randk"])
def test_dense_compression_equals_gradient_tracking_exactly(quad, mode):
    _rounds_equal(quad, fed.CompressedGT(compression_ratio=1.0, mode=mode),
                  fed.GradientTracking())


@pytest.mark.parametrize("wire", [False, True])
def test_bits32_ratio1_equals_gradient_tracking_exactly(quad, wire):
    s = fed.QuantizedGT(bits=32, ratio=1.0, wire_transport=wire)
    assert not s.stateful and s.exact_correction
    _rounds_equal(quad, s, fed.GradientTracking())


def test_identity_configurations_are_stateless():
    assert not fed.CompressedGT(compression_ratio=1.0).stateful
    assert fed.CompressedGT(compression_ratio=0.5).stateful
    assert fed.QuantizedGT(bits=8).stateful
    assert not fed.QuantizedGT(bits=8).exact_correction
    assert fed.QuantizedGT(bits=32, ratio=0.5).stateful
    assert fed.QuantizedGT(bits=8, error_feedback=False).stateful
    assert fed.CompressedGT(compression_ratio=0.5).sharded_state_keys == ("ex", "ey")
    assert fed.CompressedGT(compression_ratio=0.5,
                            error_feedback=False).sharded_state_keys == ()
    assert fed.GradientTracking().sharded_state_keys == ()


def test_knob_validation_and_aliases():
    with pytest.raises(ValueError, match="bits >= 2"):
        fed.QuantizedGT(bits=1)
    with pytest.raises(ValueError, match="unknown compression mode"):
        fed.QuantizedGT(mode="middlek")
    s = fed.resolve_strategy("compressed_gt", compression_ratio=0.2,
                             compression_mode="randk", seed=4)
    assert s == fed.CompressedGT(compression_ratio=0.2, mode="randk", seed=4)
    assert s.use_kernel and not s.wire_transport
    q = fed.resolve_strategy("quantized_gt", quantization_bits=4,
                             wire_transport=True, use_kernel=False)
    assert q == fed.QuantizedGT(bits=4, wire_transport=True, use_kernel=False)
    for name in ("compressed_gt", "quantized_gt"):
        # the noise knobs ride on the compressors (a noisy round)
        noisy = fed.resolve_strategy(name, noise_sigma=0.1, noise_seed=2)
        assert noisy.noise == fed.GaussianNoise(0.1) and noisy.noise_seed == 2
        assert noisy.stateful and not noisy.exact_correction
    st = s.init_state(torch.zeros(3), torch.zeros(2), 4)
    st["ex"] = torch.ones(4, 3)
    # the elastic hook (sim): all agents continuing keeps every EF row
    kept = s.rebase_state(st, torch.ones(4, dtype=torch.bool))
    assert torch.equal(kept["ex"], st["ex"]) and torch.equal(kept["ey"], st["ey"])
    # the sparse layout's hook: no previous ids zeroes every row; rows of
    # continuing ids are carried across layouts
    fresh = s.realign_state_rows(st, None, [0, 1])
    assert torch.equal(fresh["ex"], torch.zeros(2, 3))
    st["ex"] = torch.arange(12.0).reshape(4, 3)
    moved = s.realign_state_rows(st, [1, 4, 6, 9], [4, 5, 9])
    assert torch.equal(moved["ex"], torch.stack([st["ex"][1], torch.zeros(3),
                                                 st["ex"][3]]))


def test_topk_keeps_largest_and_feedback_stores_rest():
    s = fed.CompressedGT(compression_ratio=0.5, mode="topk")
    cx = torch.tensor([[4.0, -3.0, 0.5, 0.25], [1.0, 2.0, -8.0, 0.125]])
    cy = torch.zeros((2, 1))
    state = s.init_state(torch.zeros(4), torch.zeros(1), 2)
    cx2, _, state = s.transform_correction(cx, cy, state)
    np.testing.assert_array_equal(
        cx2.numpy(), [[4.0, -3.0, 0.0, 0.0], [0.0, 2.0, -8.0, 0.0]])
    np.testing.assert_array_equal(state["ex"].numpy(), (cx - cx2).numpy())


def test_topk_keeps_exactly_k_under_ties():
    s = fed.CompressedGT(compression_ratio=0.5, mode="topk")
    cx = torch.tensor([[1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
    state = s.init_state(torch.zeros(4), torch.zeros(1), 2)
    cx2, _, _ = s.transform_correction(cx, torch.zeros((2, 1)), state)
    assert (cx2 != 0).sum(dim=1).tolist() == [2, 0]
    np.testing.assert_array_equal(cx2[0].numpy(), [1.0, 1.0, 0.0, 0.0])


# ------------------------------------------- kernel wrappers on the CPU
def test_wrappers_run_the_plain_versions_on_cpu_and_count_nothing():
    rng = np.random.default_rng(3)
    _, (c, e, us, ur) = make_leaf(rng, 4, 100, "f32", True)
    compress_correction_2d.launches = pack_payload_2d.launches = 0
    unpack_payload_2d.launches = 0
    for mode, bits in [("topk", 8), ("randk", 32)]:
        got = compress_correction_2d(c, e, us, ur, k=10, bits=bits, mode=mode)
        want = ref.compress_correction_ref(c, e, us, ur, k=10, bits=bits, mode=mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert all(torch.equal(g, w) for g, w in zip(
            compress_leaf(c, e, us, ur, k=10, bits=bits, mode=mode,
                          use_kernel=False), want))
    data, idx, scale, _ = pack_payload_2d(c, e, us, ur, k=10, bits=8,
                                          encoding="quant",
                                          index_dtype=torch.uint16)
    out = unpack_payload_2d(data, idx, scale, cols=100, dtype=torch.float32,
                            k=10, bits=8, encoding="quant")
    assert torch.equal(out, ref.decode_payload_ref(
        data, idx, scale, cols=100, dtype=torch.float32, k=10, bits=8,
        encoding="quant"))
    assert compress_correction_2d.launches == 0
    assert pack_payload_2d.launches == 0 and unpack_payload_2d.launches == 0


def test_every_row_length_is_fusable():
    """The TPU rule C % 128 == 0 is gone: every 2D leaf with a row."""
    for C in (1, 37, 128, 4097):
        assert fusable_leaf(torch.zeros(3, C))
    assert not fusable_leaf(torch.zeros(3, 0))
    assert not fusable_leaf(torch.zeros(3))


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    c = torch.zeros(4, 16)
    u = torch.rand(4, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown mode"):
        compress_correction_2d(c, None, u, u, k=2, mode="middle")
    with pytest.raises(ValueError, match="needs u_sel"):
        compress_correction_2d(c, None, None, u, k=2, mode="randk")
    with pytest.raises(ValueError, match="needs u_rnd"):
        compress_correction_2d(c, None, None, None, k=2, bits=8)
    with pytest.raises(ValueError, match="k >= 1"):
        compress_correction_2d(c, None, None, None, k=0)
    with pytest.raises(ValueError, match="bits >= 2"):
        compress_correction_2d(c, None, None, u, k=2, bits=1)
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        compress_correction_2d(c[0], None, None, None, k=2)
    with pytest.raises(TypeError, match="unsupported dtype"):
        compress_correction_2d(c.half(), None, None, None, k=2)
    with pytest.raises(ValueError, match="match c"):
        compress_correction_2d(c, c.double(), None, None, k=2)
    with pytest.raises(ValueError, match="contiguous"):
        compress_correction_2d(c, c.t().contiguous().t(), None, None, k=2)
    with pytest.raises(ValueError, match="f64 or f32"):
        compress_correction_2d(c, None, None, u.half(), k=2, bits=8)
    with pytest.raises(TypeError, match="share a dtype"):
        compress_correction_2d(c, None, u.float(), u, k=2, bits=8, mode="randk")
    with pytest.raises(ValueError, match="bit-packing needs bits < 32"):
        pack_payload_2d(c, None, None, None, k=2, encoding="quant")
    with pytest.raises(ValueError, match="unknown payload encoding"):
        pack_payload_2d(c, None, None, None, k=2, encoding="zip")
    with pytest.raises(ValueError, match="exceeds the row length"):
        pack_payload_2d(c, None, None, u, k=17, bits=8, encoding="sparse")
    with pytest.raises(TypeError, match="index dtype"):
        pack_payload_2d(c, None, None, u, k=2, bits=8, index_dtype=torch.int64)
    with pytest.raises(TypeError, match="scale is kept"):
        pack_payload_2d(c, None, None, u, k=2, bits=8, scale_dtype=torch.float64)
    data, idx, scale, _ = pack_payload_2d(c, None, None, u, k=2, bits=8)
    with pytest.raises(ValueError, match="data must be"):
        unpack_payload_2d(data[:, :0], idx, scale, cols=16, dtype=torch.float32,
                          k=2, bits=8)
    with pytest.raises(ValueError, match="idx must be"):
        unpack_payload_2d(data, idx.to(torch.int64), scale, cols=16,
                          dtype=torch.float32, k=2, bits=8)
    with pytest.raises(ValueError, match="scale must be"):
        unpack_payload_2d(data, idx, scale.double(), cols=16,
                          dtype=torch.float32, k=2, bits=8)


def test_fp8_cast_equals_jax_bitwise():
    """`ref.cast_to` to fp8 e4m3 gives JAX's bits: rounding to nearest even,
    and NaN keeping the sign for |v| > 464, infinities and NaN (some torch
    CPU builds saturate to +-448 instead)."""
    v = np.array([-600.0, -470.0, -464.0001, -464.0, -448.0, -0.0, 0.0, 1e-9,
                  0.3, 17.3, 448.0, 464.0, 464.0001, 470.0, np.inf, -np.inf,
                  np.nan, -np.nan], dtype=np.float32)
    v = np.concatenate([v, np.random.default_rng(0).standard_normal(200).astype(
        np.float32) * 100])
    want = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = ref.cast_to(torch.tensor(v), torch.float8_e4m3fn).view(torch.uint8)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------- the cluster route, modelled
#: the shapes of chip_smoke's compress_cases: the main path's [16, 4096]
#: and the ragged ones
CLUSTER_SHAPES = [(16, 4096), (5, 4097), (3, 1000), (2, 37)]


def slices_of(n: int, o: int, cs: int):
    """Each CTA's columns [lo, hi) of a row of n whose position 0 is
    column -o: rank r takes the r-th run of ceil(groups / cs) groups."""
    groups = (o + n + GROUP - 1) // GROUP
    per = -(-groups // cs)
    out = []
    for r in range(cs):
        g_lo = min(groups, r * per)
        g_hi = min(groups, g_lo + per)
        hi = max(0, min(n, GROUP * g_hi - o))
        out.append((min(hi, max(0, GROUP * g_lo - o)), hi))
    return out


def cluster_select(ceff: torch.Tensor, score: torch.Tensor, k: int, cs: int, o: int,
                   randk: bool, stats: dict):
    """(keep, scale) of one row as a cluster of cs CTAs computes them."""
    n = score.numel()
    u = UINT[score.dtype]
    kbits = 8 * np.dtype(u).itemsize
    sl = slices_of(n, o, cs)
    assert sl[0][0] == 0 and sl[-1][1] == n
    assert all(a[1] == b[0] or b[0] == b[1] for a, b in zip(sl, sl[1:]))
    keys = okeys(score)
    select = k < n
    thr = None
    if select:
        live = [(a, b) for a, b in sl if b > a]
        maxk = max(int(keys[a:b].max()) for a, b in live)
        mink = min(int(keys[a:b].min()) for a, b in live)
        d = (u(maxk) - keys).astype(u)
        ans = 0
        if maxk != mink:
            fs, pref, kk = (maxk - mink).bit_length(), 0, k

            def matching(part):
                return part if fs >= kbits else part[(part >> u(fs)) == u(pref >> fs)]

            while True:
                wbits = min(fs, 8)
                shift = fs - wbits
                # each CTA's histogram of its candidates, summed
                hist = sum(np.bincount(((matching(d[a:b]) >> u(shift))
                                        & u((1 << wbits) - 1)).astype(np.int64),
                                       minlength=256) for a, b in sl)
                incl = np.cumsum(hist)
                b = int(np.argmax(incl >= kk))
                kk -= int(incl[b] - hist[b])
                pref |= b << shift
                fs = shift
                stats["passes"] += 1
                if fs == 0:
                    ans = pref
                    break
                if hist[b] <= RANK:
                    # the candidates gathered in rank order, ranked by one warp
                    cand = np.concatenate([matching(d[a:b_]) for a, b_ in sl])
                    assert cand.size == hist[b]
                    ans = int(np.sort(cand)[kk - 1])
                    stats["ranked"] += 1
                    break
        thr = from_okey(maxk - ans, score.dtype)
    gt = (score > thr) if select else torch.ones(n, dtype=torch.bool)
    tie = (score == thr) if select else torch.zeros(n, dtype=torch.bool)
    mag = ceff.abs()
    ng = [int(gt[a:b].sum()) for a, b in sl]
    nt = [int(tie[a:b].sum()) for a, b in sl]
    need = k - sum(ng)
    kt = min(sum(nt), need)
    keep = gt.clone()
    before = 0  # ties of the lower ranks
    for (a, b), t in zip(sl, nt):
        rank_in = torch.cumsum(tie[a:b].to(torch.int64), 0) - 1 + before
        keep[a:b] |= tie[a:b] & (rank_in < need)
        before += t

    def cta_max(mask, a, b):
        m = 0.0
        for v in mag[a:b][mask[a:b]].tolist():
            m = max_nan(m, v)
        return m

    scale = 0.0
    for a, b in sl:
        scale = max_nan(scale, cta_max(gt, a, b))
    if kt > 0:
        if not randk:
            scale = max_nan(scale, float(thr))
        elif kt == sum(nt):
            for a, b in sl:
                scale = max_nan(scale, cta_max(tie, a, b))
        else:
            stats["dropped_ties"] += 1
            kept_tie = tie & keep
            for a, b in sl:
                scale = max_nan(scale, cta_max(kept_tie, a, b))
    return keep, scale


@functools.lru_cache(maxsize=None)
def _cluster_cases(dt: str, mode: str) -> list:
    """(ceff, score, k, plain keep, plain scale, rows) of the leaves the
    cluster model is held to, for one dtype and mode: `make_leaf`'s rows
    (a row of five 3.0s, an all-zero row, NaN every third column of the
    last row) at compress_cases' shapes, cast by torch (the model and the
    plain version read the same torch bits; JAX is not involved)."""
    rng = np.random.default_rng(seed_of(dt, mode))
    tdt = DT[dt][1]
    ct = ref.compute_dtype(tdt)
    out = []
    for R, C in CLUSTER_SHAPES:
        scale = 50.0 if dt == "fp8" else 100.0
        c = rng.standard_normal((R, C)) * scale
        c[0, : min(5, C)] = 3.0
        if R > 1:
            c[1] = 0.0
        c[-1, ::3] = np.nan
        e = rng.standard_normal((R, C)) * scale * 0.1
        us = torch.tensor(rng.random((R, C)))
        if mode == "randk":  # tied scores: a quarter of each row on one value
            us[:, ::4] = 0.5
        ceff = (ref.cast_to(torch.tensor(c), tdt).to(ct)
                + ref.cast_to(torch.tensor(e), tdt).to(ct))
        score = ceff.abs() if mode == "topk" else us.to(ct)
        # the leaf's tie row, zero row, a Gaussian row and its NaN row
        rows = sorted({0, 1, 2, R - 1} & set(range(R)))
        for k in ks_of(C) + [max(1, C // 4)]:
            keep = ref.exact_k_mask(score, k)
            scl = torch.amax(torch.where(keep, ceff, 0.0).abs(), dim=-1)
            out.append((ceff, score, k, keep, scl, rows))
    return out


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("dt", list(DT))
def test_cluster_select_model_equals_plain_kept_set_and_scale(dt, mode, cs):
    """The cluster model keeps the plain version's exact-k set and finds
    its QSGD scale (max |kept|, NaN when a kept value is NaN) bit for bit,
    over the leaves' ties (a row of five 3.0s, an all-zero row, the fp8 /
    bf16 leaves' many equal values), NaN rows and tied rand-k scores (the
    rows that carry them, and a Gaussian one), whether the rows start on a
    vector group (o = row offset mod 4) or not (o = 0, an unaligned
    leaf)."""
    stats = {"passes": 0, "ranked": 0, "dropped_ties": 0}
    for ceff, score, k, keep_want, scale_want, rows in _cluster_cases(dt, mode):
        C = score.shape[1]
        for r, aligned in itertools.product(rows, (True, False)):
            o = (r * C) % GROUP if aligned else 0
            keep, scale = cluster_select(ceff[r], score[r], k, cs, o, mode == "randk", stats)
            assert torch.equal(keep, keep_want[r]), (C, k, r, o)
            w = float(scale_want[r])
            assert (scale != scale and w != w) or scale == w, (C, k, r, scale, w)
    assert stats["passes"] and stats["ranked"]
    if mode == "randk":
        assert stats["dropped_ties"]
