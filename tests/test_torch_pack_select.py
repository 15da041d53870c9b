"""The staged `pack_payload` kernel's decomposition (`csrc/pack_payload.cu`
`pack_kernel`), emulated step by step in plain torch / numpy on the CPU
and held bit for bit against `ref.pack_payload_ref`, itself held against
the JAX package's `repro.kernels.ref.pack_payload_ref`:

  * the select: an exact radix select on d = max key - key over IEEE
    total-order keys, the first 8-bit digit at d's top bit, candidates
    compacted into two lists of `list_cap(n)` entries once they fit, and
    one warp's rank of the last <= 32;
  * the layout: column i at shared position i + o (o = the row's offset
    from a 4-column vector group), groups split into one contiguous run
    per warp, a lane taking 4 consecutive columns per step;
  * the counting pass: per-warp gt / tie counts and max |ceff|, the
    row's scale as their join (thr for top-k ties; rand-k walks its ties
    only when some are dropped);
  * the write: slot = #gt before i + min(#ties before i, need), every
    count "before i" a scan over warps plus a scan over lanes per step,
    and a NaN row's padding slots (i - slot < k - #kept).

Rows: all equal, one exponent byte, a block of ties split by k, NaN every
third column, zeros, Gaussian; k in {1, a tie split, C - 1, C}; C in
{37, 1000, 4096, 4097}; f64 and f32; both modes and every encoding; the
small (8-warp) and large (16-warp) CTA of the kernel's two launch routes."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from test_torch_parity import DT, ENCODINGS, assert_same

pytestmark = pytest.mark.torch

#: the kernel's constants (csrc/pack_payload.cu)
GROUP, RANK, WARPS = 4, 32, (8, 16)
UINT = {torch.float32: np.uint32, torch.float64: np.uint64}
IVIEW = {4: torch.int32, 8: torch.int64}


def padded(n):
    return (n + 2 * GROUP - 2) // GROUP * GROUP


def list_cap(n):
    return max(RANK, (padded(n) // 4 + 3) // 4 * 4)


def okeys(x: torch.Tensor) -> np.ndarray:
    """IEEE total-order keys of a float tensor, as unsigned numpy ints."""
    u = UINT[x.dtype]
    b = x.contiguous().view(IVIEW[x.element_size()]).numpy().view(u)
    top = u(1) << u(8 * x.element_size() - 1)
    return np.where(b & top, ~b, b | top).astype(u)


def from_okey(key: int, dtype) -> torch.Tensor:
    """The float whose total-order key is `key`."""
    u = UINT[dtype]
    bits = 8 * np.dtype(u).itemsize
    top = 1 << (bits - 1)
    raw = (key & (top - 1)) if key & top else (~key & ((1 << bits) - 1))
    sint = {4: np.int32, 8: np.int64}[np.dtype(u).itemsize]
    return torch.from_numpy(np.array([raw], dtype=u).view(sint)).view(dtype)[0]


def emulate_select(score: torch.Tensor, k: int, stats: dict):
    """The k-th largest score by the kernel's radix select (value and the
    path it took)."""
    n = score.numel()
    u = UINT[score.dtype]
    kbits = 8 * np.dtype(u).itemsize
    keys = okeys(score)
    maxk, mink = int(keys.max()), int(keys.min())
    d_row = (u(maxk) - keys).astype(u)
    dmax = maxk - mink
    cap = list_cap(n)
    if dmax == 0:
        stats["all_equal"] += 1
        return from_okey(maxk, score.dtype)
    fs, pref, kk, expect = dmax.bit_length(), 0, k, n
    src, cur_n = d_row, n  # the row, then a compacted list

    def matching(a):
        if fs >= kbits:
            return a
        return a[(a >> u(fs)) == u(pref >> fs)]

    while True:
        wbits = min(fs, 8)
        shift = fs - wbits
        build = expect <= cap and expect < cur_n
        cand = matching(src)
        assert cand.size == expect
        hist = np.bincount(((cand >> u(shift)) & u((1 << wbits) - 1)).astype(np.int64),
                           minlength=256)
        assert hist.size == 256
        if build:
            assert cand.size <= cap
            src, cur_n = cand, expect
            stats["compacted"] += 1
        incl = np.cumsum(hist)
        b = int(np.argmax(incl >= kk))
        below = int(incl[b] - hist[b])
        pref |= b << shift
        kk -= below
        expect = int(hist[b])
        fs = shift
        stats["passes"] += 1
        if fs == 0:
            stats["all_digits"] += 1
            ans = pref
            break
        if expect <= RANK:
            last = matching(src)
            assert last.size == expect <= cap
            # the warp's rank: less < kk <= less-or-equal
            ans = int(np.sort(last)[kk - 1])
            stats["ranked"] += 1
            break
    return from_okey(maxk - ans, score.dtype)


def layout(n: int, r: int, W: int):
    """(warp, step, lane, position-in-group) of each column of row r of a
    leaf [R, n] whose base is vector-aligned."""
    o = (r * n) % GROUP
    groups = (o + n + GROUP - 1) // GROUP
    per = -(-groups // W)
    p = np.arange(n) + o
    q = p // GROUP
    w = q // per
    assert w.max() < W
    return w, (q - w * per) // 32, (q - w * per) % 32, p % GROUP


def before_counts(flag: np.ndarray, n: int, r: int, W: int):
    """#flag columns before each column, as the kernel counts them: warp
    bases by a scan over warps, then per step the warp's earlier steps, an
    exclusive scan of the lanes' counts and the count inside the lane's
    group.  Returns (counts, per-warp totals, each column's warp)."""
    w, step, lane, j = layout(n, r, W)
    steps = int(step.max()) + 1
    totals = np.bincount(w, weights=flag, minlength=W).astype(np.int64)
    warp_base = np.cumsum(totals) - totals
    ws = w * steps + step
    st = np.bincount(ws, weights=flag, minlength=W * steps).astype(np.int64)
    st = st.reshape(W, steps)
    step_base = (np.cumsum(st, axis=1) - st).reshape(-1)
    wsl = ws * 32 + lane
    lt = np.bincount(wsl, weights=flag, minlength=W * steps * 32).astype(np.int64)
    lt = lt.reshape(W * steps, 32)
    lane_base = (np.cumsum(lt, axis=1) - lt).reshape(-1)
    run = np.cumsum(flag) - flag
    first = np.concatenate([[True], wsl[1:] != wsl[:-1]])  # a group's first column
    inside = run - np.maximum.accumulate(np.where(first, run, 0))
    assert np.all(j[first][1:] == 0)  # only the row's first group is cut
    return warp_base[w] + step_base[ws] + lane_base[wsl] + inside, totals, w


def max_nan(a: float, b: float) -> float:
    if a != a:
        return a
    if b != b:
        return b
    return a if a > b else b


def emulate_pack(c, e, u_sel, u_rnd, *, k, bits, mode, encoding, index_dtype,
                 W, stats):
    """pack_payload_ref's outputs, computed as the staged kernel does."""
    ct = ref.compute_dtype(c.dtype)
    ceff = c.to(ct) if e is None else c.to(ct) + e.to(ct)
    R, n = ceff.shape
    select, randk, qon = k < n, k < n and mode == "randk", bits < 32
    s = float(2 ** (bits - 1) - 1)
    sb, pw, words = ref.word_layout(n if encoding == "quant_dense" else k, bits)
    data_w = np.zeros((R, words), np.int64)
    vals = torch.zeros((R, k if encoding == "sparse" else n), dtype=c.dtype)
    idx = torch.zeros((R, k), dtype=torch.int64)
    scale = torch.zeros((R, 1), dtype=ct)
    resid = torch.empty_like(c)
    for r in range(R):
        ce = ceff[r]
        score = (u_sel[r].to(ct) if randk else ce.abs())
        thr = emulate_select(score, k, stats) if select else None
        gt = (score > thr) if select else torch.ones(n, dtype=torch.bool)
        tie = (score == thr) if select else torch.zeros(n, dtype=torch.bool)
        gtn, tien = gt.numpy().astype(np.int64), tie.numpy().astype(np.int64)
        g_before, g_w, warp = before_counts(gtn, n, r, W)
        t_before, t_w, _ = before_counts(tien, n, r, W)
        n_gt, n_tie = int(g_w.sum()), int(t_w.sum())
        need = k - n_gt
        kt = min(n_tie, need)
        kept = n_gt + kt
        # the counting pass's per-warp maxima and the row's scale
        mag = ce.abs().numpy()

        def fold(m, vals):  # max_nan over vals, starting from m
            if vals.size == 0:
                return m
            return max_nan(m, float("nan") if np.isnan(vals).any() else float(vals.max()))

        mg = [fold(0.0, mag[(warp == w) & (gtn == 1)]) for w in range(W)]
        mt = [fold(0.0, mag[(warp == w) & (tien == 1)]) for w in range(W)]
        scl = 0.0
        if qon:
            for w in range(W):
                scl = max_nan(scl, mg[w])
            if kt > 0:
                if not randk:
                    scl = max_nan(scl, float(thr))
                elif kt == n_tie:
                    for w in range(W):
                        scl = max_nan(scl, mt[w])
                else:
                    stats["tie_walk"] += 1
                    scl = fold(scl, mag[(tien == 1) & (t_before < kt)])
        scale[r, 0] = scl
        keep = torch.from_numpy(gtn.astype(bool) | (tien.astype(bool) & (t_before < need)))
        slot = g_before + np.minimum(t_before, need)
        kv = torch.where(keep, ce, torch.zeros_like(ce))
        lev = np.zeros(n, np.int64)
        if qon:
            safe = scale[r] if float(scale[r]) > 0 else torch.ones(1, dtype=ct)
            rq = torch.full_like(safe, s) / safe
            tq = safe * (1.0 / s)
            uu = kv * rq
            lo = torch.floor(uu)
            q = torch.clamp(lo + (u_rnd[r].to(ct) < uu - lo).to(ct), -s, s)
            v = q * tq
            lv = torch.nan_to_num(q + s, nan=0.0)
            lev = torch.trunc(lv).to(torch.int64).numpy()
        else:
            v = kv
        out = ref.cast_to(v, c.dtype)
        resid[r] = ref.cast_to(ce - out.to(ct), c.dtype)
        pad = k - kept
        col = np.arange(n)
        keepn = keep.numpy()
        padn = ~keepn & (col - slot < pad)  # a NaN row's padding columns
        ps = kept + col[padn] - slot[padn]
        stats["padded"] += int(padn.sum())
        idx[r, slot[keepn]] = torch.from_numpy(col[keepn])
        idx[r, ps] = torch.from_numpy(col[padn] + n)
        if encoding == "quant":
            np.bitwise_or.at(data_w[r], slot[keepn] // pw,
                             lev[keepn] << (slot[keepn] % pw * sb))
        elif encoding == "quant_dense":
            np.bitwise_or.at(data_w[r], col // pw, lev << (col % pw * sb))
        elif encoding == "sparse":
            vals[r, slot[keepn]] = out[keep]
            vals[r, ps] = float("nan")
        else:
            vals[r] = out
    data = (torch.from_numpy(data_w).to(torch.uint32)
            if encoding in ("quant", "quant_dense") else vals)
    return data, idx.to(index_dtype), scale, resid


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(view[a.element_size()]),
        b.contiguous().view(view[b.element_size()])))


def make_rows(rng, C: int, dt: str):
    """(jax operands, torch operands, the tie-splitting k) of a leaf whose
    rows are: all equal, one exponent byte (|v| in [1, 2)), a block of
    ties below a few larger values, NaN every third column, zeros, and
    Gaussian; with feedback and f64 uniforms (the rand-k scores tie and
    hold NaN on the same rows)."""
    jdt, tdt = DT[dt]
    c = rng.standard_normal((6, C)) * 100.0
    c[0] = 2.5
    c[1] = (1.0 + rng.random(C)) * np.where(rng.random(C) < 0.5, -1.0, 1.0)
    big = max(1, C // 10)
    c[2] = rng.random(C) - 2.0
    c[2, ::3] = 7.0
    c[2, : big] = 50.0 + rng.random(big)
    c[3, ::3] = np.nan
    c[4] = 0.0
    # no feedback on the rows whose ties must survive it
    e = rng.standard_normal((6, C)) * 10.0
    e[[0, 1, 2, 4]] = 0.0
    us, ur = rng.random((6, C)), rng.random((6, C))
    us[0] = 0.5                       # rand-k: a row of tied scores,
    us[2, ::3] = 0.75                 # a block of ties
    us[3, ::3] = np.nan               # and NaN scores
    cj = jnp.asarray(c).astype(jdt)
    ej = jnp.asarray(e).astype(jdt)
    ct = torch.from_numpy(np.array(cj))
    et = torch.from_numpy(np.array(ej))
    ties = len(range(0, C, 3)) - len(range(0, big, 3))
    split = min(C - 1, max(1, big + ties // 2))
    return ((cj, ej, jnp.asarray(us), jnp.asarray(ur)),
            (ct, et, torch.tensor(us), torch.tensor(ur)), split)


#: (encoding, bits) of each emulated payload
PAYLOADS = [("quant", 8), ("quant_dense", 4), ("sparse", 32), ("dense", 2)]


@pytest.mark.parametrize("C", [37, 1000, 4096, 4097])
@pytest.mark.parametrize("mode", ["topk", "randk"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_emulated_staged_pack_equals_plain_and_jax(dt, mode, C):
    assert {enc for enc, _ in PAYLOADS} == set(ENCODINGS)
    rng = np.random.default_rng(C * 4 + (dt == "f32") * 2 + (mode == "randk"))
    jx, tx, split = make_rows(rng, C, dt)
    stats = dict.fromkeys(["all_equal", "compacted", "passes", "all_digits",
                           "ranked", "tie_walk", "padded"], 0)
    for (j, k), (enc, bits) in itertools.product(
            enumerate(sorted({1, split, C - 1, C})), PAYLOADS):
        jidx, tidx = [(jnp.int32, torch.int32), (jnp.uint16, torch.uint16)][j % 2]
        kw = dict(k=k, bits=bits, mode=mode, encoding=enc)
        want = ref.pack_payload_ref(*tx, index_dtype=tidx, **kw)
        for W in WARPS:
            got = emulate_pack(*tx, index_dtype=tidx, W=W, stats=stats, **kw)
            for g, w, name in zip(got, want, ("data", "idx", "scale", "resid")):
                assert same_bits(g, w), f"{name} {enc} k={k} W={W}"
        for w, g, name in zip(jref.pack_payload_ref(*jx, index_dtype=jidx, **kw),
                              want, ("data", "idx", "scale", "resid")):
            assert_same(w, g, f"jax {name} {enc} k={k}")
    # every branch of the decomposition ran
    assert stats["all_equal"] and stats["ranked"] and stats["padded"]
    if C >= 1000:
        assert stats["compacted"]
    if mode == "randk" and C >= 1000:
        assert stats["tie_walk"]


def test_emulated_layout_counts_in_column_order():
    """The warp / step / lane / group decomposition visits a row's columns
    in index order for every row offset and both CTA sizes, so its counts
    "before i" are the plain exclusive cumulative sums."""
    rng = np.random.default_rng(0)
    for n, r, W in itertools.product([1, 37, 129, 1000, 4097], range(4), WARPS):
        flag = (rng.random(n) < 0.3).astype(np.int64)
        got, _, _ = before_counts(flag, n, r, W)
        np.testing.assert_array_equal(got, np.cumsum(flag) - flag)
