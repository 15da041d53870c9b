"""Shared helpers of the port's parity tests against the JAX package
(`tests/test_torch_compress.py`, `test_torch_pack*.py`,
`test_torch_transform*.py`, `test_torch_transport.py` and the compressed
rounds and claims): dtype pairs, bit views of JAX arrays and torch
tensors, one leaf of the same numpy inputs for both sides, the transform
gate, and per-round gaps against JAX's stored ones.  The tests at the end
check the comparisons themselves: NaN-aware, and bitwise otherwise."""
import itertools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.convert import (
    strategy_state_from_numpy,
    tensor_from_numpy,
    tree_from_numpy,
)
from repro_torch.core.types import tree_flatten
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch

DT = {
    "f64": (jnp.float64, torch.float64),
    "f32": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
}
BITS = [2, 4, 8, 16, 32]
SHAPES = [(5, 37), (4, 256)]
ENCODINGS = ["quant", "quant_dense", "sparse", "dense"]
#: bit-packing needs bits < 32 (the reference asserts it)
PACK_CASES = [(enc, bits) for enc in ENCODINGS for bits in BITS
              if bits < 32 or not enc.startswith("quant")]
_INT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def as_bits(a) -> np.ndarray:
    """Integer view of a JAX array or a torch tensor (ml_dtypes included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(view[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(_INT[a.dtype.itemsize])


def is_nan(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if not a.is_floating_point():
            return np.zeros(a.shape, bool)
        return torch.isnan(a.to(torch.float64)).numpy()
    a = np.asarray(a)
    if a.dtype.kind != "f" and a.dtype.name not in ("bfloat16", "float8_e4m3fn"):
        return np.zeros(a.shape, bool)
    return np.isnan(a.astype(np.float64))


def assert_same(want, got, tag=""):
    """Bitwise equal, NaN matching NaN whatever its payload (XLA and torch
    quiet NaN payloads differently)."""
    assert tuple(np.shape(want)) == tuple(got.shape), tag
    nw, ng = is_nan(want), is_nan(got)
    assert np.array_equal(nw, ng), f"{tag}: NaN positions differ"
    bw, bg = as_bits(want), as_bits(got)
    assert np.array_equal(bw[~nw], bg[~ng]), f"{tag}: bits differ"


def seed_of(*parts) -> int:
    """A fixed seed per test case (Python's str hash varies per process)."""
    return zlib.crc32(repr(parts).encode())


def ks_of(C):
    return sorted({1, max(1, C // 10), max(1, C // 2), C})


def make_leaf(rng, R, C, dt, feedback, nan_every=0):
    """(jax operands, torch operands) of one leaf: c with a row of ties and
    an all-zero row, optional feedback, and f64 uniforms."""
    jdt, tdt = DT[dt]
    scale = 50.0 if dt == "fp8" else 100.0
    c = rng.standard_normal((R, C)) * scale
    c[0, : min(5, C)] = 3.0
    if R > 1:
        c[1] = 0.0
    if nan_every:
        c[-1, ::nan_every] = np.nan
    e = rng.standard_normal((R, C)) * scale * 0.1 if feedback else None
    us, ur = rng.random((R, C)), rng.random((R, C))
    cj = jnp.asarray(c).astype(jdt)
    ej = None if e is None else jnp.asarray(e).astype(jdt)
    ct = tensor_from_numpy(np.asarray(cj), "cpu")
    et = None if ej is None else tensor_from_numpy(np.asarray(ej), "cpu")
    return ((cj, ej, jnp.asarray(us), jnp.asarray(ur)),
            (ct, et, torch.tensor(us), torch.tensor(ur)))


# ------------------------------------------------ the transform gate
#: strategy configurations of the transform gate: name -> make(F, wire)
#: for F the JAX package's `repro.fed` or the port's `repro_torch.fed`
STRATEGIES = {
    "cgt_topk": lambda F, w: F.CompressedGT(compression_ratio=0.25,
                                            wire_transport=w),
    "cgt_topk_noef": lambda F, w: F.CompressedGT(
        compression_ratio=0.3, error_feedback=False, wire_transport=w),
    "cgt_randk": lambda F, w: F.CompressedGT(
        compression_ratio=0.25, mode="randk", seed=3, wire_transport=w),
    "qgt8": lambda F, w: F.QuantizedGT(bits=8, wire_transport=w),
    "qgt2_half": lambda F, w: F.QuantizedGT(bits=2, ratio=0.5, seed=1,
                                            wire_transport=w),
    "qgt4_randk": lambda F, w: F.QuantizedGT(
        bits=4, ratio=0.25, mode="randk", error_feedback=False,
        wire_transport=w),
    "qgt16_topk": lambda F, w: F.QuantizedGT(bits=16, ratio=0.1, seed=9,
                                             wire_transport=w),
}


def _corrections(rng, m, dt):
    """A correction pytree with an unsorted dict (JAX numbers leaves in
    sorted-key order), a matrix leaf (several quantization groups) and a
    vector; bf16 / fp8 corrections as the engine's correction_dtype gives."""
    jdt, _ = DT[dt]
    scale = 1.0 if dt != "fp8" else 0.25
    cx = {"w": rng.standard_normal((m, 4, 32)) * scale,
          "b": rng.standard_normal((m, 37)) * scale}
    cy = rng.standard_normal((m, 6)) * scale
    jx = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), cx)
    jy = jnp.asarray(cy).astype(jdt)
    return (jx, jy), (tree_from_numpy(jax.tree.map(np.asarray, jx), "cpu"),
                      tensor_from_numpy(np.asarray(jy), "cpu"))


def _dense(t):
    return t.decode() if hasattr(t, "decode") else t


def _assert_trees(want, got, tag):
    wl, gl = jax.tree.leaves(want), tree_flatten(got)[0]
    assert len(wl) == len(gl), tag
    for i, (w, g) in enumerate(zip(wl, gl)):
        assert_same(w, g, f"{tag} leaf {i}")


def check_transform(jfed, fed, name, wire, dt):
    """Same cx, cy and state in; the same bits of every output and of the
    new state out (feedback buffers, RNG key), round after round, for the
    JAX package's strategy `name` (module `jfed`) and the port's (`fed`).
    JAX runs eagerly, one XLA op at a time, as its oracle is written."""
    js, ts = STRATEGIES[name](jfed, wire), STRATEGIES[name](fed, wire)
    rng = np.random.default_rng(seed_of(name, dt))
    m = 3
    (jx, jy), _ = _corrections(rng, m, dt)
    jstate = js.init_state(jax.tree.map(lambda u: u[0], jx), jy[0], m)
    tstate = strategy_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for rnd in range(3):
        (jx, jy), (tx, ty) = _corrections(rng, m, dt)
        want = js.transform_correction(jx, jy, jstate)
        got = ts.transform_correction(tx, ty, tstate)
        if wire:
            assert isinstance(got[0], fed.PackedTree)
            assert got[0].wire_bytes() == want[0].wire_bytes()
            assert got[1].wire_bytes() == want[1].wire_bytes()
        _assert_trees(_dense(want[0]), _dense(got[0]), f"round {rnd} cx")
        _assert_trees(_dense(want[1]), _dense(got[1]), f"round {rnd} cy")
        assert set(want[2]) == set(got[2])
        for key in want[2]:
            if key == "key":
                np.testing.assert_array_equal(
                    np.asarray(want[2][key]).astype(np.int64), got[2][key].numpy())
            else:
                _assert_trees(want[2][key], got[2][key], f"round {rnd} {key}")
        jstate, tstate = want[2], got[2]


# ---------------------------------------------- the wire payload oracles
def check_pack_and_decode(dt, encoding, bits):
    """pack_payload_ref and decode_payload_ref of the port against JAX's on
    the same leaves: both shapes, both modes, k from 1 to C."""
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(seed_of(dt, encoding, bits))
    for (R, C), mode in itertools.product(SHAPES, ["topk", "randk"]):
        jx, tx = make_leaf(rng, R, C, dt, True)
        for j, k in enumerate([C // 4, C] if C > 64 else [1, C // 4, C]):
            # both index widths, alternating over the k values
            jidx, tidx = [(jnp.int32, torch.int32), (jnp.uint16, torch.uint16)][
                (j + len(mode)) % 2]
            kw = dict(k=k, bits=bits, mode=mode, encoding=encoding)
            want = jref.pack_payload_ref(*jx, index_dtype=jidx, **kw)
            got = ref.pack_payload_ref(*tx, index_dtype=tidx, **kw)
            for w, g, name in zip(want, got, ("data", "idx", "scale", "resid")):
                assert_same(w, g, f"{name} {mode} {R}x{C} k={k}")
            dk = dict(cols=C, k=k, bits=bits, encoding=encoding)
            assert_same(jref.decode_payload_ref(*want[:3], dtype=jdt, **dk),
                        ref.decode_payload_ref(*got[:3], dtype=tdt, **dk),
                        f"decode {mode} {R}x{C} k={k}")




# ------------------------------------------------ rounds against JAX
#: per-round gap tolerance against JAX's stored trajectory, relative, on
#: rounds whose gap is above GAP_FLOOR: the two engines sum the matvecs in
#: different orders, so the iterates differ by f64 round-off, which the
#: contraction keeps at that level (measured: below 1e-9 on the CPU)
GAP_RTOL = 1e-5
GAP_FLOOR = 1e-14


def parting_round(got, want, rtol=GAP_RTOL):
    """The first round where the port's gap leaves JAX's by more than rtol
    (on rounds with gap > GAP_FLOOR), or None."""
    want = np.asarray(want)[: len(got)]
    rel = np.abs(got - want) / np.where(want > GAP_FLOOR, want, 1.0)
    bad = np.nonzero((want > GAP_FLOOR) & (rel > rtol))[0]
    return int(bad[0]) if bad.size else None


def assert_gaps_follow_jax(got, want, tag=""):
    """Per-round gaps within GAP_RTOL of JAX's.  Where they part, the
    message names the round (a flipped top-k or rounding decision at a
    near-tie would show as such a parting; the transform gate of
    `test_torch_transform*.py` holds the choices themselves)."""
    r = parting_round(got, want)
    assert r is None, (
        f"{tag}: the port's gap parts from JAX's at round {r}: "
        f"{got[r]!r} vs {np.asarray(want)[r]!r}")


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's small problems are bound by per-op host overhead; extra
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the comparisons' own tests
def test_assert_same_is_bitwise_but_for_nan_payloads():
    a = np.array([1.0, -0.0, np.nan], np.float32)
    assert_same(jnp.asarray(a), torch.tensor(a))
    # another NaN payload is still NaN
    b = torch.tensor(a).view(torch.int32).clone()
    b[2] = 0x7FC00001
    assert_same(jnp.asarray(a), b.view(torch.float32))
    for bad in ([1.0, 0.0, np.nan], [1.0, -0.0, 1.0]):  # -0.0 vs +0.0; NaN vs 1
        with pytest.raises(AssertionError):
            assert_same(jnp.asarray(a), torch.tensor(bad, dtype=torch.float32))
    lv = np.array([1, 2 ** 32 - 1], np.uint32)
    assert_same(jnp.asarray(lv), torch.tensor(lv.astype(np.int64)).to(torch.uint32))


def test_parting_round_names_the_first_round_off_tolerance():
    want = np.array([1.0, 1e-3, 1e-15, 2.0])
    assert parting_round(want.copy(), want) is None
    got = want.copy()
    got[2] = 5e-15  # below GAP_FLOOR: not compared
    assert parting_round(got, want) is None
    got[3] = 2.0 * (1 + 2 * GAP_RTOL)
    assert parting_round(got, want) == 3
    with pytest.raises(AssertionError, match="round 3"):
        assert_gaps_follow_jax(got, want, "run")
