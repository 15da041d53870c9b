"""The port's `gt_update` against the JAX package's.

On the CPU the wrapper runs its plain version (`repro_torch.kernels.ref.
gt_update_ref`); these tests hold it against the Pallas kernel in
interpret mode and the JAX oracle on the same numpy inputs:

  * f32 / bf16 leaves, c in f32 / bf16 / fp8 e4m3: within 1 ulp of the
    output type at the operands' scale (max |z|, |eta (g + c)|, |out|).
    Both compute in f32, but XLA contracts the Pallas body's multiply-add
    into an FMA and torch rounds each operation, so they differ by at
    most one rounding of the sum (max 2.4e-7 in f32 on N(0, 1) data).
  * f64: bit for bit equal to `ref.gt_update_ref` (the Pallas body
    downcasts f64 to f32; the port computes in f64).

`gt_update_many` (every leaf of a tree in one launch a (z, c) dtype
pair) and `make_gt_update_fn().pair` (x and y together) run the same
plain version per leaf on the CPU: bitwise `ref.gt_update_ref` leaf by
leaf, and within the same ulp of JAX's interpret-mode kernel.  The
launch planner (`plan_launches`) is pure Python; its tests walk the
kernel's unit map (`csrc/gt_update.cu`) over the planned tables and
check that every element of every leaf is covered once, by a 16-byte
access only where the leaf's pointers are aligned.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py
holds it against the plain version there (bit for bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gt_update_2d, make_gt_update_fn as jax_make_update
from repro.kernels import ref as jax_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import default_update
from repro_torch.kernels import gt_update, gt_update_many, make_gt_update_fn, ref
from repro_torch.kernels.gt_update import THREADS, VEC_BYTES, plan_launches

pytestmark = pytest.mark.torch

ETA = 3e-3
JDT = {
    "f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16,
    "fp8": jnp.float8_e4m3fn,
}
TDT = {
    "f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}
NARROW_PAIRS = [
    ("f32", "f32"), ("f32", "bf16"), ("f32", "fp8"),
    ("bf16", "bf16"), ("bf16", "fp8"),
]


def _inputs(shape, zdt, cdt, seed=0):
    """Seeded numpy draws cast by JAX; the torch side gets the same bits
    through `convert.tensor_from_numpy`."""
    rng = np.random.default_rng(seed)
    z, g, c = (rng.standard_normal(shape) for _ in range(3))
    jz = jnp.asarray(z).astype(JDT[zdt])
    jg = jnp.asarray(g).astype(JDT[zdt])
    jc = jnp.asarray(c).astype(JDT[cdt])
    tz, tg, tc = (tensor_from_numpy(np.asarray(a), "cpu") for a in (jz, jg, jc))
    return (jz, jg, jc), (tz, tg, tc)


def _as_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _assert_within_one_ulp(got, want, dtype: str, z, g, c):
    """|got - want| <= 1 ulp of `dtype` at the scale of the operands: an
    FMA and a separately rounded multiply-add differ by one rounding of
    the sum, which cancellation can make large against a tiny result."""
    g64, w = _as_f64(got), _as_f64(want)
    scale = np.maximum.reduce([
        np.abs(_as_f64(z)), ETA * (np.abs(_as_f64(g)) + np.abs(_as_f64(c))),
        np.abs(g64), np.abs(w),
    ])
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    if dtype == "bf16":
        ulp *= 2.0 ** 16  # 8 significant bits instead of f32's 24
    err = np.abs(g64 - w)
    assert np.all(err <= ulp), (dtype, float(np.max(err / ulp)))


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("shape", [(8, 128), (256, 384)])
    @pytest.mark.parametrize("pair", NARROW_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_within_one_ulp_of_the_interpret_kernel(self, shape, pair, sign):
        zdt, cdt = pair
        (jz, jg, jc), (tz, tg, tc) = _inputs(shape, zdt, cdt)
        want = gt_update_2d(
            jz, jg, jc, eta=ETA, sign=sign, block_rows=min(128, shape[0]),
            interpret=True,
        )
        got = gt_update(tz, tg, tc, eta=ETA, sign=sign)
        assert got.dtype == TDT[zdt] and tuple(got.shape) == shape
        _assert_within_one_ulp(got, want, zdt, tz, tg, tc)

    @pytest.mark.parametrize("cdt", ["f64", "f32", "bf16", "fp8"])
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_f64_bitwise_equals_the_jax_oracle(self, cdt, sign):
        (jz, jg, jc), (tz, tg, tc) = _inputs((33, 70), "f64", cdt, seed=1)
        want = np.asarray(jax_ref.gt_update_ref(jz, jg, jc, ETA, sign))
        got = gt_update(tz, tg, tc, eta=ETA, sign=sign)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want)

    def test_f64_keeps_precision_the_pallas_body_drops(self):
        """The Pallas body computes f64 leaves in f32 (~1e-7 off the
        oracle); the port's f64 path is exact to the oracle."""
        (jz, jg, jc), (tz, tg, tc) = _inputs((8, 128), "f64", "f64", seed=2)
        want = np.asarray(jax_ref.gt_update_ref(jz, jg, jc, ETA, -1.0))
        pallas = np.asarray(
            gt_update_2d(jz, jg, jc, eta=ETA, sign=-1.0, interpret=True)
        )
        got = gt_update(tz, tg, tc, eta=ETA, sign=-1.0).numpy()
        assert np.max(np.abs(pallas - want)) > 1e-9
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("pair", NARROW_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
    def test_ragged_pytree_leaves_within_one_ulp(self, pair):
        """The JAX wrapper pads leaves to [rows, 128]; the port takes any
        shape.  Same values on ragged leaves (c is cast up by the JAX
        wrapper and read in its stored type by the port: both exact)."""
        zdt, cdt = pair
        shapes = [(17,), (3, 5), (130, 7)]
        leaves = [_inputs(s, zdt, cdt, seed=10 + i) for i, s in enumerate(shapes)]
        jtrees = [{f"l{i}": lv[0][j] for i, lv in enumerate(leaves)} for j in range(3)]
        ttrees = [{f"l{i}": lv[1][j] for i, lv in enumerate(leaves)} for j in range(3)]
        want = jax_make_update(interpret=True, use_kernel=True)(*jtrees, ETA, 1.0)
        got = make_gt_update_fn()(*ttrees, ETA, 1.0)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            _assert_within_one_ulp(
                got[k], want[k], zdt, ttrees[0][k], ttrees[1][k], ttrees[2][k]
            )


class TestWrapper:
    @pytest.mark.parametrize("zdt", ["f64", "f32"])
    @pytest.mark.parametrize("sign", [-1.0, 1.0])
    def test_bitwise_equals_default_update_on_wide_leaves(self, zdt, sign):
        """The kernel-backed update_fn is exactly the engine's plain
        default_update on f64 and f32 leaves."""
        _, (tz, tg, tc) = _inputs((6, 31), zdt, zdt, seed=3)
        got = make_gt_update_fn()({"a": tz}, {"a": tg}, {"a": tc}, ETA, sign)
        want = default_update({"a": tz}, {"a": tg}, {"a": tc}, ETA, sign)
        assert torch.equal(got["a"], want["a"])

    def test_rejects_what_the_kernel_does_not_take(self):
        z = torch.zeros(4, 8, dtype=torch.float32)
        with pytest.raises(ValueError, match="shapes"):
            gt_update(z, z, torch.zeros(4, 7), eta=ETA, sign=1.0)
        with pytest.raises(TypeError, match="unsupported dtypes"):
            gt_update(z, z.double(), z, eta=ETA, sign=1.0)
        with pytest.raises(TypeError, match="unsupported dtypes"):
            bf = z.to(torch.bfloat16)
            gt_update(bf, bf, z, eta=ETA, sign=1.0)
        with pytest.raises(ValueError, match="contiguous"):
            zt = torch.zeros(8, 4).t()
            gt_update(zt, zt, zt, eta=ETA, sign=1.0)

    def test_plain_path_launches_no_kernel(self):
        gt_update.launches = 0
        z = torch.ones(5, dtype=torch.float64)
        gt_update(z, z, z, eta=ETA, sign=-1.0)
        assert gt_update.launches == 0

    def test_plain_version_dtype_rules(self):
        assert ref.compute_dtype(torch.float64) == torch.float64
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            assert ref.compute_dtype(dt) == torch.float32


# ------------------------------------------------- gt_update_many, pair
SIZE = {"f64": 8, "f32": 4, "bf16": 2, "fp8": 1}


class TestMany:
    @pytest.mark.parametrize("pair", [("f64", "f64"), ("f64", "fp8")] + NARROW_PAIRS,
                             ids=lambda p: f"{p[0]}-{p[1]}")
    def test_many_bitwise_equals_per_leaf_plain_and_near_jax(self, pair):
        """Ragged leaves with their own scales, an empty one among them:
        each output is `gt_update_ref` of its leaf bit for bit, and within
        the ulp rule of JAX's interpret-mode kernel (f64: JAX's oracle)."""
        zdt, cdt = pair
        shapes = [(17,), (3, 5), (0,), (130, 7), (1,)]
        leaves = [_inputs(sh, zdt, cdt, seed=40 + i) for i, sh in enumerate(shapes)]
        scales = [(-1.0) ** i * ETA * (1 + i) for i in range(len(shapes))]
        got = gt_update_many([lv[1][0] for lv in leaves], [lv[1][1] for lv in leaves],
                             [lv[1][2] for lv in leaves], scales)
        for (jx, (tz, tg, tc)), s, out in zip(leaves, scales, got):
            assert out.dtype == tz.dtype and out.shape == tz.shape
            assert torch.equal(out, ref.gt_update_ref(tz, tg, tc, s, 1.0))
            if tz.numel() == 0:
                continue
            if zdt == "f64":
                want = np.asarray(jax_ref.gt_update_ref(*jx, abs(s), np.sign(s)))
                assert np.array_equal(out.numpy(), want)
            else:
                jz, jg, jc = ({"a": a} for a in jx)
                want = jax_make_update(interpret=True, use_kernel=True)(
                    jz, jg, jc, abs(s), float(np.sign(s)))["a"]
                _assert_within_one_ulp(out, want, zdt, tz, tg, tc)

    def test_pair_bitwise_equals_two_default_updates(self):
        """`pair` on trees of f64 leaves: x descends with eta_x, y ascends
        with eta_y, both bitwise the engine's plain `default_update`."""
        rng = np.random.default_rng(7)
        mk = lambda *sh: torch.tensor(rng.standard_normal(sh))
        xs, ys = {"w": mk(4, 9), "b": mk(4, 3)}, [mk(4, 11)]
        gx, gy = {k: mk(*v.shape) for k, v in xs.items()}, [mk(4, 11)]
        cx, cy = {k: mk(*v.shape) for k, v in xs.items()}, [mk(4, 11)]
        x1, y1 = make_gt_update_fn().pair(xs, gx, cx, 2e-3, ys, gy, cy, 5e-3)
        wx = default_update(xs, gx, cx, 2e-3, -1.0)
        wy = default_update(ys, gy, cy, 5e-3, 1.0)
        assert all(torch.equal(x1[k], wx[k]) for k in xs)
        assert torch.equal(y1[0], wy[0])

    def test_pair_equals_jax_update_of_each_side(self):
        """`pair` against JAX's `make_gt_update_fn` (interpret mode) on each
        side: f32 leaves within one ulp, as the single-tree update."""
        leaves = [_inputs(sh, "f32", "bf16", seed=60 + i)
                  for i, sh in enumerate([(5, 40), (3,), (2, 2, 9)])]
        jt = [{f"l{i}": lv[0][j] for i, lv in enumerate(leaves)} for j in range(3)]
        tt = [{f"l{i}": lv[1][j] for i, lv in enumerate(leaves)} for j in range(3)]
        x1, y1 = make_gt_update_fn().pair(*tt, ETA, *tt, 2 * ETA)
        jax_update = jax_make_update(interpret=True, use_kernel=True)
        for got, (eta, sign) in ((x1, (ETA, -1.0)), (y1, (2 * ETA, 1.0))):
            want = jax_update(*jt, eta, sign)
            for k in want:
                _assert_within_one_ulp(got[k], want[k], "f32", tt[0][k], tt[1][k],
                                       tt[2][k])

    def test_many_checks_every_leaf_and_counts_nothing_on_the_cpu(self):
        z = torch.zeros(4, 8)
        with pytest.raises(ValueError, match="shapes"):
            gt_update_many([z, z], [z, z], [z, torch.zeros(4, 7)], [ETA, ETA])
        with pytest.raises(ValueError, match="scales"):
            gt_update_many([z], [z], [z], [ETA, ETA])
        gt_update.launches = gt_update.leaf_updates = 0
        gt_update_many([z, z.double()], [z, z.double()], [z, z.double()], [ETA, ETA])
        make_gt_update_fn().pair(z, z, z, ETA, z, z, z, ETA)
        assert (gt_update.launches, gt_update.leaf_updates) == (0, 0)


# ------------------------------------------------------- the launch plan
def _walk(rec, z_size):
    """The elements the kernel's threads touch for one table entry, as
    csrc/gt_update.cu's unit map gives them: [(element, vector?)]."""
    z, g, c, out, n, s, blocks, vec = rec
    v = VEC_BYTES // z_size
    nvec = n // v if vec else 0
    units = nvec + (n - nvec * v)
    stride = blocks * THREADS
    seen = []
    for start in range(stride):  # every thread of the leaf's blocks
        for u in range(start, units, stride):
            if u < nvec:
                seen += [(u * v + j, True) for j in range(v)]
            else:
                seen.append((nvec * v + (u - nvec), False))
    return seen


class TestPlan:
    def test_every_element_once_vectors_only_where_aligned(self):
        """Leaves of every (z, c) size pair, aligned and misaligned, of
        ragged lengths, some longer than `max_blocks` x THREADS units (the
        grid-stride case): every element is touched once, by a vector only
        where z, g, out sit on 16 bytes and c on its V values."""
        leaves, base = [], 1 << 20
        cases = [("f64", "f64"), ("f64", "fp8"), ("f32", "bf16"), ("bf16", "fp8"),
                 ("bf16", "bf16"), ("f32", "f32")]
        for i, (zdt, cdt) in enumerate(cases):
            for n, shift in ((1, 0), (13, 0), (4099, 0), (4099, 1), (9000, 0)):
                zs, cs = SIZE[zdt], SIZE[cdt]
                z = base + shift * zs
                leaves.append(((0, zdt, cdt), z, z + (1 << 16), base + (2 << 16) + shift * cs,
                               z + (3 << 16), n, zs, cs, 1.0 + i))
                base += 1 << 18
        plan = plan_launches(leaves, max_blocks=4)
        entries = [(key, rec) for key, recs in plan for rec in recs]
        assert len(entries) == len(leaves)
        for (key, rec), leaf in zip(sorted(entries, key=lambda e: e[1][0]),
                                    sorted(leaves, key=lambda l: l[1])):
            zs, cs = SIZE[key[1]], SIZE[key[2]]
            aligned = leaf[1] % 16 == 0 and leaf[3] % (16 // zs * cs) == 0
            assert rec[7] == int(aligned) and rec[5] == leaf[8]
            assert 1 <= rec[6] <= 4
            seen = _walk(rec, zs)
            assert sorted(e for e, _ in seen) == list(range(rec[4]))
            assert any(vec for _, vec in seen) == (aligned and rec[4] >= 16 // zs)

    def test_groups_by_pair_in_first_appearance_and_cuts_tables(self):
        """Leaves grouped by (device, z, c) in the order their first leaf
        comes, each group cut into tables of `cap`; empty leaves dropped;
        each leaf keeps its own scale."""
        keys = [(0, "f32", "f32"), (0, "f64", "f64"), (1, "f32", "f32")]
        leaves = []
        for i in range(23):
            key = keys[i % 3] if i < 21 else keys[0]
            n = 0 if i == 4 else 100 + i
            leaves.append((key, 16 * i, 16 * i, 16 * i, 16 * i, n, 4, 4, float(i)))
        plan = plan_launches(leaves, max_blocks=100, cap=3)
        assert [k for k, _ in plan] == [keys[0]] * 3 + [keys[1]] * 2 + [keys[2]] * 3
        assert [len(r) for _, r in plan] == [3, 3, 3, 3, 3, 3, 3, 1]
        scales = [rec[5] for _, recs in plan for rec in recs]
        assert sorted(scales) == [float(i) for i in range(23) if i != 4]
        assert [rec[5] for rec in plan[0][1]] == [0.0, 3.0, 6.0]
        assert plan_launches([(keys[0], 0, 0, 0, 0, 0, 4, 4, 1.0)], 8) == []

    def test_blocks_cover_the_units_up_to_the_wave(self):
        """One block per THREADS units, at most `max_blocks`."""
        for n, blocks in ((1, 1), (4 * THREADS, 1), (4 * THREADS + 1, 2),
                          (10 ** 7, 7)):
            (_, (rec,)), = plan_launches([((0, "f32", "f32"), 0, 0, 0, 0, n, 4, 4, 1.0)],
                                         max_blocks=7)
            assert rec[6] == blocks and rec[7] == 1
