"""The unpack table of the port (`repro_torch.kernels.pack_payload.
unpack_payload_many`) and the exchange decodes built on it, on the CPU:

  * the launch planner (`plan_unpack`, `unpack_tile`), pure Python: leaves
    grouped by (device, dtype) in the order their first leaf comes, each
    group cut into tables of at most the cap, leaves without rows dropped;
    the kernel's walk of a table (a binary search of the block prefix,
    then row and tile, `csrc/unpack_payload.cu`) covers every (row,
    column) of every leaf once; null indices and scales go in as 0, out
    rows (pointer and row stride) as given;
  * the wrapper on CPU tensors: the plain version leaf by leaf, null
    indices and scale equal to the materialized ones, out views at an
    odd offset and row stride, no launch counted;
  * the exchange: `transport.decode_corrections`, `PackedTree.decode`,
    `decode_payloads` into out rows and the multi-host server's stacked
    decode (`launch.multihost.MultiHostRunner` on devices=["cpu"] * 4)
    equal per-leaf decoding and JAX's `repro.fed.transport.decode_leaf`
    on the same numpy-made payloads, bit for bit: every encoding in f64
    and fp8 (every dtype against the plain version above), unique
    indices in shuffled order, an index past the row.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against the plain version there, bit for bit.
"""
import bisect
import collections
import itertools
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import transport as jtransport
from repro_torch import fed
from repro_torch.convert import tensor_from_numpy
from repro_torch.fed import transport
from repro_torch.kernels import ref, unpack_payload_2d
from repro_torch.kernels.compress_correction import quant_constants
from repro_torch.kernels.pack_payload import (
    _UNPACK_LEAF,
    ENCODING_CODES,
    MIN_TILE_BYTES,
    TABLE_CAP,
    TILE_BYTES,
    VEC_BYTES,
    UnpackSpec,
    plan_unpack,
    unpack_payload_many,
    unpack_tile,
)
from repro_torch.launch import multihost as mh
from repro_torch.problems import make_quadratic_problem
from test_torch_parity import DT, ENCODINGS, assert_same

pytestmark = pytest.mark.torch

SIZE = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2, torch.float8_e4m3fn: 1}


def H100(key):
    """The SM count of every key's device: an H100's 132."""
    return 132


# ----------------------------------------------------------------- planner
def _leaf(key, rows, cols, *, ptr=1 << 20, idx=1 << 21, scale=1 << 22, out=1 << 23,
          stride=None, k=None, bits=8, enc="quant", u16=1, words=3):
    """One `plan_unpack` leaf tuple (pointers are opaque ints here)."""
    return (key, ptr, idx, scale, out, cols if stride is None else stride, rows, cols,
            cols if k is None else k, bits, enc, u16, words, SIZE[key[1]])


def _walk(recs):
    """(leaf, row, column) -> how many blocks of one table write it, as the
    kernel maps a block: the first leaf whose block prefix exceeds it,
    then row = local // tiles and the tile's columns."""
    ends = list(itertools.accumulate(r[16] for r in recs))
    seen = collections.Counter()
    for b in range(ends[-1]):
        i = bisect.bisect_right(ends, b)
        rec = recs[i]
        local = b - (ends[i - 1] if i else 0)
        row, tile = divmod(local, rec[15])
        c0 = tile * rec[14]
        for col in range(c0, min(c0 + rec[14], rec[8])):
            seen[(i, row, col)] += 1
    return seen


class TestPlanner:
    def test_record_is_the_kernels_96_byte_leaf(self):
        assert struct.calcsize("<" + _UNPACK_LEAF) == 96

    @pytest.mark.parametrize("rows,cols,itemsize,sms,want", [
        (16, 4096, 8, 132, 512),     # the main payload: 128 blocks, one wave
        (16384, 4096, 4, 132, 4096),  # the large payload: a row a block
        (16, 4096, 2, 132, 512),
        (2, 37, 4, 132, 37),          # shorter than the least tile: whole
        (1, 40000, 4, 132, 304),
        (1, 4096, 8, 132, 64),        # the least tile: MIN_TILE_BYTES
        (3, 60000, 1, 132, 1376),
        (8, 4097, 8, 132, 258),
    ])
    def test_tile_fills_the_sms_within_its_bounds(self, rows, cols, itemsize, sms, want):
        tile = unpack_tile(rows, cols, itemsize, sms)
        assert tile == want
        assert tile * itemsize <= TILE_BYTES
        v = VEC_BYTES // itemsize
        assert tile == cols or (tile % v == 0 and tile * itemsize >= MIN_TILE_BYTES)
        if tile < cols and MIN_TILE_BYTES < tile * itemsize < TILE_BYTES:
            # neither bound binds: about one wave of blocks
            assert sms - rows < rows * -(-cols // tile) <= sms + rows

    def test_groups_by_device_and_dtype_and_cuts_tables(self):
        keys = [(0, torch.float64), (0, torch.float32), (1, torch.float64)]
        leaves = []
        for i in range(23):
            key = keys[i % 3] if i < 21 else keys[0]
            leaves.append(_leaf(key, 0 if i == 4 else 2, 10 + i, ptr=16 * i))
        plan = plan_unpack(leaves, sms=H100, cap=3)
        assert [k for k, _ in plan] == [keys[0]] * 3 + [keys[1]] * 2 + [keys[2]] * 3
        assert [len(r) for _, r in plan] == [3, 3, 3, 3, 3, 3, 3, 1]
        assert [r[0] for r in plan[0][1]] == [0, 48, 96]
        assert sorted(r[0] for _, recs in plan for r in recs) == \
            [16 * i for i in range(23) if i != 4]
        assert plan_unpack([_leaf(keys[0], 0, 8)], sms=H100) == []

    def test_tiles_are_sized_by_each_devices_sm_count(self):
        """One call over two cards of different SM counts: each group's
        tiles fill its own card."""
        leaves = [_leaf((0, torch.float64), 16, 4096), _leaf((1, torch.float64), 16, 4096)]
        plan = plan_unpack(leaves, sms=lambda key: {0: 132, 1: 66}[key[0]])
        assert [(key[0], recs[0][14:17]) for key, recs in plan] == \
            [(0, (512, 8, 128)), (1, (1024, 4, 64))]

    def test_more_leaves_than_a_table(self):
        leaves = [_leaf((0, torch.float32), 1, 5, ptr=i) for i in range(2 * TABLE_CAP + 88)]
        plan = plan_unpack(leaves, sms=H100)
        assert [len(r) for _, r in plan] == [TABLE_CAP, TABLE_CAP, 88]
        assert [r[0] for _, recs in plan for r in recs] == list(range(len(leaves)))

    def test_blocks_cover_every_value_once(self):
        """Mixed encodings, specs, row counts and tiles in one table: the
        kernel's walk of its block prefix writes each value once."""
        key = (0, torch.float64)
        leaves = [_leaf(key, 16, 4096, enc="quant", k=1024),
                  _leaf(key, 3, 1000, enc="sparse", k=250, bits=32, words=0),
                  _leaf(key, 2, 37, enc="dense", bits=32, words=0),
                  _leaf(key, 5, 4097, enc="quant_dense", k=410, bits=4),
                  _leaf(key, 1, 9000, enc="quant", k=9000, idx=0)]
        (_, recs), = plan_unpack(leaves, sms=H100)
        seen = _walk(recs)
        want = {(i, r, c) for i, l in enumerate(leaves) for r in range(l[6])
                for c in range(l[7])}
        assert set(seen) == want and set(seen.values()) == {1}
        for rec, leaf in zip(recs, leaves):
            tile, tiles, blocks = rec[14:17]
            assert tiles == -(-leaf[7] // tile) and blocks == leaf[6] * tiles
            assert tile == unpack_tile(leaf[6], leaf[7], 8, 132)

    def test_fields_null_flags_and_out_rows(self):
        """The record carries each leaf's pointers (0 for a null idx or
        scale), out's row stride, the spec, s and 1/s and the encoding's
        code, in the kernel's field order."""
        leaves = [_leaf((0, torch.bfloat16), 4, 100, idx=0, scale=0, out=4096 + 2,
                        stride=131, k=100, bits=32, enc="sparse", u16=0, words=0),
                  _leaf((0, torch.bfloat16), 4, 100, out=8192, stride=100, k=25,
                        bits=4, enc="quant", words=4)]
        (_, (a, b)), = plan_unpack(leaves, sms=H100)
        assert a[:5] == (1 << 20, 0, 0, 4096 + 2, 131)
        assert a[5:7] == quant_constants(32) == (0.0, 0.0)
        assert a[7:14] == (4, 100, 100, 32, ENCODING_CODES["sparse"], 0, 0)
        assert b[1:5] == (1 << 21, 1 << 22, 8192, 100)
        assert b[5:7] == quant_constants(4) and b[10:14] == (4, 0, 1, 4)


# ----------------------------------------------------- the wrapper on the CPU
def _np_payload(rng, R, C, k, bits, enc, dt):
    """(data, idx, scale) numpy arrays of one packed [R, C] leaf: random
    words, or values cast through JAX to the leaf's dtype; unique indices
    in shuffled order with the last row's last slot past the row (dropped,
    as a NaN row's padding is); per-row scales with a zero row.  idx is
    None where the wire carries none (k == C, or no indices), scale where
    the encoding has none."""
    jdt = DT[dt][0]
    if enc in ("quant", "quant_dense"):
        words = ref.word_layout(C if enc == "quant_dense" else k, bits)[2]
        data = rng.integers(0, 2 ** 32, (R, words), dtype=np.uint64).astype(np.uint32)
    else:
        vals = rng.standard_normal((R, k if enc == "sparse" else C)) * 50
        data = np.asarray(jnp.asarray(vals).astype(jdt))
    idx = None
    if k < C and enc in ("quant", "sparse"):
        idx = np.stack([rng.permutation(C)[:k] for _ in range(R)])
        idx[-1, -1] = C
        idx = idx.astype(np.uint16 if C <= 2 ** 16 else np.int32)
    scale = None
    if enc in ("quant", "quant_dense"):
        scale = rng.random((R, 1)) * 10
        scale[0] = 0.0
        scale = scale.astype(np.float64 if dt == "f64" else np.float32)
    return data, idx, scale


def _tensors(arrays):
    return tuple(None if a is None else tensor_from_numpy(a, "cpu") for a in arrays)


#: (rows, cols, k, bits, encoding) of the leaves of one tree
TREE = [(4, 37, 10, 8, "quant"), (4, 37, 37, 4, "quant"), (4, 37, 10, 2, "quant_dense"),
        (4, 37, 9, 32, "sparse"), (4, 37, 37, 32, "sparse"), (4, 37, 37, 32, "dense")]


def _plain(data, idx, scale, spec):
    R = data.shape[0]
    if idx is None:
        idx = torch.arange(spec.k, dtype=torch.int32).expand(R, spec.k)
    if scale is None:
        scale = torch.zeros((R, 1), dtype=ref.compute_dtype(spec.dtype))
    return ref.decode_payload_ref(data, idx, scale, cols=spec.cols, dtype=spec.dtype,
                                  k=spec.k, bits=spec.bits, encoding=spec.encoding)


@pytest.mark.parametrize("dt", list(DT))
def test_many_on_the_cpu_is_the_plain_version_leaf_by_leaf(dt):
    rng = np.random.default_rng(7)
    tdt = DT[dt][1]
    arrays = [_np_payload(rng, R, C, k, b, e, dt) for R, C, k, b, e in TREE]
    specs = [UnpackSpec(C, tdt, k, b, e) for _, C, k, b, e in TREE]
    leaves = [_tensors(a) for a in arrays]
    unpack_payload_2d.launches = unpack_payload_2d.leaf_decodes = 0
    got = unpack_payload_many(*zip(*leaves), specs)
    assert (unpack_payload_2d.launches, unpack_payload_2d.leaf_decodes) == (0, 0)
    for (data, idx, scale), spec, g in zip(leaves, specs, got):
        assert_same(_plain(data, idx, scale, spec), g, spec)
        # materialized iota / zero scale: the same bits
        R = data.shape[0]
        full_idx = idx if idx is not None else torch.arange(
            spec.k, dtype=torch.int32).expand(R, spec.k).contiguous()
        full_scale = scale if scale is not None else torch.zeros(
            (R, 1), dtype=ref.compute_dtype(tdt))
        assert_same(g, unpack_payload_2d(data, full_idx, full_scale, **spec._asdict()))
        # an out view one value past an aligned base, 3 values of padding
        buf = torch.zeros((R, spec.cols + 3), dtype=tdt)
        buf.view(torch.uint8).fill_(0x55)
        out = buf[:, 1:1 + spec.cols]
        res = unpack_payload_2d(data, idx, scale, out=out, **spec._asdict())
        assert res.data_ptr() == out.data_ptr()
        assert_same(g, out)
        assert bool((buf[:, :1].view(torch.uint8) == 0x55).all())
        assert bool((buf[:, 1 + spec.cols:].contiguous().view(torch.uint8) == 0x55).all())


def test_many_raises_on_what_it_does_not_take():
    data = torch.zeros((2, 1), dtype=torch.uint32)
    spec = UnpackSpec(4, torch.float32, 4, 8, "quant_dense")
    with pytest.raises(ValueError, match="out must be"):
        unpack_payload_many([data], [None], [None], [spec], [torch.zeros(2, 5)])
    with pytest.raises(ValueError, match="out must be"):
        unpack_payload_many([data], [None], [None], [spec], [torch.zeros(4, 2).t()])
    # rows that overlap: a row stride below the row's length
    with pytest.raises(ValueError, match="do not overlap"):
        unpack_payload_many([data], [None], [None], [spec],
                            [torch.zeros(8).as_strided((2, 4), (2, 1))])
    with pytest.raises(ValueError, match="2 idx"):
        unpack_payload_many([data], [None, None], [None], [spec])
    with pytest.raises(ValueError, match="unknown payload encoding"):
        unpack_payload_many([data], [None], [None], [spec._replace(encoding="zip")])


# ------------------------------------------------------------ the exchange
_TREES = {}


def _trees(dt, m=2, seed=0):
    """Port PackedTrees of numpy payloads and JAX's decodes of the same
    payloads: cx the leaves of TREE (each leaf's rows = m agents' rows),
    cy its first two.  Made once per (dtype, seed) in a module, so JAX
    compiles its decode once per leaf shape."""
    if (dt, m, seed) not in _TREES:
        _TREES[dt, m, seed] = _make_trees(dt, m, seed)
    return _TREES[dt, m, seed]


def _make_trees(dt, m, seed):
    rng = np.random.default_rng(seed)
    jdt, tdt = DT[dt]
    out = []
    for leaves in (TREE, TREE[:2]):
        arrays = [_np_payload(rng, R, C, k, b, e, dt) for R, C, k, b, e in leaves]
        tspecs = [transport.LeafSpec(R, C, k, b, "topk", tdt, e) for R, C, k, b, e in leaves]
        jspecs = [jtransport.LeafSpec(R, C, k, b, "topk", np.dtype(jdt), e)
                  for R, C, k, b, e in leaves]
        shapes = [(m, R // m, C) for R, C, *_ in leaves]
        names = [f"w{i}" for i in range(len(leaves))]
        unflatten = lambda ls, names=names: dict(zip(names, ls))
        tree = transport.PackedTree(
            [transport.LeafPayload(*_tensors(a)) for a in arrays], tspecs, unflatten, shapes)
        jdec = [np.asarray(jtransport.decode_leaf(
            jtransport.LeafPayload(*(None if a is None else jnp.asarray(a) for a in arr)),
            spec)).reshape(shape) for arr, spec, shape in zip(arrays, jspecs, shapes)]
        out.append((tree, dict(zip(names, jdec))))
    return out


@pytest.mark.parametrize("dt", ["f64", "fp8"])
def test_decode_corrections_equals_per_leaf_and_jax(dt):
    (cx, jx), (cy, jy) = _trees(dt)
    unpack_payload_2d.launches = 0
    dx, dy = transport.decode_corrections(cx, cy)
    assert unpack_payload_2d.launches == 0
    for tree, dense, want in ((cx, dx, jx), (cy, dy, jy)):
        per_leaf = [transport.decode_leaf(p, s).reshape(shape) for p, s, shape in
                    zip(tree.payloads, tree.specs, tree.shapes)]
        plain = [transport.decode_leaf(p, s, use_kernel=False).reshape(shape)
                 for p, s, shape in zip(tree.payloads, tree.specs, tree.shapes)]
        for name, a, b in zip(want, per_leaf, plain):
            assert_same(want[name], dense[name], f"{dt} {name}")
            assert_same(want[name], a, name)
            assert_same(want[name], b, name)
            assert_same(want[name], tree.decode()[name], name)
    # plain trees through the same call, and a dense tree passes through
    cx.use_kernel = cy.use_kernel = False
    px, py = transport.decode_corrections(cx, cy)
    for name in jx:
        assert_same(jx[name], px[name], name)
    dense = {"a": torch.ones(3)}
    got_x, got_y = transport.decode_corrections(dense, cy)
    assert got_x is dense and all(torch.equal(py[n], got_y[n]) for n in py)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_entry", "plain"])
def test_decode_payloads_into_stacked_out_rows(use_kernel):
    """Two shards' payloads of each leaf decoded into their rows of one
    stacked buffer, as the multi-host server does, equal JAX's decode of
    each shard's payload."""
    (a, ja), = _trees("f64", seed=0)[:1]
    (b, jb), = _trees("f64", seed=1)[:1]
    stacked = [torch.full((4,) + shape[1:], float("nan"), dtype=torch.float64)
               for shape in a.shapes]
    outs = [u[i * 2:(i + 1) * 2].view(s.rows, s.cols)
            for i, tree in enumerate((a, b)) for u, s in zip(stacked, tree.specs)]
    transport.decode_payloads(a.payloads + b.payloads, a.specs + b.specs,
                              use_kernel=use_kernel, outs=outs)
    for u, name in zip(stacked, ja):
        assert_same(np.concatenate([ja[name], jb[name]]), u, name)


def test_multihost_stacked_decode_equals_shards_and_jax():
    """The server's one decode of every shard's cx and cy into the stacked
    [m, d] outputs equals each shard's own decode and JAX's decode_leaf of
    the gathered payloads, bit for bit, over the wire encodings."""
    m, d = 8, 16
    prob = make_quadratic_problem(torch.Generator().manual_seed(0), dim=d,
                                  num_samples=40, num_agents=m, device="cpu")
    x0 = torch.ones(d, dtype=torch.float64)
    for strategy in (fed.QuantizedGT(bits=4, ratio=0.25, wire_transport=True),
                     fed.CompressedGT(compression_ratio=0.25, wire_transport=True)):
        runner = mh.MultiHostRunner(prob.loss, strategy, prob.agent_data, 3, 1e-3,
                                    devices=["cpu"] * 4)
        runner.run(x0, -x0, 1)
        cx, cy = runner.last_exchange["decoded"]
        own_x, own_y = runner.decode_on_shards()
        assert torch.equal(own_x, cx) and torch.equal(own_y, cy)
        for which, got in ((0, cx), (1, cy)):
            parts = []
            for enc in runner.last_exchange["encoded"]:
                (p,), (s,) = enc[which].payloads, enc[which].specs
                js = jtransport.LeafSpec(s.rows, s.cols, s.k, s.bits, s.mode,
                                         np.dtype(jnp.float64), s.encoding)
                jp = jtransport.LeafPayload(*(None if t is None else jnp.asarray(t.numpy())
                                              for t in p))
                parts.append(np.asarray(jtransport.decode_leaf(jp, js)))
            assert_same(np.concatenate(parts), got, repr(strategy))
