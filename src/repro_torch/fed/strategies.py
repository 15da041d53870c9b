"""Communication strategies for the round engine (port of
`repro/fed/strategies.py`: the base protocol plus FullSync, LocalOnly,
GradientTracking, client sampling (PartialParticipation), the
compressed-correction family CompressedGT / QuantizedGT and the
stochastic family SAGDA / LocalSGDAPlus).

A `CommStrategy` says WHAT the agents communicate each round and HOW
local drift is corrected; `core.engine.make_round` reads only these hooks:

  sync_every_step    aggregate after EVERY local step (centralized GDA)
  use_correction     add a gradient-tracking correction to local steps
  exact_correction   correction cancels exactly at the anchor point, so
                     the fused-k0 step applies (saves one grad eval)
  correction_dtype   optional reduced storage dtype for the correction
  stateful           round carries persistent cross-round state
  init_state(x,y,m)  build that state
  noise              optional `fed.noise.NoiseModel`: the anchor and local
                     gradients become seeded stochastic draws; None is
                     the deterministic round, op for op
  momentum           (LocalSGDAPlus) heavy-ball local steps
  sample_weights(state, m) -> (weights | None, state)
                     client-sampling weights, drawn on the host (the
                     engine moves them to the iterates' device)
  sample_noise_keys(state, m) -> (keys | None, state)
                     the round's [m, 2] per-agent keys from the dedicated
                     noise stream (`fed.noise`), folded by agent index
  transform_correction(cx, cy, state) -> (cx, cy, state)
                     cx / cy may come back as `transport.PackedTree` wire
                     payloads (objects with a `.decode()` hook) instead of
                     dense trees; the engine decodes before use
  sample_noise_keys_ids(state, ids) -> (keys | None, state)
                     the same, folding the given global agent ids (the
                     sparse layout's rows)
  rebase_state(state, active, prev_active) -> state
                     re-anchor membership-dependent state when an elastic
                     schedule changes the active set (`sim.elastic`)
  realign_state_rows(state, prev_ids, ids) -> state
                     the sparse layout's rebase: re-gather the per-agent
                     rows from the previous round's ids to this round's
  sharded_state_keys state entries with a leading per-agent axis
  bytes_per_round(x, y, K)  analytic star-topology payload per agent
                     (`transport.measured_bytes_per_round` measures the
                     packed buffers)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import prng
from ..core.engine import agent_where, fixed_size_mask, renormalized_weights
from ..core.types import Pytree, leaf_groups, tree_flatten, tree_leaves, tree_map
from ..device import host_to_device
from ..kernels.compress_correction import compress_leaf
from .noise import noise_key as _noise_stream_key
from .noise import resolve_noise
from .transport import LeafSpec, PackedTree, dense_payload_bytes, encode_leaf

Weights = Optional[torch.Tensor]
State = dict

_payload_bytes = dense_payload_bytes


def _compressed_payload_bytes(tree: Pytree, ratio: float, bits: int = 32,
                              value_dtype=None) -> int:
    """Bytes of a `ratio`-sparsified, `bits`-bit stochastically quantized
    copy of `tree` (bits >= 32: sparsification only), leaf by leaf at the
    cheapest encoding of `transport.LeafSpec`, the object that also shapes
    the encoder's buffers, so priced bytes equal packed buffer lengths.
    `value_dtype` overrides the leaf dtype: the correction exchange is
    priced at the strategy's `correction_dtype` when one is set."""
    return sum(
        LeafSpec.build(tuple(u.shape), value_dtype or u.dtype, ratio,
                       bits).wire_bytes()
        for u in tree_leaves(tree)
    )


@dataclasses.dataclass(frozen=True)
class CommStrategy:
    """Base strategy: hook defaults shared by all concrete strategies."""

    name = "base"
    sync_every_step = False
    use_correction = False
    correction_dtype: Any = None
    #: optional `fed.noise.NoiseModel`; None is the deterministic round
    noise: Any = None
    #: seed of the dedicated noise stream (`fed.noise.noise_key`, a fold of
    #: NOISE_STREAM, never the raw PRNGKey(seed) of the other chains)
    noise_seed: int = 0

    @property
    def exact_correction(self) -> bool:
        # gradient noise voids the anchor-point cancellation: the tracked
        # gbar and the first local step see different draws
        return self.noise is None

    @property
    def stateful(self) -> bool:
        return self.noise is not None

    def _noise_state(self) -> State:
        """The noise stream's state entry (empty when deterministic), which
        concrete strategies merge into their own `init_state`."""
        if self.noise is None:
            return {}
        return {"noise_key": _noise_stream_key(self.noise_seed)}

    def init_state(self, x: Pytree, y: Pytree, m: int) -> State:
        return self._noise_state()

    def sample_noise_keys(self, state: State, m: int):
        """Per-agent noise keys for ONE round ([m, 2], on the CPU): split
        the dedicated stream once, then fold each agent's index into the
        round subkey.  None when the strategy is deterministic."""
        if self.noise is None:
            return None, state
        state = dict(state)
        key, sub = prng.split(state["noise_key"])
        state["noise_key"] = key
        return prng.fold_in(sub, list(range(m))), state

    def sample_noise_keys_ids(self, state: State, ids):
        """`sample_noise_keys` for the sparse layout: the same one split of
        the stream a round, folding the given global agent ids (uint32
        words, as JAX folds them) instead of 0 .. m-1, so an agent draws
        the same keys whether its row sits at position `id` of an [m]
        stack or anywhere in an active subset."""
        if self.noise is None:
            return None, state
        state = dict(state)
        key, sub = prng.split(state["noise_key"])
        state["noise_key"] = key
        return prng.fold_in(sub, np.asarray(ids, np.int64)), state

    @property
    def sharded_state_keys(self) -> Tuple[str, ...]:
        """Top-level state entries whose leaves carry a leading per-agent
        axis (the rest, such as RNG keys, stay server-side)."""
        return ()

    def sample_weights(self, state: State, m: int) -> Tuple[Weights, State]:
        """None means exact uniform averaging over all m agents."""
        return None, state

    def transform_correction(
        self, cx: Pytree, cy: Pytree, state: State
    ) -> Tuple[Pytree, Pytree, State]:
        return cx, cy, state

    def rebase_state(self, state: State, active, prev_active=None) -> State:
        """Re-anchor membership-dependent state when an elastic schedule
        changes the active set.  The base strategies carry no per-agent
        state that can go stale (corrections are re-formed from the
        current server iterate every round), so this is a no-op."""
        del active, prev_active
        return state

    def realign_state_rows(self, state: State, prev_ids, ids) -> State:
        """`rebase_state` for the sparse layout, where the per-agent state
        entries (`sharded_state_keys`) carry one row per ACTIVE agent: rows
        are re-gathered from last round's id layout into this round's.  A
        continuing agent (in both sorted id lists) keeps its row, every
        other row restarts at zero (the dense rule keep = active &
        prev_active over id lists); `prev_ids` None zeroes everything, as
        `init_state`'s buffers are."""
        keys = [k for k in self.sharded_state_keys if k in state]
        if not keys:
            return state
        ids = np.asarray(ids)
        state = dict(state)
        if prev_ids is None or len(np.asarray(prev_ids)) == 0:
            pos = np.full(len(ids), -1, np.int64)
        else:
            prev_ids = np.asarray(prev_ids)
            # each current id's position in the previous (sorted) layout;
            # -1 where it did not take part last round
            idx = np.clip(np.searchsorted(prev_ids, ids), 0, len(prev_ids) - 1)
            pos = np.where(prev_ids[idx] == ids, idx, -1)
        places = {}

        def leaf(u):
            if u.device not in places:
                places[u.device] = (host_to_device(np.maximum(pos, 0), u.device),
                                    host_to_device(pos >= 0, u.device))
            take, keep = places[u.device]
            rows = u[take]
            mask = keep.reshape((-1,) + (1,) * (rows.dim() - 1))
            return torch.where(mask, rows, torch.zeros_like(rows))

        for k in keys:
            state[k] = tree_map(leaf, state[k])
        return state

    def bytes_per_round(self, x: Pytree, y: Pytree, num_local_steps: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FullSync(CommStrategy):
    """Centralized GDA: agents exchange gradients EVERY local step, so one
    'round' of K local steps costs K model up/downloads."""

    name = "full_sync"
    sync_every_step = True

    def bytes_per_round(self, x, y, num_local_steps):
        return 2 * _payload_bytes((x, y)) * num_local_steps


@dataclasses.dataclass(frozen=True)
class LocalOnly(CommStrategy):
    """Local SGDA (Deng & Mahdavi 2021): K uncorrected local steps, then
    one model up/download.  Cheap but biased for K >= 2 (Proposition 1)."""

    name = "local_only"

    def bytes_per_round(self, x, y, num_local_steps):
        return 2 * _payload_bytes((x, y))


@dataclasses.dataclass(frozen=True)
class GradientTracking(CommStrategy):
    """FedGDA-GT (Algorithm 2): one gradient exchange per round buys the
    tracking correction c_i = gbar - g_i; linear convergence to the exact
    minimax point (Theorem 1).  `correction_dtype` optionally stores c_i
    reduced (e.g. torch.float8_e4m3fn)."""

    correction_dtype: Any = None
    name = "gradient_tracking"
    use_correction = True

    def bytes_per_round(self, x, y, num_local_steps):
        # up: grad + local model; down: global grad + averaged model
        return 4 * _payload_bytes((x, y))


@dataclasses.dataclass(frozen=True)
class PartialParticipation(GradientTracking):
    """Gradient tracking with client sampling: each round a uniform subset
    of S = max(1, round(participation * m)) agents participates; gbar and
    the aggregate are plain means over the sampled set.  The sampling
    chain is the raw PRNGKey(seed), one split a round, the subset
    `engine.fixed_size_mask` of the subkey, JAX's bit for bit (drawn on
    the host: m keys of 32 bits and a stable sort).

    participation >= 1 is the identity configuration: sampling is elided
    and the round is exactly GradientTracking."""

    participation: float = 0.5
    seed: int = 0
    name = "partial_participation"

    @property
    def _sampling(self) -> bool:
        return self.participation < 1.0

    @property
    def stateful(self) -> bool:
        return self._sampling or self.noise is not None

    def init_state(self, x, y, m):
        state = self._noise_state()
        if self._sampling:
            state["key"] = prng.PRNGKey(self.seed)
        return state

    def sample_weights(self, state, m):
        if not self._sampling:
            return None, state
        S = max(1, int(round(self.participation * m)))
        if S >= m:
            return None, state
        state = dict(state)
        key, sub = prng.split(state["key"])
        state["key"] = key
        return renormalized_weights(fixed_size_mask(sub, m, S, "cpu")), state

    def bytes_per_round(self, x, y, num_local_steps):
        # expected per-agent payload: only sampled agents communicate
        return int(round(self.participation * 4 * _payload_bytes((x, y))))


@dataclasses.dataclass(frozen=True)
class _CorrectionCompressor(CommStrategy):
    """Shared machinery of the strategies that transform the tracking
    correction leaf by leaf: sparsification and / or stochastic
    quantization with error feedback.

    Subclasses (CompressedGT, QuantizedGT) declare the knobs and the
    `_ratio` / `_bits` hooks; this base owns the state (per-agent feedback
    buffers "ex" / "ey" in the correction dtype, and the RNG "key", a JAX
    threefry key as `prng` keeps it), the per-leaf loop and the kernels.
    Each leaf is laid out as [m * rows, cols] with last-axis rows as the
    selection / quantization groups (`transport.wire_rows_cols`).  Its
    draws are JAX's, bit for bit: one `split` of the key per round, then
    `fold_in(sub, 2*i + tag)` for leaf i of x (tag 0) or y (tag 1), and
    f64 `uniform`s from `fold_in(leaf_key, 0)` (rand-k scores) and
    `fold_in(leaf_key, 1)` (rounding), with leaves numbered in JAX's order.
    On a model tree x (`layer_period`, the config's pattern length, set),
    JAX's leaves are its stacked pattern slots (`core.types.leaf_groups`):
    a slot's layers share the stacked leaf's number and each takes its rows
    of the stacked leaf's draws, so kept indices and levels are JAX's.

    `use_kernel` (default True) runs the hand-written kernels:
    `compress_correction_2d`, or with `wire_transport` `pack_payload_2d` /
    `unpack_payload_2d`.  They launch on CUDA tensors and run their plain
    versions on CPU tensors; `use_kernel=False` runs the plain versions on
    any device (the card's kernel-against-plain check).  The reference's
    `kernel_interpret` (TPU interpret mode) has no counterpart.  With
    `wire_transport`, `transform_correction` returns `PackedTree`s, real
    packed payloads; wire on and off give the same iterates bit for bit."""

    use_kernel: bool = True       # the CUDA kernels (plain versions on CPU)
    wire_transport: bool = False  # emit packed payloads, not dense trees
    layer_period: int = 0         # a model x's pattern length (0: plain x)
    use_correction = True
    # knob defaults, overridden by the subclasses' dataclass fields
    mode = "topk"
    error_feedback = True
    seed = 0

    def __post_init__(self):
        if self.mode not in ("topk", "randk"):
            raise ValueError(f"unknown compression mode {self.mode!r}")

    @property
    def _ratio(self) -> float:
        """Kept fraction of correction entries per leaf (1.0 = dense)."""
        raise NotImplementedError

    @property
    def _bits(self) -> int:
        """Stochastic-quantization bit-width (>= 32 = no quantization)."""
        return 32

    @property
    def _sparsifying(self) -> bool:
        return self._ratio < 1.0

    @property
    def _quantizing(self) -> bool:
        return self._bits < 32

    @property
    def _active(self) -> bool:
        return self._sparsifying or self._quantizing

    @property
    def _needs_rng(self) -> bool:
        # rand-k selection scores and / or stochastic-rounding draws
        return self._quantizing or (self._sparsifying and self.mode == "randk")

    @property
    def exact_correction(self) -> bool:
        # a lossy transform (or gradient noise) voids the anchor-point
        # cancellation
        return not self._active and self.noise is None

    @property
    def _compressor_state(self) -> bool:
        return self._active and (self.error_feedback or self._needs_rng)

    @property
    def stateful(self) -> bool:
        return self._compressor_state or self.noise is not None

    @property
    def sharded_state_keys(self) -> Tuple[str, ...]:
        if self._active and self.error_feedback:
            return ("ex", "ey")
        return ()

    def init_state(self, x, y, m):
        state: State = self._noise_state()
        if not self._compressor_state:
            return state
        if self.error_feedback:
            # in the correction dtype: the engine casts the correction
            # before transform_correction
            def zeros(p):
                return tree_map(
                    lambda u: torch.zeros((m,) + tuple(u.shape),
                                          dtype=self.correction_dtype or u.dtype,
                                          device=u.device),
                    p,
                )

            state["ex"] = zeros(x)
            state["ey"] = zeros(y)
        if self._needs_rng:
            state["key"] = prng.PRNGKey(self.seed)
        return state

    def transform_correction(self, cx, cy, state):
        if not self._active:
            return cx, cy, state
        state = dict(state)
        sub = None
        if self._needs_rng:
            key, sub = prng.split(state["key"])
            state["key"] = key

        def compress(tree, err, tag):
            leaves, unflatten = tree_flatten(tree)
            eleaves = (tree_flatten(err)[0] if err is not None
                       else [None] * len(leaves))
            chats, resids, specs = ([None] * len(leaves) for _ in range(3))
            groups = leaf_groups(tree, self.layer_period if tag == 0 else 0)
            for i, group in enumerate(groups):
                leaf_key = None if sub is None else prng.fold_in(sub, 2 * i + tag)
                for j, li in enumerate(group):
                    chats[li], resids[li], specs[li] = one(
                        leaves[li], eleaves[li], j, len(group), leaf_key)
            resid = unflatten(resids) if err is not None else None
            if self.wire_transport:
                out = PackedTree(chats, specs, unflatten,
                                 [tuple(c.shape) for c in leaves],
                                 use_kernel=self.use_kernel, headers=len(groups))
            else:
                out = unflatten(chats)
            return out, resid

        def one(c, e, j, n_stack, leaf_key):
            """(ĉ, residual or None, wire spec or None) of one leaf, layer j
            of the n_stack that JAX stacks as one leaf: its draws are rows
            of the stacked leaf's."""
            m = c.shape[0]
            spec = LeafSpec.build(tuple(c.shape[1:]), c.dtype, self._ratio,
                                  self._bits, self.mode)
            if n_stack > 1 and c.dim() < 2:
                raise ValueError("a stacked leaf of scalars has no rows to slice")
            flat = c.reshape(m * spec.rows, spec.cols)
            k, n = spec.k, spec.cols
            index = None
            if n_stack > 1 and leaf_key is not None:
                # [m, n_stack, rows, cols] of JAX's stacked draw, layer j
                per = spec.rows * spec.cols
                index = (torch.arange(m)[:, None] * (n_stack * per) + j * per
                         + torch.arange(per)[None, :]).reshape(flat.shape)
            u_sel = u_rnd = None
            if self.mode == "randk" and k < n:
                u_sel = prng.uniform(prng.fold_in(leaf_key, 0), flat.shape,
                                     device=flat.device, index=index)
            if self._quantizing:
                u_rnd = prng.uniform(prng.fold_in(leaf_key, 1), flat.shape,
                                     device=flat.device, index=index)
            e_flat = None if e is None else e.reshape(flat.shape)
            wire = spec.stacked(m) if self.wire_transport else None
            if wire is not None:
                chat, resid = encode_leaf(flat, e_flat, u_sel, u_rnd, wire,
                                          use_kernel=self.use_kernel)
            else:
                chat, resid = compress_leaf(
                    flat, e_flat, u_sel, u_rnd, k=k, bits=self._bits,
                    mode=self.mode, use_kernel=self.use_kernel,
                )
                chat = chat.reshape(c.shape)
            return chat, None if e is None else resid.reshape(c.shape), wire

        ex = state.get("ex") if self.error_feedback else None
        ey = state.get("ey") if self.error_feedback else None
        cx, ex = compress(cx, ex, 0)
        cy, ey = compress(cy, ey, 1)
        if self.error_feedback:
            state["ex"], state["ey"] = ex, ey
        return cx, cy, state

    def rebase_state(self, state, active, prev_active=None):
        """Elastic re-anchoring of the error-feedback buffers: an agent's
        residual rows survive only if it took part both last round (so
        the residual describes a correction it applied) and this round (so
        it is about to re-inject it); departed and rejoining agents
        restart from zero.

        Here `prev_active=None` means a fresh start (keep = active alone,
        as in a first round where every buffer is zero).  In
        `sim.elastic.tracker_exchange` the same None means "no rebase" (the
        naive ablation); `ElasticAggregator.round_prev_active` gives the
        right value."""
        if "ex" not in state:
            return state
        keep = active if prev_active is None else (active & prev_active)

        def zero_stale(t):
            return agent_where(keep, t, tree_map(torch.zeros_like, t))

        state = dict(state)
        state["ex"] = zero_stale(state["ex"])
        state["ey"] = zero_stale(state["ey"])
        return state


@dataclasses.dataclass(frozen=True)
class CompressedGT(_CorrectionCompressor):
    """Gradient tracking with top-k / random-k sparsified corrections and
    (optional) error feedback.

    Each round the correction c_i = gbar - g_i is sparsified to a
    `compression_ratio` fraction of its entries (exactly k per agent row,
    earliest index winning ties) before the local steps; what is dropped
    accumulates in a per-agent feedback buffer e_i and is re-injected the
    next round.  compression_ratio >= 1 is the identity configuration:
    the round is exactly GradientTracking."""

    compression_ratio: float = 0.1
    mode: str = "topk"  # "topk" | "randk"
    error_feedback: bool = True
    seed: int = 0
    name = "compressed_gt"

    @property
    def _ratio(self) -> float:
        return self.compression_ratio

    def bytes_per_round(self, x, y, num_local_steps):
        # up: sparsified grad + local model; down: sparsified global grad
        # + averaged model (only the tracked-gradient exchange compresses)
        dense = _payload_bytes((x, y))
        return 2 * dense + 2 * _compressed_payload_bytes(
            (x, y), self.compression_ratio, value_dtype=self.correction_dtype,
        )


@dataclasses.dataclass(frozen=True)
class QuantizedGT(_CorrectionCompressor):
    """Gradient tracking with QSGD-style stochastically quantized (and
    optionally sparsified) corrections and error feedback.

    The kept entries of each correction row map to a symmetric `bits`-bit
    grid with the row's max-abs scale and round stochastically (floor +
    Bernoulli(frac)), so E[Q(c)] = c; the quantization error joins the
    sparsification residual in the feedback buffer.  `ratio` < 1 also
    keeps only a top-k / rand-k fraction first.  bits >= 32 and ratio >= 1
    is the identity configuration: the round is exactly GradientTracking."""

    bits: int = 8
    ratio: float = 1.0
    mode: str = "topk"  # "topk" | "randk" (only used when ratio < 1)
    error_feedback: bool = True
    seed: int = 0
    name = "quantized_gt"

    def __post_init__(self):
        super().__post_init__()
        if self.bits < 2:
            raise ValueError(
                f"quantization needs bits >= 2 (sign + magnitude), got {self.bits}"
            )

    @property
    def _ratio(self) -> float:
        return self.ratio

    @property
    def _bits(self) -> int:
        return self.bits

    def bytes_per_round(self, x, y, num_local_steps):
        dense = _payload_bytes((x, y))
        return 2 * dense + 2 * _compressed_payload_bytes(
            (x, y), self.ratio, self.bits, value_dtype=self.correction_dtype,
        )


@dataclasses.dataclass(frozen=True)
class SAGDA(GradientTracking):
    """Stochastic sampled averaged GDA (Yang et al. 2022): the
    gradient-tracking round driven by a stochastic gradient oracle; the
    anchor exchange and every local step consume fresh draws from the
    dedicated noise stream.  noise=None is the identity configuration: the
    round is exactly GradientTracking, op for op."""

    name = "sagda"


@dataclasses.dataclass(frozen=True)
class LocalSGDAPlus(CommStrategy):
    """Local SGDA+ (Sharma et al. 2022): Local SGDA's uncorrected K-step
    round with heavy-ball momentum on the local step (per-round
    velocities, zero-initialized) and a stochastic gradient oracle.
    momentum=0, noise=None is the identity configuration: the round is
    exactly LocalOnly, op for op."""

    momentum: float = 0.0
    name = "local_sgda_plus"

    def bytes_per_round(self, x, y, num_local_steps):
        # momentum never leaves the agent: one model up/download per round
        return 2 * _payload_bytes((x, y))


def _noise_kwargs(kw) -> dict:
    """The noise knobs of the stochastic-capable aliases; empty when the
    spec resolves to the deterministic regime, so identity configurations
    build strategies equal to the deterministic ones."""
    n = resolve_noise(kw.get("noise"), sigma=kw.get("noise_sigma"),
                      fraction=kw.get("noise_fraction"))
    if n is None:
        return {}
    return {"noise": n, "noise_seed": kw.get("noise_seed", 0)}


def _compressed(kw) -> dict:
    """The knobs the compressed-correction aliases share."""
    return dict(
        mode=kw.get("compression_mode", "topk"),
        error_feedback=kw.get("error_feedback", True),
        correction_dtype=kw.get("correction_dtype"),
        seed=kw.get("seed", 0),
        use_kernel=kw.get("use_kernel", True),
        wire_transport=kw.get("wire_transport", False),
        layer_period=kw.get("layer_period", 0),
        **_noise_kwargs(kw),
    )


def _partial(kw) -> "PartialParticipation":
    return PartialParticipation(
        participation=kw.get("participation", 0.5),
        correction_dtype=kw.get("correction_dtype"),
        seed=kw.get("seed", 0),
        **_noise_kwargs(kw),
    )


_ALIASES = {
    "gda": lambda kw: FullSync(),
    "sync_gda": lambda kw: FullSync(),
    "full_sync": lambda kw: FullSync(),
    "local_sgda": lambda kw: LocalOnly(),
    "local_only": lambda kw: LocalOnly(),
    "fedgda_gt": lambda kw: GradientTracking(
        correction_dtype=kw.get("correction_dtype"), **_noise_kwargs(kw),
    ),
    "gradient_tracking": lambda kw: GradientTracking(
        correction_dtype=kw.get("correction_dtype"), **_noise_kwargs(kw),
    ),
    "sagda": lambda kw: SAGDA(
        correction_dtype=kw.get("correction_dtype"), **_noise_kwargs(kw),
    ),
    "local_sgda_plus": lambda kw: LocalSGDAPlus(
        momentum=kw.get("momentum", 0.0), **_noise_kwargs(kw),
    ),
    "partial_gt": _partial,
    "partial_participation": _partial,
    "compressed_gt": lambda kw: CompressedGT(
        compression_ratio=kw.get("compression_ratio", 0.1), **_compressed(kw),
    ),
    "quantized_gt": lambda kw: QuantizedGT(
        bits=kw.get("quantization_bits", 8),
        ratio=kw.get("compression_ratio", 1.0),
        **_compressed(kw),
    ),
}


def resolve_strategy(spec, **kwargs) -> CommStrategy:
    """Map an algorithm name (or a ready strategy) to a CommStrategy.

    Names: "gda" / "sync_gda" / "full_sync", "local_sgda" / "local_only"
    (deterministic baselines: they ignore the noise knobs), "fedgda_gt" /
    "gradient_tracking" and "sagda" (kwarg `correction_dtype`),
    "local_sgda_plus" (momentum), "partial_gt" / "partial_participation"
    (participation, correction_dtype, seed), "compressed_gt"
    (compression_ratio, compression_mode, error_feedback, correction_dtype,
    seed, use_kernel, wire_transport, layer_period) and "quantized_gt" (the same plus
    quantization_bits; compression_ratio defaults to 1).  Every name but
    the baselines takes the noise knobs noise / noise_sigma /
    noise_fraction / noise_seed (`fed.noise.resolve_noise`).  The port's
    compressors default to `use_kernel=True` (the reference's to its
    interpret-mode False); unknown names raise ValueError."""
    if isinstance(spec, CommStrategy):
        return spec
    try:
        factory = _ALIASES[spec]
    except (KeyError, TypeError):
        raise ValueError(f"unknown algorithm {spec!r}") from None
    return factory(kwargs)
