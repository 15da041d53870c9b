"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in `repro/kernels/ref.py`).  The CPU path of every kernel wrapper
runs these, and the chip check holds each kernel against them.

The model kernels' plain versions (`flash_attention_ref`,
`ssm_scan_ref`) contain reductions and are held to a tolerance.  Every
other function rounds every operation once, in the order JAX's oracle
does, so that the same inputs give JAX's bits:

  * a Python scalar meeting an f32 tensor is rounded to f32 first (JAX's
    weak types do the same); a scalar divided BY a tensor is spelled
    `torch.full_like(t, s) / t`, one true division per element;
  * casts to fp8 e4m3 turn overflow (|v| > 464, infinities) into NaN
    keeping the sign, as JAX and torch's CUDA cast do (`cast_to`);
  * the k-th largest score is a value, never an index, so the unspecified
    order of `torch.topk` among ties cannot leak into a mask; NaN ranks
    above every number, as in `jax.lax.top_k`;
  * packed uint32 words are built as int64 values in [0, 2^32) and stored
    as torch.uint32 (torch has no uint32 shifts on every device).
"""
from __future__ import annotations

import torch

#: fp8 e4m3 rounds magnitudes above this to NaN (448 is its largest
#: finite value; 464 is the midpoint to the next, unrepresentable, step)
FP8_E4M3_OVERFLOW = 464.0
MASK32 = 0xFFFFFFFF


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 in, f64 math; anything narrower (f32/bf16/f16/float8) runs in
    f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def cast_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`v.to(dtype)` with JAX's rounding on every device: to fp8 e4m3,
    |v| > 464 and infinities give NaN with v's sign (some torch CPU builds
    saturate to +-448 instead)."""
    if dtype == torch.float8_e4m3fn and v.dtype != dtype:
        over = v.abs() > FP8_E4M3_OVERFLOW
        v = torch.where(over, torch.full_like(v, float("nan")).copysign(v), v)
    return v.to(dtype)


def gt_update_ref(
    z: torch.Tensor, g: torch.Tensor, c: torch.Tensor, eta: float, sign: float
) -> torch.Tensor:
    """Fused FedGDA-GT inner update: z + sign*eta*(g + c).

    The arithmetic runs in `compute_dtype(z.dtype)`, one rounding per
    operation and in this order: s = sign*eta rounded once to the compute
    type, then g + c, then s * (g + c), then z + that, cast back to z's
    dtype (round to nearest).  c is read in its stored type and converted
    exactly.  For f64 and f32 leaves this is `engine.default_update`'s
    math; for bf16 leaves it is the Pallas kernel's (f32 math, cast back),
    and the CUDA kernel reproduces it bit for bit."""
    ct = compute_dtype(z.dtype)
    # a Python float times a tensor rounds the scalar to the tensor's
    # (compute) type first, on the CPU and on CUDA alike
    upd = (g.to(ct) + c.to(ct)) * (float(sign) * float(eta))
    return (z.to(ct) + upd).to(z.dtype)


# ----------------------------------------------------------------------
# compressed corrections — oracles of kernels/compress_correction.py
# ----------------------------------------------------------------------
def quantize_levels(kept, u_rnd, bits: int, ct):
    """QSGD quantization half: each row of `kept` onto the symmetric
    s = 2^(bits-1)-1 grid with a per-row max-abs scale, rounded
    stochastically (floor + [u_rnd < frac]) and clamped to [-s, s].
    Returns (q, scale): integer-valued levels in the compute dtype and the
    per-row scale (NaN rows keep a NaN scale, as `jnp.max` does)."""
    s = float(2 ** (bits - 1) - 1)
    scale = torch.amax(kept.abs(), dim=-1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    u = kept * (torch.full_like(safe, s) / safe)
    lo = torch.floor(u)
    q = lo + (u_rnd.to(ct) < u - lo).to(ct)
    return torch.clamp(q, -s, s), scale


def dequantize_levels(q, scale, bits: int, ct):
    """QSGD dequantization half: q * (safe * (1/s)), the constant
    reciprocal rounded once to the compute dtype."""
    s = float(2 ** (bits - 1) - 1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return q * (safe * (1.0 / s))


def stochastic_quantize(kept, u_rnd, bits: int, ct):
    """quantize_levels then dequantize_levels: the dense compressed
    correction and the decoded wire payload are the same bits."""
    q, scale = quantize_levels(kept, u_rnd, bits, ct)
    return dequantize_levels(q, scale, bits, ct)


def kth_largest(score: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value of each row of `score` [R, C] as [R, 1]
    (NaN ranks above every number, as in `jax.lax.top_k`).  Only the
    values of `torch.topk` are read, never its tie order."""
    return torch.topk(score, k, dim=-1).values[..., k - 1:k]


def exact_k_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask keeping exactly k entries per row of `score` [R, C]:
    the k largest, earliest index winning ties.  With NaN scores it keeps
    what JAX keeps: NaN compares false, so a row whose k-th largest score
    is NaN keeps nothing, and a NaN above the threshold is not kept."""
    n = score.shape[-1]
    if k >= n:
        return torch.ones(score.shape, dtype=torch.bool, device=score.device)
    thr = kth_largest(score, k)
    gt = score > thr
    n_gt = gt.sum(dim=-1, keepdim=True)
    tie = score == thr
    tie_rank = torch.cumsum(tie.to(torch.int64), dim=-1)
    return gt | (tie & (tie_rank <= k - n_gt))


def _effective(c, e, ct):
    return c.to(ct) if e is None else c.to(ct) + e.to(ct)


def _select(ceff, u_sel, k: int, mode: str):
    """(mask | None, kept): the exact-k selection of `ceff`'s rows by
    |ceff| (topk) or by u_sel (randk); no mask when k covers the row."""
    if k >= ceff.shape[-1]:
        return None, ceff
    score = ceff.abs() if mode == "topk" else u_sel.to(ceff.dtype)
    mask = exact_k_mask(score, k)
    return mask, torch.where(mask, ceff, torch.zeros_like(ceff))


def compress_correction_ref(c, e, u_sel, u_rnd, *, k: int, bits: int,
                            mode: str = "topk"):
    """One flattened leaf c [R, C] (R = agents x groups): error-feedback
    injection, exact-k selection, QSGD stochastic quantization, residual.

      ceff  = c + e                       (e may be None)
      kept  = ceff * exact_k_mask(score)  score = |ceff| (topk) | u_sel (randk)
      chat  = Q(kept)                     identity for bits >= 32
      resid = ceff - chat as stored       (what the feedback re-injects)

    u_sel / u_rnd are U[0,1) draws of c's shape.  Returns (chat, resid) in
    c.dtype; the math runs in `compute_dtype(c.dtype)`."""
    ct = compute_dtype(c.dtype)
    ceff = _effective(c, e, ct)
    _, kept = _select(ceff, u_sel, k, mode)
    chat = stochastic_quantize(kept, u_rnd, bits, ct) if bits < 32 else kept
    chat = cast_to(chat, c.dtype)
    resid = cast_to(ceff - chat.to(ct), c.dtype)
    return chat, resid


# ----------------------------------------------------------------------
# packed (value, index) wire payloads — oracles of kernels/pack_payload.py
# ----------------------------------------------------------------------
_WORD_BITS = 32
_STORAGE_WIDTHS = (2, 4, 8, 16, 32)
ENCODINGS = ("quant", "quant_dense", "sparse", "dense")


def storage_bits(bits: int) -> int:
    """Wire width of one quantized level: the smallest power-of-two
    sub-word width (2/4/8/16/32) holding `bits` bits, so levels never
    straddle a uint32 word."""
    for w in _STORAGE_WIDTHS:
        if w >= bits:
            return w
    raise ValueError(f"bits={bits} exceeds the 32-bit word")


def word_layout(k: int, bits: int):
    """(storage bits, levels per uint32 word, words per row) for k kept
    levels of `bits`-bit quantized values."""
    sb = storage_bits(bits)
    per_word = _WORD_BITS // sb
    return sb, per_word, -(-k // per_word)


def kept_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices [.., k] (ascending, int64) of the True entries of
    each row of `mask`.  A row with fewer than k (a NaN row) is padded, as
    in JAX, with C + j for its first non-kept columns j."""
    C = mask.shape[-1]
    it = torch.arange(C, device=mask.device).expand(mask.shape)
    return torch.sort(torch.where(mask, it, it + C), dim=-1).values[..., :k]


def _int_view(dtype: torch.dtype) -> torch.dtype:
    return {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[dtype.itemsize]


def take_or_nan(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take_along_axis(values, idx, -1)`: an index past the row
    gives NaN (JAX's fill for inexact types).  Gathers the raw bits, so it
    takes every float dtype (fp8 included) on every device."""
    C = values.shape[-1]
    iv = _int_view(values.dtype)
    raw = torch.gather(values.view(iv), -1, idx.clamp(max=C - 1))
    nan = torch.tensor(float("nan")).to(values.dtype).view(iv).to(raw.device)
    return torch.where(idx < C, raw, nan).view(values.dtype)


def levels_of(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Wire levels of quantized values q: (q + s) as int32 the way XLA
    converts (NaN -> 0, saturating), then its uint32 bits, as int64."""
    s = float(2 ** (bits - 1) - 1)
    v = torch.nan_to_num((q + s).to(torch.float64), nan=0.0)
    v = torch.clamp(v, -2.0 ** 31, 2.0 ** 31 - 1)
    return torch.trunc(v).to(torch.int64) & MASK32


def pack_words(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit-pack non-negative integer levels [.., k] (int64, each <
    2^storage_bits) into uint32 words [.., W], level i of a row landing at
    bit (i % per_word) * storage_bits of word i // per_word."""
    k = levels.shape[-1]
    sb, per_word, W = word_layout(k, bits)
    lv = torch.nn.functional.pad(levels, (0, W * per_word - k))
    lv = lv.reshape(*levels.shape[:-1], W, per_word)
    shifts = torch.arange(per_word, device=levels.device) * sb
    # disjoint bit ranges: the sum is the bitwise or
    return (lv << shifts).sum(dim=-1).to(torch.uint32)


def unpack_words(words: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """Inverse of pack_words: uint32 words [.., W] -> levels [.., k] as
    int64."""
    sb, per_word, W = word_layout(k, bits)
    w = words.view(torch.int32).to(torch.int64) & MASK32
    shifts = torch.arange(per_word, device=words.device) * sb
    lv = (w[..., None] >> shifts) & ((1 << sb) - 1)
    return lv.reshape(*words.shape[:-1], W * per_word)[..., :k]


def pack_payload_ref(c, e, u_sel, u_rnd, *, k: int, bits: int,
                     mode: str = "topk", encoding: str = "quant",
                     index_dtype=torch.int32):
    """One flattened leaf c [R, C]: compress_correction_ref's selection and
    quantization on the same draws, then the wire buffers.  Returns
    (data, idx, scale, resid):

      data   "quant":       uint32 words [R, W] of the bit-packed levels
                            q + s of the kept entries (pack_words)
             "quant_dense": all C levels bit-packed, no indices
             "sparse":      the kept values [R, k] in c.dtype
             "dense":       the full compressed chat [R, C]
      idx    kept column indices [R, k], ascending (iota when k == C), in
             `index_dtype`
      scale  per-row quantization scale [R, 1] in compute_dtype(c.dtype)
             (zeros when bits >= 32)
      resid  ceff - chat in c.dtype, chat being what decode_payload_ref
             reconstructs"""
    if encoding not in ENCODINGS:
        raise ValueError(f"unknown payload encoding {encoding!r}")
    ct = compute_dtype(c.dtype)
    ceff = _effective(c, e, ct)
    R, C = ceff.shape
    mask, kept = _select(ceff, u_sel, k, mode)
    if mask is None:
        idx = torch.arange(k, device=ceff.device).expand(R, k)
    else:
        idx = kept_indices(mask, k)
    if bits < 32:
        q, scale = quantize_levels(kept, u_rnd, bits, ct)
        chat = dequantize_levels(q, scale, bits, ct)
    else:
        q, scale = kept, torch.zeros((R, 1), dtype=ct, device=ceff.device)
        chat = kept
    chat_out = cast_to(chat, c.dtype)
    resid = cast_to(ceff - chat_out.to(ct), c.dtype)
    if encoding in ("quant", "quant_dense"):
        qk = q if encoding == "quant_dense" else take_or_nan(q, idx)
        data = pack_words(levels_of(qk, bits), bits)
    elif encoding == "sparse":
        data = take_or_nan(chat_out, idx)
    else:
        data = chat_out
    return data, idx.to(index_dtype), scale, resid


def decode_payload_ref(data, idx, scale, *, cols: int, dtype, k: int,
                       bits: int, encoding: str = "quant"):
    """Inverse of pack_payload_ref: the dense [R, cols] compressed
    correction.  Kept slots land as 0 + v, as JAX's scatter-add into zeros
    does (so a kept -0.0 decodes to +0.0); an index past the row is
    dropped, as JAX's scatter drops it."""
    if encoding == "dense":
        return data
    ct = compute_dtype(dtype)
    s = float(2 ** (bits - 1) - 1)
    if encoding == "quant_dense":
        q = unpack_words(data, cols, bits).to(ct) - s
        return cast_to(dequantize_levels(q, scale.to(ct), bits, ct), dtype)
    ii = idx.to(torch.int64)
    if encoding == "sparse":
        vals = data
    else:
        q = unpack_words(data, k, bits).to(ct) - s
        vals = cast_to(dequantize_levels(q, scale.to(ct), bits, ct), dtype)
    valid = ii < cols
    add = torch.where(valid, vals.to(ct), torch.zeros((), dtype=ct,
                                                      device=vals.device))
    dense = torch.zeros((ii.shape[0], cols), dtype=ct, device=vals.device)
    dense.scatter_add_(1, ii.clamp(max=cols - 1), add)
    return cast_to(dense, dtype)


#: the attention mask fill of the TPU kernel and the JAX models: finite,
#: so that a row whose first needed tile is fully masked averages
#: uniformly until its first real key, whose alpha = exp(-1e30 - m) = 0
#: then wipes that average (with -inf the rescale would be NaN)
NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int = 0, softcap: float = 0.0,
) -> torch.Tensor:
    """Plain attention over q [B, H, Sq, hd] and k/v [B, KV, Skv, hd]
    (KV divides H; q-head h reads kv-head h // (H // KV), by
    `repeat_interleave`), computed in f32 and returned in q's dtype, as
    the kernel does (f64 inputs, which the kernel does not take, are
    computed in f64: the yardstick both are held to): scale 1/sqrt(hd),
    tanh softcap, causal / window masks on tile-index positions filled
    with -1e30, softmax over keys.

    JAX's `ref.flash_attention_ref` takes repeated heads and computes the
    scores in the inputs' dtype; in f32 the two are the same function."""
    s, vf = _flash_scores(q, k, v, causal, window, softcap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int = 0, softcap: float = 0.0,
) -> torch.Tensor:
    """Each query row's log-sum-exp of its masked, capped logits (natural
    units), [B, H, Sq] in f32: the statistic the flash kernel's forward
    leaves for its backward."""
    s, _ = _flash_scores(q, k, v, causal, window, softcap)
    return torch.logsumexp(s, dim=-1).float()


def _flash_scores(q, k, v, causal: bool, window: int, softcap: float):
    """The masked, capped logits [B, H, Sq, Skv] and the repeated v, in the
    compute dtype."""
    H, KV, hd = q.shape[1], k.shape[1], q.shape[-1]
    if H % KV:
        raise ValueError(f"flash_attention_ref: {H} q heads over {KV} kv heads")
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    ct = compute_dtype(q.dtype)
    qf, kf, vf = q.to(ct), k.to(ct), v.to(ct)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=ct))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    # query i sits at position i, key j at j (the TPU kernel's tile-index
    # positions)
    qp = torch.arange(q.shape[2], device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= qp - kp < window
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), vf


def ssm_scan_ref(
    da: torch.Tensor, dbx: torch.Tensor, c_coef: torch.Tensor,
    state0=None,
):
    """Sequential plain version of h_t = da_t * h_{t-1} + dbx_t and
    y_t = <h_t, c_t>, in f32, over the batched layout the kernel takes:
    dbx [B, S, H, P, N], da broadcastable to it (Mamba-2's [B, S, H, 1, 1]
    is never expanded), c_coef [B, S, N], state0 [B, H, P, N] or None
    (zeros).  Returns (y [B, S, H, P], final state [B, H, P, N]).

    JAX's `ref.ssm_scan_ref` is the same recurrence over one sequence
    ([S, D, N], `lax.scan`).  On `meta` (shapes only, the dry-run's) the
    outputs' shapes come back without stepping through S positions: there
    is no value to compute, and the recurrence has no product a census
    counts."""
    B, S, H, P, N = dbx.shape
    if dbx.device.type == "meta":
        return (torch.empty(B, S, H, P, dtype=torch.float32, device="meta"),
                torch.empty(B, H, P, N, dtype=torch.float32, device="meta"))
    h = (torch.zeros(B, H, P, N, dtype=torch.float32, device=dbx.device)
         if state0 is None else state0.float())
    da, dbx, c = da.float(), dbx.float(), c_coef.float()
    ys = []  # stacked, not written in place: the loop runs under vmap too
    for t in range(S):
        h = da[:, t] * h + dbx[:, t]
        ys.append((h * c[:, t, None, None, :]).sum(-1))
    y = (torch.stack(ys, dim=1) if ys else
         torch.empty(B, S, H, P, dtype=torch.float32, device=dbx.device))
    return y, h
