// Blocked online-softmax (flash) attention, forward, for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces `repro/kernels/flash_attention.py` `flash_attention` (the
// Pallas TPU kernel `_flash_kernel`): out = softmax(mask(cap(q k^T /
// sqrt(hd)))) v per (batch, head), with
//   * tile-index positions: query i sits at position i, key j at j;
//   * causal (i >= j) and sliding-window (i - j < window) masks, filled
//     with the finite -1e30 of the TPU kernel, so that a row whose first
//     needed tile is fully masked averages uniformly until its first real
//     key, whose rescale 2^(-1e30 - m) = 0 wipes that average;
//   * the Gemma-2 logit softcap cap(s) = softcap * tanh(s / softcap);
//   * tiles that the masks exclude entirely skipped (the TPU kernel's
//     `needed` test), the denominator clamped at 1e-30.
// Beyond the TPU kernel: any Sq and Skv (keys past Skv get exactly zero
// weight, queries past Sq are not stored), any head_dim up to 256, q/k/v
// read through their (batch, head, seq) strides so the model's
// [B, S, H, hd] layout needs no transpose, and grouped-query attention
// natively: q-head h reads kv-head h / (H / KV), with no repeated K/V.
//
// Bound: operations.  4 * hd flops per unmasked (query, key) pair, on the
// tensor cores: bf16 at 989 TFLOP/s; f32 as 3xTF32 (three TF32 products
// per f32-accurate product, 495 / 3 = 165 TFLOP/s).  The bytes (q, k, v
// read once, out written once, at 3.35 TB/s) bound it only at short
// sequences.  The design:
//   * Both products on the tensor cores with `mma.sync`.  f32: each
//     operand is split a = hi + lo, hi = rna(a) and lo = rna(a - hi) in
//     TF32 (`cvt.rna.tf32.f32`'s rounding, done as two integer operations
//     for these finite operands), and lo*hi + hi*lo + hi*hi accumulate in
//     f32 (m16n8k8 TF32), which keeps f32's accuracy where one TF32
//     product would lose three digits.  bf16: m16n8k16 with f32
//     accumulation; P is rounded to bf16 in registers (the TPU's
//     default-precision dot does the same), its row sum is taken from the
//     f32 values.  The tensor cores' f32 accumulation does not round each
//     sum to nearest, so the chains are kept short: in QK^T the three TF32 products accumulate
//     apart over the head dim, and each tile's P V is formed apart and
//     folded in as o = o * alpha + P V with one f32 FMA.
//   * One warp per 16 query rows, 64 rows per CTA; the running max, the
//     denominator and the output accumulator stay in registers in f32.
//     The QK^T accumulator holds keys (2t, 2t+1) of each 8-key group in
//     lane t, which is not the TF32 A-operand order (t, t+4): instead of
//     moving P between lanes, the PV product reads V's rows in the
//     permuted order (2t, 2t+1).  In bf16 the two layouts coincide.
//   * K/V tiles of BK keys stream through a ring of NS stages in shared
//     memory, filled by `cp.async` 16-byte copies (8 or 4 bytes, or plain
//     loads, where a row's address is less aligned) kept NS-1 tiles ahead
//     of the compute, one barrier per tile; rows past Sq / Skv and the
//     head dim padded to HDP (a multiple of 16) arrive as zeros.  Each
//     row is padded by 16 bytes, so that `ldmatrix` and the fragment
//     loads hit every bank once.  (BK, NS) are chosen per (dtype, HDP) so
//     that two CTAs fit on an SM where they can (`Plan`).
//   * Scores in log2 units (exp2 on the SFU, log2(e) folded into the
//     scale, after the softcap, which is applied in natural units); masks
//     are evaluated only in tiles that the diagonal, the window edge or
//     the ragged Skv tail cut, for the warp's 16 rows.  A warp skips the
//     tiles its rows cannot see (past the diagonal, before the window).
//     The grid runs over (batch, head) fastest and over query tiles from
//     the last: under causal the heaviest CTAs start first.
// A query that no key may see (with a window, i >= Skv + window - 1)
// gets the mean of v over the keys j < Skv of the tiles its warp
// processes, or zero when there are none: the CTA's tiles run from the
// one holding key max(0, q0 - window + 1) of its first query q0 to the
// one holding Skv - 1 (or its last query, under causal), less those the
// warp skips.  The TPU kernel's answer there depends on its tiling too; no
// model path asks for such a row.  Built with FMA contraction (no
// -fmad=false): the result is held to a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// dtype codes shared with kernels/flash_attention.py
enum DType : int { kF32 = 1, kBF16 = 2 };

constexpr float kMaskFill = -1e30f;
constexpr int kWarps = 4;                    // 16 query rows each
constexpr size_t kTwoPerSm = 113 * 1024;     // (228 KB - 2 x 1 KB) / 2

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] per-row log-sum-exp (natural units), or null
  int B, H, KV, Sq, Skv, hd;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal, window;
  float softcap;
  float mul, cap2;  // logits in log2 units: cap2 * tanh(s * mul), or s * mul
  int vq, vk, vv;  // bytes per cp.async of q, k, v (16, 8, 4; 0: plain loads)
  int vo;          // out's rows take two-element stores
};

// ------------------------------------------------------------- tiling
template <typename T, int HDP_, int BK_, int NS_>
struct Tiling {
  static constexpr int HDP = HDP_, BK = BK_, NS = NS_;
  static constexpr int BQ = 16 * kWarps, THREADS = 32 * kWarps;
  static constexpr int ES = sizeof(T);
  static constexpr int LD = HDP + 16 / ES;   // smem row stride, elements
  static constexpr int ROWB = LD * ES;       // ... in bytes (16 * odd)
  static constexpr int TILE = BK * LD;       // one K or V tile, elements
  static constexpr int NT = HDP / 8;         // 8-column tiles of the output
  // ... in one P V chunk (4 above hd 128, where the accumulator is large)
  static constexpr int NC = NT > 16 ? 4 : NT < 8 ? NT : 8;
  static constexpr int NJ = BK / 8;          // 8-key tiles of the scores
  static constexpr int KS = HDP * ES / 32;   // k-steps of QK^T (8 f32, 16 bf16)
  static constexpr size_t SMEM = (size_t)(BQ + 2 * NS * BK) * ROWB;
};

__host__ __device__ constexpr size_t smem_of(int es, int hdp, int bk, int ns) {
  return (size_t)(16 * kWarps + 2 * ns * bk) * (hdp * es + 16);
}

// The deepest ring of the widest key tiles that lets two CTAs share an
// SM, else the one that fits one CTA: (64, 3), (64, 2), (32, 3), (32, 2)
// in that order.
__host__ __device__ constexpr int plan_code(int es, int hdp) {
  const int bk[4] = {64, 64, 32, 32}, ns[4] = {3, 2, 3, 2};
  for (int i = 0; i < 4; ++i)
    if (smem_of(es, hdp, bk[i], ns[i]) <= kTwoPerSm) return i;
  for (int i = 0; i < 4; ++i)
    if (smem_of(es, hdp, bk[i], ns[i]) <= kMaxSmem) return i;
  return -1;
}

template <typename T, int HDP>
struct Plan {
  static constexpr int code = plan_code(sizeof(T), HDP);
  static_assert(code >= 0, "no tiling fits shared memory");
  using type = Tiling<T, HDP, code < 2 ? 64 : 32, code % 2 == 0 ? 3 : 2>;
};


// ---------------------------------------------------------- products
// s[j] = Q_w K_j^T for the warp's 16 rows (Qw) and the BK keys of Ks.
// In f32 the large products (hi*hi) and the small ones (lo*hi, hi*lo)
// accumulate apart over the head dim and meet at the end: the chain that
// carries the large values is a third as long.
template <class C>
__device__ __forceinline__ void qk(float (&s)[C::NJ][4], const float* Qw,
                                   const float* Ks, int lane) {
  const uint32_t qa = smem_u32(Qw) + (lane & 15) * C::ROWB + (lane >> 4) * 16;
  const uint32_t ka = smem_u32(Ks) + ((lane & 7) + ((lane >> 4) << 3)) * C::ROWB +
                      ((lane >> 3) & 1) * 16;
  float small[C::NJ][4];
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < C::KS; ++kk) {
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, qa + kk * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < C::NJ; j += 2) {
      uint32_t b[4], bh[4], bl[4];
      ldsm_x4(b, ka + j * 8 * C::ROWB + kk * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), bh[i], bl[i]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mma_tf32(small[j + u], al, bh[2 * u], bh[2 * u + 1]);
        mma_tf32(small[j + u], ah, bl[2 * u], bl[2 * u + 1]);
        mma_tf32(s[j + u], ah, bh[2 * u], bh[2 * u + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];
}

template <class C>
__device__ __forceinline__ void qk(float (&s)[C::NJ][4], const __nv_bfloat16* Qw,
                                   const __nv_bfloat16* Ks, int lane) {
  const uint32_t qa = smem_u32(Qw) + (lane & 15) * C::ROWB + (lane >> 4) * 16;
  const uint32_t ka = smem_u32(Ks) + ((lane & 7) + ((lane >> 4) << 3)) * C::ROWB +
                      ((lane >> 3) & 1) * 16;
#pragma unroll 2
  for (int kk = 0; kk < C::KS; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qa + kk * 32);
#pragma unroll
    for (int j = 0; j < C::NJ; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, ka + j * 8 * C::ROWB + kk * 32);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

// pt = P V over the output's 8-column tiles N0 .. N0 + NC - 1 (those
// below NT).  Lane (g, t) holds P[g][2t, 2t+1] and P[g+8][2t, 2t+1] of
// each 8-key group j; taken as the TF32 A operand (columns t, t+4) they
// stand for keys 2t and 2t+1, so B reads V's rows 2t and 2t+1.
template <class C, int N0>
__device__ __forceinline__ void pv(float (&pt)[C::NC][4], const float (&s)[C::NJ][4],
                                   const float* Vs, int g, int t4) {
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(s[j][0], ah[0], al[0]);
    split_tf32(s[j][2], ah[1], al[1]);
    split_tf32(s[j][1], ah[2], al[2]);
    split_tf32(s[j][3], ah[3], al[3]);
    const float* v0 = Vs + (8 * j + 2 * t4) * C::LD + 8 * N0 + g;
#pragma unroll
    for (int nn = 0; nn < C::NC && N0 + nn < C::NT; ++nn) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(v0[8 * nn], bh0, bl0);
      split_tf32(v0[C::LD + 8 * nn], bh1, bl1);
      mma_3xtf32(pt[nn], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// ... in bf16, P rounded to bf16; the A and accumulator layouts coincide
template <class C, int N0>
__device__ __forceinline__ void pv(float (&pt)[C::NC][4], const float (&s)[C::NJ][4],
                                   const __nv_bfloat16* Vs, int lane) {
  const uint32_t va = smem_u32(Vs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * C::ROWB +
                      (lane >> 4) * 16 + N0 * 16;
#pragma unroll
  for (int jj = 0; jj < C::NJ / 2; ++jj) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * jj][0], s[2 * jj][1]), pack_bf16(s[2 * jj][2], s[2 * jj][3]),
        pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
        pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
    for (int nn = 0; nn < C::NC && N0 + nn < C::NT; nn += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, va + jj * 16 * C::ROWB + nn * 16);
      mma_bf16(pt[nn], a, b[0], b[1]);
      mma_bf16(pt[nn + 1], a, b[2], b[3]);
    }
  }
}

// o = o * alpha + P V, the product formed apart in chunks of NC column
// tiles and folded in with one f32 FMA: the tensor cores' accumulation
// chain stays one tile long, and the chunk's accumulator stays small
template <class C, int N0 = 0, typename T>
__device__ __forceinline__ void pv_fold(float (&o)[C::NT][4], const float (&s)[C::NJ][4],
                                        const T* Vs, const float (&alpha)[2], int lane) {
  if constexpr (N0 < C::NT) {
    float pt[C::NC][4];
#pragma unroll
    for (int nn = 0; nn < C::NC; ++nn) pt[nn][0] = pt[nn][1] = pt[nn][2] = pt[nn][3] = 0.f;
    if constexpr (sizeof(T) == 4)
      pv<C, N0>(pt, s, Vs, lane >> 2, lane & 3);
    else
      pv<C, N0>(pt, s, Vs, lane);
#pragma unroll
    for (int nn = 0; nn < C::NC && N0 + nn < C::NT; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[N0 + nn][e] = fmaf(o[N0 + nn][e], alpha[e >> 1], pt[nn][e]);
    pv_fold<C, N0 + C::NC>(o, s, Vs, alpha, lane);
  }
}

// The max (MAX) or the sum of this lane's entries of row half r (entries
// 2r, 2r+1 of each 8-key tile), as a tree: short dependent chains
template <int NJ, bool MAX>
__device__ __forceinline__ float row_tree(const float (&s)[NJ][4], int r) {
  float t[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    t[j] = MAX ? fmaxf(s[j][2 * r], s[j][2 * r + 1]) : s[j][2 * r] + s[j][2 * r + 1];
#pragma unroll
  for (int w = NJ / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = MAX ? fmaxf(t[j], t[j + w]) : t[j] + t[j + w];
  return t[0];
}

// the max over the four lanes that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ------------------------------------------------------------ kernel
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS) flash_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* const Qs = reinterpret_cast<T*>(smem);
  T* const ring = Qs + C::BQ * C::LD;  // stage s: K at 2s * TILE, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // heaviest (last, under causal) query tiles are scheduled first: the
  // grid runs over (batch, head) fastest, then query tiles backwards
  const int nbh = p.B * p.H, nqt = (p.Sq + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / nbh)) * C::BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const T* qp = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kp = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  T* op = static_cast<T*>(p.o) + b * p.osb + h * p.osh;

  // the key tiles some query of this CTA needs (the TPU kernel's
  // `needed`): causal stops after the last query, a window starts at the
  // first query's first visible key
  const int q_last = min(q0 + C::BQ, p.Sq) - 1;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / C::BK;
  const int t_hi = (k_hi + C::BK - 1) / C::BK;

  auto load_kv = [&](int t) {
    T* const dst = ring + ((t - t_lo) % C::NS) * 2 * C::TILE;
    const int k0 = t * C::BK, rows = min(C::BK, p.Skv - k0);
    load_rows<C, C::BK>(dst, kp + k0 * p.kss, kp, p.kss, rows, p.hd, p.vk);
    load_rows<C, C::BK>(dst + C::TILE, vp + k0 * p.vss, vp, p.vss, rows, p.hd, p.vv);
  };

  load_rows<C, C::BQ>(Qs, qp + q0 * p.qss, qp, p.qss, min(C::BQ, p.Sq - q0), p.hd,
                      p.vq);
  cp_commit();
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (t_lo + s < t_hi) load_kv(t_lo + s);
    cp_commit();
  }

  const int qw = q0 + 16 * warp;  // the warp's first row
  const T* const Qw = Qs + 16 * warp * C::LD;
  const bool cap = p.softcap > 0.f;
  float o[C::NT][4];
#pragma unroll
  for (int nn = 0; nn < C::NT; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;
  float m[2] = {kMaskFill, kMaskFill}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    cp_wait<C::NS - 2>();  // tile t (and Q) landed, for this thread's copies
    __syncthreads();       // ... for every thread's; tile t-1 is consumed
    if (t + C::NS - 1 < t_hi) load_kv(t + C::NS - 1);  // into tile t-1's stage
    cp_commit();

    const int k0 = t * C::BK;
    if (qw >= p.Sq || (p.causal && k0 > qw + 15) ||
        (p.window > 0 && k0 + C::BK - 1 < qw - p.window + 1))
      continue;  // no row of this warp sees a key of the tile
    const T* const Ks = ring + ((t - t_lo) % C::NS) * 2 * C::TILE;

    float s[C::NJ][4];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    qk<C>(s, Qw, Ks, lane);

    // scores in log2 units, masked where the tile is cut
    const bool edge = (p.causal && k0 + C::BK - 1 > qw) ||
                      (p.window > 0 && qw + 15 - k0 >= p.window) ||
                      k0 + C::BK > p.Skv;
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = cap ? p.cap2 * tanhf(s[j][e] * p.mul) : s[j][e] * p.mul;
        if (edge) {
          const int qi = qw + g + 8 * (e >> 1), kj = k0 + 8 * j + 2 * t4 + (e & 1);
          bool keep = true;
          if (p.causal) keep = qi >= kj;
          if (p.window > 0) keep = keep && qi - kj < p.window;
          x = keep ? x : kMaskFill;
          if (kj >= p.Skv) x = -INFINITY;  // past the sequence: no weight
        }
        s[j][e] = x;
      }
    float alpha[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = quad_max(row_tree<C::NJ, true>(s, r));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2_approx(s[j][e] - m[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) rs[r] = row_tree<C::NJ, false>(s, r);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this lane's part
    pv_fold<C>(o, s, Ks + C::TILE, alpha, lane);
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    // 1 / max(sum, 1e-30) to 2 ulp, on the SFU: an IEEE division's slow
    // path is a call, around which the accumulator would spill
    const float inv = __fdividef(1.f, fmaxf(sum, 1e-30f));
    const int qi = qw + g + 8 * r;
    if (qi >= p.Sq) continue;
    // the backward's softmax statistic: log(sum_j e^x_j), from the running
    // max and sum in log2 units; a store beside the output, which it
    // leaves unchanged
    if (p.lse != nullptr && t4 == 0)
      p.lse[(long long)bh * p.Sq + qi] = (m[r] + log2f(fmaxf(sum, 1e-30f))) * 0.69314718055994531f;
    T* const orow = op + qi * p.oss;
#pragma unroll
    for (int nn = 0; nn < C::NT; ++nn) {
      const int d = 8 * nn + 2 * t4;
      const float x0 = o[nn][2 * r] * inv, x1 = o[nn][2 * r + 1] * inv;
      if (p.vo && d + 1 < p.hd) {
        store_pair(orow + d, x0, x1);
      } else {
        if (d < p.hd) store_f(orow + d, x0);
        if (d + 1 < p.hd) store_f(orow + d + 1, x1);
      }
    }
  }
}

template <typename T, int HDP>
int launch(const Params& p, cudaStream_t stream) {
  using C = typename Plan<T, HDP>::type;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long opted_in = 0;  // per instantiation, by device
  if (C::SMEM > 48 * 1024 && dev < 64 && !(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ull << dev;
  }
  const long long ctas = (long long)p.B * p.H * ((p.Sq + C::BQ - 1) / C::BQ);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_kernel<T, C><<<(unsigned)ctas, C::THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// head dims padded to HDP: every multiple of 16 up to 128, then 160, 192,
// 224, 256
constexpr int hdp_of(int hd) {
  return hd <= 128 ? (hd + 15) / 16 * 16 : (hd + 31) / 32 * 32;
}

template <typename T>
int launch_hdp(const Params& p, cudaStream_t stream) {
  switch (hdp_of(p.hd)) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 48: return launch<T, 48>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 112: return launch<T, 112>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 160: return launch<T, 160>(p, stream);
    case 192: return launch<T, 192>(p, stream);
    case 224: return launch<T, 224>(p, stream);
    case 256: return launch<T, 256>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}


}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  q [B, H, Sq,
// hd], k/v [B, KV, Skv, hd] and out [B, H, Sq, hd], each with unit stride
// over hd and the (batch, head, seq) strides given in `strides` (12
// values: q, k, v, out), all of one dtype.  lse, if not null, receives
// each row's log-sum-exp of its logits (f32, natural units, contiguous
// [B, H, Sq]) for the backward (`flash_attention_bwd.cu`).  Shapes the kernel does not
// take (hd outside 1..256, KV not dividing H) return
// cudaErrorInvalidValue without launching; an empty problem launches
// nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int H,
                                      int KV, int Sq, int Skv, int hd,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      int dtype, void* stream) {
  if (hd < 1 || hd > 256 || KV < 1 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return 0;
  const int es = dtype == kF32 ? 4 : 2;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out; p.lse = lse;
  p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Skv = Skv; p.hd = hd;
  p.qsb = strides[0]; p.qsh = strides[1]; p.qss = strides[2];
  p.ksb = strides[3]; p.ksh = strides[4]; p.kss = strides[5];
  p.vsb = strides[6]; p.vsh = strides[7]; p.vss = strides[8];
  p.osb = strides[9]; p.osh = strides[10]; p.oss = strides[11];
  p.causal = causal; p.window = window; p.softcap = softcap;
  p.mul = softcap > 0.f ? scale / softcap : scale * kLog2e;
  p.cap2 = softcap * kLog2e;
  p.vq = vec_bytes(q, strides, es);
  p.vk = vec_bytes(k, strides + 3, es);
  p.vv = vec_bytes(v, strides + 6, es);
  p.vo = reinterpret_cast<uintptr_t>(out) % (2 * es) == 0 && strides[9] % 2 == 0 &&
         strides[10] % 2 == 0 && strides[11] % 2 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kF32 ? launch_hdp<float>(p, st) : launch_hdp<__nv_bfloat16>(p, st);
}

// The tiling the kernel takes for head_dim `hd` and `dtype`, into
// plan[0..5]: padded head dim, query rows per CTA, keys per tile, ring
// stages, threads per CTA and dynamic shared memory bytes.  Returns
// cudaErrorInvalidValue for what the launcher refuses.
extern "C" int flash_attention_plan(int hd, int dtype, int* plan) {
  if (hd < 1 || hd > 256 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == kF32 ? 4 : 2, hdp = hdp_of(hd);
  const int code = plan_code(es, hdp);
  const int bk = code < 2 ? 64 : 32, ns = code % 2 == 0 ? 3 : 2;
  plan[0] = hdp;
  plan[1] = 16 * kWarps;
  plan[2] = bk;
  plan[3] = ns;
  plan[4] = 32 * kWarps;
  plan[5] = (int)smem_of(es, hdp, bk, ns);
  return 0;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
