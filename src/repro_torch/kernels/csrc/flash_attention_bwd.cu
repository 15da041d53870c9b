// Backward of the blocked online-softmax (flash) attention, f32, for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces no TPU kernel: the JAX package differentiates its plain
// attention (`models/attention.py` `_attend`) with XLA's autodiff and has
// no backward Pallas kernel.  It was added so that the port's training
// path runs through `csrc/flash_attention.cu` forward and this backward,
// with no [B, H, Sq, Skv] score tensor in device memory.
//
// For out = softmax(x) v with x = cap(s), s = scale * q k^T (cap(s) =
// softcap * tanh(s / softcap), or s), tile-index positions and the
// forward's causal / window masks, and the forward's per-row log-sum-exp
// lse (natural units), the gradients are
//   P  = exp(x - lse)                      (recomputed, never stored)
//   D  = rowsum(dO o out)                  (first kernel, [B, H, Sq])
//   dV = P^T dO,  dP = dO V^T,  dx = P o (dP - D)
//   ds = dx o (1 - tanh^2(s / softcap))    (softcap > 0; else ds = dx)
//   dQ = scale * ds K,  dK = scale * ds^T Q
// Grouped-query attention: k/v carry KV heads and q-head h reads kv-head
// h / (H / KV), so dK and dV of a kv head sum over its G query heads.
//
// Bound: operations, 10 * hd flops per unmasked (query, key) pair (S^T,
// dP^T, dV, dK and dQ, 2 hd each) on the tensor cores as 3xTF32 (495 / 3
// = 165 TFLOP/s); at short sequences the bytes (q, k, v, out, dO, lse
// read once, dq, dk, dv written once).  Three kernels, in order on one
// stream:
//   * delta_kernel: one warp a row, D = rowsum(dO o out);
//   * flash_bwd_kernel: one pass for dQ, dK and dV.  One CTA a tile of BC
//     keys of one (batch, kv head), in groups of 16 keys, each held by two
//     warps: one forms S^T = K Q^T, P^T and dV += P^T dO, the other dP^T
//     = V dO^T, dS^T and dK += dS^T Q, the first handing P^T (times 1 -
//     tanh^2 under a softcap) to the second through shared memory; so a
//     warp keeps one of dK / dV of its keys in registers.  The CTA walks
//     its G query heads and, within each, the tiles of BR query rows that
//     may see its keys (causal: from the tile's first key; window: up to
//     its last key + window - 1); a warp whose 16 keys no query of the tile
//     may see forms no product.  Where B * KV * key tiles would leave the
//     card short of CTAs (fewer than kTargetCtas), a key tile's query-tile
//     steps are split over several CTAs (split-Q), each writing its share
//     of dK / dV to a partial of its own.  Q, dO, lse and D of the next
//     query tile stream into a second shared-memory stage by `cp.async`
//     while the current one is computed.  The products run on
//     `mma.sync.m16n8k8` TF32 with each f32 operand split into two TF32
//     parts (`sm90.cuh` `split_tf32_fast`; the forward's 3xTF32): S^T and
//     dP^T with their large and small products accumulated apart, as the
//     forward's q k^T; dV and dK with P^T and dS^T taken from the
//     accumulators as A operands (the B operand read in the accumulator's
//     key order, as the forward's P V), each query tile's products formed
//     apart and folded into dK / dV with one f32 add, which keeps the
//     tensor cores' accumulation chains short.  dS^T goes to shared
//     memory, and the CTA's warps form dQ's share of this key tile, dS K
//     (skipping the k-steps the masks zero), writing it to a partial of its
//     own, [ceil(Skv / BC), B, H, Sq, hd], or to dQ itself where one key
//     tile covers Skv;
//   * dq_reduce_kernel (more than one key tile): dQ = the partials of the
//     key tiles that visited a row's query tile, summed in key-tile order;
//   * dkv_reduce_kernel (split-Q): dK, dV = their chunks' partials, in
//     chunk order.
// No float atomics: every sum runs in a fixed order, so two calls give
// the same bits.  Tiling (`Plan`): BC = 128 keys (16 warps, one CTA an
// SM) and BR = 32 query rows up to hd 96; BC = 64 (8 warps) and BR = 16
// above, two CTAs an SM up to hd 128; head dims above 128 pad to 256, one
// CTA an SM.  Rows that no key may see (a window past Skv) get dQ = 0 and
// add nothing to dK / dV: outside the gradient's contract.  Offsets are
// 64-bit throughout.  Built with FMA contraction: held to a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kRowThreads = 256;  // delta_kernel and the reduce kernels
// CTAs below which a key tile's query tiles are split over several CTAs:
// two an H100's 132 SMs
constexpr long long kTargetCtas = 264;

struct Params {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *delta;
  float* dq_part;   // [nkt, B, H, Sq, hd], or dq itself where nkt = 1
  float* dkv_part;  // [nsplit, 2, B, KV, Skv, hd] (dV then dK), where nsplit > 1
  int B, H, KV, Sq, Skv, hd;
  // (batch, head, seq) strides of q, k, v, o, dO, dQ, dK, dV
  long long s[8][3];
  int causal, window;
  float softcap, scale;
  int vq, vk, vv, vdo;  // bytes per cp.async of q, k, v, dO rows (16, 8 or 4)
  int v4;               // out, dO and dQ rows take 16-byte accesses (hd % 4 == 0)
  int nsplit, chunk;    // CTAs a key tile, query-tile steps each walks
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

// ------------------------------------------------------------- tiling
template <int HDP_, int BR_, int BC_>
struct Tiling {
  static constexpr int HDP = HDP_, BC = BC_, BR = BR_, NS = 2;
  static constexpr int KG = BC / 16;              // key groups, 16 keys each
  static constexpr int WARPS = 2 * KG, THREADS = 32 * WARPS;  // two roles a group
  static constexpr int LD = HDP + 4;              // smem row stride, floats
  static constexpr int ROWB = 4 * LD;             // ... in bytes (16 * odd)
  static constexpr int NT = HDP / 8;              // 8-column tiles of hd
  static constexpr int NJ = BR / 8;               // 8-query tiles of S^T
  static constexpr int KS = HDP / 8;              // k-steps over hd
  static constexpr int LDT = BR + 4;              // P'^T and dS^T row stride
  static constexpr int RGS = BR / 16;             // dQ units: 16 rows ...
  static constexpr int QC0 = (NT * RGS + WARPS - 1) / WARPS;
  static constexpr int QC = QC0 > 4 ? 4 : QC0;    // ... by QC 8-column tiles
  static constexpr int STAGE = 2 * BR * LD + 2 * BR;  // Q, dO, lse, D
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)2 * BC * LD + (size_t)2 * BC * LDT + (size_t)NS * STAGE);
};

__host__ __device__ constexpr size_t smem_of(int hdp, int br, int bc) {
  return sizeof(float) * ((size_t)2 * bc * (hdp + 4) + (size_t)2 * bc * (br + 4) +
                          (size_t)2 * (2 * br * (hdp + 4) + 2 * br));
}

// Key tiles of 128 (one CTA of 16 warps an SM, at most 128 registers a
// thread) up to hd 96; of 64 above (8 warps: two CTAs an SM up to hd 128,
// where a thread needs all of its 128 registers, one at hd 256); query
// tiles of 32 rows up to hd 96, of 16 above
__host__ __device__ constexpr int bc_of(int hdp) { return hdp <= 96 ? 128 : 64; }
__host__ __device__ constexpr int br_of(int hdp) { return hdp <= 96 ? 32 : 16; }

template <int HDP>
struct Plan {
  using type = Tiling<HDP, br_of(HDP), bc_of(HDP)>;
  static_assert(type::SMEM <= kMaxSmem, "no tiling fits shared memory");
};

// a key tile's query-tile steps split over CTAs (split-Q) where B * KV *
// nkt CTAs would not fill the card: nsplit CTAs of `chunk` steps each
struct Split {
  int nkt, nsplit, chunk;
};

inline Split split_of(int B, int H, int KV, int Sq, int Skv, int bc, int br) {
  Split sp;
  sp.nkt = (Skv + bc - 1) / bc;
  const long long base = (long long)B * KV * sp.nkt;
  const int most = H / KV * ((Sq + br - 1) / br);  // a key tile's steps, at most
  long long want = base >= kTargetCtas ? 1 : (kTargetCtas + base - 1) / base;
  want = want > most ? most : want;
  sp.chunk = (int)((most + want - 1) / want);
  sp.nsplit = (most + sp.chunk - 1) / sp.chunk;
  return sp;
}

__device__ __forceinline__ bool keep(const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Skv) return false;
  if (p.causal && qi < kj) return false;
  if (p.window > 0 && qi - kj >= p.window) return false;
  return true;
}

// the query tiles [lo, hi) that key tile kt's CTA visits: those holding a
// query that may see one of its keys (causal: from its first key; window:
// up to its last key + window - 1)
template <class C>
__device__ __forceinline__ void query_tiles(const Params& p, int kt, int& lo, int& hi) {
  const int k0 = kt * C::BC;
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = (int)min((long long)q_hi, (long long)k0 + C::BC - 1 + p.window);
  lo = q_lo / C::BR;
  hi = q_hi > q_lo ? (q_hi + C::BR - 1) / C::BR : lo;
}

// D[b, h, i] = sum_d dO * out: one warp a row (grid (rows / 8, H, B)),
// lanes over 4-column groups where the rows take 16-byte loads (p.v4),
// else over columns; then a fixed shuffle tree
__global__ void __launch_bounds__(kRowThreads) delta_kernel(const Params p) {
  const int i = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  if (i >= p.Sq) return;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.z, h = blockIdx.y;
  const float* o = p.o + b * p.s[kO][0] + h * p.s[kO][1] + i * p.s[kO][2];
  const float* g = p.dout + b * p.s[kDO][0] + h * p.s[kDO][1] + i * p.s[kDO][2];
  float acc = 0.f;
  if (p.v4) {
    for (int d = lane; d < p.hd / 4; d += 32) {
      const float4 x = reinterpret_cast<const float4*>(o)[d];
      const float4 y = reinterpret_cast<const float4*>(g)[d];
      acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
  } else {
    for (int d = lane; d < p.hd; d += 32) acc += o[d] * g[d];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(b * p.H + h) * p.Sq + i] = acc;
}

// ---------------------------------------------------------- products
// acc = A_w B^T for the warp's 16 rows of A (K or V, at Aw) and the BR
// rows of B (the stage's Q or dO), over the head dim: S^T = K Q^T or
// dP^T = V dO^T.  The large products (hi*hi) and the small ones (lo*hi,
// hi*lo) accumulate apart and meet at the end, as in the forward's q k^T.
template <class C>
__device__ __forceinline__ void scores_t(float (&acc)[C::NJ][4], const float* Aw,
                                         const float* Bs, int lane) {
  const uint32_t aa = smem_u32(Aw) + (lane & 15) * C::ROWB + (lane >> 4) * 16;
  const uint32_t ba = smem_u32(Bs) + ((lane & 7) + ((lane >> 4) << 3)) * C::ROWB +
                      ((lane >> 3) & 1) * 16;
  float small[C::NJ][4];
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < C::KS; ++kk) {
    uint32_t a[4], ah[4], al[4];
    ldsm_x4(a, aa + kk * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32_fast(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < C::NJ; j += 2) {
      uint32_t b[4], bh[4], bl[4];
      ldsm_x4(b, ba + j * 8 * C::ROWB + kk * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32_fast(__uint_as_float(b[i]), bh[i], bl[i]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mma_tf32(small[j + u], al, bh[2 * u], bh[2 * u + 1]);
        mma_tf32(small[j + u], ah, bl[2 * u], bl[2 * u + 1]);
        mma_tf32(acc[j + u], ah, bh[2 * u], bh[2 * u + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// acc += X^T B over the NT column tiles: X^T (P^T or dS^T, the warp's 16
// keys by BR queries) from its S^T-shaped accumulator, B the stage's dO or
// Q.  Lane (g, t) holds keys g, g+8 at queries 2t, 2t+1 of each 8-query
// tile, taken as the TF32 A operand's columns t and t+4, so B reads query
// rows 2t and 2t+1 (the forward's P V).  This query tile's products are
// formed apart and folded in with one f32 add, which keeps the tensor
// cores' accumulation chains short.
template <class C>
__device__ __forceinline__ void kv_update(float (&acc)[C::NT][4], const float (&x)[C::NJ][4],
                                          const float* Bs, int g, int t4) {
  uint32_t xh[C::NJ][4], xl[C::NJ][4];
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    split_tf32_fast(x[j][0], xh[j][0], xl[j][0]);
    split_tf32_fast(x[j][2], xh[j][1], xl[j][1]);
    split_tf32_fast(x[j][1], xh[j][2], xl[j][2]);
    split_tf32_fast(x[j][3], xh[j][3], xl[j][3]);
  }
#pragma unroll
  for (int nn = 0; nn < C::NT; ++nn) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int off = (8 * j + 2 * t4) * C::LD + 8 * nn + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32_fast(Bs[off], bh0, bl0);
      split_tf32_fast(Bs[off + C::LD], bh1, bl1);
      mma_3xtf32(t, xh[j], xl[j], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] += t[e];
  }
}

// acc = dS K for query rows 16 rg .. 16 rg + 15 and the 8-column tiles
// ch * QC .. (those below NT), over the k-steps [kk_lo, kk_hi) of 8 keys
// (outside them the masks leave dS zero): dS read from dSt ([key][query])
// in the key order 2t, 2t+1 of the accumulator layout
template <class C>
__device__ __forceinline__ void dq_unit(float (&acc)[C::QC][4], const float* dSt,
                                        const float* Ks, int rg, int ch, int kk_lo, int kk_hi,
                                        int g, int t4) {
#pragma unroll
  for (int nn = 0; nn < C::QC; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
  const int r = 16 * rg + g;
#pragma unroll 2
  for (int kk = kk_lo; kk < kk_hi; ++kk) {
    const float* a0 = dSt + (8 * kk + 2 * t4) * C::LDT + r;
    uint32_t ah[4], al[4];
    split_tf32_fast(a0[0], ah[0], al[0]);
    split_tf32_fast(a0[8], ah[1], al[1]);
    split_tf32_fast(a0[C::LDT], ah[2], al[2]);
    split_tf32_fast(a0[C::LDT + 8], ah[3], al[3]);
    const float* b0 = Ks + (8 * kk + 2 * t4) * C::LD + 8 * ch * C::QC + g;
#pragma unroll
    for (int nn = 0; nn < C::QC; ++nn) {
      if (ch * C::QC + nn < C::NT) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_fast(b0[8 * nn], bh0, bl0);
        split_tf32_fast(b0[C::LD + 8 * nn], bh1, bl1);
        mma_3xtf32(acc[nn], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// ------------------------------------------------------------ kernels
// one CTA per (batch, kv head, key tile): dK and dV of the tile, and its
// share of dQ into the key tile's partial.  Warp w < KG owns keys 16 w ..
// of the tile for S^T, P^T and dV; warp KG + w the same keys for dP^T,
// dS^T and dK.
template <class C>
__global__ void __launch_bounds__(C::THREADS) flash_bwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* const Ks = reinterpret_cast<float*>(smem);
  float* const Vs = Ks + C::BC * C::LD;
  float* const Pt = Vs + C::BC * C::LD;      // [BC][LDT]: P'^T (dS's share of P)
  float* const dSt = Pt + C::BC * C::LDT;    // [BC][LDT]: scale * dS^T
  float* const ring = dSt + C::BC * C::LDT;  // stage s at s * STAGE: Q, dO, lse, D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = warp % C::KG;
  const bool role_v = warp < C::KG;  // S, P, dV; else dP, dS, dK
  // the grid runs over (batch, kv head) fastest, then a key tile's
  // chunks of steps, then key tiles from the first: under causal the
  // heaviest CTAs start first
  const int nbk = p.B * p.KV;
  const int bk = blockIdx.x % nbk, rest = blockIdx.x / nbk;
  const int c = rest % p.nsplit, kt = rest / p.nsplit;
  const int b = bk / p.KV, kvh = bk - b * p.KV;
  const int k0 = kt * C::BC, G = p.H / p.KV;
  int qt_lo, qt_hi;
  query_tiles<C>(p, kt, qt_lo, qt_hi);
  const int nq = qt_hi - qt_lo;
  // this CTA's steps (query head it / nq, its (it % nq)-th query tile):
  // chunk c of the key tile's G * nq; chunk 0 stands for a key tile no
  // query sees
  const int it0 = c * p.chunk, it1 = min(G * nq, it0 + p.chunk);
  if (it0 > 0 && it0 >= it1) return;

  const float* kp = p.k + b * p.s[kK][0] + kvh * p.s[kK][1];
  const float* vp = p.v + b * p.s[kV][0] + kvh * p.s[kV][1];
  {
    const int rows = min(C::BC, p.Skv - k0);
    load_rows<C, C::BC>(Ks, kp + k0 * p.s[kK][2], kp, p.s[kK][2], rows, p.hd, p.vk);
    load_rows<C, C::BC>(Vs, vp + k0 * p.s[kV][2], vp, p.s[kV][2], rows, p.hd, p.vv);
  }
  cp_commit();

  // Q, dO, lse and D of step `it` into stage (it - it0) % NS
  auto load_stage = [&](int it) {
    float* const st = ring + ((it - it0) % C::NS) * C::STAGE;
    const int q0 = (qt_lo + it % nq) * C::BR;
    const long long h = (long long)kvh * G + it / nq;
    const float* qp = p.q + b * p.s[kQ][0] + h * p.s[kQ][1];
    const float* gp = p.dout + b * p.s[kDO][0] + h * p.s[kDO][1];
    const int rows = min(C::BR, p.Sq - q0);
    load_rows<C, C::BR>(st, qp + q0 * p.s[kQ][2], qp, p.s[kQ][2], rows, p.hd, p.vq);
    load_rows<C, C::BR>(st + C::BR * C::LD, gp + q0 * p.s[kDO][2], gp, p.s[kDO][2], rows,
                        p.hd, p.vdo);
    const long long r0 = ((long long)b * p.H + h) * p.Sq + q0;
    for (int i = threadIdx.x; i < 2 * C::BR; i += C::THREADS) {
      const int r = i % C::BR;
      const float* src = i < C::BR ? p.lse : p.delta;
      const bool in = r < rows;
      cp_async<4>(smem_u32(st + 2 * C::BR * C::LD + i), in ? src + r0 + r : src, in ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (it0 + s < it1) load_stage(it0 + s);
    cp_commit();
  }

  const int key0 = 16 * kw;  // the warp's first key in the tile
  const int kq = k0 + key0;
  const bool cap = p.softcap > 0.f;
  float acc[C::NT][4];  // dV (role v) or dK of the warp's keys
#pragma unroll
  for (int nn = 0; nn < C::NT; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  for (int it = it0; it < it1; ++it) {
    cp_wait<C::NS - 2>();  // step it (and K, V) landed, for this thread's copies
    __syncthreads();       // ... for every thread's; step it-1 consumed
    if (it + C::NS - 1 < it1) load_stage(it + C::NS - 1);
    cp_commit();
    const float* const Qs = ring + ((it - it0) % C::NS) * C::STAGE;
    const float* const dOs = Qs + C::BR * C::LD;
    const float* const lse_s = dOs + C::BR * C::LD;
    const float* const D_s = lse_s + C::BR;
    const int q0 = (qt_lo + it % nq) * C::BR;
    const long long h = (long long)kvh * G + it / nq;

    // the warp's keys are masked for every query of the tile: P = dS = 0,
    // no products, and zeros for dQ
    const bool masked = kq >= p.Skv || (p.causal && kq > q0 + C::BR - 1) ||
                        (p.window > 0 && q0 - (kq + 15) >= p.window);
    float x[C::NJ][4];  // S^T then P^T (role v); dP^T then scale * dS^T
    float* const own = Pt + (key0 + g) * C::LDT + 2 * t4;  // this lane's P'^T
    if (role_v) {
      // P^T, and P'^T = P^T o (1 - tanh^2) (softcap) or P^T for the dS warp
      if (!masked) {
        scores_t<C>(x, Ks + key0 * C::LD, Qs, lane);
        const bool edge = (p.causal && kq + 15 > q0) ||
                          (p.window > 0 && q0 + C::BR - 1 - kq >= p.window) ||
                          q0 + C::BR > p.Sq || kq + 16 > p.Skv;
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          float pw[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = 8 * j + 2 * t4 + (e & 1);
            const float sv = x[j][e] * p.scale;
            float xv = sv, th = 0.f;
            if (cap) {
              th = tanhf(sv / p.softcap);
              xv = p.softcap * th;
            }
            float pr = exp2_approx((xv - lse_s[qr]) * kLog2e);
            if (edge && !keep(p, q0 + qr, kq + g + 8 * (e >> 1))) pr = 0.f;
            x[j][e] = pr;
            pw[e] = cap ? pr * (1.f - th * th) : pr;
          }
          *reinterpret_cast<float2*>(own + 8 * j) = make_float2(pw[0], pw[1]);
          *reinterpret_cast<float2*>(own + 8 * j + 8 * C::LDT) = make_float2(pw[2], pw[3]);
        }
      }
    } else if (!masked) {
      scores_t<C>(x, Vs + key0 * C::LD, dOs, lane);
    }
    __syncthreads();  // P'^T of every key group stored
    if (role_v) {
      if (!masked) kv_update<C>(acc, x, dOs, g, t4);  // dV += P^T dO
    } else {
      // scale * dS^T = scale * P'^T o (dP^T - D), from this lane's own P'^T
      float* const ds = dSt + (key0 + g) * C::LDT + 2 * t4;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = 8 * j + 2 * t4 + (e & 1);
          const float pw = own[8 * j + 8 * C::LDT * (e >> 1) + (e & 1)];
          x[j][e] = masked ? 0.f : pw * (x[j][e] - D_s[qr]) * p.scale;
        }
        *reinterpret_cast<float2*>(ds + 8 * j) = make_float2(x[j][0], x[j][1]);
        *reinterpret_cast<float2*>(ds + 8 * j + 8 * C::LDT) = make_float2(x[j][2], x[j][3]);
      }
      if (!masked) kv_update<C>(acc, x, Qs, g, t4);  // dK += dS^T Q
    }
    __syncthreads();  // dS^T of every key group stored

    // this key tile's share of dQ for the query tile: units of 16 rows x
    // QC column tiles over the warps, each into the key tile's partial
    constexpr int NCH = (C::NT + C::QC - 1) / C::QC;
    float* const part = p.dq_part + (((long long)kt * p.B + b) * p.H + h) * p.Sq * p.hd;
    for (int u = warp; u < C::RGS * NCH; u += C::WARPS) {
      const int rg = u % C::RGS, ch = u / C::RGS;
      // the k-steps of keys some row of the unit may see: causal up to its
      // last row, a window from its first row's first key, keys below Skv
      const int r_lo = q0 + 16 * rg, r_hi = r_lo + 15;
      int kk_lo = 0, kk_hi = min(C::BC / 8, (p.Skv - k0 + 7) / 8);
      if (p.causal) kk_hi = r_hi < k0 ? 0 : min(kk_hi, (r_hi - k0) / 8 + 1);
      if (p.window > 0 && r_lo - p.window + 1 - k0 > 0)
        kk_lo = min(kk_hi, (r_lo - p.window + 1 - k0) / 8);
      float dq[C::QC][4];
      dq_unit<C>(dq, dSt, Ks, rg, ch, kk_lo, kk_hi, g, t4);
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int qi = r_lo + g + 8 * r2;
        if (qi >= p.Sq) continue;
        float* const row = part + (long long)qi * p.hd;
#pragma unroll
        for (int nn = 0; nn < C::QC; ++nn) {
          const int d = 8 * (ch * C::QC + nn) + 2 * t4;
          if (ch * C::QC + nn >= C::NT) continue;
          if ((p.hd & 1) == 0 && d + 1 < p.hd) {
            *reinterpret_cast<float2*>(row + d) = make_float2(dq[nn][2 * r2], dq[nn][2 * r2 + 1]);
          } else {
            if (d < p.hd) row[d] = dq[nn][2 * r2];
            if (d + 1 < p.hd) row[d + 1] = dq[nn][2 * r2 + 1];
          }
        }
      }
    }
  }
  cp_wait<0>();

  // dV or dK of the warp's keys, or this chunk's share of it
  const int w = role_v ? kDV : kDK;
  float* out;
  long long ss;
  if (p.nsplit == 1) {
    out = (role_v ? p.dv : p.dk) + b * p.s[w][0] + kvh * p.s[w][1];
    ss = p.s[w][2];
  } else {
    out = p.dkv_part + (((long long)(2 * c + (role_v ? 0 : 1)) * p.B + b) * p.KV + kvh) *
                           p.Skv * p.hd;
    ss = p.hd;
  }
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int kj = kq + g + 8 * r2;
    if (kj >= p.Skv) continue;
#pragma unroll
    for (int nn = 0; nn < C::NT; ++nn) {
      const int d = 8 * nn + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (d + e < p.hd) out[(long long)kj * ss + d + e] = acc[nn][2 * r2 + e];
    }
  }
}

// dQ[b, h, i, :] = the partials of the key tiles whose CTA visited row
// i's query tile qt, summed in key-tile order: one warp a row (grid
// (rows / 8, H, B)), lanes over 4-column groups where the rows take
// 16-byte accesses (p.v4), else over columns.  Key tile kt visits qt
// (`query_tiles`) iff kt * BC < (qt + 1) * BR under causal and, with a
// window, qt * BR < kt * BC + BC - 1 + window: a range [lo, hi).
template <class C>
__global__ void __launch_bounds__(kRowThreads) dq_reduce_kernel(const Params p) {
  const int i = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  if (i >= p.Sq) return;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.z, h = blockIdx.y;
  const long long plane = (long long)p.B * p.H * p.Sq * p.hd;  // one key tile's partial
  const float* part = p.dq_part + ((b * p.H + h) * p.Sq + i) * p.hd;
  float* const dq = p.dq + b * p.s[kDQ][0] + h * p.s[kDQ][1] + (long long)i * p.s[kDQ][2];
  const int qt = i / C::BR;
  int lo = 0, hi = (p.Skv + C::BC - 1) / C::BC;
  if (p.causal) hi = min(hi, ((qt + 1) * C::BR - 1) / C::BC + 1);
  if (p.window > 0 && qt * C::BR - C::BC + 1 >= p.window)
    lo = (qt * C::BR - C::BC + 1 - p.window) / C::BC + 1;
  if (p.v4) {
    for (int d = lane; d < p.hd / 4; d += 32) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kt = lo; kt < hi; ++kt) {
        const float4 x = reinterpret_cast<const float4*>(part + kt * plane)[d];
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
      reinterpret_cast<float4*>(dq)[d] = sum;
    }
  } else {
    for (int d = lane; d < p.hd; d += 32) {
      float sum = 0.f;
      for (int kt = lo; kt < hi; ++kt) sum += part[kt * plane + d];
      dq[d] = sum;
    }
  }
}

// dV and dK of key row j = the chunks' partials of its key tile, summed in
// chunk order: one warp a row (grid (Skv / 8, KV, B)), lanes over columns
template <class C>
__global__ void __launch_bounds__(kRowThreads) dkv_reduce_kernel(const Params p) {
  const int j = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  if (j >= p.Skv) return;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.z, kvh = blockIdx.y;
  int qt_lo, qt_hi;
  query_tiles<C>(p, j / C::BC, qt_lo, qt_hi);
  const int steps = p.H / p.KV * (qt_hi - qt_lo);
  const int chunks = steps > 0 ? (steps + p.chunk - 1) / p.chunk : 1;
  const long long plane = (long long)p.B * p.KV * p.Skv * p.hd;  // one chunk's dV or dK
  const float* part = p.dkv_part + ((b * p.KV + kvh) * p.Skv + j) * p.hd;
#pragma unroll
  for (int role = 0; role < 2; ++role) {
    const int w = role == 0 ? kDV : kDK;
    float* const out = (role == 0 ? p.dv : p.dk) + b * p.s[w][0] + kvh * p.s[w][1] +
                       (long long)j * p.s[w][2];
    for (int d = lane; d < p.hd; d += 32) {
      float sum = 0.f;
      for (int c = 0; c < chunks; ++c) sum += part[(2 * c + role) * plane + d];
      out[d] = sum;
    }
  }
}

template <int HDP>
int launch(Params& p, cudaStream_t stream) {
  using C = typename Plan<HDP>::type;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long opted_in = 0;  // per instantiation, by device
  if (dev < 64 && !(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    // the whole carveout as shared memory: two CTAs an SM up to hd 128
    err = cudaFuncSetAttribute(flash_bwd_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ull << dev;
  }
  const Split sp = split_of(p.B, p.H, p.KV, p.Sq, p.Skv, C::BC, C::BR);
  p.nsplit = sp.nsplit;
  p.chunk = sp.chunk;
  // one key tile: its share of dQ is dQ, written in place (dq contiguous)
  const long long hd = p.hd;
  const bool dq_dense = p.s[kDQ][2] == hd && p.s[kDQ][1] == p.Sq * hd &&
                        p.s[kDQ][0] == p.H * p.Sq * hd;
  if (sp.nkt == 1 && dq_dense) p.dq_part = p.dq;
  if (p.dq_part == nullptr || (sp.nsplit > 1 && p.dkv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 rows((p.Sq + kRowThreads / 32 - 1) / (kRowThreads / 32), p.H, p.B);
  const long long ctas = (long long)p.B * p.KV * sp.nkt * sp.nsplit;
  if (ctas > 0x7fffffffLL || p.H > 65535 || p.B > 65535) return (int)cudaErrorInvalidValue;
  delta_kernel<<<rows, kRowThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kernel<C><<<(unsigned)ctas, C::THREADS, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.dq_part != p.dq) {
    dq_reduce_kernel<C><<<rows, kRowThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (sp.nsplit > 1) {
    const dim3 keys((p.Skv + kRowThreads / 32 - 1) / (kRowThreads / 32), p.KV, p.B);
    dkv_reduce_kernel<C><<<keys, kRowThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// head dims padded to a multiple of 16 up to 128, and above to 256 (the
// zoo's only head dim above 128 is gemma2's 256)
constexpr int hdp_of(int hd) { return hd <= 128 ? (hd + 15) / 16 * 16 : 256; }

int launch_hdp(Params& p, cudaStream_t st) {
  switch (hdp_of(p.hd)) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 48: return launch<48>(p, st);
    case 64: return launch<64>(p, st);
    case 80: return launch<80>(p, st);
    case 96: return launch<96>(p, st);
    case 112: return launch<112>(p, st);
    case 128: return launch<128>(p, st);
    case 256: return launch<256>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tiling the backward takes for head_dim `hd`, into plan[0..5]: padded
// head dim, keys per CTA, query rows per tile, stages, threads per CTA and
// dynamic shared memory bytes.  Returns cudaErrorInvalidValue for a head
// dim outside 1..256.
extern "C" int flash_attention_bwd_plan(int hd, int* plan) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const int hdp = hdp_of(hd), br = br_of(hdp), bc = bc_of(hdp);
  plan[0] = hdp;
  plan[1] = bc;
  plan[2] = br;
  plan[3] = 2;
  plan[4] = 4 * bc;
  plan[5] = (int)smem_of(hdp, br, bc);
  return 0;
}

// The scratch a launch takes, into out[0..2]: floats of dq_part ([nkt, B,
// H, Sq, hd]; 0 where one key tile writes a contiguous dq in place),
// floats of dkv_part ([nsplit, 2, B, KV, Skv, hd]; 0 where nsplit is 1),
// and nsplit, the CTAs that share a key tile's query tiles.
extern "C" int flash_attention_bwd_scratch(int B, int H, int KV, int Sq, int Skv, int hd,
                                           long long* out) {
  if (hd < 1 || hd > 256 || KV < 1 || H % KV != 0 || B < 1 || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const int hdp = hdp_of(hd);
  const Split sp = split_of(B, H, KV, Sq, Skv, bc_of(hdp), br_of(hdp));
  out[0] = sp.nkt == 1 ? 0 : (long long)sp.nkt * B * H * Sq * hd;
  out[1] = sp.nsplit == 1 ? 0 : (long long)sp.nsplit * 2 * B * KV * Skv * hd;
  out[2] = sp.nsplit;
  return 0;
}

// Launch on `stream`; returns a cudaError_t (0 on success).  All f32.
// q [B, H, Sq, hd], k / v [B, KV, Skv, hd], out and dout [B, H, Sq, hd],
// and the outputs dq / dk / dv in the shapes of q / k / v, each with unit
// stride over hd and the (batch, head, seq) strides in `strides` (24
// values: q, k, v, out, dout, dq, dk, dv); lse (the forward's, natural
// units) and delta (scratch) contiguous [B, H, Sq]; dq_part and dkv_part
// scratch of `flash_attention_bwd_scratch`'s sizes (null where 0; dq_part
// null with one key tile asks for a contiguous dq).  Shapes the kernel
// does not take return cudaErrorInvalidValue without launching (also B or
// H above 65535); an empty problem launches nothing.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* out,
    const float* dout, const float* lse, float* dq, float* dk, float* dv,
    float* delta, float* dq_part, float* dkv_part, int B, int H, int KV, int Sq, int Skv,
    int hd,
    const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  if (hd < 1 || hd > 256 || KV < 1 || H % KV != 0 || window < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out; p.dout = dout; p.lse = lse;
  p.dq = dq; p.dk = dk; p.dv = dv; p.delta = delta;
  p.dq_part = dq_part; p.dkv_part = dkv_part;
  p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Skv = Skv; p.hd = hd;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  p.vq = vec_bytes(q, strides + 3 * kQ, 4);
  p.vk = vec_bytes(k, strides + 3 * kK, 4);
  p.vv = vec_bytes(v, strides + 3 * kV, 4);
  p.vdo = vec_bytes(dout, strides + 3 * kDO, 4);
  p.v4 = hd % 4 == 0 && p.vdo == 16 && vec_bytes(out, strides + 3 * kO, 4) == 16 &&
         vec_bytes(dq, strides + 3 * kDQ, 4) == 16;
  return launch_hdp(p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
