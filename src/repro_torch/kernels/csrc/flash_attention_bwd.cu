// Backward of the blocked online-softmax (flash) attention, f32, for
// Hopper (sm_90a).
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
// Three kernels, launched in order on one stream:
//   * delta_kernel: one warp a row, D = rowsum(dO o out);
//   * dkdv_kernel: one CTA a key tile of one (batch, kv head); it keeps
//     the tile's dK and dV in registers and walks its G query heads and,
//     within each, the query tiles that may see the tile (causal: from
//     the tile's first key; window: up to its last key + window - 1);
//   * dq_kernel: one CTA a query tile of one (batch, head), walking the
//     key tiles its rows may see.
// No float atomics: every sum runs in a fixed order (heads, then query
// tiles, then rows within a tile; key tiles, then keys), so two calls give
// the same bits.
//
// Bound: operations, 10 * hd flops per unmasked (query, key) pair beside
// the forward's 4 (the recomputed q k^T and dO v^T, P^T dO, ds^T q and
// ds k).  This first kernel runs them on the CUDA cores in f32 (67
// TFLOP/s): tiles of T = 32 (hd <= 128) or 16 (hd > 128) rows of q, k, v
// and dO stage through shared memory, each thread accumulating its share
// of the tile's dK / dV (or dQ) in registers.  The tensor cores (the
// forward's 3xTF32 `mma.sync`) are later work.  Rows that no key may see
// (a window past Skv) get dQ = 0 and add nothing to dK / dV: outside the
// gradient's contract.  Offsets are 64-bit throughout.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *delta;
  int B, H, KV, Sq, Skv, hd;
  // (batch, head, seq) strides of q, k, v, o, dO, dQ, dK, dV
  long long s[8][3];
  int causal, window;
  float softcap, scale;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ bool keep(const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Skv) return false;
  if (p.causal && qi < kj) return false;
  if (p.window > 0 && qi - kj >= p.window) return false;
  return true;
}

// D[b, h, i] = sum_d dO * out, one warp a row, lanes over d, then a fixed
// shuffle tree
__global__ void __launch_bounds__(kThreads) delta_kernel(const Params p) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / p.Sq, i = row - bh * p.Sq;
  const long long b = bh / p.H, h = bh - b * p.H;
  const float* o = p.o + b * p.s[kO][0] + h * p.s[kO][1] + i * p.s[kO][2];
  const float* g = p.dout + b * p.s[kDO][0] + h * p.s[kDO][1] + i * p.s[kDO][2];
  float acc = 0.f;
  for (int d = lane; d < p.hd; d += 32) acc += o[d] * g[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// rows [r0, r0 + T) of a [*, hd] operand at `base` (row stride `ss`) into
// shared memory rows of LD floats, zero past `rows` and past hd
template <int HDP, int T>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long ss,
                                          int r0, int rows, int hd) {
  constexpr int LD = HDP + 1;
  for (int e = threadIdx.x; e < T * HDP; e += kThreads) {
    const int r = e / HDP, d = e - r * HDP;
    const int gr = r0 + r;
    dst[r * LD + d] = (gr < rows && d < hd) ? base[(long long)gr * ss + d] : 0.f;
  }
}

// P and scale * ds of a (query tile, key tile) pair into Ps / dSs [T][T+1]
template <int HDP, int T>
__device__ __forceinline__ void scores(const Params& p, const float* Qs, const float* Ks,
                                       const float* Vs, const float* dOs,
                                       const float* lse_s, const float* D_s, int q0,
                                       int k0, float* Ps, float* dSs) {
  constexpr int LD = HDP + 1;
  const bool cap = p.softcap > 0.f;
  for (int e = threadIdx.x; e < T * T; e += kThreads) {
    const int i = e / T, j = e - i * T;
    const float* qr = Qs + i * LD;
    const float* kr = Ks + j * LD;
    const float* gr = dOs + i * LD;
    const float* vr = Vs + j * LD;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      s += qr[d] * kr[d];
      dp += gr[d] * vr[d];
    }
    s *= p.scale;
    float pr = 0.f, ds = 0.f;
    if (keep(p, q0 + i, k0 + j)) {
      float x = s, th = 0.f;
      if (cap) {
        th = tanhf(s / p.softcap);
        x = p.softcap * th;
      }
      pr = expf(x - lse_s[i]);
      ds = pr * (dp - D_s[i]);
      if (cap) ds *= 1.f - th * th;
    }
    Ps[i * (T + 1) + j] = pr;
    dSs[i * (T + 1) + j] = ds * p.scale;
  }
}

template <int HDP, int T>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * T * (HDP + 1) + 2 * T * (T + 1) + 2 * T);
}

// one CTA per (batch, kv head, key tile): dK and dV of the tile
template <int HDP, int T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params p) {
  constexpr int LD = HDP + 1, R = T * HDP / kThreads;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* dOs = Qs + T * LD;
  float* Ps = dOs + T * LD;
  float* dSs = Ps + T * (T + 1);
  float* lse_s = dSs + T * (T + 1);
  float* D_s = lse_s + T;

  const long long nkt = (p.Skv + T - 1) / T;
  const long long bk = blockIdx.x / nkt;
  const int k0 = (int)(blockIdx.x - bk * nkt) * T;
  const long long b = bk / p.KV, kvh = bk - b * p.KV;
  const int G = p.H / p.KV;

  load_tile<HDP, T>(Ks, p.k + b * p.s[kK][0] + kvh * p.s[kK][1], p.s[kK][2], k0, p.Skv, p.hd);
  load_tile<HDP, T>(Vs, p.v + b * p.s[kV][0] + kvh * p.s[kV][1], p.s[kV][2], k0, p.Skv, p.hd);

  float dk[R], dv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dk[r] = dv[r] = 0.f;

  // the queries that may see a key of this tile
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = (int)min((long long)q_hi, (long long)k0 + T - 1 + p.window);

  for (int g = 0; g < G; ++g) {
    const long long h = kvh * G + g;
    const float* qb = p.q + b * p.s[kQ][0] + h * p.s[kQ][1];
    const float* gb = p.dout + b * p.s[kDO][0] + h * p.s[kDO][1];
    const float* lb = p.lse + (b * p.H + h) * p.Sq;
    const float* db = p.delta + (b * p.H + h) * p.Sq;
    for (int q0 = q_lo / T * T; q0 < q_hi; q0 += T) {
      __syncthreads();  // the previous tile's Ps / dSs / Qs are consumed
      load_tile<HDP, T>(Qs, qb, p.s[kQ][2], q0, p.Sq, p.hd);
      load_tile<HDP, T>(dOs, gb, p.s[kDO][2], q0, p.Sq, p.hd);
      for (int i = threadIdx.x; i < T; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        lse_s[i] = in ? lb[q0 + i] : 0.f;
        D_s[i] = in ? db[q0 + i] : 0.f;
      }
      __syncthreads();
      scores<HDP, T>(p, Qs, Ks, Vs, dOs, lse_s, D_s, q0, k0, Ps, dSs);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = threadIdx.x + r * kThreads;
        const int j = e / HDP, d = e - j * HDP;
        float av = dv[r], ak = dk[r];
#pragma unroll 4
        for (int i = 0; i < T; ++i) {
          av += Ps[i * (T + 1) + j] * dOs[i * LD + d];
          ak += dSs[i * (T + 1) + j] * Qs[i * LD + d];
        }
        dv[r] = av;
        dk[r] = ak;
      }
    }
  }

  float* dkb = p.dk + b * p.s[kDK][0] + kvh * p.s[kDK][1];
  float* dvb = p.dv + b * p.s[kDV][0] + kvh * p.s[kDV][1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int j = e / HDP, d = e - j * HDP;
    if (k0 + j < p.Skv && d < p.hd) {
      dkb[(long long)(k0 + j) * p.s[kDK][2] + d] = dk[r];
      dvb[(long long)(k0 + j) * p.s[kDV][2] + d] = dv[r];
    }
  }
}

// one CTA per (batch, head, query tile): dQ of the tile
template <int HDP, int T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int LD = HDP + 1, R = T * HDP / kThreads;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* dOs = Qs + T * LD;
  float* Ps = dOs + T * LD;
  float* dSs = Ps + T * (T + 1);
  float* lse_s = dSs + T * (T + 1);
  float* D_s = lse_s + T;

  const long long nqt = (p.Sq + T - 1) / T;
  const long long bh = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x - bh * nqt) * T;
  const long long b = bh / p.H, h = bh - b * p.H;
  const long long kvh = h / (p.H / p.KV);

  load_tile<HDP, T>(Qs, p.q + b * p.s[kQ][0] + h * p.s[kQ][1], p.s[kQ][2], q0, p.Sq, p.hd);
  load_tile<HDP, T>(dOs, p.dout + b * p.s[kDO][0] + h * p.s[kDO][1], p.s[kDO][2], q0, p.Sq,
                    p.hd);
  for (int i = threadIdx.x; i < T; i += kThreads) {
    const bool in = q0 + i < p.Sq;
    lse_s[i] = in ? p.lse[bh * p.Sq + q0 + i] : 0.f;
    D_s[i] = in ? p.delta[bh * p.Sq + q0 + i] : 0.f;
  }

  float dq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dq[r] = 0.f;

  // the keys some row of this tile may see
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q0 + T);
  const float* kb = p.k + b * p.s[kK][0] + kvh * p.s[kK][1];
  const float* vb = p.v + b * p.s[kV][0] + kvh * p.s[kV][1];
  for (int k0 = k_lo / T * T; k0 < k_hi; k0 += T) {
    __syncthreads();
    load_tile<HDP, T>(Ks, kb, p.s[kK][2], k0, p.Skv, p.hd);
    load_tile<HDP, T>(Vs, vb, p.s[kV][2], k0, p.Skv, p.hd);
    __syncthreads();
    scores<HDP, T>(p, Qs, Ks, Vs, dOs, lse_s, D_s, q0, k0, Ps, dSs);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int i = e / HDP, d = e - i * HDP;
      float a = dq[r];
#pragma unroll 4
      for (int j = 0; j < T; ++j) a += dSs[i * (T + 1) + j] * Ks[j * LD + d];
      dq[r] = a;
    }
  }

  float* dqb = p.dq + b * p.s[kDQ][0] + h * p.s[kDQ][1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int i = e / HDP, d = e - i * HDP;
    if (q0 + i < p.Sq && d < p.hd) dqb[(long long)(q0 + i) * p.s[kDQ][2] + d] = dq[r];
  }
}

template <int HDP, int T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP, T>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long opted_in = 0;  // per instantiation, by device
  if (smem > 48 * 1024 && dev < 64 && !(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(dkdv_kernel<HDP, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(dq_kernel<HDP, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ull << dev;
  }
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long kv_ctas = (long long)p.B * p.KV * ((p.Skv + T - 1) / T);
  const long long q_ctas = (long long)p.B * p.H * ((p.Sq + T - 1) / T);
  if (delta_blocks > 0x7fffffffLL || kv_ctas > 0x7fffffffLL || q_ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  delta_kernel<<<(unsigned)delta_blocks, kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<HDP, T><<<(unsigned)kv_ctas, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<HDP, T><<<(unsigned)q_ctas, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// head dims padded as the forward pads them: every multiple of 16 up to
// 128 (key / query tiles of 32), then 160, 192, 224, 256 (tiles of 16)
constexpr int hdp_of(int hd) {
  return hd <= 128 ? (hd + 15) / 16 * 16 : (hd + 31) / 32 * 32;
}

int launch_hdp(const Params& p, cudaStream_t st) {
  switch (hdp_of(p.hd)) {
    case 16: return launch<16, 32>(p, st);
    case 32: return launch<32, 32>(p, st);
    case 48: return launch<48, 32>(p, st);
    case 64: return launch<64, 32>(p, st);
    case 80: return launch<80, 32>(p, st);
    case 96: return launch<96, 32>(p, st);
    case 112: return launch<112, 32>(p, st);
    case 128: return launch<128, 32>(p, st);
    case 160: return launch<160, 16>(p, st);
    case 192: return launch<192, 16>(p, st);
    case 224: return launch<224, 16>(p, st);
    case 256: return launch<256, 16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  All f32.
// q [B, H, Sq, hd], k / v [B, KV, Skv, hd], out and dout [B, H, Sq, hd],
// and the outputs dq / dk / dv in the shapes of q / k / v, each with unit
// stride over hd and the (batch, head, seq) strides in `strides` (24
// values: q, k, v, out, dout, dq, dk, dv); lse (the forward's, natural
// units) and delta (scratch) contiguous [B, H, Sq].  Shapes the kernel
// does not take return cudaErrorInvalidValue without launching; an empty
// problem launches nothing.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* out,
    const float* dout, const float* lse, float* dq, float* dk, float* dv,
    float* delta, int B, int H, int KV, int Sq, int Skv, int hd,
    const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  if (hd < 1 || hd > 256 || KV < 1 || H % KV != 0 || window < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out; p.dout = dout; p.lse = lse;
  p.dq = dq; p.dk = dk; p.dv = dv; p.delta = delta;
  p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Skv = Skv; p.hd = hd;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  return launch_hdp(p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
