// Blocked online-softmax (flash) attention, forward, for Hopper (sm_90a).
//
// Replaces `repro/kernels/flash_attention.py` `flash_attention` (the
// Pallas TPU kernel `_flash_kernel`): out = softmax(mask(cap(q k^T /
// sqrt(hd)))) v per (batch, head), with
//   * tile-index positions: query i sits at position i, key j at j;
//   * causal (i >= j) and sliding-window (i - j < window) masks, filled
//     with the finite -1e30 of the TPU kernel, so that a row whose first
//     needed tile is fully masked averages uniformly until its first real
//     key, whose rescale exp(-1e30 - m) = 0 wipes that average;
//   * the Gemma-2 logit softcap cap(s) = softcap * tanh(s / softcap);
//   * tiles that the masks exclude entirely skipped (the TPU kernel's
//     `needed` test), the denominator clamped at 1e-30.
// Beyond the TPU kernel: any Sq and Skv (ragged ends are masked here:
// keys past Skv get exactly zero weight, queries past Sq are not
// stored), any head_dim up to 256 (112 for zamba2, 256 for gemma2), q/k/v
// read through their (batch, head, seq) strides so the model's
// [B, S, H, hd] layout needs no transpose, and grouped-query attention
// natively: q-head h reads kv-head h / (H / KV), with no repeated K/V.
//
// Bound: at the serving shapes it is compute: 4 * hd flops per unmasked
// (query, key) pair against the card's 67 TFLOP/s of f32 outside the
// tensor cores, over q + k + v + out bytes at 3.35 TB/s.  This first
// kernel is simple and correct, on CUDA cores in f32: one CTA of 256
// threads per (batch*head, 64-query tile); Q is staged once, transposed,
// in shared memory; 64-key K/V tiles stream through shared memory; each
// thread owns a 4x4 block of the score tile and 4 rows x 4*NJ columns of
// the output, so the running max, denominator and accumulator stay in
// registers in f32.  Inputs are f32 or bf16, read in their own type; the
// output is in q's type.  Tensor cores (wgmma on bf16), TMA and
// asynchronous double buffering are later work.  Built with FMA
// contraction (no -fmad=false): the result is held to a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// dtype codes shared with kernels/flash_attention.py
enum DType : int { kF32 = 1, kBF16 = 2 };

constexpr int BQ = 64;           // queries per CTA
constexpr int BK = 64;           // keys per streamed tile
constexpr int kThreads = 256;    // 16 x 16 threads, each 4 rows x 4 keys
constexpr int PADQ = BQ + 4;     // row stride of Qt and Pt (floats)
constexpr int PADK = BK + 4;     // row stride of Kt
constexpr float kMaskFill = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Skv, hd, hd16;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NJ: float4 column groups of the output per thread (ceil(hd16 / 64))
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* const Qt = reinterpret_cast<float*>(smem4);  // [hd16][PADQ]
  float* const Kt = Qt + p.hd16 * PADQ;                // [hd16][PADK]
  float* const Vs = Kt + p.hd16 * PADK;                // [BK][hd16]
  float* const Pt = Vs + BK * p.hd16;                  // [BK][PADQ]

  const int hd = p.hd, hd16 = p.hd16;
  const int bh = blockIdx.x;
  // heaviest (last, under causal) query tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const T* qp = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kp = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  T* op = static_cast<T*>(p.o) + b * p.osb + h * p.osh;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // Q tile, transposed: Qt[d][r] = q[q0 + r][d], zero past Sq and hd
  for (int idx = tid; idx < BQ * hd16; idx += kThreads) {
    const int r = idx / hd16, d = idx - r * hd16;
    float val = 0.f;
    if (q0 + r < p.Sq && d < hd) val = load_f(qp + (long long)(q0 + r) * p.qss + d);
    Qt[d * PADQ + r] = val;
  }

  // the key tiles some query of this tile needs (the TPU kernel's
  // `needed`): causal stops after the last query, a window starts at the
  // first query's first visible key
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) acc[i][e] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Qt written; the previous tile's readers are done
    for (int idx = tid; idx < BK * hd16; idx += kThreads) {
      const int c = idx / hd16, d = idx - c * hd16;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < p.Skv && d < hd) {
        kv = load_f(kp + (long long)(k0 + c) * p.kss + d);
        vv = load_f(vp + (long long)(k0 + c) * p.vss + d);
      }
      Kt[d * PADK + c] = kv;
      Vs[c * hd16 + d] = vv;
    }
    __syncthreads();

    // scores of rows 4ty..4ty+3 against keys 4tx..4tx+3
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * PADQ + 4 * ty);
      const float4 kk = *reinterpret_cast<const float4*>(Kt + d * PADK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = true;
        if (p.causal) keep = keep && qi >= kj;
        if (p.window > 0) keep = keep && qi - kj < p.window;
        x = keep ? x : kMaskFill;
        if (kj >= p.Skv) x = -INFINITY;  // past the sequence: no weight
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's part of the row sum
#pragma unroll
      for (int e = 0; e < 4 * NJ; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }

    // P transposed into shared memory: Pt[key][row]
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * PADQ + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[rows 4ty.., cols 4tx + 64jj ..] += P V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv4 = *reinterpret_cast<const float4*>(Pt + c * PADQ + 4 * ty);
      const float pv[4] = {pv4.x, pv4.y, pv4.z, pv4.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = 4 * tx + 64 * jj;
        if (d < hd16) {
          const float4 v4 = *reinterpret_cast<const float4*>(Vs + c * hd16 + d);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][4 * jj + e] += pv[i] * vv[e];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(row_sum16(l[i]), 1e-30f);
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.Sq) continue;
    T* orow = op + (long long)qi * p.oss;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * jj + e;
        if (d < hd) store_f(orow + d, acc[i][4 * jj + e] / denom);
      }
  }
}

size_t smem_bytes(int hd16) {
  return ((size_t)hd16 * PADQ + (size_t)hd16 * PADK + (size_t)BK * hd16 +
          (size_t)BK * PADQ) * sizeof(float);
}

template <typename T, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd16);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nj(const Params& p, cudaStream_t stream) {
  switch ((p.hd16 + 63) / 64) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 4: return launch<T, 4>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  q [B, H, Sq,
// hd], k/v [B, KV, Skv, hd] and out [B, H, Sq, hd], each with unit stride
// over hd and the (batch, head, seq) strides given in `strides` (12
// values: q, k, v, out), all of one dtype.  Shapes the kernel does not
// take (hd outside 1..256, KV not dividing H) return
// cudaErrorInvalidValue without launching; an empty problem launches
// nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KV, int Sq, int Skv, int hd,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      int dtype, void* stream) {
  if (hd < 1 || hd > 256 || KV < 1 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out;
  p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Skv = Skv; p.hd = hd;
  p.hd16 = (hd + 15) / 16 * 16;
  p.qsb = strides[0]; p.qsh = strides[1]; p.qss = strides[2];
  p.ksb = strides[3]; p.ksh = strides[4]; p.kss = strides[5];
  p.vsb = strides[6]; p.vsh = strides[7]; p.vss = strides[8];
  p.osb = strides[9]; p.osh = strides[10]; p.oss = strides[11];
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_nj<float>(p, st);
    case kBF16: return launch_nj<__nv_bfloat16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
