// Shared device code of the compressed-correction kernels
// (compress_correction.cu, pack_payload.cu): one CTA owns one row of a
// flattened correction leaf [R, C] and runs, in the row's compute type,
//
//   ceff = c + e                       feedback injection
//   thr  = k-th largest score          score = |ceff| (top-k) | u_sel (rand-k)
//   keep = score > thr, or score == thr among the first (k - #greater)
//          ties in index order         exact k, earliest index wins ties
//   q    = clamp(floor(u) + [u_rnd < u - floor(u)], -s, s),  u = kept * (s/safe)
//   chat = q * (safe * (1/s))          QSGD with the row's max-abs scale
//
// exactly as the plain versions (`kernels/ref.py`) do: every operation
// rounds once (the *_rn intrinsics, and the build passes -fmad=false), the
// weak-typed constants s and 1/s are rounded once to the compute type on
// the host's terms, and every comparison is an IEEE comparison, so NaN
// behaves as in JAX.
//
// The k-th largest score is found by an MSB-first radix select on an
// order-preserving key of the score's bits (8-bit digits: 4 passes in f32,
// 8 in f64), with a 256-bin shared-memory histogram per pass.  The key
// order is IEEE's total order, which is `jax.lax.top_k`'s: NaN (positive,
// as |x| makes it) ranks above +inf.
//
// The row is staged in dynamic shared memory when it fits (ceff, and the
// rand-k scores converted to the compute type); otherwise every pass
// recomputes ceff from global memory (streaming), which is slower but
// takes any row length.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowsel {

// dtype codes shared with the Python wrappers
enum DType : int { kF64 = 0, kF32 = 1, kBF16 = 2, kFP8E4M3 = 3 };

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ------------------------------------------------------- conversions
__device__ __forceinline__ double to_ct(double v, double) { return v; }
__device__ __forceinline__ double to_ct(float v, double) { return (double)v; }
__device__ __forceinline__ float to_ct(float v, float) { return v; }
__device__ __forceinline__ float to_ct(double v, float) { return __double2float_rn(v); }
__device__ __forceinline__ float to_ct(__nv_bfloat16 v, float) { return __bfloat162float(v); }
__device__ __forceinline__ float to_ct(__nv_fp8_e4m3 v, float) { return (float)v; }

// f32 -> fp8 e4m3 bits with JAX's overflow rule: NaN, infinities and
// |v| > 464 give NaN keeping the sign; the rest round to nearest even.
__device__ __forceinline__ unsigned char fp8_bits(float v) {
  const unsigned char sign = (unsigned char)((__float_as_uint(v) >> 24) & 0x80u);
  if (isnan(v) || fabsf(v) > 464.0f) return (unsigned char)(0x7Fu | sign);
  return (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

template <typename T> struct Store;
template <> struct Store<double> {
  __device__ static double of(double v) { return v; }
};
template <> struct Store<float> {
  __device__ static float of(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  __device__ static __nv_bfloat16 of(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Store<__nv_fp8_e4m3> {
  __device__ static __nv_fp8_e4m3 of(float v) {
    __nv_fp8_e4m3 out;
    out.__x = fp8_bits(v);
    return out;
  }
};

// JAX's fill value NaN in each storage type (what take_along_axis gives
// for an index past the row)
template <typename T> __device__ __forceinline__ T nan_of();
template <> __device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7FF8000000000000LL);
}
template <> __device__ __forceinline__ float nan_of<float>() {
  return __uint_as_float(0x7FC00000u);
}
template <> __device__ __forceinline__ __nv_bfloat16 nan_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0x7FC0u);
}
template <> __device__ __forceinline__ __nv_fp8_e4m3 nan_of<__nv_fp8_e4m3>() {
  __nv_fp8_e4m3 out;
  out.__x = 0x7F;
  return out;
}

// ------------------------------------------------- rounded arithmetic
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double absv(double v) { return fabs(v); }
__device__ __forceinline__ float absv(float v) { return fabsf(v); }
__device__ __forceinline__ double floorv(double v) { return floor(v); }
__device__ __forceinline__ float floorv(float v) { return floorf(v); }
__device__ __forceinline__ double from_host(double v, double) { return v; }
__device__ __forceinline__ float from_host(double v, float) { return __double2float_rn(v); }
// f -> int32 as XLA converts: toward zero, saturating, NaN -> 0 (the
// f64 conversion gives INT_MIN for NaN on the card, so NaN is explicit)
__device__ __forceinline__ int to_i32(double v) { return isnan(v) ? 0 : __double2int_rz(v); }
__device__ __forceinline__ int to_i32(float v) { return isnan(v) ? 0 : __float2int_rz(v); }
__device__ __forceinline__ double from_i32(int v, double) { return __int2double_rn(v); }
__device__ __forceinline__ float from_i32(int v, float) { return __int2float_rn(v); }

// max that propagates NaN, as jnp.max / torch.amax do
template <typename Acc>
__device__ __forceinline__ Acc max_nan(Acc a, Acc b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// ------------------------------------------- IEEE total-order keys
__device__ __forceinline__ uint32_t okey(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ uint64_t okey(double v) {
  const uint64_t b = (uint64_t)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | (1ull << 63));
}
__device__ __forceinline__ float from_okey(uint32_t k, float) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}
__device__ __forceinline__ double from_okey(uint64_t k, double) {
  return __longlong_as_double(
      (long long)((k >> 63) ? (k & 0x7FFFFFFFFFFFFFFFull) : ~k));
}
template <typename Acc> struct KeyOf;
template <> struct KeyOf<float> { using type = uint32_t; };
template <> struct KeyOf<double> { using type = uint64_t; };

// ------------------------------------------------- block primitives
// Scratch in static shared memory, the same for every instantiation.
struct Shared {
  int hist[256];
  int warp[kWarps];
  int misc[4];
  double red[kWarps];
};

__device__ __forceinline__ int block_sum(int v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh.warp[w] = v;
  __syncthreads();
  int t = lane < kWarps ? sh.warp[lane] : 0;
  for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  return t;
}

// exclusive prefix sum over the block in thread order; *total = the sum
__device__ __forceinline__ int block_scan(int v, Shared& sh, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();
  if (lane == 31) sh.warp[w] = incl;
  __syncthreads();
  const int ws = lane < kWarps ? sh.warp[lane] : 0;
  int winc = ws;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, winc, o);
    if (lane >= o) winc += t;
  }
  const int before = __shfl_sync(kFull, winc - ws, w);
  *total = __shfl_sync(kFull, winc, 31);
  return before + incl - v;
}

template <typename Acc>
__device__ __forceinline__ Acc block_max_nan(Acc v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = max_nan(v, (Acc)__shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh.red[w] = (double)v;
  __syncthreads();
  Acc t = lane < kWarps ? (Acc)sh.red[lane] : (Acc)0;
  for (int o = 16; o; o >>= 1) t = max_nan(t, (Acc)__shfl_xor_sync(kFull, t, o));
  return t;
}

// ------------------------------------------------------- one row
template <typename T, typename Acc, typename U>
struct Row {
  const T* c;       // [n]
  const T* e;       // [n] or null
  const U* us;      // [n] rand-k scores or null
  const U* ur;      // [n] rounding uniforms or null
  Acc* s_ceff;      // staged ceff [n] or null (streaming)
  Acc* s_sel;       // staged rand-k scores [n] or null
  int n;
  bool topk;

  __device__ __forceinline__ Acc ceff(int i) const {
    if (s_ceff) return s_ceff[i];
    const Acc v = to_ct(c[i], Acc());
    return e ? add_rn(v, to_ct(e[i], Acc())) : v;
  }
  __device__ __forceinline__ Acc score(int i) const {
    if (topk) return absv(ceff(i));
    return s_sel ? s_sel[i] : to_ct(us[i], Acc());
  }
  // stage ceff (and the rand-k scores) in shared memory
  __device__ void stage(bool select) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const Acc v = to_ct(c[i], Acc());
      s_ceff[i] = e ? add_rn(v, to_ct(e[i], Acc())) : v;
      if (select && !topk) s_sel[i] = to_ct(us[i], Acc());
    }
    __syncthreads();
  }
};

// key of the k-th largest score of the row (1 <= k <= n)
template <typename T, typename Acc, typename U>
__device__ typename KeyOf<Acc>::type radix_kth_largest(const Row<T, Acc, U>& row,
                                                       int k, Shared& sh) {
  using Key = typename KeyOf<Acc>::type;
  constexpr int kBits = (int)sizeof(Key) * 8;
  Key prefix = 0, pmask = 0;
  int kk = k;
  for (int shift = kBits - 8; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += kThreads) sh.hist[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < row.n; i += kThreads) {
      const Key key = okey(row.score(i));
      if ((key & pmask) == prefix) atomicAdd(&sh.hist[(int)((key >> shift) & 0xFF)], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l owns bins 255-8l down to 248-8l; scan from the top bin
      const int lane = threadIdx.x;
      int local = 0;
      for (int j = 0; j < 8; ++j) local += sh.hist[255 - 8 * lane - j];
      int incl = local;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned ball = __ballot_sync(kFull, incl >= kk);
      if (lane == __ffs(ball) - 1) {
        int above = incl - local;
        int d = 255 - 8 * lane;
        for (int j = 0; j < 8; ++j, --d) {
          const int h = sh.hist[d];
          if (above + h >= kk) break;
          above += h;
        }
        sh.misc[0] = d;
        sh.misc[1] = kk - above;
      }
    }
    __syncthreads();
    prefix |= (Key)sh.misc[0] << shift;
    pmask |= (Key)0xFF << shift;
    kk = sh.misc[1];
    __syncthreads();
  }
  return prefix;
}

// The selection of one row: thr and the number of ties to keep.
template <typename Acc>
struct Selection {
  bool select;  // false: k covers the row, every entry is kept
  Acc thr;
  int need;     // ties kept: k - #(score > thr)
  int kept;     // entries kept in all (< k only for a row with NaN scores)
};

template <typename T, typename Acc, typename U>
__device__ Selection<Acc> select_row(const Row<T, Acc, U>& row, int k, Shared& sh) {
  Selection<Acc> sel{false, (Acc)0, 0, row.n};
  if (k >= row.n) return sel;
  sel.select = true;
  sel.thr = from_okey(radix_kth_largest(row, k, sh), Acc());
  int gt = 0, tie = 0;
  for (int i = threadIdx.x; i < row.n; i += kThreads) {
    const Acc s = row.score(i);
    gt += s > sel.thr;
    tie += s == sel.thr;
  }
  const int n_gt = block_sum(gt, sh);
  const int n_tie = block_sum(tie, sh);
  sel.need = k - n_gt;
  sel.kept = n_gt + (n_tie < sel.need ? n_tie : sel.need);
  return sel;
}

// Walk the row in chunks of kThreads columns, in index order, calling
// body(i, in_row, keep) for every thread of every chunk (the whole block
// takes part in every call, so body may use block primitives).
template <typename T, typename Acc, typename U, typename Body>
__device__ void for_each_kept(const Row<T, Acc, U>& row, const Selection<Acc>& sel,
                              Shared& sh, Body body) {
  int ties_before = 0;
  for (int base = 0; base < row.n; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool in = i < row.n;
    bool keep = in;
    if (sel.select) {
      const Acc s = in ? row.score(i) : (Acc)0;
      const bool gt = in && s > sel.thr;
      const bool tie = in && s == sel.thr;
      int total;
      const int ex = block_scan(tie ? 1 : 0, sh, &total);
      keep = gt || (tie && ties_before + ex + 1 <= sel.need);
      ties_before += total;
    }
    body(i, in, keep);
  }
}

// QSGD constants of one row
template <typename Acc>
struct Quant {
  bool on;     // bits < 32
  Acc s;       // 2^(bits-1) - 1 in the compute type
  Acc r;       // s / safe
  Acc t;       // safe * (1/s)
  Acc scale;   // max |kept| (what the wire stores)
};

template <typename T, typename Acc, typename U>
__device__ Quant<Acc> quant_row(const Row<T, Acc, U>& row, const Selection<Acc>& sel,
                                int bits, double s_host, double inv_s_host, Shared& sh) {
  Quant<Acc> qc{bits < 32, from_host(s_host, Acc()), (Acc)0, (Acc)0, (Acc)0};
  if (!qc.on) return qc;
  Acc m = 0;  // |kept| >= 0, so 0 is the identity of the max
  for_each_kept(row, sel, sh, [&](int i, bool in, bool keep) {
    if (in && keep) m = max_nan(m, absv(row.ceff(i)));
  });
  qc.scale = block_max_nan(m, sh);
  const Acc safe = qc.scale > (Acc)0 ? qc.scale : (Acc)1;
  qc.r = div_rn(qc.s, safe);
  qc.t = mul_rn(safe, from_host(inv_s_host, Acc()));
  return qc;
}

// the integer-valued level q of one kept value (before the + s offset)
template <typename Acc, typename U>
__device__ __forceinline__ Acc level(Acc kept, const U* ur, int i, const Quant<Acc>& qc) {
  const Acc u = mul_rn(kept, qc.r);
  const Acc lo = floorv(u);
  const Acc inc = to_ct(ur[i], Acc()) < sub_rn(u, lo) ? (Acc)1 : (Acc)0;
  const Acc q = add_rn(lo, inc);
  return q < -qc.s ? -qc.s : (q > qc.s ? qc.s : q);  // NaN stays NaN
}

// largest dynamic shared memory a CTA of `Kernel` may take on this card
// (set as the kernel's limit at first use)
template <auto Kernel>
int max_dynamic_smem() {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&fa, Kernel) != cudaSuccess) {
      return 0;
    }
    const int avail = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             avail) != cudaSuccess) {
      return 0;
    }
    cached = avail;
  }
  return cached;
}

}  // namespace rowsel
