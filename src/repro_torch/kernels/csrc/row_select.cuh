// Shared device code of the compressed-correction kernels
// (compress_correction.cu, pack_payload.cu).  Per row of a flattened
// correction leaf [R, C], in the row's compute type:
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
// behaves as in JAX.  Scores are ranked by order-preserving keys of their
// bits (IEEE's total order, which is `jax.lax.top_k`'s: NaN, positive as
// |x| makes it, ranks above +inf).
//
// Two front ends compute thr, the ties kept and the scale:
//
// * streaming (`Row`, `select_row`, `for_each_kept`, `quant_row`): one CTA
//   of kThreads per row, an MSB-first radix select with 8-bit digits (4
//   passes in f32, 8 in f64) and a 256-bin shared-memory histogram per
//   pass; ceff is recomputed from global memory on every pass, so it takes
//   any row length.  Rows too long for the staged front end take it.
//
// * staged (`Staged`, shared with pack_kernel): the row, or a CTA's
//   contiguous slice of it, is read once, in 16-byte vectors, into shared
//   memory as ceff (and the rand-k scores), and everything after runs
//   there.  A warp owns a contiguous run of the slice, a lane 4
//   consecutive columns at a time, so a count "before column i" is a
//   scan over CTAs, then warps, plus a warp scan per step.
//     select  an exact radix select on d = max key - key, starting at d's
//             top bit: the first digit sorts the row by binade instead of
//             piling it into the few bins of its sign and top exponent
//             bits.  Once a digit has narrowed a CTA's candidates, they are
//             compacted into a list in shared memory and later digits read
//             only that list; at 32 or fewer in the row, one warp ranks
//             them directly.
//     count   one pass counts each warp's gt (score > thr) and tie columns
//             and their max |ceff|, and keeps each group's flags for the
//             write: the row's scale (max |kept|) is the max over gt
//             joined with the kept ties (thr itself for top-k; rand-k
//             walks the ties only when some are dropped).
//   With kCluster the row is split over a thread-block cluster, CTA r of
//   the cluster taking the r-th contiguous slice of its 4-column groups.
//   The cluster joins each step through distributed shared memory: every
//   CTA stores what the others need into its own slot of every CTA's
//   scratch with `st.async`, each store counted on the receiver's mbarrier
//   of that exchange, and reads the slots it holds once the exchange's
//   bytes have all come -- the min / max keys, each pass's 256-bin
//   histogram (every CTA sums them and takes the same digit; the slots
//   alternate by pass parity: a rank sends pass p + 2 only after it holds
//   every rank's pass p + 1, so after their reads of pass p), the last
//   <= 32 candidates, the gt / tie counts and max |ceff| of each CTA (a
//   CTA's ties before its slice are the ties of the lower ranks, so the
//   earliest index still wins) and, for rand-k, the max over the kept
//   ties.  Every CTA computes the same thr, need and scale.  One cluster
//   barrier, after the mbarriers are armed and before the first store,
//   is the only one: no CTA reads another's shared memory, and a CTA
//   leaves only once every store meant for it has landed.  (A cluster
//   barrier, or a read of another CTA's shared memory, is a long-latency
//   step, and at the strategies' [16, 4096] the select is a chain of
//   them: an exchange that waits only for its own bytes keeps each step
//   to one remote store's latency.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
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
  int n;
  bool topk;

  __device__ __forceinline__ Acc ceff(int i) const {
    const Acc v = to_ct(c[i], Acc());
    return e ? add_rn(v, to_ct(e[i], Acc())) : v;
  }
  __device__ __forceinline__ Acc score(int i) const {
    if (topk) return absv(ceff(i));
    return to_ct(us[i], Acc());
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


// ============================================================ staged route
constexpr int kGroup = 4;  // consecutive columns a lane takes at once
constexpr int kRank = 32;  // candidates one warp ranks directly

// kGroup values of X, loaded or stored as one (or two) vector accesses
template <typename X>
struct alignas(sizeof(X) * kGroup < 16 ? sizeof(X) * kGroup : 16) Group {
  X v[kGroup];
};

// shared-memory positions of a row: column i sits at i + o, o < kGroup,
// so that position groups are global vector groups; padded to a group
__host__ __device__ __forceinline__ int padded(int n) {
  return (n + 2 * kGroup - 2) / kGroup * kGroup;
}
// capacity of each of the two candidate lists of a CTA that holds
// `groups` groups
__host__ __device__ __forceinline__ int list_cap_of(int groups) {
  const int c = (groups + 3) / 4 * 4;
  return c < kRank ? kRank : c;
}
// ... of a CTA that holds a whole row of n
__host__ __device__ __forceinline__ int list_cap(int n) {
  return list_cap_of(padded(n) / kGroup);
}
// groups of the largest slice of a row of n over a cluster of cs CTAs
__host__ __device__ __forceinline__ int slice_groups(int n, int cs) {
  return (padded(n) / kGroup + cs - 1) / cs;
}

// columns [i0, i0 + kGroup) of a row, those inside [0, n); one vector
// access when `vec` (the group is aligned) and the group is whole
template <typename X>
__device__ __forceinline__ void load_group(const X* row, int i0, int n, bool vec,
                                           X (&v)[kGroup]) {
  if (vec && i0 >= 0 && i0 + kGroup <= n) {
    const Group<X> g = *reinterpret_cast<const Group<X>*>(row + i0);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = g.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int i = i0 + j;
      if (i >= 0 && i < n) v[j] = row[i];
    }
  }
}

template <typename X>
__device__ __forceinline__ void store_group(X* row, int i0, int n, bool vec,
                                            const X (&v)[kGroup]) {
  if (vec && i0 >= 0 && i0 + kGroup <= n) {
    Group<X> g;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) g.v[j] = v[j];
    *reinterpret_cast<Group<X>*>(row + i0) = g;
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int i = i0 + j;
      if (i >= 0 && i < n) row[i] = v[j];
    }
  }
}

// bit j set: column i0 + j lies in [0, n)
__device__ __forceinline__ int group_mask(int i0, int n) {
  if (i0 >= 0 && i0 + kGroup <= n) return (1 << kGroup) - 1;
  int m = 0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) m |= (i0 + j >= 0 && i0 + j < n) << j;
  return m;
}

__device__ __forceinline__ int top_bit(uint32_t v) { return 31 - __clz((int)v); }
__device__ __forceinline__ int top_bit(uint64_t v) { return 63 - __clzll((long long)v); }

// exclusive warp prefix of cnt; *total = the warp's sum
__device__ __forceinline__ int warp_scan(int cnt, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  *total = __shfl_sync(kFull, incl, 31);
  return incl - cnt;
}

// first of `cnt` consecutive places the lane takes in a list whose length
// is *len (the whole warp calls it)
__device__ __forceinline__ int warp_reserve(int cnt, int* len) {
  int total;
  const int before = warp_scan(cnt, &total);
  int base = 0;
  if ((threadIdx.x & 31) == 31 && total) base = atomicAdd(len, total);
  return __shfl_sync(kFull, base, 31) + before;
}

template <typename Acc>
__device__ __forceinline__ Acc warp_max_nan(Acc v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max_nan(v, (Acc)__shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int TH>
struct StagedBase {
  unsigned long long ans;            // d of the k-th largest score
  unsigned long long kmax[TH / 32];  // per-warp max / min score key
  unsigned long long kmin[TH / 32];
  double mg[TH / 32];                // per-warp max |ceff| over gt columns,
  double mt[TH / 32];                //   over tie columns,
  double mk[TH / 32];                //   over kept tie columns
  int ng[TH / 32], nt[TH / 32];      // per-warp gt / tie counts
  int hist[256];                     // the row's histogram of a pass
  int misc[4];                       // bin, rank in it, its count; list length
};

// scratch in static shared memory; a cluster's CTAs read each other's
// cluster part
template <int TH, bool kCluster>
struct StagedShared : StagedBase<TH> {};

constexpr int kMaxCluster = 8;  // CTAs a cluster may take (the portable limit)

// the cluster's exchanges, each counted on an mbarrier of its own: the
// keys, passes 0-7 of the select, the last candidates, the counts, the
// rand-k tie max
enum Exchange : int { kKeys = 0, kPass0 = 1, kCand = 9, kCount = 10, kTieMax = 11,
                      kExchanges = 12 };

// Each CTA of a cluster pushes what the others need into a slot of its
// own rank in every CTA's scratch (`st.async`, each store counted on the
// receiver's mbarrier of that exchange), so every read is local and no
// exchange needs a cluster barrier.
template <int TH>
struct StagedShared<TH, true> : StagedBase<TH> {
  unsigned long long bar[kExchanges];            // the exchanges' mbarriers
  int part[256];                                 // this CTA's histogram of a pass
  int hin[2][kMaxCluster][256];                  // each CTA's, by pass parity
  unsigned long long key_in[kMaxCluster][2];     // each CTA's max / min score key
  unsigned long long cand_in[kMaxCluster][kRank];  // each CTA's last candidates
  int cand_n[kMaxCluster];                       //   and their number
  int cnt_in[kMaxCluster][2];                    // each CTA's gt / tie columns
  double mx_in[kMaxCluster][3];                  // its max |ceff| over gt, tie and
                                                 //   kept tie columns
};

// the cluster's rank and size (one CTA: 0 and 1), and its exchanges
template <bool kOn>
struct ClusterOps {
  __device__ int rank() const { return 0; }
  __device__ int size() const { return 1; }
};

template <>
struct ClusterOps<true> {
  __device__ int rank() const { return (int)cooperative_groups::this_cluster().block_rank(); }
  __device__ int size() const { return (int)cooperative_groups::this_cluster().num_blocks(); }
  // rank r's shared::cluster address of a variable of this CTA's layout
  __device__ static uint32_t at(const void* p, int r) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(r));
    return out;
  }
  // store v into rank r's copy of *field, its bytes counted on rank r's
  // copy of the mbarrier *bar
  __device__ void send(const void* field, int r, uint32_t v, const void* bar) const {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                 :: "r"(at(field, r)), "r"(v), "r"(at(bar, r)) : "memory");
  }
  __device__ void send(const void* field, int r, unsigned long long v,
                       const void* bar) const {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                 :: "r"(at(field, r)), "l"(v), "r"(at(bar, r)) : "memory");
  }
  // one thread: an mbarrier of one arrival expecting `bytes`
  __device__ static void arm(unsigned long long* bar, uint32_t bytes) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(a) : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(a), "r"(bytes) : "memory");
  }
  // until *bar's bytes have all come (a fault past ~2^26 polls: a missing
  // byte is an error, never a hung card)
  __device__ static void wait(unsigned long long* bar) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
    for (uint32_t spins = 0;; ++spins) {
      uint32_t done;
      asm volatile("{\n .reg .pred p;\n"
                   " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   " selp.u32 %0, 1, 0, p;\n}"
                   : "=r"(done) : "r"(a) : "memory");
      if (done) return;
      if (spins > (1u << 26)) __trap();
    }
  }
  // the mbarriers' initialisation before any other CTA may send; a split
  // cluster barrier, waited for before the first send
  __device__ static void fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __device__ static void arrive() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  __device__ static void wait_all() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
};

// warp 0: the bin b (ascending) holding the kk-th smallest d, kk's rank
// inside it and its count; resets the list length
__device__ __forceinline__ void choose_bin(const int* hist, int* misc, int kk) {
  const int lane = threadIdx.x & 31;
  int local = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) local += hist[8 * lane + j];
  int total;
  const int incl = warp_scan(local, &total) + local;
  const unsigned ball = __ballot_sync(kFull, incl >= kk);
  if (lane == __ffs(ball) - 1) {
    int below = incl - local, b = 8 * lane;
    for (int j = 0; j < 8; ++j, ++b) {
      const int h = hist[b];
      if (below + h >= kk) break;
      below += h;
    }
    misc[0] = b;
    misc[1] = kk - below;
    misc[2] = hist[b];
  }
  if (lane == 0) misc[3] = 0;
}

// choose_bin for every warp at once: each takes *bin, kk's rank inside
// it (into kk) and *count from the histogram in its registers
__device__ __forceinline__ void choose_bin_warp(const int* hist, int& kk, int* bin,
                                                int* count) {
  const int lane = threadIdx.x & 31;
  int local = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) local += hist[8 * lane + j];
  int total;
  const int incl = warp_scan(local, &total) + local;
  const int src = __ffs(__ballot_sync(kFull, incl >= kk)) - 1;
  int below = incl - local, b = 8 * lane;
  if (lane == src) {
    for (int j = 0; j < 8; ++j, ++b) {
      const int h = hist[b];
      if (below + h >= kk) break;
      below += h;
    }
  }
  *bin = __shfl_sync(kFull, b, src);
  kk -= __shfl_sync(kFull, below, src);
  *count = hist[*bin];
}

// The staged front end of one CTA over groups [g_lo, g_hi) of a row of n
// columns (position p = column + o, group q = positions [4q, 4q + 4)):
// stage(), select(), count() and scale(), each called by the whole CTA
// (the whole cluster with kCluster), in that order.  Shared memory: s_ce
// (and s_sel) hold kGroup positions per group from g_lo, `lists` two
// lists of `cap` keys, s_flag a byte per group.
template <typename T, typename Acc, typename U, int TH, bool kCluster>
struct Staged {
  using Key = typename KeyOf<Acc>::type;
  static constexpr int W = TH / 32;
  static constexpr int kKeyBits = (int)sizeof(Key) * 8;

  const T* cr;
  const T* er;
  const U* usr;
  int n, k;
  bool select, randk, vec;
  int o, g_lo, g_hi, q0, q1, cap;
  Acc* s_ce;
  Acc* s_sel;
  Key* lists;
  uint8_t* s_flag;
  StagedShared<TH, kCluster>& sh;
  ClusterOps<kCluster> cl;
  int lane, wid;
  // select's: the row's max score key and thr
  Key maxk;
  Acc thr;
  // count's: the row's gt / tie columns, ties kept (need = k - #gt, kt of
  // them there), entries kept; this warp's gt / tie columns before its
  // first group; the row's max |ceff| over gt and tie columns
  int n_gt, n_tie, need, kt, kept, gbase, tbase;
  Acc m_gt, m_tie;

  __device__ Staged(const T* cr_, const T* er_, const U* usr_, int n_, int k_,
                    bool select_, bool randk_, bool vec_, int o_, int g_lo_, int g_hi_,
                    int cap_, Acc* s_ce_, Acc* s_sel_, Key* lists_, uint8_t* s_flag_,
                    StagedShared<TH, kCluster>& sh_)
      : cr(cr_), er(er_), usr(usr_), n(n_), k(k_), select(select_), randk(randk_),
        vec(vec_), o(o_), g_lo(g_lo_), g_hi(g_hi_), cap(cap_), s_ce(s_ce_),
        s_sel(s_sel_), lists(lists_), s_flag(s_flag_), sh(sh_) {
    lane = threadIdx.x & 31;
    wid = threadIdx.x >> 5;
    const int per = (g_hi - g_lo + W - 1) / W;
    q0 = g_lo + wid * per;
    q1 = min(g_hi, q0 + per);
  }

  __device__ __forceinline__ Group<Acc>& ce(int q) const {
    return *reinterpret_cast<Group<Acc>*>(s_ce + kGroup * (q - g_lo));
  }
  __device__ __forceinline__ Group<Acc> scores(int q, const Group<Acc>& c) const {
    Group<Acc> sc;
    if (randk) {
      sc = *reinterpret_cast<const Group<Acc>*>(s_sel + kGroup * (q - g_lo));
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) sc.v[j] = absv(c.v[j]);
    }
    return sc;
  }
  __device__ __forceinline__ uint8_t& flag(int q) const { return s_flag[q - g_lo]; }

  // ---- stage ceff (and the rand-k scores); min / max score keys; in a
  // cluster, arm the exchanges' mbarriers
  __device__ __forceinline__ void stage() {
    if (threadIdx.x == 0) sh.misc[3] = 0;
    if constexpr (kCluster) {
      for (int b = threadIdx.x; b < 256; b += TH) sh.part[b] = 0;
      if (threadIdx.x == 0) {  // every exchange's bytes: its size from each rank
        const uint32_t cs = (uint32_t)cl.size();
        cl.arm(&sh.bar[kKeys], cs * 16);
        for (int p = 0; p < 8; ++p) cl.arm(&sh.bar[kPass0 + p], cs * 256 * 4);
        cl.arm(&sh.bar[kCand], cs * (kRank * 8 + 4));
        cl.arm(&sh.bar[kCount], cs * 24);
        cl.arm(&sh.bar[kTieMax], cs * 8);
        cl.fence_init();
      }
      cl.arrive();  // waited for in select_thr / count, before the first send
    }
    Key kmax = 0, kmin = ~(Key)0;
    // not unrolled: unrolled, the 256-thread CTAs spill past their 64
    // registers
#pragma unroll 1
    for (int q = q0 + lane; q < q1; q += 32) {
      const int i0 = kGroup * q - o;
      const int vm = group_mask(i0, n);
      T cv[kGroup], ev[kGroup];
      load_group(cr, i0, n, vec, cv);
      if (er) load_group(er, i0, n, vec, ev);
      Group<Acc> cg;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        Acc v = (Acc)0;
        if (vm >> j & 1) {
          v = to_ct(cv[j], Acc());
          if (er) v = add_rn(v, to_ct(ev[j], Acc()));
        }
        cg.v[j] = v;
      }
      ce(q) = cg;
      if (select) {
        Group<Acc> sc;
        if (randk) {
          U uv[kGroup];
          load_group(usr, i0, n, vec, uv);
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            sc.v[j] = (vm >> j & 1) ? to_ct(uv[j], Acc()) : (Acc)0;
          *reinterpret_cast<Group<Acc>*>(s_sel + kGroup * (q - g_lo)) = sc;
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) sc.v[j] = absv(cg.v[j]);
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (!(vm >> j & 1)) continue;
          const Key key = okey(sc.v[j]);
          kmax = key > kmax ? key : kmax;
          kmin = key < kmin ? key : kmin;
        }
      }
    }
    if (select) {
#pragma unroll
      for (int s = 16; s; s >>= 1) {
        const Key a = __shfl_xor_sync(kFull, kmax, s);
        const Key b = __shfl_xor_sync(kFull, kmin, s);
        kmax = a > kmax ? a : kmax;
        kmin = b < kmin ? b : kmin;
      }
      if (lane == 0) {
        sh.kmax[wid] = kmax;
        sh.kmin[wid] = kmin;
      }
    }
    __syncthreads();
  }

  // Visit the candidates (the d matching pref above bit fs) of the current
  // source, the slice (cur < 0) or list cur of cur_n entries: histogram
  // digit [shift, shift + wbits) into `hist` (if not null), append them to
  // list `to` (if build).
  __device__ __forceinline__ void visit(int* hist, int shift, Key dmask, bool build, Key* to,
                        int cur, int cur_n, int fs, Key pref) {
    auto matches = [&](Key d) { return fs >= kKeyBits || (d >> fs) == (pref >> fs); };
    if (cur < 0) {
      for (int base = q0; base < q1; base += 32) {
        const int q = base + lane;
        Key d[kGroup];
        bool m[kGroup];
        int cnt = 0;
        if (q < q1) {
          const int vm = group_mask(kGroup * q - o, n);
          const Group<Acc> sc = scores(q, ce(q));
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            d[j] = maxk - okey(sc.v[j]);
            m[j] = (vm >> j & 1) && matches(d[j]);
            cnt += m[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) m[j] = false;
        }
        if (hist) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (m[j]) atomicAdd(&hist[(int)((d[j] >> shift) & dmask)], 1);
        }
        if (build) {
          int at = warp_reserve(cnt, &sh.misc[3]);
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (m[j]) to[at++] = d[j];
        }
      }
    } else {
      const Key* from = lists + (size_t)cur * cap;
      for (int base = 0; base < cur_n; base += TH) {
        const int t = base + threadIdx.x;
        const Key d = t < cur_n ? from[t] : (Key)0;
        const bool m = t < cur_n && matches(d);
        if (hist && m) atomicAdd(&hist[(int)((d >> shift) & dmask)], 1);
        if (build) {
          const int at = warp_reserve(m ? 1 : 0, &sh.misc[3]);
          if (m) to[at] = d;
        }
      }
    }
  }

  // the min / max of a key over the lanes of a warp
  __device__ __forceinline__ void warp_minmax(Key& a, Key& b) const {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const Key x = __shfl_xor_sync(kFull, a, o), y = __shfl_xor_sync(kFull, b, o);
      a = x > a ? x : a;
      b = y < b ? y : b;
    }
  }

  // ---- select: thr = the k-th largest score of the row (0 without a
  // select).  n_loc: the slice's columns.  In a cluster each pass's
  // histogram buffer is cleared one pass ahead, and every warp takes the
  // digit from the summed histogram itself (`choose_bin_warp`), so a pass
  // costs two CTA barriers and one cluster barrier.
  __device__ __forceinline__ void select_thr(int n_loc) {
    thr = (Acc)0;
    if (!select) return;
    Key mink = ~(Key)0;
    maxk = 0;
    if constexpr (!kCluster) {
      for (int w = 0; w < W; ++w) {
        maxk = (Key)sh.kmax[w] > maxk ? (Key)sh.kmax[w] : maxk;
        mink = (Key)sh.kmin[w] < mink ? (Key)sh.kmin[w] : mink;
      }
    } else {
      // warp 0 joins the warps' keys, lane r pushes the CTA's to rank r;
      // every warp then joins the CTAs', lane r reading rank r's slot
      const int cs = cl.size(), me = cl.rank();
      cl.wait_all();  // every rank's mbarriers are armed
      if (wid == 0) {
        Key a = lane < W ? (Key)sh.kmax[lane] : (Key)0;
        Key b = lane < W ? (Key)sh.kmin[lane] : ~(Key)0;
        warp_minmax(a, b);
        if (lane < cs) {
          cl.send(&sh.key_in[me][0], lane, (unsigned long long)a, &sh.bar[kKeys]);
          cl.send(&sh.key_in[me][1], lane, (unsigned long long)b, &sh.bar[kKeys]);
        }
      }
      cl.wait(&sh.bar[kKeys]);
      Key a = lane < cs ? (Key)sh.key_in[lane][0] : (Key)0;
      Key b = lane < cs ? (Key)sh.key_in[lane][1] : ~(Key)0;
      warp_minmax(a, b);
      maxk = a;
      mink = b;
    }
    const Key dmax = maxk - mink;
    Key ans = 0;  // the k-th smallest d
    if (dmax != 0) {
      int fs = top_bit(dmax) + 1;  // bits >= fs of d are decided: pref's
      Key pref = 0;
      int kk = k;          // rank of the answer among the candidates
      int expect = n_loc;  // this CTA's candidates: the d that match pref
      int cur = -1;        // where they are: -1 the slice, else list cur
      int cur_n = n_loc;   //   holding cur_n entries (a superset)
      for (int pass = 0;; ++pass) {
        const int wbits = fs < 8 ? fs : 8;
        const int shift = fs - wbits;
        const Key dmask = ((Key)1 << wbits) - 1;
        // compact the candidates when they fit a list smaller than the source
        const bool build = expect <= cap && expect < cur_n;
        const int nxt = cur == 0 ? 1 : 0;
        int* hist = sh.hist;
        if constexpr (kCluster) {
          hist = sh.part;  // cleared by stage() or the pass before
        } else {
          for (int b = threadIdx.x; b < 256; b += TH) hist[b] = 0;
          __syncthreads();
        }
        visit(hist, shift, dmask, build, lists + (size_t)nxt * cap, cur, cur_n, fs, pref);
        __syncthreads();
        if (build) {
          cur = nxt;
          cur_n = expect;
        }
        int bin, row_expect;
        if constexpr (kCluster) {
          // every CTA pushes its histogram into its slot of this pass's
          // parity at every rank, then sums the slots it holds once they
          // have all come (a rank sends pass p + 2 into the slots of pass
          // p only after every rank's pass p + 1, so after their reads)
          const int cs = cl.size(), me = cl.rank();
          int (*in)[256] = sh.hin[pass & 1];
          for (int b = threadIdx.x; b < 256; b += TH) {
            const int v = hist[b];
            hist[b] = 0;  // for the next pass
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r)
              if (r < cs) cl.send(&in[me][b], r, (uint32_t)v, &sh.bar[kPass0 + pass]);
          }
          if (threadIdx.x == 0) sh.misc[3] = 0;
          cl.wait(&sh.bar[kPass0 + pass]);
          for (int b = threadIdx.x; b < 256; b += TH) {
            int t = 0;
            for (int r = 0; r < cs; ++r) t += in[r][b];
            sh.hist[b] = t;
          }
          __syncthreads();
          choose_bin_warp(sh.hist, kk, &bin, &row_expect);
          expect = in[me][bin];
        } else {
          if (wid == 0) choose_bin(sh.hist, sh.misc, kk);
          __syncthreads();
          bin = sh.misc[0];
          kk = sh.misc[1];
          row_expect = expect = sh.misc[2];
        }
        pref |= (Key)bin << shift;
        fs = shift;
        if (fs == 0) {
          ans = pref;
          break;
        }
        if (row_expect <= kRank) {  // gather them into the other list and rank them
          const int to = cur == 0 ? 1 : 0;
          Key* list = lists + (size_t)to * cap;
          visit(nullptr, 0, 0, true, list, cur, cur_n, fs, pref);
          __syncthreads();
          if constexpr (kCluster) {
            // each CTA pushes its candidate slots (all kRank of them, so
            // that every exchange has a fixed size) and their number to
            // every rank
            const int cs = cl.size(), me = cl.rank(), c = sh.misc[3];
            for (int i = threadIdx.x; i < cs * kRank; i += TH)
              cl.send(&sh.cand_in[me][i % kRank], i / kRank,
                      (unsigned long long)list[i % kRank], &sh.bar[kCand]);
            if (threadIdx.x < cs)
              cl.send(&sh.cand_n[me], threadIdx.x, (uint32_t)c, &sh.bar[kCand]);
            cl.wait(&sh.bar[kCand]);
          }
          if (wid == 0) {
            Key x = ~(Key)0;
            int total = row_expect;
            if constexpr (kCluster) {
              // lane j takes the j-th candidate of the cluster in rank order
              const int cs = cl.size();
              const int cnt = lane < cs ? sh.cand_n[lane] : 0;
              const int before = warp_scan(cnt, &total);
              for (int r = 0; r < cs; ++r) {
                const int b_r = __shfl_sync(kFull, before, r);
                const int c_r = __shfl_sync(kFull, cnt, r);
                if (lane >= b_r && lane < b_r + c_r) x = (Key)sh.cand_in[r][lane - b_r];
              }
            } else if (lane < total) {
              x = list[lane];
            }
            int less = 0, leq = 0;
            for (int j = 0; j < total; ++j) {
              const Key y = __shfl_sync(kFull, x, j);
              less += y < x;
              leq += y <= x;
            }
            if (lane < total && less < kk && kk <= leq) sh.ans = (unsigned long long)x;
          }
          __syncthreads();
          ans = (Key)sh.ans;
          break;
        }
      }
    }
    thr = from_okey((Key)(maxk - ans), Acc());
  }

  // ---- count: gt / tie columns per warp and their max |ceff|; each
  // group's flags (bit j: column i0 + j is gt, bit 4 + j: tie) are kept
  // for the write, whose lanes take the same groups
  __device__ __forceinline__ void count() {
    {
      int ng = 0, nt = 0;
      Acc mg = (Acc)0, mt = (Acc)0;  // |kept| >= 0: 0 is the identity
      for (int q = q0 + lane; q < q1; q += 32) {
        const int vm = group_mask(kGroup * q - o, n);
        const Group<Acc> cg = ce(q);
        const Group<Acc> sc = scores(q, cg);
        int gtm = 0, tiem = 0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (!(vm >> j & 1)) continue;
          // gt: kept outright (every column when k covers the row); tie:
          // kept by rank among the ties
          const bool gt = !select || sc.v[j] > thr;
          const bool tie = select && sc.v[j] == thr;
          if (gt) mg = max_nan(mg, absv(cg.v[j]));
          if (tie) mt = max_nan(mt, absv(cg.v[j]));
          gtm |= gt << j;
          tiem |= tie << j;
        }
        flag(q) = (uint8_t)(gtm | tiem << kGroup);
        ng += __popc(gtm);
        nt += __popc(tiem);
      }
      ng = warp_sum(ng);
      nt = warp_sum(nt);
      mg = warp_max_nan(mg);
      mt = warp_max_nan(mt);
      if (lane == 0) {
        sh.ng[wid] = ng;
        sh.nt[wid] = nt;
        sh.mg[wid] = (double)mg;
        sh.mt[wid] = (double)mt;
      }
    }
    __syncthreads();
    gbase = tbase = n_gt = n_tie = 0;
    m_gt = m_tie = (Acc)0;
    if constexpr (!kCluster) {
      for (int w = 0; w < W; ++w) {
        if (w == wid) {
          gbase = n_gt;
          tbase = n_tie;
        }
        n_gt += sh.ng[w];
        n_tie += sh.nt[w];
        m_gt = max_nan(m_gt, (Acc)sh.mg[w]);
        m_tie = max_nan(m_tie, (Acc)sh.mt[w]);
      }
    } else {
      // every warp joins the warps' counts (lane w holds warp w's), lane r
      // of warp 0 pushes the CTA's to rank r; then every warp reads the
      // CTAs', lane r rank r's: the lower ranks' columns come before this
      // CTA's
      int g = lane < W ? sh.ng[lane] : 0, t = lane < W ? sh.nt[lane] : 0;
      Acc mg = lane < W ? (Acc)sh.mg[lane] : (Acc)0, mt = lane < W ? (Acc)sh.mt[lane] : (Acc)0;
      int g_all, t_all;
      gbase = __shfl_sync(kFull, warp_scan(g, &g_all), wid);
      tbase = __shfl_sync(kFull, warp_scan(t, &t_all), wid);
      mg = warp_max_nan(mg);
      mt = warp_max_nan(mt);
      const int cs = cl.size(), me = cl.rank();
      if (!select) cl.wait_all();  // no select: its first exchange is this one
      if (wid == 0 && lane < cs) {  // lane r pushes the CTA's to rank r
        const void* bar = &sh.bar[kCount];
        cl.send(&sh.cnt_in[me][0], lane, (uint32_t)g_all, bar);
        cl.send(&sh.cnt_in[me][1], lane, (uint32_t)t_all, bar);
        cl.send(&sh.mx_in[me][0], lane, (unsigned long long)__double_as_longlong((double)mg), bar);
        cl.send(&sh.mx_in[me][1], lane, (unsigned long long)__double_as_longlong((double)mt), bar);
      }
      cl.wait(&sh.bar[kCount]);
      g = lane < cs ? sh.cnt_in[lane][0] : 0;
      t = lane < cs ? sh.cnt_in[lane][1] : 0;
      mg = lane < cs ? (Acc)sh.mx_in[lane][0] : (Acc)0;
      mt = lane < cs ? (Acc)sh.mx_in[lane][1] : (Acc)0;
      gbase += __shfl_sync(kFull, warp_scan(g, &g_all), me);
      tbase += __shfl_sync(kFull, warp_scan(t, &t_all), me);
      n_gt = g_all;
      n_tie = t_all;
      m_gt = warp_max_nan(mg);
      m_tie = warp_max_nan(mt);
    }
    need = k - n_gt;                        // ties kept
    kt = n_tie < need ? n_tie : need;
    kept = n_gt + kt;                       // < k only for a NaN row
  }

  // Walk the warp's groups in column order: body(q, i0, fl, g, t) sees
  // each of its lane's groups with its flags and g / t = the row's gt /
  // tie columns before the group.
  template <typename Body>
  __device__ __forceinline__ void walk(Body&& body) const {
    int g = gbase, t = tbase;
    for (int base = q0; base < q1; base += 32) {
      const int q = base + lane;
      const int fl = q < q1 ? flag(q) : 0;
      int total;
      const int before = warp_scan(__popc(fl & 0xF) + (__popc(fl >> kGroup) << 16), &total);
      if (q < q1) body(q, kGroup * q - o, fl, g + (before & 0xFFFF), t + (before >> 16));
      g += total & 0xFFFF;
      t += total >> 16;
    }
  }

  // ---- the row's scale: max |kept| (0 without quantization)
  __device__ __forceinline__ Acc scale(bool qon) {
    Acc scl = (Acc)0;
    if (!qon) return scl;
    scl = m_gt;
    if (kt > 0) {
      if (!randk) {
        scl = max_nan(scl, thr);  // a top-k tie's |ceff| is thr
      } else if (kt == n_tie) {
        scl = max_nan(scl, m_tie);
      } else {  // rand-k keeps the first kt ties only
        Acc mk = (Acc)0;
        const int nt_w = sh.nt[wid];
        if (tbase + nt_w <= kt) {
          mk = (Acc)sh.mt[wid];
        } else if (tbase < kt) {
          walk([&](int q, int, int fl, int, int t) {
            const Group<Acc> cg = ce(q);
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
              if (!(fl >> (kGroup + j) & 1)) continue;
              if (t < kt) mk = max_nan(mk, absv(cg.v[j]));
              ++t;
            }
          });
          mk = warp_max_nan(mk);
        }
        if (lane == 0) sh.mk[wid] = (double)mk;
        __syncthreads();
        if constexpr (!kCluster) {
          for (int w = 0; w < W; ++w) scl = max_nan(scl, (Acc)sh.mk[w]);
        } else {
          Acc cm = (Acc)0;
          for (int w = 0; w < W; ++w) cm = max_nan(cm, (Acc)sh.mk[w]);
          const int cs = cl.size(), me = cl.rank();
          if (wid == 0 && lane < cs)
            cl.send(&sh.mx_in[me][2], lane,
                    (unsigned long long)__double_as_longlong((double)cm), &sh.bar[kTieMax]);
          cl.wait(&sh.bar[kTieMax]);
          const Acc mr = lane < cs ? (Acc)sh.mx_in[lane][2] : (Acc)0;
          scl = max_nan(scl, warp_max_nan(mr));
        }
      }
    }
    return scl;
  }

};

// p is aligned for a vector of kGroup X (16 bytes at most)
template <typename X>
bool vec_aligned(const void* p) {
  const size_t a = sizeof(X) * kGroup < 16 ? sizeof(X) * kGroup : 16;
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % a == 0;
}

// SM count of the current device (cached at first use; 0 if unknown)
inline int sm_count() {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cached = v;
  }
  return cached;
}

}  // namespace rowsel
