// Device helpers shared by the Hopper kernels (`flash_attention.cu`,
// `flash_attention_bwd.cu`, `ssm_scan_bwd.cu`): `cp.async` copies into
// shared memory, `ldmatrix`, the TF32 and bf16 `mma.sync` tensor-core
// products and the split of an f32 operand into TF32 parts (3xTF32), and
// the row-tile loads of the flash kernels.  Included once per
// translation unit, inside its anonymous namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 227 * 1024;      // a CTA's shared memory, at most

// --------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(VB), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// what `cvt.rna.tf32.f32` gives for a finite x, in two integer
// operations (add half of the dropped unit to the magnitude, clear the 13
// low bits), which cost less than the conversion in the split's hot loop
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32, lo the rounded remainder
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// x = hi + lo with hi = x truncated to TF32 and lo = x - hi exactly in f32,
// its low 13 bits left for the tensor core, which reads a TF32 operand's
// top 19 bits and drops the rest: two operations where `split_tf32`
// takes five.  The dropped parts of a product (lo*lo, lo's low bits) are
// at most about 2^-20 of it where `split_tf32` leaves about 2^-22: fine
// for a gradient held to 1e-4 (`flash_attention_bwd.cu`).
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in f32 accuracy: the small products first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) { *p = __float2bfloat16_rn(0.f); }

// ------------------------------------------------------------- loads
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// rows [0, R) x columns [0, HDP) of a tile from `src` (row stride `ld`)
// into shared memory; rows >= `rows` and columns >= hd as zeros.  Each
// thread keeps one column chunk and walks the rows, so that a copy costs
// an address increment.
template <class C, int R, int VB, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, const T* base,
                                          long long ld, int rows, int hd) {
  constexpr int EPC = VB / (int)sizeof(T), CPR = C::HDP / EPC;
  constexpr int TPR = pow2_at_least(CPR) < C::THREADS ? pow2_at_least(CPR) : C::THREADS;
  constexpr int RPP = C::THREADS / TPR;  // rows per pass
  const int r0 = threadIdx.x / TPR;
#pragma unroll
  for (int cc = threadIdx.x % TPR; cc < CPR; cc += TPR) {
    const int e = cc * EPC;
    const int bytes = max(0, min(EPC, hd - e)) * (int)sizeof(T);
    const T* s = src + r0 * ld + e;
#pragma unroll
    for (int r = r0; r < R; r += RPP, s += RPP * ld) {
      const bool ok = r < rows && bytes > 0;  // else no byte is read
      cp_async<VB>(smem_u32(dst + r * C::LD + e), ok ? s : base, ok ? bytes : 0);
    }
  }
}

template <class C, int R, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, const T* base,
                                          long long ld, int rows, int hd, int vb) {
  switch (vb) {
    case 16: copy_rows<C, R, 16>(dst, src, base, ld, rows, hd); break;
    case 8: copy_rows<C, R, 8>(dst, src, base, ld, rows, hd); break;
    case 4: copy_rows<C, R, 4>(dst, src, base, ld, rows, hd); break;
    default:  // 2-byte aligned bf16 rows: plain loads
      for (int c = threadIdx.x; c < R * C::HDP; c += C::THREADS) {
        const int r = c / C::HDP, e = c - r * C::HDP;
        if (r < rows && e < hd) dst[r * C::LD + e] = src[r * ld + e];
        else zero(dst + r * C::LD + e);
      }
  }
}

// the widest cp.async (16, 8 or 4 bytes) that every row start of a
// tensor is aligned to; 0 for plain loads
inline int vec_bytes(const void* ptr, const long long* strides, int es) {
  for (int vb = 16; vb >= 4; vb /= 2) {
    bool ok = reinterpret_cast<uintptr_t>(ptr) % vb == 0;
    for (int i = 0; i < 3; ++i) ok = ok && (strides[i] * es) % vb == 0;
    if (ok) return vb;
  }
  return 0;
}

}  // namespace
