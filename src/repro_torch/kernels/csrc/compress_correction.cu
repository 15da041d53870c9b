// Fused compressed-correction kernel for Hopper (sm_90a): feedback
// injection, exact-k selection, QSGD stochastic quantization and the
// residual update, one CTA per row of a flattened correction leaf [R, C]:
//
//   ceff  = c + e
//   kept  = ceff where keep (exact k by |ceff| or by u_sel), else 0
//   chat  = Q(kept)  (identity for bits >= 32)        -> stored in c's type
//   resid = ceff - chat as stored                       -> stored in c's type
//
// Replaces `repro/kernels/compress_correction.py` `compress_correction_2d`
// (the Pallas TPU kernel the CompressedGT / QuantizedGT strategies call on
// each correction leaf).  The math is `row_select.cuh`'s and equals the
// plain version (`kernels/ref.py` `compress_correction_ref`) bit for bit.
//
// Bound: HBM bytes -- c, e, u_sel, u_rnd read once, chat and resid written
// once.  The TPU's rule that C be a multiple of 128 is gone: any C >= 1.
// A row that fits is staged in shared memory once and every pass of the
// select reads it there; a longer row streams from global memory on each
// pass (then L2-bound).  One CTA per row leaves most of the card idle at
// the strategies' R = agents x groups = 16; several CTAs per row, vector
// loads and a fused multi-row tile are later work.
#include "row_select.cuh"

using namespace rowsel;

namespace {

template <typename T, typename Acc, typename U>
__global__ void __launch_bounds__(kThreads)
compress_kernel(const T* __restrict__ c, const T* __restrict__ e,
                const U* __restrict__ us, const U* __restrict__ ur,
                T* __restrict__ chat, T* __restrict__ resid, int n, int k,
                int bits, int topk, int staged, double s, double inv_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int64_t off = (int64_t)blockIdx.x * n;
  const bool select = k < n;
  Row<T, Acc, U> row{c + off, e ? e + off : nullptr,
                     us ? us + off : nullptr, ur ? ur + off : nullptr,
                     nullptr, nullptr, n, topk != 0};
  if (staged) {
    row.s_ceff = reinterpret_cast<Acc*>(smem);
    row.s_sel = (select && !row.topk) ? row.s_ceff + n : nullptr;
    row.stage(select);
  }
  const Selection<Acc> sel = select_row(row, k, sh);
  const Quant<Acc> qc = quant_row(row, sel, bits, s, inv_s, sh);
  T* ch = chat + off;
  T* rs = resid + off;
  for_each_kept(row, sel, sh, [&](int i, bool in, bool keep) {
    if (!in) return;
    const Acc ce = row.ceff(i);
    const Acc kept = keep ? ce : (Acc)0;
    const Acc v = qc.on ? mul_rn(level(kept, row.ur, i, qc), qc.t) : kept;
    const T out = Store<T>::of(v);
    ch[i] = out;
    rs[i] = Store<T>::of(sub_rn(ce, to_ct(out, Acc())));
  });
}

template <typename T, typename Acc, typename U>
int launch(const void* c, const void* e, const void* us, const void* ur,
           void* chat, void* resid, long long rows, int n, int k, int bits,
           int topk, double s, double inv_s, cudaStream_t stream) {
  auto kernel = compress_kernel<T, Acc, U>;
  const int limit = max_dynamic_smem<compress_kernel<T, Acc, U>>();
  const bool randk_sel = !topk && k < n;
  const size_t need = (size_t)n * sizeof(Acc) * (randk_sel ? 2 : 1);
  const int staged = need <= (size_t)limit ? 1 : 0;
  kernel<<<(unsigned)rows, kThreads, staged ? need : 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(e),
      static_cast<const U*>(us), static_cast<const U*>(ur),
      static_cast<T*>(chat), static_cast<T*>(resid), n, k, bits, topk,
      staged, s, inv_s);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int by_uniform(int u_dtype, const void* c, const void* e, const void* us,
               const void* ur, void* chat, void* resid, long long rows, int n,
               int k, int bits, int topk, double s, double inv_s,
               cudaStream_t st) {
  if (u_dtype == kF64)
    return launch<T, Acc, double>(c, e, us, ur, chat, resid, rows, n, k, bits, topk, s, inv_s, st);
  if (u_dtype == kF32)
    return launch<T, Acc, float>(c, e, us, ur, chat, resid, rows, n, k, bits, topk, s, inv_s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  c, e, chat
// and resid are [rows, n] of c_dtype; us and ur are [rows, n] of u_dtype
// (f64 or f32).  e may be null; us is read only for rand-k with k < n, ur
// only for bits < 32.  s = 2^(bits-1)-1 and inv_s = 1/s as the host's
// doubles.  rows == 0 launches nothing.
extern "C" int compress_correction_launch(
    const void* c, const void* e, const void* us, const void* ur, void* chat,
    void* resid, long long rows, int n, int k, int bits, int topk,
    int c_dtype, int u_dtype, double s, double inv_s, void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || k <= 0 || rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case kF64:
      return by_uniform<double, double>(u_dtype, c, e, us, ur, chat, resid, rows, n, k, bits, topk, s, inv_s, st);
    case kF32:
      return by_uniform<float, float>(u_dtype, c, e, us, ur, chat, resid, rows, n, k, bits, topk, s, inv_s, st);
    case kBF16:
      return by_uniform<__nv_bfloat16, float>(u_dtype, c, e, us, ur, chat, resid, rows, n, k, bits, topk, s, inv_s, st);
    case kFP8E4M3:
      return by_uniform<__nv_fp8_e4m3, float>(u_dtype, c, e, us, ur, chat, resid, rows, n, k, bits, topk, s, inv_s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether a row of n entries (rand-k scores staged too when randk_sel)
// runs staged in shared memory for c_dtype; -1 on a bad dtype.
extern "C" int compress_correction_staged(int n, int randk_sel, int c_dtype) {
  const size_t acc = c_dtype == kF64 ? sizeof(double) : sizeof(float);
  int limit;
  switch (c_dtype) {
    case kF64: limit = max_dynamic_smem<compress_kernel<double, double, double>>(); break;
    case kF32: limit = max_dynamic_smem<compress_kernel<float, float, double>>(); break;
    case kBF16: limit = max_dynamic_smem<compress_kernel<__nv_bfloat16, float, double>>(); break;
    case kFP8E4M3: limit = max_dynamic_smem<compress_kernel<__nv_fp8_e4m3, float, double>>(); break;
    default: return -1;
  }
  return (size_t)n * acc * (randk_sel ? 2 : 1) <= (size_t)limit ? 1 : 0;
}

extern "C" const char* compress_correction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
