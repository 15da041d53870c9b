// Fused wire-payload kernels for Hopper (sm_90a).
//
// pack_payload:   one CTA per row of a flattened correction leaf [R, C]:
//                 the select and quantize of compress_correction
//                 (`row_select.cuh`), then the wire buffers of the row --
//                 ascending kept column indices (a block prefix scan over
//                 the kept flags gives each its slot), the levels q + s
//                 bit-packed into uint32 words, the kept values, or the
//                 whole compressed row, per encoding -- plus the row's
//                 scale and the feedback residual ceff - chat.
// unpack_payload: one CTA per row: unpack the words, dequantize with
//                 dequantize_levels' expression, and write the dense row;
//                 kept slots land as 0 + v, as JAX's scatter-add into zeros
//                 does (a kept -0.0 decodes to +0.0).
//
// Replace `repro/kernels/pack_payload.py` `pack_payload_2d` and
// `unpack_payload_2d` (the Pallas TPU kernels behind the packed wire
// transport, `fed/transport.py`).  Both equal the plain versions
// (`kernels/ref.py` `pack_payload_ref`, `decode_payload_ref`) bit for bit.
//
// Encodings (codes shared with kernels/pack_payload.py):
//   0 quant        words [R, W]: the k kept levels, storage_bits each
//   1 quant_dense  words [R, W]: all C levels (masked ones encode 0)
//   2 sparse       the k kept values [R, k] in c's type
//   3 dense        the compressed row [R, C] in c's type
// Every encoding also writes idx [R, k] (uint16 or int32), scale [R, 1]
// and resid [R, C].  A row whose scores are NaN keeps fewer than k
// entries (as in JAX); its last slots then hold C + j for its first
// non-kept columns j, level 0 and value NaN -- JAX's fill for a gather
// past the row -- and unpack drops indices past the row, as JAX's
// scatter does.
//
// Bound: HBM bytes -- c, e, u_sel, u_rnd read once; data, idx, scale and
// resid written once (pack); data, idx, scale read and the dense row
// written once (unpack).  A word is built by the lanes that hold its
// levels (quant_dense: a shuffle-or within groups of 32/storage_bits
// lanes) or by one thread from the row's levels staged in shared memory
// (quant), so no atomics touch a word.  Rows too long for shared memory
// stream from global memory and stage their levels in a global scratch
// row.
#include "row_select.cuh"

using namespace rowsel;

namespace {

enum Encoding : int { kQuant = 0, kQuantDense = 1, kSparse = 2, kDense = 3 };

__host__ __device__ __forceinline__ int storage_bits(int bits) {
  return bits <= 2 ? 2 : bits <= 4 ? 4 : bits <= 8 ? 8 : bits <= 16 ? 16 : 32;
}

__device__ __forceinline__ void put_index(void* idx, bool u16, int64_t at, int v) {
  if (u16) static_cast<uint16_t*>(idx)[at] = (uint16_t)v;
  else static_cast<int32_t*>(idx)[at] = v;
}

template <typename T, typename Acc, typename U>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ c, const T* __restrict__ e,
            const U* __restrict__ us, const U* __restrict__ ur,
            void* __restrict__ data, void* __restrict__ idx,
            Acc* __restrict__ scale, T* __restrict__ resid,
            uint32_t* __restrict__ lv_scratch, int n, int k, int bits,
            int topk, int enc, int idx_u16, int words, int staged, double s,
            double inv_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int64_t r = blockIdx.x;
  const int64_t off = r * n;
  const bool select = k < n;
  Row<T, Acc, U> row{c + off, e ? e + off : nullptr,
                     us ? us + off : nullptr, ur ? ur + off : nullptr,
                     nullptr, nullptr, n, topk != 0};
  const int sel_arrays = (select && !row.topk) ? 2 : 1;
  uint32_t* lv = lv_scratch ? lv_scratch + r * k : nullptr;
  if (staged) {
    row.s_ceff = reinterpret_cast<Acc*>(smem);
    row.s_sel = sel_arrays == 2 ? row.s_ceff + n : nullptr;
    lv = reinterpret_cast<uint32_t*>(smem + (size_t)n * sizeof(Acc) * sel_arrays);
    row.stage(select);
  }
  const Selection<Acc> sel = select_row(row, k, sh);
  const Quant<Acc> qc = quant_row(row, sel, bits, s, inv_s, sh);
  if (threadIdx.x == 0) scale[r] = qc.on ? qc.scale : (Acc)0;

  const int sb = storage_bits(bits);
  const int pw = 32 / sb;
  const bool u16 = idx_u16 != 0;
  const int64_t islot = r * k;
  uint32_t* wrow = static_cast<uint32_t*>(data) + r * words;
  T* vrow = static_cast<T*>(data) + r * (enc == kSparse ? k : n);
  T* rs = resid + off;
  const int pad = k - sel.kept;  // > 0 only for a row with NaN scores
  int kept_before = 0;
  for_each_kept(row, sel, sh, [&](int i, bool in, bool keep) {
    int total;
    const int slot = kept_before + block_scan(keep ? 1 : 0, sh, &total);
    kept_before += total;
    uint32_t lev = 0;
    if (in) {
      const Acc ce = row.ceff(i);
      const Acc kept = keep ? ce : (Acc)0;
      Acc q = kept, v = kept;
      if (qc.on) {
        q = level(kept, row.ur, i, qc);
        v = mul_rn(q, qc.t);
        lev = (uint32_t)to_i32(add_rn(q, qc.s));
      }
      const T out = Store<T>::of(v);
      rs[i] = Store<T>::of(sub_rn(ce, to_ct(out, Acc())));
      if (enc == kDense) vrow[i] = out;
      if (keep) {
        put_index(idx, u16, islot + slot, i);
        if (enc == kQuant) lv[slot] = lev;
        else if (enc == kSparse) vrow[slot] = out;
      } else if (i - slot < pad) {  // i - slot: non-kept columns before i
        const int ps = sel.kept + (i - slot);
        put_index(idx, u16, islot + ps, i + n);
        if (enc == kQuant) lv[ps] = 0;
        else if (enc == kSparse) vrow[ps] = nan_of<T>();
      }
    }
    if (enc == kQuantDense) {
      // pw consecutive columns share a word; their lanes or it together
      uint32_t w = in ? lev << ((i % pw) * sb) : 0u;
      for (int o = 1; o < pw; o <<= 1) w |= __shfl_xor_sync(kFull, w, o);
      if (in && i % pw == 0) wrow[i / pw] = w;
    }
  });
  if (enc == kQuant) {
    __syncthreads();
    for (int w = threadIdx.x; w < words; w += kThreads) {
      uint32_t word = 0;
      for (int j = 0; j < pw; ++j) {
        const int slot = w * pw + j;
        if (slot < k) word |= lv[slot] << (j * sb);
      }
      wrow[w] = word;
    }
  }
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const void* __restrict__ data, const void* __restrict__ idx,
              const Acc* __restrict__ scale, T* __restrict__ out, int cols,
              int k, int bits, int enc, int idx_u16, int words, double s,
              double inv_s) {
  const int64_t r = blockIdx.x;
  T* o = out + r * cols;
  if (enc == kDense) {
    const T* d = static_cast<const T*>(data) + r * cols;
    for (int j = threadIdx.x; j < cols; j += kThreads) o[j] = d[j];
    return;
  }
  const Acc sc = scale[r];
  const Acc safe = sc > (Acc)0 ? sc : (Acc)1;
  const Acc t = mul_rn(safe, from_host(inv_s, Acc()));
  const Acc sa = from_host(s, Acc());
  const int sb = storage_bits(bits);
  const int pw = 32 / sb;
  const uint32_t mask = sb == 32 ? 0xFFFFFFFFu : ((1u << sb) - 1u);
  const uint32_t* w = static_cast<const uint32_t*>(data) + r * words;
  auto value = [&](int slot) -> T {  // dequantized level of one slot
    const uint32_t lev = (w[slot / pw] >> ((slot % pw) * sb)) & mask;
    return Store<T>::of(mul_rn(sub_rn(from_i32((int)lev, Acc()), sa), t));
  };
  if (enc == kQuantDense) {
    for (int j = threadIdx.x; j < cols; j += kThreads) o[j] = value(j);
    return;
  }
  for (int j = threadIdx.x; j < cols; j += kThreads) o[j] = Store<T>::of((Acc)0);
  __syncthreads();
  const T* vals = static_cast<const T*>(data) + r * k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const int col = idx_u16 ? (int)static_cast<const uint16_t*>(idx)[r * k + j]
                            : static_cast<const int32_t*>(idx)[r * k + j];
    if (col < 0 || col >= cols) continue;  // dropped, as JAX's scatter does
    const T v = enc == kSparse ? vals[j] : value(j);
    o[col] = Store<T>::of(add_rn((Acc)0, to_ct(v, Acc())));
  }
}

template <typename T, typename Acc, typename U>
int launch_pack(const void* c, const void* e, const void* us, const void* ur,
                void* data, void* idx, void* scale, void* resid, void* scratch,
                long long rows, int n, int k, int bits, int topk, int enc,
                int idx_u16, int words, double s, double inv_s,
                cudaStream_t stream) {
  auto kernel = pack_kernel<T, Acc, U>;
  const int limit = max_dynamic_smem<pack_kernel<T, Acc, U>>();
  const bool randk_sel = !topk && k < n;
  const size_t need = (size_t)n * sizeof(Acc) * (randk_sel ? 2 : 1) +
                      (enc == kQuant ? (size_t)k * sizeof(uint32_t) : 0);
  const int staged = need <= (size_t)limit ? 1 : 0;
  if (!staged && enc == kQuant && scratch == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)rows, kThreads, staged ? need : 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(e),
      static_cast<const U*>(us), static_cast<const U*>(ur), data, idx,
      static_cast<Acc*>(scale), static_cast<T*>(resid),
      staged ? nullptr : static_cast<uint32_t*>(scratch), n, k, bits, topk,
      enc, idx_u16, words, staged, s, inv_s);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int pack_by_uniform(int u_dtype, const void* c, const void* e, const void* us,
                    const void* ur, void* data, void* idx, void* scale,
                    void* resid, void* scratch, long long rows, int n, int k,
                    int bits, int topk, int enc, int idx_u16, int words,
                    double s, double inv_s, cudaStream_t st) {
  if (u_dtype == kF64)
    return launch_pack<T, Acc, double>(c, e, us, ur, data, idx, scale, resid, scratch,
                                       rows, n, k, bits, topk, enc, idx_u16, words, s, inv_s, st);
  if (u_dtype == kF32)
    return launch_pack<T, Acc, float>(c, e, us, ur, data, idx, scale, resid, scratch,
                                      rows, n, k, bits, topk, enc, idx_u16, words, s, inv_s, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename Acc>
int launch_unpack(const void* data, const void* idx, const void* scale, void* out,
                  long long rows, int cols, int k, int bits, int enc, int idx_u16,
                  int words, double s, double inv_s, cudaStream_t stream) {
  unpack_kernel<T, Acc><<<(unsigned)rows, kThreads, 0, stream>>>(
      data, idx, static_cast<const Acc*>(scale), static_cast<T*>(out), cols, k,
      bits, enc, idx_u16, words, s, inv_s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch pack on `stream`; returns a cudaError_t (0 on success).  c, e
// and resid are [rows, n] of c_dtype; us, ur [rows, n] of u_dtype (f64 or
// f32; each may be null when unused, as for compress_correction); data is
// [rows, words] uint32 (quant, quant_dense), [rows, k] (sparse) or
// [rows, n] (dense) of c_dtype; idx [rows, k] uint16 (idx_u16) or int32;
// scale [rows] in the compute type; scratch [rows, k] uint32, needed only
// for the quant encoding of a row too long for shared memory.
extern "C" int pack_payload_launch(
    const void* c, const void* e, const void* us, const void* ur, void* data,
    void* idx, void* scale, void* resid, void* scratch, long long rows, int n,
    int k, int bits, int topk, int enc, int idx_u16, int words, int c_dtype,
    int u_dtype, double s, double inv_s, void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || k <= 0 || k > n || enc < 0 || enc > 3 || rows > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case kF64:
      return pack_by_uniform<double, double>(u_dtype, c, e, us, ur, data, idx, scale, resid, scratch,
                                             rows, n, k, bits, topk, enc, idx_u16, words, s, inv_s, st);
    case kF32:
      return pack_by_uniform<float, float>(u_dtype, c, e, us, ur, data, idx, scale, resid, scratch,
                                           rows, n, k, bits, topk, enc, idx_u16, words, s, inv_s, st);
    case kBF16:
      return pack_by_uniform<__nv_bfloat16, float>(u_dtype, c, e, us, ur, data, idx, scale, resid, scratch,
                                                   rows, n, k, bits, topk, enc, idx_u16, words, s, inv_s, st);
    case kFP8E4M3:
      return pack_by_uniform<__nv_fp8_e4m3, float>(u_dtype, c, e, us, ur, data, idx, scale, resid, scratch,
                                                   rows, n, k, bits, topk, enc, idx_u16, words, s, inv_s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Launch unpack on `stream`: data / idx / scale as pack wrote them (idx
// is read for quant and sparse only, scale for quant and quant_dense),
// out [rows, cols] of dtype.
extern "C" int unpack_payload_launch(
    const void* data, const void* idx, const void* scale, void* out,
    long long rows, int cols, int k, int bits, int enc, int idx_u16,
    int words, int dtype, double s, double inv_s, void* stream) {
  if (rows <= 0) return 0;
  if (cols <= 0 || k <= 0 || enc < 0 || enc > 3 || rows > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64:
      return launch_unpack<double, double>(data, idx, scale, out, rows, cols, k, bits, enc, idx_u16, words, s, inv_s, st);
    case kF32:
      return launch_unpack<float, float>(data, idx, scale, out, rows, cols, k, bits, enc, idx_u16, words, s, inv_s, st);
    case kBF16:
      return launch_unpack<__nv_bfloat16, float>(data, idx, scale, out, rows, cols, k, bits, enc, idx_u16, words, s, inv_s, st);
    case kFP8E4M3:
      return launch_unpack<__nv_fp8_e4m3, float>(data, idx, scale, out, rows, cols, k, bits, enc, idx_u16, words, s, inv_s, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pack_payload_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
