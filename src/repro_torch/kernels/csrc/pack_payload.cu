// Fused wire-payload kernels for Hopper (sm_90a).
//
// pack_payload:   one CTA per row of a flattened correction leaf [R, C]:
//                 the select and quantize of compress_correction, then the
//                 wire buffers of the row -- ascending kept column indices,
//                 the levels q + s bit-packed into uint32 words, the kept
//                 values, or the whole compressed row, per encoding --
//                 plus the row's scale and the feedback residual
//                 ceff - chat.
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
// written once (unpack).
//
// Pack has two routes, chosen at launch from the row's shared-memory
// footprint:
//
// * staged (`pack_kernel`, every row that fits): `row_select.cuh`'s
//   staged front end (`Staged`, one CTA per row: the row read once in
//   16-byte vectors into shared memory, the compacted radix select on
//   d = max key - key from d's top bit, one counting pass with each
//   group's gt / tie flags, the scale), then the write:
//     write   column i is kept when gt, or tie with fewer than need =
//             k - #gt ties before it; its slot is #gt before i +
//             min(#ties before i, need), and a NaN row's padding slots
//             are its first non-kept columns (i - slot < k - #kept).
//             Indices and levels land in shared memory (the levels of a
//             slot in whole bytes, or or-ed into its word when narrower)
//             and are stored once, coalesced; resid, dense values and the
//             rounding uniforms move as vectors.  One copy of the loop
//             per encoding, so the hot loop carries no other encoding's
//             branches.
//   Rows at least twice the SMs run 256-thread CTAs, four per SM, so
//   that some CTAs stream their rows while others select; fewer rows run
//   512-thread CTAs, which finish one row sooner.
// * streaming (`pack_stream_kernel`, rows too long for shared memory):
//   `row_select.cuh`'s streaming front end recomputes ceff from global
//   memory on every pass and stages the levels in a global scratch row.
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

// ------------------------------------------------------------ staged route
constexpr int kSmall = 256;  // threads per CTA when the rows fill the card
constexpr int kBig = 512;    // threads per CTA for a few rows
// bytes of the region that holds the two candidate lists during the
// select and the row's indices after it
template <typename Acc>
__host__ __device__ __forceinline__ size_t list_bytes(int n, int k, int idx_u16) {
  using Key = typename KeyOf<Acc>::type;
  const size_t lists = k < n ? 2 * (size_t)list_cap(n) * sizeof(Key) : 0;
  const size_t ids = ((size_t)k * (idx_u16 ? 2 : 4) + 15) / 16 * 16;
  return lists > ids ? lists : ids;
}

template <typename Acc>
size_t staged_bytes(int n, int k, int topk, int enc, int idx_u16, int words) {
  const bool randk = k < n && !topk;
  size_t b = (size_t)padded(n) * sizeof(Acc) * (randk ? 2 : 1);
  b += list_bytes<Acc>(n, k, idx_u16);
  if (enc == kQuant || enc == kQuantDense) b += (size_t)words * sizeof(uint32_t);
  return b + padded(n) / kGroup;  // a gt / tie flag byte per group
}

template <int E>
struct EncodingTag {
  static constexpr int value = E;
};

template <typename T, typename Acc, typename U, int TH>
__global__ void __launch_bounds__(TH, TH == kSmall ? (sizeof(Acc) == 4 ? 4 : 2) : 1)
pack_kernel(const T* __restrict__ c, const T* __restrict__ e,
            const U* __restrict__ us, const U* __restrict__ ur,
            void* __restrict__ data, void* __restrict__ idx,
            Acc* __restrict__ scale, T* __restrict__ resid, int n, int k,
            int bits, int topk, int enc, int idx_u16, int words, int vec_in,
            double s_host, double inv_s_host) {
  using Key = typename KeyOf<Acc>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StagedShared<TH, false> sh;
  const int64_t r = blockIdx.x;
  const int64_t off = r * n;
  const bool vec = vec_in != 0;
  const bool select = k < n;
  const bool randk = select && !topk;
  const bool qon = bits < 32;
  const bool wordy = enc == kQuant || enc == kQuantDense;
  // position p = column + o; group q = positions [4q, 4q + 4)
  const int o = vec ? (int)(off & (kGroup - 1)) : 0;
  const int groups = (o + n + kGroup - 1) / kGroup;
  const int pn = padded(n);
  Acc* s_ce = reinterpret_cast<Acc*>(smem);
  Acc* s_sel = s_ce + pn;
  Key* lists = reinterpret_cast<Key*>(s_ce + (size_t)pn * (randk ? 2 : 1));
  unsigned char* s_idx = reinterpret_cast<unsigned char*>(lists);  // after the select
  uint32_t* s_words = reinterpret_cast<uint32_t*>(
      s_idx + list_bytes<Acc>(n, k, idx_u16));
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_words + (wordy ? words : 0));
  const T* cr = c + off;
  const T* er = e ? e + off : nullptr;
  const U* usr = randk ? us + off : nullptr;
  const U* urr = qon ? ur + off : nullptr;
  Staged<T, Acc, U, TH, false> st(cr, er, usr, n, k, select, randk, vec, o, 0, groups,
                                  list_cap(n), s_ce, s_sel, lists, s_flag, sh);
  for (int w = threadIdx.x; w < (wordy ? words : 0); w += TH) s_words[w] = 0;
  st.stage();
  st.select_thr(n);
  st.count();
  const Acc scl = st.scale(qon);
  const int need = st.need;
  const int kept = st.kept;
  const Acc sq = from_host(s_host, Acc());
  Acc rq = (Acc)0, tq = (Acc)0;  // s / safe, safe * (1/s)
  if (qon) {
    const Acc safe = scl > (Acc)0 ? scl : (Acc)1;
    rq = div_rn(sq, safe);
    tq = mul_rn(safe, from_host(inv_s_host, Acc()));
  }
  if (threadIdx.x == 0) scale[r] = qon ? scl : (Acc)0;

  // ---- write: levels, values, indices, residual; one loop per encoding
  const int sb = storage_bits(bits);
  const int lsb = __ffs(sb) - 1;   // log2 of the storage bits
  const int lpw = 5 - lsb;         // log2 of the levels per word
  const bool u16 = idx_u16 != 0;
  const int64_t islot = r * k;
  T* vrow = static_cast<T*>(data) + r * (enc == kSparse ? k : n);
  T* rs = resid + off;
  const int pad = k - kept;
  auto write = [&](auto tag) {
    constexpr int E = decltype(tag)::value;
    st.walk([&](int q, int i0, int fl, int g, int t) {
      U uv[kGroup];  // the rounding uniforms
      if (qon) load_group(urr, i0, n, vec, uv);
      const int vm = group_mask(i0, n);
      const Group<Acc> ce = st.ce(q);
      T out[kGroup], res[kGroup];
      int wcur = -1;  // the word this lane's narrow levels are or-ed into
      uint32_t wacc = 0;
      // level lev at slot / column pos of the row's words: whole bytes are
      // stored, narrower levels or-ed (a lane's run of them at once)
      auto put_level = [&](int pos, uint32_t lev) {
        if (lsb == 3) {
          reinterpret_cast<uint8_t*>(s_words)[pos] = (uint8_t)lev;
        } else if (lsb == 4) {
          reinterpret_cast<uint16_t*>(s_words)[pos] = (uint16_t)lev;
        } else if (lsb == 5) {
          s_words[pos] = lev;
        } else {
          const int wd = pos >> lpw;
          if (wd != wcur) {
            if (wacc) atomicOr(&s_words[wcur], wacc);
            wcur = wd;
            wacc = 0;
          }
          wacc |= lev << ((pos & ((1 << lpw) - 1)) << lsb);
        }
      };
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (!(vm >> j & 1)) continue;
        const int i = i0 + j;
        const bool gt = fl >> j & 1, tie = fl >> (kGroup + j) & 1;
        const bool keep = gt || (tie && t < need);
        const int slot = g + (t < need ? t : need);  // kept columns before i
        g += gt;
        t += tie;
        const Acc kv = keep ? ce.v[j] : (Acc)0;
        Acc v = kv;
        uint32_t lev = 0;
        if (qon) {
          const Acc u = mul_rn(kv, rq);
          const Acc lo = floorv(u);
          const Acc inc = to_ct(uv[j], Acc()) < sub_rn(u, lo) ? (Acc)1 : (Acc)0;
          Acc qv = add_rn(lo, inc);
          qv = qv < -sq ? -sq : (qv > sq ? sq : qv);  // NaN stays NaN
          v = mul_rn(qv, tq);
          lev = (uint32_t)to_i32(add_rn(qv, sq));
        }
        out[j] = Store<T>::of(v);
        res[j] = Store<T>::of(sub_rn(ce.v[j], to_ct(out[j], Acc())));
        if (keep) {
          put_index(s_idx, u16, slot, i);
          if (E == kQuant) put_level(slot, lev);
          if (E == kSparse) vrow[slot] = out[j];
        } else if (i - slot < pad) {  // i - slot: non-kept columns before i
          const int ps = kept + (i - slot);
          put_index(s_idx, u16, ps, i + n);
          if (E == kSparse) vrow[ps] = nan_of<T>();
        }
        if (E == kQuantDense) put_level(i, lev);
      }
      if (wacc) atomicOr(&s_words[wcur], wacc);
      store_group(rs, i0, n, vec, res);
      if (E == kDense) store_group(vrow, i0, n, vec, out);
    });
  };
  switch (enc) {
    case kQuant: write(EncodingTag<kQuant>()); break;
    case kQuantDense: write(EncodingTag<kQuantDense>()); break;
    case kSparse: write(EncodingTag<kSparse>()); break;
    default: write(EncodingTag<kDense>()); break;
  }
  __syncthreads();
  if (u16) {
    uint16_t* irow = static_cast<uint16_t*>(idx) + islot;
    for (int j = threadIdx.x; j < k; j += TH) irow[j] = reinterpret_cast<uint16_t*>(s_idx)[j];
  } else {
    int32_t* irow = static_cast<int32_t*>(idx) + islot;
    for (int j = threadIdx.x; j < k; j += TH) irow[j] = reinterpret_cast<int32_t*>(s_idx)[j];
  }
  if (wordy) {
    uint32_t* wrow = static_cast<uint32_t*>(data) + r * words;
    for (int w = threadIdx.x; w < words; w += TH) wrow[w] = s_words[w];
  }
}

// --------------------------------------------------------- streaming route
template <typename T, typename Acc, typename U>
__global__ void __launch_bounds__(kThreads)
pack_stream_kernel(const T* __restrict__ c, const T* __restrict__ e,
                   const U* __restrict__ us, const U* __restrict__ ur,
                   void* __restrict__ data, void* __restrict__ idx,
                   Acc* __restrict__ scale, T* __restrict__ resid,
                   uint32_t* __restrict__ lv_scratch, int n, int k, int bits,
                   int topk, int enc, int idx_u16, int words, double s,
                   double inv_s) {
  __shared__ Shared sh;
  const int64_t r = blockIdx.x;
  const int64_t off = r * n;
  Row<T, Acc, U> row{c + off, e ? e + off : nullptr,
                     us ? us + off : nullptr, ur ? ur + off : nullptr, n,
                     topk != 0};
  uint32_t* lv = lv_scratch ? lv_scratch + r * k : nullptr;
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

// ------------------------------------------------------------ launchers
// dynamic shared memory both staged instantiations may take
template <typename T, typename Acc, typename U>
int staged_limit() {
  const int a = max_dynamic_smem<pack_kernel<T, Acc, U, kSmall>>();
  const int b = max_dynamic_smem<pack_kernel<T, Acc, U, kBig>>();
  return a < b ? a : b;
}

template <typename T, typename Acc, typename U>
int launch_pack(const void* c, const void* e, const void* us, const void* ur,
                void* data, void* idx, void* scale, void* resid, void* scratch,
                long long rows, int n, int k, int bits, int topk, int enc,
                int idx_u16, int words, double s, double inv_s,
                cudaStream_t stream) {
  const size_t need = staged_bytes<Acc>(n, k, topk, enc, idx_u16, words);
  if (need <= (size_t)staged_limit<T, Acc, U>()) {
    const bool vec = vec_aligned<T>(c) && vec_aligned<T>(e) && vec_aligned<T>(resid) &&
                     vec_aligned<U>(us) && vec_aligned<U>(ur) &&
                     (enc != kDense || vec_aligned<T>(data));
    auto go = [&](auto kernel, int threads) {
      kernel<<<(unsigned)rows, threads, need, stream>>>(
          static_cast<const T*>(c), static_cast<const T*>(e),
          static_cast<const U*>(us), static_cast<const U*>(ur), data, idx,
          static_cast<Acc*>(scale), static_cast<T*>(resid), n, k, bits, topk,
          enc, idx_u16, words, vec ? 1 : 0, s, inv_s);
    };
    if (rows >= 2LL * sm_count()) go(pack_kernel<T, Acc, U, kSmall>, kSmall);
    else go(pack_kernel<T, Acc, U, kBig>, kBig);
    return (int)cudaGetLastError();
  }
  if (enc == kQuant && scratch == nullptr) return (int)cudaErrorInvalidValue;
  pack_stream_kernel<T, Acc, U><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(e),
      static_cast<const U*>(us), static_cast<const U*>(ur), data, idx,
      static_cast<Acc*>(scale), static_cast<T*>(resid),
      static_cast<uint32_t*>(scratch), n, k, bits, topk, enc, idx_u16, words,
      s, inv_s);
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

template <typename T, typename Acc>
int staged_for(int n, int k, int topk, int enc, int idx_u16, int words) {
  return staged_bytes<Acc>(n, k, topk, enc, idx_u16, words) <=
                 (size_t)staged_limit<T, Acc, double>()
             ? 1
             : 0;
}

}  // namespace

// Launch pack on `stream`; returns a cudaError_t (0 on success).  c, e
// and resid are [rows, n] of c_dtype; us, ur [rows, n] of u_dtype (f64 or
// f32; each may be null when unused); data is [rows, words] uint32
// (quant, quant_dense), [rows, k] (sparse) or [rows, n] (dense) of
// c_dtype; idx [rows, k] uint16 (idx_u16) or int32; scale [rows] in the
// compute type; scratch [rows, k] uint32, needed only for the quant
// encoding of a row that streams (pack_payload_staged says which).
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

// Whether pack stages a row of n columns (k kept, uint16 or int32
// indices, `words` words of data) in shared memory; 0: it streams, and
// quant then needs the scratch; -1 on a bad dtype.
extern "C" int pack_payload_staged(int n, int k, int topk, int enc, int idx_u16,
                                   int words, int c_dtype) {
  if (n <= 0 || k <= 0 || k > n) return -1;
  switch (c_dtype) {
    case kF64: return staged_for<double, double>(n, k, topk, enc, idx_u16, words);
    case kF32: return staged_for<float, float>(n, k, topk, enc, idx_u16, words);
    case kBF16: return staged_for<__nv_bfloat16, float>(n, k, topk, enc, idx_u16, words);
    case kFP8E4M3: return staged_for<__nv_fp8_e4m3, float>(n, k, topk, enc, idx_u16, words);
  }
  return -1;
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
