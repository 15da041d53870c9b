// Fused compressed-correction kernels for Hopper (sm_90a): feedback
// injection, exact-k selection, QSGD stochastic quantization and the
// residual update of each row of a flattened correction leaf [R, C]:
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
//
// Three routes, chosen at launch (`compress_correction_launch`):
//
// * cluster (`compress_staged_kernel<..., true>`, few rows): a row is
//   split into contiguous column slices over a thread-block cluster of cs
//   CTAs (cs in 2, 4, 8), each staging its slice in shared memory and
//   joining the select, counts and scale through distributed shared
//   memory (`row_select.cuh` `Staged`).  The strategies' leaves have R =
//   agents x groups = 16 rows: one CTA a row would leave 116 of 132 SMs
//   idle, a cluster of 8 a row fills 128.  The wrapper takes the largest
//   cs with R * cs <= SMs and at least 128 columns a CTA; launched with
//   cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension, after
//   cudaOccupancyMaxActiveClusters has admitted the cluster (a size the
//   card cannot hold is an error, never a quiet size 1).
// * staged (`compress_staged_kernel<..., false>`, one CTA a row): the
//   staged front end on the whole row, 256-thread CTAs once the rows are
//   at least twice the SMs (several CTAs an SM, so that some stream their
//   rows while others select), 512 threads for fewer.
// * streaming (`compress_kernel`, rows too long for one CTA's shared
//   memory): `row_select.cuh`'s streaming front end, one CTA a row,
//   recomputing ceff from global memory on every pass (then L2-bound).
//
// The staged routes' write: column i is kept when gt, or tie with fewer
// than need = k - #gt ties before it in the row; chat and resid are
// stored as 16-byte vectors where the operands are aligned.
#include <map>
#include <mutex>
#include <tuple>

#include "row_select.cuh"

using namespace rowsel;

namespace {

constexpr int kSmall = 256;    // threads per CTA when the rows fill the card
constexpr int kBig = 512;      // threads per CTA for a few rows
constexpr int kCTA = 256;      // threads per CTA of a cluster
constexpr int kMinSlice = 128; // columns a cluster's CTA takes at least

// plan codes written back to the host (`kernels/compress_correction.py`)
enum Route : int { kStreaming = 0, kStaged = 1, kCluster = 2 };
// errors beyond cudaError_t
constexpr int kErrNoCluster = -2;  // the card admits no such cluster
constexpr int kErrNoFit = -3;      // a requested cluster's slice overflows shared memory

// ------------------------------------------------------------ streaming route
template <typename T, typename Acc, typename U>
__global__ void __launch_bounds__(kThreads)
compress_kernel(const T* __restrict__ c, const T* __restrict__ e,
                const U* __restrict__ us, const U* __restrict__ ur,
                T* __restrict__ chat, T* __restrict__ resid, int n, int k,
                int bits, int topk, double s, double inv_s) {
  __shared__ Shared sh;
  const int64_t off = (int64_t)blockIdx.x * n;
  Row<T, Acc, U> row{c + off, e ? e + off : nullptr,
                     us ? us + off : nullptr, ur ? ur + off : nullptr, n, topk != 0};
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

// ------------------------------------------------------------ staged routes
// shared-memory bytes of a slice of `groups` groups: ceff (and the rand-k
// scores), the two candidate lists, a flag byte per group
template <typename Acc>
__host__ __device__ __forceinline__ size_t slice_bytes(int groups, bool select,
                                                       bool randk) {
  using Key = typename KeyOf<Acc>::type;
  size_t b = (size_t)groups * kGroup * sizeof(Acc) * (randk ? 2 : 1);
  if (select) b += 2 * (size_t)list_cap_of(groups) * sizeof(Key);
  return b + groups;
}

template <typename T, typename Acc, typename U, int TH, bool kCl>
__global__ void __launch_bounds__(TH, kCl ? 2 : TH == kSmall ? (sizeof(Acc) == 4 ? 4 : 2) : 1)
compress_staged_kernel(const T* __restrict__ c, const T* __restrict__ e,
                       const U* __restrict__ us, const U* __restrict__ ur,
                       T* __restrict__ chat, T* __restrict__ resid, int n, int k,
                       int bits, int topk, int vec_in, double s_host,
                       double inv_s_host) {
  using Key = typename KeyOf<Acc>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StagedShared<TH, kCl> sh;
  const ClusterOps<kCl> cl{};
  const int cs = cl.size(), rank = cl.rank();
  const int64_t r = blockIdx.x / cs;
  const int64_t off = r * n;
  const bool vec = vec_in != 0;
  const bool select = k < n;
  const bool randk = select && !topk;
  const bool qon = bits < 32;
  // position p = column + o; group q = positions [4q, 4q + 4); this CTA
  // takes the rank-th of cs contiguous runs of groups
  const int o = vec ? (int)(off & (kGroup - 1)) : 0;
  const int groups = (o + n + kGroup - 1) / kGroup;
  const int per = (groups + cs - 1) / cs;
  const int g_lo = min(groups, rank * per);
  const int g_hi = min(groups, g_lo + per);
  const int cap_groups = slice_groups(n, cs);  // the largest slice's
  const int pos = cap_groups * kGroup;
  Acc* s_ce = reinterpret_cast<Acc*>(smem);
  Acc* s_sel = s_ce + pos;
  Key* lists = reinterpret_cast<Key*>(s_ce + (size_t)pos * (randk ? 2 : 1));
  const int cap = list_cap_of(cap_groups);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(lists + (select ? 2 * (size_t)cap : 0));
  const T* cr = c + off;
  const T* er = e ? e + off : nullptr;
  const U* usr = randk ? us + off : nullptr;
  const U* urr = qon ? ur + off : nullptr;
  // the slice's columns
  const int c_lo = max(0, kGroup * g_lo - o), c_hi = min(n, kGroup * g_hi - o);
  Staged<T, Acc, U, TH, kCl> st(cr, er, usr, n, k, select, randk, vec, o, g_lo, g_hi,
                                cap, s_ce, s_sel, lists, s_flag, sh);
  st.stage();
  st.select_thr(c_hi > c_lo ? c_hi - c_lo : 0);
  st.count();
  const Acc scl = st.scale(qon);
  const int need = st.need;
  const Acc sq = from_host(s_host, Acc());
  Acc rq = (Acc)0, tq = (Acc)0;  // s / safe, safe * (1/s)
  if (qon) {
    const Acc safe = scl > (Acc)0 ? scl : (Acc)1;
    rq = div_rn(sq, safe);
    tq = mul_rn(safe, from_host(inv_s_host, Acc()));
  }

  // ---- write: chat and resid of the slice
  T* ch = chat + off;
  T* rs = resid + off;
  st.walk([&](int q, int i0, int fl, int, int t) {
    U uv[kGroup];  // the rounding uniforms
    if (qon) load_group(urr, i0, n, vec, uv);
    const int vm = group_mask(i0, n);
    const Group<Acc> ce = st.ce(q);
    T out[kGroup], res[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (!(vm >> j & 1)) continue;
      const bool gt = fl >> j & 1, tie = fl >> (kGroup + j) & 1;
      const bool keep = gt || (tie && t < need);
      t += tie;
      const Acc kv = keep ? ce.v[j] : (Acc)0;
      Acc v = kv;
      if (qon) {
        const Acc u = mul_rn(kv, rq);
        const Acc lo = floorv(u);
        const Acc inc = to_ct(uv[j], Acc()) < sub_rn(u, lo) ? (Acc)1 : (Acc)0;
        Acc qv = add_rn(lo, inc);
        qv = qv < -sq ? -sq : (qv > sq ? sq : qv);  // NaN stays NaN
        v = mul_rn(qv, tq);
      }
      out[j] = Store<T>::of(v);
      res[j] = Store<T>::of(sub_rn(ce.v[j], to_ct(out[j], Acc())));
    }
    store_group(ch, i0, n, vec, out);
    store_group(rs, i0, n, vec, res);
  });
}

// ------------------------------------------------------------ launchers
template <typename T, typename Acc, typename U, int TH, bool kCl>
int limit_of() {
  return max_dynamic_smem<compress_staged_kernel<T, Acc, U, TH, kCl>>();
}

// dynamic shared memory both one-CTA staged instantiations may take
template <typename T, typename Acc, typename U>
int staged_limit() {
  const int a = limit_of<T, Acc, U, kSmall, false>();
  const int b = limit_of<T, Acc, U, kBig, false>();
  return a < b ? a : b;
}

// the cluster size the wrapper takes for `rows` rows of n: the largest cs
// in {8, 4, 2} with rows * cs <= SMs and n >= kMinSlice * cs, else 1
int auto_cluster(long long rows, int n) {
  const long long sms = sm_count();
  for (int cs = 8; cs > 1; cs >>= 1)
    if (rows * cs <= sms && n >= kMinSlice * cs) return cs;
  return 1;
}

// clusters of `cs` CTAs with `smem` bytes each the card holds at once
// (cudaOccupancyMaxActiveClusters), cached per kernel, size and bytes
int active_clusters(const void* kernel, const cudaLaunchConfig_t& cfg, int cs,
                    size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, cs, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int num = 0;
  if (cudaOccupancyMaxActiveClusters(&num, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    num = 0;
  }
  cache.emplace(key, num);
  return num;
}

template <typename T, typename Acc, typename U>
int launch(const void* c, const void* e, const void* us, const void* ur, void* chat,
           void* resid, long long rows, int n, int k, int bits, int topk,
           int cluster, double s, double inv_s, cudaStream_t stream, int* plan) {
  const bool select = k < n, randk = select && !topk;
  const int cs = cluster > 0 ? cluster : auto_cluster(rows, n);
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8) return (int)cudaErrorInvalidValue;
  const int vec = vec_aligned<T>(c) && vec_aligned<T>(e) && vec_aligned<T>(chat) &&
                  vec_aligned<T>(resid) && vec_aligned<U>(us) && vec_aligned<U>(ur);
  const T* cp = static_cast<const T*>(c);
  const T* ep = static_cast<const T*>(e);
  const U* usp = static_cast<const U*>(us);
  const U* urp = static_cast<const U*>(ur);
  T* chp = static_cast<T*>(chat);
  T* rsp = static_cast<T*>(resid);
  if (cs > 1) {
    const size_t need = slice_bytes<Acc>(slice_groups(n, cs), select, randk);
    const bool fits = need <= (size_t)limit_of<T, Acc, U, kCTA, true>();
    if (!fits && cluster > 0) return kErrNoFit;
    if (fits) {
      auto kernel = compress_staged_kernel<T, Acc, U, kCTA, true>;
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cs;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3((unsigned)(rows * cs));
      cfg.blockDim = dim3(kCTA);
      cfg.dynamicSmemBytes = need;
      cfg.stream = stream;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (active_clusters((const void*)kernel, cfg, cs, need) <= 0) return kErrNoCluster;
      plan[0] = kCluster;
      plan[1] = cs;
      plan[2] = kCTA;
      const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, cp, ep, usp, urp, chp, rsp,
                                                 n, k, bits, topk, vec, s, inv_s);
      return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
    }
  }
  const size_t need = slice_bytes<Acc>(slice_groups(n, 1), select, randk);
  if (need <= (size_t)staged_limit<T, Acc, U>()) {
    const int th = rows >= 2LL * sm_count() ? kSmall : kBig;
    plan[0] = kStaged;
    plan[1] = 1;
    plan[2] = th;
    if (th == kSmall)
      compress_staged_kernel<T, Acc, U, kSmall, false><<<(unsigned)rows, kSmall, need, stream>>>(
          cp, ep, usp, urp, chp, rsp, n, k, bits, topk, vec, s, inv_s);
    else
      compress_staged_kernel<T, Acc, U, kBig, false><<<(unsigned)rows, kBig, need, stream>>>(
          cp, ep, usp, urp, chp, rsp, n, k, bits, topk, vec, s, inv_s);
    return (int)cudaGetLastError();
  }
  plan[0] = kStreaming;
  plan[1] = 1;
  plan[2] = kThreads;
  compress_kernel<T, Acc, U><<<(unsigned)rows, kThreads, 0, stream>>>(
      cp, ep, usp, urp, chp, rsp, n, k, bits, topk, s, inv_s);
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int by_uniform(int u_dtype, const void* c, const void* e, const void* us,
               const void* ur, void* chat, void* resid, long long rows, int n,
               int k, int bits, int topk, int cluster, double s, double inv_s,
               cudaStream_t st, int* plan) {
  if (u_dtype == kF64)
    return launch<T, Acc, double>(c, e, us, ur, chat, resid, rows, n, k, bits, topk,
                                  cluster, s, inv_s, st, plan);
  if (u_dtype == kF32)
    return launch<T, Acc, float>(c, e, us, ur, chat, resid, rows, n, k, bits, topk,
                                 cluster, s, inv_s, st, plan);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename Acc>
int staged_for(int n, int randk) {
  return slice_bytes<Acc>(slice_groups(n, 1), n > 1, randk && n > 1) <=
                 (size_t)staged_limit<T, Acc, double>()
             ? 1
             : 0;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success), -2 when the
// card admits no cluster of the size taken, -3 when a requested cluster's
// slice does not fit its shared memory.  c, e, chat and resid are
// [rows, n] of c_dtype; us and ur are [rows, n] of u_dtype (f64 or f32).
// e may be null; us is read only for rand-k with k < n, ur only for
// bits < 32.  s = 2^(bits-1)-1 and inv_s = 1/s as the host's doubles.
// cluster: 0 the wrapper's choice, 1 one CTA a row (staged, or streaming
// for a row too long), 2 / 4 / 8 a cluster of that many CTAs a row.
// plan[0..2] receives the route (0 streaming, 1 staged, 2 cluster), the
// CTAs a row and the threads a CTA.  rows == 0 launches nothing.
extern "C" int compress_correction_launch(
    const void* c, const void* e, const void* us, const void* ur, void* chat,
    void* resid, long long rows, int n, int k, int bits, int topk,
    int c_dtype, int u_dtype, double s, double inv_s, int cluster, void* stream,
    int* plan) {
  if (rows <= 0) return 0;
  if (n <= 0 || k <= 0 || rows > 0x7FFFFFFFLL / 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case kF64:
      return by_uniform<double, double>(u_dtype, c, e, us, ur, chat, resid, rows, n, k, bits,
                                        topk, cluster, s, inv_s, st, plan);
    case kF32:
      return by_uniform<float, float>(u_dtype, c, e, us, ur, chat, resid, rows, n, k, bits,
                                      topk, cluster, s, inv_s, st, plan);
    case kBF16:
      return by_uniform<__nv_bfloat16, float>(u_dtype, c, e, us, ur, chat, resid, rows, n, k,
                                              bits, topk, cluster, s, inv_s, st, plan);
    case kFP8E4M3:
      return by_uniform<__nv_fp8_e4m3, float>(u_dtype, c, e, us, ur, chat, resid, rows, n, k,
                                              bits, topk, cluster, s, inv_s, st, plan);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether one CTA stages a row of n entries (its rand-k scores too when
// randk) in shared memory for c_dtype; -1 on a bad dtype.
extern "C" int compress_correction_staged(int n, int randk, int c_dtype) {
  switch (c_dtype) {
    case kF64: return staged_for<double, double>(n, randk);
    case kF32: return staged_for<float, float>(n, randk);
    case kBF16: return staged_for<__nv_bfloat16, float>(n, randk);
    case kFP8E4M3: return staged_for<__nv_fp8_e4m3, float>(n, randk);
  }
  return -1;
}

// The cluster size the wrapper takes for `rows` rows of n columns.
extern "C" int compress_correction_auto_cluster(long long rows, int n) {
  return auto_cluster(rows, n);
}

extern "C" const char* compress_correction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
