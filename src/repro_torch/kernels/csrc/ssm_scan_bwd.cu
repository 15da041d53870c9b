// Backward of the selective scan (Mamba-1 / Mamba-2) for Hopper (sm_90a):
//
//   forward   h_t = da_t * h_{t-1} + dbx_t,   y_t = <h_t, c_t>
//   backward  dh_t = c_t dy_t + da_{t+1} dh_{t+1}   (seeded by the final
//             state's cotangent), then
//             d dbx_t = dh_t,  d da_t = dh_t o h_{t-1},
//             dc_t = sum over channels of h_t dy_t,  d state0 = da_0 dh_0.
//
// Replaces no TPU kernel: the JAX package differentiates its plain scan
// (`models/mamba.py` `_chunked_scan`) with XLA's autodiff and has no
// backward Pallas kernel.  It was added so that the port's training path
// runs through `csrc/ssm_scan.cu` forward and this backward.
//
// Bound: HBM bytes.  dbx is read once (the recompute) and d dbx written
// once, both B*S*H*P*N f32; da, c, dy and the chunk states (1/T of dbx)
// are small beside them (d da and da too, but for Mamba-1, where both are
// dbx's size).  The design keeps those bytes in flight and little else on
// the serial chain:
//   * A CTA of 128 threads owns a block of `rows` (batch, head, channel)
//     rows and walks the sequence backwards chunk by chunk; the forward
//     stored the state entering every chunk of T steps (16, 8 above 128
//     states: `chunk_len`).  L lanes own a row, each SPL consecutive
//     states (4, or 8 above 128), so a row's loads and stores are 16-byte
//     vectors; the CTA's threads cover one group of 128 / L rows at a
//     time, and a work item is (chunk, group), chunks from the last.
//   * Each item's dbx tile [T][rows of the group][N] (in Mamba-1 layout
//     da's too), its chunk state, c [T][N], dy and da's rows stream into
//     the second of two shared-memory stages by `cp.async` while the
//     current item runs, each thread copying its own states.
//   * The chunk's states are recomputed into the tile in place (h_t over
//     dbx_t, which the backward needs no more); registers hold only dh,
//     the entering state and a step's values, and the rows' dh live in
//     shared memory between their items.
//   * d da reduced off the serial chain: where da broadcasts over the
//     states each step's per-lane product dh o h_{t-1} goes to shared
//     memory, and after the item a row's products are summed in lane
//     order.  Where da broadcasts over the channels too (Mamba-2's
//     per-head decay) and the CTA's rows are whole heads, it sums them
//     over P as well and writes d da [B, S, H] itself; else a second
//     kernel sums [B, S, H, P] over P in order.  Where da is full over the
//     states (Mamba-1's [B, S, D, 1, N]), d da is written per element.
//   * dc_t sums h_t dy_t over all H * P rows of a batch: after each item
//     the CTA adds its group's rows, in row order, to the chunk's sum in
//     shared memory, and writes it once the chunk's last group is done:
//     one partial per CTA, [B, CTAs, S, N], which a last kernel sums in
//     CTA order.
// No float atomics: two calls give the same bits.  Built with FMA
// contraction (no -fmad=false): held to a tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kReduceThreads = 256;
constexpr int kDhFloats = 4096;       // the rows' dh held by a CTA, at most
constexpr int kMaxHeadRows = 256;     // rows of the heads a CTA sums d da over
constexpr long long kMinCtas = 512;   // a block of rows is shrunk to reach this

// steps per chunk for N states: the forward (`ssm_scan.cu`) stores the
// state entering every chunk of this many steps
__host__ __device__ constexpr int chunk_len(int N) { return N > 128 ? 8 : 16; }

struct Params {
  const float* da;
  const float* dbx;
  const float* c;
  const float* chunks;  // [B, nch, H, P, N], the forward's
  const float* dy;      // [B, S, H, P]
  const float* dstate;  // [B, H, P, N] or null (zero)
  float* ddbx;          // [B, S, H, P, N]
  float* dda;           // mode 0: [B, S, H, P, N]; mode 1: [B, S, H, P] (heads: unused)
  float* dda_heads;     // [B, S, H] when the CTA sums over P
  float* dc_part;       // [B, gridDim.x, S, N]
  float* dstate0;       // [B, H, P, N]
  int B, S, H, P, N;
  int rows, groups;     // rows of a CTA, in groups of 128 / L
  int heads;            // heads whose d da the CTA sums over P (0: none)
  int vec;              // rows of dbx, ddbx, chunks (and mode 0's dda) take 16-byte accesses
  int da_vec;           // mode 0: da's rows take 16-byte copies
  long long da_sb, da_ss, da_sh, da_sp, da_sn;
  long long c_sb, c_ss, c_sn;
};

// L lanes of SPL states a row; FULL: da full over the states (mode 0)
template <int L_, int SPL_, bool FULL_>
struct Cfg {
  static constexpr int L = L_, SPL = SPL_;
  static constexpr bool FULL = FULL_;
  static constexpr int NP = L * SPL;            // a row's states, N padded
  static constexpr int RG = kThreads / L;       // rows of a group
  static constexpr int T = chunk_len(NP);       // = chunk_len(N) for N <= NP
  static constexpr int TILE = T * RG * NP;      // dbx / the states [T][RG][NP]
  static constexpr int DA = FULL ? TILE : T * RG;  // da [T][RG][NP], or [T][RG]
  static constexpr int H0 = RG * NP;            // the entering states
  static constexpr int CT = T * NP;             // c [T][NP]
  static constexpr int DY = T * RG;             // dy [T][RG]
  static constexpr int STAGE = TILE + DA + H0 + CT + DY;
  static constexpr int LANES = FULL ? 0 : T * kThreads;  // per-lane d da products
  static size_t smem(int rows, int heads) {
    return sizeof(float) * (2 * (size_t)STAGE + LANES + CT + (size_t)rows * NP +
                            (heads ? (size_t)rows * T : 0));
  }
};

template <int SPL>
__device__ __forceinline__ void lds(float (&v)[SPL], const float* s) {
#pragma unroll
  for (int q = 0; q < SPL; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(s + q);
    v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
  }
}

template <int SPL>
__device__ __forceinline__ void sts(float* s, const float (&v)[SPL]) {
#pragma unroll
  for (int q = 0; q < SPL; q += 4)
    *reinterpret_cast<float4*>(s + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// states n0 .. n0 + SPL - 1 of a row whose state 0 is at `row` (stride sn)
// into `dst`: 16-byte copies where `vec` (then sn = 1), else one a state;
// past N, or for a dead row, zeros
template <int SPL>
__device__ __forceinline__ void copy_states(float* dst, const float* row, const float* base,
                                            bool live, int n0, int N, bool vec, long long sn) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < SPL; q += 4) {
      const bool in = live && n0 + q < N;
      cp_async<16>(smem_u32(dst + q), in ? row + n0 + q : base, in ? 16 : 0);
    }
  } else {
    const float* src = row + n0 * sn;
#pragma unroll
    for (int q = 0; q < SPL; ++q, src += sn) {
      const bool in = live && n0 + q < N;
      cp_async<4>(smem_u32(dst + q), in ? src : base, in ? 4 : 0);
    }
  }
}

// states n0 .. of a row (dst at state n0), those below N
template <int SPL>
__device__ __forceinline__ void store_states(float* dst, const float (&v)[SPL], int n0,
                                             int N, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < SPL; q += 4)
      if (n0 + q < N)
        *reinterpret_cast<float4*>(dst + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < SPL; ++q)
      if (n0 + q < N) dst[q] = v[q];
  }
}

// grid (CTAs over the H * P rows, B)
template <class C>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* const lanes = sm + 2 * C::STAGE;     // [T][L][RG] (mode 1)
  float* const dc_s = lanes + C::LANES;       // [T][NP]: the chunk's dc so far
  float* const dh_s = dc_s + C::CT;           // [rows][NP]: every row's dh
  float* const rowv = dh_s + p.rows * C::NP;  // [T][rows]: a row's d da (heads)

  const int tid = threadIdx.x, r = tid / C::L, li = tid % C::L, n0 = li * C::SPL;
  const int HP = p.H * p.P;  // a batch's rows, within int32 (the launcher checks)
  const long long b = blockIdx.y;
  const int row0 = blockIdx.x * p.rows;  // the CTA's first row
  const int S = p.S, N = p.N;
  const long long step = (long long)HP * N;  // one step of dbx's layout
  const int nch = (S + C::T - 1) / C::T;
  const int items = nch * p.groups;
  const bool vec = p.vec != 0;
  const long long part = (b * gridDim.x + blockIdx.x) * (long long)S;

  // item i: chunk nch - 1 - i / groups, group i % groups, in stage i % 2
  auto prefetch = [&](int i) {
    float* const tile = sm + (i & 1) * C::STAGE;
    float* const dat = tile + C::TILE;
    float* const h0s = dat + C::DA;
    float* const cs = h0s + C::H0;
    float* const dys = cs + C::CT;
    const int k = nch - 1 - i / p.groups, g = i % p.groups;
    const int t0 = k * C::T, tn = min(C::T, S - t0);
    const int gr0 = row0 + g * C::RG, row = gr0 + r;
    const bool live = row < HP;
    const int hh = row / p.P, pp = row - hh * p.P;
    const float* dbx = p.dbx + ((b * S + t0) * HP + row) * N;
    for (int u = 0; u < tn; ++u)
      copy_states<C::SPL>(tile + (u * C::RG + r) * C::NP + n0, dbx + u * step, p.dbx,
                          live, n0, N, vec, 1);
    copy_states<C::SPL>(h0s + r * C::NP + n0, p.chunks + ((b * nch + k) * HP + row) * N,
                        p.chunks, live, n0, N, vec, 1);
    if constexpr (C::FULL) {
      const float* da = p.da + b * p.da_sb + t0 * p.da_ss + hh * p.da_sh + pp * p.da_sp;
      for (int u = 0; u < tn; ++u)
        copy_states<C::SPL>(dat + (u * C::RG + r) * C::NP + n0, da + u * p.da_ss, p.da,
                            live, n0, N, p.da_vec != 0, p.da_sn);
    }
    const float* cb = p.c + b * p.c_sb + t0 * p.c_ss;
    for (int e = tid; e < C::CT; e += kThreads) {
      const int u = e / C::NP, n = e % C::NP;
      const bool in = u < tn && n < N;
      cp_async<4>(smem_u32(cs + e), in ? cb + u * p.c_ss + n * p.c_sn : p.c, in ? 4 : 0);
    }
    for (int e = tid; e < C::DY; e += kThreads) {
      const int u = e / C::RG, rr = e % C::RG;
      const int rx = gr0 + rr;
      const bool in = u < tn && rx < HP;
      cp_async<4>(smem_u32(dys + e), in ? p.dy + (b * S + t0 + u) * HP + rx : p.dy,
                  in ? 4 : 0);
      if constexpr (!C::FULL) {
        const int hx = rx / p.P, px = rx - hx * p.P;
        const float* src = p.da + b * p.da_sb + (t0 + u) * p.da_ss + hx * p.da_sh + px * p.da_sp;
        cp_async<4>(smem_u32(dat + e), in ? src : p.da, in ? 4 : 0);
      }
    }
  };

  // every row's dh from dstate, or zero; the chunk's dc sum at zero
  for (int g = 0; g < p.groups; ++g) {
    const int row = row0 + g * C::RG + r;
    float* const d = dh_s + (g * C::RG + r) * C::NP + n0;
#pragma unroll
    for (int q = 0; q < C::SPL; ++q) {
      const int n = n0 + q;
      d[q] = (p.dstate != nullptr && row < HP && n < N) ? p.dstate[(b * HP + row) * N + n] : 0.f;
    }
  }
  for (int e = tid; e < C::CT; e += kThreads) dc_s[e] = 0.f;
  prefetch(0);
  cp_commit();

  for (int i = 0; i < items; ++i) {
    cp_wait<0>();     // item i landed, for this thread's copies
    __syncthreads();  // ... for every thread's; item i-1's reductions done
    if (i + 1 < items) prefetch(i + 1);
    cp_commit();
    float* const tile = sm + (i & 1) * C::STAGE;
    const float* const dat = tile + C::TILE;
    const float* const h0s = dat + C::DA;
    const float* const cs = h0s + C::H0;
    const float* const dys = cs + C::CT;
    const int k = nch - 1 - i / p.groups, g = i % p.groups;
    const int t0 = k * C::T, tn = min(C::T, S - t0);
    const int row = row0 + g * C::RG + r;
    const bool live = row < HP;
    float* const dhp = dh_s + (g * C::RG + r) * C::NP + n0;
    float h0[C::SPL], h[C::SPL], dh[C::SPL];
    lds<C::SPL>(h0, h0s + r * C::NP + n0);
    lds<C::SPL>(dh, dhp);
#pragma unroll
    for (int q = 0; q < C::SPL; ++q) h[q] = h0[q];

    // the chunk's states, over dbx in place: tile step u holds h_u
#pragma unroll
    for (int u = 0; u < C::T; ++u) {
      if (u < tn) {
        float* const x = tile + (u * C::RG + r) * C::NP + n0;
        float xv[C::SPL], a[C::SPL];
        lds<C::SPL>(xv, x);
        if constexpr (C::FULL) {
          lds<C::SPL>(a, dat + (u * C::RG + r) * C::NP + n0);
        } else {
#pragma unroll
          for (int q = 0; q < C::SPL; ++q) a[q] = dat[u * C::RG + r];
        }
#pragma unroll
        for (int q = 0; q < C::SPL; ++q) h[q] = a[q] * h[q] + xv[q];
        sts<C::SPL>(x, h);
      }
    }

    // the reverse recurrence
    const long long g0 = ((b * S + t0) * HP + row) * N + n0;  // (t0, row, n0) in dbx's layout
#pragma unroll
    for (int u = C::T - 1; u >= 0; --u) {
      if (u < tn) {
        const float gy = dys[u * C::RG + r];
        float cv[C::SPL], hp[C::SPL], a[C::SPL];
        lds<C::SPL>(cv, cs + u * C::NP + n0);
#pragma unroll
        for (int q = 0; q < C::SPL; ++q) dh[q] += cv[q] * gy;
        if (live) store_states<C::SPL>(p.ddbx + g0 + u * step, dh, n0, N, vec);
        if (u > 0) {
          lds<C::SPL>(hp, tile + ((u - 1) * C::RG + r) * C::NP + n0);
        } else {
#pragma unroll
          for (int q = 0; q < C::SPL; ++q) hp[q] = h0[q];
        }
        if constexpr (C::FULL) {
          float prod[C::SPL];
#pragma unroll
          for (int q = 0; q < C::SPL; ++q) prod[q] = dh[q] * hp[q];
          if (live) store_states<C::SPL>(p.dda + g0 + u * step, prod, n0, N, vec);
          lds<C::SPL>(a, dat + (u * C::RG + r) * C::NP + n0);
        } else {
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < C::SPL; ++q) acc += dh[q] * hp[q];
          lanes[u * kThreads + li * C::RG + r] = acc;
#pragma unroll
          for (int q = 0; q < C::SPL; ++q) a[q] = dat[u * C::RG + r];
        }
#pragma unroll
        for (int q = 0; q < C::SPL; ++q) dh[q] *= a[q];
      }
    }
    sts<C::SPL>(dhp, dh);
    if (k == 0 && live) store_states<C::SPL>(p.dstate0 + (b * HP + row) * N + n0, dh, n0, N, false);
    __syncthreads();  // the group's states and d da products stored

    // dc: the group's rows in row order, added to the chunk's sum over the
    // CTA's rows; written once the chunk's last group is in
    const bool last = g == p.groups - 1;
    for (int e = tid; e < C::CT; e += kThreads) {
      const int u = e / C::NP, n = e % C::NP;
      if (u >= tn) continue;
      float sum = 0.f;
      for (int rr = 0; rr < C::RG; ++rr)
        sum += tile[(u * C::RG + rr) * C::NP + n] * dys[u * C::RG + rr];
      const float tot = dc_s[e] + sum;
      if (last) {
        if (n < N) p.dc_part[(part + t0 + u) * N + n] = tot;
        dc_s[e] = 0.f;
      } else {
        dc_s[e] = tot;
      }
    }
    if constexpr (!C::FULL) {
      // a row's d da: its lanes' products in lane order
      for (int e = tid; e < C::DY; e += kThreads) {
        const int u = e / C::RG, rr = e % C::RG;
        if (u >= tn) continue;
        float v = 0.f;
#pragma unroll
        for (int l = 0; l < C::L; ++l) v += lanes[u * kThreads + l * C::RG + rr];
        const int rx = row0 + g * C::RG + rr;
        if (p.heads) rowv[u * p.rows + g * C::RG + rr] = v;
        else if (rx < HP) p.dda[(b * S + t0 + u) * HP + rx] = v;
      }
      if (p.heads && last) {
        __syncthreads();  // every row's d da of the chunk in rowv
        // a head's d da: its P rows in order
        for (int e = tid; e < C::T * p.heads; e += kThreads) {
          const int u = e / p.heads, hl = e % p.heads;
          const int hx = row0 / p.P + hl;
          if (u >= tn || hx >= p.H) continue;
          float v = 0.f;
          for (int q = 0; q < p.P; ++q) v += rowv[u * p.rows + hl * p.P + q];
          p.dda_heads[(b * S + t0 + u) * p.H + hx] = v;
        }
      }
    }
  }
  cp_wait<0>();
}

// dc[b, t, n] = sum over the CTAs' partials, in CTA order
__global__ void __launch_bounds__(kReduceThreads) dc_reduce_kernel(const float* part,
                                                                  float* dc, long long B,
                                                                  long long S, long long N,
                                                                  long long parts) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= B * S * N) return;
  const long long b = i / (S * N), tn = i - b * S * N;
  const float* src = part + b * parts * S * N + tn;
  float sum = 0.f;
  for (long long k = 0; k < parts; ++k) sum += src[k * S * N];
  dc[i] = sum;
}

// out[b, t, h] = sum over p of rows[b, t, h, p], in channel order
__global__ void __launch_bounds__(kReduceThreads) rows_reduce_kernel(const float* rows,
                                                                    float* out,
                                                                    long long n_out, int P) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n_out) return;
  const float* src = rows + i * P;
  float sum = 0.f;
  for (int k = 0; k < P; ++k) sum += src[k];
  out[i] = sum;
}

// a CTA's rows, the heads it sums d da over, its shared memory
struct Plan {
  int rows, heads;
  long long parts;
  size_t smem;
};

template <class C>
Plan plan_of(int B, int H, int P, int reduce_heads) {
  const long long HP = (long long)H * P;
  const int dh_rows = kDhFloats / C::NP > C::RG ? kDhFloats / C::NP : C::RG;
  Plan pl{0, 0, 0, 0};
  if (reduce_heads) {  // whole heads a CTA: Mamba-2's per-head decay
    if (P % C::RG == 0 && P <= dh_rows && P <= kMaxHeadRows) {
      pl.rows = P;
      pl.heads = 1;
    } else if (C::RG % P == 0) {
      pl.rows = C::RG;
      pl.heads = C::RG / P;
    }
  }
  if (pl.rows == 0) {  // up to 8 groups, as long as enough CTAs remain
    int groups = 8;
    while (groups > 1 && (C::RG * groups > dh_rows ||
                          B * ((HP + C::RG * groups - 1) / (C::RG * groups)) < kMinCtas))
      groups /= 2;
    pl.rows = C::RG * groups;
  }
  pl.parts = (HP + pl.rows - 1) / pl.rows;
  pl.smem = C::smem(pl.rows, pl.heads);
  return pl;
}

template <class C>
int launch(Params& p, int reduce_p, cudaStream_t stream) {
  const Plan pl = plan_of<C>(p.B, p.H, p.P, reduce_p);
  p.rows = pl.rows;
  p.groups = pl.rows / C::RG;
  p.heads = pl.heads;
  if ((long long)p.H * p.P > 0x7fffffffLL || p.B > 65535 || pl.smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static unsigned long long opted_in = 0;  // per instantiation, by device
  if (dev < 64 && !(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ull << dev;
  }
  ssm_scan_bwd_kernel<C><<<dim3((unsigned)pl.parts, (unsigned)p.B), kThreads, pl.smem,
                           stream>>>(p);
  return (int)cudaGetLastError();
}

// (L, SPL) for N states: L lanes of 4 states (8 above 128), L a power of
// two
#define SSM_DISPATCH(N, FULL, CALL)           \
  ((N) <= 4     ? CALL(1, 4, FULL)            \
   : (N) <= 8   ? CALL(2, 4, FULL)            \
   : (N) <= 16  ? CALL(4, 4, FULL)            \
   : (N) <= 32  ? CALL(8, 4, FULL)            \
   : (N) <= 64  ? CALL(16, 4, FULL)           \
   : (N) <= 128 ? CALL(32, 4, FULL)           \
                : CALL(32, 8, FULL))

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// The kernel's plan for [B, S, H, P, N] in da_mode (0: da full over the
// states; 1: broadcast over them) and reduce_p (da broadcast over P, d da
// wanted [B, S, H]), into out[0..5]: rows a CTA, CTAs over the rows of a
// batch (dc_part's second axis, [B, parts, S, N]), heads whose d da a CTA
// sums over P (0: the launcher's second pass does), steps per chunk,
// threads per CTA and dynamic shared memory bytes.  Returns
// cudaErrorInvalidValue for N outside 1..256.
extern "C" int ssm_scan_bwd_plan(int B, int H, int P, int N, int da_mode, int reduce_p,
                                 long long* out) {
  if (N < 1 || N > 256 || (da_mode != 0 && da_mode != 1) || H < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int heads = da_mode == 1 && reduce_p;
#define SSM_PLAN(L, SPL, FULL) plan_of<Cfg<L, SPL, FULL>>(B, H, P, heads)
  const Plan pl = da_mode == 0 ? SSM_DISPATCH(N, true, SSM_PLAN) : SSM_DISPATCH(N, false, SSM_PLAN);
#undef SSM_PLAN
  out[0] = pl.rows;
  out[1] = pl.parts;
  out[2] = pl.heads;
  out[3] = chunk_len(N);
  out[4] = kThreads;
  out[5] = (long long)pl.smem;
  return 0;
}

// Launch on `stream`; returns a cudaError_t (0 on success).  All f32:
// da read at da_strides (b, s, h, p, n; 0 broadcasts), dbx [B, S, H, P, N]
// contiguous, c at c_strides (b, s, n), chunks the forward's chunk states
// [B, ceil(S / T), H, P, N] (T = `ssm_scan_bwd_plan`'s steps per chunk),
// dy [B, S, H, P] contiguous, dstate [B, H, P, N] or null.  Outputs,
// contiguous: ddbx [B, S, H, P, N]; dda [B, S, H, P, N] when da_mode is
// 0, else [B, S, H, P] summed over the states (unused, and may be null,
// when reduce_p and the plan's CTAs sum heads) and, when reduce_p,
// dda_heads [B, S, H] summed over P too; dc [B, S, N]; dstate0 [B, H, P,
// N].  dc_part is scratch [B, parts, S, N] (`ssm_scan_bwd_plan`).  N
// outside 1..256, B above 65535 or H * P above 2^31 - 1 returns
// cudaErrorInvalidValue without launching; an empty problem launches
// nothing.
extern "C" int ssm_scan_bwd_launch(
    const float* da, const float* dbx, const float* c, const float* chunks,
    const float* dy, const float* dstate, float* ddbx, float* dda,
    float* dda_heads, float* dc, float* dc_part, float* dstate0, int B, int S,
    int H, int P, int N, int da_mode, int reduce_p,
    const long long* da_strides, const long long* c_strides, void* stream) {
  if (N < 1 || N > 256 || (da_mode != 0 && da_mode != 1)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || P <= 0 || S <= 0) return 0;
  reduce_p = da_mode == 1 && reduce_p;
  Params p;
  p.da = da; p.dbx = dbx; p.c = c; p.chunks = chunks; p.dy = dy;
  p.dstate = dstate; p.ddbx = ddbx; p.dda = dda; p.dda_heads = dda_heads;
  p.dc_part = dc_part; p.dstate0 = dstate0;
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N;
  p.da_sb = da_strides[0]; p.da_ss = da_strides[1]; p.da_sh = da_strides[2];
  p.da_sp = da_strides[3]; p.da_sn = da_strides[4];
  p.c_sb = c_strides[0]; p.c_ss = c_strides[1]; p.c_sn = c_strides[2];
  p.vec = N % 4 == 0 && aligned16(dbx) && aligned16(ddbx) && aligned16(chunks) &&
          (da_mode == 1 || aligned16(dda));
  p.da_vec = N % 4 == 0 && aligned16(da) && p.da_sn == 1 && p.da_sb % 4 == 0 &&
             p.da_ss % 4 == 0 && p.da_sh % 4 == 0 && p.da_sp % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSM_LAUNCH(L, SPL, FULL) launch<Cfg<L, SPL, FULL>>(p, reduce_p, st)
  int err = da_mode == 0 ? SSM_DISPATCH(N, true, SSM_LAUNCH) : SSM_DISPATCH(N, false, SSM_LAUNCH);
#undef SSM_LAUNCH
  if (err != 0) return err;
  const long long parts = ((long long)H * P + p.rows - 1) / p.rows;
  const long long n_dc = (long long)B * S * N;
  dc_reduce_kernel<<<(unsigned)((n_dc + kReduceThreads - 1) / kReduceThreads), kReduceThreads,
                     0, st>>>(dc_part, dc, B, S, N, parts);
  err = (int)cudaGetLastError();
  if (err != 0 || !reduce_p || p.heads) return err;
  const long long n_out = (long long)B * S * H;
  rows_reduce_kernel<<<(unsigned)((n_out + kReduceThreads - 1) / kReduceThreads),
                       kReduceThreads, 0, st>>>(dda, dda_heads, n_out, P);
  return (int)cudaGetLastError();
}

extern "C" const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
