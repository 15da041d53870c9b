// Selective scan (Mamba-1 / Mamba-2) for Hopper (sm_90a):
//
//   h_t = da_t * h_{t-1} + dbx_t,   y_t = <h_t, c_t>   (over the N states)
//
// Replaces `repro/kernels/ssm_scan.py` `ssm_scan` (the Pallas TPU kernel
// `_ssm_kernel`), whose sequential chunk axis carried the [d_block, N]
// state in VMEM.  Here the sequence is a loop inside the thread: a group
// of L lanes of one warp owns one (batch, head, channel) row and holds its
// N states in registers (NPT per lane, lane i holding states i, i+L, ...,
// so each load of a step is L consecutive floats), reduces <h_t, c_t>
// over the group with warp shuffles, and writes y_t.  Beyond the TPU
// kernel it starts from a given state (or zero) and writes the final
// state, which fills the serving cache.
//
// da is read through its strides and never expanded: Mamba-2's decay is
// [B, S, H, 1, 1] (stride 0 over the channel and state axes), Mamba-1's a
// full [B, S, D, 1, N]; c_coef [B, S, N] likewise.  dbx [B, S, H, P, N]
// is contiguous.
//
// Bound: HBM bytes.  dbx (B*S*D*N f32) is read once and dominates; the
// arithmetic is 4 flops per state per step.  The loop issues the loads of
// U steps before it computes them, so that each warp keeps U steps of
// reads in flight (a dependent load per step would leave the card
// latency-bound).  Built with FMA contraction (no -fmad=false): y and the
// state are held to a tolerance.  When asked, it also stores the state
// entering every chunk of T steps, from which the backward
// (`ssm_scan_bwd.cu`) recomputes h_{t-1}.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int U = 4;  // steps whose loads are in flight together

struct Params {
  const float* da;
  const float* dbx;
  const float* c;
  const float* state0;  // nullptr: start from zero
  float* y;
  float* state;
  float* chunks;  // [B, ceil(S / T), H, P, N] states entering each chunk, or null
  int B, S, H, P, N;
  long long da_sb, da_ss, da_sh, da_sp, da_sn;
  long long c_sb, c_ss, c_sn;
};

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// L lanes per row (a power of two up to 32), NPT states per lane; the
// backward's chunks are T steps long, 16 up to N = 128 states and 8 above
// (`ssm_scan_bwd.cu` `chunk_len`)
template <int L, int NPT>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(const Params p) {
  constexpr int RPW = 32 / L;  // rows per warp
  constexpr int T = NPT > 4 ? 8 : 16;  // a multiple of U
  const int lane = threadIdx.x & 31;
  const int li = lane & (L - 1);
  const long long HP = (long long)p.H * p.P;
  const long long rows = (long long)p.B * HP;
  const long long row =
      ((long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * RPW +
      lane / L;
  const bool live = row < rows;
  // a lane past the last row scans row 0 with the others (the shuffles
  // need the whole warp) and stores nothing
  const long long r = live ? row : 0;
  const long long b = r / HP, hp = r - b * HP;
  const long long hh = hp / p.P, pp = hp - hh * p.P;
  const int N = p.N;

  const float* dbx = p.dbx + (b * p.S * HP + hp) * N;
  const long long dbx_ss = HP * N;
  const float* da = p.da + b * p.da_sb + hh * p.da_sh + pp * p.da_sp;
  const float* cc = p.c + b * p.c_sb;
  float* y = p.y + b * p.S * HP + hp;

  float h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = li + j * L;
    h[j] = (p.state0 != nullptr && n < N) ? p.state0[r * N + n] : 0.f;
  }
  // the state entering each chunk of T steps, for the backward
  const long long nch = (p.S + T - 1) / T;
  float* chunk = p.chunks == nullptr ? nullptr : p.chunks + (b * nch * HP + hp) * N;
  auto save = [&](int t) {
    if (chunk != nullptr && live && t % T == 0) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = li + j * L;
        if (n < N) chunk[(long long)(t / T) * HP * N + n] = h[j];
      }
    }
  };

  int t = 0;
  for (; t + U <= p.S; t += U) {
    save(t);
    float a[U][NPT], bx[U][NPT], cv[U][NPT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = li + j * L;
        const long long s = t + u;
        const bool in = n < N;
        a[u][j] = in ? da[s * p.da_ss + n * p.da_sn] : 0.f;
        bx[u][j] = in ? dbx[s * dbx_ss + n] : 0.f;
        cv[u][j] = in ? cc[s * p.c_ss + n * p.c_sn] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        h[j] = a[u][j] * h[j] + bx[u][j];
        acc += h[j] * cv[u][j];
      }
      acc = group_sum<L>(acc);
      if (live && li == 0) y[(long long)(t + u) * HP] = acc;
    }
  }
  for (; t < p.S; ++t) {
    save(t);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = li + j * L;
      if (n < N) {
        h[j] = da[(long long)t * p.da_ss + n * p.da_sn] * h[j] +
               dbx[(long long)t * dbx_ss + n];
        acc += h[j] * cc[(long long)t * p.c_ss + n * p.c_sn];
      }
    }
    acc = group_sum<L>(acc);
    if (live && li == 0) y[(long long)t * HP] = acc;
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = li + j * L;
      if (n < N) p.state[r * N + n] = h[j];
    }
  }
}

template <int L, int NPT>
int launch(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.P;
  const long long rows_per_block = (kThreads / 32) * (32 / L);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssm_scan_kernel<L, NPT><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  All f32:
// dbx [B, S, H, P, N] contiguous; da read at da_strides (5 values, b, s,
// h, p, n; 0 broadcasts); c at c_strides (b, s, n); state0 [B, H, P, N]
// contiguous or null; y [B, S, H, P] and state [B, H, P, N] contiguous
// outputs; chunks, if not null, receives the state entering every chunk
// of T steps (16 for N <= 128, else 8), contiguous [B, ceil(S / T), H,
// P, N], for the backward.  N outside 1..256 returns cudaErrorInvalidValue without
// launching; an empty problem launches nothing (and leaves state unset).
extern "C" int ssm_scan_launch(const float* da, const float* dbx,
                               const float* c, const float* state0, float* y,
                               float* state, float* chunks, int B, int S,
                               int H, int P, int N,
                               const long long* da_strides,
                               const long long* c_strides, void* stream) {
  if (N < 1 || N > 256) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || P <= 0 || S < 0) return 0;
  Params p;
  p.da = da; p.dbx = dbx; p.c = c; p.state0 = state0; p.y = y; p.state = state;
  p.chunks = chunks;
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N;
  p.da_sb = da_strides[0]; p.da_ss = da_strides[1]; p.da_sh = da_strides[2];
  p.da_sp = da_strides[3]; p.da_sn = da_strides[4];
  p.c_sb = c_strides[0]; p.c_ss = c_strides[1]; p.c_sn = c_strides[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 1) return launch<1, 1>(p, st);
  if (N <= 2) return launch<2, 1>(p, st);
  if (N <= 4) return launch<4, 1>(p, st);
  if (N <= 8) return launch<8, 1>(p, st);
  if (N <= 16) return launch<16, 1>(p, st);
  if (N <= 32) return launch<32, 1>(p, st);
  if (N <= 64) return launch<32, 2>(p, st);
  if (N <= 128) return launch<32, 4>(p, st);
  return launch<32, 8>(p, st);
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
