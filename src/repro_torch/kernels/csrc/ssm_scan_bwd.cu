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
// One group of L lanes of one warp owns one (batch, head, channel) row,
// as in the forward, and walks the sequence backwards chunk by chunk.  A
// chunk is T = 32 / NPT steps; the forward stored the state entering each
// chunk, so the group reloads it, recomputes the chunk's T states into
// registers (T * NPT = 32 floats a lane), then runs the reverse
// recurrence over the chunk with h_{t-1} at hand.  Saving chunk states
// costs the forward one [B, S/T, H, P, N] write (1/T of dbx) against a
// second forward pass over dbx for a full recompute.
//
// The decay's gradient is reduced to da's own shape, never written at
// dbx's size where da broadcasts:
//   * da full over the states (Mamba-1's [B, S, D, 1, N]): d da_t = dh_t o
//     h_{t-1}, written per element;
//   * da broadcast over the states (stride 0 over n): each row's sum over
//     its N states, a fixed shuffle tree, written [B, S, H, P]; where da
//     also broadcasts over the channels (Mamba-2's [B, S, H, 1, 1]) a
//     second kernel sums those over P in order, into [B, S, H].
// dc_t sums h_t dy_t over all H * P channel rows of a batch: each CTA
// reduces its rows in shared memory per chunk, in row order, into a
// partial [B, CTAs, S, N]; a second kernel sums the partials in CTA order.
// No atomics: two calls give the same bits.
//
// Bound: HBM bytes.  dbx is read once (the recompute) and d dbx written
// once, both B*S*H*P*N f32; da, c, dy and the chunk states are small
// beside them (d da too, but for Mamba-1, where it is dbx's size).
// Built with FMA contraction (no -fmad=false): held to a tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* da;
  const float* dbx;
  const float* c;
  const float* chunks;  // [B, nch, H, P, N], the forward's
  const float* dy;      // [B, S, H, P]
  const float* dstate;  // [B, H, P, N] or null (zero)
  float* ddbx;          // [B, S, H, P, N]
  float* dda;           // mode 0: [B, S, H, P, N]; mode 1: [B, S, H, P]
  float* dc_part;       // [B, gridDim.x, S, N]
  float* dstate0;       // [B, H, P, N]
  int B, S, H, P, N;
  int da_mode;          // 0: da full over n; 1: da broadcast over n
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

// grid (row blocks over H * P, B); L lanes per row, NPT states per lane
template <int L, int NPT>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(const Params p) {
  constexpr int RPW = 32 / L, RPB = kWarps * RPW;  // rows per warp / block
  constexpr int T = 32 / NPT;                      // steps per chunk
  constexpr int NM = L * NPT;                      // states a row can hold
  __shared__ float sdc[RPB * T * NM];              // [row][step][state]

  const int lane = threadIdx.x & 31, li = lane & (L - 1);
  const int row_in = (threadIdx.x >> 5) * RPW + lane / L;
  const long long HP = (long long)p.H * p.P;
  const long long b = blockIdx.y;
  const long long hp_live = (long long)blockIdx.x * RPB + row_in;
  const bool live = hp_live < HP;
  // a lane past the last row runs row 0 with the others (the shuffles and
  // barriers need every thread) and stores nothing
  const long long hp = live ? hp_live : 0;
  const long long hh = hp / p.P, pp = hp - hh * p.P;
  const long long r = b * HP + hp;
  const int N = p.N, S = p.S;
  const long long nch = (S + T - 1) / T;

  const long long dbx_ss = HP * N;
  const float* dbx = p.dbx + (b * S * HP + hp) * N;
  float* ddbx = p.ddbx + (b * S * HP + hp) * N;
  const float* da = p.da + b * p.da_sb + hh * p.da_sh + pp * p.da_sp;
  const float* cc = p.c + b * p.c_sb;
  const float* dy = p.dy + b * S * HP + hp;
  const float* chunk = p.chunks + (b * nch * HP + hp) * N;
  float* dc_part = p.dc_part + ((b * gridDim.x + blockIdx.x) * S) * (long long)N;

  float dh[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = li + j * L;
    dh[j] = (p.dstate != nullptr && n < N) ? p.dstate[r * N + n] : 0.f;
  }

  for (long long k = nch - 1; k >= 0; --k) {
    const long long t0 = k * T;
    const int tn = (int)min((long long)T, S - t0);
    // the chunk's states, from the one entering it
    float h0[NPT], hs[T][NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = li + j * L;
      h0[j] = n < N ? chunk[k * HP * N + n] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = li + j * L;
        const float prev = u == 0 ? h0[j] : hs[u - 1][j];
        float a = 0.f, bx = 0.f;
        if (u < tn && n < N) {
          const long long s = t0 + u;
          a = da[s * p.da_ss + n * p.da_sn];
          bx = dbx[s * dbx_ss + n];
        }
        hs[u][j] = a * prev + bx;
      }
    // the reverse recurrence over the chunk
#pragma unroll
    for (int u = T - 1; u >= 0; --u) {
      if (u < tn) {
        const long long s = t0 + u;
        const float g = dy[s * HP];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int n = li + j * L;
          const float prev = u == 0 ? h0[j] : hs[u - 1][j];
          float contrib = 0.f;
          if (n < N) {
            dh[j] += cc[s * p.c_ss + n * p.c_sn] * g;
            if (live) ddbx[s * dbx_ss + n] = dh[j];
            const float dda = dh[j] * prev;
            if (p.da_mode == 0) {
              if (live) p.dda[(b * S * HP + s * HP + hp) * N + n] = dda;
            } else {
              acc += dda;
            }
            contrib = live ? hs[u][j] * g : 0.f;
            dh[j] *= da[s * p.da_ss + n * p.da_sn];
          }
          sdc[(row_in * T + u) * NM + n] = contrib;
        }
        if (p.da_mode == 1) {
          acc = group_sum<L>(acc);
          if (live && li == 0) p.dda[b * S * HP + s * HP + hp] = acc;
        }
      }
    }
    __syncthreads();
    // this block's rows' h_t dy_t, summed in row order, per (step, state)
    for (int e = threadIdx.x; e < T * N; e += kThreads) {
      const int u = e / N, n = e - u * N;
      if (u < tn) {
        float sum = 0.f;
        for (int rr = 0; rr < RPB; ++rr) sum += sdc[(rr * T + u) * NM + n];
        dc_part[(t0 + u) * N + n] = sum;
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = li + j * L;
      if (n < N) p.dstate0[r * N + n] = dh[j];
    }
  }
}

// dc[b, t, n] = sum over the CTAs' partials, in CTA order
__global__ void __launch_bounds__(kThreads) dc_reduce_kernel(const float* part, float* dc,
                                                            long long B, long long S,
                                                            long long N, int parts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * S * N) return;
  const long long b = i / (S * N), tn = i - b * S * N;
  const float* src = part + b * parts * S * N + tn;
  float sum = 0.f;
  for (int k = 0; k < parts; ++k) sum += src[(long long)k * S * N];
  dc[i] = sum;
}

// out[b, t, h] = sum over p of rows[b, t, h, p], in channel order
__global__ void __launch_bounds__(kThreads) rows_reduce_kernel(const float* rows, float* out,
                                                              long long n_out, int P) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const float* src = rows + i * P;
  float sum = 0.f;
  for (int k = 0; k < P; ++k) sum += src[k];
  out[i] = sum;
}

template <int L, int NPT>
long long blocks_x(long long HP) {
  constexpr int RPB = kWarps * (32 / L);
  return (HP + RPB - 1) / RPB;
}

template <int L, int NPT>
int launch(const Params& p, cudaStream_t stream) {
  const long long bx = blocks_x<L, NPT>((long long)p.H * p.P);
  if (bx > 0x7fffffffLL || p.B > 65535) return (int)cudaErrorInvalidValue;
  ssm_scan_bwd_kernel<L, NPT><<<dim3((unsigned)bx, (unsigned)p.B), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// the configuration the forward takes for N states (`ssm_scan.cu`)
#define SSM_DISPATCH(N, CALL)               \
  ((N) <= 1    ? CALL(1, 1)                 \
   : (N) <= 2  ? CALL(2, 1)                 \
   : (N) <= 4  ? CALL(4, 1)                 \
   : (N) <= 8  ? CALL(8, 1)                 \
   : (N) <= 16 ? CALL(16, 1)                \
   : (N) <= 32 ? CALL(32, 1)                \
   : (N) <= 64 ? CALL(32, 2)                \
   : (N) <= 128 ? CALL(32, 4)               \
                : CALL(32, 8))

}  // namespace

// The number of CTAs over the channel rows (H * P) of one batch: the
// partials' second axis, [B, parts, S, N].
extern "C" long long ssm_scan_bwd_parts(int H, int P, int N) {
  const long long HP = (long long)H * P;
#define SSM_PARTS(L, NPT) blocks_x<L, NPT>(HP)
  return SSM_DISPATCH(N, SSM_PARTS);
#undef SSM_PARTS
}

// Launch on `stream`; returns a cudaError_t (0 on success).  All f32:
// da read at da_strides (b, s, h, p, n; 0 broadcasts), dbx [B, S, H, P, N]
// contiguous, c at c_strides (b, s, n), chunks the forward's chunk states
// [B, ceil(S / T), H, P, N], dy [B, S, H, P] contiguous, dstate [B, H, P,
// N] or null.  Outputs, contiguous: ddbx [B, S, H, P, N]; dda [B, S, H,
// P, N] when da_mode is 0, else [B, S, H, P] summed over the states and,
// when reduce_p, dda_heads [B, S, H] summed over P too; dc [B, S, N];
// dstate0 [B, H, P, N].  dc_part is scratch [B, parts, S, N]
// (`ssm_scan_bwd_parts`).  N outside 1..256 or B above 65535 returns
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
  Params p;
  p.da = da; p.dbx = dbx; p.c = c; p.chunks = chunks; p.dy = dy;
  p.dstate = dstate; p.ddbx = ddbx; p.dda = dda; p.dc_part = dc_part;
  p.dstate0 = dstate0;
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N; p.da_mode = da_mode;
  p.da_sb = da_strides[0]; p.da_ss = da_strides[1]; p.da_sh = da_strides[2];
  p.da_sp = da_strides[3]; p.da_sn = da_strides[4];
  p.c_sb = c_strides[0]; p.c_ss = c_strides[1]; p.c_sn = c_strides[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSM_LAUNCH(L, NPT) launch<L, NPT>(p, st)
  int err = SSM_DISPATCH(N, SSM_LAUNCH);
#undef SSM_LAUNCH
  if (err != 0) return err;
  const int parts = (int)ssm_scan_bwd_parts(H, P, N);
  const long long n_dc = (long long)B * S * N;
  dc_reduce_kernel<<<(unsigned)((n_dc + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      dc_part, dc, B, S, N, parts);
  err = (int)cudaGetLastError();
  if (err != 0 || !(da_mode == 1 && reduce_p)) return err;
  const long long n_out = (long long)B * S * H;
  rows_reduce_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      dda, dda_heads, n_out, P);
  return (int)cudaGetLastError();
}

extern "C" const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
