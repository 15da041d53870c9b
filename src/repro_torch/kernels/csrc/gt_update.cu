// Fused FedGDA-GT local-step update for Hopper (sm_90a):
//
//   out = cast_z( z + (sign * eta) * (g + c) )
//
// Replaces `repro/kernels/gt_update.py` `gt_update_2d` (the Pallas TPU
// kernel), which the JAX engine applies as `update_fn` on every local
// step after the fused anchor step.
//
// Arithmetic runs in the compute type of z: f64 stays f64 (the Pallas body
// downcasts to f32, which would cap Theorem 1's exact limit); f32 and bf16
// compute in f32.  c is read in its own stored type (f64, f32, bf16 or fp8
// e4m3) and converted exactly, so a narrow correction is never widened in
// device memory.  Every operation rounds to nearest with no FMA
// contraction (__fadd_rn/__fmul_rn, __dadd_rn/__dmul_rn, and the build
// passes -fmad=false), and bf16 results are rounded with
// __float2bfloat16_rn: the kernel equals the plain PyTorch version
// (`kernels/ref.py` `gt_update_ref`) bit for bit.
//
// Bound: HBM bytes, numel * (2*|z| + |g| + |c|) -- z, g and c read once,
// out written once, two flops per element.  This is a simple kernel that
// is correct: a flat grid-stride loop over numel with a masked tail, one
// element per thread per iteration.  Vector loads and a tuned grid are
// left for a later change.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with kernels/gt_update.py
enum DType : int { kF64 = 0, kF32 = 1, kBF16 = 2, kFP8E4M3 = 3 };

__device__ __forceinline__ double to_acc(double v, double) { return v; }
__device__ __forceinline__ double to_acc(float v, double) { return (double)v; }
__device__ __forceinline__ double to_acc(__nv_bfloat16 v, double) {
  return (double)__bfloat162float(v);
}
__device__ __forceinline__ double to_acc(__nv_fp8_e4m3 v, double) {
  return (double)(float)v;
}
__device__ __forceinline__ float to_acc(float v, float) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(__nv_fp8_e4m3 v, float) {
  return (float)v;
}

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Z, typename C, typename Acc>
__global__ void gt_update_kernel(const Z* __restrict__ z,
                                 const Z* __restrict__ g,
                                 const C* __restrict__ c,
                                 Z* __restrict__ out, int64_t n, Acc s) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Acc upd = mul_rn(s, add_rn(to_acc(g[i], s), to_acc(c[i], s)));
    store(out + i, add_rn(to_acc(z[i], s), upd));
  }
}

constexpr int kThreads = 256;

int num_blocks(int64_t n) {
  static int sms = 0;  // SM count of the first device launched on
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  // enough resident blocks to fill every SM (2048 threads each), never
  // more than the elements need
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t fill = (int64_t)sms * (2048 / kThreads);
  return (int)(need < fill ? need : fill);
}

template <typename Z, typename C, typename Acc>
int launch(const void* z, const void* g, const void* c, void* out, int64_t n,
           double s, cudaStream_t stream) {
  gt_update_kernel<Z, C, Acc><<<num_blocks(n), kThreads, 0, stream>>>(
      static_cast<const Z*>(z), static_cast<const Z*>(g),
      static_cast<const C*>(c), static_cast<Z*>(out), n, (Acc)s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  z, g and out
// share z_dtype; c has c_dtype.  Unsupported pairs return
// cudaErrorInvalidValue without launching.  n == 0 launches nothing.
extern "C" int gt_update_launch(const void* z, const void* g, const void* c,
                                void* out, long long n, int z_dtype,
                                int c_dtype, double s, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (z_dtype) {
    case kF64:
      switch (c_dtype) {
        case kF64: return launch<double, double, double>(z, g, c, out, n, s, st);
        case kF32: return launch<double, float, double>(z, g, c, out, n, s, st);
        case kBF16: return launch<double, __nv_bfloat16, double>(z, g, c, out, n, s, st);
        case kFP8E4M3: return launch<double, __nv_fp8_e4m3, double>(z, g, c, out, n, s, st);
      }
      break;
    case kF32:
      switch (c_dtype) {
        case kF32: return launch<float, float, float>(z, g, c, out, n, s, st);
        case kBF16: return launch<float, __nv_bfloat16, float>(z, g, c, out, n, s, st);
        case kFP8E4M3: return launch<float, __nv_fp8_e4m3, float>(z, g, c, out, n, s, st);
      }
      break;
    case kBF16:
      switch (c_dtype) {
        case kBF16: return launch<__nv_bfloat16, __nv_bfloat16, float>(z, g, c, out, n, s, st);
        case kFP8E4M3: return launch<__nv_bfloat16, __nv_fp8_e4m3, float>(z, g, c, out, n, s, st);
      }
      break;
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gt_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
