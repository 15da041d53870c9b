// Fused FedGDA-GT local-step update for Hopper (sm_90a), over a table of
// leaves in one launch:
//
//   out_i = cast_z( z_i + s_i * (g_i + c_i) )     s_i = sign_i * eta_i
//
// Replaces `repro/kernels/gt_update.py` `gt_update_2d` (the Pallas TPU
// kernel), which the JAX engine applies as `update_fn` on every local
// step after the fused anchor step, leaf by leaf.  Here one launch takes
// every leaf of x and y whose (z dtype, c dtype) pair it holds, so a
// local step is one launch (`kernels/gt_update.py` `gt_update_many`).
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
// Bound: HBM bytes, numel * (2*|z| + |g| + |c|) per leaf -- z, g and c
// read once, out written once, two flops per element.
//
// Layout of a launch.  The table (`Table<CAP>`) is a __grid_constant__
// kernel parameter: per leaf its four pointers, numel, s, whether it runs
// vectorized, and the inclusive prefix of its block counts.  A block finds
// its leaf by a binary search of that prefix, so a 512 KB leaf and a 1 GB
// leaf share one launch; a leaf's blocks walk it grid-stride.  A "unit" is
// one 16-byte access of z (2 f64, 4 f32 or 8 bf16 values, V = 16 / |z|),
// with g and out alike and c read as V values of its own width, where
// the leaf's z, g and out are 16-byte aligned and c is aligned to V * |c|;
// the leaf's last numel % V values, or every value of a misaligned leaf
// (a contiguous view at an odd offset), are scalar units.  The host
// (`gt_update.plan_launches`) fills the table; its CPU tests walk the
// same unit map and check that every element is covered once.
//
// Table size: CAP 256 leaves take 256 * (4 * 8 + 8 + 8 + 4 + 1) + 4 =
// 13,572 bytes of parameters.  Kernel parameters may take 32,764 bytes on
// sm_70 and later since CUDA 12.1 (4,096 before); the card's toolkit is
// CUDA 12.8.  A second instantiation with CAP 8 (428 bytes) serves the
// usual one or two leaves of x and y, so their launches copy no more.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// dtype codes shared with kernels/gt_update.py
enum DType : int { kF64 = 0, kF32 = 1, kBF16 = 2, kFP8E4M3 = 3 };

constexpr int kThreads = 256;
constexpr int kSmallCap = 8;
constexpr int kLargeCap = 256;

// one leaf as the host packs it (`gt_update.py` `_LEAF`, 56 bytes)
struct Leaf {
  unsigned long long z, g, c, out;
  long long n;
  double s;
  int blocks;
  int vec;
};
static_assert(sizeof(Leaf) == 56, "Leaf must match the host's record");

template <int CAP>
struct Table {
  const void* z[CAP];
  const void* g[CAP];
  const void* c[CAP];
  void* out[CAP];
  long long n[CAP];
  double s[CAP];
  int block_end[CAP];  // inclusive prefix of the leaves' block counts
  unsigned char vec[CAP];
  int count;
};

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

__device__ __forceinline__ double store_of(double v, double) { return v; }
__device__ __forceinline__ float store_of(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 store_of(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// a register word of B bytes, moved by one load or store
template <int B> struct Word;
template <> struct Word<16> { using type = int4; };
template <> struct Word<8> { using type = int2; };
template <> struct Word<4> { using type = int; };
template <> struct Word<2> { using type = short; };

// V values of X, loaded or stored as one access
template <typename X, int V>
struct alignas(sizeof(X) * V) Vec {
  X v[V];
};

template <typename X, int V>
__device__ __forceinline__ Vec<X, V> load_vec(const X* p) {
  using W = typename Word<sizeof(X) * V>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  Vec<X, V> r;
  memcpy(&r, &w, sizeof(W));
  return r;
}

template <typename X, int V>
__device__ __forceinline__ void store_vec(X* p, const Vec<X, V>& v) {
  using W = typename Word<sizeof(X) * V>::type;
  W w;
  memcpy(&w, &v, sizeof(W));
  *reinterpret_cast<W*>(p) = w;
}

template <typename Z, typename C, typename Acc, int CAP>
__global__ void __launch_bounds__(kThreads)
gt_update_kernel(const __grid_constant__ Table<CAP> t) {
  constexpr int V = 16 / (int)sizeof(Z);
  // the leaf of this block: the first whose block_end exceeds blockIdx.x
  const int b = (int)blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.block_end[mid] > b) hi = mid;
    else lo = mid + 1;
  }
  const int first = lo ? t.block_end[lo - 1] : 0;
  const int64_t stride = (int64_t)(t.block_end[lo] - first) * kThreads;
  const Z* __restrict__ z = static_cast<const Z*>(t.z[lo]);
  const Z* __restrict__ g = static_cast<const Z*>(t.g[lo]);
  const C* __restrict__ c = static_cast<const C*>(t.c[lo]);
  Z* __restrict__ out = static_cast<Z*>(t.out[lo]);
  const int64_t n = t.n[lo];
  const Acc s = (Acc)t.s[lo];
  const int64_t nvec = t.vec[lo] ? n / V : 0;
  const int64_t units = nvec + (n - nvec * V);
  for (int64_t u = (int64_t)(b - first) * kThreads + threadIdx.x; u < units; u += stride) {
    if (u < nvec) {
      const int64_t i = u * V;
      const Vec<Z, V> zv = load_vec<Z, V>(z + i);
      const Vec<Z, V> gv = load_vec<Z, V>(g + i);
      const Vec<C, V> cv = load_vec<C, V>(c + i);
      Vec<Z, V> ov;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const Acc upd = mul_rn(s, add_rn(to_acc(gv.v[j], s), to_acc(cv.v[j], s)));
        ov.v[j] = store_of(add_rn(to_acc(zv.v[j], s), upd), Z());
      }
      store_vec<Z, V>(out + i, ov);
    } else {
      const int64_t i = nvec * V + (u - nvec);
      const Acc upd = mul_rn(s, add_rn(to_acc(g[i], s), to_acc(c[i], s)));
      out[i] = store_of(add_rn(to_acc(z[i], s), upd), Z());
    }
  }
}

template <int CAP>
void fill(Table<CAP>& t, const Leaf* leaves, int count) {
  int end = 0;
  for (int i = 0; i < count; ++i) {
    const Leaf& l = leaves[i];
    t.z[i] = reinterpret_cast<const void*>(l.z);
    t.g[i] = reinterpret_cast<const void*>(l.g);
    t.c[i] = reinterpret_cast<const void*>(l.c);
    t.out[i] = reinterpret_cast<void*>(l.out);
    t.n[i] = l.n;
    t.s[i] = l.s;
    end += l.blocks;
    t.block_end[i] = end;
    t.vec[i] = (unsigned char)(l.vec != 0);
  }
  t.count = count;
}

template <typename Z, typename C, typename Acc>
int launch(const Leaf* leaves, int count, cudaStream_t stream) {
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (leaves[i].n <= 0 || leaves[i].blocks <= 0) return (int)cudaErrorInvalidValue;
    blocks += leaves[i].blocks;
  }
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (count <= kSmallCap) {
    Table<kSmallCap> t;
    fill(t, leaves, count);
    gt_update_kernel<Z, C, Acc, kSmallCap><<<(unsigned)blocks, kThreads, 0, stream>>>(t);
  } else {
    Table<kLargeCap> t;
    fill(t, leaves, count);
    gt_update_kernel<Z, C, Acc, kLargeCap><<<(unsigned)blocks, kThreads, 0, stream>>>(t);
  }
  return (int)cudaGetLastError();
}

int dispatch(const Leaf* leaves, int count, int z_dtype, int c_dtype, cudaStream_t st) {
  switch (z_dtype) {
    case kF64:
      switch (c_dtype) {
        case kF64: return launch<double, double, double>(leaves, count, st);
        case kF32: return launch<double, float, double>(leaves, count, st);
        case kBF16: return launch<double, __nv_bfloat16, double>(leaves, count, st);
        case kFP8E4M3: return launch<double, __nv_fp8_e4m3, double>(leaves, count, st);
      }
      break;
    case kF32:
      switch (c_dtype) {
        case kF32: return launch<float, float, float>(leaves, count, st);
        case kBF16: return launch<float, __nv_bfloat16, float>(leaves, count, st);
        case kFP8E4M3: return launch<float, __nv_fp8_e4m3, float>(leaves, count, st);
      }
      break;
    case kBF16:
      switch (c_dtype) {
        case kBF16: return launch<__nv_bfloat16, __nv_bfloat16, float>(leaves, count, st);
        case kFP8E4M3: return launch<__nv_bfloat16, __nv_fp8_e4m3, float>(leaves, count, st);
      }
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Leaves one launch may take.
extern "C" int gt_update_table_capacity() { return kLargeCap; }

// Threads per block (the host sizes each leaf's block count with it).
extern "C" int gt_update_threads() { return kThreads; }

// Launch one table of `count` leaves (1 <= count <= the capacity, each
// with numel >= 1 and blocks >= 1) on `stream`, on device `device`;
// returns a cudaError_t (0 on success).  Every leaf's z, g and out have
// z_dtype, its c has c_dtype.  Unsupported pairs return
// cudaErrorInvalidValue without launching.  The calling thread's current
// device is switched to `device` for the launch and restored after.
extern "C" int gt_update_many_launch(const void* leaves, int count, int z_dtype,
                                     int c_dtype, int device, void* stream) {
  if (count < 1 || count > kLargeCap) return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const int rc = dispatch(static_cast<const Leaf*>(leaves), count, z_dtype, c_dtype,
                          static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

extern "C" const char* gt_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
