// Wire-payload unpack for Hopper (sm_90a), over a table of leaves in one
// launch: unpack the words, dequantize with dequantize_levels' expression
// and write the dense [rows, cols] correction of every leaf.
//
// Replaces `repro/kernels/pack_payload.py:141` `unpack_payload_2d` (the
// Pallas TPU kernel behind the packed wire transport's decode,
// `fed/transport.py`).  It equals the plain version
// (`kernels/ref.py` `decode_payload_ref`) bit for bit:
//
//   value     = Store(mul_rn(sub_rn(lev, s), t)),  t = mul_rn(scale > 0 ?
//               scale : 1, 1/s), in the compute type (f64 for f64, else f32)
//   kept slot lands as Store(add_rn(0, value)), as JAX's scatter-add into
//               zeros does (a kept -0.0 decodes to +0.0); quant_dense
//               writes the value itself
//
// Encodings (codes shared with kernels/pack_payload.py):
//   0 quant        words [R, W]: the k kept levels, storage_bits each
//   1 quant_dense  words [R, W]: all C levels
//   2 sparse       the k kept values [R, k] in the leaf's type
//   3 dense        the row [R, C] in the leaf's type
// idx [R, k] (uint16 or int32) is read for quant and sparse; null means the
// implicit iota (k == cols), slot j at column j.  scale [R, 1] in the
// compute type is read for quant and quant_dense; null reads as 0.  The
// contract: a row's indices are unique, as every producer writes them
// (`ref.pack_payload_ref`, the pack kernel, the iota); an index < 0 or >=
// cols is dropped, as JAX's scatter drops it (a NaN row's padding slots
// hold cols + j).  The kernel does not rely on sorted order.
//
// Bound: HBM bytes -- data, idx and scale read once, the dense rows written
// once.  At the main path's [16, 4096] f64 the output is 91% of them; at
// that size the time is latency (an L2 round trip, two barriers), not
// bytes.  Six 256-thread blocks stay resident an SM (kMinBlocks), so that
// at many rows the blocks waiting on their loads leave others storing.
//
// Layout of a launch.  The table (`Table<CAP>`) is a __grid_constant__
// kernel parameter: per leaf its pointers, out's row stride, the spec,
// its column tile and the inclusive prefix of its block counts.  A block
// finds its leaf by a binary search of that prefix and owns one row's
// tile of columns: the host (`pack_payload.plan_unpack`) cuts rows into
// tiles so that a leaf of few rows still fills the SMs (a [16, 4096] f64
// leaf: 8 tiles of 512 columns, 128 blocks), at most kTileBytes of
// output a tile.  Each output byte is written once, from registers or
// from shared memory, in 16-byte vectors: a tile's columns before the
// first 16-byte boundary of its out row and after the last one (a ragged
// tail, an out view at an odd offset) take scalar stores.
//   quant, sparse   the tile is assembled in shared memory, placed so that
//                   its 16-byte vectors fall where out's do: zeros, then
//                   each kept slot whose column falls in the tile, then one
//                   store.  The row's idx is read by every tile of the row
//                   (from L2 after the first); a thread loads a batch of
//                   slots' indices and levels (or values) together, the
//                   first batch before the zero fill, so their round trip
//                   overlaps it.  The store is every thread's st.global.v4
//                   (one thread's cp.async.bulk of the tile measured as
//                   fast at the large payload and slower at the main one
//                   on the H100: PERF.md §6).
//   quant_dense     each thread decodes its own columns from the words
//   dense           a 16-byte vector copy (element loads where data and out
//                   sit at different offsets from a 16-byte boundary)
//   null idx        as quant_dense, column j < k taking slot j
//
// Table size: CAP 256 leaves take 256 * (96 + 4) + 4 = 25,604 bytes of
// parameters (32,764 allowed since CUDA 12.1); a second instantiation of
// CAP 8 (804 bytes) serves the usual x and y.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// dtype codes shared with kernels/pack_payload.py
enum DType : int { kF64 = 0, kF32 = 1, kBF16 = 2, kFP8E4M3 = 3 };
enum Encoding : int { kQuant = 0, kQuantDense = 1, kSparse = 2, kDense = 3 };

constexpr int kThreads = 256;
constexpr int kSmallCap = 8;
constexpr int kLargeCap = 256;
constexpr int kTileBytes = 16384;
constexpr int kBatch = 4;  // slots a thread loads before it writes them
// blocks an SM keeps resident (at most 40 registers a thread): a row a
// block at the large shape needs them to keep HBM busy
constexpr int kMinBlocks = 6;

// one leaf as the host packs it (`pack_payload.py` `_UNPACK_LEAF`, 96 bytes)
struct Leaf {
  unsigned long long data, idx, scale, out;
  long long out_stride;  // elements between out rows
  double s, inv_s;       // 2^(bits-1) - 1 and its inverse, as the host's doubles
  int rows, cols, k, bits, enc, idx_u16, words;
  int tile;    // columns a block owns (the last tile of a row may be short)
  int tiles;   // tiles a row
  int blocks;  // rows * tiles
};
static_assert(sizeof(Leaf) == 96, "Leaf must match the host's record");

template <int CAP>
struct Table {
  Leaf leaf[CAP];
  int block_end[CAP];  // inclusive prefix of the leaves' block counts
  int count;
};

// ------------------------------------------------------- conversions
__device__ __forceinline__ double to_ct(double v, double) { return v; }
__device__ __forceinline__ float to_ct(float v, float) { return v; }
__device__ __forceinline__ float to_ct(__nv_bfloat16 v, float) { return __bfloat162float(v); }
__device__ __forceinline__ float to_ct(__nv_fp8_e4m3 v, float) { return (float)v; }

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double from_host(double v, double) { return v; }
__device__ __forceinline__ float from_host(double v, float) { return __double2float_rn(v); }
__device__ __forceinline__ double from_i32(int v, double) { return __int2double_rn(v); }
__device__ __forceinline__ float from_i32(int v, float) { return __int2float_rn(v); }

// f32 -> fp8 e4m3 bits with JAX's overflow rule: NaN, infinities and
// |v| > 464 give NaN keeping the sign; the rest round to nearest even
__device__ __forceinline__ unsigned char fp8_bits(float v) {
  const unsigned char sign = (unsigned char)((__float_as_uint(v) >> 24) & 0x80u);
  if (isnan(v) || fabsf(v) > 464.0f) return (unsigned char)(0x7Fu | sign);
  return (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

template <typename T> struct Store;
template <> struct Store<double> {
  __device__ static double of(double v) { return v; }
};
template <> struct Store<float> {
  __device__ static float of(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  __device__ static __nv_bfloat16 of(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Store<__nv_fp8_e4m3> {
  __device__ static __nv_fp8_e4m3 of(float v) {
    __nv_fp8_e4m3 out;
    out.__x = fp8_bits(v);
    return out;
  }
};

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// V values of T moved as one 16-byte access
template <typename T>
struct alignas(16) Vec {
  static constexpr int V = 16 / (int)sizeof(T);
  T v[V];
};

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& v) {
  int4 w;
  memcpy(&w, &v, 16);
  *reinterpret_cast<int4*>(p) = w;
}

template <typename T>
__device__ __forceinline__ Vec<T> bits_vec(int4 w) {
  Vec<T> v;
  memcpy(&v, &w, 16);
  return v;
}

// Write out columns [c0, c1) of one row: 16-byte vectors from vec(col) on
// the aligned middle, one(col) on the columns before and after it.
template <typename T, typename VecF, typename OneF>
__device__ __forceinline__ void emit(T* orow, int c0, int c1, VecF vec, OneF one) {
  constexpr int V = Vec<T>::V;
  const int o = (int)((reinterpret_cast<uintptr_t>(orow + c0) & 15) / sizeof(T));
  const int a0 = min(c1, c0 + (o ? V - o : 0));  // the first aligned column
  const int nvec = (c1 - a0) / V;
  const int a1 = a0 + nvec * V;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int col = a0 + i * V;
    store_vec(orow + col, vec(col));
  }
  const int head = a0 - c0;
  for (int i = threadIdx.x; i < head + (c1 - a1); i += kThreads) {
    const int col = i < head ? c0 + i : a1 + (i - head);
    orow[col] = one(col);
  }
}

// the dequantized level of one slot of a row's words
template <typename T, typename Acc>
struct Levels {
  const uint32_t* w;
  int lsb, lpw;  // log2 of the storage bits, of the levels per word
  uint32_t mask;
  Acc sa, t;
  __device__ __forceinline__ uint32_t word(int slot) const { return w[slot >> lpw]; }
  __device__ __forceinline__ T of(int slot, uint32_t word) const {
    const uint32_t lev = (word >> ((slot & ((1 << lpw) - 1)) << lsb)) & mask;
    return Store<T>::of(mul_rn(sub_rn(from_i32((int)lev, Acc()), sa), t));
  }
  __device__ __forceinline__ T operator()(int slot) const { return of(slot, word(slot)); }
};

// store a tile assembled in shared memory (position p at column c0 + p - o)
template <typename T>
__device__ __forceinline__ void store_tile(T* orow, int c0, int c1, const T* s, int o) {
  emit(orow, c0, c1,
       [&](int col) { return bits_vec<T>(*reinterpret_cast<const int4*>(s + (o + col - c0))); },
       [&](int col) { return s[o + col - c0]; });
}

template <typename T, int CAP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
unpack_table_kernel(const __grid_constant__ Table<CAP> t) {
  using Acc = typename AccOf<T>::type;
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  // the leaf of this block: the first whose block_end exceeds blockIdx.x
  const int b = (int)blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.block_end[mid] > b) hi = mid;
    else lo = mid + 1;
  }
  const Leaf& L = t.leaf[lo];
  const int local = b - (lo ? t.block_end[lo - 1] : 0);
  const int r = local / L.tiles;
  const int c0 = (local - r * L.tiles) * L.tile;
  const int c1 = min(c0 + L.tile, L.cols);
  const int enc = L.enc, k = L.k;
  T* orow = reinterpret_cast<T*>(L.out) + (int64_t)r * L.out_stride;

  if (enc == kDense) {
    const T* d = reinterpret_cast<const T*>(L.data) + (int64_t)r * L.cols;
    const bool same = ((reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(orow)) & 15) == 0;
    emit(orow, c0, c1,
         [&](int col) {
           if (same) return bits_vec<T>(__ldg(reinterpret_cast<const int4*>(d + col)));
           Vec<T> v;
#pragma unroll
           for (int j = 0; j < V; ++j) v.v[j] = d[col + j];
           return v;
         },
         [&](int col) { return d[col]; });
    return;
  }
  const int sb = L.bits <= 2 ? 2 : L.bits <= 4 ? 4 : L.bits <= 8 ? 8 : L.bits <= 16 ? 16 : 32;
  const Acc sc = L.scale ? reinterpret_cast<const Acc*>(L.scale)[r] : (Acc)0;
  const Acc safe = sc > (Acc)0 ? sc : (Acc)1;
  Levels<T, Acc> lv;
  lv.w = reinterpret_cast<const uint32_t*>(L.data) + (int64_t)r * L.words;
  lv.lsb = __ffs(sb) - 1;
  lv.lpw = 5 - lv.lsb;
  lv.mask = sb == 32 ? 0xFFFFFFFFu : ((1u << sb) - 1u);
  lv.sa = from_host(L.s, Acc());
  lv.t = mul_rn(safe, from_host(L.inv_s, Acc()));
  const T* vals = reinterpret_cast<const T*>(L.data) + (int64_t)r * k;
  // a kept slot's value as it lands: 0 + v
  auto kept = [&](int slot) -> T {
    const T v = enc == kSparse ? vals[slot] : lv(slot);
    return Store<T>::of(add_rn((Acc)0, to_ct(v, Acc())));
  };
  if (enc == kQuantDense || !L.idx) {
    // straight from the words or values: a column's own slot
    auto one = [&](int col) -> T {
      if (enc == kQuantDense) return lv(col);
      return col < k ? kept(col) : Store<T>::of((Acc)0);
    };
    emit(orow, c0, c1,
         [&](int col) {
           Vec<T> v;
#pragma unroll
           for (int j = 0; j < V; ++j) v.v[j] = one(col + j);
           return v;
         },
         one);
    return;
  }

  // quant / sparse: the tile in shared memory, position p at column
  // c0 + p - o (o: out's offset from a 16-byte boundary at c0, in values)
  T* s = reinterpret_cast<T*>(smem);
  const int o = (int)((reinterpret_cast<uintptr_t>(orow + c0) & 15) / sizeof(T));
  const bool u16 = L.idx_u16 != 0, sparse = enc == kSparse;
  const uint16_t* i16 = reinterpret_cast<const uint16_t*>(L.idx) + (int64_t)r * k;
  const int32_t* i32 = reinterpret_cast<const int32_t*>(L.idx) + (int64_t)r * k;
  // kBatch slots a thread at a time: their indices and words (or values)
  // are loaded first, so the first batch's loads overlap the zero fill
  for (int j0 = 0; j0 < k; j0 += kBatch * kThreads) {
    int col[kBatch];
    uint32_t word[kBatch];
    T val[kBatch];
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int j = j0 + p * kThreads + threadIdx.x;
      col[p] = -1;  // past the slots: no column
      word[p] = 0u;
      val[p] = T();
      if (j < k) {
        col[p] = u16 ? (int)i16[j] : i32[j];
        if (sparse) val[p] = vals[j];
        else word[p] = lv.word(j);
      }
    }
    if (j0 == 0) {
      const int n16 = (o + (c1 - c0) + V - 1) / V;
      for (int i = threadIdx.x; i < n16; i += kThreads)
        reinterpret_cast<int4*>(s)[i] = make_int4(0, 0, 0, 0);
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int c = col[p];
      if (c >= c0 && c < c1) {  // else another tile's, or dropped
        const T v = sparse ? val[p] : lv.of(j0 + p * kThreads + threadIdx.x, word[p]);
        s[o + c - c0] = Store<T>::of(add_rn((Acc)0, to_ct(v, Acc())));
      }
    }
  }
  __syncthreads();
  store_tile(orow, c0, c1, s, o);
}

template <int CAP>
void fill(Table<CAP>& t, const Leaf* leaves, int count) {
  int end = 0;
  for (int i = 0; i < count; ++i) {
    t.leaf[i] = leaves[i];
    end += leaves[i].blocks;
    t.block_end[i] = end;
  }
  t.count = count;
}

bool valid(const Leaf& l, size_t item) {
  const bool wordy = l.enc == kQuant || l.enc == kQuantDense;
  return l.rows > 0 && l.cols > 0 && l.k > 0 && l.enc >= 0 && l.enc <= kDense &&
         l.data && l.out && (!wordy || (l.bits >= 2 && l.bits < 32 && l.words > 0)) &&
         l.tile > 0 && (size_t)l.tile * item <= (size_t)kTileBytes &&
         l.tiles == (l.cols + l.tile - 1) / l.tile &&
         (long long)l.blocks == (long long)l.rows * l.tiles;
}

template <typename T>
int launch(const Leaf* leaves, int count, cudaStream_t stream) {
  long long blocks = 0;
  size_t smem = 0;
  for (int i = 0; i < count; ++i) {
    const Leaf& l = leaves[i];
    if (!valid(l, sizeof(T))) return (int)cudaErrorInvalidValue;
    blocks += l.blocks;
    if ((l.enc == kQuant || l.enc == kSparse) && l.idx) {
      const size_t need = ((size_t)l.tile * sizeof(T) + 16 + 15) / 16 * 16;
      smem = need > smem ? need : smem;
    }
  }
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (count <= kSmallCap) {
    Table<kSmallCap> t;
    fill(t, leaves, count);
    unpack_table_kernel<T, kSmallCap><<<(unsigned)blocks, kThreads, smem, stream>>>(t);
  } else {
    Table<kLargeCap> t;
    fill(t, leaves, count);
    unpack_table_kernel<T, kLargeCap><<<(unsigned)blocks, kThreads, smem, stream>>>(t);
  }
  return (int)cudaGetLastError();
}

int dispatch(const Leaf* leaves, int count, int dtype, cudaStream_t st) {
  switch (dtype) {
    case kF64: return launch<double>(leaves, count, st);
    case kF32: return launch<float>(leaves, count, st);
    case kBF16: return launch<__nv_bfloat16>(leaves, count, st);
    case kFP8E4M3: return launch<__nv_fp8_e4m3>(leaves, count, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Leaves one launch may take.
extern "C" int unpack_payload_table_capacity() { return kLargeCap; }

// Threads per block.
extern "C" int unpack_payload_threads() { return kThreads; }

// The most output bytes one block's tile may hold.
extern "C" int unpack_payload_tile_bytes() { return kTileBytes; }

// Launch one table of `count` leaves (1 <= count <= the capacity), every
// leaf's out of `dtype`, on `stream` on device `device`; returns a
// cudaError_t (0 on success).  A leaf the kernel does not take returns
// cudaErrorInvalidValue without launching.
// The calling thread's current device is switched to `device` for the
// launch and restored after.
extern "C" int unpack_payload_many_launch(const void* leaves, int count, int dtype,
                                          int device, void* stream) {
  if (count < 1 || count > kLargeCap) return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const int rc = dispatch(static_cast<const Leaf*>(leaves), count, dtype,
                          static_cast<cudaStream_t>(stream));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

extern "C" const char* unpack_payload_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
