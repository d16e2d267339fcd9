// The qkv GEMM's output into attention's head-major q, k, v in one pass:
// bias, q scale, head split and (optionally) the grid pooling of k and v.
//
// Replaces no Pallas kernel. The JAX package writes this part of the
// shared-prefix engine's block (counterfactualworldmodels_tpu/models/
// fast_vmae.py: the qkv projection with its q/v bias, the reshape into
// heads, `q * scale`, the pool of the suffix keys and values) as jnp ops,
// and XLA fuses them into the dot's epilogue and one loop. PyTorch's eager
// ops do not fuse: the plain version (ops/linear.py:_qkv_heads_plain) runs
// a broadcast bias add, a permuting copy, a scaling pass and, pooled, a
// reshape, an f32 cast, a mean and a cast back, each a pass over the rows
// of the GEMM's output. This kernel reads those rows once.
//
// Contract. qkv is [S, N, 3A] row-major in T (float or bf16), A = H * d,
// columns [q | k | v], each head-major (h * d + j); q_bias and v_bias are
// [A] in T, either may be null. Out: q [S, H, N, d]; k and v [S, H, N', d],
// N' = N unpooled, else N / pool^2 with the rows of k and v averaged
// pool x pool over the (gh, gw) token grid (N = gh * gw, row-major; pooled
// cells row-major too). The arithmetic is eager's, rounding for rounding:
// q = T(f32(T(f32(x) + f32(qb))) * scale), k = x, v = T(f32(x) + f32(vb));
// pooled, each of k and v = T(sum of the pool^2 rounded values in f32 /
// pool^2). So q and unpooled k, v equal the plain version bit for bit;
// pooled k, v differ only by the order of the f32 sum.
//
// What bounds it on the H100: bytes. It reads 3A values a token and
// writes A of q and 2A / pool^2 of k and v, with a few operations each. At
// the cf decoder suffix ([256 * 3136, 1536] bf16, pool 4) that is 2.47 GB
// read and 0.92 GB written: 1.01 ms at 3.35 TB/s.
//
// Design. A thread owns a 16-byte column chunk of the rows (8 bf16 or 4
// f32 values; a chunk never straddles a head, d being a multiple of the
// chunk) for a few cells of one sample: 4 tokens unpooled, one pool x pool
// cell pooled. A cell is one token unpooled. threadIdx.x walks the chunks
// of a row, so a warp reads 512 contiguous bytes of a token and writes
// whole runs of a head's d values (128 bytes at d = 64 bf16); threadIdx.y
// takes the next cells, so a block has up to 256 threads. A thread decodes
// its column once (q, k or v; head; offset; its bias chunk), issues the
// loads of all its tokens before it uses any (16 at pool 4), then stores q
// per token, or k or v once per cell. Token indices are recomputed where
// they are used, so that the 16 loaded chunks are most of what a thread
// holds in registers. A width that is not a multiple of 16 bytes, or a
// pointer that is not 16-byte aligned, takes single-element chunks: the
// same arithmetic, still coalesced. A pool other than 1, 2 or 4 takes the
// tokens one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of T: one 16-byte word, or one value.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Chunk {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void chunk_f32(const Chunk<T, VEC>& c,
                                          float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(c.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> chunk_of(const float (&in)[VEC]) {
  Chunk<T, VEC> c;
#pragma unroll
  for (int i = 0; i < VEC; ++i) c.v[i] = from_f32<T>(in[i]);
  return c;
}

struct Args {
  const void* qkv;
  const void* q_bias;
  const void* v_bias;
  void* q;
  void* k;
  void* v;
  int n;           // tokens a sample
  int heads;
  int d;
  int gw;          // token grid width (pooled only)
  int pool;        // 1: no pooling
  int cells;       // cells a sample: n, or n / pool^2
  int cell_blocks; // blocks a sample
  float scale;
};

// Token u (row-major within the cell) of a cell: pooled, cells and the
// tokens in them run row-major over the grid.
__device__ __forceinline__ int cell_token(int cell, int u, int pool, int gw) {
  if (pool == 1) return cell;
  const int pw = gw / pool;
  return ((cell / pw) * pool + u / pool) * gw + (cell % pw) * pool + u % pool;
}

// One chunk of a token's q, k or v columns, in f32 with its bias added and
// rounded to T as eager's `qkv + bias` rounds it.
template <typename T, int VEC>
__device__ __forceinline__ void biased(const Chunk<T, VEC>& x,
                                       const float (&bias)[VEC],
                                       bool has_bias, float (&f)[VEC]) {
  chunk_f32(x, f);
  if (has_bias) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      f[i] = to_f32(from_f32<T>(__fadd_rn(f[i], bias[i])));
  }
}

// The cells a thread takes: 4 tokens unpooled, one cell pooled.
template <int P>
__host__ __device__ constexpr int cells_per_thread() {
  return P == 1 ? 4 : 1;
}

// P: the pool at compile time (1, 2 or 4), every load of a thread issued
// before any is used; 0 reads a.pool at run time and takes the tokens one
// at a time. threadIdx.x walks the row's chunks, threadIdx.y the block's
// groups of cells.
template <typename T, int VEC, int P>
__global__ void __launch_bounds__(kThreads) qkv_heads_kernel(Args a) {
  using C = Chunk<T, VEC>;
  constexpr int kCells = cells_per_thread<P>();
  const int sample = blockIdx.x / a.cell_blocks;
  const int cell0 =
      ((blockIdx.x % a.cell_blocks) * blockDim.y + threadIdx.y) * kCells;
  if (cell0 >= a.cells) return;
  const int width = a.heads * a.d;          // A
  const int row_chunks = 3 * width / VEC;
  const int head_chunks = a.d / VEC;
  const C* __restrict__ in = static_cast<const C*>(a.qkv) +
                             static_cast<size_t>(sample) * a.n * row_chunks;

  for (int c = threadIdx.x; c < row_chunks; c += blockDim.x) {
    const int which = c / (width / VEC);    // 0 q, 1 k, 2 v
    const int col = c - which * (width / VEC);
    const int head = col / head_chunks;
    const int j = (col - head * head_chunks) * VEC;
    const T* bias_p = which == 0   ? static_cast<const T*>(a.q_bias)
                      : which == 2 ? static_cast<const T*>(a.v_bias)
                                   : nullptr;
    const bool has_bias = bias_p != nullptr;
    float bias[VEC];
    if (has_bias) chunk_f32(reinterpret_cast<const C*>(bias_p)[col], bias);
    // this sample's rows of the head in the output, at offset j
    const size_t out_rows = static_cast<size_t>(sample) * a.heads + head;
    T* __restrict__ q = static_cast<T*>(a.q) + out_rows * a.n * a.d + j;
    T* __restrict__ kv = static_cast<T*>(which == 1 ? a.k : a.v) +
                         out_rows * a.cells * a.d + j;
    if constexpr (P > 0) {
      constexpr int kPerCell = P * P;
      constexpr int kLoads = kCells * kPerCell;
      C x[kLoads];
#pragma unroll
      for (int t = 0; t < kLoads; ++t) {
        const int cell = cell0 + t / kPerCell;
        if (cell < a.cells)
          x[t] = in[static_cast<size_t>(
                        cell_token(cell, t % kPerCell, P, a.gw)) *
                        row_chunks + c];
      }
      if (which == 0) {
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          const int cell = cell0 + t / kPerCell;
          if (cell >= a.cells) continue;
          float f[VEC];
          biased<T, VEC>(x[t], bias, has_bias, f);
#pragma unroll
          for (int i = 0; i < VEC; ++i) f[i] = __fmul_rn(f[i], a.scale);
          const int token = cell_token(cell, t % kPerCell, P, a.gw);
          *reinterpret_cast<C*>(q + static_cast<size_t>(token) * a.d) =
              chunk_of<T, VEC>(f);
        }
        continue;
      }
#pragma unroll
      for (int cc = 0; cc < kCells; ++cc) {
        if (cell0 + cc >= a.cells) continue;
        float sum[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] = 0.f;
#pragma unroll
        for (int u = 0; u < kPerCell; ++u) {
          float f[VEC];
          biased<T, VEC>(x[cc * kPerCell + u], bias, has_bias, f);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = __fadd_rn(sum[i], f[i]);
        }
        if (kPerCell > 1) {
          // eager's f32 mean of the pool: the sum over the count
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            sum[i] = __fdiv_rn(sum[i], static_cast<float>(kPerCell));
        }
        *reinterpret_cast<C*>(kv + static_cast<size_t>(cell0 + cc) * a.d) =
            chunk_of<T, VEC>(sum);
      }
    } else {
      const int cell = cell0, pool = a.pool, per_cell = pool * pool;
      float sum[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] = 0.f;
      for (int u = 0; u < per_cell; ++u) {
        const int token = cell_token(cell, u, pool, a.gw);
        float f[VEC];
        biased<T, VEC>(in[static_cast<size_t>(token) * row_chunks + c], bias,
                       has_bias, f);
        if (which == 0) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) f[i] = __fmul_rn(f[i], a.scale);
          *reinterpret_cast<C*>(q + static_cast<size_t>(token) * a.d) =
              chunk_of<T, VEC>(f);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = __fadd_rn(sum[i], f[i]);
        }
      }
      if (which != 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          sum[i] = __fdiv_rn(sum[i], static_cast<float>(per_cell));
        *reinterpret_cast<C*>(kv + static_cast<size_t>(cell) * a.d) =
            chunk_of<T, VEC>(sum);
      }
    }
  }
}

template <typename T, int VEC, int P>
int launch_pool(Args a, int samples, cudaStream_t stream) {
  const int row_chunks = 3 * a.heads * a.d / VEC;
  const int x = std::min(kThreads, (row_chunks + 31) / 32 * 32);
  const int y = std::max(1, kThreads / x);
  const dim3 block(x, y);
  const int per_block = y * cells_per_thread<P>();
  a.cell_blocks = (a.cells + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(samples) * a.cell_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qkv_heads_kernel<T, VEC, P>
      <<<static_cast<unsigned>(blocks), block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const Args& a, int samples, cudaStream_t stream) {
  switch (a.pool) {
    case 1: return launch_pool<T, VEC, 1>(a, samples, stream);
    case 2: return launch_pool<T, VEC, 2>(a, samples, stream);
    case 4: return launch_pool<T, VEC, 4>(a, samples, stream);
    default: return launch_pool<T, VEC, 0>(a, samples, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const Args& a, int samples, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.d % kVec == 0 && aligned16(a.qkv) && aligned16(a.q) &&
                   aligned16(a.k) && aligned16(a.v) &&
                   (a.q_bias == nullptr || aligned16(a.q_bias)) &&
                   (a.v_bias == nullptr || aligned16(a.v_bias));
  return vec ? launch_vec<T, kVec>(a, samples, stream)
             : launch_vec<T, 1>(a, samples, stream);
}

}  // namespace

// dtype: 0 float, 1 bf16 (every tensor). q_bias, v_bias: null for none.
// pool 1: k and v [S, H, N, d]; pool > 1: gh * gw == n, both divisible by
// pool, k and v [S, H, n / pool^2, d]. Returns a CUDA error code (0 on
// success).
extern "C" int cwm_qkv_heads(const void* qkv, const void* q_bias,
                             const void* v_bias, void* q, void* k, void* v,
                             int samples, int n, int heads, int d, int gh,
                             int gw, int pool, float scale, int dtype,
                             void* stream) {
  if (samples <= 0 || n <= 0 || heads <= 0 || d <= 0 || pool <= 0 ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool > 1 && (gh * gw != n || gh % pool != 0 || gw % pool != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{qkv, q_bias, v_bias, q, k, v, n, heads, d,
               pool > 1 ? gw : 1, pool, n / (pool * pool), 0, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, samples, s)
                    : launch<__nv_bfloat16>(a, samples, s);
}
