// RAFT correlation-pyramid window lookup for Hopper (sm_90a): every level of
// one refinement iteration in one launch.
//
// Replaces the TPU kernels
//   counterfactualworldmodels_tpu/models/raft/corr.py:_window_lookup_lanes_kernel
//     (launched by _window_lookup_lanes; entry lookup_pyramid_lanes) -- K3
//   counterfactualworldmodels_tpu/models/raft/corr.py:_window_lookup_kernel
//     (launched by _window_lookup_tpu, the CWM_RAFT_LANES=0 route)   -- K4
// Both TPU layouts (queries on lanes; padded row-major levels) exist only to
// suit the TPU's vector unit and MXU, and both launch once per level. Here
// one kernel reads the unpadded row-major levels [N, h_l, w_l] directly and
// serves all levels of a lookup_pyramid call (or the one level of a
// window_lookup call).
//
// Contract. Query n has coordinates (xs[n * stride], ys[n * stride]). On
// level l they are scaled by 2^-l (exact in f32, so equal to the
// reference's x / 2**l) and clipped to [-(r+1), w_l+r] and [-(r+1), h_l+r]
// as corr.py:99-100 does. out[n, l, a, b] is the bilinear sample of level l,
// row n, at (x - r + a, y - r + b), with zeros outside the level (the zero
// padding of grid_sample): [N, L, 2r+1, 2r+1], levels outer, in
// [x-offset, y-offset] order (corr.py:122) -- lookup_pyramid's
// [B, H, W, L*(2r+1)^2]. Sums are f32, like the JAX lookup. The output is
// f32, or bf16 rounded to nearest even (bitwise the f32 output cast) for a
// consumer that computes in bf16.
//
// What bounds it on the H100: bytes. It writes L*(2r+1)^2 values per query
// (1296 bytes at L = 4, r = 4, f32), reads at most (2r+2)^2 values of each
// level, and does about 4 operations per output.
//
// Design. A window is one (query, level). Each warp takes 32 / (2r+2)
// windows (3 at r = 4) and gives each 2r+2 lanes, one per patch column:
//  - the lanes of a window compute its set-up (scale, clip, floor,
//    fractions) in the same warp instructions, so it costs one pass per
//    warp, not one per output;
//  - each lane loads its column of the (2r+2)^2 patch: neighbouring lanes
//    read neighbouring addresses, every window value is read from device
//    memory once, and all 2r+2 loads of a lane are in flight together. A
//    value outside the level is a load predicated off (one unsigned compare
//    per row, one per column), which is cheaper than a branch on whether the
//    patch crosses an edge;
//  - separable bilinear weights in registers: the row lerp takes the right
//    neighbour's column by shuffles, then the column lerp gives the lane's
//    2r+1 outputs (x offset a = its column) with two FP operations each;
//  - the outputs go to shared memory in the final order, then the block
//    writes its outputs -- one contiguous range of [N, L*(2r+1)^2] -- with
//    16-byte (f32) or 8-byte (bf16) coalesced stores. The staging buffer
//    starts at the same offset modulo 4 as the range, so both sides of every
//    vector copy are aligned.
// The radius and the level count are template parameters: every division
// is by a constant. The level pointers and sizes are passed by value, up to
// kMaxLevels. One pass per warp and no loop, so a block's loads are all
// issued before it waits on any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Pyramid {
  const float* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct __align__(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<Bf16x4*>(p) = Bf16x4{__floats2bfloat162_rn(v.x, v.y),
                                         __floats2bfloat162_rn(v.z, v.w)};
}

// windows of a warp, and queries of a block (each query has L windows)
template <int R>
__host__ __device__ constexpr int windows_per_warp() {
  return 32 / (2 * R + 2);
}
template <int R, int L>
__host__ __device__ constexpr int queries_per_block() {
  return kWarps * windows_per_warp<R>() / L;
}

template <int R, int L, typename OutT>
__global__ void __launch_bounds__(kThreads)
    window_lookup_kernel(const __grid_constant__ Pyramid pyr,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys, const int stride,
                         OutT* __restrict__ out, const int n) {
  constexpr int P = 2 * R + 1;  // window side
  constexpr int S = 2 * R + 2;  // patch side
  constexpr int kQueries = queries_per_block<R, L>();
  extern __shared__ __align__(16) float smem[];

  const int q0 = blockIdx.x * kQueries;
  const int nq = min(kQueries, n - q0);
  const size_t first = (size_t)q0 * L * P * P;  // the block's first output
  float* staged = smem + (first & 3);           // [window][a][b]

  const int lane = threadIdx.x & 31;
  const int sub = lane / S, j = lane - sub * S;  // window of the warp, column
  const int wi = (threadIdx.x >> 5) * windows_per_warp<R>() + sub;
  const bool live = sub < windows_per_warp<R>() && wi < nq * L;

  float v[S];  // the lane's patch column, then its row lerps
  float wx = 0.f, wy = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) v[i] = 0.f;
  if (live) {
    const int q = wi / L, l = wi - q * L;
    const float* level = pyr.level[0];
    int h = pyr.h[0], w = pyr.w[0];
#pragma unroll
    for (int k = 1; k < L; ++k)
      if (l == k) {
        level = pyr.level[k];
        h = pyr.h[k];
        w = pyr.w[k];
      }
    const float scale = 1.f / (float)(1 << l);
    const size_t at = (size_t)(q0 + q) * stride;
    const float x = fminf(fmaxf(xs[at] * scale, -(R + 1.f)), (float)(w + R));
    const float y = fminf(fmaxf(ys[at] * scale, -(R + 1.f)), (float)(h + R));
    const float fx = floorf(x), fy = floorf(y);
    wx = x - fx;
    wy = y - fy;
    const int xx = (int)fx - R + j, y0 = (int)fy - R;
    const float* row = level + (size_t)(q0 + q) * h * w;
    const bool col_in = (unsigned)xx < (unsigned)w;
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (col_in && (unsigned)(y0 + i) < (unsigned)h)
        v[i] = __ldg(row + (y0 + i) * w + xx);
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float right = __shfl_down_sync(0xffffffffu, v[i], 1);
    v[i] = fmaf(wx, right - v[i], v[i]);
  }
  if (live && j < P) {
    float* dst = staged + (wi * P + j) * P;
#pragma unroll
    for (int b = 0; b < P; ++b) dst[b] = fmaf(wy, v[b + 1] - v[b], v[b]);
  }
  __syncthreads();

  // the block's outputs, [first, first + count), aligned vectors in between
  const int count = nq * L * P * P;
  const int head = min(count, (int)((4 - (first & 3)) & 3));
  const int vecs = (count - head) >> 2;
  OutT* dst = out + first;
  for (int k = threadIdx.x; k < vecs; k += kThreads)
    store4(dst + head + 4 * k,
           *reinterpret_cast<const float4*>(staged + head + 4 * k));
  const int rest = head + 4 * vecs;
  if ((int)threadIdx.x < head) store1(dst + threadIdx.x, staged[threadIdx.x]);
  if ((int)threadIdx.x < count - rest)
    store1(dst + rest + threadIdx.x, staged[rest + threadIdx.x]);
}

template <int R, int L, typename OutT>
int launch(const Pyramid& pyr, const float* xs, const float* ys, int stride,
           void* out, int n, cudaStream_t stream) {
  constexpr int P = 2 * R + 1;
  constexpr int kQueries = queries_per_block<R, L>();
  const size_t smem = (kQueries * L * P * P + 3) * sizeof(float);
  const int blocks = (n + kQueries - 1) / kQueries;
  window_lookup_kernel<R, L, OutT><<<blocks, kThreads, smem, stream>>>(
      pyr, xs, ys, stride, static_cast<OutT*>(out), n);
  return (int)cudaGetLastError();
}

template <int R, typename OutT>
int launch_levels(int levels, const Pyramid& pyr, const float* xs,
                  const float* ys, int stride, void* out, int n,
                  cudaStream_t stream) {
  switch (levels) {
    case 1: return launch<R, 1, OutT>(pyr, xs, ys, stride, out, n, stream);
    case 2: return launch<R, 2, OutT>(pyr, xs, ys, stride, out, n, stream);
    case 3: return launch<R, 3, OutT>(pyr, xs, ys, stride, out, n, stream);
    case 4: return launch<R, 4, OutT>(pyr, xs, ys, stride, out, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename OutT>
int launch_radius(int r, int levels, const Pyramid& pyr, const float* xs,
                  const float* ys, int stride, void* out, int n,
                  cudaStream_t stream) {
  switch (r) {
    case 3:
      return launch_levels<3, OutT>(levels, pyr, xs, ys, stride, out, n,
                                    stream);
    case 4:
      return launch_levels<4, OutT>(levels, pyr, xs, ys, stride, out, n,
                                    stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// levels[l]: float32 [n, hs[l], ws[l]], contiguous (a zero-size level is all
// out of bounds and never read); query i's coordinates at xs[i * stride] and
// ys[i * stride]; out: [n, num_levels, 2r+1, 2r+1], float32 (out_bf16 = 0)
// or bfloat16 (1), 16-byte aligned. r is 3 or 4 (RAFT's small and large
// models), num_levels 1 to kMaxLevels. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int cwm_window_lookup(const float* const* levels, const int* hs,
                                 const int* ws, int num_levels,
                                 const float* xs, const float* ys, int stride,
                                 void* out, int out_bf16, int n, int r,
                                 void* stream) {
  if (n <= 0 || num_levels < 1 || num_levels > kMaxLevels || stride < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr = {};
  for (int l = 0; l < num_levels; ++l) {
    if (hs[l] < 0 || ws[l] < 0) return (int)cudaErrorInvalidValue;
    pyr.level[l] = levels[l];
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_radius<__nv_bfloat16>(r, num_levels, pyr, xs, ys,
                                                 stride, out, n, s)
                  : launch_radius<float>(r, num_levels, pyr, xs, ys, stride,
                                         out, n, s);
}
