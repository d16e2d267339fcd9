// Residual add + LayerNorm for Hopper (sm_90a) in one pass:
// h = x + r rounded to the working dtype, y = LayerNorm(h).
//
// Replaces no Pallas kernel. The JAX package writes the shared-prefix
// engine's residual adds and LayerNorms (counterfactualworldmodels_tpu/
// models/fast_vmae.py, models/layers.py:layer_norm) as jnp ops, and XLA
// fuses each add with the norm after it into one loop over the rows.
// PyTorch's eager ops do not fuse: the plain version (x + r, then
// models/layers.py:layer_norm) runs about a dozen elementwise and reduction
// kernels and moves some 37 row-widths of bytes per element row, where
// this pass moves 4. This kernel stands in for XLA's fusion.
//
// Contract. x, r, h, y are [rows, d] row-major in T (float or bf16); scale
// and bias are [d] in P (T, or float). With r: h[i] = T(f32(x[i]) +
// f32(r[i])), the rounded sum that eager's `x + r` gives, and the
// statistics use that rounded value. Without r (r == nullptr) h is not
// written and x is normalised. Then, in f32 as layers.layer_norm computes
// it: mean = sum(h) * (1/d); var = sum((h - mean)^2) * (1/d);
// y = T(((h - mean) * rsqrt(var + eps)) * scale + bias), each product and
// sum rounded on its own (no fused multiply-add), so that only the order
// of the two row sums differs from eager's.
//
// What bounds it on the H100: bytes. It reads x and r and writes h and y,
// 4 * rows * d * sizeof(T) bytes, with about 8 operations per element. At
// the decoder suffix's [802816, 512] bf16 rows that is 3.29 GB: 0.98 ms at
// 3.35 TB/s.
//
// Design. One warp per row, 8 rows per 256-thread block. Each lane loads
// 16 bytes of x (and of r) per access (8 bf16 or 4 f32 values),
// neighbouring lanes on neighbouring addresses, all of a row's accesses
// issued before any is used; the row stays in registers (NV accesses per
// lane, a compile-time bucket: 2 at d = 512 bf16, 4 at d = 1024, 16 at
// d = 4096), so nothing passes through shared memory. The two row sums are
// per-lane partial sums reduced by warp shuffles. h is stored as soon as it
// is formed, y after the statistics, with the same 16-byte accesses. A
// width that is not a multiple of 16 bytes, or a pointer that is not
// 16-byte aligned, takes single-element accesses (lane i takes elements
// i, i + 32, ...): the same arithmetic, still coalesced. Lanes past the
// row's end are masked. At d = 512 each SM holds several blocks of 8 rows
// (1 KB of x and 1 KB of r each), so megabytes of loads are in flight over
// the 132 SMs, more than the memory's latency needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxD = 4096;

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

template <typename S>
struct alignas(16) Word {
  S v[16 / sizeof(S)];
};

// N consecutive values at p, as f32; 16-byte loads where N values fill
// whole 16-byte words (the caller guarantees the alignment then).
template <typename S, int N>
__device__ __forceinline__ void load_f32(const S* p, float (&out)[N]) {
  constexpr int kPer = 16 / sizeof(S);
  if constexpr (N % kPer == 0) {
#pragma unroll
    for (int c = 0; c < N / kPer; ++c) {
      const Word<S> w = reinterpret_cast<const Word<S>*>(p)[c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(w.v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// The same for a store, each value rounded to S.
template <typename S, int N>
__device__ __forceinline__ void store_f32(S* p, const float (&in)[N]) {
  constexpr int kPer = 16 / sizeof(S);
  if constexpr (N % kPer == 0) {
#pragma unroll
    for (int c = 0; c < N / kPer; ++c) {
      Word<S> w;
#pragma unroll
      for (int i = 0; i < kPer; ++i) w.v[i] = from_f32<S>(in[c * kPer + i]);
      reinterpret_cast<Word<S>*>(p)[c] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<S>(in[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC values of T per access (16 bytes, or 1), NV accesses per lane.
template <typename T, typename P, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          const P* __restrict__ scale,
                          const P* __restrict__ bias, T* __restrict__ h,
                          T* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  const T* xr = x + base;
  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * 32 + lane) * VEC;
    if (col < d) {
      load_f32<T, VEC>(xr + col, v[j]);
      if (r != nullptr) {
        float b[VEC];
        load_f32<T, VEC>(r + base + col, b);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          v[j][i] = to_f32(from_f32<T>(__fadd_rn(v[j][i], b[i])));
        store_f32<T, VEC>(h + base + col, v[j]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[j][i];
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const float mean = __fmul_rn(warp_sum(sum), inv_d);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * 32 + lane) * VEC;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[j][i] = __fsub_rn(v[j][i], mean);
        sq = __fadd_rn(sq, __fmul_rn(v[j][i], v[j][i]));
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * 32 + lane) * VEC;
    if (col < d) {
      float s[VEC], b[VEC];
      load_f32<P, VEC>(scale + col, s);
      load_f32<P, VEC>(bias + col, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        v[j][i] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][i], rstd), s[i]), b[i]);
      store_f32<T, VEC>(y + base + col, v[j]);
    }
  }
}

// The least bucket in {1, 2, 4, ..., kMax} that holds n accesses a lane.
template <typename T, typename P, int VEC, int NV, int kMax>
int launch_bucket(int per_lane, const T* x, const T* r, const P* scale,
                  const P* bias, T* h, T* y, int rows, int d, float eps,
                  cudaStream_t stream) {
  if constexpr (NV < kMax) {
    if (per_lane > NV)
      return launch_bucket<T, P, VEC, NV * 2, kMax>(per_lane, x, r, scale,
                                                    bias, h, y, rows, d, eps,
                                                    stream);
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  add_layer_norm_kernel<T, P, VEC, NV>
      <<<blocks, kThreads, 0, stream>>>(x, r, scale, bias, h, y, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename P>
int launch(const void* x, const void* r, const void* scale, const void* bias,
           void* h, void* y, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(y) &&
                   (r == nullptr || (aligned16(r) && aligned16(h))) &&
                   aligned16(scale) && aligned16(bias);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const P* st = static_cast<const P*>(scale);
  const P* bt = static_cast<const P*>(bias);
  T* ht = static_cast<T*>(h);
  T* yt = static_cast<T*>(y);
  if (vec) {
    const int per_lane = (d / kVec + 31) / 32;
    return launch_bucket<T, P, kVec, 1, kMaxD / (32 * kVec)>(
        per_lane, xt, rt, st, bt, ht, yt, rows, d, eps, stream);
  }
  const int per_lane = (d + 31) / 32;
  return launch_bucket<T, P, 1, 4, kMaxD / 32>(per_lane, xt, rt, st, bt, ht,
                                               yt, rows, d, eps, stream);
}

}  // namespace

// dtype: 0 float, 1 bf16 (x, r, h, y); param_bf16: scale and bias in bf16
// (only with dtype 1), else float. r == nullptr: no residual, h unused.
// Returns a CUDA error code (0 on success).
extern "C" int cwm_add_layer_norm(const void* x, const void* r,
                                  const void* scale, const void* bias,
                                  void* h, void* y, int rows, int d,
                                  float eps, int dtype, int param_bf16,
                                  void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || dtype < 0 || dtype > 1 ||
      (param_bf16 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(x, r, scale, bias, h, y, rows, d, eps, s);
  return param_bf16
             ? launch<__nv_bfloat16, __nv_bfloat16>(x, r, scale, bias, h, y,
                                                    rows, d, eps, s)
             : launch<__nv_bfloat16, float>(x, r, scale, bias, h, y, rows, d,
                                            eps, s);
}
