// Flash attention forward for Hopper (sm_90a): single-source and two-source.
//
// Replaces the TPU kernels
//   counterfactualworldmodels_tpu/ops/flash_attention.py:_flash_kernel
//     (launched by _flash_bhnd; public entry flash_attention)       -- K1
//   counterfactualworldmodels_tpu/ops/flash_attention.py:_flash2_kernel
//     (launched by flash_attention_prefix)                           -- K2
//   counterfactualworldmodels_tpu/ops/flash_attention.py:_flash_kernel_lse
//     (launched by _flash_bhnd_lse; the training forward)            -- K5
//
// Contract. q [BH, Nq, D] is pre-scaled (softmax scale 1). Keys and values
// come in one or two panels that share ONE softmax: panel 0 (k0/v0, N0
// keys) and, for K2, panel 1 (k1/v1, N1 keys). Panel 0 is either per
// (sample, head) or, with shared0, one panel per head that every sample
// reads in place (batch stride 0) -- the shared-prefix cache is never
// broadcast S-fold in memory. Each panel carries a key multiplicity w
// that scales its contributions to the running sum l and accumulator acc,
// exactly as _panel_partials does (equal to a +ln w logit bias). Inputs
// are float32 or bfloat16; scores, softmax statistics and the accumulator
// are float32; the output has q's type. Ragged Nq / Nk are masked by
// bounds: padded keys score -inf, padded query rows are never stored.
// K5 is K1 with an lse pointer: it also stores each row's logsumexp
// m + ln l in natural-log units of the raw scores ([BH, Nq] float32), the
// residual the backward (attention_bwd.cu) rebuilds the probabilities from.
// The online softmax runs in the exp2 domain (m there is max(s) * log2 e),
// so the stored value is m * ln 2 + ln l. The lse write adds Nq floats per
// (sample, head): noise next to the 4*Nq*Nk*d operations.
//
// What bounds it on the H100. At the main-path shapes (ViT-L 4x4 @224,
// N = 3136, d = 64) attention does 4*N*Nk*d operations per (sample, head)
// against 2*(N+Nk)*d*itemsize bytes of compulsory traffic, hundreds of
// operations per byte: it is bound by arithmetic. This first version
// computes on the CUDA cores in float32 (67 TFLOP/s peak) rather than on
// the tensor cores (989 TFLOP/s bf16), so it sits far from the bound;
// wgmma, TMA and warp specialisation are the later work that closes it.
//
// Design. One block of 256 threads per (sample*head, 64-query tile).
// Keys stream through shared memory in tiles of 64 with an online softmax
// in the exp2 domain: the [Nq, Nk] score matrix never reaches device
// memory. Q and K tiles are stored transposed ([d][row]) so each thread
// reads its 4x4 score micro-tile operands as two float4 loads per step of
// d (the register-blocked SGEMM pattern); the probability tile goes back
// to shared memory transposed for the P.V product, where each thread owns
// 4 query rows x d/16 output columns. Row statistics (m, l) live with the
// 16 threads of a row group and are combined with warp shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16
constexpr int LD = BQ + 4;    // leading dim of the transposed tiles (BQ == BK)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int smem_floats(int d) { return 2 * d * LD + BK * d + BK * LD; }

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attention_kernel(const T* __restrict__ q,
                 const T* __restrict__ k0, const T* __restrict__ v0,
                 int n0, int shared0, float w0,
                 const T* __restrict__ k1, const T* __restrict__ v1,
                 int n1, float w1,
                 T* __restrict__ out, float* __restrict__ lse, int nq,
                 int heads) {
  constexpr int CT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;             // [D][LD]  q tile, transposed
  float* kt = qt + D * LD;      // [D][LD]  k tile, transposed
  float* vs = kt + D * LD;      // [BK][D]  v tile
  float* pt = vs + BK * D;      // [BK][LD] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // key / column group
  const int ty = tid >> 4;      // query row group: rows ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * BQ;

  const T* qb = q + (size_t)bh * nq * D;
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    const int gq = q_start + r;
    qt[c * LD + r] = gq < nq ? to_f(qb[(size_t)gq * D + c]) : 0.f;
  }

  float m[4], l[4], o[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) o[i][c] = 0.f;
  }

  for (int panel = 0; panel < 2; ++panel) {
    const int n = panel == 0 ? n0 : n1;
    if (n == 0) continue;
    const size_t kv_row = panel == 0 ? (size_t)(shared0 ? bh % heads : bh) : (size_t)bh;
    const T* kb = (panel == 0 ? k0 : k1) + kv_row * n * D;
    const T* vb = (panel == 0 ? v0 : v1) + kv_row * n * D;
    const float w = panel == 0 ? w0 : w1;

    for (int k_start = 0; k_start < n; k_start += BK) {
      __syncthreads();  // previous tile (and the q tile writes) complete
      for (int e = tid; e < BK * D; e += NT) {
        const int r = e / D, c = e % D;
        const int gk = k_start + r;
        const bool ok = gk < n;
        kt[c * LD + r] = ok ? to_f(kb[(size_t)gk * D + c]) : 0.f;
        vs[r * D + c] = ok ? to_f(vb[(size_t)gk * D + c]) : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&qt[d * LD + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&kt[d * LD + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = (k_start + tx * 4 + j < n) ? s[i][j] * LOG2E : -INFINITY;
          mt = fmaxf(mt, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[i], mt);
        // an all-masked history keeps m = -inf; exp2(-inf - 0) = 0 then
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[i] - base);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = exp2f(s[i][j] - base) * w;
          ls += s[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          ls += __shfl_xor_sync(0xffffffffu, ls, off);
        l[i] = l[i] * alpha + ls;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < CT; ++c) o[i][c] *= alpha;
      }

#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * LD + ty * 4]) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&pt[kk * LD + ty * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float vv[CT];
        if constexpr (CT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CT; c += 4) {
            const float4 b = *reinterpret_cast<const float4*>(&vs[kk * D + tx * CT + c]);
            vv[c] = b.x; vv[c + 1] = b.y; vv[c + 2] = b.z; vv[c + 3] = b.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CT; ++c) vv[c] = vs[kk * D + tx * CT + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CT; ++c) o[i][c] = fmaf(av[i], vv[c], o[i][c]);
      }
    }
  }

  T* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q_start + ty * 4 + i;
    if (gq >= nq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CT; ++c)
      ob[(size_t)gq * D + tx * CT + c] = from_f<T>(o[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * nq + gq] = m[i] * LN2 + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k0, const void* v0, int n0,
                   int shared0, float w0, const void* k1, const void* v1,
                   int n1, float w1, void* out, float* lse, int bh,
                   int heads, int nq, cudaStream_t stream) {
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k0),
      static_cast<const T*>(v0), n0, shared0, w0, static_cast<const T*>(k1),
      static_cast<const T*>(v1), n1, w1, static_cast<T*>(out), lse, nq, heads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k0, const void* v0,
                       int n0, int shared0, float w0, const void* k1,
                       const void* v1, int n1, float w1, void* out,
                       float* lse, int bh, int heads, int nq, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out, lse, bh, heads, nq, s);
    case 32: return launch<T, 32>(q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out, lse, bh, heads, nq, s);
    case 64: return launch<T, 64>(q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out, lse, bh, heads, nq, s);
    case 128: return launch<T, 128>(q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out, lse, bh, heads, nq, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Panel 1 is absent when n1 == 0 (K1).
// lse: null, or [bh, nq] float32 for the row logsumexps (K5).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cwm_attention(const void* q, const void* k0, const void* v0,
                             int n0, int shared0, float w0, const void* k1,
                             const void* v1, int n1, float w1, void* out,
                             void* lse_, int bh, int heads, int nq, int d,
                             int dtype, void* stream) {
  float* lse = static_cast<float*>(lse_);
  if (nq <= 0 || n0 <= 0 || n1 < 0 || bh <= 0 || bh > 65535 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out, lse, bh, heads, nq, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out, lse, bh, heads, nq, s);
  return (int)cudaErrorInvalidValue;
}
