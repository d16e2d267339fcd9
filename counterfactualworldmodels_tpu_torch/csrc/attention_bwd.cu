// Fused flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   counterfactualworldmodels_tpu/ops/flash_attention.py:_flash_bwd_kernel
//     (launched by _flash_bwd_bhnd, selected in _flash_vjp_bwd)        -- K6
//
// Contract. From q, dO [BH, Nq, D], k, v [BH, Nk, D] (q pre-scaled, float32
// or bfloat16), the forward's row logsumexps lse [BH, Nq] (natural log of
// the raw scores, as attention.cu's K5 stores them) and
// delta = rowsum(dO * O) [BH, Nq] (both float32), it computes
//   P  = exp(S - lse),  S = q k^T
//   dV = P^T dO,  dS = P * (dO v^T - delta),  dK = dS^T q,  dQ = dS k
// and returns dq, dk, dv in q's type. No score tensor goes to device
// memory. Scores, probabilities and all sums are float32. On bfloat16
// inputs the two rounding points of the TPU kernel are kept: P is rounded
// to dO's type before dV, and dS to q's type before dK and dQ. Ragged Nq
// and Nk are masked by bounds (padded rows get P = 0 and are never stored);
// nothing is padded in memory.
//
// Why two passes. The TPU kernel walks the key blocks of one (batch, head)
// in grid order and accumulates dq across them in its output block. Blocks
// on the H100 run in no order, so that accumulation would need atomics,
// whose order (and so whose float sums) changes from run to run. Here:
//   pass 1: one block per (bh, 64-key tile) walks the query tiles and
//           accumulates dK and dV for its keys in registers;
//   pass 2: one block per (bh, 64-query tile) walks the key tiles and
//           accumulates dQ for its queries in registers.
// Every output element is summed by one thread in a fixed order: two runs
// on the same inputs give bitwise-equal results. The price is rebuilding S
// and dP twice: 14*Nq*Nk*D operations per (sample, head) against the
// 10*Nq*Nk*D the TPU kernel does.
//
// What bounds it on the H100. At the training shapes (ViT-L 4x4 @224,
// N = 3450 encoder tokens or 6272 decoder tokens, D = 64) the work is
// hundreds of operations per byte of compulsory traffic: it is bound by
// arithmetic. Like attention.cu this first version computes on the CUDA
// cores in float32 (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
// bf16); wgmma and TMA are the later work that closes the gap.
//
// Design. 256 threads per block as 16 x 16 groups. Tiles live in shared
// memory as float32, transposed ([d][row]) where they feed the 4x4
// register-blocked score products (two float4 loads per step of d), and
// row-major where they feed the P/dS products (each thread owns 4 rows x
// D/16 columns of the accumulator). The tiles exceed 48 KB at D = 64
// (about 103 KB per block), so the launch raises the dynamic shared memory
// limit; in pass 1 the P and dS tiles reuse the space of the transposed
// query tiles, which keeps D = 128 inside the 227 KB a block may have.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BT = 64;        // rows per tile, queries and keys alike
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LD = BT + 4;    // leading dim of the transposed and P/dS tiles
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// the value v takes in type T, as float (the TPU kernel's astype points)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Rows r0 .. r0+BT-1 of a row-major [n][D] source into shared memory as
// float32: transposed into tdst[c*LD + r] and/or row-major into
// rdst[r*D + c] (either may be null). Rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int n, float* tdst, float* rdst) {
  for (int e = threadIdx.x; e < BT * D; e += NT) {
    const int r = e / D, c = e % D;
    const int g = r0 + r;
    const float x = g < n ? to_f(src[(size_t)g * D + c]) : 0.f;
    if (tdst) tdst[c * LD + r] = x;
    if (rdst) rdst[r * D + c] = x;
  }
}

// acc[i][j] = sum_d a[d][a0+i] * b[d][b0+j] over two transposed tiles.
template <int D>
__device__ __forceinline__ void product_tt(const float* a, int a0,
                                           const float* b, int b0,
                                           float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&a[d * LD + a0]);
    const float4 y = *reinterpret_cast<const float4*>(&b[d * LD + b0]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// CT consecutive floats of a row-major tile row into registers.
template <int CT>
__device__ __forceinline__ void load_cols(const float* p, float out[CT]) {
  if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CT; c += 4) {
      const float4 b = *reinterpret_cast<const float4*>(&p[c]);
      out[c] = b.x; out[c + 1] = b.y; out[c + 2] = b.z; out[c + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) out[c] = p[c];
  }
}

__host__ __device__ constexpr int area_floats(int d) { return 2 * d * LD > 2 * BT * LD ? 2 * d * LD : 2 * BT * LD; }
__host__ __device__ constexpr int dkdv_smem_floats(int d) { return 2 * d * LD + 2 * BT * d + area_floats(d) + 2 * BT; }
__host__ __device__ constexpr int dq_smem_floats(int d) { return 4 * d * LD + BT * d + BT * LD + 2 * BT; }

// Pass 1: dK and dV of one (bh, 64-key tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int nq, int nk) {
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* kt = smem;               // [D][LD]  this block's keys, transposed
  float* vt = kt + D * LD;        // [D][LD]  its values, transposed
  float* qs = vt + D * LD;        // [BT][D]  query tile, row-major
  float* dos = qs + BT * D;       // [BT][D]  dO tile, row-major
  float* area = dos + BT * D;
  float* qt = area;               // [D][LD]  query tile, transposed
  float* dot = area + D * LD;     // [D][LD]  dO tile, transposed
  float* ps = area;               // [BT][LD] P as [query][key] (reuses qt/dot)
  float* dss = area + BT * LD;    // [BT][LD] dS as [query][key]
  float* lsl = area + area_floats(D);  // [BT] lse * log2 e of the query tile
  float* dls = lsl + BT;               // [BT] delta of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // score tile: queries tx*4..; products: columns
  const int ty = tid >> 4;        // keys ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const size_t qoff = (size_t)bh * nq;

  load_tile<T, D>(k + (size_t)bh * nk * D, k0, nk, kt, nullptr);
  load_tile<T, D>(v + (size_t)bh * nk * D, k0, nk, vt, nullptr);

  float acc_k[4][CT], acc_v[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += BT) {
    __syncthreads();  // the previous tile's products are done with the area
    load_tile<T, D>(q + qoff * D, q0, nq, qt, qs);
    load_tile<T, D>(dout + qoff * D, q0, nq, dot, dos);
    if (tid < BT) {
      const bool ok = q0 + tid < nq;
      lsl[tid] = ok ? lse[qoff + q0 + tid] * LOG2E : 0.f;
      dls[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    product_tt<D>(kt, ty * 4, qt, tx * 4, s);    // S^T  [key][query]
    product_tt<D>(vt, ty * 4, dot, tx * 4, dp);  // dP^T [key][query]
    float p[4][4], ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool kok = k0 + ty * 4 + i < nk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        const bool ok = kok && q0 + r < nq;
        const float pf = ok ? exp2f(s[i][j] * LOG2E - lsl[r]) : 0.f;
        p[i][j] = round_to<T>(pf);
        ds[i][j] = round_to<T>(pf * (dp[i][j] - dls[r]));
      }
    }
    __syncthreads();  // every thread is done reading qt/dot
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&ps[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      *reinterpret_cast<float4*>(&dss[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&ps[r * LD + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&dss[r * LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      float dov[CT], qv[CT];
      load_cols<CT>(&dos[r * D + tx * CT], dov);
      load_cols<CT>(&qs[r * D + tx * CT], qv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          acc_v[i][c] = fmaf(av[i], dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(bv[i], qv[c], acc_k[i][c]);
        }
    }
  }

  T* dkb = dk + (size_t)bh * nk * D;
  T* dvb = dv + (size_t)bh * nk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = k0 + ty * 4 + i;
    if (g >= nk) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      dkb[(size_t)g * D + tx * CT + c] = from_f<T>(acc_k[i][c]);
      dvb[(size_t)g * D + tx * CT + c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// Pass 2: dQ of one (bh, 64-query tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int nq, int nk) {
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;               // [D][LD]  this block's queries, transposed
  float* dot = qt + D * LD;       // [D][LD]  their dO rows, transposed
  float* kt = dot + D * LD;       // [D][LD]  key tile, transposed
  float* vt = kt + D * LD;        // [D][LD]  value tile, transposed
  float* ks = vt + D * LD;        // [BT][D]  key tile, row-major
  float* dss = ks + BT * D;       // [BT][LD] dS as [key][query]
  float* lsl = dss + BT * LD;     // [BT]
  float* dls = lsl + BT;          // [BT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // score tile: keys tx*4..; products: columns
  const int ty = tid >> 4;        // queries ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const size_t qoff = (size_t)bh * nq;
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * D;

  load_tile<T, D>(q + qoff * D, q0, nq, qt, nullptr);
  load_tile<T, D>(dout + qoff * D, q0, nq, dot, nullptr);
  if (tid < BT) {
    const bool ok = q0 + tid < nq;
    lsl[tid] = ok ? lse[qoff + q0 + tid] * LOG2E : 0.f;
    dls[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
  }

  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BT) {
    __syncthreads();  // the previous tile's product is done with ks/dss
    load_tile<T, D>(kb, k0, nk, kt, ks);
    load_tile<T, D>(vb, k0, nk, vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
    product_tt<D>(qt, ty * 4, kt, tx * 4, s);    // S  [query][key]
    product_tt<D>(dot, ty * 4, vt, tx * 4, dp);  // dP [query][key]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool kok = k0 + tx * 4 + j < nk;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool ok = kok && q0 + r < nq;
        const float pf = ok ? exp2f(s[i][j] * LOG2E - lsl[r]) : 0.f;
        ds[i] = round_to<T>(pf * (dp[i][j] - dls[r]));
      }
      *reinterpret_cast<float4*>(&dss[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&dss[r * LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float kv[CT];
      load_cols<CT>(&ks[r * D + tx * CT], kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(av[i], kv[c], acc[i][c]);
    }
  }

  T* dqb = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = q0 + ty * 4 + i;
    if (g >= nq) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      dqb[(size_t)g * D + tx * CT + c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int bh, int nq, int nk,
                   cudaStream_t stream) {
  const int smem1 = dkdv_smem_floats(D) * (int)sizeof(float);
  const int smem2 = dq_smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  dkdv_kernel<T, D><<<dim3((nk + BT - 1) / BT, bh), NT, smem1, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      nq, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3((nq + BT - 1) / BT, bh), NT, smem2, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dq), nq, nk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, int bh, int nq, int nk,
                       cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk, s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk, s);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk, s);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv); lse and
// delta are float32 [bh, nq]. All tensors contiguous. Launches pass 1 then
// pass 2 on the stream; returns cudaGetLastError() (0 on success).
extern "C" int cwm_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int bh, int nq, int nk, int d,
                                 int dtype, void* stream) {
  if (nq <= 0 || nk <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, q, k, v, dout, l, dl, dq, dk, dv, bh, nq, nk, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, q, k, v, dout, l, dl, dq, dk, dv, bh, nq, nk, s);
  return (int)cudaErrorInvalidValue;
}
