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
// inputs the two rounding points of the TPU kernel are kept
// (flash_attention.py:434, 439): P is rounded to dO's type before dV, and
// dS to q's type before dK and dQ. Ragged Nq and Nk are masked by bounds
// (padded rows get P = 0 and are never stored); nothing is padded in
// memory.
//
// Why two passes. The TPU kernel walks the key blocks of one (batch, head)
// in grid order and accumulates dq across them in its output block. Blocks
// on the H100 run in no order, so that accumulation would need atomics,
// whose order (and so whose float sums) changes from run to run. Here:
//   pass 1: one block per (bh, key tile) walks the query tiles and
//           accumulates dK and dV for its keys in registers;
//   pass 2: one block per (bh, query tile) walks the key tiles and
//           accumulates dQ for its queries in registers.
// Every output element is summed by one thread in a fixed order: two runs
// on the same inputs give bitwise-equal results. The price is rebuilding S
// and dP twice: 14*Nq*Nk*D operations per (sample, head) against the
// 10*Nq*Nk*D the TPU kernel does.
//
// What bounds it on the H100. At the training shapes (ViT-L 4x4 @224,
// N = 3450 encoder tokens or 6272 decoder tokens, D = 64) the work is
// hundreds of operations per byte of compulsory traffic: it is bound by
// arithmetic, on bf16 by the tensor cores (989 TFLOP/s).
//
// Two routes, chosen by dtype inside cwm_attention_bwd:
//
// bfloat16 -- dkdv_sm90 and dq_sm90, on the tensor cores (wgmma). A block
// is two warpgroups, each owning 64 rows (keys in pass 1, queries in pass
// 2), so 128 rows per block; the other operand streams through a
// two-stage cp.async ring of swizzled shared-memory tiles (sm90_mma.cuh).
//   pass 1, per query tile (64 queries; 32 at D = 128, for registers):
//     S^T = K.Q^T and dP^T = V.dO^T, both operands in shared memory;
//     P^T = exp2(S^T log2 e - lse log2 e) and dS^T = P^T (dP^T - delta)
//     on the accumulator fragments, rounded to bf16 in registers;
//     dV += P^T.dO and dK += dS^T.Q with P^T, dS^T as register A operands
//     and dO, Q read MN-major from the same tiles. lse and delta of the
//     query tile ride in the ring beside it.
//   pass 2, per key tile (64 keys): S = Q.K^T and dP = dO.V^T; dS in
//     registers; dQ += dS.K with K read MN-major.
//
// float32 -- dkdv_kernel and dq_kernel, on the CUDA cores (full f32, no
// TF32). 256 threads per block as 16 x 16 groups. Tiles live in shared
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

#include "sm90_mma.cuh"

namespace {

constexpr int BT = 64;        // rows per tile, queries and keys alike
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LD = BT + 4;    // leading dim of the transposed and P/dS tiles
constexpr float LOG2E = 1.4426950408889634f;

// Rows r0 .. r0+BT-1 of a row-major [n][D] source into shared memory as
// float32: transposed into tdst[c*LD + r] and/or row-major into
// rdst[r*D + c] (either may be null). Rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int r0,
                                          int n, float* tdst, float* rdst) {
  for (int e = threadIdx.x; e < BT * D; e += NT) {
    const int r = e / D, c = e % D;
    const int g = r0 + r;
    const float x = g < n ? src[(size_t)g * D + c] : 0.f;
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
template <int D>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int nq, int nk) {
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

  load_tile<D>(k + (size_t)bh * nk * D, k0, nk, kt, nullptr);
  load_tile<D>(v + (size_t)bh * nk * D, k0, nk, vt, nullptr);

  float acc_k[4][CT], acc_v[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += BT) {
    __syncthreads();  // the previous tile's products are done with the area
    load_tile<D>(q + qoff * D, q0, nq, qt, qs);
    load_tile<D>(dout + qoff * D, q0, nq, dot, dos);
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
        p[i][j] = pf;
        ds[i][j] = pf * (dp[i][j] - dls[r]);
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

  float* dkb = dk + (size_t)bh * nk * D;
  float* dvb = dv + (size_t)bh * nk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = k0 + ty * 4 + i;
    if (g >= nk) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      dkb[(size_t)g * D + tx * CT + c] = acc_k[i][c];
      dvb[(size_t)g * D + tx * CT + c] = acc_v[i][c];
    }
  }
}

// Pass 2: dQ of one (bh, 64-query tile).
template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int nq, int nk) {
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
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;

  load_tile<D>(q + qoff * D, q0, nq, qt, nullptr);
  load_tile<D>(dout + qoff * D, q0, nq, dot, nullptr);
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
    load_tile<D>(kb, k0, nk, kt, ks);
    load_tile<D>(vb, k0, nk, vt, nullptr);
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
        ds[i] = pf * (dp[i][j] - dls[r]);
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

  float* dqb = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = q0 + ty * 4 + i;
    if (g >= nq) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      dqb[(size_t)g * D + tx * CT + c] = acc[i][c];
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int bh, int nq, int nk,
                   cudaStream_t stream) {
  const int smem1 = dkdv_smem_floats(D) * (int)sizeof(float);
  const int smem2 = dq_smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* dd = static_cast<const float*>(dout);
  dkdv_kernel<D><<<dim3((nk + BT - 1) / BT, bh), NT, smem1, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), nq, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3((nq + BT - 1) / BT, bh), NT, smem2, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<float*>(dq), nq, nk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using sm90::bf16;
using sm90::Tile;

// A block's warpgroups own 64 rows each: keys in pass 1, queries in pass 2.
constexpr int DKDV_GROUPS = 2;
constexpr int DQ_GROUPS = 2;
constexpr int WG_STAGES = 2;    // ring depth
constexpr int WG_BK = 64;       // key tile of pass 2
template <int D> __host__ __device__ constexpr int wg_bq() { return D == 128 ? 32 : 64; }  // pass 1

// pass 1 ring stage: the Q and dO tiles, then lse and delta (BQ floats each)
template <int D> __host__ __device__ constexpr int dkdv_stage() {
  return sm90::align1k(2 * Tile<D>::bytes(wg_bq<D>()) + 8 * wg_bq<D>());
}
template <int D> __host__ __device__ constexpr int dkdv_smem_sm90() {
  return 1024 + 2 * Tile<D>::bytes(64 * DKDV_GROUPS) +
         WG_STAGES * dkdv_stage<D>();
}
template <int D> __host__ __device__ constexpr int dq_smem_sm90() {
  return 1024 + 2 * Tile<D>::bytes(64 * DQ_GROUPS) +
         WG_STAGES * 2 * Tile<D>::bytes(WG_BK);
}

// the thread's accumulator rows h = 0, 1 (acc_row(0) and 8 below) as bf16
// pairs at row g of a [*, D] output
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 2],
                                           int h, size_t g) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    *reinterpret_cast<__nv_bfloat162*>(dst + g * D + sm90::acc_col(4 * i)) =
        __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

// Pass 1: dK and dV of one (bh, key tile of 64 * DKDV_GROUPS).
template <int D>
__global__ void __launch_bounds__(128 * DKDV_GROUPS, 1)
dkdv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk) {
  using namespace sm90;
  constexpr int KR = 64 * DKDV_GROUPS;    // keys per block
  constexpr int THREADS = 128 * DKDV_GROUPS;
  constexpr int BQ = wg_bq<D>();
  constexpr int RB = Tile<D>::bytes(KR);
  constexpr int TB = Tile<D>::bytes(BQ);
  constexpr int SB = dkdv_stage<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + RB;
  auto sq = [&](int s) { return sv + RB + s * SB; };
  auto sdo = [&](int s) { return sv + RB + s * SB + TB; };
  // lse then delta of stage s, as a generic pointer for plain loads
  auto stats = [&](int s) {
    return reinterpret_cast<const float*>(smem_raw + (sdo(s) + TB - raw));
  };

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * KR;
  const size_t qoff = (size_t)bh * nq;
  const bf16* qb = q + qoff * D;
  const bf16* dob = dout + qoff * D;
  const int tiles = (nq + BQ - 1) / BQ;

  sm90::load_tile<D, KR, THREADS>(sk, k + (size_t)bh * nk * D, k0, nk);
  sm90::load_tile<D, KR, THREADS>(sv, v + (size_t)bh * nk * D, k0, nk);
  auto load_q = [&](int t) {
    if (t < tiles) {
      const int s = t % WG_STAGES;
      const int r0 = t * BQ;
      sm90::load_tile<D, BQ, THREADS>(sq(s), qb, r0, nq);
      sm90::load_tile<D, BQ, THREADS>(sdo(s), dob, r0, nq);
      const int i = threadIdx.x;
      if (i < 2 * BQ) {
        const int c = i % BQ;
        const bool ok = r0 + c < nq;
        cp_async4(sdo(s) + TB + 4 * i,
                  (i < BQ ? lse : delta) + qoff + (ok ? r0 + c : 0), ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < WG_STAGES - 1; ++t) load_q(t);  // K, V ride in group 0

  float dka[D / 2], dva[D / 2], s[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BQ / 2; ++j) s[j] = dp[j] = 0.f;
  const bool key_ok[2] = {k0 + wg * 64 + acc_row(0) < nk,
                          k0 + wg * 64 + acc_row(2) < nk};

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<WG_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    load_q(t + WG_STAGES - 1);
    const int st = t % WG_STAGES;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BQ>(s, desc_k<D, KR>(sk, wg * 64, kk),
                 desc_k<D, BQ>(sq(st), 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BQ>(dp, desc_k<D, KR>(sv, wg * 64, kk),
                 desc_k<D, BQ>(sdo(st), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    keep(dp);

    const float* ls = stats(st);
    const float* dl = ls + BQ;
    const int q0 = t * BQ;
    // masks only where the tile crosses Nq or the block crosses Nk
    const bool edge = !(key_ok[0] && key_ok[1]) || q0 + BQ > nq;
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {  // rows: keys, columns: queries
      const int c = acc_col(j);
      const bool ok = !edge || (key_ok[(j >> 1) & 1] && q0 + c < nq);
      const float p = ok ? exp2_ftz(s[j] * LOG2E - ls[c] * LOG2E) : 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - dl[c]);
    }
    to_a<BQ>(s, pa);   // P^T rounded to dO's type
    to_a<BQ>(dp, da);  // dS^T rounded to q's type

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<D>(dva, pa[kk], desc_mn<D, BQ>(sdo(st), kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<D>(dka, da[kk], desc_mn<D, BQ>(sq(st), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(dka);
    keep(dva);
    keep(pa);
    keep(da);
  }

  bf16* dkb = dk + (size_t)bh * nk * D;
  bf16* dvb = dv + (size_t)bh * nk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = k0 + wg * 64 + acc_row(2 * h);
    if (g >= nk) continue;
    store_rows<D>(dkb, dka, h, g);
    store_rows<D>(dvb, dva, h, g);
  }
}

// Pass 2: dQ of one (bh, query tile of 64 * DQ_GROUPS).
template <int D>
__global__ void __launch_bounds__(128 * DQ_GROUPS, 1)
dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dq, int nq, int nk) {
  using namespace sm90;
  constexpr int QR = 64 * DQ_GROUPS;      // queries per block
  constexpr int THREADS = 128 * DQ_GROUPS;
  constexpr int RB = Tile<D>::bytes(QR);
  constexpr int KB = Tile<D>::bytes(WG_BK);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + RB;
  auto sk = [&](int s) { return sdo + RB + s * 2 * KB; };
  auto sv = [&](int s) { return sdo + RB + s * 2 * KB + KB; };

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * QR;
  const size_t qoff = (size_t)bh * nq;
  const bf16* kb = k + (size_t)bh * nk * D;
  const bf16* vb = v + (size_t)bh * nk * D;
  const int tiles = (nk + WG_BK - 1) / WG_BK;

  sm90::load_tile<D, QR, THREADS>(sq, q + qoff * D, q0, nq);
  sm90::load_tile<D, QR, THREADS>(sdo, dout + qoff * D, q0, nq);
  auto load_kv = [&](int t) {
    if (t < tiles) {
      sm90::load_tile<D, WG_BK, THREADS>(sk(t % WG_STAGES), kb, t * WG_BK, nk);
      sm90::load_tile<D, WG_BK, THREADS>(sv(t % WG_STAGES), vb, t * WG_BK, nk);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < WG_STAGES - 1; ++t) load_kv(t);  // Q, dO ride in group 0

  int gq[2];
  bool q_ok[2];
  float lsl[2], dls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gq[h] = q0 + wg * 64 + acc_row(2 * h);
    q_ok[h] = gq[h] < nq;
    lsl[h] = q_ok[h] ? lse[qoff + gq[h]] * LOG2E : 0.f;
    dls[h] = q_ok[h] ? delta[qoff + gq[h]] : 0.f;
  }

  float dqa[D / 2], s[WG_BK / 2], dp[WG_BK / 2];
  uint32_t da[WG_BK / 16][4];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dqa[j] = 0.f;
#pragma unroll
  for (int j = 0; j < WG_BK / 2; ++j) s[j] = dp[j] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<WG_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    load_kv(t + WG_STAGES - 1);
    const int st = t % WG_STAGES;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<WG_BK>(s, desc_k<D, QR>(sq, wg * 64, kk),
                    desc_k<D, WG_BK>(sk(st), 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<WG_BK>(dp, desc_k<D, QR>(sdo, wg * 64, kk),
                    desc_k<D, WG_BK>(sv(st), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    keep(dp);

    const int k0 = t * WG_BK;
    // masks only where the tile crosses Nk or the block crosses Nq
    const bool edge = !(q_ok[0] && q_ok[1]) || k0 + WG_BK > nk;
#pragma unroll
    for (int j = 0; j < WG_BK / 2; ++j) {  // rows: queries, columns: keys
      const int h = (j >> 1) & 1;
      const bool ok = !edge || (q_ok[h] && k0 + acc_col(j) < nk);
      const float p = ok ? exp2_ftz(s[j] * LOG2E - lsl[h]) : 0.f;
      dp[j] = p * (dp[j] - dls[h]);
    }
    to_a<WG_BK>(dp, da);  // dS rounded to q's type

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      mma_rs<D>(dqa, da[kk], desc_mn<D, WG_BK>(sk(st), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(dqa);
    keep(da);
  }

  bf16* dqb = dq + qoff * D;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (q_ok[h]) store_rows<D>(dqb, dqa, h, gq[h]);
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, void* dk, void* dv, int bh, int nq, int nk,
                        cudaStream_t stream) {
  const int smem1 = dkdv_smem_sm90<D>();
  const int smem2 = dq_smem_sm90<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* dd = static_cast<const bf16*>(dout);
  constexpr int KR = 64 * DKDV_GROUPS, QR = 64 * DQ_GROUPS;
  dkdv_sm90<D><<<dim3((nk + KR - 1) / KR, bh), 128 * DKDV_GROUPS, smem1,
                 stream>>>(qq, kk, vv, dd, lse, delta, static_cast<bf16*>(dk),
                           static_cast<bf16*>(dv), nq, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_sm90<D><<<dim3((nq + QR - 1) / QR, bh), 128 * DQ_GROUPS, smem2,
               stream>>>(qq, kk, vv, dd, lse, delta, static_cast<bf16*>(dq),
                         nq, nk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (dkdv_kernel, dq_kernel: CUDA cores), 1 = bfloat16
// (dkdv_sm90, dq_sm90: tensor cores) for q, k, v, dout, dq, dk, dv; lse and
// delta are float32 [bh, nq]. All tensors contiguous. Launches pass 1 then
// pass 2 on the stream; returns cudaGetLastError() (0 on success).
extern "C" int cwm_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int bh, int nq, int nk, int d,
                                 int dtype, void* stream) {
  if (nq <= 0 || nk <= 0 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return (int)sm90::with_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return dtype == 0 ? launch<D>(q, k, v, dout, l, dl, dq, dk, dv, bh, nq, nk, s)
                      : launch_sm90<D>(q, k, v, dout, l, dl, dq, dk, dv, bh,
                                       nq, nk, s);
  });
}
