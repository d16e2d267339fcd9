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
// operations per byte: it is bound by arithmetic, and on bf16 by the
// tensor cores (989 TFLOP/s) and, at d = 64, nearly as much by the exp2
// unit (one exp2 per score against 4*d tensor-core operations).
//
// Two routes, chosen by dtype inside cwm_attention:
//
// bfloat16 -- attention_fwd_sm90, on the tensor cores (wgmma). A block of
// two warpgroups owns 128 query rows (64 each); Q stays in shared memory
// and K/V tiles of 128 keys (64 at D = 128) stream through a two-stage
// ring filled by cp.async, so the copy of tile t+1 overlaps the products
// of tile t. Tiles are stored swizzled for wgmma (sm90_mma.cuh). Per tile
// and warpgroup: S = Q.K^T is one wgmma chain with both operands in shared
// memory; the online softmax runs on the accumulator fragment in
// registers, each row's max and sum reduced over the 4 threads of a quad;
// P is rounded to bf16 in registers (the TPU kernel's cast point,
// flash_attention.py:273) and is the register A operand of O += P.V, with
// V read MN-major from the same tile. The panel multiplicity is applied
// once per panel switch: acc and l are kept in units of the current
// panel's weight, scaled by w0/w1 when panel 1 begins and by w_last in the
// stored lse (the output acc/l is free of it); pool weights are powers of
// two, so that adds no rounding.
//
// float32 -- attention_kernel, on the CUDA cores (full f32, no TF32). One
// block of 256 threads per (sample*head, 64-query tile). Keys stream
// through shared memory in tiles of 64 with an online softmax in the exp2
// domain: the [Nq, Nk] score matrix never reaches device memory. Q and K
// tiles are stored transposed ([d][row]) so each thread reads its 4x4
// score micro-tile operands as two float4 loads per step of d (the
// register-blocked SGEMM pattern); the probability tile goes back to
// shared memory transposed for the P.V product, where each thread owns 4
// query rows x d/16 output columns. Row statistics (m, l) live with the 16
// threads of a row group and are combined with warp shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "sm90_mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16
constexpr int LD = BQ + 4;    // leading dim of the transposed tiles (BQ == BK)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int smem_floats(int d) { return 2 * d * LD + BK * d + BK * LD; }

template <int D>
__global__ void __launch_bounds__(NT)
attention_kernel(const float* __restrict__ q,
                 const float* __restrict__ k0, const float* __restrict__ v0,
                 int n0, int shared0, float w0,
                 const float* __restrict__ k1, const float* __restrict__ v1,
                 int n1, float w1,
                 float* __restrict__ out, float* __restrict__ lse, int nq,
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

  const float* qb = q + (size_t)bh * nq * D;
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    const int gq = q_start + r;
    qt[c * LD + r] = gq < nq ? qb[(size_t)gq * D + c] : 0.f;
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
    const float* kb = (panel == 0 ? k0 : k1) + kv_row * n * D;
    const float* vb = (panel == 0 ? v0 : v1) + kv_row * n * D;
    const float w = panel == 0 ? w0 : w1;

    for (int k_start = 0; k_start < n; k_start += BK) {
      __syncthreads();  // previous tile (and the q tile writes) complete
      for (int e = tid; e < BK * D; e += NT) {
        const int r = e / D, c = e % D;
        const int gk = k_start + r;
        const bool ok = gk < n;
        kt[c * LD + r] = ok ? kb[(size_t)gk * D + c] : 0.f;
        vs[r * D + c] = ok ? vb[(size_t)gk * D + c] : 0.f;
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

  float* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q_start + ty * 4 + i;
    if (gq >= nq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CT; ++c)
      ob[(size_t)gq * D + tx * CT + c] = o[i][c] * inv;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * nq + gq] = m[i] * LN2 + logf(l[i]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k0, const void* v0, int n0,
                   int shared0, float w0, const void* k1, const void* v1,
                   int n1, float w1, void* out, float* lse, int bh,
                   int heads, int nq, cudaStream_t stream) {
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  attention_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k0),
      static_cast<const float*>(v0), n0, shared0, w0,
      static_cast<const float*>(k1), static_cast<const float*>(v1), n1, w1,
      static_cast<float*>(out), lse, nq, heads);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using sm90::bf16;
using sm90::Tile;

constexpr int WG_GROUPS = 2;              // warpgroups per block
constexpr int WG_BQ = 64 * WG_GROUPS;     // query rows per block
constexpr int WG_NT = 128 * WG_GROUPS;
constexpr int WG_STAGES = 2;              // K/V ring depth

template <int D> __host__ __device__ constexpr int wg_bk() { return D == 128 ? 64 : 128; }
template <int D> __host__ __device__ constexpr int wg_smem() {
  return 1024 + Tile<D>::bytes(WG_BQ) +
         WG_STAGES * 2 * Tile<D>::bytes(wg_bk<D>());
}

template <int D>
__global__ void __launch_bounds__(WG_NT, 1)
attention_fwd_sm90(const bf16* __restrict__ q,
                   const bf16* __restrict__ k0, const bf16* __restrict__ v0,
                   int n0, int shared0, float w0,
                   const bf16* __restrict__ k1, const bf16* __restrict__ v1,
                   int n1, float w1, bf16* __restrict__ out,
                   float* __restrict__ lse, int nq, int heads) {
  using namespace sm90;
  constexpr int BK = wg_bk<D>();
  constexpr int QB = Tile<D>::bytes(WG_BQ);
  constexpr int KB = Tile<D>::bytes(BK);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  auto sk = [&](int s) { return sq + QB + s * 2 * KB; };
  auto sv = [&](int s) { return sq + QB + s * 2 * KB + KB; };

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * WG_BQ;
  const size_t row0 = shared0 ? (size_t)(bh % heads) : (size_t)bh;
  const bf16* kb0 = k0 + row0 * n0 * D;
  const bf16* vb0 = v0 + row0 * n0 * D;
  const bf16* kb1 = k1 + (size_t)bh * n1 * D;
  const bf16* vb1 = v1 + (size_t)bh * n1 * D;
  const int t0 = (n0 + BK - 1) / BK;         // tiles of panel 0
  const int tiles = t0 + (n1 + BK - 1) / BK;

  auto load_kv = [&](int t) {
    if (t < tiles) {
      const bool p1 = t >= t0;
      const int r0 = (p1 ? t - t0 : t) * BK;
      const int n = p1 ? n1 : n0;
      sm90::load_tile<D, BK, WG_NT>(sk(t % WG_STAGES), p1 ? kb1 : kb0, r0, n);
      sm90::load_tile<D, BK, WG_NT>(sv(t % WG_STAGES), p1 ? vb1 : vb0, r0, n);
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  sm90::load_tile<D, WG_BQ, WG_NT>(sq, q + (size_t)bh * nq * D, q_start, nq);
#pragma unroll
  for (int t = 0; t < WG_STAGES - 1; ++t) load_kv(t);  // Q rides in group 0

  float o[D / 2], s[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
  // the thread's two rows: h = 0 is row acc_row(0), h = 1 is 8 rows below
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<WG_STAGES - 2>();  // tile t (and Q) landed
    fence_async_smem();
    __syncthreads();                  // ... for every thread; tile t-1 is free
    load_kv(t + WG_STAGES - 1);
    const int st = t % WG_STAGES;
    const bool p1 = t >= t0;
    if (t == t0) {  // panel 1 begins: acc and l into its weight's units
      const float c = w0 / w1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= c;
      l[0] *= c;
      l[1] *= c;
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BK>(s, desc_k<D, WG_BQ>(sq, wg * 64, kk),
                 desc_k<D, BK>(sk(st), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);

    const int n = p1 ? n1 : n0;
    const int r0 = (p1 ? t - t0 : t) * BK;
    const bool edge = r0 + BK > n;   // only a panel's last tile has padding
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        if (r0 + acc_col(j) >= n) s[j] = -INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;  // of the raw scores; m is in the exp2 domain
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        mt = fmaxf(mt, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt * LOG2E);
      // an all-masked history keeps m = -inf; exp2(-inf - 0) = 0 then
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_ftz(m[h] - base);
      float ls = 0.f;  // this thread's share; the quad is summed at the end
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_ftz(fmaf(s[4 * i + 2 * h + e], LOG2E, -base));
          s[4 * i + 2 * h + e] = p;
          ls += p;
        }
      l[h] = l[h] * alpha + ls;
      m[h] = m_new;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i + 2 * h] *= alpha;
        o[4 * i + 2 * h + 1] *= alpha;
      }
    }
    to_a<BK>(s, pa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<D>(o, pa[kk], desc_mn<D, BK>(sv(st), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
    keep(pa);
  }

  const float w_last = tiles > t0 ? w1 : w0;
  bf16* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int gq = q_start + wg * 64 + acc_row(2 * h);
    if (gq >= nq) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)gq * D + acc_col(4 * i)) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] * inv,
                                o[4 * i + 2 * h + 1] * inv);
    if (lse != nullptr && (threadIdx.x & 3) == 0)
      lse[(size_t)bh * nq + gq] = m[h] * LN2 + logf(l[h] * w_last);
  }
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k0, const void* v0, int n0,
                        int shared0, float w0, const void* k1, const void* v1,
                        int n1, float w1, void* out, float* lse, int bh,
                        int heads, int nq, cudaStream_t stream) {
  const int smem = wg_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + WG_BQ - 1) / WG_BQ, bh);
  attention_fwd_sm90<D><<<grid, WG_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k0),
      static_cast<const bf16*>(v0), n0, shared0, w0,
      static_cast<const bf16*>(k1), static_cast<const bf16*>(v1), n1, w1,
      static_cast<bf16*>(out), lse, nq, heads);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (attention_kernel, CUDA cores), 1 = bfloat16
// (attention_fwd_sm90, tensor cores). Panel 1 is absent when n1 == 0 (K1).
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)sm90::with_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return dtype == 0 ? launch<D>(q, k0, v0, n0, shared0, w0, k1, v1, n1, w1,
                                  out, lse, bh, heads, nq, s)
                      : launch_sm90<D>(q, k0, v0, n0, shared0, w0, k1, v1,
                                       n1, w1, out, lse, bh, heads, nq, s);
  });
}
