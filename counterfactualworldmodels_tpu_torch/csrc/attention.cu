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
// K2 may take an own-key length per sample (own_len): the sample's own keys
// at or past it are pad keys (the bucketed encoder suffix's, whose pads
// trail) and score -inf, and own tiles wholly past it are skipped; a length
// 0 attends the prefix alone. With a shared prefix and Nq <= 64 the bf16
// route packs floor(128 / Nq) samples' queries into one block (PACK): at
// the encoder suffix's Nq = 40, 120 of 128 rows are live instead of 40.
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
// operations per byte: it is bound by arithmetic. On bf16 that is the
// tensor cores (989 TFLOP/s) and, at d = 64, nearly as much the exp2 unit
// (one exp2 per score against 4*d tensor-core operations). On float32 it
// is the tensor cores in tf32 with three products per product (split
// tf32, sm90_mma.cuh): 495 / 3 = 165 TFLOP/s of f32-accurate work, against
// 67 TFLOP/s for f32 on the CUDA cores.
//
// Two routes, chosen by dtype inside cwm_attention. Both run the same
// online softmax on the score accumulator in registers: each row's max and
// sum reduced over the 4 threads of a quad; an all-masked history keeps
// m = -inf; the panel multiplicity applied once per panel switch (acc and
// l are kept in units of the current panel's weight, scaled by w0/w1 when
// panel 1 begins and by w_last in the stored lse; the output acc/l is free
// of it; pool weights are powers of two, so that adds no rounding).
//
// bfloat16 -- attention_fwd_sm90, on the tensor cores (wgmma). A block of
// two warpgroups owns 128 query rows (64 each); Q stays in shared memory
// and K/V tiles of 128 keys (64 at D = 128) stream through a two-stage
// ring filled by cp.async, so the copy of tile t+1 overlaps the products
// of tile t. Tiles are stored swizzled for wgmma (sm90_mma.cuh). Per tile
// and warpgroup: S = Q.K^T is one wgmma chain with both operands in shared
// memory; P is rounded to bf16 in registers (the TPU kernel's cast point,
// flash_attention.py:273) and is the register A operand of O += P.V, with
// V read MN-major from the same tile.
//
// float32 -- attention_fwd_tf32, on the tensor cores in split tf32. Every
// product is three tf32 wgmma chains (lo.hi, hi.lo, hi.hi), which keeps
// f32 accuracy (~2^-21 per product; the plain f32 version's tolerances
// hold with a wide margin) whatever PyTorch's TF32 flags say. tf32 wgmma
// takes both operands K-major, and P.V contracts over keys, so V is needed
// as V^T tiles. A block of two warpgroups owns 128 query rows (one of 64
// at D = 128). Q is split once per block: into register A fragments
// (D <= 64) or into hi/lo tiles in shared memory (D = 128, where the
// fragments would not fit the registers). Raw K and V tiles of 64 keys
// (16 at D = 128) stream through a two-stage cp.async ring two tiles
// ahead; each tile is then split into tf32 hi/lo tiles of K and of V^T
// (a second two-stage ring) by the block's threads, while the tensor cores
// run the previous tile's S = Q.K^T: the split costs one pass over shared
// memory per tile and overlaps the products. V is transposed in that pass:
// it lands in a staging layout whose chunks are XOR-spread so that the
// transposing reads and writes hit distinct banks. Within each 8-key step
// the V^T tile holds the keys in the order in which a thread's score
// accumulator holds P (keys 2c, 2c+1 in one thread, A-fragment columns c,
// c+4), so P is split in registers and goes to the A operand of O += P.V
// with no shuffle. One barrier per tile. The staging layout and the split
// passes (load_stage, split_tile, split_transposed, to_a_tf32) are in
// sm90_mma.cuh, shared with the f32 backward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: tensor cores, split tf32
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The online softmax of one key tile, shared by both routes: on the score
// accumulator s (BK keys; the thread's two rows, h = 0 at acc_row(0) and
// h = 1 8 rows below) of a tile whose first key is r0 in a panel of n
// keys, in the exp2 domain. Masks keys at or past n (a panel's end, or a
// sample's own-key length), updates the running max m and the thread's
// share of the sum l (the quad is summed at the end), rescales the
// accumulator o, and leaves the probabilities in s.
template <int BK, int D>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&o)[D / 2], float (&m)[2],
                                             float (&l)[2], int r0, int n) {
  using sm90::acc_col;
  using sm90::exp2_ftz;
  if (r0 + BK > n) {  // only a panel's last tile has padding
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
    float ls = 0.f;
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
}

// The packed own panel's block-diagonal mask, before softmax_tile: keys of
// the tile (first key r0 of the panel) outside [lo[h], hi[h]), the live own
// keys of the sample that the thread's row h belongs to, score -inf.
template <int BK>
__device__ __forceinline__ void mask_spans(float (&s)[BK / 2], int r0,
                                           const int (&lo)[2],
                                           const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const int c = r0 + sm90::acc_col(j), h = (j >> 1) & 1;
    if (c < lo[h] || c >= hi[h]) s[j] = -INFINITY;
  }
}

// The own keys that sample `sample` reads: own_len[sample] within [0, n1],
// or all n1 without own_len.
__device__ __forceinline__ int own_keys(const int* __restrict__ own_len,
                                        int sample, int n1) {
  return own_len == nullptr ? n1 : min(max(own_len[sample], 0), n1);
}

using sm90::bf16;
using sm90::Tile;

template <int D>
struct Tf32 {
  static constexpr bool QREG = D <= 64;         // Q's fragments in registers
  static constexpr int WGS = D == 128 ? 1 : 2;  // warpgroups per block
  static constexpr int BQ = 64 * WGS;           // query rows per block
  static constexpr int NT = 128 * WGS;
  static constexpr int BK = D == 128 ? 16 : 64; // keys per tile
  static constexpr int KT = BK * D * 4;         // bytes of a K or V^T tile
  static constexpr int QT = QREG ? 0 : BQ * D * 4;
  // Q hi, lo (D = 128); 2 stages of raw K, V; 2 of K hi, lo, V^T hi, lo
  static constexpr int SMEM = 1024 + 2 * QT + 2 * 2 * KT + 2 * 4 * KT;
};

template <int D>
__global__ void __launch_bounds__(Tf32<D>::NT, 1)
attention_fwd_tf32(const float* __restrict__ q,
                   const float* __restrict__ k0, const float* __restrict__ v0,
                   int n0, int shared0, float w0,
                   const float* __restrict__ k1, const float* __restrict__ v1,
                   int n1, float w1, float* __restrict__ out,
                   float* __restrict__ lse, int nq, int heads,
                   const int* __restrict__ own_len) {
  using namespace sm90;
  using C = Tf32<D>;
  constexpr int BK = C::BK, KT = C::KT, QT = C::QT, NT = C::NT;
  extern __shared__ uint8_t smem_raw[];
  // byte offsets from a 1024-aligned base: generic pointers for the split
  // passes, shared addresses for cp.async and the descriptors
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t sb = (raw_addr + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sb - raw_addr);
  auto stage_k = [&](int t) { return 2 * QT + (t & 1) * 2 * KT; };
  auto stage_v = [&](int t) { return stage_k(t) + KT; };
  auto split_at = [&](int t) { return 2 * QT + 4 * KT + (t & 1) * 4 * KT; };

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * C::BQ;
  const size_t row0 = shared0 ? (size_t)(bh % heads) : (size_t)bh;
  const float* kb0 = k0 + row0 * n0 * D;
  const float* vb0 = v0 + row0 * n0 * D;
  const float* kb1 = k1 + (size_t)bh * n1 * D;
  const float* vb1 = v1 + (size_t)bh * n1 * D;
  const int n1s = own_keys(own_len, bh / heads, n1);  // tiles past it skipped
  const int t0 = (n0 + BK - 1) / BK;         // tiles of panel 0
  const int tiles = t0 + (n1s + BK - 1) / BK;

  auto load_kv = [&](int t) {
    if (t < tiles) {
      const bool p1 = t >= t0;
      const int r0 = (p1 ? t - t0 : t) * BK;
      const int n = p1 ? n1s : n0;
      load_tile_f32<D, BK, NT>(sb + stage_k(t), p1 ? kb1 : kb0, r0, n);
      load_stage<D, BK, NT>(sb + stage_v(t), p1 ? vb1 : vb0, r0, n);
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  auto split_kv = [&](int t) {  // raw tile t into its split tiles
    uint8_t* s = base + split_at(t);
    split_tile<KT, NT>(base + stage_k(t), s, s + KT);
    split_transposed<D, BK, NT>(base + stage_v(t), s + 2 * KT, s + 3 * KT);
  };

  if constexpr (!C::QREG)  // raw Q into the hi tile, split in place below
    load_tile_f32<D, C::BQ, NT>(sb, q + (size_t)bh * nq * D, q_start, nq);
  load_kv(0);  // Q rides in group 0
  load_kv(1);
  constexpr int QK = C::QREG ? D / 8 : 1;
  uint32_t qh[QK][4], ql[QK][4];
  if constexpr (C::QREG) {
    const float* qb = q + (size_t)bh * nq * D;
    const int r = q_start + wg * 64 + acc_row(0);
    const int c = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e & 1);
        const float x =
            row < nq ? qb[(size_t)row * D + 8 * kk + c + 4 * (e >> 1)] : 0.f;
        split_tf32(x, qh[kk][e], ql[kk][e]);
      }
  }
  cp_async_wait<1>();  // tile 0 (and Q) landed
  __syncthreads();     // ... for every thread
  if constexpr (!C::QREG) split_tile<QT, NT>(base, base, base + QT);
  split_kv(0);

  float o[D / 2], s[BK / 2];
  // Each tile's P.V goes to a fresh accumulator pv, added to o in f32: the
  // tensor cores drop the bits of a sum below the accumulator's last place,
  // which over the 3 * Nk / 8 steps of a row summed straight into o pulls
  // the output toward zero (on an H100 at [8,16,3169,3169,64]: 6.7e-6
  // from the plain f32 version, against the 2e-5 bound; 6.9e-7 with pv).
  // pv lives in s's registers (dead once P is split) when they are enough.
  constexpr bool PV_IN_S = D <= BK;
  float pv_own[PV_IN_S ? 1 : D / 2];
  float(&pv)[D / 2] = *reinterpret_cast<float(*)[D / 2]>(PV_IN_S ? s : pv_own);
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
  if constexpr (!PV_IN_S) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) pv_own[j] = 0.f;
  }
  // the thread's two rows: h = 0 is row acc_row(0), h = 1 is 8 rows below
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();  // this thread's copies of tile t+1 landed
    fence_async_smem();  // its split of tile t, to the tensor cores
    __syncthreads();     // ... for every thread; tile t-1's buffers are free
    load_kv(t + 2);
    const bool p1 = t >= t0;
    if (t == t0) {  // panel 1 begins: acc and l into its weight's units
      const float cw = w0 / w1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= cw;
      l[0] *= cw;
      l[1] *= cw;
    }
    const uint32_t khi = sb + split_at(t), klo = khi + KT;
    const uint32_t vhi = khi + 2 * KT, vlo = khi + 3 * KT;

    wgmma_fence();  // S = Qlo.Khi + Qhi.Klo + Qhi.Khi
    if constexpr (C::QREG) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_rs_tf32<BK>(s, ql[kk], desc_k<2 * D, BK>(khi, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_rs_tf32<BK>(s, qh[kk], desc_k<2 * D, BK>(klo, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_rs_tf32<BK>(s, qh[kk], desc_k<2 * D, BK>(khi, 0, kk), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_ss_tf32<BK>(s, desc_k<2 * D, C::BQ>(sb + QT, wg * 64, kk),
                        desc_k<2 * D, BK>(khi, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_ss_tf32<BK>(s, desc_k<2 * D, C::BQ>(sb, wg * 64, kk),
                        desc_k<2 * D, BK>(klo, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_ss_tf32<BK>(s, desc_k<2 * D, C::BQ>(sb, wg * 64, kk),
                        desc_k<2 * D, BK>(khi, 0, kk), 1);
    }
    wgmma_commit();
    if (t + 1 < tiles) split_kv(t + 1);  // while the tensor cores run S
    wgmma_wait<0>();
    keep(s);

    softmax_tile<BK, D>(s, o, m, l, (p1 ? t - t0 : t) * BK, p1 ? n1s : n0);
    uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P as tf32 A fragments
    to_a_tf32<BK>(s, ph, pl);

    wgmma_fence();  // pv = Plo.Vhi + Phi.Vlo + Phi.Vhi
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      mma_rs_tf32<D>(pv, pl[kk], desc_k<2 * BK, D>(vhi, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      mma_rs_tf32<D>(pv, ph[kk], desc_k<2 * BK, D>(vlo, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      mma_rs_tf32<D>(pv, ph[kk], desc_k<2 * BK, D>(vhi, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(pv);
    keep(ph);
    keep(pl);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] += pv[j];
  }

  const float w_last = tiles > t0 ? w1 : w0;
  float* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int gq = q_start + wg * 64 + acc_row(2 * h);
    if (gq >= nq) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(ob + (size_t)gq * D + acc_col(4 * i)) =
          make_float2(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
    if (lse != nullptr && (threadIdx.x & 3) == 0)
      lse[(size_t)bh * nq + gq] = m[h] * LN2 + logf(l[h] * w_last);
  }
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k0, const void* v0, int n0,
                        int shared0, float w0, const void* k1, const void* v1,
                        int n1, float w1, void* out, float* lse, int bh,
                        int heads, int nq, const int* own_len,
                        cudaStream_t stream) {
  using C = Tf32<D>;
  static sm90::OncePerDevice smem_set;
  cudaError_t err = smem_set([] {
    return cudaFuncSetAttribute(attention_fwd_tf32<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::SMEM);
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + C::BQ - 1) / C::BQ, bh);
  attention_fwd_tf32<D><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k0),
      static_cast<const float*>(v0), n0, shared0, w0,
      static_cast<const float*>(k1), static_cast<const float*>(v1), n1, w1,
      static_cast<float*>(out), lse, nq, heads, own_len);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int WG_GROUPS = 2;              // warpgroups per block
constexpr int WG_BQ = 64 * WG_GROUPS;     // query rows per block
constexpr int WG_NT = 128 * WG_GROUPS;
constexpr int WG_STAGES = 2;              // K/V ring depth

template <int D> __host__ __device__ constexpr int wg_bk() { return D == 128 ? 64 : 128; }
template <int D> __host__ __device__ constexpr int wg_smem() {
  return 1024 + Tile<D>::bytes(WG_BQ) +
         WG_STAGES * 2 * Tile<D>::bytes(wg_bk<D>());
}

// PACK: a block holds `pack` samples of one head (shared prefix, Nq <= 64):
// block row r is query row r % nq of sample s_base + r / nq (rows from
// pack * nq on are dead), and its own panel is the samples' own keys end to
// end, n1 each, masked block-diagonally (mask_spans). The prefix panel is
// read once for all of them. Without PACK a block holds 128 query rows of
// one (sample, head), and its own panel stops at the sample's own length.
template <int D, bool PACK>
__global__ void __launch_bounds__(WG_NT, 1)
attention_fwd_sm90(const bf16* __restrict__ q,
                   const bf16* __restrict__ k0, const bf16* __restrict__ v0,
                   int n0, int shared0, float w0,
                   const bf16* __restrict__ k1, const bf16* __restrict__ v1,
                   int n1, float w1, bf16* __restrict__ out,
                   float* __restrict__ lse, int nq, int heads,
                   const int* __restrict__ own_len, int pack, int batch) {
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

  // PACK: sample p of the block is s_base + p; its row i of n rows per
  // (sample, head) is row `at(p, i, n)` of q, k1, v1 or out
  const int s_base = (bh / heads) * pack;
  auto live = [&](int p) { return p < pack && s_base + p < batch; };
  auto own = [&](int p) {
    return live(p) ? own_keys(own_len, s_base + p, n1) : 0;
  };
  auto at = [&](int p, int i, int n) {
    return ((size_t)(s_base + p) * heads + bh % heads) * n + i;
  };
  // own keys the block reads: tiles wholly past them are skipped
  int n1s;
  int lo[2] = {0, 0}, hi[2] = {0, 0};  // PACK: each row's live own keys
  if constexpr (PACK) {
    n1s = 0;
    for (int p = 0; p < pack; ++p)
      if (own(p) > 0) n1s = p * n1 + own(p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wg * 64 + acc_row(2 * h)) / nq;
      lo[h] = p * n1;
      hi[h] = lo[h] + own(p);
    }
  } else {
    n1s = own_keys(own_len, bh / heads, n1);
  }
  const int t0 = (n0 + BK - 1) / BK;         // tiles of panel 0
  const int tiles = t0 + (n1s + BK - 1) / BK;

  auto load_kv = [&](int t) {
    if (t < tiles) {
      const bool p1 = t >= t0;
      const int r0 = (p1 ? t - t0 : t) * BK;
      const int st = t % WG_STAGES;
      if (PACK && p1) {
        auto own_row = [&](const bf16* base) {
          return [=](int r, bool& ok) {
            const int p = (r0 + r) / n1, i = r0 + r - p * n1;
            ok = i < own(p);
            return base + (ok ? at(p, i, n1) : 0) * D;
          };
        };
        load_rows<D, BK, WG_NT>(sk(st), own_row(k1));
        load_rows<D, BK, WG_NT>(sv(st), own_row(v1));
      } else {
        const int n = p1 ? n1s : n0;
        load_tile<D, BK, WG_NT>(sk(st), p1 ? kb1 : kb0, r0, n);
        load_tile<D, BK, WG_NT>(sv(st), p1 ? vb1 : vb0, r0, n);
      }
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  if constexpr (PACK)
    load_rows<D, WG_BQ, WG_NT>(sq, [&](int r, bool& ok) {
      const int p = r / nq;
      ok = live(p);
      return q + (ok ? at(p, r - p * nq, nq) : 0) * D;
    });
  else
    load_tile<D, WG_BQ, WG_NT>(sq, q + (size_t)bh * nq * D, q_start, nq);
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

    const int r0 = (p1 ? t - t0 : t) * BK;
    if (PACK && p1) mask_spans<BK>(s, r0, lo, hi);
    softmax_tile<BK, D>(s, o, m, l, r0, p1 ? n1s : n0);
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
    bf16* orow;
    if constexpr (PACK) {
      const int p = gq / nq;
      if (!live(p)) continue;
      orow = out + at(p, gq - p * nq, nq) * D;
    } else {
      if (gq >= nq) continue;
      orow = ob + (size_t)gq * D;
    }
    const float inv = 1.f / l[h];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + acc_col(4 * i)) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] * inv,
                                o[4 * i + 2 * h + 1] * inv);
    if (!PACK && lse != nullptr && (threadIdx.x & 3) == 0)
      lse[(size_t)bh * nq + gq] = m[h] * LN2 + logf(l[h] * w_last);
  }
}

template <int D, bool PACK>
cudaError_t launch_sm90(const void* q, const void* k0, const void* v0, int n0,
                        int shared0, float w0, const void* k1, const void* v1,
                        int n1, float w1, void* out, float* lse, int bh,
                        int heads, int nq, const int* own_len, int pack,
                        cudaStream_t stream) {
  const int smem = wg_smem<D>();
  static sm90::OncePerDevice smem_set;
  cudaError_t err = smem_set([&] {
    return cudaFuncSetAttribute(attention_fwd_sm90<D, PACK>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  });
  if (err != cudaSuccess) return err;
  const int batch = bh / heads;
  // PACK: one block for each `pack` samples of a head
  const dim3 grid = PACK ? dim3(1, (batch + pack - 1) / pack * heads)
                         : dim3((nq + WG_BQ - 1) / WG_BQ, bh);
  attention_fwd_sm90<D, PACK><<<grid, WG_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k0),
      static_cast<const bf16*>(v0), n0, shared0, w0,
      static_cast<const bf16*>(k1), static_cast<const bf16*>(v1), n1, w1,
      static_cast<bf16*>(out), lse, nq, heads, own_len, pack, batch);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (attention_fwd_tf32, tensor cores in split tf32),
// 1 = bfloat16 (attention_fwd_sm90, tensor cores). Panel 1 is absent when n1 == 0 (K1).
// lse: null, or [bh, nq] float32 for the row logsumexps (K5).
// own_len: null, or [bh / heads] int32: sample s's own keys (panel 1) at or
// past own_len[s] score -inf. pack: 1, or the samples a block packs (bf16,
// shared panel 0, pack * nq <= 128, no lse).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cwm_attention(const void* q, const void* k0, const void* v0,
                             int n0, int shared0, float w0, const void* k1,
                             const void* v1, int n1, float w1, void* out,
                             void* lse_, int bh, int heads, int nq, int d,
                             int dtype, const void* own_len_, int pack,
                             void* stream) {
  float* lse = static_cast<float*>(lse_);
  const int* own_len = static_cast<const int*>(own_len_);
  if (nq <= 0 || n0 <= 0 || n1 < 0 || bh <= 0 || bh > 65535 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (pack < 1 || (pack > 1 && (dtype != 1 || !shared0 || n1 == 0 ||
                                lse != nullptr || pack * nq > WG_BQ)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)sm90::with_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (dtype == 0)
      return launch_tf32<D>(q, k0, v0, n0, shared0, w0, k1, v1, n1, w1, out,
                            lse, bh, heads, nq, own_len, s);
    return pack > 1
               ? launch_sm90<D, true>(q, k0, v0, n0, shared0, w0, k1, v1, n1,
                                      w1, out, lse, bh, heads, nq, own_len,
                                      pack, s)
               : launch_sm90<D, false>(q, k0, v0, n0, shared0, w0, k1, v1,
                                       n1, w1, out, lse, bh, heads, nq,
                                       own_len, 1, s);
  });
}
