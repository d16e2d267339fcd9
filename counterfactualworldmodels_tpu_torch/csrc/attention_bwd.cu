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
// arithmetic, on bf16 by the tensor cores (989 TFLOP/s), on float32 by the
// tensor cores in tf32 with three products per product (495 / 3 = 165
// TFLOP/s of f32-accurate work, against 67 TFLOP/s on the CUDA cores).
// Within a float32 block the nearer limit is shared memory: tf32 wgmma
// reads a K-major operand from shared memory at 4 bytes a value, and the
// score products take both operands from there (below), so they and the
// split passes ask about as many bytes of shared memory per clock as it
// gives (128 per SM) at the tensor cores' full rate. At the ViT-L shapes
// the f32 route runs at 0.29-0.32 of the split-tf32 bound (chip_smoke.py,
// an H100 80GB HBM3 at 700 W).
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
// float32 -- dkdv_tf32 and dq_tf32, on the tensor cores in split tf32
// (sm90_mma.cuh): every product is three tf32 wgmma chains, lo.hi, hi.lo,
// hi.hi, with f32 accumulators, whatever PyTorch's TF32 flags say. The
// passes and the arithmetic are the bf16 route's, with no rounding of P or
// dS. tf32 wgmma takes both operands K-major, so the three products that
// contract down rows need transposed tiles: dV += P^T.dO and dK += dS^T.Q
// read dO^T and Q^T tiles, dQ += dS.K a K^T tile, each built in shared
// memory from a staging tile whose chunks are XOR-spread (the transposing
// reads and writes hit distinct banks) and stored, within each 8-row step,
// in the order of the score accumulator, so P^T, dS^T and dS are split in
// registers into A fragments with no shuffle. The score products contract
// over D and need no transpose.
//   Layout. A block is two warpgroups owning 64 resident rows each (one
//   at D = 128). The resident K and V (pass 1) or Q and dO (pass 2) are
//   split once into hi/lo tiles in shared memory and read as the A
//   operand of the score products: as register fragments they would take
//   128 registers at D = 64 beside the 64 of the dK and dV sums. Streamed
//   tiles are 32 rows (16 at D = 128). Shared memory holds, per block, the
//   resident hi/lo tiles (128 KB at D = 64), ONE stage of the streamed
//   tile's split tiles, row-major (RM) and transposed (TR), and a
//   two-stage cp.async ring of its raw rows: 226 KB in pass 1 at D = 64
//   and 128. Two split stages of 64 rows would be 256 KB more.
//   Overlap without a second split stage: the score products read RM and
//   the accumulating products read TR, so each tile's TR is split while
//   the tensor cores run its score products, and the next tile's RM while
//   they run its accumulating products. That takes two barriers per tile.
//   In pass 1 the tile's lse and delta ride in the ring beside it.
//   Accuracy. Each tile's contribution to dV, dK (Nq / 8 * 3 k-steps per
//   element over the whole loop) and dQ goes to a fresh accumulator that
//   is added to the running sum in f32: the tensor cores drop the bits of
//   a sum below the accumulator's last place, which summed straight into
//   one accumulator biases a long contraction (attention.cu's forward
//   measured 6.7e-6 that way against 6.9e-7). At D = 128 dV's and dK's
//   tile share one fresh accumulator, in turn, for the registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "sm90_mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: tensor cores, split tf32
// ---------------------------------------------------------------------------

// Both passes: NW warpgroups, each owning 64 resident rows (keys in pass
// 1, queries in pass 2), and streamed tiles of BT rows. Shared memory, in
// bytes from a 1024-aligned base: the resident X and Y (K and V in pass 1,
// Q and dO in pass 2) as hi, lo tiles; the streamed tile's row-major
// hi, lo tiles (RM: X then Y); its transposed hi, lo tiles (TR: X^T, then
// Y^T in pass 1); a two-stage ring of raw streamed tiles (X, Y staged),
// and in pass 1 the tile's lse and delta beside the ring.
template <int D>
struct Tf32Bwd {
  static constexpr int NW = D == 128 ? 1 : 2;    // warpgroups per block
  static constexpr int R = 64 * NW;              // resident rows per block
  static constexpr int NT = 128 * NW;
  static constexpr int BT = D == 128 ? 16 : 32;  // streamed rows per tile
  static constexpr int RT = R * D * 4;           // a resident tile
  static constexpr int ST = BT * D * 4;          // a streamed tile
  static constexpr int RM = 4 * RT;
  static constexpr int TR = RM + 4 * ST;
  static constexpr int RAW1 = TR + 4 * ST;       // pass 1: TR holds 4 tiles
  static constexpr int RAW2 = TR + 2 * ST;       // pass 2: 2
  static constexpr int STATS = RAW1 + 4 * ST;    // pass 1: [2][lse, delta][BT]
  static constexpr int SMEM1 = 1024 + STATS + 2 * 2 * BT * 4;
  static constexpr int SMEM2 = 1024 + RAW2 + 4 * ST;
  // two fresh accumulators (dV's and dK's) where the registers allow
  static constexpr bool TWO = D <= 64;
};

// d = A.B^T in split tf32 over D (lo.hi, hi.lo, hi.hi; one accumulator):
// A rows row0 .. row0+63 of an RA-row tile pair, B the N-row tile pair,
// both K-major Tile<2 * D> in shared memory
template <int N, int D, int RA>
__device__ __forceinline__ void ss3(float (&d)[N / 2], uint32_t ahi,
                                    uint32_t alo, int row0, uint32_t bhi,
                                    uint32_t blo) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss_tf32<N>(d, desc_k<2 * D, RA>(alo, row0, kk),
                   desc_k<2 * D, N>(bhi, 0, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss_tf32<N>(d, desc_k<2 * D, RA>(ahi, row0, kk),
                   desc_k<2 * D, N>(blo, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss_tf32<N>(d, desc_k<2 * D, RA>(ahi, row0, kk),
                   desc_k<2 * D, N>(bhi, 0, kk), 1);
}

// d = A.B in split tf32 over BT rows: A the register fragments (to_a_tf32)
// of a [64 x BT] accumulator, B the transposed tile pair (D rows of BT,
// split_transposed)
template <int D, int BT>
__device__ __forceinline__ void rs3(float (&d)[D / 2],
                                    const uint32_t (&ah)[BT / 8][4],
                                    const uint32_t (&al)[BT / 8][4],
                                    uint32_t bhi, uint32_t blo) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
    mma_rs_tf32<D>(d, al[kk], desc_k<2 * BT, D>(bhi, 0, kk), kk);
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
    mma_rs_tf32<D>(d, ah[kk], desc_k<2 * BT, D>(blo, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
    mma_rs_tf32<D>(d, ah[kk], desc_k<2 * BT, D>(bhi, 0, kk), 1);
}

// the thread's accumulator rows h = 0, 1 (acc_row(0) and 8 below) at row
// g of a [*, D] f32 output
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst,
                                               const float (&acc)[D / 2],
                                               int h, size_t g) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    *reinterpret_cast<float2*>(dst + g * D + sm90::acc_col(4 * i)) =
        make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

// Pass 1: dK and dV of one (bh, R keys); query tiles of BT stream.
template <int D>
__global__ void __launch_bounds__(Tf32Bwd<D>::NT, 1)
dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dk, float* __restrict__ dv, int nq, int nk) {
  using namespace sm90;
  using C = Tf32Bwd<D>;
  constexpr int R = C::R, BT = C::BT, NT = C::NT, RT = C::RT, ST = C::ST;
  constexpr int KHI = 0, KLO = RT, VHI = 2 * RT, VLO = 3 * RT;
  constexpr int QHI = C::RM, QLO = QHI + ST, DOHI = QHI + 2 * ST,
                DOLO = QHI + 3 * ST;
  constexpr int QTHI = C::TR, QTLO = QTHI + ST, DOTHI = QTHI + 2 * ST,
                DOTLO = QTHI + 3 * ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t sb = (raw_addr + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sb - raw_addr);
  auto raw_q = [](int t) { return C::RAW1 + (t & 1) * 2 * ST; };
  auto raw_do = [](int t) { return C::RAW1 + (t & 1) * 2 * ST + ST; };
  auto stats = [](int t) { return C::STATS + (t & 1) * 2 * BT * 4; };

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const size_t qoff = (size_t)bh * nq;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;
  const int tiles = (nq + BT - 1) / BT;

  // raw K and V into their hi tiles, split in place below
  load_tile_f32<D, R, NT>(sb + KHI, k + (size_t)bh * nk * D, k0, nk);
  load_tile_f32<D, R, NT>(sb + VHI, v + (size_t)bh * nk * D, k0, nk);
  auto load_q = [&](int t) {
    if (t < tiles) {
      const int r0 = t * BT;
      load_stage<D, BT, NT>(sb + raw_q(t), qb, r0, nq);
      load_stage<D, BT, NT>(sb + raw_do(t), dob, r0, nq);
      const int i = threadIdx.x;
      if (i < 2 * BT) {  // the tile's lse, then its delta
        const int c = i % BT;
        const bool ok = r0 + c < nq;
        cp_async4(sb + stats(t) + 4 * i,
                  (i < BT ? lse : delta) + qoff + (ok ? r0 + c : 0), ok);
      }
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  load_q(0);  // K and V ride in group 0
  load_q(1);
  cp_async_wait<1>();
  __syncthreads();
  split_tile<RT, NT>(base + KHI, base + KHI, base + KLO);
  split_tile<RT, NT>(base + VHI, base + VHI, base + VLO);
  split_rows<D, BT, NT>(base + raw_q(0), base + QHI, base + QLO);
  split_rows<D, BT, NT>(base + raw_do(0), base + DOHI, base + DOLO);

  constexpr bool TWO = C::TWO;
  float dka[D / 2], dva[D / 2], s[BT / 2], dp[BT / 2];
  float fv[D / 2], fk_own[TWO ? D / 2 : 1];  // a tile's dV and dK
  float(&fk)[D / 2] = *reinterpret_cast<float(*)[D / 2]>(TWO ? fk_own : fv);
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = fv[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (TWO ? D / 2 : 1); ++j) fk_own[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BT / 2; ++j) s[j] = dp[j] = 0.f;
  const bool key_ok[2] = {k0 + wg * 64 + acc_row(0) < nk,
                          k0 + wg * 64 + acc_row(2) < nk};

  for (int t = 0; t < tiles; ++t) {
    fence_async_smem();  // this thread's split of RM(t), to the tensor cores
    __syncthreads();     // RM(t) whole; every warpgroup is done with TR(t-1)

    wgmma_fence();  // S^T = K.Q^T, dP^T = V.dO^T
    ss3<BT, D, R>(s, sb + KHI, sb + KLO, wg * 64, sb + QHI, sb + QLO);
    ss3<BT, D, R>(dp, sb + VHI, sb + VLO, wg * 64, sb + DOHI, sb + DOLO);
    wgmma_commit();
    // while the tensor cores run them: Q^T and dO^T of tile t
    split_transposed<D, BT, NT>(base + raw_q(t), base + QTHI, base + QTLO);
    split_transposed<D, BT, NT>(base + raw_do(t), base + DOTHI,
                                base + DOTLO);
    wgmma_wait<0>();
    keep(s);
    keep(dp);

    const float* ls = reinterpret_cast<const float*>(base + stats(t));
    const float* dl = ls + BT;
    const int q0 = t * BT;
    // masks only where the tile crosses Nq or the block crosses Nk
    const bool edge = !(key_ok[0] && key_ok[1]) || q0 + BT > nq;
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {  // rows: keys, columns: queries
      const int c = acc_col(j);
      const bool ok = !edge || (key_ok[(j >> 1) & 1] && q0 + c < nq);
      const float p = ok ? exp2_ftz(fmaf(s[j], LOG2E, -ls[c] * LOG2E)) : 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - dl[c]);
    }
    uint32_t ph[BT / 8][4], pl[BT / 8][4], dh[BT / 8][4], dlo[BT / 8][4];
    to_a_tf32<BT>(s, ph, pl);    // P^T
    to_a_tf32<BT>(dp, dh, dlo);  // dS^T

    cp_async_wait<0>();  // this thread's copies of raw tile t+1 landed
    fence_async_smem();  // its split of TR(t), to the tensor cores
    __syncthreads();     // TR(t) whole; RM(t) and raw tile t are free
    load_q(t + 2);

    // Each tile's dV and dK go to fresh accumulators, added to the sums in
    // f32: the tensor cores drop the bits of a sum below the accumulator's
    // last place, which over Nq / 8 * 3 steps of one accumulator biases it
    wgmma_fence();
    rs3<D, BT>(fv, ph, pl, sb + DOTHI, sb + DOTLO);  // P^T.dO
    if constexpr (!TWO) {  // one fresh accumulator, in turn
      wgmma_commit();
      wgmma_wait<0>();
      keep(fv);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dva[j] += fv[j];
      wgmma_fence();
    }
    rs3<D, BT>(fk, dh, dlo, sb + QTHI, sb + QTLO);  // dS^T.Q
    wgmma_commit();
    if (t + 1 < tiles) {  // RM(t+1), while the tensor cores run them
      split_rows<D, BT, NT>(base + raw_q(t + 1), base + QHI, base + QLO);
      split_rows<D, BT, NT>(base + raw_do(t + 1), base + DOHI, base + DOLO);
    }
    wgmma_wait<0>();
    keep(fv);
    keep(fk);
    keep(ph);
    keep(pl);
    keep(dh);
    keep(dlo);
    if constexpr (TWO) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dva[j] += fv[j];
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dka[j] += fk[j];
  }

  float* dkb = dk + (size_t)bh * nk * D;
  float* dvb = dv + (size_t)bh * nk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = k0 + wg * 64 + acc_row(2 * h);
    if (g >= nk) continue;
    store_rows_f32<D>(dkb, dka, h, g);
    store_rows_f32<D>(dvb, dva, h, g);
  }
}

// Pass 2: dQ of one (bh, R queries); key tiles of BT stream.
template <int D>
__global__ void __launch_bounds__(Tf32Bwd<D>::NT, 1)
dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int nq, int nk) {
  using namespace sm90;
  using C = Tf32Bwd<D>;
  constexpr int R = C::R, BT = C::BT, NT = C::NT, RT = C::RT, ST = C::ST;
  constexpr int QHI = 0, QLO = RT, DOHI = 2 * RT, DOLO = 3 * RT;
  constexpr int KHI = C::RM, KLO = KHI + ST, VHI = KHI + 2 * ST,
                VLO = KHI + 3 * ST;
  constexpr int KTHI = C::TR, KTLO = KTHI + ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t sb = (raw_addr + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sb - raw_addr);
  auto raw_k = [](int t) { return C::RAW2 + (t & 1) * 2 * ST; };
  auto raw_v = [](int t) { return C::RAW2 + (t & 1) * 2 * ST + ST; };

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const size_t qoff = (size_t)bh * nq;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;
  const int tiles = (nk + BT - 1) / BT;

  // raw Q and dO into their hi tiles, split in place below
  load_tile_f32<D, R, NT>(sb + QHI, q + qoff * D, q0, nq);
  load_tile_f32<D, R, NT>(sb + DOHI, dout + qoff * D, q0, nq);
  auto load_kv = [&](int t) {
    if (t < tiles) {
      load_stage<D, BT, NT>(sb + raw_k(t), kb, t * BT, nk);
      load_stage<D, BT, NT>(sb + raw_v(t), vb, t * BT, nk);
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  load_kv(0);  // Q and dO ride in group 0
  load_kv(1);

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
  cp_async_wait<1>();
  __syncthreads();
  split_tile<RT, NT>(base + QHI, base + QHI, base + QLO);
  split_tile<RT, NT>(base + DOHI, base + DOHI, base + DOLO);
  split_rows<D, BT, NT>(base + raw_k(0), base + KHI, base + KLO);
  split_rows<D, BT, NT>(base + raw_v(0), base + VHI, base + VLO);

  float dqa[D / 2], f[D / 2], s[BT / 2], dp[BT / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dqa[j] = f[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BT / 2; ++j) s[j] = dp[j] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    fence_async_smem();  // this thread's split of RM(t), to the tensor cores
    __syncthreads();     // RM(t) whole; every warpgroup is done with TR(t-1)

    wgmma_fence();  // S = Q.K^T, dP = dO.V^T
    ss3<BT, D, R>(s, sb + QHI, sb + QLO, wg * 64, sb + KHI, sb + KLO);
    ss3<BT, D, R>(dp, sb + DOHI, sb + DOLO, wg * 64, sb + VHI, sb + VLO);
    wgmma_commit();
    // while the tensor cores run them: K^T of tile t
    split_transposed<D, BT, NT>(base + raw_k(t), base + KTHI, base + KTLO);
    wgmma_wait<0>();
    keep(s);
    keep(dp);

    const int k0 = t * BT;
    // masks only where the tile crosses Nk or the block crosses Nq
    const bool edge = !(q_ok[0] && q_ok[1]) || k0 + BT > nk;
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {  // rows: queries, columns: keys
      const int h = (j >> 1) & 1;
      const bool ok = !edge || (q_ok[h] && k0 + acc_col(j) < nk);
      const float p = ok ? exp2_ftz(fmaf(s[j], LOG2E, -lsl[h])) : 0.f;
      dp[j] = p * (dp[j] - dls[h]);
    }
    uint32_t dh[BT / 8][4], dlo[BT / 8][4];
    to_a_tf32<BT>(dp, dh, dlo);  // dS

    cp_async_wait<0>();  // this thread's copies of raw tile t+1 landed
    fence_async_smem();  // its split of TR(t), to the tensor cores
    __syncthreads();     // TR(t) whole; RM(t) and raw tile t are free
    load_kv(t + 2);

    // each tile's dQ goes to a fresh accumulator, added to the sum in f32
    wgmma_fence();
    rs3<D, BT>(f, dh, dlo, sb + KTHI, sb + KTLO);  // dS.K
    wgmma_commit();
    if (t + 1 < tiles) {  // RM(t+1), while the tensor cores run it
      split_rows<D, BT, NT>(base + raw_k(t + 1), base + KHI, base + KLO);
      split_rows<D, BT, NT>(base + raw_v(t + 1), base + VHI, base + VLO);
    }
    wgmma_wait<0>();
    keep(f);
    keep(dh);
    keep(dlo);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dqa[j] += f[j];
  }

  float* dqb = dq + qoff * D;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (q_ok[h]) store_rows_f32<D>(dqb, dqa, h, gq[h]);
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        int bh, int nq, int nk, cudaStream_t stream) {
  using C = Tf32Bwd<D>;
  static sm90::OncePerDevice smem_set;
  cudaError_t err = smem_set([] {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM1);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        dq_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM2);
  });
  if (err != cudaSuccess) return err;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* dd = static_cast<const float*>(dout);
  dkdv_tf32<D><<<dim3((nk + C::R - 1) / C::R, bh), C::NT, C::SMEM1,
                 stream>>>(qq, kk, vv, dd, lse, delta,
                           static_cast<float*>(dk), static_cast<float*>(dv),
                           nq, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_tf32<D><<<dim3((nq + C::R - 1) / C::R, bh), C::NT, C::SMEM2, stream>>>(
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

// dtype: 0 = float32 (dkdv_tf32, dq_tf32: tensor cores in split tf32),
// 1 = bfloat16 (dkdv_sm90, dq_sm90: tensor cores) for q, k, v, dout, dq, dk, dv; lse and
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
    return dtype == 0 ? launch_tf32<D>(q, k, v, dout, l, dl, dq, dk, dv, bh,
                                       nq, nk, s)
                      : launch_sm90<D>(q, k, v, dout, l, dl, dq, dk, dv, bh,
                                       nq, nk, s);
  });
}
