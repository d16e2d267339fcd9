// Hopper (sm_90a) building blocks of the attention kernels (attention.cu,
// attention_bwd.cu): warpgroup matrix multiply (wgmma) with bf16 or tf32
// operands and f32 accumulators, the shared-memory matrix descriptor,
// the swizzled tile layout and its cp.async copy, the split-tf32 passes,
// and the fences between them.
//
// Tile layout. A tile of R rows of D bf16 values (row-major [n][D] in
// device memory) lives in shared memory in the layout wgmma reads with a
// swizzle of W = min(2D, 128) bytes: each row is cut into slabs of W bytes
// (D = 128 has two), a slab holds all R rows at a stride of W bytes, and
// the 16-byte chunks of a row are XOR-permuted by the row's bits above the
// 128-byte line (the 32B, 64B or 128B swizzle mode, by D). Every tile
// starts on a 1024-byte boundary, so the hardware's swizzle, which acts on
// address bits, sees the same pattern the copy wrote. The same tile serves
// as a K-major operand (the product contracts along D) and as an MN-major
// one (it contracts down the rows), which is how P.V, dV, dK and dQ read
// their B operand without a transposed copy. A row of D floats has the
// bytes of a row of 2D bf16 values, so an f32 tile is the bf16 tile of
// twice the width: Tile<2 * D>, copied by load_tile_f32 and described by
// desc_k<2 * D, R>, whose 32-byte k-step is the 8 values of one tf32 step.
//
// Fragments. A warpgroup is 4 warps; in an m64nN product warp w owns rows
// 16w .. 16w+15. Element j (j < N/2) of a thread's f32 accumulator is at
// row 16w + lane/4 + 8*((j/2)%2) and column 8*(j/4) + 2*(lane%4) + j%2
// (acc_row, acc_col). The bf16 A fragment of k-step kk (columns 16kk ..
// 16kk+15) wants exactly elements 8kk .. 8kk+7 of that accumulator, in
// pairs: a score tile becomes the register A operand of the next product
// with no shuffle (to_a). The tf32 A fragment of a k-step (8 columns) is
// a[0] at (row lane/4, column lane%4), a[1] 8 rows below, a[2] and a[3]
// the same rows 4 columns on.
//
// Split tf32 products ("3xTF32"), for f32 accuracy on the tensor cores.
// x = hi + lo with hi = x rounded to tf32 (to nearest, ties away: the 13
// low bits of the f32 pattern) and lo = x - hi, exact in f32; the tensor
// core keeps lo's high 19 bits, so hi + lo' is within 2^-21 |x| of x. A
// product a.b is lo_a.hi_b + hi_a.lo_b + hi_a.hi_b in f32 accumulators,
// the small terms first; lo_a.lo_b (under 2^-22 |ab|) is dropped. One tf32
// pass alone keeps about three decimal digits. The f32 kernels split
// their operands in shared memory: a raw tile lands by cp.async in a
// staging layout (load_stage) and is split into K-major hi/lo tiles, as it
// is (split_rows) or transposed (split_transposed) for a product that
// contracts down its rows; to_a_tf32 splits an accumulator into A
// fragments in the order split_transposed stores the rows.
//
// with_head_dim is the one switch from a runtime head dim to the kernels'
// template argument, for both routes of attention.cu and attention_bwd.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace sm90 {

typedef __nv_bfloat16 bf16;

template <int D>
struct Tile {
  static constexpr int W = 2 * D < 128 ? 2 * D : 128;  // swizzle width, bytes
  // descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t MODE = W == 128 ? 1 : (W == 64 ? 2 : 3);
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * 2 * D;
  }
};

__host__ __device__ constexpr int align1k(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// the byte offset of a logical offset within a W-byte-swizzled tile
template <int W>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ ((off >> 3) & ((W / 16 - 1) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// K-major operand: rows row0 .. row0+63 (A) or all R rows (B) of an R-row
// tile, values 16kk .. 16kk+15 along D. Within a swizzle atom the k-step
// moves the start address by 32 bytes; 8-row groups are 8W bytes apart.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  constexpr int W = Tile<D>::W;
  const uint32_t byte = kk * 32;
  return make_desc(tile + (byte / W) * (R * W) + row0 * W + byte % W, 16,
                   8 * W, Tile<D>::MODE);
}

// MN-major operand: rows 16kk .. 16kk+15 of an R-row tile as the k-step,
// all D values as N. 8-row groups are 8W bytes apart (stride offset); the
// second slab at D = 128 is R*W bytes on (leading offset).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  constexpr int W = Tile<D>::W;
  return make_desc(tile + kk * 16 * W, R * W, 8 * W, Tile<D>::MODE);
}

// 16 bytes from device to shared memory, asynchronously; zeros when !ok
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's completed shared-memory writes visible to wgmma (the
// async proxy); a barrier after it publishes them to the block
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// R rows of D bf16 values, gathered from anywhere, into the swizzled tile
// at shared address `tile`, by the NT threads of the block, 16 bytes per
// copy: row(r, ok) returns the address of row r and sets ok; a row with ok
// false is zeros (its address must still be valid).
template <int D, int R, int NT, typename Row>
__device__ __forceinline__ void load_rows(uint32_t tile, Row row) {
  constexpr int W = Tile<D>::W;
  constexpr int CPR = D / 8;   // chunks per row
  constexpr int CPS = W / 16;  // chunks per slab row
#pragma unroll
  for (int i = 0; i < (R * CPR + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if ((R * CPR) % NT != 0 && e >= R * CPR) break;
    const int r = e / CPR, c = e % CPR;
    bool ok;
    const bf16* src = row(r, ok);
    const uint32_t off = (c / CPS) * (R * W) + swizzle<W>(r * W + (c % CPS) * 16);
    cp_async16(tile + off, src + c * 8, ok);
  }
}

// Rows r0 .. r0+R-1 of a row-major [n][D] bf16 matrix into the swizzled
// tile at shared address `tile`; rows at or past n are zeros.
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const bf16* __restrict__ src,
                                          int r0, int n) {
  load_rows<D, R, NT>(tile, [&](int r, bool& ok) {
    const int g = r0 + r;
    ok = g < n;
    return src + (size_t)(ok ? g : 0) * D;
  });
}

// Rows r0 .. r0+R-1 of a row-major [n][D] float32 matrix into the f32
// tile (Tile<2 * D>) at `tile`; rows at or past n are zeros.
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile_f32(uint32_t tile,
                                              const float* __restrict__ src,
                                              int r0, int n) {
  load_tile<2 * D, R, NT>(tile, reinterpret_cast<const bf16*>(src), r0, n);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point (call after wgmma_wait).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int K>
__device__ __forceinline__ void keep(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// row and column of accumulator element j within the warpgroup's 64-row tile
__device__ __forceinline__ int acc_row(int j) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((j >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0.
// exp2f adds a range fix-up for such results that costs about a tenth of
// K6's time; softmax terms that small vanish in the f32 sums and in bf16.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an m64nN f32 accumulator, rounded to bf16, as the A operands of the
// N/16 k-steps of the next product
template <int N>
__device__ __forceinline__ void to_a(const float (&acc)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], bf16 in, f32 accumulate, issued
// asynchronously by the warpgroup. mma_ss: A and B K-major in shared
// memory. mma_rs: A from registers (to_a), B MN-major in shared memory.
// accumulate = 0 overwrites D.
template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                       int accumulate);
template <int N>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                       int accumulate);

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// x rounded to tf32, to nearest with ties away from zero (the f32 pattern
// with its 13 low bits cleared), on the integer units
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as hi + lo for the split products: hi in tf32, lo the exact f32 rest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// an m64nN f32 accumulator as the split tf32 A operands (hi, lo) of the
// N/8 k-steps of the next product: a[e] of a k-step is element
// (e & 1) * 2 + (e >> 1) of its four (rows h = e & 1, column 2c + (e >> 1)),
// so fragment column c holds accumulator column 2c and column c + 4 holds
// 2c + 1. The B operand stores each 8-row k-step in that order
// (split_transposed).
template <int N>
__device__ __forceinline__ void to_a_tf32(const float (&acc)[N / 2],
                                          uint32_t (&hi)[N / 8][4],
                                          uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(acc[4 * kk + 2 * (e & 1) + (e >> 1)], hi[kk][e], lo[kk][e]);
}

// The staging tile of an f32 tile that is split in shared memory: row r
// at byte 4D * r, its 16-byte chunk c in slot c ^ stage_swz(r). The XOR
// permutes each 8 aligned slots, so a quarter-warp's copies into one row
// stay on distinct banks, and so do the 8 rows 8g + 2i + h (g = 0..3,
// h = 0..1) whose chunk c a quarter-warp of split_transposed reads at once.
template <int D>
__device__ __forceinline__ int stage_swz(int r) {
  return D >= 32 ? 2 * ((r >> 3) & 3) + (r & 1) : (r >> 3) & 3;
}

// Rows r0 .. r0+R-1 of a row-major [n][D] f32 matrix into the staging
// tile at shared address `tile`, by the NT threads of the block; zeros at
// or past n
template <int D, int R, int NT>
__device__ __forceinline__ void load_stage(uint32_t tile,
                                           const float* __restrict__ src,
                                           int r0, int n) {
  constexpr int CPR = D / 4;  // chunks per row
#pragma unroll
  for (int i = 0; i < (R * CPR + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if ((R * CPR) % NT != 0 && e >= R * CPR) break;
    const int r = e / CPR, c = e % CPR;
    const int g = r0 + r;
    const bool ok = g < n;
    cp_async16(tile + r * 4 * D + 16 * (c ^ stage_swz<D>(r)),
               src + (size_t)(ok ? g : 0) * D + 4 * c, ok);
  }
}

__device__ __forceinline__ void split4(const float4 x, uint4& h, uint4& l) {
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
}

// Each 16-byte chunk of the f32 tile `src` (BYTES long) split into the
// chunks at the same offsets of the tf32 tiles hi and lo (hi may be src)
template <int BYTES, int NT>
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo) {
  constexpr int CHUNKS = BYTES / 16;
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if (CHUNKS % NT != 0 && e >= CHUNKS) break;
    uint4 h, l;
    split4(*reinterpret_cast<const float4*>(src + 16 * e), h, l);
    *reinterpret_cast<uint4*>(hi + 16 * e) = h;
    *reinterpret_cast<uint4*>(lo + 16 * e) = l;
  }
}

// A staging tile of R rows split into the K-major tf32 tiles hi and lo
// (R rows of D values, Tile<2 * D>, the layout load_tile_f32 writes)
template <int D, int R, int NT>
__device__ __forceinline__ void split_rows(const uint8_t* stage, uint8_t* hi,
                                           uint8_t* lo) {
  constexpr int W = Tile<2 * D>::W;
  constexpr int CPR = D / 4;   // chunks per row
  constexpr int CPS = W / 16;  // chunks per slab row
#pragma unroll
  for (int i = 0; i < (R * CPR + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if ((R * CPR) % NT != 0 && e >= R * CPR) break;
    const int r = e / CPR, c = e % CPR;
    uint4 h, l;
    split4(*reinterpret_cast<const float4*>(stage + r * 4 * D +
                                            16 * (c ^ stage_swz<D>(r))),
           h, l);
    const uint32_t off =
        (c / CPS) * (R * W) + swizzle<W>(r * W + (c % CPS) * 16);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A staging tile of R rows split and transposed into the K-major tf32
// tiles hi and lo (D rows of R values, Tile<2 * R>): the operand of a
// product that contracts down the R rows. A thread takes rows
// 8g + 2i + h (i = 0..3) x columns 4c .. 4c+3 and writes, for each column,
// the 4 floats at positions 8g + 4h .. 8g + 4h + 3 of that column's row:
// position p of an 8-row step holds row 2p (p < 4) or 2(p - 4) + 1, the
// order of to_a_tf32's fragments.
template <int D, int R, int NT>
__device__ __forceinline__ void split_transposed(const uint8_t* stage,
                                                 uint8_t* hi, uint8_t* lo) {
  constexpr int TASKS = D * R / 16;
  constexpr int W = Tile<2 * R>::W;
#pragma unroll
  for (int it = 0; it < (TASKS + NT - 1) / NT; ++it) {
    const int e = threadIdx.x + it * NT;
    if (TASKS % NT != 0 && e >= TASKS) break;
    const int h = e & 1, g = (e >> 1) % (R / 8), c = e / (R / 4);
    float x[4][4];  // [row i][column j]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 8 * g + 2 * i + h;
      const float4 v = *reinterpret_cast<const float4*>(
          stage + r * 4 * D + 16 * (c ^ stage_swz<D>(r)));
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    }
    const int b = 4 * (8 * g + 4 * h);  // byte of position 8g + 4h in a row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * c + j;
      const uint32_t off = (b / W) * (D * W) + swizzle<W>(d * W + b % W);
      uint4 hv, lv;
      split4(make_float4(x[0][j], x[1][j], x[2][j], x[3][j]), hv, lv);
      *reinterpret_cast<uint4*>(hi + off) = hv;
      *reinterpret_cast<uint4*>(lo + off) = lv;
    }
  }
}

// D[64 x N] (+)= A[64 x 8] . B[8 x N], tf32 in, f32 accumulate, issued
// asynchronously by the warpgroup; both operands K-major (the only tf32
// layout). mma_ss_tf32: A and B in shared memory. mma_rs_tf32: A from
// registers (the tf32 fragment above). accumulate = 0 overwrites D.
template <int N>
__device__ void mma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                            int accumulate);
template <int N>
__device__ void mma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                            uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void mma_ss_tf32<16>(float (&d)[8], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss_tf32<32>(float (&d)[16], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<16>(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<32>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_tf32<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// A launcher's one-time setup (cudaFuncSetAttribute), run once per device:
// each launcher instantiation keeps one of these as a function-local static.
class OncePerDevice {
 public:
  template <typename F>
  cudaError_t operator()(F&& setup) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return setup();
    const uint64_t bit = 1ull << dev;
    if (done_.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = setup();
    if (err == cudaSuccess) done_.fetch_or(bit, std::memory_order_acq_rel);
    return err;
  }

 private:
  std::atomic<uint64_t> done_{0};
};

// f(std::integral_constant<int, D>{}) for a head dim d the attention
// kernels are built for (16, 32, 64, 128); any other d is refused.
template <typename F>
cudaError_t with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
