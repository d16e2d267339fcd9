// Hopper (sm_90a) building blocks of the bf16 attention kernels
// (attention.cu, attention_bwd.cu): warpgroup matrix multiply (wgmma) with
// bf16 operands and f32 accumulators, the shared-memory matrix descriptor,
// the swizzled tile layout and its cp.async copy, and the fences between
// them.
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
// their B operand without a transposed copy.
//
// Fragments. A warpgroup is 4 warps; in an m64nN product warp w owns rows
// 16w .. 16w+15. Element j (j < N/2) of a thread's f32 accumulator is at
// row 16w + lane/4 + 8*((j/2)%2) and column 8*(j/4) + 2*(lane%4) + j%2
// (acc_row, acc_col). The bf16 A fragment of k-step kk (columns 16kk ..
// 16kk+15) wants exactly elements 8kk .. 8kk+7 of that accumulator, in
// pairs: a score tile becomes the register A operand of the next product
// with no shuffle (to_a).
//
// with_head_dim is the one switch from a runtime head dim to the kernels'
// template argument, for both routes of attention.cu and attention_bwd.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// Rows r0 .. r0+R-1 of a row-major [n][D] bf16 matrix into the swizzled
// tile at shared address `tile`, by the NT threads of the block, 16 bytes
// per copy; rows at or past n are zeros.
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const bf16* __restrict__ src,
                                          int r0, int n) {
  constexpr int W = Tile<D>::W;
  constexpr int CPR = D / 8;   // chunks per row
  constexpr int CPS = W / 16;  // chunks per slab row
#pragma unroll
  for (int i = 0; i < (R * CPR + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if ((R * CPR) % NT != 0 && e >= R * CPR) break;
    const int r = e / CPR, c = e % CPR;
    const int g = r0 + r;
    const bool ok = g < n;
    const uint32_t off = (c / CPS) * (R * W) + swizzle<W>(r * W + (c % CPS) * 16);
    cp_async16(tile + off, src + (size_t)(ok ? g : 0) * D + c * 8, ok);
  }
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
