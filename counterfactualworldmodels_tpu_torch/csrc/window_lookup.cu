// RAFT correlation-pyramid window lookup for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   counterfactualworldmodels_tpu/models/raft/corr.py:_window_lookup_lanes_kernel
//     (launched by _window_lookup_lanes; entry lookup_pyramid_lanes) -- K3
//   counterfactualworldmodels_tpu/models/raft/corr.py:_window_lookup_kernel
//     (launched by _window_lookup_tpu, the CWM_RAFT_LANES=0 route)   -- K4
// Both TPU layouts (queries on lanes; padded row-major level) exist only to
// suit the TPU's vector unit and MXU. Here one kernel reads the unpadded
// row-major level [N, h, w] directly.
//
// Contract. For query n at level coordinates (x[n], y[n]) and radius r,
// out[n, a, b] is the bilinear sample of level[n] at (x - r + a, y - r + b),
// with zeros outside the level (grid_sample's zero padding, corner by
// corner), so the output is [N, 2r+1, 2r+1] in [x-offset, y-offset] order
// (corr.py:122). Coordinates are first clipped to [-(r+1), w+r] and
// [-(r+1), h+r] as corr.py:99-100 does; beyond that every corner is out of
// bounds either way. Float32 in and out, like the JAX lookup.
//
// What bounds it on the H100. It does ~10 operations per output and reads
// at most (2r+2)^2 level values per query: a few bytes per operation, so
// it is bound by memory traffic -- the output write (N*(2r+1)^2*4 bytes)
// and the window reads, which touch the level once.
//
// Design. One thread per output element: consecutive threads write
// consecutive outputs (coalesced stores), and the 81 threads of one query
// read the same (2r+2)^2 patch of one level row, so neighbouring threads
// hit the same cache lines. Out-of-bounds corners are skipped by bounds
// checks instead of padding the level, so no padded copy of the pyramid is
// ever made. One launch per pyramid level.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void window_lookup_kernel(const float* __restrict__ level,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ ys,
                                     float* __restrict__ out, int n, int h,
                                     int w, int r) {
  const int p = 2 * r + 1;
  const int pp = p * p;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * pp) return;
  const int qi = (int)(idx / pp);
  const int o = (int)(idx - (long long)qi * pp);
  const int a = o / p;  // x offset
  const int b = o - a * p;  // y offset

  const float x = fminf(fmaxf(xs[qi], -(r + 1.0f)), (float)(w + r));
  const float y = fminf(fmaxf(ys[qi], -(r + 1.0f)), (float)(h + r));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  const int xi = (int)x0 - r + a;
  const int yi = (int)y0 - r + b;
  const float* row = level + (size_t)qi * h * w;

  float c[2][2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = yi + dy, xx = xi + dx;
      c[dy][dx] = (yy >= 0 && yy < h && xx >= 0 && xx < w) ? row[yy * w + xx] : 0.f;
    }
  out[idx] = (1.f - wy) * (1.f - wx) * c[0][0] + (1.f - wy) * wx * c[0][1] +
             wy * (1.f - wx) * c[1][0] + wy * wx * c[1][1];
}

}  // namespace

// level [n, h, w], xs/ys [n], out [n, 2r+1, 2r+1]; all float32, contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cwm_window_lookup(const float* level, const float* xs,
                                 const float* ys, float* out, int n, int h,
                                 int w, int r, void* stream) {
  // a zero-size level (a pyramid of a tiny image) is all out of bounds:
  // the kernel then writes zeros without reading it
  if (n <= 0 || h < 0 || w < 0 || r < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * (2 * r + 1) * (2 * r + 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  window_lookup_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(level, xs, ys,
                                                              out, n, h, w, r);
  return (int)cudaGetLastError();
}
