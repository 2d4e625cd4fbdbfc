// C B^T once per chunk, shared by every head: the first launch of the SSD
// intra-chunk forward (ssd_intra_chunk.cu) and of its backward
// (ssd_intra_chunk_bwd.cu), which recomputes it rather than keep it.
//
// One block per 32 x 32 tile on or below the diagonal and per (b, c), f32
// FMAs summed over N in order, into an f32 scratch (B*NC, Lp, Lp), Lp = L
// rounded up to 64.  `A` is the including kernel's argument struct; it
// names the fields read here alike (cm, bm, cb, NC, L, N, Lp and the
// strides of B and C).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kCBT = 32;        // C B^T tile, rows and columns
constexpr int kCBK = 32;        // C B^T step over N
constexpr int kCBThreads = 256;

template <typename A>
__global__ void __launch_bounds__(kCBThreads) ssd_cb_kernel(const A a) {
  __shared__ float cs[kCBT][kCBK + 1];
  __shared__ float bs[kCBT][kCBK + 1];
  // the block's tile (ti, tj), tj <= ti, from its index in the triangle
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = ti * kCBT, j0 = tj * kCBT;
  const int bc = blockIdx.y, bb = bc / a.NC, cz = bc % a.NC;
  const float* cm = a.cm + bb * a.c_sb + cz * a.c_sc;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < a.N; k0 += kCBK) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kCBT * kCBK / kCBThreads; ++s) {
      const int idx = s * kCBThreads + tid, r = idx / kCBK, k = idx % kCBK;
      const bool kin = k0 + k < a.N;
      cs[r][k] = (i0 + r < a.L && kin) ? cm[(i0 + r) * a.c_sl + k0 + k] : 0.f;
      bs[r][k] = (j0 + r < a.L && kin) ? bm[(j0 + r) * a.b_sl + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kCBK; ++k) {
      const float c0 = cs[ty][k], c1 = cs[ty + 16][k];
      const float b0 = bs[tx][k], b1 = bs[tx + 16][k];
      acc[0][0] = fmaf(c0, b0, acc[0][0]);
      acc[0][1] = fmaf(c0, b1, acc[0][1]);
      acc[1][0] = fmaf(c1, b0, acc[1][0]);
      acc[1][1] = fmaf(c1, b1, acc[1][1]);
    }
  }
  float* out = a.cb + (long long)bc * a.Lp * a.Lp;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      out[(long long)(i0 + ty + 16 * r) * a.Lp + j0 + tx + 16 * c] =
          acc[r][c];
}

// Launch the C B^T tiles of every chunk on `st`.
template <typename A>
cudaError_t launch_cb(const A& a, cudaStream_t st) {
  const int nt = (a.L + kCBT - 1) / kCBT;
  ssd_cb_kernel<A><<<dim3(nt * (nt + 1) / 2, a.B * a.NC), kCBThreads, 0, st>>>(
      a);
  return cudaGetLastError();
}

}  // namespace
