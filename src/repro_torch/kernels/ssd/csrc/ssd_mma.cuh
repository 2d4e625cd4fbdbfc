// The tensor-core helpers of the SSD intra-chunk forward
// (ssd_intra_chunk.cu) and of its backward (ssd_intra_chunk_bwd.cu):
// cp.async, ldmatrix and bf16 mma.sync m16n8k16 with f32 accumulation, the
// exact three-way bf16 split of an f32 value that runs f32 products on the
// tensor cores at f32 accuracy, the swizzled 64-row tile layouts, and the
// staging of an X tile.  Every tile is 64 rows and every block 128 threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kT = 64;          // rows of i, j, l or n per tile; P padded
constexpr int kMaxL = 256;      // longest chunk

// bf16 tiles an X tile takes: an f32 x is split in three, a bf16 x is exact
template <typename XT>
struct XParts {
  static constexpr int value = std::is_same<XT, float>::value ? 3 : 1;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const void* ptr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// v0, v1 -> three packed bf16 pairs (hi, mid, lo), v = hi + mid + lo
// exactly: each difference is exact (Sterbenz), and what is left after two
// 8-bit parts of a 24-bit significand fits the third.
__device__ __forceinline__ void split3(float v0, float v1,
                                       unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// Tile layouts in shared memory, 64 rows each, swizzled in 16-byte chunks:
//   CB (i, j) f32: chunk j/4 of row i at (j/4) ^ 2(i%8)
//   B  (l, n) f32: chunk n/4 of row l at (n/4) ^ (l & 14)
//   X  (r, p) bf16: chunk p/8 of row r at (p/8) ^ (r%8)
// so that a warp's float2 reads of CB, its scalar reads of B down a column
// and ldmatrix's eight rows of X each touch 32 distinct banks.
__device__ __forceinline__ int cb_at(int i, int j) {
  return i * kT + ((((j >> 2) ^ ((i & 7) << 1))) << 2) + (j & 3);
}
__device__ __forceinline__ int b_at(int l, int n) {
  return l * kT + ((((n >> 2) ^ (l & 14))) << 2) + (n & 3);
}
__device__ __forceinline__ int x_at(int r, int p) {
  return r * kT + ((((p >> 3) ^ (r & 7))) << 3) + (p & 7);
}

// X rows [r0, r0 + 64) of one head into xt (XParts bf16 tiles); rows past
// L and columns past P are 0.  Async: 16-byte cp.async (bf16, aligned);
// else plain loads, an f32 value split into its three parts.  `A` is the
// including kernel's argument struct (L, P and x_sl are read).
template <typename XT, bool kAsync, typename A>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xt, const XT* xh,
                                        const A& a, int r0) {
  constexpr int kParts = XParts<XT>::value;
#pragma unroll
  for (int s = 0; s < kT * kT / 8 / kThreads; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int r = idx >> 3, c = idx & 7;
    const bool row_in = r0 + r < a.L;
    const XT* src = xh + (r0 + r) * a.x_sl + 8 * c;
    __nv_bfloat16* dst = xt + x_at(r, 8 * c);
    if constexpr (kAsync) {
      const bool ok = row_in && 8 * c < a.P;
      cp16(dst, ok ? static_cast<const void*>(src) : xh, ok);
    } else {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (row_in && 8 * c + e < a.P) ? to_f32(src[e]) : 0.f;
      uint4 w[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned hi, mid, lo;
        split3(v[2 * e], v[2 * e + 1], hi, mid, lo);
        (&w[0].x)[e] = hi;
        (&w[1].x)[e] = mid;
        (&w[2].x)[e] = lo;
      }
#pragma unroll
      for (int q = 0; q < kParts; ++q)
        *reinterpret_cast<uint4*>(dst + q * kT * kT) = w[q];
    }
  }
}

// acc (16 rows x 64 columns of one warp) += A X over one 16-wide k-step,
// A given as its split parts; X's parts from the tile at row k0.
template <int kXParts>
__device__ __forceinline__ void mma_step(float (&acc)[8][4],
                                         const unsigned (&af)[3][4],
                                         const __nv_bfloat16* xt, int k0,
                                         int lane) {
  const int r = k0 + (lane & 15);
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned bx[kXParts][4];
#pragma unroll
    for (int xp = 0; xp < kXParts; ++xp)
      ldsm_x4_trans(xt + xp * kT * kT + x_at(r, 16 * np + 8 * (lane >> 4)),
                    bx[xp]);
    // the products whose parts weigh the least first: A part q times X
    // part xp weighs 2^-8(q + xp)
#pragma unroll
    for (int s = 2; s >= 0; --s)
#pragma unroll
      for (int xp = 0; xp < kXParts; ++xp) {
        const int q = s - xp;
        if (q < 0) continue;
        mma(acc[2 * np], af[q], bx[xp][0], bx[xp][1]);
        mma(acc[2 * np + 1], af[q], bx[xp][2], bx[xp][3]);
      }
  }
}

}  // namespace
