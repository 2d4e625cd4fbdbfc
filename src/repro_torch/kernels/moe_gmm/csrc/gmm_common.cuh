// Device code shared by the grouped expert FFN's forward (moe_gmm.cu) and
// backward (moe_gmm_bwd.cu): the live-row scan, row addressing, the
// activation, and the cp.async / ldmatrix / mma.sync helpers of the bf16
// bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { kNone = 0, kSwiglu = 1, kGelu = 2 };

constexpr int kThreads = 256;      // 8 warps
constexpr int kBM = 64;            // rows per row tile

// Workspace of int32, zeroed by the caller: [0] the scan's ticket, [1] the
// number of live experts, [2, 2 + E) live rows per expert, [2 + E, 2 + 2E)
// the live experts in order.
struct Live {
  int* ws;
  int E;
  __device__ int n_live() const { return ws[1]; }
  __device__ int expert(int i) const { return ws[2 + E + i]; }
  __device__ int rows(int e) const { return ws[2 + e]; }
};

// Row r of expert e of a (B, E, C, *) tensor, or of an (E, B*C, *) one with
// sb = C * sc: r = b * C + c.
__device__ __forceinline__ long long row_off(int r, int C, long long se,
                                             long long sb, long long sc,
                                             int e) {
  return e * se + (long long)(r / C) * sb + (long long)(r % C) * sc;
}

template <int ACT>
__device__ __forceinline__ float epilogue(float x, float gate) {
  if (ACT == kSwiglu) return gate / (1.f + expf(-gate)) * x;
  if (ACT == kGelu)   // jax.nn.gelu's default (tanh) form
    return 0.5f * x *
           (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x;
}

// ============================================================= (0) scan
// One warp per row: the row is live if any value of buf's row (or, when
// `buf2` is given, of buf2's row at the same (b, e, c)) is nonzero, the
// sign bit masked, so -0 counts as zero.  The last block to finish writes
// the live-expert list in expert order.
template <typename Word>
__device__ __forceinline__ unsigned nonzero_bits(const Word& w);
template <>
__device__ __forceinline__ unsigned nonzero_bits<uint4>(const uint4& w) {
  return (w.x | w.y | w.z | w.w) & 0x7fff7fffu;     // 8 bf16
}
template <>
__device__ __forceinline__ unsigned nonzero_bits<unsigned>(const unsigned& w) {
  return w & 0x7fffffffu;                           // 1 f32
}

template <typename Word>
__device__ __forceinline__ unsigned row_bits(const void* buf, long long off,
                                             int words, int lane) {
  // strides are in elements: a Word is 8 bf16 or 1 f32
  constexpr long long kElemBytes = sizeof(Word) == 16 ? 2 : 4;
  const Word* row = reinterpret_cast<const Word*>(
      static_cast<const char*>(buf) + off * kElemBytes);
  unsigned bits = 0;
#pragma unroll 4
  for (int i = lane; i < words; i += 32) bits |= nonzero_bits(row[i]);
  return bits;
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
    scan_rows(const void* buf, long long sb, long long se, long long sc,
              const void* buf2, long long sb2, long long se2, long long sc2,
              int B, int C, int words, int* ws, int E) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.y, r = blockIdx.x * (kThreads / 32) + warp;
  if (r < B * C) {
    unsigned bits =
        row_bits<Word>(buf, row_off(r, C, se, sb, sc, e), words, lane);
    if (buf2 != nullptr)
      bits |= row_bits<Word>(buf2, row_off(r, C, se2, sb2, sc2, e), words,
                             lane);
    if (__any_sync(0xffffffffu, bits != 0) && lane == 0)
      atomicAdd(ws + 2 + e, 1);
  }
  __shared__ bool last;
  __shared__ int warp_n[kThreads / 32], total;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ws, 1) == (int)(gridDim.x * gridDim.y) - 1;
    total = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile int* count = ws + 2;
  for (int base = 0; base < E; base += kThreads) {
    const int ex = base + threadIdx.x;
    const bool on = ex < E && count[ex] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = total + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += warp_n[w];
    if (on) ws[2 + E + at] = ex;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kThreads / 32; ++w) total += warp_n[w];
    __syncthreads();
  }
  if (threadIdx.x == 0) ws[1] = total;
}

// Launch the scan over the (B, E, C, D) rows of buf (and of buf2, if not
// null) on `st`; dtype 1 is bfloat16 (D % 8 == 0), else float32.
inline cudaError_t launch_scan(int dtype, const void* buf, long long sb,
                               long long se, long long sc, const void* buf2,
                               long long sb2, long long se2, long long sc2,
                               int B, int E, int C, int D, int* ws,
                               cudaStream_t st) {
  const dim3 grid((B * C + kThreads / 32 - 1) / (kThreads / 32), E);
  if (dtype == 1)
    scan_rows<uint4><<<grid, kThreads, 0, st>>>(
        buf, sb, se, sc, buf2, sb2, se2, sc2, B, C, D / 8, ws, E);
  else
    scan_rows<unsigned><<<grid, kThreads, 0, st>>>(
        buf, sb, se, sc, buf2, sb2, se2, sc2, B, C, D, ws, E);
  return cudaGetLastError();
}

// ================================================ bfloat16 mma.sync helpers
namespace bf16 {

constexpr int kPad = 8;            // bf16 of padding per shared row (16 B)

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

__device__ __forceinline__ void ldsm_x4(const void* ptr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
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

}  // namespace bf16

}  // namespace
