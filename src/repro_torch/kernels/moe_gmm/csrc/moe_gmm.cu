// Grouped expert FFN for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py::_gmm_kernel,
// launched by grouped_ffn_pallas.  It computes the same function: for every
// batch row b and expert e, with X = buf[b, e] (C capacity rows of width D),
//     swiglu:  out[b, e] = (silu(X W_gate[e]) * (X W_in[e])) W_out[e]
//     gelu:    out[b, e] = gelu_tanh(X W_in[e]) W_out[e]
// with f32 sums and the output in buf's dtype.
//
// Layout.  buf (B, E, C, D) and out (B, E, C, D) are read and written in
// place through their strides (the last dim contiguous); w_in / w_gate are
// (E, D, F) and w_out (E, F, D), each with its expert and row stride and a
// contiguous last dim.  Nothing is padded in memory: ragged rows, columns
// and reductions are masked here (the Pallas wrapper pads F to its block).
//
// Design.  The Pallas grid is (B, E, F / bf): it keeps the (C, D) output
// in VMEM and sums it over a sequential F axis, and it loads each expert's
// weights once per batch row.  On the card a (C, D) f32 accumulator at
// D = 5120 does not fit one block, and blocks run in parallel in no order.
// So one call is two launches of one tiled product:
//   (a) up:   H[e] = act(X[e] W_in[e], X[e] W_gate[e]), the activation
//             fused into the epilogue, into an (E, B*C, F) scratch;
//   (b) down: out[b, e] = H[e] W_out[e].
// X[e] gathers the B*C rows of expert e from every batch row through the
// strides, so each weight tile is read from memory once per call and
// shared by all rows of its expert.  One block owns one (expert, tile of
// 128 output columns); it walks the reduction dim in steps of 64, staging
// the row tile and the weight tiles in shared memory, and loops over row
// tiles of 64 when an expert has more rows than that.
//   * bfloat16 (the serving path): eight warps, each owning 16 output
//     columns for all 64 rows, run mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with fragments from ldmatrix; tiles are staged with
//     16-byte loads in a loop of constant trip count; row tiles of 16 that
//     hold no row are skipped.  H is rounded to bf16 before (b), as the
//     JAX ref path's bf16 hidden activation is.
//   * float32 (the tests' dtype): f32 FMAs, which keep results exact to the
//     order of sums (TF32 tensor cores would not); H stays f32.
//
// What bounds it on an H100.  Counting each input read once and each output
// written once: at llama4-scout (E 16, D 5120, F 8192, bf16) the weights are
// 3 E D F x 2 bytes = 4.03 GB per call, 1.20 ms at 3.35 TB/s, against
// 0.24 ms of tensor-core work at prefill (60 rows per expert) and 0.07 ms at
// decode (16 rows): bound by bytes.  What the design does about it: every
// weight byte crosses from memory once per call (never once per batch row),
// H (16 MB at prefill) is the only extra traffic, and the two products
// give 1024 and 640 blocks to spread the stream over the 132 SMs.  The
// tiles are loaded synchronously, without a pipeline; cp.async or TMA
// double buffering is the next step to the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { kNone = 0, kSwiglu = 1, kGelu = 2 };

// One grouped product: for each expert e, O[e] = epi(A[e] W0[e], A[e] W1[e])
// with A[e] (R, K), W (K, N), O[e] (R, N).  Row r of expert e lives at
// base + e * se + (r / C) * sb + (r % C) * sc, so a (B, E, C, *) tensor and
// an (E, B*C, *) one are addressed alike.
struct Gemm {
  const void* a;
  long long a_se, a_sb, a_sc;
  const void* w0;
  long long w0_se, w0_sk;
  const void* w1;                  // the gate for swiglu, else unused
  long long w1_se, w1_sk;
  void* o;
  long long o_se, o_sb, o_sc;
  int R, C, K, N;
};

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

constexpr int kThreads = 256;      // 8 warps
constexpr int kBM = 64;            // rows per row tile
constexpr int kBK = 64;            // reduction step

// ===================================================== bfloat16: mma.sync
namespace bf16 {

constexpr int kBN = 128;           // output columns per block: 16 per warp
constexpr int kPad = 8;            // bf16 of padding per shared row (16 B)
constexpr int kLDA = kBK + kPad;
constexpr int kLDW = kBN + kPad;

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
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

// Stage the (kBM, kBK) row tile at (m0, k0) of expert e.  16-byte loads:
// the wrapper admits only rows that start 16-byte aligned and K % 8 == 0.
// Constant trip counts, so that the loops unroll and a thread has all of
// its loads in flight at once.
__device__ __forceinline__ void stage_a(__nv_bfloat16* dst, const Gemm& p,
                                        int e, int m0, int k0) {
  constexpr int kChunks = kBK / 8;
  const auto* a = static_cast<const __nv_bfloat16*>(p.a);
#pragma unroll
  for (int it = 0; it < kBM * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = m0 + r, k = k0 + c * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.R && k < p.K)
      val = *reinterpret_cast<const uint4*>(
          a + row_off(row, p.C, p.a_se, p.a_sb, p.a_sc, e) + k);
    *reinterpret_cast<uint4*>(dst + r * kLDA + c * 8) = val;
  }
}

// Stage the (kBK, kBN) weight tile at (k0, n0) of expert e; N % 8 == 0.
__device__ __forceinline__ void stage_w(__nv_bfloat16* dst, const void* w,
                                        long long se, long long sk,
                                        const Gemm& p, int e, int k0,
                                        int n0) {
  constexpr int kChunks = kBN / 8;
  const auto* wb = static_cast<const __nv_bfloat16*>(w) + e * se;
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const int k = k0 + r, n = n0 + c * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k < p.K && n < p.N)
      val = *reinterpret_cast<const uint4*>(wb + k * sk + n);
    *reinterpret_cast<uint4*>(dst + r * kLDW + c * 8) = val;
  }
}

template <int ACT>
__device__ __forceinline__ void gemm_block(const Gemm& p) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  constexpr int kMT = kBM / 16;                  // row tiles of 16
  __shared__ __align__(16) __nv_bfloat16 as[kBM * kLDA];
  __shared__ __align__(16) __nv_bfloat16 ws[kMats][kBK * kLDW];

  const int n0 = blockIdx.x * kBN, e = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;       // mma fragment row / column
  const int wn = warp * 16;                      // this warp's columns
  auto* ob = static_cast<__nv_bfloat16*>(p.o);

  for (int m0 = 0; m0 < p.R; m0 += kBM) {
    float acc[kMats][kMT][2][4];
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          acc[m][t][n][0] = acc[m][t][n][1] = acc[m][t][n][2] =
              acc[m][t][n][3] = 0.f;

    for (int k0 = 0; k0 < p.K; k0 += kBK) {
      __syncthreads();     // the previous step's ldmatrix reads are done
      stage_a(as, p, e, m0, k0);
      stage_w(ws[0], p.w0, p.w0_se, p.w0_sk, p, e, k0, n0);
      if (kMats == 2) stage_w(ws[kMats - 1], p.w1, p.w1_se, p.w1_sk, p, e,
                              k0, n0);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        unsigned bw[kMats][4];
#pragma unroll
        for (int m = 0; m < kMats; ++m)
          ldsm_x4_trans(ws[m] + (ks * 16 + (lane & 15)) * kLDW + wn +
                            (lane >> 4) * 8,
                        bw[m]);
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          if (m0 + t * 16 >= p.R) break;         // block-uniform
          unsigned af[4];
          ldsm_x4(as + (t * 16 + (lane & 15)) * kLDA + ks * 16 +
                      (lane >> 4) * 8,
                  af);
#pragma unroll
          for (int m = 0; m < kMats; ++m) {
            mma(acc[m][t][0], af, bw[m][0], bw[m][1]);
            mma(acc[m][t][1], af, bw[m][2], bw[m][3]);
          }
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + t * 16 + g + h * 8;
          const int col = n0 + wn + n * 8 + tig * 2;   // even; N % 8 == 0
          if (row >= p.R || col >= p.N) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              ob + row_off(row, p.C, p.o_se, p.o_sb, p.o_sc, e) + col) =
              __floats2bfloat162_rn(
                  epilogue<ACT>(acc[0][t][n][2 * h],
                                acc[kMats - 1][t][n][2 * h]),
                  epilogue<ACT>(acc[0][t][n][2 * h + 1],
                                acc[kMats - 1][t][n][2 * h + 1]));
        }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads) moe_up_mma(const Gemm p) {
  gemm_block<ACT>(p);
}

__global__ void __launch_bounds__(kThreads) moe_down_mma(const Gemm p) {
  gemm_block<kNone>(p);
}

}  // namespace bf16

// ======================================================= float32: FMAs
namespace f32 {

constexpr int kBN = 64;            // output columns per block
constexpr int kBKf = 16;           // reduction step
constexpr int kRows = kBM / 16;    // rows per thread
constexpr int kCols = kBN / 16;    // columns per thread

template <int ACT>
__device__ __forceinline__ void gemm_block(const Gemm& p) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  __shared__ float as[kBM][kBKf + 1];
  __shared__ float ws[kMats][kBKf][kBN];

  const int n0 = blockIdx.x * kBN, e = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* a = static_cast<const float*>(p.a);
  const float* w[2] = {static_cast<const float*>(p.w0) + e * p.w0_se,
                       static_cast<const float*>(p.w1) + e * p.w1_se};
  const long long sk[2] = {p.w0_sk, p.w1_sk};
  float* ob = static_cast<float*>(p.o);

  for (int m0 = 0; m0 < p.R; m0 += kBM) {
    float acc[kMats][kRows][kCols];
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[m][i][c] = 0.f;

    for (int k0 = 0; k0 < p.K; k0 += kBKf) {
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kBM * kBKf / kThreads; ++it) {
        const int idx = it * kThreads + threadIdx.x;
        const int r = idx / kBKf, kk = idx % kBKf;
        const int row = m0 + r, k = k0 + kk;
        as[r][kk] = row < p.R && k < p.K
                        ? a[row_off(row, p.C, p.a_se, p.a_sb, p.a_sc, e) + k]
                        : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMats; ++m)
#pragma unroll
        for (int it = 0; it < kBKf * kBN / kThreads; ++it) {
          const int idx = it * kThreads + threadIdx.x;
          const int kk = idx / kBN, c = idx % kBN;
          const int k = k0 + kk, n = n0 + c;
          ws[m][kk][c] = k < p.K && n < p.N ? w[m][k * sk[m] + n] : 0.f;
        }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBKf; ++kk) {
        float av[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = as[ty * kRows + i][kk];
#pragma unroll
        for (int m = 0; m < kMats; ++m)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float wv = ws[m][kk][tx + 16 * c];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              acc[m][i][c] = fmaf(av[i], wv, acc[m][i][c]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = m0 + ty * kRows + i;
      if (row >= p.R) continue;
      float* orow = ob + row_off(row, p.C, p.o_se, p.o_sb, p.o_sc, e);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = n0 + tx + 16 * c;
        if (col < p.N)
          orow[col] = epilogue<ACT>(acc[0][i][c], acc[kMats - 1][i][c]);
      }
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads) moe_up_fma(const Gemm p) {
  gemm_block<ACT>(p);
}

__global__ void __launch_bounds__(kThreads) moe_down_fma(const Gemm p) {
  gemm_block<kNone>(p);
}

}  // namespace f32

dim3 grid_of(const Gemm& p, int bn, int E) {
  return dim3((p.N + bn - 1) / bn, E);
}

cudaError_t launch(const Gemm& up, const Gemm& down, int dtype, int act,
                   int E, cudaStream_t st) {
  if (dtype == 1) {
    const int bn = bf16::kBN;
    if (act == kSwiglu)
      bf16::moe_up_mma<kSwiglu><<<grid_of(up, bn, E), kThreads, 0, st>>>(up);
    else
      bf16::moe_up_mma<kGelu><<<grid_of(up, bn, E), kThreads, 0, st>>>(up);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bf16::moe_down_mma<<<grid_of(down, bn, E), kThreads, 0, st>>>(down);
    return cudaGetLastError();
  }
  const int bn = f32::kBN;
  if (act == kSwiglu)
    f32::moe_up_fma<kSwiglu><<<grid_of(up, bn, E), kThreads, 0, st>>>(up);
  else
    f32::moe_up_fma<kGelu><<<grid_of(up, bn, E), kThreads, 0, st>>>(up);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32::moe_down_fma<<<grid_of(down, bn, E), kThreads, 0, st>>>(down);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 1 = swiglu, 2 = gelu (w_gate is
// then not read).  Strides are in elements.  h is an (E, B*C, F) scratch of
// buf's dtype.  For bfloat16 every row must start 16-byte aligned and D, F
// must be multiples of 8 (checked by the wrapper).  Returns the CUDA error
// of the launches (0 on success); the kernels run asynchronously on
// `stream`.
extern "C" int moe_gmm_fwd(
    const void* buf, const void* w_in, const void* w_gate, const void* w_out,
    void* h, void* out, int dtype, int act, int B, int E, int C, int D,
    int F, long long buf_sb, long long buf_se, long long buf_sc,
    long long wi_se, long long wi_sk, long long wg_se, long long wg_sk,
    long long wo_se, long long wo_sk, long long out_sb, long long out_se,
    long long out_sc, void* stream) {
  if ((dtype != 0 && dtype != 1) || (act != kSwiglu && act != kGelu))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = B * C;
  const long long h_se = (long long)R * F, h_sb = (long long)C * F;
  const Gemm up{buf,  buf_se, buf_sb, buf_sc, w_in, wi_se, wi_sk,
                w_gate, wg_se, wg_sk, h, h_se, h_sb, F, R, C, D, F};
  const Gemm down{h,    h_se,   h_sb,   F,      w_out,  wo_se, wo_sk,
                  w_out, wo_se, wo_sk, out, out_se, out_sb, out_sc,
                  R,    C,      F,      D};
  return static_cast<int>(
      launch(up, down, dtype, act, E, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
