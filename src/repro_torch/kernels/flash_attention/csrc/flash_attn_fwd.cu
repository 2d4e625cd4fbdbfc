// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _attn_kernel, launched by flash_attention_pallas.  It computes the same
// function: softmax(q k^T * scale) v with an online softmax over kv tiles,
// GQA (query head h reads kv head h / (H / K)), causal masking with the
// diagonal offset T - S (a kv prefix), an optional sliding window, f32
// running max, denominator and accumulator, the denominator clamped at
// 1e-30, masked scores set to the finite -2^30, and the output in q's dtype.
//
// Layout.  q and o are (B, S, H, hd), k and v are (B, T, K, hd), read in
// place through their strides (the last dim must be contiguous); nothing is
// padded in memory.
//
// Design.  The TPU walks kv blocks as a sequential grid axis and keeps m, l,
// acc in VMEM scratch between grid steps; here blocks run in parallel in no
// order, so the kv walk is a loop inside the block and m, l, acc live in
// registers.  kv tiles wholly outside the causal / window band are never
// loaded.  Causal q tiles are issued heaviest first so the last wave is not
// a long tail.  The head dim picks one of three bodies at compile time:
//   * bfloat16, hd 64 and 128 (every served path but zamba2's): one block
//     per (q tile of 128 rows, head, batch) holds two consumer warpgroups of
//     64 q rows and one producer warp.  The producer loads Q once and each kv tile of 128
//     rows through TMA (rank-4 tensor maps over the tensors' own strides,
//     128-byte swizzle) into a 2-stage ring, each stage with a full and an
//     empty mbarrier, so the next tile's load overlaps this tile's products.
//     TMA's zero fill stands in for masked staging at the ragged S and T
//     edges.  S = Q K^T runs on wgmma m64n128k16 with both operands read
//     from shared memory through descriptors; the softmax stays in
//     registers, in log2 units (exp2 with log2(e) folded into the scale);
//     P is rounded to bf16 in registers, as the reference casts probs to v's
//     dtype, and is the register A operand of O += P V on wgmma, V read
//     from shared memory in its transposed (MN-major) form.  Only tiles that
//     cut the causal diagonal, the window's edge or T are masked; a
//     warpgroup skips the products of a tile whose every score it would
//     mask.  Tiles of 128 kv rows: two stages of K and V plus Q are 160 KB of
//     shared memory at hd 128 (one block an SM either way), and the score
//     tile (64 f32 a thread), the output (64) and P (32) fit the 168
//     registers ptxas gives a thread of this 288-thread block, unspilled.
//   * bfloat16, hd 16, 32 and 80: four warps of 16 q rows on mma.sync
//     m16n8k16, K and V staged synchronously in 64-row tiles, every score
//     masked.  hd 80 is zamba2's served width: 5 k-steps of 16, 10 output
//     tiles of 8, and 5 staging loads of 16 bytes a thread per 64-row tile.
//     It takes no wgmma body, whose 64-column panels of 128-byte swizzled
//     rows do not divide 80 (a TMA box of 160 bytes takes no 128-byte
//     swizzle); padding to 128 would copy q, k, v on every call and spend
//     37.5 % of the products on zero columns.
//   * float32 (the tests' dtype): f32 FMAs, which keep f32 results exact to
//     the order of sums (TF32 tensor cores would not); each thread keeps a
//     4 x 4 block of scores and a 4 x hd/16 block of the output.
//
// What bounds it on an H100.  Counting each input read once and the output
// written once: at deepseek-7b's served prefill, S <= 768 bf16 (32 heads,
// hd 128), the kernel must move at most 25.2 MB (7.5 us at 3.35 TB/s)
// against 4.8 GFLOP of the causal half (4.9 us at 989 TFLOP/s): bound by
// bytes.  At S = 2048 it moves 67 MB (20 us) and does 34 GFLOP (35 us):
// bound by operations.  At zamba2's longest served prefill, (1, 663, 32, 80)
// on the mma.sync body, it moves 13.6 MB (4.1 us) against 2.3 GFLOP (2.3
// us): bound by bytes.  What the design does about it: the band skip does
// only the work the mask leaves; each kv tile is read from memory once per
// q tile of 128 rows; TMA moves tiles without spending threads on
// addresses, and the ring keeps one tile in flight behind the products;
// both products run on wgmma, the only path to the tensor cores' full rate.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr int kBlockQ = 64;        // q rows per block (mma.sync and FMA)
constexpr int kBlockK = 64;        // kv rows per tile (mma.sync and FMA)
constexpr float kNegInf = -1073741824.0f;  // -2^30, as in the JAX kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // (B, H, S) row logsumexp, or null (serving)
  int S, T, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

// kv tiles of BK rows in the causal / window band of the q tile of BQ
// rows at q0: [*lo, *hi)
template <int BQ = kBlockQ, int BK = kBlockK>
__device__ __forceinline__ void kv_band(const Params& p, int q0, int* lo,
                                        int* hi) {
  const int diag = p.T - p.S;
  const int n_kv = (p.T + BK - 1) / BK;
  *lo = 0;
  *hi = n_kv;
  if (p.causal) {
    const int k_max = min(q0 + BQ, p.S) - 1 + diag;
    *hi = k_max < 0 ? 0 : min(n_kv, k_max / BK + 1);
  }
  if (p.window > 0) {
    const int k_min = q0 + diag - p.window + 1;
    *lo = k_min > 0 ? k_min / BK : 0;
  }
}

__device__ __forceinline__ bool kept(const Params& p, int q_pos, int k_pos) {
  const int diag = p.T - p.S;
  bool ok = k_pos < p.T && q_pos < p.S;
  if (p.causal) ok = ok && k_pos <= q_pos + diag;
  if (p.window > 0) ok = ok && k_pos > q_pos + diag - p.window;
  return ok;
}

// max / sum over the lanes that share bits above `width` (xor shuffles)
template <int kWidth>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int kWidth>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// =================================== bfloat16, hd 16 / 32 / 80: mma.sync
namespace bf16 {

constexpr int kThreads = 128;      // 4 warps x 16 q rows
constexpr int kPad = 8;            // bf16 of padding per shared row (16 B)

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

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Stage rows [row0, row0 + 64) of one head into shared memory, row stride
// HD + kPad; rows at or past `limit` are zero.  Loads 16 bytes (8 values)
// at a time: the wrapper admits only 16-byte aligned rows.  The trip count
// is a constant so the loop unrolls and all of a thread's loads are in
// flight at once: a bound tied to threadIdx.x does not unroll, and the
// kernel then takes twice as long at S = 2048 on an H100.
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src,
                                      long long row_stride, int row0,
                                      int limit) {
  constexpr int LD = HD + kPad;
  constexpr int kChunks = HD / 8;   // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit)
      val = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_mma(const Params p) {
  constexpr int LD = HD + kPad;
  constexpr int kKS = HD / 16;         // k-steps of q.k over hd
  constexpr int kNT = kBlockK / 8;     // 8-column score tiles per kv tile
  constexpr int kON = HD / 8;          // 8-column output tiles
  static_assert(HD % 16 == 0, "k-steps and output tile pairs of 16 columns");
  extern __shared__ uint4 smem_bf16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* ks = qs + kBlockQ * LD;
  __nv_bfloat16* vs = ks + kBlockK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;     // mma fragment row / column
  const int row0 = q0 + warp * 16 + g;         // this thread's rows: +0, +8

  const auto* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                   h * p.q_sh;
  const auto* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                   kh * p.k_sh;
  const auto* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                   kh * p.v_sh;
  auto* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  int j_lo, j_hi;
  kv_band(p, q0, &j_lo, &j_hi);

  stage<HD>(qs, qb, p.q_ss, q0, p.S);
  __syncthreads();
  unsigned qf[kKS][4];
#pragma unroll
  for (int s = 0; s < kKS; ++s)
    ldsm_x4(qs + (warp * 16 + (lane & 15)) * LD + s * 16 + (lane >> 4) * 8,
            qf[s]);

  float o[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();   // the previous tile's ldmatrix reads are done
    stage<HD>(ks, kb, p.k_ss, k0, p.T);
    stage<HD>(vs, vb, p.v_ss, k0, p.T);
    __syncthreads();

    // scores: s[n] is the 16 x 8 tile of columns k0 + 8n .. k0 + 8n + 7
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kKS; ++st)
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned kf[4];
        ldsm_x4(ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                    st * 16 + ((lane >> 3) & 1) * 8,
                kf);
        mma(s[2 * np], qf[st], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[st], kf[2], kf[3]);
      }

    // mask, online softmax update
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = row0 + (e >> 1) * 8;
        const int k_pos = k0 + n * 8 + tig * 2 + (e & 1);
        s[n][e] = kept(p, q_pos, k_pos) ? s[n][e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], group_max<4>(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + group_sum<4>(rs[r]);
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P V; two score tiles make the A fragment of one k-step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const unsigned pf[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kON / 2; ++np) {
        unsigned vf[4];
        ldsm_x4_trans(vs + (kk * 16 + (lane & 15)) * LD + np * 16 +
                          (lane >> 4) * 8,
                      vf);
        mma(o[2 * np], pf, vf[0], vf[1]);
        mma(o[2 * np + 1], pf, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + r * 8;
    if (q_pos >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && tig == 0)   // m is in natural-log units here
      p.lse[((long long)b * p.H + h) * p.S + q_pos] = m[r] + logf(denom);
    __nv_bfloat16* orow = ob + q_pos * p.o_ss;
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tig * 2) =
          __floats2bfloat162_rn(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(kBlockQ + 2 * kBlockK) * (HD + kPad);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_attn_fwd_mma<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ======================================================= float32: FMAs
namespace f32 {

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kRows = 4;           // q rows per thread (kBlockQ / 16)
constexpr int kCols = 4;           // score columns per thread (kBlockK / 16)
constexpr int kPad = 4;            // floats of padding per shared row

// Stage rows [row0, row0 + 64) of one head into shared memory, row stride
// HD + kPad; rows at or past `limit` are zero.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long row_stride, int row0,
                                      int limit) {
  constexpr int LD = HD + kPad;
  constexpr int kIters = kBlockK * HD / kThreads;
  // unrolled by 8, not fully: a full unroll at hd 128 spills registers
#pragma unroll 8
  for (int it = 0; it < kIters; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / HD, d = idx % HD;
    const int row = row0 + r;
    dst[r * LD + d] = row < limit ? src[row * row_stride + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attn_fwd_fma(const Params p) {
  constexpr int LD = HD + kPad;         // Q / KV shared row stride
  constexpr int LDP = kBlockK + kPad;   // P shared row stride
  constexpr int kOut = HD / 16;         // output columns per thread
  extern __shared__ float4 smem_f32[];  // float4: 16-byte aligned rows
  float* qs = reinterpret_cast<float*>(smem_f32);
  float* kvs = qs + kBlockQ * LD;
  float* ps = kvs + kBlockK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * kBlockQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  int j_lo, j_hi;
  kv_band(p, q0, &j_lo, &j_hi);

  stage<HD>(qs, qb, p.q_ss, q0, p.S);

  float acc[kRows][kOut];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();   // Q staged; the previous tile's V reads are done
    stage<HD>(kvs, kb, p.k_ss, k0, p.T);
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16*c
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[kRows], kk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(ty * kRows + i) * LD + d]);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kk[c] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[i][c] = fmaf(a[i].x, kk[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, kk[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, kk[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, kk[c].w, s[i][c]);
        }
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int k_pos = k0 + tx + 16 * c;
        s[i][c] = kept(p, q_pos, k_pos) ? s[i][c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max<16>(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
        ps[(ty * kRows + i) * LDP + tx + 16 * c] = s[i][c];
      }
      l[i] = l[i] * alpha + group_sum<16>(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // K reads done, P visible
    stage<HD>(kvs, vb, p.v_ss, k0, p.T);
    __syncthreads();

    // acc += P V: rows ty*4 + i, columns tx + 16*c
#pragma unroll 2
    for (int t = 0; t < kBlockK; t += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&ps[(ty * kRows + i) * LDP + t]);
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float* vcol = &kvs[t * LD + tx + 16 * c];
        const float v0 = vcol[0], v1 = vcol[LD], v2 = vcol[2 * LD],
                    v3 = vcol[3 * LD];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][c] = fmaf(pr[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pr[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pr[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pr[i].w, v3, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q_pos = q0 + ty * kRows + i;
    if (q_pos >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0)    // m is in natural-log units here
      p.lse[((long long)b * p.H + h) * p.S + q_pos] = m[i] + logf(denom);
    float* orow = ob + q_pos * p.o_ss;
#pragma unroll
    for (int c = 0; c < kOut; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(
      (kBlockQ + kBlockK) * (HD + kPad) + kBlockQ * (kBlockK + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_fma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_attn_fwd_fma<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// ======================================== bfloat16, hd 64 / 128: wgmma + TMA
namespace wg {

using namespace sm90;   // mbarriers, TMA, wgmma (sm90.cuh)

constexpr int kBlockQ = 128;       // q rows per block: 2 warpgroups x 64
constexpr int kBlockKV = 128;      // kv rows per tile
constexpr int kStages = 2;         // K / V ring depth
constexpr int kConsumers = 2;      // warpgroups that run the products
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Every tile is kept as hd / 64 panels of (rows, 64) bf16, each row 128
// bytes, in the layout TMA's 128-byte swizzle writes and wgmma reads.
template <int HD>
struct alignas(1024) Smem {
  static constexpr int kPanels = HD / kPanel;
  __nv_bfloat16 q[kPanels][kBlockQ * kPanel];
  __nv_bfloat16 k[kStages][kPanels][kBlockKV * kPanel];
  __nv_bfloat16 v[kStages][kPanels][kBlockKV * kPanel];
  uint64_t q_full, full[kStages], empty[kStages];
};

// What a kv tile at k0 asks of the 64 q rows from r0: 0 nothing (every
// score of every real row is masked), 1 the products without a mask (the
// tile lies wholly inside the band and inside T), 2 the products and the
// mask (the diagonal, the window's edge, the ragged last tile).
__device__ __forceinline__ int tile_mode(const Params& p, int r0, int k0) {
  if (r0 >= p.S) return 0;
  const int diag = p.T - p.S;
  const int r1 = min(r0 + 63, p.S - 1);
  bool mask = k0 + kBlockKV > p.T;
  if (p.causal) {
    if (k0 > r1 + diag) return 0;
    mask = mask || k0 + kBlockKV - 1 > r0 + diag;
  }
  if (p.window > 0) {
    if (k0 + kBlockKV - 1 <= r0 + diag - p.window) return 0;
    mask = mask || k0 <= r1 + diag - p.window;
  }
  return mask ? 2 : 1;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const Params p) {
  constexpr int kPanels = HD / kPanel;
  constexpr int kTileBytes = kBlockKV * kPanel * 2;     // one panel
  extern __shared__ uint8_t smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * kBlockQ;
  int j_lo, j_hi;
  kv_band<kBlockQ, kBlockKV>(p, q0, &j_lo, &j_hi);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // ------------------------------------------------------ producer warp
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(&sm.q_full, kPanels * kBlockQ * kPanel * 2);
#pragma unroll
    for (int c = 0; c < kPanels; ++c)
      tma_load(sm.q[c], &tq, &sm.q_full, c * kPanel, h, q0, b);
    for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(&sm.full[s], 2 * kPanels * kTileBytes);
#pragma unroll
      for (int c = 0; c < kPanels; ++c) {
        tma_load(sm.k[s][c], &tk, &sm.full[s], c * kPanel, kh, j * kBlockKV,
                 b);
        tma_load(sm.v[s][c], &tv, &sm.full[s], c * kPanel, kh, j * kBlockKV,
                 b);
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + wgi * 64;                 // this warpgroup's rows
  const int row0 = r0 + warp * 16 + g;          // this thread's: +0, +8
  const float scale = p.scale * kLog2e;         // scores in log2 units

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(&sm.q_full, 0);
  for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
    const int s = it % kStages;
    const int k0 = j * kBlockKV;
    const int mode = tile_mode(p, r0, k0);      // warpgroup-uniform
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    if (mode != 0) {
      // S = Q K^T: hd / 16 steps of k16, both operands from shared memory
      float sc[kBlockKV / 2];
#pragma unroll
      for (int i = 0; i < kBlockKV / 2; ++i) sc[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 16;
        wgmma_ss_n128(sc, desc(sm.q[c] + wgi * 64 * kPanel + off, 16, 1024),
                      desc(sm.k[s][c] + off, 16, 1024));
      }
      wg_commit();
      wg_wait();
      pin(sc);

      // mask where the tile needs it, then the online softmax update; the
      // accumulator layout: sc[4i + e] is row row0 + 8 (e / 2), column
      // k0 + 8i + 2 tig + e % 2
#pragma unroll
      for (int i = 0; i < kBlockKV / 2; ++i) sc[i] *= scale;
      if (mode == 2) {
        // each row keeps the keys [lo, hi] (kept() row by row)
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q_pos = row0 + r * 8;
          hi[r] = q_pos >= p.S ? -1 : p.T - 1;
          if (p.causal) hi[r] = min(hi[r], q_pos + p.T - p.S);
          lo[r] = p.window > 0 ? q_pos + p.T - p.S - p.window + 1 : 0;
        }
#pragma unroll
        for (int i = 0; i < kBlockKV / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int k_pos = k0 + (i / 4) * 8 + tig * 2 + (i & 1);
          if (k_pos > hi[r] || k_pos < lo[r]) sc[i] = kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBlockKV / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], group_max<4>(mx[r]));
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kBlockKV / 2; ++i) {
        sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + group_sum<4>(rs[r]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: P rounded to bf16 in registers (the A operand: two score
      // tiles of 8 columns make one k16 step), V from shared memory
      unsigned pa[kBlockKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockKV / 16; ++kk) {
        pa[kk][0] = pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      pin(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockKV / 16; ++kk) {
        // rows 16 kk .. 16 kk + 15 of every panel; panels kTileBytes apart
        const uint64_t dv = desc(sm.v[s][0] + kk * 16 * kPanel, kTileBytes,
                                 1024);
        if constexpr (HD == 128)
          wgmma_rs_n128(o, pa[kk], dv);
        else
          wgmma_rs_n64(o, pa[kk], dv);
      }
      wg_commit();
      wg_wait();
      pin(o);
      pin(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);   // this warp is done with s
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + r * 8;
    if (q_pos >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && tig == 0)   // m is in log2 units: back to ln
      p.lse[((long long)b * p.H + h) * p.S + q_pos] =
          (m[r] + log2f(denom)) * kLn2;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                          h * p.o_sh + q_pos * p.o_ss;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tig * 2) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] / denom,
                                o[4 * n + 2 * r + 1] / denom);
  }
}


template <int HD>
cudaError_t launch(const Params& p, int B, int hd, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, p.q, hd, p.H, p.S, B, p.q_sh, p.q_ss,
                             p.q_sb, kBlockQ);
  if (err == cudaSuccess)
    err = make_map(&tk, p.k, hd, p.KH, p.T, B, p.k_sh, p.k_ss, p.k_sb,
                   kBlockKV);
  if (err == cudaSuccess)
    err = make_map(&tv, p.v, hd, p.KH, p.T, B, p.v_sh, p.v_ss, p.v_sb,
                   kBlockKV);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(Smem<HD>) + 1024;   // + room to align to 1 KB
  err = cudaFuncSetAttribute(flash_attn_fwd_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_attn_fwd_wgmma<HD><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace wg

// The body is chosen by dtype and, at compile time, by hd (see the top).
template <int HD>
cudaError_t launch_hd(const Params& p, int dtype, int B, cudaStream_t st) {
  if (dtype == 0) return f32::launch<HD>(p, B, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (HD % wg::kPanel == 0)   // whole 64-column panels
    return wg::launch<HD>(p, B, HD, st);
  else
    return bf16::launch<HD>(p, B, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `lse`, when not null, receives each
// row's logsumexp of the scaled, masked scores (f32 (B, H, S), natural log),
// which the backward (flash_attn_bwd.cu) reads.  Strides are in elements; for bfloat16
// every row of q, k, v must start 16-byte aligned, and at hd 64 and 128
// every stride must be one TMA takes (both checked by the wrapper).
// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B,
    int S, int T, int H, int KH, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    void* stream) {
  const Params p{q,    k,    v,    o,    lse,  S,      T,      H,
                 KH,   q_sb, q_ss, q_sh, k_sb, k_ss,   k_sh,   v_sb,
                 v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_hd<16>(p, dtype, B, st); break;
    case 32: err = launch_hd<32>(p, dtype, B, st); break;
    case 64: err = launch_hd<64>(p, dtype, B, st); break;
    case 80: err = launch_hd<80>(p, dtype, B, st); break;
    case 128: err = launch_hd<128>(p, dtype, B, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
