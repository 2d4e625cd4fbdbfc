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
// padded in memory, the kernel masks the ragged edges itself.
//
// Design.  One thread block per (q tile of 64 rows, head, batch).  The TPU
// walks kv blocks as a sequential grid axis and keeps m, l, acc in VMEM
// scratch between grid steps; here blocks run in parallel in no order, so
// the kv walk is a loop inside the block and m, l, acc live in registers.
// Q is staged once in shared memory, each kv tile of 64 rows after it.  kv
// tiles wholly outside the causal / window band are never loaded.  Causal q
// tiles are issued heaviest first so the last wave is not a long tail.
// Two instantiations of that design:
//   * bfloat16 (the serving path): four warps, 16 q rows each, run both
//     products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); Q fragments stay in registers for the whole kv walk, K
//     and V fragments come from shared memory by ldmatrix, and the score
//     accumulators are repacked in registers as the A operand of P.V, so P
//     never touches shared memory.  P is rounded to bf16 for that product,
//     as the reference casts probs to v's dtype.
//   * float32 (the tests' dtype): f32 FMAs, which keep f32 results exact to
//     the order of sums (TF32 tensor cores would not); each thread keeps a
//     4 x 4 block of scores and a 4 x hd/16 block of the output.
//
// What bounds it on an H100.  Counting each input read once and the output
// written once: at deepseek-7b prefill, S = 512 bf16 (32 heads, hd 128), the
// kernel must move 16.8 MB (5.0 us at 3.35 TB/s) against 2.1 GFLOP of the
// causal half (2.2 us at 989 TFLOP/s): bound by bytes.  At S = 2048 it moves
// 67 MB (20 us) and does 34 GFLOP (35 us): bound by operations.  What the
// design does about it: the band skip does only the work the mask leaves;
// each kv tile is read from memory once per q tile of 64 rows, and the
// products run on the tensor cores.  mma.sync reaches only part of the
// 989 TFLOP/s that wgmma can; the tiles are loaded synchronously, without a
// pipeline.  wgmma with TMA-fed, double-buffered tiles is the next step to
// the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;        // q rows per block
constexpr int kBlockK = 64;        // kv rows per tile
constexpr float kNegInf = -1073741824.0f;  // -2^30, as in the JAX kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

// kv tiles in the causal / window band of the q tile at q0: [*lo, *hi)
__device__ __forceinline__ void kv_band(const Params& p, int q0, int* lo,
                                        int* hi) {
  const int diag = p.T - p.S;
  const int n_kv = (p.T + kBlockK - 1) / kBlockK;
  *lo = 0;
  *hi = n_kv;
  if (p.causal) {
    const int k_max = min(q0 + kBlockQ, p.S) - 1 + diag;
    *hi = k_max < 0 ? 0 : min(n_kv, k_max / kBlockK + 1);
  }
  if (p.window > 0) {
    const int k_min = q0 + diag - p.window + 1;
    *lo = k_min > 0 ? k_min / kBlockK : 0;
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

// ===================================================== bfloat16: mma.sync
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

template <int HD>
cudaError_t launch_hd(const Params& p, int dtype, int B, cudaStream_t st) {
  if (dtype == 0) return f32::launch<HD>(p, B, st);
  if (dtype == 1) return bf16::launch<HD>(p, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; for bfloat16
// every row of q, k, v must start 16-byte aligned (checked by the wrapper).
// Returns the CUDA error of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int KH, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    void* stream) {
  const Params p{q,    k,    v,    o,    S,    T,      H,      KH,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,
                 v_sh, o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_hd<16>(p, dtype, B, st); break;
    case 32: err = launch_hd<32>(p, dtype, B, st); break;
    case 64: err = launch_hd<64>(p, dtype, B, st); break;
    case 128: err = launch_hd<128>(p, dtype, B, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
