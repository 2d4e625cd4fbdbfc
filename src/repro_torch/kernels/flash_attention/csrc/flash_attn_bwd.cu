// Flash attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces no TPU kernel: the JAX package's Pallas kernel
// src/repro/kernels/flash_attention/kernel.py::_attn_kernel has no backward,
// and jax.grad of the reference differentiates plain XLA ops.  This is the
// backward of that kernel's function, softmax(q k^T * scale) v with GQA,
// causal masking at the diagonal offset T - S and an optional sliding
// window, as flash_attn_fwd.cu computes it.  Given q, k, v, the forward's
// output o, its row logsumexp lse (f32, (B, H, S), natural-log units of the
// scaled scores) and the output's cotangent do, it computes
//
//     D  = rowsum(do * o)                     (f32, one value per q row)
//     P  = exp(s * scale - lse),  s = q k^T   (0 where the mask drops a key)
//     dv = P^T do          dP = do v^T        dS = P * (dP - D)
//     dq = dS k * scale    dk = dS^T q * scale
//
// with dk and dv summed over the H / K query heads of each kv head, exactly
// as the plain version (ref.py::attention_backward_reference) does.
//
// Layout.  q, o, do are (B, S, H, hd) and k, v are (B, T, K, hd), read in
// place through their strides (the last dim must be contiguous); dq, dk, dv
// are written contiguous in the inputs' dtype.  The wrapper allocates D as
// an f32 (B, H, S) scratch.
//
// Design: three launches, deterministic, no atomics.
//   (a) bwd_delta: D, one warp per (b, s, h) row.
//   (b) bwd_dkdv: one block per (kv tile, kv head, batch) keeps its K and V
//       tile in shared memory and walks, for each query head of its group,
//       the q tiles that the causal / window band lets see the tile.  For
//       each it recomputes S^T = K Q^T and dP^T = V dO^T, forms P^T and
//       dS^T from lse and D, and accumulates dV += P^T dO and dK += dS^T Q
//       in f32 registers.  Every kv row's sums are taken in one block in a
//       fixed order, so no two blocks write the same row.
//   (c) bwd_dq: one block per (q tile, head, batch), heaviest causal tiles
//       first, walks the kv tiles of its band, recomputes S and dP, and
//       accumulates dQ += dS K in f32 registers.
//   Tiles wholly outside the band are never loaded, as in the forward.
//   bfloat16 products run on mma.sync m16n8k16 with f32 accumulation (the
//   fragment helpers of the forward's mma body); P and dS are rounded to
//   bf16 as the A operand of the second products, as the forward rounds P.
//   Each warp owns 16 rows of its block's tile: kv rows in (b), q rows in
//   (c), so the per-row sums of a fragment stay inside four lanes.  float32
//   (the tests' dtype) runs on f32 FMAs, exact to the order of sums.
//
// What bounds it on an H100.  At the training shape of deepseek-7b, (B, S,
// H, hd) = (2, 2048, 32, 128) bf16 causal, the five products over the
// causal half are 171.8 GFLOP: 0.174 ms at 989 TFLOP/s.  Reading q, k, v,
// o, do and lse once and writing dq, dk, dv once is 269 MB: 0.080 ms at
// 3.35 TB/s.  So it is bound by operations.  What this design does about
// it: the band skip does only the work the mask leaves, and every product
// runs on the tensor cores.  What it leaves for later: S and dP are
// computed twice (once in (b), once in (c)), and mma.sync with operands
// staged synchronously through shared memory runs well below the wgmma
// rate; a wgmma body fed by TMA is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, as in the JAX kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, S)
  float* delta;       // (B, H, S), written by bwd_delta
  void* dq;           // (B, S, H, hd) contiguous
  void* dk;           // (B, T, K, hd) contiguous
  void* dv;
  int B, S, T, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool kept(const Params& p, int q_pos, int k_pos) {
  const int diag = p.T - p.S;
  bool ok = k_pos < p.T && q_pos < p.S;
  if (p.causal) ok = ok && k_pos <= q_pos + diag;
  if (p.window > 0) ok = ok && k_pos > q_pos + diag - p.window;
  return ok;
}

// kv tiles of BK rows in the band of the q tile of BQ rows at q0: [*lo, *hi)
template <int BQ, int BK>
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

// q tiles of BQ rows that see some key of the kv tile of BK rows at k0:
// [*lo, *hi)
template <int BQ, int BK>
__device__ __forceinline__ void q_band(const Params& p, int k0, int* lo,
                                       int* hi) {
  const int diag = p.T - p.S;
  int q_lo = 0, q_hi = p.S;
  // causal: some k >= k0 with k <= q + diag, so q >= k0 - diag
  if (p.causal) q_lo = max(0, k0 - diag);
  // window: some k <= k_last with k > q + diag - window
  if (p.window > 0) {
    const int k_last = min(k0 + BK, p.T) - 1;
    q_hi = min(p.S, k_last + p.window - diag);
  }
  *lo = q_lo / BQ;
  *hi = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : *lo;
}

template <int kWidth>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ===================================================== (a) D = rowsum(do*o)
constexpr int kDeltaRows = 8;   // one warp per row, 8 rows per block

template <typename Tin>
__global__ void __launch_bounds__(kDeltaRows * 32)
    flash_attn_bwd_delta(const Params p, int hd) {
  const long long row =
      (long long)blockIdx.x * kDeltaRows + threadIdx.x / 32;   // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.S * p.H) return;   // whole warps
  const int h = (int)(row % p.H);
  const long long bs = row / p.H;
  const int s = (int)(bs % p.S), b = (int)(bs / p.S);
  const Tin* o = static_cast<const Tin*>(p.o) + b * p.o_sb + s * p.o_ss +
                 h * p.o_sh;
  const Tin* d = static_cast<const Tin*>(p.dout) + b * p.do_sb +
                 s * p.do_ss + h * p.do_sh;
  float acc = 0.f;
  for (int i = lane; i < hd; i += 32) acc += to_f32(o[i]) * to_f32(d[i]);
  acc = group_sum<32>(acc);
  if (lane == 0) p.delta[((long long)b * p.H + h) * p.S + s] = acc;
}

// ===================================================== bfloat16: mma.sync
namespace bf16 {

using bf16_t = __nv_bfloat16;
constexpr int kThreads = 128;      // 4 warps x 16 rows
constexpr int kPad = 8;            // bf16 of padding per shared row (16 B)
constexpr int kRows = 64;          // rows a block owns: kv in (b), q in (c)
constexpr int kTile = 32;          // rows of the tiles it walks

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

// A fragment (16 x 16, row-major) of rows r0.., columns c0.. of a shared
// tile with row stride LD
template <int LD>
__device__ __forceinline__ void frag_a(const bf16_t* tile, int r0, int c0,
                                       unsigned (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8, r);
}

// B fragments of two 8-column tiles, n = rows n0.. of the shared tile
// (B^T row-major), k = columns k0..: r[0], r[1] for n0..n0+7, r[2], r[3]
// for n0+8..n0+15
template <int LD>
__device__ __forceinline__ void frag_bt(const bf16_t* tile, int n0, int k0,
                                        unsigned (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
              ((lane >> 3) & 1) * 8,
          r);
}

// B fragments of two 8-column tiles, k = rows k0.. of the shared tile (B
// row-major), n = columns n0..: as frag_bt
template <int LD>
__device__ __forceinline__ void frag_b(const bf16_t* tile, int k0, int n0,
                                       unsigned (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(tile + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8, r);
}

// Stage rows [row0, row0 + ROWS) of one head into shared memory, row stride
// HD + kPad; rows at or past `limit` are zero.  16 bytes a load: the
// wrapper admits only 16-byte aligned rows.
template <int HD, int ROWS>
__device__ __forceinline__ void stage(bf16_t* dst, const bf16_t* src,
                                      long long row_stride, int row0,
                                      int limit) {
  constexpr int LD = HD + kPad;
  constexpr int kChunks = HD / 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    if (kTotal % kThreads == 0 || idx < kTotal) {
      const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < limit)
        val = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
      *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
    }
  }
}

// (b): 64 kv rows of one kv head; q tiles of 32 rows of each query head of
// the group.  Each warp: 16 kv rows x 32 q columns of S^T and dP^T.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkdv_mma(const Params p) {
  constexpr int LD = HD + kPad;
  constexpr int kKS = HD / 16;        // k-steps over hd
  constexpr int kNQ = kTile / 8;      // 8-column tiles of the q tile
  constexpr int kON = HD / 8;         // 8-column tiles of dk, dv
  static_assert(HD % 16 == 0, "k-steps and tile pairs of 16 columns");
  extern __shared__ uint4 smem_bf16[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(smem_bf16);
  bf16_t* vs = ks + kRows * LD;
  bf16_t* qs = vs + kRows * LD;
  bf16_t* dos = qs + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * LD);
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kRows;   // tile 0 sees the most q rows
  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int krow0 = k0 + warp * 16 + g;   // this thread's kv rows: +0, +8

  stage<HD, kRows>(ks,
                   static_cast<const bf16_t*>(p.k) + b * p.k_sb + kh * p.k_sh,
                   p.k_ss, k0, p.T);
  stage<HD, kRows>(vs,
                   static_cast<const bf16_t*>(p.v) + b * p.v_sb + kh * p.v_sh,
                   p.v_ss, k0, p.T);
  int t_lo, t_hi;
  q_band<kTile, kRows>(p, k0, &t_lo, &t_hi);

  float dk[kON][4], dv[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int hq = kh * group; hq < (kh + 1) * group; ++hq) {
    const bf16_t* qb =
        static_cast<const bf16_t*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const bf16_t* dob =
        static_cast<const bf16_t*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    const float* lse_b = p.lse + ((long long)b * p.H + hq) * p.S;
    const float* dl_b = p.delta + ((long long)b * p.H + hq) * p.S;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();   // the previous q tile's reads are done
      stage<HD, kTile>(qs, qb, p.q_ss, q0, p.S);
      stage<HD, kTile>(dos, dob, p.do_ss, q0, p.S);
      if (threadIdx.x < kTile) {
        const int q_pos = q0 + threadIdx.x;
        lse_s[threadIdx.x] = q_pos < p.S ? lse_b[q_pos] : 0.f;
        dl_s[threadIdx.x] = q_pos < p.S ? dl_b[q_pos] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns a warp
      float st[kNQ][4], dpt[kNQ][4];
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        unsigned kf[4], vf[4];
        frag_a<LD>(ks, warp * 16, s * 16, kf);
        frag_a<LD>(vs, warp * 16, s * 16, vf);
#pragma unroll
        for (int np = 0; np < kNQ / 2; ++np) {
          unsigned qf[4], df[4];
          frag_bt<LD>(qs, np * 16, s * 16, qf);
          frag_bt<LD>(dos, np * 16, s * 16, df);
          mma(st[2 * np], kf, qf[0], qf[1]);
          mma(st[2 * np + 1], kf, qf[2], qf[3]);
          mma(dpt[2 * np], vf, df[0], df[1]);
          mma(dpt[2 * np + 1], vf, df[2], df[3]);
        }
      }

      // P^T into st, dS^T into dpt; element e of tile n is kv row
      // krow0 + 8 (e / 2), q column n * 8 + 2 tig + e % 2
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + tig * 2 + (e & 1);
          const float pr = kept(p, q0 + qi, krow0 + (e >> 1) * 8)
                               ? expf(st[n][e] * p.scale - lse_s[qi])
                               : 0.f;
          st[n][e] = pr;
          dpt[n][e] = pr * (dpt[n][e] - dl_s[qi]);
        }

      // dV += P^T dO and dK += dS^T Q, k-steps of 16 q rows
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const unsigned pf[4] = {pack(st[2 * kk][0], st[2 * kk][1]),
                                pack(st[2 * kk][2], st[2 * kk][3]),
                                pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const unsigned sf[4] = {pack(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < kON / 2; ++np) {
          unsigned df[4], qf[4];
          frag_b<LD>(dos, kk * 16, np * 16, df);
          frag_b<LD>(qs, kk * 16, np * 16, qf);
          mma(dv[2 * np], pf, df[0], df[1]);
          mma(dv[2 * np + 1], pf, df[2], df[3]);
          mma(dk[2 * np], sf, qf[0], qf[1]);
          mma(dk[2 * np + 1], sf, qf[2], qf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k_pos = krow0 + r * 8;
    if (k_pos >= p.T) continue;
    const long long off = (((long long)b * p.T + k_pos) * p.KH + kh) * HD;
    bf16_t* dkr = static_cast<bf16_t*>(p.dk) + off;
    bf16_t* dvr = static_cast<bf16_t*>(p.dv) + off;
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + n * 8 + tig * 2) =
          __floats2bfloat162_rn(dk[n][2 * r] * p.scale,
                                dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + n * 8 + tig * 2) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// (c): 64 q rows of one head; kv tiles of 32 rows.  Each warp: 16 q rows x
// 32 kv columns of S and dP; Q and dO stay in registers as A fragments.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_mma(const Params p) {
  constexpr int LD = HD + kPad;
  constexpr int kKS = HD / 16;
  constexpr int kNK = kTile / 8;      // 8-column tiles of the kv tile
  constexpr int kON = HD / 8;
  extern __shared__ uint4 smem_bf16[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_bf16);
  bf16_t* dos = qs + kRows * LD;
  bf16_t* ks = dos + kRows * LD;
  bf16_t* vs = ks + kTile * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + warp * 16 + g;         // this thread's rows: +0, +8

  const bf16_t* kb =
      static_cast<const bf16_t*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16_t* vb =
      static_cast<const bf16_t*>(p.v) + b * p.v_sb + kh * p.v_sh;
  stage<HD, kRows>(qs,
                   static_cast<const bf16_t*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q0, p.S);
  stage<HD, kRows>(dos,
                   static_cast<const bf16_t*>(p.dout) + b * p.do_sb +
                       h * p.do_sh,
                   p.do_ss, q0, p.S);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + r * 8;
    const long long i = ((long long)b * p.H + h) * p.S + q_pos;
    lse_r[r] = q_pos < p.S ? p.lse[i] : 0.f;
    dl_r[r] = q_pos < p.S ? p.delta[i] : 0.f;
  }
  __syncthreads();
  unsigned qf[kKS][4], df[kKS][4];
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    frag_a<LD>(qs, warp * 16, s * 16, qf[s]);
    frag_a<LD>(dos, warp * 16, s * 16, df[s]);
  }

  int j_lo, j_hi;
  kv_band<kRows, kTile>(p, q0, &j_lo, &j_hi);
  float dq[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kTile;
    __syncthreads();   // the previous tile's reads are done
    stage<HD, kTile>(ks, kb, p.k_ss, k0, p.T);
    stage<HD, kTile>(vs, vb, p.v_ss, k0, p.T);
    __syncthreads();

    float s[kNK][4], dp[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kKS; ++st)
#pragma unroll
      for (int np = 0; np < kNK / 2; ++np) {
        unsigned kf[4], vf[4];
        frag_bt<LD>(ks, np * 16, st * 16, kf);
        frag_bt<LD>(vs, np * 16, st * 16, vf);
        mma(s[2 * np], qf[st], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[st], kf[2], kf[3]);
        mma(dp[2 * np], df[st], vf[0], vf[1]);
        mma(dp[2 * np + 1], df[st], vf[2], vf[3]);
      }

    // dS into s; element e of tile n is q row row0 + 8 (e / 2), kv column
    // k0 + n * 8 + 2 tig + e % 2
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr =
            kept(p, row0 + r * 8, k0 + n * 8 + tig * 2 + (e & 1))
                ? expf(s[n][e] * p.scale - lse_r[r])
                : 0.f;
        s[n][e] = pr * (dp[n][e] - dl_r[r]);
      }

    // dQ += dS K, k-steps of 16 kv rows
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const unsigned sf[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kON / 2; ++np) {
        unsigned kf[4];
        frag_b<LD>(ks, kk * 16, np * 16, kf);
        mma(dq[2 * np], sf, kf[0], kf[1]);
        mma(dq[2 * np + 1], sf, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + r * 8;
    if (q_pos >= p.S) continue;
    bf16_t* dqr = static_cast<bf16_t*>(p.dq) +
                  (((long long)b * p.S + q_pos) * p.H + h) * HD;
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqr + n * 8 + tig * 2) =
          __floats2bfloat162_rn(dq[n][2 * r] * p.scale,
                                dq[n][2 * r + 1] * p.scale);
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem_dkdv = sizeof(bf16_t) * (size_t)(2 * kRows + 2 * kTile) *
                               (HD + kPad) +
                           sizeof(float) * 2 * kTile;
  const size_t smem_dq =
      sizeof(bf16_t) * (size_t)(2 * kRows + 2 * kTile) * (HD + kPad);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkdv_mma<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_bwd_dq_mma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dq);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.T + kRows - 1) / kRows, p.KH, p.B);
  flash_attn_bwd_dkdv_mma<HD><<<grid_kv, kThreads, smem_dkdv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.S + kRows - 1) / kRows, p.H, p.B);
  flash_attn_bwd_dq_mma<HD><<<grid_q, kThreads, smem_dq, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ======================================================= float32: FMAs
namespace f32 {

constexpr int kThreads = 256;
constexpr int kRows = 32;          // rows a block owns
constexpr int kTile = 32;          // rows of the tiles it walks
constexpr int kPad = 4;            // floats of padding per shared row
constexpr int kLP = kTile + 1;     // row stride of the score tiles
// thread t: row t / 8 of the block's rows, columns t % 8 + 8 c
constexpr int kCols = kTile / 8;

// Stage rows [row0, row0 + ROWS) of one head, row stride HD + kPad; rows at
// or past `limit` are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long row_stride, int row0,
                                      int limit) {
  constexpr int LD = HD + kPad;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    dst[r * LD + d] = row < limit ? src[row * row_stride + d] : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// (b): 32 kv rows of one kv head; q tiles of 32 rows of each query head of
// the group
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkdv_fma(const Params p) {
  constexpr int LD = HD + kPad;
  constexpr int kOut = HD / 8;        // dk, dv columns per thread
  extern __shared__ float4 smem_f32[];
  float* ks = reinterpret_cast<float*>(smem_f32);
  float* vs = ks + kRows * LD;
  float* qs = vs + kRows * LD;
  float* dos = qs + kTile * LD;
  float* pt = dos + kTile * LD;       // P^T (kv rows x q columns)
  float* dst = pt + kRows * kLP;      // dS^T
  float* lse_s = dst + kRows * kLP;
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kRows;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KH;
  const int i = threadIdx.x / 8, c0 = threadIdx.x % 8;

  stage<HD, kRows>(ks,
                   static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh,
                   p.k_ss, k0, p.T);
  stage<HD, kRows>(vs,
                   static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh,
                   p.v_ss, k0, p.T);
  int t_lo, t_hi;
  q_band<kTile, kRows>(p, k0, &t_lo, &t_hi);

  float dk[kOut], dv[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) dk[c] = dv[c] = 0.f;

  for (int hq = kh * group; hq < (kh + 1) * group; ++hq) {
    const float* qb = static_cast<const float*>(p.q) + b * p.q_sb +
                      hq * p.q_sh;
    const float* dob = static_cast<const float*>(p.dout) + b * p.do_sb +
                       hq * p.do_sh;
    const float* lse_b = p.lse + ((long long)b * p.H + hq) * p.S;
    const float* dl_b = p.delta + ((long long)b * p.H + hq) * p.S;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();   // the previous q tile's reads are done
      stage<HD, kTile>(qs, qb, p.q_ss, q0, p.S);
      stage<HD, kTile>(dos, dob, p.do_ss, q0, p.S);
      if (threadIdx.x < kTile) {
        const int q_pos = q0 + threadIdx.x;
        lse_s[threadIdx.x] = q_pos < p.S ? lse_b[q_pos] : 0.f;
        dl_s[threadIdx.x] = q_pos < p.S ? dl_b[q_pos] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = c0 + 8 * c;
        const float s = dot<HD>(ks + i * LD, qs + j * LD);
        const float dp = dot<HD>(vs + i * LD, dos + j * LD);
        const float pr = kept(p, q0 + j, k0 + i)
                             ? expf(s * p.scale - lse_s[j]) : 0.f;
        pt[i * kLP + j] = pr;
        dst[i * kLP + j] = pr * (dp - dl_s[j]);
      }
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        const float pr = pt[i * kLP + j], ds = dst[i * kLP + j];
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          dv[c] = fmaf(pr, dos[j * LD + c0 + 8 * c], dv[c]);
          dk[c] = fmaf(ds, qs[j * LD + c0 + 8 * c], dk[c]);
        }
      }
    }
  }

  const int k_pos = k0 + i;
  if (k_pos < p.T) {
    const long long off = (((long long)b * p.T + k_pos) * p.KH + kh) * HD;
    float* dkr = static_cast<float*>(p.dk) + off;
    float* dvr = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dkr[c0 + 8 * c] = dk[c] * p.scale;
      dvr[c0 + 8 * c] = dv[c];
    }
  }
}

// (c): 32 q rows of one head; kv tiles of 32 rows
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_fma(const Params p) {
  constexpr int LD = HD + kPad;
  constexpr int kOut = HD / 8;
  extern __shared__ float4 smem_f32[];
  float* qs = reinterpret_cast<float*>(smem_f32);
  float* dos = qs + kRows * LD;
  float* ks = dos + kRows * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;       // dS (q rows x kv columns)

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * kRows;
  const int i = threadIdx.x / 8, c0 = threadIdx.x % 8;
  const int q_pos = q0 + i;

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  stage<HD, kRows>(qs,
                   static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q0, p.S);
  stage<HD, kRows>(dos,
                   static_cast<const float*>(p.dout) + b * p.do_sb +
                       h * p.do_sh,
                   p.do_ss, q0, p.S);
  const long long li = ((long long)b * p.H + h) * p.S + q_pos;
  const float lse = q_pos < p.S ? p.lse[li] : 0.f;
  const float dl = q_pos < p.S ? p.delta[li] : 0.f;

  int j_lo, j_hi;
  kv_band<kRows, kTile>(p, q0, &j_lo, &j_hi);
  float dq[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) dq[c] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kTile;
    __syncthreads();   // Q staged; the previous tile's reads are done
    stage<HD, kTile>(ks, kb, p.k_ss, k0, p.T);
    stage<HD, kTile>(vs, vb, p.v_ss, k0, p.T);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int jj = c0 + 8 * c;
      const float s = dot<HD>(qs + i * LD, ks + jj * LD);
      const float dp = dot<HD>(dos + i * LD, vs + jj * LD);
      const float pr = kept(p, q_pos, k0 + jj)
                           ? expf(s * p.scale - lse) : 0.f;
      dss[i * kLP + jj] = pr * (dp - dl);
    }
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float ds = dss[i * kLP + jj];
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        dq[c] = fmaf(ds, ks[jj * LD + c0 + 8 * c], dq[c]);
    }
  }

  if (q_pos < p.S) {
    float* dqr = static_cast<float*>(p.dq) +
                 (((long long)b * p.S + q_pos) * p.H + h) * HD;
#pragma unroll
    for (int c = 0; c < kOut; ++c) dqr[c0 + 8 * c] = dq[c] * p.scale;
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(2 * kRows + 2 * kTile) *
                                           (HD + kPad) +
                                       2 * kRows * kLP + 2 * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkdv_fma<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_bwd_dq_fma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.T + kRows - 1) / kRows, p.KH, p.B);
  flash_attn_bwd_dkdv_fma<HD><<<grid_kv, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.S + kRows - 1) / kRows, p.H, p.B);
  flash_attn_bwd_dq_fma<HD><<<grid_q, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

template <int HD>
cudaError_t launch_hd(const Params& p, int dtype, cudaStream_t st) {
  const long long rows = (long long)p.B * p.S * p.H;
  const unsigned blocks = (unsigned)((rows + kDeltaRows - 1) / kDeltaRows);
  if (dtype == 0)
    flash_attn_bwd_delta<float><<<blocks, kDeltaRows * 32, 0, st>>>(p, HD);
  else if (dtype == 1)
    flash_attn_bwd_delta<__nv_bfloat16>
        <<<blocks, kDeltaRows * 32, 0, st>>>(p, HD);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dtype == 0 ? f32::launch<HD>(p, st) : bf16::launch<HD>(p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements (the last dim
// of q, k, v, o and do is contiguous; for bfloat16 every row starts 16-byte
// aligned, checked by the wrapper).  lse and delta are f32 (B, H, S); dq, dk
// and dv are contiguous.  Returns the CUDA error of the launches (0 on
// success); the kernels run asynchronously on `stream`.
extern "C" int flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int T, int H, int KH, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, int causal,
    int window, float scale, void* stream) {
  const Params p{q,     k,     v,     o,     dout,  lse,   delta,  dq,
                 dk,    dv,    B,     S,     T,     H,     KH,     q_sb,
                 q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,   v_sh,
                 o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh, causal, window,
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_hd<16>(p, dtype, st); break;
    case 32: err = launch_hd<32>(p, dtype, st); break;
    case 64: err = launch_hd<64>(p, dtype, st); break;
    case 80: err = launch_hd<80>(p, dtype, st); break;
    case 128: err = launch_hd<128>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
