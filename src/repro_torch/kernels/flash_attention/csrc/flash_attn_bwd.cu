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
// are written contiguous in the inputs' dtype.  The wrapper allocates one
// f32 workspace (D, and for the wgmma body lse * log2 e, the dq sums and
// the counters; laid out in flash_attn_bwd below) and, for the wgmma body,
// the band schedule.
//
// Every body starts with bwd_delta: D (one warp per (b, s, h) row), and for
// the wgmma body lse * log2 e, both padded to whole 64-row tiles, and the
// counters zeroed, all in one launch.  Then the body, chosen by the wrapper:
//
//   * wgmma (bfloat16, hd 64 and 128; training's path).  One launch of a
//     persistent grid, one block per SM.  A block draws work items (a kv
//     tile of 128 rows, kv head, batch) from an atomic ticket in the
//     schedule's order: kv-tile-major, so the heaviest causal tiles come
//     first.  Its two warpgroups own 64 kv rows each.  Thread 0 loads the
//     item's K and V once through TMA, then, two steps ahead, for each query
//     head of the group the 64-row Q and dO tiles that the band lets see the
//     kv tile, with their lse and D rows, into a 2-stage ring with one full
//     mbarrier a stage; TMA zero-fills rows past S and T.  Per q tile (a
//     step) each warpgroup computes S^T = K Q^T and dP^T = V dO^T on wgmma
//     m64n64k16 (both operands from 128-byte swizzled shared memory),
//     P^T = exp2(S^T scale log2 e - lse log2 e) while dP^T is still in
//     flight, dS^T = P^T (dP^T - D) (masked only on tiles that cross the
//     causal or window edge or the end of S or T), then dV += P^T dO and
//     dK += dS^T Q with A from registers and B from shared memory,
//     MN-major.  dS^T goes to shared memory in bf16, and the two warpgroups
//     compute the q tile's dQ partial dS K (at hd 128 64 columns each; at hd
//     64 each over its own 64 kv rows, the halves then summed).  So each of
//     the five products is computed once.
//     dQ is summed in a fixed order, without races.  The partial goes to
//     shared memory; an add to q tile t waits (warp 0 spinning on an
//     acquire load) until t's counter equals the number of kv tiles below
//     its own that see t, then the copy engine writes (the first) or adds
//     the f32 partial into the dq sums (a TMA reduce-add), during the next
//     step's first products, and warp 0 increments the counter with release
//     semantics once that is done.  The last adder instead reads the sums
//     and writes dq * scale in bf16 itself.  Every item an item waits on
//     holds a lower ticket, so it was drawn by a block already running,
//     which never waits on a higher ticket: no deadlock, whatever the number
//     of resident blocks.  Every dq element is summed in ascending kv-tile
//     order and every dk / dv row in one block in a fixed order, so the
//     result is deterministic.
//     There is no producer warp: ptxas gives a wgmma kernel of 288 or 384
//     threads 168 registers a thread and setmaxnreg did not raise that; at
//     168 the consumers (dK and dV take 128 registers at hd 128) spilled and
//     ptxas serialized the products.  At 256 threads a thread may hold 255.
//   * mma.sync (bfloat16, hd 16, 32 and 80, and hd 128 when the caller asks
//     for it by name, to time it against the wgmma body).  Two launches:
//     bwd_dkdv, one block per (kv tile of 64, kv head, batch) walking the q
//     tiles of 32 rows of its band, and bwd_dq, one block per (q tile of 64,
//     head, batch), heaviest causal tiles first; each recomputes S and dP
//     (seven products for five), on mma.sync m16n8k16 from ldmatrix with
//     tiles staged synchronously.
//   * FMA (float32, the tests' dtype): the same two launches on f32 FMAs,
//     exact to the order of sums.
//
// What bounds it on an H100.  At the training shape of deepseek-7b, (B, S,
// H, hd) = (2, 2048, 32, 128) bf16 causal, the five products over the
// causal half are 171.8 GFLOP: 0.174 ms at 989 TFLOP/s.  Reading q, k, v,
// o, do and lse once and writing dq, dk, dv once is 269 MB: 0.080 ms at
// 3.35 TB/s.  So it is bound by operations.  What the wgmma body does about
// it: each product once and only over the band, every product on wgmma fed
// by TMA with the next tile's loads in flight, exp2 on pre-scaled operands,
// and a persistent grid that draws the heaviest items first.  What holds it
// back: the ordered dQ add moves an f32 partial of 64 x hd through L2 (a
// TMA reduce-add) every step; each warpgroup's step is a chain of
// products, waits and elementwise work with little overlap of its own; and
// the S and dP products read both operands from shared memory at N = 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "../../csrc/sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// A wait that lasts this many cycles (about 10 s) has hung: trap, so the
// launch fails instead of holding the card
constexpr long long kHangCycles = 20000000000LL;

// Body numbers shared with kernel.py
constexpr int kBodyFma = 0, kBodyMma = 1, kBodyWgmma = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, S)
  float* delta;       // (B, H, Sp), written by bwd_delta
  void* dq;           // (B, S, H, hd) contiguous
  void* dk;           // (B, T, K, hd) contiguous
  void* dv;
  float* lse2;        // (B, H, Sp) lse * log2 e (wgmma body), else null
  float* dq_acc;      // (B, H, S, hd) dq sums (wgmma body)
  int* counters;      // (B, H, ceil(S / 64)) adds done, then the ticket
  const int* sched;   // the band schedule (wgmma body)
  int B, S, T, H, KH, Sp, n_sms;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int causal, window;
  float scale;
  float scale_log2;   // scale * log2 e: scores in log2 units (wgmma body)
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

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device, not on every call
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ========================== (a) D = rowsum(do*o), lse * log2 e, counters
constexpr int kDeltaRows = 8;   // one warp per row, 8 rows per block

// Rows (b, s, h) with s < Sp: D, and lse * log2 e when lse2 is set, zero
// past S; threads below n_zero zero the counters.
template <typename Tin>
__global__ void __launch_bounds__(kDeltaRows * 32)
    flash_attn_bwd_delta(const Params p, int hd, long long n_zero) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < n_zero) p.counters[gid] = 0;
  const long long row = gid / 32;                  // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Sp * p.H) return;  // whole warps
  const int h = (int)(row % p.H);
  const long long bs = row / p.H;
  const int s = (int)(bs % p.Sp), b = (int)(bs / p.Sp);
  float acc = 0.f;
  if (s < p.S) {
    const Tin* o = static_cast<const Tin*>(p.o) + b * p.o_sb + s * p.o_ss +
                   h * p.o_sh;
    const Tin* d = static_cast<const Tin*>(p.dout) + b * p.do_sb +
                   s * p.do_ss + h * p.do_sh;
    for (int i = lane; i < hd; i += 32) acc += to_f32(o[i]) * to_f32(d[i]);
    acc = group_sum<32>(acc);
  }
  if (lane == 0) {
    const long long bh = (long long)b * p.H + h;
    p.delta[bh * p.Sp + s] = acc;
    if (p.lse2 != nullptr)
      p.lse2[bh * p.Sp + s] = s < p.S ? p.lse[bh * p.S + s] * kLog2e : 0.f;
  }
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
    const float* dl_b = p.delta + ((long long)b * p.H + hq) * p.Sp;
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
    const long long bh = (long long)b * p.H + h;
    lse_r[r] = q_pos < p.S ? p.lse[bh * p.S + q_pos] : 0.f;
    dl_r[r] = q_pos < p.S ? p.delta[bh * p.Sp + q_pos] : 0.f;
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
  cudaError_t err = allow_smem<flash_attn_bwd_dkdv_mma<HD>>(smem_dkdv);
  if (err == cudaSuccess) err = allow_smem<flash_attn_bwd_dq_mma<HD>>(smem_dq);
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
    const float* dl_b = p.delta + ((long long)b * p.H + hq) * p.Sp;
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
  const float dl =
      q_pos < p.S ? p.delta[((long long)b * p.H + h) * p.Sp + q_pos] : 0.f;

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
  cudaError_t err = allow_smem<flash_attn_bwd_dkdv_fma<HD>>(smem);
  if (err == cudaSuccess) err = allow_smem<flash_attn_bwd_dq_fma<HD>>(smem);
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

// ================================== bfloat16, hd 64 / 128: wgmma + TMA
namespace wg {

using namespace sm90;   // mbarriers, TMA, wgmma (sm90.cuh)

constexpr int kBlockKV = 128;      // kv rows per work item: 2 warpgroups x 64
constexpr int kBlockQ = 64;        // q rows per tile of the ring
constexpr int kStages = 2;         // Q / dO ring depth
constexpr int kThreads = 256;      // two warpgroups; thread 0 issues loads
// named barriers of the block's threads (0 is __syncthreads)
constexpr int kBarDs = 1, kBarWait = 2, kBarSum = 3, kBarDone = 4;

// x, which the compiler may not see through
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// mbar_wait, but a wait of kHangCycles traps
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// A warp spins until *ctr == want (acquire), trapping after kHangCycles.
// Lane 0's readings decide for the warp, so every branch is warp-uniform.
__device__ __forceinline__ void wait_count(const int* ctr, int want) {
  const long long t0 = clock64();
  while (true) {
    const int v = __shfl_sync(0xffffffffu, ld_acquire(ctr), 0);
    if (v == want) break;
    if (__shfl_sync(0xffffffffu, (int)(clock64() - t0 > kHangCycles), 0))
      __trap();
  }
}

template <int HD>
struct alignas(1024) Smem {
  static constexpr int kPanels = HD / kPanel;
  __nv_bfloat16 k[kPanels][kBlockKV * kPanel];
  __nv_bfloat16 v[kPanels][kBlockKV * kPanel];
  __nv_bfloat16 q[kStages][kPanels][kBlockQ * kPanel];
  __nv_bfloat16 dout[kStages][kPanels][kBlockQ * kPanel];
  // dS^T: 128 kv rows of 64 q columns (128 bytes), 128-byte swizzled
  __nv_bfloat16 ds[kBlockKV * kBlockQ];
  float lse[kStages][kBlockQ];     // the tile's lse * log2(e)
  float dl[kStages][kBlockQ];      // the tile's D
  // dQ partials, two steps' worth (one may still be read by the copy
  // engine), each as boxes of 64 rows x 32 f32 columns (128 bytes),
  // 128-byte swizzled: at hd 128 boxes m = columns 32m.., at hd 64 boxes
  // 0-1 the first group's partial and 2-3 the second's
  float dqp[2][4][kBlockQ * 32];
  uint64_t kv_full, full[kStages];
  int* published;                  // the copy engine's add not yet counted
  int pend[4];                     // the add warp 0 has yet to issue
  int item;                        // the block's item, -1 when none is left
};

// What the 64 q rows from c ask of the 64 kv rows from a: 0 nothing (every
// pair is masked), 1 the products without a mask, 2 the products and the
// mask (the diagonal, the window's edge, the ragged ends of S and T).
__device__ __forceinline__ int tile_mode(const Params& p, int a, int c) {
  if (a >= p.T || c >= p.S) return 0;
  const int diag = p.T - p.S;
  const int a1 = min(a + 63, p.T - 1), c1 = min(c + 63, p.S - 1);
  bool mask = a + 64 > p.T || c + 64 > p.S;
  if (p.causal) {
    if (a > c1 + diag) return 0;
    mask = mask || a1 > c + diag;
  }
  if (p.window > 0) {
    if (a1 <= c + diag - p.window) return 0;
    mask = mask || a <= c1 + diag - p.window;
  }
  return mask ? 2 : 1;
}

// The band schedule the wrapper computes from the shape (kernel.py::
// band_schedule): ticket order of the items, then per kv tile the q tiles
// it walks [q_lo, q_hi), then per q tile the first kv tile that adds to it
// and the number that do.  Read where used, so that no pointer to it takes
// registers through the steps.
__device__ __forceinline__ int n_items(const Params& p) {
  return (p.T + kBlockKV - 1) / kBlockKV * p.B * p.KH;
}
__device__ __forceinline__ const int* sched_q_lo(const Params& p) {
  return p.sched + n_items(p);
}
__device__ __forceinline__ const int* sched_first(const Params& p) {
  return sched_q_lo(p) + 2 * ((p.T + kBlockKV - 1) / kBlockKV);
}
__device__ __forceinline__ const int* sched_count(const Params& p) {
  return sched_first(p) + (p.S + kBlockQ - 1) / kBlockQ;
}

// One step of an item: query head hq (of the group), q tile t
struct Step {
  int hq, t;
};

// Thread 0: load the Q, dO, lse and D tiles of step `st` into ring stage s
template <int HD>
__device__ __forceinline__ void load_step(Smem<HD>& sm, const Params& p,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* tdo, int s,
                                          int b, Step st) {
  constexpr int kPanels = HD / kPanel;
  constexpr int kQBytes = kBlockQ * kPanel * 2;
  mbar_expect_tx(&sm.full[s], 2 * kPanels * kQBytes + 2 * kBlockQ * 4);
#pragma unroll
  for (int c = 0; c < kPanels; ++c) {
    tma_load(sm.q[s][c], tq, &sm.full[s], c * kPanel, st.hq, st.t * kBlockQ,
             b);
    tma_load(sm.dout[s][c], tdo, &sm.full[s], c * kPanel, st.hq,
             st.t * kBlockQ, b);
  }
  const long long row = ((long long)b * p.H + st.hq) * p.Sp + st.t * kBlockQ;
  bulk_load(sm.lse[s], p.lse2 + row, kBlockQ * 4, &sm.full[s]);
  bulk_load(sm.dl[s], p.delta + row, kBlockQ * 4, &sm.full[s]);
}

// where column cc (0..31) of row `row` of box `box` of buffer `buf` lies
template <int HD>
__device__ __forceinline__ float* dqp_at(Smem<HD>& sm, int buf, int box,
                                         int row, int cc) {
  return &sm.dqp[buf][box][row * 32 + (((cc >> 2) ^ (row & 7)) << 2) +
                           (cc & 3)];
}

// The dQ partials are added into the dq sums in ascending kv-tile order:
// an add to q tile t waits until t's counter equals its rank, the number of
// kv tiles below its item's that see t.  Warp 0 does the waiting and has
// the copy engine write (rank 0) or add the partial, during the next step's
// first products; it counts the add on the counter (release) once the copy
// engine is done, at its next add.  The last adder instead reads the sums,
// adds its partial and writes dq * scale in bf16 itself, with every thread.
// Warp 0's work branches only on warp-uniform values and issues from lane
// 0 by predicate: code that some lanes of a warp skip while the group's
// accumulators are live made ptxas serialize every wgmma of the kernel.
// What warp 0 still has to do lives in shared memory, not in registers,
// which the steps need for their products.

// Warp 0: wait for the copy engine's add (if any) to be done and written,
// then count it on its tile's counter
template <int HD>
__device__ __forceinline__ void publish(Smem<HD>& sm) {
  int* ctr = sm.published;
  if (ctr == nullptr) return;
  bulk_wait_all();
  fence_async_global();
  red_release_add(ctr, 1, threadIdx.x == 0);
  __syncwarp();
  if (threadIdx.x == 0) sm.published = nullptr;
  __syncwarp();
}

// Warp 0: the add of the pending partial (sm.pend: head, q tile, rank,
// buffer; none when the head is -1)
template <int HD>
__device__ __forceinline__ void issue_add(Smem<HD>& sm, const Params& p,
                                          const CUtensorMap* tacc, int b,
                                          int n_q) {
  publish(sm);
  const int hq = sm.pend[0];
  if (hq < 0) return;
  const int t = sm.pend[1], rank = sm.pend[2], buf = sm.pend[3];
  int* ctr = p.counters + ((long long)b * p.H + hq) * n_q + t;
  wait_count(ctr, rank);
  fence_async_global();
  const bool lane0 = threadIdx.x == 0;
#pragma unroll
  for (int m = 0; m < HD / 32; ++m) {
    tma_store_3d<0>(tacc, sm.dqp[buf][m], 32 * m, t * kBlockQ, b * p.H + hq,
                    lane0 && rank == 0);
    tma_store_3d<1>(tacc, sm.dqp[buf][m], 32 * m, t * kBlockQ, b * p.H + hq,
                    lane0 && rank != 0);
  }
  bulk_commit();
  __syncwarp();
  if (lane0) {
    sm.published = ctr;
    sm.pend[0] = -1;
  }
  __syncwarp();
}

// Every thread: the last add to q tile (b, hq, t), from buffer buf
template <int HD>
__device__ __forceinline__ void add_last(Smem<HD>& sm, const Params& p,
                                         int b, int n_q, int hq, int t,
                                         int rank, int buf) {
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0) {
    publish(sm);
    wait_count(p.counters + ((long long)b * p.H + hq) * n_q + t, rank);
  }
  bar_sync(kBarWait, kThreads);
  if (HD == 64 && __shfl_sync(0xffffffffu, wgi, 0) == 1) return;
  const int col0 = HD == 128 ? wgi * 64 : 0;
  const float* acc = p.dq_acc + ((long long)b * p.H + hq) * p.S * HD;
  __nv_bfloat16* dqo = static_cast<__nv_bfloat16*>(p.dq) +
                       (long long)b * p.S * p.H * HD + hq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const int q_pos = t * kBlockQ + row;
    if (q_pos >= p.S) continue;
    const float* arow = acc + (long long)q_pos * HD + col0;
    __nv_bfloat16* orow = dqo + (long long)q_pos * p.H * HD + col0;
    // every load of the row first, then every store: interleaved, each
    // load would wait for the store before it (they may alias)
    float2 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = *reinterpret_cast<const float2*>(
          dqp_at(sm, buf, (HD == 128 ? 2 * wgi : 0) + i / 4, row,
                 8 * (i % 4) + 2 * tig));
    if (rank > 0) {
      float2 old[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        old[i] = __ldcg(reinterpret_cast<const float2*>(arow + 8 * i +
                                                        2 * tig));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i].x += old[i].x;
        v[i].y += old[i].y;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * tig) =
          __floats2bfloat162_rn(v[i].x * p.scale, v[i].y * p.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bwd_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tacc,
                         const Params p) {
  constexpr int kPanels = HD / kPanel;
  constexpr int kQBytes = kBlockQ * kPanel * 2;       // one panel of Q / dO
  constexpr int kKVBytes = kBlockKV * kPanel * 2;     // one panel of K / V
  extern __shared__ uint8_t smem_raw[];
  // aligned to 1 KB by an offset from smem_raw, so that the compiler keeps
  // every access a 32-bit shared one
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int group = p.H / p.KH;
  const int n_q = (p.S + kBlockQ - 1) / kBlockQ;
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
  const int krow = warp * 16 + g;     // this thread's rows: krow + 8 r
  uint8_t* ds_bytes = reinterpret_cast<uint8_t*>(sm.ds);

  if (threadIdx.x == 0) {
    sm.published = nullptr;
    sm.pend[0] = -1;
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  int it = 0;                         // steps run by this block so far
  for (int round = 0;; ++round) {
    __syncthreads();                  // the last item's K, V, ring are free
    if (threadIdx.x == 0) {
      // tickets in the schedule's order: every item an item waits on holds
      // a lower ticket, so a block that is already running drew it
      const int ticket = atomicAdd(p.counters + opaque(p.B * p.H * n_q), 1);
      sm.item = ticket < n_items(p) ? p.sched[ticket] : -1;
    }
    __syncthreads();
    const int item = sm.item;
    if (item < 0) break;
    const int kh = item % p.KH, b = item / p.KH % p.B;
    const int n = item / (p.KH * p.B);
    const int* q_lo = sched_q_lo(p);
    const int t_lo = q_lo[n], n_t = q_lo[n + (p.T + kBlockKV - 1) / kBlockKV] -
                                    t_lo;
    const int n_steps = group * n_t;
    auto step = [&](int j) {
      return Step{kh * group + j / n_t, t_lo + j % n_t};
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kPanels * kBlockKV * kPanel * 2);
#pragma unroll
      for (int c = 0; c < kPanels; ++c) {
        tma_load(sm.k[c], &tk, &sm.kv_full, c * kPanel, kh, n * kBlockKV, b);
        tma_load(sm.v[c], &tv, &sm.kv_full, c * kPanel, kh, n * kBlockKV, b);
      }
      for (int j = 0; j < kStages && j < n_steps; ++j)
        load_step<HD>(sm, p, &tq, &tdo, (it + j) % kStages, b, step(j));
    }

    const int a0 = n * kBlockKV + wgi * 64;     // this warpgroup's kv rows

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    // this group's 64 rows of K and V, K-major
    const uint64_t d_k = desc(sm.k[0] + wgi * 64 * kPanel, 16, 1024);
    const uint64_t d_v = desc(sm.v[0] + wgi * 64 * kPanel, 16, 1024);
    wait_phase(&sm.kv_full, round & 1);
    for (int j = 0; j < n_steps; ++j, ++it) {
      const int s = it % kStages;
      const Step stp = step(j);
      const int q0 = stp.t * kBlockQ;
      const int mode = tile_mode(p, a0, q0);      // warpgroup-uniform
      wait_phase(&sm.full[s], (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, 64 kv rows x 64 q columns: both
      // operands K-major from shared memory, two groups of products
      // Descriptors step by adding 16-byte units to one base per operand:
      // a k16 step is 32 bytes into a swizzled row, a panel kKVBytes or
      // kQBytes on
      const uint64_t d_q = desc(sm.q[s][0], 16, 1024);
      const uint64_t d_do = desc(sm.dout[s][0], 16, 1024);
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int step_k = (kk / 4) * (kKVBytes >> 4) + (kk % 4) * 2;
        const int step_q = (kk / 4) * (kQBytes >> 4) + (kk % 4) * 2;
        wgmma_ss_n64<0, 0>(st, d_k + step_k, d_q + step_q);
      }
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int step_k = (kk / 4) * (kKVBytes >> 4) + (kk % 4) * 2;
        const int step_q = (kk / 4) * (kQBytes >> 4) + (kk % 4) * 2;
        wgmma_ss_n64<0, 0>(dpt, d_v + step_k, d_do + step_q);
      }
      wg_commit();
      // the last step's add runs while the tensor cores work
      const bool warp0 = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0;
      if (warp0) issue_add(sm, p, &tacc, b, n_q);
      // P^T = exp2(S^T scale log2 e - lse log2 e), masked where the tile
      // needs it; st[4i + e] is kv row a0 + krow + 8 (e / 2), q column
      // q0 + 8 i + 2 tig + e % 2
      wg_wait_pending<1>();
      pin(st);
      // the q positions each of this thread's two kv rows keeps, [lo, hi),
      // worked out here from an opaque row (hoisted, they would hold four
      // registers through every step)
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k_pos = a0 + opaque(krow) + 8 * r;
        lo[r] = p.causal ? k_pos - (p.T - p.S) : 0;
        hi[r] = p.S;
        if (p.window > 0) hi[r] = min(hi[r], k_pos - (p.T - p.S) + p.window);
        if (k_pos >= p.T || mode == 0) hi[r] = lo[r] = 0;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * tig;
        const float2 l = *reinterpret_cast<const float2*>(&sm.lse[s][col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr =
              ex2(st[4 * i + e] * p.scale_log2 - ((e & 1) ? l.y : l.x));
          const int q_pos = q0 + col + (e & 1);
          if (mode != 1 && (q_pos < lo[e >> 1] || q_pos >= hi[e >> 1]))
            pr = 0.f;
          st[4 * i + e] = pr;
        }
      }
      // dS^T = P^T (dP^T - D)
      wg_wait_pending<0>();
      pin(dpt);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 d =
            *reinterpret_cast<const float2*>(&sm.dl[s][8 * i + 2 * tig]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * i + e] =
              st[4 * i + e] * (dpt[4 * i + e] - ((e & 1) ? d.y : d.x));
      }
      // bf16 A operands of the k16 steps over q: two 8-column tiles each
      unsigned pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          sa[kk][e] = pack(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }
      // dS^T into shared memory for dQ: row krow + 8 r of this group's 64,
      // 16-byte chunk i of the row at chunk i ^ (row % 8)
      // (from an opaque copy of krow: otherwise the compiler keeps all 16
      // addresses of each store sequence in registers through the loop)
      const int krow_s = opaque(krow);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wgi * 64 + krow_s + 8 * r;
          *reinterpret_cast<unsigned*>(ds_bytes + row * 128 +
                                       ((i ^ (row & 7)) << 4) + 4 * tig) =
              sa[i / 2][(i & 1) * 2 + r];
        }
      fence_async_smem();

      // dV += P^T dO and dK += dS^T Q: A from registers, B (dO, Q) from
      // shared memory, MN-major; panels kQBytes apart
      pin(dv);
      pin(dk);
      wg_fence();
      // 16 rows (2048 bytes) a k16 step; panels kQBytes apart
      const uint64_t d_do_mn = desc(sm.dout[s][0], kQBytes, 1024);
      const uint64_t d_q_mn = desc(sm.q[s][0], kQBytes, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (HD == 128)
          wgmma_rs_n128(dv, pa[kk], d_do_mn + kk * 128);
        else
          wgmma_rs_n64(dv, pa[kk], d_do_mn + kk * 128);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (HD == 128)
          wgmma_rs_n128(dk, sa[kk], d_q_mn + kk * 128);
        else
          wgmma_rs_n64(dk, sa[kk], d_q_mn + kk * 128);
      }
      wg_commit();
      bar_sync(kBarDs, kThreads);     // every dS^T row is stored
      wg_wait();                      // dV, dK done: pa and sa are free
      pin(dv);
      pin(dk);
      pin(pa);
      pin(sa);

      // dQ partial = dS K, 64 q rows: at hd 128 each group takes 64 of the
      // columns over all 128 kv rows; at hd 64 each takes its own 64 kv
      // rows over all columns.  A (dS) and B (K) are both MN-major.
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      wg_fence();
      {
        // 16 kv rows (2048 bytes of dS^T and of K) a k16 step
        const uint64_t d_ds = desc(sm.ds + (HD == 128 ? 0 : wgi * 64 * 64),
                                   8192, 1024);
        const uint64_t d_kmn = desc(
            HD == 128 ? sm.k[wgi] : sm.k[0] + wgi * 64 * kPanel, 8192, 1024);
#pragma unroll
        for (int kk = 0; kk < (HD == 128 ? kBlockKV : 64) / 16; ++kk)
          wgmma_ss_n64<1, 1>(dq, d_ds + kk * 128, d_kmn + kk * 128);
      }
      wg_commit();
      wg_wait();
      pin(dq);
      // the partial goes to shared memory for its add
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float2*>(dqp_at(sm, it & 1, 2 * wgi + i / 4,
                                            krow_s + 8 * r,
                                            8 * (i % 4) + 2 * tig)) =
              make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
      fence_async_smem();
      bar_sync(kBarDone, kThreads);   // stage s, dS^T, dQ's partial done
      if (threadIdx.x == 0 && j + kStages < n_steps)
        load_step<HD>(sm, p, &tq, &tdo, s, b, step(j + kStages));
      if (HD == 64 && __shfl_sync(0xffffffffu, wgi, 0) == 0) {
        // the first group adds the second's partial (over the other 64 kv
        // rows) into its own
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = krow_s + 8 * r, cc = 8 * (i % 4) + 2 * tig;
            float2* mine =
                reinterpret_cast<float2*>(dqp_at(sm, it & 1, i / 4, row, cc));
            const float2 other = *reinterpret_cast<const float2*>(
                dqp_at(sm, it & 1, 2 + i / 4, row, cc));
            mine->x += other.x;
            mine->y += other.y;
          }
        fence_async_smem();
        bar_sync(kBarSum, 128);
      }
      const int rank =
          __shfl_sync(0xffffffffu, n - sched_first(p)[stp.t], 0);
      const bool last =
          __shfl_sync(0xffffffffu, sched_count(p)[stp.t] - 1, 0) == rank;
      if (last) {
        add_last(sm, p, b, n_q, stp.hq, stp.t, rank, it & 1);
      } else if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0) {
        __syncwarp();
        if (lane == 0) {
          sm.pend[0] = stp.hq;
          sm.pend[1] = stp.t;
          sm.pend[2] = rank;
          sm.pend[3] = it & 1;
        }
        __syncwarp();
      }
    }
    if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0) {
      issue_add(sm, p, &tacc, b, n_q);
      publish(sm);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k_pos = a0 + krow + 8 * r;
      if (k_pos >= p.T) continue;
      const long long off = (((long long)b * p.T + k_pos) * p.KH + kh) * HD;
      __nv_bfloat16* dkr = static_cast<__nv_bfloat16*>(p.dk) + off;
      __nv_bfloat16* dvr = static_cast<__nv_bfloat16*>(p.dv) + off;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int c = 8 * i + 2 * tig;
        *reinterpret_cast<__nv_bfloat162*>(dkr + c) = __floats2bfloat162_rn(
            dk[4 * i + 2 * r] * p.scale, dk[4 * i + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + c) =
            __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// Rank-3 map (hd, S, B * H) over the f32 dq sums, boxes of (32, 64, 1),
// 128-byte swizzle: the copy engine's adds of dQ partials
cudaError_t make_acc_map(CUtensorMap* map, float* base, int hd, int seq,
                         int bh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)seq,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 4,
                                 (cuuint64_t)hd * seq * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)kBlockQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tacc;
  cudaError_t err = make_map(&tq, p.q, HD, p.H, p.S, p.B, p.q_sh, p.q_ss,
                             p.q_sb, kBlockQ);
  if (err == cudaSuccess)
    err = make_map(&tdo, p.dout, HD, p.H, p.S, p.B, p.do_sh, p.do_ss,
                   p.do_sb, kBlockQ);
  if (err == cudaSuccess)
    err = make_map(&tk, p.k, HD, p.KH, p.T, p.B, p.k_sh, p.k_ss, p.k_sb,
                   kBlockKV);
  if (err == cudaSuccess)
    err = make_map(&tv, p.v, HD, p.KH, p.T, p.B, p.v_sh, p.v_ss, p.v_sb,
                   kBlockKV);
  if (err == cudaSuccess) err = make_acc_map(&tacc, p.dq_acc, HD, p.S,
                                             p.B * p.H);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sizeof(Smem<HD>) + 1024;   // + room to align
  err = allow_smem<flash_attn_bwd_wgmma<HD>>(smem);
  if (err != cudaSuccess) return err;
  const int n_items = (p.T + kBlockKV - 1) / kBlockKV * p.B * p.KH;
  const int grid = n_items < p.n_sms ? n_items : p.n_sms;
  flash_attn_bwd_wgmma<HD><<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                                             tdo, tacc, p);
  return cudaGetLastError();
}

}  // namespace wg

// The body is chosen by the wrapper (kernel.py::_body); each hd compiles
// only the bodies that take it.
template <int HD>
cudaError_t launch_hd(const Params& p, int dtype, int body,
                      cudaStream_t st) {
  constexpr bool kTma = HD % sm90::kPanel == 0;   // 64 and 128
  const bool ok = dtype == 0   ? body == kBodyFma
                  : dtype != 1 ? false
                  : body == kBodyMma ? HD != 64
                                     : body == kBodyWgmma && kTma;
  if (!ok) return cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.Sp * p.H;
  const long long n_zero =
      body == kBodyWgmma
          ? (long long)p.B * p.H * ((p.S + wg::kBlockQ - 1) / wg::kBlockQ) + 1
          : 0;
  const long long row_blocks = (rows + kDeltaRows - 1) / kDeltaRows;
  const long long zero_blocks =
      (n_zero + kDeltaRows * 32 - 1) / (kDeltaRows * 32);
  const long long blocks = row_blocks > zero_blocks ? row_blocks : zero_blocks;
  if (dtype == 0)
    flash_attn_bwd_delta<float>
        <<<(unsigned)blocks, kDeltaRows * 32, 0, st>>>(p, HD, n_zero);
  else
    flash_attn_bwd_delta<__nv_bfloat16>
        <<<(unsigned)blocks, kDeltaRows * 32, 0, st>>>(p, HD, n_zero);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dtype == 0) return f32::launch<HD>(p, st);
  if constexpr (kTma) {
    if (body == kBodyWgmma) return wg::launch<HD>(p, st);
  }
  if constexpr (HD != 64) return bf16::launch<HD>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dims: 26 int64 values: dtype (0 = float32, 1 = bfloat16), body (0 FMA,
// 1 mma.sync, 2 wgmma), B, S, T, H, K, hd, causal, window, the number of
// SMs, then the (batch, seq, head) strides in elements of q, k, v, o and
// do.  The last dim of each is contiguous; for bfloat16 every row starts
// 16-byte aligned, and for the wgmma body every stride is one TMA takes
// (both checked by the wrapper).  lse is f32 (B, H, S); dq, dk and dv are
// contiguous.  ws is the f32 workspace of `workspace_words` words, sched
// the band schedule (wgmma body only, else null).  Returns the CUDA error
// of the launches (0 on success); they run asynchronously on `stream`.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, void* dq, void* dk, void* dv,
                              float* ws, const int* sched,
                              const long long* dims, float scale,
                              void* stream) {
  const int dtype = (int)dims[0], body = (int)dims[1];
  const int B = (int)dims[2], S = (int)dims[3], T = (int)dims[4];
  const int H = (int)dims[5], KH = (int)dims[6], hd = (int)dims[7];
  const int Sp = (S + wg::kBlockQ - 1) / wg::kBlockQ * wg::kBlockQ;
  const long long rows = (long long)B * H * Sp;
  const bool wgmma = body == kBodyWgmma;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  // workspace: D (B, H, Sp) | lse * log2 e (B, H, Sp) | dq sums
  // (B, H, S, hd) | counters (B, H, ceil(S / 64)) and the ticket, as int32
  p.delta = ws;
  p.lse2 = wgmma ? ws + rows : nullptr;
  p.dq_acc = wgmma ? ws + 2 * rows : nullptr;
  p.counters = wgmma ? reinterpret_cast<int*>(ws + 2 * rows +
                                              (long long)B * H * S * hd)
                     : nullptr;
  p.sched = sched;
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.Sp = Sp;
  p.n_sms = (int)dims[10];
  const long long* st = dims + 11;
  p.q_sb = st[0], p.q_ss = st[1], p.q_sh = st[2];
  p.k_sb = st[3], p.k_ss = st[4], p.k_sh = st[5];
  p.v_sb = st[6], p.v_ss = st[7], p.v_sh = st[8];
  p.o_sb = st[9], p.o_ss = st[10], p.o_sh = st[11];
  p.do_sb = st[12], p.do_ss = st[13], p.do_sh = st[14];
  p.causal = (int)dims[8];
  p.window = (int)dims[9];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  if (wgmma && sched == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_hd<16>(p, dtype, body, s); break;
    case 32: err = launch_hd<32>(p, dtype, body, s); break;
    case 64: err = launch_hd<64>(p, dtype, body, s); break;
    case 80: err = launch_hd<80>(p, dtype, body, s); break;
    case 128: err = launch_hd<128>(p, dtype, body, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
