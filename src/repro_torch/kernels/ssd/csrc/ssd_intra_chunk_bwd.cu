// Backward of the Mamba2 SSD intra-chunk function for Hopper (sm_90a),
// written by hand in CUDA C++.
//
// The TPU kernel src/repro/kernels/ssd/kernel.py::_ssd_kernel has no
// backward: the reference trains the SSM and hybrid families with
// kernel_mode="ref", where jax.grad differentiates the einsums of
// src/repro/models/ssm.py:91-103.  This is the gradient of the function
// ssd_intra_chunk.cu computes.  Per batch row b, chunk c and head h, with
// the chunk's L rows, E[i,j] = exp(cum_i - cum_j) for i >= j (else 0),
// M = CB * E * dt_j and w_l = exp(cum_{L-1} - cum_l) dt_l, given the
// cotangents dy (L, P) of y = M X and dS (N, P) of S = (w B)^T X:
//     dM    = dy X^T                            (causal half)
//     dX    = M^T dy + w * (B dS)
//     dw_l  = sum_p X[l,p] (B dS)[l,p]
//     d dt  = colsum(dM * CB * E) + dw * exp(cum_{L-1} - cum)
//     d cum = rowsum(Q) - colsum(Q) - dw * w, + sum_l dw_l w_l on row L-1,
//             Q = dM * M
//     dCB   = sum_h dM * E * dt_j,   dC = dCB B,
//     dB    = dCB^T C + sum_h w * (X dS^T)
// with f32 sums; x in f32 or bf16, every other input and both cotangents
// f32.  dx comes out in x's dtype, the other four in f32.
//
// Layout.  xc (B, NC, L, H, P), dtc and cum (B, NC, L, H), bc and cc
// (B, NC, L, N) are read through their strides, as the forward reads them
// (the last dim of x, B and C contiguous); dy (B, NC, L, H, P) and dS
// (B, NC, H, N, P) are contiguous, and so are the outputs.  L is 1 to 256,
// P up to 64, N up to 128; ragged edges are masked, and every entry with
// j > i is masked before its exponential.
//
// What bounds it on an H100.  At mamba2-780m's training shape (B 2, NC 8,
// L 256, H 48, P 64, N 128, x bf16) the function needs 13.3 GFLOP (the
// causal halves of dM and M^T dy, B dS and X dS^T per head; C B^T, dC and
// dB once per chunk) and moves 137 MB (each input and output once): 0.041
// ms at 3.35 TB/s, 0.013 ms at the bf16 tensor-core rate.  Bound by bytes.
//
// Every product runs on the tensor cores at f32 accuracy: bf16 mma.sync
// m16n8k16 with f32 accumulation, each f32 operand split exactly into three
// bf16 parts (ssd_mma.cuh's split3), and the part-products whose weight is
// 2^-16 or more summed, the lightest first (ssd/ref.py::split_matmul is the
// same sum on the CPU; two parts miss the row bound on rows that cancel).
// A bf16 X is exact as an operand: its products take three part-products,
// every f32 x f32 product six (an f32 X is split like any f32 operand, in
// the same body).  So the kernel issues 69.5 GFLOP of bf16 products at that
// shape (the function's 13.3 with the split, and dM again for dCB).
//   launch  product          A operand                    B operand  parts
//   (b)     dM^T = X dy^T    X (ldmatrix)                 dy's parts   3
//           dX += M^T dy     M^T: dM^T's accumulators     dy's parts   6
//           U = B dS         B, split in registers        dS's parts   6
//   (c)     dM = dy X^T      dy, split in registers       X            3
//   (d)     dS X^T           dS, split in registers       X            3
//   (e)     dC^T = B^T dCB^T B^T, split in registers      dCB's parts  6
//           dB^T = C^T dCB   C^T, split in registers      dCB's parts  6
// (6 instead of 3 for an f32 X).  A "part" operand is split by the whole
// block once per tile into a swizzled tile that ldmatrix reads without
// bank conflicts; an operand "split in registers" is rows of the warp's
// own, split where its fragment is built (no barrier, no split by the
// block).  mma.sync and not wgmma: M^T is built in the accumulators of dM^T
// and goes on as the A operand of M^T dy from registers, and the units are
// a few hundred blocks of four warps, not the long persistent product
// wgmma pays off on.  Dropping the products of parts that are exactly zero
// (x, B, C and dy hold bf16 values on the bf16 training path) gave the
// same bits but only 5 % there and cost 3 % on f32 data: the per-head
// kernel is held by its latency at 8 warps an SM, not by its products.
//
// Design: five launches on the caller's stream, every sum in a fixed order
// (no atomics: two calls give the same bits); 128 threads a block, each
// warp 16 rows of a 64-row tile; every operand tile comes through a
// cp.async ring of two or three stages (plain loads where a row is not
// 16-byte aligned, or x is f32), so the next step's loads run under this
// step's products.
//   (a) C B^T into an f32 scratch, the forward's kernel (ssd_cb.cuh).
//   (b) One block per (b, c, h): everything whose sums stay inside one
//       head.  For each 64-row column tile j: U = B dS over N in steps of
//       64, dw = rowsum(X * U) and dX = w * U; then for each row tile
//       i >= j, dM^T = X dy^T with the tile transposed (rows j, columns
//       i), and in its accumulators M^T = CB * E * dt_j and D = dM * CB *
//       E; d dt's column sums of D are row sums of the fragment (quad
//       shuffles), Q's row sums (D dt_j over j) column sums, added down
//       the warp in a fixed tree and kept per warp in shared memory; then
//       dX += M^T dy with M^T's fragments as the A operand.  d cum per row
//       at the end, the warps' sums added in warp order.
//   (c) dCB: one block per 64 x 64 tile on or below the diagonal, (b, c)
//       and head group, walking its heads in order: dM recomputed (a
//       quarter more products than the function needs, and no scratch of
//       per-head partials), times E and dt_j, summed into registers; each
//       group's partial to scratch, masked entries as zeros.
//   (d) The state term of dB, sum_h w * (X dS^T): one block per 64 rows,
//       64 columns of N, (b, c) and head group, transposed (rows n) so
//       that dS is this warp's own A operand; w applied to each head's sum;
//       each group's partial to scratch.
//   (e) dC and dB: one block per 64 rows and 64 columns of N and per
//       (b, c), transposed: dC = dCB B over the tiles left of the diagonal,
//       dB = dCB^T C over those below (dCB's group partials added in order
//       as its tile is split), then + (d)'s partials in group order.
// Head groups: one block walking all 48 (or 80) heads left (c) and the
// state term at 160 and 128 blocks of 4 warps, latency-bound; two groups
// for dCB and four for the state term cut them from 0.221 to 0.097 ms and
// from 0.110 (with dC, dB) to 0.074 ms.  Every unit of a launch does the
// same work (a whole head's tiles in (b), a group of heads in (c), (d)), so
// the in-order dispatch needs no ordering.
//
// Registers (ptxas, CUDA 12.8) and blocks an SM, bf16 x by cp.async / by
// plain loads / f32 x: (b) 210 / 222 / 220, two blocks an SM (112 KB of
// shared memory; f32 144 KB, one); (c) 165 / 191 / 209, three / two / one
// (74 KB; three blocks by plain loads spilled); (d) 161 / 167 / 167, three
// / three / one (73 KB); (e), whatever x is, 152 / 148, one (120 KB, five
// steps a block).  No spills.  Times at the shape above on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py --ssd-only): 0.5098 ms a call, (b)
// 0.2801, (c) 0.0961, (d) 0.0738, (e) 0.0272, (a) 0.0169.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "ssd_cb.cuh"
#include "ssd_mma.cuh"

namespace {

constexpr int kTileF = kT * kT * 4;   // a 64 x 64 f32 tile
constexpr int kTileH = kT * kT * 2;   // a 64 x 64 bf16 tile

// (named apart from the forward's Args, so that a profile tells the two
// C B^T launches apart)
struct BwdArgs {
  const void* x;
  const float* dt;
  const float* cum;
  const float* bm;
  const float* cm;
  const float* dy;
  const float* ds;
  void* dx;
  float* ddt;
  float* dcum;
  float* db;
  float* dc;
  float* cb;   // (B*NC, Lp, Lp) scratch: C B^T, written by (a)
  float* dcb;  // (G, B*NC, Lp, Lp) scratch: dCB's group partials, by (c)
  float* dst;  // (G', B*NC, L, N) scratch: the state term's, by (d)
  int B, NC, L, H, P, N, Lp;
  long long x_sb, x_sc, x_sl, x_sh;
  long long dt_sb, dt_sc, dt_sl, dt_sh;
  long long cu_sb, cu_sc, cu_sl, cu_sh;
  long long b_sb, b_sc, b_sl;
  long long c_sb, c_sc, c_sl;
};

// 4 bytes global -> shared; zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* ptr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// An f32 tile read down its columns, (i, j): chunk j/4 of row i at
// (j/4) ^ 2((i/2)%4), so that a warp reading t[i][j] for 8 consecutive j
// and i = 2tig (+1) (an A fragment of the transpose, or CB^T's elements
// beside an accumulator fragment) touches 32 distinct banks.
__device__ __forceinline__ int cbt_at(int i, int j) {
  return i * kT + ((((j >> 2) ^ (((i >> 1) & 3) << 1))) << 2) + (j & 3);
}

enum Layout { kRows, kCb, kCbt };

template <int kLay>
__device__ __forceinline__ int f32_at(int r, int c) {
  if constexpr (kLay == kCb)
    return cb_at(r, c);
  else if constexpr (kLay == kCbt)
    return cbt_at(r, c);
  else
    return r * kT + c;
}

// A 64 x 64 f32 tile (row r at src + r * ld) into dst in layout kLay; rows
// from `rows` on and columns from `cols` on are 0.  Async: 16-byte
// cp.async (every row 16-byte aligned, cols % 4 == 0 or past 64); else
// plain loads.
template <int kLay, bool kAsync>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long ld, int rows, int cols) {
#pragma unroll
  for (int s = 0; s < kT * kT / 4 / kThreads; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int r = idx >> 4, c = 4 * (idx & 15);
    const bool row_in = r < rows;
    const float* p = src + r * ld + c;
    float* d = dst + f32_at<kLay>(r, c);
    if constexpr (kAsync) {
      const bool ok = row_in && c < cols;
      cp16(d, ok ? p : src, ok);
    } else {
      float4 v;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        (&v.x)[e] = (row_in && c + e < cols) ? p[e] : 0.f;
      *reinterpret_cast<float4*>(d) = v;
    }
  }
}

// The f32 tile src (row layout; with kAdd > 1, the sum of kAdd tiles one
// after the other, added in order) as its three bf16 parts, in x_at
// layout, at dst, dst + 64 * 64 and dst + 2 * 64 * 64; the whole block
// takes part.
template <int kAdd = 1>
__device__ __forceinline__ void split_tile(__nv_bfloat16* dst,
                                           const float* src) {
#pragma unroll
  for (int s = 0; s < kT * kT / 4 / kThreads; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int r = idx >> 4, c = 4 * (idx & 15);
    float4 v = *reinterpret_cast<const float4*>(src + r * kT + c);
#pragma unroll
    for (int q = 1; q < kAdd; ++q) {
      const float4 u =
          *reinterpret_cast<const float4*>(src + q * kT * kT + r * kT + c);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    uint2 w[3];
    split3(v.x, v.y, w[0].x, w[1].x, w[2].x);
    split3(v.z, v.w, w[0].y, w[1].y, w[2].y);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint2*>(dst + q * kT * kT + x_at(r, c)) = w[q];
  }
}

// The A fragment of rows row0 + g (+8), columns k0 + 2tig (+1) (+8), of
// the f32 tile t in cb_at layout (kTrans: t holds A transposed, rows k, in
// cbt_at layout), split into its three bf16 parts.
template <bool kTrans>
__device__ __forceinline__ void a_frag(const float* t, int row0, int k0,
                                       int g, int tig, unsigned (&af)[3][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = k0 + 2 * tig + 8 * half;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      float v0, v1;
      if constexpr (kTrans) {
        v0 = t[cbt_at(k, row)];
        v1 = t[cbt_at(k + 1, row)];
      } else {
        const float2 v = *reinterpret_cast<const float2*>(t + cb_at(row, k));
        v0 = v.x;
        v1 = v.y;
      }
      split3(v0, v1, af[0][rr + 2 * half], af[1][rr + 2 * half],
             af[2][rr + 2 * half]);
    }
  }
}

// The A fragment of parts planes (x_at layout, rows row0.., columns k0..)
template <int kParts>
__device__ __forceinline__ void a_planes(const __nv_bfloat16* t, int row0,
                                         int k0, int lane,
                                         unsigned (&af)[3][4]) {
#pragma unroll
  for (int q = 0; q < kParts; ++q)
    ldsm_x4(t + q * kT * kT + x_at(row0 + (lane & 15), k0 + 8 * (lane >> 4)),
            af[q]);
}

// acc (16 rows x 64 columns of one warp) += A B over one k16 step: A's
// first kA parts given as fragments, B's first kB parts from planes in
// x_at layout that hold B (kRowsK: rows k, read by ldmatrix.trans) or B^T
// (rows n, columns k); the part-products whose weight 2^-8(q + b) is
// 2^-16 or more, the lightest first.
template <bool kRowsK, int kA, int kB>
__device__ __forceinline__ void mma_parts(float (&acc)[8][4],
                                          const unsigned (&af)[3][4],
                                          const __nv_bfloat16* t, int k0,
                                          int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    unsigned bf[kB][4];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      if constexpr (kRowsK)
        ldsm_x4_trans(t + q * kT * kT +
                          x_at(k0 + (lane & 15), 16 * np + 8 * (lane >> 4)),
                      bf[q]);
      else
        ldsm_x4(t + q * kT * kT +
                    x_at(16 * np + (lane & 7) + 8 * (lane >> 4),
                         k0 + 8 * ((lane >> 3) & 1)),
                bf[q]);
    }
#pragma unroll
    for (int s = 2; s >= 0; --s)
#pragma unroll
      for (int q = 0; q < kA; ++q) {
        const int b = s - q;
        if (b < 0 || b >= kB) continue;
        mma(acc[2 * np], af[q], bf[b][0], bf[b][1]);
        mma(acc[2 * np + 1], af[q], bf[b][2], bf[b][3]);
      }
  }
}

// X[r][p], X[r][p + 1] from the parts planes of an X tile (exact: the
// parts of an f32 X add back to it, smallest first)
template <int kParts>
__device__ __forceinline__ float2 x_pair(const __nv_bfloat16* t, int r,
                                         int p) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = kParts - 1; q >= 0; --q) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(t + q * kT * kT + x_at(r, p)));
    v.x += f.x;
    v.y += f.y;
  }
  return v;
}

// Sums over the 8 lanes of each quad position (lanes 4g + tig, g = 0..7)
// of the 16 values v[2n + e] (column 8n + 2tig + e of a fragment), halving
// the values each exchange: lane (g, tig) ends with the sums of columns
// 8g + 2tig + m in v[m], m = 0, 1.  A fixed tree: the same bits each call.
template <int W>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool up = lane & (2 * W);
#pragma unroll
  for (int m = 0; m < W; ++m) {
    const float keep = up ? v[m + W] : v[m];
    const float send = up ? v[m] : v[m + W];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * W);
  }
}
__device__ __forceinline__ void sum_columns(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// A warp's 16 rows x 64 columns (acc, rows row0 + g (+8), columns
// 8n + 2tig (+1)) into out (row r at out + r * ld), rows below `rows` and
// columns below `cols` only.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, long long ld,
                                           const float (&acc)[8][4], int row0,
                                           int rows, int cols, int g,
                                           int tig) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    if (r >= rows) continue;
    T* o = out + r * ld;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c >= cols) continue;
      const float v0 = acc[n][2 * rr], v1 = acc[n][2 * rr + 1];
      if (((cols | ld) & 1) == 0) {
        store2(o + c, v0, v1);
      } else {
        store1(o + c, v0);
        if (c + 1 < cols) store1(o + c + 1, v1);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// ------------------------------------------------------ (b) one head a block
template <typename XT>
struct HeadShape {
  static constexpr int kXP = XParts<XT>::value;
  static constexpr int kStage = 2 * kTileF;          // F1 (CB, B) | F2 (dy, dS)
  static constexpr int kSplitOff = 2 * kStage;       // F2's three parts
  static constexpr int kXOff = kSplitOff + 3 * kTileH;   // two X tiles
  static constexpr int kVecOff = kXOff + 2 * kXP * kTileH;
  // cum, dt, dw, colq; rowq of each warp
  static constexpr int kSmem = kVecOff + 8 * kMaxL * 4;
  // 112 KB, two blocks an SM (a one-stage ring of 72 KB, three blocks at
  // most 170 registers, spilled); f32 x 144 KB, one
  static constexpr int kMinBlocks = kXP == 1 ? 2 : 1;
};

template <typename XT, bool kAsync>
__global__ void __launch_bounds__(kThreads, HeadShape<XT>::kMinBlocks)
    ssd_bwd_head_kernel(const BwdArgs a) {
  using S = HeadShape<XT>;
  constexpr int kXP = S::kXP;
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  auto* sp = reinterpret_cast<__nv_bfloat16*>(base + S::kSplitOff);
  auto* xb = reinterpret_cast<__nv_bfloat16*>(base + S::kXOff);
  float* cum_s = reinterpret_cast<float*>(base + S::kVecOff);
  float* dt_s = cum_s + kMaxL;
  float* dw_s = dt_s + kMaxL;
  float* colq_s = dw_s + kMaxL;
  float* rowq_s = colq_s + kMaxL;            // [warp][i]

  const int h = blockIdx.x % a.H, bc = blockIdx.x / a.H;
  const int bb = bc / a.NC, cz = bc % a.NC;
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const XT* xh = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc +
                 h * a.x_sh;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;
  const float* dyh = a.dy + (long long)bc * L * H * P + (long long)h * P;
  const float* dsh = a.ds + ((long long)bc * H + h) * N * P;
  const float* cbm = a.cb + (long long)bc * a.Lp * a.Lp;
  const float* cuh = a.cum + bb * a.cu_sb + cz * a.cu_sc + h * a.cu_sh;
  const float* dth = a.dt + bb * a.dt_sb + cz * a.dt_sc + h * a.dt_sh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float last = cuh[(L - 1) * a.cu_sl];

#pragma unroll
  for (int s = 0; s < kMaxL / kThreads; ++s) {
    const int l = s * kThreads + tid;
    cum_s[l] = l < L ? cuh[l * a.cu_sl] : 0.f;
    dt_s[l] = l < L ? dth[l * a.dt_sl] : 0.f;
    dw_s[l] = colq_s[l] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < 4 * kMaxL / kThreads; ++s)
    rowq_s[s * kThreads + tid] = 0.f;

  // Steps (jt, k): for each column tile jt, k < nnt the U chunk k (rows j
  // of B, N from 64k), then k >= nnt the row tile it = jt + k - nnt.
  const int nlt = (L + kT - 1) / kT, nnt = (N + kT - 1) / kT;
  const int nsteps = nlt * nnt + nlt * (nlt + 1) / 2;
  auto next = [&](int& jt, int& k) {
    if (++k == nnt + nlt - jt) {
      ++jt;
      k = 0;
    }
  };
  auto load = [&](int t, int jt, int k) {
    float* f1 = reinterpret_cast<float*>(base + (t & 1) * S::kStage);
    float* f2 = f1 + kT * kT;
    const int j0 = jt * kT;
    if (k < nnt) {
      const int n0 = k * kT;
      stage_f32<kCb, kAsync>(f1, bm + j0 * a.b_sl + n0, a.b_sl, L - j0,
                             N - n0);
      stage_f32<kRows, kAsync>(f2, dsh + (long long)n0 * P, P, N - n0, P);
      if (k == 0)
        stage_x<XT, kAsync>(xb + (jt & 1) * kXP * kT * kT, xh, a, j0);
    } else {
      const int i0 = (jt + k - nnt) * kT;
      stage_f32<kCbt, true>(f1, cbm + (long long)i0 * a.Lp + j0, a.Lp, kT,
                            kT);
      stage_f32<kRows, kAsync>(f2, dyh + (long long)i0 * H * P,
                               (long long)H * P, L - i0, P);
    }
    cp_commit();
  };

  float dx[8][4];                 // U, then dX, of rows j (this warp's 16)
  float cold[2] = {0.f, 0.f};     // this thread's part of colsum(D), rows j
  int jt = 0, k = 0, ljt = 0, lk = 0;
  load(0, 0, 0);
  next(ljt, lk);
  for (int t = 0; t < nsteps; ++t) {
    cp_wait<0>();
    __syncthreads();              // step t landed; step t - 1 all done
    if (t + 1 < nsteps) {
      load(t + 1, ljt, lk);
      next(ljt, lk);
    }
    const float* f1 =
        reinterpret_cast<const float*>(base + (t & 1) * S::kStage);
    split_tile(sp, f1 + kT * kT);     // dS or dy
    __syncthreads();
    const __nv_bfloat16* xt = xb + (jt & 1) * kXP * kT * kT;
    const int j0 = jt * kT;
    if (k < nnt) {
      // U (rows j, columns p) += B dS over 64 of N
      if (k == 0) zero(dx);
      const int ks_end = min(4, (N - k * kT + 15) / 16);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= ks_end) break;
        unsigned af[3][4];
        a_frag<false>(f1, 16 * warp, 16 * ks, g, tig, af);
        mma_parts<true, 3, 3>(dx, af, sp, 16 * ks, lane);
      }
      if (k == nnt - 1) {
        // dw_j = sum_p X[j,p] U[j,p] (the quad's lanes added in a fixed
        // pattern); then the dX accumulator starts at w_j U
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int jl = 16 * warp + g + 8 * rr, j = j0 + jl;
          float part = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 xv = x_pair<kXP>(xt, jl, 8 * n + 2 * tig);
            part = fmaf(xv.x, dx[n][2 * rr], part);
            part = fmaf(xv.y, dx[n][2 * rr + 1], part);
          }
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          const bool in = j < L;
          if (tig == 0 && in) dw_s[j] = part;
          const float wj = in ? expf(last - cum_s[j]) * dt_s[j] : 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            dx[n][2 * rr] *= wj;
            dx[n][2 * rr + 1] *= wj;
          }
        }
        cold[0] = cold[1] = 0.f;
      }
    } else {
      const int it = jt + k - nnt, i0 = it * kT;
      // dM^T (rows j, columns i) = X dy^T over P (on the diagonal tile,
      // whole n8 tiles of it are masked: skipping them made it slower)
      float d[8][4];
      zero(d);
      const int p_end = (P + 15) / 16;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= p_end) break;
        unsigned xa[3][4];
        a_planes<kXP>(xt, 16 * warp, 16 * ks, lane, xa);
        mma_parts<false, kXP, 3>(d, xa, sp, 16 * ks, lane);
      }
      // M^T = CB E dt_j and D = dM CB E, elementwise in the accumulators;
      // colsum(D) over i into cold, rowsum(Q) = sum_j D dt_j into q
      float q[16];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int jl = 16 * warp + g + 8 * rr, j = j0 + jl;
        const float cj = cum_s[j], dtj = dt_s[j];
        // CB[i][j] at cbt_at(i, jl) = 64i + (jl ^ 8tig) for every
        // i = 8n + 2tig + e of this thread
        const float* cbp = f1 + 2 * tig * kT + (jl ^ (8 * tig));
        const float* cup = cum_s + i0 + 2 * tig;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + 8 * n + 2 * tig + e;
            const bool keep = i < L && j <= i;   // masked before the exp
            const float ce =
                keep ? cbp[(8 * n + e) * kT] * __expf(cup[8 * n + e] - cj)
                     : 0.f;
            const float dv = d[n][2 * rr + e] * ce;
            cold[rr] += dv;
            q[2 * n + e] = rr ? fmaf(dv, dtj, q[2 * n + e]) : dv * dtj;
            d[n][2 * rr + e] = ce * dtj;
          }
      }
      sum_columns(q, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        rowq_s[warp * kMaxL + i0 + 8 * g + 2 * tig + m] += q[m];
      // dX (rows j) += M^T dy, M^T's accumulators as the A fragments
      const int ks_end = min(4, (L - i0 + 15) / 16);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= ks_end) break;
        unsigned af[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            split3(d[2 * ks + half][2 * rr], d[2 * ks + half][2 * rr + 1],
                   af[0][rr + 2 * half], af[1][rr + 2 * half],
                   af[2][rr + 2 * half]);
        mma_parts<true, 3, 3>(dx, af, sp, 16 * ks, lane);
      }
      if (it == nlt - 1) {
        // column tile jt done: dX, d dt and colsum(Q) = dt_j colsum(D)
        store_rows(static_cast<XT*>(a.dx) + (((long long)bc * L + j0) * H +
                                             h) * P,
                   (long long)H * P, dx, 16 * warp, L - j0, P, g, tig);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float c = cold[rr];
          c += __shfl_xor_sync(0xffffffffu, c, 1);
          c += __shfl_xor_sync(0xffffffffu, c, 2);
          const int j = j0 + 16 * warp + g + 8 * rr;
          if (tig == 0 && j < L) {
            a.ddt[((long long)bc * L + j) * H + h] =
                c + dw_s[j] * expf(last - cum_s[j]);
            colq_s[j] = c * dt_s[j];
          }
        }
      }
    }
    next(jt, k);
  }
  __syncthreads();
  // d cum; the state term sum_l dw_l w_l of row L-1 added in a fixed tree
  float* red = reinterpret_cast<float*>(sp);
  float part = 0.f, v[kMaxL / kThreads];
#pragma unroll
  for (int s = 0; s < kMaxL / kThreads; ++s) {
    const int l = s * kThreads + tid;
    v[s] = 0.f;
    if (l < L) {
      const float dww = dw_s[l] * (expf(last - cum_s[l]) * dt_s[l]);
      v[s] = rowq_s[l] + rowq_s[kMaxL + l] + rowq_s[2 * kMaxL + l] +
             rowq_s[3 * kMaxL + l] - colq_s[l] - dww;
      part += dww;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  const float tot = (red[0] + red[1]) + (red[2] + red[3]);
#pragma unroll
  for (int s = 0; s < kMaxL / kThreads; ++s) {
    const int l = s * kThreads + tid;
    if (l < L)
      a.dcum[((long long)bc * L + l) * H + h] = v[s] + (l == L - 1 ? tot : 0.f);
  }
}

// --------------------------------------- (c) dCB, the heads walked in order
// dCB's head groups: block g of a tile sums heads [gH/G, (g+1)H/G) in
// order into its own partial, and (d) adds the partials in group order
constexpr int kGroups = 2;

template <typename XT, bool kAsync>
struct DcbShape {
  static constexpr int kXP = XParts<XT>::value;
  static constexpr int kStages = 3;
  // dy (f32, cb_at layout) | X's parts | cum_i, cum_j, dt_j
  static constexpr int kStage = kTileF + kXP * kTileH + 3 * kT * 4;
  static constexpr int kSmem = kStages * kStage;
  // 74 KB, three blocks an SM (two by plain loads, which spill at three);
  // 122 KB for f32 x
  static constexpr int kMinBlocks = kXP == 3 ? 1 : kAsync ? 3 : 2;
};

template <typename XT, bool kAsync>
__global__ void __launch_bounds__(kThreads, DcbShape<XT, kAsync>::kMinBlocks)
    ssd_bwd_dcb_kernel(const BwdArgs a) {
  using S = DcbShape<XT, kAsync>;
  constexpr int kXP = S::kXP;
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = ti * kT, j0 = tj * kT;
  const int bc = blockIdx.y, bb = bc / a.NC, cz = bc % a.NC;
  const int L = a.L, P = a.P, H = a.H;
  const int h0 = blockIdx.z * H / kGroups, h1 = (blockIdx.z + 1) * H / kGroups;
  const XT* xb = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc;
  const float* dyb = a.dy + ((long long)bc * L + i0) * H * P;
  const float* cub = a.cum + bb * a.cu_sb + cz * a.cu_sc;
  const float* dtb = a.dt + bb * a.dt_sb + cz * a.dt_sc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  auto stage = [&](int h) { return base + (h % S::kStages) * S::kStage; };
  auto load = [&](int h) {
    if (h < h1) {
      char* st = stage(h);
      stage_f32<kCb, kAsync>(reinterpret_cast<float*>(st), dyb + h * P,
                             (long long)H * P, L - i0, P);
      stage_x<XT, kAsync>(reinterpret_cast<__nv_bfloat16*>(st + kTileF),
                          xb + h * a.x_sh, a, j0);
      float* vec = reinterpret_cast<float*>(st + kTileF + kXP * kTileH);
      if (tid < kT) {
        const int i = i0 + tid, j = j0 + tid;
        cp4(vec + tid, i < L ? cub + i * a.cu_sl + h * a.cu_sh : cub, i < L);
        cp4(vec + kT + tid, j < L ? cub + j * a.cu_sl + h * a.cu_sh : cub,
            j < L);
        cp4(vec + 2 * kT + tid,
            j < L ? dtb + j * a.dt_sl + h * a.dt_sh : dtb, j < L);
      }
    }
    cp_commit();                  // one group a step, empty past the heads
  };

  float acc[8][4];                // dCB, rows i (this warp's 16)
  zero(acc);
  const int p_end = (P + 15) / 16;
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) load(h0 + s);
  for (int h = h0; h < h1; ++h) {
    cp_wait<S::kStages - 2>();
    __syncthreads();              // head h landed; head h - 1 all done
    load(h + S::kStages - 1);
    const char* st = stage(h);
    const auto* dyt = reinterpret_cast<const float*>(st);
    const auto* xt = reinterpret_cast<const __nv_bfloat16*>(st + kTileF);
    const float* vec =
        reinterpret_cast<const float*>(st + kTileF + kXP * kTileH);
    // dM (rows i, columns j) = dy X^T over P, dy's rows (this warp's own)
    // split in registers
    float d[8][4];
    zero(d);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= p_end) break;
      unsigned ya[3][4];
      a_frag<false>(dyt, 16 * warp, 16 * ks, g, tig, ya);
      mma_parts<false, 3, kXP>(d, ya, xt, 16 * ks, lane);
    }
    const float ci[2] = {vec[16 * warp + g], vec[16 * warp + g + 8]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = 8 * n + 2 * tig + e;
        const float cj = vec[kT + jl], dtj = vec[2 * kT + jl];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + 16 * warp + g + 8 * rr;
          if (i < L && j0 + jl <= i)        // masked before the exp
            acc[n][2 * rr + e] = fmaf(d[n][2 * rr + e] * __expf(ci[rr] - cj),
                                      dtj, acc[n][2 * rr + e]);
        }
      }
  }
  cp_wait<0>();
  // the whole tile, masked entries as zeros, into this group's partial
  store_rows(a.dcb + (((long long)blockIdx.z * a.B * a.NC + bc) * a.Lp + i0)
                         * a.Lp + j0,
             a.Lp, acc, 16 * warp, kT, kT, g, tig);
}

// ------------------------------------- (d) the state term of dB, by group
// Its head groups: block g of a tile sums heads [gH/G, (g+1)H/G) in order
// into its own partial, and (e) adds the partials in group order.
constexpr int kStateGroups = 4;

template <typename XT>
struct StateShape {
  static constexpr int kXP = XParts<XT>::value;
  static constexpr int kStages = 3;
  // X's parts | dS (f32, cb_at layout) | cum_l, dt_l and cum_{L-1}
  // (padded to 16 bytes)
  static constexpr int kStage = kXP * kTileH + kTileF + (2 * kT + 4) * 4;
  static constexpr int kSmem = kStages * kStage;
  static constexpr int kMinBlocks = kXP == 1 ? 3 : 1;  // 73 KB; 121 KB
};

// A warp's 16 rows n x 64 columns l (acc, rows n0 + row0 + g (+8),
// columns l0 + 8nt + 2tig (+1)) into out[l][n] (rows of N), rows n < N and
// l < L only.
__device__ __forceinline__ void store_nl(float* out, const float (&acc)[8][4],
                                         int n0, int l0, int N, int L, int g,
                                         int tig) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int n = n0 + 16 * warp + g + 8 * rr;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = l0 + 8 * nt + 2 * tig + e;
        if (l < L) out[(long long)l * N + n] = acc[nt][2 * rr + e];
      }
  }
}

// One block per 64 rows l, 64 columns n, (b, c) and head group, computing
// sum_h w_h * (X_h dS_h^T) transposed, rows n (this warp's 16) and columns
// l: dS's rows are this warp's own A operand, split in registers, and X's
// parts the B operand (ldmatrix), so a head's step needs no split by the
// block; w_l is applied to each head's sum.
template <typename XT, bool kAsync>
__global__ void __launch_bounds__(kThreads, StateShape<XT>::kMinBlocks)
    ssd_bwd_state_kernel(const BwdArgs a) {
  using S = StateShape<XT>;
  constexpr int kXP = S::kXP;
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const int nnt = (N + kT - 1) / kT;
  const int l0 = (blockIdx.x / nnt) * kT, n0 = (blockIdx.x % nnt) * kT;
  const int bc = blockIdx.y, bb = bc / a.NC, cz = bc % a.NC;
  const int h0 = blockIdx.z * H / kStateGroups;
  const int h1 = (blockIdx.z + 1) * H / kStateGroups;
  const XT* xb = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc;
  const float* dsb = a.ds + (long long)bc * H * N * P + (long long)n0 * P;
  const float* cub = a.cum + bb * a.cu_sb + cz * a.cu_sc;
  const float* dtb = a.dt + bb * a.dt_sb + cz * a.dt_sc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  auto stage = [&](int h) { return base + (h % S::kStages) * S::kStage; };
  auto load = [&](int h) {
    if (h < h1) {
      char* st = stage(h);
      stage_x<XT, kAsync>(reinterpret_cast<__nv_bfloat16*>(st),
                          xb + h * a.x_sh, a, l0);
      stage_f32<kCb, kAsync>(reinterpret_cast<float*>(st + kXP * kTileH),
                             dsb + (long long)h * N * P, P, N - n0, P);
      float* vec = reinterpret_cast<float*>(st + kXP * kTileH + kTileF);
      const float* cuh = cub + h * a.cu_sh;
      if (tid < kT) {
        const int l = l0 + tid;
        cp4(vec + tid, l < L ? cuh + l * a.cu_sl : cuh, l < L);
        cp4(vec + kT + tid, l < L ? dtb + l * a.dt_sl + h * a.dt_sh : dtb,
            l < L);
      } else if (tid == kT) {
        cp4(vec + 2 * kT, cuh + (L - 1) * a.cu_sl, true);
      }
    }
    cp_commit();                  // one group a step, empty past the heads
  };

  float acc[8][4];                // rows n, columns l
  zero(acc);
  const int p_end = (P + 15) / 16;
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) load(h0 + s);
  for (int h = h0; h < h1; ++h) {
    cp_wait<S::kStages - 2>();
    __syncthreads();              // head h landed; head h - 1 all done
    load(h + S::kStages - 1);
    const char* st = stage(h);
    const auto* xt = reinterpret_cast<const __nv_bfloat16*>(st);
    const auto* dst = reinterpret_cast<const float*>(st + kXP * kTileH);
    const float* vec = dst + kT * kT;
    float tacc[8][4];
    zero(tacc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= p_end) break;
      unsigned af[3][4];
      a_frag<false>(dst, 16 * warp, 16 * ks, g, tig, af);
      mma_parts<false, 3, kXP>(tacc, af, xt, 16 * ks, lane);
    }
    const float clast = vec[2 * kT];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ll = 8 * nt + 2 * tig + e;
        const float w =
            l0 + ll < L ? __expf(clast - vec[ll]) * vec[kT + ll] : 0.f;
        acc[nt][e] = fmaf(w, tacc[nt][e], acc[nt][e]);
        acc[nt][2 + e] = fmaf(w, tacc[nt][2 + e], acc[nt][2 + e]);
      }
  }
  cp_wait<0>();
  store_nl(a.dst + ((long long)blockIdx.z * a.B * a.NC + bc) * L * N, acc, n0,
           l0, N, L, g, tig);
}

// ---------------------------------------------------------- (e) dC and dB
struct BcShape {
  static constexpr int kStages = 2;
  // dCB's partials (f32, rows) | B or C (f32, cbt_at layout)
  static constexpr int kStage = kGroups * kTileF + kTileF;
  static constexpr int kSplitOff = kStages * kStage;  // dCB's three parts
  static constexpr int kSmem = kSplitOff + 3 * kTileH;
  static constexpr int kMinBlocks = 1;               // 120 KB
};

// One block per 64 rows l, 64 columns n and (b, c), computing dC and dB
// transposed, rows n (this warp's 16) and columns l, so that the A operands
// B^T and C^T are rows of this warp's own, split in registers, and dCB
// (its groups' partials added in order) is split into parts by the block:
// dC^T = B^T dCB^T over the tiles left of the diagonal, dB^T = C^T dCB over
// those below; then dB = that + (d)'s partials, added in group order.
template <bool kAsync>
__global__ void __launch_bounds__(kThreads, BcShape::kMinBlocks)
    ssd_bwd_bc_kernel(const BwdArgs a) {
  using S = BcShape;
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  auto* sp = reinterpret_cast<__nv_bfloat16*>(base + S::kSplitOff);
  const int L = a.L, N = a.N;
  const int nnt = (N + kT - 1) / kT, nlt = (L + kT - 1) / kT;
  const int lt = blockIdx.x / nnt, l0 = lt * kT;
  const int n0 = (blockIdx.x % nnt) * kT;
  const int bc = blockIdx.y, bb = bc / a.NC, cz = bc % a.NC;
  const float* dcb = a.dcb + (long long)bc * a.Lp * a.Lp;
  const long long dcb_group = (long long)a.B * a.NC * a.Lp * a.Lp;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc + n0;
  const float* cm = a.cm + bb * a.c_sb + cz * a.c_sc + n0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  // Steps: t <= lt the dC tile jt = t; then the dB tile it = t - 1.
  const int nsteps = nlt + 1;
  auto stage = [&](int t) { return base + (t % S::kStages) * S::kStage; };
  auto load = [&](int t) {
    if (t < nsteps) {
      auto* f1 = reinterpret_cast<float*>(stage(t));
      auto* f2 = f1 + kGroups * kT * kT;
      const int r0 = t <= lt ? l0 : (t - 1) * kT;   // dCB's rows, columns
      const int c0 = t <= lt ? t * kT : l0;
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
        stage_f32<kRows, true>(f1 + q * kT * kT,
                               dcb + q * dcb_group + (long long)r0 * a.Lp + c0,
                               a.Lp, kT, kT);
      if (t <= lt)
        stage_f32<kCbt, kAsync>(f2, bm + c0 * a.b_sl, a.b_sl, L - c0, N - n0);
      else
        stage_f32<kCbt, kAsync>(f2, cm + r0 * a.c_sl, a.c_sl, L - r0, N - n0);
    }
    cp_commit();                  // one group a step, empty past the end
  };

  float acc[8][4];                // dC^T, then dB^T: rows n, columns l
  zero(acc);
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) load(s);
  for (int t = 0; t < nsteps; ++t) {
    cp_wait<S::kStages - 2>();
    __syncthreads();              // step t landed; step t - 1 all done
    load(t + S::kStages - 1);
    const auto* f1 = reinterpret_cast<const float*>(stage(t));
    const auto* f2 = f1 + kGroups * kT * kT;
    // dCB's tile (dC: rows l, columns j; dB: rows i, columns l)
    split_tile<kGroups>(sp, f1);
    __syncthreads();
    const int ks_end = min(4, (L - (t <= lt ? t : t - 1) * kT + 15) / 16);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= ks_end) break;
      unsigned af[3][4];
      a_frag<true>(f2, 16 * warp, 16 * ks, g, tig, af);
      if (t <= lt)      // dC^T[n,l] += B^T[n,j] dCB[l,j] over column tile t
        mma_parts<false, 3, 3>(acc, af, sp, 16 * ks, lane);
      else              // dB^T[n,l] += C^T[n,i] dCB[i,l] over row tile t - 1
        mma_parts<true, 3, 3>(acc, af, sp, 16 * ks, lane);
    }
    if (t == lt) {
      store_nl(a.dc + (long long)bc * L * N, acc, n0, l0, N, L, g, tig);
      zero(acc);
    }
  }
  cp_wait<0>();
  // + the state term's group partials, added in group order
  const long long group = (long long)a.B * a.NC * L * N;
  const float* part = a.dst + (long long)bc * L * N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int n = n0 + 16 * warp + g + 8 * rr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = l0 + 8 * nt + 2 * tig + e;
        if (n < N && l < L) {
          const long long at = (long long)l * N + n;
          float v = part[at];
#pragma unroll
          for (int q = 1; q < kStateGroups; ++q) v += part[q * group + at];
          acc[nt][2 * rr + e] += v;
        }
      }
  }
  store_nl(a.db + (long long)bc * L * N, acc, n0, l0, N, L, g, tig);
}

// Allow the three kernels their dynamic shared memory, once per device.
template <typename XT, bool kAsync>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_bwd_head_kernel<XT, kAsync>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HeadShape<XT>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_dcb_kernel<XT, kAsync>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DcbShape<XT, kAsync>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_state_kernel<XT, kAsync>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               StateShape<XT>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc_kernel<kAsync>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BcShape::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename XT, bool kAsync>
cudaError_t launch(const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = allow_smem<XT, kAsync>();
  if (err != cudaSuccess) return err;
  err = launch_cb(a, st);                                        // (a)
  if (err != cudaSuccess) return err;
  const long long heads = (long long)a.B * a.NC * a.H;
  if (heads > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_bwd_head_kernel<XT, kAsync>                                // (b)
      <<<static_cast<unsigned>(heads), kThreads, HeadShape<XT>::kSmem, st>>>(
          a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nlt = (a.L + kT - 1) / kT, nnt = (a.N + kT - 1) / kT;
  ssd_bwd_dcb_kernel<XT, kAsync>                                 // (c)
      <<<dim3(nlt * (nlt + 1) / 2, a.B * a.NC, kGroups), kThreads,
         DcbShape<XT, kAsync>::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<XT, kAsync>                               // (d)
      <<<dim3(nlt * nnt, a.B * a.NC, kStateGroups), kThreads,
         StateShape<XT>::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_bc_kernel<kAsync>                                      // (e)
      <<<dim3(nlt * nnt, a.B * a.NC), kThreads, BcShape::kSmem, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// ptrs: x, dt, cum, B, C, dy, dS, dx, d dt, d cum, dB, dC, and three
// float32 scratches: C B^T (B * NC * Lp * Lp, Lp = L rounded up to a
// multiple of 64), dCB's group partials (ssd_bwd_groups(0) times that) and
// the state term's (ssd_bwd_groups(1) * B * NC * L * N); dims: the
// forward's 25 int64 values (the dtype of x, 0 = float32, 1 = bfloat16; B,
// NC, L, H, P, N; the strides in elements of x (4), dt (4), cum (4), B (3)
// and C (3)).  dy (B, NC, L, H, P) and dS (B, NC, H, N, P) are contiguous
// float32; dx is contiguous in x's dtype; d dt and d cum (B, NC, L, H) and
// dB and dC (B, NC, L, N) are contiguous float32.  Returns the CUDA error
// of the launches (0 on success); the kernels run asynchronously on
// `stream`.
extern "C" int ssd_intra_chunk_bwd(const void* const* ptrs, const void* dims,
                                   void* stream) {
  long long d[25];
  std::memcpy(d, dims, sizeof(d));
  const long long dtype = d[0], B = d[1], NC = d[2], L = d[3], H = d[4],
                  P = d[5], N = d[6];
  if ((dtype != 0 && dtype != 1) || B < 1 || NC < 1 || L < 1 ||
      L > kMaxL || H < 1 || P < 1 || P > kT || N < 1 || N > 2 * kT ||
      B * NC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{ptrs[0],
               static_cast<const float*>(ptrs[1]),
               static_cast<const float*>(ptrs[2]),
               static_cast<const float*>(ptrs[3]),
               static_cast<const float*>(ptrs[4]),
               static_cast<const float*>(ptrs[5]),
               static_cast<const float*>(ptrs[6]),
               const_cast<void*>(ptrs[7]),
               static_cast<float*>(const_cast<void*>(ptrs[8])),
               static_cast<float*>(const_cast<void*>(ptrs[9])),
               static_cast<float*>(const_cast<void*>(ptrs[10])),
               static_cast<float*>(const_cast<void*>(ptrs[11])),
               static_cast<float*>(const_cast<void*>(ptrs[12])),
               static_cast<float*>(const_cast<void*>(ptrs[13])),
               static_cast<float*>(const_cast<void*>(ptrs[14])),
               static_cast<int>(B), static_cast<int>(NC),
               static_cast<int>(L), static_cast<int>(H),
               static_cast<int>(P), static_cast<int>(N),
               static_cast<int>((L + kT - 1) / kT * kT),
               d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13], d[14],
               d[15], d[16], d[17], d[18], d[19], d[20], d[21],
               d[22], d[23], d[24]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte cp.async for x, B, C, dy and dS where every row starts 16-byte
  // aligned; an f32 x is split as it is staged, by plain loads
  const bool async = dtype == 1 && P % 8 == 0 && N % 4 == 0 &&
                     aligned16(ptrs[0]) && aligned16(ptrs[3]) &&
                     aligned16(ptrs[4]) && aligned16(ptrs[5]) &&
                     aligned16(ptrs[6]) &&
                     (a.x_sb | a.x_sc | a.x_sl | a.x_sh) % 8 == 0 &&
                     (a.b_sb | a.b_sc | a.b_sl) % 4 == 0 &&
                     (a.c_sb | a.c_sc | a.c_sl) % 4 == 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, false>(a, s);
  else if (async)
    err = launch<__nv_bfloat16, true>(a, s);
  else
    err = launch<__nv_bfloat16, false>(a, s);
  return static_cast<int>(err);
}

// The head groups the dCB scratch (0) and the state term's (1) hold a
// partial for.
extern "C" int ssd_bwd_groups(int which) {
  return which == 0 ? kGroups : kStateGroups;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
