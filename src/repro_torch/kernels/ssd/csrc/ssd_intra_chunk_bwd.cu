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
// ms at 3.35 TB/s, 0.013 ms at the bf16 tensor-core rate, 0.20 ms on f32
// FMAs.  This first version runs every product on f32 FMAs, so it is bound
// by operations on the FMA pipes; the products could move to the tensor
// cores at f32 accuracy with the forward's three-way bf16 split.
//
// Design: four launches on the caller's stream, every sum in a fixed order
// (no atomics: two calls give the same bits).
//   (a) C B^T into an f32 scratch, the forward's kernel (ssd_cb.cuh).
//   (b) One block per (b, c, h): everything whose sums stay inside one
//       head.  For each 64-column tile j of the chunk it forms U = B dS,
//       dw and the dX accumulator w U, then walks the row tiles i >= j:
//       dM = dy X^T, M and D = dM * CB * E into shared memory, dX += M^T dy;
//       D's columns give d dt (and Q's, as dt_j colsum D), its rows times
//       dt give Q's row sums.  Then d cum per row.  256 threads, each a
//       4 x 4 block of the 64 x 64 tile; operands read as float4 where the
//       layout allows (X transposed on its way into shared memory).
//   (c) dCB: one block per 32 x 32 tile on or below the diagonal and per
//       (b, c), dM recomputed (a quarter more products than the function
//       needs; no scratch of per-head partials).  Masked entries are
//       written as zeros.
//   (d) dC and dB: one block per 32 rows and 32 columns of N and per
//       (b, c): dC = dCB B over the tiles left of the diagonal, dB = dCB^T
//       C over those below, then + w (X dS^T) over the heads (depth P a
//       head, w applied to each head's sum).
//   (c) and (d) each run four groups of 64 threads a block, each thread a
//   4 x 4 block of the 32 x 32 tile: one group walking every head leaves
//   too few warps on the card to hide a step's latency.  Group g takes
//   heads (and tiles) g, g + 4, ... under its own named barrier, and the
//   four partial sums are added in group order at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstring>

#include "ssd_cb.cuh"

namespace {

constexpr int kMaxL = 256;      // longest chunk
constexpr int kT = 64;          // (b): rows i, j of a tile; P and N padded
constexpr int kS = kT + 4;      // (b): row stride of a tile, 16-byte rows
constexpr int kThreads = 256;   // (b): 16 x 16 threads, 4 x 4 values each
constexpr int kR = 32;          // (c), (d): output tile
constexpr int kRS = kR + 4;     // (c), (d): row stride, 16-byte rows
constexpr int kRThreads = 64;   // (c), (d): a group of 8 x 8 threads, 4 x 4
                                // values each
constexpr int kGroups = 4;      // (c), (d): head groups a block
constexpr int kGThreads = kGroups * kRThreads;
// (b)'s shared memory: X^T, dy (or a chunk of B), M (or a chunk of dS), D;
// then cum, dt, w, dw, the row sums of Q and the column sums of Q
constexpr int kHeadSmem = (4 * kT * kS + 6 * kMaxL) * 4;

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
  float* dcb;  // (B*NC, Lp, Lp) scratch: dCB, written by (c), read by (d)
  int B, NC, L, H, P, N, Lp;
  long long x_sb, x_sc, x_sl, x_sh;
  long long dt_sb, dt_sc, dt_sl, dt_sh;
  long long cu_sb, cu_sc, cu_sl, cu_sh;
  long long b_sb, b_sc, b_sl;
  long long c_sb, c_sc, c_sl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc (4 x 4) += a (4) outer b (4)
__device__ __forceinline__ void outer(float (&acc)[4][4], const float (&a)[4],
                                      const float4 b) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r][0] = fmaf(a[r], b.x, acc[r][0]);
    acc[r][1] = fmaf(a[r], b.y, acc[r][1]);
    acc[r][2] = fmaf(a[r], b.z, acc[r][2]);
    acc[r][3] = fmaf(a[r], b.w, acc[r][3]);
  }
}

// ------------------------------------------------------ (b) one head a block
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_head_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* xt = reinterpret_cast<float*>(smem4);  // X^T: [p][j]
  float* ys = xt + kT * kS;      // dy: [i][p]   | B chunk: [j][n]
  float* ms = ys + kT * kS;      // M: [i][j]    | dS chunk: [n][p]
  float* dd = ms + kT * kS;      // D: [i][j]
  float* cum_s = dd + kT * kS;
  float* dt_s = cum_s + kMaxL;
  float* w_s = dt_s + kMaxL;
  float* dw_s = w_s + kMaxL;
  float* rowq_s = dw_s + kMaxL;
  float* colq_s = rowq_s + kMaxL;

  const int u = blockIdx.x;
  const int h = u % a.H, bc = u / a.H;
  const int bb = bc / a.NC, cz = bc % a.NC;
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const XT* xh = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc +
                 h * a.x_sh;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;
  const float* dyh = a.dy + (long long)bc * L * H * P + h * P;  // row i: iHP
  const float* dsh = a.ds + ((long long)bc * H + h) * N * P;
  const float* cbm = a.cb + (long long)bc * a.Lp * a.Lp;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  {
    const int l = tid;                       // kThreads == kMaxL
    const float* cuh = a.cum + bb * a.cu_sb + cz * a.cu_sc + h * a.cu_sh;
    const float* dth = a.dt + bb * a.dt_sb + cz * a.dt_sc + h * a.dt_sh;
    cum_s[l] = l < L ? cuh[l * a.cu_sl] : 0.f;
    dt_s[l] = l < L ? dth[l * a.dt_sl] : 0.f;
    dw_s[l] = rowq_s[l] = colq_s[l] = 0.f;
  }
  __syncthreads();
  const float last = cum_s[L - 1];
  w_s[tid] = tid < L ? expf(last - cum_s[tid]) * dt_s[tid] : 0.f;

  const int nlt = (L + kT - 1) / kT;
  for (int jt = 0; jt < nlt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();                         // the last tile's readers done
    // X rows [j0, j0 + 64) transposed: xt[p][j]
#pragma unroll 4
    for (int s = 0; s < kT * kT / kThreads; ++s) {
      const int idx = s * kThreads + tid, j = idx >> 6, p = idx & 63;
      xt[p * kS + j] = (j0 + j < L && p < P)
                           ? to_f32(xh[(j0 + j) * a.x_sl + p]) : 0.f;
    }
    // U = B dS over chunks of 64 of N: rows j = 4ty + r, columns p = 4tx + c
    float acc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += kT) {
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kT * kT / kThreads; ++s) {
        const int idx = s * kThreads + tid, r = idx >> 6, c = idx & 63;
        ys[r * kS + c] = (j0 + r < L && n0 + c < N)
                             ? bm[(j0 + r) * a.b_sl + n0 + c] : 0.f;
        ms[r * kS + c] = (n0 + r < N && c < P) ? dsh[(n0 + r) * P + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kT; ++k) {
        float av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = ys[(4 * ty + r) * kS + k];
        outer(acc, av, ld4(ms + k * kS + 4 * tx));
      }
    }
    // dw_j = sum_p X[j,p] U[j,p], summed over the 16 lanes of a row in a
    // fixed pattern; then the dX accumulator starts at w_j U
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * ty + r;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part = fmaf(xt[(4 * tx + c) * kS + j], acc[r][c], part);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (tx == 0 && j0 + j < L) dw_s[j0 + j] = part;
      const float wj = w_s[j0 + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= wj;
    }

    float cold = 0.f;                        // tid < 64: colsum of D, col j
    for (int it = jt; it < nlt; ++it) {
      const int i0 = it * kT;
      __syncthreads();                       // ys, ms, dd free again
#pragma unroll 4
      for (int s = 0; s < kT * kT / 4 / kThreads; ++s) {
        const int idx = s * kThreads + tid, r = idx >> 4, c = 4 * (idx & 15);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i0 + r < L) {
          const float* src = dyh + (long long)(i0 + r) * H * P + c;
          if (c + 3 < P) {
            v = make_float4(src[0], src[1], src[2], src[3]);
          } else {
            if (c < P) v.x = src[0];
            if (c + 1 < P) v.y = src[1];
            if (c + 2 < P) v.z = src[2];
          }
        }
        *reinterpret_cast<float4*>(ys + r * kS + c) = v;
      }
      __syncthreads();
      // dM: rows i = 4ty + r, columns j = 4tx + c
      float d[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kT; ++k) {
        float av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = ys[(4 * ty + r) * kS + k];
        outer(d, av, ld4(xt + k * kS + 4 * tx));
      }
      // M and D; Q's row sums: sum_j D[i,j] dt_j over the 16 lanes of a row
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        float mv[4], dv[4], rq = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 4 * tx + c;
          const bool keep = i < L && j <= i;   // masked before the exp
          const float ce = keep ? cbm[(long long)i * a.Lp + j] *
                                      expf(cum_s[i] - cum_s[j])
                                : 0.f;
          mv[c] = ce * dt_s[j];
          dv[c] = d[r][c] * ce;
          rq = fmaf(dv[c], dt_s[j], rq);
        }
        *reinterpret_cast<float4*>(ms + (4 * ty + r) * kS + 4 * tx) =
            make_float4(mv[0], mv[1], mv[2], mv[3]);
        *reinterpret_cast<float4*>(dd + (4 * ty + r) * kS + 4 * tx) =
            make_float4(dv[0], dv[1], dv[2], dv[3]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          rq += __shfl_xor_sync(0xffffffffu, rq, o);
        if (tx == 0 && i < L) rowq_s[i] += rq;   // in the order of jt
      }
      __syncthreads();
      if (tid < kT) {
#pragma unroll 8
        for (int r = 0; r < kT; ++r) cold += dd[r * kS + tid];
      }
      // dX (rows j = 4ty + r, columns p = 4tx + c) += M^T dy
#pragma unroll 8
      for (int k = 0; k < kT; ++k) {
        const float4 m4 = ld4(ms + k * kS + 4 * ty);
        const float av[4] = {m4.x, m4.y, m4.z, m4.w};
        outer(acc, av, ld4(ys + k * kS + 4 * tx));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 4 * ty + r;
      if (j >= L) continue;
      XT* out = static_cast<XT*>(a.dx) + (((long long)bc * L + j) * H + h) * P;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * tx + c < P) store(out + 4 * tx + c, acc[r][c]);
    }
    if (tid < kT && j0 + tid < L) {
      const int j = j0 + tid;
      a.ddt[((long long)bc * L + j) * H + h] =
          cold + dw_s[j] * expf(last - cum_s[j]);
      colq_s[j] = cold * dt_s[j];
    }
  }
  __syncthreads();
  if (tid < L) {
    float v = rowq_s[tid] - colq_s[tid] - dw_s[tid] * w_s[tid];
    if (tid == L - 1) {
      float tot = 0.f;
      for (int l = 0; l < L; ++l) tot = fmaf(dw_s[l], w_s[l], tot);
      v += tot;
    }
    a.dcum[((long long)bc * L + tid) * H + h] = v;
  }
}

// Barrier `g + 1` among the kRThreads threads of head group g of (c), (d)
// (barrier 0 is __syncthreads): each group walks its own heads or tiles.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kRThreads) : "memory");
}

// The groups' 4 x 4 sums (each thread's, in red[group][row * kR + col])
// added in group order into the kR x kR tile at out (row stride ld), rows
// below `rows` and columns below `cols` only; every thread of the block
// takes 4 consecutive values of a row.
__device__ __forceinline__ void reduce_groups(const float* red, float* out,
                                              long long ld, int rows,
                                              int cols) {
  const int e = 4 * threadIdx.x, r = e / kR, c = e % kR;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float4 x = ld4(red + g * kR * kR + e);
    v[0] += x.x;
    v[1] += x.y;
    v[2] += x.z;
    v[3] += x.w;
  }
  if (r >= rows) return;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (c + q < cols) out[r * ld + c + q] = v[q];
}

// This thread's 4 x 4 sums into its group's slice of red.
__device__ __forceinline__ void park(float* red, int g, int ty, int tx,
                                     const float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(red + g * kR * kR + (4 * ty + r) * kR +
                               4 * tx) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// --------------------------------------- (c) dCB, four head groups a tile
template <typename XT>
__global__ void __launch_bounds__(kGThreads, 3)
    ssd_bwd_dcb_kernel(const BwdArgs a) {
  // per group: dy rows i [i][p] and X rows j transposed [p][j], P in steps
  // of kR; then cum_i, cum_j, dt_j of its head.  The groups' sums are
  // parked in ys at the end (4 x 32 x 33 >= 4 x 32 x 32 floats).
  __shared__ __align__(16) float ys[kGroups][kR][kR + 1];
  __shared__ __align__(16) float xt[kGroups][kR][kRS];
  __shared__ float ci[kGroups][kR], cj[kGroups][kR], dtj[kGroups][kR];
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = ti * kR, j0 = tj * kR;
  const int bc = blockIdx.y, bb = bc / a.NC, cz = bc % a.NC;
  const int L = a.L, P = a.P, H = a.H;
  const int g = threadIdx.x / kRThreads, tid = threadIdx.x % kRThreads;
  const int ty = tid >> 3, tx = tid & 7;
  const XT* xb = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc;
  const float* dyb = a.dy + (long long)bc * L * H * P;
  const float* cub = a.cum + bb * a.cu_sb + cz * a.cu_sc;
  const float* dtb = a.dt + bb * a.dt_sb + cz * a.dt_sc;

  float acc[4][4] = {};
  for (int h = g; h < H; h += kGroups) {
    float d[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += kR) {
      group_sync(g);                       // the last step's readers done
#pragma unroll 4
      for (int s = 0; s < kR * kR / kRThreads; ++s) {
        const int idx = s * kRThreads + tid, r = idx >> 5, p = idx & 31;
        const bool pin = p0 + p < P;
        ys[g][r][p] = (i0 + r < L && pin)
            ? dyb[((long long)(i0 + r) * H + h) * P + p0 + p] : 0.f;
        xt[g][p][r] = (j0 + r < L && pin)
            ? to_f32(xb[(j0 + r) * a.x_sl + h * a.x_sh + p0 + p]) : 0.f;
      }
      if (p0 == 0 && tid < kR) {
        const int i = i0 + tid, j = j0 + tid;
        ci[g][tid] = i < L ? cub[i * a.cu_sl + h * a.cu_sh] : 0.f;
        cj[g][tid] = j < L ? cub[j * a.cu_sl + h * a.cu_sh] : 0.f;
        dtj[g][tid] = j < L ? dtb[j * a.dt_sl + h * a.dt_sh] : 0.f;
      }
      group_sync(g);
#pragma unroll 8
      for (int k = 0; k < kR; ++k) {
        float av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = ys[g][4 * ty + r][k];
        outer(d, av, ld4(&xt[g][k][4 * tx]));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * tx + c;
        if (i < L && j <= i)               // masked before the exp
          acc[r][c] = fmaf(
              d[r][c] * expf(ci[g][4 * ty + r] - cj[g][4 * tx + c]),
              dtj[g][4 * tx + c], acc[r][c]);
      }
    }
  }
  __syncthreads();                          // every group done with ys
  float* red = &ys[0][0][0];
  park(red, g, ty, tx, acc);
  __syncthreads();
  // the whole tile, masked entries as zeros
  reduce_groups(red, a.dcb + ((long long)bc * a.Lp + i0) * a.Lp + j0, a.Lp,
                kR, kR);
}

// ---------------------------------------- (d) dC and dB, four head groups
template <typename XT>
__global__ void __launch_bounds__(kGThreads, 3)
    ssd_bwd_bc_kernel(const BwdArgs a) {
  // per group: the A operand k-major [k][m] and the B operand [k][n]; the
  // groups' sums of dC are parked in at, of dB in bt, at the end
  __shared__ __align__(16) float at[kGroups][kR][kRS];
  __shared__ __align__(16) float bt[kGroups][kR][kRS];
  __shared__ float ws[kGroups][kR];
  const int nnt = (a.N + kR - 1) / kR;
  const int l0 = (blockIdx.x / nnt) * kR, n0 = (blockIdx.x % nnt) * kR;
  const int lt = l0 / kR, nt = (a.L + kR - 1) / kR;
  const int bc = blockIdx.y, bb = bc / a.NC, cz = bc % a.NC;
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const int g = threadIdx.x / kRThreads, tid = threadIdx.x % kRThreads;
  const int ty = tid >> 3, tx = tid & 7;
  const float* dcb = a.dcb + (long long)bc * a.Lp * a.Lp;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;
  const float* cm = a.cm + bb * a.c_sb + cz * a.c_sc;

  // acc += at[g]^T bt[g] over one depth of 32
  auto product = [&](float (&acc)[4][4]) {
#pragma unroll 8
    for (int k = 0; k < kR; ++k) {
      const float4 a4 = ld4(&at[g][k][4 * ty]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      outer(acc, av, ld4(&bt[g][k][4 * tx]));
    }
  };
  // dC[i,n] = sum_j dCB[i,j] B[j,n] over the tiles j <= i, every fourth
  // tile this group's
  float dc[4][4] = {};
  for (int jt = g; jt <= lt; jt += kGroups) {
    group_sync(g);
#pragma unroll 4
    for (int s = 0; s < kR * kR / kRThreads; ++s) {
      const int idx = s * kRThreads + tid, r = idx >> 5, c = idx & 31;
      const int j = jt * kR + r;
      at[g][c][r] = dcb[(long long)(l0 + r) * a.Lp + jt * kR + c];  // [j][i]
      bt[g][r][c] = (j < L && n0 + c < N) ? bm[j * a.b_sl + n0 + c] : 0.f;
    }
    group_sync(g);
    product(dc);
  }
  // dB[l,n] = sum_i dCB[i,l] C[i,n] over the tiles i >= l
  float db[4][4] = {};
  for (int it = lt + g; it < nt; it += kGroups) {
    group_sync(g);
#pragma unroll 4
    for (int s = 0; s < kR * kR / kRThreads; ++s) {
      const int idx = s * kRThreads + tid, r = idx >> 5, c = idx & 31;
      const int i = it * kR + r;
      at[g][r][c] = dcb[(long long)i * a.Lp + l0 + c];             // [i][l]
      bt[g][r][c] = (i < L && n0 + c < N) ? cm[i * a.c_sl + n0 + c] : 0.f;
    }
    group_sync(g);
    product(db);
  }
  // dB[l,n] += sum_h w_h[l] sum_p X_h[l,p] dS_h[n,p], every fourth head
  // this group's, P in steps of 32
  const XT* xb = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc;
  const float* cub = a.cum + bb * a.cu_sb + cz * a.cu_sc;
  const float* dtb = a.dt + bb * a.dt_sb + cz * a.dt_sc;
  for (int h = g; h < H; h += kGroups) {
    const float* dsh = a.ds + ((long long)bc * H + h) * N * P;
    float t[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += kR) {
      group_sync(g);                       // the last step's readers done
#pragma unroll 4
      for (int s = 0; s < kR * kR / kRThreads; ++s) {
        const int idx = s * kRThreads + tid, r = idx >> 5, c = idx & 31;
        const int p = p0 + c;
        at[g][c][r] = (l0 + r < L && p < P)
            ? to_f32(xb[(l0 + r) * a.x_sl + h * a.x_sh + p]) : 0.f;  // [p][l]
        bt[g][c][r] = (n0 + r < N && p < P) ? dsh[(n0 + r) * P + p]
                                            : 0.f;                   // [p][n]
      }
      if (p0 == 0 && tid < kR) {
        const int l = l0 + tid;
        const float* cuh = cub + h * a.cu_sh;
        ws[g][tid] = l < L ? expf(cuh[(L - 1) * a.cu_sl] - cuh[l * a.cu_sl]) *
                                 dtb[l * a.dt_sl + h * a.dt_sh]
                           : 0.f;
      }
      group_sync(g);
      product(t);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float w = ws[g][4 * ty + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) db[r][c] = fmaf(w, t[r][c], db[r][c]);
    }
  }
  __syncthreads();                          // every group done with at, bt
  park(&at[0][0][0], g, ty, tx, dc);
  park(&bt[0][0][0], g, ty, tx, db);
  __syncthreads();
  const long long row0 = (long long)bc * L + l0;
  reduce_groups(&at[0][0][0], a.dc + row0 * N + n0, N, L - l0, N - n0);
  reduce_groups(&bt[0][0][0], a.db + row0 * N + n0, N, L - l0, N - n0);
}

// Allow (b) its dynamic shared memory, once per device.
template <typename XT>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_bwd_head_kernel<XT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHeadSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename XT>
cudaError_t launch(const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = allow_smem<XT>();
  if (err != cudaSuccess) return err;
  err = launch_cb(a, st);                                        // (a)
  if (err != cudaSuccess) return err;
  const long long heads = (long long)a.B * a.NC * a.H;
  if (heads > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_bwd_head_kernel<XT>                                        // (b)
      <<<static_cast<unsigned>(heads), kThreads, kHeadSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nt = (a.L + kR - 1) / kR, nnt = (a.N + kR - 1) / kR;
  ssd_bwd_dcb_kernel<XT>                                         // (c)
      <<<dim3(nt * (nt + 1) / 2, a.B * a.NC), kGThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_bc_kernel<XT>                                          // (d)
      <<<dim3(nt * nnt, a.B * a.NC), kGThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ptrs: x, dt, cum, B, C, dy, dS, dx, d dt, d cum, dB, dC, the C B^T
// scratch and the dCB scratch; dims: the forward's 25 int64 values (the
// dtype of x, 0 = float32, 1 = bfloat16; B, NC, L, H, P, N; the strides in
// elements of x (4), dt (4), cum (4), B (3) and C (3)).  dy (B, NC, L, H,
// P) and dS (B, NC, H, N, P) are contiguous float32; dx is contiguous in
// x's dtype; d dt and d cum (B, NC, L, H) and dB and dC (B, NC, L, N) are
// contiguous float32; both scratches are float32 of B * NC * Lp * Lp, Lp =
// L rounded up to a multiple of 64.  Returns the CUDA error of the launches
// (0 on success); the kernels run asynchronously on `stream`.
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
               static_cast<int>(B), static_cast<int>(NC),
               static_cast<int>(L), static_cast<int>(H),
               static_cast<int>(P), static_cast<int>(N),
               static_cast<int>((L + kT - 1) / kT * kT),
               d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13], d[14],
               d[15], d[16], d[17], d[18], d[19], d[20], d[21],
               d[22], d[23], d[24]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(a, s)
                                     : launch<__nv_bfloat16>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
