// Backward of the grouped expert FFN for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// The TPU kernel src/repro/kernels/moe_gmm/kernel.py::_gmm_kernel
// (grouped_ffn_pallas) has no backward: jax.grad differentiates the plain
// einsums of the reference path.  This is the backward of the function that
// kernel and moe_gmm.cu compute: with X = buf[b, e] gathered over the batch
// into the R = B*C rows of expert e, A = X W_in[e], G = X W_gate[e], dY the
// output's cotangent and s = sigmoid(G),
//     swiglu:  H = silu(G) * A,  dH = dY W_out[e]^T,
//              dA = dH * silu(G),  dG = dH * A * s * (1 + G (1 - s))
//     gelu:    H = gelu_tanh(A), dA = dH * gelu_tanh'(A), no dG
//     dX = dA W_in^T + dG W_gate^T,  dW_in = X^T dA,  dW_gate = X^T dG,
//     dW_out = H^T dY,
// each weight gradient summed over all R rows of its expert, f32 sums, the
// results in the inputs' dtype.
//
// Liveness.  A first launch scans the rows on the card (gmm_common.cuh) and
// lists the experts with a live row; no count comes back to the host.  The
// rule differs from the forward's: for swiglu a zero X row gives exact zero
// contributions to every gradient whatever dY holds (A = G = 0, silu(0) =
// 0), so a row is live if its X row is nonzero; for gelu gelu'(0) = 1/2, so
// a zero X row with a nonzero dY row has a nonzero dX row: a row is live if
// its X row or its dY row is nonzero.  dX is zero-filled by the caller, so
// rows of dead experts stay exact zeros; the weight-gradient pass writes
// the tiles of dead experts as zeros itself (no 4 GB memset at llama4).
//
// Passes (one launch each after the scan):
//   (1) hidden:  units (live expert, 64 rows, 128 F columns), reduction over
//       D.  A, G and dH from one walk over X and dY; the epilogue writes H =
//       act(A, G) (rounded to bf16, as the forward rounds it), dA and dG into
//       (E, R, F) scratch.  The two up products are recomputed, not saved,
//       so the forward keeps no activation (remat "full" keeps memory as the
//       reference's).
//   (2) dX:  units (live expert, 64 rows, 128 D columns), reduction over 2F:
//       dA against W_in^T, then dG against W_gate^T; written into dbuf
//       (B, E, C, D) through its strides.
//   (3) weights:  units (expert, which of the three, 128 x 128 output tile),
//       reduction over the expert's R rows in ascending order, the row
//       operand read transposed.  Each output tile has one owner: no split,
//       no atomics, every sum in a fixed order, so two calls give the same
//       bits.
// bfloat16: each unit is one block of 8 warps running mma.sync m16n8k16
// (bf16 in, f32 accumulate) with fragments from ldmatrix, fed by a 4-stage
// cp.async ring.  Weights are read K-contiguous where the product needs
// their transpose (W_out in (1), W_in and W_gate in (2)): those tiles are
// kept as [n][k] in shared memory and loaded without .trans.  float32 (the
// tests' dtype): one thread per output element, its sum in order on FMAs,
// H in f32; exact to the order of sums.
//
// What bounds it on an H100.  At llama4-scout's training shape (buf (2, 16,
// 160, 5120), F 8192, bf16, all 16 experts live with 320 rows each) the
// gradient needs six products of 2 * 320 * 5120 * 8192 flops per expert:
// 2.577 TFLOP, 2.61 ms at 989 TFLOP/s.  Its bytes (three weights read,
// three gradients written, buf, dY and dX) are about 8.21 GB, 2.45 ms at
// 3.35 TB/s: bound by operations.  This design recomputes A and G, two
// products more (its own floor 3.47 ms), and moves its (E, R, F) scratch
// (252 MB written, read twice) through memory.  It is simple first: mma.sync
// rather than wgmma, one unit a block, no split of the reduction when few
// experts are live.
#include "gmm_common.cuh"

namespace {

// Everything a pass needs.  Strides are in elements; the weights' last dim
// and the scratch are contiguous, the gradients of the weights contiguous.
struct Bwd {
  const void* x;   long long x_se, x_sb, x_sc;     // buf (B, E, C, D)
  const void* dy;  long long dy_se, dy_sb, dy_sc;  // (B, E, C, D)
  const void* wi;  long long wi_se, wi_sk;         // (E, D, F)
  const void* wg;  long long wg_se, wg_sk;         // (E, D, F)
  const void* wo;  long long wo_se, wo_sk;         // (E, F, D)
  void* h;  void* da;  void* dg;                   // (E, R, F) scratch
  void* dx;  long long dx_se, dx_sb, dx_sc;        // (B, E, C, D)
  void* dwi;  void* dwg;  void* dwo;               // (E, D, F), (E, F, D)
  int R, C, D, F, E;
  Live live;
};

// the scratch's row r of expert e
__device__ __forceinline__ long long scratch_off(const Bwd& p, int e, int r) {
  return ((long long)e * p.R + r) * p.F;
}

template <int ACT>
struct Hidden {   // H, dA, dG at one element from A, G, dH
  float h, da, dg;
  __device__ __forceinline__ Hidden(float a, float g, float dh) {
    if (ACT == kSwiglu) {
      const float s = 1.f / (1.f + expf(-g));
      const float silu = g * s;
      h = epilogue<kSwiglu>(a, g);
      da = dh * silu;
      dg = dh * a * s * (1.f + g * (1.f - s));
    } else {
      constexpr float kC = 0.7978845608028654f, kA = 0.044715f;
      const float t = tanhf(kC * (a + kA * a * a * a));
      h = epilogue<kGelu>(a, 0.f);
      da = dh * (0.5f * (1.f + t) +
                 0.5f * a * (1.f - t * t) * kC * (1.f + 3.f * kA * a * a));
      dg = 0.f;
    }
  }
};

// ===================================================== bfloat16: mma.sync
namespace bf16 {

constexpr int kBK = 32;            // reduction step
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kBN = 128;           // output columns per unit
constexpr int kLDK = kBK + kPad;   // a [row][k] tile's row
constexpr int kLDN = kBN + kPad;   // a [k][n] tile's row

using bf = __nv_bfloat16;

// The standard ring: kStages - 1 steps in flight ahead of the one computed;
// every step commits one group (empty past the end).  load(stage, step)
// starts a step's copies, compute(stage) consumes one.
template <typename Load, typename Compute>
__device__ __forceinline__ void ring(int steps, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_wait<kStages - 2>();    // step k's tiles have landed
    __syncthreads();           // for all threads; the oldest stage is free
    const int next = k + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_commit();
    compute(k % kStages);
  }
  cp_wait<0>();
}

// A fragment (16 x 16) of rows [r0, r0 + 16) from a [row][k] tile
__device__ __forceinline__ void frag_a(const bf* t, int ld, int r0, int k0,
                                      unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(t + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8, f);
}

// A fragment of rows [m0, m0 + 16) from a [k][m] tile (the operand stored
// transposed)
__device__ __forceinline__ void frag_a_t(const bf* t, int ld, int m0, int k0,
                                        unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                    ((lane >> 3) & 1) * 8,
                f);
}

// B fragments of columns [n0, n0 + 16) (two n8 blocks: f[0..1], f[2..3])
// from a [k][n] tile
__device__ __forceinline__ void frag_b(const bf* t, int ld, int n0, int k0,
                                      unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(t + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8, f);
}

// the same from an [n][k] tile (a K-contiguous operand)
__device__ __forceinline__ void frag_b_t(const bf* t, int ld, int n0, int k0,
                                        unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
              ((lane >> 3) & 1) * 8,
          f);
}

// Copy a (rows, kBK) slice of a row-gathered operand into a [row][k] tile:
// row r of expert e at base + row_off(r), columns [k0, k0 + kBK) of K.
__device__ __forceinline__ void load_rows(bf* dst, const bf* base, int C,
                                          long long se, long long sb,
                                          long long sc, int e, int r0,
                                          int R, int k0, int K) {
  constexpr int kChunks = kBK / 8;
#pragma unroll
  for (int it = 0; it < kBM * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = r0 + r, k = k0 + c * 8;
    const bool ok = row < R && k < K;
    cp16(dst + r * kLDK + c * 8,
         ok ? base + row_off(row, C, se, sb, sc, e) + k : base, ok);
  }
}

// Copy rows [k0, k0 + kBK) x columns [n0, n0 + kBN) of a (K, N) matrix with
// row stride sk (N contiguous) into a [k][n] tile.
__device__ __forceinline__ void load_kn(bf* dst, const bf* base,
                                        long long sk, int k0, int K, int n0,
                                        int N) {
  constexpr int kChunks = kBN / 8;
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const int k = k0 + r, n = n0 + c * 8;
    const bool ok = k < K && n < N;
    cp16(dst + r * kLDN + c * 8, ok ? base + k * sk + n : base, ok);
  }
}

// Copy columns [n0, n0 + kBN) x rows [k0, k0 + kBK) of the transpose of an
// (N, K) matrix with row stride sn (K contiguous) into an [n][k] tile.
__device__ __forceinline__ void load_nk(bf* dst, const bf* base,
                                        long long sn, int n0, int N, int k0,
                                        int K) {
  constexpr int kChunks = kBK / 8;
#pragma unroll
  for (int it = 0; it < kBN * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const int n = n0 + r, k = k0 + c * 8;
    const bool ok = n < N && k < K;
    cp16(dst + r * kLDK + c * 8, ok ? base + n * sn + k : base, ok);
  }
}

// ------------------------------------------------------------ (1) hidden
template <int ACT>
struct HiddenTiles {
  static constexpr int kRows = kBM * kLDK;          // X or dY tile
  static constexpr int kKN = kBK * kLDN;            // W_in or W_gate tile
  static constexpr int kNK = kBN * kLDK;            // W_out^T tile
  static constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  static constexpr int kStage = 2 * kRows + kMats * kKN + kNK;
};

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1) hidden_pass(const Bwd p) {
  using T = HiddenTiles<ACT>;
  constexpr int kMats = T::kMats;
  constexpr int kMT = kBM / 16;
  extern __shared__ uint4 smem_raw[];
  bf* smem = reinterpret_cast<bf*>(smem_raw);

  const int n_mt = (p.R + kBM - 1) / kBM, n_nt = (p.F + kBN - 1) / kBN;
  const int mt = blockIdx.x % n_mt, nt = (blockIdx.x / n_mt) % n_nt;
  const int li = blockIdx.x / (n_mt * n_nt);
  if (li >= p.live.n_live()) return;               // the whole block
  const int e = p.live.expert(li);
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3, wn = warp * 16;
  const bf* x = static_cast<const bf*>(p.x);
  const bf* dy = static_cast<const bf*>(p.dy);
  const bf* wi = static_cast<const bf*>(p.wi) + e * p.wi_se;
  const bf* wg = static_cast<const bf*>(p.wg) + e * p.wg_se;
  const bf* wo = static_cast<const bf*>(p.wo) + e * p.wo_se;

  float acc[kMats + 1][kMT][2][4] = {};            // A, (G,) dH
  auto load = [&](int stage, int step) {
    bf* st = smem + stage * T::kStage;
    const int k0 = step * kBK;
    load_rows(st, x, p.C, p.x_se, p.x_sb, p.x_sc, e, m0, p.R, k0, p.D);
    load_rows(st + T::kRows, dy, p.C, p.dy_se, p.dy_sb, p.dy_sc, e, m0,
              p.R, k0, p.D);
    load_kn(st + 2 * T::kRows, wi, p.wi_sk, k0, p.D, n0, p.F);
    if (kMats == 2)
      load_kn(st + 2 * T::kRows + T::kKN, wg, p.wg_sk, k0, p.D, n0, p.F);
    load_nk(st + 2 * T::kRows + kMats * T::kKN, wo, p.wo_sk, n0, p.F, k0,
            p.D);
  };
  const int rows = p.R - m0;                       // block-uniform
  auto compute = [&](int stage) {
    const bf* st = smem + stage * T::kStage;
    const bf* xs = st;
    const bf* ys = st + T::kRows;
    const bf* ws = st + 2 * T::kRows;
    const bf* os = ws + kMats * T::kKN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned bw[kMats][4], bo[4];
#pragma unroll
      for (int m = 0; m < kMats; ++m)
        frag_b(ws + m * T::kKN, kLDN, wn, kk, bw[m]);
      frag_b_t(os, kLDK, wn, kk, bo);
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        if (t * 16 >= rows) break;
        unsigned af[4];
        frag_a(xs, kLDK, t * 16, kk, af);
#pragma unroll
        for (int m = 0; m < kMats; ++m) {
          mma(acc[m][t][0], af, bw[m][0], bw[m][1]);
          mma(acc[m][t][1], af, bw[m][2], bw[m][3]);
        }
        frag_a(ys, kLDK, t * 16, kk, af);
        mma(acc[kMats][t][0], af, bo[0], bo[1]);
        mma(acc[kMats][t][1], af, bo[2], bo[3]);
      }
    }
  };
  ring((p.D + kBK - 1) / kBK, load, compute);

  bf* hs = static_cast<bf*>(p.h);
  bf* das = static_cast<bf*>(p.da);
  bf* dgs = static_cast<bf*>(p.dg);
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + t * 16 + g + hf * 8;
        const int col = n0 + wn + n * 8 + tig * 2;   // even; F % 8 == 0
        if (row >= p.R || col >= p.F) continue;
        const int i = 2 * hf;
        const Hidden<ACT> v0(acc[0][t][n][i], acc[kMats - 1][t][n][i],
                             acc[kMats][t][n][i]);
        const Hidden<ACT> v1(acc[0][t][n][i + 1], acc[kMats - 1][t][n][i + 1],
                             acc[kMats][t][n][i + 1]);
        const long long o = scratch_off(p, e, row) + col;
        *reinterpret_cast<__nv_bfloat162*>(hs + o) =
            __floats2bfloat162_rn(v0.h, v1.h);
        *reinterpret_cast<__nv_bfloat162*>(das + o) =
            __floats2bfloat162_rn(v0.da, v1.da);
        if (ACT == kSwiglu)
          *reinterpret_cast<__nv_bfloat162*>(dgs + o) =
              __floats2bfloat162_rn(v0.dg, v1.dg);
      }
}

// ---------------------------------------------------------------- (2) dX
constexpr int kDxStage = kBM * kLDK + kBN * kLDK;  // dA or dG, W^T

template <int kMats>
__global__ void __launch_bounds__(kThreads, 2) dx_pass(const Bwd p) {
  constexpr int kMT = kBM / 16;
  extern __shared__ uint4 smem_raw[];
  bf* smem = reinterpret_cast<bf*>(smem_raw);

  const int n_mt = (p.R + kBM - 1) / kBM, n_nt = (p.D + kBN - 1) / kBN;
  const int mt = blockIdx.x % n_mt, nt = (blockIdx.x / n_mt) % n_nt;
  const int li = blockIdx.x / (n_mt * n_nt);
  if (li >= p.live.n_live()) return;
  const int e = p.live.expert(li);
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3, wn = warp * 16;
  const int ksteps = (p.F + kBK - 1) / kBK;
  // the scratch as a row-gathered operand: (E, R, F) with se = R F, rows
  // r = b C + c at b C F + c F
  const long long s_se = (long long)p.R * p.F, s_sb = (long long)p.C * p.F;

  float acc[kMT][2][4] = {};
  auto load = [&](int stage, int step) {
    bf* st = smem + stage * kDxStage;
    const int m = step / ksteps, k0 = (step % ksteps) * kBK;
    const bf* a = static_cast<const bf*>(m ? p.dg : p.da);
    const bf* w = static_cast<const bf*>(m ? p.wg : p.wi) +
                  e * (m ? p.wg_se : p.wi_se);
    load_rows(st, a, p.C, s_se, s_sb, p.F, e, m0, p.R, k0, p.F);
    load_nk(st + kBM * kLDK, w, m ? p.wg_sk : p.wi_sk, n0, p.D, k0, p.F);
  };
  const int rows = p.R - m0;
  auto compute = [&](int stage) {
    const bf* as = smem + stage * kDxStage;
    const bf* ws = as + kBM * kLDK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned bw[4];
      frag_b_t(ws, kLDK, wn, kk, bw);
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        if (t * 16 >= rows) break;
        unsigned af[4];
        frag_a(as, kLDK, t * 16, kk, af);
        mma(acc[t][0], af, bw[0], bw[1]);
        mma(acc[t][1], af, bw[2], bw[3]);
      }
    }
  };
  ring(kMats * ksteps, load, compute);

  bf* dx = static_cast<bf*>(p.dx);
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + t * 16 + g + hf * 8;
        const int col = n0 + wn + n * 8 + tig * 2;   // even; D % 8 == 0
        if (row >= p.R || col >= p.D) continue;
        *reinterpret_cast<__nv_bfloat162*>(
            dx + row_off(row, p.C, p.dx_se, p.dx_sb, p.dx_sc, e) + col) =
            __floats2bfloat162_rn(acc[t][n][2 * hf], acc[t][n][2 * hf + 1]);
      }
}

// ----------------------------------------------------------- (3) weights
// O[e] (M, N) = P[e]^T Q[e], P (R, M) and Q (R, N) row-gathered; 128 x 128
// tiles, warps 2 (rows) x 4 (columns) of 64 x 32 each.  Two blocks an SM
// (ptxas then keeps it at 128 registers, no spills): at llama4's 320 rows a
// unit has only 10 reduction steps, and a second block hides the first's
// ring fill and epilogue (the backward 26.0 -> 22.5 ms on an H100).
constexpr int kWM = 128;
constexpr int kLDM = kWM + kPad;
constexpr int kDwStage = kBK * kLDM + kBK * kLDN;

// Operand `which` of expert e's weight gradient: 0 dW_in = X^T dA, 1
// dW_gate = X^T dG, 2 dW_out = H^T dY.  Rows of an (E, R, F) scratch have
// se = R F, sb = C F, sc = F.
struct Operand {
  const bf* base;
  long long se, sb, sc;
  int cols;
};

__device__ __forceinline__ void operands(const Bwd& p, int which, Operand& a,
                                         Operand& b) {
  const long long s_se = (long long)p.R * p.F, s_sb = (long long)p.C * p.F;
  const Operand x{static_cast<const bf*>(p.x), p.x_se, p.x_sb, p.x_sc, p.D};
  const Operand dy{static_cast<const bf*>(p.dy), p.dy_se, p.dy_sb, p.dy_sc,
                   p.D};
  const Operand da{static_cast<const bf*>(p.da), s_se, s_sb, p.F, p.F};
  const Operand dg{static_cast<const bf*>(p.dg), s_se, s_sb, p.F, p.F};
  const Operand h{static_cast<const bf*>(p.h), s_se, s_sb, p.F, p.F};
  a = which == 2 ? h : x;
  b = which == 0 ? da : which == 1 ? dg : dy;
}

// Copy rows [k0, k0 + kBK) of the R gathered rows x columns [c0, c0 + W)
// of an operand into a [k][c] tile of row length ld.
template <int W>
__device__ __forceinline__ void load_cols(bf* dst, int ld, const Operand& o,
                                          int C, int e, int k0, int R,
                                          int c0) {
  constexpr int kChunks = W / 8;
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = k0 + r, col = c0 + c * 8;
    const bool ok = row < R && col < o.cols;
    cp16(dst + r * ld + c * 8,
         ok ? o.base + row_off(row, C, o.se, o.sb, o.sc, e) + col : o.base,
         ok);
  }
}

template <int kWhich>   // 3 (swiglu: in, gate, out) or 2 (gelu: in, out)
__global__ void __launch_bounds__(kThreads, 2) dw_pass(const Bwd p) {
  extern __shared__ uint4 smem_raw[];
  bf* smem = reinterpret_cast<bf*>(smem_raw);

  const int td = (p.D + kWM - 1) / kWM, tf = (p.F + kBN - 1) / kBN;
  const int tiles = td * tf;           // the same count for (D,F) and (F,D)
  const int tile = blockIdx.x % tiles;
  const int sel = (blockIdx.x / tiles) % kWhich;
  const int e = blockIdx.x / (tiles * kWhich);
  const int which = kWhich == 3 ? sel : 2 * sel;
  const int M = which == 2 ? p.F : p.D, N = which == 2 ? p.D : p.F;
  const int n_nt = (N + kBN - 1) / kBN;
  const int m0 = (tile / n_nt) * kWM, n0 = (tile % n_nt) * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  bf* out = static_cast<bf*>(which == 0 ? p.dwi : which == 1 ? p.dwg : p.dwo)
            + (long long)e * M * N;

  float acc[4][4][4] = {};             // 4 row tiles x 4 n8 blocks
  if (p.live.rows(e) > 0) {            // else the tile is written as zeros
    Operand a, b;
    operands(p, which, a, b);
    auto load = [&](int stage, int step) {
      bf* st = smem + stage * kDwStage;
      load_cols<kWM>(st, kLDM, a, p.C, e, step * kBK, p.R, m0);
      load_cols<kBN>(st + kBK * kLDM, kLDN, b, p.C, e, step * kBK, p.R, n0);
    };
    auto compute = [&](int stage) {
      const bf* as = smem + stage * kDwStage;
      const bf* bs = as + kBK * kLDM;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        unsigned bf_[2][4];
        frag_b(bs, kLDN, wn, kk, bf_[0]);
        frag_b(bs, kLDN, wn + 16, kk, bf_[1]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          unsigned af[4];
          frag_a_t(as, kLDM, wm + t * 16, kk, af);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma(acc[t][2 * j], af, bf_[j][0], bf_[j][1]);
            mma(acc[t][2 * j + 1], af, bf_[j][2], bf_[j][3]);
          }
        }
      }
    };
    ring((p.R + kBK - 1) / kBK, load, compute);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm + t * 16 + g + hf * 8;
        const int col = n0 + wn + n * 8 + tig * 2;   // even; N % 8 == 0
        if (row >= M || col >= N) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[t][n][2 * hf], acc[t][n][2 * hf + 1]);
      }
}

template <typename K>
cudaError_t launch(K kernel, long long blocks, size_t smem, const Bwd& p,
                   cudaStream_t st) {
  if (blocks <= 0) return cudaSuccess;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t run(const Bwd& p, cudaStream_t st) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  const long long n_mt = (p.R + kBM - 1) / kBM;
  const long long n_ft = (p.F + kBN - 1) / kBN;
  const long long n_dt = (p.D + kBN - 1) / kBN;
  const size_t b = sizeof(bf) * kStages;
  cudaError_t err = launch(hidden_pass<ACT>, p.E * n_mt * n_ft,
                           b * HiddenTiles<ACT>::kStage, p, st);
  if (err == cudaSuccess)
    err = launch(dx_pass<kMats>, p.E * n_mt * n_dt, b * kDxStage, p, st);
  if (err == cudaSuccess)
    err = launch(dw_pass<kMats + 1>,
                 (long long)p.E * (kMats + 1) * ((p.D + kWM - 1) / kWM) *
                     n_ft,
                 b * kDwStage, p, st);
  return err;
}

}  // namespace bf16

// ======================================================= float32: FMAs
// One thread per output element, its sum in order.  Blocks past the live
// list's length exit.
namespace f32 {

template <int ACT>
__global__ void __launch_bounds__(kThreads) hidden_pass(const Bwd p) {
  if ((int)blockIdx.y >= p.live.n_live()) return;
  const int e = p.live.expert(blockIdx.y);
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)p.R * p.F) return;
  const int r = (int)(i / p.F), f = (int)(i % p.F);
  const float* x = static_cast<const float*>(p.x) +
                   row_off(r, p.C, p.x_se, p.x_sb, p.x_sc, e);
  const float* dy = static_cast<const float*>(p.dy) +
                    row_off(r, p.C, p.dy_se, p.dy_sb, p.dy_sc, e);
  const float* wi = static_cast<const float*>(p.wi) + e * p.wi_se + f;
  const float* wg = static_cast<const float*>(p.wg) + e * p.wg_se + f;
  const float* wo = static_cast<const float*>(p.wo) + e * p.wo_se +
                    f * p.wo_sk;
  float a = 0.f, g = 0.f, dh = 0.f;
  for (int d = 0; d < p.D; ++d) {
    a = fmaf(x[d], wi[d * p.wi_sk], a);
    if (ACT == kSwiglu) g = fmaf(x[d], wg[d * p.wg_sk], g);
    dh = fmaf(dy[d], wo[d], dh);
  }
  const Hidden<ACT> v(a, g, dh);
  const long long o = scratch_off(p, e, r) + f;
  static_cast<float*>(p.h)[o] = v.h;
  static_cast<float*>(p.da)[o] = v.da;
  if (ACT == kSwiglu) static_cast<float*>(p.dg)[o] = v.dg;
}

template <int kMats>
__global__ void __launch_bounds__(kThreads) dx_pass(const Bwd p) {
  if ((int)blockIdx.y >= p.live.n_live()) return;
  const int e = p.live.expert(blockIdx.y);
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)p.R * p.D) return;
  const int r = (int)(i / p.D), d = (int)(i % p.D);
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < kMats; ++m) {
    const float* a = static_cast<const float*>(m ? p.dg : p.da) +
                     scratch_off(p, e, r);
    const float* w = static_cast<const float*>(m ? p.wg : p.wi) +
                     e * (m ? p.wg_se : p.wi_se) +
                     d * (m ? p.wg_sk : p.wi_sk);
    for (int f = 0; f < p.F; ++f) s = fmaf(a[f], w[f], s);
  }
  static_cast<float*>(p.dx)[row_off(r, p.C, p.dx_se, p.dx_sb, p.dx_sc, e) +
                            d] = s;
}

template <int kWhich>
__global__ void __launch_bounds__(kThreads) dw_pass(const Bwd p) {
  const int e = blockIdx.y;
  const int which = kWhich == 3 ? (int)blockIdx.z : 2 * (int)blockIdx.z;
  const int M = which == 2 ? p.F : p.D, N = which == 2 ? p.D : p.F;
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  float s = 0.f;
  if (p.live.rows(e) > 0) {
    const long long s_se = (long long)p.R * p.F, s_sb = (long long)p.C * p.F;
    const float* scr = static_cast<const float*>(
        which == 0 ? p.da : which == 1 ? p.dg : p.h);
    for (int r = 0; r < p.R; ++r) {
      const long long xo = row_off(r, p.C, p.x_se, p.x_sb, p.x_sc, e);
      const long long so = row_off(r, p.C, s_se, s_sb, p.F, e);
      if (which == 2)
        s = fmaf(scr[so + m],
                 static_cast<const float*>(p.dy)[row_off(
                     r, p.C, p.dy_se, p.dy_sb, p.dy_sc, e) + n],
                 s);
      else
        s = fmaf(static_cast<const float*>(p.x)[xo + m], scr[so + n], s);
    }
  }
  float* out = static_cast<float*>(which == 0 ? p.dwi
                                   : which == 1 ? p.dwg : p.dwo);
  out[(long long)e * M * N + i] = s;
}

template <int ACT>
cudaError_t run(const Bwd& p, cudaStream_t st) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  auto blocks = [](long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
  };
  hidden_pass<ACT><<<dim3(blocks((long long)p.R * p.F), p.E), kThreads, 0,
                     st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dx_pass<kMats><<<dim3(blocks((long long)p.R * p.D), p.E), kThreads, 0,
                   st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_pass<kMats + 1><<<dim3(blocks((long long)p.D * p.F), p.E, kMats + 1),
                       kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// dims (int64): dtype (0 float32, 1 bfloat16), act (1 swiglu, 2 gelu), B,
// E, C, D, F, then the strides of buf (b, e, c), dy (b, e, c), w_in (e, d),
// w_gate (e, d), w_out (e, f) and dbuf (b, e, c), in elements.  h, da, dg:
// (E, B*C, F) scratch of buf's dtype (dg unused for gelu); ws: int32 of 2 +
// 2E, zero-filled; dbuf zero-filled; dw_in, dw_gate (swiglu only), dw_out
// contiguous.  For bfloat16 every row must start 16-byte aligned and D, F
// must be multiples of 8 (checked by the wrapper).  Returns the CUDA error
// of the launches (0 on success); the kernels run asynchronously on
// `stream`.
extern "C" int moe_gmm_bwd(const void* buf, const void* w_in,
                           const void* w_gate, const void* w_out,
                           const void* dy, void* h, void* da, void* dg,
                           int* ws, void* dbuf, void* dw_in, void* dw_gate,
                           void* dw_out, const long long* dims,
                           void* stream) {
  const int dtype = (int)dims[0], act = (int)dims[1];
  if ((dtype != 0 && dtype != 1) || (act != kSwiglu && act != kGelu))
    return static_cast<int>(cudaErrorInvalidValue);
  const int B = (int)dims[2], E = (int)dims[3], C = (int)dims[4],
            D = (int)dims[5], F = (int)dims[6];
  const long long* s = dims + 7;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bwd p{buf,   s[1],  s[0],   s[2],  dy,     s[4],  s[3],  s[5],
              w_in,  s[6],  s[7],   w_gate, s[8],  s[9],  w_out, s[10],
              s[11], h,     da,     dg,    dbuf,   s[13], s[12], s[14],
              dw_in, dw_gate, dw_out, B * C, C,    D,     F,     E,
              Live{ws, E}};
  // gelu: a zero X row with a nonzero dY row has a nonzero dX row
  cudaError_t err = launch_scan(dtype, buf, s[0], s[1], s[2],
                                act == kGelu ? dy : nullptr, s[3], s[4],
                                s[5], B, E, C, D, ws, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 1)
    err = act == kSwiglu ? bf16::run<kSwiglu>(p, st) : bf16::run<kGelu>(p, st);
  else
    err = act == kSwiglu ? f32::run<kSwiglu>(p, st) : f32::run<kGelu>(p, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
