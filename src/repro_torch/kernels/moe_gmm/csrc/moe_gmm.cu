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
// The skip.  A row of buf whose values are all zero gives an output row of
// exact zeros for finite weights: X W = 0, silu(0) * 0 = 0, gelu(0) = 0,
// 0 W_out = 0.  The MoE dispatch fills only the capacity slots that a token
// took, so at decode (4 slots of one token, top-1, 16 experts) at most 4
// of the 16 experts hold a live row.  A first launch scans buf on the card
// and writes, per expert, its number of live rows, and the list of live
// experts in order with its length; no count comes back to the host.  The
// products then read the weights of live experts only.  out is zero-filled
// by the caller, so the rows of dead experts stay exact zeros, and the dead
// rows of live experts come out as exact zeros from the arithmetic.
//
// Design.  The Pallas grid is (B, E, F / bf): it keeps the (C, D) output
// in VMEM and sums it over a sequential F axis.  On the card a (C, D) f32
// accumulator at D = 5120 does not fit one block, so one call runs
//   (0) scan:  live rows per expert, and the live-expert list;
//   (a) up:    H[e] = act(X[e] W_in[e], X[e] W_gate[e]), the activation
//              fused into the epilogue, into an (E, B*C, F) scratch;
//   (b) down:  out[b, e] = H[e] W_out[e].
// X[e] gathers the B*C rows of expert e from every batch row through the
// strides, so each weight tile is read from memory once per call.
//   * bfloat16 (the serving path): each product is one persistent grid, one
//     or two blocks an SM, that walks work units (live expert, row tile of 64, tile
//     of 128 output columns, k-split) in a fixed order.  When few experts
//     are live, the reduction dim is split (splits x live experts <= 16) so
//     that 1 to 4 live experts still give every SM work; each split writes
//     f32 partials, and a second pass sums them in split order (the same
//     sum on every run) and applies the epilogue.  Weight and row tiles
//     stream through a 4-stage cp.async ring, so each SM keeps three steps
//     (96 KB of weights) in flight; the ring runs on across unit bounds.
//     Eight warps, each owning 16 output columns for all 64 rows, run
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) with fragments from
//     ldmatrix.  H is rounded to bf16 before (b), as the JAX ref path's bf16
//     hidden activation is.
//   * float32 (the tests' dtype): f32 FMAs, which keep results exact to the
//     order of sums (TF32 tensor cores would not); one block per (tile of 64
//     columns, live-list entry), blocks past the list's length exit; H f32.
//
// What bounds it on an H100.  Counting each input read once and each output
// written once, over the experts the data makes live: at llama4-scout (E 16,
// D 5120, F 8192, bf16) an expert's weights are 3 D F x 2 bytes = 252 MB.
// At the served decode with 4 live experts the call must move 1.012 GB
// (their weights, buf and out): 0.302 ms at 3.35 TB/s; with all 16 live,
// 4.032 GB, 1.2035 ms.  The tensor-core work (0.065 ms at decode, 0.212 ms
// at a 663-token prefill, for all experts) is far below that: bound by
// bytes.  What the design does about it: no weight byte of a dead expert is
// read, every weight byte of a live one crosses once, the ring keeps enough
// bytes in flight per SM to approach the memory rate, and the split keeps
// all SMs streaming at any live count.  The split partials and H are the
// only extra traffic: 46 MB written and read back at decode with 4 live
// experts (4 splits each), under 5 % of the call's bytes.
#include "gmm_common.cuh"

namespace {

constexpr int kSlots = 16;         // live experts x splits when split

// One grouped product: for each live expert e, O[e] = epi(A[e] W0[e],
// A[e] W1[e]) with A[e] (R, K), W (K, N), O[e] (R, N).  Row r of expert e
// lives at base + e * se + (r / C) * sb + (r % C) * sc, so a (B, E, C, *)
// tensor and an (E, B*C, *) one are addressed alike.
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
  float* part;                     // (kSlots, mats, R, N) split partials
  Live live;
};

// ===================================================== bfloat16: mma.sync
namespace bf16 {

constexpr int kBN = 128;           // output columns per unit: 16 per warp
constexpr int kLDW = kBN + kPad;

// Tiles of a product with kMats weight matrices (2: the swiglu up product,
// 1: gelu's and the down product): the reduction step, the depth of the
// cp.async ring and the most blocks an SM holds.  The one-matrix ring (106
// KB) leaves room for two blocks an SM, the swiglu product's (172 KB) one.
template <int kMats>
struct Tiles {
  static constexpr int kBK = 64;
  static constexpr int kStages = 4;
  static constexpr int kMaxBlocks = kMats == 1 ? 2 : 1;
  static constexpr int kLDA = kBK + kPad;
  static constexpr int kAElems = kBM * kLDA;
  static constexpr int kWElems = kBK * kLDW;
  static constexpr int kStage = kAElems + kMats * kWElems;   // elements
};

// How a product is cut into units; the same on every block and in the
// reduction pass, from the live count alone.
struct Plan {
  int n_live, ks, span, n_mt, n_nt, units;  // span: k-steps per split
};

template <int kMats>
__device__ __forceinline__ Plan plan_of(const Gemm& p) {
  constexpr int kBK = Tiles<kMats>::kBK;
  Plan pl;
  pl.n_live = p.live.n_live();
  pl.n_mt = (p.R + kBM - 1) / kBM;
  pl.n_nt = (p.N + kBN - 1) / kBN;
  const int steps = (p.K + kBK - 1) / kBK;
  // split only when the expert's rows fit one row tile, so the partials
  // stay small (moe_gmm_partial_floats)
  int ks = pl.n_mt == 1 && pl.n_live > 0 ? kSlots / pl.n_live : 1;
  ks = max(1, min(ks, steps));
  pl.span = (steps + ks - 1) / ks;
  pl.ks = (steps + pl.span - 1) / pl.span;   // no empty split
  pl.units = pl.n_live * pl.n_mt * pl.n_nt * pl.ks;
  return pl;
}

struct Unit {
  int li, e, m0, n0, split, k0, k1, nk;   // [k0, k1), nk reduction steps
};

template <int kMats>
__device__ __forceinline__ Unit unit_of(const Gemm& p, const Plan& pl,
                                        int u) {
  constexpr int kBK = Tiles<kMats>::kBK;
  Unit t;
  t.split = u % pl.ks;
  int rest = u / pl.ks;
  t.n0 = (rest % pl.n_nt) * kBN;
  rest /= pl.n_nt;
  t.m0 = (rest % pl.n_mt) * kBM;
  t.li = rest / pl.n_mt;
  t.e = p.live.expert(t.li);
  t.k0 = t.split * pl.span * kBK;
  t.k1 = min(p.K, t.k0 + pl.span * kBK);
  t.nk = (t.k1 - t.k0 + kBK - 1) / kBK;
  return t;
}

// Start the cp.async loads of step `ks` of unit `t` into one ring stage:
// the (kBM, kBK) row tile and the (kBK, kBN) weight tile(s).  Rows past R,
// k past the unit's end and columns past N are zero-filled and not read.
// The wrapper admits only rows that start 16-byte aligned, K % 8 == 0 and
// N % 8 == 0.  Constant trip counts: all of a thread's copies in flight.
template <int kMats>
__device__ __forceinline__ void load_step(__nv_bfloat16* st, const Gemm& p,
                                          const Unit& t, int ks) {
  using T = Tiles<kMats>;
  constexpr int kBK = T::kBK;
  const int kb = t.k0 + ks * kBK;
  const auto* a = static_cast<const __nv_bfloat16*>(p.a);
  constexpr int kAChunks = kBK / 8;
#pragma unroll
  for (int it = 0; it < kBM * kAChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kAChunks, c = idx % kAChunks;
    const int row = t.m0 + r, k = kb + c * 8;
    const bool ok = row < p.R && k < t.k1;
    const __nv_bfloat16* src =
        ok ? a + row_off(row, p.C, p.a_se, p.a_sb, p.a_sc, t.e) + k : a;
    cp16(st + r * T::kLDA + c * 8, src, ok);
  }
  constexpr int kWChunks = kBN / 8;
#pragma unroll
  for (int m = 0; m < kMats; ++m) {
    const auto* w = static_cast<const __nv_bfloat16*>(m ? p.w1 : p.w0) +
                    t.e * (m ? p.w1_se : p.w0_se);
    const long long sk = m ? p.w1_sk : p.w0_sk;
    __nv_bfloat16* dst = st + T::kAElems + m * T::kWElems;
#pragma unroll
    for (int it = 0; it < kBK * kWChunks / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / kWChunks, c = idx % kWChunks;
      const int k = kb + r, n = t.n0 + c * 8;
      const bool ok = k < t.k1 && n < p.N;
      cp16(dst + r * kLDW + c * 8, ok ? w + k * sk + n : w, ok);
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads,
                                  Tiles<ACT == kSwiglu ? 2 : 1>::kMaxBlocks)
    gemm_persistent(const Gemm p) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  using T = Tiles<kMats>;
  constexpr int kBK = T::kBK, kStages = T::kStages, kStage = T::kStage;
  constexpr int kLDA = T::kLDA, kAElems = T::kAElems, kWElems = T::kWElems;
  constexpr int kMT = kBM / 16;                  // row tiles of 16
  extern __shared__ uint4 smem_raw[];
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const Plan pl = plan_of<kMats>(p);
  if ((int)blockIdx.x >= pl.units) return;       // the whole block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;       // mma fragment row / column
  const int wn = warp * 16;                      // this warp's columns

  // the load cursor runs kStages - 1 steps ahead of the compute cursor,
  // across unit bounds; every step commits one group, empty past the end
  int lu = blockIdx.x, lk = 0;
  Unit lt = unit_of<kMats>(p, pl, lu);
  auto fetch = [&](int stage) {
    if (lu < pl.units) {
      load_step<kMats>(ring + stage * kStage, p, lt, lk);
      if (++lk == lt.nk) {
        lk = 0;
        lu += gridDim.x;
        if (lu < pl.units) lt = unit_of<kMats>(p, pl, lu);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  int cu = blockIdx.x, ck = 0, cs = 0, ls = kStages - 1;
  Unit ct = unit_of<kMats>(p, pl, cu);
  float acc[kMats][kMT][2][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        acc[m][t][n][0] = acc[m][t][n][1] = acc[m][t][n][2] =
            acc[m][t][n][3] = 0.f;

  while (cu < pl.units) {
    cp_wait<kStages - 2>();    // this step's tiles have landed
    __syncthreads();           // for all threads; the oldest stage is free
    fetch(ls);
    ls = ls + 1 == kStages ? 0 : ls + 1;

    const __nv_bfloat16* as = ring + cs * kStage;
    const __nv_bfloat16* ws = as + kAElems;
    const int rows = p.R - ct.m0;                // block-uniform
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      unsigned bw[kMats][4];
#pragma unroll
      for (int m = 0; m < kMats; ++m)
        ldsm_x4_trans(ws + m * kWElems + (ks * 16 + (lane & 15)) * kLDW +
                          wn + (lane >> 4) * 8,
                      bw[m]);
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        if (t * 16 >= rows) break;
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
    cs = cs + 1 == kStages ? 0 : cs + 1;
    if (++ck < ct.nk) continue;

    // the unit is done: its epilogue (global stores only), then the next
    auto* ob = static_cast<__nv_bfloat16*>(p.o);
    float* part = p.part + (long long)((ct.li * pl.ks + ct.split) * kMats) *
                               p.R * p.N;
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = ct.m0 + t * 16 + g + h * 8;
          const int col = ct.n0 + wn + n * 8 + tig * 2;  // even; N % 8 == 0
          if (row >= p.R || col >= p.N) continue;
          if (pl.ks == 1) {
            *reinterpret_cast<__nv_bfloat162*>(
                ob + row_off(row, p.C, p.o_se, p.o_sb, p.o_sc, ct.e) + col) =
                __floats2bfloat162_rn(
                    epilogue<ACT>(acc[0][t][n][2 * h],
                                  acc[kMats - 1][t][n][2 * h]),
                    epilogue<ACT>(acc[0][t][n][2 * h + 1],
                                  acc[kMats - 1][t][n][2 * h + 1]));
          } else {
#pragma unroll
            for (int m = 0; m < kMats; ++m)
              *reinterpret_cast<float2*>(
                  part + (long long)m * p.R * p.N + (long long)row * p.N +
                  col) = make_float2(acc[m][t][n][2 * h],
                                     acc[m][t][n][2 * h + 1]);
          }
        }
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          acc[m][t][n][0] = acc[m][t][n][1] = acc[m][t][n][2] =
              acc[m][t][n][3] = 0.f;
    ck = 0;
    cu += gridDim.x;
    if (cu < pl.units) ct = unit_of<kMats>(p, pl, cu);
  }
  cp_wait<0>();
}

// The second pass of a split product: sum each output pair's partials in
// split order, apply the epilogue, store in bf16.  Nothing to do unsplit.
template <int ACT>
__global__ void __launch_bounds__(kThreads) reduce_splits(const Gemm p) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  const Plan pl = plan_of<kMats>(p);
  if (pl.ks == 1) return;
  const int half = p.N / 2;
  const long long mat = (long long)p.R * p.N;
  const long long total = (long long)pl.n_live * p.R * half;
  auto* ob = static_cast<__nv_bfloat16*>(p.o);
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const int col = (int)(i % half) * 2;
    const long long rest = i / half;
    const int row = (int)(rest % p.R), li = (int)(rest / p.R);
    float2 s[kMats];
#pragma unroll
    for (int m = 0; m < kMats; ++m) s[m] = make_float2(0.f, 0.f);
    for (int k = 0; k < pl.ks; ++k)
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float2 v = *reinterpret_cast<const float2*>(
            p.part + ((long long)(li * pl.ks + k) * kMats + m) * mat +
            (long long)row * p.N + col);
        s[m].x += v.x;
        s[m].y += v.y;
      }
    const int e = p.live.expert(li);
    *reinterpret_cast<__nv_bfloat162*>(
        ob + row_off(row, p.C, p.o_se, p.o_sb, p.o_sc, e) + col) =
        __floats2bfloat162_rn(epilogue<ACT>(s[0].x, s[kMats - 1].x),
                              epilogue<ACT>(s[0].y, s[kMats - 1].y));
  }
}

template <int ACT>
cudaError_t run(const Gemm& p, int sms, cudaStream_t st) {
  using T = Tiles<ACT == kSwiglu ? 2 : 1>;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)T::kStages * T::kStage;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_persistent<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // Two blocks an SM hide more of the mma latency when an expert has more
  // than 32 rows (a prefill); at decode's 16 rows one block an SM walks the
  // units in even rounds (640 units: 5 rounds of 132, against 3 of 264).
  const int per_sm = p.R > 32 ? T::kMaxBlocks : 1;
  gemm_persistent<ACT><<<per_sm * sms, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits<ACT><<<2 * sms, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ======================================================= float32: FMAs
namespace f32 {

constexpr int kBN = 64;            // output columns per block
constexpr int kBKf = 16;           // reduction step
constexpr int kRows = kBM / 16;    // rows per thread
constexpr int kCols = kBN / 16;    // columns per thread

template <int ACT>
__global__ void __launch_bounds__(kThreads) gemm_block(const Gemm p) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  __shared__ float as[kBM][kBKf + 1];
  __shared__ float ws[kMats][kBKf][kBN];

  if ((int)blockIdx.y >= p.live.n_live()) return;   // the whole block
  const int n0 = blockIdx.x * kBN, e = p.live.expert(blockIdx.y);
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
cudaError_t run(const Gemm& p, int E, cudaStream_t st) {
  gemm_block<ACT><<<dim3((p.N + kBN - 1) / kBN, E), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Floats of f32 scratch a call needs for split partials: a split runs only
// when an expert's B*C rows fit one row tile.
extern "C" long long moe_gmm_partial_floats(int R, int D, int F) {
  return R <= kBM ? (long long)kSlots * 2 * R * (D > F ? D : F) : 0;
}

// dtype: 0 = float32, 1 = bfloat16; act: 1 = swiglu, 2 = gelu (w_gate is
// then not read).  Strides are in elements.  h is an (E, B*C, F) scratch of
// buf's dtype; part a float scratch of moe_gmm_partial_floats(B*C, D, F);
// ws an int32 scratch of 2 + 2E and out the (B, E, C, D) output, both
// zero-filled by the caller.  For bfloat16 every row must start 16-byte
// aligned and D, F must be multiples of 8 (checked by the wrapper).
// Returns the CUDA error of the launches (0 on success); the kernels run
// asynchronously on `stream`.
extern "C" int moe_gmm_fwd(
    const void* buf, const void* w_in, const void* w_gate, const void* w_out,
    void* h, float* part, int* ws, void* out, int dtype, int act, int B,
    int E, int C, int D, int F, long long buf_sb, long long buf_se,
    long long buf_sc, long long wi_se, long long wi_sk, long long wg_se,
    long long wg_sk, long long wo_se, long long wo_sk, long long out_sb,
    long long out_se, long long out_sc, void* stream) {
  if ((dtype != 0 && dtype != 1) || (act != kSwiglu && act != kGelu))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = B * C;
  const long long h_se = (long long)R * F, h_sb = (long long)C * F;
  const Live live{ws, E};
  const Gemm up{buf,  buf_se, buf_sb, buf_sc, w_in, wi_se, wi_sk, w_gate,
                wg_se, wg_sk, h, h_se, h_sb, F, R, C, D, F, part, live};
  const Gemm down{h,     h_se,   h_sb,   F,      w_out,  wo_se, wo_sk,
                  w_out, wo_se,  wo_sk,  out,    out_se, out_sb, out_sc,
                  R,     C,      F,      D,      part,   live};

  cudaError_t err = launch_scan(dtype, buf, buf_sb, buf_se, buf_sc, nullptr,
                                0, 0, 0, B, E, C, D, ws, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (dtype == 1) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = act == kSwiglu ? bf16::run<kSwiglu>(up, sms, st)
                         : bf16::run<kGelu>(up, sms, st);
    if (err == cudaSuccess) err = bf16::run<kNone>(down, sms, st);
    return static_cast<int>(err);
  }
  err = act == kSwiglu ? f32::run<kSwiglu>(up, E, st)
                       : f32::run<kGelu>(up, E, st);
  if (err == cudaSuccess) err = f32::run<kNone>(down, E, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
