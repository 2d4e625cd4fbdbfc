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
//   (1) hidden:  A, G and dH from one walk over X and dY (reduction over D);
//       the epilogue writes H = act(A, G) (rounded to bf16, as the forward
//       rounds it), dA and dG into (E, R, F) scratch.  The two up products
//       are recomputed, not saved, so the forward keeps no activation (remat
//       "full" keeps memory as the reference's).
//   (2) dX:  dA against W_in^T, then dG against W_gate^T (reduction over
//       2F), written into dbuf (B, E, C, D) through its strides.
//   (3) weights:  each output tile summed over the expert's R rows in
//       ascending order.  Each output tile has one owner: no split, no
//       atomics, every sum in a fixed order, so two calls give the same
//       bits.  Dead experts' tiles are written as zeros.
//
// Bodies, chosen by the wrapper (kernel.py::bwd_body) by dtype alone:
//   * wgmma (bfloat16, every shape the wrapper takes: D and F multiples of 8,
//     rows 16-byte aligned; training's path), namespace wg.  Each pass is
//     one persistent launch of 256-thread blocks, one an SM: two consumer
//     warpgroups, and warp 0 also issues the TMA loads (by predicate from
//     one lane) into a ring of mbarrier-guarded stages, up to a ring ahead
//     and across the block's units, so a unit's epilogue overlaps the next
//     unit's loads.  Every product is wgmma from 128-byte swizzled shared
//     memory, each operand in the major-ness its layout gives (no copy in
//     memory):
//       hidden  A^T = W_in^T X^T, G^T, dH^T = W_out dY^T: rows on wgmma's N
//               (80 rows of one batch row), 128 F columns on M (64 a
//               warpgroup); W_in, W_gate MN-major, W_out, X, dY K-major;
//               three accumulators of 64 x 80, 120 registers a thread.
//       dX      dX^T = W_in dA^T + W_gate dG^T: 160 rows of one batch row on
//               N, 256 D columns on M (two m64 slabs a warpgroup, sharing
//               the dA tile); both operands K-major.
//       weights dW_in = X^T dA, dW_gate = X^T dG, dW_out = H^T dY: 128 x
//               256 output tiles (64 x 256 a warpgroup), reduction in steps
//               of 64 rows of one batch row; both operands MN-major; each
//               tile goes through shared memory to a TMA store that
//               overlaps the next tile's products.
//     Row operands are read through rank-4 TMA maps over buf, dY (cols, C,
//     E, B) and the scratch (F, C, B, E), so a box never crosses a batch
//     row: TMA zero-fills the rows past C, and no epilogue writes them.
//     Rows on N (80 and 160 divide C = 160, llama4's capacity) waste no
//     product where 64-row M tiles would compute 384 rows for 320.  The
//     weight pass's steps of 64 rows compute 384 for 320 at C = 160; steps
//     of 32 rows (no waste) ran that pass 1.4x slower on an H100: the
//     per-step wait and refill, not the products, set its pace.  The maps'
//     dims and strides come from the wrapper (kernel.py::bwd_maps).
//   * FMA (float32, the tests' dtype): one thread per output element, its
//     sum in order on FMAs, H in f32; exact to the order of sums.
//
// What bounds it on an H100.  At llama4-scout's training shape (buf (2, 16,
// 160, 5120), F 8192, bf16, all 16 experts live with 320 rows each) the
// gradient needs six products of 2 * 320 * 5120 * 8192 flops per expert:
// 2.577 TFLOP, 2.61 ms at 989 TFLOP/s.  Its bytes (three weights read,
// three gradients written, buf, dY and dX) are about 8.21 GB, 2.45 ms at
// 3.35 TB/s: bound by operations.  This design recomputes A and G, two
// products more (its own floor 3.47 ms), and moves its (E, R, F) scratch
// (252 MB written, read twice) through memory.  The wgmma body puts every
// product on the tensor cores' asynchronous path at N = 80 to 256; the
// weight pass, 6 reduction steps a tile at llama4's 320 rows, hides its
// 64 KB a tile of output behind the next tile's loads and products.
#include "gmm_common.cuh"
#include "../../csrc/sm90.cuh"

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

// ============================================ bfloat16: wgmma fed by TMA
namespace wg {

using namespace sm90;   // mbarriers, TMA, wgmma (kernels/csrc/sm90.cuh)

constexpr int kThreads = 256;   // two consumer warpgroups; warp 0 issues TMA
constexpr long long kHangCycles = 20000000000LL;   // about 10 s: then trap
using bf = __nv_bfloat16;

// The tensors whose TMA maps the wrapper describes (kernel.py::bwd_maps),
// in its order: rank 4, dims inner first, element strides of dims 1..3.
// Row operands are cut per batch row, so a box of rows stays in one: buf
// and dY (cols, C, E, B), the scratch (F, C, B, E).
enum { kMapX, kMapDy, kMapWi, kMapWg, kMapWo, kMapScratch, kMapDwi, kMapDwg,
       kMapDwo };
struct MapDims {
  long long dims[4];
  long long strides[3];
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// B, the batch rows of R = B C
__host__ __device__ __forceinline__ int batch(const Bwd& p) {
  return p.R / p.C;
}

// v as lane 0 of the warp holds it: a value every lane reads the same, made
// warp-uniform for the compiler, so that branches on it are
__device__ __forceinline__ int uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

// Wait for the phase of parity `parity` of `bar`; lane 0's reading decides
// for the warp, so the wait is warp-uniform.  A wait of kHangCycles traps,
// so a schedule fault fails the launch instead of hanging the card.
__device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {
  if (uniform(mbar_try(bar, parity))) return;
  const long long t0 = clock64();
  while (!uniform(mbar_try(bar, parity)))
    if (uniform(clock64() - t0 > kHangCycles)) __trap();
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[m][i] = 0.f;
}

template <int M, int N>
__device__ __forceinline__ void pin_all(float (&acc)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) pin(acc[m]);
}

// x, which the compiler may not see through
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}
// x, which the compiler may neither see through nor compute before the
// memory accesses that precede it
__device__ __forceinline__ int opaque_after_stores(int x) {
  asm volatile("" : "+r"(x)::"memory");
  return x;
}

// Where this thread's accumulator element 4 i + q of a 64 x N wgmma result
// lies: row (of the 64) and column.  Made in an epilogue from an opaque
// thread index: hoisted, the epilogue's addresses would hold registers
// through every step of the products.
struct Frag {
  int row0, col0;    // element 4 i + q: row0 + 8 (q / 2), col0 + 8 i + q % 2
  __device__ __forceinline__ Frag() {
    const int t = opaque((int)threadIdx.x);
    const int warp = (t % 128) / 32, lane = t % 32;
    row0 = warp * 16 + (lane >> 2);
    col0 = 2 * (lane & 3);
  }
};

// ------------------------------------------------------------ (1) hidden
// Unit: (live expert, batch row b, 80 rows from c0, 128 F columns from f0).
// Stage: W_in (and W_gate) as two [64 d][64 f] panels each (a warpgroup's
// f on M, MN-major), W_out as [128 f][64 d] (K-major), X and dY as
// [80 r][64 d] (K-major, the rows on N).
template <int ACT>
struct HiddenPass {
  static constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  static constexpr int kRows = 80, kCols = 128;
  static constexpr int kAccMats = kMats + 1, kN = kRows;
  static constexpr int kW = 64 * 128;          // a [64 d][64 f] panel
  static constexpr int kWo = kCols * 128;      // [128 f][64 d]
  static constexpr int kR = kRows * 128;       // [80 r][64 d]
  static constexpr int kStageBytes = kMats * 2 * kW + kWo + 2 * kR;
  static constexpr int kStages = ACT == kSwiglu ? 3 : 4;
  static constexpr int kExtraBytes = 0;
  struct alignas(64) Maps {
    CUtensorMap x, dy, wi, wg, wo;
  };
  struct Unit {
    int e, b, c0, f0;
  };

  static __device__ int tiles(const Bwd& p) {
    return cdiv(p.C, kRows) * batch(p) * cdiv(p.F, kCols);
  }
  static __device__ int units(const Bwd& p) {
    return uniform(p.live.n_live()) * tiles(p);
  }
  static __device__ int loaded_units(const Bwd& p) { return units(p); }
  static __device__ int steps(const Bwd& p) { return cdiv(p.D, 64); }
  // row tiles fastest: the units running together share their weight tiles
  static __device__ Unit unit(const Bwd& p, int u) {
    const int nrt = cdiv(p.C, kRows), nft = cdiv(p.F, kCols);
    const int rt = u % nrt, b = (u / nrt) % batch(p);
    const int ft = (u / (nrt * batch(p))) % nft, li = u / (nrt * batch(p) * nft);
    return Unit{p.live.expert(li), b, rt * kRows, ft * kCols};
  }
  static __device__ void load(const Maps& m, const Bwd& p, uint8_t* st,
                              uint64_t* bar, int u, int k, bool on) {
    const Unit t = unit(p, u);
    const int d0 = k * 64;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      tma_load_4d(st + q * kW, &m.wi, bar, t.f0 + 64 * q, d0, t.e, 0, on);
      if (kMats == 2)
        tma_load_4d(st + (2 + q) * kW, &m.wg, bar, t.f0 + 64 * q, d0, t.e, 0,
                    on);
    }
    uint8_t* r = st + kMats * 2 * kW;
    tma_load_4d(r, &m.wo, bar, d0, t.f0, t.e, 0, on);
    tma_load_4d(r + kWo, &m.x, bar, d0, t.c0, t.e, t.b, on);
    tma_load_4d(r + kWo + kR, &m.dy, bar, d0, t.c0, t.e, t.b, on);
  }
  // A^T (G^T) += W_in^T (W_gate^T) X^T and dH^T += W_out dY^T over 64 d;
  // a k16 step is 16 rows (2048 bytes) of an MN-major panel, 32 bytes into
  // the rows of a K-major one
  static __device__ void mma(float (&acc)[kAccMats][kN / 2], uint8_t* st,
                             int wgi) {
    const uint64_t d_wi = desc(st + wgi * kW, kW, 1024);
    const uint64_t d_wg = desc(st + (2 + wgi) * kW, kW, 1024);
    uint8_t* r = st + kMats * 2 * kW;
    const uint64_t d_wo = desc(r + wgi * 64 * 128, 16, 1024);
    const uint64_t d_x = desc(r + kWo, 16, 1024);
    const uint64_t d_dy = desc(r + kWo + kR, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_n80<1, 0>(acc[0], d_wi + kk * 128, d_x + kk * 2);
      if constexpr (kMats == 2)
        wgmma_ss_n80<1, 0>(acc[1], d_wg + kk * 128, d_x + kk * 2);
      wgmma_ss_n80<0, 0>(acc[kMats], d_wo + kk * 2, d_dy + kk * 2);
    }
  }
  // H, dA, dG of this thread's (f, row) elements into the scratch; rows
  // past C and columns past F are not written
  static __device__ void epilogue(float (&acc)[kAccMats][kN / 2], const Maps&,
                                  const Bwd& p, uint8_t*, int u, int wgi) {
    const Unit t = unit(p, u);
    const Frag fr;
    bf* hs = static_cast<bf*>(p.h);
    bf* das = static_cast<bf*>(p.da);
    bf* dgs = static_cast<bf*>(p.dg);
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = t.f0 + wgi * 64 + fr.row0 + 8 * (q >> 1);
        const int c = t.c0 + fr.col0 + 8 * i + (q & 1);
        const Hidden<ACT> v(acc[0][4 * i + q], acc[kMats - 1][4 * i + q],
                            acc[kMats][4 * i + q]);
        if (f < p.F && c < p.C) {
          const long long o = scratch_off(p, t.e, t.b * p.C + c) + f;
          hs[o] = __float2bfloat16_rn(v.h);
          das[o] = __float2bfloat16_rn(v.da);
          if (ACT == kSwiglu) dgs[o] = __float2bfloat16_rn(v.dg);
        }
      }
  }
  static __device__ void finish() {}
};

// ---------------------------------------------------------------- (2) dX
// Unit: (live expert, batch row b, 160 rows from c0, 256 D columns from
// d0: two m64 slabs a warpgroup, which share the dA tile).  Stage: W_in or
// W_gate as [256 d][64 f] and dA or dG as [160 r][64 f], both K-major;
// steps over f run through dA, then dG.
template <int MATS>
struct DxPass {
  static constexpr int kRows = 160, kCols = 256, kSlabs = kCols / 128;
  static constexpr int kAccMats = kSlabs, kN = kRows;
  static constexpr int kW = kCols * 128;       // [256 d][64 f]
  static constexpr int kR = kRows * 128;       // [160 r][64 f]
  static constexpr int kStageBytes = kW + kR;
  static constexpr int kStages = 4;
  static constexpr int kExtraBytes = 0;
  struct alignas(64) Maps {
    CUtensorMap wi, wg, da, dg;
  };
  struct Unit {
    int e, b, c0, d0;
  };

  static __device__ int tiles(const Bwd& p) {
    return cdiv(p.C, kRows) * batch(p) * cdiv(p.D, kCols);
  }
  static __device__ int units(const Bwd& p) {
    return uniform(p.live.n_live()) * tiles(p);
  }
  static __device__ int loaded_units(const Bwd& p) { return units(p); }
  static __device__ int steps(const Bwd& p) { return MATS * cdiv(p.F, 64); }
  static __device__ Unit unit(const Bwd& p, int u) {
    const int nrt = cdiv(p.C, kRows), ndt = cdiv(p.D, kCols);
    const int rt = u % nrt, b = (u / nrt) % batch(p);
    const int dt = (u / (nrt * batch(p))) % ndt, li = u / (nrt * batch(p) * ndt);
    return Unit{p.live.expert(li), b, rt * kRows, dt * kCols};
  }
  static __device__ void load(const Maps& m, const Bwd& p, uint8_t* st,
                              uint64_t* bar, int u, int k, bool on) {
    const Unit t = unit(p, u);
    const int nf = cdiv(p.F, 64);
    const bool gate = k >= nf;
    const int f0 = (gate ? k - nf : k) * 64;
    tma_load_4d(st, gate ? &m.wg : &m.wi, bar, f0, t.d0, t.e, 0, on);
    tma_load_4d(st + kW, gate ? &m.dg : &m.da, bar, f0, t.c0, t.b, t.e, on);
  }
  static __device__ void mma(float (&acc)[kAccMats][kN / 2], uint8_t* st,
                             int wgi) {
    const uint64_t d_w = desc(st + wgi * kSlabs * 64 * 128, 16, 1024);
    const uint64_t d_s = desc(st + kW, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl)   // 64 rows of 128 bytes a slab
        wgmma_ss_n160<0, 0>(acc[sl], d_w + sl * 512 + kk * 2, d_s + kk * 2);
  }
  // dX^T's (d, row) elements into dbuf, a row of dbuf at a time; rows past
  // C and columns past D are not written.  Each row's address is made after
  // the last row's stores: made all at once, the 40 addresses would hold 80
  // registers beside the 160 of the sums.
  static __device__ void epilogue(float (&acc)[kAccMats][kN / 2], const Maps&,
                                  const Bwd& p, uint8_t*, int u, int wgi) {
    const Unit t = unit(p, u);
    const Frag fr;
    bf* dx = static_cast<bf*>(p.dx) + t.e * p.dx_se + t.b * p.dx_sb +
             t.d0 + wgi * kSlabs * 64 + fr.row0;
    const int d0 = t.d0 + wgi * kSlabs * 64 + fr.row0;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int c = opaque_after_stores(t.c0 + fr.col0 + 8 * i + odd);
        if (c >= p.C) continue;
        bf* row = dx + c * p.dx_sc;
#pragma unroll
        for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (d0 + sl * 64 + 8 * h < p.D)
              row[sl * 64 + 8 * h] =
                  __float2bfloat16_rn(acc[sl][4 * i + 2 * h + odd]);
      }
  }
  static __device__ void finish() {}
};

// ----------------------------------------------------------- (3) weights
// Unit: (expert, which gradient, 128 x 256 output tile); the live experts'
// tiles first, then the dead ones', which run no step and store zeros.
// Stage: 64 rows of one batch row of the A operand (X or H) as two [64 r]
// [64 m] panels and of the B operand (dA, dG or dY) as four [64 r][64 n]
// panels, all MN-major.  The epilogue stages a warpgroup's 64 x 256 result
// as four swizzled [64][64] panels in shared memory; one TMA store each,
// issued from the warpgroup's first lane, overlaps the next tile.
template <int WHICH>   // 3 (swiglu: in, gate, out) or 2 (gelu: in, out)
struct WeightPass {
  static constexpr int kRows = 64, kM = 128, kNc = 256;
  static constexpr int kAccMats = 1, kN = kNc;
  static constexpr int kP = kRows * 128;       // a [64 r][64] panel
  static constexpr int kStageBytes = 6 * kP;
  static constexpr int kStages = 3;
  static constexpr int kOut = 4 * 64 * 128;    // a warpgroup's 64 x 256
  static constexpr int kExtraBytes = 2 * kOut;
  struct alignas(64) Maps {
    CUtensorMap x, dy, h, da, dg, dwi, dwg, dwo;
  };
  struct Unit {
    int e, which, m0, n0;
  };

  // tiles of one expert: (WHICH - 1) of (D, F), then one of (F, D)
  static __device__ int tiles_in(const Bwd& p) {
    return cdiv(p.D, kM) * cdiv(p.F, kNc);
  }
  static __device__ int tiles(const Bwd& p) {
    return (WHICH - 1) * tiles_in(p) + cdiv(p.F, kM) * cdiv(p.D, kNc);
  }
  static __device__ int units(const Bwd& p) { return p.E * tiles(p); }
  static __device__ int loaded_units(const Bwd& p) {
    return uniform(p.live.n_live()) * tiles(p);
  }
  static __device__ int steps(const Bwd& p) {
    return batch(p) * cdiv(p.C, kRows);
  }
  static __device__ Unit unit(const Bwd& p, int u) {
    const int per = tiles(p), n_live = uniform(p.live.n_live());
    int e, r = u % per;
    if (u < n_live * per) {
      e = p.live.expert(u / per);
    } else {                       // the (u - n_live per) / per-th dead one
      int want = (u - n_live * per) / per;
      for (e = 0; e < p.E; ++e)
        if (p.live.rows(e) == 0 && want-- == 0) break;
    }
    const int t_in = tiles_in(p);
    int which;
    if (r < (WHICH - 1) * t_in) {
      which = r / t_in;
      r %= t_in;
    } else {
      which = 2;
      r -= (WHICH - 1) * t_in;
    }
    const int n_nt = cdiv(which == 2 ? p.D : p.F, kNc);
    return Unit{e, which, (r / n_nt) * kM, (r % n_nt) * kNc};
  }
  static __device__ void load(const Maps& m, const Bwd& p, uint8_t* st,
                              uint64_t* bar, int u, int k, bool on) {
    const Unit t = unit(p, u);
    const int kc = cdiv(p.C, kRows);
    const int b = k / kc, c0 = (k % kc) * kRows;
    // the scratch's map is (F, C, B, E), buf's and dY's (D, C, E, B)
    const bool out = t.which == 2;
    const CUtensorMap* a = out ? &m.h : &m.x;
    const CUtensorMap* bm = t.which == 0 ? &m.da : t.which == 1 ? &m.dg : &m.dy;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      tma_load_4d(st + q * kP, a, bar, t.m0 + 64 * q, c0, out ? b : t.e,
                  out ? t.e : b, on);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_4d(st + (2 + q) * kP, bm, bar, t.n0 + 64 * q, c0,
                  out ? t.e : b, out ? b : t.e, on);
  }
  static __device__ void mma(float (&acc)[kAccMats][kN / 2], uint8_t* st,
                             int wgi) {
    const uint64_t d_a = desc(st + wgi * kP, kP, 1024);
    const uint64_t d_b = desc(st + 2 * kP, kP, 1024);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_ss_n256<1, 1>(acc[0], d_a + kk * 128, d_b + kk * 128);
  }
  static __device__ bool lead_warp() {
    return uniform((threadIdx.x % 128) / 32) == 0;
  }
  static __device__ void epilogue(float (&acc)[kAccMats][kN / 2],
                                  const Maps& m, const Bwd& p, uint8_t* extra,
                                  int u, int wgi) {
    const Unit t = unit(p, u);
    uint8_t* out = extra + wgi * kOut;
    const bool lead = lead_warp();
    if (lead) bulk_wait_read_all();   // the last store has read `out`
    bar_sync(1 + wgi, 128);
    const Frag fr;
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = fr.row0 + 8 * h;
        // 8 columns of block i: panel i / 8, 16-byte chunk i % 8 of the
        // row, swizzled with the row
        *reinterpret_cast<unsigned*>(out + (i / 8) * 64 * 128 + row * 128 +
                                     (((i % 8) ^ (row & 7)) << 4) +
                                     2 * fr.col0) =
            pack(acc[0][4 * i + 2 * h], acc[0][4 * i + 2 * h + 1]);
      }
    fence_async_smem();
    bar_sync(1 + wgi, 128);
    if (lead) {
      const CUtensorMap* dst = t.which == 0   ? &m.dwi
                               : t.which == 1 ? &m.dwg
                                              : &m.dwo;
      const bool on = threadIdx.x % 128 == 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_store_4d(dst, out + q * 64 * 128, t.n0 + 64 * q,
                     t.m0 + 64 * wgi, t.e, 0, on);
      bulk_commit();
    }
  }
  static __device__ void finish() {
    if (lead_warp()) bulk_wait_all();
  }
};

// ------------------------------------------------------- the common loop
// A block walks units blockIdx.x, + gridDim.x, ...; the first loaded_units
// run `steps` steps each through a ring of kStages stages, the rest (the
// weight pass's dead experts) none.  full[s] completes when a stage's TMA
// loads land, empty[s] when all 256 threads are done with it.  Warp 0 keeps
// the ring a ring ahead: after step j is released it waits for every thread
// to release it and loads step j + kStages into its stage (the block's own
// load count, across units).  Thread 0 issues each load by predicate;
// every branch is on a warp-uniform value.
template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    pass(const __grid_constant__ typename P::Maps maps, const Bwd p) {
  constexpr int S = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 1 KB aligned, as the 128-byte swizzle's pattern is
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* extra = ring + S * P::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(extra + P::kExtraBytes);
  uint64_t* empty = full + S;
  const bool lane0 = threadIdx.x == 0;
  const bool warp0 = uniform(threadIdx.x / 32) == 0;
  const int wgi = uniform(threadIdx.x / 128);
  if (lane0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_units = P::units(p), n_loaded = P::loaded_units(p);
  const int steps = P::steps(p);
  const int mine = n_loaded > (int)blockIdx.x
                       ? (n_loaded - (int)blockIdx.x + (int)gridDim.x - 1) /
                             (int)gridDim.x
                       : 0;
  const int n_loads = mine * steps;
  // warp 0: load number L of this block into stage L % S
  auto issue = [&](int L) {
    if (L >= n_loads) return;
    const int s = L % S;
    if (L >= S) wait(&empty[s], ((L / S) + 1) & 1);
    mbar_expect_tx_if(&full[s], P::kStageBytes, lane0);
    P::load(maps, p, ring + s * P::kStageBytes, &full[s],
            blockIdx.x + (L / steps) * gridDim.x, L % steps, lane0);
  };
  if (warp0)
    for (int L = 0; L < S; ++L) issue(L);

  int j = 0;                            // steps consumed so far
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    float acc[P::kAccMats][P::kN / 2];
    zero(acc);
    if (u < n_loaded) {
      for (int k = 0; k < steps; ++k, ++j) {
        const int s = j % S;
        wait(&full[s], (j / S) & 1);
        wg_fence();
        P::mma(acc, ring + s * P::kStageBytes, wgi);
        wg_commit();
        wg_wait_pending<1>();           // step j - 1's products are done
        if (k > 0) {
          mbar_arrive(&empty[(j - 1) % S]);
          if (warp0) issue(j - 1 + S);
        }
      }
      wg_wait();
      pin_all(acc);
      mbar_arrive(&empty[(j - 1) % S]);
      if (warp0) issue(j - 1 + S);
    }
    P::epilogue(acc, maps, p, extra, u, wgi);
  }
  P::finish();
}

template <class P>
cudaError_t launch(const typename P::Maps& maps, const Bwd& p,
                   long long max_units, int sms, cudaStream_t st) {
  if (max_units <= 0) return cudaSuccess;
  constexpr size_t smem = 1024 + P::kStages * P::kStageBytes +
                          P::kExtraBytes + 2 * P::kStages * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      pass<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = max_units < sms ? (int)max_units : sms;
  pass<P><<<grid, kThreads, smem, st>>>(maps, p);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t run(const Bwd& p, const MapDims* md, cudaStream_t st) {
  constexpr int kMats = ACT == kSwiglu ? 2 : 1;
  using H = HiddenPass<ACT>;
  using X = DxPass<kMats>;
  using W = WeightPass<kMats + 1>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto map = [&](CUtensorMap* m, const void* base, int which, int rows) {
    if (err == cudaSuccess)
      err = make_map_4d(m, base, md[which].dims, md[which].strides, rows);
  };
  typename H::Maps hm;
  map(&hm.x, p.x, kMapX, H::kRows);
  map(&hm.dy, p.dy, kMapDy, H::kRows);
  map(&hm.wi, p.wi, kMapWi, 64);
  map(&hm.wg, p.wg, kMapWg, 64);
  map(&hm.wo, p.wo, kMapWo, H::kCols);
  typename X::Maps xm;
  map(&xm.wi, p.wi, kMapWi, X::kCols);
  map(&xm.wg, p.wg, kMapWg, X::kCols);
  map(&xm.da, p.da, kMapScratch, X::kRows);
  map(&xm.dg, p.dg, kMapScratch, X::kRows);
  typename W::Maps wm;
  map(&wm.x, p.x, kMapX, W::kRows);
  map(&wm.dy, p.dy, kMapDy, W::kRows);
  map(&wm.h, p.h, kMapScratch, W::kRows);
  map(&wm.da, p.da, kMapScratch, W::kRows);
  map(&wm.dg, p.dg, kMapScratch, W::kRows);
  map(&wm.dwi, p.dwi, kMapDwi, 64);
  map(&wm.dwg, p.dwg, kMapDwg, 64);
  map(&wm.dwo, p.dwo, kMapDwo, 64);
  if (err != cudaSuccess) return err;
  auto cd = [](long long a, long long b) { return (a + b - 1) / b; };
  const long long rows_h = cd(p.C, H::kRows) * batch(p);
  const long long rows_x = cd(p.C, X::kRows) * batch(p);
  err = launch<H>(hm, p, p.E * rows_h * cd(p.F, H::kCols), sms, st);
  if (err == cudaSuccess)
    err = launch<X>(xm, p, p.E * rows_x * cd(p.D, X::kCols), sms, st);
  if (err == cudaSuccess)
    err = launch<W>(wm, p,
                    p.E * (kMats * cd(p.D, W::kM) * cd(p.F, W::kNc) +
                           cd(p.F, W::kM) * cd(p.D, W::kNc)),
                    sms, st);
  return err;
}

}  // namespace wg

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
// w_gate (e, d), w_out (e, f) and dbuf (b, e, c), in elements; the body
// (kBodyFma for float32, kBodyWgmma for bfloat16: any other pair is
// refused, so the body the wrapper names is the one that runs); then, for
// the wgmma body, the TMA maps of wg::kMaps tensors (kernel.py::bwd_maps),
// 4 dims and 3 strides each.  h, da, dg: (E, B*C, F) scratch of buf's dtype (dg unused
// for gelu); ws: int32 of 2 + 2E, zero-filled; dbuf zero-filled; dw_in,
// dw_gate (swiglu only), dw_out contiguous.  For bfloat16 every row must
// start 16-byte aligned and D, F must be multiples of 8 (checked by the
// wrapper).  Returns the CUDA error of the launches (0 on success); the
// kernels run asynchronously on `stream`.
constexpr int kBodyFma = 0, kBodyWgmma = 1;
constexpr int kDimsHead = 23;

extern "C" int moe_gmm_bwd(const void* buf, const void* w_in,
                           const void* w_gate, const void* w_out,
                           const void* dy, void* h, void* da, void* dg,
                           int* ws, void* dbuf, void* dw_in, void* dw_gate,
                           void* dw_out, const long long* dims,
                           void* stream) {
  const int dtype = (int)dims[0], act = (int)dims[1], body = (int)dims[22];
  if ((dtype != 0 && dtype != 1) || (act != kSwiglu && act != kGelu) ||
      body != (dtype == 0 ? kBodyFma : kBodyWgmma))
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
  const wg::MapDims* maps =
      reinterpret_cast<const wg::MapDims*>(dims + kDimsHead);
  if (dtype == 0)
    err = act == kSwiglu ? f32::run<kSwiglu>(p, st) : f32::run<kGelu>(p, st);
  else
    err = act == kSwiglu ? wg::run<kSwiglu>(p, maps, st)
                         : wg::run<kGelu>(p, maps, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
