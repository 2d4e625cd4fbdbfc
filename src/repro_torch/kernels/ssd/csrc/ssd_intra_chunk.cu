// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::_ssd_kernel,
// launched by ssd_intra_chunk_pallas.  It computes the same function: for
// every batch row b, chunk c and head h, with the chunk's L rows,
//     CB      = C B^T                                          (L, L)
//     M[i,j]  = CB[i,j] * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//     y       = M X                                            (L, P)
//     state   = (exp(cum_{L-1} - cum) * dt * B)^T X            (N, P)
// with f32 sums, x in f32 or bf16 and every other input f32.  Outputs y
// (B, NC, L, H, P) and states (B, NC, H, N, P) are f32.
//
// Layout.  xc (B, NC, L, H, P), dtc and cum (B, NC, L, H), bc and cc
// (B, NC, L, N) are read in place through their strides (the last dim of x,
// B and C contiguous): the model hands in views of its projection without a
// copy.  y and states are written contiguous.  Nothing is padded in memory:
// L is any length from 1 to 256, P up to 64 and N up to 128; the kernel
// masks the ragged edges (rows past L, columns past P and N) and nothing
// else.
//
// What bounds it on an H100.  At the longest prefill that mamba2-780m serves
// (663 tokens, padded to 768: B 1, NC 3, L 256, H 48, P 64, N 128, x bf16),
// counting each input read once and each output written once, it moves
// 19.96 MB, 6.0 us at 3.35 TB/s; its 1.236 GFLOP of the causal half (C B^T
// once per chunk 0.025, M X 0.606, states 0.604) take 1.25 us at the bf16
// tensor-core rate.  Bound by bytes, at 0.0060 ms.  (On f32 FMAs the same
// work would take 18.4 us.)
//
// Design: two launches.
//   (a) C B^T once per chunk, shared by all heads: one block per 32 x 32
//       tile on or below the diagonal and per (b, c), f32 FMAs summed over
//       N in order, into an f32 scratch (B*NC, Lp, Lp) with Lp = L rounded
//       up to 64 (768 KB at the shape above: it stays in L2 for (b)).
//   (b) One launch of y and state units, 128 threads a block, each block
//       one unit: y rows [i0, i0+64) of one head, or state rows [n0, n0+64)
//       of one head.  Each warp owns 16 rows and all 64 columns of P.
// What each part answers:
//   - Tensor cores at f32 accuracy.  The products run on bf16 mma.sync
//     m16n8k16 with f32 accumulation.  Each thread builds its own A
//     fragment elements of M (one expf each) or of w B in registers, with
//     no round trip through shared memory, and splits each f32 value v
//     exactly into three bf16 parts, v = hi + mid + lo (8 + 8 + 8 bits of
//     its 24-bit significand).  X in bf16 is exact as an operand and each
//     bf16 x bf16 product is exact in f32, so y = M_lo X + M_mid X +
//     M_hi X (smallest first) differs from an f32 FMA sum only in how the
//     sums round.  An f32 X is split the same way and the six products
//     whose parts weigh down to 2^-16 are summed; no served path has it.
//   - Even, plentiful blocks.  The units are ordered heaviest first (the
//     y units of the last i-tile and the state units, which walk every
//     tile of the chunk, then the lighter i-tiles), so the in-order
//     dispatch fills the tail with light ones; a one-chunk prompt gives
//     (ceil(L/64) + ceil(N/64)) x H blocks, 144 or more for mamba2.
//     Tiles above the diagonal, and k-steps wholly above it or past L,
//     are skipped.  50 KB of shared memory and at most 170 registers a
//     thread for bf16 x: three blocks an SM (a build for four, at 128
//     registers, spilled); 82 KB for f32 x: two.
//   - Copies beside the products.  Tiles of 64 rows of CB (or of B) and of
//     X come through a 2-stage cp.async ring, so the next tile's loads run
//     under this tile's products.  Tiles are swizzled in 16-byte chunks so
//     that ldmatrix and the fragment reads meet no bank conflict.  Inputs
//     whose rows are not 16-byte aligned (or P not a multiple of 8, N of
//     4) are staged by plain loads in the same layout.
//   - Every tile size and the number of blocks an SM are fixed at compile
//     time; nothing of the schedule is read at run time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "ssd_cb.cuh"
#include "ssd_mma.cuh"

namespace {

struct Args {
  const void* x;
  const float* dt;
  const float* cum;
  const float* bm;
  const float* cm;
  float* cb;  // (B*NC, Lp, Lp) scratch: written by (a), read by (b)
  float* y;
  float* st;
  int B, NC, L, H, P, N, Lp;
  long long x_sb, x_sc, x_sl, x_sh;
  long long dt_sb, dt_sc, dt_sl, dt_sh;
  long long cu_sb, cu_sc, cu_sl, cu_sh;
  long long b_sb, b_sc, b_sl;
  long long c_sb, c_sc, c_sl;
};

// (a) C B^T: ssd_cb.cuh

// ------------------------------------------------- (b) y and state units
// (the tensor-core helpers and tile layouts: ssd_mma.cuh)

template <typename XT>
struct Stage {
  static constexpr int kXParts = XParts<XT>::value;
  static constexpr int kFloatBytes = kT * kT * 4;
  static constexpr int kXBytes = kT * kT * 2;
  static constexpr int kBytes = kFloatBytes + kXParts * kXBytes;
  static constexpr int kSmem = 2 * kBytes + 2 * kMaxL * 4;  // ring + vectors
  // blocks an SM: three for bf16 x (50 KB each, at most 170 registers a
  // thread), two for f32 x (82 KB)
  static constexpr int kMinBlocks = kXParts == 1 ? 3 : 2;
};

// CB rows [i0, i0 + 64), columns [j0, j0 + 64) of chunk bc; the scratch is
// Lp x Lp, so every read is in bounds (entries above the diagonal or past
// L are never used).
__device__ __forceinline__ void stage_cb(float* ft, const Args& a, int bc,
                                         int i0, int j0) {
  const float* src0 = a.cb + ((long long)bc * a.Lp + i0) * a.Lp + j0;
#pragma unroll
  for (int s = 0; s < kT * kT / 4 / kThreads; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int r = idx >> 4, c = idx & 15;
    cp16(ft + cb_at(r, 4 * c), src0 + (long long)r * a.Lp + 4 * c, true);
  }
}

// B rows [l0, l0 + 64), columns [n0, n0 + 64) of one chunk; 0 past L, N.
template <bool kAsync>
__device__ __forceinline__ void stage_b(float* ft, const float* bm,
                                        const Args& a, int l0, int n0) {
#pragma unroll
  for (int s = 0; s < kT * kT / 4 / kThreads; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int r = idx >> 4, c = idx & 15;
    const bool row_in = l0 + r < a.L;
    const float* src = bm + (l0 + r) * a.b_sl + n0 + 4 * c;
    float* dst = ft + b_at(r, 4 * c);
    if constexpr (kAsync) {
      const bool ok = row_in && n0 + 4 * c < a.N;
      cp16(dst, ok ? src : bm, ok);
    } else {
      float4 v;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        (&v.x)[e] = (row_in && n0 + 4 * c + e < a.N) ? src[e] : 0.f;
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

template <typename XT, bool kAsync>
__global__ void __launch_bounds__(kThreads, Stage<XT>::kMinBlocks)
    ssd_chunk_kernel(const Args a) {
  using S = Stage<XT>;
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  float* vec0 = reinterpret_cast<float*>(base + 2 * S::kBytes);  // cum | w
  float* vec1 = vec0 + kMaxL;                                     // dt

  // The block's unit, heaviest first: level 0 holds the y units of the
  // last i-tile and every state unit (all walk nlt tiles), level v > 0 the
  // y units of i-tile nlt - 1 - v.  Inside a level, heads vary fastest.
  const int nlt = (a.L + kT - 1) / kT, nnt = (a.N + kT - 1) / kT;
  const int per = a.H * a.B * a.NC;
  int u = blockIdx.x, tile;
  bool state = false;
  if (u < per * (1 + nnt)) {
    state = u >= per;
    tile = state ? (u - per) / per : nlt - 1;
    u = state ? (u - per) % per : u;
  } else {
    u -= per * (1 + nnt);
    tile = nlt - 2 - u / per;
    u %= per;
  }
  const int h = u % a.H, bc = u / a.H;
  const int bb = bc / a.NC, cz = bc % a.NC;
  const float* dth = a.dt + bb * a.dt_sb + cz * a.dt_sc + h * a.dt_sh;
  const float* cuh = a.cum + bb * a.cu_sb + cz * a.cu_sc + h * a.cu_sh;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;
  const XT* xh = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc +
                 h * a.x_sh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = tile * kT;                   // i0 (y) or n0 (state)
  const int ntiles = state ? nlt : tile + 1;  // j- or l-tiles to walk

  // cum and dt of the columns j (y), or the state weights w_l
  if (state) {
    const float last = cuh[(a.L - 1) * a.cu_sl];
#pragma unroll
    for (int s = 0; s < kMaxL / kThreads; ++s) {
      const int l = s * kThreads + tid;
      vec0[l] = l < a.L ? expf(last - cuh[l * a.cu_sl]) * dth[l * a.dt_sl]
                        : 0.f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kMaxL / kThreads; ++s) {
      const int j = s * kThreads + tid;
      vec0[j] = j < a.L ? cuh[j * a.cu_sl] : 0.f;
      vec1[j] = j < a.L ? dth[j * a.dt_sl] : 0.f;
    }
  }

  auto load = [&](int t) {
    char* sb = base + (t & 1) * S::kBytes;
    float* ft = reinterpret_cast<float*>(sb);
    auto* xt = reinterpret_cast<__nv_bfloat16*>(sb + S::kFloatBytes);
    if (state)
      stage_b<kAsync>(ft, bm, a, t * kT, r0);
    else
      stage_cb(ft, a, bc, r0, t * kT);
    stage_x<XT, kAsync>(xt, xh, a, t * kT);
    cp_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int rw = r0 + 16 * warp;              // this warp's first row
  const int rows_of = state ? a.N : a.L;
  const bool busy = rw < rows_of;             // warp-uniform
  // y: this thread's rows ia = rw + g and ib = ia + 8; column j of M is
  // kept while j <= lim (rows past L keep none)
  const int ia = rw + g, ib = ia + 8;
  const int lim_a = ia < a.L ? ia : -1, lim_b = ib < a.L ? ib : -1;

  load(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load(t + 1);
    else
      cp_commit();                            // one group per step
    cp_wait<1>();
    __syncthreads();
    const char* sb = base + (t & 1) * S::kBytes;
    const float* ft = reinterpret_cast<const float*>(sb);
    const auto* xt =
        reinterpret_cast<const __nv_bfloat16*>(sb + S::kFloatBytes);
    const int c0 = t * kT;                    // first column j or row l
    if (busy) {
      // k-steps of 16 that hold a kept column (y) or a row l < L (state)
      const int last = state ? a.L - 1 : min(rw + 15, a.L - 1);
      const int ks_end = min(4, (last - c0) / 16 + 1);
      const float cum_a = state ? 0.f : vec0[ia < a.L ? ia : 0];
      const float cum_b = state ? 0.f : vec0[ib < a.L ? ib : 0];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= ks_end) break;
        unsigned af[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 16 * ks + 2 * tig + 8 * half;   // column in tile
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = 16 * warp + g + 8 * rr;     // row in tile
            float v0, v1;
            if (state) {
              v0 = ft[b_at(k, row)] * vec0[c0 + k];
              v1 = ft[b_at(k + 1, row)] * vec0[c0 + k + 1];
            } else {
              const int j = c0 + k, lim = rr ? lim_b : lim_a;
              const float ci = rr ? cum_b : cum_a;
              const float2 cb =
                  *reinterpret_cast<const float2*>(ft + cb_at(row, k));
              v0 = j <= lim ? cb.x * expf(ci - vec0[j]) * vec1[j] : 0.f;
              v1 = j + 1 <= lim
                       ? cb.y * expf(ci - vec0[j + 1]) * vec1[j + 1]
                       : 0.f;
            }
            split3(v0, v1, af[0][rr + 2 * half], af[1][rr + 2 * half],
                   af[2][rr + 2 * half]);
          }
        }
        mma_step<S::kXParts>(acc, af, xt, 16 * ks, lane);
      }
    }
    __syncthreads();                          // the stage may be refilled
  }
  cp_wait<0>();
  if (!busy) return;

  // acc[n] holds rows g (0, 1) and g + 8 (2, 3), columns 8n + 2tig (+1)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rw + g + 8 * rr;
    if (row >= rows_of) continue;
    float* out = state
        ? a.st + (((long long)bc * a.H + h) * a.N + row) * a.P
        : a.y + (((long long)bc * a.L + row) * a.H + h) * a.P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = 8 * n + 2 * tig;
      if (p >= a.P) continue;
      const float v0 = acc[n][2 * rr], v1 = acc[n][2 * rr + 1];
      if ((a.P & 1) == 0) {
        *reinterpret_cast<float2*>(out + p) = make_float2(v0, v1);
      } else {
        out[p] = v0;
        if (p + 1 < a.P) out[p + 1] = v1;
      }
    }
  }
}

// Allow the (b) kernel its dynamic shared memory, once per device.
template <typename XT, bool kAsync>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_chunk_kernel<XT, kAsync>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Stage<XT>::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename XT, bool kAsync>
cudaError_t launch(const Args& a, cudaStream_t st) {
  cudaError_t err = allow_smem<XT, kAsync>();
  if (err != cudaSuccess) return err;
  err = launch_cb(a, st);
  if (err != cudaSuccess) return err;
  const int smem = Stage<XT>::kSmem;
  const int nlt = (a.L + kT - 1) / kT, nnt = (a.N + kT - 1) / kT;
  const long long blocks = (long long)a.B * a.NC * a.H * (nlt + nnt);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_chunk_kernel<XT, kAsync>
      <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dims: 25 int64 values, the dtype of x (0 = float32, 1 = bfloat16; dt,
// cum, B and C are float32), B, NC, L, H, P, N, then the strides in
// elements of x (4: b, c, l, h), dt (4), cum (4), B (3: b, c, l) and C (3);
// the last dim of x, B and C is contiguous.  (One packed argument, not 25:
// each argument costs the Python caller its own conversion.)  y
// (B, NC, L, H, P) and st (B, NC, H, N, P) are contiguous float32; cb is a
// float32 scratch of B * NC * Lp * Lp, Lp = L rounded up to a multiple of
// 64.  Returns the CUDA error of the launches (0 on success); the kernels
// run asynchronously on `stream`.
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt,
                                   const void* cum, const void* bm,
                                   const void* cm, void* y, void* st,
                                   void* cb, const void* dims,
                                   void* stream) {
  long long d[25];
  std::memcpy(d, dims, sizeof(d));
  const long long dtype = d[0], B = d[1], NC = d[2], L = d[3], H = d[4],
                  P = d[5], N = d[6];
  if ((dtype != 0 && dtype != 1) || B < 1 || NC < 1 || L < 1 ||
      L > kMaxL || H < 1 || P < 1 || P > kT || N < 1 || N > 2 * kT ||
      B * NC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,    static_cast<const float*>(dt),
               static_cast<const float*>(cum),
               static_cast<const float*>(bm),
               static_cast<const float*>(cm),
               static_cast<float*>(cb),
               static_cast<float*>(y),
               static_cast<float*>(st),
               static_cast<int>(B), static_cast<int>(NC),
               static_cast<int>(L), static_cast<int>(H),
               static_cast<int>(P), static_cast<int>(N),
               static_cast<int>((L + kT - 1) / kT * kT),
               d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13], d[14],
               d[15], d[16], d[17], d[18], d[19], d[20], d[21],
               d[22], d[23], d[24]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte cp.async for x and B where every row starts 16-byte aligned
  const bool async = dtype == 1 && P % 8 == 0 && N % 4 == 0 &&
                     aligned16(x) && aligned16(bm) &&
                     (a.x_sb | a.x_sc | a.x_sl | a.x_sh) % 8 == 0 &&
                     (a.b_sb | a.b_sc | a.b_sl) % 4 == 0;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float, false>(a, s);
  else if (async)
    err = launch<__nv_bfloat16, true>(a, s);
  else
    err = launch<__nv_bfloat16, false>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
