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
// in f32, with x in f32 or bf16 and every other input f32.  Outputs y
// (B, NC, L, H, P) and states (B, NC, H, N, P) are f32.
//
// Layout.  xc (B, NC, L, H, P), dtc and cum (B, NC, L, H), bc and cc
// (B, NC, L, N) are read in place through their strides (the last dim of x,
// B and C contiguous): the model hands in views of its projection without a
// copy.  y and states are written contiguous.  Nothing is padded in memory:
// L is any length from 1 to 256 and P up to 64, and the kernel masks the
// ragged edges.
//
// Design.  The Pallas grid is (B, NC, H): one cell holds a whole chunk in
// VMEM, recomputes C B^T for every head and builds the (L, L) decay matrix
// there.  On the card a chunk of L = 256 with N = 128 needs 128 KB for C and
// 128 KB for B in f32, more than a block's 227 KB with anything beside.  So
// the work is two launches:
//   (a) y: one block per (64-row tile of i, group of heads, (b, c)).  It
//       builds the rows C[i0:i0+64] B^T once, into shared memory, for the
//       column tiles j on or below the diagonal only (tiles above it are
//       exactly 0 and are skipped), and reuses them for every head of its
//       group: per head and column tile it forms the masked M tile in shared
//       memory and accumulates M X in registers (each thread 4 rows by
//       P / 16 columns).  A group is two heads: of 1, 2 and 4, two was the
//       fastest on the H100 at the three shapes timed, mamba2-780m's
//       prefills of 3 and 2 chunks of 256 and one chunk of 254 (B 1, H 48,
//       P 64, N 128).
//   (b) states: one block per (64-row tile of n, head, (b, c)), summing
//       (w B)^T X over the chunk in tiles of 64 rows of l.
// All sums are f32 FMAs, with expf (not __expf) and no TF32, so that the
// kernel agrees with the plain version to the order of sums.  Staging loops
// have a constant trip count.
//
// What bounds it on an H100.  At the longest prefill that mamba2-780m serves
// (663 tokens, padded to 768: B 1, NC 3, L 256, H 48, P 64, N 128, x bf16),
// counting each input read once and each output written once, it moves
// 19.96 MB (6.0 us at 3.35 TB/s) and does 1.236 GFLOP of the causal half
// (C B^T once per chunk 0.025, M X 0.606, states 0.604), 18.4 us at the
// 67 TFLOP/s f32 rate: bound by operations.  This kernel recomputes C B^T
// once per head group, builds M with one exp per (i, j, head), and runs its
// products on f32 FMAs without a pipeline; a one-chunk prompt gives only
// 4 x 24 y blocks and 2 x 48 state blocks for 132 SMs.  bf16 tensor cores for C B^T (exact on the
// bf16 values the model feeds it) and more blocks for one-chunk prompts are
// the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kT = 64;             // rows of i, j, l or n per tile
constexpr int kTK = 32;            // step over N of the C B^T product
constexpr int kMaxL = 256;         // longest chunk
constexpr int kHeadsPerBlock = 2;  // heads a y block shares C B^T rows with

struct Args {
  const void* x;
  const float* dt;
  const float* cum;
  const float* bm;
  const float* cm;
  float* y;
  float* st;
  int NC, L, H, P, N;
  int hpb;  // kHeadsPerBlock, read at run time (see ssd_y_kernel)
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

// Shared memory of the y kernel, in floats: cum and dt of the columns, the
// C B^T rows (kT x ldcb), then a work area used first for the C and B tiles
// of C B^T and then for the X and M tiles.
__host__ __device__ constexpr int y_work_floats(int kp) {
  return 2 * kT * (kTK + 1) > kT * kp + kT * (kT + 1)
             ? 2 * kT * (kTK + 1)
             : kT * kp + kT * (kT + 1);
}

__host__ __device__ constexpr int y_smem_floats(int ldcb, int kp) {
  return 2 * kMaxL + kT * ldcb + y_work_floats(kp);
}

// Stage rows [r0, r0 + kT) of one head's X into xs (kT x kP, f32); rows
// past L and columns past P are 0.
template <typename XT, int PC>
__device__ __forceinline__ void stage_x(float* xs, const XT* xh,
                                        const Args& a, int r0) {
  constexpr int kP = 16 * PC;
#pragma unroll
  for (int s = 0; s < kT * kP / kThreads; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int r = idx / kP, p = idx % kP;
    xs[r * kP + p] = (r0 + r < a.L && p < a.P)
                         ? to_f32(xh[(r0 + r) * a.x_sl + p])
                         : 0.f;
  }
}

// (a) y = M X for rows [i0, i0 + kT) and heads [h0, h0 + kHeadsPerBlock).
template <typename XT, int PC>
__global__ void __launch_bounds__(kThreads)
    ssd_y_kernel(const Args a, int ldcb) {
  constexpr int kP = 16 * PC;
  constexpr int kLDK = kTK + 1;
  constexpr int kLDM = kT + 1;
  extern __shared__ float smem[];
  float* cumj = smem;                      // [kMaxL]
  float* dtj = cumj + kMaxL;               // [kMaxL]
  float* cb = dtj + kMaxL;                 // [kT][ldcb]
  float* work = cb + kT * ldcb;
  float* cs = work;                        // [kT][kLDK]  (C B^T phase)
  float* bs = cs + kT * kLDK;              // [kT][kLDK]
  float* xs = work;                        // [kT][kP]    (head phase)
  float* ms = xs + kT * kP;                // [kT][kLDM]

  const int i0 = blockIdx.x * kT;
  const int h0 = blockIdx.y * a.hpb;
  const int bb = blockIdx.z / a.NC, cz = blockIdx.z % a.NC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // columns j <= i < min(L, i0 + kT) can be nonzero: skip the tiles above
  const int njt = (min(a.L, i0 + kT) + kT - 1) / kT;

  const float* cm = a.cm + bb * a.c_sb + cz * a.c_sc;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;

  // C B^T for rows i0 + ty + 16 r and columns j0 + tx + 16 c, once for all
  // heads of the block
  for (int jt = 0; jt < njt; ++jt) {
    const int j0 = jt * kT;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < a.N; k0 += kTK) {
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kT * kTK / kThreads; ++s) {
        const int idx = s * kThreads + tid;
        const int r = idx / kTK, k = idx % kTK;
        const bool kin = k0 + k < a.N;
        cs[r * kLDK + k] =
            (i0 + r < a.L && kin) ? cm[(i0 + r) * a.c_sl + k0 + k] : 0.f;
        bs[r * kLDK + k] =
            (j0 + r < a.L && kin) ? bm[(j0 + r) * a.b_sl + k0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kTK; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * kLDK + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * kLDK + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cb[(ty + 16 * r) * ldcb + j0 + tx + 16 * c] = acc[r][c];
  }

  // The group size comes from the kernel's arguments, not the constant:
  // with the head count known at compile time, nvcc builds a y kernel that
  // runs about 20 % slower on the H100 (PERF.md).
  const int hend = min(a.H, h0 + a.hpb);
  for (int h = h0; h < hend; ++h) {
    const float* dth = a.dt + bb * a.dt_sb + cz * a.dt_sc + h * a.dt_sh;
    const float* cuh = a.cum + bb * a.cu_sb + cz * a.cu_sc + h * a.cu_sh;
    const XT* xh = static_cast<const XT*>(a.x) + bb * a.x_sb +
                   cz * a.x_sc + h * a.x_sh;
    __syncthreads();     // the previous head's reads of cumj, dtj are done
    if (tid < njt * kT) {  // njt * kT <= kMaxL == kThreads
      cumj[tid] = tid < a.L ? cuh[tid * a.cu_sl] : 0.f;
      dtj[tid] = tid < a.L ? dth[tid * a.dt_sl] : 0.f;
    }
    float acc[4][PC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;

    for (int jt = 0; jt < njt; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();   // cumj, dtj, cb written; last tile's reads done
      stage_x<XT, PC>(xs, xh, a, j0);
#pragma unroll
      for (int s = 0; s < kT * kT / kThreads; ++s) {
        const int idx = s * kThreads + tid;
        const int r = idx / kT, c = idx % kT;
        const int i = i0 + r, j = j0 + c;
        float m = 0.f;
        if (i >= j && i < a.L)
          m = cb[r * ldcb + j] * expf(cumj[i] - cumj[j]) * dtj[j];
        ms[r * kLDM + c] = m;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kT; ++c) {
        float mv[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = ms[(ty + 16 * r) * kLDM + c];
#pragma unroll
        for (int q = 0; q < PC; ++q) xv[q] = xs[c * kP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < PC; ++q)
            acc[r][q] = fmaf(mv[r], xv[q], acc[r][q]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= a.L) continue;
      float* yrow =
          a.y + (((long long)blockIdx.z * a.L + i) * a.H + h) * a.P;
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        const int p = tx + 16 * q;
        if (p < a.P) yrow[p] = acc[r][q];
      }
    }
  }
}

// (b) states[n0:n0+kT, :] of head h: sum over l of (w_l B[l, n]) X[l, :].
template <typename XT, int PC>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(const Args a) {
  constexpr int kP = 16 * PC;
  constexpr int kLDB = kT + 1;
  __shared__ float w[kMaxL];
  __shared__ float bs[kT * kLDB];          // [l][n], B scaled by w
  __shared__ float xs[kT * kP];            // [l][p]

  const int n0 = blockIdx.x * kT, h = blockIdx.y;
  const int bb = blockIdx.z / a.NC, cz = blockIdx.z % a.NC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* dth = a.dt + bb * a.dt_sb + cz * a.dt_sc + h * a.dt_sh;
  const float* cuh = a.cum + bb * a.cu_sb + cz * a.cu_sc + h * a.cu_sh;
  const float* bm = a.bm + bb * a.b_sb + cz * a.b_sc;
  const XT* xh = static_cast<const XT*>(a.x) + bb * a.x_sb + cz * a.x_sc +
                 h * a.x_sh;

  const float last = cuh[(a.L - 1) * a.cu_sl];
  if (tid < a.L)       // L <= kMaxL == kThreads
    w[tid] = expf(last - cuh[tid * a.cu_sl]) * dth[tid * a.dt_sl];

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;

  for (int l0 = 0; l0 < a.L; l0 += kT) {
    __syncthreads();     // w written; the last tile's reads are done
#pragma unroll
    for (int s = 0; s < kT * kT / kThreads; ++s) {
      const int idx = s * kThreads + tid;
      const int r = idx / kT, c = idx % kT;
      bs[r * kLDB + c] = (l0 + r < a.L && n0 + c < a.N)
                             ? bm[(l0 + r) * a.b_sl + n0 + c] * w[l0 + r]
                             : 0.f;
    }
    stage_x<XT, PC>(xs, xh, a, l0);
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < kT; ++l) {
      float bv[4], xv[PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = bs[l * kLDB + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < PC; ++q) xv[q] = xs[l * kP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < PC; ++q)
          acc[r][q] = fmaf(bv[r], xv[q], acc[r][q]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty + 16 * r;
    if (n >= a.N) continue;
    float* srow =
        a.st + (((long long)blockIdx.z * a.H + h) * a.N + n) * a.P;
#pragma unroll
    for (int q = 0; q < PC; ++q) {
      const int p = tx + 16 * q;
      if (p < a.P) srow[p] = acc[r][q];
    }
  }
}

template <typename XT, int PC>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  const int ldcb = (a.L + kT - 1) / kT * kT + 1;
  const size_t smem = sizeof(float) * y_smem_floats(ldcb, 16 * PC);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel<XT, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 gy((a.L + kT - 1) / kT,
                (a.H + kHeadsPerBlock - 1) / kHeadsPerBlock, B * a.NC);
  ssd_y_kernel<XT, PC><<<gy, kThreads, smem, st>>>(a, ldcb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gs((a.N + kT - 1) / kT, a.H, B * a.NC);
  ssd_state_kernel<XT, PC><<<gs, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_p(const Args& a, int B, cudaStream_t st) {
  if (a.P <= 16) return launch<XT, 1>(a, B, st);
  if (a.P <= 32) return launch<XT, 2>(a, B, st);
  return launch<XT, 4>(a, B, st);
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16; dt, cum, B and C are float32.
// Strides are in elements; the last dim of x, B and C is contiguous.  y
// (B, NC, L, H, P) and st (B, NC, H, N, P) are contiguous float32.
// Returns the CUDA error of the launches (0 on success); the kernels run
// asynchronously on `stream`.
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* cum, const void* bm,
    const void* cm, void* y, void* st, int dtype, int B, int NC, int L,
    int H, int P, int N, long long x_sb, long long x_sc,
    long long x_sl, long long x_sh, long long dt_sb, long long dt_sc,
    long long dt_sl, long long dt_sh, long long cu_sb, long long cu_sc,
    long long cu_sl, long long cu_sh, long long b_sb, long long b_sc,
    long long b_sl, long long c_sb, long long c_sc, long long c_sl,
    void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || NC < 1 || L < 1 ||
      L > kMaxL || H < 1 || P < 1 || P > 64 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,    static_cast<const float*>(dt),
               static_cast<const float*>(cum),
               static_cast<const float*>(bm),
               static_cast<const float*>(cm),
               static_cast<float*>(y),
               static_cast<float*>(st),
               NC,   L,     H,     P,     N,     kHeadsPerBlock,
               x_sb, x_sc,  x_sl,  x_sh,  dt_sb, dt_sc, dt_sl, dt_sh,
               cu_sb, cu_sc, cu_sl, cu_sh, b_sb, b_sc, b_sl,
               c_sb, c_sc,  c_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch_p<__nv_bfloat16>(a, B, s)
                                     : launch_p<float>(a, B, s);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
