// Tiled matrix product C[m,n] = A[m,k] · B[k,n] for Hopper (sm_90a): fp32 or
// bf16 operands, fp32 accumulation with plain FMAs (no TF32, no tensor
// cores), the result cast to the operands' type at the end.
//
// Replaces the TPU kernel `_mm_kernel` / `matmul` of
// src/repro/kernels/matmul/matmul.py.  The Pallas kernel walks a grid
// (m/bm, n/bn, k/bk) in order with an fp32 VMEM accumulator carried across
// the innermost k steps, and relies on ops.py padding every operand to block
// multiples.  Here one thread block owns one BM x BN output tile and walks
// the whole contraction itself (blocks run in parallel and in no order, so
// nothing is carried between them); the ragged edges are masked in the
// kernel, so no padded copies are made.
//
// What bounds it: at the workload shapes (m=256, k and n of 1024/2048) the
// product does 1.07 GFLOP on 11 MB of fp32 operands and result, about 97
// FLOP a byte against the card's fp32 ridge of 20, so it is bound by fp32
// FMA issue (67 TFLOP/s on an H100 SXM outside the tensor cores).  The design keeps the FMA units fed from
// registers: each k slice of A and B is staged once in shared memory as
// fp32, and every thread computes a TM x TN register micro-tile from it, so
// each shared-memory read feeds TM (or TN) FMAs.  The two output tiles are
// the registry's two schedules (`pallas_32`, `pallas_128`): the 32 tile
// gives many blocks and little reuse, the 128 tile much reuse and few
// blocks at m=256; the predictor chooses between them.  The k slice is 32
// deep for both, so the 128 tile's fp32 A and B slices take 32.5 KB and fit
// the 48 KB of static shared memory.  TMA, wgmma and a pipelined ring of
// slices are left for later work: this kernel is the simple, exact one.

#include <cstddef>

#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int m, int n, int k) {
  constexpr int TX = BN / TN;  // threads along n
  constexpr int TY = BM / TM;  // threads along m
  constexpr int NT = TX * TY;
  // A slice stored k-major so the inner loop reads a column of it; the extra
  // column puts the 32 stores of a warp (one A row) in 32 different banks
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // coalesced loads: a warp reads BK consecutive elements of one A row,
    // and 32 consecutive elements of one B row; out-of-range reads become 0
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, q = e % BK;
      const int gr = row0 + r, gq = k0 + q;
      as[q][r] = (gr < m && gq < k)
                     ? repro::to_float(a[static_cast<size_t>(gr) * k + gq])
                     : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int q = e / BN, s = e % BN;
      const int gq = k0 + q, gs = col0 + s;
      bs[q][s] = (gq < k && gs < n)
                     ? repro::to_float(b[static_cast<size_t>(gq) * n + gs])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      // a thread's rows and columns are strided by TY and TX, so the 16
      // threads of a half-warp read 16 consecutive words (no bank conflict)
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[q][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[q][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int s = col0 + tx + j * TX;
      if (s < n)
        c[static_cast<size_t>(r) * n + s] = repro::from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const void* a, const void* b, void* c, int m, int n, int k,
                int tile, cudaStream_t stream) {
  // 256 threads for both tiles: 2x2 outputs a thread at 32, 8x8 at 128
  if (tile == 32) return launch<T, 32, 32, 32, 2, 2>(a, b, c, m, n, k, stream);
  if (tile == 128) return launch<T, 128, 128, 32, 8, 8>(a, b, c, m, n, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// c[m,n] = a[m,k] @ b[k,n], all row-major and contiguous, on `stream`.
// `tile` is the output tile edge (32 or 128); the k slice is 32 for both.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m,
                            int n, int k, int dtype, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_tile<float>(a, b, c, m, n, k, tile, s);
  if (dtype == repro::kBFloat16)
    return launch_tile<__nv_bfloat16>(a, b, c, m, n, k, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
