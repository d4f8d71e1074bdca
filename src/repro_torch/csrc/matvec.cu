// Matrix-vector product y[m] = A[m,k] · x[k] for Hopper (sm_90a): fp32 or
// bf16 operands, fp32 accumulation, the result cast to the operands' type.
//
// Replaces the TPU kernel `_mv_kernel` / `matvec` of
// src/repro/kernels/matvec/matvec.py.  The Pallas kernel walks a grid
// (m/bm, k/bk) in order, carrying per-row fp32 partials in VMEM across the
// k steps, on operands that ops.py padded to block multiples.  Here one warp
// owns one row and sweeps the whole of k itself; eight warps (rows) share a
// 256-thread block, so m=1024 gives 128 blocks, about one per SM.  Ragged
// rows and unaligned tails are handled in the kernel, so nothing is padded.
//
// What bounds it: every element of A is read once and used for one FMA, so
// the kernel is bound by device-memory bandwidth (3.35 TB/s on an H100 SXM).
// Each lane reads A with 16-byte loads, neighbouring lanes on neighbouring
// addresses, so a warp moves 512 contiguous bytes per load; x is small and
// is re-read by every warp from L1/L2.  The lane partials are reduced with
// warp shuffles in a fixed order and no atomics, so results are bitwise
// deterministic.  At the decode workload's 1024 x 1024 (4 MB fp32) the
// bandwidth bound is about 1.25 us, under a kernel launch's own cost, so
// launch overhead, not this kernel, sets the time there.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row

// dot product of two 16-byte packets: 4 fp32 or 8 bf16 elements
__device__ __forceinline__ float dot16(const int4& av, const int4& xv,
                                       float /*tag*/) {
  const float* ap = reinterpret_cast<const float*>(&av);
  const float* xp = reinterpret_cast<const float*>(&xv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s = fmaf(ap[i], xp[i], s);
  return s;
}

__device__ __forceinline__ float dot16(const int4& av, const int4& xv,
                                       __nv_bfloat16 /*tag*/) {
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 af = __bfloat1622float2(ap[i]);
    const float2 xf = __bfloat1622float2(xp[i]);
    s = fmaf(af.x, xf.x, s);
    s = fmaf(af.y, xf.y, s);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    mv_kernel(const T* __restrict__ a, const T* __restrict__ x,
              T* __restrict__ y, int m, int k) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte packet
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp leaves together
  const T* ar = a + static_cast<size_t>(row) * k;

  float acc = 0.f;
  int kv = 0;  // elements covered by the 16-byte path
  if (((reinterpret_cast<uintptr_t>(ar) | reinterpret_cast<uintptr_t>(x)) &
       15) == 0) {
    kv = k - k % V;
    const int4* a4 = reinterpret_cast<const int4*>(ar);
    const int4* x4 = reinterpret_cast<const int4*>(x);
#pragma unroll 4
    for (int v = lane; v < kv / V; v += 32) acc += dot16(a4[v], x4[v], T());
  }
  for (int i = kv + lane; i < k; i += 32)
    acc = fmaf(repro::to_float(ar[i]), repro::to_float(x[i]), acc);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = repro::from_float<T>(acc);
}

template <typename T>
int launch(const void* a, const void* x, void* y, int m, int k,
           cudaStream_t stream) {
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  mv_kernel<T><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y),
      m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y[m] = a[m,k] @ x[k], a row-major and contiguous, x of a's type, on
// `stream`.  Returns the launch's cudaError_t (0 on success).
extern "C" int repro_matvec(const void* a, const void* x, void* y, int m,
                            int k, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch<float>(a, x, y, m, k, s);
  if (dtype == repro::kBFloat16) return launch<__nv_bfloat16>(a, x, y, m, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
