// Shared pieces of the port's hand-written CUDA kernels: the dtype codes the
// ctypes wrappers pass, element conversion to and from the fp32 accumulator
// (only through the conversion intrinsics), the device guard of the entry
// points that take a device index (matmul, matvec), and the skeleton of
// the window kernels (conv2d, maxpool): a block per output tile that stages
// its input window in shared memory, and the dispatch on the compiled
// tiles.
#pragma once

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Dynamic shared memory a launch may take without opting in to more.
constexpr size_t kSmemLimit = 48 * 1024;
// The most a block of an H100 may take after opting in with
// cudaFuncSetAttribute (227 KB of the SM's 256 KB).
constexpr size_t kSmemOptIn = 232448;

// Threads of a block that owns a BM x BN output tile: one per output up to
// 256, laid out BN along a row; each thread then owns a few rows.
template <int BM, int BN>
__host__ __device__ constexpr int tile_threads() {
  return BM * BN < 256 ? BM * BN : 256;
}

// Stages the h x w window at (row0, col0) of the row-major [m, n] plane `a`
// into `dst` as fp32, row stride w, with the NT threads of the block.  The
// block walks the window as rows of min(w, NT) threads (a thread's row and
// column are divided out once, not per element), several rows at a time
// where a row is narrower than the block.  Coalesced: consecutive threads
// read consecutive elements of a row.  Elements past the plane get `fill`;
// they feed only masked outputs.
template <int NT, typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ a,
                                             float* dst, int m, int n,
                                             int row0, int col0, int h, int w,
                                             float fill) {
  const int cols = w < NT ? w : NT;  // threads along a window row
  const int step = NT / cols;        // window rows staged at once
  const int r0 = threadIdx.x / cols, c0 = threadIdx.x % cols;
  if (r0 >= step) return;
  for (int i = r0; i < h; i += step) {
    const int gi = row0 + i;
    for (int j = c0; j < w; j += cols) {
      const int gj = col0 + j;
      dst[i * w + j] = (gi < m && gj < n)
                           ? to_float(a[static_cast<size_t>(gi) * n + gj])
                           : fill;
    }
  }
}

// Makes `device` current for a launch and restores the caller's device when
// it leaves scope.  One cudaGetDevice when the device is current already
// (the common case), so a wrapper needs no device context of its own.
struct DeviceGuard {
  int prev = -1;
  cudaError_t error = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    error = cudaGetDevice(&cur);
    if (error == cudaSuccess && cur != device) {
      error = cudaSetDevice(device);
      if (error == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// A compiled BM x BN output tile, as a tag for with_tile.
template <int M, int N>
struct Tile {
  static constexpr int BM = M, BN = N;
};

// Returns launch(Tile<BM, BN>{}) for the listed tile that equals (bm, bn),
// or cudaErrorInvalidValue when none does.
template <typename... Tiles, typename F>
int with_tile(int bm, int bn, F&& launch) {
  int code = static_cast<int>(cudaErrorInvalidValue);
  (void)((bm == Tiles::BM && bn == Tiles::BN && ((code = launch(Tiles{})), true))
         || ...);
  return code;
}

}  // namespace repro

// Each library built from a source that includes this header exports the
// message for the error codes its entry points return.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
