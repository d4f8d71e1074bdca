// Max pooling out[om,on] = max over a[i*s+di, j*s+dj], di, dj < r, of one
// [m,n] plane with an r x r window at stride s (om = (m-r)/s+1, on =
// (n-r)/s+1) for Hopper (sm_90a): fp32 or bf16, a running fp32 max from -inf,
// the result cast back to the plane's type (exact: max only selects).
//
// Replaces the TPU kernel `_mp_kernel` / `maxpool` of
// src/repro/kernels/maxpool/maxpool.py.  The Pallas kernel keeps the input
// resident in VMEM, walks a grid of (bm, bn) output tiles, loads each tile's
// input span ((bm-1)·s+r) x ((bn-1)·s+r) with `pl.dslice`, and takes the max
// over r² strided slices; ops.py pads the input with -inf so the output grid
// is a block multiple.  Here one thread block owns one BM x BN output tile,
// stages its input span in shared memory (dynamic, sized by r and s at
// launch), and each thread takes the running max of a few outputs' windows
// from it.  Every valid output's window lies inside the plane by
// construction, so nothing is padded: outputs past [om, on] are masked.
//
// NaN: `jnp.maximum` and `F.max_pool2d` propagate a NaN, while `fmaxf(acc,
// NaN)` would return acc.  The running max takes v when `v > acc || v != v`,
// so a NaN in the window wins and then stays (no comparison with it is
// true).
//
// What bounds it: each input element is read once and compared at most
// (r/s)² times, so the kernel is bound by device-memory bandwidth (3.35 TB/s
// on an H100 SXM).  At the image workload's [1020,1020] plane with r = s = 2
// that bound (5.2 MB, 1.6 us) lies under a launch's own cost.  A warp stages
// consecutive elements of one span row (coalesced); at stride 2 its window
// reads fall two-way on the shared-memory banks.  This kernel is the simple,
// exact one.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(repro::tile_threads<BM, BN>())
    mp_kernel(const T* __restrict__ a, T* __restrict__ out, int m, int n,
              int r, int s) {
  constexpr int NT = repro::tile_threads<BM, BN>();
  constexpr int TX = BN;                  // threads along n, one column each
  constexpr int TY = NT / BN;             // threads along m
  constexpr int TM = (BM + TY - 1) / TY;  // output rows a thread owns
  extern __shared__ float span[];
  const int om = (m - r) / s + 1, on = (n - r) / s + 1;
  const int sh = (BM - 1) * s + r, sw = (BN - 1) * s + r;  // sw: row stride

  const int tid = threadIdx.x;
  const int orow0 = blockIdx.y * BM, ocol0 = blockIdx.x * BN;
  // the span's origin in a is (orow0 * s, ocol0 * s)
  repro::stage_window<NT>(a, span, m, n, orow0 * s, ocol0 * s, sh, sw,
                          -INFINITY);
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  const int j = tx;
  if (ocol0 + j >= on) return;
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    const int i = ty + q * TY;
    if (i >= BM || orow0 + i >= om) break;
    float acc = -INFINITY;
    for (int di = 0; di < r; ++di) {
      const float* row = span + (i * s + di) * sw + j * s;
      for (int dj = 0; dj < r; ++dj) {
        const float v = row[dj];
        acc = (v > acc || v != v) ? v : acc;
      }
    }
    out[static_cast<size_t>(orow0 + i) * on + ocol0 + j] =
        repro::from_float<T>(acc);
  }
}

template <typename T, int BM, int BN>
int launch(const void* a, void* out, int m, int n, int r, int s,
           cudaStream_t stream) {
  const int om = (m - r) / s + 1, on = (n - r) / s + 1;
  const size_t smem = sizeof(float) * static_cast<size_t>((BM - 1) * s + r) *
                      ((BN - 1) * s + r);
  if (smem > repro::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((on + BN - 1) / BN, (om + BM - 1) / BM);
  mp_kernel<T, BM, BN><<<grid, repro::tile_threads<BM, BN>(), smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), m, n, r, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const void* a, void* out, int m, int n, int r, int s, int bm,
                int bn, cudaStream_t stream) {
  return repro::with_tile<repro::Tile<32, 32>, repro::Tile<8, 8>>(
      bm, bn, [&](auto tile) {
        using Tl = decltype(tile);
        return launch<T, Tl::BM, Tl::BN>(a, out, m, n, r, s, stream);
      });
}

}  // namespace

// out[(m-r)/s+1, (n-r)/s+1] = r x r max pooling of a[m,n] at stride s, both
// row-major and contiguous, on `stream`.  (bm, bn) is the output tile, 32x32
// or 8x8; the staged input span must fit 48 KB of shared memory.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int repro_maxpool(const void* a, void* out, int m, int n, int r,
                             int s, int bm, int bn, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || s < 1 || m < r || n < r)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return launch_tile<float>(a, out, m, n, r, s, bm, bn, st);
  if (dtype == repro::kBFloat16)
    return launch_tile<__nv_bfloat16>(a, out, m, n, r, s, bm, bn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
