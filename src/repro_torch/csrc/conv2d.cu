// Valid 2-D cross-correlation out[om,on] = sum_{di,dj} a[i+di, j+dj]·w[di,dj]
// of one [m,n] plane with [r,r] taps (om = m-r+1, on = n-r+1) for Hopper
// (sm_90a): fp32 or bf16 operands, fp32 accumulation, the result cast to the
// operands' type at the end.
//
// Replaces the TPU kernel `_conv_kernel` / `conv2d` of
// src/repro/kernels/conv2d/conv2d.py.  The Pallas kernel keeps the whole
// input resident in VMEM, walks a grid of (bm, bn) output tiles, loads each
// tile's (bm+r-1) x (bn+r-1) halo window with `pl.dslice`, and unrolls the r²
// taps into shift-multiply-accumulates; ops.py pads the output grid to block
// multiples.  Here one thread block owns one BM x BN output tile: it stages
// its halo window of `a`, converted to fp32, and the r² taps in shared
// memory (dynamic, sized by r at launch), and each thread then accumulates a
// few outputs from shared memory.  Ragged edges are masked in the kernel,
// so nothing is padded.
//
// Taps run in the Pallas kernel's order (di outer, dj inner), and each
// product is rounded before it is added (`__fmul_rn`/`__fadd_rn` forbid the
// compiler's fused multiply-add), as the plain PyTorch version computes
// them: in fp32 the kernel agrees with it bit for bit.
//
// What bounds it: at the image workload's [1022,1022] plane (the blur's
// output) with r=3 each input element is read once from device memory and
// reused r² times from shared memory, about 2.2 FLOP a byte against the
// card's fp32 ridge of 20, so it is bound by device-memory bandwidth
// (3.35 TB/s on an H100 SXM).  At 8.3 MB that bound (2.5 us) lies under a
// launch's own cost.  The halo
// re-read between neighbouring tiles ((r-1)/32 of a 32 tile's edge) stays in
// L2.  A warp reads 32 consecutive elements of one staged row per tap, so
// shared-memory reads are free of bank conflicts at the 32 tile.  TMA loads
// of the halo and wider register tiles are left for later work: this kernel
// is the simple, exact one.

#include <cstddef>

#include "common.cuh"

namespace {

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(repro::tile_threads<BM, BN>())
    conv_kernel(const T* __restrict__ a, const T* __restrict__ w,
                T* __restrict__ out, int m, int n, int r) {
  constexpr int NT = repro::tile_threads<BM, BN>();
  constexpr int TX = BN;                  // threads along n, one column each
  constexpr int TY = NT / BN;             // threads along m
  constexpr int TM = (BM + TY - 1) / TY;  // output rows a thread owns
  extern __shared__ float smem[];
  const int om = m - r + 1, on = n - r + 1;
  const int hh = BM + r - 1, hw = BN + r - 1;  // halo window, hw = row stride
  float* tile = smem;                          // [hh][hw]
  float* taps = smem + hh * hw;                // [r][r]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  repro::stage_window<NT>(a, tile, m, n, row0, col0, hh, hw, 0.f);
  for (int e = tid; e < r * r; e += NT) taps[e] = repro::to_float(w[e]);
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  const int j = tx;
  if (col0 + j >= on) return;
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    const int i = ty + q * TY;
    if (i >= BM || row0 + i >= om) break;
    float acc = 0.f;
    for (int di = 0; di < r; ++di) {
      const float* row = tile + (i + di) * hw + j;
      const float* wr = taps + di * r;
      for (int dj = 0; dj < r; ++dj)
        acc = __fadd_rn(acc, __fmul_rn(row[dj], wr[dj]));
    }
    out[static_cast<size_t>(row0 + i) * on + col0 + j] =
        repro::from_float<T>(acc);
  }
}

template <typename T, int BM, int BN>
int launch(const void* a, const void* w, void* out, int m, int n, int r,
           cudaStream_t stream) {
  const int om = m - r + 1, on = n - r + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BM + r - 1) * (BN + r - 1) + r * r);
  if (smem > repro::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((on + BN - 1) / BN, (om + BM - 1) / BM);
  conv_kernel<T, BM, BN><<<grid, repro::tile_threads<BM, BN>(), smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<T*>(out),
      m, n, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const void* a, const void* w, void* out, int m, int n, int r,
                int bm, int bn, cudaStream_t stream) {
  return repro::with_tile<repro::Tile<32, 32>, repro::Tile<16, 16>>(
      bm, bn, [&](auto tile) {
        using Tl = decltype(tile);
        return launch<T, Tl::BM, Tl::BN>(a, w, out, m, n, r, stream);
      });
}

}  // namespace

// out[m-r+1, n-r+1] = valid cross-correlation of a[m,n] with w[r,r], all
// row-major and contiguous, on `stream`.  (bm, bn) is the output tile, 32x32
// or 16x16; the staged halo window must fit 48 KB of shared memory.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int repro_conv2d(const void* a, const void* w, void* out, int m,
                            int n, int r, int bm, int bn, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 1 || m < r || n < r) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return launch_tile<float>(a, w, out, m, n, r, bm, bn, s);
  if (dtype == repro::kBFloat16)
    return launch_tile<__nv_bfloat16>(a, w, out, m, n, r, bm, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
