// 3x3 box blur of one [m,n] plane, valid region, out[om,on] with om = m-2,
// on = n-2, for Hopper (sm_90a): fp32 or bf16, fp32 sums, the result cast
// to the plane's type.  Two schedules, as the TPU kernels have:
//
//   direct     out[i,j] = (0 + the nine taps a[i+di, j+dj], di and dj
//              row-major) * (1/9)
//   separable  h[i,j]   = (a[i,j] + a[i,j+1] + a[i,j+2]) * (1/3), stored in
//              the plane's type, i in [0, m);
//              out[i,j] = (h[i,j] + h[i+1,j] + h[i+2,j]) * (1/3)
//
// Replaces the TPU kernels `_blur_direct_kernel`, `_blur_h_kernel` and
// `_blur_v_kernel` / `blur` of src/repro/kernels/blur/blur.py.  The Pallas
// kernels keep the whole input resident in VMEM and walk a grid of (bm, bn)
// output tiles, loading each tile's window with `pl.dslice`; ops.py pads the
// plane so the grid is a block multiple, and the separable path pads pass
// 1's rows up to a bm multiple and cuts h back to om+2 rows.  None of that
// padding changes a value.  Here one thread block owns one BM x BN output
// tile of one pass: it stages the tile's input window, (BM+2) x (BN+2) for
// direct, BM x (BN+2) for the h pass, (BM+2) x BN for the v pass, converted
// to fp32, in shared memory, and each thread sums a few outputs' taps from
// it.  Ragged edges are masked in the kernel, so nothing is padded.
//
// Arithmetic, to agree with the plain PyTorch version bit for bit: the sums
// run in the Pallas order (direct from a zero accumulator, each pass from its
// first tap), every add and the final multiply are rounded as written
// (`__fadd_rn`/`__fmul_rn`), the scales are the fp32 roundings of 1/9 and
// 1/3, and the h pass stores h in the plane's type, so with bf16 input h is
// rounded to bf16 between the passes, as the Pallas `out_shape` rounds it.
//
// Shared memory: at the registry's 128 x 128 tile the fp32 window takes
// 67,600 bytes (direct) or 66,560 (one pass), above the 48 KB a launch gets
// without asking, so such launches opt in with cudaFuncSetAttribute; the
// 16 x 16 tile of the JAX package's tests stages 1,296 bytes.
//
// What bounds it: each input element is read once from device memory and
// reused nine (or three) times from shared memory, under 1 FLOP a byte
// against the card's fp32 ridge of 20, so it is bound by device-memory
// bandwidth (3.35 TB/s on an H100 SXM): 8.37 MB in and out at the image
// workload's [1024,1024] plane, 2.5 us, under a launch's own cost.  The
// separable schedule moves h through device memory as well (about twice the
// bytes); it stays for parity with the TPU kernels' schedule space.  A warp
// stages consecutive elements of a window row (coalesced) and reads
// consecutive staged elements per tap, free of bank conflicts.  This kernel
// is the simple, exact one.

#include <cstddef>

#include "common.cuh"

namespace {

enum Pass : int { kDirect = 0, kH = 1, kV = 2 };

// Tap extents of a pass: rows and columns of the window one output reads.
template <int P>
__host__ __device__ constexpr int taps_h() { return P == kH ? 1 : 3; }
template <int P>
__host__ __device__ constexpr int taps_w() { return P == kV ? 1 : 3; }

template <int BM, int BN, int P>
constexpr size_t window_bytes() {
  return sizeof(float) * static_cast<size_t>(BM + taps_h<P>() - 1) *
         (BN + taps_w<P>() - 1);
}

// One pass over a [m, n] plane `a` into out [m - taps_h + 1, n - taps_w + 1].
template <typename T, int BM, int BN, int P>
__global__ void __launch_bounds__(repro::tile_threads<BM, BN>())
    blur_kernel(const T* __restrict__ a, T* __restrict__ out, int m, int n) {
  constexpr int NT = repro::tile_threads<BM, BN>();
  constexpr int TX = BN;                  // threads along n, one column each
  constexpr int TY = NT / BN;             // threads along m
  constexpr int TM = (BM + TY - 1) / TY;  // output rows a thread owns
  constexpr int KH = taps_h<P>(), KW = taps_w<P>();
  extern __shared__ float window[];
  const int om = m - KH + 1, on = n - KW + 1;
  const int wh = BM + KH - 1, ww = BN + KW - 1;  // ww: row stride
  const float scale = P == kDirect ? static_cast<float>(1.0 / 9.0)
                                   : static_cast<float>(1.0 / 3.0);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  repro::stage_window<NT>(a, window, m, n, row0, col0, wh, ww, 0.f);
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  const int j = tx;
  if (col0 + j >= on) return;
#pragma unroll 4
  for (int q = 0; q < TM; ++q) {
    const int i = ty + q * TY;
    if (i >= BM || row0 + i >= om) break;
    const float* base = window + i * ww + j;
    // direct starts from a zero accumulator, each separable pass from its
    // first tap, as the Pallas bodies do
    float acc = P == kDirect ? __fadd_rn(0.f, base[0]) : base[0];
#pragma unroll
    for (int t = 1; t < KH * KW; ++t)
      acc = __fadd_rn(acc, base[(t / KW) * ww + t % KW]);
    out[static_cast<size_t>(row0 + i) * on + col0 + j] =
        repro::from_float<T>(__fmul_rn(acc, scale));
  }
}

template <typename T, int BM, int BN, int P>
int launch(const void* a, void* out, int m, int n, cudaStream_t stream) {
  constexpr size_t smem = window_bytes<BM, BN, P>();
  static_assert(smem <= repro::kSmemOptIn, "window above 227 KB");
  auto kernel = blur_kernel<T, BM, BN, P>;
  if (smem > repro::kSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int om = m - taps_h<P>() + 1, on = n - taps_w<P>() + 1;
  const dim3 grid((on + BN - 1) / BN, (om + BM - 1) / BM);
  kernel<<<grid, repro::tile_threads<BM, BN>(), smem, stream>>>(
      static_cast<const T*>(a), static_cast<T*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_tile(const void* a, void* out, int m, int n, int bm, int bn,
                cudaStream_t stream) {
  return repro::with_tile<repro::Tile<128, 128>, repro::Tile<16, 16>>(
      bm, bn, [&](auto tile) {
        using Tl = decltype(tile);
        return launch<T, Tl::BM, Tl::BN, P>(a, out, m, n, stream);
      });
}

template <int P>
int launch_pass(const void* a, void* out, int m, int n, int bm, int bn,
                int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < taps_h<P>() || n < taps_w<P>())
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return launch_tile<float, P>(a, out, m, n, bm, bn, s);
  if (dtype == repro::kBFloat16)
    return launch_tile<__nv_bfloat16, P>(a, out, m, n, bm, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point takes a[m,n] and writes out, both row-major and
// contiguous, on `stream`; (bm, bn) is the output tile, 128x128 or 16x16.
// Each returns the launch's cudaError_t (0 on success).

// out[m-2, n-2]: the fused 3x3 box mean.
extern "C" int repro_blur_direct(const void* a, void* out, int m, int n,
                                 int bm, int bn, int dtype, void* stream) {
  return launch_pass<kDirect>(a, out, m, n, bm, bn, dtype, stream);
}

// h[m, n-2]: the 1x3 row mean, in a's type (pass 1 of the separable blur).
extern "C" int repro_blur_h(const void* a, void* h, int m, int n, int bm,
                            int bn, int dtype, void* stream) {
  return launch_pass<kH>(a, h, m, n, bm, bn, dtype, stream);
}

// out[m-2, n]: the 3x1 column mean of h[m, n] (pass 2).
extern "C" int repro_blur_v(const void* h, void* out, int m, int n, int bm,
                            int bn, int dtype, void* stream) {
  return launch_pass<kV>(h, out, m, n, bm, bn, dtype, stream);
}
