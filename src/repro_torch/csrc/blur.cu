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
// padding changes a value.
//
// What bounds it: each input element is read once from device memory and
// each output written once, under 1 FLOP a byte against the card's fp32
// ridge of 20, so every pass is bound by device-memory bandwidth (3.35 TB/s
// on an H100 SXM): 8.37 MB in and out at the image workload's [1024,1024]
// plane, 2.5 us.  To stream at that rate the card needs loads in flight on
// every SM, so the plane is cut finely and every load is a wide one.
//
// The vector path (input planes whose base and rows lie on 16 or 8 bytes):
// a thread owns V consecutive columns (one 16- or 8-byte packet: V = 4 or 2
// fp32, 8 or 4 bf16) of a strip of R output rows.  It loads the R+2
// (direct, v) or R (h) input rows' packets at once, all in flight
// together, widens them to fp32 in registers, and takes the two columns
// right of its packet from the next lane by warp shuffle (the warp's last
// lane loads them itself).  Each input element thus leaves device memory
// once (the strips' two halo rows are re-read from L2) and is reused from
// registers.  Blocks are one row of `threads` threads along the columns; the grid is
// (column blocks, row strips).  The wrapper (kernels/blur/blur.py,
// `geometry`) picks the packets from the pointers and row widths and the
// block and strip from the tile: the tile now sets the most rows a thread
// walks and the block's width (128: 4 rows, 128 threads; 16: 2 rows, 32
// threads), and a strip is shortened until the grid gives the 132 SMs
// several blocks each.  Outputs are written in packets as wide as the output
// rows' alignment allows (the [1024,1022] h rows lie on 8 bytes, not 16).
//
// The staged path (rows off 8 bytes: misaligned bases, odd widths): one
// block per BM x BN output tile stages the tile's input window, (BM+2) x
// (BN+2) for direct, BM x (BN+2) for h, (BM+2) x BN for v, as fp32 in shared
// memory (67,600 bytes at 128, so such launches opt in above 48 KB) and each
// thread sums a few outputs' taps from it.
//
// Both paths mask ragged edges, so nothing is padded, and both keep the
// arithmetic of the plain PyTorch version bit for bit: the sums run in the
// Pallas order (direct from a zero accumulator, each pass from its first
// tap), every add and the final multiply are rounded as written
// (`__fadd_rn`/`__fmul_rn`), the scales are the fp32 roundings of 1/9 and
// 1/3, and the h pass stores h in the plane's type, so with bf16 input h is
// rounded to bf16 between the passes, as the Pallas `out_shape` rounds it.

#include <cstddef>

#include "window.cuh"

namespace {

enum Pass : int { kDirect = 0, kH = 1, kV = 2 };

// Tap extents of a pass: rows and columns of the window one output reads.
template <int P>
__host__ __device__ constexpr int taps_h() { return P == kH ? 1 : 3; }
template <int P>
__host__ __device__ constexpr int taps_w() { return P == kV ? 1 : 3; }

template <int P>
__device__ __forceinline__ float scale() {
  return P == kDirect ? static_cast<float>(1.0 / 9.0)
                      : static_cast<float>(1.0 / 3.0);
}

// ---- the vector path -------------------------------------------------------

// One pass over a [m, n] plane `a` into out [om, on]: thread g of the launch
// owns columns [g*V, g*V + V) of output rows [s*R, s*R + R) for each row
// strip s of its block.
template <typename T, int P, int V, int R>
__global__ void __launch_bounds__(256)
    blur_vec_kernel(const T* __restrict__ a, T* __restrict__ out, int m,
                    int n, int strips, int store_bytes) {
  constexpr int KH = taps_h<P>(), KW = taps_w<P>();
  constexpr int RI = R + KH - 1;  // input rows a strip reads
  constexpr int X = V + KW - 1;   // input columns a thread's outputs read
  const int om = m - KH + 1, on = n - KW + 1;
  const int lane = threadIdx.x & 31;
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool in_row = j < n;  // the packet lies inside the row (n % V == 0)

  for (int s = blockIdx.y; s < strips; s += gridDim.y) {
    const int i0 = s * R;
    // every row's packet first, so that all of them are in flight at once
    float x[RI][X];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      float v[V];
      if (in_row && i0 + r < m) {
        repro::load_packet<T, V>(a + static_cast<size_t>(i0 + r) * n + j, v);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) x[r][e] = v[e];
    }
    // the columns right of the packet: the next lane's first elements (all
    // lanes take part in the shuffle; the last lane loads its own)
#pragma unroll
    for (int r = 0; r < RI; ++r) {
#pragma unroll
      for (int e = V; e < X; ++e) {
        float y = __shfl_down_sync(0xffffffffu, x[r][e - V], 1);
        if (lane == 31)
          y = (j + e < n && i0 + r < m)
                  ? repro::to_float(a[static_cast<size_t>(i0 + r) * n + j + e])
                  : 0.f;
        x[r][e] = y;
      }
    }
    if (j < on) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r;
        if (i < om) {
          float y[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            // direct starts from a zero accumulator, each separable pass
            // from its first tap, as the Pallas bodies do
            float acc = P == kDirect ? __fadd_rn(0.f, x[r][e]) : x[r][e];
#pragma unroll
            for (int t = 1; t < KH * KW; ++t)
              acc = __fadd_rn(acc, x[r + t / KW][e + t % KW]);
            y[e] = __fmul_rn(acc, scale<P>());
          }
          repro::store_outputs<T, V>(out + static_cast<size_t>(i) * on + j,
                                     y, on - j, store_bytes);
        }
      }
    }
  }
}

template <typename T, int P, int V>
int launch_vec(const void* a, void* out, int m, int n,
               const repro::Config& cfg, cudaStream_t stream) {
  const int om = m - taps_h<P>() + 1, on = n - taps_w<P>() + 1;
  // the wrapper's packets must fit the pointers and the row widths
  if (!repro::rows_aligned<T>(a, n, V * sizeof(T)) ||
      !repro::rows_aligned<T>(out, on, cfg.store_bytes) ||
      cfg.store_bytes > V * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (cfg.threads < 32 || cfg.threads > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::with_rows(cfg.rows, [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    const int groups = (n + V - 1) / V;
    const int strips = (om + R - 1) / R;
    const dim3 grid((groups + cfg.threads - 1) / cfg.threads,
                    strips < repro::kMaxGridY ? strips : repro::kMaxGridY);
    blur_vec_kernel<T, P, V, R><<<grid, cfg.threads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<T*>(out), m, n, strips,
        cfg.store_bytes);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---- the staged path -------------------------------------------------------

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
    float acc = P == kDirect ? __fadd_rn(0.f, base[0]) : base[0];
#pragma unroll
    for (int t = 1; t < KH * KW; ++t)
      acc = __fadd_rn(acc, base[(t / KW) * ww + t % KW]);
    out[static_cast<size_t>(row0 + i) * on + col0 + j] =
        repro::from_float<T>(__fmul_rn(acc, scale<P>()));
  }
}

template <typename T, int BM, int BN, int P>
int launch_staged(const void* a, void* out, int m, int n,
                  cudaStream_t stream) {
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

// ---- dispatch --------------------------------------------------------------

template <typename T, int P>
int launch(const void* a, void* out, int m, int n, const repro::Config& cfg,
           cudaStream_t stream) {
  if (cfg.load_bytes == 16) return launch_vec<T, P, 16 / sizeof(T)>(
      a, out, m, n, cfg, stream);
  if (cfg.load_bytes == 8) return launch_vec<T, P, 8 / sizeof(T)>(
      a, out, m, n, cfg, stream);
  if (cfg.load_bytes != 0) return static_cast<int>(cudaErrorInvalidValue);
  return repro::with_tile<repro::Tile<128, 128>, repro::Tile<16, 16>>(
      cfg.tile, cfg.tile, [&](auto tile) {
        using Tl = decltype(tile);
        return launch_staged<T, Tl::BM, Tl::BN, P>(a, out, m, n, stream);
      });
}

template <int P>
int launch_pass(const void* a, void* out, long long shape, long long config,
                void* stream) {
  const int m = static_cast<int>(shape & 0xffffffffLL);
  const int n = static_cast<int>(shape >> 32);
  const repro::Config cfg(config);
  if (m < taps_h<P>() || n < taps_w<P>())
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::DeviceGuard guard(cfg.device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg.dtype == repro::kFloat32)
    return launch<float, P>(a, out, m, n, cfg, s);
  if (cfg.dtype == repro::kBFloat16)
    return launch<__nv_bfloat16, P>(a, out, m, n, cfg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point takes a[m,n] and writes out, both row-major and
// contiguous, on `stream`: shape = m | n << 32, and config the wrapper's
// packed launch configuration (`repro::Config`: dtype, packet bytes, rows a
// thread walks, block width, tile, device).  Each does its own device guard
// and returns the launch's cudaError_t (0 on success).

// out[m-2, n-2]: the fused 3x3 box mean.
extern "C" int repro_blur_direct(const void* a, void* out, long long shape,
                                 long long config, void* stream) {
  return launch_pass<kDirect>(a, out, shape, config, stream);
}

// h[m, n-2]: the 1x3 row mean, in a's type (pass 1 of the separable blur).
extern "C" int repro_blur_h(const void* a, void* h, long long shape,
                            long long config, void* stream) {
  return launch_pass<kH>(a, h, shape, config, stream);
}

// out[m-2, n]: the 3x1 column mean of h[m, n] (pass 2).
extern "C" int repro_blur_v(const void* h, void* out, long long shape,
                            long long config, void* stream) {
  return launch_pass<kV>(h, out, shape, config, stream);
}
