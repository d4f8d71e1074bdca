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
// is a block multiple.  Every valid output's window lies inside the plane by
// construction, so here nothing is padded: outputs past [om, on] are masked.
//
// What bounds it: each input element is read once and compared at most
// (r/s)² times, so the kernel is bound by device-memory bandwidth (3.35 TB/s
// on an H100 SXM): 5.2 MB and 1.55 us at the image workload's [1020,1020]
// plane with r = s = 2, 0.74 MB and 0.22 us at mixed_dag's [384,384], under
// a launch's own cost.
//
// The vector path (r = s = 2, input rows on 16 or 8 bytes): the windows do
// not overlap, so a thread owns one 16- or 8-byte packet of V input columns
// (V/2 outputs) and walks a strip of R output rows: it loads the 2R input
// rows' packets at once, all in flight together, takes each output's max in
// registers and writes its V/2 outputs in packets as wide as the output rows'
// alignment allows.  No shared memory.  Blocks are one row of `threads`
// threads along the columns; the grid is (column blocks, row strips).  The
// wrapper (kernels/maxpool/maxpool.py, `geometry`) picks the packets from
// the pointers and row widths and the block and strip from the tile: the
// tile now sets the most rows a thread walks and the block's width (32: 4
// rows, 128 threads; 8: 1 row, 32 threads), and a strip is shortened until
// the grid gives the 132 SMs several blocks each.
//
// The staged path (every other r and s, and planes off 8 bytes): one block
// owns one BM x BN output tile, stages its input span in shared memory
// (dynamic, sized by r and s at launch), and each thread takes the running
// max of a few outputs' windows from it.  A warp stages consecutive elements
// of one span row (coalesced).
//
// NaN: `jnp.maximum` and `F.max_pool2d` propagate a NaN, while `fmaxf(acc,
// NaN)` would return acc.  Both paths take v when `v > acc || v != v`, over
// the window in row-major order, so a NaN in the window wins and then stays
// (no comparison with it is true).

#include <cmath>
#include <cstddef>

#include "window.cuh"

namespace {

__device__ __forceinline__ float take(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// ---- the vector path (r = s = 2) -------------------------------------------

// Thread g of the launch owns input columns [g*V, g*V + V), outputs
// [g*V/2, g*V/2 + V/2), of output rows [s*R, s*R + R) for each row strip s
// of its block.
template <typename T, int V, int R>
__global__ void __launch_bounds__(256)
    mp2_kernel(const T* __restrict__ a, T* __restrict__ out, int m, int n,
               int strips, int store_bytes) {
  constexpr int W = V / 2;  // outputs a thread writes a row
  const int om = m / 2, on = n / 2;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  // n % V == 0: a packet lies inside the row, its V/2 outputs inside the
  // output row
  if (c >= n) return;
  const int j = c / 2;

  for (int s = blockIdx.y; s < strips; s += gridDim.y) {
    const int i0 = s * R;
    float x[2 * R][V];
#pragma unroll
    for (int r = 0; r < 2 * R; ++r) {
      if (2 * i0 + r < 2 * om) {
        repro::load_packet<T, V>(a + static_cast<size_t>(2 * i0 + r) * n + c,
                                 x[r]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[r][e] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i < om) {
        float y[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float acc = take(-INFINITY, x[2 * r][2 * k]);
          acc = take(acc, x[2 * r][2 * k + 1]);
          acc = take(acc, x[2 * r + 1][2 * k]);
          y[k] = take(acc, x[2 * r + 1][2 * k + 1]);
        }
        repro::store_outputs<T, W>(out + static_cast<size_t>(i) * on + j, y,
                                   on - j, store_bytes);
      }
    }
  }
}

template <typename T, int V>
int launch_vec(const void* a, void* out, int m, int n,
               const repro::Config& cfg, cudaStream_t stream) {
  constexpr int W = V / 2;
  const int om = m / 2, on = n / 2;
  // the wrapper's packets must fit the pointers and the row widths
  if (!repro::rows_aligned<T>(a, n, V * sizeof(T)) ||
      !repro::rows_aligned<T>(out, on, cfg.store_bytes) ||
      cfg.store_bytes > W * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (cfg.threads < 32 || cfg.threads > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::with_rows(cfg.rows, [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    const int groups = (n + V - 1) / V;
    const int strips = (om + R - 1) / R;
    const dim3 grid((groups + cfg.threads - 1) / cfg.threads,
                    strips < repro::kMaxGridY ? strips : repro::kMaxGridY);
    mp2_kernel<T, V, R><<<grid, cfg.threads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<T*>(out), m, n, strips,
        cfg.store_bytes);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---- the staged path (any r, s) --------------------------------------------

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
      for (int dj = 0; dj < r; ++dj) acc = take(acc, row[dj]);
    }
    out[static_cast<size_t>(orow0 + i) * on + ocol0 + j] =
        repro::from_float<T>(acc);
  }
}

template <typename T, int BM, int BN>
int launch_staged(const void* a, void* out, int m, int n, int r, int s,
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

// ---- dispatch --------------------------------------------------------------

template <typename T>
int launch(const void* a, void* out, int m, int n, int r, int s,
           const repro::Config& cfg, cudaStream_t stream) {
  if (cfg.load_bytes != 0 && (r != 2 || s != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cfg.load_bytes == 16)
    return launch_vec<T, 16 / sizeof(T)>(a, out, m, n, cfg, stream);
  if (cfg.load_bytes == 8)
    return launch_vec<T, 8 / sizeof(T)>(a, out, m, n, cfg, stream);
  if (cfg.load_bytes != 0) return static_cast<int>(cudaErrorInvalidValue);
  return repro::with_tile<repro::Tile<32, 32>, repro::Tile<8, 8>>(
      cfg.tile, cfg.tile, [&](auto tile) {
        using Tl = decltype(tile);
        return launch_staged<T, Tl::BM, Tl::BN>(a, out, m, n, r, s, stream);
      });
}

}  // namespace

// out[(m-r)/s+1, (n-r)/s+1] = r x r max pooling of a[m,n] at stride s, both
// row-major and contiguous, on `stream`: shape = m | n << 32, window = r |
// s << 16, and config the wrapper's packed launch configuration
// (`repro::Config`: dtype, packet bytes, rows a thread walks, block width,
// tile, device).  The staged path's input span must fit 48 KB of shared
// memory.  Does its own device guard and returns the launch's cudaError_t
// (0 on success).
extern "C" int repro_maxpool(const void* a, void* out, long long shape,
                             int window, long long config, void* stream) {
  const int m = static_cast<int>(shape & 0xffffffffLL);
  const int n = static_cast<int>(shape >> 32);
  const int r = window & 0xffff, s = window >> 16;
  const repro::Config cfg(config);
  if (r < 1 || s < 1 || m < r || n < r)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::DeviceGuard guard(cfg.device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cfg.dtype == repro::kFloat32)
    return launch<float>(a, out, m, n, r, s, cfg, st);
  if (cfg.dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(a, out, m, n, r, s, cfg, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
