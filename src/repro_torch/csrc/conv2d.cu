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
// multiples.  Here ragged edges are masked in the kernel, so nothing is
// padded.
//
// Taps run in the Pallas kernel's order (di outer, dj inner), and each
// product is rounded before it is added (`__fmul_rn`/`__fadd_rn` forbid the
// compiler's fused multiply-add), from a zero accumulator, as the plain
// PyTorch version computes them: in fp32 and bf16 both paths agree with it
// bit for bit.
//
// What bounds it: at the image workload's [1022,1022] plane (the blur's
// output) with r=3 each input element is read once from device memory and
// reused r² times, about 2.2 FLOP a byte against the card's fp32 ridge of
// 20, so it is bound by device-memory bandwidth (3.35 TB/s on an H100 SXM):
// 8.3 MB in and out, 2.5 us.  To stream at that rate the card needs wide
// loads in flight on every SM, so the plane is cut finely.
//
// The vector path (taps r = 3, 5 or 7, compiled; input rows whose base and
// width lie on 16 or 8 bytes): a thread owns V consecutive columns (one 16- or
// 8-byte packet: V = 4 or 2 fp32, 8 or 4 bf16) of a strip of R output rows, the
// blur's direct pass with r² taps.  It issues the loads of the strip's R+r-1
// input rows' packets at once, all in flight together, with those of the
// columns past the packet that the warp's last lanes read themselves (their
// neighbours lie in the next warp), then streams the rows in order through
// registers: each row is widened to fp32, its r-1 columns past the packet come
// from the next lanes by `__shfl_down_sync`, and the row adds its taps to every
// output row of the strip it feeds.  Rows arrive in order, so each output still
// adds its taps di outer, dj inner.  The taps live in registers.  (Loading the
// last lanes' columns after the shuffles, as the blur does, cost a second
// memory round trip a strip: 4.8 against 4.3 us at the workload's plane.)  Each
// input element thus leaves device memory once (the strips' r-1 halo rows are
// re-read from L2), with no shared memory and no per-element index arithmetic.
// Blocks are one row of `threads` threads along the columns; the grid is
// (column blocks, row strips).  The wrapper (kernels/conv2d/conv2d.py,
// `geometry`) picks the packets from the pointers and row widths, and the block
// and strip from the tile (32: 4 rows, 128 threads; 16: 2 rows, 32 threads), a
// strip shortened until the grid gives the 132 SMs several blocks each.
// Outputs are written in packets as wide as the output rows' alignment allows.
//
// The staged path (every other r, and planes off 8 bytes): one thread block
// owns one BM x BN output tile, 32x32 or 16x16: it stages its halo window
// of `a`, converted to fp32, and the r² taps in shared memory (dynamic,
// sized by r at launch), and each thread then accumulates a few outputs
// from shared memory.  A warp reads 32 consecutive elements of one staged
// row per tap, free of bank conflicts at the 32 tile.

#include <cstddef>
#include <type_traits>

#include "window.cuh"

namespace {

// ---- the vector path (r = 3, 5, 7) -----------------------------------------

// Thread g of the launch owns columns [g*V, g*V + V) of output rows
// [s*R, s*R + R) for each row strip s of its block; RT is the tap count r.
template <typename T, int V, int R, int RT>
__global__ void __launch_bounds__(256)
    conv_vec_kernel(const T* __restrict__ a, const T* __restrict__ w,
                    T* __restrict__ out, int m, int n, int strips,
                    int store_bytes) {
  constexpr int RI = R + RT - 1;  // input rows a strip reads
  constexpr int X = V + RT - 1;   // input columns a thread's outputs read
  const int om = m - RT + 1, on = n - RT + 1;
  const int lane = threadIdx.x & 31;
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool in_row = j < n;  // the packet lies inside the row (n % V == 0)

  float taps[RT * RT];
#pragma unroll
  for (int e = 0; e < RT * RT; ++e) taps[e] = repro::to_float(w[e]);

  for (int s = blockIdx.y; s < strips; s += gridDim.y) {
    const int i0 = s * R;
    // every row's packet first, so that all of them are in flight at once
    repro::PacketOf<T, V> raw[RI];
#pragma unroll
    for (int r = 0; r < RI; ++r)
      raw[r] = in_row && i0 + r < m
                   ? repro::fetch_packet<T, V>(
                         a + static_cast<size_t>(i0 + r) * n + j)
                   : repro::PacketOf<T, V>{};
    // the columns past the packet that a lane near the warp's end reads
    // itself (the lane that holds them lies in the next warp), issued with
    // the packets
    float edge[RI][X - V];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int e = V; e < X; ++e)
        edge[r][e - V] =
            lane + e / V > 31 && j + e < n && i0 + r < m
                ? repro::to_float(a[static_cast<size_t>(i0 + r) * n + j + e])
                : 0.f;
    float acc[R][V];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[o][e] = 0.f;
    // the rows in order: input row r feeds output row o through tap row
    // di = r - o
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      float x[X];
      repro::widen<T, V>(raw[r], x);
      // the columns past the packet: element e % V of lane + e / V (all
      // lanes take part in the shuffles; lanes whose source lies past the
      // warp take their own loads)
#pragma unroll
      for (int e = V; e < X; ++e) {
        const float y = __shfl_down_sync(0xffffffffu, x[e % V], e / V);
        x[e] = lane + e / V > 31 ? edge[r][e - V] : y;
      }
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int di = r - o;
        if (di < 0 || di >= RT) continue;
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int dj = 0; dj < RT; ++dj)
            acc[o][e] = __fadd_rn(acc[o][e],
                                  __fmul_rn(x[e + dj], taps[di * RT + dj]));
      }
    }
    if (j < on) {
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int i = i0 + o;
        if (i < om)
          repro::store_outputs<T, V>(out + static_cast<size_t>(i) * on + j,
                                     acc[o], on - j, store_bytes);
      }
    }
  }
}

// Calls launch(std::integral_constant<int, RT>) for the compiled tap
// counts; cudaErrorInvalidValue for any other.
template <typename F>
int with_taps(int r, F&& launch) {
  switch (r) {
    case 3: return launch(std::integral_constant<int, 3>{});
    case 5: return launch(std::integral_constant<int, 5>{});
    case 7: return launch(std::integral_constant<int, 7>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int V>
int launch_vec(const void* a, const void* w, void* out, int m, int n, int r,
               const repro::Config& cfg, cudaStream_t stream) {
  const int om = m - r + 1, on = n - r + 1;
  // the wrapper's packets must fit the pointers and the row widths
  if (!repro::rows_aligned<T>(a, n, V * sizeof(T)) ||
      !repro::rows_aligned<T>(out, on, cfg.store_bytes) ||
      cfg.store_bytes > V * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (cfg.threads < 32 || cfg.threads > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_taps(r, [&](auto taps) {
    constexpr int RT = decltype(taps)::value;
    return repro::with_rows(cfg.rows, [&](auto rows) {
      constexpr int R = decltype(rows)::value;
      const int groups = (n + V - 1) / V;
      const int strips = (om + R - 1) / R;
      const dim3 grid((groups + cfg.threads - 1) / cfg.threads,
                      strips < repro::kMaxGridY ? strips : repro::kMaxGridY);
      conv_vec_kernel<T, V, R, RT><<<grid, cfg.threads, 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(w),
          static_cast<T*>(out), m, n, strips, cfg.store_bytes);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// ---- the staged path (any r) -----------------------------------------------

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
int launch_staged(const void* a, const void* w, void* out, int m, int n,
                  int r, cudaStream_t stream) {
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

// ---- dispatch --------------------------------------------------------------

template <typename T>
int launch(const void* a, const void* w, void* out, int m, int n, int r,
           const repro::Config& cfg, cudaStream_t stream) {
  if (cfg.load_bytes == 16)
    return launch_vec<T, 16 / sizeof(T)>(a, w, out, m, n, r, cfg, stream);
  if (cfg.load_bytes == 8)
    return launch_vec<T, 8 / sizeof(T)>(a, w, out, m, n, r, cfg, stream);
  if (cfg.load_bytes != 0) return static_cast<int>(cudaErrorInvalidValue);
  return repro::with_tile<repro::Tile<32, 32>, repro::Tile<16, 16>>(
      cfg.tile, cfg.tile, [&](auto tile) {
        using Tl = decltype(tile);
        return launch_staged<T, Tl::BM, Tl::BN>(a, w, out, m, n, r, stream);
      });
}

}  // namespace

// out[m-r+1, n-r+1] = valid cross-correlation of a[m,n] with w[r,r], all
// row-major and contiguous, on `stream`: shape = m | n << 32, and config the
// wrapper's packed launch configuration (`repro::Config`: dtype, packet
// bytes, rows a thread walks, block width, tile, device).  The staged
// path's halo window must fit 48 KB of shared memory.  Does its own device
// guard and returns the launch's cudaError_t (0 on success).
extern "C" int repro_conv2d(const void* a, const void* w, void* out,
                            long long shape, int r, long long config,
                            void* stream) {
  const int m = static_cast<int>(shape & 0xffffffffLL);
  const int n = static_cast<int>(shape >> 32);
  const repro::Config cfg(config);
  if (r < 1 || m < r || n < r) return static_cast<int>(cudaErrorInvalidValue);
  const repro::DeviceGuard guard(cfg.device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg.dtype == repro::kFloat32)
    return launch<float>(a, w, out, m, n, r, cfg, s);
  if (cfg.dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(a, w, out, m, n, r, cfg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
