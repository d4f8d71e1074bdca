// Matrix-vector product y[m] = A[m,k] · x[k] for Hopper (sm_90a): fp32 or
// bf16 operands, fp32 accumulation, the result cast to the operands' type.
//
// Replaces the TPU kernel `_mv_kernel` / `matvec` of
// src/repro/kernels/matvec/matvec.py:16.  The Pallas kernel walks a grid
// (m/bm, k/bk) in order, carrying per-row fp32 partials in VMEM across the
// k steps, on operands that ops.py padded to block multiples.  Here `wpr`
// warps (1 or 2) own one row and sweep the whole of k themselves; a
// 64-thread block holds 2/wpr rows.  Ragged rows and unaligned tails are
// handled in the kernel, so nothing is padded.
//
// What bounds it: every element of A is read once and used for one FMA, so
// the kernel is bound by device-memory bandwidth (3.35 TB/s on an H100
// SXM): 4 MB at the decode workload's 1024 x 1024 fp32, 1.25 us.  To stream
// A at that rate the card needs megabytes in flight, so:
//
//  - a lane issues all of its 16-byte loads of a chunk of its row (up to
//    kUnroll packets, a whole 1024-wide fp32 row per warp) into a register
//    array before its first FMA, neighbouring lanes on neighbouring
//    addresses; the first chunk's loads go out before x is staged, so the
//    two overlap;
//  - x is staged once per block in shared memory (in 16 KB chunks for large
//    k) and read from there, instead of by every warp from L1/L2;
//  - small blocks of 2 warps spread the rows evenly over the 132 SMs (m =
//    1024 gives 512 blocks, every SM holding 7-8 rows, 28-32 KB of A in
//    flight), and when m is small a row is split across 2 warps;
//  - the loads of A bypass L1 and fetch whole 256-byte L2 lines (see
//    ld_stream).
//
// At 1024 x 1024 the whole of A is in flight at once, so what is left
// beside the 1.25 us of streaming is a fixed cost a launch: the launch, one
// DRAM round trip and the tail (PERF.md has the card's numbers).
//  - the partials are reduced with warp shuffles, then across a row's
//    warps in warp order through shared memory: no atomics, so results are
//    bitwise deterministic for a shape.
//
// Operands off 16-byte alignment (a base pointer, or k not a multiple of 4
// fp32 / 8 bf16 elements) take an element-wise path chosen at launch.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;       // 2 warps a block
constexpr int kUnroll = 8;         // 16-byte packets a lane loads at once
constexpr int kXBytes = 16384;     // x staged per chunk
constexpr int kFillWarps = 1024;   // warps that keep every SM streaming

// A 16-byte load of A for streaming: read-only, not kept in L1, and each
// L2 miss fetching the whole 256-byte line of the row.
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0,%1,%2,%3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// dot product of two 16-byte packets: 4 fp32 or 8 bf16 elements, in element
// order (bf16 widens exactly by a 16-bit shift; values, not addresses, so
// the packets stay in registers)
__device__ __forceinline__ float dot16(const int4& av, const int4& xv,
                                       float /*tag*/) {
  float s = fmaf(__int_as_float(av.x), __int_as_float(xv.x), 0.f);
  s = fmaf(__int_as_float(av.y), __int_as_float(xv.y), s);
  s = fmaf(__int_as_float(av.z), __int_as_float(xv.z), s);
  return fmaf(__int_as_float(av.w), __int_as_float(xv.w), s);
}

__device__ __forceinline__ float dot2(unsigned a, unsigned x, float s) {
  s = fmaf(__uint_as_float(a << 16), __uint_as_float(x << 16), s);
  return fmaf(__uint_as_float(a & 0xffff0000u),
              __uint_as_float(x & 0xffff0000u), s);
}

__device__ __forceinline__ float dot16(const int4& av, const int4& xv,
                                       __nv_bfloat16 /*tag*/) {
  float s = dot2(static_cast<unsigned>(av.x), static_cast<unsigned>(xv.x), 0.f);
  s = dot2(static_cast<unsigned>(av.y), static_cast<unsigned>(xv.y), s);
  s = dot2(static_cast<unsigned>(av.z), static_cast<unsigned>(xv.z), s);
  return dot2(static_cast<unsigned>(av.w), static_cast<unsigned>(xv.w), s);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    mv_kernel(const T* __restrict__ a, const T* __restrict__ x,
              T* __restrict__ y, int m, int k, int wpr) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte packet
  constexpr int XC = kXBytes / sizeof(T);
  __shared__ int4 xbuf[kXBytes / 16];
  __shared__ float part[kThreads / 32];
  T* xs = reinterpret_cast<T*>(xbuf);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32 / wpr) + warp / wpr;
  const int wr = warp % wpr;        // the warp's place in its row
  const int tr = wr * 32 + lane;    // the thread's place in its row
  const int nt = wpr * 32;          // threads of a row
  const bool live = row < m;        // dead warps still meet the barriers
  const T* ar = a + static_cast<size_t>(live ? row : 0) * k;

  float acc = 0.f;
  for (int x0 = 0; x0 < k; x0 += XC) {
    const int xn = min(XC, k - x0);
    if constexpr (VEC) {
      const int nv = xn / V;
      const int4* a4 = reinterpret_cast<const int4*>(ar + x0);
      const int4* x4 = xbuf;
      int4 av[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int v = tr + j * nt;
        av[j] = live && v < nv ? ld_stream(a4 + v) : make_int4(0, 0, 0, 0);
      }
      __syncthreads();  // the previous chunk's readers are done with xs
      for (int v = threadIdx.x; v < nv; v += kThreads)
        xbuf[v] = reinterpret_cast<const int4*>(x + x0)[v];
      __syncthreads();
      for (int v0 = 0; v0 < nv; v0 += kUnroll * nt) {
        if (v0 > 0) {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int v = v0 + tr + j * nt;
            av[j] = live && v < nv ? ld_stream(a4 + v) : make_int4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int v = v0 + tr + j * nt;
          if (v < nv) acc += dot16(av[j], x4[v], T());
        }
      }
    } else {
      __syncthreads();
      for (int i = threadIdx.x; i < xn; i += kThreads) xs[i] = x[x0 + i];
      __syncthreads();
      if (live)
        for (int i = tr; i < xn; i += nt)
          acc = fmaf(repro::to_float(ar[x0 + i]), repro::to_float(xs[i]),
                     acc);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (wpr == 1) {
    if (live && lane == 0) y[row] = repro::from_float<T>(acc);
    return;
  }
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (live && wr == 0 && lane == 0) {
    float s = part[warp];
    for (int w = 1; w < wpr; ++w) s += part[warp + w];
    y[row] = repro::from_float<T>(s);
  }
}

// Warps a row: more when there are too few rows to keep every SM streaming
// and the row is long enough to give each warp a full sweep of packets.
int warps_per_row(int m, int k, int v) {
  int wpr = 1;
  while (wpr < kThreads / 32 &&
         static_cast<long long>(m) * wpr < kFillWarps &&
         k >= 2 * wpr * 32 * v)
    wpr *= 2;
  return wpr;
}

template <typename T>
int launch(const void* a, const void* x, void* y, int m, int k,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int wpr = warps_per_row(m, k, V);
  const int rows = kThreads / 32 / wpr;
  const int blocks = (m + rows - 1) / rows;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x)) &
       15) == 0 &&
      k % V == 0;
  const T* ap = static_cast<const T*>(a);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (aligned)
    mv_kernel<T, true><<<blocks, kThreads, 0, stream>>>(ap, xp, yp, m, k, wpr);
  else
    mv_kernel<T, false><<<blocks, kThreads, 0, stream>>>(ap, xp, yp, m, k,
                                                         wpr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y[m] = a[m,k] @ x[k], a row-major and contiguous, x of a's type, on
// `stream` of `device`; shape = m | k << 32 and config = dtype | device << 8
// (packed: the ctypes caller pays for each argument).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_matvec(const void* a, const void* x, void* y,
                            long long shape, int config, void* stream) {
  const int m = static_cast<int>(shape & 0xffffffffLL);
  const int k = static_cast<int>(shape >> 32);
  const int dtype = config & 0xff, device = config >> 8;
  const repro::DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch<float>(a, x, y, m, k, s);
  if (dtype == repro::kBFloat16) return launch<__nv_bfloat16>(a, x, y, m, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
