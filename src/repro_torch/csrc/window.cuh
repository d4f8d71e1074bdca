// The vector path of the window kernels (blur, maxpool, conv2d): a thread owns
// V consecutive elements of a plane row, loaded as one 16- or 8-byte packet and
// widened to fp32 in registers, and writes its outputs back in packets as wide
// as the output rows' alignment allows.  No shared memory and no per-element
// index arithmetic: a thread's column is its global index times V.  The launch
// configuration comes from the wrapper packed in one 64-bit word (`Config`), so
// the C entry decodes it with shifts.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {

// The wrapper's packed launch configuration: one byte each for the dtype,
// the bytes of a load packet (0 = the staged scalar path), the bytes of a
// store packet, the rows a thread walks, the warps of a block, the tile
// edge and the device index.
struct Config {
  int dtype, load_bytes, store_bytes, rows, threads, tile, device;
  explicit Config(long long c)
      : dtype(static_cast<int>(c & 0xff)),
        load_bytes(static_cast<int>((c >> 8) & 0xff)),
        store_bytes(static_cast<int>((c >> 16) & 0xff)),
        rows(static_cast<int>((c >> 24) & 0xff)),
        threads(32 * static_cast<int>((c >> 32) & 0xff)),
        tile(static_cast<int>((c >> 40) & 0xff)),
        device(static_cast<int>((c >> 48) & 0xff)) {}
};

// True when `p` and every row start of a plane `width` elements wide lie
// on `bytes` (a power of two; 1 for element-wise access).
template <typename T>
inline bool rows_aligned(const void* p, long long width, int bytes) {
  return bytes > 0 &&
         ((reinterpret_cast<uintptr_t>(p) |
           static_cast<uintptr_t>(width * static_cast<long long>(sizeof(T)))) &
          static_cast<uintptr_t>(bytes - 1)) == 0;
}

template <int BYTES>
struct Packet;
template <>
struct Packet<16> {
  using type = int4;
};
template <>
struct Packet<8> {
  using type = int2;
};

// The k-th 32-bit word of a packet.
__device__ __forceinline__ unsigned word(const int4& p, int k) {
  return static_cast<unsigned>(k == 0   ? p.x
                               : k == 1 ? p.y
                               : k == 2 ? p.z
                                        : p.w);
}
__device__ __forceinline__ unsigned word(const int2& p, int k) {
  return static_cast<unsigned>(k == 0 ? p.x : p.y);
}

// Element e of a packet's words as fp32 (exact: bf16 widens by a shift,
// the element at the lower address in the low half of its word).
__device__ __forceinline__ float element(unsigned w, int e, float /*tag*/) {
  return __uint_as_float(w);
}
__device__ __forceinline__ float element(unsigned w, int e,
                                         __nv_bfloat16 /*tag*/) {
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

// The packet of V elements of type T.
template <typename T, int V>
using PacketOf = typename Packet<V * static_cast<int>(sizeof(T))>::type;

// The raw packet of V elements at p (aligned to V * sizeof(T) bytes: 16 or
// 8), through the read-only path.
template <typename T, int V>
__device__ __forceinline__ PacketOf<T, V> fetch_packet(const T* p) {
  return __ldg(reinterpret_cast<const PacketOf<T, V>*>(p));
}

// The V elements of a raw packet widened to fp32 into x[0, V).
template <typename T, int V, int N>
__device__ __forceinline__ void widen(const PacketOf<T, V>& raw,
                                      float (&x)[N]) {
  constexpr int E = 4 / static_cast<int>(sizeof(T));  // elements a word
  static_assert(N >= V, "too few values");
#pragma unroll
  for (int e = 0; e < V; ++e) x[e] = element(word(raw, e / E), e, T());
}

// Loads the V elements at p through the read-only path and widens them to
// fp32.
template <typename T, int V>
__device__ __forceinline__ void load_packet(const T* p, float (&x)[V]) {
  widen<T, V>(fetch_packet<T, V>(p), x);
}

__device__ __forceinline__ unsigned bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Stores the V values y, rounded to T, at p, in packets of `bytes` (16, 8,
// 4, or else one element at a time): p lies on `bytes`, and `bytes` is at
// most the V elements' size.  The choice is uniform across the launch.
template <typename T, int V>
__device__ __forceinline__ void store_packets(T* p, const float (&y)[V],
                                              int bytes) {
  constexpr int B = V * static_cast<int>(sizeof(T));
  constexpr int E = 4 / static_cast<int>(sizeof(T));
  constexpr int W = (B + 3) / 4;  // 32-bit words of the V elements
  if (B < 4 || bytes < 4) {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = from_float<T>(y[e]);
    return;
  }
  unsigned w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    w[k] = 0u;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (k * E + e < V)
        w[k] |= bits(from_float<T>(y[k * E + e])) << (32 / E * e);
  }
  if constexpr (B >= 16) {
    if (bytes == 16) {
#pragma unroll
      for (int k = 0; k < W; k += 4)
        reinterpret_cast<int4*>(p)[k / 4] = make_int4(
            static_cast<int>(w[k]), static_cast<int>(w[k + 1]),
            static_cast<int>(w[k + 2]), static_cast<int>(w[k + 3]));
      return;
    }
  }
  if constexpr (B >= 8) {
    if (bytes == 8) {
#pragma unroll
      for (int k = 0; k < W; k += 2)
        reinterpret_cast<int2*>(p)[k / 2] =
            make_int2(static_cast<int>(w[k]), static_cast<int>(w[k + 1]));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) reinterpret_cast<unsigned*>(p)[k] = w[k];
}

// Stores the first `count` of a thread's V outputs at p: packets when all V
// lie inside the row, else one element at a time (the row's ragged end).
template <typename T, int V>
__device__ __forceinline__ void store_outputs(T* p, const float (&y)[V],
                                              int count, int bytes) {
  if (count >= V) {
    store_packets<T, V>(p, y, bytes);
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (e < count) p[e] = from_float<T>(y[e]);
}

// Calls launch(std::integral_constant<int, R>) for the compiled rows a
// thread walks, 1, 2 or 4; cudaErrorInvalidValue for any other.  (8 rows
// ran slower than 1 to 4 at every workload plane and spilled.)
template <typename F>
int with_rows(int rows, F&& launch) {
  switch (rows) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Row strips of a launch past the grid's y limit are walked by a loop.
constexpr int kMaxGridY = 65535;

}  // namespace repro
