// Tiled matrix product C[m,n] = A[m,k] · B[k,n] for Hopper (sm_90a): fp32 or
// bf16 operands, fp32 accumulation with plain FMAs (no TF32, no tensor
// cores), the result cast to the operands' type at the end.
//
// Replaces the TPU kernel `_mm_kernel` / `matmul` of
// src/repro/kernels/matmul/matmul.py:17.  The Pallas kernel walks a grid
// (m/bm, n/bn, k/bk) in order with an fp32 VMEM accumulator carried across
// the innermost k steps, and relies on ops.py padding every operand to block
// multiples.  Here a block (or a cluster of blocks, below) owns one BM x BN
// output tile and walks its share of the contraction itself; the ragged
// edges are masked in the kernel, so no padded copies are made.
//
// What bounds it: at the workload shapes (m=256 or 512, k and n of 512 to
// 2048, and 384^3) the product does about 97 FLOP a byte of fp32 operands
// and result against the card's fp32 ridge of 20, so it is bound by fp32
// FMA issue (67 TFLOP/s on an H100 SXM outside the tensor cores; exact fp32
// rules out TF32 and wgmma).  On the card what stands between the kernel
// and that rate is the copy pipeline (its barriers and its latency) more
// than the shared-memory reads of the fragments.  What the design does:
//
//  - Register micro-tiles.  Each thread owns 8x8 outputs: rows ty + TY*i
//    of the tile and columns tx*4..tx*4+3 of each half, so a k step is
//    eight 4-byte reads of A, two 16-byte reads of B and 64 FMAs.
//  - Copies in flight during the FMAs.  k is staged BK deep through a ring
//    of STAGES slices in dynamic shared memory (opting in above 48 KB): A
//    and B go straight from device memory to shared memory with 16-byte
//    cp.async copies, STAGES-1 slices ahead of the FMAs.  A stays
//    row-major and the FMAs read its columns in place, so no transpose
//    stands between a copy and the FMAs that use it.  The slices are deep
//    (64 at the 128 tile, 128 at the 32 tile), so a barrier serves many
//    FMAs.
//  - A full card at few output tiles.  At m=256 the 128 tile gives 9 to 32
//    tiles for 132 SMs.  The host (matmul.py: split_k) then asks for a
//    thread-block cluster of s in {2, 4, 8} blocks along k: each block sums
//    its own contiguous k range, writes its partial tile to its shared
//    memory, and after a cluster barrier block r adds rows [r*BM/s,
//    (r+1)*BM/s) of every peer's partial through distributed shared memory,
//    in rank order, and writes them.  The order is fixed, so results are
//    deterministic; there are no atomics and no workspace.  A second
//    cluster barrier keeps every block resident until its peers have read
//    its partial.  The 32 tile fills the card by count: its 128 threads
//    split each slice across 8 k groups of 16 threads (each 8x8 outputs of
//    the 32x32 tile), summed in group order at the end, and 3 blocks share
//    an SM.
//  - Misaligned operands (k or n not a multiple of 16 bytes' elements, or a
//    base pointer off 16 bytes) take a narrower copy path chosen at launch:
//    element copies into the same ring, same FMAs.

#include <cooperative_groups.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// The k range of a cluster's blocks starts at a multiple of this many
// elements, so every block's 16-byte A copies stay aligned (matmul.py's
// SPLIT_ALIGN).
constexpr int kSplitAlign = 8;

template <typename T_, int BM_, int BN_, int BK_, int KG_, int STAGES_,
          int MINB_>
struct Cfg {
  using T = T_;
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int TM = 8, TN = 8;      // 8 rows x (2 x 4) columns
  static constexpr int KG = KG_;            // k groups inside a block
  static constexpr int S = STAGES_;         // slices in the ring
  static constexpr int MINB = MINB_;        // blocks an SM should hold
  static constexpr int V = 16 / sizeof(T);  // elements of a 16-byte packet
  static constexpr int TX = BN / TN, TY = BM / TM;  // threads of a k group
  static constexpr int NT = TX * TY * KG;
  static constexpr int KS = BK / KG;        // k steps of a group a slice
  // row strides (elements): A is kept row-major, its rows 8 elements
  // longer than BK, so that a warp's column reads (rows ty + TY*i) fall in
  // banks 8 apart; B rows one 16-byte packet longer than BN; the partial
  // tiles (floats) four beyond BN.  All rows stay 16-byte aligned for
  // cp.async.
  static constexpr int AR = BK + 8, BR = BN + V, RS = BN + 4;
  static constexpr size_t A_STAGE = size_t(BM) * AR * sizeof(T);
  static constexpr size_t B_STAGE = size_t(BK) * BR * sizeof(T);
  static constexpr size_t RING = S * (A_STAGE + B_STAGE);
  static constexpr size_t RED = size_t(KG) * BM * RS * sizeof(float);
  static constexpr size_t SMEM = RING > RED ? RING : RED;
  static constexpr int QV = BK / V;            // A packets along a slice row
  static constexpr int A_PACKETS = BM * QV;
  static constexpr int B_PACKETS = BK * BN / V;
  static_assert(S >= 2 && BK % KG == 0 && BK % V == 0, "slice shape");
  static_assert(A_STAGE % 16 == 0 && B_STAGE % 16 == 0, "16-byte stages");
};

// 128 tile: 256 threads, one k group, 3 slices of 64 (211,968 bytes fp32),
// one block an SM; 32 tile: 8 k groups of 16 threads, 2 slices of 128
// (71,680 bytes fp32), three blocks an SM.  A slice's FMAs (16 k steps a
// thread at the 32 tile) outlast the copies of the next one, so two
// slices suffice there; deeper slices cost fewer barriers per FMA.
template <typename T>
using Tile128 = Cfg<T, 128, 128, 64, 1, 3, 1>;
template <typename T>
using Tile32 = Cfg<T, 32, 32, 128, 8, 2, 3>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive elements of shared memory as fp32 (16- or 8-byte read)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// four consecutive outputs, 16-byte (fp32) or 8-byte (bf16) aligned
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  // round to nearest even, as __float2bfloat16 and torch's .to(bfloat16)
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<__nv_bfloat162*>(p) = lo;
  *reinterpret_cast<__nv_bfloat162*>(p + 2) = hi;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Four outputs of row `gr` from column `gc` on: one vector store on the
// aligned path (n is then a multiple of 4, so the four are all in or all
// out), element stores with the column mask otherwise.
template <bool VEC, typename T>
__device__ __forceinline__ void write4(T* __restrict__ c, int n, int gr,
                                       int gc, float4 v) {
  T* p = c + static_cast<size_t>(gr) * n + gc;
  if constexpr (VEC) {
    if (gc < n) store4(p, v);
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gc + j < n) p[j] = repro::from_float<T>(f[j]);
  }
}

// Starts the copies of slice `slice` (k from q0) into a ring stage (`as`,
// `bs`) when `live`: 16-byte cp.async copies, zero-filled past the block's k range
// and the matrix edges, on the aligned path; element copies on the narrow
// one.  Commits one cp.async group either way, so the ring's wait counts
// hold.
template <class C, bool VEC>
__device__ __forceinline__ void fetch(const typename C::T* __restrict__ a,
                                      const typename C::T* __restrict__ b,
                                      typename C::T* as, typename C::T* bs,
                                      bool live, int q0, int ke, int row0,
                                      int col0, int m, int n, int k) {
  using T = typename C::T;
  const int tid = threadIdx.x;
  if (live) {
    if constexpr (VEC) {
      for (int e = tid; e < C::A_PACKETS; e += C::NT) {
        const int r = e / C::QV, q = (e % C::QV) * C::V;
        const int gr = row0 + r, gq = q0 + q;
        const bool ok = gr < m && gq < ke;
        cp_async16(as + r * C::AR + q,
                   ok ? a + static_cast<size_t>(gr) * k + gq : a, ok ? 16 : 0);
      }
      for (int e = tid; e < C::B_PACKETS; e += C::NT) {
        const int q = e / (C::BN / C::V), cv = (e % (C::BN / C::V)) * C::V;
        const int gq = q0 + q, gc = col0 + cv;
        const bool ok = gq < ke && gc < n;
        cp_async16(bs + q * C::BR + cv,
                   ok ? b + static_cast<size_t>(gq) * n + gc : b, ok ? 16 : 0);
      }
    } else {
      const T zero = repro::from_float<T>(0.f);
      for (int e = tid; e < C::BM * C::BK; e += C::NT) {
        const int r = e / C::BK, q = e % C::BK;
        const int gr = row0 + r, gq = q0 + q;
        as[r * C::AR + q] =
            gr < m && gq < ke ? a[static_cast<size_t>(gr) * k + gq] : zero;
      }
      for (int e = tid; e < C::BK * C::BN; e += C::NT) {
        const int q = e / C::BN, s = e % C::BN;
        const int gq = q0 + q, gs = col0 + s;
        bs[q * C::BR + s] =
            gq < ke && gs < n ? b[static_cast<size_t>(gq) * n + gs] : zero;
      }
    }
  }
  cp_async_commit();
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::NT, C::MINB)
    mm_kernel(const typename C::T* __restrict__ a,
              const typename C::T* __restrict__ b,
              typename C::T* __restrict__ c, int m, int n, int k, int split,
              int chunk) {
  using T = typename C::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + C::S * C::A_STAGE);

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int col0 = (blockIdx.x / split) * C::BN;
  const int row0 = blockIdx.y * C::BM;
  const int kb = rank * chunk;          // this block's k range [kb, ke)
  const int ke = min(k, kb + chunk);
  const int slices = ke > kb ? (ke - kb + C::BK - 1) / C::BK : 0;

  const int kg = tid / (C::TX * C::TY);
  const int tx = tid % C::TX, ty = (tid / C::TX) % C::TY;

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  constexpr int ASZ = C::BM * C::AR, BSZ = C::BK * C::BR;
#pragma unroll
  for (int s = 0; s < C::S - 1; ++s)
    fetch<C, VEC>(a, b, as + s * ASZ, bs + s * BSZ, s < slices,
                  kb + s * C::BK, ke, row0, col0, m, n, k);

  for (int t = 0; t < slices; ++t) {
    // slice t has landed, and every thread is done with slice t-1, whose
    // stage the copies of slice t+S-1 refill
    cp_async_wait<C::S - 2>();
    __syncthreads();
    const int nxt = t + C::S - 1;
    fetch<C, VEC>(a, b, as + (nxt % C::S) * ASZ, bs + (nxt % C::S) * BSZ,
                  nxt < slices, kb + nxt * C::BK, ke, row0, col0, m, n, k);

    // A is read in place: a column of the row-major slice, rows ty + TY*i
    const T* ast = as + (t % C::S) * ASZ + ty * C::AR;
    const T* bst = bs + (t % C::S) * BSZ;
#pragma unroll
    for (int qq = 0; qq < C::KS; ++qq) {
      const int q = kg * C::KS + qq;
      float av[8];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        av[i] = repro::to_float(ast[i * C::TY * C::AR + q]);
      const float4 b0 = load4(bst + q * C::BR + tx * 4);
      const float4 b1 = load4(bst + q * C::BR + C::BN / 2 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // thread (tx, ty) owns rows ty + TY*i of the tile, and columns
  // tx*4 + {0..3} of each half
  if (C::KG == 1 && split == 1) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int gr = row0 + ty + C::TY * i;
      if (gr >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        write4<VEC>(c, n, gr, col0 + h * (C::BN / 2) + tx * 4,
                    make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
    return;
  }

  // partial tiles: each k group's into its own plane of the freed ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = ty + C::TY * i;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store4(red + (kg * C::BM + r) * C::RS + h * (C::BN / 2) + tx * 4,
             make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                         acc[i][4 * h + 3]));
  }
  __syncthreads();
  if constexpr (C::KG > 1) {
    // the block's k groups, summed in group order into plane 0
    for (int e = tid; e < C::BM * C::BN / 4; e += C::NT) {
      const int r = e / (C::BN / 4), c4 = (e % (C::BN / 4)) * 4;
      float4 s = load4(red + r * C::RS + c4);
#pragma unroll
      for (int g = 1; g < C::KG; ++g)
        s = add4(s, load4(red + (g * C::BM + r) * C::RS + c4));
      store4(red + r * C::RS + c4, s);
    }
    __syncthreads();
  }

  if (split == 1) {
    for (int e = tid; e < C::BM * C::BN / 4; e += C::NT) {
      const int r = e / (C::BN / 4), c4 = (e % (C::BN / 4)) * 4;
      if (row0 + r < m)
        write4<VEC>(c, n, row0 + r, col0 + c4, load4(red + r * C::RS + c4));
    }
    return;
  }
  // block `rank` finishes rows [r0, r0 + rows) of the tile: the sum of
  // every cluster peer's partial, in rank order
  const int rows = C::BM / split;
  const int r0 = rank * rows;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every peer's partial is written
  for (int e = tid; e < rows * C::BN / 4; e += C::NT) {
    const int r = r0 + e / (C::BN / 4), c4 = (e % (C::BN / 4)) * 4;
    float4 s = load4(cluster.map_shared_rank(red, 0) + r * C::RS + c4);
    for (int p = 1; p < split; ++p)
      s = add4(s, load4(cluster.map_shared_rank(red, p) + r * C::RS + c4));
    if (row0 + r < m) write4<VEC>(c, n, row0 + r, col0 + c4, s);
  }
  cluster.sync();  // no block leaves while a peer still reads its partial
}

// The launch configuration of a tile at a cluster size (grid left to the
// caller); opts the kernel in above 48 KB of shared memory first.
template <class C, bool VEC>
cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   int split, cudaStream_t stream) {
  static_assert(C::SMEM <= repro::kSmemOptIn, "ring above 227 KB");
  if (C::SMEM > repro::kSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_kernel<C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return e;
  }
  cfg = {};
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaSuccess;
}

template <class C, bool VEC>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int split, int chunk, cudaStream_t stream) {
  using T = typename C::T;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = config<C, VEC>(cfg, attr, split, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim =
      dim3(split * ((n + C::BN - 1) / C::BN), (m + C::BM - 1) / C::BM);
  e = cudaLaunchKernelEx(&cfg, mm_kernel<C, VEC>, static_cast<const T*>(a),
                         static_cast<const T*>(b), static_cast<T*>(c), m, n,
                         k, split, chunk);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <class C>
int launch_path(const void* a, const void* b, void* c, int m, int n, int k,
                int split, int chunk, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
      k % C::V == 0 && n % C::V == 0;
  return aligned ? launch<C, true>(a, b, c, m, n, k, split, chunk, stream)
                 : launch<C, false>(a, b, c, m, n, k, split, chunk, stream);
}

// The launch, and the cluster occupancy query, of one compiled
// configuration: with_cfg calls f.template operator()<Cfg>() for it.
struct Launch {
  const void* a;
  const void* b;
  void* c;
  int m, n, k, split, chunk;
  cudaStream_t stream;
  template <class C>
  int operator()() const {
    return launch_path<C>(a, b, c, m, n, k, split, chunk, stream);
  }
};

struct ClusterBlocks {
  int split;
  int* blocks;
  template <class C>
  int operator()() const {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = config<C, true>(cfg, attr, split, nullptr);
    if (e != cudaSuccess) return static_cast<int>(e);
    cfg.gridDim = dim3(split, 1);
    cfg.numAttrs = 1;  // the occupancy query needs the cluster size, even 1
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, mm_kernel<C, true>, &cfg);
    *blocks = clusters * split;
    return static_cast<int>(e);
  }
};

// Calls f.template operator()<Cfg>() for the compiled tile and type.
template <class F>
int with_cfg(int dtype, int tile, const F& f) {
  if (dtype == repro::kFloat32 && tile == 32)
    return f.template operator()<Tile32<float>>();
  if (dtype == repro::kFloat32 && tile == 128)
    return f.template operator()<Tile128<float>>();
  if (dtype == repro::kBFloat16 && tile == 32)
    return f.template operator()<Tile32<__nv_bfloat16>>();
  if (dtype == repro::kBFloat16 && tile == 128)
    return f.template operator()<Tile128<__nv_bfloat16>>();
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// c[m,n] = a[m,k] @ b[k,n], all row-major and contiguous, on `stream` of
// `device`; mn = m | n << 32 and config = dtype | tile << 8 | split << 16 |
// device << 24 (packed: the ctypes caller pays for each argument).  `tile`
// is the output tile edge (32 or 128; k slices are 32 deep for both);
// `split` in {1, 2, 4, 8} is the cluster's blocks along k, each over
// ceil(ceil(k/split)/8)*8 of k, and no block may get an empty range.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c,
                            long long mn, int k, int config, void* stream) {
  const int m = static_cast<int>(mn & 0xffffffffLL);
  const int n = static_cast<int>(mn >> 32);
  const int dtype = config & 0xff, tile = (config >> 8) & 0xff;
  const int split = (config >> 16) & 0xff, device = config >> 24;
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int chunk = k;
  if (split > 1) {
    chunk = ((k + split - 1) / split + kSplitAlign - 1) / kSplitAlign *
            kSplitAlign;
    if ((split - 1) * chunk >= k)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro::DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_cfg(dtype, tile, Launch{a, b, c, m, n, k, split, chunk, s});
}

// *blocks = how many blocks of `tile` the card runs at once in clusters of
// `split` blocks (clusters sit inside one GPC, so at 4 or 8 blocks a cluster
// fewer SMs than the card has can take them).  Returns a cudaError_t.
extern "C" int repro_matmul_cluster_blocks(int dtype, int tile, int split,
                                           int device, int* blocks) {
  const repro::DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_cfg(dtype, tile, ClusterBlocks{split, blocks});
}
