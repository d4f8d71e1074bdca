// GQA flash attention for Hopper (sm_90a), forward and backward: fp32 or
// bf16 operands, fp32 arithmetic, each output rounded to the operands' type
// once; lse and delta are fp32.  Every product runs on the tensor cores at
// fp32 accuracy (3xTF32, below).
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/
// flash_attention.py: `_fa_kernel` (forward), `_fa_fwd_kernel` (forward that
// also writes the row log-sum-exp), `_fa_bwd_dq_kernel` and
// `_fa_bwd_dkv_kernel` (the two backward sweeps).  The Pallas kernels walk a
// grid (B·H, Sq/bq, Sk/bk) in order, KV innermost for the forward and dq,
// q innermost for dk/dv, and carry the online-softmax state (acc, m, l) or
// the gradient tiles in VMEM scratch from one grid step to the next.  Here
// blocks run in parallel and in no order, so one block owns one (b·h, q
// tile) — or one (b·h, KV tile) for dk/dv — and walks the other sequence
// axis itself in a loop, with the carried state in registers.  A KV head is
// `head / (H/KV)`: K and V are never expanded in device memory.  dq stays a
// sweep of its own, as in the JAX package: no atomics, so every launch
// gives the same bits.
//
// Every sweep is built the same way.  A warp owns 16 rows of the block's
// own tile (queries for the forward and dq, keys for dk/dv) and computes
// their scores against each streamed tile with m16n8k8 `mma.sync`
// products: S = Q·Kᵀ, and for the backward dP = dO·Vᵀ.  It turns them into
// P (the forward's online softmax: row max and row sum over the 4 lanes
// that share a row, on the accumulators' registers) or P and dS, and feeds
// those straight into O += P·V, or dQ += dS·K, or dV += Pᵀ·dO and
// dK += dSᵀ·Q: the m16n8 accumulator holds columns 2t and 2t+1 of its rows,
// which the next product's A fragment takes as its k slots t and t+4, so
// its B fragment reads rows 2t and 2t+1.  No score tile goes through shared
// memory.  Each fp32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (the rounding of cvt.rna.tf32.f32, done by an
// integer add and mask), and a product is lo·hi + hi·lo + hi·hi (the small
// terms first), accurate to about fp32's rounding; bf16 operands are exact
// in tf32 (lo = 0, their terms skipped), while P and dS are always split.
// Each sweep step sums its products in a fresh accumulator, added in fp32
// to the carried one (the forward's O scaled by the step's alpha first).
// The streamed tiles (K and V, or Q, dO, lse and delta) land by 16-byte
// cp.async in the operands' type, two stages, the next step's copies in
// flight during this step's products; rows are D + 16/sizeof(T) elements
// long, so that they start on 16 bytes and the fragment reads of a warp
// fall in distinct banks.  Tiles by head dim: FwdCfg for the forward,
// BwdCfg for the backward (warps a block, warps sharing 16 own rows,
// streamed rows a step); at D = 256 two warps share 16 rows, each with half
// the output columns (and each recomputing the rows' scores), so that its
// accumulators fit the registers.  Heads are the grid's fast dimension, so
// that under a causal mask every head's heaviest blocks (the last q tiles
// of the forward and dq, the first KV tiles of dk/dv) start in the first
// wave and the light ones fill the tail.
//
// Ragged tiles are masked: rows past Sq are zero and never written, keys
// past Sk take no part.  The caller's (bq, bk) only sets the padding, as in
// the JAX package.
//
// Masks and the finite NEG_INF: a score is visible when its key lies below
// `sk_orig`, and (causal) at or before its query, and (window > 0) less than
// `window` before it.  Invisible scores are -1e30 in the forward, as in the
// Pallas kernels, never -inf: a row whose first visited tile is all masked
// gets p = exp(0) = 1 there, which the first visible tile wipes out through
// alpha = exp(-1e30 - m) = 0, where -inf would give inf - inf = NaN.  A row
// that sees no key at all (a padded query row under a window) ends up
// averaging every key's value, as in the Pallas kernels; in the backward
// its p is 0 everywhere.  The mask is evaluated only on tiles where it can
// bite: a warp's tile wholly visible skips the test, one wholly invisible
// skips its products.
//
// Skipped tiles: a sweep visits only the tiles that hold a key (or query)
// some row (or column) of the block can see; the others change nothing,
// since all their p are 0 after the row's first visible key (alpha = 1),
// and what they add before it alpha = 0 wipes out.  The one exception is a
// forward row that sees no key: it must average all keys, so a forward
// block whose last query row is blind sweeps every KV tile, and so does
// each of its warps that holds a blind row (blindness only grows along the
// rows, so the warp's last row decides).  Causal attention thus does about
// half the work of all tiles, and a window of w at S keys about w/S of it.
//
// What bounds it: attention does 4·S·D FLOP per query row forward and
// 14·S·D backward on 2-4 reads of a D-long row, some hundreds of FLOP a
// byte at the shapes used (S of 512-4096, D of 32-256), above the card's
// ridge, so it is bound by arithmetic: the TF32 tensor-core rate over three
// products (495/3 = 165 TFLOP/s of fp32-grade work, dense).  mma.sync
// reaches only part of the rate `wgmma` does, three products a product
// triple the tensor-core work, and every fragment a warp reads is split
// (two integer roundings and a subtraction) before its products.  wgmma
// with K-major swizzled tiles, TMA loads and a warp-specialised pipeline
// are the known next steps.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.44269504088896341f;  // exp(x) = exp2(x·log2 e)

// Shape and mask of one call.  q, dq, do, out: [B,H,Sq,D]; k, v: [B,KV,Sk,D];
// lse, delta: [B,H,Sq]; per-q-head dk, dv: [B,H,Sk,D]; all contiguous.
struct Problem {
  int h, kv, sq, sk, sk_orig, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, const Problem& p) {
  bool ok = kp < p.sk_orig;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && qp - kp < p.window;
  return ok;
}

// True when query row q sees no key.  Only a window makes a row blind, and
// then every later row is blind too.
__device__ __forceinline__ bool blind_row(int q, const Problem& p) {
  const int lo = p.window > 0 ? max(0, q - p.window + 1) : 0;
  const int hi = p.causal ? min(p.sk_orig - 1, q) : p.sk_orig - 1;
  return lo > hi;
}

// The KV tiles [j0, j1) a forward or dq block over queries [q0, q_last]
// visits: those holding a key some of its rows can see.  With `all_if_blind`
// (the forward), every tile when its last row sees no key.
template <int BK>
__device__ __forceinline__ void kv_tiles(int q0, int q_last, const Problem& p,
                                         bool all_if_blind, int& j0, int& j1) {
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.sk_orig - 1, q_last) : p.sk_orig - 1;
  if (all_if_blind && blind_row(q_last, p)) {
    j0 = 0;
    j1 = (p.sk + BK - 1) / BK;
  } else if (lo > hi) {
    j0 = j1 = 0;
  } else {
    j0 = lo / BK;
    j1 = hi / BK + 1;
  }
}

// ---------------------------------------------------------------------------
// tensor-core tiles at fp32 accuracy (3xTF32)
// ---------------------------------------------------------------------------

// Tiles by head dim.  A warp owns 16 rows of the block's own tile (query
// rows for the forward and dq, key rows for dk/dv) and, with SPLIT = 2,
// half of the output columns: two warps then share 16 rows, each
// recomputing their scores, so that at D = 256 an accumulator stays within
// the registers.  STREAM is the rows of the other operand a step of the
// sweep copies (keys for the forward and dq, queries for dk/dv), two steps
// in flight.  A block owns at least 64 rows (`valid` admits 65535 blocks of
// them along a sequence).  The staged tiles fit the 227 KB a block can
// take.
//
// The forward's (FwdCfg) are the fastest of tools/flash_attention_probe.py's
// sweep at each head dim on an H100: 4 warps (64 query rows) and 64 keys a
// step at D = 32, several blocks an SM; 8 warps and 32 or 64 keys at D = 64
// and 128 (255 registers at D = 128, one block an SM); 16 warps in pairs
// (128 rows) and 16 keys at D = 256.
template <int D>
struct FwdCfg;
template <>
struct FwdCfg<32> {
  static constexpr int WARPS = 4, SPLIT = 1, STREAM = 64;
};
template <>
struct FwdCfg<64> {
  static constexpr int WARPS = 8, SPLIT = 1, STREAM = 32;
};
template <>
struct FwdCfg<128> {
  static constexpr int WARPS = 8, SPLIT = 1, STREAM = 64;
};
template <>
struct FwdCfg<256> {
  static constexpr int WARPS = 16, SPLIT = 2, STREAM = 16;
};

// The backward's (BwdCfg): at D <= 128 a block has 8 warps (4 at D = 32,
// several blocks an SM), so at least 8 warps are resident on an SM.
template <int D>
struct BwdCfg;
template <>
struct BwdCfg<32> {
  static constexpr int DQ_WARPS = 4, DQ_SPLIT = 1, DQ_STREAM = 64;
  static constexpr int DKV_WARPS = 4, DKV_SPLIT = 1, DKV_STREAM = 32;
};
template <>
struct BwdCfg<64> {
  static constexpr int DQ_WARPS = 8, DQ_SPLIT = 1, DQ_STREAM = 32;
  static constexpr int DKV_WARPS = 8, DKV_SPLIT = 1, DKV_STREAM = 32;
};
template <>
struct BwdCfg<128> {
  static constexpr int DQ_WARPS = 8, DQ_SPLIT = 1, DQ_STREAM = 32;
  static constexpr int DKV_WARPS = 8, DKV_SPLIT = 1, DKV_STREAM = 32;
};
template <>
struct BwdCfg<256> {
  static constexpr int DQ_WARPS = 8, DQ_SPLIT = 2, DQ_STREAM = 16;
  static constexpr int DKV_WARPS = 8, DKV_SPLIT = 2, DKV_STREAM = 16;
};

// One sweep's shape: WARPS warps, SPLIT warps per 16 own rows, OWN =
// 16·WARPS/SPLIT own rows in OWNT own tiles (Q; or Q and dO, K and V) and
// STREAM streamed rows per step.  Tiles sit in shared memory in the
// operands' type with rows of D + 16/sizeof(T) elements: 16-byte aligned
// for cp.async, and the fragment reads of a warp (row g, column t, or row
// 2t, column g) fall in distinct banks.
template <typename T, int D, int WARPS, int SPLIT, int STREAM, int OWNT,
          int ROWBUF>
struct Sweep {
  static constexpr int kWarps = WARPS, kSplit = SPLIT;
  static constexpr int NT = 32 * WARPS;
  static constexpr int OWN = 16 * WARPS / SPLIT;
  static constexpr int STR = STREAM;
  static constexpr int LD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int DOUT = D / SPLIT;   // output columns a warp owns
  // own tiles (OWNT x OWN rows), then two stages of two streamed tiles,
  // then ROWBUF floats a row of the streamed tile per stage (lse, delta)
  static constexpr size_t TILES =
      sizeof(T) * static_cast<size_t>(LD) * (OWNT * OWN + 4 * STREAM);
  static constexpr size_t SMEM =
      TILES + sizeof(float) * 2 * static_cast<size_t>(ROWBUF) * STREAM;
  static_assert(STREAM % 8 == 0 && DOUT % 8 == 0 && WARPS % SPLIT == 0 &&
                    OWN >= 64,
                "tile shape");
  static_assert(SMEM <= repro::kSmemOptIn, "tiles above the opt-in limit");
};

template <typename T, int D>
using FwdSweep = Sweep<T, D, FwdCfg<D>::WARPS, FwdCfg<D>::SPLIT,
                       FwdCfg<D>::STREAM, 1, 0>;
template <typename T, int D>
using DqSweep = Sweep<T, D, BwdCfg<D>::DQ_WARPS, BwdCfg<D>::DQ_SPLIT,
                      BwdCfg<D>::DQ_STREAM, 2, 0>;
template <typename T, int D>
using DkvSweep = Sweep<T, D, BwdCfg<D>::DKV_WARPS, BwdCfg<D>::DKV_SPLIT,
                       BwdCfg<D>::DKV_STREAM, 2, 2>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// Copies rows [row0, row0 + ROWS) of the row-major [n, D] matrix `src` to
// `dst` (row stride LD elements) by 16-byte cp.async; rows at or past n are
// zero-filled.  Consecutive threads copy consecutive packets of a row.
template <int ROWS, int D, int LD, int NT, typename T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, T* dst,
                                          int row0, int n) {
  constexpr int V = 16 / sizeof(T), C = D / V;
  for (int e = threadIdx.x; e < ROWS * C; e += NT) {
    const int r = e / C, c = (e % C) * V;
    const bool in = row0 + r < n;
    cp_async16(dst + r * LD + c,
               in ? src + static_cast<size_t>(row0 + r) * D + c : src,
               in ? 16 : 0);
  }
}

// A tf32 operand held as hi + lo: hi = rna(x), lo = rna(x - hi).  Exact
// operands (bf16 widened to fp32 fits tf32) keep lo = 0 and skip its
// products.
template <typename T>
constexpr bool kExact = sizeof(T) == 2;

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// the bits cvt.rna.tf32.f32 gives for a finite x, by an integer add and
// mask.  On sm_90 the conversion compiles to a longer sequence (compares
// and selects among them), and the split runs for every fragment a warp
// reads, so its cost shows in the sweep's time.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

template <bool EXACT, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32(x[i]);
    lo[i] = EXACT ? 0u : tf32(x[i] - __uint_as_float(hi[i]));
  }
}

// c += a · b for one m16n8k8 tile on the tensor cores, tf32 in, fp32 out.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a · b at fp32 accuracy: the two small cross terms first, then
// hi · hi (3xTF32; a term with an exact operand's lo = 0 is skipped).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!A_EXACT) mma(c, al, bh);
  if (!B_EXACT) mma(c, ah, bl);
  mma(c, ah, bh);
}

// Fragment reads from shared memory, converted to fp32.  Lane (g, t) =
// (lane / 4, lane % 4).  The A fragment of a 16 x 8 tile at `a` (row
// stride LD, columns c0..c0+7): rows g and g+8, columns t and t+4.
template <int LD, typename T>
__device__ __forceinline__ void frag_a(const T* a, int c0, int g, int t,
                                       float (&x)[4]) {
  x[0] = repro::to_float(a[g * LD + c0 + t]);
  x[1] = repro::to_float(a[(g + 8) * LD + c0 + t]);
  x[2] = repro::to_float(a[g * LD + c0 + t + 4]);
  x[3] = repro::to_float(a[(g + 8) * LD + c0 + t + 4]);
}

// The B fragment of Yᵀ for the 8 rows of Y at `y` (a score tile's key or
// query rows), columns c0..c0+7 of the contraction: row g, columns t, t+4.
template <int LD, typename T>
__device__ __forceinline__ void frag_bt(const T* y, int c0, int g, int t,
                                        float (&x)[2]) {
  x[0] = repro::to_float(y[g * LD + c0 + t]);
  x[1] = repro::to_float(y[g * LD + c0 + t + 4]);
}

// The B fragment of Y itself for a product whose A is a score accumulator
// (P, dS or their transposes).  The m16n8 accumulator holds columns 2t and
// 2t+1 of its rows, which the A fragment reads as its k slots t and t+4;
// so B's k slots t and t+4 are rows 2t and 2t+1 of the 8 rows at `y`, and
// the product still sums over all 8.  Column g of the 8 at c0.
template <int LD, typename T>
__device__ __forceinline__ void frag_b_perm(const T* y, int c0, int g, int t,
                                            float (&x)[2]) {
  x[0] = repro::to_float(y[(2 * t) * LD + c0 + g]);
  x[1] = repro::to_float(y[(2 * t + 1) * LD + c0 + g]);
}

// s = A · Bᵀ over D, in a fresh accumulator: A the warp's 16 own rows, B
// the N8·8 streamed rows, both of type T in shared memory (the forward's
// S = Q·Kᵀ).  A k step's three products go out term by term over the N8
// key groups, so that consecutive mma.sync instructions feed different
// accumulators instead of waiting on each other; each accumulator still
// takes lo·hi, hi·lo, hi·hi in that order.
template <int D, int LD, int N8, typename T>
__device__ __forceinline__ void score(const T* a, const T* b,
                                      float (&s)[N8][4], int g, int t) {
  constexpr bool E = kExact<T>;
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll 2
  for (int c0 = 0; c0 < D; c0 += 8) {
    float x[4];
    uint32_t ah[4], al[4], bh[N8][2], bl[N8][2];
    frag_a<LD>(a, c0, g, t, x);
    split<E>(x, ah, al);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      float y[2];
      frag_bt<LD>(b + n * 8 * LD, c0, g, t, y);
      split<E>(y, bh[n], bl[n]);
    }
    if (!E) {
#pragma unroll
      for (int n = 0; n < N8; ++n) mma(s[n], al, bh[n]);
#pragma unroll
      for (int n = 0; n < N8; ++n) mma(s[n], ah, bl[n]);
    }
#pragma unroll
    for (int n = 0; n < N8; ++n) mma(s[n], ah, bh[n]);
  }
}

// acc += P · V for the forward: P a score accumulator (16 rows x N8·8
// keys, in registers), V the streamed rows at `y` (the warp's DN8·8
// columns from c0).  P is split once, as the A fragments of its N8 k
// steps.  The output columns go in groups of up to 4 blocks of 8: a group
// sums the step's products in fresh accumulators, term by term over the
// group (consecutive mma.sync feed different accumulators), and adds them
// to `acc` in fp32 (the tensor cores truncate as they accumulate; see
// `accumulate`).  The backward keeps `accumulate`, one block of 8 columns
// at a time: its dk/dv sweep holds two output tiles, and a group's extra
// accumulators and fragments (about 24 registers) would not fit beside
// them at D = 128.
template <int LD, int N8, int DN8, typename T>
__device__ __forceinline__ void accumulate_pv(const float (&s)[N8][4],
                                              const T* y, int c0,
                                              float (&acc)[DN8][4], int g,
                                              int t) {
  constexpr bool E = kExact<T>;
  constexpr int G = DN8 < 4 ? DN8 : 4;
  static_assert(DN8 % G == 0, "column groups");
  uint32_t ah[N8][4], al[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    const float x[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
    split<false>(x, ah[n], al[n]);
  }
#pragma unroll
  for (int d0 = 0; d0 < DN8; d0 += G) {
    float part[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float z[2];
        frag_b_perm<LD>(y + n * 8 * LD, c0 + (d0 + j) * 8, g, t, z);
        split<E>(z, bh[j], bl[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) mma(part[j], al[n], bh[j]);
      if (!E) {
#pragma unroll
        for (int j = 0; j < G; ++j) mma(part[j], ah[n], bl[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) mma(part[j], ah[n], bh[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[d0 + j][i] += part[j][i];
  }
}

// s1 += A1 · B1ᵀ and s2 += A2 · B2ᵀ over D: A1, A2 the warp's 16 own rows,
// B1, B2 the N8·8 streamed rows, all of type T in shared memory.
template <int D, int LD, int N8, typename T>
__device__ __forceinline__ void scores(const T* a1, const T* b1, const T* a2,
                                       const T* b2, float (&s1)[N8][4],
                                       float (&s2)[N8][4], int g, int t) {
  constexpr bool E = kExact<T>;
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s1[n][i] = s2[n][i] = 0.f;
#pragma unroll 2
  for (int c0 = 0; c0 < D; c0 += 8) {
    float x[4];
    uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
    frag_a<LD>(a1, c0, g, t, x);
    split<E>(x, a1h, a1l);
    frag_a<LD>(a2, c0, g, t, x);
    split<E>(x, a2h, a2l);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      float y[2];
      uint32_t bh[2], bl[2];
      frag_bt<LD>(b1 + n * 8 * LD, c0, g, t, y);
      split<E>(y, bh, bl);
      mma3<E, E>(s1[n], a1h, a1l, bh, bl);
      frag_bt<LD>(b2 + n * 8 * LD, c0, g, t, y);
      split<E>(y, bh, bl);
      mma3<E, E>(s2[n], a2h, a2l, bh, bl);
    }
  }
}

// acc += S · Y for a score accumulator S (16 rows x N8·8 streamed rows, in
// registers) and the streamed rows Y at `y` (the warp's DOUT columns from
// c0).  S is split once, as the A fragments of its N8 k steps.  Each 8
// output columns sum the step's products in a fresh accumulator, added to
// `acc` in fp32: the tensor cores truncate as they accumulate, so a long
// sweep summed inside them would drift; this way only a step's few
// products are summed there.
template <int LD, int N8, int DN8, typename T>
__device__ __forceinline__ void accumulate(const float (&s)[N8][4],
                                           const T* y, int c0,
                                           float (&acc)[DN8][4], int g,
                                           int t) {
  constexpr bool E = kExact<T>;
  uint32_t ah[N8][4], al[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    const float x[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
    split<false>(x, ah[n], al[n]);
  }
#pragma unroll
  for (int dn = 0; dn < DN8; ++dn) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      float z[2];
      uint32_t bh[2], bl[2];
      frag_b_perm<LD>(y + n * 8 * LD, c0 + dn * 8, g, t, z);
      split<E>(z, bh, bl);
      mma3<false, E>(part, ah[n], al[n], bh, bl);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] += part[i];
  }
}

// The max and the sum of v over the 4 lanes that hold one accumulator row
// (lanes 4g .. 4g+3).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// forward: `_fa_kernel` and `_fa_fwd_kernel` in one template; one block per
// (b·h, q tile), KV tiles in the loop
// ---------------------------------------------------------------------------

template <typename T, int D, bool WITH_LSE>
__global__ void __launch_bounds__(FwdSweep<T, D>::NT)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, Problem p) {
  using S = FwdSweep<T, D>;
  constexpr int LD = S::LD, BQ = S::OWN, BK = S::STR, NT = S::NT;
  constexpr int N8 = BK / 8, DN8 = S::DOUT / 8;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* qs = reinterpret_cast<T*>(fwd_smem);   // [BQ][LD]
  T* kvs = qs + BQ * LD;                    // 2 stages of K [BK][LD], V

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const int row = 16 * (warp / S::kSplit);       // the warp's first own row
  const int c0 = (warp % S::kSplit) * S::DOUT;   // its first output column
  // heads are the grid's fast dimension, and the last q tiles (the heaviest
  // under a causal mask) come first
  const int bh = blockIdx.x;
  const int kvh = (bh / p.h) * p.kv + (bh % p.h) / (p.h / p.kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int qw = q0 + row;                        // the warp's first query
  const size_t qoff = static_cast<size_t>(bh) * p.sq * D;
  const T* kh = k + static_cast<size_t>(kvh) * p.sk * D;
  const T* vh = v + static_cast<size_t>(kvh) * p.sk * D;

  int j0, j1;
  kv_tiles<BK>(q0, q_last, p, true, j0, j1);
  copy_rows<BQ, D, LD, NT>(q + qoff, qs, q0, p.sq);
  cp_async_commit();
  if (j0 < j1) {
    copy_rows<BK, D, LD, NT>(kh, kvs, j0 * BK, p.sk);
    copy_rows<BK, D, LD, NT>(vh, kvs + BK * LD, j0 * BK, p.sk);
  }
  cp_async_commit();

  // a warp holding a row that sees no key visits every tile of the sweep
  const bool blind = qw < p.sq && blind_row(min(qw + 15, p.sq - 1), p);
  float acc[DN8][4], m_row[2], l_row[2];
#pragma unroll
  for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_row[h] = kNegInf;
    l_row[h] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    const T* ks = kvs + ((j - j0) & 1) * 2 * BK * LD;
    const T* vs = ks + BK * LD;
    if (j + 1 < j1) {  // the next tile into the other stage
      T* nk = kvs + ((j + 1 - j0) & 1) * 2 * BK * LD;
      copy_rows<BK, D, LD, NT>(kh, nk, (j + 1) * BK, p.sk);
      copy_rows<BK, D, LD, NT>(vh, nk + BK * LD, (j + 1) * BK, p.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * BK, k_end = k0 + BK - 1;
    // whether none of the warp's 16 rows sees a key of the tile (and none
    // is blind), and whether all of them see all of its keys
    const bool skip = qw >= p.sq ||
                      (!blind && (k0 >= p.sk_orig ||
                                  (p.causal && k0 > qw + 15) ||
                                  (p.window > 0 && qw - k_end >= p.window)));
    const bool full = qw + 15 < p.sq && k_end < p.sk_orig &&
                      (!p.causal || k_end <= qw) &&
                      (p.window <= 0 || qw + 15 - k0 < p.window);
    if (!skip) {
      float s[N8][4];
      score<D, LD>(qs + row * LD, ks, s, g, t);
      // the online softmax, in the Pallas kernel's order of operations;
      // element i of an accumulator is row g + 8·(i/2), column 2t + (i&1)
      float mx[2] = {-INFINITY, -INFINITY};  // only keys past Sk keep it
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i / 2;
          const int qp = qw + g + 8 * h, kp = k0 + n * 8 + 2 * t + (i & 1);
          const float sv = full || visible(qp, kp, p) ? s[n][i] * p.scale
                                                      : kNegInf;
          s[n][i] = sv;
          if (full || kp < p.sk) mx[h] = fmaxf(mx[h], sv);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_row[h], quad_max(mx[h]));
        alpha[h] = exp2f((m_row[h] - m_new) * kLog2e);
        m_row[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i / 2, kp = k0 + n * 8 + 2 * t + (i & 1);
          const float pv = full || kp < p.sk
                               ? exp2f((s[n][i] - m_row[h]) * kLog2e)
                               : 0.f;
          s[n][i] = pv;
          rs[h] += pv;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_row[h] = l_row[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
      for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dn][i] *= alpha[i / 2];
      accumulate_pv<LD>(s, vs, c0, acc, g, t);   // O += P · V
    }
    __syncthreads();  // the stage is free for the copy two steps on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = qw + g + 8 * h;
    if (qr >= p.sq) continue;
    const float li = fmaxf(l_row[h], 1e-30f);
    T* orow = out + qoff + static_cast<size_t>(qr) * D + c0;
#pragma unroll
    for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        orow[dn * 8 + 2 * t + e] =
            repro::from_float<T>(acc[dn][2 * h + e] / li);
    if (WITH_LSE && t == 0 && c0 == 0)
      lse[static_cast<size_t>(bh) * p.sq + qr] = m_row[h] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (b·h, q tile), KV tiles in the loop
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(DqSweep<T, D>::NT)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     Problem p) {
  using S = DqSweep<T, D>;
  constexpr int LD = S::LD, BQ = S::OWN, BK = S::STR, NT = S::NT;
  constexpr int N8 = BK / 8, DN8 = S::DOUT / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* qs = reinterpret_cast<T*>(bwd_smem);   // [BQ][LD]
  T* dos = qs + BQ * LD;                    // [BQ][LD]
  T* kvs = dos + BQ * LD;                   // 2 stages of K [BK][LD], V

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const int row = 16 * (warp / S::kSplit);       // the warp's first own row
  const int c0 = (warp % S::kSplit) * S::DOUT;   // its first output column
  // heads are the grid's fast dimension, so every head's heaviest tile
  // (the last q tile under a causal mask) starts in the first wave
  const int bh = blockIdx.x;
  const int kvh = (bh / p.h) * p.kv + (bh % p.h) / (p.h / p.kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int qw = q0 + row;                        // the warp's first query
  const size_t qoff = static_cast<size_t>(bh) * p.sq * D;
  const T* kh = k + static_cast<size_t>(kvh) * p.sk * D;
  const T* vh = v + static_cast<size_t>(kvh) * p.sk * D;

  int j0, j1;
  kv_tiles<BK>(q0, q_last, p, false, j0, j1);
  copy_rows<BQ, D, LD, NT>(q + qoff, qs, q0, p.sq);
  copy_rows<BQ, D, LD, NT>(dout + qoff, dos, q0, p.sq);
  cp_async_commit();
  if (j0 < j1) {
    copy_rows<BK, D, LD, NT>(kh, kvs, j0 * BK, p.sk);
    copy_rows<BK, D, LD, NT>(vh, kvs + BK * LD, j0 * BK, p.sk);
  }
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = qw + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * p.sq + qr;
    row_lse[h] = qr < p.sq ? lse[at] : 0.f;
    row_delta[h] = qr < p.sq ? delta[at] : 0.f;
  }
  float acc[DN8][4];
#pragma unroll
  for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const T* ks = kvs + ((j - j0) & 1) * 2 * BK * LD;
    const T* vs = ks + BK * LD;
    if (j + 1 < j1) {  // the next tile into the other stage
      T* nk = kvs + ((j + 1 - j0) & 1) * 2 * BK * LD;
      copy_rows<BK, D, LD, NT>(kh, nk, (j + 1) * BK, p.sk);
      copy_rows<BK, D, LD, NT>(vh, nk + BK * LD, (j + 1) * BK, p.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * BK, k_end = k0 + BK - 1;
    // whether any of the warp's 16 rows sees a key of the tile, and
    // whether all of them see all of its keys (no mask to evaluate)
    const bool empty = qw >= p.sq || k0 >= p.sk_orig ||
                       (p.causal && k0 > qw + 15) ||
                       (p.window > 0 && qw - k_end >= p.window);
    const bool full = qw + 15 < p.sq && k_end < p.sk_orig &&
                      (!p.causal || k_end <= qw) &&
                      (p.window <= 0 || qw + 15 - k0 < p.window);
    if (!empty) {
      float s[N8][4], dp[N8][4];
      scores<D, LD>(qs + row * LD, ks, dos + row * LD, vs, s, dp, g, t);
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i / 2;
          const int qp = qw + g + 8 * h, kp = k0 + n * 8 + 2 * t + (i & 1);
          const bool ok = full || (qp < p.sq && visible(qp, kp, p));
          const float pv = ok ? expf(s[n][i] * p.scale - row_lse[h]) : 0.f;
          s[n][i] = pv * (dp[n][i] - row_delta[h]);   // dS
        }
      accumulate<LD>(s, ks, c0, acc, g, t);
    }
    __syncthreads();  // the stage is free for the copy two steps on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = qw + g + 8 * (i / 2);
      if (qr < p.sq)
        dq[qoff + static_cast<size_t>(qr) * D + c0 + dn * 8 + 2 * t + (i & 1)] =
            repro::from_float<T>(acc[dn][i] * p.scale);
    }
}

// ---------------------------------------------------------------------------
// backward, dk/dv per q head: one block per (b·h, KV tile), q tiles in the loop
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(DkvSweep<T, D>::NT)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Problem p) {
  using S = DkvSweep<T, D>;
  constexpr int LD = S::LD, BK = S::OWN, BQ = S::STR, NT = S::NT;
  constexpr int N8 = BQ / 8, DN8 = S::DOUT / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* ks = reinterpret_cast<T*>(bwd_smem);   // [BK][LD]
  T* vs = ks + BK * LD;                     // [BK][LD]
  T* qds = vs + BK * LD;                    // 2 stages of Q [BQ][LD], dO
  float* rows = reinterpret_cast<float*>(bwd_smem + S::TILES);
  //                                          2 stages of lse [BQ], delta

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const int row = 16 * (warp / S::kSplit);
  const int c0 = (warp % S::kSplit) * S::DOUT;
  // heads fast, the first KV tiles (the heaviest under a causal mask) first
  const int bh = blockIdx.x;
  const int kvh = (bh / p.h) * p.kv + (bh % p.h) / (p.h / p.kv);
  const int k0 = blockIdx.y * BK;
  const int kw = k0 + row;                        // the warp's first key
  const size_t qoff = static_cast<size_t>(bh) * p.sq * D;
  const size_t roff = static_cast<size_t>(bh) * p.sq;

  // the q tiles holding a query some key of the block is visible to
  int i0 = 0, i1 = 0;
  if (k0 < p.sk_orig) {
    const int k_last = min(k0 + BK, p.sk_orig) - 1;
    const int lo = p.causal ? k0 : 0;
    const int hi = p.window > 0 ? min(p.sq - 1, k_last + p.window - 1)
                                : p.sq - 1;
    if (lo <= hi) {
      i0 = lo / BQ;
      i1 = hi / BQ + 1;
    }
  }
  // Q, dO, lse and delta of q tile i into stage st
  auto stage = [&](int i, int st) {
    T* qd = qds + st * 2 * BQ * LD;
    copy_rows<BQ, D, LD, NT>(q + qoff, qd, i * BQ, p.sq);
    copy_rows<BQ, D, LD, NT>(dout + qoff, qd + BQ * LD, i * BQ, p.sq);
    float* r = rows + st * 2 * BQ;
    for (int e = threadIdx.x; e < 2 * BQ; e += NT) {
      const int qr = i * BQ + e % BQ;
      const float* src = e < BQ ? lse : delta;
      const bool in = qr < p.sq;
      cp_async4(r + e, in ? src + roff + qr : src, in ? 4 : 0);
    }
  };
  const size_t kvoff = static_cast<size_t>(kvh) * p.sk * D;
  copy_rows<BK, D, LD, NT>(k + kvoff, ks, k0, p.sk);
  copy_rows<BK, D, LD, NT>(v + kvoff, vs, k0, p.sk);
  cp_async_commit();
  if (i0 < i1) stage(i0, 0);
  cp_async_commit();

  float dk_acc[DN8][4], dv_acc[DN8][4];
#pragma unroll
  for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[dn][i] = dv_acc[dn][i] = 0.f;

  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) & 1;
    const T* qt = qds + st * 2 * BQ * LD;
    const T* dot = qt + BQ * LD;
    const float* lses = rows + st * 2 * BQ;
    const float* deltas = lses + BQ;
    if (i + 1 < i1) {
      stage(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = i * BQ, q_end = q0 + BQ - 1;
    const bool empty = kw >= p.sk_orig || q0 >= p.sq ||
                       (p.causal && kw > q_end) ||
                       (p.window > 0 && q0 - (kw + 15) >= p.window);
    const bool full = q_end < p.sq && kw + 15 < p.sk_orig &&
                      (!p.causal || kw + 15 <= q0) &&
                      (p.window <= 0 || q_end - kw < p.window);
    if (!empty) {
      // Sᵀ and dPᵀ: the warp's 16 keys by the tile's BQ queries
      float s[N8][4], dp[N8][4];
      scores<D, LD>(ks + row * LD, qt, vs + row * LD, dot, s, dp, g, t);
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const int kp = kw + g + 8 * (e / 2), qp = q0 + col;
          const bool ok = full || (qp < p.sq && visible(qp, kp, p));
          const float pv = ok ? expf(s[n][e] * p.scale - lses[col]) : 0.f;
          s[n][e] = pv;                                  // Pᵀ
          dp[n][e] = pv * (dp[n][e] - deltas[col]);     // dSᵀ
        }
      accumulate<LD>(s, dot, c0, dv_acc, g, t);
      accumulate<LD>(dp, qt, c0, dk_acc, g, t);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dn = 0; dn < DN8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = kw + g + 8 * (e / 2);
      if (kr >= p.sk) continue;
      const size_t at = (static_cast<size_t>(bh) * p.sk + kr) * D + c0 +
                        dn * 8 + 2 * t + (e & 1);
      dk[at] = repro::from_float<T>(dk_acc[dn][e] * p.scale);
      dv[at] = repro::from_float<T>(dv_acc[dn][e]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Lets `kernel` take `smem` bytes of dynamic shared memory (opt-in above the
// default 48 KB), then launches it on `grid` with `threads` a block.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > repro::kSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

Problem make_problem(int h, int kv, int sq, int sk, int d, int sk_orig,
                     int causal, int window) {
  // d ** -0.5 as the host computes it, rounded to fp32 once
  return Problem{h, kv, sq, sk, sk_orig, causal, window,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)))};
}

// b·h and the blocks along a sequence (64 or more rows each) are grid
// dimensions, at most 65535 each
bool valid(int b, int h, int kv, int sq, int sk, int sk_orig, int window) {
  return b > 0 && kv > 0 && h % kv == 0 && sq > 0 && sk > 0 && sk_orig > 0 &&
         sk_orig <= sk && window >= 0 && static_cast<long>(b) * h <= 65535 &&
         sq <= 65535 * 64 && sk <= 65535 * 64;
}

// Returns fn(Dim<D>{}) for the compiled head dim D equal to d.
template <int V>
struct Dim {
  static constexpr int value = V;
};
template <typename F>
int with_head_dim(int d, F&& fn) {
  switch (d) {
    case 32: return fn(Dim<32>{});
    case 64: return fn(Dim<64>{});
    case 128: return fn(Dim<128>{});
    case 256: return fn(Dim<256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool WITH_LSE>
int forward(const void* q, const void* k, const void* v, void* out, float* lse,
            int b, int h, int kv, int sq, int sk, int d, int sk_orig,
            int causal, int window, cudaStream_t stream) {
  const Problem p = make_problem(h, kv, sq, sk, d, sk_orig, causal, window);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    using S = FwdSweep<T, D>;
    return launch(fa_fwd_kernel<T, D, WITH_LSE>,
                  dim3(b * h, (sq + S::OWN - 1) / S::OWN), S::NT, S::SMEM,
                  stream, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out), lse, p);
  });
}

template <typename T>
int backward_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int b, int h,
                int kv, int sq, int sk, int d, int sk_orig, int causal,
                int window, cudaStream_t stream) {
  const Problem p = make_problem(h, kv, sq, sk, d, sk_orig, causal, window);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    using S = DqSweep<T, D>;
    return launch(fa_bwd_dq_kernel<T, D>,
                  dim3(b * h, (sq + S::OWN - 1) / S::OWN), S::NT, S::SMEM,
                  stream, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                  delta, static_cast<T*>(dq), p);
  });
}

template <typename T>
int backward_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int b, int h, int kv, int sq, int sk,
                 int d, int sk_orig, int causal, int window,
                 cudaStream_t stream) {
  const Problem p = make_problem(h, kv, sq, sk, d, sk_orig, causal, window);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    using S = DkvSweep<T, D>;
    return launch(fa_bwd_dkv_kernel<T, D>,
                  dim3(b * h, (sk + S::OWN - 1) / S::OWN), S::NT, S::SMEM,
                  stream, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                  delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  });
}

template <bool WITH_LSE>
int forward_typed(const void* q, const void* k, const void* v, void* out,
                  void* lse, int b, int h, int kv, int sq, int sk, int d,
                  int sk_orig, int causal, int window, int dtype,
                  void* stream) {
  if (!valid(b, h, kv, sq, sk, sk_orig, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::kFloat32)
    return forward<float, WITH_LSE>(q, k, v, out, l, b, h, kv, sq, sk, d,
                                    sk_orig, causal, window, s);
  if (dtype == repro::kBFloat16)
    return forward<__nv_bfloat16, WITH_LSE>(q, k, v, out, l, b, h, kv, sq, sk,
                                            d, sk_orig, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The four entry points, one per TPU kernel they replace.  q, out, dout, dq:
// [b,h,sq,d]; k, v: [b,kv,sk,d]; lse, delta: fp32 [b,h,sq]; dk, dv per q
// head: [b,h,sk,d]; all row-major and contiguous, in the type `dtype`
// (0 fp32, 1 bf16) unless stated.  Keys at or past sk_orig (1 <= sk_orig <=
// sk) are invisible; causal != 0 masks later keys; window > 0 masks keys
// `window` or more before the query.  d is 32, 64, 128 or 256; b·h <= 65535
// and sq, sk <= 65535·64.  Each launches on `stream` and returns the launch's cudaError_t (0 on
// success).

// `_fa_kernel`: out only.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int h,
                                     int kv, int sq, int sk, int d,
                                     int sk_orig, int causal, int window,
                                     int dtype, void* stream) {
  return forward_typed<false>(q, k, v, out, nullptr, b, h, kv, sq, sk, d,
                              sk_orig, causal, window, dtype, stream);
}

// `_fa_fwd_kernel`: out and lse = m + log(max(l, 1e-30)).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int b, int h, int kv, int sq, int sk,
                                         int d, int sk_orig, int causal,
                                         int window, int dtype, void* stream) {
  return forward_typed<true>(q, k, v, out, lse, b, h, kv, sq, sk, d, sk_orig,
                             causal, window, dtype, stream);
}

// `_fa_bwd_dq_kernel`: dq = scale · Σ_keys p·(dp − delta) · k.
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int kv,
    int sq, int sk, int d, int sk_orig, int causal, int window, int dtype,
    void* stream) {
  if (!valid(b, h, kv, sq, sk, sk_orig, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == repro::kFloat32)
    return backward_dq<float>(q, k, v, dout, l, dl, dq, b, h, kv, sq, sk, d,
                              sk_orig, causal, window, s);
  if (dtype == repro::kBFloat16)
    return backward_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, b, h, kv, sq,
                                      sk, d, sk_orig, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// `_fa_bwd_dkv_kernel`: per q head, dv = Σ_queries p·do and
// dk = scale · Σ_queries p·(dp − delta) · q.
extern "C" int repro_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int kv, int sq, int sk, int d, int sk_orig, int causal, int window,
    int dtype, void* stream) {
  if (!valid(b, h, kv, sq, sk, sk_orig, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == repro::kFloat32)
    return backward_dkv<float>(q, k, v, dout, l, dl, dk, dv, b, h, kv, sq, sk,
                               d, sk_orig, causal, window, s);
  if (dtype == repro::kBFloat16)
    return backward_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, b, h, kv,
                                       sq, sk, d, sk_orig, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
