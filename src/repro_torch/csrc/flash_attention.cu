// GQA flash attention for Hopper (sm_90a), forward and backward: fp32 or
// bf16 operands converted to fp32 as they are staged, fp32 arithmetic with
// plain FMAs (no TF32, no tensor cores), each output rounded to the
// operands' type once; lse and delta are fp32.
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
// `head / (H/KV)`: K and V are never expanded in device memory.
//
// Each block stages its own rows (Q, or K and V) once, then per step of the
// sweep the other operand's tile, in shared memory as fp32 with a row
// stride of D+1 (reads of D-long rows by 16 lanes fall in 16 banks).  A
// block has 256 threads as a 16 x 16 grid; a thread owns BQ/16 rows and
// BK/16 columns of each score tile and BQ/16 rows and D/16 columns of the
// output tile, and row reductions (max, sum) are shuffles over the 16 lanes
// of a half-warp.  Tiles are compiled in per head dim: 64 x 64 for every
// forward and for the backward at D <= 128, 32 x 32 for the backward at
// D = 256, where four staged 64-row tiles would not fit the 227 KB a block
// can take (kernels above 48 KB opt in with cudaFuncSetAttribute).  Ragged
// kernel tiles are masked: rows past Sq are zero and never written, keys
// past Sk take no part.  The caller's (bq, bk) only sets the padding, as in
// the JAX package.
//
// Masks and the finite NEG_INF: a score is visible when its key lies below
// `sk_orig`, and (causal) at or before its query, and (window > 0) less than
// `window` before it.  Invisible scores are -1e30, as in the Pallas kernels,
// never -inf: a row whose first visited tile is all masked gets p = exp(0) =
// 1 there, which the first visible tile wipes out through alpha =
// exp(-1e30 - m) = 0, where -inf would give inf - inf = NaN.  A row that
// sees no key at all (a padded query row under a window) ends up averaging
// every key's value, as in the Pallas kernels.
//
// Skipped tiles: a sweep visits only the tiles that hold a key (or query)
// some row (or column) of the block can see; the others change nothing,
// since all their p are 0 after the row's first visible key (alpha = 1),
// and what they add before it alpha = 0 wipes out.  The one exception is a
// forward block whose last query row sees no key: such a row must average
// all keys, so that block sweeps every KV tile.  Causal attention thus
// does about half the work of all tiles, and a window of w at S keys about
// w/S of it.
//
// What bounds it: attention does 4·S·D FLOP per query row forward and
// 14·S·D backward on 2-4 reads of a D-long row, some hundreds of FLOP a
// byte at the shapes used (S of 512-4096, D of 32-256), above the card's
// fp32 ridge of 20, so it is bound by the fp32 FMA rate (67 TFLOP/s on an
// H100 SXM outside the tensor cores).  In the inner loops a thread reads
// BQ/16 + BK/16 words of shared memory per 16 FMAs (score tiles) or BQ/16
// + D/16 per BQ·D/256 (output tiles), so shared-memory bandwidth holds it
// near half of that peak at best.  wgmma on bf16 tiles, TMA loads into a
// ring of stages and a warp-specialised pipeline are the known remedies,
// left for later work: this kernel is the simple fp32 one.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kLanes = 16;     // threads along a tile row (half a warp)
constexpr float kNegInf = -1e30f;

// Shape and mask of one call.  q, dq, do, out: [B,H,Sq,D]; k, v: [B,KV,Sk,D];
// lse, delta: [B,H,Sq]; per-q-head dk, dv: [B,H,Sk,D]; all contiguous.
struct Problem {
  int h, kv, sq, sk, sk_orig, causal, window;
  float scale;
};

constexpr int kFwdTile = 64;
constexpr int bwd_tile(int d) { return d <= 128 ? 64 : 32; }

// Row strides of the staged tiles: D+1 floats for operand rows; BK+16 for
// score tiles, so the two rows a warp touches fall 16 banks apart.
template <int D>
__host__ __device__ constexpr int ld() { return D + 1; }
template <int BK>
__host__ __device__ constexpr int sld() { return BK + 16; }

__device__ __forceinline__ bool visible(int qp, int kp, const Problem& p) {
  bool ok = kp < p.sk_orig;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && qp - kp < p.window;
  return ok;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stages rows [row0, row0 + ROWS) of the row-major [n, D] matrix `src` into
// `dst` as fp32 with row stride D+1; rows at or past n become zero.
// Coalesced: consecutive threads read consecutive elements of a row.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int row0, int n) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * ld<D>() + c] =
        row0 + r < n
            ? repro::to_float(src[static_cast<size_t>(row0 + r) * D + c])
            : 0.f;
  }
}

// The KV tiles [j0, j1) a forward or dq block over queries [q0, q_last]
// visits: those holding a key some of its rows can see.  With `all_if_blind`
// (the forward), every tile when its last row sees no key.
template <int BK>
__device__ __forceinline__ void kv_tiles(int q0, int q_last, const Problem& p,
                                         bool all_if_blind, int& j0, int& j1) {
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.sk_orig - 1, q_last) : p.sk_orig - 1;
  const int lo_last = p.window > 0 ? max(0, q_last - p.window + 1) : 0;
  if (all_if_blind && lo_last > hi) {
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
// forward: `_fa_kernel` and `_fa_fwd_kernel` in one template
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr size_t fwd_smem() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * ld<D>() +
                          static_cast<size_t>(BQ) * sld<BK>());
}

template <typename T, int D, int BQ, int BK, bool WITH_LSE>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, Problem p) {
  constexpr int RM = BQ / kLanes;  // query rows a thread owns
  constexpr int CN = BK / kLanes;  // score columns a thread owns
  constexpr int DN = D / kLanes;   // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;                   // [BQ][D+1]
  float* ks = qs + BQ * ld<D>();      // [BK][D+1]
  float* vs = ks + BK * ld<D>();      // [BK][D+1]
  float* ps = vs + BK * ld<D>();      // [BQ][BK+16]

  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int bh = blockIdx.y;
  const int kvh = (bh / p.h) * p.kv + (bh % p.h) / (p.h / p.kv);
  // the last q tiles carry the most causal work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const T* qh = q + static_cast<size_t>(bh) * p.sq * D;
  const T* kh = k + static_cast<size_t>(kvh) * p.sk * D;
  const T* vh = v + static_cast<size_t>(kvh) * p.sk * D;

  stage_rows<BQ, D>(qh, qs, q0, p.sq);

  float acc[RM][DN], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  int j0, j1;
  kv_tiles<BK>(q0, q_last, p, true, j0, j1);
  for (int j = j0; j < j1; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<BK, D>(kh, ks, k0, p.sk);
    stage_rows<BK, D>(vh, vs, k0, p.sk);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[(ty + i * kLanes) * ld<D>() + e];
#pragma unroll
      for (int c = 0; c < CN; ++c) b[c] = ks[(tx + c * kLanes) * ld<D>() + e];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] = fmaf(a[i], b[c], s[i][c]);
    }

    // online softmax, in the Pallas kernel's order of operations
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + i * kLanes;
      float mx = -INFINITY;  // only ever a key past Sk keeps it
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kp = k0 + tx + c * kLanes;
        const float sv = visible(qp, kp, p) ? s[i][c] * p.scale : kNegInf;
        s[i][c] = sv;
        if (kp < p.sk) mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kp = k0 + tx + c * kLanes;
        const float pv = kp < p.sk ? expf(s[i][c] - m_new) : 0.f;
        ps[(ty + i * kLanes) * sld<BK>() + tx + c * kLanes] = pv;
        rs += pv;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RM], b[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ps[(ty + i * kLanes) * sld<BK>() + c];
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) b[dd] = vs[c * ld<D>() + tx + dd * kLanes];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd) acc[i][dd] = fmaf(a[i], b[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty + i * kLanes;
    if (qr >= p.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<size_t>(bh) * p.sq + qr) * D;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd)
      orow[tx + dd * kLanes] = repro::from_float<T>(acc[i][dd] / li);
    if (WITH_LSE && tx == 0)
      lse[static_cast<size_t>(bh) * p.sq + qr] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (b·h, q tile), KV tiles in the loop
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * ld<D>() +
                          static_cast<size_t>(BQ) * sld<BK>());
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     Problem p) {
  constexpr int RM = BQ / kLanes, CN = BK / kLanes, DN = D / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;                   // [BQ][D+1]
  float* dos = qs + BQ * ld<D>();     // [BQ][D+1]
  float* ks = dos + BQ * ld<D>();     // [BK][D+1]
  float* vs = ks + BK * ld<D>();      // [BK][D+1]
  float* dss = vs + BK * ld<D>();     // [BQ][BK+16]

  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int bh = blockIdx.y;
  const int kvh = (bh / p.h) * p.kv + (bh % p.h) / (p.h / p.kv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const size_t qoff = static_cast<size_t>(bh) * p.sq * D;
  const T* kh = k + static_cast<size_t>(kvh) * p.sk * D;
  const T* vh = v + static_cast<size_t>(kvh) * p.sk * D;

  stage_rows<BQ, D>(q + qoff, qs, q0, p.sq);
  stage_rows<BQ, D>(dout + qoff, dos, q0, p.sq);
  float row_lse[RM], row_delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty + i * kLanes;
    const size_t at = static_cast<size_t>(bh) * p.sq + qr;
    row_lse[i] = qr < p.sq ? lse[at] : 0.f;
    row_delta[i] = qr < p.sq ? delta[at] : 0.f;
  }

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) acc[i][dd] = 0.f;

  int j0, j1;
  kv_tiles<BK>(q0, q_last, p, false, j0, j1);
  for (int j = j0; j < j1; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    stage_rows<BK, D>(kh, ks, k0, p.sk);
    stage_rows<BK, D>(vh, vs, k0, p.sk);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[RM], g[RM], b[CN], w[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = qs[(ty + i * kLanes) * ld<D>() + e];
        g[i] = dos[(ty + i * kLanes) * ld<D>() + e];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        b[c] = ks[(tx + c * kLanes) * ld<D>() + e];
        w[c] = vs[(tx + c * kLanes) * ld<D>() + e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = fmaf(a[i], b[c], s[i][c]);
          dp[i][c] = fmaf(g[i], w[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + i * kLanes;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kp = k0 + tx + c * kLanes;
        const bool ok = qp < p.sq && kp < p.sk && visible(qp, kp, p);
        const float pv = ok ? expf(s[i][c] * p.scale - row_lse[i]) : 0.f;
        dss[(ty + i * kLanes) * sld<BK>() + tx + c * kLanes] =
            pv * (dp[i][c] - row_delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RM], b[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = dss[(ty + i * kLanes) * sld<BK>() + c];
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) b[dd] = ks[c * ld<D>() + tx + dd * kLanes];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd) acc[i][dd] = fmaf(a[i], b[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty + i * kLanes;
    if (qr >= p.sq) continue;
    T* row = dq + qoff + static_cast<size_t>(qr) * D;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd)
      row[tx + dd * kLanes] = repro::from_float<T>(acc[i][dd] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// backward, dk/dv per q head: one block per (b·h, KV tile), q tiles in the loop
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr size_t dkv_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BK + 2 * BQ) * ld<D>() +
                          2 * static_cast<size_t>(BK) * sld<BQ>() + 2 * BQ);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Problem p) {
  constexpr int RK = BK / kLanes;  // key rows a thread owns
  constexpr int CQ = BQ / kLanes;  // query columns of a transposed score tile
  constexpr int DN = D / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;                   // [BK][D+1]
  float* vs = ks + BK * ld<D>();      // [BK][D+1]
  float* qs = vs + BK * ld<D>();      // [BQ][D+1]
  float* dos = qs + BQ * ld<D>();     // [BQ][D+1]
  float* pts = dos + BQ * ld<D>();    // [BK][BQ+16]: p transposed
  float* dsts = pts + BK * sld<BQ>(); // [BK][BQ+16]: ds transposed
  float* lses = dsts + BK * sld<BQ>();  // [BQ]
  float* deltas = lses + BQ;            // [BQ]

  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int bh = blockIdx.y;
  const int kvh = (bh / p.h) * p.kv + (bh % p.h) / (p.h / p.kv);
  const int k0 = blockIdx.x * BK;
  const size_t qoff = static_cast<size_t>(bh) * p.sq * D;
  stage_rows<BK, D>(k + static_cast<size_t>(kvh) * p.sk * D, ks, k0, p.sk);
  stage_rows<BK, D>(v + static_cast<size_t>(kvh) * p.sk * D, vs, k0, p.sk);

  float dk_acc[RK][DN], dv_acc[RK][DN];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) dk_acc[r][dd] = dv_acc[r][dd] = 0.f;

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
  for (int i = i0; i < i1; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    stage_rows<BQ, D>(q + qoff, qs, q0, p.sq);
    stage_rows<BQ, D>(dout + qoff, dos, q0, p.sq);
    for (int e = threadIdx.x; e < BQ; e += kThreads) {
      const bool in = q0 + e < p.sq;
      lses[e] = in ? lse[static_cast<size_t>(bh) * p.sq + q0 + e] : 0.f;
      deltas[e] = in ? delta[static_cast<size_t>(bh) * p.sq + q0 + e] : 0.f;
    }
    __syncthreads();

    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int r = 0; r < RK; ++r)
#pragma unroll
      for (int c = 0; c < CQ; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[RK], w[RK], b[CQ], g[CQ];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        a[r] = ks[(ty + r * kLanes) * ld<D>() + e];
        w[r] = vs[(ty + r * kLanes) * ld<D>() + e];
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        b[c] = qs[(tx + c * kLanes) * ld<D>() + e];
        g[c] = dos[(tx + c * kLanes) * ld<D>() + e];
      }
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          s[r][c] = fmaf(a[r], b[c], s[r][c]);
          dp[r][c] = fmaf(w[r], g[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < RK; ++r) {
      const int kp = k0 + ty + r * kLanes;
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int col = tx + c * kLanes;
        const int qp = q0 + col;
        const bool ok = qp < p.sq && kp < p.sk && visible(qp, kp, p);
        const float pv = ok ? expf(s[r][c] * p.scale - lses[col]) : 0.f;
        pts[(ty + r * kLanes) * sld<BQ>() + col] = pv;
        dsts[(ty + r * kLanes) * sld<BQ>() + col] = pv * (dp[r][c] - deltas[col]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pa[RK], da[RK], gb[DN], qb[DN];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        pa[r] = pts[(ty + r * kLanes) * sld<BQ>() + c];
        da[r] = dsts[(ty + r * kLanes) * sld<BQ>() + c];
      }
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) {
        gb[dd] = dos[c * ld<D>() + tx + dd * kLanes];
        qb[dd] = qs[c * ld<D>() + tx + dd * kLanes];
      }
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd) {
          dv_acc[r][dd] = fmaf(pa[r], gb[dd], dv_acc[r][dd]);
          dk_acc[r][dd] = fmaf(da[r], qb[dd], dk_acc[r][dd]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kr = k0 + ty + r * kLanes;
    if (kr >= p.sk) continue;
    const size_t row = (static_cast<size_t>(bh) * p.sk + kr) * D;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) {
      dk[row + tx + dd * kLanes] = repro::from_float<T>(dk_acc[r][dd] * p.scale);
      dv[row + tx + dd * kLanes] = repro::from_float<T>(dv_acc[r][dd]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Lets `kernel` take `smem` bytes of dynamic shared memory (opt-in above the
// default 48 KB), then launches it on `grid`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > repro::kSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

Problem make_problem(int h, int kv, int sq, int sk, int d, int sk_orig,
                     int causal, int window) {
  // d ** -0.5 as the host computes it, rounded to fp32 once
  return Problem{h, kv, sq, sk, sk_orig, causal, window,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)))};
}

bool valid(int b, int h, int kv, int sq, int sk, int sk_orig, int window) {
  return b > 0 && kv > 0 && h % kv == 0 && sq > 0 && sk > 0 && sk_orig > 0 &&
         sk_orig <= sk && window >= 0 && static_cast<long>(b) * h <= 65535;
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
    constexpr int D = decltype(dim)::value, B = kFwdTile;
    return launch(fa_fwd_kernel<T, D, B, B, WITH_LSE>,
                  dim3((sq + B - 1) / B, b * h), fwd_smem<D, B, B>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
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
    constexpr int D = decltype(dim)::value, B = bwd_tile(D);
    return launch(fa_bwd_dq_kernel<T, D, B, B>,
                  dim3((sq + B - 1) / B, b * h), dq_smem<D, B, B>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
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
    constexpr int D = decltype(dim)::value, B = bwd_tile(D);
    return launch(fa_bwd_dkv_kernel<T, D, B, B>,
                  dim3((sk + B - 1) / B, b * h), dkv_smem<D, B, B>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
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
// `window` or more before the query.  d is 32, 64, 128 or 256; b·h <= 65535.
// Each launches on `stream` and returns the launch's cudaError_t (0 on
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
