// The kNN similarity kernel: scores of B query vectors against N document
// vectors, masked, in XLA:CPU's arithmetic.
//
// Replaces: elasticsearch_tpu/search/knn.py::_similarity_scores (the REST
// `knn` section's per-segment scores, with shard_candidates' mask) and the
// dot products and norms of elasticsearch_tpu/parallel/distributed.py::
// _knn_local_body (the mesh kNN step; its own score formulas). The plain
// torch version of both is elasticsearch_tpu_torch/ops/knn_kernel.py::
// knn_scores_plain; the top-k after it is the shard_topk kernel.
//
// Parity. The reference's scores are XLA:CPU's bits, and those depend on
// the order of every sum, so each (document, query) pair keeps XLA:CPU's
// ordered chains:
//   - the dot product is XLA:CPU's gemv: eight lane accumulators, lane j a
//     fused multiply-add chain over columns j, j+8, ... up to the last
//     multiple of 8, the lanes added ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)),
//     then the tail's chain from 0 over the remaining columns, added last;
//   - a norm or a squared distance is XLA:CPU's row sum: windows of 32
//     (zero-padded, the pad split pad / 2 low, the rest high), each summed
//     left to right from 0, the window sums reduced the same way;
//   - every step is one IEEE operation rounded to nearest in the PTX .ftz
//     form (fma/add/sub/mul/div/sqrt .rn.ftz.f32, the <ptx> block below):
//     a subnormal operand is read as a zero, and a result that is tiny
//     after rounding to 24 bits with an unbounded exponent is flushed to a
//     zero of its sign. That is x86's rule, under which XLA:CPU runs with
//     FTZ and DAZ: tools/ftz_probe.py on an H100 finds no fma or mul
//     result of 4,098 near FLT_MIN that differs from it. -fmad=false, so
//     nothing else is contracted.
// Tensor cores, TF32 and cuBLAS cannot give these bits: they sum in tiles
// of their own order (and TF32 drops 13 mantissa bits).
//
// Design. A gemv lane is what one accumulator of a register-tiled SGEMM
// is along K, so the dot products are 8 interleaved products with K =
// dims / 8, on the FP32 pipes. Both operands are staged in shared memory
// by cp.async in stages of 128 columns (a ring of three: the stage before,
// read again by the windows that straddle a stage's first column; the
// current one; the next one in flight, and the one after it issued once
// the windows are read), in rows of 136 floats, so that the eight 16-byte
// pieces a warp's load asks for fall in distinct banks. A subnormal
// operand needs no pass of its own: the .ftz operations read it as a zero.
// The mesh formula's nan_to_num is applied in place, by each thread to
// the pieces it copied, before the stage is shared.
//   knn_tile_kernel (B >= 8): a block takes 64 documents x 64 queries;
//     each thread holds lanes 4h..4h+3 (h = its lane's low bit) of 4
//     documents x 8 queries, 128 accumulators: a step of 8 columns is 4 +
//     8 float4 loads for 128 fused multiply-adds. The tree's two halves
//     meet through __shfl_xor_sync(1). A document's sum of squares comes
//     from the staged rows: 256 threads take the stage's 4 windows of its
//     64 rows, and 64 of them fold the window sums in order. The scores go
//     through shared memory to float4 stores of consecutive documents.
//     At B <= 64 every row is read from device memory once.
//   knn_row_kernel (B < 8, and the segment formula's l2_norm at any B): a
//     block takes 32 documents and up to 8 queries; thread (d, j) holds
//     lane j of document d for each query, the tree through
//     __shfl_xor_sync 1, 2, 4; the windows (squares and, for l2_norm,
//     squared distances a pair) from the staged rows.
//   knn_qss_kernel: each query's sum of squares, once a launch.
//
// What bounds it on an H100. The work is 2 * B * N * dims operations in
// FP32 outside the tensor cores (67 TFLOP/s) against N * dims * 4 bytes of
// vectors read once and B * N * 4 bytes of scores written (3.35 TB/s): at
// B = 64, dims = 768 the operations bound it (1.47 ms at 1M rows); one
// query is bound by the bytes (0.057 ms for a 62,592-row segment).
// On an H100 80GB HBM3 at 700 W the tile kernel's loop runs at about 43
// TFLOP/s fed from shared memory, where the same accumulators fed from
// registers reach 64; the stages' copies, the windows' serial chains and
// the tile's scores run between barriers (tools/knn_ablate.py). ptxas
// (-Xptxas -v, the package's flags; tools/ptxas_report.py --source knn):
// knn_tile_kernel 223 registers, no spills, 211,200 B of shared memory,
// 1 block an SM; knn_row_kernel<8> 128 registers; knn_row_kernel<1> 40
// registers, 55,396 B, 4 blocks an SM; knn_qss_kernel 29 registers.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 4096;  // the mapping's dims limit, knn_kernel.MAX_DIMS
constexpr int kMaxWindows = kMaxDims / 32;    // first-level window sums

// kinds (knn_kernel.KINDS' order)
constexpr int kL2 = 0;
constexpr int kDot = 1;
constexpr int kCosine = 2;

constexpr int kThreads = 256;
constexpr int kStageCols = 128;             // 4 windows of 32
constexpr int kPitch = kStageCols + 8;      // a staged row: 8 (mod 32) banks
constexpr int kStages = 3;
constexpr int kTileDocs = 64;
constexpr int kTileQueries = 64;
constexpr int kOutPitch = kTileDocs + 4;
constexpr int kRowDocs = 32;
constexpr int kRowQueries = 8;

// instances (es_knn_plan)
constexpr int kTile = 0;
constexpr int kRow = 1;
constexpr int kRow1 = 2;

// <ptx>
__device__ __forceinline__ float fma_z(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
__device__ __forceinline__ float add_z(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sub_z(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float mul_z(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float div_z(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sqrt_z(float a) {
  float r;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
// `bytes` (16 or 0) from global to shared memory; the rest of the 16 zero
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
// `bytes` (4 or 0) from global to shared memory; a zero for 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group but the newest `N` has landed (this thread's)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// </ptx>

// jnp.maximum(x, lo): a NaN x stays NaN
__device__ __forceinline__ float nan_max(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
// jnp.nan_to_num: NaN 0, +-inf +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  return isnan(x) ? 0.0f : fminf(fmaxf(x, -FLT_MAX), FLT_MAX);
}

// The row sum's shape for K = dims entries: nw windows of 32 (lo of the
// pad low), and, past 32 windows, nw2 windows of window sums (lo2 low).
struct Windows {
  int nw, lo, lo2;
  __device__ explicit Windows(int dims)
      : nw((dims + 31) / 32),
        lo((nw * 32 - dims) / 2),
        lo2((((nw + 31) / 32) * 32 - nw) / 2) {}
};

// The window sums of one row fed in order (w = 0, 1, ...): the row sum
// of squares (or of squared differences) without its first level.
// Every summand is +0 or more (or NaN), so the zero pad adds nothing.
struct WindowFold {
  float acc2 = 0.0f, sum = 0.0f;
  __device__ void push(float v, int w, const Windows& win) {
    if (win.nw <= 32) {
      sum = add_z(sum, v);
      return;
    }
    acc2 = add_z(acc2, v);
    if (((w + win.lo2) & 31) == 31 || w == win.nw - 1) {
      sum = add_z(sum, acc2);
      acc2 = 0.0f;
    }
  }
};

// nan_to_num in place over a staged float4 (the mesh formula's rows)
__device__ __forceinline__ void sanitize4(float* d) {
  float4 v = *reinterpret_cast<const float4*>(d);
  if (fabsf(v.x) <= FLT_MAX && fabsf(v.y) <= FLT_MAX &&
      fabsf(v.z) <= FLT_MAX && fabsf(v.w) <= FLT_MAX)
    return;
  v.x = nan_to_num(v.x);
  v.y = nan_to_num(v.y);
  v.z = nan_to_num(v.z);
  v.w = nan_to_num(v.w);
  *reinterpret_cast<float4*>(d) = v;
}

// A summand of the row sums: x^2 (a sum of squares) or (x - y)^2 (a
// squared distance).
template <bool kDist>
__device__ __forceinline__ float summand(float x, float y) {
  if (kDist) {
    const float e = sub_z(x, y);
    return mul_z(e, e);
  }
  return mul_z(x, x);
}

// First-level window w of a staged row: the summands of columns
// [32 w - lo, 32 w - lo + 32) ∩ [0, dims), left to right from 0. The
// stage that starts at column c0 holds the row at cx (and the query's at
// cy), the stage before at px (py); a window reaches back into it only by
// the lo columns it straddles.
// With `fix` (the mesh formula, a whole window in the current stage) the
// window's 32 staged values are sanitized in place as they are read.
template <bool kDist>
__device__ __forceinline__ float window_sum(int w, const Windows& win,
                                            int dims, int c0, float* cx,
                                            const float* px, const float* cy,
                                            const float* py, bool fix) {
  const int p0 = 32 * w - win.lo;
  const int a = p0 > 0 ? p0 : 0;
  const int e = p0 + 32 < dims ? p0 + 32 : dims;
  float acc = 0.0f;
  if (a == p0 && e == p0 + 32 && a >= c0 && ((a - c0) & 3) == 0) {
    // whole and in the current stage: eight float4 loads
    float4* X = reinterpret_cast<float4*>(cx + (a - c0));
    const float4* Y = reinterpret_cast<const float4*>(
        (kDist ? cy : cx) + (a - c0));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (fix) sanitize4(reinterpret_cast<float*>(X + i));
      const float4 v = X[i];
      const float4 u = kDist ? Y[i] : v;
      acc = add_z(acc, summand<kDist>(v.x, u.x));
      acc = add_z(acc, summand<kDist>(v.y, u.y));
      acc = add_z(acc, summand<kDist>(v.z, u.z));
      acc = add_z(acc, summand<kDist>(v.w, u.w));
    }
    return acc;
  }
  for (int p = a; p < e; ++p) {
    const bool cur = p >= c0;
    const int i = cur ? p - c0 : p - c0 + kStageCols;
    const float x = (cur ? cx : px)[i];
    acc = add_z(acc, summand<kDist>(x, kDist ? (cur ? cy : py)[i] : 0.0f));
  }
  return acc;
}

// Rows [r0, r0 + rows) of a row-major f32[limit, dims] matrix, columns
// [c0, c0 + cols), into dst (kPitch floats a row) by cp.async: 16-byte
// pieces where the rows are 16-byte aligned (vec; a warp a row, a lane a
// piece), else 4-byte ones; rows past `limit` are zeros. With `fix`,
// nothing is copied: the pieces this thread copied are sanitized in place
// (after its copies have landed).
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long r0, int rows,
                                           long long limit, int dims, int c0,
                                           int cols, bool vec, bool fix) {
  const int t = threadIdx.x;
  if (vec) {
    constexpr int kRowsAPass = kThreads / 32;
    const int c = 4 * (t & 31);
    if (c >= cols) return;
    int r = t >> 5;
    float* d = dst + r * kPitch + c;
    const float* g = src + (r0 + r) * dims + c0 + c;
    for (; r < rows; r += kRowsAPass, d += kRowsAPass * kPitch,
                     g += (long long)kRowsAPass * dims) {
      if (fix) {
        sanitize4(d);
        continue;
      }
      const bool in = r0 + r < limit;
      cp_async16(d, in ? g : src, in ? 16 : 0);
    }
    return;
  }
  constexpr int kRowsAPass = kThreads / kStageCols;
  const int c = t % kStageCols;
  if (c >= cols) return;
  int r = t / kStageCols;
  float* d = dst + r * kPitch + c;
  const float* g = src + (r0 + r) * dims + c0 + c;
  for (; r < rows; r += kRowsAPass, d += kRowsAPass * kPitch,
                   g += (long long)kRowsAPass * dims) {
    if (fix) {
      *d = nan_to_num(*d);
      continue;
    }
    const bool in = r0 + r < limit;
    cp_async4(d, in ? g : src, in ? 4 : 0);
  }
}

// The score of a pair from its dot product (dot), the document's and the
// query's sums of squares (dss, qss) and their square roots (sd, sq: the
// cosine's), and, for the segment formula's l2_norm, its squared distance
// (d2); -inf where masked. mesh = 0: the per-segment scores
// (knn.py::_similarity_scores), masked by NaN raw values, `ok` (in keep)
// and the `similarity` threshold (raw >= thr). mesh = 1: the mesh step's
// formulas, masked by keep (`ok` and a NaN first component). A halving
// is a multiplication by 0.5: the same exact value, so the same rounding
// and flush.
__device__ __forceinline__ float masked_score(int kind, int mesh, int has_thr,
                                              float thr, float dot, float dss,
                                              float qss, float sd, float sq,
                                              float d2, bool keep) {
  float score;
  if (!mesh) {
    float raw;
    if (kind == kL2) {
      raw = -sqrt_z(d2);
      score = div_z(1.0f, add_z(1.0f, d2));
    } else if (kind == kDot) {
      raw = dot;
      score = mul_z(add_z(1.0f, raw), 0.5f);
    } else {
      raw = div_z(dot, nan_max(mul_z(sd, sq), 1e-12f));
      score = mul_z(add_z(1.0f, raw), 0.5f);
    }
    keep = keep && !isnan(raw);
    if (has_thr) keep = keep && raw >= thr;
  } else if (kind == kL2) {
    // ||d||^2 - 2 d.q + ||q||^2, clamped at 0
    const float m2 = add_z(sub_z(dss, mul_z(2.0f, dot)), qss);
    score = div_z(1.0f, add_z(1.0f, nan_max(m2, 0.0f)));
  } else if (kind == kDot) {
    score = mul_z(add_z(1.0f, dot), 0.5f);
  } else {
    const float den = nan_max(mul_z(sq, sd), 1e-12f);
    score = mul_z(add_z(1.0f, div_z(dot, den)), 0.5f);
  }
  return keep ? score : -INFINITY;
}

// ok[doc] and, for the mesh formula, a first component that is not NaN
__device__ __forceinline__ int keep_doc(const float* vectors, long long n,
                                        int dims, const uint8_t* ok,
                                        int mesh, long long doc) {
  if (doc >= n || (ok != nullptr && ok[doc] == 0)) return 0;
  return !(mesh && isnan(vectors[doc * dims]));
}

// Each query's sum of squares, XLA:CPU's row sum (once a launch): a warp
// a query, lane w the first-level windows w, w + 32, ...; lane 0 the rest.
__global__ void __launch_bounds__(128)
knn_qss_kernel(const float* __restrict__ queries, int b, int dims,
               float* __restrict__ qss) {
  __shared__ float wsum[4][kMaxWindows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * 4 + warp;
  if (q >= b) return;
  const float* row = queries + (long long)q * dims;
  const Windows win(dims);
  for (int w = lane; w < win.nw; w += 32) {
    const int p0 = 32 * w - win.lo;
    const int a = p0 > 0 ? p0 : 0;
    const int e = p0 + 32 < dims ? p0 + 32 : dims;
    float acc = 0.0f;
    for (int p = a; p < e; ++p) acc = add_z(acc, mul_z(row[p], row[p]));
    wsum[warp][w] = acc;
  }
  __syncwarp();
  if (lane == 0) {
    WindowFold fold;
    for (int w = 0; w < win.nw; ++w) fold.push(wsum[warp][w], w, win);
    qss[q] = fold.sum;
  }
}

// The stage ring of a persistent block: its tiles are blockIdx.x,
// + gridDim.x, ..., each S stages of 128 columns; global stage g is stage
// g % S of the block's tile g / S, in buffer g % kStages. A tile's first
// stages are in flight while the tile before it finishes.
struct Ring {
  int S;              // stages a tile
  long long G;        // stages of all this block's tiles
  __device__ Ring(int dims, long long tiles)
      : S((dims + kStageCols - 1) / kStageCols),
        G(blockIdx.x < tiles
              ? ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * (long long)S
              : 0) {}
  __device__ long long tile(long long g) const {
    return blockIdx.x + (g / S) * (long long)gridDim.x;
  }
};

// Persistent blocks over tiles of 64 documents x 64 queries (tile k:
// documents (k / n_qtiles) * 64, queries (k % n_qtiles) * 64).
__global__ void __launch_bounds__(kThreads, 1)
knn_tile_kernel(const float* __restrict__ vectors, long long n, int dims,
                const float* __restrict__ queries, int b,
                const uint8_t* __restrict__ ok, int kind, int mesh,
                int has_thr, float thr, const float* __restrict__ qss,
                float* __restrict__ out, int n_qtiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStageFloats = (kTileDocs + kTileQueries) * kPitch;
  float* ws = smem + kStages * kStageFloats;   // [64][4] window sums
  float* dss_s = ws + kTileDocs * 4;           // [64]
  float* sd_s = dss_s + kTileDocs;             // [64] their square roots
  float* qss_s = sd_s + kTileDocs;             // [64]
  float* sq_s = qss_s + kTileQueries;          // [64] their square roots
  int* keep_s = (int*)(sq_s + kTileQueries);   // [64]
  const int t = threadIdx.x;
  const bool norms = kind == kCosine || (mesh && kind == kL2);
  const long long n_tiles = ((n + kTileDocs - 1) / kTileDocs) * n_qtiles;
  const Ring ring(dims, n_tiles);
  const int S = ring.S;
  const int full = dims & ~7;
  const Windows win(dims);
  // the mesh formula's sanitizing done by the windows, which read every
  // staged value of the documents once where they are whole (dims a
  // multiple of 32)
  const bool fused_fix = mesh && norms && vec && dims % 32 == 0;

  auto docs = [&](long long g) {
    return smem + (int)(g % kStages) * kStageFloats;
  };
  auto qrys = [&](long long g) { return docs(g) + kTileDocs * kPitch; };
  auto stage = [&](long long g, bool fix) {
    const long long tile = ring.tile(g);
    const long long d0 = (tile / n_qtiles) * kTileDocs;
    const int c0 = (int)(g % S) * kStageCols;
    const int cols = dims - c0 < kStageCols ? dims - c0 : kStageCols;
    stage_rows(docs(g), vectors, d0, kTileDocs, n, dims, c0, cols, vec, fix);
    if (!fix)
      stage_rows(qrys(g), queries, (tile % n_qtiles) * kTileQueries,
                 kTileQueries, b, dims, c0, cols, vec, false);
  };
  auto load = [&](long long g) {
    if (g < ring.G) stage(g, false);
    cp_async_commit();
  };
  load(0);
  load(1);
  // thread t < 64: the masks and query norm of a tile, loaded a stage
  // before the tile starts (while the tile before runs its last FMAs)
  int pf_in = 0, pf_ok = 0;
  float pf_v0 = 0.0f, pf_qss = 0.0f;
  auto prefetch = [&](long long g1) {
    const long long tile1 = ring.tile(g1);
    const long long doc = (tile1 / n_qtiles) * kTileDocs + t;
    const int q = (int)(tile1 % n_qtiles) * kTileQueries + t;
    pf_in = doc < n;
    pf_ok = !pf_in || ok == nullptr || ok[doc] != 0;
    pf_v0 = pf_in && mesh ? vectors[doc * dims] : 0.0f;
    pf_qss = norms && q < b ? qss[q] : 0.0f;
  };
  if (t < kTileDocs && ring.G > 0) prefetch(0);

  // lanes 2e, 2e + 1 (e = lane & 3) of documents dq + 2i x queries
  // qq + 4i (i < 8): a warp 16 documents x 32 queries, in 8-byte loads
  // that fall in distinct banks a half-warp
  const int lane = t & 31, warp = t >> 5;
  const int e = lane & 3;
  const int dq = 16 * (warp & 3) + ((lane >> 2) & 1);
  const int qq = 32 * (warp >> 2) + (lane >> 3);
  float acc[8][8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int qi = 0; qi < 8; ++qi) acc[i][qi][0] = acc[i][qi][1] = 0.0f;
  WindowFold fold;  // thread t < 64: document t's sum of squares

  for (long long g = 0; g < ring.G; ++g) {
    const int s = (int)(g % S);
    const long long tile = ring.tile(g);
    const long long d0 = (tile / n_qtiles) * kTileDocs;
    const int q0 = (int)(tile % n_qtiles) * kTileQueries;
    cp_async_wait<1>();
    if (mesh && !fused_fix) stage(g, true);
    __syncthreads();  // stage g whole; stage g - 3 read by every thread
    if (s == 0 && t < kTileDocs) {  // the tile's masks and query norms
      keep_s[t] = pf_in && pf_ok && !(mesh && isnan(pf_v0));
      qss_s[t] = pf_qss;
      sq_s[t] = sqrt_z(pf_qss);
    }
    if (norms) {
      const int d = t & (kTileDocs - 1), k = t >> 6, w = 4 * s + k;
      if (w < win.nw)
        ws[d * 4 + k] = window_sum<false>(
            w, win, dims, s * kStageCols, docs(g) + d * kPitch,
            docs(g + kStages - 1) + d * kPitch, nullptr, nullptr, fused_fix);
    }
    __syncthreads();  // the windows read stage g - 1 for the last time
    load(g + 2);
    if (norms && t < kTileDocs)
      for (int k = 0; k < 4 && 4 * s + k < win.nw; ++k)
        fold.push(ws[t * 4 + k], 4 * s + k, win);
    if (s == S - 1 && t < kTileDocs && g + 1 < ring.G) prefetch(g + 1);
    const float* D = docs(g) + dq * kPitch + 2 * e;
    const float* Q = qrys(g) + qq * kPitch + 2 * e;
    const int cols = full - s * kStageCols;
    const int steps = (cols < kStageCols ? cols : kStageCols) / 8;
    for (int ks = 0; ks < steps; ++ks) {
      float2 dv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dv[i] = *reinterpret_cast<const float2*>(D + 2 * i * kPitch + 8 * ks);
#pragma unroll
      for (int qi = 0; qi < 8; ++qi) {
        const float2 qv =
            *reinterpret_cast<const float2*>(Q + 4 * qi * kPitch + 8 * ks);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][qi][0] = fma_z(dv[i].x, qv.x, acc[i][qi][0]);
          acc[i][qi][1] = fma_z(dv[i].y, qv.y, acc[i][qi][1]);
        }
      }
    }
    if (s != S - 1) continue;

    // the tile's scores
    if (t < kTileDocs) {
      dss_s[t] = fold.sum;
      sd_s[t] = sqrt_z(fold.sum);
      fold = WindowFold();
    }
    // the tree: (l2e + l2e+1), then with lane ^ 1, then lane ^ 2; this
    // thread keeps queries qq + 4 (2e + j), j < 2
    float dot[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int qi = 0; qi < 8; ++qi) {
        float v = add_z(acc[i][qi][0], acc[i][qi][1]);
        v = add_z(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = add_z(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if ((qi >> 1) == e) dot[i][qi & 1] = v;
        acc[i][qi][0] = acc[i][qi][1] = 0.0f;
      }
    // the tail's chain from 0, added last
    const float* Dl = docs(g);
    const float* Ql = qrys(g);
    const int cl = s * kStageCols;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = dq + 2 * i, q = qq + 4 * (2 * e + j);
        float tail = 0.0f;
        for (int c = full; c < dims; ++c)
          tail = fma_z(Dl[d * kPitch + c - cl], Ql[q * kPitch + c - cl], tail);
        dot[i][j] = full ? add_z(dot[i][j], tail) : tail;
      }
    __syncthreads();  // the tails and windows read; dss_s whole
    float* O = docs(g);  // [64 queries][kOutPitch], over the stage just read
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = dq + 2 * i, q = qq + 4 * (2 * e + j);
        O[q * kOutPitch + d] =
            masked_score(kind, mesh, has_thr, thr, dot[i][j], dss_s[d],
                         qss_s[q], sd_s[d], sq_s[q], 0.0f, keep_s[d] != 0);
      }
    __syncthreads();
    const int c4 = 4 * (t & 15);
    for (int r = t >> 4; r < kTileQueries && q0 + r < b; r += kThreads / 16)
      if (d0 + c4 < n)
        *reinterpret_cast<float4*>(out + (long long)(q0 + r) * n + d0 + c4) =
            *reinterpret_cast<const float4*>(O + r * kOutPitch + c4);
  }
  cp_async_wait<0>();
}

// Persistent blocks over tiles of 32 documents x kQ queries (tile k:
// documents (k / n_qchunks) * 32, queries (k % n_qchunks) * kQ); kQ 1 for
// one query, else 8.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
knn_row_kernel(const float* __restrict__ vectors, long long n, int dims,
               const float* __restrict__ queries, int b,
               const uint8_t* __restrict__ ok, int kind, int mesh,
               int has_thr, float thr, const float* __restrict__ qss,
               float* __restrict__ out, int n_qchunks, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStageFloats = (kRowDocs + kQ) * kPitch;
  constexpr int kSums = kRowDocs + kQ * kRowDocs;
  float* ws = smem + kStages * kStageFloats;  // [kSums][4] window sums
  float* sums = ws + kSums * 4;     // [32] dss, then [kQ][32] d2 a pair
  float* qss_s = sums + kSums;      // [kQ]
  float* O = qss_s + kQ;            // [kQ][32] scores
  int* keep_s = (int*)(O + kQ * kRowDocs);  // [32]
  const int t = threadIdx.x;
  const bool norms = kind == kCosine || (mesh && kind == kL2);
  const bool dist = !mesh && kind == kL2;   // a squared distance a pair
  const bool dots = mesh || kind != kL2;
  const long long n_tiles = ((n + kRowDocs - 1) / kRowDocs) * n_qchunks;
  const Ring ring(dims, n_tiles);
  const int S = ring.S;
  const int full = dims & ~7;
  const Windows win(dims);

  auto docs = [&](long long g) {
    return smem + (int)(g % kStages) * kStageFloats;
  };
  auto qrys = [&](long long g) { return docs(g) + kRowDocs * kPitch; };
  auto stage = [&](long long g, bool fix) {
    const long long tile = ring.tile(g);
    const int c0 = (int)(g % S) * kStageCols;
    const int cols = dims - c0 < kStageCols ? dims - c0 : kStageCols;
    stage_rows(docs(g), vectors, (tile / n_qchunks) * kRowDocs, kRowDocs, n,
               dims, c0, cols, vec, fix);
    if (!fix)
      stage_rows(qrys(g), queries, (tile % n_qchunks) * kQ, kQ, b, dims, c0,
                 cols, vec, false);
  };
  auto load = [&](long long g) {
    if (g < ring.G) stage(g, false);
    cp_async_commit();
  };
  load(0);
  load(1);

  // lane j of document d for each of the tile's queries
  const int d = t >> 3, j = t & 7;
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.0f;
  WindowFold fold_sq, fold_d2;   // document t < 32; pair t (q = t / 32)

  for (long long g = 0; g < ring.G; ++g) {
    const int s = (int)(g % S);
    const long long tile = ring.tile(g);
    const long long d0 = (tile / n_qchunks) * kRowDocs;
    const int q0 = (int)(tile % n_qchunks) * kQ;
    const int nq = b - q0 < kQ ? b - q0 : kQ;
    // the windows a stage: (document, window) for the squares, then
    // (query, document, window) for the squared distances
    const int sq_tasks = norms ? kRowDocs * 4 : 0;
    const int tasks = sq_tasks + (dist ? nq * kRowDocs * 4 : 0);
    cp_async_wait<1>();
    if (mesh) stage(g, true);
    __syncthreads();
    if (s == 0) {
      if (t < kRowDocs)
        keep_s[t] = keep_doc(vectors, n, dims, ok, mesh, d0 + t);
      if (t < kQ) qss_s[t] = norms && t < nq ? qss[q0 + t] : 0.0f;
    }
    for (int id = t; id < tasks; id += kThreads) {
      const bool sq = id < sq_tasks;
      const int x = sq ? id : id - sq_tasks;
      const int k = x & 3, dd = (x >> 2) & (kRowDocs - 1), q = x >> 7;
      const int w = 4 * s + k;
      if (w >= win.nw) continue;
      const int c0 = s * kStageCols;
      float* cx = docs(g) + dd * kPitch;
      const float* px = docs(g + kStages - 1) + dd * kPitch;
      if (sq)
        ws[dd * 4 + k] = window_sum<false>(w, win, dims, c0, cx, px, nullptr,
                                           nullptr, false);
      else
        ws[(kRowDocs + q * kRowDocs + dd) * 4 + k] = window_sum<true>(
            w, win, dims, c0, cx, px, qrys(g) + q * kPitch,
            qrys(g + kStages - 1) + q * kPitch, false);
    }
    __syncthreads();
    load(g + 2);
    for (int k = 0; k < 4 && 4 * s + k < win.nw; ++k) {
      if (norms && t < kRowDocs) fold_sq.push(ws[t * 4 + k], 4 * s + k, win);
      if (dist && (t >> 5) < nq)
        fold_d2.push(ws[(kRowDocs + t) * 4 + k], 4 * s + k, win);
    }
    if (dots) {
      const float* D = docs(g) + d * kPitch + j;
      const float* Q = qrys(g) + j;
      const int cols = full - s * kStageCols;
      const int steps = (cols < kStageCols ? cols : kStageCols) / 8;
      for (int ks = 0; ks < steps; ++ks) {
        const float x = D[8 * ks];
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          acc[q] = fma_z(x, Q[q * kPitch + 8 * ks], acc[q]);
      }
    }
    if (s != S - 1) continue;

    // the tile's scores
    if (norms && t < kRowDocs) sums[t] = fold_sq.sum;
    if (dist && (t >> 5) < nq) sums[kRowDocs + t] = fold_d2.sum;
    fold_sq = fold_d2 = WindowFold();
    // the tree ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)); query j's is kept
    float tree = 0.0f;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float v = acc[q];
      v = add_z(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = add_z(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = add_z(v, __shfl_xor_sync(0xffffffffu, v, 4));
      if (q == j) tree = v;
      acc[q] = 0.0f;
    }
    float dot = 0.0f;
    if (j < nq) {
      const float* Dl = docs(g);
      const float* Ql = qrys(g);
      const int cl = s * kStageCols;
      float tail = 0.0f;
      if (dots)
        for (int c = full; c < dims; ++c)
          tail = fma_z(Dl[d * kPitch + c - cl], Ql[j * kPitch + c - cl], tail);
      dot = full ? add_z(tree, tail) : tail;
    }
    __syncthreads();  // sums
    if (j < nq)
      O[j * kRowDocs + d] = masked_score(
          kind, mesh, has_thr, thr, dot, sums[d], qss_s[j], sqrt_z(sums[d]),
          sqrt_z(qss_s[j]), sums[kRowDocs + j * kRowDocs + d],
          keep_s[d] != 0);
    __syncthreads();
    const int q = t >> 5, dd = t & (kRowDocs - 1);
    if (q < nq && d0 + dd < n)
      out[(long long)(q0 + q) * n + d0 + dd] = O[q * kRowDocs + dd];
  }
  cp_async_wait<0>();
}

// instances (es_knn_plan): the tile kernel; the row kernel at 8 and at 1
// query a tile
int instance_of(int b, int kind, int mesh) {
  if (b >= 8 && (mesh || kind != kL2)) return kTile;
  return b == 1 ? kRow1 : kRow;
}

int tile_docs(int instance) {
  return instance == kTile ? kTileDocs : kRowDocs;
}

int tile_queries(int instance) {
  return instance == kTile ? kTileQueries
                           : instance == kRow ? kRowQueries : 1;
}

int smem_of(int instance) {
  if (instance == kTile)
    return (kStages * (kTileDocs + kTileQueries) * kPitch + kTileDocs * 4 +
            2 * (kTileDocs + kTileQueries)) * (int)sizeof(float) +
           kTileDocs * (int)sizeof(int);
  const int q = tile_queries(instance);
  const int sums = kRowDocs + q * kRowDocs;
  return (kStages * (kRowDocs + q) * kPitch + sums * 5 + q + q * kRowDocs) *
             (int)sizeof(float) +
         kRowDocs * (int)sizeof(int);
}

typedef void (*KnnKernel)(const float*, long long, int, const float*, int,
                          const uint8_t*, int, int, int, float, const float*,
                          float*, int, int);

KnnKernel kernel_of(int instance) {
  if (instance == kTile) return knn_tile_kernel;
  return instance == kRow ? knn_row_kernel<kRowQueries> : knn_row_kernel<1>;
}

cudaError_t allow_smem(int instance) {
  const int smem = smem_of(instance);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_of(instance),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Blocks of an instance resident on one SM (-1 when it cannot say).
int blocks_per_sm(int instance) {
  if (allow_smem(instance) != cudaSuccess) return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel_of(instance), kThreads, smem_of(instance)) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// The blocks of an instance resident on the current device, found once a
// device (the persistent grid's size).
cudaError_t resident_blocks(int instance, long long* out) {
  constexpr int kDevices = 64;
  static long long cached[kDevices][3];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev][instance] > 0) {
    *out = cached[dev][instance];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int per_sm = blocks_per_sm(instance);
  if (per_sm < 1) return cudaErrorInvalidValue;
  *out = (long long)sms * per_sm;
  if (dev < kDevices) cached[dev][instance] = *out;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch of b queries against n rows: plan[0..5] = its instance,
// tile (documents, queries), dynamic shared memory, tiles and blocks (the
// persistent grid: at most the blocks resident on the current device).
// Returns a cudaError.
int es_knn_plan(long long n, int b, int kind, int mesh, long long* plan) {
  const int inst = instance_of(b, kind, mesh);
  const long long tiles = ((n + tile_docs(inst) - 1) / tile_docs(inst)) *
                          ((b + tile_queries(inst) - 1) / tile_queries(inst));
  long long resident = 0;
  const cudaError_t err = resident_blocks(inst, &resident);
  if (err != cudaSuccess) return (int)err;
  plan[0] = inst;
  plan[1] = tile_docs(inst);
  plan[2] = tile_queries(inst);
  plan[3] = smem_of(inst);
  plan[4] = tiles;
  plan[5] = tiles < resident ? tiles : resident;
  return 0;
}

// scores f32[b, n] of queries f32[b, dims] against vectors f32[n, dims]
// (ok: u8[n] or null) on `stream`; qss: f32[b] scratch for the queries'
// sums of squares (cosine, and the mesh formula's l2_norm).
int es_knn_scores(const void* vectors, long long n, int dims,
                  const void* queries, int b, const void* ok, int kind,
                  int mesh, int has_thr, float thr, void* qss, void* out,
                  void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (dims < 1 || dims > kMaxDims) return (int)cudaErrorInvalidValue;
  const bool norms = kind == kCosine || (mesh && kind == kL2);
  if (norms && qss == nullptr) return (int)cudaErrorInvalidValue;
  long long plan[6];
  int err = es_knn_plan(n, b, kind, mesh, plan);
  if (err != 0) return err;
  const int inst = (int)plan[0];
  const int vec = dims % 4 == 0 && (uintptr_t)vectors % 16 == 0 &&
                  (uintptr_t)queries % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (norms) {
    knn_qss_kernel<<<(b + 3) / 4, 128, 0, st>>>(
        (const float*)queries, b, dims, (float*)qss);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const KnnKernel k = kernel_of(inst);
  k<<<(unsigned)plan[5], kThreads, smem_of(inst), st>>>(
      (const float*)vectors, n, dims, (const float*)queries, b,
      (const uint8_t*)ok, kind, mesh, has_thr, thr, (const float*)qss,
      (float*)out, (b + (int)plan[2] - 1) / (int)plan[2], vec);
  return (int)cudaGetLastError();
}

// Blocks of an instance resident on one SM of the current device.
int es_knn_blocks_per_sm(int instance) { return blocks_per_sm(instance); }

const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
