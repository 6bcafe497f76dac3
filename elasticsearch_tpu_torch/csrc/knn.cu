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
// the order of every sum, so each thread computes the whole ordered chain
// of its (document, query) pairs:
//   - the dot product is XLA:CPU's gemv: eight lane accumulators, lane j a
//     fused multiply-add chain over columns j, j+8, ... up to the last
//     multiple of 8, the lanes added ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)),
//     then the tail's chain from 0 over the remaining columns, added last;
//   - a norm or a squared distance is XLA:CPU's row sum: windows of 32
//     (zero-padded, the pad split pad / 2 low, the rest high), each summed
//     left to right from 0, the window sums reduced the same way;
//   - sqrt and division correctly rounded (__fsqrt_rn, __fdiv_rn), every
//     other step __fadd_rn / __fmul_rn / __fmaf_rn, and -fmad=false so that
//     nothing else is contracted;
//   - XLA:CPU runs with FTZ and DAZ: every operand read and every result is
//     flushed to a zero of its sign (ftz() below), explicitly, so that the
//     build's own denormal mode does not matter.
// Tensor cores, TF32 and cuBLAS cannot give these bits: they sum in tiles
// of their own order (and TF32 drops 13 mantissa bits).
//
// Design. A block takes 128 documents (a thread each) and a chunk of QB
// queries (8, or 1 for fewer than 8), staged in shared memory with their
// sums of squares; the grid walks the query chunks fastest, so the blocks
// that read one document tile run together and share it through L2. A
// thread reads its document's row once for the QB queries' gemv chains
// (8 x QB accumulators in registers), once more for its norm, and once a
// query for a squared distance.
//
// What bounds it on an H100. The work is 2 * B * N * dims operations in
// FP32 outside the tensor cores (67 TFLOP/s) against N * dims * 4 bytes of
// vectors read once and B * N * 4 bytes of scores written (3.35 TB/s): at
// B = 64, dims = 768 the operations bound it. This simple kernel adds a
// flush check to every step and reads each row from L2 once a query chunk;
// double-buffered tiles of rows (cp.async or TMA) shared by a block and
// register blocking over more queries are later work.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // documents a block
constexpr int kMaxDims = 4096;  // the mapping's dims limit, knn_kernel.MAX_DIMS
constexpr int kMaxWindows = kMaxDims / 32;    // first-level window sums
constexpr float kMinNorm = 1.17549435e-38f;   // FLT_MIN

// kinds (knn_kernel.KINDS' order)
constexpr int kL2 = 0;
constexpr int kDot = 1;
constexpr int kCosine = 2;

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kMinNorm ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ float add(float a, float b) {
  return ftz(__fadd_rn(a, b));
}
__device__ __forceinline__ float sub(float a, float b) {
  return ftz(__fsub_rn(a, b));
}
__device__ __forceinline__ float mul(float a, float b) {
  return ftz(__fmul_rn(a, b));
}
__device__ __forceinline__ float dv(float a, float b) {
  return ftz(__fdiv_rn(a, b));
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return ftz(__fmaf_rn(a, b, c));
}
// jnp.maximum(x, lo): a NaN x stays NaN
__device__ __forceinline__ float nan_max(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// XLA:CPU's row sum of f(0), ..., f(K - 1) (K <= kMaxDims).
template <typename F>
__device__ float xla_row_sum(int K, F f) {
  if (K <= 32) {
    float acc = 0.0f;
    for (int i = 0; i < K; ++i) acc = add(acc, f(i));
    return acc;
  }
  float ws[kMaxWindows];
  int nw = (K + 31) / 32;
  int lo = (nw * 32 - K) / 2;
  for (int w = 0; w < nw; ++w) {
    float acc = 0.0f;
    for (int i = 0; i < 32; ++i) {
      const int p = w * 32 + i - lo;
      acc = add(acc, (p >= 0 && p < K) ? f(p) : 0.0f);
    }
    ws[w] = acc;
  }
  K = nw;
  while (K > 32) {  // window w reads entries past w: in place is safe
    nw = (K + 31) / 32;
    lo = (nw * 32 - K) / 2;
    for (int w = 0; w < nw; ++w) {
      float acc = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int p = w * 32 + i - lo;
        acc = add(acc, (p >= 0 && p < K) ? ws[p] : 0.0f);
      }
      ws[w] = acc;
    }
    K = nw;
  }
  float acc = 0.0f;
  for (int i = 0; i < K; ++i) acc = add(acc, ws[i]);
  return acc;
}

// One block: documents [tile * 128, +128) against queries [qc * QB, +QB).
// mesh = 0: the per-segment scores (knn.py::_similarity_scores), masked by
// NaN raw values, `ok` and the `similarity` threshold (raw >= thr). mesh =
// 1: the mesh step's formulas over nan_to_num'd vectors, masked by a NaN
// first component and `ok`. Masked scores are -inf.
template <int QB>
__global__ void __launch_bounds__(kThreads)
knn_scores_kernel(const float* __restrict__ vectors, long long n, int dims,
                  const float* __restrict__ queries, int b,
                  const uint8_t* __restrict__ ok, int kind, int mesh,
                  int has_thr, float thr, float* __restrict__ out,
                  int n_qchunks) {
  extern __shared__ float sq[];  // QB * dims query values, QB sums
  float* qss = sq + QB * dims;
  const int qc = (int)(blockIdx.x % n_qchunks);
  const long long tile = blockIdx.x / n_qchunks;
  const int q0 = qc * QB;
  const int nq = min(QB, b - q0);
  for (int i = threadIdx.x; i < QB * dims; i += kThreads)
    sq[i] = i < nq * dims ? ftz(queries[(long long)q0 * dims + i]) : 0.0f;
  __syncthreads();
  const bool need_norms = mesh || kind == kCosine;
  if (need_norms && threadIdx.x < nq) {
    const float* qv = sq + threadIdx.x * dims;
    qss[threadIdx.x] =
        xla_row_sum(dims, [&](int c) { return mul(qv[c], qv[c]); });
  }
  __syncthreads();
  const long long doc = tile * kThreads + threadIdx.x;
  if (doc >= n) return;
  const float* row = vectors + doc * dims;
  auto load = [&](int c) -> float {
    float x = row[c];
    if (mesh) x = isnan(x) ? 0.0f : (isinf(x) ? copysignf(FLT_MAX, x) : x);
    return ftz(x);
  };
  bool keep = ok == nullptr || ok[doc] != 0;
  if (mesh) keep = keep && !isnan(row[0]);

  float dots[QB] = {};
  if (mesh || kind != kL2) {
    const int full = dims & ~7;
    float lanes[QB][8];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi)
#pragma unroll
      for (int j = 0; j < 8; ++j) lanes[qi][j] = 0.0f;
    for (int c = 0; c < full; c += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = load(c + j);
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        const float* qv = sq + qi * dims + c;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          lanes[qi][j] = fma_(v[j], qv[j], lanes[qi][j]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) {
      const float* qv = sq + qi * dims;
      float tail = 0.0f;
      for (int c = full; c < dims; ++c) tail = fma_(load(c), qv[c], tail);
      if (full == 0) {
        dots[qi] = tail;
      } else {
        const float tree =
            add(add(add(lanes[qi][0], lanes[qi][1]),
                    add(lanes[qi][2], lanes[qi][3])),
                add(add(lanes[qi][4], lanes[qi][5]),
                    add(lanes[qi][6], lanes[qi][7])));
        dots[qi] = add(tree, tail);
      }
    }
  }
  float dss = 0.0f;  // the document's sum of squares
  if (need_norms)
    dss = xla_row_sum(dims, [&](int c) {
      const float x = load(c);
      return mul(x, x);
    });

#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    if (qi >= nq) break;
    const float* qv = sq + qi * dims;
    float score;
    bool k2 = keep;
    if (!mesh) {
      float raw;
      if (kind == kL2) {
        const float d2 = xla_row_sum(dims, [&](int c) {
          const float d = sub(load(c), qv[c]);
          return mul(d, d);
        });
        raw = -__fsqrt_rn(d2);
        score = dv(1.0f, add(1.0f, d2));
      } else if (kind == kDot) {
        raw = dots[qi];
        score = dv(add(1.0f, raw), 2.0f);
      } else {
        const float den =
            nan_max(mul(__fsqrt_rn(dss), __fsqrt_rn(qss[qi])), 1e-12f);
        raw = dv(dots[qi], den);
        score = dv(add(1.0f, raw), 2.0f);
      }
      k2 = k2 && !isnan(raw);
      if (has_thr) k2 = k2 && raw >= thr;
    } else if (kind == kL2) {
      // ||d||^2 - 2 d.q + ||q||^2, clamped at 0
      const float d2 = add(sub(dss, mul(2.0f, dots[qi])), qss[qi]);
      score = dv(1.0f, add(1.0f, nan_max(d2, 0.0f)));
    } else if (kind == kDot) {
      score = dv(add(1.0f, dots[qi]), 2.0f);
    } else {
      const float den =
          nan_max(mul(__fsqrt_rn(qss[qi]), __fsqrt_rn(dss)), 1e-12f);
      score = dv(add(1.0f, dv(dots[qi], den)), 2.0f);
    }
    out[(long long)(q0 + qi) * n + doc] = k2 ? score : -INFINITY;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch with QB queries a block.
int es_knn_smem(int qb, int dims) {
  return (qb * dims + qb) * (int)sizeof(float);
}

// scores f32[b, n] of queries f32[b, dims] against vectors f32[n, dims]
// (ok: u8[n] or null) on `stream`; qb is 8 or 1.
int es_knn_scores(const void* vectors, long long n, int dims,
                  const void* queries, int b, const void* ok, int kind,
                  int mesh, int has_thr, float thr, void* out, int qb,
                  void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (dims < 1 || dims > kMaxDims) return (int)cudaErrorInvalidValue;
  const int QB = qb == 8 ? 8 : 1;
  const long long tiles = (n + kThreads - 1) / kThreads;
  const int nqc = (b + QB - 1) / QB;
  const long long blocks = tiles * nqc;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = es_knn_smem(QB, dims);
  auto k = QB == 8 ? &knn_scores_kernel<8> : &knn_scores_kernel<1>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  k<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)vectors, n, dims, (const float*)queries, b,
      (const uint8_t*)ok, kind, mesh, has_thr, thr, (float*)out, nqc);
  return (int)cudaGetLastError();
}

// Blocks of a launch resident on one SM of the current device.
int es_knn_blocks_per_sm(int qb, int dims) {
  const int smem = es_knn_smem(qb == 8 ? 8 : 1, dims);
  auto k = qb == 8 ? &knn_scores_kernel<8> : &knn_scores_kernel<1>;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
