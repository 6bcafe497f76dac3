// The aggregation kernels: masked bucket counts, masked column stats and
// per-ordinal column stats over a segment's doc-value columns, in XLA:CPU's
// arithmetic.
//
// Replaces: elasticsearch_tpu/search/aggregations/device.py's six jitted
// scatter and reduce functions. The plain torch versions are in
// elasticsearch_tpu_torch/ops/agg_kernel.py, which also states the XLA:CPU
// facts these kernels reproduce:
//
//   K1 agg_bucket_counts (_terms_counts_fn, _ord_presence_fn,
//      _histo_counts_fn, _bounded_bucket_fn): a doc's bucket is its ordinal,
//      floor((v - base) / interval), or the index of the last boundary <= v;
//      counts int64[n_out] (or presence int32[n_out]). Integer counts have
//      the same bits in any order: a block counts into shared memory while
//      n_out fits there (`privatized`), else straight into device memory.
//   K2 agg_masked_stats (_stats_fn): count, sum, min and max of a column
//      under a mask. The sum keeps XLA:CPU's association: windows of 32
//      (zero-padded, pad / 2 low and the rest high), each summed left to
//      right from 0, the window sums reduced again the same way until at
//      most 32 are left, those summed left to right from 0. A thread a
//      window, a launch a level. min and max are order-free (IEEE minimum
//      and maximum: -0 below +0) and go through 64-bit atomics on keys
//      that order doubles as integers.
//   K3 agg_ord_stats (_terms_metric_fn): per ordinal, the count, sum, min
//      and max of a column under a mask. XLA:CPU's scatter-add adds in doc
//      order, so each ordinal's sum is one chain in doc order from 0: the
//      docs are grouped by ordinal with a stable counting sort (a thread a
//      chunk of docs counts, then places, its docs in order), and a warp
//      an ordinal walks its group, its loads tiles ahead of its adds.
//
// Every double is read as XLA:CPU reads it under DAZ (a subnormal is a zero
// of its sign) and every sum or quotient is flushed under FTZ (a subnormal
// result becomes a zero of its sign): the card has no such mode for f64,
// so daz() and ftz() do it. -fmad=false: nothing is contracted.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMissingI64 = (long long)0x8000000000000000ULL;
enum { kTerms = 0, kPresence = 1, kHisto = 2, kBounded = 3 };
enum { kOrd = 0, kI64 = 1, kF64 = 2 };

__device__ __forceinline__ double flush64(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}
// an operand under DAZ, a result under FTZ: the same rule on each side
__device__ __forceinline__ double daz(double x) { return flush64(x); }
__device__ __forceinline__ double ftz(double x) { return flush64(x); }

// doubles ordered as signed integers (-0 below +0; no NaN reaches these)
__device__ __forceinline__ long long order_key(double x) {
  long long b;
  memcpy(&b, &x, 8);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}
__device__ __forceinline__ double key_value(long long k) {
  const long long b = k >= 0 ? k : k ^ 0x7fffffffffffffffLL;
  double x;
  memcpy(&x, &b, 8);
  return x;
}
__device__ __forceinline__ double min_total(double a, double b) {
  return order_key(b) < order_key(a) ? b : a;
}
__device__ __forceinline__ double max_total(double a, double b) {
  return order_key(b) > order_key(a) ? b : a;
}

// A numeric column's value at i as the reference reads it (`ok` false where
// it is missing: MISSING_I64, or NaN in an f64 column).
__device__ __forceinline__ double column_value(int kind, const void* col,
                                               long long i, bool* ok) {
  if (kind == kI64) {
    const long long x = ((const long long*)col)[i];
    *ok = x != kMissingI64;
    return (double)x;
  }
  const double v = ((const double*)col)[i];
  *ok = !isnan(v);
  return daz(v);
}

// K1: doc i's bucket, or -1 where it counts nowhere.
__device__ __forceinline__ long long bucket_of(
    int mode, int kind, const void* col, const uint8_t* mask, long long i,
    double base, double interval, const double* bounds, int n_out) {
  if (!mask[i]) return -1;
  if (kind == kOrd) {
    const int o = ((const int*)col)[i];
    return o >= 0 && o < n_out ? o : -1;
  }
  bool ok;
  const double v = column_value(kind, col, i, &ok);
  if (!ok) return -1;
  if (mode == kHisto) {
    const double f = floor(ftz(ftz(v - base) / interval));
    // XLA's f64 -> s64 convert: NaN -> 0, out of range saturated (and so
    // dropped by the range check)
    if (isnan(f)) return 0;
    return f >= 0.0 && f < (double)n_out ? (long long)f : -1;
  }
  // bounded: jnp.searchsorted(bounds, v, side="right") - 1; NaN sorts last
  if (isnan(v)) return n_out - 1;
  int lo = 0, hi = n_out;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bounds[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

__global__ void __launch_bounds__(kThreads) bucket_counts_kernel(
    int mode, int kind, const void* col, const uint8_t* mask, long long n,
    double base, double interval, const double* bounds, int n_out,
    int privatized, unsigned long long* counts, int* presence) {
  extern __shared__ unsigned int bins[];
  if (privatized) {
    for (int k = threadIdx.x; k < n_out; k += blockDim.x) bins[k] = 0;
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long b = bucket_of(mode, kind, col, mask, i, base, interval,
                                  bounds, n_out);
    if (b < 0) continue;
    if (privatized) {
      if (mode == kPresence) bins[b] = 1; else atomicAdd(&bins[b], 1u);
    } else if (mode == kPresence) {
      presence[b] = 1;
    } else {
      atomicAdd(&counts[b], 1ULL);
    }
  }
  if (privatized) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_out; k += blockDim.x) {
      const unsigned int c = bins[k];
      if (c == 0) continue;
      if (mode == kPresence) presence[k] = 1;
      else atomicAdd(&counts[k], (unsigned long long)c);
    }
  }
}

// K2, level 1: thread w sums window w of the masked column (padded
// positions 32w .. 32w + 31, `lo_pad` zeros before the first value) from
// 0, and the block's count, min and max go to `acc` by atomics.
__global__ void __launch_bounds__(kThreads) stats_first_level_kernel(
    int kind, const void* col, const uint8_t* mask, long long n,
    long long n_windows, long long lo_pad, double* sums,
    unsigned long long* count, long long* min_key, long long* max_key) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long cnt = 0;
  double mn = INFINITY, mx = -INFINITY;
  if (w < n_windows) {
    double acc = 0.0;
    for (int j = 0; j < 32; ++j) {
      const long long p = w * 32 + j - lo_pad;
      if (p < 0 || p >= n || !mask[p]) continue;
      bool ok;
      const double v = column_value(kind, col, p, &ok);
      if (!ok) continue;
      acc = ftz(acc + v);
      ++cnt;
      mn = min_total(mn, v);
      mx = max_total(mx, v);
    }
    sums[w] = acc;
  }
  for (int d = 16; d > 0; d >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
    mn = min_total(mn, __shfl_xor_sync(0xffffffffu, mn, d));
    mx = max_total(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  }
  if ((threadIdx.x & 31) == 0 && cnt) {
    atomicAdd(count, cnt);
    atomicMin(min_key, order_key(mn));
    atomicMax(max_key, order_key(mx));
  }
}

// K2, a later level: thread w sums window w of `in` (n values, `lo_pad`
// zeros before the first) from 0.
__global__ void __launch_bounds__(kThreads) stats_level_kernel(
    const double* in, long long n, long long n_windows, long long lo_pad,
    double* out) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_windows) return;
  double acc = 0.0;
  for (int j = 0; j < 32; ++j) {
    const long long p = w * 32 + j - lo_pad;
    if (p >= 0 && p < n) acc = ftz(acc + in[p]);
  }
  out[w] = acc;
}

// K2, the last level: at most 32 sums left to right from 0, and the
// results in place: out[0] sum, out[1] min, out[2] max.
__global__ void stats_finish_kernel(const double* in, long long n,
                                    const long long* min_key,
                                    const long long* max_key, double* out) {
  if (threadIdx.x != 0) return;
  double acc = 0.0;
  for (long long p = 0; p < n; ++p) acc = ftz(acc + in[p]);
  out[0] = acc;
  out[1] = key_value(*min_key);
  out[2] = key_value(*max_key);
}

__global__ void set_keys_kernel(long long* min_key, long long* max_key) {
  if (threadIdx.x != 0) return;
  *min_key = order_key(INFINITY);
  *max_key = order_key(-INFINITY);
}

// K3: doc i's ordinal where it counts (mask, a value, an ordinal below
// n_out), else -1.
__device__ __forceinline__ int counted_ord(int kind, const int* ords,
                                           const void* col,
                                           const uint8_t* mask, long long i,
                                           int n_out, double* v) {
  if (!mask[i]) return -1;
  const int o = ords[i];
  if (o < 0 || o >= n_out) return -1;
  bool ok;
  *v = column_value(kind, col, i, &ok);
  return ok ? o : -1;
}

// K3, count: thread c counts chunk c's docs per ordinal into its row of
// `table` (int32[n_chunks, n_out], zeroed).
__global__ void __launch_bounds__(kThreads) ord_chunk_count_kernel(
    int kind, const int* ords, const void* col, const uint8_t* mask,
    long long n, long long chunk, long long n_chunks, int n_out, int* table) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  int* row = table + c * n_out;
  const long long end = min(n, (c + 1) * chunk);
  for (long long i = c * chunk; i < end; ++i) {
    double v;
    const int o = counted_ord(kind, ords, col, mask, i, n_out, &v);
    if (o >= 0) ++row[o];
  }
}

// K3, offsets: block k turns ordinal k's column of `table` into each
// chunk's offset within the ordinal's group (each thread a run of
// chunks, thread 0 the runs' totals); counts[k] is the group's size.
__global__ void __launch_bounds__(kThreads) ord_column_scan_kernel(
    long long n_chunks, int n_out, int* table, long long* counts) {
  __shared__ int part[kThreads];
  const int k = blockIdx.x;
  const long long per = (n_chunks + kThreads - 1) / kThreads;
  const long long lo = min(n_chunks, (long long)threadIdx.x * per);
  const long long hi = min(n_chunks, lo + per);
  int s = 0;
  for (long long c = lo; c < hi; ++c) s += table[c * n_out + k];
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const int x = part[t];
      part[t] = run;
      run += x;
    }
    counts[k] = run;
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (long long c = lo; c < hi; ++c) {
    const int t = table[c * n_out + k];
    table[c * n_out + k] = run;
    run += t;
  }
}

// K3, group starts: the exclusive prefix sum of counts, one block (each
// thread a slice, thread 0 the slices' totals).
__global__ void __launch_bounds__(kThreads) ord_starts_kernel(
    const long long* counts, int n_out, long long* starts) {
  __shared__ long long part[kThreads];
  const int per = (n_out + kThreads - 1) / kThreads;
  const int lo = min(n_out, (int)threadIdx.x * per);
  const int hi = min(n_out, lo + per);
  long long s = 0;
  for (int k = lo; k < hi; ++k) s += counts[k];
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const long long x = part[t];
      part[t] = run;
      run += x;
    }
  }
  __syncthreads();
  long long run = part[threadIdx.x];
  for (int k = lo; k < hi; ++k) {
    starts[k] = run;
    run += counts[k];
  }
}

// K3, placement: thread c writes chunk c's values, in doc order, to their
// ordinals' groups (`table` row c: its next slot in each group).
__global__ void __launch_bounds__(kThreads) ord_place_kernel(
    int kind, const int* ords, const void* col, const uint8_t* mask,
    long long n, long long chunk, long long n_chunks, int n_out, int* table,
    const long long* starts, double* grouped) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  int* row = table + c * n_out;
  const long long end = min(n, (c + 1) * chunk);
  for (long long i = c * chunk; i < end; ++i) {
    double v;
    const int o = counted_ord(kind, ords, col, mask, i, n_out, &v);
    if (o >= 0) grouped[starts[o] + row[o]++] = v;
  }
}

// K3, chains: warp k (a block of 32) sums ordinal k's group in doc order
// from 0, and takes its min and max (+inf / -inf for an empty group). Only
// the adds depend on each other, so the chain carries nothing else. The
// lanes load the group in tiles of 32 (one coalesced load a tile), each
// lane kChainDepth tiles ahead in a ring of registers, and every lane
// walks the same chain over the values the tile's lanes broadcast
// (__shfl_sync): the loads' latency hides behind kChainDepth · 32 adds.
// min and max are order-free: each lane takes them over its own values
// (fmin / fmax, the sign of a zero result settled at the end: IEEE
// minimum, -0 below +0), then the warp combines them. The flush is not
// applied on the way but watched: a partial sum that is subnormal (rare:
// it needs cancellation) sends the warp through the chain again with
// every add flushed, which gives FTZ's bits.
constexpr int kChainDepth = 8;

__global__ void __launch_bounds__(32) ord_chain_kernel(
    const double* grouped, const long long* counts, const long long* starts,
    int n_out, double* sums, double* mins, double* maxs) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const double* g = grouped + starts[k];
  const long long len = counts[k];
  const long long tiles = (len + 31) / 32;
  double ring[kChainDepth];
#pragma unroll
  for (int d = 0; d < kChainDepth; ++d) {
    const long long p = (long long)d * 32 + lane;
    ring[d] = p < len ? g[p] : 0.0;
  }
  double acc = 0.0, mn = INFINITY, mx = -INFINITY;
  bool tiny = false, neg0 = false, pos0 = false;
  for (long long t = 0; t < tiles; t += kChainDepth) {
#pragma unroll
    for (int d = 0; d < kChainDepth; ++d) {
      const long long tile = t + d;
      if (tile >= tiles) break;
      const double mine = ring[d];
      const long long ahead = (tile + kChainDepth) * 32 + lane;
      ring[d] = ahead < len ? g[ahead] : 0.0;
      const long long left = len - tile * 32;
      if (lane < left) {   // this lane's own value: min, max, zeros
        mn = fmin(mn, mine);
        mx = fmax(mx, mine);
        const bool zero = mine == 0.0, neg = signbit(mine);
        neg0 |= zero & neg;
        pos0 |= zero & !neg;
      }
      if (left >= 32) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          acc = acc + __shfl_sync(0xffffffffu, mine, j);
          tiny |= (acc != 0.0) & (fabs(acc) < DBL_MIN);
        }
      } else {
        for (int j = 0; j < (int)left; ++j) {
          acc = acc + __shfl_sync(0xffffffffu, mine, j);
          tiny |= (acc != 0.0) & (fabs(acc) < DBL_MIN);
        }
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, d));
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  }
  neg0 = __ballot_sync(0xffffffffu, neg0) != 0;
  pos0 = __ballot_sync(0xffffffffu, pos0) != 0;
  if (tiny) {
    acc = 0.0;
    for (long long p = 0; p < len; ++p) acc = ftz(acc + g[p]);
  }
  if (lane == 0) {
    sums[k] = acc;
    mins[k] = mn == 0.0 ? (neg0 ? -0.0 : 0.0) : mn;
    maxs[k] = mx == 0.0 ? (pos0 ? 0.0 : -0.0) : mx;
  }
}

int grid_for(long long work, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  return (int)(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

int blocks_for(long long work) {
  return (int)((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// K1: counts (int64[n_out], zeroed) or presence (int32[n_out], zeroed) of
// the docs under mask (u8[n]). kind: 0 ordinals int32, 1 int64, 2 float64
// column; mode: 0 terms, 1 presence, 2 histogram (base, interval), 3
// bounded (bounds f64[n_out], ascending). privatized: count in shared
// memory (n_out * 4 bytes).
int es_agg_bucket_counts(int mode, int kind, const void* col,
                         const void* mask, long long n, double base,
                         double interval, const void* bounds, int n_out,
                         int privatized, void* counts, void* presence,
                         void* stream) {
  if (n <= 0 || n_out <= 0) return 0;
  const size_t smem = privatized ? (size_t)n_out * sizeof(unsigned int) : 0;
  bucket_counts_kernel<<<grid_for(n, 8), kThreads, smem,
                         (cudaStream_t)stream>>>(
      mode, kind, col, (const uint8_t*)mask, n, base, interval,
      (const double*)bounds, n_out, privatized,
      (unsigned long long*)counts, (int*)presence);
  return (int)cudaGetLastError();
}

// K2: out_count int64[1] (zeroed), out f64[3] (sum, min, max); scratch:
// f64 for every level's window sums (es_agg_stats_scratch doubles) and
// two int64 keys.
int es_agg_stats_scratch(long long n, long long* doubles) {
  long long total = 0;
  for (long long m = n; ; ) {
    const long long w = (m + 31) / 32;
    total += w;
    if (w <= 32) break;
    m = w;
  }
  *doubles = total;
  return 0;
}

int es_agg_masked_stats(int kind, const void* col, const void* mask,
                        long long n, void* scratch, void* keys,
                        void* out_count, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long* min_key = (long long*)keys;
  long long* max_key = min_key + 1;
  set_keys_kernel<<<1, 32, 0, st>>>(min_key, max_key);
  double* level = (double*)scratch;
  if (n <= 0) {
    stats_finish_kernel<<<1, 32, 0, st>>>(level, 0, min_key, max_key,
                                          (double*)out);
    return (int)cudaGetLastError();
  }
  long long m = n;
  long long w = (m + 31) / 32;
  stats_first_level_kernel<<<blocks_for(w), kThreads, 0, st>>>(
      kind, col, (const uint8_t*)mask, n, w, (w * 32 - m) / 2, level,
      (unsigned long long*)out_count, min_key, max_key);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  while (w > 32) {
    m = w;
    w = (m + 31) / 32;
    double* next = level + m;
    stats_level_kernel<<<blocks_for(w), kThreads, 0, st>>>(
        level, m, w, (w * 32 - m) / 2, next);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    level = next;
  }
  stats_finish_kernel<<<1, 32, 0, st>>>(level, w, min_key, max_key,
                                        (double*)out);
  return (int)cudaGetLastError();
}

// K3: counts int64[n_out], sums / mins / maxs f64[n_out] of the docs
// under mask with an ordinal (ords int32[n], -1 none) and a value. table:
// int32[n_chunks * n_out] zeroed; starts int64[n_out]; grouped f64[n].
int es_agg_ord_stats(int kind, const void* ords, const void* col,
                     const void* mask, long long n, int n_out,
                     long long chunk, long long n_chunks, void* table,
                     void* starts, void* grouped, void* counts, void* sums,
                     void* mins, void* maxs, void* stream) {
  if (n_out <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int* o = (const int*)ords;
  const uint8_t* m = (const uint8_t*)mask;
  int* t = (int*)table;
  if (n > 0) {
    ord_chunk_count_kernel<<<blocks_for(n_chunks), kThreads, 0, st>>>(
        kind, o, col, m, n, chunk, n_chunks, n_out, t);
  }
  ord_column_scan_kernel<<<n_out, kThreads, 0, st>>>(
      n > 0 ? n_chunks : 0, n_out, t, (long long*)counts);
  ord_starts_kernel<<<1, kThreads, 0, st>>>((const long long*)counts, n_out,
                                            (long long*)starts);
  if (n > 0) {
    ord_place_kernel<<<blocks_for(n_chunks), kThreads, 0, st>>>(
        kind, o, col, m, n, chunk, n_chunks, n_out, t,
        (const long long*)starts, (double*)grouped);
  }
  ord_chain_kernel<<<n_out, 32, 0, st>>>(
      (const double*)grouped, (const long long*)counts,
      (const long long*)starts, n_out, (double*)sums, (double*)mins,
      (double*)maxs);
  return (int)cudaGetLastError();
}

const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
