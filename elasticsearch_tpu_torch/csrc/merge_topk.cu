// Hopper kernels for the compressed-pack sorted-merge top-k.
//
// Replaces: elasticsearch_tpu/ops/pallas_merge.py::fused_merge_topk, whose
// body is elasticsearch_tpu/ops/sparse.py::_merge_topk_core with
// variant="compressed". The result is the same bits: scores (as u32),
// doc ids and totals. The plain torch version of the same pipeline is
// elasticsearch_tpu_torch/ops/sparse.py::merge_topk_core.
//
// Why not one block per row, as the Pallas grid has it: a row is T * L_c
// lanes (131,072 at T=32, 524,288 at T=128) and its u32 sort keys (0.5-2
// MiB) do not fit the 227 KB of shared memory of one block. So the row
// pipeline is five kernels with scratch in device memory:
//
//   1. slot_decode     grid (T, R): one slot window per block. Decodes the
//                      window's value codes, finds the slot's k-th largest
//                      lane lower bound (radix select in shared memory)
//                      and the per-128-lane group upper bounds.
//   2. row_pack        grid R: row threshold and every slot's "other terms"
//                      bound, the block-max skip, and the u32 keys
//                      (doc << 16 | code16(w * value)) of the surviving
//                      lanes, compacted: padding and skipped lanes are
//                      dropped before the sort (they never reach a
//                      result). When totals are asked for with the skip
//                      on, also the pre-skip count keys (doc << 1 | pos).
//   3. row_sort        grid R: LSD radix sort of each row's keys, 8-bit
//                      digits, stable scatter per pass (warp match +
//                      per-warp digit offsets); a pass whose digit is the
//                      same in every key of the row is skipped.
//   4. run_sum         grid R: run ends of the sorted keys, each run's
//                      quantized total with the reference's Hillis-Steele
//                      tree, clause counts, the msm filter, TotalHits, and
//                      the matching run ends as candidates in key order.
//   5. select_rescore  grid R: top kc candidates by (quantized score desc,
//                      key position asc) through a radix select, the exact
//                      f32 rescore (binary search in each slot window, rank
//                      into the residual table, the same tree over the
//                      matched contributions in slot order), and a bitonic
//                      sort on (-score, doc) in shared memory.
//
// Parity: every product is __fmul_rn and every sum __fadd_rn (and the
// build passes -fmad=false): the reference rounds w * value before it
// adds. Run sums reproduce segmented_run_sum's doubling tree per run,
// anchored at the run's last lane, so a run total never depends on lanes
// outside its run.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Per row the kernels read
// each valid posting lane twice (doc and value code, 3-4 B, in kernels 1
// and 2), write and read every surviving key once per executed sort pass
// (8 B per key per pass plus 4 B for the histogram sweep), and read the
// keys once more for the run sums. At the chip_smoke shape (16 shards x
// 128 queries, L_c = 4096, 2-5 query terms of a 1M-doc corpus: 3.8M
// valid lanes, 1.7M candidates) the least traffic, each input read once
// and each output written once, is 214 MB per batch: 0.064 ms at
// 3.35 TB/s. chip_smoke.py computes that bound from each run's own lane
// and key counts and prints it beside the measured time (1.89 ms per
// batch for the five kernels on an H100 80GB HBM3 at 700 W; PERF.md).
// The design answers the bound by moving only real lanes:
// the gather reads just the valid part of each window, padding and
// skipped lanes never enter the sort, and constant-digit passes are
// skipped. What it does not do yet: one block per row leaves rows with
// few keys latency-bound, and the rescore's binary searches are
// dependent loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 128;      // COMPRESSED_BLOCK
constexpr int kRowThreads = 1024;    // threads of the per-row kernels
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kSlotThreads = 256;    // threads of slot_decode
constexpr int kMaxSlotLanes = 4096;  // CHUNK_CAP: the widest slot window
constexpr int kStack = 16;           // tree stack (windows up to 2**15)
constexpr int kNegInfBits = (int)0xff800000u;  // -inf as f32 bits

struct Streams {
  const uint8_t* docs8;       // u8 block deltas (delta doc stream) or null
  const uint16_t* docs16;     // u16 doc ids (plain doc stream) or null
  const uint16_t* codes;      // u16 value codes
  const uint16_t* ranks;      // u16 per-term ranks
  long long n_post;
  const uint16_t* doc_bases;  // u16 per-block doc bases (delta) or null
  long long n_bases;
  const float* res_vals;      // f32 residual tables
  long long n_res;
};

struct Slots {
  const int* starts;      // [R, T]
  const int* lengths;     // [R, T]
  const float* weights;   // [R, T]
  const int* min_count;   // [R]
  const int* res_starts;  // [R, T]
  const int* res_lens;    // [R, T]
  const int* dbs;         // [R, T] or null
  const int* dlo;         // [R, T] or null
  int T;
  int max_len;
  int d_pad;
};

__device__ __forceinline__ float decode_code16(uint32_t code) {
  return __uint_as_float(code << 16);
}

__device__ __forceinline__ uint32_t code16(float x) {
  return __float_as_uint(x) >> 16;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Lane doc of the gathered window (jax.lax.dynamic_slice clamps the start
// into [0, n - width]); only called for valid lanes.
__device__ __forceinline__ int lane_doc(const Streams& s, const Slots& p,
                                        int rt, long long s_eff, int lane) {
  if (s.docs8 != nullptr) {
    const int nb_slice = p.max_len / kLaneBlock + 2;
    const long long dbs = clampll(p.dbs[rt], 0, s.n_bases - nb_slice);
    const int blk = (p.dlo[rt] + lane) / kLaneBlock;
    return (int)s.doc_bases[dbs + blk] + (int)s.docs8[s_eff + lane];
  }
  return (int)s.docs16[s_eff + lane];
}

// Random-access doc of a posting position for the rescore's binary
// search (jnp.take with fill: outside the slot window reads d_pad).
__device__ __forceinline__ int doc_at(const Streams& s, const Slots& p,
                                      int rt, long long pos) {
  if (s.docs8 != nullptr) {
    const long long jrel = pos - (long long)p.starts[rt];
    if (jrel < 0 || jrel >= (long long)p.lengths[rt]) return p.d_pad;
    long long num = (long long)p.dlo[rt] + jrel;
    long long q = num >= 0 ? num / kLaneBlock
                           : -((-num + kLaneBlock - 1) / kLaneBlock);
    const long long bidx = (long long)p.dbs[rt] + q;
    const int base = (bidx >= 0 && bidx < s.n_bases) ? s.doc_bases[bidx] : 0;
    const int dd = (pos >= 0 && pos < s.n_post) ? s.docs8[pos] : 0;
    return base + dd;
  }
  return (pos >= 0 && pos < s.n_post) ? (int)s.docs16[pos] : p.d_pad;
}

// segmented_run_sum's doubling tree evaluated at one run end, fed with
// the run's lanes from the run end backwards (leaf b = b-th lane before
// the end). Nodes pair (b, b + d) at stride d = 1, 2, 4, ...; addition is
// commutative, so only the grouping has to match, and it does.
struct TreeUp {
  float val[kStack];
  int sp = 0;
  int n = 0;
  __device__ __forceinline__ void push(float v) {
    int q = n++;
    while (q & 1) {
      v = __fadd_rn(val[--sp], v);
      q >>= 1;
    }
    val[sp++] = v;
  }
  __device__ __forceinline__ float result() const {
    float acc = val[sp - 1];
    for (int j = sp - 2; j >= 0; --j) acc = __fadd_rn(val[j], acc);
    return acc;
  }
};

// The same tree fed in the other direction: leaves arrive with b = m-1,
// m-2, ..., 0 (the matched contributions of a candidate in slot order;
// leaf b is the (m-1-b)-th). A left child waits for nothing (its right
// sibling, if any, is complete and on the stack); a right child waits.
struct TreeDown {
  float val[kStack];
  int sp = 0;
  float out = 0.0f;
  __device__ __forceinline__ void push(int b, float v, int m) {
    int q = b, s = 0;
    while (true) {
      if (q & 1) {
        val[sp++] = v;
        return;
      }
      if (((long long)(q + 1) << s) < (long long)m) {
        v = __fadd_rn(val[--sp], v);
      } else if (q == 0) {
        out = v;
        return;
      }
      ++s;
      q >>= 1;
    }
  }
};

// Exclusive block scan of one flag per thread (all threads call it);
// returns the thread's rank and writes the block total.
__device__ __forceinline__ int block_rank(bool flag, int* s_warp,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  const int rank = __popc(bal & ((1u << lane) - 1u));
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? s_warp[lane] : 0;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
      int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane < nwarps) s_warp[lane] = inc - v;
    if (lane == 31) s_warp[32] = inc;
  }
  __syncthreads();
  const int r = s_warp[warp] + rank;
  *total = s_warp[32];
  __syncthreads();
  return r;
}

// Warp-aggregated append to a shared counter (order does not matter: the
// keys are sorted next).
__device__ __forceinline__ int warp_append(bool flag, int* s_count) {
  const int lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  int base = 0;
  if (lane == 0 && bal) base = atomicAdd(s_count, __popc(bal));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(bal & ((1u << lane) - 1u));
}

// Radix select of the k-th largest u32 (1-based) among n values in
// shared memory or device memory; every thread returns it.
template <typename Load>
__device__ uint32_t radix_select(int n, int k, Load load, int* s_hist,
                                 uint32_t* s_pick) {
  uint32_t prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t v = load(i);
      if ((v & mask) == prefix) atomicAdd(&s_hist[(v >> shift) & 0xFF], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int acc = 0, d = 255;
      for (; d > 0; --d) {
        if (acc + s_hist[d] >= remaining) break;
        acc += s_hist[d];
      }
      s_pick[0] = (uint32_t)d;
      s_pick[1] = (uint32_t)(remaining - acc);
    }
    __syncthreads();
    prefix |= s_pick[0] << shift;
    mask |= 0xFFu << shift;
    remaining = (int)s_pick[1];
    __syncthreads();
  }
  return prefix;
}

// ---------------------------------------------------------------------------
// 1. slot_decode
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSlotThreads)
slot_decode_kernel(Streams s, Slots p, const uint16_t* block_max,
                   long long n_bm, const int* blk_starts, int kk,
                   float* kth_out, float* grp_ub_out, float* slot_ub_out) {
  __shared__ uint32_t s_vals[kMaxSlotLanes];
  __shared__ int s_hist[256];
  __shared__ uint32_t s_pick[2];
  __shared__ float s_max[kSlotThreads / 32];
  const int t = blockIdx.x, r = blockIdx.y;
  const int rt = r * p.T + t;
  const int len = p.lengths[rt];
  const float w = p.weights[rt];
  const int n_grp = (p.max_len + kLaneBlock - 1) / kLaneBlock;

  // group upper bounds: an unaligned 128-lane group spans two aligned
  // blocks; +1 on the code is an open bound (clamped below +inf)
  const long long bs = clampll(blk_starts[rt], 0, n_bm - (n_grp + 1));
  float local_max = 0.0f;
  for (int g = threadIdx.x; g < n_grp; g += blockDim.x) {
    uint32_t c = max((uint32_t)block_max[bs + g],
                     (uint32_t)block_max[bs + g + 1]);
    c = min(c + 1u, 0x7F80u);
    const float ub = decode_code16(c);
    const bool gv = (long long)g * kLaneBlock < (long long)len;
    const float gu = (gv && w > 0.0f) ? __fmul_rn(w, ub) : 0.0f;
    grp_ub_out[(long long)rt * n_grp + g] = gu;
    local_max = fmaxf(local_max, gu);
  }
  for (int o = 16; o > 0; o >>= 1)
    local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = local_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.0f;
    for (int i = 0; i < kSlotThreads / 32; ++i) m = fmaxf(m, s_max[i]);
    slot_ub_out[rt] = m;
  }

  if (len < kk) {  // this slot cannot set the row threshold
    if (threadIdx.x == 0) kth_out[rt] = __int_as_float(kNegInfBits);
    return;
  }
  // lane lower bounds w * decode(code) are non-negative, so their bit
  // patterns order like the values; padding lanes hold 0
  const long long s_eff = clampll(p.starts[rt], 0, s.n_post - p.max_len);
  for (int l = threadIdx.x; l < p.max_len; l += blockDim.x) {
    float v = 0.0f;
    if (l < len) v = __fmul_rn(w, decode_code16(s.codes[s_eff + l]));
    s_vals[l] = __float_as_uint(v);
  }
  __syncthreads();
  const uint32_t bits = radix_select(
      p.max_len, kk, [&](int i) { return s_vals[i]; }, s_hist, s_pick);
  if (threadIdx.x == 0) kth_out[rt] = __uint_as_float(bits);
}

// ---------------------------------------------------------------------------
// 2. row_pack
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
row_pack_kernel(Streams s, Slots p, int do_skip, int with_counts, int kk,
                const int* slot_terms, const float* kth,
                const float* grp_ub, const float* slot_ub,
                const long long* row_off, uint32_t* keys, int* n_keys,
                uint32_t* ckeys, int* n_ckeys) {
  __shared__ float s_others[kRowThreads];
  __shared__ float s_term_ub[kRowThreads];
  __shared__ float s_thr;
  __shared__ int s_count, s_ccount;
  const int r = blockIdx.x;
  const int T = p.T;
  const int n_grp = (p.max_len + kLaneBlock - 1) / kLaneBlock;
  if (threadIdx.x == 0) {
    s_count = 0;
    s_ccount = 0;
  }
  if (do_skip) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const float su = slot_ub[r * T + t];
      float tu = su;
      if (slot_terms != nullptr) {
        const int term = slot_terms[r * T + t];
        tu = 0.0f;
        for (int u = 0; u < T; ++u)
          if (slot_terms[r * T + u] == term)
            tu = fmaxf(tu, slot_ub[r * T + u]);
      }
      s_term_ub[t] = tu;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // the bound of every other term: max over a term's chunks, summed
      // over distinct terms (first chunk of each term counts)
      float total = 0.0f;
      for (int t = 0; t < T; ++t) {
        bool first = true;
        if (slot_terms != nullptr) {
          const int term = slot_terms[r * T + t];
          for (int u = 0; u < t; ++u)
            if (slot_terms[r * T + u] == term) {
              first = false;
              break;
            }
        }
        total = __fadd_rn(total, first ? s_term_ub[t] : 0.0f);
      }
      float thr = __int_as_float(kNegInfBits);
      for (int t = 0; t < T; ++t)
        if (p.lengths[r * T + t] >= kk) thr = fmaxf(thr, kth[r * T + t]);
      if (with_counts && p.min_count[r] > 1) thr = __int_as_float(kNegInfBits);
      s_thr = thr;
      s_others[0] = total;
    }
    __syncthreads();
    const float total = s_others[0];
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x)
      s_others[t] = __fsub_rn(total, s_term_ub[t]);
  }
  __syncthreads();

  const long long off = row_off[r];
  const bool want_count = ckeys != nullptr;
  for (int t = 0; t < T; ++t) {
    const int rt = r * T + t;
    const int len = p.lengths[rt];
    if (len <= 0) continue;
    const float w = p.weights[rt];
    const long long s_eff = clampll(p.starts[rt], 0, s.n_post - p.max_len);
    const float oth = do_skip ? s_others[t] : 0.0f;
    for (int base = 0; base < len; base += blockDim.x) {
      const int l = base + threadIdx.x;
      const bool in = l < len;
      int doc = p.d_pad;
      float imp = 0.0f;
      if (in) {
        doc = lane_doc(s, p, rt, s_eff, l);
        imp = __fmul_rn(w, decode_code16(s.codes[s_eff + l]));
      }
      const bool real = in && doc < p.d_pad;
      if (want_count) {
        const int at = warp_append(real, &s_ccount);
        if (real)
          ckeys[off + at] = ((uint32_t)doc << 1) | (code16(imp) > 0 ? 1u : 0u);
      }
      bool keep = real;
      if (do_skip && real) {
        const float gu = grp_ub[(long long)rt * n_grp + l / kLaneBlock];
        if (__fadd_rn(gu, oth) < s_thr) keep = false;
      }
      const int at = warp_append(keep, &s_count);
      if (keep) keys[off + at] = ((uint32_t)doc << 16) | code16(imp);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_keys[r] = s_count;
    if (want_count) n_ckeys[r] = s_ccount;
  }
}

// ---------------------------------------------------------------------------
// 3. row_sort: per-row LSD radix sort, stable scatter per pass
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
row_sort_kernel(uint32_t* keys, uint32_t* alt, const long long* row_off,
                const int* n_keys, int key_bits) {
  __shared__ int s_hist[256];
  __shared__ int s_wcnt[kRowWarps][256];
  __shared__ int s_skip;
  const int r = blockIdx.x;
  const int n = n_keys[r];
  const long long off = row_off[r];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* src = keys + off;
  uint32_t* dst = alt + off;
  for (int i = threadIdx.x; i < kRowWarps * 256; i += blockDim.x)
    (&s_wcnt[0][0])[i] = 0;
  bool in_alt = false;
  for (int shift = 0; shift < key_bits; shift += 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      atomicAdd(&s_hist[(src[i] >> shift) & 0xFF], 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int skip = 0, acc = 0;
      for (int d = 0; d < 256; ++d) {
        const int c = s_hist[d];
        if (c == n) skip = 1;
        s_hist[d] = acc;  // exclusive digit base
        acc += c;
      }
      s_skip = skip;
    }
    __syncthreads();
    if (s_skip) continue;  // digit constant over the row: order unchanged
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const bool in = i < n;
      const uint32_t key = in ? src[i] : 0u;
      const int digit = in ? (int)((key >> shift) & 0xFF) : 256 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (in && rank == 0) s_wcnt[warp][digit] = __popc(peers);
      __syncthreads();
      for (int d = threadIdx.x; d < 256; d += blockDim.x) {
        int run = s_hist[d];
        for (int w = 0; w < kRowWarps; ++w) {
          const int c = s_wcnt[w][d];
          s_wcnt[w][d] = run;
          run += c;
        }
        s_hist[d] = run;
      }
      __syncthreads();
      if (in) dst[s_wcnt[warp][digit] + rank] = key;
      __syncthreads();
      for (int j = threadIdx.x; j < kRowWarps * 256; j += blockDim.x)
        (&s_wcnt[0][0])[j] = 0;
      __syncthreads();
    }
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
    in_alt = !in_alt;
  }
  if (in_alt) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) keys[off + i] = src[i];
  }
}

// ---------------------------------------------------------------------------
// 4. run_sum
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
run_sum_kernel(const uint32_t* keys, const int* n_keys,
               const uint32_t* ckeys, const int* n_ckeys,
               const long long* row_off, const int* min_count,
               int with_counts, int window, float* cand_score,
               int* cand_doc, int* cand_cnt, int* n_cand, int* totals) {
  __shared__ int s_warp[33];
  const int r = blockIdx.x;
  const long long off = row_off[r];
  const int n = n_keys[r];
  const float mc = (float)min_count[r];
  const uint32_t* k = keys + off;
  int emitted = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool ok = false;
    float total = 0.0f;
    int doc = 0, cnt = 0;
    if (i < n) {
      doc = (int)(k[i] >> 16);
      const bool end = (i == n - 1) || ((int)(k[i + 1] >> 16) != doc);
      if (end) {
        TreeUp tree;
        for (int b = 0; b < window && i - b >= 0; ++b) {
          const uint32_t kb = k[i - b];
          if ((int)(kb >> 16) != doc) break;
          tree.push(decode_code16(kb & 0xFFFFu));
        }
        cnt = tree.n;
        total = tree.result();
        ok = total > 0.0f && (!with_counts || (float)cnt >= mc);
      }
    }
    int tile = 0;
    const int at = block_rank(ok, s_warp, &tile);
    if (ok) {
      cand_score[off + emitted + at] = total;
      cand_doc[off + emitted + at] = doc;
      cand_cnt[off + emitted + at] = cnt;
    }
    emitted += tile;
  }
  int hits = emitted;
  if (ckeys != nullptr) {
    // exact TotalHits from the pre-skip count keys: a run matches when
    // its last (largest) key carries the positive-code bit
    const uint32_t* c = ckeys + off;
    const int nc = n_ckeys[r];
    hits = 0;
    for (int base = 0; base < nc; base += blockDim.x) {
      const int i = base + threadIdx.x;
      bool ok = false;
      if (i < nc) {
        const uint32_t cdoc = c[i] >> 1;
        const bool end = (i == nc - 1) || ((c[i + 1] >> 1) != cdoc);
        if (end && (c[i] & 1u)) {
          int run = 0;
          if (with_counts)
            for (; run < window && i - run >= 0; ++run)
              if ((c[i - run] >> 1) != cdoc) break;
          ok = !with_counts || (float)run >= mc;
        }
      }
      int tile = 0;
      block_rank(ok, s_warp, &tile);
      hits += tile;
    }
  }
  if (threadIdx.x == 0) {
    n_cand[r] = emitted;
    totals[r] = hits;
  }
}

// ---------------------------------------------------------------------------
// 5. select_rescore
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
select_rescore_kernel(Streams s, Slots p, const float* cand_score,
                      const int* cand_doc, const int* cand_cnt,
                      const int* n_cand, const long long* row_off, int kc,
                      int kk, int sort_n, float* out_vals, int* out_docs) {
  extern __shared__ unsigned char s_raw[];
  float* s_neg = reinterpret_cast<float*>(s_raw);
  int* s_doc = reinterpret_cast<int*>(s_raw + sizeof(float) * sort_n);
  __shared__ int s_hist[256];
  __shared__ uint32_t s_pick[2];
  __shared__ int s_warp[33];
  __shared__ int s_count;
  const int r = blockIdx.x;
  const long long off = row_off[r];
  const int n = n_cand[r];
  const float* sc = cand_score + off;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  // candidates: the top kc run ends by (score desc, key position asc) —
  // lax.top_k's earliest-index rule; scores are positive finite f32, so
  // their bit patterns order like the values
  uint32_t tau = 0;
  int need = n;
  if (n > kc) {
    tau = radix_select(
        n, kc, [&](int i) { return __float_as_uint(sc[i]); }, s_hist, s_pick);
    need = (int)s_pick[1];  // ties at tau to take, in position order
  }
  int eq_seen = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const uint32_t bits = i < n ? __float_as_uint(sc[i]) : 0u;
    const bool gt = i < n && (n <= kc || bits > tau);
    const bool eq = i < n && n > kc && bits == tau;
    int tile = 0;
    const int eq_rank = block_rank(eq, s_warp, &tile);
    const bool take = gt || (eq && eq_seen + eq_rank < need);
    eq_seen += tile;
    const int at = warp_append(take, &s_count);
    if (take) s_doc[at] = i;
  }
  __syncthreads();
  const int n_pick = s_count;

  // exact rescore: binary search the candidate in every slot window,
  // rank -> residual table -> w * exact, the first m matches in slot
  // order summed with the run-sum tree (m = the run's clause count)
  const int T = p.T;
  for (int j = threadIdx.x; j < sort_n; j += blockDim.x) {
    if (j >= n_pick) {
      s_neg[j] = __int_as_float(0x7f800000);
      s_doc[j] = p.d_pad;
      continue;
    }
    const int ci = s_doc[j];
    const int doc = cand_doc[off + ci];
    const int m = cand_cnt[off + ci];
    TreeDown tree;
    int found = 0;
    for (int t = 0; t < T && found < m; ++t) {
      const int rt = r * T + t;
      const int len = p.lengths[rt];
      if (len <= 0) continue;
      const long long st = p.starts[rt];
      const long long end = st + len;
      long long lo = st, hi = end;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (doc_at(s, p, rt, mid) < doc) lo = mid + 1;
        else hi = mid;
      }
      if (lo >= end || doc_at(s, p, rt, lo) != doc || doc >= p.d_pad)
        continue;
      const int rank = (lo >= 0 && lo < s.n_post) ? (int)s.ranks[lo] : 0;
      float val = 0.0f;
      if (rank > 0 && rank <= p.res_lens[rt]) {
        const long long at = (long long)p.res_starts[rt] + rank - 1;
        if (at >= 0 && at < s.n_res) val = s.res_vals[at];
      }
      tree.push(m - 1 - found, __fmul_rn(p.weights[rt], val), m);
      ++found;
    }
    for (; found < m; ++found) tree.push(m - 1 - found, 0.0f, m);
    s_neg[j] = -tree.out;
    s_doc[j] = doc;
  }
  __syncthreads();

  // bitonic sort ascending on (-score, doc)
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < sort_n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const float a = s_neg[lo], b = s_neg[hi];
        const int da = s_doc[lo], db = s_doc[hi];
        const bool gt = (a > b) || (a == b && da > db);
        if (gt == up) {
          s_neg[lo] = b;
          s_neg[hi] = a;
          s_doc[lo] = db;
          s_doc[hi] = da;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    const float neg = s_neg[j];
    const bool inf = isinf(neg);
    const float v = inf ? __int_as_float(kNegInfBits) : -neg;
    out_vals[(long long)r * kk + j] = v;
    out_docs[(long long)r * kk + j] = inf ? p.d_pad : s_doc[j];
  }
}

Streams make_streams(const void* docs8, const void* docs16,
                     const void* codes, const void* ranks, long long n_post,
                     const void* doc_bases, long long n_bases,
                     const void* res_vals, long long n_res) {
  Streams s;
  s.docs8 = static_cast<const uint8_t*>(docs8);
  s.docs16 = static_cast<const uint16_t*>(docs16);
  s.codes = static_cast<const uint16_t*>(codes);
  s.ranks = static_cast<const uint16_t*>(ranks);
  s.n_post = n_post;
  s.doc_bases = static_cast<const uint16_t*>(doc_bases);
  s.n_bases = n_bases;
  s.res_vals = static_cast<const float*>(res_vals);
  s.n_res = n_res;
  return s;
}

Slots make_slots(const void* starts, const void* lengths,
                 const void* weights, const void* min_count,
                 const void* res_starts, const void* res_lens,
                 const void* dbs, const void* dlo, int T, int max_len,
                 int d_pad) {
  Slots p;
  p.starts = static_cast<const int*>(starts);
  p.lengths = static_cast<const int*>(lengths);
  p.weights = static_cast<const float*>(weights);
  p.min_count = static_cast<const int*>(min_count);
  p.res_starts = static_cast<const int*>(res_starts);
  p.res_lens = static_cast<const int*>(res_lens);
  p.dbs = static_cast<const int*>(dbs);
  p.dlo = static_cast<const int*>(dlo);
  p.T = T;
  p.max_len = max_len;
  p.d_pad = d_pad;
  return p;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes): each launches one kernel on `stream` and returns
// the cudaError_t of the launch.
// ---------------------------------------------------------------------------

extern "C" {

int es_slot_decode(const void* docs8, const void* docs16, const void* codes,
                   const void* ranks, long long n_post,
                   const void* doc_bases, long long n_bases,
                   const void* res_vals, long long n_res,
                   const void* starts, const void* lengths,
                   const void* weights, const void* min_count,
                   const void* res_starts, const void* res_lens,
                   const void* dbs, const void* dlo, int R, int T,
                   int max_len, int d_pad, const void* block_max,
                   long long n_bm, const void* blk_starts, int kk,
                   void* kth, void* grp_ub, void* slot_ub, void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  dim3 grid(T, R);
  slot_decode_kernel<<<grid, kSlotThreads, 0, (cudaStream_t)stream>>>(
      s, p, static_cast<const uint16_t*>(block_max), n_bm,
      static_cast<const int*>(blk_starts), kk, static_cast<float*>(kth),
      static_cast<float*>(grp_ub), static_cast<float*>(slot_ub));
  return (int)cudaGetLastError();
}

int es_row_pack(const void* docs8, const void* docs16, const void* codes,
                const void* ranks, long long n_post, const void* doc_bases,
                long long n_bases, const void* res_vals, long long n_res,
                const void* starts, const void* lengths, const void* weights,
                const void* min_count, const void* res_starts,
                const void* res_lens, const void* dbs, const void* dlo,
                int R, int T, int max_len, int d_pad, int do_skip,
                int with_counts, int kk, const void* slot_terms,
                const void* kth, const void* grp_ub, const void* slot_ub,
                const void* row_off, void* keys, void* n_keys, void* ckeys,
                void* n_ckeys, void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  row_pack_kernel<<<R, kRowThreads, 0, (cudaStream_t)stream>>>(
      s, p, do_skip, with_counts, kk, static_cast<const int*>(slot_terms),
      static_cast<const float*>(kth), static_cast<const float*>(grp_ub),
      static_cast<const float*>(slot_ub),
      static_cast<const long long*>(row_off), static_cast<uint32_t*>(keys),
      static_cast<int*>(n_keys), static_cast<uint32_t*>(ckeys),
      static_cast<int*>(n_ckeys));
  return (int)cudaGetLastError();
}

int es_row_sort(void* keys, void* alt, const void* row_off,
                const void* n_keys, int R, int key_bits, void* stream) {
  row_sort_kernel<<<R, kRowThreads, 0, (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(keys), static_cast<uint32_t*>(alt),
      static_cast<const long long*>(row_off),
      static_cast<const int*>(n_keys), key_bits);
  return (int)cudaGetLastError();
}

int es_run_sum(const void* keys, const void* n_keys, const void* ckeys,
               const void* n_ckeys, const void* row_off,
               const void* min_count, int R, int with_counts, int window,
               void* cand_score, void* cand_doc, void* cand_cnt,
               void* n_cand, void* totals, void* stream) {
  run_sum_kernel<<<R, kRowThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(n_keys),
      static_cast<const uint32_t*>(ckeys), static_cast<const int*>(n_ckeys),
      static_cast<const long long*>(row_off),
      static_cast<const int*>(min_count), with_counts, window,
      static_cast<float*>(cand_score), static_cast<int*>(cand_doc),
      static_cast<int*>(cand_cnt), static_cast<int*>(n_cand),
      static_cast<int*>(totals));
  return (int)cudaGetLastError();
}

int es_select_rescore(const void* docs8, const void* docs16,
                      const void* codes, const void* ranks, long long n_post,
                      const void* doc_bases, long long n_bases,
                      const void* res_vals, long long n_res,
                      const void* starts, const void* lengths,
                      const void* weights, const void* min_count,
                      const void* res_starts, const void* res_lens,
                      const void* dbs, const void* dlo, int R, int T,
                      int max_len, int d_pad, const void* cand_score,
                      const void* cand_doc, const void* cand_cnt,
                      const void* n_cand, const void* row_off, int kc,
                      int kk, int sort_n, void* out_vals, void* out_docs,
                      void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  const size_t smem = (size_t)sort_n * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      select_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  select_rescore_kernel<<<R, kRowThreads, smem, (cudaStream_t)stream>>>(
      s, p, static_cast<const float*>(cand_score),
      static_cast<const int*>(cand_doc), static_cast<const int*>(cand_cnt),
      static_cast<const int*>(n_cand),
      static_cast<const long long*>(row_off), kc, kk, sort_n,
      static_cast<float*>(out_vals), static_cast<int*>(out_docs));
  return (int)cudaGetLastError();
}

const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
