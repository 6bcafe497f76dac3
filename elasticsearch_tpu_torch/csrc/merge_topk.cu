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
//   3. row_sort        grid (R, key sets): LSD radix sort of each row's
//                      keys and count keys in one launch, 8-bit digits,
//                      stable; in shared memory when the row fits.
//   4. run_sum         grid R: run ends of the sorted keys, each run's
//                      quantized total with the reference's Hillis-Steele
//                      tree, clause counts, the msm filter, TotalHits, and
//                      the matching run ends as candidates in key order.
//   5. select_rescore  grid R: top kc candidates by (quantized score desc,
//                      key position asc) through a radix select, the exact
//                      f32 rescore (binary search in each slot window,
//                      staged in shared memory, rank into the residual
//                      table, the same tree over the matched contributions
//                      in slot order), and the top kk on (-score, doc).
//
// Parity: every product is __fmul_rn and every sum __fadd_rn (and the
// build passes -fmad=false): the reference rounds w * value before it
// adds. Run sums reproduce segmented_run_sum's doubling tree per run,
// anchored at the run's last lane, so a run total never depends on lanes
// outside its run.
//
// What bounds the pipeline on an H100 (3.35 TB/s): bytes. Per row the
// kernels read each valid posting lane twice (doc and value code, 3-4 B,
// in kernels 1 and 2), sort the surviving keys, and read them once more
// for the run sums. At the chip_smoke shape (16 shards x 128 queries,
// L_c = 4096, 2-5 query terms of a 1M-doc corpus: 3.4M valid lanes,
// 1.6M candidates) the least traffic, each input read once and each
// output written once, is under 0.1 ms per train; chip_smoke.py computes
// that bound from each run's own counts and prints it beside each
// kernel's measured time. The rows are small (1,643 keys, ~790
// candidates on average) and many (2048), so what holds a kernel back is
// latency: barriers per tile, serial scans and dependent loads from
// device memory, with too few rows in flight per SM to hide them.
//
// row_sort. One launch sorts both key sets of every row: grid (R, 1 or
// 2), the count keys in blockIdx.y = 1. A 512-thread block holds 2 x
// kSortSmemKeys keys in shared memory (64 KB; two blocks per SM). A row
// whose keys fit there (the size class "shared", decided per row from
// its n_keys on the device) is loaded once, sorted between two shared
// buffers and written once. A larger row (stop-word queries, up to T *
// 4096 keys) takes the class "device": the same passes between its key
// array and a scratch array in device memory. Each LSD pass (8-bit
// digit) is reduce-then-scan inside the block: each warp counts the
// digits of its contiguous chunk with shared atomics, one parallel scan
// over (digit, warp) turns the counts into every warp's stable offsets,
// and the warps scatter in order; four barriers per pass whatever the
// row's size, and a pass whose digit is constant is skipped. In the
// scatter a digit's lanes are found with one ballot per digit bit (not
// __match_any_sync, whose cost grows with the distinct digits of a
// warp), and one leader per digit takes the group's slots. What still
// bounds it (PERF.md): a device-class row walks its keys on one block,
// many times longer than a short row, while a short row pays four
// barriers and a scan per pass for a few hundred keys.
//
// select_rescore. 512 threads per row, dynamic shared memory sized by
// the wrapper from kk alone (32 KB, or 8 B per entry of the final sort
// when larger), reused by its three phases:
//   1. Selection of the top kc quantized candidates (lax.top_k's rule:
//      all above the kc-th score, then the earliest equal ones): the
//      scores are copied to shared memory once when they fit ("shared"
//      class, else read from device memory, "device"), then a radix
//      select with a parallel digit search.
//   2. The exact rescore, slot-major: the valid doc windows of the row's
//      slots are decoded into shared memory (u16, a u8 delta stream's
//      base plus delta decoded once per lane) - all of them at once when
//      they fit ("staged"), else in groups of consecutive slots,
//      restaged for each 512-candidate chunk ("restaged"). Each
//      candidate binary-searches the staged windows in slot order and
//      pushes w * residual into its own TreeDown, the tree of
//      segmented_run_sum, so the adds and their order are unchanged. The
//      rank and residual reads stay device-memory loads, once per match.
//   3. The final order: each rescored candidate becomes one u64 key
//      (score order bits, then 65535 - doc; the docs of a row are
//      unique, so the keys are). With more than kk of them ("trim") a
//      radix select finds the kk-th and keeps exactly kk; otherwise
//      ("all") all are kept. Only those are sorted (bitonic over the
//      next power of two of their count) and written.
// The candidate list and the rescored keys live in the row's slice of
// the sort scratch, so kc has no shared-memory cap: kernel k reaches
// 16,384 (from + size 10,000). What bounds it before: ~96 dependent
// device-memory loads per candidate (T binary searches through the u8
// decode) and a 78-stage bitonic sort of 4096 entries whatever the row
// held. What bounds it now (PERF.md): barriers (the selection's block
// scans, up to 55 bitonic stages at kk = 1024), and in the restaged
// class the windows decoded again for every chunk of 512 candidates,
// which makes a stop-word row at kk = 16,384 several ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 128;      // COMPRESSED_BLOCK
constexpr int kRowThreads = 1024;    // threads of row_pack and run_sum
constexpr int kSlotThreads = 256;    // threads of slot_decode
constexpr int kMaxSlotLanes = 4096;  // CHUNK_CAP: the widest slot window
constexpr int kStack = 16;           // tree stack (windows up to 2**15)
constexpr int kMaxSlots = 1024;      // T_LIMIT: slots per row
constexpr int kSortThreads = 512;    // threads of row_sort
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 4;        // keys per lane per round of a pass
constexpr int kSortSmemKeys = 8192;  // the "shared" class: keys per row
constexpr int kSelThreads = 512;     // threads of select_rescore

// size classes (rows per class, when the wrapper asks for them)
enum {
  kSortShared = 0, kSortDevice, kSelNone, kSelShared, kSelDevice,
  kRescoreStaged, kRescoreRestaged, kFinalAll, kFinalTrim, kNumClasses
};
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

// Exclusive block scan of one int per thread (all threads call it);
// returns the thread's prefix and writes the block total.
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < nwarps ? s_warp[lane] : 0;
    int xi = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, xi, d);
      if (lane >= d) xi += o;
    }
    if (lane < nwarps) s_warp[lane] = xi - x;
    if (lane == 31) s_warp[32] = xi;
  }
  __syncthreads();
  const int r = s_warp[warp] + inc - v;
  *total = s_warp[32];
  __syncthreads();
  return r;
}

// The digit of a 256-bin histogram that holds the `remaining`-th largest
// value: s_pick[0] = digit, s_pick[1] = its rank among the digit's values.
// A suffix scan by the first 256 threads (blockDim >= 256), no serial walk.
__device__ __forceinline__ void pick_digit(const int* s_hist, int remaining,
                                           int* s_wsum, int* s_pick) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v = 0, inc = 0;
  if (tid < 256) {
    v = s_hist[255 - tid];  // thread e holds digit 255 - e
    inc = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane == 31) s_wsum[warp] = inc;
  }
  __syncthreads();
  if (tid < 256) {
    for (int w = 0; w < warp; ++w) inc += s_wsum[w];
    const int above = inc - v;  // values in larger digits
    if (above < remaining && (remaining <= inc || tid == 255)) {
      s_pick[0] = 255 - tid;
      s_pick[1] = remaining - above;
    }
  }
  __syncthreads();
}

// Radix select of the k-th largest value (1-based) among n values in
// shared or device memory, over the 8-bit digits from `top` down to
// `bottom`; every thread returns it (the low bits below `bottom` are 0)
// and s_pick[1] holds how many values equal to it are to be taken.
template <typename U, typename Load>
__device__ U radix_select(int n, int k, Load load, int top, int bottom,
                          int* s_hist, int* s_wsum, int* s_pick) {
  U prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = top; shift >= bottom; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const U v = load(i);
      if ((v & mask) == prefix)
        atomicAdd(&s_hist[(int)((v >> shift) & 0xFF)], 1);
    }
    __syncthreads();
    pick_digit(s_hist, remaining, s_wsum, s_pick);
    prefix |= (U)s_pick[0] << shift;
    mask |= (U)0xFF << shift;
    remaining = s_pick[1];
  }
  return prefix;
}

// An f32 as a u32 whose unsigned order is the float order (-0 as +0).
__device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t order_bits_inverse(uint32_t o) {
  return (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
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
  __shared__ int s_pick[2];
  __shared__ int s_wsum[kSlotThreads / 32];
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
  const uint32_t bits = radix_select<uint32_t>(
      p.max_len, kk, [&](int i) { return s_vals[i]; }, 24, 0, s_hist,
      s_wsum, s_pick);
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
// 3. row_sort: per-row LSD radix sort of both key sets, one launch
// ---------------------------------------------------------------------------

// The lanes of the warp whose kBits-bit label equals this lane's, from
// one ballot per bit (__match_any_sync serializes over distinct values).
template <int kBits>
__device__ __forceinline__ unsigned warp_match(unsigned label) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (label >> b) & 1u;
    const unsigned v = __ballot_sync(0xffffffffu, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// One stable LSD pass of the 8-bit digit at `shift` from src to dst (n
// keys, shared or device memory), reduce-then-scan: each warp counts the
// digits of its contiguous chunk (shared atomics), a parallel scan over
// (digit, warp) turns the counts into each warp's first slot per digit,
// in place, and each warp scatters its chunk in order. Returns false,
// writing nothing, when the digit is the same in every key. s_cnt is
// all zero on entry and on return.
__device__ bool sort_pass(const uint32_t* src, uint32_t* dst, int n,
                          int shift, int (*s_cnt)[256], int* s_wsum) {
  constexpr int kRound = 32 * kSortItems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int chunk = ((n + kSortWarps - 1) / kSortWarps + kRound - 1)
                    / kRound * kRound;
  const int lo = min(warp * chunk, n), hi = min(lo + chunk, n);
  for (int base = lo; base < hi; base += kRound) {
    uint32_t key[kSortItems];
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int at = base + i * 32 + lane;
      key[i] = at < hi ? src[at] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kSortItems; ++i)  // counting needs no order
      if (base + i * 32 + lane < hi)
        atomicAdd(&s_cnt[warp][(key[i] >> shift) & 0xFF], 1);
  }
  __syncthreads();
  // thread d < 256: digit d's counts per warp become its slots: the
  // exclusive scan over digits, then over the warps of each digit
  const int d = threadIdx.x;
  int cnt[kSortWarps];
  int tot = 0;
  if (d < 256) {
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      cnt[w] = s_cnt[w][d];
      tot += cnt[w];
    }
  }
  int inc = tot;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (d < 256 && lane == 31) s_wsum[warp] = inc;
  const bool constant = __syncthreads_or(d < 256 && tot == n);
  if (d < 256) {
    int run = inc - tot;
    for (int w = 0; w < warp; ++w) run += s_wsum[w];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      s_cnt[w][d] = constant ? 0 : run;
      run += cnt[w];
    }
  }
  __syncthreads();
  if (constant) return false;  // order unchanged
  for (int base = lo; base < hi; base += kRound) {
    uint32_t key[kSortItems];
    int pos[kSortItems];
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int at = base + i * 32 + lane;
      key[i] = at < hi ? src[at] : 0u;
    }
    // the peers of every item first (out-of-range lanes share the label
    // 256 and take no slot); then, item by item, the digit's leader takes
    // the group's slots from the warp's counter and hands the first to
    // its peers: one warp barrier per item, the stores after the round
    int digit[kSortItems];
    unsigned group[kSortItems];
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      digit[i] = base + i * 32 + lane < hi ? (int)((key[i] >> shift) & 0xFF)
                                           : 256;
      group[i] = warp_match<9>(digit[i]);
    }
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const bool in = digit[i] < 256;
      const unsigned peers = group[i];
      const int leader = __ffs(peers) - 1;
      int first = 0;
      if (in && lane == leader) {
        first = s_cnt[warp][digit[i]];
        s_cnt[warp][digit[i]] = first + __popc(peers);
      }
      first = __shfl_sync(0xffffffffu, first, leader);
      pos[i] = first + __popc(peers & below);
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < kSortItems; ++i)
      if (base + i * 32 + lane < hi) dst[pos[i]] = key[i];
  }
  __syncthreads();
  if (d < 256)
    for (int w = 0; w < kSortWarps; ++w) s_cnt[w][d] = 0;
  __syncthreads();
  return true;
}

// Block (r, 0) sorts row r's keys (32 bits), block (r, 1) its pre-skip
// count keys (doc << 1 | bit: 17 bits). The size class is the row's own:
// "shared" when its keys fit kSortSmemKeys, else "device" (passes
// between the key array and `spare` in device memory).
__global__ void __launch_bounds__(kSortThreads)
row_sort_kernel(uint32_t* keys, uint32_t* alt, const int* n_keys,
                uint32_t* ckeys, uint32_t* calt, const int* n_ckeys,
                const long long* row_off, int* class_rows) {
  extern __shared__ uint32_t s_keys[];  // 2 * kSortSmemKeys
  __shared__ int s_cnt[kSortWarps][256];
  __shared__ int s_wsum[8];
  const int r = blockIdx.x;
  const bool counts = blockIdx.y == 1;
  const int n = counts ? n_ckeys[r] : n_keys[r];
  const int bits = counts ? 17 : 32;
  const long long off = row_off[r];
  uint32_t* home = (counts ? ckeys : keys) + off;
  uint32_t* spare = (counts ? calt : alt) + off;
  for (int i = threadIdx.x; i < kSortWarps * 256; i += blockDim.x)
    (&s_cnt[0][0])[i] = 0;
  const bool shared = n <= kSortSmemKeys;
  if (class_rows != nullptr && threadIdx.x == 0)
    atomicAdd(&class_rows[shared ? kSortShared : kSortDevice], 1);
  uint32_t* src = home;
  uint32_t* dst = spare;
  if (shared) {
    src = s_keys;
    dst = s_keys + kSortSmemKeys;
    for (int i = threadIdx.x; i < n; i += blockDim.x) src[i] = home[i];
  }
  __syncthreads();
  for (int shift = 0; shift < bits && n > 1; shift += 8) {
    if (sort_pass(src, dst, n, shift, s_cnt, s_wsum)) {
      uint32_t* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
  if (src != home)
    for (int i = threadIdx.x; i < n; i += blockDim.x) home[i] = src[i];
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

// Row r's slot windows [t0, t1) decoded into s_docs (u16: d_pad < 2**16),
// slot t at s_soff[t] - s_soff[t0]: exactly the docs the binary search
// reads (jnp.take with fill, as doc_at), one decode per lane.
__device__ __forceinline__ void stage_windows(const Streams& s,
                                              const Slots& p, int r, int t0,
                                              int t1, const int* s_soff,
                                              uint16_t* s_docs) {
  const int base0 = s_soff[t0];
  for (int t = t0; t < t1; ++t) {
    const int rt = r * p.T + t;
    const int len = s_soff[t + 1] - s_soff[t];
    const long long st = p.starts[rt];
    uint16_t* w = s_docs + (s_soff[t] - base0);
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      w[i] = (uint16_t)doc_at(s, p, rt, st + i);
  }
}

__global__ void __launch_bounds__(kSelThreads)
select_rescore_kernel(Streams s, Slots p, const float* cand_score,
                      const int* cand_doc, const int* cand_cnt,
                      const int* n_cand, const long long* row_off, int kc,
                      int kk, int smem_bytes, uint32_t* scr_hi,
                      uint32_t* scr_lo, float* out_vals, int* out_docs,
                      int* class_rows) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int s_hist[256];
  __shared__ int s_wsum[8];
  __shared__ int s_pick[2];
  __shared__ int s_warp[33];
  __shared__ int s_count;
  __shared__ int s_soff[kMaxSlots + 1];
  const int r = blockIdx.x;
  const int T = p.T;
  const long long off = row_off[r];
  const int n = n_cand[r];
  const float* sc = cand_score + off;
  // the row's slice of the sort scratch: the picked candidates' indices,
  // then their final keys (high word in scr_hi, low word in scr_lo)
  uint32_t* key_hi = scr_hi + off;
  uint32_t* key_lo = scr_lo + off;
  const bool count_class = class_rows != nullptr && threadIdx.x == 0;

  // 1. candidates: the top kc run ends by (score desc, key position asc),
  // lax.top_k's earliest-index rule; scores are positive finite f32, so
  // their bit patterns order like the values
  const bool select = n > kc;
  const int n_pick = select ? kc : n;
  uint32_t* s_sc = reinterpret_cast<uint32_t*>(s_raw);
  const bool sel_shared = select && n <= smem_bytes / 4;
  if (count_class)
    atomicAdd(&class_rows[!select ? kSelNone
                                  : (sel_shared ? kSelShared : kSelDevice)],
              1);
  if (select) {
    if (threadIdx.x == 0) s_count = 0;
    if (sel_shared)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        s_sc[i] = __float_as_uint(sc[i]);
    __syncthreads();
    auto score_bits = [&](int i) {
      return sel_shared ? s_sc[i] : __float_as_uint(sc[i]);
    };
    const uint32_t tau = radix_select<uint32_t>(
        n, kc, score_bits, 24, 0, s_hist, s_wsum, s_pick);
    const int need = s_pick[1];  // ties at tau to take, in position order
    int eq_seen = 0;
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const uint32_t bits = i < n ? score_bits(i) : 0u;
      const bool eq = i < n && bits == tau;
      int tile = 0;
      const int eq_rank = block_rank(eq, s_warp, &tile);
      const bool take =
          (i < n && bits > tau) || (eq && eq_seen + eq_rank < need);
      eq_seen += tile;
      const int at = warp_append(take, &s_count);
      if (take) key_lo[at] = (uint32_t)i;
    }
  }

  // 2. exact rescore, slot-major over windows staged in shared memory:
  // binary search the candidate in every slot window, rank -> residual
  // table -> w * exact, the first m matches in slot order summed with the
  // run-sum tree (m = the run's clause count)
  int carry = 0;
  for (int base = 0; base < T; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int len = t < T ? max(p.lengths[r * T + t], 0) : 0;
    int tile = 0;
    const int x = block_excl_scan(len, s_warp, &tile);
    if (t < T) s_soff[t] = carry + x;
    carry += tile;
  }
  if (threadIdx.x == 0) s_soff[T] = carry;
  uint16_t* s_docs = reinterpret_cast<uint16_t*>(s_raw);
  const int stage_cap = smem_bytes / 2;
  const bool one_group = carry <= stage_cap;
  if (count_class && n_pick > 0)
    atomicAdd(&class_rows[one_group ? kRescoreStaged : kRescoreRestaged], 1);
  __syncthreads();  // s_soff, the picks; the scores' copy is read no more
  if (one_group) {
    stage_windows(s, p, r, 0, T, s_soff, s_docs);
    __syncthreads();
  }
  for (int base = 0; base < n_pick; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool live = j < n_pick;
    int doc = 0, m = 0;
    if (live) {
      const int ci = select ? (int)key_lo[j] : j;
      doc = cand_doc[off + ci];
      m = cand_cnt[off + ci];
    }
    TreeDown tree;
    int found = 0;
    for (int t0 = 0; t0 < T;) {
      int t1 = T;
      if (!one_group) {  // the next slots whose windows fit together
        t1 = t0 + 1;
        while (t1 < T && s_soff[t1 + 1] - s_soff[t0] <= stage_cap) ++t1;
        __syncthreads();
        stage_windows(s, p, r, t0, t1, s_soff, s_docs);
        __syncthreads();
      }
      const int base0 = s_soff[t0];
      for (int t = t0; live && t < t1 && found < m; ++t) {
        const int len = s_soff[t + 1] - s_soff[t];
        if (len <= 0) continue;
        const uint16_t* w = s_docs + (s_soff[t] - base0);
        int lo = 0, hi = len;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((int)w[mid] < doc) lo = mid + 1;
          else hi = mid;
        }
        if (lo >= len || (int)w[lo] != doc || doc >= p.d_pad) continue;
        const int rt = r * T + t;
        const long long pos = (long long)p.starts[rt] + lo;
        const int rank = (pos >= 0 && pos < s.n_post) ? (int)s.ranks[pos] : 0;
        float val = 0.0f;
        if (rank > 0 && rank <= p.res_lens[rt]) {
          const long long at = (long long)p.res_starts[rt] + rank - 1;
          if (at >= 0 && at < s.n_res) val = s.res_vals[at];
        }
        tree.push(m - 1 - found, __fmul_rn(p.weights[rt], val), m);
        ++found;
      }
      t0 = t1;
    }
    if (live) {
      for (; found < m; ++found) tree.push(m - 1 - found, 0.0f, m);
      // the final key: score order, then the smaller doc first (docs of
      // a row are unique, so are the keys); bit 0 keeps a -0.0's sign
      key_hi[j] = order_bits(tree.out);
      key_lo[j] = ((uint32_t)(65535 - doc) << 16) |
                  (__float_as_uint(tree.out) == 0x80000000u ? 1u : 0u);
    }
  }
  __syncthreads();

  // 3. the top kk on (-score, doc): when more than kk were rescored, a
  // radix select of the kk-th key keeps exactly kk; only those are sorted
  const int count = min(n_pick, kk);
  unsigned long long* s_fin = reinterpret_cast<unsigned long long*>(s_raw);
  auto key_at = [&](int j) {
    return ((unsigned long long)key_hi[j] << 32) | key_lo[j];
  };
  if (count_class && n_pick > 0)
    atomicAdd(&class_rows[n_pick > kk ? kFinalTrim : kFinalAll], 1);
  if (n_pick > kk) {
    const unsigned long long thr = radix_select<unsigned long long>(
        n_pick, kk, key_at, 56, 16, s_hist, s_wsum, s_pick);
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    for (int base = 0; base < n_pick; base += blockDim.x) {
      const int j = base + threadIdx.x;
      const unsigned long long key = j < n_pick ? key_at(j) : 0ull;
      const bool take = j < n_pick && (key >> 16) >= (thr >> 16);
      const int at = warp_append(take, &s_count);
      if (take) s_fin[at] = key;
    }
  } else {
    for (int j = threadIdx.x; j < n_pick; j += blockDim.x)
      s_fin[j] = key_at(j);
  }
  int sort_n = 1;
  while (sort_n < count) sort_n <<= 1;
  for (int j = count + threadIdx.x; j < sort_n; j += blockDim.x)
    s_fin[j] = 0ull;  // below every real key
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < sort_n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = s_fin[lo], b = s_fin[hi];
        if ((a < b) == ((lo & size) == 0)) {
          s_fin[lo] = b;
          s_fin[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    float v = __int_as_float(kNegInfBits);
    int doc = p.d_pad;
    if (j < count) {
      const unsigned long long key = s_fin[j];
      const uint32_t lo = (uint32_t)key;
      uint32_t bits = order_bits_inverse((uint32_t)(key >> 32));
      if (lo & 1u) bits = 0x80000000u;
      v = __uint_as_float(bits);
      doc = 65535 - (int)(lo >> 16);
    }
    out_vals[(long long)r * kk + j] = v;
    out_docs[(long long)r * kk + j] = doc;
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

int es_row_sort(void* keys, void* alt, const void* n_keys, void* ckeys,
                void* calt, const void* n_ckeys, const void* row_off, int R,
                void* class_rows, void* stream) {
  const int smem = 2 * kSortSmemKeys * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      row_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R, ckeys != nullptr ? 2 : 1);
  row_sort_kernel<<<grid, kSortThreads, smem, (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(keys), static_cast<uint32_t*>(alt),
      static_cast<const int*>(n_keys), static_cast<uint32_t*>(ckeys),
      static_cast<uint32_t*>(calt), static_cast<const int*>(n_ckeys),
      static_cast<const long long*>(row_off), static_cast<int*>(class_rows));
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
                      int kk, int smem_bytes, void* scr_hi, void* scr_lo,
                      void* out_vals, void* out_docs, void* class_rows,
                      void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      select_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  select_rescore_kernel<<<R, kSelThreads, smem_bytes,
                          (cudaStream_t)stream>>>(
      s, p, static_cast<const float*>(cand_score),
      static_cast<const int*>(cand_doc), static_cast<const int*>(cand_cnt),
      static_cast<const int*>(n_cand),
      static_cast<const long long*>(row_off), kc, kk, smem_bytes,
      static_cast<uint32_t*>(scr_hi), static_cast<uint32_t*>(scr_lo),
      static_cast<float*>(out_vals), static_cast<int*>(out_docs),
      static_cast<int*>(class_rows));
  return (int)cudaGetLastError();
}

const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
