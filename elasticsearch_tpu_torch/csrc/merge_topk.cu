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
//   1. slot_decode     one launch: each slot whose lanes reach kk selects
//                      its kk-th largest lane lower bound (radix select
//                      over the slot's own lanes, in a block past 512
//                      lanes, else in a warp); one warp per slot takes
//                      its per-128-lane group upper bounds and their max.
//   2. row_pack        grid tiles: one block per 2048 lanes of a row (a
//                      long row split over several): row threshold and
//                      every slot's "other terms" bound, the block-max
//                      skip, and the u32 keys (doc << 16 | code16(w *
//                      value)) of the surviving lanes, compacted: padding
//                      and skipped lanes are dropped before the sort
//                      (they never reach a result). When totals are asked
//                      for with the skip on, also the pre-skip count keys
//                      (doc << 1 | pos).
//   3. row_sort        grid (R, key sets): LSD radix sort of each row's
//                      keys and count keys in one launch, 8-bit digits,
//                      stable; in shared memory when the row fits.
//   4. run_sum         grid tiles (row_pack's): run ends of the sorted
//                      keys, each run's quantized total with the
//                      reference's Hillis-Steele tree, clause counts, the
//                      msm filter, TotalHits, and the matching run ends
//                      as candidates in key order.
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
// slot_decode. A slot's group bounds are 32 values at most, so a warp
// takes them, with no barrier. Only a slot of at least kk lanes selects,
// over its own len lanes (16 codes a thread, loaded at once and kept in
// registers): a slot of up to 512 lanes in a warp with a 256-bin
// histogram of its own (no barrier), a longer one in a block. So the
// many short slots of a small kernel k are all in flight at once, where
// a block a slot runs them in waves, each a chain of barriers and two
// dependent loads. The select skips the key bits all its keys share (a
// min/max pass) and bins the next 8 with plain shared atomics: one or
// two passes on the 16-bit codes, where a select on the f32 bounds of
// all max_len lanes takes four, every thread adding into the one or two
// bins of the slot's shared exponent (warp-aggregated adds,
// __match_any_sync, cost more than the conflicts they save: PERF.md).
// What bounds it (PERF.md): the long slots' blocks (a load round trip,
// then five to nine barriers) and the bounds warps' dependent loads.
//
// row_pack and run_sum share one tile layout: each row's lanes in tiles
// of kTile, block r < R the first tile of row r (no lookup), block R
// + e the e-th further tile (tile_rq[e] = row | tile << 16), so a
// one-tile row costs no lookup and a long row spreads over many blocks.
// 256-thread blocks, four to five per SM: ~500 tiles in flight.
//
// row_pack. A row's valid lanes are its slots back to back; each block
// stages the row's slot table (prefix of the lengths, clamped starts,
// weights, delta bases, bounds) in shared memory with one block scan,
// issues every lane load of its tile (8 striped lanes a thread, the slot
// found by one binary search and a walk), computes the skip bounds while
// the loads are in flight, and compacts the keys in lane order by one
// warp scan over (item, warp) counts. A one-tile row writes its counts;
// the blocks of a split row take their slots with one atomic per key
// set (the key order within a row is free: row_sort sorts it). What
// bounds it (PERF.md): two dependent round trips a block (the slot
// table, then the lanes), hidden only by the tiles in flight.
//
// run_sum. A tile of both key sets is staged in shared memory with the
// window - 1 keys before it, in a padded layout (one word per 32) so
// each thread reads its 8 consecutive keys conflict-free; it runs the
// reference's doubling steps on them in registers, and walks back in
// shared memory (TreeUp) only for its first run when that began in an
// earlier thread. The candidates of a tile are ordered by a scan of the
// threads' counts, placed after the row's earlier tiles' by a decoupled
// look-back (32 earlier tiles a round), and written out through shared
// memory on neighbouring words. What bounds it (PERF.md): the staging
// round trip and, in long rows, the wait for earlier tiles' counts.
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

// Two more kernels serve the main path around the merge:
//
//   6. shard_topk      the top min(k, N) of each row's N f32 values,
//                      equal values in ascending position (lax.top_k's
//                      rule). Replaces the XLA top-k of
//                      elasticsearch_tpu/parallel/distributed.py::
//                      _merge_topk (sparse.hierarchical_top_k) after the
//                      cross-shard all_gather, and the exact variant's
//                      final top_k. One unique 56-bit key a value (value
//                      order bits, position reversed); a radix select of
//                      the k-th key stops at the first digit taken whole.
//                      A row whose finalists sort in one block (up to
//                      the wrapper's sort_cap keys) takes one block: its
//                      values staged in shared memory when they fit
//                      ("staged": one read of the row, every select pass
//                      there), else read from device memory ("shared");
//                      a bitonic sort in shared memory. A row with more
//                      finalists ("device", kernel k 16,384) spreads over
//                      blocks of `slice` values: one launch per 8-bit
//                      digit whose last-arriving block picks the digit,
//                      then each block sorts its slice's finalists in
//                      shared memory into one run, then each key's rank
//                      is its index in its run plus the keys above it in
//                      the other runs (binary searches in shared memory).
//                      Bound: bytes, N values read once.
//   7. exact_merge     grid R: the compressed_exact variant
//                      (elasticsearch_tpu/ops/sparse.py::_merge_topk_core,
//                      its exact branch, for weights that fail
//                      packable()) up to its top-k: each valid lane
//                      decoded to w * exact value (rounded before any
//                      add); the row's slots, each a sorted run of docs,
//                      merged stably (equal docs in slot order) in
//                      windows of shared memory sized to the launch; the
//                      run sums with the reference tree, the msm filter
//                      and TotalHits. A slot whose docs descend sends its
//                      row through LSD radix passes instead. No
//                      block-max skip, as in the reference. shard_topk
//                      then takes the top kk of the candidates. Bound:
//                      bytes, each valid lane's doc and rank read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneBlock = 128;      // COMPRESSED_BLOCK
constexpr int kSlotThreads = 256;    // threads of slot_decode
constexpr int kSlotWarps = kSlotThreads / 32;  // warps of a slot_decode block
constexpr int kSlotItems = 16;       // codes a thread of a block select:
                                     // 4096 (CHUNK_CAP) a block
constexpr int kWarpSelectLanes = 32 * kSlotItems;  // longest slot a warp
                                                    // selects in
static_assert(kSlotItems * kSlotThreads >= 4096, "a block holds a slot");
constexpr int kStack = 16;           // TreeDown stack (windows up to 2**15)
constexpr int kTile = 2048;          // lanes of a row_pack or run_sum block
constexpr int kPackThreads = 256;    // threads of row_pack
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackItems = kTile / kPackThreads;  // striped lanes a thread
constexpr int kRunThreads = 256;     // threads of run_sum
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kRunItems = kTile / kRunThreads;    // consecutive keys a thread
constexpr int kRunStack = 10;        // TreeUp stack (runs up to 2**10)
constexpr int kWideRunStack = 14;    // the same past a window of 2**10
                                     // terms (runs up to 2**14)
constexpr int kWindowLimit = 1 << kWideRunStack;  // t_window, any kernel
constexpr int kSoffShared = 1024;    // select_rescore's slot prefix in
                                     // static shared memory up to here
// dynamic shared memory a block may opt in to (227 KB), less what the
// kernels hold statically
constexpr int kSmemOptIn = 232448 - 9 * 1024;
constexpr int kSortThreads = 512;    // threads of row_sort
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 4;        // keys per lane per round of a pass
constexpr int kSortSmemKeys = 8192;  // the "shared" class: keys per row
constexpr int kSelThreads = 512;     // threads of select_rescore

// size classes (rows per class, when the wrapper asks for them)
enum {
  kSortShared = 0, kSortDevice, kSelNone, kSelShared, kSelDevice,
  kRescoreStaged, kRescoreRestaged, kFinalAll, kFinalTrim, kPackSingle,
  kPackSplit, kRunOneTile, kRunTiled, kSlotBounds, kSlotSelectWarp,
  kSlotSelectBlock, kNumClasses
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
  const int* docs32;          // a raw pack's int32 doc ids, or null
  const float* imps;          // a raw pack's f32 impacts, or null
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
// commutative, so only the grouping has to match, and it does. The stack
// is a shift register (s[0] its top, every index a constant), so it stays
// in registers; a run of n <= 2**kDepth lanes holds popcount(n) nodes.
// kDepth follows the launch's window: kRunStack up to 2**10 terms, else
// kWideRunStack.
template <int kDepth>
struct TreeUp {
  float s[kDepth];
  int sp = 0;
  int n = 0;
  __device__ __forceinline__ void push(float v) {
    int q = n++;
    while (q & 1) {
      v = __fadd_rn(s[0], v);
#pragma unroll
      for (int j = 0; j + 1 < kDepth; ++j) s[j] = s[j + 1];
      --sp;
      q >>= 1;
    }
#pragma unroll
    for (int j = kDepth - 1; j > 0; --j) s[j] = s[j - 1];
    s[0] = v;
    ++sp;
  }
  __device__ __forceinline__ float result() const {
    float acc = s[0];
#pragma unroll
    for (int j = 1; j < kDepth; ++j)
      if (j < sp) acc = __fadd_rn(s[j], acc);
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

// Group bounds of slot rt by one warp (lane g takes 128-lane group g;
// max_len <= 4096, so n_grp <= 32): an unaligned group spans two aligned
// blocks, +1 on the code is an open bound (clamped below +inf). The
// n_grp + 1 block-max codes are read one a lane, bm[g + 1] from the next
// lane; the group bounds leave as one line. A slot shorter than kk cannot
// set the row threshold: its kth is -inf.
__device__ __forceinline__ void slot_bounds(
    int rt, const Slots& p, const uint16_t* block_max, long long n_bm,
    const int* blk_starts, int kk, int n_grp, float* kth_out,
    float* grp_ub_out, float* slot_ub_out, int* class_rows) {
  const int lane = threadIdx.x & 31;
  const int len = p.lengths[rt];
  const float w = p.weights[rt];
  const long long bs = clampll(blk_starts[rt], 0, n_bm - (n_grp + 1));
  const uint32_t c0 = lane <= n_grp ? (uint32_t)block_max[bs + lane] : 0u;
  uint32_t c1 = __shfl_down_sync(0xffffffffu, c0, 1);
  if (lane == 31 && n_grp == 32) c1 = block_max[bs + 32];
  float gu = 0.0f;
  if (lane < n_grp) {
    const uint32_t c = min(max(c0, c1) + 1u, 0x7F80u);
    const bool gv = (long long)lane * kLaneBlock < (long long)len;
    gu = (gv && w > 0.0f) ? __fmul_rn(w, decode_code16(c)) : 0.0f;
    grp_ub_out[(long long)rt * n_grp + lane] = gu;
  }
  // every bound is +0 or above, so its bits order like its value
  const uint32_t m = __reduce_max_sync(0xffffffffu, __float_as_uint(gu));
  if (lane == 0) {
    slot_ub_out[rt] = __uint_as_float(m);
    if (len < kk) {
      kth_out[rt] = __int_as_float(kNegInfBits);
      if (class_rows != nullptr) atomicAdd(&class_rows[kSlotBounds], 1);
    }
  }
}

// The digit of a 256-bin histogram that holds the `remaining`-th largest
// key, by one warp over its own bins (lane l holds digits 255 - 8l down
// to 248 - 8l): → (digit, its rank among the digit's keys).
__device__ __forceinline__ int2 warp_pick_digit(const int* s_hist,
                                                int remaining) {
  const int lane = threadIdx.x & 31;
  int cnt[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cnt[i] = s_hist[255 - 8 * lane - i];
    sum += cnt[i];
  }
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  const unsigned hit = __ballot_sync(
      0xffffffffu, incl - sum < remaining && remaining <= incl);
  const int owner = hit ? __ffs(hit) - 1 : 31;
  int digit = 0, rank = 0, acc = incl - sum;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (rank == 0 && acc + cnt[i] >= remaining) {
      digit = 255 - 8 * lane - i;
      rank = remaining - acc;
    }
    acc += cnt[i];
  }
  return make_int2(__shfl_sync(0xffffffffu, digit, owner),
                   __shfl_sync(0xffffffffu, rank, owner));
}

// The kk-th largest lane lower bound of slot rt (len >= kk), by one warp
// (kBlock false: len <= kWarpSelectLanes, `s_hist` the warp's own 256
// bins, no barrier) or by one block (up to 4096 lanes). Either way a
// thread loads its kSlotItems codes at once (one round trip) and keeps
// them as keys in registers; a min/max pass over the keys skips the bits
// they all share, and each 8-bit pass bins the next digit of the keys
// that match the prefix so far with plain shared atomics.
template <bool kBlock>
__device__ __forceinline__ void slot_select(int rt, const Streams& s,
                                            const Slots& p, int kk,
                                            int* s_hist, float* kth_out,
                                            int* class_rows) {
  __shared__ int s_pick[2];
  __shared__ int s_wsum[kSlotWarps];
  __shared__ uint32_t s_mm[2][kSlotWarps][2];
  constexpr int kThreads = kBlock ? kSlotThreads : 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int me = kBlock ? threadIdx.x : lane;
  const int len = p.lengths[rt];
  const float w = p.weights[rt];
  const uint16_t* codes =
      s.codes + clampll(p.starts[rt], 0, s.n_post - p.max_len);
  uint32_t key[kSlotItems];
#pragma unroll
  for (int j = 0; j < kSlotItems; ++j) {
    const int l = j * kThreads + me;
    key[j] = l < len ? (uint32_t)codes[l] : 0u;
  }
  auto valid = [&](int j) { return j * kThreads + me < len; };
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
  auto min_max = [&](int call) {
#pragma unroll
    for (int j = 0; j < kSlotItems; ++j) {
      if (valid(j)) {
        lo = min(lo, key[j]);
        hi = max(hi, key[j]);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if constexpr (kBlock) {
      if (lane == 0) {
        s_mm[call][warp][0] = lo;
        s_mm[call][warp][1] = hi;
      }
      __syncthreads();
      for (int i = 0; i < kSlotWarps; ++i) {
        lo = min(lo, s_mm[call][i][0]);
        hi = max(hi, s_mm[call][i][1]);
      }
    }
  };
  min_max(0);
  // For a finite w >= +0 and codes <= 0x7F7F (what compress_flat and
  // packable() admit: finite non-negative impacts and weights) the map
  // code -> __fmul_rn(w, decode(code)) is monotone non-decreasing, so the
  // kk-th largest product is the product of the kk-th largest code, and
  // the padding lanes (+0, at most every lane's bound) cannot change it:
  // the keys are the 16-bit codes. Any other slot's keys are the
  // products' order bits over all max_len lanes, the padding counted as
  // max_len - len keys of order_bits(+0).
  const bool by_code = __float_as_uint(w) < 0x7F800000u && hi <= 0x7F7Fu;
  const int n_pad = by_code ? 0 : p.max_len - len;
  constexpr uint32_t kPadKey = 0x80000000u;  // order_bits(+0)
  if (!by_code) {
#pragma unroll
    for (int j = 0; j < kSlotItems; ++j)
      key[j] = order_bits(__fmul_rn(w, decode_code16(key[j])));
    lo = n_pad > 0 ? kPadKey : 0xFFFFFFFFu;
    hi = n_pad > 0 ? kPadKey : 0u;
    min_max(1);
  }
  // skip the bits all keys share: the first pass bins the highest bit
  // they differ in and the 7 below it (none when they are all the same)
  uint32_t prefix = hi, mask = 0xFFFFFFFFu;
  int shift = -1;
  if (lo != hi) {
    const int top = 31 - __clz(lo ^ hi);
    mask = top == 31 ? 0u : ~((2u << top) - 1u);
    prefix = hi & mask;
    shift = max(top - 7, 0);
  }
  for (int remaining = kk; shift >= 0;
       shift = shift > 0 ? max(shift - 8, 0) : -1) {
    if constexpr (kBlock) {
      s_hist[threadIdx.x] = 0;  // kSlotThreads == 256 bins
      __syncthreads();
    } else {
      for (int i = lane; i < 256; i += 32) s_hist[i] = 0;
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < kSlotItems; ++j) {
      if (valid(j) && (key[j] & mask) == prefix)
        atomicAdd(&s_hist[(key[j] >> shift) & 0xFFu], 1);
    }
    if (me == 0 && n_pad > 0 && (kPadKey & mask) == prefix)
      atomicAdd(&s_hist[(kPadKey >> shift) & 0xFFu], n_pad);
    int2 pick;
    if constexpr (kBlock) {
      __syncthreads();
      pick_digit(s_hist, remaining, s_wsum, s_pick);
      pick = make_int2(s_pick[0], s_pick[1]);
    } else {
      __syncwarp();
      pick = warp_pick_digit(s_hist, remaining);
      __syncwarp();
    }
    prefix |= (uint32_t)pick.x << shift;
    mask |= 0xFFu << shift;
    remaining = pick.y;
  }
  if (me == 0) {
    kth_out[rt] = by_code ? __fmul_rn(w, decode_code16(prefix))
                          : __uint_as_float(order_bits_inverse(prefix));
    if (class_rows != nullptr)
      atomicAdd(&class_rows[kBlock ? kSlotSelectBlock : kSlotSelectWarp], 1);
  }
}

// One launch. Blocks b < n_long each select in the long slot sel[b] (the
// longest tasks first, so they start in the first wave); after them one
// warp per task: warps gw < n_short select in the short slot sel[n_long
// + gw], warp n_short + rt takes slot rt's group bounds (a block may
// hold both kinds: neither waits at a block barrier). Six blocks an SM
// (40 registers, a few spilled): at its natural 58 registers only four
// fit and the launch is slower (PERF.md).
__global__ void __launch_bounds__(kSlotThreads, 6)
slot_decode_kernel(Streams s, Slots p, int R, const uint16_t* block_max,
                   long long n_bm, const int* blk_starts, int kk,
                   const int* sel, int n_long, int n_short, float* kth_out,
                   float* grp_ub_out, float* slot_ub_out, int* class_rows) {
  __shared__ int s_hist[kSlotWarps][256];
  const int b = blockIdx.x, warp = threadIdx.x >> 5;
  if (b < n_long) {
    slot_select<true>(sel[b], s, p, kk, s_hist[0], kth_out, class_rows);
    return;
  }
  const long long gw = (long long)(b - n_long) * kSlotWarps + warp;
  if (gw < n_short) {
    slot_select<false>(sel[n_long + gw], s, p, kk, s_hist[warp], kth_out,
                       class_rows);
    return;
  }
  const long long rt = gw - n_short;
  if (rt >= (long long)R * p.T) return;  // whole warps
  slot_bounds((int)rt, p, block_max, n_bm, blk_starts, kk,
              (p.max_len + kLaneBlock - 1) / kLaneBlock, kth_out,
              grp_ub_out, slot_ub_out, class_rows);
}

// ---------------------------------------------------------------------------
// 2. row_pack
// ---------------------------------------------------------------------------

// The (row, tile of the row) of block b: blocks 0 .. R-1 are the rows'
// first tiles, block R + e the e-th further tile (tile_rq[e] = row |
// tile << 16; a row's further tiles are consecutive blocks).
__device__ __forceinline__ int2 block_tile(const int* tile_rq, int R) {
  const int b = blockIdx.x;
  if (b < R) return make_int2(b, 0);
  const int rq = tile_rq[b - R];
  return make_int2(rq & 0xFFFF, rq >> 16);
}

// A row's slot table for row_pack: the prefix of the lengths (T + 1;
// pref[T] the row's lanes), clamped starts, weights, delta bases; for
// the skip each slot's term bound, whether it is its term's first slot,
// its upper bound, term and k-th lower bound; then the skip's total and
// threshold. In shared memory while it fits, else in device memory.
struct PackTable {
  int* pref;
  int* eff;
  float* w;
  int* dbs;
  int* dlo;
  float* tu;
  int* first;
  float* ub;
  int* term;
  float* kth;
  float* total_thr;  // [2]
};

__host__ __device__ __forceinline__ long long pack_table_words(int T) {
  return 10LL * T + 3;
}

__device__ __forceinline__ PackTable pack_table(int* base, int T) {
  PackTable tb;
  tb.pref = base;
  tb.eff = tb.pref + T + 1;
  tb.w = reinterpret_cast<float*>(tb.eff + T);
  tb.dbs = reinterpret_cast<int*>(tb.w + T);
  tb.dlo = tb.dbs + T;
  tb.tu = reinterpret_cast<float*>(tb.dlo + T);
  tb.first = reinterpret_cast<int*>(tb.tu + T);
  tb.ub = reinterpret_cast<float*>(tb.first + T);
  tb.term = reinterpret_cast<int*>(tb.ub + T);
  tb.kth = reinterpret_cast<float*>(tb.term + T);
  tb.total_thr = tb.kth + T;
  return tb;
}

// Row r's slots into its table: clamped starts, weights, delta bases,
// the skip's per-slot operands and the prefix of the lengths (a block
// scan per kPackThreads slots).
__device__ void pack_table_slots(const Streams& s, const Slots& p, int r,
                                 int do_skip, const int* slot_terms,
                                 const float* kth, const float* slot_ub,
                                 const PackTable& tb, int* s_warp) {
  const int T = p.T, tid = threadIdx.x;
  const bool delta = s.docs8 != nullptr;
  const int nb_slice = p.max_len / kLaneBlock + 2;
  int carry = 0;
  for (int base = 0; base < T; base += kPackThreads) {
    const int t = base + tid;
    const int rt = r * T + t;
    int len = 0;
    if (t < T) {
      len = max(p.lengths[rt], 0);
      tb.eff[t] = (int)clampll(p.starts[rt], 0, s.n_post - p.max_len);
      tb.w[t] = p.weights[rt];
      if (delta) {
        tb.dbs[t] = (int)clampll(p.dbs[rt], 0, s.n_bases - nb_slice);
        tb.dlo[t] = p.dlo[rt];
      }
      if (do_skip) {
        tb.ub[t] = slot_ub[rt];
        tb.term[t] = slot_terms != nullptr ? slot_terms[rt] : t;
        tb.kth[t] = kth[rt];
      }
    }
    int tile = 0;
    const int x = block_excl_scan(len, s_warp, &tile);
    if (t < T) tb.pref[t] = carry + x;
    carry += tile;
  }
  if (tid == 0) tb.pref[T] = carry;
}

// The skip's part of the table (its slots part complete): a slot's term
// bound is the max over its term's slots; the first slot of each term
// carries it into the sum of every term's bound; the threshold is the
// largest k-th bound of a slot of at least kk lanes (-inf under msm).
__device__ void pack_table_skip(const Slots& p, int r, int with_counts,
                                int kk, bool by_term, const PackTable& tb) {
  const int T = p.T, tid = threadIdx.x;
  for (int t = tid; t < T; t += kPackThreads) {
    float tu = tb.ub[t];
    bool first = true;
    if (by_term) {
      const int term = tb.term[t];
      tu = 0.0f;
      for (int u = 0; u < T; ++u)
        if (tb.term[u] == term) {
          tu = fmaxf(tu, tb.ub[u]);
          if (u < t) first = false;
        }
    }
    tb.tu[t] = tu;
    tb.first[t] = first;
  }
  __syncthreads();
  if (tid == 0) {
    // summed serially in slot order, as the reference adds them
    float total = 0.0f;
    float thr = __int_as_float(kNegInfBits);
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      total = __fadd_rn(total, tb.first[t] ? tb.tu[t] : 0.0f);
      if (tb.pref[t + 1] - tb.pref[t] >= kk) thr = fmaxf(thr, tb.kth[t]);
    }
    tb.total_thr[0] = total;
    tb.total_thr[1] = with_counts && p.min_count[r] > 1
                          ? __int_as_float(kNegInfBits) : thr;
  }
  __syncthreads();
}

// Rows whose table does not fit in shared memory: one block a row
// builds the row's table in device memory once, for every tile block of
// the row (row_pack's launch runs it first).
__global__ void __launch_bounds__(kPackThreads)
pack_table_kernel(Streams s, Slots p, int do_skip, int with_counts, int kk,
                  const int* slot_terms, const float* kth,
                  const float* slot_ub, int* tables) {
  __shared__ int s_warp[33];
  const int r = blockIdx.x;
  const PackTable tb =
      pack_table(tables + r * pack_table_words(p.T), p.T);
  pack_table_slots(s, p, r, do_skip, slot_terms, kth, slot_ub, tb, s_warp);
  __syncthreads();
  if (do_skip) pack_table_skip(p, r, with_counts, kk, slot_terms != nullptr,
                               tb);
}

// One block per tile of kTile lanes of a row; a row's valid lanes are
// its slots back to back (slot t from pref[t]), a row longer than one
// tile is split over several blocks. Each block stages its row's slot
// table in shared memory (or reads the one pack_table_kernel built in
// device memory for a row too wide), recomputes the skip threshold and
// the "other terms" bounds there, issues every lane load of its tile
// before it uses one, and compacts its keys in lane order; a one-tile
// row writes its counts, a split row's blocks take their slots with one
// global atomic per key set.
__global__ void __launch_bounds__(kPackThreads)
row_pack_kernel(Streams s, Slots p, int R, int do_skip, int with_counts,
                int kk, const int* slot_terms, const float* kth,
                const float* grp_ub, const float* slot_ub,
                const long long* row_off, const int* tile_rq,
                uint32_t* keys, int* n_keys, uint32_t* ckeys, int* n_ckeys,
                int* class_rows, int* tables) {
  extern __shared__ __align__(16) int s_slot[];
  __shared__ int s_cnt[2][kPackItems * kPackWarps];
  __shared__ int s_warp[33];
  const int T = p.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_grp = (p.max_len + kLaneBlock - 1) / kLaneBlock;
  const bool delta = s.docs8 != nullptr;
  const bool want_count = ckeys != nullptr;
  const int2 rq = block_tile(tile_rq, R);
  const int r = rq.x, q = rq.y;
  const PackTable tb = pack_table(
      tables != nullptr ? tables + r * pack_table_words(T) : s_slot, T);
  if (tables == nullptr)
    pack_table_slots(s, p, r, do_skip, slot_terms, kth, slot_ub, tb,
                     s_warp);
  __syncthreads();  // the table
  const int row_lanes = tb.pref[T];
  const bool split = row_lanes > kTile;
  if (tid == 0 && class_rows != nullptr && q == 0)
    atomicAdd(&class_rows[split ? kPackSplit : kPackSingle], 1);
  if (row_lanes == 0) return;  // the row's counts stay 0
  const int* s_pref = tb.pref;
  const int* s_eff = tb.eff;
  const float* s_w = tb.w;
  const int* s_dbs = tb.dbs;
  const int* s_dlo = tb.dlo;
  const float* s_tu = tb.tu;

  // the tile's lanes, striped: item i of thread tid is lane
  // q * kTile + i * kPackThreads + tid of the row; every load is
  // issued here and used only after the skip bounds below
  const int lane0 = q * kTile;
  int slot[kPackItems], doc[kPackItems];
  uint32_t code[kPackItems];
  float gu[kPackItems];
  int t = 0;  // the last slot starting at or before the item's lane
  {
    int hi = T - 1;  // binary search for the first item, then walk on
    const int f = lane0 + tid;
    while (t < hi) {
      const int mid = (t + hi + 1) >> 1;
      if (s_pref[mid] <= f) t = mid;
      else hi = mid - 1;
    }
  }
#pragma unroll
  for (int i = 0; i < kPackItems; ++i) {
    const int f = lane0 + i * kPackThreads + tid;
    doc[i] = p.d_pad;
    code[i] = 0;
    gu[i] = 0.0f;
    if (f < row_lanes) {
      while (s_pref[t + 1] <= f) ++t;
      const int l = f - s_pref[t];
      const long long pos = (long long)s_eff[t] + l;
      code[i] = s.codes[pos];
      if (delta)
        doc[i] = (int)s.doc_bases[s_dbs[t] + (s_dlo[t] + l) / kLaneBlock] +
                 (int)s.docs8[pos];
      else
        doc[i] = (int)s.docs16[pos];
      if (do_skip)
        gu[i] = grp_ub[(long long)(r * T + t) * n_grp + l / kLaneBlock];
    }
    slot[i] = t;
  }

  if (do_skip && tables == nullptr)
    pack_table_skip(p, r, with_counts, kk, slot_terms != nullptr, tb);
  const float total = do_skip ? tb.total_thr[0] : 0.0f;
  const float thr = do_skip ? tb.total_thr[1] : 0.0f;
  uint32_t key[kPackItems];
  unsigned keep = 0, real = 0;  // bit i: item i
  // items past the row's lanes for the whole warp take no work
  const int live = min(kPackItems, (row_lanes - lane0 - warp * 32 +
                                    kPackThreads - 1) / kPackThreads);
#pragma unroll
  for (int i = 0; i < kPackItems; ++i) {
    if (i >= live) {
      key[i] = 0u;
      if (lane == 0)
        s_cnt[0][i * kPackWarps + warp] = s_cnt[1][i * kPackWarps + warp] = 0;
      continue;
    }
    const int f = lane0 + i * kPackThreads + tid;
    const float imp = __fmul_rn(s_w[slot[i]], decode_code16(code[i]));
    const bool is_real = f < row_lanes && doc[i] < p.d_pad;
    bool is_kept = is_real;
    if (do_skip && is_real &&
        __fadd_rn(gu[i], __fsub_rn(total, s_tu[slot[i]])) < thr)
      is_kept = false;
    key[i] = ((uint32_t)doc[i] << 16) | code16(imp);
    keep |= (unsigned)is_kept << i;
    real |= (unsigned)is_real << i;
    const unsigned kb = __ballot_sync(0xffffffffu, is_kept);
    const unsigned cb = __ballot_sync(0xffffffffu, is_real && want_count);
    if (lane == 0) {
      s_cnt[0][i * kPackWarps + warp] = __popc(kb);
      s_cnt[1][i * kPackWarps + warp] = __popc(cb);
    }
  }
  __syncthreads();
  // warp 0 (keys) and warp 1 (count keys): exclusive scan of the
  // (item, warp) counts, i.e. in lane order, into the keys' offsets; a
  // split row's blocks take their slots of the row with one atomic
  constexpr int kCountsPer = kPackItems * kPackWarps / 32;
  if (warp < 2 && (warp == 0 || want_count)) {
    int* cnt = s_cnt[warp] + lane * kCountsPer;
    int v[kCountsPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kCountsPer; ++j) {
      v[j] = cnt[j];
      sum += v[j];
    }
    int inc = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    const int tile_total = __shfl_sync(0xffffffffu, inc, 31);
    int* count = warp == 0 ? &n_keys[r] : &n_ckeys[r];
    int base = 0;
    if (lane == 0) {
      if (!split) *count = tile_total;
      else if (tile_total > 0) base = atomicAdd(count, tile_total);
    }
    int at = __shfl_sync(0xffffffffu, base, 0) + inc - sum;
#pragma unroll
    for (int j = 0; j < kCountsPer; ++j) {
      cnt[j] = at;
      at += v[j];
    }
  }
  __syncthreads();
  const long long off = row_off[r];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kPackItems; ++i) {
    if (i >= live) break;
    const unsigned kb = __ballot_sync(0xffffffffu, (keep >> i) & 1u);
    const unsigned cb = __ballot_sync(0xffffffffu, (real >> i) & 1u);
    if ((keep >> i) & 1u)
      keys[off + s_cnt[0][i * kPackWarps + warp] + __popc(kb & below)] =
          key[i];
    if (want_count && ((real >> i) & 1u))
      ckeys[off + s_cnt[1][i * kPackWarps + warp] + __popc(cb & below)] =
          ((key[i] >> 16) << 1) | ((key[i] & 0xFFFFu) != 0u ? 1u : 0u);
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
// keys, u32 or u64, shared or device memory), reduce-then-scan: each warp
// counts the digits of its contiguous chunk (shared atomics), a parallel
// scan over (digit, warp) turns the counts into each warp's first slot
// per digit, in place, and each warp scatters its chunk in order.
// Returns false, writing nothing, when the digit is the same in every
// key. s_cnt (kWarps rows) is all zero on entry and on return; kWarps
// warps of at least 256 threads in all.
template <typename K, int kWarps = kSortWarps>
__device__ bool sort_pass(const K* src, K* dst, int n, int shift,
                          int (*s_cnt)[256], int* s_wsum) {
  constexpr int kRound = 32 * kSortItems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int chunk = ((n + kWarps - 1) / kWarps + kRound - 1)
                    / kRound * kRound;
  const int lo = min(warp * chunk, n), hi = min(lo + chunk, n);
  for (int base = lo; base < hi; base += kRound) {
    K key[kSortItems];
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int at = base + i * 32 + lane;
      key[i] = at < hi ? src[at] : (K)0;
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
  int cnt[kWarps];
  int tot = 0;
  if (d < 256) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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
    for (int w = 0; w < kWarps; ++w) {
      s_cnt[w][d] = constant ? 0 : run;
      run += cnt[w];
    }
  }
  __syncthreads();
  if (constant) return false;  // order unchanged
  for (int base = lo; base < hi; base += kRound) {
    K key[kSortItems];
    int pos[kSortItems];
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int at = base + i * 32 + lane;
      key[i] = at < hi ? src[at] : (K)0;
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
    for (int w = 0; w < kWarps; ++w) s_cnt[w][d] = 0;
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

// Look-back status of a run_sum tile: flag (bits 62-63: 1 = the tile's
// own counts, 2 = the counts of its row up to and including it), the
// matching count-key runs (bits 31-61) and the candidates (bits 0-30).
constexpr unsigned long long kOwnCounts = 1ull << 62;
constexpr unsigned long long kRowCounts = 2ull << 62;
constexpr unsigned long long kCountBits = (1ull << 62) - 1;

// run_sum's shared key arrays hold tile position x at pad(x): one word
// of padding after every 32, so the eight consecutive keys each thread
// reads are on distinct banks across a warp.
__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }

// The run ending at tile position x (row index i) walked back in shared
// memory: its sum through TreeUp (→ *n, its lanes within the window).
template <int kDepth>
__device__ __forceinline__ float run_total(const uint32_t* sk, int x, int i,
                                           uint32_t doc, int window,
                                           int* n) {
  TreeUp<kDepth> tree;
  for (int d = 0; d < window && i - d >= 0; ++d) {
    const uint32_t kd = sk[pad(x - d)];
    if ((kd >> 16) != doc) break;
    tree.push(decode_code16(kd & 0xFFFFu));
  }
  *n = tree.n;
  return tree.result();
}

// The count-key run ending at tile position x: its lanes within the
// window, walked back in shared memory.
__device__ __forceinline__ int run_lanes(const uint32_t* sc, int x, int i,
                                         uint32_t cdoc, int window) {
  int m = 0;
  for (; m < window && i - m >= 0; ++m)
    if ((sc[pad(x - m)] >> 1) != cdoc) break;
  return m;
}

// One block per tile of kTile keys (of both key sets) of a row, the
// same tiles as row_pack's (a row's keys are at most its lanes; a tile
// past the row's keys exits). The tile is staged in shared memory with
// the `halo` (window - 1, at least 1) keys before it and the one after
// it; then each thread takes 8 consecutive keys into registers and runs
// segmented_run_sum's doubling steps on them there (a key adds the key
// `st` before it when that key is in its run: the reference's adds,
// grouped as it groups them). Only a thread's first run, when it began
// in an earlier thread, is walked back through TreeUp in shared memory.
// Candidates leave in key order: a scan of the threads' counts, and a
// decoupled look-back over the row's earlier tiles for their candidates
// and matching count-key runs.
template <int kDepth>
__global__ void __launch_bounds__(kRunThreads)
run_sum_kernel(const uint32_t* keys, const int* n_keys,
               const uint32_t* ckeys, const int* n_ckeys,
               const long long* row_off, const int* tile_rq, int R,
               const int* min_count, int with_counts, int window, int halo,
               unsigned long long* status, float* cand_score, int* cand_doc,
               int* cand_cnt, int* n_cand, int* totals, int* class_rows) {
  extern __shared__ __align__(16) uint32_t s_run[];
  __shared__ int s_wsum[kRunWarps];
  __shared__ int s_woff[kRunWarps];
  __shared__ int s_first, s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int2 rq = block_tile(tile_rq, R);
  const int r = rq.x, q = rq.y;
  const long long off = row_off[r];
  const int n = n_keys[r];
  const int nc = ckeys != nullptr ? n_ckeys[r] : 0;
  const float mc = (float)min_count[r];
  const int rows_keys = max(n, nc);
  if (class_rows != nullptr && tid == 0 && q == 0)
    atomicAdd(&class_rows[rows_keys > kTile ? kRunTiled : kRunOneTile], 1);
  const int base = q * kTile;
  if (base >= max(rows_keys, 1)) return;  // past the row's keys
  const uint32_t* k = keys + off;
  const uint32_t* c = ckeys + off;
  // sk[pad(x)] / sc[pad(x)]: key / count key at base + x, x in [-halo,
  // kTile]
  const int lead = halo + (halo >> 5) + 1;
  const int span = lead + pad(kTile) + 1;
  uint32_t* sk = s_run + lead;
  uint32_t* sc = s_run + span + lead;
  {
    uint32_t kv[kRunItems], cv[kRunItems];  // every load before a store
#pragma unroll
    for (int it = 0; it < kRunItems; ++it) {
      const int g = base + it * kRunThreads + tid;
      kv[it] = g < n ? k[g] : 0u;
      cv[it] = g < nc ? c[g] : 0u;
    }
    for (int e = tid; e <= halo; e += kRunThreads) {
      const int x = e < halo ? e - halo : kTile;
      const int g = base + x;
      if (g >= 0 && g < n) sk[pad(x)] = k[g];
      if (g >= 0 && g < nc) sc[pad(x)] = c[g];
    }
#pragma unroll
    for (int it = 0; it < kRunItems; ++it) {
      sk[pad(it * kRunThreads + tid)] = kv[it];
      sc[pad(it * kRunThreads + tid)] = cv[it];
    }
  }
  __syncthreads();

  // this thread's keys: tile positions x0 .. x0 + 7, rows i0 .. i0 + 7
  // (a thread past the row's keys takes no work)
  const int x0 = tid * kRunItems, i0 = base + x0;
  uint32_t key[kRunItems];
  float y[kRunItems];
  int st[kRunItems];  // the first of the run's keys here (-1: before)
  unsigned take = 0;  // bit j: key j ends a run that is a candidate
  int hits = 0;
  if (i0 < rows_keys) {
#pragma unroll
    for (int j = 0; j < kRunItems; ++j) key[j] = sk[pad(x0 + j)];
    {
      uint32_t before = sk[pad(x0 - 1)] >> 16;
      int start = -1;
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) {
        const int i = i0 + j;
        const uint32_t doc = key[j] >> 16;
        if (!(i > 0 && i < n && doc == before)) start = j;
        st[j] = start;
        y[j] = i < n ? decode_code16(key[j] & 0xFFFFu) : 0.0f;
        before = doc;
      }
    }
    // the doubling steps below the window; a step of 8 or more never
    // reaches a key of a run that starts in this thread
#pragma unroll
    for (int sh = 1; sh < kRunItems; sh <<= 1)
      if (sh < window)
#pragma unroll
        for (int j = kRunItems - 1; j >= sh; --j)
          if (st[j] >= 0 && j - sh >= st[j]) y[j] = __fadd_rn(y[j], y[j - sh]);
    {
      const uint32_t after = sk[pad(x0 + kRunItems)] >> 16;
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) {
        const int i = i0 + j;
        const uint32_t doc = key[j] >> 16;
        const uint32_t next = j + 1 < kRunItems ? key[j + 1] >> 16 : after;
        int m = 0;
        if (i < n && (i == n - 1 || next != doc)) {
          if (st[j] >= 0) m = min(j - st[j] + 1, window);
          else y[j] = run_total<kDepth>(sk, x0 + j, i, doc, window, &m);
          if (y[j] > 0.0f && (!with_counts || (float)m >= mc)) take |= 1u << j;
        }
        st[j] = m;  // now the run's clause count
      }
    }
    // exact TotalHits from the pre-skip count keys: a run matches when its
    // last (largest) key carries the positive-code bit
    {
      uint32_t ck[kRunItems];
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) ck[j] = sc[pad(x0 + j)];
      uint32_t before = sc[pad(x0 - 1)] >> 1;
      const uint32_t after = sc[pad(x0 + kRunItems)] >> 1;
      int start = -1;
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) {
        const int i = i0 + j;
        const uint32_t cdoc = ck[j] >> 1;
        const uint32_t next = j + 1 < kRunItems ? ck[j + 1] >> 1 : after;
        if (!(i > 0 && i < nc && cdoc == before)) start = j;
        before = cdoc;
        if (i < nc && (i == nc - 1 || next != cdoc) && (ck[j] & 1u)) {
          int m = 0;
          if (with_counts)
            m = start >= 0 ? min(j - start + 1, window)
                           : run_lanes(sc, x0 + j, i, cdoc, window);
          hits += (!with_counts || (float)m >= mc) ? 1 : 0;
        }
      }
    }
  }
  // candidates (low half) and hits (high half): warp scan, then warp 0
  // over the warps' sums and the look-back
  const int mine = __popc(take) | (hits << 16);
  int inc = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) s_wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int ws = lane < kRunWarps ? s_wsum[lane] : 0;
    int winc = ws;
    for (int d = 1; d < kRunWarps; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += o;
    }
    const int tile = __shfl_sync(0xffffffffu, winc, kRunWarps - 1);
    // this tile's counts; the row's counts before it from the earlier
    // tiles, 32 at a time: their own counts back to the nearest tile that
    // holds its row's counts, whose counts end the sum
    const unsigned long long own = (unsigned long long)(tile & 0xFFFF) |
                                   ((unsigned long long)(tile >> 16) << 31);
    volatile unsigned long long* sts = status;
    const long long b = blockIdx.x;
    unsigned long long before = 0;
    if (q > 0) {
      if (lane == 0) sts[b] = kOwnCounts | own;
      for (int top = q - 1;; top -= 32) {
        const int qq = top - lane;  // this lane's earlier tile
        unsigned long long w = kRowCounts;
        if (qq >= 0) {
          const long long pb = qq > 0 ? b - (q - qq) : r;
          while ((w = sts[pb]) == 0ull) __nanosleep(32);
        }
        const unsigned rows = __ballot_sync(0xffffffffu,
                                            (w & ~kCountBits) == kRowCounts);
        const int last = rows ? __ffs(rows) - 1 : 31;  // lanes 0 .. last
        unsigned long long v = lane <= last ? (w & kCountBits) : 0ull;
        for (int d = 16; d > 0; d >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, d);
        before += v;
        if (rows) break;
      }
    }
    if (lane == 0) {
      sts[b] = kRowCounts | (before + own);
      if (base + kTile >= rows_keys) {  // the row's last tile
        const int cands = (int)((before + own) & 0x7FFFFFFFull);
        n_cand[r] = cands;
        totals[r] = ckeys != nullptr ? (int)((before + own) >> 31) : cands;
      }
    }
    if (lane < kRunWarps) s_woff[lane] = (winc - ws) & 0xFFFF;
    if (lane == 0) {
      s_first = (int)(before & 0x7FFFFFFFull);
      s_tile = tile & 0xFFFF;
    }
  }
  __syncthreads();
  // the tile's candidates in key order through the spent key arrays,
  // then out with neighbouring threads on neighbouring words
  float* s_score = reinterpret_cast<float*>(s_run);
  int* s_doc = reinterpret_cast<int*>(s_run) + kTile;
  int* s_num = s_doc + kTile;
  int at = s_woff[warp] + ((inc - mine) & 0xFFFF);
#pragma unroll
  for (int j = 0; j < kRunItems; ++j)
    if ((take >> j) & 1u) {
      s_score[at] = y[j];
      s_doc[at] = (int)(key[j] >> 16);
      s_num[at] = st[j];
      ++at;
    }
  __syncthreads();
  const long long out = off + s_first;
  for (int m = tid; m < s_tile; m += kRunThreads) {
    cand_score[out + m] = s_score[m];
    cand_doc[out + m] = s_doc[m];
    cand_cnt[out + m] = s_num[m];
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
                      int* class_rows, int* soff_dev) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int s_hist[256];
  __shared__ int s_wsum[8];
  __shared__ int s_pick[2];
  __shared__ int s_warp[33];
  __shared__ int s_count;
  __shared__ int s_soff_sh[kSoffShared + 1];
  const int r = blockIdx.x;
  const int T = p.T;
  // the slots' lane prefix: static shared memory, or device memory for a
  // wider row
  int* s_soff = soff_dev != nullptr ? soff_dev + (long long)r * (T + 1)
                                    : s_soff_sh;
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

// ---------------------------------------------------------------------------
// 6. shard_topk: the cross-shard top-k (and the exact merge's final top-k)
// ---------------------------------------------------------------------------

// A row's finalist key: the value's order bits (the IEEE total order
// lax.top_k ranks by: -NaN below -inf, +NaN above +inf, -0 below +0),
// then the position
// reversed in the low kTopPosBits, so a larger key is a larger value or,
// between equal values, the earlier position: lax.top_k's order. The
// keys of a row are unique, and every key is above 0.
constexpr int kTopThreads = 512;
constexpr int kTopPosBits = 24;   // positions of a row < 2**24
constexpr uint32_t kTopPosMask = (1u << kTopPosBits) - 1u;
// The select takes the value's four 8-bit digits (order bits, shifts 24
// to 0); equal values split by position through their order, not by
// more digits.
constexpr int kTopValueTop = 24;
constexpr int kTopBatch = 8;      // keys a thread loads before it bins them
constexpr int kTopMaxRuns = 1024; // slices of a device-class row
// size classes of shard_topk (rows per class)
enum { kTopStaged = 0, kTopShared, kTopDevice };

// A value's order bits in the IEEE total order (NaN by its sign bit,
// -0 below +0).
__device__ __forceinline__ uint32_t topk_ob(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long topk_key(uint32_t ob, int pos) {
  return ((unsigned long long)ob << kTopPosBits) |
         (kTopPosMask - (uint32_t)pos);
}

__device__ __forceinline__ long long topk_pos(unsigned long long key) {
  return (long long)(kTopPosMask - (uint32_t)(key & kTopPosMask));
}

// The values lo <= i < hi (their order bits, from load) in the order a
// thread meets them: each warp a contiguous chunk, its lanes on
// neighbouring values (coalesced, and conflict-free in shared memory),
// kTopBatch values a lane loaded before any is used, so their loads are
// in flight together. fn(in range, ob, i) for every one; a lane's values
// are 32 apart within its warp's chunk, so on a gather of descending
// shard lists they descend too.
template <typename Load, typename Fn>
__device__ __forceinline__ void for_keys(int lo, int hi, Load load, Fn fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  constexpr int kRound = 32 * kTopBatch;
  const int chunk =
      ((hi - lo + nwarps - 1) / nwarps + kRound - 1) / kRound * kRound;
  const int c_lo = min(lo + warp * chunk, hi), c_hi = min(c_lo + chunk, hi);
  for (int base = c_lo; base < c_hi; base += kRound) {
    uint32_t ob[kTopBatch];
#pragma unroll
    for (int j = 0; j < kTopBatch; ++j) {
      const int i = base + j * 32 + lane;
      ob[j] = i < c_hi ? load(i) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kTopBatch; ++j) {
      const int i = base + j * 32 + lane;
      fn(i < c_hi, ob[j], i);
    }
  }
}

// Adds the digit at `shift` of the values lo <= i < hi whose order bits
// match `prefix` under `mask` into s_hist. A thread counts a run of equal
// digits in a register and adds it once: on descending shard lists a
// lane's values change their digit a few times, so the one or two digits
// most values share cost a few atomics a thread, not one a value.
template <typename Load>
__device__ __forceinline__ void bin_values(int lo, int hi, Load load,
                                           uint32_t prefix, uint32_t mask,
                                           int shift, int* s_hist) {
  int cur = 0, cnt = 0;
  for_keys(lo, hi, load, [&](bool in, uint32_t ob, int) {
    if (!in || (ob & mask) != prefix) return;
    const int d = (int)((ob >> shift) & 0xFF);
    if (d != cur) {
      if (cnt) atomicAdd(&s_hist[cur], cnt);
      cur = d;
      cnt = 0;
    }
    ++cnt;
  });
  if (cnt) atomicAdd(&s_hist[cur], cnt);
}

// Where a select of the k-th value stopped. Not split: the digits it took
// are `value` (its lower bits 0), the last bin taken whole, and exactly k
// values have order bits >= value. Split: `value` is the k-th value's
// order bits, and the finalists are the values above it and, of those
// equal to it, the `remaining` earliest.
struct TopkCut {
  uint32_t value;
  int remaining;
  bool split;
};

// The k-th largest (1-based, k <= n) of n values by their order bits,
// 8-bit digits from the top; it stops at the first digit whose bin is
// taken whole.
template <typename Load>
__device__ TopkCut select_kth_value(int n, int k, Load load, int* s_hist,
                                    int* s_wsum, int* s_pick) {
  TopkCut cut{0u, k, false};
  uint32_t mask = 0;
  for (int shift = kTopValueTop; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    bin_values(0, n, load, cut.value, mask, shift, s_hist);
    __syncthreads();
    pick_digit(s_hist, cut.remaining, s_wsum, s_pick);
    const int digit = s_pick[0];
    const bool whole = s_hist[digit] == s_pick[1];
    cut.value |= (uint32_t)digit << shift;
    mask |= 0xFFu << shift;
    cut.remaining = s_pick[1];
    cut.split = !whole && shift == 0;
    __syncthreads();  // s_hist and s_pick are read before the next pass
    if (whole) break;
  }
  return cut;
}

// The lane's share of a warp sum (every lane gets it).
__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Appends to out (order free: they are sorted next; s_count is 0 on
// entry) the finalists among the values lo <= i < hi under `cut`, as
// their keys: every value >= its prefix, or when the cut splits a value,
// every larger value and the values equal to it whose rank by position
// among the row's equal ones, counting from tie_base (those before lo),
// is below cut.remaining: one pass counts each warp's equal values, a
// block scan orders the warps (their chunks are in position order), a
// second pass ranks them by ballots.
template <typename Load>
__device__ void take_finalists(int lo, int hi, Load load, TopkCut cut,
                               int tie_base, unsigned long long* out,
                               int* s_count, int* s_warp) {
  if (!cut.split) {
    for_keys(lo, hi, load, [&](bool in, uint32_t ob, int i) {
      const bool take = in && ob >= cut.value;
      const int at = warp_append(take, s_count);
      if (take) out[at] = topk_key(ob, i);
    });
    return;
  }
  int ties = 0;
  for_keys(lo, hi, load, [&](bool in, uint32_t ob, int) {
    ties += in && ob == cut.value;
  });
  ties = warp_sum(ties);
  const int lane = threadIdx.x & 31;
  int total = 0;
  const int before = block_excl_scan(lane == 0 ? ties : 0, s_warp, &total);
  int run = tie_base + __shfl_sync(0xffffffffu, before, 0);
  for_keys(lo, hi, load, [&](bool in, uint32_t ob, int i) {
    const bool tie = in && ob == cut.value;
    const unsigned bal = __ballot_sync(0xffffffffu, tie);
    const int rank = run + __popc(bal & ((1u << lane) - 1u));
    run += __popc(bal);
    const bool take = in && (ob > cut.value || (tie && rank < cut.remaining));
    const int at = warp_append(take, s_count);
    if (take) out[at] = topk_key(ob, i);
  });
}

// One compare-exchange of a bitonic sort, descending: element e of a
// pair (e, e ^ half) keeps the larger key when it is the lower of the
// two in a descending block of `size`, or the higher in an ascending one.
__device__ __forceinline__ unsigned long long bitonic_keep(
    unsigned long long mine, unsigned long long other, int e, int half,
    int size) {
  const bool lower = (e & half) == 0;
  const bool desc = (e & size) == 0;
  return lower == desc ? (mine > other ? mine : other)
                       : (mine < other ? mine : other);
}

// The stages of a bitonic sort of block `size` with half < 64, for every
// group of 64 keys: a warp holds a group in registers (two keys a lane,
// 2 * lane and 2 * lane + 1) and exchanges by shuffles, no barrier.
__device__ __forceinline__ void bitonic_warp(unsigned long long* a, int n,
                                             int size, int top_half) {
  const int lane = threadIdx.x & 31;
  for (int g = (threadIdx.x >> 5) * 64; g < n; g += (blockDim.x >> 5) * 64) {
    const int e0 = g + 2 * lane;
    unsigned long long x0 = a[e0], x1 = a[e0 + 1];
    for (int sz = size == 0 ? 2 : size; sz <= (size == 0 ? 64 : size);
         sz <<= 1) {
      for (int half = size == 0 ? sz >> 1 : top_half; half > 0;
           half >>= 1) {
        if (half == 1) {
          const unsigned long long y0 = bitonic_keep(x0, x1, e0, 1, sz);
          x1 = bitonic_keep(x1, x0, e0 + 1, 1, sz);
          x0 = y0;
        } else {
          const int m = half >> 1;
          const unsigned long long o0 = __shfl_xor_sync(0xffffffffu, x0, m);
          const unsigned long long o1 = __shfl_xor_sync(0xffffffffu, x1, m);
          x0 = bitonic_keep(x0, o0, e0, half, sz);
          x1 = bitonic_keep(x1, o1, e0 + 1, half, sz);
        }
      }
    }
    a[e0] = x0;
    a[e0 + 1] = x1;
  }
}

// Bitonic sort, descending, of n (a power of two) keys in shared memory;
// every thread of the block calls it. The stages that pair keys 64 or
// more apart go through shared memory with a barrier each; the rest run
// in registers a warp at a time (bitonic_warp): for 1024 keys, 15
// barriers where a stage each would take 55.
__device__ void bitonic_desc(unsigned long long* a, int n) {
  if (n >= 64) {
    bitonic_warp(a, n, 0, 0);  // every block of up to 64 keys
    __syncthreads();
  }
  for (int size = n >= 64 ? 128 : 2; size <= n; size <<= 1) {
    const int low = n >= 64 ? 64 : 1;  // stages below go by warps
    for (int half = size >> 1; half >= low; half >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (half - 1));
        const int hi = lo + half;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
    if (n >= 64) {
      bitonic_warp(a, n, size, 32);
      __syncthreads();
    }
  }
}

// The select of a device-class row, carried from launch to launch.
struct TopkRow {
  uint32_t value, mask;  // the k-th value's digits found so far (TopkCut)
  int remaining;  // rank of the k-th value among the values under them
  int done;       // the cut is final
  int split;      // it splits a value (TopkCut::split)
  int arrive;     // blocks of the row done with the current pass
  int placed;     // finalists written by the runs kernel
  int count;      // min(n, kk)
  int device;     // the row takes the device class
};

// One block per row: the top min(kk, n) of the row's n values by (value
// desc, position asc), then (-inf, fill) up to kk. A row whose finalists'
// sort (the next power of two of their count) fits sort_cap keys sorts
// them in shared memory with a bitonic sort. When it has more than kk
// values it finds its kk-th key by a radix select: over its values
// staged in shared memory when they fit the launch's stage_cap (class
// "staged": one coalesced read of the row, every pass in shared
// memory), else over the row in device memory ("shared", the finalists'
// sort in shared memory all the same). A row with more finalists
// ("device") is only initialised here (its TopkRow, its fill beyond
// min(kk, n)); topk_pass, topk_runs and topk_merge take it. Writes the
// values (read back from the input, so every bit is the input's), their
// positions when out_pos is given, and ids[position] (fill where the
// value is -inf or NaN) when ids is given.
__global__ void __launch_bounds__(kTopThreads)
shard_topk_kernel(const float* vals, long long stride,
                  const long long* row_off, const int* row_n, int n_all,
                  int kk, int sort_cap, int fin_cap, int stage_cap,
                  TopkRow* rows, float* out_vals, long long* out_pos,
                  const int* ids, int fill, int* out_ids, int* class_rows) {
  extern __shared__ __align__(16) unsigned long long s_fin[];
  __shared__ int s_hist[256];
  __shared__ int s_wsum[8];
  __shared__ int s_pick[2];
  __shared__ int s_warp[33];
  __shared__ int s_count;
  const int r = blockIdx.x;
  const long long off =
      row_off != nullptr ? row_off[r] : (long long)r * stride;
  const int n = row_n != nullptr ? row_n[r] : n_all;
  const float* v = vals + off;
  const int count = min(n, kk);
  int sort_n = 1;
  while (sort_n < count) sort_n <<= 1;
  if (sort_n > sort_cap) {  // the device class: the later launches
    if (threadIdx.x == 0) {
      TopkRow st;
      st.value = 0;
      st.mask = 0;
      st.remaining = count;
      st.done = n <= count;  // every key a finalist: prefix 0 takes all
      st.split = 0;
      st.arrive = 0;
      st.placed = 0;
      st.count = count;
      st.device = 1;
      rows[r] = st;
      if (class_rows != nullptr) atomicAdd(&class_rows[kTopDevice], 1);
    }
    for (int j = count + threadIdx.x; j < kk; j += blockDim.x) {
      const long long o = (long long)r * kk + j;
      out_vals[o] = __int_as_float(kNegInfBits);
      if (out_pos != nullptr) out_pos[o] = -1;
      if (out_ids != nullptr) out_ids[o] = fill;
    }
    return;
  }
  if (rows != nullptr && threadIdx.x == 0) rows[r].device = 0;
  const bool staged = n > count && n <= stage_cap;
  uint32_t* s_ob = reinterpret_cast<uint32_t*>(s_fin + fin_cap);
  if (class_rows != nullptr && threadIdx.x == 0)
    atomicAdd(&class_rows[staged ? kTopStaged : kTopShared], 1);
  unsigned long long* fin = s_fin;
  auto staged_ob = [&](int i) { return s_ob[i]; };
  auto device_ob = [&](int i) { return topk_ob(v[i]); };
  TopkCut cut{0u, count, false};  // value 0: every value a finalist
  if (staged) {
#pragma unroll 8
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_ob[i] = topk_ob(v[i]);
    __syncthreads();
    cut = select_kth_value(n, count, staged_ob, s_hist, s_wsum, s_pick);
  } else if (n > count) {
    cut = select_kth_value(n, count, device_ob, s_hist, s_wsum, s_pick);
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  if (staged)
    take_finalists(0, n, staged_ob, cut, 0, fin, &s_count, s_warp);
  else
    take_finalists(0, n, device_ob, cut, 0, fin, &s_count, s_warp);
  for (int j = count + threadIdx.x; j < sort_n; j += blockDim.x)
    fin[j] = 0ull;  // below every real key
  __syncthreads();
  bitonic_desc(fin, sort_n);
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    float val = __int_as_float(kNegInfBits);
    long long pos = -1;
    if (j < count) {
      pos = topk_pos(fin[j]);
      val = v[pos];
    }
    const long long o = (long long)r * kk + j;
    out_vals[o] = val;
    if (out_pos != nullptr) out_pos[o] = pos;
    if (out_ids != nullptr)
      out_ids[o] = pos >= 0 && val > __int_as_float(kNegInfBits)
                       ? ids[off + pos] : fill;
  }
}

// The device class, one launch per value digit (grid: slices x rows).
// Block g bins the keys of its slice [g * slice, (g + 1) * slice) of the
// row into its own histogram (hist[row][g]); the last block of the row to
// arrive (one atomic a block, after a fence) sums the row's histograms,
// picks the digit and moves the row's TopkRow on. A row whose select is
// done, or that is not of the class, returns at once. No block waits for
// another: the passes are separate launches. After the last value digit
// hist keeps each slice's count of the k-th value (its bin), which the
// runs kernel reads when the cut splits that value.
__global__ void __launch_bounds__(kTopThreads)
topk_pass_kernel(const float* vals, long long stride,
                 const long long* row_off, const int* row_n, int n_all,
                 int slice, int shift, TopkRow* rows, int* hist) {
  __shared__ int s_hist[256];
  __shared__ int s_wsum[8];
  __shared__ int s_pick[2];
  __shared__ int s_last;
  const int r = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  TopkRow* st = rows + r;
  if (!st->device || st->done) return;
  const int n = row_n != nullptr ? row_n[r] : n_all;
  const int g_row = (n + slice - 1) / slice;
  if (g >= g_row) return;
  const float* v =
      vals + (row_off != nullptr ? row_off[r] : (long long)r * stride);
  const uint32_t value = st->value, mask = st->mask;
  const int remaining = st->remaining;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  bin_values(g * slice, min(n, (g + 1) * slice),
             [&](int i) { return topk_ob(v[i]); }, value, mask, shift,
             s_hist);
  __syncthreads();
  int* mine = hist + ((long long)r * G + g) * 256;
  for (int d = threadIdx.x; d < 256; d += blockDim.x) mine[d] = s_hist[d];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&st->arrive, 1) == g_row - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int d = threadIdx.x; d < 256; d += blockDim.x) {
    int sum = 0;
    for (int b = 0; b < g_row; ++b)
      sum += __ldcg(hist + ((long long)r * G + b) * 256 + d);
    s_hist[d] = sum;
  }
  __syncthreads();
  pick_digit(s_hist, remaining, s_wsum, s_pick);
  if (threadIdx.x == 0) {
    const int digit = s_pick[0];
    const bool whole = s_hist[digit] == s_pick[1];
    st->value = value | ((uint32_t)digit << shift);
    st->mask = mask | (0xFFu << shift);
    st->remaining = s_pick[1];
    st->done = whole || shift == 0;
    st->split = !whole && shift == 0;
    st->arrive = 0;
  }
}

// The device class's finalists (grid: slices x rows): block g takes the
// finalists of its slice (exactly `count` over the row; a split value's
// ties ranked from those of the earlier slices, which hist holds), sorts
// them in shared memory (bitonic, the next power of two of their number)
// and writes them as one descending run at a base taken with one atomic:
// runs[row][g] = (base, length).
__global__ void __launch_bounds__(kTopThreads)
topk_runs_kernel(const float* vals, long long stride,
                 const long long* row_off, const int* row_n, int n_all,
                 int kk, int slice, TopkRow* rows, const int* hist,
                 unsigned long long* finals, int* runs) {
  extern __shared__ __align__(16) unsigned long long s_sorted[];
  __shared__ int s_warp[33];
  __shared__ int s_count;
  __shared__ int s_base;
  const int r = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  TopkRow* st = rows + r;
  if (!st->device) return;
  const int n = row_n != nullptr ? row_n[r] : n_all;
  if (g * slice >= n) return;
  const float* v =
      vals + (row_off != nullptr ? row_off[r] : (long long)r * stride);
  const TopkCut cut{st->value, st->remaining, st->split != 0};
  int tie_base = 0;
  if (cut.split) {  // the k-th value's count in the slices before this one
    int mine = 0;
    for (int b = threadIdx.x; b < g; b += blockDim.x)
      mine += hist[((long long)r * G + b) * 256 + (cut.value & 0xFF)];
    block_excl_scan(mine, s_warp, &tie_base);
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  take_finalists(g * slice, min(n, (g + 1) * slice),
                 [&](int i) { return topk_ob(v[i]); }, cut, tie_base,
                 s_sorted, &s_count, s_warp);
  __syncthreads();
  const int m = s_count;
  int sort_n = 1;
  while (sort_n < m) sort_n <<= 1;
  for (int j = m + threadIdx.x; j < sort_n; j += blockDim.x)
    s_sorted[j] = 0ull;
  if (threadIdx.x == 0) {
    s_base = m > 0 ? atomicAdd(&st->placed, m) : 0;
    int* run = runs + ((long long)r * G + g) * 2;
    run[0] = s_base;
    run[1] = m;
  }
  __syncthreads();
  if (m > 1) bitonic_desc(s_sorted, sort_n);
  unsigned long long* out = finals + (long long)r * kk + s_base;
  for (int j = threadIdx.x; j < m; j += blockDim.x) out[j] = s_sorted[j];
}

// The keys above `key` in the runs b0 <= b < b0 + kTopSearch (those below
// n_runs) of a[], run b at s_base[b], s_len[b], each descending:
// kTopSearch binary searches stepped together, so their loads are in
// flight at once.
constexpr int kTopSearch = 8;

__device__ __forceinline__ int keys_above(const unsigned long long* a,
                                          const int* s_base,
                                          const int* s_len, int b0,
                                          int n_runs,
                                          unsigned long long key) {
  int lo[kTopSearch], cnt[kTopSearch];
#pragma unroll
  for (int q = 0; q < kTopSearch; ++q) {
    const bool in = b0 + q < n_runs;
    lo[q] = in ? s_base[b0 + q] : 0;
    cnt[q] = in ? s_len[b0 + q] : 0;
  }
  int above = 0;
#pragma unroll
  for (int q = 0; q < kTopSearch; ++q) above -= lo[q];
  bool more = true;
  while (more) {
    more = false;
#pragma unroll
    for (int q = 0; q < kTopSearch; ++q) {
      if (cnt[q] > 0) {
        const int half = cnt[q] >> 1;
        if (a[lo[q] + half] > key) {
          lo[q] += half + 1;
          cnt[q] -= half + 1;
        } else {
          cnt[q] = half;
        }
        more |= cnt[q] > 0;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kTopSearch; ++q) above += lo[q];
  return above;
}

// The device class's output (grid: chunks of kTopMergeKeys finalists x
// rows): every block stages the row's finalists (every run) in shared
// memory and ranks its chunk of them (in the order the runs were
// placed): a key's rank is the keys above it in every run, its own
// included (binary searches; the keys are unique). Writes the value read
// back from the input, the position and the id at that rank.
constexpr int kTopMergeKeys = 1024;

__global__ void __launch_bounds__(kTopThreads)
topk_merge_kernel(const float* vals, long long stride,
                  const long long* row_off, const int* row_n, int n_all,
                  int kk, int slice, const TopkRow* rows,
                  const unsigned long long* finals, const int* runs,
                  int runs_stride, float* out_vals, long long* out_pos,
                  const int* ids, int fill, int* out_ids) {
  extern __shared__ __align__(16) unsigned long long s_all[];
  __shared__ int s_base[kTopMaxRuns];
  __shared__ int s_len[kTopMaxRuns];
  const int r = blockIdx.y;
  const TopkRow* st = rows + r;
  if (!st->device) return;
  const int count = st->count;
  const int lo = blockIdx.x * kTopMergeKeys;
  if (lo >= count) return;
  const int n = row_n != nullptr ? row_n[r] : n_all;
  const int n_runs = (n + slice - 1) / slice;
  const long long off =
      row_off != nullptr ? row_off[r] : (long long)r * stride;
  const float* v = vals + off;
  for (int b = threadIdx.x; b < n_runs; b += blockDim.x) {
    s_base[b] = runs[((long long)r * runs_stride + b) * 2];
    s_len[b] = runs[((long long)r * runs_stride + b) * 2 + 1];
  }
  const unsigned long long* fin = finals + (long long)r * kk;
#pragma unroll 8
  for (int j = threadIdx.x; j < count; j += blockDim.x) s_all[j] = fin[j];
  __syncthreads();
  const int hi = min(count, lo + kTopMergeKeys);
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const unsigned long long key = s_all[j];
    int rank = 0;
    for (int b0 = 0; b0 < n_runs; b0 += kTopSearch)
      rank += keys_above(s_all, s_base, s_len, b0, n_runs, key);
    const long long pos = topk_pos(key);
    const float val = v[pos];
    const long long o = (long long)r * kk + rank;
    out_vals[o] = val;
    if (out_pos != nullptr) out_pos[o] = pos;
    if (out_ids != nullptr)
      out_ids[o] = val > __int_as_float(kNegInfBits) ? ids[off + pos] : fill;
  }
}

// ---------------------------------------------------------------------------
// 7. exact_merge: the compressed_exact variant up to its final top-k
// ---------------------------------------------------------------------------

constexpr int kExactThreads = 256;
constexpr int kExactBlocksPerSm = 6;  // bounds its registers a thread
constexpr int kExactWarps = kExactThreads / 32;
constexpr int kExactBatch = 4;  // lanes a thread decodes at once
// the most items a merge window stages (two buffers of 8 B each in
// shared memory); a row of more slots goes to the radix class
constexpr int kExactMaxItems = 12288;
constexpr int kNoNext = 0x7fffffff;  // a slot with no lane past its chunk
// size classes of exact_merge (rows per class)
enum { kExactMerge = 0, kExactParts, kExactRadix };

// A row's slot table in shared memory (dynamic, after the two item
// buffers): per slot its clamped start, delta block base, lane count,
// cursor (lanes merged so far), staged and taken lanes, residual table,
// delta offset, weight, and the prefixes of the staged, taken and all
// lanes.
struct ExactTable {
  long long* eff;
  long long* dbs;
  int* len;
  int* cur;
  int* chunk;
  int* take;
  int* rs;
  int* rl;
  int* dlo;
  float* w;
  int* cpre;  // T + 1
  int* tpre;  // T + 1
  int* lpre;  // T + 1
};

__host__ __device__ __forceinline__ int exact_smem_bytes(int S, int T) {
  return 16 * S + 16 * T + 32 * T + 12 * (T + 1);
}

// The table of T slots laid out at `base` (8-byte aligned).
__device__ __forceinline__ ExactTable exact_table(void* base, int T) {
  ExactTable tb;
  tb.eff = static_cast<long long*>(base);
  tb.dbs = tb.eff + T;
  tb.len = reinterpret_cast<int*>(tb.dbs + T);
  tb.cur = tb.len + T;
  tb.chunk = tb.cur + T;
  tb.take = tb.chunk + T;
  tb.rs = tb.take + T;
  tb.rl = tb.rs + T;
  tb.dlo = tb.rl + T;
  tb.w = reinterpret_cast<float*>(tb.dlo + T);
  tb.cpre = reinterpret_cast<int*>(tb.w + T);
  tb.tpre = tb.cpre + T + 1;
  tb.lpre = tb.tpre + T + 1;
  return tb;
}

// Row r's slot table: each slot's clamped window start, delta block base
// and offset, weight, residual table and lane count; cursors at 0. kRaw
// (the raw merge): a raw pack's lanes, no residual tables.
template <bool kRaw>
__device__ void load_slot_table(const Streams& s, const Slots& p,
                                const ExactTable& tb, int r) {
  const bool delta = s.docs8 != nullptr;
  const int nb_slice = p.max_len / kLaneBlock + 2;
  for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
    const int rt = r * p.T + t;
    tb.len[t] = max(p.lengths[rt], 0);
    tb.cur[t] = 0;
    tb.eff[t] = clampll(p.starts[rt], 0, s.n_post - p.max_len);
    tb.w[t] = p.weights[rt];
    tb.rs[t] = kRaw ? 0 : p.res_starts[rt];
    tb.rl[t] = kRaw ? 0 : p.res_lens[rt];
    tb.dbs[t] = delta ? clampll(p.dbs[rt], 0, s.n_bases - nb_slice) : 0;
    tb.dlo[t] = delta ? p.dlo[rt] : 0;
  }
}

// The slot t whose prefix range pre[t] <= i < pre[t + 1] holds i.
__device__ __forceinline__ int slot_of(const int* pre, int T, int i) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int item_doc(unsigned long long it) {
  return (int)(it >> 32);
}

// The doc of lane l of slot t, d_pad at most.
template <bool kRaw>
__device__ __forceinline__ int lane_doc(const Streams& s, const Slots& p,
                                        const ExactTable& tb, int t, int l) {
  const long long pos = tb.eff[t] + l;
  if (kRaw) return min(s.docs32[pos], p.d_pad);
  const int doc =
      s.docs8 != nullptr
          ? (int)s.doc_bases[tb.dbs[t] + (tb.dlo[t] + l) / kLaneBlock] +
                (int)s.docs8[pos]
          : (int)s.docs16[pos];
  return min(doc, p.d_pad);
}

// Items i < n as items out[i]: lane (cur[t] when given) + i - pre[t] of
// the slot t with pre[t] <= i < pre[t + 1], each its doc (d_pad at most)
// in bits 32-63 and, below, the bits of w * exact value (rank ->
// residual table, or kRaw the raw pack's f32 impact; the product
// rounded, as the reference rounds it). kExactBatch lanes a thread at a
// time: every doc and rank (or impact) load of the batch, then every
// residual load, so their round trips overlap.
template <bool kRaw>
__device__ void stage_items(const Streams& s, const Slots& p,
                            const ExactTable& tb, const int* pre,
                            const int* cur, int n, unsigned long long* out) {
  for (int base = 0; base < n; base += kExactBatch * blockDim.x) {
    int t[kExactBatch], doc[kExactBatch], rank[kExactBatch];
    float imp[kExactBatch];
#pragma unroll
    for (int j = 0; j < kExactBatch; ++j) {
      const int i = base + j * blockDim.x + threadIdx.x;
      t[j] = 0;
      doc[j] = 0;
      rank[j] = 0;
      imp[j] = 0.0f;
      if (i < n) {
        t[j] = slot_of(pre, p.T, i);
        const int l = (cur != nullptr ? cur[t[j]] : 0) + i - pre[t[j]];
        doc[j] = lane_doc<kRaw>(s, p, tb, t[j], l);
        if (kRaw) imp[j] = s.imps[tb.eff[t[j]] + l];
        else rank[j] = (int)s.ranks[tb.eff[t[j]] + l];
      }
    }
#pragma unroll
    for (int j = 0; j < kExactBatch; ++j) {
      const int i = base + j * blockDim.x + threadIdx.x;
      if (i >= n) continue;
      float val = imp[j];
      if (!kRaw && rank[j] > 0 && rank[j] <= tb.rl[t[j]]) {
        const long long at = (long long)tb.rs[t[j]] + rank[j] - 1;
        if (at >= 0 && at < s.n_res) val = s.res_vals[at];
      }
      out[i] = ((unsigned long long)(uint32_t)doc[j] << 32) |
               __float_as_uint(__fmul_rn(tb.w[t[j]], val));
    }
  }
}

// Exclusive prefix of one int per slot into pre[0..T], pre[T] the total
// (all threads call it; returns the total).
__device__ int slot_scan(const int* vals, int* pre, int T, int* s_warp) {
  int carry = 0;
  for (int base = 0; base < T; base += blockDim.x) {
    const int t = base + threadIdx.x;
    int tile = 0;
    const int x = block_excl_scan(t < T ? vals[t] : 0, s_warp, &tile);
    if (t < T) pre[t] = carry + x;
    carry += tile;
  }
  if (threadIdx.x == 0) pre[T] = carry;
  __syncthreads();
  return carry;
}

// Items of a[lo..hi) whose doc is below d, the docs ascending.
__device__ __forceinline__ int docs_below(const unsigned long long* a,
                                          int lo, int hi, int d) {
  const int start = lo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (item_doc(a[mid]) < d) lo = mid + 1;
    else hi = mid;
  }
  return lo - start;
}

// Items a thread takes when each takes a contiguous segment of n: odd,
// so the 8-byte items that the lanes of a warp read at one step of their
// segments fall on different banks (an even count of items puts every
// other lane on one bank pair).
__device__ __forceinline__ int odd_share(int n) {
  return ((n + blockDim.x - 1) / blockDim.x) | 1;
}

// Merges T runs of src, each ascending by doc, into one stable doc order
// (equal docs in run order) at [0, n): run u has pre[u + 1] - pre[u]
// items from src[at[u]] and takes output places pre[u] on, so the first
// level also packs runs that lie apart (a window's taken lanes). Pairwise
// merges, log2 T levels ping-ponging between src and dst (with T = 1 the
// run must start at 0: src is the result). In
// each level a thread takes `per` consecutive outputs, finds where its
// first one comes from by one binary search along the merge path of its
// pair of runs, then merges sequentially; a pair whose first run ends at
// or before the second's first doc (the slots of one term split into
// chunks, say) is copied. Returns the buffer that holds the result (src
// when T is 1).
__device__ unsigned long long* merge_runs(unsigned long long* src,
                                          unsigned long long* dst,
                                          const int* pre, const int* at,
                                          int T, int n) {
  const int per = odd_share(n);
  for (int width = 1; width < T; width <<= 1) {
    int o = min(n, (int)threadIdx.x * per);
    const int o_end = min(n, o + per);
    while (o < o_end) {
      const int g = slot_of(pre, T, o) / (2 * width);
      const int a0 = pre[g * 2 * width];
      const int m = pre[min(T, g * 2 * width + width)];
      const int b1 = pre[min(T, (g + 1) * 2 * width)];
      const int la = m - a0, lb = b1 - m, rel = o - a0;
      // where A and B start in src: first at[] (the staged slots),
      // then the runs of the level before, back to back
      const int sa = width == 1 ? at[2 * g] : a0;
      const int sb = width == 1 ? at[min(T, 2 * g + 1)] : m;
      const int stop = min(o_end, b1);
      if (la == 0 || lb == 0 ||
          item_doc(src[sa + la - 1]) <= item_doc(src[sb])) {
        for (; o < stop; ++o)  // A then B: a copy
          dst[o] = o - a0 < la ? src[sa + o - a0] : src[sb + o - a0 - la];
        continue;
      }
      int lo = max(0, rel - lb), hi = min(rel, la);
      while (lo < hi) {  // A[mid] first when its doc is at most B's
        const int mid = (lo + hi) >> 1;
        if (item_doc(src[sa + mid]) <= item_doc(src[sb + rel - mid - 1]))
          lo = mid + 1;
        else
          hi = mid;
      }
      // the heads of A and B in registers: one load a step
      int i = lo, j = rel - lo;
      unsigned long long xa = i < la ? src[sa + i] : 0ull;
      unsigned long long xb = j < lb ? src[sb + j] : 0ull;
      for (; o < stop; ++o) {
        if (j >= lb || (i < la && item_doc(xa) <= item_doc(xb))) {
          dst[o] = xa;
          xa = ++i < la ? src[sa + i] : 0ull;
        } else {
          dst[o] = xb;
          xb = ++j < lb ? src[sb + j] : 0ull;
        }
      }
    }
    __syncthreads();
    unsigned long long* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// The run ends of n items in doc order (shared or device memory): each
// run of a doc below d_pad sums its last `window` lanes with the doubling
// tree of segmented_run_sum (TreeUp), counts them, and keeps the doc when
// the total is > 0 and, with counts, the lanes reach `need`. Each thread
// takes a contiguous segment of the items and parks its candidates, as
// (score bits << 32 | doc), in `scratch` (not src: a run's tree may read
// an earlier segment) from its segment's start *lo on → how many.
template <int kDepth>
__device__ int park_runs(const unsigned long long* src, int n, int window,
                         int with_counts, int need, int d_pad,
                         unsigned long long* scratch, int* lo_out) {
  const int per = odd_share(n);
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int kept = 0;
  for (int i = lo; i < hi; ++i) {
    const int doc = item_doc(src[i]);
    if (doc >= d_pad || (i + 1 < n && item_doc(src[i + 1]) == doc))
      continue;  // not a run end, or a run of padding
    float total = __uint_as_float((uint32_t)src[i]);
    int lanes = 1;  // a run of one lane: its tree is its leaf
    if (i > 0 && item_doc(src[i - 1]) == doc) {
      TreeUp<kDepth> tree;
      for (int d = 0; d < window && i - d >= 0; ++d) {
        const unsigned long long it = src[i - d];
        if (item_doc(it) != doc) break;
        tree.push(__uint_as_float((uint32_t)it));
      }
      total = tree.result();
      lanes = tree.n;
    }
    if (total > 0.0f && (!with_counts || (float)lanes >= (float)need))
      scratch[lo + kept++] =
          ((unsigned long long)__float_as_uint(total) << 32) |
          (uint32_t)doc;
  }
  *lo_out = lo;
  return kept;
}

// park_runs, then one block scan places the candidates: in doc order
// after the `found` already written, to cand_score and cand_doc, or
// packed as (score bits << 32 | doc) when `packed` is given.
template <int kDepth>
__device__ void emit_runs(const unsigned long long* src, int n, int window,
                          int with_counts, int need, int d_pad,
                          unsigned long long* scratch, float* cand_score,
                          int* cand_doc, unsigned long long* packed,
                          int* found, int* s_warp) {
  int lo = 0;
  const int kept = park_runs<kDepth>(src, n, window, with_counts, need,
                                     d_pad, scratch, &lo);
  int tile = 0;
  const int at = *found + block_excl_scan(kept, s_warp, &tile);
  for (int j = 0; j < kept; ++j) {
    const unsigned long long c = scratch[lo + j];
    if (packed != nullptr) {
      packed[at + j] = c;
    } else {
      cand_score[at + j] = __uint_as_float((uint32_t)(c >> 32));
      cand_doc[at + j] = (int)(uint32_t)c;
    }
  }
  *found += tile;
}

// The first lane of slot t whose doc is at least d (its length if none),
// by a warp (every lane calls it): 32 probes a round, each round cutting
// the range to one probe step, so 4096 lanes take three rounds of loads
// in flight together. Where a slot's docs descend the answer is still a
// function of d that never falls as d rises (each probe's test only
// turns true as d rises), so the parts of a slot still tile it.
template <bool kRaw>
__device__ int warp_lower_bound(const Streams& s, const Slots& p,
                                const ExactTable& tb, int t, int d) {
  const int lane = threadIdx.x & 31;
  int a = 0, b = tb.len[t];  // the answer lies in [a, b]
  while (a < b) {
    const int step = (b - a + 31) / 32;
    const int at = a + lane * step;
    const bool probe = at < b;
    const bool below = probe && lane_doc<kRaw>(s, p, tb, t, at) < d;
    const unsigned probes = __ballot_sync(0xffffffffu, probe);
    const unsigned belows = __ballot_sync(0xffffffffu, below);
    const int k = __ffs(~belows & probes) - 1;  // the first probe not below
    if (k < 0) {
      a += (__popc(probes) - 1) * step + 1;
    } else {
      b = a + k * step;
      if (k > 0) a += (k - 1) * step + 1;
    }
  }
  return a;
}

// A row's slot windows each hold a term's postings, docs ascending (the
// pack sorts postings per term), so the reference's stable sort of the
// row's lanes by doc is a merge of T sorted runs in which equal docs keep
// slot order. A row of more lanes than a window (S, the launch's shared
// memory) is cut into P parts by doc, part q the docs [q * d_pad / P,
// (q + 1) * d_pad / P) (the last one up), each slot's share of a part
// found by a binary search of its docs, and each part takes its own
// block: block r is part 0 of row r, block R + e the part part_rq[e]
// (row | part << 16). A part is merged in windows of at most S lanes (a
// row of one part in one): each window stages, from every slot with
// lanes left, its lanes left or, when they do not fit, its next lanes (S
// shared among the slots), decoded to items in one flat pass (each
// thread a few lanes, the slot found by a search over the staged prefix,
// every doc and rank load of a batch before its residual loads), and
// takes every staged lane whose doc is below D1, the least first
// unstaged doc of any slot (d_pad at most). So no doc's lanes straddle
// two windows or parts, and each window is complete: its taken lanes, T
// sorted runs, are merged pairwise along their merge paths (merge_runs),
// then emit_runs writes the window's candidates in doc order: part 0 to
// the row's candidates, a later part packed in `parked` at its first
// lane (exact_finish moves them). Every staged pair of neighbouring lanes,
// the last staged lane against the slot's next one and the lane before a
// part's start against it are checked: a slot whose docs descend (a
// window clamped to the end of the stream reads another term's postings)
// marks its row `bad`, and exact_finish redoes it whole. Lanes clamped to
// d_pad never reach a candidate (they sort last and a run of d_pad is
// dropped). 256 threads, their registers bounded so that six blocks
// share an SM when their windows fit (2048 lanes, 33 KB each). kRaw: the
// raw merge, the same design over a raw pack's int32 docs and f32
// impacts (docs up to 2**31, which the items' 32 doc bits hold).
// Wide rows: the slot table lives in shared memory while it fits beside
// the windows; past that (`tables` given) each block keeps it in its own
// slice of device memory and the grid, one block per table slice, walks
// the n_blocks rows and parts. A row of more slots than S (a window
// stages a lane of every slot) goes whole to exact_finish's radix class.
template <bool kRaw, int kDepth>
__global__ void __launch_bounds__(kExactThreads, kExactBlocksPerSm)
exact_merge_kernel(Streams s, Slots p, const long long* row_off,
                   const int* part_rq, const int* row_parts, int R,
                   int with_counts, int window, int S, float* cand_score,
                   int* cand_doc, int* n_cand, unsigned long long* parked,
                   int* part_found, int* part_base, int* bad,
                   int* class_rows, int n_blocks,
                   unsigned long long* tables, long long tab_words) {
  extern __shared__ __align__(16) unsigned long long s_dyn[];
  __shared__ int s_wsum[8];
  __shared__ int s_warp[33];
  __shared__ int s_d1;
  __shared__ int s_more;
  const int T = p.T;
  const int tid = threadIdx.x;
  const int d_pad = p.d_pad;
  unsigned long long* s_src = s_dyn;
  unsigned long long* s_dst = s_dyn + S;
  const ExactTable tb = exact_table(
      tables != nullptr ? tables + blockIdx.x * tab_words : s_dyn + 2 * S,
      T);
  for (int vb = blockIdx.x; vb < n_blocks; vb += gridDim.x) {
  __syncthreads();  // the previous row's table and windows are spent
  const bool first = vb < R;
  const int e = first ? 0 : vb - R;
  const int r = first ? vb : part_rq[e] & 0xFFFF;
  const int q = first ? 0 : part_rq[e] >> 16;
  const int P = row_parts[r];
  const bool fits = T <= S;
  if (fits) load_slot_table<kRaw>(s, p, tb, r);
  __syncthreads();
  // the part's lanes of each slot: [cur, len) between the binary searches
  // of its doc bounds (monotone in the bound even where docs descend, so
  // the parts of a slot tile it); the lane before the start is checked
  bool bad_here = !fits;
  if (fits && P > 1) {
    const int d_lo = (int)((long long)q * d_pad / P);
    const int d_hi = (int)((long long)(q + 1) * d_pad / P);
    // a warp a search: slot t's lower (item 2t) and upper (2t + 1) bound,
    // parked in chunk and take
    const int nwarps = blockDim.x >> 5;
    for (int item = tid >> 5; item < 2 * T; item += nwarps) {
      const int t = item >> 1;
      const bool upper = item & 1;
      if (upper ? q + 1 < P : q > 0) {
        const int at =
            warp_lower_bound<kRaw>(s, p, tb, t, upper ? d_hi : d_lo);
        if ((tid & 31) == 0) (upper ? tb.take : tb.chunk)[t] = at;
      }
    }
    __syncthreads();
    for (int t = tid; t < T; t += blockDim.x) {
      const int lo = q > 0 ? tb.chunk[t] : 0;
      const int hi = q + 1 < P ? max(lo, tb.take[t]) : tb.len[t];
      if (lo > 0 && lo < tb.len[t]) {
        const int b = lane_doc<kRaw>(s, p, tb, t, lo);
        bad_here |= b < d_pad && lane_doc<kRaw>(s, p, tb, t, lo - 1) >= b;
      }
      tb.cur[t] = lo;
      tb.len[t] = hi;
    }
  }
  bool radix = __syncthreads_or(bad_here);
  int lanes_before = 0;  // the row's lanes of the parts before this one
  if (q > 0 && !radix) {
    int mine = 0;
    for (int t = tid; t < T; t += blockDim.x) mine += tb.cur[t];
    block_excl_scan(mine, s_warp, &lanes_before);
  }
  const long long off = row_off[r];
  const int need = with_counts ? p.min_count[r] : 0;
  int found = 0;
  while (!radix) {
    // 1. every slot's share of the window: all its lanes left when they
    // fit (a row of one part: one window); else S over the slots with
    // lanes left, then what the short ones leave over the long ones (one
    // scan of the slots' lanes below the share and, from bit 20, the
    // slots above it: at most S and T)
    int left = 0, active = 0, total = 0;
    for (int t = tid; t < T; t += blockDim.x) {
      left += tb.len[t] - tb.cur[t];
      active += tb.len[t] > tb.cur[t];
    }
    block_excl_scan(left, s_warp, &total);
    if (total == 0) break;
    int share = S, extra = 0;
    if (total > S) {
      block_excl_scan(active, s_warp, &active);
      share = max(1, S / active);
      int packed = 0, sums = 0;
      for (int t = tid; t < T; t += blockDim.x) {
        const int rem = tb.len[t] - tb.cur[t];
        packed += min(rem, share) + (rem > share ? 1 << 20 : 0);
      }
      block_excl_scan(packed, s_warp, &sums);
      const int used = sums & ((1 << 20) - 1), n_big = sums >> 20;
      extra = n_big > 0 ? (S - used) / n_big : 0;
    }
    for (int t = tid; t < T; t += blockDim.x)
      tb.chunk[t] = min(tb.len[t] - tb.cur[t], share + extra);
    if (tid == 0) {
      s_d1 = d_pad;
      s_more = 0;
    }
    const int staged = slot_scan(tb.chunk, tb.cpre, T, s_warp);
    // 2. stage the chunks; each slot's next unstaged doc bounds D1 (read
    // into the table's `take`, free until step 4, by the thread that
    // owns the slot there)
    for (int t = tid; t < T; t += blockDim.x) {
      const bool has = tb.cur[t] + tb.chunk[t] < tb.len[t];
      tb.take[t] = has ? lane_doc<kRaw>(s, p, tb, t, tb.cur[t] + tb.chunk[t])
                       : kNoNext;
    }
    stage_items<kRaw>(s, p, tb, tb.cpre, tb.cur, staged, s_src);
    for (int t = tid; t < T; t += blockDim.x) {
      if (tb.take[t] != kNoNext) {
        atomicMin(&s_d1, tb.take[t]);
        s_more = 1;
      }
    }
    __syncthreads();
    // 3. the ascent check: neighbours in a chunk, and the chunk's last
    // lane against the slot's next
    bool descends = false;
    for (int i = tid; i < staged; i += blockDim.x) {
      const int t = slot_of(tb.cpre, T, i);
      if (i > tb.cpre[t]) {
        const int b = item_doc(s_src[i]);
        descends |= b < d_pad && item_doc(s_src[i - 1]) >= b;
      }
    }
    for (int t = tid; t < T; t += blockDim.x) {
      if (tb.chunk[t] > 0 && tb.take[t] < d_pad)
        descends |= item_doc(s_src[tb.cpre[t + 1] - 1]) >= tb.take[t];
    }
    radix = __syncthreads_or(descends);
    if (radix) break;
    // 4. each slot takes its staged lanes below D1; with D1 = d_pad no
    // lane below d_pad is left unstaged, and every staged lane is taken
    // (those of d_pad go last and make no candidate)
    const int d1 = s_d1;
    for (int t = tid; t < T; t += blockDim.x)
      tb.take[t] = d1 >= d_pad ? tb.chunk[t]
                               : docs_below(s_src, tb.cpre[t],
                                            tb.cpre[t + 1], d1);
    const int taken = slot_scan(tb.take, tb.tpre, T, s_warp);
    // 5. the merge: each slot's taken lanes, a run from cpre, stably
    unsigned long long* merged =
        merge_runs(s_src, s_dst, tb.tpre, tb.cpre, T, taken);
    // 6. the window's run ends; the cursors move on
    emit_runs<kDepth>(merged, taken, window, with_counts, need, d_pad,
              merged == s_src ? s_dst : s_src, cand_score + off,
              cand_doc + off,
              q > 0 ? parked + off + lanes_before : nullptr, &found,
              s_warp);
    const bool more = s_more;
    for (int t = tid; t < T; t += blockDim.x) tb.cur[t] += tb.take[t];
    __syncthreads();
    if (!more && d1 >= d_pad) break;  // every lane was staged and taken
  }
  if (tid == 0) {
    part_found[vb] = found;
    part_base[vb] = lanes_before;
    if (radix) {
      bad[r] = 1;
    } else if (P == 1) {
      n_cand[r] = found;
      if (class_rows != nullptr) atomicAdd(&class_rows[kExactMerge], 1);
    }
  }
  }
}

// What exact_merge leaves (grid R + the later parts, 256 threads): block
// r redoes row r whole when it is bad, every lane in lane order, stable
// LSD passes of sort_pass on the doc's bytes below d_pad in device memory
// (items, alt: two for a compressed pack's 16-bit docs, three for a raw
// pack of up to 2**24), then the run ends (class "radix"); block R + e
// moves the parked candidates of the later part part_rq[e] of a good row
// after those of the row's earlier parts (part_rq holds a row's parts in
// order), and the last part writes the row's count (class "parts").
template <bool kRaw, int kDepth>
__global__ void __launch_bounds__(kExactThreads)
exact_finish_kernel(Streams s, Slots p, const long long* row_off,
                    const int* part_rq, const int* row_parts, int R,
                    int with_counts, int window, const int* part_found,
                    const int* part_base, const int* bad,
                    unsigned long long* items, unsigned long long* alt,
                    float* cand_score, int* cand_doc, int* n_cand,
                    int* class_rows, int n_blocks,
                    unsigned long long* tables, long long tab_words) {
  extern __shared__ __align__(16) unsigned long long s_tab[];
  __shared__ int s_cnt[kExactWarps][256];
  __shared__ int s_wsum[8];
  __shared__ int s_warp[33];
  const ExactTable tb = exact_table(
      tables != nullptr ? tables + blockIdx.x * tab_words : s_tab, p.T);
  for (int vb = blockIdx.x; vb < n_blocks; vb += gridDim.x) {
  __syncthreads();  // the previous row's table and counts are spent
  if (vb >= R) {
    const int e = vb - R;
    const int r = part_rq[e] & 0xFFFF, q = part_rq[e] >> 16;
    if (bad[r]) continue;
    int at = part_found[r];  // part 0
    for (int j = e - q + 1; j < e; ++j) at += part_found[R + j];
    const int m = part_found[R + e];
    const long long off = row_off[r];
    const unsigned long long* src = alt + off + part_base[R + e];
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const unsigned long long c = src[j];
      cand_score[off + at + j] = __uint_as_float((uint32_t)(c >> 32));
      cand_doc[off + at + j] = (int)(uint32_t)c;
    }
    if (threadIdx.x == 0 && q + 1 == row_parts[r]) {
      n_cand[r] = at + m;
      if (class_rows != nullptr) atomicAdd(&class_rows[kExactParts], 1);
    }
    continue;
  }
  const int r = vb;
  if (!bad[r]) continue;
  load_slot_table<kRaw>(s, p, tb, r);
  for (int i = threadIdx.x; i < kExactWarps * 256; i += blockDim.x)
    (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const int n = slot_scan(tb.len, tb.lpre, p.T, s_warp);
  const long long off = row_off[r];
  unsigned long long* src = items + off;
  unsigned long long* dst = alt + off;
  stage_items<kRaw>(s, p, tb, tb.lpre, nullptr, n, src);
  __syncthreads();
  const int doc_bits = 32 - __clz((unsigned)p.d_pad);
  for (int shift = 32; shift < 32 + doc_bits && n > 1; shift += 8) {
    if (sort_pass<unsigned long long, kExactWarps>(src, dst, n, shift, s_cnt,
                                                    s_wsum)) {
      unsigned long long* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
  int found = 0;
  emit_runs<kDepth>(src, n, window, with_counts,
                    with_counts ? p.min_count[r] : 0, p.d_pad, dst,
                    cand_score + off, cand_doc + off, nullptr, &found,
                    s_warp);
  if (threadIdx.x == 0) {
    n_cand[r] = found;
    if (class_rows != nullptr) atomicAdd(&class_rows[kExactRadix], 1);
  }
  }
}

// Lets fn take `bytes` of dynamic shared memory: past the 48 KB that
// every kernel may take, the attribute is raised (it is never lowered in
// this source, so a smaller launch needs no call).
template <typename F>
cudaError_t allow_smem(F fn, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// A shard_topk launch over rows of at most n_max values: the finalists
// of its largest row (count), their sort (sort_n), whether a row may take
// the device class, the finalist slots of the per-row kernel's shared
// memory (none when every row is of the device class) and the values it
// stages there (a select runs only over a row wider than kk).
struct TopkPlan {
  int count, sort_n, fin_cap, stage;
  bool device;
};

TopkPlan topk_plan(int n_max, int kk, int sort_cap, int stage_cap,
                   bool has_row_n) {
  TopkPlan t;
  t.count = n_max < kk ? n_max : kk;
  t.sort_n = 1;
  while (t.sort_n < t.count) t.sort_n <<= 1;
  t.device = t.sort_n > sort_cap;
  t.fin_cap = t.device ? (has_row_n ? sort_cap : 0) : t.sort_n;
  t.stage = n_max > kk && t.fin_cap > 0
                ? (n_max < stage_cap ? n_max : stage_cap) : 0;
  return t;
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
  s.docs32 = nullptr;
  s.imps = nullptr;
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


// ---------------------------------------------------------------------------
// 8. pruned_candidates: phase A of a pruned tier, one group of pack rows
// ---------------------------------------------------------------------------

// Replaces the reference's make_pruned_search phase A, one_group
// (elasticsearch_tpu/parallel/distributed.py:971). Query b's slots are G
// rows x T slots of the impact-sorted copy (rows[b * GT + j]: slot j's
// device-local pack row), so a slot's lanes are in impact order, not doc
// order: there are no runs to merge, and the lanes are sorted. Every
// valid lane (j < len of its slot) is one u64 item: its key in the high
// 32 bits, the bits of w * impact (rounded) below. The key is the gid
// row * (d_pad + 1) + doc less key_base (the gid of the launch's lowest
// row's doc 0), or with pack_keys the reference's u32 key ((gid -
// key_base) << 16 | the value's 16-bit code, key_base then the group's
// first slot's row, as the reference's group-relative gid), the value
// its decoded code. The order is
// a stable one by key (a lane whose gid equals another's stays in
// slot-then-lane order, as the reference's stable sort keeps it; with
// pack_keys equal keys are equal items); then each run's total by the
// reference's doubling tree (t_window), the runs with total > 0 as
// candidates in gid order, whose top-k shard_topk then takes. Invalid
// lanes are not staged: in the reference they carry doc d_pad and
// impact 0, so their runs are never candidates.
//
// Bound: bytes, each valid lane's doc and impact read once, each
// candidate written once. The design keeps every sort pass in shared
// memory and spreads a query over many blocks, two launches:
//
//   cand_part   a block per part_lanes lanes of a query: its lanes read
//               once from the streams, partitioned stably by band (the
//               key's bits above the query's `shift`) in shared memory,
//               written back in band order with each band's start;
//   cand_band   a block per band of a query: the band's pieces from every
//               part, in part order (so lane order), staged in shared
//               memory and sorted there by the key bits below the band
//               (stable LSD passes of sort_pass); the run sums; the
//               band's candidates after those of the query's earlier
//               bands, found by a decoupled look-back over them.
//
// A run never crosses a band: its lanes share a gid, so its key bits
// above `shift` (with pack_keys, shift >= 16: above the code). The
// wrapper picks each query's shift so that a band holds about half of
// `cap` items; a band that holds more is sorted in device memory
// (class cand.device). A query of at most the shared cap takes one
// band block that reads its lanes from the streams itself and no part
// block (class cand.shared). The plan (each query's shift, bands, parts
// and blocks) comes from the wrapper, which reads each query's lane
// count and the rows' bounds once on the host to make it and to size
// the buffers; no other host read.
constexpr int kCandThreads = 256;
constexpr int kCandWarps = kCandThreads / 32;
enum { kCandShared = 0, kCandBands, kCandDevice, kCandClasses };

struct CandArgs {
  const int* docs32;
  const float* imps;
  long long n_post;
  const int* starts;     // [B, GT]
  const int* lengths;    // [B, GT]
  const float* weights;  // [B, GT]
  const int* rows;       // [B, GT]
  int GT, max_len, d_pad, pack_keys, window, cap, part_lanes;
  long long key_base;
  // the wrapper's plan: row_off [B + 1] (a query's slice of the lane
  // buffers), qinfo [B][4] (shift, bands, parts, its first band start in
  // bstart), the part blocks' and the band blocks' (query | index << 32)
  const long long* row_off;
  const long long* qinfo;
  const long long* part_tiles;
  const long long* band_tiles;
  unsigned long long* items;  // the parts' items, band by band
  unsigned long long* alt;    // a device-class band's items and its
  unsigned long long* alt2;   // pass buffer, at the band's start
  int* bstart;     // per part of a query: its bands' starts, bands + 1
  unsigned long long* status;  // per band block: the look-back word
  float* cand_score;
  int* cand_gid;
  int* n_cand;
  int* class_rows;
};

// A query's slot table in shared memory: the clamped window starts, the
// weights, the rows and the prefix of the lane counts (pre[GT] = lanes).
struct CandTable {
  long long* eff;
  float* w;
  int* row;
  int* pre;
};

__host__ __device__ __forceinline__ int cand_table_bytes(int GT) {
  return 8 * GT + 4 * GT + 4 * GT + 4 * (GT + 1);
}

__device__ __forceinline__ CandTable cand_table(void* base, int GT) {
  CandTable tb;
  tb.eff = static_cast<long long*>(base);
  tb.w = reinterpret_cast<float*>(tb.eff + GT);
  tb.row = reinterpret_cast<int*>(tb.w + GT);
  tb.pre = tb.row + GT;
  return tb;
}

// Stages query b's slot table (all threads) → its lanes.
__device__ int load_cand_table(const CandArgs& a, const CandTable& tb,
                               int b, int* s_warp) {
  for (int j = threadIdx.x; j < a.GT; j += blockDim.x) {
    const long long rj = (long long)b * a.GT + j;
    tb.eff[j] = clampll(a.starts[rj], 0, a.n_post - a.max_len);
    tb.pre[j] = min(max(a.lengths[rj], 0), a.max_len);
    tb.w[j] = a.weights[rj];
    tb.row[j] = a.rows[rj];
  }
  __syncthreads();
  return slot_scan(tb.pre, tb.pre, a.GT, s_warp);  // in place
}

// The items of the query's lanes lo .. lo + m - 1 into out[0 .. m), four
// lanes a thread at a time: their doc and impact loads first, then the
// keys, so the loads' round trips overlap.
constexpr int kCandBatch = 4;
__device__ void stage_cand_items(const CandArgs& a, const CandTable& tb,
                                 int lo, int m, unsigned long long* out) {
  const long long d1 = (long long)a.d_pad + 1;
  for (int i0 = threadIdx.x; i0 < m; i0 += kCandBatch * blockDim.x) {
    int slot[kCandBatch], doc[kCandBatch];
    float imp[kCandBatch];
#pragma unroll
    for (int u = 0; u < kCandBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      slot[u] = 0;
      doc[u] = 0;
      imp[u] = 0.0f;
      if (i < m) {
        slot[u] = slot_of(tb.pre, a.GT, lo + i);
        const long long pos = tb.eff[slot[u]] + lo + i - tb.pre[slot[u]];
        doc[u] = a.docs32[pos];
        imp[u] = a.imps[pos];
      }
    }
#pragma unroll
    for (int u = 0; u < kCandBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= m) continue;
      const int j = slot[u];
      const uint32_t v = __float_as_uint(__fmul_rn(tb.w[j], imp[u]));
      const long long gid = (long long)tb.row[j] * d1 + doc[u];
      if (a.pack_keys) {
        const long long grel = gid > a.key_base ? gid - a.key_base : 0;
        const uint32_t key = ((uint32_t)grel << 16) | (v >> 16);
        out[i] = ((unsigned long long)key << 32) | ((v >> 16) << 16);
      } else {
        out[i] = ((unsigned long long)(uint32_t)(gid - a.key_base) << 32) |
                 v;
      }
    }
  }
}

__device__ __forceinline__ int cand_band(unsigned long long it, int shift) {
  return (int)((it >> 32) >> shift);
}

// One block per part of a banded query (part_tiles): its lanes in shared
// memory, stable LSD passes of sort_pass over the band bits, the items
// out in band order to the part's slice of `items`, and each band's
// start within the part (bands + 1 of them) to bstart.
__global__ void __launch_bounds__(kCandThreads)
cand_part_kernel(CandArgs a) {
  extern __shared__ __align__(16) unsigned long long s_cand[];
  __shared__ int s_cnt[kCandWarps][256];
  __shared__ int s_wsum[8];
  __shared__ int s_warp[33];
  const long long tile = a.part_tiles[blockIdx.x];
  const int b = (int)(tile & 0xFFFFFFFFll), p = (int)(tile >> 32);
  const long long* q = a.qinfo + 4 * (long long)b;
  const int shift = (int)q[0], nb = (int)q[1];
  unsigned long long* src = s_cand;
  unsigned long long* dst = s_cand + a.part_lanes;
  const CandTable tb = cand_table(s_cand + 2 * a.part_lanes, a.GT);
  for (int i = threadIdx.x; i < kCandWarps * 256; i += blockDim.x)
    (&s_cnt[0][0])[i] = 0;
  const int n = load_cand_table(a, tb, b, s_warp);
  const int lo = min(n, p * a.part_lanes);
  const int m = min(n - lo, a.part_lanes);
  stage_cand_items(a, tb, lo, m, src);
  __syncthreads();
  const int band_bits = 32 - __clz((unsigned)(nb - 1));
  for (int sh = 32 + shift; sh < 32 + shift + band_bits && m > 1; sh += 8) {
    if (sort_pass<unsigned long long, kCandWarps>(src, dst, m, sh, s_cnt,
                                                   s_wsum)) {
      unsigned long long* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
  unsigned long long* out = a.items + a.row_off[b] + lo;
  for (int i = threadIdx.x; i < m; i += blockDim.x) out[i] = src[i];
  int* bs = a.bstart + q[3] + (long long)p * (nb + 1);
  for (int c = threadIdx.x; c <= nb; c += blockDim.x) {
    int l = 0, h = m;  // the first item of a band >= c
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (cand_band(src[mid], shift) < c) l = mid + 1;
      else h = mid;
    }
    bs[c] = l;
  }
}

// One block per band of a query (band_tiles; a shared-class query: one
// block, its lanes from the streams): the band's items sorted, in shared
// memory or (more than cap) in device memory, the run sums, and the
// band's candidates placed after those of the query's earlier bands
// (look-back word: bits 0-30 candidates, 31-61 device-class bands, as
// run_sum's). The query's last band writes its count and class.
__global__ void __launch_bounds__(kCandThreads)
cand_band_kernel(CandArgs a) {
  constexpr int kWarps = kCandWarps;
  extern __shared__ __align__(16) unsigned long long s_cand[];
  __shared__ int s_cnt[kWarps][256];
  __shared__ int s_wsum[8];
  __shared__ int s_warp[33];
  __shared__ long long s_before;
  const long long tile = a.band_tiles[blockIdx.x];
  const int b = (int)(tile & 0xFFFFFFFFll), c = (int)(tile >> 32);
  const long long* q = a.qinfo + 4 * (long long)b;
  const int shift = (int)q[0], nb = (int)q[1], np = (int)q[2];
  const long long off = a.row_off[b];
  unsigned long long* src = s_cand;
  unsigned long long* dst = s_cand + a.cap;
  for (int i = threadIdx.x; i < kWarps * 256; i += blockDim.x)
    (&s_cnt[0][0])[i] = 0;
  int n = 0;
  bool device = false;
  if (np == 0) {  // the shared class: the query's lanes from the streams
    const CandTable tb = cand_table(s_cand + 2 * a.cap, a.GT);
    n = load_cand_table(a, tb, b, s_warp);
    stage_cand_items(a, tb, 0, n, src);
  } else {
    // the band's piece of each part: from pst[p], ppre[p] before it
    int* pst = reinterpret_cast<int*>(s_cand + 2 * a.cap);
    int* ppre = pst + np;
    const int* bs = a.bstart + q[3];
    for (int p = threadIdx.x; p < np; p += blockDim.x) {
      const int s0 = bs[(long long)p * (nb + 1) + c];
      pst[p] = s0;
      ppre[p] = bs[(long long)p * (nb + 1) + c + 1] - s0;
    }
    n = slot_scan(ppre, ppre, np, s_warp);  // in place
    device = n > a.cap;
    if (device) {  // at the band's start in the query's band order
      int starts_below = 0, below = 0;
      for (int p = threadIdx.x; p < np; p += blockDim.x)
        starts_below += pst[p];
      block_excl_scan(starts_below, s_warp, &below);
      src = a.alt + off + below;
      dst = a.alt2 + off + below;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = slot_of(ppre, np, i);
      src[i] = a.items[off + (long long)p * a.part_lanes + pst[p] + i -
                       ppre[p]];
    }
  }
  __syncthreads();
  for (int sh = 32; sh < 32 + shift && n > 1; sh += 8) {
    if (sort_pass<unsigned long long, kWarps>(src, dst, n, sh, s_cnt, s_wsum)) {
      unsigned long long* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
  if (a.pack_keys) {  // the key's relative gid back in the high word
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned long long it = src[i];
      src[i] = ((it >> 48) << 32) | (uint32_t)it;
    }
    __syncthreads();
  }
  int lo = 0;
  const int kept =
      park_runs<kRunStack>(src, n, a.window, 0, 0, 0x7fffffff, dst, &lo);
  int found = 0;
  const int at = block_excl_scan(kept, s_warp, &found);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned long long own =
        (unsigned long long)found | ((unsigned long long)device << 31);
    volatile unsigned long long* sts = a.status;
    const long long t = blockIdx.x;
    unsigned long long before = 0;
    if (c > 0) {  // the query's earlier bands, 32 at a time
      if (lane == 0) sts[t] = kOwnCounts | own;
      for (int top = c - 1;; top -= 32) {
        const int cc = top - lane;
        unsigned long long w = kRowCounts;
        if (cc >= 0)
          while ((w = sts[t - (c - cc)]) == 0ull) __nanosleep(32);
        const unsigned incl =
            __ballot_sync(0xffffffffu, (w & ~kCountBits) == kRowCounts);
        const int last = incl ? __ffs(incl) - 1 : 31;
        unsigned long long v = lane <= last ? (w & kCountBits) : 0ull;
        for (int d = 16; d > 0; d >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, d);
        before += v;
        if (incl) break;
      }
    }
    if (lane == 0) {
      const unsigned long long all = before + own;
      if (nb > 1) sts[t] = kRowCounts | all;
      if (c == nb - 1) {
        a.n_cand[b] = (int)(all & 0x7FFFFFFFull);
        if (a.class_rows != nullptr)
          atomicAdd(&a.class_rows[np == 0 ? kCandShared
                                  : (all >> 31) ? kCandDevice
                                                : kCandBands],
                    1);
      }
      s_before = (long long)(before & 0x7FFFFFFFull);
    }
  }
  __syncthreads();
  const long long out = off + s_before + at;
  for (int j = 0; j < kept; ++j) {
    const unsigned long long cv = dst[lo + j];
    a.cand_score[out + j] = __uint_as_float((uint32_t)(cv >> 32));
    a.cand_gid[out + j] = (int)((long long)(uint32_t)cv + a.key_base);
  }
}

// Dynamic shared memory of the two launches: the items and the pass
// buffer, then the slot table (part blocks, shared-class band blocks) or
// the band's pieces of the query's parts (banded band blocks).
__host__ __device__ __forceinline__ int cand_part_smem(int GT,
                                                       int part_lanes) {
  return 16 * part_lanes + cand_table_bytes(GT);
}

__host__ __device__ __forceinline__ int cand_band_smem(int GT, int cap,
                                                       int p_max,
                                                       int has_shared) {
  const int table = has_shared ? cand_table_bytes(GT) : 0;
  const int parts = p_max > 0 ? 8 * p_max + 4 : 0;
  return 16 * cap + (table > parts ? table : parts);
}

// ---------------------------------------------------------------------------
// 9. pruned_rescore: phase B of a pruned tier, and its final order
// ---------------------------------------------------------------------------

// Replaces the reference's phase B and final order
// (elasticsearch_tpu/parallel/distributed.py:1052-1108). Mode bits: 1
// scores, 2 orders. Scoring: each of query b's C candidate gids (phase
// A's, global) whose row lies in this device's [row_base, row_base +
// S_l) gets, for each of its row's T_terms term ranges, a lower-bound
// binary search of search_iters steps in the doc-sorted docs (the
// reference's loop as it is: no early stop, reads past the array give
// d_pad) and w * impact where the doc is found, summed over the terms by
// shuffles in the reference's association (halving: x_t + x_(t + T/2),
// then the halves again: for 8 terms ((x0 + x4) + (x2 + x6)) + ((x1 +
// x5) + (x3 + x7))). Ordering: -inf where the candidate was
// (cand_vals), each candidate one u64 key (order bits of -score, +inf
// for -inf, then the gid; -0 before +0 as the reference's float sort has
// it), sorted, the first k out. A device that holds every row of the
// query does both in one call; else each device scores (exact_out), the
// sum over the devices comes in between, and one call orders.
//
// Bound: bytes, each candidate's gid and score read once, each (candidate,
// term)'s range and weight, its search_iters probes and its impact, the
// first k written; but the searches' probes are dependent loads, so
// latency bounds it: every search has to be in flight at once. The
// design: rescore_score spreads a query's candidates over blocks of 256 /
// T_terms candidates (grid chunks x B), a thread a (candidate, term)
// walking the loop's search_iters steps in device memory, its scores to
// exact_out; rescore_order, a block of 512 threads a query, sorts the
// (-score, gid) keys in shared memory: groups of 64 in a warp's
// registers by bitonic stages (shuffles), then merge-path levels, one
// barrier a level (sort_desc_merge). A score-and-order call is the two
// launches. 512 order threads: the least device time of 256, 512 and
// 1,024 on the raw deployment's order calls (tools/kernel_ab.py --raw).
constexpr int kRescoreThreads = 256;
constexpr int kOrderThreads = 512;
constexpr int kRescoreCands = 4096;  // PRUNED_CAND_LIMIT

__device__ __forceinline__ uint32_t sort_order_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float sort_order_inverse(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

struct RescoreArgs {
  const int* docs32;   // [S_l * p_pad] doc-sorted docs
  const float* imps;
  long long n_post;
  const long long* cand_gids;  // [B, C]
  int C;
  const int* t_starts;    // [S_l, B, T_terms]
  const int* t_lengths;
  const float* t_weights;
  int S_l, B, T_terms, d_pad;
  long long p_pad;
  int row_base, search_iters;
  const float* exact_in;   // [B, C]: order-only calls
  const float* cand_vals;  // [B, C]
  float* exact_out;        // [B, C]
  int kk;
  float* out_vals;         // [B, kk]
  long long* out_gids;
};

// Candidate c's term t of query b: w * impact where the search finds its
// doc, else 0.
__device__ __forceinline__ float score_lane(const RescoreArgs& a, int b,
                                            int c, int t) {
  const int T = a.T_terms;
  const long long d1 = (long long)a.d_pad + 1;
  const int gid = (int)a.cand_gids[(long long)b * a.C + c];
  const long long row = (long long)gid / d1;
  const int ord = (int)((long long)gid - row * d1);
  const long long local = row - a.row_base;
  const bool in_local = local >= 0 && local < a.S_l;
  const long long lr = local < 0 ? 0 : (local >= a.S_l ? a.S_l - 1 : local);
  const long long at = (lr * a.B + b) * T + t;
  const int ln = a.t_lengths[at];
  long long lo = lr * a.p_pad + a.t_starts[at];
  long long hi = lo + ln;
  const long long end = hi;
  for (int it = 0; it < a.search_iters; ++it) {
    const long long mid = (lo + hi) >> 1;
    const int v = (mid >= 0 && mid < a.n_post) ? a.docs32[mid] : a.d_pad;
    const bool go = v < ord;
    lo = go ? mid + 1 : lo;
    hi = go ? hi : mid;
  }
  const bool inside = lo >= 0 && lo < a.n_post;
  const int v = inside ? a.docs32[lo] : a.d_pad;
  const bool found = ln > 0 && v == ord && lo < end;
  return found && in_local
             ? __fmul_rn(a.t_weights[at], inside ? a.imps[lo] : 0.0f)
             : 0.0f;
}

// Lane L (candidate L / T, term L % T) of query b scored and summed over their terms by shuffles in the
// reference's association (a candidate's T lanes are neighbours in a
// warp) → the sum, at the candidate's first lane (else meaningless).
__device__ __forceinline__ float score_sum(const RescoreArgs& a, int b,
                                           int L) {
  const int T = a.T_terms;
  const int c = L / T, t = L % T;
  float x = c < a.C ? score_lane(a, b, c, t) : 0.0f;
  for (int h = T >> 1; h > 0; h >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, x, h);
    if (t < h) x = __fadd_rn(x, o);
  }
  return x;
}

// Sorts n keys (a power of two, at least 64) descending in shared
// memory: each warp's groups of 64 in registers by bitonic stages, as
// bitonic_warp runs them but every group descending (shuffles, no
// barrier), then merge levels of runs of 64,
// 128, ... between a and b, one barrier a level: a thread takes a few
// consecutive outputs of a pair of runs, finds where the first comes
// from by one binary search along the merge path, and merges on (equal
// keys: the first run's first). Returns the buffer that holds the
// result.
__device__ unsigned long long* sort_desc_merge(unsigned long long* a,
                                               unsigned long long* b,
                                               int n) {
  const int lane = threadIdx.x & 31;
  for (int g = (threadIdx.x >> 5) * 64; g < n; g += (blockDim.x >> 5) * 64) {
    const int e0 = 2 * lane;  // within the group: every group descending
    unsigned long long x0 = a[g + e0], x1 = a[g + e0 + 1];
    for (int sz = 2; sz <= 64; sz <<= 1) {
      for (int half = sz >> 1; half > 0; half >>= 1) {
        if (half == 1) {
          const unsigned long long y0 = bitonic_keep(x0, x1, e0, 1, sz);
          x1 = bitonic_keep(x1, x0, e0 + 1, 1, sz);
          x0 = y0;
        } else {
          const int m = half >> 1;
          const unsigned long long o0 = __shfl_xor_sync(0xffffffffu, x0, m);
          const unsigned long long o1 = __shfl_xor_sync(0xffffffffu, x1, m);
          x0 = bitonic_keep(x0, o0, e0, half, sz);
          x1 = bitonic_keep(x1, o1, e0 + 1, half, sz);
        }
      }
    }
    a[g + e0] = x0;
    a[g + e0 + 1] = x1;
  }
  __syncthreads();
  const int per = (n + blockDim.x - 1) / blockDim.x;
  for (int w = 64; w < n; w <<= 1) {
    const int o0 = threadIdx.x * per;
    if (o0 < n) {
      const int g = o0 / (2 * w), rel = o0 - g * 2 * w;
      const unsigned long long* A = a + g * 2 * w;
      const unsigned long long* B = A + w;
      int lo = max(0, rel - w), hi = min(rel, w);
      while (lo < hi) {  // A's share of the first rel outputs
        const int mid = (lo + hi) >> 1;
        if (A[mid] >= B[rel - mid - 1]) lo = mid + 1;
        else hi = mid;
      }
      int i = lo, j = rel - lo;
      for (int o = o0; o < o0 + per; ++o) {
        const bool take_a = j >= w || (i < w && A[i] >= B[j]);
        b[o] = take_a ? A[i++] : B[j++];
      }
    }
    __syncthreads();
    unsigned long long* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Query b's order: each candidate's key from cand_vals, its score
// (`exact`, row b's) and gid, sorted in s_order (2 x sort_n u64), the
// first kk out.
__device__ __forceinline__ int order_sort_n(int C) {
  int sort_n = 64;
  while (sort_n < C) sort_n <<= 1;
  return sort_n;
}

__device__ void order_query(const RescoreArgs& a, int b, const float* exact,
                            unsigned long long* s_order) {
  const int sort_n = order_sort_n(a.C);
  const float neg_inf = __int_as_float(kNegInfBits);
  const float pos_inf = __int_as_float(0x7f800000);
  for (int c = threadIdx.x; c < sort_n; c += blockDim.x) {
    unsigned long long key = ~0ull;  // past every candidate
    if (c < a.C) {
      const long long at = (long long)b * a.C + c;
      const float v = a.cand_vals[at];
      const float e = v > neg_inf ? exact[c] : neg_inf;
      const float neg = e > neg_inf ? -e : pos_inf;
      key = ((unsigned long long)sort_order_bits(neg) << 32) |
            (uint32_t)a.cand_gids[at];
    }
    s_order[c] = ~key;  // sorted descending
  }
  __syncthreads();
  const unsigned long long* sorted =
      sort_desc_merge(s_order, s_order + sort_n, sort_n);
  for (int j = threadIdx.x; j < a.kk; j += blockDim.x) {
    const unsigned long long key = ~sorted[j];
    const float neg = sort_order_inverse((uint32_t)(key >> 32));
    a.out_vals[(long long)b * a.kk + j] = isinf(neg) ? neg_inf : -neg;
    a.out_gids[(long long)b * a.kk + j] = (long long)(uint32_t)key;
  }
}

// Scores spread over blocks (grid chunks x B): a thread a (candidate,
// term), 256 / T_terms candidates a block.
__global__ void __launch_bounds__(kRescoreThreads)
rescore_score_kernel(RescoreArgs a) {
  const int b = blockIdx.y;
  const int L = blockIdx.x * kRescoreThreads + threadIdx.x;
  const float x = score_sum(a, b, L);
  const int c = L / a.T_terms;
  if (c < a.C && L % a.T_terms == 0)
    a.exact_out[(long long)b * a.C + c] = x;
}

// The order alone: a block a query over exact_in.
__global__ void __launch_bounds__(kOrderThreads)
rescore_order_kernel(RescoreArgs a) {
  extern __shared__ __align__(16) unsigned long long s_order[];
  order_query(a, blockIdx.x, a.exact_in + (long long)blockIdx.x * a.C,
              s_order);
}

__host__ __device__ __forceinline__ int rescore_order_smem(int C) {
  int sort_n = 64;
  while (sort_n < C) sort_n <<= 1;
  return 16 * sort_n;
}

// exact_merge then exact_finish over the lanes of kRaw's reader.
// A launch's merge window: at least one lane of every slot, at most
// kExactMaxItems (a row of more slots takes the radix class).
int exact_window(int window_lanes, int T) {
  const int S = window_lanes > T ? window_lanes : T;
  return S < kExactMaxItems ? S : kExactMaxItems;
}

// Bytes of one block's device-memory slot table, or 0 when the table
// fits in shared memory beside the windows.
long long exact_table_bytes(int window_lanes, int T) {
  const int S = exact_window(window_lanes, T);
  if (exact_smem_bytes(S, T) <= kSmemOptIn) return 0;
  return ((long long)exact_smem_bytes(0, T) + 7) / 8 * 8;
}

template <bool kRaw, int kDepth>
int launch_exact_depth(const Streams& s, const Slots& p, int R,
                       const void* row_off, const void* part_rq,
                       const void* row_parts, int n_extra, int with_counts,
                       int window, int window_lanes, void* items, void* alt,
                       void* cand_score, void* cand_doc, void* n_cand,
                       void* part_found, void* part_base, void* bad,
                       void* class_rows, void* tables, int n_tables,
                       void* stream) {
  const int T = p.T;
  cudaStream_t st = (cudaStream_t)stream;
  const int S = exact_window(window_lanes, T);
  const long long tab_bytes = exact_table_bytes(window_lanes, T);
  const int n_blocks = R + n_extra;
  unsigned long long* tabs = nullptr;
  int grid = n_blocks;
  if (tab_bytes > 0) {  // the tables in device memory, a slice a block
    if (tables == nullptr || n_tables < 1) return (int)cudaErrorInvalidValue;
    tabs = static_cast<unsigned long long*>(tables);
    grid = n_blocks < n_tables ? n_blocks : n_tables;
  }
  const int smem = tabs != nullptr ? 16 * S : exact_smem_bytes(S, T);
  auto merge = exact_merge_kernel<kRaw, kDepth>;
  auto finish = exact_finish_kernel<kRaw, kDepth>;
  cudaError_t err = allow_smem(merge, smem);
  if (err != cudaSuccess) return (int)err;
  merge<<<grid, kExactThreads, smem, st>>>(
      s, p, static_cast<const long long*>(row_off),
      static_cast<const int*>(part_rq), static_cast<const int*>(row_parts),
      R, with_counts, window, S, static_cast<float*>(cand_score),
      static_cast<int*>(cand_doc), static_cast<int*>(n_cand),
      static_cast<unsigned long long*>(alt), static_cast<int*>(part_found),
      static_cast<int*>(part_base), static_cast<int*>(bad),
      static_cast<int*>(class_rows), n_blocks, tabs, tab_bytes / 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int table = tabs != nullptr ? 0 : exact_smem_bytes(0, T);
  err = allow_smem(finish, table);
  if (err != cudaSuccess) return (int)err;
  finish<<<grid, kExactThreads, table, st>>>(
      s, p, static_cast<const long long*>(row_off),
      static_cast<const int*>(part_rq), static_cast<const int*>(row_parts),
      R, with_counts, window, static_cast<const int*>(part_found),
      static_cast<const int*>(part_base), static_cast<const int*>(bad),
      static_cast<unsigned long long*>(items),
      static_cast<unsigned long long*>(alt), static_cast<float*>(cand_score),
      static_cast<int*>(cand_doc), static_cast<int*>(n_cand),
      static_cast<int*>(class_rows), n_blocks, tabs, tab_bytes / 8);
  return (int)cudaGetLastError();
}

// The exact merge's two launches, their run trees as deep as the window.
template <bool kRaw>
int launch_exact(const Streams& s, const Slots& p, int R,
                 const void* row_off, const void* part_rq,
                 const void* row_parts, int n_extra, int with_counts,
                 int window, int window_lanes, void* items, void* alt,
                 void* cand_score, void* cand_doc, void* n_cand,
                 void* part_found, void* part_base, void* bad,
                 void* class_rows, void* tables, int n_tables,
                 void* stream) {
  if (window > kWindowLimit) return (int)cudaErrorInvalidValue;
  auto run = window <= (1 << kRunStack)
                 ? launch_exact_depth<kRaw, kRunStack>
                 : launch_exact_depth<kRaw, kWideRunStack>;
  return run(s, p, R, row_off, part_rq, row_parts, n_extra, with_counts,
             window, window_lanes, items, alt, cand_score, cand_doc, n_cand,
             part_found, part_base, bad, class_rows, tables, n_tables,
             stream);
}


}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes): each launches one kernel on `stream` and returns
// the cudaError_t of the launch.
// ---------------------------------------------------------------------------

extern "C" {

// Bytes of one row's row_pack slot table in device memory, or 0 when it
// stays in shared memory: up to kSoffShared slots. A wider row's table
// is built once (pack_table_kernel) and read by every tile block of the
// row: the skip's term bounds compare every slot with every other, which
// per tile block was most of a wide row's time.
long long es_pack_table_bytes(int T) {
  return T <= kSoffShared ? 0 : pack_table_words(T) * (long long)sizeof(int);
}

// Slots whose prefix select_rescore keeps in static shared memory; a
// launch of more takes a device-memory prefix of R * (T + 1) ints.
int es_soff_shared() { return kSoffShared; }

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
                   const void* sel, int n_long, int n_short, void* kth,
                   void* grp_ub, void* slot_ub, void* class_rows,
                   void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  const long long warps = n_short + (long long)R * T;
  const int blocks =
      n_long + (int)((warps + kSlotWarps - 1) / kSlotWarps);
  slot_decode_kernel<<<blocks, kSlotThreads, 0, (cudaStream_t)stream>>>(
      s, p, R, static_cast<const uint16_t*>(block_max), n_bm,
      static_cast<const int*>(blk_starts), kk, static_cast<const int*>(sel),
      n_long, n_short, static_cast<float*>(kth),
      static_cast<float*>(grp_ub), static_cast<float*>(slot_ub),
      static_cast<int*>(class_rows));
  return (int)cudaGetLastError();
}

// Longest slot a warp selects in; a longer one takes a block.
int es_slot_warp_lanes() { return kWarpSelectLanes; }

int es_row_pack(const void* docs8, const void* docs16, const void* codes,
                const void* ranks, long long n_post, const void* doc_bases,
                long long n_bases, const void* res_vals, long long n_res,
                const void* starts, const void* lengths, const void* weights,
                const void* min_count, const void* res_starts,
                const void* res_lens, const void* dbs, const void* dlo,
                int R, int T, int max_len, int d_pad, int do_skip,
                int with_counts, int kk, const void* slot_terms,
                const void* kth, const void* grp_ub, const void* slot_ub,
                const void* row_off, const void* tile_rq, int n_tiles,
                void* keys, void* n_keys, void* ckeys, void* n_ckeys,
                void* class_rows, void* tables, void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  cudaStream_t st = (cudaStream_t)stream;
  // the slot table: in shared memory while it fits, else each row's in
  // device memory (`tables`, es_pack_table_bytes each), built first
  const long long tab_bytes = es_pack_table_bytes(T);
  int* tabs = nullptr;
  int smem = (int)(pack_table_words(T) * (long long)sizeof(int));
  cudaError_t err = cudaSuccess;
  if (tab_bytes > 0) {
    if (tables == nullptr) return (int)cudaErrorInvalidValue;
    tabs = static_cast<int*>(tables);
    smem = 0;
    pack_table_kernel<<<R, kPackThreads, 0, st>>>(
        s, p, do_skip, with_counts, kk,
        static_cast<const int*>(slot_terms), static_cast<const float*>(kth),
        static_cast<const float*>(slot_ub), tabs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = allow_smem(row_pack_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  row_pack_kernel<<<n_tiles, kPackThreads, smem, st>>>(
      s, p, R, do_skip, with_counts, kk, static_cast<const int*>(slot_terms),
      static_cast<const float*>(kth), static_cast<const float*>(grp_ub),
      static_cast<const float*>(slot_ub),
      static_cast<const long long*>(row_off),
      static_cast<const int*>(tile_rq), static_cast<uint32_t*>(keys),
      static_cast<int*>(n_keys), static_cast<uint32_t*>(ckeys),
      static_cast<int*>(n_ckeys), static_cast<int*>(class_rows), tabs);
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
               const void* n_ckeys, const void* row_off, const void* tile_rq,
               int R, int n_tiles, const void* min_count, int with_counts,
               int window, void* status, void* cand_score, void* cand_doc,
               void* cand_cnt, void* n_cand, void* totals, void* class_rows,
               void* stream) {
  if (window > kWindowLimit) return (int)cudaErrorInvalidValue;
  const int halo = window > 1 ? window - 1 : 1;
  // the two key sets, whose space then stages the candidates (< 26 KB up
  // to a window of 1024, 152 KB at kWindowLimit)
  const int span = halo + (halo >> 5) + 1 + kTile + (kTile >> 5) + 1;
  const int words = 2 * span > 3 * kTile ? 2 * span : 3 * kTile;
  const int smem = words * (int)sizeof(uint32_t);
  // the run trees as deep as the window
  auto run_sum = window <= (1 << kRunStack) ? run_sum_kernel<kRunStack>
                                            : run_sum_kernel<kWideRunStack>;
  const cudaError_t err = allow_smem(run_sum, smem);
  if (err != cudaSuccess) return (int)err;
  run_sum<<<n_tiles, kRunThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(n_keys),
      static_cast<const uint32_t*>(ckeys), static_cast<const int*>(n_ckeys),
      static_cast<const long long*>(row_off),
      static_cast<const int*>(tile_rq), R,
      static_cast<const int*>(min_count), with_counts, window, halo,
      static_cast<unsigned long long*>(status),
      static_cast<float*>(cand_score), static_cast<int*>(cand_doc),
      static_cast<int*>(cand_cnt), static_cast<int*>(n_cand),
      static_cast<int*>(totals), static_cast<int*>(class_rows));
  return (int)cudaGetLastError();
}

// Lanes of a row_pack or run_sum block: the wrapper's tiles.
int es_tile() { return kTile; }

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
                      void* soff, void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  if (T > kSoffShared && soff == nullptr) return (int)cudaErrorInvalidValue;
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
      static_cast<int*>(class_rows),
      T > kSoffShared ? static_cast<int*>(soff) : nullptr);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a shard_topk launch's kernel (1 the per-row
// kernel, 2 topk_pass, 3 topk_runs, 4 topk_merge; es_blocks_per_sm's
// numbers) for rows of at most n_max values (row_n given or not) and
// kernel k kk.
int es_topk_smem(int kernel, int n_max, int kk, int sort_cap, int stage_cap,
                 int slice, int has_row_n) {
  const TopkPlan t = topk_plan(n_max, kk, sort_cap, stage_cap, has_row_n);
  if (kernel == 1)
    return t.fin_cap * (int)sizeof(long long) +
           t.stage * (int)sizeof(float);
  if (kernel == 3) {
    int run_n = 1;
    while (run_n < (slice < t.count ? slice : t.count)) run_n <<= 1;
    return run_n * (int)sizeof(long long);
  }
  return kernel == 4 ? t.count * (int)sizeof(long long) : 0;
}

int es_shard_topk(const void* vals, long long stride, const void* row_off,
                  const void* row_n, int n_all, int n_max, int R, int kk,
                  int sort_cap, int stage_cap, int slice, void* rows,
                  void* hist, void* finals, void* runs, void* out_vals,
                  void* out_pos, const void* ids, int fill, void* out_ids,
                  void* class_rows, void* stream) {
  const int has_row_n = row_n != nullptr;
  const TopkPlan t = topk_plan(n_max, kk, sort_cap, stage_cap, has_row_n);
  const bool device = t.device;
  const int fin_cap = t.fin_cap, stage = t.stage;
  const int smem = es_topk_smem(1, n_max, kk, sort_cap, stage_cap, slice,
                                has_row_n);
  cudaStream_t st = (cudaStream_t)stream;
  TopkRow* trows = static_cast<TopkRow*>(rows);
  cudaError_t err = allow_smem(shard_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  shard_topk_kernel<<<R, kTopThreads, smem, st>>>(
      static_cast<const float*>(vals), stride,
      static_cast<const long long*>(row_off),
      static_cast<const int*>(row_n), n_all, kk, sort_cap, fin_cap, stage,
      device ? trows : nullptr, static_cast<float*>(out_vals),
      static_cast<long long*>(out_pos), static_cast<const int*>(ids), fill,
      static_cast<int*>(out_ids), static_cast<int*>(class_rows));
  err = cudaGetLastError();
  if (err != cudaSuccess || !device) return (int)err;
  // the device class: a select pass a value digit, the runs, the rank
  // merge (a block a kTopMergeKeys finalists)
  const int G = (n_max + slice - 1) / slice;
  const dim3 grid(G, R);
  for (int shift = kTopValueTop; shift >= 0; shift -= 8) {
    topk_pass_kernel<<<grid, kTopThreads, 0, st>>>(
        static_cast<const float*>(vals), stride,
        static_cast<const long long*>(row_off),
        static_cast<const int*>(row_n), n_all, slice, shift, trows,
        static_cast<int*>(hist));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int run_smem = es_topk_smem(3, n_max, kk, sort_cap, stage_cap,
                                    slice, has_row_n);
  err = allow_smem(topk_runs_kernel, run_smem);
  if (err != cudaSuccess) return (int)err;
  topk_runs_kernel<<<grid, kTopThreads, run_smem, st>>>(
      static_cast<const float*>(vals), stride,
      static_cast<const long long*>(row_off),
      static_cast<const int*>(row_n), n_all, kk, slice, trows,
      static_cast<const int*>(hist),
      static_cast<unsigned long long*>(finals), static_cast<int*>(runs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int merge_smem = es_topk_smem(4, n_max, kk, sort_cap, stage_cap,
                                      slice, has_row_n);
  err = allow_smem(topk_merge_kernel, merge_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 merge_grid((t.count + kTopMergeKeys - 1) / kTopMergeKeys, R);
  topk_merge_kernel<<<merge_grid, kTopThreads, merge_smem, st>>>(
      static_cast<const float*>(vals), stride,
      static_cast<const long long*>(row_off),
      static_cast<const int*>(row_n), n_all, kk, slice, trows,
      static_cast<const unsigned long long*>(finals),
      static_cast<const int*>(runs), G, static_cast<float*>(out_vals),
      static_cast<long long*>(out_pos), static_cast<const int*>(ids), fill,
      static_cast<int*>(out_ids));
  return (int)cudaGetLastError();
}

// Bytes of a device-class row's TopkRow, and the most slices it may take.
int es_topk_row_bytes() { return (int)sizeof(TopkRow); }
int es_topk_max_runs() { return kTopMaxRuns; }

int es_exact_merge(const void* docs8, const void* docs16, const void* codes,
                   const void* ranks, long long n_post,
                   const void* doc_bases, long long n_bases,
                   const void* res_vals, long long n_res,
                   const void* starts, const void* lengths,
                   const void* weights, const void* min_count,
                   const void* res_starts, const void* res_lens,
                   const void* dbs, const void* dlo, int R, int T,
                   int max_len, int d_pad, const void* row_off,
                   const void* part_rq, const void* row_parts, int n_extra,
                   int with_counts, int window, int window_lanes,
                   void* items, void* alt, void* cand_score, void* cand_doc,
                   void* n_cand, void* part_found, void* part_base,
                   void* bad, void* class_rows, void* tables, int n_tables,
                   void* stream) {
  Streams s = make_streams(docs8, docs16, codes, ranks, n_post, doc_bases,
                           n_bases, res_vals, n_res);
  Slots p = make_slots(starts, lengths, weights, min_count, res_starts,
                       res_lens, dbs, dlo, T, max_len, d_pad);
  return launch_exact<false>(s, p, R, row_off, part_rq, row_parts, n_extra,
                             with_counts, window, window_lanes, items, alt,
                             cand_score, cand_doc, n_cand, part_found,
                             part_base, bad, class_rows, tables, n_tables,
                             stream);
}

// The raw merge: exact_merge over a raw pack (int32 docs, f32 impacts).
int es_raw_merge(const void* docs32, const void* imps, long long n_post,
                 const void* starts, const void* lengths,
                 const void* weights, const void* min_count, int R, int T,
                 int max_len, int d_pad, const void* row_off,
                 const void* part_rq, const void* row_parts, int n_extra,
                 int with_counts, int window, int window_lanes,
                 void* items, void* alt, void* cand_score, void* cand_doc,
                 void* n_cand, void* part_found, void* part_base,
                 void* bad, void* class_rows, void* tables, int n_tables,
                 void* stream) {
  Streams s = make_streams(nullptr, nullptr, nullptr, nullptr, n_post,
                           nullptr, 0, nullptr, 0);
  s.docs32 = static_cast<const int*>(docs32);
  s.imps = static_cast<const float*>(imps);
  Slots p = make_slots(starts, lengths, weights, min_count, nullptr,
                       nullptr, nullptr, nullptr, T, max_len, d_pad);
  return launch_exact<true>(s, p, R, row_off, part_rq, row_parts, n_extra,
                            with_counts, window, window_lanes, items, alt,
                            cand_score, cand_doc, n_cand, part_found,
                            part_base, bad, class_rows, tables, n_tables,
                            stream);
}

// Phase A of a pruned tier over B queries of GT slots each, as the
// wrapper planned it (see cand_part_kernel, cand_band_kernel): the part
// blocks, then the band blocks.
int es_pruned_candidates(const void* docs32, const void* imps,
                         long long n_post, const void* starts,
                         const void* lengths, const void* weights,
                         const void* rows, int B, int GT, int max_len,
                         int d_pad, int pack_keys, int window,
                         long long key_base, const void* plan, int n_parts,
                         int n_bands, int p_max, int has_shared, int cap,
                         int part_lanes, void* items, void* alt,
                         void* alt2,
                         void* bstart, void* status, void* cand_score,
                         void* cand_gid, void* n_cand, void* class_rows,
                         void* stream) {
  CandArgs a;
  a.docs32 = static_cast<const int*>(docs32);
  a.imps = static_cast<const float*>(imps);
  a.n_post = n_post;
  a.starts = static_cast<const int*>(starts);
  a.lengths = static_cast<const int*>(lengths);
  a.weights = static_cast<const float*>(weights);
  a.rows = static_cast<const int*>(rows);
  a.GT = GT;
  a.max_len = max_len;
  a.d_pad = d_pad;
  a.pack_keys = pack_keys;
  a.window = window;
  a.cap = cap;
  a.part_lanes = part_lanes;
  a.key_base = key_base;
  a.row_off = static_cast<const long long*>(plan);
  a.qinfo = a.row_off + B + 1;
  a.part_tiles = a.qinfo + 4 * (long long)B;
  a.band_tiles = a.part_tiles + n_parts;
  a.items = static_cast<unsigned long long*>(items);
  a.alt = static_cast<unsigned long long*>(alt);
  a.alt2 = static_cast<unsigned long long*>(alt2);
  a.bstart = static_cast<int*>(bstart);
  a.status = static_cast<unsigned long long*>(status);
  a.cand_score = static_cast<float*>(cand_score);
  a.cand_gid = static_cast<int*>(cand_gid);
  a.n_cand = static_cast<int*>(n_cand);
  a.class_rows = static_cast<int*>(class_rows);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n_parts > 0) {
    const int smem = cand_part_smem(GT, part_lanes);
    err = allow_smem(cand_part_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cand_part_kernel<<<n_parts, kCandThreads, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_bands > 0) {
    const int smem = cand_band_smem(GT, cap, p_max, has_shared);
    err = allow_smem(cand_band_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cand_band_kernel<<<n_bands, kCandThreads, smem, st>>>(a);
    err = cudaGetLastError();
  }
  return (int)err;
}

// Dynamic shared memory of pruned_candidates' part (kernel 0) or band
// (kernel 1) blocks.
int es_cand_smem_bytes(int kernel, int GT, int cap, int part_lanes,
                       int p_max, int has_shared) {
  return kernel == 0 ? cand_part_smem(GT, part_lanes)
                     : cand_band_smem(GT, cap, p_max, has_shared);
}

// Phase B of a pruned tier and its final order (mode bits 1 and 2; see
// rescore_score_kernel, rescore_order_kernel): with both, the scores go
// through exact_out to the order.
int es_pruned_rescore(const void* docs32, const void* imps, long long n_post,
                      const void* cand_gids, int C, const void* t_starts,
                      const void* t_lengths, const void* t_weights, int S_l,
                      int B, int T_terms, int d_pad, long long p_pad,
                      int row_base, int search_iters, const void* exact_in,
                      const void* cand_vals, void* exact_out, int kk,
                      void* out_vals, void* out_gids, int mode,
                      void* stream) {
  if (C > kRescoreCands ||
      ((mode & 1) && (T_terms > 32 || T_terms < 1 ||
                      (T_terms & (T_terms - 1)))))
    return (int)cudaErrorInvalidValue;
  RescoreArgs a;
  a.docs32 = static_cast<const int*>(docs32);
  a.imps = static_cast<const float*>(imps);
  a.n_post = n_post;
  a.cand_gids = static_cast<const long long*>(cand_gids);
  a.C = C;
  a.t_starts = static_cast<const int*>(t_starts);
  a.t_lengths = static_cast<const int*>(t_lengths);
  a.t_weights = static_cast<const float*>(t_weights);
  a.S_l = S_l;
  a.B = B;
  a.T_terms = T_terms;
  a.d_pad = d_pad;
  a.p_pad = p_pad;
  a.row_base = row_base;
  a.search_iters = search_iters;
  a.exact_in = static_cast<const float*>(mode & 1 ? exact_out : exact_in);
  a.cand_vals = static_cast<const float*>(cand_vals);
  a.exact_out = static_cast<float*>(exact_out);
  a.kk = kk;
  a.out_vals = static_cast<float*>(out_vals);
  a.out_gids = static_cast<long long*>(out_gids);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (mode & 1) {
    const int per_block = kRescoreThreads / T_terms;
    const dim3 grid((C + per_block - 1) / per_block, B);
    rescore_score_kernel<<<grid, kRescoreThreads, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (mode & 2) {
    const int smem = rescore_order_smem(C);
    err = allow_smem(rescore_order_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rescore_order_kernel<<<B, kOrderThreads, smem, st>>>(a);
    err = cudaGetLastError();
  }
  return (int)err;
}

// Dynamic shared memory of a pruned_rescore order block of C candidates.
int es_rescore_order_smem_bytes(int C) { return rescore_order_smem(C); }

// Dynamic shared memory of an exact_merge launch of T slots and windows
// of window_lanes lanes.
int es_exact_smem_bytes(int window_lanes, int T) {
  const int S = exact_window(window_lanes, T);
  return exact_table_bytes(window_lanes, T) > 0 ? 16 * S
                                                 : exact_smem_bytes(S, T);
}

// Bytes of an exact_merge block's device-memory slot table (0: the table
// stays in shared memory), and the merge window's most items (a row of
// more slots takes the radix class).
long long es_exact_table_bytes(int window_lanes, int T) {
  return exact_table_bytes(window_lanes, T);
}
int es_exact_max_items() { return kExactMaxItems; }

// Blocks of a kernel resident on one SM at `smem` bytes of dynamic shared
// memory (0 exact_merge, 1 shard_topk, 2 topk_pass, 3 topk_runs,
// 4 topk_merge, 5 exact_finish, 6 cand_part, 7 cand_band, 8
// rescore_score, 9 rescore_order), or -1 with an
// unknown kernel or a refused size.
int es_blocks_per_sm(int kernel, int smem) {
  int blocks = -1;
  cudaError_t err = cudaSuccess;
#define ES_OCCUPANCY(fn, threads)                                          \
  err = allow_smem(fn, smem);                                              \
  if (err == cudaSuccess)                                                  \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,       \
                                                        threads, smem);
  switch (kernel) {
    case 0: {
      auto fn = exact_merge_kernel<false, kRunStack>;
      ES_OCCUPANCY(fn, kExactThreads)
    } break;
    case 1: ES_OCCUPANCY(shard_topk_kernel, kTopThreads) break;
    case 2: ES_OCCUPANCY(topk_pass_kernel, kTopThreads) break;
    case 3: ES_OCCUPANCY(topk_runs_kernel, kTopThreads) break;
    case 4: ES_OCCUPANCY(topk_merge_kernel, kTopThreads) break;
    case 5: {
      auto fn = exact_finish_kernel<false, kRunStack>;
      ES_OCCUPANCY(fn, kExactThreads)
    } break;
    case 6: ES_OCCUPANCY(cand_part_kernel, kCandThreads) break;
    case 7: ES_OCCUPANCY(cand_band_kernel, kCandThreads) break;
    case 8: ES_OCCUPANCY(rescore_score_kernel, kRescoreThreads) break;
    case 9: ES_OCCUPANCY(rescore_order_kernel, kOrderThreads) break;
    default: break;
  }
#undef ES_OCCUPANCY
  cudaGetLastError();  // a refused size leaves no error for a later launch
  return err == cudaSuccess ? blocks : -1;
}

const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
