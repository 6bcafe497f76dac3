// Host emulation of the CUDA subset used by csrc/merge_topk.cu,
// csrc/knn.cu and csrc/aggs.cu (see __init__.py): each CUDA thread is a
// fiber (ucontext) of one OS thread, switched at every barrier, blocks one
// after another. One core, no spinning: the emulation does not slow what
// runs beside it.
#include <float.h>
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct int2 { int x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline int2 make_int2(int a, int b) { return int2{a, b}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int v) { return v > 232448 ? 1 : 0; }
inline int cudaGetLastError() { return 0; }
// one block an SM on two SMs: a persistent kernel's blocks walk several tiles
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
#define __host__
inline const char* cudaGetErrorString(int) { return "emu"; }

constexpr size_t kFiberStack = 1 << 16;

struct Fiber {
  ucontext_t ctx;
  dim3 tid;
  int votes = 0;      // block votes taken (picks the accumulator)
  bool done = false;
};

struct Barrier {     // generation barrier over `n` fibers
  int n = 0, count = 0, gen = 0;
};

struct Block {
  std::vector<Fiber> fibers;
  std::vector<char> stacks;
  ucontext_t sched;
  int cur = 0;
  Barrier bar;
  std::vector<Barrier> warp_bar;
  std::vector<uint64_t> warp_vals;  // 32 per warp
  int votes[3] = {0, 0, 0};
};

static Block* g_block;
static dim3 blockIdx, blockDim, gridDim;
alignas(16) static unsigned char g_smem[1 << 18];
#define threadIdx (g_block->fibers[g_block->cur].tid)

inline void emu_yield() {
  Fiber& f = g_block->fibers[g_block->cur];
  swapcontext(&f.ctx, &g_block->sched);
}
inline void emu_wait(Barrier& b) {
  const int gen = b.gen;
  if (++b.count == b.n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) emu_yield();
}

inline void __syncthreads() { emu_wait(g_block->bar); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_wait(g_block->warp_bar[threadIdx.x / 32]);
}
// __syncthreads_count / _or: three rotating accumulators, the next one
// cleared before this one is read (every fiber has left the one before)
inline int block_vote(int v) {
  const int idx = g_block->fibers[g_block->cur].votes++ % 3;
  g_block->votes[(idx + 1) % 3] = 0;
  g_block->votes[idx] += v;
  __syncthreads();
  const int r = g_block->votes[idx];
  __syncthreads();
  return r;
}
inline int __syncthreads_or(int p) { return block_vote(p != 0) != 0; }
inline int __syncthreads_count(int p) { return block_vote(p != 0); }

inline uint64_t* warp_slots() { return &g_block->warp_vals[(threadIdx.x / 32) * 32]; }
template <class T> inline void wput(T v) { uint64_t u = 0; std::memcpy(&u, &v, sizeof(T)); warp_slots()[threadIdx.x & 31] = u; }
template <class T> inline T wget(int l) { T v; uint64_t u = warp_slots()[l]; std::memcpy(&v, &u, sizeof(T)); return v; }
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  wput(v); __syncwarp(); int l = threadIdx.x & 31; T r = l >= d ? wget<T>(l - d) : v; __syncwarp(); return r; }
template <class T> T __shfl_sync(unsigned, T v, int s) {
  wput(v); __syncwarp(); T r = wget<T>(s & 31); __syncwarp(); return r; }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  wput(v); __syncwarp(); T r = wget<T>((threadIdx.x & 31) ^ m); __syncwarp(); return r; }
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  wput(v); __syncwarp(); int l = threadIdx.x & 31; T r = l + d < 32 ? wget<T>(l + d) : v; __syncwarp(); return r; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  wput(v); __syncwarp(); unsigned r = v; for (int l = 0; l < 32; ++l) r = std::min(r, wget<unsigned>(l)); __syncwarp(); return r; }
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  wput(v); __syncwarp(); unsigned r = v; for (int l = 0; l < 32; ++l) r = std::max(r, wget<unsigned>(l)); __syncwarp(); return r; }
inline unsigned __ballot_sync(unsigned, int p) {
  wput<int>(p != 0); __syncwarp(); unsigned r = 0; for (int l = 0; l < 32; ++l) if (wget<int>(l)) r |= 1u << l; __syncwarp(); return r; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline void __nanosleep(unsigned) {}  // blocks run in order: no wait
inline int atomicAdd(int* a, int v) { const int old = *a; *a = old + v; return old; }
inline int atomicMin(int* a, int v) { const int old = *a; *a = std::min(old, v); return old; }
// csrc/aggs.cu's 64-bit and unsigned atomics: fibers switch only at
// barriers, so each is a plain read-modify-write
inline unsigned atomicAdd(unsigned* a, unsigned v) { const unsigned old = *a; *a = old + v; return old; }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) { const unsigned long long old = *a; *a = old + v; return old; }
inline long long atomicMin(long long* a, long long v) { const long long old = *a; *a = std::min(old, v); return old; }
inline long long atomicMax(long long* a, long long v) { const long long old = *a; *a = std::max(old, v); return old; }
inline void __threadfence() {}  // one block at a time: every write is seen
template <class T> inline T __ldcg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

// csrc/knn.cu's <ptx> block. The .rn.ftz.f32 operations: a subnormal
// operand read as a zero, the result rounded once and flushed to a zero of
// its sign where, rounded to 24 bits with an unbounded exponent, it is
// below FLT_MIN (x86's rule, the card's). emu_ftz takes the exact result or
// one rounded to odd in double (innocuous for the one rounding to float).
inline float emu_daz(float x) { return std::fabs(x) < FLT_MIN ? std::copysign(0.0f, x) : x; }
inline float emu_ftz(double x) {
  const float scaled = (float)(x * 0x1p64);  // 24 bits, the exponent unbounded
  return std::fabs(scaled) < 0x1p-62f ? std::copysign(0.0f, (float)x) : (float)x;
}
inline double emu_odd_sum(double p, double c) {  // p + c rounded to odd
  const double s = p + c, bb = s - p;
  const double e = (p - (s - bb)) + (c - bb);
  uint64_t bits; std::memcpy(&bits, &s, 8);
  if (e != 0 && std::isfinite(s) && !(bits & 1)) bits += ((e > 0) == (s > 0)) ? 1 : (uint64_t)-1;
  double r; std::memcpy(&r, &bits, 8); return r;
}
inline float fma_z(float a, float b, float c) {
  return emu_ftz(emu_odd_sum((double)emu_daz(a) * emu_daz(b), emu_daz(c))); }
inline float add_z(float a, float b) { return emu_ftz((double)emu_daz(a) + emu_daz(b)); }
inline float sub_z(float a, float b) { return emu_ftz((double)emu_daz(a) - emu_daz(b)); }
inline float mul_z(float a, float b) { return emu_ftz((double)emu_daz(a) * emu_daz(b)); }
inline float div_z(float a, float b) { return emu_ftz((double)emu_daz(a) / emu_daz(b)); }
inline float sqrt_z(float a) { return emu_ftz(std::sqrt((double)emu_daz(a))); }
// cp.async as a plain copy (zeros past `bytes`), landed at once: the waits
// have nothing to wait for
inline void cp_async16(float* dst, const float* src, int bytes) {
  std::memset(dst, 0, 16); std::memcpy(dst, src, bytes); }
inline void cp_async4(float* dst, const float* src, int bytes) {
  std::memset(dst, 0, 4); std::memcpy(dst, src, bytes); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

template <class T> inline T min(T a, T b) { return a < b ? a : b; }
template <class T> inline T max(T a, T b) { return a > b ? a : b; }
using std::isinf; using std::isnan; using std::fmaxf;

// The kernel and its arguments, for the fibers' entry (makecontext
// passes only ints).
static void (*g_entry)(void*);
static void* g_entry_arg;
static void emu_fiber_main() {
  g_entry(g_entry_arg);
  g_block->fibers[g_block->cur].done = true;
}

template <typename... KA, typename... A>
void emu_launch(void (*k)(KA...), dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  if (smem > sizeof(g_smem)) { fprintf(stderr, "smem too large\n"); abort(); }
  std::memset(g_smem, 0xAB, sizeof(g_smem));
  auto call = [&]() { k(args...); };
  g_entry = [](void* c) { (*static_cast<decltype(call)*>(c))(); };
  g_entry_arg = &call;
  const int n = (int)block.x;
  Block blk;
  blk.fibers.resize(n);
  blk.stacks.resize((size_t)n * kFiberStack);
  blk.bar.n = n;
  blk.warp_bar.resize((n + 31) / 32);
  for (auto& w : blk.warp_bar) w.n = 32;
  blk.warp_vals.assign(blk.warp_bar.size() * 32, 0);
  g_block = &blk;
  blockDim = block;
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, 0);
      std::fill(std::begin(blk.votes), std::end(blk.votes), 0);
      for (int t = 0; t < n; ++t) {
        Fiber& f = blk.fibers[t];
        f.tid = dim3(t, 0, 0);
        f.votes = 0;
        f.done = false;
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = &blk.stacks[(size_t)t * kFiberStack];
        f.ctx.uc_stack.ss_size = kFiberStack;
        f.ctx.uc_link = &blk.sched;
        makecontext(&f.ctx, emu_fiber_main, 0);
      }
      for (int left = n; left > 0;) {
        left = 0;
        for (int t = 0; t < n; ++t) {
          if (blk.fibers[t].done) continue;
          blk.cur = t;
          swapcontext(&blk.sched, &blk.fibers[t].ctx);
          left += !blk.fibers[t].done;
        }
      }
    }
  g_block = nullptr;
}
