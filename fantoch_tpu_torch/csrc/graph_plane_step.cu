// Hopper kernels of the graph-plane step (one resident EPaxos/Atlas
// backlog dispatch): the stages of mode "keyed", and the sort every mode
// uses.  They replace the TPU kernel graph_plane_step_pallas
// (fantoch_tpu/ops/pallas_resolve.py:334, tracing graph_plane_step_core,
// fantoch_tpu/ops/graph_resolve.py:883); the prologue of every mode and the
// general modes' stages are in graph_general.cu.  The Python
// wrappers, plain versions and per-stage notes on bounds and design are in
// fantoch_tpu_torch/ops/graph_plane_kernels.py.
//
// Interface: every launcher is extern "C", takes raw device pointers, ints
// and a cudaStream_t, launches on that stream, never synchronises and never
// allocates (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its last launch (or the first failing one).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgraph_plane_step.so graph_plane_step.cu

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <climits>
#include <mutex>

namespace cg = cooperative_groups;

#define TERMINAL (-1)
#define MISSING (-2)
#define UNRESOLVED_RANK INT_MAX
#define EMIT_UNRESOLVED_BIT (1 << 30)

#define EW_BLOCK 256  // elementwise kernels

typedef unsigned long long u64;

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

#define CHECK_CALL(call)                       \
  do {                                         \
    cudaError_t e_ = (call);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static inline unsigned grid_for(long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

// The plane's epilogue (fantoch_tpu/ops/graph_resolve.py:1009-1010) for
// vertex v whose resolved flag is res: newly = res & occ & ~executed,
// executed |= newly.  §8 launches it alone; pointer doubling (§6) and the
// emit scatter (§7) fold it into the launch that makes the flags, when
// the wrapper passes occ, executed and newly (all three or none).  Each
// vertex is taken by exactly one thread, so executed is updated in place.
__device__ __forceinline__ void epilogue_row(const uint8_t* occ, uint8_t* executed,
                                             uint8_t* newly, long v, bool res) {
  bool nw = res && occ[v] && !executed[v];
  newly[v] = nw;
  if (nw) executed[v] = 1;
}

static inline bool epilogue_args_ok(const void* occ, const void* executed,
                                    const void* newly) {
  return (occ == nullptr) == (executed == nullptr) && (occ == nullptr) == (newly == nullptr);
}

// ---------------------------------------------------------------------------
// 2. stable lexicographic sort: an LSD radix sort of (key digit, position)
// ---------------------------------------------------------------------------
// Columns go from the last key to the first.  A column's first digit pass
// reads its key through the running permutation (the previous column's
// result; the identity for the first column), so its values are the
// original positions; every later pass moves 4-byte (key, value) pairs.
// int32 keys are biased (^ 0x80000000) to sort as signed and take four
// 8-bit passes; a bool key (kind 1) or an inverted bool key (kind 2) takes
// one 1-bit pass.  A pass is stable by construction, so the original index
// is the last key without being stored.  It replaces the first version's
// bitonic network over padded (key << 32 | position) words, 55 launches at
// 2^20 each moving the whole 8 MB array; at the port's sizes its launches,
// not its bytes, bound it (the byte bound of one key at 2^20 is 0.0025 ms).
//
// One digit pass over n > RADIX_SMALL_N elements is three launches: a
// per-tile digit histogram, the exclusive scan of the digit-major
// [bins x tiles] counts (one warp per digit, plus each digit's total),
// and the stable scatter.  In the scatter each warp ranks its 32 x
// RADIX_ITEMS consecutive elements inside their digit (the lanes holding
// the same digit by ballots, the lower ones among them, and the warp's
// running count of the digit in shared memory); one shuffle scan over the
// digits gives the tile's digit starts and the array's; the tile is
// sorted into shared memory and written out in order, so consecutive
// threads store consecutive words of a digit's run.  No block waits on
// another block.
//
// A digit that every key of a column shares moves nothing: the first
// pass's histogram also ORs the column's keys and their complements into
// two device words, and the column's later passes whose digit is constant
// return at once (the last one copies its input to the column's result),
// the passes after them reading from where the last moving pass wrote.
// Most keys are far below 2^24 (positions, key ids, process ids), so this
// skips one to three of an int32 column's four passes without a host read.
//
// Up to RADIX_SMALL_N elements one block holds the whole array in shared
// memory and runs every pass of every column in one launch.

#define RADIX_THREADS 256
#define RADIX_WARPS (RADIX_THREADS / 32)
#define RADIX_ITEMS 8  // a tile is RADIX_THREADS x RADIX_ITEMS elements
#define RADIX_TILE (RADIX_THREADS * RADIX_ITEMS)
#define RADIX_BINS 256
#define RADIX_SMALL_ITEMS 16
#define RADIX_SMALL_N (RADIX_THREADS * RADIX_SMALL_ITEMS)
#define SCAN_SEG 256  // tile counts a scanning warp holds at a time
#define SCAN_SKEWED (SCAN_SEG + SCAN_SEG / 32)
#define LEX_MAX_KEYS 8
#define FULL_MASK 0xffffffffu
static_assert(RADIX_THREADS == RADIX_BINS, "a radix block's thread d owns digit d");

// the columns of one sort, most significant first; kind 0 int32, 1 bool,
// 2 inverted bool
struct LexKeys {
  const void* col[LEX_MAX_KEYS];
  int kind[LEX_MAX_KEYS];
};

// a pass's input: a key column read through perm (first pass of a column;
// perm null for the identity) or the previous pass's (keys, vals)
struct RadixSrc {
  const void* col;
  int kind;
  const int32_t* perm;
  const uint32_t* keys;
  const int32_t* vals;
};

// one digit pass of one column over n > RADIX_SMALL_N elements
struct RadixPass {
  const void* col;  // the column, read through perm
  int kind;
  const int32_t* perm;  // null: the identity
  uint32_t* keys0;  // the (key, value) buffers between passes
  int32_t* vals0;
  uint32_t* keys1;
  int32_t* vals1;
  int32_t* out;               // the column's result
  const int32_t* through;     // applied to the last column's result
  unsigned* varying;          // [2]: OR of the column's keys, of their complements
  int pass, passes, bits;
};

__device__ __forceinline__ bool pass_moves(const RadixPass& P, int q) {
  unsigned vary = P.varying[0] & P.varying[1];
  return ((vary >> (q * 8)) & ((1u << P.bits) - 1u)) != 0;
}

// the passes before this one that moved elements
__device__ __forceinline__ int moved_before(const RadixPass& P) {
  int m = 0;
  for (int q = 0; q < P.pass; ++q) m += pass_moves(P, q) ? 1 : 0;
  return m;
}

// where this pass reads: the column, or the buffer the last moving pass wrote
__device__ __forceinline__ RadixSrc pass_input(const RadixPass& P, int moved) {
  RadixSrc s = {P.col, P.kind, P.perm, nullptr, nullptr};
  if (moved > 0) {
    s.keys = (moved & 1) ? P.keys0 : P.keys1;
    s.vals = (moved & 1) ? P.vals0 : P.vals1;
  }
  return s;
}

// column c of the kernel parameter by compile-time indices (a parameter
// indexed at run time would be copied to a stack frame)
__device__ __forceinline__ void lex_column(const LexKeys& keys, int c, const void*& col,
                                           int& kind) {
#pragma unroll
  for (int i = 0; i < LEX_MAX_KEYS; ++i) {
    if (i == c) {
      col = keys.col[i];
      kind = keys.kind[i];
    }
  }
}

__device__ __forceinline__ unsigned column_key(const void* col, int kind, int j) {
  if (kind == 0) return (unsigned)((const int32_t*)col)[j] ^ 0x80000000u;
  unsigned b = ((const uint8_t*)col)[j] ? 1u : 0u;
  return kind == 2 ? 1u - b : b;
}

__device__ __forceinline__ void load_pair(const RadixSrc& s, long i, unsigned& key,
                                          int& val) {
  if (s.keys) {
    key = s.keys[i];
    val = s.vals[i];
    return;
  }
  int j = s.perm ? s.perm[i] : (int)i;
  key = column_key(s.col, s.kind, j);
  val = j;
}

// Rank ITEMS elements a thread (element it of the warp's run sits at
// it * 32 + lane) inside their digit, in order: the lanes holding the same
// digit (one ballot a digit bit: cheaper on sm_90 than __match_any_sync),
// the leader (the lowest of them) taking their count from the warp's
// running count of the digit (a shared atomic) and passing the old count
// on (a shuffle), and the lower lanes among them.
// whist[warp * RADIX_BINS + d] ends as the warp's count of digit d (zeroed
// by the caller).  Elements past the end of the array are a suffix of the
// order, so what they add reaches no element that is written.
template <int ITEMS>
__device__ __forceinline__ void rank_items(const unsigned (&key)[ITEMS], int shift,
                                           unsigned mask, int* whist, int (&rank)[ITEMS]) {
  int lane = threadIdx.x & 31;
  int* h = whist + (threadIdx.x >> 5) * RADIX_BINS;
  unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    unsigned d = (key[it] >> shift) & mask;
    unsigned peers = FULL_MASK;
    for (int b = 0; (mask >> b) & 1u; ++b) {
      unsigned bit = (d >> b) & 1u;
      unsigned set = __ballot_sync(FULL_MASK, bit);
      peers &= bit ? set : ~set;
    }
    int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader) before = atomicAdd(&h[d], __popc(peers));
    before = __shfl_sync(FULL_MASK, before, leader);
    rank[it] = before + __popc(peers & lower);
  }
}

// exclusive sums of a and of b over a RADIX_THREADS block (warp shuffles,
// then the warp totals); every thread must call it.  sh: 2 * RADIX_WARPS
__device__ __forceinline__ void block_excl_sum2(int a, int b, int& ea, int& eb, int* sh) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int ya = __shfl_up_sync(FULL_MASK, ia, off);
    int yb = __shfl_up_sync(FULL_MASK, ib, off);
    if (lane >= off) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    sh[warp] = ia;
    sh[RADIX_WARPS + warp] = ib;
  }
  __syncthreads();
  ea = ia - a;
  eb = ib - b;
  for (int w = 0; w < warp; ++w) {
    ea += sh[w];
    eb += sh[RADIX_WARPS + w];
  }
  __syncthreads();
}

// per tile: the count of each digit (per-warp shared histograms, summed),
// written digit-major counts[d * tiles + t]; the first pass of a column
// also ORs its keys and their complements into P.varying (zeroed by the
// launcher)
__global__ void k_radix_hist(RadixPass P, int32_t* counts, int tiles, int n) {
  __shared__ int whist[RADIX_WARPS * RADIX_BINS];
  __shared__ unsigned vary[2];
  if (P.pass > 0 && !pass_moves(P, P.pass)) return;
  RadixSrc s = pass_input(P, moved_before(P));
  int nb = 1 << P.bits, shift = P.pass * 8;
  for (int t = threadIdx.x; t < RADIX_WARPS * RADIX_BINS; t += blockDim.x) whist[t] = 0;
  if (threadIdx.x < 2) vary[threadIdx.x] = 0;
  __syncthreads();
  int* h = whist + (threadIdx.x >> 5) * RADIX_BINS;
  long base = (long)blockIdx.x * RADIX_TILE + (threadIdx.x >> 5) * 32 * RADIX_ITEMS +
              (threadIdx.x & 31);
  unsigned any = 0, any_not = 0;
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    long i = base + it * 32;
    if (i < n) {
      unsigned key;
      int val;
      load_pair(s, i, key, val);
      atomicAdd(&h[(key >> shift) & (unsigned)(nb - 1)], 1);
      any |= key;
      any_not |= ~key;
    }
  }
  if (P.pass == 0) {
    any = __reduce_or_sync(FULL_MASK, any);
    any_not = __reduce_or_sync(FULL_MASK, any_not);
    if ((threadIdx.x & 31) == 0) {
      atomicOr(&vary[0], any);
      atomicOr(&vary[1], any_not);
    }
  }
  __syncthreads();
  if (P.pass == 0 && threadIdx.x < 2) atomicOr(&P.varying[threadIdx.x], vary[threadIdx.x]);
  for (int d = threadIdx.x; d < nb; d += blockDim.x) {
    int c = 0;
    for (int w = 0; w < RADIX_WARPS; ++w) c += whist[w * RADIX_BINS + d];
    counts[(long)d * tiles + blockIdx.x] = c;
  }
}

// One warp per digit: the exclusive scan of its tiles' counts, in place,
// and the digit's total.  The row passes through shared memory SCAN_SEG
// counts at a time, loaded and stored coalesced (skewed by one word every
// 32, so that the lanes' runs hit distinct banks); each lane sums a run of
// consecutive counts, the lanes' sums are scanned by shuffles, and each
// lane rewrites its run.
__global__ void k_radix_scan(RadixPass P, int32_t* counts, int32_t* totals, int tiles) {
  __shared__ int seg[RADIX_WARPS * SCAN_SKEWED];
  int d = blockIdx.x * RADIX_WARPS + (threadIdx.x >> 5);
  if (!pass_moves(P, P.pass) || d >= (1 << P.bits)) return;  // whole warps
  int lane = threadIdx.x & 31;
  int* sh = seg + (threadIdx.x >> 5) * SCAN_SKEWED;
  int32_t* row = counts + (long)d * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += SCAN_SEG) {
    int len = tiles - base < SCAN_SEG ? tiles - base : SCAN_SEG;
    for (int t = lane; t < len; t += 32) sh[t + (t >> 5)] = row[base + t];
    __syncwarp();
    int per = (len + 31) >> 5;
    int lo = lane * per, hi = lo + per < len ? lo + per : len;
    int sum = 0;
    for (int t = lo; t < hi; ++t) sum += sh[t + (t >> 5)];
    int inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(FULL_MASK, inc, off);
      if (lane >= off) inc += y;
    }
    int run = carry + inc - sum;
    for (int t = lo; t < hi; ++t) {
      int c = sh[t + (t >> 5)];
      sh[t + (t >> 5)] = run;
      run += c;
    }
    carry += __shfl_sync(FULL_MASK, inc, 31);
    __syncwarp();
    for (int t = lane; t < len; t += 32) row[base + t] = sh[t + (t >> 5)];
    __syncwarp();
  }
  if (lane == 0) totals[d] = carry;
}

// After rank_items: thread d turns the warps' counts of digit d into each
// warp's first position for it inside the block's sorted elements, and
// returns the block's count of d (0 past nb).  `excess` elements past the
// end of the array were counted as digit 0.
__device__ __forceinline__ int digit_counts(int* whist, int nb, int excess) {
  int d = threadIdx.x, cnt = 0;
  if (d < nb) {
    for (int w = 0; w < RADIX_WARPS; ++w) {
      int c = whist[w * RADIX_BINS + d];
      whist[w * RADIX_BINS + d] = cnt;
      cnt += c;
    }
  }
  return d == 0 ? cnt - excess : cnt;
}

// the stable scatter of one tile; the last pass of a column writes only
// the values (through P.through when given), and copies them when its
// digit is constant
__global__ void k_radix_scatter(RadixPass P, const int32_t* counts, const int32_t* totals,
                                int tiles, int n) {
  __shared__ int whist[RADIX_WARPS * RADIX_BINS];
  __shared__ int delta[RADIX_BINS];  // a digit's output position less its tile one
  __shared__ int sh[2 * RADIX_WARPS];
  __shared__ unsigned skey[RADIX_TILE];
  __shared__ int sval[RADIX_TILE];
  bool last = P.pass == P.passes - 1;
  int moved = moved_before(P);
  RadixSrc s = pass_input(P, moved);
  long tile0 = (long)blockIdx.x * RADIX_TILE;
  int tile_n = n - tile0 < RADIX_TILE ? (int)(n - tile0) : RADIX_TILE;
  if (!pass_moves(P, P.pass)) {
    if (!last) return;
    for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
      unsigned key;
      int val;
      load_pair(s, tile0 + i, key, val);
      P.out[tile0 + i] = P.through ? P.through[val] : val;
    }
    return;
  }
  uint32_t* keys_out = last ? nullptr : ((moved & 1) ? P.keys1 : P.keys0);
  int32_t* vals_out = last ? P.out : ((moved & 1) ? P.vals1 : P.vals0);
  const int32_t* through = last ? P.through : nullptr;
  int nb = 1 << P.bits, shift = P.pass * 8;
  unsigned mask = (unsigned)(nb - 1);
  for (int t = threadIdx.x; t < RADIX_WARPS * RADIX_BINS; t += blockDim.x) whist[t] = 0;
  // thread d's digit total and this tile's offset in it, read with the keys
  int d = threadIdx.x;
  int total = d < nb ? totals[d] : 0;
  int offset = d < nb ? counts[(long)d * tiles + blockIdx.x] : 0;
  int lane = threadIdx.x & 31;
  int first = (threadIdx.x >> 5) * 32 * RADIX_ITEMS + lane;  // in the tile
  unsigned key[RADIX_ITEMS];
  int val[RADIX_ITEMS], rank[RADIX_ITEMS];
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    key[it] = 0;
    val[it] = 0;
    if (first + it * 32 < tile_n) load_pair(s, tile0 + first + it * 32, key[it], val[it]);
  }
  __syncthreads();
  rank_items<RADIX_ITEMS>(key, shift, mask, whist, rank);
  __syncthreads();
  int cnt = digit_counts(whist, nb, RADIX_TILE - tile_n);
  int start, digit_start;
  block_excl_sum2(cnt, total, start, digit_start, sh);
  if (d < nb) {
    delta[d] = digit_start + offset - start;
    for (int w = 0; w < RADIX_WARPS; ++w) whist[w * RADIX_BINS + d] += start;
  }
  __syncthreads();
  const int* h = whist + (threadIdx.x >> 5) * RADIX_BINS;
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    if (first + it * 32 >= tile_n) continue;
    int at = h[(key[it] >> shift) & mask] + rank[it];
    skey[at] = key[it];
    sval[at] = val[it];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
    unsigned k = skey[i];
    int dst = delta[(k >> shift) & mask] + i;
    if (keys_out) keys_out[dst] = k;
    vals_out[dst] = through ? through[sval[i]] : sval[i];
  }
}

// n <= RADIX_SMALL_N: every pass of every column in one block, the
// permutation and the keys in shared memory
__global__ void k_radix_small(LexKeys keys, int ncols, const int32_t* through,
                              int32_t* out, int n) {
  __shared__ unsigned skey[RADIX_SMALL_N];
  __shared__ int sval[RADIX_SMALL_N];
  __shared__ int whist[RADIX_WARPS * RADIX_BINS];
  __shared__ int sh[2 * RADIX_WARPS];
  int lane = threadIdx.x & 31;
  int base = (threadIdx.x >> 5) * 32 * RADIX_SMALL_ITEMS + lane;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sval[i] = i;
  __syncthreads();
  for (int c = ncols - 1; c >= 0; --c) {
    const void* col = nullptr;
    int kind = 0;
    lex_column(keys, c, col, kind);
    int passes = kind == 0 ? 4 : 1, bits = kind == 0 ? 8 : 1, nb = 1 << bits;
    for (int p = 0; p < passes; ++p) {
      int shift = p * 8;
      unsigned key[RADIX_SMALL_ITEMS];
      int val[RADIX_SMALL_ITEMS], rank[RADIX_SMALL_ITEMS];
#pragma unroll
      for (int it = 0; it < RADIX_SMALL_ITEMS; ++it) {
        int i = base + it * 32;
        key[it] = 0;
        val[it] = 0;
        if (i < n) {
          val[it] = sval[i];
          key[it] = p == 0 ? column_key(col, kind, val[it]) : skey[i];
        }
      }
      for (int t = threadIdx.x; t < RADIX_WARPS * RADIX_BINS; t += blockDim.x) whist[t] = 0;
      __syncthreads();
      rank_items<RADIX_SMALL_ITEMS>(key, shift, (unsigned)(nb - 1), whist, rank);
      __syncthreads();
      // the slots past n hold key 0: digit 0 counted them too, after
      // every valid element, so no rank above moved
      int d = threadIdx.x;
      int cnt = digit_counts(whist, nb, RADIX_SMALL_N - n);
      int start, unused;
      block_excl_sum2(cnt, 0, start, unused, sh);
      if (d < nb)
        for (int w = 0; w < RADIX_WARPS; ++w) whist[w * RADIX_BINS + d] += start;
      __syncthreads();
      const int* h = whist + (threadIdx.x >> 5) * RADIX_BINS;
      unsigned mask = (unsigned)(nb - 1);
#pragma unroll
      for (int it = 0; it < RADIX_SMALL_ITEMS; ++it) {
        if (base + it * 32 >= n) continue;
        int dst = h[(key[it] >> shift) & mask] + rank[it];
        skey[dst] = key[it];
        sval[dst] = val[it];
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = through ? through[sval[i]] : sval[i];
}

// out[i] = through[perm[i]] (through optional), perm the stable
// lexicographic argsort of the ncols columns (col0 most significant, the
// index last).  scratch: 6n + RADIX_BINS * (tiles + 1) + 2 * LEX_MAX_KEYS
// ints for n > RADIX_SMALL_N (two permutations, two (key, value) buffers,
// the counts, the digit totals and the columns' varying bits), unused
// otherwise.
extern "C" int gp_lex_sort(const void* col0, const void* col1, const void* col2,
                           const void* col3, const void* col4, const void* col5,
                           const void* col6, const void* col7, const int32_t* through,
                           int32_t* out, int32_t* scratch, int kind0, int kind1,
                           int kind2, int kind3, int kind4, int kind5, int kind6,
                           int kind7, int ncols, int n, cudaStream_t stream) {
  if (n <= 0 || ncols < 1 || ncols > LEX_MAX_KEYS) return n <= 0 ? 0 : -1;
  LexKeys keys = {{col0, col1, col2, col3, col4, col5, col6, col7},
                  {kind0, kind1, kind2, kind3, kind4, kind5, kind6, kind7}};
  if (n <= RADIX_SMALL_N) {
    k_radix_small<<<1, RADIX_THREADS, 0, stream>>>(keys, ncols, through, out, n);
    CHECK_LAUNCH();
    return (int)cudaGetLastError();
  }
  int tiles = (int)grid_for(n, RADIX_TILE);
  long ln = n;
  int32_t* perm_buf[2] = {scratch, scratch + ln};
  int32_t* counts = scratch + 6 * ln;
  int32_t* totals = counts + (long)RADIX_BINS * tiles;
  unsigned* varying = (unsigned*)(totals + RADIX_BINS);
  cudaError_t err = cudaMemsetAsync(varying, 0, 2 * LEX_MAX_KEYS * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const int32_t* perm = nullptr;
  for (int c = ncols - 1, j = 0; c >= 0; --c, ++j) {
    int kind = keys.kind[c];
    RadixPass P = {keys.col[c], kind, perm,
                   (uint32_t*)(scratch + 2 * ln), scratch + 3 * ln,
                   (uint32_t*)(scratch + 4 * ln), scratch + 5 * ln,
                   c == 0 ? out : perm_buf[j & 1], c == 0 ? through : nullptr,
                   varying + 2 * c, 0, kind == 0 ? 4 : 1, kind == 0 ? 8 : 1};
    for (int p = 0; p < P.passes; ++p) {
      P.pass = p;
      k_radix_hist<<<tiles, RADIX_THREADS, 0, stream>>>(P, counts, tiles, n);
      CHECK_LAUNCH();
      k_radix_scan<<<grid_for(1 << P.bits, RADIX_WARPS), RADIX_THREADS, 0, stream>>>(
          P, counts, totals, tiles);
      CHECK_LAUNCH();
      k_radix_scatter<<<tiles, RADIX_THREADS, 0, stream>>>(P, counts, totals, tiles, n);
      CHECK_LAUNCH();
    }
    perm = P.out;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. link scan: one launch
// ---------------------------------------------------------------------------
// Row p of the key-sorted order (j = pos_s[p]) is a run head when its key
// differs from row p - 1's; its link is ok when a head's dependency is
// TERMINAL and any other row's is row p - 1's position.  run_start is the
// running max of head positions, lastbad that of rows whose link is not
// ok, chain_ok[p] = lastbad[p] < run_start[p], and n_residual counts the
// rows that are not chain_ok (fantoch_tpu/ops/graph_resolve.py:263-273).
//
// One pass over tiles of LS_TILE rows.  A tile loads its rows striped
// (pos_s, then pk and col through it; one extra read of row base - 1 for
// the first row's predecessor), keeps keys and positions in shared memory,
// scans them blocked, LS_ITEMS consecutive rows a thread, and carries one
// aggregate across tiles (LinkAgg): the last head and the last bad row, and
// the count of rows that are not chain_ok as a function of the rows before
// the tile.  That count splits at the tile's first head: the rows after it
// do not depend on what came before; the L rows before it are all not ok
// when the run they continue is already broken (its last bad row at or
// past its head) and otherwise all but the first f (the rows before the
// first bad one).  So (h, b, c, L, f) composes associatively, and the last
// tile writes n_residual itself: no fill and no atomicAdd.
//
// Forms: up to the wrapper's gate (LINK_CTA_ROWS) one block walks the
// tiles in order and carries the aggregate in registers.  Above it every
// tile is a block, and the aggregate crosses tiles by decoupled look-back
// (Merrill & Garland): a tile publishes its aggregate, a warp combines its
// predecessors' back to the nearest inclusive prefix, then the tile
// publishes its own.  Tiles take their index from a ticket, so a tile only
// waits on tiles already running; the block that takes the last ticket
// sets the ticket back to 0 for the next call (every other block took its
// ticket before it).
//
// No memset: the status words live in a buffer the wrapper allocates
// zeroed once per device and keeps (ops/graph_plane_kernels.py
// lookback), and each call passes a new epoch (1, 2, ...; the buffer is
// replaced before the epoch would reach 2^29).  A flag is epoch * 4 +
// LB_AGG or + LB_INCL, so a flag any earlier call left (a smaller epoch,
// or the zeroed 0) never equals a flag of this call, and a tile spins
// until its predecessor wrote this call's flag.  Values go out before
// their flag, a __threadfence between them, and are read after the flag,
// a __threadfence between them.  Calls on one buffer follow each other on
// one stream (the port uses one stream a device).
//
// Bound: bytes (pos_s streamed, pk and col gathered through it, dep_s,
// run_start and chain_ok written once).

#define LS_THREADS 256
#define LS_ITEMS 8
#define LS_TILE (LS_THREADS * LS_ITEMS)
#define LS_WARPS (LS_THREADS / 32)
#define LB_HEAD 16     // ints before the first tile's status: [0] is the ticket
#define LB_STATUS 16   // ints of a tile's status: flag, aggregate, inclusive
#define LB_AGG 1       // the tile's aggregate is published
#define LB_INCL 2      // its inclusive prefix is published
#define LB_EPOCH_STEP 4  // a flag: epoch * LB_EPOCH_STEP + LB_AGG or LB_INCL

// the look-back buffer's layout as this source has it (checked against the
// wrappers' when the library is loaded): head ints, status ints a tile, the
// aggregate's and the inclusive prefix's flag, epochs' step in a flag
extern "C" void gp_lookback_layout(int32_t* out) {
  out[0] = LB_HEAD;
  out[1] = LB_STATUS;
  out[2] = LB_AGG;
  out[3] = LB_INCL;
  out[4] = LB_EPOCH_STEP;
}

struct LinkAgg {
  int h, b, c, L, f;  // last head, last bad row, not-ok count, lead rows, lead rows before a bad one
  __device__ static LinkAgg none() { return {-1, -1, 0, 0, 0}; }
  __device__ void put(int32_t* p) const {
    p[0] = h;
    p[1] = b;
    p[2] = c;
    p[3] = L;
    p[4] = f;
  }
  __device__ static LinkAgg get(const int32_t* p) {
    const volatile int32_t* q = p;
    return {q[0], q[1], q[2], q[3], q[4]};
  }
};

// a then b (b's rows follow a's)
__device__ __forceinline__ LinkAgg combine(LinkAgg a, LinkAgg b) {
  if (a.h >= 0) {
    int lead = a.b >= a.h ? b.L : b.L - b.f;  // b's lead rows that are not ok
    return {max(a.h, b.h), max(a.b, b.b), a.c + b.c + lead, a.L, a.f};
  }
  return {b.h, max(a.b, b.b), a.c + b.c, a.L + b.L, a.f < a.L ? a.f : a.L + b.f};
}

__device__ __forceinline__ LinkAgg shfl(LinkAgg x, int src) {
  return {__shfl_sync(FULL_MASK, x.h, src), __shfl_sync(FULL_MASK, x.b, src),
          __shfl_sync(FULL_MASK, x.c, src), __shfl_sync(FULL_MASK, x.L, src),
          __shfl_sync(FULL_MASK, x.f, src)};
}

// decoupled look-back for tile `tile` of aggregate `agg` in this call's
// `epoch`: publishes the aggregate, combines the tiles before it (a warp
// reads 32 statuses at a time, back to the nearest inclusive prefix),
// publishes the inclusive prefix and returns the exclusive one to every
// thread.  `status` is the call's look-back buffer (LB_HEAD ints, then
// LB_STATUS a tile); *sh is block-shared.
template <class S>
__device__ S look_back(int32_t* status, int tile, S agg, int epoch, S* sh) {
  int32_t* mine = status + LB_HEAD + (long)tile * LB_STATUS;
  const int agg_flag = epoch * LB_EPOCH_STEP + LB_AGG;
  const int incl_flag = epoch * LB_EPOCH_STEP + LB_INCL;
  if (threadIdx.x == 0) {
    agg.put(mine + 1);
    __threadfence();
    *(volatile int32_t*)mine = agg_flag;
  }
  if (threadIdx.x < 32) {
    int lane = threadIdx.x;
    S acc = S::none();
    for (int base = tile - 1;; base -= 32) {
      int j = base - lane;
      int flag = incl_flag;
      S v = S::none();
      if (j >= 0) {
        const int32_t* st = status + LB_HEAD + (long)j * LB_STATUS;
        do {
          flag = *(const volatile int32_t*)st;
        } while (flag != agg_flag && flag != incl_flag);
        __threadfence();
        v = S::get(st + (flag == incl_flag ? 8 : 1));
      }
      unsigned incl = __ballot_sync(FULL_MASK, flag == incl_flag);
      int stop = incl ? __ffs(incl) - 1 : 31;
      if (lane > stop) v = S::none();
      // lane 0 takes the window's combination, the farthest tile first
      for (int d = 1; d < 32; d <<= 1) {
        S y = shfl(v, lane + d < 32 ? lane + d : lane);
        if (lane + d < 32) v = combine(y, v);
      }
      acc = combine(shfl(v, 0), acc);
      if (incl) break;
    }
    if (lane == 0) {
      combine(acc, agg).put(mine + 8);
      __threadfence();
      *(volatile int32_t*)mine = incl_flag;
      *sh = acc;
    }
  }
  __syncthreads();
  S out = *sh;
  __syncthreads();
  return out;
}

// a tile's index: from the ticket; the last one sets it back to 0
__device__ int take_tile(int32_t* ticket, int tiles, int* sh) {
  if (threadIdx.x == 0) {
    int t = atomicAdd(ticket, 1);
    if (t == tiles - 1) atomicCAS(ticket, tiles, 0);
    *sh = t;
  }
  __syncthreads();
  int t = *sh;
  __syncthreads();
  return t;
}

struct LinkShared {
  int key[LS_TILE];
  int pos[LS_TILE];
  int dep[LS_TILE];
  uint8_t bits[LS_TILE];  // a row's head (1) and bad (2) bits
  int w[5][LS_WARPS];  // per-warp partials
  LinkAgg prefix;
  int prev_key, prev_pos, tile;
};

// warp max of x and of y, min of u and v, sum of s
__device__ __forceinline__ void warp_fold(int& x, int& y, int& u, int& v, int& s) {
  for (int d = 16; d > 0; d >>= 1) {
    int lane = threadIdx.x & 31;
    int src = lane + d < 32 ? lane + d : lane;
    int x2 = __shfl_sync(FULL_MASK, x, src), y2 = __shfl_sync(FULL_MASK, y, src);
    int u2 = __shfl_sync(FULL_MASK, u, src), v2 = __shfl_sync(FULL_MASK, v, src);
    int s2 = __shfl_sync(FULL_MASK, s, src);
    if (lane + d < 32) {
      x = max(x, x2);
      y = max(y, y2);
      u = min(u, u2);
      v = min(v, v2);
      s += s2;
    }
  }
}

// one tile: dep_s, run_start and chain_ok of its rows; returns the tile's
// inclusive prefix (the rows before it and its own).  `tiled`: the prefix
// comes by look-back; otherwise it is `prefix`, carried by the one block.
__device__ LinkAgg link_tile(const int32_t* pk, const int32_t* col, const int32_t* pos_s,
                             int32_t* dep_s, int32_t* run_start, uint8_t* chain_ok,
                             int32_t* status, int n, int epoch, int tile, bool tiled,
                             LinkAgg prefix, LinkShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long base = (long)tile * LS_TILE;
  const int cnt = (int)min((long)LS_TILE, n - base);
  // striped loads, consecutive threads on consecutive rows: every load
  // of the tile issued before any store (a store could alias a later
  // load, which would then wait for it)
  int jj[LS_ITEMS], kk[LS_ITEMS], dd[LS_ITEMS];
#pragma unroll
  for (int i = 0; i < LS_ITEMS; ++i) {
    int r = i * LS_THREADS + tid;
    jj[i] = r < cnt ? pos_s[base + r] : 0;
  }
  int jp = tid == 0 && base > 0 ? pos_s[base - 1] : 0;
#pragma unroll
  for (int i = 0; i < LS_ITEMS; ++i) {
    int r = i * LS_THREADS + tid;
    kk[i] = r < cnt ? pk[jj[i]] : 0;
    dd[i] = r < cnt ? col[jj[i]] : 0;
  }
  int kp = tid == 0 && base > 0 ? pk[jp] : 0;
#pragma unroll
  for (int i = 0; i < LS_ITEMS; ++i) {
    int r = i * LS_THREADS + tid;
    if (r < cnt) {
      sh.pos[r] = jj[i];
      sh.key[r] = kk[i];
      sh.dep[r] = dd[i];
      dep_s[base + r] = dd[i];
    }
  }
  if (tid == 0) {
    sh.prev_pos = jp;
    sh.prev_key = kp;
  }
  __syncthreads();
  // blocked, LS_ITEMS consecutive rows a thread: each row's head and bad
  // bits (shared memory), and the thread's last head and last bad row
  int hh = -1, bb = -1, first_head = INT_MAX, first_bad = INT_MAX;
#pragma unroll
  for (int k = 0; k < LS_ITEMS; ++k) {
    int r = tid * LS_ITEMS + k;
    int bits = 0;
    if (r < cnt) {
      long p = base + r;
      int pkey = r ? sh.key[r - 1] : sh.prev_key;
      int ppos = r ? sh.pos[r - 1] : sh.prev_pos;
      bool head = p == 0 || pkey != sh.key[r];
      int d = sh.dep[r];
      bool ok = head ? d == TERMINAL : d == ppos;
      bits = (head ? 1 : 0) | (ok ? 0 : 2);
      if (head) {
        hh = (int)p;
        first_head = min(first_head, r);
      }
      if (!ok) {
        bb = (int)p;
        first_bad = min(first_bad, r);
      }
    }
    sh.bits[tid * LS_ITEMS + k] = (uint8_t)bits;
  }
  // exclusive max-scan of (hh, bb) over the threads, in order
  int ih = hh, ib = bb;
  for (int d = 1; d < 32; d <<= 1) {
    int h2 = __shfl_up_sync(FULL_MASK, ih, d), b2 = __shfl_up_sync(FULL_MASK, ib, d);
    if (lane >= d) {
      ih = max(ih, h2);
      ib = max(ib, b2);
    }
  }
  if (lane == 31) {
    sh.w[0][warp] = ih;
    sh.w[1][warp] = ib;
  }
  int eh = __shfl_up_sync(FULL_MASK, ih, 1), eb = __shfl_up_sync(FULL_MASK, ib, 1);
  if (lane == 0) eh = eb = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    eh = max(eh, sh.w[0][w]);
    eb = max(eb, sh.w[1][w]);
  }
  // the tile's aggregate: rows at or after the tile's first head that are
  // not ok do not depend on the rows before the tile
  int c = 0;
  {
    int h = eh, b = eb;
#pragma unroll
    for (int k = 0; k < LS_ITEMS; ++k) {
      int r = tid * LS_ITEMS + k;
      int bits = sh.bits[r];
      if (bits & 1) h = (int)base + r;
      if (bits & 2) b = (int)base + r;
      if (r < cnt && h >= 0 && b >= h) ++c;
    }
  }
  int th = hh, tb = bb;
  warp_fold(th, tb, first_head, first_bad, c);
  __syncthreads();  // every thread has read sh.w
  if (lane == 0) {
    sh.w[0][warp] = th;
    sh.w[1][warp] = tb;
    sh.w[2][warp] = first_head;
    sh.w[3][warp] = first_bad;
    sh.w[4][warp] = c;
  }
  __syncthreads();
  if (tid == 0) {
    int h = -1, b = -1, fh = INT_MAX, fb = INT_MAX, cc = 0;
    for (int w = 0; w < LS_WARPS; ++w) {
      h = max(h, sh.w[0][w]);
      b = max(b, sh.w[1][w]);
      fh = min(fh, sh.w[2][w]);
      fb = min(fb, sh.w[3][w]);
      cc += sh.w[4][w];
    }
    int L = fh == INT_MAX ? cnt : fh;
    sh.prefix = {h, b, cc, L, min(fb, L)};  // the tile's aggregate, for now
  }
  __syncthreads();
  LinkAgg agg = sh.prefix;
  __syncthreads();
  LinkAgg before = tiled ? look_back(status, tile, agg, epoch, &sh.prefix) : prefix;
  // outputs, staged in shared memory (the keys and dependencies are no
  // longer read) and stored striped
  {
    int h = max(before.h, eh), b = max(before.b, eb);
#pragma unroll
    for (int k = 0; k < LS_ITEMS; ++k) {
      int r = tid * LS_ITEMS + k;
      int bits = sh.bits[r];
      if (bits & 1) h = (int)base + r;
      if (bits & 2) b = (int)base + r;
      if (r < cnt) {
        sh.key[r] = h;
        sh.dep[r] = b < h;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < LS_ITEMS; ++i) {
    int r = i * LS_THREADS + tid;
    if (r < cnt) {
      run_start[base + r] = sh.key[r];
      chain_ok[base + r] = (uint8_t)sh.dep[r];
    }
  }
  __syncthreads();
  return combine(before, agg);
}

// tiled: a block a tile; one_cta: one block walks every tile in order
__global__ void __launch_bounds__(LS_THREADS)
    k_link_scan(const int32_t* pk, const int32_t* col, const int32_t* pos_s, int32_t* dep_s,
                int32_t* run_start, uint8_t* chain_ok, int32_t* n_residual,
                int32_t* status, int n, int epoch, int one_cta) {
  __shared__ LinkShared sh;
  int tiles = (int)(((long)n + LS_TILE - 1) / LS_TILE);
  if (one_cta) {
    LinkAgg acc = LinkAgg::none();
    for (int t = 0; t < tiles; ++t)
      acc = link_tile(pk, col, pos_s, dep_s, run_start, chain_ok, status, n, epoch, t,
                      false, acc, sh);
    if (threadIdx.x == 0) n_residual[0] = acc.c;
    return;
  }
  int tile = take_tile(status, tiles, &sh.tile);
  LinkAgg incl = link_tile(pk, col, pos_s, dep_s, run_start, chain_ok, status, n, epoch,
                           tile, true, LinkAgg::none(), sh);
  if (tile == tiles - 1 && threadIdx.x == 0) n_residual[0] = incl.c;
}

// status: the call's look-back buffer (LB_HEAD + LB_STATUS ints a tile,
// zeroed once when allocated; unused by the one-CTA form); epoch: this
// call's, above every earlier call's on the same buffer
extern "C" int gp_link_scan(const int32_t* pk, const int32_t* col, const int32_t* pos_s,
                            int32_t* dep_s, int32_t* run_start, uint8_t* chain_ok,
                            int32_t* n_residual, int32_t* status, int n, int epoch,
                            int one_cta, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  unsigned grid = one_cta || n == 0 ? 1 : grid_for(n, LS_TILE);  // n = 0: n_residual = 0
  k_link_scan<<<grid, LS_THREADS, 0, stream>>>(pk, col, pos_s, dep_s, run_start, chain_ok,
                                               n_residual, status, n, epoch, one_cta);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 4. residual view: two launches, no fill
// ---------------------------------------------------------------------------
// The gather writes the residual rows' columns and, for each valid row r,
// remap[rpos[r]] = (epoch, r) (residual positions are distinct).  The local
// map, once the remap has landed, reads the entry at a row's dependency and
// takes its row only when its epoch is this call's: any other entry (an
// earlier call's, or the 0 of a zeroed buffer) reads as TERMINAL, as the
// reference's remap filled with TERMINAL does.  So no fill: the remap is a
// buffer of 64-bit words, (epoch << 32) | r, that the wrapper allocates
// zeroed once a device, grows and keeps (ops/graph_plane_kernels.py
// remap_buffer), and each call passes a new epoch (1, 2, ...; a new zeroed
// buffer before it would pass 2^31 - 1).  Calls on one buffer follow each
// other on one stream.  The gather leaves a valid row's dependency in
// rdep_local, which the local map (one thread a row) replaces in place by
// its residual-local slot: no scratch column.
// Bound: bytes (p_r streamed; pos_s, src, seq gathered at res_n rows,
// dep_s and run_start at the n_residual valid ones; five res_n-row outputs;
// a remap entry written and read a valid row).  But each launch waits on
// dependent loads (p_r, then pos_s, then src and seq; the row's dep, then
// its remap entry), and at phase 2's 32,768 rows a launch of either takes
// little more than at one row.  (Gathering src and seq in the second
// launch instead, through rpos, moved the wait and saved nothing on an
// H100.)

__global__ void k_residual_gather(const int32_t* p_r, const int32_t* pos_s,
                                  const int32_t* dep_s, const int32_t* run_start,
                                  const int32_t* src, const int32_t* seq, int32_t* rpos,
                                  int32_t* rrs, int32_t* rsrc, int32_t* rseq,
                                  int32_t* rdep_local, u64* remap, int m, int n_residual,
                                  unsigned epoch) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  int pr = p_r[r];
  int pos = pos_s[pr];
  bool valid = r < n_residual;
  rpos[r] = pos;
  rrs[r] = valid ? run_start[pr] : INT_MAX;
  rsrc[r] = src[pos];
  rseq[r] = seq[pos];
  if (valid) {
    rdep_local[r] = dep_s[pr];  // the local map's input
    remap[pos] = (u64)epoch << 32 | (unsigned)r;
  }
}

__global__ void k_residual_local(int32_t* rdep_local, const u64* remap, int m, int batch,
                                 int n_residual, unsigned epoch) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  int d = TERMINAL;
  if (r < n_residual) {
    d = rdep_local[r];
    if (d >= 0) {
      u64 w = remap[d < batch ? d : batch - 1];
      d = (unsigned)(w >> 32) == epoch ? (int)(unsigned)w : TERMINAL;
    }
  }
  rdep_local[r] = d;
}

// remap: at least batch 64-bit words, each (epoch << 32) | row or of an
// earlier epoch; epoch: this call's, above every earlier call's on remap
extern "C" int gp_residual_view(const int32_t* p_r, const int32_t* pos_s,
                                const int32_t* dep_s, const int32_t* run_start,
                                const int32_t* src, const int32_t* seq, int32_t* rpos,
                                int32_t* rrs, int32_t* rsrc, int32_t* rseq,
                                int32_t* rdep_local, u64* remap, int m, int batch,
                                int n_residual, int epoch, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (epoch <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  k_residual_gather<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(
      p_r, pos_s, dep_s, run_start, src, seq, rpos, rrs, rsrc, rseq, rdep_local, remap, m,
      n_residual, (unsigned)epoch);
  CHECK_LAUNCH();
  k_residual_local<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(
      rdep_local, remap, m, batch, n_residual, (unsigned)epoch);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 5. group scan: one elementwise launch, no scan
// ---------------------------------------------------------------------------
// target[r] = firstbad[r] + (r - gstart[r]), where gstart is the first row
// of r's group (a group: consecutive rows of equal rrs) and firstbad the
// running max of p_r over the groups' first rows (group_scan_plain's two
// cummaxes, fantoch_tpu/ops/graph_resolve.py:302-309).
//
// Precondition (the reference's comment there): rrs is nondecreasing in
// p_r order, since run_start is monotone in position and the compaction
// by chain_ok is stable; the rows past n_residual carry INT_MAX and form
// the last group.  The same stability makes p_r increase over the rows
// before that group.  So a row's running max is p_r[gstart] itself,
// except in a group whose first p_r falls below the row before it (only
// the INT_MAX group: its first row is the first chain_ok position): there
// the max also takes in the first p_r of the group before.
//
// A warp takes 32 consecutive rows.  Their group heads are one ballot, so
// a row whose group starts in the warp finds its first row there; the
// group of the warp's first row, if it began before the warp, is found by
// one search of the warp over the rows before it, 32 probes a level (one a
// lane, log32 levels: 3 at 32,768 rows).  No scratch, no flag, no memset.
// (The first version searched by halving in every row: 15 dependent loads
// a row at 32,768 rows, 0.0051-0.0058 ms on an H100 against this one's
// fewer.)  Bound: bytes (rrs and p_r read, target written).

// the first row of the group that holds row hi (rrs nondecreasing over
// [0, hi]); every lane of the warp calls it with the same hi
__device__ int warp_group_first(const int32_t* rrs, int hi) {
  const int lane = threadIdx.x & 31;
  const int v = rrs[hi];
  int lo = 0;  // the answer lies in [lo, hi], and rrs[hi] == v
  while (lo < hi) {
    int step = (hi - lo + 31) >> 5;
    int at = min(lo + lane * step, hi);
    // the probes below v are a prefix of the lanes
    int below = __popc(__ballot_sync(FULL_MASK, rrs[at] < v));
    if (below == 0) return lo;
    int next = lo + (below - 1) * step + 1;
    if (below < 32) hi = min(lo + below * step, hi);
    lo = next;
  }
  return lo;
}

// the first row of the group holding lane k's row, given the warp's heads
// and the first row of the group that began before the warp
__device__ __forceinline__ int first_in_warp(unsigned heads, int k, int base, int carried) {
  unsigned upto = heads & (FULL_MASK >> (31 - k));
  return upto ? base + 31 - __clz(upto) : carried;
}

__global__ void k_group_scan(const int32_t* rrs, const int32_t* p_r, int32_t* target,
                             int m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int base = r - lane;
  if (base >= m) return;  // the whole warp
  const bool in = r < m;
  const int v = in ? rrs[r] : 0;
  const unsigned heads = __ballot_sync(FULL_MASK, in && (r == 0 || rrs[r - 1] != v));
  const int carried = heads & 1u ? base : warp_group_first(rrs, base);
  const int gstart = first_in_warp(heads, lane, base, carried);
  int firstbad = in ? p_r[gstart] : 0;
  // a group whose first p_r falls: also the first p_r of the group before
  bool falls = in && gstart > 0 && p_r[gstart - 1] > firstbad;
  for (unsigned need = __ballot_sync(FULL_MASK, falls); need;) {
    int at = __shfl_sync(FULL_MASK, gstart, __ffs(need) - 1) - 1;
    int first = at >= base ? first_in_warp(heads, at - base, base, carried)
                           : warp_group_first(rrs, at);
    bool mine = falls && gstart - 1 == at;
    if (mine) firstbad = max(firstbad, p_r[first]);
    need &= ~__ballot_sync(FULL_MASK, mine);
  }
  if (in) target[r] = firstbad + (r - gstart);
}

extern "C" int gp_group_scan(const int32_t* rrs, const int32_t* p_r, int32_t* target,
                             int m, cudaStream_t stream) {
  if (m <= 0) return 0;
  k_group_scan<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(rrs, p_r, target, m);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 6. pointer doubling (_doubling_core)
// ---------------------------------------------------------------------------
// The reference (fantoch_tpu/ops/graph_resolve.py:96-153), bit for bit:
// pass 1 doubles (jump, acc) L = num_doubling_steps(n) times (2^L >= 2n),
// acc the least id on the first 2^t hops; a row is nonterminating when its
// end, jump after pass 1, is not absorbing (TERMINAL or MISSING); the
// closure marks the cycles of the nonterminating components; pass 2
// doubles (jump2, dist2) L times over the graph cut at the cycles.
//
// The closure as one scatter.  The reference seeds each cycle's least id
// and marks p^(2^t) of every mark, t = 0..L-1, among nonterminating rows.
// Here on_cycle[end[i]] = 1 for every nonterminating i, which marks the
// same rows:
//   - a nonterminating walk's tail has fewer than n <= 2^(L-1) hops, so
//     end[i] = p^(2^L)(i) lies on i's cycle: only cycle rows are marked;
//   - p^(2^L) maps each cycle onto itself one to one, so every row of a
//     cycle is the end of some row of it: every cycle row is marked;
//   - the reference's marks stay on the cycle (p maps it into itself) and
//     cover it (it is shorter than 2^L hops from its seed), so its column
//     is the same.
// Every writer stores 1, so plain stores do and no atomic is needed; the
// column is zeroed in the barrier phase before.  The
// reference's cyc_leader[i] = acc[end[i]] is read only where on_cycle[i],
// and there acc[i] itself is the cycle's least id (2^L hops from i walk the
// whole cycle), so pass 1's last step parks acc in `leader` and the final
// step keeps it on the cycle and writes i elsewhere.
//
// Pass 2 may stop early.  If a step changes no (jump2, dist2) word, every
// jump2[i] is a fixed point of p2: a non-absorbing2 row that returned to
// itself would lie on a cycle, and cycle rows are absorbing2.  Absorbing2
// rows carry dist2 0, so every later step leaves both words as they are,
// and its steps may do nothing.  A step's changed words are DBL_SLOTS
// ints on lines of their own (a block sets its slot, blockIdx.x %
// DBL_SLOTS, with a plain store of 1 where it reads 0: hundreds of blocks
// storing to one word would queue at one L2 slice), and after the barrier
// every block's warp reads them and all stop where they are all 0.
// Pass 1 keeps its L steps: acc can settle while end is still on a tail.
//
// State: one 64-bit word a row, (jump, acc) in pass 1 and (jump2, dist2) in
// pass 2 (jump in the low half), so a step gathers one 8-byte word at its
// jump; two ping-pong columns, pass 2 reusing pass 1's once the closure has
// read end.  Init folds into the first step of each pass and the final
// outputs into pass 2's last step, so no step's jumps are kept; so does the
// plane's epilogue when the wrapper asks for it (the keyed plane step's
// overflow branch, whose rows are the window's).
//
// One cooperative launch, rows grid-stride over the co-resident grid, a
// grid barrier between steps.  (A chain of launches, L + 1 + L, was built
// and timed too: behind the cooperative launch at every size from 16,384
// rows to 2^20 on an H100, so it went; so did one block with its columns in
// shared memory, ahead only below 16,384 rows, a size no path calls it at.)
// Bound: bytes, but the gathers are random, so a step runs at the card's
// gather rate.

#define DBL_BLOCK_MAX 1024  // threads a block at most

__device__ __forceinline__ bool absorbing(int d) { return d == TERMINAL || d == MISSING; }
__device__ __forceinline__ u64 dbl_pack(int jump, int value) {
  return (u64)(unsigned)jump | ((u64)(unsigned)value << 32);
}
__device__ __forceinline__ int dbl_jump(u64 s) { return (int)(unsigned)(s & 0xffffffffull); }
__device__ __forceinline__ int dbl_value(u64 s) { return (int)(unsigned)(s >> 32); }

#define DBL_SLOTS 32      // changed words a step
#define DBL_SLOT_INTS 32  // ints from one to the next: a 128-byte line each

struct Doubling {
  const int32_t* dep;
  uint8_t *resolved, *on_cycle;
  int32_t *rank, *leader;
  int32_t* changed;  // pass 2's changed words: DBL_SLOTS a step, DBL_SLOT_INTS apart
  int n, steps;
  // the plane's epilogue folded into the final step (§8), or all null
  const uint8_t* occ;
  uint8_t *executed, *newly;
};

// the block sets its changed word of step t (where it reads 0)
__device__ __forceinline__ void dbl_set_changed(const Doubling& d, int t) {
  volatile int32_t* w =
      d.changed + ((long)t * DBL_SLOTS + blockIdx.x % DBL_SLOTS) * DBL_SLOT_INTS;
  if (*w == 0) *w = 1;
}

// whether step t changed a word: a warp reads the step's words; every
// thread of the block must call it
__device__ __forceinline__ bool dbl_changed(const Doubling& d, int t, int* sh) {
  if (threadIdx.x < 32) {
    int v = 0;
    if (threadIdx.x < DBL_SLOTS)
      v = *(const volatile int32_t*)(d.changed +
                                     ((long)t * DBL_SLOTS + threadIdx.x) * DBL_SLOT_INTS);
    unsigned any = __ballot_sync(FULL_MASK, v != 0);
    if (threadIdx.x == 0) *sh = any != 0;
  }
  __syncthreads();
  bool out = *sh != 0;
  __syncthreads();
  return out;
}

// zeroes changed word i (i < steps * DBL_SLOTS)
__device__ __forceinline__ void dbl_zero_changed(const Doubling& d, long i) {
  d.changed[i * DBL_SLOT_INTS] = 0;
}

// pass 1's first step, from dep: jump0 = i (absorbing) or dep, acc0 = n or
// dep; then acc1 = min(acc0, acc0[jump0]), jump1 = jump0[jump0]
__device__ __forceinline__ u64 dbl1_first(const Doubling& d, int i) {
  int j = d.dep[i];
  if (absorbing(j)) return dbl_pack(i, d.n);
  int dj = d.dep[j];
  return absorbing(dj) ? dbl_pack(j, min(j, d.n)) : dbl_pack(dj, min(j, dj));
}

// the closure: the end of a nonterminating row is on its cycle
__device__ __forceinline__ void dbl_mark(const Doubling& d, const u64* end, int i) {
  int e = dbl_jump(end[i]);
  if (!absorbing(d.dep[e])) d.on_cycle[e] = 1;
}

// pass 2's init and first step: absorbing2 rows (absorbing or on a cycle)
// keep (i, 0), the others (dep, 1); returns the state after the step and
// sets `moved` where it differs from the init
__device__ __forceinline__ u64 dbl2_first(const Doubling& d, int i, bool* moved) {
  int j = d.dep[i];
  if (absorbing(j) || d.on_cycle[i]) {
    *moved = false;
    return dbl_pack(i, 0);
  }
  int dj = d.dep[j];
  bool stop = absorbing(dj) || d.on_cycle[j];  // the init (j, 1) stays
  *moved = !stop;
  return stop ? dbl_pack(j, 1) : dbl_pack(dj, 2);
}

__device__ __forceinline__ void dbl_final(const Doubling& d, int i, u64 s) {
  int j = dbl_jump(s);
  bool oc = d.on_cycle[i] != 0;
  bool res = oc || d.dep[j] == TERMINAL || d.on_cycle[j] != 0;
  d.resolved[i] = res;
  d.rank[i] = res ? dbl_value(s) : UNRESOLVED_RANK;
  if (!oc) d.leader[i] = i;
  if (d.newly) epilogue_row(d.occ, d.executed, d.newly, i, res);
}

// pass 1's last step parks acc in leader and zeroes on_cycle for the
// closure after it
__device__ __forceinline__ void dbl1_last(const Doubling& d, int i, u64 s) {
  d.leader[i] = dbl_value(s);
  d.on_cycle[i] = 0;
}

// --- the cooperative launch ----------------------------------------------

#define DBL_ROWS(v, n)                                               \
  for (long v = (long)blockIdx.x * blockDim.x + threadIdx.x; v < (n); \
       v += (long)gridDim.x * blockDim.x)

#define DBL_ILP 4  // rows a thread takes at once in a doubling step

// one doubling step of pass 1 (PASS 1: acc the min) or pass 2 (dist the
// sum) over the rows a thread walks, DBL_ILP rows at a time: their words
// first, then their gathers, so a thread keeps DBL_ILP gathers in flight.
// `last`: pass 1's parks acc and zeroes on_cycle, pass 2's writes the
// outputs instead of a column.  Returns whether a row's word changed.
template <int PASS>
__device__ __forceinline__ bool dbl_step_rows(const Doubling& d, const u64* cur, u64* nxt,
                                              bool last) {
  long stride = (long)gridDim.x * blockDim.x;
  bool any = false;
  for (long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x; i0 < d.n;
       i0 += DBL_ILP * stride) {
    u64 s[DBL_ILP], t[DBL_ILP];
#pragma unroll
    for (int k = 0; k < DBL_ILP; ++k) {
      long i = i0 + k * stride;
      s[k] = i < d.n ? cur[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < DBL_ILP; ++k) t[k] = i0 + k * stride < d.n ? cur[dbl_jump(s[k])] : 0;
#pragma unroll
    for (int k = 0; k < DBL_ILP; ++k) {
      long i = i0 + k * stride;
      if (i >= d.n) break;
      int v = PASS == 1 ? min(dbl_value(s[k]), dbl_value(t[k]))
                        : dbl_value(s[k]) + dbl_value(t[k]);
      u64 out = dbl_pack(dbl_jump(t[k]), v);
      if (PASS == 2 && last) {
        dbl_final(d, (int)i, out);
        continue;
      }
      nxt[i] = out;
      if (PASS == 1 && last) dbl1_last(d, (int)i, out);
      any |= out != s[k];
    }
  }
  return any;
}

// every step of both passes, grid barriers between them; col0, col1: two
// columns of n words; sh: an int of the block's shared memory
// (dbl_changed's broadcast)
__device__ void dbl_all(const Doubling& d, u64* col0, u64* col1, int* sh) {
  // the two columns as a pair of pointers swapped by value (an array of
  // them indexed at run time would live in a stack frame)
  u64* cur = col0;
  u64* nxt = col1;
  if (blockIdx.x == 0)
    for (long t = threadIdx.x; t < (long)d.steps * DBL_SLOTS; t += blockDim.x)
      dbl_zero_changed(d, t);
  DBL_ROWS(i, d.n) cur[i] = dbl1_first(d, (int)i);
  cg::this_grid().sync();
  for (int t = 1; t < d.steps; ++t) {
    dbl_step_rows<1>(d, cur, nxt, t == d.steps - 1);
    u64* w = cur;
    cur = nxt;
    nxt = w;
    cg::this_grid().sync();
  }
  // cur holds pass 1's end; pass 2 writes the other column, then alternates
  DBL_ROWS(i, d.n) dbl_mark(d, cur, (int)i);
  cg::this_grid().sync();
  bool any = false;
  DBL_ROWS(i, d.n) {
    bool moved;
    nxt[i] = dbl2_first(d, (int)i, &moved);
    any |= moved;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) dbl_set_changed(d, 0);
  {
    u64* w = cur;
    cur = nxt;
    nxt = w;
  }
  cg::this_grid().sync();
  for (int t = 1; t < d.steps; ++t) {
    // every block reads the words after the barrier that ends step t - 1,
    // so all take the same branch
    if (!dbl_changed(d, t - 1, sh)) break;
    bool last = t == d.steps - 1;
    any = dbl_step_rows<2>(d, cur, nxt, last);
    if (last) return;
    if (__syncthreads_or(any) && threadIdx.x == 0) dbl_set_changed(d, t);
    u64* w = cur;
    cur = nxt;
    nxt = w;
    cg::this_grid().sync();
  }
  // stopped early: every later step would leave cur as it is
  DBL_ROWS(i, d.n) dbl_final(d, (int)i, cur[i]);
}

__global__ void __launch_bounds__(DBL_BLOCK_MAX) k_dbl_coop(Doubling d, u64* col0,
                                                             u64* col1) {
  extern __shared__ u64 dbl_smem[];
  dbl_all(d, col0, col1, (int*)dbl_smem);
}

// the co-resident grid of a cooperative launch of `kernel`: the SM count
// times the blocks of `block` threads one SM holds, at most `want`,
// queried once per (kernel, block, device) and kept; a card without
// cooperative launches refuses (never a fallback)
struct DblGrid {
  const void* kernel;
  int block, dev;
  long blocks;
};
#define DBL_GRIDS 16
static DblGrid dbl_grids[DBL_GRIDS];
static int n_dbl_grids = 0;
static std::mutex dbl_grids_mu;

template <class F>
static int dbl_coop_grid(F kernel, int block, long want, int* grid) {
  int dev = 0;
  CHECK_CALL(cudaGetDevice(&dev));
  long blocks = -1;
  {
    std::lock_guard<std::mutex> lock(dbl_grids_mu);
    for (int i = 0; i < n_dbl_grids; ++i)
      if (dbl_grids[i].kernel == (const void*)kernel && dbl_grids[i].block == block &&
          dbl_grids[i].dev == dev)
        blocks = dbl_grids[i].blocks;
  }
  if (blocks < 0) {
    int coop = 0, sms = 0, per_sm = 0;
    CHECK_CALL(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    CHECK_CALL(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                             sizeof(int)));
    blocks = (long)sms * per_sm;
    std::lock_guard<std::mutex> lock(dbl_grids_mu);
    if (n_dbl_grids < DBL_GRIDS) dbl_grids[n_dbl_grids++] = {(const void*)kernel, block,
                                                             dev, blocks};
  }
  long g = want < blocks ? want : blocks;
  if (g < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = (int)g;
  return 0;
}

// one cooperative launch of blocks of `block` threads.  scratch: 4n +
// steps * DBL_SLOTS * DBL_SLOT_INTS ints (the two columns, then the changed
// words).  occ, executed, newly: the plane's epilogue over the same n rows
// (§8), folded into the final step where each row's resolved flag is made;
// all three or none.
extern "C" int gp_pointer_doubling(const int32_t* dep, uint8_t* resolved, int32_t* rank,
                                   int32_t* leader, uint8_t* on_cycle, int32_t* scratch,
                                   const uint8_t* occ, uint8_t* executed, uint8_t* newly,
                                   int n, int steps, int block, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (steps < 2) return (int)cudaErrorInvalidValue;
  if (!epilogue_args_ok(occ, executed, newly)) return (int)cudaErrorInvalidValue;
  u64* col0 = (u64*)scratch;
  u64* col1 = col0 + n;
  Doubling d = {dep,   resolved, on_cycle, rank, leader, (int32_t*)(col1 + n),
                n,     steps,    occ,      executed, newly};
  if (block <= 0 || block % 32 || block > DBL_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  int grid = 0;
  int err = dbl_coop_grid(k_dbl_coop, block, (n + block - 1) / block, &grid);
  if (err) return err;
  void* args[] = {&d, &col0, &col1};
  CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_dbl_coop, dim3(grid), dim3(block),
                                         args, sizeof(int), stream));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 7. emit scatter: two launches, no fill
// ---------------------------------------------------------------------------
// An init launch over the batch, then the scatter over the residual rows
// (the emit targets of one group are a permutation of its positions, so no
// two threads write one cell).
//
// The init takes index i twice, EMIT_ROWS consecutive indices a thread,
// read and written as words where the columns are aligned: as sorted
// position i it writes packed[i] and res_b[i] from chain_ok[i]; with the
// epilogue folded (branch "residual" of the keyed plane step) it also
// finishes vertex i as if it were resolved: newly[i] = occ[i] & ~executed[i],
// executed[i] |= newly[i].  Every access of the window-wide pass is
// coalesced.  The scatter writes packed and res_b at p_r[e[r]] for r <
// n_valid, and an unresolved row undoes the init's mark on its vertex v =
// flag_perm[p_r[e[r]]]: if newly[v] is set it clears newly[v] and
// executed[v].
//
// Why the fold equals the epilogue through flag_perm (vertex flag_perm[p]
// takes sorted position p's resolved flag).  The launcher folds only when
// n_residual <= m; then the scatter's positions are exactly the positions
// that are not chain_ok: p_r is the stable sort by chain_ok, so its first
// n_residual entries are them, and e, sorted first by rrs, puts the
// n_residual valid rows (rrs below INT_MAX) before the INT_MAX ones.  So a
// vertex whose position is chain_ok or resolved in the residual keeps the
// init's resolved mark, and a vertex whose position is an unresolved
// residual row is undone.  The undo is exact: newly[v] set means occ[v] and
// executed[v] false before the dispatch, so clearing both restores
// executed[v] and gives newly[v] = false; newly[v] clear means the init
// left executed[v] as it was.  Each vertex has exactly one writer in each
// launch: the init's thread of index v, and in the scatter the row of its
// position (flag_perm is a permutation, the positions p_r[e[r]] distinct).
//
// n_unres, written once, with no fill and no atomic: by the same argument
// the rows e[0 .. n_valid) are the rows 0 .. n_valid - 1, so n_unres is
// the residual rows beyond the buffer (overflow: unresolved) plus the
// count of l_resolved[0 .. n_valid) that are false.  Block 0 of the init
// launch counts them, 16 bytes a load, and writes it; the other blocks
// take the rows.  (The first version counted in the scatter, each block's
// count in a slot of the look-back buffer and the block that took the last
// ticket summing them: on an H100 its fences and ticket made the scatter
// 0.0031 ms at one residual row, where the scatter it replaced took 0.0018.)
// Bound: bytes (chain_ok read and packed, res_b written over the batch;
// folded, occ and executed read, newly written and executed where it
// changes; the residual rows' e, p_r, l_resolved and target, and flag_perm
// at the unresolved ones).

#define EMIT_ROWS 4  // indices an init thread takes

// 1 in each byte of w that is not 0, 0 in the others
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) >> 7) & 0x01010101u;
}

#define COUNT_LOADS 8  // 16-byte loads a counting thread has in flight

// block 0: n_unres = overflow + the false flags of l_resolved[0 .. n_valid),
// COUNT_LOADS loads issued before any is counted (one block's loads wait
// on latency, not on bandwidth)
__device__ void emit_count(const uint8_t* l_resolved, int32_t* n_unres, int n_valid,
                           int overflow, bool words) {
  __shared__ int sums[EW_BLOCK / 32];
  int resolved = 0, i = 0;
  if (words) {
    const uint4* wide = (const uint4*)l_resolved;
    const int n16 = n_valid / 16;
    for (int base = 0; base < n16; base += COUNT_LOADS * blockDim.x) {
      uint4 w[COUNT_LOADS];
#pragma unroll
      for (int u = 0; u < COUNT_LOADS; ++u) {
        int k = base + u * blockDim.x + threadIdx.x;
        uint4 v = {0u, 0u, 0u, 0u};
        if (k < n16) v = wide[k];
        w[u] = v;
      }
#pragma unroll
      for (int u = 0; u < COUNT_LOADS; ++u)
        resolved += __popc(nonzero_bytes(w[u].x)) + __popc(nonzero_bytes(w[u].y)) +
                    __popc(nonzero_bytes(w[u].z)) + __popc(nonzero_bytes(w[u].w));
    }
    i = n16 * 16;
  }
  for (i += threadIdx.x; i < n_valid; i += blockDim.x) resolved += l_resolved[i] != 0;
  resolved = __reduce_add_sync(FULL_MASK, resolved);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = resolved;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) total += sums[w];
    n_unres[0] = overflow + n_valid - total;
  }
}

// words: every byte column 4-byte aligned, packed and l_resolved 16-byte
// aligned
__global__ void __launch_bounds__(EW_BLOCK)
    k_emit_init(const uint8_t* chain_ok, int32_t* packed, uint8_t* res_b,
                const uint8_t* occ, uint8_t* executed, uint8_t* newly,
                const uint8_t* l_resolved, int32_t* n_unres, int batch, int n_valid,
                int overflow, int words) {
  if (blockIdx.x == 0) {
    emit_count(l_resolved, n_unres, n_valid, overflow, words);
    return;
  }
  const long i0 = ((long)(blockIdx.x - 1) * blockDim.x + threadIdx.x) * EMIT_ROWS;
  if (i0 >= batch) return;
  if (words && i0 + EMIT_ROWS <= batch) {
    uint32_t ok = nonzero_bytes(*(const uint32_t*)(chain_ok + i0));
    int4 pk;
    pk.x = (ok & 0x1u ? 0 : EMIT_UNRESOLVED_BIT) | (int)i0;
    pk.y = (ok & 0x100u ? 0 : EMIT_UNRESOLVED_BIT) | (int)(i0 + 1);
    pk.z = (ok & 0x10000u ? 0 : EMIT_UNRESOLVED_BIT) | (int)(i0 + 2);
    pk.w = (ok & 0x1000000u ? 0 : EMIT_UNRESOLVED_BIT) | (int)(i0 + 3);
    *(int4*)(packed + i0) = pk;
    *(uint32_t*)(res_b + i0) = ok;
    if (newly) {
      uint32_t ex = *(const uint32_t*)(executed + i0);
      uint32_t nw = nonzero_bytes(*(const uint32_t*)(occ + i0)) & ~nonzero_bytes(ex);
      *(uint32_t*)(newly + i0) = nw;
      if (nw) *(uint32_t*)(executed + i0) = ex | nw;
    }
    return;
  }
  for (long i = i0; i < i0 + EMIT_ROWS && i < batch; ++i) {
    bool res = chain_ok[i] != 0;
    packed[i] = (res ? 0 : EMIT_UNRESOLVED_BIT) | (int)i;
    res_b[i] = res;
    if (newly) epilogue_row(occ, executed, newly, i, true);
  }
}

__global__ void k_emit_scatter(const int32_t* e, const int32_t* p_r,
                               const uint8_t* l_resolved, const int32_t* target,
                               int32_t* packed, uint8_t* res_b, uint8_t* executed,
                               uint8_t* newly, const int32_t* flag_perm, int n_valid) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_valid) return;
  int s = e[r];
  int pr = p_r[s];
  bool res = l_resolved[s] != 0;
  packed[pr] = (res ? 0 : EMIT_UNRESOLVED_BIT) | target[r];
  res_b[pr] = res;
  if (newly && !res) {
    int v = flag_perm[pr];
    if (newly[v]) {  // the init marked it: undo
      newly[v] = 0;
      executed[v] = 0;
    }
  }
}

// occ, executed, newly, flag_perm: the folded epilogue (all four or none;
// only with n_residual <= m)
extern "C" int gp_emit_scatter(const int32_t* e, const int32_t* p_r,
                               const uint8_t* l_resolved, const int32_t* target,
                               const uint8_t* chain_ok, int32_t* packed, uint8_t* res_b,
                               int32_t* n_unres, const uint8_t* occ, uint8_t* executed,
                               uint8_t* newly, const int32_t* flag_perm, int m, int batch,
                               int n_residual, cudaStream_t stream) {
  if (batch < 0 || m < 0 || n_residual < 0) return (int)cudaErrorInvalidValue;
  if (!epilogue_args_ok(occ, executed, newly) || (newly == nullptr) != (flag_perm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (newly && n_residual > m) return (int)cudaErrorInvalidValue;
  int n_valid = n_residual < m ? n_residual : m;
  uintptr_t bytes = (uintptr_t)chain_ok | (uintptr_t)res_b | (uintptr_t)occ |
                    (uintptr_t)executed | (uintptr_t)newly;
  uintptr_t wide = (uintptr_t)packed | (uintptr_t)l_resolved;
  int words = (bytes & 3) == 0 && (wide & 15) == 0;
  // block 0 counts, the others take EMIT_ROWS rows a thread
  unsigned grid = 1 + grid_for((batch + EMIT_ROWS - 1) / EMIT_ROWS, EW_BLOCK);
  k_emit_init<<<grid, EW_BLOCK, 0, stream>>>(chain_ok, packed, res_b, occ, executed, newly,
                                             l_resolved, n_unres, batch, n_valid,
                                             n_residual - n_valid, words);
  CHECK_LAUNCH();
  if (n_valid > 0) {
    k_emit_scatter<<<grid_for(n_valid, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        e, p_r, l_resolved, target, packed, res_b, executed, newly, flag_perm, n_valid);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 8. epilogue
// ---------------------------------------------------------------------------
// A launch of its own only where no kernel makes the resolved flags: a
// keyed dispatch whose links all verify (flags null: all resolved) and the
// general fast path.  Elsewhere it is folded into the launch that makes
// them (§6, §7; graph_general.cu §10, §12).

__global__ void k_epilogue(const uint8_t* occ, uint8_t* executed, const uint8_t* flags,
                           const int32_t* flag_perm, uint8_t* newly, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  epilogue_row(occ, executed, newly, flag_perm ? flag_perm[p] : p,
               flags ? flags[p] != 0 : true);
}

extern "C" int gp_epilogue(const uint8_t* occ, uint8_t* executed, const uint8_t* flags,
                           const int32_t* flag_perm, uint8_t* newly, int n,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  k_epilogue<<<grid_for(n, EW_BLOCK), EW_BLOCK, 0, stream>>>(occ, executed, flags,
                                                             flag_perm, newly, n);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
