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
#include <stdint.h>
#include <climits>

#define TERMINAL (-1)
#define MISSING (-2)
#define UNRESOLVED_RANK INT_MAX
#define EMIT_UNRESOLVED_BIT (1 << 30)

#define EW_BLOCK 256     // elementwise kernels
#define SCAN_BLOCK 1024  // block scans (all threads take part)

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static inline unsigned grid_for(long n, int block) {
  return (unsigned)((n + block - 1) / block);
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
// block max-scan (inclusive cummax) with carried block totals
// ---------------------------------------------------------------------------

// Hillis-Steele inclusive max over the block; every thread must call it
__device__ int block_incl_max(int x, int* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    int y = threadIdx.x >= off ? sh[threadIdx.x - off] : INT_MIN;
    __syncthreads();
    if (threadIdx.x >= off) sh[threadIdx.x] = max(sh[threadIdx.x], y);
    __syncthreads();
  }
  return sh[threadIdx.x];
}

__global__ void k_scan_reduce(const int32_t* x, int32_t* bmax, int n) {
  __shared__ int sh[SCAN_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int inc = block_incl_max(i < n ? x[i] : INT_MIN, sh);
  if (threadIdx.x == blockDim.x - 1) bmax[blockIdx.x] = inc;
}

// one block: exclusive max-scan of the block totals
__global__ void k_scan_carry(const int32_t* bmax, int32_t* carry, int nb) {
  __shared__ int sh[SCAN_BLOCK];
  int running = INT_MIN;
  for (int base = 0; base < nb; base += blockDim.x) {
    int t = base + threadIdx.x;
    block_incl_max(t < nb ? bmax[t] : INT_MIN, sh);
    int excl = threadIdx.x > 0 ? sh[threadIdx.x - 1] : INT_MIN;
    int total = sh[blockDim.x - 1];
    if (t < nb) carry[t] = max(running, excl);
    running = max(running, total);
    __syncthreads();
  }
}

__global__ void k_scan_apply(const int32_t* x, int32_t* y, const int32_t* carry, int n) {
  __shared__ int sh[SCAN_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int inc = block_incl_max(i < n ? x[i] : INT_MIN, sh);
  if (i < n) y[i] = max(inc, carry[blockIdx.x]);
}

// y = cummax(x); scratch holds 2 * nblocks ints
static int cummax(const int32_t* x, int32_t* y, int32_t* scratch, int n,
                  cudaStream_t stream) {
  int nb = (int)grid_for(n, SCAN_BLOCK);
  int32_t* bmax = scratch;
  int32_t* carry = scratch + nb;
  k_scan_reduce<<<nb, SCAN_BLOCK, 0, stream>>>(x, bmax, n);
  CHECK_LAUNCH();
  k_scan_carry<<<1, SCAN_BLOCK, 0, stream>>>(bmax, carry, nb);
  CHECK_LAUNCH();
  k_scan_apply<<<nb, SCAN_BLOCK, 0, stream>>>(x, y, carry, n);
  CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// 3. link scan
// ---------------------------------------------------------------------------

__global__ void k_link_pre(const int32_t* pk, const int32_t* col, const int32_t* pos_s,
                           int32_t* dep_s, int32_t* x_head, int32_t* x_bad, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int j = pos_s[p];
  int k = pk[j];
  int d = col[j];
  dep_s[p] = d;
  bool head = p == 0 || pk[pos_s[p - 1]] != k;
  bool ok = head ? d == TERMINAL : d == pos_s[p - 1];
  x_head[p] = head ? p : 0;
  x_bad[p] = ok ? -1 : p;
}

__global__ void k_link_post(const int32_t* run_start, const int32_t* lastbad,
                            uint8_t* chain_ok, int32_t* n_residual, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  int bad = 0;
  if (p < n) {
    bool c = lastbad[p] < run_start[p];
    chain_ok[p] = c;
    bad = c ? 0 : 1;
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(n_residual, bad);
}

// scratch: 2n + 4 * nblocks ints; n_residual zeroed by the caller
extern "C" int gp_link_scan(const int32_t* pk, const int32_t* col, const int32_t* pos_s,
                            int32_t* dep_s, int32_t* run_start, uint8_t* chain_ok,
                            int32_t* n_residual, int32_t* scratch, int n,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  int32_t* x_head = scratch;
  int32_t* x_bad = scratch + n;
  int32_t* scan_tmp = scratch + 2L * n;
  k_link_pre<<<grid_for(n, EW_BLOCK), EW_BLOCK, 0, stream>>>(pk, col, pos_s, dep_s,
                                                             x_head, x_bad, n);
  CHECK_LAUNCH();
  int err = cummax(x_head, run_start, scan_tmp, n, stream);
  if (err) return err;
  err = cummax(x_bad, x_bad, scan_tmp, n, stream);  // lastbad, in place
  if (err) return err;
  k_link_post<<<grid_for(n, EW_BLOCK), EW_BLOCK, 0, stream>>>(run_start, x_bad,
                                                              chain_ok, n_residual, n);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 4. residual view
// ---------------------------------------------------------------------------

__global__ void k_residual_gather(const int32_t* p_r, const int32_t* pos_s,
                                  const int32_t* dep_s, const int32_t* run_start,
                                  const int32_t* src, const int32_t* seq, int32_t* rpos,
                                  int32_t* rrs, int32_t* rsrc, int32_t* rseq,
                                  int32_t* rdep, int32_t* remap, int m, int n_residual) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  int pr = p_r[r];
  int pos = pos_s[pr];
  bool valid = r < n_residual;
  rpos[r] = pos;
  rdep[r] = dep_s[pr];
  rrs[r] = valid ? run_start[pr] : INT_MAX;
  rsrc[r] = src[pos];
  rseq[r] = seq[pos];
  if (valid) remap[pos] = r;  // residual positions are distinct
}

__global__ void k_residual_local(const int32_t* rdep, const int32_t* remap,
                                 int32_t* rdep_local, int m, int batch, int n_residual) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  int d = rdep[r];
  int v = d >= 0 ? remap[d < batch ? d : batch - 1] : d;
  rdep_local[r] = r < n_residual ? v : TERMINAL;
}

// remap: int32[batch] filled with TERMINAL by the caller; scratch: m ints
extern "C" int gp_residual_view(const int32_t* p_r, const int32_t* pos_s,
                                const int32_t* dep_s, const int32_t* run_start,
                                const int32_t* src, const int32_t* seq, int32_t* rpos,
                                int32_t* rrs, int32_t* rsrc, int32_t* rseq,
                                int32_t* rdep_local, int32_t* scratch, int32_t* remap,
                                int m, int batch, int n_residual, cudaStream_t stream) {
  if (m <= 0) return 0;
  k_residual_gather<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(
      p_r, pos_s, dep_s, run_start, src, seq, rpos, rrs, rsrc, rseq, scratch, remap, m,
      n_residual);
  CHECK_LAUNCH();
  k_residual_local<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(
      scratch, remap, rdep_local, m, batch, n_residual);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 5. group scan
// ---------------------------------------------------------------------------

__global__ void k_group_pre(const int32_t* rrs, const int32_t* p_r, int32_t* x_fb,
                            int32_t* x_gs, int m) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  bool head = r == 0 || rrs[r] != rrs[r - 1];
  x_fb[r] = head ? p_r[r] : 0;
  x_gs[r] = head ? r : 0;
}

__global__ void k_group_post(const int32_t* firstbad, const int32_t* gstart,
                             int32_t* target, int m) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  target[r] = firstbad[r] + (r - gstart[r]);
}

// scratch: 2m + 4 * nblocks ints
extern "C" int gp_group_scan(const int32_t* rrs, const int32_t* p_r, int32_t* target,
                             int32_t* scratch, int m, cudaStream_t stream) {
  if (m <= 0) return 0;
  int32_t* x_fb = scratch;
  int32_t* x_gs = scratch + m;
  int32_t* scan_tmp = scratch + 2L * m;
  k_group_pre<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(rrs, p_r, x_fb, x_gs, m);
  CHECK_LAUNCH();
  int err = cummax(x_fb, x_fb, scan_tmp, m, stream);
  if (err) return err;
  err = cummax(x_gs, x_gs, scan_tmp, m, stream);
  if (err) return err;
  k_group_post<<<grid_for(m, EW_BLOCK), EW_BLOCK, 0, stream>>>(x_fb, x_gs, target, m);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 6. pointer doubling (_doubling_core)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool absorbing(int d) { return d == TERMINAL || d == MISSING; }

__global__ void k_dbl_init(const int32_t* dep, int32_t* jump, int32_t* acc, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int d = dep[i];
  bool ab = absorbing(d);
  jump[i] = ab ? i : d;
  acc[i] = ab ? n : d;
}

__global__ void k_dbl_step(const int32_t* jin, const int32_t* ain, int32_t* jout,
                           int32_t* aout, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = jin[i];
  aout[i] = min(ain[i], ain[j]);
  jout[i] = jin[j];
}

__global__ void k_dbl_seed(const int32_t* dep, const int32_t* end, const int32_t* acc,
                           int32_t* nonterm, int32_t* cyc_leader, int32_t* onc, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = end[i];
  bool nt = !absorbing(dep[e]);
  int leader = acc[e];
  nonterm[i] = nt;
  cyc_leader[i] = leader;
  onc[i] = nt && i == leader;
}

// contrib[hop[i]] |= onc[i]: the reference's .at[hop].max
__global__ void k_dbl_scatter(const int32_t* hop, const int32_t* onc, int32_t* contrib,
                              int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (onc[i]) atomicOr((unsigned*)&contrib[hop[i]], 1u);
}

__global__ void k_dbl_merge(int32_t* onc, int32_t* contrib, const int32_t* nonterm,
                            int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (contrib[i] && nonterm[i]) onc[i] = 1;
  contrib[i] = 0;
}

__global__ void k_dbl2_init(const int32_t* dep, const int32_t* onc, int32_t* jump,
                            int32_t* dist, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int d = dep[i];
  bool ab = absorbing(d) || onc[i];
  jump[i] = ab ? i : d;
  dist[i] = ab ? 0 : 1;
}

__global__ void k_dbl2_step(const int32_t* jin, const int32_t* din, int32_t* jout,
                            int32_t* dout, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = jin[i];
  dout[i] = din[i] + din[j];
  jout[i] = jin[j];
}

__global__ void k_dbl_final(const int32_t* dep, const int32_t* onc, const int32_t* jump2,
                            const int32_t* dist2, const int32_t* cyc_leader,
                            uint8_t* resolved, int32_t* rank, int32_t* leader,
                            uint8_t* on_cycle, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = jump2[i];
  bool oc = onc[i] != 0;
  bool res = oc || dep[j] == TERMINAL || onc[j] != 0;
  resolved[i] = res;
  rank[i] = res ? dist2[i] : UNRESOLVED_RANK;
  leader[i] = oc ? cyc_leader[i] : i;
  on_cycle[i] = oc;
}

// scratch: (steps + 1) * n + 8n ints; flags: 2n ints zeroed by the caller
extern "C" int gp_pointer_doubling(const int32_t* dep, uint8_t* resolved, int32_t* rank,
                                   int32_t* leader, uint8_t* on_cycle, int32_t* scratch,
                                   int32_t* flags, int n, int steps,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  unsigned g = grid_for(n, EW_BLOCK);
  long ln = n;
  int32_t* jumps = scratch;  // jumps[t] = the jump before step t
  int32_t* acc[2] = {scratch + (steps + 1) * ln, scratch + (steps + 2) * ln};
  int32_t* j2[2] = {scratch + (steps + 3) * ln, scratch + (steps + 4) * ln};
  int32_t* d2[2] = {scratch + (steps + 5) * ln, scratch + (steps + 6) * ln};
  int32_t* cyc_leader = scratch + (steps + 7) * ln;
  int32_t* nonterm = scratch + (steps + 8) * ln;
  int32_t* onc = flags;
  int32_t* contrib = flags + ln;

  k_dbl_init<<<g, EW_BLOCK, 0, stream>>>(dep, jumps, acc[0], n);
  CHECK_LAUNCH();
  for (int t = 0; t < steps; ++t) {
    k_dbl_step<<<g, EW_BLOCK, 0, stream>>>(jumps + t * ln, acc[t & 1],
                                           jumps + (t + 1) * ln, acc[(t + 1) & 1], n);
    CHECK_LAUNCH();
  }
  k_dbl_seed<<<g, EW_BLOCK, 0, stream>>>(dep, jumps + steps * ln, acc[steps & 1],
                                         nonterm, cyc_leader, onc, n);
  CHECK_LAUNCH();
  for (int t = 0; t < steps; ++t) {
    k_dbl_scatter<<<g, EW_BLOCK, 0, stream>>>(jumps + t * ln, onc, contrib, n);
    CHECK_LAUNCH();
    k_dbl_merge<<<g, EW_BLOCK, 0, stream>>>(onc, contrib, nonterm, n);
    CHECK_LAUNCH();
  }
  k_dbl2_init<<<g, EW_BLOCK, 0, stream>>>(dep, onc, j2[0], d2[0], n);
  CHECK_LAUNCH();
  for (int t = 0; t < steps; ++t) {
    k_dbl2_step<<<g, EW_BLOCK, 0, stream>>>(j2[t & 1], d2[t & 1], j2[(t + 1) & 1],
                                            d2[(t + 1) & 1], n);
    CHECK_LAUNCH();
  }
  k_dbl_final<<<g, EW_BLOCK, 0, stream>>>(dep, onc, j2[steps & 1], d2[steps & 1],
                                          cyc_leader, resolved, rank, leader, on_cycle,
                                          n);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 7. emit scatter
// ---------------------------------------------------------------------------

__global__ void k_emit_init(const uint8_t* chain_ok, int32_t* packed, uint8_t* res_b,
                            int batch) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  bool res = chain_ok[p] != 0;
  packed[p] = (res ? 0 : EMIT_UNRESOLVED_BIT) | p;
  res_b[p] = res;
}

__global__ void k_emit_scatter(const int32_t* e, const int32_t* p_r,
                               const uint8_t* l_resolved, const int32_t* target,
                               int32_t* packed, uint8_t* res_b, int32_t* n_unres,
                               int m, int n_valid, int n_residual) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int unres = 0;
  if (r < n_valid) {
    int s = e[r];
    int pr = p_r[s];
    bool res = l_resolved[s] != 0;
    packed[pr] = (res ? 0 : EMIT_UNRESOLVED_BIT) | target[r];
    res_b[pr] = res;
    unres = res ? 0 : 1;
  }
  // residual rows beyond the buffer (overflow) stay unresolved
  if (r == 0) unres += n_residual - n_valid;
  unres = __reduce_add_sync(0xffffffffu, unres);
  if ((threadIdx.x & 31) == 0 && unres) atomicAdd(n_unres, unres);
}

// n_unres zeroed by the caller
extern "C" int gp_emit_scatter(const int32_t* e, const int32_t* p_r,
                               const uint8_t* l_resolved, const int32_t* target,
                               const uint8_t* chain_ok, int32_t* packed, uint8_t* res_b,
                               int32_t* n_unres, int m, int batch, int n_residual,
                               cudaStream_t stream) {
  if (batch <= 0) return 0;
  int n_valid = n_residual < m ? n_residual : m;
  k_emit_init<<<grid_for(batch, EW_BLOCK), EW_BLOCK, 0, stream>>>(chain_ok, packed,
                                                                  res_b, batch);
  CHECK_LAUNCH();
  int threads = m > 0 ? m : 1;
  k_emit_scatter<<<grid_for(threads, EW_BLOCK), EW_BLOCK, 0, stream>>>(
      e, p_r, l_resolved, target, packed, res_b, n_unres, m, n_valid, n_residual);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 8. epilogue
// ---------------------------------------------------------------------------

__global__ void k_epilogue(const uint8_t* occ, uint8_t* executed, const uint8_t* flags,
                           const int32_t* flag_perm, uint8_t* newly, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int v = flag_perm ? flag_perm[p] : p;
  bool res = flags ? flags[p] != 0 : true;
  bool nw = res && occ[v] && !executed[v];
  newly[v] = nw;
  if (nw) executed[v] = 1;
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
