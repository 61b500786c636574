// Hopper kernels of the Caesar predecessors plane: one resident window step
// (pred_plane_step_pallas, fantoch_tpu/ops/pallas_resolve.py:264, body
// _pred_step_kernel :201) -- install the feed's rows, patch dep cells, then
// the least fixpoint of the monotone two-phase operator over the whole
// window.  The Python wrapper (pred_plane_step), its plain version and the
// note on bounds and design are in fantoch_tpu_torch/ops/pred_kernels.py.
//
// Interface: every launcher is extern "C", takes raw device pointers, ints
// and a cudaStream_t, launches on that stream, never synchronises and never
// allocates (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its launch (or the first failing call; a
// refused cooperative launch is such a call).
//
// The fixpoint.  A row v is done once it was executed, or once it is
// occupied and every dep cell either never blocks (TERMINAL, or a target in
// the window that is occupied and higher in (clock, src)) or points at a
// done row.  Each row gets a state byte (IDLE, DONE or PENDING) and a
// packed record (clock, src, occupancy, state); each PENDING row counts its
// cells that wait: a target that is not DONE (one count a cell: a target
// named twice counts twice), or a MISSING cell, which never ends.  The
// reverse edges (target -> waiting row, a cell each) of the targets that
// are PENDING form a CSR: a count per target, an inclusive scan, a fill
// that walks each target's end back to its start.  The PENDING rows whose
// count is 0 are the seeds.  Propagation marks a seed DONE and takes one
// from the count of each of its waiters (atomicSub); a waiter taken to 0 is
// ready: the first one the thread finds it marks itself and carries on
// down the chain, the others go onto a worklist that every thread drains
// (atomic head and tail; a slot read spins until its pusher's store lands).
// A thread leaves once the head has caught up with the tail: every row it
// pushed was taken by then, by it or by another thread, so one pass drains
// everything.  Rows that wait on a MISSING cell, on an IDLE row, on
// themselves or on any row that never gets done never reach 0, exactly as
// in the reference's least fixpoint, which does not depend on the order in
// which rows are marked: the marks are the reference's `executed` bit for
// bit.
//
// Two forms of the same phases (install, a cell a thread | patch | states
// and records, a row a thread | counts and target degrees, a cell a thread
// | the degrees' scan | fill and seeds | propagate | finish), chosen by the
// wrapper's shared-memory gate:
//   * pp_one_cta: one block of PP_CTA threads, a __syncthreads between
//     phases, the counts, the CSR and the worklist in dynamic shared memory
//     (rows as 16-bit indices), the records and each cell's edge target in
//     the wrapper's scratch;
//   * pp_grid: one cooperative launch clamped to the co-resident grid, a
//     grid barrier between phases, the working set in the wrapper's scratch.
// Either is one operation on the card a dispatch whatever the chain length,
// with no memset and no host read inside the fixpoint.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpred_plane.so pred_plane.cu

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <mutex>

namespace cg = cooperative_groups;

#define PP_CTA 1024    // the one-CTA form's block
#define PP_RED 64      // ints of dynamic shared memory for block reductions
#define PP_PARTS 4096  // most blocks of a grid form (its scan's partial sums)

#define TERMINAL (-1)

// per-row fixpoint state
#define ST_IDLE 0     // not occupied, not executed: never done
#define ST_DONE 1
#define ST_PENDING 2  // occupied, waiting on its wait targets
#define ST_SEED 3     // PENDING with nothing to wait for: propagation starts here

// the worklist's head and tail (Work::ctl)
#define CTL_HEAD 0
#define CTL_TAIL 1

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

// rows walked grid-stride (one block: block-stride)
#define FOR_N(v, n)                                                      \
  for (long v = (long)blockIdx.x * blockDim.x + threadIdx.x; v < (long)(n); \
       v += (long)gridDim.x * blockDim.x)

// CHUNK indices a thread at a time, STRIDE apart: i0, i0 + STRIDE, ...
#define CHUNK 4
#define STRIDE ((long)gridDim.x * blockDim.x)
#define FOR_CHUNKS(i0, n)                                                   \
  for (long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x; i0 < (long)(n); \
       i0 += CHUNK * STRIDE)

template <bool COOP>
__device__ __forceinline__ void phase_sync() {
  if constexpr (COOP) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

template <class T>
__device__ __forceinline__ T vload(const T* p) {
  return *(const volatile T*)p;
}

template <class T>
__device__ __forceinline__ void vstore(T* p, T v) {
  *(volatile T*)p = v;
}

// the step's state, feed and outputs
struct Step {
  int32_t* deps;
  int32_t* clock;
  int32_t* src;
  uint8_t* occ;
  uint8_t* executed;
  const int32_t* u_row;
  const int32_t* u_deps;
  const int32_t* u_clock;
  const int32_t* u_src;
  const int32_t* p_row;
  const int32_t* p_col;
  const int32_t* p_val;
  uint8_t* newly;
  int32_t* work;  // [0]: rows the propagation marked, [1]: rows it pushed
  int C, W, U, P;
  int wshift;  // log2(W) where W is a power of two, else -1
};

// a row's clock, src, occupancy and state, packed so that a target costs
// one load
struct __align__(16) Rec {
  int32_t clock, src, occ, st;
};

// the working set: shared memory (one CTA, Idx = uint16_t) or the wrapper's
// scratch (grid, Idx = int32_t)
template <class Idx>
struct Work {
  int32_t* red;   // PP_RED ints of the block's dynamic shared memory
  int32_t* ends;  // C + 1: target degrees, then CSR ends, then CSR starts
  int32_t* cnt;   // C: waits still open, a cell each (MISSING never closes)
  Idx* adj;       // C * W: waiting rows, grouped by target
  Idx* queue;     // C: the worklist (each row is pushed at most once)
  uint8_t* st;    // C: state bytes
  int32_t* ctl;   // worklist head and tail
  int32_t* part;  // a partial sum a block (the degrees' scan)
  int32_t* tgt;   // C * W: each cell's edge target, or -1 (device memory)
  Rec* rec;       // C: each row's packed record (device memory)
};

// the row of cell i (cells row-major, W a row)
__device__ __forceinline__ long row_of(const Step& s, long i) {
  return s.wshift >= 0 ? i >> s.wshift : i / s.W;
}

// (1) install cell i of the feed (row i / W): the row's dep cell, and with
// its cell 0 the row's clock and src, occupied and not executed.  Rows
// outside [0, C) are pads and dropped.
__device__ __forceinline__ void install_cell(const Step& s, long i) {
  long f = row_of(s, i);
  int w = (int)(i - f * s.W);
  int r = s.u_row[f];
  if (r < 0 || r >= s.C) return;
  s.deps[(size_t)r * s.W + w] = s.u_deps[i];
  if (w) return;
  s.clock[r] = s.u_clock[f];
  s.src[r] = s.u_src[f];
  s.occ[r] = 1;
  s.executed[r] = 0;
}

// (2) patch cell i; cells outside [0, C) x [0, W) are pads and dropped
__device__ __forceinline__ void patch_cell(const Step& s, long i) {
  int r = s.p_row[i], c = s.p_col[i];
  if (r < 0 || r >= s.C || c < 0 || c >= s.W) return;
  s.deps[(size_t)r * s.W + c] = s.p_val[i];
}

// the sum of x over the block; every thread must call it
__device__ int block_sum(int x, int32_t* red) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = (blockDim.x + 31) >> 5;
  for (int d = 16; d > 0; d >>= 1) x += __shfl_sync(0xffffffffu, x, (lane + d) & 31);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < nw; ++i) total += red[i];
  __syncthreads();
  return total;
}

// the inclusive sum of x over the block; every thread must call it
__device__ int block_incl_sum(int x, int32_t* red) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_sync(0xffffffffu, x, lane >= d ? lane - d : lane);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += red[i];
  __syncthreads();
  return before + x;
}

// marks v DONE and walks down the chain: a waiter taken to 0 by this thread
// is marked next (the first one), or pushed onto the worklist (the others).
// Returns the rows marked.
template <class Idx>
__device__ int walk(int v, const Work<Idx>& k, int* pushed) {
  int marked = 0;
  for (;;) {
    k.st[v] = ST_DONE;
    ++marked;
    int next = -1;
    int hi = k.ends[v + 1];
    for (int e = k.ends[v]; e < hi; ++e) {
      int u = (int)k.adj[e];
      if (atomicSub(&k.cnt[u], 1) == 1) {
        if (next < 0) {
          next = u;
        } else {
          int j = atomicAdd(&k.ctl[CTL_TAIL], 1);
          vstore(&k.queue[j], (Idx)u);
          ++*pushed;
        }
      }
    }
    if (next < 0) return marked;
    v = next;
  }
}

// the whole step; the one-CTA form runs it in one block (COOP false), the
// grid form in a cooperative grid
template <bool COOP, class Idx>
__device__ void pp_step(const Step& s, const Work<Idx>& k) {
  const Idx EMPTY = (Idx)~0u;
  int C = s.C;
  FOR_N(i, (long)s.U * s.W) install_cell(s, i);
  // install, then patch: a patch may land on a row this dispatch installs
  phase_sync<COOP>();
  FOR_N(i, s.P) patch_cell(s, i);
  phase_sync<COOP>();
  // a row a thread: the state byte and packed record; counts and degrees
  // zeroed, the worklist's slot empty
  FOR_N(v, C) {
    uint8_t st = s.executed[v] ? ST_DONE : s.occ[v] ? ST_PENDING : ST_IDLE;
    k.st[v] = st;
    k.rec[v] = Rec{s.clock[v], s.src[v], s.occ[v], st};
    k.cnt[v] = 0;
    k.ends[v] = 0;
    k.queue[v] = EMPTY;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    k.ends[C] = 0;
    k.ctl[CTL_HEAD] = 0;
    k.ctl[CTL_TAIL] = 0;
    s.work[0] = 0;
    s.work[1] = 0;
  }
  phase_sync<COOP>();
  // cells, CHUNK a thread at a time (their loads issued together, then
  // their targets'): a PENDING row's cell waits on its target unless it
  // never blocks (TERMINAL, or a target occupied and higher in (clock,
  // src)); it counts while the target is not DONE, and is an edge (kept in
  // tgt, the target's degree raised) while the target is PENDING.  A dep
  // index at or past C reads row C - 1, as the reference's clamped gather
  // does.  A MISSING (or other negative) cell is a wait that never ends.
  long cells = (long)C * s.W;
  FOR_CHUNKS(i0, cells) {
    long ii[CHUNK];
    int dep[CHUNK];
    Rec me[CHUNK], t[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      ii[j] = i0 + j * STRIDE;
      bool in = ii[j] < cells;
      me[j] = in ? k.rec[row_of(s, ii[j])] : Rec{0, 0, 0, ST_IDLE};
      dep[j] = in ? s.deps[ii[j]] : TERMINAL;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      int q = dep[j] < C ? dep[j] : C - 1;
      t[j] = me[j].st == ST_PENDING && dep[j] >= 0 ? k.rec[q] : Rec{0, 0, 0, ST_IDLE};
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (ii[j] >= cells) break;
      int edge = -1;
      if (me[j].st == ST_PENDING && dep[j] != TERMINAL) {
        bool waits = dep[j] < 0;
        if (!waits) {
          bool higher = t[j].clock > me[j].clock ||
                        (t[j].clock == me[j].clock && t[j].src > me[j].src);
          if (!(t[j].occ && higher)) {
            waits = t[j].st != ST_DONE;
            if (t[j].st == ST_PENDING) {
              edge = dep[j] < C ? dep[j] : C - 1;
              atomicAdd(&k.ends[edge], 1);
            }
          }
        }
        if (waits) atomicAdd(&k.cnt[row_of(s, ii[j])], 1);
      }
      k.tgt[ii[j]] = edge;
    }
  }
  phase_sync<COOP>();
  // the degrees' inclusive scan: a contiguous chunk a block, the chunks'
  // sums, then each chunk scanned from the sum of the chunks before it
  long chunk = ((long)C + gridDim.x - 1) / gridDim.x;
  long lo = (long)blockIdx.x * chunk;
  long hi = lo + chunk < C ? lo + chunk : C;
  int sum = 0;
  for (long v = lo + threadIdx.x; v < hi; v += blockDim.x) sum += k.ends[v];
  sum = block_sum(sum, k.red);
  if (threadIdx.x == 0) k.part[blockIdx.x] = sum;
  phase_sync<COOP>();
  int carry = 0;
  for (unsigned b = threadIdx.x; b < blockIdx.x; b += blockDim.x)
    carry += vload(&k.part[b]);
  carry = block_sum(carry, k.red);
  for (long base = lo; base < hi; base += blockDim.x) {
    long v = base + threadIdx.x;
    int x = v < hi ? k.ends[v] : 0;
    int inc = block_incl_sum(x, k.red);
    if (v < hi) {
      k.ends[v] = carry + inc;
      if (v == C - 1) k.ends[C] = carry + inc;  // the chunk's own thread alone
    }
    carry += block_sum(x, k.red);
  }
  phase_sync<COOP>();
  // the fill, a cell a thread, walks each target's end back to its start;
  // the seeds, a row a thread: PENDING rows that wait on nothing
  FOR_CHUNKS(i0, cells) {
    int t[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      t[j] = i0 + j * STRIDE < cells ? k.tgt[i0 + j * STRIDE] : -1;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (t[j] >= 0)
        k.adj[atomicSub(&k.ends[t[j]], 1) - 1] = (Idx)row_of(s, i0 + j * STRIDE);
  }
  FOR_N(v, C) {
    if (k.st[v] == ST_PENDING && k.cnt[v] == 0) k.st[v] = ST_SEED;
  }
  phase_sync<COOP>();
  // propagate: each thread walks its seeds, then drains the worklist
  int marked = 0, pushed = 0;
  FOR_N(v, C) {
    if (k.st[v] == ST_SEED) marked += walk((int)v, k, &pushed);
  }
  for (;;) {
    int t = vload(&k.ctl[CTL_TAIL]);
    int h = vload(&k.ctl[CTL_HEAD]);
    if (h >= t) break;
    if (atomicCAS(&k.ctl[CTL_HEAD], h, h + 1) != h) continue;
    Idx v;
    while ((v = vload(&k.queue[h])) == EMPTY) {
    }
    marked += walk((int)v, k, &pushed);
  }
  marked = block_sum(marked, k.red);
  pushed = block_sum(pushed, k.red);
  if (threadIdx.x == 0 && (marked || pushed)) {
    atomicAdd(&s.work[0], marked);
    atomicAdd(&s.work[1], pushed);
  }
  phase_sync<COOP>();
  FOR_N(v, C) {
    uint8_t done = k.st[v] == ST_DONE;
    s.newly[v] = done && !s.executed[v];
    s.executed[v] = done;
  }
}

// ---------------------------------------------------------------------------
// one CTA: the working set in dynamic shared memory
// ---------------------------------------------------------------------------

// log2(W) where W is a power of two, else -1
static int width_shift(int W) {
  if (W & (W - 1)) return -1;
  int shift = 0;
  while ((1 << shift) < W) ++shift;
  return shift;
}

// the one-CTA form's dynamic shared memory (ops/pred_kernels.py mirrors
// it): ints (reductions, ends, counts, head and tail), then the 16-bit
// adjacency and worklist, then the state bytes
static size_t one_cta_smem(int C, int W) {
  return (size_t)4 * (PP_RED + 2 * (size_t)C + 1 + 2) + 2 * ((size_t)C * W + C) + C;
}

// at most 64 registers a thread, so the block of PP_CTA threads launches
__global__ void __launch_bounds__(PP_CTA) k_one_cta(Step s, int32_t* scratch) {
  extern __shared__ int32_t pp_smem[];
  int C = s.C;
  Work<uint16_t> k;
  k.red = pp_smem;
  k.ends = pp_smem + PP_RED;
  k.cnt = k.ends + C + 1;
  k.ctl = k.cnt + C;
  k.part = k.red;  // one block: its partial sum is read back by itself
  k.adj = (uint16_t*)(k.ctl + 2);
  k.queue = k.adj + (size_t)C * s.W;
  k.st = (uint8_t*)(k.queue + C);
  k.rec = (Rec*)scratch;
  k.tgt = scratch + 4 * (size_t)C;
  pp_step<false>(s, k);
}

extern "C" int pp_one_cta(int32_t* deps, int32_t* clock, int32_t* src, uint8_t* occ,
                          uint8_t* executed, const int32_t* u_row,
                          const int32_t* u_deps, const int32_t* u_clock,
                          const int32_t* u_src, const int32_t* p_row,
                          const int32_t* p_col, const int32_t* p_val, uint8_t* newly,
                          int32_t* work, int32_t* scratch, int C, int W, int U,
                          int P, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (W <= 0) return (int)cudaErrorInvalidValue;
  if (C >= 0xffff) return (int)cudaErrorInvalidValue;  // rows are 16-bit here
  size_t smem = one_cta_smem(C, W);
  CHECK_CALL(cudaFuncSetAttribute(k_one_cta, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
  Step s = {deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src,
            p_row, p_col, p_val, newly, work, C, W, U, P, width_shift(W)};
  k_one_cta<<<1, PP_CTA, smem, stream>>>(s, scratch);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// grid: one cooperative launch, the working set in the wrapper's scratch
// ---------------------------------------------------------------------------

__global__ void k_grid(Step s, Work<int32_t> k) {
  extern __shared__ int32_t pp_red[];
  k.red = pp_red;
  pp_step<true>(s, k);
}

// the co-resident grid of k_grid: the SM count times the blocks of `block`
// threads one SM holds, at most `want` and PP_PARTS; queried once per (block,
// device) and kept.  A card without cooperative launches refuses.
struct GridSize {
  int block, dev;
  long blocks;
};
#define GRID_SIZES 16
static GridSize grid_sizes[GRID_SIZES];
static int n_grid_sizes = 0;
static std::mutex grid_sizes_mu;

static int grid_size(int block, size_t smem, long want, int* grid) {
  int dev = 0;
  CHECK_CALL(cudaGetDevice(&dev));
  long blocks = -1;
  {
    std::lock_guard<std::mutex> lock(grid_sizes_mu);
    for (int i = 0; i < n_grid_sizes; ++i)
      if (grid_sizes[i].block == block && grid_sizes[i].dev == dev)
        blocks = grid_sizes[i].blocks;
  }
  if (blocks < 0) {
    int coop = 0, sms = 0, per_sm = 0;
    CHECK_CALL(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    CHECK_CALL(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_grid, block, smem));
    blocks = (long)sms * per_sm;
    std::lock_guard<std::mutex> lock(grid_sizes_mu);
    if (n_grid_sizes < GRID_SIZES) grid_sizes[n_grid_sizes++] = {block, dev, blocks};
  }
  long g = want < blocks ? want : blocks;
  g = g < PP_PARTS ? g : PP_PARTS;
  if (g < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = (int)g;
  return 0;
}

// scratch: the packed records (4 * C), ends (C + 1), cnt (C), adj (C * W),
// queue (C), head and tail (2), PP_PARTS partial sums and tgt (C * W) as
// ints, then st (C bytes)
extern "C" int pp_grid(int32_t* deps, int32_t* clock, int32_t* src, uint8_t* occ,
                       uint8_t* executed, const int32_t* u_row, const int32_t* u_deps,
                       const int32_t* u_clock, const int32_t* u_src,
                       const int32_t* p_row, const int32_t* p_col,
                       const int32_t* p_val, uint8_t* newly, int32_t* work,
                       int32_t* scratch, int C, int W, int U, int P, int block,
                       cudaStream_t stream) {
  if (C <= 0) return 0;
  if (W <= 0) return (int)cudaErrorInvalidValue;
  size_t smem = PP_RED * sizeof(int32_t);
  long most = (long)C * W > (long)U * W ? (long)C * W : (long)U * W;
  most = most > P ? most : P;
  int grid = 0;
  int e = grid_size(block, smem, (most + block - 1) / block, &grid);
  if (e) return e;
  Step s = {deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src,
            p_row, p_col, p_val, newly, work, C, W, U, P, width_shift(W)};
  Work<int32_t> k;
  k.red = nullptr;
  k.rec = (Rec*)scratch;
  k.ends = scratch + 4 * (size_t)C;
  k.cnt = k.ends + C + 1;
  k.adj = k.cnt + C;
  k.queue = k.adj + (size_t)C * W;
  k.ctl = k.queue + C;
  k.part = k.ctl + 2;
  k.tgt = k.part + PP_PARTS;
  k.st = (uint8_t*)(k.tgt + (size_t)C * W);
  void* args[] = {&s, &k};
  CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_grid, dim3(grid), dim3(block), args,
                                         smem, stream));
  return (int)cudaGetLastError();
}
