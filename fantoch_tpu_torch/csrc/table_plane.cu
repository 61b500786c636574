// Hopper kernels of the Newt votes-table plane: the commit dispatch
// (votes_commit_pallas, fantoch_tpu/ops/pallas_resolve.py:394, tracing
// table_ops._votes_commit_core :260) and the dense table round
// (table_round_pallas, pallas_resolve.py:441, tracing
// table_ops._fused_round_core :369 and _proposal_core :148).  The stable
// sorts of both are the graph plane's lex_sort (graph_plane_step.cu).  The
// Python wrappers (clock_proposal, clock_bump, vote_runs, stable_rows), their
// plain versions and the per-wrapper notes on bounds and design are in
// fantoch_tpu_torch/ops/table_kernels.py.
//
// Interface: every launcher is extern "C", takes raw device pointers, ints
// and a cudaStream_t, launches on that stream, never synchronises and never
// allocates (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its last launch (or the first failing one).
//
// All arithmetic is int32 with two's-complement wrap, as in the reference
// (XLA's int32 adds wrap): sums go through unsigned ints, never signed
// overflow.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtable_plane.so table_plane.cu

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

#define EW_BLOCK 256     // elementwise kernels
#define SCAN_BLOCK 1024  // block scans (all threads take part)
#define MAX_VOTERS 16    // stable_rows ranks a frontier row in registers

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static inline unsigned grid_for(long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// ---------------------------------------------------------------------------
// clock_bump (the proposal, after vote_runs, shares its look-back helpers)
// ---------------------------------------------------------------------------

// table.at[idx].max(val), in place: clock_bump's fold of the host's
// scalar bumps
__global__ void k_scatter_max(const int32_t* idx, const int32_t* val, int32_t* table,
                              int M) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < M) atomicMax(&table[idx[j]], val[j]);
}

extern "C" int tp_clock_bump(const int32_t* idx, const int32_t* val, int32_t* prior,
                             int M, cudaStream_t stream) {
  if (M <= 0) return 0;
  k_scatter_max<<<grid_for(M, EW_BLOCK), EW_BLOCK, 0, stream>>>(idx, val, prior, M);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// vote_runs (on the (group, start)-sorted vote ranges)
// ---------------------------------------------------------------------------
// After tp_votes_gid and lex_sort, three stages over tiles of VR_ROWS rows
// (or run slots) a thread, each the reference's lines in order:
//   1. gather: the sorted groups, starts and ends into scratch (the key,
//      process and validity are read at the run heads alone, through the
//      order), and each tile's aggregate of the group-segmented running max
//      of the ends;
//   2. runs: the running max end (the carry from the gather's aggregates of
//      the tiles before), the run heads (a group head, or a start past the
//      group's running max end + 1), and one scan of (run heads, max end
//      since the last head, last head index): a run's last row knows its
//      run id, head and end (the max of its ends, whatever their order
//      against the starts), writes the run columns and residual, and keeps
//      the frontier cell's value f0 for its slot;
//   3. extend: the slots past the last run take the reference's fill (key
//      and by 0, the first sorted start, end INT_MIN; a tile wholly past
//      it only that, with no scan); every valid run
//      computes what it raises its cell to (its end where it extends, else
//      0), a max scan segmented by cell gives each cell's, and the cell's
//      last run is its only writer: max(f0, that).  The slots that are not
//      valid runs all raise frontier[0, 0] to at least 0 (the reference's
//      .at[0, 0].max(0)): that is one write, folded into the writer of cell
//      (0, 0) where a valid run has it, else made by slot V - 1.
// Every read of the frontier (f0, stage 2) happens before any write
// (stage 3): in the multi-block form the stages are separate launches on
// one stream; in the one-CTA form a block barrier stands between them and
// stage 3 reads each cell's f0 from its run slot, never from the frontier,
// except in slot V - 1's write of cell (0, 0), which no other thread
// writes or reads then.  No same-address atomic: a run slot is written by
// its run's last row alone, a frontier cell by its last run alone.
//
// The forms: up to a one-CTA gate (the wrapper's), one block runs the three
// stages with block barriers between them (one launch); above it each stage
// is a launch of tiles, and the scans of stages 2 and 3 carry across tiles
// by decoupled look-back (Merrill & Garland): a tile publishes its
// aggregate, a warp combines its predecessors' (stopping at the nearest
// inclusive prefix), then the tile publishes its inclusive prefix.  Tiles
// take their index from a ticket (atomicAdd), so a tile waits only on
// tiles that already run.  Stage 1 zeroes the status flags and tickets of
// stages 2 and 3, so nothing is memset.

#define VR_ROWS 4         // rows (or run slots) a thread
#define VR_STATUS 8       // ints of a tile's look-back status
#define VR_FLAG_AGG 1     // the tile's aggregate is published
#define VR_FLAG_INCL 2    // its inclusive prefix is published
#define VR_CTA_MAX 1024   // the one-CTA form's largest block

// the group-segmented running max (segment ids contiguous): (segment id,
// max since the segment's first row); `any` is false for the empty prefix
struct SegMax {
  int any, seg, val;
  __device__ static SegMax none() { return {0, 0, 0}; }
  __device__ static SegMax of(int seg, int val) { return {1, seg, val}; }
  __device__ void put(int32_t* p) const {
    p[0] = any;
    p[1] = seg;
    p[2] = val;
  }
  __device__ static SegMax get(const int32_t* p) {
    const volatile int32_t* q = p;
    return {q[0], q[1], q[2]};
  }
};
__device__ __forceinline__ SegMax combine(SegMax a, SegMax b) {
  if (!a.any) return b;
  if (!b.any) return a;
  return {1, b.seg, a.seg == b.seg ? max(a.val, b.val) : b.val};
}
__device__ __forceinline__ SegMax shfl(SegMax x, int src) {
  return {__shfl_sync(0xffffffffu, x.any, src), __shfl_sync(0xffffffffu, x.seg, src),
          __shfl_sync(0xffffffffu, x.val, src)};
}

// the run scan: run heads so far, the max end since the last head, the
// last head's row
struct RunScan {
  int cnt, mx, head;
  __device__ static RunScan none() { return {0, INT_MIN, -1}; }
  __device__ void put(int32_t* p) const {
    p[0] = cnt;
    p[1] = mx;
    p[2] = head;
  }
  __device__ static RunScan get(const int32_t* p) {
    const volatile int32_t* q = p;
    return {q[0], q[1], q[2]};
  }
};
__device__ __forceinline__ RunScan combine(RunScan a, RunScan b) {
  return {a.cnt + b.cnt, b.cnt ? b.mx : max(a.mx, b.mx), max(a.head, b.head)};
}
__device__ __forceinline__ RunScan shfl(RunScan x, int src) {
  return {__shfl_sync(0xffffffffu, x.cnt, src), __shfl_sync(0xffffffffu, x.mx, src),
          __shfl_sync(0xffffffffu, x.head, src)};
}

// the exclusive scan of x over the block (threads in order), and the block's
// total; blockDim.x a multiple of 32, every thread must call it.  sh holds
// 32 states.
template <class S>
__device__ S block_exclusive(S x, S* sh, S* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  S inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    S y = shfl(inc, lane >= d ? lane - d : lane);
    if (lane >= d) inc = combine(y, inc);
  }
  S ex = shfl(inc, lane > 0 ? lane - 1 : 0);
  if (lane == 0) ex = S::none();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    S w = lane < nw ? sh[lane] : S::none();
    for (int d = 1; d < 32; d <<= 1) {
      S y = shfl(w, lane >= d ? lane - d : lane);
      if (lane >= d) w = combine(y, w);
    }
    sh[lane] = w;
  }
  __syncthreads();
  S pre = warp > 0 ? sh[warp - 1] : S::none();
  *total = sh[nw - 1];
  __syncthreads();
  return combine(pre, ex);
}

// decoupled look-back for tile `tile` of total `total`: publishes the
// aggregate, combines the tiles before it (a warp reads 32 statuses at a
// time, back to the nearest inclusive prefix), publishes the inclusive
// prefix and returns the exclusive one to every thread of the block.
// status: VR_STATUS ints a tile (flag, aggregate, inclusive prefix),
// flags zeroed before the launch.
template <class S>
__device__ S look_back(int32_t* status, int tile, S total, S* sh) {
  int32_t* mine = status + (long)tile * VR_STATUS;
  if (threadIdx.x == 0) {
    total.put(mine + 1);
    __threadfence();
    *(volatile int32_t*)mine = VR_FLAG_AGG;
  }
  if (threadIdx.x < 32) {
    int lane = threadIdx.x;
    S acc = S::none();
    for (int base = tile - 1;; base -= 32) {
      int j = base - lane;
      int flag = VR_FLAG_INCL;
      S v = S::none();
      if (j >= 0) {
        const int32_t* st = status + (long)j * VR_STATUS;
        while ((flag = *(const volatile int32_t*)st) == 0) {
        }
        __threadfence();
        v = S::get(st + (flag == VR_FLAG_INCL ? 4 : 1));
      }
      unsigned incl = __ballot_sync(0xffffffffu, flag == VR_FLAG_INCL);
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
      combine(acc, total).put(mine + 4);
      __threadfence();
      *(volatile int32_t*)mine = VR_FLAG_INCL;
      sh[0] = acc;
    }
  }
  __syncthreads();
  S out = sh[0];
  __syncthreads();
  return out;
}

// a tile's index in the multi-block form: from the stage's ticket
__device__ int take_tile(int32_t* ticket) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1);
  __syncthreads();
  int t = tile;
  __syncthreads();
  return t;
}

// the call's columns, outputs and scratch
struct VoteRuns {
  const int32_t *order, *gid, *vkey, *vby, *vstart, *vend;
  const uint8_t* valid;
  int32_t* frontier;
  int32_t *run_key, *run_by, *run_start, *run_end;
  uint8_t* residual;
  // scratch: the sorted groups, starts and ends, f0 per run slot, the
  // gather's tile aggregates, the run count, the look-back statuses and
  // tickets of stages 2 and 3; each run slot's validity
  int32_t *g, *s, *e, *f0;
  int32_t *agg_seg, *agg_val, *num_runs, *status2, *status3, *tickets;
  uint8_t* rv;
  int V, n;
};

// stage 1: the tile's sorted rows and its aggregate of the running max end;
// zeroes the tile's status flags of stages 2 and 3 (and tile 0 the tickets)
__device__ void vr_gather(const VoteRuns& c, int tile) {
  __shared__ SegMax sh[32];
  long base = ((long)tile * blockDim.x + threadIdx.x) * VR_ROWS;
  SegMax agg = SegMax::none();
  for (int k = 0; k < VR_ROWS; ++k) {
    long i = base + k;
    if (i >= c.V) break;
    int j = c.order[i];
    int gi = c.gid[j], ei = c.vend[j];
    c.g[i] = gi;
    c.s[i] = c.vstart[j];
    c.e[i] = ei;
    agg = combine(agg, SegMax::of(gi, ei));
  }
  SegMax total;
  block_exclusive(agg, sh, &total);
  if (threadIdx.x == 0) {
    c.agg_seg[tile] = total.seg;
    c.agg_val[tile] = total.val;
    c.status2[(long)tile * VR_STATUS] = 0;
    c.status3[(long)tile * VR_STATUS] = 0;
    if (tile == 0) c.tickets[0] = c.tickets[1] = 0;
  }
}

// the max of x over the block; every thread must call it
__device__ int block_max(int x) {
  __shared__ SegMax sh[32];
  SegMax total;
  block_exclusive(SegMax::of(0, x), sh, &total);
  return total.val;
}

// stage 2: run heads, run ids, the run columns, residual and f0
__device__ void vr_runs(const VoteRuns& c, int tile, bool multi) {
  __shared__ SegMax sh1[32];
  __shared__ RunScan sh2[32];
  // the running max end at the row before the tile: the gather's aggregates
  // of the tiles before it on the last one's segment (segments are
  // contiguous, so those tiles hold nothing but it after their first row of
  // it, and each aggregate is its max there)
  SegMax carry = SegMax::none();
  if (tile > 0) {
    int seg = c.agg_seg[tile - 1];
    int m = INT_MIN;
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
      if (c.agg_seg[j] == seg) m = max(m, c.agg_val[j]);
    carry = SegMax::of(seg, block_max(m));
  }
  long base = ((long)tile * blockDim.x + threadIdx.x) * VR_ROWS;
  int gk[VR_ROWS], sk[VR_ROWS], ek[VR_ROWS];
  SegMax t1 = SegMax::none();
  for (int k = 0; k < VR_ROWS; ++k) {
    long i = base + k;
    gk[k] = i < c.V ? c.g[i] : 0;
    sk[k] = i < c.V ? c.s[i] : 0;
    ek[k] = i < c.V ? c.e[i] : 0;
    if (i < c.V) t1 = combine(t1, SegMax::of(gk[k], ek[k]));
  }
  SegMax tot1;
  SegMax prev = combine(carry, block_exclusive(t1, sh1, &tot1));
  // the run heads (the group head masks row 0's wrapped prev_max, as
  // jnp.roll's); rme: the running max end at each row
  int rme[VR_ROWS];
  RunScan t2 = RunScan::none();
  bool nr[VR_ROWS];
  for (int k = 0; k < VR_ROWS; ++k) {
    long i = base + k;
    if (i >= c.V) break;
    bool head = !prev.any || prev.seg != gk[k];
    nr[k] = head || sk[k] > wrap_add(prev.val, 1);
    prev = combine(prev, SegMax::of(gk[k], ek[k]));
    rme[k] = prev.val;
    t2 = combine(t2, nr[k] ? RunScan{1, ek[k], (int)i} : RunScan{0, ek[k], -1});
  }
  RunScan tot2;
  RunScan run = block_exclusive(t2, sh2, &tot2);
  if (multi) run = combine(look_back(c.status2, tile, tot2, sh2), run);
  for (int k = 0; k < VR_ROWS; ++k) {
    long i = base + k;
    if (i >= c.V) break;
    run = combine(run, nr[k] ? RunScan{1, ek[k], (int)i} : RunScan{0, ek[k], -1});
    bool last = i == c.V - 1 || c.g[i + 1] != gk[k] || c.s[i + 1] > wrap_add(rme[k], 1);
    if (!last) continue;
    int r = run.cnt - 1, h = run.head, jh = c.order[h];
    bool valid = c.valid[jh];
    int key = valid ? c.vkey[jh] : 0, by = valid ? c.vby[jh] : 0;
    int start = c.s[h], end = run.mx;
    int f0 = c.frontier[(long)key * c.n + by];
    int f1 = wrap_add(f0, 1);
    c.run_key[r] = key;
    c.run_by[r] = by;
    c.run_start[r] = start;
    c.run_end[r] = end;
    c.residual[r] = valid && start > f1 && end > f0;
    c.f0[r] = f0;
    c.rv[r] = valid;
    if (i == c.V - 1) *c.num_runs = run.cnt;
  }
}

// stage 3: the fill of the slots past the last run, and the frontier
__device__ void vr_extend(const VoteRuns& c, int tile, bool multi) {
  __shared__ SegMax sh[32];
  int runs = *c.num_runs;
  // some slot is not a valid run (the invalid group sorts last)
  bool spare = runs < c.V || !c.rv[runs - 1];
  bool cell0 = c.rv[0] && c.run_key[0] == 0 && c.run_by[0] == 0;
  long first = (long)tile * blockDim.x * VR_ROWS;
  if (multi && first >= runs) {
    // a tile past the last run (as every later one): the reference's fill,
    // slots striped over the threads so the stores coalesce, and no scan,
    // since no tile after it reads its prefix
    long last = first + (long)blockDim.x * VR_ROWS;
    last = last < c.V ? last : c.V;
    int start0 = c.s[0];
    for (long r = first + threadIdx.x; r < last; r += blockDim.x) {
      c.run_key[r] = 0;
      c.run_by[r] = 0;
      c.run_start[r] = start0;
      c.run_end[r] = INT_MIN;
      c.residual[r] = 0;
    }
    if (threadIdx.x == 0 && last == c.V && spare && !cell0 && c.frontier[0] < 0)
      c.frontier[0] = 0;
    return;
  }
  long base = first + (long)threadIdx.x * VR_ROWS;
  SegMax el[VR_ROWS];
  SegMax t = SegMax::none();
  for (int k = 0; k < VR_ROWS; ++k) {
    long r = base + k;
    el[k] = SegMax::none();
    if (r >= c.V) break;
    if (r >= runs) {
      c.run_key[r] = 0;
      c.run_by[r] = 0;
      c.run_start[r] = c.s[0];
      c.run_end[r] = INT_MIN;
      c.residual[r] = 0;
      el[k] = SegMax::of(-1, 0);
    } else if (!c.rv[r]) {
      el[k] = SegMax::of(-1, 0);
    } else {
      int f0 = c.f0[r], end = c.run_end[r];
      bool extends = c.run_start[r] <= wrap_add(f0, 1) && end > f0;
      el[k] = SegMax::of(c.run_key[r] * c.n + c.run_by[r], extends ? end : 0);
    }
    t = combine(t, el[k]);
  }
  SegMax total;
  SegMax acc = block_exclusive(t, sh, &total);
  if (multi) acc = combine(look_back(c.status3, tile, total, sh), acc);
  for (int k = 0; k < VR_ROWS; ++k) {
    long r = base + k;
    if (r >= c.V) break;
    acc = combine(acc, el[k]);
    if (r < runs && c.rv[r]) {
      int cell = acc.seg;
      bool last = r == runs - 1 || !c.rv[r + 1] ||
                  c.run_key[r + 1] * c.n + c.run_by[r + 1] != cell;
      if (last) {
        int f0 = c.f0[r];
        int raised = max(f0, acc.val);
        if (cell == 0 && spare) raised = max(raised, 0);
        if (raised != f0) c.frontier[(long)c.run_key[r] * c.n + c.run_by[r]] = raised;
      }
    }
    if (r == c.V - 1 && spare && !cell0 && c.frontier[0] < 0) c.frontier[0] = 0;
  }
}

__global__ void __launch_bounds__(VR_CTA_MAX) k_vr_gather(VoteRuns c) {
  vr_gather(c, blockIdx.x);
}

__global__ void __launch_bounds__(VR_CTA_MAX) k_vr_runs(VoteRuns c) {
  vr_runs(c, take_tile(c.tickets), true);
}

__global__ void __launch_bounds__(VR_CTA_MAX) k_vr_extend(VoteRuns c) {
  vr_extend(c, take_tile(c.tickets + 1), true);
}

// one CTA: the three stages in one launch, block barriers between them (the
// kernels are bounded for blocks of VR_CTA_MAX threads)
__global__ void __launch_bounds__(VR_CTA_MAX) k_vr_cta(VoteRuns c) {
  vr_gather(c, 0);
  __syncthreads();
  vr_runs(c, 0, false);
  __syncthreads();
  vr_extend(c, 0, false);
}

// the sort group: key * n + by, invalid rows one shared group K * n
__global__ void k_votes_gid(const int32_t* vkey, const int32_t* vby,
                            const uint8_t* valid, int32_t* gid, int V, int n, int K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < V) gid[i] = valid[i] ? wrap_add(wrap_mul(vkey[i], n), vby[i]) : wrap_mul(K, n);
}

extern "C" int tp_votes_gid(const int32_t* vkey, const int32_t* vby, const uint8_t* valid,
                            int32_t* gid, int V, int n, int K, cudaStream_t stream) {
  if (V <= 0) return 0;
  k_votes_gid<<<grid_for(V, EW_BLOCK), EW_BLOCK, 0, stream>>>(vkey, vby, valid, gid, V,
                                                              n, K);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// order: the (gid, vstart) lexsort permutation (lex_sort).  cta: one block
// for the three stages (V <= VR_CTA_MAX * VR_ROWS), else tiles of `block`
// threads (a multiple of 32, at most 1024).  scratch: 4 * V + 18 * tiles +
// 3 ints, then V bytes
extern "C" int tp_vote_runs(const int32_t* order, const int32_t* gid,
                            const int32_t* vkey, const int32_t* vby,
                            const int32_t* vstart, const int32_t* vend,
                            const uint8_t* valid, int32_t* frontier, int32_t* run_key,
                            int32_t* run_by, int32_t* run_start, int32_t* run_end,
                            uint8_t* residual, int32_t* scratch, int V, int n, int cta,
                            int block, cudaStream_t stream) {
  if (V <= 0) return 0;
  if (cta) {
    block = 32;
    while (block * VR_ROWS < V && block < VR_CTA_MAX) block *= 2;
    if (block * VR_ROWS < V) return (int)cudaErrorInvalidValue;
  } else if (block <= 0 || block % 32 || block > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  long tiles = cta ? 1 : (V + (long)block * VR_ROWS - 1) / ((long)block * VR_ROWS);
  VoteRuns c;
  c.order = order;
  c.gid = gid;
  c.vkey = vkey;
  c.vby = vby;
  c.vstart = vstart;
  c.vend = vend;
  c.valid = valid;
  c.frontier = frontier;
  c.run_key = run_key;
  c.run_by = run_by;
  c.run_start = run_start;
  c.run_end = run_end;
  c.residual = residual;
  c.g = scratch;
  c.s = c.g + V;
  c.e = c.s + V;
  c.f0 = c.e + V;
  c.agg_seg = c.f0 + V;
  c.agg_val = c.agg_seg + tiles;
  c.status2 = c.agg_val + tiles;
  c.status3 = c.status2 + tiles * VR_STATUS;
  c.num_runs = c.status3 + tiles * VR_STATUS;
  c.tickets = c.num_runs + 1;
  c.rv = (uint8_t*)(c.tickets + 2);
  c.V = V;
  c.n = n;
  if (cta) {
    k_vr_cta<<<1, block, 0, stream>>>(c);
    CHECK_LAUNCH();
  } else {
    k_vr_gather<<<(unsigned)tiles, block, 0, stream>>>(c);
    CHECK_LAUNCH();
    k_vr_runs<<<(unsigned)tiles, block, 0, stream>>>(c);
    CHECK_LAUNCH();
    k_vr_extend<<<(unsigned)tiles, block, 0, stream>>>(c);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}
// ---------------------------------------------------------------------------
// clock_proposal: one look-back pass over the key-sorted batch
// ---------------------------------------------------------------------------
// The reference (fantoch_tpu/ops/table_ops.py:148-184), bit for bit, int32
// wrap included: on the key-sorted rows i (perm, the stable argsort,
// lex_sort's), rank = i - h (h the run's head), base = max(prior[k] + 1,
// min_clock), running = the run's signed running max of x = base - rank,
// clock = rank + running, vote_start = (head ? prior[k] : clock[i - 1]) +
// 1, and prior.at[key].max(clock).
//
// The carried state.  With Y = running - h (exact, in 64 bits), a row adds
// y' = x - h to a running max and clock = i + Y (wrapped).  Where x does not
// wrap, y' = base - i needs no h; a row is safe when base - i >= INT_MIN,
// since then base - rank >= base - i cannot wrap whatever h is.  The
// exact clock c = i + Y rises strictly along a run, so the run's signed max
// of wrapped clocks is that of its last row where c stays <= INT_MAX; once a
// row goes past INT_MAX, every later row does, and where that row is safe
// (its Y did not jump: a jump at a safe row gives c = base <= INT_MAX) the
// row before it had c = INT_MAX, the largest int32.  So the rows so far
// carry (head seen, the run's head h, its last row L, Y, P = the run's
// signed max clock so far), and a run of safe rows without a head (b)
// after a prefix (a) gives P = c_b where c_b = b.L + max(a.Y, b.Y) <=
// INT_MAX; max(a.P, c_b - 2^32) where a's last row was already past it;
// INT_MAX otherwise.  PropAgg composes so (associative; a prefix from row 0
// always holds a head and is exact).
//
// A tile (PROP_TILE rows, PROP_ITEMS consecutive rows a thread) loads its
// rows through perm (key, min_clock, prior[key]; one extra read of the row
// before and after it), scans the heads, Y and P (block scans), and
// publishes its aggregate: the last run's (h, L, Y, P) where it holds a
// head (exact, from local rows alone), (L, Y) where it holds none and every
// row is safe, nothing otherwise (its successors then wait for its
// inclusive prefix).  With the prefix of the rows before it the tile fixes
// its lead rows (those before its first head), writes clock and vote_start
// through perm, and the run's last row writes prior[k] = max(prior[k], P)
// where that raises it: one writer a key, no atomic.
//
// One launch.  Every read of prior[k] by a run happens before the run's
// last row writes it: each tile reads prior in its load, before the block
// barrier ahead of its scans, and publishes its aggregate or inclusive
// prefix (a __threadfence between) only after; the run's last tile writes
// only after its look-back has seen, directly or through an inclusive
// prefix, a flag of every tile before it, so after every read of prior[k]
// by the run's tiles, its own made before its barrier; no later row has
// the key (the rows are sorted).
//
// Every tile is a block, the prefix crossing tiles by decoupled look-back
// (Merrill & Garland) with the conventions of graph_plane_step.cu's link
// scan, copied here: the status buffer the wrapper keeps zeroed once per
// device, an epoch a call tagging the flags, values before their flag with
// a __threadfence between, a ticket the last block sets back to 0.  No
// memset, no atomic on prior.
//
// Bound: bytes (key and min_clock read, clock and vote_start written, one
// prior cell read and written a distinct key); perm's gathers are random.

#define PROP_THREADS 256
#define PROP_ITEMS 4
#define PROP_TILE (PROP_THREADS * PROP_ITEMS)
#define PLB_HEAD 16    // ints before the first tile's status: [0] is the ticket
#define PLB_STATUS 16  // ints of a tile's status: flag, aggregate, inclusive
#define PLB_AGG 1      // the tile's aggregate is published
#define PLB_INCL 2     // its inclusive prefix is published
#define PLB_EPOCH_STEP 4  // a flag: epoch * PLB_EPOCH_STEP + PLB_AGG or PLB_INCL

// the look-back buffer's layout as this source has it (checked against the
// wrappers' when the library is loaded): head ints, status ints a tile, the
// aggregate's and the inclusive prefix's flag, epochs' step in a flag
extern "C" void tp_lookback_layout(int32_t* out) {
  out[0] = PLB_HEAD;
  out[1] = PLB_STATUS;
  out[2] = PLB_AGG;
  out[3] = PLB_INCL;
  out[4] = PLB_EPOCH_STEP;
}

struct PropAgg {
  int any, head, h, L, P;
  long long Y;
  __device__ static PropAgg none() { return {0, 0, -1, -1, INT_MIN, LLONG_MIN}; }
  __device__ void put(int32_t* p) const {
    p[0] = any;
    p[1] = head;
    p[2] = h;
    p[3] = L;
    p[4] = P;
    p[5] = (int32_t)(unsigned)(Y & 0xffffffffll);
    p[6] = (int32_t)(Y >> 32);
  }
  __device__ static PropAgg get(const int32_t* p) {
    const volatile int32_t* q = p;
    long long y = ((long long)q[6] << 32) | (long long)(unsigned)q[5];
    return {q[0], q[1], q[2], q[3], q[4], y};
  }
};

// a then b (b's rows follow a's); b without a head holds safe rows only
__device__ __forceinline__ PropAgg combine(PropAgg a, PropAgg b) {
  if (!a.any) return b;
  if (!b.any || b.head) return b.any ? b : a;
  long long y = max(a.Y, b.Y);
  int p = 0;
  if (a.head) {
    long long cb = (long long)b.L + y;
    if (cb <= INT_MAX)
      p = (int)cb;
    else if ((long long)a.L + a.Y > INT_MAX)
      p = max(a.P, (int)(cb - (1ll << 32)));
    else
      p = INT_MAX;
  }
  return {1, a.head, a.h, b.L, p, y};
}

__device__ __forceinline__ long long shfl_ll(long long x, int src) {
  int lo = __shfl_sync(0xffffffffu, (int)(unsigned)(x & 0xffffffffll), src);
  int hi = __shfl_sync(0xffffffffu, (int)(x >> 32), src);
  return ((long long)hi << 32) | (long long)(unsigned)lo;
}

__device__ __forceinline__ PropAgg shfl(PropAgg x, int src) {
  return {__shfl_sync(0xffffffffu, x.any, src), __shfl_sync(0xffffffffu, x.head, src),
          __shfl_sync(0xffffffffu, x.h, src), __shfl_sync(0xffffffffu, x.L, src),
          __shfl_sync(0xffffffffu, x.P, src), shfl_ll(x.Y, src)};
}

// the block scans of a tile: the last head, the run's Y (a max that a head
// resets), the run's P (a signed max that a head resets), and a plain max
struct PHead {
  int h;
  __device__ static PHead none() { return {-1}; }
};
__device__ __forceinline__ PHead combine(PHead a, PHead b) { return {max(a.h, b.h)}; }
__device__ __forceinline__ PHead shfl(PHead x, int src) {
  return {__shfl_sync(0xffffffffu, x.h, src)};
}
struct PSegY {
  int reset;
  long long Y;
  __device__ static PSegY none() { return {0, LLONG_MIN}; }
};
__device__ __forceinline__ PSegY combine(PSegY a, PSegY b) {
  return b.reset ? b : PSegY{a.reset, max(a.Y, b.Y)};
}
__device__ __forceinline__ PSegY shfl(PSegY x, int src) {
  return {__shfl_sync(0xffffffffu, x.reset, src), shfl_ll(x.Y, src)};
}
struct PSegP {
  int reset, P;
  __device__ static PSegP none() { return {0, INT_MIN}; }
};
__device__ __forceinline__ PSegP combine(PSegP a, PSegP b) {
  return b.reset ? b : PSegP{a.reset, max(a.P, b.P)};
}
__device__ __forceinline__ PSegP shfl(PSegP x, int src) {
  return {__shfl_sync(0xffffffffu, x.reset, src), __shfl_sync(0xffffffffu, x.P, src)};
}

// decoupled look-back for tile `tile` in this call's `epoch`: publishes the
// aggregate where `valid`, combines the tiles before it (a warp reads 32
// statuses at a time, back to the nearest inclusive prefix; a tile with no
// aggregate is waited for until its inclusive prefix), publishes the
// inclusive prefix where `valid` and returns the exclusive one to every
// thread.  status: PLB_HEAD ints, then PLB_STATUS a tile.
__device__ PropAgg prop_look_back(int32_t* status, int tile, PropAgg agg, bool valid,
                                  int epoch, PropAgg* sh) {
  int32_t* mine = status + PLB_HEAD + (long)tile * PLB_STATUS;
  const int agg_flag = epoch * PLB_EPOCH_STEP + PLB_AGG;
  const int incl_flag = epoch * PLB_EPOCH_STEP + PLB_INCL;
  if (threadIdx.x == 0 && valid) {
    agg.put(mine + 1);
    __threadfence();
    *(volatile int32_t*)mine = agg_flag;
  }
  if (threadIdx.x < 32) {
    int lane = threadIdx.x;
    PropAgg acc = PropAgg::none();
    for (int base = tile - 1;; base -= 32) {
      int j = base - lane;
      int flag = incl_flag;
      PropAgg v = PropAgg::none();
      if (j >= 0) {
        const int32_t* st = status + PLB_HEAD + (long)j * PLB_STATUS;
        do {
          flag = *(const volatile int32_t*)st;
        } while (flag != agg_flag && flag != incl_flag);
        __threadfence();
        v = PropAgg::get(st + (flag == incl_flag ? 8 : 1));
      }
      unsigned incl = __ballot_sync(0xffffffffu, flag == incl_flag);
      int stop = incl ? __ffs(incl) - 1 : 31;
      if (lane > stop) v = PropAgg::none();
      // lane 0 takes the window's combination, the farthest tile first
      for (int d = 1; d < 32; d <<= 1) {
        PropAgg y = shfl(v, lane + d < 32 ? lane + d : lane);
        if (lane + d < 32) v = combine(y, v);
      }
      acc = combine(shfl(v, 0), acc);
      if (incl) break;
    }
    if (lane == 0) {
      if (valid) {
        combine(acc, agg).put(mine + 8);
        __threadfence();
        *(volatile int32_t*)mine = incl_flag;
      }
      *sh = acc;
    }
  }
  __syncthreads();
  PropAgg out = *sh;
  __syncthreads();
  return out;
}

// a tile's index: from the ticket; the last one sets it back to 0
__device__ int prop_take_tile(int32_t* ticket, int tiles, int* sh) {
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

struct Proposal {
  const int32_t *key, *min_clock, *perm;
  int32_t *prior, *clock, *vote_start, *status;
  int B, epoch;
};

struct PropShared {
  PHead s1[32];
  PSegY s2[32];
  PSegP s3[32];
  PropAgg agg;
  int first_key[PROP_THREADS], last_key[PROP_THREADS], last_clock[PROP_THREADS];
  int tile;
};

// x's wrapped offset from the run's head h, less h: the row's y'
__device__ __forceinline__ long long prop_y(int base, long i, int h) {
  return (long long)wrap_sub(base, (int)(i - h)) - h;
}

// one tile, the prefix of the rows before it found by look-back
__device__ void prop_tile(const Proposal& c, int tile, PropShared& sh) {
  long t0 = (long)tile * PROP_TILE;
  long r0 = t0 + (long)threadIdx.x * PROP_ITEMS;
  long tile_last = min(t0 + PROP_TILE, (long)c.B) - 1;
  int ks[PROP_ITEMS], pk[PROP_ITEMS], base[PROP_ITEMS], hloc[PROP_ITEMS];
  int clk[PROP_ITEMS];
  long long yp[PROP_ITEMS], yv[PROP_ITEMS];
  bool hd[PROP_ITEMS];
  int n = (int)max(0l, min((long)PROP_ITEMS, c.B - r0));  // the thread's rows
  // (loops run PROP_ITEMS times with a guard, so the row arrays stay in
  // registers)
  // loads first: perm, then the key, min_clock and the prior through it
  int jj[PROP_ITEMS];
  for (int k = 0; k < PROP_ITEMS; ++k) jj[k] = k < n ? c.perm[r0 + k] : 0;
  int mc[PROP_ITEMS];
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
    ks[k] = c.key[jj[k]];
    mc[k] = c.min_clock[jj[k]];
  }
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) pk[k] = c.prior[ks[k]];
  int before = INT_MIN, after = INT_MIN;  // the keys of the tile's neighbours
  if (threadIdx.x == 0 && t0 > 0) before = c.key[c.perm[t0 - 1]];
  if (threadIdx.x == PROP_THREADS - 1 && tile_last + 1 < c.B)
    after = c.key[c.perm[tile_last + 1]];
  sh.first_key[threadIdx.x] = n ? ks[0] : INT_MIN;
  sh.last_key[threadIdx.x] = n ? ks[n - 1] : INT_MIN;
  __syncthreads();
  // scan 1: the heads
  PHead th = PHead::none();
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
    long i = r0 + k;
    int prev = k ? ks[k - 1] : threadIdx.x ? sh.last_key[threadIdx.x - 1] : before;
    hd[k] = i == 0 || prev != ks[k];
    base[k] = max(wrap_add(pk[k], 1), mc[k]);
    if (hd[k]) th.h = (int)i;
  }
  PHead tot1;
  PHead h = block_exclusive(th, sh.s1, &tot1);
  bool unsafe = false;  // a lead row (before the tile's first head) that may wrap
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
    long i = r0 + k;
    if (hd[k]) h.h = (int)i;
    hloc[k] = h.h;
    long long y = (long long)base[k] - i;
    yp[k] = h.h >= 0 ? prop_y(base[k], i, h.h) : y;
    if (h.h < 0 && y < INT_MIN) unsafe = true;
  }
  // scan 2: Y; scan 3: P
  PSegY t2 = PSegY::none();
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) t2 = combine(t2, PSegY{hd[k], yp[k]});
  PSegY tot2;
  PSegY y2 = block_exclusive(t2, sh.s2, &tot2);
  PSegP t3 = PSegP::none();
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
    y2 = combine(y2, PSegY{hd[k], yp[k]});
    yv[k] = y2.Y;
    clk[k] = (int)(unsigned)(unsigned long long)(r0 + k + yv[k]);
    t3 = combine(t3, PSegP{hd[k], clk[k]});
  }
  PSegP tot3;
  PSegP p3 = block_exclusive(t3, sh.s3, &tot3);
  unsafe = __syncthreads_or(unsafe);
  bool has_head = tot1.h >= 0;
  PropAgg agg = {1, has_head, tot1.h, (int)tile_last, has_head ? tot3.P : 0, tot2.Y};
  bool valid = has_head || !unsafe;
  PropAgg e = prop_look_back(c.status, tile, agg, valid, c.epoch, &sh.agg);

  // the lead rows, with the prefix: h = e.h, Y and P carried from e
  if (e.any) {
    if (unsafe) {  // some lead row may wrap: y' with the run's head, Y again
      for (int k = 0; k < PROP_ITEMS; ++k) if (k < n)
        if (hloc[k] < 0) yp[k] = prop_y(base[k], r0 + k, e.h);
      PSegY t = PSegY::none();
      for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) t = combine(t, PSegY{hd[k], yp[k]});
      PSegY tot;
      PSegY y = block_exclusive(t, sh.s2, &tot);
      for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
        y = combine(y, PSegY{hd[k], yp[k]});
        yv[k] = y.Y;
      }
    }
    for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
      if (hloc[k] >= 0) continue;
      yv[k] = max(e.Y, yv[k]);
      clk[k] = (int)(unsigned)(unsigned long long)(r0 + k + yv[k]);
    }
  }
  // P over the lead rows: the run's max clock for its last row here
  PSegP lead = PSegP::none();
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n)
    if (hloc[k] < 0) lead = combine(lead, PSegP{0, clk[k]});
  PSegP lead_tot;
  block_exclusive(lead, sh.s3, &lead_tot);
  int p_lead = e.any ? max(e.P, lead_tot.P) : lead_tot.P;
  sh.last_clock[threadIdx.x] = n ? clk[n - 1] : 0;
  __syncthreads();
  for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) {
    long i = r0 + k;
    int prev_clock = k ? clk[k - 1]
                   : threadIdx.x ? sh.last_clock[threadIdx.x - 1]
                                 : (int)(unsigned)(unsigned long long)(e.L + e.Y);
    c.clock[jj[k]] = clk[k];
    c.vote_start[jj[k]] = wrap_add(hd[k] ? pk[k] : prev_clock, 1);
    p3 = combine(p3, PSegP{hd[k], clk[k]});
    int next = k + 1 < n ? ks[k + 1]
             : threadIdx.x + 1 < PROP_THREADS ? sh.first_key[threadIdx.x + 1] : after;
    if (i == c.B - 1 || next != ks[k]) {
      int p = hloc[k] >= 0 ? p3.P : p_lead;
      if (p > pk[k]) c.prior[ks[k]] = p;
    }
  }
  if (!valid) {  // no aggregate was published: the inclusive prefix now
    // (a tile without a head, some lead row of which may wrap)
    PropAgg incl = {1, 1, e.h, (int)tile_last, p_lead, max(e.Y, tot2.Y)};
    long long ylast = LLONG_MIN;  // Y at the tile's last row, with the head
    for (int k = 0; k < PROP_ITEMS; ++k) if (k < n) ylast = max(ylast, yv[k]);
    PSegY t = {0, ylast}, tot;
    block_exclusive(t, sh.s2, &tot);
    incl.Y = tot.Y;
    if (threadIdx.x == 0) {
      int32_t* mine = c.status + PLB_HEAD + (long)tile * PLB_STATUS;
      incl.put(mine + 8);
      __threadfence();
      *(volatile int32_t*)mine = c.epoch * PLB_EPOCH_STEP + PLB_INCL;
    }
  }
}

__global__ void __launch_bounds__(PROP_THREADS) k_prop_tiles(Proposal c, int tiles) {
  __shared__ PropShared sh;
  int tile = prop_take_tile(c.status, tiles, &sh.tile);
  prop_tile(c, tile, sh);
}

// perm: the stable argsort of key (lex_sort).  status: the look-back
// buffer (PLB_HEAD + PLB_STATUS * tiles ints, kept zeroed between calls but
// for its epoch-tagged flags), epoch this call's.  One launch.
extern "C" int tp_clock_proposal(const int32_t* key, const int32_t* min_clock,
                                 const int32_t* perm, int32_t* prior, int32_t* clock,
                                 int32_t* vote_start, int32_t* status, int B, int epoch,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  int tiles = (int)((B + (long)PROP_TILE - 1) / PROP_TILE);
  Proposal c = {key, min_clock, perm, prior, clock, vote_start, status, B, epoch};
  k_prop_tiles<<<tiles, PROP_THREADS, 0, stream>>>(c, tiles);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// stable_rows: the (n - threshold)-th smallest frontier of each key, with
// the table round's dense vote update before it and executable after it
// ---------------------------------------------------------------------------

__global__ void k_dense_touch(const int32_t* key, uint8_t* touched, int B) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) touched[key[b]] = 1;
}

// one thread per (key, process) lane: contiguous voters of touched keys
// advance to new_prior; the others count as gaps (a warp sum, a block sum,
// then one atomicAdd per block)
__global__ void k_dense_lanes(int32_t* frontier, const int32_t* prior_old,
                              const int32_t* new_prior, const uint8_t* touched,
                              int32_t* gaps, int K, int n, int voters) {
  __shared__ int warp_sums[EW_BLOCK / 32];
  long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  int bad = 0;
  if (idx < (long)K * n) {
    int k = (int)(idx / n);
    int p = (int)(idx % n);
    bool lane = touched[k] && p < voters;
    int f = frontier[idx];
    bool contiguous = f >= prior_old[k];
    if (lane && contiguous) frontier[idx] = max(f, new_prior[k]);
    bad = lane && !contiguous ? 1 : 0;
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
    if (total) atomicAdd(gaps, total);
  }
}

// The cell at sorted index c of each of a block's EW_BLOCK rows.  The
// rows' N cells load into shared memory coalesced (consecutive threads on
// consecutive words), each row at an odd stride so that the threads'
// reads of their rows hit distinct banks; then one thread a row ranks its
// cells (the cells below, plus the equal cells before) with every index
// known at compile time, so they stay in registers, and keeps the cell of
// rank c.  The ranks are a permutation of 0..N-1, as a stable sort's.
template <int N>
__device__ __forceinline__ void stable_select(const int32_t* frontier, int32_t* stable,
                                              int K, int c, int* sh) {
  constexpr int STRIDE = N | 1;
  int row0 = blockIdx.x * EW_BLOCK;
  int rows = K - row0 < EW_BLOCK ? K - row0 : EW_BLOCK;
  const int32_t* src = frontier + (long)row0 * N;
  for (int t = threadIdx.x; t < rows * N; t += blockDim.x)
    sh[(t / N) * STRIDE + t % N] = src[t];
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  int v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = sh[threadIdx.x * STRIDE + i];
  int out = v[0];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) r += v[j] < v[i] || (j < i && v[j] == v[i]);
    out = r == c ? v[i] : out;
  }
  stable[row0 + threadIdx.x] = out;
}

#define STABLE_CASE(N)                                \
  case N:                                             \
    stable_select<N>(frontier, stable, K, c, sh);     \
    break;

// stable[k] = the (c + 1)-th smallest of frontier[k, 0..n), n <= MAX_VOTERS
__global__ void k_stable_select(const int32_t* frontier, int32_t* stable, int K, int n,
                                int c) {
  __shared__ int sh[EW_BLOCK * (MAX_VOTERS | 1)];
  switch (n) {
    STABLE_CASE(1) STABLE_CASE(2) STABLE_CASE(3) STABLE_CASE(4)
    STABLE_CASE(5) STABLE_CASE(6) STABLE_CASE(7) STABLE_CASE(8)
    STABLE_CASE(9) STABLE_CASE(10) STABLE_CASE(11) STABLE_CASE(12)
    STABLE_CASE(13) STABLE_CASE(14) STABLE_CASE(15) STABLE_CASE(16)
  }
}

__global__ void k_dense_exec(const int32_t* key, const int32_t* clock,
                             const int32_t* stable, uint8_t* executable, int B) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) executable[b] = clock[b] <= stable[key[b]];
}

// the stable clocks alone: one launch
extern "C" int tp_stable_only(const int32_t* frontier, int32_t* stable, int K, int n,
                              int c, cudaStream_t stream) {
  if (K <= 0) return 0;
  k_stable_select<<<grid_for(K, EW_BLOCK), EW_BLOCK, 0, stream>>>(frontier, stable, K, n,
                                                                  c);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// the table round: the dense vote update (touched zeroed and gaps set to 0
// by the caller), then the stable clocks, then executable
extern "C" int tp_stable_rows(int32_t* frontier, int32_t* stable, const int32_t* key,
                              const int32_t* clock, const int32_t* prior_old,
                              const int32_t* new_prior, uint8_t* touched,
                              uint8_t* executable, int32_t* gaps, int K, int n, int c,
                              int B, int voters, cudaStream_t stream) {
  if (B > 0) {
    k_dense_touch<<<grid_for(B, EW_BLOCK), EW_BLOCK, 0, stream>>>(key, touched, B);
    CHECK_LAUNCH();
  }
  if ((long)K * n > 0) {
    k_dense_lanes<<<grid_for((long)K * n, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        frontier, prior_old, new_prior, touched, gaps, K, n, voters);
    CHECK_LAUNCH();
  }
  if (K > 0) {
    k_stable_select<<<grid_for(K, EW_BLOCK), EW_BLOCK, 0, stream>>>(frontier, stable, K,
                                                                    n, c);
    CHECK_LAUNCH();
  }
  if (B > 0) {
    k_dense_exec<<<grid_for(B, EW_BLOCK), EW_BLOCK, 0, stream>>>(key, clock, stable,
                                                                 executable, B);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}
