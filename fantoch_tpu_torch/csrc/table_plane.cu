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
// segmented running max (clock_proposal)
// ---------------------------------------------------------------------------
// The combiner of table_ops._seg_max_combiner: (a, b) -> (b.seg, a.seg ==
// b.seg ? max(a.val, b.val) : b.val).  It is associative when equal segment
// ids are contiguous, which every caller guarantees (sorted ids).  The
// segment id of a combined range is that of its last element, so only the
// values move.

// Hillis-Steele inclusive segmented max over the block; every thread must
// call it.  ss holds each thread's segment id (unchanged), sv the values.
__device__ int block_seg_max(int seg, int val, int* ss, int* sv) {
  int t = threadIdx.x;
  ss[t] = seg;
  sv[t] = val;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    bool take = t >= off && ss[t - off] == seg;
    int left = take ? sv[t - off] : 0;
    __syncthreads();
    if (take) sv[t] = max(sv[t], left);
    __syncthreads();
  }
  return sv[t];
}

__global__ void k_seg_reduce(const int32_t* seg, const int32_t* val, int32_t* tseg,
                             int32_t* tval, int n) {
  __shared__ int ss[SCAN_BLOCK];
  __shared__ int sv[SCAN_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int inc = block_seg_max(i < n ? seg[i] : INT_MIN, i < n ? val[i] : INT_MIN, ss, sv);
  if (threadIdx.x == blockDim.x - 1) {
    tseg[blockIdx.x] = ss[threadIdx.x];
    tval[blockIdx.x] = inc;
  }
}

// one block: the exclusive combination of the block totals (cseg/cval of
// block 0 are never read: it has no carry)
__global__ void k_seg_carry(const int32_t* tseg, const int32_t* tval, int32_t* cseg,
                            int32_t* cval, int nb) {
  __shared__ int ss[SCAN_BLOCK];
  __shared__ int sv[SCAN_BLOCK];
  int rs = 0, rv = 0;  // the running combination of every earlier chunk
  bool have = false;
  for (int base = 0; base < nb; base += blockDim.x) {
    int t = base + threadIdx.x;
    block_seg_max(t < nb ? tseg[t] : INT_MIN, t < nb ? tval[t] : INT_MIN, ss, sv);
    if (t < nb) {
      if (threadIdx.x == 0) {
        cseg[t] = rs;
        cval[t] = rv;
      } else {
        int ps = ss[threadIdx.x - 1], pv = sv[threadIdx.x - 1];
        cseg[t] = ps;
        cval[t] = have && rs == ps ? max(rv, pv) : pv;
      }
    }
    int ls = ss[blockDim.x - 1], lv = sv[blockDim.x - 1];
    rv = have && rs == ls ? max(rv, lv) : lv;
    rs = ls;
    have = true;
    __syncthreads();
  }
}

__global__ void k_seg_apply(const int32_t* seg, const int32_t* val, const int32_t* cseg,
                            const int32_t* cval, int32_t* out, int n) {
  __shared__ int ss[SCAN_BLOCK];
  __shared__ int sv[SCAN_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int s = i < n ? seg[i] : INT_MIN;
  int inc = block_seg_max(s, i < n ? val[i] : INT_MIN, ss, sv);
  if (i < n) {
    int b = blockIdx.x;
    out[i] = b > 0 && cseg[b] == s ? max(cval[b], inc) : inc;
  }
}

// out = segmented running max of val; scratch holds 4 * nblocks ints
static int seg_scan(const int32_t* seg, const int32_t* val, int32_t* out,
                    int32_t* scratch, int n, cudaStream_t stream) {
  int nb = (int)grid_for(n, SCAN_BLOCK);
  int32_t* tseg = scratch;
  int32_t* tval = scratch + nb;
  int32_t* cseg = scratch + 2 * nb;
  int32_t* cval = scratch + 3 * nb;
  k_seg_reduce<<<nb, SCAN_BLOCK, 0, stream>>>(seg, val, tseg, tval, n);
  CHECK_LAUNCH();
  k_seg_carry<<<1, SCAN_BLOCK, 0, stream>>>(tseg, tval, cseg, cval, nb);
  CHECK_LAUNCH();
  k_seg_apply<<<nb, SCAN_BLOCK, 0, stream>>>(seg, val, cseg, cval, out, n);
  CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// clock_proposal (on the key-sorted batch) and clock_bump
// ---------------------------------------------------------------------------

// first index of the run of x in the ascending a[0..hi)
__device__ int first_of_run(const int32_t* a, int hi, int x) {
  int lo = 0;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void k_prop_gather(const int32_t* key, const int32_t* perm, int32_t* ks,
                              int B) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) ks[i] = key[perm[i]];
}

// rank within the key run, base = max(prior[k] + 1, min_clock), x = base - rank
__global__ void k_prop_base(const int32_t* ks, const int32_t* perm,
                            const int32_t* prior, const int32_t* min_clock,
                            int32_t* rank, int32_t* x, int B) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int k = ks[i];
  int r = i - first_of_run(ks, i, k);
  int base = max(wrap_add(prior[k], 1), min_clock[perm[i]]);
  rank[i] = r;
  x[i] = wrap_sub(base, r);
}

// clock = rank + running, scattered back through perm; the vote range
// starts one past the previous clock on the key (the prior at a run head)
__global__ void k_prop_emit(const int32_t* ks, const int32_t* perm, const int32_t* prior,
                            const int32_t* rank, const int32_t* running, int32_t* clock,
                            int32_t* vote_start, int B) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int j = perm[i];
  clock[j] = wrap_add(rank[i], running[i]);
  bool head = i == 0 || ks[i] != ks[i - 1];
  int prev = head ? prior[ks[i]] : wrap_add(rank[i - 1], running[i - 1]);
  vote_start[j] = wrap_add(prev, 1);
}

// table.at[idx].max(val), in place: the proposal's new_prior (a launch of
// its own, so every read of the old prior above has finished) and
// clock_bump's fold of the host's scalar bumps
__global__ void k_scatter_max(const int32_t* idx, const int32_t* val, int32_t* table,
                              int M) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < M) atomicMax(&table[idx[j]], val[j]);
}

// perm: the stable argsort of key (lex_sort); scratch: ks, rank, x,
// running (4 * B) and 4 * nblocks for the segmented scan
extern "C" int tp_clock_proposal(const int32_t* key, const int32_t* min_clock,
                                 const int32_t* perm, int32_t* prior, int32_t* clock,
                                 int32_t* vote_start, int32_t* scratch, int B,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  int32_t* ks = scratch;
  int32_t* rank = scratch + B;
  int32_t* x = scratch + 2L * B;
  int32_t* running = scratch + 3L * B;
  int32_t* scan_tmp = scratch + 4L * B;
  unsigned grid = grid_for(B, EW_BLOCK);
  k_prop_gather<<<grid, EW_BLOCK, 0, stream>>>(key, perm, ks, B);
  CHECK_LAUNCH();
  k_prop_base<<<grid, EW_BLOCK, 0, stream>>>(ks, perm, prior, min_clock, rank, x, B);
  CHECK_LAUNCH();
  int err = seg_scan(ks, x, running, scan_tmp, B, stream);
  if (err) return err;
  k_prop_emit<<<grid, EW_BLOCK, 0, stream>>>(ks, perm, prior, rank, running, clock,
                                             vote_start, B);
  CHECK_LAUNCH();
  k_scatter_max<<<grid, EW_BLOCK, 0, stream>>>(key, clock, prior, B);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
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
