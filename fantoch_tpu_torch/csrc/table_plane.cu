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
// segmented running max (shared by clock_proposal and vote_runs)
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
// inclusive count scan (the run ids of vote_runs)
// ---------------------------------------------------------------------------

__device__ int block_incl_sum(int x, int* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    int y = threadIdx.x >= off ? sh[threadIdx.x - off] : 0;
    __syncthreads();
    sh[threadIdx.x] += y;
    __syncthreads();
  }
  return sh[threadIdx.x];
}

__global__ void k_sum_reduce(const int32_t* x, int32_t* bsum, int n) {
  __shared__ int sh[SCAN_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int inc = block_incl_sum(i < n ? x[i] : 0, sh);
  if (threadIdx.x == blockDim.x - 1) bsum[blockIdx.x] = inc;
}

__global__ void k_sum_carry(const int32_t* bsum, int32_t* carry, int nb) {
  __shared__ int sh[SCAN_BLOCK];
  int running = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    int t = base + threadIdx.x;
    int x = t < nb ? bsum[t] : 0;
    int inc = block_incl_sum(x, sh);
    if (t < nb) carry[t] = running + inc - x;
    running += sh[blockDim.x - 1];
    __syncthreads();
  }
}

__global__ void k_sum_apply(const int32_t* x, int32_t* y, const int32_t* carry, int n) {
  __shared__ int sh[SCAN_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int inc = block_incl_sum(i < n ? x[i] : 0, sh);
  if (i < n) y[i] = inc + carry[blockIdx.x];
}

// y = inclusive prefix sum of x (counts: never past 2^31); scratch holds
// 2 * nblocks ints
static int count_scan(const int32_t* x, int32_t* y, int32_t* scratch, int n,
                      cudaStream_t stream) {
  int nb = (int)grid_for(n, SCAN_BLOCK);
  k_sum_reduce<<<nb, SCAN_BLOCK, 0, stream>>>(x, scratch, n);
  CHECK_LAUNCH();
  k_sum_carry<<<1, SCAN_BLOCK, 0, stream>>>(scratch, scratch + nb, nb);
  CHECK_LAUNCH();
  k_sum_apply<<<nb, SCAN_BLOCK, 0, stream>>>(x, y, scratch + nb, n);
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

__global__ void k_votes_gather(const int32_t* order, const int32_t* gid,
                               const int32_t* vstart, const int32_t* vend,
                               const uint8_t* valid, const int32_t* vkey,
                               const int32_t* vby, int32_t* g, int32_t* s, int32_t* e,
                               uint8_t* vs, int32_t* ko, int32_t* bo, int V) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  int j = order[i];
  g[i] = gid[j];
  s[i] = vstart[j];
  e[i] = vend[j];
  vs[i] = valid[j];
  ko[i] = vkey[j];
  bo[i] = vby[j];
}

// a run starts at a group head or where the start clears the group's
// running max end by more than one (prev_max wraps at row 0 like jnp.roll;
// the group head masks it there)
__global__ void k_votes_newrun(const int32_t* g, const int32_t* s, const int32_t* rme,
                               int32_t* nr, int32_t* run_end, int32_t* run_head, int V) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  bool head = i == 0 || g[i] != g[i - 1];
  int prev = rme[i == 0 ? V - 1 : i - 1];
  nr[i] = head || s[i] > wrap_add(prev, 1) ? 1 : 0;
  run_end[i] = INT_MIN;
  run_head[i] = 0;
}

__global__ void k_votes_scatter(const int32_t* cnt, const int32_t* e, const int32_t* nr,
                                int32_t* run_end, int32_t* run_head, int V) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  int r = cnt[i] - 1;  // the run id
  atomicMax(&run_end[r], e[i]);
  atomicMax(&run_head[r], nr[i] ? i : 0);
}

// one thread per run slot: the run columns, f0 (read before any frontier
// write: the update is the next launch), extends and residual
__global__ void k_votes_runs(const int32_t* cnt, const int32_t* run_head,
                             const int32_t* run_end, const uint8_t* vs,
                             const int32_t* ko, const int32_t* bo, const int32_t* s,
                             const int32_t* frontier, int32_t* run_key,
                             int32_t* run_by, int32_t* run_start, int32_t* ext,
                             uint8_t* residual, int V, int n) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= V) return;
  int num_runs = cnt[V - 1];
  int h = run_head[r];
  bool valid = r < num_runs && vs[h];
  int k = valid ? ko[h] : 0;
  int b = valid ? bo[h] : 0;
  int st = s[h];
  int re = run_end[r];
  int f0 = frontier[(long)k * n + b];
  int f1 = wrap_add(f0, 1);
  bool extends = valid && st <= f1 && re > f0;
  run_key[r] = k;
  run_by[r] = b;
  run_start[r] = st;
  ext[r] = extends ? re : 0;
  residual[r] = valid && st > f1 && re > f0;
}

// frontier.at[run_key, run_by].max(where(extends, run_end, 0)), every slot
// (slots that are not runs scatter 0 into frontier[0, 0], as the reference)
__global__ void k_votes_extend(const int32_t* run_key, const int32_t* run_by,
                               const int32_t* ext, int32_t* frontier, int V, int n) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < V) atomicMax(&frontier[(long)run_key[r] * n + run_by[r]], ext[r]);
}

// order: the (gid, vstart) lexsort permutation (lex_sort).  scratch: the
// sorted columns g, s, e, ko, bo, the running max end, nr, cnt, ext,
// run_head (10 * V ints), vs (V bytes, after them) and 4 * nblocks for
// the scans
extern "C" int tp_vote_runs(const int32_t* order, const int32_t* gid,
                            const int32_t* vkey, const int32_t* vby,
                            const int32_t* vstart, const int32_t* vend,
                            const uint8_t* valid, int32_t* frontier, int32_t* run_key,
                            int32_t* run_by, int32_t* run_start, int32_t* run_end,
                            uint8_t* residual, int32_t* scratch, int V, int n,
                            cudaStream_t stream) {
  if (V <= 0) return 0;
  int32_t* g = scratch;
  int32_t* s = scratch + 1L * V;
  int32_t* e = scratch + 2L * V;
  int32_t* ko = scratch + 3L * V;
  int32_t* bo = scratch + 4L * V;
  int32_t* rme = scratch + 5L * V;
  int32_t* nr = scratch + 6L * V;
  int32_t* cnt = scratch + 7L * V;
  int32_t* ext = scratch + 8L * V;
  int32_t* run_head = scratch + 9L * V;
  int32_t* scan_tmp = scratch + 10L * V;
  uint8_t* vs = (uint8_t*)(scan_tmp + 4L * grid_for(V, SCAN_BLOCK));
  unsigned grid = grid_for(V, EW_BLOCK);
  k_votes_gather<<<grid, EW_BLOCK, 0, stream>>>(order, gid, vstart, vend, valid, vkey,
                                                vby, g, s, e, vs, ko, bo, V);
  CHECK_LAUNCH();
  int err = seg_scan(g, e, rme, scan_tmp, V, stream);
  if (err) return err;
  k_votes_newrun<<<grid, EW_BLOCK, 0, stream>>>(g, s, rme, nr, run_end, run_head, V);
  CHECK_LAUNCH();
  err = count_scan(nr, cnt, scan_tmp, V, stream);
  if (err) return err;
  k_votes_scatter<<<grid, EW_BLOCK, 0, stream>>>(cnt, e, nr, run_end, run_head, V);
  CHECK_LAUNCH();
  k_votes_runs<<<grid, EW_BLOCK, 0, stream>>>(cnt, run_head, run_end, vs, ko, bo, s,
                                              frontier, run_key, run_by, run_start, ext,
                                              residual, V, n);
  CHECK_LAUNCH();
  k_votes_extend<<<grid, EW_BLOCK, 0, stream>>>(run_key, run_by, ext, frontier, V, n);
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
