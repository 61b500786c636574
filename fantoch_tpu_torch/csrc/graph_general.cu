// Hopper kernels of the graph-plane step's general modes (windows with
// multi-key commands: up to W live dependencies per row).  Together with
// the prologue and the sort of graph_plane_step.cu they replace the TPU
// kernel graph_plane_step_pallas (fantoch_tpu/ops/pallas_resolve.py:334)
// in modes "general" (resolve_general, fantoch_tpu/ops/graph_resolve.py:467
// and its _resolve_general_iterative, :1052) and "general_resident"
// (resolve_general_resident, :746, with _peel_stage, :528).  The Python
// wrappers, plain versions and per-stage notes on bounds and design are in
// fantoch_tpu_torch/ops/graph_plane_kernels.py (stages 9-12).
//
// The reference's while_loops run on the device: every affine round of a
// resolve and its SCC fold are one launch (one CTA up to a size gate, a
// cooperative launch above it), every peel round of a stage one
// cooperative launch; each loop stops at the round the reference stops at
// and writes the rounds it ran to a device int.  All work is int32/bool and
// every cross-row reduction is an integer atomic (max/add/or) into zeroed
// columns, so results are exact in any order.  Each round sees the state
// the round before it left, as the reference's lines each read the whole
// array the line before wrote.
//
// Interface: every launcher is extern "C", takes raw device pointers, ints
// and a cudaStream_t, launches on that stream, never synchronises and never
// allocates (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its last launch (or the first failing call; a
// refused cooperative launch is such a call).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgraph_general.so graph_general.cu

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <climits>
#include <mutex>

namespace cg = cooperative_groups;

#define TERMINAL (-1)
#define MISSING (-2)
#define FROZEN (-3)
#define UNRESOLVED_RANK INT_MAX

#define EW_BLOCK 256     // per-row kernels (a power of two: block_sum)
#define SCAN_BLOCK 1024  // block scans of the compaction
#define LOOP_CTA 1024    // the one-CTA affine loop's largest block
#define COMP_NONE INT_MIN  // a composition column's "not composable"
#define CHUNK 4  // the loops take a row's cells four at a time: loads first

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

// block-wide sum (blockDim.x a power of two, at most SCAN_BLOCK); every
// thread of the block must call it
__device__ int block_sum(int x) {
  __shared__ int sh_sum[SCAN_BLOCK];
  sh_sum[threadIdx.x] = x;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh_sum[threadIdx.x] += sh_sum[threadIdx.x + off];
    __syncthreads();
  }
  int total = sh_sum[0];
  __syncthreads();
  return total;
}

// one atomicAdd per block of the block's sum; every thread must call it
__device__ void count_into(int32_t* dst, int x) {
  int total = block_sum(x);
  if (threadIdx.x == 0 && total) atomicAdd(dst, total);
}

// block-wide inclusive sum scan (Hillis-Steele in shared memory)
__device__ int block_incl_sum(int x, int* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    int y = threadIdx.x >= off ? sh[threadIdx.x - off] : 0;
    __syncthreads();
    if (threadIdx.x >= off) sh[threadIdx.x] += y;
    __syncthreads();
  }
  return sh[threadIdx.x];
}

// ---------------------------------------------------------------------------
// 9. mutual collapse (graph_resolve.py:1058-1077)
// ---------------------------------------------------------------------------

// self-dependency prune into tgt, the back test (does a slot of the
// target point back at v?), leader = idx
__global__ void k_mc_back(const int32_t* deps, int32_t* tgt, uint8_t* back,
                          int32_t* leader, int B, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  for (int w = 0; w < W; ++w) {
    int t = deps[(long)v * W + w];
    if (t == v) t = TERMINAL;
    tgt[(long)v * W + w] = t;
    bool b = false;
    if (t >= 0)
      for (int k = 0; k < W; ++k) b = b || deps[(long)t * W + k] == v;
    back[(long)v * W + w] = b;
  }
  leader[v] = v;
}

// leader = min(leader, min over mutual neighbours of leader[nbr])
__global__ void k_mc_min(const int32_t* tgt, const uint8_t* back, const int32_t* lin,
                         int32_t* lout, int B, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  int m = B;
  for (int w = 0; w < W; ++w)
    if (back[(long)v * W + w]) m = min(m, lin[tgt[(long)v * W + w]]);
  lout[v] = min(lin[v], m);
}

// leader = min(leader, leader[leader])
__global__ void k_mc_jump(const int32_t* lin, int32_t* lout, int B) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  lout[v] = min(lin[v], lin[lin[v]]);
}

// retarget through the leaders, drop intra-SCC edges, seed add/missing,
// count members (member_count zeroed by the launcher)
__global__ void k_mc_retarget(int32_t* tgt, int32_t* add, uint8_t* missing,
                              const int32_t* leader, int32_t* member_count, int B,
                              int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  int lv = leader[v];
  bool miss = false;
  for (int w = 0; w < W; ++w) {
    long c = (long)v * W + w;
    int t = tgt[c];
    if (t >= 0) {
      t = leader[t];
      if (t == lv) t = TERMINAL;
    }
    tgt[c] = t;
    add[c] = t >= 0 ? 1 : 0;
    miss = miss || t == MISSING;
  }
  missing[v] = miss;
  atomicAdd(&member_count[lv], 1);
}

extern "C" int gg_mutual_collapse(const int32_t* deps, int32_t* leader, int32_t* tgt,
                                  int32_t* add, uint8_t* missing,
                                  int32_t* member_count, uint8_t* back,
                                  int32_t* spare, int B, int W, int steps,
                                  cudaStream_t stream) {
  if (B <= 0) return 0;
  unsigned g = grid_for(B, EW_BLOCK);
  k_mc_back<<<g, EW_BLOCK, 0, stream>>>(deps, tgt, back, leader, B, W);
  CHECK_LAUNCH();
  for (int s = 0; s < steps; ++s) {
    k_mc_min<<<g, EW_BLOCK, 0, stream>>>(tgt, back, leader, spare, B, W);
    CHECK_LAUNCH();
    k_mc_jump<<<g, EW_BLOCK, 0, stream>>>(spare, leader, B);
    CHECK_LAUNCH();
  }
  CHECK_CALL(cudaMemsetAsync(member_count, 0, (size_t)B * sizeof(int32_t), stream));
  k_mc_retarget<<<g, EW_BLOCK, 0, stream>>>(tgt, add, missing, leader, member_count,
                                            B, W);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the loops' shared pieces: rows walked grid-stride (one block: block-stride),
// and the barrier between the phases of a round
// ---------------------------------------------------------------------------

#define FOR_ROWS(v, n)                                               \
  for (long v = (long)blockIdx.x * blockDim.x + threadIdx.x; v < (n); \
       v += (long)gridDim.x * blockDim.x)

// the grid barrier of a cooperative launch, or the block's barrier
template <bool COOP>
__device__ __forceinline__ void loop_sync() {
  if constexpr (COOP) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// a per-round device flag or count read after the barrier that ends the
// round: volatile, so no block reads its own stale L1 copy
__device__ __forceinline__ int32_t read_slot(const int32_t* p) {
  return *(const volatile int32_t*)p;
}

// the co-resident grid of a cooperative launch of `kernel`: the SM count
// times the blocks of `block` threads one SM holds, at most `want`; a card
// without cooperative launches refuses (never a fallback).  The blocks an
// SM holds are queried once per (kernel, block, shared memory, device) and
// kept, so a launch after the first makes no attribute or occupancy query.
struct CoopGrid {
  const void* kernel;
  int block;
  size_t smem;
  int dev;
  long blocks;  // SM count x blocks an SM holds
};
#define COOP_GRIDS 64
static CoopGrid coop_grids[COOP_GRIDS];
static int n_coop_grids = 0;
static std::mutex coop_grids_mu;

template <class F>
static int coop_grid(F kernel, int block, size_t smem, long want, int* grid) {
  int dev = 0;
  CHECK_CALL(cudaGetDevice(&dev));
  long blocks = -1;
  {
    std::lock_guard<std::mutex> lock(coop_grids_mu);
    for (int i = 0; i < n_coop_grids; ++i) {
      const CoopGrid& c = coop_grids[i];
      if (c.kernel == (const void*)kernel && c.block == block && c.smem == smem &&
          c.dev == dev)
        blocks = c.blocks;
    }
  }
  if (blocks < 0) {
    int coop = 0, sms = 0, per_sm = 0;
    CHECK_CALL(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
    if (!coop) return (int)cudaErrorNotSupported;
    CHECK_CALL(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem));
    blocks = (long)sms * per_sm;
    std::lock_guard<std::mutex> lock(coop_grids_mu);
    if (n_coop_grids < COOP_GRIDS)
      coop_grids[n_coop_grids++] = {(const void*)kernel, block, smem, dev, blocks};
  }
  long g = want < blocks ? want : blocks;
  if (g < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = (int)g;
  return 0;
}

// ---------------------------------------------------------------------------
// 10. affine loop: every round of resolve_general's while_loop
//     (graph_resolve.py:1089-1164) and the SCC fold (:1166-1176) in one launch
// ---------------------------------------------------------------------------
//
// A round has three phases, each over every row, with a barrier between
// them: zero the four leader-indexed aggregate columns; build them (integer
// atomics, exact in any order) and the composition columns (a row that is
// its own singleton SCC with one live slot: that slot's target and add);
// update each row's state.  Every cross-row read of a round is of those
// columns, which the phase before it wrote, so the [B, W] state is updated
// in place: a row reads and writes only its own cells, and each round sees
// the state the round before it left, as the reference's does.  Round 0
// reads the inputs (floor all 0) and writes every cell of the working
// copy; later rounds write only the cells that change.  The loop stops
// after the first round that changed nothing or after max_iters rounds.
//
// One CTA (COOP false): aggregates and composition columns in dynamic shared
// memory (6 * B ints), the changed flag a __syncthreads_or.  Cooperative
// (COOP true): the columns in global scratch, grid barriers, and the changed
// flag an atomicOr into slot r % 3 read after the barrier; block 0 zeroes
// slot (r + 1) % 3 in round r, which every block last read two barriers ago.

template <bool COOP>
__device__ void affine_loop_body(const int32_t* tgt0, const int32_t* add0,
                                 const uint8_t* miss0, const int32_t* leader,
                                 const int32_t* member_count, int32_t* tgt, int32_t* add,
                                 int32_t* floor, uint8_t* miss, int32_t* cols,
                                 int32_t* slots, uint8_t* resolved, int32_t* rank,
                                 uint8_t* stuck, int32_t* rounds, int32_t* total, int B,
                                 int W, int max_iters) {
  int32_t* agg_floor = cols;
  int32_t* agg_live = cols + B;
  int32_t* agg_miss = cols + 2L * B;
  int32_t* agg_frozen = cols + 3L * B;
  int32_t* comp_tgt = cols + 4L * B;
  int32_t* comp_add = cols + 5L * B;
  if (COOP && blockIdx.x == 0 && threadIdx.x == 0) slots[0] = 0;
  int r = 0;
  while (r < max_iters) {
    const int32_t* t_in = r ? tgt : tgt0;
    const int32_t* a_in = r ? add : add0;
    const uint8_t* m_in = r ? miss : miss0;
    FOR_ROWS(v, B) {
      agg_floor[v] = 0;
      agg_live[v] = 0;
      agg_miss[v] = 0;
      agg_frozen[v] = 0;
    }
    loop_sync<COOP>();
    // the SCC aggregates and the composition columns
    FOR_ROWS(v, B) {
      int n_live = 0, vfloor = 0, first = -1;
      bool frozen_any = false;
      for (int w0 = 0; w0 < W; w0 += CHUNK) {
        int t[CHUNK], f[CHUNK];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          long c = v * W + w0 + k;
          t[k] = w0 + k < W ? t_in[c] : TERMINAL;
          f[k] = r && w0 + k < W ? floor[c] : 0;  // floors are >= 0
        }
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          bool frozen = t[k] == v;  // composed all the way around a cycle
          bool live = t[k] >= 0 && !frozen;
          frozen_any = frozen_any || frozen;
          if (live) {
            ++n_live;
            if (first < 0) first = w0 + k;
          }
          vfloor = max(vfloor, f[k]);
        }
      }
      // a singleton SCC (the only row it leads) with one live slot is
      // composed through: its target and add, else COMP_NONE
      if (n_live == 1 && member_count[v] == 1) {
        comp_tgt[v] = t_in[v * W + first];
        comp_add[v] = a_in[v * W + first];
      } else {
        comp_tgt[v] = COMP_NONE;
      }
      int l = leader[v];
      if (vfloor > 0) atomicMax(&agg_floor[l], vfloor);
      if (n_live) atomicAdd(&agg_live[l], n_live);
      if (m_in[v]) atomicOr(&agg_miss[l], 1);
      if (frozen_any) atomicOr(&agg_frozen[l], 1);
    }
    loop_sync<COOP>();
    // fold finalized targets, absorb live targets' floors, compose through
    // single-slot singleton targets, saturate at B
    int ch = 0;
    FOR_ROWS(v, B) {
      bool m0 = m_in[v], nm = m0;
      for (int w0 = 0; w0 < W; w0 += CHUNK) {
        int t[CHUNK], a[CHUNK], f[CHUNK];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          long c = v * W + w0 + k;
          bool in = w0 + k < W;
          t[k] = in ? t_in[c] : TERMINAL;
          a[k] = in ? a_in[c] : 0;
          f[k] = r && in ? floor[c] : 0;
        }
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          if (w0 + k >= W) break;
          long c = v * W + w0 + k;
          int nt = t[k], na = a[k], nf = f[k];
          if (t[k] >= 0 && t[k] != v) {  // live: not TERMINAL/MISSING/frozen
            int u = t[k];
            bool t_miss = agg_miss[u] != 0;
            bool t_final = agg_live[u] == 0 && !t_miss && !agg_frozen[u];
            int t_vfloor = agg_floor[u];
            if (t_final) {
              nf = max(f[k], a[k] + t_vfloor);
              nt = TERMINAL;
            } else if (t_miss) {
              nm = true;
            } else {
              nf = max(f[k], a[k] + t_vfloor);
              if (a[k] < B && comp_tgt[u] != COMP_NONE) {
                nt = comp_tgt[u];
                na = a[k] + comp_add[u];
              }
            }
          }
          nf = min(nf, B);
          na = min(na, B);
          if (!r || nt != t[k]) tgt[c] = nt;  // after round 0, changed cells only
          if (!r || na != a[k]) add[c] = na;
          if (!r || nf != f[k]) floor[c] = nf;
          if (nt != t[k] || nf != f[k]) ch = 1;
        }
      }
      if (!r || nm != m0) miss[v] = nm;
      if (nm != m0) ch = 1;
    }
    int any = __syncthreads_or(ch);
    if constexpr (COOP) {
      if (threadIdx.x == 0) {
        if (any) atomicOr(&slots[r % 3], 1);
        if (blockIdx.x == 0) slots[(r + 1) % 3] = 0;
      }
      cg::this_grid().sync();
      any = read_slot(&slots[r % 3]);
    }
    ++r;
    if (!any) break;
  }
  // the SCC fold: scatter-max of final ranks, "any member not final" and
  // "any member missing" per leader (the first three columns, zeroed here)
  const int32_t* t_f = r ? tgt : tgt0;
  const uint8_t* m_f = r ? miss : miss0;
  FOR_ROWS(v, B) {
    agg_floor[v] = 0;
    agg_live[v] = 0;
    agg_miss[v] = 0;
  }
  loop_sync<COOP>();
  FOR_ROWS(v, B) {
    int n_live = 0, vrank = 0;
    for (int w = 0; w < W; ++w) {
      long c = v * W + w;
      if (t_f[c] >= 0) ++n_live;  // frozen slots count: never final
      if (r) vrank = max(vrank, floor[c]);
    }
    bool fin = n_live == 0 && !m_f[v];
    int l = leader[v];
    if (fin && vrank > 0) atomicMax(&agg_floor[l], vrank);
    if (!fin) atomicOr(&agg_live[l], 1);
    if (m_f[v]) atomicOr(&agg_miss[l], 1);
  }
  loop_sync<COOP>();
  FOR_ROWS(v, B) {
    int l = leader[v];
    bool res = !agg_live[l] && !agg_miss[l];
    resolved[v] = res;
    rank[v] = res ? agg_floor[l] : UNRESOLVED_RANK;
    stuck[v] = !res && !(m_f[v] || agg_miss[l]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *rounds = r;
    atomicAdd(total, r);
  }
}

__global__ void k_affine_cta(const int32_t* tgt0, const int32_t* add0,
                             const uint8_t* miss0, const int32_t* leader,
                             const int32_t* member_count, int32_t* tgt, int32_t* add,
                             int32_t* floor, uint8_t* miss, uint8_t* resolved,
                             int32_t* rank, uint8_t* stuck, int32_t* rounds,
                             int32_t* total, int B, int W, int max_iters) {
  extern __shared__ int32_t aff_smem[];
  affine_loop_body<false>(tgt0, add0, miss0, leader, member_count, tgt, add, floor,
                          miss, aff_smem, nullptr, resolved, rank, stuck, rounds,
                          total, B, W, max_iters);
}

__global__ void k_affine_coop(const int32_t* tgt0, const int32_t* add0,
                              const uint8_t* miss0, const int32_t* leader,
                              const int32_t* member_count, int32_t* tgt, int32_t* add,
                              int32_t* floor, uint8_t* miss, int32_t* cols,
                              int32_t* slots, uint8_t* resolved, int32_t* rank,
                              uint8_t* stuck, int32_t* rounds, int32_t* total, int B,
                              int W, int max_iters) {
  affine_loop_body<true>(tgt0, add0, miss0, leader, member_count, tgt, add, floor,
                         miss, cols, slots, resolved, rank, stuck, rounds, total, B, W,
                         max_iters);
}

// B <= cta_rows: one CTA of up to LOOP_CTA threads; above, a cooperative
// launch of `block`-thread blocks.  scratch: 3 * B * W ints (the working
// tgt/add/floor), then, cooperative only, 6 * B + 3 ints (the columns and
// the changed slots); miss: B bytes (the working missing flags).  rounds
// gets the rounds run, and total is raised by them.
extern "C" int gg_affine_loop(const int32_t* tgt0, const int32_t* add0,
                              const uint8_t* miss0, const int32_t* leader,
                              const int32_t* member_count, int32_t* scratch,
                              uint8_t* miss, uint8_t* resolved, int32_t* rank,
                              uint8_t* stuck, int32_t* rounds, int32_t* total, int B,
                              int W, int max_iters, int cta_rows, int block,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  int32_t* tgt = scratch;
  int32_t* add = scratch + (long)B * W;
  int32_t* floor = scratch + 2L * B * W;
  if (B <= cta_rows) {
    int threads = 32;
    while (threads < B && threads < LOOP_CTA) threads *= 2;
    size_t smem = 6 * (size_t)B * sizeof(int32_t);
    // the dynamic shared-memory limit, raised on each device only when a
    // launch asks for more than it was last set to (48 KB, the default)
    static std::mutex smem_mu;
    static size_t smem_set[64];
    int dev = 0;
    CHECK_CALL(cudaGetDevice(&dev));
    if (smem > 48 * 1024) {
      std::lock_guard<std::mutex> lock(smem_mu);
      if (dev >= 64 || smem > smem_set[dev]) {
        CHECK_CALL(cudaFuncSetAttribute(k_affine_cta,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem));
        if (dev < 64) smem_set[dev] = smem;
      }
    }
    k_affine_cta<<<1, threads, smem, stream>>>(tgt0, add0, miss0, leader, member_count,
                                              tgt, add, floor, miss, resolved, rank,
                                              stuck, rounds, total, B, W, max_iters);
    CHECK_LAUNCH();
    return (int)cudaGetLastError();
  }
  int32_t* cols = scratch + 3L * B * W;
  int32_t* slots = cols + 6L * B;
  int grid = 0;
  int e = coop_grid(k_affine_coop, block, 0, ((long)B + block - 1) / block, &grid);
  if (e) return e;
  void* args[] = {&tgt0, &add0,  &miss0,  &leader, &member_count, &tgt,
                  &add,  &floor, &miss,   &cols,   &slots,        &resolved,
                  &rank, &stuck, &rounds, &total,  &B,            &W,
                  &max_iters};
  CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_affine_coop, dim3(grid),
                                         dim3(block), args, 0, stream));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 11. peel stage: every round of _peel_stage's while_loop (graph_resolve.py
//     :528-566) in one cooperative launch
// ---------------------------------------------------------------------------
//
// A row reads its own target cells, floor and rank, and of other rows only
// the final and miss flags and, for a target final before the round, its
// rank.  Rank changes only when a row turns final, so tgt, floor and rank
// are updated in place (round 0 reads the inputs and writes the outputs);
// final and miss, packed as one state byte a row, ping-pong between two
// buffers, so each round reads the flags the round before it left, as the
// reference's does.  Rows final before a round never change and are skipped
// past.  After each round a grid barrier, then every block reads the
// round's changed flag and live count (rows neither final nor missing) from
// slot r % 3 and takes the same decision: stop on "nothing changed" or,
// unless run_to_fixpoint, on live <= half.  Before the first round the
// stage's initial live count, passed in, is tested the same way.  Block 0
// zeroes slot (r + 1) % 3 in round r; the launcher zeroes all three first.

#define ST_FIN 1
#define ST_MISS 2

__device__ __forceinline__ uint8_t peel_state(const uint8_t* st, const uint8_t* fin0,
                                              const uint8_t* miss0, long v) {
  if (st) return st[v];
  return (fin0[v] ? ST_FIN : 0) | (miss0[v] ? ST_MISS : 0);
}

__global__ void k_peel_stage(const int32_t* tgt0, const int32_t* floor0,
                             const uint8_t* miss0, const uint8_t* fin0,
                             const int32_t* rank0, int32_t* tgt, int32_t* floor,
                             uint8_t* miss, uint8_t* fin, int32_t* rank, uint8_t* st,
                             int32_t* slots, int32_t* rounds, int32_t* total, int S,
                             int W, int live0, int fixpoint) {
  extern __shared__ int32_t peel_smem[];  // the block's live count
  int half = S / 2 > 1 ? S / 2 : 1;
  bool run = fixpoint || live0 > half;
  if (threadIdx.x == 0) peel_smem[0] = 0;
  __syncthreads();
  int r = 0;
  while (run) {
    const uint8_t* st_in = r ? st + (long)((r + 1) & 1) * S : nullptr;
    uint8_t* st_out = st + (long)(r & 1) * S;
    const int32_t* t_in = r ? tgt : tgt0;
    const int32_t* f_in = r ? floor : floor0;
    const int32_t* k_in = r ? rank : rank0;
    int ch = 0, lv = 0;
    FOR_ROWS(v, S) {
      uint8_t s0 = peel_state(st_in, fin0, miss0, v);
      if (s0 & ST_FIN) {  // final rows never change
        st_out[v] = s0;
        if (!r) {
          for (int w = 0; w < W; ++w) tgt[v * W + w] = tgt0[v * W + w];
          floor[v] = floor0[v];
          rank[v] = rank0[v];
        }
        continue;
      }
      int lift = 0, open = 0;
      bool any_miss = false;
      for (int w0 = 0; w0 < W; w0 += CHUNK) {
        int t[CHUNK], kr[CHUNK];
        uint8_t s[CHUNK];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k)
          t[k] = w0 + k < W ? t_in[v * W + w0 + k] : TERMINAL;
#pragma unroll
        for (int k = 0; k < CHUNK; ++k)
          s[k] = t[k] >= 0 ? peel_state(st_in, fin0, miss0, t[k]) : 0;
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) kr[k] = s[k] & ST_FIN ? k_in[t[k]] : 0;
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          if (w0 + k >= W) break;
          int nt = t[k];
          if (s[k] & ST_FIN) {  // fold a finalized target into the floor
            lift = max(lift, kr[k] + 1);
            nt = TERMINAL;
          }
          any_miss = any_miss || (s[k] & ST_MISS);
          if (!r || nt != t[k]) tgt[v * W + w0 + k] = nt;
          if (nt >= 0) ++open;
        }
      }
      int f0 = f_in[v], nf = max(f0, lift);
      bool m0 = s0 & ST_MISS, nm = m0 || any_miss;
      bool newly = !nm && open == 0;
      if (!r || nf != f0) floor[v] = nf;
      if (!r || newly) rank[v] = newly ? nf : k_in[v];
      st_out[v] = (newly ? ST_FIN : 0) | (nm ? ST_MISS : 0);
      if (newly || nm != m0) ch = 1;
      if (!newly && !nm) ++lv;
    }
    lv = __reduce_add_sync(0xffffffffu, lv);
    if ((threadIdx.x & 31) == 0 && lv) atomicAdd(&peel_smem[0], lv);
    int any = __syncthreads_or(ch);
    int32_t* slot = slots + 2 * (r % 3);
    if (threadIdx.x == 0) {
      if (any) atomicOr(&slot[0], 1);
      if (peel_smem[0]) atomicAdd(&slot[1], peel_smem[0]);
      peel_smem[0] = 0;
      if (blockIdx.x == 0) {
        slots[2 * ((r + 1) % 3)] = 0;
        slots[2 * ((r + 1) % 3) + 1] = 0;
      }
    }
    cg::this_grid().sync();
    int changed = read_slot(&slot[0]);
    int live = read_slot(&slot[1]);
    ++r;
    run = changed && (fixpoint || live > half);
  }
  // the flags out of the last round's state bytes (the inputs after none)
  const uint8_t* st_last = r ? st + (long)((r + 1) & 1) * S : nullptr;
  FOR_ROWS(v, S) {
    if (st_last) {
      fin[v] = (st_last[v] & ST_FIN) != 0;
      miss[v] = (st_last[v] & ST_MISS) != 0;
    } else {
      for (int w = 0; w < W; ++w) tgt[v * W + w] = tgt0[v * W + w];
      floor[v] = floor0[v];
      rank[v] = rank0[v];
      fin[v] = fin0[v];
      miss[v] = miss0[v];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *rounds = r;
    atomicAdd(total, r);
  }
}

// st: 2 * S bytes; slots: 6 ints (zeroed here); rounds gets the rounds run,
// and total is raised by them
extern "C" int gg_peel_stage(const int32_t* tgt0, const int32_t* floor0,
                             const uint8_t* miss0, const uint8_t* fin0,
                             const int32_t* rank0, int32_t* tgt, int32_t* floor,
                             uint8_t* miss, uint8_t* fin, int32_t* rank, uint8_t* st,
                             int32_t* slots, int32_t* rounds, int32_t* total, int S,
                             int W, int live0, int fixpoint, int block,
                             cudaStream_t stream) {
  if (S <= 0) return 0;
  size_t smem = sizeof(int32_t);
  int grid = 0;
  int e = coop_grid(k_peel_stage, block, smem, ((long)S + block - 1) / block, &grid);
  if (e) return e;
  CHECK_CALL(cudaMemsetAsync(slots, 0, 6 * sizeof(int32_t), stream));
  void* args[] = {&tgt0, &floor0, &miss0, &fin0, &rank0, &tgt,   &floor,
                  &miss, &fin,    &rank,  &st,   &slots, &rounds, &total,
                  &S,    &W,      &live0, &fixpoint};
  CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_peel_stage, dim3(grid), dim3(block), args,
                                         smem, stream));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 12. peel compact: init, publish, compaction (graph_resolve.py:772-846)
// ---------------------------------------------------------------------------

// the padded stage-0 state (pads start final), fresh outputs, dead = 0
__global__ void k_pc_init(const int32_t* deps, int32_t* tgt, int32_t* floor,
                          uint8_t* miss, uint8_t* fin, int32_t* rank, int32_t* orig,
                          uint8_t* out_final, uint8_t* out_miss, int32_t* out_rank,
                          int32_t* dead, int32_t* live, int B, int S, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int lv = 0;
  if (v < S) {
    bool m = false;
    for (int w = 0; w < W; ++w) {
      int t = TERMINAL;
      if (v < B) {
        t = deps[(long)v * W + w];
        if (t == v) t = TERMINAL;  // self-dependencies are no-ops
      }
      tgt[(long)v * W + w] = t;
      m = m || t == MISSING;
    }
    bool f = v >= B;
    floor[v] = 0;
    miss[v] = m;
    fin[v] = f;
    rank[v] = 0;
    orig[v] = v < B ? v : B;
    if (v < B) {
      out_final[v] = 0;
      out_miss[v] = 0;
      out_rank[v] = UNRESOLVED_RANK;
    }
    if (v == 0) dead[0] = 0;
    lv = (!f && !m) ? 1 : 0;
  }
  count_into(live, lv);
}

// publish the stage's rows unless the gate is closed; orig == B (pads)
// is dropped, and orig values are distinct
__global__ void k_pc_publish(const uint8_t* fin, const uint8_t* miss,
                             const int32_t* rank, const int32_t* orig,
                             uint8_t* out_final, uint8_t* out_miss, int32_t* out_rank,
                             const int32_t* dead, int B, int S) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= S || dead[0]) return;
  int o = orig[v];
  if (o < 0 || o >= B) return;
  out_final[o] = fin[v];
  out_miss[o] = miss[v];
  out_rank[o] = fin[v] ? rank[v] : UNRESOLVED_RANK;
}

__global__ void k_pc_stuck(const uint8_t* out_final, const uint8_t* out_miss,
                           uint8_t* stuck, int B) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  stuck[v] = !out_final[v] && !out_miss[v];
}

__device__ int row_live(const uint8_t* fin, const uint8_t* miss, int v, int S) {
  return (v < S && !fin[v] && !miss[v]) ? 1 : 0;
}

// per-block live counts (SCAN_BLOCK rows a block)
__global__ void k_pc_count(const uint8_t* fin, const uint8_t* miss, int32_t* bcount,
                           int S) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int c = block_sum(row_live(fin, miss, v, S));
  if (threadIdx.x == 0) bcount[blockIdx.x] = c;
}

// one block: exclusive scan of the block counts, their total, and the
// gate: more live rows than the next stage holds means a fixpoint with
// every survivor permanently blocked
__global__ void k_pc_carry(const int32_t* bcount, int32_t* bcarry, int32_t* total,
                           int32_t* dead, int nb, int half) {
  __shared__ int sh[SCAN_BLOCK];
  int running = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    int t = base + threadIdx.x;
    int x = t < nb ? bcount[t] : 0;
    int inc = block_incl_sum(x, sh);
    if (t < nb) bcarry[t] = running + inc - x;
    running += sh[blockDim.x - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *total = running;
    if (running > half) dead[0] = 1;
  }
}

// positions of the stable live-first partition; the first half is kept,
// every other row's targets become FROZEN
__global__ void k_pc_place(const uint8_t* fin, const uint8_t* miss,
                           const int32_t* bcarry, const int32_t* total,
                           int32_t* remap, int32_t* keep, int S, int half) {
  __shared__ int sh[SCAN_BLOCK];
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int l = row_live(fin, miss, v, S);
  int inc = block_incl_sum(l, sh);
  if (v < S) {
    int before = bcarry[blockIdx.x] + inc - l;  // live rows before v
    int pos = l ? before : *total + (v - before);
    if (pos < half) {
      remap[v] = pos;
      keep[pos] = v;
    } else {
      remap[v] = FROZEN;
    }
  }
}

// the kept rows at half size: targets remapped, finalized targets folded
// into the floor, missing targets into miss; the new live count
__global__ void k_pc_gather(const int32_t* tgt, const int32_t* floor,
                            const uint8_t* miss, const uint8_t* fin,
                            const int32_t* rank, const int32_t* orig,
                            const int32_t* remap, const int32_t* keep, int32_t* ntgt,
                            int32_t* nfloor, uint8_t* nmiss, uint8_t* nfin,
                            int32_t* nrank, int32_t* norig, int32_t* live, int half,
                            int W) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int lv = 0;
  if (r < half) {
    int v = keep[r];
    int lift = 0;
    bool m = miss[v];
    for (int w = 0; w < W; ++w) {
      int t = tgt[(long)v * W + w], nt = t;
      if (t >= 0) {
        if (fin[t]) {
          lift = max(lift, rank[t] + 1);
          nt = TERMINAL;
        } else {
          nt = remap[t];
        }
        m = m || miss[t];
      }
      ntgt[(long)r * W + w] = nt;
    }
    nfloor[r] = max(floor[v], lift);
    nmiss[r] = m;
    nfin[r] = fin[v];
    nrank[r] = rank[v];
    norig[r] = orig[v];
    lv = (!fin[v] && !m) ? 1 : 0;
  }
  count_into(live, lv);
}

// mode 0 (init): deps in p0, the padded state out in n*, outputs and dead
//   initialised, live = its live count;
// mode 1 (publish): publish the state, then stuck = ~out_final & ~out_miss;
// mode 2 (compact): publish, then the half-size state in n*, dead updated,
//   live = the new state's live count.
// scratch (mode 2): 2 * S + 2 * ceil(S / SCAN_BLOCK) + 1 ints
extern "C" int gg_peel_compact(const int32_t* tgt, const int32_t* floor,
                               const uint8_t* miss, const uint8_t* fin,
                               const int32_t* rank, const int32_t* orig,
                               uint8_t* out_final, uint8_t* out_miss,
                               int32_t* out_rank, int32_t* dead, int32_t* ntgt,
                               int32_t* nfloor, uint8_t* nmiss, uint8_t* nfin,
                               int32_t* nrank, int32_t* norig, int32_t* live,
                               uint8_t* stuck, int32_t* scratch, int mode, int B,
                               int S, int W, int half, cudaStream_t stream) {
  if (mode == 0) {
    CHECK_CALL(cudaMemsetAsync(live, 0, sizeof(int32_t), stream));
    if (S <= 0) return 0;
    k_pc_init<<<grid_for(S, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        tgt, ntgt, nfloor, nmiss, nfin, nrank, norig, out_final, out_miss, out_rank,
        dead, live, B, S, W);
    CHECK_LAUNCH();
    return (int)cudaGetLastError();
  }
  if (S > 0) {
    k_pc_publish<<<grid_for(S, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        fin, miss, rank, orig, out_final, out_miss, out_rank, dead, B, S);
    CHECK_LAUNCH();
  }
  if (mode == 1) {
    if (B > 0) {
      k_pc_stuck<<<grid_for(B, EW_BLOCK), EW_BLOCK, 0, stream>>>(out_final, out_miss,
                                                                stuck, B);
      CHECK_LAUNCH();
    }
    return (int)cudaGetLastError();
  }
  CHECK_CALL(cudaMemsetAsync(live, 0, sizeof(int32_t), stream));
  if (S <= 0) return 0;
  int nb = (int)grid_for(S, SCAN_BLOCK);
  int32_t* remap = scratch;
  int32_t* keep = scratch + S;
  int32_t* bcount = scratch + 2L * S;
  int32_t* bcarry = bcount + nb;
  int32_t* total = bcarry + nb;
  k_pc_count<<<nb, SCAN_BLOCK, 0, stream>>>(fin, miss, bcount, S);
  CHECK_LAUNCH();
  k_pc_carry<<<1, SCAN_BLOCK, 0, stream>>>(bcount, bcarry, total, dead, nb, half);
  CHECK_LAUNCH();
  k_pc_place<<<nb, SCAN_BLOCK, 0, stream>>>(fin, miss, bcarry, total, remap, keep, S,
                                            half);
  CHECK_LAUNCH();
  if (half > 0) {
    k_pc_gather<<<grid_for(half, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        tgt, floor, miss, fin, rank, orig, remap, keep, ntgt, nfloor, nmiss, nfin,
        nrank, norig, live, half, W);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}
