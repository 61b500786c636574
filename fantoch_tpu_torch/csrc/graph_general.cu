// Hopper kernels of the graph-plane step's general modes (windows with
// multi-key commands: up to W live dependencies per row) and the prologue of
// every mode.  Together with the sort of graph_plane_step.cu they replace
// the TPU kernel graph_plane_step_pallas
// (fantoch_tpu/ops/pallas_resolve.py:334) in modes "general"
// (resolve_general, fantoch_tpu/ops/graph_resolve.py:467 and its
// _resolve_general_iterative, :1052) and "general_resident"
// (resolve_general_resident, :746, with _peel_stage, :528).  The Python
// wrappers, plain versions and per-stage notes on bounds and design are in
// fantoch_tpu_torch/ops/graph_plane_kernels.py (stages 1 and 9-12).
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

#define EW_BLOCK 256     // per-row kernels
#define LOOP_CTA 1024    // the one-CTA kernels' largest block
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

// The plane's epilogue (fantoch_tpu/ops/graph_resolve.py:1009-1010) for
// vertex v whose resolved flag is res: newly = res & occ & ~executed,
// executed |= newly (graph_plane_step.cu §8 keeps its own launch and its
// own copy of this).  The affine loop (§10) and the resident peeler's
// publish (§12) fold it into the phase that makes the flags, when the
// wrapper passes occ, executed and newly (all three or none); each vertex
// is taken by exactly one thread, so executed is updated in place.
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

// threads of a one-CTA launch over n rows: the least power of two (at least
// a warp) that holds every row, at most LOOP_CTA
static int cta_threads(long n) {
  int threads = 32;
  while (threads < n && threads < LOOP_CTA) threads *= 2;
  return threads;
}

// raise `kernel`'s dynamic shared-memory limit on the current device when a
// launch asks for more than it was last set to (48 KB, the default); the
// limit set is kept per (kernel, device), so later launches make no call
struct SmemLimit {
  const void* kernel;
  int dev;
  size_t bytes;
};
static SmemLimit smem_limits[COOP_GRIDS];
static int n_smem_limits = 0;
static std::mutex smem_limits_mu;

template <class F>
static int allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  CHECK_CALL(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> lock(smem_limits_mu);
  SmemLimit* hit = nullptr;
  for (int i = 0; i < n_smem_limits; ++i)
    if (smem_limits[i].kernel == (const void*)kernel && smem_limits[i].dev == dev)
      hit = &smem_limits[i];
  if (hit && hit->bytes >= smem) return 0;
  CHECK_CALL(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
  if (hit)
    hit->bytes = smem;
  else if (n_smem_limits < COOP_GRIDS)
    smem_limits[n_smem_limits++] = {(const void*)kernel, dev, smem};
  return 0;
}

// ---------------------------------------------------------------------------
// 9. mutual collapse (graph_resolve.py:1058-1077), one launch a resolve
// ---------------------------------------------------------------------------
//
// Three phases over every row, each row always taken by the same thread:
//   back: the back test (does a slot of the target point back at v?) as a
//     bitmask a row, one word per 32 slots; leader = idx; counts zeroed;
//   steps: num_doubling_steps(B) of two lines, lb = min(la, the mutual
//     neighbours' la) and la = min(lb, lb[lb]), each reading the whole
//     column the line before wrote, with a barrier after each line (an
//     in-place asynchronous update converges differently within a fixed
//     number of steps); a step is a function of the leader column alone,
//     so the loop stops after the first step that changes no leader;
//   retarget: prune self-dependencies, retarget through the leaders, drop
//     intra-SCC edges, seed add/missing and count each leader's members.
// One CTA (COOP false): la, lb, the counts and the masks in dynamic shared
// memory, the changed flag a __syncthreads_or, leaders and counts written
// out once.  Cooperative (COOP true): la is the leader output and the counts
// atomics into member_count; lb, the masks and three changed slots are
// global scratch; grid barriers, and the changed flag an atomicOr into slot
// s % 3 (block 0 zeroes slot s + 1, which every block last read two
// barriers before).  No memset: every column is written in the first phase.

template <bool COOP>
__device__ void collapse_body(const int32_t* deps, int32_t* la, int32_t* lb,
                              uint32_t* mask, int32_t* mc, int32_t* slots, int32_t* tgt,
                              int32_t* add, uint8_t* missing, int B, int W, int steps) {
  int nw = (W + 31) / 32;
  if (COOP && blockIdx.x == 0 && threadIdx.x == 0) slots[0] = 0;
  FOR_ROWS(v, B) {
    for (int j = 0; j < nw; ++j) {
      uint32_t m = 0;
      for (int w = 32 * j; w < W && w < 32 * j + 32; ++w) {
        int t = deps[v * W + w];
        if (t >= 0 && t != v) {  // a self-dependency is pruned, never mutual
          bool b = false;
          for (int k = 0; k < W; ++k) b = b || deps[(long)t * W + k] == v;
          if (b) m |= 1u << (w - 32 * j);
        }
      }
      mask[v * nw + j] = m;
    }
    la[v] = (int32_t)v;
    mc[v] = 0;
  }
  loop_sync<COOP>();
  for (int s = 0; s < steps; ++s) {
    FOR_ROWS(v, B) {
      int m = la[v];
      for (int j = 0; j < nw; ++j)
        for (uint32_t bits = mask[v * nw + j]; bits; bits &= bits - 1)
          m = min(m, la[deps[v * W + 32 * j + __ffs(bits) - 1]]);
      lb[v] = m;
    }
    loop_sync<COOP>();
    int ch = 0;
    FOR_ROWS(v, B) {
      int x = lb[v];
      int n = min(x, lb[x]);  // never above la[v]: lb[v] <= la[v]
      if (n != la[v]) {
        la[v] = n;
        ch = 1;
      }
    }
    int any = __syncthreads_or(ch);
    if constexpr (COOP) {
      if (threadIdx.x == 0) {
        if (any) atomicOr(&slots[s % 3], 1);
        if (blockIdx.x == 0) slots[(s + 1) % 3] = 0;
      }
      cg::this_grid().sync();
      any = read_slot(&slots[s % 3]);
    }
    if (!any) break;
  }
  FOR_ROWS(v, B) {
    int lv = la[v];
    bool miss = false;
    for (int w = 0; w < W; ++w) {
      long c = v * W + w;
      int t = deps[c];
      if (t == v) {
        t = TERMINAL;
      } else if (t >= 0) {
        t = la[t];
        if (t == lv) t = TERMINAL;
      }
      tgt[c] = t;
      add[c] = t >= 0 ? 1 : 0;
      miss = miss || t == MISSING;
    }
    missing[v] = miss;
    atomicAdd(&mc[lv], 1);
  }
}

__global__ void k_mc_cta(const int32_t* deps, int32_t* leader, int32_t* tgt, int32_t* add,
                         uint8_t* missing, int32_t* member_count, int B, int W, int steps) {
  extern __shared__ int32_t mc_smem[];
  int32_t* la = mc_smem;
  int32_t* lb = la + B;
  int32_t* mc = lb + B;
  collapse_body<false>(deps, la, lb, (uint32_t*)(mc + B), mc, nullptr, tgt, add, missing, B,
                       W, steps);
  __syncthreads();
  FOR_ROWS(v, B) {
    leader[v] = la[v];
    member_count[v] = mc[v];
  }
}

__global__ void k_mc_coop(const int32_t* deps, int32_t* leader, int32_t* tgt, int32_t* add,
                          uint8_t* missing, int32_t* member_count, int32_t* scratch, int B,
                          int W, int steps) {
  int32_t* slots = scratch + B;
  collapse_body<true>(deps, leader, scratch, (uint32_t*)(slots + 3), member_count, slots,
                      tgt, add, missing, B, W, steps);
}

// B <= cta_rows: one CTA of up to LOOP_CTA threads, (3 + ceil(W / 32)) * B
// ints of dynamic shared memory; above, a cooperative launch of
// `block`-thread blocks, scratch B + 3 + ceil(W / 32) * B ints
extern "C" int gg_mutual_collapse(const int32_t* deps, int32_t* leader, int32_t* tgt,
                                  int32_t* add, uint8_t* missing,
                                  int32_t* member_count, int32_t* scratch, int B, int W,
                                  int steps, int cta_rows, int block,
                                  cudaStream_t stream) {
  if (B <= 0) return 0;
  if (B <= cta_rows) {
    size_t smem = (size_t)(3 + (W + 31) / 32) * B * sizeof(int32_t);
    int e = allow_smem(k_mc_cta, smem);
    if (e) return e;
    k_mc_cta<<<1, cta_threads(B), smem, stream>>>(deps, leader, tgt, add, missing,
                                                  member_count, B, W, steps);
    CHECK_LAUNCH();
    return 0;
  }
  int grid = 0;
  int e = coop_grid(k_mc_coop, block, 0, ((long)B + block - 1) / block, &grid);
  if (e) return e;
  void* args[] = {&deps,         &leader,  &tgt, &add, &missing,
                  &member_count, &scratch, &B,   &W,   &steps};
  CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_mc_coop, dim3(grid), dim3(block),
                                         args, 0, stream));
  return (int)cudaGetLastError();
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
//
// The plane's epilogue, when the wrapper asks for it (the general plane
// step's iterative resolve, whose B rows are the window's), is folded into
// the fold's last phase, where each row's resolved flag is made: after the
// barrier that ends the loop and the fold's own, so no barrier is added.
// Nothing in the launch reads occ or executed.

template <bool COOP>
__device__ void affine_loop_body(const int32_t* tgt0, const int32_t* add0,
                                 const uint8_t* miss0, const int32_t* leader,
                                 const int32_t* member_count, int32_t* tgt, int32_t* add,
                                 int32_t* floor, uint8_t* miss, int32_t* cols,
                                 int32_t* slots, uint8_t* resolved, int32_t* rank,
                                 uint8_t* stuck, int32_t* rounds, int32_t* total,
                                 const uint8_t* occ, uint8_t* executed, uint8_t* newly,
                                 int B, int W, int max_iters) {
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
    if (newly) epilogue_row(occ, executed, newly, v, res);
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
                             int32_t* total, const uint8_t* occ, uint8_t* executed,
                             uint8_t* newly, int B, int W, int max_iters) {
  extern __shared__ int32_t aff_smem[];
  affine_loop_body<false>(tgt0, add0, miss0, leader, member_count, tgt, add, floor,
                          miss, aff_smem, nullptr, resolved, rank, stuck, rounds,
                          total, occ, executed, newly, B, W, max_iters);
}

__global__ void k_affine_coop(const int32_t* tgt0, const int32_t* add0,
                              const uint8_t* miss0, const int32_t* leader,
                              const int32_t* member_count, int32_t* tgt, int32_t* add,
                              int32_t* floor, uint8_t* miss, int32_t* cols,
                              int32_t* slots, uint8_t* resolved, int32_t* rank,
                              uint8_t* stuck, int32_t* rounds, int32_t* total,
                              const uint8_t* occ, uint8_t* executed, uint8_t* newly,
                              int B, int W, int max_iters) {
  affine_loop_body<true>(tgt0, add0, miss0, leader, member_count, tgt, add, floor,
                         miss, cols, slots, resolved, rank, stuck, rounds, total, occ,
                         executed, newly, B, W, max_iters);
}

// B <= cta_rows: one CTA of up to LOOP_CTA threads; above, a cooperative
// launch of `block`-thread blocks.  scratch: 3 * B * W ints (the working
// tgt/add/floor), then, cooperative only, 6 * B + 3 ints (the columns and
// the changed slots); miss: B bytes (the working missing flags).  rounds
// gets the rounds run, and total is raised by them.  occ, executed, newly:
// the plane's epilogue over the B rows, folded into the fold's last phase
// (all three or none).
extern "C" int gg_affine_loop(const int32_t* tgt0, const int32_t* add0,
                              const uint8_t* miss0, const int32_t* leader,
                              const int32_t* member_count, int32_t* scratch,
                              uint8_t* miss, uint8_t* resolved, int32_t* rank,
                              uint8_t* stuck, int32_t* rounds, int32_t* total,
                              const uint8_t* occ, uint8_t* executed, uint8_t* newly, int B,
                              int W, int max_iters, int cta_rows, int block,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  if (!epilogue_args_ok(occ, executed, newly)) return (int)cudaErrorInvalidValue;
  int32_t* tgt = scratch;
  int32_t* add = scratch + (long)B * W;
  int32_t* floor = scratch + 2L * B * W;
  if (B <= cta_rows) {
    size_t smem = 6 * (size_t)B * sizeof(int32_t);
    int e = allow_smem(k_affine_cta, smem);
    if (e) return e;
    k_affine_cta<<<1, cta_threads(B), smem, stream>>>(
        tgt0, add0, miss0, leader, member_count, tgt, add, floor, miss, resolved, rank,
        stuck, rounds, total, occ, executed, newly, B, W, max_iters);
    CHECK_LAUNCH();
    return (int)cudaGetLastError();
  }
  int32_t* cols = scratch + 3L * B * W;
  int32_t* slots = cols + 6L * B;
  int grid = 0;
  int e = coop_grid(k_affine_coop, block, 0, ((long)B + block - 1) / block, &grid);
  if (e) return e;
  void* args[] = {&tgt0,  &add0,     &miss0, &leader, &member_count, &tgt,
                  &add,   &floor,    &miss,  &cols,   &slots,        &resolved,
                  &rank,  &stuck,    &rounds, &total, &occ,          &executed,
                  &newly, &B,        &W,     &max_iters};
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
// Init and publish are one operation on the card each, the compaction two;
// none has a memset.
//   init (mode 0): one cooperative launch; block 0 zeroes `live` before the
//     grid barrier, every block adds its count of live rows after it.
//   publish (mode 1, the terminal stage): one cooperative launch; the
//     stage's rows are published, then after a grid barrier stuck =
//     ~out_final & ~out_miss over the whole batch and, for the general_resident
//     plane step (whose batch is the window), the plane's epilogue on
//     out_final, the resolved flags, in the same pass.  Nothing in the
//     launch reads occ or executed but that pass.
//   compact (mode 2): the publish (gated by the `dead` the stage found),
//     then the stable live-first partition: the first `half` rows kept,
//     the gate closed when more than `half` rows are live, the kept rows
//     gathered with their targets remapped, finalized targets folded into
//     the floor, missing ones into miss, and the new live count.  A kept
//     row's targets need the position of any row, so every position must
//     be known first: a grid-wide dependency, met by two launches.  The
//     partition: tiles of PC_TILE rows publish their rows, count their
//     live rows and carry the count across tiles by decoupled look-back
//     (epoch-tagged flags and a ticket, as §3 of graph_plane_step.cu: no
//     memset, see the note there), and place their rows; the last tile
//     writes the live total and closes the gate, and tile 0 zeroes
//     `live`.  To place a row is to write one word for it (pc_place:
//     final, missing, and its rank or the live rows before it) and, if it
//     is kept, its stage row at its position.  Then the gather reads one
//     word a target and computes the target's position on demand.  (One
//     cooperative launch, placing after a grid barrier and gathering after
//     another, was level with these two launches up to 32,768 rows and
//     behind them from 65,536 on, on an H100: it was not kept.)
//     The publish reads the `dead` of the stage before: every tile reads
//     it before it publishes its aggregate, which the last tile waits for
//     before it writes.
// Bound: bytes — the stage's [S, W] matrix and columns read once, the
// half-size state and the published rows written once.

#define PC_THREADS 256
#define PC_ITEMS 8
#define PC_TILE (PC_THREADS * PC_ITEMS)
#define PC_WARPS (PC_THREADS / 32)
#define LB_HEAD 16    // ints before the first tile's status: [0] is the ticket
#define LB_STATUS 16  // ints of a tile's status: flag, aggregate, inclusive
#define LB_AGG 1
#define LB_INCL 2
#define LB_EPOCH_STEP 4  // a flag: epoch * LB_EPOCH_STEP + LB_AGG or LB_INCL

// the look-back buffer's layout as this source has it (checked against the
// wrappers' when the library is loaded): head ints, status ints a tile, the
// aggregate's and the inclusive prefix's flag, epochs' step in a flag
extern "C" void gg_lookback_layout(int32_t* out) {
  out[0] = LB_HEAD;
  out[1] = LB_STATUS;
  out[2] = LB_AGG;
  out[3] = LB_INCL;
  out[4] = LB_EPOCH_STEP;
}

// the call's columns, outputs and scratch
struct PeelCompact {
  const int32_t *tgt, *floor, *rank, *orig;
  const uint8_t *miss, *fin;
  uint8_t *out_final, *out_miss;
  int32_t *out_rank, *dead;
  int32_t *ntgt, *nfloor, *nrank, *norig;
  uint8_t *nmiss, *nfin, *stuck;
  int32_t *live, *scratch, *status;
  // publish: the plane's epilogue over the batch, or all null
  const uint8_t* occ;
  uint8_t *executed, *newly;
  int B, S, W, half, epoch;
};

// a value another block wrote earlier in the same launch: past L1
template <class T>
__device__ __forceinline__ T ld_fresh(const T* p) {
  return *(const volatile T*)p;
}

// a stage row's columns the publish and the partition read, loaded
// before any store (a store could alias a later load, which would then
// wait for it)
struct PcRow {
  int orig, rank;
  uint8_t fin, miss;
  __device__ static PcRow load(const PeelCompact& c, long v) {
    return {c.orig[v], c.rank[v], c.fin[v], c.miss[v]};
  }
  __device__ int live() const { return (!fin && !miss) ? 1 : 0; }
};

// publish a stage row into the batch outputs; orig == B (pads) is
// dropped, and orig values are distinct
__device__ __forceinline__ void pc_publish(const PeelCompact& c, const PcRow& x) {
  if (x.orig < 0 || x.orig >= c.B) return;
  c.out_final[x.orig] = x.fin;
  c.out_miss[x.orig] = x.miss;
  c.out_rank[x.orig] = x.fin ? x.rank : UNRESOLVED_RANK;
}

// a stage row as the gather reads it at a target, one word: bit 31 final,
// bit 30 missing, bits 0-29 the rank (a final row) or the live rows before
// the row (any other, whose position follows from the live total).  A
// rank is a chain length, below the batch, and batches stay below 2^30.
#define CODE_FIN (1u << 31)
#define CODE_MISS (1u << 30)
#define CODE_LOW ((1u << 30) - 1)

// stage row v, with `before` live rows ahead of it: its code, and the row
// at its position if it is kept (live rows in keep_live, the others by
// their rank among them in keep_dead)
__device__ __forceinline__ void pc_place(const PeelCompact& c, const PcRow& x, long v,
                                         int before, int32_t* code, int32_t* keep_live,
                                         int32_t* keep_dead) {
  unsigned low = x.fin ? (unsigned)x.rank & CODE_LOW : (unsigned)before;
  code[v] = (int32_t)(low | (x.fin ? CODE_FIN : 0u) | (x.miss ? CODE_MISS : 0u));
  if (x.live()) {
    if (before < c.half) keep_live[before] = (int)v;
  } else if (v - before < c.half) {
    keep_dead[v - before] = (int)v;
  }
}

// kept row r at half size, given the live `total` and the partition's
// code and keep columns: targets remapped (FROZEN past the half),
// finalized targets folded into the floor, missing ones into miss; returns
// whether the new row is live.  A row's cells are taken CHUNK at a time,
// their loads, then their targets' codes, before any store.
__device__ int pc_gather(const PeelCompact& c, int r, int total, const int32_t* code,
                         const int32_t* keep_live, const int32_t* keep_dead) {
  const int v = r < total ? keep_live[r] : keep_dead[r - total];
  int lift = 0;
  bool m = c.miss[v];
  const int f0 = c.floor[v], rank0 = c.rank[v], orig0 = c.orig[v];
  const uint8_t fin0 = c.fin[v];
  for (int w0 = 0; w0 < c.W; w0 += CHUNK) {
    int t[CHUNK];
    unsigned x[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      t[k] = w0 + k < c.W ? c.tgt[(long)v * c.W + w0 + k] : TERMINAL;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) x[k] = t[k] >= 0 ? (unsigned)code[t[k]] : 0u;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (w0 + k >= c.W) break;
      int nt = t[k];
      if (nt >= 0) {
        bool mt = x[k] & CODE_MISS;
        if (x[k] & CODE_FIN) {
          lift = max(lift, (int)(x[k] & CODE_LOW) + 1);
          nt = TERMINAL;
        } else {
          int before = (int)(x[k] & CODE_LOW);
          int pos = mt ? total + (t[k] - before) : before;
          nt = pos < c.half ? pos : FROZEN;
        }
        m = m || mt;
      }
      c.ntgt[(long)r * c.W + w0 + k] = nt;
    }
  }
  c.nfloor[r] = max(f0, lift);
  c.nmiss[r] = m;
  c.nfin[r] = fin0;
  c.nrank[r] = rank0;
  c.norig[r] = orig0;
  return (!fin0 && !m) ? 1 : 0;
}

// block-wide exclusive sum of x (threads in order) and, in *total, the
// block's sum; blockDim.x a multiple of 32, sh 32 ints of shared memory
// (dynamic in a cooperative kernel); every thread must call it
__device__ int block_excl_sum(int x, int* sh, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  int pre = 0, all = 0;
  for (int w = 0; w < nw; ++w) {
    int s = sh[w];
    if (w < warp) pre += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return pre + inc - x;
}

// mode 0: the padded stage-0 state (pads start final), fresh outputs,
// dead = 0 and live = the state's live count; deps in c.tgt
__global__ void k_pc_init(PeelCompact c) {
  extern __shared__ int32_t pc_smem[];  // 32 ints: block_excl_sum's
  if (blockIdx.x == 0 && threadIdx.x == 0) c.live[0] = 0;
  int lv = 0;
  FOR_ROWS(v, c.S) {
    bool m = false;
    for (int w0 = 0; w0 < c.W; w0 += CHUNK) {
      int t[CHUNK];
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        t[k] = v < c.B && w0 + k < c.W ? c.tgt[v * c.W + w0 + k] : TERMINAL;
        if (t[k] == v) t[k] = TERMINAL;  // self-dependencies are no-ops
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        if (w0 + k >= c.W) break;
        c.ntgt[v * c.W + w0 + k] = t[k];
        m = m || t[k] == MISSING;
      }
    }
    bool f = v >= c.B;
    c.nfloor[v] = 0;
    c.nmiss[v] = m;
    c.nfin[v] = f;
    c.nrank[v] = 0;
    c.norig[v] = v < c.B ? (int)v : c.B;
    if (v < c.B) {
      c.out_final[v] = 0;
      c.out_miss[v] = 0;
      c.out_rank[v] = UNRESOLVED_RANK;
    }
    if (v == 0) c.dead[0] = 0;
    lv += (!f && !m) ? 1 : 0;
  }
  int total;
  block_excl_sum(lv, pc_smem, &total);
  cg::this_grid().sync();  // live is zeroed
  if (threadIdx.x == 0 && total) atomicAdd(c.live, total);
}

// mode 1: publish the terminal stage, then stuck over the batch and, when
// asked, the plane's epilogue on out_final (the resolved flags): the phase
// after the grid barrier already reads every published row, so the fold
// adds no barrier
__global__ void k_pc_publish(PeelCompact c) {
  if (!ld_fresh(c.dead)) {
    FOR_ROWS(v, c.S) pc_publish(c, PcRow::load(c, v));
  }
  cg::this_grid().sync();
  // four rows a thread where the columns are 4-byte aligned (bool columns
  // hold 0 or 1), then the rest a row a thread
  uintptr_t at_bits = (uintptr_t)c.out_final | (uintptr_t)c.out_miss | (uintptr_t)c.stuck;
  if (c.newly) at_bits |= (uintptr_t)c.occ | (uintptr_t)c.executed | (uintptr_t)c.newly;
  const long words = (at_bits & 3) == 0 ? c.B / 4 : 0;
  FOR_ROWS(i, words) {
    uint32_t f = ld_fresh((const uint32_t*)c.out_final + i);
    uint32_t m = ld_fresh((const uint32_t*)c.out_miss + i);
    ((uint32_t*)c.stuck)[i] = (f | m) ^ 0x01010101u;
    if (c.newly) {
      uint32_t e = ((const uint32_t*)c.executed)[i];
      uint32_t nw = f & ((const uint32_t*)c.occ)[i] & ~e & 0x01010101u;
      ((uint32_t*)c.newly)[i] = nw;
      if (nw) ((uint32_t*)c.executed)[i] = e | nw;
    }
  }
  FOR_ROWS(o, c.B - words * 4) {
    long at = words * 4 + o;
    bool f = ld_fresh(c.out_final + at);
    c.stuck[at] = !f && !ld_fresh(c.out_miss + at);
    if (c.newly) epilogue_row(c.occ, c.executed, c.newly, at, f);
  }
}

// the compaction's scratch: the code of each stage row, the kept rows
// (keep_live, keep_dead) and the live total
struct PcScratch {
  int32_t *code, *keep_live, *keep_dead, *total;
  __device__ PcScratch(const PeelCompact& c)
      : code(c.scratch),
        keep_live(c.scratch + c.S),
        keep_dead(keep_live + c.half),
        total(keep_dead + c.half) {}
};

// the live count of a tile, carried by look-back
struct Count {
  int n;
  __device__ static Count none() { return {0}; }
  __device__ void put(int32_t* p) const { p[0] = n; }
  __device__ static Count get(const int32_t* p) { return {*(const volatile int32_t*)p}; }
};
__device__ __forceinline__ Count combine(Count a, Count b) { return {a.n + b.n}; }
__device__ __forceinline__ Count shfl(Count x, int src) {
  return {__shfl_sync(0xffffffffu, x.n, src)};
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
      unsigned incl = __ballot_sync(0xffffffffu, flag == incl_flag);
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


// mode 2, launch 1: the partition
__global__ void __launch_bounds__(PC_THREADS) k_pc_partition(PeelCompact c) {
  __shared__ int sh_row[PC_TILE];  // live flags, then live rows before each row
  __shared__ int sh_warp[PC_WARPS];
  __shared__ Count sh_prefix;
  __shared__ int sh_tile, sh_dead;
  PcScratch sc(c);
  const int tid = threadIdx.x;
  int tiles = (int)(((long)c.S + PC_TILE - 1) / PC_TILE);
  if (tid == 0) sh_dead = ld_fresh(c.dead);
  int tile = take_tile(c.status, tiles, &sh_tile);  // barriers: sh_dead is seen
  const long base = (long)tile * PC_TILE;
  const int cnt = (int)min((long)PC_TILE, c.S - base);
  const bool dead = sh_dead != 0;
  PcRow x[PC_ITEMS];
#pragma unroll
  for (int i = 0; i < PC_ITEMS; ++i) {
    int r = i * PC_THREADS + tid;
    x[i] = r < cnt ? PcRow::load(c, base + r) : PcRow{0, 0, 1, 0};
  }
#pragma unroll
  for (int i = 0; i < PC_ITEMS; ++i) {
    int r = i * PC_THREADS + tid;
    if (r < cnt) {
      if (!dead) pc_publish(c, x[i]);
      sh_row[r] = x[i].live();
    }
  }
  __syncthreads();
  int mine = 0;
#pragma unroll
  for (int k = 0; k < PC_ITEMS; ++k) {
    int r = tid * PC_ITEMS + k;
    mine += r < cnt ? sh_row[r] : 0;
  }
  int count;
  int ex = block_excl_sum(mine, sh_warp, &count);
  Count prior = look_back(c.status, tile, Count{count}, c.epoch, &sh_prefix);
  int run = prior.n + ex;
#pragma unroll
  for (int k = 0; k < PC_ITEMS; ++k) {
    int r = tid * PC_ITEMS + k;
    if (r < cnt) {
      int l = sh_row[r];
      sh_row[r] = run;
      run += l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PC_ITEMS; ++i) {
    int r = i * PC_THREADS + tid;
    if (r < cnt) pc_place(c, x[i], base + r, sh_row[r], sc.code, sc.keep_live, sc.keep_dead);
  }
  if (tid == 0 && tile == 0) c.live[0] = 0;
  if (tid == 0 && tile == tiles - 1) {
    int total = prior.n + count;
    *sc.total = total;
    if (total > c.half) c.dead[0] = 1;
  }
}

// mode 2, launch 2: the gather
__global__ void k_pc_gather(PeelCompact c) {
  __shared__ int sh_warp[EW_BLOCK / 32];
  PcScratch sc(c);
  int total = *sc.total;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int lv = 0;
  if (r < c.half) lv = pc_gather(c, r, total, sc.code, sc.keep_live, sc.keep_dead);
  int count;
  block_excl_sum(lv, sh_warp, &count);
  if (threadIdx.x == 0 && count) atomicAdd(c.live, count);  // tile 0 zeroed it
}

// mode 0 (init): deps in tgt, the padded state out in n*, outputs and dead
//   initialised, live = its live count;
// mode 1 (publish): publish the state, then stuck = ~out_final & ~out_miss
//   and, with occ, executed and newly (all three or none; mode 1 only), the
//   plane's epilogue on out_final;
// mode 2 (compact): publish, then the half-size state in n*, dead updated,
//   live = the new state's live count; scratch S + 2 * half + 1 ints;
//   status and epoch as gp_link_scan's.
// block: threads a block of the cooperative launches (modes 0 and 1)
extern "C" int gg_peel_compact(const int32_t* tgt, const int32_t* floor,
                               const uint8_t* miss, const uint8_t* fin,
                               const int32_t* rank, const int32_t* orig,
                               uint8_t* out_final, uint8_t* out_miss,
                               int32_t* out_rank, int32_t* dead, int32_t* ntgt,
                               int32_t* nfloor, uint8_t* nmiss, uint8_t* nfin,
                               int32_t* nrank, int32_t* norig, int32_t* live,
                               uint8_t* stuck, int32_t* scratch, int32_t* status,
                               const uint8_t* occ, uint8_t* executed, uint8_t* newly,
                               int mode, int B, int S, int W, int half, int epoch, int block,
                               cudaStream_t stream) {
  if (!epilogue_args_ok(occ, executed, newly) || (newly && mode != 1))
    return (int)cudaErrorInvalidValue;
  PeelCompact c = {tgt,      floor, rank, orig,   miss,  fin,   out_final, out_miss,
                   out_rank, dead,  ntgt, nfloor, nrank, norig, nmiss,     nfin,
                   stuck,    live,  scratch, status, occ, executed, newly,
                   B,        S,     W,    half,   epoch};
  void* args[] = {&c};
  size_t smem = 32 * sizeof(int32_t);
  int grid = 0;
  if (mode == 0) {
    if (S <= 0) return 0;
    int e = coop_grid(k_pc_init, block, smem, ((long)S + block - 1) / block, &grid);
    if (e) return e;
    CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_pc_init, dim3(grid), dim3(block),
                                           args, smem, stream));
    return (int)cudaGetLastError();
  }
  if (mode == 1) {
    long rows = S > B ? S : B;
    if (rows <= 0) return 0;
    int e = coop_grid(k_pc_publish, block, smem, (rows + block - 1) / block, &grid);
    if (e) return e;
    CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_pc_publish, dim3(grid),
                                           dim3(block), args, smem, stream));
    return (int)cudaGetLastError();
  }
  if (S <= 0 || half <= 0) return (int)cudaErrorInvalidValue;
  k_pc_partition<<<grid_for(S, PC_TILE), PC_THREADS, 0, stream>>>(c);
  CHECK_LAUNCH();
  k_pc_gather<<<grid_for(half, EW_BLOCK), EW_BLOCK, 0, stream>>>(c);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 13. prologue (graph_resolve.py:927-946), every mode
// ---------------------------------------------------------------------------
//
// Install the feed's rows, patch the MISSING cells whose dots committed,
// mark the host oracle's executed rows, then fold deps on executed slots to
// TERMINAL and mask non-pending rows, in the reference's order: a patch or
// a mark follows the install of its row, and the fold, which reads
// executed[dep] of any row, follows every mark.  The install, patch and
// mark rules (pad rows and out-of-range cells dropped) and the fold of one
// dependency are __device__ functions both modes share; rows, patches and
// marks are walked one a thread, grid-stride.  (Installs and folds a cell a
// thread, a 64-bit index division a cell, took 0.0416 ms on the card in
// mode keyed at 2^20 slots against 0.0311-0.0318 a row a thread.)
//   general (out0 = dmat, out1 = n_bad): one cooperative launch a dispatch
//     (the grid clamped to the co-resident one), the steps split by grid
//     barriers; the fold and mask a row a thread, with the count of cells
//     that bar resolve_general's backward-only fast path once
//     self-dependencies are pruned (a forward dependency or a MISSING one):
//     a warp sum, a shared-memory sum a block, and one atomicAdd a block
//     into n_bad, which block 0 zeroes in the first phase.  No one-CTA
//     form: one CTA was level with it on the card up to 512 slots and
//     behind from 1,024.
//   keyed (out0 = col, out1 = pk): three launches, one a step; the fold a
//     row a thread: the first live folded dependency (else MISSING if any,
//     else TERMINAL) and the run key (pending rows keep their key, the
//     others the private pad key INT_MAX - row).  It stays three launches:
//     one cooperative launch (installs a cell a thread) took 0.0396 ms on
//     the card at 2^20 slots against the three launches' 0.0312.
// Times: one H100 80GB HBM3 at 700 W, chip_smoke.py phase 4b.
// No memset: every output is written by the launches.

// install row i of the feed (a pad row is dropped)
__device__ __forceinline__ void install_row(long i, int32_t* deps, int32_t* key,
                                            int32_t* src, int32_t* seq, uint8_t* occ,
                                            uint8_t* executed, const int32_t* u_row,
                                            const int32_t* u_deps, const int32_t* u_key,
                                            const int32_t* u_src, const int32_t* u_seq,
                                            int cap, int W) {
  int r = u_row[i];
  if (r < 0 || r >= cap) return;
  for (int w = 0; w < W; ++w) deps[(long)r * W + w] = u_deps[i * W + w];
  key[r] = u_key[i];
  src[r] = u_src[i];
  seq[r] = u_seq[i];
  occ[r] = 1;
  executed[r] = 0;
}

// patch j (j < P) or mark j - P (different arrays, so in any order)
__device__ __forceinline__ void patch_or_mark(long j, int32_t* deps, uint8_t* executed,
                                              const int32_t* p_row, const int32_t* p_col,
                                              const int32_t* p_val, const int32_t* e_row,
                                              int cap, int W, int P) {
  if (j < P) {
    int r = p_row[j], c = p_col[j];
    if (r >= 0 && r < cap && c >= 0 && c < W) deps[(long)r * W + c] = p_val[j];
  } else {
    int r = e_row[j - P];
    if (r >= 0 && r < cap) executed[r] = 1;
  }
}

// dependency v of a pending row, folded: TERMINAL if its slot executed
__device__ __forceinline__ int folded(int v, const uint8_t* executed, int cap) {
  return v >= 0 && executed[v < cap ? v : cap - 1] ? TERMINAL : v;
}

#define INSTALL_ARGS                                                                   \
  int32_t *deps, int32_t *key, int32_t *src, int32_t *seq, uint8_t *occ,              \
      uint8_t *executed, const int32_t *u_row, const int32_t *u_deps,                 \
      const int32_t *u_key, const int32_t *u_src, const int32_t *u_seq
#define PROLOGUE_ARGS                                                                  \
  INSTALL_ARGS, const int32_t *p_row, const int32_t *p_col, const int32_t *p_val,     \
      const int32_t *e_row, int32_t *out0, int32_t *out1, int cap, int W, int U, int P, \
      int E

__global__ void k_install(INSTALL_ARGS, int cap, int W, int U) {
  FOR_ROWS(i, U)
  install_row(i, deps, key, src, seq, occ, executed, u_row, u_deps, u_key, u_src, u_seq,
              cap, W);
}

__global__ void k_patch_mark(int32_t* deps, uint8_t* executed, const int32_t* p_row,
                             const int32_t* p_col, const int32_t* p_val,
                             const int32_t* e_row, int cap, int W, int P, int E) {
  FOR_ROWS(j, (long)P + E)
  patch_or_mark(j, deps, executed, p_row, p_col, p_val, e_row, cap, W, P);
}

__global__ void k_fold_keyed(const int32_t* deps, const int32_t* key, const uint8_t* occ,
                             const uint8_t* executed, int32_t* col, int32_t* pk, int cap,
                             int W) {
  FOR_ROWS(r, cap) {
    bool pending = occ[r] && !executed[r];
    int first = TERMINAL;
    bool any_miss = false;
    for (int w = 0; pending && w < W && first == TERMINAL; ++w) {
      int v = folded(deps[r * W + w], executed, cap);
      if (v >= 0)
        first = v;
      else if (v == MISSING)
        any_miss = true;
    }
    col[r] = first != TERMINAL ? first : (any_miss ? MISSING : TERMINAL);
    pk[r] = pending ? key[r] : (int32_t)(INT_MAX - r);
  }
}

__global__ void k_prologue_general(PROLOGUE_ARGS) {
  extern __shared__ int32_t pro_smem[];  // the block's bad-cell sum
  if (threadIdx.x == 0) {
    pro_smem[0] = 0;
    if (blockIdx.x == 0) out1[0] = 0;
  }
  FOR_ROWS(i, U)
  install_row(i, deps, key, src, seq, occ, executed, u_row, u_deps, u_key, u_src, u_seq,
              cap, W);
  cg::this_grid().sync();
  FOR_ROWS(j, (long)P + E)
  patch_or_mark(j, deps, executed, p_row, p_col, p_val, e_row, cap, W, P);
  cg::this_grid().sync();
  int bad = 0;
  FOR_ROWS(r, cap) {
    bool pending = occ[r] && !executed[r];
    for (int w = 0; w < W; ++w) {
      int v = pending ? folded(deps[r * W + w], executed, cap) : TERMINAL;
      out0[r * W + w] = v;
      bad += (v > r || v == MISSING) ? 1 : 0;
    }
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(pro_smem, bad);
  __syncthreads();
  if (threadIdx.x == 0 && pro_smem[0]) atomicAdd(out1, pro_smem[0]);
}

// general: a cooperative launch of `block`-thread blocks, as many as the
// largest phase needs up to the co-resident grid; keyed: three launches
extern "C" int gg_prologue(PROLOGUE_ARGS, int general, int block, cudaStream_t stream) {
  if (!general) {
    if (U > 0) {
      k_install<<<grid_for(U, EW_BLOCK), EW_BLOCK, 0, stream>>>(
          deps, key, src, seq, occ, executed, u_row, u_deps, u_key, u_src, u_seq, cap, W,
          U);
      CHECK_LAUNCH();
    }
    if (P + E > 0) {
      k_patch_mark<<<grid_for((long)P + E, EW_BLOCK), EW_BLOCK, 0, stream>>>(
          deps, executed, p_row, p_col, p_val, e_row, cap, W, P, E);
      CHECK_LAUNCH();
    }
    if (cap > 0) {
      k_fold_keyed<<<grid_for(cap, EW_BLOCK), EW_BLOCK, 0, stream>>>(deps, key, occ,
                                                                     executed, out0, out1,
                                                                     cap, W);
      CHECK_LAUNCH();
    }
    return 0;
  }
  size_t smem = sizeof(int32_t);
  long most = cap > U ? cap : U;
  if ((long)P + E > most) most = (long)P + E;
  int grid = 0;
  int e = coop_grid(k_prologue_general, block, smem, (most + block - 1) / block, &grid);
  if (e) return e;
  void* args[] = {&deps,  &key,   &src,   &seq, &occ,   &executed, &u_row, &u_deps,
                  &u_key, &u_src, &u_seq, &p_row, &p_col, &p_val,  &e_row, &out0,
                  &out1,  &cap,   &W,     &U,   &P,     &E};
  CHECK_CALL(cudaLaunchCooperativeKernel((const void*)k_prologue_general, dim3(grid),
                                         dim3(block), args, smem, stream));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the launch floor: an empty kernel, one warp, which chip_smoke.py times on
// the same stream beside the one-launch kernels above (it replaces no TPU
// kernel and no path calls it)
// ---------------------------------------------------------------------------

__global__ void k_empty() {}

extern "C" int gg_empty(cudaStream_t stream) {
  k_empty<<<1, 32, 0, stream>>>();
  CHECK_LAUNCH();
  return 0;
}
