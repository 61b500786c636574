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
// The reference's loops stay on the host: each launcher below is one
// round (or one fold) and raises a device flag or count that the wrapper's
// caller reads, so every loop stops at the round the reference stops at.
// All work is int32/bool and every cross-row reduction is an integer
// atomic (max/add/or) into zeroed columns, so results are exact in any
// order.  Every round reads the previous round's arrays and writes fresh
// ones: the reference's lines each read the whole array the line before
// wrote.
//
// Interface: every launcher is extern "C", takes raw device pointers, ints
// and a cudaStream_t, launches on that stream, never synchronises and never
// allocates (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its last launch (or the first failing call).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgraph_general.so graph_general.cu

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

#define TERMINAL (-1)
#define MISSING (-2)
#define FROZEN (-3)
#define UNRESOLVED_RANK INT_MAX

#define EW_BLOCK 256     // per-row kernels (a power of two: block_sum)
#define SCAN_BLOCK 1024  // block scans of the compaction

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
// 10. affine round (graph_resolve.py:1089-1157) and the SCC fold (:1166-1176)
// ---------------------------------------------------------------------------

// per row: the SCC aggregates by atomics into zeroed columns, and the
// row's first live slot (jnp.argmax of the live mask: first True, else 0)
__global__ void k_aff_agg(const int32_t* tgt, const int32_t* add, const int32_t* floor,
                          const uint8_t* missing, const int32_t* leader,
                          int32_t* agg_floor, int32_t* agg_live, int32_t* agg_miss,
                          int32_t* agg_frozen, int32_t* comp_tgt, int32_t* comp_add,
                          int B, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  int n_live = 0, vfloor = 0, first = -1;
  bool frozen_any = false;
  for (int w = 0; w < W; ++w) {
    long c = (long)v * W + w;
    int t = tgt[c];
    bool frozen = t == v;  // composed all the way around a cycle
    bool live = t >= 0 && !frozen;
    frozen_any = frozen_any || frozen;
    if (live) {
      ++n_live;
      if (first < 0) first = w;
    }
    vfloor = max(vfloor, floor[c]);  // floors are >= 0
  }
  long slot = (long)v * W + (first < 0 ? 0 : first);
  comp_tgt[v] = tgt[slot];
  comp_add[v] = add[slot];
  int l = leader[v];
  if (vfloor > 0) atomicMax(&agg_floor[l], vfloor);
  if (n_live) atomicAdd(&agg_live[l], n_live);
  if (missing[v]) atomicOr(&agg_miss[l], 1);
  if (frozen_any) atomicOr(&agg_frozen[l], 1);
}

// per row: fold finalized targets, absorb live targets' floors, compose
// through single-slot singleton targets, saturate at B; raise changed
__global__ void k_aff_update(const int32_t* tgt, const int32_t* add, const int32_t* floor,
                             const uint8_t* missing, const int32_t* member_count,
                             const int32_t* agg_floor, const int32_t* agg_live,
                             const int32_t* agg_miss, const int32_t* agg_frozen,
                             const int32_t* comp_tgt, const int32_t* comp_add,
                             int32_t* ntgt, int32_t* nadd, int32_t* nfloor,
                             uint8_t* nmissing, int32_t* changed, int B, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int ch = 0;
  if (v < B) {
    bool miss = missing[v], new_miss = miss;
    for (int w = 0; w < W; ++w) {
      long c = (long)v * W + w;
      int t = tgt[c], a = add[c], f = floor[c];
      int nt = t, na = a, nf = f;
      if (t >= 0 && t != v) {  // live: not TERMINAL/MISSING/frozen
        bool t_miss = agg_miss[t] != 0;
        bool t_final = agg_live[t] == 0 && !t_miss && !agg_frozen[t];
        int t_vfloor = agg_floor[t];
        if (t_final) {
          nf = max(f, a + t_vfloor);
          nt = TERMINAL;
        } else if (t_miss) {
          new_miss = true;
        } else {
          nf = max(f, a + t_vfloor);
          if (agg_live[t] == 1 && member_count[t] == 1 && a < B) {
            nt = comp_tgt[t];
            na = a + comp_add[t];
          }
        }
      }
      nf = min(nf, B);
      na = min(na, B);
      ntgt[c] = nt;
      nadd[c] = na;
      nfloor[c] = nf;
      if (nt != t || nf != f) ch = 1;
    }
    nmissing[v] = new_miss;
    if (new_miss != miss) ch = 1;
  }
  ch = block_sum(ch);
  if (threadIdx.x == 0 && ch) atomicOr(changed, 1);
}

// the SCC fold: scatter-max of final ranks, "any member not final" and
// "any member missing" per leader (columns zeroed by the launcher)
__global__ void k_aff_fold_agg(const int32_t* tgt, const int32_t* floor,
                               const uint8_t* missing, const int32_t* leader,
                               int32_t* scc_rank, int32_t* scc_notfinal,
                               int32_t* scc_missing, int B, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  int n_live = 0, vrank = 0;
  for (int w = 0; w < W; ++w) {
    long c = (long)v * W + w;
    if (tgt[c] >= 0) ++n_live;  // frozen slots count: never final
    vrank = max(vrank, floor[c]);
  }
  bool fin = n_live == 0 && !missing[v];
  int l = leader[v];
  if (fin && vrank > 0) atomicMax(&scc_rank[l], vrank);
  if (!fin) atomicOr(&scc_notfinal[l], 1);
  if (missing[v]) atomicOr(&scc_missing[l], 1);
}

__global__ void k_aff_fold_out(const uint8_t* missing, const int32_t* leader,
                               const int32_t* scc_rank, const int32_t* scc_notfinal,
                               const int32_t* scc_missing, uint8_t* resolved,
                               int32_t* rank, uint8_t* stuck, int B) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= B) return;
  int l = leader[v];
  bool res = !scc_notfinal[l] && !scc_missing[l];
  resolved[v] = res;
  rank[v] = res ? scc_rank[l] : UNRESOLVED_RANK;
  stuck[v] = !res && !(missing[v] || scc_missing[l]);
}

// scratch: 6 * B ints (four aggregate columns, two composition columns);
// final == 0: one round into ntgt/nadd/nfloor/nmissing and changed;
// final == 1: the fold into resolved/rank/stuck
extern "C" int gg_affine_round(const int32_t* tgt, const int32_t* add,
                               const int32_t* floor, const uint8_t* missing,
                               const int32_t* leader, const int32_t* member_count,
                               int32_t* scratch, int32_t* ntgt, int32_t* nadd,
                               int32_t* nfloor, uint8_t* nmissing, int32_t* changed,
                               uint8_t* resolved, int32_t* rank, uint8_t* stuck,
                               int B, int W, int final, cudaStream_t stream) {
  if (B <= 0) return 0;
  unsigned g = grid_for(B, EW_BLOCK);
  int32_t* a0 = scratch;
  int32_t* a1 = scratch + B;
  int32_t* a2 = scratch + 2L * B;
  int32_t* a3 = scratch + 3L * B;
  int32_t* comp_tgt = scratch + 4L * B;
  int32_t* comp_add = scratch + 5L * B;
  if (final) {
    CHECK_CALL(cudaMemsetAsync(scratch, 0, 3 * (size_t)B * sizeof(int32_t), stream));
    k_aff_fold_agg<<<g, EW_BLOCK, 0, stream>>>(tgt, floor, missing, leader, a0, a1, a2,
                                               B, W);
    CHECK_LAUNCH();
    k_aff_fold_out<<<g, EW_BLOCK, 0, stream>>>(missing, leader, a0, a1, a2, resolved,
                                               rank, stuck, B);
    CHECK_LAUNCH();
    return (int)cudaGetLastError();
  }
  CHECK_CALL(cudaMemsetAsync(scratch, 0, 4 * (size_t)B * sizeof(int32_t), stream));
  CHECK_CALL(cudaMemsetAsync(changed, 0, sizeof(int32_t), stream));
  k_aff_agg<<<g, EW_BLOCK, 0, stream>>>(tgt, add, floor, missing, leader, a0, a1, a2,
                                        a3, comp_tgt, comp_add, B, W);
  CHECK_LAUNCH();
  k_aff_update<<<g, EW_BLOCK, 0, stream>>>(tgt, add, floor, missing, member_count, a0,
                                           a1, a2, a3, comp_tgt, comp_add, ntgt, nadd,
                                           nfloor, nmissing, changed, B, W);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 11. peel round (graph_resolve.py:536-553)
// ---------------------------------------------------------------------------

// stats[0]: changed (any newly final, any miss flipped); stats[1]: rows
// neither final nor missing after the round (both zeroed by the launcher)
__global__ void k_peel_round(const int32_t* tgt, const int32_t* floor,
                             const uint8_t* miss, const uint8_t* fin,
                             const int32_t* rank, int32_t* ntgt, int32_t* nfloor,
                             uint8_t* nmiss, uint8_t* nfin, int32_t* nrank,
                             int32_t* stats, int S, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int ch = 0, lv = 0;
  if (v < S) {
    int lift = 0, open = 0;
    bool any_miss = false;
    for (int w = 0; w < W; ++w) {
      long c = (long)v * W + w;
      int t = tgt[c], nt = t;
      if (t >= 0) {
        if (fin[t]) {  // fold a finalized target into the floor
          lift = max(lift, rank[t] + 1);
          nt = TERMINAL;
        }
        any_miss = any_miss || miss[t];
      }
      ntgt[c] = nt;
      if (nt >= 0) ++open;
    }
    int nf = max(floor[v], lift);
    bool m0 = miss[v], nm = m0 || any_miss;
    bool f0 = fin[v];
    bool newly = !f0 && !nm && open == 0;
    nfloor[v] = nf;
    nmiss[v] = nm;
    nfin[v] = f0 || newly;
    nrank[v] = newly ? nf : rank[v];
    ch = (newly || nm != m0) ? 1 : 0;
    lv = (!(f0 || newly) && !nm) ? 1 : 0;
  }
  ch = block_sum(ch);
  lv = block_sum(lv);
  if (threadIdx.x == 0) {
    if (ch) atomicOr(&stats[0], 1);
    if (lv) atomicAdd(&stats[1], lv);
  }
}

extern "C" int gg_peel_round(const int32_t* tgt, const int32_t* floor,
                             const uint8_t* miss, const uint8_t* fin,
                             const int32_t* rank, int32_t* ntgt, int32_t* nfloor,
                             uint8_t* nmiss, uint8_t* nfin, int32_t* nrank,
                             int32_t* stats, int S, int W, cudaStream_t stream) {
  CHECK_CALL(cudaMemsetAsync(stats, 0, 2 * sizeof(int32_t), stream));
  if (S <= 0) return 0;
  k_peel_round<<<grid_for(S, EW_BLOCK), EW_BLOCK, 0, stream>>>(
      tgt, floor, miss, fin, rank, ntgt, nfloor, nmiss, nfin, nrank, stats, S, W);
  CHECK_LAUNCH();
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
