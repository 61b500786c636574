// Hopper kernels of the Caesar predecessors plane: one resident window step
// (pred_plane_step_pallas, fantoch_tpu/ops/pallas_resolve.py:264, body
// _pred_step_kernel :201) -- install the feed's rows, patch dep cells, then
// the monotone two-phase fixpoint over the whole window.  The Python
// wrapper (pred_plane_step), its plain version and the note on bounds and
// design are in fantoch_tpu_torch/ops/pred_kernels.py.
//
// Interface: every launcher is extern "C", takes raw device pointers, ints
// and a cudaStream_t, launches on that stream, never synchronises and never
// allocates (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its last launch (or the first failing one).
//
// The fixpoint.  A row v is done once it was executed, or once it is
// occupied and every dep cell either never blocks (TERMINAL, or a target in
// the window that is occupied and higher in (clock, src)) or points at a
// done row.  The prepare pass turns each row into a state byte (IDLE, DONE,
// PENDING, or BLOCKED when a cell is MISSING) and each PENDING row's cells
// into wait targets (-1 where the cell never blocks); a sweep marks DONE
// every PENDING row whose wait targets are all DONE.  The operator is
// monotone, so sweeps that update in place, in any order and with stale
// reads of other threads' marks, reach the same least fixpoint as the
// reference's Jacobi rounds; only a sweep that changes nothing ends it.
//
// Two variants, chosen by the wrapper's shared-memory gate:
//   * pp_one_cta: one block of PP_CTA threads does install, patch, prepare,
//     every sweep (wait targets and state bytes in shared memory, a
//     __syncthreads_or per sweep) and the finish, in one launch;
//   * pp_grid_prepare / pp_grid_sweeps / pp_grid_finish: one thread a row,
//     one sweep a launch.  pp_grid_sweeps enqueues S sweeps at once, each
//     reading the flag the one before it wrote and returning at once when
//     that sweep changed nothing; the wrapper reads the S + 1 flags after
//     each batch.  No grid-wide barrier inside a kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpred_plane.so pred_plane.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define EW_BLOCK 256  // one thread a row (or a feed entry)
#define PP_CTA 1024   // the one-CTA variant's block

#define TERMINAL (-1)

// per-row fixpoint state
#define ST_IDLE 0     // not occupied, not executed: never done
#define ST_DONE 1
#define ST_PENDING 2  // occupied, waiting on its wait targets
#define ST_BLOCKED 3  // a MISSING (or other negative) cell: not this dispatch

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static inline unsigned grid_for(long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

// (1) install feed row i: the full row, occupied and not executed.  Rows
// outside [0, C) are pads and dropped.
__device__ __forceinline__ void install_row(int i, int32_t* deps, int32_t* clock,
                                            int32_t* src, uint8_t* occ,
                                            uint8_t* executed, const int32_t* u_row,
                                            const int32_t* u_deps,
                                            const int32_t* u_clock,
                                            const int32_t* u_src, int C, int W) {
  int r = u_row[i];
  if (r < 0 || r >= C) return;
  for (int w = 0; w < W; ++w) deps[(size_t)r * W + w] = u_deps[(size_t)i * W + w];
  clock[r] = u_clock[i];
  src[r] = u_src[i];
  occ[r] = 1;
  executed[r] = 0;
}

// (2) patch cell i; cells outside [0, C) x [0, W) are pads and dropped
__device__ __forceinline__ void patch_cell(int i, int32_t* deps, const int32_t* p_row,
                                           const int32_t* p_col, const int32_t* p_val,
                                           int C, int W) {
  int r = p_row[i], c = p_col[i];
  if (r < 0 || r >= C || c < 0 || c >= W) return;
  deps[(size_t)r * W + c] = p_val[i];
}

// (3) the row's state byte and its wait targets (never_blocks, once a
// dispatch).  A dep index at or past C reads row C - 1, as the reference's
// clamped gather does.
__device__ __forceinline__ uint8_t prepare_row(int v, const int32_t* deps,
                                               const int32_t* clock, const int32_t* src,
                                               const uint8_t* occ,
                                               const uint8_t* executed, int32_t* wait,
                                               int C, int W) {
  if (executed[v]) return ST_DONE;
  if (!occ[v]) return ST_IDLE;
  int cv = clock[v], sv = src[v];
  uint8_t state = ST_PENDING;
  for (int w = 0; w < W; ++w) {
    int dep = deps[(size_t)v * W + w];
    int target = -1;
    if (dep != TERMINAL) {
      if (dep < 0) {
        state = ST_BLOCKED;  // MISSING always blocks
      } else {
        int q = dep < C ? dep : C - 1;
        int cq = clock[q];
        bool higher = cq > cv || (cq == cv && src[q] > sv);
        if (!(occ[q] && higher)) target = q;
      }
    }
    wait[w] = target;
  }
  return state;
}

__device__ __forceinline__ bool ready(const int32_t* wait, const uint8_t* st, int W) {
  for (int w = 0; w < W; ++w) {
    int t = wait[w];
    if (t >= 0 && st[t] != ST_DONE) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// one CTA: the whole step in one launch, the fixpoint in shared memory
// ---------------------------------------------------------------------------

__global__ void k_one_cta(int32_t* deps, int32_t* clock, int32_t* src, uint8_t* occ,
                          uint8_t* executed, const int32_t* u_row,
                          const int32_t* u_deps, const int32_t* u_clock,
                          const int32_t* u_src, const int32_t* p_row,
                          const int32_t* p_col, const int32_t* p_val, uint8_t* newly,
                          int32_t* sweeps, int C, int W, int U, int P) {
  extern __shared__ int32_t pp_smem[];
  int32_t* wait = pp_smem;                              // C * W
  uint8_t* st = (uint8_t*)(pp_smem + (size_t)C * W);    // C
  int tid = threadIdx.x;
  int stride = blockDim.x;
  for (int i = tid; i < U; i += stride)
    install_row(i, deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src, C, W);
  __syncthreads();
  for (int i = tid; i < P; i += stride) patch_cell(i, deps, p_row, p_col, p_val, C, W);
  __syncthreads();
  for (int v = tid; v < C; v += stride)
    st[v] = prepare_row(v, deps, clock, src, occ, executed, wait + (size_t)v * W, C, W);
  __syncthreads();
  int n = 0;
  for (;;) {
    int changed = 0;
    for (int v = tid; v < C; v += stride) {
      if (st[v] == ST_PENDING && ready(wait + (size_t)v * W, st, W)) {
        st[v] = ST_DONE;
        changed = 1;
      }
    }
    ++n;
    if (!__syncthreads_or(changed)) break;
  }
  for (int v = tid; v < C; v += stride) {
    uint8_t done = st[v] == ST_DONE;
    newly[v] = done && !executed[v];
    executed[v] = done;
  }
  if (tid == 0) *sweeps = n;
}

extern "C" int pp_one_cta(int32_t* deps, int32_t* clock, int32_t* src, uint8_t* occ,
                          uint8_t* executed, const int32_t* u_row,
                          const int32_t* u_deps, const int32_t* u_clock,
                          const int32_t* u_src, const int32_t* p_row,
                          const int32_t* p_col, const int32_t* p_val, uint8_t* newly,
                          int32_t* sweeps, int C, int W, int U, int P,
                          cudaStream_t stream) {
  size_t smem = (size_t)C * W * sizeof(int32_t) + (size_t)C;
  cudaError_t e = cudaFuncSetAttribute(k_one_cta, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_one_cta<<<1, PP_CTA, smem, stream>>>(deps, clock, src, occ, executed, u_row, u_deps,
                                         u_clock, u_src, p_row, p_col, p_val, newly,
                                         sweeps, C, W, U, P);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// grid-wide: one thread a row, one sweep a launch
// ---------------------------------------------------------------------------

__global__ void k_install(int32_t* deps, int32_t* clock, int32_t* src, uint8_t* occ,
                          uint8_t* executed, const int32_t* u_row,
                          const int32_t* u_deps, const int32_t* u_clock,
                          const int32_t* u_src, int C, int W, int U) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < U)
    install_row(i, deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src, C, W);
}

__global__ void k_patch(int32_t* deps, const int32_t* p_row, const int32_t* p_col,
                        const int32_t* p_val, int C, int W, int P) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) patch_cell(i, deps, p_row, p_col, p_val, C, W);
}

__global__ void k_prepare(const int32_t* deps, const int32_t* clock, const int32_t* src,
                          const uint8_t* occ, const uint8_t* executed, int32_t* wait,
                          uint8_t* st, int C, int W) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < C)
    st[v] = prepare_row(v, deps, clock, src, occ, executed, wait + (size_t)v * W, C, W);
}

// one sweep; runs only when the sweep before it changed something
__global__ void k_sweep(const int32_t* wait, uint8_t* st, int C, int W,
                        const int32_t* prev, int32_t* cur) {
  if (*prev == 0) return;
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= C || st[v] != ST_PENDING) return;
  if (ready(wait + (size_t)v * W, st, W)) {
    st[v] = ST_DONE;
    *cur = 1;
  }
}

__global__ void k_finish(const uint8_t* st, uint8_t* executed, uint8_t* newly, int C) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= C) return;
  uint8_t done = st[v] == ST_DONE;
  newly[v] = done && !executed[v];
  executed[v] = done;
}

extern "C" int pp_grid_prepare(int32_t* deps, int32_t* clock, int32_t* src, uint8_t* occ,
                               uint8_t* executed, const int32_t* u_row,
                               const int32_t* u_deps, const int32_t* u_clock,
                               const int32_t* u_src, const int32_t* p_row,
                               const int32_t* p_col, const int32_t* p_val, int32_t* wait,
                               uint8_t* st, int C, int W, int U, int P,
                               cudaStream_t stream) {
  // install, then patch: a patch may land on a row this dispatch installs
  if (U > 0) {
    k_install<<<grid_for(U, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        deps, clock, src, occ, executed, u_row, u_deps, u_clock, u_src, C, W, U);
    CHECK_LAUNCH();
  }
  if (P > 0) {
    k_patch<<<grid_for(P, EW_BLOCK), EW_BLOCK, 0, stream>>>(deps, p_row, p_col, p_val,
                                                             C, W, P);
    CHECK_LAUNCH();
  }
  if (C > 0) {
    k_prepare<<<grid_for(C, EW_BLOCK), EW_BLOCK, 0, stream>>>(deps, clock, src, occ,
                                                               executed, wait, st, C, W);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}

// S sweeps; flags[0] is set (the first sweep runs), flags[s + 1] says
// whether sweep s changed something
extern "C" int pp_grid_sweeps(const int32_t* wait, uint8_t* st, int32_t* flags, int C,
                              int W, int S, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(flags, 0, (size_t)(S + 1) * sizeof(int32_t), stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(flags, 1, 1, stream);
  if (e != cudaSuccess) return (int)e;
  if (C <= 0) return 0;
  for (int s = 0; s < S; ++s) {
    k_sweep<<<grid_for(C, EW_BLOCK), EW_BLOCK, 0, stream>>>(wait, st, C, W, flags + s,
                                                            flags + s + 1);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}

extern "C" int pp_grid_finish(const uint8_t* st, uint8_t* executed, uint8_t* newly, int C,
                              cudaStream_t stream) {
  if (C <= 0) return 0;
  k_finish<<<grid_for(C, EW_BLOCK), EW_BLOCK, 0, stream>>>(st, executed, newly, C);
  CHECK_LAUNCH();
  return (int)cudaGetLastError();
}
