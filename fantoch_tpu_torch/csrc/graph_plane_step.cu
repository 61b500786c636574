// Hopper kernels of the graph-plane step (one resident EPaxos/Atlas
// backlog dispatch): the prologue of every mode and the stages of mode
// "keyed".  They replace the TPU kernel graph_plane_step_pallas
// (fantoch_tpu/ops/pallas_resolve.py:334, tracing graph_plane_step_core,
// fantoch_tpu/ops/graph_resolve.py:883); the general modes' stages are in
// graph_general.cu.  The Python
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
#define SORT_CHUNK 2048  // bitonic elements per block in shared memory

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static inline unsigned grid_for(long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

// ---------------------------------------------------------------------------
// 1. prologue
// ---------------------------------------------------------------------------

__global__ void k_install(int32_t* deps, int32_t* key, int32_t* src, int32_t* seq,
                          uint8_t* occ, uint8_t* executed, const int32_t* u_row,
                          const int32_t* u_deps, const int32_t* u_key,
                          const int32_t* u_src, const int32_t* u_seq, int cap,
                          int width, int U) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= U) return;
  int r = u_row[i];
  if (r < 0 || r >= cap) return;  // pad rows are dropped
  for (int w = 0; w < width; ++w)
    deps[(long)r * width + w] = u_deps[(long)i * width + w];
  key[r] = u_key[i];
  src[r] = u_src[i];
  seq[r] = u_seq[i];
  occ[r] = 1;
  executed[r] = 0;
}

__global__ void k_patch_mark(int32_t* deps, uint8_t* executed, const int32_t* p_row,
                             const int32_t* p_col, const int32_t* p_val,
                             const int32_t* e_row, int cap, int width, int P, int E) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) {
    int r = p_row[i], c = p_col[i];
    if (r >= 0 && r < cap && c >= 0 && c < width) deps[(long)r * width + c] = p_val[i];
  } else if (i < P + E) {
    int r = e_row[i - P];
    if (r >= 0 && r < cap) executed[r] = 1;
  }
}

__global__ void k_fold_compress(const int32_t* deps, const int32_t* key,
                                const uint8_t* occ, const uint8_t* executed,
                                int32_t* col, int32_t* pk, int cap, int width) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= cap) return;
  bool pending = occ[r] && !executed[r];
  bool has_live = false, any_miss = false;
  int first = TERMINAL;
  if (pending) {
    for (int w = 0; w < width; ++w) {
      int v = deps[(long)r * width + w];
      if (v >= 0) {
        int safe = v < cap ? v : cap - 1;
        if (executed[safe]) v = TERMINAL;  // fold deps on executed slots
      }
      if (v >= 0) {
        if (!has_live) {
          has_live = true;
          first = v;
        }
      } else if (v == MISSING) {
        any_miss = true;
      }
    }
  }
  col[r] = has_live ? first : (any_miss ? MISSING : TERMINAL);
  pk[r] = pending ? key[r] : (INT_MAX - r);  // private pad key per slot
}

// the general modes' fold: the folded, masked dep matrix, and the count
// of cells that bar resolve_general's backward-only fast path once
// self-dependencies are pruned (a forward dep, or a MISSING one);
// n_bad is zeroed by the caller
__global__ void k_fold_general(const int32_t* deps, const uint8_t* occ,
                               const uint8_t* executed, int32_t* dmat,
                               int32_t* n_bad, int cap, int width) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int bad = 0;
  if (r < cap) {
    bool pending = occ[r] && !executed[r];
    for (int w = 0; w < width; ++w) {
      int v = TERMINAL;
      if (pending) {
        v = deps[(long)r * width + w];
        if (v >= 0) {
          int safe = v < cap ? v : cap - 1;
          if (executed[safe]) v = TERMINAL;  // fold deps on executed slots
        }
      }
      dmat[(long)r * width + w] = v;
      bad += (v > r || v == MISSING) ? 1 : 0;
    }
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(n_bad, bad);
}

// general == 0: the keyed fold + compression into col/pk;
// general == 1: the general fold into dmat/n_bad
extern "C" int gp_prologue(int32_t* deps, int32_t* key, int32_t* src, int32_t* seq,
                           uint8_t* occ, uint8_t* executed, const int32_t* u_row,
                           const int32_t* u_deps, const int32_t* u_key,
                           const int32_t* u_src, const int32_t* u_seq,
                           const int32_t* p_row, const int32_t* p_col,
                           const int32_t* p_val, const int32_t* e_row, int32_t* col,
                           int32_t* pk, int32_t* dmat, int32_t* n_bad, int cap,
                           int width, int U, int P, int E, int general,
                           cudaStream_t stream) {
  if (U > 0) {
    k_install<<<grid_for(U, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        deps, key, src, seq, occ, executed, u_row, u_deps, u_key, u_src, u_seq, cap,
        width, U);
    CHECK_LAUNCH();
  }
  if (P + E > 0) {
    k_patch_mark<<<grid_for(P + E, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        deps, executed, p_row, p_col, p_val, e_row, cap, width, P, E);
    CHECK_LAUNCH();
  }
  if (cap > 0 && general) {
    k_fold_general<<<grid_for(cap, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        deps, occ, executed, dmat, n_bad, cap, width);
    CHECK_LAUNCH();
  } else if (cap > 0) {
    k_fold_compress<<<grid_for(cap, EW_BLOCK), EW_BLOCK, 0, stream>>>(
        deps, key, occ, executed, col, pk, cap, width);
    CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. stable lexicographic sort: one LSD pass per key, bitonic over u64 words
// ---------------------------------------------------------------------------

// kind 0: int32 key (signed order); 1: bool key; 2: inverted bool key
__global__ void k_sort_make(const void* key, int kind, const int32_t* perm,
                            unsigned long long* vals, int n, int npad) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  if (i >= n) {
    vals[i] = ~0ull;  // padding sorts last
    return;
  }
  int j = perm ? perm[i] : i;
  unsigned k;
  if (kind == 0) {
    k = (unsigned)((const int32_t*)key)[j] ^ 0x80000000u;
  } else {
    unsigned b = ((const uint8_t*)key)[j] ? 1u : 0u;
    k = kind == 2 ? 1u - b : b;
  }
  vals[i] = ((unsigned long long)k << 32) | (unsigned)i;
}

__device__ __forceinline__ void cmp_swap(unsigned long long* a, unsigned long long* b,
                                         bool asc) {
  unsigned long long x = *a, y = *b;
  if ((x > y) == asc && x != y) {
    *a = y;
    *b = x;
  }
}

// sort every chunk in shared memory (all merge levels k <= chunk), with the
// direction of the global bitonic network
__global__ void k_bitonic_local(unsigned long long* v, int chunk) {
  extern __shared__ unsigned long long sh[];
  long base = (long)blockIdx.x * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) sh[t] = v[base + t];
  __syncthreads();
  for (int k = 2; k <= chunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
        int i = 2 * j * (t / j) + (t % j);
        cmp_swap(&sh[i], &sh[i + j], ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) v[base + t] = sh[t];
}

// one compare-exchange step of merge level k at a stride j >= chunk
__global__ void k_bitonic_global(unsigned long long* v, int j, int k, int npad) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= npad / 2) return;
  long i = 2L * j * (t / j) + (t % j);
  cmp_swap(&v[i], &v[i + j], (i & k) == 0);
}

// the strides j < chunk of merge level k, in shared memory
__global__ void k_bitonic_merge(unsigned long long* v, int chunk, int k) {
  extern __shared__ unsigned long long sh[];
  long base = (long)blockIdx.x * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) sh[t] = v[base + t];
  __syncthreads();
  for (int j = chunk >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < chunk / 2; t += blockDim.x) {
      int i = 2 * j * (t / j) + (t % j);
      cmp_swap(&sh[i], &sh[i + j], ((base + i) & k) == 0);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) v[base + t] = sh[t];
}

__global__ void k_sort_apply(const unsigned long long* vals, const int32_t* perm,
                             const int32_t* through, int32_t* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int pos = (int)(unsigned)(vals[i] & 0xffffffffull);
  int j = perm ? perm[pos] : pos;
  out[i] = through ? through[j] : j;
}

static int bitonic_sort(unsigned long long* v, int npad, cudaStream_t stream) {
  if (npad < 2) return 0;
  int chunk = npad < SORT_CHUNK ? npad : SORT_CHUNK;
  int threads = chunk / 2;
  size_t shmem = (size_t)chunk * sizeof(unsigned long long);
  k_bitonic_local<<<npad / chunk, threads, shmem, stream>>>(v, chunk);
  CHECK_LAUNCH();
  for (int k = chunk * 2; k <= npad; k <<= 1) {
    for (int j = k >> 1; j >= chunk; j >>= 1) {
      k_bitonic_global<<<grid_for(npad / 2, EW_BLOCK), EW_BLOCK, 0, stream>>>(v, j, k,
                                                                               npad);
      CHECK_LAUNCH();
    }
    k_bitonic_merge<<<npad / chunk, threads, shmem, stream>>>(v, chunk, k);
    CHECK_LAUNCH();
  }
  return 0;
}

// one LSD pass: out[i] = through[perm[sorted position i]] (through, perm
// optional); stable because each word carries its position
extern "C" int gp_sort_pass(const void* key, int kind, const int32_t* perm,
                            unsigned long long* vals, const int32_t* through,
                            int32_t* out, int n, int npad, cudaStream_t stream) {
  if (n <= 0) return 0;
  k_sort_make<<<grid_for(npad, EW_BLOCK), EW_BLOCK, 0, stream>>>(key, kind, perm, vals,
                                                                 n, npad);
  CHECK_LAUNCH();
  int err = bitonic_sort(vals, npad, stream);
  if (err) return err;
  k_sort_apply<<<grid_for(n, EW_BLOCK), EW_BLOCK, 0, stream>>>(vals, perm, through, out,
                                                               n);
  CHECK_LAUNCH();
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
