// CPU emulation of the CUDA subset the port's kernels use (csrc/emu/emulate.py).
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>
#include <climits>
#include <algorithm>
#include <functional>
#include <memory>
#include <type_traits>
using std::max; using std::min;
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline unsigned g_grid = 1, g_block = 1;
inline size_t g_smem_bytes = 0;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __align__(n) alignas(n)
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
#define cudaErrorCooperativeLaunchTooLarge 720
#define cudaErrorNotSupported 801
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { memset(p, v, n); return 0; }

// one block's shared state: its barrier (__syncthreads), the slots of the
// block-wide and warp collectives, a barrier per warp and its dynamic
// shared memory; every thread points at its block's
struct MockBlock {
  std::barrier<> bar;
  int slots[1024];
  unsigned lanes[1024];
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<char> smem;
  MockBlock(unsigned block, size_t smem_bytes) : bar(block), smem(smem_bytes + 16, 0) {
    for (unsigned w = 0; w * 32 < block; ++w)
      warps.emplace_back(new std::barrier<>(std::min(32u, block - w * 32)));
  }
};
inline thread_local MockBlock* t_block = nullptr;
inline thread_local std::barrier<>* t_warp_bar = nullptr;
// the grid barrier of a cooperative launch (null outside one)
inline std::barrier<>* g_grid_bar = nullptr;

inline void __syncthreads() { t_block->bar.arrive_and_wait(); }
// warp collectives emulated with block barriers (every thread must call)
inline int __reduce_add_sync(unsigned, int v) {
  int t = threadIdx.x; t_block->slots[t] = v; __syncthreads();
  int base = t & ~31, s = 0;
  for (int i = base; i < base + 32 && i < (int)blockDim.x; ++i) s += t_block->slots[i];
  __syncthreads();
  return s;
}
// warp collectives of the radix sort: a barrier per warp, slots per lane
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned* lanes = t_block->lanes;
  int t = threadIdx.x; lanes[t] = pred != 0; t_warp_bar->arrive_and_wait();
  int base = t & ~31; unsigned m = 0;
  for (int i = base; i < base + 32 && i < (int)blockDim.x; ++i)
    if (lanes[i]) m |= 1u << (i - base);
  t_warp_bar->arrive_and_wait();
  return m;
}
inline int __shfl_sync(unsigned, int v, int src) {
  unsigned* lanes = t_block->lanes;
  int t = threadIdx.x; lanes[t] = (unsigned)v; t_warp_bar->arrive_and_wait();
  int r = (int)lanes[(t & ~31) + (src & 31)];
  t_warp_bar->arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  unsigned* lanes = t_block->lanes;
  int t = threadIdx.x; lanes[t] = (unsigned)v; t_warp_bar->arrive_and_wait();
  int r = (t & 31) >= (int)delta ? (int)lanes[t - delta] : v;
  t_warp_bar->arrive_and_wait();
  return r;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  unsigned* lanes = t_block->lanes;
  int t = threadIdx.x; lanes[t] = v; t_warp_bar->arrive_and_wait();
  int base = t & ~31; unsigned r = 0;
  for (int i = base; i < base + 32 && i < (int)blockDim.x; ++i) r |= lanes[i];
  t_warp_bar->arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { t_warp_bar->arrive_and_wait(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __syncthreads_or(int v) {
  t_block->slots[threadIdx.x] = v; __syncthreads();
  int any = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) any |= t_block->slots[i];
  __syncthreads();
  return any != 0;
}
inline int __syncthreads_count(int v) {
  t_block->slots[threadIdx.x] = v != 0; __syncthreads();
  int n = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) n += t_block->slots[i];
  __syncthreads();
  return n;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class T> T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
template <class T> T atomicSub(T* p, T v) { return std::atomic_ref<T>(*p).fetch_sub(v); }
template <class T> T atomicOr(T* p, T v) { return std::atomic_ref<T>(*p).fetch_or(v); }
template <class T> T atomicCAS(T* p, T expected, T v) {
  std::atomic_ref<T>(*p).compare_exchange_strong(expected, v);
  return expected;  // the old value, whether or not it was replaced
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T> T atomicMax(T* p, T v) {
  std::atomic_ref<T> a(*p); T old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
template <class T> T atomicMin(T* p, T v) {
  std::atomic_ref<T> a(*p); T old = a.load();
  while (old > v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline void* mock_dyn_smem() { return t_block->smem.data(); }
inline int mock_cfg(unsigned grid, unsigned block, size_t smem = 0, cudaStream_t = nullptr) {
  g_grid = grid; g_block = block; g_smem_bytes = smem; return 0;
}
// k<<<grid, block>>>: the block's threads at once, the blocks one after
// another (one MockBlock for all of them)
template <class F, class... A> void mock_launch(F f, A... args) {
  unsigned grid = g_grid, block = g_block;
  if (grid == 0 || block == 0) return;
  gridDim = dim3(grid); blockDim = dim3(block);
  MockBlock blk(block, g_smem_bytes);
  std::vector<std::thread> ts;
  ts.reserve(block);
  for (unsigned t = 0; t < block; ++t) {
    ts.emplace_back([&, t]() {
      threadIdx = dim3(t);
      t_block = &blk;
      t_warp_bar = blk.warps[t / 32].get();
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx = dim3(b);
        f(args...);
        blk.bar.arrive_and_wait();  // block boundary
      }
    });
  }
  for (auto& th : ts) th.join();
}

// cooperative launches: a small card (MOCK_SMS SMs holding
// MOCK_BLOCKS_PER_SM blocks each), so a test crosses a real multi-block grid
// barrier with few OS threads; every block's threads start at once
#define MOCK_SMS 2
#define MOCK_BLOCKS_PER_SM 2
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount, cudaDevAttrCooperativeLaunch };
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? MOCK_SMS : 1;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = MOCK_BLOCKS_PER_SM;
  return 0;
}
namespace cooperative_groups {
struct grid_group {
  void sync() const {
    if (!g_grid_bar) {
      fprintf(stderr, "cuda_mock: grid sync outside a cooperative launch\n");
      abort();
    }
    g_grid_bar->arrive_and_wait();
  }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
template <class... A, size_t... I>
void mock_call(void (*f)(A...), void** args, std::index_sequence<I...>) {
  f(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}
// cudaLaunchCooperativeKernel((const void*)k, ...), typed by the translation
template <class... A>
int mock_launch_cooperative(void (*f)(A...), dim3 grid, dim3 block, void** args,
                            size_t smem, cudaStream_t) {
  unsigned G = grid.x, T = block.x;
  if (G == 0 || T == 0) return 0;
  if (G > MOCK_SMS * MOCK_BLOCKS_PER_SM) return cudaErrorCooperativeLaunchTooLarge;
  gridDim = grid; blockDim = block;
  std::barrier<> gbar(G * T);
  g_grid_bar = &gbar;
  std::vector<std::unique_ptr<MockBlock>> blocks;
  for (unsigned b = 0; b < G; ++b) blocks.emplace_back(new MockBlock(T, smem));
  std::vector<std::thread> ts;
  ts.reserve(G * T);
  for (unsigned b = 0; b < G; ++b)
    for (unsigned t = 0; t < T; ++t)
      ts.emplace_back([&, b, t]() {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        t_block = blocks[b].get();
        t_warp_bar = t_block->warps[t / 32].get();
        mock_call(f, args, std::index_sequence_for<A...>{});
      });
  for (auto& th : ts) th.join();
  g_grid_bar = nullptr;
  return 0;
}
