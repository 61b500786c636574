// CPU emulation of the CUDA subset the port's kernels use (csrc/emu/emulate.py).
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <climits>
#include <algorithm>
#include <functional>
using std::max; using std::min;
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<char> g_dyn_smem;
inline size_t g_smem_bytes = 0;
inline unsigned g_grid = 1, g_block = 1;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { memset(p, v, n); return 0; }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
// warp collectives emulated with block barriers (every thread must call)
inline int g_warp_slots[1024];
inline int __reduce_add_sync(unsigned, int v) {
  int t = threadIdx.x; g_warp_slots[t] = v; __syncthreads();
  int base = t & ~31, s = 0;
  for (int i = base; i < base + 32 && i < (int)blockDim.x; ++i) s += g_warp_slots[i];
  __syncthreads();
  return s;
}
inline int __syncthreads_or(int v) {
  g_warp_slots[threadIdx.x] = v; __syncthreads();
  int any = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) any |= g_warp_slots[i];
  __syncthreads();
  return any != 0;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class T> T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
template <class T> T atomicOr(T* p, T v) { return std::atomic_ref<T>(*p).fetch_or(v); }
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
inline void* mock_dyn_smem() { return g_dyn_smem.data(); }
inline int mock_cfg(unsigned grid, unsigned block, size_t smem = 0, cudaStream_t = nullptr) {
  g_grid = grid; g_block = block; g_smem_bytes = smem; return 0;
}
template <class F, class... A> void mock_launch(F f, A... args) {
  unsigned grid = g_grid, block = g_block;
  if (grid == 0 || block == 0) return;
  gridDim = dim3(grid); blockDim = dim3(block);
  g_dyn_smem.assign(g_smem_bytes + 16, 0);
  std::barrier<> bar(block);
  g_bar = &bar;
  std::vector<std::thread> ts;
  ts.reserve(block);
  for (unsigned t = 0; t < block; ++t) {
    ts.emplace_back([&, t]() {
      threadIdx = dim3(t);
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx = dim3(b);
        f(args...);
        bar.arrive_and_wait();  // block boundary
      }
    });
  }
  for (auto& th : ts) th.join();
}
