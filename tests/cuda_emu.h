// Host emulation of the CUDA subset that the port's tiled 2D kernels use, so
// that their sources run on a CPU in tests/test_torch_kernel_emulation.py:
// each block runs its threads as std::threads that meet at a std::barrier
// for __syncthreads, one block after another; shared memory starts as NaN
// bytes, so a read of a point no phase wrote shows in the result. The
// test rewrites the launches (kernel<<<grid, threads, smem, stream>>>(...)
// becomes emu_launch(kernel, grid, threads, smem, stream, ...)), the dynamic
// shared-memory declaration and the cp.async helpers.
#pragma once
#include <algorithm>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline thread_local dim3 blockIdx, threadIdx, blockDim;
inline thread_local unsigned char* emu_smem;
inline thread_local std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
typedef void* cudaStream_t;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
using std::isinf;
using std::max;
using std::min;

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<unsigned char> shared(smem + 16, 0xFF);
      std::barrier<> barrier(threads);
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          blockIdx = dim3(bx, by);
          threadIdx = dim3(t);
          blockDim = dim3(threads);
          emu_smem = shared.data();
          emu_barrier = &barrier;
          kernel(args...);
        });
      for (auto& th : pool) th.join();
    }
}
