// Host emulation of the CUDA subset that the port's tiled kernels use, so
// that their sources run on a CPU in tests/test_torch_kernel_emulation.py:
// a block's threads are std::threads that meet at a std::barrier for
// __syncthreads (every thread of a block must reach the same barriers, as
// the kernels here do), and the blocks of a grid of up to three dimensions
// run one after another on that pool; shared memory starts each block as
// NaN bytes, so a read of a point no phase wrote shows in the result. The test rewrites the launches
// (kernel<<<grid, block, smem, stream>>>(...) becomes emu_launch(kernel,
// grid, block, smem, stream, ...)), the dynamic shared-memory declaration
// and the cp.async helpers (commit, wait and copy: a plain copy, so staging
// is complete when it is issued). The rounded intrinsics are the host's IEEE
// operations.
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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 0, cudaDevAttrMultiProcessorCount = 16 };
typedef void* cudaStream_t;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
// an emulated card of 4 SMs, one resident block each
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 4; return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
using std::isinf;
using std::max;
using std::min;

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  // one pool of threads runs the blocks one after another; shared memory is
  // refilled with NaN bytes before each block
  const int threads = block.x * block.y * block.z;
  const unsigned blocks = grid.x * grid.y * grid.z;
  std::vector<unsigned char> shared(smem + 16);
  std::barrier<> barrier(threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
      blockDim = block;
      emu_smem = shared.data();
      emu_barrier = &barrier;
      for (unsigned b = 0; b < blocks; ++b) {
        blockIdx = dim3(b % grid.x, (b / grid.x) % grid.y, b / (grid.x * grid.y));
        if (t == 0) std::fill(shared.begin(), shared.end(), 0xFF);
        barrier.arrive_and_wait();
        kernel(args...);
        barrier.arrive_and_wait();
      }
    });
  for (auto& th : pool) th.join();
}
