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
// operations. The Tensor Memory Accelerator: cuTensorMapEncodeTiled (reached
// through cudaGetDriverEntryPointByVersion) checks its arguments as CUDA's
// documentation gives them and fills an emulated CUtensorMap (base, dims, byte
// strides, box); a TMA load or store is a plain strided copy of the box
// (emu_tma_4d), an mbarrier counts arrivals and transaction bytes
// (emu_mbar_*), and a wait that would not complete on the card, a box that
// lands outside the block's shared memory or off 128 bytes, counts a fault
// that emu_fault_count() returns.
#pragma once
#include <algorithm>
#include <atomic>
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
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline thread_local dim3 blockIdx, threadIdx, blockDim;
inline thread_local unsigned char* emu_smem;
inline thread_local size_t emu_smem_bytes;  // the launch's dynamic shared memory
inline thread_local std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 0, cudaDevAttrMultiProcessorCount = 16 };
typedef void* cudaStream_t;
inline uintptr_t __cvta_generic_to_shared(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
// an emulated card of 4 SMs, one resident block each
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 4; return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }

// ---- the Tensor Memory Accelerator
#define CUDART_VERSION 12080
typedef int CUresult;
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1, cudaErrorSymbolNotFound = 500 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0,
                                       cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
struct CUtensorMap {
  unsigned char* base;
  unsigned rank;
  uint64_t dims[5], strides[5];  // strides in bytes; strides[0] is the element's size
  uint32_t box[5];
};
inline std::atomic<int> emu_faults{0};
extern "C" int emu_fault_count() { return emu_faults.load(); }
inline void emu_fault(bool bad) {
  if (bad) ++emu_faults;
}

// the documented checks of a tiled, non-interleaved, unswizzled float32 map
inline CUresult cuTensorMapEncodeTiled(
    CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank, void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* elem, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_FLOAT32 || rank < 1 || rank > 5 ||
      reinterpret_cast<uintptr_t>(base) % 16 || (box[0] * 4) % 16)
    return CUDA_ERROR_INVALID_VALUE;
  for (unsigned d = 0; d < rank; ++d) {
    if (dims[d] == 0 || dims[d] > (1ull << 32) || box[d] == 0 || box[d] > 256 ||
        elem[d] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    if (d > 0 && (strides[d - 1] % 16 || strides[d - 1] >= (1ull << 40)))
      return CUDA_ERROR_INVALID_VALUE;
  }
  m->base = static_cast<unsigned char*>(base);
  m->rank = rank;
  for (unsigned d = 0; d < rank; ++d) {
    m->dims[d] = dims[d];
    m->strides[d] = d == 0 ? 4 : strides[d - 1];
    m->box[d] = box[d];
  }
  return CUDA_SUCCESS;
}
typedef CUresult (*PFN_cuTensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline int cudaGetDriverEntryPointByVersion(const char* name, void** fn, unsigned, int,
                                            cudaDriverEntryPointQueryResult* q) {
  const bool found = std::strcmp(name, "cuTensorMapEncodeTiled") == 0;
  *fn = found ? reinterpret_cast<void*>(&cuTensorMapEncodeTiled) : nullptr;
  *q = found ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return 0;
}

// An mbarrier's 8 bytes: arrivals still expected (high 32 bits) and
// transaction bytes still expected (low 32 bits, signed).
inline void emu_mbar_init(uint64_t* bar, unsigned count) { *bar = uint64_t(count) << 32; }
inline void emu_mbar_add(uint64_t* bar, int arrivals, int64_t bytes) {
  const int64_t a = int64_t(*bar >> 32) + arrivals;
  const int64_t tx = int64_t(int32_t(uint32_t(*bar))) + bytes;
  *bar = (uint64_t(a) << 32) | uint32_t(int32_t(tx));
}
// a wait on phase 0 completes once every arrival and byte has come
inline void emu_mbar_wait(uint64_t* bar, unsigned parity) { emu_fault(parity != 0 || *bar != 0); }

// A TMA copy of the 4D box at (c0, c1, c2, c3) between `smem` (dense,
// innermost first) and the map's tensor: a load fills what lies outside the
// tensor with zeros and completes its bytes on `bar`; a store skips it.
inline void emu_tma_4d(void* smem, const CUtensorMap* m, uint64_t* bar, int c0, int c1,
                       int c2, int c3) {
  unsigned char* s = static_cast<unsigned char*>(smem);
  const uint64_t bytes = uint64_t(m->box[0]) * m->box[1] * m->box[2] * m->box[3] * 4;
  emu_fault(m->rank != 4 || reinterpret_cast<uintptr_t>(s) % 128 || s < emu_smem ||
            s + bytes > emu_smem + emu_smem_bytes);
  if (m->rank != 4 || s < emu_smem || s + bytes > emu_smem + emu_smem_bytes) return;
  const int64_t c[4] = {c0, c1, c2, c3};
  int64_t k[4];
  for (k[3] = 0; k[3] < m->box[3]; ++k[3])
    for (k[2] = 0; k[2] < m->box[2]; ++k[2])
      for (k[1] = 0; k[1] < m->box[1]; ++k[1])
        for (k[0] = 0; k[0] < m->box[0]; ++k[0]) {
          bool in = true;
          int64_t off = 0;
          for (int d = 0; d < 4; ++d) {
            const int64_t g = c[d] + k[d];
            in = in && g >= 0 && g < int64_t(m->dims[d]);
            off += g * int64_t(m->strides[d]);
          }
          unsigned char* sp = s + (((k[3] * m->box[2] + k[2]) * m->box[1] + k[1]) *
                                   m->box[0] + k[0]) * 4;
          if (bar && in) std::memcpy(sp, m->base + off, 4);
          else if (bar) std::memset(sp, 0, 4);
          else if (in) std::memcpy(m->base + off, sp, 4);
        }
  if (bar) emu_mbar_add(bar, 0, -int64_t(bytes));
}
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
      emu_smem_bytes = smem;
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
