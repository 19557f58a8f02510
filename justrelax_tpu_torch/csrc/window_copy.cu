// 2D dynamic-window copy, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of the 2D dynamic-slice DMA reproduction:
//   R  scripts/repro_2d_dma.py::kern
// which copies, per grid block (i, j), a window of an HBM array at the
// offsets x0 = clip(i R - 4, 0, X - W) and y0 = clip(j Ry - 4, 0, Y - Wy)
// into VMEM with pltpu.make_async_copy (start, then wait) and writes plane
// 0's (R, Ry) corner of it to out[0, i R + a, j Ry + b, :].
//
// Here one block per (i, j) window computes x0 / y0 from blockIdx and stages
// the rows that reach `out` through shared memory with cp.async (16-byte
// pieces, then cp.async.wait_all): Hopper's form of make_async_copy / start /
// wait. The TPU scratch held the whole window, all N planes (2.6 MB in "2d"
// mode, far past a block's 227 KB); only plane 0's (R, Ry) corner of it
// reaches `out`, so only that is staged, as many x rows (Ry rows of Z each)
// per step as fit in 96 KB: 12 of the script's 32, three steps a block.
// Modes, as the script's: MODE_2D one copy of the row's window, MODE_X the
// same with no y offset, MODE_LOOP one copy (and wait) per y row.
//
// What bounds it on this card: the launch. The copy moves 2 MiB in and 2 MiB
// out at the script's shape (1.25 us at 3.35 TB/s); a launch of 8 blocks
// costs several microseconds. A TMA copy with two runtime coordinates would
// be the closer analogue of the faulting DMA; it is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { MODE_2D = 0, MODE_X = 1, MODE_LOOP = 2 };
constexpr size_t STAGE_BYTES = 96 * 1024;  // shared memory staged per step

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block per window (blockIdx.x = i, blockIdx.y = j). `stage` holds up
// to `rows` x rows of Ry * Z floats; Z is a multiple of 4 (16-byte pieces).
__global__ void __launch_bounds__(256) k_window_copy(
    const float* __restrict__ src, float* __restrict__ out, int Y, int Z,
    int X, int W, int Wy, int R, int Ry, int rows, int mode) {
  extern __shared__ __align__(16) float stage[];
  const int i = blockIdx.x, j = blockIdx.y;
  const int x0 = min(max(i * R - 4, 0), X - W);
  const int y0 = (mode == MODE_X) ? 0 : min(max(j * Ry - 4, 0), Y - Wy);
  const int pieces = Z / 4;       // per (x, y) row
  const int per_a = Ry * pieces;  // per x row
  for (int a0 = 0; a0 < R; a0 += rows) {
    const int na = min(rows, R - a0);
    const float* base = src + ((int64_t)(x0 + a0) * Y + y0) * Z;  // plane 0
    if (mode == MODE_LOOP) {  // one copy, and its wait, per y row
      for (int b = 0; b < Ry; ++b) {
        for (int p = threadIdx.x; p < na * pieces; p += blockDim.x) {
          const int a = p / pieces, k = p - a * pieces;
          cp_async16(stage + (a * Ry + b) * Z + 4 * k,
                     base + ((int64_t)a * Y + b) * Z + 4 * k);
        }
        cp_async_commit();
        cp_async_wait_all();
      }
    } else {  // one copy of the rows' window
      for (int p = threadIdx.x; p < na * per_a; p += blockDim.x) {
        const int a = p / per_a, k = p - a * per_a;
        cp_async16(stage + 4 * p, base + (int64_t)a * Y * Z + 4 * k);
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    const float4* st = reinterpret_cast<const float4*>(stage);
    for (int p = threadIdx.x; p < na * per_a; p += blockDim.x) {
      const int a = p / per_a, k = p - a * per_a;
      reinterpret_cast<float4*>(
          out + ((int64_t)(i * R + a0 + a) * Y + j * Ry) * Z)[k] = st[p];
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). `src` is float32 (N, X, Y, Z) and
// `out` float32 (1, X, Y, Z), both contiguous; the grid is (X / R, Y / Ry).
// Launches on `stream` without synchronising; returns the launch error, or 0.
extern "C" int jr_window_copy_f32(const void* src, void* out, int X, int Y,
                                  int Z, int W, int Wy, int R, int Ry,
                                  int mode, void* stream) {
  // as many x rows per staging step as fit in STAGE_BYTES (at least one)
  const size_t row_bytes = (size_t)Ry * Z * sizeof(float);
  const size_t fit = STAGE_BYTES / row_bytes;
  const int rows = fit < 1 ? 1 : (fit > (size_t)R ? R : (int)fit);
  const size_t smem = rows * row_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      k_window_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(X / R, Y / Ry);
  k_window_copy<<<grid, 256, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(src), static_cast<float*>(out), Y, Z, X, W, Wy,
      R, Ry, rows, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
