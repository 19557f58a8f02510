// 2D dynamic-window copy, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of the 2D dynamic-slice DMA reproduction:
//   R  scripts/repro_2d_dma.py::kern
// which copies, per grid block (i, j), a window of an HBM array at the
// offsets x0 = clip(i R - 4, 0, X - W) and y0 = clip(j Ry - 4, 0, Y - Wy)
// into VMEM with pltpu.make_async_copy (start, then wait) and writes plane
// 0's (R, Ry) corner of it to out[0, i R + a, j Ry + b, :].
//
// Hopper's form of that DMA is a Tensor Memory Accelerator (TMA) copy with
// runtime coordinates. Only plane 0's (R, Ry) corner of the TPU's window
// reaches `out`, so only that is copied: one block per `rows` x rows of a
// window (i, j), whose one elected thread
//   - arms an mbarrier with the bytes it expects, then issues
//     cp.async.bulk.tensor.4d loads of the box (Zb, Ry, rows, 1) of a tiled
//     tensor map over `src` at (z, y0, x0 + a0, 0): make_async_copy.start;
//   - waits on the barrier's phase 0 (the block's only phase): .wait;
//   - fences the async proxy and stores the same boxes with
//     cp.async.bulk.tensor.4d to `out` at (z, j Ry, i R + a0, 0), commits
//     the bulk group and waits until shared memory has been read, before the
//     block exits.
// A box dimension holds at most 256 elements, so Z > 256 is copied as Z / Zb
// boxes along z (Zb divides Z). Modes, as the script's: MODE_2D one load per
// box; MODE_X the same with y0 = 0; MODE_LOOP one load per y row (box
// (Zb, 1, rows, 1) at y0 + b, and one store each). The TPU waits on each row
// copy before the next; here the rows' loads land in disjoint shared memory
// and complete on one barrier with one wait, which gives the same output.
//
// What bounds it on this card: the 2 MiB read and 2 MiB written at the
// script's shape, 1.25 us at 3.35 TB/s, against the launch's fixed cost of a
// few microseconds. The design spreads the copy over the whole card (256
// blocks of 8 KiB at the script's shape, two to an SM of the 132) and
// leaves the addresses to the TMA unit: no thread computes an address or
// holds a word. A block's load and its store do not overlap; many small
// blocks hide that latency (one x row a block copies 4 % faster than two).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { MODE_2D = 0, MODE_X = 1, MODE_LOOP = 2 };
constexpr int ALIGN = 128;  // a TMA box's shared-memory address, in bytes

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(s), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(b) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* smem,
                                             int c0, int c1, int c2, int c3) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(s), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// One block per `rows` x rows (blockIdx.x) of window column j (blockIdx.y).
// Shared memory: the barrier in the first ALIGN bytes, then one region of
// `region` bytes (a multiple of ALIGN) per box: Z / zb boxes along z, times
// Ry y rows in MODE_LOOP.
__global__ void __launch_bounds__(32) k_window_copy(
    const __grid_constant__ CUtensorMap src_map, const __grid_constant__ CUtensorMap out_map,
    int X, int Y, int Z, int W, int Wy, int R, int Ry, int rows, int zb, int region,
    int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (threadIdx.x != 0) return;
  unsigned char* smem = smem_raw + (-static_cast<unsigned>(
      __cvta_generic_to_shared(smem_raw)) & (ALIGN - 1));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + ALIGN;
  const int xr = blockIdx.x * rows, j = blockIdx.y;  // first output x row, window column
  const int i = xr / R, a0 = xr - i * R;
  const int x0 = min(max(i * R - 4, 0), X - W);
  const int y0 = (mode == MODE_X) ? 0 : min(max(j * Ry - 4, 0), Y - Wy);
  const int nz = Z / zb, ny = (mode == MODE_LOOP) ? Ry : 1;
  mbar_init(bar);
  mbar_expect_tx(bar, static_cast<unsigned>(rows) * Ry * Z * sizeof(float));
  for (int c = 0; c < nz; ++c)
    for (int b = 0; b < ny; ++b)
      tma_load_4d(stage + (c * ny + b) * region, &src_map, bar, c * zb, y0 + b, x0 + a0, 0);
  mbar_wait(bar, 0);
  fence_proxy_async();
  for (int c = 0; c < nz; ++c)
    for (int b = 0; b < ny; ++b)
      tma_store_4d(&out_map, stage + (c * ny + b) * region, c * zb, j * Ry + b, xr, 0);
  bulk_commit_and_wait_read();
}

// cuTensorMapEncodeTiled from libcuda, found through the runtime (no -lcuda).
cudaError_t encoder(PFN_cuTensorMapEncodeTiled* fn) {
  static PFN_cuTensorMapEncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A float32 (n3, n2, n1, n0) row-major tensor at `base` as a tiled 4D map
// with the box (b0, b1, b2, 1), innermost first.
CUresult encode(PFN_cuTensorMapEncodeTiled fn, CUtensorMap* map, const void* base,
                uint64_t n0, uint64_t n1, uint64_t n2, uint64_t n3, uint32_t b0,
                uint32_t b1, uint32_t b2) {
  const cuuint64_t dims[4] = {n0, n1, n2, n3};
  const cuuint64_t strides[3] = {n0 * 4, n0 * n1 * 4, n0 * n1 * n2 * 4};  // bytes, dims 1-3
  const cuuint32_t box[4] = {b0, b1, b2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Plain C interface (loaded with ctypes). `src` is float32 (N, X, Y, Z) and
// `out` float32 (1, X, Y, Z), both contiguous and 16-byte aligned; the grid
// is (X / rows, Y / Ry), each block copying `rows` x rows (rows divides R)
// as boxes of `zb` z values (zb divides Z, at most 256) into shared-memory
// regions of `region` bytes, `smem` bytes in all (the wrapper's plan).
// Launches on `stream` without synchronising. Returns 0, a launch or
// entry-point error (cudaError_t), or minus the CUresult of a failed
// cuTensorMapEncodeTiled.
extern "C" int jr_window_copy_f32(const void* src, void* out, int N, int X, int Y, int Z,
                                  int W, int Wy, int R, int Ry, int rows, int zb, int region,
                                  int smem, int mode, void* stream) {
  PFN_cuTensorMapEncodeTiled fn = nullptr;
  const cudaError_t e = encoder(&fn);
  if (e != cudaSuccess) return (int)e;
  const uint32_t box_y = (mode == MODE_LOOP) ? 1 : Ry;
  CUtensorMap src_map, out_map;
  CUresult r = encode(fn, &src_map, src, Z, Y, X, N, zb, box_y, rows);
  if (r != CUDA_SUCCESS) return -(int)r;
  r = encode(fn, &out_map, out, Z, Y, X, 1, zb, box_y, rows);
  if (r != CUDA_SUCCESS) return -(int)r;
  static int smem_allowed = 48 * 1024;  // raised once, when a plan first needs more
  if (smem > smem_allowed) {
    const cudaError_t a = cudaFuncSetAttribute(
        k_window_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return (int)a;
    smem_allowed = smem;
  }
  k_window_copy<<<dim3(X / rows, Y / Ry), 32, smem, (cudaStream_t)stream>>>(
      src_map, out_map, X, Y, Z, W, Wy, R, Ry, rows, zb, region, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
