// 2D pseudo-transient (PT) thermal diffusion chunk, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the constant-coefficient thermal solve
// (heatdiffusion_PT with K and rho_Cp tensors):
//   B5  justrelax_tpu/ops/pallas_thermal.py::thermal_chunk_vmem
// It computes `nout` iterations of the array path
// (justrelax_tpu_torch/ops/thermal.py: compute_flux, update_T, then
// ops/bc.py::thermal_bcs), adiabatic term included.
//
// One iteration is two launches, one thread per point, in stream order:
//   1. faces (an (nx+1) x (ny+1) grid of threads): the flux relaxation
//      q = (q*theta_f + (-K_f*dT)) / (1 + theta_f) on every x- and y-face,
//      boundary faces included. It reads only the OLD T, ghosts included.
//   2. cells (nx x ny): the damped implicit update
//      T = (dtau_rho*((-div q + Told*rhoCp*inv_dt) + src) + T) / den,
//      src = H_tot + adiabatic*T, from the NEW fluxes; then the ghost BCs.
//      thermal_bcs writes whole ghost lines face by face (constant_value over
//      bot, top, left, right, then no_flux in the same order), so an edge
//      ghost is the last active pass of its face applied to the new interior
//      value beside it, and each is written by the thread of that interior
//      cell. A corner ghost depends on the order: the thread of the interior
//      corner cell owns the corner and the two edge ghosts beside it, and
//      replays the passes of its two faces in order on that 2x2 patch. No
//      thread of launch 2 reads a ghost, so no third launch is needed.
// Each formula keeps the array path's operation order, reading what that
// path derives from its inputs each iteration from chunk-invariant stacks
// (face averages of theta_r_dtau and K; Told*rhoCp*inv_dt and
// 1 + dtau_rho*rhoCp*inv_dt), so the kernel agrees with its plain version
// to rounding (FMA contraction aside). B5's coefficient form, its canvas
// padding, jnp.roll and iota bands become index arithmetic on the solver's
// own arrays.
//
// What bounds it on this card: device-memory traffic. The compulsory traffic
// of one iteration is 12 words per cell: T, qx and qy read and written (6),
// and six chunk-invariant cell inputs read once (theta, K, dtau_rho and the
// three terms of the T update). The two launches move more (~17: the face
// averages are four face arrays, the update re-reads both fluxes and the
// stacks every iteration), and at 1024^2 f32 one iteration's fields
// (~70 MB) exceed the 50 MB L2. Left for later: fusing the two launches,
// and temporal blocking in shared memory (k iterations per tile with a
// k-cell halo).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Slot order of the invariant stacks (ops/hopper_thermal.py CELL_SLOTS /
// FACE_SLOTS).
enum CSlot { C_DTAU, C_TOLD, C_HTOT, C_DEN };
enum FSlot { F_THETA, F_K };
// Faces in thermal_bcs order; a pass k of the recipe acts on face k % 4.
enum Face { BOT, TOP, LEFT, RIGHT };
enum Code { NONE = 0, CONSTANT_VALUE = 1, NO_FLUX = 2 };

template <typename T> struct Bc {
  int code[8];  // constant_value then no_flux passes, faces in Face order
  T two_v[4];   // 2 * constant value per face
};

template <typename T> struct Fields {
  T *T_, *qx, *qy;
  const T *cinv, *fx, *fy, *ad;
  int nx, ny;
};

// One BC pass of face f applied to the interior value x.
template <typename T>
__device__ __forceinline__ T pass_op(const Bc<T>& bc, int k, T x) {
  return bc.code[k] == CONSTANT_VALUE ? bc.two_v[k & 3] - x : x;
}

// An edge ghost: the last active pass of face f on the interior value t, or
// the ghost as it was if face f has none.
template <typename T>
__device__ __forceinline__ T edge_ghost(const Bc<T>& bc, int f, T t, T old) {
  T g = old;
  for (int k = f; k < 8; k += 4)
    if (bc.code[k] != NONE) g = pass_op(bc, k, t);
  return g;
}

// ---- 1. faces: flux relaxation from the old T
template <typename T>
__global__ void __launch_bounds__(256) k_flux(Fields<T> f, T inv_dx, T inv_dy) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  if (i > nx || j > ny) return;
  const int64_t sT = ny + 2;
  if (j < ny) {  // x-face (i, j), (nx+1, ny)
    const int64_t NX = (int64_t)(nx + 1) * ny;
    const int64_t q = (int64_t)i * ny + j;
    const T th = f.fx[F_THETA * NX + q];
    const T dT = (f.T_[(i + 1) * sT + j + 1] - f.T_[i * sT + j + 1]) * inv_dx;
    const T phys = -f.fx[F_K * NX + q] * dT;
    f.qx[q] = (f.qx[q] * th + phys) / (T(1) + th);
  }
  if (i < nx) {  // y-face (i, j), (nx, ny+1)
    const int64_t NY = (int64_t)nx * (ny + 1);
    const int64_t q = (int64_t)i * (ny + 1) + j;
    const T th = f.fy[F_THETA * NY + q];
    const T dT = (f.T_[(i + 1) * sT + j + 1] - f.T_[(i + 1) * sT + j]) * inv_dy;
    const T phys = -f.fy[F_K * NY + q] * dT;
    f.qy[q] = (f.qy[q] * th + phys) / (T(1) + th);
  }
}

// ---- 2. cells: damped implicit T update, then the ghosts the cell owns
template <typename T>
__global__ void __launch_bounds__(256) k_update(Fields<T> f, T inv_dx, T inv_dy,
                                                Bc<T> bc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  if (i >= nx || j >= ny) return;
  const int64_t N = (int64_t)nx * ny;
  const int64_t c = (int64_t)i * ny + j;
  const int64_t sT = ny + 2;
  T* Tg = f.T_;
  const int64_t t = (i + 1) * sT + j + 1;

  const T divq = (f.qx[c + ny] - f.qx[c]) * inv_dx +
                 (f.qy[i * (int64_t)(ny + 1) + j + 1] - f.qy[i * (int64_t)(ny + 1) + j]) * inv_dy;
  const T Tin = Tg[t];
  T src = f.cinv[C_HTOT * N + c];
  if (f.ad) src = src + f.ad[c] * Tin;
  const T num = f.cinv[C_DTAU * N + c] * (-divq + f.cinv[C_TOLD * N + c] + src) + Tin;
  const T Tn = num / f.cinv[C_DEN * N + c];

  // Ghost neighbours of this cell: x-side (left/right) at row j+1, y-side
  // (bot/top) at column i+1. A corner cell also owns the corner ghost.
  const int fx_side = i == 0 ? LEFT : (i == nx - 1 ? RIGHT : -1);
  const int fy_side = j == 0 ? BOT : (j == ny - 1 ? TOP : -1);
  const int64_t gx = fx_side < 0 ? -1 : (fx_side == LEFT ? j + 1 : (nx + 1) * sT + j + 1);
  const int64_t gy = fy_side < 0 ? -1 : (fy_side == BOT ? (i + 1) * sT : (i + 1) * sT + ny + 1);
  if (fx_side >= 0 && fy_side >= 0) {
    // replay the passes of the two faces in thermal_bcs order on the patch
    // (corner, x-ghost, y-ghost): a y-face pass writes the corner from the
    // x-ghost and the y-ghost from Tn; an x-face pass the corner from the
    // y-ghost and the x-ghost from Tn
    const int64_t cg = (fx_side == LEFT ? 0 : (nx + 1) * sT) + (fy_side == BOT ? 0 : ny + 1);
    T vc = Tg[cg], vx = Tg[gx], vy = Tg[gy];
    for (int k = 0; k < 8; ++k) {
      if (bc.code[k] == NONE) continue;
      const int face = k & 3;
      if (face == fy_side) {
        vc = pass_op(bc, k, vx);
        vy = pass_op(bc, k, Tn);
      } else if (face == fx_side) {
        vc = pass_op(bc, k, vy);
        vx = pass_op(bc, k, Tn);
      }
    }
    Tg[cg] = vc;
    Tg[gx] = vx;
    Tg[gy] = vy;
  } else if (fx_side >= 0) {
    Tg[gx] = edge_ghost(bc, fx_side, Tn, Tg[gx]);
  } else if (fy_side >= 0) {
    Tg[gy] = edge_ghost(bc, fy_side, Tn, Tg[gy]);
  }
  Tg[t] = Tn;
}

template <typename T>
int run_chunk(void** carry, const void* cinv, const void* fx, const void* fy,
              const void* ad, int nx, int ny, int nout, const double* sc,
              const int* recipe, cudaStream_t stream) {
  Fields<T> f;
  T** c = reinterpret_cast<T**>(carry);
  f.T_ = c[0]; f.qx = c[1]; f.qy = c[2];
  f.cinv = static_cast<const T*>(cinv);
  f.fx = static_cast<const T*>(fx);
  f.fy = static_cast<const T*>(fy);
  f.ad = static_cast<const T*>(ad);
  f.nx = nx; f.ny = ny;
  const T inv_dx = T(sc[0]), inv_dy = T(sc[1]);
  Bc<T> bc;
  for (int k = 0; k < 8; ++k) bc.code[k] = recipe[k];
  for (int k = 0; k < 4; ++k) bc.two_v[k] = T(sc[2 + k]);

  const dim3 blk(32, 8);
  const dim3 g_flux((ny + 1 + 31) / 32, (nx + 1 + 7) / 8);
  const dim3 g_cell((ny + 31) / 32, (nx + 7) / 8);
  for (int it = 0; it < nout; ++it) {
    k_flux<T><<<g_flux, blk, 0, stream>>>(f, inv_dx, inv_dy);
    k_update<T><<<g_cell, blk, 0, stream>>>(f, inv_dx, inv_dy, bc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). `carry` holds T (nx+2, ny+2), qx
// (nx+1, ny) and qy (nx, ny+1), updated in place; `cinv` the (4, nx, ny)
// cell stack, `fx`/`fy` the (2, nx+1, ny) / (2, nx, ny+1) face stacks; `ad`
// the (nx, ny) adiabatic field or NULL; `scal` inv_dx, inv_dy and 2*value of
// the constant_value faces (bot, top, left, right); `recipe` one code per
// pass and face in thermal_bcs order (0 none, 1 constant_value, 2 no_flux).
// Launches on `stream` without synchronising; returns the first launch
// error, or 0.
extern "C" int jr_thermal_chunk_f32(void** carry, const void* cinv, const void* fx,
                                    const void* fy, const void* ad, int nx, int ny,
                                    int nout, const double* scal, const int* recipe,
                                    void* stream) {
  return run_chunk<float>(carry, cinv, fx, fy, ad, nx, ny, nout, scal, recipe,
                          (cudaStream_t)stream);
}

extern "C" int jr_thermal_chunk_f64(void** carry, const void* cinv, const void* fx,
                                    const void* fy, const void* ad, int nx, int ny,
                                    int nout, const double* scal, const int* recipe,
                                    void* stream) {
  return run_chunk<double>(carry, cinv, fx, fy, ad, nx, ny, nout, scal, recipe,
                           (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
