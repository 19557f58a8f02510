// 2D visco-elastic (VE) compressible pseudo-transient chunk, hand-written for
// Hopper (sm_90a).
//
// Replaces the two TPU kernels of the linear VE Stokes solve (solve_ve):
//   B1  justrelax_tpu/ops/pallas_stokes.py::stokes_chunk_vmem
//   B4  justrelax_tpu/ops/pallas_stokes.py::stokes_chunk_blocked
// Both compute `nout` iterations of `_ve_iteration`; on this card one kernel
// family serves both (B4's temporal row blocking only existed because a TPU
// core's VMEM could not hold the grid past ~820^2).
//
// One iteration is two launches, one thread per point, in stream order:
//   1. cells + interior vertices (an (nx+1) x (ny+1) grid of threads): the
//      divergence, the pressure update and the normal stresses at the cell,
//      and the shear stress at the interior vertex. Both read only the OLD
//      velocities, so one launch updates them together, in place.
//   2. faces: the damped velocity update on the interior faces from the NEW
//      P / tau, then the free-slip ghosts, each written by the thread that
//      updates (or, on a boundary row, holds) the value it mirrors. Boundary
//      vertices of tau_xy and the boundary normal faces are never updated.
// Each formula keeps the array path's operation order
// (justrelax_tpu_torch/ops/stokes.py: compute_P, compute_tau_ve, compute_V),
// reading the chunk-invariant fields it reads (1/(K dt), 1/(G dt), Q/dt, P0,
// eta, eta_tau, the old stresses, rho g, and the vertex averages of eta and
// G), so that the kernel agrees with its plain version to rounding. The TPU
// kernel's collocated canvas, jnp.roll + iota bands and edge-padded
// coefficient canvases become index arithmetic on the solver's own staggered
// arrays. 1/(G dt) = 0 for G = inf and Q/dt = 0 for dt = inf come from the
// host in IEEE arithmetic (no fast-math).
//
// What bounds it on this card: device-memory traffic. The iteration's own
// accounting (justrelax_tpu/utils/bench_kernels.py::ve2d) is 23 words per
// cell (12 unknown words read and written, 11 read-only); the two launches
// move more (~32: the face launch re-reads P, tau and eta_tau, and the
// invariant fields are re-read every iteration), and at 1024^2 one
// iteration's fields are far past the 50 MB L2. Left for later: fusing the
// two launches, and temporal blocking in shared memory (k iterations per
// tile with a 2k-row halo, the Hopper form of B4's row blocking).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Slot order of the invariant stacks (ops/hopper_stokes.py CELL_SLOTS /
// VERTEX_SLOTS).
enum CSlot { C_ETA, C_ETAT, C_GDT, C_KDT, C_P0, C_QDT, C_TXX_O, C_TYY_O,
             C_RHO_GX, C_RHO_GY };
enum VSlot { V_ETA, V_GDT, V_TXY_O };

template <typename T> struct Scal {
  T inv_dx, inv_dy, r_over_theta, theta_dtau, etadtau;
};

template <typename T> struct Fields {
  T *Vx, *Vy, *P, *txx, *tyy, *txy;
  const T *cinv, *vinv;
  int nx, ny;
};

// d(tau) = dtau_r * (2 eta eps - (tau - tau_o) eta/(G dt) - tau)
template <typename T>
__device__ __forceinline__ T stress_inc(T tau, T tau_o, T e, T eta, T Gdt,
                                        T dr) {
  return dr * (T(2) * eta * e - (tau - tau_o) * eta * Gdt - tau);
}

// ---- 1. cells (P, tau_xx, tau_yy) and interior vertices (tau_xy)
template <typename T>
__global__ void __launch_bounds__(256) k_cells_vertices(Fields<T> f,
                                                        Scal<T> s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  if (i > nx || j > ny) return;
  const int64_t sx = ny + 2, sy = ny + 1;

  if (i < nx && j < ny) {
    const int64_t N = (int64_t)nx * ny;
    const int64_t c = (int64_t)i * ny + j;
    const T* ci = f.cinv;
    const T dVxdx = (f.Vx[(i + 1) * sx + j + 1] - f.Vx[i * sx + j + 1]) * s.inv_dx;
    const T dVydy = (f.Vy[(i + 1) * sy + j + 1] - f.Vy[(i + 1) * sy + j]) * s.inv_dy;
    const T gv = dVxdx + dVydy;

    // compute_P: psi from eta_tau, (P0/(K dt) + rhs) psi + P over 1 + psi/(K dt)
    const T Kdt = ci[C_KDT * N + c];
    const T Gdt = ci[C_GDT * N + c];
    const T rhs = -gv + ci[C_QDT * N + c];
    const T psi = T(1) / (T(1) / ci[C_ETAT * N + c] + Gdt) * s.r_over_theta;
    f.P[c] = ((ci[C_P0 * N + c] * Kdt + rhs) * psi + f.P[c]) / (T(1) + Kdt * psi);

    // compute_tau_ve at the cell
    const T third = T(1.0 / 3.0);
    const T exx = dVxdx - gv * third;
    const T eyy = dVydy - gv * third;
    const T eta = ci[C_ETA * N + c];
    const T dtau_r = T(1) / (s.theta_dtau + eta * Gdt + T(1));
    const T txx = f.txx[c], tyy = f.tyy[c];
    f.txx[c] = txx + stress_inc(txx, ci[C_TXX_O * N + c], exx, eta, Gdt, dtau_r);
    f.tyy[c] = tyy + stress_inc(tyy, ci[C_TYY_O * N + c], eyy, eta, Gdt, dtau_r);
  }

  if (i >= 1 && i <= nx - 1 && j >= 1 && j <= ny - 1) {
    const int64_t NV = (int64_t)(nx + 1) * (ny + 1);
    const int64_t v = (int64_t)i * (ny + 1) + j;
    const T* vi = f.vinv;
    const T exy = T(0.5) * ((f.Vx[i * sx + j + 1] - f.Vx[i * sx + j]) * s.inv_dy +
                            (f.Vy[(i + 1) * sy + j] - f.Vy[i * sy + j]) * s.inv_dx);
    const T eta_v = vi[V_ETA * NV + v];
    const T Gdt_v = vi[V_GDT * NV + v];
    const T dtau_rv = T(1) / (s.theta_dtau + eta_v * Gdt_v + T(1));
    const T txy = f.txy[v];
    f.txy[v] = txy + stress_inc(txy, vi[V_TXY_O * NV + v], exy, eta_v, Gdt_v, dtau_rv);
  }
}

// ---- 2. faces: damped velocity update, then the free-slip ghosts
template <typename T>
__global__ void __launch_bounds__(256) k_faces(Fields<T> f, Scal<T> s,
                                               int free_slip) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  const int64_t N = (int64_t)nx * ny;
  const int64_t sx = ny + 2, sy = ny + 1, nv = ny + 1;
  const T* etat = f.cinv + C_ETAT * N;
  const T* rgx = f.cinv + C_RHO_GX * N;
  const T* rgy = f.cinv + C_RHO_GY * N;

  // Vx (nx+1, ny+2): interior faces i = 1..nx-1, j = 1..ny; ghost columns
  // 0 and ny+1 mirror columns 1 and ny on every face row 0..nx
  if (i <= nx && j >= 1 && j <= ny) {
    T* vx = f.Vx + i * sx + j;
    T val = *vx;
    if (i >= 1 && i <= nx - 1) {
      const int64_t a = (int64_t)(i - 1) * ny + (j - 1), b = a + ny;
      const T rx = (f.txx[b] - f.txx[a]) * s.inv_dx +
                   (f.txy[i * nv + j] - f.txy[i * nv + j - 1]) * s.inv_dy -
                   (f.P[b] - f.P[a]) * s.inv_dx - T(0.5) * (rgx[b] + rgx[a]);
      const T etax = T(0.5) * (etat[b] + etat[a]);
      val = val + rx * s.etadtau / etax;
      *vx = val;
    }
    if (free_slip) {
      if (j == 1) vx[-1] = val;
      if (j == ny) vx[1] = val;
    }
  }
  // Vy (nx+2, ny+1): interior faces i = 1..nx, j = 1..ny-1; ghost rows 0 and
  // nx+1 mirror rows 1 and nx on every column 0..ny
  if (i >= 1 && i <= nx && j <= ny) {
    T* vy = f.Vy + i * sy + j;
    T val = *vy;
    if (j >= 1 && j <= ny - 1) {
      const int64_t a = (int64_t)(i - 1) * ny + (j - 1), b = a + 1;
      const T ry = (f.tyy[b] - f.tyy[a]) * s.inv_dy +
                   (f.txy[i * nv + j] - f.txy[(i - 1) * nv + j]) * s.inv_dx -
                   (f.P[b] - f.P[a]) * s.inv_dy - T(0.5) * (rgy[b] + rgy[a]);
      const T etay = T(0.5) * (etat[b] + etat[a]);
      val = val + ry * s.etadtau / etay;
      *vy = val;
    }
    if (free_slip) {
      if (i == 1) vy[-sy] = val;
      if (i == nx) vy[sy] = val;
    }
  }
}

template <typename T>
int run_chunk(void** carry, const void* cinv, const void* vinv, int nx, int ny,
              int nout, const double* sc, int free_slip, cudaStream_t stream) {
  Fields<T> f;
  T** c = reinterpret_cast<T**>(carry);
  f.Vx = c[0]; f.Vy = c[1]; f.P = c[2]; f.txx = c[3]; f.tyy = c[4];
  f.txy = c[5];
  f.cinv = static_cast<const T*>(cinv);
  f.vinv = static_cast<const T*>(vinv);
  f.nx = nx; f.ny = ny;

  Scal<T> s;
  s.inv_dx = T(sc[0]); s.inv_dy = T(sc[1]); s.r_over_theta = T(sc[2]);
  s.theta_dtau = T(sc[3]); s.etadtau = T(sc[4]);

  const dim3 blk(32, 8);
  const dim3 g_vert((ny + 1 + 31) / 32, (nx + 1 + 7) / 8);
  const dim3 g_face((ny + 2 + 31) / 32, (nx + 2 + 7) / 8);
  for (int it = 0; it < nout; ++it) {
    k_cells_vertices<T><<<g_vert, blk, 0, stream>>>(f, s);
    k_faces<T><<<g_face, blk, 0, stream>>>(f, s, free_slip);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). `carry` holds the 6 fields in the
// order Vx, Vy, P, txx, tyy, txy, updated in place; `cinv` the (10, nx, ny)
// and `vinv` the (3, nx+1, ny+1) invariant stacks; `scal` inv_dx, inv_dy,
// r/theta_dtau, theta_dtau, etadtau. Launches on `stream` without
// synchronising; returns the first launch error, or 0.
extern "C" int jr_stokes_ve_chunk_f32(void** carry, const void* cinv,
                                      const void* vinv, int nx, int ny,
                                      int nout, const double* scal,
                                      int free_slip, void* stream) {
  return run_chunk<float>(carry, cinv, vinv, nx, ny, nout, scal, free_slip,
                          (cudaStream_t)stream);
}

extern "C" int jr_stokes_ve_chunk_f64(void** carry, const void* cinv,
                                      const void* vinv, int nx, int ny,
                                      int nout, const double* scal,
                                      int free_slip, void* stream) {
  return run_chunk<double>(carry, cinv, vinv, nx, ny, nout, scal, free_slip,
                           (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
