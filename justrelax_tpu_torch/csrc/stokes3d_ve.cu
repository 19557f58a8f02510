// 3D visco-elastic (VE) compressible pseudo-transient chunk, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of the 3D VE Stokes solve (solve_ve_3d):
//   B7  justrelax_tpu/ops/pallas_stokes3d_blocked.py::stokes3d_chunk_blocked
// It computes `nout` iterations of the collocated-canvas iteration
// (justrelax_tpu_torch/ops/stokes3d_canvas.py::iteration3d_canvas) on the
// ten (nx+2, ny+2, nz+2) canvases Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy,
// with the chunk-invariant coefficients of that module:
//   P   <- P*c1 + c2 - grad_V*c3
//   tau <- a*tau + b*eps + d            (cells, and each edge family)
//   V   <- V + (div tau - grad P - f)*inv_eta      (interior faces)
// A coefficient is a canvas, a scalar (the viscous limit's decay a, or any
// canvas that holds one value), or absent (c1, c2, d in the viscous limit or
// where dt is infinite), chosen per call by a slot table that the wrapper
// builds; an absent term is left out of the expression, a scalar costs no
// traffic.
//
// One iteration is two launches, one thread per canvas point, z fastest:
//   1. cells and interior edges: divergence, pressure and normal stresses at
//      the cell, the three shear stresses on the interior edges that share
//      the cell's index. All read only the OLD velocities, so one launch
//      updates them together, in place.
//   2. faces: the damped velocity update on the interior faces from the NEW
//      P and tau, then the free-slip ghosts. The serial mirrors (front, back,
//      top, bot, left, right) compose to a closed form: every tangential
//      ghost equals the value at the clamped interior index, e.g.
//      Vx[a, b, c] <- Vx[a, clamp(b, 1, ny), clamp(c, 1, nz)], on every row
//      a, the normal-face rows the update leaves alone included. So the
//      thread that owns the value at the clamped index writes each ghost
//      that maps onto it; no thread reads a ghost, and the launch is
//      race-free.
// The TPU kernel's x-slab VMEM windows, DMA semaphores, choose_blocking_3d,
// 128-lane z padding and roll + iota masks have no counterpart: the canvas is
// the wrapper's layout, z contiguous, so one index serves every field and
// neighbouring threads read neighbouring addresses.
//
// What bounds it on this card: device-memory traffic. The iteration's own
// accounting (justrelax_tpu/utils/bench_kernels.py::ve3d) is 35 words per
// cell (20 unknown words read and written, 15 read-only inputs); where dt is
// infinite only eta, eta_tau and f of those remain, 25 words or fewer. The
// two launches move more: launch 1 reads 3 V, 7 P/tau and up to 20
// coefficient words and writes 7, launch 2 reads 3 + 7 + up to 6 and writes
// 3 (about 56 words in the general form, 38-41 with dt infinite), and at
// 126^3 one iteration's fields are several times the 50 MB L2. Left for later: fusing the two
// launches, temporal blocking in shared memory (k iterations per tile from a
// window with a halo of 2 per iteration on each axis), and deriving the
// viscous coefficients in the kernel from eta, eta_tau and f.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Coefficient order (ops/hopper_stokes3d.py COEF_NAMES).
enum Coef { K_C1, K_C2, K_C3, K_AC, K_BC, K_DC0, K_DC1, K_DC2,
            K_AE0, K_AE1, K_AE2, K_BE0, K_BE1, K_BE2, K_DE0, K_DE1, K_DE2,
            K_IE0, K_IE1, K_IE2, K_F0, K_F1, K_F2, N_COEF };
constexpr int ABSENT = -2;

template <typename T> struct Coefs {
  const T* base;       // (n_canvas, X, Y, Z) stack
  int slot[N_COEF];    // >= 0: canvas index in base; -1: scalar; ABSENT
  T val[N_COEF];       // the value of a scalar coefficient
};

template <typename T> struct Carry {
  T *Vx, *Vy, *Vz, *P, *txx, *tyy, *tzz, *tyz, *txz, *txy;
  int nx, ny, nz;
  int64_t sx, sy, n;   // strides of a and b; points per canvas
  T inv_dx, inv_dy, inv_dz;
};

template <typename T>
__device__ __forceinline__ T coef(const Coefs<T>& k, int id, int64_t i,
                                  int64_t n) {
  const int s = k.slot[id];
  return s >= 0 ? k.base[s * n + i] : k.val[id];
}

// t <- a*t + b*e (+ d)
template <typename T>
__device__ __forceinline__ void relax(T* t, int64_t i, T a, T b, T e,
                                      const Coefs<T>& k, int id_d, int64_t n) {
  T tn = a * t[i] + b * e;
  if (k.slot[id_d] != ABSENT) tn = tn + coef(k, id_d, i, n);
  t[i] = tn;
}

// ---- 1. cells (P, txx, tyy, tzz) and interior edges (tyz, txz, txy)
template <typename T>
__global__ void __launch_bounds__(256) k_cells_edges(Carry<T> q, Coefs<T> k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  const int a = blockIdx.z;
  const int nx = q.nx, ny = q.ny, nz = q.nz;
  if (a < 1 || a > nx || b < 1 || b > ny || c < 1 || c > nz) return;
  const int64_t n = q.n, sx = q.sx, sy = q.sy;
  const int64_t i = a * sx + b * sy + c;

  const T vx = q.Vx[i], vy = q.Vy[i], vz = q.Vz[i];
  const T dVxdx = (vx - q.Vx[i - sx]) * q.inv_dx;
  const T dVydy = (vy - q.Vy[i - sy]) * q.inv_dy;
  const T dVzdz = (vz - q.Vz[i - 1]) * q.inv_dz;
  const T gv = dVxdx + dVydy + dVzdz;

  T Pn = q.P[i];
  if (k.slot[K_C1] != ABSENT) Pn = Pn * coef(k, K_C1, i, n);
  if (k.slot[K_C2] != ABSENT) Pn = Pn + coef(k, K_C2, i, n);
  q.P[i] = Pn - gv * coef(k, K_C3, i, n);

  const T third = T(1.0 / 3.0);
  const T ac = coef(k, K_AC, i, n), bc = coef(k, K_BC, i, n);
  relax(q.txx, i, ac, bc, dVxdx - gv * third, k, K_DC0, n);
  relax(q.tyy, i, ac, bc, dVydy - gv * third, k, K_DC1, n);
  relax(q.tzz, i, ac, bc, dVzdz - gv * third, k, K_DC2, n);

  if (b < ny && c < nz) {
    const T e = T(0.5) * ((q.Vy[i + 1] - vy) * q.inv_dz + (q.Vz[i + sy] - vz) * q.inv_dy);
    relax(q.tyz, i, coef(k, K_AE0, i, n), coef(k, K_BE0, i, n), e, k, K_DE0, n);
  }
  if (a < nx && c < nz) {
    const T e = T(0.5) * ((q.Vx[i + 1] - vx) * q.inv_dz + (q.Vz[i + sx] - vz) * q.inv_dx);
    relax(q.txz, i, coef(k, K_AE1, i, n), coef(k, K_BE1, i, n), e, k, K_DE1, n);
  }
  if (a < nx && b < ny) {
    const T e = T(0.5) * ((q.Vx[i + sy] - vx) * q.inv_dy + (q.Vy[i + sx] - vy) * q.inv_dx);
    relax(q.txy, i, coef(k, K_AE2, i, n), coef(k, K_BE2, i, n), e, k, K_DE2, n);
  }
}

// Writes v into the ghosts that the clamp rule maps onto the owner slot i:
// lo/hi flag an owner on the first/last interior index of the two
// tangential axes, whose strides are s1 and s2.
template <typename T>
__device__ __forceinline__ void mirror(T* A, int64_t i, bool lo1, bool hi1,
                                       bool lo2, bool hi2, int64_t s1,
                                       int64_t s2, T v) {
  if (lo1) A[i - s1] = v;
  if (hi1) A[i + s1] = v;
  if (lo2) {
    A[i - s2] = v;
    if (lo1) A[i - s1 - s2] = v;
    if (hi1) A[i + s1 - s2] = v;
  }
  if (hi2) {
    A[i + s2] = v;
    if (lo1) A[i - s1 + s2] = v;
    if (hi1) A[i + s1 + s2] = v;
  }
}

// ---- 2. faces: damped velocity update, then the free-slip ghosts
template <typename T>
__global__ void __launch_bounds__(256) k_faces(Carry<T> q, Coefs<T> k,
                                               int free_slip) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  const int a = blockIdx.z;
  const int nx = q.nx, ny = q.ny, nz = q.nz;
  if (b > ny + 1 || c > nz + 1) return;
  const int64_t n = q.n, sx = q.sx, sy = q.sy;
  const int64_t i = a * sx + b * sy + c;
  const bool in_a = a >= 1 && a <= nx, in_b = b >= 1 && b <= ny,
             in_c = c >= 1 && c <= nz;

  // Vx: owner slots b in [1, ny], c in [1, nz] on every row a; the update
  // on the interior faces a in [1, nx-1]
  if (in_b && in_c) {
    T v = q.Vx[i];
    if (a >= 1 && a <= nx - 1) {
      const T r = (q.txx[i + sx] - q.txx[i]) * q.inv_dx +
                  (q.txy[i] - q.txy[i - sy]) * q.inv_dy +
                  (q.txz[i] - q.txz[i - 1]) * q.inv_dz -
                  (q.P[i + sx] - q.P[i]) * q.inv_dx - coef(k, K_F0, i, n);
      v = v + r * coef(k, K_IE0, i, n);
      q.Vx[i] = v;
    }
    if (free_slip) mirror(q.Vx, i, b == 1, b == ny, c == 1, c == nz, sy, (int64_t)1, v);
  }
  // Vy: owner slots a in [1, nx], c in [1, nz]; update b in [1, ny-1]
  if (in_a && in_c) {
    T v = q.Vy[i];
    if (b >= 1 && b <= ny - 1) {
      const T r = (q.txy[i] - q.txy[i - sx]) * q.inv_dx +
                  (q.tyy[i + sy] - q.tyy[i]) * q.inv_dy +
                  (q.tyz[i] - q.tyz[i - 1]) * q.inv_dz -
                  (q.P[i + sy] - q.P[i]) * q.inv_dy - coef(k, K_F1, i, n);
      v = v + r * coef(k, K_IE1, i, n);
      q.Vy[i] = v;
    }
    if (free_slip) mirror(q.Vy, i, a == 1, a == nx, c == 1, c == nz, sx, (int64_t)1, v);
  }
  // Vz: owner slots a in [1, nx], b in [1, ny]; update c in [1, nz-1]
  if (in_a && in_b) {
    T v = q.Vz[i];
    if (c >= 1 && c <= nz - 1) {
      const T r = (q.txz[i] - q.txz[i - sx]) * q.inv_dx +
                  (q.tyz[i] - q.tyz[i - sy]) * q.inv_dy +
                  (q.tzz[i + 1] - q.tzz[i]) * q.inv_dz -
                  (q.P[i + 1] - q.P[i]) * q.inv_dz - coef(k, K_F2, i, n);
      v = v + r * coef(k, K_IE2, i, n);
      q.Vz[i] = v;
    }
    if (free_slip) mirror(q.Vz, i, a == 1, a == nx, b == 1, b == ny, sx, sy, v);
  }
}

template <typename T>
int run_chunk(void* carry, const void* coefs, const int* slots,
              const double* vals, int nx, int ny, int nz, int nout,
              const double* inv_di, int free_slip, cudaStream_t stream) {
  const int X = nx + 2, Y = ny + 2, Z = nz + 2;
  Carry<T> q;
  q.nx = nx; q.ny = ny; q.nz = nz;
  q.sy = Z; q.sx = (int64_t)Y * Z; q.n = (int64_t)X * Y * Z;
  T* base = static_cast<T*>(carry);
  T** f[10] = {&q.Vx, &q.Vy, &q.Vz, &q.P, &q.txx, &q.tyy, &q.tzz,
               &q.tyz, &q.txz, &q.txy};
  for (int j = 0; j < 10; ++j) *f[j] = base + j * q.n;
  q.inv_dx = T(inv_di[0]); q.inv_dy = T(inv_di[1]); q.inv_dz = T(inv_di[2]);

  Coefs<T> k;
  k.base = static_cast<const T*>(coefs);
  for (int j = 0; j < N_COEF; ++j) {
    k.slot[j] = slots[j];
    k.val[j] = T(vals[j]);
  }

  const dim3 blk(32, 8, 1);
  const dim3 grid((Z + 31) / 32, (Y + 7) / 8, X);
  for (int it = 0; it < nout; ++it) {
    k_cells_edges<T><<<grid, blk, 0, stream>>>(q, k);
    k_faces<T><<<grid, blk, 0, stream>>>(q, k, free_slip);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). `carry` is the (10, nx+2, ny+2,
// nz+2) canvas stack in the order Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz,
// txy, updated in place; `coefs` the (n_canvas, nx+2, ny+2, nz+2) coefficient
// stack; `slots` and `vals` the 23 coefficients' slot table and scalar
// values; `inv_di` 1/dx, 1/dy, 1/dz. Launches on `stream` without
// synchronising; returns the first launch error, or 0.
extern "C" int jr_stokes3d_ve_chunk_f32(void* carry, const void* coefs,
                                        const int* slots, const double* vals,
                                        int nx, int ny, int nz, int nout,
                                        const double* inv_di, int free_slip,
                                        void* stream) {
  return run_chunk<float>(carry, coefs, slots, vals, nx, ny, nz, nout, inv_di,
                          free_slip, (cudaStream_t)stream);
}

extern "C" int jr_stokes3d_ve_chunk_f64(void* carry, const void* coefs,
                                        const int* slots, const double* vals,
                                        int nx, int ny, int nz, int nout,
                                        const double* inv_di, int free_slip,
                                        void* stream) {
  return run_chunk<double>(carry, coefs, slots, vals, nx, ny, nz, nout, inv_di,
                           free_slip, (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
