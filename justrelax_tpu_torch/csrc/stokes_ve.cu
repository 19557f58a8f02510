// 2D visco-elastic (VE) compressible pseudo-transient chunk, hand-written for
// Hopper (sm_90a): one tiled launch per PT iteration.
//
// Replaces the two TPU kernels of the linear VE Stokes solve (solve_ve):
//   B1  justrelax_tpu/ops/pallas_stokes.py::stokes_chunk_vmem
//   B4  justrelax_tpu/ops/pallas_stokes.py::stokes_chunk_blocked
// Both compute `nout` iterations of `_ve_iteration`; on this card one kernel
// serves both (B4's temporal row blocking only existed because a TPU core's
// VMEM could not hold the grid past ~820^2).
//
// What bounds it on this card: device-memory traffic. One iteration must
// read and write the 6 unknowns (12 words per cell) and read each invariant
// slot that varies and is not derived here: on SolCx (G = K = inf, P0 = Q =
// tau_o = 0) eta and rho g_y, 14 words, against the ~32 that the earlier
// two-launch form moved (the face launch re-read P, tau and eta_tau, and all
// 13 slots were streamed every iteration).
//
// Design, as csrc/stokes_vep.cu: each block owns a TX x TY tile of cells and
// the vertices, faces and ghosts mapped onto it, stages every old field and
// varying slot it reads over its tile plus a radius-2 halo in shared memory
// (phase A: cp.async, all of the block's device-memory reads in flight at
// once) and computes
//   B. cells [I0-1, I1) x [J0-1, J1): divergence, P, tau_xx, tau_yy;
//      vertices [I0, I1] x [J0, J1]: tau_xy on the interior vertices (the
//      boundary vertices keep their value);
//   C. the damped velocity update of the faces it owns from the new P / tau
//      and, with free slip, the ghosts, each from the updated value it
//      mirrors (the boundary normal faces are never updated);
// writing only the points it owns, to the other of two alternating work sets.
// One launch per iteration: the face update's dependencies (new P and tau at
// the adjacent cells, new tau_xy at the adjacent vertices) are recomputed in
// the halo, bit-equal to their owner's values.
//
// Invariant slots come in packed (ops/slots.py): a uniform slot as a
// scalar. eta_v (the 4-cell average of eta on the interior vertices) is
// always derived here from eta, and eta_tau (the 3x3 clamped maxloc of eta)
// when the wrapper found it equal to maxloc(eta): both in the operation order
// of ops/stencil.py (av_a, maxloc), so the values are the stack's own. Each
// formula keeps the array path's operation order (ops/stokes.py: compute_P,
// compute_tau_ve, compute_V). 1/(G dt) = 0 for G = inf and Q/dt = 0 for
// dt = inf come from the host in IEEE arithmetic (no fast-math). Left for
// later: temporal blocking (k iterations per launch, B4's TPU form).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Slot order of the invariant stacks (ops/hopper_stokes.py CELL_SLOTS /
// VERTEX_SLOTS).
enum CSlot { C_ETA, C_ETAT, C_GDT, C_KDT, C_P0, C_QDT, C_TXX_O, C_TYY_O,
             C_RHO_GX, C_RHO_GY, C_NSLOT };
enum VSlot { V_ETA, V_GDT, V_TXY_O, V_NSLOT };
// a slot's index: a canvas (>= 0), a scalar, or derived in the kernel
enum { SLOT_SCALAR = -1, SLOT_DERIVED = -2 };

constexpr int NT = 256;  // threads per block
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int TX = 16, TY = 64; };
template <> struct Tile<double> { static constexpr int TX = 16, TY = 32; };
constexpr int N_STAGED = 6;    // old fields staged per window point
constexpr int N_COMPUTED = 1;  // computed fields per window point (eta_tau)

template <typename T> struct Scal {
  T inv_dx, inv_dy, r_over_theta, theta_dtau, etadtau;
};

template <typename T> struct Carry {
  T *Vx, *Vy, *P, *txx, *tyy, *txy;
};

// The invariant slots: a canvas of the packed stacks (index >= 0; ncv cell
// and nvv vertex canvases, staged in shared memory), a scalar, or derived
template <typename T> struct Inv {
  const T *cinv, *vinv;
  int ncv, nvv;
  int ci[C_NSLOT], vi[V_NSLOT];
  T cv[C_NSLOT], vv[V_NSLOT];
};

// Staging copies: cp.async of one element from device to shared memory, no
// registers and no wait until cp_async_wait_all, so every copy of a tile is
// in flight at once
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d(tau) = dtau_r * (2 eta eps - (tau - tau_o) eta/(G dt) - tau)
template <typename T>
__device__ __forceinline__ T stress_inc(T tau, T tau_o, T e, T eta, T Gdt,
                                        T dr) {
  return dr * (T(2) * eta * e - (tau - tau_o) * eta * Gdt - tau);
}

// NaN-propagating max, as torch.amax
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// One PT iteration from carry `in` to carry `out`. Ownership as in
// csrc/stokes_vep.cu: along each axis [I0 + off, I1 + off) for an array whose
// index k sits at cell k - off, extended to 0 on the first tile and to the
// array's end on the last. Block t takes tile t (y fastest); every read of
// device memory is a cp.async into shared memory in phase A.
template <typename T, int TX, int TY>
__global__ void __launch_bounds__(NT)
    k_iteration(const Carry<T> in, Carry<T> out, const Inv<T> inv,
                const Scal<T> s, int free_slip, int nx, int ny) {
  constexpr int WX = TX + 4, WY = TY + 4, NW = WX * WY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_vx = sm;             // old Vx
  T* s_vy = sm + NW;        // old Vy
  T* s_P = sm + 2 * NW;     // P (cells): old, then new
  T* s_txx = sm + 3 * NW;   // tau_xx (cells): old, then new
  T* s_tyy = sm + 4 * NW;   // tau_yy (cells): old, then new
  T* s_txy = sm + 5 * NW;   // tau_xy (vertices): old, then new
  T* s_cinv = sm + N_STAGED * NW;      // the varying cell slots
  T* s_vinv = s_cinv + inv.ncv * NW;   // the varying vertex slots
  T* s_et = s_cinv + (inv.ncv + inv.nvv) * NW;  // eta_tau (cells)
  auto cs = [&](int k, int p) -> T {
    return inv.ci[k] >= 0 ? s_cinv[inv.ci[k] * NW + p] : inv.cv[k];
  };
  auto vs = [&](int k, int p) -> T {
    return inv.vi[k] >= 0 ? s_vinv[inv.vi[k] * NW + p] : inv.vv[k];
  };

  const int nty = (ny + TY - 1) / TY;  // block t takes tile t, y fastest
  const int I0 = (blockIdx.x / nty) * TX, J0 = (blockIdx.x % nty) * TY;
  const int I1 = min(I0 + TX, nx), J1 = min(J0 + TY, ny);
  const int oi = I0 - 2, oj = J0 - 2;
  auto W = [&](int i, int j) { return (i - oi) * WY + (j - oj); };
  const int64_t sx = ny + 2, sy = ny + 1;
  const int64_t N = (int64_t)nx * ny, NV = (int64_t)(nx + 1) * (ny + 1);
  const bool derive_et = inv.ci[C_ETAT] == SLOT_DERIVED;
  const bool derive_ev = inv.vi[V_ETA] == SLOT_DERIVED;

  // ---- A. stage the window's old fields and varying slots
#pragma unroll
  for (int k = 0; k < (NW + NT - 1) / NT; ++k) {
    const int p = threadIdx.x + k * NT;
    if (p >= NW) break;
    const int i = oi + p / WY, j = oj + p % WY;
    if (i >= 0 && i < nx && j >= 0 && j < ny) {
      const int64_t c = (int64_t)i * ny + j;
      cp_async_elem(s_P + p, in.P + c);
      cp_async_elem(s_txx + p, in.txx + c);
      cp_async_elem(s_tyy + p, in.tyy + c);
    }
    if (i >= 0 && i <= nx && j >= 0 && j <= ny)
      cp_async_elem(s_txy + p, in.txy + (int64_t)i * sy + j);
    if (i >= 0 && i <= nx && j >= 0 && j <= ny + 1) cp_async_elem(s_vx + p, in.Vx + i * sx + j);
    if (i >= 0 && i <= nx + 1 && j >= 0 && j <= ny) cp_async_elem(s_vy + p, in.Vy + i * sy + j);
  }
  for (int m = 0; m < inv.ncv + inv.nvv; ++m) {
    const bool cell = m < inv.ncv;
    const T* src = cell ? inv.cinv + m * N : inv.vinv + (m - inv.ncv) * NV;
    const int ni = cell ? nx : nx + 1, nj = cell ? ny : ny + 1;
#pragma unroll
    for (int k = 0; k < (NW + NT - 1) / NT; ++k) {
      const int p = threadIdx.x + k * NT;
      if (p >= NW) break;
      const int i = oi + p / WY, j = oj + p % WY;
      if (i >= 0 && i < ni && j >= 0 && j < nj)
        cp_async_elem(s_cinv + m * NW + p, src + (int64_t)i * nj + j);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- B. cells [I0-1, I1) x [J0-1, J1): P, tau_xx, tau_yy
  for (int q = threadIdx.x; q < (TX + 1) * (TY + 1); q += NT) {
    const int i = I0 - 1 + q / (TY + 1), j = J0 - 1 + q % (TY + 1);
    if (i < 0 || j < 0 || i >= I1 || j >= J1) continue;
    const int p = W(i, j);
    T et;
    if (derive_et) {  // ops/stencil.py::maxloc, window 1, clamped
      const int rows[3] = {max(i - 1, 0), i, min(i + 1, nx - 1)};
      const int cols[3] = {max(j - 1, 0), j, min(j + 1, ny - 1)};
      et = cs(C_ETA, p);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int c = 0; c < 3; ++c) et = vmax(et, cs(C_ETA, W(rows[a], cols[c])));
      }
    } else {
      et = cs(C_ETAT, p);
    }
    s_et[p] = et;
    const T dVxdx = (s_vx[W(i + 1, j + 1)] - s_vx[W(i, j + 1)]) * s.inv_dx;
    const T dVydy = (s_vy[W(i + 1, j + 1)] - s_vy[W(i + 1, j)]) * s.inv_dy;
    const T gv = dVxdx + dVydy;

    // compute_P: psi from eta_tau, (P0/(K dt) + rhs) psi + P over 1 + psi/(K dt)
    const T Kdt = cs(C_KDT, p);
    const T Gdt = cs(C_GDT, p);
    const T rhs = -gv + cs(C_QDT, p);
    const T psi = T(1) / (T(1) / et + Gdt) * s.r_over_theta;
    const T Pn = ((cs(C_P0, p) * Kdt + rhs) * psi + s_P[p]) / (T(1) + Kdt * psi);

    // compute_tau_ve at the cell
    const T third = T(1.0 / 3.0);
    const T exx = dVxdx - gv * third;
    const T eyy = dVydy - gv * third;
    const T eta = cs(C_ETA, p);
    const T dtau_r = T(1) / (s.theta_dtau + eta * Gdt + T(1));
    const T txx = s_txx[p], tyy = s_tyy[p];
    const T txx_n = txx + stress_inc(txx, cs(C_TXX_O, p), exx, eta, Gdt, dtau_r);
    const T tyy_n = tyy + stress_inc(tyy, cs(C_TYY_O, p), eyy, eta, Gdt, dtau_r);
    s_P[p] = Pn;  // each cell is read and written by its own thread only
    s_txx[p] = txx_n;
    s_tyy[p] = tyy_n;
    if (i >= I0 && j >= J0) {
      const int64_t c = (int64_t)i * ny + j;
      out.P[c] = Pn;
      out.txx[c] = txx_n;
      out.tyy[c] = tyy_n;
    }
  }

  // ---- B. vertices [I0, I1] x [J0, J1]: tau_xy on the interior ones
  for (int q = threadIdx.x; q < (TX + 1) * (TY + 1); q += NT) {
    const int i = I0 + q / (TY + 1), j = J0 + q % (TY + 1);
    if (i > I1 || j > J1) continue;
    const int pv = W(i, j);
    T txy = s_txy[pv];
    if (i >= 1 && i <= nx - 1 && j >= 1 && j <= ny - 1) {
      const T exy = T(0.5) * ((s_vx[W(i, j + 1)] - s_vx[pv]) * s.inv_dy +
                              (s_vy[W(i + 1, j)] - s_vy[pv]) * s.inv_dx);
      // ops/stencil.py::av_a of eta: the 4 cells around the vertex
      const T eta_v = derive_ev
          ? T(0.25) * (cs(C_ETA, W(i - 1, j - 1)) + cs(C_ETA, W(i, j - 1)) +
                       cs(C_ETA, W(i - 1, j)) + cs(C_ETA, pv))
          : vs(V_ETA, pv);
      const T Gdt_v = vs(V_GDT, pv);
      const T dtau_rv = T(1) / (s.theta_dtau + eta_v * Gdt_v + T(1));
      txy = txy + stress_inc(txy, vs(V_TXY_O, pv), exy, eta_v, Gdt_v, dtau_rv);
    }
    s_txy[pv] = txy;
    if ((i < I1 || I1 == nx) && (j < J1 || J1 == ny)) out.txy[(int64_t)i * sy + j] = txy;
  }
  __syncthreads();

  // ---- C. faces: damped velocity update, then the free-slip ghosts
  auto vx_new = [&](int i, int j) -> T {
    const T old = s_vx[W(i, j)];
    if (i < 1 || i > nx - 1 || j < 1 || j > ny) return old;
    const int a = W(i - 1, j - 1), c = W(i, j - 1);
    const T rx = (s_txx[c] - s_txx[a]) * s.inv_dx +
                 (s_txy[W(i, j)] - s_txy[W(i, j - 1)]) * s.inv_dy -
                 (s_P[c] - s_P[a]) * s.inv_dx -
                 T(0.5) * (cs(C_RHO_GX, c) + cs(C_RHO_GX, a));
    const T etax = T(0.5) * (s_et[c] + s_et[a]);
    return old + rx * s.etadtau / etax;
  };
  auto vy_new = [&](int i, int j) -> T {
    const T old = s_vy[W(i, j)];
    if (i < 1 || i > nx || j < 1 || j > ny - 1) return old;
    const int a = W(i - 1, j - 1), c = W(i - 1, j);
    const T ry = (s_tyy[c] - s_tyy[a]) * s.inv_dy +
                 (s_txy[W(i, j)] - s_txy[W(i - 1, j)]) * s.inv_dx -
                 (s_P[c] - s_P[a]) * s.inv_dy -
                 T(0.5) * (cs(C_RHO_GY, c) + cs(C_RHO_GY, a));
    const T etay = T(0.5) * (s_et[c] + s_et[a]);
    return old + ry * s.etadtau / etay;
  };

  {  // Vx (nx+1, ny+2): rows [I0, I1) (+ nx), columns [J0+1, J1+1) (+ 0, ny+1)
    const int ihi = I1 + (I1 == nx);
    const int jlo = J0 == 0 ? 0 : J0 + 1, jhi = J1 + 1 + (J1 == ny);
    for (int q = threadIdx.x; q < (TX + 1) * (TY + 2); q += NT) {
      const int i = I0 + q / (TY + 2), j = jlo + q % (TY + 2);
      if (i >= ihi || j >= jhi) continue;
      const int jj = !free_slip ? j : (j == 0 ? 1 : (j == ny + 1 ? ny : j));
      out.Vx[i * sx + j] = vx_new(i, jj);
    }
  }
  {  // Vy (nx+2, ny+1): rows [I0+1, I1+1) (+ 0, nx+1), columns [J0, J1) (+ ny)
    const int ilo = I0 == 0 ? 0 : I0 + 1, ihi = I1 + 1 + (I1 == nx);
    const int jhi = J1 + (J1 == ny);
    for (int q = threadIdx.x; q < (TX + 2) * (TY + 1); q += NT) {
      const int i = ilo + q / (TY + 1), j = J0 + q % (TY + 1);
      if (i >= ihi || j >= jhi) continue;
      const int ii = !free_slip ? i : (i == 0 ? 1 : (i == nx + 1 ? nx : i));
      out.Vy[i * sy + j] = vy_new(ii, j);
    }
  }
}

template <typename T> Carry<T> carry_of(void** p) {
  T** c = reinterpret_cast<T**>(p);
  return Carry<T>{c[0], c[1], c[2], c[3], c[4], c[5]};
}

template <typename T>
int run_chunk(void** in, void** w0, void** w1, const void* cinv,
              const void* vinv, const int* cidx, const double* cval,
              const int* vidx, const double* vval, int nx, int ny, int nout,
              const double* sc, int free_slip, cudaStream_t stream) {
  constexpr int TX = Tile<T>::TX, TY = Tile<T>::TY;
  Inv<T> inv;
  inv.cinv = static_cast<const T*>(cinv);
  inv.vinv = static_cast<const T*>(vinv);
  inv.ncv = inv.nvv = 0;
  for (int k = 0; k < C_NSLOT; ++k) {
    inv.ci[k] = cidx[k];
    inv.cv[k] = T(cval[k]);
    inv.ncv += cidx[k] >= 0;
  }
  for (int k = 0; k < V_NSLOT; ++k) {
    inv.vi[k] = vidx[k];
    inv.vv[k] = T(vval[k]);
    inv.nvv += vidx[k] >= 0;
  }
  Scal<T> s;
  s.inv_dx = T(sc[0]); s.inv_dy = T(sc[1]); s.r_over_theta = T(sc[2]);
  s.theta_dtau = T(sc[3]); s.etadtau = T(sc[4]);

  const Carry<T> src0 = carry_of<T>(in), set[2] = {carry_of<T>(w0), carry_of<T>(w1)};
  // at most 20 staged arrays and eta_tau (every slot a canvas): 111 KB
  const size_t smem = (size_t)(N_STAGED + inv.ncv + inv.nvv + N_COMPUTED) *
                      (TX + 4) * (TY + 4) * sizeof(T);
  auto kern = k_iteration<T, TX, TY>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  for (int it = 0; it < nout; ++it) {
    const Carry<T> src = it == 0 ? src0 : set[(it - 1) % 2];
    kern<<<tiles, NT, smem, stream>>>(src, set[it % 2], inv, s, free_slip, nx, ny);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). `in`, `w0` and `w1` each hold the
// 6 fields Vx, Vy, P, txx, tyy, txy: iteration k reads `in` (k = 0) or work
// set (k - 1) % 2 and writes work set k % 2, so the result is in work set
// (nout - 1) % 2 and `in` is never written. `cinv` / `vinv` are the packed
// canvases of the varying cell / vertex slots; per slot (CSlot / VSlot
// order) `cidx` / `vidx` give its canvas, -1 for the scalar in `cval` /
// `vval`, or -2 where the kernel derives it from eta (eta_tau, eta_v).
// `scal`: inv_dx, inv_dy, r/theta_dtau, theta_dtau, etadtau. Launches on
// `stream` without synchronising; returns the first launch error, or 0.
extern "C" int jr_stokes_ve_chunk_f32(
    void** in, void** w0, void** w1, const void* cinv, const void* vinv,
    const int* cidx, const double* cval, const int* vidx, const double* vval,
    int nx, int ny, int nout, const double* scal, int free_slip, void* stream) {
  return run_chunk<float>(in, w0, w1, cinv, vinv, cidx, cval, vidx, vval, nx,
                          ny, nout, scal, free_slip, (cudaStream_t)stream);
}

extern "C" int jr_stokes_ve_chunk_f64(
    void** in, void** w0, void** w1, const void* cinv, const void* vinv,
    const int* cidx, const double* cval, const int* vidx, const double* vval,
    int nx, int ny, int nout, const double* scal, int free_slip, void* stream) {
  return run_chunk<double>(in, w0, w1, cinv, vinv, cidx, cval, vidx, vval, nx,
                           ny, nout, scal, free_slip, (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
