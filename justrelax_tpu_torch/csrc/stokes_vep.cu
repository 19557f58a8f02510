// Fused 2D multi-phase visco-elasto-plastic (VEP) pseudo-transient chunk,
// hand-written for Hopper (sm_90a): one tiled launch per PT iteration.
//
// Replaces the two TPU kernels of the flagship VEP solve:
//   B2  justrelax_tpu/ops/pallas_stokes_vep.py::stokes_vep_chunk_vmem
//   B3  justrelax_tpu/ops/pallas_stokes_vep.py::stokes_vep_chunk_blocked
// Both compute `nout` iterations of `_vep_iteration` on chunk-invariant
// stacks; on this card one kernel serves both (B3 only existed because a
// TPU core's VMEM could not hold the grid past ~650^2).
//
// What bounds it on this card: device-memory traffic. One iteration must
// read the 11 carried fields it depends on, write all 12 (P is write-only)
// and read each invariant slot that varies: 25 words per cell on the shear
// band's first step (2 of the 33 slots vary there), against the ~77 that
// the earlier five-launch form moved. The arithmetic (a few hundred flops
// per cell) is far below the card's 67 TFLOP/s (f32).
//
// Design. Each block owns a TX x TY tile of cells (the long side on the
// contiguous y axis) and the vertices, faces and ghosts mapped onto it (see
// k_iteration). In phase A it stages every OLD carried field and varying
// slot it reads, over its tile plus a radius-2 halo, in shared memory with
// cp.async: all of its device-memory reads in flight at once. (On an H100,
// a form that read the point-wise fields inside the later phases ran at
// 21 % of the bound, latency-bound; a persistent form that prefetched the
// next tile into a second buffer was slower than this one, its two buffers
// leaving fewer blocks per SM.) Then it computes, with __syncthreads between
// the phases:
//   B. cells [I0-1, I1] x [J0-1, J1]: maxloc eta_tau (3x3, clamped),
//      divergence, pressure iterate theta, eps_xx / eps_yy; vertices
//      [I0-1, I1] x [J0-1, J1]: eps_xy from the old velocities;
//   C. vertices [I0, I1] x [J0, J1]: the vertex return mapping (tau_xy_v,
//      lambda_v, eta_v) from the new theta and the old tau / eta at the four
//      clamped cells; cells [I0-1, I1) x [J0-1, J1): the cell return mapping
//      (tau, lambda, P, eta continuation);
//   D. the damped velocity update of the faces it owns, from the new tau /
//      P / tau_xy_v and eta_tau, with the BC lines (no-slip bottom-row Vx/3
//      smoothing before the ghost mirrors; zeroed faces) written by the block
//      that owns the ghost, from the updated values it mirrors.
// The halo's share is recomputed, not exchanged: a halo point runs the same
// code on the same inputs as its owner and gets bit-equal values. Each block
// writes only the points it owns, to the other of two alternating work sets
// (a neighbour block still reads the old carry), so the four scratch fields
// of the five-launch form (eta_tau, eps_xx, eps_yy, eps_xy) never reach
// device memory. One launch per iteration: every dependency of the iteration
// is met inside a tile with this halo.
//
// Invariant slots: a slot that holds one value everywhere comes in as a
// scalar (ops/slots.py::pack_slots); the kernel reads a canvas only for a
// slot that varies. Each formula keeps the plain version's operation order
// (ops/stokes_vep.py::vep_iteration), so f64 parity stays at rounding. The
// TPU kernel's jnp.roll + iota bands become index arithmetic and its
// edge-replicated ghost ring becomes clamped cell indices. Left for later:
// temporal blocking (k iterations per launch from a (T + 4k)^2 window, B3's
// TPU form).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// Slot order of the invariant stacks (ops/hopper_stokes_vep.py CINV_SLOTS /
// VINV_SLOTS).
enum CSlot {
  C_P0_KDT, C_QDT, C_TXX_O, C_TYY_O, C_TXYC_O, C_GDT, C_KDT_INV, C_KDT0,
  C_VISC_A, C_VISC_B, C_IS_PL, C_SCALE, C_CCOS, C_SINPHI, C_SINPSI, C_ETAREG,
  C_PT, C_RHO_GX, C_RHO_GY, C_NSLOT
};
enum VSlot {
  V_TXX_O, V_TYY_O, V_TXY_O, V_GDT, V_KDT0, V_VISC_A, V_VISC_B, V_IS_PL,
  V_SCALE, V_CCOS, V_SINPHI, V_SINPSI, V_ETAREG, V_PT, V_NSLOT
};
// no-slip faces (bits of bc_bits); a face without its bit is free-slip
enum { BC_LEFT = 1, BC_RIGHT = 2, BC_BOT = 4, BC_TOP = 8 };

constexpr int NT = 512;  // threads per block
// Tiles: the shared memory of the worst case (every slot a canvas) fits a
// block; on the shear band (2 canvases, 52 KB in f32) the registers let
// three f32 blocks share an SM.
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int TX = 16, TY = 32; };
template <> struct Tile<double> { static constexpr int TX = 8, TY = 32; };
constexpr int N_STAGED = 11;   // old fields staged per window point
constexpr int N_COMPUTED = 5;  // computed fields per window point

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
};
template <> struct Lim<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
};

__device__ __forceinline__ float xsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double xsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float xpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double xpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float xabs(float a) { return fabsf(a); }
__device__ __forceinline__ double xabs(double a) { return fabs(a); }

// NaN-propagating max/min, as jnp.maximum / torch.clamp
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T vmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T clip(T x, T lo, T hi) {
  return vmin(vmax(x, lo), hi);
}

template <typename T> struct Scal {
  T inv_dx, inv_dy, etadtau, r_over_theta, theta_dtau;
  T rel_lambda, one_m_rel, relax_v, one_m_relax, cut_lo, cut_hi, visc_m;
};

template <typename T> struct Carry {
  T *Vx, *Vy, *theta, *P, *txx, *tyy, *txy_c, *txy_v, *eta, *eta_v, *lam,
      *lam_v;
};

// The invariant slots: a canvas of the packed stacks (index >= 0; ncv cell
// and nvv vertex canvases, staged in shared memory) or a scalar
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

// Drucker-Prager (+ elliptic tension cap when CAP) return mapping: yield
// flag, relaxed multiplier and dQ/dP (rheology/plasticity.py formulas).
template <typename T, bool CAP>
__device__ __forceinline__ void plastic_step(
    T tII, T P, T ipl, T Ccos, T sinphi, T sinpsi, T pT, T etareg, T Kdt0,
    T eta, T dtau_r, T lam, const Scal<T>& s, bool& yielding, T& lam_new,
    T& dQdP) {
  const T cone = Ccos + P * sinphi;
  T F, dFdP;
  if (CAP) {
    const T inf = T(INFINITY);
    const T pT_eff = (pT == T(0)) ? -inf : pT;
    const T ratio = clip(P / pT_eff, T(0), T(1));
    const T one_m_r2 = T(1) - ratio * ratio;
    T cap = Ccos * xsqrt(vmax(one_m_r2, T(0)));
    cap = (P < T(0)) ? cap : inf;
    F = tII - vmin(cone, cap);
    const T root = xsqrt(vmax(one_m_r2, T(1e-12)));
    const T dcap = Ccos * P / (isinf(pT_eff) ? inf : pT_eff * pT_eff) / root;
    const bool on_cap = cap < cone;
    dFdP = on_cap ? dcap : -sinphi;
    dQdP = on_cap ? dcap : -sinpsi;
  } else {
    F = tII - cone;
    dFdP = -sinphi;
    dQdP = -sinpsi;
  }
  const T volume = Kdt0 * dFdP * dQdP;
  yielding = (ipl > T(0)) && (tII != T(0)) && (F > T(0));
  lam_new = yielding ? s.one_m_rel * lam +
                           s.rel_lambda * (vmax(F, T(0)) /
                                           (eta * dtau_r + etareg + volume))
                     : lam;
}

// viscosity continuation target: the linear table, or 1/(A + B tII^m)
template <typename T>
__device__ __forceinline__ T visc_target(int visc_mode, T a, T b, T tII,
                                         const Scal<T>& s) {
  if (visc_mode == 0) return a;
  if (tII == T(0)) tII = Lim<T>::eps();
  const T pw = (s.visc_m == T(0)) ? T(1) : xpow(tII, s.visc_m);
  return T(1) / vmax(a + b * pw, Lim<T>::tiny());
}

// One PT iteration from carry `in` to carry `out` (see the note at the top).
// Ownership of tile [I0, I1) x [J0, J1) along each axis, for an array whose
// index k sits at cell k - off (off 0: cells, vertices, Vx rows, Vy
// columns; off 1: Vx columns, Vy rows): [I0 + off, I1 + off), extended down
// to 0 on the first tile and up to the array's end on the last. Block t
// takes tile t (y fastest). Every read of device memory is a cp.async into
// shared memory in phase A; phases B-D read shared memory only.
template <typename T, bool CAP, int TX, int TY>
__global__ void __launch_bounds__(NT)
    k_iteration(const Carry<T> in, Carry<T> out, const Inv<T> inv,
                const Scal<T> s, int visc_mode, int bc, int nx, int ny) {
  constexpr int WX = TX + 4, WY = TY + 4, NW = WX * WY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  // staged old fields (A); the second name is what phase C writes over the
  // point's own value once it has read it
  T* s_eta = sm;               // eta (cells)
  T* s_vx = sm + NW;           // Vx
  T* s_vy = sm + 2 * NW;       // Vy
  T* s_txx = sm + 3 * NW;      // tau_xx (cells)
  T* s_tyy = sm + 4 * NW;      // tau_yy (cells)
  T* s_thold = sm + 5 * NW;    // theta (cells);  new P after phase B
  T* s_txyc = sm + 6 * NW;     // tau_xy_c;       new tau_xx
  T* s_lam = sm + 7 * NW;      // lambda;         new tau_yy
  T* s_txyv = sm + 8 * NW;     // tau_xy_v (vertices); new tau_xy_v
  T* s_lamv = sm + 9 * NW;     // lambda_v
  T* s_etav = sm + 10 * NW;    // eta_v
  T* s_cinv = sm + N_STAGED * NW;      // the varying cell slots
  T* s_vinv = s_cinv + inv.ncv * NW;   // the varying vertex slots
  // computed in phase B
  T* s_th = s_cinv + (inv.ncv + inv.nvv) * NW;  // new theta (cells)
  T* s_exx = s_th + NW;        // eps_xx (cells)
  T* s_eyy = s_th + 2 * NW;    // eps_yy (cells)
  T* s_et = s_th + 3 * NW;     // eta_tau (cells)
  T* s_exy = s_th + 4 * NW;    // eps_xy (vertices)
  T* s_P = s_thold;
  T* s_txxn = s_txyc;
  T* s_tyyn = s_lam;
  auto cs = [&](int k, int p) -> T {
    return inv.ci[k] >= 0 ? s_cinv[inv.ci[k] * NW + p] : inv.cv[k];
  };
  auto vs = [&](int k, int p) -> T {
    return inv.vi[k] >= 0 ? s_vinv[inv.vi[k] * NW + p] : inv.vv[k];
  };

  const int nty = (ny + TY - 1) / TY;  // block t takes tile t, y fastest
  const int I0 = (blockIdx.x / nty) * TX, J0 = (blockIdx.x % nty) * TY;
  const int I1 = min(I0 + TX, nx), J1 = min(J0 + TY, ny);
  const int oi = I0 - 2, oj = J0 - 2;  // window origin, same for every array
  auto W = [&](int i, int j) { return (i - oi) * WY + (j - oj); };
  const int64_t sx = ny + 2, sy = ny + 1;
  const int64_t N = (int64_t)nx * ny, NV = (int64_t)(nx + 1) * (ny + 1);

  // ---- A. stage the window's old fields and varying slots
#pragma unroll
  for (int k = 0; k < (NW + NT - 1) / NT; ++k) {
    const int p = threadIdx.x + k * NT;
    if (p >= NW) break;
    const int i = oi + p / WY, j = oj + p % WY;
    if (i >= 0 && i < nx && j >= 0 && j < ny) {
      const int64_t c = (int64_t)i * ny + j;
      cp_async_elem(s_eta + p, in.eta + c);
      cp_async_elem(s_txx + p, in.txx + c);
      cp_async_elem(s_tyy + p, in.tyy + c);
      cp_async_elem(s_thold + p, in.theta + c);
      cp_async_elem(s_txyc + p, in.txy_c + c);
      cp_async_elem(s_lam + p, in.lam + c);
    }
    if (i >= 0 && i <= nx && j >= 0 && j <= ny) {
      const int64_t v = (int64_t)i * sy + j;
      cp_async_elem(s_txyv + p, in.txy_v + v);
      cp_async_elem(s_lamv + p, in.lam_v + v);
      cp_async_elem(s_etav + p, in.eta_v + v);
    }
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

  // ---- B. cells: eta_tau, theta, eps_xx, eps_yy; vertices: eps_xy
  for (int q = threadIdx.x; q < (TX + 2) * (TY + 2); q += NT) {
    const int i = I0 - 1 + q / (TY + 2), j = J0 - 1 + q % (TY + 2);
    if (i < 0 || j < 0 || i > I1 || j > J1) continue;
    const int p = W(i, j);
    if (i < nx && j < ny) {
      const int rows[3] = {max(i - 1, 0), i, min(i + 1, nx - 1)};
      const int cols[3] = {max(j - 1, 0), j, min(j + 1, ny - 1)};
      T et = s_eta[p];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) et = vmax(et, s_eta[W(rows[a], cols[b])]);
      }
      const T dVxdx = (s_vx[W(i + 1, j + 1)] - s_vx[W(i, j + 1)]) * s.inv_dx;
      const T dVydy = (s_vy[W(i + 1, j + 1)] - s_vy[W(i + 1, j)]) * s.inv_dy;
      const T gv = dVxdx + dVydy;
      const T rhs = -gv + cs(C_QDT, p);
      const T psi = T(1) / (T(1) / et + cs(C_GDT, p)) * s.r_over_theta;
      s_th[p] = ((cs(C_P0_KDT, p) + rhs) * psi + s_thold[p]) /
                (T(1) + cs(C_KDT_INV, p) * psi);
      const T third = T(1.0 / 3.0);
      s_exx[p] = dVxdx - gv * third;
      s_eyy[p] = dVydy - gv * third;
      s_et[p] = et;
    }
    s_exy[p] = T(0.5) * ((s_vx[W(i, j + 1)] - s_vx[p]) * s.inv_dy +
                         (s_vy[W(i + 1, j)] - s_vy[p]) * s.inv_dx);
  }
  __syncthreads();

  // ---- C. vertices [I0, I1] x [J0, J1]: trial stress, return mapping
  for (int q = threadIdx.x; q < (TX + 1) * (TY + 1); q += NT) {
    const int i = I0 + q / (TY + 1), j = J0 + q % (TY + 1);
    if (i > I1 || j > J1) continue;
    const int pv = W(i, j);
    // the 4 cells around the vertex, clamped into the grid
    const int i0 = max(i - 1, 0), i1 = min(i, nx - 1);
    const int j0 = max(j - 1, 0), j1 = min(j, ny - 1);
    const int c00 = W(i0, j0), c10 = W(i1, j0), c01 = W(i0, j1), c11 = W(i1, j1);
    const T q4 = T(0.25);
    const T Pv = q4 * (s_th[c00] + s_th[c10] + s_th[c01] + s_th[c11]);
    const T exx_v = q4 * (s_exx[c00] + s_exx[c10] + s_exx[c01] + s_exx[c11]);
    const T eyy_v = q4 * (s_eyy[c00] + s_eyy[c10] + s_eyy[c01] + s_eyy[c11]);
    const T txx_v = q4 * (s_txx[c00] + s_txx[c10] + s_txx[c01] + s_txx[c11]);
    const T tyy_v = q4 * (s_tyy[c00] + s_tyy[c10] + s_tyy[c01] + s_tyy[c11]);
    const T eta_vh = T(4) / (T(1) / s_eta[c00] + T(1) / s_eta[c10] +
                             T(1) / s_eta[c01] + T(1) / s_eta[c11]);
    const T exy = s_exy[pv];

    const T Gdt = vs(V_GDT, pv);
    const T dtau_rv = T(1) / (s.theta_dtau + eta_vh * Gdt + T(1));
    const T dtxx = stress_inc(txx_v, vs(V_TXX_O, pv), exx_v, eta_vh, Gdt, dtau_rv);
    const T dtyy = stress_inc(tyy_v, vs(V_TYY_O, pv), eyy_v, eta_vh, Gdt, dtau_rv);
    const T txy0 = s_txyv[pv];
    const T dtxy = stress_inc(txy0, vs(V_TXY_O, pv), exy, eta_vh, Gdt, dtau_rv);
    const T xy_t = txy0 + dtxy;
    const T xx_t = txx_v + dtxx, yy_t = tyy_v + dtyy;
    const T tII = xsqrt(T(0.5) * (xx_t * xx_t + yy_t * yy_t) + xy_t * xy_t);

    bool yv;
    T lam_new, dQdP;
    plastic_step<T, CAP>(tII, Pv, vs(V_IS_PL, pv), vs(V_CCOS, pv),
                         vs(V_SINPHI, pv), vs(V_SINPSI, pv), vs(V_PT, pv),
                         vs(V_ETAREG, pv), vs(V_KDT0, pv), eta_vh, dtau_rv,
                         s_lamv[pv], s, yv, lam_new, dQdP);
    const T dQdt_xy = vs(V_SCALE, pv) * (xy_t / (tII == T(0) ? T(1) : tII));
    const T eps_pl_xy = yv ? lam_new * dQdt_xy : T(0);
    const T txy_new =
        txy0 + (yv ? dtxy - T(2) * eta_vh * eps_pl_xy * dtau_rv : dtxy);
    s_txyv[pv] = txy_new;
    if ((i < I1 || I1 == nx) && (j < J1 || J1 == ny)) {
      const int64_t v = (int64_t)i * sy + j;
      out.txy_v[v] = txy_new;
      out.lam_v[v] = lam_new;
      // vertex viscosity continuation: tau-mode invariant of (0, 0, tau_xy_v)
      const T tgt = visc_target(visc_mode, vs(V_VISC_A, pv), vs(V_VISC_B, pv),
                                xabs(txy_new), s);
      out.eta_v[v] = clip(s.relax_v * tgt + s.one_m_relax * s_etav[pv],
                          s.cut_lo, s.cut_hi);
    }
  }

  // ---- C. cells [I0-1, I1) x [J0-1, J1): trial stress, return mapping, P
  for (int q = threadIdx.x; q < (TX + 1) * (TY + 1); q += NT) {
    const int i = I0 - 1 + q / (TY + 1), j = J0 - 1 + q % (TY + 1);
    if (i < 0 || j < 0 || i >= I1 || j >= J1) continue;
    const int p = W(i, j);
    const T exy_c = T(0.25) * (s_exy[p] + s_exy[W(i + 1, j)] +
                               s_exy[W(i, j + 1)] + s_exy[W(i + 1, j + 1)]);
    const T eta0 = s_eta[p];
    const T Gdt = cs(C_GDT, p);
    const T dtau_r = T(1) / (s.theta_dtau + eta0 * Gdt + T(1));
    const T txx0 = s_txx[p], tyy0 = s_tyy[p], txy0 = s_txyc[p], lam0 = s_lam[p];
    T xx = txx0 + stress_inc(txx0, cs(C_TXX_O, p), s_exx[p], eta0, Gdt, dtau_r);
    T yy = tyy0 + stress_inc(tyy0, cs(C_TYY_O, p), s_eyy[p], eta0, Gdt, dtau_r);
    T xy = txy0 + stress_inc(txy0, cs(C_TXYC_O, p), exy_c, eta0, Gdt, dtau_r);
    const T tII = xsqrt(T(0.5) * (xx * xx + yy * yy) + xy * xy);

    const T th = s_th[p];
    const T Kdt0 = cs(C_KDT0, p);
    bool yc;
    T lam_new, dQdP;
    plastic_step<T, CAP>(tII, th, cs(C_IS_PL, p), cs(C_CCOS, p),
                         cs(C_SINPHI, p), cs(C_SINPSI, p), cs(C_PT, p),
                         cs(C_ETAREG, p), Kdt0, eta0, dtau_r, lam0, s, yc,
                         lam_new, dQdP);
    if (yc) {
      const T ls = lam_new * cs(C_SCALE, p);
      const T den = (tII == T(0)) ? T(1) : tII;
      const T corr = T(2) * eta0 * dtau_r;
      xx = xx - corr * (ls * (xx / den));
      yy = yy - corr * (ls * (yy / den));
      xy = xy - corr * (ls * (xy / den));
    }
    const T Pn = th - Kdt0 * lam_new * dQdP;
    s_txxn[p] = xx;
    s_tyyn[p] = yy;
    s_P[p] = Pn;
    if (i >= I0 && j >= J0) {
      const int64_t c = (int64_t)i * ny + j;
      out.theta[c] = th;
      out.txx[c] = xx;
      out.tyy[c] = yy;
      out.txy_c[c] = xy;
      out.lam[c] = lam_new;
      out.P[c] = Pn;
      const T tII_new = xsqrt(T(0.5) * (xx * xx + yy * yy) + xy * xy);
      const T tgt = visc_target(visc_mode, cs(C_VISC_A, p), cs(C_VISC_B, p),
                                tII_new, s);
      out.eta[c] = clip(s.relax_v * tgt + s.one_m_relax * eta0, s.cut_lo, s.cut_hi);
    }
  }
  __syncthreads();

  // ---- D. faces: damped velocity update, no-slip zeros, BC lines
  // Vx after the update, before the BC lines (no-slip normal faces zeroed)
  auto vx_base = [&](int i, int j) -> T {
    if (((bc & BC_LEFT) && i == 0) || ((bc & BC_RIGHT) && i == nx)) return T(0);
    const T old = s_vx[W(i, j)];
    if (i < 1 || i > nx - 1 || j < 1 || j > ny) return old;
    const int a = W(i - 1, j - 1), b = W(i, j - 1);
    const T rx = (s_txxn[b] - s_txxn[a]) * s.inv_dx +
                 (s_txyv[W(i, j)] - s_txyv[W(i, j - 1)]) * s.inv_dy -
                 (s_P[b] - s_P[a]) * s.inv_dx -
                 T(0.5) * (cs(C_RHO_GX, b) + cs(C_RHO_GX, a));
    const T etax = T(0.5) * (s_et[b] + s_et[a]);
    return old + rx * s.etadtau / etax;
  };
  auto vy_base = [&](int i, int j) -> T {
    if (((bc & BC_BOT) && j == 0) || ((bc & BC_TOP) && j == ny)) return T(0);
    const T old = s_vy[W(i, j)];
    if (i < 1 || i > nx || j < 1 || j > ny - 1) return old;
    const int a = W(i - 1, j - 1), b = W(i - 1, j);
    const T ry = (s_tyyn[b] - s_tyyn[a]) * s.inv_dy +
                 (s_txyv[W(i, j)] - s_txyv[W(i - 1, j)]) * s.inv_dx -
                 (s_P[b] - s_P[a]) * s.inv_dy -
                 T(0.5) * (cs(C_RHO_GY, b) + cs(C_RHO_GY, a));
    const T etay = T(0.5) * (s_et[b] + s_et[a]);
    return old + ry * s.etadtau / etay;
  };

  {  // Vx (nx+1, ny+2): rows [I0, I1) (+ nx), columns [J0+1, J1+1) (+ 0, ny+1)
    const int ilo = I0, ihi = I1 + (I1 == nx);
    const int jlo = J0 == 0 ? 0 : J0 + 1, jhi = J1 + 1 + (J1 == ny);
    for (int q = threadIdx.x; q < (TX + 1) * (TY + 2); q += NT) {
      const int i = ilo + q / (TY + 2), j = jlo + q % (TY + 2);
      if (i >= ihi || j >= jhi) continue;
      T val;
      if (j <= 1) {  // no-slip bottom: row 1 smoothed to Vx(., 2) / 3 first
        const T c1 = (bc & BC_BOT) ? vx_base(i, 2) * T(1.0 / 3.0) : vx_base(i, 1);
        val = (j == 1 || !(bc & BC_BOT)) ? c1 : -c1;
      } else if (j == ny + 1) {
        const T b = vx_base(i, ny);
        val = (bc & BC_TOP) ? -b : b;
      } else {
        val = vx_base(i, j);
      }
      out.Vx[i * sx + j] = val;
    }
  }
  {  // Vy (nx+2, ny+1): rows [I0+1, I1+1) (+ 0, nx+1), columns [J0, J1) (+ ny)
    const int ilo = I0 == 0 ? 0 : I0 + 1, ihi = I1 + 1 + (I1 == nx);
    const int jlo = J0, jhi = J1 + (J1 == ny);
    for (int q = threadIdx.x; q < (TX + 2) * (TY + 1); q += NT) {
      const int i = ilo + q / (TY + 1), j = jlo + q % (TY + 1);
      if (i >= ihi || j >= jhi) continue;
      T val;
      if (i == 0) {
        const T b = vy_base(1, j);
        val = (bc & BC_LEFT) ? -b : b;
      } else if (i == nx + 1) {
        const T b = vy_base(nx, j);
        val = (bc & BC_RIGHT) ? -b : b;
      } else {
        val = vy_base(i, j);
      }
      out.Vy[i * sy + j] = val;
    }
  }
}

template <typename T> Carry<T> carry_of(void** p) {
  T** c = reinterpret_cast<T**>(p);
  return Carry<T>{c[0], c[1], c[2], c[3], c[4], c[5],
                  c[6], c[7], c[8], c[9], c[10], c[11]};
}

template <typename T, bool CAP>
int run_chunk(void** in, void** w0, void** w1, const Inv<T>& inv,
              const Scal<T>& s, int nx, int ny, int nout, int visc_mode,
              int bc_bits, cudaStream_t stream) {
  constexpr int TX = Tile<T>::TX, TY = Tile<T>::TY;
  const size_t smem = (size_t)(N_STAGED + inv.ncv + inv.nvv + N_COMPUTED) *
                      (TX + 4) * (TY + 4) * sizeof(T);
  auto kern = k_iteration<T, CAP, TX, TY>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Carry<T> src0 = carry_of<T>(in), set[2] = {carry_of<T>(w0), carry_of<T>(w1)};
  const int tiles = ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  for (int it = 0; it < nout; ++it) {
    const Carry<T> src = it == 0 ? src0 : set[(it - 1) % 2];
    kern<<<tiles, NT, smem, stream>>>(src, set[it % 2], inv, s, visc_mode,
                                      bc_bits, nx, ny);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int run(void** in, void** w0, void** w1, const void* cinv, const void* vinv,
        const int* cidx, const double* cval, const int* vidx,
        const double* vval, int nx, int ny, int nout, const double* sc,
        int visc_mode, int has_cap, int bc_bits, cudaStream_t stream) {
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
  s.inv_dx = T(sc[0]); s.inv_dy = T(sc[1]); s.etadtau = T(sc[2]);
  s.r_over_theta = T(sc[3]); s.theta_dtau = T(sc[4]);
  s.rel_lambda = T(sc[5]); s.one_m_rel = T(sc[6]);
  s.relax_v = T(sc[7]); s.one_m_relax = T(sc[8]);
  s.cut_lo = T(sc[9]); s.cut_hi = T(sc[10]); s.visc_m = T(sc[11]);

  return has_cap ? run_chunk<T, true>(in, w0, w1, inv, s, nx, ny, nout,
                                      visc_mode, bc_bits, stream)
                 : run_chunk<T, false>(in, w0, w1, inv, s, nx, ny, nout,
                                       visc_mode, bc_bits, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). `in`, `w0` and `w1` each hold the
// 12 carried fields in the order Vx, Vy, theta, P, txx, tyy, txy_c, txy_v,
// eta, eta_v, lam, lam_v: iteration k reads `in` (k = 0) or work set
// (k - 1) % 2 and writes work set k % 2, so the result is in work set
// (nout - 1) % 2 and `in` is never written. `cinv` / `vinv` are the packed
// canvases of the varying cell / vertex slots; per slot (CSlot / VSlot
// order) `cidx` / `vidx` give its canvas, or -1 for the scalar in `cval` /
// `vval`. `scal`: inv_dx, inv_dy, etadtau, r/theta_dtau, theta_dtau,
// rel_lambda, 1-rel_lambda, relax_v, 1-relax_v, cut_lo, cut_hi, visc_m.
// Launches on `stream` without synchronising; returns the first launch
// error, or 0.
extern "C" int jr_stokes_vep_chunk_f32(
    void** in, void** w0, void** w1, const void* cinv, const void* vinv,
    const int* cidx, const double* cval, const int* vidx, const double* vval,
    int nx, int ny, int nout, const double* scal, int visc_mode, int has_cap,
    int bc_bits, void* stream) {
  return run<float>(in, w0, w1, cinv, vinv, cidx, cval, vidx, vval, nx, ny,
                    nout, scal, visc_mode, has_cap, bc_bits,
                    (cudaStream_t)stream);
}

extern "C" int jr_stokes_vep_chunk_f64(
    void** in, void** w0, void** w1, const void* cinv, const void* vinv,
    const int* cidx, const double* cval, const int* vidx, const double* vval,
    int nx, int ny, int nout, const double* scal, int visc_mode, int has_cap,
    int bc_bits, void* stream) {
  return run<double>(in, w0, w1, cinv, vinv, cidx, cval, vidx, vval, nx, ny,
                     nout, scal, visc_mode, has_cap, bc_bits,
                     (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
