// Fused 2D multi-phase visco-elasto-plastic (VEP) pseudo-transient chunk,
// hand-written for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the flagship VEP solve:
//   B2  justrelax_tpu/ops/pallas_stokes_vep.py::stokes_vep_chunk_vmem
//   B3  justrelax_tpu/ops/pallas_stokes_vep.py::stokes_vep_chunk_blocked
// Both compute `nout` iterations of `_vep_iteration` on chunk-invariant
// stacks; on this card one kernel family serves both (B3 only existed
// because a TPU core's VMEM could not hold the grid past ~650^2).
//
// One iteration is five launches, one thread per point, in stream order:
//   1. cells    : maxloc eta_tau (3x3, clamped), divergence, pressure
//                 iterate theta, eps_xx / eps_yy
//   2. vertices : clamped center->vertex averages of the NEW theta and of the
//                 OLD tau_xx / tau_yy / eta, trial stress, return mapping,
//                 tau_xy_v, lambda_v, eta_v continuation; eps_xy stored
//   3. cells    : trial stress with eps_xy_c from the old velocities, return
//                 mapping, dilatancy-corrected P, lambda, eta continuation
//   4. faces    : damped velocity update from the new tau / P / tau_xy_v and
//                 eta_tau; no-slip normal faces zeroed
//   5. BC lines : no-slip bottom-row Vx/3 smoothing, then the ghost rows
// Every cross-point dependency of the iteration (new theta at vertices, old
// tau and eta at vertices, old V in eps_xy_c, new stresses in the momentum
// balance, ghosts from updated values) is a launch boundary, so each field is
// updated in place. The TPU kernel's jnp.roll + iota bands become index
// arithmetic and its edge-replicated ghost ring becomes clamped cell indices.
//
// What bounds it on this card: device-memory traffic. The iteration's own
// accounting (justrelax_tpu/utils/bench_kernels.py::vep2d) is ~39 words per
// cell; five unfused launches read and write more than that (each pass
// re-reads its neighbours' fields and the invariant stacks, and four scratch
// fields -- eta_tau, eps_xx, eps_yy, eps_xy -- go through device memory), and
// at 1024^2 one iteration's ~45 arrays (~190 MB in f32) are far past the
// 50 MB L2. Left for later: fusing the launches, and temporal blocking in
// shared memory (k iterations per tile with a k*radius halo, the Hopper form
// of B3's row blocking).

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
  C_PT, C_RHO_GX, C_RHO_GY
};
enum VSlot {
  V_TXX_O, V_TYY_O, V_TXY_O, V_GDT, V_KDT0, V_VISC_A, V_VISC_B, V_IS_PL,
  V_SCALE, V_CCOS, V_SINPHI, V_SINPSI, V_ETAREG, V_PT
};
// no-slip faces (bits of bc_bits); a face without its bit is free-slip
enum { BC_LEFT = 1, BC_RIGHT = 2, BC_BOT = 4, BC_TOP = 8 };

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

template <typename T> struct Fields {
  T *Vx, *Vy, *theta, *P, *txx, *tyy, *txy_c, *txy_v, *eta, *eta_v, *lam,
      *lam_v;
  T *etat, *exx, *eyy, *exy;  // scratch, rewritten every iteration
  const T *cinv, *vinv;
  int nx, ny;
};

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

// ---- 1. cells: eta_tau, divergence, pressure iterate, normal strain rates
template <typename T>
__global__ void __launch_bounds__(256) k_cells_theta(Fields<T> f, Scal<T> s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  if (i >= nx || j >= ny) return;
  const int64_t N = (int64_t)nx * ny;
  const int64_t c = (int64_t)i * ny + j;
  const T* ci = f.cinv;

  const int rows[3] = {max(i - 1, 0), i, min(i + 1, nx - 1)};
  const int cols[3] = {max(j - 1, 0), j, min(j + 1, ny - 1)};
  T et = f.eta[c];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      et = vmax(et, f.eta[(int64_t)rows[a] * ny + cols[b]]);
    }
  }

  const int64_t sx = ny + 2, sy = ny + 1;
  const T dVxdx = (f.Vx[(i + 1) * sx + j + 1] - f.Vx[i * sx + j + 1]) * s.inv_dx;
  const T dVydy = (f.Vy[(i + 1) * sy + j + 1] - f.Vy[(i + 1) * sy + j]) * s.inv_dy;
  const T gv = dVxdx + dVydy;
  const T rhs = -gv + ci[C_QDT * N + c];
  const T psi = T(1) / (T(1) / et + ci[C_GDT * N + c]) * s.r_over_theta;
  f.theta[c] = ((ci[C_P0_KDT * N + c] + rhs) * psi + f.theta[c]) /
               (T(1) + ci[C_KDT_INV * N + c] * psi);
  const T third = T(1.0 / 3.0);
  f.exx[c] = dVxdx - gv * third;
  f.eyy[c] = dVydy - gv * third;
  f.etat[c] = et;
}

// ---- 2. vertices: trial stress, return mapping, tau_xy_v, lambda_v, eta_v
template <typename T, bool CAP>
__global__ void __launch_bounds__(256) k_vertices(Fields<T> f, Scal<T> s,
                                                  int visc_mode) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  if (i > nx || j > ny) return;
  const int64_t NV = (int64_t)(nx + 1) * (ny + 1);
  const int64_t v = (int64_t)i * (ny + 1) + j;
  const T* vi = f.vinv;

  // the 4 cells around the vertex, clamped into the grid
  const int i0 = max(i - 1, 0), i1 = min(i, nx - 1);
  const int j0 = max(j - 1, 0), j1 = min(j, ny - 1);
  const int64_t c00 = (int64_t)i0 * ny + j0, c10 = (int64_t)i1 * ny + j0;
  const int64_t c01 = (int64_t)i0 * ny + j1, c11 = (int64_t)i1 * ny + j1;
  const T q = T(0.25);
  const T Pv = q * (f.theta[c00] + f.theta[c10] + f.theta[c01] + f.theta[c11]);
  const T exx_v = q * (f.exx[c00] + f.exx[c10] + f.exx[c01] + f.exx[c11]);
  const T eyy_v = q * (f.eyy[c00] + f.eyy[c10] + f.eyy[c01] + f.eyy[c11]);
  const T txx_v = q * (f.txx[c00] + f.txx[c10] + f.txx[c01] + f.txx[c11]);
  const T tyy_v = q * (f.tyy[c00] + f.tyy[c10] + f.tyy[c01] + f.tyy[c11]);
  const T eta_vh = T(4) / (T(1) / f.eta[c00] + T(1) / f.eta[c10] +
                           T(1) / f.eta[c01] + T(1) / f.eta[c11]);

  const int64_t sx = ny + 2, sy = ny + 1;
  const T exy = T(0.5) * ((f.Vx[i * sx + j + 1] - f.Vx[i * sx + j]) * s.inv_dy +
                          (f.Vy[(i + 1) * sy + j] - f.Vy[i * sy + j]) * s.inv_dx);
  f.exy[v] = exy;

  const T Gdt = vi[V_GDT * NV + v];
  const T dtau_rv = T(1) / (s.theta_dtau + eta_vh * Gdt + T(1));
  const T dtxx = stress_inc(txx_v, vi[V_TXX_O * NV + v], exx_v, eta_vh, Gdt, dtau_rv);
  const T dtyy = stress_inc(tyy_v, vi[V_TYY_O * NV + v], eyy_v, eta_vh, Gdt, dtau_rv);
  const T txy0 = f.txy_v[v];
  const T dtxy = stress_inc(txy0, vi[V_TXY_O * NV + v], exy, eta_vh, Gdt, dtau_rv);
  const T xy_t = txy0 + dtxy;
  const T xx_t = txx_v + dtxx, yy_t = tyy_v + dtyy;
  const T tII = xsqrt(T(0.5) * (xx_t * xx_t + yy_t * yy_t) + xy_t * xy_t);

  bool yv;
  T lam_new, dQdP;
  plastic_step<T, CAP>(tII, Pv, vi[V_IS_PL * NV + v], vi[V_CCOS * NV + v],
                       vi[V_SINPHI * NV + v], vi[V_SINPSI * NV + v],
                       vi[V_PT * NV + v], vi[V_ETAREG * NV + v],
                       vi[V_KDT0 * NV + v], eta_vh, dtau_rv, f.lam_v[v], s, yv,
                       lam_new, dQdP);
  const T dQdt_xy = vi[V_SCALE * NV + v] * (xy_t / (tII == T(0) ? T(1) : tII));
  const T eps_pl_xy = yv ? lam_new * dQdt_xy : T(0);
  const T txy_new =
      txy0 + (yv ? dtxy - T(2) * eta_vh * eps_pl_xy * dtau_rv : dtxy);
  f.txy_v[v] = txy_new;
  f.lam_v[v] = lam_new;

  // vertex viscosity continuation: tau-mode invariant of (0, 0, tau_xy_v)
  const T tgt = visc_target(visc_mode, vi[V_VISC_A * NV + v],
                            vi[V_VISC_B * NV + v], xabs(txy_new), s);
  f.eta_v[v] = clip(s.relax_v * tgt + s.one_m_relax * f.eta_v[v], s.cut_lo,
                    s.cut_hi);
}

// ---- 3. cells: trial stress, return mapping, P, lambda, eta continuation
template <typename T, bool CAP>
__global__ void __launch_bounds__(256) k_cells_stress(Fields<T> f, Scal<T> s,
                                                      int visc_mode) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  if (i >= nx || j >= ny) return;
  const int64_t N = (int64_t)nx * ny;
  const int64_t c = (int64_t)i * ny + j;
  const T* ci = f.cinv;

  const int64_t v00 = (int64_t)i * (ny + 1) + j, v10 = v00 + (ny + 1);
  const T exy_c = T(0.25) * (f.exy[v00] + f.exy[v10] + f.exy[v00 + 1] + f.exy[v10 + 1]);

  const T eta0 = f.eta[c];
  const T Gdt = ci[C_GDT * N + c];
  const T dtau_r = T(1) / (s.theta_dtau + eta0 * Gdt + T(1));
  const T txx0 = f.txx[c], tyy0 = f.tyy[c], txy0 = f.txy_c[c];
  T xx = txx0 + stress_inc(txx0, ci[C_TXX_O * N + c], f.exx[c], eta0, Gdt, dtau_r);
  T yy = tyy0 + stress_inc(tyy0, ci[C_TYY_O * N + c], f.eyy[c], eta0, Gdt, dtau_r);
  T xy = txy0 + stress_inc(txy0, ci[C_TXYC_O * N + c], exy_c, eta0, Gdt, dtau_r);
  const T tII = xsqrt(T(0.5) * (xx * xx + yy * yy) + xy * xy);

  const T th = f.theta[c];
  bool yc;
  T lam_new, dQdP;
  plastic_step<T, CAP>(tII, th, ci[C_IS_PL * N + c], ci[C_CCOS * N + c],
                       ci[C_SINPHI * N + c], ci[C_SINPSI * N + c],
                       ci[C_PT * N + c], ci[C_ETAREG * N + c],
                       ci[C_KDT0 * N + c], eta0, dtau_r, f.lam[c], s, yc,
                       lam_new, dQdP);
  if (yc) {
    const T ls = lam_new * ci[C_SCALE * N + c];
    const T den = (tII == T(0)) ? T(1) : tII;
    const T corr = T(2) * eta0 * dtau_r;
    xx = xx - corr * (ls * (xx / den));
    yy = yy - corr * (ls * (yy / den));
    xy = xy - corr * (ls * (xy / den));
  }
  f.txx[c] = xx;
  f.tyy[c] = yy;
  f.txy_c[c] = xy;
  f.lam[c] = lam_new;
  f.P[c] = th - ci[C_KDT0 * N + c] * lam_new * dQdP;

  const T tII_new = xsqrt(T(0.5) * (xx * xx + yy * yy) + xy * xy);
  const T tgt = visc_target(visc_mode, ci[C_VISC_A * N + c],
                            ci[C_VISC_B * N + c], tII_new, s);
  f.eta[c] = clip(s.relax_v * tgt + s.one_m_relax * eta0, s.cut_lo, s.cut_hi);
}

// ---- 4. faces: damped velocity update; no-slip normal faces zeroed
template <typename T>
__global__ void __launch_bounds__(256) k_velocity(Fields<T> f, Scal<T> s,
                                                  int bc_bits) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = f.nx, ny = f.ny;
  const int64_t N = (int64_t)nx * ny;
  const int64_t sx = ny + 2, sy = ny + 1, nv = ny + 1;
  const T* rgx = f.cinv + C_RHO_GX * N;
  const T* rgy = f.cinv + C_RHO_GY * N;

  if (i <= nx && j <= ny + 1) {  // Vx (nx+1, ny+2)
    T* vx = f.Vx + i * sx + j;
    if (((bc_bits & BC_LEFT) && i == 0) || ((bc_bits & BC_RIGHT) && i == nx)) {
      *vx = T(0);
    } else if (i >= 1 && i <= nx - 1 && j >= 1 && j <= ny) {
      const int64_t a = (int64_t)(i - 1) * ny + (j - 1), b = a + ny;
      const T rx = (f.txx[b] - f.txx[a]) * s.inv_dx +
                   (f.txy_v[i * nv + j] - f.txy_v[i * nv + j - 1]) * s.inv_dy -
                   (f.P[b] - f.P[a]) * s.inv_dx - T(0.5) * (rgx[b] + rgx[a]);
      const T etax = T(0.5) * (f.etat[b] + f.etat[a]);
      *vx = *vx + rx * s.etadtau / etax;
    }
  }
  if (i <= nx + 1 && j <= ny) {  // Vy (nx+2, ny+1)
    T* vy = f.Vy + i * sy + j;
    if (((bc_bits & BC_BOT) && j == 0) || ((bc_bits & BC_TOP) && j == ny)) {
      *vy = T(0);
    } else if (i >= 1 && i <= nx && j >= 1 && j <= ny - 1) {
      const int64_t a = (int64_t)(i - 1) * ny + (j - 1), b = a + 1;
      const T ry = (f.tyy[b] - f.tyy[a]) * s.inv_dy +
                   (f.txy_v[i * nv + j] - f.txy_v[(i - 1) * nv + j]) * s.inv_dx -
                   (f.P[b] - f.P[a]) * s.inv_dy - T(0.5) * (rgy[b] + rgy[a]);
      const T etay = T(0.5) * (f.etat[b] + f.etat[a]);
      *vy = *vy + ry * s.etadtau / etay;
    }
  }
}

// ---- 5. BC lines: bottom-row Vx/3 smoothing (no-slip), then ghost rows
template <typename T>
__global__ void __launch_bounds__(256) k_bc_lines(Fields<T> f, int bc_bits) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int nx = f.nx, ny = f.ny;
  if (k <= nx) {  // Vx row k: ghost columns 0 and ny+1
    T* row = f.Vx + (int64_t)k * (ny + 2);
    const bool zeroed =
        ((bc_bits & BC_LEFT) && k == 0) || ((bc_bits & BC_RIGHT) && k == nx);
    if ((bc_bits & BC_BOT) && !zeroed) row[1] = row[2] * T(1.0 / 3.0);
    row[0] = (bc_bits & BC_BOT) ? -row[1] : row[1];
    row[ny + 1] = (bc_bits & BC_TOP) ? -row[ny] : row[ny];
  }
  if (k <= ny) {  // Vy column k: ghost rows 0 and nx+1
    const int64_t sy = ny + 1;
    T* Vy = f.Vy;
    Vy[k] = (bc_bits & BC_LEFT) ? -Vy[sy + k] : Vy[sy + k];
    Vy[(nx + 1) * sy + k] =
        (bc_bits & BC_RIGHT) ? -Vy[nx * sy + k] : Vy[nx * sy + k];
  }
}

template <typename T>
int run_chunk(void** carry, void** scratch, const void* cinv, const void* vinv,
              int nx, int ny, int nout, const double* sc, int visc_mode,
              int has_cap, int bc_bits, cudaStream_t stream) {
  Fields<T> f;
  T** c = reinterpret_cast<T**>(carry);
  f.Vx = c[0]; f.Vy = c[1]; f.theta = c[2]; f.P = c[3]; f.txx = c[4];
  f.tyy = c[5]; f.txy_c = c[6]; f.txy_v = c[7]; f.eta = c[8]; f.eta_v = c[9];
  f.lam = c[10]; f.lam_v = c[11];
  T** w = reinterpret_cast<T**>(scratch);
  f.etat = w[0]; f.exx = w[1]; f.eyy = w[2]; f.exy = w[3];
  f.cinv = static_cast<const T*>(cinv);
  f.vinv = static_cast<const T*>(vinv);
  f.nx = nx; f.ny = ny;

  Scal<T> s;
  s.inv_dx = T(sc[0]); s.inv_dy = T(sc[1]); s.etadtau = T(sc[2]);
  s.r_over_theta = T(sc[3]); s.theta_dtau = T(sc[4]);
  s.rel_lambda = T(sc[5]); s.one_m_rel = T(sc[6]);
  s.relax_v = T(sc[7]); s.one_m_relax = T(sc[8]);
  s.cut_lo = T(sc[9]); s.cut_hi = T(sc[10]); s.visc_m = T(sc[11]);

  const dim3 blk(32, 8);
  const dim3 g_cell((ny + 31) / 32, (nx + 7) / 8);
  const dim3 g_vert((ny + 1 + 31) / 32, (nx + 1 + 7) / 8);
  const dim3 g_face((ny + 2 + 31) / 32, (nx + 2 + 7) / 8);
  const int n_line = (nx > ny ? nx : ny) + 1;
  const dim3 g_line((n_line + 255) / 256);

  for (int it = 0; it < nout; ++it) {
    k_cells_theta<T><<<g_cell, blk, 0, stream>>>(f, s);
    if (has_cap) {
      k_vertices<T, true><<<g_vert, blk, 0, stream>>>(f, s, visc_mode);
      k_cells_stress<T, true><<<g_cell, blk, 0, stream>>>(f, s, visc_mode);
    } else {
      k_vertices<T, false><<<g_vert, blk, 0, stream>>>(f, s, visc_mode);
      k_cells_stress<T, false><<<g_cell, blk, 0, stream>>>(f, s, visc_mode);
    }
    k_velocity<T><<<g_face, blk, 0, stream>>>(f, s, bc_bits);
    k_bc_lines<T><<<g_line, 256, 0, stream>>>(f, bc_bits);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). `carry` holds the 12 fields in the
// order Vx, Vy, theta, P, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v;
// `scratch` eta_tau, eps_xx, eps_yy (cells) and eps_xy (vertices); `scal`
// inv_dx, inv_dy, etadtau, r/theta_dtau, theta_dtau, rel_lambda,
// 1-rel_lambda, relax_v, 1-relax_v, cut_lo, cut_hi, visc_m. Launches on
// `stream` without synchronising; returns the first launch error, or 0.
extern "C" int jr_stokes_vep_chunk_f32(void** carry, void** scratch,
                                       const void* cinv, const void* vinv,
                                       int nx, int ny, int nout,
                                       const double* scal, int visc_mode,
                                       int has_cap, int bc_bits, void* stream) {
  return run_chunk<float>(carry, scratch, cinv, vinv, nx, ny, nout, scal,
                          visc_mode, has_cap, bc_bits, (cudaStream_t)stream);
}

extern "C" int jr_stokes_vep_chunk_f64(void** carry, void** scratch,
                                       const void* cinv, const void* vinv,
                                       int nx, int ny, int nout,
                                       const double* scal, int visc_mode,
                                       int has_cap, int bc_bits, void* stream) {
  return run_chunk<double>(carry, scratch, cinv, vinv, nx, ny, nout, scal,
                           visc_mode, has_cap, bc_bits, (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
