// The 3D visco-elasto-plastic (VEP) pseudo-transient iteration, hand-written
// for Hopper (sm_90a): its three edge return-mapping passes alone, and the
// whole iteration fused into a chunk.
//
// Replaces three TPU kernels:
//   B6  justrelax_tpu/ops/pallas_vep3d_edges.py::vep3d_edges_blocked
//       (the three edge families in one pass, the old-stress interpolants
//       re-derived from the nine tau_o canvases): k_edges<T, false, TOC>;
//   B9  justrelax_tpu/ops/pallas_vep3d_edges.py::vep3d_edges_split
//       (one launch per family, the six old-stress interpolants of the family
//       hoisted into const canvases): k_edges<T, true, false>, the three
//       families in one launch (the TPU split only shrank VMEM);
//   B8  justrelax_tpu/ops/pallas_stokes3d_vep_blocked.py::
//       stokes3d_vep_chunk_blocked (nout fused iterations of
//       ops/stokes3d_vep_canvas.py::iteration_vep3d_canvas on the 19 carry
//       canvases): k_cells, k_stress and k_velocity, launched in turn once
//       per iteration.
//
// The edge passes compute what the edge passes of
// justrelax_tpu_torch/ops/stokes3d_vep.py::update_stresses_center_edges_3d
// compute on the collocated canvases of ops/stokes3d_vep_canvas.py: for each
// shear-edge family k (0 = yz, 1 = xz, 2 = xy) on the slots it owns (its
// normal axis 1..n, its two edge axes 0..n), the visco-elastic trial stress
// from the six stress and strain-rate components interpolated to the edge,
// the Drucker-Prager yield test, the relaxed plastic multiplier lambda_k and
// the corrected shear stress tau_k. In B6/B9 the center pass, theta/P, the
// viscosity continuation and the velocity update stay in PyTorch; both read
// the pre-iteration state (a Jacobi update), so the split is exact.
//
// Every output is written at every slot: the new value where the slot is
// updated, the input's value elsewhere. The canvas moves of the plain
// version become closed-form index clamps (ops/stokes3d_vep.py::serial_moves):
//   center -> edge k : the 2x2 average over k's edge axes of the center
//                      values at clamp(j, 1, n) and clamp(j+1, 1, n) (the
//                      ghost refresh), first along the lower axis;
//   family m -> edge k: along k's normal axis (m's own staggered axis) the
//                      pair j-1, min(j, n-1) (the center-count clamp never
//                      reads m's outermost face), along m's normal axis the
//                      pair clamp(q, 1, n), clamp(q+1, 1, n), along the
//                      shared axis the index min(p, n-1).
// Only the three normal components of tau_c reach the edge passes.
//
// The chunk (B8) runs each iteration in three launches, from the carry A to
// the carry B (the wrapper alternates two work sets, so the input carry is
// never written):
//   k_cells    the maxloc preconditioner eta_tau (the 3x3x3 max of eta over
//              clamped indices, into a scratch canvas) and the new pressure
//              iterate theta at the cells;
//   k_stress   the center return mapping (tau_c x6, lambda, the corrected
//              P), the viscosity continuation eta, and the three edge
//              passes (run_family, B6's form) on the new theta. A block
//              takes an 8 x 32 tile of slots of one x plane: it computes the
//              strain rates (and 1/eta at the cells) of the tile and a halo
//              of one slot on three x planes into shared memory, each point
//              once, and the passes read them there;
//   k_velocity the damped velocity update on the interior faces; a ghost
//              slot's thread computes the value of the slot the free-slip
//              mirrors copy into it (the tangential axes clamped to 1..n),
//              which is the serial order's result (front/back, top/bot,
//              left/right act on different axes).
//
// Constants: each canvas constant is a pointer or, where it holds one value
// over the slots it is read on, that value (the wrappers decide once per
// chunk); K and the nine Drucker-Prager parameters are scalars under the
// phase-uniform guard of ops/hopper_vep3d_edges.py::vep3d_blocked_supported.
// K = infinity drops the volume term by a test, not a product (inf * 0 =
// NaN). The tension cap follows rheology/plasticity.py: pT = 0 means no cap.
//
// What bounds them on this card. The edge passes (B6, B9) read at least 14
// words per slot (V x3, theta, eta, tau_c normals x3, tau_e x3, lambda_e x3)
// and write 6, plus each non-uniform constant (G_e x3, and tau_o: 6 canvases
// re-derived in B6, 18 hoisted in B9), about 1.0 GFLOP at 126^3 against
// 0.18 GB: bound by bytes, 55 us at 23 words. But neither kernel comes near
// that: the one-thread-per-slot form re-derived every strain rate and 1/eta
// at each of its ~40 reads per slot and took 0.24 ms, and with the strain
// rates read from precomputed canvases still 0.18 ms; its arithmetic and
// 64-bit-indexed loads, not its bytes, set the time (PERF.md §6). So
// k_edges marches a (y, z) tile along x: it stages each plane once by
// cp.async, computes each strain rate and 1/eta once per point into rings,
// reads them by 32-bit ring offsets computed once per slot and plane, and
// runs the three families of a slot in three threads, so that three
// independent dependency chains of divisions and roots hide each other's
// latency. Its march alone (staging, strain rates, barriers) takes ~0.07 ms
// at 126^3 f32, the families ~0.1 ms more. One chunk iteration (B8)
// reads the 19 carry canvases and writes 19, plus its non-uniform constants.
// B8's stress pass is bound by its arithmetic, not by that traffic: on the
// card it took as long with every field it reads staged in shared memory as
// through the caches, and each IEEE division left out moved it (PERF.md §6).
// So it computes each strain rate and 1/eta once per point, and the branches
// of the return mapping leave out what they do not use: the multiplier and
// the plastic correction where a point does not yield, the tension cap's
// divisions and roots where there is none (each value unchanged).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_DYN = 14;   // Vx Vy Vz theta eta tc0..2 te0..2 le0..2
constexpr int N_OUT = 6;    // te0..2 le0..2
constexpr int N_PP = 9;     // is_pl pl_frac C_cosphi sinphi cosphi sinpsi eta_reg pT dq_shear

template <typename T> struct Args {
  const T *Vx, *Vy, *Vz, *theta, *eta;
  const T* tc[3];
  const T* te[3];
  const T* le[3];
  T* ote[3];
  T* ole[3];
  const T* G[3];       // nullptr: the scalar Gv
  T Gv[3];
  const T* to[3][6];   // per family the six old-stress sources; nullptr: tov
  T tov[3][6];
  T inv[3];            // 1/dx, 1/dy, 1/dz
  T dt, theta_dtau, rel, one_minus_rel;
  T pl_frac, C_cosphi, sinphi, sinpsi, eta_reg, pT, K;
  bool is_pl;
  int n[3];
  int64_t st[3];       // strides of x, y, z (z = 1)
};

template <typename T> __device__ __forceinline__ T xsqrt(T a);
template <> __device__ __forceinline__ float xsqrt(float a) { return sqrtf(a); }
template <> __device__ __forceinline__ double xsqrt(double a) { return sqrt(a); }

// NaN-propagating helpers, as torch.minimum / torch.clamp
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T clamp_lo(T a, T lo) {
  return a < lo ? lo : a;
}
template <typename T> __device__ __forceinline__ T clamp01(T a) {
  return a < T(0) ? T(0) : (a > T(1) ? T(1) : a);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ bool is_inf(float a) { return isinf(a); }
__device__ __forceinline__ bool is_inf(double a) { return isinf(a); }

template <typename T>
__device__ __forceinline__ T at(const T* p, T v, int64_t i) {
  return p ? p[i] : v;
}

// 0.5 * (0.5 * (a + b) + 0.5 * (c + d)): a pair average along the first
// axis, then along the second
template <typename T>
__device__ __forceinline__ T avg4(T a, T b, T c, T d) {
  return T(0.5) * (T(0.5) * (a + b) + T(0.5) * (c + d));
}

template <typename T>
__device__ __forceinline__ int64_t lin(const Args<T>& g, const int* s) {
  return s[0] * g.st[0] + s[1] * g.st[1] + s[2];
}

// deviatoric normal strain rates from the velocity differences along x, y, z
template <typename T>
__device__ __forceinline__ void deviatoric(const Args<T>& g, T ux, T uy, T uz, T* e) {
  const T dx = ux * g.inv[0];
  const T dy = uy * g.inv[1];
  const T dz = uz * g.inv[2];
  const T gv = dx + dy + dz;
  const T third = T(1.0 / 3.0);
  e[0] = dx - gv * third;
  e[1] = dy - gv * third;
  e[2] = dz - gv * third;
}

// a shear strain rate from its two velocity differences u and w and the
// inverse spacings they are taken over
template <typename T>
__device__ __forceinline__ T shear_of(T u, T iu, T w, T iw) {
  return T(0.5) * (u * iu + w * iw);
}

// deviatoric normal strain rates at a cell slot
template <typename T>
__device__ __forceinline__ void normal_strain(const Args<T>& g, int64_t p, T* e) {
  deviatoric(g, g.Vx[p] - g.Vx[p - g.st[0]], g.Vy[p] - g.Vy[p - g.st[1]],
             g.Vz[p] - g.Vz[p - 1], e);
}

// shear strain rate of family m at an edge slot of that family
template <typename T>
__device__ __forceinline__ T shear_strain(const Args<T>& g, int m, int64_t p) {
  const int64_t sx = g.st[0], sy = g.st[1];
  if (m == 0) return shear_of(g.Vy[p + 1] - g.Vy[p], g.inv[2], g.Vz[p + sy] - g.Vz[p], g.inv[1]);
  if (m == 1) return shear_of(g.Vx[p + 1] - g.Vx[p], g.inv[2], g.Vz[p + sx] - g.Vz[p], g.inv[0]);
  return shear_of(g.Vx[p + sy] - g.Vx[p], g.inv[1], g.Vy[p + sx] - g.Vy[p], g.inv[0]);
}

template <typename T>
__device__ __forceinline__ T avg_at(const T* A, T v, const int64_t* q) {
  if (!A) return v;   // a uniform source: its average is the value itself
  return avg4(A[q[0]], A[q[1]], A[q[2]], A[q[3]]);
}

// The edge passes read the fields they interpolate through a view: the
// rings of the edge kernel's march (B6, B9) or the staged window of the
// fused chunk's stress pass (B8). A view maps canvas coordinates to its own
// index and reads through it.

// the canvas coordinates of the four cells the center -> edge K average
// reads, in avg4 order
template <int K>
__device__ __forceinline__ void center_points(const int* n, const int* s, int (*c)[3]) {
  constexpr int A0 = K == 0 ? 1 : 0;   // lower edge axis
  constexpr int A1 = K == 2 ? 1 : 2;   // upper edge axis
  const int u0 = clampi(s[A0], 1, n[A0]), u1 = clampi(s[A0] + 1, 1, n[A0]);
  const int w0 = clampi(s[A1], 1, n[A1]), w1 = clampi(s[A1] + 1, 1, n[A1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j][0] = s[0]; c[j][1] = s[1]; c[j][2] = s[2];
    c[j][A0] = (j & 1) ? u1 : u0;
    c[j][A1] = (j & 2) ? w1 : w0;
  }
}

// the coordinates of the four slots of family M that the M -> K move
// reads, in avg4 order
template <int K, int M>
__device__ __forceinline__ void other_points(const int* n, const int* s, int (*c)[3]) {
  constexpr int SO = K;              // K's normal axis: M's own staggered axis
  constexpr int DO = M;              // M's normal axis: K's own staggered axis
  constexpr int SH = 3 - K - M;      // the shared staggered axis
  const int jl = s[SO] - 1, jh = min(s[SO], n[SO] - 1);
  const int q0 = clampi(s[DO], 1, n[DO]), q1 = clampi(s[DO] + 1, 1, n[DO]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j][SH] = min(s[SH], n[SH] - 1);
    c[j][SO] = (j & 1) ? jh : jl;
    c[j][DO] = (j & 2) ? q1 : q0;
  }
}

// A view's indices of the four cells of the center -> edge K average and of
// the four slots of the M -> K move at slot s, from their coordinates (a
// view with its own rule overloads these)
template <int K, class V, class I>
__device__ __forceinline__ void centers(const V& v, const int* n, const int* s, I* w) {
  int c[4][3];
  center_points<K>(n, s, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = v.at(c[j]);
}
template <int K, int M, class V, class I>
__device__ __forceinline__ void others(const V& v, const int* n, const int* s, I* w) {
  int c[4][3];
  other_points<K, M>(n, s, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = v.at(c[j]);
}

// Family M's shear stress, strain rate and (unless hoisted) old stress
// moved onto edge K at slot s, into slot 3 + M of the six-component tuples.
template <typename T, int K, int M, bool HOIST, class V>
__device__ __forceinline__ void other_family(const Args<T>& g, const V& v, const int* s,
                                             T* t6, T* e6, T* o6) {
  typename V::Index w[4];
  others<K, M>(v, g.n, s, w);
  t6[3 + M] = avg4(v.te(M, w[0]), v.te(M, w[1]), v.te(M, w[2]), v.te(M, w[3]));
  e6[3 + M] = avg4(v.shear(M, w[0]), v.shear(M, w[1]), v.shear(M, w[2]), v.shear(M, w[3]));
  if (!HOIST) o6[3 + M] = v.old4(K, 3 + M, w);
}

// The Drucker-Prager cone with the optional tension cap (pT = 0: none) at
// pressure Pv and trial invariant tII: the yield function F, the flow
// gradient dQ/dP and the volume term K dt dF/dP dQ/dP of the multiplier's
// denominator (rheology/plasticity.py: yield_function, flow_gradients_P).
template <typename T>
__device__ __forceinline__ void drucker_prager(const Args<T>& g, T Pv, T tII, T& F, T& dQdP,
                                               T& volume) {
  const T cone = g.C_cosphi + Pv * g.sinphi;
  if (g.pT == T(0) && Pv - Pv == T(0)) {
    // no cap and a finite Pv: ratio = 0 and root = 1 below, so the cap is
    // C cos(phi) under tension and dF/dP on it (C Pv) / inf = 0 (C Pv)
    const T cap = Pv < T(0) ? g.C_cosphi : T(INFINITY);
    F = tII - tmin(cone, cap);
    const T dFdP_cap = T(0) * (g.C_cosphi * Pv);
    const bool on_cap = cap < cone;
    const T dFdP = on_cap ? dFdP_cap : -g.sinphi;
    dQdP = on_cap ? dFdP_cap : -g.sinpsi;
    volume = is_inf(g.K) ? T(0) : g.K * g.dt * dFdP * dQdP;
    return;
  }
  const T pT = g.pT == T(0) ? T(-INFINITY) : g.pT;
  const T ratio = clamp01(Pv / pT);
  const T cap = Pv < T(0) ? g.C_cosphi * xsqrt(clamp_lo(T(1) - ratio * ratio, T(0)))
                          : T(INFINITY);
  F = tII - tmin(cone, cap);
  const T root = xsqrt(clamp_lo(T(1) - ratio * ratio, T(1e-12)));
  const T dFdP_cap = g.C_cosphi * Pv / (is_inf(pT) ? T(INFINITY) : pT * pT) / root;
  const bool on_cap = cap < cone;
  const T dFdP = on_cap ? dFdP_cap : -g.sinphi;
  dQdP = on_cap ? dFdP_cap : -g.sinpsi;
  volume = is_inf(g.K) ? T(0) : g.K * g.dt * dFdP * dQdP;
}

// The second invariant of a six-component tuple (xx, yy, zz, yz, xz, xy).
template <typename T>
__device__ __forceinline__ T inv_II(const T* t) {
  return xsqrt(T(0.5) * (t[0] * t[0] + t[1] * t[1] + t[2] * t[2]) + t[3] * t[3] +
               t[4] * t[4] + t[5] * t[5]);
}

// One family's return mapping at an owned slot s (canvas index i, view
// index vi).
template <typename T, int K, bool HOIST, class V>
__device__ void family(const Args<T>& g, const V& v, const int* s, int64_t i,
                       typename V::Index vi, T& t_new, T& lam_new) {
  typename V::Index wc[4];
  centers<K>(v, g.n, s, wc);
  const T Pv = avg4(v.theta(wc[0]), v.theta(wc[1]), v.theta(wc[2]), v.theta(wc[3]));
  const T eta_e = T(1) / avg4(v.inv_eta(wc[0]), v.inv_eta(wc[1]), v.inv_eta(wc[2]),
                              v.inv_eta(wc[3]));
  const T Ge = at(g.G[K], g.Gv[K], i);
  const T Gedt = T(1) / (Ge * g.dt);
  const T dtau = T(1) / (g.theta_dtau + eta_e * Gedt + T(1));

  T t6[6], e6[6], o6[6];
  {
    T e4[4][3];
#pragma unroll
    for (int c = 0; c < 4; ++c) v.normal(wc[c], e4[c]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t6[j] = avg4(v.tc(j, wc[0]), v.tc(j, wc[1]), v.tc(j, wc[2]), v.tc(j, wc[3]));
      e6[j] = avg4(e4[0][j], e4[1][j], e4[2][j], e4[3][j]);
    }
  }
  if (!HOIST) {
#pragma unroll
    for (int j = 0; j < 3; ++j) o6[j] = v.old4(K, j, wc);
  }
  // the family's own shear lives here
  t6[3 + K] = v.te(K, vi);
  e6[3 + K] = v.shear(K, vi);
  if (!HOIST) o6[3 + K] = at(g.to[K][3 + K], g.tov[K][3 + K], i);
  // the two other families interpolate over
  other_family<T, K, (K + 1) % 3, HOIST>(g, v, s, t6, e6, o6);
  other_family<T, K, (K + 2) % 3, HOIST>(g, v, s, t6, e6, o6);
  if (HOIST) {
#pragma unroll
    for (int j = 0; j < 6; ++j) o6[j] = at(g.to[K][j], g.tov[K][j], i);
  }

  // visco-elastic trial stress
  T d6[6], tr[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    d6[j] = dtau * (T(2) * eta_e * e6[j] - (t6[j] - o6[j]) * eta_e * Gedt - t6[j]);
    tr[j] = t6[j] + d6[j];
  }
  const T tII = inv_II(tr);

  T F, dQdP, volume;
  drucker_prager(g, Pv, tII, F, dQdP, volume);
  const bool yld = g.is_pl && tII != T(0) && F > T(0);

  // the multiplier and the plastic correction, where the slot yields
  lam_new = g.le[K][i];
  const T d_own = d6[3 + K];
  if (yld) {
    lam_new = g.one_minus_rel * lam_new +
              g.rel * (clamp_lo(F, T(0)) / (eta_e * dtau + g.eta_reg + volume));
    const T dQdt = g.pl_frac * T(0.5) * (tr[3 + K] / (tII == T(0) ? T(1) : tII));
    const T e_pl = lam_new * dQdt;
    t_new = t6[3 + K] + (d_own - T(2) * eta_e * e_pl * dtau);
  } else {
    t_new = t6[3 + K] + d_own;
  }
}

template <typename T, int K>
__device__ __forceinline__ bool owned(const Args<T>& g, const int* s) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int lo = ax == K ? 1 : 0;
    if (s[ax] < lo || s[ax] > g.n[ax]) return false;
  }
  return true;
}

// Family K at slot s: the new tau_e and lambda_e where K owns the slot, the
// input's values elsewhere
template <typename T, int K, bool HOIST, class V>
__device__ __forceinline__ void run_family(const Args<T>& g, const V& v, const int* s,
                                           int64_t i, typename V::Index vi) {
  T t = v.te(K, vi), l = g.le[K][i];
  if (owned<T, K>(g, s)) family<T, K, HOIST>(g, v, s, i, vi, t, l);
  g.ote[K][i] = t;
  g.ole[K][i] = l;
}

// ---- the edge passes (B6, B9): (y, z) tiles marching along x -------------

// The block's windows in a plane, both with the origin one slot below the
// tile in y and z: the velocity window (the tile and one slot below, two
// above: V is read up to two slots past a slot) and the field window (the
// tile and one slot around it: what the families read).
struct EdgeLayout {
  // a block's tile: TY x TZ (y, z) slots, three threads each (one per family)
  static constexpr int TY = 4, TZ = 32, NT = TY * TZ;
  static constexpr int NTH = 3 * NT;  // threads
  static constexpr int VZ = TZ + 3, NV = (TY + 3) * VZ;
  static constexpr int WZ = TZ + 2, NW = (TY + 2) * WZ;
  // window points per thread
  static constexpr int RV = (NV + NTH - 1) / NTH, RW = (NW + NTH - 1) / NTH;
};
// Ring depths, in planes. Step k of the march reads the cell fields of
// planes k, k+1 and the edge fields of k-1..k+1 (the families of plane k),
// writes the strain rates of plane k+2 from V of planes k+1..k+3, and
// stages V of plane k+4 and the other fields of plane k+3: V and the cell
// fields four planes deep, the edge fields five, or eight where that fits
// (a power of two makes each ring slot a mask, not a remainder, and
// every thread computes ten of them per plane; with tau_o staged the
// larger ring slowed the kernel, PERF.md §6). The cell fields: theta,
// eta (then 1/eta), the normal tau_c x3 staged, the normal strain rates x3
// computed, and with TOC the normal tau_o_c x3 staged; the edge fields:
// tau_e x3 staged, the shear strain rates x3 computed, and with TOC
// tau_o_e x3 staged.
constexpr int DV = 4, DC = 4;
template <bool TOC> __host__ __device__ constexpr int edge_depth() { return TOC ? 5 : 8; }
// the ring slot of plane p (p >= -D) in a ring D planes deep
template <int D> __device__ __forceinline__ int ring(int p) {
  return static_cast<int>(static_cast<unsigned>(p + D) % D);
}
enum CellField { CF_TH, CF_ETA, CF_TC, CF_EN = CF_TC + 3, CF_TO = CF_EN + 3 };
enum EdgeField { EF_TE, EF_ES = 3, EF_TO = 6 };
template <bool TOC> __host__ __device__ constexpr int n_cell_fields() {
  return CF_TO + (TOC ? 3 : 0);
}
template <bool TOC> __host__ __device__ constexpr int n_edge_fields() {
  return EF_TO + (TOC ? 3 : 0);
}
template <typename T, bool TOC> constexpr size_t edge_smem() {
  using L = EdgeLayout;
  return (3 * DV * L::NV +
          (n_cell_fields<TOC>() * DC + n_edge_fields<TOC>() * edge_depth<TOC>()) * L::NW) *
         sizeof(T);
}
// The resident blocks per SM the registers are capped for: f32 two (80
// registers, no spills; three would cap them at 56 and spill), f64 one
template <typename T> constexpr int edge_min_blocks() { return sizeof(T) == 4 ? 2 : 1; }

// Staging copy: cp.async of one element from device to shared memory, no
// registers and no wait until cp_async_wait_all
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

// The march's view for the families of plane a: every field they read at a
// point other than their slot's own device-memory inputs (lambda_e, G_e,
// the hoisted tau_o) comes from the rings, by 32-bit indices into the field
// window: the cell fields of planes a, a+1 and the edge fields of planes
// a-1..a+1. A point's index is the sum of an x, a y and a z offset, each
// picked by the point's role on that axis (the clamps of center_points and
// other_points): the slot's own coordinate s, clamp(s, 1, n),
// clamp(s + 1, 1, n), s - 1 or min(s, n - 1). The y and z offsets depend
// on the slot alone and the x offsets on the plane alone, so a thread
// computes the ten of them once per plane, not once per point read. Scalar
// tau_o sources are their value.
enum Role { R_S, R_C0, R_C1, R_M1, R_MIN, N_ROLE };

template <typename T, bool TOC> struct RingView {
  using L = EdgeLayout;
  static constexpr int DE = edge_depth<TOC>();
  struct Index {
    int c, e;  // cell-ring and edge-ring offsets
  };
  const Args<T>& g;
  const T* cr;          // [cell fields][DC][NW]
  const T* er;          // [edge fields][DE][NW]
  const int* ry;        // [N_ROLE] window row of each y role, times WZ
  const int* cz;        // [N_ROLE] window column of each z role
  int xc[N_ROLE];       // cell-ring plane offset of each x role (R_S, R_C0, R_C1)
  int xe[N_ROLE];       // edge-ring plane offset of each x role
  __device__ Index own() const {
    return {xc[R_S] + ry[R_S] + cz[R_S], xe[R_S] + ry[R_S] + cz[R_S]};
  }
  template <int K> __device__ void centers(Index* w) const {
    constexpr int A0 = K == 0 ? 1 : 0, A1 = K == 2 ? 1 : 2;  // as center_points
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r[3] = {R_S, R_S, R_S};
      r[A0] = (j & 1) ? R_C1 : R_C0;
      r[A1] = (j & 2) ? R_C1 : R_C0;
      w[j] = {xc[r[0]] + ry[r[1]] + cz[r[2]], 0};
    }
  }
  template <int K, int M> __device__ void others(Index* w) const {
    constexpr int SO = K, DO = M, SH = 3 - K - M;  // as other_points
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r[3];
      r[SH] = R_MIN;
      r[SO] = (j & 1) ? R_MIN : R_M1;
      r[DO] = (j & 2) ? R_C1 : R_C0;
      w[j] = {0, xe[r[0]] + ry[r[1]] + cz[r[2]]};
    }
  }
  __device__ T cell(int f, Index p) const { return cr[f * DC * L::NW + p.c]; }
  __device__ T edge(int f, Index p) const { return er[f * DE * L::NW + p.e]; }
  __device__ T theta(Index p) const { return cell(CF_TH, p); }
  __device__ T inv_eta(Index p) const { return cell(CF_ETA, p); }
  __device__ T tc(int j, Index p) const { return cell(CF_TC + j, p); }
  __device__ T te(int m, Index p) const { return edge(EF_TE + m, p); }
  __device__ void normal(Index p, T* e) const {
#pragma unroll
    for (int j = 0; j < 3; ++j) e[j] = cell(CF_EN + j, p);
  }
  __device__ T shear(int m, Index p) const { return edge(EF_ES + m, p); }
  __device__ T old4(int k, int j, const Index* w) const {
    if (!TOC || !g.to[k][j]) return g.tov[k][j];
    if (j < 3) return avg4(cell(CF_TO + j, w[0]), cell(CF_TO + j, w[1]), cell(CF_TO + j, w[2]),
                           cell(CF_TO + j, w[3]));
    return avg4(edge(EF_TO + j - 3, w[0]), edge(EF_TO + j - 3, w[1]),
                edge(EF_TO + j - 3, w[2]), edge(EF_TO + j - 3, w[3]));
  }
};
template <int K, typename T, bool TOC, class I>
__device__ __forceinline__ void centers(const RingView<T, TOC>& v, const int*, const int*,
                                        I* w) {
  v.template centers<K>(w);
}
template <int K, int M, typename T, bool TOC, class I>
__device__ __forceinline__ void others(const RingView<T, TOC>& v, const int*, const int*,
                                       I* w) {
  v.template others<K, M>(w);
}

// The edge passes. A block owns a TY x TZ tile of (y, z) slots over a range
// of x planes [A0, A1) and marches along it, three threads per slot (one
// per family); step k, between one barrier and the next:
//   - cp.async of V of plane k+4 and of the staged fields of plane k+3
//     into ring slots no one reads in this step;
//   - the strain rates of plane k+2 at every field-window point where the
//     families read them (the normal ones and 1/eta at the cells, the shear
//     ones at the edges), each point once, into the rings;
//   - the families of the mask at the slots of plane k: the new tau_e and
//     lambda_e where a family owns the slot, the input's values elsewhere.
// HOIST: the six old-stress sources of each family are its hoisted
// interpolants, read at the slot (B9); else the normal tau_o_c and tau_o_e,
// averaged as the stresses are (B6), staged where TOC.
template <typename T, bool HOIST, bool TOC>
__global__ void __launch_bounds__(EdgeLayout::NTH, edge_min_blocks<T>())
    k_edges(const Args<T> g, int mask, int xc) {
  using L = EdgeLayout;
  constexpr int TY = L::TY, TZ = L::TZ, NT = L::NT, NTH = L::NTH, VZ = L::VZ, NV = L::NV,
                WZ = L::WZ, NW = L::NW, DE = edge_depth<TOC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vr = reinterpret_cast<T*>(smem_raw);       // [Vx, Vy, Vz][DV][NV]
  T* cr = vr + 3 * DV * NV;                      // [cell fields][DC][NW]
  T* er = cr + n_cell_fields<TOC>() * DC * NW;  // [edge fields][DE][NW]

  const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
  const int X = nx + 2, Y = ny + 2, Z = nz + 2;
  const int64_t sx = g.st[0];
  // block -> (x range, y tile, z tile), z fastest
  const int ntz = (Z + TZ - 1) / TZ, nty = (Y + TY - 1) / TY;
  const int tz = blockIdx.x % ntz, ty = (blockIdx.x / ntz) % nty;
  const int tx = blockIdx.x / (ntz * nty);
  const int B0 = ty * TY, C0 = tz * TZ;
  const int A0 = tx * xc, A1 = min(A0 + xc, X);
  const int b_lo = B0 - 1, c_lo = C0 - 1;
  const int t = threadIdx.x;
  const T* const V[3] = {g.Vx, g.Vy, g.Vz};

  // this thread's points of the velocity window (staging) and of the field
  // window (staging and strain rates); out of the canvas: no point
  int gv[L::RV], gw[L::RW];  // in-plane offsets in the canvas
  int qw[L::RW], qv[L::RW];
  bool in_v[L::RV], in_w[L::RW], cell_yz[L::RW], edge_yz[L::RW];
#pragma unroll
  for (int r = 0; r < L::RV; ++r) {
    const int q = t + r * NTH, b = b_lo + q / VZ, c = c_lo + q % VZ;
    in_v[r] = q < NV && b >= 0 && b < Y && c >= 0 && c < Z;
    gv[r] = b * Z + c;
  }
#pragma unroll
  for (int r = 0; r < L::RW; ++r) {
    const int q = t + r * NTH, wb = q / WZ, wc = q % WZ, b = b_lo + wb, c = c_lo + wc;
    in_w[r] = q < NW && b >= 0 && b < Y && c >= 0 && c < Z;
    // cells below the tile's window row 1 are never read (their strain
    // rates would need V one row outside the velocity window)
    cell_yz[r] = in_w[r] && wb >= 1 && wc >= 1 && b <= ny && c <= nz;
    edge_yz[r] = in_w[r] && b <= ny && c <= nz;
    gw[r] = b * Z + c;
    qw[r] = q;
    qv[r] = wb * VZ + wc;
  }

  // cp.async of V of plane p, and of the staged cell and edge fields of plane p
  auto stage_v = [&](int p) {
#pragma unroll
    for (int r = 0; r < L::RV; ++r) {
      if (!in_v[r]) continue;
      const int q = t + r * NTH;
      for (int f = 0; f < 3; ++f)
        cp_async_elem(vr + (f * DV + ring<DV>(p)) * NV + q, V[f] + p * sx + gv[r]);
    }
  };
  auto stage_fields = [&](int p) {
    const bool pc = p >= 1 && p <= nx;
#pragma unroll
    for (int r = 0; r < L::RW; ++r) {
      if (!in_w[r]) continue;
      const int64_t i = p * sx + gw[r];
      T* ce = cr + ring<DC>(p) * NW + qw[r];
      T* ed = er + ring<DE>(p) * NW + qw[r];
      if (pc && cell_yz[r]) {
        cp_async_elem(ce + CF_TH * DC * NW, g.theta + i);
        cp_async_elem(ce + CF_ETA * DC * NW, g.eta + i);
        for (int j = 0; j < 3; ++j) cp_async_elem(ce + (CF_TC + j) * DC * NW, g.tc[j] + i);
        if (TOC)
          for (int j = 0; j < 3; ++j)
            if (g.to[0][j]) cp_async_elem(ce + (CF_TO + j) * DC * NW, g.to[0][j] + i);
      }
      for (int m = 0; m < 3; ++m) cp_async_elem(ed + (EF_TE + m) * DE * NW, g.te[m] + i);
      if (TOC && p <= nx && edge_yz[r])
        for (int m = 0; m < 3; ++m)
          if (g.to[0][3 + m]) cp_async_elem(ed + (EF_TO + m) * DE * NW, g.to[0][3 + m] + i);
    }
  };
  // the strain rates (and 1/eta) of plane p from V of planes p-1..p+1
  auto strain_rates = [&](int p) {
    const int o0 = ring<DV>(p) * NV, o1 = ring<DV>(p + 1) * NV;
    const T* Vx = vr;
    const T* Vy = vr + DV * NV;
    const T* Vz = vr + 2 * DV * NV;
#pragma unroll
    for (int r = 0; r < L::RW; ++r) {
      const int v0 = o0 + qv[r];
      T* ce = cr + ring<DC>(p) * NW + qw[r];
      if (p >= 1 && p <= nx && cell_yz[r]) {
        const int vm = ring<DV>(p - 1) * NV + qv[r];
        T e[3];
        deviatoric(g, Vx[v0] - Vx[vm], Vy[v0] - Vy[v0 - VZ], Vz[v0] - Vz[v0 - 1], e);
        for (int j = 0; j < 3; ++j) ce[(CF_EN + j) * DC * NW] = e[j];
        ce[CF_ETA * DC * NW] = T(1) / ce[CF_ETA * DC * NW];
      }
      if (p <= nx && edge_yz[r]) {
        const int v1 = o1 + qv[r];
        T* es = er + (EF_ES * DE + ring<DE>(p)) * NW + qw[r];
        es[0] = shear_of(Vy[v0 + 1] - Vy[v0], g.inv[2], Vz[v0 + VZ] - Vz[v0], g.inv[1]);
        es[DE * NW] = shear_of(Vx[v0 + 1] - Vx[v0], g.inv[2], Vz[v1] - Vz[v0], g.inv[0]);
        es[2 * DE * NW] = shear_of(Vx[v0 + VZ] - Vx[v0], g.inv[1], Vy[v1] - Vy[v0], g.inv[0]);
      }
    }
  };

  // the slot and family of this thread (a warp's threads share a family)
  const int fam = t / NT, sb = B0 + (t % NT) / TZ, sc = C0 + t % TZ;
  const bool slot = sb < Y && sc < Z && (mask >> fam & 1);
  const int gs = sb * Z + sc;
  // its window rows and columns of each role
  const int ry[N_ROLE] = {(sb - b_lo) * WZ, (clampi(sb, 1, ny) - b_lo) * WZ,
                          (clampi(sb + 1, 1, ny) - b_lo) * WZ, (sb - 1 - b_lo) * WZ,
                          (min(sb, ny - 1) - b_lo) * WZ};
  const int cz[N_ROLE] = {sc - c_lo, clampi(sc, 1, nz) - c_lo, clampi(sc + 1, 1, nz) - c_lo,
                          sc - 1 - c_lo, min(sc, nz - 1) - c_lo};

  // the march: the families of plane A0 need the strain rates of planes
  // A0-1..A0+1, so it starts three planes before the range; it stages as
  // far as the strain rates of plane A1
  const int k0 = A0 - 3;
  const int last_v = min(A1 + 1, X - 1), last_f = min(A1, X - 1);
  for (int p = max(k0 + 1, 0); p <= min(k0 + 3, last_v); ++p) stage_v(p);
  if (k0 + 2 >= 0 && k0 + 2 <= last_f) stage_fields(k0 + 2);
  for (int k = k0; k < A1; ++k) {
    cp_async_wait_all();
    __syncthreads();
    if (k + 4 <= last_v) stage_v(k + 4);
    if (k + 3 >= 0 && k + 3 <= last_f) stage_fields(k + 3);
    if (k + 2 >= 0 && k + 2 <= last_f) strain_rates(k + 2);
    if (k >= A0 && slot) {
      const int s[3] = {k, sb, sc};
      const int64_t i = k * sx + gs;
      // the ring planes of each role
      const int x[N_ROLE] = {k, clampi(k, 1, nx), clampi(k + 1, 1, nx), k - 1, min(k, nx - 1)};
      RingView<T, TOC> v{g, cr, er, ry, cz};
#pragma unroll
      for (int r = 0; r < N_ROLE; ++r) {
        v.xc[r] = ring<DC>(x[r]) * NW;  // read for R_S, R_C0, R_C1 (planes k, k+1)
        v.xe[r] = ring<DE>(x[r]) * NW;
      }
      const typename RingView<T, TOC>::Index vi = v.own();
      if (fam == 0) run_family<T, 0, HOIST>(g, v, s, i, vi);
      else if (fam == 1) run_family<T, 1, HOIST>(g, v, s, i, vi);
      else run_family<T, 2, HOIST>(g, v, s, i, vi);
    }
  }
  cp_async_wait_all();  // no copy outlives the block (the last steps stage none)
}

// The plastic scalars (the order of ops/hopper_vep3d_edges.py _PP_FIELDS)
// and K from `vals`.
template <typename T>
void set_plastic(Args<T>& g, const double* pp) {
  g.is_pl = pp[0] > 0.5;
  g.pl_frac = T(pp[1]); g.C_cosphi = T(pp[2]); g.sinphi = T(pp[3]);
  g.sinpsi = T(pp[5]); g.eta_reg = T(pp[6]); g.pT = T(pp[7]);
  g.K = T(pp[N_PP]);
}

template <typename T>
void set_grid(Args<T>& g, int nx, int ny, int nz) {
  g.n[0] = nx; g.n[1] = ny; g.n[2] = nz;
  g.st[2] = 1; g.st[1] = nz + 2; g.st[0] = (int64_t)(ny + 2) * (nz + 2);
}

// The edge passes' arguments from the C interface's `ptrs` and `vals`
template <typename T>
Args<T> edge_args(const void* const* ptrs, const double* vals, int nx, int ny, int nz) {
  Args<T> g;
  set_grid(g, nx, ny, nz);
  auto cp = [&](int j) { return static_cast<const T*>(ptrs[j]); };
  g.Vx = cp(0); g.Vy = cp(1); g.Vz = cp(2); g.theta = cp(3); g.eta = cp(4);
  for (int k = 0; k < 3; ++k) {
    g.tc[k] = cp(5 + k);
    g.te[k] = cp(8 + k);
    g.le[k] = cp(11 + k);
    g.ote[k] = static_cast<T*>(const_cast<void*>(ptrs[N_DYN + k]));
    g.ole[k] = static_cast<T*>(const_cast<void*>(ptrs[N_DYN + 3 + k]));
    g.G[k] = cp(N_DYN + N_OUT + k);
    for (int j = 0; j < 6; ++j) g.to[k][j] = cp(N_DYN + N_OUT + 3 + 6 * k + j);
  }
  for (int k = 0; k < 3; ++k) g.inv[k] = T(vals[k]);
  g.dt = T(vals[3]); g.theta_dtau = T(vals[4]);
  g.rel = T(vals[5]); g.one_minus_rel = T(1.0 - vals[5]);
  set_plastic(g, vals + 6);
  for (int k = 0; k < 3; ++k) g.Gv[k] = T(vals[7 + N_PP + k]);
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 6; ++j) g.tov[k][j] = T(vals[10 + N_PP + 6 * k + j]);
  return g;
}

// One launch of k_edges over the whole canvas, x split into as many ranges
// as fill one wave of resident blocks
template <typename T, bool HOIST, bool TOC>
int launch_march(const Args<T>& g, int mask, cudaStream_t stream) {
  using L = EdgeLayout;
  constexpr size_t smem = edge_smem<T, TOC>();
  auto kern = k_edges<T, HOIST, TOC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int X = g.n[0] + 2;
  const int tiles = ((g.n[1] + 2 + L::TY - 1) / L::TY) * ((g.n[2] + 2 + L::TZ - 1) / L::TZ);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, L::NTH, smem)) !=
          cudaSuccess)
    return (int)err;
  const int ranges = max(1, min(X, sms * per_sm / tiles));
  const int xc = (X + ranges - 1) / ranges;  // x planes per block
  kern<<<tiles * ((X + xc - 1) / xc), L::NTH, smem, stream>>>(g, mask, xc);
  return (int)cudaGetLastError();
}

// family < 0: B6, the three families with the old-stress interpolants
// averaged; 0..2: that family on its hoisted interpolants; 3: the three
// families on theirs (B9)
template <typename T>
int launch_edges(const void* const* ptrs, const double* vals, int nx, int ny, int nz,
                 int family, cudaStream_t stream) {
  // the kernel indexes a canvas plane with 32-bit offsets
  if (family < -1 || family > 3 || (int64_t)(ny + 2) * (nz + 2) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Args<T> g = edge_args<T>(ptrs, vals, nx, ny, nz);
  if (family >= 0) return launch_march<T, true, false>(g, family == 3 ? 7 : 1 << family, stream);
  bool toc = false;
  for (int j = 0; j < 6; ++j) toc = toc || g.to[0][j] != nullptr;
  return toc ? launch_march<T, false, true>(g, 7, stream)
             : launch_march<T, false, false>(g, 7, stream);
}

// ---- the fused chunk (B8) -----------------------------------------------

constexpr int N_CARRY = 19;   // Vx Vy Vz P theta tc0..5 te0..2 eta lam le0..2
constexpr int N_CONST = 20;   // Gc Ge0..2 toc0..5 toe0..2 P0 Q fzA fzB visc_eta visc_A visc_B
enum CarrySlot { C_VX, C_VY, C_VZ, C_P, C_TH, C_TC, C_TE = C_TC + 6, C_ETA = C_TE + 3, C_LAM,
                 C_LE };
enum ConstSlot { K_GC, K_GE, K_TOC = K_GE + 3, K_TOE = K_TOC + 6, K_P0 = K_TOE + 3, K_Q, K_FZA,
                 K_FZB, K_VETA, K_VA, K_VB };

template <typename T> struct Chunk {
  Args<T> e;             // the edge passes' view: V, eta, tau_c normals, tau_e, lambda_e of
                         // the input carry, the new theta, the outputs tau_e, lambda_e
  const T* in[N_CARRY];  // carry A (read)
  T* out[N_CARRY];       // carry B (written)
  T* et;                 // eta_tau scratch (cells)
  const T* c[N_CONST];   // constant canvases; nullptr: the value in cv
  T cv[N_CONST];
  T r_theta, inv_dt, etadtau, rel_visc, one_minus_rel_visc, cut_lo, cut_hi, vm, eps;
  bool fz, linear;
};

template <typename T> __device__ __forceinline__ T xpow(T a, T b);
template <> __device__ __forceinline__ float xpow(float a, float b) { return powf(a, b); }
template <> __device__ __forceinline__ double xpow(double a, double b) { return pow(a, b); }

// NaN-propagating max, as torch.maximum
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ bool is_cell(const Args<T>& g, const int* s) {
  return s[0] >= 1 && s[0] <= g.n[0] && s[1] >= 1 && s[1] <= g.n[1] && s[2] >= 1 &&
         s[2] <= g.n[2];
}

#define SLOT_OR_RETURN(g)                                            \
  const int c_ = blockIdx.x * blockDim.x + threadIdx.x;              \
  const int b_ = blockIdx.y * blockDim.y + threadIdx.y;              \
  const int a_ = blockIdx.z;                                         \
  if (b_ > (g).n[1] + 1 || c_ > (g).n[2] + 1) return;                \
  const int s[3] = {a_, b_, c_};                                     \
  const int64_t i = a_ * (g).st[0] + b_ * (g).st[1] + c_;

// eta_tau (the maxloc of eta over the 3x3x3 neighbourhood, indices clamped to
// the cells) and the compressible pressure iterate theta (ops/stokes.py
// compute_P) at the cells; theta keeps its value elsewhere.
template <typename T>
__global__ void __launch_bounds__(256) k_cells(const Chunk<T> g) {
  const Args<T>& e = g.e;
  SLOT_OR_RETURN(e)
  T th = g.in[C_TH][i];
  if (is_cell(e, s)) {
    const T* eta = g.in[C_ETA];
    T m = eta[i];
    for (int da = -1; da <= 1; ++da) {
      const int a = clampi(s[0] + da, 1, e.n[0]);
      for (int db = -1; db <= 1; ++db) {
        const int b = clampi(s[1] + db, 1, e.n[1]);
        for (int dc = -1; dc <= 1; ++dc) {
          const int c = clampi(s[2] + dc, 1, e.n[2]);
          m = tmax(m, eta[a * e.st[0] + b * e.st[1] + c]);
        }
      }
    }
    g.et[i] = m;
    const T dx = (e.Vx[i] - e.Vx[i - e.st[0]]) * e.inv[0];
    const T dy = (e.Vy[i] - e.Vy[i - e.st[1]]) * e.inv[1];
    const T dz = (e.Vz[i] - e.Vz[i - 1]) * e.inv[2];
    const T gv = dx + dy + dz;
    const T Kdt = T(1) / (e.K * e.dt);
    const T Gdt = T(1) / (at(g.c[K_GC], g.cv[K_GC], i) * e.dt);
    const T rhs = -gv + at(g.c[K_Q], g.cv[K_Q], i) * g.inv_dt;
    const T psi = T(1) / (T(1) / m + Gdt) * g.r_theta;
    th = ((at(g.c[K_P0], g.cv[K_P0], i) * Kdt + rhs) * psi + th) / (T(1) + Kdt * psi);
  }
  g.out[C_TH][i] = th;
}

// The stress pass's view: theta, tau_c and tau_e from device memory
// (through the caches); the strain rates and 1/eta from shared memory,
// where the block computed them once per point of its window (the three
// normal components and 1/eta at the cells, the three shear components at
// the edges) on x planes a-1..a+1 of a (SY + 2) x (SZ + 2) window around
// its tile of slots.
constexpr int SY = 8, SZ = 32;                        // a block's tile of slots
constexpr int WY = SY + 2, WZ = SZ + 2, NW = WY * WZ;  // its strain window
enum StrainField { F_EN = 0, F_ES = 3, F_IETA = 6, N_STRAIN = 7 };

template <typename T> struct StrainView {
  struct Index {
    int64_t g;  // canvas index
    int s;      // strain window index
  };
  const Args<T>& g;
  const T* s;            // [N_STRAIN][3 planes][NW]
  int a_lo, b_lo, c_lo;  // the window's origin
  __device__ Index at(const int* c) const {
    return {lin(g, c), ((c[0] - a_lo) * WY + (c[1] - b_lo)) * WZ + (c[2] - c_lo)};
  }
  __device__ T theta(Index p) const { return g.theta[p.g]; }
  __device__ T inv_eta(Index p) const { return s[F_IETA * 3 * NW + p.s]; }
  __device__ T tc(int j, Index p) const { return g.tc[j][p.g]; }
  __device__ T te(int m, Index p) const { return g.te[m][p.g]; }
  __device__ void normal(Index p, T* e) const {
#pragma unroll
    for (int j = 0; j < 3; ++j) e[j] = s[(F_EN + j) * 3 * NW + p.s];
  }
  __device__ T shear(int m, Index p) const { return s[(F_ES + m) * 3 * NW + p.s]; }
  __device__ T old4(int k, int j, const Index* w) const {
    const int64_t q[4] = {w[0].g, w[1].g, w[2].g, w[3].g};
    return avg_at(g.to[k][j], g.tov[k][j], q);
  }
};

// The center return mapping at cell slot s (canvas index i, view index vi):
// tau_c x6, lambda and the corrected pressure, then the viscosity
// continuation, in place.
template <typename T, class V>
__device__ void center(const Chunk<T>& g, const V& v, const int* s, int64_t i,
                       typename V::Index vi,
                       T* tc, T& lam, T& P, T& eta) {
  const Args<T>& e = g.e;
  T e6[6];
  v.normal(vi, e6);
  // the shear strain rates, averaged from the four edges around the cell
  auto sh = [&](int m, int da, int db, int dc) {
    const int c[3] = {s[0] + da, s[1] + db, s[2] + dc};
    return v.shear(m, v.at(c));
  };
  e6[3] = avg4(sh(0, 0, -1, -1), sh(0, 0, 0, -1), sh(0, 0, -1, 0), sh(0, 0, 0, 0));
  e6[4] = avg4(sh(1, -1, 0, -1), sh(1, 0, 0, -1), sh(1, -1, 0, 0), sh(1, 0, 0, 0));
  e6[5] = avg4(sh(2, -1, -1, 0), sh(2, 0, -1, 0), sh(2, -1, 0, 0), sh(2, 0, 0, 0));
  const T Gdt = T(1) / (at(g.c[K_GC], g.cv[K_GC], i) * e.dt);
  const T dtau = T(1) / (e.theta_dtau + eta * Gdt + T(1));
  T tr[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const T to = at(g.c[K_TOC + j], g.cv[K_TOC + j], i);
    tr[j] = tc[j] + dtau * (T(2) * eta * e6[j] - (tc[j] - to) * eta * Gdt - tc[j]);
  }
  const T tII = inv_II(tr);
  const T Pr = v.theta(vi);
  T F, dQdP, volume;
  drucker_prager(e, Pr, tII, F, dQdP, volume);
  const bool yld = e.is_pl && tII != T(0) && F > T(0);
  // the multiplier and the plastic correction, where the cell yields
  if (yld) {
    lam = e.one_minus_rel * lam +
          e.rel * (clamp_lo(F, T(0)) / (eta * dtau + e.eta_reg + volume));
    const T scale = e.pl_frac * T(0.5);
    const T corr = T(2) * eta * dtau;
    const T div = tII == T(0) ? T(1) : tII;
#pragma unroll
    for (int j = 0; j < 6; ++j) tc[j] = tr[j] - corr * (lam * scale * (tr[j] / div));
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) tc[j] = tr[j];
  }
  P = Pr - (is_inf(e.K) ? T(0) : e.K * e.dt * lam * dQdP);

  // viscosity continuation on the new tau_c: the creep target (a constant
  // for a linear table, else 1/eta = A + B tauII^m), relaxed and cut off
  const T sabs = fabs(tc[0]) + fabs(tc[1]) + fabs(tc[2]) + fabs(tc[3]) + fabs(tc[4]) +
                 fabs(tc[5]);
  T t6[6] = {tc[0] + (sabs == T(0) ? g.eps : T(0)), tc[1], tc[2], tc[3], tc[4], tc[5]};
  T eta_n;
  if (g.linear) {
    eta_n = at(g.c[K_VETA], g.cv[K_VETA], i);
  } else {
    eta_n = T(1) / (at(g.c[K_VA], g.cv[K_VA], i) +
                    at(g.c[K_VB], g.cv[K_VB], i) * xpow(inv_II(t6), g.vm));
  }
  eta_n = g.rel_visc * eta_n + g.one_minus_rel_visc * eta;
  eta = tmin(tmax(eta_n, g.cut_lo), g.cut_hi);
}

// The stress pass: the center pass and the viscosity at the cells, and
// the three edge passes on their owned slots; every other slot keeps its
// value. A block takes an SY x SZ tile of slots of one x plane a: it first
// computes the strain rates of its window on planes a-1..a+1 into shared
// memory (each point once, from V through the caches), then one thread per
// slot runs the passes, reading the strain rates from there.
template <typename T>
__global__ void __launch_bounds__(SY * SZ) k_stress(const Chunk<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [N_STRAIN][3 planes][NW]
  const Args<T>& e = g.e;
  const int nx = e.n[0], ny = e.n[1], nz = e.n[2];
  const int64_t sx = e.st[0], sy = e.st[1];
  const int a = blockIdx.z, b0 = blockIdx.y * SY, c0 = blockIdx.x * SZ;
  const StrainView<T> v{e, sm, a - 1, b0 - 1, c0 - 1};

  // ---- the strain rates of the window, where the passes read them
  for (int q = threadIdx.y * SZ + threadIdx.x; q < 3 * NW; q += SY * SZ) {
    const int pl = q / NW, r = q - pl * NW, wb = r / WZ, wc = r - wb * WZ;
    const int p = a - 1 + pl, b = b0 - 1 + wb, c = c0 - 1 + wc;
    if (p < 0 || p > nx + 1 || b < 0 || b > ny + 1 || c < 0 || c > nz + 1) continue;
    const int64_t i = p * sx + b * sy + c;
    T* out = sm + q;
    if (p >= 1 && p <= nx && b >= 1 && b <= ny && c >= 1 && c <= nz) {
      T en[3];
      normal_strain(e, i, en);
#pragma unroll
      for (int j = 0; j < 3; ++j) out[(F_EN + j) * 3 * NW] = en[j];
      out[F_IETA * 3 * NW] = T(1) / e.eta[i];
    }
    if (b <= ny && c <= nz) out[F_ES * 3 * NW] = shear_strain(e, 0, i);
    if (p <= nx && c <= nz) out[(F_ES + 1) * 3 * NW] = shear_strain(e, 1, i);
    if (p <= nx && b <= ny) out[(F_ES + 2) * 3 * NW] = shear_strain(e, 2, i);
  }
  __syncthreads();

  // ---- the passes, one thread per slot
  const int b = b0 + threadIdx.y, c = c0 + threadIdx.x;
  if (b > ny + 1 || c > nz + 1) return;
  const int s[3] = {a, b, c};
  const int64_t i = a * sx + b * sy + c;
  const typename StrainView<T>::Index vi = v.at(s);
  T tc[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) tc[j] = g.in[C_TC + j][i];
  T lam = g.in[C_LAM][i], P = g.in[C_P][i], eta = g.in[C_ETA][i];
  if (is_cell(e, s)) center(g, v, s, i, vi, tc, lam, P, eta);
#pragma unroll
  for (int j = 0; j < 6; ++j) g.out[C_TC + j][i] = tc[j];
  g.out[C_LAM][i] = lam;
  g.out[C_P][i] = P;
  g.out[C_ETA][i] = eta;
  run_family<T, 0, false>(e, v, s, i, vi);
  run_family<T, 1, false>(e, v, s, i, vi);
  run_family<T, 2, false>(e, v, s, i, vi);
}

// Index of the interior slot the free-slip mirrors copy into a ghost slot
// along an axis of n cells (0 <- 1, n+1 <- n).
__device__ __forceinline__ int mirror(int v, int n) { return v == 0 ? 1 : (v == n + 1 ? n : v); }

// The damped velocity update of component D at slot q (a face slot it
// updates: 1..n-1 along D, 1..n along the others), from the new stresses and
// pressure of carry B; the input's value elsewhere.
template <typename T, int D>
__device__ __forceinline__ T velocity(const Chunk<T>& g, const int* q) {
  const Args<T>& e = g.e;
  const int64_t p = q[0] * e.st[0] + q[1] * e.st[1] + q[2];
  const T v = g.in[C_VX + D][p];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int hi = ax == D ? e.n[ax] - 1 : e.n[ax];
    if (q[ax] < 1 || q[ax] > hi) return v;
  }
  const int64_t sx = e.st[0], sy = e.st[1], sd = e.st[D];
  const T* P = g.out[C_P];
  const T* tyz = g.out[C_TE];
  const T* txz = g.out[C_TE + 1];
  const T* txy = g.out[C_TE + 2];
  T rr;
  if (D == 0) {
    const T* txx = g.out[C_TC];
    rr = (txx[p + sx] - txx[p]) * e.inv[0] + (txy[p] - txy[p - sy]) * e.inv[1] +
         (txz[p] - txz[p - 1]) * e.inv[2] - (P[p + sx] - P[p]) * e.inv[0];
  } else if (D == 1) {
    const T* tyy = g.out[C_TC + 1];
    rr = (txy[p] - txy[p - sx]) * e.inv[0] + (tyy[p + sy] - tyy[p]) * e.inv[1] +
         (tyz[p] - tyz[p - 1]) * e.inv[2] - (P[p + sy] - P[p]) * e.inv[1];
  } else {
    const T* tzz = g.out[C_TC + 2];
    rr = (txz[p] - txz[p - sx]) * e.inv[0] + (tyz[p] - tyz[p - sy]) * e.inv[1] +
         (tzz[p + 1] - tzz[p]) * e.inv[2] - (P[p + 1] - P[p]) * e.inv[2];
    if (g.fz) {
      const T* Pa = g.in[C_P];
      const T f0 = at(g.c[K_FZA], g.cv[K_FZA], p) + at(g.c[K_FZB], g.cv[K_FZB], p) * Pa[p];
      const T f1 = at(g.c[K_FZA], g.cv[K_FZA], p + 1) +
                   at(g.c[K_FZB], g.cv[K_FZB], p + 1) * Pa[p + 1];
      rr = rr - T(0.5) * (f0 + f1);
    }
  }
  return v + rr * (g.etadtau / (T(0.5) * (g.et[p] + g.et[p + sd])));
}

// The velocity update on the interior faces; a ghost slot takes the value
// of the slot the free-slip mirrors copy into it (its tangential axes
// clamped into 1..n).
template <typename T>
__global__ void __launch_bounds__(256) k_velocity(const Chunk<T> g) {
  const Args<T>& e = g.e;
  SLOT_OR_RETURN(e)
  const int nx = e.n[0], ny = e.n[1], nz = e.n[2];
  const int qx[3] = {s[0], mirror(s[1], ny), mirror(s[2], nz)};
  const int qy[3] = {mirror(s[0], nx), s[1], mirror(s[2], nz)};
  const int qz[3] = {mirror(s[0], nx), mirror(s[1], ny), s[2]};
  g.out[C_VX][i] = velocity<T, 0>(g, qx);
  g.out[C_VY][i] = velocity<T, 1>(g, qy);
  g.out[C_VZ][i] = velocity<T, 2>(g, qz);
}

template <typename T>
int launch_chunk(const void* const* ptrs, const double* vals, int nx, int ny, int nz, int nit,
                 cudaStream_t stream) {
  Chunk<T> g;
  Args<T>& e = g.e;
  set_grid(e, nx, ny, nz);
  for (int k = 0; k < 3; ++k) e.inv[k] = T(vals[k]);
  e.dt = T(vals[3]);
  g.inv_dt = T(1.0 / vals[3]);
  g.r_theta = T(vals[4] / vals[5]);
  e.theta_dtau = T(vals[5]);
  g.etadtau = T(vals[6]);
  e.rel = T(vals[7]); e.one_minus_rel = T(1.0 - vals[7]);
  g.rel_visc = T(vals[8]); g.one_minus_rel_visc = T(1.0 - vals[8]);
  g.cut_lo = T(vals[9]); g.cut_hi = T(vals[10]);
  set_plastic(e, vals + 11);
  const double* cv = vals + 12 + N_PP;
  const void* const* cp = ptrs + 3 * N_CARRY + 1;
  for (int j = 0; j < N_CONST; ++j) {
    g.c[j] = static_cast<const T*>(cp[j]);
    g.cv[j] = T(cv[j]);
  }
  g.vm = T(cv[N_CONST]);
  g.fz = cv[N_CONST + 1] > 0.5;
  g.linear = cv[N_CONST + 2] > 0.5;
  g.eps = sizeof(T) == 4 ? T(1.1920928955078125e-07) : T(2.220446049250313e-16);
  g.et = static_cast<T*>(const_cast<void*>(ptrs[3 * N_CARRY]));
  // the edge passes' constants in B6's form: G_e, and for every family the
  // normal tau_o_c and the three tau_o_e
  for (int k = 0; k < 3; ++k) {
    e.G[k] = g.c[K_GE + k]; e.Gv[k] = g.cv[K_GE + k];
    for (int j = 0; j < 3; ++j) {
      e.to[k][j] = g.c[K_TOC + j]; e.tov[k][j] = g.cv[K_TOC + j];
      e.to[k][3 + j] = g.c[K_TOE + j]; e.tov[k][3 + j] = g.cv[K_TOE + j];
    }
  }
  const dim3 blk(32, 8, 1);
  const dim3 grid((nz + 2 + 31) / 32, (ny + 2 + 7) / 8, nx + 2);
  const dim3 sblk(SZ, SY, 1);
  const dim3 sgrid((nz + 2 + SZ - 1) / SZ, (ny + 2 + SY - 1) / SY, nx + 2);
  auto kc = k_cells<T>;
  auto ks = k_stress<T>;
  auto kv = k_velocity<T>;
  const size_t smem = N_STRAIN * 3 * NW * sizeof(T);  // f64: above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(ks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < nit; ++it) {
    const void* const* src = it == 0 ? ptrs : ptrs + N_CARRY * (1 + (it - 1) % 2);
    const void* const* dst = ptrs + N_CARRY * (1 + it % 2);
    for (int j = 0; j < N_CARRY; ++j) {
      g.in[j] = static_cast<const T*>(src[j]);
      g.out[j] = static_cast<T*>(const_cast<void*>(dst[j]));
    }
    e.Vx = g.in[C_VX]; e.Vy = g.in[C_VY]; e.Vz = g.in[C_VZ];
    e.theta = g.out[C_TH];
    e.eta = g.in[C_ETA];
    for (int k = 0; k < 3; ++k) {
      e.tc[k] = g.in[C_TC + k];
      e.te[k] = g.in[C_TE + k];
      e.le[k] = g.in[C_LE + k];
      e.ote[k] = g.out[C_TE + k];
      e.ole[k] = g.out[C_LE + k];
    }
    kc<<<grid, blk, 0, stream>>>(g);
    ks<<<sgrid, sblk, smem, stream>>>(g);
    kv<<<grid, blk, 0, stream>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
}  // namespace

// Plain C interface (loaded with ctypes).
//
// jr_vep3d_edges_*: the edge passes in one launch: B6 (`family` < 0), the
//   three families on their hoisted interpolants (B9, `family` 3) or one of
//   them (0..2).
// `ptrs`: 14 inputs (Vx, Vy, Vz, theta, eta, tau_c normals x3, tau_e x3,
//   lambda_e x3), 6 outputs (tau_e x3, lambda_e x3; null for a family that
//   is not run), G_e x3, then per family the six old-stress sources (null:
//   the scalar in `vals`): for B9 the family's hoisted interpolants, for B6
//   tau_o_c normals x3 and tau_o_e x3.
// `vals`: 1/dx, 1/dy, 1/dz, dt, theta_dtau, lambda_relaxation, the nine
//   plastic scalars, K, G_e x3, the 18 old-stress scalars.
//
// jr_vep3d_chunk_*: `nit` fused iterations (B8), three launches each.
// `ptrs`: the 19 input carry canvases (CARRY order), two work sets of 19,
//   the eta_tau scratch canvas, then the N_CONST constant sources (CONST
//   order; null: the scalar in `vals`). Iteration j reads the input (j = 0)
//   or work set (j - 1) % 2 and writes work set j % 2: the result is in
//   work set (nit - 1) % 2.
// `vals`: 1/dx, 1/dy, 1/dz, dt, r, theta_dtau, etadtau, lambda_relaxation,
//   viscosity_relaxation, the viscosity cut-off (lo, hi), the nine plastic
//   scalars, K, the N_CONST constant values, the power-law exponent minus
//   one, and the flags "has a body force" and "linear creep".
//
// All canvases are contiguous (nx+2, ny+2, nz+2). Both launch on `stream`
// without synchronising and return the launch error, or 0.
extern "C" int jr_vep3d_edges_f32(const void* const* ptrs, const double* vals, int nx,
                                  int ny, int nz, int family, void* stream) {
  return launch_edges<float>(ptrs, vals, nx, ny, nz, family, (cudaStream_t)stream);
}

extern "C" int jr_vep3d_edges_f64(const void* const* ptrs, const double* vals, int nx,
                                  int ny, int nz, int family, void* stream) {
  return launch_edges<double>(ptrs, vals, nx, ny, nz, family, (cudaStream_t)stream);
}

extern "C" int jr_vep3d_chunk_f32(const void* const* ptrs, const double* vals, int nx,
                                  int ny, int nz, int nit, void* stream) {
  return launch_chunk<float>(ptrs, vals, nx, ny, nz, nit, (cudaStream_t)stream);
}

extern "C" int jr_vep3d_chunk_f64(const void* const* ptrs, const double* vals, int nx,
                                  int ny, int nz, int nit, void* stream) {
  return launch_chunk<double>(ptrs, vals, nx, ny, nz, nit, (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
