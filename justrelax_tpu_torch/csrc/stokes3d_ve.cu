// 3D visco-elastic (VE) compressible pseudo-transient chunk, hand-written for
// Hopper (sm_90a): one tiled launch per PT iteration, marching along x.
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
// A coefficient is a canvas, a scalar (any canvas that holds one value), absent
// (c1, c2, d where they change nothing) or derived here, chosen per call by a
// slot table that the wrapper builds (ops/hopper_stokes3d.py::kernel_slots).
//
// What bounds it on this card: device-memory traffic. One iteration must
// read and write the 10 unknowns and read each coefficient input that varies;
// on SolVi (dt = inf) that is eta and eta_tau, 22 words per cell. The earlier
// form moved about 50: two launches per iteration, each re-reading V, P and
// tau, and 8 coefficient canvases streamed.
//
// Design. Each block owns a TY x TZ tile of interior (y, z) points (extended
// to the ghost rows 0 and n+1 on the first and last tile) over a range of x
// planes, and marches along x with one thread per point of the tile's
// window (the tile and a halo of one point in y and z). Step k:
//   1. stage by cp.async a plane ahead of every field into rings of shared
//      memory: four planes deep for what the (x, y, z) stencil reads (old
//      Vx, Vy, Vz; eta and eta_tau where coefficients are derived; the face
//      coefficients), two deep for what each thread reads at its own point
//      (old P and tau; cell and edge coefficients);
//   2. compute the new P and tau of plane k+1 at every window point from
//      the staged old velocities (a halo point's values are recomputed by
//      every block that needs them, bit-equal to their owner's); keep them
//      in registers, and the six read at (y, z) neighbours in shared memory;
//   3. the damped velocity update of the faces of plane k at the owned
//      points, from the new P and tau of planes k-1, k, k+1 (x neighbours
//      in registers, y and z neighbours in shared memory); write every
//      owned point of plane k in all ten canvases, and the free-slip ghosts
//      from the updated value each mirrors (the clamp rule: a tangential
//      ghost equals the value at the clamped interior index, on every row;
//      the x ghosts of Vy and Vz with planes 1 and nx).
// One barrier per step: the new fields of plane k+1 go to the other of two
// shared planes than plane k's. Iteration k reads the input carry (k = 0)
// or work set (k - 1) % 2 and writes work set k % 2: the input carry is
// never written, and every canvas point has one writer. The z rows are
// contiguous; a window row starts at z = TZ t, on a 32-byte sector when
// nz + 2 is a multiple of 8. The wrapper splits x into as many ranges as
// fill one wave of blocks.
//
// Coefficients derived from eta and eta_tau (the edge-padded cell fields) in
// the operation order of ops/stokes3d_canvas.py, so that the values are the
// packed canvases' own (the wrapper checks each bit for bit before it marks
// a slot derived, and streams it otherwise):
//   c3       = src * r_theta, or (1/(1/src)) * r_theta  (src eta or eta_tau)
//   b_c      = (2 eta) * dtau_r
//   b_e      = (2 * edge average of eta) * dtau_r      (0.5 (0.5 (a+b) + ...))
//   inv_eta  = (1 / (0.5 (eta_tau + eta_tau'))) * etadtau
// with products and sums rounded one by one (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b + c into an FMA). A coefficient that depends on G, K,
// tau_o, P0 or Q with a finite dt streams. Left for later: temporal blocking
// (k iterations per window), whose reading against a per-iteration bound
// needs a convention first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Coefficient order (ops/hopper_stokes3d.py COEF_NAMES).
enum Coef { K_C1, K_C2, K_C3, K_AC, K_BC, K_DC0, K_DC1, K_DC2,
            K_AE0, K_AE1, K_AE2, K_BE0, K_BE1, K_BE2, K_DE0, K_DE1, K_DE2,
            K_IE0, K_IE1, K_IE2, K_F0, K_F1, K_F2, N_COEF };
enum { SLOT_SCALAR = -1, SLOT_ABSENT = -2, SLOT_DERIVED = -3 };
// c3's derivation: from eta_tau (else eta), through 1/(1/src) (else src)
enum { C3_FROM_ETAT = 1, C3_DOUBLE_RCP = 2 };

// The (y, z) tile of one block: TY interior y points by TZ interior z
// points; one thread per point of its window, the tile and a halo of one
// point: (TY + 2) x (TZ + 2), rounded up to whole warps
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int TY = 4, TZ = 64; };
template <> struct Tile<double> { static constexpr int TY = 4, TZ = 32; };
template <int TY, int TZ> constexpr int threads() { return ((TY + 2) * (TZ + 2) + 31) / 32 * 32; }
constexpr int D4 = 4, D2 = 2;         // ring depths, in planes
constexpr int N_CARRY = 10;
constexpr int N_NEW = 7;              // P, txx, tyy, tzz, tyz, txz, txy
constexpr int N_SHARED = 6;           // the new fields read at (y, z) neighbours
constexpr int MAX_R4 = 3 + 2 + 6;     // V, eta, eta_tau, face coefficients
constexpr int MAX_R2 = N_NEW + 17;    // old P and tau, cell/edge coefficients

template <typename T> struct Params {
  const T* r4[MAX_R4];   // staged four planes deep: Vx, Vy, Vz, then extras
  const T* r2[MAX_R2];   // staged two planes deep: P, txx, ..., txy, coefs
  T* out[N_CARRY];
  int n4, n2;
  int slot[N_COEF];      // >= 0: a canvas, staged at where[]; or SLOT_*
  int where[N_COEF];
  T val[N_COEF];
  int i_eta, i_etat;     // r4 index of the eta / eta_tau canvas
  int c3_mode;
  T r_theta, dtau_r, etadtau, inv_dx, inv_dy, inv_dz;
  int nx, ny, nz, xc;    // xc: interior x planes per block
  int free_slip;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Staging copies: cp.async of one element from device to shared memory, no
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

// Writes v into the ghosts that the clamp rule maps onto the owner point g:
// lo/hi flag an owner on the first/last interior index of the two
// tangential axes, whose strides are s1 and s2.
template <typename T>
__device__ __forceinline__ void mirror(T* A, int64_t g, bool lo1, bool hi1, bool lo2,
                                       bool hi2, int64_t s1, int64_t s2, T v) {
  if (lo1) A[g - s1] = v;
  if (hi1) A[g + s1] = v;
  if (lo2) {
    A[g - s2] = v;
    if (lo1) A[g - s1 - s2] = v;
    if (hi1) A[g + s1 - s2] = v;
  }
  if (hi2) {
    A[g + s2] = v;
    if (lo1) A[g - s1 + s2] = v;
    if (hi1) A[g + s1 + s2] = v;
  }
}

// One PT iteration. GEN: some coefficient streams as a canvas; without it
// every coefficient is a scalar, absent or derived and the kernel reads
// none (measured 5 % faster on SolVi than the general form, PERF.md §6).
template <typename T, int TY, int TZ, bool GEN>
__global__ void __launch_bounds__(threads<TY, TZ>()) k_iteration(const Params<T> q) {
  constexpr int WY = TY + 2, WZ = TZ + 2, NW = WY * WZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s4 = reinterpret_cast<T*>(smem_raw);  // [n4][D4 planes][NW]
  T* s2 = s4 + q.n4 * D4 * NW;             // [n2][D2 planes][NW]
  T* sn = s2 + q.n2 * D2 * NW;             // [N_SHARED][2 planes][NW]

  const int nx = q.nx, ny = q.ny, nz = q.nz;
  const int X = nx + 2, Y = ny + 2, Z = nz + 2;
  const int64_t sy = Z, sx = (int64_t)Y * Z;
  // block -> (x range, y tile, z tile), z fastest
  const int ntz = (nz + TZ - 1) / TZ, nty = (ny + TY - 1) / TY;
  const int tz = blockIdx.x % ntz, ty = (blockIdx.x / ntz) % nty;
  const int tx = blockIdx.x / (ntz * nty);
  const int C0 = 1 + tz * TZ, C1 = min(C0 + TZ, nz + 1);
  const int B0 = 1 + ty * TY, B1 = min(B0 + TY, ny + 1);
  const int A0 = 1 + tx * q.xc, A1 = min(A0 + q.xc, nx + 1);
  // owned planes: the x range, extended to the ghost planes at the ends
  const int P0 = A0 == 1 ? 0 : A0, P1 = A1 == nx + 1 ? X : A1;
  // this thread's window point; the window is [B0-1, B1] x [C0-1, C1]
  const int wb = threadIdx.x / WZ, wc = threadIdx.x - wb * WZ;
  const int p = threadIdx.x;  // its shared-memory index in a plane
  const int b = B0 - 1 + wb, c = C0 - 1 + wc;
  const bool valid = wb < WY && b <= B1 && c <= C1;
  // owned (y, z) points: the tile, extended to the ghost rows at the ends
  const bool owned = valid && (b >= B0 || B0 == 1) && (b < B1 || B1 == ny + 1) &&
                     (c >= C0 || C0 == 1) && (c < C1 || C1 == nz + 1);
  const int64_t g0 = (int64_t)b * sy + c;
  const bool fs = q.free_slip != 0;
  const bool der_c3 = q.slot[K_C3] == SLOT_DERIVED, der_bc = q.slot[K_BC] == SLOT_DERIVED;

  // the staged fields' planes: field base + (a % depth) * NW + point
  const T* Vx = s4;
  const T* Vy = s4 + D4 * NW;
  const T* Vz = s4 + 2 * D4 * NW;
  const T* Eta = s4 + max(q.i_eta, 0) * D4 * NW;
  const T* Etat = s4 + max(q.i_etat, 0) * D4 * NW;
  const T* C3src = (q.c3_mode & C3_FROM_ETAT) ? Etat : Eta;
  // a coefficient at this point of the plane whose offset in its ring is o
  auto cf2 = [&](int id, int o) -> T {
    if constexpr (GEN) {
      if (q.slot[id] >= 0) return s2[q.where[id] * D2 * NW + o + p];
    }
    return q.val[id];
  };
  auto cf4 = [&](int id, int o) -> T {
    if constexpr (GEN) {
      if (q.slot[id] >= 0) return s4[q.where[id] * D4 * NW + o + p];
    }
    return q.val[id];
  };

  // this point of plane a of nf fields into ring slot a % depth
  auto stage = [&](const T* const* src, T* dst, int nf, int depth, int a) {
    if (!valid) return;
    const int64_t g = a * sx + g0;
    for (int f = 0; f < nf; ++f) cp_async_elem(dst + (f * depth + a % depth) * NW + p, src[f] + g);
  };
  // t <- a*t + b*e (+ d)
  auto relax = [&](T t, T a, T b_, T e, int id_d, int o) -> T {
    T tn = a * t + b_ * e;
    if (q.slot[id_d] != SLOT_ABSENT) tn = tn + cf2(id_d, o);
    return tn;
  };
  const T half = T(0.5), two = T(2);
  // 2 dtau_r times the 4-point average of eta around an edge (_edge_avg)
  auto b_edge = [&](T e00, T e01, T e10, T e11) -> T {
    const T u = half * add_rn(e00, e01), v = half * add_rn(e10, e11);
    return mul_rn(two * (half * add_rn(u, v)), q.dtau_r);
  };
  auto inv_eta = [&](T e0, T e1) -> T {
    return mul_rn(T(1) / (half * add_rn(e0, e1)), q.etadtau);
  };

  // ---- 2. the new P and tau of plane a at this window point, from the
  // stencil ring's planes a-1, a, a+1 (offsets om, o0, o1) and the point
  // ring's plane a (offset o2); the (y, z) neighbours exist where they are
  // read
  auto new_stresses = [&](int a, int om, int o0, int o1, int o2, T* t) {
    const bool a_cell = a >= 1 && a <= nx, a_e = a >= 1 && a <= nx - 1;
#pragma unroll
    for (int f = 0; f < N_NEW; ++f) t[f] = s2[f * D2 * NW + o2 + p];
    const int i0 = o0 + p, i1 = o1 + p;
    if (a_cell && b >= B0 && c >= C0 && b <= ny && c <= nz) {
      const T dVxdx = (Vx[i0] - Vx[om + p]) * q.inv_dx;
      const T dVydy = (Vy[i0] - Vy[i0 - WZ]) * q.inv_dy;
      const T dVzdz = (Vz[i0] - Vz[i0 - 1]) * q.inv_dz;
      const T gv = dVxdx + dVydy + dVzdz;
      T Pn = t[0];
      if (q.slot[K_C1] != SLOT_ABSENT) Pn = Pn * cf2(K_C1, o2);
      if (q.slot[K_C2] != SLOT_ABSENT) Pn = Pn + cf2(K_C2, o2);
      T c3;
      if (der_c3) {
        T src = C3src[i0];
        if (q.c3_mode & C3_DOUBLE_RCP) src = T(1) / (T(1) / src);
        c3 = mul_rn(src, q.r_theta);
      } else {
        c3 = cf2(K_C3, o2);
      }
      t[0] = Pn - gv * c3;
      const T third = T(1.0 / 3.0);
      const T ac = cf2(K_AC, o2);
      const T bc = der_bc ? mul_rn(two * Eta[i0], q.dtau_r) : cf2(K_BC, o2);
      t[1] = relax(t[1], ac, bc, dVxdx - gv * third, K_DC0, o2);
      t[2] = relax(t[2], ac, bc, dVydy - gv * third, K_DC1, o2);
      t[3] = relax(t[3], ac, bc, dVzdz - gv * third, K_DC2, o2);
    }
    if (a_cell && b >= 1 && b <= ny - 1 && c >= 1 && c <= nz - 1 && b < B1 && c < C1) {
      const T e = T(0.5) * ((Vy[i0 + 1] - Vy[i0]) * q.inv_dz +
                            (Vz[i0 + WZ] - Vz[i0]) * q.inv_dy);
      const T be = q.slot[K_BE0] == SLOT_DERIVED
          ? b_edge(Eta[i0], Eta[i0 + WZ], Eta[i0 + 1], Eta[i0 + WZ + 1])
          : cf2(K_BE0, o2);
      t[4] = relax(t[4], cf2(K_AE0, o2), be, e, K_DE0, o2);
    }
    if (a_e && b >= 1 && b <= ny && c >= 1 && c <= nz - 1 && c < C1) {
      const T e = T(0.5) * ((Vx[i0 + 1] - Vx[i0]) * q.inv_dz +
                            (Vz[i1] - Vz[i0]) * q.inv_dx);
      const T be = q.slot[K_BE1] == SLOT_DERIVED
          ? b_edge(Eta[i0], Eta[i1], Eta[i0 + 1], Eta[i1 + 1])
          : cf2(K_BE1, o2);
      t[5] = relax(t[5], cf2(K_AE1, o2), be, e, K_DE1, o2);
    }
    if (a_e && b >= 1 && b <= ny - 1 && c >= 1 && c <= nz && b < B1) {
      const T e = T(0.5) * ((Vx[i0 + WZ] - Vx[i0]) * q.inv_dy +
                            (Vy[i1] - Vy[i0]) * q.inv_dx);
      const T be = q.slot[K_BE2] == SLOT_DERIVED
          ? b_edge(Eta[i0], Eta[i1], Eta[i0 + WZ], Eta[i1 + WZ])
          : cf2(K_BE2, o2);
      t[6] = relax(t[6], cf2(K_AE2, o2), be, e, K_DE2, o2);
    }
  };

  // ---- 3. the faces of plane a at this (owned) point: t0, t1 the new P and
  // tau of planes a and a+1 here, txy_m / txz_m of plane a-1; the (y, z)
  // neighbours of plane a from the shared new fields (offset on), the old
  // velocities and face coefficients from the stencil ring (planes a, a+1
  // at offsets o0, o1). Then all ten canvases at this point; a free-slip
  // ghost is written by the owner of the value it mirrors
  auto faces = [&](int a, int o0, int o1, int on, const T* t0, const T* t1, T txy_m,
                   T txz_m) {
    const int64_t g = a * sx + g0;
#pragma unroll
    for (int f = 0; f < N_NEW; ++f) q.out[3 + f][g] = t0[f];
    const int i0 = o0 + p, i1 = o1 + p, in = on + p;
    // shared new fields: 0 P, 1 tyy, 2 tzz, 3 tyz, 4 txz, 5 txy
    const T* nP = sn;
    const T* nTyy = sn + 2 * NW;
    const T* nTzz = sn + 4 * NW;
    const T* nTyz = sn + 6 * NW;
    const T* nTxz = sn + 8 * NW;
    const T* nTxy = sn + 10 * NW;
    const bool ia = a >= 1 && a <= nx, ib = b >= 1 && b <= ny, ic = c >= 1 && c <= nz;
    if (!fs || (ib && ic)) {  // Vx: tangential y, z; updated on a in [1, nx-1]
      T v = Vx[i0];
      if (a >= 1 && a <= nx - 1 && ib && ic) {
        const T rx = (t1[1] - t0[1]) * q.inv_dx + (t0[6] - nTxy[in - WZ]) * q.inv_dy +
                     (t0[5] - nTxz[in - 1]) * q.inv_dz - (t1[0] - t0[0]) * q.inv_dx -
                     cf4(K_F0, o0);
        const T ie = q.slot[K_IE0] == SLOT_DERIVED ? inv_eta(Etat[i0], Etat[i1])
                                                    : cf4(K_IE0, o0);
        v = v + rx * ie;
      }
      q.out[0][g] = v;
      if (fs) mirror(q.out[0], g, b == 1, b == ny, c == 1, c == nz, sy, (int64_t)1, v);
    }
    if (!fs || (ia && ic)) {  // Vy: tangential x, z; updated on b in [1, ny-1]
      T v = Vy[i0];
      if (ia && b >= 1 && b <= ny - 1 && ic) {
        const T ry = (t0[6] - txy_m) * q.inv_dx + (nTyy[in + WZ] - t0[2]) * q.inv_dy +
                     (t0[4] - nTyz[in - 1]) * q.inv_dz - (nP[in + WZ] - t0[0]) * q.inv_dy -
                     cf4(K_F1, o0);
        const T ie = q.slot[K_IE1] == SLOT_DERIVED ? inv_eta(Etat[i0], Etat[i0 + WZ])
                                                    : cf4(K_IE1, o0);
        v = v + ry * ie;
      }
      q.out[1][g] = v;
      if (fs) mirror(q.out[1], g, a == 1, a == nx, c == 1, c == nz, sx, (int64_t)1, v);
    }
    if (!fs || (ia && ib)) {  // Vz: tangential x, y; updated on c in [1, nz-1]
      T v = Vz[i0];
      if (ia && ib && c >= 1 && c <= nz - 1) {
        const T rz = (t0[5] - txz_m) * q.inv_dx + (t0[4] - nTyz[in - WZ]) * q.inv_dy +
                     (nTzz[in + 1] - t0[3]) * q.inv_dz - (nP[in + 1] - t0[0]) * q.inv_dz -
                     cf4(K_F2, o0);
        const T ie = q.slot[K_IE2] == SLOT_DERIVED ? inv_eta(Etat[i0], Etat[i0 + 1])
                                                    : cf4(K_IE2, o0);
        v = v + rz * ie;
      }
      q.out[2][g] = v;
      if (fs) mirror(q.out[2], g, a == 1, a == nx, b == 1, b == ny, sx, sy, v);
    }
  };

  // ---- the march: step k computes the new P and tau of plane k+1 and the
  // faces of plane k. It reads planes k..k+2 of the stencil ring and k+1 of
  // the point ring, which the previous step staged, and stages k+3 and k+2
  // meanwhile; one barrier per step (the new fields of plane k+1 go to the
  // other of two shared planes than plane k's).
  const int k0 = max(P0 - 2, -1);
  const int last4 = min(P1 + 1, X - 1), last2 = min(P1, X - 1);
  for (int a = max(k0, 0); a <= min(k0 + 2, last4); ++a) stage(q.r4, s4, q.n4, D4, a);
  if (k0 + 1 <= last2) stage(q.r2, s2, q.n2, D2, k0 + 1);
  T t0[N_NEW], t1[N_NEW], txy_m = T(0), txz_m = T(0);
#pragma unroll
  for (int f = 0; f < N_NEW; ++f) t0[f] = t1[f] = T(0);
  for (int k = k0; k < P1; ++k) {
    cp_async_wait_all();
    __syncthreads();
    if (k + 3 <= last4) stage(q.r4, s4, q.n4, D4, k + 3);
    if (k + 2 <= last2) stage(q.r2, s2, q.n2, D2, k + 2);
    const int o0 = (k & 3) * NW, o1 = ((k + 1) & 3) * NW, o2 = ((k + 2) & 3) * NW;
    if (valid && k + 1 <= X - 1) {
      new_stresses(k + 1, o0, o1, o2, ((k + 1) & 1) * NW, t1);
      T* nw = sn + ((k + 1) & 1) * NW + p;
      nw[0] = t1[0];
#pragma unroll
      for (int f = 1; f < N_SHARED; ++f) nw[2 * f * NW] = t1[f + 1];
    }
    if (owned && k >= P0) faces(k, o0, o1, (k & 1) * NW, t0, t1, txy_m, txz_m);
    txy_m = t0[6];
    txz_m = t0[5];
#pragma unroll
    for (int f = 0; f < N_NEW; ++f) t0[f] = t1[f];
  }
}

template <typename T> void fill(const T** dst, void** src, int n) {
  for (int j = 0; j < n; ++j) dst[j] = static_cast<const T*>(src[j]);
}

// The face coefficients stream four planes deep, the others two
inline bool face_coef(int id) { return id >= K_IE0; }

template <typename T>
int run_chunk(void** in, void** w0, void** w1, const void* coefs, const int* slots,
              const double* vals, const void* base, const int* derive,
              const double* dscal, int nx, int ny, int nz, int nout,
              const double* inv_di, int free_slip, int xc, cudaStream_t stream) {
  constexpr int TY = Tile<T>::TY, TZ = Tile<T>::TZ;
  const int64_t n = (int64_t)(nx + 2) * (ny + 2) * (nz + 2);
  const T* cbase = static_cast<const T*>(coefs);
  const T* dbase = static_cast<const T*>(base);
  Params<T> q;
  q.nx = nx; q.ny = ny; q.nz = nz;
  q.free_slip = free_slip;
  q.inv_dx = T(inv_di[0]); q.inv_dy = T(inv_di[1]); q.inv_dz = T(inv_di[2]);
  q.r_theta = T(dscal[0]); q.dtau_r = T(dscal[1]); q.etadtau = T(dscal[2]);
  q.c3_mode = derive[0];
  // r4: Vx, Vy, Vz, [eta], [eta_tau], the face canvases; r2: P, tau, the rest
  q.n4 = 3;
  q.n2 = N_NEW;
  q.i_eta = q.i_etat = -1;
  if (derive[1]) { q.i_eta = q.n4; q.r4[q.n4++] = dbase; }
  if (derive[2]) { q.i_etat = q.n4; q.r4[q.n4++] = dbase + n; }
  for (int j = 0; j < N_COEF; ++j) {
    q.slot[j] = slots[j];
    q.val[j] = T(vals[j]);
    q.where[j] = -1;
    if (slots[j] < 0) continue;
    const T* src = cbase + slots[j] * n;
    if (face_coef(j)) { q.where[j] = q.n4; q.r4[q.n4++] = src; }
    else { q.where[j] = q.n2; q.r2[q.n2++] = src; }
  }
  const size_t smem = (size_t)(D4 * q.n4 + D2 * q.n2 + 2 * N_SHARED) * (TY + 2) * (TZ + 2) *
                      sizeof(T);
  bool gen = false;
  for (int j = 0; j < N_COEF; ++j) gen = gen || slots[j] >= 0;
  auto kern = gen ? k_iteration<T, TY, TZ, true> : k_iteration<T, TY, TZ, false>;
  constexpr int nt = threads<TY, TZ>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_yz = ((ny + TY - 1) / TY) * ((nz + TZ - 1) / TZ);
  q.xc = xc > 0 ? xc : nx;
  const int blocks = tiles_yz * ((nx + q.xc - 1) / q.xc);

  void** set[2] = {w0, w1};
  for (int it = 0; it < nout; ++it) {
    void** src = it == 0 ? in : set[(it - 1) % 2];
    fill(q.r4, src, 3);
    fill(q.r2, src + 3, N_NEW);
    for (int j = 0; j < N_CARRY; ++j) q.out[j] = static_cast<T*>(set[it % 2][j]);
    kern<<<blocks, nt, smem, stream>>>(q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). `in`, `w0` and `w1` each hold the
// 10 canvases Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy, (nx+2, ny+2, nz+2)
// each: iteration k reads `in` (k = 0) or work set (k - 1) % 2 and writes
// work set k % 2, so the result is in work set (nout - 1) % 2 and `in` is
// never written. `coefs` is the (n_canvas, nx+2, ny+2, nz+2) coefficient
// stack; `slots` and `vals` the 23 coefficients' slot table (a canvas, -1
// for the scalar in `vals`, -2 absent, -3 derived) and scalar values; `base`
// the (2, nx+2, ny+2, nz+2) edge-padded eta and eta_tau; `derive` = (c3
// mode, eta read, eta_tau read); `dscal` = (r/theta_dtau, dtau_r, etadtau);
// `inv_di` 1/dx, 1/dy, 1/dz; `xc` the interior x planes per block (0: all).
// Launches on `stream` without synchronising; returns the first launch
// error, or 0.
extern "C" int jr_stokes3d_ve_chunk_f32(void** in, void** w0, void** w1, const void* coefs,
                                        const int* slots, const double* vals,
                                        const void* base, const int* derive,
                                        const double* dscal, int nx, int ny, int nz,
                                        int nout, const double* inv_di, int free_slip,
                                        int xc, void* stream) {
  return run_chunk<float>(in, w0, w1, coefs, slots, vals, base, derive, dscal, nx, ny, nz,
                          nout, inv_di, free_slip, xc, (cudaStream_t)stream);
}

extern "C" int jr_stokes3d_ve_chunk_f64(void** in, void** w0, void** w1, const void* coefs,
                                        const int* slots, const double* vals,
                                        const void* base, const int* derive,
                                        const double* dscal, int nx, int ny, int nz,
                                        int nout, const double* inv_di, int free_slip,
                                        int xc, void* stream) {
  return run_chunk<double>(in, w0, w1, coefs, slots, vals, base, derive, dscal, nx, ny, nz,
                           nout, inv_di, free_slip, xc, (cudaStream_t)stream);
}

extern "C" const char* jr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
