"""Where the time of the 3D VEP edge passes (B6, B9) goes on the card: the
edge kernel beside variants of the one-thread-per-slot form it replaced.

    python -m justrelax_tpu_torch.scripts.probe_edges [--n 126] [--repeats 20]

Run from the root of a checkout, on a machine with a CUDA card. The variants
are CUDA kernels appended to ``csrc/stokes3d_vep.cu`` (they share its return
mapping) and built with it into ``justrelax_tpu_torch/_build/``; nothing in
the package calls them. On the ShearBand3D n³ f32 step's first-chunk inputs
(route ``"edges"`` for B6, ``"edges_split"`` for B9) and on its set-up near
yield (``chip_smoke.vep3d_case("shearband3d_kb_inf")``), by CUDA events, in
turns:

- ``kernel``: this tree's ``vep3d_edges``;
- ``slot``: one thread per slot in 32×8 blocks of one x plane, strain rates
  re-derived from V at every point read and 1/η divided at every read;
- ``pre``: ``slot`` with the strain rates and 1/η read from seven canvases
  that ``derive`` computed before (one thread per slot, each point once);
- ``derive``: those seven canvases alone;
- ``slot3``: ``slot`` with B9's three families in one kernel (B6: ``slot``);
- ``stage``: one thread per slot that reads every input once and writes
  every output, with no arithmetic;
- ``march0``, ``march1``: this tree's kernel with no family (its staging,
  strain rates and barriers) and with family 0 alone.

Each line gives ms per call, the bound from ``chip_smoke.vep3d_edges_words``
and each variant's largest difference from the plain version, relative to
each field's max.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess

import torch

import chip_smoke as cs
from justrelax_tpu_torch.models import shearband3d
from justrelax_tpu_torch.ops import _cuda_build
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.solvers.stokes3d_vep import canvas_chunk_inputs

PROBE_CU = r"""
namespace {
// The edge passes' view of seven precomputed canvases: the normal strain
// rates and 1/eta at the cells, the shear strain rates at the edges.
template <typename T> struct CanvasView {
  using Index = int64_t;
  const Args<T>& g;
  const T* d;  // en0..2, 1/eta, es0..2, each a canvas of n slots
  int64_t n;
  __device__ int64_t at(const int* c) const { return lin(g, c); }
  __device__ T theta(int64_t p) const { return g.theta[p]; }
  __device__ T inv_eta(int64_t p) const { return d[3 * n + p]; }
  __device__ T tc(int j, int64_t p) const { return g.tc[j][p]; }
  __device__ T te(int m, int64_t p) const { return g.te[m][p]; }
  __device__ void normal(int64_t p, T* e) const {
    for (int j = 0; j < 3; ++j) e[j] = d[j * n + p];
  }
  __device__ T shear(int m, int64_t p) const { return d[(4 + m) * n + p]; }
  __device__ T old4(int k, int j, const int64_t* w) const {
    return avg_at(g.to[k][j], g.tov[k][j], w);
  }
};

// The slot's family K on global memory, strain rates re-derived at every read
template <typename T> struct SlotView {
  using Index = int64_t;
  const Args<T>& g;
  __device__ int64_t at(const int* c) const { return lin(g, c); }
  __device__ T theta(int64_t p) const { return g.theta[p]; }
  __device__ T inv_eta(int64_t p) const { return T(1) / g.eta[p]; }
  __device__ T tc(int j, int64_t p) const { return g.tc[j][p]; }
  __device__ T te(int m, int64_t p) const { return g.te[m][p]; }
  __device__ void normal(int64_t p, T* e) const { normal_strain(g, p, e); }
  __device__ T shear(int m, int64_t p) const { return shear_strain(g, m, p); }
  __device__ T old4(int k, int j, const int64_t* w) const {
    return avg_at(g.to[k][j], g.tov[k][j], w);
  }
};

template <typename T>
__global__ void __launch_bounds__(256) k_probe_derive(const Args<T> g, T* d) {
  SLOT_OR_RETURN(g)
  const int64_t n = (g.n[0] + 2) * g.st[0];
  if (is_cell(g, s)) {
    T e[3];
    normal_strain(g, i, e);
    for (int j = 0; j < 3; ++j) d[j * n + i] = e[j];
    d[3 * n + i] = T(1) / g.eta[i];
  }
  if (s[0] <= g.n[0] && s[1] <= g.n[1] && s[2] <= g.n[2])
    for (int m = 0; m < 3; ++m) d[(4 + m) * n + i] = shear_strain(g, m, i);
}

// FAM -1: B6's three families; 0..2: one hoisted family; 3: the three
// hoisted families in one kernel
template <typename T, int FAM, bool PRE>
__global__ void __launch_bounds__(256) k_probe_edges(const Args<T> g, const T* d) {
  constexpr bool HOIST = FAM >= 0, ALL = FAM < 0 || FAM == 3;
  SLOT_OR_RETURN(g)
  if constexpr (PRE) {
    const CanvasView<T> v{g, d, (g.n[0] + 2) * g.st[0]};
    if (ALL || FAM == 0) run_family<T, 0, HOIST>(g, v, s, i, i);
    if (ALL || FAM == 1) run_family<T, 1, HOIST>(g, v, s, i, i);
    if (ALL || FAM == 2) run_family<T, 2, HOIST>(g, v, s, i, i);
  } else {
    const SlotView<T> v{g};
    if (ALL || FAM == 0) run_family<T, 0, HOIST>(g, v, s, i, i);
    if (ALL || FAM == 1) run_family<T, 1, HOIST>(g, v, s, i, i);
    if (ALL || FAM == 2) run_family<T, 2, HOIST>(g, v, s, i, i);
  }
}

// every input read once at the slot, every output written; the reads reach
// memory through a sum that is stored only where dt < 0 (never)
// (a B9 call of one family reads the shared inputs only with family 0)
template <typename T>
__global__ void __launch_bounds__(256) k_probe_stage(const Args<T> g, bool hoist, bool shared) {
  SLOT_OR_RETURN(g)
  T acc = T(0);
  if (shared) acc = g.Vx[i] + g.Vy[i] + g.Vz[i] + g.theta[i] + g.eta[i];
  for (int k = 0; k < 3; ++k) {
    if (shared) acc += g.tc[k][i];
    if (!g.ote[k]) continue;
    if (g.G[k]) acc += g.G[k][i];
    for (int j = 0; j < 6; ++j)
      if ((hoist || k == 0) && g.to[k][j]) acc += g.to[k][j][i];
  }
  for (int k = 0; k < 3; ++k) {
    if (!g.ote[k]) continue;
    g.ote[k][i] = g.dt < T(0) ? acc : g.te[k][i];
    g.ole[k][i] = g.le[k][i];
  }
}

// variant 0 derive, 1 pre, 2 stage, 3 slot, 4 slot3, 5 march0, 6 march1;
// family -1 (B6), 0..2 or 3 (B9: all three families, hoisted)
template <typename T, bool PRE>
void probe_edges(const Args<T>& g, int family, const T* d, dim3 grid, dim3 blk,
                 cudaStream_t stream) {
  if (family < 0) {
    k_probe_edges<T, -1, PRE><<<grid, blk, 0, stream>>>(g, d);
    return;
  }
  if (family == 0 || family == 3) k_probe_edges<T, 0, PRE><<<grid, blk, 0, stream>>>(g, d);
  if (family == 1 || family == 3) k_probe_edges<T, 1, PRE><<<grid, blk, 0, stream>>>(g, d);
  if (family == 2 || family == 3) k_probe_edges<T, 2, PRE><<<grid, blk, 0, stream>>>(g, d);
}

template <typename T>
int probe(const void* const* ptrs, const double* vals, int nx, int ny, int nz, int family,
          int variant, void* derived, cudaStream_t stream) {
  const Args<T> g = edge_args<T>(ptrs, vals, nx, ny, nz);
  const dim3 blk(32, 8, 1);
  const dim3 grid((nz + 2 + 31) / 32, (ny + 2 + 7) / 8, nx + 2);
  T* d = static_cast<T*>(derived);
  const bool first = family <= 0 || family == 3;  // a B9 call of one family: family 0's
  if (variant == 0) {
    if (first) k_probe_derive<T><<<grid, blk, 0, stream>>>(g, d);
  } else if (variant == 1) {
    probe_edges<T, true>(g, family, d, grid, blk, stream);
  } else if (variant == 2) {
    k_probe_stage<T><<<grid, blk, 0, stream>>>(g, family >= 0, first);
  } else if (variant == 4 && family == 3) {
    k_probe_edges<T, 3, false><<<grid, blk, 0, stream>>>(g, d);
  } else if (variant == 5 || variant == 6) {
    // the march with no family (staging, strain rates, barriers) or family 0 alone
    const int mask = variant == 5 ? 0 : 1;
    bool toc = false;
    for (int j = 0; j < 6; ++j) toc = toc || (family < 0 && g.to[0][j] != nullptr);
    if (family >= 0) return launch_march<T, true, false>(g, mask, stream);
    return toc ? launch_march<T, false, true>(g, mask, stream)
               : launch_march<T, false, false>(g, mask, stream);
  } else {
    probe_edges<T, false>(g, family, d, grid, blk, stream);
  }
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int probe_edges_f32(const void* const* ptrs, const double* vals, int nx, int ny,
                               int nz, int family, int variant, void* derived, void* stream) {
  return probe<float>(ptrs, vals, nx, ny, nz, family, variant, derived, (cudaStream_t)stream);
}
"""

VARIANTS = {"derive": 0, "pre": 1, "stage": 2, "slot": 3, "slot3": 4, "march0": 5,
            "march1": 6}


@functools.lru_cache(maxsize=None)
def library():
    """The edge source with the probe kernels appended, built and bound."""
    src = _cuda_build._BUILD_DIR / "probe_edges.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(he.SOURCE.read_text() + PROBE_CU)
    lib = he._bind(_cuda_build.load_library(src))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_edges_f32.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_double),
                                    i, i, i, i, i, vp, vp]
    lib.probe_edges_f32.restype = i
    return lib


class _Variant:
    """``library()`` seen by ``hopper_vep3d_edges._launch`` as an edge
    library whose f32 entry runs one probe variant."""

    def __init__(self, variant, derived):
        self._lib = library()
        self.jr_cuda_error_string = self._lib.jr_cuda_error_string

        def fn(ptrs, vals, nx, ny, nz, family, stream):
            return self._lib.probe_edges_f32(ptrs, vals, nx, ny, nz, family, variant,
                                             derived.data_ptr(), stream)
        self.jr_vep3d_edges_f32 = fn


def states(n, dev):
    """{(kernel, state): (positional, keyword) arguments of vep3d_edges}."""
    geometry, st0, material, (pr_c, pr_e), _, pt, dt = shearband3d._setup(n, torch.float32,
                                                                          dev)
    kw = dict(dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0)
    inv_di = tuple(1.0 / d for d in geometry.di)
    near, co6, co9, _, inv_near, kw_near = cs.vep3d_case("shearband3d_kb_inf", torch.float32,
                                                         dev, n=n)
    out = {}
    for name, route, split in (("B6", "edges", False), ("B9", "edges_split", True)):
        carry, _, packed = canvas_chunk_inputs(st0, material, pr_c, pr_e, route=route)
        args, ekw = cs.edge_args(carry, packed, inv_di, kw)
        out[(name, "first_chunk")] = (args, dict(ekw, split=split))
        args, ekw = cs.edge_args(near, he.pack_edge_consts(co9 if split else co6, split),
                                 inv_near, kw_near)
        out[(name, "near_yield")] = (args, dict(ekw, split=split))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=126)
    p.add_argument("--repeats", type=int, default=20, help="calls per timed run")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_edges: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = "PCIe" if "PCIe" in torch.cuda.get_device_name(0) else "SXM"
    n = a.n
    derived = torch.empty((7, n + 2, n + 2, n + 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for (name, state), (args, ekw) in states(n, dev).items():
        V, theta, eta, tcn, te, le, co, inv_di = args
        dyn = (*V, theta, eta, *tcn, *te, *le)

        def run(variant):
            def call():
                if variant == "kernel":
                    return he.vep3d_edges(*args, **ekw)
                if variant == "pre":
                    he._launch(_Variant(0, derived), stream, dyn, co, inv_di, ekw["dt"],
                               ekw["theta_dtau"], ekw["lambda_relaxation"], ekw["split"])
                return he._launch(_Variant(VARIANTS[variant], derived), stream, dyn, co, inv_di,
                                  ekw["dt"], ekw["theta_dtau"], ekw["lambda_relaxation"],
                                  ekw["split"])
            return call

        order = ("kernel", "march0", "march1", "slot", "slot3", "pre", "derive", "stage")
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            fn = run(v)
            times[v].append(cs.cuda_time_ms(lambda: [fn() for _ in range(a.repeats)])
                            / a.repeats)
        ref = he.vep3d_edges_reference(*args, **ekw)
        diffs = {}
        for v in ("kernel", "slot", "pre", "slot3"):
            out = run(v)()
            diffs[v] = max(cs.rel_diffs_edges((*out[0], *out[1]), (*ref[0], *ref[1])).values())
        slot = run("slot")()
        slot = (*slot[0], *slot[1])
        # where the kernel and slot3 differ from the slot form: per output,
        # the slots that differ and how many of them yield (λ_e moved)
        moved = [o != i for o, i in zip(slot[3:], le)]
        apart = {}
        for v in ("kernel", "slot3"):
            out = run(v)()
            out = (*out[0], *out[1])
            apart[v] = {name: [int((x != y).sum()), int(((x != y) & moved[k % 3]).sum()),
                               float((x - y).abs().max())]
                        for k, (name, x, y) in enumerate(zip(cs.VEP3D_EDGE_FIELDS, out, slot))}
        kern = run("kernel")()
        words = cs.vep3d_edges_words(he.pack_edge_consts(co, ekw["split"]))
        bound = cs.bound_ms(words, n ** 3, 4, kind)
        print(json.dumps({
            "probe": "edges", "kernel": name, "state": state, "n": n, "dtype": "float32",
            "ms": times, "pre_plus_derive_ms": min(times["pre"]),
            "pre_alone_ms": min(times["pre"]) - min(times["derive"]),
            "words": words, "bound_ms": bound, "bound_share": bound / min(times["kernel"]),
            "max_rel_diff": diffs,
            "kernel_equals_slot": all(torch.equal(x, y) for x, y in
                                      zip((*kern[0], *kern[1]), slot)),
            "apart_from_slot": apart,
            "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
