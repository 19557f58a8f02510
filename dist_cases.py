"""The distributed solves' parity cases and the card's distributed cell,
for the CPU tests and ``chip_smoke.py`` phase 42.

A case is a sharded solve of a set-up of the JAX package's distributed
tests (SolCx and the VE solve with every term, the 2D and 3D thermal
diffusion, the two-phase VEP shear band over loading steps, the sticky-air
variational blob), on a named mesh, at fixed iterations.
:func:`serial_solve` runs the same set-up through the port's serial plain
solver; :func:`field_diffs` holds the two. The set-ups are numpy, so the
CPU tests feed the same inputs to the JAX package.

:func:`run_suite` is what each rank of a world runs; :func:`world` starts
four of them through ``justrelax_tpu_torch.parallel.launch``, which a
user may also run under torchrun::

    torchrun --nproc-per-node=4 -m justrelax_tpu_torch.parallel.launch \
        dist_cases:run_suite OUT solves card
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.models import solcx
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    flow_bcs,
    thermal_bcs,
)
from justrelax_tpu_torch.parallel import halo, launch, multihost
from justrelax_tpu_torch.parallel.decomp import (
    Decomp2D,
    Decomp3D,
    block_staggered,
    block_staggered_nd,
    unblock_staggered,
    unblock_staggered_nd,
)
from justrelax_tpu_torch.parallel.mesh import make_grid_mesh

# per-tile surplus over the owned cells of each 2D block (decomp.py)
EXTRAS = {
    "Vx": (1, 2), "Vy": (2, 1), "txy": (1, 1), "txy_o": (1, 1),
    "txy_v": (1, 1), "txy_v_o": (1, 1), "eta_v": (1, 1), "lam_v": (1, 1),
    "phi_v": (1, 1), "vm_v": (1, 1), "vm_vx": (1, 0), "vm_vy": (0, 1), "T": (2, 2),
}
VE_FIELDS = ("Vx", "Vy", "P", "txx", "tyy", "txy")
VEP_FIELDS = ("Vx", "Vy", "P", "txx", "tyy", "txy_c", "txy_v", "tau_II", "lam", "lam_v",
              "eta")
FREE_SLIP = dict(free_slip=Faces(left=True, right=True, top=True, bot=True))


@dataclasses.dataclass(frozen=True)
class Case:
    """One sharded solve: ``kind`` (ve, thermal, thermal3d, vep,
    variational), its set-up, the grid, the mesh and the fixed iterations
    (``nt`` loading steps for the VEP)."""

    label: str
    kind: str
    n: int
    mesh: tuple
    iters: int
    nout: int
    setup: str = ""
    overlap: bool = True
    nt: int = 1


def suite_cases(size: str = "test") -> Dict[str, Case]:
    """The cases of one world of four ranks: the CPU tests' sizes
    (``test``, 16², 8³) or the JAX tests' (``card``, 32², 16³; the VEP and
    the variational blob at their tests' 16² either way)."""
    small = size == "test"
    n2, n3 = (16, 8) if small else (32, 16)
    ve_it, ve_out = (300, 100) if small else (100, 50)
    # the thermal solves stop well before err reaches rounding (1e-5 to
    # 1e-3), so that err compares across summation orders
    th_it, th_out = 100, 50
    th3_it, th3_out = (60, 30) if small else (100, 50)
    vep_it, vep_nt, var_it = (200, 2, 200) if small else (100, 2, 100)
    cases = [
        Case("ve_solcx", "ve", n2, (2, 2), ve_it, ve_out, "solcx", overlap=True),
        Case("ve_solcx_no_overlap", "ve", n2, (2, 2), ve_it, ve_out, "solcx", overlap=False),
        Case("ve_full_terms", "ve", n2, (4, 1), ve_it, ve_out, "full_terms", overlap=True),
        Case("ve_full_terms_no_overlap", "ve", n2, (4, 1), ve_it, ve_out, "full_terms",
             overlap=False),
        Case("thermal2d", "thermal", n2, (2, 2), th_it, th_out),
        Case("thermal3d_xy", "thermal3d", n3, (2, 2, 1), th3_it, th3_out),
        Case("thermal3d_yz", "thermal3d", n3, (1, 2, 2), th3_it, th3_out),
        Case("vep_2x2", "vep", 16, (2, 2), vep_it, 100, nt=vep_nt),
        Case("vep_4x1", "vep", 16, (4, 1), vep_it, 100, nt=vep_nt),
        Case("variational", "variational", 16, (2, 2), var_it, min(var_it, 100)),
    ]
    return {c.label: c for c in cases}


def setup_key(case: Case):
    """Cases that differ only in their mesh or ``overlap`` share a serial
    reference."""
    return (case.kind, case.setup, case.n, case.iters, case.nout, case.nt)


def setups(cases: Dict[str, Case]) -> Dict[str, Case]:
    """The first case of each set-up, by label."""
    out, seen = {}, set()
    for label, case in cases.items():
        if setup_key(case) not in seen:
            seen.add(setup_key(case))
            out[label] = case
    return out


# ---- set-ups (numpy) --------------------------------------------------------
def ve_inputs(setup: str, n: int) -> dict:
    """The VE solve of tests/test_distributed.py: SolCx (Δη 1e6, G = K = ∞)
    or every term (a varying η, finite G and K, a source Q, old stresses,
    gravity along both axes)."""
    geometry = Geometry((n, n), (1.0, 1.0))
    z = np.zeros((n, n))
    if setup == "solcx":
        return dict(n=n, eta=solcx.solcx_viscosity(geometry, 1.0e6), rho_x=z,
                    rho_y=solcx.solcx_density(geometry), Q=z, txx_o=z, tyy_o=z,
                    txy_o=np.zeros((n + 1, n + 1)), G=np.full((n, n), np.inf),
                    K=np.full((n, n), np.inf), dt=0.1)
    rng = np.random.default_rng(7)
    d = dict(n=n, eta=np.exp(rng.uniform(0.0, 2.0, (n, n))),
             rho_x=0.3 * rng.standard_normal((n, n)),
             rho_y=1.0 + 0.2 * rng.standard_normal((n, n)),
             Q=0.05 * rng.standard_normal((n, n)))
    d.update(txx_o=0.1 * rng.standard_normal((n, n)), tyy_o=0.1 * rng.standard_normal((n, n)),
             txy_o=0.1 * rng.standard_normal((n + 1, n + 1)), G=np.full((n, n), 5.0),
             K=np.full((n, n), 8.0), dt=0.25)
    return d


def ve_pt(n):
    g = Geometry((n, n), (1.0, 1.0))
    return g, PTStokesCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0,
                                  eps_rel=0.0)


def thermal_inputs(n: int) -> dict:
    """tests/test_distributed_thermal.py: a Gaussian bump between T = 2 at
    the bottom and 1 at the top, insulated sides, K = ρCp = 1, H = 0."""
    g = Geometry((n, n), (1.0, 1.0))
    T0 = np.zeros((n + 2, n + 2))
    X, Y = g.cell_centers_mesh()
    T0[1:-1, 1:-1] = 1.0 + np.exp(-((X - 0.4) ** 2 + (Y - 0.6) ** 2) / 0.02)
    return dict(n=n, T0=T0, K=np.ones((n, n)), rho_Cp=np.ones((n, n)), H=np.zeros((n, n)),
                dt=0.05, bc=dict(no_flux=dict(left=True, right=True),
                                 constant_value=dict(top=1.0, bot=2.0)))


def thermal3d_inputs(n: int) -> dict:
    """tests/test_distributed_thermal3d.py: a varying K, a heat source and
    random T between T = 120 at the bottom and 100 at the top."""
    rng = np.random.default_rng(0)
    ni = (n, n, n)
    T0 = np.zeros((n + 2,) * 3)
    K = np.exp(0.3 * rng.normal(size=ni))
    H = 0.1 * rng.normal(size=ni)
    T0[1:-1, 1:-1, 1:-1] = 100.0 + 10.0 * rng.normal(size=ni)
    return dict(n=n, T0=T0, K=K, rho_Cp=np.ones(ni), H=H, dt=0.05,
                bc=dict(constant_value=dict(top=100.0, bot=120.0),
                        no_flux=dict(left=True, right=True, front=True, back=True)))


def thermal_objects(d, ndim, device, dtype):
    """(geometry, bc, T with its BCs, K, ρCp, H, coefficients) on ``device``;
    ``eps = 1e-30`` fixes the iterations (``eps = 0`` would run none: err
    starts at 2ϵ)."""
    n = d["n"]
    g = Geometry((n,) * ndim, (1.0,) * ndim)
    bc = TemperatureBoundaryConditions(no_flux=Faces(**d["bc"]["no_flux"]),
                                       constant_value=Faces(**d["bc"]["constant_value"]))
    f = dict(dtype=dtype, device=device)
    T = thermal_bcs(torch.as_tensor(d["T0"], **f), bc)
    K, rc, H = (torch.as_tensor(d[k], **f) for k in ("K", "rho_Cp", "H"))
    kw = {} if ndim == 2 else dict(CFL=0.9 / math.sqrt(3.0))
    pt = PTThermalCoeffs.make(K, rc, d["dt"], g.di, g.li, eps=1e-30, **kw)
    return g, bc, T, K, rc, H, pt


def vep_material(device, dtype):
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack

    tau_y, phi = 0.8, 30.0
    common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                  C=tau_y / math.cos(math.radians(phi)), friction_angle=phi, eta_reg=8.0e-3)
    return MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)],
                              dtype=dtype, device=device)


def vep_inputs(n: int) -> dict:
    """tests/test_distributed_vep2d.py: a two-phase Drucker-Prager band
    under pure shear, its weak inclusion off center so that it straddles
    the tiles."""
    g = Geometry((n, n), (1.0, 1.0))

    def circle(xs, ys):
        X, Y = np.meshgrid(np.asarray(xs), np.asarray(ys), indexing="ij")
        inside = (X - 0.45) ** 2 + (Y - 0.6) ** 2 <= 0.22**2
        ratios = np.zeros(X.shape + (2,))
        ratios[..., 0] = ~inside
        ratios[..., 1] = inside
        return ratios

    xv, yv = np.asarray(g.xvi[0]), np.asarray(g.xvi[1])
    Vx = np.broadcast_to(xv[:, None], (n + 1, n + 2)).copy()
    Vy = np.broadcast_to(-yv[None, :], (n + 2, n + 1)).copy()
    Vx, Vy = (t.numpy() for t in flow_bcs((torch.as_tensor(Vx), torch.as_tensor(Vy)),
                                           VelocityBoundaryConditions(**FREE_SLIP)))
    return dict(n=n, pr_c=circle(g.xci[0], g.xci[1]), pr_v=circle(g.xvi[0], g.xvi[1]),
                Vx=Vx, Vy=Vy, dt=0.25)


def vep_pt(n):
    g = Geometry((n, n), (1.0, 1.0))
    return g, PTStokesCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0,
                                  CFL=0.75 / math.sqrt(2.1))


def variational_inputs(n: int) -> dict:
    """tests/test_distributed_variational.py: a dense blob in fluid under a
    sticky-air layer (phase 1), its RockRatio and validity masks."""
    from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio, valid_masks
    from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field

    g = Geometry((n, n), (1.0, 1.0))
    X, Y = (np.asarray(A) for A in g.cell_centers_mesh())
    phase = np.zeros((n, n), dtype=np.int64)
    phase[Y > 0.75] = 1
    phase[(X - 0.45) ** 2 + (Y - 0.4) ** 2 <= 0.15**2] = 2
    pr = phase_ratios_from_field(torch.as_tensor(phase), 3)
    phi = update_rock_ratio(pr, air_phase=1)
    vm = valid_masks(phi)
    return dict(n=n, phase=phase, pr_c=pr.center.numpy(), pr_v=pr.vertex.numpy(),
                phi_c=phi.center.numpy(), phi_v=phi.vertex.numpy(), vm_c=vm.c.numpy(),
                vm_v=vm.v.numpy(), vm_vx=vm.vx.numpy(), vm_vy=vm.vy.numpy())


def variational_material(device, dtype):
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack

    return MaterialStack.make([
        Material(rho0=1.0, eta0=1.0, gravity=10.0),
        Material(rho0=0.0, eta0=1.0e-3, gravity=10.0),  # air
        Material(rho0=2.0, eta0=1.0, gravity=10.0),
    ], dtype=dtype, device=device)


def inputs(case: Case) -> dict:
    return {"ve": lambda: ve_inputs(case.setup, case.n),
            "thermal": lambda: thermal_inputs(case.n),
            "thermal3d": lambda: thermal3d_inputs(case.n),
            "vep": lambda: vep_inputs(case.n),
            "variational": lambda: variational_inputs(case.n)}[case.kind]()


# ---- the serial reference -----------------------------------------------------
def serial_solve(case: Case, device, dtype=torch.float64) -> dict:
    """The case through the port's serial plain solver on ``device``: the
    global fields as numpy (one dict per loading step for the VEP), with
    ``err`` and ``iters``."""
    from justrelax_tpu_torch.solvers.stokes2d import solve_ve
    from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
    from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
    from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

    d = inputs(case)
    f = dict(dtype=dtype, device=device)
    n = case.n
    if case.kind == "ve":
        g, pt = ve_pt(n)
        st = StokesState.make((n, n), **f)
        st = st.replace(
            viscosity=st.viscosity.replace(eta=torch.as_tensor(d["eta"], **f)),
            Q=torch.as_tensor(d["Q"], **f),
            tau_o=st.tau_o.replace(**{k: torch.as_tensor(d["t" + k + "_o"], **f)
                                      for k in ("xx", "yy", "xy")}))
        rho_g = (torch.as_tensor(d["rho_x"], **f), torch.as_tensor(d["rho_y"], **f))
        G, K = torch.as_tensor(d["G"], **f), torch.as_tensor(d["K"], **f)
        s, info = solve_ve(st, pt, g, VelocityBoundaryConditions(**FREE_SLIP), rho_g, G, K,
                           d["dt"], iter_max=case.iters, nout=case.nout, use_kernel=False)
        out = dict(Vx=s.V.Vx, Vy=s.V.Vy, P=s.P, txx=s.tau.xx, tyy=s.tau.yy, txy=s.tau.xy)
        return _np(out, info)
    if case.kind in ("thermal", "thermal3d"):
        ndim = 2 if case.kind == "thermal" else 3
        g, bc, T, K, rc, H, pt = thermal_objects(d, ndim, device, dtype)
        th = ThermalState.make(g.ni, **f).replace(T=T, Told=T, H=H)
        th, info = heatdiffusion_PT(th, pt, bc, d["dt"], g, K=K, rho_Cp=rc,
                                    iter_max=case.iters, nout=case.nout, use_kernel=False)
        return _np(dict(T=th.T), info)
    if case.kind == "vep":
        g, pt = vep_pt(n)
        mat = vep_material(device, dtype)
        st = StokesState.make((n, n), **f)
        st = st.replace(V=st.V.replace(Vx=torch.as_tensor(d["Vx"], **f),
                                       Vy=torch.as_tensor(d["Vy"], **f)))
        pr_c, pr_v = (torch.as_tensor(d[k], **f) for k in ("pr_c", "pr_v"))
        steps = []
        for _ in range(case.nt):
            st, info = solve_vep(st, pt, g, VelocityBoundaryConditions(**FREE_SLIP), mat,
                                 pr_c, pr_v, d["dt"], iter_max=case.iters, iter_min=100,
                                 nout=case.nout, use_kernel=False)
            steps.append(_np(dict(
                Vx=st.V.Vx, Vy=st.V.Vy, P=st.P, txx=st.tau.xx, tyy=st.tau.yy,
                txy_c=st.tau.xy_c, txy_v=st.tau.xy, tau_II=st.tau.II, lam=st.lam,
                lam_v=st.lam_v, eta=st.viscosity.eta), info))
        return dict(steps=steps)
    from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio
    from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field

    g, _ = ve_pt(n)
    pt = PTStokesCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0, CFL=1.0 / math.sqrt(2.1))
    pr = phase_ratios_from_field(torch.as_tensor(d["phase"], device=device), 3, dtype=dtype)
    phi = update_rock_ratio(pr, air_phase=1)
    s, info = solve_variational(StokesState.make((n, n), **f), pt, g,
                                VelocityBoundaryConditions(**FREE_SLIP),
                                variational_material(device, dtype), pr.center, pr.vertex,
                                phi, math.inf, iter_max=case.iters, iter_min=100,
                                nout=case.nout)
    return _np(dict(Vx=s.V.Vx, Vy=s.V.Vy, P=s.P, txx=s.tau.xx, tyy=s.tau.yy,
                    txy_c=s.tau.xy_c, txy_v=s.tau.xy, tau_II=s.tau.II, lam=s.lam,
                    eta=s.viscosity.eta), info)


def _np(fields: dict, info) -> dict:
    out = {k: v.detach().cpu().numpy() for k, v in fields.items()}
    out.update(err=float(info.err), iters=int(info.iters))
    return out


# ---- the sharded solve on a rank ------------------------------------------------
def _blocked(d2: Decomp2D, name, A):
    return block_staggered(np.asarray(A), d2, EXTRAS.get(name, (0, 0)))


def _blocked_phase(d2: Decomp2D, A, vertex):
    nl, p = d2.ni_local, (d2.px, d2.py)
    e = (1, 1, 0) if vertex else (0, 0, 0)
    return block_staggered_nd(np.asarray(A), nl + (A.shape[-1],), p + (1,), e)


def sharded_solve(case: Case, mesh, dtype=torch.float64) -> dict:
    """The case through the port's sharded solver on ``mesh`` (this rank's
    tiles on the mesh's device): the fields gathered into the blocked
    layout (numpy, on every rank), with ``err``, ``iters`` and the wall
    ``seconds`` of each solve."""
    from justrelax_tpu_torch.parallel.stokes2d import solve_ve_sharded
    from justrelax_tpu_torch.parallel.stokes2d_variational import solve_variational_sharded
    from justrelax_tpu_torch.parallel.stokes2d_vep import solve_vep_sharded
    from justrelax_tpu_torch.parallel.thermal import (
        heatdiffusion_PT_sharded,
        heatdiffusion_PT_sharded_3d,
    )

    d = inputs(case)
    n = case.n
    dev = mesh.device
    up = lambda A: multihost.blocks_from_global(mesh, A, dtype)  # noqa: E731

    def result(res, names, seconds):
        out = {k: multihost.gather_blocked(getattr(res, k), mesh) for k in names}
        out.update(err=float(res.err), iters=int(res.iters), seconds=seconds)
        return out

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    if case.kind in ("thermal", "thermal3d"):
        ndim = 2 if case.kind == "thermal" else 3
        g, bc, T, K, rc, H, pt = thermal_objects(d, ndim, "cpu", torch.float64)
        if ndim == 2:
            dec = Decomp2D.make(g.ni, case.mesh)
            Tb = up(block_staggered(T.numpy(), dec, (2, 2)))
            fn = heatdiffusion_PT_sharded
        else:
            dec = Decomp3D.make(g.ni, case.mesh)
            Tb = up(block_staggered_nd(T.numpy(), dec.ni_local, case.mesh, (2, 2, 2)))
            fn = heatdiffusion_PT_sharded_3d
        pt_local = dataclasses.replace(pt, theta_r_dtau=up(pt.theta_r_dtau.numpy()),
                                       dtau_rho=up(pt.dtau_rho.numpy()))
        (Tl, err, iters), s = timed(lambda: fn(mesh, dec, Tb, up(K.numpy()), up(rc.numpy()),
                                               up(H.numpy()), pt_local, bc, d["dt"], g.di,
                                               iter_max=case.iters, nout=case.nout))
        out = dict(T=multihost.gather_blocked(Tl, mesh))
        out.update(err=float(err), iters=int(iters), seconds=s)
        return out

    dec = Decomp2D.make((n, n), case.mesh)
    if case.kind == "ve":
        g, pt = ve_pt(n)
        z = np.zeros((n, n))
        glob = dict(Vx=np.zeros((n + 1, n + 2)), Vy=np.zeros((n + 2, n + 1)), P=z, P0=z,
                    Q=d["Q"], txx=z, tyy=z, txy=np.zeros((n + 1, n + 1)), txx_o=d["txx_o"],
                    tyy_o=d["tyy_o"], txy_o=d["txy_o"], eta=d["eta"], G=d["G"], K=d["K"],
                    rho_gx=d["rho_x"], rho_gy=d["rho_y"])
        blocks = {k: up(_blocked(dec, k, v)) for k, v in glob.items()}
        blocks.update(inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1])
        res, s = timed(lambda: solve_ve_sharded(
            mesh, dec, blocks, pt, VelocityBoundaryConditions(**FREE_SLIP), d["dt"],
            iter_max=case.iters, nout=case.nout, overlap=case.overlap))
        return result(res, VE_FIELDS, s)

    zc, zv = np.zeros((n, n)), np.zeros((n + 1, n + 1))
    blocks = dict(P=zc, Q=zc, EII_pl=zc, eta=np.ones((n, n)), eta_v=np.ones_like(zv),
                  txx=zc, tyy=zc, txy_c=zc, txy_v=zv, txx_o=zc, tyy_o=zc, txy_c_o=zc,
                  txy_v_o=zv)
    if case.kind == "vep":
        g, pt = vep_pt(n)
        mat = vep_material(dev, dtype)
        blocks.update(Vx=d["Vx"], Vy=d["Vy"])
        blocks = {k: up(_blocked(dec, k, v)) for k, v in blocks.items()}
        blocks.update(pr_c=up(_blocked_phase(dec, d["pr_c"], False)),
                      pr_v=up(_blocked_phase(dec, d["pr_v"], True)),
                      inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1])
        steps = []
        for _ in range(case.nt):
            res, s = timed(lambda: solve_vep_sharded(
                mesh, dec, blocks, pt, VelocityBoundaryConditions(**FREE_SLIP), mat, d["dt"],
                iter_max=case.iters, iter_min=100, nout=case.nout))
            for k in ("Vx", "Vy", "P", "eta", "eta_v", "txx", "tyy", "txy_c", "txy_v"):
                blocks[k] = getattr(res, k)
            for k in ("txx", "tyy", "txy_c", "txy_v"):
                blocks[k + "_o"] = getattr(res, k)
            steps.append(result(res, VEP_FIELDS, s))
        return dict(steps=steps)

    g, _ = ve_pt(n)
    pt = PTStokesCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0, CFL=1.0 / math.sqrt(2.1))
    blocks.update(Vx=np.zeros((n + 1, n + 2)), Vy=np.zeros((n + 2, n + 1)),
                  **{k: d[k] for k in ("phi_c", "phi_v", "vm_c", "vm_v", "vm_vx", "vm_vy")})
    blocks = {k: up(_blocked(dec, k, v)) if not k.startswith("vm")
              else multihost.blocks_from_global(mesh, _blocked(dec, k, v))
              for k, v in blocks.items()}
    blocks.update(pr_c=up(_blocked_phase(dec, d["pr_c"], False)),
                  pr_v=up(_blocked_phase(dec, d["pr_v"], True)),
                  inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1])
    res, s = timed(lambda: solve_variational_sharded(
        mesh, dec, blocks, pt, VelocityBoundaryConditions(**FREE_SLIP),
        variational_material(dev, dtype), math.inf, iter_max=case.iters, iter_min=100,
        nout=case.nout))
    return result(res, tuple(k for k in VEP_FIELDS if k != "lam_v"), s)


def unblock(case: Case, name: str, B: np.ndarray) -> np.ndarray:
    """A gathered blocked field back to the global array."""
    if case.kind == "thermal3d":
        n = case.n
        return unblock_staggered_nd(B, (n // case.mesh[0], n // case.mesh[1],
                                        n // case.mesh[2]), case.mesh, (2, 2, 2))
    dec = Decomp2D.make((case.n, case.n), case.mesh)
    return unblock_staggered(B, dec, EXTRAS.get(name, (0, 0)))


def field_diffs(case: Case, sharded: dict, serial: dict) -> dict:
    """Each field's max |sharded − serial| over max |serial| (0 where both
    are 0), the sharded result unblocked first."""
    out = {}
    for k, ref in serial.items():
        if k in ("err", "iters", "seconds") or k not in sharded:
            continue
        a = unblock(case, k, sharded[k])
        d = float(np.max(np.abs(a - ref), initial=0.0))
        scale = float(np.max(np.abs(ref), initial=0.0))
        out[k] = 0.0 if d == 0.0 else d / scale
    return out


def steps_of(result: dict):
    """A case's results as a list of loading steps (one for most kinds)."""
    return result["steps"] if "steps" in result else [result]


# ---- the halo checks (the CPU tests) ------------------------------------------
def halo_inputs(px, py, extra, axis, nxl=5, nyl=4):
    """tests/test_halo_unit.py's blocked container with the outermost
    layer of every tile along ``axis`` corrupted to −1e30."""
    ex, ey = (extra, 0) if axis == 0 else (0, extra)
    dec = Decomp2D(px=px, py=py, nxl=nxl, nyl=nyl)
    G = np.random.default_rng(0).normal(size=(px * nxl + ex, py * nyl + ey))
    B = block_staggered(G, dec, (ex, ey))
    sx, sy = nxl + ex, nyl + ey
    for rx in range(px):
        for ry in range(py):
            tile = B[rx * sx:(rx + 1) * sx, ry * sy:(ry + 1) * sy]
            if axis == 0:
                tile[0, :] = tile[-1, :] = -1e30
            else:
                tile[:, 0] = tile[:, -1] = -1e30
    return B, (nxl if axis == 0 else nyl)


def extend_inputs(px, py, nxl=4, nyl=6):
    dec = Decomp2D(px=px, py=py, nxl=nxl, nyl=nyl)
    return block_staggered(np.random.default_rng(1).normal(size=dec.ni_global), dec, (0, 0))


HALO_MESHES = ((2, 2), (4, 1), (1, 3))


def run_halo(group_of_three) -> dict:
    """Every halo case of the CPU tests on this rank: ``exchange_ghosts``
    (extra 1–3, both axes), ``extend`` (halo 1–2, both axes), the cyclic
    ``from_prev``/``from_next``, the refusal of a block without ghosts and
    the byte counter, on the meshes (2, 2), (4, 1) and (1, 3), the last over
    ranks 0–2 of a group. Gathered results on every member."""
    import torch.distributed as dist

    out = {}
    for shape in HALO_MESHES:
        group = group_of_three if math.prod(shape) == 3 else None
        if group is not None and dist.get_rank() not in dist.get_process_group_ranks(group):
            continue
        mesh = make_grid_mesh(shape, group=group, device="cpu")
        for extra in (1, 2, 3):
            for axis in (0, 1):
                B, n_owned = halo_inputs(*shape, extra, axis)
                A = torch.as_tensor(mesh.tile(B)).contiguous()
                halo.reset_counters()
                got = halo.exchange_ghosts(A, axis, n_owned, mesh=mesh)
                sent = torch.tensor([float(halo.bytes_sent), float(halo.exchanges)])
                out[("exchange", shape, extra, axis)] = multihost.gather_blocked(got, mesh)
                out[("bytes", shape, extra, axis)] = multihost.gather_blocked(
                    sent.reshape((1,) * len(shape) + (2,)), mesh)
        for h in (1, 2):
            for axis in (0, 1):
                A = torch.as_tensor(mesh.tile(extend_inputs(*shape)))
                out[("extend", shape, h, axis)] = multihost.gather_blocked(
                    halo.extend(A, axis, h, mesh=mesh), mesh)
        A = torch.as_tensor(mesh.tile(extend_inputs(*shape)))
        for name, fn in (("from_prev", halo.from_prev), ("from_next", halo.from_next)):
            for axis, mesh_axis in ((0, "x"), (1, "y")):
                edge = A.narrow(axis, 0, 1)
                out[(name, shape, mesh_axis)] = multihost.gather_blocked(
                    fn(edge, mesh_axis, mesh=mesh), mesh)
        try:
            halo.exchange_ghosts(torch.zeros(4, 3), 0, 4, mesh=mesh)
            out[("refusal", shape)] = None
        except ValueError as e:
            out[("refusal", shape)] = str(e)
        out[("coords", shape)] = multihost.gather_blocked(
            torch.tensor([float(mesh.rank)]).reshape((1,) * len(shape)), mesh)
    return out


# ---- the rank program ---------------------------------------------------------------
CARD_MESHES = ((2, 2), (2, 2, 1))


def kernel_counters():
    """(name, object, attribute) of each kernel wrapper's launch counter."""
    from justrelax_tpu_torch.ops import hopper_stokes as hs
    from justrelax_tpu_torch.ops import hopper_stokes3d as h3
    from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
    from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
    from justrelax_tpu_torch.ops import hopper_thermal as ht
    from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
    from justrelax_tpu_torch.ops import hopper_window_copy as hw

    return (("stokes_vep_chunk", hv.stokes_vep_chunk, "launches"),
            ("stokes_chunk", hs.stokes_chunk, "launches"),
            ("thermal_chunk", ht.thermal_chunk, "launches"),
            ("stokes3d_chunk", h3.stokes3d_chunk, "launches"),
            ("vep3d_edges", he.vep3d_edges, "launches"),
            ("vep3d_edges_split", he.vep3d_edges, "split_launches"),
            ("stokes3d_vep_chunk", hc.stokes3d_vep_chunk, "launches"),
            ("window_copy", hw.window_copy, "launches"))


def kernel_counts() -> Dict[str, int]:
    """The launch counter of every kernel wrapper in this process."""
    return {name: getattr(obj, attr) for name, obj, attr in kernel_counters()}


def set_kernel_counts(values: Dict[str, int]) -> None:
    """Set every launch counter to ``values`` (0 where it names none)."""
    for name, obj, attr in kernel_counters():
        setattr(obj, attr, values.get(name, 0))


def wait_by_blocking(blocking: bool) -> bool:
    """Make the current CUDA context wait for the card by blocking
    (``CU_CTX_SCHED_BLOCKING_SYNC``) or, with ``False``, as CUDA does by
    default (``CU_CTX_SCHED_AUTO``: it spins while the host has a core per
    context), through ``cuCtxSetFlags``; whether the flag took. Four ranks
    that share one card spend much of each staged exchange waiting for it,
    and a spinning wait takes a core from every other process on the host."""
    try:
        fn = ctypes.CDLL("libcuda.so.1").cuCtxSetFlags
    except (OSError, AttributeError):
        return False
    fn.argtypes = [ctypes.c_uint]
    return fn(0x04 if blocking else 0x00) == 0


def _wait_for(path: Optional[str], timeout: float = 1100.0) -> None:
    """Wait until ``path`` exists (a signal from the process that started
    the world), if one is given."""
    deadline = time.monotonic() + timeout
    while path and not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(0.05)


def run_suite(suite: str, size: str = "test", go: Optional[str] = None) -> dict:
    """What one rank of a world of four runs for ``suite``, on the rank's
    device:

    - ``halo``: :func:`run_halo` (CPU tiles);
    - ``solves`` / ``ve`` / ``thermal`` / ``vep`` / ``variational``: the
      matching cases of :func:`suite_cases`;
    - ``multihost``: SolCx on :func:`multihost.make_multihost_grid_mesh`
      (hosts along x; local_shape (1, 2));
    - ``card``: the cases of ``solves`` on a 2×2 mesh (``CARD_MESHES``) on
      the card and on the CPU, the multihost layout, the serial solve of
      every set-up on both (rank 0, ``serial``), then ``production`` (see
      :func:`production_vep`) once the file ``go`` exists, so that it has
      the card to itself. The ranks wait for the card by blocking until
      then, and as CUDA does by default in the production;
    - ``probe``: nothing past ``initialize``'s first ``all_reduce``.

    Every suite but ``probe`` also returns ``launches``: each kernel
    wrapper's launches, summed over the ranks, from 0 at the start.
    """
    import torch.distributed as dist

    if suite == "probe":
        return dict(world=dist.get_world_size(), backend=dist.get_backend())
    device = multihost.rank_device()
    set_kernel_counts({})
    out = {}
    if suite == "card" and device.type == "cuda":
        torch.zeros(1, device=device)  # the context exists and is current
        out["blocking_wait"] = wait_by_blocking(True)
    if suite == "halo":
        out.update(run_halo(dist.new_group([0, 1, 2])))
    kinds = {"solves": None, "card": None, "ve": ("ve",), "thermal": ("thermal", "thermal3d"),
             "vep": ("vep",), "variational": ("variational",)}
    if suite in kinds:
        for label, case in suite_cases(size).items():
            if kinds[suite] is not None and case.kind not in kinds[suite]:
                continue
            if suite == "card" and case.mesh not in CARD_MESHES:
                continue
            out[label] = sharded_solve(case, make_grid_mesh(case.mesh, device=device))
            if suite == "card":
                out[label + "@cpu"] = sharded_solve(case, make_grid_mesh(case.mesh,
                                                                         device="cpu"))
    if suite in ("multihost", "card"):
        case = suite_cases(size)["ve_solcx"]
        mesh = multihost.make_multihost_grid_mesh(ndim=2, local_shape=(1, 2), device=device)
        out["multihost"] = sharded_solve(case, mesh)
        out["multihost_layout"] = dict(ranks=mesh.ranks.copy(), shape=mesh.shape)
    if suite == "card":
        if dist.get_rank() == 0:
            # the serial references of every set-up, on the card and on the
            # CPU, while the other ranks wait for `go`
            out["serial"] = {where: {setup_key(c): serial_solve(c, dev)
                                     for c in setups(suite_cases(size)).values()}
                             for where, dev in (("card", device), ("cpu", "cpu"))}
        _wait_for(go)
        if device.type == "cuda":
            out["default_wait_in_production"] = wait_by_blocking(False)
        out["production"] = production_vep(make_grid_mesh((2, 2), device=device), size)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, kernel_counts())
    out["launches"] = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
    return out


def world(suite: str, size: str = "test", go: Optional[str] = None, nranks: int = 4,
          **kw) -> launch.World:
    """A world of ``nranks`` ranks running :func:`run_suite` (``launch.World``'s
    keywords: ``device``, ``backend``, ``hosts``, ``timeout``,
    ``rank_timeout``)."""
    args = (suite, size) + ((go,) if go else ())
    return launch.World("dist_cases:run_suite", nranks, args=args, **kw)


# the production cell: the flagship's grid at the card's size, a small one
# for a rehearsal on the CPU
PRODUCTION = {"card": dict(n=1024, iters=1_000), "test": dict(n=32, iters=100)}


def production_setup(device, n, dtype=torch.float32):
    """The flagship's shear band set-up (``models/shearband.py``) at the
    production grid, f32: (geometry, material, pr_c, pr_v, state, pt, bc,
    dt), with ``eps_rel = eps_abs = 0`` so the iterations are fixed."""
    from justrelax_tpu_torch.models import shearband

    common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                  C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0, eta_reg=8.0e-3)
    geometry, material, pr_c, pr_v, st, _, bc = shearband._setup(
        n, common, 0.5, dtype, device, eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=0.0, eps_abs=0.0,
                             CFL=0.75 / math.sqrt(2.1))
    return geometry, material, pr_c, pr_v, st, pt, bc, 0.25


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def production_serial(dev, size: str = "card") -> dict:
    """The same solve through the serial plain ``solve_vep`` on ``dev``: ms
    per iteration."""
    from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep

    n, iters = PRODUCTION[size]["n"], PRODUCTION[size]["iters"]
    geometry, material, pr_c, pr_v, st, pt, bc, dt = production_setup(dev, n)
    kw = dict(iter_min=0, use_kernel=False)
    solve_vep(st, pt, geometry, bc, material, pr_c, pr_v, dt, iter_max=2, nout=2, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    s, info = solve_vep(st, pt, geometry, bc, material, pr_c, pr_v, dt, iter_max=iters,
                        nout=iters, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    return dict(P=s.P.cpu().numpy(), n=n, iters=int(info.iters), err=float(info.err),
                wall_s=wall, ms_per_iter=wall * 1e3 / int(info.iters))


def production_vep(mesh, size: str = "card") -> dict:
    """The flagship's 1024² f32 VEP solve, sharded over ``mesh``, for a
    fixed 1 000 iterations (one chunk): ms per iteration, the part of it
    spent in the halo functions (CUDA events around each,
    ``halo.timed_exchanges``), the halo bytes this rank sent per iteration
    and its tile's bytes, and the gathered P."""
    from justrelax_tpu_torch.parallel.stokes2d_vep import solve_vep_sharded

    n, iters = PRODUCTION[size]["n"], PRODUCTION[size]["iters"]
    dev = mesh.device
    geometry, material, pr_c, pr_v, st, pt, bc, dt = production_setup(dev, n)
    dec = Decomp2D.make((n, n), mesh.shape)
    tau = st.tau
    glob = dict(Vx=st.V.Vx, Vy=st.V.Vy, P=st.P, Q=st.Q, txx=tau.xx, tyy=tau.yy,
                txy_c=tau.xy_c, txy_v=tau.xy, txx_o=tau.xx, tyy_o=tau.yy, txy_c_o=tau.xy_c,
                txy_v_o=tau.xy, EII_pl=st.EII_pl, eta=st.viscosity.eta,
                eta_v=st.viscosity.eta_v)
    blocks = {k: multihost.blocks_from_global(mesh, _blocked(dec, k, v.cpu().numpy()),
                                              torch.float32) for k, v in glob.items()}
    blocks.update(pr_c=multihost.blocks_from_global(
        mesh, _blocked_phase(dec, pr_c.cpu().numpy(), False), torch.float32),
        pr_v=multihost.blocks_from_global(
        mesh, _blocked_phase(dec, pr_v.cpu().numpy(), True), torch.float32),
        inv_dx=1.0 / geometry.di[0], inv_dy=1.0 / geometry.di[1])
    kw = dict(iter_max=iters, iter_min=0, nout=iters)
    solve_vep_sharded(mesh, dec, blocks, pt, bc, material, dt, iter_max=2, iter_min=0,
                      nout=2)  # warm-up
    _sync(dev)
    halo.reset_counters()
    with halo.timed_exchanges() as spans:
        t0 = time.perf_counter()
        res = solve_vep_sharded(mesh, dec, blocks, pt, bc, material, dt, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
    exchange_ms = sum(a.elapsed_time(b) for a, b in spans)
    tile_bytes = sum(int(blocks[k].numel()) * 4 for k in (
        "Vx", "Vy", "P", "txx", "tyy", "txy_c", "txy_v", "eta", "eta_v"))
    finite = all(bool(torch.isfinite(getattr(res, k)).all()) for k in ("Vx", "Vy", "P",
                                                                          "txx", "tau_II"))
    return dict(P=multihost.gather_blocked(res.P, mesh), n=n, mesh=list(mesh.shape),
                tile=list(blocks["P"].shape),
                iters=int(res.iters), err=float(res.err), wall_s=wall,
                ms_per_iter=wall * 1e3 / int(res.iters),
                exchange_ms_per_iter=exchange_ms / int(res.iters),
                exchange_spans=len(spans), halo_bytes_per_iter=halo.bytes_sent / int(res.iters),
                halo_batches_per_iter=halo.exchanges / int(res.iters),
                center_tile_bytes=int(blocks["P"].numel()) * 4,
                state_tile_bytes=tile_bytes, finite=finite)
