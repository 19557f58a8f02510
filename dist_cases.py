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
# the 3D blocks' surplus (the old stresses ``*_o`` as their stresses)
EXTRAS_3D = {"Vx": (1, 2, 2), "Vy": (2, 1, 2), "Vz": (2, 2, 1), "tyz": (0, 1, 1),
             "txz": (1, 0, 1), "txy": (1, 1, 0)}
EXTRAS_3D.update({k + "_o": EXTRAS_3D[k] for k in ("tyz", "txz", "txy")})
VE3D_FIELDS = ("Vx", "Vy", "Vz", "P", "txx", "tyy", "tzz", "tyz", "txz", "txy")
VEP3D_FIELDS = VE3D_FIELDS + ("tyz_c", "txz_c", "txy_c", "tau_II", "lam", "eta")
ALL_FACES = dict(left=True, right=True, top=True, bot=True, front=True, back=True)


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
        Case("ve3d_free_slip_xy", "ve3d", 8, (2, 2, 1), 200, 100, "free_slip"),
        Case("ve3d_free_slip_yz", "ve3d", 8, (1, 2, 2), 200, 100, "free_slip"),
        Case("ve3d_no_slip_xy", "ve3d", 8, (2, 2, 1), 200, 100, "no_slip"),
        Case("ve3d_no_slip_yz", "ve3d", 8, (1, 2, 2), 200, 100, "no_slip"),
        Case("vep3d_xy", "vep3d", 8, (2, 2, 1), 200, 100, nt=3),
        Case("vep3d_yz", "vep3d", 8, (1, 2, 2), 200, 100, nt=3),
        Case("dyrel_2x2", "dyrel", 32, (2, 2), 0, DYREL_KW["nout"]),
        Case("dyrel_4x1", "dyrel", 32, (4, 1), 0, DYREL_KW["nout"]),
        Case("dyrel_nonlinear_2x2", "dyrel", 16, (2, 2), 0, 100, "nonlinear"),
        Case("particles_2x2", "particles", 16, (2, 2), 0, 0, nt=3),
        Case("particles_1x4", "particles", 16, (1, 4), 0, 0, nt=3),
        Case("particles3d_xy", "particles3d", 8, (2, 2, 1), 0, 0, nt=3),
        Case("particles3d_yz", "particles3d", 8, (1, 2, 2), 0, 0, nt=3),
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


def ve3d_inputs(setup: str, n: int) -> dict:
    """tests/test_distributed3d.py: buoyancy with a random η and ρ, G = 1,
    K = dt = ∞, free slip or no slip on all six faces."""
    rng = np.random.default_rng(3)
    ni = (n, n, n)
    return dict(n=n, eta=np.exp(0.5 * rng.normal(size=ni)), rho=1.0 + 0.2 * rng.normal(size=ni),
                G=np.ones(ni), K=np.full(ni, np.inf), dt=math.inf, bc=setup)


def ve3d_objects(case: Case):
    """(geometry, coefficients with ϵ = 1e-30, so the iterations are fixed,
    velocity BCs)."""
    n = case.n
    g = Geometry((n, n, n), (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(3.0), eps_rel=1.0e-30,
                             eps_abs=1.0e-30)
    return g, pt, VelocityBoundaryConditions(**{case.setup: Faces(**ALL_FACES)})


def vep3d_material(device, dtype):
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack

    tau_y, phi = 0.8, 30.0
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0, C=tau_y / math.cos(math.radians(phi)),
                  friction_angle=phi, eta_reg=8.0e-3)
    return MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)],
                              dtype=dtype, device=device)


def vep3d_inputs(n: int) -> dict:
    """tests/test_distributed_vep3d.py: two-phase Drucker-Prager pure shear
    in xz, a weak elastic sphere off center so that it straddles the
    tiles."""
    from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field

    g = Geometry((n, n, n), (1.0, 1.0, 1.0))
    X, Y, Z = g.cell_centers_mesh()
    sph = ((X - 0.45) ** 2 + (Y - 0.55) ** 2 + (Z - 0.5) ** 2) < 0.22**2
    pr = phase_ratios_from_field(torch.as_tensor(sph.astype(np.int64)), 2)
    xv, zv = np.asarray(g.xvi[0]), np.asarray(g.xvi[2])
    Vx = np.broadcast_to(xv[:, None, None], (n + 1, n + 2, n + 2)).copy()
    Vy = np.zeros((n + 2, n + 1, n + 2))
    Vz = np.broadcast_to(-zv[None, None, :], (n + 2, n + 2, n + 1)).copy()
    V = flow_bcs(tuple(torch.as_tensor(a) for a in (Vx, Vy, Vz)),
                 VelocityBoundaryConditions(free_slip=Faces(**ALL_FACES)))
    return dict(n=n, Vx=V[0].numpy(), Vy=V[1].numpy(), Vz=V[2].numpy(), dt=0.25,
                pr_c=pr.center.numpy(), pr_yz=pr.edge_yz.numpy(), pr_xz=pr.edge_xz.numpy(),
                pr_xy=pr.edge_xy.numpy())


def vep3d_pt(n):
    g = Geometry((n, n, n), (1.0, 1.0, 1.0))
    return g, PTStokesCoeffs.make(g.li, g.di, eps_rel=1.0e-30, eps_abs=1.0e-30,
                                  CFL=0.9 / math.sqrt(3.1))


def dyrel_inputs(n: int) -> dict:
    """tests/test_distributed_dyrel.py's ``_setup``: a two-phase
    Drucker-Prager band (a weak circle at the center) under pure shear, the
    boundary velocities set and the interior at rest."""
    from justrelax_tpu_torch.models.shearband import _circle_phase_ratios

    g = Geometry((n, n), (1.0, 1.0))
    xv, yv = np.asarray(g.xvi[0]), np.asarray(g.xvi[1])
    Vx = np.broadcast_to(xv[:, None], (n + 1, n + 2)).copy()
    Vy = np.broadcast_to(-yv[None, :], (n + 2, n + 1)).copy()
    Vx[1:-1, 1:-1] = 0.0
    Vy[1:-1, 1:-1] = 0.0
    Vx, Vy = (t.numpy() for t in flow_bcs((torch.as_tensor(Vx), torch.as_tensor(Vy)),
                                           VelocityBoundaryConditions(**FREE_SLIP)))
    return dict(n=n, Vx=Vx, Vy=Vy, dt=0.25,
                pr_c=_circle_phase_ratios(g.xci[0], g.xci[1], (0.5, 0.5), 0.1),
                pr_v=_circle_phase_ratios(g.xvi[0], g.xvi[1], (0.5, 0.5), 0.1))


def dyrel_material(device, dtype):
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack

    tau_y, phi = 1.6, 30.0
    common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0,
                  C=tau_y / math.cos(math.radians(phi)), friction_angle=phi, dilation_angle=0.0,
                  eta_reg=1.0e-2)
    return MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)],
                              dtype=dtype, device=device)


# tests/test_distributed_dyrel.py's keywords, with the DR caps
DYREL_KW = dict(eps=1.0e-6, nout=50, rel_drop=0.5)


def dyrel_state(d, device, dtype):
    n = d["n"]
    st = StokesState.make((n, n), dtype=dtype, device=device)
    return st.replace(V=st.V.replace(Vx=torch.as_tensor(d["Vx"], dtype=dtype, device=device),
                                     Vy=torch.as_tensor(d["Vy"], dtype=dtype, device=device)))


def dyrel_nonlinear_setup(n, dtype, dev):
    """tests/test_dyrel_nonlinear.py's set-up on the port: the shear band
    with dislocation creep (n = 3) in both phases, η from ε̇II = 1 and
    refreshed every DR iteration. Returns (state, geometry, bc, material,
    pr_c, pr_v, η₀, keywords)."""
    from justrelax_tpu_torch.models import shearband_dyrel
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
    from justrelax_tpu_torch.rheology.viscosity import phase_viscosity

    common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0, C=1.6 / math.cos(math.radians(30)),
                  friction_angle=30.0, eta_reg=8e-3)
    geometry, _, _, _, st, bc = shearband_dyrel._setup(n, common, 1.0, False, dtype, dev)
    f = dict(dtype=st.P.dtype, device=st.P.device)
    mat = MaterialStack.make([Material(G=1.0, disl_A=0.5, disl_n=3.0, **common),
                              Material(G=0.5, disl_A=5.0, disl_n=3.0, **common)], **f)

    def circ(xs, ys):
        X, Y = np.meshgrid(np.asarray(xs), np.asarray(ys), indexing="ij")
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.01
        return torch.as_tensor(np.stack([~inside, inside], axis=-1).astype(float), **f)

    prc, prv = circ(*geometry.xci), circ(*geometry.xvi)
    eta0 = phase_viscosity(mat, torch.ones((n, n), **f), None, prc, "eps")
    eta0v = phase_viscosity(mat, torch.ones((n + 1, n + 1), **f), None, prv, "eps")
    st = st.replace(viscosity=st.viscosity.replace(eta=eta0, eta_v=eta0v))
    kw = dict(linear_viscosity=False, viscosity_relaxation=0.5, viscosity_cutoff=(1e-3, 1e3),
              eps=1e-6, nout=100, iter_max=20_000, total_iter_max=200_000)
    return st, geometry, bc, mat, prc, prv, eta0, kw


def dyrel_objects(case: Case, device, dtype):
    """(state, geometry, bc, material, pr_c, pr_v, dt, keywords) of a DYREL
    case: tests/test_distributed_dyrel.py's band, or (``setup``
    "nonlinear") the band with dislocation creep, whose η the DR loop
    refreshes."""
    n = case.n
    if case.setup == "nonlinear":
        st, g, bc, mat, prc, prv, _, kw = dyrel_nonlinear_setup(n, dtype, torch.device(device))
        return st, g, bc, mat, prc, prv, 0.25, kw
    d = dyrel_inputs(n)
    f = dict(dtype=dtype, device=device)
    return (dyrel_state(d, device, dtype), Geometry((n, n), (1.0, 1.0)),
            VelocityBoundaryConditions(**FREE_SLIP), dyrel_material(device, dtype),
            torch.as_tensor(d["pr_c"], **f), torch.as_tensor(d["pr_v"], **f), d["dt"],
            dict(DYREL_KW))


def dyrel_fields(s) -> dict:
    """The fields tests/test_distributed_dyrel.py holds, as numpy."""
    return dict(P=s.P, Vx=s.V.Vx, Vy=s.V.Vy, txx=s.tau.xx, txy_v=s.tau.xy, tII=s.tau.II,
                eta_vep=s.viscosity.eta_vep, EII_pl=s.EII_pl)


def particles_inputs(n: int, ndim: int) -> dict:
    """tests/test_distributed_particles.py (2D, 16²) and
    tests/test_distributed_particles3d.py (3D, 8³): a random velocity field
    at CFL 0.45, four particles per cell and a random phase per slot."""
    from justrelax_tpu_torch.particles.particles import init_particles
    from justrelax_tpu_torch.particles.particles3d import init_particles_3d

    ni = (n,) * ndim
    g = Geometry(ni, (1.0,) * ndim)
    rng = np.random.default_rng(5 if ndim == 2 else 7)
    V = [rng.normal(size=tuple(m + (1 if a == d else 2) for a, m in enumerate(ni)))
         for d in range(ndim)]
    dt = 0.45 * min(g.di) / max(float(np.abs(v).max()) for v in V)
    if ndim == 2:
        p = init_particles(g, nxcell=4, max_xcell=12, min_xcell=2, seed=3, device="cpu")
    else:
        p = init_particles_3d(g, nxcell=4, max_xcell=14, min_xcell=2, seed=3, device="cpu")
    phase = rng.integers(0, 3, size=tuple(p.px.shape)).astype(float)
    names = ("px", "py", "pz")[:ndim]
    return dict(n=n, ndim=ndim, V=V, dt=dt, phase=phase, active=p.active.numpy(),
                min_xcell=p.min_xcell, nxcell=p.nxcell,
                **{k: getattr(p, k).numpy() for k in names})


def make_particles(d, device, dtype=torch.float64):
    """The particle set of :func:`particles_inputs` on ``device``."""
    from justrelax_tpu_torch.particles.particles import Particles
    from justrelax_tpu_torch.particles.particles3d import Particles3D

    names = ("px", "py", "pz")[:d["ndim"]]
    cls = Particles if d["ndim"] == 2 else Particles3D
    f = dict(dtype=dtype, device=device)
    return cls(active=torch.as_tensor(d["active"], device=device), min_xcell=d["min_xcell"],
               nxcell=d["nxcell"], **{k: torch.as_tensor(d[k], **f) for k in names})


def particle_rows(positions, active, phase) -> dict:
    """The multiset of active (x, y[, z], phase) rows, sorted, and the
    per-cell occupancy (tests/test_distributed_particles.py's
    ``_gather_sorted`` and ``count``)."""
    a = np.asarray(active).astype(bool)
    rows = np.stack([np.asarray(x)[a] for x in positions] + [np.asarray(phase)[a]], axis=-1)
    return dict(rows=rows[np.lexsort(rows.T[::-1])], count=a.sum(axis=-1))


def particle_diffs(a: dict, b: dict) -> dict:
    """(max |rows a − rows b|, ∞ if the numbers of particles differ; cells
    whose occupancy differs)."""
    same = a["rows"].shape == b["rows"].shape
    rows = float(np.abs(a["rows"] - b["rows"]).max(initial=0.0)) if same else math.inf
    return dict(rows=rows, count=int((a["count"] != b["count"]).sum()))


def inputs(case: Case) -> dict:
    return {"ve": lambda: ve_inputs(case.setup, case.n),
            "thermal": lambda: thermal_inputs(case.n),
            "thermal3d": lambda: thermal3d_inputs(case.n),
            "vep": lambda: vep_inputs(case.n),
            "variational": lambda: variational_inputs(case.n),
            "ve3d": lambda: ve3d_inputs(case.setup, case.n),
            "vep3d": lambda: vep3d_inputs(case.n),
            "dyrel": lambda: dyrel_inputs(case.n),
            "particles": lambda: particles_inputs(case.n, 2),
            "particles3d": lambda: particles_inputs(case.n, 3)}[case.kind]()


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
    if case.kind in ("particles", "particles3d"):
        from justrelax_tpu_torch.particles.particles import advect_rk2, move_particles
        from justrelax_tpu_torch.particles.particles3d import advect_rk2_3d, move_particles_3d

        ndim = d["ndim"]
        g = Geometry((n,) * ndim, (1.0,) * ndim)
        advect, move = (advect_rk2, move_particles) if ndim == 2 else (advect_rk2_3d,
                                                                       move_particles_3d)
        p, ph = make_particles(d, device, dtype), torch.as_tensor(d["phase"], **f)
        V = tuple(torch.as_tensor(v, **f) for v in d["V"])
        for _ in range(case.nt):
            p = advect(p, V, g, d["dt"])
            p, fl = move(p, g, {"phase": ph})
            ph = fl["phase"]
        names = ("px", "py", "pz")[:ndim]
        out = particle_rows([getattr(p, k).cpu() for k in names], p.active.cpu(), ph.cpu())
        return dict(out, err=0.0, iters=case.nt)
    if case.kind == "dyrel":
        from justrelax_tpu_torch.solvers.dyrel import solve_dyrel

        *args, kw = dyrel_objects(case, device, dtype)
        s, info = solve_dyrel(*args, **kw)
        return _np(dyrel_fields(s), info)
    if case.kind == "ve3d":
        from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d

        g, pt, bc = ve3d_objects(case)
        st = StokesState.make(g.ni, **f)
        st = st.replace(viscosity=st.viscosity.replace(eta=torch.as_tensor(d["eta"], **f)))
        z = torch.zeros(g.ni, **f)
        s, info = solve_ve_3d(st, pt, g, bc, (z, z, torch.as_tensor(d["rho"], **f)),
                              torch.as_tensor(d["G"], **f), torch.as_tensor(d["K"], **f),
                              d["dt"], iter_max=case.iters, nout=case.nout, use_kernel=False)
        t = s.tau
        return _np(dict(Vx=s.V.Vx, Vy=s.V.Vy, Vz=s.V.Vz, P=s.P, txx=t.xx, tyy=t.yy, tzz=t.zz,
                        tyz=t.yz, txz=t.xz, txy=t.xy), info)
    if case.kind == "vep3d":
        from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d

        g, pt = vep3d_pt(n)
        mat = vep3d_material(device, dtype)
        st = StokesState.make(g.ni, **f)
        st = st.replace(V=st.V.replace(**{k: torch.as_tensor(d[k], **f)
                                          for k in ("Vx", "Vy", "Vz")}))
        pr_c, *pr_e = (torch.as_tensor(d[k], **f) for k in ("pr_c", "pr_yz", "pr_xz", "pr_xy"))
        bc = VelocityBoundaryConditions(free_slip=Faces(**ALL_FACES))
        steps = []
        for _ in range(case.nt):
            st, info = solve_vep_3d(st, pt, g, bc, mat, pr_c, tuple(pr_e), d["dt"],
                                    iter_max=case.iters, iter_min=100, nout=case.nout,
                                    use_kernel=False)
            t = st.tau
            steps.append(_np(dict(Vx=st.V.Vx, Vy=st.V.Vy, Vz=st.V.Vz, P=st.P, txx=t.xx,
                                  tyy=t.yy, tzz=t.zz, tyz=t.yz, txz=t.xz, txy=t.xy,
                                  tyz_c=t.yz_c, txz_c=t.xz_c, txy_c=t.xy_c, tau_II=t.II,
                                  lam=st.lam, eta=st.viscosity.eta), info))
        return dict(steps=steps)
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

    if case.kind in ("ve3d", "vep3d"):
        return _sharded_3d(case, d, mesh, up, result, timed, dtype)
    if case.kind in ("particles", "particles3d"):
        return _sharded_particles(case, d, mesh, timed, dtype)
    if case.kind == "dyrel":
        from justrelax_tpu_torch.parallel.dyrel import solve_dyrel_sharded

        # the global fields on the CPU, cut by each rank; the material on
        # the rank's device
        st, g, bc, _, pr_c, pr_v, dt, kw = dyrel_objects(case, "cpu", dtype)
        mat = dyrel_objects(case, dev, dtype)[3]
        (s, info), sec = timed(lambda: solve_dyrel_sharded(mesh, st, g, bc, mat, pr_c, pr_v,
                                                           dt, **kw))
        out = {k: v.cpu().numpy() for k, v in dyrel_fields(s).items()}
        out.update(err=float(info.err), iters=int(info.iters), seconds=sec)
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


def face_particles(n: int = 16, per_side: int = 4):
    """Float32 particles a few ulps either side of every face between the
    tiles of a 2×2 mesh and of the domain's upper faces, at rest (the
    velocities are 0): positions where the blocks' frames round apart.
    Returns (particles, velocities, dt), global."""
    from justrelax_tpu_torch.particles.particles import Particles

    f32 = torch.float32
    g = Geometry((n, n), (1.0, 1.0))
    dx = g.di[0]
    m = 4 * per_side
    px = np.zeros((n, n, m), np.float32)
    py = np.zeros((n, n, m), np.float32)
    active = np.zeros((n, n, m), bool)
    faces = (0.5, 1.0)
    k = np.arange(1, per_side + 1, dtype=np.float32)
    for i in range(n):
        for j in range(n):
            xc, yc = np.float32((i + 0.5) * dx), np.float32((j + 0.5) * dx)
            slots = []
            for face in faces:
                f = np.float32(face)
                if i == int(face * n) - 1:  # just below an x face
                    slots += [(np.nextafter(f, 0, dtype=np.float32) - (q - 1) * np.spacing(
                        f / 2), yc) for q in k]
                if i == int(face * n) and face < 1.0:  # at and just above it
                    slots += [(f + (q - 1) * np.spacing(f), yc) for q in k]
                if j == int(face * n) - 1:
                    slots += [(xc, np.nextafter(f, 0, dtype=np.float32) - (q - 1) * np.spacing(
                        f / 2)) for q in k]
                if j == int(face * n) and face < 1.0:
                    slots += [(xc, f + (q - 1) * np.spacing(f)) for q in k]
            for s_, (x, y) in enumerate(slots[:m]):
                px[i, j, s_], py[i, j, s_], active[i, j, s_] = x, y, True
    parts = Particles(px=torch.as_tensor(px), py=torch.as_tensor(py),
                      active=torch.as_tensor(active), min_xcell=1, nxcell=1)
    V = (torch.zeros((n + 1, n + 2), dtype=f32), torch.zeros((n + 2, n + 1), dtype=f32))
    return parts, V, 0.1


def run_face_particles(device) -> dict:
    """:func:`face_particles` through one sharded step on a 2×2 mesh: the
    per-cell occupancy gathered, and the particles placed."""
    from justrelax_tpu_torch.parallel.particles import (
        advect_move_local,
        block_particles,
    )

    parts, V, dt = face_particles()
    n = parts.px.shape[0]
    g = Geometry((n, n), (1.0, 1.0))
    mesh = make_grid_mesh((2, 2), device=device)
    dec = Decomp2D.make((n, n), (2, 2))
    pb = block_particles(parts, g, dec)
    p = pb.replace(active=mesh.local(pb.active, dec.ni_local),
                   px=mesh.local(pb.px, dec.ni_local), py=mesh.local(pb.py, dec.ni_local))
    Vt = [mesh.local(torch.as_tensor(block_staggered(v.numpy(), dec, ex)),
                     tuple(k + e for k, e in zip(dec.ni_local, ex)))
          for v, ex in zip(V, ((1, 2), (2, 1)))]
    with mesh:
        q, _ = advect_move_local(p, {"phase": torch.zeros_like(p.px)}, *Vt, dec, g.di, dt)
        count = multihost.gather_blocked(q.count().to(torch.int32))
    return dict(count=count, placed=int(parts.active.sum()))


def _sharded_particles(case, d, mesh, timed, dtype):
    """The particle cases through ``parallel/particles.py`` and
    ``parallel/particles3d.py``: block-relative positions, this rank's
    slots and velocity tiles, ``nt`` steps of advection and migration, the
    slots gathered and made global again."""
    from justrelax_tpu_torch.parallel.particles import (
        advect_move_local,
        block_particles,
        unblock_particles,
    )
    from justrelax_tpu_torch.parallel.particles3d import advect_move_local_3d

    n, ndim = case.n, d["ndim"]
    ni = (n,) * ndim
    g = Geometry(ni, (1.0,) * ndim)
    dec = (Decomp2D if ndim == 2 else Decomp3D).make(ni, case.mesh)
    nl = dec.ni_local
    names = ("px", "py", "pz")[:ndim]
    pb = block_particles(make_particles(d, "cpu", dtype), g, dec)
    # the slot arrays are cell-aligned: the blocked layout is the global one
    p = pb.replace(active=mesh.local(pb.active, nl),
                   **{k: mesh.local(getattr(pb, k), nl) for k in names})
    ph = mesh.local(torch.as_tensor(d["phase"], dtype=dtype), nl)
    V = []
    for a, v in enumerate(d["V"]):
        ex = tuple(1 if b == a else 2 for b in range(ndim))
        tile = tuple(m + e for m, e in zip(nl, ex))
        V.append(mesh.local(torch.as_tensor(block_staggered_nd(v, nl, case.mesh, ex),
                                            dtype=dtype), tile))
    step = advect_move_local if ndim == 2 else advect_move_local_3d
    seconds = 0.0
    with mesh:
        for _ in range(case.nt):
            (p, fl), s = timed(lambda: step(p, {"phase": ph}, *V, dec, g.di, d["dt"]))
            ph = fl["phase"]
            seconds += s
        gathered = {k: torch.as_tensor(multihost.gather_blocked(getattr(p, k)))
                    for k in names}
        active = torch.as_tensor(multihost.gather_blocked(p.active.to(torch.uint8))) != 0
        phase = multihost.gather_blocked(ph)
    glob = unblock_particles(p.replace(active=active, **gathered), g, dec)
    out = particle_rows([getattr(glob, k) for k in names], active, phase)
    return dict(out, err=0.0, iters=case.nt, seconds=seconds)


def _blocked_3d(case: Case, name, A, extra=None):
    nl = tuple(case.n // p for p in case.mesh)
    return block_staggered_nd(np.asarray(A), nl, case.mesh,
                              EXTRAS_3D.get(name, (0, 0, 0)) if extra is None else extra)


def _blocked_phase_3d(case: Case, A, extra):
    nl = tuple(case.n // p for p in case.mesh)
    return block_staggered_nd(np.asarray(A), nl + (A.shape[-1],), case.mesh + (1,),
                              extra + (0,))


def _sharded_3d(case, d, mesh, up, result, timed, dtype):
    """The 3D VE and VEP cases through ``parallel/stokes3d.py`` and
    ``parallel/stokes3d_vep.py``."""
    from justrelax_tpu_torch.parallel.stokes3d import solve_ve_sharded_3d
    from justrelax_tpu_torch.parallel.stokes3d_vep import solve_vep_sharded_3d

    n = case.n
    ni = (n, n, n)
    dec = Decomp3D.make(ni, case.mesh)
    zc = np.zeros(ni)
    shapes = dict(Vx=(n + 1, n + 2, n + 2), Vy=(n + 2, n + 1, n + 2),
                  Vz=(n + 2, n + 2, n + 1), tyz=(n, n + 1, n + 1), txz=(n + 1, n, n + 1),
                  txy=(n + 1, n + 1, n))
    if case.kind == "ve3d":
        g, pt, bc = ve3d_objects(case)
        glob = {k: np.zeros(shapes.get(k.replace("_o", ""), ni)) for k in (
            "Vx", "Vy", "Vz", "P", "P0", "Q", "txx", "tyy", "tzz", "tyz", "txz", "txy",
            "txx_o", "tyy_o", "tzz_o", "tyz_o", "txz_o", "txy_o")}
        glob.update(eta=d["eta"], G=d["G"], K=d["K"], fx=zc, fy=zc, fz=d["rho"])
        blocks = {k: up(_blocked_3d(case, k, v)) for k, v in glob.items()}
        blocks.update(inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1], inv_dz=1.0 / g.di[2])
        res, s = timed(lambda: solve_ve_sharded_3d(mesh, dec, blocks, pt, bc, d["dt"],
                                                   iter_max=case.iters, nout=case.nout))
        return result(res, VE3D_FIELDS, s)
    g, pt = vep3d_pt(n)
    mat = vep3d_material(mesh.device, dtype)
    bc = VelocityBoundaryConditions(free_slip=Faces(**ALL_FACES))
    glob = dict(Vx=d["Vx"], Vy=d["Vy"], Vz=d["Vz"], P=zc, Q=zc, EII_pl=zc, eta=np.ones(ni))
    for k in ("txx", "tyy", "tzz", "tyz_c", "txz_c", "txy_c", "tyz", "txz", "txy"):
        glob[k] = glob[k + "_o"] = np.zeros(shapes.get(k, ni))
    blocks = {k: up(_blocked_3d(case, k, v)) for k, v in glob.items()}
    for k, ex in (("pr_c", (0, 0, 0)), ("pr_yz", (0, 1, 1)), ("pr_xz", (1, 0, 1)),
                  ("pr_xy", (1, 1, 0))):
        blocks[k] = up(_blocked_phase_3d(case, d[k], ex))
    blocks.update(inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1], inv_dz=1.0 / g.di[2])
    steps = []
    for _ in range(case.nt):
        res, s = timed(lambda: solve_vep_sharded_3d(
            mesh, dec, blocks, pt, bc, mat, d["dt"], iter_max=case.iters, iter_min=100,
            nout=case.nout))
        # the next loading step: τ_o ← τ; P, V and η carried, as the serial
        # solver threads its state
        for k in ("Vx", "Vy", "Vz", "P", "eta", "txx", "tyy", "tzz", "tyz_c", "txz_c",
                  "txy_c", "tyz", "txz", "txy"):
            blocks[k] = getattr(res, k)
        for k in ("txx", "tyy", "tzz", "tyz_c", "txz_c", "txy_c", "tyz", "txz", "txy"):
            blocks[k + "_o"] = getattr(res, k)
        steps.append(result(res, VEP3D_FIELDS, s))
    return dict(steps=steps)


def unblock(case: Case, name: str, B: np.ndarray) -> np.ndarray:
    """A gathered blocked field back to the global array."""
    if case.kind == "thermal3d":
        n = case.n
        return unblock_staggered_nd(B, (n // case.mesh[0], n // case.mesh[1],
                                        n // case.mesh[2]), case.mesh, (2, 2, 2))
    if case.kind in ("ve3d", "vep3d"):
        nl = tuple(case.n // p for p in case.mesh)
        return unblock_staggered_nd(B, nl, case.mesh, EXTRAS_3D.get(name, (0, 0, 0)))
    if case.kind in ("dyrel", "particles", "particles3d"):  # gathered already
        return B
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


# each kind's gate against the serial (or the JAX package's) result: the
# worst field difference and its limit (of each field's max; DYREL's
# absolute, as tests/test_distributed_dyrel.py holds it, since its sums
# reorder; the particles' rows absolute, with equal occupancy), and err's
# relative limit
FIELD_TOL, ERR_RTOL = 1e-12, 1e-6
DYREL_ATOL, DYREL_ERR_RTOL = 1e-12, 1e-10
PARTICLE_TOL = 1e-13


def case_gate(case: Case, sharded: dict, ref: dict):
    """(worst difference over every step, its limit, iterations equal, err
    within its limit) of a sharded result against a global one (the serial
    solve's or the JAX package's); a missing step fails."""
    worst, iters_ok, err_ok = 0.0, True, True
    a_steps, b_steps = steps_of(sharded), steps_of(ref)
    iters_ok = len(a_steps) == len(b_steps)
    tol, rtol = FIELD_TOL, ERR_RTOL
    for a, b in zip(a_steps, b_steps):
        if case.kind in ("particles", "particles3d"):
            d = particle_diffs(a, b)
            w, tol = (d["rows"] if d["count"] == 0 else math.inf), PARTICLE_TOL
        elif case.kind == "dyrel":
            tol, rtol = DYREL_ATOL, DYREL_ERR_RTOL
            w = max(float(np.abs(np.asarray(a[k]) - v).max(initial=0.0))
                    for k, v in b.items() if k not in ("err", "iters", "seconds"))
        else:
            w = max(field_diffs(case, a, b).values())
        worst = max(worst, w)
        iters_ok &= a["iters"] == b["iters"]
        err_ok &= abs(a["err"] - b["err"]) <= rtol * abs(b["err"])
    return worst, tol, iters_ok, err_ok


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


MOVES_MESHES = ((2, 2, 1), (1, 2, 2))
# cases also run through a staged mesh on the CPU ranks (their batches mix
# float64 slabs with uint8 ones)
STAGED_CASES = ("particles_2x2", "particles3d_xy")
MOVE_FAMILIES = {"yz": (1, 2), "xz": (0, 2), "xy": (0, 1)}
MOVE_EXTRAS = {"yz": (0, 1, 1), "xz": (1, 0, 1), "xy": (1, 1, 0)}


def moves_inputs(n: int = 8) -> dict:
    """tests/test_distributed_vep3d.py's random fields of the moves check: a
    positive center field and one array per shear-edge family."""
    rng = np.random.default_rng(11)
    ni = (n, n, n)
    C = rng.normal(size=ni) + 3.0  # positive for the harmonic move
    E = {name: rng.normal(size=tuple(m + e for m, e in zip(ni, MOVE_EXTRAS[name])))
         for name in ("yz", "xz", "xy")}
    return dict(n=n, C=C, E=E)


def run_moves() -> dict:
    """Every halo-aware move of ``parallel/stokes3d_vep.py`` on this rank's
    tiles, one at a time (``distributed_moves``) and prefetched
    (``HaloMoves.prefetch``), on the meshes ``MOVES_MESHES``: the results
    gathered into the blocked layout, keyed by (mesh, route, move, source,
    destination)."""
    from justrelax_tpu_torch.parallel.stokes3d_vep import HaloMoves, distributed_moves

    d = moves_inputs()
    n = d["n"]
    out = {}
    for shape in MOVES_MESHES:
        mesh = make_grid_mesh(shape, device="cpu")
        nl = tuple(n // p for p in shape)

        def tile(A, extra):
            return torch.as_tensor(mesh.tile(block_staggered_nd(A, nl, shape, extra))).clone()

        C = tile(d["C"], (0, 0, 0))
        E = {k: tile(v, MOVE_EXTRAS[k]) for k, v in d["E"].items()}
        with mesh:
            edges = tuple(halo.axis_edges(a) for a in ("x", "y", "z"))
            one = distributed_moves(edges)
            hm = HaloMoves(edges)
            hm.prefetch(centers=(C,), harmonic=(C,), shear=tuple(E.items()))
            for route, m in (("one", one), ("prefetched", hm.moves)):
                for name, (a, b) in MOVE_FAMILIES.items():
                    out[(shape, route, "center", name)] = multihost.gather_blocked(
                        m.center_to_edge(C, a, b))
                    out[(shape, route, "harm", name)] = multihost.gather_blocked(
                        m.harm_center_to_edge(C, a, b))
                for src in MOVE_FAMILIES:
                    for dst in MOVE_FAMILIES:
                        if src != dst:
                            out[(shape, route, src, dst)] = multihost.gather_blocked(
                                m.other_to_edge(src, dst, E[src]))
    return out


# ---- the rank program ---------------------------------------------------------------
CARD_MESHES = ((2, 2), (2, 2, 1))
# the kinds whose card cases the four ranks also run on the CPU (the later
# kinds' CPU runs are the CPU tests': their twins here would only crowd the
# host beside phase 28)
CPU_TWIN_KINDS = ("ve", "thermal", "thermal3d", "vep", "variational")


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
    - ``card``: the cases of ``solves`` on the meshes ``CARD_MESHES`` on
      the card (and on the CPU, ``CPU_TWIN_KINDS``), the multihost layout, the serial solve of
      every set-up on both (rank 0, ``serial``), then the production cells
      (:func:`production_vep`, :func:`production_vep3d`,
      :func:`production_dyrel`, :func:`production_particles`) once the file
      ``go`` exists, so that they have the card to themselves. The ranks
      wait for the card by blocking until then, and as CUDA does by default
      in the productions;
    - ``one`` (a world of one rank): every set-up's first case on a mesh of
      ones, then the 2D and 3D VEP productions on it once ``go`` exists;
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
    if suite in ("card", "one") and device.type == "cuda":
        torch.zeros(1, device=device)  # the context exists and is current
        out["blocking_wait"] = wait_by_blocking(True)
    if suite == "halo":
        out.update(run_halo(dist.new_group([0, 1, 2])))
    if suite == "vep3d":
        out["moves"] = run_moves()
    if suite == "particles":
        out["faces"] = run_face_particles(device)
    kinds = {"solves": None, "card": None, "ve": ("ve",), "thermal": ("thermal", "thermal3d"),
             "vep": ("vep",), "variational": ("variational",), "ve3d": ("ve3d",),
             "vep3d": ("vep3d",), "dyrel": ("dyrel",), "particles": ("particles",),
             "particles3d": ("particles3d",)}
    if suite in kinds:
        for label, case in suite_cases(size).items():
            if kinds[suite] is not None and case.kind not in kinds[suite]:
                continue
            if suite == "card" and case.mesh not in CARD_MESHES:
                continue
            out[label] = sharded_solve(case, make_grid_mesh(case.mesh, device=device))
            if suite in ("particles", "particles3d") and label in STAGED_CASES:
                # every batch staged through a byte buffer, as on the card
                staged = dataclasses.replace(make_grid_mesh(case.mesh, device=device),
                                             staged=True)
                out[label + "@staged"] = sharded_solve(case, staged)
            if suite == "card" and case.kind in CPU_TWIN_KINDS:
                out[label + "@cpu"] = sharded_solve(case, make_grid_mesh(case.mesh,
                                                                         device="cpu"))
    if suite == "one":
        for label, case in setups(suite_cases(size)).items():
            one = dataclasses.replace(case, mesh=(1,) * len(case.mesh))
            out[label] = sharded_solve(one, make_grid_mesh(one.mesh, device=device))
        _wait_for(go)
        if device.type == "cuda":
            out["default_wait_in_production"] = wait_by_blocking(False)
        out["production"] = production_vep(make_grid_mesh((1, 1), device=device), size)
        out["production_vep3d"] = production_vep3d(make_grid_mesh((1, 1, 1), device=device),
                                                   size)
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
        out["production_vep3d"] = production_vep3d(make_grid_mesh((2, 2, 1), device=device),
                                                   size)
        out["production_dyrel"] = production_dyrel(make_grid_mesh((2, 2), device=device), size)
        out["production_particles"] = production_particles(
            make_grid_mesh((2, 2), device=device), size)
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
PRODUCTION = {"card": dict(n=1024, iters=500), "test": dict(n=32, iters=100)}


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
    fixed 500 iterations (one chunk): ms per iteration, the part of it
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


# the production cells of this slice: the 3D VEP band, the DYREL band and a
# particle step, each at the card's size, a small one for a rehearsal
PRODUCTION_VEP3D = {"card": dict(n=126, iters=100), "test": dict(n=16, iters=10)}
PRODUCTION_DYREL = {"card": dict(n=1024, iters=200, nout=50),
                    "test": dict(n=32, iters=40, nout=20)}
PRODUCTION_PARTICLES = {"card": dict(n=1024, nxcell=40, max_xcell=80, min_xcell=20),
                        "test": dict(n=32, nxcell=8, max_xcell=16, min_xcell=4)}


def _timed_sharded(mesh, fn, iters_of):
    """``fn()`` after one warm-up call of ``fn(warm=True)``, timed on the
    host around a synchronize, with CUDA events around each halo function
    (``halo.timed_exchanges``) and the halo counters from 0: (result, dict
    of ms per iteration, the halo's part, bytes and batches this rank sent
    per iteration; ``iters_of(result)`` counts the iterations)."""
    dev = mesh.device
    fn(warm=True)
    _sync(dev)
    halo.reset_counters()
    with halo.timed_exchanges() as spans:
        t0 = time.perf_counter()
        res = fn(warm=False)
        _sync(dev)
        wall = time.perf_counter() - t0
    exchange_ms = sum(a.elapsed_time(b) for a, b in spans)
    iters = iters_of(res)
    return res, dict(mesh=list(mesh.shape), iters=iters, wall_s=wall,
                     ms_per_iter=wall * 1e3 / iters, exchange_ms_per_iter=exchange_ms / iters,
                     exchange_spans=len(spans), halo_bytes_per_iter=halo.bytes_sent / iters,
                     halo_batches_per_iter=halo.exchanges / iters)


def production_vep3d_setup(device, n):
    """ShearBand3D (``models/shearband3d.py``) at ``n``³ f32, with
    ``eps_rel = eps_abs = 0`` so the iterations are fixed."""
    from justrelax_tpu_torch.models import shearband3d

    g, st, mat, (pr_c, pr_e), bc, _, dt = shearband3d._setup(n, torch.float32, device)
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=0.75 / math.sqrt(3.1), eps_rel=0.0, eps_abs=0.0)
    return g, st, mat, pr_c, pr_e, bc, pt, dt


def production_vep3d_serial(dev, size: str = "card") -> dict:
    """The same solve through the serial plain ``solve_vep_3d`` on ``dev``:
    ms per iteration."""
    from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d

    n, iters = PRODUCTION_VEP3D[size]["n"], PRODUCTION_VEP3D[size]["iters"]
    g, st, mat, pr_c, pr_e, bc, pt, dt = production_vep3d_setup(dev, n)
    kw = dict(iter_min=0, viscosity_relaxation=1.0, use_kernel=False)
    solve_vep_3d(st, pt, g, bc, mat, pr_c, pr_e, dt, iter_max=2, nout=2, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    s, info = solve_vep_3d(st, pt, g, bc, mat, pr_c, pr_e, dt, iter_max=iters, nout=iters, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    return dict(P=s.P.cpu().numpy(), n=n, iters=int(info.iters), err=float(info.err),
                wall_s=wall, ms_per_iter=wall * 1e3 / int(info.iters))


def production_vep3d(mesh, size: str = "card") -> dict:
    """ShearBand3D's 126³ f32 VEP solve sharded over ``mesh`` (2×2×1 tiles
    on four ranks, or the world of one), fixed iterations (one chunk): ms
    per iteration, its halo part, halo bytes and batches per iteration
    against the tile's bytes, and the gathered P."""
    from justrelax_tpu_torch.parallel.stokes3d_vep import solve_vep_sharded_3d

    n, iters = PRODUCTION_VEP3D[size]["n"], PRODUCTION_VEP3D[size]["iters"]
    dev = mesh.device
    g, st, mat, pr_c, pr_e, bc, pt, dt = production_vep3d_setup(dev, n)
    dec = Decomp3D.make((n, n, n), mesh.shape)
    nl = dec.ni_local
    t, to = st.tau, st.tau_o
    glob = dict(Vx=st.V.Vx, Vy=st.V.Vy, Vz=st.V.Vz, P=st.P, Q=st.Q, EII_pl=st.EII_pl,
                eta=st.viscosity.eta)
    for k in ("xx", "yy", "zz", "yz_c", "xz_c", "xy_c", "yz", "xz", "xy"):
        glob["t" + k], glob["t" + k + "_o"] = getattr(t, k), getattr(to, k)
    blocks = {k: multihost.blocks_from_global(mesh, block_staggered_nd(
        v.cpu().numpy(), nl, mesh.shape, EXTRAS_3D.get(k, (0, 0, 0))), torch.float32)
        for k, v in glob.items()}
    for k, A, ex in (("pr_c", pr_c, (0, 0, 0)), ("pr_yz", pr_e[0], (0, 1, 1)),
                     ("pr_xz", pr_e[1], (1, 0, 1)), ("pr_xy", pr_e[2], (1, 1, 0))):
        a = A.cpu().numpy()
        blocks[k] = multihost.blocks_from_global(mesh, block_staggered_nd(
            a, nl + (a.shape[-1],), mesh.shape + (1,), ex + (0,)), torch.float32)
    blocks.update(inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1], inv_dz=1.0 / g.di[2])

    def run(warm):
        it = 2 if warm else iters
        return solve_vep_sharded_3d(mesh, dec, blocks, pt, bc, mat, dt, iter_max=it,
                                    iter_min=0, nout=it, viscosity_relaxation=1.0)

    res, out = _timed_sharded(mesh, run, lambda r: int(r.iters))
    finite = all(bool(torch.isfinite(getattr(res, k)).all())
                 for k in ("Vx", "Vy", "Vz", "P", "txx", "tau_II"))
    tile_bytes = sum(int(blocks[k].numel()) * 4 for k in (
        "Vx", "Vy", "Vz", "P", "txx", "tyy", "tzz", "tyz_c", "txz_c", "txy_c", "tyz", "txz",
        "txy", "eta"))
    out.update(P=multihost.gather_blocked(res.P, mesh), n=n, tile=list(blocks["P"].shape),
               err=float(res.err), finite=finite, center_tile_bytes=int(blocks["P"].numel()) * 4,
               state_tile_bytes=tile_bytes)
    return out


def production_dyrel_setup(device, n):
    """shearband-dyrel's set-up (``models/shearband_dyrel.py``) at ``n``² f32:
    (geometry, material, pr_c, pr_v, stokes, bc, dt)."""
    from justrelax_tpu_torch.models import shearband_dyrel

    common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0,
                  C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                  dilation_angle=0.0, eta_reg=1.0e-2)
    g, mat, pr_c, pr_v, st, bc = shearband_dyrel._setup(n, common, 1.0, True, torch.float32,
                                                        device)
    return g, mat, pr_c, pr_v, st, bc, 0.25


def _dyrel_kw(size):
    """The production's keywords: ``iters`` DR iterations in one inner solve
    (``iter_max`` caps the inner solve, ``total_iter_max`` the call)."""
    p = PRODUCTION_DYREL[size]
    return dict(eps=1.0e-6, nout=p["nout"], rel_drop=0.5, iter_max=p["iters"],
                total_iter_max=p["iters"])


def _warm_kw(kw):
    """One DR chunk: the warm-up, whose result no reduction has touched yet
    (the damping is first estimated after it)."""
    return dict(kw, iter_max=kw["nout"], total_iter_max=kw["nout"])


def dyrel_residual_norms(s) -> list:
    """‖Rx‖, ‖Ry‖ (preconditioned) and ‖RP‖ of a DYREL state, in float64."""
    return [float(np.linalg.norm(a.detach().cpu().double().numpy()))
            for a in (s.R.Rx, s.R.Ry, s.R.RP)]


def production_dyrel_serial(dev, size: str = "card") -> dict:
    """The same solve through the serial ``solve_dyrel`` on ``dev`` (its
    graphed chunk on the card): ms per DR iteration, P after the first chunk
    (the warm-up) and at the end, the final residual norms."""
    from justrelax_tpu_torch.solvers.dyrel import solve_dyrel

    n = PRODUCTION_DYREL[size]["n"]
    g, mat, pr_c, pr_v, st, bc, dt = production_dyrel_setup(dev, n)
    kw = _dyrel_kw(size)
    warm, _ = solve_dyrel(st, g, bc, mat, pr_c, pr_v, dt, **_warm_kw(kw))
    _sync(dev)
    t0 = time.perf_counter()
    s, info = solve_dyrel(st, g, bc, mat, pr_c, pr_v, dt, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    return dict(P=s.P.cpu().numpy(), P_first_chunk=warm.P.cpu().numpy(), n=n,
                iters=int(info.iters), err=float(info.err), wall_s=wall,
                ms_per_iter=wall * 1e3 / int(info.iters), residual_norms=dyrel_residual_norms(s))


def production_dyrel(mesh, size: str = "card") -> dict:
    """shearband-dyrel's 1024² f32 solve sharded over ``mesh`` (2×2), 200
    DR iterations (``total_iter_max``): ms per DR iteration, its halo part,
    halo bytes and batches per iteration, and the gathered P."""
    from justrelax_tpu_torch.parallel.dyrel import solve_dyrel_sharded

    n = PRODUCTION_DYREL[size]["n"]
    dev = mesh.device
    g, mat, pr_c, pr_v, st, bc, dt = production_dyrel_setup(dev, n)
    kw = _dyrel_kw(size)

    first = {}

    def run(warm):
        s, info = solve_dyrel_sharded(mesh, st, g, bc, mat, pr_c, pr_v, dt,
                                      **(_warm_kw(kw) if warm else kw))
        if warm:
            first["P"] = s.P.cpu().numpy()
        return s, info

    (s, info), out = _timed_sharded(mesh, run, lambda r: int(r[1].iters))
    out.update(P=s.P.cpu().numpy(), P_first_chunk=first["P"], n=n, err=float(info.err),
               residual_norms=dyrel_residual_norms(s),
               finite=all(bool(torch.isfinite(a).all()) for a in (s.P, s.V.Vx, s.V.Vy,
                                                                  s.tau.xx, s.tau.II)))
    return out


def production_particles_tile(size, coords, dtype=torch.float32, device="cpu"):
    """The production's particles of the tile at mesh ``coords`` of a 2×2
    mesh, block-relative (each tile its own seed, so a rank makes only its
    own), and the tile's block origin."""
    from justrelax_tpu_torch.particles.particles import init_particles

    p = PRODUCTION_PARTICLES[size]
    nl = p["n"] // 2
    dx = 1.0 / p["n"]
    g = Geometry((nl, nl), (nl * dx, nl * dx))
    parts = init_particles(g, p["nxcell"], p["max_xcell"], p["min_xcell"],
                           seed=100 + 2 * coords[0] + coords[1], dtype=dtype, device=device)
    return parts, (coords[0] * nl * dx, coords[1] * nl * dx)


def production_particles_velocity(size):
    """A random velocity field at CFL 0.45 on the production grid (numpy)
    and its dt."""
    n = PRODUCTION_PARTICLES[size]["n"]
    rng = np.random.default_rng(9)
    V = [rng.normal(size=(n + 1, n + 2)), rng.normal(size=(n + 2, n + 1))]
    return V, 0.45 / n / max(float(np.abs(v).max()) for v in V)


def production_particles_serial(dev, size: str = "card") -> dict:
    """One serial advect + move step of the production's particles (the four
    tiles put together, positions global) on ``dev``: seconds, and the
    per-cell occupancy."""
    from justrelax_tpu_torch.particles.particles import advect_rk2, move_particles

    n = PRODUCTION_PARTICLES[size]["n"]
    g = Geometry((n, n), (1.0, 1.0))
    tiles = [[production_particles_tile(size, (rx, ry), device=dev) for ry in range(2)]
             for rx in range(2)]

    def glue(name, shift):
        rows = []
        for rx in range(2):
            cols = []
            for ry in range(2):
                p, o = tiles[rx][ry]
                A = getattr(p, name)
                cols.append(A + o[shift] if shift is not None else A)
            rows.append(torch.cat(cols, dim=1))
        return torch.cat(rows, dim=0)

    p0 = tiles[0][0][0]
    parts = p0.replace(px=glue("px", 0), py=glue("py", 1), active=glue("active", None))
    phase = (torch.arange(parts.px.numel(), device=dev) % 3).to(torch.float32).reshape(
        parts.px.shape)
    V, dt = production_particles_velocity(size)
    V = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in V)
    n_active = int(parts.active.sum())

    def step():
        q = advect_rk2(parts, V, g, dt)
        return move_particles(q, g, {"phase": phase})

    step()
    _sync(dev)
    t0 = time.perf_counter()
    q, _ = step()
    _sync(dev)
    wall = time.perf_counter() - t0
    return dict(count=q.count().cpu().numpy(), n=n, slots=int(parts.px.numel()),
                active_before=n_active, wall_s=wall, ms_per_step=wall * 1e3)


def production_particles(mesh, size: str = "card") -> dict:
    """One advect + move step of the production's particles sharded over a
    2×2 ``mesh``: ms per step, its halo part, halo bytes and batches, and
    the gathered per-cell occupancy."""
    from justrelax_tpu_torch.parallel.particles import advect_move_local

    n = PRODUCTION_PARTICLES[size]["n"]
    dev = mesh.device
    dec = Decomp2D.make((n, n), mesh.shape)
    parts, _ = production_particles_tile(size, mesh.coords, device=dev)
    nl = dec.ni_local
    # the tile's phases as the glued set numbers them
    gx = torch.arange(nl[0], device=dev)[:, None, None] + mesh.coords[0] * nl[0]
    gy = torch.arange(nl[1], device=dev)[None, :, None] + mesh.coords[1] * nl[1]
    m = parts.px.shape[-1]
    k = torch.arange(m, device=dev)[None, None, :]
    phase = (((gx * n + gy) * m + k) % 3).to(torch.float32)
    V, dt = production_particles_velocity(size)
    V = [multihost.blocks_from_global(mesh, block_staggered(v, dec, ex), torch.float32)
         for v, ex in zip(V, ((1, 2), (2, 1)))]
    g = Geometry((n, n), (1.0, 1.0))

    def run(warm):
        with mesh:
            return advect_move_local(parts, {"phase": phase}, *V, dec, g.di, dt)

    (q, _), out = _timed_sharded(mesh, run, lambda r: 1)
    count = multihost.gather_blocked(q.count().to(torch.int32), mesh)
    out.update(count=count, n=n, tile=list(parts.px.shape),
               slots=int(parts.px.numel()) * mesh.size,
               slot_tile_bytes=int(parts.px.numel()) * (4 * 3 + 1))
    return out
