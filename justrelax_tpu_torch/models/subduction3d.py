"""3D thermo-mechanical subduction (reference miniapps/subduction/3D/
Subduction3D.jl, analytic initial geometry: the 2D set-up of
``models/subduction2d.py`` extruded along y).

Counterpart of ``justrelax_tpu/models/subduction3d.py``, the repository's
north-star configuration (BASELINE.json, "converged 3D Stokes
subduction"). A 3000×L_y×675 km box: 15 km of sticky air above a
half-space-cooled (50 Myr) lithosphere with a 250-km slab dipping 30°;
mantle η=1e20, lithosphere η=1e23 with a T-dependent density; the air
excised by the masked 3D VEP solve (``solve_vep_3d(phi=RockRatio3D)``).
Each step: the masked 3D Stokes solve → CFL dt → 3D PT thermal diffusion.

Oracle (tests/test_subduction3d.py) at 48×8×16, 2 steps: err < 1e-4, a
slab sinking at a plate-tectonic rate, physical T, a y-invariant flow and
frozen goldens.

On the card both solves are plain by contract: the JAX package refuses
``use_pallas`` with ``phi``, and a 3D thermal solve has no kernel; the
model passes ``use_kernel=False`` to each and runs no kernel of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.models.subduction2d import (
    AIR,
    ETA0,
    KAPPA,
    T_BOT,
    T_SURF,
    _setup_phases_T,
    materials,
)
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    thermal_bcs,
)
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio_3d
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["KM", "run"]

KM = 1.0e3


def run(nx=48, ny=8, nz=16, nt=2, dtype=None, device=None):
    """``nt`` coupled steps; returns (stokes, thermal, the last Stokes
    solve's info, the cell phases, numpy). ``device`` defaults to the
    card."""
    device = resolve_device(device)
    lx, ly, lz = 3000.0 * KM, 500.0 * KM, 675.0 * KM
    ni = (nx, ny, nz)
    geometry = Geometry(ni, (lx, ly, lz), origin=(0.0, 0.0, -660.0 * KM))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = materials(**f)
    # extrude the 2D analytic set-up along y, from an (nx, nz) slice geometry
    g2 = Geometry((nx, nz), (lx, lz), origin=(0.0, -660.0 * KM))
    phases2, T2 = _setup_phases_T(g2)
    phases = np.repeat(phases2[:, None, :], ny, axis=1)
    T0 = np.repeat(T2[:, None, :], ny, axis=1)

    pr = phase_ratios_from_field(torch.as_tensor(phases, device=device), 3, dtype=f["dtype"])
    phi = update_rock_ratio_3d(pr, air_phase=AIR)

    eta0 = torch.as_tensor(np.choose(phases, ETA0), **f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta0))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-4, eps_abs=1.0e-5, CFL=0.9 / math.sqrt(3.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True, front=True, back=True))

    Tg = np.full((nx + 2, ny + 2, nz + 2), T_BOT)
    Tg[1:-1, 1:-1, 1:-1] = T0
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True, front=True, back=True),
        constant_value=Faces(top=T_SURF, bot=T_BOT),
    )
    Tj = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
    thermal = ThermalState.make(ni, dtype=f["dtype"], device=device).replace(T=Tj, Told=Tj)
    dt_diff = 0.9 * min(geometry.di) ** 2 / KAPPA / 6.0

    info = None
    for _ in range(nt):
        T_c = thermal.T[1:-1, 1:-1, 1:-1]
        stokes, info = solve_vep_3d(
            stokes, pt_stokes, geometry, flow_bc, material,
            pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), math.inf, T=T_c,
            iter_max=60_000, iter_min=500, nout=1_000,
            viscosity_cutoff=(1.0e18, 1.0e24), phi=phi, use_kernel=False,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di, dt_diff))

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_c, stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-5, CFL=0.95 / math.sqrt(3.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            iter_max=10_000, nout=100, use_kernel=False,
        )
    return stokes, thermal, info, phases
