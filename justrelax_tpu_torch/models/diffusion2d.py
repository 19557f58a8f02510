"""2D thermal diffusion benchmark.

Counterpart of ``justrelax_tpu/models/diffusion2d.py``: a 100×100 km domain
with a linear geotherm (1600→1900 K across the cell-center column),
Dirichlet top/bottom (300 K / 3500 K), insulating sides, constant radiogenic
heating 1e-6 W/m³ and a +100 K circular perturbation of radius 10 km at the
center; 20 implicit steps of 50 kyr of the PT diffusion solver with a
T-dependent density (ρ0 = 3.1e3, α = 1.5e-5), Cp = 1.2e3, k = 3.

Golden values at 32² (tests/test_diffusion2d.py): T[17, 17] ≈
1817.9448461176817 and T[16, 16] ≈ 1827.4674313638786 (0-based, ghosted
34×34 array), within 0.1; final residual < 1e-8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import ThermalState
from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs
from justrelax_tpu_torch.rheology.materials import Material
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

__all__ = ["KYR", "MYR", "setup", "run"]

KYR = 1.0e3 * 3600 * 24 * 365.25
MYR = 1.0e3 * KYR


def setup(nx=32, ny=32, lx=100.0e3, ly=100.0e3, dtype=None, device=None):
    """Grid, material, initial thermal state and BCs, on ``device`` (the
    card unless given)."""
    device = resolve_device(device)
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xci = geometry.xci
    material = Material(rho0=3.1e3, alpha=1.5e-5, beta=0.0, T0=0.0, Cp=1.2e3, k=3.0)

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=thermal.T.dtype, device=device)
    thermal = thermal.replace(H=torch.full(ni, 1.0e-6, **f))

    # linear geotherm on all columns (incl. x-ghosts), interior rows
    z = xci[1]
    profile = z * (1900.0 - 1600.0) / z.min() + 1600.0
    T = np.zeros((nx + 2, ny + 2))
    T[:, 1:-1] = profile[None, :]
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=300.0, bot=3500.0),
    )
    T = thermal_bcs(torch.as_tensor(T, **f), thermal_bc)

    # circular thermal perturbation at the domain center
    xc, yc = lx / 2, -ly / 2
    X, Y = np.meshgrid(xci[0], xci[1], indexing="ij")
    mask = (X - xc) ** 2 + (Y - yc) ** 2 <= 10.0e3**2
    T[1:-1, 1:-1] += torch.as_tensor(100.0 * mask, **f)
    return geometry, material, thermal.replace(T=T), thermal_bc


def run(nx=32, ny=32, lx=100.0e3, ly=100.0e3, ttot=1 * MYR, dt=50 * KYR, dtype=None,
        device=None):
    """``ceil(ttot/dt)`` implicit steps; returns (thermal, info of the last
    solve). ``device`` defaults to the card."""
    geometry, material, thermal, thermal_bc = setup(nx, ny, lx, ly, dtype, device)
    ni = geometry.ni
    f = dict(dtype=thermal.T.dtype, device=thermal.T.device)

    # PT coefficients from constant K and ρCp (the reference uses ρ0 = 3.3e3 here)
    K = torch.full(ni, 3.0, **f)
    rho_Cp = torch.full(ni, 3.3e3 * 1.2e3, **f)
    pt_thermal = PTThermalCoeffs.make(K, rho_Cp, dt, geometry.di, geometry.li,
                                      CFL=0.95 / math.sqrt(2.1))
    P = torch.zeros(ni, **f)
    info = None
    for _ in range(int(math.ceil(ttot / dt))):
        # ρ(T)·Cp is re-evaluated from T every iteration (the material
        # path), which the thermal chunk kernel does not cover (its contract
        # is the constant-coefficient K/ρCp path, as B5's is): the plain path
        # is asked for explicitly.
        thermal, info = heatdiffusion_PT(thermal, pt_thermal, thermal_bc, dt, geometry,
                                         material=material, P=P, use_kernel=False)
    return thermal, info
