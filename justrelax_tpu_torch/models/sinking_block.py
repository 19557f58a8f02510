"""Sinking block benchmark.

Counterpart of ``justrelax_tpu/models/sinking_block.py``: a 500×500 km box
of mantle (η = 1e21, ρ = 3200) with a 100×100 km stiff, dense block
(η = 1e23, ρ = 3300) centered at 250 km across and 100 km deep; lithostatic
initial pressure; free slip on all four faces. Oracle at 32²
(tests/test_more_benchmarks.py): residual < 1e-5 and max vertex velocity
4.8419e-10 m/s within 10 %.

On the card the solve runs through the VEP chunk kernel (B2/B3): the creep
table is linear, ρ is constant and every face is free slip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.interpolation import velocity2vertex
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep

__all__ = ["run"]


def run(n=32, iter_max=150_000, nout=1_000, dtype=None, device=None, use_kernel=None):
    """The sinking block solve; returns (stokes, info, max |V| at the
    vertices). ``device`` defaults to the card; ``use_kernel`` to the
    Hopper kernel on the card and the plain path on the CPU (``False``
    asks for the plain path)."""
    device = resolve_device(device)
    ni = (n, n)
    ly = 500.0e3
    geometry = Geometry(ni, (ly, ly), origin=(0.0, -ly))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = MaterialStack.make(
        [
            Material(rho0=3.2e3, eta0=1.0e21, gravity=9.81),
            Material(rho0=3.3e3, eta0=1.0e23, gravity=9.81),
        ],
        dtype=f["dtype"], device=device,
    )
    X, Y = geometry.cell_centers_mesh()
    depth = -Y
    block = (np.abs(X - 250.0e3) <= 50.0e3) & (np.abs(depth - 100.0e3) <= 50.0e3)
    pr = phase_ratios_from_field(torch.as_tensor(block.astype(int), device=device), 2,
                                 dtype=f["dtype"])

    # initial viscosity and pressure: η from the phases, lithostatic P = ρg·|y|
    eta0 = torch.as_tensor(np.where(block, 1.0e23, 1.0e21), **f)
    rho = torch.as_tensor(np.where(block, 3.3e3, 3.2e3), **f)
    P0 = rho * 9.81 * torch.as_tensor(np.abs(Y), **f)
    stokes = stokes.replace(P=P0, viscosity=stokes.viscosity.replace(eta=eta0))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-5, CFL=0.95 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    stokes, info = solve_vep(
        stokes, pt_stokes, geometry, flow_bc, material, pr.center, pr.vertex, 1.0,
        iter_max=iter_max, nout=nout, use_kernel=use_kernel,
    )
    Vx_v, Vy_v = velocity2vertex(stokes.V.Vx, stokes.V.Vy)
    vmax = float(torch.sqrt(Vx_v**2 + Vy_v**2).max())
    return stokes, info, vmax
