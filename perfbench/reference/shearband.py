"""The 2D visco-elasto-plastic shear band's initial state, built from the
published setup alone (JustRelax.jl ``miniapps/benchmarks/stokes2D/
shear_band/ShearBand2D.jl``; Duretz, de Borst & Le Pourhiet 2019): a unit
box under pure shear with free slip on every face, a weak circular
inclusion of half the shear modulus, Drucker-Prager plasticity on a Maxwell
background, dt a quarter of the Maxwell time."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import vep2d


def phases(cfg):
    """Per-phase parameters: matrix, then inclusion."""
    C = cfg["tau_y"] / math.cos(math.radians(cfg["friction_angle"]))
    both = lambda v: [float(v), float(v)]  # noqa: E731
    return {
        "rho0": both(0.0), "gravity": both(0.0),
        "G": [cfg["G0"], cfg["G_inclusion"]], "Kb": both(cfg["Kb"]),
        "eta0": both(cfg["eta0"]), "is_plastic": both(1.0), "C": both(C),
        "friction_angle": both(cfg["friction_angle"]),
        "dilation_angle": both(cfg["dilation_angle"]), "eta_reg": both(cfg["eta_reg"]),
    }


def _circle(xs, ys, centre, radius, dtype, device):
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    inside = (X - centre[0]) ** 2 + (Y - centre[1]) ** 2 <= radius**2
    return torch.as_tensor(np.stack([~inside, inside], axis=-1), dtype=dtype, device=device)


def initial(cfg, dtype, device):
    """The model's state at the first solve: the carried fields, the phase
    ratios, the material, the time step, the solver's coefficients."""
    n, L = cfg["n"], (cfg["lx"], cfg["ly"])
    dx, dy, xc, xv = vep2d.grid(n, L)
    kw = dict(dtype=dtype, device=device)
    e = cfg["eps_bg"]
    Vx = (e * torch.as_tensor(xv[0], **kw))[:, None].expand(n + 1, n + 2).contiguous()
    Vy = (-e * torch.as_tensor(xv[1], **kw))[None, :].expand(n + 2, n + 1).contiguous()
    Vx, Vy = vep2d._bcs(Vx, Vy, cfg["bc"])
    zc = torch.zeros((n, n), **kw)
    zv = torch.zeros((n + 1, n + 1), **kw)
    s = cfg["solver"]
    return {
        "carry": {"Vx": Vx, "Vy": Vy, "theta": zc, "P": zc, "txx": zc, "tyy": zc,
                  "txy_c": zc, "txy_v": zv, "eta": torch.ones((n, n), **kw),
                  "eta_v": torch.ones((n + 1, n + 1), **kw), "lam": zc, "lam_v": zv},
        "pr_c": _circle(xc[0], xc[1], cfg["inclusion_centre"], cfg["inclusion_radius"], dtype, device),
        "pr_v": _circle(xv[0], xv[1], cfg["inclusion_centre"], cfg["inclusion_radius"], dtype, device),
        "phases": phases(cfg),
        "dt": cfg["eta0"] / cfg["G0"] * cfg["dt_over_maxwell"],
        "pt": vep2d.pt_coefficients(n, L, s["CFL"], s["r"], s["Re"]),
        "dx": dx, "dy": dy,
    }
