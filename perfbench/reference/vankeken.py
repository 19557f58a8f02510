"""The isoviscous Rayleigh-Taylor instability of van Keken et al. (1997,
JGR 102(B10), case 1a; JustRelax.jl ``test/test_VanKeken.jl``), built from
the published setup alone: a unit box, a dense layer (ρ = 2) over a light
one (ρ = 1) meeting at y = 0.2 + 0.02·cos(πx/λ), λ = 0.9142, η = 1, g = 1,
free slip on the sides and no slip at top and bottom. The composition rides
particles; each step the particles are advected by RK2 over a tenth of the
advective time step, re-binned, topped up and turned into phase ratios."""

from __future__ import annotations

import math

import torch

from perfbench.reference import particles2d as pic
from perfbench.reference import vep2d


def phases(cfg):
    return {
        "rho0": [cfg["rho_light"], cfg["rho_dense"]], "gravity": [cfg["g"], cfg["g"]],
        "G": [math.inf, math.inf], "Kb": [math.inf, math.inf], "eta0": [cfg["eta"], cfg["eta"]],
        "is_plastic": [0.0, 0.0], "C": [0.0, 0.0], "friction_angle": [0.0, 0.0],
        "dilation_angle": [0.0, 0.0], "eta_reg": [0.0, 0.0],
    }


def initial_phase(px, py, cfg):
    """1 (dense) above the interface, 0 below."""
    return torch.where(
        py > cfg["interface_y"] + cfg["interface_amp"]
        * torch.cos(math.pi * px / cfg["interface_lambda"]), 1.0, 0.0).to(px.dtype)


def initial(cfg, seed, dtype, device):
    """The model's state at the first solve, the particles it starts from
    and their phase."""
    n, L = cfg["n"], (cfg["lx"], cfg["ly"])
    dx, dy, _, _ = vep2d.grid(n, L)
    p = cfg["particles"]
    px, py, active = pic.seed_particles(n, dx, dy, p["per_cell"], p["slots"], seed, dtype, device)
    phase = initial_phase(px, py, cfg)
    pr_c, pr_v = pic.phase_ratios(px, py, active, phase, dx, dy, 2)
    kw = dict(dtype=dtype, device=device)
    zc = torch.zeros((n, n), **kw)
    zv = torch.zeros((n + 1, n + 1), **kw)
    s = cfg["solver"]
    return {
        "carry": {"Vx": torch.zeros((n + 1, n + 2), **kw), "Vy": torch.zeros((n + 2, n + 1), **kw),
                  "theta": zc, "P": zc, "txx": zc, "tyy": zc, "txy_c": zc, "txy_v": zv,
                  "eta": torch.ones((n, n), **kw), "eta_v": torch.ones((n + 1, n + 1), **kw),
                  "lam": zc, "lam_v": zv},
        "particles": {"px": px, "py": py, "active": active, "phase": phase},
        "pr_c": pr_c, "pr_v": pr_v, "phases": phases(cfg), "dt": cfg["first_dt"],
        "pt": vep2d.pt_coefficients(n, L, s["CFL"], s["r"], s["Re"]), "dx": dx, "dy": dy,
    }


def particle_step(px, py, active, phase, Vx, Vy, cfg):
    """One step's particle stage after its solve: returns (px, py, active,
    phase, pr_c, pr_v)."""
    n, L = cfg["n"], (cfg["lx"], cfg["ly"])
    dx, dy, _, _ = vep2d.grid(n, L)
    p = cfg["particles"]
    dt = vep2d.advective_dt(Vx, Vy, dx, dy) / cfg["dt_fraction_inv"]
    px, py = pic.advect(px, py, active, Vx, Vy, dx, dy, L, dt)
    px, py, active, phase = pic.rebin(px, py, active, phase, dx, dy)
    px, py, active, phase = pic.inject(px, py, active, phase, dx, dy, p["per_cell"],
                                       p["min_per_cell"], 2)
    pr_c, pr_v = pic.phase_ratios(px, py, active, phase, dx, dy, 2)
    return px, py, active, phase, pr_c, pr_v
