"""Driver of the shear band cells: ``justrelax_tpu_torch.models.shearband.run``
through its normal path, its steps marked and sampled by the hooks of
``perfbench.core.solve2d``.

The published setup has nothing random, so the seed perturbs only the first
solve's starting guess: the interior velocities get uniform offsets of
``seed_perturbation``·ε̇bg·lx at most, drawn on the device from the seed.
The boundary velocities, the material and the loading stay as published."""

from __future__ import annotations

import torch

from perfbench.core import compare, solve2d
from perfbench.core.harness import patched, run_model
from perfbench.reference import shearband as reference
from perfbench.reference import vep2d

START_FIELDS = {"Vx": lambda s: s.V.Vx, "Vy": lambda s: s.V.Vy, "P": lambda s: s.P,
                "txx": lambda s: s.tau.xx, "tyy": lambda s: s.tau.yy,
                "txy_c": lambda s: s.tau.xy_c, "txy_v": lambda s: s.tau.xy,
                "eta": lambda s: s.viscosity.eta, "eta_v": lambda s: s.viscosity.eta_v}
TABLE = ("G", "Kb", "eta0", "C", "friction_angle", "dilation_angle", "eta_reg",
         "is_plastic", "rho0", "gravity")


def perturbation(cfg, seed, dtype, device):
    """(ΔVx, ΔVy) on the interior velocity nodes, from the seed."""
    n = cfg["n"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    amp = cfg["seed_perturbation"] * cfg["eps_bg"] * cfg["lx"]
    kw = dict(generator=g, device=device, dtype=dtype)
    return ((torch.rand((n - 1, n), **kw) - 0.5) * (2 * amp),
            (torch.rand((n, n - 1), **kw) - 0.5) * (2 * amp))


def run(ctx):
    from justrelax_tpu_torch.models import shearband as model
    from justrelax_tpu_torch.solvers import stokes2d_vep as solver

    cfg, s = ctx.cfg, ctx.cfg["solver"]
    dvx, dvy = perturbation(cfg, ctx.seed, ctx.dtype, ctx.device)

    def first(stokes, pt, material, pr_c, pr_v, dt):
        ctx.captures["start"] = {
            "fields": {k: solve2d.to_host(f(stokes)) for k, f in START_FIELDS.items()}
            | {"pr_c": solve2d.to_host(pr_c), "pr_v": solve2d.to_host(pr_v)},
            "table": solve2d.material_table(material, TABLE),
            "scalars": {"dt": float(dt), "r": pt.r, "theta_dtau": pt.theta_dtau,
                        "etadtau": pt.etadtau},
        }
        Vx, Vy = stokes.V.Vx.clone(), stokes.V.Vy.clone()
        Vx[1:-1, 1:-1] += dvx
        Vy[1:-1, 1:-1] += dvy
        return stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))

    hooks = ctx.hooks = solve2d.SolveHooks(ctx, solver, first)
    with patched([(model, "solve_vep", hooks.solve(model.solve_vep)),
                  (solver, "stokes_vep_chunk", hooks.chunk(solver.stokes_vep_chunk))]):
        run_model(model.run, n=cfg["n"], nt=10**9, dtype=ctx.dtype, eps_bg=cfg["eps_bg"],
                  iter_max=s["iter_max"], nout=s["nout"], device=ctx.device, **ctx.kernel_kw)


def _table(phases):
    return {k: torch.tensor(phases[k], dtype=torch.float64) for k in TABLE}


def readings(ctx, low=None):
    """The numbers compared: the start, the sampled solve's last two
    chunks. With ``low`` the reference in that dtype stands in for the
    program."""
    cfg, dev, dtype = ctx.cfg, ctx.device, ctx.dtype
    init = reference.initial(cfg, dtype, dev)
    ref_fields = dict(init["carry"], pr_c=init["pr_c"], pr_v=init["pr_v"])
    ref_fields = {k: ref_fields[k] for k in ctx.captures["start"]["fields"]}
    ref_scalars = dict(init["pt"], dt=init["dt"])
    if low is None:
        cand = ctx.captures["start"]
        cand_fields, cand_table, cand_scalars = cand["fields"], cand["table"], cand["scalars"]
    else:
        li = reference.initial(cfg, low, dev)
        cand_fields = {k: (dict(li["carry"], pr_c=li["pr_c"], pr_v=li["pr_v"]))[k]
                       for k in ref_fields}
        cand_table = {k: v.to(low).double() for k, v in _table(li["phases"]).items()}
        cand_scalars = {k: float(torch.tensor(v, dtype=low)) for k, v in ref_scalars.items()}
    gaps = compare.field_gaps(cand_fields, ref_fields)
    gaps |= {f"table.{k}": v for k, v in
             compare.field_gaps(cand_table, _table(init["phases"])).items()}
    gaps |= {f"scalar.{k}": v for k, v in compare.scalar_gaps(cand_scalars, ref_scalars).items()}
    out, worst = {}, {}
    out["start_gap"], worst["start_gap"] = compare.worst(gaps)

    setup = {"phases": init["phases"], "pr_c": init["pr_c"], "pr_v": init["pr_v"],
             "dt": init["dt"], "pt": init["pt"], "dx": init["dx"], "dy": init["dy"]}
    o, w = solve2d.solve_readings(ctx.hooks, setup, cfg, dtype, dev, low)
    out |= o
    worst |= w
    # the sampled solve's inputs, for the frozen byte count
    ctx.counts["vep2d"] = {"entry": ctx.hooks.entry, "mat": vep2d.material_fields(
        setup["phases"], setup["pr_c"], setup["pr_v"])}
    return out, worst
