"""Driver of the Van Keken cells: ``justrelax_tpu_torch.models.vankeken.run``
through its normal path. Besides the solve's hooks
(``perfbench.core.solve2d``), the four particle calls the model imported are
wrapped: CUDA events around each call in every step, and in the step
sampled from the seed host copies of the particles the stage starts from
and of what it hands back. The seed reaches ``init_particles``: it draws
the particles' positions."""

from __future__ import annotations

import torch

from perfbench.core import compare, solve2d
from perfbench.core.harness import patched, run_model
from perfbench.core.timers import EventSpans
from perfbench.reference import vankeken as reference
from perfbench.reference import vep2d

PARTICLE_CALLS = ("advect_rk2", "move_particles", "inject_particles",
                  "phase_ratios_from_particles")
TABLE = ("G", "Kb", "eta0", "rho0", "gravity", "is_plastic")


def particle_seed(seed):
    return int(seed) % (2**63)


def _particles(p, phase):
    return {"px": p.px, "py": p.py, "active": p.active, "phase": phase}


def run(ctx):
    from justrelax_tpu_torch.models import vankeken as model
    from justrelax_tpu_torch.solvers import stokes2d_vep as solver

    cfg, s = ctx.cfg, ctx.cfg["solver"]
    win = ctx.window
    ctx.events = EventSpans(ctx.device.type == "cuda")
    caps = ctx.captures
    mirrors = {}

    def init_particles(*args, **kwargs):
        kwargs["seed"] = particle_seed(ctx.seed)
        return orig["init_particles"](*args, **kwargs)

    def timed(name):
        fn = orig[name]

        def call(*args, **kwargs):
            k = win.calls - 1
            sampled = k == win.check_step
            if k < 0 and name == "phase_ratios_from_particles":
                out = fn(*args, **kwargs)
                state = _particles(args[0], args[1]) | {"pr_c": out[0], "pr_v": out[1]}
                caps["start"] = {k_: solve2d.to_host(v) for k_, v in state.items()}
                mirrors["before"] = solve2d.Mirror(_particles(args[0], args[1]), ctx.device,
                                                   win.clock)
                mirrors["after"] = solve2d.Mirror(state, ctx.device, win.clock)
                return out
            if sampled and name == "advect_rk2":
                p = args[0]
                caps["before"] = mirrors["before"].fill(
                    {"px": p.px, "py": p.py, "active": p.active, "phase": None})
            if sampled and name == "move_particles":
                mirrors["before"].fill({"phase": args[2]["phase"]})
            a = ctx.events.start() if k >= 1 else None
            with win.span(name):
                out = fn(*args, **kwargs)
            ctx.events.end(a, (k, name))
            if sampled and name == "phase_ratios_from_particles":
                caps["after"] = mirrors["after"].fill(
                    _particles(args[0], args[1]) | {"pr_c": out[0], "pr_v": out[1]})
            return out

        return call

    def first(stokes, pt, material, pr_c, pr_v, dt):
        caps["start"] |= {"table": solve2d.material_table(material, TABLE),
                          "scalars": {"dt": float(dt), "r": pt.r,
                                      "theta_dtau": pt.theta_dtau, "etadtau": pt.etadtau}}
        return stokes

    hooks = ctx.hooks = solve2d.SolveHooks(ctx, solver, first)
    solve = hooks.solve(model.solve_vep)

    def solve_vep(*args, **kwargs):
        # the model's own settings, unless a test caps them
        kwargs.update(iter_max=s["iter_max"], nout=s["nout"])
        return solve(*args, **kwargs)

    names = ("init_particles",) + PARTICLE_CALLS
    orig = {n: getattr(model, n) for n in names}
    items = [(model, "init_particles", init_particles), (model, "solve_vep", solve_vep),
             (solver, "stokes_vep_chunk", hooks.chunk(solver.stokes_vep_chunk))]
    items += [(model, n, timed(n)) for n in PARTICLE_CALLS]
    p = cfg["particles"]
    with patched(items):
        run_model(model.run, nx=cfg["n"], ny=cfg["n"], nt=10**9, nxcell=p["per_cell"],
                  max_xcell=p["slots"], min_xcell=p["min_per_cell"], dtype=ctx.dtype,
                  device=ctx.device, **ctx.kernel_kw)


def _table(phases):
    return {k: torch.tensor(phases[k], dtype=torch.float64) for k in TABLE}


def readings(ctx, low=None):
    """The numbers compared: the start (particles, phase, phase ratios,
    material), the sampled solve's last two chunks and the sampled step's
    particle stage. With ``low`` the reference in that dtype stands in for
    the program."""
    cfg, dev, dtype = ctx.cfg, ctx.device, ctx.dtype
    seed = particle_seed(ctx.seed)
    n, L = cfg["n"], (cfg["lx"], cfg["ly"])
    dx, dy, _, _ = vep2d.grid(n, L)
    caps = ctx.captures
    out, worst = {}, {}

    # the start
    init = reference.initial(cfg, seed, dtype, dev)
    ref_scalars = dict(init["pt"], dt=init["dt"])
    if low is None:
        st = caps["start"]
        cp, c_pr = st, {"pr_c": st["pr_c"], "pr_v": st["pr_v"]}
        c_table, c_scalars = st["table"], st["scalars"]
    else:
        li = reference.initial(cfg, seed, low, dev)
        cp, c_pr = li["particles"], {"pr_c": li["pr_c"], "pr_v": li["pr_v"]}
        c_table = {k: v.to(low).double() for k, v in _table(li["phases"]).items()}
        c_scalars = {k: float(torch.tensor(v, dtype=low)) for k, v in ref_scalars.items()}
    pos, bad = compare.particle_gaps(cp, init["particles"], dx, dy)
    gaps = compare.field_gaps(c_pr, {"pr_c": init["pr_c"], "pr_v": init["pr_v"]})
    gaps |= {f"table.{k}": v for k, v in compare.field_gaps(c_table, _table(init["phases"])).items()}
    gaps |= {f"scalar.{k}": v for k, v in compare.scalar_gaps(c_scalars, ref_scalars).items()}
    gaps["particle_position"] = pos
    out["start_gap"], worst["start_gap"] = compare.worst(gaps)
    out["start_slot_mismatch"], worst["start_slot_mismatch"] = float(bad), "active/phase"
    del init

    # the sampled solve: its material from the particles it was given
    before = {k: v.to(dev) for k, v in caps["before"].items()}
    bx, by, ba, bph = (before[k].to(dtype) if k != "active" else before[k]
                       for k in ("px", "py", "active", "phase"))
    pr_c, pr_v = reference.pic.phase_ratios(bx, by, ba, bph, dx, dy, 2)
    entry = ctx.hooks.entry
    dt = vep2d.advective_dt(entry["Vx"].to(dev), entry["Vy"].to(dev), dx, dy) / cfg["dt_fraction_inv"]
    setup = {"phases": reference.phases(cfg), "pr_c": pr_c, "pr_v": pr_v, "dt": dt,
             "pt": vep2d.pt_coefficients(n, L, cfg["solver"]["CFL"], cfg["solver"]["r"],
                                         cfg["solver"]["Re"]), "dx": dx, "dy": dy}
    o, w = solve2d.solve_readings(ctx.hooks, setup, cfg, dtype, dev, low)
    out |= o
    worst |= w
    ctx.counts["vep2d"] = {"entry": entry,
                           "mat": vep2d.material_fields(setup["phases"], pr_c, pr_v)}
    del pr_c, pr_v, setup

    # the sampled step's particle stage, from the particles and velocities it was given
    Vx, Vy = (ctx.hooks.out[k].to(dev) for k in ("Vx", "Vy"))
    ref = reference.particle_step(bx, by, ba, bph, Vx.to(dtype), Vy.to(dtype), cfg)
    ref_p = dict(zip(("px", "py", "active", "phase"), ref[:4]))
    if low is None:
        cand = caps["after"]
        cand_p = {k: cand[k].to(dev) for k in ("px", "py", "active", "phase")}
        cand_pr = {"pr_c": cand["pr_c"], "pr_v": cand["pr_v"]}
    else:
        lw = reference.particle_step(bx.to(low), by.to(low), ba, bph.to(low), Vx.to(low),
                                     Vy.to(low), cfg)
        cand_p = dict(zip(("px", "py", "active", "phase"), lw[:4]))
        cand_pr = {"pr_c": lw[4], "pr_v": lw[5]}
    pos, bad = compare.particle_gaps(cand_p, ref_p, dx, dy)
    out["particle_position_gap"], worst["particle_position_gap"] = pos, "px/py"
    out["particle_slot_mismatch"], worst["particle_slot_mismatch"] = float(bad), "active/phase"
    prg = {k: float((cand_pr[k].to(dev, r.dtype) - r).abs().max())
           for k, r in (("pr_c", ref[4]), ("pr_v", ref[5]))}
    out["phase_ratio_gap"], worst["phase_ratio_gap"] = compare.worst(prg)
    return out, worst
