"""Hooks around the 2D VEP Stokes solve that a model step calls, and the
check of what that solve produced.

The model's ``solve_vep`` name is wrapped to mark step boundaries, time the
solve, keep its iteration count and, in the step sampled from the seed,
copy to the host the state it was entered with and the fields it handed
back. The solver's ``stokes_vep_chunk`` name (the chunk kernel's wrapper)
is wrapped to count its calls. After the window the program's solve runs
once more from the sampled entry state, keeping the last two chunk calls'
inputs, and must hand back the window's fields bit for bit. The plain
reference then runs those two chunks again: the first against the second's
input (the kernel's ``nout − 1`` iterations and the solver's own last
iteration of the chunk), the second through the fields the solve hands
back."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.core import compare
from perfbench.core.harness import patched
from perfbench.reference import vep2d

CARRY = vep2d.CARRY
ENTRY = {"P0": lambda s: s.P, "Q": lambda s: s.Q, "txx_o": lambda s: s.tau_o.xx,
         "tyy_o": lambda s: s.tau_o.yy, "txy_c_o": lambda s: s.tau_o.xy_c,
         "txy_v_o": lambda s: s.tau_o.xy, "EII_pl": lambda s: s.EII_pl,
         "Vx": lambda s: s.V.Vx, "Vy": lambda s: s.V.Vy}
OUT = {"Vx": lambda s: s.V.Vx, "Vy": lambda s: s.V.Vy, "P": lambda s: s.P,
       "txx": lambda s: s.tau.xx, "tyy": lambda s: s.tau.yy, "txy_c": lambda s: s.tau.xy_c,
       "txy_v": lambda s: s.tau.xy, "tau_II": lambda s: s.tau.II,
       "eta": lambda s: s.viscosity.eta, "eta_v": lambda s: s.viscosity.eta_v,
       "lam": lambda s: s.lam,
       "lam_v": lambda s: s.lam_v, "EII_pl": lambda s: s.EII_pl}


def to_host(t):
    return t.detach().to("cpu", copy=True)


def tree_map(fn, obj):
    """``fn`` applied to every tensor of ``obj`` (tensors, dataclasses of
    them, dicts, lists, tuples), the structure rebuilt."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: tree_map(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_map(fn, v) for v in obj)
    return obj


def leaves(obj):
    out = []
    tree_map(out.append, obj)
    return out


class Mirror:
    """Host buffers shaped like a tree of device tensors, pinned on the
    card, allocated once (in set-up) and filled in the window by one
    asynchronous copy per tensor and one wait (``clock``, the window's)."""

    def __init__(self, like, device, clock):
        self.device = device
        self.clock = clock
        pin = device.type == "cuda"
        self.host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin), like)

    def fill(self, tree):
        """Copy ``tree`` in; in a dict, an entry given as ``None`` is left
        as it is."""
        pairs = ([(self.host[k], v) for k, v in tree.items() if v is not None]
                 if isinstance(tree, dict) else [(self.host, tree)])
        for host, dev in pairs:
            for h, d in zip(leaves(host), leaves(dev)):
                h.copy_(d, non_blocking=True)
        self.clock()
        return self.host


class SolveHooks:
    """Wrappers for a model module's ``solve_vep`` and the solver module's
    ``stokes_vep_chunk``; ``first`` (optional) is called with the warm-up
    solve's arguments and may return a new entry state.

    In the window the sampled solve costs two host copies: the whole state
    it is entered with and the fields it hands back. After the window
    :meth:`replay` runs the program's solve again from that entry state,
    keeping the last two chunks' inputs, and checks that it hands back the
    window's fields bit for bit."""

    def __init__(self, ctx, solver, first=None):
        self.ctx = ctx
        self.solver = solver
        self.orig_chunk = solver.stokes_vep_chunk
        self.first = first
        self.kept = None
        self.chunk_calls = 0
        self.mirror_in = self.mirror_out = None
        self.call = None
        self.replayed = None

    def solve(self, orig):
        ctx = self.ctx
        self.orig_solve = orig

        def solve_vep(stokes, pt_stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
                      *args, **kwargs):
            win = ctx.window
            k = win.boundary()
            if k == 0:
                if self.first is not None:
                    stokes = self.first(stokes, pt_stokes, material, pr_c, pr_v, dt)
                self.mirror_in = Mirror(stokes, ctx.device, win.clock)
                self.mirror_out = Mirror({n: f(stokes) for n, f in OUT.items()}, ctx.device,
                                         win.clock)
            sampled = k == win.check_step
            if sampled:
                self.mirror_in.fill(stokes)
                self.call = dict(pt=pt_stokes, geometry=geometry, flow_bc=flow_bc,
                                 material=material, pr_c=to_host(pr_c), pr_v=to_host(pr_v),
                                 dt=dt, args=args, kwargs=kwargs)
            calls0 = self.chunk_calls
            with win.span("solve_vep"):
                t0 = win.clock()
                out, info = orig(stokes, pt_stokes, geometry, flow_bc, material,
                                 pr_c, pr_v, dt, *args, **kwargs)
                t1 = win.clock()
            err = float(info.err)
            win.note(k, solve_s=t1 - t0, iters=int(info.iters),
                     chunk_calls=self.chunk_calls - calls0, failed=not (err == err))
            if sampled:
                self.mirror_out.fill({n: f(out) for n, f in OUT.items()})
            return out, info

        return solve_vep

    def chunk(self, orig):
        ctx = self.ctx

        def stokes_vep_chunk(*args, **kwargs):
            self.chunk_calls += 1
            if self.kept is not None:
                self.kept = (self.kept + [dict(zip(CARRY, (to_host(t) for t in args[:12])))])[-2:]
            with ctx.window.span("stokes_vep_chunk"):
                return orig(*args, **kwargs)

        return stokes_vep_chunk

    @property
    def entry(self):
        """The sampled solve's entry fields (host)."""
        e = {n: f(self.mirror_in.host) for n, f in ENTRY.items()}
        e["dt"] = float(self.call["dt"])
        return e

    @property
    def out(self):
        """The fields the sampled solve handed back in the window (host)."""
        return self.mirror_out.host

    def replay(self):
        """Run the sampled solve again from its entry state (after the
        window), keeping the last two chunk calls' inputs; returns them and
        the number of values in which what the replay handed back differs
        from what the window's solve did."""
        if self.replayed is None:
            dev, c = self.ctx.device, self.call
            entry = tree_map(lambda t: t.to(dev), self.mirror_in.host)
            self.kept = []
            with patched([(self.solver, "stokes_vep_chunk", self.chunk(self.orig_chunk))]):
                out, _ = self.orig_solve(entry, c["pt"], c["geometry"], c["flow_bc"],
                                         c["material"], c["pr_c"].to(dev), c["pr_v"].to(dev),
                                         c["dt"], *c["args"], **c["kwargs"])
            again = {n: to_host(f(out)) for n, f in OUT.items()}
            gap = max(float((again[n] != self.out[n]).sum()) for n in OUT)
            self.replayed = (self.kept, gap)
            self.kept = None
            del out, entry
        return self.replayed


def solve_readings(hooks, setup, cfg, dtype, device, low=None):
    """The two chunk comparisons of the sampled solve. ``setup`` holds the
    reference's material (``phases``, ``pr_c``, ``pr_v``), ``dt``, ``pt``,
    ``dx``, ``dy``. With ``low`` (a dtype) the reference computed in it
    stands in the program's place (the control). Returns
    {"chunk_gap": …, "solve_end_gap": …} and the worst fields."""
    s_cfg = cfg["solver"]
    nout = int(s_cfg["nout"])
    chunks, replay_gap = hooks.replay()
    entry = hooks.entry

    def solve_for(dt_):
        def dev(name):
            return entry[name].to(device=device, dtype=dt_)
        mat = vep2d.material_fields(setup["phases"], setup["pr_c"].to(dt_), setup["pr_v"].to(dt_))
        return vep2d.Solve(
            P0=dev("P0"), Q=dev("Q"), txx_o=dev("txx_o"), tyy_o=dev("tyy_o"),
            txy_c_o=dev("txy_c_o"), txy_v_o=dev("txy_v_o"), mat=mat, dt=setup["dt"],
            dx=setup["dx"], dy=setup["dy"], pt=setup["pt"],
            rel_lambda=s_cfg["lambda_relaxation"], visc_relax=s_cfg["viscosity_relaxation"],
            bc=cfg["bc"])

    def on(carry, dt_):
        return {k: v.to(device=device, dtype=dt_) for k, v in carry.items()}

    full = solve_for(dtype)
    lowsolve = solve_for(low) if low is not None else None
    out, worst = {"replay_mismatch": replay_gap}, {"replay_mismatch": "values differing"}
    if len(chunks) >= 2:
        ref, _ = vep2d.chunk(on(chunks[-2], dtype), full, nout)
        if low is None:
            cand = chunks[-1]
        else:
            cand, _ = vep2d.chunk(on(chunks[-2], low), lowsolve, nout)
        out["chunk_gap"], worst["chunk_gap"] = compare.worst(compare.field_gaps(cand, ref))
        del ref, cand
    else:
        out["chunk_gap"], worst["chunk_gap"] = float("inf"), "fewer than two chunks"
    if chunks:
        EII = entry["EII_pl"].to(device=device, dtype=dtype)
        c, d = vep2d.chunk(on(chunks[-1], dtype), full, nout)
        ref = vep2d.solve_end(c, d, EII, setup["dt"])
        del c, d
        if low is None:
            cand = hooks.out
        else:
            c, d = vep2d.chunk(on(chunks[-1], low), lowsolve, nout)
            cand = vep2d.solve_end(c, d, EII.to(low), setup["dt"])
        out["solve_end_gap"], worst["solve_end_gap"] = compare.worst(compare.field_gaps(cand, ref))
    else:
        out["solve_end_gap"], worst["solve_end_gap"] = float("inf"), "no chunk kept"
    return out, worst


def material_table(material, names):
    """The program's per-phase parameters, for the start check."""
    p = material.params
    return {k: to_host(getattr(p, k)).double() for k in names}
