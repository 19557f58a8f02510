"""Faults planted under the timed path, each of which ``correct`` has to
catch: ``fault(kind)`` returns a callable that the harness gives the run's
context before the run (``harness.run_cell(..., faults=[...])``) and whose
``undo()`` takes the fault out again. The CPU tests plant them at a tiny
size, ``perfbench/control.py --fault`` at a cell's own size on the card.

- ``unchanged``: the chunk call returns its state unchanged;
- ``half``: the chunk call leaves half of the grid as it came in;
- ``altered``: the chunk call's τxx is altered by 10 % where it is produced;
- ``particle``: one active particle moved by a quarter cell after the move.
"""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half", "altered", "particle")


def fault(kind):
    if kind == "particle":
        return _particle_fault()
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    from justrelax_tpu_torch.solvers import stokes2d_vep as solver

    orig = solver.stokes_vep_chunk

    def broken(*args, **kwargs):
        if kind == "unchanged":
            return tuple(args[:12])
        out = list(orig(*args, **kwargs))
        if kind == "half":
            h = out[0].shape[0] // 2
            for i in range(12):
                o = out[i].clone()
                o[:h] = args[i][:h]
                out[i] = o
        else:
            out[4] = out[4] * 1.1
        return tuple(out)

    def install(ctx):
        solver.stokes_vep_chunk = broken

    install.undo = lambda: setattr(solver, "stokes_vep_chunk", orig)
    return install


def _particle_fault():
    from justrelax_tpu_torch.models import vankeken

    orig = vankeken.move_particles

    def moved(particles, geometry, fields, **kw):
        p, f = orig(particles, geometry, fields, **kw)
        px = p.px.clone()
        i = torch.nonzero(p.active)[0]
        px[tuple(i)] += 0.25 * geometry.di[0]
        return p.replace(px=px), f

    def install(ctx):
        vankeken.move_particles = moved

    install.undo = lambda: setattr(vankeken, "move_particles", orig)
    return install
