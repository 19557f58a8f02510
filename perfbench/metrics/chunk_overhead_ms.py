"""The chunk loop's cost around the kernel, per chunk call: the untraced
window steps' solve wall time (host clock) less the VEP kernel's device
time for their launches (its time per launch read in the traced step; a
chunk call of ``nout`` iterations launches it ``nout − 1`` times), over
their chunk calls, in ms. The untraced steps' host clock keeps the
profiler's own cost out."""

from perfbench.metrics import _vep


def read(rec):
    k = _vep.kernel_launches(rec)
    steps = [s for s in rec.untraced() if s.get("chunk_calls")]
    if k is None or not steps:
        return None
    per_launch = k[1] / k[0]
    calls = sum(s["chunk_calls"] for s in steps)
    solve = sum(s["solve_s"] for s in steps)
    nout = int(rec.cfg["solver"]["nout"])
    return (solve - per_launch * (nout - 1) * calls) / calls * 1e3
