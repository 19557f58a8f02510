"""The comparisons that decide ``correct``: gaps between what the program
produced and what the plain reference produces from the same inputs."""

from __future__ import annotations

import statistics

import torch


def field_gaps(prog: dict, ref: dict):
    """Each field's largest absolute gap over a scale: the larger of that
    field's largest reference magnitude and the median of those magnitudes
    over the fields, so that a field that is all but zero in the reference
    (a plastic multiplier outside the band) is not judged against its own
    rounding. Returns {field: gap}."""
    mags = {k: float(ref[k].abs().max()) if ref[k].numel() else 0.0 for k in ref}
    med = statistics.median(mags.values())
    out = {}
    for k, r in ref.items():
        p = prog[k].to(device=r.device, dtype=r.dtype)
        if p.shape == r.shape:
            diff = float(torch.where(p == r, 0.0, (p - r).abs()).max()) if r.numel() else 0.0
        else:
            diff = float("inf")
        if diff != diff:  # NaN in either
            diff = float("inf")
        scale = max(mags[k], med)
        out[k] = diff / scale if scale > 0 else diff
    return out


def worst(gaps: dict):
    """(largest gap, its field)."""
    k = max(gaps, key=lambda name: gaps[name])
    return gaps[k], k


def scalar_gaps(prog: dict, ref: dict):
    """Relative gaps of scalars (absolute where the reference is 0)."""
    out = {}
    for k, r in ref.items():
        p = float(prog[k])
        out[k] = abs(p - r) / abs(r) if r != 0 else abs(p)
    return out


def particle_gaps(prog: dict, ref: dict, dx: float, dy: float):
    """(largest position gap in cell widths over the slots active on both
    sides, slots whose activity or phase differ)."""
    a_p = prog["active"].to(ref["active"].device)
    a_r = ref["active"]
    both = a_p & a_r
    if bool(both.any()):
        gx = (prog["px"].to(ref["px"]) - ref["px"]).abs()[both].max() / dx
        gy = (prog["py"].to(ref["py"]) - ref["py"]).abs()[both].max() / dy
        pos = float(torch.maximum(gx, gy))
    else:
        pos = 0.0
    if pos != pos:
        pos = float("inf")
    phase_off = both & (prog["phase"].to(ref["phase"]) != ref["phase"])
    return pos, int((a_p != a_r).sum()) + int(phase_off.sum())
