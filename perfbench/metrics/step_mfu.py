"""The whole step's share of the card's peak, which HBM bandwidth sets for
this solver: the frozen bytes of one PT iteration times the iterations of
the window's untraced steps, over those steps' wall time and the HBM peak,
in percent."""

from perfbench.metrics import _vep


def read(rec):
    b = _vep.bytes_per_iteration(rec)
    steps = [s for s in rec.untraced() if "iters" in s]
    if b is None or rec.peak is None or not steps:
        return None
    wall = sum(s["t1"] - s["t0"] for s in steps)
    iters = sum(s["iters"] for s in steps)
    return 100.0 * b * iters / (wall * rec.peak["hbm_bytes_per_s"])
