"""PT iterations per step: the iterations each window step's solve
reported (``solve_vep``'s returned info), averaged."""


def read(rec):
    iters = [s["iters"] for s in rec.steps if "iters" in s]
    return sum(iters) / len(iters) if iters else None
