"""What the VEP kernel's readers share: its launches in the traced step
and the frozen count of the bytes one iteration must move."""

from perfbench.counts import vep2d

# B2/B3's kernel as csrc/stokes_vep.cu names it, k_iteration<T, CAP, TX, TY>;
# the port's other kernels named k_iteration take other template arguments
KERNEL = r"k_iteration<\w+, (?:true|false), \d+, \d+>"


def kernel_launches(rec):
    """(count, device seconds) of the VEP kernel in the traced step, or
    ``None`` without a trace or a launch."""
    if rec.trace is None:
        return None
    ks = rec.trace.kernels(KERNEL)
    if not ks:
        return None
    return len(ks), sum(b - a for a, b, _ in ks) * 1e-6


def bytes_per_iteration(rec):
    c = rec.counts.get("vep2d")
    if c is None:
        return None
    n_cells = rec.cfg["n"] ** 2
    return vep2d.bytes_per_iteration(c["entry"], c["mat"], n_cells, rec.itemsize)
