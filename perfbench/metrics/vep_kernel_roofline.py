"""B2/B3's share of its roofline: the bytes its launches in the traced
step must move (one PT iteration per launch, the frozen count of
``perfbench/counts/vep2d.py``) over their device time and the card's HBM
peak, in percent. Bandwidth bounds it: a few dozen operations a cell take
far less at the card's floating-point peak."""

from perfbench.metrics import _vep


def read(rec):
    k = _vep.kernel_launches(rec)
    b = _vep.bytes_per_iteration(rec)
    if k is None or b is None or rec.peak is None:
        return None
    count, seconds = k
    return 100.0 * b * count / (seconds * rec.peak["hbm_bytes_per_s"])
