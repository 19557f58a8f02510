"""The share of the traced step in which no operation ran on the device:
1 less the union of the device's kernels, copies and sets over the step,
in percent. The step is profiled with CUDA activity only, so the profiler
adds little host time to a step that the host paces."""


def read(rec):
    if rec.trace is None or rec.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s())
