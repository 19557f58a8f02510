"""The measured window: whole model steps between the end of the warm-up
step and the first step boundary at or after ``--seconds``, with the host
clock read (after a synchronise) at every boundary. A model step starts
where its Stokes solve is entered; the model's own set-up and its first
step are the warm-up, counted in ``setup_s``. The window is held open
until the step sampled for the check and the traced step have run.

With ``--trace 1`` window step :data:`TRACED_STEP` runs under
``torch.profiler`` with CUDA activity only (kernels, copies, sets and the
CUDA runtime's calls), so that the profiler does not record every host op
and slow the host that paces some steps. The harness's host spans of that
step are kept on the host clock and put on the trace's clock by the
harness's synchronises in that step (:meth:`StepWindow.clock`)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from perfbench.core import timers

TRACED_STEP = 2  # the window step profiled in a --trace 1 run


class StopWindow(Exception):
    """Raised at the step boundary that closes the window; the model's run
    unwinds and frees its state."""


class StepWindow:
    def __init__(self, t_process, seconds, device, check_step, trace=False, trace_dir=None):
        self.t_process = t_process
        self.seconds = float(seconds)
        self.device = device
        self.check_step = int(check_step)
        self.traced_step = TRACED_STEP if trace else None
        self.trace_dir = trace_dir
        self.calls = 0
        self.steps = []
        self.setup_s = None
        self.t0 = None
        self.t1 = None
        self.profiler = None
        self.stopped = None
        self.host_spans = []  # (name, start, end) on the host clock, traced step only
        self.anchors = []  # the host clock after each synchronise of the traced step
        self.last_needed = max(self.check_step, self.traced_step or 0)

    @property
    def tracing(self):
        return self.profiler is not None

    def clock(self):
        """The host clock once the card has finished what was queued. In
        the traced step each reading is kept as an anchor: the harness's
        synchronises there are the trace's, in the same order."""
        now = timers.clock(self.device)
        if self.profiler is not None:
            self.anchors.append(now)
        return now

    @contextlib.contextmanager
    def span(self, name):
        """A named host span, kept in the traced step."""
        if self.profiler is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_spans.append((name, t0, time.perf_counter()))

    def boundary(self):
        """Called where a step's solve is entered; returns the step's index
        (0 is the warm-up) or raises :class:`StopWindow`."""
        k = self.calls
        now = self.clock()
        if self.steps:
            self.steps[-1]["t1"] = now
        if k == 1:
            self.t0 = now
            self.setup_s = now - self.t_process
        if self.profiler is not None:
            self.profiler.stop()
            self.stopped, self.profiler = self.profiler, None
            now = self.clock()
        if k >= 2 and k > self.last_needed and now - self.t0 >= self.seconds:
            self.t1 = now
            raise StopWindow()
        if k == self.traced_step:
            acts = [torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" \
                else [torch.profiler.ProfilerActivity.CPU]
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.start()
            now = self.clock()  # the traced step's first anchor
        if k >= 1:
            self.steps.append({"index": k, "t0": now, "traced": self.tracing})
        self.calls += 1
        return k

    def note(self, k, **values):
        """Attach what step ``k`` reported (iterations, solve seconds, …)."""
        for s in self.steps:
            if s["index"] == k:
                s.update(values)

    def window_steps(self):
        """The whole steps of the window (each with ``t1``)."""
        return [s for s in self.steps if "t1" in s]

    def traced_interval(self):
        """(start, end) of the traced step on the host clock, or ``None``."""
        s = next((s for s in self.steps if s["traced"] and "t1" in s), None)
        return (s["t0"], s["t1"]) if s else None

    def export_trace(self):
        """Write the traced step's Chrome trace (after the window) and
        return its path, or ``None`` when nothing was traced."""
        if self.stopped is None:
            return None
        path = os.path.join(self.trace_dir, "perfbench_trace.json")
        self.stopped.export_chrome_trace(path)
        self.stopped = None
        return path

    def close(self):
        """Stop a profiler the window left running."""
        if self.profiler is not None:
            self.profiler.stop()
            self.profiler = None
