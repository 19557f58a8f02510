"""Reading the traced step: the profiler's Chrome trace reduced to the
device's activity and its kernels, and the harness's host spans put on the
trace's clock."""

from __future__ import annotations

import json
import os
import re
import statistics
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC = "DeviceSynchronize"
MATCH_US = 20e3  # an anchor this far from the others' median is not paired right


def clock_offset(sync_ends, anchors):
    """Microseconds to add to a host time (seconds × 1e6) to put it on the
    trace's clock. The k-th anchor is the host clock read just after the
    k-th synchronise of the trace returned, so it is late by whatever held
    the host up in between (the first after the profiler starts, by some
    milliseconds), never early: the largest offset is the truest. Pairs far
    from the median are left out."""
    offs = [s - a * 1e6 for s, a in zip(sync_ends, anchors)]
    med = statistics.median(offs)
    return max(o for o in offs if abs(o - med) <= MATCH_US)


class Trace:
    """Device intervals and harness spans, in microseconds on the
    profiler's one clock.

    ``spans`` are the harness's (name, start, end) and ``interval`` the
    traced step's (start, end), in seconds on the host clock; ``anchors``
    the host clock after each of the harness's synchronises in the step,
    in order (by default the one that opens it), which are the trace's
    ``cudaDeviceSynchronize`` calls, in the same order. Without a
    synchronise the step is the device's extent and the spans are left
    out."""

    def __init__(self, events, spans=(), interval=None, anchors=None):
        self.device = []  # (start, end, name)
        syncs = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            name = e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name))
            elif cat in LAUNCH_CATS and SYNC in name:
                syncs.append(ts + dur)
        self.device.sort()
        syncs.sort()
        self.spans = []  # (start, end, name) of the harness
        if syncs and interval is not None:
            off = clock_offset(syncs, anchors or [interval[0]])
            self.lo, self.hi = interval[0] * 1e6 + off, interval[1] * 1e6 + off
            self.spans = sorted((a * 1e6 + off, b * 1e6 + off, n) for n, a, b in spans)
        elif self.device:
            self.lo, self.hi = self.device[0][0], max(d[1] for d in self.device)
        else:
            self.lo = self.hi = 0.0

    @classmethod
    def load(cls, path, spans=(), interval=None, anchors=None, remove=True):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if remove:
            os.remove(path)
        return cls(events, spans, interval, anchors)

    def window_s(self):
        return (self.hi - self.lo) * 1e-6

    def busy_intervals(self):
        """The union of device activity inside the traced step."""
        out = []
        for a, b, _ in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self, pattern):
        """Device kernels inside the traced step whose name matches the
        regular expression ``pattern``: (start, end, name)."""
        rx = re.compile(pattern)
        return [(a, b, name) for a, b, name in self.device
                if rx.search(name) and a >= self.lo and b <= self.hi]

    def host_span_at(self, t):
        """The innermost harness span that holds host time ``t``; ``step``
        for the rest of the traced step."""
        best = None
        for a, b, name in self.spans:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "step"

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time
        grouped by the harness span the host was in when each gap began,
        seconds."""
        by_op = defaultdict(float)
        for a, b, name in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                by_op[_short(name)] += (b - a) * 1e-6
        gaps = defaultdict(float)
        prev = self.lo
        for a, b in self.busy_intervals() + [[self.hi, self.hi]]:
            if a > prev:
                gaps[self.host_span_at(prev)] += (a - prev) * 1e-6
            prev = max(prev, b)
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


def _short(name, width=96):
    """A kernel's name without ``void``, namespaces' parentheses and its
    argument list, at most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:width]
