"""Timers of the benchmark's own, copied from the port's ``chip_smoke.py``
(``timed_calls``, ``events_s``) so that later changes there do not move
the yardstick: CUDA events around the calls a model makes, and the host
clock around work that ends in a synchronise."""

from __future__ import annotations

import time

import torch


class EventSpans:
    """CUDA events recorded on the current stream around calls; ``seconds``
    sums the card's time between each start and end (waiting for the card
    once)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pairs = []

    def start(self):
        if not self.enabled:
            return None
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        return a

    def end(self, a, tag):
        if a is None:
            return
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        self.pairs.append((tag, a, b))

    def seconds(self, keep=lambda tag: True):
        if not self.pairs:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for tag, a, b in self.pairs if keep(tag)) * 1e-3


def clock(device):
    """The host's clock once the card has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
