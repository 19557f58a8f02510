"""A PT solve's chunk of iterations, replayed on the card as CUDA graphs.

The variational solvers keep the fields their iterations carry in static
tensors and update them in place (:meth:`GraphedChunk.iteration`). On the
CPU a chunk runs eagerly. On the card :meth:`GraphedChunk.run_chunk`
captures the chunk once per solve call, after one warm-up iteration on a
side stream whose effect is undone, and replays it for every chunk: the
counterpart of the JAX package's device-resident ``fori_loop``, without one
host launch per operation. A failed capture raises; there is no eager
fallback on the card.

The chunk is captured as a graph of ``GRAPH_BLOCK`` iterations replayed
⌊n / GRAPH_BLOCK⌋ times and a graph of the remaining iterations: capture
costs the host about as much per operation as the eager dispatch, so a
whole chunk's graph (1 999 iterations in the models) would take longer to
capture than the solve takes eagerly.
"""

from __future__ import annotations

import torch

__all__ = ["GRAPH_BLOCK", "GraphedChunk"]

GRAPH_BLOCK = 25  # iterations per captured graph


class GraphedChunk:
    """Subclasses define :meth:`carried` (the static tensors the iteration
    updates) and :meth:`iteration` (one iteration on them, in place)."""

    graphs = None  # the replays of one chunk, in order (captured once)
    graph_iterations = None  # the iterations one chunk runs

    def carried(self):
        raise NotImplementedError

    def iteration(self):
        raise NotImplementedError

    def chunk(self, n):
        """``n`` iterations on the carried fields, eagerly."""
        for _ in range(n):
            self.iteration()

    def _capture_one(self, n):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.chunk(n)
        return graph

    def capture(self, n):
        """Capture the chunk of ``n`` iterations as CUDA graphs (a block of
        ``GRAPH_BLOCK`` iterations and the remainder). Raises if the capture
        fails."""
        saved = [t.clone() for t in self.carried()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.iteration()
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(self.carried(), saved):
            t.copy_(s)
        block = min(n, GRAPH_BLOCK)
        repeats, rest = divmod(n, block)
        graphs = [self._capture_one(block)] * repeats
        if rest:
            graphs.append(self._capture_one(rest))
        self.graphs, self.graph_iterations = graphs, n

    def replay(self):
        """One chunk: the captured graphs' replays."""
        for graph in self.graphs:
            graph.replay()

    def run_chunk(self, n):
        """``n`` iterations: the graphs' replays on the card (captured at the
        first chunk of the call), the eager chunk on the CPU."""
        if n == 0:
            return
        if self.carried()[0].device.type != "cuda":
            self.chunk(n)
            return
        if self.graphs is None:
            self.capture(n)
        if self.graph_iterations != n:
            raise ValueError(f"the graphs run {self.graph_iterations} iterations, not {n}")
        self.replay()
