"""A block of eager kernels replayed as one CUDA graph (the form of
ops/traverse.py's march block and of the bench's loops; the transport's
propagate.PoolRun captures its march block the same way).

The host issues an eager block's kernels one by one, and on a card it
issues them more slowly than the card runs them; a captured graph is
issued once. The replay runs the same kernels in the same order on the
same values, so its results are the eager block's bit for bit.
"""

import torch

from . import trace


class GraphedBlock:
    """fn(*tensors) -> a tuple of tensors, run as one CUDA graph when
    ``device`` is a card.

    The first call runs fn eagerly (warming its kernels up), the second
    captures it on a side stream and every call from then on replays the
    capture, the arguments copied into the graph's own inputs first (they
    keep their shapes and dtypes). The outputs are then the graph's
    buffers: valid until the next call. fn must not copy from the host or
    wait on the device (no .item(), nonzero or boolean mask index); what
    it reaches other than its arguments (a table it reads, a tally it
    adds to in place) is captured as it is. Off a card every call runs
    fn. The capture and its instantiation are the span
    `transport.capture` (utils/trace.py), attr ``kind``: the caller's
    block ("pool", "path")."""

    def __init__(self, fn, device, kind="block"):
        self.fn = fn
        self.kind = kind
        self.graphed = torch.device(device).type == "cuda"
        self.calls = 0
        self.graph = None

    def __call__(self, *args):
        self.calls += 1
        if not self.graphed or self.calls == 1:
            return tuple(self.fn(*args))
        if self.graph is None:
            with trace.span("transport.capture", kind=self.kind):
                self._capture(args)
        for dst, src in zip(self.g_in, args):
            dst.copy_(src)
        self.graph.replay()
        return self.g_out

    def _capture(self, args):
        self.g_in = [a.clone() for a in args]
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                out = tuple(self.fn(*self.g_in))
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self.graph, self.g_out = graph, out
