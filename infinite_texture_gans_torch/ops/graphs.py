"""CUDA graphs of the port's hot loops, with the kernel launch counts kept exact.

A CUDA graph is PyTorch's counterpart of a jitted ``lax.scan``: the host
issues a captured sequence of launches with one call instead of one call
per launch. The train loop replays a captured fused step
(``train/train_step.py: StepDispatch``) and the raster engine a captured
canvas row (``sampling/infinite.py: RasterRow``).

The wrappers of ``ops/kernels.py`` and ``ops/ssm.py`` count a launch in
Python when they call their C entry point, and a capture calls each once
while the device runs nothing. :class:`CountedGraph` takes back what the
capture counted and adds it again at every replay, so the counts stay the
launches the device ran, as in an eager run.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, TypeVar

import torch

from infinite_texture_gans_torch.ops import kernels, ssm

T = TypeVar("T")

# every launch counter of the kernel wrappers
_COUNTERS = (kernels.LAUNCHES, kernels.ROUTE_LAUNCHES, ssm.ROUTE_LAUNCHES)


def _snapshot() -> List[dict]:
    return [dict(c) for c in _COUNTERS]


def on_side_stream(fn: Callable[[], T]) -> T:
    """``fn()`` on a side stream that first waits for the current stream,
    which then waits for it: the warm-up PyTorch asks for before a capture
    (the kernel library is built and loaded, and cuDNN's and cuBLAS's
    handles are made, outside any capture)."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream(device=cur.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


class CountedGraph:
    """One ``torch.cuda.CUDAGraph`` and the kernel launches each replay makes."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: List[dict] = []  # per counter: {key: launches per replay}

    def capture(self, fn: Callable[[], T], generators: Iterable[torch.Generator] = ()) -> T:
        """Capture ``fn()`` on the current device (the caller makes it the
        device of ``fn``'s tensors) and return its output, whose tensors
        each replay rewrites in place. ``generators`` (CUDA
        ``torch.Generator`` objects that ``fn`` draws from) are registered
        with the graph, so that each replay draws what an eager call from
        the generator's current state would draw, and advances it as that
        call would. Capture errors raise; nothing falls back to an eager
        run."""
        for g in generators:
            if not hasattr(self.graph, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch cannot register a torch.Generator with a CUDA graph "
                    "(CUDAGraph.register_generator_state); run one step per dispatch")
            self.graph.register_generator_state(g)
        before = _snapshot()
        try:
            # a capture stream of the current device; thread_local: another
            # thread's host calls (the streamed engine's encoder waits on
            # CUDA events) do not break the capture
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(),
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            after = _snapshot()
            for counter, was in zip(_COUNTERS, before):
                counter.update(was)
        self.launches = [{k: a[k] - b[k] for k in a if a[k] != b[k]} for a, b in zip(after, before)]
        return out

    def replay(self) -> None:
        self.graph.replay()
        for counter, per_replay in zip(_COUNTERS, self.launches):
            for k, n in per_replay.items():
                counter[k] += n
