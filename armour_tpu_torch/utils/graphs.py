"""One fixed-shape step of a loop, captured once as a CUDA graph and replayed.

The JAX package compiles its solver iterations and its RK4 rollout into one
XLA program each (`lax.scan`); eager PyTorch would pay the host for every
one of the thousands of small kernels of each step.  ``CapturedStep`` runs
the step's first call op by op on a side stream (the warm-up that capture
needs: library handles, the collision kernels' first launch, lazily cached
index tensors), then captures a second call, which executes nothing, and
replays that capture on every later call.  Warm-up and capture allocate
from one memory pool of the object's own.  The step must keep its state in
tensors that outlive the object, at fixed addresses (it updates them in
place), and must not synchronise with the host; a capture that fails raises.

The launch counters of the collision kernels (`collision/kernels.py`)
count launches that run: a capture adds none, and each replay adds what
the capture recorded.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from armour_tpu_torch.collision import kernels


class CapturedStep:
    """``step()`` on CUDA: the first call runs it and captures it, every
    later call replays the capture.  The class's ``last_capture_ms`` is the
    host time of the latest capture in the process, the graph's
    instantiation included."""

    last_capture_ms = 0.0

    def __init__(self, step: Callable[[], None]):
        self.step = step
        self.pool = None
        self.graph = None
        self.launches = {}

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            for k, n in self.launches.items():
                k.launches += n
            return
        # the warm-up allocates from the pool that the capture then uses, so
        # the capture reuses the warm-up's memory, and the pool goes with
        # this object (a capture in a pool of its own took as much again,
        # and the caching allocator kept each such pool reserved)
        self.pool = torch.cuda.MemPool()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            with torch.cuda.use_mem_pool(self.pool):
                self.step()                  # the real first step, op by op
            t0 = time.perf_counter()
            before = {k: k.launches for k in kernels.KERNELS}
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool.id)
            try:
                self.step()
            finally:
                graph.capture_end()
            self.launches = {k: k.launches - before[k] for k in kernels.KERNELS}
            for k in kernels.KERNELS:
                k.launches = before[k]
            CapturedStep.last_capture_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.current_stream().wait_stream(side)
        self.graph = graph


def stepper(step: Callable[[], None], device: torch.device, eager: bool) -> Callable[[], None]:
    """``step`` itself on the CPU or with ``eager`` (op by op, for holding
    the graph against it on a card); a ``CapturedStep`` on CUDA otherwise."""
    if eager or torch.device(device).type != "cuda":
        return step
    return CapturedStep(step)
