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

The launch counters of the kernel wrappers in ``COUNTED`` (the collision
kernels of `collision/kernels.py`, and the rollout kernel, which
`sim/rollout_kernel.py` adds) count launches that run: a capture adds none,
and each replay adds what the capture recorded.

``ProgramCache`` keeps a few programs (objects that own such captures) by
shape key, least recently used first out, and frees an evicted program's
graphs and memory pools.  A program may read the outputs of another (its
``parent``): evicting the parent evicts it too.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Hashable

import torch

from armour_tpu_torch.collision import kernels


_SIDE: dict = {}

# the kernel wrappers whose ``launches`` counter a replay adds to
COUNTED = list(kernels.KERNELS)


def _side_stream() -> torch.cuda.Stream:
    """The one side stream of the current device on which every capture
    warms up and records.  cuBLAS keeps a workspace (32 MiB) per stream for
    the life of the process, made at the stream's first product: a new
    stream per capture kept one more each time, inside the capture's own
    memory pool (two per battery iteration: the solve's and the move's).
    The workspace of this stream is made once, outside any pool."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for dt in (torch.float32, torch.float64):
                x = torch.ones((2, 2), dtype=dt, device="cuda")
                torch.matmul(x, x)
        side.synchronize()
        _SIDE[dev] = side
    return _SIDE[dev]


class CapturedStep:
    """``step()`` on CUDA: the first call runs it and captures it, every
    later call replays the capture.  ``capture_ms`` is the host time of the
    capture, the graph's instantiation included, and the class's
    ``last_capture_ms`` that of the latest capture in the process."""

    last_capture_ms = 0.0

    def __init__(self, step: Callable[[], None]):
        self.step = step
        self.pool = None
        self.graph = None
        self.launches = {}
        self.capture_ms = 0.0

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
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            with torch.cuda.use_mem_pool(self.pool):
                self.step()                  # the real first step, op by op
            t0 = time.perf_counter()
            before = {k: k.launches for k in COUNTED}
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool.id)
            try:
                self.step()
                graph.capture_end()
            except BaseException:
                _end_failed_capture(graph, self.pool)
                raise
            finally:
                captured = {k: k.launches - before[k] for k in COUNTED}
                for k in COUNTED:
                    k.launches = before[k]
            self.launches = captured
            self.capture_ms = CapturedStep.last_capture_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.current_stream().wait_stream(side)
        self.graph = graph

    def release(self):
        """Drop the graph, the memory pool and the step (with what its
        closure holds), with no wait for the device: a graph destroyed while
        a replay runs is freed when the replay ends, and the caching
        allocator frees a released pool's memory only after a device
        synchronise.  The caller drops every tensor that the step made."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.pool = self.step = None


def _end_failed_capture(graph: torch.cuda.CUDAGraph, pool: torch.cuda.MemPool):
    """Leave a capture that failed (the caller re-raises its error): end
    the stream's capture if it still runs, and stop the caching allocator
    routing the side stream's allocations to the capture's pool, which
    ``capture_end`` leaves undone when the capture was invalidated (a later
    release of another graph's pool then aborted the process)."""
    if torch.cuda.is_current_stream_capturing():
        try:
            graph.capture_end()
            return            # a capture still valid ends whole, the routing with it
        except RuntimeError:
            pass              # an invalidated one stops capturing, and raises before the routing
    try:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), pool.id)
    except RuntimeError as err:
        # ``capture_end`` itself failed after it had ended the routing
        if "not currently recording" not in str(err):
            raise


def stepper(step: Callable[[], None], device: torch.device, eager: bool) -> Callable[[], None]:
    """``step`` itself on the CPU or with ``eager`` (op by op, for holding
    the graph against it on a card); a ``CapturedStep`` on CUDA otherwise."""
    if eager or torch.device(device).type != "cuda":
        return step
    return CapturedStep(step)


def release(step: Callable[[], None]):
    """Release what ``stepper`` returned once its loop is done.  A loop's
    capture is not left to the garbage collector: the step outlived its
    loop in reference cycles (the loop's own frame among its referrers),
    and with it the loop's state and inputs, until a full collection; a
    battery of 100 worlds on an H100 (80 GB) held about 1 GB more per
    iteration that way and ran out of memory after 60 iterations."""
    if isinstance(step, CapturedStep):
        step.release()


def keep_into(kept, value):
    """``value`` (a tensor, or a tuple or dataclass of them) in the
    buffers ``kept``: a clone when ``kept`` is None (the step's first, op-by-op
    run makes the buffers), else copied into them in place (what a capture
    records).  Returns the buffers."""
    if kept is None:
        return tree_map(torch.clone, value)
    tree_map(torch.Tensor.copy_, kept, value)
    return kept


class KeptFunction:
    """``fn(*args)`` of fixed-shape tensors (tuples and NamedTuples of them,
    or None) kept as one step, a CUDA graph on a card: a call copies its
    arguments into input buffers at fixed addresses (made by the first
    call), runs the step and returns the outputs in buffers that the next
    call overwrites.  A program of a ``ProgramCache``."""

    def __init__(self, fn: Callable, device: torch.device):
        self.inputs = self.out = None

        def step():
            self.out = keep_into(self.out, fn(*self.inputs))

        self.step = stepper(step, device, eager=False)

    @property
    def steps(self) -> list:
        return [] if self.step is None else [self.step]

    def __call__(self, *args):
        self.inputs = keep_into(self.inputs, args)
        self.step()
        return self.out

    def release(self):
        release(self.step)
        self.step = self.inputs = self.out = None


def tree_map(fn, *trees):
    """``fn`` over the tensors of matching tuples (NamedTuples too) and
    dataclasses, the rest of the first tree kept as it is."""
    x = trees[0]
    if isinstance(x, torch.Tensor):
        return fn(*trees)
    if isinstance(x, tuple):
        fields = [tree_map(fn, *f) for f in zip(*trees)]
        return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                                         for f in dataclasses.fields(x)})
    return x


class ProgramCache:
    """At most ``capacity`` programs by key (a tuple), the least recently
    used evicted first (its ``release()`` is called).  A program is a
    callable with a ``release()``, a list ``steps`` of the ``CapturedStep``
    objects it owns and, optionally, a ``parent``: a program of the same
    cache whose outputs it reads at fixed addresses, evicted with it.  The
    owner of the cache is held weakly by its programs, so that dropping it
    releases them (``__del__``).
    Counts hits, misses, evictions and the graphs captured, and keeps the
    capture ms of the latest miss (the sum over its steps)."""

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self.entries: OrderedDict = OrderedDict()
        self.hits = self.misses = self.evictions = self.captures = 0
        self.last_capture_ms = 0.0

    def run(self, key: Hashable, make: Callable, *args, **kwargs):
        """The program of ``key`` (made by ``make()`` on a miss) called on
        ``args`` and ``kwargs``."""
        prog = self.entries.get(key)
        if prog is not None:
            self.entries.move_to_end(key)
            self.hits += 1
            return prog(*args, **kwargs)
        self.misses += 1
        prog = self.entries[key] = make()
        spare = (prog, getattr(prog, "parent", None))
        while len(self.entries) > self.capacity:
            old = next((k for k, p in self.entries.items() if p not in spare), None)
            if old is None:
                break
            self._evict(old)
        try:
            out = prog(*args, **kwargs)
        except BaseException:
            del self.entries[key]       # a program whose capture failed is not kept
            prog.release()
            raise
        done = [s for s in prog.steps if isinstance(s, CapturedStep) and s.graph is not None]
        self.captures += len(done)
        self.last_capture_ms = sum(s.capture_ms for s in done)
        return out

    def _evict(self, key):
        prog = self.entries.pop(key)
        self.evictions += 1
        for k in [k for k, p in self.entries.items() if getattr(p, "parent", None) is prog]:
            self._evict(k)
        prog.release()

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "captures": self.captures,
                "evictions": self.evictions, "entries": len(self.entries),
                "last_capture_ms": self.last_capture_ms}

    def clear(self):
        """Release every program."""
        while self.entries:
            self.entries.popitem(last=False)[1].release()

    def __del__(self):
        # a program and its steps reference each other (the steps' closures
        # read the program's buffers), so a cache dropped with its owner
        # releases them here rather than leaving their graphs and memory
        # pools to a full garbage collection
        self.clear()
