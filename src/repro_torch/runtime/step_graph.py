"""One dispatch a step: a model step replayed as a CUDA graph (the
port's counterpart of the JAX package's ``_jit_prefill`` /
``_jit_decode`` in ``runtime/engine.py``, which run a whole tick --
the step, the greedy argmax and the finite flag -- as one compiled
call).

A :class:`StepGraph` owns, for one step function at one shape key:

- its inputs: int32 buffers on the device, packed into one allocation
  made outside any capture, with a pinned host twin, so that a tick's
  host inputs (tokens, mask or start, lengths, block table) cross in
  ONE non-blocking host-to-device copy;
- the captured graph of the step, whose outputs stay where the capture
  put them (every replay writes the same addresses).

The first step at a key runs eagerly: it builds and loads every kernel
the step launches (and sets their one-time attributes), so the capture
that follows makes no call but launches.  :meth:`StepGraph.capture` then
records the step, and every later :meth:`StepGraph.step` replays it.
On the CPU, or with graphs off, every step runs eagerly on the same
buffers.  A capture or replay that fails raises; nothing falls back to
the eager step.

Launch counts hold under replay: the wrapper calls a capture makes go to
its own record (``_build.recording_launches``), and each replay adds
that record (``_build.add_launches``).
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _build

ALIGN = 4       # int32 elements: each input starts on a 16-byte boundary


class StepGraph:
    """A step ``fn(inputs) -> output`` (``inputs``: name -> int32 device
    view of the shapes given) at one shape key.

    Fill :attr:`host` (name -> numpy view of the pinned buffer), then
    :meth:`step` (or :meth:`run`, which also brings the output to the
    host).  With ``graphs`` on a CUDA device, call :meth:`capture` after
    the first step; later steps replay.  The step function is passed to
    each call, not held: an owner whose bound method it is stays free of
    a reference cycle, so its device memory goes when it does.  ``pool``
    is a graph memory pool (``torch.cuda.graph_pool_handle()``) that
    graphs may share when each replay's output is consumed before
    another graph of the pool replays."""

    def __init__(self, inputs: dict[str, tuple[int, ...]], device, *,
                 graphs: bool = True, pool=None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        sizes = {name: math.prod(shape) for name, shape in inputs.items()}
        total = sum(-(-n // ALIGN) * ALIGN for n in sizes.values())
        self._host = torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
        self._dev = torch.zeros(total, dtype=torch.int32, device=self.device)
        flat = self._host.numpy()
        self.host: dict[str, np.ndarray] = {}
        self.inputs: dict[str, torch.Tensor] = {}
        off = 0
        for name, shape in inputs.items():
            n = sizes[name]
            self.host[name] = flat[off:off + n].reshape(shape)
            self.inputs[name] = self._dev[off:off + n].view(shape)
            off += -(-n // ALIGN) * ALIGN
        self.graphs = bool(graphs) and cuda
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.launches: dict[str, int] = {}   # the capture's record
        self.capture_s = 0.0
        self.replays = 0

    def step(self, fn: Callable):
        """Send the host inputs over (one copy), then run the step:
        a replay once captured, else ``fn`` eagerly.  Returns its output
        (on the device; a replay's is the captured output, rewritten)."""
        if self._dev.numel():
            self._dev.copy_(self._host, non_blocking=True)
        if self.graph is None:
            return fn(self.inputs)
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.out

    def run(self, fn: Callable) -> np.ndarray:
        """:meth:`step`, then its output to the host: the step's only
        wait."""
        return self.step(fn).cpu().numpy()

    def capture(self, fn: Callable) -> None:
        """Capture the step ``fn`` into a CUDA graph, once; a no-op on
        the CPU, with graphs off, or when already captured.  Call it
        after an eager step at this key.  Nothing runs: the capture
        records the kernels and their launch counts."""
        if not self.graphs or self.graph is not None:
            return
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as record:
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn(self.inputs)
        self.graph, self.out, self.launches = graph, out, record
        self.capture_s = time.perf_counter() - t0


__all__ = ["StepGraph"]
