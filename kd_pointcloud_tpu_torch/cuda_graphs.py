"""A call as CUDA graphs: a capture an input signature, a replay a call.

``CallGraphs`` is what eval/graphs.py EvalGraphs (the eval forward) and
train/graphs.py StepGraphs (a train step) share. A call that its subclass's
rule does not engage runs eager. Of a call that it engages:
  * a new signature's first call runs eager on a side stream, so that the
    kernel library, cuBLAS's handle and workspace for that stream and
    whatever else is made lazily exist before a capture;
  * its second is captured on that stream into static inputs, and the
    graph replayed once: that replay answers the call;
  * each later call copies its inputs into the static ones, replays, and
    returns a clone of the static output, so a result a caller keeps is
    never overwritten by a later call;
  * where a tensor the graph reads no longer lies where it lay at capture
    (the subclass's ``where``), the call is captured again;
  * no capture is made while a torch profiler records (that call runs
    eager); a replay under a profiler is.
At most ``max_signatures`` signatures are held, the least recently used
dropped first, each with its static inputs and its graph's private memory
pool. A capture takes the launches it recorded back out of
ops.kernels.LAUNCHES and WIDTH_LAUNCHES, and a replay adds them, so those
still count kernels that ran; ``counts`` (a dict of ops.kernels) counts
captures, calls answered by a replay (a capture's own among them) and
calls run eager.

A subclass gives the rule (``engages``), the ``signature``, ``where``, the
context around the warm-up's call and the capture (``prepared``), its
``counts`` and ``max_signatures``, and the span a replay runs in (``span``,
none by default).
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves, tree_map

from .ops import kernels
from .perf.trace import annotate

_UNSEEN = object()
_NO_CONTEXT = contextlib.nullcontext()


def _static(a: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(a, memory_format=torch.contiguous_format)


class _Graph(NamedTuple):
    """A captured call: the graph, its static inputs (in the call's form
    and as leaves) and output, the launches (kernels.restore_launches'
    pair) a replay runs, and where the tensors it reads lay at capture."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    leaves: list
    output: torch.Tensor
    launches: tuple
    where: tuple


class CallGraphs:
    """fn(*args), answered from CUDA graphs where the subclass's rule
    engages (the module docstring), else eager. args are tensors or dicts
    of tensors."""

    max_signatures: int
    counts: dict
    span: Optional[str] = None

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: OrderedDict = OrderedDict()
        self._streams: dict = {}

    def engages(self, args) -> bool:
        raise NotImplementedError

    def signature(self, args) -> tuple:
        raise NotImplementedError

    def where(self) -> tuple:
        """Where the tensors a graph reads lie now."""
        raise NotImplementedError

    def prepared(self, capture: bool):
        """The context around the warm-up's eager call (capture False) and
        around a capture (True)."""
        return _NO_CONTEXT

    def __call__(self, *args):
        if not self.engages(args):
            return self._eager(args)
        key = self.signature(args)
        graph = self._graphs.get(key, _UNSEEN)
        if graph is _UNSEEN:
            self._graphs[key] = None
            while len(self._graphs) > self.max_signatures:
                self._graphs.popitem(last=False)
            return self._warm_up(args)
        self._graphs.move_to_end(key)
        if graph is None or graph.where != self.where():
            if _autograd_profiler._is_profiler_enabled:
                return self._eager(args)
            self._graphs[key] = None        # the old pool goes first
            graph = self._graphs[key] = self._capture(args)
        return self._replay(graph, args)

    def _stream(self, device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device=device)
        return self._streams[device]

    def _eager(self, args):
        self.counts["eager"] += 1
        return self.fn(*args)

    def _warm_up(self, args):
        """The eager call on the side stream the capture will use."""
        device = tree_leaves(args)[0].device
        side, here = self._stream(device), torch.cuda.current_stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side), self.prepared(False):
            out = self._eager(args)
        here.wait_stream(side)
        out.record_stream(here)     # the caller reads and frees it here
        return out

    def _capture(self, args) -> _Graph:
        static = tree_map(_static, args)
        leaves = tree_leaves(static)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES), dict(kernels.WIDTH_LAUNCHES)
        try:
            with self.prepared(True), torch.cuda.graph(
                    graph, stream=self._stream(leaves[0].device)):
                out = self.fn(*static)
        finally:
            launches = kernels.restore_launches(before)
        self.counts["captures"] += 1
        return _Graph(graph, static, leaves, out, launches, self.where())

    def _replay(self, graph: _Graph, args):
        with annotate(self.span) if self.span else _NO_CONTEXT:
            for static, a in zip(graph.leaves, tree_leaves(args)):
                static.copy_(a)
            graph.graph.replay()
            kernels.add_launches(graph.launches)
            self.counts["replays"] += 1
            return graph.output.clone()
