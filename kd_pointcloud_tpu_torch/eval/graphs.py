"""The eval forward as CUDA graphs: a capture an input signature, a replay
a request.

At batch 1 the card waits on the host: the teacher's eval forward at 8192
points launches about 757 kernels, and a request's wall follows its
launches. A replay of the captured forward is one launch of the same
kernels. ``EvalGraphs`` answers eval/runner.py make_eval_forward's
requests.

When it engages. A request is answered from a graph only where all of
these hold, each observed at the call; else it runs eager, as the module
call it wraps:
  * the model declares its forward free of host syncs (``host_sync_free``:
    BidPointFlowNet's, derived from its layer types, holds for every
    configuration); a model that declares nothing runs eager;
  * the model is not in training mode;
  * the inputs are CUDA tensors;
  * no kernel count is on (ops.kernels.is_counting(), so perf.flop_count
    counts an eager call), no torch dispatch mode is active, and the
    current stream is not itself capturing.
A capture is not made while a torch profiler records (that request runs
eager); a replay under a profiler is.

A signature (the four inputs' shapes and dtypes, and the device) is served
so. Its first request runs eager on a side stream: it builds and loads the
kernel library, fills the kernels' caches and sets their attributes, and
creates cuBLAS's handle and workspace for that stream, so that nothing
lazy happens inside the capture. Its second is captured on the same
stream, into static input buffers, and replayed. Each request from then on
copies its inputs into those buffers, replays, and returns a clone of the
static flow0: a result a caller keeps is never overwritten by a later
request.

Memory. A captured signature holds its static inputs and its graph's
private memory pool, about the forward's peak memory at that shape (0.29
GB for the teacher at batch 1 and 8192 points). At most MAX_SIGNATURES
signatures are held, the least recently used dropped first, so memory
grows with the distinct shapes served up to MAX_SIGNATURES such pools.

Weights. The graph reads the model's parameters and buffers where they
lay at capture, so an update in place (load_state_dict, an optimizer step,
running statistics) shows in the next replay. Each replayed request checks
that every parameter and buffer of the model, as listed when the forward
was made, still lies where it lay at capture (one data_ptr a tensor: about
40 us of host time for the teacher's 250), and captures again where one
moved (.to(), an assignment to .data). A parameter, buffer or module
replaced by a new object (load_state_dict(assign=True), an assignment to
the attribute) is not seen: make a new forward after such a change.

Counters: ops.kernels.EVAL_GRAPHS (perf.eval_graph_counts()) counts
captures, requests answered by a replay (a capture's own among them) and
requests run eager. The cache, the warm-up, the capture and the replay are
cuda_graphs.py CallGraphs', which train/graphs.py StepGraphs shares.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..cuda_graphs import CallGraphs
from ..ops import kernels

MAX_SIGNATURES = 4
_PTR = torch.Tensor.data_ptr


def host_sync_free(model) -> bool:
    """The model's declaration that its forward never waits on the card
    from the host; False for a model that declares nothing."""
    return getattr(model, "host_sync_free", False) is True


def signature(args) -> tuple:
    """The inputs' device, shapes and dtypes."""
    return (args[0].device,) + tuple((tuple(a.shape), a.dtype) for a in args)


def engages(sync_free: bool, model, args) -> bool:
    """Whether a request of model on args may be answered from a graph
    (the module docstring's conditions)."""
    return (sync_free and not model.training
            and all(torch.is_tensor(a) and a.is_cuda for a in args)
            and not kernels.is_counting()
            and torch._C._len_torch_dispatch_stack() == 0
            and not torch.cuda.is_current_stream_capturing())


class EvalGraphs(CallGraphs):
    """forward(*args) -> flow0 of model, answered from CUDA graphs where
    they engage (the module docstring), else eager. Call it inside
    torch.inference_mode()."""

    max_signatures = MAX_SIGNATURES
    counts = kernels.EVAL_GRAPHS

    def __init__(self, model: torch.nn.Module, forward: Callable):
        super().__init__(forward)
        self.model, self.forward = model, forward
        self.sync_free = host_sync_free(model)
        self._state = [*model.parameters(), *model.buffers()]

    def engages(self, args) -> bool:
        return engages(self.sync_free, self.model, args)

    def signature(self, args) -> tuple:
        return signature(args)

    def where(self) -> tuple:
        """Where the model's parameters and buffers lie now."""
        return tuple(map(_PTR, self._state))
