"""A whole train step as CUDA graphs: a capture a batch signature, a replay
a step.

An eager KD step at batch 8 launches about 3,300 kernels (the frozen
teacher's forward, the student's forward, autograd's backward, Adam), and
the card waits on the host between many of them. A replay of the captured
step is one launch of the same kernels. ``StepGraphs`` wraps a step body
(train/distill.py make_distill_step's, which make_fast_distill_step
shares); any step of the same form can adopt it: a body that takes a dict
of tensors, zeroes its optimizers' gradients (set_to_none) before its
backward, steps its optimizers, and returns the loss detached.

When it engages. A step is replayed from a graph only where all of these
hold, each observed at the call; else the body runs eager, unchanged:
  * every tensor of the batch is a CUDA tensor;
  * the step holds no collective: its mesh is None, or of one rank with no
    process group (parallel.sync_grads then does nothing);
  * no kernel count is on (ops.kernels.is_counting()), no torch dispatch
    mode is active, and the current stream is not itself capturing;
  * every optimizer is a torch.optim.Adam.
A capture is not made while a torch profiler records (that step runs
eager); a replay under a profiler is.

A signature is the batch's keys, shapes and dtypes, its device, and every
optimizer param group's lr, betas, eps and weight_decay, which the graph
holds as constants: a new learning rate (set_learning_rate, once an epoch)
is a new signature. Its first step runs eager on a side stream: it builds
and loads the kernel library, creates cuBLAS's handle and workspace for
that stream and autograd's device thread, and Adam's state, so that
nothing lazy happens inside the capture; it is a real step. Its second
sets the gradients to None, is captured on the same stream into static
batch buffers (the step's gradients become the graph's), and is replayed
once: that replay is the step. Each step from then on copies the batch
into those buffers, replays, and returns a clone of the static loss: a
loss a caller keeps is never overwritten by a later step. A replay, with
its copies, runs inside the span kd.step.

Adam. Around the warm-up's step and around a capture, and only there, each
engaged optimizer's param groups are set capturable (Adam's bias
correction on the card, from a step count on the card); each group's own
setting is put back after, so an eager step, a state_dict and a checkpoint
see the optimizer as it was made. Any step count Adam holds moves to its
parameter's device, and stays there: an eager Adam reads it back to the
host, the same number. The update is the same float32 Adam; a replay's
bias correction differs from the host's scalar one by float32 rounding.
train/state.py make_optimizer is unchanged.

What forces a new capture. The graph reads and writes tensors where they
lay at capture. Each replayed step checks, one data_ptr a tensor, that
these still lie there: every parameter and buffer of the modules, as
listed when the step was made; each optimized parameter's .grad; Adam's
step, exp_avg, exp_avg_sq (and max_exp_avg_sq) of each parameter. Where
one moved (an optimizer's load_state_dict on resume, .to(), an
assignment to .data, an eager step between replays, which sets the
gradients anew) the step is captured again. A parameter, buffer or module
replaced by a new object (load_state_dict(assign=True), an assignment to
the attribute) is not seen: make a new step after such a change.

Memory. A captured signature holds its static batch and its graph's
private memory pool, about the step's peak memory at that shape (5.9 GB
for the teacher -> lighttoken_res KD step at batch 8 and 8192 points). At
most MAX_SIGNATURES signatures are held, the least recently used dropped
first.

Counters: ops.kernels.TRAIN_GRAPHS (perf.train_graph_counts()) counts
captures, steps answered by a replay (a capture's own among them) and
steps run eager. The cache, the warm-up, the capture and the replay are
cuda_graphs.py CallGraphs', which eval/graphs.py EvalGraphs shares.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, Sequence

import torch

from ..cuda_graphs import CallGraphs
from ..ops import kernels

MAX_SIGNATURES = 2
HYPERPARAMETERS = ("lr", "betas", "eps", "weight_decay")
ADAM_STATE = ("step", "exp_avg", "exp_avg_sq", "max_exp_avg_sq")
_NO_STATE: dict = {}
_UNCAPTURED = "This instance was constructed with capturable=True"


def signature(batch: Dict[str, torch.Tensor], optimizers) -> tuple:
    """The batch's device, keys, shapes and dtypes, and each optimizer
    param group's HYPERPARAMETERS."""
    first = next(iter(batch.values()))
    return ((first.device,)
            + tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())
            + tuple(tuple(g[h] for h in HYPERPARAMETERS)
                    for opt in optimizers for g in opt.param_groups))


def engages(batch: Dict[str, torch.Tensor], mesh, optimizers) -> bool:
    """Whether a step on batch may be replayed from a graph (the module
    docstring's conditions)."""
    return (len(batch) > 0
            and all(torch.is_tensor(v) and v.is_cuda for v in batch.values())
            and (mesh is None or (mesh.size == 1 and mesh.group is None))
            and all(isinstance(o, torch.optim.Adam) for o in optimizers)
            and not kernels.is_counting()
            and torch._C._len_torch_dispatch_stack() == 0
            and not torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def capturable(optimizers):
    """Every param group capturable inside, each group's own setting back
    after; each step count Adam holds moved to its parameter's device (and
    left there)."""
    own = [(group, group.get("capturable", False))
           for opt in optimizers for group in opt.param_groups]
    for opt in optimizers:
        for group in opt.param_groups:
            group["capturable"] = True
            for p in group["params"]:
                state = opt.state.get(p, _NO_STATE)
                step = state.get("step")
                if step is not None and not (torch.is_tensor(step)
                                             and step.device == p.device):
                    state["step"] = torch.as_tensor(
                        step, dtype=torch.float32, device=p.device)
    try:
        yield
    finally:
        for group, value in own:
            group["capturable"] = value


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


class StepGraphs(CallGraphs):
    """step(batch) -> loss of body, replayed from CUDA graphs where they
    engage (the module docstring), else eager. modules are every module
    whose parameters and buffers the body reads (a KD step's teacher and
    student); optimizers are the body's; mesh is the body's data mesh."""

    max_signatures = MAX_SIGNATURES
    counts = kernels.TRAIN_GRAPHS
    span = "kd.step"

    def __init__(self, body: Callable, modules: Sequence[torch.nn.Module],
                 optimizers: Sequence[torch.optim.Optimizer], mesh=None):
        super().__init__(body)
        self.body, self.optimizers, self.mesh = body, tuple(optimizers), mesh
        self._state = [t for m in modules
                       for t in (*m.parameters(), *m.buffers())]

    def engages(self, args) -> bool:
        return engages(args[0], self.mesh, self.optimizers)

    def signature(self, args) -> tuple:
        return signature(args[0], self.optimizers)

    def where(self) -> tuple:
        """Where the tensors a graph reads lie now (the module docstring's
        list)."""
        ptrs = [t.data_ptr() for t in self._state]
        for opt in self.optimizers:
            for group in opt.param_groups:
                for p in group["params"]:
                    state = opt.state.get(p, _NO_STATE)
                    ptrs.append(_ptr(p.grad))
                    ptrs.extend(_ptr(state.get(k)) for k in ADAM_STATE)
        return tuple(ptrs)

    @contextlib.contextmanager
    def prepared(self, capture: bool):
        """Adam capturable (its warning of a capturable step run eager
        silenced); before a capture the gradients set to None, so that the
        step's gradients become the graph's."""
        with capturable(self.optimizers), warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_UNCAPTURED)
            if capture:
                for opt in self.optimizers:
                    opt.zero_grad(set_to_none=True)
            yield
