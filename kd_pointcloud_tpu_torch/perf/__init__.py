"""Profiling and tracing of the port: params, operations and latency
(perf.profiling, the counterpart of kd_pointcloud_tpu/utils/profiling.py)
and torch.profiler traces, the program's spans and the graph counters of
the eval forward and the KD steps (perf.trace, of
kd_pointcloud_tpu/utils/trace.py). They
import torch, so they live outside utils/, whose modules loader workers
import after a fork. The model and
ops/ open spans (perf.trace annotate), so perf.profiling, which imports
them, is imported on first use."""

from .trace import (annotate, eval_graph_counts, idle_by_span, recording,
                    trace, train_graph_counts)

_PROFILING = ("flop_count", "latency", "param_count", "profile_model")

__all__ = [*_PROFILING, "annotate", "eval_graph_counts", "idle_by_span",
           "recording", "trace", "train_graph_counts"]


def __getattr__(name: str):
    if name in _PROFILING:
        from . import profiling
        return getattr(profiling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
