"""Profiling and tracing of the port: params, operations and latency
(perf.profiling, the counterpart of kd_pointcloud_tpu/utils/profiling.py)
and torch.profiler traces (perf.trace, of kd_pointcloud_tpu/utils/trace.py).
They import torch, so they live outside utils/, whose modules loader
workers import after a fork."""

from .profiling import flop_count, latency, param_count, profile_model
from .trace import annotate, recording, step_annotation, trace

__all__ = ["flop_count", "latency", "param_count", "profile_model",
           "annotate", "recording", "step_annotation", "trace"]
