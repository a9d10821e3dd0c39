"""The port's spans (perf/trace.py annotate) on the CPU: off without a
profiler, on in a recording's active step, and never a change to what the
program computes; the benchmark's span readers (benchmark/spans.py) and
perf.trace's idle_by_span on hand-made traces.

The bit-identity tests run a tiny teacher KD step, a tiny fast KD step
(bifeat -> fg), a tiny fg eval forward and a tiny pointpwc supervised
train step (make_train_step) three times from the same seeded weights,
once with the spans off and once inside perf.trace.recording (spans on),
and compare losses, flows, parameters, BatchNorm statistics and Adam's
moments bit for bit, and the aten ops each run dispatched (the profiler's
own ops left out) one by one.
"""

import json
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness import read_metric
from benchmark.tracing import STRETCH, Stretch
from benchmark.tracing import recording as bench_recording
from kd_pointcloud_tpu_torch.eval import make_eval_forward
from kd_pointcloud_tpu_torch.models import BidPointFlowNet, tiny_config
from kd_pointcloud_tpu_torch.ops import knn
from kd_pointcloud_tpu_torch.perf import (annotate, idle_by_span, recording,
                                          trace)
from kd_pointcloud_tpu_torch.perf.trace import OUTSIDE, SPANS
from kd_pointcloud_tpu_torch.train import (make_distill_step,
                                           make_fast_distill_step,
                                           make_named_loss, make_optimizer)
from kd_pointcloud_tpu_torch.train.loop import make_train_step

torch.set_num_threads(1)

B, N, STEPS = 2, 256, 3
CPU = [ProfilerActivity.CPU]
READERS = ("feature_knn_device_ms.train", "feature_knn_device_ms.eval",
           "host_sync_ms.train", "host_sync_ms.eval")


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _batch(i):
    g = torch.Generator().manual_seed(100 + i)
    pc1 = torch.rand(B, N, 3, generator=g) * 4 - 2
    pc2 = pc1 + 0.1 * torch.randn(B, N, 3, generator=g)
    return dict(pos1=pc1, pos2=pc2, norm1=pc1, norm2=pc2, flow=pc2 - pc1)


def _model(name, seed):
    return BidPointFlowNet(tiny_config(name), device="cpu",
                           generator=torch.Generator().manual_seed(seed))


class _OpLog(TorchDispatchMode):
    """The aten ops dispatched, by name, the profiler's own left out."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not name.startswith("profiler."):
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def _steps(step, model, opt):
    """Three steps: (losses, the model's parameters and buffers, Adam's
    moments)."""
    losses = [step(_batch(i)) for i in range(STEPS)]
    state = [t.detach().clone() for t in model.state_dict().values()]
    moments = [opt.state[p][key].clone() for p in model.parameters()
               for key in ("exp_avg", "exp_avg_sq")]
    return losses, state + moments


def _kd(teacher, student, make_step):
    """Three KD steps from seeded weights: (losses, the student's
    parameters and buffers, Adam's moments)."""
    t_model, s_model = _model(teacher, 1), _model(student, 0)
    opt = make_optimizer(s_model)
    return _steps(make_step(t_model, s_model, opt), s_model, opt)


def _teacher_kd():
    loss = make_named_loss("biDirection_loss_ht",
                           dict(gamma=0.3, beta=0.8, hint_layers=[3]))
    return _kd("teacher", "lighttoken_res",
               lambda t, s, o: make_distill_step(t, s, o, loss_fn=loss))


def _fast_kd():
    return _kd("bifeat", "fg", make_fast_distill_step)


def _fg_eval():
    fwd = make_eval_forward(_model("fg", 0))
    flows = [fwd(*(_batch(i)[k] for k in ("pos1", "pos2", "norm1", "norm2")))
             for i in range(STEPS)]
    return flows, []


def _pwc_train():
    """Three supervised train steps of a tiny pointpwc (make_train_step):
    the train.* phases and the model.cost_volume spans."""
    model = _model("pointpwc", 0)
    opt = make_optimizer(model)
    return _steps(make_train_step(model, opt), model, opt)


RUNS = {"teacher_kd": _teacher_kd, "fast_kd": _fast_kd, "fg_eval": _fg_eval,
        "pwc_train": _pwc_train}


def test_annotate_without_a_profiler_is_the_shared_no_op():
    assert not _profiling()
    off = annotate("kd.teacher")
    assert off is annotate("model.cross")
    with off, off:                          # reusable and reentrant
        pass
    assert not isinstance(off, torch.autograd.profiler.record_function)


def test_spans_follow_the_active_step():
    """A span opened before the recorded step (the profiler warms up)
    leaves no trace; one opened in it is a user_annotation."""
    with profile(activities=CPU, schedule=schedule(wait=0, warmup=1,
                                                   active=1)) as prof:
        assert not _profiling()
        with annotate("before"):
            torch.ones(2).sum()
        prof.step()
        assert _profiling()
        with annotate("inside"):
            torch.ones(2).sum()
    assert not _profiling()
    spans = {e.name for e in prof.events()}
    assert "inside" in spans and "before" not in spans


def _benchmark_recording(monkeypatch):
    """benchmark/tracing.py's recording, its card calls run on the CPU."""
    zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, device=None, **k: zeros(*a, **k))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return bench_recording()


@pytest.mark.parametrize("which", ["perf.trace", "benchmark.tracing"])
def test_recording_turns_the_spans_on_in_its_block(which, monkeypatch):
    assert not _profiling()
    block = (recording(CPU) if which == "perf.trace"
             else _benchmark_recording(monkeypatch))
    with block:
        assert _profiling()
        assert isinstance(annotate("kd.loss"),
                          torch.autograd.profiler.record_function)
    assert not _profiling()


@pytest.mark.parametrize("run", sorted(RUNS))
def test_spans_change_nothing_the_program_computes(run):
    with _OpLog() as log_off:
        out_off, state_off = RUNS[run]()
    with recording(CPU), _OpLog() as log_on:
        assert _profiling()
        out_on, state_on = RUNS[run]()
    assert log_on.ops == log_off.ops
    assert len(out_on) == len(out_off) == STEPS
    assert len(state_on) == len(state_off)
    for a, b in zip(out_on + state_on, out_off + state_off):
        assert torch.equal(a, b)


def test_traced_fast_kd_step_holds_every_span(tmp_path, monkeypatch):
    """One knn_features.sync span a smallest_k call; every span of a KD
    step and of the model; eval.forward in an eval forward; the train.*
    phases and model.cost_volume in a pointpwc train step."""
    calls = []
    plain = knn.smallest_k

    def counted(d, k):
        calls.append(k)
        return plain(d, k)

    monkeypatch.setattr(knn, "smallest_k", counted)
    t_model, s_model = _model("bifeat", 1), _model("fg", 0)
    step = make_fast_distill_step(t_model, s_model, make_optimizer(s_model))
    fwd = make_eval_forward(_model("fg", 2))
    pwc = _model("pointpwc", 3)
    train = make_train_step(pwc, make_optimizer(pwc))
    with trace(str(tmp_path)):
        step(_batch(0))
        fwd(*(_batch(1)[k] for k in ("pos1", "pos2", "norm1", "norm2")))
        train(_batch(2))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert set(SPANS) <= set(names)
    for phase in ("kd.teacher", "kd.student", "kd.loss", "kd.backward",
                  "kd.optimizer", "eval.forward", "train.forward",
                  "train.loss", "train.backward", "train.optimizer"):
        assert names.count(phase) == 1, phase
    assert names.count("model.cost_volume") == 4     # one a level
    # four levels of feature kNN a forward, three forwards
    assert names.count("knn_features") == 12
    assert names.count("knn_features.sync") == len(calls) == 12
    spans = [e for e in events if e.get("name") in SPANS]
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    gaps = idle_by_span(events)     # no device: one gap, the whole trace
    assert len(gaps) == 1
    assert sum(gaps.values()) == pytest.approx((t1 - t0) * 1e-6)


def _stretch(spans=True):
    """A 10 ms stretch (1000-11000 us) serving 2 pairs on host thread 1:
    a knn_features span 2000-4000 holding a sync span 3000-3500, another
    knn_features span 7000-8000. Kernels launched inside the spans on
    thread 1: 300 + 200 + 100 us; one launched in that time from thread 2
    (400 us), one outside the spans (1000 us) and a copy inside them
    (50 us) do not count."""
    ev = [dict(ph="X", cat="user_annotation", name=STRETCH, ts=1000,
               dur=10000, pid=1, tid=1)]
    if spans:
        for name, ts, dur in (("kd.student", 1000, 5000),
                              ("knn_features", 2000, 2000),
                              ("knn_features.sync", 3000, 500),
                              ("knn_features", 7000, 1000)):
            ev.append(dict(ph="X", cat="user_annotation", name=name, ts=ts,
                           dur=dur, pid=1, tid=1))
            ev.append(dict(ph="X", cat="gpu_user_annotation", name=name,
                           ts=ts, dur=dur, pid=0, tid=7))
    for corr, (call, tid, ts, cat, dur) in enumerate((
            ("cudaLaunchKernel", 1, 2100, "kernel", 300),
            ("cuLaunchKernel", 1, 3100, "kernel", 200),
            ("cudaLaunchKernel", 2, 2500, "kernel", 400),
            ("cudaLaunchKernel", 1, 5000, "kernel", 1000),
            ("cudaMemcpyAsync", 1, 3200, "gpu_memcpy", 50),
            ("cudaLaunchKernelExC", 1, 7100, "kernel", 100))):
        ev.append(dict(ph="X", cat="cuda_driver" if call.startswith("cu")
                       and not call.startswith("cuda") else "cuda_runtime",
                       name=call, ts=ts, dur=5, pid=1, tid=tid,
                       args=dict(correlation=corr)))
        ev.append(dict(ph="X", cat=cat, name=f"op{corr}", ts=ts + 500,
                       dur=dur, pid=0, tid=7, args=dict(correlation=corr)))
    return Stretch(ev, 2, {}, rate=1.0)


def test_pwc_train_spans_nest_as_named(tmp_path):
    """In a pointpwc train step the four phases follow one another, and
    each model.cost_volume lies inside a model.cross inside
    train.forward."""
    model = _model("pointpwc", 0)
    step = make_train_step(model, make_optimizer(model))
    with trace(str(tmp_path)):
        step(_batch(0))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]

    def one(name):
        found = [e for e in spans if e["name"] == name]
        assert len(found) == 1, name
        return found[0]

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    phases = [one(f"train.{p}") for p in ("forward", "loss", "backward",
                                           "optimizer")]
    for a, b in zip(phases, phases[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    crosses = [e for e in spans if e["name"] == "model.cross"]
    volumes = [e for e in spans if e["name"] == "model.cost_volume"]
    assert len(volumes) == len(crosses) == 4
    for v in volumes:
        assert inside(v, phases[0])
        assert sum(inside(v, c) for c in crosses) == 1


@pytest.mark.parametrize("name,value", [
    ("feature_knn_device_ms.train", 0.3),
    ("feature_knn_device_ms.eval", 0.3),
    ("host_sync_ms.train", 0.25),
    ("host_sync_ms.eval", 0.25)])
def test_span_readers(name, value):
    assert read_metric(name, _stretch()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_without_spans_read_nothing(name):
    assert read_metric(name, _stretch(spans=False)) is None


def _cost_volume_stretch(spans=True, bound_s=1.5e-4):
    """_stretch with its knn_features spans named model.cost_volume, and
    a cost volume bound of bound_s a pair (None: a cell without one)."""
    s = _stretch(spans)
    for e in s.events:
        if e.get("name") == "knn_features":
            e["name"] = "model.cost_volume"
    kern = {} if bound_s is None else dict(cost_volume=(0, 0, bound_s))
    s.work = dict(flops=0, kernels=kern)
    return s


def test_cost_volume_readers():
    """Device ms a pair inside model.cost_volume (0.3, as the knn_features
    reader reads the same spans), and the bound's share of it: 0.15 ms a
    pair over 0.3 ms."""
    s = _cost_volume_stretch()
    assert read_metric("cost_volume_device_ms.train", s) == pytest.approx(0.3)
    assert read_metric("cost_volume_roofline.train", s) == pytest.approx(50.0)


@pytest.mark.parametrize("spans,bound_s", [(False, 1.5e-4), (True, None)])
def test_cost_volume_readers_without_spans_or_bound_read_nothing(spans,
                                                                   bound_s):
    s = _cost_volume_stretch(spans, bound_s)
    assert read_metric("cost_volume_roofline.train", s) is None
    if not spans:
        assert read_metric("cost_volume_device_ms.train", s) is None


def test_idle_by_span_names_each_gap_by_its_innermost_span():
    """Spans 0-5000 us; device busy 200-600, 1200-1500 (and a copy
    1500-1550), 2000-2500, 2900-5100, 5300-5400: the gaps start in
    kd.teacher (0, 600), model.encode (1550), knn_features.sync (2500)
    and outside every span (5100). The settle kernel over 0 and spans
    of other names are left out."""
    def x(cat, name, ts, dur):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)

    events = [x("user_annotation", "ProfilerStep#1", -1000, 7000),
              x("user_annotation", "kd.teacher", 0, 1000),
              x("user_annotation", "kd.student", 1000, 4000),
              x("user_annotation", "model.encode", 1000, 1000),
              x("user_annotation", "knn_features", 2000, 1000),
              x("user_annotation", "knn_features.sync", 2500, 300),
              x("cpu_op", "aten::mm", 600, 900),
              x("kernel", "spin_kernel", -50, 200),
              x("kernel", "a", 200, 400), x("kernel", "b", 1200, 300),
              x("gpu_memcpy", "Memcpy DtoH", 1500, 50),
              x("kernel", "c", 2000, 500), x("gpu_memset", "Memset", 2900,
                                               2200),
              x("kernel", "d", 5300, 100)]
    got = idle_by_span(events)
    assert list(got) == ["kd.teacher", "model.encode", "knn_features.sync",
                         OUTSIDE]
    assert [round(v * 1e6, 3) for v in got.values()] == [800, 450, 400, 200]
    assert idle_by_span([e for e in events
                         if not re.match(r"^(kd|model|knn)", e["name"])]) \
        == {}
