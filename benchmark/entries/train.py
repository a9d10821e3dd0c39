"""The entry "train": supervised train steps of the program's train/loop.py
make_train_step back to back over the cell's seeded batches, cycled; each
step is the model's forward in train mode, its default loss (the
multi-scale flow loss against the pairs' flow, alpha 0.02 / 0.04 / 0.08 /
0.16), the backward and Adam.

Workload keys: model (a model of the configuration file), batch, points,
batches, check_steps, window_check_steps, trace_calls, scene, limits.

`correct`: the KD entry's training-step numbers (entries/kd.py), at the
start (set-up's check_steps steps from the seeded weights) and at a step
of the window drawn from the seed (window_*), with the reference's
supervised step in place of its KD step: the model entry's reference
network in train mode, reference/train.py multi_scale_loss and Adam.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark import check, program
from benchmark.harness import by_name, free
from benchmark.inputs import batch_of, generator, scene_pairs, seeded_weights
from benchmark.reference.train import multi_scale_loss

kd = by_name("entries", "kd")


def build(cfg: dict, weights: dict, train: dict, device):
    """The system under test: (step, model, optimizer); step(batch) -> loss
    runs one train step, updating model and optimizer in place."""
    from kd_pointcloud_tpu_torch.train.loop import make_train_step

    net = program.model(cfg, weights, device)
    opt = program.optimizer(net, train)
    return make_train_step(net, opt), net, opt


def runs(cell) -> list:
    """(model sizes, with a backward) of the forwards a pair runs."""
    return [(cell.config["models"][cell.workload["model"]], True)]


def supervised_loss(out, t_out, batch):
    """The program's default loss, in the reference: the multi-scale loss
    of the flows through the first cloud's FPS chain (t_out, a KD step's
    teacher output, is None here)."""
    return multi_scale_loss(out["flows"], batch["flow"], out["fps_idx1"])


class NoTeacher(nn.Module):
    """The teacher of the reference's KD step (reference/train.py kd_step)
    where a step has none: its output is None, so that kd_step with
    supervised_loss is the supervised step."""

    def forward(self, *args):
        return None


class Driver(kd.Driver):
    """kd.Driver over one model: its window, readouts and
    traced calls, with make_train_step as the step."""

    def __init__(self, cell, seed: int, device):
        w = cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config["models"][w["model"]]
        self.s_w = seeded_weights(check.meta_model(cfg), seed, "model",
                                  device)
        pairs = scene_pairs(w["scene"], w["batches"] * w["batch"],
                            w["points"], seed, device)
        B = w["batch"]
        self.batches = [batch_of(pairs, list(range(i * B, (i + 1) * B)))
                        for i in range(w["batches"])]
        self.step, self.student, self.opt = build(
            cfg, self.s_w, cell.config["train"], device)
        self.shapes = {n: p.shape for n, p in self.student.named_parameters()}
        self.beta1 = self.opt.param_groups[0]["betas"][0]
        before, losses = self.state(), []
        for i in range(w["check_steps"]):
            losses.append(self.step(self.batches[i]))
            if i == 0:
                before["m_after"] = self.moment()
        self.start = self.readout(before, losses, self.flat_params())
        self.done = w["check_steps"]
        g = generator(seed, "sample", "cpu")
        self.at = 1 + int(torch.randint(w["batches"], (1,), generator=g))
        self.snap = None

    def numbers(self) -> dict:
        ref = Reference(self)
        out = check.step_numbers(self.start, ref.start())
        out.update(check.step_numbers(self.window_prog, ref.window(),
                                      "window_"))
        return out


class Reference(kd.Reference):
    """The KD entry's reference runs (start and window) of the model entry's
    reference network, each step kd_step without a teacher and with
    supervised_loss."""

    def __init__(self, d: Driver):
        self.d, self.train = d, d.cell.config["train"]
        cfg = d.cell.config["models"][d.cell.workload["model"]]
        self.teacher = NoTeacher()
        self.student = check.reference_model(cfg, d.s_w, d.device)
        self.loss_fn = supervised_loss


def readings(cell, seed: int, seconds: float, device,
             controls: bool = True) -> dict:
    """control.py's readings of one seed: the program's numbers after a
    short window; with controls, the reference in TF32 in the program's
    place, and the fault "half": the reference's steps on half of each
    batch's rows (the loss's mean over the rest)."""
    d = Driver(cell, seed, device)
    d.window(seconds)
    d.release()
    free(device)
    ref = Reference(d)
    want = dict(start=ref.start(), window=ref.window())

    def numbers(got):
        out = check.step_numbers(got["start"], want["start"])
        out.update(check.step_numbers(got["window"], want["window"],
                                      "window_"))
        return out

    def step_gaps(got):
        return {k: [abs(a - b) / abs(b) for a, b in
                    zip(got[k]["losses"], want[k]["losses"])]
                for k in want}

    prog = dict(start=d.start, window=d.window_prog)
    out = dict(program=numbers(prog), program_step_loss_gaps=step_gaps(prog))
    if not controls:
        return out
    with check.tf32():
        low = dict(start=ref.start(), window=ref.window())
    out["control"] = numbers(low)
    out["control_step_loss_gaps"] = step_gaps(low)

    def half(batches):
        return [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                for b in batches]

    n = cell.workload["check_steps"]
    out["fault_half"] = numbers(dict(
        start=ref.start(half(d.batches[:n])),
        window=ref.window(half(d.window_batches()))))
    return out
