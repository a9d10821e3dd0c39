"""The entry "kd": knowledge-distillation steps back to back over the cell's
seeded batches, cycled; each step is the frozen teacher's forward, the
student's forward and backward, and Adam. The step is the program's
steps/<step>.py build; the reference's loss is reference/losses/<loss>.py.

Workload keys: step, loss (and the loss's own keys: gamma, beta,
hint_layers), teacher and student (models of the configuration file),
batch, points, batches, check_steps, window_check_steps, trace_calls,
limits.

`correct` (check.py's training-step numbers, twice):

* the start: set-up drives the one step object from the seeded weights
  through its first check_steps steps, through the window's own call, on
  distinct batches; the reference repeats them from the same weights;
* the window: at a step of the window drawn from the seed (one of its
  steps 1..batches), the student's parameters and Adam's state are taken
  before the step, Adam's first moment after it and the parameters after
  window_check_steps steps; the reference runs the same steps on the same
  batches from that state (the program's own state: the start above
  checks the way there). Its numbers carry the prefix "window_".
"""

from __future__ import annotations

import time

import torch

from benchmark import check, program
from benchmark.harness import by_name, free, sync
from benchmark.inputs import batch_of, generator, scene_pairs, seeded_weights
from benchmark.reference.train import Adam, kd_step


def build(workload: dict, models: dict, t_w: dict, s_w: dict, train: dict,
          device):
    """The system under test: (step, student, optimizer); step(batch) ->
    loss runs one KD step, updating student and optimizer in place."""
    teacher = program.model(models[workload["teacher"]], t_w, device)
    student = program.model(models[workload["student"]], s_w, device)
    opt = program.optimizer(student, train)
    step = by_name("steps", workload["step"]).build(teacher, student, opt,
                                                    workload)
    return step, student, opt


def runs(cell) -> list:
    """(model sizes, with a backward) of the forwards a pair runs."""
    w, models = cell.workload, cell.config["models"]
    return [(models[w["teacher"]], False), (models[w["student"]], True)]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, shapes: dict) -> dict:
    out, at = {}, 0
    for name, shape in shapes.items():
        n = shape.numel()
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


class Driver:
    def __init__(self, cell, seed: int, device):
        w = cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        models, train = cell.config["models"], cell.config["train"]
        self.t_w = seeded_weights(check.meta_model(models[w["teacher"]]),
                                  seed, "teacher", device)
        self.s_w = seeded_weights(check.meta_model(models[w["student"]]),
                                  seed, "student", device)
        pairs = scene_pairs(w["scene"], w["batches"] * w["batch"],
                            w["points"], seed, device)
        B = w["batch"]
        self.batches = [batch_of(pairs, list(range(i * B, (i + 1) * B)))
                        for i in range(w["batches"])]
        self.step, self.student, self.opt = build(
            w, models, self.t_w, self.s_w, train, device)
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

    # what the check reads of the program's state, kept on the device
    def flat_params(self) -> torch.Tensor:
        return _flat(self.student.parameters())

    def moment(self) -> torch.Tensor:
        return _flat(program.adam_moments(self.student, self.opt, "exp_avg"))

    def state(self) -> dict:
        return dict(params=self.flat_params(), m=self.moment(),
                    v=_flat(program.adam_moments(self.student, self.opt,
                                                 "exp_avg_sq")),
                    t=program.adam_steps(self.student, self.opt))

    def readout(self, before: dict, losses: list, after) -> dict:
        """The program's numbers of a checked run of steps from before to
        after: losses, the first step's gradient as Adam took it ((m1 -
        beta1 m0) / (1 - beta1)) and each parameter's change, by name, as
        norms."""
        grad = (before["m_after"] - self.beta1 * before["m"]) \
            / (1 - self.beta1)
        return dict(losses=[float(x) for x in losses],
                    grad=check.norms(_unflat(grad, self.shapes)),
                    change=check.norms(_unflat(after - before["params"],
                                               self.shapes)))

    def window(self, seconds: float) -> dict:
        w = self.cell.workload
        n = w["window_check_steps"]
        losses, after = [], None
        t0 = time.perf_counter()
        steps = 0
        while steps < self.at + n or time.perf_counter() < t0 + seconds:
            if steps == self.at:
                self.snap = self.state()
            loss = self.step(self.batches[(self.done + steps)
                                          % len(self.batches)])
            if self.at <= steps < self.at + n:
                losses.append(loss)
                if steps == self.at:
                    self.snap["m_after"] = self.moment()
                if steps == self.at + n - 1:
                    after = self.flat_params()
            steps += 1
        sync(self.device)
        t1 = time.perf_counter()
        self.window_prog = self.readout(self.snap, losses, after)
        self.snap["batch"] = self.done + self.at
        self.done += steps
        return dict(attempted=steps, pairs=steps * w["batch"],
                    seconds=t1 - t0,
                    metrics=dict(train_pairs_per_s=steps * w["batch"]
                                 / (t1 - t0)))

    def traced(self, i: int) -> None:
        self.step(self.batches[(self.done + i) % len(self.batches)])

    def pairs_of(self, calls: int) -> int:
        return calls * self.cell.workload["batch"]

    def release(self) -> None:
        del self.step, self.student, self.opt

    def window_batches(self) -> list:
        n = self.cell.workload["window_check_steps"]
        return [self.batches[(self.snap["batch"] + i) % len(self.batches)]
                for i in range(n)]

    def numbers(self) -> dict:
        ref = Reference(self)
        out = check.step_numbers(self.start, ref.start())
        out.update(check.step_numbers(self.window_prog, ref.window(),
                                      "window_"))
        return out


class Reference:
    """The reference's runs of a driver's checked steps: start() from the
    seeded weights, window(batches) from the program's state at the
    window's checked step; each (losses, grad, change) as the program's
    readout gives them."""

    def __init__(self, d: Driver):
        w, models = d.cell.workload, d.cell.config["models"]
        self.d, self.train = d, d.cell.config["train"]
        self.teacher = check.reference_model(models[w["teacher"]], d.t_w,
                                             d.device)
        self.student = check.reference_model(models[w["student"]], d.s_w,
                                             d.device)
        self.loss_fn = by_name("reference/losses", w["loss"]).loss(w)

    def run(self, params: dict, adam, batches: list) -> dict:
        """The reference's steps over batches from params (by name) and
        Adam's (m, v, t) (None: a fresh Adam)."""
        d = self.d
        state = {**d.s_w, **params}
        self.student.load_state_dict(state, strict=True)
        opt = Adam(self.student.parameters(), self.train["learning_rate"],
                   self.train["weight_decay"])
        if adam is not None:
            m, v, t = adam
            opt.m = [x.clone() for x in _unflat(m, d.shapes).values()]
            opt.v = [x.clone() for x in _unflat(v, d.shapes).values()]
            opt.t = t
        m0 = [x.clone() for x in opt.m]
        losses, grad = [], None
        b1 = opt.betas[0]
        for i, batch in enumerate(batches):
            losses.append(float(kd_step(self.teacher, self.student, opt,
                                        self.loss_fn, batch)))
            if i == 0:
                grad = {n: (m1 - b1 * m) / (1 - b1) for n, m, m1 in
                        zip(d.shapes, m0, opt.m)}
        change = {n: p.detach() - params[n]
                  for n, p in self.student.named_parameters()}
        return dict(losses=losses, grad=check.norms(grad),
                    change=check.norms(change))

    def start(self, batches=None) -> dict:
        d = self.d
        n = d.cell.workload["check_steps"]
        return self.run({k: d.s_w[k] for k in d.shapes}, None,
                        batches if batches is not None else d.batches[:n])

    def window(self, batches=None) -> dict:
        s = self.d.snap
        return self.run(_unflat(s["params"], self.d.shapes),
                        (s["m"], s["v"], int(float(s["t"]))),
                        batches if batches is not None
                        else self.d.window_batches())


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
    prog = dict(start=d.start, window=d.window_prog)

    def numbers(got):
        out = check.step_numbers(got["start"], want["start"])
        out.update(check.step_numbers(got["window"], want["window"],
                                      "window_"))
        return out

    def step_gaps(got):
        return {k: [abs(a - b) / abs(b) for a, b in
                    zip(got[k]["losses"], want[k]["losses"])]
                for k in want}

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
