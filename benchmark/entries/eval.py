"""The entry "eval": the program's eval forward (eval/runner.py
make_eval_forward) in a closed loop of one caller, one request a pair at
batch 1, over the cell's seeded pairs (already on the device), each
request ending when its flow0 is on the host.

Workload keys: model (a model of the configuration file), batch, points,
pairs, scene, warmup (requests in set-up), check (requests compared),
trace_calls, limits.

`correct`: the flow0 of a sample of the window's requests, drawn from the
seed, against the reference's. flow0 is the end of the whole forward
(every level's flow is upsampled into it and warps the next level's
search), so FPS, the kNN, the pool, interpolation, warping, the cross
layers and the flow heads all reach it. Numbers: the worst request's
median point error over the median length of the reference's flow vectors,
and the count of points, over all checked requests, whose error passes FAR
of that length (a single point altered counts; a neighbour choice that
flips between two float32 paths moves a point by a few 1e-3 of it at
most).
"""

from __future__ import annotations

import time

import torch

from benchmark import check
from benchmark.harness import free, p95
from benchmark.inputs import batch_of, generator, scene_pairs, seeded_weights
from benchmark.program import model
from benchmark.reference.outputs import flow0

BLOCK = 4                 # pairs a reference eval forward
FAR = 0.05                # a point this far off, over the median flow
                          # length, is a wrong answer


def build(cfg: dict, weights: dict, device):
    """The system under test: fn(pos1, pos2, norm1, norm2) -> flow0 on the
    device."""
    from kd_pointcloud_tpu_torch.eval.runner import make_eval_forward

    return make_eval_forward(model(cfg, weights, device))


def runs(cell) -> list:
    """(model sizes, with a backward) of the forwards a pair runs."""
    return [(cell.config["models"][cell.workload["model"]], False)]


class Driver:
    def __init__(self, cell, seed: int, device):
        w = cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cell.config["models"][w["model"]]
        self.weights = seeded_weights(check.meta_model(self.cfg), seed,
                                      "model", device)
        self.pairs = scene_pairs(w["scene"], w["pairs"], w["points"], seed,
                                 device)
        self.args = [(b["pos1"], b["pos2"], b["norm1"], b["norm2"])
                     for b in (batch_of(self.pairs, [i])
                               for i in range(w["pairs"]))]
        self.fwd = build(self.cfg, self.weights, device)
        for i in range(w["warmup"]):
            self.request(i)
        self.flows = []

    def request(self, i: int) -> torch.Tensor:
        return self.fwd(*self.args[i % len(self.args)])[0].cpu()

    def window(self, seconds: float) -> dict:
        lat, flows = [], []
        t0 = time.perf_counter()
        end = t1 = t0
        while t1 < t0 + seconds:
            a = time.perf_counter()
            flows.append(self.request(len(flows)))
            t1 = time.perf_counter()
            lat.append(t1 - a)
            end = t1
        self.flows = flows
        n = len(flows)
        return dict(attempted=n, pairs=n, seconds=end - t0,
                    metrics=dict(
                        eval_pairs_per_s=n / (end - t0),
                        eval_latency_p95_ms=1e3 * p95(lat)))

    def traced(self, i: int) -> None:
        self.request(len(self.flows) + i)

    def pairs_of(self, calls: int) -> int:
        return calls

    def release(self) -> None:
        del self.fwd

    def answers(self) -> list:
        """(pair id, flow0) of the window's requests that the check
        compares: a sample drawn from the seed."""
        w = self.cell.workload
        g = generator(self.seed, "sample", "cpu")
        picks = torch.randperm(len(self.flows), generator=g)[:w["check"]]
        return [(int(r) % w["pairs"], self.flows[int(r)]) for r in picks]

    def numbers(self) -> dict:
        answers = self.answers()
        ref = reference_flows(self.cfg, self.weights, self.pairs,
                              [pid for pid, _ in answers], self.device)
        return eval_numbers(answers, ref)


def reference_flows(cfg: dict, weights: dict, pairs: dict, ids, device):
    """{pair id: flow0 (N, 3) on the host} of the reference, in eval mode
    without autograd, BLOCK pairs a forward."""
    net = check.reference_model(cfg, weights, device).eval()
    out = {}
    ids = sorted(set(ids))
    with torch.no_grad():
        for at in range(0, len(ids), BLOCK):
            rows = ids[at:at + BLOCK]
            b = batch_of(pairs, rows)
            f = flow0(net(b["pos1"], b["pos2"], b["norm1"], b["norm2"]))
            for j, r in enumerate(rows):
                out[r] = f[j].cpu()
    return out


def point_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each point's error of got against want, over the median length of
    want's flow vectors (float64)."""
    err = (got.double() - want.double()).norm(dim=-1)
    return err / want.double().norm(dim=-1).median()


def eval_numbers(answers: list, ref: dict) -> dict:
    """answers: (pair id, program flow0) of the checked requests."""
    errs = [point_errors(got, ref[pid]) for pid, got in answers]
    return dict(flow_median_gap=max(float(e.median()) for e in errs),
                flow_far_points=sum(int((e > FAR).sum()) for e in errs))


def readings(cell, seed: int, seconds: float, device,
             controls: bool = True) -> dict:
    """control.py's readings of one seed: the program's numbers after a
    short window at the cell's load; with controls, the reference in TF32
    in the program's place, and one point's flow of each answer zeroed."""
    d = Driver(cell, seed, device)
    d.window(seconds)
    d.release()
    free(device)
    answers = d.answers()
    ids = [pid for pid, _ in answers]
    ref = reference_flows(d.cfg, d.weights, d.pairs, ids, device)
    out = dict(program=eval_numbers(answers, ref), requests=len(d.flows),
               program_max_gap=max(float(point_errors(f, ref[p]).max())
                                   for p, f in answers))
    if not controls:
        return out
    with check.tf32():
        low = reference_flows(d.cfg, d.weights, d.pairs, ids, device)
    out["control"] = eval_numbers([(p, low[p]) for p in ids], ref)
    out["control_max_gap"] = max(float(point_errors(low[p], ref[p]).max())
                                 for p in ids)
    row = []
    for p in ids:
        f = ref[p].clone()
        f[0] = 0.0
        row.append((p, f))
    out["fault_row"] = eval_numbers(row, ref)
    return out
