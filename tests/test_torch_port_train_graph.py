"""The KD step's CUDA graphs (train/graphs.py StepGraphs, which
train/distill.py make_distill_step and make_fast_distill_step return).

On the CPU: the rule that decides between graph and eager, each condition
alone; the signature (device, keys, shapes, dtypes, every param group's
lr, betas, eps and weight_decay); what moves a captured step's tensors;
Adam made capturable; a tiny KD step teacher -> lighttoken_res and bifeat
-> fg staying eager, bit-identical to the step's own body, with the
counters saying so; Adam made capturable around a warm-up and a capture
alone, its checkpoint resuming on the CPU; the sequence eager, capture,
replay and its recaptures, with the card's calls stood in for; the launch
counters' take-back and replay; kd.step among the spans.

On the card (marker ``card``; each skips without one): the graphed step
against the eager body at teacher -> lighttoken_res and bifeat -> fg,
batch 2 of 8192-point pairs, 8 batches in rotation; a kept loss after the
next step; a new learning rate; an optimizer's load_state_dict; a
checkpoint of graphed steps resumed on the CPU; a trace around replays. This file imports no JAX; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_train_graph.py
"""

import contextlib
import copy
import json
import statistics
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            tiny_config)
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.parallel import Mesh
from kd_pointcloud_tpu_torch.perf import trace, train_graph_counts
from kd_pointcloud_tpu_torch.perf.trace import SPANS, kernel_records
from kd_pointcloud_tpu_torch.train import (full_state_tree,
                                           make_distill_step,
                                           make_fast_distill_step,
                                           make_named_loss, make_optimizer,
                                           restore_train_state,
                                           save_checkpoint,
                                           set_learning_rate)
from kd_pointcloud_tpu_torch.train import graphs
from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

from torch_port_checks import card  # noqa: F401  (the card tests' gate)

torch.set_num_threads(1)

B, N, STEPS = 2, 256, 3
ZERO_GRAD = 1e-3     # benchmark/check.py's: Adam moves such a parameter by
                     # round-off alone
KD_LOSS = ("biDirection_loss_ht", dict(gamma=0.3, beta=0.8, hint_layers=[3]))
# (teacher, student, the benchmark cell whose limits hold the card steps)
PATHS = {"kd": ("teacher", "lighttoken_res", "teacher-kd-b8"),
         "fast_kd": ("bifeat", "fg", "fg-fastkd-b8")}
WORKLOADS = Path(__file__).resolve().parents[1] / "benchmark" / "workloads"


def _model(name, seed, device="cpu", cfg=tiny_config):
    return BidPointFlowNet(cfg(name), device=device,
                           generator=torch.Generator().manual_seed(seed))


def _batch(i, b=B, n=N):
    g = torch.Generator().manual_seed(100 + i)
    pc1 = torch.rand(b, n, 3, generator=g) * 4 - 2
    pc2 = pc1 + 0.1 * torch.randn(b, n, 3, generator=g)
    return dict(pos1=pc1, pos2=pc2, norm1=pc1, norm2=pc2, flow=pc2 - pc1)


def _step(path, teacher, student, opt):
    if path == "fast_kd":
        return make_fast_distill_step(teacher, student, opt)
    return make_distill_step(teacher, student, opt,
                             loss_fn=make_named_loss(*KD_LOSS))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, for the rule alone."""

    @property
    def is_cuda(self):
        return True


class _Mode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _on_card(batch):
    return {k: torch.Tensor._make_subclass(_OnCard, v)
            for k, v in batch.items()}


def _adam():
    return torch.optim.Adam(torch.nn.Linear(3, 3).parameters(), lr=1e-3)


# every condition alone: whether breaking it keeps the step from a graph
BREAKS = {
    "as_is": False,
    "cpu_batch": True,
    "one_cpu_tensor": True,
    "empty_batch": True,
    "mesh_of_one": False,
    "mesh_of_two": True,
    "mesh_of_one_with_a_group": True,
    "counting": True,
    "dispatch_mode": True,
    "capturing": True,
    "sgd": True,
    "adam_and_sgd": True,
}


@pytest.mark.parametrize("case", sorted(BREAKS))
def test_engagement_rule(case, monkeypatch):
    """Graph only with the whole batch on the card, no collective, no
    count, no dispatch mode, no capture going on and Adam alone."""
    capturing = case == "capturing"
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    batch, mesh, opts = _on_card(_batch(0)), None, [_adam()]
    block = contextlib.nullcontext()
    if case == "cpu_batch":
        batch = _batch(0)
    elif case == "one_cpu_tensor":
        batch["flow"] = _batch(0)["flow"]
    elif case == "empty_batch":
        batch = {}
    elif case.startswith("mesh_of"):
        mesh = Mesh(2 if case == "mesh_of_two" else 1, 0,
                    torch.device("cuda"),
                    object() if case.endswith("group") else None)
    elif case == "counting":
        block = kernels.counting()
    elif case == "dispatch_mode":
        block = _Mode()
    elif case in ("sgd", "adam_and_sgd"):
        sgd = torch.optim.SGD(torch.nn.Linear(3, 3).parameters(), lr=0.1)
        opts = [sgd] if case == "sgd" else [opts[0], sgd]
    with block:
        assert graphs.engages(batch, mesh, opts) is not BREAKS[case]


def test_signature_is_device_keys_shapes_dtypes_and_hyperparameters():
    opt = _adam()
    key = graphs.signature(_batch(0), [opt])
    assert key == graphs.signature(_batch(1), [opt])
    assert key != graphs.signature(_batch(0, n=N // 2), [opt])
    assert key != graphs.signature(_batch(0, b=1), [opt])
    assert key != graphs.signature(
        {k: v.double() for k, v in _batch(0).items()}, [opt])
    assert key != graphs.signature(
        dict(_batch(0), weight=torch.ones(B)), [opt])
    assert key != graphs.signature(
        {k: v.to("meta") for k, v in _batch(0).items()}, [opt])
    for name, value in (("lr", 1e-4), ("betas", (0.8, 0.999)),
                        ("eps", 1e-6), ("weight_decay", 1e-2)):
        other = _adam()
        other.param_groups[0][name] = value
        assert key != graphs.signature(_batch(0), [other]), name
    set_learning_rate(opt, 1e-3)
    assert key == graphs.signature(_batch(0), [opt])
    set_learning_rate(opt, 5e-4)
    assert key != graphs.signature(_batch(0), [opt])


def _resumes_on_cpu(model, opt, tmp_path):
    """A checkpoint of model and opt, restored into a CPU copy of model
    with a fresh make_optimizer, takes an Adam step there."""
    path = save_checkpoint(str(tmp_path), "m", 1, 0.5,
                           full_state_tree(model, opt, 1, 0.5))
    cpu = copy.deepcopy(model).cpu()
    cpu_opt = make_optimizer(cpu)
    restore_train_state(path, cpu, cpu_opt)
    assert not any(g["capturable"] for g in cpu_opt.param_groups)
    before = [p.detach().clone() for p in cpu.parameters()]
    for p in cpu.parameters():
        p.grad = torch.ones_like(p)
    cpu_opt.step()
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                      cpu.parameters()))


def test_capturable_sets_the_groups_and_puts_them_back(tmp_path):
    """Inside, every group capturable and each step count a float32
    tensor on its parameter's device; after, each group's own setting
    back (also after an error), the counts left where they were moved,
    and a checkpoint that resumes on the CPU."""
    model = torch.nn.Linear(3, 3)
    opt = make_optimizer(model)
    model(torch.ones(2, 3)).sum().backward()
    opt.step()
    steps = [opt.state[p]["step"] for p in model.parameters()]
    assert not any(g["capturable"] for g in opt.param_groups)
    with graphs.capturable([opt]):
        assert all(g["capturable"] for g in opt.param_groups)
        # already on the parameter's device: left where it lies
        assert all(opt.state[p]["step"] is s
                   for p, s in zip(model.parameters(), steps))
    assert not any(g["capturable"] for g in opt.param_groups)
    p = next(model.parameters())
    opt.state[p]["step"] = 1.0          # a count Adam kept as a number
    other = torch.optim.Adam(torch.nn.Linear(3, 3).parameters(),
                             capturable=True)
    with pytest.raises(RuntimeError), graphs.capturable([opt, other]):
        assert all(g["capturable"] for g in opt.param_groups)
        raise RuntimeError("a failed capture")
    assert not any(g["capturable"] for g in opt.param_groups)
    assert all(g["capturable"] for g in other.param_groups)
    assert torch.is_tensor(opt.state[p]["step"])
    assert float(opt.state[p]["step"]) == 1.0
    assert opt.state[p]["step"].dtype == torch.float32
    assert not any(g["capturable"]
                   for g in opt.state_dict()["param_groups"])
    _resumes_on_cpu(model, opt, tmp_path)


def test_where_sees_what_forces_a_new_capture():
    """Parameters, buffers, gradients and Adam's state moved, each alone,
    change where the step's tensors lie; a step in place does not."""
    teacher, student = _model("teacher", 1), _model("lighttoken_res", 0)
    opt = make_optimizer(student)
    step = _step("kd", teacher, student, opt)
    assert isinstance(step, graphs.StepGraphs)
    step(_batch(0))
    where = step.where()
    assert where == step.where()
    with torch.no_grad():
        for p in student.parameters():
            p.add_(1.0)                 # in place: no new capture
    assert step.where() == where
    p = next(student.parameters())
    moves = [
        lambda: setattr(next(teacher.parameters()), "data",
                        next(teacher.parameters()).data.clone()),
        lambda: setattr(next(student.buffers()), "data",
                        next(student.buffers()).data.clone()),
        lambda: setattr(p, "grad", p.grad.clone()),
        lambda: opt.zero_grad(set_to_none=True),
        lambda: opt.load_state_dict(copy.deepcopy(opt.state_dict())),
        lambda: opt.state[p].__setitem__("exp_avg_sq",
                                         opt.state[p]["exp_avg_sq"].clone()),
    ]
    for i, move in enumerate(moves):
        step(_batch(0))                 # gradients and state as a step left
        before = step.where()
        move()
        assert step.where() != before, i


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cpu_step_is_eager_and_bit_identical(path):
    """Three steps on the CPU: eager, bit for bit the step's own body
    (today's step), Adam's settings untouched, every step counted
    eager."""
    teacher, student = PATHS[path][:2]
    runs = []
    for graphed in (True, False):
        t_model, s_model = _model(teacher, 1), _model(student, 0)
        opt = make_optimizer(s_model)
        step = _step(path, t_model, s_model, opt)
        run = step if graphed else step.body
        kernels.reset_launches()
        losses = [run(_batch(i)) for i in range(STEPS)]
        counts = train_graph_counts()
        state = [t.detach().clone() for t in s_model.state_dict().values()]
        moments = [opt.state[p][k].clone() for p in s_model.parameters()
                   for k in ("exp_avg", "exp_avg_sq", "step")]
        assert not any(g["capturable"] for g in opt.param_groups)
        runs.append((losses, state + moments, counts))
    (got, got_state, counts), (want, want_state, none) = runs
    assert counts == dict(captures=0, replays=0, eager=STEPS)
    assert none == dict(captures=0, replays=0, eager=0)
    assert kernels.TRAIN_GRAPHS == none
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(got_state) == len(want_state)
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay reruns nothing and
    counts itself."""
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def _stand_ins(monkeypatch):
    """The card's calls StepGraphs makes, stood in for on the CPU: the
    rule says yes, a capture records no work and a replay runs none, so
    the sequence, the counters and the recaptures can be read."""
    monkeypatch.setattr(graphs, "engages", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: None)
    # Adam takes capturable groups on the card only: record the calls
    made = []

    @contextlib.contextmanager
    def record(optimizers):
        made.append(optimizers)
        yield
    monkeypatch.setattr(graphs, "capturable", record)
    _FakeGraph.replays = 0
    return made


def _linear_step(model, opt, launches=3):
    """A step of the body's form on a Linear: gradients to None, a loss,
    backward, Adam; it counts `launches` pool launches."""
    def body(batch):
        opt.zero_grad(set_to_none=True)
        loss = ((model(batch["x"]) - batch["y"]) ** 2).mean()
        loss.backward()
        opt.step()
        kernels.LAUNCHES["pool"] += launches
        kernels.WIDTH_LAUNCHES["pool C=3"] = (
            kernels.WIDTH_LAUNCHES.get("pool C=3", 0) + launches)
        return loss.detach()
    return graphs.StepGraphs(body, (model,), (opt,))


def _xy(i, rows=4):
    g = torch.Generator().manual_seed(i)
    return dict(x=torch.randn(rows, 3, generator=g),
                y=torch.randn(rows, 3, generator=g))


def test_sequence_eager_capture_replay(monkeypatch):
    """A signature's first step eager with Adam made capturable, its
    second captured (Adam capturable again, launches taken back) and
    replayed, then replays,
    each returning a clone of the static loss and adding the launches;
    a moved tensor, a new lr or a new shape capture again; at most
    MAX_SIGNATURES held; no capture while a profiler records."""
    made = _stand_ins(monkeypatch)
    model = torch.nn.Linear(3, 3)
    opt = make_optimizer(model)
    step = _linear_step(model, opt)
    kernels.reset_launches()
    step(_xy(0))
    assert made == [(opt,)]
    assert train_graph_counts() == dict(captures=0, replays=0, eager=1)
    assert kernels.LAUNCHES["pool"] == 3
    losses = [step(_xy(i)) for i in range(1, 5)]
    assert train_graph_counts() == dict(captures=1, replays=4, eager=1)
    assert made == [(opt,)] * 2
    assert _FakeGraph.replays == 4
    assert kernels.LAUNCHES["pool"] == 3 * 5
    assert kernels.WIDTH_LAUNCHES == {"pool C=3": 15}
    (graph,) = step._graphs.values()
    assert all(loss is not graph.output for loss in losses)
    assert torch.equal(graph.inputs[0]["x"], _xy(4)["x"])
    # a moved tensor: captured again
    p = next(model.parameters())
    p.data = p.data.clone()
    step(_xy(5))
    assert train_graph_counts() == dict(captures=2, replays=5, eager=1)
    # no capture while a profiler records; a replay is allowed
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    step(_xy(6))
    assert train_graph_counts()["replays"] == 6
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    step(_xy(7))
    assert train_graph_counts() == dict(captures=2, replays=6, eager=2)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)
    step(_xy(8))
    assert train_graph_counts() == dict(captures=3, replays=7, eager=2)
    # a new lr, then a new shape: each a signature of its own, the least
    # recently used dropped
    set_learning_rate(opt, 1e-4)
    step(_xy(9))
    step(_xy(10))
    assert train_graph_counts() == dict(captures=4, replays=8, eager=3)
    step(_xy(11, rows=2))
    assert len(step._graphs) == graphs.MAX_SIGNATURES
    assert [k[-1][0] for k in step._graphs] == [1e-4, 1e-4]
    assert train_graph_counts() == dict(captures=4, replays=8, eager=4)


def test_launch_counters_and_train_graph_counts():
    kernels.reset_launches()
    kernels.TRAIN_GRAPHS.update(captures=1, replays=5, eager=1)
    kernels.EVAL_GRAPHS["replays"] = 2
    assert train_graph_counts() == dict(captures=1, replays=5, eager=1)
    counts = train_graph_counts()
    counts["replays"] = 0               # a copy
    assert kernels.TRAIN_GRAPHS["replays"] == 5
    kernels.reset_launches()
    assert train_graph_counts() == dict(captures=0, replays=0, eager=0)
    assert kernels.EVAL_GRAPHS == dict(captures=0, replays=0, eager=0)


def test_spans_hold_kd_step():
    assert "kd.step" in SPANS
    assert len(set(SPANS)) == len(SPANS)


# ------------------------------------------------------------------ card

POINTS = 8192
CARD_BATCH = 2
ROTATION = 8
CARD_STEPS = 6


def _limits(path):
    return json.loads((WORKLOADS / f"{PATHS[path][2]}.json").read_text())[
        "limits"]


@pytest.fixture(scope="module")
def batches(card):
    return synthetic_batches(ROTATION, CARD_BATCH, POINTS, 11, "cuda")


def _twins(path, card):
    """Two students from the same weights under one frozen teacher, each
    with its own Adam: [(student, opt, step)], the graphed step first,
    then the step's own body (the eager step, Adam as make_optimizer
    builds it)."""
    teacher, student = PATHS[path][:2]
    t_model = _model(teacher, 1, card, cfg=lambda n: PRESETS[n]).eval()
    s_model = _model(student, 0, card, cfg=lambda n: PRESETS[n])
    out = []
    for graphed in (True, False):
        s = copy.deepcopy(s_model)
        opt = make_optimizer(s, 1e-3, 1e-4)
        step = _step(path, t_model, s, opt)
        out.append((s, opt, step if graphed else step.body))
    return out


def _worst_gap(got: dict, want: dict, keep=None) -> tuple:
    """benchmark/check.py's rule: the worst |got - want| over max(want,
    the median of want), and the name it is worst at."""
    names = [n for n in want if keep is None or n in keep]
    scale = statistics.median(want[n] for n in names)
    return max((abs(got[n] - want[n]) / max(want[n], scale), n)
               for n in names)


def _moment(opt, p):
    m = opt.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m.detach().clone()


def _follow(twins) -> None:
    """Set the eager twin's parameters, buffers and Adam state to the
    graphed twin's, in place (the eager Adam keeps its own settings)."""
    (s_g, opt_g, _), (s_e, opt_e, _) = twins
    with torch.no_grad():
        for a, b in zip(s_e.state_dict().values(),
                        s_g.state_dict().values(), strict=True):
            a.copy_(b)
        for p_e, p_g in zip(s_e.parameters(), s_g.parameters()):
            for key, v in opt_g.state.get(p_g, {}).items():
                opt_e.state[p_e][key].copy_(v)


def _lockstep(path, twins, batch) -> dict:
    """One step of each twin from the same state (the eager one made to
    follow the graphed one, once both hold Adam state): the losses bit for
    bit, and the step's gradient as Adam took it and each parameter's
    change within the cell's grad_gap and change_gap, by
    benchmark/check.py's rule: a parameter whose eager gradient is under
    ZERO_GRAD of the median parameter's is left out of the change,
    since Adam moves it by round-off alone. Returns the two gaps, each
    with the parameter it is worst at."""
    (s_g, opt_g, step_g), (s_e, opt_e, step_e) = twins
    if opt_e.state:
        _follow(twins)
    before = {n: p.detach().clone() for n, p in s_g.named_parameters()}
    m0 = {n: _moment(opt_g, p) for n, p in s_g.named_parameters()}
    loss_g, loss_e = step_g(batch), step_e(batch)
    assert torch.equal(loss_g, loss_e), (float(loss_g), float(loss_e))
    beta1 = opt_e.param_groups[0]["betas"][0]
    out = {}
    for name, (s, opt) in (("graph", (s_g, opt_g)), ("eager", (s_e, opt_e))):
        params = dict(s.named_parameters())
        out[name] = dict(
            grad={n: float(((_moment(opt, p) - beta1 * m0[n]) / (1 - beta1))
                           .double().norm()) for n, p in params.items()},
            change={n: float((p.detach() - before[n]).double().norm())
                    for n, p in params.items()})
    grad = out["eager"]["grad"]
    med = statistics.median(grad.values())
    moved = {n for n, g in grad.items() if g >= ZERO_GRAD * med}
    gaps = dict(grad_gap=_worst_gap(out["graph"]["grad"], grad),
                change_gap=_worst_gap(out["graph"]["change"],
                                      out["eager"]["change"], moved))
    limits = _limits(path)
    assert all(g <= limits[k] for k, (g, _) in gaps.items()), gaps
    return gaps


@pytest.mark.card
@pytest.mark.parametrize("path", sorted(PATHS))
def test_graphed_step_against_eager(path, card, batches):
    """CARD_STEPS steps over batches in rotation, each graphed and eager
    from the same state: the losses bit for bit, the gradients and the
    parameters' changes within the cell's limits; 1 capture, CARD_STEPS -
    1 replays and 1 eager step; every step ran the path's kernels. (Two
    eager runs of these steps, left to run on apart, differ by more than
    those limits after a few steps: the backward adds in no fixed order.)"""
    twins = _twins(path, card)
    kernels.reset_launches()
    for i in range(CARD_STEPS):
        _lockstep(path, twins, batches[i % ROTATION])
    assert train_graph_counts() == dict(captures=1, replays=CARD_STEPS - 1,
                                        eager=1)
    launches = dict(kernels.LAUNCHES)
    assert launches["pool_bwd"] > 0 and launches["knn"] > 0
    assert all(c % (2 * CARD_STEPS) == 0 for c in launches.values())


@pytest.mark.card
def test_kept_loss_survives_the_next_step(card, batches):
    step = _twins("kd", card)[0][2]
    kept = [step(batches[i]) for i in range(4)]
    copies = [k.clone() for k in kept]
    for i in range(4, 7):
        step(batches[i])
    torch.cuda.synchronize()
    assert train_graph_counts()["replays"] > 0
    assert all(torch.equal(k, c) for k, c in zip(kept, copies))
    assert len({float(k) for k in kept}) == len(kept)


@pytest.mark.card
def test_new_lr_captures_again_and_steps_with_it(card, batches):
    """Three steps at lr 1e-3, then three at 1e-2, graphed and eager from
    the same state: a second warm-up and capture, and every step within
    the cell's limits of the eager step at the same lr."""
    twins = _twins("kd", card)
    kernels.reset_launches()
    for i in range(6):
        if i == 3:
            for _, opt, _ in twins:
                set_learning_rate(opt, 1e-2)
        _lockstep("kd", twins, batches[i])
    assert train_graph_counts() == dict(captures=2, replays=4, eager=2)


@pytest.mark.card
def test_load_state_dict_captures_again(card, batches):
    """The eager twin's Adam state (its step counts on the host, not
    capturable) loaded into the graphed step's Adam: the graphed step
    captures again, and steps as the eager one does."""
    twins = _twins("kd", card)
    for i in range(3):
        _lockstep("kd", twins, batches[i])
    (s_g, opt_g, _), (s_e, opt_e, _) = twins
    s_g.load_state_dict(s_e.state_dict())
    opt_g.load_state_dict(copy.deepcopy(opt_e.state_dict()))
    assert not any(g["capturable"] for g in opt_g.param_groups)
    kernels.reset_launches()
    for i in range(3, 6):
        _lockstep("kd", twins, batches[i])
    assert train_graph_counts() == dict(captures=1, replays=3, eager=0)
    assert not any(g["capturable"] for g in opt_g.param_groups)


@pytest.mark.card
def test_checkpoint_of_graphed_steps_resumes_on_cpu(card, batches,
                                                    tmp_path):
    """After a warm-up, a capture and replays, the optimizer holds the
    settings it was made with: a further step runs eager Adam within the
    cell's limits of the eager twin's, and a checkpoint written then
    resumes on the CPU."""
    twins = _twins("kd", card)
    kernels.reset_launches()
    for i in range(4):
        _lockstep("kd", twins, batches[i])
    s_g, opt_g, _ = twins[0]
    assert not any(g["capturable"] for g in opt_g.param_groups)
    with kernels.counting():            # the graph does not engage
        _lockstep("kd", twins, batches[4])
    assert train_graph_counts() == dict(captures=1, replays=3, eager=2)
    _resumes_on_cpu(s_g, opt_g, tmp_path)


@pytest.mark.card
def test_trace_of_replayed_steps(card, batches, tmp_path):
    """Two replays under perf.trace (which raises where a record is lost):
    the path's kernels by name, as many records as launches, one kd.step
    span a replay and no phase span."""
    step = _twins("kd", card)[0][2]
    for i in range(2):
        step(batches[i])
    before = dict(kernels.LAUNCHES)
    replays = train_graph_counts()["replays"]
    with trace(str(tmp_path)):
        for i in range(2, 4):
            step(batches[i])
    assert train_graph_counts()["replays"] == replays + 2
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {str(e.get("name")) for e in events if e.get("cat") == "kernel"}
    for kernel in ("knn_kernel", "pool_kernel", "pool_bwd_mask_kernel",
                   "pool_bwd_kernel"):
        assert any(kernel in n for n in names), kernel
    launched = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
                if c > before[n]}
    assert kernel_records(events) == launched
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("kd.step") == 2
    assert not [s for s in spans if s.startswith("kd.") and s != "kd.step"]
