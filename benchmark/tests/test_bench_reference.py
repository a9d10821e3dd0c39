"""The benchmark's plain reference against the program's plain path (its
CPU versions) at test shapes: the forwards of every configured model, and
the KD steps of the KD cells."""

import torch
import pytest

from benchmark import check, program
from benchmark.harness import by_name
from benchmark.inputs import batch_of, scene_pairs, seeded_weights
from benchmark.reference.outputs import flow0
from benchmark.reference.train import Adam, kd_step
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 33 + 7
SCENE = tiny_cell("teacher-eval-b1").workload["scene"]


def _pairs(n, seed=SEED):
    return scene_pairs(SCENE, n, 256, seed, "cpu")


def _flat(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _flat(v, f"{prefix}{i}.")
    elif torch.is_tensor(x):
        yield prefix, x


@pytest.mark.parametrize("cell,model", [("teacher-eval-b1", "teacher"),
                                        ("fg-eval-b1", "fg"),
                                        ("fg-fastkd-b8", "bifeat")])
def test_forward_equals_program(cell, model):
    cfg = tiny_cell(cell).config["models"][model]
    w = seeded_weights(check.meta_model(cfg), SEED, "model", "cpu")
    ref = check.reference_model(cfg, w, "cpu").eval()
    net = program.model(cfg, w, "cpu").eval()
    b = batch_of(_pairs(2), [0, 1])
    args = (b["pos1"], b["pos2"], b["norm1"], b["norm2"])
    with torch.no_grad():
        got, want = net(*args), ref(*args)
    want_flat = dict(_flat({k: want[k] for k in want}))
    got_flat = dict(_flat({k: got[k] for k in want}))
    assert want_flat.keys() == got_flat.keys()
    for name, t in want_flat.items():
        g = got_flat[name]
        assert g.shape == t.shape, name
        if t.dtype == torch.int32:
            assert torch.equal(g, t), name
        else:
            scale = t.abs().median().clamp(min=1e-6)
            assert float((g - t).abs().max() / scale) < 1e-4, name
    served = by_name("entries", "eval").build(cfg, w, "cpu")(*args)
    f0 = flow0(want)
    assert float((served - f0).abs().max() / f0.abs().median()) < 1e-4


@pytest.mark.parametrize("cell", ["teacher-kd-b8", "fg-fastkd-b8"])
def test_kd_steps_equal_program(cell):
    """The program's first steps and the window's checked steps (losses,
    Adam's gradient, the parameters' change) against the reference's, by
    the check's own numbers: both run the same float32 math on the CPU,
    so only the order of a few sums differs."""
    d = by_name("entries", "kd").Driver(tiny_cell(cell), SEED, "cpu")
    d.window(0.0)
    d.release()
    nums = d.numbers()
    for prefix in ("", "window_"):
        assert nums[prefix + "first_loss_gap"] <= 1e-6, nums
        assert nums[prefix + "grad_gap"] <= 1e-6, nums
        assert nums[prefix + "change_gap"] <= 1e-4, nums


def test_window_check_starts_mid_window():
    """The window's checked steps start at a step of the window drawn
    from the seed, from Adam's state there (its step count past set-up's)."""
    d = by_name("entries", "kd").Driver(tiny_cell("teacher-kd-b8"), SEED,
                                         "cpu")
    w = d.cell.workload
    assert 1 <= d.at <= w["batches"]
    d.window(0.0)
    assert float(d.snap["t"]) == w["check_steps"] + d.at
    assert d.snap["batch"] == w["check_steps"] + d.at
    assert len(d.window_prog["losses"]) == w["window_check_steps"]


def test_reference_adam_is_torch_adam():
    torch.manual_seed(0)
    a = torch.nn.Parameter(torch.randn(5, 3))
    b = torch.nn.Parameter(a.detach().clone())
    mine = Adam([a], lr=1e-3, weight_decay=1e-4)
    theirs = torch.optim.Adam([b], lr=1e-3, weight_decay=1e-4)
    for i in range(3):
        g = torch.randn(5, 3)
        a.grad, b.grad = g.clone(), g.clone()
        mine.step()
        theirs.step()
        assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_kd_step_moves_student_only():
    c = tiny_cell("teacher-kd-b8")
    w, models, train = c.workload, c.config["models"], c.config["train"]
    t_w = seeded_weights(check.meta_model(models["teacher"]), 1, "teacher",
                         "cpu")
    s_w = seeded_weights(check.meta_model(models["lighttoken_res"]), 1,
                         "student", "cpu")
    teacher = check.reference_model(models["teacher"], t_w, "cpu")
    student = check.reference_model(models["lighttoken_res"], s_w, "cpu")
    opt = Adam(student.parameters(), train["learning_rate"],
               train["weight_decay"])
    loss = by_name("reference/losses", w["loss"]).loss(w)
    kd_step(teacher, student, opt, loss, batch_of(_pairs(2), [0, 1]))
    for name, p in teacher.state_dict().items():
        assert torch.equal(p, t_w[name]), name
    moved = [n for n, p in student.named_parameters()
             if not torch.equal(p.detach(), s_w[n])]
    assert len(moved) == len(list(student.parameters()))
