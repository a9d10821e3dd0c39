"""The frozen counts of work.py against the program's own counts
(ops/kernels.py counting() over its plain path) at test shapes, and the
teacher's model count against the reference's published figure."""

import pytest
import torch

from benchmark import check, program, work
from benchmark.harness import Cell, entry_of
from benchmark.inputs import batch_of, scene_pairs, seeded_weights
from benchmark.tests.tiny import TINY_POINTS, tiny_cell
from kd_pointcloud_tpu_torch.ops import kernels


def _program_count(cfg, batch, grad):
    """The program's kernels.counting() of one forward (a student's in
    train mode with its backward when grad) on seeded inputs."""
    w = seeded_weights(check.meta_model(cfg), 5, "model", "cpu")
    net = program.model(cfg, w, "cpu").train(grad)
    pairs = scene_pairs(tiny_cell("teacher-eval-b1").workload["scene"],
                        batch, TINY_POINTS[0], 5, "cpu")
    b = batch_of(pairs, list(range(batch)))
    with kernels.counting() as count, torch.set_grad_enabled(grad):
        out = net(b["pos1"], b["pos2"], b["norm1"], b["norm2"])
        if grad:
            sum(f.sum() for f in out["flows"] if torch.is_tensor(f)).backward()
    return count


@pytest.mark.parametrize("cell,model,grad", [
    ("teacher-eval-b1", "teacher", False),
    ("fg-eval-b1", "fg", False),
    ("fg-fastkd-b8", "bifeat", False),
    ("teacher-kd-b8", "lighttoken_res", True),
    ("fg-fastkd-b8", "fg", True)])
def test_site_counts_equal_program(cell, model, grad):
    """Calls, operations and bytes of kNN, FPS and the pool forward at the
    reference's call sites equal the program's count; the pool backward,
    which the program's CPU count leaves out, is at every student pool."""
    cfg = tiny_cell(cell).config["models"][model]
    _, calls = work.forward_sites(cfg, 2, TINY_POINTS[0], grad)
    totals = work.kernel_totals(calls)
    count = _program_count(cfg, 2, grad)
    for name in ("knn", "fps", "pool"):
        assert count.calls[name] == len(calls[name]), name
        assert count.ops[name] == totals[name][0], name
        assert count.bytes[name] == totals[name][1], name
    assert "pool_bwd" not in count.calls
    assert calls.get("pool_bwd", []) == (calls["pool"] if grad else [])


def test_pool_backward_count_leaves_out_the_recompute():
    """kernels/pool_bwd.py is ops/kernels.py kernel_work("pool_bwd") less the
    forward's recompute (2 C^2 + 5 C) and the mask's compares and counts
    (2 C) a (query, neighbour), on tie-free inputs (one mask entry a query
    and channel); the bytes are the same."""
    g = torch.Generator().manual_seed(3)
    B, N1, N2, K, C = 2, 24, 40, 8, 16
    u = torch.randn(B, N2, C, generator=g)
    idx = torch.rand(B, N1, N2, generator=g).argsort(-1)[..., :K].int()
    v = torch.randn(B, N1, C, generator=g)
    w = torch.randn(C, C, generator=g)
    b = torch.randn(C, generator=g)
    ct = torch.randn(B, N1, C, generator=g)
    ops, nbytes = kernels.kernel_work("pool_bwd", u, idx, v, w, b, ct)
    assert kernels.mask_entries(u, idx, v, w, b) == B * N1 * C
    mine = work.formula("pool_bwd").work(B, N1, N2, K, C)
    assert mine == (ops - B * N1 * K * (2 * C * C + 7 * C), nbytes)


def test_kernel_formulas_equal_program():
    g = torch.Generator().manual_seed(4)
    xyz = torch.randn(3, 50, 3, generator=g)
    q = torch.randn(3, 20, 3, generator=g)
    def formula(kind, *site):
        return work.formula(kind).work(*site)

    assert formula("knn", 3, 20, 50, 7) == kernels.kernel_work("knn", 7, xyz,
                                                               q)
    assert formula("fps", 3, 50, 10) == kernels.kernel_work("fps", xyz, 10)
    u, v = torch.zeros(3, 50, 32), torch.zeros(3, 20, 32)
    idx = torch.zeros(3, 20, 9, dtype=torch.int32)
    assert formula("pool", 3, 20, 50, 9, 32) == kernels.kernel_work(
        "pool", u, idx, v, torch.zeros(32, 32), torch.zeros(32))


def test_teacher_dense_count_near_published():
    """The teacher's matrix products a 8192-point pair land near the
    reference's published 13.1 GMAC (26.2 GFLOP, thop); the count adds the
    3-D kNN and FPS formulas on top."""
    c = Cell("teacher-eval-b1")
    dense, calls = work.forward_sites(c.config["models"]["teacher"], 1, 8192,
                                      False)
    assert abs(dense - 26.2e9) <= 0.1 * 26.2e9
    assert work.model_flops(dense, calls) == pytest.approx(
        work.cell_work(entry_of(c).runs(c), c.workload)["flops"])


@pytest.mark.parametrize("cell", ["teacher-kd-b8", "fg-fastkd-b8"])
def test_training_pair_counts_searches_once(cell):
    """A KD pair: the teacher's forward once; the student's differentiable
    products three times, its 3-D kNN, FPS and feature-kNN products (no
    autograd) once."""
    c = tiny_cell(cell)
    w, models = c.workload, c.config["models"]
    B, N = w["batch"], w["points"]
    t_dense, t_calls = work.forward_sites(models[w["teacher"]], B, N, False)
    s_dense, s_calls = work.forward_sites(models[w["student"]], B, N, True)
    t_tot, s_tot = work.kernel_totals(t_calls), work.kernel_totals(s_calls)
    fknn = sum(2 * b * s * n * d
               for b, s, n, d, _ in s_calls.get("feature_knn", ()))
    assert (fknn > 0) == (models[w["student"]]["cross"] == "fg")
    want = (t_dense + t_tot["knn"][0] + t_tot["fps"][0]
            + 3 * (s_dense - fknn) + fknn + s_tot["knn"][0] + s_tot["fps"][0])
    got = work.cell_work(entry_of(c).runs(c), w)["flops"] * B
    assert got == pytest.approx(want, rel=1e-12)
