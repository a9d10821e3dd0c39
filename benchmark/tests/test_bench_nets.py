"""A model entry's reference network and a kernel's work formula, found by
name: the frozen counts and seeded weights of every configured model as
they read before the lookup by name, the models the default network
refuses at set-up, and a new architecture that enters as files only."""

import dataclasses
import hashlib

import pytest
import torch

from benchmark import check, lookup, program, work
from benchmark.harness import BENCH_DIR, Cell, by_name, entry_of, read_metric
from benchmark.inputs import batch_of, scene_pairs, seeded_weights
from benchmark.reference.outputs import flow0
from benchmark.tests.tiny import tiny_cell
from benchmark.tracing import STRETCH, Stretch
from kd_pointcloud_tpu_torch.models.config import PRESETS

# work.cell_work of each cell at its own size (meta tensors), as the
# harness read it while the network and the formulas were fixed in code:
# flops a pair, and each kernel's (ops, bytes, bound seconds) a pair. The
# eval cells' pool_bwd read (0.0, 0.0, 0.0) then: a kernel no run records
# is no longer listed.
CELL_WORK = {
    "teacher-kd-b8": (115922241280.0, {
        "knn": (6450315264.0, 19339264.0, 9.636274053731343e-05),
        "fps": (670760960.0, 425984.0, 1.0011357611940299e-05),
        "pool": (16609443840.0, 46465440.0, 0.00024790214686567163),
        "pool_bwd": (655884288.0, 35946912.0, 1.3297719402985076e-05)}),
    "fg-fastkd-b8": (107588163264.0, {
        "knn": (11442585600.0, 29169664.0, 0.00017083340035820897),
        "fps": (670760960.0, 425984.0, 1.0011357611940299e-05),
        "pool": (21661483008.0, 67141872.0, 0.0003233057165373135),
        "pool_bwd": (655884288.0, 35946912.0, 1.3297719402985076e-05)}),
    "teacher-eval-b1": (30760829376.0, {
        "knn": (3225157632.0, 9669632.0, 4.818137026865672e-05),
        "fps": (335380480.0, 212992.0, 5.0056788059701495e-06),
        "pool": (8304721920.0, 24151680.0, 0.00012395107343283581)}),
    "fg-eval-b1": (31184150976.0, {
        "knn": (4433117184.0, 12176384.0, 6.61901984477612e-05),
        "fps": (335380480.0, 212992.0, 5.0056788059701495e-06),
        "pool": (8304721920.0, 24151680.0, 0.00012395107343283581)}),
}

# sha256 over (name, bytes) of every leaf of seeded_weights(meta_model(
# model entry), WEIGHT_SEED, "model", "cpu") at the published sizes, as
# read while the network was fixed in code; and the count of leaves and of
# numbers (lighttoken_res and bifeat share their siblings' names and
# shapes)
WEIGHT_SEED = 2 ** 31 + 77
WEIGHTS = {
    ("teacher", "teacher"): (
        "707e9c51583d758f56d42318057ccbf0b20b0ce37c7dcb94ec34852a2e5b83ed",
        250, 7958932),
    ("teacher", "lighttoken_res"): (
        "707e9c51583d758f56d42318057ccbf0b20b0ce37c7dcb94ec34852a2e5b83ed",
        250, 7958932),
    ("fg", "fg"): (
        "75a599fac2f7545961e4603455f89448982415c7e137266eb3453e0af9f11121",
        256, 4341124),
    ("fg", "bifeat"): (
        "75a599fac2f7545961e4603455f89448982415c7e137266eb3453e0af9f11121",
        256, 4341124),
}
CONFIG_CELL = {"teacher": "teacher-eval-b1", "fg": "fg-eval-b1"}

# the program's presets that the default network does not build, and the
# fields its refusal names
UNBUILT = {
    "serving": ("flow_nei_per_level",),
    "serving_v2": ("flow_nei_per_level",),
    "serving_v3": ("coarse_warp",),
    "student": ("level_block",),
    "student2": ("level_block",),
    "non_linear": ("level_block", "nonlinear_downsample"),
    "no_cross": ("cross", "swap_interlevel"),
    "vote": ("cross",),
}
BUILT = ("teacher", "lighttoken_res", "weight48", "fg", "bifeat")

NEWARCH = BENCH_DIR / "tests" / "newarch"
CORRFLOW = dict(reference="corrflow", name="corrflow", width=16, nei=4)
SEED = 2 ** 33 + 21


@pytest.mark.parametrize("cell", sorted(CELL_WORK))
def test_cell_work_as_pinned(cell):
    c = Cell(cell)
    got = work.cell_work(entry_of(c).runs(c), c.workload)
    flops, kernels = CELL_WORK[cell]
    assert got["flops"] == flops
    assert got["kernels"] == kernels


@pytest.mark.parametrize("config,model", sorted(WEIGHTS))
def test_seeded_weights_as_pinned(config, model):
    cfg = Cell(CONFIG_CELL[config]).config["models"][model]
    w = seeded_weights(check.meta_model(cfg), WEIGHT_SEED, "model", "cpu")
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert (h.hexdigest(), len(w), sum(t.numel() for t in w.values())) \
        == WEIGHTS[config, model]


def _preset(name: str) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(PRESETS[name]).items()}


def _eval_setup(model_entry: dict):
    """An eval cell's set-up at test size with model_entry as its model."""
    cell = tiny_cell("teacher-eval-b1")
    cell.config["models"][cell.workload["model"]] = model_entry
    return by_name("entries", "eval").Driver(cell, SEED, "cpu")


@pytest.mark.parametrize("preset", sorted(UNBUILT))
def test_setup_refuses_what_the_reference_does_not_build(preset):
    with pytest.raises(ValueError) as err:
        _eval_setup(_preset(preset))
    for field in UNBUILT[preset]:
        assert field in str(err.value), (preset, field)
    assert "pointflownet" in str(err.value)


def test_setup_refuses_an_unknown_field():
    entry = tiny_cell("teacher-eval-b1").config["models"]["teacher"]
    with pytest.raises(ValueError, match="radius"):
        _eval_setup(dict(entry, radius=0.5))


def test_setup_refuses_an_unknown_reference():
    entry = tiny_cell("teacher-eval-b1").config["models"]["teacher"]
    with pytest.raises(KeyError, match="reference/nets has no no_such_net"):
        _eval_setup(dict(entry, reference="no_such_net"))


@pytest.mark.parametrize("preset", BUILT)
def test_default_network_builds_its_presets(preset):
    assert isinstance(check.meta_model(_preset(preset)), torch.nn.Module)


def test_reference_key_names_the_default_network():
    """A model entry that names "pointflownet" gets the network an entry
    without the key gets, names and shapes, and the program drops the
    key."""
    entry = tiny_cell("teacher-eval-b1").config["models"]["teacher"]
    named = dict(entry, reference=lookup.DEFAULT_NET)
    w = seeded_weights(check.meta_model(entry), SEED, "model", "cpu")
    w2 = seeded_weights(check.meta_model(named), SEED, "model", "cpu")
    assert w.keys() == w2.keys()
    assert all(torch.equal(w[k], w2[k]) for k in w)
    program.model(named, w, "cpu")
    check.reference_model(named, w, "cpu")


def test_recorded_kind_without_a_formula_raises():
    with pytest.raises(KeyError, match="kernels has no mystery.py"):
        work.kernel_totals({"knn": [(1, 4, 4, 2)], "mystery": [(1, 2)]})
    assert work.kernel_totals({"feature_knn": [(1, 4, 4, 8, 2)]}) == {}


def _stretch(kernel: str, dur_us: float, cell_work: dict) -> Stretch:
    """A 10 ms stretch of 2 pairs whose one device kernel is kernel."""
    ev = [dict(ph="X", cat="user_annotation", name=STRETCH, ts=1000,
               dur=10000),
          dict(ph="X", cat="kernel", name=kernel, ts=2000, dur=dur_us)]
    return Stretch(ev, 2, cell_work, rate=1.0)


def test_new_architecture_is_files_only(monkeypatch):
    """A network outside the family, a new kind of kernel call with its
    formula and a roofline reader, each a file under the fixture root
    benchmark/tests/newarch/: built and seeded by name, counted by work.py
    (the new kind too), read by its reader."""
    with pytest.raises(KeyError, match="corrflow"):
        check.meta_model(CORRFLOW)
    monkeypatch.setattr(lookup, "ROOTS", lookup.ROOTS + (NEWARCH,))
    B, N, W, K = 2, 64, CORRFLOW["width"], CORRFLOW["nei"]

    w = seeded_weights(check.meta_model(CORRFLOW), SEED, "model", "cpu")
    again = seeded_weights(check.meta_model(CORRFLOW), SEED, "model", "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    net = check.reference_model(CORRFLOW, w, "cpu").eval()
    pairs = scene_pairs(tiny_cell("teacher-eval-b1").workload["scene"], B,
                        N, SEED, "cpu")
    b = batch_of(pairs, list(range(B)))
    with torch.no_grad():
        out = net(b["pos1"], b["pos2"], b["norm1"], b["norm2"])
    assert flow0(out).shape == (B, N, 3)
    assert torch.isfinite(flow0(out)).all()

    dense, calls = work.forward_sites(CORRFLOW, B, N, False)
    assert calls == {"knn": [(B, N, N, K)], "correlation": [(B, N, N, K, W)]}
    # the encoder 3 -> W -> W on both clouds, the head W + K -> W, the
    # output W -> 3: the correlation is no product the dense count sees
    assert dense == 2 * (2 * B * N * (3 * W + W * W) + B * N * (W + K) * W
                         + B * N * W * 3)
    got = work.cell_work([(CORRFLOW, False)], dict(batch=B, points=N))
    corr = by_name("kernels", "correlation").work(B, N, N, K, W)
    knn = work.formula("knn").work(B, N, N, K)
    assert set(got["kernels"]) == {"knn", "correlation"}
    assert got["kernels"]["correlation"] == (
        corr[0] / B, corr[1] / B, work.bound_s(*corr) / B)
    assert got["flops"] == (dense + corr[0] + knn[0]) / B

    s = _stretch("void correlation_kernel<16>(float const*)", 1.0, got)
    want = 100.0 * got["kernels"]["correlation"][2] * 2 / 1e-6
    assert read_metric("correlation_roofline.eval", s) == pytest.approx(want)
    other = _stretch("void knn_kernel<32, 1>(float const*)", 1.0, got)
    assert read_metric("correlation_roofline.eval", other) is None
