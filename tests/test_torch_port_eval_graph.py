"""The eval forward's CUDA graphs (eval/graphs.py, eval/runner.py
make_eval_forward).

On the CPU: which models declare their forward free of host syncs, and
that the declaration holds in the aten ops a tiny forward dispatches; the
rule that decides between graph and eager; that the forward stays eager
here, bit-identical to the model's own call, with the counters saying so;
the launch counters' take-back and replay; and that perf's operation
count and profile read as before.

On the card (marker ``card``; each skips without one): the teacher at
8192 points graphed against eager over seeded pairs in rotation, a kept
result after the next request, new weights between requests, fg graphed
against eager in rotation (its feature kNN kernel 4 launches a request), a
trace around replays, and the operation count. This file imports
no JAX; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_eval_graph.py
"""

import json

import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from kd_pointcloud_tpu_torch.eval import graphs, make_eval_forward
from kd_pointcloud_tpu_torch.eval.runner import flow0_of, synthetic_pairs
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            tiny_config)
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.perf import (eval_graph_counts, flop_count,
                                          profile_model, trace)
from kd_pointcloud_tpu_torch.perf.trace import kernel_records

from torch_port_checks import card  # noqa: F401  (the card tests' gate)

torch.set_num_threads(1)

N = 256
SYNC_FREE = {"teacher": True, "lighttoken_res": True, "fg": True,
             "bifeat": True}
# aten ops that wait on the device from the host, or bring host data to it
HOST_SYNCS = {"aten.is_nonzero", "aten._local_scalar_dense", "aten.item",
              "aten.nonzero", "aten.nonzero_numpy", "aten.equal",
              "aten.masked_select", "aten._unique2", "aten.unique_dim",
              "aten.unique_consecutive", "aten.lift_fresh"}


def _model(name, seed=0, device="cpu", cfg=tiny_config):
    return BidPointFlowNet(cfg(name), device=device,
                           generator=torch.Generator().manual_seed(seed))


def _pair(seed=0, n=N):
    g = torch.Generator().manual_seed(seed)
    pc1 = torch.rand(1, n, 3, generator=g) * 4 - 2
    pc2 = pc1 + 0.1 * torch.randn(1, n, 3, generator=g)
    return pc1, pc2, pc1, pc2


def _direct(model, args):
    """The model's own call, as make_eval_forward made it before graphs."""
    with torch.inference_mode():
        return flow0_of(model(*args))


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, for the rule alone."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("name", sorted(SYNC_FREE))
def test_host_sync_free_by_model(name):
    model = _model(name)
    assert model.host_sync_free is SYNC_FREE[name]
    assert graphs.host_sync_free(model) is SYNC_FREE[name]


def test_model_without_the_property_is_not_sync_free():
    assert graphs.host_sync_free(nn.Linear(3, 3)) is False


@pytest.mark.parametrize("name", sorted(SYNC_FREE))
def test_declaration_holds_in_the_dispatched_ops(name):
    """A tiny eval forward, the kernels' plain versions hidden (they stand
    for kernels, which sync nothing): a sync-free model dispatches no op
    that waits on the device or reads the host, fg and bifeat's feature
    kNN (a kernel on the card) among them; a model that declared a sync
    would dispatch one."""
    fwd = make_eval_forward(_model(name))
    with kernels.counting(), _OpNames() as ops:
        fwd(*_pair())
    assert bool(ops.names & HOST_SYNCS) is not SYNC_FREE[name]


def test_engagement_rule(monkeypatch):
    """Graph only with a sync-free model out of training, inputs on the
    card, no count, no dispatch mode and no capture going on."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    model = _model("teacher")
    model.eval()
    on_card = [torch.Tensor._make_subclass(_OnCard, a) for a in _pair()]
    assert graphs.engages(True, model, on_card)
    assert not graphs.engages(False, model, on_card)
    assert not graphs.engages(True, model, _pair())
    with kernels.counting():
        assert not graphs.engages(True, model, on_card)
    with _OpNames():
        assert not graphs.engages(True, model, on_card)
    model.train()
    assert not graphs.engages(True, model, on_card)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    model.eval()
    assert not graphs.engages(True, model, on_card)


def test_signature_is_device_shapes_and_dtypes():
    a = _pair()
    assert graphs.signature(a) == graphs.signature(_pair(1))
    assert graphs.signature(a) != graphs.signature(_pair(0, N // 2))
    assert graphs.signature(a) != graphs.signature(
        [t.double() for t in a])


@pytest.mark.parametrize("name", ["teacher", "fg"])
def test_cpu_forward_is_eager_and_bit_identical(name):
    model = _model(name)
    fwd = make_eval_forward(model)
    kernels.reset_launches()
    for seed in (0, 1, 0):
        args = _pair(seed)
        assert torch.equal(fwd(*args), _direct(model, args))
    assert eval_graph_counts() == dict(captures=0, replays=0, eager=3)
    assert kernels.EVAL_GRAPHS == eval_graph_counts()
    assert not any(kernels.LAUNCHES.values())


def test_launch_counters_take_back_and_replay():
    kernels.reset_launches()
    kernels.LAUNCHES["knn"] = 5
    kernels.WIDTH_LAUNCHES["pool C=64"] = 1
    before = dict(kernels.LAUNCHES), dict(kernels.WIDTH_LAUNCHES)
    kernels.LAUNCHES["knn"] += 19
    kernels.LAUNCHES["pool"] += 12
    kernels.WIDTH_LAUNCHES["pool C=64"] += 3
    kernels.WIDTH_LAUNCHES["pool C=128"] = 9
    recorded = kernels.restore_launches(before)
    assert recorded == ({"knn": 19, "pool": 12},
                        {"pool C=64": 3, "pool C=128": 9})
    assert (kernels.LAUNCHES, kernels.WIDTH_LAUNCHES) == before
    kernels.add_launches(recorded)
    kernels.add_launches(recorded)
    assert kernels.LAUNCHES["knn"] == 5 + 38
    assert kernels.LAUNCHES["pool"] == 24
    assert kernels.WIDTH_LAUNCHES == {"pool C=64": 7, "pool C=128": 18}
    kernels.EVAL_GRAPHS["replays"] = 2
    kernels.reset_launches()
    assert eval_graph_counts() == dict(captures=0, replays=0, eager=0)
    assert not any(kernels.LAUNCHES.values()) and not kernels.WIDTH_LAUNCHES


def test_flop_count_and_profile_model_as_before():
    """flop_count of the eval forward equals the count of the model's own
    call, and profile_model reports it."""
    model = _model("teacher")
    args = _pair(2)
    want = flop_count(lambda *a: _direct(model, a), *args)
    assert flop_count(make_eval_forward(model), *args) == want
    stats = profile_model(model, *args, warmup=1, iters=1)
    assert {k: stats[k] for k in want} == want


# ------------------------------------------------------------------ card

POINTS = 8192
PAIRS = 6


@pytest.fixture(scope="module")
def pairs(card):
    return [tuple(torch.from_numpy(a)[None].to(card) for a in p[:4])
            for p in synthetic_pairs(PAIRS, POINTS, seed=7)]


def _card_model(name, seed, card):
    return _model(name, seed, card, cfg=lambda n: PRESETS[n])


@pytest.fixture(scope="module")
def teacher(card):
    return _card_model("teacher", 0, card).eval()


@pytest.mark.card
def test_graphed_teacher_is_bit_identical_in_rotation(teacher, pairs):
    want = [_direct(teacher, p) for p in pairs]
    fwd = make_eval_forward(teacher)
    kernels.reset_launches()
    for i in range(2 * PAIRS):
        got = fwd(*pairs[i % PAIRS])
        assert torch.equal(got, want[i % PAIRS]), i
    assert eval_graph_counts() == dict(captures=1, replays=2 * PAIRS - 1,
                                       eager=1)
    # every request ran the forward's kernels: fps 1, knn 19, pool 12
    assert {k: kernels.LAUNCHES[k] for k in ("fps", "knn", "pool")} == {
        "fps": 2 * PAIRS, "knn": 19 * 2 * PAIRS, "pool": 12 * 2 * PAIRS}


@pytest.mark.card
def test_kept_result_survives_the_next_request(teacher, pairs):
    fwd = make_eval_forward(teacher)
    kernels.reset_launches()
    kept = [fwd(*pairs[i]) for i in range(4)]
    copies = [k.clone() for k in kept]
    for i in range(4, 8):
        fwd(*pairs[i % PAIRS])
    torch.cuda.synchronize()
    assert eval_graph_counts()["replays"] > 0
    for k, c in zip(kept, copies):
        assert torch.equal(k, c)


@pytest.mark.card
def test_new_weights_show_in_the_replay(card, pairs):
    model = _card_model("teacher", 1, card)
    other = _card_model("teacher", 2, card).eval()
    fwd = make_eval_forward(model)
    kernels.reset_launches()
    for i in range(3):
        fwd(*pairs[i])
    model.load_state_dict(other.state_dict())
    assert torch.equal(fwd(*pairs[3]), _direct(other, pairs[3]))
    assert eval_graph_counts() == dict(captures=1, replays=3, eager=1)
    # storages replaced (the old ones held, so that none is reused):
    # captured again, never a stale replay
    held = [t.data for t in (*model.parameters(), *model.buffers())]
    model.cpu().to(card)
    assert torch.equal(fwd(*pairs[4]), _direct(other, pairs[4]))
    assert eval_graph_counts()["captures"] == 2
    del held


@pytest.mark.card
def test_graphed_fg_is_bit_identical_in_rotation(card, pairs):
    """fg's forward, sync-free with the feature kNN kernel, replays as a
    graph, bit-identical to eager; every request runs the kernel once a
    level (4 launches)."""
    model = _card_model("fg", 0, card).eval()
    want = [_direct(model, p) for p in pairs]
    fwd = make_eval_forward(model)
    kernels.reset_launches()
    for i in range(2 * PAIRS):
        got = fwd(*pairs[i % PAIRS])
        assert torch.equal(got, want[i % PAIRS]), i
    assert eval_graph_counts() == dict(captures=1, replays=2 * PAIRS - 1,
                                       eager=1)
    assert kernels.LAUNCHES["knn_features"] == 4 * 2 * PAIRS


@pytest.mark.card
def test_trace_of_graphed_requests(teacher, pairs, tmp_path):
    fwd = make_eval_forward(teacher)
    for i in range(2):
        fwd(*pairs[i])
    before = dict(kernels.LAUNCHES)
    replays = eval_graph_counts()["replays"]
    with trace(str(tmp_path)):          # raises where a record is lost
        for i in range(4):
            fwd(*pairs[i])
    assert eval_graph_counts()["replays"] == replays + 4
    with open(tmp_path / "trace.json") as f:
        traced = kernel_records(json.load(f)["traceEvents"])
    launched = {n: c - before[n] for n, c in kernels.LAUNCHES.items()
                if c > before[n]}
    assert traced == launched == {"fps": 4, "knn": 76, "pool": 48}


@pytest.mark.card
def test_flop_count_on_the_card_equals_eager(teacher, pairs):
    want = flop_count(lambda *a: _direct(teacher, a), *pairs[0])
    fresh = make_eval_forward(teacher)
    assert flop_count(fresh, *pairs[0]) == want
    for i in range(3):
        fresh(*pairs[i])
    assert eval_graph_counts()["replays"] > 0
    assert flop_count(fresh, *pairs[0]) == want
    assert np.isfinite(want["flops"]) and want["flops"] > 0
