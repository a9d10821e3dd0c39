"""PointPWC-Net on the port's normal path (models/bid_pointflow.py
cross="pwc", the preset pointpwc) against the benchmark's plain reference,
benchmark/reference/nets/pointpwc.py, at tiny_config on the CPU: one set of
seeded weights (benchmark/inputs.py seeded_weights) loaded strictly into
both; every level's flow in eval and train mode; one make_train_step
against the reference's supervised step (loss, every gradient, every
parameter after Adam, BatchNorm statistics); what check_config and the
reference refuse; the host-sync freedom that lets the forward be captured;
the published widths; and the cost volume's reported work against the
benchmark's formula at the reference's recorded sites.

No JAX: the JAX package has no such wiring.
"""

import dataclasses

import pytest
import torch

from benchmark import check, program, work
from benchmark.harness import Cell
from benchmark.inputs import batch_of, scene_pairs, seeded_weights
from benchmark.reference.train import Adam, multi_scale_loss
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            check_config, tiny_config)
from kd_pointcloud_tpu_torch.nn import SceneFlowEstimatorPointConv
from kd_pointcloud_tpu_torch.nn.experimental import PointConvFlow
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.perf import flop_count
from kd_pointcloud_tpu_torch.train import make_optimizer
from kd_pointcloud_tpu_torch.train.loop import make_train_step

torch.set_num_threads(2)

B, N = 2, 256
SEEDS = (2 ** 31 + 11, 2 ** 32 + 5)
LR, WD = 1e-3, 1e-4
# flows: the port and the reference run the same float32 operations in the
# same order on this path (they read bit-identical here); 1e-5 leaves room
# for a reordered sum of the cost volume's 16 neighbours
FLOW_TOL = 1e-5
# the loss: a sum of a few hundred norms, as the flows above
LOSS_RTOL = 1e-6
# a gradient, per parameter, over that parameter's largest entry: the two
# backwards add the same terms in another order (float32; 1e-6 measured)
GRAD_RTOL = 1e-5
# a parameter after one Adam step moves by lr g / (|g| + eps): an entry
# whose gradient is within rounding of zero may step by up to lr of either
# sign, any other by nearly lr the same way on both sides (6.2e-6 the
# largest gap measured over three seeds); a tenth of lr
PARAM_TOL = LR / 10


def _entry(cfg=None) -> dict:
    """A configuration file's model entry of cfg (tiny_config("pointpwc")
    by default), naming the benchmark's pointpwc reference."""
    d = dataclasses.asdict(cfg or tiny_config("pointpwc"))
    d = {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}
    return dict(d, reference="pointpwc")


def _pair(seed):
    """The two models on one set of seeded weights, and a batch of B
    KITTI-shaped pairs of N points (pointpwc-train-b8's scene)."""
    entry = _entry()
    w = seeded_weights(check.meta_model(entry), seed, "model", "cpu")
    port = program.model(entry, w, "cpu")
    ref = check.reference_model(entry, w, "cpu")
    scene = Cell("pointpwc-train-b8").workload["scene"]
    batch = batch_of(scene_pairs(scene, B, N, seed, "cpu"), list(range(B)))
    return port, ref, batch


def _args(batch):
    return batch["pos1"], batch["pos2"], batch["norm1"], batch["norm2"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_every_level_flow_matches_reference(seed, mode):
    port, ref, batch = _pair(seed)
    port.train(mode == "train")
    ref.train(mode == "train")
    with torch.no_grad():
        got, want = port(*_args(batch)), ref(*_args(batch))
    assert len(got["flows"]) == len(want["flows"]) == 4
    for lvl, (a, b) in enumerate(zip(got["flows"], want["flows"])):
        assert a.shape == b.shape == (B, tiny_config("pointpwc").npoints[lvl],
                                      3)
        assert float((a - b).abs().max()) <= FLOW_TOL, lvl
        assert float(b.abs().max()) <= 200.0        # the heads' clamp
    for key in ("fps_idx1", "fps_idx2"):
        for a, b in zip(got[key], want[key]):
            assert torch.equal(a.int(), b.int())


@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_matches_reference(seed):
    """One make_train_step (default loss) against the reference's
    supervised step: the loss, every gradient, every parameter after Adam
    and the heads' BatchNorm statistics."""
    port, ref, batch = _pair(seed)
    step = make_train_step(port, make_optimizer(port, LR, WD))
    loss = float(step(batch))

    ref.train()
    out = ref(*_args(batch))
    ref_loss = multi_scale_loss(out["flows"], batch["flow"], out["fps_idx1"])
    ref_loss.backward()
    grads = {n: p.grad.clone() for n, p in ref.named_parameters()}
    Adam(ref.parameters(), LR, WD).step()

    want = float(ref_loss.detach())
    assert abs(loss - want) <= LOSS_RTOL * abs(want)
    got = dict(port.named_parameters())
    assert got.keys() == grads.keys()
    for name, g in grads.items():
        scale = float(g.abs().max())
        assert scale > 0, name                  # every parameter is used
        assert float((got[name].grad - g).abs().max()) <= GRAD_RTOL * scale, \
            name
    for name, p in ref.named_parameters():
        assert float((got[name].detach() - p.detach()).abs().max()) \
            <= PARAM_TOL, name
    stats = {k: v for k, v in ref.state_dict().items() if "running" in k}
    assert stats
    for k, v in stats.items():
        assert torch.allclose(port.state_dict()[k], v, rtol=1e-6, atol=1e-7), k


@pytest.mark.parametrize("field,value", [("iters", 2), ("coarse_warp", (0,)),
                                         ("swap_interlevel", True),
                                         ("encoder", "pointconv")])
def test_check_config_refuses_what_pwc_does_not_build(field, value):
    cfg = dataclasses.replace(tiny_config("pointpwc"), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        check_config(cfg)
    with pytest.raises(NotImplementedError, match=field):
        BidPointFlowNet(cfg, device="cpu")
    # the light wiring builds each of them
    check_config(dataclasses.replace(cfg, cross="light"))


@pytest.mark.parametrize("field,value", [("iters", 2), ("cross", "light"),
                                         ("encoder", "pointconv"),
                                         ("coarse_warp", [0]),
                                         ("radius", 0.5)])
def test_reference_refuses_what_it_does_not_build(field, value):
    with pytest.raises(ValueError, match=field):
        check.meta_model(dict(_entry(), **{field: value}))


def test_forward_is_host_sync_free():
    """No layer syncs the host, so make_eval_forward may capture it as a
    CUDA graph, as the teacher's."""
    model = BidPointFlowNet(tiny_config("pointpwc"), device="cpu")
    assert model.host_sync_free


def test_published_widths():
    """PRESETS["pointpwc"] builds PointPWC-Net's widths: cost volumes over
    131, 195, 387 and 643 grouped channels (32-NN, MLP (c, c)), heads that
    take the flow at l0-l2 and none at l3, 7.72 M parameters (the paper's
    count; the heads' BatchNorm adds 2048)."""
    cfg = PRESETS["pointpwc"]
    assert cfg.cross == "pwc" and cfg.npoints == (8192, 2048, 512, 256, 64)
    model = BidPointFlowNet(cfg, device="cpu")
    for lvl, (grouped, c) in enumerate(((131, 32), (195, 64), (387, 128),
                                        (643, 256))):
        cross = getattr(model, f"cross{lvl}")
        assert isinstance(cross, PointConvFlow) and cross.nsample == 32
        assert cross.dense.weight.shape == (c, grouped)
        assert cross.dense1.weight.shape == (c, c)
        head = getattr(model, f"flow{lvl}")
        assert isinstance(head, SceneFlowEstimatorPointConv)
        feat = c if lvl == 3 else c + 64
        flow = 0 if lvl == 3 else 3
        assert head.convs[0].dense.weight.shape[1] == 16 * (3 + feat + c
                                                            + flow)
    params = sum(p.numel() for p in model.parameters())
    assert params == 7719340
    assert params == sum(p.numel() for p in
                         check.meta_model(_entry(cfg)).parameters())


def test_cost_volume_count_matches_benchmark():
    """Inside ops.kernels.counting() each cost volume reports its call as
    "cost_volume": one a level, and the same operations and bytes as the
    benchmark's formula (kernels/cost_volume.py) at the reference's
    recorded sites; the count's totals leave it out (FlopCounterMode sees
    its products), so a model's operations stay the dense count plus the
    kernels'."""
    port, _, batch = _pair(SEEDS[0])
    port.eval()
    with kernels.counting() as count, torch.no_grad():
        port(*_args(batch))
    _, calls = work.forward_sites(_entry(), B, N, False)
    sites = calls["cost_volume"]
    assert len(sites) == count.calls["cost_volume"] == 4
    formula = work.formula("cost_volume")
    assert formula.IN_DENSE_COUNT
    assert count.ops["cost_volume"] == sum(formula.work(*s)[0] for s in sites)
    assert count.bytes["cost_volume"] == sum(formula.work(*s)[1]
                                             for s in sites)
    assert count.total_ops == sum(v for n, v in count.ops.items()
                                  if n != "cost_volume")
    with torch.no_grad():
        stats = flop_count(port, *_args(batch))
    assert stats["by_kernel"]["cost_volume"]["calls"] == 4
    assert stats["kernel_flops"] == count.total_ops
    assert stats["flops"] == stats["dense_flops"] + count.total_ops
