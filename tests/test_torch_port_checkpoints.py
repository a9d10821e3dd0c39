"""The port's checkpoints and weight importers, on the CPU.

- Save / load / resume and the file naming, mirroring the JAX package's
  TestCheckpoints (tests/test_train.py): names, parse_epoch_from_name,
  best_checkpoint; a restored model, optimizer and bridge equal to the
  saved ones, bit for bit, and one more step from each agrees exactly.
- The reference .pth importer against the JAX package's importer plus
  params_from_jax, entry by entry, on evidence/fixtures/overfit_init.pth.
- The flax msgpack reader against the JAX package's reader (flax's
  msgpack_restore) plus params_from_jax, entry by entry, on
  evidence/fixtures/semitrained_teacher_30k.msgpack, and on a small tree
  that flax writes with chunked arrays and numpy scalars.
All comparisons are exact: the readers only copy and reshape.
"""

import importlib.util
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.models.torch_import import \
    load_torch_checkpoint as jax_load_torch_checkpoint
from kd_pointcloud_tpu.train import checkpoints as jax_ckpt
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet, Bridge,
                                            convert_state_dict,
                                            load_torch_checkpoint,
                                            params_from_jax, tiny_config)
from kd_pointcloud_tpu_torch.train import (best_checkpoint, full_state_tree,
                                           load_checkpoint,
                                           load_msgpack_checkpoint,
                                           load_msgpack_tree, make_optimizer,
                                           make_train_step,
                                           parse_epoch_from_name,
                                           restore_train_state,
                                           save_checkpoint)
from kd_pointcloud_tpu_torch.train.checkpoints import _ckpt_name

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "evidence" / "fixtures"
PTH = FIXTURES / "overfit_init.pth"
MSGPACK = FIXTURES / "semitrained_teacher_30k.msgpack"


def _model(seed):
    return BidPointFlowNet(tiny_config("teacher"), device="cpu",
                           generator=torch.Generator().manual_seed(seed))


def _batch(seed=0, n=256):
    rng = np.random.RandomState(seed)
    pc1 = rng.uniform(-2, 2, (2, n, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in
            dict(pos1=pc1, pos2=pc2, norm1=pc1, norm2=pc2,
                 flow=pc2 - pc1).items()}


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("epoch,epe", [(7, 0.1234), (123, 2.0), (0, 0.00005)])
def test_checkpoint_names_match_jax(epoch, epe):
    assert _ckpt_name("PointConv", epoch, epe) == \
        jax_ckpt._ckpt_name("PointConv", epoch, epe)
    path = f"/ckpts/{_ckpt_name('S', epoch, epe)}"
    assert parse_epoch_from_name(path) == jax_ckpt.parse_epoch_from_name(path)


def test_roundtrip_and_naming(tmp_path):
    model = _model(0)
    tree = {"model": model.state_dict()}
    p1 = save_checkpoint(str(tmp_path), "PointConv", 7, 0.1234, tree)
    p2 = save_checkpoint(str(tmp_path), "PointConv", 9, 0.0777, tree)
    assert Path(p1).name == "PointConv_007_0.1234"
    assert parse_epoch_from_name(p2) == 9
    assert best_checkpoint(str(tmp_path)) == p2
    assert best_checkpoint(str(tmp_path / "missing")) is None
    _assert_states_equal(load_checkpoint(p1)["model"], model.state_dict())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "PointConv_007_0.1234", "PointConv_009_0.0777"]


def test_full_state_resumes_bit_for_bit(tmp_path):
    """A model, its Adam state after two steps and a bridge with its own
    optimizer, saved and restored into fresh objects: equal state, and the
    next step from each gives equal parameters."""
    batch = _batch()
    model = _model(0)
    opt = make_optimizer(model)
    step = make_train_step(model, opt)
    for _ in range(2):
        step(batch)
    bridge = Bridge(8, 16, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    b_opt = make_optimizer(bridge)
    bridge(torch.ones(1, 4, 8), torch.ones(1, 4, 8))[0].sum().backward()
    b_opt.step()
    path = save_checkpoint(str(tmp_path), "S", 3, 0.25, full_state_tree(
        model, opt, 3, 0.25, extra={"bridge": bridge, "bridge_opt": b_opt}))

    fresh, fresh_bridge = _model(5), Bridge(8, 16, device="cpu")
    fresh_opt, fresh_b_opt = make_optimizer(fresh), make_optimizer(
        fresh_bridge)
    epoch, best_epe, restored = restore_train_state(
        path, fresh, fresh_opt, extra={"bridge": fresh_bridge,
                                       "bridge_opt": fresh_b_opt,
                                       "absent": torch.nn.Linear(1, 1)})
    assert (epoch, best_epe) == (3, 0.25)
    assert set(restored) == {"bridge", "bridge_opt"}
    _assert_states_equal(fresh.state_dict(), model.state_dict())
    _assert_states_equal(fresh_bridge.state_dict(), bridge.state_dict())
    assert fresh_b_opt.state_dict()["state"][0]["step"] == 1
    step(batch)
    make_train_step(fresh, fresh_opt)(batch)
    _assert_states_equal(fresh.state_dict(), model.state_dict())


def test_bare_checkpoint_takes_epoch_from_name(tmp_path):
    model = _model(0)
    path = save_checkpoint(str(tmp_path), "T", 42, 0.1234,
                           {"model": model.state_dict()})
    fresh = _model(9)
    opt = make_optimizer(fresh)
    epoch, best_epe, restored = restore_train_state(path, fresh, opt)
    assert (epoch, best_epe, restored) == (42, float("inf"), {})
    _assert_states_equal(fresh.state_dict(), model.state_dict())
    assert opt.state_dict()["state"] == {}


def test_pth_reader_matches_jax_importer():
    """The reference .pth of the overfit fixture: every entry of the port's
    state_dict equals the JAX importer's tree through params_from_jax; the
    BatchNorm step counters, which the JAX importer drops, are the file's."""
    got = load_torch_checkpoint(str(PTH))
    params, stats = jax_load_torch_checkpoint(str(PTH))
    want = params_from_jax({"params": params, "batch_stats": stats})
    assert set(got) == set(want)
    raw = torch.load(PTH, map_location="cpu", weights_only=True)["state_dict"]
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            src = k.replace(".convs.", ".pointconv_list.").replace(
                ".bn.", ".bn_linear.")
            assert torch.equal(v, raw[src]), k
        else:
            assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
    model = BidPointFlowNet(PRESETS["teacher"], device="cpu")
    model.load_state_dict(got, strict=True)


def test_pth_reader_refuses_unknown_keys_and_families():
    sd = torch.load(PTH, map_location="cpu", weights_only=True)["state_dict"]
    with pytest.raises(ValueError, match="unmapped"):
        convert_state_dict(dict(sd, **{"level9.extra": torch.zeros(1)}))
    with pytest.raises(ValueError, match="family"):
        convert_state_dict(sd, family="student")
    with pytest.raises(KeyError):       # a teacher file read as the FG family
        convert_state_dict(sd, family="fg")
    renamed = {f"module.{k}": v for k, v in sd.items()}
    assert set(convert_state_dict({"state_dict": renamed})) == \
        set(convert_state_dict(sd))


def _evidence_reader():
    spec = importlib.util.spec_from_file_location(
        "evidence_data", ROOT / "scripts" / "evidence_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_msgpack_tree


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_msgpack_reader_matches_flax():
    params, stats = load_msgpack_tree(str(MSGPACK))
    w_params, w_stats = _evidence_reader()(str(MSGPACK))
    for mine, want in ((params, w_params), (stats, w_stats)):
        mine, want = dict(_flat(mine)), dict(_flat(want))
        assert set(mine) == set(want)
        for k in want:
            assert mine[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(mine[k], np.asarray(want[k]))
    got = load_msgpack_checkpoint(str(MSGPACK))
    ref = params_from_jax({"params": w_params, "batch_stats": w_stats})
    _assert_states_equal(got, ref)
    model = BidPointFlowNet(PRESETS["teacher"], device="cpu")
    model.load_state_dict(got, strict=True)


def test_msgpack_reader_chunks_and_scalars(tmp_path, monkeypatch):
    """flax splits arrays above MAX_CHUNK_SIZE bytes into chunks and packs
    numpy scalars as their own extension type; the reader undoes both."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(2)
    tree = {"params": {"a": {"kernel": rng.standard_normal((7, 5))
                             .astype(np.float32)},
                       "b": np.arange(40, dtype=np.int32)},
            "batch_stats": {"n": np.float32(2.5), "m": np.int64(-3)}}
    path = tmp_path / "tree.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        jax.tree_util.tree_map(lambda x: x, tree)))
    params, stats = load_msgpack_tree(str(path))
    np.testing.assert_array_equal(params["a"]["kernel"],
                                  tree["params"]["a"]["kernel"])
    np.testing.assert_array_equal(params["b"], tree["params"]["b"])
    assert stats["n"] == np.float32(2.5) and stats["n"].dtype == np.float32
    assert stats["m"] == -3 and stats["m"].dtype == np.int64
