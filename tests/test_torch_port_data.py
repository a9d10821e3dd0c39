"""The port's config, logging and data pipeline against the JAX package's,
and the 2-D half of its metrics.

Every data test is an equality: the port copies numpy code, so the same
np.random.Generator seed gives the same samples and batches bit for bit
(with 0 or 1 loader workers; with a pool of 2 the batches hold the same
scenes in the same order, but which worker's random stream transforms a
batch is not reproducible). The trees are small seeded HPLFlowNet-layout
trees (data.synthetic); the FT3D scene counts are lowered for them with
monkeypatch, on the JAX classes and the port's alike.

2-D metrics: the projection divides by z + constz in float32, which rounds
differently between XLA and torch; EPE2D is held to 1e-5 relative and ACC2D
to the sample's exact count of points under the thresholds, where no point
lies within float32 rounding of a threshold.
"""

import os.path as osp
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.data import datasets as jax_datasets
from kd_pointcloud_tpu.data import loader as jax_loader
from kd_pointcloud_tpu.data import native_io as jax_native_io
from kd_pointcloud_tpu.data import transforms as jax_tf
from kd_pointcloud_tpu.eval import geometry as jax_geometry
from kd_pointcloud_tpu.eval import metrics as jax_metrics
from kd_pointcloud_tpu.eval import runner as jax_runner
from kd_pointcloud_tpu.utils import config as jax_config
from kd_pointcloud_tpu.utils import logging as jax_logging
from kd_pointcloud_tpu_torch.data import (datasets, loader, native_io,
                                          synthetic, transforms)
from kd_pointcloud_tpu_torch.eval import geometry, metrics, runner
from kd_pointcloud_tpu_torch.utils import config, logging as port_logging

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = osp.join(ROOT, "kd_pointcloud_tpu", "configs")
YAMLS = ("train_teacher_ft3d", "evaluate_kitti", "distill_kd",
         "distill_bridge", "fast_distill")
N_POINTS = 256
N_TRAIN, N_VAL = 8, 5
KITTI_MAPPED = (3, 17, 42, 150)
AUG_TOGETHER = dict(degree_range=0.1745329252, shift_range=1.0,
                    scale_low=0.95, scale_high=1.05, jitter_sigma=0.01,
                    jitter_clip=0.0)
AUG_PC2 = dict(degree_range=0.0, shift_range=0.3, jitter_sigma=0.01,
               jitter_clip=0.0)


def _equal(a, b):
    """Samples or batches equal: arrays bit for bit, paths as strings."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    ft3d = synthetic.write_ft3d_tree(str(base / "ft3d"), N_TRAIN, N_VAL,
                                     300, seed=1)
    kitti_root, calib = synthetic.write_kitti_tree(
        str(base / "kt"), KITTI_MAPPED, 400, seed=2)
    return dict(ft3d=ft3d, kitti=kitti_root, calib=calib)


@pytest.fixture
def counts(monkeypatch):
    """The FT3D classes of both packages, counts lowered to the tree's."""
    for mod in (jax_datasets, datasets):
        monkeypatch.setattr(mod.FlyingThings3DSubset, "TRAIN_COUNT", N_TRAIN)
        monkeypatch.setattr(mod.FlyingThings3DSubset, "VAL_COUNT", N_VAL)


def _pair(rng, n=500):
    pc1 = rng.uniform([-10, -3, 0], [10, 3, 45], (n, 3)).astype(np.float32)
    pc2 = (pc1 + 0.2 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return pc1, pc2


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("no_corr", [True, False])
@pytest.mark.parametrize("num_points,allow_less", [(256, False),
                                                   (1024, False),
                                                   (1024, True), (0, False)])
def test_process_data_matches_jax(no_corr, num_points, allow_less):
    pair = _pair(np.random.default_rng(0))
    kw = dict(depth_threshold=35.0, no_corr=no_corr, num_points=num_points,
              allow_less_points=allow_less)
    want = jax_tf.ProcessData(**kw)(pair, np.random.default_rng(5))
    got = transforms.ProcessData(**kw)(pair, np.random.default_rng(5))
    _equal(got, want)


@pytest.mark.parametrize("no_corr", [True, False])
@pytest.mark.parametrize("depth", [35.0, 0.0])
def test_augmentation_matches_jax(no_corr, depth):
    pair = _pair(np.random.default_rng(1))
    kw = dict(depth_threshold=depth, no_corr=no_corr, num_points=256)
    rngs = np.random.default_rng(7), np.random.default_rng(7)
    want = jax_tf.Augmentation(AUG_TOGETHER, AUG_PC2, **kw)(pair, rngs[0])
    got = transforms.Augmentation(AUG_TOGETHER, AUG_PC2, **kw)(pair, rngs[1])
    _equal(got, want)
    # the generators moved alike
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


def test_transform_helpers_match_jax():
    pc1, pc2 = _pair(np.random.default_rng(2))
    for t in (35.0, 10.0, 0.0):
        np.testing.assert_array_equal(transforms._depth_mask(pc1, pc2, t),
                                      jax_tf._depth_mask(pc1, pc2, t))
    np.testing.assert_array_equal(transforms._rot_y(0.3), jax_tf._rot_y(0.3))
    idx = np.arange(0, 500, 3)
    for n, no_corr in ((100, True), (400, False), (400, True)):
        got = transforms._sample_indices(idx, n, no_corr,
                                         np.random.default_rng(3))
        want = jax_tf._sample_indices(idx, n, no_corr,
                                      np.random.default_rng(3))
        _equal(got, want)


def test_empty_after_depth_mask_is_none():
    pc = np.full((10, 3), 50.0, np.float32)
    for mod in (transforms, jax_tf):
        assert mod.ProcessData()((pc, pc), np.random.default_rng(0)) == (
            None, None, None)


# -------------------------------------------------------------- datasets

@pytest.mark.parametrize("train,full", [(True, True), (True, False),
                                        (False, True)])
def test_ft3d_samples_match_jax(trees, counts, train, full):
    """Sample by sample, with the sign flips: pc1 is the stored cloud with
    x and z negated, before sampling."""
    tf = transforms.ProcessData(num_points=N_POINTS)
    jtf = jax_tf.ProcessData(num_points=N_POINTS)
    ds = datasets.FlyingThings3DSubset(train, tf, trees["ft3d"], full=full,
                                       seed=3)
    jds = jax_datasets.FlyingThings3DSubset(train, jtf, trees["ft3d"],
                                            full=full, seed=3)
    assert ds.samples == jds.samples
    assert len(ds) == ((N_TRAIN + 3) // 4 if train and not full
                       else N_TRAIN if train else N_VAL)
    for i in range(len(ds)):
        _equal(ds[i], jds[i])
    raw = np.load(osp.join(ds.samples[0], "pc1.npy"))
    pc1, _ = ds.pc_loader(ds.samples[0])
    np.testing.assert_array_equal(pc1, raw * np.float32([-1, 1, -1]))


def test_ft3d_min_reads_its_own_root(tmp_path, monkeypatch):
    cls = datasets.FlyingThings3DSubsetMin
    root = synthetic.write_ft3d_tree(str(tmp_path), 2, 1, 50,
                                     dirname=cls.DIRNAME)
    monkeypatch.setattr(cls, "TRAIN_COUNT", 2)
    monkeypatch.setattr(cls, "VAL_COUNT", 1)
    assert len(cls(False, transforms.ProcessData(num_points=32), root)) == 1


def test_strict_scene_counts_end_the_run(trees):
    """The real counts (19640 / 3824, 200) against a small tree: both
    packages exit."""
    tf = transforms.ProcessData()
    for cls in (datasets.FlyingThings3DSubset,
                jax_datasets.FlyingThings3DSubset):
        with pytest.raises(SystemExit):
            cls(True, tf, trees["ft3d"])
    with pytest.raises(SystemExit):
        datasets.KITTI(False, tf, osp.join(trees["ft3d"], "missing"))
    ds = datasets.FlyingThings3DSubset(True, tf, trees["ft3d"],
                                       strict_counts=False)
    assert len(ds) == N_TRAIN


def test_kitti_samples_match_jax(trees):
    """The mapping filter keeps the mapped scenes of 200; ground rows (y <
    -1.4 in both clouds) are removed; samples equal JAX's."""
    mapping = osp.join(trees["kitti"], "KITTI_mapping.txt")
    tf = transforms.ProcessData(num_points=N_POINTS)
    ds = datasets.KITTI(False, tf, trees["kitti"], seed=4)
    jds = jax_datasets.KITTI(False, jax_tf.ProcessData(num_points=N_POINTS),
                             trees["kitti"], seed=4, mapping_path=mapping)
    assert ds.samples == jds.samples
    assert [int(osp.basename(p)) for p in ds.samples] == list(KITTI_MAPPED)
    for i in range(len(ds)):
        _equal(ds[i], jds[i])
    raw1 = np.load(osp.join(ds.samples[0], "pc1.npy"))
    raw2 = np.load(osp.join(ds.samples[0], "pc2.npy"))
    ground = (raw1[:, 1] < -1.4) & (raw2[:, 1] < -1.4)
    assert 0 < ground.sum() < len(raw1)
    pc1, pc2 = ds.pc_loader(ds.samples[0])
    np.testing.assert_array_equal(pc1, raw1[~ground])
    np.testing.assert_array_equal(pc2, raw2[~ground])
    full1, _ = datasets.KITTI(False, tf, trees["kitti"],
                              remove_ground=False).pc_loader(ds.samples[0])
    np.testing.assert_array_equal(full1, raw1)


def test_failed_sample_resamples_like_jax(tmp_path, counts):
    """A scene with no point inside the depth threshold is replaced by a
    random other scene, drawn from the same generator."""
    root = synthetic.write_ft3d_tree(str(tmp_path), N_TRAIN, N_VAL, 80,
                                     seed=6)
    far = osp.join(root, datasets.FlyingThings3DSubset.DIRNAME, "val",
                   f"{0:07d}")
    for name in ("pc1.npy", "pc2.npy"):
        np.save(osp.join(far, name), np.full((80, 3), -60.0, np.float32))
    ds = datasets.FlyingThings3DSubset(
        False, transforms.ProcessData(num_points=32), root, seed=9)
    jds = jax_datasets.FlyingThings3DSubset(
        False, jax_tf.ProcessData(num_points=32), root, seed=9)
    got, want = ds[0], jds[0]
    _equal(got, want)
    assert got[5] != ds.samples[0]


# ---------------------------------------------------------------- loader

def _loaders(trees, batch, **kw):
    tf = transforms.ProcessData(num_points=N_POINTS)
    jtf = jax_tf.ProcessData(num_points=N_POINTS)
    ds = datasets.FlyingThings3DSubset(False, tf, trees["ft3d"], seed=2)
    jds = jax_datasets.FlyingThings3DSubset(False, jtf, trees["ft3d"],
                                            seed=2)
    return (loader.DataLoader(ds, batch, seed=11, **kw),
            jax_loader.DataLoader(jds, batch, seed=11, **kw))


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("shuffle,pad_last,drop_last", [
    (False, True, False), (True, True, False), (True, False, True),
    (False, False, False)])
def test_batches_match_jax(trees, counts, workers, shuffle, pad_last,
                           drop_last):
    mine, theirs = _loaders(trees, 2, shuffle=shuffle, pad_last=pad_last,
                            drop_last=drop_last, num_workers=workers)
    assert len(mine) == len(theirs)
    for _ in range(2):                  # two epochs: the shuffle moves on
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == len(mine)
        for g, w in zip(got, want):
            _equal(g, w)
            assert loader.valid_count(g) == jax_loader.valid_count(w)
    last = got[-1]
    assert last[0].shape[0] == (2 if pad_last or drop_last else 1)
    assert loader.valid_count(last) == (
        2 if drop_last else 1 if N_VAL % 2 else 2)


def test_pool_batches_are_the_same_scenes(trees, counts):
    """Two fork workers: the same scenes in the same order as the
    in-process loader, padded alike, each cloud of the right shape."""
    seq, _ = _loaders(trees, 2, shuffle=True, pad_last=True, num_workers=0)
    pool, _ = _loaders(trees, 2, shuffle=True, pad_last=True, num_workers=2)
    try:
        for _ in range(2):
            want = [b[5] for b in seq]
            got = list(pool)
            assert [b[5] for b in got] == want
            for b in got:
                assert all(a.shape == (2, N_POINTS, 3) and
                           a.dtype == np.float32 for a in b[:5])
        # an abandoned iteration cancels its pending batches
        next(iter(pool))
    finally:
        pool.close()
        pool.close()
    assert pool._pool is None


def test_collate_pad_batch_valid_count_match_jax():
    rng = np.random.default_rng(8)
    samples = [tuple(rng.standard_normal((6, 3)).astype(np.float32)
                     for _ in range(5)) + (f"s{i}",) for i in range(3)]
    got, want = loader.collate(samples), jax_loader.collate(samples)
    _equal(got, want)
    _equal(loader.pad_batch(got, 5), jax_loader.pad_batch(want, 5))
    assert loader.valid_count(loader.pad_batch(got, 5)) == 3
    assert loader.PAD_PATH == jax_loader.PAD_PATH


def test_train_loop_pads_with_the_loaders_sentinel():
    from kd_pointcloud_tpu_torch.train import loop

    assert loop.PAD_PATH is loader.PAD_PATH


def test_native_reader_matches_numpy(trees, tmp_path):
    """The native reader is built into build/native/ and reads what numpy
    reads, float64 files converted to float32; the JAX package's reader
    agrees."""
    assert native_io.available()
    assert native_io.BUILD_DIR.parts[-2:] == ("build", "native")
    scene = osp.join(trees["kitti"], "kitti_processed",
                     f"{KITTI_MAPPED[0]:06d}")
    paths = [osp.join(scene, "pc1.npy"), osp.join(scene, "pc2.npy")]
    f64 = str(tmp_path / "f64.npy")
    np.save(f64, np.random.default_rng(0).standard_normal((7, 3)))
    paths.append(f64)
    got = native_io.read_batch(paths, n_threads=2)
    for p, g in zip(paths, got):
        want = np.load(p).astype(np.float32)
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(native_io.npy_read(p), want)
        assert native_io.npy_info(p) == want.shape
    for p, g in zip(paths, jax_native_io.read_batch(paths)):
        np.testing.assert_array_equal(g, native_io.npy_read(p))
    with pytest.raises(IOError):
        native_io.read_batch([str(tmp_path / "missing.npy")])


def test_data_modules_import_no_torch():
    code = ("import sys\n"
            "import kd_pointcloud_tpu_torch.data as d\n"
            "import kd_pointcloud_tpu_torch.utils\n"
            "import kd_pointcloud_tpu_torch.data.synthetic\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------- config, logs

@pytest.mark.parametrize("name", YAMLS)
def test_configs_parse_like_jax(name):
    path = osp.join(CONFIGS, name + ".yaml")
    assert config.parse_args_from_yaml(path) == \
        jax_config.parse_args_from_yaml(path)


def test_config_rules_match_jax():
    base = dict(dataset="KITTI", data_root="/data", custom_lr=True,
                lrs="0.001,0.0005,0.0001", lr_switch_epochs="0,100,200")
    got = config.postprocess(config.Config(base))
    want = jax_config.postprocess(jax_config.Config(base))
    assert got == want and got.lr == 0.001
    assert got.lrs == [0.0001, 0.0005, 0.001]
    assert got.data_root == "/data" and got.allow_less_points is False
    nested = config.Config(dict(a=dict(b=[dict(c=1)])))
    assert nested.a.b[0].c == 1
    for bad in (dict(base, dataset="Other"),
                {k: v for k, v in base.items() if k != "data_root"},
                dict(base, evaluate=True),
                dict(base, lr_switch_epochs="0,200,100")):
        with pytest.raises(ValueError):
            config.postprocess(config.Config(bad))
        with pytest.raises(AssertionError):
            jax_config.postprocess(jax_config.Config(bad))


def test_logging_utils_match_jax(tmp_path):
    mine, theirs = port_logging.AverageMeter(), jax_logging.AverageMeter()
    ma, jma = port_logging.MovingAverage(3), jax_logging.MovingAverage(3)
    for v, n in ((1.5, 2), (4.0, 1), (-2.0, 3), (0.25, 1)):
        mine.update(v, n)
        theirs.update(v, n)
        ma.update(v)
        jma.update(v)
        assert (mine.avg, mine.val, mine.count, ma.avg) == (
            theirs.avg, theirs.val, theirs.count, jma.avg)
    run = port_logging.make_experiment_dir(str(tmp_path), "X", tag="-KD")
    assert osp.basename(run).startswith("PointConvX-KD-")
    assert osp.isdir(osp.join(run, "checkpoints"))
    assert osp.isdir(osp.join(run, "logs"))
    log_path = osp.join(run, "logs", "l.txt")
    logger = port_logging.make_logger("port-test", log_path,
                                      to_stdout=False)
    logger.info("hello %d", 3)
    port_logging.make_logger("port-test")           # closes the file
    assert open(log_path).read().rstrip().endswith("hello 3")
    assert port_logging.blue("a") == jax_logging.blue("a")


# ------------------------------------------------------------ 2-D metrics

def test_read_kitti_intrinsics_matches_jax(trees):
    name = f"{KITTI_MAPPED[1]:06d}"
    got = geometry.read_kitti_intrinsics(name, trees["calib"])
    want = jax_geometry.read_kitti_intrinsics(name, trees["calib"])
    assert set(got) == set(geometry.INTRINSIC_KEYS) == set(want)
    for k in got:
        assert got[k] == want[k] and got[k].dtype == np.float32
    assert got["f"] < 0                 # f = -P[0, 0]
    assert geometry.calib_dir_for(trees["kitti"]) == trees["calib"]
    bad = osp.join(trees["calib"], "nocalib.txt")
    with open(bad, "w") as fd:
        fd.write("S_02: 1 2\n")
    with pytest.raises(ValueError):
        geometry.read_kitti_intrinsics("nocalib", trees["calib"])


def _flows(seed, n=400, b=3):
    """Clouds in front of a camera and predictions whose pixel errors
    straddle ACC2D's thresholds (3 px, 5 %)."""
    rng = np.random.default_rng(seed)
    pc1 = rng.uniform([-10, -2, 5], [10, 2, 40], (b, n, 3)).astype(
        np.float32)
    flow = (0.5 * rng.standard_normal(pc1.shape)).astype(np.float32)
    pred = (flow + 0.06 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return pc1, flow, pred


@pytest.mark.parametrize("kitti", [False, True])
def test_batch_2d_flow_and_metrics_match_jax(trees, kitti):
    pc1, flow, pred = _flows(3)
    if kitti:
        paths = [osp.join(trees["kitti"], "kitti_processed", f"{i:06d}")
                 for i in KITTI_MAPPED[:3]]
    else:
        paths = ["ft3d/val/0000000"] * 3
    got = geometry.get_batch_2d_flow(pc1, pc1 + flow, pc1 + pred, paths,
                                     trees["calib"])
    want = jax_geometry.get_batch_2d_flow(pc1, pc1 + flow, pc1 + pred, paths,
                                          trees["calib"])
    _equal(got, want)
    accs = []
    for b in range(3):
        g = metrics.evaluate_2d(got[0][b], got[1][b])
        w = jax_metrics.evaluate_2d(want[0][b], want[1][b])
        assert g == w
        accs.append(g[1])
    assert 0.05 < min(accs) and max(accs) < 0.95   # straddles a threshold
    # the batched versions: the port's projection and metrics in torch
    # against JAX's, on the same intrinsics rows
    intr = runner._intrinsics_for(paths, trees["calib"])
    np.testing.assert_array_equal(
        intr, np.asarray([[(geometry.read_kitti_intrinsics(
            osp.basename(p), trees["calib"]) if kitti else
            geometry.FT3D_INTRINSICS)[k] for k in geometry.INTRINSIC_KEYS]
            for p in paths], np.float32))
    tp = [torch.from_numpy(a) for a in (pc1, flow, pred, intr)]
    px1 = runner.project_points(tp[0], tp[3])
    f_pred = runner.project_points(tp[0] + tp[2], tp[3]) - px1
    f_gt = runner.project_points(tp[0] + tp[1], tp[3]) - px1
    jpx1 = jax_runner.project_points(jnp.asarray(pc1), jnp.asarray(intr))
    np.testing.assert_allclose(px1.numpy(), np.asarray(jpx1), rtol=1e-6)
    epe2d, acc2d = (t.numpy() for t in metrics.evaluate_2d_torch(f_pred,
                                                                 f_gt))
    jepe, jacc = (np.asarray(t) for t in jax_metrics.evaluate_2d_jax(
        jax_runner.project_points(jnp.asarray(pc1 + pred), jnp.asarray(intr))
        - jpx1, jax_runner.project_points(jnp.asarray(pc1 + flow),
                                          jnp.asarray(intr)) - jpx1))
    np.testing.assert_allclose(epe2d, jepe, rtol=1e-5)
    n = pc1.shape[1]                    # ACC2D as counts of points
    np.testing.assert_array_equal(np.rint(acc2d * n), np.rint(jacc * n))
    np.testing.assert_allclose(epe2d, [float(w[0]) for w in (
        metrics.evaluate_2d(got[0][b], got[1][b]) for b in range(3))],
        rtol=1e-5)


def test_kitti_2d_needs_calibration(trees):
    paths = [osp.join(trees["kitti"], "kitti_processed", "000003")]
    with pytest.raises(ValueError, match="calib_dir"):
        runner._intrinsics_for(paths)
    with pytest.raises(ValueError, match="calib_dir"):
        geometry.get_batch_2d_flow(*(np.zeros((1, 2, 3), np.float32),) * 3,
                                   paths)
