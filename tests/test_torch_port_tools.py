"""The port's tooling around the model against the JAX package's, on the
CPU: the licensing band and its KITTI sweep (eval/licensing.py), fixture
resolution (utils/fixtures.py), and the raw-data preprocessors with their
PNG codec (data/preprocess/).

The preprocessors run on seeded raw frames written to a temporary
directory (data/synthetic.py: PFM, .flo, 8-bit and 16-bit PNGs, a
P_rect_02 calib line); their .npy files must be the JAX preprocessors'
byte for byte, and the codec must decode what PIL writes as PIL does.
"""

import os
import os.path as osp
import struct
import sys
import tempfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from kd_pointcloud_tpu.data.preprocess import ft3d as jax_ft3d
from kd_pointcloud_tpu.data.preprocess import kitti as jax_kitti
from kd_pointcloud_tpu.eval import licensing as jax_licensing
from kd_pointcloud_tpu.eval.metrics import evaluate_2d as jax_evaluate_2d
from kd_pointcloud_tpu.eval.metrics import evaluate_3d as jax_evaluate_3d
from kd_pointcloud_tpu_torch.data import synthetic
from kd_pointcloud_tpu_torch.data.preprocess import ft3d, io, kitti, png16
from kd_pointcloud_tpu_torch.eval import licensing
from kd_pointcloud_tpu_torch.models import BidPointFlowNet, tiny_config
from kd_pointcloud_tpu_torch.utils import fixtures

torch.set_num_threads(1)


# ----------------------------------------------------------------- licensing

def test_band_constants_are_jax_s():
    assert licensing.BAND == jax_licensing.BAND
    assert licensing.LOWER_BETTER == jax_licensing.LOWER_BETTER
    assert licensing.METRIC_NAMES == jax_licensing.METRIC_NAMES


def _band_cases():
    """tests/test_licensing.py's four cases as (delta, verdict) pairs."""
    cases = [("zero", np.zeros(6), True),
             ("improvements", np.array([-1.0, 1.0, 1.0, -1.0, -1.0, 1.0]),
              True)]
    for i, (b, lb) in enumerate(zip(licensing.BAND, licensing.LOWER_BETTER)):
        for scale, ok in ((1.01, False), (0.99, True)):
            d = np.zeros(6)
            d[i] = b * scale if lb else -b * scale
            cases.append((f"{licensing.METRIC_NAMES[i]} x{scale}", d, ok))
    cases.append(("round5 production", np.array(
        [2e-06, -0.000378, -0.000251, -0.00083, -0.001887, 0.000144]), True))
    cases.append(("round5 K=24 at l0", np.array(
        [0.000746, -0.005132, -0.002751, 0.001223, 0.034701, -0.005347]),
        False))
    return cases


@pytest.mark.parametrize("label,delta,verdict", _band_cases(),
                         ids=[c[0] for c in _band_cases()])
def test_in_band_reproduces_jax_cases(label, delta, verdict):
    assert licensing.in_band(delta) is verdict
    assert jax_licensing.in_band(delta) is verdict


def _project(pc, P):
    """utils/geometry.py's projection with a KITTI P_rect_02 (f = -P00)."""
    x = (pc[..., 0] * -P[0, 0] + P[0, 2] * pc[..., 2] + P[0, 3]) \
        / (pc[..., 2] + P[2, 3])
    y = (pc[..., 1] * -P[0, 0] + P[1, 2] * pc[..., 2] + P[1, 3]) \
        / (pc[..., 2] + P[2, 3])
    return np.stack([x, y], -1)


def test_sweep_rows_equals_a_hand_computation(tmp_path):
    """load_scenes + sweep_rows on a seeded KITTI tree: each row is the
    six metrics of the model's flow on that scene, computed here with the
    JAX package's numpy metrics and the calib file's P_rect_02."""
    data_root, calib_dir = synthetic.write_kitti_tree(
        str(tmp_path), mapped=(0, 1, 5), n_points=600)
    scenes = licensing.load_scenes(2, 256, data_root)
    assert [osp.basename(s[3]) for s in scenes] == ["000000", "000001"]
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    rows = licensing.sweep_rows(model, scenes, "cpu")
    assert rows.shape == (2, 6)
    for row, (pc1, pc2, sf, path) in zip(rows, scenes):
        with torch.no_grad():
            a, b = torch.from_numpy(pc1)[None], torch.from_numpy(pc2)[None]
            pred = model(a, b, a, b)["flows"][0][0].numpy()
        P = np.loadtxt(osp.join(calib_dir, osp.basename(path) + ".txt"),
                       skiprows=1, usecols=range(1, 13)).astype(
                           np.float32).reshape(3, 4)
        px1 = _project(pc1, P)
        f_pred, f_gt = _project(pc1 + pred, P) - px1, \
            _project(pc1 + sf, P) - px1
        want = [*jax_evaluate_3d(pred, sf), *jax_evaluate_2d(f_pred, f_gt)]
        np.testing.assert_allclose(row, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ fixtures

def test_fixture_resolution(tmp_path, monkeypatch):
    """The evidence copy under its own name, then its alias, then the
    legacy store, hydrated into the cache (again when stale); a cache-only
    fixture; None; persist_fixture writes the evidence copy."""
    evidence, legacy = tmp_path / "fixtures", tmp_path / "checkpoints"
    cache = tmp_path / "cache"
    evidence.mkdir()
    legacy.mkdir()
    monkeypatch.setattr(fixtures, "EVIDENCE_DIR", str(evidence))
    monkeypatch.setattr(fixtures, "CHECKPOINT_DIR", str(legacy))
    (evidence / "a.npz").write_bytes(b"evidence a")
    (evidence / "semitrained_teacher_18k.msgpack").write_bytes(b"18k")
    (legacy / "semitrained_teacher.msgpack").write_bytes(b"6k")
    (legacy / "old.pth").write_bytes(b"legacy")

    path = fixtures.fixture_path("a.npz", str(cache))
    assert path == str(cache / "a.npz") and open(path, "rb").read() == \
        b"evidence a"
    # the alias wins over the legacy checkpoint of the same name
    alias = fixtures.fixture_path("semitrained_teacher.msgpack", str(cache))
    assert open(alias, "rb").read() == b"18k"
    assert open(fixtures.fixture_path("old.pth", str(cache)), "rb").read() \
        == b"legacy"
    # a stale cache entry is refreshed from the evidence copy
    (cache / "a.npz").write_bytes(b"stale, longer")
    assert open(fixtures.fixture_path("a.npz", str(cache)), "rb").read() == \
        b"evidence a"
    (cache / "only.bin").write_bytes(b"cache")
    assert fixtures.fixture_path("only.bin", str(cache)) == \
        str(cache / "only.bin")
    assert fixtures.fixture_path("missing.bin", str(cache)) is None
    dst = fixtures.persist_fixture("only.bin", str(cache))
    assert dst == str(evidence / "only.bin")
    assert open(dst, "rb").read() == b"cache"


def test_fixture_paths_point_into_the_checkout_and_the_temp_dir():
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    assert fixtures.EVIDENCE_DIR == osp.join(root, "evidence", "fixtures")
    assert fixtures.CHECKPOINT_DIR == osp.join(root, "evidence",
                                               "checkpoints")
    assert osp.dirname(fixtures.CACHE_DIR) == tempfile.gettempdir()


# ------------------------------------------------------------ preprocessors

PIL_CASES = {"L": (np.uint8, (17, 23)), "RGB": (np.uint8, (9, 11, 3)),
             "I;16": (np.uint16, (16, 21))}


@pytest.mark.parametrize("mode", sorted(PIL_CASES))
def test_codec_decodes_pil_output_as_pil(tmp_path, mode):
    """PIL writes with adaptive row filters; the port's reader (the
    codec, not PIL) gives PIL's array."""
    dtype, shape = PIL_CASES[mode]
    rng = np.random.RandomState(len(mode))
    arr = (rng.rand(*shape) * (60000 if dtype == np.uint16 else 255)
           ).astype(dtype)
    path = str(tmp_path / "pil.png")
    img = Image.fromarray(arr)
    assert img.mode == mode
    img.save(path)
    assert png16.decodable(path)
    want = np.asarray(Image.open(path))
    got = io.read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_reader_gives_pil_s_array_for_16_bit_color(tmp_path, channels):
    """PIL keeps 16 bits for grayscale only: a 16-bit grayscale + alpha,
    RGB or RGBA PNG (written by the codec, as PIL writes none) comes back
    from the port's reader as PIL reads it."""
    rng = np.random.RandomState(channels)
    arr = rng.randint(0, 65536, (7, 9, channels)).astype(np.uint16)
    path = str(tmp_path / "color16.png")
    png16.write_png16(path, arr)
    assert png16.decodable(path)
    want = np.asarray(Image.open(path))
    got = io.read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_falls_back_to_pil_and_says_when_it_is_missing(tmp_path,
                                                            monkeypatch):
    """A palette PNG is the codec's gap: PIL reads it; without PIL the
    reader raises a clear error."""
    path = str(tmp_path / "palette.png")
    Image.fromarray(np.arange(12, dtype=np.uint8).reshape(3, 4)).convert(
        "P").save(path)
    assert not png16.decodable(path)
    np.testing.assert_array_equal(io.read(path),
                                  np.asarray(Image.open(path)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        io.read(path)


def _filtered_png(path, arr, filters):
    """An 8-bit grayscale PNG whose row r is stored with filter
    filters[r] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = arr.shape
    rows, prev = [], np.zeros(w, np.int64)
    for r in range(h):
        x = arr[r].astype(np.int64)
        a = np.concatenate([[0], x[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        p = a + prev - c
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [0 * x, a, prev, (a + prev) >> 1, paeth][filters[r]]
        rows.append(bytes([filters[r]]) + ((x - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = x

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


def test_codec_reverses_every_row_filter(tmp_path):
    """Rows stored with each of the five filters decode to the image, as
    PIL decodes them."""
    arr = (np.random.RandomState(9).rand(10, 13) * 255).astype(np.uint8)
    path = str(tmp_path / "filters.png")
    _filtered_png(path, arr, [0, 1, 2, 3, 4, 3, 4, 1, 2, 3])
    np.testing.assert_array_equal(png16.read_png16(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)


@pytest.mark.parametrize("shape,dtype", [((5, 7), np.uint16),
                                         ((4, 6, 3), np.uint16),
                                         ((6, 9), np.uint8)])
def test_png_roundtrip(tmp_path, shape, dtype):
    rng = np.random.RandomState(0)
    arr = (rng.rand(*shape) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "t.png")
    png16.write_png16(path, arr)
    np.testing.assert_array_equal(png16.read_png16(path), arr)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[osp.relpath(osp.join(d, n), root)] = open(
                osp.join(d, n), "rb").read()
    return out


@pytest.mark.parametrize("save_near", [False, True])
def test_ft3d_preprocessor_writes_jax_s_bytes(tmp_path, save_near,
                                              monkeypatch):
    raw = synthetic.write_raw_ft3d(str(tmp_path / "raw"), 1, 2, height=24,
                                   width=40, seed=3)
    ft3d.main(["--raw_data_path", raw, "--save_path",
               str(tmp_path / "port"), "--workers", "1"]
              + (["--only_save_near_pts"] if save_near else []))
    # the port's run reads no PNG through PIL
    for split, name in (("train", "0000000"), ("val", "0000000"),
                        ("val", "0000001")):
        jax_ft3d.process_one_file(raw, str(tmp_path / "jax"), split, name,
                                  save_near)
    port, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(want) and len(port) == 6
    for name, data in want.items():
        assert port[name] == data, name
    pc1 = np.load(tmp_path / "port" / "val" / "0000001" / "pc1.npy")
    assert 0.85 * 24 * 40 < len(pc1) < 24 * 40   # occluded pixels dropped


def test_ft3d_preprocessor_writes_jax_s_bytes_from_16_bit_rgb_masks(
        tmp_path):
    """Occlusion masks stored as 16-bit RGB, some samples with only their
    low byte set and some with only their high byte: the port reads them
    as JAX's reader (PIL) does."""
    raw = synthetic.write_raw_ft3d(str(tmp_path / "raw"), 0, 1, height=12,
                                   width=20, seed=6)
    rng = np.random.RandomState(6)
    for parts in (("disparity_occlusions", "left"),
                  ("flow_occlusions", "left", "into_future")):
        mask = rng.choice(np.array([0, 0x00FF, 0xFF00], np.uint16),
                          size=(12, 20, 3), p=[0.8, 0.1, 0.1])
        png16.write_png16(osp.join(raw, "val", *parts, "0000000.png"), mask)
    ft3d.process_one_file(raw, str(tmp_path / "port"), "val", "0000000")
    jax_ft3d.process_one_file(raw, str(tmp_path / "jax"), "val", "0000000",
                              False)
    port, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(want) and len(port) == 2
    for name, data in want.items():
        assert port[name] == data, name


def test_ft3d_preprocessor_needs_no_pil(tmp_path, monkeypatch):
    raw = synthetic.write_raw_ft3d(str(tmp_path / "raw"), 0, 1, height=8,
                                   width=12, seed=4)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ft3d.process_one_file(raw, str(tmp_path / "out"), "val", "0000000")
    assert (tmp_path / "out" / "val" / "0000000" / "pc2.npy").exists()


def test_kitti_preprocessor_writes_jax_s_bytes(tmp_path):
    data_root, calib = synthetic.write_raw_kitti(str(tmp_path / "raw"),
                                                 (0, 4), height=20,
                                                 width=33, seed=5)
    assert kitti.frames(data_root) == [0, 4]
    assert kitti.main([data_root, str(tmp_path / "port"), "--calib_root",
                       calib, "--workers", "1"]) == 2
    for i in (0, 4):
        jax_kitti.process_one_frame(data_root, str(tmp_path / "jax"), calib,
                                    i)
    port, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(want) and len(port) == 4
    for name, data in want.items():
        assert port[name] == data, name
    np.testing.assert_array_equal(
        kitti.read_p_rect(osp.join(calib, "000004.txt")),
        jax_kitti.read_p_rect(osp.join(calib, "000004.txt")))
