"""The port's hand-written CUDA kernels against their plain versions, on the
card (marker ``card``; each skips without one), at the inputs the paths
hand them at 8192 points.

Each path's kernel calls are recorded from a seeded forward: the teacher's
eval forward at batch 1, its train forward at batch 3, the KD steps'
forwards at batch 8 (teacher -> lighttoken_res, teacher -> student,
bifeat -> fg), the bifeat and fg eval forwards, and the self-supervised
loss on a student's outputs at batch 2. There FPS and kNN are bit-identical
to fps_plain and knn_plain (indices in order, and kNN's d2), FPS at every
cluster size the card holds and at its plan; FPS also on duplicated points,
at N = 8000, at l2-l4's N (nested_fps=False) and at fps_blocks=8's blocked
shapes; kNN also at every k of KNN_SWEEP over 2048^2, 8192^2 and
duplicated points. The pool forward is within POOL_TOL x max|plain| at the
eval forward's sites and the student's C = 16 sites (and at K = 9 with N1
off every query tile); the pool backward within POOL_BWD_TOL at the train
step's and the KD step's sites and on crafted ties, the FG union and a
ragged grid, with d_v asked alone equal to the full call's. The attic
kernels: pruned FPS bit-identical to fps_plain, its plain version and the
FPS kernel (and skipping the same sub-block updates); the cross pool at
L = 1 bit-equal to the pool kernel, at L = 2 within POOL_TOL; the
Morton-window kNN's recall against the kNN kernel. The feature kNN kernel
is held in tests/test_torch_port_knn_features.py.

This file imports no JAX; run every card test on the card with

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_port_card_kernels.py \\
        tests/test_torch_port_card_paths.py \\
        tests/test_torch_port_eval_graph.py \\
        tests/test_torch_port_knn_features.py
"""

import pytest
import torch

from kd_pointcloud_tpu_torch import losses
from kd_pointcloud_tpu_torch.attic import cross_pool as cross_mod
from kd_pointcloud_tpu_torch.attic import fps_pruned as pruned_mod
from kd_pointcloud_tpu_torch.attic import morton as morton_mod
from kd_pointcloud_tpu_torch.eval import synthetic_pairs
from kd_pointcloud_tpu_torch.models import PRESETS
from kd_pointcloud_tpu_torch.ops import fps as fps_mod
from kd_pointcloud_tpu_torch.ops import gather_points
from kd_pointcloud_tpu_torch.ops import knn as knn_mod
from kd_pointcloud_tpu_torch.ops import pool_fused as pool_mod
from kd_pointcloud_tpu_torch.train import apply_frozen
from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

import torch_port_checks as checks
from torch_port_checks import N_POINTS, SEED
from torch_port_checks import card, kd_batch, pair  # noqa: F401  (fixtures)

# FPS at l2-l4 when nested_fps=False: (N, npoint) of each level's call
NESTED_FPS = ((2048, 512), (512, 256), (256, 64))
FPS_BLOCKS = 8
# KERNEL_K's edges: 33-64 at two entries a lane
KNN_SWEEP = (1, 2, 7, 8, 24, 31, 33, 48, 63, 64)
# the Morton-window kNN: k and window of the JAX module's recall note
# (attic/morton.py), at the l0 search of 8192^2
MORTON_K, MORTON_WINDOW = 32, 1024
# each path: (teacher, student) run as the KD steps run them, the
# teacher frozen; a student alone in train mode; or an eval forward
PATHS = {"eval": (None, "teacher"), "train": (None, "teacher"),
         "kd": ("teacher", "lighttoken_res"),
         "student kd": ("teacher", "student"),
         "fast kd": (checks.FAST_TEACHER, checks.FAST_STUDENT),
         "bifeat": (None, "bifeat"), "fg": (None, "fg"),
         "selfsup": (None, "student")}


def _inputs(batch):
    return [batch[k] for k in ("pos1", "pos2", "norm1", "norm2")]


def _record(path, card, pair, kd_batch) -> dict:
    """The kernel calls of one forward of path (PATHS), checked against
    the launches the path makes."""
    t_name, s_name = PATHS[path]
    sites = checks.empty_sites()
    with torch.no_grad():
        if path in ("eval", "bifeat", "fg"):
            model = checks.model(s_name, SEED, card).eval()
            with checks.recording(sites):
                model(*pair)
            want = checks.forward_launches(PRESETS[s_name])
        elif path == "train":
            model = checks.model(s_name, SEED, card).train()
            batch = synthetic_batches(1, checks.TRAIN_BATCH, N_POINTS,
                                      SEED + 1, "cuda")[0]
            with checks.recording(sites):
                model(*_inputs(batch))
            want = checks.PER_FORWARD
        elif path == "selfsup":
            model = checks.model(s_name, checks.STUDENT_SEED, card).train()
            batch = synthetic_batches(1, checks.SELFSUP_BATCH, N_POINTS,
                                      SEED + 5, "cuda")[0]
            out = model(*_inputs(batch))
            with checks.recording(sites):
                losses.multi_scale_chamfer_smooth_curvature(
                    out["pc1"], out["pc2"], out["flows"])
            want = dict.fromkeys(checks.ENTRIES, 0)
            want["knn"] = checks.SELFSUP_KNN
        else:
            teacher = checks.model(t_name, checks.TEACHER_SEED, card)
            student = checks.model(s_name, checks.STUDENT_SEED, card).train()
            with checks.recording(sites):
                apply_frozen(teacher, kd_batch)
                student(*_inputs(kd_batch))
            want = checks.distill_launches(PRESETS[t_name], PRESETS[s_name])
    torch.cuda.synchronize()
    got = {n: len(c) for n, c in sites.items()}
    assert got == {n: want[n] for n in checks.ENTRIES}, (path, got)
    return sites


@pytest.fixture(scope="module")
def path_sites(card, pair, kd_batch):
    """sites(path): the kernel calls of path, recorded at first use."""
    cache = {}

    def sites(path):
        if path not in cache:
            cache[path] = _record(path, card, pair, kd_batch)
        return cache[path]
    yield sites
    cache.clear()


def _hold_pool(u, idx, v, w, b):
    with torch.inference_mode():
        got = pool_mod._pool_cuda(u, idx, v, w, b)
        want = pool_mod.pool_plain(u, idx, v, w, b)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= checks.POOL_TOL * scale, (tuple(idx.shape), err, scale)


def _hold_pool_bwd(*args):
    """d_u, d_v, d_weight, d_bias of the backward kernel within
    POOL_BWD_TOL of autograd of pool_plain, each relative to its max
    |plain|."""
    got = pool_mod._pool_bwd_cuda(*args)
    want = checks.pool_bwd_plain(*args)
    ratios = [float((a - x).abs().max()) / max(float(x.abs().max()), 1e-30)
              for a, x in zip(got, want)]
    assert max(ratios) <= checks.POOL_BWD_TOL, (tuple(args[1].shape), ratios)


def _ragged_pool(sites):
    """One pool site a width at K = 9 (slots left empty in the kernel's
    tile of 32) and N1 off every pass of queries."""
    return [(u, idx[:, :-5, :9].contiguous(), v[:, :-5].contiguous(), w, b)
            for u, idx, v, w, b in {a[0].shape[2]: a for a in sites}.values()]


def _c16(sites):
    c16 = [a for a in sites["pool"] if a[0].shape[2] == 16]
    assert len(c16) == 3        # the student's l0 cross layer's three pools
    return c16


def _with_cotangents(sites, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(*a, torch.randn(a[2].shape, device="cuda", generator=gen))
            for a in sites]


def _bwd_sites(path, path_sites):
    """The pool backward's sites of path's step, each with a seeded
    cotangent: the train forward's 12, the KD student's 12 (batch 8), or
    the student's three at C = 16."""
    if path == "c16":
        pools = _c16(path_sites("student kd"))
    elif path == "kd":              # the student's, after the teacher's
        pools = path_sites("kd")["pool"][checks.PER_FORWARD["pool"]:]
    else:
        pools = path_sites("train")["pool"]
    return _with_cotangents(pools, SEED)


# ------------------------------------------------------------------ FPS

@pytest.mark.card
@pytest.mark.parametrize("path", ["eval", "train", "kd", "student kd",
                                  "fast kd", "bifeat", "fg"])
def test_fps_at_path_sites(path, path_sites):
    for xyz, m in path_sites(path)["fps"]:
        checks.hold_fps(xyz, m)


@pytest.mark.card
@pytest.mark.parametrize("case", ["ties", "N=8000", "nested", "shuffled"])
def test_fps_off_the_path(case, path_sites):
    """The eval forward's cloud pair: 512 points repeated 16 times (equal
    distances in other lanes, warps and blocks), its first 8000 points
    (off every multiple of 1024), and l2-l4's FPS of nested_fps=False
    (2048 -> 512 -> 256 -> 64) from the l1 cloud in FPS order, which
    selects its prefix, and from a shuffled copy, where the selection is
    real."""
    xyz0, m0 = path_sites("eval")["fps"][0]
    if case == "ties":
        tied = xyz0[:, :512].repeat(1, N_POINTS // 512, 1)
        checks.hold_fps(tied.contiguous(), m0)
        return
    if case == "N=8000":
        checks.hold_fps(xyz0[:, :8000].contiguous(), 2000)
        return
    with torch.inference_mode():
        order = fps_mod.fps_plain(xyz0, m0).long()
    l1 = xyz0.gather(1, order[..., None].expand(-1, -1, 3))
    shuffle = torch.randperm(m0, generator=torch.Generator().manual_seed(
        SEED)).cuda()
    for n, m in NESTED_FPS:
        pts = (l1[:, :n] if case == "nested"
               else l1[:, shuffle[shuffle < n]])
        checks.hold_fps(pts.contiguous(), m)


@pytest.mark.card
@pytest.mark.parametrize("path", ["eval", "kd"])
def test_fps_at_blocked_sites(path, path_sites, kd_batch):
    """fps_blocks=8: l1's 8192 -> 2048 as blocks of 1024 -> 256, over the
    stacked clouds of an eval forward (16 clouds) and of a KD step's
    forward (128)."""
    stacked = (path_sites("eval")["fps"][0][0] if path == "eval"
               else torch.cat([kd_batch["pos1"], kd_batch["pos2"]]))
    m1 = PRESETS["teacher"].npoints[1]
    blocks = stacked.reshape(stacked.shape[0] * FPS_BLOCKS,
                             N_POINTS // FPS_BLOCKS, 3)
    checks.hold_fps(blocks, m1 // FPS_BLOCKS)


# ------------------------------------------------------------------ kNN

@pytest.mark.card
@pytest.mark.parametrize("path", list(PATHS))
def test_knn_at_path_sites(path, path_sites):
    for args in path_sites(path)["knn"]:
        checks.hold_knn(*args)


@pytest.fixture(scope="module")
def sweep_clouds(pair):
    """The l1 pair stacked (2 x 2048, by the FPS kernel), one l0 cloud
    (8192) and duplicated points: 683 distinct points thrice at indices
    j, j + 683, j + 1366 (683 = 21 x 32 + 11, so the copies fall in other
    lanes)."""
    n1 = PRESETS["teacher"].npoints[1]
    with torch.inference_mode():
        l1 = torch.cat([gather_points(p, fps_mod.furthest_point_sample(p, n1))
                        for p in pair[:2]])
    l1 = l1.clone()
    dup = l1[:, torch.arange(n1, device="cuda") % 683].contiguous()
    return {"l1 pair": l1, "l0": pair[0], "duplicated": dup}


@pytest.mark.card
@pytest.mark.parametrize("k", KNN_SWEEP)
def test_knn_over_k(k, sweep_clouds):
    for pts in sweep_clouds.values():
        checks.hold_knn(k, pts, pts)


@pytest.mark.card
def test_knn_sweep_ties_across_lanes_and_entries(sweep_clouds):
    """The duplicated cloud's lists hold ties across lanes and, above
    k = 32, across the two entries of a lane: the cases the sweep holds."""
    pts = sweep_clouds["duplicated"]
    lanes_tied = entries_tied = 0
    for k in KNN_SWEEP:
        with torch.inference_mode():
            d, i = knn_mod._knn_cuda(k, pts, pts)
        tie = d[..., 1:] == d[..., :-1]
        lanes = knn_mod.knn_plan(pts.shape[0], pts.shape[1], pts.shape[1],
                                 k)[0]
        lanes_tied += int((tie & (i[..., 1:] % lanes
                                  != i[..., :-1] % lanes)).sum())
        if k > 32:
            pos = torch.arange(1, k, device="cuda")
            entries_tied += int((tie & (pos % 2 == 1)).sum())
    assert lanes_tied > 0 and entries_tied > 0


# ------------------------------------------------------------------ pool

@pytest.mark.card
@pytest.mark.parametrize("path", ["eval", "c16"])
def test_pool_at_path_sites(path, path_sites):
    """The eval forward's 12 sites and the student's three C = 16 sites of
    a batch-8 forward, each width also at K = 9 with N1 off every query
    tile."""
    sites = (path_sites("eval")["pool"] if path == "eval"
             else _c16(path_sites("student kd")))
    for args in sites + _ragged_pool(sites):
        _hold_pool(*args)


@pytest.mark.card
@pytest.mark.parametrize("path", ["train", "kd", "c16"])
def test_pool_bwd_at_path_sites(path, path_sites):
    sites = _bwd_sites(path, path_sites)
    for args in sites:
        _hold_pool_bwd(*args)
    # autograd asks only for the gradients it needs: d_v alone (the mask
    # kernel skips d_w and d_bias, the second kernel its scatter into d_u)
    # is the full call's d_v, which is summed in a fixed order
    full = pool_mod._pool_bwd_cuda(*sites[0])
    part = pool_mod._pool_bwd_cuda(*sites[0], need=(False, True, False,
                                                    False))
    assert part[0] is None and part[2] is None and part[3] is None
    assert torch.equal(part[1], full[1])


@pytest.mark.card
@pytest.mark.parametrize("path", ["train", "c16"])
@pytest.mark.parametrize("case", [checks.tie_case, checks.union_case,
                                  checks.ragged_case],
                         ids=["ties", "union", "ragged"])
def test_pool_bwd_crafted_cases(path, case, path_sites):
    """At one site a width: exact ties, which must split the cotangent as
    the plain version does; the FG layer's union (every neighbour in two
    slots); K = 16 with N1 off every tile."""
    widths = {}
    for args in _bwd_sites(path, path_sites):
        widths.setdefault(args[0].shape[2], args)
    for args in widths.values():
        _hold_pool_bwd(*case(*args))


# ------------------------------------------------------------------ attic

@pytest.mark.card
@pytest.mark.parametrize("case", ["2", "6", "16", "clustered", "widest"])
def test_fps_pruned(case, path_sites, kd_batch):
    """Pruned FPS -> 2048 on the stacked clouds of the eval, train and KD
    forwards (batches 2, 6, 16), a clustered cloud and two clouds of 32768
    points (the most it takes: a cluster of 4 blocks a cloud):
    bit-identical to its plain version, fps_plain and the FPS kernel, and
    skipping the plain version's sub-block updates."""
    if case in ("2", "6"):
        xyz = path_sites("eval" if case == "2" else "train")["fps"][0][0]
    elif case == "16":
        xyz = torch.cat([kd_batch["pos1"], kd_batch["pos2"]])
    elif case == "clustered":
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        xyz = (torch.randn(1, 16, 1, 3, device="cuda", generator=gen) * 20
               + torch.randn(1, 16, N_POINTS // 16, 3, device="cuda",
                             generator=gen)).reshape(1, N_POINTS, 3)
    else:
        xyz = torch.stack([torch.from_numpy(a) for a in synthetic_pairs(
            1, pruned_mod.MAX_N, seed=SEED + 4)[0][:2]]).cuda()
    if case != "clustered":
        assert xyz.shape[0] == (2 if case == "widest" else int(case))
    m = PRESETS["teacher"].npoints[1]
    with torch.inference_mode():
        got, dirty = pruned_mod._fps_pruned_cuda(xyz, m, True)
        plain, p_dirty = pruned_mod.fps_pruned_plain(xyz, m, True)
        for want in (plain, fps_mod.fps_plain(xyz, m),
                     fps_mod._fps_cuda(xyz, m)):
            assert torch.equal(got, want)
    assert torch.equal(dirty, p_dirty)


@pytest.mark.card
@pytest.mark.parametrize("path", ["eval", "c16"])
def test_cross_pool_one_layer(path, path_sites):
    """The L-layer cross pool at L = 1 on the eval forward's 12 pool sites
    and the student's three C = 16 sites: bit-equal to the pool kernel,
    within POOL_TOL x max|plain| of pool_plain."""
    sites = (path_sites("eval")["pool"] if path == "eval"
             else _c16(path_sites("student kd")))
    with torch.inference_mode():
        for u, idx, v, w, b in sites:
            got = cross_mod._cross_pool_cuda(u, v, idx, [w], [b])
            assert torch.equal(got, pool_mod._pool_cuda(u, idx, v, w, b))
            want = pool_mod.pool_plain(u, idx, v, w, b)
            err = float((got - want).abs().max())
            assert err <= checks.POOL_TOL * float(want.abs().max())


@pytest.mark.card
def test_cross_pool_two_layers(path_sites):
    """L = 2 at one eval site a width, within POOL_TOL x max|plain| of
    cross_pool_plain."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    sites = {a[0].shape[2]: a for a in path_sites("eval")["pool"]}
    with torch.inference_mode():
        for c, (u, idx, v, w, b) in sorted(sites.items()):
            w2 = torch.randn(c, c, device="cuda", generator=gen) / c ** 0.5
            b2 = 0.1 * torch.randn(c, device="cuda", generator=gen)
            args = (u, v, idx, [w, w2], [b, b2])
            got = cross_mod._cross_pool_cuda(*args)
            want = cross_mod.cross_pool_plain(*args)
            err = float((got - want).abs().max())
            assert err <= checks.POOL_TOL * float(want.abs().max()), c


@pytest.mark.card
def test_morton_knn_recall(pair):
    """The Morton-window kNN (plain torch) at 8192^2, k = 32, window 1024:
    a recall against the kNN kernel in (0, 1]."""
    pos1, pos2 = pair[:2]
    with torch.inference_mode():
        _, m_idx = morton_mod.knn_block_dist(MORTON_K, pos2, pos1,
                                             window=MORTON_WINDOW)
        _, k_idx = knn_mod._knn_cuda(MORTON_K, pos2, pos1)
    recall = float((m_idx[..., :, None] == k_idx[..., None, :]).any(-1)
                   .float().mean())
    assert 0.0 < recall <= 1.0
