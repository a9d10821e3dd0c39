"""The feature-space kNN (ops/knn.py knn_features, csrc/knn_features.cu).

On the CPU: the plain version is the stable sort of feature_distance
(checked on integer features, whose distances are exact, against an
int64 argsort: planted ties and duplicated rows go to the lower index,
across the 2048-query chunks); a CPU tensor takes it and launches
nothing; it reports the kernel's work; the kernel's wrapper refuses a bad
D, k, dtype, layout or device; the block plan.

On the card (marker ``card``; each skips without one): the kernel against
feature_distance and a stable sort at every site shape of the fg cells
(batch 1 and 8, both directions stacked: B = 2 and 16; D = 32, 64, 128,
256 at 8192, 2048, 512, 256 points; k = 16), at the sites of seeded fg
and bifeat forwards, and at one shape over k = 1 ... 64 with planted ties,
duplicated rows and N not a multiple of the key tile: indices equal, and
distances equal feature_distance's bit for bit. This file imports no JAX;
run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_knn_features.py
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from kd_pointcloud_tpu_torch.eval.runner import synthetic_pairs
from kd_pointcloud_tpu_torch.models import PRESETS, BidPointFlowNet
from kd_pointcloud_tpu_torch.nn import cross as cross_nn
from kd_pointcloud_tpu_torch.ops import kernels, knn

from torch_port_checks import card  # noqa: F401  (the card tests' gate)

torch.set_num_threads(1)

CHUNK = 2048


def _exact_features(seed, B, S, N, D):
    """Integer features in [-2, 2] (float32 distances exact): keys 100-149
    repeat keys 0-49, and queries 0-29 are keys 10-39."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(-2, 3, (B, N, D)).astype(np.float32)
    keys[:, 100:150] = keys[:, :50]
    query = rng.randint(-2, 3, (B, S, D)).astype(np.float32)
    query[:, :30] = keys[:, 10:40]
    return keys, query


def _exact_order(k, keys, query):
    """The k smallest distances' indices by an int64 stable argsort."""
    k64, q64 = keys.astype(np.int64), query.astype(np.int64)
    d = ((q64[:, :, None, :] - k64[:, None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=-1, kind="stable")[..., :k]


@pytest.mark.parametrize("k", [1, 16, 64])
@pytest.mark.parametrize("D", [3, 32])
def test_plain_is_the_stable_sort_on_exact_features(k, D):
    keys, query = _exact_features(k + D, 2, CHUNK + 52, 300, D)
    want = _exact_order(k, keys, query)
    kt, qt = torch.from_numpy(keys), torch.from_numpy(query)
    got = knn.knn_features_plain(k, kt, qt)
    assert got.dtype == torch.int32 and got.shape == (2, CHUNK + 52, k)
    np.testing.assert_array_equal(got.numpy(), want)
    sort = torch.sort(knn.feature_distance(qt, kt), dim=-1, stable=True)[1]
    np.testing.assert_array_equal(got.numpy(), sort[..., :k].numpy())
    # the cut falls inside a tie on many rows: the order decides the set
    d = np.sort(((query[:, :, None] - keys[:, None]) ** 2).sum(-1), -1)
    assert (d[..., k - 1] == d[..., k]).mean() > 0.1


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    keys, query = (torch.from_numpy(a) for a in _exact_features(1, 2, 200,
                                                                 300, 64))
    kernels.reset_launches()
    assert torch.equal(knn.knn_features(16, keys, query),
                       knn.knn_features_plain(16, keys, query))
    assert not any(kernels.LAUNCHES.values())


def test_plain_reports_the_kernels_work():
    """Inside kernels.counting() the plain version reports
    kernel_work("knn_features"): the product's 2 B S N D operations, as
    FlopCounterMode counted them, which now sees none."""
    keys, query = (torch.from_numpy(a) for a in _exact_features(2, 2, 100,
                                                                 300, 32))
    with FlopCounterMode(display=False) as fc:
        knn.knn_features(8, keys, query)
    assert fc.get_total_flops() == 2 * 2 * 100 * 300 * 32
    with kernels.counting() as count, FlopCounterMode(display=False) as fc:
        knn.knn_features(8, keys, query)
    assert fc.get_total_flops() == 0
    assert count.calls == {"knn_features": 1}
    assert count.ops["knn_features"] == 2 * 2 * 100 * 300 * 32
    assert count.bytes["knn_features"] == ((2 * 100 + 2 * 300) * 33 * 4
                                           + 2 * 100 * 8 * 4)


def _bad(case):
    keys = torch.zeros(2, 300, 64)
    query = torch.zeros(2, 100, 64)
    k = 16
    if case == "dim":
        keys, query = torch.zeros(2, 300, 48), torch.zeros(2, 100, 48)
    elif case == "k0":
        k = 0
    elif case == "k65":
        k = 65
    elif case == "k_above_n":
        keys = torch.zeros(2, 10, 64)
    elif case == "dtype":
        keys, query = keys.double(), query.double()
    elif case == "layout":
        query = torch.zeros(2, 64, 100).transpose(1, 2)
    return k, keys, query


@pytest.mark.parametrize("case,error", [
    ("dim", ValueError), ("k0", ValueError), ("k65", ValueError),
    ("k_above_n", ValueError), ("dtype", TypeError), ("layout", ValueError),
    ("device", ValueError)])
def test_kernel_wrapper_refuses(case, error):
    """Checked before anything reaches the card; a well-formed CPU call
    fails on its device."""
    with pytest.raises(error):
        knn._knn_features_cuda(*_bad(case))


def test_feature_rows_plan():
    """128 queries a block where that gives two blocks an SM, else 64:
    the KD cell's l0 (16 clouds) at 128, the eval cell's (2 clouds) at
    64."""
    assert knn.feature_rows(16, 8192) == 128
    assert knn.feature_rows(2, 8192) == 64
    assert knn.feature_rows(16, 2048) == 64
    assert knn.feature_rows(2, 256) == 64
    assert knn.feature_rows(264, 100) == 128


# ------------------------------------------------------------------ card

# (S = N, D) of the four feature kNN sites a forward, l0 to l3
SITES = [(8192, 32), (2048, 64), (512, 128), (256, 256)]


def _plain_with_distances(k, keys, query):
    """(d, idx): knn_features_plain's indices and feature_distance at
    them, in the plain version's chunks."""
    idx = knn.knn_features_plain(k, keys, query)
    d = torch.cat([knn.feature_distance(q, keys).gather(-1, i.long())
                   for q, i in zip(torch.split(query, CHUNK, dim=1),
                                   torch.split(idx, CHUNK, dim=1))], dim=1)
    return d, idx


def _hold(k, keys, query):
    with torch.inference_mode():
        dk, ik = knn._knn_features_cuda(k, keys, query, with_dist=True)
        dp, ip = _plain_with_distances(k, keys, query)
    site = f"k={k} {tuple(query.shape)} x {tuple(keys.shape)}"
    assert torch.equal(ik, ip), (site, int((ik != ip).sum()))
    assert torch.equal(dk, dp), (site, int((dk != dp).sum()))


@pytest.mark.card
@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("S,D", SITES)
def test_kernel_equals_plain_at_the_site_shapes(card, B, S, D):
    g = torch.Generator(device=card).manual_seed(S + D + B)
    keys = torch.randn(B, S, D, device=card, generator=g)
    query = torch.randn(B, S, D, device=card, generator=g)
    _hold(16, keys, query)


@pytest.mark.card
@pytest.mark.parametrize("name,batch", [("fg", 1), ("bifeat", 8),
                                        ("fg", 8)])
def test_kernel_equals_plain_at_a_forwards_sites(card, name, batch):
    """The feature kNN sites of a seeded forward at 8192 points: fg at
    batch 1 (the eval cell), bifeat and fg at batch 8 (the KD cell's
    teacher and student)."""
    model = BidPointFlowNet(PRESETS[name], device=card,
                            generator=torch.Generator().manual_seed(3))
    pairs = synthetic_pairs(batch, 8192, seed=11)
    args = [torch.from_numpy(np.stack([p[i] for p in pairs])).to(card)
            for i in range(4)]
    sites = []
    entry = cross_nn.knn_features

    def record(k, keys, query):
        sites.append((k, keys.clone(), query.clone()))
        return entry(k, keys, query)

    cross_nn.knn_features = record
    try:
        with torch.inference_mode():
            model.eval()(*args)
    finally:
        cross_nn.knn_features = entry
    assert sorted(tuple(q.shape) for _, _, q in sites) == sorted(
        (2 * batch, s, d) for s, d in SITES)
    for k, keys, query in sites:
        _hold(k, keys, query)


@pytest.mark.card
@pytest.mark.parametrize("B", [2, 96])
def test_kernel_over_k_with_ties_and_a_ragged_tile(card, B):
    """k = 1 ... 64 on integer features (exact ties, duplicated rows),
    300 queries and 1000 keys (neither a multiple of a block's queries
    nor of the 128-key tile); B = 96 takes 128 queries a block, B = 2
    64."""
    keys, query = (torch.from_numpy(a).to(card)
                   for a in _exact_features(5, B, 300, 1000, 64))
    assert knn.feature_rows(B, 300) == (128 if B == 96 else 64)
    for k in range(1, knn.MAX_K + 1):
        _hold(k, keys, query)


@pytest.mark.card
def test_kernel_launches_once_a_call(card):
    keys = torch.randn(2, 2048, 64, device=card)
    kernels.reset_launches()
    with torch.inference_mode():
        idx = knn.knn_features(16, keys, keys)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["knn_features"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert torch.equal(idx[..., 0].long().cpu(),
                       torch.arange(2048).expand(2, -1))
