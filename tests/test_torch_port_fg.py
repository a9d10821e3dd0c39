"""The port's fg, bifeat, no_cross and vote presets against the JAX
package, on the CPU.

Each preset at tiny_config (full widths, 256 points), exact kNN on the JAX
side, the same numpy inputs and the same weights (carried by
params_from_jax): every flow level and every iteration (bifeat refines
l0-l2 twice), the features (8 entries for the FG family, feat_l4 at index
4), the FG family's c_feat1s / c_feat2s and the cost volumes within 1e-5
abs, FPS chains equal, and the bridge covering every state_dict entry.
Weights are seeded draws at torch's default scale (U(+-1/sqrt(fan_in)))
with non-trivial BatchNorm statistics, and for fg and bifeat also the
semitrained trees of evidence/fixtures/semitrained_{fg,bifeat}.msgpack
(read by the port's load_msgpack_tree) on a synthetic scene, whose
features give the feature-space search realistic structure.

The feature-space kNN ranks keys by the |q|^2 - 2 q.k + |k|^2 expansion,
its cross term a float32 matrix product, as the JAX package. Two matrix
product libraries round that term differently, so keys whose distances
differ by less than that rounding (near-ties, common where the expansion
cancels) may rank differently on the two sides. The port's rule is JAX's on
the same floats (test_knn_features_*); the model cases hold the inputs
tie-free in that sense by checking, at every feature-kNN site of the port's
forward, that the port's indices are JAX's exact knn_point's on the same
features.

Then the new parts module by module: knn_features against JAX's exact
search at D = 32 and 256 and on duplicated rows, CrossLayerLightFG (both of
the JAX package's round schedules), NoCrossLayerLight and
CrossLayerLightVote; the eval runner on bifeat's per-iteration flows
against the JAX package's eval metrics step; and the "fg" and "vote" .pth
families against the JAX reader.
"""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import kd_pointcloud_tpu_torch.nn.cross as port_cross
from kd_pointcloud_tpu.eval import runner as jax_runner
from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.models.torch_import import \
    convert_state_dict as jax_convert_state_dict
from kd_pointcloud_tpu.nn import cross as jax_cross
from kd_pointcloud_tpu.ops import knn_point as jax_knn_point
from kd_pointcloud_tpu_torch.eval import (evaluate_model, pairs_loader,
                                          synthetic_pairs)
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet,
                                            convert_state_dict,
                                            params_from_jax, tiny_config)
from kd_pointcloud_tpu_torch.nn import (CrossLayerLightFG,
                                        CrossLayerLightVote,
                                        NoCrossLayerLight, PointConv)
from kd_pointcloud_tpu_torch.ops import knn_features
from kd_pointcloud_tpu_torch.train import load_msgpack_tree

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent.parent / "evidence" / "fixtures"
N = 256
TOL = 1e-5
CASES = ("fg", "bifeat", "no_cross", "vote", "fg_semitrained",
         "bifeat_semitrained")
FG = ("fg", "bifeat")
_JITTED = {}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _seeded_tree(shapes, rng):
    """Seeded weights for a flax param tree: every Dense-like node (kernel
    and bias) U(+-1/sqrt(fan_in)), BatchNorm scale in [0.5, 2] and bias in
    [-0.1, 0.1]."""
    out = {k: _seeded_tree(v, rng) for k, v in shapes.items()
           if isinstance(v, dict)}
    if "kernel" in shapes:
        bound = 1 / np.sqrt(np.prod(shapes["kernel"].shape[:-1]))
        for k, v in shapes.items():
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
    elif "scale" in shapes:
        out["scale"] = rng.uniform(0.5, 2.0, shapes["scale"].shape
                                   ).astype(np.float32)
        out["bias"] = rng.uniform(-0.1, 0.1, shapes["bias"].shape
                                  ).astype(np.float32)
    return out


def _jax_forward(name):
    """The JAX model of a preset at tiny_config with exact kNN, and its
    jitted eval forward (compiled once per preset)."""
    if name not in _JITTED:
        net = JaxNet(dataclasses.replace(jax_tiny_config(name),
                                         knn_method="exact"))
        _JITTED[name] = net, jax.jit(
            lambda v, a, b: net.apply(v, a, b, a, b, train=False))
    return _JITTED[name]


def _inputs(case, rng):
    if case.endswith("_semitrained"):
        pc1, pc2 = synthetic_pairs(1, npoints=N, seed=4)[0][:2]
        return pc1[None], pc2[None]
    pc1 = rng.uniform(-2, 2, (1, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return pc1, pc2


def _variables(case, net, pc1, pc2, rng):
    if case.endswith("_semitrained"):
        name = case.removesuffix("_semitrained")
        params, stats = load_msgpack_tree(
            str(FIXTURES / f"semitrained_{name}.msgpack"))
        return {"params": params, "batch_stats": stats}
    shapes = jax.eval_shape(lambda k, a, b: net.init(k, a, b, a, b,
                                                     train=False),
                            jax.random.PRNGKey(0), pc1, pc2)
    return {"params": _seeded_tree(shapes["params"], rng),
            "batch_stats": jax.tree_util.tree_map(
                lambda s: rng.uniform(0.5, 2.0, s.shape).astype(np.float32),
                shapes["batch_stats"])}


@pytest.fixture(scope="module", params=CASES)
def preset(request):
    case = request.param
    name = case.removesuffix("_semitrained")
    rng = np.random.RandomState(0)
    pc1, pc2 = _inputs(case, rng)
    net, fwd = _jax_forward(name)
    variables = _variables(case, net, pc1, pc2, rng)
    out = jax.device_get(fwd(variables, pc1, pc2))

    model = BidPointFlowNet(tiny_config(name), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    sites = []

    def recording(k, keys, query):
        idx = knn_features(k, keys, query)
        sites.append((k, keys.numpy().copy(), query.numpy().copy(),
                      idx.numpy()))
        return idx

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cross, "knn_features", recording)
        mine = model(*(_t(a) for a in (pc1, pc2, pc1, pc2)))
    return dict(name=name, out=out, mine=mine, model=model,
                variables=variables, sites=sites)


def _pairs(want, got):
    """(want, got) leaves of one output entry, per-iteration lists
    flattened; their structure must agree."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        return [p for w, g in zip(want, got) for p in _pairs(w, g)]
    return [(np.asarray(want), got.detach().numpy())]


def _assert_equal_up_to_near_ties(idx, want, keys, query):
    """idx equals want except at near-ties: where they differ, the two
    keys' exact (float64) distances to the query are within 1e-5 of |q|^2
    + |k|^2, the scale of the expansion's float32 rounding."""
    for b, s in np.argwhere((idx != want).any(-1)):
        q = query[b, s].astype(np.float64)
        kk = keys[b].astype(np.float64)
        exact = ((kk - q) ** 2).sum(-1)
        scale = (q ** 2).sum() + (kk ** 2).sum(-1).max()
        gap = np.abs(exact[idx[b, s]] - exact[want[b, s]]).max()
        assert gap <= 1e-5 * scale, (keys.shape, b, s, gap, scale)


def test_feature_knn_sites_match_jax(preset):
    """Every feature-space search of the port's forward selects JAX's exact
    knn_point neighbours on the same features: four sites (each level's
    both directions stacked; bifeat's two iterations share them), the same
    set a query. The pool takes the max over the set, so order within it
    does not reach the outputs; where the order differs, the two keys are
    a near-tie (exact distances within 1e-5 of |q|^2 + |k|^2: the
    expansion's rounding, see the module docstring)."""
    sites = preset["sites"]
    if preset["name"] not in FG:
        assert sites == []
        return
    assert len(sites) == 4
    dims = sorted(s[1].shape[2] for s in sites)
    assert dims == [32, 64, 128, 256]
    for k, keys, query, idx in sites:
        want = np.asarray(jax_knn_point(k, keys, query, method="exact"))
        np.testing.assert_array_equal(np.sort(idx, -1), np.sort(want, -1),
                                      err_msg=f"D={keys.shape[2]}")
        _assert_equal_up_to_near_ties(idx, want, keys, query)


@pytest.mark.parametrize("lvl", range(4))
def test_flows_match_jax(preset, lvl):
    out, mine = preset["out"], preset["mine"]
    pairs = _pairs(out["flows"][lvl], mine["flows"][lvl])
    iters = 2 if preset["name"] == "bifeat" and lvl < 3 else 1
    assert len(pairs) == iters
    for want, got in pairs:
        assert got.shape == want.shape == (1, tiny_config("fg").npoints[lvl],
                                           3)
        assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("key", ["pc1", "pc2", "feat1s", "feat2s", "crosses",
                                 "fps_idx1", "fps_idx2", "c_feat1s",
                                 "c_feat2s"])
def test_other_outputs_match_jax(preset, key):
    out, mine = preset["out"], preset["mine"]
    if key.startswith("c_feat") and preset["name"] not in FG:
        assert key not in out and key not in mine
        return
    for want, got in _pairs(out[key], mine[key]):
        assert got.shape == want.shape
        if key.startswith("fps_idx"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_output_contract(preset):
    """feat1s / feat2s hold 8 entries for the FG family (feat_l4, the
    level-4 encoder features, at index 4) and 7 otherwise; bifeat's l0-l2
    flows and c_feats are per-iteration lists of two."""
    mine, name = preset["mine"], preset["name"]
    fg = name in FG
    assert len(mine["feat1s"]) == len(mine["feat2s"]) == (8 if fg else 7)
    if fg:
        assert mine["feat1s"][4].shape[1:] == (tiny_config(name).npoints[4],
                                              tiny_config(name)
                                              .level_channels[4])
        assert len(mine["c_feat1s"]) == 3
    for lvl in range(3):
        entries = [mine["flows"][lvl]] + ([mine["c_feat1s"][lvl]]
                                          if fg else [])
        for e in entries:
            assert isinstance(e, list) == (name == "bifeat")
            assert not isinstance(e, list) or len(e) == 2


def test_bridge_covers_every_state_entry(preset):
    state = params_from_jax(preset["variables"])
    want = preset["model"].state_dict()
    assert set(state) == set(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


def test_presets_build_their_layers():
    fg = BidPointFlowNet(tiny_config("fg"), device="cpu")
    assert isinstance(fg.level0, PointConv) and not hasattr(fg, "level0_2")
    assert fg.level0.nsample == tiny_config("fg").feat_nei
    assert fg.level0.weightnet.layers[-1].weight.shape[0] == 8
    assert all(type(getattr(fg, f"cross{lvl}")) is CrossLayerLightFG
               for lvl in range(4))
    vote = BidPointFlowNet(tiny_config("vote"), device="cpu")
    assert type(vote.cross0) is CrossLayerLightVote
    # the flow heads read the vote's 3 extra cost channels
    assert vote.flow0.convs[0].dense.weight.shape[1] == \
        (3 + 32 + 64 + 32 + 3) * 8
    no_cross = BidPointFlowNet(tiny_config("no_cross"), device="cpu")
    assert type(no_cross.cross2) is NoCrossLayerLight


# ------------------------------------------------------- feature-space kNN

@pytest.mark.parametrize("dim", [32, 256])
def test_knn_features_matches_jax(dim):
    """Indices identical, in order, to JAX's exact knn_point_dist. The
    features are small integers, so every product and sum of the expansion
    is exact in float32 on both sides: the distances are the same floats,
    with many exact ties, and the selection rule alone decides. 4096
    queries go in two chunks of 2048 on both sides."""
    rng = np.random.RandomState(dim)
    keys = rng.randint(-3, 4, (2, 300, dim)).astype(np.float32)
    query = rng.randint(-3, 4, (2, 4096, dim)).astype(np.float32)
    got = knn_features(16, _t(keys), _t(query))
    assert got.dtype == torch.int32 and got.shape == (2, 4096, 16)
    want = np.asarray(jax_knn_point(16, keys, query, method="exact"))
    np.testing.assert_array_equal(got.numpy(), want)
    d = ((query[:, :, None].astype(np.int64)
          - keys[:, None].astype(np.int64)) ** 2).sum(-1)
    kth = np.take_along_axis(d, want[..., -1:].astype(np.int64), -1)
    assert ((d == kth).sum(-1) > 1).mean() > 0.1     # ties at the k-th place


@pytest.mark.parametrize("dim", [32, 256])
def test_knn_features_gaussian_matches_jax(dim):
    """On gaussian features the expansion's cross term is rounded by each
    side's matrix product: the indices are JAX's except at near-ties."""
    rng = np.random.RandomState(dim + 1)
    keys = rng.standard_normal((2, 300, dim)).astype(np.float32)
    query = rng.standard_normal((2, 2048, dim)).astype(np.float32)
    got = knn_features(16, _t(keys), _t(query)).numpy()
    want = np.asarray(jax_knn_point(16, keys, query, method="exact"))
    assert (got == want).all(-1).mean() > 0.99
    _assert_equal_up_to_near_ties(got, want, keys, query)


@pytest.mark.parametrize("dim", [32, 256])
def test_knn_features_ties_toward_lower_index(dim):
    """Duplicated key rows give equal distances: the lower index comes
    first, as lax.top_k orders them, also where the tie straddles the k-th
    place; queries that are keys find themselves first."""
    rng = np.random.RandomState(1)
    base = rng.standard_normal((1, 40, dim)).astype(np.float32)
    keys = np.concatenate([base, base[:, ::-1], base], axis=1)   # 120 rows
    query = np.concatenate([base[:, :8], rng.standard_normal(
        (1, 24, dim)).astype(np.float32)], axis=1)
    got = knn_features(7, _t(keys), _t(query)).numpy()
    want = np.asarray(jax_knn_point(7, keys, query, method="exact"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :8, 0], np.arange(8))
    # each neighbour's copies appear lowest index first
    for row in got[0]:
        rows = keys[0, row]
        for i in range(1, len(row)):
            if np.array_equal(rows[i], rows[i - 1]):
                assert row[i] > row[i - 1]
    with pytest.raises(ValueError):
        knn_features(121, _t(keys), _t(query))


# ---------------------------------------------------------- cross layers

def _init(module, *args):
    return jax.device_get(jax.jit(lambda k, *a: module.init(k, *a))(
        jax.random.PRNGKey(0), *args))


def _load(port, variables, name="cross0"):
    state = params_from_jax({"params": {name: variables["params"]}})
    port.load_state_dict({k.removeprefix(f"{name}."): v
                          for k, v in state.items()}, strict=True)
    return port.eval()


def _clouds(rng, n=96, c=32, fg_dim=48):
    pc1 = rng.uniform(-2, 2, (2, n, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    f1, f2, g1, g2 = (rng.standard_normal((2, n, d)).astype(np.float32)
                      for d in (c, c, fg_dim, fg_dim))
    return pc1, pc2, f1, f2, g1, g2


@pytest.mark.parametrize("c", [32, 128])
def test_cross_layer_fg_matches_jax(c):
    """CrossLayerLightFG against the JAX layer: C = 32 takes the JAX
    package's merged-gather schedule, C = 128 the plain one; the port runs
    the rounds in one order, the same math. The union holds the feature
    half first, then the Euclidean half; with feat_idx passed in (the
    model's once-a-level search) the result is the same."""
    rng = np.random.RandomState(c)
    pc1, pc2, f1, f2, g1, g2 = _clouds(rng, c=c)
    jm = jax_cross.CrossLayerLightFG(16, (c, c), (c, c), knn_method="exact")
    v = _init(jm, pc1, pc2, f1, f2, g1, g2)
    want = jm.apply(v, pc1, pc2, f1, f2, g1, g2)
    port = _load(CrossLayerLightFG(16, c, (c, c), (c, c)), v)
    args = [_t(a) for a in (pc1, pc2, f1, f2, g1, g2)]
    with torch.no_grad():
        got = port(*args)
        again = port(*args, feat_idx=port.feature_knn(args[4], args[5]))
    for w, g, a in zip(want, got, again):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
        assert torch.equal(g, a)
    # the union: 8 feature-space neighbours, then 8 Euclidean ones
    f12, _ = port.feature_knn(args[4], args[5])
    np.testing.assert_array_equal(
        f12.numpy(), np.asarray(jax_knn_point(8, g2, g1, method="exact")))


def test_nocross_layer_matches_jax():
    rng = np.random.RandomState(7)
    pc1, pc2, f1, f2, _, _ = _clouds(rng, c=40)
    jm = jax_cross.NoCrossLayerLight(16, (32, 32), knn_method="exact")
    v = _init(jm, pc1, pc2, f1, f2)
    port = _load(NoCrossLayerLight(16, 40, (32, 32)), v)
    with torch.no_grad():
        got = port(*(_t(a) for a in (pc1, pc2, f1, f2)))
    assert got.shape == (2, 96, 32)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.apply(v, pc1, pc2, f1, f2)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("c", [32, 64])
def test_vote_layer_matches_jax(c):
    """CrossLayerLightVote against the JAX layer (C = 32: the merged
    k-major gather; C = 64: the plain _cross_pool with return_neighbors):
    both rounds, and the final round's pooled features with the 3 vote
    flow channels."""
    rng = np.random.RandomState(c + 1)
    pc1, pc2, f1, f2, _, _ = _clouds(rng, c=c)
    jm = jax_cross.CrossLayerLightVote(16, (c, c), (c, c),
                                       knn_method="exact")
    v = _init(jm, pc1, pc2, f1, f2)
    want = jm.apply(v, pc1, pc2, f1, f2)
    port = _load(CrossLayerLightVote(16, c, (c, c), (c, c)), v)
    with torch.no_grad():
        got = port(*(_t(a) for a in (pc1, pc2, f1, f2)))
    assert got[2].shape == (2, 96, c + 3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


# ------------------------------------------------------------ eval runner

def test_evaluate_model_takes_the_last_iteration():
    """evaluate_model on bifeat, whose l0 flow is a per-iteration list,
    scores the last iteration as the JAX package's eval metrics step does:
    EPE3D, ACC3DS, ACC3DR, Outliers3D and the eval loss."""
    rng = np.random.RandomState(5)
    pairs = synthetic_pairs(2, npoints=N, seed=6)
    net, _ = _jax_forward("bifeat")
    pc1 = pairs[0][0][None]
    variables = _variables("bifeat", net, pc1, pc1, rng)
    model = BidPointFlowNet(tiny_config("bifeat"), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    got = evaluate_model(model, pairs_loader(pairs), with_2d=False)
    step = jax_runner.make_eval_metrics_step(net, with_2d=False)
    rows = [np.asarray(step(variables, *(a[None] for a in pair),
                            np.zeros((1, 6), np.float32)))[0]
            for pair in pairs]
    want = np.mean(rows, axis=0)
    np.testing.assert_allclose(
        [got[k] for k in ("epe3d", "acc3ds", "acc3dr", "outliers", "loss")],
        want[[0, 1, 2, 3, 6]], rtol=1e-5, atol=1e-6)
    # the first iteration's flow scores otherwise
    with torch.no_grad():
        flows0 = model(*(_t(a)[None] for a in pairs[0][:4]))["flows"][0]
    assert len(flows0) == 2
    assert not torch.allclose(flows0[0], flows0[1])


# ------------------------------------------------------- .pth families

# the port's state_dict key prefix -> the reference's, and the trailing 1s
# of its conv weights (Conv1d 1, the weight nets' Conv2d 2); first match
_REFERENCE_NAMES = (
    (r"(flow\d)\.convs\.(\d+)\.weightnet\.layers\.(\d+)\.",
     r"\1.pointconv_list.\2.weightnet.mlp_convs.\3.", 2),
    (r"(flow\d)\.convs\.(\d+)\.dense\.", r"\1.pointconv_list.\2.linear.", 0),
    (r"(flow\d)\.convs\.(\d+)\.bn\.", r"\1.pointconv_list.\2.bn_linear.", 0),
    (r"(flow\d)\.mlp\.layers\.(\d+)\.dense\.",
     r"\1.mlp_convs.\2.composed_module.0.", 1),
    (r"(flow\d)\.dense\.", r"\1.fc.", 1),
    (r"(cross\d)\.(mlp\d)\.layers\.(\d+)\.dense\.",
     r"\1.\2.\3.composed_module.0.", 1),
    (r"(cross\d)\.(\w+)\.", r"\1.\2.", 1),
    (r"(level\d)\.weightnet\.layers\.(\d+)\.", r"\1.weightnet.mlp_convs.\2.",
     2),
    (r"(\w+)\.dense\.", r"\1.composed_module.0.", 1),
)


def _reference_keys(state):
    """A reference-keyed state_dict (the reference's module names and conv
    weight shapes) of the port's state_dict, with dead entries that the
    readers skip. A level with a weight net is a PointConv: its dense is
    the reference's `linear`."""
    sd = {}
    for key, value in state.items():
        for pattern, repl, dims in _REFERENCE_NAMES:
            m = re.match(pattern, key)
            if m:
                break
        head = m.group(0)
        if dims == 1 and f"{m.group(1)}.weightnet.layers.0.weight" in state:
            repl, dims = r"\1.linear.", 0
        ref = m.expand(repl) + key[len(head):]
        if key.endswith(".weight"):
            value = value.reshape(*value.shape, *([1] * dims))
        sd[ref] = value.clone()
    sd["cross0.bias1"] = torch.zeros(3)
    sd["level1.weightnet.mlp_bns.0.weight"] = torch.ones(8)
    return sd


@pytest.mark.parametrize("family,preset_name", [("fg", "fg"),
                                                ("fg", "bifeat"),
                                                ("vote", "vote")])
def test_pth_family_matches_jax_reader(family, preset_name):
    """A reference-keyed state_dict built from a seeded tiny model: the
    port's reader gives back the model's state_dict entry by entry, equal
    to the JAX reader's trees through params_from_jax, and loads strictly
    into the preset."""
    model = BidPointFlowNet(tiny_config(preset_name), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    state = model.state_dict()
    sd = _reference_keys(state)
    assert ("level0.linear.weight" in sd) == (family == "fg")
    assert ("cross2.vote.weight" in sd) == (family == "vote")
    got = convert_state_dict({"state_dict": sd}, family=family)
    params, stats = jax_convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, family=family)
    want = params_from_jax({"params": params, "batch_stats": stats})
    for key, value in state.items():
        assert torch.equal(got[key], value), key
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(want[key], value), key
    assert set(got) == set(state)
    BidPointFlowNet(tiny_config(preset_name), device="cpu").load_state_dict(
        got, strict=True)
    with pytest.raises(KeyError):
        convert_state_dict(sd, family="teacher" if family == "fg" else "fg")
