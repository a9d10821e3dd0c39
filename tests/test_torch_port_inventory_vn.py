"""The port's vector-neuron layers (nn/vn_layers.py), ConvGRU (nn/blocks.py)
and weighted_contract (nn/pointconv.py) against the JAX package's, on the
CPU.

Each flax module is built from jax.random.PRNGKey(0), its variables carried
into the port's module by params_from_jax (strict load), and every output
compared within 1e-5 abs. Layers with a VNBatchNorm are compared in eval
mode on random running statistics, and in train mode (outputs and the
moved running statistics) with both sides in float64: flax's float32 batch
variance, E[x^2] - E[x]^2 over the vector norms, cancels (on these inputs
JAX's float32 VNStdFeature is 6e-4 from its own float64 result, the port's
float32 9e-5: the frame normalisation amplifies it), so only the float64
runs hold the arithmetic to 1e-5.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.nn import blocks as jblocks
from kd_pointcloud_tpu.nn import pointconv as jpc
from kd_pointcloud_tpu.nn import vn_layers as jvn
from kd_pointcloud_tpu_torch.models import params_from_jax
from kd_pointcloud_tpu_torch.nn import ConvGRU, weighted_contract
from kd_pointcloud_tpu_torch.nn import vn_layers as pvn

torch.set_num_threads(1)
TOL = 1e-5
F = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got = list(got) if isinstance(got, tuple) else [got]
    want = list(want) if isinstance(want, tuple) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.detach().numpy().astype(np.float64) - w).max() <= TOL


def _vectors(seed, shape=(2, 32, 4, F, 3)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _load(port, variables):
    port.load_state_dict(params_from_jax(variables), strict=True)
    return port


def _random_stats(variables, seed):
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 2.0, a.shape) if path[-1].key ==
                         "var" else rng.standard_normal(a.shape)
                         ).astype(np.float32),
        variables["batch_stats"])
    return dict(variables, batch_stats=stats)


def _check_train_and_eval(jax_mod, port, x):
    """train=True (batch statistics, running ones moved) against
    port.train(), both in float64; train=False on random running
    statistics against port.eval(), in float32."""
    variables = jax.device_get(jax_mod.init(jax.random.PRNGKey(0), x))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        want, upd = jax.tree_util.tree_map(np.asarray, jax_mod.apply(
            v64, x.astype(np.float64), train=True, mutable=["batch_stats"]))
    port64 = copy.deepcopy(port).double()
    port64.load_state_dict(params_from_jax(variables), strict=True)
    _close(port64.train()(_t(x).double()), want)
    got_stats = port64.state_dict()
    for key, value in params_from_jax({"batch_stats": upd["batch_stats"]}
                                      ).items():
        if "running" in key:
            assert np.abs(got_stats[key].numpy() - value.numpy()).max() \
                <= TOL
    variables = _random_stats(variables, 3)
    with torch.no_grad():
        _close(_load(port, variables).eval()(_t(x)),
               jax_mod.apply(variables, x, train=False))


@pytest.mark.parametrize("share", [False, True], ids=["per_channel",
                                                      "shared"])
def test_vn_linear_and_leaky_match_jax(share):
    x = _vectors(0)
    for jm, pm in ((jvn.VNLinear(6), pvn.VNLinear(F, 6)),
                   (jvn.VNLeakyReLU(share, 0.1),
                    pvn.VNLeakyReLU(F, share, 0.1))):
        v = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
        with torch.no_grad():
            _close(_load(pm, v)(_t(x)), jm.apply(v, x))


@pytest.mark.parametrize("share", [False, True], ids=["per_channel",
                                                      "shared"])
def test_vn_linear_leaky_relu_with_batchnorm_matches_jax(share):
    _check_train_and_eval(jvn.VNLinearLeakyReLU(6, share),
                          pvn.VNLinearLeakyReLU(F, 6, share), _vectors(1))


def test_vn_linear_leaky_relu_without_batchnorm_matches_jax():
    x = _vectors(2)
    jm = jvn.VNLinearLeakyReLU(6, use_batchnorm=False)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    with torch.no_grad():
        _close(_load(pvn.VNLinearLeakyReLU(F, 6, use_batchnorm=False), v)(
            _t(x)), jm.apply(v, x))


def test_vn_batchnorm_matches_jax():
    _check_train_and_eval(jvn.VNBatchNorm(), pvn.VNBatchNorm(F), _vectors(4))


def test_vn_max_pool_and_mean_pool_match_jax():
    x = _vectors(5)
    jm = jvn.VNMaxPool()
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    with torch.no_grad():
        got = _load(pvn.VNMaxPool(F), v)(_t(x))
    _close(got, jm.apply(v, x))
    # each pooled vector is one of the pooled axis' inputs
    assert (got.numpy()[:, :, None] == x).all(-1).any(2).all()
    _close(pvn.vn_mean_pool(_t(x)), jvn.vn_mean_pool(x))
    _close(pvn.vn_mean_pool(_t(x), axis=-2), jvn.vn_mean_pool(x, axis=-2))


@pytest.mark.parametrize("normalize", [False, True], ids=["frame3",
                                                          "normalized"])
def test_vn_std_feature_matches_jax(normalize):
    _check_train_and_eval(jvn.VNStdFeature(normalize),
                          pvn.VNStdFeature(F, normalize), _vectors(6))


def test_vn_layers_are_equivariant():
    """A rotation of the input rotates VNLinearLeakyReLU's output (the
    layer's reason to exist), through the port alone."""
    x = _t(_vectors(7))
    q, _ = np.linalg.qr(np.random.RandomState(8).standard_normal((3, 3)))
    rot = _t(q.astype(np.float32))
    layer = pvn.VNLinearLeakyReLU(F, 6, use_batchnorm=False,
                                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(layer(x @ rot), layer(x) @ rot,
                                   rtol=1e-4, atol=1e-5)


def test_conv_gru_matches_jax():
    rng = np.random.RandomState(9)
    h = rng.standard_normal((2, 64, 32)).astype(np.float32)
    x = rng.standard_normal((2, 64, 48)).astype(np.float32)
    jm = jblocks.ConvGRU(hidden=32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), h, x))
    # the bias is zeros at init on both sides: give it values
    for name in ("convz", "convr", "convq"):
        v["params"][name]["bias"] = rng.standard_normal(32).astype(
            np.float32)
    port = ConvGRU(48, hidden=32)
    assert port.convz.weight.shape == (32, 80, 3)
    with torch.no_grad():
        _close(_load(port, v)(_t(h), _t(x)), jm.apply(v, h, x))


def test_weighted_contract_matches_jax():
    rng = np.random.RandomState(10)
    g = rng.standard_normal((2, 16, 8, 19)).astype(np.float32)
    w = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    got = weighted_contract(_t(g), _t(w))
    assert got.shape == (2, 16, 19 * 16)
    _close(got, jpc.weighted_contract(g, w))
