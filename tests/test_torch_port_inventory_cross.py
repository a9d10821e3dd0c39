"""The experimental inventory's cross layers
(kd_pointcloud_tpu_torch/nn/experimental.py, group b) against the JAX
package's, on the CPU.

Each flax module is built from jax.random.PRNGKey(0) at the shapes of
tests/test_experimental.py (B 2, N 64, C 16, K 8), its variables carried
into the port's module by params_from_jax (strict load), and every output
compared within 1e-5 abs (indices exactly). kNN is exact on both sides;
CrossLocalTransLayer searches 2 K neighbours. A layer the JAX package
calls twice (qk, cross_conv, t1 / t2 / pos, the cross_t* projections) is
one parameter in the port: the tests check it is shared, not copied.
"""

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.nn import experimental as jx
from kd_pointcloud_tpu_torch.models import params_from_jax
from kd_pointcloud_tpu_torch.nn import experimental as px

torch.set_num_threads(1)
TOL = 1e-5
B, N, C, K = 2, 64, 16, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _check(jax_mod, port, args):
    """Outputs of jax_mod (PRNGKey(0) init) and of port (strict load of its
    variables) on the same inputs; returns the port's."""
    variables = jax.device_get(jax_mod.init(jax.random.PRNGKey(0), *args))
    port.load_state_dict(params_from_jax(variables), strict=True)
    want = _flat(jax_mod.apply(variables, *args))
    with torch.no_grad():
        got = _flat(port.eval()(*(None if a is None else _t(a)
                                  for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy().astype(np.float64) - w).max() <= TOL
    return got


@pytest.fixture
def pair():
    rng = np.random.RandomState(0)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, N, 3), (B, N, 3), (B, N, C), (B, N, C)))


@pytest.mark.parametrize("name,jax_args,port_args", [
    ("CrossLayerConcat", (K, (32, 32), (32, 24)), (K, C, (32, 32), (32, 24))),
    ("CrossLayerConcat", (K, (32, 24)), (K, C, (32, 24))),
    ("CrossPoolLayer", (K, (32,), (24,)), (K, C, (32,), (24,))),
    ("CrossConvLayer", (K, 24, 32), (K, C, 24, 32)),
    ("CrossConvLayer", (K, 24), (K, C, 24)),
    ("CrossLayerPoolLight", (K, (16, 24), (32,)), (K, C, (16, 24), (32,))),
    ("CrossLayerPoolLight", (K, (24,), (24, 32)), (K, C, (24,), (24, 32))),
    ("CrossTransLayer", (K, (C, C), (32,)), (K, C, (C, C), (32,))),
    ("CrossTransLayer", (K, (C,)), (K, C, (C,))),
    ("CrossLocalTransLayer", (K, (C, C), (32,)), (K, C, (C, C), (32,))),
    ("CrossLocalTransLayer", (K, (C,)), (K, C, (C,))),
    ("CrossLayerLightVoteDouble", (K, (16, 16), (16, 16)),
     (K, C, (16, 16), (16, 16))),
    ("CrossLayerLightVote1", (K, (16, 16), (16, 16)),
     (K, C, (16, 16), (16, 16))),
    ("CrossLayerLightVote2", (K, (16, 24), (16, 16)),
     (K, C, (16, 24), (16, 16))),
    ("NoCrossLayer", (K, (32, 24)), (K, C, (32, 24))),
    ("NoCrossLayer", (K, (32, 24), True), (K, C, (32, 24), True)),
    ("CrossLayerLightOcc", (K, (24, 24), (32, 32)),
     (K, C, (24, 24), (32, 32))),
    ("CrossLayerLightOcc", (K, (24, 24)), (K, C, (24, 24))),
    ("CrossLayerLightAttentive", (K, (24, C), (24, C)),
     (K, C, (24, C), (24, C))),
    ("CrossLayerLightAttentive", (K, (24, C)), (K, C, (24, C))),
    ("CrossLayerP2PConvLight2", (K, (24, 24), (32, 32)),
     (K, C, (24, 24), (32, 32))),
    ("CrossLayerLightShift", (K, (24, 24), (32, 32)),
     (K, C, (24, 24), (32, 32))),
    ("CrossLayerLightShift", (K, (24, 24)), (K, C, (24, 24))),
], ids=["concat", "concat_one_round", "pool_alias", "conv", "conv_one_round",
        "pool_light", "pool_light_two_fusions", "trans", "trans_no_fusion",
        "local_trans", "local_trans_no_fusion", "vote_double_sparse",
        "vote1", "vote2", "no_cross", "no_cross_clue", "occ", "occ_no_mlp2",
        "attentive", "attentive_no_mlp2", "p2p", "shift", "shift_no_mlp2"])
def test_cross_layers_match_jax(pair, name, jax_args, port_args):
    _check(getattr(jx, name)(*jax_args), getattr(px, name)(*port_args), pair)


def test_point_conv_flow_and_flow_embedding_match_jax(pair):
    out = _check(jx.PointConvFlow(K, (32, 24)),
                 px.PointConvFlow(K, C, (32, 24)), pair)
    assert out[0].shape == (B, N, 24)
    assert _check(jx.FlowEmbeddingLayer(K, (32,)),
                  px.FlowEmbeddingLayer(K, C, (32,)), pair)[0].shape == (
        B, N, 32)


def test_cross_layer_light_up_matches_jax(pair):
    rng = np.random.RandomState(1)
    sparse = rng.standard_normal((B, 16, 3)).astype(np.float32)
    sfeat = rng.standard_normal((B, 16, 24)).astype(np.float32)
    out = _check(jx.CrossLayerLightUp(4, (32, 32)),
                 px.CrossLayerLightUp(4, C, 24, (32, 32)),
                 (pair[0], sparse, pair[2], sfeat))
    assert out[0].shape == (B, N, 32)


def test_vote_double_dense_final_round_matches_jax(pair):
    rng = np.random.RandomState(2)
    xyz2 = rng.standard_normal((B, 32, 3)).astype(np.float32)
    f2s = rng.standard_normal((B, 32, C)).astype(np.float32)
    dense = rng.standard_normal((B, N, 3)).astype(np.float32)
    dfeat = rng.standard_normal((B, N, 8)).astype(np.float32)
    args = (pair[0], xyz2, pair[2], f2s, dense, dfeat)
    out = _check(jx.CrossLayerLightVoteDouble(K, (16, 16), (16, 16)),
                 px.CrossLayerLightVoteDouble(K, C, (16, 16), (16, 16),
                                              dense_channel=8), args)
    assert out[2].shape == (B, N, 16)
    with pytest.raises(ValueError):
        px.CrossLayerLightVoteDouble(K, C, (16, 16), (16, 16))(
            *(_t(a) for a in args))


def test_occ_residual_logits_match_jax(pair):
    rng = np.random.RandomState(3)
    occ = [rng.standard_normal((B, N, 1)).astype(np.float32)
           for _ in range(2)]
    out = _check(jx.CrossLayerLightOcc(K, (24, 24), None),
                 px.CrossLayerLightOcc(K, C, (24, 24)), (*pair, *occ))
    assert len(out) == 4


def test_cross_atten_matches_jax(pair):
    a, b = _check(jx.CrossAtten(24), px.CrossAtten(C, 24), pair)
    assert a.shape == (B, N, 24) and b.shape == (B, N, 24)


def test_no_cross_clue_counts_ties_as_jax():
    """Equal activations at several neighbours (a cloud-2 point repeated):
    the clue counts each of them, as the JAX package's == mask does."""
    rng = np.random.RandomState(4)
    pc1 = rng.standard_normal((B, N, 3)).astype(np.float32)
    pc2 = np.repeat(rng.standard_normal((B, N // 4, 3)), 4, 1).astype(
        np.float32)
    f1 = rng.standard_normal((B, N, C)).astype(np.float32)
    f2 = np.repeat(rng.standard_normal((B, N // 4, C)), 4, 1).astype(
        np.float32)
    maxp, clue, idx = _check(jx.NoCrossLayer(K, (32, 24), output_clue=True),
                             px.NoCrossLayer(K, C, (32, 24), True),
                             (pc1, pc2, f1, f2))
    assert clue.shape == (B, N, K) and idx.dtype == torch.int32


@pytest.mark.parametrize("name,args,shared", [
    ("CrossTransLayer", (K, C, (C,)), ["dense", "dense1"]),
    ("CrossLocalTransLayer", (K, C, (C,)), ["dense", "dense1"]),
    ("CrossLayerPoolLight", (K, C, (24,), (32,)),
     ["dense", "dense1", "dense2"]),
    ("CrossLayerLightVote1", (K, C, (16, 16), (16, 16)),
     ["cross_t11", "cross_t22", "pos1", "mlp1"]),
    ("CrossLayerConcat", (K, C, (32,)), ["dense"]),
    ("CrossConvLayer", (K, C, 24), ["weightnet1", "linear1"]),
], ids=["trans", "local_trans", "pool_light", "vote1", "concat", "conv"])
def test_layers_called_twice_are_one_parameter(name, args, shared):
    """A layer used by both directions is one module: a change to it moves
    both directions' outputs."""
    port = getattr(px, name)(*args, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    pc = [_t(rng.standard_normal((1, 32, 3)).astype(np.float32))
          for _ in range(2)]
    f = [_t(rng.standard_normal((1, 32, C)).astype(np.float32))
         for _ in range(2)]
    with torch.no_grad():
        before = port(*pc, *f)
        for attr in shared:
            for p in getattr(port, attr).parameters():
                p.add_(0.5)
        after = port(*pc, *f)
    assert not torch.equal(before[0], after[0])
    assert not torch.equal(before[1], after[1])
    n_params = sum(1 for _ in port.parameters())
    assert n_params == len(port.state_dict()) - sum(
        1 for k in port.state_dict() if "running" in k or "batches" in k)
