"""The port's 13 KD losses and make_named_loss against the JAX package's, on
the CPU.

Inputs are synthetic model outputs made from a numpy seed (four flow levels
with an FPS-like nested index chain, seven feature levels, four cost
volumes, bridge features, an iterative teacher with two iterations at
levels 0-2). Each loss's value within 1e-5 relative, and its gradient by
every student-side input (flows, features, cost volumes, bridge features)
within 1e-5 of that input's largest gradient: the same float32 math, sums
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.losses import kd as jax_kd
from kd_pointcloud_tpu.train import distill_experiment as jax_dexp
from kd_pointcloud_tpu_torch.losses import kd as port_kd
from kd_pointcloud_tpu_torch.train import make_named_loss

torch.set_num_threads(1)

B = 2
SIZES = (64, 32, 16, 8)
FEAT_N = (64, 32, 16, 8, 16, 32, 64)       # points of the 7 feature levels
FEAT_C = (4, 6, 8, 10, 8, 6, 4)
GAMMA, GAMMA2, BETA = 0.3, 0.6, 0.8
REL = 1e-5


def _chain(rng):
    return [np.stack([rng.permutation(a)[:b] for _ in range(B)])
            .astype(np.int32) for a, b in zip(SIZES, SIZES[1:])]


def _data(seed=0):
    """(student-side arrays, constants), nested lists of numpy arrays."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    gt = f(B, SIZES[0], 3)
    feats = lambda w=1: [f(B, n, w * c) for n, c in zip(FEAT_N, FEAT_C)]  # noqa: E731
    crosses = lambda: [f(B, n, c) for n, c in zip(SIZES, FEAT_C)]  # noqa: E731
    s = dict(flows=[f(B, n, 3) for n in SIZES], feat1s=feats(),
             feat2s=feats(), wide1s=feats(2), crosses=crosses(),
             c_feat1s=crosses(), c_feat2s=crosses(),
             br1=f(B, FEAT_N[3], FEAT_C[3]), br2=f(B, FEAT_N[3], FEAT_C[3]),
             br1s=[f(B, FEAT_N[i], FEAT_C[i]) for i in (2, 3)],
             br2s=[f(B, FEAT_N[i], FEAT_C[i]) for i in (2, 3)],
             br_crosses=crosses())
    t_flows = [f(B, n, 3) for n in SIZES]
    c = dict(gt=gt, idx1=_chain(rng), idx2=_chain(rng), t_idx1=_chain(rng),
             t_flows=t_flows,
             t_iter=[[t_flows[i], f(B, SIZES[i], 3)] for i in range(3)]
             + [t_flows[3]],
             t_feat1s=feats(), t_feat2s=feats(), t_crosses=crosses(),
             t_c1=[[f(B, n, k), f(B, n, k)] for n, k in zip(SIZES, FEAT_C)],
             t_c2=[[f(B, n, k), f(B, n, k)] for n, k in zip(SIZES, FEAT_C)],
             hist=[3.0, 5.5, 4.25])
    return s, c


def _losses(L, s, c):
    """name -> loss of library L (jax_kd or port_kd) on s and c."""
    g, g2, b = GAMMA, GAMMA2, BETA
    return {
        "loss_fn_kd_2": lambda: L.loss_fn_kd_2(
            s["flows"], c["idx1"], c["gt"], c["t_flows"], c["t_idx1"], g),
        "loss_fn_kd_2_iterative_teacher": lambda: L.loss_fn_kd_2(
            s["flows"], c["idx1"], c["gt"], c["t_iter"], c["t_idx1"], g),
        "attentive_imitation_loss": lambda: L.attentive_imitation_loss(
            s["flows"], c["idx1"], c["gt"], c["t_flows"], c["t_idx1"],
            c["hist"], g),
        "bidirection_loss": lambda: L.bidirection_loss(
            s["flows"], c["idx1"], c["idx2"], c["gt"], c["t_flows"],
            c["t_idx1"], g, g2, b),
        "loss_fn_ht": lambda: L.loss_fn_ht(
            s["flows"], s["feat1s"], c["idx1"], c["gt"], c["t_flows"],
            c["t_feat1s"], g, layer=2),
        "bidirection_loss_ht": lambda: L.bidirection_loss_ht(
            s["flows"], s["feat1s"], s["feat2s"], c["idx1"], c["gt"],
            c["t_flows"], c["t_feat1s"], c["t_feat2s"], g, b, layer=3),
        "flow_loss_ht": lambda: L.flow_loss_ht(
            s["flows"], s["feat1s"], s["feat2s"], c["idx1"], c["gt"],
            c["t_iter"], c["t_feat1s"], c["t_feat2s"], g, b, layer=1),
        "att_iter_loss": lambda: L.att_iter_loss(
            s["flows"], c["idx1"], c["gt"], c["t_iter"], c["t_idx1"], g,
            layers=(1, 2)),
        "att_ht_loss": lambda: L.att_ht_loss(
            s["flows"], s["c_feat1s"], s["c_feat2s"], c["idx1"], c["gt"],
            c["t_iter"], c["t_c1"], c["t_c2"], c["t_idx1"], g,
            layers=(1, 2)),
        "cross_bidirection_loss_ht": lambda: L.cross_bidirection_loss_ht(
            s["flows"], s["wide1s"], c["idx1"], c["gt"], c["t_flows"],
            c["t_feat1s"], c["t_feat2s"], g, b, layer=(2, 3)),
        "cross_loss": lambda: L.cross_loss(
            s["flows"], s["crosses"], c["idx1"], c["gt"], c["t_flows"],
            c["t_crosses"], g, b),
        "bridge_ht_loss": lambda: L.bridge_ht_loss(
            s["flows"], s["feat1s"], s["feat2s"], c["idx1"], c["gt"],
            c["t_flows"], s["br1"], s["br2"], g, b, layer=3),
        "bridge_ht_loss_iter": lambda: L.bridge_ht_loss_iter(
            s["flows"], s["feat1s"], s["feat2s"], c["idx1"], c["gt"],
            c["t_flows"], s["br1s"], s["br2s"], g, b, layer=(2, 3)),
        "double_bridge_ht_loss": lambda: L.double_bridge_ht_loss(
            s["flows"], s["feat1s"], s["feat2s"], c["idx1"], s["crosses"],
            c["gt"], c["t_flows"], s["br1"], s["br2"], s["br_crosses"],
            (0.5, 0.3, 0.2), b, layer=3),
    }


NAMES = sorted(_losses(port_kd, {}, {}))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_every_loss_of_the_jax_package_is_covered():
    public = {n for n in dir(jax_kd) if not n.startswith("_")
              and callable(getattr(jax_kd, n)) and n not in (
                  "downsample_gt", "multi_scale_loss", "safe_norm")}
    assert len(public) == 13
    assert public == {n for n in NAMES if not n.endswith("_teacher")}
    for name in public:
        assert callable(getattr(port_kd, name)), name


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_jax(name):
    s_np, c_np = _data()
    c_jax = _map(jnp.asarray, c_np)

    def jax_loss(s):
        return _losses(jax_kd, s, c_jax)[name]()

    want, want_g = jax.value_and_grad(jax_loss)(_map(jnp.asarray, s_np))
    s_t = _map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), s_np)
    got = _losses(port_kd, s_t, _map(torch.from_numpy, c_np))[name]()
    assert float(got.detach()) == pytest.approx(float(want), rel=REL)
    leaves = _leaves(s_t)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    n_used = 0
    for g, w, x in zip(grads, _leaves(want_g), leaves):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == x.shape
        n_used += bool(np.abs(w).max() > 0)
        assert np.abs(g - w).max() <= REL * max(np.abs(w).max(), 1e-30)
    assert n_used >= 4


def _outputs(s, c, student=True, wide=False):
    """A model-output dict of the synthetic data (student or teacher)."""
    if student:
        return dict(flows=s["flows"], fps_idx1=c["idx1"], fps_idx2=c["idx2"],
                    feat1s=s["wide1s"] if wide else s["feat1s"],
                    feat2s=s["feat2s"], crosses=s["crosses"])
    return dict(flows=c["t_flows"], fps_idx1=c["t_idx1"],
                fps_idx2=c["idx2"], feat1s=c["t_feat1s"],
                feat2s=c["t_feat2s"], crosses=c["t_crosses"])


@pytest.mark.parametrize("name", [
    "loss_fn_kd_2", "attentiveImitationLoss", "biDirectionLoss",
    "biDirection_loss_ht", "cross_biDirection_loss_ht", "cross_loss"])
def test_named_loss_matches_jax(name):
    """make_named_loss with the shipped config's hyperparameters (gamma
    0.3, beta 0.8, hint layers [2, 3]) and gamma2 0.6: 1e-5 relative."""
    args = dict(gamma=GAMMA, beta=BETA, gamma2=GAMMA2, hint_layers=[2, 3])
    s_np, c_np = _data(1)
    wide = name == "cross_biDirection_loss_ht"
    jx = _map(jnp.asarray, (s_np, c_np))
    want = jax_dexp.make_named_loss(name, args)(
        _outputs(*jx, wide=wide), _outputs(*jx, student=False),
        {"flow": jx[1]["gt"]}, t_history=c_np["hist"])
    th = _map(torch.from_numpy, (s_np, c_np))
    got = make_named_loss(name, args)(
        _outputs(*th, wide=wide), _outputs(*th, student=False),
        {"flow": th[1]["gt"]}, t_history=c_np["hist"])
    assert float(got) == pytest.approx(float(want), rel=REL)


def test_named_loss_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown kd loss"):
        make_named_loss("nope", {})(None, None, None)
