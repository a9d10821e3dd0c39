"""The port's self-supervised loss (losses/selfsup.py) against the JAX
package's, on the CPU.

Seeded numpy clouds at four levels go through both: every helper and the
multi-scale total within 1e-5 relative (sums over the points), the
gradients with respect to the flows within 1e-5 of their max, and JAX's
perfect-flow case. The loss's kNN sites run at k = 5, 9 and 10; the
kernel's selection rule at the (k, L) that knn_plan picks there is held
bit for bit by tests/test_torch_port_redesign.py (KERNEL_K).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.losses import selfsup as jax_selfsup
from kd_pointcloud_tpu_torch import losses
from kd_pointcloud_tpu_torch.models import PRESETS
from kd_pointcloud_tpu_torch.ops import knn as knn_mod

torch.set_num_threads(1)

SIZES = (128, 64, 32, 16)
RTOL = 1e-5


def _levels(seed, B=2):
    rng = np.random.RandomState(seed)
    pc1 = [rng.uniform(-2, 2, (B, n, 3)).astype(np.float32) for n in SIZES]
    flows = [(0.1 * rng.standard_normal((B, n, 3))).astype(np.float32)
             for n in SIZES]
    pc2 = [(p + f + 0.02 * rng.standard_normal(p.shape)).astype(np.float32)
           for p, f in zip(pc1, flows)]
    pred = [(f + 0.05 * rng.standard_normal(f.shape)).astype(np.float32)
            for f in flows]
    return pc1, pc2, pred


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _helper_outputs(mod, to, pc1, pc2, flow):
    """Each helper on level-0 inputs, as a dict of (B, N[, 3]) arrays."""
    p1, p2, f = to(pc1), to(pc2), to(flow)
    warped = p1 + f
    curv2 = mod.curvature(p2)
    d1, d2 = mod.chamfer(warped, p2)
    return {"curvature": curv2,
            "curvature_of_warped": mod.curvature_of_warped(p1, warped),
            "chamfer_1": d1, "chamfer_2": d2,
            "smoothness": mod.smoothness(p1, f),
            "interpolate_curvature": mod.interpolate_curvature(warped, p2,
                                                               curv2)}


HELPERS = ("curvature", "curvature_of_warped", "chamfer_1", "chamfer_2",
           "smoothness", "interpolate_curvature")


@pytest.fixture(scope="module")
def helpers():
    pc1, pc2, pred = _levels(0)
    want = _helper_outputs(jax_selfsup, jnp.asarray, pc1[0], pc2[0], pred[0])
    got = _helper_outputs(losses, _t, pc1[0], pc2[0], pred[0])
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_jax(helpers, name):
    want, got = helpers
    assert got[name].shape == want[name].shape
    # per cloud, summed over its points, as the loss sums them (a point's
    # expansion distance near 0 differs by the float32 rounding of
    # |x|^2 ~ 10 between the two packages' sums of products)
    np.testing.assert_allclose(got[name].sum(1), want[name].sum(1),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_total_and_flow_gradients_match_jax(seed):
    pc1, pc2, pred = _levels(seed)

    def jax_total(flows):
        return jax_selfsup.multi_scale_chamfer_smooth_curvature(
            [jnp.asarray(p) for p in pc1], [jnp.asarray(p) for p in pc2],
            flows)

    (want, *want_parts), want_grads = (
        jax_total([jnp.asarray(f) for f in pred]),
        jax.grad(lambda fl: jax_total(fl)[0])([jnp.asarray(f) for f in pred]))
    flows = [_t(f).requires_grad_() for f in pred]
    total, *parts = losses.multi_scale_chamfer_smooth_curvature(
        [_t(p) for p in pc1], [_t(p) for p in pc2], flows)
    total.backward()
    for g, w in zip([total, *parts], [want, *want_parts]):
        assert float(g.detach()) == pytest.approx(float(w), rel=RTOL)
    top = max(float(np.abs(g).max()) for g in want_grads)
    for f, w in zip(flows, want_grads):
        assert np.abs(f.grad.numpy() - np.asarray(w)).max() <= RTOL * top


def test_perfect_flow_matches_jax():
    """tests/test_losses.py's case: pc2 = pc1 + 0.1 and the flow 0.1
    everywhere, so chamfer ~0, smoothness 0 and curvature ~0; the port's
    four values equal JAX's."""
    rng = np.random.RandomState(0)
    pc1 = [rng.randn(1, n, 3).astype(np.float32) for n in (32, 16)]
    pc2 = [p + np.float32(0.1) for p in pc1]
    flows = [np.full_like(p, 0.1) for p in pc1]
    got = losses.multi_scale_chamfer_smooth_curvature(
        [_t(p) for p in pc1], [_t(p) for p in pc2], [_t(f) for f in flows])
    want = jax_selfsup.multi_scale_chamfer_smooth_curvature(
        [jnp.asarray(p) for p in pc1], [jnp.asarray(p) for p in pc2],
        [jnp.asarray(f) for f in flows])
    total, ch, cu, sm = (float(v) for v in got)
    assert ch == pytest.approx(0.0, abs=1e-5)
    assert sm == pytest.approx(0.0, abs=1e-6)
    assert cu == pytest.approx(0.0, abs=1e-4)
    for g, w in zip((total, ch, cu, sm), want):
        assert g == pytest.approx(float(w), rel=RTOL, abs=1e-7)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_knn_plan_at_the_loss_sites(batch):
    """The loss's kNN sites on a model's levels (8192, 2048, 512, 256
    points): k = 10 and 9 over each level's own cloud, k = 5 from the
    warped cloud into the second. The plan picks L >= k lanes, which the
    striped rule's tests cover, and one or more queries a block."""
    for n in PRESETS["teacher"].npoints[:4]:
        for k in (5, 9, 10):
            assert k in knn_mod.KERNEL_K
            lanes, qpb = knn_mod.knn_plan(batch, n, n, k)
            assert lanes in knn_mod.KERNEL_LANES and lanes >= max(k, 4)
            assert qpb >= 1 and lanes * qpb <= knn_mod.MAX_THREADS
            assert (lanes * qpb) % 32 == 0


@pytest.mark.parametrize("need", ["query", "keys", "both"])
def test_knn_distance_gradient_of_the_card_path(monkeypatch, need):
    """On the card the distances' gradient is _KnnFunction's backward of
    the expansion at the selected keys; with the plain version in the
    kernel's place it equals autograd of knn_plain (through its sort)."""
    monkeypatch.setattr(knn_mod, "_knn_cuda", knn_mod.knn_plain)
    rng = np.random.RandomState(5)
    keys = _t(rng.uniform(-1, 1, (2, 90, 3)).astype(np.float32))
    query = _t(rng.uniform(-1, 1, (2, 30, 3)).astype(np.float32))
    ct = _t(rng.standard_normal((2, 30, 5)).astype(np.float32))
    grads = []
    for entry in (knn_mod._knn_card, knn_mod.knn_plain):
        k_, q_ = keys.clone(), query.clone()
        k_.requires_grad_(need in ("keys", "both"))
        q_.requires_grad_(need in ("query", "both"))
        d2, idx = entry(5, k_, q_)
        assert not idx.requires_grad
        (d2 * ct).sum().backward()
        grads.append([t.grad for t in (k_, q_)])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            # float32 sums of the same terms in another order
            torch.testing.assert_close(
                got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
