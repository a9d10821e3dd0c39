"""The port's train path against the reference PyTorch trainer's own run.

evidence/fixtures/overfit.npz holds 8 fixed batches of 2 x 4096-point
KITTI pairs and the per-step loss and train-mode l0 EPE3D of 400 steps of
the reference trainer (Adam lr 1e-3, weight decay 1e-4) from
overfit_init.pth, plus overfit_selfdiv.npz, the same run from an init
perturbed by 1 ulp: the envelope any float32 reimplementation is judged
against (tests/test_train_parity.py TestConvergenceParity holds the JAX
package to it). The weights reach the port through the JAX package's .pth
reader and params_from_jax.

- One train step (tier-1): before any update, the loss and EPE3D depend
  on the init and the batch alone, so they match the reference's first
  step at rounding scale.
- The whole 400-step trajectory (-m slow, about 80 minutes a run on the
  CPU): the assertions of TestConvergenceParity, for the port from the
  fixture's init, for the port from that init perturbed by 1 ulp as the
  reference's control was (the port's own float32 chaos), and for the JAX
  package's run_trajectory on the same fixture. Each run prints its tails;
  select one with -k.
"""

from pathlib import Path

import jax  # noqa: F401  (the port's test files import both frameworks)
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.models.torch_import import load_torch_checkpoint
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            params_from_jax)
from kd_pointcloud_tpu_torch.train import overfit
from kd_pointcloud_tpu_torch.train.overfit import (load_overfit_batches,
                                                   run_trajectory)

FIXTURES = Path(__file__).resolve().parents[1] / "evidence" / "fixtures"
TAIL = 50


def _reference_init():
    """The fixture's init as the JAX package's (params, batch_stats)."""
    return load_torch_checkpoint(str(FIXTURES / "overfit_init.pth"))


def _model(perturb=False):
    params, stats = _reference_init()
    model = BidPointFlowNet(PRESETS["teacher"], device="cpu")
    sd = params_from_jax({"params": params, "batch_stats": stats})
    if perturb:
        # the reference control's perturbation: v + |v| 1e-7 on every float
        # entry of the init (make_train_parity_fixture.py overfit mode)
        sd = {k: v + v.abs() * 1e-7 if v.is_floating_point() else v
              for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model


def _trajectory(n_steps, perturb=False):
    batches = load_overfit_batches(str(FIXTURES / "overfit.npz"), "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        losses, epes, _ = run_trajectory(_model(perturb), batches, n_steps,
                                         log_every=0)
    finally:
        torch.set_num_threads(threads)
    return losses, epes


def _jax_trajectory(n_steps):
    """The JAX package's run_trajectory on the fixture, as
    TestConvergenceParity runs it on the CPU (exact kNN)."""
    import dataclasses

    from kd_pointcloud_tpu.models import PRESETS as JAX_PRESETS
    from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
    from kd_pointcloud_tpu.train import overfit as jax_overfit

    cfg = dataclasses.replace(JAX_PRESETS["teacher"], knn_method="exact",
                              knn_precision="highest")
    params, stats = _reference_init()
    batches = jax_overfit.load_overfit_batches(str(FIXTURES / "overfit.npz"))
    losses, epes, _ = jax_overfit.run_trajectory(
        JaxNet(cfg), params, stats, batches, n_steps, log_every=0)
    return losses, epes


def test_first_train_step_matches_reference_trainer():
    """Step 1's loss and EPE3D within 1e-5 relative of the reference
    trainer's (measured: loss equal, EPE3D 1e-7)."""
    z = np.load(FIXTURES / "overfit.npz")
    losses, epes = _trajectory(1)
    assert abs(losses[0] - z["losses"][0]) <= 1e-5 * z["losses"][0]
    assert abs(epes[0] - z["epes"][0]) <= 1e-5 * z["epes"][0]


def test_entry_from_the_reference_pth_matches_first_step():
    """python -m kd_pointcloud_tpu_torch.train.overfit --init
    overfit_init.pth: the port's own .pth reader carries the fixture's init
    (no JAX on the way), and step 1 gives the reference trainer's loss and
    EPE3D within 1e-5 relative."""
    z = np.load(FIXTURES / "overfit.npz")
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        summary = overfit.main(["--device", "cpu", "--steps", "1",
                                "--npz", str(FIXTURES / "overfit.npz"),
                                "--init", str(FIXTURES / "overfit_init.pth")])
    finally:
        torch.set_num_threads(threads)
    assert summary["init"].endswith("overfit_init.pth")
    assert abs(summary["loss_first"] - z["losses"][0]) <= 1e-5 * z["losses"][0]
    assert abs(summary["epe_first"] - z["epes"][0]) <= 1e-5 * z["epes"][0]


RUNS = {"port": lambda n: _trajectory(n),
        "port_1ulp": lambda n: _trajectory(n, perturb=True),
        "jax": _jax_trajectory}


@pytest.mark.slow
class TestOverfitTrajectory:
    """400 steps against the reference trainer's run and its 1-ulp
    control, with TestConvergenceParity's bounds, for each run of RUNS."""

    @pytest.fixture(scope="class", params=sorted(RUNS))
    def traj(self, request):
        z = np.load(FIXTURES / "overfit.npz")
        zc = np.load(FIXTURES / "overfit_selfdiv.npz")
        losses, epes = RUNS[request.param](int(z["n_steps"]))
        print(f"{request.param}: loss {losses[0]:.4f} -> tail "
              f"{np.mean(losses[-TAIL:]):.4f}"
              f", EPE3D tail {np.mean(epes[-TAIL:]):.4f}; reference: tail "
              f"{np.mean(z['losses'][-TAIL:]):.4f}, "
              f"{np.mean(z['epes'][-TAIL:]):.4f}; 1-ulp control: tail "
              f"{np.mean(zc['losses'][-TAIL:]):.4f}, "
              f"{np.mean(zc['epes'][-TAIL:]):.4f}")
        return dict(ours_l=losses, ours_e=epes, torch_l=z["losses"],
                    torch_e=z["epes"], ctrl_l=zc["losses"],
                    ctrl_e=zc["epes"])

    @staticmethod
    def _tail(a):
        return float(np.mean(a[-TAIL:]))

    def test_loss_descends_to_reference_depth(self, traj):
        ours0, ours_t = traj["ours_l"][0], self._tail(traj["ours_l"])
        torch_t = self._tail(traj["torch_l"])
        assert ours_t < ours0 / 5
        ctrl_dev = abs(self._tail(traj["ctrl_l"]) - torch_t) / torch_t
        assert abs(ours_t - torch_t) / torch_t < max(5 * ctrl_dev, 0.30)

    def test_epe_reaches_trained_regime(self, traj):
        ours_e, torch_e = self._tail(traj["ours_e"]), self._tail(
            traj["torch_e"])
        ctrl_e = self._tail(traj["ctrl_e"])
        assert ours_e < 0.15
        assert abs(ours_e - torch_e) < max(5 * abs(ctrl_e - torch_e), 0.05)
