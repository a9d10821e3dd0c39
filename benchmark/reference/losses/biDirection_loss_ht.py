"""biDirection_loss_ht (KD-PointCloud loss_functions.py): a blend of
imitating the teacher's finest flow and the ground truth through the
student's FPS chain, plus both clouds' feature hints at one layer (the last
of hint_layers). Workload keys: gamma, beta, hint_layers."""

from benchmark.reference.outputs import flow0
from benchmark.reference.train import multi_scale_loss


def loss(spec: dict):
    """fn(student outputs, teacher outputs, batch) -> the loss."""
    gamma, beta, layer = spec["gamma"], spec["beta"], spec["hint_layers"][-1]

    def fn(s, t, batch):
        blend = (gamma * multi_scale_loss(s["flows"], flow0(t),
                                          s["fps_idx1"])
                 + (1 - gamma) * multi_scale_loss(s["flows"], batch["flow"],
                                                  s["fps_idx1"]))
        src = (((s["feat1s"][layer] - t["feat1s"][layer]) ** 2) / 2).sum()
        tgt = (((s["feat2s"][layer] - t["feat2s"][layer]) ** 2) / 2).sum()
        return beta * blend + (1 - beta) * (0.5 * src + 0.5 * tgt)

    return fn
