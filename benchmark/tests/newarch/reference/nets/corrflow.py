"""A fixture network outside the Bi-PointFlowNet family, found by name
under the test's lookup root (test_bench_nets.py): a per-point encoder of
both clouds, the correlation of each first-cloud point's features with
those of its nei nearest second-cloud points (a kind of call of its own,
"correlation", counted by kernels/correlation.py beside this folder), and
a head to the flow. Its output is the family's dict (reference/outputs.py)
at one level. Model entry keys: reference, name, width, nei."""

import torch
from torch import nn

from benchmark.reference.nn import MLP, Dense
from benchmark.reference.ops import group_points, knn, record

FIELDS = ("reference", "name", "width", "nei")


def correlation(f1, f2, idx):
    """(B, N1, K): the dot product over channels of each f1 row (B, N1, C)
    with the f2 rows (B, N2, C) that idx (B, N1, K) names; no product the
    dense count sees."""
    B, N1, K = idx.shape
    record("correlation", (B, N1, f2.shape[1], K, f1.shape[-1]))
    return (group_points(f2, idx) * f1[:, :, None, :]).sum(-1)


class CorrFlow(nn.Module):
    def __init__(self, width: int, nei: int):
        super().__init__()
        self.nei = nei
        self.encoder = MLP(3, (width, width))
        self.head = MLP(width + nei, (width,))
        self.out = Dense(width, 3)

    def forward(self, xyz1, xyz2, color1, color2):
        B = xyz1.shape[0]
        f = self.encoder(torch.cat([color1, color2]))
        f1, f2 = f[:B], f[B:]
        idx = knn(self.nei, xyz2, xyz1)[1]
        x = self.head(torch.cat([f1, correlation(f1, f2, idx)], -1))
        return dict(flows=[self.out(x)], fps_idx1=[], fps_idx2=[],
                    feat1s=[f1], feat2s=[f2])


def Net(cfg: dict) -> CorrFlow:
    unknown = sorted(set(cfg) - set(FIELDS))
    if unknown:
        raise ValueError(f"reference network corrflow does not know "
                         f"{', '.join(unknown)}")
    return CorrFlow(cfg["width"], cfg["nei"])
