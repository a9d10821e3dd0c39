"""The output of every reference network (reference/nets/<net>.py), as the
KD losses, reference/train.py and the entries read it: a dict of

* flows: the flow of each level, fine -> coarse, (B, N_l, 3); a level that
  refines its flow several times holds the list of its iterations';
* fps_idx1, fps_idx2: (B, N_l) int32, the rows of level l - 1 that make
  level l, l = 1.., of the first and the second cloud;
* feat1s, feat2s: the feature maps that the KD losses' hints read, (B,
  N, C) each.
"""

from __future__ import annotations

import torch


def flow0(out) -> torch.Tensor:
    """The finest flow: the last iteration's where l0 holds a list."""
    f = out["flows"][0]
    return f[-1] if isinstance(f, (list, tuple)) else f
