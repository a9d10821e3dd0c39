"""Pairwise squared distances.

Port of kd_pointcloud_tpu/ops/distance.py square_distance. The
|q|^2 - 2 q.k + |k|^2 expansion is kept: exact-kNN index parity with the JAX
package depends on ranking keys by the same expansion. The cross term is
summed coordinate by coordinate, each product and sum rounded on its own, so
the result is the same float on the CPU, on the card and inside the kNN
kernel (csrc/knn.cu), whatever matrix-product library is underneath.
"""

from __future__ import annotations

import torch


def _sum_of_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c] in coordinate order, rounded per op."""
    out = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c] * b[..., c]
    return out


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance between every (src, dst) point pair.

    Args:
      src: (..., N, C) query points.
      dst: (..., M, C) reference points.

    Returns:
      (..., N, M) squared distances.
    """
    s2 = _sum_of_products(src, src)[..., :, None]
    d2 = _sum_of_products(dst, dst)[..., None, :]
    cross = _sum_of_products(src[..., :, None, :], dst[..., None, :, :])
    return s2 - 2.0 * cross + d2
