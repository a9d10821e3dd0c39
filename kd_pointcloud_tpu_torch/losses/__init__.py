"""Losses of the port: the multi-scale supervised flow loss."""

from .multiscale import (ALPHA, downsample_gt, multi_scale_loss,
                         multi_scale_loss_per_sample, safe_norm)

__all__ = ["ALPHA", "downsample_gt", "multi_scale_loss",
           "multi_scale_loss_per_sample", "safe_norm"]
