"""Losses of the port: the multi-scale supervised flow loss, the 13
knowledge-distillation losses and the self-supervised Chamfer + smoothness
+ curvature loss."""

from .kd import (att_ht_loss, att_iter_loss, attentive_imitation_loss,
                 bidirection_loss, bidirection_loss_ht, bridge_ht_loss,
                 bridge_ht_loss_iter, cross_bidirection_loss_ht, cross_loss,
                 double_bridge_ht_loss, flow_loss_ht, loss_fn_ht,
                 loss_fn_kd_2)
from .multiscale import (ALPHA, downsample_gt, multi_scale_loss,
                         multi_scale_loss_per_sample, safe_norm)
from .selfsup import (chamfer, curvature, curvature_of_warped,
                      interpolate_curvature,
                      multi_scale_chamfer_smooth_curvature, smoothness)

__all__ = ["ALPHA", "downsample_gt", "multi_scale_loss",
           "multi_scale_loss_per_sample", "safe_norm",
           "att_ht_loss", "att_iter_loss", "attentive_imitation_loss",
           "bidirection_loss", "bidirection_loss_ht", "bridge_ht_loss",
           "bridge_ht_loss_iter", "cross_bidirection_loss_ht", "cross_loss",
           "double_bridge_ht_loss", "flow_loss_ht", "loss_fn_ht",
           "loss_fn_kd_2", "chamfer", "curvature", "curvature_of_warped",
           "interpolate_curvature", "multi_scale_chamfer_smooth_curvature",
           "smoothness"]
