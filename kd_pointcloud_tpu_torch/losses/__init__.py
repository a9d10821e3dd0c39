"""Losses of the port: the multi-scale supervised flow loss and the 13
knowledge-distillation losses."""

from .kd import (att_ht_loss, att_iter_loss, attentive_imitation_loss,
                 bidirection_loss, bidirection_loss_ht, bridge_ht_loss,
                 bridge_ht_loss_iter, cross_bidirection_loss_ht, cross_loss,
                 double_bridge_ht_loss, flow_loss_ht, loss_fn_ht,
                 loss_fn_kd_2)
from .multiscale import (ALPHA, downsample_gt, multi_scale_loss,
                         multi_scale_loss_per_sample, safe_norm)

__all__ = ["ALPHA", "downsample_gt", "multi_scale_loss",
           "multi_scale_loss_per_sample", "safe_norm",
           "att_ht_loss", "att_iter_loss", "attentive_imitation_loss",
           "bidirection_loss", "bidirection_loss_ht", "bridge_ht_loss",
           "bridge_ht_loss_iter", "cross_bidirection_loss_ht", "cross_loss",
           "double_bridge_ht_loss", "flow_loss_ht", "loss_fn_ht",
           "loss_fn_kd_2"]
