"""Knowledge-distillation losses.

Port of kd_pointcloud_tpu/losses/kd.py: the 13 losses of the reference's
loss_functions.py, with the JAX package's names, argument order and
channels-last tensors. Argument conventions:

  * ``outputs`` / ``teacher_outputs``: multi-scale flow lists, fine ->
    coarse, each (B, Nl, 3); for an iterative teacher the entries of levels
    0..2 are per-iteration lists.
  * ``feat1s`` / ``feat2s``, ``c_feat1s`` / ``c_feat2s``, ``crosses``: the
    model-output feature lists, (B, Nl, C).
  * ``fps_idxs*``: FPS index chains.

The JAX package's two documented repairs are kept, not the reference's
bugs: ``flow_loss_ht`` is the reference's evident intent (GT supervision
plus per-level teacher matching plus hints; the reference's version uses
undefined names), and ``_distil_ratios`` returns per-layer (B, iters)
matrices indexed [layer][:, iter] (the reference transposes layer and
iteration).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .multiscale import ALPHA, downsample_gt, multi_scale_loss, safe_norm


def _flow0(teacher_outputs):
    """Finest teacher flow; the last iteration's if the entry is a list."""
    t0 = teacher_outputs[0]
    return t0[-1] if isinstance(t0, (list, tuple)) else t0


def _half_sq(a, b):
    """sum((a - b)^2 / 2)."""
    return (((a - b) ** 2) / 2).sum()


def _blend(outputs, fps_idxs1, gt_flow, teacher_outputs, gamma, alpha):
    """gamma * (imitation of the teacher's finest flow) + (1 - gamma) * (GT
    supervision), both through the student's pc1 FPS chain."""
    loss1 = multi_scale_loss(outputs, _flow0(teacher_outputs), fps_idxs1,
                             alpha)
    loss2 = multi_scale_loss(outputs, gt_flow, fps_idxs1, alpha)
    return gamma * loss1 + (1 - gamma) * loss2


def loss_fn_kd_2(outputs, fps_idxs, gt_flow, teacher_outputs,
                 teacher_fps_idxs, gamma, alpha=ALPHA):
    """Flow-imitation blending (loss_functions.py:27-36)."""
    return _blend(outputs, fps_idxs, gt_flow, teacher_outputs, gamma, alpha)


def attentive_imitation_loss(outputs, fps_idxs, gt_flow, teacher_outputs,
                             teacher_fps_idxs, t_history, gamma, alpha=ALPHA):
    """Teacher-error-weighted imitation (loss_functions.py:38-51); t_history
    is the teacher's loss over the train set (compute_teacher_history)."""
    loss_st = multi_scale_loss(outputs, _flow0(teacher_outputs), fps_idxs,
                               alpha)
    loss_sg = multi_scale_loss(outputs, gt_flow, fps_idxs, alpha)
    loss_tg = multi_scale_loss(teacher_outputs, gt_flow, teacher_fps_idxs,
                               alpha)
    hist = torch.as_tensor(t_history, dtype=torch.float32)
    sigma = 1 - loss_tg / float(hist.max() - hist.min())
    return gamma * loss_sg + (1 - gamma) * sigma * loss_st


def bidirection_loss(outputs, fps_idxs1, fps_idxs2, gt_flow, teacher_outputs,
                     teacher_fps_idxs, gamma1, gamma2, beta, alpha=ALPHA):
    """The blend through both clouds' FPS chains (loss_functions.py:53-66)."""
    t0 = _flow0(teacher_outputs)
    g1 = multi_scale_loss(outputs, gt_flow, fps_idxs1, alpha)
    g2 = multi_scale_loss(outputs, gt_flow, fps_idxs2, alpha)
    k1 = multi_scale_loss(outputs, t0, fps_idxs1, alpha)
    k2 = multi_scale_loss(outputs, t0, fps_idxs2, alpha)
    return (beta * (gamma1 * k1 + (1 - gamma1) * g1)
            + (1 - beta) * (gamma2 * k2 + (1 - gamma2) * g2))


def loss_fn_ht(outputs, feat1s, fps_idxs1, gt_flow, teacher_outputs,
               t_feat1s, gamma, layer=0, alpha=ALPHA):
    """Blend + one-layer hint, normalised by feat1s[0]'s size
    (loss_functions.py:69-81)."""
    return (_blend(outputs, fps_idxs1, gt_flow, teacher_outputs, gamma, alpha)
            + _half_sq(feat1s[layer], t_feat1s[layer]) / feat1s[0].numel())


def bidirection_loss_ht(outputs, feat1s, feat2s, fps_idxs1, gt_flow,
                        teacher_outputs, t_feat1s, t_feat2s, gamma, beta,
                        layer=0, alpha=ALPHA):
    """Blend + both clouds' hints at one layer (loss_functions.py:83-96)."""
    src = _half_sq(feat1s[layer], t_feat1s[layer])
    tgt = _half_sq(feat2s[layer], t_feat2s[layer])
    return (beta * _blend(outputs, fps_idxs1, gt_flow, teacher_outputs,
                          gamma, alpha)
            + (1 - beta) * (0.5 * src + 0.5 * tgt))


def flow_loss_ht(outputs, feat1s, feat2s, fps_idxs1, gt_flow, teacher_outputs,
                 t_feat1s, t_feat2s, gamma, beta, layer=0, alpha=ALPHA):
    """Per-level flow matching against the teacher + both clouds' hints.

    The reference's version (loss_functions.py:98-120) uses undefined names;
    this is its evident intent, as in the JAX package: loss1 = GT
    supervision, loss2 = per-level teacher matching."""
    loss1 = multi_scale_loss(outputs, gt_flow, fps_idxs1, alpha)
    loss2 = outputs[0].new_zeros(())
    for i in range(len(outputs)):
        t_i = teacher_outputs[i]
        t_i = t_i[-1] if isinstance(t_i, (list, tuple)) else t_i
        loss2 = loss2 + alpha[i] * safe_norm(outputs[i] - t_i).sum(1).mean()
    src = _half_sq(feat1s[layer], t_feat1s[layer])
    tgt = _half_sq(feat2s[layer], t_feat2s[layer])
    return (beta * (gamma * loss1 + (1 - gamma) * loss2)
            + (1 - beta) * (0.5 * src + 0.5 * tgt))


def _distil_ratios(t_outputs, gt_flows, layers):
    """1 - softmax over iterations of the teacher's per-iteration squared
    error (loss_functions.py:136-144): [n_layers] of (B, n_iters)."""
    ratios = []
    for layer in layers:
        diffs = torch.stack([((t_flow - gt_flows[layer]) ** 2).sum((1, 2))
                             for t_flow in t_outputs[layer]], dim=1)
        ratios.append(1 - F.softmax(diffs, dim=1))
    return ratios


def att_iter_loss(outputs, fps_idxs1, gt_flow, t_outputs, t_fps_idxs1,
                  gamma, layers=(1, 2), alpha=ALPHA):
    """Attentive per-iteration distillation against an iterative teacher
    (loss_functions.py:123-158): each teacher iteration's flow is imitated
    with weight 1 - softmax of its error against GT."""
    loss1 = multi_scale_loss(outputs, gt_flow, fps_idxs1, alpha)
    ratios = _distil_ratios(t_outputs, downsample_gt(gt_flow, t_fps_idxs1),
                            layers)
    src_ht = outputs[0].new_zeros(())
    for i, layer in enumerate(layers):
        for it, t_flow in enumerate(t_outputs[layer]):
            diff = safe_norm(outputs[layer] - t_flow).sum(1)          # (B,)
            src_ht = src_ht + alpha[layer] * (ratios[i][:, it] * diff).sum()
    return gamma * loss1 + (1 - gamma) * src_ht


def att_ht_loss(outputs, c_feat1s, c_feat2s, fps_idxs1, gt_flow, t_outputs,
                t_c_feat1s, t_c_feat2s, t_fps_idxs1, gamma, layers=(1, 2),
                alpha=ALPHA):
    """Attentive per-iteration feature hints (loss_functions.py:160-199):
    the norm runs over the point axis, then channels are summed."""
    loss1 = multi_scale_loss(outputs, gt_flow, fps_idxs1, alpha)
    ratios = _distil_ratios(t_outputs, downsample_gt(gt_flow, t_fps_idxs1),
                            layers)
    src_ht = outputs[0].new_zeros(())
    tgt_ht = outputs[0].new_zeros(())
    for i, layer in enumerate(layers):
        for it in range(len(t_outputs[layer])):
            r = ratios[i][:, it]
            d1 = safe_norm(((c_feat1s[layer] - t_c_feat1s[layer][it]) ** 2)
                           / 2, dim=1).sum(-1)                         # (B,)
            src_ht = src_ht + alpha[layer] * (r * d1).sum()
            d2 = safe_norm(((c_feat2s[layer] - t_c_feat2s[layer][it]) ** 2)
                           / 2, dim=1).sum(-1)
            tgt_ht = tgt_ht + alpha[layer] * (r * d2).sum()
    return gamma * loss1 + (1 - gamma) * 0.5 * (src_ht + tgt_ht)


def cross_bidirection_loss_ht(outputs, feat1s, fps_idxs1, gt_flow,
                              teacher_outputs, t_feat1s, t_feat2s, gamma,
                              beta, layer=(2, 3), alpha=ALPHA):
    """Cross-feature hint: student feat1s[l] mimics the concatenation of
    the teacher's both-cloud features (loss_functions.py:201-219). The
    student's hint layers must be twice the teacher's width, or the
    difference raises."""
    hint = outputs[0].new_zeros(())
    for each in layer:
        t_feats = torch.cat([t_feat1s[each], t_feat2s[each]], dim=-1)
        hint = hint + _half_sq(feat1s[each], t_feats)
    return (beta * _blend(outputs, fps_idxs1, gt_flow, teacher_outputs,
                          gamma, alpha)
            + (1 - beta) * hint)


def cross_loss(outputs, crosses, fps_idxs1, gt_flow, teacher_outputs,
               t_crosses, gamma, beta, alpha=ALPHA):
    """Cost-volume mimic across all levels (loss_functions.py:222-235)."""
    c_loss = outputs[0].new_zeros(())
    for layer in range(len(crosses)):
        c_loss = c_loss + (_half_sq(crosses[layer], t_crosses[layer])
                           / crosses[layer].numel())
    return (beta * _blend(outputs, fps_idxs1, gt_flow, teacher_outputs,
                          gamma, alpha)
            + (1 - beta) * c_loss)


def bridge_ht_loss(outputs, feat1s, feat2s, fps_idxs1, gt_flow,
                   teacher_outputs, br_feat1, br_feat2, gamma, beta,
                   layer=3, alpha=ALPHA):
    """Hints against the Bridge's mixed teacher features
    (loss_functions.py:238-251)."""
    src = _half_sq(feat1s[layer], br_feat1)
    tgt = _half_sq(feat2s[layer], br_feat2)
    return (beta * _blend(outputs, fps_idxs1, gt_flow, teacher_outputs,
                          gamma, alpha)
            + (1 - beta) * (0.5 * src + 0.5 * tgt))


def bridge_ht_loss_iter(outputs, feat1s, feat2s, fps_idxs1, gt_flow,
                        teacher_outputs, br_feat1s, br_feat2s, gamma, beta,
                        layer=(2, 3), alpha=ALPHA):
    """Multi-layer bridge hints (loss_functions.py:253-270): br_feat*s[i]
    pairs with the student's feat*s[layer[i]]."""
    src = outputs[0].new_zeros(())
    tgt = outputs[0].new_zeros(())
    for i, each in enumerate(layer):
        src = src + _half_sq(feat1s[each], br_feat1s[i])
        tgt = tgt + _half_sq(feat2s[each], br_feat2s[i])
    return (beta * _blend(outputs, fps_idxs1, gt_flow, teacher_outputs,
                          gamma, alpha)
            + (1 - beta) * (0.5 * src + 0.5 * tgt))


def double_bridge_ht_loss(outputs, feat1s, feat2s, fps_idxs1, crosses,
                          gt_flow, teacher_outputs, br_feat1, br_feat2,
                          br_crosses, gamma, beta, layer=3, alpha=ALPHA):
    """Bridge hints + cost-volume mimic with a 3-way gamma blend
    (loss_functions.py:274-293); gamma is a 3-sequence."""
    loss1 = multi_scale_loss(outputs, _flow0(teacher_outputs), fps_idxs1,
                             alpha)
    loss2 = multi_scale_loss(outputs, gt_flow, fps_idxs1, alpha)
    loss3 = outputs[0].new_zeros(())
    for i in range(len(br_crosses)):
        loss3 = loss3 + (_half_sq(crosses[i], br_crosses[i])
                         / crosses[i].numel())
    src = _half_sq(feat1s[layer], br_feat1)
    tgt = _half_sq(feat2s[layer], br_feat2)
    return (beta * (gamma[0] * loss1 + gamma[1] * loss2 + gamma[2] * loss3)
            + (1 - beta) * (0.5 * src + 0.5 * tgt))
