"""Segmentation losses (port of ``nnuzoo_tpu/training/losses.py``).

Memory-efficient soft dice (no fp/fn maps), Dice+CE with ignore-label masking,
Dice+BCE for region-based training (the ignore mask is the last target
channel), deep-supervision weights 1/2^i with the lowest output skipped.
Logits are (B, C, *spatial), label targets (B, 1, *spatial).
"""

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """labels (B, 1, *spatial) -> (B, C, *spatial) float one-hot."""
    classes = torch.arange(num_classes, dtype=labels.dtype, device=labels.device)
    classes = classes.reshape((1, num_classes) + (1,) * (labels.dim() - 2))
    return (labels == classes).float()


def memory_efficient_soft_dice(probs, target, batch_dice: bool = False,
                               do_bg: bool = True, smooth: float = 1.0,
                               loss_mask: Optional[torch.Tensor] = None):
    """probs (B, C, *spatial) after the nonlinearity; target (B, 1, *spatial)
    labels or (B, C, *spatial) one-hot. Returns -mean dice."""
    if target.shape != probs.shape:
        y_onehot = _onehot(target, probs.shape[1])
    else:
        y_onehot = target.float()
    if not do_bg:
        probs = probs[:, 1:]
        y_onehot = y_onehot[:, 1:]

    axes = tuple(range(2, probs.dim()))
    if loss_mask is None:
        intersect = (probs * y_onehot).sum(axes)
        sum_pred = probs.sum(axes)
        sum_gt = y_onehot.sum(axes)
    else:
        intersect = (probs * y_onehot * loss_mask).sum(axes)
        sum_pred = (probs * loss_mask).sum(axes)
        sum_gt = (y_onehot * loss_mask).sum(axes)
    if batch_dice:
        intersect, sum_pred, sum_gt = intersect.sum(0), sum_pred.sum(0), sum_gt.sum(0)
    dc = (2 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth, min=1e-8)
    return -dc.mean()


def _nll(logits, labels):
    logp = F.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, labels[:, None].long())[:, 0]


def robust_cross_entropy(logits, labels, loss_mask: Optional[torch.Tensor] = None):
    """logits (B, C, *spatial), labels (B, *spatial) int. Mean CE over the
    voxels of the mask."""
    nll = _nll(logits, labels)
    if loss_mask is not None:
        m = loss_mask.to(nll.dtype)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def topk_cross_entropy(logits, labels, k_percent: float = 10.0,
                       loss_mask: Optional[torch.Tensor] = None):
    """Mean CE of the worst k% voxels."""
    nll = _nll(logits, labels)
    if loss_mask is not None:
        nll = torch.where(loss_mask.bool(), nll, torch.zeros_like(nll))
    flat = nll.reshape(-1)
    k = max(1, int(flat.shape[0] * k_percent / 100))
    return torch.topk(flat, k)[0].mean()


def dice_ce_loss(logits, target, batch_dice: bool, ignore_label: Optional[int] = None,
                 weight_ce: float = 1.0, weight_dice: float = 1.0,
                 smooth: float = 1e-5):
    """Label-based compound loss: softmax dice without background + CE;
    ``ignore_label`` masks both."""
    target = target.long()
    if ignore_label is not None:
        mask = target != ignore_label
        target_dice = torch.where(mask, target, torch.zeros_like(target))
    else:
        mask = None
        target_dice = target

    probs = F.softmax(logits, dim=1)
    dc = memory_efficient_soft_dice(probs, target_dice, batch_dice=batch_dice,
                                    do_bg=False, smooth=smooth, loss_mask=mask)
    # the gather runs on the labels with ignore replaced by 0: the ignore
    # value may exceed C-1, and those voxels are masked out of the mean
    ce = robust_cross_entropy(logits, target_dice[:, 0],
                              loss_mask=mask[:, 0] if mask is not None else None)
    if ignore_label is not None:
        ce = torch.where(mask.sum() > 0, ce, torch.zeros_like(ce))
    return weight_ce * ce + weight_dice * dc


def dice_bce_loss(logits, target, batch_dice: bool, use_ignore_label: bool = False,
                  weight_ce: float = 1.0, weight_dice: float = 1.0,
                  smooth: float = 1e-5):
    """Region-based compound loss: sigmoid dice with background + BCE over
    one-hot region targets; with ``use_ignore_label`` the last target channel
    marks the ignored voxels (mask = 1 - target[:, -1:])."""
    if use_ignore_label:
        mask = (1 - target[:, -1:]).float()
        target_regions = target[:, :-1].float()
    else:
        mask = None
        target_regions = target.float()

    probs = torch.sigmoid(logits)
    dc = memory_efficient_soft_dice(probs, target_regions, batch_dice=batch_dice,
                                    do_bg=True, smooth=smooth, loss_mask=mask)
    per_pixel = torch.clamp(logits, min=0) - logits * target_regions + \
        torch.log1p(torch.exp(-logits.abs()))
    if mask is not None:
        # the BCE is summed over all region channels and divided by the sum of
        # the one-channel mask only
        bce = (per_pixel * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        bce = per_pixel.mean()
    return weight_ce * bce + weight_dice * dc


def get_deep_supervision_weights(num_outputs: int) -> np.ndarray:
    """1/2^i per output, the lowest set to 0, normalised."""
    weights = np.array([1 / (2 ** i) for i in range(num_outputs)])
    if num_outputs > 1:
        weights[-1] = 0
    return weights / weights.sum()


def deep_supervision_loss(loss_fn, outputs: Sequence[torch.Tensor],
                          targets: Sequence[torch.Tensor], weights=None):
    """Outputs of weight zero are skipped, not scaled: their targets may have
    another shape."""
    if weights is None:
        weights = get_deep_supervision_weights(len(outputs))
    weights = np.asarray(weights)
    total = 0.0
    for w, o, t in zip(weights, outputs, targets):
        if float(w) == 0.0:
            continue
        total = total + float(w) * loss_fn(o, t)
    return total


def hard_dice_stats(logits, target, num_classes: int, has_regions: bool,
                    ignore_label_mask: Optional[torch.Tensor] = None):
    """Per-class tp/fp/fn of the argmax (or thresholded) prediction, for the
    pseudo dice of validation. Shape (C_fg,): classes 1..C-1 for labels."""
    if has_regions:
        pred = (torch.sigmoid(logits) > 0.5).float()
        gt = target.float()
    else:
        pred_labels = logits.argmax(1, keepdim=True)
        classes = torch.arange(1, num_classes, device=logits.device).reshape(
            (1, num_classes - 1) + (1,) * (logits.dim() - 2))
        pred = (pred_labels == classes).float()
        gt = (target == classes).float()

    axes = (0,) + tuple(range(2, pred.dim()))
    if ignore_label_mask is not None:
        pred = pred * ignore_label_mask
        gt = gt * ignore_label_mask
    tp = (pred * gt).sum(axes)
    fp = (pred * (1 - gt)).sum(axes)
    fn = ((1 - pred) * gt).sum(axes)
    return tp, fp, fn
