"""Training losses.

Counterpart of the JAX package's `train/losses.py` (reference
`crowdsam/utils.py`: dice_loss, mIoU, sigmoid_focal_loss, and the composite
adapter loss of `tools/train.py:147-204`), with its extensions: the mask
dice term of full-decoder training and the negative hinge.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """inputs (B, K, ...) logits, targets (B, 1|K, ...) binary -> (B, K)
    per-pair losses over the flattened trailing dims."""
    probs = torch.sigmoid(inputs)
    b, k = probs.shape[0], probs.shape[1]
    probs = probs.reshape(b, k, -1)
    targets = targets.reshape(targets.shape[0], targets.shape[1], -1)
    numerator = 2 * (probs * targets).sum(-1)
    denominator = probs.sum(-1) + targets.sum(-1)
    return 1 - (numerator + 1) / (denominator + 1)


def miou(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """inputs (B, K, H, W) logits, targets (B, 1, H, W) binary -> (B, K) IoU
    of the binarized inputs against the targets (no gradient)."""
    mask_bin = (inputs > 0).float()
    b, k = mask_bin.shape[0], mask_bin.shape[1]
    mask_bin = mask_bin.reshape(b, k, -1)
    targets = targets.reshape(targets.shape[0], targets.shape[1], -1).float()
    inter = (mask_bin * targets).sum(-1)
    union = mask_bin.sum(-1) + targets.sum(-1) - inter
    return inter / union.clamp_min(1e-9)


def sigmoid_focal_loss(preds: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """RetinaNet focal loss, summed over the last dim, then the mean."""
    p = torch.sigmoid(preds)
    ce = F.relu(preds) - preds * targets + torch.log1p(
        torch.exp(-preds.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.sum(-1).mean()


def adapter_loss(low_res_masks: torch.Tensor, fused_iou: torch.Tensor,
                 cls_logits: torch.Tensor, target_masks: torch.Tensor,
                 fg_mask: torch.Tensor, region_valid: torch.Tensor,
                 num_pos: int, mask_loss: bool = False,
                 neg_hinge_weight: float = 0.0,
                 neg_hinge_margin: float = 0.05) -> Dict[str, torch.Tensor]:
    """The composite adapter loss.

    low_res_masks (P, K, R, R) logits; fused_iou (P, K) = iou_pred *
    sigmoid(cls); cls_logits (C, R, R) FG-map logits; target_masks (P_pos,
    R, R) binary; fg_mask, region_valid (R, R).  Terms: the squared error
    of the fused IoU against each positive's true mIoU (0 for negatives),
    split positive/negative; the dice of the FG map against the union of
    the boxes over the valid region; with `mask_loss`, the best-of-K dice
    of the positives' masks; with `neg_hinge_weight`, a square hinge on the
    negatives' fused scores above `neg_hinge_margin`."""
    pos_masks = low_res_masks[:num_pos]
    iou_true = miou(pos_masks, target_masks[:, None])
    iou_target = torch.cat([iou_true, torch.zeros_like(
        fused_iou[num_pos:])], dim=0)
    cls_loss = (fused_iou - iou_target).square().sum(1)
    v = region_valid[None]
    fg_dice = dice_loss((cls_logits * v - 1e4 * (1 - v))[None],
                        (fg_mask[None] * v)[None]).mean()
    out = {
        "pos_cls_loss": cls_loss[:num_pos].mean(),
        "neg_cls_loss": cls_loss[num_pos:].mean(),
        "dice_loss": fg_dice,
    }
    if mask_loss:
        # amin: the gradient shared among equal heads, as jnp.min shares it
        # (saturated heads tie).
        per_k = dice_loss(pos_masks, target_masks[:, None])
        out["mask_dice_loss"] = per_k.amin(dim=1).mean()
    if neg_hinge_weight > 0.0:
        h = F.relu(fused_iou[num_pos:] - neg_hinge_margin)
        out["neg_hinge_loss"] = neg_hinge_weight * h.square().sum(1).mean()
    return out
