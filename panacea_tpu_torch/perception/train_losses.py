"""Detection training losses of the StreamPETR head.

Counterpart of ``panacea_tpu/perception/train_losses.py``: the reference's
HungarianAssigner3D (scipy matching, hungarian_assigner_3d.py), the sigmoid
focal classification loss (mmdet FocalLoss, gamma 2, alpha 0.25) and the
code-weighted L1 box loss (loss_cls weight 2.0, loss_bbox 0.25,
code_weights [2, 2, 1, 1, 1, 1, 1, 1, 1, 1]). The assignment runs on the
host (``scipy.optimize.linear_sum_assignment``) on detached costs, as in
the reference and the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from panacea_tpu_torch.perception.coder import normalize_bbox

CODE_WEIGHTS = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """labels == num_classes is background (a row of zeros in the one-hot,
    as ``jax.nn.one_hot`` gives it). Summed over the classes."""
    onehot = (labels[..., None] == torch.arange(num_classes, device=labels.device)).float()
    p = torch.sigmoid(logits)
    ce = -(onehot * torch.log(p.clamp(min=1e-8))
           + (1 - onehot) * torch.log((1 - p).clamp(min=1e-8)))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return (alpha_t * (1 - p_t) ** gamma * ce).sum(-1)


def focal_cls_cost(logits: torch.Tensor, gt_labels: torch.Tensor, gamma: float = 2.0,
                   alpha: float = 0.25, eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost: cost[q, g] of assigning query q to gt g."""
    p = torch.sigmoid(logits)
    neg = (1 - alpha) * p ** gamma * -torch.log(1 - p + eps)
    pos = alpha * (1 - p) ** gamma * -torch.log(p + eps)
    return (pos - neg)[:, gt_labels]


def bbox_l1_cost(bbox_preds: torch.Tensor, gt_boxes_norm: torch.Tensor,
                 pc_range=None) -> torch.Tensor:
    """mmdet BBox3DL1Cost under HungarianAssigner3D's code-weight scaling
    (hungarian_assigner_3d.py:59-67): the first 8 dims of prediction and
    normalised gt, each times the code weights. ``pc_range`` is unused."""
    mc = torch.tensor(CODE_WEIGHTS[:8], dtype=bbox_preds.dtype, device=bbox_preds.device)
    p = bbox_preds[..., :8] * mc
    g = gt_boxes_norm[..., :8] * mc
    return (p[:, None] - g[None, :]).abs().sum(-1)


def hungarian_assign(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """|pred - target| * weights, elementwise, 0 where that is not finite
    (a nan velocity target). The non-finite targets are replaced before
    the difference, so their zero carries a zero gradient."""
    ok = torch.isfinite(target) & torch.isfinite(pred.detach())
    w = torch.tensor(weights, dtype=pred.dtype, device=pred.device)
    diff = (pred - torch.where(ok, target, torch.zeros_like(target))).abs() * w
    return torch.where(ok, diff, torch.zeros_like(diff))


def detection_loss_single(cls_logits: torch.Tensor, bbox_preds: torch.Tensor,
                          gt_boxes: np.ndarray, gt_labels: np.ndarray,
                          pc_range: Sequence[float], num_classes: int = 10,
                          cls_weight: float = 2.0, bbox_weight: float = 0.25
                          ) -> Dict[str, torch.Tensor]:
    """One sample, one decoder layer: cls_logits (Q, C), bbox_preds (Q, 10),
    gt_boxes (G, 9), gt_labels (G,). Hungarian matching on the host on the
    detached cost, then the losses of the matched pairs."""
    q = cls_logits.shape[0]
    g = len(gt_labels)
    dev = cls_logits.device
    if g == 0:
        labels = torch.full((q,), num_classes, device=dev)
        return {"loss_cls": cls_weight * sigmoid_focal_loss(cls_logits, labels,
                                                            num_classes).mean(),
                "loss_bbox": torch.zeros((), device=dev)}
    gt_norm = normalize_bbox(torch.as_tensor(np.asarray(gt_boxes), dtype=torch.float32,
                                             device=dev))
    glabels = torch.as_tensor(np.asarray(gt_labels), dtype=torch.long, device=dev)
    with torch.no_grad():
        cost = (cls_weight * focal_cls_cost(cls_logits, glabels)
                + bbox_weight * bbox_l1_cost(bbox_preds, gt_norm, pc_range))
    rows, cols = hungarian_assign(cost.cpu().numpy())
    labels = np.full((q,), num_classes, dtype=np.int64)
    labels[rows] = np.asarray(gt_labels)[cols]
    cls_l = sigmoid_focal_loss(cls_logits, torch.as_tensor(labels, device=dev),
                               num_classes).sum() / max(g, 1)
    rows_t, cols_t = (torch.as_tensor(x, device=dev) for x in (rows, cols))
    bbox_l = masked_l1(bbox_preds[rows_t], gt_norm[cols_t], CODE_WEIGHTS).sum() / max(g, 1)
    return {"loss_cls": cls_weight * cls_l, "loss_bbox": bbox_weight * bbox_l}


def reduced(reduce_fn: Optional[Callable], x: torch.Tensor) -> torch.Tensor:
    """``reduce_fn(x)`` (an avg factor averaged over the ranks, mmdet's
    ``reduce_mean``) as a tensor of ``x``'s device and type; ``x`` where
    ``reduce_fn`` is None."""
    if reduce_fn is None:
        return x
    return torch.as_tensor(reduce_fn(x), dtype=x.dtype, device=x.device)
