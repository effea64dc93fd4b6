"""The DETR3D family's training loss, shared by the heads whose reference
repeats it (SparseHeadv4 here).

Counterpart of the DETR3D part of ``panacea_tpu/perception/vestigial_train.py``
(:47-186; reference joint_head.py:754-1101 and its copies, among them
sparse_head_v4.py:630-966): per decoder layer a Hungarian assignment on the
host (focal classification cost and the code-weighted L1 of the first 8
box dims, scipy), then the sigmoid focal loss over the matched count and
the code-weighted L1 of the box code against the normalised target over
the rows whose normalised target is finite. ``pre_assigns_list`` pins
given queries to given boxes (SimMOD's guided assignment) and matches the
rest.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from panacea_tpu_torch.perception.coder import normalize_bbox
from panacea_tpu_torch.perception.train_losses import (CODE_WEIGHTS, bbox_l1_cost,
                                                       focal_cls_cost, hungarian_assign,
                                                       sigmoid_focal_loss)


def detr3d_layer_targets(cls_logits: np.ndarray, bbox_preds: np.ndarray,
                         gt_boxes_list: Sequence[np.ndarray], gt_labels_list: Sequence[np.ndarray],
                         num_classes: int, cls_weight: float = 2.0, bbox_weight: float = 0.25,
                         pre_assigns_list: Optional[Sequence[np.ndarray]] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """One layer's targets on the host (joint_head.py:754-864): cls_logits
    (B, Q, C), bbox_preds (B, Q, 10), per image gt boxes (G_i, 9) and labels
    (G_i,). Returns (labels (B, Q), bbox_targets (B, Q, 9), bbox_pos (B, Q),
    num_pos, num_neg)."""
    b, q = cls_logits.shape[:2]
    labels = np.full((b, q), num_classes, dtype=np.int64)
    bbox_targets = np.zeros((b, q, 9), dtype=np.float64)
    bbox_pos = np.zeros((b, q), dtype=np.float64)
    num_pos = 0
    for i in range(b):
        gt_b = np.asarray(gt_boxes_list[i], np.float64).reshape(-1, 9)
        gt_l = np.asarray(gt_labels_list[i]).reshape(-1)
        g = len(gt_l)
        if g == 0:
            continue
        rows_pin, cols_pin = [], []
        free_q, free_g = np.arange(q), np.arange(g)
        if pre_assigns_list is not None:
            pa = np.asarray(pre_assigns_list[i]).reshape(-1)
            seen = set()
            for qi in range(q):
                gi = int(pa[qi])
                if 0 <= gi < g and gi not in seen:
                    rows_pin.append(qi)
                    cols_pin.append(gi)
                    seen.add(gi)
            free_q = np.setdiff1d(free_q, np.asarray(rows_pin, int))
            free_g = np.setdiff1d(free_g, np.asarray(cols_pin, int))
        rows, cols = np.asarray(rows_pin, int), np.asarray(cols_pin, int)
        if len(free_g) and len(free_q):
            gt_norm = normalize_bbox(torch.as_tensor(gt_b[free_g], dtype=torch.float32))
            cost = (cls_weight * focal_cls_cost(
                        torch.as_tensor(cls_logits[i][free_q], dtype=torch.float32),
                        torch.as_tensor(gt_l[free_g], dtype=torch.long))
                    + bbox_weight * bbox_l1_cost(
                        torch.as_tensor(bbox_preds[i][free_q], dtype=torch.float32), gt_norm))
            r, c = hungarian_assign(cost.numpy())
            rows = np.concatenate([rows, free_q[r]])
            cols = np.concatenate([cols, free_g[c]])
        labels[i, rows] = gt_l[cols]
        bbox_targets[i, rows] = gt_b[cols]
        bbox_pos[i, rows] = 1.0
        num_pos += len(rows)
    return labels, bbox_targets, bbox_pos, num_pos, b * q - num_pos


def detr3d_layer_loss(cls_logits: torch.Tensor, bbox_preds: torch.Tensor, labels: torch.Tensor,
                      bbox_targets: torch.Tensor, bbox_pos: torch.Tensor, num_pos: float,
                      num_neg: float, num_classes: int, cls_weight: float = 2.0,
                      bbox_weight: float = 0.25, bg_cls_weight: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's (loss_cls, loss_bbox) (joint_head.py:865-932 loss_single):
    the focal sum over max(num_pos + bg_cls_weight num_neg, 1); the
    code-weighted L1 of the first 10 box dims against the normalised target
    over the rows whose normalised target is all finite, over
    max(num_pos, 1)."""
    cls_af = max(num_pos * 1.0 + num_neg * bg_cls_weight, 1.0)
    cls_l = sigmoid_focal_loss(cls_logits, labels, num_classes).sum() / cls_af
    gt_norm = normalize_bbox(bbox_targets)                       # (B, Q, 10)
    finite = torch.isfinite(gt_norm).all(-1, keepdim=True)      # (B, Q, 1)
    w = bbox_pos[..., None] * torch.tensor(CODE_WEIGHTS, dtype=bbox_preds.dtype,
                                           device=bbox_preds.device)
    diff = (bbox_preds[..., :10] - torch.where(finite, gt_norm, torch.zeros_like(gt_norm))).abs()
    bbox_l = (diff * w * finite).sum() / max(num_pos, 1.0)
    return (torch.nan_to_num(cls_weight * cls_l), torch.nan_to_num(bbox_weight * bbox_l))


def detr3d_family_loss(all_cls_scores: torch.Tensor, all_bbox_preds: torch.Tensor,
                       gt_boxes_list: Sequence[np.ndarray], gt_labels_list: Sequence[np.ndarray],
                       num_classes: int = 10, cls_weight: float = 2.0, bbox_weight: float = 0.25,
                       bg_cls_weight: float = 0.0,
                       pre_assigns_list: Optional[Sequence[np.ndarray]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The whole loss (joint_head.py:992-1101 and its copies): each decoder
    layer's ``detr3d_layer_loss`` on its own assignment, keys ``loss_cls``
    and ``loss_bbox`` for the last layer and ``d{i}.loss_*`` for the others,
    ``loss`` their sum. all_cls_scores (L, B, Q, C), all_bbox_preds (L, B,
    Q, 10)."""
    n_layers = all_cls_scores.shape[0]
    dev, dtype = all_bbox_preds.device, all_bbox_preds.dtype
    cls_np = all_cls_scores.detach().float().cpu().numpy()
    reg_np = all_bbox_preds.detach().float().cpu().numpy()
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=dev)
    for li in range(n_layers):
        labels, tgts, pos, n_pos, n_neg = detr3d_layer_targets(
            cls_np[li], reg_np[li], gt_boxes_list, gt_labels_list, num_classes, cls_weight,
            bbox_weight, pre_assigns_list=pre_assigns_list)
        cls_l, bbox_l = detr3d_layer_loss(
            all_cls_scores[li], all_bbox_preds[li], torch.as_tensor(labels, device=dev),
            torch.as_tensor(tgts, dtype=dtype, device=dev),
            torch.as_tensor(pos, dtype=dtype, device=dev), n_pos, n_neg, num_classes,
            cls_weight, bbox_weight, bg_cls_weight)
        prefix = "" if li == n_layers - 1 else f"d{li}."
        out[f"{prefix}loss_cls"], out[f"{prefix}loss_bbox"] = cls_l, bbox_l
        total = total + cls_l + bbox_l
    out["loss"] = total
    return out
