"""FocalHead's 2D training: the HungarianAssigner2D targets and the five losses.

Counterpart of ``panacea_tpu/perception/focal_train.py`` (reference
dense_heads/focal_head.py:196-540, core/bbox/assigners/
hungarian_assigner_2d.py:20-158, models/losses/iou_loss.py:7-69):

- per image, a Hungarian matching over four costs, the focal
  classification cost, the L1 of the normalised cxcywh boxes, the GIoU of
  the pixel xyxy boxes and the L1 of the 2D centres
  (hungarian_assigner_2d.py:127-145), on the host with scipy;
- the Quality Focal Loss for the classes (positives pulled to their
  detached IoU), the GIoU loss, the L1 box and centre losses, and a
  Gaussian focal loss of the centerness against per-image centre heatmaps
  (``_get_heatmap_single``'s min-LTRB radius, focal_head.py:372-385).

The matching and the targets are NumPy on detached predictions; the losses
are torch, differentiable in the head's outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


# geometry (host)
def cxcywh_to_xyxy(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


def xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], axis=-1)


def _giou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise GIoU, a (N, 4) and b (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    wh = np.clip(np.minimum(a[:, None, 2:], b[None, :, 2:])
                 - np.maximum(a[:, None, :2], b[None, :, :2]), 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    ewh = np.clip(np.maximum(a[:, None, 2:], b[None, :, 2:])
                  - np.minimum(a[:, None, :2], b[None, :, :2]), 0, None)
    enclose = ewh[..., 0] * ewh[..., 1] + 1e-7
    return inter / (union + 1e-7) - (enclose - union) / enclose


def _focal_cost(logits: np.ndarray, gt_labels: np.ndarray, alpha: float = 0.25,
                gamma: float = 2.0, eps: float = 1e-12) -> np.ndarray:
    """mmdet FocalLossCost: (N, C) logits and (M,) labels -> (N, M)."""
    p = 1 / (1 + np.exp(-logits))
    neg = -np.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -np.log(p + eps) * alpha * (1 - p) ** gamma
    return (pos - neg)[:, gt_labels]


def hungarian_assign_2d(cls_logits: np.ndarray, bbox_pred: np.ndarray,
                        pred_centers2d: np.ndarray, gt_bboxes: np.ndarray, gt_labels: np.ndarray,
                        centers2d: np.ndarray, img_hw: Tuple[int, int], cls_weight: float = 2.0,
                        reg_weight: float = 5.0, iou_weight: float = 2.0,
                        centers2d_weight: float = 10.0) -> Tuple[np.ndarray, np.ndarray]:
    """One image (hungarian_assigner_2d.py:58-158): cls_logits (Q, C),
    bbox_pred (Q, 4) normalised cxcywh, pred_centers2d (Q, 2) normalised,
    gt_bboxes (G, 4) pixel xyxy, centers2d (G, 2) pixels. Returns (pos (Q,)
    bool, assigned gt (Q,))."""
    from scipy.optimize import linear_sum_assignment

    q = bbox_pred.shape[0]
    pos, asg = np.zeros((q,), bool), np.zeros((q,), np.int64)
    if len(gt_bboxes) == 0:
        return pos, asg
    h, w = img_hw
    factor = np.array([w, h, w, h], np.float64)
    cost = cls_weight * _focal_cost(cls_logits, gt_labels)
    cost += reg_weight * np.abs(bbox_pred[:, None] - xyxy_to_cxcywh(gt_bboxes / factor)[None]
                                ).sum(-1)
    cost += iou_weight * -_giou_xyxy(cxcywh_to_xyxy(bbox_pred) * factor, gt_bboxes)
    cost += centers2d_weight * np.abs(pred_centers2d[:, None]
                                      - (centers2d / factor[:2])[None]).sum(-1)
    cost = np.nan_to_num(cost, nan=100.0, posinf=100.0, neginf=-100.0)
    rows, cols = linear_sum_assignment(cost)
    pos[rows] = True
    asg[rows] = cols
    return pos, asg


def gaussian_2d(radius: int, sigma: float) -> np.ndarray:
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_heatmap_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> np.ndarray:
    """centerpoint's draw_heatmap_gaussian: a Gaussian splat, max-composited."""
    gaussian = gaussian_2d(radius, sigma=(2 * radius + 1) / 6)
    x, y = int(center[0]), int(center[1])
    hh, wk = heatmap.shape
    if not (0 <= x < wk and 0 <= y < hh):
        return heatmap
    left, right = min(x, radius), min(wk - x, radius + 1)
    top, bottom = min(y, radius), min(hh - y, radius + 1)
    masked = heatmap[y - top:y + bottom, x - left:x + right]
    g = gaussian[radius - top:radius + bottom, radius - left:radius + right]
    np.maximum(masked, g * k, out=masked)
    return heatmap


def heatmap_target(centers2d: np.ndarray, gt_bboxes: np.ndarray, img_hw: Tuple[int, int],
                   stride: int = 16) -> np.ndarray:
    """One image's centerness heatmap (focal_head.py:372-385): radius
    ceil(min LTRB extent / 16), at least 1."""
    h, w = img_hw
    hm = np.zeros((h // stride, w // stride), np.float64)
    for c, b in zip(centers2d, gt_bboxes):
        bound = [c[0] - b[0], c[1] - b[1], b[2] - c[0], b[3] - c[1]]
        r = max(1.0, np.ceil(min(bound) / 16))
        draw_heatmap_gaussian(hm, c / stride, radius=int(r))
    return hm


def pad_gt_2d(gt_bboxes_list, gt_labels_list, centers2d_list):
    """Per-image lists -> padded (N, G, .) arrays, labels -1-padded."""
    n = len(gt_labels_list)
    g = max([1] + [len(np.asarray(lab).reshape(-1)) for lab in gt_labels_list])
    gtb = np.zeros((n, g, 4), np.float32)
    gtl = np.full((n, g), -1, np.int32)
    c2d = np.zeros((n, g, 2), np.float32)
    for i in range(n):
        k = len(np.asarray(gt_labels_list[i]).reshape(-1))
        if k:
            gtb[i, :k] = np.asarray(gt_bboxes_list[i], np.float32).reshape(-1, 4)
            gtl[i, :k] = np.asarray(gt_labels_list[i]).reshape(-1)
            c2d[i, :k] = np.asarray(centers2d_list[i], np.float32).reshape(-1, 2)
    return gtb, gtl, c2d


def make_focal_targets_host(img_hw: Tuple[int, int], num_classes: int, lw: Dict[str, float]):
    """The host half of focal_head.py:258-371, the assigner and the
    heatmaps: padded (N, G, .) ground truth in, fixed-shape targets out
    (labels (N, Q), box targets and weights (N, Q, 4), centre targets (N,
    Q, 2), heatmaps (N, H / 16, W / 16), the matched count)."""
    h, w = img_hw
    factor = np.array([w, h, w, h], np.float64)

    def host(cls_logits, bbox_preds, cen_preds, gtb_all, gtl_all, c2d_all):
        cls_logits = np.asarray(cls_logits, np.float64)
        bbox_preds = np.asarray(bbox_preds, np.float64)
        cen_preds = np.asarray(cen_preds, np.float64)
        n_img, q = cls_logits.shape[:2]
        labels = np.full((n_img, q), num_classes, np.int32)
        bbox_t = np.zeros((n_img, q, 4), np.float32)
        bbox_w = np.zeros((n_img, q, 4), np.float32)
        cen_t = np.zeros((n_img, q, 2), np.float32)
        heatmaps = np.zeros((n_img, h // 16, w // 16), np.float32)
        n_pos = 0
        for i in range(n_img):
            valid = np.asarray(gtl_all[i]) >= 0
            gtb = np.asarray(gtb_all[i], np.float64)[valid]
            gtl = np.asarray(gtl_all[i], np.int64)[valid]
            c2d = np.asarray(c2d_all[i], np.float64)[valid]
            heatmaps[i] = heatmap_target(c2d, gtb, img_hw)
            pos, asg = hungarian_assign_2d(
                cls_logits[i], bbox_preds[i], cen_preds[i], gtb, gtl, c2d, img_hw,
                cls_weight=lw["cls"], reg_weight=lw["bbox"], iou_weight=lw["iou"],
                centers2d_weight=lw["centers2d"])
            n_pos += int(pos.sum())
            if pos.any():
                labels[i][pos] = gtl[asg[pos]]
                bbox_t[i][pos] = xyxy_to_cxcywh(gtb / factor)[asg[pos]]
                bbox_w[i][pos] = 1.0
                cen_t[i][pos] = (c2d / factor[:2])[asg[pos]]
        return labels, bbox_t, bbox_w, cen_t, heatmaps, np.float32(n_pos)

    return host


# losses (torch)
def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.sigmoid(x).clamp(eps, 1 - eps)


def quality_focal_loss(logits: torch.Tensor, labels: torch.Tensor, scores: torch.Tensor,
                       num_classes: int, beta: float = 2.0) -> torch.Tensor:
    """mmdet QualityFocalLoss (sigmoid form): logits (Q, C), labels (Q,)
    with num_classes the background, scores (Q,) the positives' (detached)
    IoU targets. Elementwise (Q, C)."""
    p = torch.sigmoid(logits)
    loss = -torch.log((1 - p).clamp(min=1e-12)) * p ** beta
    pos = labels < num_classes
    onehot = (torch.where(pos, labels, torch.zeros_like(labels))[:, None]
              == torch.arange(num_classes, device=labels.device)).to(logits.dtype)
    q = scores[:, None] * onehot
    ce = -(q * torch.log(p.clamp(min=1e-12)) + (1 - q) * torch.log((1 - p).clamp(min=1e-12)))
    loss_pos = ce * (q - p).abs() ** beta
    return torch.where(pos[:, None] & (onehot > 0), loss_pos, loss)


def gaussian_focal_loss(pred: torch.Tensor, gaussian_target: torch.Tensor, alpha: float = 2.0,
                        gamma: float = 4.0) -> torch.Tensor:
    """mmdet GaussianFocalLoss (CornerNet), pred in (0, 1)."""
    eps = 1e-12
    pos_w = (gaussian_target == 1).to(pred.dtype)
    neg_w = (1 - gaussian_target) ** gamma
    pos = -torch.log(pred + eps) * (1 - pred) ** alpha * pos_w
    neg = -torch.log(1 - pred + eps) * pred ** alpha * neg_w * (1 - pos_w)
    return pos + neg


def _cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def _iou_and_enclose(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Aligned IoU, the union and the enclosing area of xyxy boxes."""
    wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])).clamp(0)
    inter = wh[..., 0] * wh[..., 1]
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    ewh = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])).clamp(0)
    return inter / (union + 1e-7), union, ewh[..., 0] * ewh[..., 1] + 1e-7


def focal_head_loss(outs: Dict[str, torch.Tensor], gt_bboxes, gt_labels, centers2d,
                    img_hw: Tuple[int, int], num_classes: int = 10,
                    loss_weights: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """The whole head's loss (focal_head.py:196-371). ``outs``:
    ``FocalHead``'s (Q = H W tokens an image); the ground truth per-image
    lists (padded here) or padded (N, G, .) arrays with -1 labels. The
    assignment and the heatmaps are made on the host from the detached
    predictions. Loss weights default to the reference's StreamPETR focal
    configs (cls 2.0, bbox 5.0, iou 2.0, centers2d 10.0, centerness 2.0)."""
    lw = {"cls": 2.0, "bbox": 5.0, "iou": 2.0, "centers2d": 10.0, "centerness": 2.0}
    lw.update(loss_weights or {})
    h, w = img_hw
    if isinstance(gt_labels, (list, tuple)):
        gt_bboxes, gt_labels, centers2d = pad_gt_2d(gt_bboxes, gt_labels, centers2d)
    targets = make_focal_targets_host(img_hw, num_classes, lw)(
        *(outs[k].detach().float().cpu().numpy()
          for k in ("enc_cls_scores", "enc_bbox_preds", "pred_centers2d")),
        np.asarray(gt_bboxes, np.float32), np.asarray(gt_labels, np.int32),
        np.asarray(centers2d, np.float32))
    dev = outs["enc_cls_scores"].device
    labels, bbox_t, bbox_w, cen_t, hm = (torch.as_tensor(np.asarray(t), device=dev)
                                         for t in targets[:5])
    n_img = labels.shape[0]
    labels = labels.reshape(-1).long()
    bbox_t, bbox_w, cen_t = bbox_t.reshape(-1, 4), bbox_w.reshape(-1, 4), cen_t.reshape(-1, 2)
    avg = max(float(targets[5]), 1.0)

    logits = outs["enc_cls_scores"].reshape(-1, num_classes)
    preds = outs["enc_bbox_preds"].reshape(-1, 4)
    cenp = outs["pred_centers2d"].reshape(-1, 2)
    fac = torch.tensor([w, h, w, h], dtype=preds.dtype, device=dev)
    pred_px, tgt_px = _cxcywh_to_xyxy(preds) * fac, _cxcywh_to_xyxy(bbox_t) * fac
    iou, union, enclose = _iou_and_enclose(pred_px, tgt_px)
    giou = iou - (enclose - union) / enclose
    loss_iou = ((1.0 - giou) * bbox_w[:, 0]).sum() / avg * lw["iou"]
    iou_q = iou.detach()
    loss_cls = quality_focal_loss(logits, labels, iou_q, num_classes).sum() / avg * lw["cls"]
    cen = clip_sigmoid(outs["centerness"].reshape(n_img, -1, 1))
    loss_centerness = (gaussian_focal_loss(cen, hm.reshape(n_img, -1, 1)).sum() / avg
                       * lw["centerness"])
    loss_bbox = ((preds - bbox_t).abs() * bbox_w).sum() / avg * lw["bbox"]
    loss_centers2d = ((cenp - cen_t).abs() * bbox_w[:, :2]).sum() / avg * lw["centers2d"]
    return {"enc_loss_cls": loss_cls, "enc_loss_bbox": loss_bbox, "enc_loss_iou": loss_iou,
            "centers2d_losses": loss_centers2d, "centerness_losses": loss_centerness}
