"""The training losses of the head families whose reference repeats one
DETR3D loss: the proposal-query heads, the joint heads, SimMOD and the
cascade RoI head.

Counterpart of ``panacea_tpu/perception/vestigial_train.py`` (reference
joint_head.py:754-1101 and its copies, sparse_head_v4.py:630-966 and
simmod_head.py:389-658 among them; cascade_roi_head.py:191-286):

- the DETR3D loss, on ``perception/train.py``'s Hungarian matching
  (``hungarian_match``) and layer losses (``detection_layer_losses``),
  adding only what the family adds: SimMOD's pinned pre-assignments
  (queries that carry a proposal's matched box keep it; the rest are
  matched), ``bg_cls_weight``, a box whose normalised target is not all
  finite dropped from the L1 whole (loss_single's ``isnotnan``), and the
  per-layer keys;
- SimMOD's IoU3D quality branch: the BCE of the predicted IoU logit
  against clamp(2 iou3d - 0.5, 0, 1) (simmod_head.py:629-641, 757-762),
  the exact rotated-BEV x height IoU on the host (Sutherland-Hodgman);
- the cascade RoI loss: per stage MaxIoU assignment with rising
  thresholds, delta targets against the stage's own input boxes, CE and
  SmoothL1, the stage weights.

Host-side targets are NumPy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from panacea_tpu_torch.perception.coder import denormalize_bbox, normalize_bbox
from panacea_tpu_torch.perception.train import detection_layer_losses, hungarian_match

# --------------------------------------------------------------- DETR3D ----


def detr3d_layer_targets(cls_logits: np.ndarray, bbox_preds: np.ndarray,
                         gt_boxes_list: Sequence[np.ndarray], gt_labels_list: Sequence[np.ndarray],
                         num_classes: int, cls_weight: float = 2.0, bbox_weight: float = 0.25,
                         pre_assigns_list: Optional[Sequence[np.ndarray]] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """One layer's targets on the host (joint_head.py:754-864): cls_logits
    (B, Q, C), bbox_preds (B, Q, 10), per image gt boxes (G_i, 9) and labels
    (G_i,); ``pre_assigns_list`` per image (Q,) a gt index or -1. Returns
    (labels (B, Q), bbox_targets (B, Q, 9), bbox_pos (B, Q), num_pos,
    num_neg)."""
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
            gt_norm = normalize_bbox(torch.as_tensor(gt_b[free_g], dtype=torch.float32)).numpy()
            r, c = hungarian_match(np.asarray(cls_logits[i][free_q], np.float32),
                                   np.asarray(bbox_preds[i][free_q], np.float32), gt_norm,
                                   gt_l[free_g], cls_weight, bbox_weight)
            rows = np.concatenate([rows, free_q[r]])
            cols = np.concatenate([cols, free_g[c]])
        labels[i, rows] = gt_l[cols]
        bbox_targets[i, rows] = gt_b[cols]
        bbox_pos[i, rows] = 1.0
        num_pos += len(rows)
    return labels, bbox_targets, bbox_pos, num_pos, b * q - num_pos


def detr3d_family_loss(all_cls_scores: torch.Tensor, all_bbox_preds: torch.Tensor,
                       gt_boxes_list: Sequence[np.ndarray], gt_labels_list: Sequence[np.ndarray],
                       num_classes: int = 10, cls_weight: float = 2.0, bbox_weight: float = 0.25,
                       bg_cls_weight: float = 0.0,
                       pre_assigns_list: Optional[Sequence[np.ndarray]] = None,
                       iou3d_logits: Optional[torch.Tensor] = None, iou3d_weight: float = 1.0
                       ) -> Dict[str, torch.Tensor]:
    """The whole loss (joint_head.py:992-1101 and its copies): each decoder
    layer on its own assignment, keys ``loss_cls`` and ``loss_bbox`` for the
    last layer and ``d{i}.loss_*`` for the others, with ``iou3d_logits``
    (L, B, Q) also ``loss_iou3d``; ``loss`` their sum. all_cls_scores (L, B,
    Q, C), all_bbox_preds (L, B, Q, >= 10)."""
    n_layers = all_cls_scores.shape[0]
    dev, dtype = all_bbox_preds.device, all_bbox_preds.dtype
    cls_np = all_cls_scores.detach().float().cpu().numpy()
    reg_np = all_bbox_preds.detach().float().cpu().numpy()
    tgts = [detr3d_layer_targets(cls_np[li], reg_np[li], gt_boxes_list, gt_labels_list,
                                 num_classes, cls_weight, bbox_weight,
                                 pre_assigns_list=pre_assigns_list) for li in range(n_layers)]
    labels = torch.as_tensor(np.stack([t[0] for t in tgts]), device=dev)
    boxes = torch.as_tensor(np.stack([t[1] for t in tgts]), dtype=dtype, device=dev)
    pos = torch.as_tensor(np.stack([t[2] for t in tgts]), dtype=dtype, device=dev)
    gt_norm = normalize_bbox(boxes)
    # loss_single drops a row whose normalised target is not all finite
    gt_norm = torch.where(torch.isfinite(gt_norm).all(-1, keepdim=True), gt_norm,
                          torch.full_like(gt_norm, float("nan")))
    cls_l, bbox_l = detection_layer_losses(all_cls_scores, all_bbox_preds, labels, gt_norm, pos,
                                           num_classes, bg_cls_weight)
    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=dev)
    for li in range(n_layers):
        prefix = "" if li == n_layers - 1 else f"d{li}."
        terms = {"loss_cls": torch.nan_to_num(cls_weight * cls_l[li]),
                 "loss_bbox": torch.nan_to_num(bbox_weight * bbox_l[li])}
        if iou3d_logits is not None:
            terms["loss_iou3d"] = simmod_iou3d_loss(all_bbox_preds[li], iou3d_logits[li],
                                                    boxes[li], pos[li]) * iou3d_weight
        for k, v in terms.items():
            out[prefix + k] = v
            total = total + v
    out["loss"] = total
    return out


# ------------------------------------------------------------ SimMOD IoU3D -


def _rect_corners(cx, cy, w, l, yaw):
    """BEV rectangle corners (4, 2), counter-clockwise; w along y and l
    along x before the rotation."""
    dx, dy = l / 2.0, w / 2.0
    base = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]])
    c, s = np.cos(yaw), np.sin(yaw)
    return base @ np.array([[c, -s], [s, c]]).T + np.array([cx, cy])


def _seg_x(p, q, a, b):
    """The intersection of segment pq with the line ab."""
    d1, d2 = q - p, b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return q
    t = ((a[0] - p[0]) * d2[1] - (a[1] - p[1]) * d2[0]) / denom
    return p + t * d1


def _convex_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: the convex polygon ``subject`` clipped by the
    convex ``clip``, both (N, 2) counter-clockwise."""
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        inp, out = out, []
        if not inp:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= -1e-12

        for j, cur in enumerate(inp):
            prev = inp[j - 1]
            if inside(cur):
                if not inside(prev):
                    out.append(_seg_x(prev, cur, a, b))
                out.append(cur)
            elif inside(prev):
                out.append(_seg_x(prev, cur, a, b))
    return np.asarray(out) if out else np.zeros((0, 2))


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def rotated_iou_3d(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The paired 3D IoU of (N, >= 7) boxes (cx, cy, cz_bottom, w, l, h,
    yaw): the rotated BEV intersection times the vertical overlap (mmcv's
    iou3d semantics, which simmod_head.py:757-762 consumes)."""
    pred, target = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    out = np.zeros(len(pred))
    for i, (p, t) in enumerate(zip(pred, target)):
        inter2d = _poly_area(_convex_clip(_rect_corners(p[0], p[1], p[3], p[4], p[6]),
                                          _rect_corners(t[0], t[1], t[3], t[4], t[6])))
        inter = inter2d * max(min(p[2] + p[5], t[2] + t[5]) - max(p[2], t[2]), 0.0)
        union = p[3] * p[4] * p[5] + t[3] * t[4] * t[5] - inter
        out[i] = inter / union if union > 0 else 0.0
    return out


def simmod_iou3d_targets(bbox_preds: np.ndarray, bbox_targets: np.ndarray,
                         bbox_pos: np.ndarray) -> np.ndarray:
    """The IoU targets on the host (simmod_head.py:629-637): the decoded
    predictions and the targets moved to bottom z, their rotated 3D IoU
    squashed to clamp(2 iou - 0.5, 0, 1); 0 where unmatched."""
    b, q = bbox_pos.shape
    out = np.zeros((b, q), np.float64)
    dec = denormalize_bbox(torch.as_tensor(np.asarray(bbox_preds[..., :10], np.float32))).numpy()
    for i in range(b):
        pos = np.nonzero(bbox_pos[i] > 0)[0]
        if not len(pos):
            continue
        p = dec[i][pos].astype(np.float64)
        t = np.array(bbox_targets[i][pos], np.float64)
        p[:, 2] -= 0.5 * p[:, 5]
        t[:, 2] -= 0.5 * t[:, 5]
        out[i, pos] = np.clip(2.0 * rotated_iou_3d(p, t) - 0.5, 0.0, 1.0)
    return out


def simmod_iou3d_loss(bbox_preds: torch.Tensor, iou_logits: torch.Tensor,
                      bbox_targets: torch.Tensor, bbox_pos: torch.Tensor) -> torch.Tensor:
    """BCE of the IoU logit against the squashed exact IoU over the matched
    rows (simmod_head.py:629-641, BCEWithLogitsLoss)."""
    tgt = torch.as_tensor(simmod_iou3d_targets(
        bbox_preds.detach().float().cpu().numpy(), bbox_targets.detach().cpu().numpy(),
        bbox_pos.detach().cpu().numpy()), dtype=iou_logits.dtype, device=iou_logits.device)
    bce = F.binary_cross_entropy_with_logits(iou_logits, tgt, reduction="none")
    return torch.nan_to_num((bce * bbox_pos).sum() / bbox_pos.sum().clamp(min=1.0))


# --------------------------------------------------------- cascade RoI -----


def iou_xyxy_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P, 4) x (G, 4) pairwise IoU."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    wh = np.maximum(np.minimum(a[:, None, 2:], b[None, :, 2:])
                    - np.maximum(a[:, None, :2], b[None, :, :2]), 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def max_iou_assign(boxes: np.ndarray, gt: np.ndarray, pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float) -> np.ndarray:
    """mmdet MaxIoUAssigner (gt_max_assign_all): per box -1 ignored, 0
    negative, g + 1 positive to gt g."""
    p = len(boxes)
    if len(gt) == 0:
        return np.zeros((p,), dtype=np.int64)
    assigned = np.full((p,), -1, dtype=np.int64)
    ious = iou_xyxy_matrix(boxes, gt)
    max_iou, argmax = ious.max(axis=1), ious.argmax(axis=1)
    assigned[max_iou < neg_iou_thr] = 0
    pos = max_iou >= pos_iou_thr
    assigned[pos] = argmax[pos] + 1
    # low-quality positives: each gt claims the boxes that share its best IoU
    gt_max = ious.max(axis=0)
    for g in range(len(gt)):
        if gt_max[g] >= min_pos_iou:
            assigned[np.abs(ious[:, g] - gt_max[g]) < 1e-9] = g + 1
    return assigned


def bbox2delta(proposals: np.ndarray, gt: np.ndarray, means=(0.0, 0.0, 0.0, 0.0),
               stds=(0.1, 0.1, 0.2, 0.2)) -> np.ndarray:
    """mmdet DeltaXYWHBBoxCoder.encode."""
    pw, ph = proposals[:, 2] - proposals[:, 0], proposals[:, 3] - proposals[:, 1]
    px, py = proposals[:, 0] + pw * 0.5, proposals[:, 1] + ph * 0.5
    gw, gh = gt[:, 2] - gt[:, 0], gt[:, 3] - gt[:, 1]
    gx, gy = gt[:, 0] + gw * 0.5, gt[:, 1] + gh * 0.5
    d = np.stack([(gx - px) / np.maximum(pw, 1e-6), (gy - py) / np.maximum(ph, 1e-6),
                  np.log(np.maximum(gw, 1e-6) / np.maximum(pw, 1e-6)),
                  np.log(np.maximum(gh, 1e-6) / np.maximum(ph, 1e-6))], -1)
    return (d - np.asarray(means)) / np.asarray(stds)


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


# the mmdet cascade training config per stage (the positive threshold
# rises, the stds shrink)
CASCADE_STAGE_CFG = (
    {"pos_iou_thr": 0.5, "neg_iou_thr": 0.5, "min_pos_iou": 0.5, "stds": (0.1, 0.1, 0.2, 0.2)},
    {"pos_iou_thr": 0.6, "neg_iou_thr": 0.6, "min_pos_iou": 0.6,
     "stds": (0.05, 0.05, 0.1, 0.1)},
    {"pos_iou_thr": 0.7, "neg_iou_thr": 0.7, "min_pos_iou": 0.7,
     "stds": (0.033, 0.033, 0.067, 0.067)},
)
CASCADE_STAGE_WEIGHTS = (1.0, 0.5, 0.25)


def cascade_roi_loss(stage_cls: Sequence[torch.Tensor], stage_reg: Sequence[torch.Tensor],
                     stage_input_boxes: Sequence[np.ndarray], valid: np.ndarray,
                     gt_boxes: Sequence[np.ndarray], gt_labels: Sequence[np.ndarray],
                     num_classes: int, stage_cfg=CASCADE_STAGE_CFG,
                     stage_weights=CASCADE_STAGE_WEIGHTS) -> Dict[str, torch.Tensor]:
    """mmdet CascadeRoIHead.forward_train (cascade_roi_head.py:191-286 and
    BBoxHead.loss): per stage the stage's own input boxes MaxIoU-assigned,
    CE over the C + 1 classes and SmoothL1 of the positives' deltas, both
    over the valid proposals, times the stage weight. stage_cls per stage
    (M, P, C + 1), stage_reg (M, P, 4), stage_input_boxes (M, P, 4), valid
    (M, P)."""
    out: Dict[str, torch.Tensor] = {}
    dev = stage_cls[0].device
    total = torch.zeros((), device=dev)
    m, p = valid.shape
    valid_t = torch.as_tensor(np.asarray(valid), dtype=stage_cls[0].dtype, device=dev)
    n_valid = max(float(valid.sum()), 1.0)
    for si, (cls, reg, boxes_in) in enumerate(zip(stage_cls, stage_reg, stage_input_boxes)):
        cfg = stage_cfg[min(si, len(stage_cfg) - 1)]
        lw = stage_weights[min(si, len(stage_weights) - 1)]
        labels = np.full((m, p), num_classes, dtype=np.int64)     # background
        deltas = np.zeros((m, p, 4))
        pos_w = np.zeros((m, p))
        for i in range(m):
            ok = valid[i] > 0
            if ok.sum() == 0:
                continue
            gt_b = np.asarray(gt_boxes[i], np.float64).reshape(-1, 4)
            gt_l = np.asarray(gt_labels[i]).reshape(-1)
            boxes = np.asarray(boxes_in[i][ok], np.float64)
            assigned = max_iou_assign(boxes, gt_b, cfg["pos_iou_thr"], cfg["neg_iou_thr"],
                                      cfg["min_pos_iou"])
            idx = np.nonzero(ok)[0]
            pos = assigned > 0
            labels[i, idx[pos]] = gt_l[assigned[pos] - 1]
            if pos.any():
                deltas[i, idx[pos]] = bbox2delta(boxes[pos], gt_b[assigned[pos] - 1],
                                                 stds=cfg["stds"])
                pos_w[i, idx[pos]] = 1.0
        ce = F.cross_entropy(cls.transpose(1, 2), torch.as_tensor(labels, device=dev),
                             reduction="none")
        cls_l = (ce * valid_t).sum() / n_valid
        reg_l = (smooth_l1(reg - torch.as_tensor(deltas, dtype=reg.dtype, device=dev)).sum(-1)
                 * torch.as_tensor(pos_w, dtype=reg.dtype, device=dev)).sum() / n_valid
        out[f"s{si}.loss_cls"] = lw * cls_l
        out[f"s{si}.loss_bbox"] = lw * reg_l
        total = total + lw * (cls_l + reg_l)
    out["loss"] = total
    return out
