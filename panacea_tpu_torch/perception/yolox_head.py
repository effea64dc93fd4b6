"""YOLOXHeadCustom: the YOLOX 2D auxiliary detection head (NCHW).

Counterpart of ``panacea_tpu/perception/yolox_head.py`` (reference
dense_heads/yolox_head.py:21-615): per-level conv towers (not shared) of
ConvModules with batch norm (eps 1e-3) and Swish, 1 x 1 predictors of the
classes, the box, the objectness and the 2D centre's offset, point priors
at the stride offsets (MlvlPointGenerator offset 0, :116), boxes decoded
by exp (:382-392), and SimOTA's dynamic-k assignment for training
(:534-607, mmdet SimOTAAssigner) on the host in NumPy, as in the JAX
package. The outputs are flattened over the levels, (B, P, .).

Keys are the reference's (``multi_level_{cls,reg}_convs.{l}.{i}.conv`` /
``.bn``, ``multi_level_conv_{cls,reg,obj,centers2d}.{l}``), the names of
``panacea_tpu/utils/convert.py:1276``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.atss import CLS_BIAS
from panacea_tpu_torch.perception.resnet import FrozenBatchNorm


def mlvl_priors(featmap_sizes: Sequence[Tuple[int, int]], strides: Sequence[int]) -> np.ndarray:
    """(P, 4) [cx, cy, stride_w, stride_h] point priors, offset 0."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        out.append(np.stack([xs.reshape(-1) * s, ys.reshape(-1) * s, np.full(h * w, s),
                             np.full(h * w, s)], -1))
    return np.concatenate(out, 0).astype(np.float32)


def _priors(priors, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(priors), dtype=like.dtype, device=like.device)


def bbox_decode(priors, bbox_preds: torch.Tensor) -> torch.Tensor:
    """xy offset x stride + prior, wh = exp x stride -> xyxy (:382-392)."""
    pr = _priors(priors, bbox_preds)
    xys = bbox_preds[..., :2] * pr[:, 2:] + pr[:, :2]
    whs = torch.exp(bbox_preds[..., 2:]) * pr[:, 2:]
    return torch.cat([xys - whs / 2, xys + whs / 2], dim=-1)


def centers2d_decode(priors, centers2d: torch.Tensor) -> torch.Tensor:
    """(:394-396)."""
    pr = _priors(priors, centers2d)
    return centers2d[..., :2] * pr[:, 2:] + pr[:, :2]


class ConvBNSwish(nn.Module):
    """mmcv ConvModule: 3 x 3 ``.conv`` without bias, ``.bn`` (eps 1e-3, on
    its stored statistics), Swish."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn = FrozenBatchNorm(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 2, strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.num_classes, self.strides = num_classes, tuple(strides)

        def tower():
            return nn.Sequential(*(ConvBNSwish(in_channels if i == 0 else feat_channels,
                                               feat_channels) for i in range(stacked_convs)))

        levels = range(len(self.strides))
        self.multi_level_cls_convs = nn.ModuleList(tower() for _ in levels)
        self.multi_level_reg_convs = nn.ModuleList(tower() for _ in levels)
        self.multi_level_conv_cls = nn.ModuleList(nn.Conv2d(feat_channels, num_classes, 1)
                                                  for _ in levels)
        self.multi_level_conv_reg = nn.ModuleList(nn.Conv2d(feat_channels, 4, 1) for _ in levels)
        self.multi_level_conv_obj = nn.ModuleList(nn.Conv2d(feat_channels, 1, 1) for _ in levels)
        self.multi_level_conv_centers2d = nn.ModuleList(nn.Conv2d(feat_channels, 2, 1)
                                                        for _ in levels)
        for conv in list(self.multi_level_conv_cls) + list(self.multi_level_conv_obj):
            nn.init.constant_(conv.bias, CLS_BIAS)

    def forward(self, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """feats per level (B, C, H_l, W_l). Returns the reference's outs
        with the predictions flattened over the levels, (B, P, .)."""
        if len(feats) != len(self.strides):
            raise ValueError(f"{len(feats)} levels for {len(self.strides)} strides")

        def flat(t):
            return t.flatten(2).transpose(1, 2)

        cls_all, bbox_all, obj_all, ctr_all = [], [], [], []
        for li, x in enumerate(feats):
            cls_feat = self.multi_level_cls_convs[li](x)
            reg_feat = self.multi_level_reg_convs[li](x)
            cls_all.append(flat(self.multi_level_conv_cls[li](cls_feat)))
            bbox_all.append(flat(self.multi_level_conv_reg[li](reg_feat)))
            obj_all.append(flat(self.multi_level_conv_obj[li](reg_feat))[..., 0])
            ctr_all.append(flat(self.multi_level_conv_centers2d[li](reg_feat)))
        return {"enc_cls_scores": torch.cat(cls_all, 1), "enc_bbox_preds": torch.cat(bbox_all, 1),
                "objectnesses": torch.cat(obj_all, 1),
                "pred_centers2d_offset": torch.cat(ctr_all, 1), "topk_indexes": None}


# ---------------------------------------------------------------- training


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    ar_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return inter / np.maximum(ar_a[:, None] + ar_b[None] - inter, 1e-9)


def simota_assign(cls_preds: np.ndarray, objectness: np.ndarray, priors: np.ndarray,
                  decoded: np.ndarray, gt_boxes: np.ndarray, gt_labels: np.ndarray,
                  center_radius: float = 2.5, candidate_topk: int = 10, iou_weight: float = 3.0,
                  cls_weight: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """mmdet SimOTAAssigner: cls_preds (P, C) and objectness (P,) logits,
    priors (P, 4), decoded (P, 4) xyxy, gt (G, 4) and (G,). Returns
    (assigned gt (P,), -1 background; its IoU (P,)). Candidates are the
    priors whose offset centre (prior + stride / 2, :573-575) lies in a box
    or its centre window; cost = BCE(sqrt(cls obj) vs one-hot) + 3 (-log
    IoU) + 1e5 outside both; dynamic k per gt from its top-10 IoU sum; a
    prior claimed twice goes to its least cost."""
    p, g = len(priors), len(gt_boxes)
    assigned = np.full(p, -1, np.int64)
    max_iou = np.zeros(p, np.float32)
    if g == 0:
        return assigned, max_iou
    centers = priors[:, :2] + priors[:, 2:] * 0.5
    in_box = ((centers[:, None, 0] >= gt_boxes[None, :, 0])
              & (centers[:, None, 0] <= gt_boxes[None, :, 2])
              & (centers[:, None, 1] >= gt_boxes[None, :, 1])
              & (centers[:, None, 1] <= gt_boxes[None, :, 3]))
    gt_c = (gt_boxes[:, :2] + gt_boxes[:, 2:]) / 2
    r = center_radius * priors[:, 2:3]
    in_ctr = ((np.abs(centers[:, None, 0] - gt_c[None, :, 0]) <= r)
              & (np.abs(centers[:, None, 1] - gt_c[None, :, 1]) <= r))
    is_cand = (in_box | in_ctr).any(1)
    if not is_cand.any():
        return assigned, max_iou
    cand = np.where(is_cand)[0]
    ious = _iou_xyxy(decoded[cand], gt_boxes)
    score = (1 / (1 + np.exp(-cls_preds[cand])) * 1 / (1 + np.exp(-objectness[cand, None])))
    onehot = np.eye(cls_preds.shape[1], dtype=np.float32)[np.clip(gt_labels, 0, None)]
    sq = np.sqrt(np.clip(score, 1e-8, 1 - 1e-8))
    bce = -(onehot[None] * np.log(sq[:, None])
            + (1 - onehot[None]) * np.log(1 - sq[:, None])).sum(-1)
    cost = (cls_weight * bce + iou_weight * -np.log(ious + 1e-8)
            + 100000.0 * (~(in_box & in_ctr)[cand]))
    k = min(candidate_topk, len(cand))
    dynamic_k = np.clip((-np.sort(-ious, axis=0)[:k]).sum(0).astype(np.int64), 1, None)
    match = np.zeros_like(cost, dtype=bool)
    for gi in range(g):
        match[np.argsort(cost[:, gi])[:dynamic_k[gi]], gi] = True
    multi = match.sum(1) > 1
    if multi.any():
        best = cost[multi].argmin(1)
        match[multi] = False
        match[np.where(multi)[0], best] = True
    pos = match.any(1)
    gt_idx = match.argmax(1)
    assigned[cand[pos]] = gt_idx[pos]
    max_iou[cand[pos]] = ious[pos, gt_idx[pos]]
    return assigned, max_iou


def yolox_targets(priors: np.ndarray, cls_preds: np.ndarray, objectness: np.ndarray,
                  decoded: np.ndarray, gt_boxes: Sequence[np.ndarray],
                  gt_labels: Sequence[np.ndarray], centers2d: Sequence[np.ndarray] = None,
                  num_classes: int = 10):
    """The batch's SimOTA targets (:534-607), per prior: (pos_mask (B, P),
    cls_target (B, P, C) the IoU-weighted one-hot, obj_target (B, P),
    bbox_target (B, P, 4) xyxy, l1_target (B, P, 4), centers2d_target (B,
    P, 2), num_pos)."""
    b, p = objectness.shape
    pos_mask = np.zeros((b, p), np.float32)
    cls_t = np.zeros((b, p, num_classes), np.float32)
    obj_t = np.zeros((b, p), np.float32)
    bbox_t = np.zeros((b, p, 4), np.float32)
    l1_t = np.zeros((b, p, 4), np.float32)
    ctr_t = np.zeros((b, p, 2), np.float32)
    total = 0.0
    for bi in range(b):
        gb, gl = np.asarray(gt_boxes[bi]), np.asarray(gt_labels[bi])
        if len(gb) == 0:
            continue
        assigned, ious = simota_assign(cls_preds[bi], objectness[bi], priors, decoded[bi], gb, gl)
        pos = assigned >= 0
        if not pos.any():
            continue
        gi = assigned[pos]
        pos_mask[bi, pos] = 1.0
        obj_t[bi, pos] = 1.0
        cls_t[bi, pos] = np.eye(num_classes, dtype=np.float32)[gl[gi]] * ious[pos][:, None]
        bbox_t[bi, pos] = gb[gi]
        # the L1 target in prior-normalised cxcywh-log space (:606-611)
        cxcy, wh, pr = (gb[gi, :2] + gb[gi, 2:]) / 2, gb[gi, 2:] - gb[gi, :2], priors[pos]
        l1_t[bi, pos, :2] = (cxcy - pr[:, :2]) / pr[:, 2:]
        l1_t[bi, pos, 2:] = np.log(wh / pr[:, 2:] + 1e-8)
        if centers2d is not None and len(centers2d[bi]):
            ctr_t[bi, pos] = (np.asarray(centers2d[bi])[gi] - pr[:, :2]) / pr[:, 2:]
        total += float(pos.sum())
    return pos_mask, cls_t, obj_t, bbox_t, l1_t, ctr_t, np.float32(total)


def yolox_loss(outs: Dict[str, torch.Tensor], priors: np.ndarray, targets,
               use_l1: bool = False) -> Dict[str, torch.Tensor]:
    """Squared-IoU (weight 5), objectness and class BCE, centres2d L1 (and
    the box L1 with ``use_l1``), each summed over num_pos
    (:509-529, the loss configs :64-81)."""
    dev = outs["enc_bbox_preds"].device
    pos_mask, cls_t, obj_t, bbox_t, l1_t, ctr_t, num_pos = (
        torch.as_tensor(np.asarray(t), device=dev) for t in targets)
    n = num_pos.clamp(min=1.0)
    decoded = bbox_decode(priors, outs["enc_bbox_preds"])
    wh = (torch.minimum(decoded[..., 2:], bbox_t[..., 2:])
          - torch.maximum(decoded[..., :2], bbox_t[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = (decoded[..., 2:] - decoded[..., :2]).clamp(min=0).prod(-1)
    area_g = (bbox_t[..., 2:] - bbox_t[..., :2]).clamp(min=0).prod(-1)
    iou = inter / (area_p + area_g - inter).clamp(min=1e-9)

    def bce(logits, target):
        return F.binary_cross_entropy_with_logits(logits, target, reduction="none")

    out = {"enc_loss_cls": (bce(outs["enc_cls_scores"], cls_t).sum(-1) * pos_mask).sum() / n,
           "enc_loss_iou": 5.0 * ((1 - iou ** 2) * pos_mask).sum() / n,   # mode 'square'
           "enc_loss_obj": bce(outs["objectnesses"], obj_t).sum() / n,
           "enc_loss_centers2d": ((outs["pred_centers2d_offset"] - ctr_t).abs().sum(-1)
                                  * pos_mask).sum() / n}
    if use_l1:
        out["enc_loss_bbox"] = ((outs["enc_bbox_preds"] - l1_t).abs().sum(-1)
                                * pos_mask).sum() / n
    return out
