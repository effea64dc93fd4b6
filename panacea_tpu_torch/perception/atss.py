"""The ATSS 2D auxiliary detection head of training (NCHW).

Counterpart of ``panacea_tpu/perception/atss.py`` (reference ATSSTaskHead,
dense_heads/atss_head.py; config streampetr_r50_atss_512x256_window.py:63-99):
per-level anchor grids (octave scale 8, ratio 1.0, strides 8 to 128), 4
stacked convolutions shared across the levels, cls / box / centerness
outputs, the ATSS assignment (the top k anchors by centre distance, an IoU
threshold of mean + std), DeltaXYWH box coding and the GIoU loss. The
assignment and the targets are NumPy on the host, as in the JAX package.

Keys are mmdet's (``cls_convs.{i}.conv``, ``reg_convs.{i}.conv``,
``atss_cls``, ``atss_reg``, ``atss_centerness``, ``scales.{i}.scale``), so
an mmdet ``.pth`` loads by name. Like the JAX head, the branch
convolutions have a bias and no GroupNorm, which the reference's have.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.fpn import ConvModule

STRIDES = (8, 16, 32, 64, 128)
CLS_BIAS = -4.595


class Scale(nn.Module):
    """mmcv Scale: a learned scalar ``scale``, initialised at 1."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class ATSSHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 5):
        super().__init__()
        self.cls_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3)
            for i in range(stacked_convs))
        self.atss_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.atss_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.atss_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in range(num_levels))
        with torch.no_grad():
            self.atss_cls.bias.fill_(CLS_BIAS)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: per level (BN, C, h, w). Returns per level (cls (BN,
        num_classes, h, w), box deltas (BN, 4, h, w), centerness (BN, 1, h,
        w))."""
        outs = []
        for li, f in enumerate(feats):
            c = f
            for conv in self.cls_convs:
                c = F.relu(conv(c))
            r = f
            for conv in self.reg_convs:
                r = F.relu(conv(r))
            outs.append((self.atss_cls(c), self.scales[li](self.atss_reg(r)),
                         self.atss_centerness(r)))
        return outs


def fpn_shapes(img_hw: Tuple[int, int], num_levels: int = 5,
               stride: int = 8) -> List[Tuple[int, int]]:
    """The FPN's per-level shapes: ``stride`` first (8 for ResNet-50's
    neck, 16 for VoVNet-99's from its third stage), then halving with the
    ceiling (a 1 x 2 map halves to 1 x 1)."""
    h = -(-img_hw[0] // stride)
    w = -(-img_hw[1] // stride)
    out = []
    for _ in range(num_levels):
        out.append((h, w))
        h = max(1, -(-h // 2))
        w = max(1, -(-w // 2))
    return out


def grid_anchors(shapes_hw: List[Tuple[int, int]], strides=STRIDES,
                 octave_base_scale: float = 8.0) -> List[np.ndarray]:
    """One square anchor per location, side stride * octave_base_scale,
    centred at (x, y) * stride (mmdet AnchorGenerator's center_offset 0)."""
    out = []
    for (h, w), s in zip(shapes_hw, strides):
        side = s * octave_base_scale
        cx, cy = np.meshgrid(np.arange(w) * float(s), np.arange(h) * float(s))
        out.append(np.stack([cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2],
                            axis=-1).reshape(-1, 4))
    return out


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M) IoU."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-9)


def atss_assign(anchors_per_level: List[np.ndarray], gt_boxes: np.ndarray,
                topk: int = 9) -> np.ndarray:
    """Per gt, the top-k closest anchors of each level are candidates; the
    threshold is the mean + std of their IoUs; a positive's centre must lie
    inside the gt. The gt index per anchor, -1 for background."""
    anchors = np.concatenate(anchors_per_level, axis=0)
    n, g = len(anchors), len(gt_boxes)
    assigned = np.full(n, -1, dtype=np.int64)
    if g == 0:
        return assigned
    ious = iou_xyxy(anchors, gt_boxes)
    centers = np.stack([(anchors[:, 0] + anchors[:, 2]) / 2,
                        (anchors[:, 1] + anchors[:, 3]) / 2], axis=1)
    gt_centers = np.stack([(gt_boxes[:, 0] + gt_boxes[:, 2]) / 2,
                           (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2], axis=1)
    dists = np.linalg.norm(centers[:, None] - gt_centers[None], axis=-1)
    candidate_idx = []
    start = 0
    for a in anchors_per_level:
        lvl_n = len(a)
        idx = np.argsort(dists[start:start + lvl_n], axis=0)[:min(topk, lvl_n)] + start
        candidate_idx.append(idx)
        start += lvl_n
    candidate_idx = np.concatenate(candidate_idx, axis=0)   # (k L, G)
    best_iou = np.full(n, -1.0)
    for gi in range(g):
        cand = candidate_idx[:, gi]
        cious = ious[cand, gi]
        ok = cious >= cious.mean() + cious.std()
        cx, cy = centers[cand, 0], centers[cand, 1]
        inside = ((cx > gt_boxes[gi, 0]) & (cx < gt_boxes[gi, 2])
                  & (cy > gt_boxes[gi, 1]) & (cy < gt_boxes[gi, 3]))
        for ai in cand[ok & inside]:
            if ious[ai, gi] > best_iou[ai]:
                best_iou[ai] = ious[ai, gi]
                assigned[ai] = gi
    return assigned


def delta_encode(anchors, gt, means=(0, 0, 0, 0), stds=(0.1, 0.1, 0.2, 0.2)):
    """DeltaXYWHBBoxCoder.encode (NumPy)."""
    aw, ah = anchors[:, 2] - anchors[:, 0], anchors[:, 3] - anchors[:, 1]
    ax, ay = (anchors[:, 0] + anchors[:, 2]) / 2, (anchors[:, 1] + anchors[:, 3]) / 2
    gw = np.maximum(gt[:, 2] - gt[:, 0], 1e-6)
    gh = np.maximum(gt[:, 3] - gt[:, 1], 1e-6)
    gx, gy = (gt[:, 0] + gt[:, 2]) / 2, (gt[:, 1] + gt[:, 3]) / 2
    d = np.stack([(gx - ax) / aw, (gy - ay) / ah, np.log(gw / aw), np.log(gh / ah)], axis=1)
    return (d - np.asarray(means)) / np.asarray(stds)


def delta_decode(anchors: torch.Tensor, deltas: torch.Tensor, means=(0, 0, 0, 0),
                 stds=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """DeltaXYWHBBoxCoder.decode: (N, 4) anchors and deltas -> (N, 4) xyxy."""
    d = (deltas * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
         + torch.tensor(means, dtype=deltas.dtype, device=deltas.device))
    aw, ah = anchors[:, 2] - anchors[:, 0], anchors[:, 3] - anchors[:, 1]
    ax, ay = (anchors[:, 0] + anchors[:, 2]) / 2, (anchors[:, 1] + anchors[:, 3]) / 2
    cx, cy = d[:, 0] * aw + ax, d[:, 1] * ah + ay
    w = torch.exp(d[:, 2].clamp(-10, 4)) * aw
    h = torch.exp(d[:, 3].clamp(-10, 4)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=1)


def giou_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - GIoU of (N, 4) xyxy pairs."""
    area_p = (pred[:, 2] - pred[:, 0]).clamp(min=0) * (pred[:, 3] - pred[:, 1]).clamp(min=0)
    area_g = (gt[:, 2] - gt[:, 0]).clamp(min=0) * (gt[:, 3] - gt[:, 1]).clamp(min=0)
    lt = torch.maximum(pred[:, :2], gt[:, :2])
    rb = torch.minimum(pred[:, 2:], gt[:, 2:])
    inter = (rb - lt).clamp(min=0).prod(dim=1)
    union = area_p + area_g - inter
    iou = inter / union.clamp(min=1e-9)
    area_c = (torch.maximum(pred[:, 2:], gt[:, 2:])
              - torch.minimum(pred[:, :2], gt[:, :2])).clamp(min=0).prod(dim=1)
    return 1.0 - (iou - (area_c - union) / area_c.clamp(min=1e-9))


def centerness_target(anchors: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b)) at the anchor
    centres."""
    ax, ay = (anchors[:, 0] + anchors[:, 2]) / 2, (anchors[:, 1] + anchors[:, 3]) / 2
    l, r = ax - gt[:, 0], gt[:, 2] - ax
    t, b = ay - gt[:, 1], gt[:, 3] - ay
    lr = np.minimum(l, r) / np.maximum(np.maximum(l, r), 1e-9)
    tb = np.minimum(t, b) / np.maximum(np.maximum(t, b), 1e-9)
    return np.sqrt(np.clip(lr * tb, 0, None))
