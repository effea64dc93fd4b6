"""FocalHead: the 2D auxiliary head of FocalPETR that picks the salient
image tokens for a dense PETR head.

Counterpart of ``panacea_tpu/perception/focal_head.py`` (reference
dense_heads/focal_head.py:21-195): over one neck level, a shared conv +
GroupNorm (32 groups) + ReLU tower for the class logits and the
centerness, another for the LTRB box and the 2D centre offset, each
predictor a 1x1 convolution, the class and centerness biases at -4.595.
The per-token weight sigmoid(max class logit) * sigmoid(centerness) picks
the top ``infer_ratio`` of the tokens of all cameras: ``topk_indexes`` (B,
K, 1), which ``StreamPETRHead`` takes to restrict its cross-attention
(streampetr_head.py:440 topk_gather). The top-k orders equal weights
lowest index first (``head.topk_stable``), as ``jax.lax.top_k``.

Names are the reference's (``shared_cls.0``, ``shared_cls.1`` the
GroupNorm, ``cls``, ``centerness``, ``ltrb``, ``center2d``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from panacea_tpu_torch.perception.atss import CLS_BIAS
from panacea_tpu_torch.perception.head import inverse_sigmoid, topk_stable


def token_locations(h: int, w: int, device=None) -> torch.Tensor:
    """The (0, 1) pixel-centre grid, (H, W, 2) xy (misc.py locations)."""
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([cx, cy], dim=-1)


def apply_ltrb(loc: torch.Tensor, ltrb: torch.Tensor) -> torch.Tensor:
    """(H, W, 2) and (N, H, W, 4) -> cxcywh in [0, 1] (misc.py:50-67)."""
    x1 = (loc[..., 0] - ltrb[..., 0]).clamp(0, 1)
    y1 = (loc[..., 1] - ltrb[..., 1]).clamp(0, 1)
    x2 = (loc[..., 0] + ltrb[..., 2]).clamp(0, 1)
    y2 = (loc[..., 1] + ltrb[..., 3]).clamp(0, 1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def apply_center_offset(loc: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(inverse_sigmoid(loc) + off)


class FocalHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256, embed_dims: int = 256,
                 infer_ratio: float = 0.5):
        super().__init__()
        self.num_classes, self.infer_ratio = num_classes, infer_ratio
        for tower in ("shared_cls", "shared_reg"):
            self.add_module(tower, nn.Sequential(
                nn.Conv2d(in_channels, embed_dims, 3, padding=1), nn.GroupNorm(32, embed_dims),
                nn.ReLU()))
        self.cls = nn.Conv2d(embed_dims, num_classes, 1)
        self.centerness = nn.Conv2d(embed_dims, 1, 1)
        self.ltrb = nn.Conv2d(embed_dims, 4, 1)
        self.center2d = nn.Conv2d(embed_dims, 2, 1)
        for layer in (self.cls, self.centerness):
            nn.init.constant_(layer.bias, CLS_BIAS)

    def forward(self, feat: torch.Tensor, num_cams: int,
                sample_ratio: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """feat (B N, C, H, W), a neck level; ``num_cams`` N. Returns the
        reference's outputs: ``enc_cls_scores`` (B N, H W, classes),
        ``enc_bbox_preds`` (B N, H W, 4) cxcywh, ``pred_centers2d`` (B N,
        H W, 2), ``centerness`` (B N, H W, 1) and ``topk_indexes`` (B, K, 1)
        over the N H W tokens."""
        bn, _, h, w = feat.shape
        b = bn // num_cams
        loc = token_locations(h, w, feat.device)

        def flat(x):   # (B N, k, H, W) -> (B N, H, W, k)
            return x.permute(0, 2, 3, 1)

        cls_feat = self.shared_cls(feat)
        cls_logits = flat(self.cls(cls_feat)).reshape(bn, h * w, self.num_classes)
        centerness = flat(self.centerness(cls_feat)).reshape(bn, h * w, 1)
        reg_feat = self.shared_reg(feat)
        ltrb = torch.sigmoid(flat(self.ltrb(reg_feat)))
        pred_bboxes = apply_ltrb(loc, ltrb).reshape(bn, h * w, 4)
        pred_centers2d = apply_center_offset(loc, flat(self.center2d(reg_feat))).reshape(
            bn, h * w, 2)

        ratio = self.infer_ratio if sample_ratio is None else sample_ratio
        num_tokens = num_cams * h * w
        k = max(1, int(num_tokens * ratio))
        with torch.no_grad():
            weight = (torch.sigmoid(cls_logits.amax(-1)).reshape(b, num_tokens)
                      * torch.sigmoid(centerness).reshape(b, num_tokens))
            _, topk = topk_stable(weight, k)
        return {"enc_cls_scores": cls_logits, "enc_bbox_preds": pred_bboxes,
                "pred_centers2d": pred_centers2d, "centerness": centerness,
                "topk_indexes": topk[..., None]}
