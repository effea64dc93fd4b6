"""Box (de)normalisation and NMS-free decoding.

Counterpart of ``panacea_tpu/perception/coder.py`` (reference
core/bbox/util.py:3-51, core/bbox/coders/nms_free_coder.py:9-113): the top
``max_num`` (query, class) scores, equal scores lowest index first as
``jax.lax.top_k`` orders them, then the post-center range filter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from panacea_tpu_torch.perception.head import topk_stable


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, cz, w, l, h, rot[, vx, vy]) -> (cx, cy, cz, log w, log l,
    log h, sin, cos[, vx, vy])."""
    out = [bboxes[..., 0:3], bboxes[..., 3:6].log(), bboxes[..., 6:7].sin(),
           bboxes[..., 6:7].cos()]
    if bboxes.shape[-1] > 7:
        out.append(bboxes[..., 7:9])
    return torch.cat(out, dim=-1)


def denormalize_bbox(nb: torch.Tensor) -> torch.Tensor:
    out = [nb[..., 0:3], nb[..., 3:6].exp(), torch.atan2(nb[..., 6:7], nb[..., 7:8])]
    if nb.shape[-1] > 8:
        out.append(nb[..., 8:10])
    return torch.cat(out, dim=-1)


class NMSFreeCoder:
    def __init__(self, pc_range: Sequence[float],
                 post_center_range: Sequence[float] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
                 max_num: int = 300, score_threshold: Optional[float] = None,
                 num_classes: int = 10):
        self.pc_range = pc_range
        self.post_center_range = np.asarray(post_center_range)
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.num_classes = num_classes

    def decode_single(self, cls_scores: torch.Tensor, bbox_preds: torch.Tensor
                      ) -> Dict[str, np.ndarray]:
        """cls_scores (Q, num_classes) logits, bbox_preds (Q, 10) normalised
        -> numpy arrays of the boxes inside the post-center range."""
        scores, idx = topk_stable(torch.sigmoid(cls_scores).reshape(-1), self.max_num)
        labels = idx % self.num_classes
        box_idx = idx // self.num_classes
        boxes = denormalize_bbox(bbox_preds[box_idx]).cpu().numpy()
        scores, labels, box_idx = (t.cpu().numpy() for t in (scores, labels, box_idx))
        mask = ((boxes[:, :3] >= self.post_center_range[:3]).all(axis=1)
                & (boxes[:, :3] <= self.post_center_range[3:]).all(axis=1))
        if self.score_threshold is not None:
            mask &= scores >= self.score_threshold
        return {"bboxes": boxes[mask], "scores": scores[mask], "labels": labels[mask],
                "box_idx": box_idx[mask]}

    def decode(self, preds: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
        cls = preds["all_cls_scores"][-1]
        reg = preds["all_bbox_preds"][-1]
        return [self.decode_single(cls[i], reg[i]) for i in range(cls.shape[0])]
