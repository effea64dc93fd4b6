"""CustomCascadeRoIHead: multi-stage 2D RoI refinement (NCHW).

Counterpart of ``panacea_tpu/perception/cascade_roi.py`` (reference
cascade_roi_head.py:16-630, mmdet's CascadeRoIHead with Shared2FCBBoxHead
stages): each stage RoIAligns the current boxes, runs two shared FCs and
predicts C + 1 class logits and class-agnostic box deltas; the decoded
boxes seed the next stage, and the class scores are the softmax averaged
over the stages (the simple_test convention).

Proposals are fixed-shape, (M, P, 4) with a validity mask, as in the JAX
package. Keys are mmdet's (``bbox_head.{s}.shared_fcs.{0,1}``,
``.fc_cls``, ``.fc_reg``); the RoI features flatten channel-major, as
mmdet's (C, 7, 7), where the JAX head flattens channels-last.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.atss import delta_decode
from panacea_tpu_torch.perception.joint_head import roi_align

STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))


class Shared2FCBBoxHead(nn.Module):
    """Flattened RoI -> fc x 2 (ReLU) -> ``fc_cls`` (C + 1) and ``fc_reg`` (4)."""

    def __init__(self, in_channels: int = 256, roi_feat_size: Tuple[int, int] = (7, 7),
                 num_classes: int = 10, fc_out_channels: int = 1024):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size[0] * roi_feat_size[1], fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4)

    def forward(self, rois: torch.Tensor):
        x = rois.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class CascadeRoIHead(nn.Module):
    def __init__(self, num_classes: int = 10, num_stages: int = 3, in_channels: int = 256,
                 feat_stride: int = 16, roi_size: Tuple[int, int] = (7, 7),
                 sampling_ratio: int = 2, stage_stds: Sequence[Sequence[float]] = STAGE_STDS,
                 fc_out_channels: int = 1024):
        super().__init__()
        self.num_stages, self.feat_stride = num_stages, feat_stride
        self.roi_size, self.sampling_ratio = tuple(roi_size), sampling_ratio
        self.stage_stds = tuple(tuple(s) for s in stage_stds)
        self.bbox_head = nn.ModuleList(
            Shared2FCBBoxHead(in_channels, self.roi_size, num_classes, fc_out_channels)
            for _ in range(num_stages))

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor
                ) -> Dict[str, object]:
        """feat (M, C, H, W); boxes (M, P, 4) xyxy image pixels; valid (M, P).
        Returns the last stage's ``boxes`` (M, P, 4), the averaged
        ``cls_scores`` (M, P, C + 1) and the per-stage lists."""
        m, p = boxes.shape[:2]
        stage_cls, stage_boxes, stage_reg = [], [], []
        cur = boxes
        for si, head in enumerate(self.bbox_head):
            rois = roi_align(feat, cur, self.roi_size, 1.0 / self.feat_stride,
                             self.sampling_ratio)
            cls, reg = head(rois.flatten(0, 1))
            cls, reg = cls.reshape(m, p, -1), reg.reshape(m, p, 4)
            decoded = delta_decode(cur.reshape(-1, 4), reg.reshape(-1, 4),
                                   stds=self.stage_stds[min(si, len(self.stage_stds) - 1)]
                                   ).reshape(m, p, 4)
            stage_cls.append(cls)
            stage_boxes.append(decoded)
            stage_reg.append(reg)
            cur = decoded.detach()
        avg = torch.softmax(torch.stack(stage_cls), dim=-1).mean(0) * valid[..., None]
        return {"cls_scores": avg, "boxes": stage_boxes[-1], "stage_cls": stage_cls,
                "stage_boxes": stage_boxes, "stage_reg": stage_reg}


def cascade_train_loss(outs: Dict[str, object], input_boxes, valid, gt_boxes_list,
                       gt_labels_list, num_classes: int,
                       stage_stds: Sequence[Sequence[float]] = None, **kw):
    """The cascade head's training loss (cascade_roi_head.py:191-286): stage
    s against its own input boxes, the proposals for stage 0 and stage s -
    1's refined boxes after, through ``vestigial_train.cascade_roi_loss``.
    ``stage_stds`` (the head's, where they differ from mmdet's) encode the
    delta targets as the forward decodes them."""
    from panacea_tpu_torch.perception.vestigial_train import CASCADE_STAGE_CFG, cascade_roi_loss

    if stage_stds is not None and "stage_cfg" not in kw:
        kw["stage_cfg"] = tuple(dict(cfg, stds=tuple(stage_stds[min(si, len(stage_stds) - 1)]))
                                for si, cfg in enumerate(CASCADE_STAGE_CFG))

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    stage_inputs = [host(input_boxes)] + [host(b) for b in outs["stage_boxes"][:-1]]
    return cascade_roi_loss(outs["stage_cls"], outs["stage_reg"], stage_inputs, host(valid),
                            gt_boxes_list, gt_labels_list, num_classes, **kw)
