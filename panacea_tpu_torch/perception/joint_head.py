"""The joint 2D-to-3D heads: QueryRoIHead, JointStreamPETRHead and JointHead.

Counterpart of ``panacea_tpu/perception/joint_head.py`` (reference
joint_streampetr_head.py):

- ``QueryRoIHead`` (QueryRoIHeadv2, :37-233) lifts 2D proposal boxes to 3D
  reference points: RoIAlign crops on the stride-16 level, a conv tower
  (ConvModule, then BasicBlocks), an embedding of the box and the
  intrinsics, centre-offset and depth heads, unprojection through
  img2lidar, the proposals outside the z range or invalid zeroed;
- ``JointStreamPETRHead`` (:236-1255) is a StreamPETRHead whose queries are
  the lifted points (:781-800), the DN references before them;
- ``JointHead`` (joint_head.py:227 and its v2/v3 width variants) is the
  'seed' proposal-query SparseHead on the lifted points.

Proposals come fixed-shape, (B, N, P, 4) xyxy image pixels with a validity
mask, as in the JAX package. ``roi_align`` is mmcv's RoIAlign with
``aligned=True`` written as the JAX gather is (no torchvision): the half
pixel offset after the scaling, roi extents not clamped, a fixed
``sampling_ratio`` x ``sampling_ratio`` grid of bilinear samples a bin,
and a sample more than one pixel outside the map contributing zero.

With 100 proposals a camera on 6 cameras and 256 propagated queries, the
joint PETR head's attention has 856 queries; the router sends its dense
cross-attention and its self-attention over queries and memory to the
fp32 flash kernel (Sq >= 128 and Skv > Sq).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.head import PC_RANGE
from panacea_tpu_torch.perception.petr_head import StreamPETRHead
from panacea_tpu_torch.perception.resnet import FrozenBatchNorm
from panacea_tpu_torch.perception.sparse_head_v3 import SparseHeadProposal


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: Tuple[int, int] = (7, 7),
              spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2) -> torch.Tensor:
    """mmcv RoIAlign(aligned=True): feat (M, C, H, W), boxes (M, P, 4) xyxy
    in image pixels -> (M, P, C, oh, ow)."""
    m, c, h, w = feat.shape
    p = boxes.shape[1]
    oh, ow = out_size
    g = int(sampling_ratio)
    if g < 1:
        raise ValueError("the adaptive sampling_ratio 0 is data-dependent; give a fixed one")
    b = boxes * spatial_scale - 0.5
    x1, y1 = b[..., 0], b[..., 1]
    bin_w, bin_h = (b[..., 2] - x1) / ow, (b[..., 3] - y1) / oh
    sub = (torch.arange(g, device=feat.device, dtype=feat.dtype) + 0.5) / g

    def grid(n_bins):   # bin i, sample j -> i + (j + 0.5) / g, in bins
        return (torch.arange(n_bins, device=feat.device, dtype=feat.dtype)[:, None]
                + sub[None]).reshape(-1)

    ys = y1[..., None] + grid(oh) * bin_h[..., None]            # (M, P, oh g)
    xs = x1[..., None] + grid(ow) * bin_w[..., None]            # (M, P, ow g)
    vy, vx = (ys >= -1.0) & (ys <= h), (xs >= -1.0) & (xs <= w)
    ys, xs = ys.clamp(0.0, h - 1), xs.clamp(0.0, w - 1)
    y0, x0 = ys.floor(), xs.floor()
    wy, wx = (ys - y0)[..., :, None], (xs - x0)[..., None, :]   # (M, P, OH, 1), (M, P, 1, OW)
    y0, x0 = y0.long(), x0.long()
    y1_, x1_ = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    flat = feat.reshape(m, c, h * w)

    def gat(yy, xx):    # (M, P, OH) x (M, P, OW) -> (M, C, P, OH, OW)
        idx = (yy[..., :, None] * w + xx[..., None, :]).reshape(m, 1, -1)
        return torch.gather(flat, 2, idx.expand(m, c, idx.shape[-1])).reshape(
            m, c, p, yy.shape[-1], xx.shape[-1])

    wx, wy = wx[:, None], wy[:, None]
    top = gat(y0, x0) * (1 - wx) + gat(y0, x1_) * wx
    bot = gat(y1_, x0) * (1 - wx) + gat(y1_, x1_) * wx
    out = (top * (1 - wy) + bot * wy) * (vy[..., :, None] & vx[..., None, :])[:, None]
    out = out.reshape(m, c, p, oh, g, ow, g).mean(dim=(4, 6))
    return out.permute(0, 2, 1, 3, 4)


class ConvBN(nn.Module):
    """mmcv ConvModule with batch norm and ReLU: 3 x 3 ``.conv`` without
    bias, ``.bn``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """mmdet ResNet BasicBlock: conv3x3-BN-ReLU-conv3x3-BN, residual, ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(x + self.bn2(self.conv2(h)))


class QueryRoIHead(nn.Module):
    """2D proposals -> 3D reference points (QueryRoIHeadv2, :37-233). Keys
    ``branch_convs.{i}`` (a ConvModule where the widths change, else a
    BasicBlock), ``geo_embed.{0,2}``, ``branch_fcs.{i}``, ``center_head``,
    ``depth_head``."""

    def __init__(self, embed_dims: int = 256, geo_channels: int = 8, num_branch_convs: int = 2,
                 num_branch_fcs: int = 2, conv_out_channels: int = 1024,
                 fc_out_channels: int = 1024, roi_feat_size: Tuple[int, int] = (7, 7),
                 sampling_ratio: int = 2, depth_range: float = 51.2, feat_stride: int = 16,
                 pc_range: Sequence[float] = PC_RANGE, detach: bool = False):
        super().__init__()
        self.roi_feat_size, self.sampling_ratio = tuple(roi_feat_size), sampling_ratio
        self.depth_range, self.feat_stride, self.detach = depth_range, feat_stride, detach
        self.register_buffer("pc_range", torch.tensor(pc_range, dtype=torch.float32),
                             persistent=False)
        convs, ch = [], embed_dims
        for i in range(num_branch_convs):
            if i == 0 and ch != conv_out_channels:
                convs.append(ConvBN(ch, conv_out_channels))
                ch = conv_out_channels
            else:
                convs.append(BasicBlock(ch))
        self.branch_convs = nn.ModuleList(convs)
        self.geo_embed = nn.Sequential(nn.Linear(geo_channels, conv_out_channels), nn.ReLU(),
                                       nn.Linear(conv_out_channels, conv_out_channels))
        fcs, fin = [], ch + conv_out_channels
        for _ in range(num_branch_fcs):
            fcs.append(nn.Linear(fin, fc_out_channels))
            fin = fc_out_channels
        self.branch_fcs = nn.ModuleList(fcs)
        self.center_head = nn.Linear(fin, 2)
        self.depth_head = nn.Linear(fin, 1)

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                data: Dict[str, torch.Tensor]):
        """feat (B N, C, h, w) the stride-16 level; boxes (B, N, P, 4) xyxy
        image pixels; valid (B, N, P). Returns (ref (B, N P, 3) normalised
        to pc_range, valid (B, N P)), the invalid or out-of-z-range
        proposals zeroed (the reference's mask and pad, :216-230)."""
        b, n, p = boxes.shape[:3]
        if self.detach:
            feat = feat.detach()
        bx = boxes.reshape(b * n, p, 4)
        x = roi_align(feat, bx, self.roi_feat_size, 1.0 / self.feat_stride,
                      self.sampling_ratio).flatten(0, 1)            # (B N P, C, 7, 7)
        for conv in self.branch_convs:
            x = conv(x)
        # the geo embedding of (box / 1e3, fx fy cx cy / 1e3) (:176-182),
        # the same at every RoI position, so its mean is itself
        intr = data["intrinsics"]
        k4 = torch.stack([intr[..., 0, 0], intr[..., 1, 1], intr[..., 0, 2], intr[..., 1, 2]],
                         dim=-1).abs() / 1e3                         # (B, N, 4)
        geo = torch.cat([boxes / 1e3, k4[:, :, None].expand(b, n, p, 4)], dim=-1)
        x = torch.cat([x.mean(dim=(2, 3)), self.geo_embed(geo.reshape(b * n * p, 8))], dim=-1)
        for fc in self.branch_fcs:
            x = F.relu(fc(x))
        center_off, depth = self.center_head(x), self.depth_head(x)
        centers = ((bx[..., :2] + bx[..., 2:]) / 2).reshape(b * n * p, 2) + center_off
        d = torch.sigmoid(depth) * self.depth_range
        uvz1 = torch.cat([centers * d.clamp(min=1e-5), d, torch.ones_like(d)], dim=-1)
        img2lidar = torch.linalg.inv(data["lidar2img"])             # (B, N, 4, 4)
        i2l = img2lidar[:, :, None].expand(b, n, p, 4, 4).reshape(b * n * p, 4, 4)
        xyz = torch.einsum("mij,mj->mi", i2l, uvz1)[..., :3]
        pc = self.pc_range
        ok = (valid.reshape(-1) > 0) & (xyz[..., 2] > pc[2]) & (xyz[..., 2] < pc[5])
        ref = torch.where(ok[:, None], (xyz - pc[0:3]) / (pc[3:6] - pc[0:3]),
                          torch.zeros_like(xyz))
        return ref.reshape(b, n * p, 3), ok.reshape(b, n * p).to(ref.dtype)


def _build_query_head(embed_dims: int, pc_range, query_head_cfg: Optional[dict]) -> QueryRoIHead:
    """The joint heads' QueryRoIHead, the host head's width and pc_range
    its defaults."""
    cfg = dict(query_head_cfg or {})
    cfg.setdefault("embed_dims", embed_dims)
    cfg.setdefault("pc_range", tuple(pc_range))
    return QueryRoIHead(**cfg)


def _lift_proposals(head, mlvl_feats, data):
    """The host head's QueryRoIHead on its FPN level: (normalised 3D
    references, validity) of ``data``'s proposal_boxes."""
    lvl = min(head.roi_feat_level, len(mlvl_feats) - 1)
    boxes = data["proposal_boxes"]
    valid = data.get("proposal_valid")
    if valid is None:
        valid = boxes.new_ones(boxes.shape[:3])
    return head.query_head(mlvl_feats[lvl], boxes, valid, data)


class JointStreamPETRHead(StreamPETRHead):
    """StreamPETRHead on QueryRoIHead-lifted proposals
    (joint_streampetr_head.py:781-800); without proposals the learned
    table (the with_query_head=False branch, :349-356)."""

    def __init__(self, *, with_query_head: bool = True, query_head_cfg: Optional[dict] = None,
                 roi_feat_level: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.with_query_head, self.roi_feat_level = with_query_head, roi_feat_level
        if with_query_head:
            self.query_head = _build_query_head(self.embed_dims,
                                                kwargs.get("pc_range", PC_RANGE), query_head_cfg)

    def forward(self, mlvl_feats, memory, data, pad_hw, dn=None, topk_indexes=None):
        if (self.with_query_head and "proposal_boxes" in data
                and "proposal_norm_ref" not in data):
            ref, ok = _lift_proposals(self, mlvl_feats, data)
            data = dict(data, proposal_norm_ref=ref, proposal_ref_valid=ok)
        return super().forward(mlvl_feats, memory, data, pad_hw, dn=dn,
                               topk_indexes=topk_indexes)

    def make_queries(self, b: int, dn=None, data: Optional[Dict[str, torch.Tensor]] = None):
        ref = (data or {}).get("proposal_norm_ref")
        if ref is None:
            return super().make_queries(b, dn, data)
        if dn is not None:   # the DN references first (JAX :254-255)
            ref = torch.cat([dn.ref, ref], dim=1)
        return ref, ref.new_zeros((b, ref.shape[1], self.embed_dims))


class JointHead(SparseHeadProposal):
    """The SparseHead decoder seeded with QueryRoIHead-lifted proposals (the
    JointHead family, joint_head.py:227, joint_headv2.py:176,
    joint_headv3.py:249)."""

    def __init__(self, *args, with_query_head: bool = True,
                 query_head_cfg: Optional[dict] = None, roi_feat_level: int = 1,
                 mode: str = "seed", **kwargs):
        super().__init__(*args, mode=mode, **kwargs)
        self.with_query_head, self.roi_feat_level = with_query_head, roi_feat_level
        if with_query_head:
            self.query_head = _build_query_head(self.embed_dims,
                                                kwargs.get("pc_range", PC_RANGE), query_head_cfg)

    def forward(self, mlvl_feats, memory, data, pad_hw, dn=None):
        if (self.with_query_head and "proposal_boxes" in data
                and "proposal_positions" not in data):
            ref, ok = _lift_proposals(self, mlvl_feats, data)
            data = dict(data, proposal_positions=self._to_range(ref), proposal_ref_valid=ok)
        return super().forward(mlvl_feats, memory, data, pad_hw, dn=dn)


def joint_family_loss(outs: Dict[str, Any], gt_boxes_list, gt_labels_list, dn_pack=None,
                      pc_range=None, dn_weight: float = 1.0, **kw) -> Dict[str, torch.Tensor]:
    """The joint family's loss (joint_head.py:992-1101 ``loss``, the same in
    v2/v3 and joint_streampetr_head): the DETR3D family's per-layer
    Hungarian loss, and with DN queries the DN branch (dn_loss_single,
    :939-989). ``pc_range`` and ``dn_weight`` go to the DN branch, the rest
    to ``detr3d_family_loss``."""
    from panacea_tpu_torch.perception.denoise import dn_loss
    from panacea_tpu_torch.perception.vestigial_train import detr3d_family_loss

    losses = detr3d_family_loss(outs["all_cls_scores"], outs["all_bbox_preds"], gt_boxes_list,
                                gt_labels_list, **kw)
    if dn_pack is not None and "dn_cls_scores" in outs:
        losses["loss_dn"] = dn_loss(outs["dn_cls_scores"], outs["dn_bbox_preds"], dn_pack,
                                    pc_range, num_classes=kw.get("num_classes", 10),
                                    dn_weight=dn_weight)
        losses["loss"] = losses["loss"] + losses["loss_dn"]
    return losses
