"""SimMOD: the two-stage multi-view 3D detector (proposals, then a DETR
decoder that refines them).

Counterpart of ``panacea_tpu/perception/simmod.py`` (reference
detectors/simmod.py:25-394 and dense_heads/simmod_head.py:23-787):
ResNet-50 + FPN per camera, ``FCOSProposalHead`` lifting the top-k tokens
to 3D proposals, and ``SimMODHead``, a Deformable-DETR decoder with
per-layer box refinement whose queries are the proposals' features and
positions (simmod_head.py:253-386). One frame, no temporal memory.

The cross-attention is ``DeformableFeatureAggregation`` (the reference's
deformable transformer projects the 3D reference through every camera),
or with ``cross_attn='twostage'`` the single-point
``TwoStageDetr3DCrossAtten``. The self-attention over the P proposals has
Sq = Skv, so the router sends it to SDPA, as the JAX router sends it to
XLA. Names follow the reference's mmdet containers
(``transformer.decoder.layers.{i}.attentions.{0,1}``, ``norms``, ``ffns``,
``cls_branches.{i}``, ``reg_branches.{i}``, ``input_proj``), the driver's
``img_backbone``, ``img_neck``, ``img_rpn_head`` and ``pts_bbox_head``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from panacea_tpu_torch.perception.atss import CLS_BIAS
from panacea_tpu_torch.perception.deformable import DeformableFeatureAggregation
from panacea_tpu_torch.perception.fcos_proposal import FCOSProposalHead
from panacea_tpu_torch.perception.fpn import FPN
from panacea_tpu_torch.perception.head import (FFN, PC_RANGE, MultiheadSelfAttention,
                                               inverse_sigmoid)
from panacea_tpu_torch.perception.resnet import ResNet50
from panacea_tpu_torch.perception.twostage_attn import TwoStageDetr3DCrossAtten


class SimMODDecoderLayer(nn.Module):
    """[self-attention over the proposals, norm, cross-attention, norm,
    FFN, norm]."""

    def __init__(self, embed_dims: int, num_levels: int, num_cams: int, cross_attn: str,
                 pc_range: Sequence[float]):
        super().__init__()
        if cross_attn == "twostage":
            cross = TwoStageDetr3DCrossAtten(embed_dims, num_levels=num_levels,
                                             num_cams=num_cams, pc_range=pc_range)
        elif cross_attn == "deformable":
            cross = DeformableFeatureAggregation(embed_dims, num_levels=num_levels,
                                                 num_cams=num_cams)
        else:
            raise ValueError(f"unknown cross_attn {cross_attn!r}")
        self.cross_attn = cross_attn
        self.attentions = nn.ModuleList([MultiheadSelfAttention(embed_dims), cross])
        self.ffns = nn.ModuleList([FFN(embed_dims)])
        self.norms = nn.ModuleList(nn.LayerNorm(embed_dims, eps=1e-5) for _ in range(3))

    def forward(self, query, query_pos, feats, ref, ref_lidar, lidar2img, pad_hw):
        query = self.norms[0](self.attentions[0](query, query, query, query_pos, query_pos))
        if self.cross_attn == "twostage":
            query = self.attentions[1](query, feats, ref, lidar2img, pad_hw, query_pos=query_pos)
        else:
            query = self.attentions[1](query, query_pos, feats, ref_lidar, lidar2img, pad_hw)
        return self.norms[2](self.ffns[0](self.norms[1](query)))


class SimMODHead(nn.Module):
    """The proposal-query decoder with box refinement (simmod_head.py:107-386).
    With ``with_box_refine`` each layer has its own cls and reg branch;
    without, one pair is shared (held once, as ``.0``)."""

    def __init__(self, num_classes: int = 10, embed_dims: int = 256,
                 num_decoder_layers: int = 6, num_reg_fcs: int = 2, code_size: int = 10,
                 num_levels: int = 4, num_cams: int = 6, num_input_proj: int = 2,
                 with_box_refine: bool = True, proposal_cam_embeddings: bool = False,
                 proposal_level_embeddings: bool = False,
                 pc_range: Sequence[float] = PC_RANGE, cross_attn: str = "deformable"):
        super().__init__()
        c = embed_dims
        self.embed_dims, self.with_box_refine = c, with_box_refine
        self.register_buffer("pc_range", torch.tensor(pc_range, dtype=torch.float32),
                             persistent=False)
        proj = []
        for i in range(num_input_proj):
            proj += [nn.Linear(2 * c if i == 0 else c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU()]
        self.input_proj = nn.Sequential(*proj)
        self.pos_proj = nn.Linear(3, c)
        self.proposal_cam_embeds = (nn.Parameter(torch.randn(num_cams, c) * 0.1)
                                    if proposal_cam_embeddings else None)
        self.proposal_level_embeds = (nn.Parameter(torch.randn(num_levels, c) * 0.1)
                                      if proposal_level_embeddings else None)
        self.transformer = nn.Module()
        self.transformer.decoder = nn.Module()
        self.transformer.decoder.layers = nn.ModuleList(
            SimMODDecoderLayer(c, num_levels, num_cams, cross_attn, pc_range)
            for _ in range(num_decoder_layers))
        n_branches = num_decoder_layers if with_box_refine else 1
        cls_branches, reg_branches = [], []
        for _ in range(n_branches):
            cls, reg = [], []
            for _ in range(num_reg_fcs):
                cls += [nn.Linear(c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU()]
                reg += [nn.Linear(c, c), nn.ReLU()]
            cls_branches.append(nn.Sequential(*cls, nn.Linear(c, num_classes)))
            reg_branches.append(nn.Sequential(*reg, nn.Linear(c, code_size)))
            nn.init.constant_(cls_branches[-1][-1].bias, CLS_BIAS)
        self.cls_branches = nn.ModuleList(cls_branches)
        self.reg_branches = nn.ModuleList(reg_branches)

    def forward(self, mlvl_feats: Sequence[torch.Tensor], proposal_features: torch.Tensor,
                proposal_positions: torch.Tensor, data: Dict[str, torch.Tensor],
                pad_hw: Tuple[int, int], proposal_scores: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        """mlvl_feats per level (B N, C, h, w); proposal_features (B, P, 2C);
        proposal_positions (B, P, >= 3) lidar xyz (then view, level). Returns
        all_cls_scores and all_bbox_preds (L, B, P, .), with
        ``proposal_scores`` also all_cls_scores_combined."""
        pc = self.pc_range
        query = self.input_proj(proposal_features)
        ref = ((proposal_positions[..., :3] - pc[0:3]) / (pc[3:6] - pc[0:3])).clamp(0.0, 1.0)
        query_pos = self.pos_proj(ref)
        if self.proposal_cam_embeds is not None:
            query_pos = query_pos + self.proposal_cam_embeds[proposal_positions[..., 3].long()]
        if self.proposal_level_embeds is not None:
            query_pos = query_pos + self.proposal_level_embeds[proposal_positions[..., 4].long()]
        cls_list, reg_list = [], []
        for li, layer in enumerate(self.transformer.decoder.layers):
            ref_lidar = ref * (pc[3:6] - pc[0:3]) + pc[0:3]
            query = layer(query, query_pos, mlvl_feats, ref, ref_lidar, data["lidar2img"],
                          pad_hw)
            bi = li if self.with_box_refine else 0
            cls_list.append(self.cls_branches[bi](query))
            new_ref, box = self.refine(ref, self.reg_branches[bi](query))
            reg_list.append(box)
            if self.with_box_refine:
                ref = new_ref.detach()
        outs = {"all_cls_scores": torch.stack(cls_list), "all_bbox_preds": torch.stack(reg_list),
                "enc_cls_scores": None, "enc_bbox_preds": None}
        if proposal_scores is not None:
            outs["all_cls_scores_combined"] = combine_scores(outs["all_cls_scores"],
                                                             proposal_scores)
        return outs

    def refine(self, ref: torch.Tensor, reg_out: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Box refinement (:341-369): the xyz offsets of ``reg_out`` move the
        normalised reference ``ref``. Returns the new reference and the box
        (its xyz in lidar metres, the other channels as predicted)."""
        pc = self.pc_range
        new_ref = torch.sigmoid(reg_out[..., 0:3] + inverse_sigmoid(ref))
        return new_ref, torch.cat([new_ref * (pc[3:6] - pc[0:3]) + pc[0:3], reg_out[..., 3:]],
                                  dim=-1)


def combine_scores(all_cls_scores: torch.Tensor, proposal_scores: torch.Tensor) -> torch.Tensor:
    """combine_scores (simmod_head.py:374-378): the decoder's class logits
    (L, B, P, C) times the proposals' scores (B, P), back in logit space."""
    comb = torch.sigmoid(all_cls_scores) * proposal_scores.detach()[None, :, :, None]
    return inverse_sigmoid(comb)


class SimMOD(nn.Module):
    """The two-stage driver (detectors/simmod.py:25-394): ResNet-50, an FPN
    from C3 with ``num_levels`` outputs (strides 8, 16, ...),
    ``FCOSProposalHead`` and ``SimMODHead``."""

    def __init__(self, num_classes: int = 10, embed_dims: int = 256, num_levels: int = 4,
                 num_cams: int = 6, num_proposal: int = 600, num_decoder_layers: int = 6,
                 fcos_cfg: Optional[dict] = None, head_cfg: Optional[dict] = None,
                 pc_range: Sequence[float] = PC_RANGE, backbone_cfg: Optional[dict] = None):
        super().__init__()
        self.img_backbone = ResNet50(**dict(backbone_cfg or {}))
        self.img_neck = FPN(out_channels=embed_dims, num_outs=num_levels, start_level=1)
        self.img_rpn_head = FCOSProposalHead(
            num_classes=num_classes, in_channels=embed_dims, feat_channels=embed_dims,
            num_proposal=num_proposal, strides=tuple(8 * 2 ** i for i in range(num_levels)),
            **dict(fcos_cfg or {}))
        self.pts_bbox_head = SimMODHead(
            num_classes=num_classes, embed_dims=embed_dims, num_levels=num_levels,
            num_cams=num_cams, num_decoder_layers=num_decoder_layers, pc_range=pc_range,
            **dict(head_cfg or {}))

    def extract_feats(self, imgs: torch.Tensor):
        """imgs (B, N, H, W, 3) normalised -> the FPN's levels, (B N, C, h, w)."""
        b, n, h, w, c = imgs.shape
        return list(self.img_neck(self.img_backbone(
            imgs.reshape(b * n, h, w, c).permute(0, 3, 1, 2).contiguous())))

    def forward(self, imgs: torch.Tensor, data: Dict[str, torch.Tensor]):
        """imgs (B, N, H, W, 3); data: lidar2img, intrinsics, extrinsics
        (B, N, 4, 4). Returns (outs, proposals)."""
        b, n, h, w, _ = imgs.shape
        feats = self.extract_feats(imgs)
        rpn_outs = self.img_rpn_head(feats)
        proposals = self.img_rpn_head.get_proposals(rpn_outs, data, num_cams=n)
        outs = self.pts_bbox_head(feats, proposals["proposal_features"],
                                  proposals["proposal_positions"], data, (h, w),
                                  proposal_scores=proposals["proposal_scores"])
        return outs, proposals


def simmod_loss(outs: Dict[str, torch.Tensor], gt_boxes_list, gt_labels_list,
                pre_assigns_list=None, compute_loss_iou3d: bool = False,
                iou3d_weight: float = 1.0, **kw) -> Dict[str, torch.Tensor]:
    """SimMODHead's loss (simmod_head.py:389-658): the DETR3D family's
    Hungarian loss with SimMOD's pinned pre-assignments and, with
    ``compute_loss_iou3d``, the IoU3D quality branch on the last box
    channel (code_size 11, :637); the box terms take channels [:10]."""
    from panacea_tpu_torch.perception.vestigial_train import detr3d_family_loss

    preds = outs["all_bbox_preds"]
    iou_logits = None
    if compute_loss_iou3d:
        if preds.shape[-1] <= 10:
            raise ValueError("compute_loss_iou3d needs code_size 11 (the IoU logit in the "
                             "last box channel)")
        iou_logits = preds[..., -1]
    return detr3d_family_loss(outs["all_cls_scores"], preds, gt_boxes_list, gt_labels_list,
                              pre_assigns_list=pre_assigns_list, iou3d_logits=iou_logits,
                              iou3d_weight=iou3d_weight, **kw)
