"""SparseHeadv3 and SparseHeadv4: the proposal-query variants of SparseHead.

Counterpart of ``panacea_tpu/perception/sparse_head_v3.py`` (reference
sparse_head_v3.py:20-997 and sparse_head_v4.py:20-1012). Both keep
SparseHead's decoder and memory; the queries come from 2D proposals in
``data`` (``proposal_positions`` (B, P, >= 3) in lidar coordinates,
``proposal_features`` (B, P, 2C)):

- v3 (``mode='context'``, sparse_head_v3.py:252-269, :503-519): P queries,
  the reference points at the proposals and the content
  ``input_proj(proposal_features)``, with
  ``context_embedding(pos2posemb3d(ref))`` under any row beyond the
  features;
- v4 (``mode='seed'``, sparse_head_v4.py:254-274, :512-523): the proposals
  seed the first rows of the learned reference points, padded with the
  table up to ``num_query``; the content stays zero.

Without proposals both are SparseHead (the references' ``using_queries``
branch). With DN queries the DN rows take zeros and the proposal content
sits on the first P match rows, as in the JAX package (the reference
writes it over the DN rows; the JAX module's docstring sets out why).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from panacea_tpu_torch.perception.encoding import pos2posemb3d
from panacea_tpu_torch.perception.head import SparseHead


class SparseHeadProposal(SparseHead):
    """SparseHead's config, and ``mode`` 'context' (v3) or 'seed' (v4). v3
    carries ``input_proj`` (``num_input_proj`` of [Linear, LayerNorm,
    ReLU], from 2C) and ``context_embedding`` (the reference's names)."""

    def __init__(self, *args, mode: str = "context", num_input_proj: int = 2,
                 detach_proposal_positions: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in ("context", "seed"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode, self.detach_proposal_positions = mode, detach_proposal_positions
        c = self.embed_dims
        if mode == "context":
            layers = []
            for i in range(num_input_proj):
                layers += [nn.Linear(2 * c if i == 0 else c, c), nn.LayerNorm(c, eps=1e-5),
                           nn.ReLU()]
            self.input_proj = nn.Sequential(*layers)
            # over pos2posemb3d's 3 x 128 bands, as query_embedding
            self.context_embedding = nn.Sequential(nn.Linear(3 * 128, c), nn.ReLU(),
                                                   nn.Linear(c, c))

    def make_queries(self, b: int, dn=None, data: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = (data or {}).get("proposal_positions")
        if pos is None:
            return super().make_queries(b, dn, data)
        if self.detach_proposal_positions:
            pos = pos.detach()
        pc = self.pc_range
        ref = (pos[..., :3] - pc[0:3]) / (pc[3:6] - pc[0:3])
        p = ref.shape[1]
        if self.mode == "seed":
            learned = self.reference_points.weight[None].expand(b, self.num_query, 3)
            ref = torch.cat([ref, learned[:, :max(self.num_query - p, 0)]], dim=1)
            tgt = ref.new_zeros((b, ref.shape[1], self.embed_dims))
        else:
            feats = data.get("proposal_features")
            if feats is None:
                raise ValueError("mode 'context' needs proposal_features")
            tgt = self.context_embedding(pos2posemb3d(ref))
            tgt = torch.cat([self.input_proj(feats), tgt[:, feats.shape[1]:]], dim=1)
        if dn is not None:
            pad = dn.ref.shape[1]
            want = dn.attn_mask.shape[0] - pad - self.num_propagated
            if ref.shape[1] != want:
                raise ValueError(
                    f"DN attention mask sized for {want} queries but the proposal path "
                    f"produced {ref.shape[1]} (mode={self.mode}); build the DN pack with "
                    f"num_query matching the proposal-driven query count (the reference "
                    f"sets num_query to the proposal count, sparse_head_v3.py:375)")
            ref = torch.cat([dn.ref, ref], dim=1)
            tgt = torch.cat([tgt.new_zeros((b, pad, tgt.shape[-1])), tgt], dim=1)
        return ref, tgt

    def query_count(self, proposals: Optional[int]) -> int:
        """The match queries for ``proposals`` proposals (None: none given):
        v3 P, v4 max(P, num_query) (the DN mask's size, JAX
        ``perception/train.py:288-299``)."""
        if proposals is None:
            return self.num_query
        return proposals if self.mode == "context" else max(proposals, self.num_query)


# the reference's registry names
SparseHeadv3 = SparseHeadProposal


class SparseHeadv4(SparseHeadProposal):
    def __init__(self, *args, mode: str = "seed", **kwargs):
        super().__init__(*args, mode=mode, **kwargs)


def sparse_v4_loss(outs: Dict[str, torch.Tensor], gt_boxes_list, gt_labels_list, **kw):
    """SparseHeadv4's training loss (sparse_head_v4.py:740-966 loss_single and
    loss): the DETR3D family's (``vestigial_train.detr3d_family_loss``)."""
    from panacea_tpu_torch.perception.vestigial_train import detr3d_family_loss

    return detr3d_family_loss(outs["all_cls_scores"], outs["all_bbox_preds"], gt_boxes_list,
                              gt_labels_list, **kw)
