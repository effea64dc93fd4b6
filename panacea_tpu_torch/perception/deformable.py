"""Multi-camera, multi-scale deformable feature aggregation.

Counterpart of ``panacea_tpu/perception/deformable.py`` (reference
detr3d_transformer.py:525-613): 3D key points (reference point plus learned
offsets) are projected into every camera, sampled bilinearly from every FPN
level and summed with softmax weights that are joint over cameras x levels
x points for each (query, group). The JAX package samples by an XLA gather
(``bilinear_sample``, not a Pallas kernel); here ``F.grid_sample`` with
``align_corners=False`` and zero padding computes the same function: x =
u W - 0.5, and each corner outside the map contributes 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def project_points(key_points: torch.Tensor, lidar2img: torch.Tensor,
                   pad_hw: Tuple[int, int]) -> torch.Tensor:
    """key_points (B, Q, P, 3) in the lidar frame, lidar2img (B, N, 4, 4)
    -> uv (B, N, Q, P, 2) over the padded image, in [0, 1] inside it. Depth
    is clipped at 1e-5, so a point behind a camera lands far off its image
    (detr3d_transformer.py:594-602)."""
    pts = torch.cat([key_points, torch.ones_like(key_points[..., :1])], dim=-1)
    cam = torch.einsum("bnij,bqpj->bnqpi", lidar2img, pts)
    uv = cam[..., :2] / cam[..., 2:3].clamp(min=1e-5)
    return uv / torch.tensor([pad_hw[1], pad_hw[0]], dtype=uv.dtype, device=uv.device)


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (M, C, H, W), uv (M, Q, P, 2) in [0, 1] over the map ->
    (M, C, Q, P)."""
    return F.grid_sample(feat, 2.0 * uv - 1.0, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


class DeformableFeatureAggregation(nn.Module):
    """Keys as the reference's ``attentions.1``: ``learnable_fc``,
    ``cam_embed.{0,2,4}``, ``weights_fc``, ``output_proj``."""

    def __init__(self, embed_dims: int = 256, num_groups: int = 8, num_levels: int = 5,
                 num_cams: int = 6, num_pts: int = 13):
        super().__init__()
        self.embed_dims, self.num_groups = embed_dims, num_groups
        self.num_levels, self.num_cams, self.num_pts = num_levels, num_cams, num_pts
        c = embed_dims
        self.learnable_fc = nn.Linear(c, num_pts * 3)
        self.cam_embed = nn.Sequential(nn.Linear(12, c // 2), nn.ReLU(), nn.Linear(c // 2, c),
                                       nn.ReLU(), nn.LayerNorm(c, eps=1e-5))
        self.weights_fc = nn.Linear(c, num_groups * num_levels * num_pts)
        self.output_proj = nn.Linear(c, c)

    def forward(self, instance_feature: torch.Tensor, query_pos: torch.Tensor,
                mlvl_feats: Sequence[torch.Tensor], reference_points_3d: torch.Tensor,
                lidar2img: torch.Tensor, pad_hw: Tuple[int, int]) -> torch.Tensor:
        """instance_feature, query_pos (B, Q, C); mlvl_feats: per level
        (B N, C, h, w); reference_points_3d (B, Q, 3) in the lidar frame;
        lidar2img (B, N, 4, 4). Returns (B, Q, C)."""
        b, q, c = instance_feature.shape
        n, g, lv, p = self.num_cams, self.num_groups, self.num_levels, self.num_pts
        key_points = reference_points_3d[:, :, None, :] + self.learnable_fc(
            instance_feature).reshape(b, q, p, 3)
        cam_embed = self.cam_embed(lidar2img[..., :3, :].reshape(b, n, 12))
        feat_pos = (instance_feature + query_pos)[:, None] + cam_embed[:, :, None]  # (B, N, Q, C)
        # softmax over cams x levels x points jointly per (query, group)
        # (detr3d_transformer.py:583), not per camera
        weights = self.weights_fc(feat_pos).reshape(b, n, q, lv * p, g)
        weights = weights.permute(0, 2, 1, 3, 4).reshape(b, q, n * lv * p, g).softmax(dim=-2)
        weights = weights.reshape(b, q, n, lv, p, g)

        uv = project_points(key_points, lidar2img, pad_hw).reshape(b * n, q, p, 2)
        out = 0.0
        for li, feat in enumerate(mlvl_feats):
            sampled = bilinear_sample(feat, uv).reshape(b, n, g, c // g, q, p)
            out = out + torch.einsum("bngdqp,bqnpg->bqgd", sampled, weights[:, :, :, li])
        return instance_feature + self.output_proj(out.reshape(b, q, c))
