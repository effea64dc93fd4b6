"""TwoStageDetr3DCrossAtten: single-point projective cross-attention.

Counterpart of ``panacea_tpu/perception/twostage_attn.py`` (reference
twostage_detr3d_transformer.py:264-628, the Detr3D-style attention of the
two-stage SimMOD decoders): each query's one 3D reference point is
projected into every camera and sampled once per camera and FPN level
(bilinear, align_corners=True), weighted by sigmoid attention weights over
cameras x points x levels (a full ``num_cams * num_points * num_levels``
linear, or the depth-wise ``num_cams + num_points + num_levels`` split,
:461-470), masked by the in-frustum and valid-range test, summed,
projected, and added to the residual and ``position_encoder(
inverse_sigmoid(ref))`` (:478-484).

The JAX package samples channels-last by an XLA gather; here
``F.grid_sample(align_corners=True, padding_mode='zeros')`` on the NCHW
levels computes the same function. Keys are the reference's
(``attention_weights``, ``output_proj``, ``position_encoder.{0,1,3,4}``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.head import PC_RANGE, inverse_sigmoid


def bilinear_sample_ac(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """grid_sample(align_corners=True, padding_mode='zeros') of one point
    set: feat (B, C, H, W), grid (B, P, 2) xy in [-1, 1] -> (B, P, C)."""
    out = F.grid_sample(feat, grid[:, :, None, :], mode="bilinear", padding_mode="zeros",
                        align_corners=True)                     # (B, C, P, 1)
    return out[..., 0].transpose(1, 2)


def project_reference_points(reference_points: torch.Tensor, lidar2img: torch.Tensor,
                             pc_range: Sequence[float], img_shape: Tuple[int, int],
                             valid_ranges: Optional[torch.Tensor] = None):
    """feature_sampling's projection (:560-613): reference_points (B, Q, 3)
    in [0, 1], lidar2img (B, N, 4, 4), img_shape (H, W). Returns (cam_xy
    (B, N, Q, 2) in [-1, 1], mask (B, N, Q, 1)): in front of the camera and
    strictly inside the valid range (the image by default)."""
    pr = torch.as_tensor(pc_range, dtype=reference_points.dtype, device=reference_points.device)
    pts = reference_points * (pr[3:6] - pr[0:3]) + pr[0:3]
    pts = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    cam = torch.einsum("bnij,bqj->bnqi", lidar2img, pts)
    eps = 1e-5
    mask = cam[..., 2:3] > eps
    h, w = img_shape
    xy = cam[..., 0:2] / cam[..., 2:3].clamp(min=eps)
    xy = (xy / torch.tensor([w, h], dtype=xy.dtype, device=xy.device) - 0.5) * 2.0
    if valid_ranges is None:
        vr = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=xy.dtype, device=xy.device).expand(
            xy.shape[:2] + (4,))
    else:
        nrm = torch.tensor([w, h, w, h], dtype=xy.dtype, device=xy.device)
        vr = (valid_ranges / nrm - 0.5) * 2.0
    vr = vr[:, :, None, :]
    mask = (mask & (xy[..., 0:1] > vr[..., 0:1]) & (xy[..., 0:1] < vr[..., 2:3])
            & (xy[..., 1:2] > vr[..., 1:2]) & (xy[..., 1:2] < vr[..., 3:4]))
    return xy, mask.to(xy.dtype)


class TwoStageDetr3DCrossAtten(nn.Module):
    """The reference's config (:283-300). ``attention_weights_normalize``
    is refused: the JAX module holds the flag and ignores it, so there is
    no counterpart to port (ROADMAP Queue C)."""

    def __init__(self, embed_dims: int = 256, num_levels: int = 4, num_points: int = 5,
                 num_cams: int = 6, pc_range: Sequence[float] = PC_RANGE,
                 attention_weights_normalize: bool = False, depth_wise_weights: bool = False,
                 pos_encoder_linear: bool = False):
        super().__init__()
        if attention_weights_normalize:
            raise NotImplementedError("attention_weights_normalize: the JAX module ignores it")
        c = embed_dims
        self.num_levels, self.num_points, self.num_cams = num_levels, num_points, num_cams
        self.pc_range, self.depth_wise_weights = tuple(pc_range), depth_wise_weights
        n_w = (num_cams + num_points + num_levels if depth_wise_weights
               else num_cams * num_levels * num_points)
        self.attention_weights = nn.Linear(c, n_w)
        self.output_proj = nn.Linear(c, c)
        if pos_encoder_linear:
            self.position_encoder = nn.Linear(3, c)
        else:
            self.position_encoder = nn.Sequential(
                nn.Linear(3, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU(),
                nn.Linear(c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU())

    def forward(self, query: torch.Tensor, mlvl_feats: Sequence[torch.Tensor],
                reference_points: torch.Tensor, lidar2img: torch.Tensor,
                img_shape: Tuple[int, int], query_pos: Optional[torch.Tensor] = None,
                valid_ranges: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, C); mlvl_feats per level (B N, C, h, w);
        reference_points (B, Q, 3) in [0, 1]. Returns (B, Q, C)."""
        residual = query
        if query_pos is not None:
            query = query + query_pos
        b, q, c = query.shape
        n, p, lv = self.num_cams, self.num_points, self.num_levels
        xy, mask = project_reference_points(reference_points, lidar2img, self.pc_range,
                                            img_shape, valid_ranges)
        grid = xy.reshape(b * n, q, 2)
        # one sample per (camera, level); the point axis is broadcast
        out = torch.stack([bilinear_sample_ac(f, grid).reshape(b, n, q, c) for f in mlvl_feats],
                          dim=-1)                                   # (B, N, Q, C, L)
        w = self.attention_weights(query)
        if self.depth_wise_weights:
            cam_w, pt_w, lvl_w = w[..., :n], w[..., n:n + p], w[..., n + p:]
            attn = cam_w[..., :, None, None] * pt_w[..., None, :, None] * lvl_w[..., None, None, :]
        else:
            attn = w.reshape(b, q, n, p, lv)
        attn = torch.sigmoid(attn) * mask.permute(0, 2, 1, 3)[..., None]   # (B, Q, N, P, L)
        # the points share one sample: sum the weights over them first
        agg = torch.einsum("bnqcl,bqnl->bqc", out, attn.sum(3))
        pos_feat = self.position_encoder(inverse_sigmoid(reference_points))
        return self.output_proj(agg) + residual + pos_feat
