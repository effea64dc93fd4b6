"""StreamPETRHead: the dense-attention PETR detection head.

Counterpart of ``panacea_tpu/perception/petr_head.py`` (reference
streampetr_head.py:31-997 and petr_transformer.py:284-560): the query
memory of ``SparseHead`` (propagation, ego-motion alignment, DN), but a
decoder whose cross-attention runs densely from every query to every image
token of the cameras, with a 3D frustum position encoding
(position_embeding, streampetr_head.py:376-420), where SparseHead samples
points deformably.

The cross-attention goes through ``ops.attention.attention``: at the eval
recipe the queries are 644 + 256 = 900 and the tokens 6 cameras x 32 x 64
= 12,288 (stride 8 at 256 x 512), so it takes the flash kernel, as the JAX
package's ``attention`` takes its Pallas kernel there
(``panacea_tpu/ops/attention.py:229-238``).

Keys are the reference's (``position_encoder.{0,2}``, ``memory_embed.{0,2}``,
``featurized_pe.conv_{reduce,expand}``, ``spatial_alignment``,
``transformer.decoder.post_norm``, both attentions of a layer as packed
``nn.MultiheadAttention``s ``attentions.{0,1}.attn.in_proj_weight``), the
names ``panacea_tpu/utils/convert.py:1181-1254`` maps from.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from panacea_tpu_torch.perception.encoding import MLN, pos2posemb3d
from panacea_tpu_torch.perception.head import (
    FFN,
    MemoryState,
    MultiheadSelfAttention,
    PackedAttention,
    SparseHead,
    inverse_sigmoid,
)

POSITION_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


def depth_bins(depth_num: int, position_range_x: float, depth_start: float,
               lid: bool) -> np.ndarray:
    """coords_d (streampetr_head.py:217-228): linear-increasing (LID) or
    uniform depth bins along a camera ray, computed in float64."""
    index = np.arange(depth_num, dtype=np.float64)
    if lid:
        bin_size = (position_range_x - depth_start) / (depth_num * (1 + depth_num))
        return (depth_start + bin_size * index * (index + 1)).astype(np.float32)
    bin_size = (position_range_x - depth_start) / depth_num
    return (depth_start + bin_size * index).astype(np.float32)


class PETRCrossAttention(nn.Module):
    """mmcv MultiheadAttention as the cross-attention
    (petr_transformer.py:87-282): q = query + query_pos, k = key + key_pos,
    v = key; residual add."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8):
        super().__init__()
        self.attn = PackedAttention(embed_dims, num_heads)

    def forward(self, query, key, query_pos, key_pos):
        return query + self.attn(query + query_pos, key + key_pos, key)


class SELayerLinear(nn.Module):
    """featurized_pe (misc.py:163-175): the position embedding gated by the
    content features."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = nn.Linear(channels, channels)
        self.conv_expand = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, x_se: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv_expand(torch.relu(self.conv_reduce(x_se))))


class PETRDecoderLayer(nn.Module):
    """[self-attention, norm, dense cross-attention, norm, FFN, norm]."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.attentions = nn.ModuleList([MultiheadSelfAttention(embed_dims),
                                         PETRCrossAttention(embed_dims)])
        self.ffns = nn.ModuleList([FFN(embed_dims)])
        self.norms = nn.ModuleList(nn.LayerNorm(embed_dims, eps=1e-5) for _ in range(3))

    def forward(self, query, query_pos, key, key_pos, tokens, pos_embed, attn_bias=None):
        query = self.norms[0](self.attentions[0](query, key, key, query_pos, key_pos, attn_bias))
        query = self.norms[1](self.attentions[1](query, tokens, query_pos, pos_embed))
        return self.norms[2](self.ffns[0](query))


class StreamPETRHead(SparseHead):
    """The reference head's config (streampetr_head.py:62-141):
    ``position_range`` the frustum volume, wider than ``pc_range``;
    ``feat_level`` the neck output the decoder attends to (position_level
    0 in petr3d.py)."""

    def __init__(self, *, depth_num: int = 64, depth_start: float = 1.0, lid: bool = False,
                 position_range: Sequence[float] = POSITION_RANGE, feat_level: int = 0,
                 **kwargs):
        super().__init__(**kwargs)
        c = self.embed_dims
        self.depth_num, self.depth_start, self.lid = depth_num, depth_start, lid
        self.feat_level = feat_level
        self.position_range = tuple(position_range)
        self.register_buffer("coords_d", torch.from_numpy(depth_bins(
            depth_num, float(position_range[3]), depth_start, lid)), persistent=False)
        self.register_buffer("pos_range", torch.tensor(position_range, dtype=torch.float32),
                             persistent=False)
        self.position_encoder = nn.Sequential(nn.Linear(depth_num * 3, 4 * c), nn.ReLU(),
                                              nn.Linear(4 * c, c))
        self.memory_embed = nn.Sequential(nn.Linear(c, c), nn.ReLU(), nn.Linear(c, c))
        self.featurized_pe = SELayerLinear(c)
        self.spatial_alignment = MLN(8, c)

    def _build_transformer(self, c: int, num_layers: int, *unused) -> nn.Module:
        """transformer.decoder.layers and the post_norm shared by every
        layer's output (PETRTransformerDecoder, petr_transformer.py:249-252)."""
        transformer = nn.Module()
        transformer.decoder = nn.Module()
        transformer.decoder.layers = nn.ModuleList(PETRDecoderLayer(c) for _ in range(num_layers))
        transformer.decoder.post_norm = nn.LayerNorm(c, eps=1e-5)
        return transformer

    def frustum_coords(self, data: Dict[str, torch.Tensor], feat_hw: Tuple[int, int],
                       pad_hw: Tuple[int, int]):
        """The frustum's points before the MLP (streampetr_head.py:376-418):
        normalised 3D coordinates (B, N h w, depth_num 3) and the 8-dim
        ``cone`` (focal lengths, the farthest and the 30th-from-farthest
        point of each ray)."""
        h, w = feat_hw
        l2i = data["lidar2img"]
        b, n = l2i.shape[:2]
        dev = l2i.device
        ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h * pad_hw[0]
        xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w * pad_hw[1]
        cx, cy = torch.meshgrid(xs, ys, indexing="xy")                   # (h, w)
        centers = torch.stack([cx, cy], dim=-1).reshape(1, 1, h * w, 1, 2)
        dd = self.coords_d.reshape(1, 1, 1, -1, 1).expand(b, n, h * w, self.depth_num, 1)
        coords = torch.cat([centers * dd.clamp(min=1e-5), dd, torch.ones_like(dd)], dim=-1)
        img2lidar = torch.linalg.inv(l2i)                                # (B, N, 4, 4)
        pts = torch.einsum("bnij,bnkdj->bnkdi", img2lidar, coords)[..., :3]
        pr = self.pos_range
        pts = ((pts - pr[0:3]) / (pr[3:6] - pr[0:3])).reshape(b, n * h * w, self.depth_num * 3)
        intr = data["intrinsics"]
        focal = torch.stack([intr[..., 0, 0], intr[..., 1, 1]], dim=-1).abs() / 1e3  # (B, N, 2)
        focal = focal[:, :, None].expand(b, n, h * w, 2).reshape(b, n * h * w, 2)
        cone = torch.cat([focal, pts[..., -3:], pts[..., -90:-87]], dim=-1)
        return pts, cone

    def position_embedding(self, data, feat_hw, pad_hw):
        """3D frustum position encoding: (pos_embed, cone)."""
        pts, cone = self.frustum_coords(data, feat_hw, pad_hw)
        return self.position_encoder(inverse_sigmoid(pts)), cone

    def encode_tokens(self, feat: torch.Tensor, data: Dict[str, torch.Tensor],
                      pad_hw: Tuple[int, int], topk_indexes: Optional[torch.Tensor] = None):
        """The decoder's keys from one neck level (B N, C, h, w): the tokens
        (B, N h w, C) through ``memory_embed`` and the spatial alignment,
        and their position embedding gated by them. ``topk_indexes`` (B, K,
        1) keeps K tokens (the reference's topk_gather,
        streampetr_head.py:440-447), before the position MLP runs."""
        bn, c, fh, fw = feat.shape
        b = data["lidar2img"].shape[0]
        tokens = feat.reshape(b, bn // b, c, fh * fw).transpose(2, 3).reshape(b, -1, c)
        pts, cone = self.frustum_coords(data, (fh, fw), pad_hw)
        if topk_indexes is not None:
            def gather(t):
                return torch.gather(t, 1, topk_indexes.expand(-1, -1, t.shape[-1]))

            tokens, pts, cone = gather(tokens), gather(pts), gather(cone)
        pos_embed = self.position_encoder(inverse_sigmoid(pts))
        tokens = self.spatial_alignment(self.memory_embed(tokens), cone)
        return tokens, self.featurized_pe(pos_embed, tokens)

    def decode(self, query, query_pos, ref, tokens, pos_embed, temp_memory=None, temp_pos=None,
               attn_bias=None):
        """The decoder layers: self-attention over the queries (and the
        memory's keys, where given), dense cross-attention to the tokens,
        FFN; each layer's output post-normed into the branches. Returns
        (all_cls, all_reg, outs_dec), each stacked over the layers."""
        cls_list, reg_list, dec_list = [], [], []
        ref_logit = inverse_sigmoid(ref)
        cls_branch, reg_branch = self.cls_branches[0], self.reg_branches[0]
        decoder = self.transformer.decoder
        for layer in decoder.layers:
            key, key_pos = query, query_pos
            if temp_memory is not None:
                key = torch.cat([query, temp_memory], dim=1)
                key_pos = torch.cat([query_pos, temp_pos], dim=1)
            query = layer(query, query_pos, key, key_pos, tokens, pos_embed, attn_bias)
            qn = decoder.post_norm(query)
            reg_out = reg_branch(qn)
            xyz = self._to_range(torch.sigmoid(reg_out[..., 0:3] + ref_logit))
            cls_list.append(cls_branch(qn))
            reg_list.append(torch.cat([xyz, reg_out[..., 3:]], dim=-1))
            dec_list.append(qn)
        return torch.stack(cls_list), torch.stack(reg_list), torch.stack(dec_list)

    @staticmethod
    def split_dn(all_cls, all_reg, pad: int) -> Dict[str, torch.Tensor]:
        outs = {}
        if pad:
            outs = {"dn_cls_scores": all_cls[:, :, :pad], "dn_bbox_preds": all_reg[:, :, :pad]}
        outs.update(all_cls_scores=all_cls[:, :, pad:], all_bbox_preds=all_reg[:, :, pad:])
        return outs

    def forward(self, mlvl_feats: Sequence[torch.Tensor], memory: MemoryState,
                data: Dict[str, torch.Tensor], pad_hw: Tuple[int, int], dn: Optional[Any] = None,
                topk_indexes: Optional[torch.Tensor] = None):
        """SparseHead's protocol, the decoder attending to
        ``mlvl_feats[feat_level]`` flattened over the cameras. Returns
        (outs, new_memory)."""
        memory = self.pre_update_memory(memory, data)
        tokens, pos_embed = self.encode_tokens(mlvl_feats[self.feat_level], data, pad_hw,
                                               topk_indexes)
        b = tokens.shape[0]
        ref = self.make_queries(b, dn)
        query_pos = self.query_embedding(pos2posemb3d(ref))
        tgt, query_pos, ref, temp_memory, temp_pos, rec_ego_pose = self.temporal_alignment(
            query_pos, torch.zeros_like(query_pos), ref, memory)
        all_cls, all_reg, outs_dec = self.decode(
            tgt, query_pos, ref, tokens, pos_embed, temp_memory, temp_pos,
            dn.attn_mask if dn is not None else None)
        pad = dn.pad_size if dn is not None else 0
        outs = self.head_extras(self.split_dn(all_cls, all_reg, pad), outs_dec[:, :, pad:])
        return outs, self.post_update_memory(memory, data, rec_ego_pose[:, pad:], outs,
                                             outs_dec[-1][:, pad:])

    def head_extras(self, outs: Dict[str, torch.Tensor], outs_dec: torch.Tensor):
        """Output branches of a subclass on the decoder's post-normed
        outputs without the DN rows (``PETRMotionHead``'s trajectories)."""
        return outs
