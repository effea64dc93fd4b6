"""StreamPETR SparseHead: the query-propagation detection head.

Counterpart of ``panacea_tpu/perception/head.py`` (reference
sparse_head.py:20-997) at the eval config
(streampetr_r50_atss_512x256_window.py:101-147): 644 queries, a 1024-slot
memory, the top 256 propagated, 6 decoder layers of [self-attention over
queries and memory, deformable multi-camera cross-attention, FFN], cls and
reg branches shared across layers. The memory is an explicit
``MemoryState`` threaded through ``forward``.

The self-attention goes through ``ops.attention.attention``: at the eval
recipe q has 644 + 256 = 900 rows and k 900 + 768 = 1668, so it takes the
flash kernel, as the JAX package's ``attention`` takes its Pallas kernel
there (``panacea_tpu/ops/attention.py:234-238``).

Keys are mmdet's (``transformer.decoder.layers.{i}.attentions.0.attn.in_proj_weight``,
``cls_branches.0.{0,1,3,4,6}``, ...): the names that
``panacea_tpu/utils/convert.py:1096-1178`` maps from. The reference's
branches are one module repeated per layer; like the JAX converter, the
port holds it once, as ``cls_branches.0`` and ``reg_branches.0``.

Training adds the denoising queries (``dn``, a ``denoise.DNPack``): the
noised ground truth goes before the match queries, and the self-attention
takes the pack's additive mask. That masked call is plain PyTorch (fp32
logits, softmax, product), as the JAX package computes it with XLA einsums
outside its Pallas kernel (``panacea_tpu/perception/head.py:92-101``); the
unmasked call stays on ``ops.attention.attention``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.ops.attention import attention, merge_heads, split_heads
from panacea_tpu_torch.perception.deformable import DeformableFeatureAggregation
from panacea_tpu_torch.perception.encoding import (
    MLN,
    MLNv2,
    nerf_positional_encoding,
    pos2posemb1d,
    pos2posemb3d,
)

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


class MemoryState(NamedTuple):
    """Query memory bank (sparse_head.py:374-436), all (B, M, ...)."""

    embedding: torch.Tensor        # (B, M, C)
    reference_point: torch.Tensor  # (B, M, 3) in the global frame
    timestamp: torch.Tensor        # (B, M, 1)
    egopose: torch.Tensor          # (B, M, 4, 4)
    velo: torch.Tensor             # (B, M, 2)


def init_memory(batch: int, memory_len: int = 1024, embed_dims: int = 256,
                device=None) -> MemoryState:
    def zeros(*shape):
        return torch.zeros((batch, memory_len) + shape, device=device)
    return MemoryState(zeros(embed_dims), zeros(3), zeros(1), zeros(4, 4), zeros(2))


def transform_reference_points(ref: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """(misc.py:215-224): ref (B, M, 3), pose (B, 4, 4)."""
    pts = torch.cat([ref, torch.ones_like(ref[..., :1])], dim=-1)
    return torch.einsum("bij,bmj->bmi", pose, pts)[..., :3]


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, equal values lowest index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order for
    ties, and fp32 sigmoid scores saturate to 1.0 and tie)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class PackedAttention(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention`` under its names
    (``in_proj_weight`` rows [q; k; v], ``in_proj_bias``, ``out_proj``),
    computed through the port's attention router."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        # each projection is a fresh contiguous (B, S, C) tensor: unit
        # head-dim stride and 16-byte aligned rows, as the flash kernel needs
        q, k, v = (split_heads(F.linear(x, w, bias).contiguous(), self.num_heads)
                   for x, w, bias in ((q_in, wq, bq), (k_in, wk, bk), (v_in, wv, bv)))
        if attn_bias is None:
            out = attention(q, k, v)
        else:   # the DN mask (Sq, Skv), added to every batch row and head
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
            probs = torch.softmax(logits + attn_bias, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out_proj(merge_heads(out))


class MultiheadSelfAttention(nn.Module):
    """mmcv MultiheadAttention: q = query + query_pos, k = key + key_pos,
    v = value, residual add (detr3d_transformer.py:420-437)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8):
        super().__init__()
        self.attn = PackedAttention(embed_dims, num_heads)

    def forward(self, query, key, value, query_pos, key_pos, attn_bias=None):
        return query + self.attn(query + query_pos, key + key_pos, value, attn_bias)


class FFN(nn.Module):
    """mmcv FFN: two linear layers with a ReLU, residual add; keys
    ``layers.0.0`` and ``layers.1``."""

    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 2048):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels), nn.ReLU()),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers(x)


class DecoderLayer(nn.Module):
    """[self-attention over queries and memory, norm, deformable
    cross-attention, norm, FFN, norm] (detr3d_transformer.py)."""

    def __init__(self, embed_dims: int, num_groups: int, num_levels: int, num_cams: int,
                 num_pts: int):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadSelfAttention(embed_dims),
            DeformableFeatureAggregation(embed_dims, num_groups, num_levels, num_cams, num_pts)])
        self.ffns = nn.ModuleList([FFN(embed_dims)])
        self.norms = nn.ModuleList(nn.LayerNorm(embed_dims, eps=1e-5) for _ in range(3))

    def forward(self, query, query_pos, temp_memory, temp_pos, feats, ref_lidar, lidar2img,
                pad_hw, attn_bias=None):
        key = torch.cat([query, temp_memory], dim=1)
        key_pos = torch.cat([query_pos, temp_pos], dim=1)
        query = self.norms[0](self.attentions[0](query, key, key, query_pos, key_pos,
                                                 attn_bias))
        query = self.norms[1](self.attentions[1](query, query_pos, feats, ref_lidar, lidar2img,
                                                 pad_hw))
        return self.norms[2](self.ffns[0](query))


class SparseHead(nn.Module):
    def __init__(self, num_classes: int = 10, embed_dims: int = 256, num_query: int = 644,
                 memory_len: int = 1024, topk_proposals: int = 256, num_propagated: int = 256,
                 num_decoder_layers: int = 6, num_reg_fcs: int = 2, code_size: int = 10,
                 num_levels: int = 5, num_pts: int = 13, num_groups: int = 8,
                 num_cams: int = 6, pc_range: Sequence[float] = PC_RANGE):
        super().__init__()
        c = embed_dims
        self.embed_dims, self.num_query, self.memory_len = c, num_query, memory_len
        self.topk_proposals, self.num_propagated = topk_proposals, num_propagated
        self.num_reg_fcs = num_reg_fcs
        self.register_buffer("pc_range", torch.tensor(pc_range, dtype=torch.float32),
                             persistent=False)
        self.reference_points = nn.Embedding(num_query, 3)
        if self._uses_memory():
            self.pseudo_reference_points = nn.Embedding(num_propagated, 3)
        self.query_embedding = nn.Sequential(nn.Linear(3 * 128, c), nn.ReLU(), nn.Linear(c, c))
        if self._uses_memory():
            self.time_embedding = nn.Sequential(nn.Linear(c, c), nn.LayerNorm(c, eps=1e-5))
            motion_dim = 2 * 6 * 15   # NeRF bands of (velocity or zeros, time, 3x4 pose)
            self.ego_pose_pe = MLN(motion_dim, c)
            self.ego_pose_memory = MLN(motion_dim, c)
        self.transformer = self._build_transformer(c, num_decoder_layers, num_groups, num_levels,
                                                   num_cams, num_pts)
        cls = []
        for _ in range(num_reg_fcs):
            cls += [nn.Linear(c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU()]
        self.cls_branches = nn.ModuleList([nn.Sequential(*cls, nn.Linear(c, num_classes))])
        reg = []
        for _ in range(num_reg_fcs):
            reg += [nn.Linear(c, c), nn.ReLU()]
        self.reg_branches = nn.ModuleList([nn.Sequential(*reg, nn.Linear(c, code_size))])

    def _uses_memory(self) -> bool:
        """Whether the head carries the streaming memory's parameters (the
        pseudo reference points, the time embedding, the ego-motion MLNs);
        the non-streaming ``PETRHeadDN`` has none."""
        return True

    def _build_transformer(self, c: int, num_layers: int, num_groups: int, num_levels: int,
                           num_cams: int, num_pts: int) -> nn.Module:
        """Containers under the reference's names: transformer.spatial_alignment
        (MLNv2, no LayerNorm: the sparse transformer modulates the raw
        features, detr3d_transformer.py:79) and transformer.decoder.layers."""
        transformer = nn.Module()
        transformer.spatial_alignment = MLNv2(14, c)
        transformer.decoder = nn.Module()
        transformer.decoder.layers = nn.ModuleList(
            DecoderLayer(c, num_groups, num_levels, num_cams, num_pts) for _ in range(num_layers))
        return transformer

    def _to_range(self, x: torch.Tensor) -> torch.Tensor:
        pc = self.pc_range
        return x * (pc[3:6] - pc[0:3]) + pc[0:3]

    def pre_update_memory(self, memory: MemoryState, data: Dict[str, torch.Tensor]) -> MemoryState:
        """Carry the memory into this frame (sparse_head.py:381-405): advance
        the timestamps, re-express poses and points in the new ego frame,
        zero it on a scene change, seed the pseudo points when fresh."""
        x = data["prev_exists"].reshape(-1)   # (B,) 1.0 = the scene goes on
        b = x.shape[0]
        keep = x.reshape(b, 1, 1)
        ts = (memory.timestamp + data["timestamp"].reshape(b, 1, 1)) * keep
        egopose = torch.einsum("bij,bmjk->bmik", data["ego_pose_inv"],
                               memory.egopose) * keep[..., None]
        ref = transform_reference_points(memory.reference_point, data["ego_pose_inv"]) * keep
        fresh = (1.0 - x).reshape(b, 1, 1)
        np_ = self.num_propagated
        pseudo = self._to_range(self.pseudo_reference_points.weight)
        ref = torch.cat([ref[:, :np_] + fresh * pseudo[None], ref[:, np_:]], dim=1)
        eye = torch.eye(4, device=ref.device)
        egopose = torch.cat([egopose[:, :np_] + fresh[..., None] * eye, egopose[:, np_:]], dim=1)
        return MemoryState(memory.embedding * keep, ref, ts, egopose, memory.velo * keep)

    def temporal_alignment(self, query_pos, tgt, reference_points, memory: MemoryState):
        """(sparse_head.py:244-273)"""
        b, q = query_pos.shape[:2]
        pc = self.pc_range
        temp_ref = (memory.reference_point - pc[:3]) / (pc[3:6] - pc[0:3])
        temp_pos = self.query_embedding(pos2posemb3d(temp_ref))
        # the queries' own motion: zero velocity and time, identity pose
        eye34 = torch.eye(4, device=tgt.device)[:3].reshape(12)
        rec_motion = nerf_positional_encoding(torch.cat(
            [torch.zeros_like(reference_points[..., :3]), eye34.expand(b, q, 12)], dim=-1))
        tgt = self.ego_pose_memory(tgt, rec_motion)
        query_pos = self.ego_pose_pe(query_pos, rec_motion)
        mem_motion = nerf_positional_encoding(torch.cat(
            [memory.velo, memory.timestamp, memory.egopose[..., :3, :].flatten(-2)], dim=-1))
        temp_pos = self.ego_pose_pe(temp_pos, mem_motion)
        temp_memory = self.ego_pose_memory(memory.embedding, mem_motion)
        query_pos = query_pos + self.time_embedding(
            pos2posemb1d(torch.zeros_like(reference_points[..., :1]), self.embed_dims))
        temp_pos = temp_pos + self.time_embedding(pos2posemb1d(memory.timestamp, self.embed_dims))
        np_ = self.num_propagated
        tgt = torch.cat([tgt, temp_memory[:, :np_]], dim=1)
        query_pos = torch.cat([query_pos, temp_pos[:, :np_]], dim=1)
        reference_points = torch.cat([reference_points, temp_ref[:, :np_]], dim=1)
        rec_ego_pose = torch.eye(4, device=tgt.device).expand(b, query_pos.shape[1], 4, 4)
        return (tgt, query_pos, reference_points, temp_memory[:, np_:], temp_pos[:, np_:],
                rec_ego_pose)

    def make_queries(self, b: int, dn=None) -> torch.Tensor:
        """The reference points (B, [pad +] Q, 3) in [0, 1]: the DN queries'
        noised centres first (sparse_head.py:439), then the learned ones."""
        ref = self.reference_points.weight[None].expand(b, self.num_query, 3)
        if dn is not None:
            ref = torch.cat([dn.ref, ref], dim=1)
        return ref

    def forward(self, mlvl_feats: Sequence[torch.Tensor], memory: MemoryState,
                data: Dict[str, torch.Tensor], pad_hw: Tuple[int, int],
                dn: Optional[Any] = None):
        """mlvl_feats: per level (B N, C, h, w); data: prev_exists (B,),
        timestamp (B,), ego_pose and ego_pose_inv (B, 4, 4), lidar2img,
        intrinsics and extrinsics (B, N, 4, 4); ``dn`` an optional
        ``denoise.DNPack``. Returns (outs, new_memory), outs with
        ``all_cls_scores`` and ``all_bbox_preds`` of shape (L, B, Q, ...),
        and with ``dn`` also ``dn_cls_scores`` and ``dn_bbox_preds`` (L, B,
        pad, ...). The memory takes no DN row."""
        memory = self.pre_update_memory(memory, data)
        b = data["lidar2img"].shape[0]
        n = data["lidar2img"].shape[1]
        # spatial alignment of the features with the camera parameters
        # (detr3d_transformer.py:140-151)
        intr = data["intrinsics"] / 1e3
        mln_in = torch.cat([intr[..., 0, 0:1], intr[..., 1, 1:2],
                            data["extrinsics"][..., :3, :].flatten(-2)], dim=-1)  # (B, N, 14)
        gamma, beta = self.transformer.spatial_alignment.gamma_beta(mln_in.reshape(b * n, 14))
        feats = [f * gamma[:, :, None, None] + beta[:, :, None, None] for f in mlvl_feats]

        ref = self.make_queries(b, dn)
        query_pos = self.query_embedding(pos2posemb3d(ref))
        tgt, query_pos, ref, temp_memory, temp_pos, rec_ego_pose = self.temporal_alignment(
            query_pos, torch.zeros_like(query_pos), ref, memory)

        cls_list, reg_list = [], []
        query = tgt
        ref_lidar = self._to_range(ref)
        ref_logit = inverse_sigmoid(ref)
        cls_branch, reg_branch = self.cls_branches[0], self.reg_branches[0]
        attn_bias = dn.attn_mask if dn is not None else None
        for layer in self.transformer.decoder.layers:
            query = layer(query, query_pos, temp_memory, temp_pos, feats, ref_lidar,
                          data["lidar2img"], pad_hw, attn_bias)
            reg_out = reg_branch(query)
            xyz = self._to_range(torch.sigmoid(reg_out[..., 0:3] + ref_logit))
            cls_list.append(cls_branch(query))
            reg_list.append(torch.cat([xyz, reg_out[..., 3:]], dim=-1))
        all_cls, all_reg = torch.stack(cls_list), torch.stack(reg_list)
        outs = {}
        pad = dn.pad_size if dn is not None else 0
        if pad:
            outs = {"dn_cls_scores": all_cls[:, :, :pad], "dn_bbox_preds": all_reg[:, :, :pad]}
        outs.update(all_cls_scores=all_cls[:, :, pad:], all_bbox_preds=all_reg[:, :, pad:])
        return outs, self.post_update_memory(memory, data, rec_ego_pose[:, pad:], outs,
                                             query[:, pad:])

    def post_update_memory(self, memory: MemoryState, data, rec_ego_pose, outs,
                           last_query: torch.Tensor) -> MemoryState:
        """Top-k proposal propagation (sparse_head.py:407-436)."""
        all_reg = outs["all_bbox_preds"][-1]
        rec_score = torch.sigmoid(outs["all_cls_scores"][-1]).amax(dim=-1, keepdim=True)
        _, top = topk_stable(rec_score[..., 0], self.topk_proposals)   # (B, k)

        def gather(x):
            idx = top.reshape(top.shape + (1,) * (x.dim() - 2)).expand(
                top.shape + x.shape[2:])
            return torch.gather(x, 1, idx)

        def push(new, old):
            return torch.cat([gather(new), old], dim=1)[:, :self.memory_len]

        embedding = push(last_query, memory.embedding)
        ref = push(all_reg[..., :3], memory.reference_point)
        ts = push(torch.zeros_like(rec_score), memory.timestamp)
        egopose = push(rec_ego_pose, memory.egopose)
        velo = push(all_reg[..., -2:], memory.velo)
        # back to the global frame; timestamps relative to now
        return MemoryState(embedding, transform_reference_points(ref, data["ego_pose"]),
                           ts - data["timestamp"].reshape(-1, 1, 1),
                           torch.einsum("bij,bmjk->bmik", data["ego_pose"], egopose), velo)
