"""The denoising (DN) query branch of SparseHead training.

Counterpart of ``panacea_tpu/perception/denoise.py`` (reference
prepare_for_dn and the dn loss, sparse_head.py:275-355, 438-530; config
scalar 10 noise groups, noise_scale 1.0, split 0.75, dn_weight 1.0): the
ground-truth boxes, noised, become extra queries placed before the match
queries, under an additive mask so that the match queries never see the
DN queries and the DN groups never see each other. As in the JAX package,
the gt list is padded to a fixed ``max_gt``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from panacea_tpu_torch.perception.coder import normalize_bbox
from panacea_tpu_torch.perception.train_losses import (CODE_WEIGHTS, masked_l1, reduced,
                                                       sigmoid_focal_loss)

NEG_INF = -1e9


class DNPack(NamedTuple):
    ref: torch.Tensor          # (B, pad, 3) normalised noised centres
    labels: torch.Tensor       # (B, pad) class, or num_classes (flipped or padding)
    box_targets: torch.Tensor  # (B, pad, 10) normalised gt codes
    valid: torch.Tensor        # (B, pad) 1.0 where a real gt holds the slot
    attn_mask: torch.Tensor    # (pad + Q + P, pad + Q + M) additive mask
    pad_size: int


def build_dn_attn_mask(pad_size: int, num_query: int, num_propagated: int, memory_len: int,
                       scalar: int) -> np.ndarray:
    """(sparse_head.py:322-346): blocked pairs -> -1e9, of shape
    (pad + Q + P, pad + Q + M)."""
    single = pad_size // scalar
    blocked = np.zeros((pad_size + num_query + num_propagated,
                        pad_size + num_query + memory_len), dtype=bool)
    blocked[pad_size:, :pad_size] = True      # match and propagated queries
    for i in range(scalar):                   # the groups among themselves
        lo, hi = single * i, single * (i + 1)
        blocked[lo:hi, :lo] = True
        blocked[lo:hi, hi:pad_size] = True
    return np.where(blocked, NEG_INF, 0.0).astype(np.float32)


def draw_dn_noise(generator: torch.Generator, b: int, pad_size: int) -> torch.Tensor:
    """The centre noise of one step, uniform in [-1, 1), (B, pad, 3), on
    the host."""
    return torch.rand((b, pad_size, 3), generator=generator) * 2.0 - 1.0


def prepare_dn(gt_boxes: torch.Tensor, gt_labels: torch.Tensor, num_query: int,
               num_propagated: int, memory_len: int, pc_range: Sequence[float],
               num_classes: int = 10, scalar: int = 10, noise_scale: float = 1.0,
               split: float = 0.75, generator: Optional[torch.Generator] = None,
               rand_prob: Optional[torch.Tensor] = None) -> DNPack:
    """gt_boxes (B, Gmax, >= 7) zero-padded, gt_labels (B, Gmax) -1-padded.
    ``rand_prob`` (B, Gmax * scalar, 3) in [-1, 1] is the noise; without
    it, it is drawn from ``generator``."""
    b, gmax = gt_labels.shape
    pad_size = gmax * scalar
    dev = gt_boxes.device
    pc = torch.tensor(pc_range, dtype=torch.float32, device=dev)
    if rand_prob is None:
        rand_prob = draw_dn_noise(generator, b, pad_size)
    rand_prob = rand_prob.to(device=dev, dtype=torch.float32)
    valid = (gt_labels >= 0).float()
    boxes_r = gt_boxes.repeat(1, scalar, 1)
    labels_r = gt_labels.repeat(1, scalar)
    valid_r = valid.repeat(1, scalar)
    center = boxes_r[..., 0:3] + rand_prob * (boxes_r[..., 3:6] / 2.0) * noise_scale
    center = ((center - pc[0:3]) / (pc[3:6] - pc[0:3])).clamp(0.0, 1.0)
    # heavily noised copies become negatives (the label flipped to background)
    flip = torch.linalg.vector_norm(rand_prob, dim=-1) > split
    labels_out = torch.where(flip, torch.full_like(labels_r, num_classes), labels_r)
    labels_out = torch.where(valid_r > 0, labels_out, torch.full_like(labels_r, num_classes))
    gt9 = boxes_r[..., :9]
    if gt9.shape[-1] < 9:
        gt9 = torch.cat([gt9, gt9.new_zeros(gt9.shape[:-1] + (9 - gt9.shape[-1],))], dim=-1)
    gt9 = torch.cat([gt9[..., :3], gt9[..., 3:6].clamp(min=1e-3), gt9[..., 6:]], dim=-1)
    mask = torch.from_numpy(build_dn_attn_mask(pad_size, num_query, num_propagated,
                                               memory_len, scalar)).to(dev)
    return DNPack(center, labels_out, normalize_bbox(gt9), valid_r, mask, pad_size)


def dn_loss(outs_dn_cls: torch.Tensor, outs_dn_reg: torch.Tensor, pack: DNPack, pc_range=None,
            num_classes: int = 10, dn_weight: float = 1.0, split: float = 0.75,
            cls_weight: float = 2.0, bbox_weight: float = 0.25,
            reduce_fn: Optional[Callable] = None) -> torch.Tensor:
    """Focal and code-weighted L1 on the DN slice (dn_loss_single,
    sparse_head.py:710-766), summed over the decoder layers; outs_dn_* are
    (L, B, pad, ...). The class normaliser is num_tgt * pi / 6 * split^3
    (the expected positive rate of the flip ball); the box loss covers
    every known row, flipped negatives included, a row whose target is
    not finite dropped whole, over num_tgt. ``reduce_fn`` averages num_tgt
    over the ranks (mmdet ``reduce_mean``, :730-737; JAX ``dn_loss``, :132)."""
    num_tgt = reduced(reduce_fn, pack.valid.sum()).clamp(min=1.0)
    cls_af = (num_tgt * 3.14159 / 6 * split ** 3).clamp(min=1.0)
    row_ok = pack.valid * torch.isfinite(pack.box_targets).all(-1)
    total = 0.0
    for li in range(outs_dn_cls.shape[0]):
        cls_l = (sigmoid_focal_loss(outs_dn_cls[li], pack.labels, num_classes)
                 * pack.valid.clamp(min=0.0)).sum() / cls_af
        diff = masked_l1(outs_dn_reg[li], pack.box_targets, CODE_WEIGHTS)
        box_l = (diff.sum(-1) * row_ok).sum() / num_tgt
        total = total + cls_weight * cls_l + bbox_weight * box_l
    return dn_weight * total
