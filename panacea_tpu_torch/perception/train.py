"""StreamPETR detector training: the loss and the train step of the recipes.

Counterpart of ``panacea_tpu/perception/train.py`` (``make_detector_train``,
:215; reference streampetr_r50_atss_512x256_window.py:36-276 and the mmdet
runner): GridMask on the input images, the history frames without
gradients, the head (SparseHead or a dense PETR head) with its denoising
(DN) queries, Hungarian matching run per decoder layer with the layer
losses summed, with the motion head the trajectory loss on the matched
queries, and the ATSS 2D auxiliary head on the last frame's FPN features.
AdamW with the backbone (ResNet-50 or VoVNet) at 0.1 times the learning
rate, its stem and first stage frozen,
the gradients clipped at a global norm of 35, and a cosine schedule after
a linear warmup.

The Hungarian assignment runs on the host (scipy) on the detached
predictions of every layer, one transfer a step, between the forward and
the loss, as in the reference; the ATSS targets depend only on the
anchors and the 2D ground truth and are made on the host per batch.

Under a process group (data parallelism, JAX ``make_detector_train`` with
a ``mesh``) each rank computes the loss of its own batch, with the avg
factors of four terms (the detection layers' matched count, the DN
targets, ATSS's positive count and total centerness) averaged over the
ranks before the division (mmdet's ``reduce_mean``, the ``reduce_fn``
hook), so that the gradients averaged over the ranks are the global
batch's ratio of sums; the logged metrics are averaged too. One
difference from the JAX package is kept: JAX clips by the global norm of
every gradient, those of the frozen stages and of the batch-norm
statistics (flax parameters there) included; the port clips the trained
parameters' gradients only, as the reference's mmcv ``OptimizerHook``
does. The two agree whenever the clip is not engaged.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from panacea_tpu_torch.models.engine import no_tf32
from panacea_tpu_torch.parallel.train import allreduce_mean, mean_metrics, reduce_mean
from panacea_tpu_torch.perception.atss import (atss_assign, centerness_target, delta_decode,
                                               giou_loss)
from panacea_tpu_torch.perception.coder import normalize_bbox
from panacea_tpu_torch.perception.denoise import DNPack, draw_dn_noise, dn_loss, prepare_dn
from panacea_tpu_torch.perception.gridmask import GridDraws, draw_grid, grid_mask
from panacea_tpu_torch.perception.head import MemoryState
from panacea_tpu_torch.perception.motion_head import traj_loss_v1, traj_targets_from_assignment
from panacea_tpu_torch.perception.train_losses import (CODE_WEIGHTS, masked_l1, reduced,
                                                       sigmoid_focal_loss)
from panacea_tpu_torch.utils.optim import AdamW

# --------------------------------------------------------------------------
# the batched Hungarian assignment, on the host
# --------------------------------------------------------------------------


def _focal_cost_np(logits: np.ndarray, gt_labels: np.ndarray, gamma: float = 2.0,
                   alpha: float = 0.25, eps: float = 1e-12) -> np.ndarray:
    """mmdet FocalLossCost (the NumPy twin of train_losses.focal_cls_cost)."""
    p = 1.0 / (1.0 + np.exp(-logits))
    neg = (1 - alpha) * p ** gamma * -np.log(1 - p + eps)
    pos = alpha * (1 - p) ** gamma * -np.log(p + eps)
    return (pos - neg)[:, gt_labels]


def _bbox_cost_np(bbox_preds: np.ndarray, gt_norm: np.ndarray,
                  match_costs: np.ndarray) -> np.ndarray:
    """mmdet BBox3DL1Cost under HungarianAssigner3D's code-weight scaling
    (hungarian_assigner_3d.py:59-67), the first 8 dims (with_velo False)."""
    p = bbox_preds[..., :8] * match_costs[:8]
    g = gt_norm[..., :8] * match_costs[:8]
    return np.abs(p[:, None] - g[None, :]).sum(-1)


def hungarian_match(cls_logits: np.ndarray, bbox_preds: np.ndarray, gt_norm: np.ndarray,
                    gt_labels: np.ndarray, cls_weight: float, bbox_weight: float):
    """One image's matching (HungarianAssigner3D): the focal classification
    cost and the code-weighted L1 of the first 8 box dims, cls_logits (Q, C),
    bbox_preds (Q, 10), gt_norm (G, 10), gt_labels (G,). Returns (rows,
    cols) of ``linear_sum_assignment``."""
    from scipy.optimize import linear_sum_assignment

    mc = np.asarray(CODE_WEIGHTS, np.float32)
    cost = (cls_weight * _focal_cost_np(cls_logits, gt_labels)
            + bbox_weight * _bbox_cost_np(bbox_preds, np.nan_to_num(gt_norm), mc))
    return linear_sum_assignment(np.nan_to_num(cost))


def make_batched_assigner(pc_range, num_classes: int, cls_weight: float, bbox_weight: float):
    """The host function (cls (N, Q, C), bbox (N, Q, 10), gt_norm (N, G, 10),
    gt_labels (N, G) -1-padded) -> per-query targets (labels_q (N, Q) int32,
    gt_norm_q (N, Q, 10), mask_q (N, Q), asg_q (N, Q) the matched gt's index
    in G, num_pos)."""

    def assign(cls_logits, bbox_preds, gt_norm, gt_labels):
        cls_logits = np.asarray(cls_logits, np.float32)
        bbox_preds = np.asarray(bbox_preds, np.float32)
        gt_norm = np.asarray(gt_norm, np.float32)
        gt_labels = np.asarray(gt_labels)
        n, q = cls_logits.shape[:2]
        labels_q = np.full((n, q), num_classes, np.int32)
        gt_norm_q = np.zeros((n, q, gt_norm.shape[-1]), np.float32)
        mask_q = np.zeros((n, q), np.float32)
        asg_q = np.zeros((n, q), np.int32)
        total = 0.0
        for bi in range(n):
            valid = gt_labels[bi] >= 0
            g = int(valid.sum())
            if g == 0:
                continue
            orig_idx = np.nonzero(valid)[0]
            gl = gt_labels[bi][valid].astype(np.int64)
            gn = gt_norm[bi][valid]
            rows, cols = hungarian_match(cls_logits[bi], bbox_preds[bi], gn, gl, cls_weight,
                                         bbox_weight)
            labels_q[bi, rows] = gl[cols]
            gt_norm_q[bi, rows] = gn[cols]
            mask_q[bi, rows] = 1.0
            asg_q[bi, rows] = orig_idx[cols].astype(np.int32)
            total += g
        return labels_q, gt_norm_q, mask_q, asg_q, np.float32(total)

    return assign


class HungarianTargets(NamedTuple):
    """Per decoder layer, sample and query: (L, B, Q) NumPy arrays."""
    labels: np.ndarray    # int32, num_classes where unmatched
    gt_norm: np.ndarray   # (L, B, Q, 10) the matched gt's code, 0 where unmatched
    mask: np.ndarray      # 1.0 where matched
    assigned: np.ndarray  # int32, the matched gt's index in G, 0 where unmatched


def hungarian_targets(assign, cls_all: torch.Tensor, bbox_all: torch.Tensor,
                      gt_norm: torch.Tensor, gt_labels: torch.Tensor) -> HungarianTargets:
    """Every layer's matching in one host call: the L layers folded into the
    batch (cls_all (L, B, Q, C), bbox_all (L, B, Q, 10), gt_norm (B, G, 10),
    gt_labels (B, G))."""
    n_layers, b, q = cls_all.shape[:3]
    g = gt_norm.shape[1]
    host = [t.detach().float().cpu().numpy() for t in (cls_all, bbox_all, gt_norm)]
    labels = gt_labels.detach().cpu().numpy()
    labels_q, gt_norm_q, mask_q, asg_q, _ = assign(
        host[0].reshape(n_layers * b, q, -1), host[1].reshape(n_layers * b, q, -1),
        np.broadcast_to(host[2][None], (n_layers, b, g, host[2].shape[-1])).reshape(
            n_layers * b, g, -1),
        np.broadcast_to(labels[None], (n_layers, b, g)).reshape(n_layers * b, g))
    return HungarianTargets(labels_q.reshape(n_layers, b, q),
                            gt_norm_q.reshape(n_layers, b, q, -1), mask_q.reshape(n_layers, b, q),
                            asg_q.reshape(n_layers, b, q))


def detection_layer_losses(cls_all: torch.Tensor, bbox_all: torch.Tensor,
                           labels: torch.Tensor, gt_norm_q: torch.Tensor, mask_q: torch.Tensor,
                           num_classes: int = 10, bg_cls_weight: float = 0.0,
                           reduce_fn: Optional[Callable] = None):
    """Each layer's focal sum over max(num_pos + bg_cls_weight num_neg, 1)
    and code-weighted L1 (an element whose target is not finite left out)
    over max(num_pos, 1), unweighted: two (L,) tensors. labels (L, B, Q),
    gt_norm_q (L, B, Q, 10), mask_q (L, B, Q) 1 where matched. ``reduce_fn``
    averages both avg factors over the ranks (JAX ``loss_fn``, :352)."""
    n_pos = mask_q.sum((1, 2))                                      # (L,)
    n_neg = mask_q[0].numel() - n_pos
    cls_af = reduced(reduce_fn, n_pos + bg_cls_weight * n_neg if bg_cls_weight else n_pos)
    n_pos = reduced(reduce_fn, n_pos) if bg_cls_weight else cls_af
    cls_l = sigmoid_focal_loss(cls_all, labels, num_classes).sum((1, 2)) / cls_af.clamp(min=1.0)
    diff = masked_l1(bbox_all[..., :10], gt_norm_q, CODE_WEIGHTS)
    return cls_l, (diff.sum(-1) * mask_q).sum((1, 2)) / n_pos.clamp(min=1.0)


def detection_loss(cls_all: torch.Tensor, bbox_all: torch.Tensor, tgt: HungarianTargets,
                   num_classes: int = 10, cls_weight: float = 2.0,
                   bbox_weight: float = 0.25,
                   reduce_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Per layer focal and code-weighted L1 over the matched count, summed
    over the layers (the mmdet loss dict: loss_cls + d0..d(L-2).loss_cls)."""
    dev = cls_all.device
    cls_l, bbox_l = detection_layer_losses(
        cls_all, bbox_all, torch.as_tensor(tgt.labels, dtype=torch.long, device=dev),
        torch.as_tensor(tgt.gt_norm, device=dev), torch.as_tensor(tgt.mask, device=dev),
        num_classes, reduce_fn=reduce_fn)
    return {"loss_cls": cls_weight * cls_l.sum(), "loss_bbox": bbox_weight * bbox_l.sum()}


def trajectory_loss(traj_all: torch.Tensor, score_all: torch.Tensor, tgt: HungarianTargets,
                    gt_trajs: torch.Tensor, gt_traj_mask: torch.Tensor,
                    reduce_fn: Optional[Callable] = None) -> torch.Tensor:
    """The motion head's term (petr_motion_head.py loss: loss_traj and
    d{i}.loss_traj summed; JAX ``loss_fn``, :367-398): each layer's matched
    ground-truth futures broadcast over the modes, the layers folded into
    the batch of one ``traj_loss_v1``, whose avg factor is the matched
    count averaged over the layers. traj_all (L, B, Q, M, S, 2), score_all
    (L, B, Q, M), gt_trajs and gt_traj_mask (B, G, S, 2)."""
    n_layers, b, q, m, s = traj_all.shape[:5]
    dev = traj_all.device
    mask_q = torch.as_tensor(tgt.mask, device=dev)
    assigned = torch.as_tensor(tgt.assigned, device=dev)
    n_pos = reduced(reduce_fn, mask_q.sum((1, 2))).clamp(min=1.0)
    targets, weights = [], []
    for li in range(n_layers):
        for bi in range(b):
            t, w = traj_targets_from_assignment((q, m, s, 2), mask_q[li, bi] > 0,
                                                assigned[li, bi], gt_trajs[bi], gt_traj_mask[bi])
            targets.append(t)
            weights.append(w)
    lb = n_layers * b
    return traj_loss_v1(score_all.reshape(lb, q, m), traj_all.reshape(lb, q, m, s, 2),
                        torch.stack(targets).reshape(lb * q, m, s, 2),
                        torch.stack(weights).reshape(lb * q, m, s, 2), avg_factor=n_pos.mean())


# --------------------------------------------------------------------------
# the ATSS 2D auxiliary targets (host) and loss
# --------------------------------------------------------------------------


class ATSSTargets(NamedTuple):
    labels: torch.Tensor       # (BN, A) long, num_classes = background
    gt_xyxy: torch.Tensor      # (BN, A, 4) the matched gt box per anchor
    centerness: torch.Tensor   # (BN, A)
    num_pos: float

    def to(self, device) -> "ATSSTargets":
        return ATSSTargets(self.labels.to(device), self.gt_xyxy.to(device),
                           self.centerness.to(device), self.num_pos)


def atss_targets(anchors_per_level: List[np.ndarray], gt2d_boxes: Sequence[np.ndarray],
                 gt2d_labels: Sequence[np.ndarray], num_classes: int = 10,
                 topk: int = 9) -> ATSSTargets:
    """Assignment and targets for a batch of images, per image (Gi, 4) xyxy
    boxes and (Gi,) labels (ATSSAssigner topk 9 and get_targets,
    window.py:92-95), on the CPU."""
    anchors = np.concatenate(anchors_per_level, axis=0)
    a, bn = len(anchors), len(gt2d_boxes)
    labels = np.full((bn, a), num_classes, np.int64)
    gt_xyxy = np.zeros((bn, a, 4), np.float32)
    ctr = np.zeros((bn, a), np.float32)
    total = 0.0
    for i in range(bn):
        boxes, lbls = np.asarray(gt2d_boxes[i]), np.asarray(gt2d_labels[i])
        if len(boxes) == 0:
            continue
        assigned = atss_assign(anchors_per_level, boxes, topk=topk)
        pos = assigned >= 0
        labels[i, pos] = lbls[assigned[pos]]
        gt_xyxy[i, pos] = boxes[assigned[pos]]
        ctr[i, pos] = centerness_target(anchors[pos], boxes[assigned[pos]])
        total += float(pos.sum())
    return ATSSTargets(torch.from_numpy(labels), torch.from_numpy(gt_xyxy),
                       torch.from_numpy(ctr), total)


def atss_loss(atss_outs, anchors_per_level: List[np.ndarray], tgt: ATSSTargets,
              num_classes: int = 10, cls_weight: float = 1.0, bbox_weight: float = 2.0,
              ctr_weight: float = 1.0,
              reduce_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Focal classification, centerness-weighted GIoU and centerness BCE
    (ATSSTaskHead's losses, window.py:79-95). ``atss_outs``: per level
    (cls (BN, C, h, w), deltas (BN, 4, h, w), centerness (BN, 1, h, w)),
    flattened in (h, w) order as the anchors are. ``reduce_fn`` averages
    the positive count and the total centerness over the ranks (mmdet
    atss_head.py:310-328; JAX ``atss_loss``, :186 and :199)."""
    def flat(x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])

    cls = torch.cat([flat(o[0]) for o in atss_outs], 1)
    reg = torch.cat([flat(o[1]) for o in atss_outs], 1)
    ctr = torch.cat([flat(o[2]) for o in atss_outs], 1)[..., 0]
    dev = cls.device
    anchors = torch.as_tensor(np.concatenate(anchors_per_level, 0), dtype=torch.float32,
                              device=dev)
    n_pos = reduced(reduce_fn, torch.tensor(float(tgt.num_pos), device=dev)).clamp(min=1.0)
    cls_l = sigmoid_focal_loss(cls, tgt.labels, num_classes).sum() / n_pos
    pos = (tgt.labels < num_classes).float()
    bn, a = pos.shape
    decoded = delta_decode(anchors.expand(bn, a, 4).reshape(-1, 4), reg.reshape(-1, 4))
    giou = giou_loss(decoded, tgt.gt_xyxy.reshape(-1, 4)).reshape(bn, a)
    w = tgt.centerness * pos
    bbox_l = (giou * w).sum() / reduced(reduce_fn, w.sum()).clamp(min=1e-6)
    ctr_bce = F.binary_cross_entropy_with_logits(ctr, tgt.centerness, reduction="none")
    ctr_l = (ctr_bce * pos).sum() / n_pos
    return {"loss_atss_cls": cls_weight * cls_l, "loss_atss_bbox": bbox_weight * bbox_l,
            "loss_atss_ctr": ctr_weight * ctr_l}


# --------------------------------------------------------------------------
# the optimizer and the schedule
# --------------------------------------------------------------------------


def _is_backbone_bn(sub: Sequence[str]) -> bool:
    """mmdet's backbone norm layers: ResNet's bn1..bn3 and downsample.1,
    VoVNet's ``{name}/norm``."""
    return any(p.startswith("bn") or p.endswith("/norm")
               or (p == "1" and i > 0 and sub[i - 1] == "downsample")
               for i, p in enumerate(sub))


def backbone_frozen(name: str, frozen_stages: int = -1, bn_trainable: bool = True) -> bool:
    """Whether the parameter ``name`` is frozen: mmdet's ``_freeze_stages``
    (``frozen_stages`` 0 the stem: ResNet's conv1 and bn1, VoVNet's
    ``stem``; s also ResNet's layer1..layer{s} or VoVNet's
    stage2..stage{s+1}) and, with ``bn_trainable`` False, every backbone
    norm's affine (norm_cfg requires_grad False). The JAX package's mask
    (JAX ``make_detector_optimizer``, :536-548) in the port's names."""
    parts = name.split(".")
    if parts[0] != "img_backbone":
        return False
    sub = parts[1:-1]
    first = sub[0] if sub else parts[-1]
    if frozen_stages >= 0 and first in ("conv1", "bn1", "stem"):
        return True
    if any(first in (f"layer{s}", f"stage{s + 1}") for s in range(1, frozen_stages + 1)):
        return True
    return not bn_trainable and _is_backbone_bn(sub)


class DetectorOptimizer:
    """The counterpart of JAX ``make_detector_optimizer`` (:514; lr 4e-4, wd
    0.01, backbone lr_mult 0.1, grad clip 35, window.py:253-266): AdamW
    over the trained parameters (the port's ``utils.optim.AdamW``):
    the backbone's at ``backbone_lr_mult`` times the learning rate, one clip
    of the global norm of the trained gradients, the decay decoupled and
    scaled with the learning rate (optax's ``add_decayed_weights`` before
    the lr). The frozen parameters get ``requires_grad`` False: no
    gradient, no update, no decay. Batch-norm statistics are buffers and
    never change."""

    def __init__(self, named_params: Mapping[str, torch.Tensor], lr: float = 4e-4,
                 weight_decay: float = 0.01, backbone_lr_mult: float = 0.1,
                 grad_clip_norm: float = 35.0, schedule: Optional[Callable[[int], float]] = None,
                 backbone_frozen_stages: int = -1, backbone_bn_trainable: bool = True):
        self.frozen = [n for n in named_params
                       if backbone_frozen(n, backbone_frozen_stages, backbone_bn_trainable)]
        for n in self.frozen:
            named_params[n].requires_grad_(False)
        self.params = {n: p for n, p in named_params.items() if p.requires_grad}
        mults = {n: backbone_lr_mult for n in self.params if n.startswith("img_backbone.")}
        # the schedule gives the learning rate itself, as optax's
        # scale_by_schedule takes it
        self.adamw = AdamW(self.params, lr=1.0 if schedule is not None else lr,
                           weight_decay=weight_decay, grad_clip=grad_clip_norm,
                           lr_schedule=schedule, lr_mults=mults)

    def step(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        return self.adamw.step(self.params, grads)

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: Mapping) -> None:
        self.adamw.load_state_dict(state)


def cosine_schedule(base_lr: float = 4e-4, warmup_iters: int = 500,
                    warmup_ratio: float = 1.0 / 3, total_iters: int = 42192,
                    min_lr_ratio: float = 1e-3) -> Callable[[int], float]:
    """CosineAnnealing after a linear warmup (window.py:268-274), step ->
    learning rate, as optax's join of ``linear_schedule`` and
    ``cosine_decay_schedule`` (JAX ``cosine_schedule``, :621)."""
    warm_steps = max(warmup_iters, 1)
    decay_steps = max(total_iters - warmup_iters, 1)
    init = base_lr * warmup_ratio

    def schedule(count: int) -> float:
        if count < warmup_iters:
            frac = 1.0 - min(max(count, 0), warm_steps) / warm_steps
            return (init - base_lr) * frac + base_lr
        c = min(count - warmup_iters, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1.0 - min_lr_ratio) * cos + min_lr_ratio)

    return schedule


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


class DetTrainState:
    """The model (its parameters), the optimizer and the step count."""

    def __init__(self, model, optimizer: DetectorOptimizer, step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.optimizer.params


class StepDraws(NamedTuple):
    """The random draws of one step: GridMask's, and the DN centre noise
    (B, max_gt * dn_scalar, 3) in [-1, 1]."""
    grid: Optional[GridDraws]
    dn_noise: Optional[torch.Tensor]


class StepOut(NamedTuple):
    metrics: Dict[str, float]
    memory: Optional[MemoryState]    # the streaming recipes' memory, detached


class DetectorTrainer:
    """One training step of the recipe: draws, forward, loss, backward,
    optimizer. The counterpart of JAX ``make_detector_train`` (:215) and
    its train step.

    ``streaming``: the seq_mode recipes, one frame a step with the memory
    threaded across steps (``train_frame``); otherwise a window a step
    (``train_window``). Under a process group the loss averages its avg
    factors over the ranks (``reduce_mean``), the gradients are averaged
    over the ranks before the optimizer and the metrics are the ranks' mean
    (JAX ``make_detector_train`` with a ``mesh``); without one each of
    these is the identity."""

    def __init__(self, pc_range, num_classes: int = 10, cls_weight: float = 2.0,
                 bbox_weight: float = 0.25, use_grid_mask: bool = True, with_dn: bool = True,
                 dn_scalar: int = 10, dn_noise_scale: float = 1.0, dn_split: float = 0.75,
                 dn_weight: float = 1.0, anchors_per_level: Optional[List[np.ndarray]] = None,
                 num_frame_losses: int = 1, streaming: bool = False):
        self.pc_range = tuple(pc_range)
        self.num_classes, self.cls_weight, self.bbox_weight = num_classes, cls_weight, bbox_weight
        self.use_grid_mask, self.with_dn = use_grid_mask, with_dn
        self.dn_scalar, self.dn_noise_scale = dn_scalar, dn_noise_scale
        self.dn_split, self.dn_weight = dn_split, dn_weight
        self.anchors_per_level = anchors_per_level
        self.num_frame_losses, self.streaming = num_frame_losses, streaming
        self.assign = make_batched_assigner(pc_range, num_classes, cls_weight, bbox_weight)

    def draw(self, generator: torch.Generator, img_h: int, b: int, max_gt: int) -> StepDraws:
        """GridMask's draws, then the DN noise, from ``generator`` (on the
        host, so the CPU and the card see the same numbers)."""
        grid = draw_grid(generator, img_h) if self.use_grid_mask else None
        noise = (draw_dn_noise(generator, b, max_gt * self.dn_scalar) if self.with_dn
                 else None)
        return StepDraws(grid, noise)

    def forward(self, model, imgs: torch.Tensor, data: Dict[str, torch.Tensor],
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor, draws: StepDraws,
                memory: Optional[MemoryState] = None):
        """(outs, atss_outs, new_memory, dn) of the recipe's forward."""
        if self.use_grid_mask:
            imgs = grid_mask(imgs, draws=draws.grid)
        dn = None
        if self.with_dn:
            # a head without the streaming memory (PETRHeadDN) self-attends
            # over its current queries alone: the reference's mask there is
            # (pad + Q) square (petr_head_dn.py prepare_for_dn)
            memory_free = not model.pts_bbox_head._uses_memory()
            # the proposal-query heads make one query a proposal (v3) or at
            # least num_query (v4): the mask takes that count (JAX
            # train.py:288-299; the reference sets num_query to the
            # proposal count, sparse_head_v3.py:375)
            num_query = model.num_query
            proposals = data.get("proposal_positions")
            if proposals is not None and hasattr(model.pts_bbox_head, "query_count"):
                num_query = model.pts_bbox_head.query_count(proposals.shape[-2])
            dn = prepare_dn(gt_boxes, gt_labels, num_query=num_query,
                            num_propagated=0 if memory_free else model.num_propagated,
                            memory_len=0 if memory_free else model.memory_len,
                            pc_range=self.pc_range, num_classes=self.num_classes,
                            scalar=self.dn_scalar, noise_scale=self.dn_noise_scale,
                            split=self.dn_split, rand_prob=draws.dn_noise)
        if self.streaming:
            outs, atss_outs, new_memory = model.train_frame(imgs, memory, data, dn=dn)
        else:
            outs, atss_outs, new_memory = model.train_window(
                imgs, data, dn=dn, num_frame_losses=self.num_frame_losses)
        return outs, atss_outs, new_memory, dn

    def loss(self, outs: Dict[str, torch.Tensor], atss_outs, dn: Optional[DNPack],
             gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
             atss_tgt: Optional[ATSSTargets] = None,
             assignment: Optional[HungarianTargets] = None,
             gt_trajs: Optional[torch.Tensor] = None,
             gt_traj_mask: Optional[torch.Tensor] = None):
        """(total, metrics, assignment): the Hungarian matching of every
        layer on the host (or ``assignment`` as given), the layer losses,
        the trajectory loss where the head gives ``all_traj_preds`` and
        ``gt_trajs`` is given, the DN loss and the ATSS losses (JAX
        ``loss_fn``, :267-419)."""
        cls_all, bbox_all = outs["all_cls_scores"], outs["all_bbox_preds"]
        if assignment is None:
            assignment = hungarian_targets(self.assign, cls_all, bbox_all,
                                           normalize_bbox(gt_boxes), gt_labels)
        metrics = detection_loss(cls_all, bbox_all, assignment, self.num_classes,
                                 self.cls_weight, self.bbox_weight, reduce_fn=reduce_mean)
        if "all_traj_preds" in outs and gt_trajs is not None:
            metrics["loss_traj"] = trajectory_loss(
                outs["all_traj_preds"], outs["all_traj_scores"], assignment,
                gt_trajs.to(cls_all.device, torch.float32),
                gt_traj_mask.to(cls_all.device, torch.float32), reduce_fn=reduce_mean)
        if self.with_dn:
            metrics["loss_dn"] = dn_loss(outs["dn_cls_scores"], outs["dn_bbox_preds"], dn,
                                         self.pc_range, self.num_classes,
                                         dn_weight=self.dn_weight, split=self.dn_split,
                                         reduce_fn=reduce_mean)
        if atss_tgt is not None and atss_outs is not None:
            metrics.update(atss_loss(atss_outs, self.anchors_per_level,
                                     atss_tgt.to(cls_all.device), self.num_classes,
                                     reduce_fn=reduce_mean))
        total = sum(metrics.values())
        metrics["loss"] = total
        return total, metrics, assignment

    def backward(self, state: DetTrainState, total: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The trained parameters' gradients of ``total`` (zeros where a
        parameter took no part), with TF32 off as in the forward."""
        for p in state.params.values():
            p.grad = None
        with no_tf32():
            total.backward()
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in state.params.items()}

    def step(self, state: DetTrainState, imgs: torch.Tensor, data: Dict[str, torch.Tensor],
             gt_boxes: torch.Tensor, gt_labels: torch.Tensor, atss_tgt: Optional[ATSSTargets],
             gt_trajs: Optional[torch.Tensor] = None, gt_traj_mask: Optional[torch.Tensor] = None,
             *, generator: torch.Generator, memory: Optional[MemoryState] = None) -> StepOut:
        """One optimizer step. imgs (B, T, N, H, W, 3) normalised and data
        with leading (B, T), or in the streaming recipes one frame, (B, N,
        H, W, 3) and (B, ...), with ``memory``. gt_boxes (B, G, 9)
        zero-padded, gt_labels (B, G) -1-padded; with the motion head
        gt_trajs and gt_traj_mask (B, G, S, 2). The draws come from
        ``generator``."""
        draws = self.draw(generator, imgs.shape[-3], gt_labels.shape[0], gt_labels.shape[1])
        outs, atss_outs, new_memory, dn = self.forward(state.model, imgs, data, gt_boxes,
                                                       gt_labels, draws, memory)
        total, metrics, _ = self.loss(outs, atss_outs, dn, gt_boxes, gt_labels, atss_tgt,
                                      gt_trajs=gt_trajs, gt_traj_mask=gt_traj_mask)
        grads = self.backward(state, total)
        grads = dict(zip(grads, allreduce_mean(list(grads.values()))))
        state.optimizer.step(grads)
        state.step += 1
        if new_memory is not None:
            new_memory = MemoryState(*(m.detach() for m in new_memory))
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        return StepOut(mean_metrics(metrics), new_memory)
