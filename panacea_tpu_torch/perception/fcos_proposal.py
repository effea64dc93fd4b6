"""FCOSMono3D proposal head: SimMOD's first stage (NCHW).

Counterpart of ``panacea_tpu/perception/fcos_proposal.py`` (reference
fcos_proposal_head.py:33-1590): FCOS towers shared over the FPN levels
(stacked conv + GroupNorm + ReLU), per-task regression branches (offset,
depth, size, rot, velo) with per-level learned ``offset`` and ``depth``
scales, a direction classifier, centerness on the regression tower, and
the proposal generator (:453-700): objectness = the largest class sigmoid
times the centerness sigmoid, a 3 x 3 local-maximum pool, per-token 2.5D
centres (the grid minus offset x stride) lifted through inv(K) and
cam2lidar, features = concat(cls tower, reg tower), one global top-k.

The top-k runs over many exact ties (the pool zeroes every score that is
not a local maximum), so it is ``topk_stable``, lowest index first, as
``jax.lax.top_k`` orders them. The proposals are ordered levels within a
camera, then cameras, as the JAX package flattens them.

Keys are the reference's (``cls_convs.{i}.conv`` / ``.gn``,
``conv_cls_prev``, ``conv_centerness_prev``, ``conv_reg_prevs.{key}``,
``conv_regs.{key}``, ``conv_dir_cls_prev``, ``conv_cls``,
``conv_centerness``, ``conv_dir_cls``, ``scales.{l}.{offset,depth}.scale``),
the names of ``panacea_tpu/utils/convert.py:1321-1387``. Targets are NumPy
on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.atss import CLS_BIAS, Scale
from panacea_tpu_torch.perception.head import topk_stable
from panacea_tpu_torch.perception.train_losses import sigmoid_focal_loss

REG_DIMS = {"offset": 2, "depth": 1, "size": 3, "rot": 1, "velo": 2, "bbox2d": 4}


class ConvGN(nn.Module):
    """mmcv ConvModule with GroupNorm and ReLU: 3 x 3 conv without bias
    (``.conv``), ``.gn`` of 32 groups (or one per channel below 32)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.gn = nn.GroupNorm(32 if out_ch % 32 == 0 else out_ch, out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


def _branch(in_ch: int, widths: Sequence[int]) -> nn.Sequential:
    """_init_branch (:348-376): a ConvGN stack with one width per layer."""
    layers = []
    for w in widths:
        layers.append(ConvGN(in_ch, w))
        in_ch = w
    return nn.Sequential(*layers)


class FCOSProposalHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, strides: Sequence[int] = (8, 16, 32, 64),
                 cls_branch: Sequence[int] = (128, 64), centerness_branch: Sequence[int] = (64,),
                 reg_keys: Sequence[str] = ("offset", "depth", "size", "rot", "velo"),
                 reg_branch: Sequence[Sequence[int]] = ((128, 64), (128, 64), (64,), (64,), ()),
                 dir_branch: Sequence[int] = (64,), reg_dims: Optional[Dict[str, int]] = None,
                 num_proposal: int = 600, objectness_with_centerness: bool = True,
                 objectness_max_pooling: bool = True, use_direction_classifier: bool = True):
        super().__init__()
        self.num_classes, self.strides, self.num_proposal = num_classes, tuple(strides), num_proposal
        self.reg_keys = tuple(reg_keys)
        self.objectness_with_centerness = objectness_with_centerness
        self.objectness_max_pooling = objectness_max_pooling
        self.use_direction_classifier = use_direction_classifier
        fc = feat_channels
        self.cls_convs = _branch(in_channels, (fc,) * stacked_convs)
        self.reg_convs = _branch(in_channels, (fc,) * stacked_convs)
        self.conv_cls_prev = _branch(fc, cls_branch)
        self.conv_centerness_prev = _branch(fc, centerness_branch)
        self.conv_cls = nn.Conv2d(cls_branch[-1] if cls_branch else fc, num_classes, 1)
        self.conv_centerness = nn.Conv2d(centerness_branch[-1] if centerness_branch else fc, 1, 1)
        dims = dict(REG_DIMS, **(reg_dims or {}))
        # velo has no prev branch: its conv reads the regression tower
        self.conv_reg_prevs = nn.ModuleDict(
            {k: _branch(fc, br) for k, br in zip(self.reg_keys, reg_branch) if len(br)})
        self.conv_regs = nn.ModuleDict(
            {k: nn.Conv2d(br[-1] if len(br) else fc, dims[k], 1)
             for k, br in zip(self.reg_keys, reg_branch)})
        self.conv_dir_cls_prev = _branch(fc, dir_branch)
        self.conv_dir_cls = nn.Conv2d(dir_branch[-1] if dir_branch else fc, 2, 1)
        self.scales = nn.ModuleList(nn.ModuleDict({"offset": Scale(), "depth": Scale()})
                                    for _ in self.strides)
        nn.init.constant_(self.conv_cls.bias, CLS_BIAS)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        """feats per level (M, C, H, W), M = B N cameras. Returns the
        reference's outs dict per level (:465-540), NCHW."""
        outs = []
        for li, x in enumerate(feats):
            cf, rf = self.cls_convs(x), self.reg_convs(x)
            res = {"cls_feat": cf, "reg_feat": rf,
                   "cls_score": self.conv_cls(self.conv_cls_prev(cf)),
                   "centerness": self.conv_centerness(self.conv_centerness_prev(rf))}
            for k in self.reg_keys:
                prev = self.conv_reg_prevs[k] if k in self.conv_reg_prevs else None
                v = self.conv_regs[k](prev(rf) if prev is not None else rf)
                if k == "offset":
                    v = self.scales[li]["offset"](v)
                elif k == "depth":
                    v = torch.exp(self.scales[li]["depth"](v))   # positive_reg_keys
                elif k == "size":
                    v = torch.exp(v)
                res[k] = v
            if self.use_direction_classifier:
                res["dir_cls"] = self.conv_dir_cls(self.conv_dir_cls_prev(rf))
            outs.append(res)
        return outs

    def get_proposals(self, outs: List[Dict[str, torch.Tensor]], data: Dict[str, torch.Tensor],
                      num_cams: int) -> Dict[str, torch.Tensor]:
        """(:453-700) -> proposal_features (B, K, 2C), proposal_positions
        (B, K, 5) [lidar xyz, view, level], proposal_scores (B, K), and
        proposal_indices (B, K), each proposal's token among the sample's
        N sum(HW) (the JAX package does not return them).
        ``data``: intrinsics and extrinsics (lidar2cam), (B, N, 4, 4)."""
        n = num_cams
        m = outs[0]["cls_score"].shape[0]
        b = m // n
        inv_k = torch.linalg.inv(data["intrinsics"].reshape(m, 4, 4))
        c2l = torch.linalg.inv(data["extrinsics"].reshape(m, 4, 4))
        dev = inv_k.device
        scores_all, feats_all, pos_all, meta_all = [], [], [], []
        for li, res in enumerate(outs):
            h, w = res["cls_score"].shape[-2:]
            obj = torch.sigmoid(res["cls_score"]).amax(dim=1, keepdim=True)
            if self.objectness_with_centerness:
                obj = obj * torch.sigmoid(res["centerness"])
            if self.objectness_max_pooling:
                # max_pool2d pads with -inf, as flax's max_pool does
                obj = obj * (obj >= F.max_pool2d(obj, 3, stride=1, padding=1))
            s = self.strides[li]
            ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                    indexing="ij")
            pts = torch.stack([xs, ys], dim=-1).reshape(1, h * w, 2) * s + s // 2
            off = res["offset"].flatten(2).transpose(1, 2) * s
            d = res["depth"].flatten(2).transpose(1, 2)                   # (M, HW, 1)
            uvz1 = torch.cat([(pts - off) * d, d, torch.ones_like(d)], dim=-1)
            cam = torch.einsum("mij,mpj->mpi", inv_k, uvz1)
            pos_all.append(torch.einsum("mij,mpj->mpi", c2l, cam)[..., :3])
            feats_all.append(torch.cat([res["cls_feat"], res["reg_feat"]], 1).flatten(2)
                             .transpose(1, 2))
            scores_all.append(obj.reshape(m, h * w))
            view = (torch.arange(m, device=dev) % n)[:, None].expand(m, h * w)
            meta_all.append(torch.stack([view, torch.full_like(view, li)], dim=-1))
        scores = torch.cat(scores_all, 1).reshape(b, -1)
        feats = torch.cat(feats_all, 1)
        feats = feats.reshape(b, -1, feats.shape[-1])
        pos = torch.cat(pos_all, 1).reshape(b, -1, 3)
        meta = torch.cat(meta_all, 1).reshape(b, -1, 2).to(pos.dtype)
        top_s, idx = topk_stable(scores, min(self.num_proposal, scores.shape[1]))

        def take(t):
            return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

        return {"proposal_features": take(feats),
                "proposal_positions": torch.cat([take(pos), take(meta)], dim=-1),
                "proposal_scores": top_s, "proposal_indices": idx}


# ---------------------------------------------------------------- training


def fcos_targets(featmap_sizes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 gt2d_boxes: Sequence[np.ndarray], gt2d_labels: Sequence[np.ndarray],
                 gt_depths: Optional[Sequence[np.ndarray]] = None, num_classes: int = 10,
                 center_radius: float = 1.5,
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 48), (48, 96), (96, 192), (192, 1e4)),
                 centerness_alpha: float = 2.5):
    """Per-token FCOS targets on the host (_get_target_single :1326-1405):
    centre sampling within radius x stride of the 2D box centre, the level's
    regress range on the largest distance to the box edges, the nearest
    centre winning a conflict, centerness exp(-alpha |offset| / (1.414
    radius stride)). Per image gt2d_boxes (G, 4) xyxy pixels, gt2d_labels
    (G,), gt_depths (G,) or None. Returns (labels (M, P) int32,
    num_classes = background; centerness (M, P); offset (M, P, 2) in
    stride units; depth (M, P); num_pos), P the tokens of all levels."""
    m = len(gt2d_boxes)
    p = int(sum(h * w for h, w in featmap_sizes))
    labels = np.full((m, p), num_classes, np.int32)
    ctr = np.zeros((m, p), np.float32)
    off = np.zeros((m, p, 2), np.float32)
    dep = np.zeros((m, p), np.float32)
    total = 0.0
    for mi in range(m):
        boxes = np.asarray(gt2d_boxes[mi], np.float32).reshape(-1, 4)
        lbls = np.asarray(gt2d_labels[mi]).reshape(-1)
        if len(boxes) == 0:
            continue
        depths = (np.asarray(gt_depths[mi], np.float32).reshape(-1)
                  if gt_depths is not None else np.ones(len(boxes)))
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        start = 0
        for li, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            pts = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.float32) * s + s // 2
            d = np.abs(pts[:, None] - centers[None])                  # (hw, G, 2)
            in_ctr = d.max(-1) < center_radius * s
            edge = np.stack([pts[:, None, 0] - boxes[None, :, 0],
                             pts[:, None, 1] - boxes[None, :, 1],
                             boxes[None, :, 2] - pts[:, None, 0],
                             boxes[None, :, 3] - pts[:, None, 1]], -1).max(-1)
            lo, hi = regress_ranges[min(li, len(regress_ranges) - 1)]
            cand = in_ctr & (edge >= lo) & (edge <= hi)
            if not cand.any():
                start += h * w
                continue
            cdist = np.sqrt((d ** 2).sum(-1))
            gi = np.where(cand, cdist, np.inf).argmin(1)
            pos = cand.any(1)
            idx = np.where(pos)[0]
            g = gi[idx]
            labels[mi, start + idx] = lbls[g]
            ctr[mi, start + idx] = np.exp(
                -centerness_alpha * cdist[idx, g] / (1.414 * center_radius * s))
            off[mi, start + idx] = (pts[idx] - centers[g]) / s
            dep[mi, start + idx] = depths[g]
            total += float(pos.sum())
            start += h * w
    return labels, ctr, off, dep, np.float32(total)


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    """optax.huber_loss: 0.5 q^2 + delta (|e| - q), q = min(|e|, delta)."""
    err = (pred - target).abs()
    q = err.clamp(max=delta)
    return 0.5 * q * q + delta * (err - q)


def fcos_loss(outs: List[Dict[str, torch.Tensor]], targets, num_classes: int = 10
              ) -> Dict[str, torch.Tensor]:
    """Focal classification, centerness BCE, offset and depth Huber (delta
    1/9) on the positives, each over num_pos (loss :604-700 at its core, as
    the JAX package keeps it)."""
    dev = outs[0]["cls_score"].device
    labels, ctr_t, off_t, dep_t, num_pos = (torch.as_tensor(np.asarray(t), device=dev)
                                            for t in targets)
    n = num_pos.clamp(min=1.0)

    def flat(key):
        return torch.cat([o[key].flatten(2).transpose(1, 2) for o in outs], 1)

    cls, ctr, off, dep = flat("cls_score"), flat("centerness")[..., 0], flat("offset"), \
        flat("depth")[..., 0]
    pos = (labels < num_classes).to(cls.dtype)
    return {"fcos_loss_cls": sigmoid_focal_loss(cls, labels.long(), num_classes).sum() / n,
            "fcos_loss_centerness": (F.binary_cross_entropy_with_logits(
                ctr, ctr_t, reduction="none") * pos).sum() / n,
            "fcos_loss_offset": (huber_loss(off, off_t, 1.0 / 9.0).sum(-1) * pos).sum() / n,
            "fcos_loss_depth": (huber_loss(dep, dep_t, 1.0 / 9.0) * pos).sum() / n}

