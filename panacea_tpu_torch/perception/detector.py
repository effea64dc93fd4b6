"""StreamPETRWindow and StreamPETR: multi-view 3D detection over a sliding
window or a stream, inference and training; and the dense-attention PETR
drivers.

Counterpart of ``panacea_tpu/perception/detector.py`` (reference
streampetrwindow.py:312-389, streampetr.py, petrwindow3d.py, petr3d.py and
the generation side's petr3dm.py and petr3dp.py): a backbone (ResNet-50, or
VoVNet-99 with the neck from its third stage) and a 5-level FPN per frame,
then a head with its query memory: the SparseHead of the recipes, the
dense-attention ``StreamPETRHead``, the non-streaming ``PETRHeadDN`` or
the trajectory head ``PETRMotionHead``; with ``with_atss`` the ATSS 2D
auxiliary head of training (``img_roi_head``). A window of T frames runs
every frame through backbone and head, warming the memory, and returns the
last frame's outputs. The memory is reset on a scene change through
``prev_exists``. In training (``train_window``) the first T - 1 frames run
without gradients; the streaming recipes (``train_frame``) carry the
memory across steps.

Images come in the JAX package's layout, (B, T, N, H, W, 3) normalised;
the backbone runs NCHW. Submodules carry mmdet's names (``img_backbone``,
``img_neck``, ``pts_bbox_head``, ``img_roi_head``), so a StreamPETR
``.pth`` loads directly. The EVA backbone and the proposal-query heads
(``sparse_v3``, ``sparse_v4``) wait for the rest of the perception zoo
(ROADMAP Queue A item 6).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from panacea_tpu_torch.models.engine import no_tf32
from panacea_tpu_torch.perception.atss import CLS_BIAS, ATSSHead, Scale
from panacea_tpu_torch.perception.fpn import FPN
from panacea_tpu_torch.perception.head import PC_RANGE, MemoryState, SparseHead, init_memory
from panacea_tpu_torch.perception.motion_head import PETRMotionHead
from panacea_tpu_torch.perception.petr_head import StreamPETRHead
from panacea_tpu_torch.perception.petr_head_dn import PETRHeadDN
from panacea_tpu_torch.perception.resnet import FrozenBatchNorm, ResNet50
from panacea_tpu_torch.perception.vovnet import VoVNet

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)
NOT_PORTED = "is not ported; it waits for the perception zoo (ROADMAP Queue A item 6)"
HEADS = {"sparse": SparseHead, "petr": StreamPETRHead, "petr_dn": PETRHeadDN,
         "motion": PETRMotionHead}
R50_CHANNELS = (256, 512, 1024, 2048)


class StreamPETRWindow(nn.Module):
    """``backbone_type`` 'r50' or 'vovnet' (``backbone_cfg`` its extra
    arguments; ``neck_start_level`` the first stage the FPN takes: 1 for
    r50, 2 for VoVNet-99, as the reference's CPFPN in_channels); ``head_type``
    'sparse', 'petr', 'petr_dn' or 'motion' (``head_cfg`` the head's extra
    arguments), by default the class's ``HEAD_TYPE``."""

    HEAD_TYPE = "sparse"

    def __init__(self, num_classes: int = 10, embed_dims: int = 256, num_query: int = 644,
                 memory_len: int = 1024, topk_proposals: int = 256, num_propagated: int = 256,
                 num_decoder_layers: int = 6, num_levels: int = 5, num_cams: int = 6,
                 pc_range: Sequence[float] = PC_RANGE, with_atss: bool = False,
                 backbone_type: str = "r50", backbone_cfg: Optional[dict] = None,
                 neck_start_level: int = 1, head_type: Optional[str] = None,
                 head_cfg: Optional[dict] = None, atss_stacked_convs: int = 4):
        super().__init__()
        head_type = head_type or self.HEAD_TYPE
        for kind, name, known in (("backbone_type", backbone_type, ("r50", "vovnet", "eva")),
                                  ("head_type", head_type,
                                   tuple(HEADS) + ("sparse_v3", "sparse_v4"))):
            if name not in known:
                raise ValueError(f"unknown {kind} {name!r}")
        if backbone_type == "eva":
            raise NotImplementedError(f"backbone_type 'eva' {NOT_PORTED}")
        if head_type not in HEADS:
            raise NotImplementedError(f"head_type {head_type!r} {NOT_PORTED}")
        self.backbone_type, self.head_type = backbone_type, head_type
        self.num_query, self.num_propagated = num_query, num_propagated
        self.pc_range = tuple(pc_range)
        self.embed_dims, self.memory_len, self.num_levels = embed_dims, memory_len, num_levels
        if backbone_type == "r50":
            self.img_backbone = ResNet50(**dict(backbone_cfg or {}))
            in_channels = R50_CHANNELS
        else:
            self.img_backbone = VoVNet(**dict(backbone_cfg or {}))
            in_channels = self.img_backbone.out_channels
        self.img_neck = FPN(in_channels=in_channels, out_channels=embed_dims,
                            start_level=neck_start_level, num_outs=num_levels)
        self.pts_bbox_head = HEADS[head_type](
            num_classes=num_classes, embed_dims=embed_dims, num_query=num_query,
            memory_len=memory_len, topk_proposals=topk_proposals,
            num_propagated=num_propagated, num_decoder_layers=num_decoder_layers,
            num_levels=num_levels, num_cams=num_cams, pc_range=pc_range,
            **dict(head_cfg or {}))
        self.with_atss = with_atss
        if with_atss:
            self.img_roi_head = ATSSHead(num_classes=num_classes, in_channels=embed_dims,
                                         feat_channels=embed_dims,
                                         stacked_convs=atss_stacked_convs, num_levels=num_levels)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, zero_init_std: Optional[float] = None):
        """Random weights from ``generator``, as the JAX modules initialise
        them: conv and linear weights normal with std 1/sqrt(fan_in), biases
        0, norms at weight 1 and bias 0, batch-norm statistics 0 and 1, the
        reference points uniform in [0, 1], the MLN gammas at weight 0 and
        bias 1, ``weights_fc`` at 0, the ``learnable_fc`` bias uniform in
        [-2, 2], the class biases (head and ATSS) at -4.595 and the ATSS
        scales at 1, the trajectory modes' embedding normal with std 1. With
        ``zero_init_std`` every
        tensor that this leaves at a constant gets normal noise of that std
        added, so that every branch computes."""
        dev = next(self.parameters()).device

        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator, device=dev) * std)

        def uniform(t, lo, hi):
            t.copy_(torch.rand(t.shape, generator=generator, device=dev) * (hi - lo) + lo)

        constant = []
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                normal(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
                if mod.bias is not None:
                    constant.append(mod.bias.zero_())
            elif isinstance(mod, (nn.LayerNorm, FrozenBatchNorm)):
                constant += [mod.weight.fill_(1.0), mod.bias.zero_()]
                if isinstance(mod, FrozenBatchNorm):
                    constant += [mod.running_mean.zero_(), mod.running_var.fill_(1.0)]
            elif isinstance(mod, nn.Embedding):
                if name.endswith("traj_embedding"):
                    normal(mod.weight, 1.0)
                else:
                    uniform(mod.weight, 0.0, 1.0)
            elif isinstance(mod, Scale):
                constant.append(mod.scale.fill_(1.0))
        # then what differs from that, children already set
        for name, mod in self.named_modules():
            if name.endswith("attn") and hasattr(mod, "in_proj_weight"):
                normal(mod.in_proj_weight, 1.0 / math.sqrt(mod.in_proj_weight.shape[1]))
                constant.append(mod.in_proj_bias.zero_())
            if name.endswith(("ego_pose_pe", "ego_pose_memory", "spatial_alignment")):
                constant += [mod.gamma.weight.zero_(), mod.gamma.bias.fill_(1.0),
                             mod.beta.weight.zero_(), mod.beta.bias.zero_()]
            if name.endswith("attentions.1") and hasattr(mod, "weights_fc"):
                constant.append(mod.weights_fc.weight.zero_())
                uniform(mod.learnable_fc.bias, -2.0, 2.0)
        for branch in self.pts_bbox_head.cls_branches:
            constant.append(branch[-1].bias.fill_(CLS_BIAS))
        if self.with_atss:
            constant.append(self.img_roi_head.atss_cls.bias.fill_(CLS_BIAS))
        if zero_init_std is not None:
            seen = set()
            for t in constant:
                if id(t) not in seen:
                    seen.add(id(t))
                    t.add_(torch.randn(t.shape, generator=generator, device=dev) * zero_init_std)

    def extract_feats(self, imgs: torch.Tensor) -> List[torch.Tensor]:
        """imgs (B, N, H, W, 3), normalised -> the FPN levels, each (B N, C, h, w)."""
        b, n, h, w, c = imgs.shape
        x = imgs.reshape(b * n, h, w, c).permute(0, 3, 1, 2).contiguous()
        feats = self.img_neck(self.img_backbone(x))
        if len(feats) != self.num_levels:
            raise ValueError(f"the neck gave {len(feats)} levels, the head takes "
                             f"{self.num_levels}")
        return list(feats)

    @no_tf32()
    def forward_frame(self, imgs: torch.Tensor, memory: MemoryState,
                      data: Dict[str, torch.Tensor]):
        """One frame: features and head. Returns (outs, new_memory). TF32 is
        off inside, as the JAX detector computes in fp32."""
        feats = self.extract_feats(imgs)
        return self.pts_bbox_head(feats, memory, data, (imgs.shape[2], imgs.shape[3]))

    def forward(self, imgs_seq: torch.Tensor, data_seq: Dict[str, torch.Tensor],
                memory: Optional[MemoryState] = None) -> Tuple[Dict[str, torch.Tensor],
                                                               MemoryState]:
        """Sliding-window inference (streampetrwindow.py:312-369): imgs_seq
        (B, T, N, H, W, 3), data_seq values with leading (B, T). Runs all T
        frames and returns the last frame's outputs and the final memory."""
        b, t = imgs_seq.shape[:2]
        if memory is None:
            memory = init_memory(b, self.memory_len, self.embed_dims, device=imgs_seq.device)
        outs = None
        for fi in range(t):
            data = {k: v[:, fi] for k, v in data_seq.items()}
            outs, memory = self.forward_frame(imgs_seq[:, fi], memory, data)
        return outs, memory

    @no_tf32()
    def train_frame(self, imgs: torch.Tensor, memory: MemoryState, data: Dict[str, torch.Tensor],
                    dn=None):
        """Streaming training forward (streampetr.py:209-252, seq_mode): one
        frame with the memory carried in from the previous step. Returns
        (outs, atss_outs, new_memory); ``atss_outs`` the roi head's
        per-level outputs on this frame's FPN features, or None without
        ``with_atss``. The caller detaches new_memory before the next
        step, as the reference's post_update_memory does."""
        feats = self.extract_feats(imgs)
        outs, memory = self.pts_bbox_head(feats, memory, data, (imgs.shape[2], imgs.shape[3]),
                                          dn=dn)
        return outs, (self.img_roi_head(feats) if self.with_atss else None), memory

    @no_tf32()
    def train_window(self, imgs_seq: torch.Tensor, data_seq: Dict[str, torch.Tensor], dn=None,
                     num_frame_losses: int = 1):
        """Training forward over a window (streampetrwindow.py's training
        path): the first T - 1 frames warm the memory under no_grad, the
        last frame runs with gradients and ``dn``. Returns (outs,
        atss_outs, memory) of the last frame. Only num_frame_losses 1, the
        value of every reference recipe (window.py:26)."""
        if num_frame_losses != 1:
            raise NotImplementedError("num_frame_losses other than 1: no reference recipe "
                                      "uses it")
        b, t = imgs_seq.shape[:2]
        memory = init_memory(b, self.memory_len, self.embed_dims, device=imgs_seq.device)
        with torch.no_grad():
            for fi in range(t - 1):
                data = {k: v[:, fi] for k, v in data_seq.items()}
                _, memory = self.forward_frame(imgs_seq[:, fi], memory, data)
        return self.train_frame(imgs_seq[:, t - 1], memory,
                                {k: v[:, t - 1] for k, v in data_seq.items()}, dn=dn)


class StreamPETR(StreamPETRWindow):
    """The streaming variant (reference detectors/streampetr.py:30): the
    memory persists across calls instead of being warmed per window.
    Drive it frame by frame and thread the returned memory;
    ``prev_exists`` 0 resets it on a scene change."""

    def stream(self, imgs: torch.Tensor, data: Dict[str, torch.Tensor],
               memory: Optional[MemoryState] = None):
        if memory is None:
            memory = init_memory(imgs.shape[0], self.memory_len, self.embed_dims,
                                 device=imgs.device)
        return self.forward_frame(imgs, memory, data)


def normalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 255] -> ImageNet-normalised (config img_norm_cfg)."""
    mean = torch.tensor(IMG_MEAN, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(IMG_STD, dtype=imgs.dtype, device=imgs.device)
    return (imgs - mean) / std


class PetrWindow3D(StreamPETRWindow):
    """Reference detectors/petrwindow3d.py: the sliding-window driver with
    the dense-attention StreamPETRHead."""

    HEAD_TYPE = "petr"


class Petr3D(StreamPETR):
    """Reference detectors/petr3d.py:21: the streaming driver with the
    dense-attention StreamPETRHead (petr3d.py:104-144)."""

    HEAD_TYPE = "petr"


class Petr3DM(StreamPETR):
    """The generation side's detectors/petr3dm.py:22: the streaming Petr3D
    driver."""

    HEAD_TYPE = "petr"


class Petr3DP(StreamPETR):
    """The generation side's detectors/petr3dp.py:22: Petr3DM with
    PETRMotionHead; ``motion_head.decode_with_traj`` gives each decoded box
    its ``traj`` and ``traj_scores`` (petr3dp.py:309-316)."""

    HEAD_TYPE = "motion"
