"""UNetModel3D (counterpart of ``panacea_tpu/models/unet.py``; reference
sgm/modules/diffusionmodules/openaimodel.py:774-1319).

SD2.1 topology with decomposed 4D attention: 320 base channels, mult
(1, 2, 4, 4), 2 ResBlock3D per level, a SpatialTemporalTransformer wherever
the downsample rate is in ``attention_resolutions``. Activations are
channels-last (B*T, H, W, C); the text context stays per clip (B, L, D).

``num_classes`` adds a class or vector embedding to the timestep embedding
(an int: ``nn.Embedding``; ``"continuous"``: a Linear on a scalar;
``"sequential"``: an MLP on ``adm_in_channels``; openaimodel.py:945-968).
``use_spatial_transformer=False`` puts the context-free
``LegacyAttentionBlock3D`` where the transformers would be (unet.py:122-133
of the JAX package). ``use_linear_in_transformer`` is accepted and, as in
the JAX package, changes nothing: the projections are always linear.

``use_checkpoint`` (default True, as the JAX modules') recomputes each
ResBlock3D and each attention block in the backward pass
(``torch.utils.checkpoint``, non-reentrant) where the JAX modules apply
``nn.remat`` (panacea_tpu/models/unet.py:78-81, 127-137): only while the
module trains and autograd records. Sampling under ``no_grad`` is unaffected.
Under a frame grid the recomputed forward runs under the grid of the
forward it repeats (``shardctx.checkpoint_contexts``) and re-issues its
exchanges, in the same order on every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from panacea_tpu_torch.diffusion.util import timestep_embedding
from panacea_tpu_torch.models.layers import (Conv2d, Downsample, GroupNorm, ResBlock3D,
                                             Upsample, zero_init)
from panacea_tpu_torch.models.legacy_attention import LegacyAttentionBlock3D
from panacea_tpu_torch.models.transformer import SpatialTemporalTransformer
from panacea_tpu_torch.parallel import shardctx

# config keys the reference yaml carries that change nothing here
COMPAT_KEYS = frozenset({"use_fp16", "legacy", "alpha", "use_linear_in_transformer"})
# the blocks that take a second argument (the time embedding or the context)
# and that use_checkpoint recomputes
_BLOCKS = (ResBlock3D, SpatialTemporalTransformer, LegacyAttentionBlock3D)


def check_compat(name: str, extra: dict) -> None:
    unknown = set(extra) - COMPAT_KEYS
    if unknown:
        raise TypeError(f"{name}: unknown config keys {sorted(unknown)}")


def make_label_emb(num_classes, width: int, adm_in_channels: Optional[int]):
    """The ``label_emb`` module of the reference (openaimodel.py:945-968)."""
    if isinstance(num_classes, int) and not isinstance(num_classes, bool):
        return nn.Embedding(num_classes, width)
    if num_classes == "continuous":
        return nn.Linear(1, width)
    if num_classes == "sequential":
        if adm_in_channels is None:
            raise ValueError("num_classes='sequential' needs adm_in_channels")
        return nn.Sequential(nn.Sequential(nn.Linear(adm_in_channels, width), nn.SiLU(),
                                           nn.Linear(width, width)))
    raise ValueError(f"unsupported num_classes {num_classes!r}")


def plan_blocks(model_channels: int, channel_mult: Sequence[int], num_res_blocks: int,
                attention_resolutions: Sequence[int]):
    """Static block plan (unet.py:37-72, openaimodel.py:975-1085)."""
    input_plan = [("conv", model_channels, None)]
    ch = model_channels
    input_chans = [model_channels]
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            out_ch = mult * model_channels
            input_plan.append(("res", (ch, out_ch), ds in attention_resolutions))
            ch = out_ch
            input_chans.append(ch)
        if level != len(channel_mult) - 1:
            input_plan.append(("down", ch, None))
            input_chans.append(ch)
            ds *= 2
    output_plan = []
    for level, mult in reversed(list(enumerate(channel_mult))):
        for i in range(num_res_blocks + 1):
            ich = input_chans.pop()
            out_ch = model_channels * mult
            up = level > 0 and i == num_res_blocks
            output_plan.append(("res", (ch + ich, out_ch), ds in attention_resolutions, up))
            ch = out_ch
            if up:
                ds //= 2
    return input_plan, output_plan, ch


class _Torso(nn.Module):
    """Time embedding, input blocks and middle block shared by the UNet and
    the ControlNet."""

    def __init__(self, in_channels, model_channels, num_res_blocks, attention_resolutions,
                 channel_mult, num_head_channels, transformer_depth, context_dim,
                 num_frames, spatial_only_attn_type, insert_crossview, use_checkpoint,
                 use_spatial_transformer=True, num_classes=None, adm_in_channels=None):
        super().__init__()
        self.model_channels = model_channels
        self.use_checkpoint = use_checkpoint
        self.num_frames = num_frames
        self.num_classes = num_classes
        emb = 4 * model_channels
        self.plan = plan_blocks(model_channels, tuple(channel_mult), num_res_blocks,
                                tuple(attention_resolutions))

        def transformer(ch):
            if not use_spatial_transformer:
                return LegacyAttentionBlock3D(ch, ch // num_head_channels, num_head_channels,
                                              num_frames=num_frames)
            return SpatialTemporalTransformer(
                ch, ch // num_head_channels, num_head_channels, context_dim,
                depth=transformer_depth, num_frames=num_frames,
                spatial_attn_mode=spatial_only_attn_type, insert_crossview=insert_crossview)

        self.make_transformer = transformer
        self.make_resblock = lambda i, o: ResBlock3D(i, emb, o, num_frames=num_frames)
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))
        if num_classes is not None:
            self.label_emb = make_label_emb(num_classes, emb, adm_in_channels)
        self.input_blocks = nn.ModuleList()
        for item in self.plan[0]:
            if item[0] == "conv":
                layers = [Conv2d(in_channels, model_channels, 3, padding=1)]
            elif item[0] == "down":
                layers = [Downsample(item[1])]
            else:
                (i, o), attn = item[1], item[2]
                layers = [self.make_resblock(i, o)] + ([transformer(o)] if attn else [])
            self.input_blocks.append(nn.ModuleList(layers))
        mid = model_channels * channel_mult[-1]
        self.middle_block = nn.ModuleList([self.make_resblock(mid, mid), transformer(mid),
                                           self.make_resblock(mid, mid)])

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed[0].weight.dtype

    def embed_time(self, timesteps: torch.Tensor, y: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """The timestep embedding, plus the label embedding of ``y`` where
        the network has ``num_classes`` (unet.py:95-117 of the JAX package).
        A per-clip ``y`` is repeated over its frames, each clip's rows
        together (``jnp.repeat``)."""
        t_emb = timestep_embedding(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed(t_emb)
        if self.num_classes is None:
            return emb
        if y is None:
            raise ValueError("a class-conditional network needs y")
        if y.shape[0] != emb.shape[0]:
            y = y.repeat_interleave(emb.shape[0] // y.shape[0], dim=0)
        if isinstance(self.label_emb, nn.Embedding):
            return emb + self.label_emb(y.long())
        if self.num_classes == "continuous":
            y = y.reshape(-1, 1)
        return emb + self.label_emb(y.to(self.dtype))

    def run_block(self, layers, h, emb, context):
        remat = self.use_checkpoint and self.training and torch.is_grad_enabled()
        for layer in layers:
            if isinstance(layer, _BLOCKS):
                arg = emb if isinstance(layer, ResBlock3D) else context
                h = (checkpoint(layer, h, arg, use_reentrant=False,
                                context_fn=shardctx.checkpoint_contexts)
                     if remat else layer(h, arg))
            else:
                h = layer(h)
        return h


class UNetModel3D(_Torso):
    def __init__(self, in_channels: int = 8, model_channels: int = 320, out_channels: int = 4,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_head_channels: int = 64,
                 transformer_depth: int = 1, context_dim: int = 1024, num_frames: int = 8,
                 spatial_only_attn_type: str = "intra-view", insert_crossview: bool = True,
                 use_spatial_transformer: bool = True, use_checkpoint: bool = True,
                 num_classes=None, adm_in_channels: Optional[int] = None, **compat):
        check_compat(type(self).__name__, compat)
        super().__init__(in_channels, model_channels, num_res_blocks, attention_resolutions,
                         channel_mult, num_head_channels, transformer_depth, context_dim,
                         num_frames, spatial_only_attn_type, insert_crossview, use_checkpoint,
                         use_spatial_transformer, num_classes, adm_in_channels)
        self.output_blocks = nn.ModuleList()
        for _, (i, o), attn, up in self.plan[1]:
            layers = [self.make_resblock(i, o)]
            if attn:
                layers.append(self.make_transformer(o))
            if up:
                layers.append(Upsample(o))
            self.output_blocks.append(nn.ModuleList(layers))
        ch = self.plan[2]
        self.out = nn.ModuleList([GroupNorm(ch), nn.SiLU(),
                                  zero_init(Conv2d(ch, out_channels, 3, padding=1))])

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                control: Optional[List[torch.Tensor]] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B*T, H, W, in_channels); timesteps: (B*T,); context: (B, L, D);
        control: ControlNet residuals (one per input block + middle); y: the
        class or vector condition, per frame or per clip, where the network
        has ``num_classes``. Returns (B*T, H, W, out_channels)."""
        emb = self.embed_time(timesteps, y)
        hs = []
        h = x.to(self.dtype)
        for layers in self.input_blocks:
            h = self.run_block(layers, h, emb, context)
            hs.append(h)
        h = self.run_block(self.middle_block, h, emb, context)
        control = list(control) if control is not None else None
        if control is not None:
            h = h + control.pop()
        for layers in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control.pop()
            h = self.run_block(layers, torch.cat([h, skip], dim=-1), emb, context)
        return self.out[2](self.out[0](h, silu=True))
