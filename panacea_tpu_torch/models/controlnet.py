"""ControlNet3D and the controlled UNet (counterpart of
``panacea_tpu/models/controlnet.py``; reference controlmodel.py:19-202).

The ControlNet is a copy of the UNet's encoder and middle with an 8-conv
hint stack that brings the 19-channel BEV-layout panorama down 8x to the
latent resolution, a zero-init 1x1 conv per input block and one after the
middle block. As in the reference, the ControlNet is a submodule of the
UNet (``model.diffusion_model.controlnet.*``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from panacea_tpu_torch.models.layers import Conv2d, zero_init
from panacea_tpu_torch.models.unet import UNetModel3D, _Torso, check_compat


class HintEncoder(nn.Sequential):
    """hint_channels at image resolution -> /8 -> model_channels, zero-init
    last conv (controlmodel.py:43-59). Convs sit at the reference's indices
    0, 2, ..., 14 of ``input_hint_block``; SiLUs between them."""

    def __init__(self, hint_channels: int, model_channels: int):
        widths = [hint_channels, 16, 16, 32, 32, 96, 96, 256]
        strides = [1, 1, 2, 1, 2, 1, 2]
        layers = []
        for i, st in enumerate(strides):
            layers += [Conv2d(widths[i], widths[i + 1], 3, stride=st, padding=1), nn.SiLU()]
        layers.append(zero_init(Conv2d(256, model_channels, 3, padding=1)))
        super().__init__(*layers)


class ControlNet3D(_Torso):
    def __init__(self, hint_channels: int = 19, control_scales: float = 1.0,
                 in_channels: int = 8, model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
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
        self.hint_channels = hint_channels
        self.control_scales = control_scales
        self.input_hint_block = HintEncoder(hint_channels, model_channels)
        chans = [model_channels if it[0] == "conv" else
                 (it[1] if it[0] == "down" else it[1][1]) for it in self.plan[0]]
        self.zero_convs = nn.ModuleList(
            [nn.ModuleList([zero_init(Conv2d(c, c, 1))]) for c in chans])
        mid = model_channels * channel_mult[-1]
        self.middle_block_out = nn.ModuleList([zero_init(Conv2d(mid, mid, 1))])

    def _fold_hint_frames(self, hint: torch.Tensor) -> torch.Tensor:
        """Panacea+ multi-frame hints (controlmodel.py:108-117): when
        hint_channels exceeds the per-frame channel count c of the
        (B*T*m, H, W, c) hint, fold the m hint frames into channels."""
        c = hint.shape[-1]
        if self.hint_channels <= c:
            return hint
        m = self.hint_channels // c
        if m * c != self.hint_channels:
            raise ValueError(f"hint_channels {self.hint_channels} is not a multiple of {c}")
        hint = hint.reshape(hint.shape[0] // m, m, *hint.shape[1:]).movedim(1, 3)
        return hint.reshape(*hint.shape[:3], m * c)

    def encode_hint(self, hint: torch.Tensor) -> torch.Tensor:
        """Latent-resolution hint features. Independent of noise and timestep:
        the engine runs this once per clip, outside the sampler loop."""
        return self.input_hint_block(self._fold_hint_frames(hint.to(self.dtype)))

    def forward(self, x, timesteps, context, hint=None,
                guided_hint: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Scaled residuals, one per UNet input block and one for the middle."""
        emb = self.embed_time(timesteps, y)
        if guided_hint is None:
            guided_hint = self.encode_hint(hint)
        guided_hint = guided_hint.to(self.dtype)
        outs = []
        h = x.to(self.dtype)
        for layers, zc in zip(self.input_blocks, self.zero_convs):
            h = self.run_block(layers, h, emb, context)
            if isinstance(layers[0], Conv2d):
                h = h + guided_hint
            outs.append(zc[0](h))
        h = self.run_block(self.middle_block, h, emb, context)
        outs.append(self.middle_block_out[0](h))
        return [o * self.control_scales for o in outs]


class ControlledUNetModel3D(UNetModel3D):
    """UNet + ControlNet (controlmodel.py:146-202, wrappers.py:37-70)."""

    def __init__(self, controlnet_config: Optional[dict] = None, **unet_params):
        super().__init__(**unet_params)
        self.controlnet = None
        if controlnet_config is not None:
            params = dict(controlnet_config.get("params", {}) or {})
            params.pop("out_channels", None)
            self.controlnet = ControlNet3D(**params)

    def forward(self, x, timesteps, context, hint=None, guided_hint=None, y=None):
        control = None
        if self.controlnet is not None and (hint is not None or guided_hint is not None):
            control = self.controlnet(x, timesteps, context, hint=hint,
                                      guided_hint=guided_hint, y=y)
        return super().forward(x, timesteps, context, control=control, y=y)

    def encode_hint(self, hint: torch.Tensor) -> torch.Tensor:
        if self.controlnet is None:
            raise ValueError("this network has no ControlNet")
        return self.controlnet.encode_hint(hint)
