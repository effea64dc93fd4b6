"""Classifier-free guidance (counterpart of ``panacea_tpu/diffusion/guiders.py``,
reference guiders.py:8-53 and sampling_utils.NoDynamicThresholding).
``VanillaCFG`` batches the unconditional and conditional branches into one
network call and splits afterwards."""

from __future__ import annotations

import torch

from panacea_tpu_torch.registry import instantiate_from_config

_CFG_CAT_KEYS = ("vector", "crossattn", "concat", "cond_feat", "cond_bev_feat",
                 "guided_hint")


class NoDynamicThresholding:
    def __call__(self, uncond, cond, scale):
        return uncond + scale * (cond - uncond)


class VanillaCFG:
    """uncond + scale * (cond - uncond), through ``dyn_thresh_config``'s
    thresholding (none by default)."""

    def __init__(self, scale: float, dyn_thresh_config=None):
        self.scale = scale
        self.dyn_thresh = (instantiate_from_config(dyn_thresh_config)
                           if dyn_thresh_config is not None else NoDynamicThresholding())

    def __call__(self, x, sigma):
        x_u, x_c = x.chunk(2, dim=0)
        return self.dyn_thresh(x_u, x_c, self.scale)

    def prepare_inputs(self, x, s, c, uc):
        c_out = {k: torch.cat((uc[k], c[k]), dim=0) if k in _CFG_CAT_KEYS else c[k]
                 for k in c}
        return torch.cat([x, x]), torch.cat([s, s]), c_out


class IdentityGuider:
    def __call__(self, x, sigma):
        return x

    def prepare_inputs(self, x, s, c, uc):
        return x, s, dict(c)
