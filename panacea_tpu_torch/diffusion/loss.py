"""Training loss (counterpart of ``panacea_tpu/diffusion/loss.py``; reference
sgm/modules/diffusionmodules/loss.py:11-79).

The Panacea shared-noise bias, which pulls every frame's noise toward the
conditioning frame's latent (loss.py:54-60), is carried over. Random draws
(the sigma sampler's, the noise, the offset noise) come from a
``torch.Generator`` in that order, or are injected: ``sigma_rand`` (what the
sigma sampler draws), ``noise`` and ``offset``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from panacea_tpu_torch.diffusion.util import append_dims
from panacea_tpu_torch.registry import instantiate_from_config


class StandardDiffusionLoss:
    def __init__(self, sigma_sampler_config, type: str = "l2", offset_noise_level: float = 0.0,
                 share_noise_level: float = 0.0, num_frames: int = 8, batch2model_keys=None,
                 lpips_fn: Optional[Callable] = None):
        if type not in ("l2", "l1", "lpips"):
            raise ValueError(f"unknown loss type {type!r}")
        self.type = type
        self.offset_noise_level = offset_noise_level
        self.share_noise_level = share_noise_level
        self.num_frames = num_frames
        self.sigma_sampler = instantiate_from_config(sigma_sampler_config)
        self.lpips_fn = lpips_fn
        if isinstance(batch2model_keys, str):
            batch2model_keys = [batch2model_keys]
        self.batch2model_keys = set(batch2model_keys or [])

    def __call__(self, network, denoiser, cond: Dict[str, Any], x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 sigma_rand: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: clean latents (B*T, H, W, C) channels-last, fp32. Returns the
        per-sample loss, (B*T,)."""
        n = x.shape[0]
        sigmas = self.sigma_sampler(n, generator=generator, rand=sigma_rand, device=x.device)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
        if self.offset_noise_level > 0.0:
            if offset is None:
                offset = torch.randn((n,), generator=generator, device=x.device, dtype=x.dtype)
            offset = torch.as_tensor(offset, dtype=x.dtype, device=x.device)
            noise = noise + self.offset_noise_level * append_dims(offset, x.ndim)
        if self.share_noise_level > 0.0:
            # bias all frames' noise toward the conditioning-frame latent
            # (loss.py:54-60); concat[-1] is the conditioning frame
            cf = cond["concat"][-1].to(x.dtype)
            cf_seq = cf[None].expand((self.num_frames,) + tuple(cf.shape))
            noise = noise + cf_seq.repeat((n // self.num_frames,) + (1,) * (x.ndim - 1)) \
                * self.share_noise_level
        noised = x + noise * append_dims(sigmas, x.ndim)
        model_output = denoiser(network, noised, sigmas, cond)
        w = append_dims(denoiser.w(sigmas), x.ndim)
        return self.get_loss(model_output, x, w)

    def get_loss(self, model_output: torch.Tensor, target: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        if self.type == "l2":
            return (w * (model_output - target) ** 2).reshape(target.shape[0], -1).mean(dim=1)
        if self.type == "l1":
            return (w * (model_output - target).abs()).reshape(target.shape[0], -1).mean(dim=1)
        if self.lpips_fn is None:
            raise ValueError("lpips loss requested but no lpips_fn provided")
        return self.lpips_fn(model_output, target).reshape(-1)
