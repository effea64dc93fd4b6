"""Denoiser preconditioning (counterpart of ``panacea_tpu/diffusion/scaling.py``,
reference denoiser_scaling.py:4-31): sigma -> (c_skip, c_out, c_in, c_noise)
for ``D(x, sigma) = net(x * c_in, c_noise) * c_out + x * c_skip``."""

from __future__ import annotations

import torch


class EDMScaling:
    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = sigma_data

    def __call__(self, sigma: torch.Tensor):
        sd2 = self.sigma_data**2
        c_skip = sd2 / (sigma**2 + sd2)
        c_out = sigma * self.sigma_data / (sigma**2 + sd2) ** 0.5
        c_in = 1 / (sigma**2 + sd2) ** 0.5
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise


class EpsScaling:
    def __call__(self, sigma: torch.Tensor):
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1 / (sigma**2 + 1.0) ** 0.5
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise


class VScaling:
    def __call__(self, sigma: torch.Tensor):
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = -sigma / (sigma**2 + 1.0) ** 0.5
        c_in = 1.0 / (sigma**2 + 1.0) ** 0.5
        c_noise = sigma
        return c_skip, c_out, c_in, c_noise
