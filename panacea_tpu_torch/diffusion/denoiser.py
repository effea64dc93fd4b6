"""Denoiser preconditioning wrappers (counterpart of
``panacea_tpu/diffusion/denoiser.py``, reference denoiser.py:6-63).

``Denoiser`` applies a scaling: ``network(x * c_in, c_noise, cond) * c_out
+ x * c_skip``. ``DiscreteDenoiser`` first quantises sigma to the nearest of
``num_idx`` DDPM levels (ascending); the network's c_noise becomes that
integer timestep index.
"""

from __future__ import annotations

import numpy as np
import torch

from panacea_tpu_torch.diffusion.util import append_dims
from panacea_tpu_torch.registry import instantiate_from_config


class Denoiser:
    def __init__(self, weighting_config, scaling_config):
        self.weighting = instantiate_from_config(weighting_config)  # the training loss's
        self.scaling = instantiate_from_config(scaling_config)

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def w(self, sigma: torch.Tensor) -> torch.Tensor:
        """The training loss's weighting w(sigma)."""
        return self.weighting(sigma)

    def __call__(self, network, x, sigma, cond):
        sigma = self.possibly_quantize_sigma(sigma)
        sigma_shape = sigma.shape
        sigma = append_dims(sigma, x.ndim)
        c_skip, c_out, c_in, c_noise = self.scaling(sigma)
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma_shape))
        return network(x * c_in, c_noise, cond) * c_out + x * c_skip


class DiscreteDenoiser(Denoiser):
    def __init__(self, weighting_config, scaling_config, num_idx: int, discretization_config):
        super().__init__(weighting_config, scaling_config)
        sigmas = instantiate_from_config(discretization_config).get_sigmas(num_idx)
        self.sigmas_np = sigmas[::-1].astype(np.float32)
        self._sigmas = {}  # device -> float32 tensor of sigmas_np

    def sigmas(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._sigmas:
            self._sigmas[device] = torch.as_tensor(self.sigmas_np, device=device)
        return self._sigmas[device]

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        dists = sigma - self.sigmas(sigma.device)[:, None]
        return dists.abs().argmin(dim=0).reshape(sigma.shape)

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.sigmas(sigma.device)[self.sigma_to_idx(sigma)]

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return self.sigma_to_idx(c_noise)
