"""Sigma schedules (counterpart of ``panacea_tpu/diffusion/discretization.py``,
reference discretizer.py:11-69).

Schedules are numpy arrays: static data of the sampler loop.
"""

from __future__ import annotations

import numpy as np

from panacea_tpu_torch.diffusion.util import make_beta_schedule


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    """Timestep subset selection (discretizer.py:11-14)."""
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


class EDMDiscretization:
    """Karras rho-schedule (discretizer.py:28-39)."""

    def __init__(self, sigma_min: float = 0.02, sigma_max: float = 80.0, rho: float = 7.0):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.rho = rho

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho


class LegacyDDPMDiscretization:
    """sigma_t = sqrt((1 - abar_t) / abar_t) of the linear-beta DDPM
    schedule, descending (discretizer.py:42-69)."""

    def __init__(self, linear_start: float = 0.00085, linear_end: float = 0.0120,
                 num_timesteps: int = 1000):
        self.num_timesteps = num_timesteps
        betas = make_beta_schedule("linear", num_timesteps,
                                   linear_start=linear_start, linear_end=linear_end)
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)

    def get_sigmas(self, n: int) -> np.ndarray:
        if n < self.num_timesteps:
            steps = generate_roughly_equally_spaced_steps(n, self.num_timesteps)
            alphas_cumprod = self.alphas_cumprod[steps]
        elif n == self.num_timesteps:
            alphas_cumprod = self.alphas_cumprod
        else:
            raise ValueError(f"n={n} > num_timesteps={self.num_timesteps}")
        sigmas = ((1 - alphas_cumprod) / alphas_cumprod).astype(np.float32) ** 0.5
        return sigmas[::-1].copy()
