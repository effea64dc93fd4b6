"""Latent distributions (counterpart of ``panacea_tpu/diffusion/distributions.py``,
reference sgm/modules/distributions/distributions.py and
autoencoding/regularizers/__init__.py).

Channels-last, as in the JAX package: the moments are ``(..., 2 * C)``.
``sample`` draws from an explicit ``torch.Generator`` or takes the standard
normal noise injected. The VAE's own encode-and-sample path
(``models/vae.py``) does not go through these classes; they serve code that
handles posteriors directly (regularizers, VAE training).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


class DiracDistribution:
    """Point mass (distributions.py:13-21)."""

    def __init__(self, value):
        self.value = value

    def sample(self, generator=None, noise=None):
        return self.value

    def mode(self):
        return self.value


class DiagonalGaussianDistribution:
    """Diagonal Gaussian from (..., 2 * C) channels-last moments
    (distributions.py:24-72; the reference splits dim 1 of NCHW)."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        if deterministic:
            self.var = self.std = torch.zeros_like(self.mean)
        else:
            self.std = torch.exp(0.5 * self.logvar)
            self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise, the noise drawn from ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * torch.as_tensor(noise, dtype=self.mean.dtype,
                                                      device=self.mean.device)

    def _reduce_dims(self) -> Tuple[int, ...]:
        return tuple(range(1, self.mean.ndim))

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        if self.deterministic:
            return self.mean.new_zeros((self.mean.shape[0],))
        dims = self._reduce_dims()
        if other is None:
            return 0.5 * torch.sum(self.mean**2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=dims)

    def nll(self, sample: torch.Tensor, dims: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        if self.deterministic:
            return self.mean.new_zeros((self.mean.shape[0],))
        dims = self._reduce_dims() if dims is None else tuple(dims)
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(logtwopi + self.logvar + (sample - self.mean) ** 2 / self.var,
                               dim=dims)

    def mode(self) -> torch.Tensor:
        return self.mean


def normal_kl(mean1, logvar1, mean2, logvar2):
    """Broadcasting KL between two diagonal Gaussians (distributions.py:75-103,
    from openai/guided-diffusion)."""
    mean1, logvar1, mean2, logvar2 = map(torch.as_tensor, (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


class DiagonalGaussianRegularizer:
    """Sample-or-mode and the KL (regularizers/__init__.py:23-41): the
    (..., 2 * C) moments -> (z, {'kl_loss': scalar})."""

    def __init__(self, sample: bool = True):
        self.sample = sample

    def __call__(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        posterior = DiagonalGaussianDistribution(z)
        if self.sample:
            if generator is None and noise is None:
                raise ValueError("DiagonalGaussianRegularizer(sample=True) needs a "
                                 "generator or the noise")
            z = posterior.sample(generator, noise)
        else:
            z = posterior.mode()
        kl = posterior.kl()
        return z, {"kl_loss": torch.sum(kl) / kl.shape[0]}
