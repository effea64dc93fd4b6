"""Training-time sigma samplers (counterpart of
``panacea_tpu/diffusion/sigma_sampling.py``; reference
sgm/modules/diffusionmodules/sigma_sampling.py).

Random draws come from a ``torch.Generator``; ``rand=`` injects them (the
standard normals of ``EDMSampling``, the level indices of
``DiscreteSampling``), so that tests feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from panacea_tpu_torch.registry import instantiate_from_config


class EDMSampling:
    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2):
        self.p_mean = p_mean
        self.p_std = p_std

    def __call__(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 rand: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
        if rand is None:
            rand = torch.randn((n_samples,), generator=generator, device=device)
        return torch.exp(self.p_mean + self.p_std * torch.as_tensor(rand, dtype=torch.float32))


class DiscreteSampling:
    def __init__(self, discretization_config, num_idx: int, do_append_zero: bool = False,
                 flip: bool = True):
        self.num_idx = num_idx
        sigmas = instantiate_from_config(discretization_config).get_sigmas(num_idx)
        if do_append_zero:
            sigmas = torch.cat([torch.as_tensor(sigmas), torch.zeros(1)]).numpy()
        self.sigmas_np = (sigmas[::-1] if flip else sigmas).copy()

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.sigmas_np, device=idx.device)[idx]

    def __call__(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 rand: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
        if rand is None:
            rand = torch.randint(0, self.num_idx, (n_samples,), generator=generator,
                                 device=device)
        return self.idx_to_sigma(torch.as_tensor(rand, dtype=torch.long, device=device))
