"""The VAE's training losses (NCHW).

Counterpart of ``panacea_tpu/losses/vae_losses.py`` (reference
sgm/modules/autoencoding/losses/__init__.py:19-251 and
regularizers/__init__.py:23-41): the KL regulariser, the PatchGAN
discriminator, the hinge and vanilla discriminator losses, the adaptive
adversarial weight, ``LatentLPIPS`` and ``GeneralLPIPSWithDiscriminator``.

As in the JAX package, the discriminator normalises with GroupNorm where the
reference has BatchNorm (its ``main.{i}`` index keeps the name), and the two
loss classes take the perceptual metric (``lpips_apply(x, y) -> (N, ...)``)
and, for ``LatentLPIPS``, the decoder (``decode_apply(z) -> images``) as
callables; ``LatentLPIPS`` also builds its decoder from ``decoder_config``
through the port's registry. Images are (N, 3, H, W) and latents (N, C, h,
w).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.ops.resize import resize


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL of a diagonal Gaussian to N(0, I), summed per sample
    (DiagonalGaussianDistribution.kl); logvar clipped to [-30, 20]."""
    logvar = logvar.clamp(-30.0, 20.0)
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return kl.reshape(kl.shape[0], -1).sum(dim=-1)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (lpips/model/model.py:1-88): a stride-2 4 x 4
    convolution, then ``n_layers`` bias-free ones (the last of stride 1),
    each normalised and LeakyReLU'd, then a 1-channel 4 x 4 convolution.
    GroupNorm(min(32, C), eps 1e-6) stands at the reference BatchNorm's
    index, as in the JAX module."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        cin = ndf
        for i in range(1, n_layers + 1):
            ch = ndf * min(2 ** i, 8)
            layers += [nn.Conv2d(cin, ch, 4, 2 if i < n_layers else 1, 1, bias=False),
                       nn.GroupNorm(min(32, ch), ch, eps=1e-6), nn.LeakyReLU(0.2)]
            cin = ch
        layers.append(nn.Conv2d(cin, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adaptive_weight(nll_grad_norm, g_grad_norm, max_w: float = 1e4):
    """||grad nll|| / (||grad g|| + 1e-4), clipped to [0, max_w]
    (calculate_adaptive_weight)."""
    return torch.clamp(torch.as_tensor(nll_grad_norm) / (torch.as_tensor(g_grad_norm) + 1e-4),
                       0.0, max_w)


class LatentLPIPS(nn.Module):
    """Latent L2 plus the LPIPS of decoded images (reference LatentLPIPS,
    losses/__init__.py:19-85): ``latent_weight * mean((z_in - z_pred)^2)
    + perceptual_weight * LPIPS(decode(z_in), decode(z_pred))``, plus
    ``perceptual_weight_on_inputs * LPIPS(image_inputs, decode(z_pred))``.
    With ``perceptual_weight`` 0 the L2 term stays elementwise and the
    scalar terms broadcast over it, the reference's quirk. The bicubic
    rescales are the port's exact ``resize`` (antialiased, as
    ``jax.image.resize``). ``forward`` returns (loss, log)."""

    def __init__(self, decoder_config=None, perceptual_weight: float = 1.0,
                 latent_weight: float = 1.0, scale_input_to_tgt_size: bool = False,
                 scale_tgt_to_input_size: bool = False,
                 perceptual_weight_on_inputs: float = 0.0,
                 decode_apply: Optional[Callable] = None,
                 lpips_apply: Optional[Callable] = None):
        super().__init__()
        if scale_input_to_tgt_size and scale_tgt_to_input_size:
            raise ValueError("scale_input_to_tgt_size and scale_tgt_to_input_size exclude "
                             "each other")
        self.perceptual_weight = perceptual_weight
        self.latent_weight = latent_weight
        self.scale_input_to_tgt_size = scale_input_to_tgt_size
        self.scale_tgt_to_input_size = scale_tgt_to_input_size
        self.perceptual_weight_on_inputs = perceptual_weight_on_inputs
        self.decode_apply = decode_apply
        self.lpips_apply = lpips_apply
        self.decoder = None
        if decoder_config is not None and decode_apply is None:
            from panacea_tpu_torch.registry import instantiate_from_config

            # the reference's init_decoder drops the encoder tower; the
            # autoencoder's own loss config is not built, as in the engine
            params = {k: v for k, v in dict(decoder_config.get("params") or {}).items()
                      if k != "lossconfig"}
            self.decoder = instantiate_from_config(dict(decoder_config, params=params))
            if hasattr(self.decoder, "encoder"):
                del self.decoder.encoder

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.decode_apply is not None:
            return self.decode_apply(z)
        if self.decoder is None:
            raise ValueError("LatentLPIPS needs decoder_config or decode_apply for its "
                             "perceptual terms")
        # the port's autoencoder is channels-last
        return self.decoder.decode(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    @staticmethod
    def _resize_like(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        if img.shape[2:] == ref.shape[2:]:
            return img
        return resize(img, tuple(img.shape[:2]) + tuple(ref.shape[2:]), "cubic")

    def forward(self, latent_inputs: torch.Tensor, latent_predictions: torch.Tensor,
                image_inputs: Optional[torch.Tensor] = None,
                split: str = "train") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        log: Dict[str, torch.Tensor] = {}
        l2 = (latent_inputs - latent_predictions) ** 2
        log[f"{split}/latent_l2_loss"] = l2.mean().detach()
        loss = l2
        recon = None
        if self.perceptual_weight > 0.0:
            recon = self._decode(latent_predictions)
            p = self.lpips_apply(self._decode(latent_inputs), recon)
            loss = self.latent_weight * l2.mean() + self.perceptual_weight * p.mean()
            log[f"{split}/perceptual_loss"] = p.mean().detach()
        if self.perceptual_weight_on_inputs > 0.0:
            if recon is None:
                recon = self._decode(latent_predictions)
            if self.scale_input_to_tgt_size:
                image_inputs = self._resize_like(image_inputs, recon)
            elif self.scale_tgt_to_input_size:
                recon = self._resize_like(recon, image_inputs)
            p2 = self.lpips_apply(image_inputs, recon)
            loss = loss + self.perceptual_weight_on_inputs * p2.mean()
            log[f"{split}/perceptual_loss_on_inputs"] = p2.mean().detach()
        return loss, log


class GeneralLPIPSWithDiscriminator(nn.Module):
    """L1 reconstruction + LPIPS + KL + adversarial loss
    (losses/__init__.py:19-251). The caller owns both networks and their
    optimisers; the adversarial terms count from step ``disc_start`` on."""

    def __init__(self, disc_start: int = 50001, kl_weight: float = 1e-6,
                 disc_weight: float = 0.5, perceptual_weight: float = 1.0,
                 disc_loss: str = "hinge", lpips_apply: Optional[Callable] = None):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"unknown disc_loss {disc_loss!r}")
        self.disc_start = disc_start
        self.kl_weight = kl_weight
        self.disc_weight = disc_weight
        self.perceptual_weight = perceptual_weight
        self.d_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.lpips_apply = lpips_apply

    def _disc_on(self, global_step: int) -> float:
        return 1.0 if global_step >= self.disc_start else 0.0

    def generator_loss(self, inputs, reconstructions, mean, logvar, disc_logits_fake,
                       global_step: int, adaptive_w=1.0):
        """Returns (total, {"nll", "kl", "g_loss"})."""
        rec = (inputs - reconstructions).abs()
        if self.lpips_apply is not None and self.perceptual_weight > 0:
            p = self.lpips_apply(inputs, reconstructions)
            rec = rec + self.perceptual_weight * p.reshape((-1,) + (1,) * (rec.ndim - 1))
        nll = rec.mean()
        kl = kl_divergence(mean, logvar).mean()
        g_loss = -disc_logits_fake.mean()
        total = (nll + self.kl_weight * kl
                 + self._disc_on(global_step) * self.disc_weight * adaptive_w * g_loss)
        return total, {"nll": nll, "kl": kl, "g_loss": g_loss}

    def discriminator_loss(self, logits_real, logits_fake, global_step: int) -> torch.Tensor:
        return self._disc_on(global_step) * self.d_loss(logits_real, logits_fake)
