"""DiffusionEngine3D (counterpart of ``panacea_tpu/models/engine.py``;
reference sgm/models/diffusion.py:29-377).

An ``nn.Module`` whose parameter names are the reference checkpoint's:
``model.diffusion_model.*`` (UNet, with the ControlNet under ``.controlnet``),
``first_stage_model.*`` (VAE) and ``conditioner.embedders.N.model.*`` (text
tower). The entry points are ``log_images`` (conditioning, VAE encode,
Euler-EDM sampling with CFG, VAE decode) and, for training, ``train_loss``
and ``loss`` with ``set_trainable`` (the freeze mask).

Device and precision:
  * ``device=None`` means CUDA; without a CUDA device the constructor
    raises. Tests pass ``device="cpu"``.
  * The UNet and ControlNet compute in ``dtype``: bf16 on the card by
    default, fp32 on the CPU. GroupNorms reduce in fp32. The network output
    goes back to fp32 before the sampler.
  * The VAE and the text tower stay fp32. The VAE is the reference's fp32
    island (disable_first_stage_autocast); the text tower runs once per clip.
  * Training keeps the network's parameters in ``dtype`` and their fp32
    masters outside the engine (``train_step.TrainState``): the optimizer
    and the EMA act on the fp32 masters, whose bf16 copies the network
    computes with, as the JAX package keeps fp32 parameters and computes in
    bf16 (its gradients are the bf16 cotangents of that cast, in fp32).
  * ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` are False while the entry points
    (``log_images``, ``sample``, ``encode_first_stage``,
    ``decode_first_stage``, ``train_loss``) run, and the caller's values
    come back after:
    the flags touch only the fp32 parts (VAE, text tower, sampler
    arithmetic), which are fp32 to stay close to the fp32 reference, and
    TF32 would cut them to a 10-bit mantissa. The bf16 UNet is unaffected.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from panacea_tpu_torch.models.conditioner import VAEEmbedder
from panacea_tpu_torch.models.layers import GroupNorm
from panacea_tpu_torch.models.clip import (CLIPAttention, CLIPTextTransformer,
                                           CLIPVisionTransformer)
from panacea_tpu_torch.registry import instantiate_from_config, resolve_target

# engine config keys of the reference yaml that the port does not use (the
# trainer's --use_ema decides about the EMA)
_COMPAT_KEYS = frozenset({"use_ema", "disable_first_stage_autocast", "wrapper_type",
                          "log_keys"})
FREEZE_TYPES = ("none", "spatial")
# checkpoint entries that are not weights of the generation path
# (panacea_tpu/utils/convert.py:504-509): EMA shadows, loss buffers, the
# CLIP causal-mask buffer and its pooled-output projection
_NON_WEIGHT_PREFIXES = ("model_ema.", "loss_fn.")
_NON_WEIGHT_SUFFIXES = (".attn_mask", ".logit_scale", ".text_projection")


def is_non_weight(key: str) -> bool:
    return key.startswith(_NON_WEIGHT_PREFIXES) or key.endswith(_NON_WEIGHT_SUFFIXES)


def resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("DiffusionEngine3D runs on CUDA by default and no CUDA "
                               "device is present; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in full fp32 within the block; the
    caller's TF32 settings are restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _Wrapper(nn.Module):
    """Holds the network under the reference's ``model.diffusion_model`` name."""

    def __init__(self, diffusion_model: nn.Module):
        super().__init__()
        self.diffusion_model = diffusion_model


class DiffusionEngine3D(nn.Module):
    def __init__(self, network_config, denoiser_config, first_stage_config,
                 conditioner_config, sampler_config, scale_factor: float = 1.0,
                 share_noise_level: float = 0.0, freeze_type: str = "none",
                 loss_fn_config=None, device=None, dtype: Optional[torch.dtype] = None,
                 **compat):
        super().__init__()
        unknown = set(compat) - _COMPAT_KEYS
        if unknown:
            raise TypeError(f"DiffusionEngine3D: unknown config keys {sorted(unknown)}")
        if freeze_type not in FREEZE_TYPES:
            raise ValueError(f"freeze_type {freeze_type!r} not in {FREEZE_TYPES}")
        self.freeze_type = freeze_type
        self.loss_fn = instantiate_from_config(loss_fn_config) if loss_fn_config else None
        device = resolve_device(device)
        self.device = device
        self.dtype = dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)
        self.scale_factor = float(scale_factor)
        self.share_noise_level = float(share_noise_level)

        self.denoiser = instantiate_from_config(denoiser_config)
        self.sampler = instantiate_from_config(sampler_config)

        net_params = dict(network_config.get("params", {}) or {})
        self.num_frames = int(net_params.get("num_frames", 8))
        fs_params = dict(first_stage_config.get("params", {}) or {})
        fs_params.pop("lossconfig", None)
        # built on the meta device, then given (uninitialised) storage on
        # `device`: init_weights or load_state_dict fills it
        with torch.device("meta"):
            net = resolve_target(network_config["target"])(**net_params)
            self.model = _Wrapper(net)
            self.first_stage_model = resolve_target(first_stage_config["target"])(**fs_params)
            self.conditioner = instantiate_from_config(conditioner_config)
        self.to_empty(device=device)
        self.model.to(self.dtype)
        if device.type == "cuda":
            # cuDNN then runs NHWC kernels on the channels-last activations
            self.model.to(memory_format=torch.channels_last)
            self.first_stage_model.to(memory_format=torch.channels_last)
        for emb in self.conditioner.embedders:
            if isinstance(emb, VAEEmbedder):
                emb.encode_fn = self.encode_first_stage

    # ------------------------------------------------------------ weights
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, zero_init_std: float = 0.0) -> None:
        """Random weights from ``generator`` (on the engine's device):
        lecun-normal matrices and convolutions, zero biases, unit norms.
        The parameters the JAX modules zero-initialise (output projections,
        temporal convs, ControlNet zero convs, ...) are zero, or drawn with
        std ``zero_init_std`` where that is > 0, so that every branch of a
        random network computes something."""
        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * std)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                if getattr(m, "zero_init", False):
                    normal(m.weight, zero_init_std)
                else:
                    normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, 0.02)
            elif isinstance(m, CLIPAttention):
                normal(m.in_proj_weight, 1.0 / math.sqrt(m.in_proj_weight.shape[1]))
                m.in_proj_bias.zero_()
            elif isinstance(m, CLIPTextTransformer):
                normal(m.positional_embedding, 0.01)
            elif isinstance(m, CLIPVisionTransformer):
                for t in (m.class_embedding, m.positional_embedding, m.proj):
                    normal(t, 0.02)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Takes the reference checkpoint's names; its known non-weights
        (EMA shadows, loss buffers, CLIP mask and pooled projection) are
        dropped first, so the reference state dict loads with strict=True."""
        sd = {k: v for k, v in state_dict.items() if not is_non_weight(k)}
        return super().load_state_dict(sd, strict=strict, assign=assign)

    # -------------------------------------------------------- first stage
    @torch.no_grad()
    @no_tf32()
    def encode_first_stage(self, x, generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, H, W, 3) in [-1, 1] -> scaled latents, one frame at a time
        in fp32; samples the posterior (autoencoder.py:371-374) from
        ``generator``, by default a fresh one seeded 0 (as the JAX engine's
        default key), or with the injected standard normals ``noise``
        (N, h, w, 4)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        elif generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        z = [self.first_stage_model.encode(x[i:i + 1], generator,
                                           noise=None if noise is None else noise[i:i + 1])
             for i in range(x.shape[0])]
        return self.scale_factor * torch.cat(z)

    @torch.no_grad()
    @no_tf32()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images, fp32, one frame at a time (engine.py:218-227)."""
        z = z.float() / self.scale_factor
        return torch.cat([self.first_stage_model.decode(z[i:i + 1]) for i in range(z.shape[0])])

    # ------------------------------------------------------------ network
    def network_fn(self, x: torch.Tensor, c_noise: torch.Tensor,
                   cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Concat the cond-frame latent onto the noisy latent, run the
        ControlNet and the UNet (wrappers.py:37-70) with ``cond["vector"]``,
        per clip, as the class or vector condition; fp32 out."""
        if "concat" in cond:
            x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
        net = self.model.diffusion_model
        kwargs = {}
        if getattr(net, "controlnet", None) is not None:
            if "guided_hint" in cond:
                kwargs["guided_hint"] = cond["guided_hint"]
            else:
                kwargs["hint"] = cond.get("cond_feat")
        if "vector" in cond:
            kwargs["y"] = cond["vector"]
        return net(x, c_noise, cond["crossattn"].to(self.dtype), **kwargs).float()

    # ----------------------------------------------------------- sampling
    @torch.no_grad()
    @no_tf32()
    def sample(self, cond: Dict[str, torch.Tensor], uc: Optional[Dict[str, torch.Tensor]] = None,
               batch_size: int = 16, shape=(32, 384, 4),
               generator: Optional[torch.Generator] = None, num_steps: Optional[int] = None,
               noise: Optional[torch.Tensor] = None, share_noise_frame: int = -1,
               sampler_noise=None, return_trajectory: bool = False):
        """Shared-noise init (diffusion.py:244-249) and the sampler loop.

        ``noise`` injects the base gaussian noise (before the shared-noise
        bias); ``sampler_noise`` the sampler's per-step noise (churn,
        ancestral steps), which it otherwise draws from ``generator`` after
        the base noise. ``share_noise_frame`` picks the flattened concat
        frame that anchors the bias; -1 is the reference's choice. The
        ControlNet hint stack runs once here, outside the step loop."""
        def prepare(c):
            if c is None:
                return None
            c = dict(c)
            for k in ("cond_feat", "crossattn"):
                if k in c:
                    c[k] = c[k].to(self.dtype)
            net = self.model.diffusion_model
            if getattr(net, "controlnet", None) is not None and "cond_feat" in c:
                c["guided_hint"] = net.encode_hint(c.pop("cond_feat"))
            return c

        cond, uc = prepare(cond), prepare(uc)
        if noise is not None:
            randn = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        else:
            randn = torch.randn((batch_size,) + tuple(shape), generator=generator,
                                device=self.device)
        if self.share_noise_level > 0.0:
            cf = cond["concat"][share_noise_frame].float()
            cf_seq = cf[None].expand((self.num_frames,) + cf.shape)
            randn = randn + cf_seq.repeat(batch_size // self.num_frames, 1, 1, 1) \
                * self.share_noise_level

        def denoiser(x, sigma, c):
            return self.denoiser(self.network_fn, x, sigma, c)

        kw = {"return_trajectory": True} if return_trajectory else {}
        return self.sampler(denoiser, randn, cond, uc=uc, num_steps=num_steps,
                            generator=generator, noise=sampler_noise, **kw)

    # --------------------------------------------------------- log_images
    @torch.no_grad()
    @no_tf32()
    def log_images(self, batch: Dict[str, Any], N: int = 8,
                   generator: Optional[torch.Generator] = None, **kwargs) -> Dict[str, torch.Tensor]:
        """Mirror of diffusion.py:302-377: c/uc (empty prompts for uc),
        encode, sample, decode. ``batch`` holds numpy arrays: ``jpg``
        (B, T, H, W, 3) in [-1, 1], ``cond_img``, ``final_cond_zero`` and the
        prompts ``txt``. Images come back channels-last, (B*T, H, W, C)."""
        log: Dict[str, torch.Tensor] = {}
        x = torch.as_tensor(np.asarray(batch["jpg"]), dtype=torch.float32,
                            device=self.device)
        N = min(x.shape[0], N)
        x = x[:N]
        x_flat = x.reshape((-1,) + tuple(x.shape[2:]))
        log["inputs"] = x_flat
        if "cond_img" in batch:
            ci = torch.as_tensor(np.asarray(batch["cond_img"])[:N], dtype=torch.float32,
                                 device=self.device)
            log["cond_img"] = ci.reshape((-1,) + tuple(ci.shape[2:]))

        batch_uc = dict(batch)
        batch_uc["txt"] = ["" for _ in batch["txt"]]
        c, uc = self.conditioner.get_unconditional_conditioning(batch, batch_uc, self.device)
        z = self.encode_first_stage(x_flat, generator=generator)
        log["reconstructions"] = self.decode_first_stage(z)
        if "cond_feat" in c:
            log["control"] = c["cond_feat"] * 2.0 - 1.0
        n_frames = N * self.num_frames
        for k in list(c):
            cut = n_frames if k in ("concat", "cond_bev_feat", "cond_feat") else N
            c[k], uc[k] = c[k][:cut], uc[k][:cut]
        samples = self.sample(c, uc=uc, batch_size=n_frames, shape=tuple(z.shape[1:]),
                              generator=generator, **kwargs)
        log["samples"] = self.decode_first_stage(samples)
        return log

    # ------------------------------------------------------------ training
    def trainable_mask(self) -> Dict[str, bool]:
        """Network parameter name -> trained (diffusion.py:107-110):
        ``freeze_type='spatial'`` trains exactly the parameters with
        ``temporal`` in their name, ``'none'`` all of them."""
        names = (f"model.{n}" for n, _ in self.model.named_parameters())
        return {n: self.freeze_type != "spatial" or "temporal" in n for n in names}

    def set_trainable(self) -> Dict[str, nn.Parameter]:
        """``requires_grad`` from ``trainable_mask``; the VAE and the
        conditioning towers are frozen. Returns the trained parameters by
        name."""
        for p in self.parameters():
            p.requires_grad_(False)
        mask = self.trainable_mask()
        out = {}
        for n, p in self.model.named_parameters():
            if mask[f"model.{n}"]:
                p.requires_grad_(True)
                out[f"model.{n}"] = p
        return out

    @no_tf32()
    def diffusion_loss(self, z: torch.Tensor, cond: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None, **inject) -> torch.Tensor:
        """The mean loss of the clean latents ``z`` under ``loss_fn``, with
        gradients to the trained parameters. ``inject``: ``sigma_rand``,
        ``noise``, ``offset`` for ``StandardDiffusionLoss``."""
        if self.loss_fn is None:
            raise RuntimeError("DiffusionEngine3D: training needs a loss_fn")
        return self.loss_fn(self.network_fn, self.denoiser, cond, z, generator=generator,
                            **inject).mean()

    def train_loss(self, jpg, cond: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   posterior_noise: Optional[torch.Tensor] = None, **inject) -> torch.Tensor:
        """The training loss (shared_step, diffusion.py:159-166; JAX
        ``train_loss``, engine.py:485-495): jpg (B, T, H, W, 3) is encoded
        without gradients (posterior drawn from ``generator`` or injected),
        the network runs with gradients, the mean loss comes back. ``cond``
        is precomputed: conditioning is frozen in Panacea."""
        x = torch.as_tensor(jpg, dtype=torch.float32, device=self.device)
        x = x.reshape((-1,) + tuple(x.shape[2:]))
        z = self.encode_first_stage(x, generator=generator, noise=posterior_noise)
        return self.diffusion_loss(z, cond, generator=generator, **inject)

    def loss(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
             ucg_keep=None) -> torch.Tensor:
        """Host-level loss (engine.py:497-505): conditioning with ucg
        dropout, then ``train_loss``."""
        with torch.no_grad():
            cond = self.conditioner(batch, self.device, generator=generator, apply_ucg=True,
                                    ucg_keep=ucg_keep)
        return self.train_loss(batch["jpg"], cond, generator=generator)
