"""Config-driven component registry of the port.

Config blocks have the reference's form ``{target: <dotted.path>, params:
{...}}``. The alias table maps the reference ``sgm.*`` targets that this
port implements onto its own classes, so ``configs.INFERENCE_NUSCENES``,
``configs.TINY_CPU`` and ``configs.TINY_STAGE1`` instantiate unchanged, and
the JAX package's perception detector targets (``StreamPETRWindow``,
``StreamPETR`` and the PETR drivers) onto the port's, so the perception
recipes of ``configs.PERCEPTION`` do too, and the VAE's
training losses (LPIPS, the discriminator and its losses) and the data
module (``DataModuleFromConfig``). Of the JAX package's aliases only
``torch.nn.Identity`` and ``torch.optim.AdamW`` have none: the engine
drops the autoencoder's ``lossconfig`` and builds its optimiser itself. An
unknown target raises.
"""

from __future__ import annotations

import importlib
from typing import Any, Mapping

_P = "panacea_tpu_torch"

_SGM_TO_LOCAL = {
    "sgm.models.diffusion.DiffusionEngine3D": f"{_P}.models.engine.DiffusionEngine3D",
    "sgm.modules.diffusionmodules.denoiser.Denoiser": f"{_P}.diffusion.denoiser.Denoiser",
    "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser":
        f"{_P}.diffusion.denoiser.DiscreteDenoiser",
    **{f"sgm.modules.diffusionmodules.denoiser_weighting.{n}": f"{_P}.diffusion.weighting.{n}"
       for n in ("UnitWeighting", "EDMWeighting", "VWeighting", "EpsWeighting")},
    **{f"sgm.modules.diffusionmodules.denoiser_scaling.{n}": f"{_P}.diffusion.scaling.{n}"
       for n in ("EDMScaling", "EpsScaling", "VScaling")},
    **{f"sgm.modules.diffusionmodules.discretizer.{n}": f"{_P}.diffusion.discretization.{n}"
       for n in ("LegacyDDPMDiscretization", "EDMDiscretization")},
    "sgm.modules.diffusionmodules.guiders.VanillaCFG": f"{_P}.diffusion.guiders.VanillaCFG",
    "sgm.modules.diffusionmodules.guiders.IdentityGuider":
        f"{_P}.diffusion.guiders.IdentityGuider",
    "sgm.modules.diffusionmodules.sampling_utils.NoDynamicThresholding":
        f"{_P}.diffusion.guiders.NoDynamicThresholding",
    **{f"sgm.modules.diffusionmodules.sampling.{n}": f"{_P}.diffusion.samplers.{n}"
       for n in ("EulerEDMSampler", "HeunEDMSampler", "EulerAncestralSampler",
                 "DPMPP2SAncestralSampler", "DPMPP2MSampler", "LinearMultistepSampler")},
    **{f"sgm.modules.distributions.distributions.{n}": f"{_P}.diffusion.distributions.{n}"
       for n in ("DiagonalGaussianDistribution", "DiracDistribution")},
    "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer":
        f"{_P}.diffusion.distributions.DiagonalGaussianRegularizer",
    "sgm.modules.diffusionmodules.controlmodel.ControlledUNetModel3D":
        f"{_P}.models.controlnet.ControlledUNetModel3D",
    "sgm.modules.diffusionmodules.controlmodel.ControlNet3D":
        f"{_P}.models.controlnet.ControlNet3D",
    "sgm.modules.diffusionmodules.openaimodel.UNetModel3D": f"{_P}.models.unet.UNetModel3D",
    "sgm.modules.GeneralConditioner": f"{_P}.models.conditioner.GeneralConditioner",
    "sgm.modules.encoders.modules.GeneralConditioner":
        f"{_P}.models.conditioner.GeneralConditioner",
    "sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder":
        f"{_P}.models.clip.FrozenOpenCLIPEmbedder",
    **{f"sgm.modules.encoders.modules.{n}": f"{_P}.models.clip.{n}"
       for n in ("FrozenCLIPEmbedder", "FrozenOpenCLIPImageEmbedder")},
    **{f"sgm.modules.encoders.modules.{n}": f"{_P}.models.conditioner.{n}"
       for n in ("IdentityEncoder", "VAEEmbedder", "FrozenT5Embedder",
                 "ConcatTimestepEmbedderND", "ClassEmbedder", "DownSampler",
                 "FrozenByT5Embedder", "FrozenOpenCLIPEmbedder2", "ClassEmbedderForMultiCond",
                 "FrozenCLIPT5Encoder", "SpatialRescaler", "LowScaleEncoder",
                 "GaussianEncoder")},
    "sgm.models.autoencoder.AutoencoderKL": f"{_P}.models.vae.AutoencoderKL",
    "sgm.models.autoencoder.AutoencoderKLInferenceWrapper":
        f"{_P}.models.vae.AutoencoderKLInferenceWrapper",
    "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling":
        f"{_P}.diffusion.sigma_sampling.EDMSampling",
    "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling":
        f"{_P}.diffusion.sigma_sampling.DiscreteSampling",
    "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss":
        f"{_P}.diffusion.loss.StandardDiffusionLoss",
    "sgm.data.nuscenes_video.nuscenes_datasets_video.MyDataset":
        f"{_P}.data.nuscenes.dataset.NuScenesVideoDataset",
    "sgm.data.dataset.DataModuleFromConfig": f"{_P}.data.loader.DataModuleFromConfig",
    **{f"sgm.modules.autoencoding.losses.{n}": f"{_P}.losses.vae_losses.{n}"
       for n in ("LatentLPIPS", "GeneralLPIPSWithDiscriminator")},
    "sgm.modules.autoencoding.lpips.loss.lpips.LPIPS": f"{_P}.losses.lpips.LPIPS",
    "sgm.modules.autoencoding.lpips.model.model.NLayerDiscriminator":
        f"{_P}.losses.vae_losses.NLayerDiscriminator",
    **{f"panacea_tpu.perception.detector.{n}": f"{_P}.perception.detector.{n}"
       for n in ("StreamPETRWindow", "StreamPETR", "PetrWindow3D", "Petr3D", "Petr3DM",
                 "Petr3DP", "Sparse4D", "Sparse4Dv2", "Sparse4Dv3")},
    "sgm.lr_scheduler.LambdaLinearScheduler": f"{_P}.utils.lr_schedule.LambdaLinearScheduler",
    "sgm.lr_scheduler.LambdaWarmUpCosineScheduler":
        f"{_P}.utils.lr_schedule.LambdaWarmUpCosineScheduler",
    "sgm.lr_scheduler.LambdaWarmUpCosineScheduler2":
        f"{_P}.utils.lr_schedule.LambdaWarmUpCosineScheduler2",
}


def resolve_target(target: str) -> Any:
    """Resolve a reference ``sgm.*`` target, or a dotted path inside this
    package, to its class. Anything else raises ``KeyError``."""
    path = _SGM_TO_LOCAL.get(target)
    if path is None:
        if not target.startswith(_P + "."):
            raise KeyError(f"no port of config target {target!r}")
        path = target
    module_path, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module_path), name)


def instantiate_from_config(config: Mapping[str, Any], **extra) -> Any:
    """``config['target'](**config['params'], **extra)`` (reference
    sgm/util.py:168-174)."""
    if not isinstance(config, Mapping) or "target" not in config:
        raise KeyError(f"expected key `target` to instantiate, got: {config!r}")
    params = dict(config.get("params", {}) or {})
    params.update(extra)
    return resolve_target(config["target"])(**params)
