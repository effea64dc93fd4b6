"""GeneralConditioner and the embedders (counterpart of
``panacea_tpu/models/conditioner.py``, reference modules.py:95-1057).

Outputs are routed to conditioning keys; on the generation path:

  txt             -> 'crossattn'  (B, 77, 1024)
  cond_img        -> 'cond_feat'  (B*T, H, W, 19)  BEV-layout hint, passed through
  final_cond_zero -> 'concat'     (B*T, h, w, 4)   VAE latents of the cond frames

Any other embedder's output goes by its rank: 2 -> 'vector', 3 ->
'crossattn', 4 and 5 -> 'concat'. An embedder that returns a list (or a
tuple, such as a text tower's tokens and pooled vector) feeds each entry
to its own key.

Images are channels-last. Resizes follow ``jax.image.resize``
(``ops/resize.py``). Where the JAX embedder draws random numbers, the port
takes them injected or from a ``torch.Generator``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from panacea_tpu_torch.diffusion.util import make_beta_schedule, timestep_embedding
from panacea_tpu_torch.models.clip import FrozenCLIPEmbedder, FrozenOpenCLIPEmbedder
from panacea_tpu_torch.models.layers import Conv2d, zero_init
from panacea_tpu_torch.models.vae import Encoder
from panacea_tpu_torch.ops.resize import resize
from panacea_tpu_torch.registry import instantiate_from_config


def _flatten_bt(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, H, W, C)"""
    return x.reshape((-1,) + tuple(x.shape[2:])) if x.ndim == 5 else x


def _device_of(module: nn.Module, default="cpu") -> torch.device:
    p = next(module.parameters(), None)
    return p.device if p is not None else torch.device(default)


def _tensor(v, **kw) -> torch.Tensor:
    """A tensor of ``v``; a numpy array is copied (it may be read-only)."""
    return torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v, **kw)


def _normal(shape, like: torch.Tensor, noise, generator) -> torch.Tensor:
    """Standard normals: ``noise`` injected, else drawn from ``generator``
    (a fresh one seeded 0 by default, as the JAX embedders' default key)."""
    if noise is not None:
        return _tensor(noise, dtype=like.dtype, device=like.device)
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


class IdentityEncoder(nn.Module):
    """Passes the rendered 19-channel BEV layout through (modules.py:244-249)."""

    def forward(self, x):
        return x


class VAEEmbedder(nn.Module):
    """Encodes the conditioning frames with the engine's frozen VAE
    (modules.py:1016-1057). ``encode_fn`` is set by the engine.

    ``down_blur_factor`` > 1 gives the JAX package's result, the frames
    unchanged: its blur computes a downsized copy that it never uses and
    then resizes the frames to their own shape (JAX conditioner.py:71-79)."""

    def __init__(self, down_blur_factor: int = 1):
        super().__init__()
        if down_blur_factor < 1:
            raise ValueError(f"down_blur_factor {down_blur_factor} < 1")
        self.down_blur_factor = down_blur_factor
        self.encode_fn = None

    def forward(self, x):
        if self.encode_fn is None:
            raise RuntimeError("VAEEmbedder is not wired to a first stage")
        return self.encode_fn(x)


class ConcatTimestepEmbedderND(nn.Module):
    """Embeds N scalar conditions (e.g. original_size) with sinusoidal
    timestep embeddings and flattens them (modules.py:978)."""

    def __init__(self, outdim: int = 256):
        super().__init__()
        self.outdim = outdim

    def forward(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.ndim == 1:
            x = x[:, None]
        b, dims = x.shape
        return timestep_embedding(x.reshape(-1), self.outdim).reshape(b, dims * self.outdim)


class ClassEmbedder(nn.Module):
    """A class-id embedding table (modules.py:268)."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, add_sequence_dim: bool = False):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)
        self.add_sequence_dim = add_sequence_dim

    def forward(self, c):
        emb = self.embedding(torch.as_tensor(c, device=self.embedding.weight.device).long())
        return emb[:, None, :] if self.add_sequence_dim else emb


class ClassEmbedderForMultiCond(ClassEmbedder):
    """The batch-dict form of ClassEmbedder (modules.py:290-300): returns
    the batch with ``batch[key]`` embedded in place, a single-element list
    unwrapped and wrapped again."""

    def forward(self, batch, key=None):
        out = dict(batch)
        v = out[key]
        islist = isinstance(v, list)
        emb = super().forward(v[0] if islist else v)
        out[key] = [emb] if islist else emb
        return out


class FrozenOpenCLIPEmbedder2(FrozenOpenCLIPEmbedder):
    """OpenCLIP text encoder with a layer choice and EOT pooling
    (modules.py:450-607; JAX conditioner.py:250-296): returns the chosen
    layer's tokens (ln_final applied) and, where ``always_return_pooled``,
    also the EOT token's state times ``text_projection``, which is loaded
    from a state dict (``load_text_projection``) and raises when missing."""

    def __init__(self, *args, always_return_pooled: bool = False, legacy: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.return_pooled = always_return_pooled
        self.legacy = legacy
        self.text_projection: Optional[torch.Tensor] = None   # (width, proj)

    def load_text_projection(self, state_dict, prefix: str = "") -> bool:
        """Take ``<prefix>...text_projection`` (a matrix) from
        ``state_dict``; ``prefix`` keeps a second tower's projection out.
        Returns whether one was found."""
        for k, v in state_dict.items():
            if k.startswith(prefix) and k.endswith("text_projection") and v.ndim == 2:
                self.text_projection = torch.as_tensor(
                    np.asarray(v) if not torch.is_tensor(v) else v, dtype=torch.float32,
                    device=self.model.positional_embedding.device)
                return True
        return False

    def forward(self, texts):
        tokens = self.tokens(texts)
        z = self.model(tokens).float()
        if not self.return_pooled:
            return z
        if self.text_projection is None:
            raise ValueError("FrozenOpenCLIPEmbedder2.always_return_pooled needs "
                             "text_projection, loaded from converted weights")
        eot = tokens.argmax(dim=-1)   # the first maximum, as jnp.argmax
        return z, z[torch.arange(z.shape[0], device=z.device), eot] @ self.text_projection


class DownSampler(nn.Module):
    """The conv hint downsampler (JAX conditioner.py:138-183): a rendered
    layout at image resolution to /8 features of ``model_input_channels``.
    Six 3x3 convs (strides 1, 2, 2, 2, 1, 1) with SiLUs sit at ``net``'s
    even indices 0-10, the zero-init output conv at 12."""

    def __init__(self, dims: int = 2, model_input_channels: int = 4, in_channels: int = 13):
        super().__init__()
        widths = [in_channels, 16, 16, 32, 32, 96, 96]
        layers = []
        for i, stride in enumerate((1, 2, 2, 2, 1, 1)):
            layers += [Conv2d(widths[i], widths[i + 1], 3, stride=stride, padding=1), nn.SiLU()]
        layers.append(zero_init(Conv2d(96, model_input_channels, 3, padding=1)))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(torch.as_tensor(x, dtype=torch.float32, device=_device_of(self)))


class SpatialRescaler(nn.Module):
    """``n_stages`` resizes by ``multiplier`` with ``jax.image.resize``'s
    arithmetic ('area' reads as 'linear', as in the JAX package), then an
    optional kxk ``channel_mapper`` conv, bias-free by default
    (modules.py:823-880). ``wrap_video`` folds (B, T, H, W, C) into frames
    for the resizes."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels=None, bias: bool = False,
                 wrap_video: bool = False, kernel_size: int = 1, remap_output: bool = False):
        super().__init__()
        if n_stages < 0:
            raise ValueError(f"n_stages {n_stages} < 0")
        if method not in ("nearest", "linear", "bilinear", "trilinear", "bicubic", "area"):
            raise ValueError(f"unknown method {method!r}")
        self.n_stages = n_stages
        self.method = {"area": "linear"}.get(method, method)
        self.multiplier = multiplier
        self.wrap_video = wrap_video
        if out_channels is not None or remap_output:
            self.channel_mapper = Conv2d(in_channels, out_channels or in_channels, kernel_size,
                                         padding=kernel_size // 2, bias=bias)

    def forward(self, x):
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=x.device if torch.is_tensor(x) else _device_of(self))
        shape = tuple(x.shape)
        video = self.wrap_video and x.ndim == 5
        if video:
            b, t = x.shape[:2]
            x = x.reshape((b * t,) + tuple(x.shape[2:]))
        for _ in range(self.n_stages):
            n, h, w, c = x.shape
            x = resize(x, (n, int(h * self.multiplier), int(w * self.multiplier), c),
                       self.method)
        if video:
            x = x.reshape((b, t) + tuple(x.shape[1:]))
        if hasattr(self, "channel_mapper"):   # per frame of a video, as flax's conv
            x = self.channel_mapper(x.reshape((-1,) + tuple(x.shape[-3:])))
            x = x.reshape(shape[:-3] + tuple(x.shape[-3:]))
        return x

    def encode(self, x):
        return self(x)


class LowScaleEncoder(nn.Module):
    """Low-resolution conditioning with DDPM noise augmentation
    (modules.py:883-994): the first stage's posterior mean times
    ``scale_factor``, ``q_sample`` at a noise level t in [0,
    ``max_noise_level``), then a nearest resize to ``output_size``.
    Returns (z, t). t and the noise are injected or drawn from
    ``generator``."""

    def __init__(self, model_config, linear_start: float, linear_end: float,
                 timesteps: int = 1000, max_noise_level: int = 250, output_size: int = 64,
                 scale_factor: float = 1.0):
        super().__init__()
        self.model = instantiate_from_config(model_config)
        self.max_noise_level = max_noise_level
        self.out_size = output_size
        self.scale_factor = scale_factor
        betas = make_beta_schedule("linear", timesteps, linear_start=linear_start,
                                   linear_end=linear_end)
        ac = np.cumprod(1.0 - betas, axis=0).astype(np.float32)
        self.register_buffer("sqrt_alphas_cumprod", torch.from_numpy(np.sqrt(ac)),
                             persistent=False)
        self.register_buffer("sqrt_one_minus_alphas_cumprod",
                             torch.from_numpy(np.sqrt(1.0 - ac)), persistent=False)

    def q_sample(self, x, t, noise):
        a = self.sqrt_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        s = self.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        return a * x + s * noise

    def forward(self, x, t=None, noise=None, generator: Optional[torch.Generator] = None):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.sqrt_alphas_cumprod.device)
        z = self.model.encode(x) * self.scale_factor
        if t is None:
            if generator is None:
                generator = torch.Generator(device=z.device).manual_seed(0)
            t = torch.randint(0, self.max_noise_level, (z.shape[0],), generator=generator,
                              device=z.device)
        t = _tensor(t, device=z.device).long()
        z = self.q_sample(z, t, _normal(z.shape, z, noise, generator))
        if self.out_size is not None:
            n, _, _, c = z.shape
            z = resize(z, (n, self.out_size, self.out_size, c), "nearest")
        return z, t

    def decode(self, z):
        return self.model.decode(z / self.scale_factor)


class GaussianEncoder(Encoder):
    """A VAE encoder whose diagonal Gaussian is sampled, with its KL as a log
    (modules.py:997-1014): returns (log, z), z flattened to (B, H*W, C)
    where ``flatten_output``. The log-variance is clipped to [-30, 20]; the
    standard normals are injected or drawn from ``generator``."""

    def __init__(self, weight: float = 1.0, flatten_output: bool = True, **encoder_kwargs):
        encoder_kwargs.pop("dtype", None)
        super().__init__(**encoder_kwargs)
        self.weight = weight
        self.flatten_output = flatten_output

    def forward(self, x, noise=None, generator: Optional[torch.Generator] = None):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.conv_in.weight.device)
        mean, logvar = super().forward(x).chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        z = mean + torch.exp(0.5 * logvar) * _normal(mean.shape, mean, noise, generator)
        kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(dim=(1, 2, 3))
        log = {"kl_loss": kl.mean(), "loss": kl.mean(), "weight": self.weight}
        if self.flatten_output:
            n, h, w, c = z.shape
            z = z.reshape(n, h * w, c)
        return log, z


class FrozenT5Embedder(nn.Module):
    """A T5 text encoder from ``transformers`` (modules.py:302; JAX
    conditioner.py:186-216). ``version`` must be a local directory that
    holds the tokenizer and the weights: nothing is downloaded. Without one,
    the first call raises before ``transformers`` is asked for anything."""

    def __init__(self, version: str = "google/t5-v1_1-xxl", device=None, max_length: int = 77,
                 freeze: bool = True):
        super().__init__()
        self.version = version
        self.max_length = max_length
        self._tok = None
        self._model = None

    def _classes(self):
        from transformers import AutoTokenizer, T5EncoderModel

        return AutoTokenizer, T5EncoderModel

    def _load(self):
        if not os.path.isdir(self.version):
            raise FileNotFoundError(
                f"{type(self).__name__}: no local weights for {self.version!r}; version "
                "must be a directory holding the tokenizer and the encoder's weights "
                "(nothing is downloaded)")
        tok_cls, model_cls = self._classes()
        self._tok = tok_cls.from_pretrained(self.version, local_files_only=True)
        self._model = model_cls.from_pretrained(self.version, local_files_only=True).eval()

    def forward(self, texts):
        if self._model is None:
            self._load()
        batch = self._tok(list(texts), truncation=True, max_length=self.max_length,
                          padding="max_length", return_tensors="pt")
        device = next(self._model.parameters()).device
        return self._model(input_ids=batch["input_ids"].to(device)).last_hidden_state


class FrozenByT5Embedder(FrozenT5Embedder):
    """ByT5 (modules.py:343-380): FrozenT5Embedder with the ByT5 tokenizer."""

    def __init__(self, version: str = "google/byt5-base", device=None, max_length: int = 77,
                 freeze: bool = True):
        super().__init__(version, device, max_length, freeze)

    def _classes(self):
        from transformers import ByT5Tokenizer, T5EncoderModel

        return ByT5Tokenizer, T5EncoderModel


class FrozenCLIPT5Encoder(nn.Module):
    """CLIP-L and T5 (modules.py:795-821): returns [clip_z, t5_z]."""

    def __init__(self, clip_version="openai/clip-vit-large-patch14",
                 t5_version="google/t5-v1_1-xl", device=None, clip_max_length: int = 77,
                 t5_max_length: int = 77):
        super().__init__()
        self.clip_encoder = FrozenCLIPEmbedder(max_length=clip_max_length)
        self.t5_encoder = FrozenT5Embedder(t5_version, device, max_length=t5_max_length)

    def forward(self, texts):
        return [self.clip_encoder(texts), self.t5_encoder(texts)]


class GeneralConditioner(nn.Module):
    """Runs the embedders and routes their outputs by key and rank, and
    applies the training-time ucg dropout (modules.py:95-220): with
    ``apply_ucg``, each embedder whose config sets ``ucg_rate`` > 0 keeps
    each batch row's embedding with probability 1 - ucg_rate and zeroes it
    otherwise (conditioner.py:530-535 of the JAX package), one Bernoulli
    draw per row and output from ``generator``, or the keep mask injected in
    ``ucg_keep[input_key]``. ``ucg_rate`` and ``is_trainable`` are read from
    each embedder's config, as the JAX conditioner reads them.
    ``ClassEmbedderForMultiCond`` is handed the whole batch (JAX
    conditioner.py:511-517)."""

    OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
    KEY2CATDIM = {"vector": -1, "crossattn": -2, "concat": -1}

    def __init__(self, emb_models: List[dict]):
        super().__init__()
        self.embedders = nn.ModuleList()
        self.input_keys = []
        for cfg in emb_models:
            emb = instantiate_from_config(cfg)
            emb.ucg_rate = float(cfg.get("ucg_rate", 0.0))
            emb.is_trainable = bool(cfg.get("is_trainable", False))
            self.embedders.append(emb)
            self.input_keys.append(cfg.get("input_key"))

    def forward(self, batch: Dict[str, Any], device, generator: Optional[torch.Generator] = None,
                apply_ucg: bool = False,
                ucg_keep: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        output: Dict[str, torch.Tensor] = {}
        for key, embedder in zip(self.input_keys, self.embedders):
            if isinstance(embedder, ClassEmbedderForMultiCond):
                emb_out = embedder(batch, key=key)[key]
            else:
                val = batch[key]
                if key in ("final_cond_zero", "cond_img"):
                    val = _flatten_bt(torch.as_tensor(val, dtype=torch.float32, device=device))
                elif isinstance(val, np.ndarray):
                    val = torch.as_tensor(val, device=device)
                emb_out = embedder(val)
            if not isinstance(emb_out, (list, tuple)):
                emb_out = [emb_out]
            for emb in emb_out:
                out_key = "cond_feat" if key == "cond_img" else self.OUTPUT_DIM2KEYS[emb.ndim]
                injected = ucg_keep is not None and key in ucg_keep
                if apply_ucg and embedder.ucg_rate > 0.0 and (generator is not None or injected):
                    if injected:
                        keep = torch.as_tensor(ucg_keep[key], device=emb.device)
                    else:
                        prob = torch.full((emb.shape[0],), 1.0 - embedder.ucg_rate,
                                          device=emb.device)
                        keep = torch.bernoulli(prob, generator=generator)
                    emb = emb * keep.to(emb.dtype).reshape((-1,) + (1,) * (emb.ndim - 1))
                if out_key in output:
                    emb = torch.cat((output[out_key], emb), dim=self.KEY2CATDIM[out_key])
                output[out_key] = emb
        return output

    def get_unconditional_conditioning(self, batch_c, batch_uc, device):
        """c from ``batch_c``, uc from ``batch_uc`` (modules.py:206-220); no
        ucg dropout for either."""
        return self(batch_c, device), self(batch_uc, device)
