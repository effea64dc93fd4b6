"""GeneralConditioner and the embedders of the generation path (counterpart
of ``panacea_tpu/models/conditioner.py``: ``IdentityEncoder``,
``VAEEmbedder`` and ``GeneralConditioner``, reference modules.py:95-249,
1016-1057).

Outputs are routed to conditioning keys:

  txt             -> 'crossattn'  (B, 77, 1024)
  cond_img        -> 'cond_feat'  (B*T, H, W, 19)  BEV-layout hint, passed through
  final_cond_zero -> 'concat'     (B*T, h, w, 4)   VAE latents of the cond frames
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

from panacea_tpu_torch.registry import instantiate_from_config


def _flatten_bt(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, H, W, C)"""
    return x.reshape((-1,) + tuple(x.shape[2:])) if x.ndim == 5 else x


class IdentityEncoder(nn.Module):
    """Passes the rendered 19-channel BEV layout through (modules.py:244-249)."""

    def forward(self, x):
        return x


class VAEEmbedder(nn.Module):
    """Encodes the conditioning frames with the engine's frozen VAE
    (modules.py:1016-1057). ``encode_fn`` is set by the engine."""

    def __init__(self, down_blur_factor: int = 1):
        super().__init__()
        if down_blur_factor != 1:
            raise NotImplementedError("VAEEmbedder down_blur_factor > 1 is not ported")
        self.encode_fn = None

    def forward(self, x):
        if self.encode_fn is None:
            raise RuntimeError("VAEEmbedder is not wired to a first stage")
        return self.encode_fn(x)


class GeneralConditioner(nn.Module):
    """Runs the embedders and routes their outputs by key and rank, and
    applies the training-time ucg dropout (modules.py:95-220): with
    ``apply_ucg``, each embedder whose config sets ``ucg_rate`` > 0 keeps
    each batch row's embedding with probability 1 - ucg_rate and zeroes it
    otherwise (conditioner.py:530-535 of the JAX package), one Bernoulli
    draw per row from ``generator``, or the keep mask injected in
    ``ucg_keep[input_key]``. ``ucg_rate`` and ``is_trainable`` are read from
    each embedder's config, as the JAX conditioner reads them."""

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
            val = batch[key]
            if key in ("final_cond_zero", "cond_img"):
                val = _flatten_bt(torch.as_tensor(val, dtype=torch.float32, device=device))
            emb = embedder(val)
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
