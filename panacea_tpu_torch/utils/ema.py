"""Exponential moving average of the trained parameters (counterpart of
``panacea_tpu/utils/ema.py``; reference LitEma, sgm/modules/ema.py:5-86).

The shadows are fp32 tensors updated in place (the JAX package builds a new
tree each step; in place saves a copy of every trained parameter). The decay
is ramped in over the first updates, ``min(decay, (1 + n) / (10 + n))``,
computed in fp32 as the JAX package does. With a sharded training state
(``parallel/fsdp.py``) the parameters it follows are this rank's slices of
the masters, and so are its shadows (JAX ``fsdp_sharding`` shards the EMA
tree as it shards the parameters).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from panacea_tpu_torch.utils.optim import CHUNK


class LitEma:
    def __init__(self, params: Mapping[str, torch.Tensor], decay: float = 0.9999,
                 use_num_updates: bool = True):
        self.decay = decay
        self.num_updates = 0 if use_num_updates else -1
        self.shadows: Dict[str, torch.Tensor] = {
            k: p.detach().float().clone() for k, p in params.items()}

    def current_decay(self) -> np.float32:
        """The decay of the next update (it counts the update first)."""
        if self.num_updates < 0:
            return np.float32(self.decay)
        n = np.float32(self.num_updates + 1)
        return np.minimum(np.float32(self.decay), (np.float32(1) + n) / (np.float32(10) + n))

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor]) -> None:
        """shadow -= (1 - d) (shadow - param), in place, as multi-tensor
        operations over chunks of ``CHUNK`` parameters."""
        weight = float(np.float32(1) - self.current_decay())
        if self.num_updates >= 0:
            self.num_updates += 1
        names = list(self.shadows)
        for i in range(0, len(names), CHUNK):
            shadows = [self.shadows[k] for k in names[i:i + CHUNK]]
            diff = torch._foreach_sub(shadows, [params[k].float() for k in names[i:i + CHUNK]])
            torch._foreach_sub_(shadows, diff, alpha=weight)

    def state_dict(self) -> dict:
        return {"decay": self.decay, "num_updates": self.num_updates, "shadows": self.shadows}

    def load_state_dict(self, state: Mapping) -> None:
        if sorted(state["shadows"]) != sorted(self.shadows):
            raise KeyError("EMA state: the shadows' names differ from the trained parameters'")
        self.decay = state["decay"]
        self.num_updates = int(state["num_updates"])
        with torch.no_grad():
            for k, e in self.shadows.items():
                e.copy_(state["shadows"][k])
