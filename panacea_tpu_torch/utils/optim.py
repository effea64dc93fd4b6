"""AdamW as the JAX trainer builds it (counterpart of
``panacea_tpu/utils/optim.py`` and of ``make_optimizer`` in
``panacea_tpu/parallel/train.py:29-74``: optax's ``clip_by_global_norm`` and
``adamw`` behind a freeze mask and optional dual learning-rate groups).

The parameters it is given are the trained ones only: frozen parameters get
no update, not even weight decay, and take no part in the clipping norm, as
under the mask of ``optax.multi_transform``. With ``spatial_lr_rate`` the
parameters split into two groups, those with ``temporal`` in their name at
``lr`` and the rest at ``lr * spatial_lr_rate``, and each group is clipped by
its own global norm, as each ``multi_transform`` branch carries its own
clip. The arithmetic is optax's, in fp32, in place on the parameters:

    mu = (1 - b1) g + b1 mu,    nu = (1 - b2) g^2 + b2 nu,    n += 1
    u = mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps) + weight_decay p
    p -= lr * schedule(n - 1) * u

The update runs as multi-tensor (``torch._foreach_*``) operations over
chunks of ``CHUNK`` parameters: a few launches a chunk rather than a dozen a
parameter, and temporaries of one chunk's size.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

CHUNK = 64  # parameters per multi-tensor operation


def _is_temporal(name: str) -> bool:
    return "temporal" in name


class AdamW:
    def __init__(self, params: Mapping[str, torch.Tensor], lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2,
                 grad_clip: Optional[float] = None, spatial_lr_rate: Optional[float] = None,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.lr_schedule = lr_schedule
        names = list(params)
        if spatial_lr_rate is not None and spatial_lr_rate != 1.0:
            self.groups = [
                {"lr": lr * spatial_lr_rate, "names": [n for n in names if not _is_temporal(n)]},
                {"lr": lr, "names": [n for n in names if _is_temporal(n)]}]
        else:
            self.groups = [{"lr": lr, "names": names}]
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}

    def _clip_scale(self, grads: Sequence[torch.Tensor]) -> Optional[float]:
        """optax.clip_by_global_norm: None where the group's norm is below
        the limit, else the norm (the gradients are divided by it and
        multiplied by the limit)."""
        if not self.grad_clip or not grads:
            return None
        sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32).square()
                          for g in grads]).sum()
        norm = float(sq.sqrt())
        return None if norm < self.grad_clip else norm

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """One update of every parameter in place from its gradient (any
        float type; used in fp32). Returns each group's global gradient norm
        where it was clipped."""
        clipped = {}
        n = self.count + 1
        c1, c2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
        for gi, group in enumerate(self.groups):
            names: List[str] = group["names"]
            norm = self._clip_scale([grads[k] for k in names])
            if norm is not None:
                clipped[f"group{gi}"] = norm
            lr = group["lr"] * (self.lr_schedule(self.count) if self.lr_schedule else 1.0)
            for i in range(0, len(names), CHUNK):
                chunk = names[i:i + CHUNK]
                ps = [params[k] for k in chunk]
                gs = [grads[k].float() for k in chunk]
                if norm is not None:
                    torch._foreach_div_(gs, norm)
                    torch._foreach_mul_(gs, self.grad_clip)
                mus, nus = [self.mu[k] for k in chunk], [self.nu[k] for k in chunk]
                torch._foreach_mul_(mus, self.b1)
                torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
                torch._foreach_mul_(nus, self.b2)
                torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
                den = torch._foreach_div(nus, c2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, self.eps)
                u = torch._foreach_div(mus, c1)
                torch._foreach_div_(u, den)
                torch._foreach_add_(u, ps, alpha=self.weight_decay)
                torch._foreach_add_(ps, u, alpha=-lr)
        self.count = n
        return clipped

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Mapping) -> None:
        if sorted(state["mu"]) != sorted(self.mu):
            raise KeyError("optimizer state: the names differ from the trained parameters'")
        self.count = int(state["count"])
        with torch.no_grad():
            for k in self.mu:
                self.mu[k].copy_(state["mu"][k])
                self.nu[k].copy_(state["nu"][k])
