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
clip. With ``lr_mults`` (name -> multiplier; the perception trainer's
backbone at 0.1) each parameter's learning rate is ``lr`` times its
multiplier and one global norm over every trained gradient is clipped, as
a chain whose clip comes before a per-parameter scale. The arithmetic is optax's, in fp32, in place on the parameters:

    mu = (1 - b1) g + b1 mu,    nu = (1 - b2) g^2 + b2 nu,    n += 1
    u = mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps) + weight_decay p
    p -= lr * schedule(n - 1) * u

The update runs as multi-tensor (``torch._foreach_*``) operations over
chunks of ``CHUNK`` parameters: a few launches a chunk rather than a dozen a
parameter, and temporaries of one chunk's size.

With a sharded training state (``shards``, ``parallel/fsdp.py``) the
parameters, gradients and moments of the split leaves are this rank's
slices, and the update of each is local; the clip's global norm then sums
the split leaves' squares over the ranks and counts each replicated leaf
once (``fsdp.square_over_ranks``).
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
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 lr_mults: Optional[Mapping[str, float]] = None, shards=None):
        self.b1, self.b2 = betas
        self.shards = shards
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.lr_schedule = lr_schedule
        names = list(params)
        self.joint_clip = lr_mults is not None
        if lr_mults is not None:
            mults = sorted({float(lr_mults.get(n, 1.0)) for n in names}, reverse=True)
            self.groups = [{"lr": lr * m, "names": [n for n in names
                                                    if float(lr_mults.get(n, 1.0)) == m]}
                           for m in mults]
        elif spatial_lr_rate is not None and spatial_lr_rate != 1.0:
            self.groups = [
                {"lr": lr * spatial_lr_rate, "names": [n for n in names if not _is_temporal(n)]},
                {"lr": lr, "names": [n for n in names if _is_temporal(n)]}]
        else:
            self.groups = [{"lr": lr, "names": names}]
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}

    def _clip_scale(self, names: Sequence[str],
                    grads: Mapping[str, torch.Tensor]) -> Optional[float]:
        """optax.clip_by_global_norm: None where the group's norm is below
        the limit, else the norm (the gradients are divided by it and
        multiplied by the limit)."""
        if not self.grad_clip or not names:
            return None

        def square(ks):
            if not ks:
                return torch.zeros((), dtype=torch.float32, device=grads[names[0]].device)
            return torch.stack([torch.linalg.vector_norm(grads[k], dtype=torch.float32).square()
                                for k in ks]).sum()

        if self.shards is None:
            sq = square(names)
        else:
            from panacea_tpu_torch.parallel import fsdp

            split = self.shards.leaves
            sq = fsdp.square_over_ranks(self.shards, square([k for k in names if k in split]),
                                        square([k for k in names if k not in split]))
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
        if self.joint_clip:
            norm = self._clip_scale([k for g in self.groups for k in g["names"]], grads)
            if norm is not None:
                clipped["all"] = norm
        for gi, group in enumerate(self.groups):
            names: List[str] = group["names"]
            if not self.joint_clip:
                norm = self._clip_scale(names, grads)
                if norm is not None:
                    clipped[f"group{gi}"] = norm
            lr = group["lr"] * (self.lr_schedule(self.count) if self.lr_schedule else 1.0)
            for i in range(0, len(names), CHUNK):
                chunk = names[i:i + CHUNK]
                ps = [params[k] for k in chunk]
                gs = [grads[k].float() for k in chunk]
                if norm is not None:   # new tensors: the caller's gradients stay as given
                    gs = torch._foreach_div(gs, norm)
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
