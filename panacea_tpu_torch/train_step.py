"""The single-device training step (counterpart of
``panacea_tpu/parallel/train.py``: ``init_train_state`` and
``make_train_step`` without a mesh; its ``make_optimizer`` is
``utils.optim.AdamW``).

One step: the clip is encoded without gradients, the network runs with
gradients (ResBlocks and transformers recomputed in the backward pass where
``use_checkpoint`` is set), the loss is averaged, the gradients go back
through the hand-written backward kernels, AdamW (with the global-norm clip
over the trained parameters) updates the fp32 masters, the network's
parameters take the masters' values in their compute type, and the EMA
follows the masters.

Parameter types: on the card the network computes in bf16 and the trained
parameters' fp32 masters live in the ``TrainState``; the gradients arrive in
bf16 on the network's parameters (the cotangents of JAX's fp32-to-bf16
cast) and are used in fp32. An fp32 engine (the CPU) needs no masters: the
masters are its parameters.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from panacea_tpu_torch.utils.ema import LitEma
from panacea_tpu_torch.utils.optim import AdamW


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]      # fp32 masters of the trained parameters
    network: Dict[str, torch.nn.Parameter]  # the same parameters as the network holds them
    optimizer: AdamW
    step: int = 0
    ema: Optional[LitEma] = None

    def sync_network(self) -> None:
        """Copy the masters into the network's parameters (a cast where the
        network computes in bf16)."""
        pairs = [(p, self.params[k]) for k, p in self.network.items() if p is not self.params[k]]
        if pairs:
            with torch.no_grad():
                torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])


def init_train_state(engine, lr: float = 1e-4, weight_decay: float = 1e-2,
                     grad_clip: Optional[float] = None, spatial_lr_rate: Optional[float] = None,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     use_ema: bool = False, ema_decay: float = 0.9999) -> TrainState:
    """Mark the trained parameters (``engine.freeze_type``), make their fp32
    masters, the optimizer and, with ``use_ema``, the EMA shadows."""
    network = engine.set_trainable()
    params = {k: p if p.dtype == torch.float32 else p.detach().float().clone()
              for k, p in network.items()}
    opt = AdamW(params, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
                spatial_lr_rate=spatial_lr_rate, lr_schedule=lr_schedule)
    ema = LitEma(params, decay=ema_decay) if use_ema else None
    return TrainState(params=params, network=network, optimizer=opt, ema=ema)


def train_step(engine, state: TrainState, jpg, cond: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, timer=None,
               **inject) -> torch.Tensor:
    """One step of ``state`` on the clip ``jpg`` (B, T, H, W, 3) with the
    precomputed conditioning ``cond``. Random draws (posterior, sigmas,
    noise) come from ``generator`` in that order, or are injected
    (``posterior_noise``, ``sigma_rand``, ``noise``, ``offset``). ``timer``
    (``utils.profiling.Timer``) splits the step into vae_encode, forward,
    backward, optimizer and ema. Returns the loss (a detached scalar)."""
    def phase(name):
        return timer(name) if timer is not None else contextlib.nullcontext()

    engine.train()
    posterior_noise = inject.pop("posterior_noise", None)
    for p in state.network.values():
        p.grad = None
    with phase("vae_encode"):
        x = torch.as_tensor(jpg, dtype=torch.float32, device=engine.device)
        z = engine.encode_first_stage(x.reshape((-1,) + tuple(x.shape[2:])),
                                      generator=generator, noise=posterior_noise)
    with phase("forward"):
        loss = engine.diffusion_loss(z, cond, generator=generator, **inject)
    with phase("backward"):
        loss.backward()
    with phase("optimizer"):
        grads = {k: p.grad for k, p in state.network.items()}
        missing = [k for k, g in grads.items() if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {len(missing)} trained parameters, "
                               f"e.g. {missing[:3]}")
        state.optimizer.step(state.params, grads)
        for p in state.network.values():
            p.grad = None
        state.sync_network()
    if state.ema is not None:
        with phase("ema"):
            state.ema.update(state.params)
    state.step += 1
    return loss.detach()
