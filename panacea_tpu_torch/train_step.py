"""The single-device training step (counterpart of
``panacea_tpu/parallel/train.py``: ``init_train_state`` and
``make_train_step`` without a mesh; its ``make_optimizer`` is
``utils.optim.AdamW``).

One step: the clip is encoded without gradients, the network runs with
gradients (ResBlocks and transformers recomputed in the backward pass where
``use_checkpoint`` is set), the loss is averaged, the gradients go back
through the hand-written backward kernels, under a process group they are
averaged over the ranks (``parallel.train.allreduce_mean``: each rank's
gradient is of its rows' mean loss, so the average is the global batch's,
as the JAX package's sharded step gives it), AdamW (with the global-norm
clip over the trained parameters) updates the fp32 masters, the network's
parameters take the masters' values in their compute type, and the EMA
follows the masters.

Over a grid (``engine.grid``: ``dp`` clip groups of ``t`` frame ranks,
``parallel/mesh.py``) each rank holds its clips' slab of ``T / t`` frames,
and the network runs under the sharded context. Why the
ranks' mean of their gradients is the global batch's: rank r's loss L_r
is the mean over its F frames, and every rank holds F = B T / world
frames, so the global batch's mean loss is L = (1 / world) sum_r L_r. The
exchanges of the frame group are autograd functions whose backward
passes are their adjoints (``shardctx``), so rank r's backward of L_r
gives, on the parameters it used, its share of the gradient of sum_r L_r
with the cross-rank terms included (a neighbour's halo gradient, the
other ranks' part of the GroupNorm statistics, the all-to-all's inverse).
Summed over the ranks these shares are d(sum_r L_r) / d(theta), so
``allreduce_mean`` (the sum over the world, divided by its size) gives
dL / d(theta), as JAX's ``value_and_grad`` of the sharded step does.

With a sharded training state (``engine.shards``, ``parallel/fsdp.py``;
the CLI's ``--fsdp``) the network's split parameters, their masters, the
moments and the EMA shadows are this rank's slices: the units gather their
parameters as they run, the backward reduce-scatters the split leaves'
fp32 gradients (the same ranks' mean, each rank receiving its slices) where
the replicated ones are all-reduced, AdamW and the EMA update the slices,
and each rank casts its master slices into its network slices.

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

from panacea_tpu_torch.parallel import comm_report
from panacea_tpu_torch.parallel.train import allreduce_mean, reduce_mean
from panacea_tpu_torch.utils.ema import LitEma
from panacea_tpu_torch.utils.optim import AdamW


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]      # fp32 masters of the trained parameters
    network: Dict[str, torch.nn.Parameter]  # the same parameters as the network holds them
    optimizer: AdamW
    step: int = 0
    ema: Optional[LitEma] = None
    shards: Optional[object] = None      # parallel.fsdp.Shards, or None: replicated

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
    masters, the optimizer and, with ``use_ema``, the EMA shadows; of this
    rank's slices where the engine's state is sharded (``engine.shards``)."""
    network = engine.set_trainable()
    params = {k: p if p.dtype == torch.float32 else p.detach().float().clone()
              for k, p in network.items()}
    opt = AdamW(params, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
                spatial_lr_rate=spatial_lr_rate, lr_schedule=lr_schedule,
                shards=engine.shards)
    ema = LitEma(params, decay=ema_decay) if use_ema else None
    return TrainState(params=params, network=network, optimizer=opt, ema=ema,
                      shards=engine.shards)


def local_grads(engine, network: Dict[str, torch.nn.Parameter], jpg,
                cond: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                timer=None, **inject) -> torch.Tensor:
    """This rank's forward and backward of a step: the clip ``jpg`` (B, T,
    H, W, 3) encoded without gradients, the loss with gradients under the
    engine's grid, its backward into ``.grad`` of the trained parameters
    ``network`` (each must get one; under a sharded state the split
    ones' reduced fp32 gradients go to ``engine.shards.grads``). Draws and
    ``timer`` as ``train_step``'s. Returns the rank's loss, not yet
    reduced."""
    def phase(name):
        return timer(name) if timer is not None else contextlib.nullcontext()

    engine.train()
    posterior_noise = inject.pop("posterior_noise", None)
    shards = engine.shards
    for p in network.values():
        p.grad = None
    if shards is not None:
        shards.grads.clear()
    # the forward runs under the engine's grid (``diffusion_loss``); the
    # backward needs no context: each exchange keeps its grid, and the
    # recomputed forward gets it from ``shardctx.checkpoint_contexts``
    with (comm_report.training_step() if engine.grid is not None or shards is not None
          else contextlib.nullcontext()):
        with phase("vae_encode"):
            x = torch.as_tensor(jpg, dtype=torch.float32, device=engine.device)
            z = engine.encode_first_stage(x.reshape((-1,) + tuple(x.shape[2:])),
                                          generator=generator, noise=posterior_noise)
        with phase("forward"):
            loss = engine.diffusion_loss(z, cond, generator=generator, **inject)
        with phase("backward"):
            loss.backward()
    missing = ([k for k, p in network.items() if p.grad is None] if shards is None
               else shards.missing(network))
    if missing:
        raise RuntimeError(f"no gradient reached {len(missing)} trained parameters, "
                           f"e.g. {missing[:3]}")
    return loss.detach()


def train_step(engine, state: TrainState, jpg, cond: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, timer=None,
               **inject) -> torch.Tensor:
    """One step of ``state`` on the clip ``jpg`` (B, T, H, W, 3) with the
    precomputed conditioning ``cond``. Random draws (posterior, sigmas,
    noise) come from ``generator`` in that order, or are injected
    (``posterior_noise``, ``sigma_rand``, ``noise``, ``offset``,
    ``share_frame``). ``timer`` (``utils.profiling.Timer``) splits the step
    into vae_encode, forward, backward, allreduce, optimizer and ema.
    Under a grid, ``jpg``, ``cond`` and the draws are this rank's slab
    (``train.rank_rows``). Returns the loss (a detached scalar), averaged
    over the ranks under a process group."""
    def phase(name):
        return timer(name) if timer is not None else contextlib.nullcontext()

    loss = local_grads(engine, state.network, jpg, cond, generator=generator, timer=timer,
                       **inject)
    with phase("allreduce"):
        if state.shards is None:
            grads = dict(zip(state.network,
                             allreduce_mean([p.grad for p in state.network.values()])))
        else:
            grads = state.shards.grads_of(state.network)
        loss = reduce_mean(loss)
    with phase("optimizer"):
        state.optimizer.step(state.params, grads)
        for p in state.network.values():
            p.grad = None
        state.sync_network()
    if state.ema is not None:
        with phase("ema"):
            state.ema.update(state.params)
    state.step += 1
    return loss.detach()
