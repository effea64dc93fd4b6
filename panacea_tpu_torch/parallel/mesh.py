"""Process groups, devices and shards of the port's data parallelism.

Counterpart of ``panacea_tpu/parallel/mesh.py``'s ``dp`` axis (and of
``maybe_init_distributed``), over ``torch.distributed``. One process drives
one card, as the reference ran under ``torch.distributed.launch`` with
DDP: start the CLIs with ``torchrun --nproc_per_node N``. Inference and the
perception eval shard their clips or windows over the ranks, which never
talk until the eval's results are merged; training replicates the
parameters and averages the gradients (``parallel/train.py``).

The backend is NCCL on CUDA and gloo on the CPU. ``PANACEA_DIST_BACKEND=gloo``
lets several ranks share a card: NCCL refuses two ranks on one device, and
nothing switches backend on its own. Sharding one clip over several devices
(the JAX package's ``t`` and ``view`` axes, ``--view_shard``) and sharded
training state (``--fsdp``) are not ported (ROADMAP Queue A items 7b, 7c).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

BACKEND_VAR = "PANACEA_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")
# what torchrun sets for each worker
RENDEZVOUS_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
VIEW_SHARD = ("sharding one clip over several devices (the JAX package's 't' and 'view' "
              "axes) is not ported: ROADMAP Queue A item 7b")
FSDP = "sharded training state (FSDP) is not ported: ROADMAP Queue A item 7c"


class Group(NamedTuple):
    """The process's place in the run: its rank, the world size, the
    backend (None without a process group) and its device."""
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device


def _is_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def backend_for(device=None) -> str:
    """gloo where ``device`` is the CPU, else NCCL, or what
    ``PANACEA_DIST_BACKEND`` names."""
    name = os.environ.get(BACKEND_VAR)
    if name:
        if name not in BACKENDS:
            raise ValueError(f"{BACKEND_VAR}={name}: not one of {BACKENDS}")
        if name == "nccl" and _is_cpu(device):
            raise ValueError(f"{BACKEND_VAR}=nccl with --device cpu: NCCL reduces CUDA "
                             "tensors only")
        return name
    return "gloo" if _is_cpu(device) else "nccl"


def local_device(device=None) -> torch.device:
    """The device of this process: the CPU where ``device`` says so,
    ``device`` where it names a card, else ``cuda:{LOCAL_RANK}`` made the
    current card (``cuda:{LOCAL_RANK % cards}`` where gloo puts more ranks
    than cards on the host), and plain ``cuda`` outside ``torchrun``.
    Raises without a card unless the caller asked for the CPU."""
    if _is_cpu(device):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the port runs on CUDA by default and no CUDA device is present; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    if device is not None and torch.device(device).index is not None:
        dev = torch.device(device)
    elif "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    else:
        return torch.device(device or "cuda")
    torch.cuda.set_device(dev)
    return dev


def maybe_init_distributed(device=None) -> bool:
    """Initialise the default process group where ``torchrun``'s
    environment is set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); without it nothing happens and False
    comes back. ``WORLD_SIZE`` above 1 without the rest is an error. The
    backend is ``backend_for(device)``; NCCL with more ranks on the host
    than cards raises. True where this call initialised the group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    missing = [v for v in RENDEZVOUS_VARS if v not in os.environ]
    if missing:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but no rendezvous ({', '.join(missing)} "
                               "unset): start the ranks with torchrun --nproc_per_node N")
        return False
    backend = backend_for(device)
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(f"NCCL puts one rank on one card: {local_world} ranks on this "
                               f"host, {cards} card(s). Set {BACKEND_VAR}=gloo to let ranks "
                               "share a card")
        local_device(device)   # NCCL binds the group to the current card
    dist.init_process_group(backend)
    return True


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@contextlib.contextmanager
def process_group(device=None) -> Iterator[Group]:
    """A CLI's run: ``maybe_init_distributed(device)``, the local device,
    and the group destroyed at the end where this call made it."""
    import torch.distributed as dist

    made = maybe_init_distributed(device)
    try:
        rank, world = rank_world()
        backend = dist.get_backend() if dist.is_initialized() else None
        yield Group(rank, world, backend, local_device(device))
    finally:
        if made:
            dist.destroy_process_group()


def shard_indices(seq: Sequence, rank: int, world: int) -> list:
    """Rank ``rank``'s items of ``seq``: every ``world``-th from its own, as
    the JAX CLIs take ``indices[proc::nproc]``."""
    return list(seq[rank::world])


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own draws (GridMask, DN, augmentation):
    ``seed`` on rank 0, so that one process draws as before; a SeedSequence
    of both on the others (the counterpart of JAX's ``fold_in(rng,
    axis_index)``)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def check_dp(dp: Optional[int], world: int) -> int:
    """The data-parallel size of a trainer: the world size by default, and
    it must equal it. A larger one needs more processes; a smaller one
    would put several ranks on one clip (the JAX trainer's ``t`` axis)."""
    if dp is None:
        return world
    if dp < 1:
        raise SystemExit(f"--dp {dp}: must be at least 1")
    if dp > world:
        raise SystemExit(f"--dp {dp} needs {dp} processes, one a rank (torchrun "
                         f"--nproc_per_node {dp}); this run has {world}")
    if dp < world:
        raise SystemExit(f"--dp {dp} over {world} processes leaves t = {world / dp:g} ranks "
                         f"a clip: {VIEW_SHARD}")
    return dp
