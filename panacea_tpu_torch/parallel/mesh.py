"""Process groups, devices and shards of the port's parallelism.

Counterpart of ``panacea_tpu/parallel/mesh.py`` (its ``dp``, ``t`` and
``view`` axes and ``maybe_init_distributed``), over ``torch.distributed``.
One process drives one card, as the reference ran under
``torch.distributed.launch`` with DDP: start the CLIs with ``torchrun
--nproc_per_node N``. Inference and the perception eval shard their clips
or windows over the ranks, which never talk until the eval's results are
merged; training replicates the parameters and averages the gradients
(``parallel/train.py``).

One clip over several devices: ``make_grid`` lays the ranks out as the
JAX ``make_mesh`` orders its devices, ``(dp, t, view)`` with the view axis
fastest, so rank ``(d * t + i) * view + j`` holds clip group ``d``'s
frames of slab ``i`` and its views of slab ``j``; the layers exchange what
crosses a shard explicitly (``parallel/shardctx.py``). Sampling
(``inference_torch.py --view_shard V``, JAX ``make_mesh(n, dp=1,
view=V)``) takes ``dp`` 1 and ``t = N / V``. Training (JAX ``train.py``'s
``make_mesh(dp * t, dp=dp)``) takes ``view`` 1: ``check_dp`` gives ``dp =
max(1, N // T)`` for a clip of ``T`` frames unless ``--dp`` is given, and
``t = N / dp`` frame ranks a clip, which must divide ``T``. The exchanges
of the ``t`` group differentiate (their backward passes send the gradient
back), those of the ``view`` group do not and refuse to.

Sharded training state (``train_torch.py --fsdp``, JAX ``fsdp_sharding``):
``fsdp_layout`` is the JAX leaf rule over every rank of the training grid;
``parallel/fsdp.py`` holds the shards and their exchanges.

The backend is NCCL on CUDA and gloo on the CPU. ``PANACEA_DIST_BACKEND=gloo``
lets several ranks share a card: NCCL refuses two ranks on one device, and
nothing switches backend on its own.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from panacea_tpu_torch.ops.panorama import NUM_VIEWS

BACKEND_VAR = "PANACEA_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")
# what torchrun sets for each worker
RENDEZVOUS_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# leaves under this many elements stay replicated (JAX fsdp_sharding's min_size)
FSDP_MIN_SIZE = 65536


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


def check_dp(dp: Optional[int], world: int, frames: int) -> Tuple[int, int]:
    """(dp, t) of a trainer on ``world`` processes and clips of ``frames``
    frames: ``dp`` clip groups of ``t = world / dp`` frame ranks each. The
    default is the JAX trainer's (``train.py:146``), ``max(1, world //
    frames)``: two to ``frames`` processes train one clip's frames over all
    of them. ``t`` must divide ``frames`` (the JAX partitioner replicates
    frames that do not split; the port refuses)."""
    if dp is None:
        dp = max(1, world // frames)
    if dp < 1:
        raise SystemExit(f"--dp {dp}: must be at least 1")
    if dp > world:
        raise SystemExit(f"--dp {dp} needs {dp} processes, one a rank (torchrun "
                         f"--nproc_per_node {dp}); this run has {world}")
    if world % dp:
        raise SystemExit(f"--dp {dp} does not divide the {world} processes into clip groups "
                         "of equal size")
    t = world // dp
    if frames % t:
        raise SystemExit(f"t = {t} frame ranks a clip ({world} processes / dp {dp}) do not "
                         f"divide the clip's {frames} frames: choose --dp or the process "
                         "count so that they do")
    return dp, t


def fsdp_spec(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension of a leaf of ``shape`` that ZeRO-3 splits over ``n``
    ranks, or None to replicate it (JAX ``fsdp_spec``): the largest
    dimension that ``n`` divides, the first of equal ones; None for a 0-d
    leaf or where no dimension divides."""
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for i in order:
        if shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def fsdp_layout(named_shapes, n: int, min_size: int = FSDP_MIN_SIZE) -> dict:
    """name -> the split dimension (``fsdp_spec``), or None for a leaf that
    stays replicated: under ``min_size`` elements, or with no dimension that
    ``n`` divides (JAX ``fsdp_sharding`` over every axis of the mesh). Torch
    orders a convolution's or a linear layer's dimensions otherwise than
    flax, so the split dimension may differ from JAX's; which leaves are
    split, and each rank's element count, do not."""
    out = {}
    for name, shape in named_shapes.items():
        shape = tuple(shape)
        out[name] = None if int(np.prod(shape, dtype=np.int64)) < min_size else fsdp_spec(
            shape, n)
    return out


class Grid(NamedTuple):
    """The place of a rank in ``dp`` clip groups of ``t * view`` ranks:
    rank ``r = (dp_index * t + t_index) * view + view_index`` holds the
    frames of slab ``t_index`` and the panorama columns of view slab
    ``view_index`` of clip group ``dp_index``'s clips, as JAX ``make_mesh``
    orders its devices. ``t_ranks`` and ``view_ranks`` are the global ranks
    of this rank's ``t`` group (the same clips and view slab) and ``view``
    group (the same clips and frames); ``t_group`` and ``view_group`` their
    process groups. ``host_staged``: gloo with CUDA tensors, whose
    exchanges go through host copies (``shardctx``)."""
    rank: int
    world: int
    t: int
    view: int
    t_index: int
    view_index: int
    t_ranks: Tuple[int, ...]
    view_ranks: Tuple[int, ...]
    t_group: object
    view_group: object
    backend: str
    host_staged: bool
    dp: int = 1
    dp_index: int = 0


def check_view_shard(view: int, world: int) -> int:
    """``t = world / view``, or SystemExit where ``view`` does not divide 6
    and the process count (JAX ``inference.py:230-233``)."""
    if view < 1 or NUM_VIEWS % view or world % view:
        raise SystemExit(f"--view_shard {view} must divide {NUM_VIEWS} and the process count "
                         f"({world})")
    return world // view


def check_frames(t: int, frames: int) -> None:
    """Each frame rank holds ``frames / t`` frames: ``t`` must divide them.
    (The JAX partitioner replicates frames that do not split and computes
    the clip ``t`` times; the port refuses.)"""
    if frames % t:
        raise SystemExit(f"t = {t} frame ranks do not divide the clip's {frames} frames: "
                         "choose the process count (and --view_shard or --dp) so that "
                         "they do")


def make_grid(world: int, view: int, device=None, dp: int = 1) -> Optional[Grid]:
    """The grid of the default process group's ``world`` ranks: ``dp``
    clip groups, each of ``t = world / (dp * view)`` frame ranks by
    ``view`` view ranks; None for a grid of one rank a clip (the plain
    path). Every rank calls it, in the same order: it makes the ``t`` and
    ``view`` process groups with ``dist.new_group``."""
    if world % dp:
        raise SystemExit(f"dp {dp} does not divide the {world} processes")
    t = check_view_shard(view, world // dp)
    if t * view == 1:
        return None
    import torch.distributed as dist

    rank = dist.get_rank()
    backend = dist.get_backend()

    def at(d, i, j):
        return (d * t + i) * view + j

    groups = {}
    for d in range(dp):
        for i in range(t):       # the view groups: the same clips and frames
            ranks = tuple(at(d, i, j) for j in range(view))
            groups[("view", d, i)] = ranks, dist.new_group(list(ranks))
        for j in range(view):    # the t groups: the same clips and view slab
            ranks = tuple(at(d, i, j) for i in range(t))
            groups[("t", d, j)] = ranks, dist.new_group(list(ranks))
    d, rest = divmod(rank, t * view)
    ti, vi = divmod(rest, view)
    on_card = device is not None and torch.device(device).type == "cuda"
    return Grid(rank, world, t, view, ti, vi, groups[("t", d, vi)][0],
                groups[("view", d, ti)][0], groups[("t", d, vi)][1],
                groups[("view", d, ti)][1], backend, backend == "gloo" and on_card, dp, d)
