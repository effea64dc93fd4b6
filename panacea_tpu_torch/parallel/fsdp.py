"""Sharded training state over every rank of the training grid: ZeRO-3
(counterpart of ``fsdp_sharding`` in ``panacea_tpu/parallel/mesh.py`` and of
the all-gathers and reduce-scatters that XLA's partitioner inserts around
the sharded leaves of ``make_train_step(fsdp=True)``).

The layout is the JAX leaf rule (``mesh.fsdp_layout``) over all ``dp x t``
ranks: every parameter of the network (``engine.model``, trained and
frozen) and of the first stage with at least ``min_size`` elements is split
along its largest dimension that the world size divides; the rest, and the
conditioner, stay replicated. Between steps each rank holds, for a split
leaf, only its slice: the network's and the first stage's modules register
the slice itself as the parameter, so the trained parameters' fp32 masters,
AdamW's moments and the EMA shadows made from them are slices too.

During a step the parameters are gathered a unit at a time, just before the
unit runs, and freed after it. A unit is a ResBlock3D, a transformer block
(``unet._BLOCKS``), or, for what lies outside those, the module that owns
the parameter (the input, down- and upsampling, zero and output
convolutions, the time embedding, the hint stack). A unit's forward is
wrapped: its slices go through ``_Gather`` (one all-gather of the unit in
the network's type), the full tensors stand in the module's parameter slots
while it runs and the slices are put back after it, also where the forward
raises or ``torch.utils.checkpoint`` stops a recomputation early. Nothing
keeps a gathered tensor past its unit: the ResBlocks and transformers are
recomputed in the backward pass under ``use_checkpoint``, and the other
units are recomputed here (non-reentrant ``torch.utils.checkpoint`` with
``shardctx.checkpoint_contexts``); each recomputation gathers the unit
again, as XLA's ZeRO-3 does. So at most the unit that runs, the one being
recomputed and the one whose gradients are being reduced are gathered at
once. The first stage is one unit, gathered around
``encode_first_stage`` / ``decode_first_stage``.

``_Gather``'s backward is the reduce-scatter: the gradients of the unit's
trained leaves, in fp32, summed over the ranks and divided by the world
size, each rank receiving its slices (the ranks' mean, as ``allreduce_mean``
gives it unsharded; ``train_step.py`` says why that mean is the global
batch's). They are kept in ``Shards.grads`` in fp32, not cast into the
slices' ``.grad``. The replicated leaves' gradients are all-reduced as
before (``grads_of``). The clip's global norm takes the sharded leaves'
squares summed over the ranks and the replicated leaves' once
(``square_over_ranks``), as ``optax.clip_by_global_norm`` over the sharded
tree does.

Every rank issues the same collectives in the same order: one graph, the
same units, the same recomputations. Transport as ``shardctx``'s: NCCL on
CUDA tensors (a rank a card), gloo on CPU tensors, and gloo with CUDA
tensors (ranks that share a card) through explicit host copies. A failing
collective raises. Each is counted in ``comm_report`` (``fsdp_gather``,
forward or recomputed; ``fsdp_reduce_scatter_bwd``; ``fsdp_state``, the
gathers of a checkpoint's full tensors).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from panacea_tpu_torch.parallel import comm_report, shardctx
from panacea_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, fsdp_layout

# the size of one gather of a checkpoint's full tensors
STATE_BUCKET_BYTES = 256 << 20


class Leaf(NamedTuple):
    """A split parameter: its module and slot, its name in the engine, the
    split dimension, its full shape and whether it lives channels-last."""
    module: nn.Module
    attr: str
    name: str
    dim: int
    shape: Tuple[int, ...]
    channels_last: bool


def _is_channels_last(p: torch.Tensor) -> bool:
    return p.dim() == 4 and p.is_contiguous(memory_format=torch.channels_last) \
        and not p.is_contiguous()


class _Gather(torch.autograd.Function):
    """A unit's slices -> its full tensors (one all-gather). The full
    tensors of frozen slices need no gradient; the backward reduce-scatters
    the trained ones' gradients into ``Shards.grads`` and hands autograd
    none."""

    @staticmethod
    def forward(ctx, unit, *slices):
        fulls = unit.owner.gather(unit.leaves, slices, "fsdp_gather")
        ctx.unit = unit
        ctx.trained = [s.requires_grad for s in slices]
        ctx.set_materialize_grads(False)
        frozen = [f for f, t in zip(fulls, ctx.trained) if not t]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        leaves = [leaf for leaf, t in zip(ctx.unit.leaves, ctx.trained) if t]
        ctx.unit.owner.scatter_grads(leaves, [g for g, t in zip(grads, ctx.trained) if t])
        return (None,) * (1 + len(grads))


class Unit:
    """The split leaves that one module's forward gathers together."""

    def __init__(self, owner: "Shards", module: nn.Module, leaves: List[Leaf], remat: bool):
        self.owner, self.module, self.leaves, self.remat = owner, module, leaves, remat

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        """The unit's full tensors in its modules' slots within the block,
        its slices back after it."""
        slices = [leaf.module._parameters[leaf.attr] for leaf in self.leaves]
        fulls = _Gather.apply(self, *slices)
        for leaf, full in zip(self.leaves, fulls):
            leaf.module._parameters[leaf.attr] = full
        del fulls
        try:
            yield
        finally:
            for leaf, s in zip(self.leaves, slices):
                leaf.module._parameters[leaf.attr] = s

    def wrap(self) -> None:
        """Gather around the module's forward; recompute it in the backward
        (so that nothing keeps its full tensors) where ``remat``."""
        inner, owner = self.module.forward, self.owner

        def gathered(*a, **kw):
            with self.installed():
                return inner(*a, **kw)

        def forward(*a, **kw):
            if not owner.active:
                return inner(*a, **kw)
            if self.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                return checkpoint(gathered, *a, use_reentrant=False,
                                  context_fn=shardctx.checkpoint_contexts, **kw)
            return gathered(*a, **kw)

        self.module.forward = forward


def _reduce_scatter(shards: "Shards", buf: torch.Tensor) -> torch.Tensor:
    """(world, S) fp32 on every rank -> this rank's (S,) of the sum over
    the ranks (one ``reduce_scatter_tensor``)."""
    import torch.distributed as dist

    send = shards.wire(buf.reshape(-1))
    out = torch.empty(buf.shape[1:], dtype=send.dtype, device=send.device,
                      pin_memory=shards.staged)
    dist.reduce_scatter_tensor(out, send)
    return shards.home(out)


def square_over_ranks(shards: "Shards", sharded_sq: torch.Tensor,
                      replicated_sq: torch.Tensor) -> torch.Tensor:
    """The squared global norm: the split leaves' squares summed over the
    ranks (each holds its slices), the replicated leaves' counted once
    (every rank holds the same)."""
    return shards.all_reduce_sum(sharded_sq, "fsdp_norm") + replicated_sq


class Shards:
    """The sharded layout of ``engine`` over ``world`` ranks (the default
    process group), made in place: the split parameters become this rank's
    slices, the units' forwards are wrapped, ``engine.shards`` is set.
    Every rank builds it, in the same order."""

    def __init__(self, engine, rank: int, world: int, backend: str,
                 min_size: int = FSDP_MIN_SIZE):
        from panacea_tpu_torch.models.unet import _BLOCKS, _Torso

        self.rank, self.world, self.min_size = rank, world, min_size
        self.device = engine.device
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.active = True
        self.grads: Dict[str, torch.Tensor] = {}
        roots = {"model": engine.model, "first_stage_model": engine.first_stage_model}
        named = {f"{r}.{n}": p for r, m in roots.items() for n, p in m.named_parameters()}
        self.dims = fsdp_layout({k: tuple(p.shape) for k, p in named.items()}, world, min_size)
        self.numel = {k: p.numel() for k, p in named.items()}
        self.leaves: Dict[str, Leaf] = {}
        for r, root in roots.items():
            for mname, m in root.named_modules():
                for attr, p in m._parameters.items():
                    name = f"{r}.{mname}.{attr}" if mname else f"{r}.{attr}"
                    if p is not None and self.dims.get(name) is not None:
                        self.leaves[name] = Leaf(m, attr, name, self.dims[name],
                                                 tuple(p.shape), _is_channels_last(p))
        with torch.no_grad():
            for leaf in self.leaves.values():
                p = leaf.module._parameters[leaf.attr]
                part = self.local(leaf.name, p.detach()).clone(
                    memory_format=torch.contiguous_format)
                leaf.module._parameters[leaf.attr] = nn.Parameter(
                    part, requires_grad=p.requires_grad)
        # the network's units: each checkpointed block with what it holds,
        # then each other module with the split leaves it owns
        net = engine.model
        remat_of = {}
        for t in net.modules():               # the ControlNet's torso after the UNet's
            if isinstance(t, _Torso):
                for b in t.modules():
                    if isinstance(b, _BLOCKS):
                        remat_of[b] = not t.use_checkpoint
        self.units: List[Unit] = []
        claimed = set()
        for mname, m in net.named_modules():
            if m in remat_of:
                leaves = [self.leaves[f"model.{mname}.{n}"] for n, _ in m.named_parameters()
                          if f"model.{mname}.{n}" in self.leaves]
                claimed.update(leaf.name for leaf in leaves)
                if leaves:
                    self.units.append(Unit(self, m, leaves, remat_of[m]))
        for name, leaf in self.leaves.items():
            if name.startswith("model.") and name not in claimed:
                same = [u for u in self.units if u.module is leaf.module]
                if same:
                    same[0].leaves.append(leaf)
                else:
                    self.units.append(Unit(self, leaf.module, [leaf], True))
        for u in self.units:
            u.wrap()
        self.first_stage = [leaf for n, leaf in self.leaves.items()
                            if n.startswith("first_stage_model.")]
        self.engine = engine
        engine.shards = self

    # ------------------------------------------------------------ transport

    def _clock(self) -> float:
        if self.staged:
            torch.cuda.synchronize(self.device)   # the card's queue is not the exchange's
        return time.perf_counter()

    def wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the collective takes it: staged, a copy in pinned host
        memory (the caching host allocator keeps the buffers)."""
        if not self.staged:
            return x.contiguous()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x.detach())
        return out

    def home(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staged else x

    def all_gather(self, flat: torch.Tensor, kind: str) -> torch.Tensor:
        """(S,) on every rank -> (world, S), rank r's in row r."""
        import torch.distributed as dist

        t0 = self._clock()
        send = self.wire(flat)
        out = torch.empty((self.world * send.numel(),), dtype=send.dtype, device=send.device,
                          pin_memory=self.staged)
        dist.all_gather_into_tensor(out, send)
        out = self.home(out).view(self.world, -1)
        comm_report.record(kind, flat.numel() * flat.element_size(), time.perf_counter() - t0)
        return out

    def all_reduce_sum(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        import torch.distributed as dist

        t0 = self._clock()
        y = self.wire(x) if self.staged else x.clone()
        dist.all_reduce(y)
        y = self.home(y)
        comm_report.record(kind, x.numel() * x.element_size(), time.perf_counter() - t0)
        return y

    # ------------------------------------------------------------ the layout

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full``, the whole tensor named ``name``:
        its slice where the leaf is split, else ``full`` itself."""
        dim = self.dims.get(name)
        if dim is None:
            return full
        k = full.shape[dim] // self.world
        return full.narrow(dim, self.rank * k, k)

    def gather(self, leaves: Sequence[Leaf], slices: Sequence[torch.Tensor],
               kind: str) -> List[torch.Tensor]:
        """The full tensors of ``leaves`` from every rank's ``slices`` (one
        all-gather, in the slices' type)."""
        flat = torch.cat([s.detach().reshape(-1) for s in slices])
        rows = self.all_gather(flat, kind)
        out, off = [], 0
        for leaf, s in zip(leaves, slices):
            k = s.numel()
            part = rows[:, off:off + k].reshape((self.world,) + tuple(s.shape))
            full = part.movedim(0, leaf.dim).reshape(leaf.shape)
            out.append(full.contiguous(memory_format=torch.channels_last)
                       if leaf.channels_last else full.contiguous())
            off += k
        return out

    def scatter_grads(self, leaves: Sequence[Leaf], grads) -> None:
        """The ranks' mean of the full gradients ``grads`` of ``leaves``,
        fp32, this rank's slices into ``grads`` (added where a leaf has one):
        one reduce-scatter. A missing gradient counts as zeros."""
        if not leaves:
            return
        sizes = [self.numel[leaf.name] // self.world for leaf in leaves]
        buf = torch.zeros((self.world, sum(sizes)), dtype=torch.float32, device=self.device)
        off = 0
        for leaf, g, k in zip(leaves, grads, sizes):
            if g is not None:
                d = leaf.dim
                per_rank = g.float().reshape(leaf.shape).unflatten(
                    d, (self.world, leaf.shape[d] // self.world)).movedim(d, 0)
                buf[:, off:off + k] = per_rank.reshape(self.world, k)
            off += k
        t0 = self._clock()
        mine = _reduce_scatter(self, buf).div_(self.world)
        comm_report.record("fsdp_reduce_scatter_bwd", buf.numel() * 4, time.perf_counter() - t0)
        for leaf, piece in zip(leaves, mine.split(sizes)):
            shape = list(leaf.shape)
            shape[leaf.dim] //= self.world
            piece = piece.view(shape)
            have = self.grads.get(leaf.name)
            self.grads[leaf.name] = piece if have is None else have + piece

    # ------------------------------------------------------------ a step

    @contextlib.contextmanager
    def first_stage_gathered(self) -> Iterator[None]:
        """The first stage's full parameters in place within the block."""
        if not self.active or not self.first_stage:
            yield
            return
        with torch.no_grad():
            unit = Unit(self, None, self.first_stage, False)
            with unit.installed():
                yield

    def grads_of(self, network: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The ranks' mean gradient of every trained parameter in fp32: the
        split ones from the reduce-scatters (taken out of ``grads``), the
        replicated ones all-reduced (``allreduce_mean``)."""
        from panacea_tpu_torch.parallel.train import allreduce_mean

        rest = [k for k in network if k not in self.leaves]
        out = dict(zip(rest, allreduce_mean([network[k].grad for k in rest])))
        for k in network:
            if k in self.leaves:
                out[k] = self.grads.pop(k)
        return out

    def missing(self, network: Dict[str, torch.Tensor]) -> List[str]:
        """The trained parameters no gradient reached in this backward."""
        return [k for k, p in network.items()
                if (k not in self.grads if k in self.leaves else p.grad is None)]

    # ------------------------------------------------------------ whole tensors

    def _buckets(self, tensors: Dict[str, torch.Tensor], bucket_bytes: int):
        """(names, their whole tensors) for the split ones among
        ``tensors``, gathered a bucket of about ``bucket_bytes`` at a time
        (one all-gather a bucket and type, every rank taking part)."""
        split = [k for k in tensors if k in self.leaves]
        for dtype in sorted({tensors[k].dtype for k in split}, key=str):
            names = [k for k in split if tensors[k].dtype == dtype]
            bucket, size = [], 0
            for i, k in enumerate(names):
                bucket.append(k)
                size += tensors[k].numel() * tensors[k].element_size()
                if size >= bucket_bytes or i == len(names) - 1:
                    yield bucket, self.gather([self.leaves[n] for n in bucket],
                                              [tensors[n] for n in bucket], "fsdp_state")
                    bucket, size = [], 0

    def full(self, tensors: Dict[str, torch.Tensor], bucket_bytes: int = STATE_BUCKET_BYTES,
             everywhere: bool = False) -> Optional[Dict[str, torch.Tensor]]:
        """The whole tensors of ``tensors`` (name -> this rank's part, split
        by the layout), on the CPU, on rank 0 (on every rank with
        ``everywhere``); None on the others. The split ones are gathered a
        bucket at a time (``_buckets``), so that no rank holds more than a
        bucket of them on its device."""
        out = {} if self.rank == 0 or everywhere else None
        if out is not None:
            out.update((k, v.detach().cpu()) for k, v in tensors.items() if k not in self.leaves)
        for names, fulls in self._buckets(tensors, bucket_bytes):
            if out is not None:
                out.update((n, f.cpu()) for n, f in zip(names, fulls))
        return None if out is None else {k: out[k] for k in tensors}

    @contextlib.contextmanager
    def unsharded(self) -> Iterator[None]:
        """Every split parameter whole on every rank within the block
        (gathered a bucket at a time, every rank taking part), with the
        units' gathers off and ``engine.shards`` unset, so that a rank can
        run the one-process step; the slices back after it."""
        slices = {n: leaf.module._parameters[leaf.attr] for n, leaf in self.leaves.items()}
        with torch.no_grad():
            for names, fulls in self._buckets(slices, STATE_BUCKET_BYTES):
                for n, f in zip(names, fulls):
                    leaf = self.leaves[n]
                    leaf.module._parameters[leaf.attr] = nn.Parameter(
                        f, requires_grad=slices[n].requires_grad)
        self.active = False
        self.engine.shards = None
        try:
            yield
        finally:
            self.active = True
            self.engine.shards = self
            for n, s in slices.items():
                leaf = self.leaves[n]
                leaf.module._parameters[leaf.attr] = s

    # ------------------------------------------------------------ bytes

    def counted_bytes(self, trained: Sequence[str], network_itemsize: int,
                      ema: bool) -> Dict[str, int]:
        """A rank's training state in bytes, counted from the layout: the
        network's parameters in their type, the first stage's in fp32, and
        for each trained parameter its fp32 master (where the network is
        not fp32), AdamW's two moments and the EMA's shadow."""
        def local(k):
            n = self.numel[k]
            return n // self.world if self.dims[k] is not None else n

        net = [k for k in self.numel if k.startswith("model.")]
        fs = [k for k in self.numel if k.startswith("first_stage_model.")]
        per_trained = 4 * (2 + int(ema) + int(network_itemsize != 4))
        out = {"network": sum(local(k) for k in net) * network_itemsize,
               "first_stage": sum(local(k) for k in fs) * 4,
               "trained_state": sum(local(k) for k in trained) * per_trained}
        out["total"] = sum(out.values())
        return out


def measured_bytes(state, engine) -> Dict[str, int]:
    """A rank's training state in bytes, measured on its tensors: the
    network's and the first stage's parameters, and the masters (where
    they are not the network's parameters), AdamW's moments and the EMA's
    shadows."""
    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    net = list(engine.model.parameters())
    ids = {id(p) for p in net}
    masters = [p for p in state.params.values() if id(p) not in ids]
    out = {"network": size(net), "first_stage": size(engine.first_stage_model.parameters()),
           "trained_state": size(masters) + size(state.optimizer.mu.values())
           + size(state.optimizer.nu.values())
           + (size(state.ema.shadows.values()) if state.ema is not None else 0)}
    out["total"] = sum(out.values())
    return out
