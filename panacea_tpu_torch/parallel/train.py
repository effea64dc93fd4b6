"""The collectives of data-parallel training over ``torch.distributed``.

Counterpart of ``panacea_tpu/parallel/train.py``'s ``dp`` axis, where the
parameters are replicated and the step's gradient is the global batch's
(the reference's DDP all-reduce): each rank computes the gradient of its
rows, ``allreduce_mean`` averages it over the ranks before the optimizer,
``broadcast_from_rank0`` makes the ranks start from one set of parameters,
and ``reduce_mean`` is mmdet's ``reduce_mean`` for the loss's avg factors.
Without a process group each of them is the identity.

Over a training grid (the JAX ``(dp, t)`` mesh; ``mesh.make_grid``: rank
``d * t + i`` holds clip group ``d``'s frames of slab ``i``) the same
``allreduce_mean`` over the whole world gives the global batch's gradient.
Rank r's loss L_r is the mean over its own frames, and every rank holds
the same number of frames, so the global mean loss is L = mean_r L_r. The
frame group's exchanges (``shardctx``: the frame halo, the temporal
statistics, the temporal all-to-all) are autograd functions whose
backward passes are their adjoints; the view group's have none and raise
where a gradient would need them. So rank r's backward of L_r puts on the
parameters it used its share of the gradient of sum_r L_r, the cross-rank
terms included (a neighbour's halo gradient comes back to the rank that
sent the frames, the statistics' gradients are all-reduced, the
all-to-all's are sent back by the inverse all-to-all); the shares sum
over the ranks to d(sum_r L_r)/d(theta), and their mean is dL/d(theta).
``tests/test_torch_train_grid.py`` holds it to one process.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch

# the size of one collective's bucket (DDP buckets gradients in 25 MiB)
BUCKET_BYTES = 64 << 20


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[int]]:
    """Indices of ``tensors`` in runs of one device whose fp32 size stays
    within ``bucket_bytes`` (a larger tensor is a bucket of its own)."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = 4 * t.numel()
        if out and size + nbytes <= bucket_bytes and tensors[out[-1][0]].device == t.device:
            out[-1].append(i)
            size += nbytes
        else:
            out.append([i])
            size = nbytes
    return out


def allreduce_mean(tensors: Sequence[torch.Tensor],
                   bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, in fp32: the tensors are
    flattened into buckets of about ``bucket_bytes``, one all-reduce (sum)
    a bucket, divided by the world size. The results are views of the
    buckets. Without a process group the tensors come back as they are."""
    if not _group_up():
        return list(tensors)
    import torch.distributed as dist

    world = dist.get_world_size()
    out: List[torch.Tensor] = [None] * len(tensors)
    for idx in _buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].detach().reshape(-1).float() for i in idx])
        dist.all_reduce(flat)
        flat.div_(world)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def _fingerprint(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Element count, sum and sum of squares of each tensor, in float64."""
    rows = [torch.stack([torch.tensor(float(t.numel()), dtype=torch.float64, device=t.device),
                         t.detach().double().sum(), t.detach().double().square().sum()])
            for t in tensors]
    return torch.stack(rows).cpu() if rows else torch.zeros((0, 3), dtype=torch.float64)


def broadcast_from_rank0(tensors: Sequence[torch.Tensor],
                         bucket_bytes: int = BUCKET_BYTES) -> None:
    """Give every rank rank 0's values of ``tensors`` (in place, one
    broadcast a bucket), then ``assert_same``. Without a process group
    nothing happens."""
    if not _group_up():
        return
    import torch.distributed as dist

    with torch.no_grad():
        for idx in _buckets(tensors, bucket_bytes):
            dtypes = {tensors[i].dtype for i in idx}
            for dtype in dtypes:
                part = [i for i in idx if tensors[i].dtype == dtype]
                flat = torch.cat([tensors[i].detach().reshape(-1) for i in part])
                dist.broadcast(flat, src=0)
                for i, piece in zip(part, flat.split([tensors[i].numel() for i in part])):
                    tensors[i].copy_(piece.view(tensors[i].shape))
    assert_same(tensors)


def assert_same(tensors: Sequence[torch.Tensor]) -> None:
    """Raise unless every rank holds the same ``tensors``: each one's
    element count, sum and sum of squares (float64) compared over the
    ranks. Nothing without a process group."""
    if not _group_up():
        return
    import torch.distributed as dist

    mine = _fingerprint(tensors)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    for rank, theirs in enumerate(every):
        if theirs.shape != mine.shape or not torch.equal(theirs, mine):
            raise RuntimeError(f"rank {dist.get_rank()}: the parameters differ from rank "
                               f"{rank}'s")


def reduce_mean(x: Union[torch.Tensor, float]) -> torch.Tensor:
    """The mean over the ranks of ``x`` (a number or a tensor, detached):
    mmdet's ``reduce_mean`` of a loss's avg factor. Without a process
    group, ``x`` as a tensor."""
    t = torch.as_tensor(x).detach()
    if not t.is_floating_point():
        t = t.float()
    if not _group_up():
        return t
    import torch.distributed as dist

    # NCCL reduces CUDA tensors only
    home = t.device
    work = t.to(torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl" else home, copy=True)
    dist.all_reduce(work)
    return (work / dist.get_world_size()).to(home)


def mean_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Logged numbers averaged over the ranks, in one all-reduce."""
    if not _group_up() or not metrics:
        return dict(metrics)
    keys = sorted(metrics)
    values = reduce_mean(torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64))
    return dict(zip(keys, values.tolist()))


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on some rank (``flag`` without a process group)."""
    if not _group_up():
        return bool(flag)
    return bool(reduce_mean(float(bool(flag))) > 0)


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if _group_up():
        import torch.distributed as dist

        dist.barrier()
