"""The sharded context of one clip over several ranks (counterpart of
``panacea_tpu/parallel/shardctx.py``).

Under the JAX mesh the partitioner inserts the communication that the
module docstring there sets out: a one-frame halo for the temporal
convolutions, a statistics psum for the temporal norm, an all-to-all in and
out of the temporal attention, and the cross-view ring. The port writes
each exchange by hand, over the process groups of a ``mesh.Grid``:

  * ``halo_w``: one column a side from the neighbouring view ranks, zeros at
    the panorama's two ends (its convolutions zero-pad; nothing wraps);
  * ``halo_t``: one frame a side from the neighbouring frame ranks, zeros at
    the clip's ends;
  * ``group_stats``: a GroupNorm's statistics over a group of ranks, the
    fp32 sum and then the centred sum of squares, each all-reduced (the
    two passes of the one-process ``var_mean``);
  * ``temporal_in`` / ``temporal_out``: the temporal stage's all-to-all over
    the ``t`` group (Ulysses): frames gathered and pixels scattered on the
    way in, the reverse on the way out;
  * ``gather_view``: an all-gather over the ``view`` group;
  * ``ring_exchange``: the cross-view boundary K/V (``ring_attention.py``);
  * ``gather_clip`` / ``gather_rows``: the clip's latents and decoded frames
    over every rank.

Training over ``t`` (the JAX ``make_train_step`` on a ``(dp, t)`` mesh)
differentiates through the exchanges of the frame group, so each is a
``torch.autograd.Function`` whose backward sends the gradient the other
way: a frame halo's gradient goes back to the rank that sent the frames,
which adds it to its edge frames (the zeros at the clip's ends take
none); the statistics' all-reduce (sum) is its own adjoint, an all-reduce
of the incoming gradients over the same group; the all-to-all's adjoint
is the inverse all-to-all, the same call on the gradient laid out as the
output. Each backward is counted in ``comm_report`` under its own kind
(``halo_t_bwd``, ``stats_t_bwd``, ``all_to_all_bwd``). Every rank's
backward issues them in one order, as it runs one graph.

The exchanges of the view group (``halo_w``, the statistics over
``view``, the ring, ``gather_view``) and the gathers stay forward-only:
no JAX path trains over ``view``. Given a tensor that needs a gradient
they raise; they never hand back a wrong one.

``sharded(grid)`` holds the grid in a context variable around sampling
and training; layers read it with ``current()``. Without it every layer
runs its one-process code, down to the same calls. ``checkpoint_contexts``
is the ``context_fn`` of the network's ``torch.utils.checkpoint``: the
recomputed forward, which runs inside the backward (in another thread on
the card), sees the grid of the forward it repeats, and its exchanges
(and those of the sharded training state, ``parallel/fsdp.py``) count as
recomputed.

Transport, chosen by the backend and nothing else: NCCL on CUDA tensors
(a rank a card), gloo on CPU tensors, and gloo with CUDA tensors (ranks
that share a card) through explicit host copies: each exchange copies its
send buffers to the host, runs there and copies the result back. A failing
exchange raises; nothing retries on another path. Each exchange is counted
in ``comm_report``.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, List, Optional, Sequence

import torch

from panacea_tpu_torch.parallel import comm_report
from panacea_tpu_torch.parallel.mesh import NUM_VIEWS, Grid

_CTX: contextvars.ContextVar = contextvars.ContextVar("panacea_view_shard", default=None)
# point-to-point tags: what a rank sends to its left and to its right neighbour
TAG_TO_LEFT, TAG_TO_RIGHT = 1, 2


def current() -> Optional[Grid]:
    return _CTX.get()


@contextlib.contextmanager
def sharded(grid: Optional[Grid]) -> Iterator[Optional[Grid]]:
    """Layers see ``grid`` within the block; None leaves them as they are."""
    if grid is None:
        yield None
        return
    token = _CTX.set(grid)
    try:
        yield grid
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def _recomputing(grid: Optional[Grid]) -> Iterator[None]:
    with sharded(grid), comm_report.recompute():
        yield


def checkpoint_contexts():
    """``context_fn`` of ``torch.utils.checkpoint`` (non-reentrant): no
    context around the forward; around its recomputation in the backward,
    the grid that holds now, and the exchanges (the grid's, the sharded
    state's gathers) counted as recomputed."""
    return contextlib.nullcontext(), _recomputing(current())


def _forward_only(kind: str, *xs: torch.Tensor) -> None:
    """Raise where autograd would need the backward of exchange ``kind``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(f"{kind} has no backward pass: no JAX path trains over the 'view' "
                           "axis (make_train_step takes a (dp, t) mesh); run it under "
                           "torch.no_grad(), or train over t alone")


def local_frames(frames: int) -> int:
    """The frames a rank holds of a clip of ``frames``."""
    g = current()
    return frames if g is None else frames // g.t


def local_views() -> int:
    """The camera views a rank holds of the panorama."""
    g = current()
    return NUM_VIEWS if g is None else NUM_VIEWS // g.view


def split_width(w: int, g: Grid) -> int:
    """The columns a rank holds of a panorama ``w`` wide: whole views, 6 / V
    of them. Raises where the panorama does not split into 6 views."""
    if w % NUM_VIEWS:
        raise ValueError(f"a panorama {w} columns wide does not split into {NUM_VIEWS} views "
                         f"over {g.view} view ranks")
    return w // g.view


# ------------------------------------------------------------- transport


def _clock(g: Grid, like: torch.Tensor) -> float:
    if g.host_staged and like.is_cuda:
        torch.cuda.synchronize(like.device)   # the card's queue is not the exchange's time
    return time.perf_counter()


def _to_wire(g: Grid, x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True).contiguous() if g.host_staged else x.contiguous()


def _from_wire(g: Grid, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device, non_blocking=False) if g.host_staged else x


def _p2p(g: Grid, kind: str, like: torch.Tensor, sends, recvs) -> List[torch.Tensor]:
    """``sends``: (tensor, peer, tag); ``recvs``: (shape, peer, tag), in
    ``like``'s type. One ``batch_isend_irecv`` over the default group (peers
    are global ranks); the received tensors come back in ``recvs``' order."""
    import torch.distributed as dist

    if not sends and not recvs:
        return []
    t0 = _clock(g, like)
    wire_dev = torch.device("cpu") if g.host_staged else like.device
    out = [torch.empty(shape, dtype=like.dtype, device=wire_dev) for shape, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, _to_wire(g, t), peer, tag=tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, o, peer, tag=tag) for o, (_, peer, tag) in zip(out, recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [_from_wire(g, o, like) for o in out]
    comm_report.record(kind, sum(t.numel() * t.element_size() for t, _, _ in sends),
                       time.perf_counter() - t0)
    return out


def _all_reduce(g: Grid, kind: str, x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    t0 = _clock(g, x)
    y = _to_wire(g, x) if g.host_staged else x.clone()
    dist.all_reduce(y, group=group)
    y = _from_wire(g, y, x)
    comm_report.record(kind, x.numel() * x.element_size(), time.perf_counter() - t0)
    return y


def _all_to_all(g: Grid, kind: str, x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n, ...) with n the group's size: part i goes to the group's
    i-th rank, and part i of the result came from it."""
    import torch.distributed as dist

    t0 = _clock(g, x)
    send = _to_wire(g, x)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = _from_wire(g, recv, x)
    comm_report.record(kind, x.numel() * x.element_size(), time.perf_counter() - t0)
    return out


def _all_gather(g: Grid, kind: str, x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    import torch.distributed as dist

    _forward_only(kind, x)
    t0 = _clock(g, x)
    send = _to_wire(g, x)
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    parts = [_from_wire(g, p, x) for p in parts]
    comm_report.record(kind, x.numel() * x.element_size(), time.perf_counter() - t0)
    return parts


# ------------------------------------------------------------- exchanges


def _neighbours(ranks: Sequence[int], index: int):
    """(left, right) neighbours of ``ranks[index]``, None past the ends."""
    return (ranks[index - 1] if index > 0 else None,
            ranks[index + 1] if index < len(ranks) - 1 else None)


def _halo(g: Grid, kind: str, x: torch.Tensor, dim: int, ranks: Sequence[int], index: int,
          pad: int) -> torch.Tensor:
    """``x`` with ``pad`` slices a side along ``dim`` from the neighbouring
    ranks of ``ranks`` (this rank is ``ranks[index]``), zeros past the ends."""
    left, right = _neighbours(ranks, index)
    edge = list(x.shape)
    edge[dim] = pad
    sends, recvs = [], []
    if left is not None:
        sends.append((x.narrow(dim, 0, pad), left, TAG_TO_LEFT))
        recvs.append((edge, left, TAG_TO_RIGHT))
    if right is not None:
        sends.append((x.narrow(dim, x.shape[dim] - pad, pad), right, TAG_TO_RIGHT))
        recvs.append((edge, right, TAG_TO_LEFT))
    got = iter(_p2p(g, kind, x, sends, recvs))
    lo = next(got) if left is not None else x.new_zeros(edge)
    hi = next(got) if right is not None else x.new_zeros(edge)
    return torch.cat([lo, x, hi], dim=dim)


def _halo_grad(g: Grid, kind: str, gy: torch.Tensor, dim: int, ranks: Sequence[int],
               index: int, pad: int) -> torch.Tensor:
    """The adjoint of ``_halo``: the gradient of the slab's own slices, plus
    the gradients of its edge slices that the neighbours received, sent
    back by them; each halo's gradient goes to the rank it came from."""
    left, right = _neighbours(ranks, index)
    n = gy.shape[dim] - 2 * pad
    gx = gy.narrow(dim, pad, n).clone()
    edge = list(gx.shape)
    edge[dim] = pad
    sends, recvs = [], []
    if left is not None:       # the left halo's gradient to the left, as its right edge's
        sends.append((gy.narrow(dim, 0, pad), left, TAG_TO_LEFT))
        recvs.append((edge, left, TAG_TO_RIGHT))
    if right is not None:
        sends.append((gy.narrow(dim, n + pad, pad), right, TAG_TO_RIGHT))
        recvs.append((edge, right, TAG_TO_LEFT))
    got = iter(_p2p(g, kind, gy, sends, recvs))
    if left is not None:
        gx.narrow(dim, 0, pad).add_(next(got))
    if right is not None:
        gx.narrow(dim, n - pad, pad).add_(next(got))
    return gx


class _HaloT(torch.autograd.Function):
    """``halo_t`` with its backward (``_halo_grad``)."""

    @staticmethod
    def forward(ctx, x, g, pad):
        ctx.g, ctx.pad = g, pad
        return _halo(g, "halo_t", x, 1, g.t_ranks, g.t_index, pad)

    @staticmethod
    def backward(ctx, gy):
        g = ctx.g
        return _halo_grad(g, "halo_t_bwd", gy, 1, g.t_ranks, g.t_index, ctx.pad), None, None


class _AllReduce(torch.autograd.Function):
    """An all-reduce (sum) over ``group``; its adjoint is the same
    all-reduce of the gradients."""

    @staticmethod
    def forward(ctx, x, g, kind, group):
        ctx.g, ctx.kind, ctx.group = g, kind, group
        return _all_reduce(g, kind, x, group)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(ctx.g, ctx.kind + "_bwd", gy, ctx.group), None, None, None


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` over the ``t`` group; its adjoint is the inverse
    all-to-all: part i of the gradient goes back to rank i."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_to_all(g, "all_to_all", x, g.t_group)

    @staticmethod
    def backward(ctx, gy):
        return _all_to_all(ctx.g, "all_to_all_bwd", gy.contiguous(), ctx.g.t_group), None


def halo_w(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W + 2 pad, C): the neighbouring view ranks'
    edge columns, zeros at the panorama's ends. Forward-only."""
    g = current()
    _forward_only("halo_w", x)
    return _halo(g, "halo_w", x, 2, g.view_ranks, g.view_index, pad)


def halo_t(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """(B, T_local, ...) -> (B, T_local + 2 pad, ...): the neighbouring
    frame ranks' edge frames, zeros at the clip's ends."""
    return _HaloT.apply(x, current(), pad)


def group_stats(xf: torch.Tensor, dims, over: str, eps: float):
    """(mean, rsqrt(var + eps)) of fp32 ``xf`` over ``dims`` and over the
    ranks of the ``over`` group ('view' or 't'), each holding an equal part:
    the sum, then the centred sum of squares, each all-reduced. Over 't'
    both all-reduces have their backward; over 'view' they are forward-only."""
    g = current()
    group, size = (g.view_group, g.view) if over == "view" else (g.t_group, g.t)
    kind = "stats_" + over
    if over == "view":
        _forward_only(kind, xf)
    n = size
    for d in dims:
        n *= xf.shape[d]
    mean = _AllReduce.apply(xf.sum(dim=dims, keepdim=True), g, kind, group) / n
    css = _AllReduce.apply((xf - mean).square().sum(dim=dims, keepdim=True), g, kind, group)
    return mean, torch.rsqrt(css / n + eps)


def temporal_in(h: torch.Tensor, b: int, t_local: int) -> torch.Tensor:
    """(b * t_local, H, W, C), this rank's frames -> (b * P', T, C): every
    frame of this rank's 1/t of the pixels, P' = H W / t, clip-major."""
    g = current()
    n, hh, ww, c = h.shape
    p = hh * ww
    if p % g.t:
        raise ValueError(f"{p} pixels do not split over t = {g.t} frame ranks")
    pt = p // g.t
    x = h.reshape(b, t_local, g.t, pt, c).permute(2, 0, 1, 3, 4)
    y = _AllToAll.apply(x, g)                       # (t, b, t_local, pt, c) from each rank
    return y.permute(1, 3, 0, 2, 4).reshape(b * pt, g.t * t_local, c)


def temporal_out(h: torch.Tensor, b: int, hh: int, ww: int) -> torch.Tensor:
    """The inverse of ``temporal_in``: (b * P', T, C) -> (b * T / t, H, W, C)."""
    g = current()
    _, tt, c = h.shape
    t_local, pt = tt // g.t, hh * ww // g.t
    x = h.reshape(b, pt, g.t, t_local, c).permute(2, 0, 3, 1, 4)
    y = _AllToAll.apply(x, g)                       # (t, b, t_local, pt, c): pixels by rank
    return y.permute(1, 2, 0, 3, 4).reshape(b * t_local, hh, ww, c)


def gather_view(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The view group's ``x`` side by side along ``dim``, in view order."""
    g = current()
    return torch.cat(_all_gather(g, "gather_view", x, g.view_group, g.view), dim=dim)


def ring_exchange(to_right: torch.Tensor, to_left: torch.Tensor):
    """(from the left neighbour, from the right neighbour) over the view
    ring, which wraps: view rank 0's left is the last view rank."""
    g = current()
    _forward_only("ring", to_right, to_left)
    v, j = g.view, g.view_index
    left, right = g.view_ranks[(j - 1) % v], g.view_ranks[(j + 1) % v]
    # sends right then left, receives from the left then the right: with
    # V = 2 both neighbours are one rank, and the tags (NCCL: the order)
    # keep the two messages apart
    got = _p2p(g, "ring", to_right,
               [(to_right, right, TAG_TO_RIGHT), (to_left, left, TAG_TO_LEFT)],
               [(tuple(to_right.shape), left, TAG_TO_RIGHT),
                (tuple(to_left.shape), right, TAG_TO_LEFT)])
    return got[0], got[1]


def gather_clip(x: torch.Tensor, g: Grid, clips: int) -> torch.Tensor:
    """(clips * T_local, h, w_local, C) on each rank -> (clips * T, h, w, C),
    the whole clip on every rank (an all-gather over every rank)."""
    import torch.distributed as dist

    n, hh, wl, c = x.shape
    tl = n // clips
    parts = _all_gather(g, "gather", x, dist.group.WORLD, g.world)
    full = x.new_empty((clips, tl * g.t, hh, wl * g.view, c))
    for r, part in enumerate(parts):
        ti, vi = divmod(r, g.view)
        full[:, ti * tl:(ti + 1) * tl, :, vi * wl:(vi + 1) * wl] = part.reshape(clips, tl, hh,
                                                                                 wl, c)
    return full.reshape(clips * tl * g.t, hh, wl * g.view, c)


def row_split(n: int, world: int) -> List[int]:
    """Rows of ``n`` a rank takes, the first ranks one more where they do
    not split evenly (``numpy.array_split``)."""
    return [n // world + (1 if r < n % world else 0) for r in range(world)]


def gather_rows(x: torch.Tensor, g: Grid, counts: Sequence[int]) -> torch.Tensor:
    """Rank r's ``counts[r]`` rows of ``x`` (zero rows allowed), stacked in
    rank order on every rank."""
    import torch.distributed as dist

    most = max(counts)
    pad = x.new_zeros((most,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = _all_gather(g, "gather", pad, dist.group.WORLD, g.world)
    return torch.cat([p[:k] for p, k in zip(parts, counts)])
