"""Ring cross-view attention over the view ranks (counterpart of
``panacea_tpu/parallel/ring_attention.py``, its ``'ragged'`` form).

The cross-view stage needs only each view's two neighbours' K/V: a ring
over the 6 cameras. With the panorama's views split over ``V`` ranks, each
rank sends its boundary views' K/V one hop left and right over the view
group (``shardctx.ring_exchange``, one ``batch_isend_irecv``; view 0 takes
view 5 from the last rank) and attends locally in one call: every view's
queries to ``[left, right]`` K/V, with per-row ``kv_lens``. The global last
view gets ``s`` (its right block masked, the reference quirk,
attention.py:545-559 and JAX ``transformer.py:240-246``) where
``last_view_left_only``, every other view ``2 s``. At Sq >= 128 that call
is the flash kernel's ``kv_lens`` route (``ops/attention.py``).

The JAX ``'partial'`` branch exists for the CPU compile's memory estimate
and gives the same result; it is not ported. The one-process cross-view
stage keeps its two calls (``models/transformer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from panacea_tpu_torch.ops.attention import attention
from panacea_tpu_torch.parallel import shardctx
from panacea_tpu_torch.parallel.mesh import NUM_VIEWS, Grid


def ring_cross_view_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              grid: Optional[Grid], last_view_left_only: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, Vl, S, H, D), this rank's ``Vl = 6 / V`` contiguous views
    of each of B rows (frames); ``grid`` None (or a view group of one) is
    one rank holding all 6, which the transformer never sends here (it
    keeps its two calls): that form is the one-process reference the tests
    hold against JAX. Each view attends to concat[left, right] neighbour
    K/V with wraparound. Returns (B, Vl, S, H, D)."""
    b, vl, s, h, d = q.shape
    if grid is None or grid.view == 1:
        from_left = k[:, -1:], v[:, -1:]
        from_right = k[:, :1], v[:, :1]
        first = 0
    else:
        # the boundary views' K and V together: one message each way
        left, right = shardctx.ring_exchange(torch.stack([k[:, -1], v[:, -1]]),
                                             torch.stack([k[:, 0], v[:, 0]]))
        from_left = left[0].unsqueeze(1), left[1].unsqueeze(1)
        from_right = right[0].unsqueeze(1), right[1].unsqueeze(1)
        first = grid.view_index * vl
    kk = torch.cat([from_left[0], k[:, :-1], k[:, 1:], from_right[0]], dim=1)
    vv = torch.cat([from_left[1], v[:, :-1], v[:, 1:], from_right[1]], dim=1)
    # (B, 2 Vl, S, ...) as [left of each view, right of each view] -> (B, Vl, 2S, ...)
    kk = kk.reshape(b, 2, vl, s, h, d).transpose(1, 2).reshape(b * vl, 2 * s, h, d)
    vv = vv.reshape(b, 2, vl, s, h, d).transpose(1, 2).reshape(b * vl, 2 * s, h, d)
    lens = torch.full((vl,), 2 * s, dtype=torch.int32)
    if last_view_left_only:
        gidx = first + torch.arange(vl)
        lens = torch.where(gidx == NUM_VIEWS - 1, s, 2 * s).to(torch.int32)
    kv_lens = lens.repeat(b).to(q.device)
    out = attention(q.reshape(b * vl, s, h, d), kk, vv, scale=scale, kv_lens=kv_lens)
    return out.reshape(b, vl, s, h, d)
