"""GridMask augmentation of detector training.

Counterpart of ``panacea_tpu/perception/gridmask.py:16`` (reference
models/utils/grid_mask.py, ratio 0.5, mode 1): with probability ``prob``
every image of the batch loses a regular grid of square holes, one draw
of period, offset and the apply coin for the whole call, as in the JAX
package. The draws come from a ``torch.Generator`` or are given.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class GridDraws(NamedTuple):
    apply: bool   # whether the mask is applied
    d: int        # the grid's period in pixels
    ox: int       # offsets in [0, d)
    oy: int


def draw_grid(generator: torch.Generator, h: int, prob: float = 0.7,
              d_range=None) -> GridDraws:
    """The draws of one call, on the host: d uniform over [2, H) (the
    reference's ``np.random.randint(2, h)``), or over ``d_range``."""
    lo, hi = d_range if d_range is not None else (2, max(h, 3))

    def randint(a, b):
        return int(torch.randint(a, b, (), generator=generator))

    d = randint(lo, hi)
    ox, oy = randint(0, max(d, 1)), randint(0, max(d, 1))
    apply = bool(torch.rand((), generator=generator) < prob)
    return GridDraws(apply, d, ox, oy)


def grid_mask(imgs: torch.Tensor, generator: Optional[torch.Generator] = None,
              draws: Optional[GridDraws] = None, ratio: float = 0.5, prob: float = 0.7,
              mode: int = 1, d_range=None) -> torch.Tensor:
    """imgs (..., H, W, C). The holes are ceil(d * ratio) pixels square;
    mode 1 zeroes them."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    if draws is None:
        draws = draw_grid(generator, h, prob, d_range)
    if not draws.apply:
        return imgs
    d = max(draws.d, 1)
    keep = int(math.ceil(float(draws.d) * ratio))
    yy = (torch.arange(h, device=imgs.device)[:, None] + draws.oy) % d
    xx = (torch.arange(w, device=imgs.device)[None, :] + draws.ox) % d
    hole = (yy < keep) & (xx < keep)
    mask = (hole if mode == 1 else ~hole)[..., None].to(imgs.dtype)
    return imgs * (1.0 - mask)
