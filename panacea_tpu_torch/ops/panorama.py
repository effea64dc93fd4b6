"""View-axis helpers of the decomposed 4D attention (counterpart of
``panacea_tpu/ops/panorama.py``).

The panorama stitches the 6 camera views along width in the order
F, FR, BR, B, BL, FL (reference nuscenes_datasets_video.py:509,537).
"""

from __future__ import annotations

import torch

NUM_VIEWS = 6


def split_views(x: torch.Tensor, views: int = NUM_VIEWS) -> torch.Tensor:
    """(B, H, W_pano, C) -> (B, V, H, W_view, C); ``views``: the views the
    width holds (fewer than 6 on a rank that holds part of the panorama)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, views, w // views, c).permute(0, 2, 1, 3, 4)


def merge_views(x: torch.Tensor) -> torch.Tensor:
    """(B, V, H, W_view, C) -> (B, H, W_pano, C)"""
    b, v, h, wv, c = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, h, v * wv, c)


def neighbor_kv(x: torch.Tensor) -> torch.Tensor:
    """Each view's cross-view K/V source, [left neighbour, right neighbour]
    with circular wraparound (reference attention.py:545-559, left first).

    x: (B, V, S, ...) -> (B, V, 2*S, ...)
    """
    left = torch.roll(x, shifts=1, dims=1)    # view i sees view i-1
    right = torch.roll(x, shifts=-1, dims=1)  # view i sees view i+1
    return torch.cat([left, right], dim=2)
