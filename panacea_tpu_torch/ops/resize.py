"""``jax.image.resize`` in PyTorch (jax/_src/image/scale.py), which the JAX
package's embedders call and ``F.interpolate`` does not reproduce:

  * it is separable: each axis whose size changes is one product with an
    (out, in) weight matrix, sampled at half-pixel centres;
  * on the way down, ``antialias`` widens the kernel by the scale (a low-pass
    filter), where ``F.interpolate`` without antialias only samples;
  * its cubic is Keys' with a = -0.5 (torch's bicubic uses -0.75);
  * each output column's weights are renormalised to sum to 1, and a sample
    point outside the input gets none;
  * ``nearest`` takes input index floor((i + 0.5) * in / out), torch's
    ``nearest-exact``.
"""

from __future__ import annotations

from typing import Sequence

import torch

METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
           "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
           "bicubic": "cubic", "tricubic": "cubic"}


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool = True,
                  device=None) -> torch.Tensor:
    """(out_size, in_size) fp32 weights of one axis (``compute_weight_mat``
    with scale out/in and no translation)."""
    kernel = _keys_cubic if method == "cubic" else _triangle
    # the scale out/in and its inverse in fp32, as jax computes them
    inv_scale = torch.tensor(1.0) / torch.tensor(out_size / in_size, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else torch.tensor(1.0)
    inv_scale, kernel_scale = inv_scale.to(device), kernel_scale.to(device)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[:, None] - src[None, :]).abs() / kernel_scale)
    total = w.sum(dim=1, keepdim=True)
    keep = total.abs() > 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(keep, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return w * inside[:, None]


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for the methods the
    JAX package uses (nearest, linear, cubic and their aliases). Axes whose
    size is unchanged are left alone, as in jax."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has not the rank of {tuple(x.shape)}")
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}")
    kind = METHODS[method]
    if not x.is_floating_point():
        x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if kind == "nearest":
            idx = ((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).floor().long()
            x = x.index_select(d, idx.to(x.device))
            continue
        w = weight_matrix(m, n, kind, antialias, device=x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [1])), -1, d)
    return x
