"""Frechet distance metrics: FID (images) and FVD (videos).

Counterpart of ``panacea_tpu/metrics_gen/fid.py``: streaming activation
statistics and the Frechet distance, whose matrix square root comes from the
eigendecomposition of the symmetrised product, with the same eps ladder. The
statistics accumulate in float64 on the device of the features they are
given (the card, in the CLI); the distance is computed in float64 NumPy on
the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch


class StreamingStats:
    """Accumulates the mean and covariance of feature batches, in float64,
    on the device of the first batch."""

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self.sum: Optional[torch.Tensor] = None
        self.outer: Optional[torch.Tensor] = None

    def update(self, feats) -> None:
        feats = torch.as_tensor(feats)
        if self.sum is None:
            self.sum = feats.new_zeros(self.dim, dtype=torch.float64)
            self.outer = feats.new_zeros((self.dim, self.dim), dtype=torch.float64)
        feats = feats.to(self.sum.device, torch.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(dim=0)
        self.outer += feats.T @ feats

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("need at least 2 samples")
        mu = self.sum.cpu().numpy() / self.n
        cov = (self.outer.cpu().numpy() - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def _sqrtm_product(c1: np.ndarray, c2: np.ndarray) -> float:
    """tr(sqrt(c1 @ c2)) via the symmetric form: sqrt(c1) c2 sqrt(c1) is PSD
    with the nonzero spectrum of c1 c2. Where the eigensolver does not
    converge (rank-deficient covariances of few samples), retry with eps * I
    added to both (pytorch-fid's fallback)."""
    def attempt(a, b):
        vals1, vecs1 = np.linalg.eigh(a)
        vals1 = np.clip(vals1, 0, None)
        s1 = (vecs1 * np.sqrt(vals1)) @ vecs1.T
        m = s1 @ b @ s1
        vals = np.linalg.eigvalsh((m + m.T) / 2)
        return np.sqrt(np.clip(vals, 0, None)).sum()

    for eps in (0.0, 1e-6, 1e-3):
        try:
            reg = eps * np.eye(c1.shape[0])
            return attempt(c1 + reg, c2 + reg)
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError(
        "sqrtm eigendecomposition failed even with eps=1e-3 regularization")


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    diff = np.asarray(mu1) - np.asarray(mu2)
    tr_sqrt = _sqrtm_product(np.asarray(cov1), np.asarray(cov2))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


def _stats(batches: Iterable) -> StreamingStats:
    stats = None
    for fb in batches:
        fb = torch.as_tensor(fb)
        if stats is None:
            stats = StreamingStats(fb.shape[-1])
        stats.update(fb)
    if stats is None:
        raise ValueError("no feature batches")
    return stats


def compute_fid(real_feature_batches: Iterable, gen_feature_batches: Iterable) -> float:
    """Iterables of (N, D) features (tensors or arrays) -> FID."""
    mu1, c1 = _stats(real_feature_batches).finalize()
    mu2, c2 = _stats(gen_feature_batches).finalize()
    return frechet_distance(mu1, c1, mu2, c2)


def compute_fvd(real_video_features: Iterable, gen_video_features: Iterable) -> float:
    """FVD: the Frechet distance over per-clip video features (I3D's)."""
    return compute_fid(real_video_features, gen_video_features)
