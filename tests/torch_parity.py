"""Helpers of the port's parity tests: weights drawn for every parameter and
carried between the port and the JAX package through
``panacea_tpu_torch.convert``'s maps, and the error measure.

``convert``'s maps send a flax path to a reference name; ``to_jax`` walks
them backwards, so a module whose JAX init is slow on the CPU (flax draws
every parameter op by op) gets its flax tree from the port's drawn state
dict. A flax path the map gets wrong is missing from that tree, and the
JAX module then refuses to run.
"""

import math

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from threadpoolctl import threadpool_limits

from panacea_tpu_torch import convert
from panacea_tpu_torch.models.layers import GroupNorm

_INVERSE = {
    convert._none: lambda w: w,
    convert._linear: np.transpose,
    convert._conv1d: lambda w: np.transpose(w, (2, 1, 0)),
    convert._conv2d: lambda w: np.transpose(w, (2, 3, 1, 0)),
    convert._conv1x1d: lambda w: np.transpose(w[:, :, 0]),
    convert._conv3d: lambda w: np.transpose(w, (2, 3, 4, 1, 0)),
    convert._deconv2d: lambda w: np.transpose(w, (2, 3, 0, 1))[::-1, ::-1],
}


@pytest.fixture
def two_threads():
    """Two threads for torch and BLAS: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(threads)


def draw(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Every parameter drawn from a numpy seed: matrices and kernels at
    1/sqrt(fan-in), norm scales 1 + 0.05 n, vectors 0.05 n. Zero-init
    layers are drawn too, so that every branch computes."""
    rng = np.random.default_rng(seed)
    scales = {f"{name}.weight" if name else "weight"
              for name, m in module.named_modules()
              if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm, GroupNorm))}
    sd = {}
    for k, v in module.state_dict().items():
        n = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.ndim >= 2:
            n /= math.sqrt(v[0].numel())
        elif k in scales:
            n = 1.0 + 0.05 * n
        else:
            n *= 0.05
        sd[k] = torch.from_numpy(n)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def to_jax(module: torch.nn.Module, mapping, prefix: str = "n.", packed=(), carried=()):
    """The flax tree of ``module``'s weights through ``mapping`` (reference
    names under ``prefix``; a transform that is no layout change of
    ``convert`` carries its own ``inverse``), and each (reference name, flax
    path) of ``packed``, a packed attention's ``in_proj`` split into the
    q/k/v Dense layers. Every name of the module must be mapped, or be
    one of ``carried``, which the caller carries itself."""
    sd = {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}
    tree = {}
    for ref, path in packed:
        w, b = sd.pop(f"{ref}.in_proj_weight"), sd.pop(f"{ref}.in_proj_bias")
        for name, wi, bi in zip(("q_proj", "k_proj", "v_proj"), np.split(w, 3), np.split(b, 3)):
            tree[path + (name, "kernel")], tree[path + (name, "bias")] = wi.T, bi
    unmapped = set(sd) - set(mapping) - set(carried)
    assert not unmapped, sorted(unmapped)[:5]
    tree.update({path: (_INVERSE[t] if t in _INVERSE else t.inverse)(sd[ref])
                 for ref, (path, t) in mapping.items() if ref in sd})
    return unflatten_dict(tree)


def assert_same_state(sd, module: torch.nn.Module) -> None:
    """``sd`` holds exactly ``module``'s state: the same names, shapes and
    values."""
    want = module.state_dict()
    assert sorted(sd) == sorted(want), sorted(set(sd) ^ set(want))[:5]
    for k, v in want.items():
        assert sd[k].shape == v.shape and torch.equal(sd[k], v), k


def from_jax(module: torch.nn.Module, params, mapping, prefix: str = "n."):
    """``module`` loaded (strict) from the JAX tree through ``mapping``."""
    sd = convert.apply_map(convert.flatten(params), mapping)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def rel_err(got, want) -> float:
    """The largest difference over the reference's largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def check(got, want, tol: float, name: str = "") -> float:
    err = rel_err(got, want)
    print(f"{name} rel_err {err:.3g}")
    assert err <= tol, (name, err)
    return err
