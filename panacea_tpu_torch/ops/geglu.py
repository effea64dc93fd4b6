"""Fused GEGLU projection: the CUDA kernel ``csrc/geglu.cu`` and its plain
PyTorch version.

Counterpart of ``panacea_tpu/ops/geglu.py`` (the Pallas kernel
``_geglu_kernel`` and ``geglu_reference``). ``w`` has the torch Linear
layout (2*inner, C) = [W_h; W_gate] (the flax kernel is its transpose), and

    geglu(x, w, b) = (x W_h^T + b_h) * gelu_erf(x W_gate^T + b_gate)

On a CPU tensor ``geglu`` runs ``geglu_plain``. On a CUDA tensor it
launches a kernel or raises: it never falls back. The operands keep their
type, as in the Pallas kernel: bf16 goes to the wgmma/TMA kernel, fp32 to the
fp32 kernel (products on the FMA units, no TF32). ``geglu.launches`` counts
all launches and ``geglu.route_launches`` each type's.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from panacea_tpu_torch.ops import _build, _tma


def geglu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unfused form (``F.linear``, split, exact-erf GELU), computed in fp32
    from the given inputs; the result has x's dtype."""
    hg = F.linear(x.float(), w.float(), b.float())
    h, gate = hg.chunk(2, dim=-1)
    return (h * F.gelu(gate)).to(x.dtype)


def _check_cuda(x, w, b):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"geglu: the CUDA kernels take bf16 or fp32, got x {x.dtype}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"geglu: x is {x.dtype} and {name} is {t.dtype}; "
                            "the kernels take one type for all three")
        if t.device != x.device:
            raise ValueError(f"geglu: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu: {name} must be contiguous and 16-byte aligned")
    # a row of x or w is read in 16-byte pieces: 8 bf16 or 4 fp32
    vec = 16 // x.element_size()
    if x.shape[-1] % vec:
        raise ValueError(f"geglu: channels {x.shape[-1]} must be a multiple of {vec} "
                         f"({x.dtype}: 16 bytes)")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("geglu.cu")
    lib.pn_geglu_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pn_geglu_bf16.restype = ctypes.c_int
    lib.pn_geglu_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pn_geglu_f32.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., C), w (2*inner, C), b (2*inner,) -> (..., inner)."""
    c = x.shape[-1]
    if w.ndim != 2 or w.shape[1] != c or w.shape[0] % 2 or b.shape != (w.shape[0],):
        raise ValueError(f"geglu: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} do not match")
    if x.device.type == "cpu":
        return geglu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"geglu: no kernel for device {x.device}")
    _check_cuda(x, w, b)
    inner = w.shape[0] // 2
    x2 = x.reshape(-1, c)
    tokens = x2.shape[0]
    lib = _lib()
    out = torch.empty((tokens, inner), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        route = "fp32"
        err = lib.pn_geglu_f32(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                               tokens, c, inner, stream)
    else:
        route = "bf16"
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        _, _, blocks = _tma.geglu_grid(tokens, inner, _sm_count(index))
        spec = (_tma.map_spec(x2, (_tma.GEGLU_BM, _tma.GEGLU_BK))
                + _tma.map_spec(w, (_tma.GEGLU_BN, _tma.GEGLU_BK)))
        tma_store = _tma.geglu_tma_store(inner)
        if tma_store:
            spec += _tma.map_spec(out, _tma.GEGLU_OUT_BOX)
        err = lib.pn_geglu_bf16(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                tokens, c, inner, (ctypes.c_longlong * len(spec))(*spec),
                                int(tma_store), blocks, stream)
    _build.check(lib, err, f"geglu ({route})")
    geglu.launches += 1
    geglu.route_launches[route] += 1
    return out.reshape(*x.shape[:-1], inner)


geglu.launches = 0
geglu.route_launches = {"bf16": 0, "fp32": 0}

