"""Flash attention: the CUDA kernels of ``csrc/flash_attention.cu`` and their
plain PyTorch version.

Counterpart of ``panacea_tpu/ops/flash_attention.py`` (the Pallas kernel
``_flash_kernel`` and its streamed plain-JAX copy ``_lax_flash``).
Layout: q (B, Sq, H, D), k and v (B, Skv, H, D) -> (B, Sq, H, D).
``kv_lens``: optional (B,) int32 valid key counts per batch row (each >= 1).

On a CPU tensor ``flash_attention`` runs ``flash_attention_plain``. On a
CUDA tensor it launches a kernel or raises: it never falls back. The
operands keep their type, as in the Pallas kernel: bf16 at head dim 64 goes
to the wgmma/TMA kernel, at 16, 32 and 128 to the mma.sync kernel
(``_tma.flash_route``); fp32 goes to the fp32 kernel (products on the FMA
units, no TF32). ``flash_attention.launches`` counts all launches and
``flash_attention.route_launches`` each route's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from panacea_tpu_torch.ops import _build, _tma

LOG2E = 1.4426950408889634
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
PLAIN_BLOCK_K = 512  # keys per chunk of the plain version, as _lax_flash


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KV-chunked online softmax, the recurrence of ``_lax_flash``
    (panacea_tpu/ops/flash_attention.py:108-163): fp32 scores, max, sum and
    accumulator, base-2 exponent with log2(e) folded into the scale,
    probabilities cast to v's dtype before the PV product. Never holds more
    than one (Sq, PLAIN_BLOCK_K) chunk of scores. Inputs of any float dtype are
    computed in fp32; the result has q's dtype."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    qt = q.permute(0, 2, 1, 3).float()                    # (B, H, Sq, D)
    kt = k.permute(0, 2, 1, 3).float()
    vt = v.permute(0, 2, 1, 3)
    if kv_lens is None:
        row_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    else:
        row_len = kv_lens.to(device=q.device, dtype=torch.int32)
    row_len = row_len[:, None, None, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for j in range(0, skv, PLAIN_BLOCK_K):
        ks, vs = kt[:, :, j:j + PLAIN_BLOCK_K], vt[:, :, j:j + PLAIN_BLOCK_K]
        s = torch.matmul(qt, ks.transpose(-1, -2)) * (scale * LOG2E)
        col = torch.arange(j, j + ks.shape[2], device=q.device)
        s = torch.where(col < row_len, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(vs.dtype).float(), vs.float())
        m = m_new
    return (acc / den).permute(0, 2, 1, 3).to(q.dtype)


def _route(dtype: torch.dtype, d: int) -> str:
    return "fp32" if dtype == torch.float32 else _tma.flash_route(d)


def _check_cuda(q, k, v, kv_lens, d):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: the CUDA kernels take bf16 or fp32, got q {q.dtype}")
    # a row of the head dim is read in 16-byte pieces: 8 bf16 or 4 fp32
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: q is {q.dtype} and {name} is {t.dtype}; "
                            "the kernels take one type for all three")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} strides {t.stride()} must be "
                             f"multiples of {vec} ({q.dtype}: 16 bytes) with a unit "
                             "head-dim stride")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if kv_lens is not None:
        if (kv_lens.device != q.device or kv_lens.dtype != torch.int32
                or kv_lens.shape != (q.shape[0],) or not kv_lens.is_contiguous()):
            raise ValueError("flash_attention: kv_lens must be a contiguous (B,) "
                             "int32 tensor on q's device")
    if _route(q.dtype, d) == "mma" and q.shape[0] * q.shape[2] > 65535:
        raise ValueError("flash_attention: batch * heads exceeds the mma.sync kernel's "
                         "65535 grid rows")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention.cu")
    lib.pn_flash_attention_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_float, ctypes.c_void_p]
    lib.pn_flash_attention_bf16.restype = ctypes.c_int
    lib.pn_flash_attention_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    lib.pn_flash_attention_f32.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v; q (B, Sq, H, D), k/v (B, Skv, H, D)."""
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    scale = d**-0.5 if scale is None else float(scale)
    if not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be positive")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, kv_lens=kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v, kv_lens, d)
    lib = _lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    route = _route(q.dtype, d)
    lens_ptr = kv_lens.data_ptr() if kv_lens is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "fp32":
        err = lib.pn_flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens_ptr,
            b, h, sq, k.shape[1], d, strides, scale, stream)
    else:
        maps = None
        if route == "wgmma":
            # 4-D views (B, S, H, D), loaded as (rows, 64) boxes of one head
            spec = (_tma.map_spec(q, (1, _tma.FLASH_BQ, 1, d))
                    + _tma.map_spec(k, (1, _tma.FLASH_BK, 1, d))
                    + _tma.map_spec(v, (1, _tma.FLASH_BK, 1, d)))
            maps = (ctypes.c_longlong * len(spec))(*spec)
        err = lib.pn_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens_ptr,
            b, h, sq, k.shape[1], d, strides, maps, scale, stream)
    _build.check(lib, err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "mma": 0, "fp32": 0}

