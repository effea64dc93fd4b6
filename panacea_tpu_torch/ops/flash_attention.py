"""Flash attention: the CUDA kernels of ``csrc/flash_attention.cu`` and their
plain PyTorch version.

Counterpart of ``panacea_tpu/ops/flash_attention.py`` (the Pallas kernel
``_flash_kernel`` and its streamed plain-JAX copy ``_lax_flash``).
Layout: q (B, Sq, H, D), k and v (B, Skv, H, D) -> (B, Sq, H, D).
``kv_lens``: optional (B,) int32 valid key counts per batch row. A row with
0 valid keys answers as the reference's (every score masked alike): it
attends to all Skv keys with equal weight, so its output is the mean of V,
its dq and dk are 0 and its dv the sum over queries of dO / Skv. Every
version computes it as a row of Skv keys whose scores are all 0.

On a CPU tensor ``flash_attention`` runs ``flash_attention_plain``. On a
CUDA tensor it launches a kernel or raises: it never falls back. The
operands keep their type, as in the Pallas kernel: bf16 goes to the
wgmma/TMA kernel at every head dim, 16, 32, 64 and 128 (``_tma.flash_route``;
its tiles by head dim in ``csrc/flash_bf16_schedule.h``); fp32 goes to the
fp32 kernels
(``_tma.flash_f32_kernel``), at head dims 64 and 32 on the tensor cores as
3xTF32 (wgmma; TMA at 64, cp.async from the strides at 32, the perception
self-attention's), at 16 and 128 on the FMA units.
``flash_attention.launches`` counts all launches,
``flash_attention.route_launches`` each route's,
``flash_attention.fp32_kernel_launches`` each fp32 kernel's,
``flash_attention.bf16_head_dim_launches`` the bf16 kernel's at each head
dim and
``flash_attention.shape_launches`` each shape's ("BxSqxSkvxHxD", with
"+kv_lens" where the call gave per-row key counts).

Gradients: where autograd needs them, ``flash_attention`` goes through a
``torch.autograd.Function`` whose forward also writes the row log-sum-exp
(fp32, (B, H, Sq), base 2) and whose backward is ``flash_attention_bwd``:
``flash_attention_bwd_plain`` on a CPU tensor, and on a CUDA tensor the
kernels of ``csrc/flash_attention_bwd.cu``, routed as the forward: bf16 to
the wgmma/TMA kernels at every head dim, fp32 to the fp32 kernels (at head
dims 64 and 32 on the tensor cores as 3xTF32: TMA at 64, cp.async from the
strides at 32, the perception self-attention's; at 16 and 128 on the FMA
units) (``flash_attention_bwd.launches``,
``flash_attention_bwd.route_launches``,
``flash_attention_bwd.fp32_kernel_launches``,
``flash_attention_bwd.bf16_head_dim_launches``). The Pallas kernel has no VJP; the
JAX trainer differentiates its plain form (``_lax_flash``), and that is the
gradient computed here.
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


def _row_len(b: int, skv: int, kv_lens: Optional[torch.Tensor], device):
    """(row_len, empty): (B, 1, 1, 1) int32 valid key counts, and whether
    the row is empty (no valid key), which then attends to all Skv keys at
    scale 0."""
    if kv_lens is None:
        row_len = torch.full((b,), skv, dtype=torch.int32, device=device)
    else:
        row_len = kv_lens.to(device=device, dtype=torch.int32)
    row_len = row_len[:, None, None, None]
    empty = row_len <= 0
    return torch.where(empty, skv, row_len), empty


def _scores(qt, ks, j, scale, row_len, empty):
    """Base-2 scaled scores of one key chunk starting at ``j``, 0 in an
    empty row, masked (NEG_INF) from ``row_len`` on."""
    s = torch.matmul(qt, ks.transpose(-1, -2)) * (scale * LOG2E)
    s = torch.where(empty, torch.zeros_like(s), s)
    col = torch.arange(j, j + ks.shape[2], device=qt.device)
    return s, col < row_len


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          kv_lens: Optional[torch.Tensor] = None, return_lse: bool = False):
    """KV-chunked online softmax, the recurrence of ``_lax_flash``
    (panacea_tpu/ops/flash_attention.py:108-163): fp32 scores, max, sum and
    accumulator, base-2 exponent with log2(e) folded into the scale,
    probabilities cast to v's dtype before the PV product. Never holds more
    than one (Sq, PLAIN_BLOCK_K) chunk of scores. Inputs of any float dtype are
    computed in fp32, or in float64 where q is float64 (the reference of the
    fp32 kernel's check); the result has q's dtype. ``return_lse`` also
    returns the row log-sum-exp, (B, H, Sq), base 2 of the scaled scores, in
    the type computed in."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qt = q.permute(0, 2, 1, 3).to(ct)                     # (B, H, Sq, D)
    kt = k.permute(0, 2, 1, 3).to(ct)
    vt = v.permute(0, 2, 1, 3)
    row_len, empty = _row_len(b, skv, kv_lens, q.device)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=ct, device=q.device)
    den = torch.zeros((b, h, sq, 1), dtype=ct, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=ct, device=q.device)
    for j in range(0, skv, PLAIN_BLOCK_K):
        ks, vs = kt[:, :, j:j + PLAIN_BLOCK_K], vt[:, :, j:j + PLAIN_BLOCK_K]
        s, valid = _scores(qt, ks, j, scale, row_len, empty)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(vs.dtype).to(ct), vs.to(ct))
        m = m_new
    out = (acc / den).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log2(den))[..., 0]
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              scale: Optional[float] = None,
                              kv_lens: Optional[torch.Tensor] = None):
    """The gradient (dq, dk, dv) of ``flash_attention_plain`` at the output
    ``o`` with row log-sum-exp ``lse`` (B, H, Sq) and output gradient ``do``,
    in the backward kernels' arithmetic: Delta = rowsum(do * o) in fp32; per
    chunk of PLAIN_BLOCK_K keys, P = exp2(S scale log2(e) - lse) recomputed
    in fp32, dV = P^T dO with P rounded to v's dtype, dP = dO V^T,
    dS = P (dP - Delta), dQ = scale dS K and dK = scale dS^T Q with dS
    rounded to q's dtype. Masked keys get zero dk and dv; an empty row
    (``kv_lens`` 0) has P = exp2(0 - lse) over all Skv keys and dq = dk =
    0. Computed in fp32, or in float64 where q is float64 (the reference
    of the fp32 kernel's check); the results have the inputs' dtypes."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qt = q.permute(0, 2, 1, 3).to(ct)                     # (B, H, Sq, D)
    kt = k.permute(0, 2, 1, 3).to(ct)
    vt = v.permute(0, 2, 1, 3).to(ct)
    dot = do.permute(0, 2, 1, 3).to(ct)
    delta = (do.to(ct) * o.to(ct)).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, Sq, 1)
    lse = lse.to(ct)[..., None]
    row_len, empty = _row_len(b, skv, kv_lens, q.device)
    dq = torch.zeros_like(qt)
    dks, dvs = [], []
    for j in range(0, skv, PLAIN_BLOCK_K):
        ks, vs = kt[:, :, j:j + PLAIN_BLOCK_K], vt[:, :, j:j + PLAIN_BLOCK_K]
        s, valid = _scores(qt, ks, j, scale, row_len, empty)
        p = torch.where(valid, torch.exp2(s - lse), torch.zeros_like(s))
        dvs.append(torch.matmul(p.to(v.dtype).to(ct).transpose(-1, -2), dot))
        ds = p * (torch.matmul(dot, vs.transpose(-1, -2)) - delta)
        ds = ds.to(q.dtype).to(ct)
        dq += torch.matmul(ds, ks)
        dks.append(torch.matmul(ds.transpose(-1, -2), qt))
    # the scale of dq and dk: 0 in an empty row
    scale = torch.where(empty, 0.0, scale).to(ct)
    dk = torch.cat(dks, dim=2) * scale
    dv = torch.cat(dvs, dim=2)
    return ((dq * scale).permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention.cu")
    lib.pn_flash_attention_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_float, ctypes.c_void_p]
    lib.pn_flash_attention_bf16.restype = ctypes.c_int
    lib.pn_flash_attention_f32.argtypes = lib.pn_flash_attention_bf16.argtypes
    lib.pn_flash_attention_f32.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd.cu")
    lib.pn_flash_attention_bwd_bf16.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_float, ctypes.c_void_p])
    lib.pn_flash_attention_bwd_bf16.restype = ctypes.c_int
    lib.pn_flash_attention_bwd_f32.argtypes = lib.pn_flash_attention_bwd_bf16.argtypes
    lib.pn_flash_attention_bwd_f32.restype = ctypes.c_int
    return lib


def _check_args(q, k, v, scale):
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    scale = d**-0.5 if scale is None else float(scale)
    if not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} must be positive")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return scale


def _forward(q, k, v, scale: float, kv_lens, with_lse: bool):
    """(out, lse or None): the plain version on a CPU tensor, else a kernel."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, scale=scale, kv_lens=kv_lens, return_lse=True)
        return flash_attention_plain(q, k, v, scale=scale, kv_lens=kv_lens), None
    b, sq, h, d = q.shape
    _check_cuda(q, k, v, kv_lens, d)
    lib = _lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    lse_ptr = lse.data_ptr() if with_lse else None
    strides = (ctypes.c_longlong * 9)(*_tma.flash_strides(q, k, v))
    route = _route(q.dtype, d)
    lens_ptr = kv_lens.data_ptr() if kv_lens is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    spec = None
    if route != "fp32":  # the bf16 kernel at every head dim: TMA, wgmma
        spec = _tma.flash_map_specs(q, k, v)
    elif d == 64:        # the fp32 kernel on TMA, 3xTF32
        spec = _tma.flash_f32_map_specs(q, k, v)
    maps = None if spec is None else (ctypes.c_longlong * len(spec))(*spec)
    entry = lib.pn_flash_attention_f32 if route == "fp32" else lib.pn_flash_attention_bf16
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, lens_ptr,
                b, h, sq, k.shape[1], d, strides, maps, scale, stream)
    _build.check(lib, err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    if route == "fp32":
        flash_attention.fp32_kernel_launches[_tma.flash_f32_kernel(d)] += 1
    else:
        flash_attention.bf16_head_dim_launches[d] += 1
    shape = f"{b}x{sq}x{k.shape[1]}x{h}x{d}" + ("+kv_lens" if kv_lens is not None else "")
    flash_attention.shape_launches[shape] = flash_attention.shape_launches.get(shape, 0) + 1
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None,
                             kv_lens: Optional[torch.Tensor] = None):
    """(out, lse): the forward, also writing the row log-sum-exp (fp32,
    (B, H, Sq), base 2 of the scaled scores) that the backward reads."""
    scale = _check_args(q, k, v, scale)
    return _forward(q, k, v, scale, kv_lens, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, scale: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of softmax(q k^T * scale) v at the output ``o`` with the
    forward's row log-sum-exp ``lse`` (B, H, Sq) and the output gradient
    ``do``. A CPU tensor takes ``flash_attention_bwd_plain``; a CUDA tensor
    the kernels of ``csrc/flash_attention_bwd.cu`` on the route of its type
    and head dim (``_route``)."""
    scale = _check_args(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale, kv_lens=kv_lens)
    b, sq, h, d = q.shape
    _check_cuda(q, k, v, kv_lens, d)
    o, do = o.contiguous(), do.contiguous()
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape), ("lse", lse, (b, h, sq))):
        if t.shape != shape or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} on {t.device} "
                             f"does not fit q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise TypeError("flash_attention_bwd: o and do must have q's type and lse be "
                        "contiguous fp32")
    lib = _bwd_lib()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*_tma.flash_strides(q, k, v))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            kv_lens.data_ptr() if kv_lens is not None else None, b, h, sq, k.shape[1], d,
            strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = _route(q.dtype, d)
    spec = None
    if route != "fp32":  # the bf16 kernels at every head dim: TMA, wgmma
        spec = _tma.flash_bwd_map_specs(q, k, v, do)
    elif d == 64:        # the fp32 kernels on TMA, 3xTF32
        spec = _tma.flash_bwd_f32_map_specs(q, k, v, do)
    maps = None if spec is None else (ctypes.c_longlong * len(spec))(*spec)
    entry = lib.pn_flash_attention_bwd_f32 if route == "fp32" else lib.pn_flash_attention_bwd_bf16
    err = entry(*args, maps, scale, stream)
    _build.check(lib, err, f"flash_attention_bwd ({route})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[route] += 1
    if route == "fp32":
        flash_attention_bwd.fp32_kernel_launches[_tma.flash_f32_kernel(d)] += 1
    else:
        flash_attention_bwd.bf16_head_dim_launches[d] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = {"wgmma": 0, "fp32": 0}
flash_attention_bwd.fp32_kernel_launches = {"tc": 0, "tc32": 0, "fma": 0}
flash_attention_bwd.bf16_head_dim_launches = dict.fromkeys(HEAD_DIMS, 0)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its row log-sum-exp saved, and the backward
    kernel; on CPU tensors the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_lens):
        out, lse = _forward(q, k, v, scale, kv_lens, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.scale, kv_lens)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v; q (B, Sq, H, D), k/v (B, Skv, H, D). Where
    autograd needs a gradient of q, k or v, the call goes through the
    autograd Function (forward kernel with the row log-sum-exp, backward
    kernel); otherwise the forward writes no log-sum-exp."""
    scale = _check_args(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, kv_lens)
    return _forward(q, k, v, scale, kv_lens, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "fp32": 0}
flash_attention.fp32_kernel_launches = {"tc": 0, "tc32": 0, "fma": 0}
flash_attention.bf16_head_dim_launches = dict.fromkeys(HEAD_DIMS, 0)
flash_attention.shape_launches = {}

