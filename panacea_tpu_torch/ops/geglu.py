"""Fused GEGLU projection: the CUDA kernel ``csrc/geglu.cu`` and its plain
PyTorch version.

Counterpart of ``panacea_tpu/ops/geglu.py`` (the Pallas kernel
``_geglu_kernel`` and ``geglu_reference``). ``w`` has the torch Linear
layout (2*inner, C) = [W_h; W_gate] (the flax kernel is its transpose), and

    geglu(x, w, b) = (x W_h^T + b_h) * gelu_erf(x W_gate^T + b_gate)

On a CPU tensor ``geglu`` runs ``geglu_plain``. On a CUDA tensor it
launches a kernel or raises: it never falls back. The operands keep their
type, as in the Pallas kernel: bf16 goes to the bf16 wgmma/TMA kernel, fp32
to the fp32 one, which runs its products on the TF32 tensor cores as 3xTF32
(each operand split into two TF32 parts, three products summed in fp32), so
that it stays as close to the exact function as an fp32 FMA sum; a call is
then two launches, the split of W and the product. ``geglu.launches`` counts
all calls and ``geglu.route_launches`` each type's.

Gradients: where autograd needs them, ``geglu`` goes through a
``torch.autograd.Function`` whose backward recomputes hg = x W^T + b with one
library product (``F.linear``; the JAX gradient leaves that product to XLA),
runs the gate-gradient pass ``geglu_bwd`` (the ``pn_geglu_bwd`` kernel on a
CUDA tensor, counted in ``geglu_bwd.launches``, ``geglu_bwd_plain`` on a CPU
tensor) and gets dX = d_hg W, dW = d_hg^T X and db from library products and
a sum.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from panacea_tpu_torch.ops import _build, _tma


def geglu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unfused form (``F.linear``, split, exact-erf GELU), computed from the
    given inputs in fp32, or in float64 for float64 inputs (the exact
    function the fp32 kernel is held to); the result has x's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    hg = F.linear(x.to(dt), w.to(dt), b.to(dt))
    h, gate = hg.chunk(2, dim=-1)
    return (h * F.gelu(gate)).to(x.dtype)


def geglu_bwd_plain(hg: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gate-gradient pass in fp32 from the given inputs: hg = [h | g]
    (tokens, 2 inner), dy (tokens, inner) -> d_hg = [dy gelu(g) |
    dy h gelu'(g)], gelu'(g) = Phi(g) + g phi(g) with the exact erf; the
    result has dy's dtype."""
    h, g = hg.float().chunk(2, dim=-1)
    d = dy.float()
    cdf = 0.5 * (1.0 + torch.erf(g * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * g * g)
    return torch.cat([d * (g * cdf), d * h * (cdf + g * pdf)], dim=-1).to(dy.dtype)


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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pn_geglu_f32.restype = ctypes.c_int
    lib.pn_geglu_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.pn_geglu_backward.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _forward(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x2 (tokens, C) -> (tokens, inner): the plain version on a CPU tensor,
    else a kernel."""
    if x2.device.type == "cpu":
        return geglu_plain(x2, w, b)
    _check_cuda(x2, w, b)
    c, inner = x2.shape[-1], w.shape[0] // 2
    tokens = x2.shape[0]
    lib = _lib()
    out = torch.empty((tokens, inner), dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    index = x2.device.index if x2.device.index is not None else torch.cuda.current_device()
    if x2.dtype == torch.float32:
        route = "fp32"
        _, _, blocks = _tma.geglu_grid(tokens, inner, _sm_count(index), fp32=True)
        w_split = torch.empty((2 * w.shape[0], c), dtype=w.dtype, device=w.device)
        spec = (_tma.map_spec(x2, (_tma.GEGLU_F32_BM, _tma.GEGLU_F32_BK))
                + _tma.map_spec(w_split, (_tma.GEGLU_F32_BN, _tma.GEGLU_F32_BK)))
        tma_store = _tma.geglu_tma_store(inner, fp32=True)
        if tma_store:
            spec += _tma.map_spec(out, _tma.GEGLU_F32_OUT_BOX)
        err = lib.pn_geglu_f32(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                               w_split.data_ptr(), tokens, c, inner,
                               (ctypes.c_longlong * len(spec))(*spec), int(tma_store), blocks,
                               stream)
    else:
        route = "bf16"
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
    return out


def geglu_bwd(hg: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gate-gradient pass: hg (tokens, 2 inner), dy (tokens, inner) ->
    d_hg (tokens, 2 inner). A CPU tensor takes ``geglu_bwd_plain``; a CUDA
    tensor (bf16 or fp32) the ``pn_geglu_bwd`` kernel."""
    if hg.ndim != 2 or dy.shape != (hg.shape[0], hg.shape[1] // 2) or hg.shape[1] % 2:
        raise ValueError(f"geglu_bwd: hg {tuple(hg.shape)} and dy {tuple(dy.shape)} do not match")
    if hg.device.type == "cpu":
        return geglu_bwd_plain(hg, dy)
    if hg.device.type != "cuda":
        raise ValueError(f"geglu_bwd: no kernel for device {hg.device}")
    if hg.dtype not in (torch.bfloat16, torch.float32) or dy.dtype != hg.dtype:
        raise TypeError(f"geglu_bwd: the kernel takes one type, bf16 or fp32, for hg "
                        f"({hg.dtype}) and dy ({dy.dtype})")
    for name, t in (("hg", hg), ("dy", dy)):
        if t.device != hg.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu_bwd: {name} must be contiguous, 16-byte aligned and on "
                             f"{hg.device}")
    out = torch.empty_like(hg)
    lib = _lib()
    err = lib.pn_geglu_backward(hg.data_ptr(), dy.data_ptr(), out.data_ptr(), hg.shape[0],
                                dy.shape[1], int(hg.dtype == torch.float32),
                                torch.cuda.current_stream(hg.device).cuda_stream)
    _build.check(lib, err, "geglu_bwd")
    geglu_bwd.launches += 1
    return out


geglu_bwd.launches = 0


class _Geglu(torch.autograd.Function):
    """The fused forward kernel; the backward recomputes hg and runs the
    gate-gradient kernel (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w, b)
        return _forward(x2, w, b)

    @staticmethod
    def backward(ctx, dy):
        x2, w, b = ctx.saved_tensors
        d_hg = geglu_bwd(F.linear(x2, w, b), dy.contiguous())
        dx = d_hg @ w if ctx.needs_input_grad[0] else None
        dw = d_hg.t() @ x2 if ctx.needs_input_grad[1] else None
        db = d_hg.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., C), w (2*inner, C), b (2*inner,) -> (..., inner)."""
    c = x.shape[-1]
    if w.ndim != 2 or w.shape[1] != c or w.shape[0] % 2 or b.shape != (w.shape[0],):
        raise ValueError(f"geglu: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} do not match")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"geglu: no kernel for device {x.device}")
    x2 = x.reshape(-1, c)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        out = _Geglu.apply(x2, w, b)
    else:
        out = _forward(x2, w, b)
    return out.reshape(*x.shape[:-1], w.shape[0] // 2)


geglu.launches = 0
geglu.route_launches = {"bf16": 0, "fp32": 0}

