"""The port's backward passes against the JAX package's gradients.

The Pallas kernels have no custom VJP: the JAX trainer differentiates their
plain forms, ``_lax_flash`` and ``geglu_reference``. On the CPU the port's
autograd Functions run the plain backward versions
(``flash_attention_bwd_plain``, ``geglu_bwd_plain``); these are held to
``jax.grad`` of the JAX forms and to torch autograd through the port's plain
forwards, on the same numpy inputs, in fp32 (tolerance ``ATOL``: only the
summation order differs). The CUDA kernels are held to the plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panacea_tpu.ops.flash_attention import _lax_flash
from panacea_tpu.ops.geglu import geglu_reference
from panacea_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                   flash_attention_bwd_plain,
                                                   flash_attention_plain,
                                                   flash_attention_with_lse)
from panacea_tpu_torch.ops import tolerance
from panacea_tpu_torch.ops.geglu import geglu, geglu_bwd, geglu_bwd_plain, geglu_plain

ATOL = 2e-5

FLASH_CASES = [
    (256, 512, None, False),        # Skv = 2 Sq, the cross-view shape
    (200, 650, None, True),         # tails; k, v as halves of one merged projection
    (256, 640, [640, 130], True),   # ragged rows, merged k/v
    (128, 1100, [1, 1100], False),  # a row with one key, more than two 512-key chunks
    # a row with no valid key: every score masked alike, so it attends to all
    # keys equally (dq = dk = 0, dv = sum of dO / Skv)
    (128, 512, [0, 300], True),
]


def _inputs(seed, b, sq, skv, h, d, merged):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kv = rng.standard_normal((b, skv, 2 * h * d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    if merged:
        k, v = kv[..., :h * d].reshape(b, skv, h, d), kv[..., h * d:].reshape(b, skv, h, d)
    else:
        k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32) for _ in range(2))
    return q, kv, k, v, do


def _jax_grads(q, k, v, do, lens):
    b, sq, h, d = q.shape

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    def f(q, k, v):
        out = _lax_flash(fold(q), fold(k), fold(v), d**-0.5, h,
                         None if lens is None else jnp.asarray(lens, jnp.int32))
        out = out.reshape(b, h, sq, d).transpose(0, 2, 1, 3)
        return jnp.sum(out * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("sq,skv,lens,merged", FLASH_CASES)
def test_flash_bwd_plain_matches_jax_grad_of_lax_flash(sq, skv, lens, merged):
    b = 2
    q, _, k, v, do = _inputs(sq + skv, b, sq, skv, 2, 16, merged)
    want = _jax_grads(q, k, v, do, lens)
    tq, tk, tv, tdo = (torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v, do))
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = flash_attention_plain(tq, tk, tv, kv_lens=kvl, return_lse=True)
    assert lse.shape == (b, 2, sq) and lse.dtype == torch.float32
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, kv_lens=kvl)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)
    if lens is not None:  # masked keys get no gradient
        for g in got[1:]:
            assert not g[1, lens[1]:].any()


@pytest.mark.parametrize("d", [16, 32, 128])
# the empty row's Skv is a multiple of 128: _lax_flash pads the keys to one,
# and its empty row attends to the padding too (ROADMAP Queue C)
@pytest.mark.parametrize("sq,skv,lens", [(130, 300, [300, 1]), (100, 256, [0, 200])])
def test_bf16_flash_bwd_plain_matches_jax_grad_of_lax_flash(d, sq, skv, lens):
    """The plain backward that the bf16 CUDA kernels are held to on the card
    (``tolerance.FLASH_BWD``), on bf16 inputs at the head dims whose kernels
    this rule now covers besides 64: P and dS rounded to bf16 as the kernels
    round them, against ``jax.grad`` of ``_lax_flash`` in fp32 on the same
    bf16 values, within the kernels' own rule; tails off the tiles, a row of
    one key and an empty row; two threads."""
    b, h = 2, 2
    q, _, k, v, do = _inputs(d + sq + skv, b, sq, skv, h, d, True)
    q, k, v, do = (torch.from_numpy(np.ascontiguousarray(x)).bfloat16() for x in (q, k, v, do))
    want = _jax_grads(*(x.float().numpy() for x in (q, k, v, do)), lens)
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = flash_attention_plain(q, k, v, kv_lens=kvl, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, kv_lens=kvl)   # the CPU route
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        assert tolerance.worst_ratio(g, torch.tensor(w), **tolerance.FLASH_BWD) <= 1.0, name
    if lens is not None:  # masked keys get no gradient
        for g in got[1:]:
            assert not g[1, lens[1]:].any()


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("sq,skv,lens", [(128, 256, None), (200, 650, [650, 130]),
                                         (100, 1100, [3, 1100]), (100, 512, [0, 300])])
def test_fp32_flash_bwd_plain_matches_jax_grad_of_lax_flash(d, sq, skv, lens):
    """The plain backward that the fp32 CUDA kernel is held to on the card,
    on fp32 inputs, against ``jax.grad`` of ``_lax_flash`` in fp32 (the
    gradient the JAX trainer takes of an fp32 engine): each of dq, dk, dv to
    1e-5 of its largest entry, at the production head dim, the perception
    self-attention's (32) and a small one, with ragged rows and Sq off the
    64-row tile. (A row of a single key has
    dk = 0 exactly in JAX and rounding noise from dP - Delta here; the test
    above covers it with an absolute bound.)"""
    b, h = 2, 2
    q, _, k, v, do = _inputs(d * sq + skv, b, sq, skv, h, d, True)
    want = _jax_grads(q, k, v, do, lens)
    assert all(w.dtype == np.float32 for w in want)
    tq, tk, tv, tdo = (torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v, do))
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = flash_attention_plain(tq, tk, tv, kv_lens=kvl, return_lse=True)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, kv_lens=kvl)   # the CPU route
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("sq,skv,lens,merged", FLASH_CASES)
def test_flash_function_matches_autograd_through_the_plain_forward(sq, skv, lens, merged):
    """The autograd Function (saved tensors, lse, kv_lens, the strided
    halves of the merged kv projection) gives autograd's gradients."""
    b, h, d = 2, 2, 16
    q, kv, k, v, do = _inputs(sq * 3 + skv, b, sq, skv, h, d, merged)
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        tq = torch.from_numpy(q).requires_grad_()
        if merged:
            tkv = torch.from_numpy(kv).requires_grad_()
            tk, tv = (x.unflatten(-1, (h, d)) for x in tkv.chunk(2, dim=-1))
            leaves = (tq, tkv)
        else:
            tk, tv = (torch.from_numpy(x).requires_grad_() for x in (k, v))
            leaves = (tq, tk, tv)
        fn(tq, tk, tv, kv_lens=kvl).backward(torch.from_numpy(do))
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_flash_forward_with_lse_is_the_plain_forward_on_cpu():
    q, _, k, v, _ = _inputs(5, 2, 130, 300, 2, 16, False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_with_lse(tq, tk, tv)
    torch.testing.assert_close(out, flash_attention_plain(tq, tk, tv), rtol=0, atol=0)
    # lse is log2 of the softmax denominator of the scaled scores
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * 16**-0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1) / np.log(2.0), rtol=0, atol=1e-5)
    dq, dk, dv = flash_attention_bwd(tq, tk, tv, out, lse, torch.ones_like(tq))
    assert dq.shape == tq.shape and dk.shape == tk.shape and dv.shape == tv.shape


def _geglu_inputs(tokens, c, inner, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens, c)).astype(np.float32)
    w = (rng.standard_normal((c, 2 * inner)) * c**-0.5).astype(np.float32)  # flax layout
    b = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    dy = rng.standard_normal((tokens, inner)).astype(np.float32)
    return x, w, b, dy


@pytest.mark.parametrize("tokens,c,inner", [(300, 64, 256), (77, 32, 120), (5, 16, 7)])
def test_geglu_bwd_plain_matches_jax_grad_of_geglu_reference(tokens, c, inner):
    x, w, b, dy = _geglu_inputs(tokens, c, inner, tokens + c)
    want = jax.grad(lambda x, w, b: jnp.sum(geglu_reference(x, w, b) * dy),
                    argnums=(0, 1, 2))(x, w, b)
    # the gate pass alone, against the VJP of the gate function at hg
    hg = x @ w + b

    def gate(hg):
        hh, g = jnp.split(hg, 2, axis=-1)
        return hh * (0.5 * g * (1.0 + jax.lax.erf(g * 0.7071067811865476)))

    _, vjp = jax.vjp(gate, hg)
    got_hg = geglu_bwd_plain(torch.from_numpy(hg), torch.from_numpy(dy))
    np.testing.assert_allclose(got_hg.numpy(), np.asarray(vjp(dy)[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(geglu_bwd(torch.from_numpy(hg), torch.from_numpy(dy)).numpy(),
                               got_hg.numpy(), atol=0, rtol=0)
    # the Function's x, W, b gradients (torch Linear layout: W transposed)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w.T.copy(), b))
    geglu(tx, tw, tb).backward(torch.from_numpy(dy))
    for name, g, ww in zip("xwb", (tx.grad, tw.grad.T, tb.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=ATOL * 10, rtol=1e-5,
                                   err_msg=name)


def test_geglu_function_matches_autograd_through_the_plain_forward():
    x, w, b, dy = _geglu_inputs(2 * 3 * 40, 32, 128, 1)
    grads = []
    for fn in (geglu, geglu_plain):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x.reshape(2, 3, 40, 32),
                                                               w.T.copy(), b)]
        fn(*leaves).backward(torch.from_numpy(dy.reshape(2, 3, 40, 128)))
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL * 10, rtol=1e-5)


def test_no_function_without_grad():
    """Under no_grad (the sampling path) neither Function records and the
    forward writes no log-sum-exp."""
    q = torch.randn(1, 128, 1, 16, requires_grad=True)
    k = torch.randn(1, 256, 1, 16)
    with torch.no_grad():
        assert flash_attention(q, k, k).grad_fn is None
        assert geglu(q, torch.randn(32, 16), torch.randn(32)).grad_fn is None
    assert flash_attention(q, k, k).grad_fn is not None
