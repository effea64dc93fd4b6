"""The port's attention dispatch against the JAX package's reference
``attention_xla`` on the same numpy inputs, in fp32 on the CPU, on the
SDPA route (Sq < 128): without ``kv_lens`` and with per-row key counts that
include an empty row, which the reference answers with the mean of V (its
-1e30 mask gives the uniform softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panacea_tpu.ops.attention import attention_xla
from panacea_tpu_torch.ops.attention import attention, attention_sdpa

ATOL = 1e-5  # fp32 on both sides; only the summation order differs


@pytest.mark.parametrize("fn", [attention_sdpa, attention], ids=["attention_sdpa", "attention"])
@pytest.mark.parametrize("sq,s,h,d", [(32, 64, 2, 16), (8, 8, 3, 32), (100, 77, 2, 64)])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "kv_lens"])
def test_sdpa_route_matches_reference(fn, sq, s, h, d, ragged):
    rng = np.random.default_rng(sq + s + d)
    q = rng.standard_normal((4, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((4, s, h, d)).astype(np.float32) for _ in range(2))
    lens = np.asarray([0, 1, s // 2, s], np.int32) if ragged else None
    want = np.asarray(attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    kv_lens=None if lens is None else jnp.asarray(lens)))
    got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             kv_lens=None if lens is None else torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if ragged:   # the empty row is the mean of V, as in the reference
        np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), got[0].shape),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [4, 8, 32])
def test_flash_shapes_take_the_flash_route_at_every_head_dim(monkeypatch, d):
    """Sq 140 to 300 keys is a flash shape: the call takes ``flash_attention``
    whatever the head dim, as the JAX router takes Pallas, and answers as
    the reference (its plain version on the CPU). On the card a head dim
    that no kernel has (the tiny detectors' 4) raises in the wrapper's
    check instead of running elsewhere."""
    from panacea_tpu_torch.ops import attention as router
    from panacea_tpu_torch.ops.flash_attention import HEAD_DIMS, _check_cuda

    calls, real = [], router.flash_attention
    monkeypatch.setattr(router, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, 140, 2, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 300, 2, d)).astype(np.float32) for _ in range(2))
    want = np.asarray(attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = attention(tq, tk, tv).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert calls == [tq.shape]
    if d in HEAD_DIMS:
        _check_cuda(tq, tk, tv, None, d)
    else:
        with pytest.raises(ValueError, match="head dim"):
            _check_cuda(tq, tk, tv, None, d)
