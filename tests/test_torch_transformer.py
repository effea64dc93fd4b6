"""The port's UNet layers and transformer against the JAX modules, on the
same weights (carried by the port's key map) and the same numpy inputs, in
fp32 on the CPU. The geometry (8 x 96 latent, 6 views of 8 x 16 = 128
tokens) sends the cross-view call of views 0-4 (Sq 128, Skv 256) down the
port's flash-kernel route."""

import importlib

import jax
import numpy as np
import pytest
import torch

from panacea_tpu.models import layers as jlayers
from panacea_tpu.models import transformer as jtrans
from panacea_tpu_torch import convert
from panacea_tpu_torch.models import layers, transformer

TOL = 1e-4


def perturbed(params, seed, scale=0.1):
    """Random values for every parameter (zero-inits included), so that
    every branch contributes."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape)
                        .astype(np.float32), params)


def load(module, params, mapping_fn):
    sd = convert.apply_map(convert.flatten(params), mapping_fn("m", ()))
    module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return module


@pytest.fixture
def flash_calls(monkeypatch):
    A = importlib.import_module("panacea_tpu_torch.ops.attention")
    calls = []
    real = A.flash_attention
    monkeypatch.setattr(A, "flash_attention",
                        lambda q, k, *a, **kw: calls.append((q.shape[1], k.shape[1]))
                        or real(q, k, *a, **kw))
    return calls


def inputs(seed, n=4, c=32, ctx_b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 96, c)).astype(np.float32)
    ctx = rng.standard_normal((ctx_b, 7, 24)).astype(np.float32)
    return x, ctx


def test_inter_view_block_matches_jax(flash_calls):
    x, ctx = inputs(0)
    jmod = jtrans.BasicTransformerBlock(2, 16, 24, mode="inter-view")
    params = perturbed(jmod.init(jax.random.PRNGKey(0), x, ctx)["params"], 1)
    want = np.asarray(jmod.apply({"params": params}, x, ctx))
    mod = load(transformer.BasicTransformerBlock(32, 2, 16, 24, "inter-view"), params,
               convert.basic_block_map)
    got = mod(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy()
    assert flash_calls == [(128, 256)]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_spatial_temporal_transformer_matches_jax(flash_calls):
    x, ctx = inputs(2)
    jmod = jtrans.SpatialTemporalTransformer(32, 2, 16, 24, depth=1, num_frames=2)
    params = perturbed(jmod.init(jax.random.PRNGKey(1), x, ctx)["params"], 3)
    want = np.asarray(jmod.apply({"params": params}, x, ctx))
    mod = load(transformer.SpatialTemporalTransformer(32, 2, 16, 24, depth=1, num_frames=2),
               params, convert.st_transformer_map)
    got = mod(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy()
    assert flash_calls == [(128, 256)]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("cin,cout", [(32, 48), (48, 48)])
def test_resblock3d_matches_jax(cin, cout):
    """Covers GroupNorm (fp32 island, fused SiLU), TemporalGroupNorm's
    per-pixel statistics, the k=3 TemporalConv and the skip paths."""
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((4, 6, 12, cin)).astype(np.float32)
    emb = rng.standard_normal((4, 64)).astype(np.float32)
    jmod = jlayers.ResBlock3D(channels=cin, emb_channels=64, out_channels=cout, num_frames=2)
    # smaller offsets: the two 3x3 convs with 0.1 offsets on 432 inputs
    # grow the output to where fp32 summation order alone reaches 1e-4
    params = perturbed(jmod.init(jax.random.PRNGKey(2), x, emb)["params"], 4, scale=0.02)
    want = np.asarray(jmod.apply({"params": params}, x, emb))
    mod = load(layers.ResBlock3D(cin, 64, cout, num_frames=2), params, convert.resblock_map)
    got = mod(torch.from_numpy(x), torch.from_numpy(emb)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_inter_view_block_gradients_match_jax(flash_calls, monkeypatch):
    """The training path through the flash route: the loss sum(out * w) of
    the inter-view block (the cross-view call at Sq 128, Skv 256) and the
    gradients of every parameter and of the input against
    ``jax.value_and_grad`` of the JAX block, fp32 on the CPU. The JAX block
    differentiates ``_lax_flash``; the port's autograd Function runs
    ``flash_attention_bwd``, whose call is recorded. Tolerance: the loss to
    TOL times sum |w| (what the outputs' TOL allows), each gradient to TOL of
    its largest entry (fp32 summation order only)."""
    import jax.numpy as jnp

    from panacea_tpu_torch.ops import flash_attention as fa_mod
    bwd_calls = []
    real_bwd = fa_mod.flash_attention_bwd
    monkeypatch.setattr(fa_mod, "flash_attention_bwd",
                        lambda q, *a, **kw: bwd_calls.append(q.shape[1]) or real_bwd(q, *a, **kw))
    x, ctx = inputs(4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    jmod = jtrans.BasicTransformerBlock(2, 16, 24, mode="inter-view")
    params = perturbed(jmod.init(jax.random.PRNGKey(2), x, ctx)["params"], 6)

    def loss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx, ctx) * w)

    want_loss, (want_gp, want_gx) = jax.value_and_grad(loss, argnums=(0, 1))(params, x)
    mod = load(transformer.BasicTransformerBlock(32, 2, 16, 24, "inter-view"), params,
               convert.basic_block_map)
    tx = torch.from_numpy(x).requires_grad_()
    got_loss = (mod(tx, torch.from_numpy(ctx)) * torch.from_numpy(w)).sum()
    got_loss.backward()
    assert flash_calls == [(128, 256)] and bwd_calls == [128]
    # the outputs agree to TOL (the forward test), so the loss to TOL sum |w|
    assert abs(got_loss.item() - float(want_loss)) <= TOL * np.abs(w).sum()
    # the JAX gradients in the port's layout, through the same key map
    want = convert.apply_map(convert.flatten(want_gp), convert.basic_block_map("m", ()))
    got = {n: p.grad for n, p in mod.named_parameters()}
    assert set(got) == {k[2:] for k in want}
    for name, g in got.items():
        ref = want["m." + name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=TOL * np.abs(ref).max(), rtol=0,
                                   err_msg=name)
    want_gx = np.asarray(want_gx)
    np.testing.assert_allclose(tx.grad.numpy(), want_gx, atol=TOL * np.abs(want_gx).max(), rtol=0)
