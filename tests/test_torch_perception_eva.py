"""The port's EVA-02 backbone (``perception/eva.py``) against the JAX
package's, piece by piece, on the CPU; and its position table against the
reference's ``get_abs_pos`` and the JAX converter's.

Every parameter is drawn on the port's side (``torch_parity.draw``) and
carried to the JAX modules through ``convert.eva_map`` walked backwards
(the deconvolutions through the inverse of JAX ``_t_deconv2d``). Inputs
are numpy arrays from a seed. Widths are tiny: 64 channels, 4 heads of dim
16, windows of 4 on a grid that needs padding. Tolerances, fp32 on both
sides in another order of summation: rtol 1e-5 and atol 1e-5 for the
pieces; the whole ViT and the adapter, whose outputs are LayerNorm'd maps
of largest value 4 to 6 after 4 blocks, within 1e-5 of the largest value
(the atol would otherwise be tighter than fp32's rounding there). Torch
and BLAS run on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import close
from torch_parity import draw, to_jax, two_threads  # noqa: F401

from panacea_tpu.perception import eva as jeva
from panacea_tpu.utils.convert import convert_eva_pos_embed
from panacea_tpu_torch import convert
from panacea_tpu_torch.perception import eva

pytestmark = pytest.mark.usefixtures("two_threads")
T = torch.from_numpy
W, HEADS, WS = 64, 4, 4
VIT = dict(width=W, heads=HEADS, layers=4, window_size=WS, window_block_indexes=(0, 1, 3),
           residual_block_indexes=(2,), out_channels=32)


def allclose(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def block_map(residual: bool):
    """``eva_map``'s entries of block 0, under the block's own names."""
    m = convert.eva_map("n", (), 1, (0,) if residual else ())
    pre = "n.blocks.0."
    return {"n." + k[len(pre):]: (p[1:], t) for k, (p, t) in m.items() if k.startswith(pre)}


def adapter_map():
    pre = "n.adapter."
    return {"n." + k[len(pre):]: (p[1:], t) for k, (p, t) in convert.eva_map("n", (), 0).items()
            if k.startswith(pre)}


def test_rope_tables_and_rotation_match_jax():
    """The tables, float64 on both sides, are equal bit for bit on a square
    and an oblong grid; ``apply_rope`` on (B, N, H, D) within the pieces'
    tolerance."""
    for grid in ((4, 4), (3, 5)):
        for a, b in zip(eva.rope_cos_sin(grid, 16, 16), jeva.rope_cos_sin(grid, 16, 16)):
            np.testing.assert_array_equal(a, b)
    cos, sin = eva.rope_cos_sin((3, 5), 16)
    x = np.random.default_rng(0).standard_normal((2, 15, HEADS, 16)).astype(np.float32)
    c32, s32 = cos.astype(np.float32)[:, None], sin.astype(np.float32)[:, None]
    allclose(eva.apply_rope(T(x), T(c32), T(s32)).numpy(),
             jeva.apply_rope(jnp.asarray(x), jnp.asarray(c32), jnp.asarray(s32)))


def test_window_round_trip_on_a_padded_grid_matches_jax():
    """A 7 x 9 grid in windows of 4: the windows, zero-padded, equal JAX's,
    and the round trip gives the input back."""
    x = np.random.default_rng(1).standard_normal((2, 7, 9, 5)).astype(np.float32)
    got, padded = eva.window_partition(T(x), WS)
    want, jpadded = jeva._window_partition(jnp.asarray(x), WS)
    assert padded == tuple(jpadded) == (8, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(eva.window_unpartition(got, WS, padded, (7, 9)).numpy(), x)


@pytest.mark.parametrize("window, residual", [(WS, False), (0, True)],
                         ids=["windowed", "global_with_residual"])
def test_eva_block_matches_jax(window, residual):
    """One block on a 6 x 10 map of batch 2: windows of 4 (padded after
    ``norm1``), or the whole map with the residual bottleneck."""
    x = np.random.default_rng(2).standard_normal((2, 6, 10, W)).astype(np.float32)
    blk = draw(eva.EVABlock(W, HEADS, window, use_residual_block=residual), 3)
    params = to_jax(blk, block_map(residual))
    jblk = jeva.EVABlock(W, HEADS, window_size=window, use_residual_block=residual)
    want = jax.jit(lambda p, v: jblk.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        allclose(blk(T(x)).numpy(), want)


def test_res_bottleneck_block_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 5, 7, W)).astype(np.float32)
    res = draw(eva.ResBottleneckBlock(W), 5)
    params = to_jax(res, {k.replace("n.residual.", "n."): (p[1:], t)
                          for k, (p, t) in block_map(True).items()
                          if k.startswith("n.residual.")})
    want = jeva.ResBottleneckBlock(W).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        allclose(res(T(x)).numpy(), want)


def test_simple_feature_pyramid_matches_jax_at_all_four_scales():
    """The adapter on a (2, 64, 5, 9) map: the deconvolutions (scales 4 and
    2), the identity (1) and the pool (0.5), each level within 1e-5 of its
    largest value."""
    x = np.random.default_rng(6).standard_normal((2, 5, 9, W)).astype(np.float32)
    fpn = draw(eva.SimpleFeaturePyramid(W, 32), 7)
    params = to_jax(fpn, adapter_map())
    want = jeva.SimpleFeaturePyramid(W, 32).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = fpn(T(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [(20, 36), (10, 18), (5, 9), (2, 4)]
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)


@pytest.mark.parametrize("fusion_stage", [0, 2])
def test_eva_vit_matches_jax(fusion_stage):
    """The whole ViT, 4 blocks (0, 1 and 3 windowed, 2 global with the
    residual bottleneck), on two 80 x 144 images (a 5 x 9 grid), with and
    without the CBEVAViT second pass from block 2."""
    cfg = dict(VIT, fusion_stage=fusion_stage)
    vit = draw(eva.EVAViT(img_size=(80, 144), **cfg), 8)
    params = to_jax(vit, convert.eva_map("n", (), 4, (2,)))
    x = np.random.default_rng(9).standard_normal((2, 80, 144, 3)).astype(np.float32)
    jvit = jeva.EVAViT(**cfg)
    want = jax.jit(lambda p, v: jvit.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = vit(T(x).permute(0, 3, 1, 2).contiguous())
    assert len(got) == 4
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)
    with pytest.raises(ValueError, match="img_size"):
        vit(torch.zeros(1, 3, 64, 144))


def bicubic_keys(grid: np.ndarray, out_hw, a: float = -0.75) -> np.ndarray:
    """An independent float64 transcription of ``F.interpolate(bicubic,
    align_corners=False)``: Keys' cubic with a = -0.75, source index
    (dst + 0.5) in / out - 0.5, taps clamped to the border, no antialias."""
    def weights(n_in, n_out):
        m = np.zeros((n_out, n_in))
        for j in range(n_out):
            src = (j + 0.5) * n_in / n_out - 0.5
            i0 = int(np.floor(src))
            t = src - i0
            for k, d in zip(range(i0 - 1, i0 + 3), (1 + t, t, 1 - t, 2 - t)):
                d = abs(d)
                w = (((a + 2) * d - (a + 3)) * d * d + 1 if d <= 1
                     else ((a * d - 5 * a) * d + 8 * a) * d - 4 * a)
                m[j, min(max(k, 0), n_in - 1)] += w
        return m
    wh, ww = weights(grid.shape[0], out_hw[0]), weights(grid.shape[1], out_hw[1])
    return np.einsum("ih,jw,hwc->ijc", wh, ww, grid)


def test_pos_embed_follows_get_abs_pos_where_the_jax_converter_departs(capsys):
    """A random 24 x 24 x 3 pretrain table with its class token: the port
    resizes it as the reference's ``get_abs_pos`` (bicubic a = -0.75, no
    antialias) to 1e-5 of the float64 transcription, enlarging to 32 x 40
    and shrinking to 16 x 16. The JAX converter's ``jax.image.resize``
    (a = -0.5, antialiased when shrinking) departs from it by far more
    (about 0.3 enlarging and 1.6 shrinking on values of size 2.8); on the
    pretrain grid both give the table itself."""
    rng = np.random.default_rng(10)
    table = rng.standard_normal((1, 1 + 24 * 24, 3)).astype(np.float32)
    grid = table[0, 1:].reshape(24, 24, 3)
    departures = {}
    for out_hw in ((32, 40), (16, 16)):
        got = eva.pos_embed_from_reference(T(table), out_hw).numpy()[0]
        want = bicubic_keys(grid.astype(np.float64), out_hw)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        departures[out_hw] = float(np.abs(convert_eva_pos_embed(table, out_hw)[0] - got).max())
    print(f"jax converter departure: {departures}, table max {np.abs(grid).max():.3g}")
    assert departures[(32, 40)] > 0.1 and departures[(16, 16)] > 0.5
    same = eva.pos_embed_from_reference(T(table), (24, 24)).numpy()
    np.testing.assert_array_equal(same, convert_eva_pos_embed(table, (24, 24)))
    np.testing.assert_array_equal(same[0], grid)
    assert "departure" in capsys.readouterr().out
