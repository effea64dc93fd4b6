"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain versions; these are held to
the Pallas kernels (in interpret mode) and their plain-JAX references on the
same numpy inputs, in fp32. The CUDA kernels themselves are held to the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import two_threads  # noqa: F401

from panacea_tpu.ops.flash_attention import _lax_flash, flash_attention as jax_flash
from panacea_tpu.ops.geglu import geglu_matmul, geglu_reference
from panacea_tpu_torch.ops import _build, tolerance
from panacea_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from panacea_tpu_torch.ops.geglu import geglu, geglu_plain

pytestmark = pytest.mark.usefixtures("two_threads")

ATOL = 1e-5  # fp32 on both sides; only the summation order differs


def qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))


def lax_flash(q, k, v, kv_lens=None):
    """The JAX streamed reference on the (B, S, H, D) layout."""
    b, sq, h, d = q.shape

    def fold(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    out = _lax_flash(fold(q), fold(k), fold(v), d**-0.5, h,
                     None if kv_lens is None else jnp.asarray(kv_lens))
    return np.asarray(out.reshape(b, h, sq, d).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("sq,skv,lens", [
    (256, 512, None),          # multi-block, Skv = 2 Sq (the cross-view shape)
    (200, 650, None),          # Sq and Skv not tile multiples
    (256, 640, [640, 130]),    # ragged per-row kv_lens
    (256, 512, [0, 300]),      # a row with no valid key: the mean of V
])
def test_flash_plain_matches_pallas_kernel(sq, skv, lens):
    q, k, v = qkv(sq + skv, 2, sq, skv, 2, 16)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=128, block_k=128, interpret=True,
                                kv_lens=None if kvl is None else jnp.asarray(kvl)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          kv_lens=None if kvl is None else torch.from_numpy(kvl))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), lax_flash(q, k, v, kvl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("tokens,c,inner", [
    (300, 64, 256),     # token tail
    (77, 32, 120),      # inner not a multiple of 128
    (1000, 40, 160),
])
def test_geglu_plain_matches_pallas_kernel(tokens, c, inner):
    rng = np.random.default_rng(tokens)
    x = rng.standard_normal((tokens, c)).astype(np.float32)
    w = (rng.standard_normal((c, 2 * inner)) * 0.1).astype(np.float32)  # flax layout
    b = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    got = geglu(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(geglu_reference(x, w, b)),
                               atol=ATOL, rtol=0)
    if inner % 128 == 0:  # the only widths the Pallas kernel tiles
        fused = geglu_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=ATOL, rtol=0)


def test_dispatch_routes_by_shape(monkeypatch):
    """Sq >= 128 with Skv > Sq or kv_lens -> the flash op; everything else
    (temporal, intra-view, text cross, last view, mid block) -> SDPA."""
    A = importlib.import_module("panacea_tpu_torch.ops.attention")
    calls = []
    real_flash, real_sdpa = A.flash_attention, A.attention_sdpa
    monkeypatch.setattr(A, "flash_attention",
                        lambda *a, **k: calls.append("flash") or real_flash(*a, **k))
    monkeypatch.setattr(A, "attention_sdpa",
                        lambda *a, **k: calls.append("sdpa") or real_sdpa(*a, **k))

    def run(s, kv, lens=None):
        q, k, v = (torch.from_numpy(t) for t in qkv(s + kv, 2, s, kv, 2, 16))
        out = A.attention(q, k, v, kv_lens=lens)
        want = real_sdpa(q, k, v, kv_lens=lens)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL, rtol=0)
        return calls[-1]

    assert run(8, 8) == "sdpa"          # temporal
    assert run(256, 256) == "sdpa"      # intra-view, and the last view
    assert run(256, 77) == "sdpa"       # text cross
    assert run(32, 64) == "sdpa"        # mid-block cross-view, Sq < 128
    assert run(256, 512) == "flash"     # cross-view views 0-4
    assert run(256, 256, torch.tensor([256, 100], dtype=torch.int32)) == "flash"


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    q = torch.empty((1, 128, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        geglu(x, torch.empty((64, 16), device="meta"), torch.empty(64, device="meta"))


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _one_bf16_step(t):
    """Each element moved one bf16 step away from zero."""
    return (t.view(torch.int16) + 1).view(torch.bfloat16)


def test_kernel_tolerance_passes_rounding_and_rejects_real_errors():
    """The rule the card's kernel checks use: one bf16 rounding step passes;
    a 2 % scale error, one key dropped from the mask, or the tanh GELU fail."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 100, 3, 64), generator=g).bfloat16()
    k, v = (torch.randn((2, 70, 3, 64), generator=g).bfloat16() for _ in range(2))
    want = flash_attention_plain(q, k, v)
    assert tolerance.worst_ratio(_one_bf16_step(want), want, **tolerance.FLASH) <= 1.0
    wrong_scale = flash_attention_plain(q, k, v, scale=1.02 * 64**-0.5)
    assert tolerance.worst_ratio(wrong_scale, want, **tolerance.FLASH) > 1.0
    dropped = flash_attention_plain(q, k, v, kv_lens=torch.tensor([69, 69], dtype=torch.int32))
    assert tolerance.worst_ratio(dropped, want, **tolerance.FLASH) > 1.0

    x = torch.randn((300, 64), generator=g).bfloat16()
    w = (torch.randn((512, 64), generator=g) / 8).bfloat16()
    b = (torch.randn(512, generator=g) * 0.1).bfloat16()
    want = geglu_plain(x, w, b)
    assert tolerance.worst_ratio(_one_bf16_step(want), want, **tolerance.GEGLU) <= 1.0
    h, gate = torch.nn.functional.linear(x.float(), w.float(), b.float()).chunk(2, dim=-1)
    tanh_gelu = (h * torch.nn.functional.gelu(gate, approximate="tanh")).bfloat16()
    assert tolerance.worst_ratio(tanh_gelu, want, **tolerance.GEGLU) > 1.0


# ---- host-side arithmetic of the Hopper kernels (ops/_tma.py): tensor-map
# specs, tile schedules and routes, held against brute force

from panacea_tpu_torch.ops import _tma  # noqa: E402
from panacea_tpu_torch.ops import flash_attention as fa_mod  # noqa: E402
from panacea_tpu_torch.ops import geglu as gg_mod  # noqa: E402


def _views(kind, b, s, h, d, dtype=torch.bfloat16):
    """(B, S, H, D) views as the model hands them to the flash kernel."""
    if kind == "contiguous":
        return [torch.zeros((b, s, h, d), dtype=dtype)]
    if kind == "merged_kv":      # the halves of one (B, S, 2 H D) projection
        kv = torch.zeros((b, s, 2 * h * d), dtype=dtype)
        return [t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1)]
    if kind == "merged_qkv":     # the thirds of one (B, S, 3 H D) projection
        qkv = torch.zeros((b, s, 3 * h * d), dtype=dtype)
        return [t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1)]
    if kind == "batch_slice":    # views 0-4 of 6, then rows 8.. of the sequence
        return [torch.zeros((b + 1, s + 8, h, d), dtype=dtype)[:b, 8:]]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["contiguous", "merged_kv", "merged_qkv", "batch_slice"])
@pytest.mark.parametrize("b,s,h", [(80, 4096, 5), (3, 1024, 10), (2, 650, 20), (1, 129, 1)])
def test_flash_tensor_map_spec_addresses_every_element(kind, b, s, h):
    d = 64
    if b * s * h * d * 3 > 2**26:
        b = 4   # the arithmetic does not depend on the batch; keep the host copy small
    rng = np.random.default_rng(s)
    for t in _views(kind, b, s, h, d):
        spec = _tma.map_spec(t, (1, _tma.FLASH_BK, 1, d))
        dims, strides, box = spec[:4], spec[4:8], spec[8:]
        assert dims == [d, h, s, b] and box == [d, 1, _tma.FLASH_BK, 1]
        assert strides[0] == 2 and all(x % 16 == 0 for x in strides[1:])
        corners = [(0, 0, 0, 0), (b - 1, s - 1, h - 1, d - 1)]
        picks = [tuple(int(rng.integers(n)) for n in (b, s, h, d)) for _ in range(50)]
        for bi, si, hi, di in corners + picks:
            want = t[bi, si, hi, di].data_ptr()
            got = t.data_ptr() + sum(i * st for i, st in zip((di, hi, si, bi), strides))
            assert got == want


GEGLU_MAP_CASES = [(196608, 320, 1280), (3072, 1280, 5120), (1000, 72, 288), (256, 32, 128)]


@pytest.mark.parametrize(
    "tokens,c,inner,dtype",
    [(*k, torch.bfloat16) for k in GEGLU_MAP_CASES]
    + [(*k, torch.float32) for k in GEGLU_MAP_CASES],
    ids=[f"{t}-{c}-{i}" for t, c, i in GEGLU_MAP_CASES]
    + [f"fp32-{t}-{c}-{i}" for t, c, i in GEGLU_MAP_CASES])
def test_geglu_tensor_map_specs(tokens, c, inner, dtype):
    """bf16: 64-channel boxes of x and W, 64 x 64 out panels. fp32: a
    32-float box row is the same 128 bytes; the W map is that of the
    (4 inner, C) scratch [W_big; W_small], the out panels 64 x 32."""
    x = torch.zeros((min(tokens, 4096), c), dtype=dtype)
    out = torch.zeros((x.shape[0], inner), dtype=dtype)
    if dtype == torch.bfloat16:
        w = torch.zeros((2 * inner, c), dtype=dtype)
        assert _tma.map_spec(x, (_tma.GEGLU_BM, _tma.GEGLU_BK)) == [c, x.shape[0], 2, 2 * c, 64,
                                                                    128]
        assert _tma.map_spec(w, (_tma.GEGLU_BN, _tma.GEGLU_BK)) == [c, 2 * inner, 2, 2 * c, 64,
                                                                    128]
        assert _tma.map_spec(out, _tma.GEGLU_OUT_BOX) == [inner, x.shape[0], 2, 2 * inner, 64, 64]
        return
    w_split = torch.zeros((4 * inner, c), dtype=dtype)
    bm, bn, bk = _tma.GEGLU_F32_BM, _tma.GEGLU_F32_BN, _tma.GEGLU_F32_BK
    assert bk * 4 == _tma.SWIZZLE_BYTES
    assert _tma.map_spec(x, (bm, bk)) == [c, x.shape[0], 4, 4 * c, 32, 128]
    assert _tma.map_spec(w_split, (bn, bk)) == [c, 4 * inner, 4, 4 * c, 32, 64]
    assert _tma.map_spec(out, _tma.GEGLU_F32_OUT_BOX) == [inner, x.shape[0], 4, 4 * inner, 32, 64]


@pytest.mark.parametrize("make,box,match", [
    (lambda: torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16).transpose(2, 3),
     (1, 128, 64, 1), "innermost stride"),
    (lambda: torch.zeros((2, 8, 68), dtype=torch.bfloat16)[..., :64].unflatten(-1, (1, 64)),
     (1, 128, 1, 64), "multiples of"),
    (lambda: torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16), (1, 128, 1, 32), "swizzle"),
    (lambda: torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16), (1, 512, 1, 64), "outside 1"),
    (lambda: torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16), (128, 64), "same rank"),
    (lambda: torch.zeros((2, 8, 3, 72), dtype=torch.bfloat16)[..., 4:68],
     (1, 128, 1, 64), "16-byte aligned"),
    # fp32: a 64-float box row is 256 bytes, not the swizzle's 128; rows of
    # C % 4 != 0 floats are not 16-byte multiples; fp16 has no map here
    (lambda: torch.zeros((256, 64)), (128, 64), "swizzle"),
    (lambda: torch.zeros((256, 34)), (128, 32), "multiples of 4 elements"),
    (lambda: torch.zeros((256, 64), dtype=torch.float16), (128, 64), "neither bf16 nor fp32"),
])
def test_tensor_map_spec_refuses_what_tma_cannot_load(make, box, match):
    with pytest.raises(ValueError, match=match):
        _tma.map_spec(make(), box)


@pytest.mark.parametrize("b,h,sq", [(80, 5, 2048), (80, 10, 512), (80, 20, 128), (4, 5, 129),
                                    (12, 2, 200), (8, 5, 300)])
def test_flash_schedule_covers_every_query_tile_once(b, h, sq):
    q_tiles, blocks = _tma.flash_grid(b, h, sq)
    seen = [_tma.flash_block(i, h, q_tiles) for i in range(blocks)]
    want = {(bi, hi, q0) for bi in range(b) for hi in range(h)
            for q0 in range(0, sq, _tma.FLASH_BQ)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    # the query tiles of one (batch row, head) are neighbours in launch order
    for i in range(0, blocks, q_tiles):
        assert len({s[:2] for s in seen[i:i + q_tiles]}) == 1
    # every query row lies in exactly one tile's rows below Sq
    rows = sorted(r for bi, hi, q0 in seen if (bi, hi) == (0, 0)
                  for r in range(q0, min(q0 + _tma.FLASH_BQ, sq)))
    assert rows == list(range(sq))


@pytest.mark.parametrize("row_len", [1, 127, 128, 129, 256, 650, 4096, 4097])
def test_flash_kv_tiles_cover_the_row_length(row_len):
    n = _tma.flash_kv_tiles(row_len)
    assert n == len(range(0, row_len, _tma.FLASH_BK))            # brute force
    assert (n - 1) * _tma.FLASH_BK < row_len <= n * _tma.FLASH_BK
    # the last tile masks from row_len - (n - 1) * BK on: at least one key stays
    assert 1 <= row_len - (n - 1) * _tma.FLASH_BK <= _tma.FLASH_BK


@pytest.mark.parametrize("tokens,c,inner", [
    (196608, 320, 1280), (49152, 640, 2560), (12288, 1280, 5120), (3072, 1280, 5120),
    (196685, 320, 1280), (1000, 72, 288), (5000, 328, 1312), (300, 64, 200), (300, 64, 77),
    (50, 320, 1280), (1, 64, 256), (256, 32, 128), (256, 64, 256)])
def test_geglu_schedule_covers_every_tile_once_in_reuse_order(tokens, c, inner):
    sms = 132
    m_tiles, n_tiles, blocks = _tma.geglu_grid(tokens, inner, sms)
    assert blocks == min(sms, m_tiles * n_tiles) and blocks >= 1
    per_block = [_tma.geglu_block_tiles(i, blocks, m_tiles, n_tiles) for i in range(blocks)]
    flat = [t for tiles in per_block for t in tiles]
    want = {(m0, n0) for m0 in range(0, tokens, _tma.GEGLU_BM)
            for n0 in range(0, inner, _tma.GEGLU_BN)}
    assert len(flat) == len(set(flat)) and set(flat) == want
    # round r of the grid works on tiles r * blocks .. : consecutive in
    # (token tile, column tile) order, so a token tile's column tiles (which
    # share x) run at the same time or in the next round, never far apart
    order = sorted(want)
    for r in range(max(len(t) for t in per_block)):
        now = [tiles[r] for tiles in per_block if r < len(tiles)]
        assert now == order[r * blocks:r * blocks + len(now)]
    # the channel slices cover C; only the last is partly zero-filled
    k = _tma.geglu_k_slices(c)
    assert (k - 1) * _tma.GEGLU_BK < c <= k * _tma.GEGLU_BK


@pytest.mark.parametrize("tokens,c,inner", [
    (196608, 320, 1280), (49152, 640, 2560), (12288, 1280, 5120), (3072, 1280, 5120),
    (196685, 320, 1280), (12365, 1280, 5120), (1000, 72, 288), (5000, 328, 1312),
    (300, 64, 200), (300, 64, 77), (1, 64, 256), (256, 32, 128), (100, 36, 100)])
def test_geglu_f32_schedule_covers_every_tile_once_in_reuse_order(tokens, c, inner):
    """The 3xTF32 kernel's tile order (``f32::tile_coords``, mirrored by
    ``_tma.geglu_f32_tile``): every tile once; inside a group of
    GEGLU_F32_GROUP_M token tiles column-major, so that the tiles of a
    round of the grid share few W column tiles, and a group's x tiles are
    all it reads of x until the group is done."""
    sms, gm = 132, _tma.GEGLU_F32_GROUP_M
    m_tiles, n_tiles, blocks = _tma.geglu_grid(tokens, inner, sms, fp32=True)
    assert (m_tiles, n_tiles) == (-(-tokens // 128), -(-inner // 64))
    assert blocks == min(sms, m_tiles * n_tiles) and blocks >= 1
    order = [_tma.geglu_f32_tile(i, m_tiles, n_tiles) for i in range(m_tiles * n_tiles)]
    assert sorted(order) == [(m, n) for m in range(m_tiles) for n in range(n_tiles)]
    # brute force: groups of gm token tiles, each swept column by column
    want = [(m, n) for g0 in range(0, m_tiles, gm) for n in range(n_tiles)
            for m in range(g0, min(g0 + gm, m_tiles))]
    assert order == want
    # round r of the persistent grid: tiles r * blocks .. r * blocks + blocks
    for r0 in range(0, len(order), blocks):
        now = order[r0:r0 + blocks]
        # at most two groups' x tiles, and W column tiles in proportion to
        # the token tiles its groups have
        rows = min(min(gm, m_tiles - m // gm * gm) for m, _ in now)
        assert len({m for m, _ in now}) <= 2 * gm
        assert len({n for _, n in now}) <= -(-len(now) // rows) + 2


def _kernel_constants(source, namespace):
    """The integer constants of one namespace of a CUDA source."""
    import re
    src = open(os.path.join(_build.CSRC, source)).read()
    body = src[src.index(f"namespace {namespace} {{"):src.index(f"}}  // namespace {namespace}")]
    return {name: int(value) for decl in re.findall(r"constexpr int ([^;]+);", body)
            for name, value in re.findall(r"(\w+) = (\d+)(?:,|$)", decl)}


def test_geglu_f32_shared_memory_fits_a_block():
    """The ring depth and the shared-memory layout of the 3xTF32 kernel,
    computed from the source's own constants (``f32::Smem``: per slot x,
    x_small, W_big and W_small; two 64 x 32 out panels and the biases per
    consumer warpgroup; two mbarriers per slot; and the 1,024-byte pad that
    aligns the tiles): they fit the 232,448 bytes an H100 block may have,
    and one slot more would not. The host's tiles are the source's."""
    k = _kernel_constants("geglu.cu", "f32")
    assert (k["BM"], k["BN"], k["BKC"], k["GROUP_M"]) == (
        _tma.GEGLU_F32_BM, _tma.GEGLU_F32_BN, _tma.GEGLU_F32_BK, _tma.GEGLU_F32_GROUP_M)
    assert k["BKC"] * 4 == _tma.SWIZZLE_BYTES        # one swizzled row of fp32
    assert _tma.GEGLU_F32_OUT_BOX == (64, k["PANEL_COLS"])

    def smem(stages):
        slot = 2 * k["BM"] * k["BKC"] * 4 + 2 * (2 * k["BN"] * k["BKC"] * 4)
        panels = 2 * 2 * 64 * k["PANEL_COLS"] * 4
        return stages * slot + panels + 2 * 2 * k["BN"] * 4 + 2 * stages * 8 + 1024

    assert smem(k["STAGES"]) == 231472 <= 232448 < smem(k["STAGES"] + 1)


def _tf32(a):
    """a rounded to the nearest TF32 value, ties away from zero (cvt.rna):
    the sign-magnitude bits rounded at bit 13, the low 13 bits cleared."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tc_add(acc, a, b):
    """acc + a b^T over one 8-channel step, added as a model of the tensor
    cores' adder: the accumulator and the 8 exact products aligned to the
    largest of them and cut 3 bits below its fp32 precision, the sum rounded
    toward zero to fp32."""
    terms = torch.cat([acc.double()[..., None],
                       a.double()[:, None, :] * b.double()[None, :, :]], -1)
    lead = terms.abs().amax(-1, keepdim=True).clamp_min(2.0**-126)
    q = torch.exp2(torch.floor(torch.log2(lead)) - 26)
    s = (torch.trunc(terms / q) * q).sum(-1)
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _geglu_tf32_emulated(x, w, b, products, adder):
    """The fp32 kernel's arithmetic: both operands split into TF32 big and
    small parts, and per 8 channels the products added in the kernel's
    order (3: x_small W_big, x_big W_small, x_big W_big; 1: the big product
    alone). ``adder``: "exact", each product exact and added to fp32
    accumulators rounded to nearest; "tc_tile", the tensor cores' adder
    (``_tc_add``) over the whole tile; "tc_slice", the same into a fresh
    accumulator set per 32-channel slice, added to the tile's fp32 sums
    rounded to nearest, as the kernel does. The epilogue in fp32."""
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _tf32(x - xb), _tf32(w - wb)
    pairs = [(xs, wb), (xb, ws), (xb, wb)] if products == 3 else [(xb, wb)]
    total = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.float32)
    acc = torch.zeros_like(total)
    for k in range(0, x.shape[1], 8):
        for a, bb in pairs:
            a, bb = a[:, k:k + 8], bb[:, k:k + 8]
            if adder == "exact":
                acc = (acc.double() + a.double() @ bb.double().T).float()
            else:
                acc = _tc_add(acc, a, bb)
        if adder == "tc_slice" and (k + 8) % _tma.GEGLU_F32_BK == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    h, gate = (total + acc + b).chunk(2, dim=-1)
    return h * torch.nn.functional.gelu(gate)


@pytest.mark.parametrize("c", [320, 1280])
@pytest.mark.parametrize("products,adder,passes", [
    (3, "exact", True), (1, "exact", False), (3, "tc_slice", True), (3, "tc_tile", False)],
    ids=["3xTF32", "1xTF32", "3xTF32-truncating-per-slice", "3xTF32-truncating-per-tile"])
def test_3xtf32_arithmetic_against_float64(c, products, adder, passes):
    """Under GEGLU_F32, against the function evaluated in float64 (the
    reference of the card's fp32 check), at the production channel counts
    and input scales: the three-product split passes; the TF32 product alone
    fails by orders of magnitude, so the rule catches a dropped term. With
    an adder that truncates, as the tensor cores' does, the sums over a
    whole tile fail (on an H100 the kernel read 5.1 at level 0 without
    the per-slice sums) and the kernel's per-slice fp32 sums pass."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn((128, c), generator=g)
    w = torch.randn((256, c), generator=g) * c**-0.5
    b = torch.randn(256, generator=g) * 0.1
    # TF32 values keep 10 mantissa bits; a tie rounds away from zero
    assert torch.equal(_tf32(_tf32(x)), _tf32(x))
    assert (_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    tie = torch.tensor([1 + 2**-11, -(1 + 2**-11)])
    assert torch.equal(_tf32(tie), torch.tensor([1 + 2**-10, -(1 + 2**-10)]))
    want = geglu_plain(x.double(), w.double(), b.double())
    assert want.dtype == torch.float64
    ratio = tolerance.worst_ratio(_geglu_tf32_emulated(x, w, b, products, adder), want,
                                  **tolerance.GEGLU_F32)
    if passes:
        assert ratio <= 1.0
    else:
        assert ratio > (100.0 if products == 1 else 1.5)


def test_flash_bwd_f32_shared_memory_fits_a_block():
    """The layouts of the fp32 tensor-core backward (``tc::KvSmem`` and
    ``tc::QSmem``), from the source's own constants: resident K and V (or Q
    and dO) with their small parts; per warpgroup a ring of STAGES slots of
    two streamed tiles, their small parts and the transposed copies (big and
    small: of Q and dO in the dK/dV pass, of K in the dQ pass); one
    mbarrier per slot and one for the resident tiles; the 1,024-byte pad.
    Both fit the 232,448 bytes an H100 block may have; a third slot would
    not fit the dK/dV pass. The host's tiles are the source's."""
    k = {**_kernel_constants("flash_f32_tc.cuh", "tc"),    # shared with the forward
         **_kernel_constants("flash_attention_bwd.cu", "tc")}
    assert (k["KB"], k["QB"], k["T"]) == (
        _tma.FLASH_BWD_F32_KB, _tma.FLASH_BWD_F32_QB, _tma.FLASH_BWD_F32_T)
    assert k["D"] == 2 * k["PANEL"] and k["PANEL"] * 4 == _tma.SWIZZLE_BYTES
    tile = k["T"] * k["D"] * 4

    def smem(resident_rows, transposed, stages):
        group = stages * 2 * tile + 2 * tile + transposed * 2 * tile
        return (4 * resident_rows * k["D"] * 4 + 2 * group + 8 * (1 + 2 * stages) + 1024)

    kv, q = smem(k["KB"], 2, k["STAGES"]), smem(k["QB"], 1, k["STAGES"])
    assert (kv, q) == (230440, 197672)
    assert kv <= 232448 < smem(k["KB"], 2, k["STAGES"] + 1)
    assert q <= 232448


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 100, 128, 2048, 4096, 4097])
def test_flash_bwd_f32_tiles_cover_every_row_once(n):
    """The two warpgroups of either pass take the 32-row tiles in turn:
    together every row below ``n`` once, neither more than one tile ahead
    of the other, and no tile past ``n``."""
    t = _tma.FLASH_BWD_F32_T
    g0, g1 = _tma.flash_bwd_f32_tiles(n, 0), _tma.flash_bwd_f32_tiles(n, 1)
    rows = sorted(r for r0 in g0 + g1 for r in range(r0, r0 + t) if r < n)
    assert rows == list(range(n)) and len(g0) - len(g1) in (0, 1)
    assert all(r0 < n for r0 in g0 + g1)
    k_tiles, kv_blocks, q_tiles, q_blocks = _tma.flash_bwd_f32_grid(40, 5, n, 2 * n)
    assert (k_tiles, q_tiles) == (-(-2 * n // 64), -(-n // 64))
    assert (kv_blocks, q_blocks) == (200 * k_tiles, 200 * q_tiles)


@pytest.mark.parametrize("b,sq,h", [(40, 2048, 5), (2, 129, 20), (1, 100, 1)])
def test_flash_bwd_f32_tensor_map_specs(b, sq, h):
    """The fp32 backward's four maps: 32-row boxes of one 32-column panel of
    q, dO and the strided k and v halves, each addressing what torch does."""
    d, skv = 64, 2 * sq
    b = min(b, 2)   # the arithmetic does not depend on the batch
    q = torch.zeros((b, sq, h, d))
    do = torch.zeros((b, sq, h, d))
    kv = torch.zeros((b, skv, 2 * h * d))
    k, v = (x.unflatten(-1, (h, d)) for x in kv.chunk(2, dim=-1))
    spec = _tma.flash_bwd_f32_map_specs(q, k, v, do)
    assert len(spec) == 4 * 12
    for i, t in enumerate((q, do, k, v)):
        dims, strides, box = spec[12 * i:12 * i + 4], spec[12 * i + 4:12 * i + 8], \
            spec[12 * i + 8:12 * i + 12]
        assert dims == [d, h, t.shape[1], b] and box == [32, 1, 32, 1]
        assert strides == [4 * s for s in reversed(t.stride())]


def _tf32_split(x):
    """x as its big and small TF32 parts (``pn::tf32_split``)."""
    big = _tf32(x)
    return big, _tf32(x - big)


def _tc_product(a, b, products, width=None):
    """a (M, K) b^T (b: N, K) as the fp32 flash kernels on the tensor cores
    compute it: both operands split into TF32 big and small parts, 8 values
    of K a step, ``products`` of them a step (3: small x big, big x small,
    big x big; 1: the big product alone) added by the tensor cores' adder
    (``_tc_add``), a fresh accumulator set every ``width`` values (all K in
    one by default), the sets added in fp32 rounded to nearest."""
    (ab, al), (bb, bl) = _tf32_split(a), _tf32_split(b)
    pairs = [(al, bb), (ab, bl), (ab, bb)] if products == 3 else [(ab, bb)]
    total = torch.zeros((a.shape[0], b.shape[0]))
    for c0 in range(0, a.shape[1], width or a.shape[1]):
        acc = torch.zeros_like(total)
        for c in range(c0, min(c0 + (width or a.shape[1]), a.shape[1]), 8):
            for x, y in pairs:
                acc = _tc_add(acc, x[:, c:c + 8], y[:, c:c + 8])
        total = total + acc
    return total


def _flash_bwd_tf32_emulated(q, k, v, o, lse, do, lens, products, s_width=16, kv_dp_width=16,
                             q_dp_width=16, kv_groups=2, q_groups=2):
    """The fp32 tensor-core backwards' arithmetic on one (batch row, head)
    pair per call: each product as ``_tc_product``. S goes to fresh
    accumulator sets of ``s_width`` channels, dP to sets of ``kv_dp_width``
    channels in the dK/dV pass and of ``q_dp_width`` in the dQ pass (the
    head-dim-64 kernels: 16 everywhere; head dim 32: S in one set, dP in
    sets of 8 and 16), and each 32-row tile's dV, dK (per query tile) and
    dQ (per key tile) to a fresh set added to fp32 sums rounded to nearest;
    the tiles of a pass are taken in turn by ``kv_groups`` or ``q_groups``
    warpgroups whose sums are added at the end, in order."""
    t = _tma.FLASH_BWD_F32_T
    scale = q.shape[-1] ** -0.5

    def tc_product(a, b, width=None):
        return _tc_product(a, b, products, width)

    def tiled(a, b, rows, groups):  # sum over 32-row tiles of a[:, tile] b[:, tile]^T
        sums = [torch.zeros((a.shape[0], b.shape[0])) for _ in range(groups)]
        for j, r0 in enumerate(range(0, rows, t)):
            sums[j % groups] = sums[j % groups] + tc_product(a[:, r0:r0 + t], b[:, r0:r0 + t])
        return sum(sums[1:], sums[0])

    def probabilities(qh, kh, n, lse_row):
        s = tc_product(qh, kh, s_width)   # (Sq, Skv)
        p = torch.exp2(s * (scale * tolerance_log2e) - lse_row[:, None])
        return torch.where(torch.arange(kh.shape[0]) < n, p, torch.zeros_like(p))

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    sq = q.shape[1]
    for bi in range(q.shape[0]):
        n = int(lens[bi])
        for hi in range(q.shape[2]):
            qh, kh, vh, oh, doh = (x[bi, :, hi] for x in (q, k, v, o, do))
            delta = (doh * oh).sum(-1, keepdim=True)
            p = probabilities(qh, kh, n, lse[bi, hi])
            ds = p * (tc_product(doh, vh, kv_dp_width) - delta)   # the dK/dV pass's
            dv[bi, :, hi] = tiled(p.T, doh.T, sq, kv_groups)
            dk[bi, :, hi] = tiled(ds.T, qh.T, sq, kv_groups) * scale
            ds = p * (tc_product(doh, vh, q_dp_width) - delta)    # the dQ pass's
            dq[bi, :, hi] = tiled(ds[:, :n], kh[:n].T, n, q_groups) * scale
    return dq, dk, dv


tolerance_log2e = 1.4426950408889634


@pytest.mark.parametrize("products,passes,d", [(3, True, 64), (1, False, 64), (3, True, 32),
                                               (1, False, 32)],
                         ids=["3xTF32", "1xTF32", "d32-3xTF32", "d32-1xTF32"])
def test_flash_bwd_3xtf32_arithmetic_against_float64(products, passes, d, tc32_schedule):
    """Under FLASH_BWD_F32, against the plain backward evaluated in float64
    (the reference of the card's fp32 check), with a full row, a row of one
    valid key (where dS is rounding noise: one set over all 64 channels of
    dP read 0.67 here, 1.8 on the card at Sq 512) and a ragged row, at head
    dim 64 (sets of 16 channels, two warpgroups in each pass) and 32 (the
    tc32 kernels' sets and warpgroups, from their compiled schedule): the
    kernels' scheme (three products, fresh accumulator sets added to
    rounded fp32 sums) passes; the TF32 product alone fails, so the rule
    catches a dropped term."""
    from panacea_tpu_torch.ops.flash_attention import flash_attention_bwd_plain
    g = torch.Generator().manual_seed(8)
    b, sq, skv, h = 3, 128, 256, 1
    q, k, v, do = (torch.randn((b, n, h, d), generator=g) for n in (sq, skv, skv, sq))
    lens = torch.tensor([256, 1, 200], dtype=torch.int32)
    o, lse = flash_attention_plain(q, k, v, kv_lens=lens, return_lse=True)
    shape = {} if d == 64 else _tc32_bwd_shape(tc32_schedule)
    got = _flash_bwd_tf32_emulated(q, k, v, o, lse, do, lens, products, **shape)
    want = flash_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, do)), kv_lens=lens)
    ratios = [tolerance.worst_ratio(a, w, **tolerance.FLASH_BWD_F32) for a, w in zip(got, want)]
    if passes:
        assert max(ratios) <= 1.0, ratios
    else:
        assert max(ratios) > 5.0, ratios


def _tc32_bwd_shape(sched):
    """The arithmetic of the head-dim-32 backward (tc32 in
    csrc/flash_attention_bwd.cu) as ``_flash_bwd_tf32_emulated`` takes it:
    S in one accumulator set of all D channels, dP's sets and the dK/dV
    block's warpgroups (KV_THREADS / 128) from the source's constants, the
    dQ block's warpgroups from the compiled schedule."""
    k = _kernel_constants("flash_attention_bwd.cu", "tc32")
    dp = re.search(r"KV_DP_SETS = D / (\d+), Q_DP_SETS = D / (\d+);",
                   open(os.path.join(_build.CSRC, "flash_attention_bwd.cu")).read())
    return {"s_width": k["D"], "kv_dp_width": int(dp.group(1)),
            "q_dp_width": int(dp.group(2)), "kv_groups": k["KV_THREADS"] // 128,
            "q_groups": sched.bwd.Q_GROUPS}


def test_flash_bwd_d32_one_key_row_takes_dp_in_sets_of_8(tc32_schedule):
    """The row of one valid key at the perception training's shape (Sq 900,
    Skv 1668): dP equals Delta there, so dk of that key sums the noise of dP
    over 900 rows. Modelled as the kernel computes it (S in one set, dP in
    sets of 8 channels, 32-row tiles), it holds FLASH_BWD_F32 against
    float64 as the fp32 plain version does (0.80 and 0.81 of the rule in
    the model with the card's inputs drawn here, 0.64 on an H100 against
    the plain version's 0.73), and by a clear margin over dP in sets of 16
    (1.21 in the model, 1.30 on the card), which is why the dK/dV pass uses
    sets of 8. Only that key's dk is modelled; the rule's floor is the whole
    tensor's rms."""
    from panacea_tpu_torch.ops.flash_attention import flash_attention_bwd_plain
    shape = _tc32_bwd_shape(tc32_schedule)
    assert (shape["s_width"], shape["kv_dp_width"]) == (32, 8)
    g = torch.Generator().manual_seed(3)
    b, sq, skv, h, d = 4, 900, 1668, 2, 32
    q, k, v, do = (torch.randn((b, n, h, d), generator=g) for n in (sq, skv, skv, sq))
    lens = torch.tensor([0, 1, 833, 1668], dtype=torch.int32)
    o, lse = flash_attention_plain(q, k, v, kv_lens=lens, return_lse=True)
    want = flash_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, do)),
                                     kv_lens=lens)[1]
    rule = tolerance.FLASH_BWD_F32
    floor = rule["floor"] * want.square().mean().sqrt()
    ratio = {}
    for width in (8, 16):
        worst = 0.0
        for hi in range(h):
            qh, kh, vh, oh, doh = (x[1, :, hi] for x in (q, k, v, o, do))
            s = _tc_product(qh, kh[:1], 3, shape["s_width"])
            p = torch.exp2(s * (d**-0.5 * tolerance_log2e) - lse[1, hi][:, None])
            ds = p * (_tc_product(doh, vh[:1], 3, width) - (doh * oh).sum(-1, keepdim=True))
            sums = [torch.zeros((1, d)) for _ in range(shape["kv_groups"])]
            for j, r0 in enumerate(range(0, sq, tc32_schedule.bwd.ROWS)):
                r1 = r0 + tc32_schedule.bwd.ROWS
                sums[j % len(sums)] += _tc_product(ds[r0:r1].T.contiguous(),
                                                   qh[r0:r1].T.contiguous(), 3)
            dk0 = sum(sums[1:], sums[0]) * d**-0.5
            w0 = want[1, 0, hi]
            worst = max(worst, ((dk0.double() - w0).abs() / (rule["rel"] * w0.abs() + floor))
                        .max().item())
        ratio[width] = worst
    assert ratio[8] <= 1.0 and ratio[16] > 1.2 * ratio[8], ratio


@pytest.mark.parametrize("d,route", [(16, "mma"), (32, "mma"), (64, "wgmma"), (128, "mma")])
def test_flash_route_by_head_dim(d, route):
    assert _tma.flash_route(d) == route
    assert fa_mod._route(torch.bfloat16, d) == route
    assert fa_mod._route(torch.float32, d) == "fp32"     # fp32 operands keep their type
    assert set(fa_mod.flash_attention.route_launches) == {"wgmma", "mma", "fp32"}
    assert set(gg_mod.geglu.route_launches) == {"bf16", "fp32"}


@pytest.mark.parametrize("inner,tma", [(1280, True), (128, True), (200, True), (288, True),
                                       (77, False), (100, False)])
def test_geglu_store_route_by_inner_width(inner, tma):
    assert _tma.geglu_tma_store(inner) is tma


@pytest.mark.parametrize("case", ["fp32", "stride", "unaligned", "head_dim", "kv_lens"])
def test_flash_cuda_checks_refuse_misuse(case):
    """The checks every CUDA call passes before its launch, run on CPU tensors."""
    q = torch.zeros((2, 128, 2, 64), dtype=torch.bfloat16)
    lens = None
    if case == "fp32":
        # fp32 is a type of its own kernel; mixed types and other types raise
        fa_mod._check_cuda(q.float(), q.float(), q.float(), None, 64)
        with pytest.raises(TypeError, match="one type"):
            fa_mod._check_cuda(q.float(), q, q, None, 64)
        with pytest.raises(TypeError, match="one type"):
            fa_mod._check_cuda(q, q, q.float(), None, 64)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            fa_mod._check_cuda(q.half(), q.half(), q.half(), None, 64)
        return
    if case == "stride":
        bad = torch.zeros((2, 128, 2, 68), dtype=torch.bfloat16)[..., :64]
    elif case == "unaligned":
        bad = torch.zeros((2, 128, 2 * 64 + 8), dtype=torch.bfloat16)[..., 4:132].unflatten(-1, (2, 64))
    elif case == "head_dim":
        q = bad = torch.zeros((2, 128, 2, 48), dtype=torch.bfloat16)
    else:
        bad, lens = q, torch.ones(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        fa_mod._check_cuda(q, bad, bad, lens, q.shape[-1])


@pytest.mark.parametrize("case", ["fp32", "strided", "channels"])
def test_geglu_cuda_checks_refuse_misuse(case):
    x = torch.zeros((64, 64), dtype=torch.bfloat16)
    w, b = torch.zeros((256, 64), dtype=torch.bfloat16), torch.zeros(256, dtype=torch.bfloat16)
    if case == "fp32":
        gg_mod._check_cuda(x.float(), w.float(), b.float())
        with pytest.raises(TypeError, match="one type"):
            gg_mod._check_cuda(x.float(), w, b)
        with pytest.raises(TypeError, match="one type"):
            gg_mod._check_cuda(x, w, b.float())
        with pytest.raises(TypeError, match="bf16 or fp32"):
            gg_mod._check_cuda(x.double(), w.double(), b.double())
    elif case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            gg_mod._check_cuda(torch.zeros((64, 128), dtype=torch.bfloat16)[:, ::2], w, b)
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            gg_mod._check_cuda(torch.zeros((64, 36), dtype=torch.bfloat16),
                               torch.zeros((256, 36), dtype=torch.bfloat16), b)
        # 16 bytes are 4 fp32 channels: 36 passes in fp32, 34 does not
        gg_mod._check_cuda(torch.zeros((64, 36)), torch.zeros((256, 36)), b.float())
        with pytest.raises(ValueError, match="multiple of 4"):
            gg_mod._check_cuda(torch.zeros((64, 34)), torch.zeros((256, 34)), b.float())


def test_flash_refuses_a_non_positive_scale():
    q = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="positive"):
        flash_attention(q, q, q, scale=0.0)


@pytest.mark.parametrize("dtype,vec", [(torch.bfloat16, 8), (torch.float32, 4)])
def test_flash_alignment_rule_is_per_type(dtype, vec):
    """Strides are checked in 16-byte pieces: multiples of 8 bf16 or of 4 fp32."""
    d = 64

    def view(pad):   # (2, 128, 2, 64) with a head stride of 64 + pad elements
        return torch.zeros((2, 128, 2, d + pad), dtype=dtype)[..., :d]

    fa_mod._check_cuda(view(vec), view(vec), view(vec), None, d)
    with pytest.raises(ValueError, match=f"multiples of {vec}"):
        fa_mod._check_cuda(view(vec), view(vec // 2), view(vec), None, d)
    if dtype == torch.float32:   # 4 elements are 16 bytes of fp32 and 8 bytes of bf16
        with pytest.raises(ValueError, match="multiples of 8"):
            bad = torch.zeros((2, 128, 2, d + 4), dtype=torch.bfloat16)[..., :d]
            fa_mod._check_cuda(bad, bad, bad, None, d)


REL = 1e-5  # fp32 operands on both sides, relative to the output's largest value


@pytest.mark.parametrize("d,sq,skv,lens", [(64, 128, 256, None), (64, 200, 330, [330, 77]),
                                           (32, 256, 512, None), (128, 128, 256, [256, 129])])
def test_fp32_flash_plain_matches_pallas_kernel_on_fp32_inputs(d, sq, skv, lens):
    """The Pallas kernel keeps fp32 operands in fp32 (interpret mode here);
    the plain version, which the fp32 CUDA kernel is held to on the card,
    agrees with it to 1e-5 of the output's scale at the production head dim
    and the others."""
    q, k, v = qkv(d + sq, 2, sq, skv, 2, d)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=128, block_k=128, interpret=True,
                                kv_lens=None if kvl is None else jnp.asarray(kvl)))
    assert want.dtype == np.float32
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                kv_lens=None if kvl is None else torch.from_numpy(kvl))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("tokens,c,inner", [(256, 320, 1280), (130, 64, 128), (64, 36, 256)])
def test_fp32_geglu_plain_matches_pallas_kernel_on_fp32_inputs(tokens, c, inner):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((tokens, c)).astype(np.float32)
    w = (rng.standard_normal((c, 2 * inner)) * c**-0.5).astype(np.float32)  # flax layout
    b = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    want = np.asarray(geglu_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    assert want.dtype == np.float32
    got = geglu_plain(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


# ---- the flash backward's routes, tile schedules and tensor maps
# (ops/_tma.py), held against brute force as the forward's are above


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "mma"), (torch.float32, 16, "fp32"), (torch.float32, 32, "fp32"),
    (torch.float32, 64, "fp32"), (torch.float32, 128, "fp32")])
def test_flash_bwd_route_by_type_and_head_dim(dtype, d, route):
    """The backward takes the forward's route: bf16 at head dim 64 the wgmma
    kernels, at 16/32/128 the mma.sync ones, fp32 the fp32 kernels; each
    route has its own launch counter, and each fp32 kernel too (tc at head
    dim 64, tc32 at 32, fma at 16 and 128, as the forward's)."""
    assert fa_mod._route(dtype, d) == route
    assert set(fa_mod.flash_attention_bwd.route_launches) == {"wgmma", "mma", "fp32"}
    assert set(fa_mod.flash_attention_bwd.fp32_kernel_launches) == {"tc", "tc32", "fma"}


@pytest.mark.parametrize("b,h,skv", [(40, 5, 4096), (40, 10, 1024), (40, 20, 256), (3, 2, 4097),
                                     (2, 3, 70), (4, 3, 256), (12, 2, 700)])
def test_flash_bwd_schedule_covers_every_key_tile_once(b, h, skv):
    k_tiles, kv_blocks, _, _ = _tma.flash_bwd_grid(b, h, 128, skv)
    seen = [_tma.flash_bwd_block(i, h, k_tiles, _tma.FLASH_BWD_KB) for i in range(kv_blocks)]
    want = {(bi, hi, k0) for bi in range(b) for hi in range(h)
            for k0 in range(0, skv, _tma.FLASH_BWD_KB)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    # the key tiles of one (batch row, head), which stream the same Q and dO,
    # are neighbours in launch order
    for i in range(0, kv_blocks, k_tiles):
        assert len({s[:2] for s in seen[i:i + k_tiles]}) == 1
    keys = sorted(k for bi, hi, k0 in seen if (bi, hi) == (b - 1, h - 1)
                  for k in range(k0, min(k0 + _tma.FLASH_BWD_KB, skv)))
    assert keys == list(range(skv))


@pytest.mark.parametrize("b,h,sq", [(40, 5, 2048), (40, 10, 512), (40, 20, 128), (3, 2, 129),
                                    (2, 3, 100), (4, 3, 200)])
def test_flash_bwd_schedule_covers_every_query_tile_once(b, h, sq):
    _, _, q_tiles, q_blocks = _tma.flash_bwd_grid(b, h, sq, 256)
    seen = [_tma.flash_bwd_block(i, h, q_tiles, _tma.FLASH_BWD_QB) for i in range(q_blocks)]
    want = {(bi, hi, q0) for bi in range(b) for hi in range(h)
            for q0 in range(0, sq, _tma.FLASH_BWD_QB)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    rows = sorted(r for bi, hi, q0 in seen if (bi, hi) == (0, 0)
                  for r in range(q0, min(q0 + _tma.FLASH_BWD_QB, sq)))
    assert rows == list(range(sq))
    # a dK/dV block streams every query row once, in tiles of FLASH_BWD_QT
    n = _tma.flash_bwd_q_tiles(sq)
    streamed = [r for j in range(n) for r in range(j * _tma.FLASH_BWD_QT,
                                                    (j + 1) * _tma.FLASH_BWD_QT) if r < sq]
    assert streamed == list(range(sq)) and (n - 1) * _tma.FLASH_BWD_QT < sq


@pytest.mark.parametrize("skv,row_len", [(4096, 4096), (1024, 1), (1024, 300), (1024, 700),
                                         (256, 129), (256, 128), (256, 192), (4097, 65),
                                         (70, 1), (70, 65)])
def test_flash_bwd_key_blocks_past_kv_len_are_skipped(skv, row_len):
    """Brute force over the keys: a dK/dV block computes where its keys
    hold a valid one, and only writes zeros otherwise; the computing blocks
    cover every valid key. The dQ blocks visit the 128-key tiles below
    row_len."""
    valid = [k < row_len for k in range(skv)]
    k_tiles = _tma.flash_bwd_grid(1, 1, 1, skv)[0]
    covered = set()
    for kt in range(k_tiles):
        key0 = kt * _tma.FLASH_BWD_KB
        keys = range(key0, min(key0 + _tma.FLASH_BWD_KB, skv))
        active = _tma.flash_bwd_key_block_active(key0, row_len)
        assert active == any(valid[k] for k in keys)
        if active:
            covered.update(keys)
    assert {k for k in range(skv) if valid[k]} <= covered
    n = _tma.flash_bwd_kv_tiles(row_len)
    visited = [k for j in range(n) for k in range(j * _tma.FLASH_BWD_KT,
                                                   (j + 1) * _tma.FLASH_BWD_KT)]
    assert set(k for k in range(skv) if valid[k]) <= set(visited)
    assert n * _tma.FLASH_BWD_KT - row_len < _tma.FLASH_BWD_KT   # no tile of masked keys only


@pytest.mark.parametrize("kind", ["contiguous", "merged_kv", "batch_slice"])
@pytest.mark.parametrize("b,sq,h", [(40, 2048, 5), (3, 512, 10), (2, 129, 20), (1, 100, 1)])
def test_flash_bwd_tensor_map_specs_address_every_element(kind, b, sq, h):
    """The six maps of the wgmma backward: q and dO at the streamed 64-row
    boxes and the resident 128-row ones, the (merged) k and v halves at
    128-key boxes; each spec addresses the element torch does."""
    d, skv = 64, 2 * sq
    if b * skv * h * d * 2 > 2**26:
        b = 2   # the arithmetic does not depend on the batch; keep the host copy small
    q = _views("contiguous", b, sq, h, d)[0]
    do = torch.zeros((b, sq, h, d), dtype=torch.bfloat16)
    k, v = (_views(kind, b, skv, h, d) * 2)[:2]
    spec = _tma.flash_bwd_map_specs(q, k, v, do)
    assert len(spec) == 6 * 12
    rows = (_tma.FLASH_BWD_QT, _tma.FLASH_BWD_QT, _tma.FLASH_BWD_QB, _tma.FLASH_BWD_QB,
            _tma.FLASH_BWD_KB, _tma.FLASH_BWD_KT)
    rng = np.random.default_rng(sq + h)
    for i, (t, r) in enumerate(zip((q, do, q, do, k, v), rows)):
        dims, strides, box = spec[12 * i:12 * i + 4], spec[12 * i + 4:12 * i + 8], \
            spec[12 * i + 8:12 * i + 12]
        n = t.shape[1]
        assert dims == [d, h, n, b] and box == [d, 1, r, 1]
        picks = [(0, 0, 0, 0), (b - 1, n - 1, h - 1, d - 1)]
        picks += [tuple(int(rng.integers(m)) for m in (b, n, h, d)) for _ in range(30)]
        for bi, si, hi, di in picks:
            got = t.data_ptr() + sum(x * st for x, st in zip((di, hi, si, bi), strides))
            assert got == t[bi, si, hi, di].data_ptr()


# ---- the fp32 flash forwards on the tensor cores (``tc`` at head dim 64,
# ``tc32`` at 32, in csrc/flash_attention.cu): their arithmetic, shared
# memory, tile schedules, tensor maps and strides, and which head dim takes
# which kernel


_TC32_SCHEDULE_SHIM = r"""
#include "flash_f32_tc32_schedule.h"
#include "flash_f32_tc32_bwd_schedule.h"
using namespace pn::tc32_schedule;
namespace bwd = pn::tc32_bwd_schedule;
extern "C" {
int tc32_constant(int i) { return i == 0 ? BQ : i == 1 ? KT : SPLIT; }
int tc32_key_split(long long blocks, int sms) { return key_split(blocks, sms); }
int tc32_key_begin(int len, int part, int split) { return key_begin(len, part, split); }
void tc32_block_of(int block, int heads, int q_tiles, int split, int* out) {
  const Block blk = block_of(block, heads, q_tiles, split);
  out[0] = blk.b;
  out[1] = blk.h;
  out[2] = blk.qt;
  out[3] = blk.part;
}
int bwd_constant(int i) {
  const int c[] = {bwd::KB, bwd::QB, bwd::ROWS, bwd::Q_GROUPS, bwd::KV_BLOCKS_PER_SM};
  return c[i];
}
void bwd_block_of(int block, int heads, int tiles, int* out) {
  const bwd::Block blk = bwd::block_of(block, heads, tiles);
  out[0] = blk.b;
  out[1] = blk.h;
  out[2] = blk.tile;
}
int bwd_kv_block_tiles(int sq, int key0, int row_len) {
  return bwd::kv_block_tiles(sq, key0, row_len);
}
int bwd_q_block_tiles(int row_len) { return bwd::q_block_tiles(row_len); }
int bwd_group_tiles(int n, int group, int groups) { return bwd::group_tiles(n, group, groups); }
int bwd_tile_row(int i, int group, int groups) { return bwd::tile_row(i, group, groups); }
}
"""


@pytest.fixture(scope="module")
def tc32_schedule(tmp_path_factory):
    """The head-dim-32 kernels' schedules as the kernels have them: the
    headers they include (csrc/flash_f32_tc32_schedule.h, the forward's,
    and csrc/flash_f32_tc32_bwd_schedule.h, the backward's) built for the
    host with g++ and loaded with ctypes. The forward's: BQ, KT and SPLIT;
    key_split(blocks, sms); key_begin(row_len, part, split);
    block_of(block, heads, q_tiles, split) -> (batch row, head, query tile,
    part). The backward's, under ``bwd``: KB, QB, ROWS, Q_GROUPS and
    KV_BLOCKS_PER_SM; block_of(block, heads, tiles) -> (batch row, head, tile);
    kv_block_tiles(sq, key0, row_len); q_block_tiles(row_len);
    group_tiles(n, group, groups); tile_row(i, group, groups)."""
    import ctypes
    import subprocess
    from types import SimpleNamespace

    out = tmp_path_factory.mktemp("tc32_schedule")
    src, lib_path = out / "shim.cpp", out / "shim.so"
    src.write_text(_TC32_SCHEDULE_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", _build.CSRC,
                    str(src), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.tc32_key_split.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.tc32_block_of.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]

    def block_of(block, heads, q_tiles, split):
        got = (ctypes.c_int * 4)()
        lib.tc32_block_of(block, heads, q_tiles, split, got)
        return tuple(got)

    def bwd_block_of(block, heads, tiles):
        got = (ctypes.c_int * 3)()
        lib.bwd_block_of(block, heads, tiles, got)
        return tuple(got)

    kb, qb, rows, q_groups, kv_per_sm = (lib.bwd_constant(i) for i in range(5))
    bwd = SimpleNamespace(KB=kb, QB=qb, ROWS=rows, Q_GROUPS=q_groups,
                          KV_BLOCKS_PER_SM=kv_per_sm, block_of=bwd_block_of, kv_block_tiles=lib.bwd_kv_block_tiles,
                          q_block_tiles=lib.bwd_q_block_tiles,
                          group_tiles=lib.bwd_group_tiles, tile_row=lib.bwd_tile_row)
    return SimpleNamespace(BQ=lib.tc32_constant(0), KT=lib.tc32_constant(1),
                           SPLIT=lib.tc32_constant(2), key_split=lib.tc32_key_split,
                           key_begin=lib.tc32_key_begin, block_of=block_of, bwd=bwd)


def _flash_fwd_tf32_emulated(q, k, v, lens, products, s_sets, tile=_tma.FLASH_F32_T,
                             key_begin=None, split=1):
    """The fp32 tensor-core forwards' arithmetic: per ``tile``-key tile,
    S = Q K^T as ``_tc_product`` with ``s_sets`` fresh accumulator sets over
    the head dim's channels; the online softmax in base 2 in fp32 (keys from
    the row's length on masked; a row with ``lens`` 0 takes every key at
    scale 0); the tile's P V (P and V split as the operands) into a fresh
    set, folded into the running output in fp32 rounded to nearest with the
    softmax's correction. With ``split`` 2 (the head-dim-32 kernel's
    cluster) the row's keys are cut at ``key_begin`` (the kernel's),
    each part keeps its own m, l and O, and the parts are merged with the
    weights exp2(m_part - max m), a part with no key weighing 0. out = O / l
    and lse = m + log2(l)."""
    t = tile
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out, lse = torch.zeros_like(q), torch.zeros((b, h, sq))
    for bi in range(b):
        n = int(lens[bi])
        row_len = skv if n <= 0 else min(n, skv)
        scale_log2 = 0.0 if n <= 0 else d**-0.5 * tolerance_log2e
        cuts = ([0, row_len] if split == 1 else
                [key_begin(row_len, p, split) for p in range(split + 1)])
        for hi in range(h):
            qh = q[bi, :, hi]
            parts = []
            for first, last in zip(cuts[:-1], cuts[1:]):
                m, l = torch.full((sq,), -1e30), torch.zeros(sq)
                o = torch.zeros((sq, d))
                for key0 in range(first, last, t):
                    kt, vt = (torch.zeros((t, d)) for _ in range(2))
                    kt[:skv - key0] = k[bi, key0:key0 + t, hi]   # past Skv: zeros
                    vt[:skv - key0] = v[bi, key0:key0 + t, hi]
                    s = _tc_product(qh, kt, products, d // s_sets)
                    x = torch.where(torch.arange(t) < last - key0, s * scale_log2,
                                    torch.tensor(float("-inf")))
                    m_new = torch.maximum(m, x.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    o = o * corr[:, None] + _tc_product(p, vt.T.contiguous(), products)
                    m = m_new
                parts.append((m, l, o))
            m = torch.stack([pm for pm, _, _ in parts]).amax(0)
            w = [torch.exp2(pm - m) for pm, _, _ in parts]
            l = sum(pl * wi for (_, pl, _), wi in zip(parts, w))
            o = sum(po * wi[:, None] for (_, _, po), wi in zip(parts, w))
            out[bi, :, hi] = o / l[:, None]
            lse[bi, hi] = m + torch.log2(l)
    return out, lse


@pytest.mark.parametrize("products,s_sets,passes,d,split", [
    pytest.param(3, 1, True, 64, 1, id="3xTF32-one-set"),
    pytest.param(3, 4, True, 64, 1, id="3xTF32-sets-of-16"),
    pytest.param(1, 1, False, 64, 1, id="1xTF32"),
    pytest.param(3, 1, True, 32, 1, id="d32-3xTF32-one-set"),
    pytest.param(3, 1, True, 32, 2, id="d32-3xTF32-split-keys"),
    pytest.param(1, 1, False, 32, 2, id="d32-1xTF32-split-keys")])
def test_flash_fwd_3xtf32_arithmetic_against_float64(products, s_sets, passes, d, split,
                                                     tc32_schedule):
    """Under FLASH_F32 and FLASH_LSE, against the plain forward evaluated in
    float64 (the reference of the card's fp32 check), at head dims 64 and
    32 with a full row, a row of one valid key and a ragged row, each at
    the kernel's tile width (32 keys at both): the kernel's scheme (three
    products, one accumulator set over the channels of S, a fresh set per
    key tile's P V folded into rounded fp32 sums) passes, as sets of 16
    channels do (0.030 and 0.014 of the rule here at head dim 64, the fp32
    plain version 0.014), and at head dim 32 with the keys split over the
    cluster's two blocks and merged (the row of one key leaves one part
    empty; the cut is the kernel's ``key_begin``); the TF32 product alone
    reads 16, so the rule catches a dropped term."""
    g = torch.Generator().manual_seed(9)
    b, sq, skv, h = 3, 128, 256, 1
    q, k, v = (torch.randn((b, n, h, d), generator=g) for n in (sq, skv, skv))
    lens = torch.tensor([256, 1, 200], dtype=torch.int32)
    tile = _tma.FLASH_F32_T if d == 64 else tc32_schedule.KT
    got, got_lse = _flash_fwd_tf32_emulated(q, k, v, lens, products, s_sets, tile,
                                            tc32_schedule.key_begin, split)
    want, want_lse = flash_attention_plain(q.double(), k.double(), v.double(), kv_lens=lens,
                                           return_lse=True)
    assert want.dtype == want_lse.dtype == torch.float64
    ratios = (tolerance.worst_ratio(got, want, **tolerance.FLASH_F32),
              tolerance.worst_ratio(got_lse, want_lse, **tolerance.FLASH_LSE))
    if passes:
        assert max(ratios) <= 1.0, ratios
    else:
        assert ratios[0] > 5.0, ratios


def test_flash_f32_fwd_shared_memory_fits_a_block():
    """The layout of the fp32 tensor-core forward (``tc::Smem`` in
    csrc/flash_attention.cu), from the sources' own constants: the 128-row
    Q tile as loaded (each thread splits its A operands into registers); a
    ring of STAGES slots, each a 32-key K tile split in place with its small
    part, the V tile as loaded and its transposed big and small copies; one
    mbarrier per slot and one for Q; the 1,024-byte pad. It fits the 232,448
    bytes an H100 block may have and one slot more would not. The host's
    tiles are the source's."""
    k = {**_kernel_constants("flash_f32_tc.cuh", "tc"),
         **_kernel_constants("flash_attention.cu", "tc")}
    assert (k["BQ"], k["T"]) == (_tma.FLASH_F32_BQ, _tma.FLASH_F32_T)
    assert k["D"] == 2 * k["PANEL"] and k["PANEL"] * 4 == _tma.SWIZZLE_BYTES
    assert k["NTHREADS"] == 2 * 128 and k["BQ"] == 2 * 64   # two warpgroups of 64 rows
    tile = k["T"] * k["D"] * 4

    def smem(stages):
        return k["BQ"] * k["D"] * 4 + stages * 5 * tile + 8 * (1 + stages) + 1024

    assert smem(k["STAGES"]) == 197672 <= 232448 < smem(k["STAGES"] + 1)


@pytest.mark.parametrize("b,h,sq", [(80, 5, 2048), (80, 10, 512), (80, 20, 128), (40, 5, 2048),
                                    (4, 5, 129), (12, 2, 200), (16, 3, 100)])
def test_flash_f32_schedule_covers_every_query_tile_once(b, h, sq):
    """The fp32 forward's grid: one block per 128 query rows of each
    (batch row, head), the tiles of one pair neighbours in launch order;
    each warpgroup's 64 rows below Sq, together every row once."""
    rows = _tma.FLASH_F32_BQ
    q_tiles, blocks = _tma.flash_grid(b, h, sq, rows)
    assert blocks == b * h * -(-sq // 128)
    seen = [_tma.flash_block(i, h, q_tiles, rows) for i in range(blocks)]
    want = {(bi, hi, q0) for bi in range(b) for hi in range(h) for q0 in range(0, sq, rows)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    for i in range(0, blocks, q_tiles):
        assert len({s[:2] for s in seen[i:i + q_tiles]}) == 1
    mine = sorted(r for bi, hi, q0 in seen if (bi, hi) == (b - 1, h - 1)
                  for group in (0, 1) for r in range(q0 + 64 * group, q0 + 64 * group + 64)
                  if r < sq)
    assert mine == list(range(sq))


@pytest.mark.parametrize("skv,row_len", [(4096, 4096), (1024, 1024), (256, 256), (256, 1),
                                         (4097, 4097), (70, 65), (700, 300), (650, 33)])
def test_flash_f32_kv_tiles_cover_the_row_length(skv, row_len):
    """Both warpgroups walk the same 32-key tiles: every valid key once, no
    tile of masked keys only, and none starting past Skv; the last tile
    masks from row_len - (n - 1) 32 on, at least one key staying."""
    t = _tma.FLASH_F32_T
    n = _tma.flash_kv_tiles(row_len, t)
    keys = [key for j in range(n) for key in range(j * t, (j + 1) * t) if key < row_len]
    assert keys == list(range(row_len)) and (n - 1) * t < skv
    assert 1 <= row_len - (n - 1) * t <= t


@pytest.mark.parametrize("kind", ["contiguous", "merged_kv", "batch_slice"])
@pytest.mark.parametrize("b,sq,h", [(80, 2048, 5), (3, 512, 10), (2, 129, 20), (1, 100, 1)])
def test_flash_f32_tensor_map_specs_address_every_element(kind, b, sq, h):
    """The fp32 forward's three maps: 32-row boxes of one 32-column panel of
    q and of the k and v views (contiguous, the halves of the merged kv
    projection, or a slice of a larger batch); each spec addresses the
    element torch does."""
    d, skv = 64, 2 * sq
    if b * skv * h * d * 2 > 2**25:
        b = 2   # the arithmetic does not depend on the batch; keep the host copy small
    q = _views(kind, b, sq, h, d, torch.float32)[0]
    k, v = (_views(kind, b, skv, h, d, torch.float32) * 2)[:2]
    spec = _tma.flash_f32_map_specs(q, k, v)
    assert len(spec) == 3 * 12
    rng = np.random.default_rng(sq + h)
    for i, t in enumerate((q, k, v)):
        dims, strides, box = spec[12 * i:12 * i + 4], spec[12 * i + 4:12 * i + 8], \
            spec[12 * i + 8:12 * i + 12]
        n = t.shape[1]
        assert dims == [d, h, n, b] and box == [32, 1, _tma.FLASH_F32_T, 1]
        assert strides[0] == 4 and all(x % 16 == 0 for x in strides[1:])
        picks = [(0, 0, 0, 0), (b - 1, n - 1, h - 1, d - 1)]
        picks += [tuple(int(rng.integers(m)) for m in (b, n, h, d)) for _ in range(30)]
        for bi, si, hi, di in picks:
            got = t.data_ptr() + sum(x * st for x, st in zip((di, hi, si, bi), strides))
            assert got == t[bi, si, hi, di].data_ptr()


def test_flash_f32_d32_shared_memory_fits_a_block(tc32_schedule):
    """The layout of the fp32 tensor-core forward at head dim 32
    (``tc32::Smem`` in csrc/flash_attention.cu), from the sources' own
    constants: the 128-row Q tile as loaded (one 128-byte panel a row); a
    ring of STAGES slots, each a KT-key K tile split in place with its small
    part, the V tile as loaded and its transposed big and small copies; one
    mbarrier per slot and one for Q; the 1,024-byte pad. It fits the 232,448
    bytes an H100 block may have, and the slots hold the hand-over of a
    cluster's second block (D / 2 + 4 values a thread). The tiles of the
    compiled schedule are the source's."""
    k = {**_kernel_constants("flash_f32_tc.cuh", "tc"),
         **_kernel_constants("flash_f32_tc32_schedule.h", "tc32_schedule"),
         **_kernel_constants("flash_attention.cu", "tc32")}
    assert (k["BQ"], k["KT"], k["SPLIT"]) == (
        tc32_schedule.BQ, tc32_schedule.KT, tc32_schedule.SPLIT)
    assert k["D"] == k["PANEL"] == _tma.SWIZZLE_BYTES // 4   # one swizzled panel a row
    assert k["NTHREADS"] == 2 * 128 and k["BQ"] == 2 * 64   # two warpgroups of 64 rows
    assert k["KT"] % 32 == 0 and k["STAGES"] >= 5   # the pipeline holds tiles j-1 .. j+3
    tile = k["KT"] * k["D"] * 4
    slots = k["STAGES"] * 5 * tile
    smem = k["BQ"] * k["D"] * 4 + slots + 8 * (1 + k["STAGES"]) + 1024
    assert smem == 119856 <= 232448
    assert (k["D"] // 2 + 4) * k["NTHREADS"] * 4 <= slots


@pytest.mark.parametrize("b,h,sq", [(1, 8, 900), (2, 8, 900), (1, 1, 1), (3, 2, 129),
                                    (1, 8, 128), (4, 5, 200), (1, 8, 644)])
def test_flash_f32_d32_schedule_writes_every_row_once(b, h, sq, tc32_schedule):
    """The head-dim-32 kernel's grid on 132 SMs, from its compiled schedule:
    the blocks of a query tile form a cluster of ``key_split`` blocks (2
    where twice the 128-row blocks fit one wave: (1, 900, 8) gives 64
    clusters of 2, (2, 900, 8) 128 single blocks); only part 0 of a cluster
    writes, and every row of every (batch row, head) is written once."""
    bq = tc32_schedule.BQ
    q_tiles, tiles = _tma.flash_grid(b, h, sq, bq)
    split = tc32_schedule.key_split(tiles, 132)
    assert split == (2 if 2 * tiles <= 132 else 1)
    if (b, h, sq) == (1, 8, 900):
        assert (tiles, split) == (64, 2)
    if (b, h, sq) == (2, 8, 900):
        assert (tiles, split) == (128, 1)
    blocks = [tc32_schedule.block_of(i, h, q_tiles, split) for i in range(tiles * split)]
    assert len(set(blocks)) == len(blocks)
    for i in range(0, len(blocks), split):   # one cluster: one query tile, parts 0 ..
        assert {x[:3] for x in blocks[i:i + split]} == {blocks[i][:3]}
        assert [x[3] for x in blocks[i:i + split]] == list(range(split))
    written = sorted((bi, hi, r) for bi, hi, qt, part in blocks if part == 0
                     for r in range(qt * bq, min(qt * bq + bq, sq)))
    assert written == [(bi, hi, r) for bi in range(b) for hi in range(h) for r in range(sq)]


@pytest.mark.parametrize("row_len", [1668, 1, 2, 31, 32, 33, 64, 65, 833, 1667, 4097, 3072,
                                     6001, 12288, 12305])
@pytest.mark.parametrize("split", [1, 2])
def test_flash_f32_d32_key_parts_cover_the_row_once(row_len, split, tc32_schedule):
    """The keys of a row, cut over the ``split`` blocks of a cluster by the
    kernel's compiled ``key_begin``: every valid key once, in order; whole
    tiles of KT keys, the first part no more tiles than the last (it
    merges); no part empty unless the row has fewer keys than parts (a row
    of one key: the second part is empty and weighs 0 in the merge); each
    part's last tile keeps at least one key."""
    kt = tc32_schedule.KT
    cuts = [tc32_schedule.key_begin(row_len, p, split) for p in range(split + 1)]
    assert cuts[0] == 0 and cuts[-1] == row_len and cuts == sorted(cuts)
    sizes = [b - a for a, b in zip(cuts[:-1], cuts[1:])]
    assert all(n >= 1 for n in sizes) or row_len < split
    if -(-row_len // kt) >= split:
        assert all(c % kt == 0 for c in cuts[:-1])
        assert -(-sizes[0] // kt) <= -(-sizes[-1] // kt)
    for first, last in zip(cuts[:-1], cuts[1:]):
        n = -(-(last - first) // kt)
        assert n * kt >= last - first and (n == 0 or last - first - (n - 1) * kt >= 1)
    if row_len == 1668 and split == 2:   # the perception row: 26 and 27 tiles of 32
        assert cuts == [0, 832, 1668]
    if row_len == 12288 and split == 2:  # the dense cross-attention's row: 192 tiles each
        assert cuts == [0, 6144, 12288]


@pytest.mark.parametrize("kind", ["contiguous", "merged_kv", "batch_slice"])
@pytest.mark.parametrize("b,sq,skv,h", [(1, 900, 1668, 8), (2, 900, 1668, 8), (3, 129, 65, 2)])
def test_flash_f32_d32_strides_address_every_element(kind, b, sq, skv, h):
    """The head-dim-32 kernel copies each row of q, k and v in four 16-byte
    chunks with cp.async from the strides the wrapper passes
    (``_tma.flash_strides``): for contiguous views, the halves of a merged
    kv projection and a slice of a larger batch, each (b, s, h) row starts
    16-byte aligned and element c of it lies where torch has it."""
    d = 32
    q = _views(kind, b, sq, h, d, torch.float32)[0]
    k, v = (_views(kind, b, skv, h, d, torch.float32) * 2)[:2]
    st = _tma.flash_strides(q, k, v)
    assert len(st) == 9 and all(x % 4 == 0 for x in st)
    rng = np.random.default_rng(sq + h)
    for i, t in enumerate((q, k, v)):
        assert t.stride(-1) == 1 and t.data_ptr() % 16 == 0
        n = t.shape[1]
        picks = [(0, 0, 0, 0), (b - 1, n - 1, h - 1, d - 1)]
        picks += [tuple(int(rng.integers(m)) for m in (b, n, h, d)) for _ in range(30)]
        for bi, si, hi, di in picks:
            row = t.data_ptr() + 4 * (bi * st[3 * i] + si * st[3 * i + 1] + hi * st[3 * i + 2])
            assert row % 16 == 0 and row + 4 * di == t[bi, si, hi, di].data_ptr()


@pytest.mark.parametrize("b,h,sq,skv,lens", [
    (2, 8, 900, 1668, [1668, 1668]), (1, 8, 900, 1668, [1668]),
    (4, 8, 900, 1668, [0, 1, 833, 1668]), (3, 2, 129, 1667, [1667, 0, 65]),
    (2, 3, 100, 70, [1, 65]), (3, 2, 31, 33, [33, 33, 33]),
    # the dense cross-attention in training: 900 + 10 x the batch's most
    # boxes (64, 23) queries to r50's 12,288 tokens, 644 + ... to VoVNet's 3,072
    (2, 8, 1540, 12288, [12288, 12288]), (2, 8, 1130, 12288, [12288, 12288]),
    (2, 8, 1284, 3072, [3072, 3072]), (2, 8, 874, 3072, [3072, 3072])])
def test_flash_bwd_f32_d32_schedule_visits_every_tile_once(b, h, sq, skv, lens, tc32_schedule):
    """The head-dim-32 backward's grids from their compiled schedule
    (csrc/flash_f32_tc32_bwd_schedule.h), brute force over every key and
    query row: each (batch row, head, key tile of KB) is one dK/dV block,
    which streams every query tile once (ROWS rows each), so every valid key
    meets every query row once; a block whose keys all lie past kv_len
    streams one tile, all masked, and so writes zeros. Each (batch row,
    head, query tile of QB) is one dQ block, whose warpgroups stream the key
    tiles below kv_len once between them; a row of kv_lens 0 takes every
    key. Launch order keeps a (batch row, head)'s blocks together."""
    s = tc32_schedule.bwd
    k_tiles, q_tiles = -(-skv // s.KB), -(-sq // s.QB)
    kv_blocks = [s.block_of(i, h, k_tiles) for i in range(b * h * k_tiles)]
    assert kv_blocks == [(bi, hi, kt) for bi in range(b) for hi in range(h)
                         for kt in range(k_tiles)]
    for bi, hi, kt in kv_blocks:
        row_len = lens[bi] if lens[bi] > 0 else skv
        key0 = kt * s.KB
        n = s.kv_block_tiles(sq, key0, row_len)
        firsts = [i * s.ROWS for i in range(n)]
        streamed = sorted(r for r0 in firsts for r in range(r0, r0 + s.ROWS) if r < sq)
        if key0 < row_len:   # every query row once
            assert streamed == list(range(sq))
        else:                # one tile, every key of the block masked: zeros
            assert n == 1 and all(k >= row_len for k in range(key0, key0 + s.KB))
    q_blocks = [s.block_of(i, h, q_tiles) for i in range(b * h * q_tiles)]
    assert q_blocks == [(bi, hi, qt) for bi in range(b) for hi in range(h)
                        for qt in range(q_tiles)]
    for bi, _, _ in q_blocks:
        row_len = lens[bi] if lens[bi] > 0 else skv
        n = s.q_block_tiles(row_len)
        firsts = [s.tile_row(i, g, s.Q_GROUPS) for g in range(s.Q_GROUPS)
                  for i in range(s.group_tiles(n, g, s.Q_GROUPS))]
        keys = sorted(k for k0 in firsts for k in range(k0, k0 + s.ROWS) if k < row_len)
        assert keys == list(range(row_len)) and (n - 1) * s.ROWS < row_len


def test_flash_bwd_f32_d32_shared_memory_fits(tc32_schedule):
    """The layouts of the head-dim-32 backward (``tc32::KvSmem`` and
    ``tc32::QSmem`` in csrc/flash_attention_bwd.cu), from the sources' own
    constants: the dK/dV block's (one warpgroup of KV_THREADS) K and V as
    loaded (the warpgroup splits its A operands into registers), a ring of
    KV_STAGES slots of a Q and a dO tile, their small parts and their
    transposed copies (big and small), the tiles' lse and Delta and the
    mbarriers; the
    dQ block's Q and dO with their small parts, and per warpgroup a ring of
    Q_STAGES slots of a K and a V tile, their small parts and K's
    transposed copy. Two blocks of each fit an SM's 228 KB (1 KB a block
    kept by the hardware), and every tile starts on a 1,024-byte swizzle
    atom. The compiled schedule's tiles are the source's."""
    k = {**_kernel_constants("flash_f32_tc.cuh", "tc"),
         **_kernel_constants("flash_f32_tc32_bwd_schedule.h", "tc32_bwd_schedule"),
         **_kernel_constants("flash_attention_bwd.cu", "tc32")}
    s = tc32_schedule.bwd
    assert (k["KB"], k["QB"], k["ROWS"], k["Q_GROUPS"], k["KV_THREADS"]) == (
        s.KB, s.QB, s.ROWS, s.Q_GROUPS, 128)
    assert k["D"] == k["PANEL"] == _tma.SWIZZLE_BYTES // 4   # one swizzled panel a row
    tile = s.ROWS * k["D"] * 4
    kv_tiles = (k["KV_STAGES"] * 2 + 2 + 4) * tile
    q_group = (k["Q_STAGES"] * 2 + 2 + 2) * tile
    assert tile % 1024 == 0 and s.KB * k["D"] * 4 % 1024 == 0 and q_group % 1024 == 0
    kv = (2 * s.KB * k["D"] * 4 + kv_tiles + k["KV_STAGES"] * 2 * s.ROWS * 4
          + 8 * (1 + k["KV_STAGES"]) + 1024)
    q = 4 * s.QB * k["D"] * 4 + s.Q_GROUPS * q_group + 8 * (1 + s.Q_GROUPS * k["Q_STAGES"]) + 1024
    assert (kv, q) == (58904, 99368)
    assert 2 * (kv + 1024) <= 233472 and 2 * (q + 1024) <= 233472


@pytest.mark.parametrize("d,kernel,namespace", [(16, "fma", "f32::launch<16>"),
                                                (32, "tc32", "tc32::launch"),
                                                (64, "tc", "tc::launch"),
                                                (128, "fma", "f32::launch<128>")])
def test_flash_f32_kernel_by_head_dim(d, kernel, namespace):
    """Which fp32 kernel each head dim takes, in the forward and in the
    backward: the tensor cores (3xTF32) at 64 and 32, the FMA units at 16
    and 128, as the wrappers count them (``fp32_kernel_launches`` of
    ``flash_attention`` and of ``flash_attention_bwd``) and as both C
    entries' switches dispatch them."""
    assert _tma.flash_f32_kernel(d) == kernel
    assert set(fa_mod.flash_attention.fp32_kernel_launches) == {"tc", "tc32", "fma"}
    assert set(fa_mod.flash_attention_bwd.fp32_kernel_launches) == {"tc", "tc32", "fma"}
    for source, name in (("flash_attention.cu", "pn_flash_attention_f32"),
                         ("flash_attention_bwd.cu", "pn_flash_attention_bwd_f32")):
        src = open(os.path.join(_build.CSRC, source)).read()
        entry = src[src.index(f'extern "C" int {name}'):]
        entry = entry[:entry.index("\n}\n")]
        assert re.search(rf"case {d}: return {re.escape(namespace)}\(", entry)


@pytest.mark.parametrize("lens", [None, [0, 300], [1, 77]], ids=["full", "empty-row", "ragged"])
def test_flash_plain_in_float64_is_the_exact_softmax(lens):
    """float64 inputs are computed in float64 (the reference of the fp32
    kernels' checks on the card): the chunked online softmax equals a direct
    float64 softmax(q k^T scale) v, a row with no valid key the mean of V;
    its lse is log2 of the direct sum of exp2 of the scaled scores."""
    g = torch.Generator().manual_seed(64)
    b, sq, skv, h, d = 2, 100, 650, 3, 64
    q, k, v = (torch.randn((b, n, h, d), generator=g, dtype=torch.float64)
               for n in (sq, skv, skv))
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = flash_attention_plain(q, k, v, kv_lens=kvl, return_lse=True)
    assert out.dtype == lse.dtype == torch.float64
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5 * tolerance_log2e
    n = torch.full((b,), skv) if kvl is None else kvl.long()
    valid = torch.arange(skv)[None, :] < n[:, None]
    s = torch.where(n[:, None, None, None] == 0, torch.zeros_like(s),   # the empty row
                    torch.where(valid[:, None, None, :], s, torch.full_like(s, float("-inf"))))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s * np.log(2), -1), v)
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lse, torch.logsumexp(s * np.log(2), -1) / np.log(2),
                               rtol=1e-12, atol=1e-12)
    if lens is not None and 0 in lens:
        row = lens.index(0)
        torch.testing.assert_close(out[row], v[row].mean(0).expand(sq, h, d), rtol=1e-12,
                                   atol=1e-12)
