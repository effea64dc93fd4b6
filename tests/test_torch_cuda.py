"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip without one. They import nothing
of JAX, so they run on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from panacea_tpu_torch.ops import tolerance
from panacea_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                   flash_attention_bwd_plain,
                                                   flash_attention_plain,
                                                   flash_attention_with_lse)
from panacea_tpu_torch.ops.geglu import geglu, geglu_bwd, geglu_bwd_plain, geglu_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,h,d,lens,merged", [
    (2048, 4096, 5, 64, None, True), (512, 1024, 10, 64, None, True),
    (128, 256, 20, 64, None, True), (512, 1024, 10, 64, None, False),
    (300, 650, 2, 32, None, False), (256, 512, 2, 128, [512, 200], False),
    (256, 512, 2, 16, None, False), (100, 70, 3, 64, [1, 65], True),
    # one row past a tile in Sq and Skv; a single key and one key past a tile
    # edge; a batch whose rows all differ in length
    (129, 4097, 5, 64, None, False), (256, 512, 5, 64, [1, 129, 128, 512], True),
    (200, 700, 2, 64, [1 + 61 * i for i in range(12)], False),
    # rows with no valid key (the mean of V) on each route
    (256, 512, 2, 64, [0, 300], True), (256, 512, 2, 16, [300, 0], False),
    (256, 512, 2, 32, [0, 300], False), (256, 512, 2, 128, [0, 300], False),
    # head dims 16, 32, 128: Sq and Skv off the tiles with ragged rows, a row
    # of one key and an empty one; fewer rows and keys than one tile
    (129, 4097, 2, 16, [4097, 1, 0], True), (129, 4097, 2, 32, [4097, 1, 0], True),
    (129, 4097, 2, 128, [4097, 1, 0], True), (31, 33, 4, 16, [1, 33], False),
    (31, 33, 4, 32, [1, 33], False), (31, 33, 4, 128, [1, 33], False)])
def test_flash_kernel_matches_plain_on_card(cuda, sq, skv, h, d, lens, merged):
    """``merged``: k and v are the halves of one (B, Skv, 2 H D) projection,
    the strided layout of the cross-view call. Every head dim runs the
    wgmma kernel."""
    b = 2 if lens is None else len(lens)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    if merged:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=cuda).bfloat16()
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k, v = (torch.randn((b, skv, h, d), generator=g, device=cuda).bfloat16()
                for _ in range(2))
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (flash_attention.route_launches["wgmma"], flash_attention.bf16_head_dim_launches[d])
    got = flash_attention(q, k, v, kv_lens=kvl)
    assert (flash_attention.route_launches["wgmma"],
            flash_attention.bf16_head_dim_launches[d]) == (before[0] + 1, before[1] + 1)
    want = flash_attention_plain(q, k, v, kv_lens=kvl)
    assert tolerance.worst_ratio(got, want, **tolerance.FLASH) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,c,inner", [
    (3001, 320, 1280), (1000, 640, 2560), (777, 1280, 5120),
    # channels off the 64-wide slice; columns off the 128-wide tile, also odd
    # (stores from registers); fewer tokens than a tile; the tiny config's widths
    (1000, 72, 288), (5000, 328, 1312), (300, 64, 200), (300, 64, 77), (50, 320, 1280),
    (1, 64, 256), (256, 32, 128), (256, 64, 256)])
def test_geglu_kernel_matches_plain_on_card(cuda, tokens, c, inner):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((tokens, c), generator=g, device=cuda).bfloat16()
    w = (torch.randn((2 * inner, c), generator=g, device=cuda) * c**-0.5).bfloat16()
    b = (torch.randn(2 * inner, generator=g, device=cuda) * 0.1).bfloat16()
    got, want = geglu(x, w, b), geglu_plain(x, w, b)
    assert tolerance.worst_ratio(got, want, **tolerance.GEGLU) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,h,d,lens,merged", [
    (2048, 4096, 5, 64, None, True), (512, 1024, 10, 64, None, False),
    (128, 256, 20, 64, None, True), (300, 650, 2, 32, None, False),
    (256, 512, 2, 128, [512, 200], False), (256, 512, 2, 16, None, False),
    (100, 70, 3, 64, [1, 65], True), (129, 4097, 5, 64, None, False),
    (200, 700, 2, 64, [1 + 61 * i for i in range(12)], False),
    # rows with no valid key (the mean of V) on each route
    (256, 512, 2, 64, [0, 300], True), (256, 512, 2, 16, [300, 0], False),
    (256, 512, 2, 32, [0, 300], False), (256, 512, 2, 128, [0, 300], False),
    # head dim 32: the perception shape (its keys split over a cluster),
    # tails off every tile multiple with rows of 1 and 2 keys
    (900, 1668, 8, 32, [1668], False), (129, 1667, 2, 32, [1, 2, 1667], True),
    (130, 97, 8, 32, [0, 1, 2, 33, 97] * 4, False)])
def test_fp32_flash_kernel_matches_plain_on_card(cuda, sq, skv, h, d, lens, merged):
    """fp32 operands go to the fp32 kernels (3xTF32 on the tensor cores at head
    dims 64 and 32, the FMA units at 16 and 128), held to the plain version
    evaluated in float64 (the exact function), as chip_smoke.py holds them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 2 if lens is None else len(lens)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda)
    if merged:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=cuda)
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k, v = (torch.randn((b, skv, h, d), generator=g, device=cuda) for _ in range(2))
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash_attention.route_launches["fp32"]
    kernel = {64: "tc", 32: "tc32"}.get(d, "fma")
    before_kernel = flash_attention.fp32_kernel_launches[kernel]
    got = flash_attention(q, k, v, kv_lens=kvl)
    assert flash_attention.route_launches["fp32"] == before + 1 and got.dtype == torch.float32
    assert flash_attention.fp32_kernel_launches[kernel] == before_kernel + 1
    want = flash_attention_plain(q.double(), k.double(), v.double(), kv_lens=kvl)
    assert tolerance.worst_ratio(got, want, **tolerance.FLASH_F32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,c,inner", [
    (3001, 320, 1280), (1000, 640, 2560), (777, 1280, 5120), (1000, 72, 288),
    (300, 64, 200), (300, 64, 77), (1, 64, 256), (256, 32, 128), (100, 36, 100)])
def test_fp32_geglu_kernel_matches_plain_on_card(cuda, tokens, c, inner):
    """fp32 operands go to the 3xTF32 kernel, held to the plain version
    evaluated in float64 (the exact function), not to the fp32 plain
    version, whose own rounding differs from the kernel's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((tokens, c), generator=g, device=cuda)
    w = torch.randn((2 * inner, c), generator=g, device=cuda) * c**-0.5
    b = torch.randn(2 * inner, generator=g, device=cuda) * 0.1
    before = geglu.route_launches["fp32"]
    got = geglu(x, w, b)
    assert geglu.route_launches["fp32"] == before + 1 and got.dtype == torch.float32
    want = geglu_plain(x.double(), w.double(), b.double())
    assert want.dtype == torch.float64
    assert tolerance.worst_ratio(got, want, **tolerance.GEGLU_F32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["flash", "geglu"])
def test_wrappers_refuse_mixed_types_on_card(cuda, what):
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    hands another type to a plain version."""
    if what == "flash":
        q = torch.zeros((1, 128, 1, 64), device=cuda)
        with pytest.raises(TypeError, match="one type"):
            flash_attention(q, q.bfloat16(), q.bfloat16())
        with pytest.raises(TypeError, match="bf16 or fp32"):
            flash_attention(q.half(), q.half(), q.half())
    else:
        x, w, b = (torch.zeros(s, device=cuda) for s in ((8, 64), (128, 64), (128,)))
        with pytest.raises(TypeError, match="one type"):
            geglu(x, w.bfloat16(), b)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            geglu(x.double(), w.double(), b.double())


BWD_CASES = [
    (512, 1024, 10, 64, None, True), (128, 256, 20, 64, None, True),
    (256, 512, 5, 64, [1, 129, 300, 512], True), (129, 4097, 2, 64, [4097, 65], False),
    (200, 400, 2, 16, None, False), (200, 400, 2, 32, None, True),
    (200, 400, 2, 128, None, False),
    # Sq and Skv below one tile; key blocks with one working warpgroup and
    # blocks wholly past kv_len; Sq off the 64-row tile
    (100, 70, 3, 64, [1, 65], True), (200, 256, 3, 64, [1, 129, 128, 192], True),
    (300, 650, 2, 64, None, False),
    # rows with no valid key: the mean of V, dq = dk = 0
    (200, 256, 2, 64, [0, 100], True), (200, 400, 2, 16, [0, 300], False),
    (200, 400, 2, 32, [300, 0], True), (200, 400, 2, 128, [0, 300], False),
    # the perception training's self-attention at head dim 32 (B 2 and B 1);
    # ragged rows with an empty one, a row of one key and key blocks wholly
    # past kv_len; Sq and Skv off the 64-row blocks and the 32-row tiles
    (900, 1668, 8, 32, None, False), (900, 1668, 8, 32, [1668], False),
    (900, 1668, 8, 32, [0, 1, 833, 1668], True), (129, 1667, 2, 32, [1667, 0, 65], False)]
# the bf16 kernels at head dims 16, 32, 128: Sq and Skv off the tiles with
# ragged rows, a row of one key and an empty one, key blocks past kv_len;
# fewer rows and keys than one tile (the fp32 FMA backward at 16 reads 2.1
# of FLASH_BWD_F32 at the first: ROADMAP Queue C)
BF16_BWD_CASES = [
    (129, 4097, 2, 16, [4097, 1, 0], True), (129, 4097, 2, 32, [4097, 1, 0], True),
    (129, 4097, 2, 128, [4097, 1, 0], True), (31, 33, 4, 16, [1, 33], False),
    (31, 33, 4, 32, [1, 33], False), (31, 33, 4, 128, [1, 33], False)]


def _check_flash_bwd(cuda, sq, skv, h, d, lens, merged, dtype):
    """The backward kernel against its plain version on the same q, k, v,
    kernel output, kernel log-sum-exp and output gradient, on the route of
    its type and head dim; masked keys get no gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 2 if lens is None else len(lens)
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    if merged:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=cuda).to(dtype)
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k, v = (torch.randn((b, skv, h, d), generator=g, device=cuda).to(dtype)
                for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    o, lse = flash_attention_with_lse(q, k, v, kv_lens=kvl)
    _, lse_plain = flash_attention_plain(q, k, v, kv_lens=kvl, return_lse=True)
    assert tolerance.worst_ratio(lse, lse_plain, **tolerance.FLASH_LSE) <= 1.0
    route = "fp32" if dtype == torch.float32 else "wgmma"   # bf16: every head dim
    before = (flash_attention_bwd.launches, flash_attention_bwd.route_launches[route])
    kernels = dict(flash_attention_bwd.fp32_kernel_launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, kv_lens=kvl)
    assert (flash_attention_bwd.launches, flash_attention_bwd.route_launches[route]) == (
        before[0] + 1, before[1] + 1)
    # fp32: the tensor cores (3xTF32) at head dims 64 and 32, the FMA units
    # at 16 and 128
    kernel = {64: "tc", 32: "tc32"}.get(d, "fma")
    assert flash_attention_bwd.fp32_kernel_launches == (
        {**kernels, kernel: kernels[kernel] + 1} if dtype == torch.float32 else kernels)
    # fp32: against the plain version evaluated in float64 (the exact function)
    ref = [t.double() if dtype == torch.float32 else t for t in (q, k, v, o, lse, do)]
    want = flash_attention_bwd_plain(*ref, kv_lens=kvl)
    rule = tolerance.FLASH_BWD_F32 if dtype == torch.float32 else tolerance.FLASH_BWD
    for a, w in zip(got, want):
        assert a.dtype == dtype and tolerance.worst_ratio(a, w, **rule) <= 1.0
    if lens is not None:
        # keys past a row's kv_len get no gradient; a row with no valid key
        # attends to every key alike and gets dq = dk = 0
        dead = (torch.arange(skv, device=cuda)[None] >= kvl[:, None]) & (kvl[:, None] > 0)
        assert not got[1][dead].any() and not got[2][dead].any()
        assert not got[0][kvl == 0].any() and not got[1][kvl == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,h,d,lens,merged", BWD_CASES + BF16_BWD_CASES)
def test_flash_bwd_kernel_matches_plain_on_card(cuda, sq, skv, h, d, lens, merged):
    """bf16: the wgmma kernels at every head dim."""
    _check_flash_bwd(cuda, sq, skv, h, d, lens, merged, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,h,d,lens,merged", BWD_CASES)
def test_fp32_flash_bwd_kernel_matches_plain_on_card(cuda, sq, skv, h, d, lens, merged):
    """fp32: the 3xTF32 tensor-core kernels at head dims 64 (tc) and 32
    (tc32), the FMA ones at 16 and 128, held to the plain version in
    float64."""
    _check_flash_bwd(cuda, sq, skv, h, d, lens, merged, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,inner,dtype", [
    (3001, 1280, torch.bfloat16), (777, 5120, torch.bfloat16), (300, 77, torch.bfloat16),
    (1, 256, torch.bfloat16), (3000, 1280, torch.float32), (300, 77, torch.float32)])
def test_geglu_bwd_kernel_matches_plain_on_card(cuda, tokens, inner, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    hg = torch.randn((tokens, 2 * inner), generator=g, device=cuda).to(dtype)
    dy = torch.randn((tokens, inner), generator=g, device=cuda).to(dtype)
    before = geglu_bwd.launches
    got = geglu_bwd(hg, dy)
    assert geglu_bwd.launches == before + 1 and got.dtype == dtype
    rule = tolerance.GEGLU_BWD if dtype == torch.bfloat16 else tolerance.GEGLU_F32
    assert tolerance.worst_ratio(got, geglu_bwd_plain(hg, dy), **rule) <= 1.0


@pytest.mark.cuda
def test_gradients_flow_through_both_kernels_on_card(cuda):
    """A cross-view-like block on the card: the output has a grad_fn, the
    backward launches both backward kernels, and the gradients of x and of
    the projections match autograd through the plain versions (fp32 on the
    CPU, the same bf16 numbers) within bf16 accuracy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    b, s, h, d, c = 2, 256, 2, 64, 128
    x0 = torch.randn((b, s, c), generator=g).bfloat16()
    wq, wkv = (torch.randn(shape, generator=g).mul(c**-0.5).bfloat16()
               for shape in ((h * d, c), (2 * h * d, c)))
    wff = torch.randn((4 * c, h * d), generator=g).mul((h * d)**-0.5).bfloat16()
    bff = torch.zeros(4 * c).bfloat16()

    def block(x, wq, wkv, wff, bff, flash, gg):
        q = (x @ wq.t()).unflatten(-1, (h, d))
        kv = torch.cat([x, x.flip(1)], dim=1) @ wkv.t()        # Skv = 2 Sq
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
        return gg(flash(q, k, v).flatten(2), wff, bff).float().square().mean()

    grads = []
    for dev, dtype, flash, gg in ((cuda, torch.bfloat16, flash_attention, geglu),
                                  ("cpu", torch.float32, flash_attention_plain, geglu_plain)):
        leaves = [t.to(dev, dtype).requires_grad_() for t in (x0, wq, wkv, wff, bff)]
        before = (flash_attention_bwd.launches, geglu_bwd.launches)
        loss = block(*leaves, flash, gg)
        assert loss.grad_fn is not None
        loss.backward()
        if dev is cuda:
            assert (flash_attention_bwd.launches, geglu_bwd.launches) == (before[0] + 1,
                                                                           before[1] + 1)
        grads.append([t.grad.float().cpu() for t in leaves])
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        assert (got - want).norm() <= 5e-2 * want.norm() + 1e-6

