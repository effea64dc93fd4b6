"""Host-side arithmetic of the Hopper kernels: tensor-map specs for TMA
loads of strided bf16 and fp32 views, and the tile schedules of the flash
forward and backward and of both GEGLU forwards.

Everything here is plain Python on shapes and strides, so the CPU tests hold
it against brute force; the C entries (``csrc/hopper.cuh``, ``encode_map``)
only hand the numbers to ``cuTensorMapEncodeTiled``. The bf16 flash
kernels' tiles at each head dim are those of ``csrc/flash_bf16_schedule.h``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

SWIZZLE_BYTES = 128     # the widest innermost box row: 64 bf16 or 32 fp32
# a box's rows are swizzled by their width, which must be one of these
# (``encode_map`` picks CU_TENSOR_MAP_SWIZZLE_32B, _64B or _128B)
SWIZZLES = (32, 64, 128)
MAX_BOX = 256           # TMA's limit on a box dimension
MAX_RANK = 4

# the bf16 flash forward: query rows per block, keys per tile (at head dims
# 16 to 64; flash_fwd_bk(d) at each); its boxes are flash_panel_cols(d)
# columns of a head
FLASH_BQ, FLASH_BK = 128, 128
# the fp32 forward on the tensor cores (``tc`` in csrc/flash_attention.cu):
# query rows per block (two warpgroups of 64) and keys per tile, which both
# warpgroups walk; its three maps have the fp32 backward's 32 x 32 boxes
FLASH_F32_BQ, FLASH_F32_T = 128, 32
# the bf16 backward at every head dim: keys per dK/dV block and query rows
# per tile it streams; query rows per dQ block (the keys per tile it
# streams are flash_bwd_kt(d))
FLASH_BWD_KB, FLASH_BWD_QT = 128, 64
FLASH_BWD_QB = 128
# the fp32 backward on the tensor cores (``tc`` in csrc/flash_attention_bwd.cu):
# keys per dK/dV block, query rows per dQ block, rows of the tiles each
# warpgroup streams (the two warpgroups take them in turn), and the box of
# all four maps (32 fp32 = one swizzled row, by 32 rows)
FLASH_BWD_F32_KB, FLASH_BWD_F32_QB, FLASH_BWD_F32_T = 64, 64, 32
GEGLU_BM, GEGLU_BN, GEGLU_BK = 128, 128, 64
GEGLU_OUT_BOX = (64, 64)            # one consumer warpgroup's rows, half the columns
# the fp32 (3xTF32) kernel, ``f32`` in csrc/geglu.cu: tile and slot, token
# tiles per group of its tile order, out panels of 64 x 32
GEGLU_F32_BM, GEGLU_F32_BN, GEGLU_F32_BK = 128, 64, 32
GEGLU_F32_GROUP_M = 16
GEGLU_F32_OUT_BOX = (64, 32)


def map_spec(t: torch.Tensor, box: Sequence[int]) -> List[int]:
    """The spec ``encode_map`` takes for the view ``t`` (bf16 or fp32): its
    dims, its byte strides and the box, each innermost dimension first (the
    reverse of torch's order). ``box`` is given in torch's order. The element
    at index ``idx`` lies at ``t.data_ptr() + sum(idx[i] * byte_stride[i])``;
    a box that reaches past a dim is filled with zeros there by the
    hardware."""
    if t.ndim != len(box) or not 2 <= t.ndim <= MAX_RANK:
        raise ValueError(f"tensor map: view {tuple(t.shape)} and box {tuple(box)} must have "
                         f"the same rank, 2 to {MAX_RANK}")
    if t.stride(-1) != 1:
        raise ValueError(f"tensor map: the innermost stride of {t.stride()} must be 1")
    if t.data_ptr() % 16:
        raise ValueError("tensor map: the view is not 16-byte aligned")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"tensor map: {t.dtype} is neither bf16 nor fp32")
    elem = t.element_size()
    dims = [int(n) for n in reversed(t.shape)]
    strides = [int(s) * elem for s in reversed(t.stride())]
    boxes = [int(n) for n in reversed(box)]
    if boxes[0] * elem not in SWIZZLES:
        raise ValueError(f"tensor map: the innermost box {boxes[0]} must span "
                         f"{' or '.join(map(str, SWIZZLES))} bytes (the swizzle)")
    if any(not 1 <= n <= MAX_BOX for n in boxes):
        raise ValueError(f"tensor map: box {tuple(box)} outside 1..{MAX_BOX}")
    if any(n < 1 or n >= 2**32 for n in dims):
        raise ValueError(f"tensor map: dims {tuple(t.shape)} outside 1..2^32")
    if any(s % 16 or not 0 < s < 2**40 for s in strides[1:]):
        raise ValueError(f"tensor map: strides {t.stride()} must be positive multiples of "
                         f"{16 // elem} elements (16 bytes) below 2^40 bytes")
    return dims + strides + boxes


def flash_grid(batch: int, heads: int, sq: int, rows: int = FLASH_BQ) -> Tuple[int, int]:
    """(query tiles per head, blocks) of a flash forward with ``rows``
    query rows a block: the bf16 wgmma kernel's by default, FLASH_F32_BQ
    for the fp32 one on the tensor cores."""
    q_tiles = -(-sq // rows)
    return q_tiles, batch * heads * q_tiles


def flash_block(block: int, heads: int, q_tiles: int,
                rows: int = FLASH_BQ) -> Tuple[int, int, int]:
    """(batch row, head, first query row) of a block: the query tiles of one
    (batch row, head) are neighbours, so its K and V are shared in L2."""
    qt, bh = block % q_tiles, block // q_tiles
    return bh // heads, bh % heads, qt * rows


def flash_kv_tiles(row_len: int, keys: int = FLASH_BK) -> int:
    """Key tiles of ``keys`` keys (``flash_fwd_bk(d)`` for the bf16
    forward, FLASH_F32_T for the fp32 one) a block visits for a row of
    ``row_len`` valid keys."""
    return -(-row_len // keys)


def flash_route(d: int) -> str:
    """The hand-written bf16 kernels that serve head dim ``d``, in the
    forward and in the backward alike: TMA + wgmma at every head dim."""
    if d not in (16, 32, 64, 128):
        raise ValueError(f"flash_route: no bf16 kernel at head dim {d}")
    return "wgmma"


def flash_panel_cols(d: int) -> int:
    """Columns of one box (and one shared-memory panel) of a bf16 flash
    map: a row of d bf16, or its halves at d 128; their bytes, 2 d or 128,
    are the map's swizzle (``csrc/flash_bf16_schedule.h``)."""
    return min(d, 64)


def flash_fwd_bk(d: int) -> int:
    """Keys per tile of the bf16 forward at head dim ``d``: FLASH_BK, or 64
    at 128 (registers)."""
    return 64 if d == 128 else FLASH_BK


def flash_map_specs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> List[int]:
    """The three maps of the bf16 forward, as ``wg::launch`` in
    csrc/flash_attention.cu takes them: 4-D views (B, S, H, D) of q, k and
    v (the strided halves of a merged kv projection load in place), loaded
    as boxes of FLASH_BQ (q) or ``flash_fwd_bk(d)`` (k, v) rows of one head
    and ``flash_panel_cols(d)`` columns (at d 128 two boxes a row)."""
    d = q.shape[-1]
    pc, bk = flash_panel_cols(d), flash_fwd_bk(d)
    return (map_spec(q, (1, FLASH_BQ, 1, pc)) + map_spec(k, (1, bk, 1, pc))
            + map_spec(v, (1, bk, 1, pc)))


def flash_strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> List[int]:
    """The element strides (batch, sequence, head) of q, k and v, as the C
    entries of the flash kernels take them (the head dim's is 1): the
    kernels that read through strides (fp32 FMA, and cp.async at head dim 32
    in fp32) address element (b, s, h, c) of each at its pointer plus b, s
    and h times these plus c."""
    return [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]


def flash_f32_kernel(d: int) -> str:
    """Which fp32 kernels serve head dim ``d``, in the forward
    (csrc/flash_attention.cu, ``pn_flash_attention_f32``'s switch) and in
    the backward alike (csrc/flash_attention_bwd.cu,
    ``pn_flash_attention_bwd_f32``'s): ``tc`` (3xTF32 wgmma, TMA) at 64,
    ``tc32`` (3xTF32 wgmma, cp.async) at 32, ``fma`` (the FMA units) at 16
    and 128."""
    return {64: "tc", 32: "tc32"}.get(d, "fma")


def flash_f32_map_specs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> List[int]:
    """The three maps of the fp32 forward on the tensor cores, as
    ``tc::launch`` in csrc/flash_attention.cu takes them: q, k and v (the
    strided halves of a merged kv projection load in place), each with
    32-row boxes of one 32-column panel (the tiles are two panels wide)."""
    box = (1, FLASH_F32_T, 1, SWIZZLE_BYTES // 4)
    return map_spec(q, box) + map_spec(k, box) + map_spec(v, box)


def flash_bwd_kt(d: int) -> int:
    """Keys of the tiles the bf16 dQ pass streams at head dim ``d``, and
    the rows of the k and v maps' boxes: 128, or 64 at 128 (shared
    memory); the dK/dV pass loads its FLASH_BWD_KB resident keys as
    FLASH_BWD_KB / flash_bwd_kt(d) boxes."""
    return 64 if d == 128 else 128


def flash_bwd_grid(batch: int, heads: int, sq: int, skv: int) -> Tuple[int, int, int, int]:
    """(key tiles per head, dK/dV blocks, query tiles per head, dQ blocks)
    of the wgmma backward, the same at every head dim."""
    k_tiles, q_tiles = -(-skv // FLASH_BWD_KB), -(-sq // FLASH_BWD_QB)
    return k_tiles, batch * heads * k_tiles, q_tiles, batch * heads * q_tiles


def flash_bwd_block(block: int, heads: int, tiles: int, rows: int) -> Tuple[int, int, int]:
    """(batch row, head, first row) of a block of either backward pass:
    ``tiles`` blocks of ``rows`` keys (dK/dV) or query rows (dQ) per head,
    the tiles of one (batch row, head) neighbours in launch order, so that
    the operands they stream are shared in L2."""
    tile, bh = block % tiles, block // tiles
    return bh // heads, bh % heads, tile * rows


def flash_bwd_key_block_active(key0: int, row_len: int) -> bool:
    """Whether the dK/dV block at ``key0`` computes: a block whose keys all
    lie at or past the row's valid length only writes zeros."""
    return key0 < row_len


def flash_bwd_q_tiles(sq: int) -> int:
    """Query tiles a dK/dV block streams; rows past Sq in the last one are
    zero-filled and have lse = +inf."""
    return -(-sq // FLASH_BWD_QT)


def flash_bwd_kv_tiles(row_len: int, d: int) -> int:
    """Key tiles a dQ block visits at head dim ``d`` for a row of
    ``row_len`` valid keys."""
    return -(-row_len // flash_bwd_kt(d))


def flash_bwd_map_specs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor) -> List[int]:
    """The six tensor maps the wgmma backward takes, as in
    ``pn_flash_attention_bwd_bf16``, each box ``flash_panel_cols(d)``
    columns of one head: q and dO with boxes of the dK/dV pass's streamed
    tiles (FLASH_BWD_QT rows), q and dO with the dQ pass's resident
    FLASH_BWD_QB rows, k and v with boxes of the dQ pass's streamed tiles
    (``flash_bwd_kt(d)`` keys, which the dK/dV pass loads too)."""
    d = q.shape[-1]
    pc, qt, kt = flash_panel_cols(d), FLASH_BWD_QT, flash_bwd_kt(d)
    return (map_spec(q, (1, qt, 1, pc)) + map_spec(do, (1, qt, 1, pc))
            + map_spec(q, (1, FLASH_BWD_QB, 1, pc)) + map_spec(do, (1, FLASH_BWD_QB, 1, pc))
            + map_spec(k, (1, kt, 1, pc)) + map_spec(v, (1, kt, 1, pc)))


def flash_bwd_f32_grid(batch: int, heads: int, sq: int, skv: int) -> Tuple[int, int, int, int]:
    """(key tiles per head, dK/dV blocks, query tiles per head, dQ blocks)
    of the fp32 tensor-core backward."""
    k_tiles, q_tiles = -(-skv // FLASH_BWD_F32_KB), -(-sq // FLASH_BWD_F32_QB)
    return k_tiles, batch * heads * k_tiles, q_tiles, batch * heads * q_tiles


def flash_bwd_f32_tiles(n: int, group: int) -> List[int]:
    """First rows of the streamed tiles warpgroup ``group`` (0 or 1) of the
    fp32 tensor-core backward takes over ``n`` rows: the two take the
    32-row tiles in turn. ``n``: Sq in the dK/dV pass (1 for a block whose
    keys all lie past kv_len: one tile, all masked), the row's valid key
    count in the dQ pass."""
    tiles = -(-n // FLASH_BWD_F32_T)
    return [t * FLASH_BWD_F32_T for t in range(group, tiles, 2)]


def flash_bwd_f32_map_specs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor) -> List[int]:
    """The four maps of the fp32 tensor-core backward, as ``tc::launch``
    takes them: q, dO, k and v, each with 32-row boxes of one 32-column
    panel (the tiles are two panels wide)."""
    box = (1, FLASH_BWD_F32_T, 1, SWIZZLE_BYTES // 4)
    return map_spec(q, box) + map_spec(do, box) + map_spec(k, box) + map_spec(v, box)


def geglu_grid(tokens: int, inner: int, sms: int, fp32: bool = False) -> Tuple[int, int, int]:
    """(token tiles, column tiles, blocks of the persistent grid) of the bf16
    kernel, or of the fp32 one."""
    bm, bn = (GEGLU_F32_BM, GEGLU_F32_BN) if fp32 else (GEGLU_BM, GEGLU_BN)
    m_tiles, n_tiles = -(-tokens // bm), -(-inner // bn)
    return m_tiles, n_tiles, min(m_tiles * n_tiles, sms)


def geglu_block_tiles(block: int, blocks: int, m_tiles: int, n_tiles: int
                      ) -> List[Tuple[int, int]]:
    """(first token, first column) of the tiles block ``block`` of the bf16
    kernel computes, in order. Tile index = token tile * n_tiles + column
    tile; a block takes every ``blocks``-th tile, so at any time the grid
    works on neighbouring tiles: all column tiles of a token tile run next
    to each other."""
    return [((tile // n_tiles) * GEGLU_BM, (tile % n_tiles) * GEGLU_BN)
            for tile in range(block, m_tiles * n_tiles, blocks)]


def geglu_f32_tile(tile: int, m_tiles: int, n_tiles: int) -> Tuple[int, int]:
    """(token tile, column tile) of tile index ``tile`` in the fp32 kernel's
    order (``f32::tile_coords``): groups of ``GEGLU_F32_GROUP_M`` token
    tiles, inside a group column-major, so that the tiles in flight share a
    few W column tiles and the group's x tiles stay in L2 while it sweeps W."""
    per_group = GEGLU_F32_GROUP_M * n_tiles
    group, local = divmod(tile, per_group)
    first = group * GEGLU_F32_GROUP_M
    rows = min(GEGLU_F32_GROUP_M, m_tiles - first)
    return first + local % rows, local // rows


def geglu_k_slices(c: int) -> int:
    """Channel slices per tile; the last is zero-filled past ``c``."""
    return -(-c // GEGLU_BK)


def geglu_tma_store(inner: int, fp32: bool = False) -> bool:
    """Whether the result leaves through TMA stores: its row stride must be
    a multiple of 16 bytes (8 bf16 or 4 fp32). Otherwise the kernel stores
    from registers."""
    return inner % (4 if fp32 else 8) == 0
