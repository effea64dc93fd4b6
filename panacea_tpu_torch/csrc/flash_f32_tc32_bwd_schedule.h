// The schedule of the fp32 flash backward at head dim 32 on the tensor cores
// (tc32::pn_flash_bwd_f32_{dkdv,dq}_tc32 in flash_attention_bwd.cu): which
// block takes which keys (dK/dV pass) or query rows (dQ pass), which tiles
// of the other side it streams, and which of them each warpgroup of a dQ
// block takes.
//
// Plain C++ with no CUDA header, so that a host compiler builds it as well:
// tests/test_torch_kernels.py compiles it with g++ and checks on the CPU that
// every key and every query row is written once, that every valid key meets
// every query row once, and that a block whose keys lie past kv_len writes
// zeros.
#pragma once

#ifdef __CUDACC__
#define PN_BWD_HOST_DEVICE __host__ __device__
#else
#define PN_BWD_HOST_DEVICE
#endif

namespace pn {
namespace tc32_bwd_schedule {

constexpr int KB = 64;      // keys per dK/dV block
constexpr int QB = 64;      // query rows per dQ block, which every warpgroup of it owns
constexpr int ROWS = 32;    // rows of a streamed tile: query rows (dK/dV) or keys (dQ)
// A dK/dV block is one warpgroup, two blocks an SM (two warpgroups of one
// block start in step and then contend for the tensor cores and the issue
// slots together). A dQ block is Q_GROUPS warpgroups, which take the key
// tiles in turn and add their sums at the end: its 240 blocks at B 2 are
// 480 warpgroups, up to four an SM.
constexpr int KV_BLOCKS_PER_SM = 2;  // dK/dV blocks an SM holds
constexpr int Q_GROUPS = 2;

// What block `block` of a pass with `tiles` blocks per (batch row, head)
// computes: block = (batch row * heads + head) * tiles + tile, so the
// blocks of one (batch row, head), which stream the same tiles, are
// neighbours in launch order.
struct Block {
  int b, h, tile;
};
PN_BWD_HOST_DEVICE constexpr Block block_of(int block, int heads, int tiles) {
  return {block / tiles / heads, block / tiles % heads, block % tiles};
}

// Query tiles a dK/dV block streams, the i-th from row i ROWS: all of Sq's
// where its first key lies below the row's length, else one (every key
// masked: the block writes zeros).
PN_BWD_HOST_DEVICE constexpr int kv_block_tiles(int sq, int key0, int row_len) {
  return key0 < row_len ? (sq + ROWS - 1) / ROWS : 1;
}

// Key tiles a dQ block streams: those below the row's length; the last is
// masked from row_len on. Its warpgroups take them in turn.
PN_BWD_HOST_DEVICE constexpr int q_block_tiles(int row_len) { return (row_len + ROWS - 1) / ROWS; }

// Of `n` streamed tiles, warpgroup `group` of `groups` takes group,
// group + groups, ...: this many, its i-th starting at row
// tile_row(i, group, groups).
PN_BWD_HOST_DEVICE constexpr int group_tiles(int n, int group, int groups) {
  return (n - group + groups - 1) / groups;
}
PN_BWD_HOST_DEVICE constexpr int tile_row(int i, int group, int groups) {
  return (group + groups * i) * ROWS;
}

// the perception self-attention's (Sq 900, Skv 1668): 29 query tiles, 53
// key tiles (27 and 26 for the dQ pass's two warpgroups); a block past
// kv_len streams one masked tile
static_assert(kv_block_tiles(900, 0, 1668) == 29 && q_block_tiles(1668) == 53, "");
static_assert(group_tiles(53, 0, 2) == 27 && group_tiles(53, 1, 2) == 26, "");
static_assert(kv_block_tiles(900, 64, 64) == 1, "");

}  // namespace tc32_bwd_schedule
}  // namespace pn
