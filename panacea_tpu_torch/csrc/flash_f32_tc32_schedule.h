// The schedule of the fp32 flash forward at head dim 32 on the tensor cores
// (tc32::pn_flash_f32_fwd_tc32 in flash_attention.cu): which block takes
// which query rows, how many blocks of a cluster share a row's keys, and
// where each block's share of the keys begins.
//
// Plain C++ with no CUDA header, so that a host compiler builds it as well:
// tests/test_torch_kernels.py compiles it with g++ and checks on the CPU that
// every query row is written once and every valid key is taken once.
#pragma once

#ifdef __CUDACC__
#define PN_HOST_DEVICE __host__ __device__
#else
#define PN_HOST_DEVICE
#endif

namespace pn {
namespace tc32_schedule {

constexpr int BQ = 128;   // query rows per block: two warpgroups x 64
constexpr int KT = 32;    // keys per tile
constexpr int SPLIT = 2;  // blocks of a cluster, which share a row's keys

// Blocks of a cluster that share each query tile's keys, for a launch of
// `blocks` 128-row blocks on `sms` SMs: SPLIT where that many still fit
// one wave, else 1.
constexpr int key_split(long long blocks, int sms) { return SPLIT * blocks <= sms ? SPLIT : 1; }

// First key of part `part` of `split` parts of a row of `len` keys: whole
// tiles, the first part (which merges) no more tiles than the last; a row
// of fewer tiles than parts is split by keys (of one key, the last part is
// empty).
PN_HOST_DEVICE constexpr int key_begin(int len, int part, int split) {
  return part >= split ? len
         : (len + KT - 1) / KT >= split ? KT * ((len + KT - 1) / KT * part / split)
                                        : (len * part + split - 1) / split;
}

// What block `block` of the launch computes: block = ((batch row * heads +
// head) * q_tiles + query tile) * split + part, so the `split` blocks of a
// query tile are neighbours (one cluster, part the block's rank in it) and
// so are the query tiles of one (batch row, head).
struct Block {
  int b, h, qt, part;
};
PN_HOST_DEVICE constexpr Block block_of(int block, int heads, int q_tiles, int split) {
  return {block / split / q_tiles / heads, block / split / q_tiles % heads,
          block / split % q_tiles, block % split};
}

// the perception self-attention's row (1,668 keys): 26 and 27 tiles
static_assert(key_begin(1668, 1, SPLIT) == 832 && key_begin(1668, 2, SPLIT) == 1668, "");
// a row of one key: the first part takes it, the second is empty
static_assert(key_begin(1, 1, SPLIT) == 1 && key_begin(1, 2, SPLIT) == 1, "");

}  // namespace tc32_schedule
}  // namespace pn
