// The tiles of the bf16 flash kernels on TMA + wgmma (wg:: in
// flash_attention.cu and flash_attention_bwd.cu) at each head dim D (16, 32,
// 64, 128): rows per block and per streamed tile, ring slots, the shared
// memory each kernel asks for, and which exponentials go to the FMA units.
//
// A row of D bf16 lies in shared memory as panels of at most 64 columns (128
// bytes), each swizzled as TMA lays it down with the swizzle of its row
// width: 32 bytes at D 16, 64 at D 32, 128 at D 64 and, in two panels, at
// D 128. A tile of R rows is its panels one after the other, each R rows of
// one swizzle width; a k16 step of a K-major operand is 32 bytes into a
// panel, or the next panel.
//
// Plain C++ with no CUDA header, so that a host compiler builds it as well:
// tests/test_torch_kernels.py compiles it with g++ and holds the host's tiles
// (ops/_tma.py) and the shared memory against it; the kernels hold their
// own structures to these byte counts by static_assert.
#pragma once

#ifdef __CUDACC__
#define PN_HOST_DEVICE __host__ __device__
#else
#define PN_HOST_DEVICE
#endif

namespace pn {
namespace bf16_schedule {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory an H100 block may use
constexpr int ALIGN = 1024;       // the pad that moves the tiles to a 1024-byte boundary

PN_HOST_DEVICE constexpr bool head_dim_ok(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }
PN_HOST_DEVICE constexpr int panel_cols(int d) { return d < 64 ? d : 64; }
PN_HOST_DEVICE constexpr int swizzle_bytes(int d) { return 2 * panel_cols(d); }
PN_HOST_DEVICE constexpr int panels(int d) { return d / panel_cols(d); }

// Byte offset, inside a tile of `rows` rows, of k16 step `kk` of a K-major
// operand: 32 bytes a step inside a panel, the next panel after it.
PN_HOST_DEVICE constexpr int kstep_offset(int d, int rows, int kk) {
  return kk * 32 / swizzle_bytes(d) * rows * swizzle_bytes(d) + kk * 32 % swizzle_bytes(d);
}

// The forward's exponentials computed on the FMA units by a polynomial
// (pn::ex2_poly) rather than by the special-function unit: every
// poly_every(d)-th one of a thread's scores, none where 0. At D 16 and 32 a
// score costs 4 D tensor-core flops and one exponential, and an SM computes
// 16 exponentials a clock against 1,024 bf16 flops: the exponentials bound
// those head dims. Every 8th was the fastest share (every 16th and 4th were
// slower; scripts/flash_bf16_headdims.py ablate). The backward takes none:
// its loops are bound by their issue slots rather than by the
// exponentials, and the polynomial's 1e-4 moved the bf16 roundings of P
// and dS past the kernels' rule (ablate_bwd, variant poly8).
PN_HOST_DEVICE constexpr int poly_every(int d) { return d < 64 ? 8 : 0; }

// ---- forward: a block of two consumer warpgroups (64 query rows each) and
// a producer warpgroup per 128 query rows; K and V stream in tiles of
// fwd_bk keys through rings of fwd_stages slots. The block's 384 threads
// hold ptxas to 168 registers a thread in the consumers' code too: at D 128
// with 128-key tiles S (64), O (64) and P (32) did not fit beside the
// softmax, and ptxas parked P in local memory between the two products, so
// D 128 takes 64-key tiles (S 32, P 16) and four slots (a tile 16 KB, Q 32)
constexpr int FWD_BQ = 128;
PN_HOST_DEVICE constexpr int fwd_bk(int d) { return d == 128 ? 64 : 128; }
PN_HOST_DEVICE constexpr int fwd_stages(int d) { return d == 128 ? 4 : 3; }
// Where the forward masks the keys past a row's length: in the last of its
// key tiles only (the others lie below it), or in every tile where the
// length falls inside it (ptxas turns that test into compares and selects
// on every tile). The last tile alone is faster at D 16 and 128 and slower
// at D 64, whose levels it ran 4 to 8 % longer (PERF.md section 6;
// scripts/flash_bf16_headdims.py ablate, variant mask_last).
PN_HOST_DEVICE constexpr bool fwd_mask_every_tile(int d) { return d == 64; }
PN_HOST_DEVICE constexpr int fwd_smem_bytes(int d) {
  return 2 * (FWD_BQ * d + 2 * fwd_stages(d) * fwd_bk(d) * d) + 8 * (1 + 4 * fwd_stages(d)) +
         ALIGN;
}

// ---- backward: two passes, each a block of two consumer warpgroups
// dK/dV: BWD_KB keys a block (64 a warpgroup), K and V resident; Q and dO
// stream in tiles of BWD_QT rows through bwd_kv_stages slots. At D 128 a
// thread then holds dK and dV (128 registers), S^T and dP^T (64) and P^T
// and dS^T (32): 255 registers, no spill; 32-row tiles (210 registers, 8
// slots) made S^T and dP^T m64n32 products, each reading 3 KB of shared
// memory for 65 kflops, and the pass took a third longer (PERF.md section
// 6). Four slots of 32 KB fit beside K and V there, not five.
constexpr int BWD_KB = 128, BWD_QT = 64;
PN_HOST_DEVICE constexpr int bwd_kv_stages(int d) { return d == 128 ? 4 : 5; }
constexpr int BWD_QB = 128;
PN_HOST_DEVICE constexpr int bwd_kt(int d) { return d == 128 ? 64 : 128; }
constexpr int BWD_Q_STAGES = 4;
constexpr int BWD_LAG = 2;  // a slot is refilled two tiles after it was consumed
PN_HOST_DEVICE constexpr int bwd_kv_smem_bytes(int d) {
  return 2 * (2 * BWD_KB * d + 2 * bwd_kv_stages(d) * BWD_QT * d) + 4 * 2 * 2 * 2 * BWD_QT +
         8 * (1 + 2 * bwd_kv_stages(d)) + ALIGN;
}
PN_HOST_DEVICE constexpr int bwd_q_smem_bytes(int d) {
  return 2 * (2 * BWD_QB * d + 2 * BWD_Q_STAGES * bwd_kt(d) * d) + 8 * (1 + 2 * BWD_Q_STAGES) +
         ALIGN;
}

static_assert(fwd_smem_bytes(128) <= MAX_SMEM && fwd_smem_bytes(64) <= MAX_SMEM, "");
static_assert(bwd_kv_smem_bytes(128) <= MAX_SMEM && bwd_q_smem_bytes(128) <= MAX_SMEM, "");
static_assert(bwd_kv_smem_bytes(64) <= MAX_SMEM && bwd_q_smem_bytes(64) <= MAX_SMEM, "");
static_assert(BWD_KB % bwd_kt(128) == 0, "");

}  // namespace bf16_schedule
}  // namespace pn
