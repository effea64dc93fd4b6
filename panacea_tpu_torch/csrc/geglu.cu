// Fused GEGLU projection for Hopper (sm_90a), both forwards on the tensor cores
// with TMA and wgmma: bf16 in / bf16 out (pn_geglu_fwd), or fp32 in / fp32 out
// with its products as 3xTF32, which keeps fp32 accuracy (pn_geglu_3xtf32_fwd,
// described at its namespace); and the backward gate pass (pn_geglu_bwd):
//   out[t, j] = (x[t] . W[j] + b[j]) * gelu_erf(x[t] . W[I + j] + b[I + j])
// for x (T, C), W (2I, C) in the torch Linear layout, b (2I,), out (T, I).
//
// Replaces the Pallas TPU kernel panacea_tpu/ops/geglu.py (_geglu_kernel,
// :64-74; its pallas_call in geglu_matmul, :162). The TPU kernel used an
// Abramowitz-Stegun erf because Pallas-TPU has none; here it is erff.
//
// What bounds it on the H100: 4 T C I flops against 2 (T C + 2 I C + T I)
// bytes. At the main path's widths (C 320..1280, I = 4 C, T >= 3072) that is
// hundreds of flops per byte, above the ~295 flop/byte ridge: the tensor
// cores bound it. Unfused, the (T, 2I) intermediate would also be written
// and read back (0.8 GB at level 0), which the fusion removes. K is short
// (C = 320 is five 64-channel slices), so what surrounds the products weighs
// much: the erf epilogue of a tile costs about as many scheduler slots as the
// tile's products at C = 320.
//
// The design: a persistent, warp-specialised kernel, one block of three
// warpgroups per SM, each block walking over output tiles of 128 tokens x
// 128 columns.
//  - The producer warpgroup gives its registers away (setmaxnreg) and one of
//    its threads starts TMA loads per 64-channel slice: the x tile
//    (128 x 64) and rows j.. and I + j.. of W (two 128 x 64 boxes laid one
//    after the other, so the slot holds one 256-row operand), into a ring of
//    STAGES slots with the 128-byte swizzle, completing on mbarriers. TMA's
//    zero fill serves the token, column and channel tails (C % 64 != 0).
//  - Two consumer warpgroups own 64 tokens each: one wgmma m64n256k16 per 16
//    channels gives both halves, 128 fp32 accumulators a thread. One group
//    of products stays in flight while the next slice is awaited (the first
//    slice is peeled out of the loop: a conditional wait_group makes ptxas
//    serialise every wgmma).
//  - The epilogue (bias, exact-erf GELU, product, bf16 pack) runs in
//    registers; only the (T, I) result is written. The tile's biases are
//    brought to shared memory at the top of the tile, under the products
//    (read from global memory in the epilogue they cost it half again as
//    long at C = 1280). Each warpgroup lays its
//    64 x 128 result down in shared memory in the swizzle of the out map and
//    one thread sends it off as two TMA stores, which clip the token and
//    column tails and run on under the next tile. Where the out rows are not
//    16-byte multiples (inner % 8 != 0) TMA cannot write them, and the
//    threads store from registers with masks.
//  - The producer does not wait for the epilogue: it runs ahead into the
//    next tile, so the ring is full when the consumers come back, and a
//    warpgroup that finishes its epilogue first starts the next tile's
//    products while the other still computes erf. The products of one
//    warpgroup do not run under its own epilogue (that takes a second
//    accumulator set, which 232 registers do not hold at this tile size).
//  - Tile order: tile = token tile * column tiles + column tile, and block b
//    takes tiles b, b + blocks, ...: at any time the SMs work on
//    neighbouring tiles, so the column tiles of one token tile run next to
//    each other, x comes from device memory once and is re-read from L2, and
//    W (1.6 to 26 MB) stays in the 50 MB L2.

#include "hopper.cuh"

namespace {

constexpr int BM = 128;    // tokens per tile: 2 consumer warpgroups x 64
constexpr int BN = 128;    // output columns per tile (of each half)
constexpr int BKC = 64;    // channels per slot: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;
constexpr int X_BYTES = BM * BKC * 2, W_BYTES = 2 * BN * BKC * 2;

struct Smem {
  __nv_bfloat16 x[STAGES][BM * BKC];
  __nv_bfloat16 w[STAGES][2 * BN * BKC];  // rows [0, BN): W_h, [BN, 2 BN): W_gate
  __nv_bfloat16 out[2][2][64 * 64];        // per consumer warpgroup: two 64 x 64 panels
  __nv_bfloat16 bias[2][2 * BN];           // per consumer warpgroup: the tile's b_h, b_gate
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + pn::SWIZZLE_ATOM;  // room to align

// With -DPN_TRACE (scripts/probe_torch_kernels.py --trace) thread 0 of each
// consumer warpgroup of block 0 stamps the phases of its first tiles.
#ifdef PN_TRACE
constexpr int TRACE_TILES = 32, TRACE_SLOTS = 4;
__device__ long long g_trace[TRACE_TILES * 2 * TRACE_SLOTS];
#define TRACE(slot)                                                              \
  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && tile_no < TRACE_TILES) {    \
    long long now;                                                               \
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));                    \
    g_trace[(tile_no * 2 + group) * TRACE_SLOTS + (slot)] = now;                 \
  }
#else
#define TRACE(slot) (void)tile_no
#endif

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__global__ void __launch_bounds__(NTHREADS, 1)
pn_geglu_fwd(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
             const __grid_constant__ CUtensorMap out_map, const __nv_bfloat16* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int tokens, int c, int inner, int n_tiles,
             int total_tiles, int tma_store) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(pn::align_smem(smem_raw));
  const int group = threadIdx.x >> 7;
  const int k_slices = (c + BKC - 1) / BKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pn::mbar_init(&sm.full[s], 1);
      pn::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    pn::mbar_init_fence();
  }
  __syncthreads();

  if (group == 2) {
    // ---- producer
    pn::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;  // slices requested so far, over all tiles
      for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        for (int ks = 0; ks < k_slices; ++ks, ++it) {
          const int s = it % STAGES;
          pn::mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
          pn::mbar_arrive_expect_tx(&sm.full[s], X_BYTES + W_BYTES);
          pn::tma_load_2d(sm.x[s], &x_map, &sm.full[s], ks * BKC, m0);
          pn::tma_load_2d(sm.w[s], &w_map, &sm.full[s], ks * BKC, n0);
          pn::tma_load_2d(sm.w[s] + BN * BKC, &w_map, &sm.full[s], ks * BKC, inner + n0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup `group` owns tokens [64 group, 64 group + 64) of the tile
    pn::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = (inner & 1) == 0;  // column pairs are 4-byte aligned
    float acc[128];                       // [0, 64): the h half, [64, 128): the gate half
    int it = 0;
    for (int tile = blockIdx.x, tile_no = 0; tile < total_tiles; tile += gridDim.x, ++tile_no) {
      const int m0 = (tile / n_tiles) * BM + group * 64, n0 = (tile % n_tiles) * BN;
      TRACE(0);  // loop top

      // this tile's biases go to shared memory now, under the products (the
      // warpgroup's barrier at the end of its last epilogue freed the space)
      {
        const int i = threadIdx.x & 127, j = n0 + i;
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        sm.bias[group][i] = j < inner ? bias[j] : zero;
        sm.bias[group][BN + i] = j < inner ? bias[inner + j] : zero;
      }

      // one group of products stays in flight while the next slice is awaited
      auto start_slice = [&](int s, bool first) {
        const uint64_t x_desc =
            pn::smem_desc(pn::smem_u32(sm.x[s]) + group * 64 * pn::SWIZZLE_BYTES);
        const uint64_t w_desc = pn::smem_desc(pn::smem_u32(sm.w[s]));
        pn::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKC / 16; ++kk)
          pn::wgmma_m64n256k16_ss(acc, pn::desc_advance(x_desc, kk * 32),
                                  pn::desc_advance(w_desc, kk * 32), !(first && kk == 0));
        pn::wgmma_commit();
      };
      int prev = it % STAGES;
      pn::mbar_wait(&sm.full[prev], (it / STAGES) & 1);
      TRACE(1);  // first slot full
      start_slice(prev, true);
      ++it;
      for (int ks = 1; ks < k_slices; ++ks, ++it) {
        const int s = it % STAGES;
        pn::mbar_wait(&sm.full[s], (it / STAGES) & 1);
        start_slice(s, false);
        pn::wgmma_wait<1>();  // the slice before this one has been read
        if (lane == 0) pn::mbar_arrive(&sm.empty[prev]);
        prev = s;
      }
      pn::wgmma_wait<0>();
      pn::pin(acc);
      if (lane == 0) pn::mbar_arrive(&sm.empty[prev]);
      TRACE(2);  // products done

      // epilogue: bias, erf-GELU gate, product; only (T, I) is written
      const int elected = (threadIdx.x & 127) == 0;
      if (tma_store && elected) pn::tma_store_wait_read();  // the last store has read the panels
      pn::group_sync(group);  // the biases are written, the panels are free
      uint8_t* panels = reinterpret_cast<uint8_t*>(sm.out[group]);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {  // this thread's columns nt * 8 + 2 t, + 1
        const int col = nt * 8 + t * 2, j = n0 + col;
        const float2 bh =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sm.bias[group][col]));
        const float2 bg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sm.bias[group][BN + col]));
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // and its rows g, g + 8 of the warp's 16
          const int i = nt * 4 + r * 2, row = warp * 16 + g + r * 8;
          const __nv_bfloat162 y =
              __floats2bfloat162_rn((acc[i] + bh.x) * gelu_erf(acc[64 + i] + bg.x),
                                    (acc[i + 1] + bh.y) * gelu_erf(acc[64 + i + 1] + bg.y));
          if (tma_store) {
            // into the 64 x 64 panel of these columns, in the out map's swizzle
            *reinterpret_cast<__nv_bfloat162*>(panels + (nt >> 3) * 8192 +
                                               row * pn::SWIZZLE_BYTES +
                                               (((nt & 7) ^ (row & 7)) << 4) + t * 4) = y;
          } else if (m0 + row < tokens) {
            __nv_bfloat16* orow = out + static_cast<long long>(m0 + row) * inner;
            if (pairs && j + 1 < inner) {
              *reinterpret_cast<__nv_bfloat162*>(orow + j) = y;
            } else {
              if (j < inner) orow[j] = y.x;
              if (j + 1 < inner) orow[j + 1] = y.y;
            }
          }
        }
      }
      if (tma_store) {
        // one TMA store per panel, which clips the token and column tails and
        // runs on while this warpgroup starts its next tile
        pn::tma_store_fence();
        pn::group_sync(group);
        if (elected) {
          pn::tma_store_2d(&out_map, panels, n0, m0);
          pn::tma_store_2d(&out_map, panels + 8192, n0 + 64, m0);
          pn::tma_store_commit();
        }
      } else {
        pn::group_sync(group);  // every thread has read the biases
      }
      TRACE(3);  // epilogue done
    }
    if (tma_store && (threadIdx.x & 127) == 0) pn::tma_store_wait_all();
  }
}

// ------------------------------------------------------------------ fp32
//
// pn_geglu_3xtf32_fwd: the same function on fp32 operands, its products on
// the TF32 tensor cores in three parts ("3xTF32"). Each fp32 operand is split
// into a TF32 big part and a TF32 small part (pn::tf32_split, hopper.cuh),
// and every 8 channels add x_small W_big, x_big W_small and x_big W_big, in
// that order, to a set of fp32 accumulators. The dropped x_small W_small term
// is about 2^-22 of a product. The tensor cores' own sums are not rounded to
// nearest: each wgmma aligns its terms to the largest and rounds toward zero,
// and over the 120 to 480 wgmmas of a tile (C 320 to 1280) that bias put the
// result 5 times GEGLU_F32 off the exact function on an H100. So each 32-channel
// slice starts a fresh accumulator set, and the threads add it to the tile's
// fp32 sums with round-to-nearest once its products are done. The result is
// then as close to the exact function as an fp32 FMA sum is (the checks hold
// it to the function evaluated in float64 under the tolerance module's
// GEGLU_F32); one TF32 product alone would be some 2^-11 off.
//
// What bounds it on the H100: 3 x 4 T C I flops at the TF32 rate (495 TFLOP/s
// dense) against 4 (T C + 2 I C + 2 I + T I) bytes: at every main-path shape
// the products (1.95 ms at levels 0 to 2) outweigh the bytes (0.38 ms at
// level 0), so the tensor cores bound it, at 2.5 times less than the fp32 FMA
// rate (67 TFLOP/s) bounds a kernel without them.
//
// What the split costs: W is split once per call by pn_tf32_split into a
// (4I, C) scratch [W_big; W_small] (8 I C bytes read, 16 I C written: about
// 0.05 ms of bytes at C = 1280), and TMA brings both parts; x is split in
// shared memory by the consumer warpgroup that owns its rows, x_big in place
// and x_small beside it (4 float4 a thread a slice), with fence.proxy.async
// so that wgmma sees the threads' writes. Both operands then come from shared
// memory, so a slice moves some 240 KB of it a block against 1,536 cycles of
// products: shared memory, not the tensor cores, may set the pace (A from
// registers would save a third of that).
//
// The design is pn_geglu_fwd's: persistent, warp-specialised, one block of
// three warpgroups per SM, each block walking over output tiles of 128
// tokens x 64 columns of each half.
//  - The producer warpgroup gives its registers away; one thread starts TMA
//    loads per 32-channel slice (one 128-byte swizzled row of fp32): the x
//    tile (128 x 32), rows j.. and I + j.. of W_big and 2I + j.. and
//    3I + j.. of W_small (64 x 32 boxes, each pair laid one after the other,
//    so that a slot holds one 128-row operand per part), into a ring of
//    STAGES slots on mbarriers. TMA's zero fill serves the token and channel
//    tails; columns past inner read other rows and are never stored.
//  - Two consumer warpgroups own 64 tokens each and run wgmma m64n128k8
//    (TF32, both operands K-major in shared memory, a k8 step 32 bytes on
//    as bf16's k16): three per 8 channels, 64 fp32 accumulators a thread,
//    [0, 32) the h half and [32, 64) the gate half, and 64 more for the
//    tile's sums. A warpgroup waits for each slice's products before it adds
//    them and splits the next slice; the other warpgroup's products keep the
//    tensor cores busy meanwhile.
//  - The epilogue (bias from shared memory, exact-erf GELU, product) runs in
//    registers; each warpgroup lays its 64 x 64 result down as two 64 x 32
//    panels in the out map's swizzle, and one thread sends them off as TMA
//    stores, which clip the tails and run on under the next tile. Where the
//    out rows are not 16-byte multiples (inner % 4 != 0), the threads store
//    from registers with masks.
//  - Tile order: groups of GROUP_M token tiles, inside a group column-major
//    (the token tiles of one column tile are neighbours). The 132 tiles in
//    flight then share a few W column tiles and at most GROUP_M x tiles in
//    L2, and the group's x tiles stay there while it sweeps W: at C = 1280
//    [W_big; W_small] is 105 MB, twice the L2, and the bf16 kernel's
//    row-major order would bring it from device memory once per 1.6 token
//    tiles.
//
// Shared memory of a block (STAGES = 3): per slot x, x_small, W_big and
// W_small 16 KB each, out panels 2 x 2 x 8 KB, biases 1 KB, the barriers and
// the alignment pad: 231,472 of the 232,448 bytes a block may have.

namespace f32 {

constexpr int BM = 128;      // tokens per tile: 2 consumer warpgroups x 64
constexpr int BN = 64;       // output columns per tile (of each half)
constexpr int BKC = 32;      // channels per slot: one 128-byte swizzled row
constexpr int STAGES = 3;
constexpr int GROUP_M = 16;  // token tiles per group of the tile order
constexpr int NTHREADS = 384;
constexpr int PANEL_COLS = 32, PANEL = 64 * PANEL_COLS;  // one 64 x 32 out panel
constexpr int X_BYTES = BM * BKC * 4, W_BYTES = 2 * (2 * BN * BKC * 4);
constexpr int SPLIT_THREADS = 256, SPLIT_MAX_BLOCKS = 4096;

struct Smem {
  float x[STAGES][BM * BKC];       // x, split in place into x_big
  float xs[STAGES][BM * BKC];      // x_small
  float wb[STAGES][2 * BN * BKC];  // W_big: rows [0, BN) W_h, [BN, 2 BN) W_gate
  float ws[STAGES][2 * BN * BKC];  // W_small, the same rows
  float out[2][2 * PANEL];         // per consumer warpgroup: two 64 x 32 panels
  float bias[2][2 * BN];           // per consumer warpgroup: the tile's b_h, b_gate
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + pn::SWIZZLE_ATOM;  // room to align
static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");

// (token tile, column tile) of tile index `tile`; ops/_tma.py mirrors it
__device__ __forceinline__ void tile_coords(int tile, int m_tiles, int n_tiles, int& m, int& n) {
  const int group = tile / (GROUP_M * n_tiles), first = group * GROUP_M;
  const int rows = min(GROUP_M, m_tiles - first);
  const int local = tile - group * GROUP_M * n_tiles;
  m = first + local % rows;
  n = local / rows;
}

// w (rows, c) -> [W_big; W_small] (2 rows, c); n4 = rows * c / 4
__global__ void __launch_bounds__(SPLIT_THREADS)
pn_tf32_split(const float4* __restrict__ w, float4* __restrict__ big, float4* __restrict__ small,
              long long n4) {
  for (long long i = static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * SPLIT_THREADS) {
    const float4 v = w[i];
    float4 b, s;
    pn::tf32_split(v.x, b.x, s.x);
    pn::tf32_split(v.y, b.y, s.y);
    pn::tf32_split(v.z, b.z, s.z);
    pn::tf32_split(v.w, b.w, s.w);
    big[i] = b;
    small[i] = s;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
pn_geglu_3xtf32_fwd(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap out_map, const float* __restrict__ bias,
                    float* __restrict__ out, int tokens, int c, int inner, int m_tiles,
                    int n_tiles, int total_tiles, int tma_store) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(pn::align_smem(smem_raw));
  const int group = threadIdx.x >> 7;
  const int k_slices = (c + BKC - 1) / BKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pn::mbar_init(&sm.full[s], 1);
      pn::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    pn::mbar_init_fence();
  }
  __syncthreads();

  if (group == 2) {
    // ---- producer
    pn::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;  // slices requested so far, over all tiles
      for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
        int m, n;
        tile_coords(tile, m_tiles, n_tiles, m, n);
        const int m0 = m * BM, n0 = n * BN;
        for (int ks = 0; ks < k_slices; ++ks, ++it) {
          const int s = it % STAGES, k0 = ks * BKC;
          pn::mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
          pn::mbar_arrive_expect_tx(&sm.full[s], X_BYTES + W_BYTES);
          pn::tma_load_2d(sm.x[s], &x_map, &sm.full[s], k0, m0);
          pn::tma_load_2d(sm.wb[s], &w_map, &sm.full[s], k0, n0);
          pn::tma_load_2d(sm.wb[s] + BN * BKC, &w_map, &sm.full[s], k0, inner + n0);
          pn::tma_load_2d(sm.ws[s], &w_map, &sm.full[s], k0, 2 * inner + n0);
          pn::tma_load_2d(sm.ws[s] + BN * BKC, &w_map, &sm.full[s], k0, 3 * inner + n0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup `group` owns tokens [64 group, 64 group + 64) of the tile
    pn::setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = (inner & 1) == 0;  // column pairs are 8-byte aligned
    const uint32_t rows_off = group * 64 * pn::SWIZZLE_BYTES;  // this warpgroup's x rows
    float acc[64];  // a slice's products: [0, 32) the h half, [32, 64) the gate half
    float sum[64];  // the tile's, over the slices
    int it = 0;
    for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
      int m, n;
      tile_coords(tile, m_tiles, n_tiles, m, n);
      const int m0 = m * BM + group * 64, n0 = n * BN;

      // this tile's biases go to shared memory now, under the products (the
      // warpgroup's barrier at the end of its last epilogue freed the space)
      {
        const int j = n0 + (tid & (BN - 1));
        sm.bias[group][tid] = j < inner ? bias[(tid < BN ? 0 : inner) + j] : 0.f;
      }

      // x -> x_big in place and x_small beside it, this warpgroup's rows
      // only; the swizzle is a permutation inside the rows, the same in
      // both buffers, so the split goes element by element
      auto split = [&](int s) {
        float4* xb = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(sm.x[s]) + rows_off);
        float4* xl = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(sm.xs[s]) + rows_off);
#pragma unroll
        for (int e = 0; e < 64 * BKC / 4 / 128; ++e) {
          const int i = tid + e * 128;
          const float4 v = xb[i];
          float4 b, l;
          pn::tf32_split(v.x, b.x, l.x);
          pn::tf32_split(v.y, b.y, l.y);
          pn::tf32_split(v.z, b.z, l.z);
          pn::tf32_split(v.w, b.w, l.w);
          xb[i] = b;
          xl[i] = l;
        }
        pn::tma_store_fence();  // the writes are seen by wgmma (the async proxy)
        pn::group_sync(group);
      };
      // three products per 8 channels into a fresh accumulator set
      auto start_slice = [&](int s) {
        const uint64_t xb = pn::smem_desc(pn::smem_u32(sm.x[s]) + rows_off);
        const uint64_t xl = pn::smem_desc(pn::smem_u32(sm.xs[s]) + rows_off);
        const uint64_t wb = pn::smem_desc(pn::smem_u32(sm.wb[s]));
        const uint64_t wl = pn::smem_desc(pn::smem_u32(sm.ws[s]));
        pn::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKC / 8; ++kk) {
          const int off = kk * 32;
          pn::wgmma_m64n128k8_tf32_ss(acc, pn::desc_advance(xl, off), pn::desc_advance(wb, off),
                                      kk != 0);
          pn::wgmma_m64n128k8_tf32_ss(acc, pn::desc_advance(xb, off), pn::desc_advance(wl, off),
                                      1);
          pn::wgmma_m64n128k8_tf32_ss(acc, pn::desc_advance(xb, off), pn::desc_advance(wb, off),
                                      1);
        }
        pn::wgmma_commit();
      };
      // each slice's sums are added to the tile's, rounded to nearest, once
      // its products are done (the tensor cores' own sums truncate)
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      for (int ks = 0; ks < k_slices; ++ks, ++it) {
        const int s = it % STAGES;
        pn::mbar_wait(&sm.full[s], (it / STAGES) & 1);
        split(s);
        start_slice(s);
        pn::wgmma_wait<0>();
        pn::pin(acc);
        if (lane == 0) pn::mbar_arrive(&sm.empty[s]);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }

      // epilogue: bias, erf-GELU gate, product; only (T, I) is written
      const int elected = tid == 0;
      if (tma_store && elected) pn::tma_store_wait_read();  // the last store has read the panels
      pn::group_sync(group);  // the biases are written, the panels are free
      uint8_t* panels = reinterpret_cast<uint8_t*>(sm.out[group]);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {  // this thread's columns nt * 8 + 2 t, + 1
        const int col = nt * 8 + t * 2, j = n0 + col;
        const float2 bh = *reinterpret_cast<const float2*>(&sm.bias[group][col]);
        const float2 bg = *reinterpret_cast<const float2*>(&sm.bias[group][BN + col]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // and its rows g, g + 8 of the warp's 16
          const int i = nt * 4 + r * 2, row = warp * 16 + g + r * 8;
          const float2 y = make_float2((sum[i] + bh.x) * gelu_erf(sum[32 + i] + bg.x),
                                       (sum[i + 1] + bh.y) * gelu_erf(sum[32 + i + 1] + bg.y));
          if (tma_store) {
            // panel nt / 4 holds columns [32 (nt / 4), + 32): the pair is
            // 8 bytes at byte 32 (nt % 4) + 8 t of the row, in 16-byte
            // chunks that the out map's swizzle permutes by the row
            const int chunk = (nt & 3) * 2 + (t >> 1);
            *reinterpret_cast<float2*>(panels + (nt >> 2) * (PANEL * 4) +
                                       row * pn::SWIZZLE_BYTES + ((chunk ^ (row & 7)) << 4) +
                                       (t & 1) * 8) = y;
          } else if (m0 + row < tokens) {
            float* orow = out + static_cast<long long>(m0 + row) * inner;
            if (pairs && j + 1 < inner) {
              *reinterpret_cast<float2*>(orow + j) = y;
            } else {
              if (j < inner) orow[j] = y.x;
              if (j + 1 < inner) orow[j + 1] = y.y;
            }
          }
        }
      }
      if (tma_store) {
        // one TMA store per panel, which clips the token and column tails and
        // runs on while this warpgroup starts its next tile
        pn::tma_store_fence();
        pn::group_sync(group);
        if (elected) {
          pn::tma_store_2d(&out_map, panels, n0, m0);
          pn::tma_store_2d(&out_map, panels + PANEL * 4, n0 + PANEL_COLS, m0);
          pn::tma_store_commit();
        }
      } else {
        pn::group_sync(group);  // every thread has read the biases
      }
    }
    if (tma_store && (threadIdx.x & 127) == 0) pn::tma_store_wait_all();
  }
}

}  // namespace f32

// ------------------------------------------------------------------ backward
//
// pn_geglu_bwd: the gate-gradient pass of GEGLU's backward. The backward
// recomputes hg = x W^T + b with one library product (the JAX gradient leaves
// that product to XLA, outside any Pallas kernel); this kernel reads hg and dY
// and writes
//   d_hg[t, j]     = dY[t, j] * gelu(g)              (the h half)
//   d_hg[t, I + j] = dY[t, j] * h * gelu'(g)         (the gate half)
// with h = hg[t, j], g = hg[t, I + j], gelu'(g) = Phi(g) + g phi(g) and exact
// erff; dX, dW and db then come from library products and a sum.
//
// What bounds it: 10 bytes per (token, column) in bf16 (read h, g and dY,
// write both halves) against some 30 flops: memory. No tensor cores, no
// reuse. Each thread takes VEC columns of one row (16-byte loads and stores,
// 8 bf16 or 4 fp32) in a grid-stride loop; rows whose width is not a
// multiple of VEC take one column a thread. fp32 math on both types.

namespace bwd {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 4096;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f(float v) { return v; }

template <typename T, int VEC>
__device__ __forceinline__ void load(T (&dst)[VEC], const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* dst, const T (&src)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
pn_geglu_bwd(const T* __restrict__ hg, const T* __restrict__ dy, T* __restrict__ dhg,
             long long tokens, int inner) {
  const long long per_row = inner / VEC, total = tokens * per_row;
  for (long long u = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x; u < total;
       u += static_cast<long long>(gridDim.x) * NTHREADS) {
    const long long row = u / per_row;
    const int j = static_cast<int>(u - row * per_row) * VEC;
    const T* hrow = hg + row * 2 * inner;
    alignas(16) T h[VEC], g[VEC], d[VEC], dh[VEC], dg[VEC];
    load<T, VEC>(h, hrow + j);
    load<T, VEC>(g, hrow + inner + j);
    load<T, VEC>(d, dy + row * inner + j);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float gf = to_f(g[e]), hf = to_f(h[e]), df = to_f(d[e]);
      const float cdf = 0.5f * (1.f + erff(gf * 0.70710678118654752f));
      const float pdf = 0.39894228040143268f * expf(-0.5f * gf * gf);
      dh[e] = from_f<T>(df * (gf * cdf));
      dg[e] = from_f<T>(df * hf * (cdf + gf * pdf));
    }
    T* orow = dhg + row * 2 * inner;
    store<T, VEC>(orow + j, dh);
    store<T, VEC>(orow + inner + j, dg);
  }
}

template <typename T, int VEC>
int launch(const void* hg, const void* dy, void* dhg, long long tokens, int inner,
           cudaStream_t stream) {
  const long long units = tokens * (inner / VEC);
  const long long blocks = (units + NTHREADS - 1) / NTHREADS;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  pn_geglu_bwd<T, VEC><<<static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS),
                         NTHREADS, 0, stream>>>(
      static_cast<const T*>(hg), static_cast<const T*>(dy), static_cast<T*>(dhg), tokens, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

}  // namespace

// x (tokens, c), w (2 inner, c), bias (2 inner,), out (tokens, inner): all
// contiguous bf16, 16-byte aligned, c a multiple of 8. maps: the tensor-map
// specs of x, w and, where tma_store is set (inner a multiple of 8), out: 6
// values each (dims, byte strides, boxes, innermost first), as
// pn::encode_map takes them. blocks: the size of the persistent grid.
// Returns a cudaError_t value: of the set-up, or cudaGetLastError() after
// the launch.
extern "C" int pn_geglu_bf16(const void* x, const void* w, const void* bias, void* out,
                             int tokens, int c, int inner, const long long* maps, int tma_store,
                             int blocks, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pn_geglu_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!maps || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map, out_map;
  int err = pn::encode_map(&x_map, x, 2, maps, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (!err) err = pn::encode_map(&w_map, w, 2, maps + 6, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (!err && tma_store) err = pn::encode_map(&out_map, out, 2, maps + 12,
                                              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (!tma_store) out_map = x_map;  // never read
  if (err) return err;
  const int m_tiles = (tokens + BM - 1) / BM, n_tiles = (inner + BN - 1) / BN;
  const long long total = static_cast<long long>(m_tiles) * n_tiles;
  if (total < 1 || total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  pn_geglu_fwd<<<blocks, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, out_map, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), tokens, c, inner, n_tiles, static_cast<int>(total),
      tma_store);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 entry: x (tokens, c), w (2 inner, c), bias (2 inner,) and out
// (tokens, inner) contiguous fp32, 16-byte aligned, c a multiple of 4;
// w_split (4 inner, c) fp32 scratch, which receives [W_big; W_small]. maps:
// the tensor-map specs of x, w_split and, where tma_store is set (inner a
// multiple of 4), out, 6 values each, as pn::encode_map takes them. blocks:
// the size of the persistent grid. Two launches: the split of W, then the
// product. Returns a cudaError_t value.
extern "C" int pn_geglu_f32(const void* x, const void* w, const void* bias, void* out,
                            void* w_split, int tokens, int c, int inner, const long long* maps,
                            int tma_store, int blocks, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      f32::pn_geglu_3xtf32_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, f32::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!maps || blocks < 1 || c % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (tokens + f32::BM - 1) / f32::BM;
  const int n_tiles = (inner + f32::BN - 1) / f32::BN;
  const long long total = static_cast<long long>(m_tiles) * n_tiles;
  if (total < 1 || total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map, out_map;
  int err = pn::encode_map(&x_map, x, 2, maps, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (!err) err = pn::encode_map(&w_map, w_split, 2, maps + 6, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (!err && tma_store) err = pn::encode_map(&out_map, out, 2, maps + 12,
                                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (!tma_store) out_map = x_map;  // never read
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = 2LL * inner * c / 4;
  const long long split_blocks = (n4 + f32::SPLIT_THREADS - 1) / f32::SPLIT_THREADS;
  float4* big = static_cast<float4*>(w_split);
  f32::pn_tf32_split<<<static_cast<unsigned>(split_blocks < f32::SPLIT_MAX_BLOCKS
                                                 ? split_blocks : f32::SPLIT_MAX_BLOCKS),
                       f32::SPLIT_THREADS, 0, s>>>(static_cast<const float4*>(w), big, big + n4,
                                                   n4);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  f32::pn_geglu_3xtf32_fwd<<<blocks, f32::NTHREADS, f32::SMEM_BYTES, s>>>(
      x_map, w_map, out_map, static_cast<const float*>(bias), static_cast<float*>(out), tokens,
      c, inner, m_tiles, n_tiles, static_cast<int>(total), tma_store);
  return static_cast<int>(cudaGetLastError());
}

// The backward gate pass: hg (tokens, 2 inner) and dy (tokens, inner) in,
// dhg (tokens, 2 inner) out, all contiguous and 16-byte aligned, of one type:
// bf16, or fp32 where `fp32` is set. Returns a cudaError_t value.
extern "C" int pn_geglu_backward(const void* hg, const void* dy, void* dhg, long long tokens,
                                 int inner, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return inner % 4 ? bwd::launch<float, 1>(hg, dy, dhg, tokens, inner, s)
                     : bwd::launch<float, 4>(hg, dy, dhg, tokens, inner, s);
  return inner % 8 ? bwd::launch<__nv_bfloat16, 1>(hg, dy, dhg, tokens, inner, s)
                   : bwd::launch<__nv_bfloat16, 8>(hg, dy, dhg, tokens, inner, s);
}

#ifdef PN_TRACE
// Copies the stamps (nanoseconds of %globaltimer) to `host`, TRACE_TILES x 2
// warpgroups x TRACE_SLOTS values. Returns a cudaError_t value.
extern "C" int pn_geglu_trace(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));
}
#endif

extern "C" const char* pn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
