// Flash attention forward for Hopper (sm_90a): bf16 in / bf16 out on the tensor
// cores, or fp32 in / fp32 out (3xTF32 on the tensor cores at head dims 64
// and 32, the FMA units at 16 and 128); fp32 softmax and accumulation.
//
// Replaces the Pallas TPU kernel panacea_tpu/ops/flash_attention.py
// (_flash_kernel, :33-86; its pallas_call in flash_attention, :236).
// It computes softmax(q k^T * scale) v for q (B, Sq, H, D) and k, v
// (B, Skv, H, D), read in place through their strides (no head-fold
// transposes), with the key tail masked per batch row by kv_lens (or by Skv).
//
// What bounds it on the H100: at the main path's shapes (Sq 128..2048,
// Skv = 2 Sq, D = 64) the work is 4 B H Sq Skv D flops against
// 2 B H (Sq + 2 Skv) D bytes, about 2 Sq / 3 flops per byte: above the
// card's ~295 flop/byte ridge from Sq = 512 up, so the tensor cores bound
// levels 0 and 1 and memory bounds level 2. At D = 64 a score costs 256
// tensor-core flops and one exponential, and an SM does 16 of either per
// clock: the exponentials take as long as both products, so the two must
// overlap.
//
// One hand-written bf16 kernel, pn_flash_fwd<D>, instantiated at every head
// dim the dispatch takes (fp32 operands go to three others,
// tc::pn_flash_f32_fwd_tc at head dim 64, tc32::pn_flash_f32_fwd_tc32 at 32,
// the perception self-attention's, and f32::pn_flash_f32_fwd at 16 and 128,
// described at their namespaces). One block of three warpgroups per (128
// query rows, head, batch):
//  - The producer warpgroup gives its registers away (setmaxnreg) and one of
//    its threads starts TMA loads: the Q tile once, then K and V tiles of
//    BK keys into two rings of STAGES slots each, completing on mbarriers.
//    The tensor maps are 4-D (D, H, S, B) with the byte strides of the
//    views, so the halves of a merged kv projection load in place; rows past
//    Skv (and past Sq) arrive as zeros. A row is swizzled by its width (32,
//    64 or 128 bytes at D 16, 32, 64); at D 128 each tile is two panels of
//    64 columns, two boxes of one map (flash_bf16_schedule.h).
//  - Two consumer warpgroups own 64 query rows each. S = Q K^T is
//    wgmma m64nBKk16 with both operands in shared memory (D / 16 k-steps,
//    the descriptors stepping 32 bytes into a panel or to the next); the
//    probabilities stay in registers, are rounded to bf16 and are the A
//    operand of the P V wgmma (m64nDk16; two m64n64k16 on the two panels at
//    D 128), which reads V MN-major, as TMA laid it down. Running max, sum
//    and the output stay in fp32 registers; the exponent is base 2 with
//    scale * log2(e) folded into one fused multiply-add.
//  - Overlap of softmax and tensor cores: inside a warpgroup, tile j's
//    Q K^T and tile j-1's P V are both started before tile j's softmax, so
//    the exponentials run while P V is in flight; and the two warpgroups run
//    unsynchronised, so one's exponentials also fill the other's products.
//  - A block visits only the tiles below its row's kv_len and masks the last
//    one in registers. The output is written once with masked stores.
// Per head dim (flash_bf16_schedule.h): BK 128 and three slots at D 16, 32
// and 64 (D 64, the production head dim, is the earlier design unchanged).
// D 128: Q takes 32 KB; the 384 threads hold ptxas to 168 registers a
// thread, where 128-key tiles needed 64 (S) + 64 (O) + 32 (P) beside the
// softmax and spilled P, so BK is 64 (S 32, P 16) with four 16 KB slots.
// D 16 and 32: a score costs 64 or 128 tensor-core flops and one
// exponential, and an SM does 1,024 flops but 16 exponentials a clock, so
// the exponentials bound them (4 and 2 times the products); a share of them
// may go to the FMA units (sched::poly_every, pn::ex2_poly).
//
// Every route can also write the row log-sum-exp that the backward kernels
// (flash_attention_bwd.cu) recompute the probabilities from: fp32, (B, H, Sq),
// base 2 of the scaled scores, lse = max * scale * log2(e) + log2(sum). The
// pointer is null on the sampling path, which then stores nothing more.
//
// A row with kv_lens 0 attends to all Skv keys with every score 0
// (pn::row_keys; the score scale set to 0, or in pn_flash_fwd a Q tile of
// zeros): each probability is 1 / Skv, the output the mean of V and lse =
// log2(Skv), the answer of the reference, whose empty row masks every score
// alike.

#include <type_traits>

#include "hopper.cuh"
#include "flash_bf16_schedule.h"
#include "flash_f32_tc.cuh"
#include "flash_f32_tc32_schedule.h"

namespace {

constexpr float NEG = -1e30f;

// a masked score's exponent in the fp32 tensor-core kernels: ex2 of it is 0
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ------------------------------------------------- wgmma, D = 16, 32, 64, 128

namespace wg {

namespace sched = pn::bf16_schedule;

constexpr int BQ = sched::FWD_BQ;  // query rows per block: 2 consumer warpgroups x 64
constexpr int NTHREADS = 384;

template <int D>
struct Smem {
  static constexpr int BK = sched::fwd_bk(D);           // keys per tile
  static constexpr int STAGES = sched::fwd_stages(D);  // slots in each of the K and V rings
  __nv_bfloat16 q[BQ * D];
  __nv_bfloat16 k[STAGES][BK * D];
  __nv_bfloat16 v[STAGES][BK * D];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};
template <int D>
constexpr int SMEM_BYTES = sizeof(Smem<D>) + pn::SWIZZLE_ATOM;  // room to align
static_assert(SMEM_BYTES<16> == sched::fwd_smem_bytes(16) &&
                  SMEM_BYTES<32> == sched::fwd_smem_bytes(32) &&
                  SMEM_BYTES<64> == sched::fwd_smem_bytes(64) &&
                  SMEM_BYTES<128> == sched::fwd_smem_bytes(128),
              "the shared memory of flash_bf16_schedule.h");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on this thread's two rows. On entry s holds
// raw scores; on exit the probabilities exp2((s - max) * scale_log2). m is
// the running max of raw scores, l this thread's share of the running sum.
// Columns from `limit` on are masked where MASK (a tile no later tile
// follows). Returns the factors for the old sums. Every POLY-th probability
// (none where POLY is 0) is pn::ex2_poly's. BK: keys per tile.
template <int BK, int POLY, bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2, int limit,
                                             int t) {
  if (MASK && limit < BK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if ((i >> 2) * 8 + t * 2 + (i & 1) >= limit) s[i] = NEG;
  }
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = ex2((m[r] - mn) * scale_log2);
    m[r] = mn;
    ms[r] = mn * scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float x = fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]);
    if constexpr (POLY > 0) s[i] = i % POLY == POLY - 1 ? pn::ex2_poly(x) : ex2(x);
    else s[i] = ex2(x);
    sum[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_fwd(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, const int* __restrict__ kv_lens, int heads, int sq,
             int skv, int q_tiles, float scale_log2) {
  constexpr int BK = Smem<D>::BK, STAGES = Smem<D>::STAGES;
  constexpr int TILE_BYTES = BK * D * 2;
  // a row lies in PANELS panels of PC columns, rows of SW bytes each
  constexpr int SW = sched::swizzle_bytes(D), PC = sched::panel_cols(D), PANELS = D / PC;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(pn::align_smem(smem_raw));

  // blockIdx.x = (batch * heads + head) * q_tiles + q tile: the blocks that
  // share one head's K and V are neighbours in launch order
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads;
  // an empty row (kv_lens 0) attends to every key with scores 0 (pn::row_keys):
  // its Q tile is loaded from past Sq, which TMA fills with zeros; the scale
  // stays, so that keys past Skv keep their mask
  const int row_len = pn::row_keys(kv_lens, b, skv);
  const int q_row0 = pn::empty_row(kv_lens, b) ? sq : qt * BQ;
  const int n_tiles = (row_len + BK - 1) / BK;
  const int group = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      pn::mbar_init(&sm.k_full[s], 1);
      pn::mbar_init(&sm.v_full[s], 1);
      pn::mbar_init(&sm.k_empty[s], 8);  // one arrival per consumer warp
      pn::mbar_init(&sm.v_empty[s], 8);
    }
    pn::mbar_init_fence();
  }
  __syncthreads();

  if (group == 2) {
    // ---- producer: each tile as PANELS boxes of PC columns
    pn::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      pn::mbar_arrive_expect_tx(&sm.q_full, BQ * D * 2);
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        pn::tma_load_4d(sm.q + p * BQ * PC, &q_map, &sm.q_full, p * PC, h, q_row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, free_parity = ((j / STAGES) & 1) ^ 1;
        pn::mbar_wait(&sm.k_empty[s], free_parity);
        pn::mbar_arrive_expect_tx(&sm.k_full[s], TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          pn::tma_load_4d(sm.k[s] + p * BK * PC, &k_map, &sm.k_full[s], p * PC, h, j * BK, b);
        pn::mbar_wait(&sm.v_empty[s], free_parity);
        pn::mbar_arrive_expect_tx(&sm.v_full[s], TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          pn::tma_load_4d(sm.v[s] + p * BK * PC, &v_map, &sm.v_full[s], p * PC, h, j * BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup `group` owns rows [64 group, 64 group + 64)
    pn::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint64_t q_desc = pn::smem_desc<SW>(pn::smem_u32(sm.q) + group * 64 * SW);

    float s[BK / 2], acc[D / 2];
    uint32_t p[BK / 16][4];
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    auto start_qk = [&](int stage) {  // s = Q K^T, one committed group
      const uint64_t k_desc = pn::smem_desc<SW>(pn::smem_u32(sm.k[stage]));
      pn::pin(s);
      pn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        pn::wgmma_ss<BK>(s, pn::desc_advance(q_desc, sched::kstep_offset(D, BQ, kk)),
                         pn::desc_advance(k_desc, sched::kstep_offset(D, BK, kk)), kk > 0);
      pn::wgmma_commit();
    };
    auto start_pv = [&](int stage) {  // acc += P V, one committed group
      const uint64_t v_desc = pn::smem_desc<SW>(pn::smem_u32(sm.v[stage]));
      pn::pin(acc);
      pn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (PANELS == 1) {
          pn::wgmma_rs_mn<D>(acc, p[kk], pn::desc_advance(v_desc, kk * 16 * SW));
        } else {
#pragma unroll
          for (int pa = 0; pa < PANELS; ++pa)
            pn::wgmma_rs_mn<64>(pn::acc_half(acc, pa), p[kk],
                                pn::desc_advance(v_desc, pa * BK * SW + kk * 16 * SW));
        }
      }
      pn::wgmma_commit();
    };
    auto pack_p = [&]() {  // the probabilities, rounded to bf16, as A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pn::pack_bf16x2(s[kk * 8 + e * 2], s[kk * 8 + e * 2 + 1]);
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) pn::mbar_arrive(bar);
    };
    constexpr int POLY = sched::poly_every(D);

    pn::mbar_wait(&sm.q_full, 0);
    pn::mbar_wait(&sm.k_full[0], 0);
    start_qk(0);
    pn::wgmma_wait<0>();
    pn::pin(s);
    release(&sm.k_empty[0]);
    if constexpr (sched::fwd_mask_every_tile(D)) {
      // the test of the mask on every tile (D 64, where it is faster)
      softmax_step<BK, POLY, true>(s, m, l, corr, scale_log2, row_len, t);
      pack_p();
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % STAGES, prev = (j - 1) % STAGES;
        pn::mbar_wait(&sm.k_full[st], (j / STAGES) & 1);
        start_qk(st);
        pn::mbar_wait(&sm.v_full[prev], ((j - 1) / STAGES) & 1);
        start_pv(prev);
        pn::wgmma_wait<1>();  // Q K^T of tile j is done; P V of tile j-1 runs on
        pn::pin(s);
        release(&sm.k_empty[st]);
        softmax_step<BK, POLY, true>(s, m, l, corr, scale_log2, row_len - j * BK, t);
        pn::wgmma_wait<0>();
        pn::pin(acc);
        release(&sm.v_empty[prev]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        pack_p();
      }
    } else {
      // the same steps, with the mask only in the last tile, which the loop
      // leaves out (a test inside the loop kept both softmax bodies in it)
      auto step = [&](int j, auto mask) {
        const int st = j % STAGES, prev = (j - 1) % STAGES;
        pn::mbar_wait(&sm.k_full[st], (j / STAGES) & 1);
        start_qk(st);
        pn::mbar_wait(&sm.v_full[prev], ((j - 1) / STAGES) & 1);
        start_pv(prev);
        pn::wgmma_wait<1>();
        pn::pin(s);
        release(&sm.k_empty[st]);
        softmax_step<BK, POLY, decltype(mask)::value>(s, m, l, corr, scale_log2,
                                                      row_len - j * BK, t);
        pn::wgmma_wait<0>();
        pn::pin(acc);
        release(&sm.v_empty[prev]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        pack_p();
      };
      if (n_tiles == 1) softmax_step<BK, POLY, true>(s, m, l, corr, scale_log2, row_len, t);
      else softmax_step<BK, POLY, false>(s, m, l, corr, scale_log2, row_len, t);
      pack_p();
      for (int j = 1; j < n_tiles - 1; ++j) step(j, std::false_type{});
      if (n_tiles > 1) step(n_tiles - 1, std::true_type{});
    }
    const int last = (n_tiles - 1) % STAGES;
    pn::mbar_wait(&sm.v_full[last], ((n_tiles - 1) / STAGES) & 1);
    start_pv(last);
    pn::wgmma_wait<0>();
    pn::pin(acc);

    // the output, (B, Sq, H, D) contiguous, written once; rows past Sq never
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    const int row0 = qt * BQ + group * 64 + warp * 16 + g;
    __nv_bfloat16* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
    const long long o_ss = static_cast<long long>(heads) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < sq) {
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(ob + row * o_ss + dt * 8 + t * 2) =
              pn::pack_bf16x2(acc[dt * 4 + r * 2] * inv[r], acc[dt * 4 + r * 2 + 1] * inv[r]);
        if (lse && t == 0)
          lse[static_cast<long long>(bh) * sq + row] = m[r] * scale_log2 + log2f(l[r]);
      }
    }
  }
}

// maps: three specs of 12 values (dims, byte strides, boxes of the 4-D views
// of q, k and v, innermost first), as pn::encode_map takes them: boxes of
// BQ (q) or sched::fwd_bk(D) (k, v) rows of one head and
// sched::panel_cols(D) columns.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* maps, float scale_log2,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pn_flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES<D>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int err = pn::encode_map(&q_map, q, 4, maps, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (!err) err = pn::encode_map(&k_map, k, 4, maps + 12, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (!err) err = pn::encode_map(&v_map, v, 4, maps + 24, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err) return err;
  const int q_tiles = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  pn_flash_fwd<D><<<static_cast<unsigned>(blocks), NTHREADS, SMEM_BYTES<D>, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_lens), heads, sq, skv, q_tiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------ fp32, D = 16, 128
//
// The Pallas kernel keeps its operands' type, so fp32 inputs give fp32
// products. This kernel does the same on the FMA units: no tensor cores, no
// TF32, no bf16 cut anywhere. Head dims 64 and 32 go to the tc and tc32
// kernels below; no path calls the others. The bound is then the card's fp32 rate outside
// the tensor cores (4 B H Sq Skv D flops at 67 TFLOP/s on an H100 SXM), 15
// times the bf16 bound, and far above the time to read q, k and v once.
//
// One block of 256 threads per (64 query rows, head, batch row), the threads
// as 16 x 16: thread (ty, tx) owns query rows ty + 16 i (i < 4). The Q tile
// stays in shared memory for the whole loop; each step stages a tile of 64
// keys of K and V (rows padded by 4 floats, so that the 16-byte reads below
// fall on distinct banks), and
//  - S = Q K^T: the thread's 4 x 4 scores of columns tx + 16 j, both operands
//    read as float4 along the head dim;
//  - the online softmax in base 2 on registers, the row maximum taken over
//    the 16 lanes that share a row; the probabilities go to shared memory in
//    fp32;
//  - O += P V: the same rows, D / 16 output columns a thread, P read back as
//    float4 along the keys (the 16 lanes of a row sit in one warp, so a warp
//    barrier is enough between the write and the read).
// Loads are not overlapped with the products inside a block; the two or three
// blocks an SM holds overlap each other.

namespace f32 {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int NTHREADS = 256;
constexpr int RI = BQ / 16; // rows a thread owns
constexpr int CJ = BK / 16; // score columns a thread owns
constexpr int LDP = BK + 4; // padded row of the probability tile

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * LDP) * static_cast<int>(sizeof(float));
}

template <int VEC>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x, dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// rows [row0, row0 + 64) of a (rows, D) view with row stride `stride` into a
// padded shared-memory tile; rows from `rows` on arrive as zeros
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long stride,
                                           int row0, int rows) {
  constexpr int LD = D + 4, CH = D / 4;
  for (int c = threadIdx.x; c < 64 * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<float4*>(dst + r * LD + col) = val;
  }
}

__device__ __forceinline__ float row_max16(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
}

__device__ __forceinline__ float row_sum16(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x + __shfl_xor_sync(0xffffffffu, x, 8);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
pn_flash_f32_fwd(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_lens, int heads, int sq, int skv, int q_tiles,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, float scale_log2) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;            // output columns a thread owns
  constexpr int VEC = DC >= 4 ? 4 : DC; // in chunks of VEC: columns (c 16 + tx) VEC + e
  constexpr int NC = DC / VEC;
  extern __shared__ float4 smem_f32[];
  float* qs = reinterpret_cast<float*>(smem_f32);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;

  // blockIdx.x = (batch * heads + head) * q_tiles + q tile, as pn_flash_fwd
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  stage_tile<D>(qs, qb, q_ss, qt * BQ, sq);

  float acc[RI][DC];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (row_len + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K and V tiles
    stage_tile<D>(ks, kb, k_ss, kv0, skv);
    stage_tile<D>(vs, vb, v_ss, kv0, skv);
    __syncthreads();

    // S = Q K^T, rows ty + 16 i, columns tx + 16 j
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax in the log2 domain; the probabilities go to shared memory
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = kv0 + tx + 16 * j < row_len ? s[i][j] * scale_log2 : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      const float corr = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = exp2f(s[i][j] - mn);
        sum += p;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's 16 lanes are in this warp

    // O += P V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pv[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) load_vec<4>(pv[i], ps + (ty + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          load_vec<VEC>(vv + c * VEC, vs + (j + jj) * LD + (c * 16 + tx) * VEC);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i][jj], vv[c], acc[i][c]);
      }
    }
    __syncwarp();  // the probabilities are read before the next tile's are written
  }

  // the output, (B, Sq, H, D) contiguous, written once; rows past Sq never
  float* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
  const long long o_ss = static_cast<long long>(heads) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = qt * BQ + ty + 16 * i;
    const float sum = row_sum16(l[i]), inv = 1.f / sum;
    if (lse && tx == 0 && row < sq) lse[static_cast<long long>(bh) * sq + row] = m[i] + log2f(sum);
    if (row < sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= inv;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        store_vec<VEC>(ob + row * o_ss + (c * 16 + tx) * VEC, acc[i] + c * VEC);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* st, float scale_log2,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pn_flash_f32_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int q_tiles = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  pn_flash_f32_fwd<D><<<static_cast<unsigned>(blocks), NTHREADS, smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lens), heads,
      sq, skv, q_tiles, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ------------------------------------------- fp32 on the tensor cores, D = 64
//
// The same function as f32, for the production head dim, with both products
// on the tensor cores as 3xTF32 (pn::tf32_split: each operand a big and a
// small TF32 part, the three larger of the four products summed), which
// keeps fp32 accuracy. Bound: 3 x 4 B H Sq Skv D flops at the TF32 rate, 2.5
// times below the FMA bound of f32; at level 2 (Sq 128) the bytes bound it.
// The shared pieces (the splits, product_nt, product_rs, to_a) are those of
// the fp32 backward's tc passes, in flash_f32_tc.cuh.
//
// One block of two warpgroups (256 threads, no producer warp: one costs the
// consumers registers, and these use 231) per (128 query rows, head, batch
// row); warpgroup g owns rows 64 g .. 64 g + 63, and both walk every key
// tile below the row's kv_len, so each K and V tile is loaded, split and
// transposed once for 128 queries (half the L2 traffic and split work per
// query of a 64-row block, and no merge of two warpgroups' partial sums).
//  - Loads: thread 0 issues TMA loads (4-D fp32 maps of the strided views,
//    32 x 32 boxes, 128-byte swizzle): the Q tile once; the 32-key tiles of
//    K and V into a ring of STAGES slots, a slot refilled at the first block
//    barrier after every thread has waited for its tile's P V.
//  - Q: each thread splits its A operands of S = Q K^T into registers once
//    (load_a), so the product reads only K from shared memory.
//  - Split: all eight warps split each arrived tile, K in place with its
//    small part beside (K-major, as S = Q K^T takes it), V into transposed
//    big and small copies (64 rows of d, keys permuted by perm_col), since
//    TF32 wgmma takes B K-major and P V contracts over the keys; one block
//    barrier a tile makes the split visible to both warpgroups.
//  - Products: S (64 x 32) = Q K^T is wgmma m64n32k8 in S_SETS accumulator
//    sets; P, in registers, is split into the register A operands (to_a) of
//    P V, m64n64k8 against the V^T copies, each tile's into a fresh
//    accumulator set: the tensor cores' adder truncates, so the
//    threads fold each set into the running output in fp32, rounded to
//    nearest, O = O corr + set, the step the online softmax takes anyway.
//  - Overlap: tile j-1's P V runs under the barrier before tile j, its fold
//    and tile j+1's split under tile j's Q K^T; the two warpgroups'
//    products and exponentials interleave on the SM.
//  - Masks select the exponent's argument (-inf) past the row's kv_len; an
//    empty row takes all Skv keys at scale 0 (pn::row_keys, row_scale); rows
//    and keys past Sq and Skv arrive as TMA's zeros; rows past Sq are not
//    written.

namespace tc {

// T, NTHREADS, PANEL and the shared device functions: flash_f32_tc.cuh
using namespace pn::tc;

constexpr int D = 64;
constexpr int TILE = T * D;  // floats of a streamed tile, and of a transposed one
constexpr int BQ = 128;     // query rows per block: two warpgroups x 64
constexpr int STAGES = 4;   // slots of the key ring
constexpr int S_SETS = 1;   // accumulator sets of S over the 64 channels

struct Smem {
  float q[BQ * D];  // Q as loaded; each thread splits its A operands into registers
  struct Slot {
    float k[TILE];      // K as loaded, split in place into K_big
    float k_small[TILE];
    float v[TILE];      // V as loaded
    float vt[2][TILE];  // V^T big and small: 64 rows of d, keys permuted by perm_col
  } slot[STAGES];
  uint64_t q_full;
  uint64_t full[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + pn::SWIZZLE_ATOM;  // room to align
static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");

__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_f32_fwd_tc(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                    float* __restrict__ lse, const int* __restrict__ kv_lens, int heads, int sq,
                    int skv, int q_tiles, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(pn::align_smem(smem_raw));

  // blockIdx.x = (batch * heads + head) * q_tiles + query tile, as pn_flash_fwd
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int n_tiles = (row_len + T - 1) / T;
  const int group = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  auto load = [&](int j) {  // key tile j into its slot (by thread 0)
    const int s = j % STAGES;
    pn::mbar_arrive_expect_tx(&sm.full[s], 2 * TILE * 4);
    load_rows<D>(sm.slot[s].k, T, &k_map, &sm.full[s], h, j * T, b);
    load_rows<D>(sm.slot[s].v, T, &v_map, &sm.full[s], h, j * T, b);
  };
  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) pn::mbar_init(&sm.full[s], 1);
    pn::mbar_init_fence();
    pn::mbar_arrive_expect_tx(&sm.q_full, BQ * D * 4);
    load_rows<D>(sm.q, BQ, &q_map, &sm.q_full, h, qt * BQ, b);
    for (int j = 0; j < min(STAGES, n_tiles); ++j) load(j);
  }
  __syncthreads();
  // this warpgroup's 64 query rows of the Q tile as the A operands of
  // S = Q K^T, split into their big and small TF32 parts, held in registers
  uint32_t qa_big[D / 8][4], qa_small[D / 8][4];
  pn::mbar_wait(&sm.q_full, 0);
  load_a(sm.q, BQ, group * 64, warp, lane, qa_big, qa_small);

  // key tile j, once arrived, split by all eight warps; a block barrier
  // before its first product makes the split visible to both warpgroups
  auto split = [&](int j) {
    Smem::Slot& sl = sm.slot[j % STAGES];
    pn::mbar_wait(&sm.full[j % STAGES], (j / STAGES) & 1);
    split_tile<D, T, false, true, 8>(sl.k, sl.k_small, nullptr, nullptr, threadIdx.x >> 5, lane);
    split_tile<D, T, true, false, 8>(sl.v, nullptr, sl.vt[0], sl.vt[1], threadIdx.x >> 5, lane);
    pn::tma_store_fence();  // the writes are seen by wgmma (the async proxy)
  };

  float s_sets[S_SETS][16], acc[32], o_sum[32];
  uint32_t p_big[4][4], p_small[4][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_sum[i] = 0.f;

  auto start_s = [&](int j) {  // S = Q K^T of tile j, one committed group
    const Smem::Slot& sl = sm.slot[j % STAGES];
    pn::wgmma_fence();
    product_nt_rs(s_sets, qa_big, qa_small, pn::smem_u32(sl.k), pn::smem_u32(sl.k_small),
                  T * pn::SWIZZLE_BYTES);
    pn::wgmma_commit();
  };
  auto start_pv = [&](int j) {  // acc = P V of tile j, a fresh set, one committed group
    const Smem::Slot& sl = sm.slot[j % STAGES];
    pn::wgmma_fence();
    product_rs(acc, p_big, p_small, pn::smem_u32(sl.vt[0]), pn::smem_u32(sl.vt[1]));
    pn::wgmma_commit();
  };
  // the online softmax of tile j on this thread's rows g, g + 8 of its
  // warp's 16 (score i: row g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t +
  // i % 2), in base 2; corr becomes the factor of the sums so far, and the
  // probabilities, as A operands, are the tile's P V
  auto softmax = [&](int j) {
    pn::pin(s_sets);
    float s[16];
    sum_sets(s, s_sets);
    const int limit = row_len - j * T;
    float mx[2] = {NEG, NEG}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = (i >> 2) * 8 + t * 2 + (i & 1);
      s[i] = col < limit ? s[i] * scale_log2 : neg_inf();
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = wg::ex2(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[i] = wg::ex2(s[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
    to_a(s, p_big, p_small);
  };
  auto fold = [&]() {  // the finished P V set into the running output
    pn::pin(acc);
    pn::pin(p_big);
    pn::pin(p_small);
#pragma unroll
    for (int i = 0; i < 32; ++i) o_sum[i] = o_sum[i] * corr[(i >> 1) & 1] + acc[i];
  };

  split(0);
  __syncthreads();
  start_s(0);
  if (n_tiles > 1) split(1);  // under tile 0's Q K^T
  pn::wgmma_wait<0>();
  softmax(0);
  start_pv(0);
  for (int j = 1; j < n_tiles; ++j) {
    // tile j is split, and every thread is done with tile j-2's slot (its
    // P V was waited for): the slot takes tile j + 2
    __syncthreads();
    if (threadIdx.x == 0 && j >= 2 && j + 2 < n_tiles) load(j + 2);
    __syncwarp();
    start_s(j);
    pn::wgmma_wait<1>();  // tile j-1's P V is done; tile j's Q K^T runs on
    fold();
    if (j + 1 < n_tiles) split(j + 1);  // under tile j's Q K^T
    pn::wgmma_wait<0>();
    softmax(j);
    start_pv(j);
  }
  pn::wgmma_wait<0>();
  fold();

  // the output, (B, Sq, H, D) contiguous, written once; rows past Sq never
  const int row0 = qt * BQ + group * 64 + warp * 16 + g;
  float* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
  const long long o_ss = static_cast<long long>(heads) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    const int row = row0 + 8 * r;
    if (row < sq) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(ob + row * o_ss + n * 8 + t * 2) =
            make_float2(o_sum[n * 4 + r * 2] * inv, o_sum[n * 4 + r * 2 + 1] * inv);
      if (lse && t == 0) lse[static_cast<long long>(bh) * sq + row] = m[r] + log2f(l[r]);
    }
  }
}

// maps: three specs of 12 values (dims, byte strides, boxes of the 4-D fp32
// views of q, k and v with 32 x 32 boxes, innermost first), as
// pn::encode_map takes them
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* maps, float scale_log2,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pn_flash_f32_fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int err = pn::encode_map(&q_map, q, 4, maps, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (!err) err = pn::encode_map(&k_map, k, 4, maps + 12, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (!err) err = pn::encode_map(&v_map, v, 4, maps + 24, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err) return err;
  const int q_tiles = (sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  pn_flash_f32_fwd_tc<<<static_cast<unsigned>(blocks), NTHREADS, SMEM_BYTES, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_lens), heads, sq, skv, q_tiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------- fp32 on the tensor cores, D = 32
//
// The same function as tc at head dim 32, the perception self-attention's
// (SparseHead: B 1 or 2, Sq 900, Skv 1668, H 8). Its arithmetic is tc's:
// 3xTF32 wgmma with each warpgroup's Q operands split into registers once;
// the online softmax in base 2 with fp32 statistics; each key tile's P V in
// a fresh accumulator set folded into the running output in rounded fp32
// (the tensor cores' adder truncates); the kv_lens mask, an empty row's
// Skv keys at scale 0, and lse for the backward. Bound: 3 x 4 B H Sq Skv D
// flops at the TF32 rate (0.0093 ms at B 1 on an H100 SXM); the bytes take
// a sixth of that. At D 32 a score costs half the tensor-core work it costs
// at D 64 but the same softmax and P split, so the CUDA cores' share of
// each tile is twice tc's. What differs from tc, and why:
//  - Tiles: a row of D 32 is one 128-byte swizzled panel. A tile of KT 32
//    keys: S = Q K^T is m64n32k8 x 4 k-steps, P V m64n32k8 x 4 against the
//    V^T copy (32 rows of d). 64-key tiles measured slower: their two S
//    sets, P operands and the rest take 239 registers, and ptxas serialises
//    the wgmma (C7512).
//  - Pipeline: tile j + 1's Q K^T is started before tile j's softmax, in a
//    second accumulator set, so the exponentials and the P split of one
//    tile run under the products of the next; tile j's P V, tile j + 2's
//    split and tile j + 3's load follow, in a ring of STAGES slots (tiles
//    j - 1 .. j + 3).
//  - Filling the card: at B 1 the 128-row blocks (900 queries x 8 heads)
//    number 64, half of the H100's 132 SMs. Where twice the blocks still
//    fit one wave (key_split), the launch pairs the blocks of a query tile
//    as a cluster of two that splits the row's keys (key_begin: whole
//    tiles, block 0 no more of them than block 1; both, and the block
//    order, in flash_f32_tc32_schedule.h, which the CPU tests build with a
//    host compiler). Each block keeps its own
//    running max, sum and output; block 1 hands them to block 0 through
//    distributed shared memory, and block 0 merges them and stores once.
//    Otherwise (B 2: 128 blocks) a block walks all the row's keys.
//  - Loads: every thread copies its share of a tile from the strides into
//    the swizzled layout with cp.async (zero-filled past Sq and Skv), each
//    thread's copies arriving on the slot's mbarrier when they land, so the
//    host passes strides and encodes no tensor map (the perception head is
//    bound by host time).
//  - The split of each tile by all eight warps and the output are tc's;
//    the mask is applied on a part's last tile only.
// What holds it below the bound is instruction issue, not the tensor cores:
// a 32-key tile costs each thread about 560 instructions (the softmax, the
// P split, the K and V split, the wgmma descriptors), more issue slots on
// the SM's four schedulers than the tile's products take on the tensor
// cores (scripts/compare_sass.py counts them; PERF.md has the times).

namespace tc32 {

// T, NTHREADS, PANEL and the shared device functions: flash_f32_tc.cuh;
// BQ, KT, SPLIT, key_split, key_begin and block_of: flash_f32_tc32_schedule.h
using namespace pn::tc;
using namespace pn::tc32_schedule;

constexpr int D = 32;
constexpr int STAGES = 5;      // slots of the key ring
constexpr int KTILE = KT * D;  // floats of a key tile, and of a transposed one

struct Smem {
  float q[BQ * D];  // Q as loaded; each thread splits its A operands into registers
  struct Slot {
    float k[KTILE];      // K as loaded, split in place into K_big
    float k_small[KTILE];
    float v[KTILE];      // V as loaded
    float vt[2][KTILE];  // V^T big and small: KT / 32 panels of D rows, keys permuted by perm_col
  } slot[STAGES];
  uint64_t q_full;
  uint64_t full[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + pn::SWIZZLE_ATOM;  // room to align
static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
// block 1's running max, sum and output (D / 2 + 4 values a thread) go to
// block 0 through the slots
static_assert(sizeof(Smem::slot) >= (D / 2 + 4) * NTHREADS * 4, "the slots hold the hand-over");

__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_f32_fwd_tc32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ kv_lens, int heads,
                      int sq, int skv, int q_tiles, int split, long long q_sb, long long q_ss,
                      long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(pn::align_smem(smem_raw));

  // the `split` blocks of a query tile are one cluster, part its rank
  const Block blk = block_of(blockIdx.x, heads, q_tiles, split);
  const int b = blk.b, h = blk.h, qt = blk.qt, part = blk.part, bh = b * heads + h;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int key0 = key_begin(row_len, part, split), key1 = key_begin(row_len, part + 1, split);
  const int n_tiles = (key1 - key0 + KT - 1) / KT;
  const int group = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.q_full, NTHREADS);
    for (int s = 0; s < STAGES; ++s) pn::mbar_init(&sm.full[s], NTHREADS);
    pn::mbar_init_fence();
  }
  __syncthreads();

  float o_sum[D / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_sum[i] = 0.f;

  if (n_tiles > 0) {  // a part with no key (a row of one key) keeps m, l and o_sum
    auto load = [&](int j) {  // key tile j into its slot, by every thread
      Smem::Slot& sl = sm.slot[j % STAGES];
      load_async<KT>(sl.k, kb, k_ss, key0 + j * KT, skv, threadIdx.x);
      load_async<KT>(sl.v, vb, v_ss, key0 + j * KT, skv, threadIdx.x);
      pn::cp_async_arrive(&sm.full[j % STAGES]);
    };
    load_async<BQ>(sm.q, q + b * q_sb + h * q_sh, q_ss, qt * BQ, sq, threadIdx.x);
    pn::cp_async_arrive(&sm.q_full);
    for (int j = 0; j < min(STAGES - 1, n_tiles); ++j) load(j);
    // this warpgroup's 64 query rows of the Q tile as the A operands of
    // S = Q K^T, split into their big and small TF32 parts, held in registers
    uint32_t qa_big[D / 8][4], qa_small[D / 8][4];
    pn::mbar_wait(&sm.q_full, 0);
    load_a(sm.q, BQ, group * 64, warp, lane, qa_big, qa_small);

    // key tile j, once arrived, split by all eight warps; a block barrier
    // before its first product makes the split visible to both warpgroups
    auto split_kv = [&](int j) {
      Smem::Slot& sl = sm.slot[j % STAGES];
      pn::mbar_wait(&sm.full[j % STAGES], (j / STAGES) & 1);
      split_tile<D, KT, false, true, 8>(sl.k, sl.k_small, nullptr, nullptr, threadIdx.x >> 5,
                                        lane);
      split_tile<D, KT, true, false, 8>(sl.v, nullptr, sl.vt[0], sl.vt[1], threadIdx.x >> 5,
                                        lane);
      pn::tma_store_fence();  // the writes are seen by wgmma (the async proxy)
    };

    // S of tiles j and j + 1 in flight together: two accumulator sets,
    // s_even for the even tiles and s_odd for the odd ones
    float s_even[1][KT / 2], s_odd[1][KT / 2], acc[D / 2], corr[2];
    uint32_t p_big[KT / 8][4], p_small[KT / 8][4];

    auto start_s = [&](int j, float(&s_sets)[1][KT / 2]) {  // S = Q K^T of tile j, one group
      const Smem::Slot& sl = sm.slot[j % STAGES];
      pn::wgmma_fence();
      product_nt_rs(s_sets, qa_big, qa_small, pn::smem_u32(sl.k), pn::smem_u32(sl.k_small),
                    KT * pn::SWIZZLE_BYTES);
      pn::wgmma_commit();
    };
    auto start_pv = [&](int j) {  // acc = P V of tile j, a fresh set, one committed group
      const Smem::Slot& sl = sm.slot[j % STAGES];
      pn::wgmma_fence();
      product_rs(acc, p_big, p_small, pn::smem_u32(sl.vt[0]), pn::smem_u32(sl.vt[1]));
      pn::wgmma_commit();
    };
    // the online softmax of tile j on this thread's rows g, g + 8 of its
    // warp's 16 (score i: row g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t +
    // i % 2), in base 2; corr becomes the factor of the sums so far, and
    // the probabilities, as A operands, are the tile's P V
    auto softmax = [&](int j, float(&s_sets)[1][KT / 2]) {
      pn::pin(s_sets);
      float s[KT / 2];
      sum_sets(s, s_sets);
      const int limit = key1 - key0 - j * KT;
      float mx[2] = {NEG, NEG}, sum[2] = {0.f, 0.f};
      if (limit < KT) {  // the part's last tile: keys from `limit` on are masked
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int col = (i >> 2) * 8 + t * 2 + (i & 1);
          s[i] = col < limit ? s[i] * scale_log2 : neg_inf();
        }
      } else {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) s[i] *= scale_log2;
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        corr[r] = wg::ex2(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        s[i] = wg::ex2(s[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];
      to_a(s, p_big, p_small);
    };
    auto fold = [&]() {  // the finished P V set into the running output
      pn::pin(acc);
      pn::pin(p_big);
      pn::pin(p_small);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_sum[i] = o_sum[i] * corr[(i >> 1) & 1] + acc[i];
    };
    // one tile of the pipeline: tile j + 1's Q K^T is started before tile
    // j's softmax, so the exponentials of one tile run under the products of
    // the next; `mine` holds tile j's S, `next` takes tile j + 1's
    auto step = [&](int j, float(&mine)[1][KT / 2], float(&next)[1][KT / 2]) {
      // tile j + 1 is split, and every thread is done with tile j-2's slot
      // (its P V was waited for): the slot takes tile j + 3
      __syncthreads();
      if (j >= 1 && j + 3 < n_tiles) load(j + 3);
      if (j + 1 < n_tiles) {
        start_s(j + 1, next);
        pn::wgmma_wait<1>();  // tile j's Q K^T and tile j-1's P V are done
      } else {
        pn::wgmma_wait<0>();
      }
      if (j >= 1) fold();
      if (j + 2 < n_tiles) split_kv(j + 2);  // under tile j + 1's Q K^T
      softmax(j, mine);
      start_pv(j);
    };

    split_kv(0);
    __syncthreads();
    start_s(0, s_even);
    if (n_tiles > 1) split_kv(1);  // under tile 0's Q K^T
    for (int j = 0; j < n_tiles; j += 2) {
      step(j, s_even, s_odd);
      if (j + 1 < n_tiles) step(j + 1, s_odd, s_even);
    }
    pn::wgmma_wait<0>();
    fold();
  }

  if (split > 1) {
    // block 1's running max, sums and output go to block 0 through block
    // 1's slots (free once both its warpgroups are done); block 0 merges
    // them into its own: m = max(m0, m1), each part's sums times
    // exp2(m_part - m), the part with no key weighing 0
    float* red = sm.slot[0].k;
    __syncthreads();
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) red[i * NTHREADS + threadIdx.x] = o_sum[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red[(D / 2 + r) * NTHREADS + threadIdx.x] = m[r];
        red[(D / 2 + 2 + r) * NTHREADS + threadIdx.x] = l[r];
      }
    }
    pn::cluster_sync();
    if (part == 0) {
      const uint32_t peer = pn::cluster_map(pn::smem_u32(red + threadIdx.x), 1);
      float w0[2], w1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = pn::cluster_load(peer + (D / 2 + r) * NTHREADS * 4);
        const float l1 = pn::cluster_load(peer + (D / 2 + 2 + r) * NTHREADS * 4);
        const float mn = fmaxf(m[r], m1);
        w0[r] = wg::ex2(m[r] - mn);
        w1[r] = wg::ex2(m1 - mn);
        l[r] = l[r] * w0[r] + l1 * w1[r];
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o_sum[i] = o_sum[i] * w0[(i >> 1) & 1] +
                   pn::cluster_load(peer + i * NTHREADS * 4) * w1[(i >> 1) & 1];
    }
    pn::cluster_sync();  // block 1's shared memory stays until block 0 has read it
    if (part != 0) return;
  }

  // the output, (B, Sq, H, D) contiguous, written once; rows past Sq never
  const int row0 = qt * BQ + group * 64 + warp * 16 + g;
  float* ob = o + (static_cast<long long>(b) * sq * heads + h) * D;
  const long long o_ss = static_cast<long long>(heads) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    const int row = row0 + 8 * r;
    if (row < sq) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(ob + row * o_ss + n * 8 + t * 2) =
            make_float2(o_sum[n * 4 + r * 2] * inv, o_sum[n * 4 + r * 2 + 1] * inv);
      if (lse && t == 0) lse[static_cast<long long>(bh) * sq + row] = m[r] + log2f(l[r]);
    }
  }
}

// st: the strides of q, k and v as the C entry takes them. The blocks of a
// query tile form a cluster of key_split(...) blocks.
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* st, float scale_log2,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pn_flash_f32_fwd_tc32, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (sq + BQ - 1) / BQ;
  const long long tiles = static_cast<long long>(batch) * heads * q_tiles;
  const int split = key_split(tiles, sms);
  if (tiles < 1 || tiles * split > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * split));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pn_flash_f32_fwd_tc32, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<float*>(o), static_cast<float*>(lse),
                           static_cast<const int*>(kv_lens), heads, sq, skv, q_tiles, split,
                           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                           scale_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc32

}  // namespace

// strides: {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h} in elements; the
// head-dim stride is 1 (the bf16 kernels read through the tensor maps; the
// strides serve the fp32 entry's kernels). kv_lens: (B,) int32 on the
// device, or null. lse: (B, H, Sq) fp32 for the row log-sum-exp, or null.
// maps: the tensor-map specs of q, k and v (see wg::launch).
// Returns a cudaError_t value: of the set-up, or cudaGetLastError() after
// the launch.
extern "C" int pn_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, const void* kv_lens, int batch, int heads, int sq,
                                       int skv, int d, const long long* strides,
                                       const long long* maps, float scale, void* stream) {
  (void)strides;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wg::launch<16>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, maps, scale_log2, s);
    case 32: return wg::launch<32>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, maps, scale_log2, s);
    case 64: return wg::launch<64>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, maps, scale_log2, s);
    case 128: return wg::launch<128>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, maps, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 entry: the same arguments; q, k, v and o are fp32, strides in
// elements of fp32 (multiples of 4, 16 bytes); lse as above. maps: the
// tensor-map specs of tc::launch, used at d = 64 (null otherwise).
extern "C" int pn_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      void* lse, const void* kv_lens, int batch, int heads, int sq,
                                      int skv, int d, const long long* strides,
                                      const long long* maps, float scale, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return tc::launch(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, maps, scale_log2, s);
    case 16: return f32::launch<16>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, strides, scale_log2, s);
    case 32: return tc32::launch(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, strides, scale_log2, s);
    case 128: return f32::launch<128>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, strides, scale_log2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
