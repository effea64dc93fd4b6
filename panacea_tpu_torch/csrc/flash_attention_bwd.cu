// Flash attention backward for Hopper (sm_90a): dq, dk, dv of
// softmax(q k^T * scale) v, in the operands' type: bf16 on the tensor cores
// (fp32 accumulation), or fp32: 3xTF32 on the tensor cores at head dims 64
// and 32, the FMA units at 16 and 128.
//
// The gradient of the Pallas TPU kernel panacea_tpu/ops/flash_attention.py
// (_flash_kernel, :33-86; its pallas_call in flash_attention, :236). That
// kernel has no custom VJP: the JAX trainer differentiates its plain form
// (_lax_flash, :108-163), so this computes the gradient of the same math,
// softmax(q k^T * scale) v with the key tail masked per batch row by kv_lens:
//   P = exp2(S * scale * log2(e) - lse)      from the forward's row lse
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),  Delta = rowsum(dO * O)
//   dQ = scale dS K,  dK = scale dS^T Q
// q, k and v are read in place through their strides (the halves of the
// merged kv projection need no copy); o, dO, dq, dk and dv are (B, S, H, D)
// contiguous; lse and Delta are fp32 (B, H, Sq).
//
// What bounds it on the H100: five products of 2 B H Sq Skv D flops each (S
// and dP recomputed, dV, dK and dQ), 10 B H Sq Skv D in all, against
// 2 B H D (4 Sq + 4 Skv) bytes (q, o, dO and dq; k, v, dk and dv, bf16): at
// the main path's shapes (Skv = 2 Sq, D = 64) 0.83 Sq flops per byte, above
// the card's ~295 flop/byte ridge at levels 0 and 1 (Sq 2048, 512), below it
// at level 2 (Sq 128). In fp32 each product is three TF32 products (495
// TFLOP/s), 6 times the bf16 bound and far above the time to move the bytes;
// on the FMA units (67 TFLOP/s) 15 times.
//
// Every route keeps FA2's deterministic form, with no atomics: Delta in a
// pre-pass, dk and dv from blocks over key tiles, dq from blocks over query
// tiles (S and dP are computed in both passes), so the same inputs give the
// same bits. Four routes, chosen by the wrapper (ops/flash_attention.py) by
// type and head dim:
//
// wg (bf16, every head dim: 16, 32, 64, 128): TMA + wgmma, two passes.
// The two passes cost 14 B H Sq Skv D flops, not 10; a single pass would
// need atomics or an ordered accumulation of dq across key blocks, and the
// 40 % more tensor-core work is the price of staying deterministic simply.
// A block is two consumer warpgroups (256 threads) and no producer warp:
// with 8 warps an SM sub-partition holds two of a block's warps, so ptxas
// gives every thread up to 255 registers; a ninth warp, or a producer
// warpgroup with setmaxnreg, held the consumers' code to 168 and spilled.
// Thread 0 issues the TMA loads (4-D tensor maps, each row swizzled by its
// width: 32, 64 or 128 bytes at D 16, 32, 64, two 128-byte panels at D 128;
// mbarriers) and refills a ring slot LAG tiles after it was consumed, once
// both warpgroups have released it (LAG >= 2: a warpgroup releases tile j-1
// late in iteration j). The tiles per head dim are in flash_bf16_schedule.h.
//  - dK/dV pass: one block per (128 keys, head, batch row); K and V are
//    loaded once and stay resident; 64-row tiles of Q and dO stream through
//    a 5-slot ring (4 at D 128, where a thread holds 255 registers: dK and
//    dV 128, S^T and dP^T 64, P^T and dS^T 32; 32-row tiles held 210 but
//    ran the pass a third longer). Each warpgroup owns 64 keys:
//    S^T = K Q^T and dP^T = V dO^T are wgmma
//    m64n64k16 with both operands in shared memory, K-major; P^T and dS^T
//    are formed in registers (the accumulator layout) from the tile's lse
//    (+inf for rows past Sq, so their P is 0) and Delta, which each
//    warpgroup stages in shared memory a tile ahead; rounded to bf16 they
//    are the register A operands of dV += P^T dO and dK += dS^T Q, which
//    read dO and Q MN-major as TMA laid them down. Tile j's S^T and dP^T are
//    issued before tile j-1's dV and dK products, so the exponentials of
//    tile j run while those are in flight, and the two warpgroups run
//    unsynchronised.
//  - dQ pass: one block per (128 query rows, head, batch row), Q and dO
//    resident; K and V stream in KT-key tiles through a 4-slot ring (KT 128;
//    64 at D 128, where two 128-key tiles would not fit beside Q and dO).
//    S = Q K^T and dP = dO V^T are m64nKTk16 from shared memory; dS stays in
//    registers and feeds dQ += dS K (K read MN-major); tile j's S and dP are
//    issued before tile j-1's dQ product. Only the key tiles below kv_len
//    are visited, the last one masked in registers. The k and v maps' boxes
//    are KT keys: the dK/dV pass loads its 128 resident keys as 128 / KT
//    boxes.
//  - D 16 and 32: a score costs 14 D tensor-core flops over the two passes
//    and two exponentials, and an SM computes 1,024 bf16 flops but 16
//    exponentials a clock, so the exponentials bound them on paper; in the
//    loops the issue slots bound them first (a D 16 dK/dV tile: about 450
//    instructions a warp against 32 exponentials, 256 clocks of the
//    special-function unit), so no exponential moves to the FMA units here.
//  - Masks select the exponent's argument (-inf), never the result: a
//    per-thread branch around the exponential, beside thread 0's refill
//    path, makes ptxas serialise the products (advisory C7520). For the same
//    reason a dK/dV block whose keys all lie past kv_len does not return
//    early: it streams one tile with every key masked and writes zeros.
//
// tc (fp32, D = 64, the production head dim): the five products on the
// tensor cores as 3xTF32 (pn::tf32_split: each operand a big and a small
// TF32 part, the three larger of the four products summed), which keeps fp32
// accuracy, with TMA loads (fp32 tensor maps, 128-byte swizzle) and two
// passes, as wg. Bound: 3 x 14 B H Sq Skv D flops at the TF32 rate.
//  - TF32 wgmma takes both shared-memory operands K-major. S^T = K Q^T,
//    dP^T = V dO^T, S and dP are K-major as loaded; dV = P^T dO, dK = dS^T Q
//    and dQ = dS K contract over the tile rows, so the consumers write
//    transposed split copies of dO, Q and K (64 rows of d) while they split
//    each tile. P^T, dS^T and dS are the register A operands; a TF32 k8 A
//    fragment holds columns t and t + 4 where the accumulator holds 2t and
//    2t + 1, so the transposed copies permute the rows within each 8 to match
//    (perm_col) instead of shuffling registers.
//  - The tensor cores' adder truncates: each 16 channels of S and dP go to a
//    fresh accumulator set (one set over all 64 left dk of a row with one
//    valid key, where dS = P (dP - Delta) is rounding noise, at 1.8 times
//    the rule), and each 32-row tile's dV, dK and dQ to a fresh set; the
//    threads add the sets to fp32 sums rounded to nearest.
//  - dK/dV pass: one block per (64 keys, head, batch row), K and V resident
//    and split; two warpgroups, each with its own 2-slot ring of 32-row Q and
//    dO tiles (its thread 0 issues the loads), take the query tiles in turn
//    and own all 64 keys (m64n32 products for S^T and dP^T, m64n64 for dV and
//    dK); warpgroup 1's sums reach warpgroup 0 through shared memory at the
//    end, added in a fixed order. dQ pass: the same per (64 query rows, head,
//    batch row) over the 32-key tiles below kv_len. No atomics: the same
//    inputs give the same bits.
//
// tc32 (fp32, D = 32, the perception self-attention's: SparseHead's grad
// frame without DN, B 2, Sq 900, Skv 1668, H 8): tc's arithmetic and two
// passes at head dim 32. Bound: 3 x 14 B H Sq Skv D flops at the TF32 rate
// for the two passes (0.065 ms at that shape on an H100 SXM); the bytes take
// a tenth of that. What differs from tc, and why:
//  - A row of D 32 is one 128-byte swizzled panel: S^T, dP^T, S and dP are
//    m64n32k8 x 4 k-steps, dV, dK and dQ m64n32k8 x 4 (32 rows a tile)
//    against the transposed copies (D rows of 32), whose sums are 16
//    registers a thread. The descriptors of a tile are made once
//    (desc_lo): a k-step only moves their low word.
//  - S goes to one accumulator set; dP to four of 8 channels (one k-step's
//    three products each) in the dK/dV pass: in a row with one valid key
//    dP equals Delta, so dS = P (dP - Delta) is the noise of dP, and over
//    Sq 900 rows that key's dk read 1.30 of FLASH_BWD_F32 against float64
//    with sets of 16 (the fp32 plain version 0.73; the model of the adder in
//    the CPU tests 1.21, and 0.80 with sets of 8). The dQ pass keeps sets of
//    16: a row's dq takes that noise from its one key, not summed over Sq
//    rows, and fewer sets cost fewer additions.
//  - dK/dV pass: one block per (64 keys, head, batch row) of one warpgroup,
//    two blocks an SM (228 registers), two ring slots (three ran 5 to 8 %
//    slower, PERF.md section 6); K and V are loaded once and held
//    split in registers as the A operands of S^T = K Q^T and dP^T = V dO^T,
//    so those products read only Q and dO from shared memory. Blocks of two
//    warpgroups that take the query tiles in turn started them in step and
//    ran 7 to 12 % slower (PERF.md, section 6). Each query tile's lse and
//    Delta arrive in shared memory with its Q and dO (cp.async of 4 bytes:
//    a row's start need not be 16-byte aligned).
//  - dQ pass: one block per (64 query rows, head, batch row) of two
//    warpgroups that take the 32-key tiles below kv_len in turn and add
//    their sums at the end (in that order), two blocks an SM: 480
//    warpgroups at B 2 instead of 240 of one. It follows the dK/dV pass on
//    the caller's stream.
//  - Loads: each warpgroup's 128 threads copy its tiles from the strides
//    into the swizzled layout with cp.async (zero-filled past Sq and Skv),
//    each thread's copies arriving on the slot's mbarrier when they land;
//    the resident tiles by every thread. The host passes strides and
//    encodes no tensor map: the perception step is bound by host time.
//  - The block and tile arithmetic is in flash_f32_tc32_bwd_schedule.h,
//    which the CPU tests build with a host compiler.
// What holds it at a quarter of its bound: issue slots and latency, as the
// forward at head dim 32. scripts/compare_sass.py counts about 850
// instructions a thread for a 32-query tile of the dK/dV pass (48 wgmma,
// 768 tensor-core clocks), and two warpgroups an SM do not hide each
// other's waits; PERF.md has the times.
//
// f32 (fp32, D = 16, 128): the layout of the fp32 forward
// (pn_flash_f32_fwd): 64 x 64 tiles, 256 threads as 16 x 16, each owning a
// 4 x 4 tile of scores, rows padded by 4 floats so that the 16-byte reads
// fall on distinct banks. No tensor cores, no TF32, no bf16 anywhere; P and
// dS pass through shared memory in fp32 between the products. No user path
// calls these head dims.
//
// Masking, the same in every route: a padded query row (past Sq) has lse =
// +inf, so P = exp2(x - inf) = 0 whatever its zero-filled operands give; a
// key past the row's kv_len gets P = 0, so its dK and dV are exactly 0. A
// row with kv_lens 0 attends to all Skv keys at scale 0 (pn::row_keys): P =
// exp2(0 - lse) = 1 / Skv gives the reference's dv = sum over queries of
// dO / Skv, and dq and dk, scaled by 0, are exactly 0.

#include "hopper.cuh"
#include "flash_bf16_schedule.h"
#include "flash_f32_tc.cuh"
#include "flash_f32_tc32_bwd_schedule.h"

namespace {

// the lse of a padded query row: its P = exp2(x - inf) = 0
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// ------------------------------------------------------- Delta (bf16)

template <int D>
__global__ void __launch_bounds__(256)
pn_flash_bwd_delta(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ d_o,
                   float* __restrict__ delta, int heads, int sq, long long rows) {
  constexpr int LANES = D / 8;  // lanes of one (b, s, h) row, 8 values each
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  float sum = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row * D + lane * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(d_o + row * D + lane * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(op[e]), b = __bfloat1622float2(dp[e]);
      sum = fmaf(a.x, b.x, fmaf(a.y, b.y, sum));
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && lane == 0) {
    // row = (b Sq + s) H + h  ->  delta[(b H + h) Sq + s]
    const long long h = row % heads, bs = row / heads;
    const long long b = bs / sq, s = bs % sq;
    delta[(b * heads + h) * sq + s] = sum;
  }
}

template <int D>
int launch_delta(const void* o, const void* d_o, void* delta, int heads, int sq, long long rows,
                 cudaStream_t stream) {
  pn_flash_bwd_delta<D><<<static_cast<unsigned>((rows * (D / 8) + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(d_o),
      static_cast<float*>(delta), heads, sq, rows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- wgmma, D = 16, 32, 64, 128

namespace wg {

namespace sched = pn::bf16_schedule;

constexpr int KB = sched::BWD_KB;  // keys per dK/dV block: 2 consumer warpgroups x 64
constexpr int QB = sched::BWD_QB;  // query rows per dQ block: 2 consumer warpgroups x 64
constexpr int Q_STAGES = sched::BWD_Q_STAGES;  // ring slots of the dQ pass (K and V tiles)
constexpr int LAG = sched::BWD_LAG;  // a slot is refilled two tiles after it was consumed
constexpr int NTHREADS = 256;  // two consumer warpgroups, no producer warp (see above)

// QT: query rows per streamed tile of the dK/dV pass; KT: keys per streamed
// tile of the dQ pass (and rows of the k and v maps' boxes)
template <int D>
struct KvSmem {
  static constexpr int QT = sched::BWD_QT, STAGES = sched::bwd_kv_stages(D);
  __nv_bfloat16 k[KB * D];
  __nv_bfloat16 v[KB * D];
  __nv_bfloat16 q[STAGES][QT * D];
  __nv_bfloat16 d_o[STAGES][QT * D];
  float stats[2][2][2 * QT];  // per warpgroup and tile parity: QT lse, then QT Delta
  uint64_t kv_full;
  uint64_t full[STAGES], empty[STAGES];
};

template <int D>
struct QSmem {
  static constexpr int KT = sched::bwd_kt(D);
  __nv_bfloat16 q[QB * D];
  __nv_bfloat16 d_o[QB * D];
  __nv_bfloat16 k[Q_STAGES][KT * D];
  __nv_bfloat16 v[Q_STAGES][KT * D];
  uint64_t q_full;
  uint64_t full[Q_STAGES], empty[Q_STAGES];
};

template <int D>
constexpr int KV_SMEM_BYTES = sizeof(KvSmem<D>) + pn::SWIZZLE_ATOM;  // room to align
template <int D>
constexpr int Q_SMEM_BYTES = sizeof(QSmem<D>) + pn::SWIZZLE_ATOM;

template <int D>
constexpr bool smem_as_scheduled() {
  return KV_SMEM_BYTES<D> == sched::bwd_kv_smem_bytes(D) &&
         Q_SMEM_BYTES<D> == sched::bwd_q_smem_bytes(D);
}
static_assert(smem_as_scheduled<16>() && smem_as_scheduled<32>() && smem_as_scheduled<64>() &&
                  smem_as_scheduled<128>(),
              "the shared memory of flash_bf16_schedule.h");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a masked score's exponent: ex2 of it is 0 (see the note on masks above)
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The (64 x D) fp32 accumulator rows 16 w + g and + 8 of a warpgroup, times
// `scale`, as bf16 into rows r0, r0 + 8 (those below `rows`) of `base`.
template <int D>
__device__ __forceinline__ void write_acc(__nv_bfloat16* base, long long row_stride,
                                          const float (&acc)[D / 2], float scale, int r0, int rows,
                                          int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < rows) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(base + row * row_stride + n * 8 + t * 2) =
            pn::pack_bf16x2(acc[n * 4 + r * 2] * scale, acc[n * 4 + r * 2 + 1] * scale);
    }
  }
}

// acc (64 x D) += A (registers) * B (16 x D rows of a tile of `rows` rows,
// MN-major, at `desc`): one m64nDk16, or at D 128 one m64n64k16 on each of
// the two panels
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int rows) {
  if constexpr (sched::panels(D) == 1) {
    pn::wgmma_rs_mn<D>(acc, a, desc);
  } else {
#pragma unroll
    for (int pa = 0; pa < sched::panels(D); ++pa)
      pn::wgmma_rs_mn<64>(pn::acc_half(acc, pa),
                          a, pn::desc_advance(desc, pa * rows * sched::swizzle_bytes(D)));
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, const int* __restrict__ kv_lens, int heads,
                     int sq, int skv, int k_tiles, float scale, float scale_log2) {
  constexpr int QT = KvSmem<D>::QT, KV_STAGES = KvSmem<D>::STAGES, KT = sched::bwd_kt(D);
  // a row lies in PANELS panels of PC columns, rows of SW bytes each
  constexpr int SW = sched::swizzle_bytes(D), PC = sched::panel_cols(D), PANELS = D / PC;
  extern __shared__ uint8_t smem_raw[];
  KvSmem<D>& sm = *reinterpret_cast<KvSmem<D>*>(pn::align_smem(smem_raw));

  // blockIdx.x = (batch * heads + head) * k_tiles + key tile: the blocks that
  // stream one head's Q and dO are neighbours in launch order
  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int h = bh % heads, b = bh / heads;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int key0 = kt * KB;
  const long long o_ss = static_cast<long long>(heads) * D;  // row stride of (B, S, H, D)
  __nv_bfloat16* dkb = dk + (static_cast<long long>(b) * skv * heads + h) * D;
  __nv_bfloat16* dvb = dv + (static_cast<long long>(b) * skv * heads + h) * D;

  // a block whose keys all lie past kv_len streams one tile, all masked
  const int q_tiles = key0 < row_len ? (sq + QT - 1) / QT : 1;
  const int group = threadIdx.x >> 7;

  auto load = [&](int j) {  // Q and dO tile j into its slot (thread 0)
    const int s = j % KV_STAGES;
    pn::mbar_arrive_expect_tx(&sm.full[s], 2 * QT * D * 2);
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      pn::tma_load_4d(sm.q[s] + p * QT * PC, &q_map, &sm.full[s], p * PC, h, j * QT, b);
      pn::tma_load_4d(sm.d_o[s] + p * QT * PC, &do_map, &sm.full[s], p * PC, h, j * QT, b);
    }
  };
  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      pn::mbar_init(&sm.full[s], 1);
      pn::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    pn::mbar_init_fence();
    // the resident keys: KB / KT boxes of the k and v maps (the dQ pass's
    // tiles) in each panel
    pn::mbar_arrive_expect_tx(&sm.kv_full, 2 * KB * D * 2);
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int part = 0; part < KB / KT; ++part) {
        pn::tma_load_4d(sm.k + p * KB * PC + part * KT * PC, &k_map, &sm.kv_full, p * PC, h,
                        key0 + part * KT, b);
        pn::tma_load_4d(sm.v + p * KB * PC + part * KT * PC, &v_map, &sm.kv_full, p * PC, h,
                        key0 + part * KT, b);
      }
    for (int j = 0; j < min(KV_STAGES, q_tiles); ++j) load(j);
  }
  __syncthreads();

  // warpgroup `group` owns keys [key0 + 64 group, + 64)
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
  const int kr0 = key0 + group * 64 + warp * 16 + g;  // this thread's keys kr0, kr0 + 8
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  {
    const bool key_ok[2] = {kr0 < row_len, kr0 + 8 < row_len};
    const uint64_t k_desc = pn::smem_desc<SW>(pn::smem_u32(sm.k) + group * 64 * SW);
    const uint64_t v_desc = pn::smem_desc<SW>(pn::smem_u32(sm.v) + group * 64 * SW);
    const float* lse_b = lse + static_cast<long long>(bh) * sq;
    const float* delta_b = delta + static_cast<long long>(bh) * sq;
    float s[QT / 2], dp[QT / 2];   // S^T then P^T; dP^T then dS^T (keys x QT queries)
    uint32_t pp[QT / 16][4], pds[QT / 16][4];  // P^T and dS^T as bf16 A operands, k16 steps

    // tile j's lse (+inf past Sq) and Delta, one value a thread; no branch,
    // so that no divergent path lies between a wgmma and its wait
    static_assert(2 * QT == 128, "a warpgroup's threads fetch a tile's statistics");
    auto fetch_stats = [&](int j) {
      const int row = j * QT + (tid & (QT - 1));
      const bool is_lse = tid < QT;
      const float v = (is_lse ? lse_b : delta_b)[min(row, sq - 1)];
      return row < sq ? v : (is_lse ? pos_inf() : 0.f);
    };
    auto start_sdp = [&](int j) {  // S^T = K Q^T, dP^T = V dO^T: one committed group
      const int st = j % KV_STAGES;
      const uint64_t q_desc = pn::smem_desc<SW>(pn::smem_u32(sm.q[st]));
      const uint64_t do_desc = pn::smem_desc<SW>(pn::smem_u32(sm.d_o[st]));
      pn::pin(s);
      pn::pin(dp);
      pn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        pn::wgmma_ss<QT>(s, pn::desc_advance(k_desc, sched::kstep_offset(D, KB, kk)),
                         pn::desc_advance(q_desc, sched::kstep_offset(D, QT, kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        pn::wgmma_ss<QT>(dp, pn::desc_advance(v_desc, sched::kstep_offset(D, KB, kk)),
                         pn::desc_advance(do_desc, sched::kstep_offset(D, QT, kk)), kk > 0);
      pn::wgmma_commit();
    };
    auto start_dkdv = [&](int j) {  // dV += P^T dO, dK += dS^T Q: one committed group
      const int st = j % KV_STAGES;
      const uint64_t q_desc = pn::smem_desc<SW>(pn::smem_u32(sm.q[st]));
      const uint64_t do_desc = pn::smem_desc<SW>(pn::smem_u32(sm.d_o[st]));
      pn::pin(dk_acc);
      pn::pin(dv_acc);
      pn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        product_rs<D>(dv_acc, pp[kk], pn::desc_advance(do_desc, kk * 16 * SW), QT);
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        product_rs<D>(dk_acc, pds[kk], pn::desc_advance(q_desc, kk * 16 * SW), QT);
      pn::wgmma_commit();
    };
    auto grads = [&](int j) {  // P^T and dS^T in place, from the tile's lse and Delta
      const float* ls = sm.stats[group][j & 1];
      const float* ds = ls + QT;
#pragma unroll
      for (int n = 0; n < QT / 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + n * 8 + t * 2);
        const float2 dl = *reinterpret_cast<const float2*>(ds + n * 8 + t * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 4 + e;
          const float pe = ex2(key_ok[e >> 1] ? fmaf(s[i], scale_log2, -((e & 1) ? l.y : l.x))
                                              : neg_inf());
          s[i] = pe;
          dp[i] = pe * (dp[i] - ((e & 1) ? dl.y : dl.x));
        }
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pp[kk][e] = pn::pack_bf16x2(s[kk * 8 + e * 2], s[kk * 8 + e * 2 + 1]);
          pds[kk][e] = pn::pack_bf16x2(dp[kk * 8 + e * 2], dp[kk * 8 + e * 2 + 1]);
        }
    };
    // thread 0 refills the slot of tile j - LAG once both warpgroups are done
    // with it; the wait lets warpgroup 0 run at most about LAG tiles ahead
    auto refill = [&](int j) {
      if (threadIdx.x == 0 && j >= LAG && j - LAG + KV_STAGES < q_tiles) {
        const int old = j - LAG;
        pn::mbar_wait(&sm.empty[old % KV_STAGES], (old / KV_STAGES) & 1);
        load(old + KV_STAGES);
      }
      __syncwarp();
    };

    // the statistics of tile j go to the buffer of parity j & 1 where no
    // wgmma is in flight, fetched a tile ahead; the barrier after the store
    // also orders it after the reads of tile j - 2
    float stat = fetch_stats(0);
    sm.stats[group][0][tid] = stat;
    pn::group_sync(group);
    stat = fetch_stats(1);
    pn::mbar_wait(&sm.kv_full, 0);
    pn::mbar_wait(&sm.full[0], 0);
    start_sdp(0);
    pn::wgmma_wait<0>();
    pn::pin(s);
    pn::pin(dp);
    grads(0);
    pack();
    for (int j = 1; j < q_tiles; ++j) {
      sm.stats[group][j & 1][tid] = stat;
      pn::group_sync(group);
      stat = fetch_stats(j + 1);
      pn::mbar_wait(&sm.full[j % KV_STAGES], (j / KV_STAGES) & 1);
      start_sdp(j);
      start_dkdv(j - 1);
      refill(j);
      pn::wgmma_wait<1>();  // S^T, dP^T of tile j are done; dV, dK of tile j-1 run on
      pn::pin(s);
      pn::pin(dp);
      grads(j);
      pn::wgmma_wait<0>();
      pn::pin(dk_acc);
      pn::pin(dv_acc);
      pn::pin(pp);
      pn::pin(pds);
      if (lane == 0) pn::mbar_arrive(&sm.empty[(j - 1) % KV_STAGES]);
      pack();
    }
    start_dkdv(q_tiles - 1);
    pn::wgmma_wait<0>();
    pn::pin(dk_acc);
    pn::pin(dv_acc);
    pn::pin(pp);
    pn::pin(pds);
  }
  // keys past the row's length get zeros; rows past Skv are not written
  write_acc<D>(dvb, o_ss, dv_acc, 1.f, kr0, skv, t);
  write_acc<D>(dkb, o_ss, dk_acc, scale, kr0, skv, t);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_bwd_dq_wg(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                   const int* __restrict__ kv_lens, int heads, int sq, int skv, int q_tiles,
                   float scale, float scale_log2) {
  constexpr int KT = QSmem<D>::KT;
  constexpr int SW = sched::swizzle_bytes(D), PC = sched::panel_cols(D), PANELS = D / PC;
  extern __shared__ uint8_t smem_raw[];
  QSmem<D>& sm = *reinterpret_cast<QSmem<D>*>(pn::align_smem(smem_raw));

  // blockIdx.x = (batch * heads + head) * q_tiles + query tile, as the forward
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int n_tiles = (row_len + KT - 1) / KT;
  const int group = threadIdx.x >> 7;

  auto load = [&](int j) {  // K and V tile j into its slot (thread 0)
    const int s = j % Q_STAGES;
    pn::mbar_arrive_expect_tx(&sm.full[s], 2 * KT * D * 2);
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      pn::tma_load_4d(sm.k[s] + p * KT * PC, &k_map, &sm.full[s], p * PC, h, j * KT, b);
      pn::tma_load_4d(sm.v[s] + p * KT * PC, &v_map, &sm.full[s], p * PC, h, j * KT, b);
    }
  };
  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < Q_STAGES; ++s) {
      pn::mbar_init(&sm.full[s], 1);
      pn::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    pn::mbar_init_fence();
    pn::mbar_arrive_expect_tx(&sm.q_full, 2 * QB * D * 2);
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      pn::tma_load_4d(sm.q + p * QB * PC, &q_map, &sm.q_full, p * PC, h, qt * QB, b);
      pn::tma_load_4d(sm.d_o + p * QB * PC, &do_map, &sm.q_full, p * PC, h, qt * QB, b);
    }
    for (int j = 0; j < min(Q_STAGES, n_tiles); ++j) load(j);
  }
  __syncthreads();

  // warpgroup `group` owns query rows [64 group, 64 group + 64)
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * QB + group * 64 + warp * 16 + g;  // this thread's rows r0, r0 + 8
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    row_lse[r] = row < sq ? lse[static_cast<long long>(bh) * sq + row] : pos_inf();
    row_delta[r] = row < sq ? delta[static_cast<long long>(bh) * sq + row] : 0.f;
  }
  const uint64_t q_desc = pn::smem_desc<SW>(pn::smem_u32(sm.q) + group * 64 * SW);
  const uint64_t do_desc = pn::smem_desc<SW>(pn::smem_u32(sm.d_o) + group * 64 * SW);
  float s[KT / 2], dp[KT / 2], dq_acc[D / 2];  // S, then dP and dS (64 rows x KT keys); dQ
  uint32_t pds[KT / 16][4];                    // dS as bf16 A operands, k16 steps
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  auto start_sdp = [&](int j) {  // S = Q K^T, dP = dO V^T: one committed group
    const int st = j % Q_STAGES;
    const uint64_t k_desc = pn::smem_desc<SW>(pn::smem_u32(sm.k[st]));
    const uint64_t v_desc = pn::smem_desc<SW>(pn::smem_u32(sm.v[st]));
    pn::pin(s);
    pn::pin(dp);
    pn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      pn::wgmma_ss<KT>(s, pn::desc_advance(q_desc, sched::kstep_offset(D, QB, kk)),
                       pn::desc_advance(k_desc, sched::kstep_offset(D, KT, kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      pn::wgmma_ss<KT>(dp, pn::desc_advance(do_desc, sched::kstep_offset(D, QB, kk)),
                       pn::desc_advance(v_desc, sched::kstep_offset(D, KT, kk)), kk > 0);
    pn::wgmma_commit();
  };
  auto start_dq = [&](int j) {  // dQ += dS K: one committed group
    const uint64_t k_desc = pn::smem_desc<SW>(pn::smem_u32(sm.k[j % Q_STAGES]));
    pn::pin(dq_acc);
    pn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      product_rs<D>(dq_acc, pds[kk], pn::desc_advance(k_desc, kk * 16 * SW), KT);
    pn::wgmma_commit();
  };
  auto grads = [&](int limit) {  // dS in dp; keys from `limit` on are masked
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float pe = ex2((i >> 2) * 8 + t * 2 + (i & 1) < limit
                               ? fmaf(s[i], scale_log2, -row_lse[r])
                               : neg_inf());
      dp[i] = pe * (dp[i] - row_delta[r]);
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pds[kk][e] = pn::pack_bf16x2(dp[kk * 8 + e * 2], dp[kk * 8 + e * 2 + 1]);
  };
  auto refill = [&](int j) {  // as in the dK/dV pass
    if (threadIdx.x == 0 && j >= LAG && j - LAG + Q_STAGES < n_tiles) {
      const int old = j - LAG;
      pn::mbar_wait(&sm.empty[old % Q_STAGES], (old / Q_STAGES) & 1);
      load(old + Q_STAGES);
    }
    __syncwarp();
  };

  pn::mbar_wait(&sm.q_full, 0);
  pn::mbar_wait(&sm.full[0], 0);
  start_sdp(0);
  pn::wgmma_wait<0>();
  pn::pin(s);
  pn::pin(dp);
  grads(row_len);
  pack();
  for (int j = 1; j < n_tiles; ++j) {
    pn::mbar_wait(&sm.full[j % Q_STAGES], (j / Q_STAGES) & 1);
    start_sdp(j);
    start_dq(j - 1);
    refill(j);
    pn::wgmma_wait<1>();  // S, dP of tile j are done; dQ of tile j-1 runs on
    pn::pin(s);
    pn::pin(dp);
    grads(row_len - j * KT);
    pn::wgmma_wait<0>();
    pn::pin(dq_acc);
    pn::pin(pds);
    if (lane == 0) pn::mbar_arrive(&sm.empty[(j - 1) % Q_STAGES]);
    pack();
  }
  start_dq(n_tiles - 1);
  pn::wgmma_wait<0>();
  pn::pin(dq_acc);
  pn::pin(pds);

  // dq, (B, Sq, H, D) contiguous, written once; rows past Sq never
  write_acc<D>(dq + (static_cast<long long>(b) * sq * heads + h) * D,
               static_cast<long long>(heads) * D, dq_acc, scale, r0, sq, t);
}

// maps: six specs of 12 values (dims, byte strides, boxes of 4-D views,
// innermost first, as pn::encode_map takes them), each box
// sched::panel_cols(D) columns of one head: q and dO with boxes of the dK/dV
// pass's streamed tiles (BWD_QT rows), q and dO with the dQ pass's resident
// 128 rows, k and v with boxes of the dQ pass's streamed tiles (bwd_kt
// rows; the dK/dV pass loads its 128 resident keys as 128 / bwd_kt of them).
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* delta, void* dq, void* dk, void* dv, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* maps, float scale,
           cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      pn_flash_bwd_dkdv_wg<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM_BYTES<D>);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      pn_flash_bwd_dq_wg<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM_BYTES<D>);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_kv, do_kv, q_q, do_q, k_map, v_map;
  const void* bases[6] = {q, d_o, q, d_o, k, v};
  CUtensorMap* out[6] = {&q_kv, &do_kv, &q_q, &do_q, &k_map, &v_map};
  for (int i = 0; i < 6; ++i) {
    const int err = pn::encode_map(out[i], bases[i], 4, maps + 12 * i,
                                   CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
    if (err) return err;
  }
  const long long bh = static_cast<long long>(batch) * heads;
  const int k_tiles = (skv + KB - 1) / KB, q_tiles = (sq + QB - 1) / QB;
  if (bh < 1 || bh * k_tiles > 2147483647LL || bh * q_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  int err = launch_delta<D>(o, d_o, delta, heads, sq, bh * sq, stream);
  if (err) return err;
  pn_flash_bwd_dkdv_wg<D><<<static_cast<unsigned>(bh * k_tiles), NTHREADS, KV_SMEM_BYTES<D>,
                            stream>>>(
      q_kv, do_kv, k_map, v_map, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<const int*>(kv_lens), heads, sq, skv, k_tiles, scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_dq_wg<D><<<static_cast<unsigned>(bh * q_tiles), NTHREADS, Q_SMEM_BYTES<D>,
                          stream>>>(
      q_q, do_q, k_map, v_map, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), static_cast<const int*>(kv_lens), heads, sq, skv, q_tiles,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------- fp32, D = 16, 128

namespace f32 {

constexpr int BT = 64;       // rows per tile: keys (dk/dv) or queries (dq)
constexpr int NTHREADS = 256;
constexpr int RI = BT / 16;  // rows a thread owns
constexpr int CJ = BT / 16;  // score columns a thread owns
constexpr int LDP = BT + 4;  // padded row of the P and dS tiles

// four (64, D) tiles, two (64, 64) score tiles and two rows of 64 floats
template <int D>
constexpr int smem_bytes() {
  return (4 * BT * (D + 4) + 2 * BT * LDP + 2 * BT) * static_cast<int>(sizeof(float));
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
  for (int c = threadIdx.x; c < BT * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<float4*>(dst + r * LD + col) = val;
  }
}

// s[i][j] = sum over d of a[(ty + 16 i)] . b[(tx + 16 j)], both tiles padded
template <int D>
__device__ __forceinline__ void scores(float (&s)[RI][CJ], const float* a, const float* b,
                                       int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][c..] += sum over the 64 columns x of w[(ty + 16 i)][x] * m[x][cols],
// the thread's columns (c 16 + tx) VEC + e of the padded (64, D) tile m
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[RI][D / 16], const float* w,
                                           const float* m, int ty, int tx) {
  constexpr int LD = D + 4, DC = D / 16, VEC = DC >= 4 ? 4 : DC, NC = DC / VEC;
#pragma unroll 2
  for (int x = 0; x < BT; x += 4) {
    float wv[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) load_vec<4>(wv[i], w + (ty + 16 * i) * LDP + x);
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      float mv[DC];
#pragma unroll
      for (int c = 0; c < NC; ++c) load_vec<VEC>(mv + c * VEC, m + (x + xx) * LD + (c * 16 + tx) * VEC);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(wv[i][xx], mv[c], acc[i][c]);
    }
  }
}

// rows ty + 16 i (those below `rows`) of acc, times `scale`, into a
// (B, S, H, D) contiguous tensor's (b, h) slice from row0 on
template <int D>
__device__ __forceinline__ void write_tile(float* base, long long row_stride,
                                           float (&acc)[RI][D / 16], float scale, int row0,
                                           int rows, int ty, int tx) {
  constexpr int DC = D / 16, VEC = DC >= 4 ? 4 : DC, NC = DC / VEC;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= scale;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        store_vec<VEC>(base + row * row_stride + (c * 16 + tx) * VEC, acc[i] + c * VEC);
    }
  }
}

// Delta = rowsum(dO * O), fp32, D / 4 lanes a row
template <int D>
__global__ void __launch_bounds__(256)
pn_flash_bwd_f32_delta(const float* __restrict__ o, const float* __restrict__ d_o,
                       float* __restrict__ delta, int heads, int sq, long long rows) {
  constexpr int LANES = D / 4;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  float sum = 0.f;
  if (row < rows) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * D + lane * 4);
    const float4 c = *reinterpret_cast<const float4*>(d_o + row * D + lane * 4);
    sum = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, a.w * c.w)));
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && lane == 0) {
    const long long h = row % heads, bs = row / heads;
    const long long b = bs / sq, s = bs % sq;
    delta[(b * heads + h) * sq + s] = sum;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
pn_flash_bwd_f32_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ d_o,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      const int* __restrict__ kv_lens, int heads, int sq, int skv, int k_tiles,
                      long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh, float scale, float scale_log2) {
  constexpr int LD = D + 4, DC = D / 16;
  extern __shared__ float4 smem_f32[];
  float* ks = reinterpret_cast<float*>(smem_f32);
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* ps = dos + BT * LD;   // P^T (keys x queries)
  float* dss = ps + BT * LDP;  // dS^T
  float* lse_s = dss + BT * LDP;
  float* delta_s = lse_s + BT;

  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int h = bh % heads, b = bh / heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int key0 = kt * BT;
  const long long o_ss = static_cast<long long>(heads) * D;

  float dk_acc[RI][DC], dv_acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  if (key0 < row_len) {
    stage_tile<D>(ks, k + b * k_sb + h * k_sh, k_ss, key0, skv);
    stage_tile<D>(vs, v + b * v_sb + h * v_sh, v_ss, key0, skv);
    bool key_ok[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) key_ok[i] = key0 + ty + 16 * i < row_len;
    const float* qb = q + b * q_sb + h * q_sh;
    const float* dob = d_o + (static_cast<long long>(b) * sq * heads + h) * D;
    const float* lse_b = lse + static_cast<long long>(bh) * sq;
    const float* delta_b = delta + static_cast<long long>(bh) * sq;
    for (int q0 = 0; q0 < sq; q0 += BT) {
      __syncthreads();  // every warp is done with the previous query tile
      stage_tile<D>(qs, qb, q_ss, q0, sq);
      stage_tile<D>(dos, dob, o_ss, q0, sq);
      if (threadIdx.x < BT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse_b[r] : pos_inf();
        delta_s[threadIdx.x] = r < sq ? delta_b[r] : 0.f;
      }
      __syncthreads();

      // P^T and dS^T: keys ty + 16 i, queries tx + 16 j
      float s[RI][CJ], dp[RI][CJ];
      scores<D>(s, ks, qs, ty, tx);
      scores<D>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int col = tx + 16 * j;
          const float pe = key_ok[i] ? exp2f(fmaf(s[i][j], scale_log2, -lse_s[col])) : 0.f;
          ps[(ty + 16 * i) * LDP + col] = pe;
          dss[(ty + 16 * i) * LDP + col] = pe * (dp[i][j] - delta_s[col]);
        }
      __syncwarp();  // a key row's 16 lanes are in this warp
      accumulate<D>(dv_acc, ps, dos, ty, tx);
      accumulate<D>(dk_acc, dss, qs, ty, tx);
      __syncwarp();
    }
  }
  // keys past the row's length (and whole tiles of them) get zeros
  const long long base = (static_cast<long long>(b) * skv * heads + h) * D;
  write_tile<D>(dv + base, o_ss, dv_acc, 1.f, key0, skv, ty, tx);
  write_tile<D>(dk + base, o_ss, dk_acc, scale, key0, skv, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
pn_flash_bwd_f32_dq(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, const int* __restrict__ kv_lens, int heads, int sq,
                    int skv, int q_tiles, long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, float scale, float scale_log2) {
  constexpr int LD = D + 4, DC = D / 16;
  extern __shared__ float4 smem_f32[];
  float* ks = reinterpret_cast<float*>(smem_f32);
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* dss = dos + BT * LD;  // dS (queries x keys)

  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int q0 = qt * BT;
  const long long o_ss = static_cast<long long>(heads) * D;

  stage_tile<D>(qs, q + b * q_sb + h * q_sh, q_ss, q0, sq);
  stage_tile<D>(dos, d_o + (static_cast<long long>(b) * sq * heads + h) * D, o_ss, q0, sq);
  float row_lse[RI], row_delta[RI], dq_acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < sq ? lse[static_cast<long long>(bh) * sq + row] : pos_inf();
    row_delta[i] = row < sq ? delta[static_cast<long long>(bh) * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;
  }

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  for (int kv0 = 0; kv0 < row_len; kv0 += BT) {
    __syncthreads();  // every warp is done with the previous key tile
    stage_tile<D>(ks, kb, k_ss, kv0, skv);
    stage_tile<D>(vs, vb, v_ss, kv0, skv);
    __syncthreads();

    // dS: rows ty + 16 i, keys tx + 16 j
    float s[RI][CJ], dp[RI][CJ];
    scores<D>(s, qs, ks, ty, tx);
    scores<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        const float pe =
            kv0 + col < row_len ? exp2f(fmaf(s[i][j], scale_log2, -row_lse[i])) : 0.f;
        dss[(ty + 16 * i) * LDP + col] = pe * (dp[i][j] - row_delta[i]);
      }
    __syncwarp();  // a query row's 16 lanes are in this warp
    accumulate<D>(dq_acc, dss, ks, ty, tx);
    __syncwarp();
  }
  write_tile<D>(dq + (static_cast<long long>(b) * sq * heads + h) * D, o_ss, dq_acc, scale, q0,
                sq, ty, tx);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* delta, void* dq, void* dk, void* dv, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* st, float scale,
           cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      pn_flash_bwd_f32_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      pn_flash_bwd_f32_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const long long bh = static_cast<long long>(batch) * heads;
  const int k_tiles = (skv + BT - 1) / BT, q_tiles = (sq + BT - 1) / BT;
  if (bh < 1 || bh * k_tiles > 2147483647LL || bh * q_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dop = static_cast<const float*>(d_o);
  const auto* lens = static_cast<const int*>(kv_lens);

  const long long rows = bh * sq;
  pn_flash_bwd_f32_delta<D><<<static_cast<unsigned>((rows * (D / 4) + 255) / 256), 256, 0,
                              stream>>>(static_cast<const float*>(o), dop,
                                        static_cast<float*>(delta), heads, sq, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_f32_dkdv<D><<<static_cast<unsigned>(bh * k_tiles), NTHREADS, smem_bytes<D>(),
                             stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), lens, heads, sq, skv, k_tiles, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_f32_dq<D><<<static_cast<unsigned>(bh * q_tiles), NTHREADS, smem_bytes<D>(),
                           stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), lens, heads, sq, skv, q_tiles, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ------------------------------------------- fp32 on the tensor cores, D = 64

namespace tc {

// T, NTHREADS, PANEL and the shared device functions (the split helpers,
// product_nt, product_rs, to_a, reduce_write): flash_f32_tc.cuh
using namespace pn::tc;

constexpr int D = 64;
constexpr int TILE = T * D;    // floats of a streamed tile, and of a transposed one
constexpr int KB = 64;         // keys per dK/dV block
constexpr int QB = 64;         // query rows per dQ block
constexpr int STAGES = 2;      // ring slots of each warpgroup
constexpr int SETS = D / 16;   // accumulator sets of S and dP: 16 channels each

struct KvSmem {
  float k[2][KB * D];  // K as loaded, split in place into K_big; K_small
  float v[2][KB * D];
  struct Group {
    float raw[STAGES][2][TILE];  // per slot Q and dO as loaded, split in place into big parts
    float small[2][TILE];        // Q_small, dO_small
    float tr[2][2][TILE];        // Q^T and dO^T (64 rows of d), each big and small
  } wg[2];
  uint64_t kv_full;
  uint64_t full[2][STAGES];
};

struct QSmem {
  float q[2][QB * D];  // Q as loaded, split in place into Q_big; Q_small
  float d_o[2][QB * D];
  struct Group {
    float raw[STAGES][2][TILE];  // per slot K and V as loaded, split in place
    float small[2][TILE];        // K_small, V_small
    float tr[2][TILE];           // K^T big and small
  } wg[2];
  uint64_t q_full;
  uint64_t full[2][STAGES];
};

constexpr int KV_SMEM_BYTES = sizeof(KvSmem) + pn::SWIZZLE_ATOM;  // room to align
constexpr int Q_SMEM_BYTES = sizeof(QSmem) + pn::SWIZZLE_ATOM;
static_assert(KV_SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
static_assert(Q_SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");

__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_bwd_f32_dkdv_tc(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, const int* __restrict__ kv_lens, int heads,
                         int sq, int skv, int k_tiles, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  KvSmem& sm = *reinterpret_cast<KvSmem*>(pn::align_smem(smem_raw));

  // blockIdx.x = (batch * heads + head) * k_tiles + key tile
  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int h = bh % heads, b = bh / heads;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int key0 = kt * KB;
  const int group = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // a block whose keys all lie past kv_len streams one tile, all masked; the
  // warpgroups take the query tiles in turn: group, group + 2, ...
  const int q_tiles = key0 < row_len ? (sq + T - 1) / T : 1;
  const int my_tiles = (q_tiles - group + 1) / 2;
  KvSmem::Group& w = sm.wg[group];

  auto load = [&](int i) {  // this warpgroup's tile i (by its thread 0)
    const int s = i % STAGES, row0 = (group + 2 * i) * T;
    pn::mbar_arrive_expect_tx(&sm.full[group][s], 2 * TILE * 4);
    load_rows<D>(w.raw[s][0], T, &q_map, &sm.full[group][s], h, row0, b);
    load_rows<D>(w.raw[s][1], T, &do_map, &sm.full[group][s], h, row0, b);
  };
  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      pn::mbar_init(&sm.full[0][s], 1);
      pn::mbar_init(&sm.full[1][s], 1);
    }
    pn::mbar_init_fence();
    pn::mbar_arrive_expect_tx(&sm.kv_full, 2 * KB * D * 4);
    load_rows<D>(sm.k[0], KB, &k_map, &sm.kv_full, h, key0, b);
    load_rows<D>(sm.v[0], KB, &v_map, &sm.kv_full, h, key0, b);
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(STAGES, my_tiles); ++i) load(i);
  pn::mbar_wait(&sm.kv_full, 0);
  split_flat(sm.k[0], sm.k[1], KB * D);
  split_flat(sm.v[0], sm.v[1], KB * D);
  pn::tma_store_fence();  // the writes are seen by wgmma (the async proxy)
  __syncthreads();

  // both warpgroups own the block's 64 keys; this thread's are kr0, kr0 + 8
  const int kr0 = key0 + warp * 16 + g;
  const bool key_ok[2] = {kr0 < row_len, kr0 + 8 < row_len};
  const uint32_t kb = pn::smem_u32(sm.k[0]), ks = pn::smem_u32(sm.k[1]);
  const uint32_t vb = pn::smem_u32(sm.v[0]), vs = pn::smem_u32(sm.v[1]);
  const float* lse_b = lse + static_cast<long long>(bh) * sq;
  const float* delta_b = delta + static_cast<long long>(bh) * sq;
  float dk_sum[32], dv_sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_sum[i] = dv_sum[i] = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    const int st = i % STAGES, q0 = (group + 2 * i) * T;
    pn::mbar_wait(&sm.full[group][st], (i / STAGES) & 1);
    split_tile<D, T, true>(w.raw[st][0], w.small[0], w.tr[0][0], w.tr[0][1], warp, lane);
    split_tile<D, T, true>(w.raw[st][1], w.small[1], w.tr[1][0], w.tr[1][1], warp, lane);
    pn::tma_store_fence();
    pn::group_sync(group);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 32 queries)
    float s_sets[SETS][16], dp_sets[SETS][16];
    pn::wgmma_fence();
    product_nt<D>(s_sets, kb, ks, KB * 128, pn::smem_u32(w.raw[st][0]), pn::smem_u32(w.small[0]),
               T * 128);
    product_nt<D>(dp_sets, vb, vs, KB * 128, pn::smem_u32(w.raw[st][1]), pn::smem_u32(w.small[1]),
               T * 128);
    pn::wgmma_commit();
    // the lse (+inf past Sq) and Delta of this thread's queries q0 + 8 n + 2 t + e
    float ls[8], dl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qr = q0 + (j >> 1) * 8 + t * 2 + (j & 1), qc = min(qr, sq - 1);
      ls[j] = qr < sq ? lse_b[qc] : pos_inf();
      dl[j] = qr < sq ? delta_b[qc] : 0.f;
    }
    pn::wgmma_wait<0>();
    pn::pin(s_sets);
    pn::pin(dp_sets);
    float s[16], dp[16];
    sum_sets(s, s_sets);
    sum_sets(dp, dp_sets);

    // P^T and dS^T in place; a masked key selects the exponent -inf
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = (j >> 2) * 2 + (j & 1);
      const float pe = wg::ex2(key_ok[(j >> 1) & 1] ? fmaf(s[j], scale_log2, -ls[c])
                                                     : wg::neg_inf());
      s[j] = pe;
      dp[j] = pe * (dp[j] - dl[c]);
    }
    uint32_t p_big[4][4], p_small[4][4], ds_big[4][4], ds_small[4][4];
    to_a(s, p_big, p_small);
    to_a(dp, ds_big, ds_small);

    // dV += P^T dO and dK += dS^T Q, each tile's into a fresh set that the
    // threads add to the sums, rounded to nearest
    float acc_v[32], acc_k[32];
    pn::wgmma_fence();
    product_rs(acc_v, p_big, p_small, pn::smem_u32(w.tr[1][0]), pn::smem_u32(w.tr[1][1]));
    product_rs(acc_k, ds_big, ds_small, pn::smem_u32(w.tr[0][0]), pn::smem_u32(w.tr[0][1]));
    pn::wgmma_commit();
    pn::wgmma_wait<0>();
    pn::pin(acc_v);
    pn::pin(acc_k);
    pn::pin(p_big);
    pn::pin(p_small);
    pn::pin(ds_big);
    pn::pin(ds_small);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      dv_sum[j] += acc_v[j];
      dk_sum[j] += acc_k[j];
    }
    pn::group_sync(group);  // every warp is done with the slot and the derived tiles
    if (tid == 0 && i + STAGES < my_tiles) load(i + STAGES);
    __syncwarp();
  }

  // keys past the row's length get zeros; rows past Skv are not written
  const long long o_ss = static_cast<long long>(heads) * D;
  const long long base = (static_cast<long long>(b) * skv * heads + h) * D;
  float* red = &sm.wg[0].raw[0][0][0];  // 32 KB, free once both warpgroups are done
  __syncthreads();
  reduce_write(red, dv_sum, group, tid, dv + base, o_ss, 1.f, kr0, skv, t);
  reduce_write(red, dk_sum, group, tid, dk + base, o_ss, scale, kr0, skv, t);
}

__global__ void __launch_bounds__(NTHREADS, 1)
pn_flash_bwd_f32_dq_tc(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       const int* __restrict__ kv_lens, int heads, int sq, int skv, int q_tiles,
                       float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  QSmem& sm = *reinterpret_cast<QSmem*>(pn::align_smem(smem_raw));

  // blockIdx.x = (batch * heads + head) * q_tiles + query tile
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int group = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the key tiles below kv_len, taken in turn by the warpgroups
  const int n_tiles = (row_len + T - 1) / T;
  const int my_tiles = (n_tiles - group + 1) / 2;
  QSmem::Group& w = sm.wg[group];

  auto load = [&](int i) {  // this warpgroup's key tile i (by its thread 0)
    const int s = i % STAGES, row0 = (group + 2 * i) * T;
    pn::mbar_arrive_expect_tx(&sm.full[group][s], 2 * TILE * 4);
    load_rows<D>(w.raw[s][0], T, &k_map, &sm.full[group][s], h, row0, b);
    load_rows<D>(w.raw[s][1], T, &v_map, &sm.full[group][s], h, row0, b);
  };
  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      pn::mbar_init(&sm.full[0][s], 1);
      pn::mbar_init(&sm.full[1][s], 1);
    }
    pn::mbar_init_fence();
    pn::mbar_arrive_expect_tx(&sm.q_full, 2 * QB * D * 4);
    load_rows<D>(sm.q[0], QB, &q_map, &sm.q_full, h, qt * QB, b);
    load_rows<D>(sm.d_o[0], QB, &do_map, &sm.q_full, h, qt * QB, b);
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(STAGES, my_tiles); ++i) load(i);
  pn::mbar_wait(&sm.q_full, 0);
  split_flat(sm.q[0], sm.q[1], QB * D);
  split_flat(sm.d_o[0], sm.d_o[1], QB * D);
  pn::tma_store_fence();
  __syncthreads();

  // both warpgroups own the block's 64 rows; this thread's are r0, r0 + 8
  const int r0 = qt * QB + warp * 16 + g;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    row_lse[r] = row < sq ? lse[static_cast<long long>(bh) * sq + row] : pos_inf();
    row_delta[r] = row < sq ? delta[static_cast<long long>(bh) * sq + row] : 0.f;
  }
  const uint32_t qb = pn::smem_u32(sm.q[0]), qs = pn::smem_u32(sm.q[1]);
  const uint32_t ob = pn::smem_u32(sm.d_o[0]), os = pn::smem_u32(sm.d_o[1]);
  float dq_sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_sum[i] = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    const int st = i % STAGES, key0 = (group + 2 * i) * T;
    pn::mbar_wait(&sm.full[group][st], (i / STAGES) & 1);
    split_tile<D, T, true>(w.raw[st][0], w.small[0], w.tr[0], w.tr[1], warp, lane);
    split_tile<D, T, false>(w.raw[st][1], w.small[1], nullptr, nullptr, warp, lane);
    pn::tma_store_fence();
    pn::group_sync(group);

    // S = Q K^T and dP = dO V^T (64 rows x 32 keys)
    float s_sets[SETS][16], dp_sets[SETS][16];
    pn::wgmma_fence();
    product_nt<D>(s_sets, qb, qs, QB * 128, pn::smem_u32(w.raw[st][0]), pn::smem_u32(w.small[0]),
               T * 128);
    product_nt<D>(dp_sets, ob, os, QB * 128, pn::smem_u32(w.raw[st][1]), pn::smem_u32(w.small[1]),
               T * 128);
    pn::wgmma_commit();
    pn::wgmma_wait<0>();
    pn::pin(s_sets);
    pn::pin(dp_sets);
    float s[16], dp[16];
    sum_sets(s, s_sets);
    sum_sets(dp, dp_sets);

    // dS in place; keys from row_len on select the exponent -inf
    const int limit = row_len - key0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = (j >> 1) & 1, col = (j >> 2) * 8 + t * 2 + (j & 1);
      const float pe =
          wg::ex2(col < limit ? fmaf(s[j], scale_log2, -row_lse[r]) : wg::neg_inf());
      dp[j] = pe * (dp[j] - row_delta[r]);
    }
    uint32_t ds_big[4][4], ds_small[4][4];
    to_a(dp, ds_big, ds_small);

    // dQ += dS K, the tile's into a fresh set added to the sums
    float acc[32];
    pn::wgmma_fence();
    product_rs(acc, ds_big, ds_small, pn::smem_u32(w.tr[0]), pn::smem_u32(w.tr[1]));
    pn::wgmma_commit();
    pn::wgmma_wait<0>();
    pn::pin(acc);
    pn::pin(ds_big);
    pn::pin(ds_small);
#pragma unroll
    for (int j = 0; j < 32; ++j) dq_sum[j] += acc[j];
    pn::group_sync(group);  // every warp is done with the slot and the derived tiles
    if (tid == 0 && i + STAGES < my_tiles) load(i + STAGES);
    __syncwarp();
  }

  __syncthreads();
  reduce_write(&sm.wg[0].raw[0][0][0], dq_sum, group, tid,
               dq + (static_cast<long long>(b) * sq * heads + h) * D,
               static_cast<long long>(heads) * D, scale, r0, sq, t);
}

// maps: four specs of 12 values (dims, byte strides, boxes of the 4-D fp32
// views of q, dO, k and v with 32 x 32 boxes, innermost first), as
// pn::encode_map takes them
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* delta, void* dq, void* dk, void* dv, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* maps, float scale,
           cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      pn_flash_bwd_f32_dkdv_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM_BYTES);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      pn_flash_bwd_f32_dq_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM_BYTES);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, do_map, k_map, v_map;
  const void* bases[4] = {q, d_o, k, v};
  CUtensorMap* out[4] = {&q_map, &do_map, &k_map, &v_map};
  for (int i = 0; i < 4; ++i) {
    const int err = pn::encode_map(out[i], bases[i], 4, maps + 12 * i,
                                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err) return err;
  }
  const long long bh = static_cast<long long>(batch) * heads;
  const int k_tiles = (skv + KB - 1) / KB, q_tiles = (sq + QB - 1) / QB;
  if (bh < 1 || bh * k_tiles > 2147483647LL || bh * q_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const long long rows = bh * sq;
  f32::pn_flash_bwd_f32_delta<D><<<static_cast<unsigned>((rows * (D / 4) + 255) / 256), 256, 0,
                                   stream>>>(static_cast<const float*>(o),
                                             static_cast<const float*>(d_o),
                                             static_cast<float*>(delta), heads, sq, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_f32_dkdv_tc<<<static_cast<unsigned>(bh * k_tiles), NTHREADS, KV_SMEM_BYTES,
                             stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(kv_lens), heads, sq, skv, k_tiles, scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_f32_dq_tc<<<static_cast<unsigned>(bh * q_tiles), NTHREADS, Q_SMEM_BYTES,
                           stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq),
      static_cast<const int*>(kv_lens), heads, sq, skv, q_tiles, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------- fp32 on the tensor cores, D = 32

namespace tc32 {

// PANEL and the shared device functions (the split helpers, load_async,
// to_a, write_rows, reduce_write): flash_f32_tc.cuh; KB, QB, ROWS, the
// warpgroups of the dQ pass and the block and tile arithmetic:
// flash_f32_tc32_bwd_schedule.h
using namespace pn::tc;
using namespace pn::tc32_bwd_schedule;

constexpr int D = 32;
constexpr int TILE = ROWS * D;  // floats of a streamed tile, and of a transposed one
// threads of a block (its consumer warpgroups: one in the dK/dV pass; no
// producer warp) and ring slots of each warpgroup, per pass
constexpr int KV_THREADS = 128, Q_THREADS = Q_GROUPS * 128;
constexpr int KV_STAGES = 2, Q_STAGES = 2;
// accumulator sets of dP: 8 channels each in the dK/dV pass, 16 in the dQ
// pass (see tc32's note above); S takes all D channels in one set
constexpr int KV_DP_SETS = D / 8, Q_DP_SETS = D / 16;

struct KvSmem {
  float k[KB * D];  // K and V as loaded; the warpgroup holds them split in registers
  float v[KB * D];
  float raw[KV_STAGES][2][TILE];  // per slot Q and dO as loaded, split in place into big parts
  float small[2][TILE];           // Q_small, dO_small
  float tr[2][2][TILE];           // Q^T and dO^T (D rows of ROWS queries), each big and small
  float rows[KV_STAGES][2][ROWS];  // per slot the tile's lse and Delta
  uint64_t kv_full;
  uint64_t full[KV_STAGES];
};

struct QSmem {
  float q[2][QB * D];  // Q as loaded, split in place into Q_big; Q_small
  float d_o[2][QB * D];
  struct Group {
    float raw[Q_STAGES][2][TILE];  // per slot K and V as loaded, split in place
    float small[2][TILE];          // K_small, V_small
    float tr[2][TILE];             // K^T big and small
  } wg[Q_GROUPS];
  uint64_t q_full;
  uint64_t full[Q_GROUPS][Q_STAGES];
};

constexpr int KV_SMEM_BYTES = sizeof(KvSmem) + pn::SWIZZLE_ATOM;  // room to align
constexpr int Q_SMEM_BYTES = sizeof(QSmem) + pn::SWIZZLE_ATOM;
static_assert(KV_SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
static_assert(Q_SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
// two dK/dV blocks an SM: at most 228 KB, 1 KB of it per block kept by the
// hardware
static_assert(2 * (KV_SMEM_BYTES + 1024) <= 233472, "two blocks an SM");
// every tile starts on a swizzle atom
static_assert(KB * D * 4 % pn::SWIZZLE_ATOM == 0 && TILE * 4 % pn::SWIZZLE_ATOM == 0, "");
static_assert(sizeof(QSmem::Group) % pn::SWIZZLE_ATOM == 0, "");
// the dQ pass's warpgroup 1's sums reach warpgroup 0 through its first slots
static_assert(sizeof(QSmem::Group::raw) >= D / 2 * 128 * 4, "the slots hold the hand-over");
static_assert(Q_GROUPS == 2, "reduce_write adds the sums of two warpgroups");

// The wgmma descriptor (pn::smem_desc) of a tile of one 128-byte panel
// starts as the low word of its first k-step's, computed once a tile:
// k-step kk lies 32 bytes (2 units of 16) on, and the high word is the same
// for every tile.
__device__ __forceinline__ uint32_t desc_lo(const float* tile) {
  return static_cast<uint32_t>(pn::smem_desc(pn::smem_u32(tile)));
}
__device__ __forceinline__ uint64_t desc_at(uint32_t lo, int kk) {
  return pn::smem_desc(0) >> 32 << 32 | (lo + 2 * kk);
}

// acc (64 x 32, in SETS sets) = A B^T (B: 32 x D), both K-major tiles of one
// panel given by desc_lo of their big and small parts: pn::tc::product_nt
// with the descriptors made once. Not committed.
template <int SETS>
__device__ __forceinline__ void product_nt32(float (&acc)[SETS][16], uint32_t a_big,
                                             uint32_t a_small, uint32_t b_big, uint32_t b_small) {
  constexpr int PER_SET = D / 8 / SETS;  // k-steps of one set
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float(&set)[16] = acc[kk / PER_SET];
    pn::wgmma_m64n32k8_tf32_ss(set, desc_at(a_small, kk), desc_at(b_big, kk), kk % PER_SET != 0);
    pn::wgmma_m64n32k8_tf32_ss(set, desc_at(a_big, kk), desc_at(b_small, kk), 1);
    pn::wgmma_m64n32k8_tf32_ss(set, desc_at(a_big, kk), desc_at(b_big, kk), 1);
  }
}

// acc (64 x 32, in SETS sets) = A B^T (B: 32 x D, K-major, one panel given
// by desc_lo of its big and small parts) with A (64 x D) in registers as the
// big and small TF32 parts of its D / 8 k-steps: pn::tc::product_nt_rs with
// the descriptors made once. Not committed.
template <int SETS>
__device__ __forceinline__ void product_nt_rs32(float (&acc)[SETS][16],
                                                const uint32_t (&a_big)[D / 8][4],
                                                const uint32_t (&a_small)[D / 8][4],
                                                uint32_t b_big, uint32_t b_small) {
  constexpr int PER_SET = D / 8 / SETS;  // k-steps of one set
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float(&set)[16] = acc[kk / PER_SET];
    pn::wgmma_m64n32k8_tf32_rs(set, a_small[kk], desc_at(b_big, kk), kk % PER_SET != 0);
    pn::wgmma_m64n32k8_tf32_rs(set, a_big[kk], desc_at(b_small, kk), 1);
    pn::wgmma_m64n32k8_tf32_rs(set, a_big[kk], desc_at(b_big, kk), 1);
  }
}

// acc (64 x D) = A (64 x 32 rows of a streamed tile; big and small parts in
// registers) times a transposed tile (D rows x 32, given by desc_lo of its
// big and small parts), in a fresh set: pn::tc::product_rs with the
// descriptors made once. Not committed.
__device__ __forceinline__ void product_rs32(float (&acc)[D / 2], const uint32_t (&a_big)[4][4],
                                             const uint32_t (&a_small)[4][4], uint32_t b_big,
                                             uint32_t b_small) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 8; ++kk) {
    pn::wgmma_m64n32k8_tf32_rs(acc, a_small[kk], desc_at(b_big, kk), kk > 0);
    pn::wgmma_m64n32k8_tf32_rs(acc, a_big[kk], desc_at(b_small, kk), 1);
    pn::wgmma_m64n32k8_tf32_rs(acc, a_big[kk], desc_at(b_big, kk), 1);
  }
}

__global__ void __launch_bounds__(KV_THREADS, KV_BLOCKS_PER_SM)
pn_flash_bwd_f32_dkdv_tc32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ d_o,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           const int* __restrict__ kv_lens, int heads, int sq, int skv,
                           int k_tiles, long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  KvSmem& sm = *reinterpret_cast<KvSmem*>(pn::align_smem(smem_raw));

  const Block blk = block_of(blockIdx.x, heads, k_tiles);
  const int b = blk.b, h = blk.h, bh = b * heads + h;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int key0 = blk.tile * KB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // a block whose keys all lie past kv_len streams one tile, all masked
  const int tiles = kv_block_tiles(sq, key0, row_len);
  const long long o_ss = static_cast<long long>(heads) * D;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* dob = d_o + (static_cast<long long>(b) * sq * heads + h) * D;
  const float* lse_b = lse + static_cast<long long>(bh) * sq;
  const float* delta_b = delta + static_cast<long long>(bh) * sq;

  auto load = [&](int i) {  // query tile i
    const int s = i % KV_STAGES, row0 = i * ROWS;
    load_async<ROWS, KV_THREADS>(sm.raw[s][0], qb, q_ss, row0, sq, tid);
    load_async<ROWS, KV_THREADS>(sm.raw[s][1], dob, o_ss, row0, sq, tid);
    if (tid < 2 * ROWS) {  // the rows' lse and Delta, zeros past Sq
      const int r = tid % ROWS;
      const bool in = row0 + r < sq;
      pn::cp_async4(&sm.rows[s][tid / ROWS][r],
                    (tid < ROWS ? lse_b : delta_b) + (in ? row0 + r : 0), in ? 4 : 0);
    }
    pn::cp_async_arrive(&sm.full[s]);
  };
  if (tid == 0) {
    pn::mbar_init(&sm.kv_full, KV_THREADS);
    for (int s = 0; s < KV_STAGES; ++s) pn::mbar_init(&sm.full[s], KV_THREADS);
    pn::mbar_init_fence();
  }
  __syncthreads();
  load_async<KB, KV_THREADS>(sm.k, k + b * k_sb + h * k_sh, k_ss, key0, skv, tid);
  load_async<KB, KV_THREADS>(sm.v, v + b * v_sb + h * v_sh, v_ss, key0, skv, tid);
  pn::cp_async_arrive(&sm.kv_full);
  for (int i = 0; i < min(KV_STAGES, tiles); ++i) load(i);
  pn::mbar_wait(&sm.kv_full, 0);
  // the block's 64 keys as the register A operands of S^T = K Q^T and dP^T = V dO^T, split into their big and
  // small TF32 parts once: the products read only Q and dO from shared
  // memory
  uint32_t k_big[D / 8][4], k_small[D / 8][4], v_big[D / 8][4], v_small[D / 8][4];
  load_a(sm.k, KB, 0, warp, lane, k_big, k_small);
  load_a(sm.v, KB, 0, warp, lane, v_big, v_small);

  // this thread's keys are kr0, kr0 + 8
  const int kr0 = key0 + warp * 16 + g;
  const bool key_ok[2] = {kr0 < row_len, kr0 + 8 < row_len};
  float dk_sum[D / 2], dv_sum[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_sum[i] = dv_sum[i] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    const int st = i % KV_STAGES, q0 = i * ROWS;
    pn::mbar_wait(&sm.full[st], (i / KV_STAGES) & 1);
    split_tile<D, ROWS, true>(sm.raw[st][0], sm.small[0], sm.tr[0][0], sm.tr[0][1], warp, lane);
    split_tile<D, ROWS, true>(sm.raw[st][1], sm.small[1], sm.tr[1][0], sm.tr[1][1], warp, lane);
    pn::tma_store_fence();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 32 queries)
    float s_set[1][16], dp_sets[KV_DP_SETS][16];
    pn::wgmma_fence();
    product_nt_rs32(s_set, k_big, k_small, desc_lo(sm.raw[st][0]), desc_lo(sm.small[0]));
    product_nt_rs32(dp_sets, v_big, v_small, desc_lo(sm.raw[st][1]), desc_lo(sm.small[1]));
    pn::wgmma_commit();
    // the lse (+inf past Sq) and Delta of this thread's queries q0 + 8 n + 2 t + e
    float ls[8], dl[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.rows[st][0][n * 8 + t * 2]);
      const float2 d2 = *reinterpret_cast<const float2*>(&sm.rows[st][1][n * 8 + t * 2]);
      const int qr = q0 + n * 8 + t * 2;
      ls[2 * n] = qr < sq ? l2.x : pos_inf();
      ls[2 * n + 1] = qr + 1 < sq ? l2.y : pos_inf();
      dl[2 * n] = d2.x;
      dl[2 * n + 1] = d2.y;
    }
    pn::wgmma_wait<0>();
    pn::pin(s_set);
    pn::pin(dp_sets);
    float s[16], dp[16];
    sum_sets(s, s_set);  // S's one set
    sum_sets(dp, dp_sets);

    // P^T and dS^T in place; a masked key selects the exponent -inf
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = (j >> 2) * 2 + (j & 1);
      const float pe = wg::ex2(key_ok[(j >> 1) & 1] ? fmaf(s[j], scale_log2, -ls[c])
                                                     : wg::neg_inf());
      s[j] = pe;
      dp[j] = pe * (dp[j] - dl[c]);
    }
    uint32_t p_big[4][4], p_small[4][4], ds_big[4][4], ds_small[4][4];
    to_a(s, p_big, p_small);
    to_a(dp, ds_big, ds_small);

    // dV += P^T dO and dK += dS^T Q, each tile's into a fresh set that the
    // threads add to the sums, rounded to nearest
    float acc_v[D / 2], acc_k[D / 2];
    pn::wgmma_fence();
    product_rs32(acc_v, p_big, p_small, desc_lo(sm.tr[1][0]), desc_lo(sm.tr[1][1]));
    product_rs32(acc_k, ds_big, ds_small, desc_lo(sm.tr[0][0]), desc_lo(sm.tr[0][1]));
    pn::wgmma_commit();
    pn::wgmma_wait<0>();
    pn::pin(acc_v);
    pn::pin(acc_k);
    pn::pin(p_big);
    pn::pin(p_small);
    pn::pin(ds_big);
    pn::pin(ds_small);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      dv_sum[j] += acc_v[j];
      dk_sum[j] += acc_k[j];
    }
    __syncthreads();  // every warp is done with the slot and the derived tiles
    if (i + KV_STAGES < tiles) load(i + KV_STAGES);
  }

  // keys past the row's length get zeros; rows past Skv are not written
  const long long base = (static_cast<long long>(b) * skv * heads + h) * D;
  write_rows(dv_sum, dv + base, o_ss, 1.f, kr0, skv, t);
  write_rows(dk_sum, dk + base, o_ss, scale, kr0, skv, t);
}

__global__ void __launch_bounds__(Q_THREADS, 2)
pn_flash_bwd_f32_dq_tc32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, const int* __restrict__ kv_lens, int heads,
                         int sq, int skv, int q_tiles, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh, float scale,
                         float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  QSmem& sm = *reinterpret_cast<QSmem*>(pn::align_smem(smem_raw));

  const Block blk = block_of(blockIdx.x, heads, q_tiles);
  const int b = blk.b, h = blk.h, bh = b * heads + h;
  const int row_len = pn::row_keys(kv_lens, b, skv);
  scale = pn::row_scale(kv_lens, b, scale);
  scale_log2 = pn::row_scale(kv_lens, b, scale_log2);
  const int row0 = blk.tile * QB;
  const int group = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the key tiles below kv_len, taken in turn by the warpgroups
  const int my_tiles = group_tiles(q_block_tiles(row_len), group, Q_GROUPS);
  QSmem::Group& w = sm.wg[group];
  const long long o_ss = static_cast<long long>(heads) * D;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  auto load = [&](int i) {  // this warpgroup's key tile i, by its 128 threads
    const int s = i % Q_STAGES, key0 = tile_row(i, group, Q_GROUPS);
    load_async<ROWS, 128>(w.raw[s][0], kb, k_ss, key0, skv, tid);
    load_async<ROWS, 128>(w.raw[s][1], vb, v_ss, key0, skv, tid);
    pn::cp_async_arrive(&sm.full[group][s]);
  };
  if (threadIdx.x == 0) {
    pn::mbar_init(&sm.q_full, Q_THREADS);
    for (int gr = 0; gr < Q_GROUPS; ++gr)
      for (int s = 0; s < Q_STAGES; ++s) pn::mbar_init(&sm.full[gr][s], 128);
    pn::mbar_init_fence();
  }
  __syncthreads();
  load_async<QB, Q_THREADS>(sm.q[0], q + b * q_sb + h * q_sh, q_ss, row0, sq, threadIdx.x);
  load_async<QB, Q_THREADS>(sm.d_o[0], d_o + (static_cast<long long>(b) * sq * heads + h) * D,
                            o_ss, row0, sq, threadIdx.x);
  pn::cp_async_arrive(&sm.q_full);
  for (int i = 0; i < min(Q_STAGES, my_tiles); ++i) load(i);
  pn::mbar_wait(&sm.q_full, 0);
  split_tile<D, QB, false, true, 4 * Q_GROUPS>(sm.q[0], sm.q[1], nullptr, nullptr,
                                               threadIdx.x >> 5, lane);
  split_tile<D, QB, false, true, 4 * Q_GROUPS>(sm.d_o[0], sm.d_o[1], nullptr, nullptr,
                                               threadIdx.x >> 5, lane);
  pn::tma_store_fence();
  __syncthreads();

  // every warpgroup owns the block's 64 rows; this thread's are r0, r0 + 8
  const int r0 = row0 + warp * 16 + g;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    row_lse[r] = row < sq ? lse[static_cast<long long>(bh) * sq + row] : pos_inf();
    row_delta[r] = row < sq ? delta[static_cast<long long>(bh) * sq + row] : 0.f;
  }
  const uint32_t qbig = desc_lo(sm.q[0]), qsmall = desc_lo(sm.q[1]);
  const uint32_t obig = desc_lo(sm.d_o[0]), osmall = desc_lo(sm.d_o[1]);
  float dq_sum[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_sum[i] = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    const int st = i % Q_STAGES, key0 = tile_row(i, group, Q_GROUPS);
    pn::mbar_wait(&sm.full[group][st], (i / Q_STAGES) & 1);
    split_tile<D, ROWS, true>(w.raw[st][0], w.small[0], w.tr[0], w.tr[1], warp, lane);
    split_tile<D, ROWS, false>(w.raw[st][1], w.small[1], nullptr, nullptr, warp, lane);
    pn::tma_store_fence();
    pn::group_sync(group);

    // S = Q K^T and dP = dO V^T (64 rows x 32 keys)
    float s_set[1][16], dp_sets[Q_DP_SETS][16];
    pn::wgmma_fence();
    product_nt32(s_set, qbig, qsmall, desc_lo(w.raw[st][0]), desc_lo(w.small[0]));
    product_nt32(dp_sets, obig, osmall, desc_lo(w.raw[st][1]), desc_lo(w.small[1]));
    pn::wgmma_commit();
    pn::wgmma_wait<0>();
    pn::pin(s_set);
    pn::pin(dp_sets);
    float s[16], dp[16];
    sum_sets(s, s_set);  // S's one set
    sum_sets(dp, dp_sets);

    // dS in place; keys from row_len on select the exponent -inf
    const int limit = row_len - key0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = (j >> 1) & 1, col = (j >> 2) * 8 + t * 2 + (j & 1);
      const float pe =
          wg::ex2(col < limit ? fmaf(s[j], scale_log2, -row_lse[r]) : wg::neg_inf());
      dp[j] = pe * (dp[j] - row_delta[r]);
    }
    uint32_t ds_big[4][4], ds_small[4][4];
    to_a(dp, ds_big, ds_small);

    // dQ += dS K, the tile's into a fresh set added to the sums
    float acc[D / 2];
    pn::wgmma_fence();
    product_rs32(acc, ds_big, ds_small, desc_lo(w.tr[0]), desc_lo(w.tr[1]));
    pn::wgmma_commit();
    pn::wgmma_wait<0>();
    pn::pin(acc);
    pn::pin(ds_big);
    pn::pin(ds_small);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq_sum[j] += acc[j];
    pn::group_sync(group);  // every warp is done with the slot and the derived tiles
    if (i + Q_STAGES < my_tiles) load(i + Q_STAGES);
  }

  __syncthreads();
  reduce_write(&sm.wg[0].raw[0][0][0], dq_sum, group, tid,
               dq + (static_cast<long long>(b) * sq * heads + h) * D, o_ss, scale, r0, sq, t);
}

// st: the strides of q, k and v as the C entry takes them; o, d_o, dq, dk
// and dv contiguous
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* delta, void* dq, void* dk, void* dv, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* st, float scale,
           cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      pn_flash_bwd_f32_dkdv_tc32, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM_BYTES);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      pn_flash_bwd_f32_dq_tc32, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM_BYTES);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const long long bh = static_cast<long long>(batch) * heads;
  const int k_tiles = (skv + KB - 1) / KB, q_tiles = (sq + QB - 1) / QB;
  if (bh < 1 || bh * k_tiles > 2147483647LL || bh * q_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dop = static_cast<const float*>(d_o);
  const auto* lens = static_cast<const int*>(kv_lens);
  const long long rows = bh * sq;
  f32::pn_flash_bwd_f32_delta<D><<<static_cast<unsigned>((rows * (D / 4) + 255) / 256), 256, 0,
                                   stream>>>(static_cast<const float*>(o), dop,
                                             static_cast<float*>(delta), heads, sq, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_f32_dkdv_tc32<<<static_cast<unsigned>(bh * k_tiles), KV_THREADS, KV_SMEM_BYTES,
                               stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), lens, heads, sq, skv, k_tiles, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  pn_flash_bwd_f32_dq_tc32<<<static_cast<unsigned>(bh * q_tiles), Q_THREADS, Q_SMEM_BYTES,
                             stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), lens, heads, sq, skv, q_tiles, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc32

}  // namespace

// q, k, v: bf16 (B, S, H, D) views, strides {q_b, q_s, q_h, k_b, k_s, k_h,
// v_b, v_s, v_h} in elements (multiples of 8), unit head-dim stride; o, d_o,
// dq (B, Sq, H, D) and dk, dv (B, Skv, H, D) contiguous bf16; lse (the
// forward's) and delta (scratch) fp32 (B, H, Sq); kv_lens (B,) int32 or null.
// maps: the tensor-map specs of wg::launch (the bf16 kernels read q, k, v
// and dO through them; the strides serve the fp32 entry's kernels).
// Returns a cudaError_t value: of the set-up, or cudaGetLastError() after the
// last launch.
extern "C" int pn_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                           const void* o, const void* d_o, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv,
                                           const void* kv_lens, int batch, int heads, int sq,
                                           int skv, int d, const long long* strides,
                                           const long long* maps, float scale, void* stream) {
  (void)strides;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wg::launch<16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, maps, scale, s);
    case 32: return wg::launch<32>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, maps, scale, s);
    case 64: return wg::launch<64>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, maps, scale, s);
    case 128: return wg::launch<128>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, maps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 entry: the same arguments; every tensor is fp32, strides in
// elements of fp32 (multiples of 4, 16 bytes). maps: the tensor-map specs of
// tc::launch, used at d = 64 (null otherwise); tc32 (d = 32) reads through
// the strides.
extern "C" int pn_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                          const void* o, const void* d_o, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv,
                                          const void* kv_lens, int batch, int heads, int sq,
                                          int skv, int d, const long long* strides,
                                          const long long* maps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return tc::launch(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, maps, scale, s);
    case 16: return f32::launch<16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    case 32: return tc32::launch(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    case 128: return f32::launch<128>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
