// The building blocks of the fp32 flash kernels on the tensor cores: the
// forwards (tc::pn_flash_f32_fwd_tc at head dim 64, tc32::pn_flash_f32_fwd_tc32
// at head dim 32, flash_attention.cu) and both passes of the backward
// (tc::pn_flash_bwd_f32_{dkdv,dq}_tc at head dim 64,
// tc32::pn_flash_bwd_f32_{dkdv,dq}_tc32 at head dim 32,
// flash_attention_bwd.cu). Each product is 3xTF32 on wgmma (pn::tf32_split:
// each operand a big and a small TF32 part, the three larger of the four
// products summed); the operands are fp32 tiles of D channels (D / 32
// panels of 128-byte rows with the 128-byte swizzle: two at D 64, one at
// D 32), laid down by TMA or cp.async, split in shared memory or, for a
// register A operand, as they are read into registers. The head dim and the
// tile shapes are template arguments, deduced from the register arrays where
// a function has them.

#pragma once

#include "hopper.cuh"

namespace pn {
namespace tc {

constexpr int T = 32;          // rows per streamed tile of the head-dim-64 kernels
constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int PANEL = 32;      // fp32 values of one 128-byte swizzled row

// Float offset of (row, col) in a panel of 128-byte rows laid down with the
// 128-byte swizzle: the 16-byte chunk c of row r lies at chunk c ^ (r % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return row * PANEL + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

// The contraction index of the transposed copies is permuted within each 8:
// the register A operand of a k8 step holds k = t and t + 4 of a row where
// the accumulator holds columns 2t and 2t + 1, so logical k = 8 n + j holds
// tile row 8 n + (0 2 4 6 1 3 5 7)[j]. This is the logical k of tile row r.
__device__ __forceinline__ int perm_col(int r) {
  const int a = r & 7;
  return (r & ~7) | (a >> 1) | ((a & 1) << 2);
}

// rows [row0, row0 + rows) of one head of a (B, S, H, D) fp32 tensor into a
// tile of D / 32 panels, in 32-row boxes; rows past S arrive as zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int rows, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row0, int b) {
  for (int p = 0; p < D / PANEL; ++p)
    for (int r = 0; r < rows; r += T)
      tma_load_4d(dst + p * rows * PANEL + r * PANEL, map, bar, p * PANEL, h, row0 + r, b);
}

// rows [row0, row0 + ROWS) of a strided (rows, 32) fp32 view into a tile of
// 128-byte swizzled rows (head dim 32: one panel), by THREADS threads, this
// one `tid`, with cp.async; rows from `limit` on arrive as zeros
template <int ROWS, int THREADS = NTHREADS>
__device__ __forceinline__ void load_async(float* dst, const float* src, long long stride,
                                           int row0, int limit, int tid) {
  static_assert(ROWS * 8 % THREADS == 0, "the threads divide the tile's 16-byte chunks");
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c >> 3, ch = c & 7;
    const bool in = row0 + r < limit;
    cp_async16(dst + swz(r, ch * 4), in ? src + (row0 + r) * stride + ch * 4 : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void split4(const float4 v, float4& hi, float4& lo) {
  tf32_split(v.x, hi.x, lo.x);
  tf32_split(v.y, hi.y, lo.y);
  tf32_split(v.z, hi.z, lo.z);
  tf32_split(v.w, hi.w, lo.w);
}

// A resident tile of `n` floats split in place into its big part, the small
// part beside it at the same offsets (so the swizzle needs no care)
__device__ __forceinline__ void split_flat(float* big, float* small, int n) {
  float4* b4 = reinterpret_cast<float4*>(big);
  float4* s4 = reinterpret_cast<float4*>(small);
  for (int i = threadIdx.x; i < n / 4; i += NTHREADS) {
    float4 hi, lo;
    split4(b4[i], hi, lo);
    b4[i] = hi;
    s4[i] = lo;
  }
}

// A streamed (ROWS x D) tile, by WARPS warps: with DIRECT split in place, the
// small part beside it; with TRANSPOSE the transposed copy (D rows of d; the
// tile rows permuted by perm_col, each band of 32 rows a panel of its own),
// big and small. Lane = row within a band of 32, and the tile's (band,
// 16-byte chunk) pairs are dealt to the warps in order, so that the reads and
// the transposed writes of a warp fall on distinct banks.
template <int D, int ROWS, bool TRANSPOSE, bool DIRECT = true, int WARPS = 4>
__device__ __forceinline__ void split_tile(float* raw, float* small, float* tr_big,
                                           float* tr_small, int warp, int lane) {
  constexpr int CH = D / 4;                    // 16-byte chunks of a row
  constexpr int PER = ROWS / 32 * CH / WARPS;  // (band, chunk) pairs of a warp
  static_assert(PER * WARPS * 32 == ROWS * CH, "the warps divide the tile");
  const int jj = perm_col(lane);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    // columns 4 c .. 4 c + 3 of rows 32 band .. 32 band + 31 (a tile of 32
    // rows is one band: its chunk index needs no division)
    const int pair = warp * PER + e, band = ROWS == 32 ? 0 : pair / CH;
    const int c = ROWS == 32 ? pair : pair % CH;
    const int off = (c >> 3) * ROWS * PANEL + swz(band * 32 + lane, (c & 7) * 4);
    float4 hi, lo;
    split4(*reinterpret_cast<const float4*>(raw + off), hi, lo);
    if constexpr (DIRECT) {
      *reinterpret_cast<float4*>(raw + off) = hi;
      *reinterpret_cast<float4*>(small + off) = lo;
    }
    if constexpr (TRANSPOSE) {
      const float hs[4] = {hi.x, hi.y, hi.z, hi.w}, ls[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr_big[band * D * PANEL + swz(c * 4 + i, jj)] = hs[i];
        tr_small[band * D * PANEL + swz(c * 4 + i, jj)] = ls[i];
      }
    }
  }
}

// d (64 x N) = or += A (64 x 8, TF32 in registers) B^T (B: N x 8, shared,
// K-major), N = 2 M: 32 or 64
template <int M>
__device__ __forceinline__ void mma_rs(float (&d)[M], const uint32_t (&a)[4], uint64_t desc_b,
                                       int accumulate) {
  static_assert(M == 16 || M == 32, "N is 32 or 64");
  if constexpr (M == 32) wgmma_m64n64k8_tf32_rs(d, a, desc_b, accumulate);
  else wgmma_m64n32k8_tf32_rs(d, a, desc_b, accumulate);
}

// acc (64 x 32) = A (64 x D) B^T (B: 32 x D), both K-major in D / 32 panels
// (`a_panel`, `b_panel`: bytes from one panel to the next), each as big and
// small parts: D / 8 k-steps of three products, every D / SETS channels into
// a fresh accumulator set, which sum_sets adds. Not committed.
template <int D, int SETS>
__device__ __forceinline__ void product_nt(float (&acc)[SETS][16], uint32_t a_big,
                                           uint32_t a_small, int a_panel, uint32_t b_big,
                                           uint32_t b_small, int b_panel) {
  constexpr int PER_SET = D / 8 / SETS;  // k-steps of one set
  static_assert(PER_SET * SETS * 8 == D, "the sets divide the channels");
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float(&set)[16] = acc[kk / PER_SET];
    const int ao = (kk >> 2) * a_panel + (kk & 3) * 32, bo = (kk >> 2) * b_panel + (kk & 3) * 32;
    wgmma_m64n32k8_tf32_ss(set, smem_desc(a_small + ao), smem_desc(b_big + bo),
                           kk % PER_SET != 0);
    wgmma_m64n32k8_tf32_ss(set, smem_desc(a_big + ao), smem_desc(b_small + bo), 1);
    wgmma_m64n32k8_tf32_ss(set, smem_desc(a_big + ao), smem_desc(b_big + bo), 1);
  }
}

// acc (64 x 2 M) = A (64 x D, D = 8 KS) B^T (B: 2 M x D, K-major in D / 32
// panels `b_panel` bytes apart) with A in registers, as the big and small
// TF32 parts of the A operands of its KS k-steps (`a_big`, `a_small`, the
// fragment layout of wgmma_m64n64k8_tf32_rs): only B is read from shared
// memory. Every D / SETS channels go into a fresh accumulator set.
template <int SETS, int M, int KS>
__device__ __forceinline__ void product_nt_rs(float (&acc)[SETS][M],
                                              const uint32_t (&a_big)[KS][4],
                                              const uint32_t (&a_small)[KS][4],
                                              uint32_t b_big, uint32_t b_small, int b_panel) {
  constexpr int PER_SET = KS / SETS;  // k-steps of one set
  static_assert(PER_SET * SETS == KS, "the sets divide the channels");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float(&set)[M] = acc[kk / PER_SET];
    const int bo = (kk >> 2) * b_panel + (kk & 3) * 32;
    mma_rs(set, a_small[kk], smem_desc(b_big + bo), kk % PER_SET != 0);
    mma_rs(set, a_big[kk], smem_desc(b_small + bo), 1);
    mma_rs(set, a_big[kk], smem_desc(b_big + bo), 1);
  }
}

// The register A operands of product_nt_rs for this thread (lane `lane` of
// warp `warp` of its warpgroup) from rows [row0, row0 + 64) of a resident
// fp32 tile of `rows` rows in D / 32 panels (D = 8 KS), as TMA laid it
// down: a[kk][0], a[kk][1] rows 16 warp + lane / 4 and 8 further on at
// channel 8 kk + lane % 4, a[kk][2], a[kk][3] the same rows 4 channels
// further on; each value split into its big and small TF32 parts.
template <int KS>
__device__ __forceinline__ void load_a(const float* tile, int rows, int row0, int warp, int lane,
                                       uint32_t (&big)[KS][4], uint32_t (&small)[KS][4]) {
  const int r = row0 + warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + (e & 1) * 8, col = (kk & 3) * 8 + t + (e >> 1) * 4;
      float hi, lo;
      tf32_split(tile[(kk >> 2) * rows * PANEL + swz(row, col)], hi, lo);
      big[kk][e] = __float_as_uint(hi);
      small[kk][e] = __float_as_uint(lo);
    }
}

// the sets of product_nt added in order, rounded to nearest
template <int SETS, int M>
__device__ __forceinline__ void sum_sets(float (&out)[M], const float (&acc)[SETS][M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    out[j] = acc[0][j];
#pragma unroll
    for (int c = 1; c < SETS; ++c) out[j] += acc[c][j];
  }
}

// acc (64 x D, D = 2 M) = A (64 x 8 KS; big and small parts in registers,
// KS k8 steps) times a transposed tile (D rows x 8 KS, big and small; each
// 32 of the contraction a panel of D rows), in a fresh accumulator set. Not
// committed.
template <int M, int KS>
__device__ __forceinline__ void product_rs(float (&acc)[M], const uint32_t (&a_big)[KS][4],
                                           const uint32_t (&a_small)[KS][4], uint32_t b_big,
                                           uint32_t b_small) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int bo = (kk >> 2) * 2 * M * SWIZZLE_BYTES + (kk & 3) * 32;
    mma_rs(acc, a_small[kk], smem_desc(b_big + bo), kk > 0);
    mma_rs(acc, a_big[kk], smem_desc(b_small + bo), 1);
    mma_rs(acc, a_big[kk], smem_desc(b_big + bo), 1);
  }
}

// x (64 x 2 M in the accumulator layout) as the big and small TF32 parts of
// the register A operands of M / 4 k8 steps: a[0], a[1] the rows g, g + 8 at
// column 2t (logical k = t), a[2], a[3] at column 2t + 1 (k = t + 4)
template <int M>
__device__ __forceinline__ void to_a(const float (&x)[M], uint32_t (&big)[M / 4][4],
                                     uint32_t (&small)[M / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < M / 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float hi, lo;
      tf32_split(x[kk * 4 + (e == 1 ? 2 : e == 2 ? 1 : e)], hi, lo);
      big[kk][e] = __float_as_uint(hi);
      small[kk][e] = __float_as_uint(lo);
    }
}

// A warpgroup's (64 x D, D = 2 M) sums: this thread's rows r0, r0 + 8 (those
// below `rows`) of a (B, S, H, D) fp32 tensor, times `scale`.
template <int M>
__device__ __forceinline__ void write_rows(const float (&sum)[M], float* base,
                                           long long row_stride, float scale, int r0, int rows,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < rows) {
#pragma unroll
      for (int n = 0; n < M / 4; ++n)
        *reinterpret_cast<float2*>(base + row * row_stride + n * 8 + t * 2) =
            make_float2(sum[n * 4 + r * 2] * scale, sum[n * 4 + r * 2 + 1] * scale);
    }
  }
}

// The (64 x D, D = 2 M) sums of warpgroup 1 go through shared memory
// (`red`, 128 M floats) to warpgroup 0, which adds them to its own, always in
// this order, and writes them (write_rows).
template <int M>
__device__ __forceinline__ void reduce_write(float* red, float (&sum)[M], int group, int tid,
                                             float* base, long long row_stride, float scale,
                                             int r0, int rows, int t) {
  if (group == 1) {
#pragma unroll
    for (int i = 0; i < M; ++i) red[i * 128 + tid] = sum[i];
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) sum[i] += red[i * 128 + tid];
    write_rows(sum, base, row_stride, scale, r0, rows, t);
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace pn
