// The building blocks of the fp32 flash kernels on the tensor cores: the
// forward (tc::pn_flash_f32_fwd_tc, flash_attention.cu) and both passes of
// the backward (tc::pn_flash_bwd_f32_{dkdv,dq}_tc, flash_attention_bwd.cu).
// Each product is 3xTF32 on wgmma (pn::tf32_split: each operand a big and a
// small TF32 part, the three larger of the four products summed); the
// operands are fp32 tiles of 64 channels laid down by TMA as two 32-column
// panels of 128-byte rows with the 128-byte swizzle, split in shared memory
// or, for a register A operand, as they are read into registers.

#pragma once

#include "hopper.cuh"

namespace pn {
namespace tc {

constexpr int D = 64;
constexpr int T = 32;          // rows per streamed tile
constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int PANEL = 32;      // fp32 values of one 128-byte swizzled row
constexpr int TILE = T * D;    // floats of a streamed tile, and of a transposed one

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

// rows [row0, row0 + rows) of one head of a (B, S, H, 64) fp32 tensor into a
// tile of two 32-column panels, in 32-row boxes; rows past S arrive as zeros
__device__ __forceinline__ void load_rows(float* dst, int rows, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row0, int b) {
  for (int p = 0; p < 2; ++p)
    for (int r = 0; r < rows; r += T)
      tma_load_4d(dst + p * rows * PANEL + r * PANEL, map, bar, p * PANEL, h, row0 + r, b);
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

// A streamed (32 x 64) tile, by WARPS warps: with DIRECT split in place, the
// small part beside it; with TRANSPOSE the transposed copy (64 rows of d, the
// tile rows permuted by perm_col), big and small. Lane = tile row, and warp w
// takes 16 / WARPS of the tile's 16 columns of 16-byte chunks, so that the
// reads and the transposed writes of a warp fall on distinct banks.
template <bool TRANSPOSE, bool DIRECT = true, int WARPS = 4>
__device__ __forceinline__ void split_tile(float* raw, float* small, float* tr_big,
                                           float* tr_small, int warp, int lane) {
  constexpr int CHUNKS = 16 / WARPS;
  const int jj = perm_col(lane);
#pragma unroll
  for (int e = 0; e < CHUNKS; ++e) {
    const int c = warp * CHUNKS + e;  // columns 4 c .. 4 c + 3, in panel c / 8
    const int off = (c >> 3) * T * PANEL + swz(lane, (c & 7) * 4);
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
        tr_big[swz(c * 4 + i, jj)] = hs[i];
        tr_small[swz(c * 4 + i, jj)] = ls[i];
      }
    }
  }
}

// acc (64 x 32) = A (64 x 64) B^T (B: 32 x 64), both K-major in two 32-column
// panels (`a_panel`, `b_panel`: bytes from one panel to the next), each as
// big and small parts: 8 k-steps of three products, every D / SETS channels
// into a fresh accumulator set, which sum_sets adds. Not committed.
template <int SETS>
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

// The same product with A (64 x 64) in registers, as the big and small TF32
// parts of the A operands of its 8 k-steps (`a_big`, `a_small`, the fragment
// layout of wgmma_m64n32k8_tf32_rs): only B is read from shared memory.
template <int SETS>
__device__ __forceinline__ void product_nt_rs(float (&acc)[SETS][16],
                                              const uint32_t (&a_big)[D / 8][4],
                                              const uint32_t (&a_small)[D / 8][4],
                                              uint32_t b_big, uint32_t b_small, int b_panel) {
  constexpr int PER_SET = D / 8 / SETS;  // k-steps of one set
  static_assert(PER_SET * SETS * 8 == D, "the sets divide the channels");
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float(&set)[16] = acc[kk / PER_SET];
    const int bo = (kk >> 2) * b_panel + (kk & 3) * 32;
    wgmma_m64n32k8_tf32_rs(set, a_small[kk], smem_desc(b_big + bo), kk % PER_SET != 0);
    wgmma_m64n32k8_tf32_rs(set, a_big[kk], smem_desc(b_small + bo), 1);
    wgmma_m64n32k8_tf32_rs(set, a_big[kk], smem_desc(b_big + bo), 1);
  }
}

// The register A operands of product_nt_rs for this thread (lane `lane` of
// warp `warp` of its warpgroup) from rows [row0, row0 + 64) of a resident
// fp32 tile of `rows` rows in two 32-column panels, as TMA laid it down:
// a[kk][0], a[kk][1] rows 16 warp + lane / 4 and 8 further on at channel
// 8 kk + lane % 4, a[kk][2], a[kk][3] the same rows 4 channels further on;
// each value split into its big and small TF32 parts.
__device__ __forceinline__ void load_a(const float* tile, int rows, int row0, int warp, int lane,
                                       uint32_t (&big)[D / 8][4], uint32_t (&small)[D / 8][4]) {
  const int r = row0 + warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
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
template <int SETS>
__device__ __forceinline__ void sum_sets(float (&out)[16], const float (&acc)[SETS][16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    out[j] = acc[0][j];
#pragma unroll
    for (int c = 1; c < SETS; ++c) out[j] += acc[c][j];
  }
}

// acc (64 x 64) = A (64 x 32; big and small parts in registers, four k8
// steps) times a transposed tile (64 rows x 32, big and small), in a fresh
// accumulator set. Not committed.
__device__ __forceinline__ void product_rs(float (&acc)[32], const uint32_t (&a_big)[4][4],
                                           const uint32_t (&a_small)[4][4], uint32_t b_big,
                                           uint32_t b_small) {
#pragma unroll
  for (int kk = 0; kk < T / 8; ++kk) {
    wgmma_m64n64k8_tf32_rs(acc, a_small[kk], smem_desc(b_big + kk * 32), kk > 0);
    wgmma_m64n64k8_tf32_rs(acc, a_big[kk], smem_desc(b_small + kk * 32), 1);
    wgmma_m64n64k8_tf32_rs(acc, a_big[kk], smem_desc(b_big + kk * 32), 1);
  }
}

// x (64 x 32 in the accumulator layout) as the big and small TF32 parts of
// the register A operands of four k8 steps: a[0], a[1] the rows g, g + 8 at
// column 2t (logical k = t), a[2], a[3] at column 2t + 1 (k = t + 4)
__device__ __forceinline__ void to_a(const float (&x)[16], uint32_t (&big)[4][4],
                                     uint32_t (&small)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float hi, lo;
      tf32_split(x[kk * 4 + (e == 1 ? 2 : e == 2 ? 1 : e)], hi, lo);
      big[kk][e] = __float_as_uint(hi);
      small[kk][e] = __float_as_uint(lo);
    }
}

// The (64 x 64) sums of warpgroup 1 go through shared memory (`red`, 32 KB)
// to warpgroup 0, which adds them to its own, always in this order, and
// writes its rows r0, r0 + 8 (those below `rows`) of a (B, S, H, 64) fp32
// tensor, times `scale`.
__device__ __forceinline__ void reduce_write(float* red, float (&sum)[32], int group, int tid,
                                             float* base, long long row_stride, float scale,
                                             int r0, int rows, int t) {
  if (group == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) red[i * 128 + tid] = sum[i];
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] += red[i * 128 + tid];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < rows) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(base + row * row_stride + n * 8 + t * 2) =
              make_float2(sum[n * 4 + r * 2] * scale, sum[n * 4 + r * 2 + 1] * scale);
      }
    }
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace pn
