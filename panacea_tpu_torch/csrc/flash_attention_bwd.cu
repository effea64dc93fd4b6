// Flash attention backward for Hopper (sm_90a): bf16 q, k, v, o, dO in, bf16
// dq, dk, dv out, on the tensor cores (mma.sync m16n8k16, fp32 accumulation).
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
// at level 2 (Sq 128).
//
// The design (FA2's, deterministic, no atomics): three launches.
//  1. pn_flash_bwd_delta: Delta = rowsum(dO * O), D / 8 lanes a row.
//  2. pn_flash_bwd_dkdv: one block of 4 warps per (64 keys, head, batch row);
//     a warp owns 16 keys. The block walks over the query tiles of 64 rows,
//     staging Q and dO (and the tile's lse and Delta) in padded shared
//     memory, and recomputes S^T = K Q^T and dP^T = V dO^T with the keys as
//     rows, so that P^T and dS^T land in registers in the accumulator layout
//     and serve, rounded to bf16, as the A operands of dV += P^T dO and
//     dK += dS^T Q, which stay in fp32 registers for the whole walk.
//     Key tiles past the row's kv_len write zeros and stop; masked keys
//     inside a tile get P = 0, so their dK and dV are zero.
//  3. pn_flash_bwd_dq: one block of 4 warps per (64 query rows, head, batch
//     row); a warp owns 16 rows. The block walks over the key tiles below
//     kv_len, staging K and V, recomputes S = Q K^T and dP = dO V^T and adds
//     dS K into fp32 registers.
// A simple kernel: plain 16-byte loads into padded shared memory, no TMA, no
// wgmma, no overlap of loads with products inside a block (the blocks an SM
// holds overlap each other). fp32 operands have no backward kernel yet.

#include "hopper.cuh"

namespace {

constexpr int BT = 64;        // rows per tile: keys (dk/dv) or queries (dq)
constexpr int NTHREADS = 128; // 4 warps x 16 rows

// the lse of a padded query row: its P = exp2(x - inf) = 0
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// the padded row of a shared-memory tile: fragment reads hit distinct banks
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }

// four (64, D) bf16 tiles and two rows of 64 floats
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * BT * ld<D>() * 2 + 2 * BT * 4;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a (rows, D) view with row stride `stride` into a
// padded shared-memory tile; rows from `rows` on arrive as zeros
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      long long stride, int row0, int rows) {
  constexpr int CH = D / 8;  // 16-byte pieces a row
  for (int c = threadIdx.x; c < BT * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<uint4*>(dst + r * ld<D>() + col) = val;
  }
}

// The A fragment (16 rows x 16 columns, columns kk * 16..) of a padded tile
// whose warp rows start at `row0`.
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + g) * ld<D>() + kk * 16 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld<D>());
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld<D>() + 8);
}

// acc (16 x 64) = A (16 rows of `a_tile` from a_row0, D wide) times the
// transpose of `b_tile` (64 rows, D wide): both operands row-major along D.
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[BT / 8][4], const __nv_bfloat16* a_tile,
                                           int a_row0, const __nv_bfloat16* b_tile, int g,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag<D>(a, a_tile, a_row0, kk, g, t);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const __nv_bfloat16* br = b_tile + (nt * 8 + g) * ld<D>() + kk * 16 + t * 2;
      mma_bf16(acc[nt], a, ld32(br), ld32(br + 8));
    }
  }
}

// out (16 x D) += P (16 x 64, in the accumulator layout, rounded to bf16)
// times `b_tile` (64 rows, D wide).
template <int D>
__device__ __forceinline__ void product_nn(float (&out)[D / 8][4], const float (&p)[BT / 8][4],
                                           const __nv_bfloat16* b_tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t a[4];
    a[0] = pn::pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pn::pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pn::pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pn::pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* br = b_tile + (kk * 16 + t * 2) * ld<D>() + dt * 8 + g;
      mma_bf16(out[dt], a, pack_bf16(br[0], br[ld<D>()]),
               pack_bf16(br[8 * ld<D>()], br[9 * ld<D>()]));
    }
  }
}

// (16 x D) fp32 rows g and g + 8 of a warp, scaled, as bf16 into a (B, S, H, D)
// contiguous tensor at rows r0 and r0 + 8 (those below `rows`)
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* base, long long row_stride,
                                           const float (&acc)[D / 8][4], float scale, int r0,
                                           int rows, int t) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(base + r0 * row_stride + c) =
          pn::pack_bf16x2(acc[dt][0] * scale, acc[dt][1] * scale);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * row_stride + c) =
          pn::pack_bf16x2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ------------------------------------------------------------------ Delta

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

// ------------------------------------------------------------------ dK, dV

template <int D>
__global__ void __launch_bounds__(NTHREADS)
pn_flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  const int* __restrict__ kv_lens, int heads, int sq, int skv, long long q_sb,
                  long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh, float scale,
                  float scale_log2) {
  extern __shared__ uint4 smem_bwd[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* vs = ks + BT * ld<D>();
  __nv_bfloat16* qs = vs + BT * ld<D>();
  __nv_bfloat16* dos = qs + BT * ld<D>();
  float* lse_s = reinterpret_cast<float*>(dos + BT * ld<D>());
  float* delta_s = lse_s + BT;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_len = kv_lens ? max(1, min(kv_lens[b], skv)) : skv;
  const int key0 = blockIdx.x * BT;
  const long long o_ss = static_cast<long long>(heads) * D;  // row stride of (B, S, H, D)
  __nv_bfloat16* dkb = dk + (static_cast<long long>(b) * skv * heads + h) * D;
  __nv_bfloat16* dvb = dv + (static_cast<long long>(b) * skv * heads + h) * D;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  const int kr0 = key0 + warp * 16 + g;  // this thread's keys kr0 and kr0 + 8

  if (key0 < row_len) {
    stage<D>(ks, k + b * k_sb + h * k_sh, k_ss, key0, skv);
    stage<D>(vs, v + b * v_sb + h * v_sh, v_ss, key0, skv);
    const bool key_ok[2] = {kr0 < row_len, kr0 + 8 < row_len};
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* dob = d_o + (static_cast<long long>(b) * sq * heads + h) * D;
    const float* lse_b = lse + static_cast<long long>(bh) * sq;
    const float* delta_b = delta + static_cast<long long>(bh) * sq;
    for (int q0 = 0; q0 < sq; q0 += BT) {
      __syncthreads();  // every warp is done with the previous query tile
      stage<D>(qs, qb, q_ss, q0, sq);
      stage<D>(dos, dob, o_ss, q0, sq);
      if (threadIdx.x < BT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse_b[r] : pos_inf();
        delta_s[threadIdx.x] = r < sq ? delta_b[r] : 0.f;
      }
      __syncthreads();

      // P^T and dS^T, keys as rows: (16 keys x 64 queries) in registers
      float p[BT / 8][4], ds[BT / 8][4];
      product_nt<D>(p, ks, warp * 16, qs, g, t);
      product_nt<D>(ds, vs, warp * 16, dos, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + t * 2 + (e & 1);  // the query of this element
          const float pe =
              key_ok[e >> 1] ? exp2f(fmaf(p[nt][e], scale_log2, -lse_s[col])) : 0.f;
          p[nt][e] = pe;
          ds[nt][e] = pe * (ds[nt][e] - delta_s[col]);
        }
      product_nn<D>(dv_acc, p, dos, g, t);
      product_nn<D>(dk_acc, ds, qs, g, t);
    }
  }
  // keys past the row's length (and whole tiles of them) get zeros
  write_rows<D>(dvb, o_ss, dv_acc, 1.f, kr0, skv, t);
  write_rows<D>(dkb, o_ss, dk_acc, scale, kr0, skv, t);
}

// ------------------------------------------------------------------ dQ

template <int D>
__global__ void __launch_bounds__(NTHREADS)
pn_flash_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_lens, int heads,
                int sq, int skv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                float scale, float scale_log2) {
  extern __shared__ uint4 smem_bwd[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* vs = ks + BT * ld<D>();
  __nv_bfloat16* qs = vs + BT * ld<D>();
  __nv_bfloat16* dos = qs + BT * ld<D>();

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_len = kv_lens ? max(1, min(kv_lens[b], skv)) : skv;
  const int q0 = blockIdx.x * BT;
  const long long o_ss = static_cast<long long>(heads) * D;

  stage<D>(qs, q + b * q_sb + h * q_sh, q_ss, q0, sq);
  stage<D>(dos, d_o + (static_cast<long long>(b) * sq * heads + h) * D, o_ss, q0, sq);
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    row_lse[r] = row < sq ? lse[static_cast<long long>(bh) * sq + row] : pos_inf();
    row_delta[r] = row < sq ? delta[static_cast<long long>(bh) * sq + row] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.f;

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  for (int key0 = 0; key0 < row_len; key0 += BT) {
    __syncthreads();  // every warp is done with the previous key tile
    stage<D>(ks, kb, k_ss, key0, skv);
    stage<D>(vs, vb, v_ss, key0, skv);
    __syncthreads();

    float p[BT / 8][4], ds[BT / 8][4];
    product_nt<D>(p, qs, warp * 16, ks, g, t);   // S = Q K^T
    product_nt<D>(ds, dos, warp * 16, vs, g, t); // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + t * 2 + (e & 1), r = e >> 1;
        const float pe = key < row_len ? exp2f(fmaf(p[nt][e], scale_log2, -row_lse[r])) : 0.f;
        ds[nt][e] = pe * (ds[nt][e] - row_delta[r]);
      }
    product_nn<D>(dq_acc, ds, ks, g, t);
  }
  write_rows<D>(dq + (static_cast<long long>(b) * sq * heads + h) * D, o_ss, dq_acc, scale, r0,
                sq, t);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* delta, void* dq, void* dk, void* dv, const void* kv_lens,
           int batch, int heads, int sq, int skv, const long long* st, float scale,
           cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      pn_flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      pn_flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const long long bh = static_cast<long long>(batch) * heads;
  if (bh < 1 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(d_o);
  const auto* lens = static_cast<const int*>(kv_lens);

  const long long rows = bh * sq;
  const long long delta_blocks = (rows * (D / 8) + 255) / 256;
  pn_flash_bwd_delta<D><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), dop, static_cast<float*>(delta), heads, sq, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  dim3 grid_kv((skv + BT - 1) / BT, static_cast<unsigned>(bh));
  pn_flash_bwd_dkdv<D><<<grid_kv, NTHREADS, smem_bytes<D>(), stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lens, heads, sq, skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  dim3 grid_q((sq + BT - 1) / BT, static_cast<unsigned>(bh));
  pn_flash_bwd_dq<D><<<grid_q, NTHREADS, smem_bytes<D>(), stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), lens, heads, sq, skv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (B, S, H, D) views, strides {q_b, q_s, q_h, k_b, k_s, k_h,
// v_b, v_s, v_h} in elements (multiples of 8), unit head-dim stride; o, d_o,
// dq (B, Sq, H, D) and dk, dv (B, Skv, H, D) contiguous bf16; lse (the
// forward's) and delta (scratch) fp32 (B, H, Sq); kv_lens (B,) int32 or null.
// Returns a cudaError_t value: of the set-up, or cudaGetLastError() after the
// last launch.
extern "C" int pn_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                           const void* o, const void* d_o, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv,
                                           const void* kv_lens, int batch, int heads, int sq,
                                           int skv, int d, const long long* strides, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    case 32: return launch<32>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    case 64: return launch<64>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    case 128: return launch<128>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, batch, heads, sq, skv, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
