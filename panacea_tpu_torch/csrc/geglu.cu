// Fused GEGLU projection for Hopper (sm_90a), bf16 in / bf16 out on the tensor
// cores (pn_geglu_fwd) or fp32 in / fp32 out on the FMA units (pn_geglu_f32_fwd),
// and its backward gate pass (pn_geglu_bwd, described at its namespace):
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
// The Pallas kernel keeps fp32 operands in fp32; so does this one, on the FMA
// units (no tensor cores, no TF32). Its bound is 4 T C I flops at the card's
// fp32 rate outside the tensor cores (67 TFLOP/s on an H100 SXM), far above
// the time to move x, W and the result once.
//
// One block of 256 threads per tile of 128 tokens x 64 output columns (both
// halves: 128 rows of W), the threads as 16 x 16: thread (ty, tx) owns tokens
// ty + 16 i (i < 8) and columns tx + 16 j (j < 4) of each half, 64 fp32
// accumulators. Each step stages 32 channels of the x tile and of the two W
// row blocks in shared memory (rows padded by 4 floats, so that the 16-byte
// reads along the channels fall on distinct banks). The epilogue (bias,
// exact-erf GELU, product) runs in registers and only (T, I) is written.
// Tile index = token tile * column tiles + column tile, so the blocks in
// flight share x tiles in L2.

namespace f32 {

constexpr int BM = 128, BN = 64, BKC = 32, NTHREADS = 256;
constexpr int LD = BKC + 4;
constexpr int RI = BM / 16, CJ = BN / 16;
static_assert(BM == 2 * BN, "one staging loop fills the x tile and both W row blocks");

__global__ void __launch_bounds__(NTHREADS)
pn_geglu_f32_fwd(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, int tokens, int c,
                 int inner, int n_tiles) {
  __shared__ __align__(16) float xs[BM * LD];
  __shared__ __align__(16) float ws[2 * BN * LD];  // rows [0, BN): W_h, [BN, 2 BN): W_gate
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float ah[RI][CJ], ag[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) ah[i][j] = ag[i][j] = 0.f;

  constexpr int CH = BKC / 4;  // float4 chunks per staged row
  for (int k0 = 0; k0 < c; k0 += BKC) {
    __syncthreads();  // every warp is done with the previous slices
    for (int ch = threadIdx.x; ch < BM * CH; ch += NTHREADS) {
      const int r = ch / CH, col = (ch % CH) * 4;
      // c is a multiple of 4: a chunk lies wholly inside the row or outside it
      const bool in_k = k0 + col < c;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), wv = xv;
      if (in_k && m0 + r < tokens)
        xv = *reinterpret_cast<const float4*>(x + static_cast<long long>(m0 + r) * c + k0 + col);
      const int n = n0 + (r & (BN - 1));  // the column this W row belongs to
      if (in_k && n < inner)
        wv = *reinterpret_cast<const float4*>(
            w + static_cast<long long>(r < BN ? n : inner + n) * c + k0 + col);
      *reinterpret_cast<float4*>(xs + r * LD + col) = xv;
      *reinterpret_cast<float4*>(ws + r * LD + col) = wv;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKC; kk += 4) {
      float4 xv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * LD + kk);
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float4 hv = *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * LD + kk);
        const float4 gv = *reinterpret_cast<const float4*>(ws + (BN + tx + 16 * j) * LD + kk);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          ah[i][j] = fmaf(xv[i].x, hv.x, ah[i][j]);
          ah[i][j] = fmaf(xv[i].y, hv.y, ah[i][j]);
          ah[i][j] = fmaf(xv[i].z, hv.z, ah[i][j]);
          ah[i][j] = fmaf(xv[i].w, hv.w, ah[i][j]);
          ag[i][j] = fmaf(xv[i].x, gv.x, ag[i][j]);
          ag[i][j] = fmaf(xv[i].y, gv.y, ag[i][j]);
          ag[i][j] = fmaf(xv[i].z, gv.z, ag[i][j]);
          ag[i][j] = fmaf(xv[i].w, gv.w, ag[i][j]);
        }
      }
    }
  }

  // epilogue: bias, erf-GELU gate, product; only (T, I) is written
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= inner) continue;
    const float bh = bias[col], bg = bias[inner + col];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < tokens)
        out[static_cast<long long>(row) * inner + col] =
            (ah[i][j] + bh) * gelu_erf(ag[i][j] + bg);
    }
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
// pn::encode_bf16_map takes them. blocks: the size of the persistent grid.
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
  int err = pn::encode_bf16_map(&x_map, x, 2, maps);
  if (!err) err = pn::encode_bf16_map(&w_map, w, 2, maps + 6);
  if (!err && tma_store) err = pn::encode_bf16_map(&out_map, out, 2, maps + 12);
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

// The fp32 entry: x, w, bias and out contiguous fp32, 16-byte aligned, c a
// multiple of 4. Returns a cudaError_t value.
extern "C" int pn_geglu_f32(const void* x, const void* w, const void* bias, void* out,
                            int tokens, int c, int inner, void* stream) {
  const int m_tiles = (tokens + f32::BM - 1) / f32::BM, n_tiles = (inner + f32::BN - 1) / f32::BN;
  const long long total = static_cast<long long>(m_tiles) * n_tiles;
  if (total < 1 || total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  f32::pn_geglu_f32_fwd<<<static_cast<unsigned>(total), f32::NTHREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), tokens, c, inner, n_tiles);
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
