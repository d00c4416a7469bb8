// Register tiles on the CUDA cores, shared by csrc/attn_bwd.cu (the fp32
// K2), csrc/flash_blocked.cu (K4-K6 on the CUDA cores) and csrc/attn_fwd.cu
// (the fp32 K1).
//
// A block of kThreads = 256 threads works as 16 x 16: thread (ty, tx) =
// (threadIdx.x / 16, threadIdx.x % 16) owns 4 contiguous rows (row0 = 4 ty)
// and, in tile_product, the columns tx + 16 j of a 64-row tile product.
// Operands are staged in shared memory as fp32: an A operand transposed
// with pitch kPA (16-byte rows: float4 reads, broadcast in a half-warp),
// a B operand transposed with pitch kPB (odd: row and column reads both
// free of bank conflicts).

#pragma once

#include "cp_async.cuh"
#include "elem.cuh"

namespace {

constexpr int kTile = 64;           // query rows and key rows of one tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kPA = kTile + 4;      // pitch of a transposed A operand
constexpr int kPB = kTile + 1;      // pitch of a transposed B operand

// Reductions over the 16 lanes that share a row (a half-warp). The xor
// butterfly leaves the same value in every lane.
__device__ __forceinline__ float half_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [r0, r0 + kTile) of one head (rows `sr` elements apart),
// scaled by `mul`, into shared memory as fp32, transposed: dst[d * pitch +
// r]. Rows >= S and columns >= D read as 0.
template <typename T, int kD>
__device__ __forceinline__ void stage_t(float* __restrict__ dst, int pitch,
                                        const T* __restrict__ src,
                                        long long sr, int r0, int S, int D,
                                        float mul) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    float x = 0.f;
    if (r0 + r < S && d < D)
      x = Elem<T>::load(src[(long long)(r0 + r) * sr + d]) * mul;
    dst[d * pitch + r] = x;
  }
}

// acc[i][j] += sum_{k < K} a[k * kPA + row0 + i] * b[k * BK + (col0 + 16 j) * BC]
// for i < 4, j < NJ: a is a transposed A operand (float4 reads), b a B
// operand read with strides BK along k and BC along the columns.
template <int NJ, int K, int BK, int BC>
__device__ __forceinline__ void tile_product(float (&acc)[4][NJ],
                                             const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int row0, int col0) {
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * kPA + row0);
    float y[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = b[k * BK + (col0 + 16 * j) * BC];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(x.x, y[j], acc[0][j]);
      acc[1][j] = fmaf(x.y, y[j], acc[1][j]);
      acc[2][j] = fmaf(x.z, y[j], acc[2][j]);
      acc[3][j] = fmaf(x.w, y[j], acc[3][j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// Store a thread's 4 x 4 values x[i][j] at dst[(col0 + 16 j) * kPA + row0 + i]
// (transposed, float4 per column: an A operand for the next product).
__device__ __forceinline__ void store_t(float* __restrict__ dst,
                                        const float (&x)[4][4], int row0,
                                        int col0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (col0 + 16 * j) * kPA + row0) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

}  // namespace
