// The fused backward of the transformer MLP's fc2 and GELU, for Hopper.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/mlp_fused.py::_fc2_bwd_kernel (K3).
// Same function, over the M = B*S rows of the activations:
//   da = dy w2, products of the inputs' values accumulated in fp32, never
//   stored;
//   t = tanh(c (h + 0.044715 h^3)) from fp32(h), c = sqrt(2 / pi);
//   a = 0.5 h (1 + t), gp = 0.5 (1 + t) + 0.5 h (1 - t^2) c (1 + 0.134145 h^2);
//   dh = da * gp; dh and a are stored in the inputs' dtype at (M, K);
//   part[tile][k] = sum over the tile's rows of the fp32 dh (before its
//   rounding), one row of partials per 128-row tile; the caller sums them.
// dy is (M, O) and w2 (O, K), fc2's weight as torch stores it (out, in).
// O and K are multiples of 128; M is any count, its ragged last tile
// masked.
//
// What bounds it on an H100: at the my_vit_b train step (M = 128 x 197 =
// 25,216, O = 768, K = 3,072) the bytes that must move are 508 MB (h read,
// dh and a written, dy and w2 read: 0.152 ms at 3.35 TB/s), and the product
// is 119 GFLOP (0.120 ms at the 989 TFLOP/s bf16 tensor-core peak), so
// device memory bounds it, with the tensor cores close behind; the
// epilogue's GELU adds ~25 instructions an element on the CUDA cores. The
// TPU kernel exists to keep da, the GELU backward's elementwise passes and
// the bias reduction out of device memory; this one does the same, and
// overlaps the epilogue's traffic with the products.
//
// bf16 and fp16 (fc2_bwd_tc_kernel; f16 is a template argument of
// csrc/hopper.cuh's helpers): a warp-specialised block of 288 threads per
// 128 x 128 tile of (M, K), two blocks an SM.
// * A producer warp keeps TMA loads in flight through a 3-stage ring of
//   64-deep steps over O: the dy tile [128 rows][64] K-major as stored, and
//   the w2 tile [64 rows of O][128 columns of K], which wgmma reads
//   MN-major through the transpose bit that 16-bit types allow. After the
//   last step it loads the h tile into the next ring slot, so h arrives
//   while the last products run; full (TMA bytes arrived) and empty (the
//   consumers' warps are done) mbarriers order the ring.
// * Two consumer warpgroups own 64 rows each: wgmma m64n128k16 with both
//   operands in 128-byte-swizzled shared memory, one step's products in
//   flight while the next is issued.
// * The epilogue runs on the accumulator fragments: h read from shared
//   memory, dh written over it in place and a into a second free ring
//   slot, both in the TMA's swizzle (conflict-free 4-byte accesses), then
//   stored by TMA, one [64][64] box per panel and warpgroup; the column sums
//   of fp32 dh go by warp shuffles and one shared-memory exchange between
//   the 8 consumer warps, in a fixed order. No float atomics: the result is
//   deterministic. Two blocks an SM (101 KB of shared memory each) let one
//   block's epilogue and loads run under the other's products.
// * tanh is 1 - 2 / (2^(2 x log2 e) + 1) with ex2.approx and rcp.approx:
//   within ~1e-7 of tanhf, one exponential and one reciprocal where tanhf
//   takes ~20 instructions and a branch.
// * Registers: a producer warp holds 32 threads' registers, so the 288
//   threads of a block need no setmaxnreg: at two blocks an SM each thread
//   may have 112, more than a producer warpgroup's setmaxnreg could hand
//   the consumers (104).
//
// fp32 (fc2_bwd_simt_kernel, on float alone) runs on the CUDA cores: the
// product in fp32 from the inputs' values (the tensor cores have no fp32
// product; TF32 would round the inputs), so the 119 GFLOP of the my_vit_b
// step bound it at 1.78 ms (67 TFLOP/s), six times its 1.02 GB's 0.30 ms. A
// block of 256 threads (16 x 16) owns a 128 x 128 tile of (M, K), each
// thread 8 rows by 8 columns (4-row and 4-column groups 64 apart), read as
// float4 from both operands: 4 shared loads per 64 FMAs. Steps of 16 over
// O, double-buffered: w2 [o][col] as stored by cp.async, dy loaded into
// registers a step ahead and stored transposed [o][row] (pitch 132, free
// of bank conflicts) after the step's products; one barrier a step. The
// epilogue is the tensor-core kernel's in fp32: the accurate tanhf (fp32
// keeps the plain version's order), dh and a stored as float4, the column
// sums of each 128-row tile's real rows over the 16 row groups in a fixed
// order (no float atomics). 33 KB of shared memory and <= 128 registers a
// thread: two blocks an SM. A call whose tensors are not all 16-byte
// aligned takes the same kernel with 4-byte accesses. Measured on an H100
// 80GB HBM3 at 700 W (PERF.md §6): 2.87-2.89 ms of device time at the
// step's shape, 62% of the bound (the 128 x 64 design before it 4.52, the
// unfused cuBLAS + GELU path 2.84); the GELU takes 0.18 of it.
//
// Both grids are one-dimensional over the tiles, so M is bounded only by
// 2^31 tiles. Plain C interface, loaded with ctypes. The kernels allocate
// nothing and launch on the caller's stream; the host function takes the
// element type's code (csrc/elem.cuh) and returns cudaGetLastError(), or a
// code of vtx_cuda_error_string's own when a tensor map could not be made.

#include <limits.h>

#include "cp_async.cuh"
#include "elem.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;         // rows of a block's tile (one partials row)
constexpr int kBN = 128;         // hidden columns of a block's tile
constexpr int kBK = 64;          // depth of one step over O: one panel
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 rows
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;  // dy tile + w2 tile
constexpr int kHalfRows = 64;    // rows of one TMA box of h, dh or a

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kGeluC3 = 0.134145f;  // 3 * 0.044715

// One block's shared memory: the ring, then the consumer warps' column
// sums. A stage is the dy tile (one [128][64] panel, 16 KB) and the w2 tile
// (two [64][64] panels, 8 KB each); the h tile, and later a, take a whole
// stage as two [128][64] panels. Every panel starts on a 1024-byte boundary
// (the swizzle atom) when the struct does.
struct Ring {
  uint8_t stage[kStages][kStageBytes];
  float red[kConsumerWarps][kBN];
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (gelu(x), gelu'(x)) of the tanh approximation, in fp32. `fast`: tanh as
// 1 - 2 / (e^(2u) + 1), which gives +-1 for |u| large (e^(2u) overflows to
// inf, or to 0) and is within ~1e-7 of tanhf elsewhere.
template <bool fast>
__device__ __forceinline__ float2 gelu_tanh_val_grad(float x) {
  const float u = kSqrt2OverPi * (x + kGeluC * x * x * x);
  float t;
  if constexpr (fast)
    t = 1.f - 2.f * rcp_approx(ex2_approx(2.f * kLog2e * u) + 1.f);
  else
    t = tanhf(u);
  const float val = 0.5f * x * (1.f + t);
  const float grad = 0.5f * (1.f + t) +
                     0.5f * x * (1.f - t * t) * kSqrt2OverPi *
                         (1.f + kGeluC3 * x * x);
  return make_float2(val, grad);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same<T, f16>::value)
    return __half22float2(*reinterpret_cast<__half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// grid (ceil(M / kBM) * K / kBN): block x is column tile x % n_tn of row
// tile x / n_tn, so the blocks in flight share their dy rows. Accumulator
// fragments (wgmma m64n128, f32): thread t of a warpgroup, warp w = t / 32,
// lane l, holds d[4n + j] at row 16 w + l / 4 + 8 (j / 2), column 8 n + 2
// (l % 4) + (j % 2).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fc2_bwd_tc_kernel(const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tw2,
                  const __grid_constant__ CUtensorMap th,
                  const __grid_constant__ CUtensorMap tdh,
                  const __grid_constant__ CUtensorMap ta,
                  float* __restrict__ part, int M, int O, int K, int n_tn) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the swizzle atom is 1024 bytes: align the ring to it
  Ring& r = *reinterpret_cast<Ring*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int tm = blockIdx.x / n_tn;
  const int m0 = tm * kBM, n0 = (blockIdx.x % n_tn) * kBN;
  const int n_k = O / kBK;  // steps over O; step n_k loads h
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: the ring's steps, then h into the next slot
    if (lane == 0) {
      for (int j = 0; j <= n_k; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(&empty[s], ((j / kStages) - 1) & 1);
        uint8_t* st = r.stage[s];
        bar_expect_tx(&full[s], kStageBytes);
        if (j < n_k) {
          tma_load(st, &tdy, &full[s], j * kBK, m0, 0, 0);
          for (int p = 0; p < kBN / kPanel; ++p)
            tma_load(st + kBM * kBK * 2 + p * kBK * kPanel * 2, &tw2,
                     &full[s], n0 + p * kPanel, j * kBK, 0, 0);
        } else {
          for (int p = 0; p < kBN / kPanel; ++p)
            for (int g = 0; g < kBM / kHalfRows; ++g)
              tma_load(st + p * kBM * kPanel * 2 + g * kHalfRows * kPanel * 2,
                       &th, &full[s], n0 + p * kPanel, m0 + g * kHalfRows, 0,
                       0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_k; ++j) {
    const int s = j % kStages;
    bar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* st = r.stage[s];
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_n128_mn<T>(
          acc, desc(st + (wg * 64 * kPanel + kk * 16) * 2, 16, 1024),
          desc(st + (kBM * kBK + kk * 16 * kPanel) * 2, kBK * kPanel * 2,
               1024),
          j > 0 || kk > 0);
    wg_commit();
    // the last step's products are done: free its slot
    wg_wait_pending<1>();
    pin(acc);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[(j - 1) % kStages]);
    }
  }
  wg_wait();
  pin(acc);
  // both warpgroups are done with the ring: a may take a slot
  named_barrier(1, kConsumers);

  // epilogue: h from its slot, dh over it in place, a into the slot after
  const int sh = n_k % kStages, sa = (n_k + 1) % kStages;
  bar_wait(&full[sh], (n_k / kStages) & 1);
  uint8_t* hs = r.stage[sh];
  uint8_t* as = r.stage[sa];
  const int row = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row + 8
  const int q = lane % 4;
  float csum[16][2];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    csum[n][0] = csum[n][1] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = row + 8 * half;
      // panel n / 8, 16-byte chunk n % 8 of row rr, in the 128-byte swizzle
      const int off = (n / 8) * kBM * kPanel * 2 + rr * 128 +
                      (((n % 8) ^ (rr % 8)) * 16) + q * 4;
      const float2 hf = unpack2<T>(*reinterpret_cast<uint32_t*>(hs + off));
      const float2 g0 = gelu_tanh_val_grad<true>(hf.x);
      const float2 g1 = gelu_tanh_val_grad<true>(hf.y);
      const float d0 = acc[4 * n + 2 * half] * g0.y;
      const float d1 = acc[4 * n + 2 * half + 1] * g1.y;
      *reinterpret_cast<uint32_t*>(hs + off) = pack2<T>(d0, d1);
      *reinterpret_cast<uint32_t*>(as + off) = pack2<T>(g0.x, g1.x);
      if (m0 + rr < M) {
        csum[n][0] += d0;
        csum[n][1] += d1;
      }
    }
  }
  // dh and a of this warpgroup's rows to device memory
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int p = 0; p < kBN / kPanel; ++p) {
      const int off = p * kBM * kPanel * 2 + wg * kHalfRows * kPanel * 2;
      tma_store(&tdh, hs + off, n0 + p * kPanel, m0 + wg * kHalfRows, 0, 0);
      tma_store(&ta, as + off, n0 + p * kPanel, m0 + wg * kHalfRows, 0, 0);
    }
    tma_store_commit();
  }
  // the column sums of fp32 dh: over the warp's 8 row lanes (lanes of equal
  // lane % 4), then over the 8 warps in order
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        csum[n][e] += __shfl_xor_sync(0xffffffffu, csum[n][e], off);
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      r.red[warp][8 * n + 2 * lane] = csum[n][0];
      r.red[warp][8 * n + 2 * lane + 1] = csum[n][1];
    }
  }
  named_barrier(1, kConsumers);
  if (threadIdx.x < kBN) {
    float sum = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) sum += r.red[w][threadIdx.x];
    part[(long long)tm * K + n0 + threadIdx.x] = sum;
  }
  // the stores have read the shared memory before the block leaves
  if (threadIdx.x % 128 == 0) tma_store_wait_read();
}

// ---- fp32 on the CUDA cores: fc2_bwd_simt_kernel

constexpr int kSThreads = 256;  // 16 x 16
constexpr int kSK = 16;         // depth of one step over O
constexpr int kSPA = kBM + 4;   // pitch of a step's dy, transposed [o][row]

// Four consecutive floats at p: one 16-byte access when `vec` (every tensor
// of the call is 16-byte aligned), else four.
__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void st4(float* p, float4 x, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
  }
}

// Two steps of operands: dy transposed [o][row] and w2 [o][col] as stored.
struct SimtRing {
  float dy[2][kSK][kSPA];
  float w2[2][kSK][kBN];
};

// grid (ceil(M / kBM) * K / kBN): block x is column tile x % n_tn of row
// tile x / n_tn, so the blocks in flight share their dy rows. Thread (ty,
// tx) owns the rows 4 ty + i and 64 + 4 ty + i and the columns 4 tx + c and
// 64 + 4 tx + c (i, c < 4) of the 128 x 128 tile.
__global__ void __launch_bounds__(kSThreads, 2)
fc2_bwd_simt_kernel(const float* __restrict__ dy, const float* __restrict__ w2,
                    const float* __restrict__ h, float* __restrict__ dh,
                    float* __restrict__ a_out, float* __restrict__ part,
                    int M, int O, int K, int n_tn, int vec) {
  extern __shared__ __align__(16) float simt_raw[];
  SimtRing& sm = *reinterpret_cast<SimtRing*>(simt_raw);
  const int tm = blockIdx.x / n_tn;
  const int m0 = tm * kBM, n0 = (blockIdx.x % n_tn) * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // this thread's share of a step: dy row ar at o 4 aq + 8 u (into
  // registers, then shared memory transposed); w2 rows br + 8 u at columns
  // bc (cp.async), u < kSU
  constexpr int kSU = kSK / 8;
  const int ar = tid >> 1, aq = tid & 1;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const bool a_ok = m0 + ar < M;
  const float* ag = dy + (long long)(m0 + ar) * O + 4 * aq;
  const float* bg = w2 + (long long)br * K + n0 + bc;
  float4 ra[kSU];
  auto load_dy = [&](int o0) {
#pragma unroll
    for (int u = 0; u < kSU; ++u)
      ra[u] = a_ok ? ld4(ag + o0 + 8 * u, vec) : make_float4(0.f, 0.f, 0.f,
                                                              0.f);
  };
  auto store_dy = [&](int buf) {
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
      const int o = 4 * aq + 8 * u;
      sm.dy[buf][o][ar] = ra[u].x;
      sm.dy[buf][o + 1][ar] = ra[u].y;
      sm.dy[buf][o + 2][ar] = ra[u].z;
      sm.dy[buf][o + 3][ar] = ra[u].w;
    }
  };
  auto load_w2 = [&](int buf, int o0) {
#pragma unroll
    for (int u = 0; u < kSU; ++u) {
      float* dst = &sm.w2[buf][br + 8 * u][bc];
      const float* src = bg + (long long)(o0 + 8 * u) * K;
      if (vec) {
        cp_async<16>(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async<4>(dst + e, src + e);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const int n_k = O / kSK;
  load_dy(0);
  load_w2(0, 0);
  store_dy(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int j = 0; j < n_k; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_k) {  // the next step, in flight during this one
      load_dy((j + 1) * kSK);
      load_w2(cur ^ 1, (j + 1) * kSK);
    }
#pragma unroll
    for (int k = 0; k < kSK; ++k) {
      const float* ak = sm.dy[cur][k];
      const float* bk = sm.w2[cur][k];
      const float4 a0 = *reinterpret_cast<const float4*>(ak + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + 4 * tx);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
    }
    if (j + 1 < n_k) {
      store_dy(cur ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();  // this step is read; the next one has landed
  }

  // Epilogue: dh = da gelu'(h), a = gelu(h), dh summed per column over the
  // tile's real rows
  float csum[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) csum[c] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
    if (gm >= M) continue;
    const long long row = (long long)gm * K + n0;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const long long at = row + 64 * g + 4 * tx;
      const float4 hv = ld4(h + at, vec);
      const float hx[4] = {hv.x, hv.y, hv.z, hv.w};
      float d[4], av[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gg = gelu_tanh_val_grad<false>(hx[e]);
        d[e] = acc[i][4 * g + e] * gg.y;
        av[e] = gg.x;
        csum[4 * g + e] += d[e];
      }
      st4(dh + at, make_float4(d[0], d[1], d[2], d[3]), vec);
      st4(a_out + at, make_float4(av[0], av[1], av[2], av[3]), vec);
    }
  }
  // the 16 row groups' column sums, in a fixed order: no float atomics
  float* red = &sm.dy[0][0][0];  // [16][kBN]; the last step is read
#pragma unroll
  for (int c = 0; c < 8; ++c)
    red[ty * kBN + 64 * (c / 4) + 4 * tx + c % 4] = csum[c];
  __syncthreads();
  if (tid < kBN) {
    float sum = 0.f;
    for (int g = 0; g < 16; ++g) sum += red[g * kBN + tid];
    part[(long long)tm * K + n0 + tid] = sum;
  }
}

// The dynamic shared memory of the tensor-core kernel: the ring and the
// column sums, plus the slack that aligns them to 1024 bytes.
constexpr size_t kTcSmem = sizeof(Ring) + 1024;

template <typename T>
int launch_tc(const void* dy, const void* w2, const void* h, void* dh,
              void* a, void* part, int M, int O, int K, long long blocks,
              cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrNoEntryPoint;
  const CUtensorMapDataType type = map_type<T>();
  // 2-D (rows, columns) tensors as 4-D maps of one head and one batch
  const Layout lo{(long long)M * O, (long long)M * O, O};
  const Layout lw{(long long)O * K, (long long)O * K, K};
  const Layout lk{(long long)M * K, (long long)M * K, K};
  CUtensorMap tdy, tw2, th, tdh, ta;
  int rc = encode(enc, &tdy, dy, 1, 1, M, O, lo, kBM, type);
  if (!rc) rc = encode(enc, &tw2, w2, 1, 1, O, K, lw, kBK, type);
  if (!rc) rc = encode(enc, &th, h, 1, 1, M, K, lk, kHalfRows, type);
  if (!rc) rc = encode(enc, &tdh, dh, 1, 1, M, K, lk, kHalfRows, type);
  if (!rc) rc = encode(enc, &ta, a, 1, 1, M, K, lk, kHalfRows, type);
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      fc2_bwd_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmem);
  if (e != cudaSuccess) return (int)e;
  fc2_bwd_tc_kernel<T><<<(unsigned)blocks, kThreads, kTcSmem, stream>>>(
      tdy, tw2, th, tdh, ta, static_cast<float*>(part), M, O, K, K / kBN);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dy (M, O), w2 (O, K), h (M, K) of the element type `dtype` in, contiguous
// and, for bf16 and fp16, 16-byte aligned; dh, a (M, K) of that type and
// part (ceil(M / 128), K) fp32 out. Returns a cudaError_t as int (0 on a
// launch that was accepted), or a code of vtx_cuda_error_string's own.
int vtx_fc2_bwd(const void* dy, const void* w2, const void* h, void* dh,
                void* a, void* part, int M, int O, int K, int dtype,
                void* stream) {
  const long long tiles = (M + (long long)kBM - 1) / kBM;
  if (M < 1 || O < 128 || O % 128 || K < 128 || K % 128 ||
      tiles * (K / kBN) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16:
      return launch_tc<bf16>(dy, w2, h, dh, a, part, M, O, K,
                             tiles * (K / kBN), s);
    case kF16:
      return launch_tc<f16>(dy, w2, h, dh, a, part, M, O, K,
                            tiles * (K / kBN), s);
    case kF32: {
      const uintptr_t bits = reinterpret_cast<uintptr_t>(dy) |
                             reinterpret_cast<uintptr_t>(w2) |
                             reinterpret_cast<uintptr_t>(h) |
                             reinterpret_cast<uintptr_t>(dh) |
                             reinterpret_cast<uintptr_t>(a);
      const cudaError_t e = cudaFuncSetAttribute(
          fc2_bwd_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)sizeof(SimtRing));
      if (e != cudaSuccess) return (int)e;
      fc2_bwd_simt_kernel<<<(unsigned)(tiles * (K / kBN)), kSThreads,
                            sizeof(SimtRing), s>>>(
          static_cast<const float*>(dy), static_cast<const float*>(w2),
          static_cast<const float*>(h), static_cast<float*>(dh),
          static_cast<float*>(a), static_cast<float*>(part), M, O, K,
          K / kBN, (bits & 15) == 0 ? 1 : 0);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of the bf16 / fp16 kernel, in bytes.
int vtx_fc2_bwd_smem() { return (int)kTcSmem; }

const char* vtx_cuda_error_string(int err) { return error_string(err); }

}  // extern "C"
