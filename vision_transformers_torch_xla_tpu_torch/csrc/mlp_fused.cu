// The fused backward of the transformer MLP's fc2 and GELU, for Hopper.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/mlp_fused.py::_fc2_bwd_kernel (K3).
// Same function, over the M = B*S rows of the activations:
//   da = dy w2, bf16 x bf16 products accumulated in fp32, never stored;
//   t = tanh(c (h + 0.044715 h^3)) from fp32(h), c = sqrt(2 / pi);
//   a = 0.5 h (1 + t), gp = 0.5 (1 + t) + 0.5 h (1 - t^2) c (1 + 0.134145 h^2);
//   dh = da * gp; dh and a are stored bf16 at (M, K);
//   part[tile][k] = sum over the tile's rows of the fp32 dh (before its
//   rounding), one row of partials per 128-row tile; the caller sums them.
// dy is (M, O) and w2 (O, K), fc2's weight as torch stores it (out, in), so
// da is a plain row-major product and no transpose is needed. O and K are
// multiples of 128; M is any count, its ragged last tile masked.
//
// What bounds it on an H100: at the my_vit_b train step (M = 128 x 197,
// O = 768, K = 3072) the product is 119 GFLOP (0.12 ms at the 989 TFLOP/s
// bf16 tensor-core peak) and the bytes that must move are ~510 MB (h read,
// dh and a written, dy and w2 read: 0.15 ms at 3.35 TB/s), so device memory
// bounds it, with the tensor cores close behind. The TPU kernel exists to
// keep da, the GELU backward's elementwise passes and the bias reduction out
// of device memory; this one does the same.
//
// Design: one block of 8 warps per 128 x 128 tile of (M, K), looping over O
// in steps of 32. dy and w2 tiles go through a 3-stage cp.async ring in
// shared memory (rows padded by 16 bytes, so ldmatrix reads are free of bank
// conflicts); each warp owns a 64 x 32 sub-tile and runs mma.sync m16n8k16
// (bf16 in, fp32 accumulators), with A fragments from ldmatrix and B
// fragments from ldmatrix.trans of the row-major w2 tile. The whole GELU
// epilogue runs in registers on the accumulators: read h, write dh and a,
// and sum dh over the tile's rows by warp shuffles and one shared-memory
// exchange between the two warps of a column, in a fixed order. No float
// atomics: the result is deterministic. wgmma and TMA are the next step.
//
// fp16 and fp32 inputs (the TPU kernel takes any float dtype) run
// fc2_bwd_cc_kernel, the same function on the CUDA cores: the product in
// fp32 from the inputs' values (mma.sync has no fp32 product; TF32 would
// round the inputs), the same GELU epilogue, dh and a rounded to the
// inputs' dtype (none for fp32, csrc/elem.cuh) and the same fp32 partials
// per 128-row tile. A block owns a 128 x 64 tile of (M, K) and loops over O
// in steps of 16, dy and w2 staged in shared memory as fp32; 256 threads
// as 16 x 16, each 8 rows by 4 columns 16 apart.
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kBM = 128;         // rows of a block's tile
constexpr int kBN = 128;         // hidden columns of a block's tile
constexpr int kBK = 32;          // depth of one stage (over O)
constexpr int kStages = 3;
constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;       // a warp's sub-tile
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16; // m16 tiles per warp
constexpr int kNT = kWarpN / 8;  // n8 tiles per warp
constexpr int kAPitch = kBK + 8;  // bf16 per staged dy row (80 bytes)
constexpr int kBPitch = kBN + 8;  // bf16 per staged w2 row (272 bytes)
constexpr int kAStage = kBM * kAPitch;
constexpr int kBStage = kBK * kBPitch;
constexpr size_t kSmemBytes = (size_t)kStages * (kAStage + kBStage) * sizeof(bf16);

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kGeluC3 = 0.134145f;  // 3 * 0.044715

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (gelu(x), gelu'(x)) of the tanh approximation, in fp32.
__device__ __forceinline__ float2 gelu_tanh_val_grad(float x) {
  const float t = tanhf(kSqrt2OverPi * (x + kGeluC * x * x * x));
  const float val = 0.5f * x * (1.f + t);
  const float grad = 0.5f * (1.f + t) +
                     0.5f * x * (1.f - t * t) * kSqrt2OverPi *
                         (1.f + kGeluC3 * x * x);
  return make_float2(val, grad);
}

// grid (K / kBN, ceil(M / kBM)); dynamic shared memory kSmemBytes.
__global__ void __launch_bounds__(kThreads)
fc2_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w2,
               const bf16* __restrict__ h, bf16* __restrict__ dh,
               bf16* __restrict__ a_out, float* __restrict__ part, int M,
               int O, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);   // kStages x [kBM][kAPitch]
  bf16* bs = as + kStages * kAStage;               // kStages x [kBK][kBPitch]

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * kWarpM;   // the warp's rows in the tile
  const int wn = (warp & 3) * kWarpN;    // and its columns

  // One stage: the dy tile (kBM x kBK, 4 chunks of 16 bytes a row) and the
  // w2 tile (kBK x kBN, 16 chunks a row), 512 chunks each, 2 per thread.
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* a_dst = as + stage * kAStage;
    bf16* b_dst = bs + stage * kBStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      const int gm = m0 + r;
      const bf16* src = gm < M ? dy + (long long)gm * O + k0 + col : dy;
      cp_async16(a_dst + r * kAPitch + col, src, gm < M ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async16(b_dst + r * kBPitch + col,
                 w2 + (long long)(k0 + r) * K + n0 + col, 16);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int KT = O / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // and every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();

    const bf16* a_st = as + (kt % kStages) * kAStage;
    const bf16* b_st = bs + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], a_st + (wm + i * 16 + (lane & 15)) * kAPitch + kk +
                               (lane >> 4) * 8);
      unsigned bfr[kNT / 2][4];  // each x4.trans gives two n8 tiles
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        ldmatrix_x4_trans(bfr[j], b_st + (kk + (lane & 15)) * kBPitch + wn +
                                      j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                   bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue. Accumulator r of tile (i, j) sits at row
  // wm + 16 i + lane / 4 + 8 (r / 2), column wn + 8 j + 2 (lane % 4) + r % 2.
  const int g = lane >> 2, q = lane & 3;
  float colsum[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) colsum[j][0] = colsum[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm + i * 16 + g + half * 8;
      if (gm >= M) continue;
      const long long row = (long long)gm * K;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn + j * 8 + 2 * q;
        const float2 hf =
            __bfloat1622float2(*reinterpret_cast<const bf162*>(h + row + col));
        const float2 g0 = gelu_tanh_val_grad(hf.x);
        const float2 g1 = gelu_tanh_val_grad(hf.y);
        const float d0 = acc[i][j][2 * half] * g0.y;
        const float d1 = acc[i][j][2 * half + 1] * g1.y;
        *reinterpret_cast<bf162*>(dh + row + col) = __floats2bfloat162_rn(d0, d1);
        *reinterpret_cast<bf162*>(a_out + row + col) =
            __floats2bfloat162_rn(g0.x, g1.x);
        colsum[j][0] += d0;
        colsum[j][1] += d1;
      }
    }
  }
  // Sum each column over the warp's 8 row groups (lanes of equal lane % 4),
  // then over the two warps that share the columns, in a fixed order.
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        colsum[j][e] += __shfl_xor_sync(0xffffffffu, colsum[j][e], off);
  __syncthreads();  // the ring is free: every warp has left the main loop
  float* red = reinterpret_cast<float*>(smem_raw);  // [2][kBN]
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      red[(warp >> 2) * kBN + wn + j * 8 + 2 * q] = colsum[j][0];
      red[(warp >> 2) * kBN + wn + j * 8 + 2 * q + 1] = colsum[j][1];
    }
  }
  __syncthreads();
  if (tid < kBN)
    part[(long long)blockIdx.y * K + n0 + tid] = red[tid] + red[kBN + tid];
}

constexpr int kCN = 64;          // hidden columns of a CUDA-core tile
constexpr int kCK = 16;          // depth of one CUDA-core step (over O)
constexpr int kCRows = kBM / 16;  // rows of a thread (8)
constexpr int kCCols = kCN / 16;  // columns of a thread (4)

// The fp16 / fp32 kernel. grid (K / kCN, ceil(M / kBM)); static shared
// memory: the dy step transposed [o][row] (pitch kBM + 4, float4 reads),
// the w2 step [o][col], and the column partials of the 16 row groups.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fc2_bwd_cc_kernel(const T* __restrict__ dy, const T* __restrict__ w2,
                  const T* __restrict__ h, T* __restrict__ dh,
                  T* __restrict__ a_out, float* __restrict__ part, int M,
                  int O, int K) {
  typedef Elem<T> E;
  __shared__ __align__(16) float as[kCK][kBM + 4];
  __shared__ float bs[kCK][kCN];
  __shared__ float red[16][kCN];
  const int n0 = blockIdx.x * kCN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float acc[kCRows][kCCols];
#pragma unroll
  for (int i = 0; i < kCRows; ++i)
#pragma unroll
    for (int j = 0; j < kCCols; ++j) acc[i][j] = 0.f;

  for (int o0 = 0; o0 < O; o0 += kCK) {
    __syncthreads();  // every thread is done with the last step
    for (int i = tid; i < kBM * kCK; i += kThreads) {
      const int r = i / kCK, c = i % kCK, gm = m0 + r;
      as[c][r] = gm < M ? E::load(dy[(long long)gm * O + o0 + c]) : 0.f;
    }
    for (int i = tid; i < kCK * kCN; i += kThreads) {
      const int r = i / kCN, c = i % kCN;
      bs[r][c] = E::load(w2[(long long)(o0 + r) * K + n0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kCK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(&as[kk][ty * 8]);
      const float4 x1 = *reinterpret_cast<const float4*>(&as[kk][ty * 8 + 4]);
      const float x[kCRows] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < kCCols; ++j) {
        const float y = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kCRows; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
      }
    }
  }

  // Epilogue: dh = da gelu'(h), a = gelu(h), the fp32 dh summed per column
  float colsum[kCCols];
#pragma unroll
  for (int j = 0; j < kCCols; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kCRows; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
    const long long row = (long long)gm * K;
#pragma unroll
    for (int j = 0; j < kCCols; ++j) {
      const int col = n0 + tx + 16 * j;
      const float2 g = gelu_tanh_val_grad(E::load(h[row + col]));
      const float d = acc[i][j] * g.y;
      dh[row + col] = E::store(d);
      a_out[row + col] = E::store(g.x);
      colsum[j] += d;
    }
  }
#pragma unroll
  for (int j = 0; j < kCCols; ++j) red[ty][tx + 16 * j] = colsum[j];
  __syncthreads();
  if (tid < kCN) {
    float sum = 0.f;
    for (int g = 0; g < 16; ++g) sum += red[g][tid];
    part[(long long)blockIdx.y * K + n0 + tid] = sum;
  }
}

template <typename T>
int launch_cc(const void* dy, const void* w2, const void* h, void* dh,
              void* a, void* part, int M, int O, int K, int tiles,
              cudaStream_t stream) {
  fc2_bwd_cc_kernel<T><<<dim3(K / kCN, tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w2),
      static_cast<const T*>(h), static_cast<T*>(dh), static_cast<T*>(a),
      static_cast<float*>(part), M, O, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dy (M, O), w2 (O, K), h (M, K) of the element type `dtype` in; dh, a
// (M, K) of that type and part (ceil(M / 128), K) fp32 out. Returns a
// cudaError_t as int: 0 on a launch that was accepted.
int vtx_fc2_bwd(const void* dy, const void* w2, const void* h, void* dh,
                void* a, void* part, int M, int O, int K, int dtype,
                void* stream) {
  const int tiles = (M + kBM - 1) / kBM;
  if (M < 1 || tiles > 65535 || O < kBK || O % 128 || K < kBN || K % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return launch_cc<__half>(dy, w2, h, dh, a, part, M, O, K, tiles, s);
  if (dtype == kF32)
    return launch_cc<float>(dy, w2, h, dh, a, part, M, O, K, tiles, s);
  if (dtype != kBf16) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fc2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  fc2_bwd_kernel<<<dim3(K / kBN, tiles), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(h), static_cast<bf16*>(dh),
      static_cast<bf16*>(a), static_cast<float*>(part), M, O, K);
  return (int)cudaGetLastError();
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
