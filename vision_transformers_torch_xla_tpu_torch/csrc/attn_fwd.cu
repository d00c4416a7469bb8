// Softmax attention forward over a fused (B, S, 3*H*D) qkv buffer, for Hopper.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_fwd_stats_kernel (K1). Same function, per (b, h):
//   q^ = bf16(q * scale); s = q^ k^T in fp32 (columns >= S do not exist here);
//   m = rowmax(s); p = exp(s - m); rinv = 1 / sum(p);
//   o = (bf16(p) v, accumulated in fp32) * rinv, stored bf16 at (B, S, H*D);
//   optionally st = (B, H, S, 2) fp32 holding [m, rinv] per query row.
// q, k and v are read by stride straight from the projection output: q at
// column h*D, k at H*D + h*D, v at 2*H*D + h*D. The TPU kernel's 128-lane
// head-pair packing is a TPU layout rule and is not carried over.
//
// What bounds it on an H100: at ViT-B shapes (S = 197, D = 64) one (b, h) is
// ~10 MFLOP over ~75 KB of q/k/v, far below the ~295 FLOP/byte ridge, so
// device memory is not the limit. On the CUDA cores the limit is instruction
// issue: every two FMAs come with a shared-memory load (and, for 16-bit
// inputs, two conversions), ~2,500 warp instructions per query row (PERF.md
// §6 has the fp32 times). fp32 has no tensor-core product that keeps the
// TPU kernel's cast order (TF32 rounds the inputs), so fp32 runs here.
//
// Design: one block per (b, h, 64-row query tile). K and V of the head are
// staged once in shared memory (rows padded to an odd number of 32-bit
// words, so lanes reading different key rows hit different banks); each warp
// owns one query row at a time: lanes split the keys for q^ k^T, warp
// shuffles give the row max and sum, and lanes split the head dim for p v.
// The score row never leaves shared memory. For head dims 32, 64 and 128 the
// head dim is a compile-time constant, q^ sits in registers and the loops
// unroll; other even head dims take the run-time loops. When K and V do not
// fit (long S with wide D), they are read from global memory (L2) through
// the same loops.
//
// Element types: this source serves fp32, which the TPU kernel computes
// with no rounding point (every astype an identity); the loops are written
// for any element type through csrc/elem.cuh, and bf16 and fp16 run on the
// tensor cores instead (csrc/attn_fwd_tc.cu).
//
// Plain C interface, loaded with ctypes. The kernel allocates nothing and
// launches on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cfloat>

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;          // query rows in flight per block
constexpr int kRowsPerBlock = 64;  // query tile of one block
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSeq = 1024;
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Floats of one warp's scratch: q^ (D) then scores (S), padded to 16 bytes.
__host__ __device__ inline int warp_floats(int D, int S) {
  return (D + S + 3) & ~3;
}

// Shared memory: per warp [q^: D][scores: S] (16-byte aligned), then
// [K: S x kv_words][V: S x kv_words] (pairs) when kv_in_smem. kD > 0 fixes
// the head dim at compile time (a multiple of 4); kD == 0 reads it from
// d_rt.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                float* __restrict__ st, int S, int H, int d_rt, float scale,
                int kv_in_smem, int kv_words) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = kD > 0 ? kD : d_rt;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D2 = D >> 1;        // pairs in a head row
  const int C = 3 * H * D;      // elements in a qkv row
  const int C2 = C >> 1;        // pairs in a qkv row

  const T* base = qkv + (long long)b * S * C;
  const T* qg = base + h * D;
  const Pair* kg = reinterpret_cast<const Pair*>(base + H * D + h * D);
  const Pair* vg = reinterpret_cast<const Pair*>(base + 2 * H * D + h * D);

  const int wf = warp_floats(D, S);
  float* qs = smem + warp * wf;
  float* sc = qs + D;
  const Pair* kp;
  const Pair* vp;
  int kv_stride;  // in pairs
  if (kv_in_smem) {
    Pair* ks = reinterpret_cast<Pair*>(smem + kWarps * wf);
    Pair* vs = ks + S * kv_words;
    for (int i = threadIdx.x; i < S * D2; i += blockDim.x) {
      const int r = i / D2, c = i - r * D2;
      ks[r * kv_words + c] = kg[r * C2 + c];
      vs[r * kv_words + c] = vg[r * C2 + c];
    }
    kp = ks;
    vp = vs;
    kv_stride = kv_words;
  } else {
    kp = kg;
    vp = vg;
    kv_stride = C2;
  }
  __syncthreads();

  const int row_end = min(row0 + kRowsPerBlock, S);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const T* qrow = qg + r * C;
    for (int d = lane; d < D; d += 32)
      qs[d] = E::round(E::load(qrow[d]) * scale);
    __syncwarp();

    // s = q^ k^T: lane j takes keys j, j + 32, ...
    float mx = -FLT_MAX;
    if constexpr (kD > 0) {
      float q[kD];
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(qs + d);
        q[d] = t.x;
        q[d + 1] = t.y;
        q[d + 2] = t.z;
        q[d + 3] = t.w;
      }
      for (int j = lane; j < S; j += 32) {
        const Pair* kr = kp + j * kv_stride;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 2; ++c) {
          const float2 kf = E::load2(kr[c]);
          a0 = fmaf(q[2 * c], kf.x, a0);
          a1 = fmaf(q[2 * c + 1], kf.y, a1);
        }
        sc[j] = a0 + a1;
        mx = fmaxf(mx, a0 + a1);
      }
    } else {
      for (int j = lane; j < S; j += 32) {
        const Pair* kr = kp + j * kv_stride;
        float acc = 0.f;
        for (int c = 0; c < D2; ++c) {
          const float2 kf = E::load2(kr[c]);
          acc = fmaf(qs[2 * c], kf.x, acc);
          acc = fmaf(qs[2 * c + 1], kf.y, acc);
        }
        sc[j] = acc;
        mx = fmaxf(mx, acc);
      }
    }
    mx = warp_max(mx);

    // p = exp(s - m); the sum is over fp32 p, the p v product takes bf16(p)
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = expf(sc[j] - mx);
      sum += p;
      sc[j] = E::round(p);
    }
    sum = warp_sum(sum);
    const float rinv = 1.f / sum;
    __syncwarp();

    // o = (bf16(p) v) * rinv: lane c takes head-dim pairs c, c + 32
    Pair* orow =
        reinterpret_cast<Pair*>(out + ((long long)b * S + r) * H * D + h * D);
    if constexpr (kD > 0) {
#pragma unroll
      for (int c0 = 0; c0 < kD / 2; c0 += 32) {
        const int c = c0 + lane;
        if (c < kD / 2) {
          float ax[4] = {0.f, 0.f, 0.f, 0.f}, ay[4] = {0.f, 0.f, 0.f, 0.f};
          int j = 0;
          for (; j + 4 <= S; j += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(sc + j);
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float2 vf = E::load2(vp[(j + u) * kv_stride + c]);
              ax[u] = fmaf(pj[u], vf.x, ax[u]);
              ay[u] = fmaf(pj[u], vf.y, ay[u]);
            }
          }
          for (; j < S; ++j) {
            const float2 vf = E::load2(vp[j * kv_stride + c]);
            ax[0] = fmaf(sc[j], vf.x, ax[0]);
            ay[0] = fmaf(sc[j], vf.y, ay[0]);
          }
          const float x = (ax[0] + ax[1]) + (ax[2] + ax[3]);
          const float y = (ay[0] + ay[1]) + (ay[2] + ay[3]);
          orow[c] = E::store2(x * rinv, y * rinv);
        }
      }
    } else {
      for (int c = lane; c < D2; c += 32) {
        float ax = 0.f, ay = 0.f;
        for (int j = 0; j < S; ++j) {
          const float2 vf = E::load2(vp[j * kv_stride + c]);
          ax = fmaf(sc[j], vf.x, ax);
          ay = fmaf(sc[j], vf.y, ay);
        }
        orow[c] = E::store2(ax * rinv, ay * rinv);
      }
    }
    if (st != nullptr && lane == 0) {
      float* sp = st + (((long long)b * H + h) * S + r) * 2;
      sp[0] = mx;
      sp[1] = rinv;
    }
    __syncwarp();  // qs and sc are rewritten by the warp's next row
  }
}

template <typename T, int kD>
int launch(const void* qkv, void* out, void* st, int B, int S, int H, int D,
           float scale, cudaStream_t stream) {
  // pad K/V rows to an odd number of pairs (of 32-bit words for the 16-bit
  // types): conflict-free row reads
  const int d2 = D / 2;
  const int kv_words = (d2 % 2 == 0) ? d2 + 1 : d2;
  const size_t warp_bytes = (size_t)kWarps * warp_floats(D, S) * sizeof(float);
  const size_t kv_bytes =
      2 * (size_t)S * kv_words * sizeof(typename Elem<T>::Pair);
  const int kv_in_smem = (kv_bytes + warp_bytes <= kSmemBudget) ? 1 : 0;
  const size_t smem = warp_bytes + (kv_in_smem ? kv_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  attn_fwd_kernel<T, kD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(st), S, H, D, scale, kv_in_smem, kv_words);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* qkv, void* out, void* st, int B, int S, int H, int D,
             float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(qkv, out, st, B, S, H, D, scale, s);
    case 64: return launch<T, 64>(qkv, out, st, B, S, H, D, scale, s);
    case 128: return launch<T, 128>(qkv, out, st, B, S, H, D, scale, s);
    default: return launch<T, 0>(qkv, out, st, B, S, H, D, scale, s);
  }
}

}  // namespace

extern "C" {

// qkv (B, S, 3HD) and out (B, S, HD) of the element type `dtype` (fp32,
// kF32, alone); st
// (B, H, S, 2) fp32 or null. Returns a cudaError_t as int: 0 on a launch
// that was accepted.
int vtx_attn_fwd(const void* qkv, void* out, void* st, int B, int S, int H,
                 int D, float scale, int dtype, void* stream) {
  // offsets inside one image are 32-bit: S * 3 * H * D must fit
  if (B < 1 || B > 65535 || S < 1 || S > kMaxSeq || H < 1 || H > 65535 ||
      D < 2 || (D & 1) || D > kMaxHeadDim ||
      (long long)S * 3 * H * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  return launch_d<float>(qkv, out, st, B, S, H, D, scale, s);
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
