// Softmax attention forward over (B, H, S, D) q, k and v given by strides,
// for Hopper, in fp32.
//
// Replaces two TPU kernels of
// vision_transformers_torch_xla_tpu/ops/flash_attention.py that compute the
// same function over two layouts:
//   _fwd_kernel (K7): q, k, v (B*H, Sp, Dp), G (b, h) pairs per program;
//   _qkv_fwd_kernel (K11): one (B, Sp, 3H, D) qkv buffer, one image per
//     program, o (B, Sp, H, D).
// Per (b, h), in their cast order:
//   s = (q k^T in fp32 from the raw values) * scale over the S real keys;
//   m = rowmax(s); p = exp(s - m) / sum(exp(s - m)), normalised in fp32;
//   o = T(p) v, accumulated in fp32, stored T (T the inputs' dtype).
// This is not K1's and K9's order (csrc/attn_fwd.cu): there q^ = T(q *
// scale) and p is cast before it is normalised, o scaled by 1 / sum after
// the product. The TPU kernels pad S to 128 and D to 8 and mask the padded
// columns; here the loops run over the S real keys and the D real columns.
//
// Element types: the loops are written for any element type through
// csrc/elem.cuh. This source serves fp32 at every head dim, where every
// rounding to T is an identity (a tensor-core product of fp32 operands,
// TF32, would round what the TPU kernels keep), and bf16 and fp16 at head
// dims over 128. Below that the 16-bit types run on the tensor cores
// (csrc/attn_fwd_tc.cu, K7's cast order), whose tiles do not fit a wider
// head: at a head dim padded to 192, Q (128 rows) and a 2-stage ring of K
// and V (128 keys) take 48 + 96 + 96 = 240 KB of the 227 KB a block may
// have.
//
// Every tensor is a base pointer and three element strides (batch, head,
// token) with the head dim contiguous, so K7 reads (B, H, S, D) tensors and
// K11 reads q, k and v in place in the qkv buffer and writes o straight into
// a (B, S, H*D) output, with no copy in or out.
//
// What bounds it on an H100: at B = 128, S = 197, H = 12, D = 64 the two
// products are 15 GFLOP over ~310 MB of fp32 (q, k, v read, o written):
// 0.228 ms at the 67 TFLOP/s fp32 CUDA-core peak, 0.093 ms at 3.35 TB/s, so
// the products bound the ideal kernel. The limit in practice is instruction
// issue: every two FMAs come with a shared-memory load.
//
// Design, K1's: one block per (b, h, 64-row query tile). K and V of the head
// are staged once in shared memory (rows padded to an odd number of 32-bit
// words, so lanes reading different key rows hit different banks); each warp
// owns one query row at a time: lanes split the keys for q k^T, warp
// shuffles give the row max and sum, and lanes split the head dim for p v.
// The score row never leaves shared memory. s is scaled with __fmul_rn, so
// the compiler cannot fuse the scale into the subtraction of m. For head dims
// 32, 64 and 128 (fp32) the head dim is a compile-time constant, q sits in
// registers and the loops unroll; other even head dims, up to 1024, take the
// run-time loops. When K and V do not fit (long S with wide D), they are read from
// global memory (L2) through the same loops.
//
// Plain C interface, loaded with ctypes. The kernel allocates nothing and
// launches on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;          // query rows in flight per block
constexpr int kRowsPerBlock = 64;  // query tile of one block
constexpr int kMaxHeadDim = 1024;  // the per-warp scratch stays < 227 KB
constexpr int kMaxSeq = 1024;
constexpr long long kMaxGridX = 2147483647;  // (b, h, tile) ride grid x
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

enum { kQ, kK, kV, kO, kTensors };

// Element strides of the four (B, H, S, D) tensors, whose base pointers are
// the kernel's __restrict__ parameters. Token strides are int: the host
// checks that one head's rows span < 2^31.
struct Layout {
  long long sb[kTensors], sh[kTensors];
  int ss[kTensors];
  int S, H, D;
  int tiles;  // query tiles of one head
  float scale;
  int kv_in_smem, kv_words;
};

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

// Tensor t's rows of head (b, h).
template <typename T>
__device__ __forceinline__ T* head(T* p, const Layout& a, int t, int b,
                                   int h) {
  return p + b * a.sb[t] + h * a.sh[t];
}

// Floats of one warp's scratch: q (D) then scores (S), padded to 16 bytes.
__host__ __device__ inline int warp_floats(int D, int S) {
  return (D + S + 3) & ~3;
}

// 1-D grid over (b, h, query tile), so B and H are bound by grid x alone
// (2^31 - 1 blocks), not by the 65535 of y and z. Shared memory: per warp
// [q: D][scores: S] (16-byte aligned), then [K: S x kv_words][V: S x
// kv_words] when kv_in_smem. kD > 0 fixes the head dim at compile time (a
// multiple of 4); kD == 0 reads a.D.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32)
fused_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const Layout a) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = kD > 0 ? kD : a.D;
  const int S = a.S;
  const int bh = blockIdx.x / a.tiles;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int row0 = (blockIdx.x - bh * a.tiles) * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D2 = D >> 1;  // pairs in a head row

  const T* qg = head(q, a, kQ, b, h);
  T* og = head(o, a, kO, b, h);
  const Pair* kp = reinterpret_cast<const Pair*>(head(k, a, kK, b, h));
  const Pair* vp = reinterpret_cast<const Pair*>(head(v, a, kV, b, h));
  int k_stride = a.ss[kK] >> 1, v_stride = a.ss[kV] >> 1;  // in pairs

  const int wf = warp_floats(D, S);
  float* qs = smem + warp * wf;
  float* sc = qs + D;
  if (a.kv_in_smem) {
    Pair* ks = reinterpret_cast<Pair*>(smem + kWarps * wf);
    Pair* vs = ks + S * a.kv_words;
    for (int i = threadIdx.x; i < S * D2; i += blockDim.x) {
      const int r = i / D2, c = i - r * D2;
      ks[r * a.kv_words + c] = kp[r * k_stride + c];
      vs[r * a.kv_words + c] = vp[r * v_stride + c];
    }
    kp = ks;
    vp = vs;
    k_stride = v_stride = a.kv_words;
  }
  __syncthreads();

  const int row_end = min(row0 + kRowsPerBlock, S);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const T* qrow = qg + r * a.ss[kQ];
    for (int d = lane; d < D; d += 32) qs[d] = E::load(qrow[d]);
    __syncwarp();

    // s = (q k^T) * scale: lane j takes keys j, j + 32, ...
    float mx = -FLT_MAX;
    if constexpr (kD > 0) {
      float qr[kD];
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(qs + d);
        qr[d] = t.x;
        qr[d + 1] = t.y;
        qr[d + 2] = t.z;
        qr[d + 3] = t.w;
      }
      for (int j = lane; j < S; j += 32) {
        const Pair* kr = kp + j * k_stride;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 2; ++c) {
          const float2 kf = E::load2(kr[c]);
          a0 = fmaf(qr[2 * c], kf.x, a0);
          a1 = fmaf(qr[2 * c + 1], kf.y, a1);
        }
        const float s = __fmul_rn(a0 + a1, a.scale);
        sc[j] = s;
        mx = fmaxf(mx, s);
      }
    } else {
      for (int j = lane; j < S; j += 32) {
        const Pair* kr = kp + j * k_stride;
        float a0 = 0.f, a1 = 0.f;
        for (int c = 0; c < D2; ++c) {
          const float2 kf = E::load2(kr[c]);
          a0 = fmaf(qs[2 * c], kf.x, a0);
          a1 = fmaf(qs[2 * c + 1], kf.y, a1);
        }
        const float s = __fmul_rn(a0 + a1, a.scale);
        sc[j] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = warp_max(mx);

    // p = exp(s - m) / sum, normalised in fp32, then rounded to bf16 for
    // the p v product; each lane rereads only the keys it wrote
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(sc[j] - mx);
      sum += e;
      sc[j] = e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32)
      sc[j] = E::round(sc[j] / sum);
    __syncwarp();

    // o = bf16(p) v: lane c takes head-dim pairs c, c + 32
    Pair* orow = reinterpret_cast<Pair*>(og + r * a.ss[kO]);
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
              const float2 vf = E::load2(vp[(j + u) * v_stride + c]);
              ax[u] = fmaf(pj[u], vf.x, ax[u]);
              ay[u] = fmaf(pj[u], vf.y, ay[u]);
            }
          }
          for (; j < S; ++j) {
            const float2 vf = E::load2(vp[j * v_stride + c]);
            ax[0] = fmaf(sc[j], vf.x, ax[0]);
            ay[0] = fmaf(sc[j], vf.y, ay[0]);
          }
          orow[c] = E::store2((ax[0] + ax[1]) + (ax[2] + ax[3]),
                              (ay[0] + ay[1]) + (ay[2] + ay[3]));
        }
      }
    } else {
      for (int c = lane; c < D2; c += 32) {
        float ax = 0.f, ay = 0.f;
        for (int j = 0; j < S; ++j) {
          const float2 vf = E::load2(vp[j * v_stride + c]);
          ax = fmaf(sc[j], vf.x, ax);
          ay = fmaf(sc[j], vf.y, ay);
        }
        orow[c] = E::store2(ax, ay);
      }
    }
    __syncwarp();  // qs and sc are rewritten by the warp's next row
  }
}

template <typename T, int kD>
int launch(T* const* t, Layout a, int B, int H, cudaStream_t stream) {
  // pad K/V rows to an odd number of pairs (of 32-bit words for the 16-bit
  // types): conflict-free row reads
  const int d2 = a.D / 2;
  a.kv_words = (d2 % 2 == 0) ? d2 + 1 : d2;
  const size_t warp_bytes =
      (size_t)kWarps * warp_floats(a.D, a.S) * sizeof(float);
  const size_t kv_bytes =
      2 * (size_t)a.S * a.kv_words * sizeof(typename Elem<T>::Pair);
  a.kv_in_smem = (kv_bytes + warp_bytes <= kSmemBudget) ? 1 : 0;
  const size_t smem = warp_bytes + (a.kv_in_smem ? kv_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_attn_fwd_kernel<T, kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)B * H * a.tiles;
  fused_attn_fwd_kernel<T, kD><<<grid, kWarps * 32, smem, stream>>>(
      t[kQ], t[kK], t[kV], t[kO], a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* const* ptrs, const Layout& a, int B, int H,
             cudaStream_t s) {
  T* t[kTensors];
  for (int i = 0; i < kTensors; ++i)
    t[i] = const_cast<T*>(static_cast<const T*>(ptrs[i]));
  // bf16 and fp16 come here at head dims over 128 alone: run-time loops
  if constexpr (std::is_same<T, float>::value) {
    switch (a.D) {
      case 32: return launch<T, 32>(t, a, B, H, s);
      case 64: return launch<T, 64>(t, a, B, H, s);
      case 128: return launch<T, 128>(t, a, B, H, s);
    }
  }
  return launch<T, 0>(t, a, B, H, s);
}

}  // namespace

extern "C" {

// q, k, v in, o out: (B, H, S, D) of the element type `dtype` (bf16 and
// fp16 at head dims <= 128 are csrc/attn_fwd_tc.cu's) with the head dim
// contiguous; strides holds 12 element strides,
// (batch, head, token) of q, k, v and o. Returns a cudaError_t as int: 0 on
// a launch that was accepted.
int vtx_fused_attn_fwd(const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int B, int S, int H, int D,
                       float scale, int dtype, void* stream) {
  const int tiles = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 ||
      (long long)B * H * tiles > kMaxGridX || D < 2 || (D & 1) ||
      D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBf16 && dtype != kF16 && dtype != kF32)
    return (int)cudaErrorInvalidValue;
  const uintptr_t pair_bytes = dtype == kF32 ? 8 : 4;
  Layout a;
  const void* ptrs[kTensors] = {q, k, v, o};
  for (int t = 0; t < kTensors; ++t) {
    const long long sb = strides[3 * t], sh = strides[3 * t + 1],
                    ss = strides[3 * t + 2];
    // rows are read and written as pairs: pair-aligned, even strides
    if ((reinterpret_cast<uintptr_t>(ptrs[t]) & (pair_bytes - 1)) ||
        ((sb | sh | ss) & 1) || sb < 0 || sh < 0 || ss < 0 ||
        ss * (S - 1) + D >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    a.sb[t] = sb;
    a.sh[t] = sh;
    a.ss[t] = (int)ss;
  }
  a.S = S;
  a.H = H;
  a.D = D;
  a.tiles = tiles;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: return launch_d<__nv_bfloat16>(ptrs, a, B, H, s);
    case kF16: return launch_d<__half>(ptrs, a, B, H, s);
    default: return launch_d<float>(ptrs, a, B, H, s);
  }
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
