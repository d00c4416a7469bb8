// Softmax attention forward over a fused (B, S, 3*H*D) qkv buffer on the
// CUDA cores, for Hopper: fp32 at every head dim, and bf16 and fp16 at head
// dims over the tensor-core tiles' 256.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_fwd_stats_kernel (K1), and _hp_fwd_kernel (K9: the same launch
// with the stats pointer null). Same function, per (b, h):
//   q^ = rnd(q * rnd(scale)); s = q^ k^T in fp32 (columns >= S do not exist);
//   m = rowmax(s); p = exp(s - m); rinv = 1 / sum(p);
//   o = (rnd(p) v, accumulated in fp32) * rinv, stored rnd() at (B, S, H*D);
//   optionally st = (B, H, S, 2) fp32 holding [m, rinv] per query row.
// rnd() rounds to the element type (csrc/elem.cuh); in fp32 every rnd() is
// the identity. q, k and v are read by stride straight from the projection
// output: q at column h*D, k at H*D + h*D, v at 2*H*D + h*D. The TPU
// kernel's 128-lane head-pair packing is a TPU layout rule and is not
// carried over.
//
// What bounds it on an H100: the products. At B = 128, S = 197, 12 heads of
// 64, s and p v are 4 B H S^2 D = 15.3 GFLOP: 0.228 ms at the 67 TFLOP/s
// fp32 peak of the CUDA cores, against 312 MB of fp32 qkv, o and stats
// (0.093 ms at 3.35 TB/s). fp32 has no tensor-core product that keeps the
// cast order (TF32 rounds the inputs), so the CUDA cores run it.
//
// fp32 at D <= 256: csrc/attn_fwd_simt.cuh's register tiles in K1's order
// (attn_fwd_simt_kernel<kD, false, kStore>, kD 32, 64, 128, 192 or 256),
// the (B, S, 3 H D) buffer given to it as q, k, v views by their strides.
// The header has the design and its times.
//
// Other element types and fp32 past D = 256 (attn_fwd_kernel<T, 0>): the
// first design, with the head dim a run-time value. One block per (b, h,
// 64-row query tile); K and V of the head staged in shared memory (rows
// padded to an odd number of 32-bit words), or read from L2 when they do
// not fit (long S with a wide D); each warp owns one query row at a time:
// lanes split the keys for q^ k^T, warp shuffles give the row max and sum,
// lanes split the head dim for p v. bf16 and fp16 keep the cast order
// through csrc/elem.cuh (q^ and p rounded to the element type, o stored in
// it); they reach it only past the tensor-core tiles (csrc/attn_fwd_tc.cu
// takes D <= 256).
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function takes the element type's
// code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cfloat>
#include <climits>

#include <cuda_runtime.h>

#include "attn_fwd_simt.cuh"
#include "cc_tiles.cuh"
#include "elem.cuh"

namespace {

constexpr int kWarps = 8;          // query rows in flight per block
constexpr int kRowsPerBlock = 64;  // query tile of one block
constexpr int kMaxHeadDim = 1024;  // the port's MAX_CUDA_CORE_HEAD_DIM
constexpr int kMaxSeq = 1024;
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

// ---- any element type at a run-time head dim: attn_fwd_kernel<T, 0>

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
// [K: S x kv_words][V: S x kv_words] (pairs) when kv_in_smem. kD is 0: the
// head dim is d_rt.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                float* __restrict__ st, int S, int H, int d_rt, float scale,
                int kv_in_smem, int kv_words) {
  static_assert(kD == 0, "the run-time head-dim loops");
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = d_rt;
  const int n_tiles = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (blockIdx.x % n_tiles) * kRowsPerBlock;
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
    for (int c = lane; c < D2; c += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < S; ++j) {
        const float2 vf = E::load2(vp[j * kv_stride + c]);
        ax = fmaf(sc[j], vf.x, ax);
        ay = fmaf(sc[j], vf.y, ay);
      }
      orow[c] = E::store2(ax * rinv, ay * rinv);
    }
    if (st != nullptr && lane == 0) {
      float* sp = st + (((long long)b * H + h) * S + r) * 2;
      sp[0] = mx;
      sp[1] = rinv;
    }
    __syncwarp();  // qs and sc are rewritten by the warp's next row
  }
}

template <typename T>
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
        attn_fwd_kernel<T, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks =
      (long long)((S + kRowsPerBlock - 1) / kRowsPerBlock) * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  attn_fwd_kernel<T, 0><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(st), S, H, D, scale, kv_in_smem, kv_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, S, 3HD) and out (B, S, HD) of the element type `dtype` (fp32 at D
// <= 256 on attn_fwd_simt_kernel, past it on the run-time loops; bf16 and
// fp16 on the run-time ones); st (B, H, S, 2) fp32 or null. D even and <=
// 1024. Returns a cudaError_t as int: 0 on a launch that was accepted.
int vtx_attn_fwd(const void* qkv, void* out, void* st, int B, int S, int H,
                 int D, float scale, int dtype, void* stream) {
  // offsets inside one image are 32-bit: S * 3 * H * D must fit
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 ||
      D < 2 || (D & 1) || D > kMaxHeadDim ||
      (long long)S * 3 * H * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (D <= 256) {
        // q, k, v: views of qkv at columns h D, H D + h D, 2 H D + h D
        const long long C = 3LL * H * D, HD = (long long)H * D;
        const float* x = static_cast<const float*>(qkv);
        const void* ptrs[kTensors] = {x, x + HD, x + 2 * HD, out};
        const long long strides[3 * kTensors] = {
            S * C, D, C, S * C, D, C, S * C, D, C, S * HD, D, HD};
        return attn_fwd_simt<false>(ptrs, static_cast<float*>(st), strides,
                                    B, S, H, D, scale, s);
      }
      return launch<float>(qkv, out, st, B, S, H, D, scale, s);
    case kBf16:  // q^ = T(q * T(scale)), as JAX scales in T
      return launch<__nv_bfloat16>(qkv, out, st, B, S, H, D,
                                   rounded_scale<__nv_bfloat16>(scale), s);
    case kF16:
      return launch<__half>(qkv, out, st, B, S, H, D,
                            rounded_scale<__half>(scale), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
