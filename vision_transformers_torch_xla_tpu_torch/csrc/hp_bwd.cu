// Softmax attention backward that recomputes the probabilities on its own,
// over (B, H, S, D) q, k, v, dO, dq, dk and dv given by strides, on the
// CUDA cores of a Hopper card. Which kernel serves which dtype and head dim
// D (the library is this file and csrc/hp_bwd_simt.cu, linked together):
//   fp32, D <= 256: csrc/hp_bwd_simt.cu (hp_bwd_stats_simt_kernel,
//     hp_bwd_dkdv_simt_kernel, hp_bwd_dq_sum_kernel: register tiles, 7
//     products; past 128 its wide tiles, hp_bwd_stats_wide_simt_kernel
//     and hp_bwd_dkdv_wide_simt_kernel), which vtx_hp_bwd hands float at
//     D <= 256;
//   fp32, bf16 and fp16 past 256 (to 1024): this file's loops,
//     hp_bwd_dq_kernel<T, 0> and hp_bwd_dkdv_kernel<T, 0> (run-time head
//     dim; the compile-time head dims of HeadRow and lane_pairs are no
//     longer instantiated);
//   bf16 and fp16 to 256: the tensor cores, csrc/hp_bwd_tc.cu (its wide
//     tiles stop at 256).
// fp32 stays off the tensor cores: the TPU kernels round nothing in fp32
// and a tensor-core product of fp32 operands (TF32) would.
// Measured on an H100 80GB HBM3 at 700 W, device ms of one call at (B, S,
// H, D) = (128, 197, 12, 64) (PERF.md §6): fp32 K8, K10, K12 2.46-2.47 on
// csrc/hp_bwd_simt.cu (this file's loops before it: 5.50; SDPA's fp32
// backward 2.12).
//
// Replaces three TPU kernels of
// vision_transformers_torch_xla_tpu/ops/flash_attention.py that compute the
// same function over different layouts:
//   _hp_bwd_kernel (K10), the backward of the head-pair attention whose
//     forward (K9) keeps no row stats and no o: q, k, v read from a fused
//     (B, S, 3*H*D) qkv buffer, dq, dk, dv written into one such buffer;
//   _bwd_kernel (K8), the backward of _fwd_kernel (K7): separate (B*H, Sp,
//     Dp) q, k, v, dO in and dq, dk, dv out, G (b, h) pairs per program;
//   _qkv_bwd_kernel (K12), the backward of _qkv_fwd_kernel (K11): a (B, Sp,
//     3H, D) qkv buffer and (B, Sp, H, D) dO in, dqkv (B, Sp, 3H, D) out,
//     which is K10's layout.
// Per (b, h), from q, k, v and dO alone:
//   s = (q k^T) * scale over the S real keys; m = rowmax(s);
//   p = exp(s - m) / sum(exp(s - m)); dv = p^T dO; dp = dO v^T;
//   delta = rowsum(dp * p); ds = p (dp - delta);
//   dq = (ds k) * scale; dk = (ds^T q) * scale.
// Every tensor is a base pointer and three element strides (batch, head,
// token) with the head dim contiguous: K10 and K12 read q, k and v in place
// in the qkv buffer and write dq, dk and dv at its standard columns h*D,
// H*D + h*D and 2*H*D + h*D, so the TPU kernel's three outputs and their
// concatenation are one buffer; K8 writes three (B, H, S, D) outputs. The
// TPU kernels pad S to 128 and D to 8 and mask the padded columns; here the
// loops run over the S real keys and queries. This is not K2's function
// (csrc/attn_bwd.cu): there are no stats from the forward, and delta is
// sum(dp * p), since these kernels have no o to form rowsum(dO * o).
//
// What bounds it on an H100: at B = 128, S = 197, H = 12, D = 64 the five
// products are 38 GFLOP over ~541 MB in fp32 (qkv and dO read, dqkv
// written), so the 67 TFLOP/s of the CUDA cores bound the ideal kernel
// (0.57 ms). This file's loops are bound by instruction issue: every two
// FMAs come with a shared-memory load, and they compute s and dp twice.
//
// Design: two launches, so that no sum crosses blocks and nothing needs
// float atomics (the result is deterministic):
//   1. dq and the row stats, one block per (b, h): K and V staged in shared
//      memory; each warp owns one query row at a time: lanes split the keys
//      for s, m and the sum of exp, then for p, dp and delta, then for ds;
//      the rows of p and ds stay in shared memory, and lanes split the head
//      dim for ds k. The row's m, sum and delta go to a (B, H, S, 3) fp32
//      scratch the caller allocates.
//   2. dk and dv, one block per (b, h): q, dO and the row stats staged in
//      shared memory; each warp owns one key row at a time and recomputes p
//      and ds for it over all queries from the stats, then lanes split the
//      head dim for p^T dO and ds^T q.
// Both passes form each s and dp as the same fp32 FMA chain over the head
// dim (the operands only swap sides) and scale s with __fmul_rn, which the
// compiler never fuses into the subtraction of m, so p and ds agree bit for
// bit between them. Staged rows are padded to an odd number of 32-bit
// words, so lanes reading different rows hit different banks. The head dim
// is a run-time value (every even one up to 1024). Operands that do not
// fit in shared memory (long S with wide D) are read from global memory (L2)
// through the same loops. The loops are written over csrc/elem.cuh's
// element type, whose rounding points are identities in fp32 and round to
// bf16 or fp16 where the TPU kernels cast.
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 1024;  // the per-warp scratch stays < 227 KB
constexpr int kMaxSeq = 1024;
constexpr long long kMaxGridX = 2147483647;  // (b, h) ride grid x
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

enum { kQ, kK, kV, kDO, kDQ, kDK, kDV, kTensors };

// Element strides of the seven (B, H, S, D) tensors, whose base pointers
// are the kernels' __restrict__ parameters. Token strides are int: the host
// checks that one head's rows span < 2^31.
struct Layout {
  long long sb[kTensors], sh[kTensors];
  int ss[kTensors];
  int S, H, D;
  float scale;
  int in_smem, pitch;
};

// Tensor t's rows of head (b, h).
template <typename T>
__device__ __forceinline__ T* head(T* p, const Layout& a, int t, int b,
                                   int h) {
  return p + b * a.sb[t] + h * a.sh[t];
}

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

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// One head row of fp32 values: in registers when the head dim kD is fixed at
// compile time (a multiple of 4), else read from the warp's shared scratch.
template <int kD>
struct HeadRow {
  float r[kD > 0 ? kD : 1];
  const float* s;

  __device__ __forceinline__ void load(const float* src) {
    if constexpr (kD > 0) {
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(src + d);
        r[d] = t.x;
        r[d + 1] = t.y;
        r[d + 2] = t.z;
        r[d + 3] = t.w;
      }
    } else {
      s = src;
    }
  }

  // dot product with a row of D2 pairs
  template <typename Pair>
  __device__ __forceinline__ float dot(const Pair* x, int D2) const {
    float a0 = 0.f, a1 = 0.f;
    if constexpr (kD > 0) {
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) {
        const float2 f = load2(x[c]);
        a0 = fmaf(r[2 * c], f.x, a0);
        a1 = fmaf(r[2 * c + 1], f.y, a1);
      }
    } else {
      for (int c = 0; c < D2; ++c) {
        const float2 f = load2(x[c]);
        a0 = fmaf(s[2 * c], f.x, a0);
        a1 = fmaf(s[2 * c + 1], f.y, a1);
      }
    }
    return a0 + a1;
  }
};

// sum_j w[j] * x[j][c] over j < n, for the pair column c of rows `stride`
// pairs apart; w is 16-byte aligned shared memory.
template <typename Pair>
__device__ __forceinline__ float2 wsum_col(const float* w, const Pair* x,
                                           int stride, int c, int n) {
  float ax[4] = {0.f, 0.f, 0.f, 0.f}, ay[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + j);
    const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = load2(x[(j + u) * stride + c]);
      ax[u] = fmaf(wj[u], f.x, ax[u]);
      ay[u] = fmaf(wj[u], f.y, ay[u]);
    }
  }
  for (; j < n; ++j) {
    const float2 f = load2(x[j * stride + c]);
    ax[0] = fmaf(w[j], f.x, ax[0]);
    ay[0] = fmaf(w[j], f.y, ay[0]);
  }
  return make_float2((ax[0] + ax[1]) + (ax[2] + ax[3]),
                     (ay[0] + ay[1]) + (ay[2] + ay[3]));
}

// Copy S rows of D2 pairs (global rows `src_stride` pairs apart) into shared
// memory rows `pitch` pairs apart.
template <typename Pair>
__device__ void stage_rows(Pair* dst, int pitch, const Pair* src,
                           int src_stride, int S, int D2) {
  for (int i = threadIdx.x; i < S * D2; i += blockDim.x) {
    const int r = i / D2, c = i - r * D2;
    dst[r * pitch + c] = src[r * src_stride + c];
  }
}

// f(c) for each head-dim pair c a lane owns (lane, lane + 32, ...):
// unrolled when the head dim kD is fixed at compile time.
template <int kD, typename F>
__device__ __forceinline__ void lane_pairs(int lane, int D2, F&& f) {
  if constexpr (kD > 0) {
#pragma unroll
    for (int u = 0; u < (kD / 2 + 31) / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < D2) f(c);
    }
  } else {
    for (int c = lane; c < D2; c += 32) f(c);
  }
}

// Read a head row into the warp's fp32 scratch.
template <typename T>
__device__ __forceinline__ void row_to_scratch(float* xs, const T* row,
                                               int D, int lane) {
  for (int d = lane; d < D; d += 32) xs[d] = Elem<T>::load(row[d]);
  __syncwarp();
}

// 1. grid B * H. Shared memory: per warp [row: D][p: S][ds: S] (each padded
// to 16 bytes), then [K: S x pitch][V: S x pitch] when in_smem.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
hp_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 T* __restrict__ dqo, float* __restrict__ stats,
                 const Layout a) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = kD > 0 ? kD : a.D;
  const int S = a.S;
  const float scale = a.scale;
  // (b, h) ride grid x alone, so B and H are not bound by y's 65535
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D2 = D >> 1;
  const long long bh = (long long)b * a.H + h;

  const T* qg = head(q, a, kQ, b, h);
  const T* dog = head(dout, a, kDO, b, h);
  T* dqg = head(dqo, a, kDQ, b, h);
  const Pair* kp = reinterpret_cast<const Pair*>(head(k, a, kK, b, h));
  const Pair* vp = reinterpret_cast<const Pair*>(head(v, a, kV, b, h));
  int k_stride = a.ss[kK] >> 1, v_stride = a.ss[kV] >> 1;  // in pairs
  const int wf = round4(D) + 2 * round4(S);
  float* xs = smem + warp * wf;
  float* ps = xs + round4(D);
  float* ts = ps + round4(S);
  if (a.in_smem) {
    Pair* ks = reinterpret_cast<Pair*>(smem + kWarps * wf);
    Pair* vs = ks + S * a.pitch;
    stage_rows(ks, a.pitch, kp, k_stride, S, D2);
    stage_rows(vs, a.pitch, vp, v_stride, S, D2);
    kp = ks;
    vp = vs;
    k_stride = v_stride = a.pitch;
  }
  __syncthreads();

  HeadRow<kD> row;
  for (int i = warp; i < S; i += kWarps) {
    // s = (q k^T) scale and its max: lanes split the keys
    row_to_scratch(xs, qg + i * a.ss[kQ], D, lane);
    row.load(xs);
    float mx = -FLT_MAX;
    for (int j = lane; j < S; j += 32) {
      const float s = __fmul_rn(row.dot(kp + j * k_stride, D2), scale);
      ps[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(ps[j] - m);
      ps[j] = e;
      sum += e;
    }
    const float l = warp_sum(sum);
    // p = e / l, dp = dO v^T and delta = sum(dp p)
    row_to_scratch(xs, dog + i * a.ss[kDO], D, lane);
    row.load(xs);
    float dsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = ps[j] / l;
      const float dp = row.dot(vp + j * v_stride, D2);
      ps[j] = p;
      ts[j] = dp;
      dsum = fmaf(dp, p, dsum);
    }
    const float delta = warp_sum(dsum);
    for (int j = lane; j < S; j += 32)
      ts[j] = E::round(ps[j] * (ts[j] - delta));
    __syncwarp();
    // dq = (ds k) scale: lanes split the head dim
    Pair* dq = reinterpret_cast<Pair*>(dqg + i * a.ss[kDQ]);
    lane_pairs<kD>(lane, D2, [&](int c) {
      const float2 w = wsum_col(ts, kp, k_stride, c, S);
      dq[c] = E::store2(w.x * scale, w.y * scale);
    });
    if (lane == 0) {
      float* st = stats + (bh * S + i) * 3;
      st[0] = m;
      st[1] = l;
      st[2] = delta;
    }
    __syncwarp();  // xs, ps and ts are rewritten by the warp's next row
  }
}

// 2. grid B * H. Shared memory: per warp [row: D][p: S][ds: S], then
// [m: S][l: S][delta: S], then [q: S x pitch][dO: S x pitch] when in_smem.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
hp_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dko,
                   T* __restrict__ dvo, const Layout a) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = kD > 0 ? kD : a.D;
  const int S = a.S;
  const float scale = a.scale;
  // (b, h) ride grid x alone, so B and H are not bound by y's 65535
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D2 = D >> 1;
  const long long bh = (long long)b * a.H + h;

  const int wf = round4(D) + 2 * round4(S);
  float* xs = smem + warp * wf;
  float* ps = xs + round4(D);
  float* ts = ps + round4(S);
  float* ms = smem + kWarps * wf;
  float* ls = ms + round4(S);
  float* dl = ls + round4(S);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const float* st = stats + (bh * S + i) * 3;
    ms[i] = st[0];
    ls[i] = st[1];
    dl[i] = st[2];
  }
  const T* kg = head(k, a, kK, b, h);
  const T* vg = head(v, a, kV, b, h);
  T* dkg = head(dko, a, kDK, b, h);
  T* dvg = head(dvo, a, kDV, b, h);
  const Pair* q_p = reinterpret_cast<const Pair*>(head(q, a, kQ, b, h));
  const Pair* do_p = reinterpret_cast<const Pair*>(head(dout, a, kDO, b, h));
  int q_stride = a.ss[kQ] >> 1, do_stride = a.ss[kDO] >> 1;  // in pairs
  if (a.in_smem) {
    Pair* rows = reinterpret_cast<Pair*>(dl + round4(S));
    stage_rows(rows, a.pitch, q_p, q_stride, S, D2);
    stage_rows(rows + S * a.pitch, a.pitch, do_p, do_stride, S, D2);
    q_p = rows;
    do_p = rows + S * a.pitch;
    q_stride = do_stride = a.pitch;
  }
  __syncthreads();

  HeadRow<kD> row;
  for (int j = warp; j < S; j += kWarps) {
    // p = exp((k_j q^T) scale - m) / l for every query: lanes split them
    row_to_scratch(xs, kg + j * a.ss[kK], D, lane);
    row.load(xs);
    for (int i = lane; i < S; i += 32)
      ps[i] = expf(__fmul_rn(row.dot(q_p + i * q_stride, D2), scale) - ms[i]) /
              ls[i];
    __syncwarp();
    // ds = bf16(p (dO v_j - delta)); keep bf16(p) for dv
    row_to_scratch(xs, vg + j * a.ss[kV], D, lane);
    row.load(xs);
    for (int i = lane; i < S; i += 32) {
      const float p = ps[i];
      ts[i] = E::round(p * (row.dot(do_p + i * do_stride, D2) - dl[i]));
      ps[i] = E::round(p);
    }
    __syncwarp();
    // dk = (ds^T q) scale, dv = bf16(p)^T dO: lanes split the head dim
    Pair* dk = reinterpret_cast<Pair*>(dkg + j * a.ss[kDK]);
    Pair* dv = reinterpret_cast<Pair*>(dvg + j * a.ss[kDV]);
    lane_pairs<kD>(lane, D2, [&](int c) {
      const float2 wk = wsum_col(ts, q_p, q_stride, c, S);
      const float2 wv = wsum_col(ps, do_p, do_stride, c, S);
      dk[c] = E::store2(wk.x * scale, wk.y * scale);
      dv[c] = E::store2(wv.x, wv.y);
    });
    __syncwarp();  // xs, ps and ts are rewritten by the warp's next row
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int kD>
int launch(T* const* t, float* stats, Layout a, int B, cudaStream_t stream) {
  const int S = a.S, D = a.D;
  // pad staged rows to an odd number of pairs (of 32-bit words for the
  // 16-bit types): conflict-free reads
  const int d2 = D / 2;
  a.pitch = (d2 % 2 == 0) ? d2 + 1 : d2;
  const size_t rows_bytes =
      (size_t)S * a.pitch * sizeof(typename Elem<T>::Pair);
  const size_t scratch =
      (size_t)kWarps * (round4(D) + 2 * round4(S)) * sizeof(float);
  const unsigned grid = (unsigned)B * a.H;

  a.in_smem = scratch + 2 * rows_bytes <= kSmemBudget ? 1 : 0;
  const size_t dq_smem = scratch + (a.in_smem ? 2 * rows_bytes : 0);
  int rc = set_smem((const void*)hp_bwd_dq_kernel<T, kD>, dq_smem);
  if (rc) return rc;
  hp_bwd_dq_kernel<T, kD><<<grid, kThreads, dq_smem, stream>>>(
      t[kQ], t[kK], t[kV], t[kDO], t[kDQ], stats, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t kv_scratch = scratch + 3 * (size_t)round4(S) * sizeof(float);
  a.in_smem = kv_scratch + 2 * rows_bytes <= kSmemBudget ? 1 : 0;
  const size_t kv_smem = kv_scratch + (a.in_smem ? 2 * rows_bytes : 0);
  rc = set_smem((const void*)hp_bwd_dkdv_kernel<T, kD>, kv_smem);
  if (rc) return rc;
  hp_bwd_dkdv_kernel<T, kD><<<grid, kThreads, kv_smem, stream>>>(
      t[kQ], t[kK], t[kV], t[kDO], stats, t[kDK], t[kDV], a);
  return (int)cudaGetLastError();
}

// Every dtype comes here at head dims over 256 alone (fp32 below is
// csrc/hp_bwd_simt.cu's, bf16 and fp16 csrc/hp_bwd_tc.cu's): run-time
// loops.
template <typename T>
int launch_d(const void* const* ptrs, float* stats, const Layout& a, int B,
             cudaStream_t s) {
  T* t[kTensors];
  for (int i = 0; i < kTensors; ++i)
    t[i] = const_cast<T*>(static_cast<const T*>(ptrs[i]));
  return launch<T, 0>(t, stats, a, B, s);
}

}  // namespace

// csrc/hp_bwd_simt.cu, linked into this library: fp32 at D <= 256.
namespace hp_bwd_simt {
long long scratch_floats(int B, int H, int S, int D);
int run(const void* const* ptrs, const long long* strides, float* scratch,
        int B, int S, int H, int D, float scale, cudaStream_t stream);
}  // namespace hp_bwd_simt

extern "C" {

// The fp32 scratch vtx_hp_bwd takes for these sizes and element type, in
// floats: the row stats of this file's loops (B, H, S, 3), or those of
// csrc/hp_bwd_simt.cu's kernels and their parts of dq.
long long vtx_hp_bwd_scratch(int B, int S, int H, int D, int dtype) {
  if (dtype == kF32 && D <= 256)
    return hp_bwd_simt::scratch_floats(B, H, S, D);
  return (long long)B * H * S * 3;
}

// q, k, v, dout in and dq, dk, dv out: (B, H, S, D) of the element type
// `dtype` (bf16 and fp16 at head dims <= 256 are csrc/hp_bwd_tc.cu's) with
// the head dim contiguous; strides holds 21 element strides,
// (batch, head, token) of each in that order; stats is fp32 scratch of
// vtx_hp_bwd_scratch floats. Returns a cudaError_t as int: 0 when every
// launch was accepted.
int vtx_hp_bwd(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, void* stats,
               const long long* strides, int B, int S, int H, int D,
               float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 ||
      (long long)B * H > kMaxGridX || D < 2 || (D & 1) || D > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBf16 && dtype != kF16 && dtype != kF32)
    return (int)cudaErrorInvalidValue;
  const uintptr_t pair_bytes = dtype == kF32 ? 8 : 4;
  Layout a;
  const void* ptrs[kTensors] = {q, k, v, dout, dq, dk, dv};
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
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D <= 256)
    return hp_bwd_simt::run(ptrs, strides, st, B, S, H, D, scale, s);
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  switch (dtype) {
    case kBf16: return launch_d<__nv_bfloat16>(ptrs, st, a, B, s);
    case kF16: return launch_d<__half>(ptrs, st, a, B, s);
    default: return launch_d<float>(ptrs, st, a, B, s);
  }
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
