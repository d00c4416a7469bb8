// Softmax attention backward over a fused (B, S, 3*H*D) qkv buffer, for Hopper.
//
// Replaces the TPU kernel
// vision_transformers_torch_xla_tpu/ops/flash_attention.py
// ::_hp_bwd_pi_kernel (K2). Same function, per (b, h), from the forward's
// (B, H, S, 2) row stats [m, rinv] (csrc/attn_fwd.cu, with stats):
//   q^ = bf16(q * scale); s = q^ k^T in fp32 over the S real keys;
//   pu = exp(s - m), left unnormalized (it may exceed 1 by a few ulps: this
//     s is summed in another order than the forward's);
//   do_n = bf16(dO * rinv); dv = bf16(pu)^T do_n;
//   delta = rowsum(dO * O) in fp32, on (S, D) data;
//   dp = dO v^T; t = bf16((dp - delta) * pu);
//   dq = (t k) * (rinv * scale); qn = bf16(q^ * rinv); dk = t^T qn.
// Every product accumulates in fp32. dq, dk and dv are stored bf16 into one
// (B, S, 3*H*D) dqkv buffer at the standard columns h*D, H*D + h*D and
// 2*H*D + h*D, and their fp32 values summed over the sequence go to the
// (B, 3*H*D) qkv-bias partials in the same column order. The TPU kernel's
// pair-interleaved column order is a TPU layout rule and is not carried over.
//
// What bounds it on an H100: like the forward, one (b, h) is ~35 MFLOP over
// ~150 KB at ViT-B shapes (S = 197, D = 64), far below the ~295 FLOP/byte
// ridge, so device memory is not the limit. On the CUDA cores the limit is
// instruction issue: every two FMAs come with a load and two bf16 -> fp32
// conversions, and the backward does 7 S x S x D products per head against
// the forward's 2. fp32 has no tensor-core product that keeps the TPU
// kernel's cast order (TF32 rounds the inputs), so fp32 runs here.
//
// Design: three launches, so that no sum crosses blocks and nothing needs
// float atomics (the result is deterministic):
//   1. prep, one warp per (b, h, query row): q^, qn, do_n (bf16) and delta
//      (fp32) into scratch the caller allocates, (B, H, S, D) and (B, H, S).
//   2. dq, one block per (b, h): K and V staged in shared memory; each warp
//      owns one query row at a time: lanes split the keys for s and dp
//      (the row of q^ or dO in registers), the row of t stays in shared
//      memory, and lanes split the head dim for t k.
//   3. dk and dv, one block per (b, h): q^, dO, qn and do_n staged in shared
//      memory; each warp owns one key row at a time and recomputes s and dp
//      for it over all queries, then lanes split the head dim for
//      bf16(pu)^T do_n and t^T qn.
// One block per (b, h) lets each warp carry its share of the bias partials
// in registers; the warps' shares are summed in a fixed order at the end.
// Staged rows are padded to an odd number of 32-bit words, so lanes reading
// different rows hit different banks. For head dims 32, 64 and 128 the head
// dim is a compile-time constant and the row sits in registers; other even
// head dims take run-time loops. Operands that do not fit in shared memory
// (long S with wide D) are read from global memory (L2) through the same
// loops.
//
// Element types: this source serves fp32, which the TPU kernel computes
// with no rounding point (every astype an identity); the loops are written
// for any element type through csrc/elem.cuh, and bf16 and fp16 run on the
// tensor cores instead (csrc/attn_bwd_tc.cu).
//
// Plain C interface, loaded with ctypes. The kernels allocate nothing and
// launch on the caller's stream; the host function takes the element
// type's code (csrc/elem.cuh) and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSeq = 1024;
constexpr int kPairsPerLane = kMaxHeadDim / 2 / 32;  // head-dim pairs a lane owns
constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may have

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

// Read a head row into the warp's fp32 scratch.
template <typename T>
__device__ __forceinline__ void row_to_scratch(float* xs, const T* row,
                                               int D, int lane) {
  for (int d = lane; d < D; d += 32) xs[d] = Elem<T>::load(row[d]);
  __syncwarp();
}

// Sum the warps' per-lane bias partials in a fixed order and write D floats
// to dst. Reuses the start of shared memory, so it waits for every warp.
__device__ void write_bias(float* smem, const float2 (&acc)[kPairsPerLane],
                           float* dst, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPairsPerLane; ++u) {
    const int c = lane + 32 * u;
    if (2 * c < D) {
      smem[warp * D + 2 * c] = acc[u].x;
      smem[warp * D + 2 * c + 1] = acc[u].y;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += smem[w * D + d];
    dst[d] = s;
  }
}

// 1. grid (ceil(S / kWarps), H, B): warp w takes query row
// blockIdx.x * kWarps + w of head blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_prep_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const T* __restrict__ out, const float* __restrict__ st,
                     T* __restrict__ qhat, T* __restrict__ qn,
                     T* __restrict__ don, float* __restrict__ delta, int S,
                     int H, int D, float scale) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  const int b = blockIdx.z, h = blockIdx.y;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= S) return;  // the whole warp leaves together
  const int D2 = D >> 1;
  const long long bh = (long long)b * H + h;
  const long long bhi = bh * S + i;
  const float rinv = st[bhi * 2 + 1];
  const Pair* q = reinterpret_cast<const Pair*>(
      qkv + ((long long)b * S + i) * 3 * H * D + h * D);
  const long long oi = ((long long)b * S + i) * H * D + h * D;
  const Pair* g = reinterpret_cast<const Pair*>(dout + oi);
  const Pair* o = reinterpret_cast<const Pair*>(out + oi);
  Pair* qh2 = reinterpret_cast<Pair*>(qhat) + bhi * D2;
  Pair* qn2 = reinterpret_cast<Pair*>(qn) + bhi * D2;
  Pair* dn2 = reinterpret_cast<Pair*>(don) + bhi * D2;
  float acc = 0.f;
  for (int c = lane; c < D2; c += 32) {
    const float2 qf = E::load2(q[c]);
    const Pair qh = E::store2(qf.x * scale, qf.y * scale);
    const float2 qhf = E::load2(qh);
    qh2[c] = qh;
    qn2[c] = E::store2(qhf.x * rinv, qhf.y * rinv);
    const float2 gf = E::load2(g[c]);
    dn2[c] = E::store2(gf.x * rinv, gf.y * rinv);
    const float2 of = E::load2(o[c]);
    acc = fmaf(gf.x, of.x, acc);
    acc = fmaf(gf.y, of.y, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[bhi] = acc;
}

// 2. grid (H, B). Shared memory: per warp [row: D][t: S] (each padded to 16
// bytes), then [K: S x pitch][V: S x pitch] when kv_in_smem.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                   const float* __restrict__ st, const T* __restrict__ qhat,
                   const float* __restrict__ delta, T* __restrict__ dqkv,
                   float* __restrict__ dbias, int S, int H, int d_rt,
                   float scale, int kv_in_smem, int pitch) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = kD > 0 ? kD : d_rt;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D2 = D >> 1, C = 3 * H * D, C2 = C >> 1;
  const long long bh = (long long)b * H + h;

  const T* base = qkv + (long long)b * S * C;
  const Pair* kp = reinterpret_cast<const Pair*>(base + H * D + h * D);
  const Pair* vp = reinterpret_cast<const Pair*>(base + 2 * H * D + h * D);
  int kv_stride = C2;
  const int wf = round4(D) + round4(S);
  float* xs = smem + warp * wf;
  float* ts = xs + round4(D);
  if (kv_in_smem) {
    Pair* ks = reinterpret_cast<Pair*>(smem + kWarps * wf);
    Pair* vs = ks + S * pitch;
    stage_rows(ks, pitch, kp, C2, S, D2);
    stage_rows(vs, pitch, vp, C2, S, D2);
    kp = ks;
    vp = vs;
    kv_stride = pitch;
  }
  __syncthreads();

  HeadRow<kD> row;
  float2 bacc[kPairsPerLane];
#pragma unroll
  for (int u = 0; u < kPairsPerLane; ++u) bacc[u] = make_float2(0.f, 0.f);
  for (int i = warp; i < S; i += kWarps) {
    const long long bhi = bh * S + i;
    const float m = st[bhi * 2], rinv = st[bhi * 2 + 1], dlt = delta[bhi];
    // pu = exp(q^ k^T - m): lanes split the keys
    row_to_scratch(xs, qhat + bhi * D, D, lane);
    row.load(xs);
    for (int j = lane; j < S; j += 32)
      ts[j] = expf(row.dot(kp + j * kv_stride, D2) - m);
    __syncwarp();
    // t = bf16((dO v^T - delta) pu)
    row_to_scratch(xs, dout + ((long long)b * S + i) * H * D + h * D, D, lane);
    row.load(xs);
    for (int j = lane; j < S; j += 32)
      ts[j] = E::round((row.dot(vp + j * kv_stride, D2) - dlt) * ts[j]);
    __syncwarp();
    // dq = (t k) (rinv scale): lanes split the head dim
    Pair* dq = reinterpret_cast<Pair*>(dqkv + ((long long)b * S + i) * C +
                                       h * D);
    const float f = rinv * scale;
#pragma unroll
    for (int u = 0; u < kPairsPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c < D2) {
        float2 a = wsum_col(ts, kp, kv_stride, c, S);
        a.x *= f;
        a.y *= f;
        dq[c] = E::store2(a.x, a.y);
        bacc[u].x += a.x;
        bacc[u].y += a.y;
      }
    }
    __syncwarp();  // xs and ts are rewritten by the warp's next row
  }
  write_bias(smem, bacc, dbias + (long long)b * C + h * D, D);
}

// 3. grid (H, B). Shared memory: per warp [row: D][pu: S][t: S], then
// [m: S][delta: S], then [q^][dO][qn][do_n] (S x pitch each) when in_smem.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const float* __restrict__ st, const T* __restrict__ qhat,
                     const T* __restrict__ qn, const T* __restrict__ don,
                     const float* __restrict__ delta, T* __restrict__ dqkv,
                     float* __restrict__ dbias, int S, int H, int d_rt,
                     int in_smem, int pitch) {
  typedef Elem<T> E;
  typedef typename E::Pair Pair;
  extern __shared__ __align__(16) float smem[];
  const int D = kD > 0 ? kD : d_rt;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D2 = D >> 1, C = 3 * H * D, HD = H * D;
  const long long bh = (long long)b * H + h;

  const int wf = round4(D) + 2 * round4(S);
  float* xs = smem + warp * wf;
  float* ps = xs + round4(D);
  float* ts = ps + round4(S);
  float* ms = smem + kWarps * wf;
  float* ds = ms + round4(S);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    ms[i] = st[(bh * S + i) * 2];
    ds[i] = delta[bh * S + i];
  }
  // the query-side operands, (B, H, S, D) from prep and dO at (B, S, H*D)
  const Pair* qh_p = reinterpret_cast<const Pair*>(qhat) + bh * S * D2;
  const Pair* qn_p = reinterpret_cast<const Pair*>(qn) + bh * S * D2;
  const Pair* dn_p = reinterpret_cast<const Pair*>(don) + bh * S * D2;
  const Pair* do_p = reinterpret_cast<const Pair*>(
      dout + (long long)b * S * HD + h * D);
  int q_stride = D2, do_stride = HD >> 1;
  if (in_smem) {
    Pair* a = reinterpret_cast<Pair*>(ds + round4(S));
    stage_rows(a, pitch, qh_p, D2, S, D2);
    stage_rows(a + S * pitch, pitch, do_p, do_stride, S, D2);
    stage_rows(a + 2 * S * pitch, pitch, qn_p, D2, S, D2);
    stage_rows(a + 3 * S * pitch, pitch, dn_p, D2, S, D2);
    qh_p = a;
    do_p = a + S * pitch;
    qn_p = a + 2 * S * pitch;
    dn_p = a + 3 * S * pitch;
    q_stride = do_stride = pitch;
  }
  __syncthreads();

  const T* base = qkv + (long long)b * S * C;
  HeadRow<kD> row;
  float2 kacc[kPairsPerLane], vacc[kPairsPerLane];
#pragma unroll
  for (int u = 0; u < kPairsPerLane; ++u) {
    kacc[u] = make_float2(0.f, 0.f);
    vacc[u] = make_float2(0.f, 0.f);
  }
  for (int j = warp; j < S; j += kWarps) {
    // pu = exp(q^ k_j - m) for every query: lanes split the queries
    row_to_scratch(xs, base + (long long)j * C + HD + h * D, D, lane);
    row.load(xs);
    for (int i = lane; i < S; i += 32)
      ps[i] = expf(row.dot(qh_p + i * q_stride, D2) - ms[i]);
    __syncwarp();
    // t = bf16((dO v_j - delta) pu); keep bf16(pu) for dv
    row_to_scratch(xs, base + (long long)j * C + 2 * HD + h * D, D, lane);
    row.load(xs);
    for (int i = lane; i < S; i += 32) {
      const float pu = ps[i];
      ts[i] = E::round((row.dot(do_p + i * do_stride, D2) - ds[i]) * pu);
      ps[i] = E::round(pu);
    }
    __syncwarp();
    // dk = t^T qn, dv = bf16(pu)^T do_n: lanes split the head dim
    T* drow = dqkv + ((long long)b * S + j) * C + h * D;
    Pair* dk = reinterpret_cast<Pair*>(drow + HD);
    Pair* dv = reinterpret_cast<Pair*>(drow + 2 * HD);
#pragma unroll
    for (int u = 0; u < kPairsPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c < D2) {
        const float2 k = wsum_col(ts, qn_p, q_stride, c, S);
        const float2 v = wsum_col(ps, dn_p, q_stride, c, S);
        dk[c] = E::store2(k.x, k.y);
        dv[c] = E::store2(v.x, v.y);
        kacc[u].x += k.x;
        kacc[u].y += k.y;
        vacc[u].x += v.x;
        vacc[u].y += v.y;
      }
    }
    __syncwarp();  // xs, ps and ts are rewritten by the warp's next row
  }
  float* db = dbias + (long long)b * C + h * D;
  write_bias(smem, kacc, db + HD, D);
  write_bias(smem, vacc, db + 2 * HD, D);
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int kD>
int launch(const void* qkv, const void* dout, const void* out, const void* st,
           void* dqkv, void* dbias, void* qhat, void* qn, void* don,
           void* delta, int B, int S, int H, int D, float scale,
           cudaStream_t stream) {
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  const float* stats = static_cast<const float*>(st);
  T* qh = static_cast<T*>(qhat);
  T* qnn = static_cast<T*>(qn);
  T* dn = static_cast<T*>(don);
  float* dl = static_cast<float*>(delta);
  T* dx = static_cast<T*>(dqkv);
  float* db = static_cast<float*>(dbias);

  attn_bwd_prep_kernel<T><<<dim3((S + kWarps - 1) / kWarps, H, B), kThreads,
                            0, stream>>>(q, g, static_cast<const T*>(out),
                                         stats, qh, qnn, dn, dl, S, H, D,
                                         scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // pad staged rows to an odd number of pairs (of 32-bit words for the
  // 16-bit types): conflict-free reads
  const int d2 = D / 2;
  const int pitch = (d2 % 2 == 0) ? d2 + 1 : d2;
  const size_t rows_bytes =
      (size_t)S * pitch * sizeof(typename Elem<T>::Pair);
  const dim3 grid(H, B);

  const size_t dq_scratch =
      (size_t)kWarps * (round4(D) + round4(S)) * sizeof(float);
  const int kv_in_smem = dq_scratch + 2 * rows_bytes <= kSmemBudget ? 1 : 0;
  const size_t dq_smem = dq_scratch + (kv_in_smem ? 2 * rows_bytes : 0);
  int rc = set_smem((const void*)attn_bwd_dq_kernel<T, kD>, dq_smem);
  if (rc) return rc;
  attn_bwd_dq_kernel<T, kD><<<grid, kThreads, dq_smem, stream>>>(
      q, g, stats, qh, dl, dx, db, S, H, D, scale, kv_in_smem, pitch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t kv_scratch =
      ((size_t)kWarps * (round4(D) + 2 * round4(S)) + 2 * round4(S)) *
      sizeof(float);
  const int in_smem = kv_scratch + 4 * rows_bytes <= kSmemBudget ? 1 : 0;
  const size_t kv_smem = kv_scratch + (in_smem ? 4 * rows_bytes : 0);
  rc = set_smem((const void*)attn_bwd_dkdv_kernel<T, kD>, kv_smem);
  if (rc) return rc;
  attn_bwd_dkdv_kernel<T, kD><<<grid, kThreads, kv_smem, stream>>>(
      q, g, stats, qh, qnn, dn, dl, dx, db, S, H, D, in_smem, pitch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* qkv, const void* dout, const void* out,
             const void* st, void* dqkv, void* dbias, void* qhat, void* qn,
             void* don, void* delta, int B, int S, int H, int D, float scale,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(qkv, dout, out, st, dqkv, dbias, qhat, qn,
                                  don, delta, B, S, H, D, scale, s);
    case 64: return launch<T, 64>(qkv, dout, out, st, dqkv, dbias, qhat, qn,
                                  don, delta, B, S, H, D, scale, s);
    case 128: return launch<T, 128>(qkv, dout, out, st, dqkv, dbias, qhat,
                                    qn, don, delta, B, S, H, D, scale, s);
    default: return launch<T, 0>(qkv, dout, out, st, dqkv, dbias, qhat, qn,
                                 don, delta, B, S, H, D, scale, s);
  }
}

}  // namespace

extern "C" {

// dqkv (B, S, 3HD) of the element type `dtype` (fp32, kF32, alone) and
// dbias (B, 3HD) fp32 out;
// qhat, qn, don (B, H, S, D) of that type and delta (B, H, S) fp32 are
// scratch. Returns a cudaError_t as int: 0 when every launch was accepted.
int vtx_attn_bwd(const void* qkv, const void* dout, const void* out,
                 const void* st, void* dqkv, void* dbias, void* qhat, void* qn,
                 void* don, void* delta, int B, int S, int H, int D,
                 float scale, int dtype, void* stream) {
  // offsets inside one image are 32-bit: S * 3 * H * D must fit
  if (B < 1 || B > 65535 || S < 1 || S > kMaxSeq || H < 1 || H > 65535 ||
      D < 2 || (D & 1) || D > kMaxHeadDim ||
      (long long)S * 3 * H * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  return launch_d<float>(qkv, dout, out, st, dqkv, dbias, qhat, qn, don,
                         delta, B, S, H, D, scale, s);
}

const char* vtx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
