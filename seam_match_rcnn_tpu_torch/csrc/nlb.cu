// K3 — SEAM temporal aggregation: masked non-local block + attention pooling.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_kernels.py, nlb_aggregate (_nlb_kernel).
//
// Per track s (a padded sequence of T frame descriptors, C = 256, with a
// frame mask), in full f32 (no TF32, no bf16):
//   theta/phi/g = seq @ W + b                       (256 -> 128)
//   f[t,u]      = relu(theta_t.w1 + phi_u.w2) * mask_u / max(sum(mask), 1)
//   z           = (f @ g) @ W_z + b_z + seq         (128 -> 256, residual)
//   z_t         = seq_t where the track has <= 1 valid frame or t is padding
//   att         = softmax over valid frames of (z @ w_att + b_att)
//   out[s]      = sum_t att_t z_t
//
// What bounds it on an H100: launch latency.  At serving S = 1, T <= 10 the
// whole aggregation is about 3 MFLOP and reads 0.6 MB of weights; nothing
// here can fill the card.  Design: one block of 256 threads per track, every
// intermediate in shared memory (T <= 32 is checked by the wrapper), the
// 256x128 projections as k-loops over shared-memory rows with per-frame
// accumulators in registers, weights read straight from global memory by
// neighbouring threads (coalesced).  One launch replaces the dozen small
// kernels of the plain PyTorch version.
//
// Layouts: seqs [S,T,256], mask [S,T] (0/1), theta/phi/g kernels [256,128]
// (in-major, as the JAX Dense kernel), their biases [128], wcat [256],
// W_z kernel [128,256], b_z [256], w_att [256], b_att [1]; out [S,256].
#include <math.h>

#include "common.cuh"

namespace {

constexpr int C = 256;
constexpr int CI = 128;
constexpr int MAX_T = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nlb_kernel(const float* __restrict__ seqs, const float* __restrict__ mask,
           const float* __restrict__ theta_w, const float* __restrict__ theta_b,
           const float* __restrict__ phi_w, const float* __restrict__ phi_b,
           const float* __restrict__ g_w, const float* __restrict__ g_b,
           const float* __restrict__ wcat, const float* __restrict__ wz_w,
           const float* __restrict__ wz_b, const float* __restrict__ att_w,
           const float* __restrict__ att_b, float* __restrict__ out, int T) {
  extern __shared__ float smem[];
  float* s_seq = smem;            // [T][C]  seq, later z
  float* s_g = s_seq + T * C;     // [T][CI] g projection
  float* s_y = s_g + T * CI;      // [T][CI] phi.w2 partial products, later y
  float* s_p = s_y + T * CI;      // [T][CI] theta.w1 partial products
  float* s_f = s_p + T * CI;      // [T][T]  normalized affinity
  __shared__ float s_mask[MAX_T], s_a[MAX_T], s_c[MAX_T], s_att[MAX_T];
  __shared__ float s_red[MAX_T][THREADS / 32];
  __shared__ float s_n, s_multi;

  const int s = blockIdx.x, tid = threadIdx.x;
  const float* seq = seqs + (size_t)s * T * C;
  for (int i = tid; i < T * C; i += THREADS) s_seq[i] = seq[i];
  if (tid < T) s_mask[tid] = mask[(size_t)s * T + tid];
  __syncthreads();
  if (tid == 0) {
    float n = 0.f;
    for (int t = 0; t < T; ++t) n += s_mask[t];
    s_n = fmaxf(n, 1.f);
    s_multi = n > 1.f ? 1.f : 0.f;
  }

  // theta (threads 0..127, together with g) and phi (threads 128..255)
  {
    const int j = tid % CI;
    const bool first = tid < CI;
    const float* wa = first ? theta_w : phi_w;
    float acc_a[MAX_T], acc_g[MAX_T];
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) acc_a[t] = acc_g[t] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float wv = wa[c * CI + j];
      const float wg = first ? g_w[c * CI + j] : 0.f;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < T) {
          const float xv = s_seq[t * C + c];
          acc_a[t] = fmaf(xv, wv, acc_a[t]);
          acc_g[t] = fmaf(xv, wg, acc_g[t]);
        }
      }
    }
    const float ba = first ? theta_b[j] : phi_b[j];
    const float wc = wcat[first ? j : CI + j];
    float* part = first ? s_p : s_y;
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) {
      if (t < T) {
        part[t * CI + j] = (acc_a[t] + ba) * wc;
        if (first) s_g[t * CI + j] = acc_g[t] + g_b[j];
      }
    }
  }
  __syncthreads();

  // a_t = theta_t . w1 (threads 0..T-1), c_t = phi_t . w2 (threads 32..32+T-1)
  if (tid < T) {
    float a = 0.f;
    for (int j = 0; j < CI; ++j) a += s_p[tid * CI + j];
    s_a[tid] = a;
  } else if (tid >= MAX_T && tid < MAX_T + T) {
    const int t = tid - MAX_T;
    float cc = 0.f;
    for (int j = 0; j < CI; ++j) cc += s_y[t * CI + j];
    s_c[t] = cc;
  }
  __syncthreads();

  for (int i = tid; i < T * T; i += THREADS) {
    const int t = i / T, u = i % T;
    s_f[i] = fmaxf(s_a[t] + s_c[u], 0.f) * s_mask[u] / s_n;
  }
  __syncthreads();

  // y = f @ g
  if (tid < CI) {
    for (int t = 0; t < T; ++t) {
      float y = 0.f;
      for (int u = 0; u < T; ++u) y = fmaf(s_f[t * T + u], s_g[u * CI + tid], y);
      s_y[t * CI + tid] = y;
    }
  }
  __syncthreads();

  // z = y @ W_z + b_z + seq, in place of seq (thread tid owns channel tid)
  {
    float acc[MAX_T];
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) acc[t] = 0.f;
    for (int j = 0; j < CI; ++j) {
      const float wv = wz_w[j * C + tid];
#pragma unroll
      for (int t = 0; t < MAX_T; ++t)
        if (t < T) acc[t] = fmaf(s_y[t * CI + j], wv, acc[t]);
    }
    const float bz = wz_b[tid];
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) {
      if (t < T) {
        const float x = s_seq[t * C + tid];
        const bool nlb = s_multi > 0.f && s_mask[t] > 0.f;
        s_seq[t * C + tid] = nlb ? (acc[t] + bz) + x : x;
      }
    }
  }
  __syncthreads();

  // attention logits: warp partial sums of z_t . w_att
  {
    const int warp = tid / 32, lane = tid % 32;
    const float aw = att_w[tid];
    for (int t = 0; t < T; ++t) {
      float p = s_seq[t * C + tid] * aw;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_down_sync(0xffffffffu, p, off);
      if (lane == 0) s_red[t][warp] = p;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float m = -INFINITY;
    for (int t = 0; t < T; ++t) {
      float a = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) a += s_red[t][w];
      a = s_mask[t] > 0.f ? a + att_b[0] : -1e9f;
      s_att[t] = a;
      m = fmaxf(m, a);
    }
    float sum = 0.f;
    for (int t = 0; t < T; ++t) {
      const float e = expf(s_att[t] - m) * s_mask[t];
      s_att[t] = e;
      sum += e;
    }
    sum = fmaxf(sum, 1e-20f);
    for (int t = 0; t < T; ++t) s_att[t] = s_att[t] / sum;
  }
  __syncthreads();

  float o = 0.f;
  for (int t = 0; t < T; ++t) o = fmaf(s_att[t], s_seq[t * C + tid], o);
  out[(size_t)s * C + tid] = o;
}

}  // namespace

extern "C" int seam_nlb_aggregate(const void* seqs, const void* mask, const void* theta_w,
                                  const void* theta_b, const void* phi_w, const void* phi_b,
                                  const void* g_w, const void* g_b, const void* wcat,
                                  const void* wz_w, const void* wz_b, const void* att_w,
                                  const void* att_b, void* out, int S, int T, void* stream) {
  const size_t smem = (size_t)(T * C + 3 * T * CI + T * T) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nlb_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)seqs, (const float*)mask, (const float*)theta_w, (const float*)theta_b,
      (const float*)phi_w, (const float*)phi_b, (const float*)g_w, (const float*)g_b,
      (const float*)wcat, (const float*)wz_w, (const float*)wz_b, (const float*)att_w,
      (const float*)att_b, (float*)out, T);
  return (int)cudaGetLastError();
}
