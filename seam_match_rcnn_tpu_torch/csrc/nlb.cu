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
// What bounds it on an H100: latency.  At serving S = 1, T <= 10 the whole
// aggregation is about 3 MFLOP and reads 0.5 MB of weights; nothing here can
// fill the card, and the bytes take 0.2 us at 3.35 TB/s.  The first design
// ran a track on one block of one SM through a chain of k-loops whose every
// step waited on a weight load from global memory (0.30 ms at S = 1, and
// about as long at S = 64).  This design spreads a track over a thread
// block cluster of 8 CTAs on 8 SMs and issues all of a CTA's loads at once:
//
// * CTA k owns 16 columns of theta, phi and g and 32 columns of W_z and of
//   the output.  At block start it copies its weight slices (64 KB) and the
//   track's [T, 256] sequence into shared memory with cp.async, all in
//   flight together.
// * projections: one thread per output (frame, column), a 256-step sum
//   over the staged sequence and weights, several outputs a thread at T = 32.
// * the affinity terms a_t = theta_t.w1 and c_u = phi_u.w2, and the
//   attention logits z_t.w_att, are partial per CTA: each CTA reads the 8
//   partials from the others' shared memory (distributed shared memory) and
//   adds them in rank order, so every CTA holds the same sums.
// * y = f @ g is local to a CTA's 16 columns of g; z = y @ W_z needs all 128
//   columns of y, which each CTA gathers from the others' shared memory.
// * the softmax is tiny and computed in every CTA; each CTA writes its 32
//   output channels.
// Four cluster barriers a track, the last one so that no CTA leaves while
// another still reads its shared memory.  Every sum has a fixed order.
//
// On an H100 SXM a track takes ~15 us of device time at T = 10 (S = 1) and
// ~34 us at T = 32 (S = 7): the chain of staging, projections, barriers and
// softmax, not the bytes.  Tracks beyond the clusters the card holds at once (84 KB of shared
// memory a CTA at T = 10, 130 KB at T = 32) run in waves: S = 64 takes ~58
// us at T = 10.  Serving and eval call it with S = 1.
//
// Layouts: seqs [S,T,256], mask [S,T] (0/1), theta/phi/g kernels [256,128]
// (in-major, as the JAX Dense kernel), their biases [128], wcat [256],
// W_z kernel [128,256], b_z [256], w_att [256], b_att [1]; out [S,256].
// seqs and the four kernels 16-byte aligned (checked by the wrapper).
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 256;
constexpr int CI = 128;
constexpr int MAX_T = 32;
constexpr int THREADS = 256;
constexpr int CLUSTER = 8;
constexpr int PJ = CI / CLUSTER;  // columns of theta/phi/g a CTA (16)
constexpr int ZJ = C / CLUSTER;   // columns of W_z and of the output a CTA (32)
constexpr int SEQ = C + 4;        // row stride of the staged sequence
constexpr int PW3 = 3 * PJ;       // theta, phi and g columns a CTA (48)

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// floats of dynamic shared memory at T frames
__host__ __device__ constexpr int smem_floats(int T) {
  return T * SEQ + 3 * C * PJ + CI * ZJ + 3 * T * PJ + T * CI + T * ZJ;
}

__global__ void __launch_bounds__(THREADS)
nlb_kernel(const float* __restrict__ seqs, const float* __restrict__ mask,
           const float* __restrict__ theta_w, const float* __restrict__ theta_b,
           const float* __restrict__ phi_w, const float* __restrict__ phi_b,
           const float* __restrict__ g_w, const float* __restrict__ g_b,
           const float* __restrict__ wcat, const float* __restrict__ wz_w,
           const float* __restrict__ wz_b, const float* __restrict__ att_w,
           const float* __restrict__ att_b, float* __restrict__ out, int T) {
  extern __shared__ __align__(16) float smem[];
  float* s_seq = smem;                  // [T][SEQ] seq
  float* s_w = s_seq + T * SEQ;         // [C][PW3] theta, phi, g slices side by side
  float* s_wz = s_w + 3 * C * PJ;       // [CI][ZJ] W_z slice
  float* s_proj = s_wz + CI * ZJ;       // [3][T][PJ] theta, phi, g (with biases)
  float* s_y = s_proj + 3 * T * PJ;     // [T][CI] y, this CTA's columns first
  float* s_z = s_y + T * CI;            // [T][ZJ] z slice
  __shared__ float s_mask[MAX_T], s_part[2][MAX_T], s_a[MAX_T], s_c[MAX_T];
  __shared__ float s_f[MAX_T * MAX_T], s_logit[MAX_T], s_att[MAX_T];
  __shared__ float s_n, s_multi;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. every load of the block in flight at once
  const float* seq = seqs + (size_t)s * T * C;
  for (int i = tid; i < T * (C / 4); i += THREADS) {
    const int t = i / (C / 4), q = i % (C / 4);
    cp_async16(s_seq + t * SEQ + 4 * q, seq + t * C + 4 * q);
  }
  for (int i = tid; i < 3 * C * (PJ / 4); i += THREADS) {
    const int m = i / (C * PJ / 4), k = (i / (PJ / 4)) % C, q = i % (PJ / 4);
    const float* w = m == 0 ? theta_w : (m == 1 ? phi_w : g_w);
    cp_async16(s_w + k * PW3 + m * PJ + 4 * q, w + k * CI + rank * PJ + 4 * q);
  }
  for (int i = tid; i < CI * (ZJ / 4); i += THREADS) {
    const int k = i / (ZJ / 4), q = i % (ZJ / 4);
    cp_async16(s_wz + k * ZJ + 4 * q, wz_w + k * C + rank * ZJ + 4 * q);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (tid < T) s_mask[tid] = mask[(size_t)s * T + tid];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    float n = 0.f;
    for (int t = 0; t < T; ++t) n += s_mask[t];
    s_n = fmaxf(n, 1.f);
    s_multi = n > 1.f ? 1.f : 0.f;
  }

  // 2. this CTA's 16 columns of theta, phi and g, one output (frame t,
  // column q) a thread at a time
  for (int o = tid; o < T * PW3; o += THREADS) {
    const int t = o / PW3, q = o - t * PW3, m = q / PJ, j = q - m * PJ;
    const float4* x = reinterpret_cast<const float4*>(s_seq + t * SEQ);
    const float* w = s_w + q;
    float acc0 = 0.f, acc1 = 0.f;  // even and odd inputs: two chains in flight
#pragma unroll 4
    for (int k4 = 0; k4 < C / 4; ++k4) {
      const float4 xv = x[k4];
      const float* wk = w + 4 * k4 * PW3;
      acc0 = fmaf(xv.x, wk[0], acc0);
      acc1 = fmaf(xv.y, wk[PW3], acc1);
      acc0 = fmaf(xv.z, wk[2 * PW3], acc0);
      acc1 = fmaf(xv.w, wk[3 * PW3], acc1);
    }
    const float* bias = m == 0 ? theta_b : (m == 1 ? phi_b : g_b);
    s_proj[(m * T + t) * PJ + j] = (acc0 + acc1) + bias[rank * PJ + j];
  }
  __syncthreads();

  // 3. partial a_t = theta_t . w1 (warp 0) and c_t = phi_t . w2 (warp 1)
  // over this CTA's columns, then the sums over the cluster in rank order
  if (warp < 2 && lane < T) {
    const float* p = s_proj + (warp * T + lane) * PJ;
    const float* wc = wcat + warp * CI + rank * PJ;
    float a = 0.f;
    for (int j = 0; j < PJ; ++j) a += p[j] * wc[j];
    s_part[warp][lane] = a;
  }
  cluster.sync();
  if (warp < 2 && lane < T) {
    float a = 0.f;
    for (int r = 0; r < CLUSTER; ++r)
      a += cluster.map_shared_rank(&s_part[0][0], r)[warp * MAX_T + lane];
    (warp == 0 ? s_a : s_c)[lane] = a;
  }
  __syncthreads();

  for (int i = tid; i < T * T; i += THREADS) {
    const int t = i / T, u = i % T;
    s_f[i] = fmaxf(s_a[t] + s_c[u], 0.f) * s_mask[u] / s_n;
  }
  __syncthreads();

  // 4. y = f @ g on this CTA's 16 columns, then all 128 from the cluster
  for (int i = tid; i < T * PJ; i += THREADS) {
    const int t = i / PJ, j = i % PJ;
    const float* gcol = s_proj + 2 * T * PJ + j;
    float y = 0.f;
    for (int u = 0; u < T; ++u) y = fmaf(s_f[t * T + u], gcol[u * PJ], y);
    s_y[t * CI + rank * PJ + j] = y;
  }
  cluster.sync();
  for (int i = tid; i < T * CI; i += THREADS) {
    const int r = (i % CI) / PJ;
    if (r != rank) s_y[i] = cluster.map_shared_rank(s_y, r)[i];
  }
  __syncthreads();

  // 5. z on this CTA's 32 channels (lane j, frames warp, warp + 8, ...),
  // with the residual, and the partial attention logits
  {
    const int j = lane, col = rank * ZJ + lane;
    const float bz = wz_b[col], aw = att_w[col];
    for (int t = warp; t < T; t += THREADS / 32) {
      const float4* y = reinterpret_cast<const float4*>(s_y + t * CI);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
      for (int i4 = 0; i4 < CI / 4; ++i4) {
        const float4 yv = y[i4];
        const float* wi = s_wz + 4 * i4 * ZJ + j;
        acc0 = fmaf(yv.x, wi[0], acc0);
        acc1 = fmaf(yv.y, wi[ZJ], acc1);
        acc0 = fmaf(yv.z, wi[2 * ZJ], acc0);
        acc1 = fmaf(yv.w, wi[3 * ZJ], acc1);
      }
      const float acc = acc0 + acc1;
      const float x = s_seq[t * SEQ + col];
      const bool nlb = s_multi > 0.f && s_mask[t] > 0.f;
      const float z = nlb ? (acc + bz) + x : x;
      s_z[t * ZJ + j] = z;
      float p = z * aw;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_down_sync(0xffffffffu, p, off);
      if (lane == 0) s_logit[t] = p;
    }
  }
  cluster.sync();

  // 6. the logits over the cluster in rank order, the softmax over valid
  // frames (every CTA computes the same), and this CTA's 32 channels
  if (tid < T) {
    float a = 0.f;
    for (int r = 0; r < CLUSTER; ++r) a += cluster.map_shared_rank(s_logit, r)[tid];
    s_att[tid] = s_mask[tid] > 0.f ? a + att_b[0] : -1e9f;
  }
  // no CTA may leave while another reads its shared memory: arrive now,
  // wait before leaving
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    float m = -INFINITY;
    for (int t = 0; t < T; ++t) m = fmaxf(m, s_att[t]);
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
  if (tid < ZJ) {
    float o = 0.f;
    for (int t = 0; t < T; ++t) o = fmaf(s_att[t], s_z[t * ZJ + tid], o);
    out[(size_t)s * C + rank * ZJ + tid] = o;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" int seam_nlb_aggregate(const void* seqs, const void* mask, const void* theta_w,
                                  const void* theta_b, const void* phi_w, const void* phi_b,
                                  const void* g_w, const void* g_b, const void* wcat,
                                  const void* wz_w, const void* wz_b, const void* att_w,
                                  const void* att_b, void* out, int S, int T, void* stream) {
  static bool configured = false;  // the attribute is set once per process
  static int clusters[MAX_T + 1] = {0};  // active clusters the card can hold, by T
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(nlb_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)(smem_floats(MAX_T) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)S * CLUSTER);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = (size_t)smem_floats(T) * sizeof(float);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (clusters[T] == 0) {
    // a cluster the card cannot place would never run: refuse it instead
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (const void*)nlb_kernel, &config);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    clusters[T] = n;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &config, nlb_kernel, (const float*)seqs, (const float*)mask, (const float*)theta_w,
      (const float*)theta_b, (const float*)phi_w, (const float*)phi_b, (const float*)g_w,
      (const float*)g_b, (const float*)wcat, (const float*)wz_w, (const float*)wz_b,
      (const float*)att_w, (const float*)att_b, (float*)out, T);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
