// K4 — pairwise gallery match probability.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_kernels.py, pairwise_scores (_pairwise_kernel).
//
//   out[i,j] = sigmoid(a_i + g_j - 2 * (x_i o v) . y_j + c0)
//   a_i = sum_c x_ic^2 v_c,  g_j = sum_c y_jc^2 v_c,  v = w1 - w0,  c0 = b1 - b0
//
// which is softmax((x_i - y_j)^2 W^T + b)[1] of the reference's Linear(256, 2)
// scorer, in full f32: a_i + g_j - 2*cross cancels badly for near-duplicate
// descriptors, so neither TF32 nor bf16 may touch any term.
//
// What bounds it on an H100: at the serving shapes (the N x N frame
// self-similarity with N <= 1000, and 1 x G per query) it is tiny — N = 1000
// is 0.5 GFLOP, far below the 67 TFLOP/s of f32 FMA, and the inputs are a
// few MB; launch latency and the single-tile tail dominate.  Design: a
// classic shared-memory tiled f32 GEMM, 64x64 outputs per 256-thread block,
// each thread 4x4 outputs over k-tiles of 16, with x pre-multiplied by v as
// it is staged; the rank-1 terms a_i and g_j are computed by the block for
// its own rows and columns, and c0 and the sigmoid are applied in the
// epilogue, so the [Q, G] matrix is written once.  Ragged Q and G (Q = 1
// included) are masked at load and store.
//
// Layouts: x [Q,C], y [G,C], v [C], c0 [1] (all f32, C a multiple of 16);
// out [Q,G] f32.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ v, const float* __restrict__ c0p,
                float* __restrict__ out, int Q, int G, int C) {
  __shared__ float s_x[BK][BM + 1];  // (x o v) tile, k-major; +1 avoids bank conflicts
  __shared__ float s_y[BK][BN + 1];
  __shared__ float s_a[BM], s_g[BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  if (tid < BM) {
    const int i = row0 + tid;
    float a = 0.f;
    if (i < Q)
      for (int c = 0; c < C; ++c) {
        const float xv = x[(size_t)i * C + c];
        a = fmaf(xv * xv, v[c], a);
      }
    s_a[tid] = a;
  } else if (tid < BM + BN) {
    const int j = col0 + tid - BM;
    float g = 0.f;
    if (j < G)
      for (int c = 0; c < C; ++c) {
        const float yv = y[(size_t)j * C + c];
        g = fmaf(yv * yv, v[c], g);
      }
    s_g[tid - BM] = g;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const int i = row0 + r, j = col0 + r;
      s_x[k][r] = i < Q ? x[(size_t)i * C + k0 + k] * v[k0 + k] : 0.f;
      s_y[k][r] = j < G ? y[(size_t)j * C + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xr[4], yr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xr[a] = s_x[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) yr[b] = s_y[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xr[a], yr[b], acc[a][b]);
    }
    __syncthreads();
  }

  const float c0 = c0p[0];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = row0 + ty + 16 * a;
    if (i >= Q) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = col0 + tx + 16 * b;
      if (j >= G) continue;
      const float d = s_a[ty + 16 * a] + s_g[tx + 16 * b] - 2.f * acc[a][b] + c0;
      out[(size_t)i * G + j] = 1.f / (1.f + expf(-d));
    }
  }
}

}  // namespace

extern "C" int seam_pairwise_scores(const void* x, const void* y, const void* v, const void* c0,
                                    void* out, int Q, int G, int C, void* stream) {
  dim3 grid((G + BN - 1) / BN, (Q + BM - 1) / BM);
  pairwise_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)v, (const float*)c0, (float*)out, Q, G, C);
  return (int)cudaGetLastError();
}
