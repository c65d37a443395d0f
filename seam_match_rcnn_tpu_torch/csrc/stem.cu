// K1 — the fused ResNet stem: maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x)*bn_scale + bn_shift)).
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_stem.py, fused_stem (_stem_kernel).
//
// Numerics, as the TPU kernel: the FrozenBN scale is folded into the conv
// weights, and both x and the folded weights are bf16; products accumulate in
// f32, the BN shift is added in f32, and the pooled result is rounded to bf16
// (the TPU kernel rounds it before its one-hot pooling matmul).  Rounding is
// monotonic, so rounding after the max equals rounding every conv value.
//
// What bounds it on an H100 at the serving shape [11,3,800,1344] ->
// [11,64,200,336]: arithmetic.  The unique conv work is 11*400*672*64*147 =
// 27.8 G multiply-adds; the input is 71 MB and the output 95 MB of bf16
// (about 0.05 ms of HBM time).  The TPU kernel's space-to-depth slabs, lane
// rolls and one-hot pooling matmul exist for the TPU's (8,128) tiling and are
// dropped.  Design: one block owns an 8x16 tile of pooled outputs for all 64
// channels; the 39x71x3 input patch it needs and the folded weights sit in
// shared memory (35 KB).  Each thread owns one pooled position and computes
// the 3x3 conv window under it straight into registers, 8 channels at a
// time, so one input value read from shared memory feeds 8 FMAs; pooling
// happens in registers and the conv activation never reaches HBM.  Neighbour
// windows overlap, so 2.25x the unique FLOPs are spent (about 125 GFLOP of
// f32 FMA on CUDA cores); no tensor cores yet.  Conv positions outside the
// conv output (the pool's -inf padding) are skipped, so no fake border row
// is ever produced; after relu a 0 floor equals the -inf pad.
//
// Layouts: x [B,3,H,W] bf16 (H, W multiples of 4), w [147][64] bf16 with tap
// index (ci*7+ky)*7+kx, bias [64] f32, out [B,64,H/4,W/4] bf16 (NCHW).
#include "common.cuh"

namespace {

constexpr int TPH = 8;               // pooled rows per block
constexpr int TPW = 16;              // pooled cols per block
constexpr int IN_H = 4 * TPH + 7;    // input rows a tile reads (39)
constexpr int IN_W = 4 * TPW + 7;    // input cols a tile reads (71)
constexpr int TAPS = 3 * 7 * 7;
constexpr int COUT = 64;
constexpr int CG = 8;                // output channels held in registers at once

__global__ void __launch_bounds__(TPH * TPW)
stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int H, int W) {
  __shared__ __nv_bfloat16 s_x[3][IN_H][IN_W];
  __shared__ __nv_bfloat16 s_w[TAPS][COUT];
  __shared__ float s_b[COUT];

  const int Hc = H / 2, Wc = W / 2, Ho = H / 4, Wo = W / 4;
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TPH, px0 = blockIdx.x * TPW;
  // pooled row py pools conv rows 2py-1..2py+1, which read input rows
  // 4py-5 .. 4py+5 (conv stride 2, pad 3)
  const int iy0 = 4 * py0 - 5, ix0 = 4 * px0 - 5;
  const int tid = threadIdx.x;
  const __nv_bfloat16* xb = x + (size_t)b * 3 * H * W;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < 3 * IN_H * IN_W; i += TPH * TPW) {
    const int ci = i / (IN_H * IN_W);
    const int r = (i / IN_W) % IN_H;
    const int c = i % IN_W;
    const int gy = iy0 + r, gx = ix0 + c;
    s_x[ci][r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? xb[((size_t)ci * H + gy) * W + gx] : zero;
  }
  for (int i = tid; i < TAPS * COUT; i += TPH * TPW) s_w[i / COUT][i % COUT] = w[i];
  if (tid < COUT) s_b[tid] = bias[tid];
  __syncthreads();

  const int ty = tid / TPW, tx = tid % TPW;
  const int py = py0 + ty, px = px0 + tx;
  if (py >= Ho || px >= Wo) return;  // no barrier follows

  bool live[9];  // conv positions of the pool window that exist
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int cy = 2 * py - 1 + dy, cx = 2 * px - 1 + dx;
      live[dy * 3 + dx] = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
    }
  __nv_bfloat16* ob = out + (size_t)b * COUT * Ho * Wo + (size_t)py * Wo + px;

  for (int c0 = 0; c0 < COUT; c0 += CG) {
    float acc[CG][9];
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[c][k] = 0.f;
    for (int ci = 0; ci < 3; ++ci) {
      for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          float v[9];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              v[dy * 3 + dx] = __bfloat162float(
                  s_x[ci][4 * ty + 2 * dy + ky][4 * tx + 2 * dx + kx]);
          const int tap = (ci * 7 + ky) * 7 + kx;
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const float wv = __bfloat162float(s_w[tap][c0 + c]);
#pragma unroll
            for (int k = 0; k < 9; ++k) acc[c][k] = fmaf(wv, v[k], acc[c][k]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      float m = 0.f;  // relu floor; every window holds a live conv position
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (live[k]) m = fmaxf(m, acc[c][k] + s_b[c0 + c]);
      ob[(size_t)(c0 + c) * Ho * Wo] = __float2bfloat16(m);
    }
  }
}

}  // namespace

extern "C" const char* seam_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

extern "C" int seam_stem_forward(const void* x, const void* w, const void* bias, void* out,
                                 int B, int H, int W, void* stream) {
  const int Ho = H / 4, Wo = W / 4;
  dim3 grid((Wo + TPW - 1) / TPW, (Ho + TPH - 1) / TPH, B);
  stem_kernel<<<grid, TPH * TPW, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)out, H, W);
  return (int)cudaGetLastError();
}
