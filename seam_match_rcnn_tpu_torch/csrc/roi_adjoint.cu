// K5 — multilevel FPN RoIAlign adjoint (the backward of K2 with respect to
// the features), exact torchvision aligned=False semantics.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_roi_adjoint.py,
// multilevel_roi_align_adjoint_pallas (_adj_kernel, _tile_tables).
//
// RoIAlign is linear in the features, so its adjoint is a fixed scatter-add:
// each output bin's cotangent is split evenly over its ratio^2 samples, and
// each sample adds (g / ratio^2) * (w_y * w_x) to each of its 4 bilinear
// corners.  The index and weight rule is K2's, from the header both include
// (csrc/roi_geometry.cuh), and that of the plain version,
// ops/roi_align.multilevel_roi_align_adjoint: LevelMapper level per roi,
// coords scaled without a half-pixel offset, roi sizes floored at 1.0,
// samples outside [-1, H] contribute nothing, clamp at 0 and the border rule
// at H-1.  Geometry is computed with the plain version's operation order, and
// the library is built with -fmad=false, so every summand equals the plain
// version's bit for bit; only the order of the f32 additions differs
// (atomics), and it changes from run to run.
//
// None of the TPU kernel's structure carries over: no 64x64 ownership tiles,
// no duplication of a roi into at most 2x2 bands (which drops the tail
// samples of a roi beyond them), no single bf16 passes.  Every sample of
// every roi lands.
//
// What bounds it on an H100 at the phase-1 training shapes (8 x 512 rois at
// 7x7 and 8 x 128 at 14x14, C = 256, an 8-image 800x1344 pyramid): the bytes
// it must move are a 205 MB f32 cotangent read per branch plus the gradient
// pyramid written once (366 MB in bf16), about 0.17 ms at 3.35 TB/s; its
// arithmetic is ~0.8 G f32 atomic adds per branch (4096 x 14 x 14 samples x
// 4 corners x 256 channels at 7x7, 1024 x 28 x 28 x 4 x 256 at 14x14), which
// is what limits this first design: L2 atomic throughput.  Design: one thread
// per (roi, sample row, sample column, channel), channels fastest, so a
// warp's 32 atomics hit 32 neighbouring floats of one pixel (one 128-byte
// line) and its cotangent reads are coalesced.  The accumulator is an f32
// NHWC scratch per level, zeroed by the wrapper (torch.zeros) and cast to the
// features' dtype by the wrapper afterwards.  Pre-summing a roi's window in
// shared memory before the atomics would cut their count and is left for a
// later change.
#include "common.cuh"
#include "roi_geometry.cuh"

namespace {

struct GradPyramid {
  float* grad[4];
  int h[4];
  int w[4];
  float scale[4];
};

__global__ void __launch_bounds__(256)
roi_adjoint_kernel(GradPyramid pyr, const float* __restrict__ g,
                   const float* __restrict__ rois, long long total, int R, int C, int O,
                   int ratio) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int P = O * ratio;
  const int c = (int)(idx % C);
  long long t = idx / C;
  const int sx = (int)(t % P);
  t /= P;
  const int sy = (int)(t % P);
  const long long n = t / P;
  const int img = (int)(n / R);
  const int ph = sy / ratio, iy = sy % ratio;
  const int pw = sx / ratio, ix = sx % ratio;

  const float* roi = rois + n * 4;
  const int l = seam::roi_level(roi[0], roi[1], roi[2], roi[3]);
  const float scale = pyr.scale[l];
  const int H = pyr.h[l], W = pyr.w[l];
  const float y = seam::sample_coord(seam::roi_axis(roi[1], roi[3], scale, O), ph, iy, ratio);
  const float x = seam::sample_coord(seam::roi_axis(roi[0], roi[2], scale, O), pw, ix, ratio);
  if (!(seam::sample_inside(y, H) && seam::sample_inside(x, W))) return;
  int ylo, yhi, xlo, xhi;
  float wylo, wyhi, wxlo, wxhi;
  seam::bilinear_axis(y, H, ylo, yhi, wylo, wyhi);
  seam::bilinear_axis(x, W, xlo, xhi, wxlo, wxhi);

  const float gs = g[((n * O + ph) * O + pw) * C + c] / (float)(ratio * ratio);
  float* dst = pyr.grad[l] + (size_t)img * H * W * C + c;
  // a zero weight (the border rule's duplicate corner) adds nothing: skipping
  // it changes no sum
  if (wylo * wxlo != 0.f) atomicAdd(dst + ((size_t)ylo * W + xlo) * C, gs * (wylo * wxlo));
  if (wylo * wxhi != 0.f) atomicAdd(dst + ((size_t)ylo * W + xhi) * C, gs * (wylo * wxhi));
  if (wyhi * wxlo != 0.f) atomicAdd(dst + ((size_t)yhi * W + xlo) * C, gs * (wyhi * wxlo));
  if (wyhi * wxhi != 0.f) atomicAdd(dst + ((size_t)yhi * W + xhi) * C, gs * (wyhi * wxhi));
}

}  // namespace

extern "C" int seam_roi_align_adjoint(
    void* g0, void* g1, void* g2, void* g3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    float s0, float s1, float s2, float s3,
    const void* grad, const void* rois, int N, int R, int C, int O, int ratio,
    void* stream) {
  GradPyramid pyr = {{(float*)g0, (float*)g1, (float*)g2, (float*)g3},
                     {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const long long P = (long long)O * ratio;
  const long long total = (long long)N * P * P * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  roi_adjoint_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pyr, (const float*)grad, (const float*)rois, total, R, C, O, ratio);
  return (int)cudaGetLastError();
}
