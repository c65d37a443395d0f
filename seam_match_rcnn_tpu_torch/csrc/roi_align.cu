// K2 — multilevel FPN RoIAlign forward, exact torchvision aligned=False semantics.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_roi_align_resident.py,
// pallas_roi_align_resident (_res_kernel).
//
// Semantics are those of seam_match_rcnn_tpu/ops/roi_align.py (the plain
// version, ops/roi_align.py in this package): LevelMapper level per roi
// (floor(4 + log2(sqrt(area)/224 + 1e-12) + 1e-6) clamped to P2..P5), roi
// coords scaled without a half-pixel offset, roi sizes floored at 1.0,
// sampling_ratio^2 samples per bin at (s + 0.5)/ratio, samples outside
// [-1, H] contribute 0, and the torchvision border rule.  Unlike the TPU
// kernel there is no 40x48-cell window (no roi is clamped), no tile sort and
// no `order` output: rois come out in their natural order.  Sums are f32;
// the result is stored in the features' dtype.  Geometry is computed with
// the same operation order as the plain version, and the library is built
// with -fmad=false so that no multiply-add is contracted behind its back.
//
// What bounds it on an H100 at the serving shapes (44,000 rois at 7x7 and
// 1,100 at 14x14 over a bf16 pyramid of 11 x 256 x (200x336 ... 25x42)):
// memory traffic of the gathers — 4 corners x 4 samples per output value,
// 8.8 G bf16 reads for the box branch, almost all of them L1/L2 hits since
// neighbouring bins and rois share corners; the pyramid itself is 0.5 GB.
// Design: one thread per (roi, bin y, bin x, channel) with the channel
// innermost, over channels_last (NHWC) features, so a warp reads 32
// neighbouring channels of one pixel (one 64-byte segment for bf16) and
// writes 32 neighbouring outputs.  The output is [N, out, out, C], which the
// wrapper returns as a channels_last view of [N, C, out, out].
#include "common.cuh"

namespace {

struct Pyramid {
  const void* feat[4];
  int h[4];
  int w[4];
  float scale[4];
};

// torchvision bilinear_interpolate index/weight rule along one axis
__device__ __forceinline__ void bilinear_axis(float coord, int size, int& lo, int& hi,
                                              float& w_lo, float& w_hi) {
  float c = fmaxf(coord, 0.f);
  lo = (int)floorf(c);
  const bool at_border = lo >= size - 1;
  if (at_border) {
    lo = size - 1;
    hi = size - 1;
    c = (float)lo;
  } else {
    hi = lo + 1;
  }
  const float lerp = c - (float)lo;
  w_lo = 1.f - lerp;
  w_hi = lerp;
}

template <typename T>
__global__ void __launch_bounds__(256)
roi_align_kernel(Pyramid pyr, const float* __restrict__ rois, T* __restrict__ out,
                 long long total, int R, int C, int O, int ratio) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long t = idx / C;
  const int pw = (int)(t % O);
  t /= O;
  const int ph = (int)(t % O);
  const long long n = t / O;
  const int img = (int)(n / R);

  const float* roi = rois + n * 4;
  const float rx1 = roi[0], ry1 = roi[1], rx2 = roi[2], ry2 = roi[3];
  const float area = fmaxf((rx2 - rx1) * (ry2 - ry1), 0.f);
  float lvl = floorf((4.f + log2f(sqrtf(area) / 224.f + 1e-12f)) + 1e-6f);
  lvl = fminf(fmaxf(lvl, 2.f), 5.f);
  const int l = (int)lvl - 2;

  const float scale = pyr.scale[l];
  const int H = pyr.h[l], W = pyr.w[l];
  const float x1 = rx1 * scale, y1 = ry1 * scale;
  const float roi_w = fmaxf(rx2 * scale - x1, 1.f);
  const float roi_h = fmaxf(ry2 * scale - y1, 1.f);
  const float bin_w = roi_w / (float)O;
  const float bin_h = roi_h / (float)O;

  const T* f = (const T*)pyr.feat[l] + (size_t)img * H * W * C + c;
  float acc = 0.f;
  for (int iy = 0; iy < ratio; ++iy) {
    const float y = y1 + ((float)ph * bin_h + (((float)iy + 0.5f) / (float)ratio) * bin_h);
    int ylo, yhi;
    float wylo, wyhi;
    bilinear_axis(y, H, ylo, yhi, wylo, wyhi);
    const bool yin = y >= -1.f && y <= (float)H;
    for (int ix = 0; ix < ratio; ++ix) {
      const float x = x1 + ((float)pw * bin_w + (((float)ix + 0.5f) / (float)ratio) * bin_w);
      int xlo, xhi;
      float wxlo, wxhi;
      bilinear_axis(x, W, xlo, xhi, wxlo, wxhi);
      const bool xin = x >= -1.f && x <= (float)W;
      if (!(yin && xin)) continue;
      const float v = seam::to_float(f[((size_t)ylo * W + xlo) * C]) * (wylo * wxlo)
                    + seam::to_float(f[((size_t)ylo * W + xhi) * C]) * (wylo * wxhi)
                    + seam::to_float(f[((size_t)yhi * W + xlo) * C]) * (wyhi * wxlo)
                    + seam::to_float(f[((size_t)yhi * W + xhi) * C]) * (wyhi * wxhi);
      acc += v;
    }
  }
  out[idx] = seam::from_float<T>(acc / (float)(ratio * ratio));
}

}  // namespace

extern "C" int seam_roi_align_forward(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    float s0, float s1, float s2, float s3,
    const void* rois, void* out, int N, int R, int C, int O, int ratio, int is_bf16,
    void* stream) {
  Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const long long total = (long long)N * O * O * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        pyr, (const float*)rois, (__nv_bfloat16*)out, total, R, C, O, ratio);
  } else {
    roi_align_kernel<float><<<blocks, threads, 0, st>>>(
        pyr, (const float*)rois, (float*)out, total, R, C, O, ratio);
  }
  return (int)cudaGetLastError();
}
