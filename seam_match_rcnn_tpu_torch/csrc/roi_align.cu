// K2 — multilevel FPN RoIAlign forward, exact torchvision aligned=False semantics.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_roi_align_resident.py,
// pallas_roi_align_resident (_res_kernel).
//
// Semantics are those of seam_match_rcnn_tpu/ops/roi_align.py (the plain
// version, ops/roi_align.py in this package): LevelMapper level per roi,
// roi coords scaled without a half-pixel offset, roi sizes floored at 1.0,
// sampling_ratio^2 samples per bin at (s + 0.5)/ratio, samples outside
// [-1, H] contribute 0, and the torchvision border rule; the geometry is
// csrc/roi_geometry.cuh, which K5 (the adjoint) shares.  Unlike the TPU
// kernel there is no 40x48-cell window (no roi is clamped), no tile sort and
// no `order` output: rois come out in their natural order.  Per channel, the
// 4 corner products of a sample are summed in corner order, the samples are
// added in (iy, ix) order and the sum is divided by ratio^2, in f32; the
// result is stored in the features' dtype.  The library is built with
// -fmad=false, so each summand rounds as the plain version's does.
//
// What bounds it on an H100 at the serving shapes (44,000 rois at 7x7 and
// 1,100 at 14x14 over a bf16 pyramid of 11 x 256 x (200x336 ... 25x42)):
// the bytes it must move are the pyramid cells that carry a weight, read
// once, and the output, written once (1.1 GB of bf16 at 7x7): about 0.48 ms
// at 3.35 TB/s.  Its gathers read each cell about 16 times, almost all of
// them L1/L2 hits, since neighbouring bins and rois share corners.
//
// The first design ran one thread per (roi, bin y, bin x, channel):
// five 64-bit divisions and remainders to decode each thread's index, the
// whole geometry (level, bin sizes, 2 ratio^2 bilinear rules) recomputed by
// every channel of a bin, and 16 scalar 2-byte loads per output value, so
// that a warp's load brought 64 bytes.  It ran 32x above its bound.
//
// This design:
//  * one block per roi: no division but n / R for the image; the roi's
//    image base and output base are one 64-bit product each, and every
//    index within the block is 32-bit (the wrapper requires H*W*C < 2^31);
//  * the roi's geometry once, into shared memory: the level, and for each
//    of the o*ratio sample rows and sample columns (lo, hi, w_lo, w_hi,
//    inside), one thread per sample coordinate, in the plain version's
//    operation order;
//  * threads over channels, 16 bytes each (8 bf16 or 4 f32 channels), so
//    that C/8 (or C/4) threads read one pixel's channels as one contiguous
//    run (a warp reads 512 bytes at C = 256 bf16) and write the [N, o, o, C]
//    output with 16-byte stores; the other threads of the block take other
//    bins of the roi.
// No stage of the roi's footprint through shared memory: the gathers are
// data-dependent and the cache already serves the repeats.
//
// Layouts: features channels_last (NHWC) per level, 16-byte aligned, C a
// multiple of 8 (bf16) or 4 (f32), C/8 (C/4) <= 256 threads; rois [N, 4]
// f32; out [N, o, o, C], which the wrapper returns as a channels_last view
// of [N, C, o, o]; o * ratio <= 64.
#include "common.cuh"
#include "roi_geometry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SAMPLES = 64;  // o * ratio along one axis

struct Pyramid {
  const void* feat[4];
  int h[4];
  int w[4];
  float scale[4];
};

// 16 bytes of channels, widened to f32 and back
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// blockDim = (C / V channel vectors, bins handled at once)
template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(Pyramid pyr, const float* __restrict__ rois, T* __restrict__ out, int R,
                 int C, int O, int ratio) {
  __shared__ int s_lo[2][MAX_SAMPLES], s_hi[2][MAX_SAMPLES];
  __shared__ float s_wlo[2][MAX_SAMPLES], s_whi[2][MAX_SAMPLES];
  __shared__ bool s_in[2][MAX_SAMPLES];
  constexpr int V = Vec<T>::N;

  const int n = blockIdx.x;
  const float* roi = rois + (size_t)n * 4;
  const int l = seam::roi_level(roi[0], roi[1], roi[2], roi[3]);
  const int H = pyr.h[l], W = pyr.w[l];
  const int P = O * ratio;
  const int nthreads = blockDim.x * blockDim.y;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < 2 * P; t += nthreads) {
    const int axis = t < P ? 0 : 1;  // 0: sample rows (y), 1: sample columns (x)
    const int i = t - axis * P;
    const seam::RoiAxis a = axis == 0 ? seam::roi_axis(roi[1], roi[3], pyr.scale[l], O)
                                      : seam::roi_axis(roi[0], roi[2], pyr.scale[l], O);
    const int size = axis == 0 ? H : W;
    const float coord = seam::sample_coord(a, i / ratio, i % ratio, ratio);
    int lo, hi;
    float wlo, whi;
    seam::bilinear_axis(coord, size, lo, hi, wlo, whi);
    s_lo[axis][i] = lo;
    s_hi[axis][i] = hi;
    s_wlo[axis][i] = wlo;
    s_whi[axis][i] = whi;
    s_in[axis][i] = seam::sample_inside(coord, size);
  }
  __syncthreads();

  const int c = threadIdx.x * V;
  const T* f = (const T*)pyr.feat[l] + (size_t)(n / R) * H * W * C + c;
  T* o = out + (size_t)n * O * O * C + c;
  const float count = (float)(ratio * ratio);
  for (int bin = threadIdx.y; bin < O * O; bin += blockDim.y) {
    const int ph = bin / O, pw = bin - ph * O;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int iy = 0; iy < ratio; ++iy) {
      const int sy = ph * ratio + iy;
      if (!s_in[0][sy]) continue;
      const int ylo = s_lo[0][sy] * W, yhi = s_hi[0][sy] * W;
      const float wylo = s_wlo[0][sy], wyhi = s_whi[0][sy];
      for (int ix = 0; ix < ratio; ++ix) {
        const int sx = pw * ratio + ix;
        if (!s_in[1][sx]) continue;
        const int xlo = s_lo[1][sx], xhi = s_hi[1][sx];
        const float wxlo = s_wlo[1][sx], wxhi = s_whi[1][sx];
        const float w00 = wylo * wxlo, w01 = wylo * wxhi, w10 = wyhi * wxlo,
                    w11 = wyhi * wxhi;
        float v00[V], v01[V], v10[V], v11[V];
        Vec<T>::load(f + (ylo + xlo) * C, v00);
        Vec<T>::load(f + (ylo + xhi) * C, v01);
        Vec<T>::load(f + (yhi + xlo) * C, v10);
        Vec<T>::load(f + (yhi + xhi) * C, v11);
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] += v00[k] * w00 + v01[k] * w01 + v10[k] * w10 + v11[k] * w11;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] / count;
    Vec<T>::store(o + bin * C, acc);
  }
}

template <typename T>
int launch(Pyramid pyr, const void* rois, void* out, int N, int R, int C, int O, int ratio,
           void* stream) {
  const int vecs = C / Vec<T>::N;
  const dim3 block((unsigned)vecs, (unsigned)(vecs < THREADS ? THREADS / vecs : 1));
  roi_align_kernel<T><<<(unsigned)N, block, 0, (cudaStream_t)stream>>>(
      pyr, (const float*)rois, (T*)out, R, C, O, ratio);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seam_roi_align_forward(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    float s0, float s1, float s2, float s3,
    const void* rois, void* out, int N, int R, int C, int O, int ratio, int is_bf16,
    void* stream) {
  Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  if (O < 1 || ratio < 1 || O * ratio > MAX_SAMPLES || C <= 0 || C % (is_bf16 ? 8 : 4) != 0 ||
      C / (is_bf16 ? 8 : 4) > THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) return launch<__nv_bfloat16>(pyr, rois, out, N, R, C, O, ratio, stream);
  return launch<float>(pyr, rois, out, N, R, C, O, ratio, stream);
}
