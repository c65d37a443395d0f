// The exact multilevel RoIAlign geometry of kernels K2 (roi_align.cu) and K5
// (roi_adjoint.cu), in one place so that K5's summands stay bit-equal to K2's.
//
// The rule is that of the plain version, ops/roi_align.py (torchvision
// aligned=False): LevelMapper level per roi, roi coords scaled without a
// half-pixel offset, roi sizes floored at 1.0, sample s of bin p at
// start + (p * bin + ((s + 0.5) / ratio) * bin), samples outside [-1, size]
// contribute nothing, coordinates clamped at 0 and the border rule at size-1.
// Every step follows the plain version's operation order, and the library is
// built with -fmad=false, so that no multiply-add is contracted: the plain
// version rounds each product and each sum on its own.
#pragma once

#include <math.h>

namespace seam {

// LevelMapper: floor(4 + log2(sqrt(area) / 224 + 1e-12) + 1e-6) clamped to
// P2..P5, returned as a level index 0..3.
__device__ __forceinline__ int roi_level(float rx1, float ry1, float rx2, float ry2) {
  const float area = fmaxf((rx2 - rx1) * (ry2 - ry1), 0.f);
  float lvl = floorf((4.f + log2f(sqrtf(area) / 224.f + 1e-12f)) + 1e-6f);
  lvl = fminf(fmaxf(lvl, 2.f), 5.f);
  return (int)lvl - 2;
}

// One axis of a roi on its level: the scaled start and the bin size.
struct RoiAxis {
  float start, bin;
};

__device__ __forceinline__ RoiAxis roi_axis(float lo, float hi, float scale, int out_size) {
  const float start = lo * scale;
  const float len = fmaxf(hi * scale - start, 1.f);
  return {start, len / (float)out_size};
}

// The coordinate of sample s (of `ratio`) in bin p.
__device__ __forceinline__ float sample_coord(RoiAxis a, int p, int s, int ratio) {
  return a.start + ((float)p * a.bin + (((float)s + 0.5f) / (float)ratio) * a.bin);
}

// Whether a sample at `coord` contributes: inside [-1, size].
__device__ __forceinline__ bool sample_inside(float coord, int size) {
  return coord >= -1.f && coord <= (float)size;
}

// torchvision bilinear_interpolate index/weight rule along one axis.
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

}  // namespace seam
