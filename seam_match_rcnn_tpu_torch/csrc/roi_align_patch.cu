// K6 and K7 — patch-window multilevel FPN RoIAlign forward.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_roi_align.py,
// pallas_roi_align_batched (_kernel): K6 with bf16 or f32 features, K7 with
// the int8 pyramid of quantize_features_int8 and its per-level, per-channel
// scales.
//
// Function: that of the plain version, ops/roi_align_patch.roi_align_patch.
// Each roi reads a window of PATCH x PATCH_W cells of its FPN level whose
// origin (image row y0, column x0) and sample geometry (sy, sx, bin_h,
// bin_w and the image bounds in window coordinates) the wrapper computes
// with plain tensor ops (ops/roi_align_patch.patch_geometry), as XLA does
// outside the TPU kernel.  Per output row, the pool-folded bilinear
// interpolation matrix of _interp_matrix has at most 2 * ratio non-zero
// columns: the block builds those taps (column, weight) for W_y and W_x in
// shared memory with the TPU kernel's arithmetic, including its window-edge
// clamp and the multiply-adds that XLA fuses.  Each output value is then the
// sum over its <= 16 (y tap, x tap) pairs of entry x feature, where the entry
// of the Kronecker operator W_y (x) W_x is rounded as the TPU kernel rounds
// it: bf16 features round wy and wx to bf16 and the product to bf16; f32
// features take the f32 product; int8 features take
// clip(rint(127 * wy * wx), -127, 127).  Sums are f32 (int32 for int8, exact
// in any order), and K7 dequantizes at the store with acc * ((1/127) *
// scale[level, c]).  The result is rounded once to the output type.  The
// library is built with -fmad=false; the fused multiply-adds are explicit.
//
// What bounds it on an H100 at the serving shapes (44,000 rois at 7x7 and
// 1,100 at 14x14 over a bf16 pyramid of 11 x 256 x (200x336 ... 25x42)):
// the feature reads.  A roi's window is at most 40 x 48 x 256 values, but
// only the <= 4 x 4 taps of each bin are read, 16 per output value, almost
// all of them L1/L2 hits (neighbouring bins share taps); the pyramid itself
// is 0.5 GB in bf16.  Design: one block per (roi, slab of 128 channels),
// threads over channels of channels_last (NHWC) features, so a warp reads 32
// neighbouring channels of one cell and writes 32 neighbouring outputs of
// [N, out, out, C]; no window is staged (the TPU kernel copies the whole
// window to VMEM because its matrix unit wants it; here 16 taps a bin cost
// less than 1,920 cells a roi).
#include "common.cuh"

namespace {

constexpr int PATCH = 40;
constexpr int PATCH_W = 48;
constexpr int MAX_O = 16;     // output sizes up to 16 (7 and 14 on the paths)
constexpr int MAX_TAPS = 8;   // 2 * sampling_ratio, ratio <= 4
constexpr int THREADS = 128;  // channels per block

struct Levels {
  const void* feat[4];
  int h[4];
  int w[4];
};

// The non-zero columns (window coordinates) and weights of row `b` of
// _interp_matrix(start, bin, lo_bound, hi_bound, out, ratio, width).
__device__ void axis_taps(float start, float bin, float lo_b, float hi_b, int b, int ratio,
                          int width, int* col, float* wt, int& n) {
  n = 0;
  for (int s = 0; s < ratio; ++s) {
    const float off = ((float)s + 0.5f) / (float)ratio;
    const float coord = __fmaf_rn(off, bin, __fmaf_rn((float)b, bin, start));
    if (!(coord >= lo_b && coord <= hi_b)) continue;  // out of range: weight 0
    float c = fmaxf(coord, fmaxf(lo_b + 1.f, 0.f));
    const float last = fminf(hi_b - 1.f, (float)(width - 1));  // image border or window edge
    c = fminf(c, last);
    const float lo = floorf(c);
    int cols[2];
    float vals[2];
    int k = 0;
    if (lo >= last) {
      cols[k] = (int)last;
      vals[k++] = 1.f;
    } else {
      const float lerp = c - lo;
      cols[k] = (int)lo;
      vals[k++] = 1.f - lerp;
      cols[k] = (int)lo + 1;
      vals[k++] = lerp;
    }
    // the dense row sums its samples' one-hot rows in sample order
    for (int i = 0; i < k; ++i) {
      int j = 0;
      while (j < n && col[j] != cols[i]) ++j;
      if (j == n) {
        col[n] = cols[i];
        wt[n++] = vals[i];
      } else {
        wt[j] += vals[i];
      }
    }
  }
  const float inv_ratio = 1.f / (float)ratio;
  for (int j = 0; j < n; ++j) wt[j] *= inv_ratio;
}

template <typename T> struct Traits;
template <> struct Traits<float> {
  using Acc = float;
  __device__ static float round_axis(float w) { return w; }
  __device__ static float entry(float wy, float wx) { return wy * wx; }
  __device__ static float term(float e, float v) { return e * v; }
  __device__ static float load(const float* p) { return *p; }
};
template <> struct Traits<__nv_bfloat16> {
  using Acc = float;
  __device__ static float round_axis(float w) { return __bfloat162float(__float2bfloat16(w)); }
  __device__ static float entry(float wy, float wx) {
    return __bfloat162float(__float2bfloat16(wy * wx));
  }
  __device__ static float term(float e, float v) { return e * v; }  // exact in f32
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};
template <> struct Traits<int8_t> {
  using Acc = int;
  __device__ static float round_axis(float w) { return w; }
  __device__ static int entry(float wy, float wx) {
    return (int)fminf(fmaxf(rintf((wy * wx) * 127.f), -127.f), 127.f);
  }
  __device__ static int term(int e, int v) { return e * v; }
  __device__ static int load(const int8_t* p) { return (int)*p; }
};

template <typename T, typename TOut>
__global__ void __launch_bounds__(THREADS)
roi_patch_kernel(Levels lv, const int* __restrict__ lvl, const int* __restrict__ origin,
                 const float* __restrict__ geom, const float* __restrict__ scales,
                 TOut* __restrict__ out, int R, int C, int O, int ratio) {
  __shared__ int ycol[MAX_O][MAX_TAPS], xcol[MAX_O][MAX_TAPS];
  __shared__ float yw[MAX_O][MAX_TAPS], xw[MAX_O][MAX_TAPS];
  __shared__ int yn[MAX_O], xn[MAX_O];
  using Tr = Traits<T>;
  const int n = blockIdx.x;
  const float* g = geom + (size_t)n * 8;
  const int t = threadIdx.x;
  if (t < O) {
    axis_taps(g[0], g[2], g[4], g[5], t, ratio, PATCH, ycol[t], yw[t], yn[t]);
    for (int j = 0; j < yn[t]; ++j) yw[t][j] = Tr::round_axis(yw[t][j]);
  } else if (t < 2 * O) {
    const int u = t - O;
    axis_taps(g[1], g[3], g[6], g[7], u, ratio, PATCH_W, xcol[u], xw[u], xn[u]);
    for (int j = 0; j < xn[u]; ++j) xw[u][j] = Tr::round_axis(xw[u][j]);
  }
  __syncthreads();
  const int c = blockIdx.y * THREADS + t;
  if (c >= C) return;

  const int l = lvl[n];
  const int H = lv.h[l], W = lv.w[l];
  const int y0 = origin[2 * n], x0 = origin[2 * n + 1];
  const T* f = (const T*)lv.feat[l] + (size_t)(n / R) * H * W * C + c;
  const float dq = scales != nullptr ? (float)(1.0 / 127.0) * scales[l * C + c] : 0.f;
  TOut* o = out + (size_t)n * O * O * C + c;
  for (int oy = 0; oy < O; ++oy) {
    for (int ox = 0; ox < O; ++ox) {
      typename Tr::Acc acc = 0;
      for (int i = 0; i < yn[oy]; ++i) {
        // taps lie inside the image by construction; the clamp only guards memory
        const int row = min(max(y0 + ycol[oy][i], 0), H - 1);
        const float wy = yw[oy][i];
        for (int j = 0; j < xn[ox]; ++j) {
          const int col = min(max(x0 + xcol[ox][j], 0), W - 1);
          acc += Tr::term(Tr::entry(wy, xw[ox][j]), Tr::load(f + ((size_t)row * W + col) * C));
        }
      }
      float v;
      if constexpr (sizeof(T) == 1) {
        v = (float)acc * dq;
      } else {
        v = acc;
      }
      o[(size_t)(oy * O + ox) * C] = seam::from_float<TOut>(v);
    }
  }
}

template <typename T, typename TOut>
int launch(Levels lv, const void* lvl, const void* origin, const void* geom, const void* scales,
           void* out, int N, int R, int C, int O, int ratio, void* stream) {
  const dim3 grid((unsigned)N, (unsigned)((C + THREADS - 1) / THREADS));
  roi_patch_kernel<T, TOut><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      lv, (const int*)lvl, (const int*)origin, (const float*)geom, (const float*)scales,
      (TOut*)out, R, C, O, ratio);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: bf16 or f32 features, output in the features' type.
extern "C" int seam_roi_align_patch(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    const void* lvl, const void* origin, const void* geom, void* out,
    int N, int R, int C, int O, int ratio, int is_bf16, void* stream) {
  Levels lv = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  if (is_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(lv, lvl, origin, geom, nullptr, out, N, R, C,
                                                 O, ratio, stream);
  }
  return launch<float, float>(lv, lvl, origin, geom, nullptr, out, N, R, C, O, ratio, stream);
}

// K7: int8 features with scales [4, C] f32, output bf16 or f32.
extern "C" int seam_roi_align_patch_int8(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    const void* lvl, const void* origin, const void* geom, const void* scales, void* out,
    int N, int R, int C, int O, int ratio, int out_bf16, void* stream) {
  Levels lv = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  if (out_bf16) {
    return launch<int8_t, __nv_bfloat16>(lv, lvl, origin, geom, scales, out, N, R, C, O, ratio,
                                         stream);
  }
  return launch<int8_t, float>(lv, lvl, origin, geom, scales, out, N, R, C, O, ratio, stream);
}
