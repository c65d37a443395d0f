// K6 and K7 — patch-window multilevel FPN RoIAlign forward.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_roi_align.py,
// pallas_roi_align_batched (_kernel): K6 with bf16 or f32 features, K7 with
// the int8 pyramid of quantize_features_int8 and its per-level, per-channel
// scales.
//
// Function: that of the plain version, ops/roi_align_patch.roi_align_patch.
// Each roi reads a window of PATCH x PATCH_W cells of its FPN level.  The
// block computes the roi's level (seam::roi_level, the LevelMapper of
// fpn_level_indices), the window origin (image row y0, column x0, x0 rounded
// to the 8-aligned column rule ((x0 + 1) // 8) * 8 - 1) and the sample
// geometry (sy, sx, bin_h, bin_w and the image bounds in window
// coordinates) in the operation order of ops/roi_align_patch.patch_geometry,
// the bin size as the product with f32(1/o) that XLA makes of the TPU
// kernel's division.  Per output row, the pool-folded bilinear interpolation
// matrix of _interp_matrix has at most 2 * ratio non-zero columns: the block
// builds those taps (column, weight) for W_y and W_x in shared memory with
// the TPU kernel's arithmetic, including its window-edge clamp and the
// multiply-adds that XLA fuses.  Each output value is then the sum over its
// <= (2 * ratio)^2 (y tap, x tap) pairs of entry x feature, where the entry
// of the Kronecker operator W_y (x) W_x is rounded as the TPU kernel rounds
// it: bf16 features round wy and wx to bf16 and the product to bf16; f32
// features take the f32 product; int8 features take
// clip(rint(127 * wy * wx), -127, 127).  Sums are f32 in (y tap, x tap)
// order (int32 for int8, exact in any order), and K7 dequantizes at the
// store with acc * ((1/127) * scale[level, c]).  The result is rounded once
// to the output type.  The library is built with -fmad=false; the fused
// multiply-adds are explicit.
//
// What bounds it on an H100 at the serving shapes (44,000 rois at 7x7 and
// 1,100 at 14x14 over a bf16 pyramid of 11 x 256 x (200x336 ... 25x42)):
// the bytes it must move, the pyramid cells that carry a tap, read once, and
// the output, written once (1.1 GB of bf16 at 7x7).  Its gathers read each
// cell several times, almost all of them L1/L2 hits (neighbouring bins
// share taps).
//
// The first design took the geometry from the wrapper (about 30 tensor ops
// and four host-to-device copies a call), ran one block per (roi, 128
// channels) with one thread per channel and scalar 2-byte (1-byte) loads,
// recomputed every Kronecker entry in every channel thread, and built the
// tap tables on 2 * o threads while the rest waited.  This design, K2's
// (csrc/roi_align.cu) adapted:
//  * one launch a call: the geometry comes from the rois [N, 4] and the
//    levels' sizes and scales, once per block, in every thread's registers;
//  * one block per roi over all C channels: threads over (16-byte channel
//    vector, bin), 8 bf16, 4 f32 or 16 int8 channels a thread, so that a
//    warp reads 512 bytes of one cell at C = 256 bf16 and writes the
//    [N, o, o, C] output with 16-byte stores;
//  * the tap tables (absolute row offset, column, weight per bin and tap)
//    and the rounded Kronecker entries per (bin, tap pair) built once a roi
//    in shared memory by all the block's threads: o^2 (2 ratio)^2 entries,
//    12.5 KB at o = 14, ratio 2 (a quarter of that in int8);
//  * K7 sums four tap pairs at a time: a byte transpose of their four
//    16-byte loads gives each channel one word of four taps, which meets the
//    four int8 entries in one dp4a (the same integers as the TPU kernel's
//    int8 matmul, in another order); unpacking each byte and one integer
//    multiply-add per byte left K7 18% slower on an H100 than K6 over bf16 at
//    11 x 4000 rois 7x7, which reads twice its bytes.
// No window is staged (the TPU kernel copies the whole window to VMEM
// because its matrix unit wants it; here 16 taps a bin cost less than 1,920
// cells a roi), and no cell is staged: the cache serves the repeats.
//
// Layouts: features channels_last (NHWC) per level, 16-byte aligned, C a
// multiple of the channel vector (8 bf16, 4 f32, 16 int8), C / vector <= 256;
// rois [N, 4] f32; scales [4, C] f32 (K7); out [N, o, o, C], which the
// wrapper returns as a channels_last view of [N, C, o, o]; o <= 16, ratio <= 4.
#include "common.cuh"
#include "roi_geometry.cuh"

namespace {

constexpr int PATCH = 40;
constexpr int PATCH_W = 48;
constexpr int MAX_O = 16;     // output sizes up to 16 (7 and 14 on the paths)
constexpr int MAX_TAPS = 8;   // 2 * sampling_ratio, ratio <= 4
constexpr int THREADS = 256;

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

// Per feature type: the channel vector, the entry and sum types, the
// rounding of the axis weights and of the Kronecker entries, one 16-byte load.
template <typename T> struct Traits;
template <> struct Traits<float> {
  using Ent = float;
  static constexpr int V = 4;
  __device__ static float round_axis(float w) { return w; }
  __device__ static float entry(float wy, float wx) { return wy * wx; }
  __device__ static void load(const float* p, float* v) { seam::Vec<float>::load(p, v); }
};
template <> struct Traits<__nv_bfloat16> {
  using Ent = float;
  static constexpr int V = 8;
  __device__ static float round_axis(float w) { return __bfloat162float(__float2bfloat16(w)); }
  __device__ static float entry(float wy, float wx) {
    return __bfloat162float(__float2bfloat16(wy * wx));
  }
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    seam::Vec<__nv_bfloat16>::load(p, v);
  }
};
template <> struct Traits<int8_t> {
  using Ent = int8_t;
  static constexpr int V = 16;
  __device__ static float round_axis(float w) { return w; }
  __device__ static int8_t entry(float wy, float wx) {
    return (int8_t)fminf(fmaxf(rintf((wy * wx) * 127.f), -127.f), 127.f);
  }
};

// K7's sums over a bin's taps, four taps at a time: the four taps' 16 bytes
// of channels, transposed into one word of four taps per channel, meet the
// four taps' entries in one dp4a (exact integer sums, in any order).
__device__ __forceinline__ void int8_bin_sums(const int8_t* f, const int* yoff, const int* xoff,
                                              int ny, int nx, const int8_t* ent, int C,
                                              int* acc) {
  const int np = ny * nx;
  int i = 0, j = 0;
  for (int p0 = 0; p0 < np; p0 += 4) {
    uint4 w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + q < np) {
        w[q] = *reinterpret_cast<const uint4*>(f + (yoff[i] + xoff[j]) * C);
        if (++j == nx) {
          j = 0;
          ++i;
        }
      }
    }
    const int e4 = *reinterpret_cast<const int*>(ent + p0);
    const uint32_t* w0 = &w[0].x;
    const uint32_t* w1 = &w[1].x;
    const uint32_t* w2 = &w[2].x;
    const uint32_t* w3 = &w[3].x;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // channels 4k .. 4k + 3
      const uint32_t lo01 = __byte_perm(w0[k], w1[k], 0x5140);
      const uint32_t lo23 = __byte_perm(w2[k], w3[k], 0x5140);
      const uint32_t hi01 = __byte_perm(w0[k], w1[k], 0x7362);
      const uint32_t hi23 = __byte_perm(w2[k], w3[k], 0x7362);
      acc[4 * k] = __dp4a((int)__byte_perm(lo01, lo23, 0x5410), e4, acc[4 * k]);
      acc[4 * k + 1] = __dp4a((int)__byte_perm(lo01, lo23, 0x7632), e4, acc[4 * k + 1]);
      acc[4 * k + 2] = __dp4a((int)__byte_perm(hi01, hi23, 0x5410), e4, acc[4 * k + 2]);
      acc[4 * k + 3] = __dp4a((int)__byte_perm(hi01, hi23, 0x7632), e4, acc[4 * k + 3]);
    }
  }
}

// blockDim = (C / V channel vectors, bins handled at once)
template <typename T, typename TOut>
__global__ void __launch_bounds__(THREADS)
roi_patch_kernel(seam::Pyramid pyr, const float* __restrict__ rois,
                 const float* __restrict__ scales, TOut* __restrict__ out, int R, int C, int O,
                 int ratio) {
  using Tr = Traits<T>;
  using Ent = typename Tr::Ent;
  constexpr int V = Tr::V;
  __shared__ int yoff[MAX_O][MAX_TAPS], xoff[MAX_O][MAX_TAPS];  // row * W; column
  __shared__ float yw[MAX_O][MAX_TAPS], xw[MAX_O][MAX_TAPS];
  __shared__ int yn[MAX_O], xn[MAX_O];
  extern __shared__ __align__(16) unsigned char dyn[];
  Ent* ent = reinterpret_cast<Ent*>(dyn);  // [o * o][(2 ratio)^2], tap pairs (i, j) in order

  // the roi's level and window geometry (patch_geometry), in registers
  const int n = blockIdx.x;
  const float* roi = rois + (size_t)n * 4;
  const int l = seam::roi_level(roi[0], roi[1], roi[2], roi[3]);
  const int H = pyr.h[l], W = pyr.w[l];
  const float sc = pyr.scale[l], hf = (float)H, wf = (float)W;
  const float x1 = roi[0] * sc, y1 = roi[1] * sc;
  const float inv = 1.f / (float)O;
  const float bin_w = fmaxf(roi[2] * sc - x1, 1.f) * inv;
  const float bin_h = fmaxf(roi[3] * sc - y1, 1.f) * inv;
  // window origin one cell above the first sample, inside [-1, size - 1];
  // the column rounded down to the TPU kernel's 8-aligned DMA start
  const float y0 = fminf(fmaxf(floorf(y1) - 1.f, -1.f), fmaxf(hf - 1.f, 0.f));
  const float x0c = fminf(fmaxf(floorf(x1) - 1.f, -1.f), fmaxf(wf - 1.f, 0.f));
  const float x0 = (float)(((int)(x0c + 1.f) / 8) * 8 - 1);  // x0c + 1 >= 0

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int u = tid; u < 2 * O; u += nthreads) {
    if (u < O) {
      axis_taps(y1 - y0, bin_h, -1.f - y0, hf - y0, u, ratio, PATCH, yoff[u], yw[u], yn[u]);
      for (int j = 0; j < yn[u]; ++j) {
        // taps lie inside the image by construction; the clamp only guards memory
        yoff[u][j] = min(max((int)y0 + yoff[u][j], 0), H - 1) * W;
        yw[u][j] = Tr::round_axis(yw[u][j]);
      }
    } else {
      const int v = u - O;
      axis_taps(x1 - x0, bin_w, -1.f - x0, wf - x0, v, ratio, PATCH_W, xoff[v], xw[v], xn[v]);
      for (int j = 0; j < xn[v]; ++j) {
        xoff[v][j] = min(max((int)x0 + xoff[v][j], 0), W - 1);
        xw[v][j] = Tr::round_axis(xw[v][j]);
      }
    }
  }
  __syncthreads();
  const int MT = 2 * ratio, per_bin = MT * MT;
  for (int e = tid; e < O * O * per_bin; e += nthreads) {
    const int bin = e / per_bin, p = e - bin * per_bin;
    const int oy = bin / O, ox = bin - oy * O, nx = xn[ox];
    if (p < yn[oy] * nx) {
      const int i = p / nx;
      ent[e] = Tr::entry(yw[oy][i], xw[ox][p - i * nx]);
    } else {
      ent[e] = 0;  // K7 sums four pairs at a time
    }
  }
  __syncthreads();

  const int c = threadIdx.x * V;
  const T* f = (const T*)pyr.feat[l] + (size_t)(n / R) * H * W * C + c;
  TOut* o = out + (size_t)n * O * O * C + c;
  float dq[V];  // K7's dequantization, as XLA folds it: (1/127) * scale
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) dq[k] = (float)(1.0 / 127.0) * scales[l * C + c + k];
  }
  for (int bin = threadIdx.y; bin < O * O; bin += blockDim.y) {
    const int oy = bin / O, ox = bin - oy * O;
    const Ent* eb = ent + bin * per_bin;
    const int ny = yn[oy], nx = xn[ox];
    float res[V];
    if constexpr (sizeof(T) == 1) {
      int acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0;
      int8_bin_sums(f, yoff[oy], xoff[ox], ny, nx, eb, C, acc);
#pragma unroll
      for (int k = 0; k < V; ++k) res[k] = (float)acc[k] * dq[k];
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) res[k] = 0.f;
      for (int i = 0; i < ny; ++i) {
        const int row = yoff[oy][i];
        for (int j = 0; j < nx; ++j) {
          const float e = eb[i * nx + j];
          float v[V];
          Tr::load(f + (row + xoff[ox][j]) * C, v);
#pragma unroll
          for (int k = 0; k < V; ++k) res[k] += e * v[k];  // exact products for bf16
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; k += seam::Vec<TOut>::N)
      seam::Vec<TOut>::store(o + bin * C + k, res + k);
  }
}

template <typename T, typename TOut>
int launch(seam::Pyramid pyr, const void* rois, const void* scales, void* out, int N, int R,
           int C, int O, int ratio, void* stream) {
  constexpr int V = Traits<T>::V;
  if (O < 1 || O > MAX_O || ratio < 1 || 2 * ratio > MAX_TAPS || C <= 0 || C % V != 0 ||
      C / V > THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = roi_patch_kernel<T, TOut>;
  const int smem = O * O * 4 * ratio * ratio * (int)sizeof(typename Traits<T>::Ent);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vecs = C / V;
  const dim3 block((unsigned)vecs, (unsigned)(vecs < THREADS ? THREADS / vecs : 1));
  kernel<<<(unsigned)N, block, smem, (cudaStream_t)stream>>>(
      pyr, (const float*)rois, (const float*)scales, (TOut*)out, R, C, O, ratio);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: bf16 or f32 features, output in the features' type.
extern "C" int seam_roi_align_patch(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    float s0, float s1, float s2, float s3,
    const void* rois, void* out, int N, int R, int C, int O, int ratio, int is_bf16,
    void* stream) {
  seam::Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  if (is_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(pyr, rois, nullptr, out, N, R, C, O, ratio,
                                                 stream);
  }
  return launch<float, float>(pyr, rois, nullptr, out, N, R, C, O, ratio, stream);
}

// K7: int8 features with scales [4, C] f32, output bf16 or f32.
extern "C" int seam_roi_align_patch_int8(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    float s0, float s1, float s2, float s3,
    const void* rois, const void* scales, void* out, int N, int R, int C, int O, int ratio,
    int out_bf16, void* stream) {
  seam::Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  if (out_bf16) {
    return launch<int8_t, __nv_bfloat16>(pyr, rois, scales, out, N, R, C, O, ratio, stream);
  }
  return launch<int8_t, float>(pyr, rois, scales, out, N, R, C, O, ratio, stream);
}
