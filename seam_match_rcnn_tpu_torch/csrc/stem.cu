// K1 — the fused ResNet stem: maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x)*bn_scale + bn_shift)).
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_stem.py, fused_stem (_stem_kernel).
//
// Numerics, as the TPU kernel: the FrozenBN scale is folded into the conv
// weights, and both x and the folded weights are bf16 (f32 images are rounded
// to nearest even as they are loaded, as .to(torch.bfloat16) rounds them);
// products accumulate in f32, the BN shift is added in f32, relu, and the
// result is rounded to bf16.  Rounding is monotonic, so rounding every conv
// value before the 3x3 max equals rounding the pooled value after it.  The
// output is bf16, or f32 holding the bf16-rounded value.
//
// The tensor cores' f32 sums round otherwise than the plain version's
// (cuDNN's f32 conv, which adds one multiply-add per tap in tap order, as
// the first design of this kernel did).  Where a conv value is small beside
// the magnitude of the products it sums (|value + shift| < 2^-13 max|x| of
// the tile's patch x sum|w| of its channel, a few per mille of the values),
// that rounding can move it by more than one ulp of bf16; the kernel
// recomputes those values on the CUDA cores in the plain version's order
// (not a conv sum that is exactly 0, as over the zeros of a canvas's
// padding, where the bias alone is small).
//
// What bounds it on an H100 at the serving shape [11,3,800,1344] ->
// [11,64,200,336]: the unique conv work is 11*400*672*64*147 = 27.8 G
// multiply-adds (56 GFLOP of bf16 products, 0.06 ms at the tensor cores'
// 989 TFLOP/s); the input is 71 MB in bf16 (142 MB in f32) and the output
// 95 MB (about 0.05-0.07 ms of HBM time).  The TPU kernel's space-to-depth
// slabs, lane rolls and one-hot pooling matmul exist for the TPU's (8,128)
// tiling and are dropped.
//
// Design: an implicit GEMM on the tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 sums).  A block owns an 8x16 tile of pooled outputs for all
// 64 channels.  The tile pools a 17x33 grid of conv positions (one position
// of halo on each side), which it computes once each: M = 561 positions
// (padded to 36 m-tiles of 16), N = 64 channels, K = 147 taps padded to 160
// with zero weights; 1.10x the unique conv work (the first design computed
// every pool window's 3x3 positions on its own, 2.25x, on the CUDA cores).
// The block's 39x71x3 input patch sits in shared memory; the A fragments
// are gathered from it through a table of tap offsets (patch offset of tap k
// = (ci*39 + ky)*72 + kx, of position m = 2*row*72 + 2*col).  The folded
// weights, [64][168] bf16 (K padded to 168 so that the B fragments' rows fall
// on distinct banks), are loaded once per block.  Each warp takes two
// m-tiles at a time, so one B fragment feeds two MMAs.  Bias, relu and the
// bf16 rounding go into a conv tile in shared memory ([561][66] bf16, 66 so
// that the pooling reads of 16 neighbouring columns fall on distinct banks);
// conv positions outside the conv output (the pool's -inf padding) hold 0,
// which after relu is the same floor.  The 3x3/s2 max is then taken from
// there, two channels at a time, and stored NCHW (layer1 takes NCHW): 16
// neighbouring pooled columns of one channel row, 32 bytes of bf16 (64 of
// f32), per half warp.
//
// 113 KB of dynamic shared memory a block, so two blocks share an SM, and
// the grid is persistent (two blocks per SM walk the tiles): one block's
// patch load (scalar, zero-filled at the image border, which is the conv's
// padding, rounding f32 on the way) overlaps the other's MMAs, and the
// weights are read once per block, not once per tile.  No cp.async or TMA:
// the patch rows start at odd columns and f32 rows need rounding, and the
// second resident block already hides the load.
//
// Layouts: x [B,3,H,W] bf16 or f32 (H, W multiples of 4), w [64][168] bf16
// with tap index (ci*7+ky)*7+kx and zeros from 147 on, bias [64] f32, out
// [B,64,H/4,W/4] bf16 or f32 (NCHW).
#include "common.cuh"

namespace {

constexpr int TPH = 8;                // pooled rows per tile
constexpr int TPW = 16;               // pooled cols per tile
constexpr int CH = 2 * TPH + 1;       // conv rows per tile (17)
constexpr int CW = 2 * TPW + 1;       // conv cols per tile (33)
constexpr int NPOS = CH * CW;         // conv positions per tile (561)
constexpr int MTILES = (NPOS + 15) / 16;  // 36
constexpr int IN_H = 4 * TPH + 7;     // input rows a tile reads (39)
constexpr int IN_W = 4 * TPW + 7;     // input cols a tile reads (71)
constexpr int PW = 72;                // patch row stride
constexpr int TAPS = 3 * 7 * 7;       // 147
constexpr int KSTEPS = 10;            // K = 160
constexpr int KP = 168;               // weight row stride
constexpr int COUT = 64;
constexpr int CS = 66;                // conv tile row stride (33 words, odd)
constexpr int WARPS = 9;              // 18 m-tile pairs, 2 per warp
constexpr int THREADS = WARPS * 32;
static_assert(MTILES % 2 == 0 && (MTILES / 2) % WARPS == 0, "m-tile pairs per warp");

constexpr int OFF_W = 0;
constexpr int OFF_K = OFF_W + COUT * KP * 2;          // tap offsets, int2 per tap pair
constexpr int OFF_B = OFF_K + KSTEPS * 8 * 8;
constexpr int OFF_X = OFF_B + COUT * 4;
constexpr int OFF_C = OFF_X + 3 * IN_H * PW * 2;
constexpr int OFF_S = OFF_C + NPOS * CS * 2;          // sum |w| per channel, patch max |x|
constexpr int SMEM = OFF_S + (COUT + WARPS + 1) * 4;  // 113,596 bytes
constexpr unsigned short REDO = 0xFFFF;               // marks a conv value to recompute
constexpr int REDO_EXP = -13;  // recompute |value| < 2^-13 max|x| sum|w| of its channel

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

__device__ __forceinline__ void store(float* p, __nv_bfloat16 v) { *p = __bfloat162float(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, __nv_bfloat16 v) { *p = v; }

// patch offset of tap k, or -1 for the zero-weight padding of K
__device__ __forceinline__ int tap_offset(int k) {
  if (k >= TAPS) return -1;
  const int ci = k / 49, ky = (k / 7) % 7, kx = k % 7;
  return (ci * IN_H + ky) * PW + kx;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The conv value of channel n at patch offset mo as the first design (and, as
// measured, cuDNN's f32 conv, the plain version) computes it on the CUDA
// cores: one f32 multiply-add per tap from 0, in tap order.
__device__ float conv_fma(const __nv_bfloat16* s_x, const __nv_bfloat16* s_w, int mo, int n) {
  const __nv_bfloat16* wn = s_w + n * KP;
  float acc = 0.f;
#pragma unroll 1
  for (int r = 0; r < 3 * 7; ++r) {  // (ci, ky)
    const __nv_bfloat16* xr = s_x + mo + (r / 7 * IN_H + r % 7) * PW;
#pragma unroll
    for (int kx = 0; kx < 7; ++kx)
      acc = fmaf(__bfloat162float(wn[r * 7 + kx]), __bfloat162float(xr[kx]), acc);
  }
  return acc;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
stem_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, TOut* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W);
  int2* s_k = reinterpret_cast<int2*>(smem + OFF_K);
  float* s_b = reinterpret_cast<float*>(smem + OFF_B);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + OFF_X);
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem + OFF_C);
  float* s_w1 = reinterpret_cast<float*>(smem + OFF_S);           // [COUT]
  unsigned* s_xmax = reinterpret_cast<unsigned*>(s_w1 + COUT);    // [WARPS], float bits
  int* s_redo = reinterpret_cast<int*>(s_xmax + WARPS);           // values to recompute

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  for (int i = tid; i < COUT * KP / 8; i += THREADS)
    reinterpret_cast<uint4*>(s_w)[i] = reinterpret_cast<const uint4*>(w)[i];
  for (int i = tid; i < KSTEPS * 8; i += THREADS)
    s_k[i] = make_int2(tap_offset(2 * i), tap_offset(2 * i + 1));
  if (tid < COUT) s_b[tid] = bias[tid];
  if (tid == 0) *s_redo = 0;
  __syncthreads();
  if (tid < COUT) {
    float w1 = 0.f;
    for (int k = 0; k < TAPS; ++k) w1 += fabsf(__bfloat162float(s_w[tid * KP + k]));
    s_w1[tid] = w1;
  }

  const int Hc = H / 2, Wc = W / 2, Ho = H / 4, Wo = W / 4;
  const int tiles_x = (Wo + TPW - 1) / TPW, tiles_y = (Ho + TPH - 1) / TPH;
  const int tiles = B * tiles_y * tiles_x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    const int ty = rest % tiles_y, b = rest / tiles_y;
    const int py0 = ty * TPH, px0 = tx * TPW;
    // conv row cy0 = 2*py0 - 1 (the first pool window's top row) reads
    // input rows from 2*cy0 - 3 = 4*py0 - 5 on
    const int iy0 = 4 * py0 - 5, ix0 = 4 * px0 - 5;

    // 1. the input patch, one row per warp step, zero outside the image
    const TIn* xb = x + (size_t)b * 3 * H * W;
    float xmax = 0.f;
    for (int row = warp; row < 3 * IN_H; row += WARPS) {
      const int ci = row / IN_H, gy = iy0 + row - ci * IN_H;
      const bool yin = gy >= 0 && gy < H;
      const TIn* src = xb + ((size_t)ci * H + (yin ? gy : 0)) * W;
      __nv_bfloat16* dst = s_x + row * PW;
      for (int c = lane; c < IN_W; c += 32) {
        const int gx = ix0 + c;
        const __nv_bfloat16 v = (yin && gx >= 0 && gx < W) ? to_bf16(src[gx]) : zero;
        dst[c] = v;
        xmax = fmaxf(xmax, fabsf(__bfloat162float(v)));
      }
    }
    // max |x| of the patch: non-negative floats order as their bits
    xmax = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(xmax)));
    if (lane == 0) s_xmax[warp] = __float_as_uint(xmax);
    __syncthreads();
    for (int i = 0; i < WARPS; ++i) xmax = fmaxf(xmax, __uint_as_float(s_xmax[i]));
    const float redo_scale = ldexpf(xmax, REDO_EXP);

    // 2. the conv tile: two m-tiles of 16 positions x 64 channels per warp step
    for (int pair = warp; pair < MTILES / 2; pair += WARPS) {
      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      int mo[2][2];  // patch offsets of fragment rows g and g + 8
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = min((2 * pair + i) * 16 + g + 8 * h, NPOS - 1);
          const int cy = m / CW, cx = m - cy * CW;
          mo[i][h] = 2 * cy * PW + 2 * cx;
        }
#pragma unroll
      for (int kb = 0; kb < KSTEPS; ++kb) {
        const int2 k0 = s_k[kb * 8 + t], k1 = s_k[kb * 8 + t + 4];
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (kb < KSTEPS - 1) {
            a[i][0] = pack(s_x[mo[i][0] + k0.x], s_x[mo[i][0] + k0.y]);
            a[i][1] = pack(s_x[mo[i][1] + k0.x], s_x[mo[i][1] + k0.y]);
            a[i][2] = pack(s_x[mo[i][0] + k1.x], s_x[mo[i][0] + k1.y]);
            a[i][3] = pack(s_x[mo[i][1] + k1.x], s_x[mo[i][1] + k1.y]);
          } else {  // taps 144..159: zeros past 146, never read from the patch
            const auto ld = [&](int mrow, int off) { return off >= 0 ? s_x[mrow + off] : zero; };
            a[i][0] = pack(ld(mo[i][0], k0.x), ld(mo[i][0], k0.y));
            a[i][1] = pack(ld(mo[i][1], k0.x), ld(mo[i][1], k0.y));
            a[i][2] = pack(ld(mo[i][0], k1.x), ld(mo[i][0], k1.y));
            a[i][3] = pack(ld(mo[i][1], k1.x), ld(mo[i][1], k1.y));
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* wp = s_w + (j * 8 + g) * KP + kb * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wp + 8);
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
      // bias, relu, bf16 into the conv tile; 0 where the conv output ends;
      // REDO where the value is small beside what its products sum in
      // magnitude, so that the f32 sums' rounding could move it by an ulp
      // of bf16 or more
      int mrow[2][2];
      bool live[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (2 * pair + i) * 16 + g + 8 * h;
          const int cy = m / CW, cx = m - cy * CW;
          const int gcy = 2 * py0 - 1 + cy, gcx = 2 * px0 - 1 + cx;
          mrow[i][h] = m;
          live[i][h] = m < NPOS && gcy >= 0 && gcy < Hc && gcx >= 0 && gcx < Wc;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j * 8 + 2 * t;
        const float b0 = s_b[n], b1 = s_b[n + 1];
        const float lim0 = redo_scale * s_w1[n], lim1 = redo_scale * s_w1[n + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mrow[i][h];
            if (m >= NPOS) continue;
            const float a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
            const float u0 = a0 + b0, u1 = a1 + b1;
            const bool on = live[i][h];
            __nv_bfloat162 r = __floats2bfloat162_rn(on ? fmaxf(u0, 0.f) : 0.f,
                                                     on ? fmaxf(u1, 0.f) : 0.f);
            if (fabsf(u0) < lim0 || fabsf(u1) < lim1) {  // rare: one test a value
              // a sum of zero products (a window of zeros: the canvas's
              // padding) is 0 in any order
              const bool redo0 = on && a0 != 0.f && fabsf(u0) < lim0;
              const bool redo1 = on && a1 != 0.f && fabsf(u1) < lim1;
              if (redo0) r.x = __ushort_as_bfloat16(REDO);
              if (redo1) r.y = __ushort_as_bfloat16(REDO);
              // the list of flagged values lives in the conv tile's pad columns
              int* list = reinterpret_cast<int*>(s_c + COUT);
              const int at = redo0 || redo1 ? atomicAdd(s_redo, redo0 + redo1) : 0;
              if (redo0 && at < NPOS) list[at * (CS / 2)] = m * COUT + n;
              if (redo1 && at + redo0 < NPOS) list[(at + redo0) * (CS / 2)] = m * COUT + n + 1;
            }
            *reinterpret_cast<__nv_bfloat162*>(s_c + m * CS + n) = r;
          }
      }
    }
    __syncthreads();

    // 2b. the flagged values again, in the plain version's arithmetic (a few
    // per mille of the values): one per thread from the list, or by a scan of
    // the conv tile when the list overflowed
    const int redo = *s_redo;
    if (redo != 0) {
      const auto recompute = [&](int m, int n) {
        const int cy = m / CW, cx = m - cy * CW;
        const float v = conv_fma(s_x, s_w, 2 * cy * PW + 2 * cx, n) + s_b[n];
        s_c[m * CS + n] = __float2bfloat16_rn(fmaxf(v, 0.f));
      };
      if (redo <= NPOS) {
        const int* list = reinterpret_cast<const int*>(s_c + COUT);
        for (int i = tid; i < redo; i += THREADS) {
          const int e = list[i * (CS / 2)];
          recompute(e / COUT, e % COUT);
        }
      } else {
        const unsigned* c32 = reinterpret_cast<const unsigned*>(s_c);
        for (int word = tid; word < NPOS * (CS / 2); word += THREADS) {
          const int m = word / (CS / 2), pair = word - m * (CS / 2);
          if (pair >= COUT / 2) continue;
          const unsigned bits = c32[word];
          if ((bits & 0xFFFFu) == REDO) recompute(m, 2 * pair);
          if ((bits >> 16) == REDO) recompute(m, 2 * pair + 1);
        }
      }
      __syncthreads();
      if (tid == 0) *s_redo = 0;  // every thread has read it
    }

    // 3. the 3x3/s2 max, two channels per thread; a half warp stores 16
    // neighbouring columns of one channel row.  The next tile's patch load
    // may start at once: this phase reads only the conv tile.
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(s_c);
    const int pxl = lane & 15, half = lane >> 4;
    const int px = px0 + pxl;
    for (int u = warp; u < TPH * 16; u += WARPS) {
      const int pyl = u & 7, cp = (u >> 3) * 2 + half;  // channel pair 0..31
      const int py = py0 + pyl;
      const int base = (2 * pyl * CW + 2 * pxl) * (CS / 2) + cp;
      __nv_bfloat162 m = c2[base];
#pragma unroll
      for (int k = 1; k < 9; ++k) m = __hmax2(m, c2[base + ((k / 3) * CW + k % 3) * (CS / 2)]);
      if (py < Ho && px < Wo) {
        TOut* o = out + (((size_t)b * COUT + 2 * cp) * Ho + py) * Wo + px;
        store(o, __low2bfloat16(m));
        store(o + (size_t)Ho * Wo, __high2bfloat16(m));
      }
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           void* stream) {
  auto kernel = stem_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long tiles = (long)B * ((H / 4 + TPH - 1) / TPH) * ((W / 4 + TPW - 1) / TPW);
  const int grid = (int)(tiles < 2L * sms ? tiles : 2L * sms);
  kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const TIn*)x, (const __nv_bfloat16*)w, (const float*)bias, (TOut*)out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* seam_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// The pooled rows and columns of a tile and the recompute rule's exponent
// (|value + shift| < 2^redo_exp max|x| sum|w|): chip_smoke.py counts the
// values the kernel recomputes from them.
extern "C" int seam_stem_tile(int* pooled_rows, int* pooled_cols, int* redo_exp) {
  *pooled_rows = TPH;
  *pooled_cols = TPW;
  *redo_exp = REDO_EXP;
  return 0;
}

extern "C" int seam_stem_forward(const void* x, const void* w, const void* bias, void* out,
                                 int B, int H, int W, int in_f32, int out_f32, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 4 != 0 || W % 4 != 0) return (int)cudaErrorInvalidValue;
  if (in_f32) {
    return out_f32 ? launch<float, float>(x, w, bias, out, B, H, W, stream)
                   : launch<float, __nv_bfloat16>(x, w, bias, out, B, H, W, stream);
  }
  return out_f32 ? launch<__nv_bfloat16, float>(x, w, bias, out, B, H, W, stream)
                 : launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, B, H, W, stream);
}
