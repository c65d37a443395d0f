// K10 — ViTDet's residual stream in one pass: the residual add, the LayerNorm
// that follows it and the rounding of its output to the compute dtype.
//
// Replaces no TPU kernel: the JAX package has no vision transformer.  Each
// residual branch of a ViTDet block ends in
//     x = x + branch;   y = LN(x).to(compute dtype)
// (the f32 stream, the branch and y in the compute dtype), which eager PyTorch
// runs as three passes over the stream: the add, the LayerNorm with an f32
// output, the cast.  Per token row of C channels in bf16 they move 4C + 2C +
// 4C (add), 4C + 4C (LayerNorm), 4C + 2C (cast) = 24C bytes; this pass reads
// x and the branch and writes the new x and y, 12C bytes.
//
// Numerics.  x_new = __fadd_rn(x, float(branch)): the add's one rounding, bit
// for bit.  The LayerNorm in f32 from the registers: mean = sum / C, var =
// sum((v - mean)^2) / C (two passes over the registers, not Welford), rstd =
// rsqrtf(var + eps), y = rnd(fma(w, rstd * (v - mean), b)), the expression
// PyTorch's vectorized LayerNorm kernel forms for each output.  Only the
// statistics' rounding differs from PyTorch's (Welford over its threads), by
// an f32 ulp or so, so y can differ from the chain where that moves it across
// a rounding boundary of the compute dtype.  A row that holds a NaN or an
// infinity (after the add) gives NaN everywhere in y, as the chain does; a
// row whose sum overflows f32 (|values| near 3e35) would too, where Welford
// would not.  The library builds with -fmad=false; the one fused multiply-add
// is written out.
//
// What bounds it on an H100: bytes, 12 a channel against ~8 flops.  At the
// ViTDet-L cell's chunk, x [11, 64, 64, 1024]: 45,056 rows, 553.6 MB, 0.165 ms
// at 3.35 TB/s.
//
// Design: one warp a row, the row held in registers: lane l takes the groups
// of 8 channels l, l + 32, l + 64, ... (C / 256 groups for C = 1024), each as
// two 16-byte f32x4 loads of x, one 16-byte load of the branch's 8 bf16 (two
// f32x4 in f32), and the same stores; the warp's loads of one group index
// cover 1 KB of x without a gap.  The sums are warp shuffles: no shared
// memory, no barrier.  WARPS rows a block.  x and the branch are read, and
// x_new written, with the streaming cache hint (each is touched once here,
// and next only after the block's attention or MLP), so the L2 keeps more of
// y for the dense layer that reads it next.  The group count, the compute
// dtype and whether there is a branch are template arguments.
//
// Layouts: x, x_new [rows, C] f32; branch, y [rows, C] in the compute dtype
// (bf16 or f32); w, b [C] f32; every pointer 16-byte aligned, C a multiple of
// 8 up to 2048.  Without a branch (the first block's norm1 on the stream the
// positional add formed) x_new is not written.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // rows a block
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 8;       // channels a lane takes at a time
constexpr int MAX_GROUPS = 8;  // groups a lane: C <= 32 * 8 * 8 = 2048

__device__ __forceinline__ void unpack(float4 a, float4 b, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

// 8 values from p, once: the streaming hint
__device__ __forceinline__ void load_once(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  unpack(__ldcs(q), __ldcs(q + 1), v);
}
__device__ __forceinline__ void load_once(const __nv_bfloat16* p, float* v) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 of the LayerNorm's parameters, read by every row: through the read-only cache
__device__ __forceinline__ void load_param(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  unpack(__ldg(q), __ldg(q + 1), v);
}

__device__ __forceinline__ void store_once(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
  __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// y: a plain store (the next dense layer reads it)
__device__ __forceinline__ void store_out(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

template <typename T, int G, bool BRANCH>
__global__ void __launch_bounds__(THREADS)
    vit_residual_ln_kernel(const float* __restrict__ x, const T* __restrict__ br,
                           const float* __restrict__ w, const float* __restrict__ b,
                           float* __restrict__ x_new, T* __restrict__ y, int rows, int C,
                           float eps) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: the shuffles below see every lane
  const int lane = threadIdx.x & 31;
  const long long base = (long long)row * C;
  float v[G][GROUP];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int c = (k * 32 + lane) * GROUP;
    if (c < C) {
      load_once(x + base + c, v[k]);
      if (BRANCH) {
        float r[GROUP];
        load_once(br + base + c, r);
#pragma unroll
        for (int j = 0; j < GROUP; ++j) v[k][j] = __fadd_rn(v[k][j], r[j]);
        store_once(x_new + base + c, v[k]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) v[k][j] = 0.f;  // adds nothing to the sum
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k)
#pragma unroll
    for (int j = 0; j < GROUP; ++j) s = __fadd_rn(s, v[k][j]);
  const float mean = __fdiv_rn(warp_sum(s), (float)C);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if ((k * 32 + lane) * GROUP < C) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const float d = __fsub_rn(v[k][j], mean);
        q = __fmaf_rn(d, d, q);
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)C), eps));
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int c = (k * 32 + lane) * GROUP;
    if (c < C) {
      float wk[GROUP], bk[GROUP], o[GROUP];
      load_param(w + c, wk);
      load_param(b + c, bk);
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        o[j] = __fmaf_rn(wk[j], __fmul_rn(rstd, __fsub_rn(v[k][j], mean)), bk[j]);
      store_out(y + base + c, o);
    }
  }
}

template <typename T, int G, bool BRANCH>
int launch(const void* x, const void* br, const void* w, const void* b, void* x_new, void* y,
           int rows, int C, float eps, void* stream) {
  vit_residual_ln_kernel<T, G, BRANCH><<<(rows + WARPS - 1) / WARPS, THREADS, 0,
                                          (cudaStream_t)stream>>>(
      (const float*)x, (const T*)br, (const float*)w, (const float*)b, (float*)x_new, (T*)y,
      rows, C, eps);
  return (int)cudaGetLastError();
}

// the template instance of the group count
template <typename T, bool BRANCH>
int by_groups(int groups, const void* x, const void* br, const void* w, const void* b,
              void* x_new, void* y, int rows, int C, float eps, void* stream) {
  switch (groups) {
    case 1: return launch<T, 1, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 2: return launch<T, 2, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 3: return launch<T, 3, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 4: return launch<T, 4, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 5: return launch<T, 5, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 6: return launch<T, 6, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 7: return launch<T, 7, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
    case 8: return launch<T, 8, BRANCH>(x, br, w, b, x_new, y, rows, C, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// branch and x_new: null together (no residual add); is_f32: the compute dtype
// of branch and y is f32 (else bf16)
extern "C" int seam_vit_residual_ln(const void* x, const void* branch, const void* w,
                                    const void* b, void* x_new, void* y, int rows, int C,
                                    float eps, int is_f32, void* stream) {
  if (rows <= 0 || C <= 0 || C % GROUP != 0 || C > 32 * GROUP * MAX_GROUPS ||
      (branch == nullptr) != (x_new == nullptr))
    return (int)cudaErrorInvalidValue;
  const int groups = (C + 32 * GROUP - 1) / (32 * GROUP);
  if (is_f32)
    return branch ? by_groups<float, true>(groups, x, branch, w, b, x_new, y, rows, C, eps, stream)
                  : by_groups<float, false>(groups, x, branch, w, b, x_new, y, rows, C, eps,
                                            stream);
  return branch ? by_groups<__nv_bfloat16, true>(groups, x, branch, w, b, x_new, y, rows, C, eps,
                                                 stream)
                : by_groups<__nv_bfloat16, false>(groups, x, branch, w, b, x_new, y, rows, C,
                                                  eps, stream);
}
