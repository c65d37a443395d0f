// K8 — the epilogue of a backbone conv in one pass: FrozenBN scale and shift,
// the residual (the identity, or the downsample conv's raw output with its own
// FrozenBN) and ReLU; and its backward.
//
// Replaces no TPU kernel: on the TPU, XLA fused these elementwise ops into the
// conv's output.  Eager PyTorch runs them one kernel each: y * scale, + shift,
// the residual add and the ReLU (clamp_min), each reading and writing the whole
// activation, the broadcast ones without vector loads.
//
// Numerics, bit for bit the op chain's (models/resnet.py before this kernel):
// every product and sum is formed in f32 from values of the compute dtype and
// rounded to it at once, as PyTorch's elementwise kernels round each op's
// result:  t = rnd(rnd(y * s) + h);  r = rnd(rnd(y_d * s_d) + h_d) for the raw
// downsample;  t = rnd(t + r);  ReLU as clamp_min (NaN passes, fmaxf
// otherwise).  rnd is round-to-nearest-even to bf16 (the identity in f32).
// The library builds with -fmad=false and the code calls __fmul_rn and
// __fadd_rn, so no product is fused into a sum.  The backward repeats
// autograd's chain: g = out <= 0 ? 0 : grad (threshold_backward), grad_y =
// rnd(g * s), grad_r = g, or rnd(g * s_d) for the raw downsample.
//
// What bounds it on an H100: bytes.  A 1x1 or 3x3 conv's output is read once
// and the result written once (the residual read once more): about 2 bytes of
// bf16 moved per 2-6 flops, far below the card's 295 flops a byte.  Over one
// 800x1344 canvas's 52 FrozenBNs that is 0.99 GB, against 3.23 GB for the op
// chain (0.30 ms against 0.96 ms at 3.35 TB/s).
//
// Design: one thread per 16 bytes of output (8 bf16 or 4 f32 values, one
// vector load of y and of the residual, one vector store), 256 threads a block,
// the flat NCHW tensor walked in order so a warp reads 512 neighbouring bytes.
// The channel of the vector's first value comes from one division; a vector
// that crosses into the next channel plane (H*W not a multiple of the vector)
// steps the channel as it goes, and the last, ragged vector of the tensor, or
// any vector of a tensor whose pointers are not 16-byte aligned, is loaded and
// stored value by value.  Scale and shift are read through the read-only
// cache once a vector (again at a plane boundary).  The variant (residual
// kind, ReLU, dtype) is a template argument, so each launch runs straight-line
// code.
//
// Layouts: y, residual, out, grad, grad_y, grad_r [B, C, H, W] contiguous in
// the compute dtype (bf16 or f32), scale and shift [C] in the same dtype;
// B*C*H*W < 2^31.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NONE = 0, IDENTITY = 1, RAW = 2;  // the residual's kind
template <typename T> constexpr int VEC = 16 / sizeof(T);  // values a thread takes

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// the compute dtype's rounding of an f32 result
template <typename T> __device__ __forceinline__ float rnd(float v) { return f32(from_f32<T>(v)); }

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The values [e0, e0 + n) of p into v as they are stored: one 16-byte load,
// or one at a time (zeros past n).  Values move as bits, so a NaN that an
// op passes through keeps its payload, as PyTorch's threshold_backward keeps it.
template <typename T>
__device__ __forceinline__ void load(const T* p, int e0, int n, bool vec, T* v) {
  if (vec && n == VEC<T>) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p + e0);
  } else {
#pragma unroll
    for (int k = 0; k < VEC<T>; ++k) v[k] = k < n ? p[e0 + k] : from_f32<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void store(T* p, int e0, int n, bool vec, const T* v) {
  if (vec && n == VEC<T>) {
    *reinterpret_cast<uint4*>(p + e0) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int k = 0; k < VEC<T>; ++k)
      if (k < n) p[e0 + k] = v[k];
  }
}

// The channel walk of one thread's vector: the channel of value e0, and the
// position in its plane, stepped value by value.
struct Channel {
  int c, pos;
  __device__ __forceinline__ Channel(int e0, int C, int HW) {
    const int plane = e0 / HW;
    pos = e0 - plane * HW;
    c = plane % C;
  }
  // true when the next value starts the next channel's plane
  __device__ __forceinline__ bool step(int C, int HW) {
    if (++pos < HW) return false;
    pos = 0;
    if (++c == C) c = 0;
    return true;
  }
};

template <typename T, int MODE, bool RELU>
__global__ void __launch_bounds__(THREADS)
    epilogue_forward(const T* __restrict__ y, const T* __restrict__ s, const T* __restrict__ h,
                     const T* __restrict__ r, const T* __restrict__ s_d,
                     const T* __restrict__ h_d, T* __restrict__ out, int numel, int C, int HW,
                     bool vec) {
  constexpr int N = VEC<T>;
  const unsigned first = (blockIdx.x * THREADS + threadIdx.x) * N;  // < 2^31 + THREADS * N
  if (first >= (unsigned)numel) return;
  const int e0 = (int)first;
  const int n = min(N, numel - e0);
  alignas(16) T a[N], b[N], o[N];
  load(y, e0, n, vec, a);
  if (MODE != NONE) load(r, e0, n, vec, b);
  Channel ch(e0, C, HW);
  float sc = load1(s + ch.c), sh = load1(h + ch.c);
  float sd = MODE == RAW ? load1(s_d + ch.c) : 0.f, hd = MODE == RAW ? load1(h_d + ch.c) : 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(f32(a[k]), sc)), sh));
    if (MODE == RAW) {
      const float r_k = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(f32(b[k]), sd)), hd));
      t = rnd<T>(__fadd_rn(t, r_k));
    }
    if (MODE == IDENTITY) t = rnd<T>(__fadd_rn(t, f32(b[k])));
    if (RELU && !isnan(t)) t = fmaxf(t, 0.f);
    o[k] = from_f32<T>(t);
    if (k + 1 < N && ch.step(C, HW)) {
      sc = load1(s + ch.c);
      sh = load1(h + ch.c);
      if (MODE == RAW) {
        sd = load1(s_d + ch.c);
        hd = load1(h_d + ch.c);
      }
    }
  }
  store(out, e0, n, vec, o);
}

template <typename T, int MODE, bool RELU>
__global__ void __launch_bounds__(THREADS)
    epilogue_backward(const T* __restrict__ grad, const T* __restrict__ out,
                      const T* __restrict__ s, const T* __restrict__ s_d,
                      T* __restrict__ grad_y, T* __restrict__ grad_r, int numel, int C, int HW,
                      bool vec) {
  constexpr int N = VEC<T>;
  const unsigned first = (blockIdx.x * THREADS + threadIdx.x) * N;  // < 2^31 + THREADS * N
  if (first >= (unsigned)numel) return;
  const int e0 = (int)first;
  const int n = min(N, numel - e0);
  alignas(16) T g[N], o[N], gy[N], gr[N];
  load(grad, e0, n, vec, g);
  if (RELU) load(out, e0, n, vec, o);
  Channel ch(e0, C, HW);
  float sc = load1(s + ch.c), sd = MODE == RAW ? load1(s_d + ch.c) : 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T gk = RELU && f32(o[k]) <= 0.f ? from_f32<T>(0.f) : g[k];
    gy[k] = from_f32<T>(__fmul_rn(f32(gk), sc));
    gr[k] = MODE == RAW ? from_f32<T>(__fmul_rn(f32(gk), sd)) : gk;
    if (k + 1 < N && ch.step(C, HW)) {
      sc = load1(s + ch.c);
      if (MODE == RAW) sd = load1(s_d + ch.c);
    }
  }
  store(grad_y, e0, n, vec, gy);
  if (MODE != NONE) store(grad_r, e0, n, vec, gr);
}

int blocks(int numel, int n) {
  return (int)(((long long)numel + n * THREADS - 1) / (n * THREADS));
}

// the launches, one struct a kernel, so that dispatch() can pick the template instance
template <typename T, int MODE, bool RELU> struct Forward {
  static int run(const void* y, const void* s, const void* h, const void* r, const void* s_d,
                 const void* h_d, void* out, int numel, int C, int HW, bool vec, void* stream) {
    epilogue_forward<T, MODE, RELU><<<blocks(numel, VEC<T>), THREADS, 0,
                                      (cudaStream_t)stream>>>(
        (const T*)y, (const T*)s, (const T*)h, (const T*)r, (const T*)s_d, (const T*)h_d,
        (T*)out, numel, C, HW, vec);
    return (int)cudaGetLastError();
  }
};

template <typename T, int MODE, bool RELU> struct Backward {
  static int run(const void* grad, const void* out, const void* s, const void* s_d,
                 void* grad_y, void* grad_r, int numel, int C, int HW, bool vec, void* stream) {
    epilogue_backward<T, MODE, RELU><<<blocks(numel, VEC<T>), THREADS, 0,
                                       (cudaStream_t)stream>>>(
        (const T*)grad, (const T*)out, (const T*)s, (const T*)s_d, (T*)grad_y, (T*)grad_r,
        numel, C, HW, vec);
    return (int)cudaGetLastError();
  }
};

// the template instance of (dtype, residual kind, relu)
template <template <typename, int, bool> class F, typename... A>
int dispatch(int mode, int relu, int is_f32, A... args) {
  if (is_f32) {
    switch (mode * 2 + relu) {
      case 0: return F<float, NONE, false>::run(args...);
      case 1: return F<float, NONE, true>::run(args...);
      case 2: return F<float, IDENTITY, false>::run(args...);
      case 3: return F<float, IDENTITY, true>::run(args...);
      case 4: return F<float, RAW, false>::run(args...);
      case 5: return F<float, RAW, true>::run(args...);
    }
  } else {
    switch (mode * 2 + relu) {
      case 0: return F<__nv_bfloat16, NONE, false>::run(args...);
      case 1: return F<__nv_bfloat16, NONE, true>::run(args...);
      case 2: return F<__nv_bfloat16, IDENTITY, false>::run(args...);
      case 3: return F<__nv_bfloat16, IDENTITY, true>::run(args...);
      case 4: return F<__nv_bfloat16, RAW, false>::run(args...);
      case 5: return F<__nv_bfloat16, RAW, true>::run(args...);
    }
  }
  return (int)cudaErrorInvalidValue;
}

bool valid(int numel, int C, int HW, int mode, int relu) {
  return numel > 0 && C > 0 && HW > 0 && mode >= NONE && mode <= RAW && (relu == 0 || relu == 1);
}

}  // namespace

// mode: 0 no residual, 1 the identity r, 2 the raw downsample r with (s_d, h_d);
// vec: every pointer is 16-byte aligned
extern "C" int seam_bn_epilogue_forward(const void* y, const void* s, const void* h,
                                        const void* r, const void* s_d, const void* h_d,
                                        void* out, int numel, int C, int HW, int mode, int relu,
                                        int is_f32, int vec, void* stream) {
  if (!valid(numel, C, HW, mode, relu)) return (int)cudaErrorInvalidValue;
  return dispatch<Forward>(mode, relu, is_f32, y, s, h, r, s_d, h_d, out, numel, C, HW,
                           vec != 0, stream);
}

extern "C" int seam_bn_epilogue_backward(const void* grad, const void* out, const void* s,
                                         const void* s_d, void* grad_y, void* grad_r,
                                         int numel, int C, int HW, int mode, int relu,
                                         int is_f32, int vec, void* stream) {
  if (!valid(numel, C, HW, mode, relu)) return (int)cudaErrorInvalidValue;
  return dispatch<Backward>(mode, relu, is_f32, grad, out, s, s_d, grad_y, grad_r, numel, C,
                            HW, vec != 0, stream);
}
