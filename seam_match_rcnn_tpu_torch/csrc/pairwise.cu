// K4 — pairwise gallery match probability.
//
// Replaces: seam_match_rcnn_tpu/ops/pallas_kernels.py, pairwise_scores (_pairwise_kernel).
//
//   out[i,j] = sigmoid(a_i + g_j - 2 * (x_i o v) . y_j + c0)
//   a_i = sum_c x_ic^2 v_c,  g_j = sum_c y_jc^2 v_c,  v = w1 - w0,  c0 = b1 - b0
//
// which is softmax((x_i - y_j)^2 W^T + b)[1] of the reference's Linear(256, 2)
// scorer, in full f32 on the FMA units: a_i + g_j - 2*cross cancels badly for
// near-duplicate descriptors, so neither TF32 nor bf16 may touch any term.
//
// What bounds it on an H100: at the main path's shapes (1 x G for a request
// against the gallery, N x N frame self-similarity and N x G eval scores, N
// up to about 1000) the work is small: 1000 x 1000 x 256 is 0.5 GFLOP, 7.6 us
// at the 67 TFLOP/s of f32 FMA, on a few MB of inputs.  A request (Q = 1) is
// bound by latency: the launch, the host's call, and the chain of k-steps one
// block walks.  At 1000 x 1000 the multiply-adds are most of the time, and
// with them what feeds them: the copies, the rank-1 pass, the barriers.
//
// The first design was a classic tiled GEMM of 64x64 outputs per
// block whose rank-1 terms came from a serial pre-pass (one thread per row
// walking its 256 channels with strided global loads before the first
// barrier: tens of microseconds that nothing hid), with scalar, unpipelined
// k-tile loads, v and c0 formed by extra launches in the wrapper, and 63 of
// 64 tile rows idle at Q = 1.  It was 4x slower than cuBLAS's f32 GEMM of the
// expansion at 1000 x 1000.
//
// This design:
//  * one kernel templated on its tile: 16 x 16 outputs per block for Q up to
//    128 (the wrapper picks from Q), so that a request spreads a gallery of
//    G rows over G / 16 blocks, and 64 x 64 above; 256 threads, thread
//    (ty, tx) owning rows ty + TY m and columns tx + 16 n;
//  * k-tiles of 32 channels of x, y and both rows of w staged with cp.async,
//    16 bytes a thread, in a ring of 8 (short tile: the whole of C = 256 in
//    flight at once) or 4 stages; the copies of a later tile are issued a few
//    at a time between the chunks of the multiply, and each copy's source
//    row and slot offset are computed once, before the loop;
//  * v = w1 - w0 formed from the staged w tile, and the rank-1 terms taken
//    from the staged tiles: every thread owns one 16-byte chunk of a few tile
//    rows, adds x^2 v (or y^2 v) into its partial a_i (g_j) and scales x by v
//    in place; the 8 partials of a row are summed with warp shuffles at the
//    end.  No pass of its own over x or y;
//  * one barrier a k-tile: iteration kt multiplies tile kt while it scales
//    tile kt + 1 and refills the slot of tile kt - 1;
//  * tiles kept row-major with a row stride of 36 floats, so that the 16-byte
//    copies land aligned and eight neighbouring rows' float4 reads fall on
//    eight distinct bank groups;
//  * rows beyond Q skip the multiply (a request computes one row of its
//    tile), and a thread with 1 or 2 outputs keeps a sum per float4 component
//    to shorten its chain of dependent multiply-adds;
//  * c0 = b1 - b0 and the sigmoid in the epilogue; [Q, G] written once.
// The call is one launch (plus the output's allocation in the wrapper).
//
// Layouts: x [Q,C], y [G,C], w [2,C] f32, C a multiple of 4, each 16-byte
// aligned; b [2] f32; out [Q,G] f32.  Ragged Q, G and C are zero-filled by
// the copies and masked at the store.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BK = 32, THREADS = 256, TY = THREADS / 16;
constexpr int LD = BK + 4;      // row stride of a staged tile, in floats (LD / 4 odd)
constexpr int CHUNKS = BK / 4;  // 16-byte chunks in a tile row

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One ring slot: a k-tile of x (BM rows), y (BN rows) and both rows of w.
template <int BM, int BN>
struct Slot {
  float x[BM][LD];
  float y[BN][LD];
  float w[2][BK];
};

template <int BM, int BN, int STAGES>
constexpr size_t smem_bytes() {
  return STAGES * sizeof(Slot<BM, BN>) + (BM + BN) * sizeof(float);
}

// BM x BN outputs per block; thread (ty, tx) owns rows ty + TY m and
// columns tx + 16 n.
template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, const float* __restrict__ b,
                float* __restrict__ out, int Q, int G, int C) {
  constexpr int TM = BM / TY, TN = BN / 16, ROWS = BM + BN;
  // the 16-byte copies of one k-tile, in rounds of THREADS, one round per
  // chunk of the multiply
  constexpr int COPIES = (ROWS + 2) * CHUNKS, ROUNDS = (COPIES + THREADS - 1) / THREADS;
  static_assert(ROUNDS <= CHUNKS, "a tile's copies are issued over the multiply's chunks");
  // rank-1 work items, (tile row, 16-byte chunk) pairs: a thread keeps one
  // chunk, and its rows lie THREADS / CHUNKS apart
  constexpr int ITEMS = (ROWS * CHUNKS + THREADS - 1) / THREADS;
  static_assert(THREADS % CHUNKS == 0, "a thread's chunk must not change between items");
  static_assert(STAGES >= 3, "tiles kt - 1, kt and kt + 1 need slots of their own");
  using S = Slot<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* slot = reinterpret_cast<S*>(smem);
  float* s_rank1 = reinterpret_cast<float*>(smem + STAGES * sizeof(S));  // a, then g
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = (C + BK - 1) / BK;
  const bool live = row0 + ty < Q;  // else none of this thread's rows is a query

  // Each round of a tile's copies moves the same (row, chunk) of every
  // tile: its source row (null when the row is ragged or the round empty),
  // its column in the tile and its offset in a ring slot are set once here.
  // x and y share the row stride, so that a slot is one [ROWS][LD] array
  // followed by w.
  const float* src_row[ROUNDS];
  int col[ROUNDS], dst_off[ROUNDS];
#pragma unroll
  for (int round = 0; round < ROUNDS; ++round) {
    const int e = tid + round * THREADS, r = e / CHUNKS;
    col[round] = (e % CHUNKS) * 4;
    dst_off[round] = (r < ROWS ? r * LD : ROWS * LD + (r - ROWS) * BK) + col[round];
    src_row[round] = e >= COPIES ? nullptr
                     : r < BM ? (row0 + r < Q ? x + (size_t)(row0 + r) * C : nullptr)
                     : r < ROWS ? (col0 + r - BM < G ? y + (size_t)(col0 + r - BM) * C : nullptr)
                                : w + (size_t)(r - ROWS) * C;
  }
  // round `round` of the copies of k-tile kt into ring slot kt % STAGES;
  // a ragged row or a column beyond C is zero-filled
  auto stage = [&](int kt, int round) {
    if (tid + round * THREADS >= COPIES) return;
    const int k = kt * BK + col[round];
    const bool full = src_row[round] != nullptr && k < C;
    cp_async16(reinterpret_cast<float*>(slot + kt % STAGES) + dst_off[round],
               full ? src_row[round] + k : x, full);
  };

#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < KT)
#pragma unroll
      for (int round = 0; round < ROUNDS; ++round) stage(kt, round);
    cp_async_commit();
  }

  // A thread with a few outputs keeps one sum per float4 component, so that
  // its dependent chain of multiply-adds is a quarter as long.
  constexpr int SPLIT = TM * TN <= 2 ? 4 : 1;
  float acc[TM][TN][SPLIT];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int c = 0; c < SPLIT; ++c) acc[m][n][c] = 0.f;
  const int chunk = tid % CHUNKS;
  float part[ITEMS];  // partial a_r (r < BM) or g_j (r >= BM) over this thread's chunk
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) part[i] = 0.f;

  // the rank-1 terms from staged tile kt, and its x scaled by v = w1 - w0 in place
  auto rank1 = [&](int kt) {
    S& sl = slot[kt % STAGES];
    const float4 w0 = *reinterpret_cast<const float4*>(&sl.w[0][chunk * 4]);
    const float4 w1 = *reinterpret_cast<const float4*>(&sl.w[1][chunk * 4]);
    const float4 v = make_float4(w1.x - w0.x, w1.y - w0.y, w1.z - w0.z, w1.w - w0.w);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = (tid + i * THREADS) / CHUNKS;
      if (r >= ROWS) break;
      float* p = r < BM ? &sl.x[r][chunk * 4] : &sl.y[r - BM][chunk * 4];
      const float4 q = *reinterpret_cast<float4*>(p);
      part[i] = fmaf(q.x * q.x, v.x, part[i]);
      part[i] = fmaf(q.y * q.y, v.y, part[i]);
      part[i] = fmaf(q.z * q.z, v.z, part[i]);
      part[i] = fmaf(q.w * q.w, v.w, part[i]);
      if (r < BM) *reinterpret_cast<float4*>(p) = make_float4(q.x * v.x, q.y * v.y,
                                                               q.z * v.z, q.w * v.w);
    }
  };

  cp_async_wait<STAGES - 2>();  // tile 0 has landed
  __syncthreads();
  rank1(0);
  // Iteration kt multiplies tile kt (scaled the iteration before) while it
  // scales tile kt + 1 and copies tile kt + STAGES - 1 into the slot of tile
  // kt - 1: three distinct slots, so one barrier a tile orders them all.
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of tile kt + 1 have landed
    __syncthreads();  // everyone's have, tile kt is scaled, slot (kt - 1) % STAGES is free
    if (kt + 1 < KT) rank1(kt + 1);
    const S& sl = slot[kt % STAGES];
    // the copies spread over the chunks of the multiply, so that the warps
    // stalled on a full copy queue are few at a time
    const bool refill = kt + STAGES - 1 < KT;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      if (refill && k / 4 < ROUNDS) stage(kt + STAGES - 1, k / 4);
      if (!live) continue;
      float4 xr[TM], yr[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) xr[m] = *reinterpret_cast<const float4*>(&sl.x[ty + TY * m][k]);
#pragma unroll
      for (int n = 0; n < TN; ++n) yr[n] = *reinterpret_cast<const float4*>(&sl.y[tx + 16 * n][k]);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          float* a = acc[m][n];
          a[0] = fmaf(xr[m].x, yr[n].x, a[0]);
          a[1 % SPLIT] = fmaf(xr[m].y, yr[n].y, a[1 % SPLIT]);
          a[2 % SPLIT] = fmaf(xr[m].z, yr[n].z, a[2 % SPLIT]);
          a[3 % SPLIT] = fmaf(xr[m].w, yr[n].w, a[3 % SPLIT]);
        }
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // a_r and g_j: the CHUNKS partials of a row sit on CHUNKS neighbouring lanes
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    float p = part[i];
#pragma unroll
    for (int o = 1; o < CHUNKS; o *= 2) p += __shfl_xor_sync(0xffffffffu, p, o);
    const int r = (tid + i * THREADS) / CHUNKS;
    if (chunk == 0 && r < ROWS) s_rank1[r] = p;
  }
  __syncthreads();
  const float c0 = b[1] - b[0];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = row0 + ty + TY * m;
    if (i >= Q) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int j = col0 + tx + 16 * n;
      if (j >= G) continue;
      const float* a = acc[m][n];
      const float cross = SPLIT == 4 ? (a[0] + a[1 % SPLIT]) + (a[2 % SPLIT] + a[3 % SPLIT]) : a[0];
      const float d = s_rank1[ty + TY * m] + s_rank1[BM + tx + 16 * n] - 2.f * cross + c0;
      out[(size_t)i * G + j] = 1.f / (1.f + expf(-d));
    }
  }
}

template <int BM, int BN, int STAGES>
int launch(const void* x, const void* y, const void* w, const void* b, void* out, int Q, int G,
           int C, void* stream) {
  constexpr size_t bytes = smem_bytes<BM, BN, STAGES>();
  // dynamic shared memory above 48 KB needs the opt-in, once per device
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES || !configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(pairwise_kernel<BM, BN, STAGES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) configured[dev] = true;
  }
  const dim3 grid((unsigned)((G + BN - 1) / BN), (unsigned)((Q + BM - 1) / BM));
  pairwise_kernel<BM, BN, STAGES><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)w, (const float*)b, (float*)out, Q, G, C);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: the tile rows, 16 or 64 (the wrapper picks them from Q).  The short
// tile is 16 x 16, so that a request spreads the gallery over G / 16 blocks;
// the tall one 64 x 64.
extern "C" int seam_pairwise_scores(const void* x, const void* y, const void* w, const void* b,
                                    void* out, int Q, int G, int C, int rows, void* stream) {
  switch (rows) {
    case 16:
      return launch<16, 16, 8>(x, y, w, b, out, Q, G, C, stream);
    case 64:
      return launch<64, 64, 4>(x, y, w, b, out, Q, G, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
