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
// version's bit for bit; only the order of the f32 additions differs, and it
// is fixed: two calls on the same inputs return the same bytes.
//
// None of the TPU kernel's structure carries over: no 64x64 ownership tiles,
// no duplication of a roi into at most 2x2 bands (which drops the tail
// samples of a roi beyond them), no single bf16 passes.  Every sample of
// every roi lands.
//
// What bounds it on an H100 at the phase-1 training shapes (8 x 512 rois at
// 7x7 and 8 x 128 at 14x14, C = 256, an 8-image 800x1344 pyramid): the bytes
// it must move are a 205 MB f32 cotangent read per branch plus the gradient
// pyramid written once (366 MB in bf16), about 0.17 ms at 3.35 TB/s.  Its
// arithmetic is ~0.8 G f32 multiply-adds per branch (4096 x 14 x 14 samples
// x 4 corners x 256 channels at 7x7, 1024 x 28 x 28 x 4 x 256 at 14x14).
// The first design did those adds as f32 atomics in L2 into an f32 scratch
// that the wrapper zeroed and then cast (1.8 GB of extra traffic), and took
// ~38x the bound.  This design adds in shared memory, and each cell's sum is
// owned by one thread, so it needs no atomic adds:
//
// * owner computes: one block per (image, level, tile of 8x8 cells, group of
//   256 channels), each thread owning two channels (c and c + 128); the
//   tile's f32 sums (64 KB and a trash cell) stay in shared memory,
//   cell-major with the channels fastest, so a warp touches 32 neighbouring
//   floats (no bank conflicts) and reads the cotangent coalesced.  A thread adds into its
//   own channels of the tile's cells only, in a fixed order (roi, bin row,
//   bin column, sample row, sample column, corner).
// * each block scans its image's rois, keeps in roi order those that map to
//   its level and whose footprint (the cells their samples can touch, from
//   the first and last sample along each axis; the plain twin is
//   ops/roi_align.roi_footprints) meets the tile, and builds their sample
//   tables in shared memory: per sample row and column, the offset in the
//   tile's sums and the weight of each corner, the trash cell where the
//   corner is off the tile, outside [-1, H] or of weight 0 (the border
//   rule's duplicate corner; skipping it changes no sum).  The sample range
//   that reaches the tile (a min and a max over the table, the same in any
//   order) bounds the loops, so a roi that spans many tiles costs each tile
//   only its share.  No binning pass and no list in global memory: one
//   launch a call.
// * per bin, its sample taps are loaded together (16 bytes each); per
//   sample, the 4 corners are distinct cells (a corner that adds nothing
//   here goes to the trash cell with weight 0), so their loads, adds and
//   stores issue together; the cotangent of a roi's next bin is loaded while
//   the current bin's samples are added.
// * the tile is written once in the features' dtype straight into the
//   channels_last output, 16 bytes a store, zeros where no roi reaches; the
//   wrapper allocates it with torch.empty and launches nothing else.
// * blocks of P5 go first, then P4, P3, P2: the coarse levels' tiles take
//   many rois each, the fine levels' many tiles few.
//
// What limits it (tools/probe_adjoint_tiles.py times every block and its
// phases): the sample loop takes about two thirds of the blocks' cycles,
// several hundred cycles a sample, part of them waiting on the cotangent's
// loads from device memory (the first bin of each roi is not prefetched: a
// version that loaded it during the previous roi spilled registers and ran
// slower).  With 73 KB of shared memory a block, 3 blocks (12 warps) share
// an SM.  A crowd of rois on one tile would set the tail (smaller tiles on
// P5 spread one), but the phase-1 step's own rois list few a tile (on P5 3-7
// on average, at most 24), and there 4x4 tiles on P5 were 1-2% slower a
// step than 8x8 (the probe's --p5-tiles 4,8).
#include "common.cuh"
#include "roi_geometry.cuh"

// The side of a P5 tile in cells, 8 as on every level.
// tools/probe_adjoint_tiles.py builds copies with other values to compare
// them on the same rois.
#ifndef SEAM_ADJOINT_P5_TILE
#define SEAM_ADJOINT_P5_TILE 8
#endif

namespace {

// Probe points, empty in the library.  tools/probe_adjoint_tiles.py builds a
// copy with SEAM_ADJOINT_PROBE defined, in which thread 0 of each block
// records its start and end on the global timer (ns), its SM, level, rois
// listed and samples visited, and its SM cycles in each phase (barrier waits
// included): 0 the roi scan, 1 the sample tables, 2 the adds, 3 the rest
// (zeroing, the write).
#ifdef SEAM_ADJOINT_PROBE
__device__ unsigned long long* g_probe;  // [blocks][10]
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_BEGIN()                                                        \
  const unsigned long long probe_t0 = probe_now();                           \
  unsigned long long probe_listed = 0, probe_visits = 0, probe_ph[4] = {};   \
  long long probe_mark = clock64()
#define PROBE_PHASE(i)                                                       \
  do {                                                                       \
    const long long t_ = clock64();                                          \
    probe_ph[i] += t_ - probe_mark;                                          \
    probe_mark = t_;                                                         \
  } while (0)
#define PROBE_LISTED(n) (probe_listed += (n))
#define PROBE_VISIT() (++probe_visits)
#define PROBE_END(level)                                                     \
  do {                                                                       \
    __syncthreads();                                                         \
    PROBE_PHASE(3);                                                          \
    if (threadIdx.x == 0) {                                                  \
      unsigned smid;                                                         \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));                      \
      unsigned long long* r_ = g_probe + (size_t)blockIdx.x * 10;            \
      r_[0] = probe_t0;                                                      \
      r_[1] = probe_now();                                                   \
      r_[2] = smid;                                                          \
      r_[3] = (level);                                                       \
      r_[4] = probe_listed;                                                  \
      r_[5] = probe_visits;                                                  \
      for (int i_ = 0; i_ < 4; ++i_) r_[6 + i_] = probe_ph[i_];              \
    }                                                                        \
  } while (0)
#else
#define PROBE_BEGIN() do {} while (0)
#define PROBE_PHASE(i) do {} while (0)
#define PROBE_LISTED(n) do {} while (0)
#define PROBE_VISIT() do {} while (0)
#define PROBE_END(level) do {} while (0)
#endif

constexpr int CELLS = 64;          // cells of a tile, at most: 8x8
static_assert(SEAM_ADJOINT_P5_TILE >= 1 && SEAM_ADJOINT_P5_TILE <= 8 &&
                  (SEAM_ADJOINT_P5_TILE & (SEAM_ADJOINT_P5_TILE - 1)) == 0,
              "tiles are 2^k cells wide, at most 8");
constexpr int GROUP = 256;         // channels a block
constexpr int CPT = 2;             // channels a thread: c and c + GROUP / 2
constexpr int THREADS = GROUP / CPT;
constexpr int TRASH = CELLS * GROUP * 4;  // byte offset of the cell of corners that add nothing
constexpr int TABLE = 384;         // sample-table entries (both axes) of a batch of rois
constexpr int MAX_RATIO = 4;       // samples a bin along each axis
constexpr int MAX_BATCH = 64;      // rois a batch

struct LevelTiles {
  void* out[4];     // [B, H, W, C] in the output dtype
  int h[4], w[4];
  float scale[4];
  int th[4], tw[4];  // cells of a tile, rows and columns
  int tiles_x[4], tiles_y[4];
  int first[5];     // first tile of level 3, 2, 1, 0 in launch order (per channel group)
  int groups;       // channel groups of GROUP
};

// One corner pair of a sample along one axis: the byte offset in the tile's
// sums of its low and high corner's row (row x tile columns x GROUP x 4) or
// column (column x GROUP x 4), TRASH where the corner adds nothing to this
// tile (weight 0 there).  A corner's cell is at min(row + column, TRASH).
// 16 bytes, one shared-memory load.
struct __align__(16) Tap {
  float wlo, whi;
  int lo, hi;
};

// The first and last cell along one axis that a roi's samples can touch: the
// corners of the first sample at or above -1 and of the last at or below
// size.  Sample coordinates rise with the sample index, so every sample that
// contributes lies between, and its corners too.  Empty (first > last) when
// every sample lies outside [-1, size].
__device__ __forceinline__ void footprint_axis(seam::RoiAxis ax, int out_size, int ratio, int size,
                                               int& first, int& last) {
  const float c0 = seam::sample_coord(ax, 0, 0, ratio);
  const float c1 = seam::sample_coord(ax, out_size - 1, ratio - 1, ratio);
  if (c1 < -1.f || c0 > (float)size) {
    first = 0;
    last = -1;
    return;
  }
  int lo, hi;
  float wlo, whi;
  seam::bilinear_axis(fmaxf(c0, -1.f), size, lo, hi, wlo, whi);
  first = lo;
  seam::bilinear_axis(fminf(c1, (float)size), size, lo, hi, wlo, whi);
  last = hi;
}

// whether neither corner of a tap adds to this tile: valid offsets are
// below TRASH, a power of two that none of them has as a bit
__device__ __forceinline__ bool off_tile(const Tap& t) { return (t.lo & t.hi & TRASH) != 0; }

// the tile's sums by 32-bit shared-memory address
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

template <typename TOut>
__global__ void __launch_bounds__(THREADS)
roi_adjoint_kernel(const LevelTiles lt, const float* __restrict__ g,
                   const float* __restrict__ rois, int R, int C, int O, int ratio) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_acc = reinterpret_cast<float*>(smem);                       // [CELLS + 1][GROUP]
  Tap* s_tap = reinterpret_cast<Tap*>(s_acc + (CELLS + 1) * GROUP);    // [TABLE]
  __shared__ int s_list[THREADS];                // listed rois of a scan chunk
  __shared__ int s_range[MAX_BATCH][4];          // sample row and column range of each
  __shared__ int s_warp[THREADS / 32];

  // the tile: channel group fastest, then tiles in launch order (P5 first)
  int bid = blockIdx.x;
  const int grp = bid % lt.groups;
  bid /= lt.groups;
  int order = 0;
  while (bid >= lt.first[order + 1]) ++order;
  const int l = 3 - order;
  bid -= lt.first[order];
  const int per_image = lt.tiles_y[l] * lt.tiles_x[l];
  const int img = bid / per_image, tile = bid - img * per_image;
  const int th = lt.th[l], tw = lt.tw[l];
  const int y0 = (tile / lt.tiles_x[l]) * th, x0 = (tile % lt.tiles_x[l]) * tw;
  const int H = lt.h[l], W = lt.w[l];
  const float scale = lt.scale[l];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROBE_BEGIN();
  const int c0 = grp * GROUP + tid;  // this thread's channels: c0 and c0 + THREADS
  const bool act0 = c0 < C, act1 = c0 + THREADS < C;
  const int P = O * ratio;
  const int batch = min(TABLE / (2 * P), MAX_BATCH);

  float* acc = s_acc + tid;
  const unsigned acc_s = (unsigned)__cvta_generic_to_shared(acc);
  for (int i = 0; i < th * tw; ++i) {  // (the trash cell is never read out)
    acc[i * GROUP] = 0.f;
    acc[i * GROUP + THREADS] = 0.f;
  }

  const float* img_rois = rois + (size_t)img * R * 4;
  const float* img_g = g + (size_t)img * R * O * O * C + c0;
  const float count = (float)(ratio * ratio);  // samples a bin
  for (int r0 = 0; r0 < R; r0 += THREADS) {
    // 1. the rois of this chunk that map to level l and whose footprint
    // meets the tile, listed in roi order
    PROBE_PHASE(3);
    const int r = r0 + tid;
    bool meets = false;
    if (r < R) {
      const float* roi = img_rois + r * 4;
      if (seam::roi_level(roi[0], roi[1], roi[2], roi[3]) == l) {
        int fy0, fy1, fx0, fx1;
        footprint_axis(seam::roi_axis(roi[1], roi[3], scale, O), O, ratio, H, fy0, fy1);
        footprint_axis(seam::roi_axis(roi[0], roi[2], scale, O), O, ratio, W, fx0, fx1);
        meets = fy0 <= fy1 && fx0 <= fx1 && fy0 < y0 + th && fy1 >= y0 && fx0 < x0 + tw &&
                fx1 >= x0;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, listed = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      listed += s_warp[w];
    }
    PROBE_LISTED(listed);
    if (meets) s_list[before + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();
    PROBE_PHASE(0);

    // 2. the listed rois in batches whose sample tables fit
    for (int j0 = 0; j0 < listed; j0 += batch) {
      const int m = min(batch, listed - j0);
      PROBE_PHASE(0);
      if (tid < m) {
        s_range[tid][0] = P;
        s_range[tid][1] = -1;
        s_range[tid][2] = P;
        s_range[tid][3] = -1;
      }
      __syncthreads();
      for (int e = tid; e < m * 2 * P; e += THREADS) {
        const int j = e / (2 * P), k = e - j * 2 * P;
        const int axis = k / P, s = k - axis * P;  // axis 0: rows (y), 1: columns (x)
        const float* roi = img_rois + s_list[j0 + j] * 4;
        const seam::RoiAxis ax = axis == 0 ? seam::roi_axis(roi[1], roi[3], scale, O)
                                           : seam::roi_axis(roi[0], roi[2], scale, O);
        const float coord = seam::sample_coord(ax, s / ratio, s % ratio, ratio);
        const int size = axis == 0 ? H : W;
        const int origin = axis == 0 ? y0 : x0, extent = axis == 0 ? th : tw;
        const int stride = (axis == 0 ? tw * GROUP : GROUP) * 4;
        Tap tap = {0.f, 0.f, TRASH, TRASH};
        if (seam::sample_inside(coord, size)) {
          int lo, hi;
          float wlo, whi;
          seam::bilinear_axis(coord, size, lo, hi, wlo, whi);
          lo -= origin;
          hi -= origin;
          if (wlo != 0.f && lo >= 0 && lo < extent) {
            tap.lo = lo * stride;
            tap.wlo = wlo;
          }
          if (whi != 0.f && hi >= 0 && hi < extent) {
            tap.hi = hi * stride;
            tap.whi = whi;
          }
        }
        s_tap[e] = tap;
        if (!off_tile(tap)) {  // min and max: the same in any order
          atomicMin(&s_range[j][2 * axis], s);
          atomicMax(&s_range[j][2 * axis + 1], s);
        }
      }
      __syncthreads();
      PROBE_PHASE(1);

      // 3. each thread adds into its own two channels of the tile: per
      // sample, the 4 corners (distinct cells, or the trash cell with
      // weight 0) loaded, added and stored together; the cotangent of the
      // next bin is loaded while this one's samples are added
      for (int j = 0; j < m; ++j) {
        const int sy0 = s_range[j][0], sy1 = s_range[j][1];
        const int sx0 = s_range[j][2], sx1 = s_range[j][3];
        if (sy1 < 0 || sx1 < 0) continue;  // the footprint met the tile, no sample does
        const Tap* ty = s_tap + j * 2 * P;
        const Tap* tx = ty + P;
        const float* gr = img_g + (size_t)s_list[j0 + j] * O * O * C;
        const int ph0 = sy0 / ratio, ph1 = sy1 / ratio, pw0 = sx0 / ratio, pw1 = sx1 / ratio;
        const float* gp = gr + (size_t)(ph0 * O + pw0) * C;
        float g0 = act0 ? gp[0] : 0.f, g1 = act1 ? gp[THREADS] : 0.f;
        for (int ph = ph0; ph <= ph1; ++ph) {
          for (int pw = pw0; pw <= pw1; ++pw) {
            const float gs0 = g0 / count, gs1 = g1 / count;
            const bool row_end = pw == pw1;
            if (!row_end || ph < ph1) {
              gp = gr + (size_t)((row_end ? ph + 1 : ph) * O + (row_end ? pw0 : pw + 1)) * C;
              g0 = act0 ? gp[0] : 0.f;
              g1 = act1 ? gp[THREADS] : 0.f;
            }
            // the bin's taps, loaded together
            Tap ys[MAX_RATIO], xs[MAX_RATIO];
#pragma unroll
            for (int i = 0; i < MAX_RATIO; ++i) {
              if (i < ratio) {
                ys[i] = ty[ph * ratio + i];
                xs[i] = tx[pw * ratio + i];
              }
            }
#pragma unroll
            for (int iy = 0; iy < MAX_RATIO; ++iy) {
              if (iy >= ratio || off_tile(ys[iy])) continue;
              const Tap& Y = ys[iy];
#pragma unroll
              for (int ix = 0; ix < MAX_RATIO; ++ix) {
                if (ix >= ratio || off_tile(xs[ix])) continue;
                PROBE_VISIT();
                const Tap& X = xs[ix];
                const unsigned cell[4] = {
                    acc_s + min(Y.lo + X.lo, TRASH), acc_s + min(Y.lo + X.hi, TRASH),
                    acc_s + min(Y.hi + X.lo, TRASH), acc_s + min(Y.hi + X.hi, TRASH)};
                const float w[4] = {Y.wlo * X.wlo, Y.wlo * X.whi, Y.whi * X.wlo, Y.whi * X.whi};
                float v[2][4];
#pragma unroll
                for (int k4 = 0; k4 < 4; ++k4) {
                  v[0][k4] = lds(cell[k4]);
                  v[1][k4] = lds(cell[k4] + THREADS * 4);
                }
#pragma unroll
                for (int k4 = 0; k4 < 4; ++k4) {
                  v[0][k4] += gs0 * w[k4];
                  v[1][k4] += gs1 * w[k4];
                }
#pragma unroll
                for (int k4 = 0; k4 < 4; ++k4) {
                  sts(cell[k4], v[0][k4]);
                  sts(cell[k4] + THREADS * 4, v[1][k4]);
                }
              }
            }
          }
        }
      }
      __syncthreads();  // before the next batch's tables, and the write
      PROBE_PHASE(2);
    }
  }
  __syncthreads();

  // 4. the tile, once, in the output dtype (zeros where no roi reached):
  // 16 bytes of a cell's channels a store
  constexpr int VEC = seam::Vec<TOut>::N;
  TOut* out = static_cast<TOut*>(lt.out[l]) + (size_t)img * H * W * C;
  const int tw_shift = __ffs(tw) - 1;  // tiles are 2^k cells wide
  for (int i = tid; i < th * tw * GROUP / VEC; i += THREADS) {
    const int cell = i / (GROUP / VEC), ch = (i % (GROUP / VEC)) * VEC;
    const int y = y0 + (cell >> tw_shift), x = x0 + (cell & (tw - 1));
    if (y < H && x < W && grp * GROUP + ch < C)
      seam::Vec<TOut>::store(out + ((size_t)y * W + x) * C + grp * GROUP + ch,
                       s_acc + cell * GROUP + ch);
  }
  PROBE_END(l);
}

constexpr size_t SMEM = (size_t)(CELLS + 1) * GROUP * sizeof(float) + TABLE * sizeof(Tap);

template <typename TOut>
cudaError_t launch(const LevelTiles& lt, unsigned blocks, const float* grad, const float* rois,
                   int R, int C, int O, int ratio, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_adjoint_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  roi_adjoint_kernel<TOut><<<blocks, THREADS, SMEM, stream>>>(lt, grad, rois, R, C, O, ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" int seam_roi_align_adjoint(
    void* g0, void* g1, void* g2, void* g3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    float s0, float s1, float s2, float s3,
    const void* grad, const void* rois, int N, int R, int C, int O, int ratio, int out_bf16,
    void* stream) {
  LevelTiles lt = {{g0, g1, g2, g3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}};
  const int B = N / R;
  lt.first[0] = 0;
  for (int order = 0; order < 4; ++order) {
    const int l = 3 - order;
    lt.th[l] = lt.tw[l] = l == 3 ? SEAM_ADJOINT_P5_TILE : 8;
    lt.tiles_y[l] = (lt.h[l] + lt.th[l] - 1) / lt.th[l];
    lt.tiles_x[l] = (lt.w[l] + lt.tw[l] - 1) / lt.tw[l];
    lt.first[order + 1] = lt.first[order] + B * lt.tiles_y[l] * lt.tiles_x[l];
  }
  lt.groups = (C + GROUP - 1) / GROUP;
  const unsigned blocks = (unsigned)lt.first[4] * (unsigned)lt.groups;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* gp = (const float*)grad;
  const float* rp = (const float*)rois;
  return (int)(out_bf16 ? launch<__nv_bfloat16>(lt, blocks, gp, rp, R, C, O, ratio, s)
                        : launch<float>(lt, blocks, gp, rp, R, C, O, ratio, s));
}

#ifdef SEAM_ADJOINT_PROBE
extern "C" int seam_probe_records(void* p) {
  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));
}
#endif
