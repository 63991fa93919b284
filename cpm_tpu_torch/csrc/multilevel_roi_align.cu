// Multilevel FPN RoIAlign for Hopper (sm_90a): forward and backward.
//
// The forward replaces the TPU kernel cpm_tpu/ops/pallas/multilevel_pallas.py
// ::multilevel_roi_align_pallas (_fwd/_fwd_kernel_body); the backward, further
// down, replaces its custom_vjp backward (_bwd/_bwd_kernel_body). Both take
// their sample coordinates from the same device functions (roi_geometry,
// sample_coord, bilinear_1d), so the backward adds into exactly the cells the
// forward read, with the same weights (roi_align_common.cuh, shared with the
// port's other RoIAlign kernels). The forward computes
// exactly what the gather formulation cpm_tpu/ops/roi_align.py::
// multilevel_roi_align computes: each roi reads the FPN level it was
// assigned, takes `sampling_ratio` x `sampling_ratio` bilinear samples per
// output bin (the reference CUDA out-of-bounds rule: a sample with
// y < -1 or y > H (x likewise) reads zero; otherwise its coordinate is
// clamped into [0, H-1]), and averages them. Rois whose `valid` flag is
// false write zeros and read nothing.
//
// What bounds it on the H100: bytes, not FLOPs. Every sample reads four
// C-vectors (4 x 512 B at C=256 in bf16) and does one multiply-add per
// element read, so the kernel is a gather whose traffic mostly hits L1/L2
// (neighbouring samples of a roi share source cells). The design keeps
// those gathers wide and coalesced: one CTA per roi (and C tile), threads
// along C, each thread loading 16 contiguous bytes of a cell with a
// read-only load, so a warp reads whole 512-byte cell rows. Threads along
// the block's y dimension split the output bins. Accumulation is in f32;
// the result is written once in the feature dtype. The TPU kernel's 64-cell
// window, prefetch ring and hat-weight matmuls have no counterpart: the
// kernel reads cells directly and is exact for every roi shape.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/multilevel_roi_align.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

struct LevelTable {
  const void* ptr[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

// Where a roi lies on its level: the level's size and the roi's box there.
struct RoiGeometry {
  int level;
  int batch;
  int height;
  int width;
  float x1;
  float y1;
  float bin_w;
  float bin_h;
};

// The level id is clamped like the batch id (roi_box): a malformed roi
// cannot touch memory outside the maps.
__device__ __forceinline__ RoiGeometry roi_geometry(
    const LevelTable& levels, int num_levels, int batch,
    const float* __restrict__ rois, const int32_t* __restrict__ roi_levels,
    int r, int pooled_h, int pooled_w, int aligned) {
  RoiGeometry g;
  g.level = min(max(roi_levels[r], 0), num_levels - 1);
  g.height = levels.height[g.level];
  g.width = levels.width[g.level];
  const RoiBox box = roi_box(rois + static_cast<size_t>(r) * 5,
                             levels.scale[g.level], batch, pooled_h, pooled_w,
                             aligned);
  g.batch = box.batch;
  g.x1 = box.x1;
  g.y1 = box.y1;
  g.bin_w = box.bin_w;
  g.bin_h = box.bin_h;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    multilevel_roi_align_fwd_kernel(LevelTable levels, int num_levels,
                                    int batch, int channels,
                                    const float* __restrict__ rois,
                                    const int32_t* __restrict__ roi_levels,
                                    const uint8_t* __restrict__ valid,
                                    int pooled_h, int pooled_w, int sr,
                                    int aligned, T* __restrict__ out) {
  constexpr int kN = VecWidth<T>::kN;
  const int r = blockIdx.x;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kN;
  if (c0 >= channels) return;
  const int bins = pooled_h * pooled_w;
  T* out_roi = out + static_cast<size_t>(r) * bins * channels + c0;

  if (!valid[r]) {
    const float zeros[kN] = {};
    for (int bin = threadIdx.y; bin < bins; bin += blockDim.y) {
      store(out_roi + static_cast<size_t>(bin) * channels, zeros);
    }
    return;
  }

  const RoiGeometry geo =
      roi_geometry(levels, num_levels, batch, rois, roi_levels, r, pooled_h,
                   pooled_w, aligned);
  const int H = geo.height;
  const int W = geo.width;
  const float count = static_cast<float>(sr * sr);

  const T* feat = static_cast<const T*>(levels.ptr[geo.level]) +
                  static_cast<size_t>(geo.batch) * H * W * channels + c0;

  for (int bin = threadIdx.y; bin < bins; bin += blockDim.y) {
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    float acc[kN] = {};
    for (int iy = 0; iy < sr; ++iy) {
      int y_lo, y_hi;
      float wy_lo, wy_hi;
      const float y = sample_coord(geo.y1, py * sr + iy, sr, geo.bin_h);
      if (!bilinear_1d(y, H, &y_lo, &y_hi, &wy_lo, &wy_hi)) continue;
      const T* row_lo = feat + static_cast<size_t>(y_lo) * W * channels;
      const T* row_hi = feat + static_cast<size_t>(y_hi) * W * channels;
      for (int ix = 0; ix < sr; ++ix) {
        int x_lo, x_hi;
        float wx_lo, wx_hi;
        const float x = sample_coord(geo.x1, px * sr + ix, sr, geo.bin_w);
        if (!bilinear_1d(x, W, &x_lo, &x_hi, &wx_lo, &wx_hi)) continue;
        accumulate(row_lo + static_cast<size_t>(x_lo) * channels,
                   cell_weight(wy_lo, wx_lo), acc);
        accumulate(row_lo + static_cast<size_t>(x_hi) * channels,
                   cell_weight(wy_lo, wx_hi), acc);
        accumulate(row_hi + static_cast<size_t>(x_lo) * channels,
                   cell_weight(wy_hi, wx_lo), acc);
        accumulate(row_hi + static_cast<size_t>(x_hi) * channels,
                   cell_weight(wy_hi, wx_hi), acc);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] /= count;
    store(out_roi + static_cast<size_t>(bin) * channels, acc);
  }
}

template <typename T>
cudaError_t launch(const LevelTable& table, int num_levels, int batch,
                   int channels, const float* rois, const int32_t* roi_levels,
                   const uint8_t* valid, int num_rois, int pooled_h,
                   int pooled_w, int sr, int aligned, T* out,
                   cudaStream_t stream) {
  dim3 grid, block;
  roi_launch_shape<T>(channels, num_rois, &grid, &block);
  multilevel_roi_align_fwd_kernel<T><<<grid, block, 0, stream>>>(
      table, num_levels, batch, channels, rois, roi_levels, valid, pooled_h,
      pooled_w, sr, aligned, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: the exact transpose of the forward, as a gather owned by tiles of
// the level maps. For each valid roi, bin and sample, g[r, bin, :] / sr^2
// times each of the four bilinear weights belongs to the cell the forward
// read with that weight. Masked rois add nothing; rois and level ids get no
// gradient.
//
// What bounds it on the H100 is bytes: the level maps' gradients written
// once (in g's dtype) and the valid rois' rows of g read. One block owns one
// (level, image, tile of kTileH x kTileW cells, kChunk channels) of the
// gradient maps. It stages the rois' boxes in shared memory, kThreads at a
// time, keeps those of its level and image whose sample footprint (the
// cells that bilinear_1d can return for the first and the last sample
// coordinate along each axis) meets the tile, and for each of them, in roi
// order, adds the samples' shares that fall into the tile into a float32
// tile in shared memory, loading each bin's row of g once for all of its
// samples there (up to kBatch bins' loads in flight per warp); then it
// writes the tile once, in g's dtype, straight
// into the per-level gradient maps. Tiles that no roi reaches write zeros.
// Warp r owns the tile's row r and each lane eight channels, so no two threads
// ever add into one element and every cell's sum runs in one fixed order
// (roi, then sample): two runs give the same bits. The scatter this replaces
// sent four C-vectors of float4 atomics to L2 for every sample into a
// zero-filled float32 buffer of all four levels (182.8 MB at batch 2,
// 800x1344, C=256), filled and cast by its wrapper: 22x the bound, about half
// of it the fill and the cast. The TPU kernel's window slabs, hat-weight
// matmuls and read-modify-write DMAs existed because its grid runs in order
// on one core; none carries over.

constexpr int kTileH = kThreads / 32;  // one tile row per warp
constexpr int kTileW = 8;
constexpr int kChunk = 256;            // eight channels per lane
constexpr int kBatch = 8;              // bins' loads of g in flight per warp
// the tile's float32 sums, in dynamic shared memory
constexpr int kTileBytes = kTileH * kTileW * kCellVecs * 16;

// The backward's blocks along grid x: level l owns [first[l], first[l+1]),
// batch x tiles[l] of them, tiles_x[l] tiles to a row of its map.
struct TileGrid {
  int tiles_x[kMaxLevels];
  int tiles[kMaxLevels];
  int first[kMaxLevels + 1];
};

// The cells along one axis of `size` that the samples between coordinates
// a and b (the first and the last, in either order) can reach after the
// out-of-bounds rule and the clamp of bilinear_1d: [*lo, *hi]. False when
// every sample is out of bounds. A coordinate that is not finite reaches
// the whole axis.
__device__ __forceinline__ bool footprint(float a, float b, int size, int* lo,
                                          int* hi) {
  if (!(isfinite(a) && isfinite(b))) {
    *lo = 0;
    *hi = size - 1;
    return true;
  }
  const float least = fminf(a, b);
  const float most = fmaxf(a, b);
  if (most < -1.0f || least > static_cast<float>(size)) return false;
  const float top = static_cast<float>(size) - 1.0f;
  *lo = static_cast<int>(floorf(fminf(fmaxf(least, 0.0f), top)));
  *hi = min(static_cast<int>(floorf(fminf(fmaxf(most, 0.0f), top))) + 1,
            size - 1);
  return true;
}

// The lanes l of a warp whose sample index base + l falls in bin p, with sr
// samples to a bin.
__device__ __forceinline__ unsigned lanes_of_bin(int p, int sr, int base) {
  const int lo = max(p * sr - base, 0);
  const int hi = min(p * sr + sr - base, 32);
  const unsigned span = hi - lo >= 32 ? 0xffffffffu : (1u << (hi - lo)) - 1u;
  return span << lo;
}

// Adds roi r's shares of map row `y` in columns [x0, x0 + kTileW) into the
// warp's tile row. Lanes compute the sample rows and columns 32 at a time;
// the bins whose samples reach the row and the tile are taken in order, and
// each bin's row of g is loaded once for all of its samples there (up to
// kBatch bins' loads in flight). A bin row's sample rows that reach the map
// row have their weights there summed first, so that each of its sample
// columns adds once into each of its two cells.
template <typename T>
__device__ __forceinline__ void add_roi_to_row(
    float4* acc_row, const RoiGeometry& geo, const T* g_roi, int channels,
    int y, int x0, int pooled_w, int sr, int rows, int cols, float inv_count,
    bool has_c, bool full, int lane) {
  for (int mb = 0; mb < cols; mb += 32) {
    const int m = mb + lane;
    int x_lo = 0, x_hi = 0;
    float wx_lo = 0.0f, wx_hi = 0.0f;
    bool in_lo = false, in_hi = false;
    if (m < cols &&
        bilinear_1d(sample_coord(geo.x1, m, sr, geo.bin_w), geo.width, &x_lo,
                    &x_hi, &wx_lo, &wx_hi)) {
      x_lo -= x0;
      x_hi -= x0;
      in_lo = x_lo >= 0 && x_lo < kTileW;
      in_hi = x_hi >= 0 && x_hi < kTileW;
    }
    const unsigned col_hits = __ballot_sync(0xffffffffu, in_lo || in_hi);
    if (col_hits == 0u) continue;
    for (int kb = 0; kb < rows; kb += 32) {
      const int k = kb + lane;
      int y_lo = 0, y_hi = 0;
      float wy_lo = 0.0f, wy_hi = 0.0f;
      bool on_lo = false, on_hi = false;
      if (k < rows &&
          bilinear_1d(sample_coord(geo.y1, k, sr, geo.bin_h), geo.height,
                      &y_lo, &y_hi, &wy_lo, &wy_hi)) {
        on_lo = y_lo == y;
        on_hi = y_hi == y;
      }
      unsigned row_hits = __ballot_sync(0xffffffffu, on_lo || on_hi);
      while (row_hits != 0u) {
        // the sample rows of one bin row that reach the map row
        const int py = (kb + __ffs(row_hits) - 1) / sr;
        const unsigned bin_rows = row_hits & lanes_of_bin(py, sr, kb);
        row_hits &= ~bin_rows;
        // their weights on the map row, summed: every sample column of the
        // bin row adds once into each of its two cells
        float wy = 0.0f;
        for (unsigned rr = bin_rows; rr != 0u; rr &= rr - 1u) {
          const int ks = __ffs(rr) - 1;
          const float w_lo = __shfl_sync(0xffffffffu, on_lo ? wy_lo : 0.0f, ks);
          const float w_hi = __shfl_sync(0xffffffffu, on_hi ? wy_hi : 0.0f, ks);
          wy += w_lo + w_hi;
        }
        unsigned hits = col_hits;
        while (hits != 0u) {
          // up to kBatch bins at once, their loads of g in flight
          unsigned bin_cols[kBatch];
          float v[kBatch][8];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            bin_cols[q] = 0u;
            if (hits != 0u) {
              const int px = (mb + __ffs(hits) - 1) / sr;
              bin_cols[q] = hits & lanes_of_bin(px, sr, mb);
              hits &= ~bin_cols[q];
              if (has_c) {
                load8(g_roi + static_cast<size_t>(py * pooled_w + px) * channels,
                      full, v[q]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            if (bin_cols[q] == 0u) break;  // the masks are the warp's own
            if (has_c) {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[q][e] *= inv_count;
            }
            for (unsigned cc = bin_cols[q]; cc != 0u; cc &= cc - 1u) {
              // every lane takes part in the shuffles
              const int ms = __ffs(cc) - 1;
              const bool b_lo = __shfl_sync(0xffffffffu, static_cast<int>(in_lo), ms) != 0;
              const bool b_hi = __shfl_sync(0xffffffffu, static_cast<int>(in_hi), ms) != 0;
              const int c_lo = __shfl_sync(0xffffffffu, x_lo, ms);
              const int c_hi = __shfl_sync(0xffffffffu, x_hi, ms);
              const float b_wlo = __shfl_sync(0xffffffffu, wx_lo, ms);
              const float b_whi = __shfl_sync(0xffffffffu, wx_hi, ms);
              if (!has_c) continue;
              if (b_lo) add8(acc_row + c_lo * kCellVecs, lane, cell_weight(wy, b_wlo), v[q]);
              if (b_hi) add8(acc_row + c_hi * kCellVecs, lane, cell_weight(wy, b_whi), v[q]);
            }
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    multilevel_roi_align_bwd_kernel(LevelTable grads, TileGrid tiles,
                                    int num_levels, int batch, int channels,
                                    const float* __restrict__ rois,
                                    const int32_t* __restrict__ roi_levels,
                                    const uint8_t* __restrict__ valid,
                                    int num_rois, int pooled_h, int pooled_w,
                                    int sr, int aligned,
                                    const T* __restrict__ g) {
  extern __shared__ float4 acc[];  // [kTileH][kTileW][kCellVecs]
  // the staged rois of one round: where they lie and the map rows they reach
  // (an empty range for a roi that misses the tile)
  __shared__ RoiGeometry st_geo[kThreads];
  __shared__ int st_row0[kThreads];
  __shared__ int st_row1[kThreads];

  int level = 0;
  while (level + 1 < num_levels &&
         static_cast<int>(blockIdx.x) >= tiles.first[level + 1]) {
    ++level;
  }
  const int local = blockIdx.x - tiles.first[level];
  const int image = local / tiles.tiles[level];
  const int tile = local - image * tiles.tiles[level];
  const int ty = tile / tiles.tiles_x[level];
  const int tx = tile - ty * tiles.tiles_x[level];
  const int H = grads.height[level];
  const int W = grads.width[level];
  const int y0 = ty * kTileH;
  const int x0 = tx * kTileW;
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int y = y0 + row;
  const int c0 = blockIdx.y * kChunk + 8 * lane;
  const bool has_c = c0 < channels;
  const bool full = c0 + 4 < channels;
  const int rows = pooled_h * sr;
  const int cols = pooled_w * sr;
  const int bins = pooled_h * pooled_w;
  const float inv_count = 1.0f / static_cast<float>(sr * sr);
  float4* acc_row = acc + row * kTileW * kCellVecs;
  for (int v = lane; v < kTileW * kCellVecs; v += 32) {
    acc_row[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int base = 0; base < num_rois; base += kThreads) {
    __syncthreads();  // the last round's rois are read
    const int r = base + static_cast<int>(threadIdx.x);
    int row0 = 1, row1 = 0;
    if (r < num_rois && valid[r]) {
      const RoiGeometry geo =
          roi_geometry(grads, num_levels, batch, rois, roi_levels, r, pooled_h,
                       pooled_w, aligned);
      int r0, r1, col0, col1;
      if (geo.level == level && geo.batch == image &&
          footprint(sample_coord(geo.y1, 0, sr, geo.bin_h),
                    sample_coord(geo.y1, rows - 1, sr, geo.bin_h), H, &r0,
                    &r1) &&
          footprint(sample_coord(geo.x1, 0, sr, geo.bin_w),
                    sample_coord(geo.x1, cols - 1, sr, geo.bin_w), W, &col0,
                    &col1) &&
          r0 < y0 + kTileH && r1 >= y0 && col0 < x0 + kTileW && col1 >= x0) {
        row0 = r0;
        row1 = r1;
        st_geo[threadIdx.x] = geo;
      }
    }
    st_row0[threadIdx.x] = row0;
    st_row1[threadIdx.x] = row1;
    __syncthreads();
    const int count = min(num_rois - base, kThreads);
    for (int k0 = 0; k0 < count; k0 += 32) {
      const int k = k0 + lane;
      const bool hit = k < count && st_row0[k] <= y && y <= st_row1[k];
      unsigned hits = __ballot_sync(0xffffffffu, hit);
      while (hits != 0u) {
        const int kk = k0 + __ffs(hits) - 1;
        hits &= hits - 1u;
        add_roi_to_row(acc_row, st_geo[kk],
                       g + static_cast<size_t>(base + kk) * bins * channels + c0,
                       channels, y, x0, pooled_w, sr, rows, cols, inv_count,
                       has_c, full, lane);
      }
    }
  }
  // the warp wrote its row alone: it stores it without waiting for the rest
  if (y >= H || !has_c) return;
  // ptr is declared const for the forward's sake
  T* dst = static_cast<T*>(const_cast<void*>(grads.ptr[level])) +
           ((static_cast<size_t>(image) * H + y) * W + x0) * channels + c0;
  const int n = min(kTileW, W - x0);
  for (int col = 0; col < n; ++col) {
    float v[8];
    read8(acc_row + col * kCellVecs, lane, v);
    store8(dst + static_cast<size_t>(col) * channels, full, v);
  }
}

template <typename T>
cudaError_t launch_bwd(const LevelTable& table, int num_levels, int batch,
                       int channels, const float* rois,
                       const int32_t* roi_levels, const uint8_t* valid,
                       int num_rois, int pooled_h, int pooled_w, int sr,
                       int aligned, const T* g, cudaStream_t stream) {
  TileGrid tiles = {};
  long long blocks = 0;
  for (int l = 0; l < num_levels; ++l) {
    tiles.tiles_x[l] = (table.width[l] + kTileW - 1) / kTileW;
    tiles.tiles[l] = (table.height[l] + kTileH - 1) / kTileH * tiles.tiles_x[l];
    tiles.first[l] = static_cast<int>(blocks);
    blocks += static_cast<long long>(batch) * tiles.tiles[l];
  }
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  for (int l = num_levels; l <= kMaxLevels; ++l) {
    tiles.first[l] = static_cast<int>(blocks);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  (channels + kChunk - 1) / kChunk);
  if (kTileBytes > 48 * 1024) {
    cudaFuncSetAttribute(multilevel_roi_align_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kTileBytes);
  }
  multilevel_roi_align_bwd_kernel<T><<<grid, kThreads, kTileBytes, stream>>>(
      table, tiles, num_levels, batch, channels, rois, roi_levels, valid,
      num_rois, pooled_h, pooled_w, sr, aligned, g);
  return cudaGetLastError();
}

LevelTable make_table(const void* level_ptrs, const void* level_hw,
                      const void* level_scales, int num_levels) {
  LevelTable table = {};
  const void* const* ptrs = static_cast<const void* const*>(level_ptrs);
  const int* hw = static_cast<const int*>(level_hw);
  const float* scales = static_cast<const float*>(level_scales);
  for (int l = 0; l < num_levels; ++l) {
    table.ptr[l] = ptrs[l];
    table.height[l] = hw[2 * l];
    table.width[l] = hw[2 * l + 1];
    table.scale[l] = scales[l];
  }
  return table;
}

bool bad_arguments(int num_levels, int num_rois, int channels,
                   int sampling_ratio, int dtype) {
  return num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
         channels < 1 || sampling_ratio < 1 || dtype < 0 || dtype > 1;
}

}  // namespace

// level_ptrs, level_hw ([h0, w0, h1, w1, ...]) and level_scales are host
// arrays of num_levels entries; every other pointer is device memory.
// Levels are [batch, H_l, W_l, channels] contiguous, rois [num_rois, 5] f32
// (batch index, x1, y1, x2, y2), roi_levels [num_rois] int32 in
// [0, num_levels), valid [num_rois] bytes (0 or 1), out
// [num_rois, pooled_h, pooled_w, channels] in the feature dtype.
// dtype: 0 = float32, 1 = bfloat16. channels must be a multiple of 16 bytes'
// worth of elements and every pointer 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int cpm_multilevel_roi_align_fwd(
    const void* level_ptrs, const void* level_hw, const void* level_scales,
    int num_levels, int batch, int channels, const void* rois,
    const void* roi_levels, const void* valid, int num_rois, int pooled_h,
    int pooled_w, int sampling_ratio, int aligned, int dtype, void* out,
    void* stream) {
  if (bad_arguments(num_levels, num_rois, channels, sampling_ratio, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LevelTable table =
      make_table(level_ptrs, level_hw, level_scales, num_levels);
  const float* r = static_cast<const float*>(rois);
  const int32_t* lv = static_cast<const int32_t*>(roi_levels);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(table, num_levels, batch, channels, r, lv, v,
                        num_rois, pooled_h, pooled_w, sampling_ratio, aligned,
                        static_cast<float*>(out), s);
  } else {
    err = launch<__nv_bfloat16>(table, num_levels, batch, channels, r, lv, v,
                                num_rois, pooled_h, pooled_w, sampling_ratio,
                                aligned, static_cast<__nv_bfloat16*>(out), s);
  }
  return static_cast<int>(err);
}

// The backward. grad_ptrs are the per-level gradient maps
// [batch, H_l, W_l, channels] of `dtype`, which the kernel writes whole (no
// fill needed); g is the gradient of the forward's output,
// [num_rois, pooled_h, pooled_w, channels] contiguous, of `dtype`
// (0 = float32, 1 = bfloat16). Everything else is as in the forward.
// channels must be a multiple of 16 bytes' worth of g's elements and every
// pointer 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int cpm_multilevel_roi_align_bwd(
    const void* grad_ptrs, const void* level_hw, const void* level_scales,
    int num_levels, int batch, int channels, const void* rois,
    const void* roi_levels, const void* valid, int num_rois, int pooled_h,
    int pooled_w, int sampling_ratio, int aligned, int dtype, const void* g,
    void* stream) {
  if (bad_arguments(num_levels, num_rois, channels, sampling_ratio, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LevelTable table =
      make_table(grad_ptrs, level_hw, level_scales, num_levels);
  const float* r = static_cast<const float*>(rois);
  const int32_t* lv = static_cast<const int32_t*>(roi_levels);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_bwd<float>(table, num_levels, batch, channels, r, lv, v,
                            num_rois, pooled_h, pooled_w, sampling_ratio,
                            aligned, static_cast<const float*>(g), s);
  } else {
    err = launch_bwd<__nv_bfloat16>(
        table, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned,
        static_cast<const __nv_bfloat16*>(g), s);
  }
  return static_cast<int>(err);
}
