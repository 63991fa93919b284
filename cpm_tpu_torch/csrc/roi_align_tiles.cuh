// The tile-owned RoIAlign backward shared by the multilevel backward
// (multilevel_roi_align.cu, one map per level) and the stacked backward
// (stacked_roi_align.cu, all levels in one buffer): the exact transpose of
// the forward, as a gather owned by tiles of the level maps. For each valid
// roi, bin and sample, g[r, bin, :] / sr^2 times each of the four bilinear
// weights belongs to the cell the forward read with that weight. Masked rois
// add nothing; rois and level ids get no gradient.
//
// What bounds it on the H100 is bytes: the level maps' gradients written
// once (in g's dtype) and the valid rois' rows of g read. One block owns one
// (level, image, tile of kTileH x kTileW cells, kChunk channels) of the
// gradient maps. It stages the rois' boxes in shared memory, kThreads at a
// time, keeps those of its level and image whose sample footprint (the
// cells that bilinear_1d can return for the first and the last sample
// coordinate along each axis; its plain version is
// cpm_tpu_torch/ops/roi_align.py::roi_tile_reach) meets the tile, and for
// each of them, in roi order, adds the samples' shares that fall into the
// tile into a float32 tile in shared memory, loading each bin's row of g
// once for all of its samples there (up to kBatch bins' loads in flight per
// warp); then it writes the tile once, in g's dtype, straight into the
// gradient maps. Tiles that no roi reaches write zeros; cells outside every
// level (the stacked buffer's padding) are neither read nor written. Warp r
// owns the tile's row r and each lane eight channels, so no two threads ever
// add into one element and every cell's sum runs in one fixed order (roi,
// then sample): two runs give the same bits, and the two kernels, whose
// tiles, roi order and rounding are the same, give the same bits as each
// other. The TPU kernels' window slabs, hat-weight matmuls and
// read-modify-write DMAs existed because their grid runs in order on one
// core; none carries over.
//
// The maps are reached through a table type with height(l), width(l),
// scale(l) and row<T>(l, image, y, channels), the address of cell (y, 0) of
// level l in `image` (LevelTable in roi_align_forward.cuh, StackMaps in
// stacked_roi_align.cu): that is all the two kernels differ in.

#pragma once

#include "roi_align_common.cuh"

namespace cpm {

constexpr int kTileH = kThreads / 32;  // one tile row per warp
constexpr int kTileW = 8;
constexpr int kChunk = 256;            // eight channels per lane
constexpr int kBatch = 8;              // bins' loads of g in flight per warp
// the tile's float32 sums, in dynamic shared memory
constexpr int kTileBytes = kTileH * kTileW * kCellVecs * 16;

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

// The roi's geometry on `level` of the maps.
template <typename Table>
__device__ __forceinline__ RoiGeometry roi_geometry_at(
    const Table& levels, int level, int batch, const float* __restrict__ rois,
    int r, int pooled_h, int pooled_w, int aligned) {
  RoiGeometry g;
  g.level = level;
  g.height = levels.height(level);
  g.width = levels.width(level);
  const RoiBox box = roi_box(rois + static_cast<size_t>(r) * 5,
                             levels.scale(level), batch, pooled_h, pooled_w,
                             aligned);
  g.batch = box.batch;
  g.x1 = box.x1;
  g.y1 = box.y1;
  g.bin_w = box.bin_w;
  g.bin_h = box.bin_h;
  return g;
}

// The level id is clamped like the batch id (roi_box): a malformed roi
// cannot touch memory outside the maps.
__device__ __forceinline__ int roi_level(const int32_t* __restrict__ roi_levels,
                                         int r, int num_levels) {
  return min(max(roi_levels[r], 0), num_levels - 1);
}

template <typename Table>
__device__ __forceinline__ RoiGeometry roi_geometry(
    const Table& levels, int num_levels, int batch,
    const float* __restrict__ rois, const int32_t* __restrict__ roi_levels,
    int r, int pooled_h, int pooled_w, int aligned) {
  return roi_geometry_at(levels, roi_level(roi_levels, r, num_levels), batch,
                         rois, r, pooled_h, pooled_w, aligned);
}

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

template <typename T, typename Table>
__global__ void __launch_bounds__(kThreads)
    roi_tile_backward_kernel(Table grads, TileGrid tiles, int num_levels,
                             int batch, int channels,
                             const float* __restrict__ rois,
                             const int32_t* __restrict__ roi_levels,
                             const uint8_t* __restrict__ valid, int num_rois,
                             int pooled_h, int pooled_w, int sr, int aligned,
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
  const int H = grads.height(level);
  const int W = grads.width(level);
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
  T* dst = grads.template row<T>(level, image, y, channels) +
           static_cast<size_t>(x0) * channels + c0;
  const int n = min(kTileW, W - x0);
  for (int col = 0; col < n; ++col) {
    float v[8];
    read8(acc_row + col * kCellVecs, lane, v);
    store8(dst + static_cast<size_t>(col) * channels, full, v);
  }
}

// Which devices each dtype's backward kernel is opted in on, for this
// library alone: `static` at namespace scope has internal linkage. A static
// inside the launch template below would be one object across every library
// loaded into the process (a unique symbol, even under RTLD_LOCAL), so a
// second library built from another version of this header, loaded beside
// it to compare the two, would skip its own opt-in and its launch would be
// refused. A library includes this header for one table type.
static int tile_backward_opted[2][kMaxDevices] = {};

// One launch of the backward over every tile of every level's map, on
// `stream`. Returns the cudaError_t of the launch.
template <typename T, typename Table>
cudaError_t launch_roi_tile_backward(const Table& table, int num_levels,
                                     int batch, int channels, const float* rois,
                                     const int32_t* roi_levels,
                                     const uint8_t* valid, int num_rois,
                                     int pooled_h, int pooled_w, int sr,
                                     int aligned, const T* g,
                                     cudaStream_t stream) {
  TileGrid tiles = {};
  long long blocks = 0;
  for (int l = 0; l < num_levels; ++l) {
    tiles.tiles_x[l] = (table.width(l) + kTileW - 1) / kTileW;
    tiles.tiles[l] = (table.height(l) + kTileH - 1) / kTileH * tiles.tiles_x[l];
    tiles.first[l] = static_cast<int>(blocks);
    blocks += static_cast<long long>(batch) * tiles.tiles[l];
  }
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  for (int l = num_levels; l <= kMaxLevels; ++l) {
    tiles.first[l] = static_cast<int>(blocks);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  (channels + kChunk - 1) / kChunk);
  const cudaError_t err = opt_in_shared(roi_tile_backward_kernel<T, Table>,
                                        kTileBytes,
                                        tile_backward_opted[sizeof(T) == 4]);
  if (err != cudaSuccess) return err;
  roi_tile_backward_kernel<T, Table><<<grid, kThreads, kTileBytes, stream>>>(
      table, tiles, num_levels, batch, channels, rois, roi_levels, valid,
      num_rois, pooled_h, pooled_w, sr, aligned, g);
  return cudaGetLastError();
}

}  // namespace cpm
