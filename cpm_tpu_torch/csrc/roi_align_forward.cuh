// The RoIAlign forward shared by three kernels of the port: the multilevel
// forward (multilevel_roi_align.cu, one map per level), the stacked forward
// (stacked_roi_align.cu, all levels in one buffer) and the single-level
// forward (roi_align.cu, one map, not aligned, no mask). Each roi reads the
// level it was assigned, takes `sampling_ratio` x `sampling_ratio` bilinear
// samples per output bin (the reference CUDA out-of-bounds rule: a sample
// with y < -1 or y > H (x likewise) reads zero; otherwise its coordinate is
// clamped into [0, H-1]), and averages them. Rois whose `valid` flag is
// false write zeros and read nothing; the single-level forward has no mask
// and one level (kSingle), and reads neither array.
//
// What bounds it on the H100: bytes, not FLOPs. Every sample reads four
// C-vectors (4 x 512 B at C=256 in bf16) and does one multiply-add per
// element read, so the kernel is a gather whose traffic mostly hits L1/L2
// (neighbouring samples of a roi share source cells), and what limits it in
// practice is how many of those gathers are in flight on the card. The
// design: threads along C, each loading 16 contiguous bytes of a cell with a
// read-only load, so a warp reads whole 512-byte cell rows; rows of threads
// split a roi's bins, at most four bins a row, and the roi's bins are
// spread over several blocks (bin_slices), so that a grid-stage call of 300
// rois at 14x14 runs 2100 short blocks over the 132 SMs rather than 300
// long ones. The single-level forward keeps a roi's bins in one block for
// each C tile: at C=1024 in f32 a roi already takes four blocks, and more
// would fetch its cells into more SMs' L1 (measured slower). Each block
// stages the roi's samples along each axis (cells and
// weights, pooled x sr a side) in shared memory once, instead of every
// thread recomputing every sample for every bin; each thread keeps a
// sample's four loads in flight (pool_bin, roi_align_common.cuh) within 48
// registers, so that five blocks fit an SM (a few bytes spill in the stacked
// and single-level forms, none in the multilevel ones). Every output element
// is summed in the order the clustered forward sums it too, so all four
// forwards give the same bits. Accumulation is in f32; the result is written
// once in the feature dtype.
//
// The maps are reached through a table type with height(l), width(l),
// scale(l), pitch(l) (cells from one row of level l to the next) and
// row<T>(l, image, y, channels) (the address of cell (y, 0) of level l in
// `image`): LevelTable below, StackMaps in stacked_roi_align.cu. A block
// takes its roi's row 0 and pitch once, so the two tables cost the sample
// loop the same registers.

#pragma once

#include "roi_align_tiles.cuh"

namespace cpm {

// One map per level, each [batch, height, width, channels] contiguous.
struct LevelTable {
  const void* ptr[kMaxLevels];
  int heights[kMaxLevels];
  int widths[kMaxLevels];
  float scales[kMaxLevels];

  __host__ __device__ int height(int l) const { return heights[l]; }
  __host__ __device__ int width(int l) const { return widths[l]; }
  __host__ __device__ int pitch(int l) const { return widths[l]; }
  __device__ float scale(int l) const { return scales[l]; }
  // cell (y, 0) of level l in `image`; ptr is declared const for the
  // forward's sake
  template <typename T>
  __device__ T* row(int l, int image, int y, int channels) const {
    return static_cast<T*>(const_cast<void*>(ptr[l])) +
           (static_cast<size_t>(image) * heights[l] + y) * widths[l] * channels;
  }
};

// Block (tx, ty) as roi_launch_shape gives it: tx threads along C, ty rows
// of bins. Block x of the grid pools bins [slice * span, slice * span +
// span) of roi x / slices; block y is the C tile. Five blocks an SM: at
// most 48 registers a thread. kSingle: one level and no mask (the
// single-level forward); roi_levels and valid are then not read and may be
// null.
template <typename T, typename Maps, bool kSingle>
__global__ void __launch_bounds__(kThreads, 5)
    roi_align_fwd_kernel(Maps maps, int num_levels, int batch, int channels,
                         const float* __restrict__ rois,
                         const int32_t* __restrict__ roi_levels,
                         const uint8_t* __restrict__ valid, int pooled_h,
                         int pooled_w, int sr, int aligned, int slices,
                         int span, T* __restrict__ out) {
  extern __shared__ AxisSample axis[];  // pooled_h * sr rows, then columns
  constexpr int kN = VecWidth<T>::kN;
  const int r = blockIdx.x / slices;
  const int bins = pooled_h * pooled_w;
  const int first = (blockIdx.x - r * slices) * span;
  const int last = min(first + span, bins);
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kN;
  const bool has_channels = c0 < channels;
  T* out_roi = out + static_cast<size_t>(r) * bins * channels + c0;

  if (!kSingle && !valid[r]) {
    if (!has_channels) return;
    const float zeros[kN] = {};
    for (int bin = first + threadIdx.y; bin < last; bin += blockDim.y) {
      store(out_roi + static_cast<size_t>(bin) * channels, zeros);
    }
    return;
  }

  // the roi's samples along each axis, once for the block
  const RoiGeometry geo = roi_geometry_at(
      maps, kSingle ? 0 : roi_level(roi_levels, r, num_levels), batch, rois,
      r, pooled_h, pooled_w, aligned);
  const int rows = pooled_h * sr;
  const int cols = pooled_w * sr;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows + cols;
       i += blockDim.x * blockDim.y) {
    axis[i] = i < rows
                  ? axis_sample(geo.y1, i, sr, geo.bin_h, geo.height)
                  : axis_sample(geo.x1, i - rows, sr, geo.bin_w, geo.width);
  }
  __syncthreads();
  if (!has_channels) return;

  const int pitch = maps.pitch(geo.level);
  const T* feat =
      maps.template row<const T>(geo.level, geo.batch, 0, channels) + c0;
  const auto load = [&](int y, int x) {
    return load16(feat + (static_cast<size_t>(y) * pitch + x) * channels);
  };
  for (int bin = first + threadIdx.y; bin < last; bin += blockDim.y) {
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    float acc[kN];
    pool_bin<T>(axis + py * sr, axis + rows + px * sr, sr, load, acc);
    store(out_roi + static_cast<size_t>(bin) * channels, acc);
  }
}

// The work split: each block pools `span` bins of one roi, at most
// kBinsPerRow per row of threads, the bins spread evenly over the `slices`
// blocks of a roi (at C=256 in bf16, 8 rows: 7 blocks of 28 bins a roi at
// 14x14, 2 of 25 at 7x7). Its plain version is
// cpm_tpu_torch/ops/cuda/multilevel_roi_align.py::bin_slices.
constexpr int kBinsPerRow = 4;
inline void bin_slices(int bins, int rows_of_threads, int* slices, int* span) {
  const int most = kBinsPerRow * rows_of_threads;
  *slices = (bins + most - 1) / most;
  *span = (bins + *slices - 1) / *slices;
}

// The forward stages (pooled_h + pooled_w) * sampling_ratio samples in
// shared memory: at most the 48 KB a block has without opting in.
inline bool forward_fits(int pooled_h, int pooled_w, int sampling_ratio) {
  return pooled_h >= 1 && pooled_w >= 1 && sampling_ratio >= 1 &&
         static_cast<long long>(pooled_h + pooled_w) * sampling_ratio *
                 sizeof(AxisSample) <=
             48 * 1024;
}

// One launch of the forward over every roi, on `stream`. The multilevel and
// stacked forwards spread each roi's bins over several blocks (bin_slices);
// the single-level forward (kSingle) gives a roi and C tile one block.
// Returns the cudaError_t of the launch.
template <typename T, bool kSingle = false, typename Maps>
cudaError_t launch_roi_align_forward(const Maps& maps, int num_levels,
                                     int batch, int channels,
                                     const float* rois,
                                     const int32_t* roi_levels,
                                     const uint8_t* valid, int num_rois,
                                     int pooled_h, int pooled_w, int sr,
                                     int aligned, T* out,
                                     cudaStream_t stream) {
  dim3 grid, block;
  roi_launch_shape<T>(channels, num_rois, &grid, &block);
  int slices = 1, span = pooled_h * pooled_w;
  if (!kSingle) bin_slices(pooled_h * pooled_w, block.y, &slices, &span);
  grid.x = num_rois * slices;
  const size_t shared = sizeof(AxisSample) * (pooled_h + pooled_w) * sr;
  roi_align_fwd_kernel<T, Maps, kSingle><<<grid, block, shared, stream>>>(
      maps, num_levels, batch, channels, rois, roi_levels, valid, pooled_h,
      pooled_w, sr, aligned, slices, span, out);
  return cudaGetLastError();
}

}  // namespace cpm
