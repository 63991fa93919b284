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
// (neighbouring samples of a roi share source cells), and what limits it in
// practice is how many of those gathers are in flight on the card. The
// design: threads along C, each loading 16 contiguous bytes of a cell with a
// read-only load, so a warp reads whole 512-byte cell rows; rows of threads
// split a roi's bins, at most four bins a row, and the roi's bins are
// spread over several blocks (bin_slices), so that a grid-stage call of 300
// rois at 14x14 runs 2100 short blocks over the 132 SMs rather than 300
// long ones. Each block stages the roi's samples along each axis (cells and
// weights, pooled x sr a side) in shared memory once, instead of every
// thread recomputing every sample for every bin; each thread keeps a
// sample's four loads in flight (pool_bin, roi_align_common.cuh) within 48
// registers, so that five blocks fit an SM. Every output element is summed
// in the order the stacked, clustered and single-level forwards sum it, so
// all four give the same bits. Accumulation is in
// f32; the result is written once in the feature dtype. The TPU kernel's
// 64-cell window, prefetch ring and hat-weight matmuls have no counterpart:
// the kernel reads cells directly and is exact for every roi shape.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/multilevel_roi_align.py).

#include "roi_align_tiles.cuh"

namespace cpm_multilevel {

using namespace cpm;

// One map per level, each [batch, height, width, channels] contiguous.
struct LevelTable {
  const void* ptr[kMaxLevels];
  int heights[kMaxLevels];
  int widths[kMaxLevels];
  float scales[kMaxLevels];

  __host__ __device__ int height(int l) const { return heights[l]; }
  __host__ __device__ int width(int l) const { return widths[l]; }
  __device__ float scale(int l) const { return scales[l]; }
  // cell (y, 0) of level l in `image`; ptr is declared const for the
  // forward's sake
  template <typename T>
  __device__ T* row(int l, int image, int y, int channels) const {
    return static_cast<T*>(const_cast<void*>(ptr[l])) +
           (static_cast<size_t>(image) * heights[l] + y) * widths[l] * channels;
  }
};

}  // namespace cpm_multilevel

namespace {

using namespace cpm;
using cpm_multilevel::LevelTable;

// Block (tx, ty) as roi_launch_shape gives it: tx threads along C, ty rows
// of bins. Block x of the grid pools bins [slice * span, slice * span +
// span) of roi x / slices; block y is the C tile. Five blocks an SM: at
// most 48 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
    multilevel_roi_align_fwd_kernel(LevelTable levels, int num_levels,
                                    int batch, int channels,
                                    const float* __restrict__ rois,
                                    const int32_t* __restrict__ roi_levels,
                                    const uint8_t* __restrict__ valid,
                                    int pooled_h, int pooled_w, int sr,
                                    int aligned, int slices, int span,
                                    T* __restrict__ out) {
  extern __shared__ AxisSample axis[];  // pooled_h * sr rows, then columns
  constexpr int kN = VecWidth<T>::kN;
  const int r = blockIdx.x / slices;
  const int bins = pooled_h * pooled_w;
  const int first = (blockIdx.x - r * slices) * span;
  const int last = min(first + span, bins);
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kN;
  const bool has_channels = c0 < channels;
  T* out_roi = out + static_cast<size_t>(r) * bins * channels + c0;

  if (!valid[r]) {
    if (!has_channels) return;
    const float zeros[kN] = {};
    for (int bin = first + threadIdx.y; bin < last; bin += blockDim.y) {
      store(out_roi + static_cast<size_t>(bin) * channels, zeros);
    }
    return;
  }

  // the roi's samples along each axis, once for the block
  const RoiGeometry geo =
      roi_geometry(levels, num_levels, batch, rois, roi_levels, r, pooled_h,
                   pooled_w, aligned);
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

  const int W = geo.width;
  const T* feat = static_cast<const T*>(levels.ptr[geo.level]) +
                  static_cast<size_t>(geo.batch) * geo.height * W * channels +
                  c0;
  const auto load = [&](int y, int x) {
    return load16(feat + (static_cast<size_t>(y) * W + x) * channels);
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

template <typename T>
cudaError_t launch(const LevelTable& table, int num_levels, int batch,
                   int channels, const float* rois, const int32_t* roi_levels,
                   const uint8_t* valid, int num_rois, int pooled_h,
                   int pooled_w, int sr, int aligned, T* out,
                   cudaStream_t stream) {
  dim3 grid, block;
  roi_launch_shape<T>(channels, num_rois, &grid, &block);
  int slices, span;
  bin_slices(pooled_h * pooled_w, block.y, &slices, &span);
  grid.x = num_rois * slices;
  const size_t shared = sizeof(AxisSample) * (pooled_h + pooled_w) * sr;
  multilevel_roi_align_fwd_kernel<T><<<grid, block, shared, stream>>>(
      table, num_levels, batch, channels, rois, roi_levels, valid, pooled_h,
      pooled_w, sr, aligned, slices, span, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: the tile-owned gather of roi_align_tiles.cuh over the per-level
// gradient maps, written in g's dtype. The scatter this replaced sent four
// C-vectors of float4 atomics to L2 for every sample into a zero-filled
// float32 buffer of all four levels (182.8 MB at batch 2, 800x1344, C=256),
// filled and cast by its wrapper: 22x the bound, about half of it the fill
// and the cast.

LevelTable make_table(const void* level_ptrs, const void* level_hw,
                      const void* level_scales, int num_levels) {
  LevelTable table = {};
  const void* const* ptrs = static_cast<const void* const*>(level_ptrs);
  const int* hw = static_cast<const int*>(level_hw);
  const float* scales = static_cast<const float*>(level_scales);
  for (int l = 0; l < num_levels; ++l) {
    table.ptr[l] = ptrs[l];
    table.heights[l] = hw[2 * l];
    table.widths[l] = hw[2 * l + 1];
    table.scales[l] = scales[l];
  }
  return table;
}

// The forward stages (pooled_h + pooled_w) * sampling_ratio samples in
// shared memory: at most the 48 KB a block has without opting in.
bool bad_arguments(int num_levels, int num_rois, int channels, int pooled_h,
                   int pooled_w, int sampling_ratio, int dtype) {
  return num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
         channels < 1 || pooled_h < 1 || pooled_w < 1 || sampling_ratio < 1 ||
         dtype < 0 || dtype > 1 ||
         static_cast<long long>(pooled_h + pooled_w) * sampling_ratio *
                 sizeof(AxisSample) >
             48 * 1024;
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
  if (bad_arguments(num_levels, num_rois, channels, pooled_h, pooled_w,
                    sampling_ratio, dtype)) {
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
  if (bad_arguments(num_levels, num_rois, channels, pooled_h, pooled_w,
                    sampling_ratio, dtype)) {
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
    err = launch_roi_tile_backward<float>(
        table, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned, static_cast<const float*>(g), s);
  } else {
    err = launch_roi_tile_backward<__nv_bfloat16>(
        table, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned,
        static_cast<const __nv_bfloat16*>(g), s);
  }
  return static_cast<int>(err);
}
