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
