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
// multilevel_roi_align computes, through the forward loop this file shares
// with the stacked and the single-level forwards (roi_align_forward.cuh,
// which says what bounds it on the H100 and how it is laid out) over one map
// per level (LevelTable). The TPU kernel's 64-cell window, prefetch ring and
// hat-weight matmuls have no counterpart: the kernel reads cells directly
// and is exact for every roi shape.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/multilevel_roi_align.py).

#include "roi_align_forward.cuh"

namespace {

using namespace cpm;

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

// The forward's staged samples must fit (forward_fits); the backward takes
// the same arguments.
bool bad_arguments(int num_levels, int num_rois, int channels, int pooled_h,
                   int pooled_w, int sampling_ratio, int dtype) {
  return num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
         channels < 1 || dtype < 0 || dtype > 1 ||
         !forward_fits(pooled_h, pooled_w, sampling_ratio);
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
    err = launch_roi_align_forward<float>(
        table, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned, static_cast<float*>(out), s);
  } else {
    err = launch_roi_align_forward<__nv_bfloat16>(
        table, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned, static_cast<__nv_bfloat16*>(out),
        s);
  }
  return static_cast<int>(err);
}

// The backward: the tile-owned gather of roi_align_tiles.cuh over the
// per-level gradient maps, written in g's dtype. The scatter this replaced
// sent four C-vectors of float4 atomics to L2 for every sample into a
// zero-filled float32 buffer of all four levels (182.8 MB at batch 2,
// 800x1344, C=256), filled and cast by its wrapper: 22x the bound, about
// half of it the fill and the cast. grad_ptrs are the per-level gradient maps
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
