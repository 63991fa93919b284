// Stacked-levels multilevel RoIAlign for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels of cpm_tpu/ops/pallas/stacked_pallas.py:
// multilevel_roi_align_stacked (_fwd/_fwd_kernel_body) and its custom_vjp
// backward (_bwd/_bwd_kernel_body). All FPN levels lie in ONE buffer
// [batch, total_rows, row_width, channels]: level l occupies rows
// row_offset[l] .. row_offset[l] + height[l] and columns 0 .. width[l], the
// rest of each row is padding. The kernels get one base pointer and one row
// stride, and a per-level table of (row offset, height, width, scale) by
// value; the address of cell (b, l, y, x) is
//   base + ((b * total_rows + row_offset[l] + y) * row_width + x) * channels
// so no pointer is chosen per roi. Sample coordinates are clamped to the
// level's own height and width, so no sample reads a neighbour level's rows
// or the padding columns.
//
// The forward is the multilevel forward's own loop (roi_align_forward.cuh,
// which says what bounds it on the H100 and how it is laid out) over the
// stacked buffer (StackMaps): a roi's bins spread over several blocks, its
// axis samples staged once a block, one sample's four 16-byte loads in
// flight, five blocks an SM. It reads the same cells with the same weights
// and sums them in the same order as the multilevel forward, so the two give
// the same bits. Masked rois write zeros and read nothing. The TPU kernel's
// 64-cell window DMA, its zero tail rows and its pad to 8 columns have no
// counterpart.
//
// The backward is the transpose, the gradient of the stacked buffer: the
// tile-owned gather of roi_align_tiles.cuh, the multilevel backward's own
// loop, over each level's valid region of ONE buffer in g's dtype
// (StackMaps addresses a level's cells through its row offset). Its blocks
// own tiles of each level's cells, sum in float32 in shared memory in roi
// order and write each tile once; the padding columns are neither read nor
// written, so the caller allocates the buffer without filling it and reads
// the levels back as views. No float32 accumulator, fill, cast or atomic:
// two runs give the same bits, and the same bits as the multilevel backward
// on the same inputs (same tiles, roi order and rounding). The TPU kernel
// accumulates in the feature dtype (its grid runs in order); this one sums in
// float32 and rounds once. The scatter it replaces (one CTA per roi, float4
// atomic adds into a zero-filled float32 stack that the caller then sliced
// and cast) ran at about 21x its bound on an H100, and its sums changed from
// run to run.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/stacked_roi_align.py).

#include "roi_align_forward.cuh"

namespace cpm_stacked {

using namespace cpm;

struct StackTable {
  int row_offset[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

// The levels of one stacked buffer [batch, total_rows, row_width, channels]
// as the forward loop and the tile-owned backward reach them.
struct StackMaps {
  StackTable table;
  void* base;
  int total_rows;
  int row_width;

  __host__ __device__ int height(int l) const { return table.height[l]; }
  __host__ __device__ int width(int l) const { return table.width[l]; }
  __host__ __device__ int pitch(int) const { return row_width; }
  __device__ float scale(int l) const { return table.scale[l]; }
  // cell (y, 0) of level l in `image`
  template <typename T>
  __device__ T* row(int l, int image, int y, int channels) const {
    return static_cast<T*>(base) +
           (static_cast<size_t>(image) * total_rows + table.row_offset[l] + y) *
               row_width * channels;
  }
};

}  // namespace cpm_stacked

namespace {

using namespace cpm;
using cpm_stacked::StackMaps;
using cpm_stacked::StackTable;

// Fills the table from the host arrays ([row_offset, height, width] int32
// triples, and float scales); false when a level does not lie inside the
// buffer.
bool make_table(const void* level_rows_hw, const void* level_scales,
                int num_levels, int total_rows, int row_width,
                StackTable* table) {
  const int* t = static_cast<const int*>(level_rows_hw);
  const float* scales = static_cast<const float*>(level_scales);
  for (int l = 0; l < num_levels; ++l) {
    table->row_offset[l] = t[3 * l];
    table->height[l] = t[3 * l + 1];
    table->width[l] = t[3 * l + 2];
    table->scale[l] = scales[l];
    // every level must lie inside the buffer
    if (t[3 * l] < 0 || t[3 * l + 1] < 1 || t[3 * l + 2] < 1 ||
        t[3 * l] + t[3 * l + 1] > total_rows || t[3 * l + 2] > row_width) {
      return false;
    }
  }
  return true;
}

// The forward's staged samples must fit (forward_fits); the backward takes
// the same arguments.
bool bad_arguments(int num_levels, int num_rois, int channels, int pooled_h,
                   int pooled_w, int sampling_ratio, int dtype) {
  return num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
         channels < 1 || dtype < 0 || dtype > 1 ||
         !forward_fits(pooled_h, pooled_w, sampling_ratio);
}

// The stacked buffer at `base` as StackMaps; false when the arguments are
// bad or a level does not lie inside the buffer.
bool make_maps(void* base, const void* level_rows_hw, const void* level_scales,
               int num_levels, int num_rois, int total_rows, int row_width,
               int channels, int pooled_h, int pooled_w, int sampling_ratio,
               int dtype, StackMaps* maps) {
  *maps = {};
  maps->base = base;
  maps->total_rows = total_rows;
  maps->row_width = row_width;
  return !bad_arguments(num_levels, num_rois, channels, pooled_h, pooled_w,
                        sampling_ratio, dtype) &&
         make_table(level_rows_hw, level_scales, num_levels, total_rows,
                    row_width, &maps->table);
}

}  // namespace

// stack is device memory [batch, total_rows, row_width, channels]
// contiguous, of `dtype` (0 = float32, 1 = bfloat16). level_rows_hw
// ([row_offset0, h0, w0, row_offset1, ...] int32) and level_scales (float)
// are host arrays of num_levels entries. rois [num_rois, 5] f32 (batch
// index, x1, y1, x2, y2), roi_levels [num_rois] int32 in [0, num_levels),
// valid [num_rois] bytes, out [num_rois, pooled_h, pooled_w, channels] of
// `dtype`: all device memory. channels must be a multiple of 16 bytes'
// worth of elements and every pointer 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int cpm_stacked_roi_align_fwd(
    const void* stack, const void* level_rows_hw, const void* level_scales,
    int num_levels, int batch, int total_rows, int row_width, int channels,
    const void* rois, const void* roi_levels, const void* valid, int num_rois,
    int pooled_h, int pooled_w, int sampling_ratio, int aligned, int dtype,
    void* out, void* stream) {
  StackMaps maps;
  if (!make_maps(const_cast<void*>(stack), level_rows_hw, level_scales,
                 num_levels, num_rois, total_rows, row_width, channels,
                 pooled_h, pooled_w, sampling_ratio, dtype, &maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* r = static_cast<const float*>(rois);
  const int32_t* lv = static_cast<const int32_t*>(roi_levels);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_roi_align_forward<float>(
        maps, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned, static_cast<float*>(out), s);
  } else {
    err = launch_roi_align_forward<__nv_bfloat16>(
        maps, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned, static_cast<__nv_bfloat16*>(out),
        s);
  }
  return static_cast<int>(err);
}

// The backward. grad_stack is the gradient of the stack,
// [batch, total_rows, row_width, channels] of `dtype`: the kernel writes
// every level's valid region (rows row_offset .. + height, columns
// 0 .. width) and nothing else, so it needs no fill; g is the gradient of
// the forward's output, [num_rois, pooled_h, pooled_w, channels]
// contiguous, of `dtype`. Everything else is as in the forward.
extern "C" int cpm_stacked_roi_align_bwd(
    void* grad_stack, const void* level_rows_hw, const void* level_scales,
    int num_levels, int batch, int total_rows, int row_width, int channels,
    const void* rois, const void* roi_levels, const void* valid, int num_rois,
    int pooled_h, int pooled_w, int sampling_ratio, int aligned, int dtype,
    const void* g, void* stream) {
  StackMaps maps;
  if (!make_maps(grad_stack, level_rows_hw, level_scales, num_levels,
                 num_rois, total_rows, row_width, channels, pooled_h,
                 pooled_w, sampling_ratio, dtype, &maps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* r = static_cast<const float*>(rois);
  const int32_t* lv = static_cast<const int32_t*>(roi_levels);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_roi_tile_backward<float>(
        maps, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned, static_cast<const float*>(g), s);
  } else {
    err = launch_roi_tile_backward<__nv_bfloat16>(
        maps, num_levels, batch, channels, r, lv, v, num_rois, pooled_h,
        pooled_w, sampling_ratio, aligned,
        static_cast<const __nv_bfloat16*>(g), s);
  }
  return static_cast<int>(err);
}
