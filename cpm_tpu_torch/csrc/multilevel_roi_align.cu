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
// Backward: the exact transpose of the forward. For each valid roi, bin and
// sample, g[r, bin, :] / sr^2 times each of the four bilinear weights is
// added to the cell the forward read with that weight. Masked rois add
// nothing; rois and level ids get no gradient.
//
// What bounds it on the H100: bytes, not FLOPs. g is read once (16 bytes a
// thread, coalesced along C), and every sample sends four C-vectors of
// atomic adds to L2: one multiply per element added. Blocks run in no order
// and many rois overlap, so the sums go through atomicAdd on float32
// accumulators (one zero-filled [B, H_l, W_l, C] float32 map per level,
// whatever the dtype of g), four channels to one float4 atomic. Their order
// changes from run to run, so two runs differ in the last bits.
// The TPU kernel's window slabs, hat-weight matmuls and read-modify-write
// DMAs existed because its grid runs in order on one core; none carries over.

template <typename T>
__global__ void __launch_bounds__(kThreads)
    multilevel_roi_align_bwd_kernel(LevelTable grads, int num_levels,
                                    int batch, int channels,
                                    const float* __restrict__ rois,
                                    const int32_t* __restrict__ roi_levels,
                                    const uint8_t* __restrict__ valid,
                                    int pooled_h, int pooled_w, int sr,
                                    int aligned, const T* __restrict__ g) {
  constexpr int kN = VecWidth<T>::kN;
  const int r = blockIdx.x;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kN;
  if (c0 >= channels || !valid[r]) return;
  const int bins = pooled_h * pooled_w;
  const RoiGeometry geo =
      roi_geometry(grads, num_levels, batch, rois, roi_levels, r, pooled_h,
                   pooled_w, aligned);
  const int H = geo.height;
  const int W = geo.width;
  const float inv_count = 1.0f / static_cast<float>(sr * sr);
  const T* g_roi = g + static_cast<size_t>(r) * bins * channels + c0;
  // the accumulators are float32 whatever T is; ptr is declared const for
  // the forward's sake
  float* grad = static_cast<float*>(const_cast<void*>(grads.ptr[geo.level])) +
                static_cast<size_t>(geo.batch) * H * W * channels + c0;

  for (int bin = threadIdx.y; bin < bins; bin += blockDim.y) {
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    float v[kN];
    load_scaled(g_roi + static_cast<size_t>(bin) * channels, inv_count, v);
    for (int iy = 0; iy < sr; ++iy) {
      int y_lo, y_hi;
      float wy_lo, wy_hi;
      const float y = sample_coord(geo.y1, py * sr + iy, sr, geo.bin_h);
      if (!bilinear_1d(y, H, &y_lo, &y_hi, &wy_lo, &wy_hi)) continue;
      float* row_lo = grad + static_cast<size_t>(y_lo) * W * channels;
      float* row_hi = grad + static_cast<size_t>(y_hi) * W * channels;
      for (int ix = 0; ix < sr; ++ix) {
        int x_lo, x_hi;
        float wx_lo, wx_hi;
        const float x = sample_coord(geo.x1, px * sr + ix, sr, geo.bin_w);
        if (!bilinear_1d(x, W, &x_lo, &x_hi, &wx_lo, &wx_hi)) continue;
        scatter<kN>(row_lo + static_cast<size_t>(x_lo) * channels,
                    wy_lo * wx_lo, v);
        scatter<kN>(row_lo + static_cast<size_t>(x_hi) * channels,
                    wy_lo * wx_hi, v);
        scatter<kN>(row_hi + static_cast<size_t>(x_lo) * channels,
                    wy_hi * wx_lo, v);
        scatter<kN>(row_hi + static_cast<size_t>(x_hi) * channels,
                    wy_hi * wx_hi, v);
      }
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const LevelTable& table, int num_levels, int batch,
                       int channels, const float* rois,
                       const int32_t* roi_levels, const uint8_t* valid,
                       int num_rois, int pooled_h, int pooled_w, int sr,
                       int aligned, const T* g, cudaStream_t stream) {
  dim3 grid, block;
  roi_launch_shape<T>(channels, num_rois, &grid, &block);
  multilevel_roi_align_bwd_kernel<T><<<grid, block, 0, stream>>>(
      table, num_levels, batch, channels, rois, roi_levels, valid, pooled_h,
      pooled_w, sr, aligned, g);
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

// The backward. grad_ptrs are the per-level float32 accumulators
// [batch, H_l, W_l, channels], zero-filled by the caller, into which the
// kernel adds; g is the gradient of the forward's output,
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
