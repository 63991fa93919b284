// Multilevel FPN RoIAlign for Hopper (sm_90a): forward and backward.
//
// The forward replaces the TPU kernel cpm_tpu/ops/pallas/multilevel_pallas.py
// ::multilevel_roi_align_pallas (_fwd/_fwd_kernel_body); the backward, further
// down, replaces its custom_vjp backward (_bwd/_bwd_kernel_body). Both take
// their sample coordinates from the same device functions (roi_geometry,
// sample_coord, bilinear_1d), so the backward adds into exactly the cells the
// forward read, with the same weights. The forward computes
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kThreads = 256;

struct LevelTable {
  const void* ptr[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

// Elements of T in one 16-byte vector.
template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int kN = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int kN = 8;
};

__device__ __forceinline__ void accumulate(const float* p, float w,
                                           float* acc) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  acc[0] += w * v.x;
  acc[1] += w * v.y;
  acc[2] += w * v.z;
  acc[3] += w * v.w;
}

__device__ __forceinline__ void accumulate(const __nv_bfloat16* p, float w,
                                           float* acc) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc[2 * k] += w * f.x;
    acc[2 * k + 1] += w * f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// Bilinear source cells and weights of one coordinate, as
// cpm_tpu/ops/roi_align.py::_bilinear_weights_1d_sized computes them.
// Returns false for an out-of-bounds sample.
__device__ __forceinline__ bool bilinear_1d(float coord, int size, int* lo,
                                            int* hi, float* w_lo,
                                            float* w_hi) {
  if (coord < -1.0f || coord > static_cast<float>(size)) return false;
  const float c = fminf(fmaxf(coord, 0.0f), static_cast<float>(size) - 1.0f);
  const float f = floorf(c);
  *lo = static_cast<int>(f);
  *hi = min(*lo + 1, size - 1);
  *w_hi = c - f;
  *w_lo = 1.0f - *w_hi;
  return true;
}

// Where a roi lies on its level: the level's size, the batch image, the
// roi's origin and its bin size in cells.
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

// Level and batch ids are clamped so that a malformed roi cannot touch
// memory outside the maps; the model always passes ids in range.
// Coordinates use explicitly rounded operations, which nvcc never fuses into
// an FMA: they then round exactly as the plain version's separate tensor ops
// do, so the kernels and the plain version touch the same cells with the
// same weights.
__device__ __forceinline__ RoiGeometry roi_geometry(
    const LevelTable& levels, int num_levels, int batch,
    const float* __restrict__ rois, const int32_t* __restrict__ roi_levels,
    int r, int pooled_h, int pooled_w, int aligned) {
  RoiGeometry g;
  g.level = min(max(roi_levels[r], 0), num_levels - 1);
  g.height = levels.height[g.level];
  g.width = levels.width[g.level];
  const float scale = levels.scale[g.level];
  const float* roi = rois + static_cast<size_t>(r) * 5;
  g.batch = min(max(static_cast<int>(roi[0]), 0), batch - 1);
  const float offset = aligned ? 0.5f : 0.0f;
  g.x1 = __fsub_rn(__fmul_rn(roi[1], scale), offset);
  g.y1 = __fsub_rn(__fmul_rn(roi[2], scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[3], scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[4], scale), offset);
  float roi_w = __fsub_rn(x2, g.x1);
  float roi_h = __fsub_rn(y2, g.y1);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  g.bin_w = roi_w / static_cast<float>(pooled_w);
  g.bin_h = roi_h / static_cast<float>(pooled_h);
  return g;
}

// Coordinate of sample `index` (over bins x samples per bin) along one axis.
__device__ __forceinline__ float sample_coord(float start, int index, int sr,
                                              float bin) {
  const float f = (static_cast<float>(index) + 0.5f) / static_cast<float>(sr);
  return __fadd_rn(start, __fmul_rn(f, bin));
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
                   wy_lo * wx_lo, acc);
        accumulate(row_lo + static_cast<size_t>(x_hi) * channels,
                   wy_lo * wx_hi, acc);
        accumulate(row_hi + static_cast<size_t>(x_lo) * channels,
                   wy_hi * wx_lo, acc);
        accumulate(row_hi + static_cast<size_t>(x_hi) * channels,
                   wy_hi * wx_hi, acc);
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
  const int vecs = channels / VecWidth<T>::kN;
  const int tx = vecs < 64 ? vecs : 64;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid(num_rois, (vecs + tx - 1) / tx);
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

__device__ __forceinline__ void load_scaled(const float* p, float s,
                                            float* v) {
  const float4 raw = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = raw.x * s;
  v[1] = raw.y * s;
  v[2] = raw.z * s;
  v[3] = raw.w * s;
}

__device__ __forceinline__ void load_scaled(const __nv_bfloat16* p, float s,
                                            float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x * s;
    v[2 * k + 1] = f.y * s;
  }
}

template <int kN>
__device__ __forceinline__ void scatter(float* cell, float w,
                                        const float* v) {
#pragma unroll
  for (int k = 0; k < kN; k += 4) {
    atomicAdd(reinterpret_cast<float4*>(cell + k),
              make_float4(w * v[k], w * v[k + 1], w * v[k + 2],
                          w * v[k + 3]));
  }
}

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
  const int vecs = channels / VecWidth<T>::kN;
  const int tx = vecs < 64 ? vecs : 64;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid(num_rois, (vecs + tx - 1) / tx);
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
