// Multilevel FPN RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel cpm_tpu/ops/pallas/multilevel_pallas.py::
// multilevel_roi_align_pallas (forward, _fwd/_fwd_kernel_body). It computes
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

  // Level and batch ids are clamped so that a malformed roi cannot read
  // outside the feature maps; the model always passes ids in range.
  const int lvl = min(max(roi_levels[r], 0), num_levels - 1);
  const int H = levels.height[lvl];
  const int W = levels.width[lvl];
  const float scale = levels.scale[lvl];
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int b = min(max(static_cast<int>(roi[0]), 0), batch - 1);

  const float offset = aligned ? 0.5f : 0.0f;
  // Coordinates use explicitly rounded operations, which nvcc never fuses
  // into an FMA: they then round exactly as the plain version's separate
  // tensor ops do, so both read the same cells with the same weights.
  const float x1 = __fsub_rn(__fmul_rn(roi[1], scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(roi[2], scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[3], scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[4], scale), offset);
  float roi_w = __fsub_rn(x2, x1);
  float roi_h = __fsub_rn(y2, y1);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  const float bin_w = roi_w / static_cast<float>(pooled_w);
  const float bin_h = roi_h / static_cast<float>(pooled_h);
  const float count = static_cast<float>(sr * sr);

  const T* feat = static_cast<const T*>(levels.ptr[lvl]) +
                  static_cast<size_t>(b) * H * W * channels + c0;

  for (int bin = threadIdx.y; bin < bins; bin += blockDim.y) {
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    float acc[kN] = {};
    for (int iy = 0; iy < sr; ++iy) {
      const float fy = (static_cast<float>(py * sr + iy) + 0.5f) /
                       static_cast<float>(sr);
      int y_lo, y_hi;
      float wy_lo, wy_hi;
      const float y = __fadd_rn(y1, __fmul_rn(fy, bin_h));
      if (!bilinear_1d(y, H, &y_lo, &y_hi, &wy_lo, &wy_hi)) continue;
      const T* row_lo = feat + static_cast<size_t>(y_lo) * W * channels;
      const T* row_hi = feat + static_cast<size_t>(y_hi) * W * channels;
      for (int ix = 0; ix < sr; ++ix) {
        const float fx = (static_cast<float>(px * sr + ix) + 0.5f) /
                         static_cast<float>(sr);
        int x_lo, x_hi;
        float wx_lo, wx_hi;
        const float x = __fadd_rn(x1, __fmul_rn(fx, bin_w));
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
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
      channels < 1 || sampling_ratio < 1 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
