// Bilinear sampler of deformable convolution for Hopper (sm_90a), forward
// and backward.
//
// Replaces the TPU kernel tools/probe_dcn_pallas_sampler.py::pallas_sample
// (body `_kernel`), the per-sample formulation of
// cpm_tpu/ops/deform_conv.py::_bilinear_gather, and that function's
// hand-written backward (`_bilinear_gather_bwd`, XLA ops in the JAX package).
// feat [B, H, W, C] is sampled at per-sample f32 coordinates ys / xs [B, P]
// into out [B, P, C], with the weights of `_window_parts`: the 2x2 window
// starts at (clamp(floor(y), 0, H-2), clamp(floor(x), 0, W-2)), cell (i, j)
// weighs relu(1 - |y - row_i|) * relu(1 - |x - col_j|), and a row or column
// past the last one weighs zero. So a sample wholly outside the map gives
// zero and one on the border a partial sum, and a map of one row or one
// column gives what the JAX package's four-corner form gives there.
//
// Forward: one warp per sample, lanes along C with 16-byte read-only loads
// (a warp covers 256 bf16 or 128 f32 channels per pass), the up to four
// cells read straight from the NHWC map, f32 accumulation in explicitly
// rounded steps (cell_weight, __fmaf_rn: the plain PyTorch version,
// cpm_tpu_torch/ops/deform_conv.py::deform_sample_plain, rounds at the same
// places but for the fused multiply-add), one 16-byte store per lane. Cells
// of zero weight are not read. The TPU kernel's 2-row x 16-column window,
// its 8-aligned origin and the W padding serve that chip's DMA alignment
// and have no counterpart.
//
// Backward: one warp per sample again. For the map, g * w_ij is added with
// float4 atomicAdd into a zero-filled f32 accumulator of the map's shape
// (blocks run in no order and samples overlap; the wrapper casts it once).
// For the coordinates, t_ij = <cell_ij, g> over C by a warp reduction, then
// gys = sum_ij t_ij * dwy_i * wx_j and gxs = sum_ij t_ij * wy_i * dwx_j with
// the tent's derivative dwy_i = -sign(y - row_i) on |y - row_i| < 1, which
// is zero at y == row_i and on a row past the last one.
//
// What bounds both on the H100 is bytes: out (forward) or g (backward) is
// K*K times the map, each element one multiply-add.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/deform_sample.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

constexpr int kWarpsPerBlock = kThreads / 32;

// One axis of a sample's window: the two cells and their tent weights, and
// (backward) the weights' derivatives by the coordinate.
struct Axis {
  int cell[2];
  float w[2];
  float dw[2];
};

__device__ __forceinline__ Axis tent_axis(float coord, int size) {
  Axis a;
  const int last_start = size >= 2 ? size - 2 : 0;
  const float f = floorf(coord);
  // the comparison keeps a NaN or huge coordinate inside the map
  const int start = f >= static_cast<float>(last_start) ? last_start
                    : (f > 0.0f ? static_cast<int>(f) : 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = start + i;
    const bool valid = c <= size - 1;
    const float d = __fsub_rn(coord, static_cast<float>(c));
    const float ad = fabsf(d);
    a.cell[i] = valid ? c : size - 1;
    a.w[i] = valid ? fmaxf(__fsub_rn(1.0f, ad), 0.0f) : 0.0f;
    a.dw[i] = (valid && ad < 1.0f) ? (d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f))
                                   : 0.0f;
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_fwd_kernel(const T* __restrict__ feat, int height, int width,
                             int channels, const float* __restrict__ ys,
                             const float* __restrict__ xs, long long samples,
                             long long per_image, T* __restrict__ out) {
  constexpr int kN = VecWidth<T>::kN;
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= samples) return;
  const long long image = s / per_image;
  const Axis ay = tent_axis(ys[s], height);
  const Axis ax = tent_axis(xs[s], width);
  const T* map = feat + image * height * width * channels;
  T* dst = out + s * channels;
  for (int c0 = lane * kN; c0 < channels; c0 += 32 * kN) {
    float acc[kN] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float w = cell_weight(ay.w[i], ax.w[j]);
        if (w != 0.0f) {
          accumulate(map + (static_cast<size_t>(ay.cell[i]) * width +
                            ax.cell[j]) * channels + c0,
                     w, acc);
        }
      }
    }
    store(dst + c0, acc);
  }
}

// grad_map: f32 accumulator [B, H, W, C], zero-filled by the caller, or null
// when the map needs no gradient; gys / gxs [B, P] f32, or both null when
// the coordinates need none.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_bwd_kernel(const T* __restrict__ feat, int height, int width,
                             int channels, const float* __restrict__ ys,
                             const float* __restrict__ xs,
                             const T* __restrict__ g, long long samples,
                             long long per_image, float* __restrict__ grad_map,
                             float* __restrict__ gys, float* __restrict__ gxs) {
  constexpr int kN = VecWidth<T>::kN;
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= samples) return;
  const long long image = s / per_image;
  const Axis ay = tent_axis(ys[s], height);
  const Axis ax = tent_axis(xs[s], width);
  const size_t map_offset =
      static_cast<size_t>(image) * height * width * channels;
  const T* src = g + s * channels;
  float t[2][2] = {};
  for (int c0 = lane * kN; c0 < channels; c0 += 32 * kN) {
    float gv[kN];
    load_scaled(src + c0, 1.0f, gv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float w = cell_weight(ay.w[i], ax.w[j]);
        if (w == 0.0f) continue;
        const size_t cell = map_offset +
                            (static_cast<size_t>(ay.cell[i]) * width +
                             ax.cell[j]) * channels + c0;
        if (grad_map != nullptr) scatter<kN>(grad_map + cell, w, gv);
        if (gys != nullptr) {
          float fv[kN];
          load_scaled(feat + cell, 1.0f, fv);
#pragma unroll
          for (int k = 0; k < kN; ++k) t[i][j] = __fmaf_rn(fv[k], gv[k], t[i][j]);
        }
      }
    }
  }
  if (gys == nullptr) return;
  float gy = 0.0f, gx = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = t[i][j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      gy += v * ay.dw[i] * ax.w[j];
      gx += v * ay.w[i] * ax.dw[j];
    }
  }
  if (lane == 0) {
    gys[s] = gy;
    gxs[s] = gx;
  }
}

inline bool bad_shape(int batch, int height, int width, int channels,
                      long long per_image, int dtype) {
  return batch < 1 || height < 1 || width < 1 || channels < 1 ||
         per_image < 1 || dtype < 0 || dtype > 1 ||
         channels % (dtype == 0 ? 4 : 8) != 0;
}

inline unsigned blocks_for(long long samples) {
  return static_cast<unsigned>((samples + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// feat [batch, height, width, channels] contiguous of `dtype` (0 = float32,
// 1 = bfloat16), ys / xs [batch, per_image] f32, out [batch, per_image,
// channels] of `dtype`; all device memory, 16-byte aligned, channels a
// multiple of 16 bytes' worth of elements. Returns the cudaError_t of the
// launch.
extern "C" int cpm_deform_sample_fwd(const void* feat, int batch, int height,
                                     int width, int channels, const void* ys,
                                     const void* xs, long long per_image,
                                     int dtype, void* out, void* stream) {
  if (bad_shape(batch, height, width, channels, per_image, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long samples = batch * per_image;
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    deform_sample_fwd_kernel<float><<<blocks_for(samples), kThreads, 0, s>>>(
        static_cast<const float*>(feat), height, width, channels, y, x, samples,
        per_image, static_cast<float*>(out));
  } else {
    deform_sample_fwd_kernel<__nv_bfloat16>
        <<<blocks_for(samples), kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(feat), height, width, channels, y,
            x, samples, per_image, static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// As above, with g [batch, per_image, channels] of `dtype`. grad_map: f32
// [batch, height, width, channels], zero-filled, or null; gys / gxs
// [batch, per_image] f32, or both null.
extern "C" int cpm_deform_sample_bwd(const void* feat, int batch, int height,
                                     int width, int channels, const void* ys,
                                     const void* xs, const void* g,
                                     long long per_image, int dtype,
                                     void* grad_map, void* gys, void* gxs,
                                     void* stream) {
  if (bad_shape(batch, height, width, channels, per_image, dtype) ||
      (gys == nullptr) != (gxs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long samples = batch * per_image;
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  float* gm = static_cast<float*>(grad_map);
  float* gy = static_cast<float*>(gys);
  float* gx = static_cast<float*>(gxs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    deform_sample_bwd_kernel<float><<<blocks_for(samples), kThreads, 0, s>>>(
        static_cast<const float*>(feat), height, width, channels, y, x,
        static_cast<const float*>(g), samples, per_image, gm, gy, gx);
  } else {
    deform_sample_bwd_kernel<__nv_bfloat16>
        <<<blocks_for(samples), kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(feat), height, width, channels, y,
            x, static_cast<const __nv_bfloat16*>(g), samples, per_image, gm, gy,
            gx);
  }
  return static_cast<int>(cudaGetLastError());
}
