// Single-level RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel cpm_tpu/ops/pallas/roi_align_pallas.py::
// roi_align_pallas_fwd (the forward of roi_align_tpu; body _kernel_body). It
// computes that kernel's function exactly: rois scaled by `spatial_scale`,
// roi_w = max(x2 - x1, 1) (not aligned), `sampling_ratio` x `sampling_ratio`
// bilinear samples per bin, a sample with y < -1 or y > H (x likewise) reads
// zero and every other one is clamped into the map, and the bin is their
// mean. Input and output are float32 (the caller casts a bf16 map, as the
// TPU wrapper does); there is no mask.
//
// What bounds it on the H100: bytes. At the C4 shape ([2, 50, 84, 1024] f32,
// 1024 rois) the output (1024 x 49 x 1024 x 4 B = 205 MB at 7x7) is far
// larger than the map (34 MB), so the stores set the bound and the gathers
// mostly hit L2. One CTA per roi and C tile, threads along C with 16-byte
// read-only loads, f32 accumulation, only the four cells of each sample
// read. The TPU kernel copies whole map rows per sample row and
// interpolates by a one-hot matmul because its core has no gather; none of
// that carries over.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/roi_align.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(const float* __restrict__ features, int batch,
                         int height, int width, int channels, float scale,
                         const float* __restrict__ rois, int pooled_h,
                         int pooled_w, int sr, float* __restrict__ out) {
  constexpr int kN = VecWidth<float>::kN;
  const int r = blockIdx.x;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kN;
  if (c0 >= channels) return;
  const int bins = pooled_h * pooled_w;
  const RoiBox box = roi_box(rois + static_cast<size_t>(r) * 5, scale, batch,
                             pooled_h, pooled_w, /*aligned=*/0);
  const float count = static_cast<float>(sr * sr);
  const size_t row_stride = static_cast<size_t>(width) * channels;
  const float* image =
      features + static_cast<size_t>(box.batch) * height * row_stride + c0;
  float* out_roi = out + static_cast<size_t>(r) * bins * channels + c0;

  for (int bin = threadIdx.y; bin < bins; bin += blockDim.y) {
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    float acc[kN] = {};
    for (int iy = 0; iy < sr; ++iy) {
      int y_lo, y_hi;
      float wy_lo, wy_hi;
      const float y = sample_coord(box.y1, py * sr + iy, sr, box.bin_h);
      if (!bilinear_1d(y, height, &y_lo, &y_hi, &wy_lo, &wy_hi)) continue;
      const float* row_lo = image + y_lo * row_stride;
      const float* row_hi = image + y_hi * row_stride;
      for (int ix = 0; ix < sr; ++ix) {
        int x_lo, x_hi;
        float wx_lo, wx_hi;
        const float x = sample_coord(box.x1, px * sr + ix, sr, box.bin_w);
        if (!bilinear_1d(x, width, &x_lo, &x_hi, &wx_lo, &wx_hi)) continue;
        const size_t lo = static_cast<size_t>(x_lo) * channels;
        const size_t hi = static_cast<size_t>(x_hi) * channels;
        accumulate(row_lo + lo, cell_weight(wy_lo, wx_lo), acc);
        accumulate(row_lo + hi, cell_weight(wy_lo, wx_hi), acc);
        accumulate(row_hi + lo, cell_weight(wy_hi, wx_lo), acc);
        accumulate(row_hi + hi, cell_weight(wy_hi, wx_hi), acc);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] /= count;
    store(out_roi + static_cast<size_t>(bin) * channels, acc);
  }
}

}  // namespace

// features [batch, height, width, channels] float32 contiguous, rois
// [num_rois, 5] float32 (batch index, x1, y1, x2, y2 in image coordinates),
// out [num_rois, pooled_h, pooled_w, channels] float32: all device memory,
// 16-byte aligned; channels a multiple of 4. Returns the cudaError_t of the
// launch.
extern "C" int cpm_roi_align_fwd(const void* features, int batch, int height,
                                 int width, int channels, float spatial_scale,
                                 const void* rois, int num_rois, int pooled_h,
                                 int pooled_w, int sampling_ratio, void* out,
                                 void* stream) {
  if (batch < 1 || height < 1 || width < 1 || channels < 1 || num_rois < 1 ||
      pooled_h < 1 || pooled_w < 1 || sampling_ratio < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid, block;
  roi_launch_shape<float>(channels, num_rois, &grid, &block);
  roi_align_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(features), batch, height, width, channels,
      spatial_scale, static_cast<const float*>(rois), pooled_h, pooled_w,
      sampling_ratio, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
