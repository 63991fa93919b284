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
// It is the multilevel forward's loop (roi_align_forward.cuh) at one level:
// a one-entry LevelTable, no level ids, no mask (kSingle), not aligned, so
// it reads the same cells with the same weights in the same order as the
// multilevel forward does at one level, and gives its bits. What bounds it
// on the H100: bytes. At the C4 shape ([2, 50, 84, 1024] f32, 1024 rois)
// the output (1024 x 49 x 1024 x 4 B = 205 MB at 7x7) is six times the map
// (34 MB), so the stores set the bound and the gathers mostly hit L2. A roi
// and C tile take one block: four C tiles already give 4096 blocks at 1024
// rois, and spreading the bins further lost; evict-first stores, no
// register cap and six blocks an SM moved it by a few percent at most and
// were not kept (PERF.md). The TPU kernel
// copies whole map rows per sample row and interpolates by a one-hot matmul
// because its core has no gather; none of that carries over.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/roi_align.py).

#include "roi_align_forward.cuh"

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
  using namespace cpm;
  if (batch < 1 || height < 1 || width < 1 || channels < 1 || num_rois < 1 ||
      !forward_fits(pooled_h, pooled_w, sampling_ratio)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelTable table = {};
  table.ptr[0] = features;
  table.heights[0] = height;
  table.widths[0] = width;
  table.scales[0] = spatial_scale;
  return static_cast<int>(
      launch_roi_align_forward<float, /*kSingle=*/true>(
          table, /*num_levels=*/1, batch, channels,
          static_cast<const float*>(rois), /*roi_levels=*/nullptr,
          /*valid=*/nullptr, num_rois, pooled_h, pooled_w, sampling_ratio,
          /*aligned=*/0, static_cast<float*>(out),
          static_cast<cudaStream_t>(stream)));
}
