// Cross-roi shared-window RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_pooler_crossroi.py::make_probe (body
// `body`, the call `run`): a single-level RoIAlign in which the G rois of
// grid step i all pool from the 64x64-cell window of roi i. Every roi comes
// with its window origin and its sample positions relative to its own
// origin (cpm_tpu_torch/ops/roi_align.py::crossroi_prep_rois, the port of
// `_prep_rois`); a position p weighs window cell c by relu(1 - |p - c|), and
// cells outside the window weigh zero. At G = 1 this is the windowed
// RoIAlign; at G > 1 the numbers are those of samples shifted into another
// roi's window, as the probe's are: it measures what sharing a window could
// save, and this kernel computes the same function
// (cpm_tpu_torch/ops/roi_align.py::crossroi_roi_align_plain).
//
// One CTA per (step, channel chunk). A chunk is 32 bytes of channels of
// every cell (16 bf16 or 8 f32 channels: 2 threads x 16 bytes). The CTA
// 1. finds the rows and columns of the window that its members' positions
//    reach (the largest position + 2, at most the window);
// 2. copies those cells of the leader's window into dynamic shared memory
//    with 16-byte loads (window * window * 32 bytes: 131,072 bytes at 64
//    cells, above the 48 KB default, so the launch opts in with
//    cudaFuncSetAttribute; one CTA fits an SM's 227 KB);
// 3. __syncthreads, then pools every member from shared memory, 2 threads
//    along the chunk's channels by 128 (member, bin) pairs at a time, f32
//    accumulation, and stores each result to the member's own output row.
// The TPU kernel's two batched hat-weight matmuls, its DMA double buffer and
// its 8-aligned column origin have no counterpart (the origin's alignment is
// kept in the prep, because it decides which cells the members share).
//
// What bounds it on the H100: bytes. Each step's window cells are read once,
// the output is written once; one multiply-add per shared-memory element.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/crossroi_roi_align.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

constexpr int kLanes = 2;  // threads along a chunk's channels, 16 bytes each

// The two window cells a relative position weighs and their hat weights;
// a cell outside [0, extent) weighs zero.
__device__ __forceinline__ void hat_axis(float pos, int extent, int* cell,
                                         float* w) {
  const float f = floorf(pos);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float c = f + static_cast<float>(i);
    const bool inside = c >= 0.0f && c < static_cast<float>(extent);
    cell[i] = inside ? static_cast<int>(c) : 0;
    w[i] = inside ? fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, c))), 0.0f)
                  : 0.0f;
  }
}

// How far into the window a position reaches: the cell after floor(pos),
// plus one; 0 for a position that weighs nothing.
__device__ __forceinline__ int reach(float pos, int window) {
  if (!(pos > -1.0f)) return 0;
  const float r = floorf(pos) + 2.0f;
  return r < static_cast<float>(window) ? static_cast<int>(r) : window;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    crossroi_roi_align_fwd_kernel(const T* __restrict__ feat, int batch,
                                  int height, int width, int channels,
                                  const int32_t* __restrict__ roi_batch,
                                  const int32_t* __restrict__ roi_y0,
                                  const int32_t* __restrict__ roi_x0,
                                  const float* __restrict__ ys,
                                  const float* __restrict__ xs, int group,
                                  int window, int pooled_h, int pooled_w,
                                  int sr, T* __restrict__ out) {
  constexpr int kN = VecWidth<T>::kN;
  extern __shared__ uint4 win[];  // [need_rows * need_cols][kLanes]
  __shared__ int need[2];

  const int step = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int c0 = (blockIdx.y * kLanes + lane) * kN;
  const bool has_channels = c0 < channels;
  const int sy = pooled_h * sr, sx = pooled_w * sr;
  const int bins = pooled_h * pooled_w;
  const size_t first = static_cast<size_t>(step) * group;

  if (tid < 2) need[tid] = 0;
  __syncthreads();
  int rows = 0, cols = 0;
  for (int k = tid; k < group * sy; k += kThreads) {
    rows = max(rows, reach(ys[first * sy + k], window));
  }
  for (int k = tid; k < group * sx; k += kThreads) {
    cols = max(cols, reach(xs[first * sx + k], window));
  }
  if (rows > 0) atomicMax(&need[0], rows);
  if (cols > 0) atomicMax(&need[1], cols);
  __syncthreads();
  const int need_rows = need[0], need_cols = need[1];

  // the leader's window: that of roi `step`, clamped into the map
  const int image = min(max(roi_batch[step], 0), batch - 1);
  const int wy0 = min(max(roi_y0[step], 0), height - window);
  const int wx0 = min(max(roi_x0[step], 0), width - window);
  const T* origin = feat + ((static_cast<size_t>(image) * height + wy0) * width +
                            wx0) * channels;
  if (has_channels) {
    for (int cell = tid / kLanes; cell < need_rows * need_cols;
         cell += kThreads / kLanes) {
      const int cy = cell / need_cols;
      const int cx = cell - cy * need_cols;
      const T* src = origin + (static_cast<size_t>(cy) * width + cx) * channels + c0;
      win[cell * kLanes + lane] = __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
  __syncthreads();
  if (!has_channels) return;

  const float count = static_cast<float>(sr * sr);
  for (int item = tid / kLanes; item < group * bins; item += kThreads / kLanes) {
    const int m = item / bins;
    const int bin = item - m * bins;
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    const float* my_ys = ys + (first + m) * sy;
    const float* my_xs = xs + (first + m) * sx;
    float acc[kN] = {};
    for (int iy = 0; iy < sr; ++iy) {
      int cy[2];
      float wy[2];
      hat_axis(my_ys[py * sr + iy], need_rows, cy, wy);
      for (int ix = 0; ix < sr; ++ix) {
        int cx[2];
        float wx[2];
        hat_axis(my_xs[px * sr + ix], need_cols, cx, wx);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float w = cell_weight(wy[a], wx[b]);
            if (w != 0.0f) {
              accumulate_bits<T>(win[(cy[a] * need_cols + cx[b]) * kLanes + lane],
                                 w, acc);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] /= count;
    store(out + ((first + m) * bins + bin) * channels + c0, acc);
  }
}

template <typename T>
cudaError_t launch(const T* feat, int batch, int height, int width,
                   int channels, const int32_t* roi_batch,
                   const int32_t* roi_y0, const int32_t* roi_x0,
                   const float* ys, const float* xs, int num_rois, int group,
                   int window, int pooled_h, int pooled_w, int sr, T* out,
                   cudaStream_t stream) {
  const int chunk = kLanes * VecWidth<T>::kN;
  const dim3 grid(num_rois / group, (channels + chunk - 1) / chunk);
  const size_t shared =
      static_cast<size_t>(window) * window * kLanes * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      crossroi_roi_align_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  crossroi_roi_align_fwd_kernel<T><<<grid, kThreads, shared, stream>>>(
      feat, batch, height, width, channels, roi_batch, roi_y0, roi_x0, ys, xs,
      group, window, pooled_h, pooled_w, sr, out);
  return cudaGetLastError();
}

}  // namespace

// feat [batch, height, width, channels] contiguous of `dtype` (0 = float32,
// 1 = bfloat16); roi_batch, roi_y0, roi_x0 [num_rois] int32; ys
// [num_rois, pooled_h * sr] and xs [num_rois, pooled_w * sr] f32 positions
// relative to each roi's own origin; out [num_rois, pooled_h, pooled_w,
// channels] of `dtype`; all device memory, 16-byte aligned. num_rois must be
// a multiple of group, the map at least window x window cells, window *
// window * 32 bytes at most 227 KB, channels a multiple of 16 bytes' worth
// of elements. Returns the cudaError_t of the launch.
extern "C" int cpm_crossroi_roi_align_fwd(
    const void* feat, int batch, int height, int width, int channels,
    const void* roi_batch, const void* roi_y0, const void* roi_x0,
    const void* ys, const void* xs, int num_rois, int group, int window,
    int pooled_h, int pooled_w, int sampling_ratio, int dtype, void* out,
    void* stream) {
  if (batch < 1 || channels < 1 || num_rois < 1 || group < 1 ||
      num_rois % group != 0 || window < 1 || height < window ||
      width < window || sampling_ratio < 1 || pooled_h < 1 || pooled_w < 1 ||
      dtype < 0 || dtype > 1 || channels % (dtype == 0 ? 4 : 8) != 0 ||
      static_cast<size_t>(window) * window * kLanes * sizeof(uint4) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* rb = static_cast<const int32_t*>(roi_batch);
  const int32_t* ry = static_cast<const int32_t*>(roi_y0);
  const int32_t* rx = static_cast<const int32_t*>(roi_x0);
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(static_cast<const float*>(feat), batch, height, width,
                        channels, rb, ry, rx, y, x, num_rois, group, window,
                        pooled_h, pooled_w, sampling_ratio,
                        static_cast<float*>(out), s);
  } else {
    err = launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(feat), batch,
                                height, width, channels, rb, ry, rx, y, x,
                                num_rois, group, window, pooled_h, pooled_w,
                                sampling_ratio,
                                static_cast<__nv_bfloat16*>(out), s);
  }
  return static_cast<int>(err);
}
