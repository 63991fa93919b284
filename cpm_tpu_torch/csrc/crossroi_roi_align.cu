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
// What bounds it on the H100: bytes. At best the map cells the members weigh
// are read once and the output is written once; one multiply-add per element
// of each weighed cell. The TPU kernel copies the window into VMEM because
// its core has no gather. Here the kernel is a gather through L1, as the
// multilevel forward is (roi_align_forward.cuh), with nothing staged but the
// samples:
// - a step's items, (bin, member) pairs taken bin by bin, so that the
//   members' reads of one neighbourhood of the leader's window meet in one
//   block's L1, are spread evenly over the fewest blocks that give a row of
//   threads at most kItemsPerRow of them;
// - threads along C, 16 bytes each, at most kLanes of them (128 bytes of a
//   cell), the rest in rows; further C tiles are further blocks;
// - each block stages its members' axis samples once (the two window cells
//   a position weighs, clamped into the window, and their hat weights);
// - a thread keeps one sample's four 16-byte loads in flight, and no shared
//   memory beyond the samples limits how many blocks fit an SM (five).
// Every launch shape measured takes one time: each sample's four cells are
// requested from L1 at any G, and L2 serves most of them. Staging the
// members' rows in shared memory through a two-stage TMA ring lost 3-4x
// (PERF.md). One thread sums each output element's 16 taps in the order
// (y sample, x sample, y cell, x cell), each weighed by cell_weight and
// added when its weight is not zero, then divides by sr^2: the bits of the
// window-staging kernel this one replaced.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/crossroi_roi_align.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

constexpr int kLanes = 8;        // threads along C at most: 128 bytes of a cell
constexpr int kItemsPerRow = 4;  // (bin, member) items a row of threads at most

// One axis sample of a member: the two window cells its position weighs,
// floor(pos) and the next, each clamped into the window so that a load of it
// stays there, and their hat weights, zero for a cell outside the window; lo
// is -1 when both weights are zero (the sample adds nothing).
__device__ __forceinline__ AxisSample hat_sample(float pos, int window) {
  const float f = floorf(pos);
  int cell[2];
  float w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float c = f + static_cast<float>(i);
    const bool inside = c >= 0.0f && c < static_cast<float>(window);
    cell[i] = inside ? static_cast<int>(c) : 0;
    w[i] = inside ? fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, c))), 0.0f)
                  : 0.0f;
  }
  AxisSample s;
  s.lo = (w[0] == 0.0f && w[1] == 0.0f) ? -1 : cell[0];
  s.hi = cell[1];
  s.w_lo = w[0];
  s.w_hi = w[1];
  return s;
}

// Block (tx, ty): tx threads along C, ty rows of items. Block x of the grid
// pools items [slice * span, slice * span + span) of step x / slices, item
// bin * group + member; block y is the C tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
    crossroi_roi_align_fwd_kernel(const T* __restrict__ feat, int batch,
                                  int height, int width, int channels,
                                  const int32_t* __restrict__ roi_batch,
                                  const int32_t* __restrict__ roi_y0,
                                  const int32_t* __restrict__ roi_x0,
                                  const float* __restrict__ ys,
                                  const float* __restrict__ xs, int group,
                                  int window, int pooled_h, int pooled_w,
                                  int sr, int slices, int span,
                                  T* __restrict__ out) {
  extern __shared__ AxisSample axis[];  // per member: rows, then columns
  constexpr int kN = VecWidth<T>::kN;
  const int step = blockIdx.x / slices;
  const int bins = pooled_h * pooled_w;
  const int first = (blockIdx.x - step * slices) * span;
  const int last = min(first + span, group * bins);
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kN;
  const bool has_channels = c0 < channels;
  const int rows = pooled_h * sr;
  const int cols = pooled_w * sr;
  const int per = rows + cols;
  const size_t lead = static_cast<size_t>(step) * group;

  // every member's samples, positions relative to its own origin
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < group * per;
       i += blockDim.x * blockDim.y) {
    const int m = i / per;
    const int k = i - m * per;
    const float pos = k < rows ? ys[(lead + m) * rows + k]
                               : xs[(lead + m) * cols + (k - rows)];
    axis[i] = hat_sample(pos, window);
  }
  __syncthreads();
  if (!has_channels) return;

  // the leader's window: that of roi `step`, clamped into the map; cells
  // within it are addressed by 32-bit offsets (the launch checks that a
  // window's rows fit them)
  const int image = min(max(roi_batch[step], 0), batch - 1);
  const int wy0 = min(max(roi_y0[step], 0), height - window);
  const int wx0 = min(max(roi_x0[step], 0), width - window);
  const T* origin =
      feat + ((static_cast<size_t>(image) * height + wy0) * width + wx0) *
                 channels + c0;
  const int pitch = width * channels;
  const float count = static_cast<float>(sr * sr);
  for (int item = first + threadIdx.y; item < last; item += blockDim.y) {
    const int bin = item / group;
    const int m = item - bin * group;
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    const AxisSample* my_ys = axis + m * per + py * sr;
    const AxisSample* my_xs = axis + m * per + rows + px * sr;
    float acc[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] = 0.0f;
    for (int iy = 0; iy < sr; ++iy) {
      const AxisSample y = my_ys[iy];
      if (y.lo < 0) continue;
      const T* lo_row = origin + y.lo * pitch;
      const T* hi_row = origin + y.hi * pitch;
      for (int ix = 0; ix < sr; ++ix) {
        const AxisSample x = my_xs[ix];
        if (x.lo < 0) continue;
        const int a = x.lo * channels;
        const int b = x.hi * channels;
        const uint4 v0 = load16(lo_row + a);
        const uint4 v1 = load16(lo_row + b);
        const uint4 v2 = load16(hi_row + a);
        const uint4 v3 = load16(hi_row + b);
        float w = cell_weight(y.w_lo, x.w_lo);
        if (w != 0.0f) accumulate_bits<T>(v0, w, acc);
        w = cell_weight(y.w_lo, x.w_hi);
        if (w != 0.0f) accumulate_bits<T>(v1, w, acc);
        w = cell_weight(y.w_hi, x.w_lo);
        if (w != 0.0f) accumulate_bits<T>(v2, w, acc);
        w = cell_weight(y.w_hi, x.w_hi);
        if (w != 0.0f) accumulate_bits<T>(v3, w, acc);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] /= count;
    store(out + ((lead + m) * bins + bin) * channels + c0, acc);
  }
}

// The staged samples of a step's members: at most the 48 KB a block has
// without opting in.
inline size_t staged_bytes(int group, int pooled_h, int pooled_w, int sr) {
  return static_cast<size_t>(group) * (pooled_h + pooled_w) * sr *
         sizeof(AxisSample);
}

template <typename T>
cudaError_t launch(const T* feat, int batch, int height, int width,
                   int channels, const int32_t* roi_batch,
                   const int32_t* roi_y0, const int32_t* roi_x0,
                   const float* ys, const float* xs, int num_rois, int group,
                   int window, int pooled_h, int pooled_w, int sr, T* out,
                   cudaStream_t stream) {
  const int vecs = channels / VecWidth<T>::kN;
  const int tx = vecs < kLanes ? vecs : kLanes;
  const dim3 block(tx, kThreads / tx);
  const int items = group * pooled_h * pooled_w;
  const int most = kItemsPerRow * static_cast<int>(block.y);
  const int slices = (items + most - 1) / most;
  const int span = (items + slices - 1) / slices;
  const dim3 grid((num_rois / group) * slices, (vecs + tx - 1) / tx);
  crossroi_roi_align_fwd_kernel<T>
      <<<grid, block, staged_bytes(group, pooled_h, pooled_w, sr), stream>>>(
          feat, batch, height, width, channels, roi_batch, roi_y0, roi_x0, ys,
          xs, group, window, pooled_h, pooled_w, sr, slices, span, out);
  return cudaGetLastError();
}

}  // namespace

// feat [batch, height, width, channels] contiguous of `dtype` (0 = float32,
// 1 = bfloat16); roi_batch, roi_y0, roi_x0 [num_rois] int32; ys
// [num_rois, pooled_h * sr] and xs [num_rois, pooled_w * sr] f32 positions
// relative to each roi's own origin; out [num_rois, pooled_h, pooled_w,
// channels] of `dtype`; all device memory, 16-byte aligned. num_rois must be
// a multiple of group, the map at least window x window cells, channels a
// multiple of 16 bytes' worth of elements, window x width x channels below
// 2^31, and a step's staged samples, group * (pooled_h + pooled_w) * sr * 16
// bytes, at most 48 KB. Returns the cudaError_t of the launch.
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
      static_cast<long long>(window) * width * channels >= (1LL << 31) ||
      staged_bytes(group, pooled_h, pooled_w, sampling_ratio) > 48 * 1024) {
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
