// Cluster-batched multilevel RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel cpm_tpu/ops/pallas/clustered_pallas.py::
// multilevel_roi_align_clustered (_cl_fwd/_cl_fwd_body). Rois of one image
// and level whose bilinear supports begin in the same lattice cell are
// grouped (cpm_tpu_torch/ops/roi_align.py::cluster_rois, torch ops on the
// device); the point of the kernel is that a group's shared cells are read
// from device memory once for the whole group. It computes what the
// multilevel kernel (multilevel_roi_align.cu) computes, from the same device
// functions (roi_align_common.cuh).
//
// One CTA per (group, channel chunk). A chunk is 128 bytes of channels of
// every cell (64 bf16 or 32 f32 channels: 8 threads x 16 bytes). The CTA
// 1. copies the union rectangle of its members' supports, which the grouping
//    bounds by `tile` x `tile` cells, from the group's level into dynamic
//    shared memory with coalesced 16-byte loads (tile * tile * 128 bytes:
//    73,728 bytes at tile 24, above the 48 KB default, so the launch opts in
//    with cudaFuncSetAttribute; three CTAs fit one SM's 227 KB);
// 2. __syncthreads;
// 3. pools every member roi from shared memory, 8 threads along the chunk's
//    channels by 32 (member, bin) pairs at a time, f32 accumulation, and
//    stores each result straight to the member's own output row: no sorted
//    output and no inverse gather.
// A cell outside the copied rectangle is read from device memory instead.
// That serves a singleton group whose support exceeds the tile (extreme
// aspect ratios, whole-map rois at the coarsest level), so the result is
// exact for every roi, and it makes the kernel's result independent of the
// rectangle the grouping computed. Slot s of the sorted order belongs to
// block s as well: when its roi is masked, the block writes that roi's row
// as zeros, so every output row is written by exactly one block and no fill
// is needed.
//
// What bounds it on the H100: bytes. Each group's rectangle is read once,
// the output is written once; the arithmetic is one multiply-add per
// shared-memory element read. The grid has one block per sorted slot,
// although there are fewer groups than slots: a block without a group and
// without a masked roi returns at once (the TPU kernel bounds its sequential
// grid and falls back to the per-roi kernel when the groups outnumber it;
// here no such fallback exists). The TPU kernel's 64-cell window, its
// batched hat-weight matmul and its DMA rings have no counterpart.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/clustered_roi_align.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

constexpr int kMaxGroup = 16;
constexpr int kLanes = 8;  // threads along a chunk's channels, 16 bytes each
constexpr int kGroupFields = 8;

struct LevelTable {
  const void* ptr[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename T>
__device__ __forceinline__ void accumulate_bits(const uint4& raw, float w,
                                                float* acc);
template <>
__device__ __forceinline__ void accumulate_bits<float>(const uint4& raw,
                                                       float w, float* acc) {
  accumulate_raw(*reinterpret_cast<const float4*>(&raw), w, acc);
}
template <>
__device__ __forceinline__ void accumulate_bits<__nv_bfloat16>(
    const uint4& raw, float w, float* acc) {
  accumulate_raw(raw, w, acc);
}

// groups: [num_rois, 8] int32 rows (first slot, size, level, batch, y0, x0,
// rows, cols) of group g; size 0 for g beyond the last group. order:
// [num_rois] int32, sorted slot -> roi.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    clustered_roi_align_fwd_kernel(LevelTable levels, int num_levels,
                                   int batch, int channels,
                                   const float* __restrict__ rois,
                                   const uint8_t* __restrict__ valid,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ groups,
                                   int num_rois, int tile, int pooled_h,
                                   int pooled_w, int sr, int aligned,
                                   T* __restrict__ out) {
  constexpr int kN = VecWidth<T>::kN;
  extern __shared__ uint4 tile_cells[];  // [rows * cols][kLanes]
  __shared__ RoiBox boxes[kMaxGroup];
  __shared__ int members[kMaxGroup];

  const int slot = blockIdx.x;
  const int lane = threadIdx.x;
  const int c0 = (blockIdx.y * kLanes + lane) * kN;
  const bool has_channels = c0 < channels;
  const int bins = pooled_h * pooled_w;

  // the masked roi at this slot, if any: its row is zeros
  const int slot_roi = min(max(order[slot], 0), num_rois - 1);
  if (!valid[slot_roi] && has_channels) {
    const float zeros[kN] = {};
    T* row = out + static_cast<size_t>(slot_roi) * bins * channels + c0;
    for (int bin = threadIdx.y; bin < bins; bin += blockDim.y) {
      store(row + static_cast<size_t>(bin) * channels, zeros);
    }
  }

  const int32_t* grp = groups + static_cast<size_t>(slot) * kGroupFields;
  const int first = grp[0];
  const int size = min(grp[1], kMaxGroup);
  if (size <= 0 || first < 0 || first + size > num_rois) return;
  const int level = min(max(grp[2], 0), num_levels - 1);
  const int image = min(max(grp[3], 0), batch - 1);
  const int H = levels.height[level];
  const int W = levels.width[level];
  const int ty0 = grp[4], tx0 = grp[5], rows = grp[6], cols = grp[7];
  // a rectangle that does not fit the tile or the map is not copied: every
  // read then goes to device memory
  const bool use_tile = rows > 0 && cols > 0 && rows <= tile && cols <= tile &&
                        ty0 >= 0 && tx0 >= 0 && ty0 + rows <= H &&
                        tx0 + cols <= W;
  const T* feat = static_cast<const T*>(levels.ptr[level]) +
                  static_cast<size_t>(image) * H * W * channels;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < size) {
    const int r = min(max(order[first + tid], 0), num_rois - 1);
    members[tid] = r;
    boxes[tid] = roi_box(rois + static_cast<size_t>(r) * 5,
                         levels.scale[level], batch, pooled_h, pooled_w,
                         aligned);
  }
  if (use_tile && has_channels) {
    for (int cell = threadIdx.y; cell < rows * cols; cell += blockDim.y) {
      const int cy = cell / cols;
      const int cx = cell - cy * cols;
      const T* src =
          feat + (static_cast<size_t>(ty0 + cy) * W + (tx0 + cx)) * channels +
          c0;
      tile_cells[cell * kLanes + lane] =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
  __syncthreads();
  if (!has_channels) return;

  const float count = static_cast<float>(sr * sr);
  for (int item = threadIdx.y; item < size * bins; item += blockDim.y) {
    const int m = item / bins;
    const int bin = item - m * bins;
    const int py = bin / pooled_w;
    const int px = bin - py * pooled_w;
    const RoiBox box = boxes[m];
    float acc[kN] = {};
    for (int iy = 0; iy < sr; ++iy) {
      int y_lo, y_hi;
      float wy_lo, wy_hi;
      const float y = sample_coord(box.y1, py * sr + iy, sr, box.bin_h);
      if (!bilinear_1d(y, H, &y_lo, &y_hi, &wy_lo, &wy_hi)) continue;
      for (int ix = 0; ix < sr; ++ix) {
        int x_lo, x_hi;
        float wx_lo, wx_hi;
        const float x = sample_coord(box.x1, px * sr + ix, sr, box.bin_w);
        if (!bilinear_1d(x, W, &x_lo, &x_hi, &wx_lo, &wx_hi)) continue;
        const int ys[2] = {y_lo, y_hi};
        const int xs[2] = {x_lo, x_hi};
        const float wy[2] = {wy_lo, wy_hi};
        const float wx[2] = {wx_lo, wx_hi};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int ry = ys[a] - ty0;
            const int rx = xs[b] - tx0;
            const float w = cell_weight(wy[a], wx[b]);
            if (use_tile && ry >= 0 && ry < rows && rx >= 0 && rx < cols) {
              accumulate_bits<T>(tile_cells[(ry * cols + rx) * kLanes + lane],
                                 w, acc);
            } else {
              accumulate(
                  feat + (static_cast<size_t>(ys[a]) * W + xs[b]) * channels +
                      c0,
                  w, acc);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] /= count;
    store(out + (static_cast<size_t>(members[m]) * bins + bin) * channels + c0,
          acc);
  }
}

template <typename T>
cudaError_t launch(const LevelTable& table, int num_levels, int batch,
                   int channels, const float* rois, const uint8_t* valid,
                   const int32_t* order, const int32_t* groups, int num_rois,
                   int tile, int pooled_h, int pooled_w, int sr, int aligned,
                   T* out, cudaStream_t stream) {
  const int chunk = kLanes * VecWidth<T>::kN;
  const dim3 block(kLanes, kThreads / kLanes);
  const dim3 grid(num_rois, (channels + chunk - 1) / chunk);
  const size_t shared = static_cast<size_t>(tile) * tile * kLanes * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      clustered_roi_align_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  clustered_roi_align_fwd_kernel<T><<<grid, block, shared, stream>>>(
      table, num_levels, batch, channels, rois, valid, order, groups, num_rois,
      tile, pooled_h, pooled_w, sr, aligned, out);
  return cudaGetLastError();
}

}  // namespace

// level_ptrs, level_hw ([h0, w0, h1, w1, ...]) and level_scales are host
// arrays of num_levels entries; every other pointer is device memory.
// Levels are [batch, H_l, W_l, channels] contiguous of `dtype` (0 = float32,
// 1 = bfloat16), rois [num_rois, 5] f32, valid [num_rois] bytes, order
// [num_rois] int32 (sorted slot -> roi, a permutation), groups
// [num_rois, 8] int32 as the kernel's comment sets out, out
// [num_rois, pooled_h, pooled_w, channels] of `dtype`. tile: the side, in
// cells, of the largest rectangle a group copies into shared memory
// (tile * tile * 128 bytes, at most 227 KB). channels must be a multiple of
// 16 bytes' worth of elements and every pointer 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int cpm_clustered_roi_align_fwd(
    const void* level_ptrs, const void* level_hw, const void* level_scales,
    int num_levels, int batch, int channels, const void* rois,
    const void* valid, const void* order, const void* groups, int num_rois,
    int tile, int pooled_h, int pooled_w, int sampling_ratio, int aligned,
    int dtype, void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
      channels < 1 || sampling_ratio < 1 || dtype < 0 || dtype > 1 ||
      tile < 1 || tile * tile * kLanes * sizeof(uint4) > 232448) {
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
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int32_t* o = static_cast<const int32_t*>(order);
  const int32_t* g = static_cast<const int32_t*>(groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(table, num_levels, batch, channels, r, v, o, g,
                        num_rois, tile, pooled_h, pooled_w, sampling_ratio,
                        aligned, static_cast<float*>(out), s);
  } else {
    err = launch<__nv_bfloat16>(table, num_levels, batch, channels, r, v, o, g,
                                num_rois, tile, pooled_h, pooled_w,
                                sampling_ratio, aligned,
                                static_cast<__nv_bfloat16*>(out), s);
  }
  return static_cast<int>(err);
}
