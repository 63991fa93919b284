// Device functions shared by every RoIAlign kernel of the port
// (multilevel_roi_align.cu, stacked_roi_align.cu, clustered_roi_align.cu,
// roi_align.cu, crossroi_roi_align.cu) and the deformable-conv sampler
// (deform_sample.cu): 16-byte vector loads and stores, the roi's box on its
// level, the sample coordinates and the bilinear cells and weights. Every
// kernel takes them from here, so that all of them read the same cells with
// the same weights as the plain PyTorch versions
// (cpm_tpu_torch/ops/roi_align.py) do, and every backward adds into exactly
// the cells its forward read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpm {

constexpr int kMaxLevels = 5;
constexpr int kThreads = 256;

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

// The weight of one of a sample's four cells. Like the multiply-adds below
// it is an explicitly rounded operation, so that every forward kernel
// rounds at the same places whatever the compiler would fuse: the stacked
// and the clustered forward then give the multilevel forward's bits.
__device__ __forceinline__ float cell_weight(float wy, float wx) {
  return __fmul_rn(wy, wx);
}

// acc += w * (one 16-byte vector of a raw 16-byte load)
__device__ __forceinline__ void accumulate_raw(const float4& v, float w,
                                               float* acc) {
  acc[0] = __fmaf_rn(w, v.x, acc[0]);
  acc[1] = __fmaf_rn(w, v.y, acc[1]);
  acc[2] = __fmaf_rn(w, v.z, acc[2]);
  acc[3] = __fmaf_rn(w, v.w, acc[3]);
}

__device__ __forceinline__ void accumulate_raw(const uint4& raw, float w,
                                               float* acc) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc[2 * k] = __fmaf_rn(w, f.x, acc[2 * k]);
    acc[2 * k + 1] = __fmaf_rn(w, f.y, acc[2 * k + 1]);
  }
}

// acc += w * (the 16-byte vector at p in global memory, read-only path)
__device__ __forceinline__ void accumulate(const float* p, float w,
                                           float* acc) {
  accumulate_raw(__ldg(reinterpret_cast<const float4*>(p)), w, acc);
}

__device__ __forceinline__ void accumulate(const __nv_bfloat16* p, float w,
                                           float* acc) {
  accumulate_raw(__ldg(reinterpret_cast<const uint4*>(p)), w, acc);
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

// v = s * (the 16-byte vector at p)
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

// The eight channels a lane owns in the backward kernels' shared-memory
// tiles: v[0..8) = the eight elements at p (16-byte aligned), read-only
// path. For float32, `full` false reads only the first four (a channel count
// that is 4 mod 8) and zeroes the rest; bf16 channel counts are multiples of
// eight.
__device__ __forceinline__ void load8(const float* p, bool full, float* v) {
  load_scaled(p, 1.0f, v);
  if (full) {
    load_scaled(p + 4, 1.0f, v + 4);
  } else {
    v[4] = v[5] = v[6] = v[7] = 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool, float* v) {
  load_scaled(p, 1.0f, v);
}

__device__ __forceinline__ void store8(float* p, bool full, const float* v) {
  store(p, v);
  if (full) store(p + 4, v + 4);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, bool, const float* v) {
  store(p, v);
}

// One cell of a backward kernel's float32 tile in shared memory, as a lane
// sees it: its eight channels are two float4, each half of the warp's 256
// channels contiguous across the lanes, so that a warp's accesses do not
// conflict. acc[k] += w * v[k].
__device__ __forceinline__ void add8(float4* cell, int lane, float w,
                                     const float* v) {
  float4 a = cell[lane];
  float4 b = cell[32 + lane];
  a.x = __fmaf_rn(w, v[0], a.x);
  a.y = __fmaf_rn(w, v[1], a.y);
  a.z = __fmaf_rn(w, v[2], a.z);
  a.w = __fmaf_rn(w, v[3], a.w);
  b.x = __fmaf_rn(w, v[4], b.x);
  b.y = __fmaf_rn(w, v[5], b.y);
  b.z = __fmaf_rn(w, v[6], b.z);
  b.w = __fmaf_rn(w, v[7], b.w);
  cell[lane] = a;
  cell[32 + lane] = b;
}

__device__ __forceinline__ void read8(const float4* cell, int lane, float* v) {
  const float4 a = cell[lane];
  const float4 b = cell[32 + lane];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

// The float4s of one cell of such a tile: 2 x 32.
constexpr int kCellVecs = 64;

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

// A roi on a map of scale `scale`: its batch image, its origin and its bin
// size in cells.
struct RoiBox {
  int batch;
  float x1;
  float y1;
  float bin_w;
  float bin_h;
};

// The batch id is clamped so that a malformed roi cannot touch memory
// outside the maps; the model always passes ids in range. Coordinates use
// explicitly rounded operations, which nvcc never fuses into an FMA: they
// then round exactly as the plain version's separate tensor ops do, so the
// kernels and the plain versions touch the same cells with the same weights.
__device__ __forceinline__ RoiBox roi_box(const float* __restrict__ roi,
                                          float scale, int batch,
                                          int pooled_h, int pooled_w,
                                          int aligned) {
  RoiBox g;
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

// One sample of a roi along one axis, as the forward kernels stage it in
// shared memory: its two cells and their weights; lo is -1 for a sample
// that is out of bounds (it reads zero).
struct AxisSample {
  int lo;
  int hi;
  float w_lo;
  float w_hi;
};

// Sample `index` (over bins x samples per bin) of an axis that starts at
// `start` with bins of `bin` cells, on an axis of `size` cells: exactly
// what sample_coord and bilinear_1d give for it.
__device__ __forceinline__ AxisSample axis_sample(float start, int index,
                                                  int sr, float bin,
                                                  int size) {
  AxisSample a;
  if (!bilinear_1d(sample_coord(start, index, sr, bin), size, &a.lo, &a.hi,
                   &a.w_lo, &a.w_hi)) {
    a.lo = -1;
  }
  return a;
}

// acc += w * (16 bytes of T held as a uint4)
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

// The 16 bytes at p in global memory, read-only path.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One bin of a forward kernel: acc = the mean of its sr x sr bilinear
// samples, from the staged samples ys[0..sr) and xs[0..sr) of the bin;
// load(y, x) returns the thread's 16 bytes of cell (y, x). Every forward
// kernel sums in this one order: y sample, x sample, then the four cells
// (lo, lo), (lo, hi), (hi, lo), (hi, hi), each weighed by cell_weight; then
// divides by sr^2. A sample's four cells are loaded before they are added,
// so four 16-byte loads are in flight; two samples' eight need registers
// that cost the kernels a block an SM, and lost on the card.
template <typename T, typename Load>
__device__ __forceinline__ void pool_bin(const AxisSample* ys,
                                         const AxisSample* xs, int sr,
                                         Load load, float* acc) {
  constexpr int kN = VecWidth<T>::kN;
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.0f;
  for (int iy = 0; iy < sr; ++iy) {
    const AxisSample y = ys[iy];
    if (y.lo < 0) continue;
    for (int ix = 0; ix < sr; ++ix) {
      const AxisSample x = xs[ix];
      if (x.lo < 0) continue;
      const uint4 v0 = load(y.lo, x.lo);
      const uint4 v1 = load(y.lo, x.hi);
      const uint4 v2 = load(y.hi, x.lo);
      const uint4 v3 = load(y.hi, x.hi);
      accumulate_bits<T>(v0, cell_weight(y.w_lo, x.w_lo), acc);
      accumulate_bits<T>(v1, cell_weight(y.w_lo, x.w_hi), acc);
      accumulate_bits<T>(v2, cell_weight(y.w_hi, x.w_lo), acc);
      accumulate_bits<T>(v3, cell_weight(y.w_hi, x.w_hi), acc);
    }
  }
  const float count = static_cast<float>(sr * sr);
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] /= count;
}

// Opts `kernel` in to `bytes` of dynamic shared memory on the current
// device unless opted[device] says it already is: the call costs the host
// microseconds, too much to repeat at every launch. Each launch function
// keeps its own `static int opted[kMaxDevices]`.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline cudaError_t opt_in_shared(Kernel* kernel, int bytes, int* opted) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[device] == bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) opted[device] = bytes;
  return err;
}

// Threads along C (16 bytes each, at most 64 of them) by bins, and the C
// tiles of the grid's y dimension: the launch shape of the one-CTA-per-roi
// kernels.
template <typename T>
inline void roi_launch_shape(int channels, int num_rois, dim3* grid,
                             dim3* block) {
  const int vecs = channels / VecWidth<T>::kN;
  const int tx = vecs < 64 ? vecs : 64;
  *block = dim3(tx, kThreads / tx);
  *grid = dim3(num_rois, (vecs + tx - 1) / tx);
}

}  // namespace cpm
