// The RPN's pre-NMS candidates for Hopper (sm_90a): every level's top-k
// anchors of every image, decoded, clipped and checked for size in one
// launch.
//
// Replaces no TPU kernel. In the JAX package (cpm_tpu/modeling/rpn.py::
// select_proposals) and in the port's plain version (cpm_tpu_torch/modeling/
// rpn.py::level_candidates_plain) each level runs its own chain of small
// ops: a top-k, gathers, BoxCoder.decode, the clip to the image and the
// small-box mask, some fifty dispatches a level. Here the caller sorts each
// level's scores (the plain version's own stable descending sort), and this
// kernel takes, for each slot (image b, level l, rank j < K), the j-th of
// level l's sorted candidates, reading the level's sorted scores and
// indices, its deltas and its anchors in place through a table of pointers,
// or pads the slot (zeros, invalid) where j is past the level's
// k = min(pre_nms_top_n, its anchors). Every slot is computed as the plain
// version computes it, operation by operation, each rounded on its own
// (__fadd_rn and kin, so that nvcc contracts nothing), in float32:
//
// - ops/box_coder.py::BoxCoder.decode with one class: widths and heights
//   (x2 - x1) + 1, centres x1 + 0.5 * w, the deltas times the reciprocal of
//   their weight (PyTorch on CUDA divides by a Python number so), dw and dh
//   clamped at bbox_xform_clip, (dx * w) + cx, expf(dw) * w, and the corners
//   with the reference's -1;
// - structures/boxes.py::clip_boxes_to_image: clamp at 0 (NaN kept), then
//   torch.minimum with the image's float size - 1;
// - structures/boxes.py::remove_small_boxes_mask: (x2 - x1) + 1 >= min_size
//   on both sides.
//
// What bounds it on the H100: latency. It reads a slot's sorted index and
// score, its anchor and its four deltas, and writes 24 bytes and a flag;
// 5000 slots at batch 1, 40000 in a training step.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/rpn_candidates.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

// Level l in place: its sorted scores [batch, n] float32 and their indices
// [batch, n] int64, its deltas [batch, n, 4] and its anchors [n, 4] float32,
// n = size[l]; its first count[l] sorted candidates are its top-k.
template <typename D>
struct Levels {
  const float* scores[kMaxLevels];
  const int64_t* order[kMaxLevels];
  const D* deltas[kMaxLevels];
  const float* anchors[kMaxLevels];
  int size[kMaxLevels];
  int count[kMaxLevels];
};

struct Coder {
  float inv_wx, inv_wy, inv_ww, inv_wh;  // float32 reciprocals of the weights
  float clip;                            // bbox_xform_clip
  float min_size;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(double x) { return __double2float_rn(x); }
__device__ __forceinline__ float to_float(int32_t x) { return __int2float_rn(x); }
__device__ __forceinline__ float to_float(int64_t x) { return __ll2float_rn(x); }

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

// torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

template <typename D, typename Z>
__global__ void __launch_bounds__(kThreads)
    rpn_candidates_kernel(Levels<D> levels, const Z* __restrict__ image_sizes,
                          int num_levels, int k, long long slots, Coder coder,
                          float* __restrict__ out_boxes,
                          float* __restrict__ out_scores,
                          bool* __restrict__ out_valid) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= slots) return;
  const int j = static_cast<int>(s % k);
  const long long bl = s / k;
  const int l = static_cast<int>(bl % num_levels);
  const long long b = bl / num_levels;
  float* box = out_boxes + s * 4;
  if (j >= levels.count[l]) {
    box[0] = box[1] = box[2] = box[3] = 0.f;
    out_scores[s] = 0.f;
    out_valid[s] = false;
    return;
  }
  const long long n = levels.size[l];
  const long long i = levels.order[l][b * n + j];
  const float* a = levels.anchors[l] + i * 4;
  const D* d = levels.deltas[l] + (b * n + i) * 4;

  const float widths = __fadd_rn(__fsub_rn(a[2], a[0]), 1.f);
  const float heights = __fadd_rn(__fsub_rn(a[3], a[1]), 1.f);
  const float ctr_x = __fadd_rn(a[0], __fmul_rn(widths, 0.5f));
  const float ctr_y = __fadd_rn(a[1], __fmul_rn(heights, 0.5f));
  const float dx = __fmul_rn(to_float(d[0]), coder.inv_wx);
  const float dy = __fmul_rn(to_float(d[1]), coder.inv_wy);
  const float dw = clamp_max(__fmul_rn(to_float(d[2]), coder.inv_ww), coder.clip);
  const float dh = clamp_max(__fmul_rn(to_float(d[3]), coder.inv_wh), coder.clip);
  const float pred_cx = __fadd_rn(__fmul_rn(dx, widths), ctr_x);
  const float pred_cy = __fadd_rn(__fmul_rn(dy, heights), ctr_y);
  const float half_w = __fmul_rn(__fmul_rn(expf(dw), widths), 0.5f);
  const float half_h = __fmul_rn(__fmul_rn(expf(dh), heights), 0.5f);
  const float x1 = __fsub_rn(pred_cx, half_w);
  const float y1 = __fsub_rn(pred_cy, half_h);
  const float x2 = __fsub_rn(__fadd_rn(pred_cx, half_w), 1.f);
  const float y2 = __fsub_rn(__fadd_rn(pred_cy, half_h), 1.f);

  const float hi_y = __fsub_rn(to_float(image_sizes[b * 2]), 1.f);
  const float hi_x = __fsub_rn(to_float(image_sizes[b * 2 + 1]), 1.f);
  const float cx1 = minimum(clamp_min(x1, 0.f), hi_x);
  const float cy1 = minimum(clamp_min(y1, 0.f), hi_y);
  const float cx2 = minimum(clamp_min(x2, 0.f), hi_x);
  const float cy2 = minimum(clamp_min(y2, 0.f), hi_y);
  box[0] = cx1;
  box[1] = cy1;
  box[2] = cx2;
  box[3] = cy2;
  out_scores[s] = levels.scores[l][b * n + j];
  out_valid[s] = __fadd_rn(__fsub_rn(cx2, cx1), 1.f) >= coder.min_size &&
                 __fadd_rn(__fsub_rn(cy2, cy1), 1.f) >= coder.min_size;
}

template <typename D, typename Z>
cudaError_t launch(const Levels<D>& levels, const void* image_sizes, int num_levels,
                   int k, long long slots, const Coder& coder, void* out_boxes,
                   void* out_scores, void* out_valid, cudaStream_t stream) {
  const long long blocks = (slots + kThreads - 1) / kThreads;
  rpn_candidates_kernel<D, Z><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      levels, static_cast<const Z*>(image_sizes), num_levels, k, slots, coder,
      static_cast<float*>(out_boxes), static_cast<float*>(out_scores),
      static_cast<bool*>(out_valid));
  return cudaGetLastError();
}

template <typename D>
cudaError_t launch_sizes(const void* const* scores, const void* const* order,
                         const void* const* deltas, const void* const* anchors,
                         const int* level_anchors, const int* level_k, int num_levels,
                         const void* image_sizes, int size_dtype, int k,
                         long long slots, const Coder& coder, void* out_boxes,
                         void* out_scores, void* out_valid, cudaStream_t stream) {
  Levels<D> levels = {};
  for (int l = 0; l < num_levels; ++l) {
    levels.scores[l] = static_cast<const float*>(scores[l]);
    levels.order[l] = static_cast<const int64_t*>(order[l]);
    levels.deltas[l] = static_cast<const D*>(deltas[l]);
    levels.anchors[l] = static_cast<const float*>(anchors[l]);
    levels.size[l] = level_anchors[l];
    levels.count[l] = level_k[l];
  }
  if (size_dtype == 0) {
    return launch<D, int32_t>(levels, image_sizes, num_levels, k, slots, coder,
                              out_boxes, out_scores, out_valid, stream);
  }
  if (size_dtype == 1) {
    return launch<D, int64_t>(levels, image_sizes, num_levels, k, slots, coder,
                              out_boxes, out_scores, out_valid, stream);
  }
  return launch<D, float>(levels, image_sizes, num_levels, k, slots, coder, out_boxes,
                          out_scores, out_valid, stream);
}

}  // namespace

// For each of num_levels levels, device pointers to its sorted scores
// [batch, n] float32 (descending, ties in index order), their indices [batch,
// n] int64, its deltas [batch, n, 4] (delta_dtype 0 float32, 1 bfloat16, 2
// float64) and its anchors [n, 4] float32, n = level_anchors[l], and its
// top-k size level_k[l]; image_sizes [batch, 2] (h, w) (size_dtype 0 int32,
// 1 int64, 2 float32); outputs boxes [batch, num_levels, k, 4] float32,
// scores [batch, num_levels, k] float32, valid [batch, num_levels, k] bool.
// All tensors are contiguous device memory. Returns the cudaError_t of the
// launch.
extern "C" int cpm_rpn_candidates(
    const void* const* scores, const void* const* order, const void* const* deltas,
    int delta_dtype, const void* const* anchors, const int* level_anchors,
    const int* level_k, int num_levels, const void* image_sizes, int size_dtype,
    int batch, int k, float inv_wx, float inv_wy, float inv_ww, float inv_wh,
    float clip, float min_size, void* out_boxes, void* out_scores, void* out_valid,
    void* stream) {
  if (batch < 1 || num_levels < 1 || num_levels > kMaxLevels || k < 1 ||
      delta_dtype < 0 || delta_dtype > 2 || size_dtype < 0 || size_dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < num_levels; ++l) {
    if (level_k[l] < 1 || level_k[l] > k || level_k[l] > level_anchors[l]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long slots = static_cast<long long>(batch) * num_levels * k;
  const Coder coder = {inv_wx, inv_wy, inv_ww, inv_wh, clip, min_size};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (delta_dtype == 0) {
    err = launch_sizes<float>(scores, order, deltas, anchors, level_anchors, level_k,
                              num_levels, image_sizes, size_dtype, k, slots, coder,
                              out_boxes, out_scores, out_valid, s);
  } else if (delta_dtype == 1) {
    err = launch_sizes<__nv_bfloat16>(scores, order, deltas, anchors, level_anchors,
                                      level_k, num_levels, image_sizes, size_dtype, k,
                                      slots, coder, out_boxes, out_scores, out_valid, s);
  } else {
    err = launch_sizes<double>(scores, order, deltas, anchors, level_anchors, level_k,
                               num_levels, image_sizes, size_dtype, k, slots, coder,
                               out_boxes, out_scores, out_valid, s);
  }
  return static_cast<int>(err);
}
