// Cluster-batched multilevel RoIAlign forward for Hopper (sm_90a), and the
// grouping it runs on.
//
// Replaces the TPU kernel cpm_tpu/ops/pallas/clustered_pallas.py::
// multilevel_roi_align_clustered (_cl_fwd/_cl_fwd_body) and its XLA grouping
// (_cluster). Rois of one image and level whose bilinear supports begin in
// the same lattice cell are grouped; the point of the kernel is that a
// group's shared cells are read from device memory once for the whole group.
// It computes what the multilevel kernel (multilevel_roi_align.cu) computes,
// from the same device functions (roi_align_common.cuh), in the same order,
// so it gives that kernel's bits.
//
// The grouping (cluster_rois_kernel) computes exactly what
// cpm_tpu_torch/ops/roi_align.py::cluster_rois computes, integer for
// integer, in one launch of one block, with no host sync: each roi's support
// and key; a counting sort of the grouped rois by key (a count per key of
// the key space, batch x levels x lattice blocks, and its exclusive scan),
// made stable by ranking each roi among the rois of its key by index; the
// singletons and the masked rois after them in index order (block scans);
// then the group rows. Its plain statement is
// cpm_tpu_torch/ops/roi_align.py::counting_sort_groups.
//
// The forward (clustered_roi_align_fwd_kernel): work items are (group, slice
// of bins, C tile) triples, the groups read from the grouping's count on the
// device, and the rows of masked rois; a grid of as many blocks as the card
// holds at once walks them, so the work follows the groups that exist. A
// block stages its group's members' samples along each axis (cells and
// weights) in shared memory, then pools the slice's bins of every member,
// member by member within each bin, threads along C and rows of threads over
// 64 (bin, member) pairs, f32 accumulation (pool_bin, the multilevel
// kernel's loop), storing each result straight to the member's own output
// row: no sorted output and no inverse gather. The members of a group read
// neighbouring cells for the same bin, one after another on one SM, so the
// group's shared cells come from L1 after the first read: on the H100 the
// cache does what the TPU kernel's VMEM window did. A rectangle staged in
// shared memory by hand (64-byte channel chunks, 36,864 bytes at tile 24)
// measured slower at every launch bound tried (PERF.md): its copy and
// barrier cost more than the L1 misses they save. Every output row is
// written by exactly one item, so no fill is needed.
//
// What bounds it on the H100: bytes. Each group's cells are read from
// device memory once at best, the output is written once; the arithmetic is
// one multiply-add per element read. The grouping moves a few bytes a roi;
// what bounds it is latency, in one block. The TPU kernel's 64-cell window,
// its batched hat-weight matmul and its DMA rings have no counterpart.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/clustered_roi_align.py).

#include <algorithm>
#include <climits>

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

constexpr int kMaxGroup = 16;
constexpr int kGroupFields = 8;
constexpr int kGroupThreads = 1024;  // the grouping's one block
constexpr int kLoner = -1;           // the key of a valid roi in no shared group
constexpr int kMasked = -2;
constexpr int kRecordFields = 8;     // key, y0, x0, y_end, x_end, level, image, rank

struct LevelTable {
  const void* ptr[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
};

// ---------------------------------------------------------------------------
// The grouping.

// Exclusive prefix sum of v over the block's threads (kGroupThreads, in
// 32 warps); *total gets the sum. Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    warp_sums[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - v;
  __syncthreads();  // warp_sums is free for the next scan
  return out;
}

// The cells [*origin, *origin + *extent) that the samples of one axis read,
// as cluster_rois' _support gives them: (0, 0) when every sample is out of
// bounds.
__device__ void support(float start, int samples, int sr, float bin, int size,
                        int* origin, int* extent) {
  int first = INT_MAX, last = -1;
  for (int k = 0; k < samples; ++k) {
    const AxisSample a = axis_sample(start, k, sr, bin, size);
    if (a.lo >= 0) {
      first = min(first, a.lo);
      last = max(last, a.hi);
    }
  }
  *origin = last >= 0 ? first : 0;
  *extent = last >= 0 ? last - first + 1 : 0;
}

// scratch: [keys + 1] counts, then starts; [keys] cursors; [keys] first
// group of each key; [num_rois] the grouped rois placed by atomics;
// [num_rois][kRecordFields] each roi's record.
__global__ void __launch_bounds__(kGroupThreads)
    cluster_rois_kernel(LevelTable levels, int num_levels, int batch,
                        const float* __restrict__ rois,
                        const int32_t* __restrict__ roi_levels,
                        const uint8_t* __restrict__ valid, int num_rois,
                        int pooled_h, int pooled_w, int sr, int aligned,
                        int cap, int tile, int pitch, int lattice_y,
                        int lattice_x, int keys, int32_t* scratch,
                        int32_t* __restrict__ order,
                        int32_t* __restrict__ groups,
                        int64_t* __restrict__ slot_group,
                        int64_t* __restrict__ n_groups) {
  __shared__ int warp_sums[32];
  __shared__ int totals[6];  // grouped rois, their groups, loners, masked, scan scratch x2
  int* start = scratch;
  int* cursor = start + keys + 1;
  int* key_group = cursor + keys;
  int* placed = key_group + keys;
  int* record = placed + num_rois;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  for (int k = tid; k < keys + 1; k += threads) start[k] = 0;
  for (int k = tid; k < keys; k += threads) cursor[k] = 0;
  if (tid == 0) totals[2] = totals[3] = 0;
  __syncthreads();

  // 1. each roi's support, key and record; the count of each key
  for (int i = tid; i < num_rois; i += threads) {
    const int level_id = roi_levels[i];
    const int l = min(max(level_id, 0), num_levels - 1);
    const int H = levels.height[l];
    const int W = levels.width[l];
    const RoiBox box = roi_box(rois + static_cast<size_t>(i) * 5,
                               levels.scale[l], batch, pooled_h, pooled_w,
                               aligned);
    int y0, need_r, x0, need_c;
    support(box.y1, pooled_h * sr, sr, box.bin_h, H, &y0, &need_r);
    support(box.x1, pooled_w * sr, sr, box.bin_w, W, &x0, &need_c);
    const int cy = y0 / pitch;
    const int cx = x0 / pitch;
    const bool fits = y0 - cy * pitch + need_r <= tile &&
                      x0 - cx * pitch + need_c <= tile && need_r > 0 &&
                      need_c > 0;
    int key;
    if (!valid[i]) {
      key = kMasked;
      atomicAdd(&totals[3], 1);
    } else if (!fits) {
      key = kLoner;
      atomicAdd(&totals[2], 1);
    } else {
      key = ((box.batch * num_levels + l) * lattice_y + cy) * lattice_x + cx;
      atomicAdd(&start[key], 1);
    }
    int* rec = record + static_cast<size_t>(i) * kRecordFields;
    rec[0] = key;
    rec[1] = y0;
    rec[2] = x0;
    rec[3] = y0 + need_r;
    rec[4] = x0 + need_c;
    rec[5] = level_id;
    rec[6] = box.batch;
  }
  __syncthreads();

  // 2. exclusive scans over the keys: each key's first slot and first group
  const int span = (keys + threads - 1) / threads;
  const int k0 = min(tid * span, keys);
  const int k1 = min(k0 + span, keys);
  int rois_here = 0, groups_here = 0;
  for (int k = k0; k < k1; ++k) {
    rois_here += start[k];
    groups_here += (start[k] + cap - 1) / cap;
  }
  int slot = block_exclusive_scan(rois_here, warp_sums, &totals[0]);
  int group = block_exclusive_scan(groups_here, warp_sums, &totals[1]);
  for (int k = k0; k < k1; ++k) {
    const int count = start[k];
    start[k] = slot;
    key_group[k] = group;
    slot += count;
    group += (count + cap - 1) / cap;
  }
  const int grouped = totals[0];
  const int shared_groups = totals[1];
  const int loners = totals[2];
  if (tid == 0) start[keys] = grouped;
  __syncthreads();

  // 3. the loners, then the masked rois, in index order after the grouped
  // rois; the grouped rois into their key's slots, in any order
  int loner_base = 0, masked_base = 0;
  for (int c = 0; c < num_rois; c += threads) {
    const int i = c + tid;
    const int key = i < num_rois ? record[static_cast<size_t>(i) * kRecordFields] : 0;
    const int l_rank = block_exclusive_scan(i < num_rois && key == kLoner, warp_sums, &totals[4]);
    const int m_rank = block_exclusive_scan(i < num_rois && key == kMasked, warp_sums, &totals[5]);
    if (i < num_rois) {
      if (key == kLoner) {
        order[grouped + loner_base + l_rank] = i;
        record[static_cast<size_t>(i) * kRecordFields + 7] = loner_base + l_rank;
      } else if (key == kMasked) {
        order[grouped + loners + masked_base + m_rank] = i;
      } else {
        placed[start[key] + atomicAdd(&cursor[key], 1)] = i;
      }
    }
    loner_base += totals[4];
    masked_base += totals[5];
    __syncthreads();  // totals[4..5] are read before the next chunk's scans
  }
  __syncthreads();

  // 4. stable: a grouped roi's rank among its key's rois is the number of
  // them with a smaller index
  for (int s = tid; s < grouped; s += threads) {
    const int i = placed[s];
    const int key = record[static_cast<size_t>(i) * kRecordFields];
    int rank = 0;
    for (int j = start[key]; j < start[key + 1]; ++j) rank += placed[j] < i;
    order[start[key] + rank] = i;
    record[static_cast<size_t>(i) * kRecordFields + 7] = rank;
  }
  __syncthreads();

  // 5. each slot's group, each group's row (first slot, size, level, image,
  // y0, x0, rows, cols), zero rows beyond the last group
  const int total_groups = shared_groups + loners;
  for (int s = tid; s < num_rois; s += threads) {
    const int* rec = record + static_cast<size_t>(order[s]) * kRecordFields;
    const int key = rec[0];
    if (key == kMasked) {
      slot_group[s] = total_groups - 1;
      continue;
    }
    int g, size = 1;
    bool leader = true;
    if (key == kLoner) {
      g = shared_groups + rec[7];
    } else {
      g = key_group[key] + rec[7] / cap;
      leader = rec[7] % cap == 0;
      size = min(cap, start[key + 1] - start[key] - rec[7]);
    }
    slot_group[s] = g;
    if (!leader) continue;
    int top = INT_MAX, left = INT_MAX, bottom = INT_MIN, right = INT_MIN;
    for (int m = 0; m < size; ++m) {
      const int* member = record + static_cast<size_t>(order[s + m]) * kRecordFields;
      top = min(top, member[1]);
      left = min(left, member[2]);
      bottom = max(bottom, member[3]);
      right = max(right, member[4]);
    }
    int32_t* row = groups + static_cast<size_t>(g) * kGroupFields;
    row[0] = s;
    row[1] = size;
    row[2] = rec[5];
    row[3] = rec[6];
    row[4] = top;
    row[5] = left;
    row[6] = bottom - top;
    row[7] = right - left;
  }
  for (int g = total_groups + tid; g < num_rois; g += threads) {
#pragma unroll
    for (int f = 0; f < kGroupFields; ++f) {
      groups[static_cast<size_t>(g) * kGroupFields + f] = 0;
    }
  }
  if (tid == 0) *n_groups = total_groups;
}

// ---------------------------------------------------------------------------
// The forward.

// groups: [num_rois, 8] int32 rows (first slot, size, level, batch, y0, x0,
// rows, cols) of group g; n_groups: the number of groups, on the device.
// order: [num_rois] int32, sorted slot -> roi; the valid rois' slots come
// first, so the masked rois hold the slots from the last group's end on.
// Block (tx, ty) as roi_launch_shape gives it; an item pools bins [slice *
// span, slice * span + span) of every member. Shared memory: the members'
// samples, cap x (pooled_h rows then pooled_w columns) x sr. Five blocks an
// SM: at most 48 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
    clustered_roi_align_fwd_kernel(LevelTable levels, int num_levels,
                                   int batch, int channels,
                                   const float* __restrict__ rois,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ groups,
                                   const int64_t* __restrict__ n_groups_ptr,
                                   int num_rois, int cap, int pooled_h,
                                   int pooled_w, int sr, int aligned,
                                   int span, int c_tiles,
                                   T* __restrict__ out) {
  constexpr int kN = VecWidth<T>::kN;
  extern __shared__ AxisSample member_samples[];
  __shared__ int members[kMaxGroup];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int bins = pooled_h * pooled_w;
  const int rows_per = pooled_h * sr;
  const int per_member = (pooled_h + pooled_w) * sr;
  const int slices = (bins + span - 1) / span;
  const int64_t counted = *n_groups_ptr;
  const int n_groups =
      counted < 0 ? 0 : (counted > num_rois ? num_rois : static_cast<int>(counted));
  const int32_t* last =
      groups + static_cast<size_t>(max(n_groups - 1, 0)) * kGroupFields;
  const int n_valid =
      n_groups > 0 ? min(max(last[0] + last[1], 0), num_rois) : 0;
  const int group_items = n_groups * slices * c_tiles;
  const int items = group_items + num_rois - n_valid;
  const int vecs = channels / kN;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    if (item >= group_items) {
      // a masked roi: its row is zeros
      const int r =
          min(max(order[n_valid + item - group_items], 0), num_rois - 1);
      const float zeros[kN] = {};
      T* row = out + static_cast<size_t>(r) * bins * channels;
      for (int v = tid; v < bins * vecs; v += threads) {
        store(row + static_cast<size_t>(v) * kN, zeros);
      }
      continue;
    }
    const int g = item / (slices * c_tiles);
    const int rest = item - g * slices * c_tiles;
    const int slice = rest / c_tiles;
    const int c0 = ((rest - slice * c_tiles) * blockDim.x + threadIdx.x) * kN;
    const int first_bin = slice * span;
    const int last_bin = min(first_bin + span, bins);
    const int32_t* grp = groups + static_cast<size_t>(g) * kGroupFields;
    const int first = grp[0];
    const int size = min(min(grp[1], cap), kMaxGroup);
    if (size <= 0 || first < 0 || first + size > num_rois) continue;
    const int level = min(max(grp[2], 0), num_levels - 1);
    const int image = min(max(grp[3], 0), batch - 1);
    const int H = levels.height[level];
    const int W = levels.width[level];

    __syncthreads();  // the previous item is done with shared memory
    if (tid < size) members[tid] = min(max(order[first + tid], 0), num_rois - 1);
    for (int e = tid; e < size * per_member; e += threads) {
      const int m = e / per_member;
      const int i = e - m * per_member;
      const int r = min(max(order[first + m], 0), num_rois - 1);
      const RoiBox box = roi_box(rois + static_cast<size_t>(r) * 5,
                                 levels.scale[level], batch, pooled_h,
                                 pooled_w, aligned);
      member_samples[e] =
          i < rows_per
              ? axis_sample(box.y1, i, sr, box.bin_h, H)
              : axis_sample(box.x1, i - rows_per, sr, box.bin_w, W);
    }
    __syncthreads();
    if (c0 >= channels) continue;

    const T* feat = static_cast<const T*>(levels.ptr[level]) +
                    static_cast<size_t>(image) * H * W * channels + c0;
    const auto load = [&](int y, int x) {
      return load16(feat + (static_cast<size_t>(y) * W + x) * channels);
    };
    for (int p = threadIdx.y; p < (last_bin - first_bin) * size;
         p += blockDim.y) {
      const int bin = first_bin + p / size;
      const int m = p - (p / size) * size;
      const int py = bin / pooled_w;
      const int px = bin - py * pooled_w;
      const AxisSample* samples = member_samples + m * per_member;
      float acc[kN];
      pool_bin<T>(samples + py * sr, samples + rows_per + px * sr, sr, load,
                  acc);
      store(out + (static_cast<size_t>(members[m]) * bins + bin) * channels +
                c0,
            acc);
    }
  }
}

// As many blocks as the card holds at once (queried once per device), at
// most one per item the launch could have.
template <typename Kernel>
cudaError_t resident_blocks(Kernel* kernel, int shared, int* blocks) {
  static int cached[kMaxDevices] = {};
  static int cached_shared[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0 || cached_shared[device] != shared) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, shared);
    if (err != cudaSuccess) return err;
    cached[device] = std::max(sms * per_sm, 1);
    cached_shared[device] = shared;
  }
  *blocks = cached[device];
  return cudaSuccess;
}

// An item's bins: 64 (bin, member) pairs a block at a group of `cap`.
constexpr int kPairsPerBlock = 64;

template <typename T>
cudaError_t launch(const LevelTable& table, int num_levels, int batch,
                   int channels, const float* rois, const int32_t* order,
                   const int32_t* groups, const int64_t* n_groups,
                   int num_rois, int cap, int pooled_h, int pooled_w, int sr,
                   int aligned, T* out, cudaStream_t stream) {
  static int opted[kMaxDevices] = {};
  dim3 grid, block;
  roi_launch_shape<T>(channels, num_rois, &grid, &block);
  const int c_tiles = static_cast<int>(grid.y);
  const int span = std::max(1, kPairsPerBlock / cap);
  const int bins = pooled_h * pooled_w;
  const int shared =
      static_cast<int>(sizeof(AxisSample) * cap * (pooled_h + pooled_w) * sr);
  cudaError_t err =
      opt_in_shared(clustered_roi_align_fwd_kernel<T>, shared, opted);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(clustered_roi_align_fwd_kernel<T>, shared, &blocks);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(num_rois) *
                          ((bins + span - 1) / span * c_tiles + 1);
  const int size = static_cast<int>(std::min(static_cast<long long>(blocks), items));
  clustered_roi_align_fwd_kernel<T><<<size, block, shared, stream>>>(
      table, num_levels, batch, channels, rois, order, groups, n_groups,
      num_rois, cap, pooled_h, pooled_w, sr, aligned, span, c_tiles, out);
  return cudaGetLastError();
}

LevelTable make_table(const void* level_ptrs, const void* level_hw,
                      const void* level_scales, int num_levels) {
  LevelTable table = {};
  const void* const* ptrs = static_cast<const void* const*>(level_ptrs);
  const int* hw = static_cast<const int*>(level_hw);
  const float* scales = static_cast<const float*>(level_scales);
  for (int l = 0; l < num_levels; ++l) {
    table.ptr[l] = ptrs != nullptr ? ptrs[l] : nullptr;
    table.height[l] = hw[2 * l];
    table.width[l] = hw[2 * l + 1];
    table.scale[l] = scales[l];
  }
  return table;
}

}  // namespace

// level_hw ([h0, w0, h1, w1, ...]) and level_scales are host arrays of
// num_levels entries; every other pointer is device memory. rois
// [num_rois, 5] f32, roi_levels [num_rois] int32, valid [num_rois] bytes;
// the outputs are cluster_rois' Grouping: order [num_rois] int32, groups
// [num_rois, 8] int32, slot_group [num_rois] int64 and n_groups [1] int64.
// cap: most rois in a group (at most 16); tile, pitch: the rectangle's side
// and the lattice's pitch, in cells. scratch: scratch_ints int32, at least
// 3 * keys + 1 + 9 * num_rois, with keys = batch * num_levels *
// (max h / pitch + 1) * (max w / pitch + 1). Returns the cudaError_t of the
// launch.
extern "C" int cpm_cluster_rois(const void* level_hw, const void* level_scales,
                                int num_levels, int batch, const void* rois,
                                const void* roi_levels, const void* valid,
                                int num_rois, int pooled_h, int pooled_w,
                                int sampling_ratio, int aligned, int cap,
                                int tile, int pitch, void* scratch,
                                long long scratch_ints, void* order,
                                void* groups, void* slot_group, void* n_groups,
                                void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
      batch < 1 || pooled_h < 1 || pooled_w < 1 || sampling_ratio < 1 ||
      cap < 1 || cap > kMaxGroup || tile < 1 || pitch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LevelTable table = make_table(nullptr, level_hw, level_scales, num_levels);
  int max_h = 0, max_w = 0;
  for (int l = 0; l < num_levels; ++l) {
    max_h = std::max(max_h, table.height[l]);
    max_w = std::max(max_w, table.width[l]);
  }
  const int lattice_y = max_h / pitch + 1;
  const int lattice_x = max_w / pitch + 1;
  const long long keys =
      static_cast<long long>(batch) * num_levels * lattice_y * lattice_x;
  if (keys > INT_MAX / 4 ||
      scratch_ints < 3 * keys + 1 + 9LL * num_rois) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cluster_rois_kernel<<<1, kGroupThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, num_levels, batch, static_cast<const float*>(rois),
      static_cast<const int32_t*>(roi_levels),
      static_cast<const uint8_t*>(valid), num_rois, pooled_h, pooled_w,
      sampling_ratio, aligned, cap, tile, pitch, lattice_y, lattice_x,
      static_cast<int>(keys), static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(order), static_cast<int32_t*>(groups),
      static_cast<int64_t*>(slot_group), static_cast<int64_t*>(n_groups));
  return static_cast<int>(cudaGetLastError());
}

// level_ptrs, level_hw ([h0, w0, h1, w1, ...]) and level_scales are host
// arrays of num_levels entries; every other pointer is device memory.
// Levels are [batch, H_l, W_l, channels] contiguous of `dtype` (0 = float32,
// 1 = bfloat16), rois [num_rois, 5] f32, order [num_rois] int32 (sorted
// slot -> roi, a permutation), groups [num_rois, 8] int32 and n_groups [1]
// int64 as cluster_rois gives them, out [num_rois, pooled_h, pooled_w,
// channels] of `dtype`. cap: the most rois in a group (at most 16); the
// members' samples take cap * (pooled_h + pooled_w) * sampling_ratio * 16
// bytes of shared memory. channels must be a multiple of 16 bytes' worth of
// elements and every pointer 16-byte aligned. Returns the cudaError_t of the
// launch.
extern "C" int cpm_clustered_roi_align_fwd(
    const void* level_ptrs, const void* level_hw, const void* level_scales,
    int num_levels, int batch, int channels, const void* rois,
    const void* order, const void* groups, const void* n_groups, int num_rois,
    int cap, int pooled_h, int pooled_w, int sampling_ratio, int aligned,
    int dtype, void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || num_rois < 1 ||
      channels < 1 || sampling_ratio < 1 || dtype < 0 || dtype > 1 ||
      cap < 1 || cap > kMaxGroup || pooled_h < 1 || pooled_w < 1 ||
      static_cast<long long>(cap) * (pooled_h + pooled_w) * sampling_ratio *
              sizeof(AxisSample) >
          232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LevelTable table =
      make_table(level_ptrs, level_hw, level_scales, num_levels);
  const float* r = static_cast<const float*>(rois);
  const int32_t* o = static_cast<const int32_t*>(order);
  const int32_t* g = static_cast<const int32_t*>(groups);
  const int64_t* n = static_cast<const int64_t*>(n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(table, num_levels, batch, channels, r, o, g, n,
                        num_rois, cap, pooled_h, pooled_w, sampling_ratio,
                        aligned, static_cast<float*>(out), s);
  } else {
    err = launch<__nv_bfloat16>(table, num_levels, batch, channels, r, o, g, n,
                                num_rois, cap, pooled_h, pooled_w,
                                sampling_ratio, aligned,
                                static_cast<__nv_bfloat16*>(out), s);
  }
  return static_cast<int>(err);
}
