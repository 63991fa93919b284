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
// Backward, the map's gradient: a gather owned by tiles of the map, not a
// scatter. What bounds it on the H100 is bytes: g is K*K times the map and
// is read once, the map's gradient written once. A counting sort on the card
// (four small launches with no host sync; its plain version is
// ops/deform_conv.py::window_tiles) first bins the samples by the tile of
// their window start, stably, and writes each one's window in that order.
// One block then owns one image's tile of kTileH x kTileW cells and kChunk
// channels: it walks the sample lists of its own tile and of the tiles to
// its left, above and above-left (a window that starts one row or column
// before the tile reaches into it), adds g * w_ij for the cells that fall in
// the tile into a float32 tile in shared memory (up to four loads of g in
// flight per warp), and writes the tile once, in the map's dtype. Warp r
// owns the tile's row r and each lane eight channels, so no two threads ever
// add into one element and every cell's sum is taken in one fixed order: the
// list order, then the sorted order, which is the samples' own. Two runs
// give the same bits. The scatter this replaces sent C/4 float4 atomics to
// L2 for each of a sample's cells into a zero-filled float32 map that the
// wrapper then cast: about 80 million atomics and 89 MB of fill and cast at
// res3, 16-21x the bound; here there is no atomic, no float32 map and no
// cast.
//
// Backward, the coordinates' gradients: one warp per sample, t_ij =
// <cell_ij, g> over C by a warp reduction in a fixed order, then gys =
// sum_ij t_ij * dwy_i * wx_j and gxs = sum_ij t_ij * wy_i * dwx_j with the
// tent's derivative dwy_i = -sign(y - row_i) on |y - row_i| < 1, which is
// zero at y == row_i and on a row past the last one. It reads g once more
// (forming t_ij in the map kernel instead, beside its sums, measured slower:
// it doubles that kernel's shared memory), in the binning's order when the
// map's gradient was binned, so that neighbouring warps read the same cells.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/deform_sample.py).

#include "roi_align_common.cuh"

namespace {

using namespace cpm;

constexpr int kWarpsPerBlock = kThreads / 32;
// the map-gradient tile: one row per warp, eight channels per lane
constexpr int kTileH = kWarpsPerBlock;
constexpr int kTileW = 2;
constexpr int kChunk = 256;
// the tile's float32 sums, in dynamic shared memory
constexpr int kTileBytes = kTileH * kTileW * kCellVecs * 16;

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

// ---------------------------------------------------------------------------
// Binning: each image's samples in a stable order by the tile of their window
// start, a counting sort in four launches with no host sync. The plain
// version is ops/deform_conv.py::window_tiles. Key of a sample within its
// image: its tile, or `tiles` (the image's last key) for a sample of no
// weight, so an image has keys = tiles + 1 and the count of keys does not
// grow with the batch. Chunk c of image b is its samples [c * kBinChunk,
// (c + 1) * kBinChunk); one warp counts and places a chunk in index order, so
// the order within a key is the samples' own. The counts live in device
// memory, counts[(b * keys + key) * chunks + c]: B * keys * chunks int32,
// under a tenth of g's bytes for maps below 100k cells at C >= 256.

constexpr int kBinChunk = 512;

struct Window {
  int key;
  int start;  // (row << 16) | column of the window's first cell
  float4 w;   // wy0, wy1, wx0, wx1
};

struct BinShape {
  long long per_image;
  int batch;
  int height;
  int width;
  int tiles_x;
  int tiles;
  int keys;    // tiles + 1 per image
  int chunks;  // per image
};

__device__ __forceinline__ Window window_of(const float* ys, const float* xs,
                                            long long s, const BinShape& sh) {
  const Axis ay = tent_axis(ys[s], sh.height);
  const Axis ax = tent_axis(xs[s], sh.width);
  Window win;
  win.start = (ay.cell[0] << 16) | ax.cell[0];
  win.w = make_float4(ay.w[0], ay.w[1], ax.w[0], ax.w[1]);
  const bool live = (ay.w[0] > 0.0f || ay.w[1] > 0.0f) &&
                    (ax.w[0] > 0.0f || ax.w[1] > 0.0f);
  win.key = live ? (ay.cell[0] / kTileH) * sh.tiles_x + ax.cell[0] / kTileW
                 : sh.tiles;
  return win;
}

// The samples of chunk blockIdx.x of image blockIdx.y, 32 at a time:
// fn(s, here, active) on every lane, s < end where `here`.
template <typename Fn>
__device__ __forceinline__ void for_chunk(const BinShape& sh, Fn fn) {
  const long long image_first = static_cast<long long>(blockIdx.y) * sh.per_image;
  const long long first =
      image_first + static_cast<long long>(blockIdx.x) * kBinChunk;
  const long long end = min(first + kBinChunk, image_first + sh.per_image);
  for (long long s0 = first; s0 < end; s0 += 32) {
    const long long s = s0 + (threadIdx.x & 31);
    const bool here = s < end;
    fn(s, here, __ballot_sync(0xffffffffu, here));
  }
}

// counts (zero-filled) += the samples of each key in each chunk; grid
// (chunks, B), one warp.
__global__ void __launch_bounds__(32)
    bin_count_kernel(BinShape sh, const float* __restrict__ ys,
                     const float* __restrict__ xs, int* __restrict__ counts) {
  const unsigned below = (1u << threadIdx.x) - 1u;
  for_chunk(sh, [&](long long s, bool here, unsigned active) {
    if (!here) return;
    const int key = window_of(ys, xs, s, sh).key;
    const unsigned peers = __match_any_sync(active, key);
    if ((peers & below) == 0u) {
      atomicAdd(counts + (static_cast<size_t>(blockIdx.y) * sh.keys + key) *
                             sh.chunks + blockIdx.x,
                __popc(peers));
    }
  });
}

// Exclusive prefix of a block's values v (one a thread) and their total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  const int warps = blockDim.x >> 5;
  int before = 0, all = 0;
  for (int w = 0; w < warps; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Block (key, image): that key's counts over the chunks become their
// exclusive prefix; totals[image * keys + key] the key's samples.
__global__ void __launch_bounds__(kThreads)
    bin_scan_chunks_kernel(int chunks, int keys, int* __restrict__ counts,
                           int* __restrict__ totals) {
  const size_t key = static_cast<size_t>(blockIdx.y) * keys + blockIdx.x;
  int* row = counts + key * chunks;
  int carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    int total;
    const int before = block_exclusive_scan(c < chunks ? row[c] : 0, &total);
    if (c < chunks) row[c] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) totals[key] = carry;
}

// Block `image`: offsets[image * keys + k] = where key k of the image begins
// in the sorted order, which holds the image's samples at [image * P,
// (image + 1) * P); offsets[B * keys] = B * P.
__global__ void __launch_bounds__(1024)
    bin_scan_keys_kernel(int keys, long long per_image,
                         const int* __restrict__ totals,
                         int* __restrict__ offsets) {
  const size_t first = static_cast<size_t>(blockIdx.x) * keys;
  int carry = static_cast<int>(blockIdx.x * per_image);
  for (int k0 = 0; k0 < keys; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    int total;
    const int before =
        block_exclusive_scan(k < keys ? totals[first + k] : 0, &total);
    if (k < keys) offsets[first + k] = carry + before;
    carry += total;
  }
  if (blockIdx.x + 1 == gridDim.x && threadIdx.x == 0) {
    offsets[first + keys] = carry;
  }
}

// Every sample to its place: order[pos] = its index, starts / weights[pos]
// its window, for the map-gradient blocks to read in one coalesced pass.
// Grid (chunks, B), one warp; a chunk's counts, now the places of its
// samples of each key before the chunk's, are its cursors.
__global__ void __launch_bounds__(32)
    bin_place_kernel(BinShape sh, const float* __restrict__ ys,
                     const float* __restrict__ xs, int* counts,
                     const int* __restrict__ offsets, int* __restrict__ order,
                     int* __restrict__ starts, float4* __restrict__ weights) {
  const unsigned below = (1u << threadIdx.x) - 1u;
  for_chunk(sh, [&](long long s, bool here, unsigned active) {
    if (here) {
      const Window win = window_of(ys, xs, s, sh);
      const unsigned peers = __match_any_sync(active, win.key);
      const size_t key = static_cast<size_t>(blockIdx.y) * sh.keys + win.key;
      int* cursor = counts + key * sh.chunks + blockIdx.x;
      const int before = *cursor;
      const int pos = offsets[key] + before + __popc(peers & below);
      order[pos] = static_cast<int>(s);
      starts[pos] = win.start;
      weights[pos] = win.w;
      __syncwarp(active);  // every lane has read its cursor
      if ((peers & below) == 0u) *cursor = before + __popc(peers);
    }
    __syncwarp();
  });
}

// ---------------------------------------------------------------------------
// The map's gradient [B, H, W, C] in T, every element written once. order,
// starts and weights are the binning's records in sorted order, offsets its
// [B * keys + 1] offsets (keys = tiles + 1 per image); grid (tiles, B,
// ceil(C / kChunk)), kTileBytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_map_grad_kernel(int height, int width, int channels,
                                  const T* __restrict__ g,
                                  const int* __restrict__ order,
                                  const int* __restrict__ starts,
                                  const float4* __restrict__ weights,
                                  const int* __restrict__ offsets, int tiles_x,
                                  int keys, T* __restrict__ grad_map) {
  constexpr int kBatch = 4;  // loads of g in flight per warp
  extern __shared__ float4 acc[];  // [kTileH][kTileW][kCellVecs]
  // the staged samples of one round: index, window start relative to the
  // tile, and the four cells' weights (00, 01, 10, 11)
  __shared__ int st_s[kThreads];
  __shared__ int st_y[kThreads];
  __shared__ int st_x[kThreads];
  __shared__ float4 st_w[kThreads];

  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int image = blockIdx.y;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int y0 = ty * kTileH;
  const int x0 = tx * kTileW;
  const int c0 = blockIdx.z * kChunk + 8 * lane;
  const bool has_c = c0 < channels;
  const bool full = c0 + 4 < channels;
  float4* acc_row = acc + row * kTileW * kCellVecs;
  for (int v = lane; v < kTileW * kCellVecs; v += 32) {
    acc_row[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // own tile, left, above, above-left
  for (int n = 0; n < 4; ++n) {
    const int nty = ty - (n >> 1);
    const int ntx = tx - (n & 1);
    if (nty < 0 || ntx < 0) continue;
    const int bin = image * keys + nty * tiles_x + ntx;
    const int begin = offsets[bin];
    const int end = offsets[bin + 1];
    for (int base = begin; base < end; base += kThreads) {
      __syncthreads();  // the last round's samples are read
      const int e = base + static_cast<int>(threadIdx.x);
      if (e < end) {
        const int start = starts[e];
        const float4 w = weights[e];
        st_s[threadIdx.x] = order[e];
        st_y[threadIdx.x] = (start >> 16) - y0;
        st_x[threadIdx.x] = (start & 0xffff) - x0;
        st_w[threadIdx.x] = make_float4(cell_weight(w.x, w.z), cell_weight(w.x, w.w),
                                        cell_weight(w.y, w.z), cell_weight(w.y, w.w));
      }
      __syncthreads();
      const int count = min(end - base, kThreads);
      for (int k0 = 0; k0 < count; k0 += 32) {
        const int k = k0 + lane;
        bool hit = false;
        if (k < count) {
          const int i = row - st_y[k];
          const int sx = st_x[k];
          const float4 w = st_w[k];
          hit = (i == 0 ? (w.x != 0.0f || w.y != 0.0f)
                        : (i == 1 && (w.z != 0.0f || w.w != 0.0f))) &&
                sx >= -1 && sx < kTileW;
        }
        unsigned hits = __ballot_sync(0xffffffffu, hit);
        while (hits != 0u) {
          // up to kBatch samples at once, their loads of g all in flight
          int ks[kBatch];
          float gv[kBatch][8];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            ks[q] = -1;
            if (hits != 0u) {
              ks[q] = k0 + __ffs(hits) - 1;
              hits &= hits - 1u;
            }
            if (ks[q] >= 0 && has_c) {
              load8(g + static_cast<size_t>(st_s[ks[q]]) * channels + c0, full, gv[q]);
            }
          }
          if (!has_c) continue;
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int kk = ks[q];
            if (kk < 0) break;
            const float4 w4 = st_w[kk];
            const bool top = row == st_y[kk];
            const float w_left = top ? w4.x : w4.z;
            const float w_right = top ? w4.y : w4.w;
            const int sx = st_x[kk];
            if (sx >= 0 && w_left != 0.0f) {
              add8(acc_row + sx * kCellVecs, lane, w_left, gv[q]);
            }
            if (sx + 1 < kTileW && w_right != 0.0f) {
              add8(acc_row + (sx + 1) * kCellVecs, lane, w_right, gv[q]);
            }
          }
        }
      }
    }
  }
  // the warp wrote its row alone: it stores it without waiting for the rest
  const int y = y0 + row;
  if (y >= height || !has_c) return;
  T* dst = grad_map + ((static_cast<size_t>(image) * height + y) * width + x0) *
                          channels + c0;
  const int cols = min(kTileW, width - x0);
  for (int col = 0; col < cols; ++col) {
    float v[8];
    read8(acc_row + col * kCellVecs, lane, v);
    store8(dst + static_cast<size_t>(col) * channels, full, v);
  }
}

// gys / gxs [B, P] f32, every sample written; order: the binning's order of
// the samples, or null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_coord_grad_kernel(const T* __restrict__ feat, int height,
                                    int width, int channels,
                                    const float* __restrict__ ys,
                                    const float* __restrict__ xs,
                                    const T* __restrict__ g, long long samples,
                                    long long per_image,
                                    const int* __restrict__ order,
                                    float* __restrict__ gys,
                                    float* __restrict__ gxs) {
  constexpr int kN = VecWidth<T>::kN;
  const int lane = threadIdx.x & 31;
  const long long e =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= samples) return;
  // in the binning's order, when there is one: neighbouring warps then read
  // the same cells
  const long long s = order != nullptr ? order[e] : e;
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
        float fv[kN];
        load_scaled(feat + map_offset +
                        (static_cast<size_t>(ay.cell[i]) * width + ax.cell[j]) *
                            channels + c0,
                    1.0f, fv);
#pragma unroll
        for (int k = 0; k < kN; ++k) t[i][j] = __fmaf_rn(fv[k], gv[k], t[i][j]);
      }
    }
  }
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

inline BinShape bin_shape(int batch, int height, int width,
                          long long per_image) {
  BinShape sh;
  sh.per_image = per_image;
  sh.batch = batch;
  sh.height = height;
  sh.width = width;
  sh.tiles_x = (width + kTileW - 1) / kTileW;
  sh.tiles = (height + kTileH - 1) / kTileH * sh.tiles_x;
  sh.keys = sh.tiles + 1;
  sh.chunks = static_cast<int>((per_image + kBinChunk - 1) / kBinChunk);
  return sh;
}

// What the binning indexes: a window start packs its row in 15 bits and its
// column in 16, a sample's place is an int, an image a grid row.
inline bool bad_bins(int batch, int height, int width, long long per_image) {
  return batch < 1 || batch > 65535 || height < 1 || width < 1 ||
         per_image < 1 || height >= (1 << 15) || width >= (1 << 16) ||
         batch * per_image >= (1LL << 31);
}

cudaError_t launch_bin(const float* ys, const float* xs, const BinShape& sh,
                       int* counts, int* totals, int* order, int* starts,
                       float4* weights, int* offsets, cudaStream_t stream) {
  const dim3 chunks(sh.chunks, sh.batch);
  cudaError_t err = cudaMemsetAsync(
      counts, 0,
      static_cast<size_t>(sh.batch) * sh.keys * sh.chunks * sizeof(int),
      stream);
  if (err != cudaSuccess) return err;
  bin_count_kernel<<<chunks, 32, 0, stream>>>(sh, ys, xs, counts);
  bin_scan_chunks_kernel<<<dim3(sh.keys, sh.batch), kThreads, 0, stream>>>(
      sh.chunks, sh.keys, counts, totals);
  bin_scan_keys_kernel<<<sh.batch, 1024, 0, stream>>>(sh.keys, sh.per_image,
                                                      totals, offsets);
  bin_place_kernel<<<chunks, 32, 0, stream>>>(sh, ys, xs, counts, offsets,
                                              order, starts, weights);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const T* feat, int batch, int height, int width,
                       int channels, const float* ys, const float* xs,
                       const T* g, long long per_image, const int* order,
                       const int* starts, const float4* weights,
                       const int* offsets, T* grad_map, float* gys, float* gxs,
                       cudaStream_t stream) {
  if (grad_map != nullptr) {
    const BinShape sh = bin_shape(batch, height, width, per_image);
    const dim3 grid(sh.tiles, batch, (channels + kChunk - 1) / kChunk);
    if (kTileBytes > 48 * 1024) {
      cudaFuncSetAttribute(deform_sample_map_grad_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTileBytes);
    }
    deform_sample_map_grad_kernel<T><<<grid, kThreads, kTileBytes, stream>>>(
        height, width, channels, g, order, starts, weights, offsets,
        sh.tiles_x, sh.keys, grad_map);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (gys != nullptr) {
    const long long samples = batch * per_image;
    deform_sample_coord_grad_kernel<T>
        <<<blocks_for(samples), kThreads, 0, stream>>>(
            feat, height, width, channels, ys, xs, g, samples, per_image,
            order, gys, gxs);
  }
  return cudaGetLastError();
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

// The binning's layout: the map tile the backward's blocks own (rows,
// columns) and the samples a binning chunk holds. For a map of H x W, B
// images of P samples there are tiles = ceil(H / rows) * ceil(W / columns)
// per image, keys = tiles + 1 per image and chunks = ceil(P / chunk) per
// image.
extern "C" void cpm_deform_sample_layout(int* tile_h, int* tile_w,
                                         int* chunk) {
  *tile_h = kTileH;
  *tile_w = kTileW;
  *chunk = kBinChunk;
}

// The samples binned by the tile of their window start, a stable counting
// sort on the card: ys / xs [batch, per_image] f32. Scratch: counts int32
// [batch * keys * chunks], totals int32 [batch * keys]. Out: order int32
// [batch * per_image], the sample indices sorted by (image, key); starts
// int32 and weights float4 of the same length, each sample's window in that
// order; offsets int32 [batch * keys + 1], where the samples of key k of
// image b begin (b * keys + k; key tiles holds those of no weight) and, last,
// batch * per_image. Returns the cudaError_t of the launches.
extern "C" int cpm_deform_sample_bin(const void* ys, const void* xs, int batch,
                                     int height, int width,
                                     long long per_image, void* counts,
                                     void* totals, void* order, void* starts,
                                     void* weights, void* offsets,
                                     void* stream) {
  if (bad_bins(batch, height, width, per_image)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_bin(
      static_cast<const float*>(ys), static_cast<const float*>(xs),
      bin_shape(batch, height, width, per_image), static_cast<int*>(counts),
      static_cast<int*>(totals), static_cast<int*>(order),
      static_cast<int*>(starts), static_cast<float4*>(weights),
      static_cast<int*>(offsets), static_cast<cudaStream_t>(stream)));
}

// As the forward, with g [batch, per_image, channels] of `dtype`. grad_map
// [batch, height, width, channels] of `dtype`, written whole, or null when
// the map needs no gradient; with it the launches begin with
// cpm_deform_sample_bin's, into counts, totals, order, starts, weights and
// offsets as that function takes them. gys / gxs [batch, per_image] f32,
// written whole, or both null. Returns the cudaError_t of the launches.
extern "C" int cpm_deform_sample_bwd(const void* feat, int batch, int height,
                                     int width, int channels, const void* ys,
                                     const void* xs, const void* g,
                                     long long per_image, int dtype,
                                     void* counts, void* totals, void* order,
                                     void* starts, void* weights,
                                     void* offsets, void* grad_map, void* gys,
                                     void* gxs, void* stream) {
  if (bad_shape(batch, height, width, channels, per_image, dtype) ||
      (gys == nullptr) != (gxs == nullptr) ||
      (grad_map != nullptr &&
       (bad_bins(batch, height, width, per_image) || counts == nullptr ||
        totals == nullptr || order == nullptr || starts == nullptr ||
        weights == nullptr || offsets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  int* o = static_cast<int*>(order);
  int* st = static_cast<int*>(starts);
  float4* w = static_cast<float4*>(weights);
  int* off = static_cast<int*>(offsets);
  float* gy = static_cast<float*>(gys);
  float* gx = static_cast<float*>(gxs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (grad_map != nullptr) {
    err = launch_bin(y, x, bin_shape(batch, height, width, per_image),
                     static_cast<int*>(counts), static_cast<int*>(totals), o,
                     st, w, off, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 0) {
    err = launch_bwd<float>(static_cast<const float*>(feat), batch, height,
                            width, channels, y, x, static_cast<const float*>(g),
                            per_image, o, st, w, off,
                            static_cast<float*>(grad_map), gy, gx, s);
  } else {
    err = launch_bwd<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(feat), batch, height, width,
        channels, y, x, static_cast<const __nv_bfloat16*>(g), per_image, o, st,
        w, off, static_cast<__nv_bfloat16*>(grad_map), gy, gx, s);
  }
  return static_cast<int>(err);
}
