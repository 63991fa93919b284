// Greedy non-maximum suppression for Hopper (sm_90a): every row of a batch
// of score-sorted boxes in two launches, with no wait of the host.
//
// Replaces no TPU kernel. The JAX package's NMS (cpm_tpu/ops/nms.py::nms) is
// a fixed point inside a lax.while_loop: keep[i] is recomputed as "no kept,
// higher-scored box overlaps me" until it stops changing, which is exactly
// sequential greedy NMS. Its plain port (cpm_tpu_torch/ops/nms.py::
// greedy_nms) runs that loop from the host, which reads a flag from the card
// after every round: a round trip a round, on the RPN's five levels and the
// detection filter. These kernels compute the same keep decisions and the
// same compacted output slots on the card:
//
// - nms_mask_kernel: for each row and each pair i < j of valid boxes in
//   sorted order, bit j of box i's mask is iou(i, j) > threshold; ceil(N/64)
//   64-bit words a box, N^2/8 bytes a row. A block takes 64 boxes of a row
//   against 64 later ones (the column boxes staged in shared memory); blocks
//   below the diagonal leave at once, since the sweep never reads them.
// - nms_sweep_kernel: one block a row walks the sorted boxes 64 at a time
//   with the removed set in shared memory. Thread 0 decides a chunk in order
//   from its 64 diagonal words (a kept box removes the later boxes its word
//   names); the block then writes the kept boxes to the output slots (their
//   index through `order`, keep true) and ORs their words into the removed
//   set. The rest of the slots get index 0 and keep false, as the plain
//   version's cumsum and scatter leave them. A row stops once its slots are
//   full.
//
// The IoU is structures/boxes.py::box_iou op for op, each operation rounded
// on its own (__fadd_rn and kin, so that nvcc contracts nothing), in the
// boxes' dtype: the areas, the max / min corners, the clamped widths,
// inter = w * h, (a1 + a2) - inter, the clamp at the dtype's smallest
// normal, a true division, and the legacy_plus1 offset; PyTorch's NaN rules
// for maximum, minimum and clamp. bfloat16 boxes are rounded to bfloat16
// after every operation, as PyTorch's bfloat16 kernels round each result.
// The kept set is then the fixed point's, bit for bit, at an IoU one ulp
// either side of the threshold too.
//
// What bounds it on the H100: latency, not bytes. The mask is N^2/8 bytes a
// row, written once and read at most once (1.25 MB over the RPN's five rows
// at N = 1000, 10 MB over training's twenty at N = 2000: L2-resident), and
// the arithmetic is a few dozen operations a pair (no division for a pair
// that does not overlap). The sweep is a chain of ceil(N/64) dependent
// steps, each a serial walk over the chunk's boxes that remove a later one,
// in shared memory, and an OR pass (the next chunk's words load meanwhile);
// the rows run side by side.
//
// Plain C interface, bound from Python with ctypes
// (cpm_tpu_torch/ops/cuda/nms.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;          // boxes a mask word covers
constexpr int kSweepThreads = 256;
constexpr int kGroup = 8;           // kept boxes a thread ORs into a word
constexpr int kMaxRowsPerGrid = 65535;
constexpr long long kMaxSweepShared = 48 * 1024;

// The arithmetic of one storage dtype: C is the type PyTorch computes in,
// round() what storing a result in the dtype does to it.
template <typename S>
struct Arith;

template <>
struct Arith<float> {
  using C = float;
  static __device__ __forceinline__ C load(const float* p) { return *p; }
  static __device__ __forceinline__ C round(C x) { return x; }
  static __device__ __forceinline__ C add(C a, C b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ C sub(C a, C b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ C mul(C a, C b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ C div(C a, C b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ C max(C a, C b) { return fmaxf(a, b); }
  static __device__ __forceinline__ C min(C a, C b) { return fminf(a, b); }
};

template <>
struct Arith<__nv_bfloat16> {
  using C = float;
  static __device__ __forceinline__ C load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ C round(C x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ C add(C a, C b) { return round(__fadd_rn(a, b)); }
  static __device__ __forceinline__ C sub(C a, C b) { return round(__fsub_rn(a, b)); }
  static __device__ __forceinline__ C mul(C a, C b) { return round(__fmul_rn(a, b)); }
  static __device__ __forceinline__ C div(C a, C b) { return round(__fdiv_rn(a, b)); }
  static __device__ __forceinline__ C max(C a, C b) { return fmaxf(a, b); }
  static __device__ __forceinline__ C min(C a, C b) { return fminf(a, b); }
};

template <>
struct Arith<double> {
  using C = double;
  static __device__ __forceinline__ C load(const double* p) { return *p; }
  static __device__ __forceinline__ C round(C x) { return x; }
  static __device__ __forceinline__ C add(C a, C b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ C sub(C a, C b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ C mul(C a, C b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ C div(C a, C b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ C max(C a, C b) { return fmax(a, b); }
  static __device__ __forceinline__ C min(C a, C b) { return fmin(a, b); }
};

template <typename C>
__device__ __forceinline__ bool is_nan(C x) {
  return x != x;
}

// torch.maximum / torch.minimum: a NaN operand is the result.
template <typename A, typename C>
__device__ __forceinline__ C maximum(C a, C b) {
  return is_nan(a) ? a : (is_nan(b) ? b : A::max(a, b));
}

template <typename A, typename C>
__device__ __forceinline__ C minimum(C a, C b) {
  return is_nan(a) ? a : (is_nan(b) ? b : A::min(a, b));
}

// torch.clamp(x, min=lo): NaN stays NaN.
template <typename A, typename C>
__device__ __forceinline__ C clamp_min(C x, C lo) {
  return is_nan(x) ? x : A::max(x, lo);
}

template <typename C>
struct Box {
  C x1, y1, x2, y2, area;
};

// One box of a row, with box_area's (x2 - x1 + off) * (y2 - y1 + off).
template <typename S>
__device__ __forceinline__ Box<typename Arith<S>::C> load_box(
    const S* p, typename Arith<S>::C off) {
  using A = Arith<S>;
  Box<typename A::C> b;
  b.x1 = A::load(p);
  b.y1 = A::load(p + 1);
  b.x2 = A::load(p + 2);
  b.y2 = A::load(p + 3);
  b.area = A::mul(A::add(A::sub(b.x2, b.x1), off), A::add(A::sub(b.y2, b.y1), off));
  return b;
}

// box_iou(a, b) > thresh, with a the higher-scored box (boxes1's row).
template <typename S>
__device__ __forceinline__ bool overlaps(const Box<typename Arith<S>::C>& a,
                                         const Box<typename Arith<S>::C>& b,
                                         typename Arith<S>::C off,
                                         typename Arith<S>::C tiny,
                                         typename Arith<S>::C thresh) {
  using A = Arith<S>;
  using C = typename A::C;
  const C zero = C(0);
  const C lx = maximum<A>(a.x1, b.x1);
  const C ly = maximum<A>(a.y1, b.y1);
  const C rx = minimum<A>(a.x2, b.x2);
  const C ry = minimum<A>(a.y2, b.y2);
  const C w = clamp_min<A>(A::add(A::sub(rx, lx), off), zero);
  const C h = clamp_min<A>(A::add(A::sub(ry, ly), off), zero);
  const C inter = A::mul(w, h);
  // no overlap (or a NaN): the IoU is 0 or NaN, over no threshold >= 0
  if (!(inter > zero) && thresh >= zero) return false;
  const C denom = A::sub(A::add(a.area, b.area), inter);
  return A::div(inter, clamp_min<A>(denom, tiny)) > thresh;
}

// grid (words, words, rows); 64 threads, one a box of the row block.
template <typename S>
__global__ void __launch_bounds__(kChunk)
    nms_mask_kernel(const S* __restrict__ boxes, const bool* __restrict__ valid,
                    int n, int words, typename Arith<S>::C off,
                    typename Arith<S>::C tiny, typename Arith<S>::C thresh,
                    unsigned long long* __restrict__ mask) {
  using C = typename Arith<S>::C;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;
  const long long row = blockIdx.z;
  const S* b = boxes + row * n * 4;
  const bool* v = valid + row * n;
  __shared__ Box<C> cols[kChunk];
  __shared__ bool col_valid[kChunk];
  const int t = threadIdx.x;
  const int j0 = col_block * kChunk;
  const int ncols = min(kChunk, n - j0);
  if (t < ncols) {
    cols[t] = load_box(b + static_cast<long long>(j0 + t) * 4, off);
    col_valid[t] = v[j0 + t];
  }
  __syncthreads();
  const int i = row_block * kChunk + t;
  if (i >= n) return;
  unsigned long long bits = 0;
  if (v[i]) {
    const Box<C> a = load_box(b + static_cast<long long>(i) * 4, off);
    for (int k = row_block == col_block ? t + 1 : 0; k < ncols; ++k) {
      if (col_valid[k] && overlaps<S>(a, cols[k], off, tiny, thresh)) {
        bits |= 1ull << k;
      }
    }
  }
  mask[(row * n + i) * words + col_block] = bits;
}

// One block a row; dynamic shared memory: the removed set, `words` words.
// A chunk's diagonal words, validity and order come from registers loaded
// while the chunk before it was decided. Thread 0 walks only the boxes
// that remove a later box of the chunk (a non-zero diagonal word); a box
// whose word is zero is kept exactly when it is valid and not removed, which
// the walk's final removed word says. The kept boxes' slots follow from a
// popcount, written by a thread each, and the OR of their words into the
// removed set runs over (word, group of 8 boxes) pairs, atomicOr in shared
// memory. Every thread keeps the count of kept boxes itself.
__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const bool* __restrict__ valid,
                     const int64_t* __restrict__ order, int n, int words,
                     int max_output, int64_t* __restrict__ out_index,
                     bool* __restrict__ out_keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diagonal[kChunk];
  __shared__ int64_t chunk_order[kChunk];
  __shared__ unsigned int valid_bits[kChunk / 32];
  __shared__ unsigned int suppressor_bits[kChunk / 32];
  __shared__ unsigned long long kept_bits;
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned long long* m = mask + row * n * words;
  const bool* v = valid + row * n;
  const int64_t* o = order == nullptr ? nullptr : order + row * n;
  int64_t* idx = out_index + row * max_output;
  bool* keep = out_keep + row * max_output;
  for (int w = t; w < words; w += kSweepThreads) removed[w] = 0;
  // thread t < 64 holds box c * 64 + t of the next chunk c
  unsigned long long next_diagonal = 0ull;
  int64_t next_order = 0;
  bool next_valid = false;
  auto fetch = [&](int c) {
    const int i = c * kChunk + t;
    if (t < kChunk && c < words && i < n) {
      next_diagonal = m[static_cast<long long>(i) * words + c];
      next_order = o == nullptr ? i : o[i];
      next_valid = v[i];
    } else {
      next_diagonal = 0ull;
      next_valid = false;
    }
  };
  fetch(0);
  int count = 0;
  for (int c = 0; c < words; ++c) {
    const int base = c * kChunk;
    if (t < kChunk) {
      diagonal[t] = next_diagonal;
      chunk_order[t] = next_order;
      const unsigned int vb = __ballot_sync(0xffffffffu, next_valid);
      const unsigned int sb = __ballot_sync(0xffffffffu, next_diagonal != 0ull);
      if ((t & 31) == 0) {
        valid_bits[t >> 5] = vb;
        suppressor_bits[t >> 5] = sb;
      }
    }
    __syncthreads();
    fetch(c + 1);
    if (t == 0) {
      const unsigned long long vb =
          (static_cast<unsigned long long>(valid_bits[1]) << 32) | valid_bits[0];
      const unsigned long long sb =
          (static_cast<unsigned long long>(suppressor_bits[1]) << 32) | suppressor_bits[0];
      unsigned long long rem = removed[c];
      unsigned long long cand = vb & sb & ~rem;
      while (cand != 0ull) {
        const int k = __ffsll(static_cast<long long>(cand)) - 1;
        rem |= diagonal[k];  // only bits above k
        cand = k == kChunk - 1 ? 0ull : vb & sb & ~rem & (~0ull << (k + 1));
      }
      kept_bits = vb & ~rem;
    }
    __syncthreads();
    const unsigned long long kept = kept_bits;
    if (t < kChunk && ((kept >> t) & 1ull)) {
      const int slot = count + __popcll(kept & ((1ull << t) - 1ull));
      if (slot < max_output) {
        idx[slot] = chunk_order[t];
        keep[slot] = true;
      }
    }
    count += __popcll(kept);
    if (count >= max_output) break;
    const int pairs = (words - c - 1) * (kChunk / kGroup);
    for (int p = t; p < pairs; p += kSweepThreads) {
      const int w = c + 1 + p / (kChunk / kGroup);
      const int g = (p % (kChunk / kGroup)) * kGroup;
      const unsigned int bits = static_cast<unsigned int>(kept >> g) & ((1u << kGroup) - 1u);
      if (bits == 0u) continue;
      const unsigned long long* col = m + static_cast<long long>(base + g) * words + w;
      unsigned long long acc = 0ull;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if ((bits >> k) & 1u) acc |= col[static_cast<long long>(k) * words];
      }
      if (acc != 0ull) atomicOr(&removed[w], acc);
    }
    __syncthreads();
  }
  for (int s = count + t; s < max_output; s += kSweepThreads) {
    idx[s] = 0;
    keep[s] = false;
  }
}

template <typename S>
cudaError_t launch_mask(const void* boxes, const bool* valid, long long rows,
                        int n, int words, double off, double tiny,
                        double thresh, unsigned long long* mask,
                        cudaStream_t stream) {
  using C = typename Arith<S>::C;
  for (long long r0 = 0; r0 < rows; r0 += kMaxRowsPerGrid) {
    const int chunk = static_cast<int>(rows - r0 < kMaxRowsPerGrid ? rows - r0
                                                                    : kMaxRowsPerGrid);
    const dim3 grid(words, words, chunk);
    nms_mask_kernel<S><<<grid, kChunk, 0, stream>>>(
        static_cast<const S*>(boxes) + r0 * n * 4, valid + r0 * n, n, words,
        static_cast<C>(off), static_cast<C>(tiny), static_cast<C>(thresh),
        mask + r0 * n * words);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// boxes [rows, n, 4] sorted by descending score within each row (dtype 0
// float32, 1 bfloat16, 2 float64), valid [rows, n] bool, order [rows, n]
// int64 (each sorted box's index in the caller's input) or null for the
// identity, mask scratch [rows, n, ceil(n/64)] 64-bit words, out_index
// [rows, max_output] int64 and out_keep [rows, max_output] bool: all device
// memory, contiguous. `thresh` is the threshold as a value of the boxes'
// dtype, `tiny` that dtype's smallest normal. Returns the cudaError_t of the
// first launch that failed.
extern "C" int cpm_nms(const void* boxes, const void* valid, const void* order,
                       long long rows, int n, int dtype, double thresh,
                       double tiny, int legacy_plus1, int max_output,
                       void* mask, void* out_index, void* out_keep,
                       void* stream) {
  const int words = (n + kChunk - 1) / kChunk;
  if (rows < 1 || n < 1 || max_output < 1 || dtype < 0 || dtype > 2 ||
      words * static_cast<long long>(sizeof(unsigned long long)) > kMaxSweepShared ||
      rows > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* v = static_cast<const bool*>(valid);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  const double off = legacy_plus1 ? 1.0 : 0.0;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_mask<float>(boxes, v, rows, n, words, off, tiny, thresh, m, s);
  } else if (dtype == 1) {
    err = launch_mask<__nv_bfloat16>(boxes, v, rows, n, words, off, tiny, thresh, m, s);
  } else {
    err = launch_mask<double>(boxes, v, rows, n, words, off, tiny, thresh, m, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<static_cast<unsigned int>(rows), kSweepThreads,
                     words * sizeof(unsigned long long), s>>>(
      m, v, static_cast<const int64_t*>(order), n, words, max_output,
      static_cast<int64_t*>(out_index), static_cast<bool*>(out_keep));
  return static_cast<int>(cudaGetLastError());
}
