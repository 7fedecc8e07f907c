// The leaf table: every parameter leaf of a model in one kernel launch.
//
// FedLDF's per-leaf kernels (sqdiff_rowsum, masked_accumulate, fused_uplink,
// fused_uplink_ef) see a model as a list of leaves, most of them tiny:
// full-width VGG-9 has 34, of which 25 hold 512 elements or fewer. One
// launch a leaf pays a launch, a ramp and a tail for a few hundred
// nanoseconds of work each. The table lets one launch cover them all:
//
// - The table is a by-value struct passed as a __grid_constant__ kernel
//   parameter, so it lives in parameter (constant) space: no device copy,
//   no staging buffer that a later call could overwrite before an earlier
//   copy has run. It stays within the classic 4 KB parameter limit, which
//   caps a table at kMaxLeaves leaves for up to kMaxPtrs pointers a leaf;
//   the host cuts a longer list into several launches (kernels/_leaves.py
//   plans them).
// - For each leaf it holds P pointers (their meaning is the kernel's), the
//   leaf's rows and columns, a dtype code, a vector width (16, 8 or 4
//   elements a thread when the columns are a multiple of it and every
//   pointer is aligned for it, 1 otherwise; each kernel names the widths it
//   takes) and the leaf's first layer unit (for kernels that read or reduce
//   per unit; 0 where unused). A scalar leaf (VGG-9's fc.b, 10 columns) runs
//   in the same launch as the vectorised ones.
// - start[] is the exclusive prefix sum of blocks a leaf. The grid is its
//   total; a block finds its leaf by a binary search over start[] (at most
//   kMaxLeaves entries, the same for every thread of the block, read from
//   parameter space).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace leaf_table {

constexpr int kThreads = 256;    // a block; kernels/_leaves.py THREADS
constexpr int kMaxLeaves = 48;   // a launch; kernels/_leaves.py MAX_LEAVES
constexpr int kMaxPtrs = 5;      // pointers a leaf that still fit 4 KB
constexpr int kInts = 5;         // rows, cols, dtype, width, unit after the
                                 // pointers in the host description

template <int P, int L = kMaxLeaves>
struct TableOf {
  static constexpr int kPtrs = P;
  static constexpr int kLeaves = L;
  const void* ptr[P][L];
  long long rows[L];
  long long cols[L];
  int start[L + 1];              // exclusive prefix sum of blocks
  int unit[L];                   // the leaf's first layer unit
  unsigned char dtype[L];
  unsigned char width[L];
  int n;
};
static_assert(sizeof(TableOf<kMaxPtrs>) + 64 <= 4096,
              "the table and a few scalars must fit 4 KB of parameters");

// Blocks a leaf takes: kThreads threads of `width` elements each, over the
// flat leaf, or (per_row) over each row on its own.
__host__ __device__ inline long long leaf_blocks(long long rows,
                                                 long long cols, int width,
                                                 bool per_row) {
  const long long span = static_cast<long long>(kThreads) * width;
  return per_row ? rows * ((cols + span - 1) / span)
                 : (rows * cols + span - 1) / span;
}

// Fill *t from the host description: n rows of P + kInts int64 (P
// pointers, rows, cols, dtype, width, unit) and n + 1 block starts.
// esize[dtype][p] is the element size of pointer p for that dtype (0: not
// read as a vector, no alignment needed), for dtype < n_dtypes; width_a
// and width_b are the kernel's vector widths besides 1. Returns false on
// anything the kernel does not take: a bad count, shape, dtype, width or
// unit, a misaligned vector pointer, or starts that disagree with
// leaf_blocks.
template <int P, int L>
inline bool fill(TableOf<P, L>* t, const long long* desc, const int* starts,
                 int n, bool per_row, const int (*esize)[P], int n_dtypes,
                 int width_a, int width_b) {
  if (n < 1 || n > L || starts[0] != 0) return false;
  t->n = n;
  t->start[0] = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + static_cast<long long>(i) * (P + kInts);
    const long long rows = d[P], cols = d[P + 1], dtype = d[P + 2],
                    width = d[P + 3], unit = d[P + 4];
    if (rows < 1 || cols < 1 || dtype < 0 || dtype >= n_dtypes ||
        (width != 1 && width != width_a && width != width_b) || cols % width ||
        unit < 0 || unit > 0x7fffffff)
      return false;
    if (starts[i + 1] - static_cast<long long>(starts[i]) !=
        leaf_blocks(rows, cols, static_cast<int>(width), per_row))
      return false;
    for (int p = 0; p < P; ++p) {
      const long long es = esize[dtype][p];
      const long long align = width * es < 16 ? width * es : 16;
      if (es && d[p] % align) return false;
      t->ptr[p][i] = reinterpret_cast<const void*>(d[p]);
    }
    t->rows[i] = rows;
    t->cols[i] = cols;
    t->dtype[i] = static_cast<unsigned char>(dtype);
    t->width[i] = static_cast<unsigned char>(width);
    t->unit[i] = static_cast<int>(unit);
    t->start[i + 1] = starts[i + 1];
  }
  return true;
}

// The leaf of block b: the largest i with start[i] <= b.
template <class Table>
__device__ __forceinline__ int find_leaf(const Table& t, int b) {
  int lo = 0, hi = t.n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.start[mid] <= b)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N consecutive elements at p, in loads of at most 16 bytes; p is aligned
// to min(16, N * sizeof(T)) bytes.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, T (&out)[N]) {
  constexpr int kPer = N * sizeof(T) < 16 ? N : 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N; i += kPer) {
    const Vec<T, kPer> v = *reinterpret_cast<const Vec<T, kPer>*>(p + i);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[i + j] = v.v[j];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const T (&in)[N]) {
  constexpr int kPer = N * sizeof(T) < 16 ? N : 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N; i += kPer) {
    Vec<T, kPer> v;
#pragma unroll
    for (int j = 0; j < kPer; ++j) v.v[j] = in[i + j];
    *reinterpret_cast<Vec<T, kPer>*>(p + i) = v;
  }
}

}  // namespace leaf_table
