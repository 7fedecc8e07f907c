// Per-row scaled accumulate for Hopper (sm_90a) over a table of leaves:
// the Eq. 5 streaming accumulation of FedLDF's sequential-client (scan)
// round, for every leaf of one client in one launch,
//     out[r, c] = acc[r, c] + w[r] * x[r, c]          (f32 result).
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py
// (masked_accumulate / _macc_kernel).
//
// What bounds it: bytes. Per element it reads acc (4 B) and x (4 or 2 B)
// and writes out (4 B) for one multiply and one add, far below the card's
// ratio of operations to bytes. But a model's leaves are mostly tiny
// (VGG-9: 25 of 34 hold 512 elements or fewer), so one launch a leaf is
// bound by launches, ramps and tails instead: a client's add took 7x its
// byte bound that way.
//
// What the design does about that:
// - One launch covers every leaf of a client (leaf_table.cuh): the grid is
//   the table's total work, a block of kThreads threads covers
//   kThreads * width consecutive elements of one leaf, and a block finds
//   its leaf by a search over the table's block prefix sums.
// - A thread moves `width` consecutive elements (16 or 4 when the leaf
//   allows it, 1 otherwise) in 16-byte loads and stores (8-byte x loads
//   for 4 bf16), all loads issued before the arithmetic. Its row's weight
//   is one load (w[0] for a one-row leaf, no division).
// - `out` may be `acc` itself (an in-place accumulate, as the private
//   Eq. 5 accumulator of a round uses it): every element is read before it
//   is written by the same thread, so acc and out carry no __restrict__.
// - The product and the sum are rounded separately (__fmul_rn, __fadd_rn:
//   no fused multiply-add), so the kernel gives the same bits as the plain
//   PyTorch version acc + w[:, None] * x.
// - No padded copies: the TPU kernel padded to (8, 2048) blocks; here a
//   thread past a leaf's end does nothing.
#include "leaf_table.cuh"

namespace {

using leaf_table::kThreads;
using leaf_table::Table;

// Table pointers: 0 acc (f32), 1 x (dtype 0 = f32, 1 = bf16), 2 w (f32,
// one a row), 3 out (f32). Element sizes a dtype, for the alignment check.
constexpr int kEsize[2][4] = {{4, 4, 0, 4}, {4, 2, 0, 4}};

template <typename TX, int N>
__device__ __forceinline__ void accumulate(const Table& t, int leaf,
                                           long long e) {
  const long long rows = t.rows[leaf], cols = t.cols[leaf];
  if (e >= rows * cols) return;
  const float* acc = static_cast<const float*>(t.ptr[0][leaf]);
  const TX* x = static_cast<const TX*>(t.ptr[1][leaf]);
  const float* w = static_cast<const float*>(t.ptr[2][leaf]);
  float* out = static_cast<float*>(const_cast<void*>(t.ptr[3][leaf]));
  float a[N];
  TX xv[N];
  leaf_table::load_n<float, N>(acc + e, a);
  leaf_table::load_n<TX, N>(x + e, xv);
  const float wr = w[rows == 1 ? 0 : e / cols];
  float o[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    o[j] = __fadd_rn(a[j], __fmul_rn(wr, leaf_table::widen(xv[j])));
  leaf_table::store_n<float, N>(out + e, o);
}

template <typename TX>
__device__ __forceinline__ void accumulate_width(const Table& t, int leaf,
                                                 int width, long long e) {
  if (width == 16)
    accumulate<TX, 16>(t, leaf, e);
  else if (width == 4)
    accumulate<TX, 4>(t, leaf, e);
  else
    accumulate<TX, 1>(t, leaf, e);
}

__global__ void __launch_bounds__(kThreads)
    masked_accumulate_leaves(const __grid_constant__ Table t) {
  const int leaf = leaf_table::find_leaf(t, blockIdx.x);
  const int width = t.width[leaf];
  const long long e =
      (static_cast<long long>(blockIdx.x - t.start[leaf]) * kThreads +
       threadIdx.x) * width;
  if (t.dtype[leaf] == 0)
    accumulate_width<float>(t, leaf, width, e);
  else
    accumulate_width<__nv_bfloat16>(t, leaf, width, e);
}

}  // namespace

extern "C" {

// One launch over n <= 48 leaves. desc: n rows of 8 int64, (acc, x, w,
// out, rows, cols, x_dtype, width) with acc, out (rows, cols) f32, x (rows,
// cols) f32 (x_dtype 0) or bf16 (1), w (rows,) f32, all contiguous, out
// possibly acc; width 16, 4 or 1 elements a thread (cols a multiple of it,
// acc, out and x aligned to min(16, width * element size) bytes). starts:
// the n + 1 exclusive prefix sums of leaf_blocks(rows, cols, width, flat).
// Returns cudaGetLastError().
int repro_masked_accumulate_leaves(const long long* desc, const int* starts,
                                   int n, void* stream_ptr) {
  Table t;
  if (!leaf_table::fill(&t, desc, starts, n, false, kEsize, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  masked_accumulate_leaves<<<t.start[n], kThreads, 0,
                             static_cast<cudaStream_t>(stream_ptr)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
