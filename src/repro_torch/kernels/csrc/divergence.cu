// Per-unit sum of squared differences for Hopper (sm_90a) over a table of
// leaves: FedLDF's Eq. 3 layer divergence of K clients, for every leaf of
// a model in one C call,
//     row[i][r]  = sum_c (a_i[r, c] - b_i[r % n_i, c])^2         (f32)
//     out[k, u]  = ((0 + row[i0][k n + j]) + row[i1][k n + j]) + ...
// where leaf i has n_i = rows_i / K rows of b (its units u_i .. u_i + n_i - 1,
// unit u_i + j on row k n_i + j of a) and i0 < i1 < ... are the leaves of
// unit u in table order.
//
// Replaces the Pallas TPU kernel src/repro/kernels/divergence.py
// (sqdiff_rowsum / _sqdiff_kernel).
//
// What bounds it: bytes. Every element of `a` is read once and takes two
// floating-point operations, so at 3.35 TB/s the card needs about
// 1 / 3.35e12 s per byte of input; no arithmetic unit comes close. But a
// model's leaves are mostly tiny (VGG-9: 25 of 34 hold 512 elements or
// fewer), and one scan-round client has only K = 1 row a leaf: one launch
// a leaf was bound by launches, ramps and tails (14x its byte bound), and
// the host spent more time on the 34 launches and ~50 small PyTorch ops
// that built each unit's sum than the card spent on the work.
//
// What the design does about that:
// - Pass 1 is one launch over every leaf (leaf_table.cuh). A block covers
//   kThreads * width columns of one row of one leaf and writes one f32
//   partial, in a fixed order (per-thread sums over `width` elements, then
//   a fixed warp-shuffle tree and a fixed sum over the warps). Blocks are
//   ordered tile-major within a leaf: the K client rows that compare with
//   one tile of b are neighbouring blocks, so b is read from device memory
//   about once and from L2 the other K - 1 times.
// - Pass 2, a second launch from the same C call, is one block an output
//   (k, u): its warps sum the rows of unit u's leaves, each from its
//   partials in a fixed order (lane-strided with several loads in flight,
//   then a fixed shuffle tree), and one thread adds them to the unit's sum
//   in table order, starting from 0 (or from out, for a later chunk of a
//   table longer than one launch holds). So each unit's sum adds its
//   leaves exactly as UnitMap.sq_divergence composes them from per-leaf
//   row sums. A second launch was chosen over the "last block finishes"
//   pattern: that needs a zeroed counter buffer (a memset launch, or a
//   cached buffer that two streams could share) and a fence in every
//   block, to save one launch gap (PERF.md has the measurement).
// - No float atomics: the result is the same from run to run, which top-n
//   selection (Eq. 4) needs, since it ranks these sums.
// - `b` has n_i rows and is broadcast over the K clients, so the global
//   model is never copied K times.
// - Loads are 16 bytes wide when the leaf allows it (16 or 4 elements a
//   thread, the columns a multiple of it, a and b aligned), scalar
//   otherwise; a scalar leaf (VGG-9's fc.b) runs in the same launch. bf16
//   is widened with __bfloat162float; every sum is f32.
#include "leaf_table.cuh"

namespace {

using leaf_table::kThreads;
using Table = leaf_table::TableOf<2>;

constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;     // pass 2: partial loads in flight a lane

// Table pointers: 0 a, 1 b; dtype 0 = f32, 1 = bf16 (both the same).
constexpr int kEsize[2][2] = {{4, 4}, {2, 2}};

// Sum of `v` over the block in a fixed order; valid in thread 0 only.
__device__ __forceinline__ float block_sum(float v, float* warp_part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) v += warp_part[i];
  }
  return v;
}

// One block: kThreads * N columns of one row of one leaf.
template <typename T, int N>
__device__ __forceinline__ float sqdiff_tile(const Table& t, int leaf,
                                             long long kk) {
  // rows <= blocks < 2^31 (the C entry checks), so 32-bit division serves
  const unsigned rows = static_cast<unsigned>(t.rows[leaf]);
  const long long cols = t.cols[leaf];
  const unsigned local = blockIdx.x - t.start[leaf];
  const unsigned tile = local / rows, row = local - tile * rows;
  const long long c =
      (static_cast<long long>(tile) * kThreads + threadIdx.x) * N;
  float s = 0.f;
  if (c < cols) {
    const T* a = static_cast<const T*>(t.ptr[0][leaf]) + row * cols + c;
    const T* b = static_cast<const T*>(t.ptr[1][leaf]) +
                 (row % (rows / static_cast<unsigned>(kk))) * cols + c;
    T va[N], vb[N];
    leaf_table::load_n<T, N>(a, va);
    leaf_table::load_n<T, N>(b, vb);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = leaf_table::widen(va[j]) - leaf_table::widen(vb[j]);
      s += d * d;
    }
  }
  return s;
}

template <typename T>
__device__ __forceinline__ float sqdiff_width(const Table& t, int leaf,
                                              long long kk) {
  const int width = t.width[leaf];
  if (width == 16) return sqdiff_tile<T, 16>(t, leaf, kk);
  if (width == 4) return sqdiff_tile<T, 4>(t, leaf, kk);
  return sqdiff_tile<T, 1>(t, leaf, kk);
}

// Pass 1: block b writes partial[b].
__global__ void __launch_bounds__(kThreads)
    sqdiff_partials(const __grid_constant__ Table t, long long kk,
                    float* __restrict__ partial) {
  __shared__ float warp_part[kWarps];
  const int leaf = leaf_table::find_leaf(t, blockIdx.x);
  const float s = t.dtype[leaf] == 0
                      ? sqdiff_width<float>(t, leaf, kk)
                      : sqdiff_width<__nv_bfloat16>(t, leaf, kk);
  const float total = block_sum(s, warp_part);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// Pass 2: block o finishes out[o] = out[k * units + u]. Warp w sums the
// row of leaves w, w + kWarps, ... that belong to unit u, each in a fixed
// order (lane-strided, kBatch loads issued before they are added, then a
// fixed shuffle tree), so the leaves' latencies overlap; thread 0 then adds
// them to the unit's sum in leaf order.
__global__ void __launch_bounds__(kThreads)
    sqdiff_units(const __grid_constant__ Table t, long long kk,
                 long long units, const float* __restrict__ partial,
                 float* __restrict__ out, int first) {
  __shared__ float leaf_sum[leaf_table::kMaxLeaves];
  __shared__ bool member[leaf_table::kMaxLeaves];
  // every count here is below 2^31 (the C entry checks), so 32-bit
  // division serves
  const unsigned o = blockIdx.x, nu = static_cast<unsigned>(units);
  const unsigned k = o / nu, u = o - k * nu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int leaf = warp; leaf < t.n; leaf += kWarps) {
    const unsigned rows = static_cast<unsigned>(t.rows[leaf]);
    const unsigned n = rows / static_cast<unsigned>(kk);
    const unsigned u0 = t.unit[leaf];
    const bool in_unit = u >= u0 && u < u0 + n;     // the same for the warp
    if (lane == 0) member[leaf] = in_unit;
    if (!in_unit) continue;
    const unsigned row = k * n + (u - u0);
    const unsigned tiles = (t.start[leaf + 1] - t.start[leaf]) / rows;
    const float* p = partial + t.start[leaf] + row;   // tile-major
    float s = 0.f;
    for (unsigned i0 = lane; i0 < tiles; i0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const unsigned i = i0 + 32 * j;
        // s + 0 == s: s is never -0
        v[j] = i < tiles ? p[static_cast<long long>(i) * rows] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) s += v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) leaf_sum[leaf] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = first ? 0.f : out[o];
    for (int leaf = 0; leaf < t.n; ++leaf)
      if (member[leaf]) acc = acc + leaf_sum[leaf];
    out[o] = acc;
  }
}

}  // namespace

extern "C" {

// One call, two launches, over n <= 48 leaves of K = kk clients. desc: n
// rows of 7 int64, (a, b, rows, cols, dtype, width, unit) with a (rows,
// cols) and b (rows / kk, cols), both f32 (dtype 0) or both bf16 (1),
// contiguous; width 16, 4 or 1 columns a thread (cols a multiple of it, a
// and b aligned to min(16, width * element size) bytes); the leaf's rows of
// b are units unit .. unit + rows / kk - 1 (< units). starts: the n + 1
// exclusive prefix sums of leaf_blocks(rows, cols, width, per row).
// partial: scratch of starts[n] floats. out: (kk, units) f32; first != 0
// starts each sum from 0 (and writes every entry), else from out (a later
// chunk of the same table). Returns cudaGetLastError().
int repro_sqdiff_rowsum_leaves(const long long* desc, const int* starts,
                               int n, long long kk, long long units,
                               float* partial, float* out, int first,
                               void* stream_ptr) {
  Table t;
  if (kk < 1 || units < 1 || kk * units > 0x7fffffff ||
      !leaf_table::fill(&t, desc, starts, n, true, kEsize, 2, 16, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i)
    if (t.rows[i] % kk || t.unit[i] + t.rows[i] / kk > units)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  sqdiff_partials<<<t.start[n], kThreads, 0, stream>>>(t, kk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sqdiff_units<<<static_cast<unsigned>(kk * units), kThreads, 0, stream>>>(
      t, kk, units, partial, out, first);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
