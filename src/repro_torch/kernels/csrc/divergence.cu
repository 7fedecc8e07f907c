// Per-row sum of squared differences for Hopper (sm_90a): the inner
// reduction of FedLDF's Eq. 3 layer divergence,
//     out[r] = sum_c (a[r, c] - b[r % rows_b, c])^2      (f32 result).
//
// Replaces the Pallas TPU kernel src/repro/kernels/divergence.py
// (sqdiff_rowsum / _sqdiff_kernel).
//
// What bounds it: bytes. Every element of `a` is read once and takes two
// floating-point operations, so at 3.35 TB/s the card needs about
// 1 / 3.35e12 s per byte of input; no arithmetic unit comes close.
//
// What the design does about that:
// - On the main path a row is one whole parameter leaf (up to 2,359,296
//   columns for VGG-9's conv7.w) and there are only K <= 20 rows, so one
//   block per row would occupy at most 20 of the 132 SMs. Pass 1 therefore
//   cuts every row into chunks of `chunk` columns, one block per
//   (row, chunk), and each block writes one f32 partial to a scratch buffer
//   that the caller allocates. Pass 2 sums each row's partials.
// - Both passes add in a fixed order (per-thread strided sums, then a
//   fixed warp-shuffle tree). There are no float atomics, so the result is
//   the same from run to run: top-n selection (Eq. 4) ranks these values.
// - `b` has rows_b rows and is broadcast over rows / rows_b clients, so the
//   client-stacked divergence of a round is one launch per parameter leaf
//   and the global model is never copied K times.
// - Loads are 16 bytes wide when the row length and the base pointers
//   allow it (the caller decides), scalar otherwise. bf16 is widened with
//   __bfloat162float; every sum is f32.
// - When a row fits in one chunk, pass 1 writes `out` directly and pass 2
//   is skipped.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Sum of `v` over the block in a fixed order; valid in thread 0 only.
__device__ float block_sum(float v) {
  __shared__ float warp_part[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_part[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Pass 1: block `blk` = row * nchunks + chunk sums its chunk of the row
// into partial[blk]. With N > 1 the caller guarantees that cols and chunk
// are multiples of N and that a and b are 16-byte aligned.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    sqdiff_partial(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ partial, long long cols,
                   long long rows_b, long long chunk, long long nchunks) {
  const long long blk = blockIdx.x;
  const long long row = blk / nchunks;
  const long long c0 = (blk % nchunks) * chunk;
  const long long c1 = min(c0 + chunk, cols);
  const T* ar = a + row * cols;
  const T* br = b + (row % rows_b) * cols;
  float s = 0.f;
  for (long long i = c0 + static_cast<long long>(threadIdx.x) * N; i < c1;
       i += static_cast<long long>(kThreads) * N) {
    const Vec<T, N> va = *reinterpret_cast<const Vec<T, N>*>(ar + i);
    const Vec<T, N> vb = *reinterpret_cast<const Vec<T, N>*>(br + i);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = widen(va.v[j]) - widen(vb.v[j]);
      s += d * d;
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blk] = s;
}

// Pass 2: block `row` sums partial[row * nchunks : (row + 1) * nchunks].
__global__ void __launch_bounds__(kThreads)
    sum_partials(const float* __restrict__ partial, float* __restrict__ out,
                 long long nchunks) {
  const long long row = blockIdx.x;
  float s = 0.f;
  for (long long i = threadIdx.x; i < nchunks; i += kThreads)
    s += partial[row * nchunks + i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[row] = s;
}

template <typename T, int N>
void launch_partial(const void* a, const void* b, float* partial,
                    long long blocks, long long cols, long long rows_b,
                    long long chunk, long long nchunks, cudaStream_t stream) {
  sqdiff_partial<T, N><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(static_cast<const T*>(a),
                                   static_cast<const T*>(b), partial, cols,
                                   rows_b, chunk, nchunks);
}

}  // namespace

extern "C" {

// a: (rows, cols), b: (rows_b, cols), same dtype (0 = f32, 1 = bf16),
// contiguous, rows % rows_b == 0. out: (rows,) f32. partial: scratch of
// rows * ceil(cols / chunk) floats (unused when that ceiling is 1).
// vec != 0 selects 16-byte loads. Returns cudaGetLastError().
int repro_sqdiff_rowsum(const void* a, const void* b, float* partial,
                        float* out, long long rows, long long rows_b,
                        long long cols, long long chunk, int dtype, int vec,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long nchunks = (cols + chunk - 1) / chunk;
  if (rows < 1 || cols < 1 || chunk < 8 || chunk % 8 || rows_b < 1 ||
      rows % rows_b || rows * nchunks > INT_MAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* first = nchunks == 1 ? out : partial;
  const long long blocks = rows * nchunks;
  if (dtype == 0) {
    if (vec)
      launch_partial<float, 4>(a, b, first, blocks, cols, rows_b, chunk,
                               nchunks, stream);
    else
      launch_partial<float, 1>(a, b, first, blocks, cols, rows_b, chunk,
                               nchunks, stream);
  } else {
    if (vec)
      launch_partial<__nv_bfloat16, 8>(a, b, first, blocks, cols, rows_b,
                                       chunk, nchunks, stream);
    else
      launch_partial<__nv_bfloat16, 1>(a, b, first, blocks, cols, rows_b,
                                       chunk, nchunks, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return static_cast<int>(err);
  sum_partials<<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      partial, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
