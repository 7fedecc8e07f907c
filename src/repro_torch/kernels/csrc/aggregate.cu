// Per-row scaled accumulate for Hopper (sm_90a): the Eq. 5 streaming
// accumulation of FedLDF's sequential-client (scan) round,
//     out[r, c] = acc[r, c] + w[r] * x[r, c]          (f32 result).
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py
// (masked_accumulate / _macc_kernel).
//
// What bounds it: bytes. Per element it reads acc (4 B) and x (4 or 2 B)
// and writes out (4 B) for one multiply and one add, far below the card's
// ratio of operations to bytes.
//
// What the design does about that:
// - One elementwise pass: rows on the grid's y axis, a grid-stride loop
//   over each row's columns on x, so w[row] is one load per row and no
//   thread divides to find its row. Each thread moves 4 consecutive
//   elements with one 16-byte load of acc, one 16- (f32) or 8-byte (bf16)
//   load of x and one 16-byte store when the row length is a multiple of
//   4 and the pointers are aligned (the caller decides); scalar otherwise.
// - `out` may be `acc` itself (an in-place accumulate, as the private
//   Eq. 5 accumulator of a round uses it): every element is read before it
//   is written by the same thread, so acc and out carry no __restrict__.
// - The product and the sum are rounded separately (__fmul_rn, __fadd_rn:
//   no fused multiply-add), so the kernel gives the same bits as the plain
//   PyTorch version acc + w[:, None] * x.
// - No padded copies: the TPU kernel padded to (8, 2048) blocks; here the
//   ragged end is just the end of the grid-stride loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Block (bx, by) walks row by (and every gridDim.y-th row after it) with a
// column grid-stride over groups of N elements; w[row] is loaded once.
template <typename TX, int N>
__global__ void __launch_bounds__(kThreads)
    masked_accumulate(const float* acc, const TX* __restrict__ x,
                      const float* __restrict__ w, float* out, long long rows,
                      long long cols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * N;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float wr = w[row];
    const long long base = row * cols;
    for (long long c = (static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x) * N;
         c < cols; c += stride) {
      const long long i = base + c;
      const Vec<float, N> va =
          *reinterpret_cast<const Vec<float, N>*>(acc + i);
      const Vec<TX, N> vx = *reinterpret_cast<const Vec<TX, N>*>(x + i);
      Vec<float, N> vo;
#pragma unroll
      for (int j = 0; j < N; ++j)
        vo.v[j] = __fadd_rn(va.v[j], __fmul_rn(wr, widen(vx.v[j])));
      *reinterpret_cast<Vec<float, N>*>(out + i) = vo;
    }
  }
}

template <typename TX, int N>
void launch(const float* acc, const void* x, const float* w, float* out,
            long long rows, long long cols, cudaStream_t stream) {
  long long bx = (cols / N + kThreads - 1) / kThreads;
  long long by = rows < kMaxGridY ? rows : kMaxGridY;
  if (bx * by > kMaxBlocks) bx = (kMaxBlocks + by - 1) / by;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  masked_accumulate<TX, N><<<grid, kThreads, 0, stream>>>(
      acc, static_cast<const TX*>(x), w, out, rows, cols);
}

}  // namespace

extern "C" {

// acc, out: (rows, cols) f32; x: (rows, cols), dtype 0 = f32, 1 = bf16;
// w: (rows,) f32; all contiguous; out may equal acc. vec != 0 selects the
// 4-wide path (cols % 4 == 0, acc/out 16-byte and x 16- or 8-byte
// aligned). Returns cudaGetLastError().
int repro_masked_accumulate(const float* acc, const void* x, const float* w,
                            float* out, long long rows, long long cols,
                            int x_dtype, int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows < 1 || cols < 1 || (x_dtype != 0 && x_dtype != 1) ||
      (vec && cols % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) {
    if (vec)
      launch<float, 4>(acc, x, w, out, rows, cols, stream);
    else
      launch<float, 1>(acc, x, w, out, rows, cols, stream);
  } else {
    if (vec)
      launch<__nv_bfloat16, 4>(acc, x, w, out, rows, cols, stream);
    else
      launch<__nv_bfloat16, 1>(acc, x, w, out, rows, cols, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
