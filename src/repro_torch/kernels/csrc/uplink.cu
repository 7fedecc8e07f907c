// Fused packed-uplink reduction for Hopper (sm_90a): dequantization of
// the clients' int8 levels and the Eq. 5 numerator in one pass, with the
// client-side error-feedback (EF) residual update in the second entry:
//     recon[k, r, c] = levels[k, r, c] * scales[k, r]
//     num[r, c]      = sum_k w[k, r] * recon[k, r, c]            (f32)
//     res[k, r, c]   = gate[k, r] * (v[k, r, c] - recon[k, r, c])
//                      + (1 - gate[k, r]) * e_old[k, r, c]       (f32, EF)
//
// Replaces the Pallas TPU kernels src/repro/kernels/uplink.py
// (fused_uplink / _uplink_kernel and fused_uplink_ef / _uplink_ef_kernel).
//
// What bounds it: bytes. Per element and client it reads one level byte
// (and, with EF, v and e_old at 4 or 2 bytes each and writes res at 4) for
// three to seven operations, far below the card's ratio of operations to
// bytes. On FedLDF's round a row is a whole parameter leaf (R = 1, C up to
// 2,359,296) and K = 20.
//
// What the design does about that:
// - One elementwise pass. Rows on the grid's y axis, a grid-stride loop
//   over each row's columns on x. Each thread owns 4 consecutive columns
//   (one 4-byte load of levels, 16-byte loads of f32 v/e_old or 8-byte of
//   bf16, 16-byte stores) when the row length is a multiple of 4 and the
//   pointers are aligned (the caller decides); one column otherwise.
// - The client axis is a loop inside the thread, k = 0 .. K-1 in
//   ascending order, with the numerator in registers: no atomics, no
//   second pass, and the same order as the plain PyTorch version. The TPU
//   kernel instead revisited an output block across a sequential grid
//   axis, which Hopper's unordered blocks cannot do.
// - The EF residual of client k is written at step k, so every byte is
//   read once and written once.
// - Each product and sum is rounded on its own (__fmul_rn, __fsub_rn,
//   __fadd_rn: no fused multiply-add), so the kernel gives the same bits
//   as the plain version, and gate == 0 keeps e_old exactly.
// - No padded copies: the TPU kernel padded to (32, 2048) blocks; here the
//   ragged end is just the end of the grid-stride loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr long long kMaxGridY = 65535;

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

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

// Block (bx, by) walks row by (and every gridDim.y-th row after it) with a
// column grid-stride over groups of N elements. EF selects the residual
// update; without it gate, v, e_old and res are not touched.
template <bool EF, typename TV, typename TE, int N>
__global__ void __launch_bounds__(kThreads)
    fused_uplink(const int8_t* __restrict__ levels,
                 const float* __restrict__ scales,
                 const float* __restrict__ w, const float* __restrict__ gate,
                 const TV* __restrict__ v, const TE* __restrict__ e_old,
                 float* __restrict__ num, float* __restrict__ res,
                 long long kk, long long rows, long long cols) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * N;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    for (long long c = (static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x) * N;
         c < cols; c += stride) {
      Vec<float, N> acc;
#pragma unroll
      for (int j = 0; j < N; ++j) acc.v[j] = 0.0f;
      for (long long k = 0; k < kk; ++k) {
        const long long kr = k * rows + row;
        const long long i = kr * cols + c;
        const float s = scales[kr];
        const float wk = w[kr];
        const Vec<int8_t, N> lv = load<int8_t, N>(levels + i);
        float recon[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          recon[j] = __fmul_rn(widen(lv.v[j]), s);
          acc.v[j] = __fadd_rn(acc.v[j], __fmul_rn(wk, recon[j]));
        }
        if constexpr (EF) {
          const float g = gate[kr];
          const float keep = __fsub_rn(1.0f, g);
          const Vec<TV, N> vv = load<TV, N>(v + i);
          const Vec<TE, N> ve = load<TE, N>(e_old + i);
          Vec<float, N> out;
#pragma unroll
          for (int j = 0; j < N; ++j)
            out.v[j] = __fadd_rn(
                __fmul_rn(g, __fsub_rn(widen(vv.v[j]), recon[j])),
                __fmul_rn(keep, widen(ve.v[j])));
          *reinterpret_cast<Vec<float, N>*>(res + i) = out;
        }
      }
      *reinterpret_cast<Vec<float, N>*>(num + row * cols + c) = acc;
    }
  }
}

template <bool EF, typename TV, typename TE, int N>
void launch(const int8_t* levels, const float* scales, const float* w,
            const float* gate, const void* v, const void* e_old, float* num,
            float* res, long long kk, long long rows, long long cols,
            cudaStream_t stream) {
  long long bx = (cols / N + kThreads - 1) / kThreads;
  long long by = rows < kMaxGridY ? rows : kMaxGridY;
  if (bx * by > kMaxBlocks) bx = (kMaxBlocks + by - 1) / by;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  fused_uplink<EF, TV, TE, N><<<grid, kThreads, 0, stream>>>(
      levels, scales, w, gate, static_cast<const TV*>(v),
      static_cast<const TE*>(e_old), num, res, kk, rows, cols);
}

template <typename TV, typename TE>
void launch_ef(const int8_t* levels, const float* scales, const float* w,
               const float* gate, const void* v, const void* e_old,
               float* num, float* res, long long kk, long long rows,
               long long cols, int vec, cudaStream_t stream) {
  if (vec)
    launch<true, TV, TE, 4>(levels, scales, w, gate, v, e_old, num, res, kk,
                            rows, cols, stream);
  else
    launch<true, TV, TE, 1>(levels, scales, w, gate, v, e_old, num, res, kk,
                            rows, cols, stream);
}

bool bad_shape(long long kk, long long rows, long long cols, int vec) {
  return kk < 1 || rows < 1 || cols < 1 || (vec && cols % 4);
}

}  // namespace

extern "C" {

// levels: (kk, rows, cols) int8; scales, w: (kk, rows) f32; num: (rows,
// cols) f32; all contiguous. vec != 0 selects the 4-wide path (cols % 4 ==
// 0, levels 4-byte and num 16-byte aligned). Returns cudaGetLastError().
int repro_fused_uplink(const int8_t* levels, const float* scales,
                       const float* w, float* num, long long kk,
                       long long rows, long long cols, int vec,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_shape(kk, rows, cols, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    launch<false, float, float, 4>(levels, scales, w, nullptr, nullptr,
                                   nullptr, num, nullptr, kk, rows, cols,
                                   stream);
  else
    launch<false, float, float, 1>(levels, scales, w, nullptr, nullptr,
                                   nullptr, num, nullptr, kk, rows, cols,
                                   stream);
  return static_cast<int>(cudaGetLastError());
}

// As repro_fused_uplink, plus gate: (kk, rows) f32, v and e_old: (kk,
// rows, cols) with dtype 0 = f32, 1 = bf16 each, and res: (kk, rows, cols)
// f32. The 4-wide path also needs v and e_old 16- (f32) or 8-byte (bf16)
// and res 16-byte aligned.
int repro_fused_uplink_ef(const int8_t* levels, const float* scales,
                          const float* w, const float* gate, const void* v,
                          const void* e_old, float* num, float* res,
                          long long kk, long long rows, long long cols,
                          int v_dtype, int e_dtype, int vec,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_shape(kk, rows, cols, vec) || (v_dtype != 0 && v_dtype != 1) ||
      (e_dtype != 0 && e_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (v_dtype == 0 && e_dtype == 0)
    launch_ef<float, float>(levels, scales, w, gate, v, e_old, num, res, kk,
                            rows, cols, vec, stream);
  else if (v_dtype == 0)
    launch_ef<float, __nv_bfloat16>(levels, scales, w, gate, v, e_old, num,
                                    res, kk, rows, cols, vec, stream);
  else if (e_dtype == 0)
    launch_ef<__nv_bfloat16, float>(levels, scales, w, gate, v, e_old, num,
                                    res, kk, rows, cols, vec, stream);
  else
    launch_ef<__nv_bfloat16, __nv_bfloat16>(levels, scales, w, gate, v,
                                            e_old, num, res, kk, rows, cols,
                                            vec, stream);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
