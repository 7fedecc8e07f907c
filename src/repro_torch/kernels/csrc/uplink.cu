// Fused packed-uplink reduction for Hopper (sm_90a): dequantization of
// the clients' int8 levels and the Eq. 5 numerator in one pass, over a
// table of every leaf of a round, and, in the second entry, the same for
// one leaf with the client-side error-feedback (EF) residual update:
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
// 2,359,296) and K = 20; 25 of VGG-9's 34 leaves hold 512 elements or
// fewer, so one launch a leaf, each a chain of K dependent loads, was bound
// by launches and latency instead.
//
// What the table kernel (fused_uplink_leaves) does about that:
// - One launch covers every leaf of a round (leaf_table.cuh). A block
//   covers kThreads * width columns of one row of one leaf; its leaf is a
//   search over the table's block prefix sums.
// - The block stages the row's K scales and K weights in shared memory with
//   one coalesced load, and compacts the list of clients whose term can be
//   nonzero (below). A thread then issues its level loads for up to kChunk
//   clients at once (16 levels in one 16-byte load where the leaf allows
//   it), and only then accumulates them, in ascending k.
// - A client row whose weight is exactly 0 and whose scale is at most
//   FLT_MAX / 128 is skipped: its term w * (level * scale) is then +0 or
//   -0, and the f32 accumulator, which starts at +0 and is never -0 in
//   round-to-nearest, is left bit for bit by adding it. A non-finite or
//   huge scale is not skipped, so the NaN of 0 * inf still comes out as in
//   the plain version. With FedLDF's n = 4 of K = 20 this reads 4 of the 20
//   level rows of a leaf.
// - The client axis is a loop inside the thread with the numerator in
//   registers: no atomics, no second pass, and the same order as the plain
//   PyTorch version. The TPU kernel instead revisited an output block
//   across a sequential grid axis, which Hopper's unordered blocks cannot.
// - Each product and sum is rounded on its own (__fmul_rn, __fsub_rn,
//   __fadd_rn: no fused multiply-add), so both kernels give the same bits
//   as the plain versions, and gate == 0 keeps e_old exactly.
//
// The EF kernel (fused_uplink_ef) is still one launch a leaf: rows on the
// grid's y axis, a grid-stride loop over each row's columns on x, each
// thread owning 4 consecutive columns (one 4-byte load of levels, 16-byte
// loads of f32 v/e_old or 8-byte of bf16, 16-byte stores) when the row
// length is a multiple of 4 and the pointers are aligned (the caller
// decides), one column otherwise. The residual of client k is written at
// step k, so every byte is read once and written once.
#include <stdint.h>

#include "leaf_table.cuh"

namespace {

using leaf_table::kThreads;
using leaf_table::Table;
using leaf_table::Vec;
using leaf_table::widen;

constexpr long long kMaxBlocks = 132 * 16;
constexpr long long kMaxGridY = 65535;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                          // level loads in flight
constexpr float kSkipScale = 3.40282347e38f / 128.0f;   // |level| <= 128

// Table pointers: 0 levels (int8), 1 scales (f32), 2 w (f32), 3 num (f32);
// scales and w are (K, rows), read one at a time.
constexpr int kEsize[1][4] = {{1, 0, 0, 4}};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

// N int8 levels, loaded in one 16-, 4- or 1-byte load and kept packed in
// 32-bit words until each is used (unpacked at load they would take a
// register a level: 16 x kChunk of them).
template <int N>
struct Levels {
  uint32_t w[(N + 3) / 4];
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (N == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (N == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = static_cast<uint8_t>(*p);
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    return static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
};

// One block: kThreads * N columns of one row of one leaf.
template <int N>
__device__ __forceinline__ void uplink_tile(const Table& t, int leaf,
                                            long long kk, float* sh_s,
                                            float* sh_w, int* sh_k,
                                            int* sh_count) {
  const long long rows = t.rows[leaf], cols = t.cols[leaf];
  const long long span = static_cast<long long>(kThreads) * N;
  const long long tiles = (cols + span - 1) / span;
  const long long local = blockIdx.x - t.start[leaf];
  const long long row = local / tiles;
  const long long c = (local - row * tiles) * span +
                      static_cast<long long>(threadIdx.x) * N;
  const bool active = c < cols;
  const int8_t* levels = static_cast<const int8_t*>(t.ptr[0][leaf]);
  const float* scales = static_cast<const float*>(t.ptr[1][leaf]);
  const float* w = static_cast<const float*>(t.ptr[2][leaf]);
  float* num = static_cast<float*>(const_cast<void*>(t.ptr[3][leaf]));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
  for (long long kb = 0; kb < kk; kb += kThreads) {
    // stage kThreads clients' scale and weight; keep those whose term can
    // be nonzero, in ascending k
    const long long k = kb + threadIdx.x;
    float s = 0.0f, wk = 0.0f;
    bool keep = false;
    if (k < kk) {
      s = scales[k * rows + row];
      wk = w[k * rows + row];
      keep = !(wk == 0.0f && fabsf(s) <= kSkipScale);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) sh_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      slot += i < warp ? sh_count[i] : 0;
      total += sh_count[i];
    }
    if (keep) {
      sh_k[slot] = static_cast<int>(k);
      sh_s[slot] = s;
      sh_w[slot] = wk;
    }
    __syncthreads();
    if (active) {
      for (int j0 = 0; j0 < total; j0 += kChunk) {
        Levels<N> lv[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j0 + j < total)
            lv[j].load(levels + (sh_k[j0 + j] * rows + row) * cols + c);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j0 + j < total) {
            const float sj = sh_s[j0 + j], wj = sh_w[j0 + j];
#pragma unroll
            for (int i = 0; i < N; ++i)
              acc[i] = __fadd_rn(
                  acc[i], __fmul_rn(wj, __fmul_rn(lv[j][i], sj)));
          }
        }
      }
    }
    __syncthreads();   // the next stage rewrites the shared lists
  }
  if (active) leaf_table::store_n<float, N>(num + row * cols + c, acc);
}

__global__ void __launch_bounds__(kThreads)
    fused_uplink_leaves(const __grid_constant__ Table t, long long kk) {
  __shared__ float sh_s[kThreads], sh_w[kThreads];
  __shared__ int sh_k[kThreads], sh_count[kWarps];
  const int leaf = leaf_table::find_leaf(t, blockIdx.x);
  const int width = t.width[leaf];
  if (width == 16)
    uplink_tile<16>(t, leaf, kk, sh_s, sh_w, sh_k, sh_count);
  else if (width == 4)
    uplink_tile<4>(t, leaf, kk, sh_s, sh_w, sh_k, sh_count);
  else
    uplink_tile<1>(t, leaf, kk, sh_s, sh_w, sh_k, sh_count);
}

// Block (bx, by) walks row by (and every gridDim.y-th row after it) with a
// column grid-stride over groups of N elements.
template <typename TV, typename TE, int N>
__global__ void __launch_bounds__(kThreads)
    fused_uplink_ef(const int8_t* __restrict__ levels,
                    const float* __restrict__ scales,
                    const float* __restrict__ w,
                    const float* __restrict__ gate,
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
      *reinterpret_cast<Vec<float, N>*>(num + row * cols + c) = acc;
    }
  }
}

template <typename TV, typename TE, int N>
void launch_ef_width(const int8_t* levels, const float* scales,
                     const float* w, const float* gate, const void* v,
                     const void* e_old, float* num, float* res, long long kk,
                     long long rows, long long cols, cudaStream_t stream) {
  long long bx = (cols / N + kThreads - 1) / kThreads;
  long long by = rows < kMaxGridY ? rows : kMaxGridY;
  if (bx * by > kMaxBlocks) bx = (kMaxBlocks + by - 1) / by;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  fused_uplink_ef<TV, TE, N><<<grid, kThreads, 0, stream>>>(
      levels, scales, w, gate, static_cast<const TV*>(v),
      static_cast<const TE*>(e_old), num, res, kk, rows, cols);
}

template <typename TV, typename TE>
void launch_ef(const int8_t* levels, const float* scales, const float* w,
               const float* gate, const void* v, const void* e_old,
               float* num, float* res, long long kk, long long rows,
               long long cols, int vec, cudaStream_t stream) {
  if (vec)
    launch_ef_width<TV, TE, 4>(levels, scales, w, gate, v, e_old, num, res,
                               kk, rows, cols, stream);
  else
    launch_ef_width<TV, TE, 1>(levels, scales, w, gate, v, e_old, num, res,
                               kk, rows, cols, stream);
}

}  // namespace

extern "C" {

// One launch over n <= 48 leaves of K = kk clients. desc: n rows of 8
// int64, (levels, scales, w, num, rows, cols, 0, width) with levels (kk,
// rows, cols) int8, scales and w (kk, rows) f32, num (rows, cols) f32, all
// contiguous; width 16, 4 or 1 columns a thread (cols a multiple of it,
// levels aligned to width bytes and num to 16). starts: the n + 1
// exclusive prefix sums of leaf_blocks(rows, cols, width, per row).
// Returns cudaGetLastError().
int repro_fused_uplink_leaves(const long long* desc, const int* starts,
                              int n, long long kk, void* stream_ptr) {
  Table t;
  if (kk < 1 || kk > 0x7fffffff ||
      !leaf_table::fill(&t, desc, starts, n, true, kEsize, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  fused_uplink_leaves<<<t.start[n], kThreads, 0,
                        static_cast<cudaStream_t>(stream_ptr)>>>(t, kk);
  return static_cast<int>(cudaGetLastError());
}

// levels: (kk, rows, cols) int8; scales, w, gate: (kk, rows) f32; v and
// e_old: (kk, rows, cols) with dtype 0 = f32, 1 = bf16 each; num: (rows,
// cols) f32; res: (kk, rows, cols) f32; all contiguous. vec != 0 selects
// the 4-wide path (cols % 4 == 0, levels 4-byte, v and e_old 16- (f32) or
// 8-byte (bf16), num and res 16-byte aligned). Returns cudaGetLastError().
int repro_fused_uplink_ef(const int8_t* levels, const float* scales,
                          const float* w, const float* gate, const void* v,
                          const void* e_old, float* num, float* res,
                          long long kk, long long rows, long long cols,
                          int v_dtype, int e_dtype, int vec,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (kk < 1 || rows < 1 || cols < 1 || (vec && cols % 4) ||
      (v_dtype != 0 && v_dtype != 1) || (e_dtype != 0 && e_dtype != 1))
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
