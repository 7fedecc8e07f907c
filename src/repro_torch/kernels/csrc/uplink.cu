// Fused packed-uplink reduction for Hopper (sm_90a): dequantization of
// the clients' int8 levels and the Eq. 5 numerator in one pass, and, in
// the second kernel, the same with the client-side error-feedback (EF)
// residual update, each over a table of every leaf of a round:
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
// What both table kernels do about that:
// - One launch covers every leaf of a round (leaf_table.cuh). A block
//   covers kThreads * width columns of one row of one leaf; its leaf is a
//   search over the table's block prefix sums.
// - The block stages the row's K scales and K weights (and, with EF, K
//   gates) in shared memory with one coalesced load, so no thread waits on
//   a scalar load a client.
// - The client axis is a loop inside the thread with the numerator in
//   registers: no atomics, no second pass, and the same order as the plain
//   PyTorch version. The TPU kernel instead revisited an output block
//   across a sequential grid axis, which Hopper's unordered blocks cannot.
// - Each product and sum is rounded on its own (__fmul_rn, __fsub_rn,
//   __fadd_rn: no fused multiply-add), so both kernels give the same bits
//   as the plain versions, and gate == 0 keeps e_old exactly.
//
// fused_uplink_leaves (no EF) also compacts the list of clients whose term
// can be nonzero. A thread then issues its level loads for up to kChunk
// clients at once (16 levels in one 16-byte load where the leaf allows
// it), and only then accumulates them, in ascending k. A client row whose
// weight is exactly 0 and whose scale is at most FLT_MAX / 128 is skipped:
// its term w * (level * scale) is then +0 or -0, and the f32 accumulator,
// which starts at +0 and is never -0 in round-to-nearest, is left bit for
// bit by adding it. A non-finite or huge scale is not skipped, so the NaN
// of 0 * inf still comes out as in the plain version. With FedLDF's n = 4
// of K = 20 this reads 4 of the 20 level rows of a leaf.
//
// fused_uplink_ef_leaves must write every residual, so it reads every
// client row (the levels too: the residual needs recon, and 0 * (v -
// recon) is NaN for a non-finite v or a huge recon, so skipping a row
// would need a proof per element). A thread owns 8 columns where the leaf
// allows it (an 8-byte level load, 16-byte loads of v and e_old), issues
// kEfChunk clients' loads before using any of them, and writes res with
// streaming (evict-first) stores: the round does not read it back. Scales,
// weights and gates are the round's shared (K, U) matrices, indexed by the
// leaf's unit, so the caller slices and copies nothing a leaf.
#include <stdint.h>

#include "leaf_table.cuh"

namespace {

using leaf_table::kThreads;
using leaf_table::Vec;
using leaf_table::widen;
using Table = leaf_table::TableOf<4>;
using EfTable = leaf_table::TableOf<5>;

constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                          // level loads in flight
constexpr int kEfChunk = 4;                        // EF clients in flight
constexpr float kSkipScale = 3.40282347e38f / 128.0f;   // |level| <= 128

// Table pointers: 0 levels (int8), 1 scales (f32), 2 w (f32), 3 num (f32);
// scales and w are (K, rows), read one at a time.
constexpr int kEsize[1][4] = {{1, 0, 0, 4}};

// EF table pointers: 0 levels (int8), 1 v, 2 e_old (dtype = v_dtype + 2 *
// e_dtype, 0 = f32 and 1 = bf16 each), 3 num (f32), 4 res (f32).
constexpr int kEfEsize[4][5] = {
    {1, 4, 4, 4, 4}, {1, 2, 4, 4, 4}, {1, 4, 2, 4, 4}, {1, 2, 2, 4, 4}};

// N int8 levels, loaded in one 16-, 8-, 4- or 1-byte load and kept packed in
// 32-bit words until each is used (unpacked at load they would take a
// register a level: 16 x kChunk of them).
template <int N>
struct Levels {
  uint32_t w[(N + 3) / 4];
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (N == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (N == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
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

// N floats at p (aligned to min(16, 4 N) bytes) with streaming stores.
template <int N>
__device__ __forceinline__ void store_streaming(float* p,
                                                const float (&in)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(in[i], in[i + 1], in[i + 2], in[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) __stcs(p + i, in[i]);
  }
}

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

// The EF kernel, one block: kThreads * N columns of one row of one leaf,
// every client k of that row in ascending order, kEfChunk clients' loads
// issued before any of them is used.
template <typename TV, typename TE, int N>
__device__ __forceinline__ void ef_tile(const EfTable& t, int leaf,
                                        long long kk, long long units,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ w,
                                        const float* __restrict__ gate,
                                        float* sh_s, float* sh_w,
                                        float* sh_g) {
  const long long rows = t.rows[leaf], cols = t.cols[leaf];
  const long long span = static_cast<long long>(kThreads) * N;
  const long long tiles = (cols + span - 1) / span;
  const long long local = blockIdx.x - t.start[leaf];
  const long long row = local / tiles;
  const long long c = (local - row * tiles) * span +
                      static_cast<long long>(threadIdx.x) * N;
  const bool active = c < cols;
  const long long unit = t.unit[leaf] + row;
  const long long plane = rows * cols;        // one client's elements
  const long long base = row * cols + c;
  const int8_t* levels = static_cast<const int8_t*>(t.ptr[0][leaf]);
  const TV* v = static_cast<const TV*>(t.ptr[1][leaf]);
  const TE* e_old = static_cast<const TE*>(t.ptr[2][leaf]);
  float* num = static_cast<float*>(const_cast<void*>(t.ptr[3][leaf]));
  float* res = static_cast<float*>(const_cast<void*>(t.ptr[4][leaf]));

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  for (long long kb = 0; kb < kk; kb += kThreads) {
    // stage kThreads clients' scale, weight and gate of this row's unit
    const long long k = kb + threadIdx.x;
    if (k < kk) {
      sh_s[threadIdx.x] = scales[k * units + unit];
      sh_w[threadIdx.x] = w[k * units + unit];
      sh_g[threadIdx.x] = gate[k * units + unit];
    }
    __syncthreads();
    const int kn = static_cast<int>(kk - kb < kThreads ? kk - kb : kThreads);
    if (active) {
      for (int j0 = 0; j0 < kn; j0 += kEfChunk) {
        Levels<N> lv[kEfChunk];
        TV vv[kEfChunk][N];
        TE ee[kEfChunk][N];
#pragma unroll
        for (int j = 0; j < kEfChunk; ++j) {
          if (j0 + j < kn) {
            const long long i = (kb + j0 + j) * plane + base;
            lv[j].load(levels + i);
            leaf_table::load_n<TV, N>(v + i, vv[j]);
            leaf_table::load_n<TE, N>(e_old + i, ee[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kEfChunk; ++j) {
          if (j0 + j < kn) {
            const float s = sh_s[j0 + j], wk = sh_w[j0 + j];
            const float g = sh_g[j0 + j], keep = __fsub_rn(1.0f, g);
            float out[N];
#pragma unroll
            for (int i = 0; i < N; ++i) {
              const float recon = __fmul_rn(lv[j][i], s);
              acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, recon));
              out[i] = __fadd_rn(
                  __fmul_rn(g, __fsub_rn(widen(vv[j][i]), recon)),
                  __fmul_rn(keep, widen(ee[j][i])));
            }
            store_streaming<N>(res + (kb + j0 + j) * plane + base, out);
          }
        }
      }
    }
    __syncthreads();   // the next stage rewrites the shared lists
  }
  if (active) leaf_table::store_n<float, N>(num + base, acc);
}

template <typename TV, typename TE>
__device__ __forceinline__ void ef_width(const EfTable& t, int leaf,
                                         long long kk, long long units,
                                         const float* scales, const float* w,
                                         const float* gate, float* sh_s,
                                         float* sh_w, float* sh_g) {
  const int width = t.width[leaf];
  if (width == 8)
    ef_tile<TV, TE, 8>(t, leaf, kk, units, scales, w, gate, sh_s, sh_w,
                       sh_g);
  else if (width == 4)
    ef_tile<TV, TE, 4>(t, leaf, kk, units, scales, w, gate, sh_s, sh_w,
                       sh_g);
  else
    ef_tile<TV, TE, 1>(t, leaf, kk, units, scales, w, gate, sh_s, sh_w,
                       sh_g);
}

__global__ void __launch_bounds__(kThreads, 2)
    fused_uplink_ef_leaves(const __grid_constant__ EfTable t, long long kk,
                           long long units, const float* __restrict__ scales,
                           const float* __restrict__ w,
                           const float* __restrict__ gate) {
  __shared__ float sh_s[kThreads], sh_w[kThreads], sh_g[kThreads];
  const int leaf = leaf_table::find_leaf(t, blockIdx.x);
  switch (t.dtype[leaf]) {     // v_dtype + 2 * e_dtype; 0 f32, 1 bf16
    case 0:
      ef_width<float, float>(t, leaf, kk, units, scales, w, gate, sh_s,
                             sh_w, sh_g);
      break;
    case 1:
      ef_width<__nv_bfloat16, float>(t, leaf, kk, units, scales, w, gate,
                                     sh_s, sh_w, sh_g);
      break;
    case 2:
      ef_width<float, __nv_bfloat16>(t, leaf, kk, units, scales, w, gate,
                                     sh_s, sh_w, sh_g);
      break;
    default:
      ef_width<__nv_bfloat16, __nv_bfloat16>(t, leaf, kk, units, scales, w,
                                             gate, sh_s, sh_w, sh_g);
  }
}

}  // namespace

extern "C" {

// One launch over n <= 48 leaves of K = kk clients. desc: n rows of 9
// int64, (levels, scales, w, num, rows, cols, 0, width, unit = 0) with levels (kk,
// rows, cols) int8, scales and w (kk, rows) f32, num (rows, cols) f32, all
// contiguous; width 16, 4 or 1 columns a thread (cols a multiple of it,
// levels aligned to width bytes and num to 16). starts: the n + 1
// exclusive prefix sums of leaf_blocks(rows, cols, width, per row).
// Returns cudaGetLastError().
int repro_fused_uplink_leaves(const long long* desc, const int* starts,
                              int n, long long kk, void* stream_ptr) {
  Table t;
  if (kk < 1 || kk > 0x7fffffff ||
      !leaf_table::fill(&t, desc, starts, n, true, kEsize, 1, 16, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  fused_uplink_leaves<<<t.start[n], kThreads, 0,
                        static_cast<cudaStream_t>(stream_ptr)>>>(t, kk);
  return static_cast<int>(cudaGetLastError());
}

// One launch over n <= 48 leaves of K = kk clients. desc: n rows of 10
// int64, (levels, v, e_old, num, res, rows, cols, dtype, width, unit) with
// levels (kk, rows, cols) int8, v and e_old (kk, rows, cols) with dtype =
// v_dtype + 2 * e_dtype (0 = f32, 1 = bf16 each), num (rows, cols) f32 and
// res (kk, rows, cols) f32, all contiguous; width 8, 4 or 1 columns a
// thread (cols a multiple of it, levels aligned to width bytes, the others
// to min(16, width * element size)); the leaf's rows are units unit ..
// unit + rows - 1 (< units). scales, w and gate: (kk, units) f32, shared by
// every leaf. starts: the n + 1 exclusive prefix sums of leaf_blocks(rows,
// cols, width, per row). Returns cudaGetLastError().
int repro_fused_uplink_ef_leaves(const long long* desc, const int* starts,
                                 int n, long long kk, long long units,
                                 const float* scales, const float* w,
                                 const float* gate, void* stream_ptr) {
  EfTable t;
  if (kk < 1 || units < 1 ||
      !leaf_table::fill(&t, desc, starts, n, true, kEfEsize, 4, 8, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i)
    if (t.unit[i] + t.rows[i] > units)
      return static_cast<int>(cudaErrorInvalidValue);
  fused_uplink_ef_leaves<<<t.start[n], kThreads, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      t, kk, units, scales, w, gate);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
