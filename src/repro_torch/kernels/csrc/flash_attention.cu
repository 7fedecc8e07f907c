// Flash attention for Hopper (sm_90a): grouped-query softmax attention with
// a causal and/or sliding-window mask and a pad mask, in one pass over the
// keys with the online softmax:
//     s[i, j] = (q[i] . k[j]) * scale,  scale = 1 / sqrt(hd)
//     row i sees key j  iff  j < kv_len  and  (not causal or j <= i)
//                                        and  (window <= 0 or j > i - window)
//     o[i]    = sum_j softmax_j(s[i, :])[j] * v[j]   (0 where row i sees none)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel). The positions are the row and key
// indices; kv_len <= Skv is the kernel's pad mask, which the decode step
// uses for the filled prefix of its KV ring buffer.
//
// Three routes compute it; kernels/flash_attention.py:route picks one from
// the dtype and the shape alone, and a call launches that route's kernel or
// raises (none gives way to another or to the plain version):
//
//   route       taken when                          kernel
//   decode      Sq <= 16, f32 or bf16, any hd       flash_attention_decode.cu:
//                                                   split-KV, grouped heads
//   tc          Sq > 16, bf16, hd 64 or 128         flash_attention_tc.cu:
//                                                   wgmma, TMA
//   cuda_core   Sq > 16 and f32 (the exact-f32      this file: flash_fwd
//               parity route), or bf16, hd 16, 32
//
// Every route takes the three masks with the tile skip, gives exactly 0 for
// a fully masked row, reads KV head h / group for head h, and takes any
// (batch, head, row) strides.
//
// This file is the CUDA-core route. What bounds it on this card:
// operations. A prefill does about 680 operations a byte of q, k, v and o
// (qwen3-1.7b: B = 4, 16 heads over 8 KV heads, S = 2048, hd = 128,
// causal: 68.7 GFLOP a layer against 101 MB); on the CUDA cores, whose f32
// peak is 67 TFLOP/s, that caps it at about 1 ms a layer. It keeps f32
// products for the f32 parity route, and serves the head dims the tensor
// cores' route does not take.
//
// What the design does about that (a simple kernel that is right):
// - One block owns one (batch, head) and a tile of 64 query rows. It walks
//   the KV tiles of 64 keys in order, with the running max m, the
//   denominator l and the output rows in registers: no atomics and no
//   second pass. The TPU kernel instead revisited its m, l and o blocks
//   across a sequential grid axis, which Hopper's unordered blocks cannot
//   do.
// - The loop starts at the first tile the window allows and ends at the
//   last tile that causality and kv_len allow, as the TPU kernel's tile
//   skip does; keys at or past kv_len are neither read nor counted.
// - 256 threads as 16 x 16: thread (ty, tx) computes scores for rows
//   ty + 16 i and keys tx + 16 j (a 4 x 4 micro-tile) and owns output
//   columns tx + 16 d. Row max and row sum are shuffles within a
//   half-warp. Q, K, V and the probabilities sit in shared memory as f32
//   (rows padded by one float so the inner loops are free of bank
//   conflicts): about 113 KB at hd = 128, so the block asks for dynamic
//   shared memory above 48 KB.
// - Products and sums are f32 FMAs, as the TPU kernel casts q, k and v to
//   f32; the scale is applied after the dot; a fully masked row keeps
//   m = -1e30 and l = 0, so its probabilities and corrections are forced
//   to 0 and its output is 0 / max(l, 1e-30) = 0, not NaN.
// - Global loads are 16 bytes a thread; q, k, v and their strides must be
//   16-byte aligned (the wrapper checks). Any (batch, row, head) strides
//   are taken, so the model passes its (B, S, H, hd) views without copies;
//   head h reads KV head h / group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTK = 64;               // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of (batch, head, row); the last axis is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int heads, group, sq, kv_len, causal, window;
  float scale;
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, int RQ>
constexpr int smem_floats() {
  return 16 * RQ * (HD + 1) + kTK * (HD + 1) + kTK * HD + 16 * RQ * (kTK + 1);
}

// rows [row0, row0 + nrows) of a (rows, HD) matrix with row stride `ss` into
// shared memory with row pitch `pitch`; rows at or past `limit` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          long long ss, int row0, int nrows,
                                          int limit, float* dst, int pitch) {
  using V = Vec16<T>;
  constexpr int kChunks = HD / V::N;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * V::N;
    V x;
    if (row0 + r < limit) {
      x = *reinterpret_cast<const V*>(src + (row0 + r) * ss + c);
#pragma unroll
      for (int e = 0; e < V::N; ++e) dst[r * pitch + c + e] = widen(x.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V::N; ++e) dst[r * pitch + c + e] = 0.f;
    }
  }
}

template <typename T, int HD, int RQ>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  constexpr int TQ = 16 * RQ;
  constexpr int QP = HD + 1;          // padded pitch of Qs and Ks
  constexpr int PP = kTK + 1;         // padded pitch of Ps
  constexpr int DJ = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // TQ x QP
  float* Ks = Qs + TQ * QP;           // kTK x QP
  float* Vs = Ks + kTK * QP;          // kTK x HD
  float* Ps = Vs + kTK * HD;          // TQ x PP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int kvh = h / a.group;
  // the heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_rows<T, HD>(qp, a.q_ss, q0, TQ, a.sq, Qs, QP);

  // tile skip: keys the window leaves to every row of the tile, and keys
  // past causality or kv_len, are never visited
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.kv_len, q0 + TQ) : a.kv_len;

  float m[RQ], l[RQ], acc[RQ][DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DJ; ++d) acc[i][d] = 0.f;
  }

  for (int t0 = (k_begin / kTK) * kTK; t0 < k_end; t0 += kTK) {
    __syncthreads();                  // the last tile's readers are done
    load_rows<T, HD>(kp, a.k_ss, t0, kTK, a.kv_len, Ks, QP);
    load_rows<T, HD>(vp, a.v_ss, t0, kTK, a.kv_len, Vs, HD);
    __syncthreads();

    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + tx + 16 * j;
        ok[j] = key < a.kv_len && (!a.causal || key <= row) &&
                (a.window <= 0 || key > row - a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // fully masked so far: exp(-1e30 - -1e30) must give 0, not 1
      const bool safe = m_new > kNegInf / 2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (safe && ok[j]) ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      rs = half_warp_sum(rs);
      const float corr =
          (safe && m[i] > kNegInf / 2) ? expf(m[i] - m_new) : 0.f;
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DJ; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float pv[RQ], vv[DJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int d = 0; d < DJ; ++d) vv[d] = Vs[c * HD + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int d = 0; d < DJ; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DJ; ++d)
      store(op + row * a.o_ss + tx + 16 * d, acc[i][d] / den);
  }
}

template <typename T, int HD, int RQ>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<HD, RQ>() * static_cast<int>(sizeof(float));
  // The attribute belongs to the current device, so it is set on every
  // launch: a cached flag would skip it on a second card.
  if (kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD, RQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.sq + 16 * RQ - 1) / (16 * RQ), batch * a.heads);
  flash_fwd<T, HD, RQ><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, int batch, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, 4>(a, batch, stream);
    case 32: return launch<T, 32, 4>(a, batch, stream);
    case 64: return launch<T, 64, 4>(a, batch, stream);
    case 128: return launch<T, 128, 4>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (batch, sq, heads, hd), k and v: (batch, skv, heads / group, hd), o like
// q, each given by its base pointer and its element strides of (batch,
// head, row); the last axis is contiguous. dtype 0 = f32, 1 = bf16, the same
// for all four. hd is 16, 32, 64 or 128; 0 <= kv_len <= skv. Pointers and
// strides of q, k and v are 16-byte aligned. Returns cudaGetLastError().
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, long long q_sb, long long q_sh,
                          long long q_ss, long long k_sb, long long k_sh,
                          long long k_ss, long long v_sb, long long v_sh,
                          long long v_ss, long long o_sb, long long o_sh,
                          long long o_ss, int batch, int heads, int group,
                          int sq, int skv, int kv_len, int causal,
                          int window, int hd, int dtype, float scale,
                          void* stream_ptr) {
  if (batch < 1 || heads < 1 || group < 1 || heads % group || sq < 1 ||
      skv < 1 || kv_len < 0 || kv_len > skv || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(batch) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    o,    q_sb, q_sh,  q_ss,   k_sb,
               k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,  o_sh,   o_ss,
               heads, group, sq,  kv_len, causal, window, scale};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      dtype == 0 ? launch_t<float>(a, batch, hd, stream)
                 : launch_t<__nv_bfloat16>(a, batch, hd, stream);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
