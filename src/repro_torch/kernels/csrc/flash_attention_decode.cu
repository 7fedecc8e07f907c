// Flash attention for Hopper (sm_90a), decode route: grouped-query softmax
// attention for at most 16 query rows a head (a decode step has one), f32
// or bf16, hd 16, 32, 64 or 128, with causal, sliding-window and pad
// (kv_len) masks. The masks and the result are those of
// csrc/flash_attention.cu (whose header has the route table):
//     s[i, j] = (q[i] . k[j]) * scale,  scale = 1 / sqrt(hd)
//     row i sees key j  iff  j < kv_len  and  (not causal or j <= i)
//                                        and  (window <= 0 or j > i - window)
//     o[i]    = sum_j softmax_j(s[i, :])[j] * v[j]   (0 where row i sees none)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel) on the decode path.
//
// What bounds it: bytes. A decode step of qwen3-1.7b (B = 4, 16 heads over
// 8 KV heads, hd = 128, kv_len up to 2080) reads 34 MB of K and V a layer
// and does about 2 * G = 4 operations per K/V byte against the card's 295,
// so the least time is 10 us a layer at 3.35 TB/s. That needs many blocks
// in flight, every K/V byte read once, and loads that overlap the math.
//
// What the design does about that:
// - Grouped heads: a block owns one (batch, KV head) and all G * Sq query
//   rows that read it (row r is head kvh * G + r / Sq at position r % Sq),
//   so each K/V row is read once for the whole group. Up to 16 rows a
//   block (RB = 2, 8 or 16, the smallest that holds them); more rows take
//   more row blocks (grid z), each reading K/V again.
// - Split-KV: the host cuts the visible keys [0, k_end) into `splits`
//   chunks of `chunk` keys, chosen so that batch * KV * splits is at least
//   about 2 x 132 blocks (flash_attention.py: decode_plan); grid y is the
//   split. Each split writes its partial (m, l, o), unnormalised, in f32
//   to scratch that the wrapper allocates; a second kernel, enqueued by
//   the same host call, merges the splits of each row in split order: no
//   float atomics, the same result from run to run. An empty split (every
//   key masked) keeps m = -inf and l = 0 and merges with weight 0; a row
//   with no visible key at all gives 0, not NaN.
// - Loads: K and V tiles of 16 KB each (TK = 16 KB / row bytes keys, at
//   most 128), double-buffered with cp.async, 16 bytes a thread, so the
//   next tile lands while this one is used. Keys at or past the split's
//   end are zero-filled, not read. Each row's 16-byte chunks are XOR-
//   swizzled with the row, so the score loop's reads (a key a thread, one
//   chunk at a time) are free of bank conflicts.
// - Math on the CUDA cores in f32 (this work is bound by bytes): scores by
//   (part of hd, key) threads summed through shared memory; the online
//   softmax a warp a row, in the log2 domain (scale * log2(e) applied to
//   the f32 dot, ex2.approx); P.V with a thread a column of hd.
// - Any (batch, head, row) strides with 16-byte alignment are taken (the
//   wrapper checks), so the model's views of its projections and of the
//   stacked cache go in without copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int HD>
struct Tile {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks a row
  static constexpr int kTK = 16384 / kRowBytes < 128 ? 16384 / kRowBytes
                                                      : 128;   // keys a tile
  static constexpr int kBytes = kTK * kRowBytes;      // one K or V tile
  static constexpr int kSwz = kChunks < 8 ? kChunks : 8;
  static constexpr int kParts = kThreads / kTK;       // threads on one dot
  static constexpr int kPartChunks = kChunks / kParts;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static_assert(kPartChunks >= 1 && kChunks % kParts == 0, "tile shape");
};

struct DecArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_o;                      // (B*KV, splits, rows, hd)
  float* part_ml;                     // (B*KV, splits, rows, 2): m, l
  // element strides of (batch, head, row); the last axis is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int kv_heads, group, sq, rows, kv_len, k_end, causal, window, splits, chunk;
  float scale_log2;                   // scale * log2(e)
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// keys [key0, key0 + TK) of a (keys, HD) matrix with row stride `ss` into a
// swizzled tile; keys at or past `key_end` are zero-filled, not read
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          long long ss, int key0,
                                          int key_end) {
  using C = Tile<T, HD>;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  static_assert(C::kTK * C::kChunks % kThreads == 0, "whole rounds");
#pragma unroll
  for (int n = 0; n < C::kTK * C::kChunks / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int j = i / C::kChunks;
    const int c = i % C::kChunks;
    const bool ok = key0 + j < key_end;
    const char* g = reinterpret_cast<const char*>(
                        src + static_cast<long long>(ok ? key0 + j : key0) *
                                  ss) + c * 16;
    cp_async16(base + j * C::kRowBytes + ((c ^ (j % C::kSwz)) * 16), g, ok);
  }
}

template <typename T, int HD, int RB>
constexpr int split_smem_bytes() {
  using C = Tile<T, HD>;
  return RB * HD * 4 + 4 * C::kBytes + C::kParts * RB * C::kTK * 4 +
         3 * RB * 4;
}

template <typename T, int HD, int RB>
__global__ void __launch_bounds__(kThreads) flash_decode_split(DecArgs a) {
  using C = Tile<T, HD>;
  constexpr int TK = C::kTK;
  constexpr int kGroups = kThreads / HD;      // row groups of the P.V step
  constexpr int kOwn = (RB + kGroups - 1) / kGroups;
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem);                 // RB x HD
  uint8_t* Kt = smem + RB * HD * 4;                           // 2 stages
  uint8_t* Vt = Kt + 2 * C::kBytes;                           // 2 stages
  float* Ss = reinterpret_cast<float*>(Vt + 2 * C::kBytes);   // parts x RB x TK
  float* Ms = Ss + C::kParts * RB * TK;   // running max (log2 domain)
  float* Ls = Ms + RB;                    // running sum
  float* Cs = Ls + RB;                    // this tile's correction
  float* Ps = Ss;                         // probabilities overwrite part 0

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * RB;
  const int b = bkv / a.kv_heads;
  const int kvh = bkv % a.kv_heads;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int s0 = split * a.chunk;
  const int s1 = min(s0 + a.chunk, a.k_end);
  const int n_tiles = s1 > s0 ? (s1 - s0 + TK - 1) / TK : 0;

  for (int e = tid; e < RB * HD; e += kThreads) {
    const int r = r0 + e / HD;
    float x = 0.f;
    if (r < a.rows)
      x = widen(static_cast<const T*>(a.q)[b * a.q_sb +
                                           (kvh * a.group + r / a.sq) * a.q_sh +
                                           (r % a.sq) * a.q_ss + e % HD]);
    Qs[e] = x;
  }
  if (tid < RB) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const int d = tid % HD;             // P.V: this thread's column of hd
  const int rg = tid / HD;            // and its rows rg + kGroups * u
  float acc[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) acc[u] = 0.f;

  if (n_tiles > 0) {
    load_tile<T, HD>(Kt, kp, a.k_ss, s0, s1);
    load_tile<T, HD>(Vt, vp, a.v_ss, s0, s1);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int t0 = s0 + it * TK;
    if (it + 1 < n_tiles) {             // the other stage was freed last time
      load_tile<T, HD>(Kt + (st ^ 1) * C::kBytes, kp, a.k_ss, t0 + TK, s1);
      load_tile<T, HD>(Vt + (st ^ 1) * C::kBytes, vp, a.v_ss, t0 + TK, s1);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();

    {  // partial scores: thread (part, key) over its chunks of hd
      const int j = tid % TK;
      const int part = tid / TK;
      const uint8_t* krow = Kt + st * C::kBytes + j * C::kRowBytes;
      float s[RB];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) s[rr] = 0.f;
#pragma unroll
      for (int cc = 0; cc < C::kPartChunks; ++cc) {
        const int c = part * C::kPartChunks + cc;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            krow + ((c ^ (j % C::kSwz)) * 16));
        const T* kv = reinterpret_cast<const T*>(&raw);
        float kf[C::kElems];
#pragma unroll
        for (int e = 0; e < C::kElems; ++e) kf[e] = widen(kv[e]);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const float* qr = Qs + rr * HD + c * C::kElems;
#pragma unroll
          for (int e = 0; e < C::kElems; ++e)
            s[rr] = fmaf(qr[e], kf[e], s[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) Ss[(part * RB + rr) * TK + j] = s[rr];
    }
    __syncthreads();

    {  // online softmax: warp w takes rows w, w + 4, ...
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int rr = warp; rr < RB; rr += kThreads / 32) {
        const int r = r0 + rr;
        const int i = r % a.sq;        // the row's query position
        float x[TK / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < TK / 32; ++u) {
          const int jj = lane + 32 * u;
          const int key = t0 + jj;
          float sum = 0.f;
#pragma unroll
          for (int p = 0; p < C::kParts; ++p) sum += Ss[(p * RB + rr) * TK + jj];
          const bool ok = r < a.rows && key < s1 && (!a.causal || key <= i) &&
                          (a.window <= 0 || key > i - a.window);
          x[u] = ok ? sum * a.scale_log2 : -INFINITY;
          mx = fmaxf(mx, x[u]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = Ms[rr];
        const float m_new = fmaxf(m_old, mx);
        // a row with no visible key so far subtracts 0: exp2(-inf) = 0
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        float ls = 0.f;
#pragma unroll
        for (int u = 0; u < TK / 32; ++u) {
          const float p = ex2(x[u] - mu);
          Ps[rr * TK + lane + 32 * u] = p;
          ls += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ls += __shfl_xor_sync(0xffffffffu, ls, off);
        __syncwarp();
        if (lane == 0) {
          const float corr = ex2(m_old - mu);
          Cs[rr] = corr;
          Ls[rr] = Ls[rr] * corr + ls;
          Ms[rr] = m_new;
        }
      }
    }
    __syncthreads();

    {  // o += P V, a thread a column of hd
      const uint8_t* vt = Vt + st * C::kBytes;
      const int c = d / C::kElems;
      const int off = (d % C::kElems) * static_cast<int>(sizeof(T));
#pragma unroll
      for (int u = 0; u < kOwn; ++u) {
        const int rr = rg + kGroups * u;
        if (rr < RB) acc[u] *= Cs[rr];
      }
#pragma unroll 4
      for (int j = 0; j < TK; ++j) {
        const float vv = widen(*reinterpret_cast<const T*>(
            vt + j * C::kRowBytes + ((c ^ (j % C::kSwz)) * 16) + off));
#pragma unroll
        for (int u = 0; u < kOwn; ++u) {
          const int rr = rg + kGroups * u;
          if (rr < RB) acc[u] = fmaf(Ps[rr * TK + j], vv, acc[u]);
        }
      }
    }
    __syncthreads();                   // this stage is refilled next time
  }

  const long long slot = (static_cast<long long>(bkv) * a.splits + split) *
                         a.rows;
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int rr = rg + kGroups * u;
    if (rr < RB && r0 + rr < a.rows)
      a.part_o[(slot + r0 + rr) * HD + d] = acc[u];
  }
  if (tid < RB && r0 + tid < a.rows) {
    a.part_ml[(slot + r0 + tid) * 2] = Ms[tid];
    a.part_ml[(slot + r0 + tid) * 2 + 1] = Ls[tid];
  }
}

// one block a (batch * KV head, row), a thread a column of hd: the splits'
// partials weighted by exp2(m_s - max m), in split order
template <typename T, int HD>
__global__ void __launch_bounds__(HD) flash_decode_merge(DecArgs a) {
  const int bkv = blockIdx.x / a.rows;
  const int r = blockIdx.x % a.rows;
  const int b = bkv / a.kv_heads;
  const int kvh = bkv % a.kv_heads;
  const int d = threadIdx.x;
  const long long slot = static_cast<long long>(bkv) * a.splits * a.rows + r;
  float m = -INFINITY;
  for (int s = 0; s < a.splits; ++s)
    m = fmaxf(m, a.part_ml[(slot + static_cast<long long>(s) * a.rows) * 2]);
  float l = 0.f, o = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < a.splits; ++s) {
      const long long i = slot + static_cast<long long>(s) * a.rows;
      const float w = ex2(a.part_ml[i * 2] - m);
      l = fmaf(w, a.part_ml[i * 2 + 1], l);
      o = fmaf(w, a.part_o[i * HD + d], o);
    }
  }
  T* op = static_cast<T*>(a.o) + b * a.o_sb +
          (kvh * a.group + r / a.sq) * a.o_sh + (r % a.sq) * a.o_ss;
  store(op + d, l > 0.f ? o / l : 0.f);
}

template <typename T, int HD, int RB>
cudaError_t launch(const DecArgs& a, int batch, cudaStream_t stream) {
  constexpr int kSmem = split_smem_bytes<T, HD, RB>();
  // The attribute belongs to the current device, so it is set on every
  // launch: a cached flag would skip it on a second card.
  if (kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split<T, HD, RB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  const int groups = batch * a.kv_heads;
  const dim3 grid(groups, a.splits, (a.rows + RB - 1) / RB);
  flash_decode_split<T, HD, RB><<<grid, kThreads, kSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge<T, HD><<<groups * a.rows, HD, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rb(const DecArgs& a, int batch, int rb,
                      cudaStream_t stream) {
  switch (rb) {
    case 2: return launch<T, HD, 2>(a, batch, stream);
    case 8: return launch<T, HD, 8>(a, batch, stream);
    case 16: return launch<T, HD, 16>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const DecArgs& a, int batch, int hd, int rb,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_rb<T, 16>(a, batch, rb, stream);
    case 32: return launch_rb<T, 32>(a, batch, rb, stream);
    case 64: return launch_rb<T, 64>(a, batch, rb, stream);
    case 128: return launch_rb<T, 128>(a, batch, rb, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (batch, sq, heads, hd), k and v: (batch, skv, heads / group, hd), o like
// q, each given by its base pointer and its element strides of (batch,
// head, row); the last axis is contiguous. dtype 0 = f32, 1 = bf16, the same
// for all four. hd is 16, 32, 64 or 128; 1 <= sq <= 16; 0 <= kv_len <= skv.
// Pointers and strides of q, k and v are 16-byte aligned. The keys
// [0, k_end), k_end = causal ? min(kv_len, sq) : kv_len, are cut into
// `splits` chunks of `chunk` keys (splits * chunk >= k_end); `rb` (2, 8 or
// 16) query rows a block. part: f32 scratch of batch * heads * sq *
// splits * (hd + 2) elements. Launches the split pass and the merge on
// `stream`; returns cudaGetLastError().
int repro_flash_attention_decode(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int batch, int heads,
    int group, int sq, int skv, int kv_len, int causal, int window, int hd,
    int dtype, float scale, float* part, int splits, int chunk, int rb,
    void* stream_ptr) {
  if (batch < 1 || heads < 1 || group < 1 || heads % group || sq < 1 ||
      sq > 16 || skv < 1 || kv_len < 0 || kv_len > skv ||
      (dtype != 0 && dtype != 1) || splits < 1 || splits > 65535 ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_heads = heads / group;
  const int rows = group * sq;
  const int k_end = causal ? (kv_len < sq ? kv_len : sq) : kv_len;
  if (static_cast<long long>(splits) * chunk < k_end ||
      (rows + rb - 1) / rb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_o =
      static_cast<long long>(batch) * kv_heads * splits * rows * hd;
  const DecArgs a{q,     k,      v,      o,      part,     part + n_o,
                  q_sb,  q_sh,   q_ss,   k_sb,   k_sh,     k_ss,
                  v_sb,  v_sh,   v_ss,   o_sb,   o_sh,     o_ss,
                  kv_heads, group, sq,   rows,   kv_len,   k_end,
                  causal, window, splits, chunk, scale * kLog2e};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      dtype == 0 ? launch_t<float>(a, batch, hd, rb, stream)
                 : launch_t<__nv_bfloat16>(a, batch, hd, rb, stream);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
