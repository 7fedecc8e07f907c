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
// This file is the CUDA-core route: f32 products and sums on the CUDA
// cores, no tensor cores (TF32 would keep about 3 decimal digits, and the
// route exists to keep f32). What bounds it on this card: operations. A
// prefill does about 680 operations a byte of q, k, v and o (qwen3-1.7b:
// B = 4, 16 heads over 8 KV heads, S = 2048, hd = 128, causal: 68.7 GFLOP
// a layer against 101 MB); at the CUDA cores' f32 peak of 67 TFLOP/s that
// is 1.03 ms a layer. So the FMA pipes must stay fed: an SM issues four
// FFMA warp-instructions a clock against one shared-memory wavefront, and
// every operand of an FFMA comes from a register that a shared-memory load
// filled, while a block that waits on a tile, a barrier or its softmax
// idles them.
//
// What the design does about that:
// - Register tiles, as in a SIMT SGEMM. A warp owns 16 query rows; lane
//   (lr, lc) = (lane / 16, lane % 16) of warp w holds an 8 x 8 block of
//   S = Q K^T (rows 16 w + lr + 2 i, keys lc + 16 j of a 128-key tile) and
//   the same 8 rows of O (hd / 16 columns, lc * W + 16 W v + e, W =
//   min(hd / 16, 4)). Operands come from shared memory as float4 along the
//   contracted axis: per 4 steps of d, 8 loads of K and 8 of Q feed 256
//   FFMAs (16 a load); P V is alike, with 8 loads of P (rows) and one or
//   two of V (a key's columns) a key per 4 keys. The next chunk's K (or V)
//   and the next row's Q (or P) are loaded while the current ones are
//   multiplied. A
//   row's 128 keys lie in the 16 lanes of its half-warp, so its max takes
//   4 shuffles and P goes through shared memory within the warp only, in
//   two halves of 64 keys.
// - Blocks: 8 warps (128 rows) at hd 128, where shared memory holds one
//   block an SM (Q, one K and one V stage, half of P: 224 KB); 4 warps (64
//   rows) below, two blocks an SM (96 KB at hd 64). Either way an SM runs
//   8 warps, 2 a scheduler, so one warp's load or barrier wait is the
//   other's issue slot.
// - An asynchronous K/V ring of 2 stages over the tile sequence K0, V0, K1,
//   V1, ...: each stage is filled by cp.async.cg (16 bytes a thread, keys
//   at or past kv_len zero-filled, not read) while the other is multiplied,
//   so V_t lands during Q K_t^T and the softmax, and K_(t+1) during P V_t;
//   V_0 is issued with Q and K_0. Two __syncthreads a tile: one publishes
//   K_t and frees V's stage, the other publishes V_t and frees K's. bf16
//   (hd 16 and 32, used by tests and reduced configs only) is widened to
//   f32 by a synchronous copy on the same schedule.
// - 16-byte chunks are XOR-swizzled by row (Q and P by its parity, K by key
//   % 8), so the inner loops' loads and the P stores are free of bank
//   conflicts.
// - Softmax in the log2 domain: scale * log2(e) applied to the f32 dot,
//   ex2.approx; each lane's share of a row sum kept apart and summed by
//   shuffles once at the end. The masks are compiled into a second copy of
//   the softmax that runs only on a tile crossing a mask's edge.
// - Work skipped without changing a bit: keys the window leaves to every
//   row of the block and keys past causality or kv_len (the TPU kernel's
//   tile skip); warps whose rows are all past sq; P V past the last key a
//   warp's rows see; Q K^T over a tile's second half of keys where a
//   warp's rows see none there (their scores are masked to -inf anyway).
//   The heaviest causal blocks (the last rows) are scheduled first.
// - A fully masked row keeps m = -1e30 and l = 0, so its probabilities are
//   0 and its output 0 / max(l, 1e-30) = 0, not NaN.
// - Deterministic: no atomics and no split of a row's keys. A row's sums
//   run in one order fixed by its index, hd and the masks, whatever the
//   batch, heads, grid or other rows.
// - Any (batch, row, head) strides are taken (16-byte aligned, the wrapper
//   checks), so the model passes its (B, S, H, hd) views without copies;
//   head h reads KV head h / group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 128;              // keys a tile
constexpr int kTP = kTK / 2;          // keys a half tile of P
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

template <int HD>
struct Core {
  // 8 warps (one block an SM) at hd 128, where shared memory allows one
  // block; 4 warps (two blocks an SM) below
  static constexpr int kWarps = HD == 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTQ = 16 * kWarps;             // query rows a block
  static constexpr int kChunks = HD / 4;              // float4 chunks a row
  static constexpr int kKSwz = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kCols = HD / 16;               // O columns a thread
  static constexpr int kW = kCols < 4 ? kCols : 4;    // columns a vector
  static constexpr int kNV = kCols / kW;              // vectors a row
  static constexpr int kQ = kTQ * HD;                 // floats
  static constexpr int kK = kTK * HD;
  static constexpr int kP = kTQ * kTP;
  static constexpr int kBytes = (kQ + 2 * kK + kP) * 4;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// W consecutive floats of shared memory into registers
template <int W>
__device__ __forceinline__ void lds(float (&x)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// Rows [row0, row0 + R) of a (rows, HD) matrix with row stride `ss` into an
// R x HD f32 tile; the 16-byte chunk c of row r lands at chunk c ^ (r &
// SWZ). Rows at or past `limit` are zero-filled, not read. f32 goes by
// cp.async (the caller commits); bf16 is widened by a synchronous copy. A
// thread keeps one chunk column and walks the rows with running addresses
// (a partly unrolled loop), so no per-row address is held in registers.
template <typename T, int HD, int R, int SWZ>
__device__ __forceinline__ void fill(float* dst, const T* src, long long ss,
                                     int row0, int limit) {
  constexpr int kThreads = Core<HD>::kThreads;
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int C = HD / kE;                           // chunks a row
  constexpr int RS = kThreads / C;                     // rows a round
  static_assert(kThreads % C == 0 && R % RS == 0, "whole rounds");
  const int c = threadIdx.x % C;
  int r = threadIdx.x / C;
  const T* g = src + static_cast<long long>(row0 + r) * ss + c * kE;
  const long long step = RS * ss;
  float* row = dst + r * HD;
#pragma unroll 4
  for (int n = 0; n < R / RS; ++n, r += RS, g += step, row += RS * HD) {
    const bool ok = row0 + r < limit;
    if constexpr (sizeof(T) == 4) {
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                     row + ((c ^ (r & SWZ)) << 2))),
                 ok ? g : src, ok);
    } else {
      float f[8];
      if (ok) {
        const uint4 u = *reinterpret_cast<const uint4*>(g);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[2 * e] = __uint_as_float(w[e] << 16);
          f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
      }
      float4* v = reinterpret_cast<float4*>(row);
      v[(2 * c) ^ (r & SWZ)] = make_float4(f[0], f[1], f[2], f[3]);
      v[(2 * c + 1) ^ (r & SWZ)] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// One chunk (4 steps of d) of S = Q K^T for the key groups j < J: K's 4
// values of the thread's keys in kf; row i + 1's Q is loaded while row i
// is multiplied.
template <int J>
__device__ __forceinline__ void qk_chunk(float (&s)[8][8],
                                         const float (&kf)[8][4],
                                         const float* qc, int row_step) {
  float qf[2][4];
  lds<4>(qf[0], qc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i + 1 < 8) lds<4>(qf[(i + 1) & 1], qc + (i + 1) * row_step);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < J; ++j)
        s[i][j] = fmaf(qf[i & 1][e], kf[j][e], s[i][j]);
  }
}

// S = Q K_t^T, an 8 x 8 block a thread (rows qrow + 2 HD i, keys krow +
// 16 HD j), float4 steps along d, for the key groups j < J (the rest of s
// stays 0); the next chunk's K is loaded while this one is multiplied.
template <int J, int HD>
__device__ __forceinline__ void qk(float (&s)[8][8], const float* krow,
                                   int kx, const float* qrow, int lr) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  float ka[8][4], kb[8][4];
#pragma unroll
  for (int j = 0; j < J; ++j) lds<4>(ka[j], krow + 16 * j * HD + (kx << 2));
#pragma unroll 1
  for (int c = 0; c < Core<HD>::kChunks; c += 2) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      lds<4>(kb[j], krow + 16 * j * HD + (((c + 1) ^ kx) << 2));
    qk_chunk<J>(s, ka, qrow + ((c ^ lr) << 2), 2 * HD);
    // the last round loads chunk 0 again, unused
    const int cn = (c + 2) % Core<HD>::kChunks;
#pragma unroll
    for (int j = 0; j < J; ++j)
      lds<4>(ka[j], krow + 16 * j * HD + ((cn ^ kx) << 2));
    qk_chunk<J>(s, kb, qrow + (((c + 1) ^ lr) << 2), 2 * HD);
  }
}

// One chunk (4 keys) of O += P V: V's columns of the 4 keys in vf; row
// i + 1's P is loaded while row i is multiplied.
template <int HD>
__device__ __forceinline__ void pv_chunk(
    float (&o)[8][Core<HD>::kCols],
    const float (&vf)[4][Core<HD>::kNV][Core<HD>::kW], const float* pc) {
  using C = Core<HD>;
  float pf[2][4];
  lds<4>(pf[0], pc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i + 1 < 8) lds<4>(pf[(i + 1) & 1], pc + 2 * (i + 1) * kTP);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int v = 0; v < C::kNV; ++v)
#pragma unroll
        for (int e = 0; e < C::kW; ++e)
          o[i][v * C::kW + e] =
              fmaf(pf[i & 1][kk], vf[kk][v][e], o[i][v * C::kW + e]);
  }
}

template <int HD>
__device__ __forceinline__ void load_v(
    float (&vf)[4][Core<HD>::kNV][Core<HD>::kW], const float* vrow, int c) {
  using C = Core<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int v = 0; v < C::kNV; ++v)
      lds<C::kW>(vf[kk][v], vrow + (4 * c + kk) * HD + 16 * C::kW * v);
}

// O += P V over the chunks [c0, c1) of 4 keys of one half tile: P from the
// warp's half-tile rows (prow, chunk c ^ 4 (row & 1)), V from the tile's
// rows 4 c + kk (vrow: this lane's columns). The next chunk's V is loaded
// while this one is multiplied.
template <int HD>
__device__ __forceinline__ void pv(float (&o)[8][Core<HD>::kCols],
                                   const float* prow, const float* vrow,
                                   int lr, int c0, int c1) {
  using C = Core<HD>;
  float va[4][C::kNV][C::kW], vb[4][C::kNV][C::kW];
  load_v<HD>(va, vrow, c0);
#pragma unroll 1
  for (int c = c0; c < c1; c += 2) {
    load_v<HD>(vb, vrow, min(c + 1, kTK / 4 - 1));
    pv_chunk<HD>(o, va, prow + (((c % (kTP / 4)) ^ (lr << 2)) << 2));
    if (c + 1 == c1) break;
    load_v<HD>(va, vrow, min(c + 2, kTK / 4 - 1));
    pv_chunk<HD>(o, vb, prow + ((((c + 1) % (kTP / 4)) ^ (lr << 2)) << 2));
  }
}

// The online softmax of one tile for the thread's 8 rows (row0 + 2 i) and
// 8 keys (key0 + 16 j): s becomes P, and m, l and o are rescaled. EDGE
// evaluates the masks (a tile that crosses a mask's edge), else every key
// is visible.
template <bool EDGE, int HD>
__device__ __forceinline__ void softmax(float (&s)[8][8],
                                        float (&o)[8][Core<HD>::kCols],
                                        float (&m)[8], float (&l)[8],
                                        int kv_len, int causal, int window,
                                        int row0, int key0, float c2) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 2 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = s[i][j] * c2;
      if (EDGE) {
        const int key = key0 + 16 * j;
        const bool ok = key < kv_len && (!causal || key <= row) &&
                        (window <= 0 || key > row - window);
        x = ok ? x : kNegInf;
      }
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    // no key seen yet: subtract 0, so masked scores give ex2(-1e30) = 0
    const float m_use = m_new > kNegInf / 2 ? m_new : 0.f;
    const float corr = ex2(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = ex2(s[i][j] - m_use);
      rs += s[i][j];
    }
    l[i] = l[i] * corr + rs;          // this lane's share of the row sum
    m[i] = m_new;
#pragma unroll
    for (int d = 0; d < Core<HD>::kCols; ++d) o[i][d] *= corr;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Core<HD>::kThreads) flash_fwd(Args a) {
  using C = Core<HD>;
  constexpr int kTQ = C::kTQ;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // kTQ x HD, chunk c ^ (row & 1)
  float* Ks = Qs + C::kQ;             // kTK x HD, chunk c ^ (key & kKSwz)
  float* Vs = Ks + C::kK;             // kTK x HD
  float* Ps = Vs + C::kK;             // kTQ x kTP, chunk c ^ 4 (row & 1)

  const int warp = threadIdx.x >> 5;
  const int lr = (threadIdx.x >> 4) & 1;
  const int lc = threadIdx.x & 15;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int kvh = h / a.group;
  // the heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // tile skip: keys the window leaves to every row of the block, and keys
  // past causality or kv_len, are never visited
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.kv_len, q0 + kTQ) : a.kv_len;
  const int t_first = (k_begin / kTK) * kTK;
  const float c2 = a.scale * kLog2e;

  const int row_w = 16 * warp + lr;   // the thread's rows: row_w + 2 i
  // a warp whose 16 rows are all past sq only loads and waits; the keys
  // its rows can see end at w_end (causality), so P V stops there
  const bool live = q0 + 16 * warp < a.sq;
  const int w_end = a.causal ? min(k_end, q0 + 16 * warp + 16) : k_end;
  float o[8][C::kCols], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < C::kCols; ++d) o[i][d] = 0.f;
  }

  // the ring's first two stages: K_0 (with Q), then V_0
  if (t_first < k_end) {
    fill<T, HD, kTQ, 1>(Qs, qp, a.q_ss, q0, a.sq);
    fill<T, HD, kTK, C::kKSwz>(Ks, kp, a.k_ss, t_first, a.kv_len);
    cp_async_commit();
    fill<T, HD, kTK, 0>(Vs, vp, a.v_ss, t_first, a.kv_len);
    cp_async_commit();
  }
  const float* qrow = Qs + row_w * HD;
  const float* krow = Ks + lc * HD;
  const int kx = lc & C::kKSwz;
  float* prow = Ps + row_w * kTP;
  const float* vrow = Vs + lc * C::kW;

  for (int t0 = t_first; t0 < k_end; t0 += kTK) {
    if (t0 == t_first) {
      cp_async_wait<1>();             // V_0 may still be on its way
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // K_t is in; P V_(t-1) is done
    if (t0 != t_first) {
      fill<T, HD, kTK, 0>(Vs, vp, a.v_ss, t0, a.kv_len);
      cp_async_commit();
    }

    float s[8][8];
    if (live) {
      // S = Q K_t^T; a warp whose rows see no key in the tile's second
      // half (a causal diagonal tile, or kv_len) skips its key groups
      // there, which the masks then hold at -inf
      if (w_end - t0 <= kTP) {
        qk<4, HD>(s, krow, kx, qrow, lr);
      } else {
        qk<8, HD>(s, krow, kx, qrow, lr);
      }

      // online softmax; masks only on a tile that crosses a mask's edge
      if (t0 + kTK > a.kv_len || (a.causal && t0 + kTK - 1 > q0) ||
          (a.window > 0 && t0 <= q0 + kTQ - 1 - a.window)) {
        softmax<true, HD>(s, o, m, l, a.kv_len, a.causal, a.window,
                          q0 + row_w, t0 + lc, c2);
      } else {
        softmax<false, HD>(s, o, m, l, a.kv_len, a.causal, a.window,
                           q0 + row_w, t0 + lc, c2);
      }
    }

    cp_async_wait<0>();
    __syncthreads();                  // V_t is in; S is done with K_t
    if (t0 + kTK < k_end) {
      fill<T, HD, kTK, C::kKSwz>(Ks, kp, a.k_ss, t0 + kTK, a.kv_len);
      cp_async_commit();
    }

    if (live) {
      // O += P V_t in two halves of 64 keys, P through the warp's own
      // rows of shared memory; chunks of 4 keys past w_end hold only
      // zeros of P and are skipped
      const int nc = min(kTK, w_end - t0 + 3) / 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half * (kTP / 4) >= nc) break;
        __syncwarp();                 // the other half's readers are done
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = lc + 16 * j;     // in the half tile
            const int at = (((key >> 2) ^ (lr << 2)) << 2) | (key & 3);
            prow[2 * i * kTP + at] = s[i][4 * half + j];
          }
        __syncwarp();
        pv<HD>(o, prow, vrow, lr, half * (kTP / 4),
               min(nc, (half + 1) * (kTP / 4)));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float den = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    den = fmaxf(den, 1e-30f);
    const int row = q0 + row_w + 2 * i;
    if (row >= a.sq) continue;
    T* out = op + row * a.o_ss + lc * C::kW;
#pragma unroll
    for (int v = 0; v < C::kNV; ++v)
#pragma unroll
      for (int e = 0; e < C::kW; ++e)
        store(out + 16 * C::kW * v + e, o[i][v * C::kW + e] / den);
  }
}

template <typename T, int HD>
cudaError_t prepare() {
  // The attribute belongs to the current device, so it is set on every
  // launch: a cached flag would skip it on a second card.
  if (Core<HD>::kBytes > 48 * 1024)
    return cudaFuncSetAttribute(flash_fwd<T, HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Core<HD>::kBytes);
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  cudaError_t err = prepare<T, HD>();
  if (err != cudaSuccess) return err;
  constexpr int kTQ = Core<HD>::kTQ;
  const dim3 grid((a.sq + kTQ - 1) / kTQ, batch * a.heads);
  flash_fwd<T, HD><<<grid, Core<HD>::kThreads, Core<HD>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t occupancy(int* out) {
  cudaError_t err = prepare<T, HD>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_fwd<T, HD>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], flash_fwd<T, HD>, Core<HD>::kThreads, Core<HD>::kBytes);
  if (err != cudaSuccess) return err;
  out[0] = Core<HD>::kBytes;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_t(const Args& a, int batch, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t occupancy_t(int hd, int* out) {
  switch (hd) {
    case 16: return occupancy<T, 16>(out);
    case 32: return occupancy<T, 32>(out);
    case 64: return occupancy<T, 64>(out);
    case 128: return occupancy<T, 128>(out);
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

// The instantiation for (hd, dtype) on the current device: out[0] shared
// memory bytes a block, out[1] blocks an SM (the occupancy calculator's),
// out[2] registers a thread, out[3] local memory bytes a thread (spills).
int repro_flash_attention_occupancy(int hd, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = dtype == 0 ? occupancy_t<float>(hd, out)
                                     : occupancy_t<__nv_bfloat16>(hd, out);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
