// Flash attention for Hopper (sm_90a), tensor-core prefill route: grouped-
// query softmax attention with causal, sliding-window and pad (kv_len)
// masks, for bf16 q, k, v with hd 64 or 128 and more than 16 query rows.
// The masks and the result are those of csrc/flash_attention.cu (whose
// header has the route table):
//     s[i, j] = (q[i] . k[j]) * scale,  scale = 1 / sqrt(hd)
//     row i sees key j  iff  j < kv_len  and  (not causal or j <= i)
//                                        and  (window <= 0 or j > i - window)
//     o[i]    = sum_j softmax_j(s[i, :])[j] * v[j]   (0 where row i sees none)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel) on the prefill path.
//
// What bounds it: operations. qwen3-1.7b's prefill (B = 4, 16 heads over 8
// KV heads, S = 2048, hd = 128, causal) does 68.7 GFLOP a layer against
// 101 MB of q, k, v and o, about 680 operations a byte, above the card's
// 295 for bf16; the least time is 69 us a layer at 989 TFLOP/s, which only
// the tensor cores reach through wgmma.
//
// What the design does about that:
// - A block has two consumer warpgroups; each owns 64 query rows of one
//   (batch, head), so a block owns 128 rows. It walks KV tiles of 128 keys.
//   S = Q.K^T is a wgmma m64n128k16 per 16 columns of hd, with Q and K read
//   from shared memory (both K-major) and f32 accumulation. The online
//   softmax runs on that f32 fragment in registers: the scale, with log2(e)
//   folded in, is applied to the f32 scores after the dot, and exp2 is
//   ex2.approx. P is rounded to bf16 in registers and is the register A
//   operand of O += P.V (wgmma m64nHDk16), so it never touches shared
//   memory; V is read from shared memory as B with the transpose flag, so
//   there is no transpose pass. The row sum l adds the f32 probabilities.
// - Copies: TMA (cp.async.bulk.tensor, one thread) fills a ring of two K/V
//   stages ahead of the consumers; each tile signals a "full" mbarrier per
//   stage for K and one for V, so S starts before V has landed, and every
//   warp signals an "empty" mbarrier when its wgmmas on a stage are done.
//   The issuing thread waits on that before it refills the stage, so the
//   two warpgroups are not held in step and one's softmax overlaps the
//   other's products. Each tile is loaded as boxes of 64 columns (128
//   bytes) with 128-byte swizzle, the same swizzle the wgmma descriptors
//   name; the tiles are 1024-byte aligned so the two agree on the pattern.
//   The tensor maps are encoded on the host, one per tensor a call, with
//   cuTensorMapEncodeTiled taken through cudaGetDriverEntryPoint (no
//   -lcuda). Their bounds are the tensors' Sq and Skv: rows past them are
//   zero-filled by the copy, and keys in [kv_len, Skv) are read and given
//   an exact 0 weight (as in the plain version, they must be finite).
// - Shared memory: Q 128 x hd, two stages of K and of V 128 x hd, bf16:
//   160 KB at hd = 128, asked for on every launch; one block an SM.
// - Order: the grid is (batch * heads, query tiles) with the last query
//   tile first, so the heaviest causal tiles start first on all heads.
// - Tile skip as the TPU kernel's: the loop starts at the first tile the
//   window allows and ends at the last one causality and kv_len allow
//   (q0 + 128 for the block's rows, which holds for ragged Sq); a tile
//   wholly visible to a warpgroup's rows is not masked. A fully masked
//   row keeps m = -inf and l = 0: its probabilities and corrections are
//   exp2(-inf) = 0 and its output 0 * (l > 0 ? 1 / l : 0) = 0, not NaN.
//   kv_len = 0 (or a block with no visible tile) writes zeros and loads
//   nothing.
// - Accumulator fragments: thread t of a warpgroup holds rows
//   16 * (t / 32) + (t % 32) / 4 and that + 8, and column pairs
//   8 * j + 2 * (t % 4); the same pairs are the A fragment of P.V.
// - Any (batch, head, row) strides with 16-byte alignment are taken (the
//   wrapper checks), so the model's views go in without copies; head h
//   reads KV head h / group.
#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWG = 128;              // threads of a warpgroup
constexpr int kThreads = 2 * kWG;     // two consumer warpgroups
constexpr int kTQ = 128;              // query rows a block (64 a warpgroup)
constexpr int kTK = 128;              // keys a KV tile
constexpr int kBox = 64;              // bf16 columns of a 128-byte box
constexpr int kRegion = 128 * 128;    // bytes of one 128-row, 64-column box
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Layout {                       // byte offsets from a 1024-aligned base
  static constexpr int kTile = HD / kBox * kRegion;   // a Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                    // two stages
  static constexpr int kV = kK + 2 * kTile;           // two stages
  static constexpr int kBar = kV + 2 * kTile;         // 7 mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;     // + alignment slack
};

// mbarriers, by index: Q full; K full of stage 0, 1; V full of stage 0, 1;
// stage 0, 1 empty (one arrival a consumer warp).
constexpr int kBarQ = 0, kBarK = 1, kBarV = 3, kBarFree = 5;

struct TcArgs {
  void* o;
  long long o_sb, o_sh, o_ss;         // element strides of (batch, head, row)
  int heads, group, sq, kv_len, causal, window, q_tiles;
  float scale_log2;                   // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One 64-column box of a 4-d (hd, rows, heads, batch) tensor map into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// A whole 128-row tile (hd / 64 boxes) and its byte count on `bar`.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int head,
                                          int batch) {
  mbar_expect_tx(bar, Layout<HD>::kTile);
#pragma unroll
  for (int c = 0; c < HD / kBox; ++c)
    tma_load(dst + c * kRegion, map, bar, c * kBox, row, head, batch);
}

// wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the fence or the wait that orders them with the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int key, int row, const TcArgs& a) {
  return key < a.kv_len && (!a.causal || key <= row) &&
         (a.window <= 0 || key > row - a.window);
}

// D (64 x 128, f32) {=, +=} A (64 x 16) * B (16 x 128): bf16 operands read
// from shared memory through 128-byte-swizzle descriptors, both K-major;
// acc = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, bf16
// in shared memory, MN-major: the transpose flag reads V's rows as B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, bf16
// in shared memory, MN-major: the transpose flag reads V's rows as B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const TcArgs a) {
  using L = Layout<HD>;
  constexpr int kO = HD / 2;          // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: the TMA boxes and the wgmma
  // descriptors agree on the pattern only from a 1024-aligned base
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int warp = (tid % kWG) / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int kvh = h / a.group;
  // the heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (a.q_tiles - 1 - blockIdx.y) * kTQ;
  // tile skip: keys the window leaves to every row of the block, and keys
  // past causality or kv_len, are never loaded
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_end = a.causal ? min(a.kv_len, q0 + kTQ) : a.kv_len;
  const int t_first = k_begin / kTK;
  const int n_tiles =
      k_end > t_first * kTK ? (k_end - t_first * kTK + kTK - 1) / kTK : 0;

  const int wrow = q0 + 64 * wg;      // first row of this warpgroup
  const int row0 = wrow + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    if (tid == 0) {
      for (int i = 0; i < kBarFree; ++i) mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * kBarFree, 8);
      mbar_init(bars + 8 * (kBarFree + 1), 8);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      load_tile<HD>(base + L::kQ, &map_q, bars + 8 * kBarQ, q0, h, b);
      load_tile<HD>(base + L::kK, &map_k, bars + 8 * kBarK, t_first * kTK,
                    kvh, b);
      load_tile<HD>(base + L::kV, &map_v, bars + 8 * kBarV, t_first * kTK,
                    kvh, b);
    }
    __syncwarp();
    mbar_wait(bars + 8 * kBarQ, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1;
      const uint32_t parity = (it >> 1) & 1;
      const int t0 = (t_first + it) * kTK;
      if (tid == 0 && it + 1 < n_tiles) {
        // refill the other stage once every consumer warp has left it
        const int ns = st ^ 1;
        if (it >= 1)
          mbar_wait(bars + 8 * (kBarFree + ns), ((it - 1) >> 1) & 1);
        load_tile<HD>(base + L::kK + ns * L::kTile, &map_k,
                      bars + 8 * (kBarK + ns), t0 + kTK, kvh, b);
        load_tile<HD>(base + L::kV + ns * L::kTile, &map_v,
                      bars + 8 * (kBarV + ns), t0 + kTK, kvh, b);
      }
      __syncwarp();

      // S = Q K^T for this warpgroup's 64 rows and the tile's 128 keys
      float sc[64];
      mbar_wait(bars + 8 * (kBarK + st), parity);
      const uint32_t qa = base + L::kQ + wg * 64 * 128;
      const uint32_t ka = base + L::kK + st * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // 16 columns of hd: box kk / 4, 32 bytes into its 128-byte rows
        const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(qa + off, 16, 1024),
                      sw128_desc(ka + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax on the f32 fragment, in the log2 domain
      const bool masked =
          t0 + kTK > a.kv_len || (a.causal && t0 + kTK - 1 > wrow) ||
          (a.window > 0 && t0 <= wrow + 63 - a.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * j + e] * a.scale_log2;
          float x1 = sc[4 * j + 2 + e] * a.scale_log2;
          if (masked) {
            const int key = t0 + 8 * j + col + e;
            if (!visible(key, row0, a)) x0 = -INFINITY;
            if (!visible(key, row1, a)) x1 = -INFINITY;
          }
          sc[4 * j + e] = x0;
          sc[4 * j + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      // a row lives on the four threads of a quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with no visible key so far subtracts 0: exp2(-inf) = 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = ex2(m0 - mu0), c1 = ex2(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
      uint32_t pf[8][4];              // P as bf16 A fragments, 16 keys each
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p00 = ex2(sc[4 * j] - mu0), p01 = ex2(sc[4 * j + 1] - mu0);
        const float p10 = ex2(sc[4 * j + 2] - mu1);
        const float p11 = ex2(sc[4 * j + 3] - mu1);
        rs0 += p00 + p01;
        rs1 += p10 + p11;
        pf[j / 2][2 * (j % 2)] = pack_bf16(p00, p01);
        pf[j / 2][2 * (j % 2) + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }

      // O += P V: 16 keys a product, V's rows read as B with the transpose
      mbar_wait(bars + 8 * (kBarV + st), parity);
      const uint32_t va = base + L::kV + st * L::kTile;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        // 16 keys are two 1024-byte groups of 8 rows; the next 64 columns
        // of hd are the next box (the leading byte offset)
        const uint64_t dv = sw128_desc(va + kk * 2048, kRegion, 1024);
        if constexpr (HD == 128)
          wgmma_rs_n128(o, pf[kk], dv);
        else
          wgmma_rs_n64(o, pf[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kBarFree + st));
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh + col;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row0 * a.o_ss + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (row1 < a.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row1 * a.o_ss + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 (batch, rows, heads, hd) view with element strides (sb, sh, ss)
// as a 4-d map over (hd, rows, heads, batch), boxes of 64 x 128 x 1 x 1.
bool encode_map(CUtensorMap* map, const void* ptr, int hd, int rows,
                int heads, int batch, long long sb, long long sh,
                long long ss) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  // byte strides of dims 1..3; an axis of extent 1 is never stepped, so a
  // zero stride there (a broadcast view) is given a legal one
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                           static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1 && strides[i] == 0) strides[i] = 16;
  const cuuint32_t box[4] = {kBox, 128, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const TcArgs& a, int batch,
                   cudaStream_t stream) {
  constexpr int kSmem = Layout<HD>::kBytes;
  // The attribute belongs to the current device, so it is set on every
  // launch: a cached flag would skip it on a second card.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, a.q_tiles);
  flash_fwd_tc<HD><<<grid, kThreads, kSmem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (batch, sq, heads, hd), k and v: (batch, skv, heads / group, hd), o like
// q, all bf16, each given by its base pointer and its element strides of
// (batch, head, row); the last axis is contiguous. hd is 64 or 128; sq > 0;
// 0 <= kv_len <= skv. Pointers and strides are 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a refused shape or a
// tensor map the driver does not encode.
int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                             void* o, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long o_sb, long long o_sh,
                             long long o_ss, int batch, int heads, int group,
                             int sq, int skv, int kv_len, int causal,
                             int window, int hd, float scale,
                             void* stream_ptr) {
  const int q_tiles = (sq + kTQ - 1) / kTQ;
  if (batch < 1 || heads < 1 || group < 1 || heads % group || sq < 1 ||
      skv < 1 || kv_len < 0 || kv_len > skv || (hd != 64 && hd != 128) ||
      q_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  const int kv_heads = heads / group;
  if (!encode_map(&mq, q, hd, sq, heads, batch, q_sb, q_sh, q_ss) ||
      !encode_map(&mk, k, hd, skv, kv_heads, batch, k_sb, k_sh, k_ss) ||
      !encode_map(&mv, v, hd, skv, kv_heads, batch, v_sb, v_sh, v_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{o,     o_sb,  o_sh,   o_ss,   heads,  group,
                 sq,    kv_len, causal, window, q_tiles, scale * kLog2e};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = hd == 64 ? launch<64>(mq, mk, mv, a, batch, stream)
                                   : launch<128>(mq, mk, mv, a, batch, stream);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
