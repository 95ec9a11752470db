// Spec-verify flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spec_verify/kernel.py:
// spec_verify_attention_kernel (body _verify_attn_kernel): attention of
// the (K+1)-token draft block against the position-tagged ring KV cache.
// GQA rows r = t*G + g; slot s is visible to row r iff
// 0 <= cpos[s] <= qpos[r] and, with a window, cpos[s] > qpos[r] - window;
// optional tanh softcap; online softmax in float32 over KV tiles, with the
// reference's guards (rows that see nothing stay empty; the output is
// acc / max(l, 1e-20), 0 for a row that sees no slot).
//
// What bounds it on this card: bytes. Each valid K and V slot must be
// read once, 2*B*Hkv*S*hd*2 bytes in bf16, against 4*B*Hq*T*S*hd flops
// that tensor cores finish far sooner.
//
// The bfloat16 kernel (spec_verify_tc_kernel) is built around that:
// - One K/V stream per (batch, kv head, split): a CTA holds up to NWG * 64
//   query rows of one kv head (TcCfg, :353): two consumer warpgroups at
//   hd <= 128, one at hd 256 (its 64 x 256 float32 accumulator fills half
//   a thread's registers). A (b, head, split) range is read once from HBM
//   and ceil(T*G / rows) times from L2: once at Qwen3-8B's 68 rows, 5
//   times at RecurrentGemma-9B's 272 (the grid, :1020).
// - Split-KV: split j of n_split owns the ring's tiles j, j + n_split, ...
//   (fixed by tile index, so by the shapes alone; the plan is
//   kernels/spec_verify/ops.py:split_plan). Interleaved, a partly filled
//   ring spreads over all the splits. Each CTA writes its partial
//   (m, l, acc) in float32 (:683); spec_verify_combine_kernel
//   (:737) merges a row's partials in split order, with no atomics: a
//   row's output depends only on its query, its position and the cache.
//   An empty partial is m = -1e30, l = 0 and no acc.
// - K/V reach shared memory by TMA (cp.async.bulk.tensor, a CUtensorMap
//   each for K and V, encoded per call, 128-byte swizzle; kv_map,
//   :988) into a ring of STAGES = 4 tiles completed on mbarriers: the
//   producer warp (:504) keeps up to four tiles in flight while the
//   consumer warpgroups compute (:524).
// - QK^T (:571) and P.V (:664) on wgmma: Q staged once in shared memory
//   as the A operand, K as B (wgmma_ss_*); P from registers as A, V as
//   the transposed (MN-major) B (wgmma_rs_n64). float32 accumulation, P
//   rounded to bf16 for P.V.
// - The online softmax runs in registers on the accumulator fragments
//   (:585), in base 2 (log2(e) folded into the scale: one ex2 an
//   entry), with quad shuffles for row max and sum: no score tile goes
//   through shared memory. A warp whose rows all see a whole tile skips
//   the mask, and a rescale by exactly 1 is skipped; neither changes a
//   value.
// - Tiles no row of the CTA can see (empty ring slots, slots past its
//   last position, out of the window) are never loaded: the prologue
//   reads the split's slot positions once and marks the live tiles
//   (:461); the producer issues TMA for those alone. A CTA with none
//   writes an empty partial. A tile masked for a row leaves the row's
//   state bit for bit unchanged, so skipping it is exact.
// Tiles are 64 slots at hd <= 128 and 32 at hd = 256 (four stages fit
// next to the query rows); hd 32 is read as 64 columns, the upper half
// zero-filled by TMA's bounds handling.
//
// float32 inputs (the exact gate: resumes, re-sliced batches, small
// models) take spec_verify_f32_kernel, full float32 fused multiply-adds on
// CUDA cores (no TF32). What bounds it: operations (4 flops a visible
// (row, slot) pair and head dim, against 67 TFLOP/s), and before them
// shared memory, which returns 128 bytes a clock an SM: a CUDA-core
// product must reuse each loaded float across several multiply-adds.
// - Split-KV as in bf16, but the plan (kernels/spec_verify/ops.py:
//   f32_split_plan) is fixed by S+1, hd and the SM count alone (splits of
//   at least 128 slots, tiles owned by index), so a row's float32 output
//   does not depend on B, T or the other rows, bit for bit; only the cut
//   of a kv head's T*G rows into CTAs (up to 96 rows, 8 a warp) follows
//   the batch. One K/V stream per (batch, kv head, split, row block); at
//   Qwen3-8B's 68 rows a kv head, one block.
// - K/V tiles (64 slots; 32 at hd 256) by 16-byte cp.async into a
//   two-stage ring, one copy group a tile, the next in flight while one
//   is computed; the split's first tile is fetched with the query rows
//   before the slot positions say whether it is live, and the slot and
//   row positions are loaded ahead of both.
// - Register tiles: a lane holds 4 rows x 4 slots of scores (a k-step:
//   4 + 4 float4 loads for 64 fused multiply-adds) and 4 rows x hd/16
//   output columns (a slot of P.V: one float4 of P and hd/64 of V for
//   hd/4 multiply-adds), Q, K and V rows padded to hd + 4 floats.
// - The online softmax runs on the score registers, base 2, row max and
//   sum by shuffles over a row's 16 lanes; a rescale by exactly 1 is
//   skipped. Tiles no row of the CTA sees are never loaded, and 16-slot
//   blocks past a tile's last visible slot are not computed: both leave a
//   row's state bit for bit as it was.
// - Partials merge in split order in spec_verify_f32_combine_kernel
//   (float32 out), launched as a programmatic dependent of the main grid
//   so its launch overlaps that grid's tail.
// hd must be 32, 64, 128 or 256 (the wrapper checks).
//
// The tensor maps come from the driver's cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {


constexpr float NEG = -1e30f;

// ---- bfloat16: TMA + wgmma, split-KV ----------------------------------------

constexpr int WG_ROWS = 64;   // rows of a consumer warpgroup (wgmma M)
constexpr int STAGES = 4;     // K/V tiles in the smem ring
constexpr int CPCAP = 4096;   // slot positions a split stages

struct TcShape {
  int Tq, Hq, Hkv, S1, hd, window;
  float softcap, scale;
  int n_split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits for the barrier's phase of this parity. A wait of more than 2^35
// cycles (~17 s) can only be a fault of the pipeline: it traps, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  }
}

// One TMA box: 64 head-dim columns (128 bytes, swizzled) x the tile's
// slots of one (batch, kv head), coordinates innermost first.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart (the stride offset). Every operand
// here spans one swizzle atom along its contiguous dimension (16 of 64
// columns of Q or K; 64 columns of V), so the leading offset is unused;
// it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers after a wait, so that no use of them is
// moved above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D(64 x 64, f32) += A(smem desc, K-major) * B(smem desc, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 32, f32) += A(smem desc, K-major) * B(smem desc, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64, f32) += A(registers) * B(smem desc, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x (MUFU): the softmax runs in base 2, with log2(e) folded into the
// score scale, so that each probability is one multiply-add and one ex2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;


// One instantiation's geometry. HDP: the head dim padded to a multiple of
// 64 (64, 128, 256); KT: slots per K/V tile; NWG: consumer warpgroups of
// 64 query rows (2 at hd <= 128; 1 at hd 256, where a warpgroup's 64 x
// 256 float32 accumulator takes half a thread's registers); one producer
// warp. Shared memory, in this order from a 1024-byte-aligned base: Q
// (NWG x NC chunks of 64 rows x 128 B), STAGES x (K, V) tiles (NC chunks
// of KT rows x 128 B each), the split's slot positions, per split tile a
// live flag and its lowest and highest slot position, full/empty
// barriers, the rows' position range.
template <int HDP, int KT, int NWG>
struct TcCfg {
  static constexpr int NC = HDP / 64;
  static constexpr int ROWS = NWG * WG_ROWS;  // query rows of a CTA
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int CHUNK = KT * 128;
  static constexpr int STAGE = 2 * NC * CHUNK;
  static constexpr int QBYTES = NWG * NC * WG_ROWS * 128;
  static constexpr int MAXT = CPCAP / KT;
  static constexpr size_t bytes() {
    return 1024 + QBYTES + (size_t)STAGES * STAGE + 4 * CPCAP + 12 * MAXT +
           16 * STAGES + 16;
  }
};

// Grid (row blocks x n_split, Hkv, B). Split j owns the ring's tiles j,
// j + n_split, j + 2 n_split, ... The NWG consumer warpgroups own 64
// query rows each; the last warp produces: it reads the split's slot
// positions, marks the live tiles and issues their TMA loads, while the
// consumers stage their query rows.
template <int HDP, int KT, int NWG>
__global__ void __launch_bounds__(TcCfg<HDP, KT, NWG>::THREADS, 1)
spec_verify_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ cpos,
                      const int* __restrict__ pos,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part, TcShape sh) {
  using L = TcCfg<HDP, KT, NWG>;
  constexpr int NC = L::NC;
  constexpr int NS = KT / 8;  // n8 blocks of a score tile
  constexpr int QITER = WG_ROWS * (HDP / 8) / 128;  // Q units a thread

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* kv_s = base + L::QBYTES;
  int* cp_s = reinterpret_cast<int*>(kv_s + STAGES * L::STAGE);
  int* live_s = cp_s + CPCAP;
  int* tmin_s = live_s + L::MAXT;
  int* tmax_s = tmin_s + L::MAXT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tmax_s + L::MAXT);
  int* pw_s = reinterpret_cast<int*>(bars + 2 * STAGES);  // rows' min, max
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);

  const int G = sh.Hq / sh.Hkv, TG = sh.Tq * G;
  const int split = blockIdx.x % sh.n_split;
  const int r0 = (blockIdx.x / sh.n_split) * L::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (sh.S1 + KT - 1) / KT;
  const int nt = (n_tiles - split + sh.n_split - 1) / sh.n_split;  // tiles
  // this CTA's partials: (b, h, split) x T*G rows
  const size_t prow = (((size_t)b * sh.Hkv + h) * sh.n_split + split) * TG;
  const size_t n_part_rows = (size_t)gridDim.z * sh.Hkv * sh.n_split * TG;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);    // the producer's expect_tx + bytes
      mbar_init(empty0 + 8 * i, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // ---- prologue: one round of global loads by every thread: the
  // consumers' query rows (kept in registers), the split's slot positions
  // (-1 past S+1), the rows' position range (the producer warp) ----
  const bool consumer = warp < 4 * NWG;  // warp-uniform
  const int wg = warp / 4, wq = warp % 4, wtid = tid % 128;
  const int rw0 = r0 + wg * WG_ROWS;
  const int rA = rw0 + wq * 16 + lane / 4, rB = rA + 8;  // a thread's rows
  int hiA = 0, hiB = 0;  // their positions
  if (consumer && rA < TG) hiA = __ldg(pos + (size_t)b * sh.Tq + rA / G);
  if (consumer && rB < TG) hiB = __ldg(pos + (size_t)b * sh.Tq + rB / G);
  uint4 qv[QITER];
#pragma unroll
  for (int k = 0; k < QITER; ++k) {
    const int i = wtid + k * 128;
    const int row = rw0 + i / (HDP / 8), u = i % (HDP / 8);
    qv[k] = make_uint4(0, 0, 0, 0);
    if (consumer && row < TG && u * 8 < sh.hd)
      qv[k] = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * sh.Tq + row / G) * sh.Hq + h * G + row % G) *
                  sh.hd + u * 8));
  }
#pragma unroll 4
  for (int i = tid; i < nt * KT; i += L::THREADS) {
    const int s = (split + (i / KT) * sh.n_split) * KT + i % KT;
    cp_s[i] = s < sh.S1 ? __ldg(cpos + (size_t)b * sh.S1 + s) : -1;
  }
  if (!consumer) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = r0 + lane; r < min(r0 + L::ROWS, TG); r += 32) {
      const int qp = __ldg(pos + (size_t)b * sh.Tq + r / G);
      mn = min(mn, qp);
      mx = max(mx, qp);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      pw_s[0] = mn;
      pw_s[1] = mx;
    }
  }
  __syncthreads();
  // a tile is live iff some row of the CTA can see one of its slots; its
  // lowest and highest position let a consumer warp skip the mask (every
  // warp takes a share of the split's tiles)
  const int qmin = pw_s[0], qmax = pw_s[1];
  int any = 0;
  for (int k = warp; k < nt; k += L::THREADS / 32) {
    int live = 0, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
    for (int j = lane; j < KT; j += 32) {
      const int cp = cp_s[k * KT + j];
      live |= cp >= 0 && cp <= qmax &&
              (sh.window <= 0 || cp > qmin - sh.window);
      cmin = min(cmin, cp);
      cmax = max(cmax, cp);
    }
    live = __any_sync(0xffffffffu, live);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, off));
      cmax = max(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    }
    if (lane == 0) {
      live_s[k] = live;
      tmin_s[k] = cmin;
      tmax_s[k] = cmax;
    }
    any |= live;
  }
  // Q into shared memory, swizzled as TMA would (16-byte unit u of row r
  // at u ^ (r % 8))
  if (consumer) {
#pragma unroll
    for (int k = 0; k < QITER; ++k) {
      const int i = wtid + k * 128;
      const int rr = i / (HDP / 8), u = i % (HDP / 8);
      *reinterpret_cast<uint4*>(q_s + (wg * NC + u / 8) * (WG_ROWS * 128) +
                                rr * 128 + (((u % 8) ^ (rr % 8)) << 4)) =
          qv[k];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  any = __syncthreads_or(any);

  if (!consumer) {  // ---- producer warp: TMA for the live tiles, in order
    if (lane == 0) {
      int it = 0;
      for (int k = 0; k < nt; ++k) {
        if (!live_s[k]) continue;
        const int t = split + k * sh.n_split;
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * st, ((it / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, L::STAGE);
        const uint32_t dst = smem_u32(kv_s + st * L::STAGE);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(&kmap, dst + c * L::CHUNK, full, c * 64, h, t * KT, b);
          tma_load(&vmap, dst + (NC + c) * L::CHUNK, full, c * 64, h, t * KT,
                   b);
        }
        ++it;
      }
    }
  } else {  // ---- consumers: warpgroup wg owns rows r0 + 64 wg ... + 63 ----
    const int g = lane / 4, tq = lane % 4;  // accumulator coordinates
    const bool active = rw0 < TG;                // warpgroup-uniform
    const bool warp_rows = rw0 + 16 * wq < TG;   // warp-uniform
    // row r sees slot positions [lo, hi]; nothing for a row past T*G
    const int loA = rA >= TG ? 1 : sh.window > 0 ? max(hiA - sh.window + 1, 0)
                                                 : 0;
    const int loB = rB >= TG ? 1 : sh.window > 0 ? max(hiB - sh.window + 1, 0)
                                                 : 0;
    // the positions every row of the warp sees (empty past T*G)
    int wlo = max(loA, loB), whi = min(hiA, hiB);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wlo = max(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
      whi = min(whi, __shfl_xor_sync(0xffffffffu, whi, off));
    }

    const float sl2 = sh.scale * LOG2E;
    const float inv_cap = sh.softcap > 0.f ? sh.scale / sh.softcap : 0.f;
    const float cap_l2 = sh.softcap * LOG2E;
    const uint32_t qaddr = smem_u32(q_s + wg * NC * (WG_ROWS * 128));

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float sc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    // running max (log2 units) and sum of this thread's two rows
    float mA = NEG, mB = NEG, lA = 0.f, lB = 0.f;

    int it = 0;
    for (int k = 0; any && k < nt; ++k) {
      if (!live_s[k]) continue;
      const int st = it % STAGES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      __syncwarp();
      if (active) {
        const uint32_t kaddr = smem_u32(kv_s + st * L::STAGE);
        const uint32_t vaddr = kaddr + NC * L::CHUNK;
        // Q's address through an opaque move: its HDP / 16 descriptors are
        // formed next to their wgmma, not hoisted out of the loop into
        // registers the accumulator needs
        uint32_t qa;
        asm volatile("mov.b32 %0, %1;\n" : "=r"(qa) : "r"(qaddr));
        // ---- S = Q K^T (wgmma, both operands in shared memory) ----
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint64_t da = sw128_desc(qa + (kk / 4) * (WG_ROWS * 128) +
                                         (kk % 4) * 32);
          const uint64_t db =
              sw128_desc(kaddr + (kk / 4) * L::CHUNK + (kk % 4) * 32);
          if constexpr (KT == 64) wgmma_ss_n64(sc, da, db, kk > 0);
          else wgmma_ss_n32(sc, da, db, kk > 0);
        }
        wgmma_commit_wait();
        fence_regs(sc);

        // ---- online softmax in registers, base 2: sc[4j + e] is row
        // (e < 2 ? A : B), slot 8j + 2tq + (e & 1) of the tile. A warp
        // with no row below T*G skips it (its P stays unused); a warp
        // whose rows all see every slot of the tile skips the mask. Both
        // paths compute a visible entry alike, so a row's result does not
        // depend on the rows it shares a warp with. ----
        if (warp_rows) {
          const bool all_vis = tmin_s[k] >= wlo && tmax_s[k] <= whi;
          if (sh.softcap > 0.f) {
#pragma unroll
            for (int i = 0; i < KT / 2; ++i)
              sc[i] = tanhf(sc[i] * inv_cap) * cap_l2;
          } else {
#pragma unroll
            for (int i = 0; i < KT / 2; ++i) sc[i] *= sl2;
          }
          if (!all_vis) {
            const int* cpt = cp_s + k * KT;
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int cp = cpt[8 * j + 2 * tq + (e & 1)];
                const bool vis = e >= 2 ? (cp >= loB && cp <= hiB)
                                        : (cp >= loA && cp <= hiA);
                if (!vis) sc[4 * j + e] = NEG;
              }
          }
          float mxA = NEG, mxB = NEG;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            mxA = fmaxf(mxA, fmaxf(sc[4 * j], sc[4 * j + 1]));
            mxB = fmaxf(mxB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
          }
          const float mnA = fmaxf(mA, quad_max(mxA));
          const float mnB = fmaxf(mB, quad_max(mxB));
          // a row with nothing visible yet keeps an empty state: its
          // reference point 0 sends every masked entry to ex2(-1e30) = 0
          const float refA = mnA > NEG ? mnA : 0.f;
          const float refB = mnB > NEG ? mnB : 0.f;
          const float alA = ex2(mA - refA), alB = ex2(mB - refB);
          float sumA = 0.f, sumB = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            sc[4 * j] = ex2(sc[4 * j] - refA);
            sc[4 * j + 1] = ex2(sc[4 * j + 1] - refA);
            sc[4 * j + 2] = ex2(sc[4 * j + 2] - refB);
            sc[4 * j + 3] = ex2(sc[4 * j + 3] - refB);
            sumA += sc[4 * j] + sc[4 * j + 1];
            sumB += sc[4 * j + 2] + sc[4 * j + 3];
          }
          lA = alA * lA + quad_sum(sumA);
          lB = alB * lB + quad_sum(sumB);
          mA = mnA;
          mB = mnB;
          // a rescale by exactly 1 changes nothing: skipped
          if (!__all_sync(0xffffffffu, alA == 1.f && alB == 1.f)) {
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                acc[c][4 * j] *= alA;
                acc[c][4 * j + 1] *= alA;
                acc[c][4 * j + 2] *= alB;
                acc[c][4 * j + 3] *= alB;
              }
          }
        }
        // P (bf16) as wgmma A fragments: k-step kk takes n8 blocks 2kk and
        // 2kk + 1
        uint32_t pa[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        // ---- acc += P V (wgmma, P from registers, V transposed) ----
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk)
            wgmma_rs_n64(acc[c], pa[kk],
                         sw128_desc(vaddr + c * L::CHUNK + kk * 16 * 128));
        wgmma_commit_wait();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
      ++it;
    }

    // ---- epilogue: the output (one split) or this split's partial, m in
    // log2 units; an empty partial (m = -1e30, l = 0) writes no acc ----
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? rB : rA;
        if (row >= TG) continue;
        const float m = half ? mB : mA, l = half ? lB : lA;
        if (sh.n_split == 1) {
          const int tr = row / G, gq = row % G;
          __nv_bfloat16* orow =
              out + (((size_t)b * sh.Tq + tr) * sh.Hq + h * G + gq) * sh.hd;
          const float lc = fmaxf(l, 1e-20f);
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = c * 64 + 8 * j + 2 * tq;
              if (col < sh.hd)
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    __floats2bfloat162_rn(acc[c][4 * j + 2 * half] / lc,
                                          acc[c][4 * j + 2 * half + 1] / lc);
            }
        } else {
          if (m > NEG) {
            float* arow = part + (prow + row) * sh.hd;
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = c * 64 + 8 * j + 2 * tq;
                if (col < sh.hd)
                  *reinterpret_cast<float2*>(arow + col) = make_float2(
                      acc[c][4 * j + 2 * half], acc[c][4 * j + 2 * half + 1]);
              }
          }
          if (tq == 0) {
            part[n_part_rows * sh.hd + 2 * (prow + row)] = m;
            part[n_part_rows * sh.hd + 2 * (prow + row) + 1] = l;
          }
        }
      }
    }
  }
}

constexpr int CB_THREADS = 256;

// Merges the n_split partials of each (batch, kv head, row) in split
// order: M = max m_i; out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-20)
// with w_i = 2^(m_i - M) (m in log2 units), and w_i = 0 (acc_i not read)
// for an empty partial (m_i = -1e30). hd / 4 threads a row, four columns
// a thread; rows (b, kv head, t*G + g) in order.
__global__ void __launch_bounds__(CB_THREADS)
spec_verify_combine_kernel(const float* __restrict__ part,
                           __nv_bfloat16* __restrict__ out, TcShape sh,
                           int n_rows) {
  const int G = sh.Hq / sh.Hkv, TG = sh.Tq * G;
  const int tpr = sh.hd / 4;
  const int r = blockIdx.x * (CB_THREADS / tpr) + threadIdx.x / tpr;
  if (r >= n_rows) return;
  const int col = (threadIdx.x % tpr) * 4;
  const int row = r % TG, bh = r / TG;
  const int h = bh % sh.Hkv, b = bh / sh.Hkv;
  const size_t p0 = (size_t)bh * sh.n_split;
  const float* ml = part + (size_t)n_rows * sh.n_split * sh.hd;
  float M = NEG;
  for (int i = 0; i < sh.n_split; ++i)
    M = fmaxf(M, ml[2 * ((p0 + i) * TG + row)]);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int i = 0; i < sh.n_split; ++i) {
    const size_t pr = (p0 + i) * TG + row;
    const float m = ml[2 * pr];
    if (m <= NEG) continue;
    const float w = ex2(m - M);
    l += w * ml[2 * pr + 1];
    const float4 x = *reinterpret_cast<const float4*>(part + pr * sh.hd + col);
    a.x += w * x.x;
    a.y += w * x.y;
    a.z += w * x.z;
    a.w += w * x.w;
  }
  l = fmaxf(l, 1e-20f);
  const int tr = row / G, gq = row % G;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
      out + (((size_t)b * sh.Tq + tr) * sh.Hq + h * G + gq) * sh.hd + col);
  o[0] = __floats2bfloat162_rn(a.x / l, a.y / l);
  o[1] = __floats2bfloat162_rn(a.z / l, a.w / l);
}

// ---- float32: CUDA cores, split-KV ------------------------------------------

constexpr int F32_CHUNK = 16;        // split tiles whose slots are staged
constexpr int F32_STAGES = 2;        // K/V tiles in the shared-memory ring
constexpr int F32_MAX_WARPS = 12;    // warps of a CTA (8 query rows each)
constexpr size_t SMEM_MAX = 232448;  // shared memory a CTA may have

// One instantiation's geometry. KT: slots a K/V tile (64; 32 at hd 256).
// A warp holds 8 query rows: lane (rg, sg) = (lane / 16, lane % 16) owns
// rows rg + 2 e (e < 4), their scores at slots sg + 16 j (j < SPL) and
// their output columns 4 sg + 64 c ... + 3 (c < CPL / 4; 2 sg, 2 sg + 1
// at hd 32). Rows of Q, K and V lie STR = HD + 4 floats apart in shared
// memory: 16-byte aligned, and the 8 slots a quarter-warp reads in a
// k-step fall in distinct banks. Shared memory, in floats: F32_STAGES
// K/V stages (K then V, KT x STR each), the CTA's query rows (8 W x
// STR), a P tile a warp (KT slots x 8 rows), then as ints the chunk's
// slot positions (F32_CHUNK x KT) and live flags.
template <int HD, int KT>
struct F32Cfg {
  static constexpr int STR = HD + 4;
  static constexpr int SPL = KT / 16;
  static constexpr int CPL = HD / 16;
  static constexpr int STAGE = 2 * KT * STR;
  static constexpr int PW = KT * 8;
  static constexpr size_t bytes(int warps) {
    return 4 * (F32_STAGES * (size_t)STAGE + (size_t)warps * (8 * STR + PW) +
                (size_t)F32_CHUNK * (KT + 1));
  }
};

// The most warps a CTA of this geometry may have: what fits in shared
// memory, at most F32_MAX_WARPS (8 at hd 256, whose lanes hold 64
// accumulators).
template <int HD, int KT>
constexpr int f32_maxw() {
  int w = HD > 128 ? 8 : F32_MAX_WARPS;
  while (w > 1 && F32Cfg<HD, KT>::bytes(w) > SMEM_MAX) --w;
  return w;
}

// 16-byte copy into shared memory; zeros where !full (nothing is read).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Over the 16 lanes of a row group.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Grid (row blocks x Hkv x B, n_split) of 32 W threads: the CTAs of split
// 0, which own the most live tiles of a partly filled ring, start first.
// Split j owns the ring's tiles j, j + n_split, ...; a CTA holds 8 W query
// rows of one kv head (warp w: rows 8 w ... 8 w + 7). A row's arithmetic (dot products
// in head-dim order, the softmax's reductions over its 16-lane group, P.V
// in slot order) is the same in every CTA, whatever the other rows.
template <int HD, int KT>
__global__ void __launch_bounds__(f32_maxw<HD, KT>() * 32)
spec_verify_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ cpos,
                       const int* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ part, TcShape sh) {
  using L = F32Cfg<HD, KT>;
  constexpr int STR = L::STR, SPL = L::SPL, CPL = L::CPL;
  extern __shared__ __align__(16) float smem_f[];
  const int W = blockDim.x / 32, CR = 8 * W;
  float* kv_s = smem_f;
  float* q_s = kv_s + F32_STAGES * L::STAGE;
  float* p_s = q_s + CR * STR;
  int* cp_s = reinterpret_cast<int*>(p_s + W * L::PW);
  int* live_s = cp_s + F32_CHUNK * KT;

  const int G = sh.Hq / sh.Hkv, TG = sh.Tq * G;
  const int row_blocks = (TG + CR - 1) / CR;
  const int split = blockIdx.y;
  const int r0 = (blockIdx.x % row_blocks) * CR;
  const int h = (blockIdx.x / row_blocks) % sh.Hkv;
  const int b = blockIdx.x / row_blocks / sh.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 16, sg = lane % 16;
  const int n_tiles = (sh.S1 + KT - 1) / KT;
  const int nt = (n_tiles - split + sh.n_split - 1) / sh.n_split;  // tiles

  // ---- live tile (ring tile t) into stage st by 16-byte cp.async, zeros
  // past S+1
  auto issue = [&](int t, int st) {
    float* ks = kv_s + st * L::STAGE;
    for (int i = tid; i < KT * (HD / 4); i += blockDim.x) {
      const int j = i / (HD / 4), c = (i % (HD / 4)) * 4, s = t * KT + j;
      const bool ok = s < sh.S1;
      const size_t off =
          ok ? (((size_t)b * sh.S1 + s) * sh.Hkv + h) * HD + c : 0;
      cp16(ks + j * STR + c, k + off, ok);
      cp16(ks + (KT + j) * STR + c, v + off, ok);
    }
  };
  // ---- prologue. First the small loads (ahead of the bulk copies in the
  // memory system): the slot positions of the first chunk's tile this
  // warp tests (-1 past S+1) and the rows' positions
  int cpv[KT / 32];
#pragma unroll
  for (int j = 0; j < KT / 32; ++j) {
    const int s = (split + warp * sh.n_split) * KT + lane + 32 * j;
    cpv[j] = warp < nt && s < sh.S1 ? __ldg(cpos + (size_t)b * sh.S1 + s)
                                    : -1;
  }
  const int ra = r0 + 8 * warp + rg;  // the lane's rows: ra + 2 e
  const int r_end = min(r0 + CR, TG);
  int hi[4], qp[(8 * F32_MAX_WARPS + 31) / 32];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    hi[e] = ra + 2 * e < TG ? __ldg(pos + (size_t)b * sh.Tq + (ra + 2 * e) / G)
                            : -1;
#pragma unroll
  for (int i = 0; i < (8 * F32_MAX_WARPS + 31) / 32; ++i) {
    const int r = r0 + lane + 32 * i;
    qp[i] = r < r_end ? __ldg(pos + (size_t)b * sh.Tq + r / G) : 0;
  }

  // then one copy group: the CTA's query rows (zeros past T*G) and, ahead
  // of knowing whether any row sees it, the split's first tile (stage 0:
  // the first owned tile is live but for the shortest caches)
  for (int i = tid; i < CR * (HD / 4); i += blockDim.x) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, row = r0 + r;
    const bool ok = row < TG;
    cp16(q_s + r * STR + c,
         ok ? q + (((size_t)b * sh.Tq + row / G) * sh.Hq + h * G + row % G) *
                      HD + c
            : q,
         ok);
  }
  if (nt > 0) issue(split, 0);
  cp_commit();

  // the lane's rows see slot positions [lo, hi] (nothing past T*G); the
  // CTA's position range (each warp finds it)
  int lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    lo[e] = sh.window > 0 && ra + 2 * e < TG
                ? max(hi[e] - sh.window + 1, 0) : 0;
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < (8 * F32_MAX_WARPS + 31) / 32; ++i)
    if (r0 + lane + 32 * i < r_end) {
      qmin = min(qmin, qp[i]);
      qmax = max(qmax, qp[i]);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }

  const bool active = r0 + 8 * warp < TG;  // warp-uniform
  const float sl2 = sh.scale * LOG2E;
  const float inv_cap = sh.softcap > 0.f ? sh.scale / sh.softcap : 0.f;
  const float cap_l2 = sh.softcap * LOG2E;
  float acc[4][CPL];
  // running max (log2 units) and sum of the lane's rows
  float m[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    m[e] = NEG;
    l[e] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[e][i] = 0.f;
  }

  for (int k0 = 0; k0 < nt; k0 += F32_CHUNK) {
    const int nk = min(F32_CHUNK, nt - k0);
    // ---- the chunk's slot positions (-1 past S+1), a tile a warp. A
    // slot is live iff some row of the CTA sees it; a tile's live_s is
    // the count of its 16-slot blocks up to its last live slot (0: the
    // tile is dead). The blocks past it would add exact zeros: skipped
    for (int kk = warp; kk < nk; kk += W) {
      const int s0 = (split + (k0 + kk) * sh.n_split) * KT;
      int last = -1;
#pragma unroll
      for (int j = 0; j < KT / 32; ++j) {
        const int s = s0 + lane + 32 * j;
        const int cp = k0 == 0 && kk == warp ? cpv[j]
                       : s < sh.S1           ? __ldg(cpos + (size_t)b * sh.S1 + s)
                                             : -1;
        cp_s[kk * KT + lane + 32 * j] = cp;
        const unsigned vis = __ballot_sync(
            0xffffffffu, cp >= 0 && cp <= qmax &&
                             (sh.window <= 0 || cp > qmin - sh.window));
        if (vis) last = 32 * j + 31 - __clz(vis);
      }
      if (lane == 0) live_s[kk] = last < 0 ? 0 : last / 16 + 1;
    }
    __syncthreads();
    // the live tiles, lowest first: to issue (iss) and to compute (cmp)
    unsigned iss = __ballot_sync(0xffffffffu, lane < nk && live_s[lane]);
    unsigned cmp = iss;
    const int n = __popc(iss);
    auto pop = [](unsigned& mk) {
      const int t = __ffs(mk) - 1;
      mk &= mk - 1;
      return t;
    };
    const auto tile = [&](int kk) { return split + (k0 + kk) * sh.n_split; };
    // stage 0 gets the first live tile (already in flight if it is the
    // speculative one; else that copy lands before stage 0 is reused),
    // stage i the (i+1)-th: one copy group a tile, the next ones in
    // flight while a tile is computed
    if (k0 == 0 && (iss & 1u)) {
      pop(iss);
    } else {
      if (k0 == 0) cp_wait<0>();
      if (iss) issue(tile(pop(iss)), 0);
      cp_commit();
    }
#pragma unroll
    for (int st = 1; st < F32_STAGES; ++st) {
      if (iss) issue(tile(pop(iss)), st);
      cp_commit();
    }
    for (int it = 0; it < n; ++it) {
      cp_wait<F32_STAGES - 1>();
      __syncthreads();
      if (active) {
        const float* ks = kv_s + (it % F32_STAGES) * L::STAGE;
        const float* vs = ks + KT * STR;
        const int kk = pop(cmp);
        const int* cpt = cp_s + kk * KT;
        const int nb = live_s[kk];  // 16-slot blocks to compute
        // ---- S = Q K^T: a k-step is a float4 of each of the lane's 4
        // rows and SPL slots, 16 SPL fused multiply-adds
        float sc[4][SPL];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < SPL; ++j) sc[e][j] = 0.f;
        const float* qa = q_s + (8 * warp + rg) * STR;
        const float* kb = ks + sg * STR;
        // one k-step over the first NB 16-slot blocks
        const auto kstep = [&](int c, int NB) {
          float4 a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = lds4(qa + 2 * e * STR + c);
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            if (j >= NB) break;
            const float4 x = lds4(kb + 16 * j * STR + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[e][j] = fmaf(a[e].x, x.x, sc[e][j]);
              sc[e][j] = fmaf(a[e].y, x.y, sc[e][j]);
              sc[e][j] = fmaf(a[e].z, x.z, sc[e][j]);
              sc[e][j] = fmaf(a[e].w, x.w, sc[e][j]);
            }
          }
        };
        if (nb == SPL) {  // a whole tile: unrolled, no test
#pragma unroll
          for (int c = 0; c < HD; c += 4) kstep(c, SPL);
        } else {
#pragma unroll 2
          for (int c = 0; c < HD; c += 4) kstep(c, nb);
        }
        // ---- online softmax in registers, base 2; a row's max and sum
        // over its 16 lanes by shuffles. A row with nothing visible yet
        // keeps an empty state (reference point 0: ex2(-1e30) = 0); a
        // tile a row cannot see leaves its state bit for bit as it was
        float al[4];
        bool one = true;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float mx = NEG;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int cp = cpt[sg + 16 * j];
            const float s = sh.softcap > 0.f
                                ? tanhf(sc[e][j] * inv_cap) * cap_l2
                                : sc[e][j] * sl2;
            sc[e][j] = cp >= lo[e] && cp <= hi[e] ? s : NEG;
            mx = fmaxf(mx, sc[e][j]);
          }
          const float mn = fmaxf(m[e], max16(mx));
          const float ref = mn > NEG ? mn : 0.f;
          al[e] = ex2(m[e] - ref);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            sc[e][j] = ex2(sc[e][j] - ref);
            sum += sc[e][j];
          }
          l[e] = al[e] * l[e] + sum16(sum);
          m[e] = mn;
          one = one && al[e] == 1.f;
        }
        // a rescale by exactly 1 changes nothing: skipped
        if (!__all_sync(0xffffffffu, one)) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < CPL; ++i) acc[e][i] *= al[e];
        }
        // ---- acc += P V: P through the warp's own tile (slot-major, a
        // float4 of the lane's 4 rows), V in float4 (float2 at hd 32) of
        // the lane's columns a k-step
        float* pw = p_s + warp * L::PW + 4 * rg;
#pragma unroll
        for (int j = 0; j < SPL; ++j)
          *reinterpret_cast<float4*>(pw + (sg + 16 * j) * 8) =
              make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        __syncwarp();
#pragma unroll 4
        for (int s = 0; s < 16 * nb; ++s) {
          const float4 p4 = lds4(pw + s * 8);
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
          const float* vr = vs + s * STR;
          float x[CPL];
          if constexpr (CPL == 2) {
            const float2 t = *reinterpret_cast<const float2*>(vr + 2 * sg);
            x[0] = t.x;
            x[1] = t.y;
          } else {
#pragma unroll
            for (int i = 0; i < CPL / 4; ++i) {
              const float4 t = lds4(vr + 4 * sg + 64 * i);
              x[4 * i] = t.x;
              x[4 * i + 1] = t.y;
              x[4 * i + 2] = t.z;
              x[4 * i + 3] = t.w;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < CPL; ++i)
              acc[e][i] = fmaf(p[e], x[i], acc[e][i]);
        }
      }
      __syncthreads();  // the stage is free
      if (iss) issue(tile(pop(iss)), it % F32_STAGES);
      cp_commit();
    }
  }
  cp_wait<0>();

  // the combine grid may start launching (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // ---- epilogue: the output (one split) or this split's partial, m in
  // log2 units; an empty partial (m = -1e30, l = 0) writes no acc ----
  if (!active) return;
  const size_t n_part_rows = (size_t)gridDim.x / row_blocks * sh.n_split * TG;
  const int col0 = CPL == 2 ? 2 * sg : 4 * sg;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = ra + 2 * e;
    if (row >= TG) continue;
    const size_t pr =
        (((size_t)b * sh.Hkv + h) * sh.n_split + split) * TG + row;
    const bool whole = sh.n_split == 1;
    if (!whole && m[e] <= NEG) {
      if (sg == 0) {
        part[n_part_rows * HD + 2 * pr] = m[e];
        part[n_part_rows * HD + 2 * pr + 1] = l[e];
      }
      continue;
    }
    const float lc = whole ? fmaxf(l[e], 1e-20f) : 1.f;
    float* orow = whole ? out + (((size_t)b * sh.Tq + row / G) * sh.Hq +
                                 h * G + row % G) * HD + col0
                        : part + pr * HD + col0;
    if constexpr (CPL == 2) {
      *reinterpret_cast<float2*>(orow) =
          whole ? make_float2(acc[e][0] / lc, acc[e][1] / lc)
                : make_float2(acc[e][0], acc[e][1]);
    } else {
#pragma unroll
      for (int i = 0; i < CPL / 4; ++i)
        *reinterpret_cast<float4*>(orow + 64 * i) =
            whole ? make_float4(acc[e][4 * i] / lc, acc[e][4 * i + 1] / lc,
                                acc[e][4 * i + 2] / lc,
                                acc[e][4 * i + 3] / lc)
                  : make_float4(acc[e][4 * i], acc[e][4 * i + 1],
                                acc[e][4 * i + 2], acc[e][4 * i + 3]);
    }
    if (!whole && sg == 0) {
      part[n_part_rows * HD + 2 * pr] = m[e];
      part[n_part_rows * HD + 2 * pr + 1] = l[e];
    }
  }
}

// The float32 kernel's merge, into float32: as spec_verify_combine_kernel
// (the same sums in split order), with a thread's loads of F32_MERGE
// partials issued before their use. Launched as the main grid's
// programmatic dependent: its launch overlaps that grid's tail, and
// griddepcontrol.wait holds it until the partials are written.
constexpr int F32_MERGE = 8;

__global__ void __launch_bounds__(CB_THREADS)
spec_verify_f32_combine_kernel(const float* __restrict__ part,
                               float* __restrict__ out, TcShape sh,
                               int n_rows) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = sh.Hq / sh.Hkv, TG = sh.Tq * G;
  const int tpr = sh.hd / 4;
  const int r = blockIdx.x * (CB_THREADS / tpr) + threadIdx.x / tpr;
  if (r >= n_rows) return;
  const int col = (threadIdx.x % tpr) * 4;
  const int row = r % TG, bh = r / TG;
  const int h = bh % sh.Hkv, b = bh / sh.Hkv;
  const size_t p0 = (size_t)bh * sh.n_split * TG + row;  // split 0's row
  const float2* ml = reinterpret_cast<const float2*>(
      part + (size_t)n_rows * sh.n_split * sh.hd);
  // the first F32_MERGE partials' loads all at once; M over every m_i
  float2 mi[F32_MERGE];
  float4 x[F32_MERGE];
  const auto load = [&](int i0) {
#pragma unroll
    for (int i = 0; i < F32_MERGE; ++i) {
      if (i0 + i >= sh.n_split) break;
      const size_t pr = p0 + (size_t)(i0 + i) * TG;
      mi[i] = ml[pr];
      x[i] = *reinterpret_cast<const float4*>(part + pr * sh.hd + col);
    }
  };
  load(0);
  float M = NEG;
#pragma unroll
  for (int i = 0; i < F32_MERGE; ++i)
    if (i < sh.n_split) M = fmaxf(M, mi[i].x);
  for (int i = F32_MERGE; i < sh.n_split; ++i)
    M = fmaxf(M, ml[p0 + (size_t)i * TG].x);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int i0 = 0; i0 < sh.n_split; i0 += F32_MERGE) {
    if (i0 > 0) load(i0);
#pragma unroll
    for (int i = 0; i < F32_MERGE; ++i) {
      if (i0 + i >= sh.n_split) break;
      if (mi[i].x <= NEG) continue;  // empty: its acc not read
      const float w = ex2(mi[i].x - M);
      l += w * mi[i].y;
      a.x += w * x[i].x;
      a.y += w * x[i].y;
      a.z += w * x[i].z;
      a.w += w * x[i].w;
    }
  }
  l = fmaxf(l, 1e-20f);
  *reinterpret_cast<float4*>(
      out + (((size_t)b * sh.Tq + row / G) * sh.Hq + h * G + row % G) *
                sh.hd + col) = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
}

// ---- host side of the bfloat16 kernel ---------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// An error of cuTensorMapEncodeTiled is returned as ENCODE_ERROR + CUresult.
constexpr int ENCODE_ERROR = 10000;

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The (B, S+1, Hkv, hd) cache as a 4-d tensor map whose box is 64 head-dim
// columns (128 bytes, 128-byte swizzle) x kt slots of one (batch, kv
// head). Columns past hd and slots past S+1 read as zeros.
int kv_map(CUtensorMap* map, const void* ptr, int B, int S1, int Hkv, int hd,
           int kt) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)Hkv, (cuuint64_t)S1,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)Hkv * hd * 2,
                                 (cuuint64_t)S1 * Hkv * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kt, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int HDP, int KT, int NWG>
int launch_tc(const void* q, const void* k, const void* v, const void* cpos,
              const void* pos, void* out, void* part, int B,
              const TcShape& sh, void* stream) {
  using L = TcCfg<HDP, KT, NWG>;
  const auto kernel = spec_verify_tc_kernel<HDP, KT, NWG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes());
  if (e != cudaSuccess) return (int)e;
  CUtensorMap kmap, vmap;
  int r = kv_map(&kmap, k, B, sh.S1, sh.Hkv, sh.hd, KT);
  if (r == 0) r = kv_map(&vmap, v, B, sh.S1, sh.Hkv, sh.hd, KT);
  if (r != 0) return r;
  const int TG = sh.Tq * (sh.Hq / sh.Hkv);
  const dim3 grid(((TG + L::ROWS - 1) / L::ROWS) * sh.n_split, sh.Hkv, B);
  kernel<<<grid, L::THREADS, L::bytes(), (cudaStream_t)stream>>>(
      kmap, vmap, (const __nv_bfloat16*)q, (const int*)cpos, (const int*)pos,
      (__nv_bfloat16*)out, (float*)part, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess || sh.n_split == 1) return (int)e;
  const int n_rows = B * sh.Hkv * TG;
  const int rows_per_block = CB_THREADS / (sh.hd / 4);
  spec_verify_combine_kernel<<<(n_rows + rows_per_block - 1) / rows_per_block,
                               CB_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (__nv_bfloat16*)out, sh, n_rows);
  return (int)cudaGetLastError();
}

int f32_max_warps(int hd) {
  return hd == 256   ? f32_maxw<256, 32>()
         : hd == 128 ? f32_maxw<128, 64>()
         : hd == 64  ? f32_maxw<64, 64>()
                     : f32_maxw<32, 64>();
}

template <int HD, int KT>
int launch_f32(const void* q, const void* k, const void* v, const void* cpos,
               const void* pos, void* out, void* part, int B,
               const TcShape& sh, int warps, int row_blocks, void* stream) {
  const auto kernel = spec_verify_f32_kernel<HD, KT>;
  const size_t smem = F32Cfg<HD, KT>::bytes(warps);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(row_blocks * sh.Hkv * B, sh.n_split);
  kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)cpos,
      (const int*)pos, (float*)out, (float*)part, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess || sh.n_split == 1) return (int)e;
  const int n_rows = B * sh.Hkv * sh.Tq * (sh.Hq / sh.Hkv);
  const int rows_per_block = CB_THREADS / (HD / 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows + rows_per_block - 1) / rows_per_block);
  cfg.blockDim = dim3(CB_THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, spec_verify_f32_combine_kernel,
                                 (const float*)part, (float*)out, sh,
                                 n_rows);
}

}  // namespace

// tile, n_split and tiles_per_split are the plan of
// kernels/spec_verify/ops.py:f32_split_plan (fixed by S+1, hd and the SM
// count); warps (8 query rows each) and row_blocks cut a kv head's T*G
// rows into CTAs; part as for the bfloat16 entry.
extern "C" int spec_verify_attention_f32(
    const void* q, const void* k, const void* v, const void* cpos,
    const void* pos, void* out, void* part, int B, int Tq, int Hq, int Hkv,
    int S1, int hd, int window, float softcap, float scale, int tile,
    int n_split, int tiles_per_split, int warps, int row_blocks,
    void* stream) {
  const TcShape sh{Tq, Hq, Hkv, S1, hd, window, softcap, scale, n_split};
  const int kt = hd > 128 ? 32 : 64;
  const int n_tiles = (S1 + kt - 1) / kt;
  const long long TG = (long long)Tq * (Hq / Hkv), rows = 8LL * warps;
  if (tile != kt || n_split < 1 || n_split > (n_tiles > 1 ? n_tiles : 1) ||
      tiles_per_split != (n_tiles + n_split - 1) / n_split || warps < 1 ||
      warps > f32_max_warps(hd) || row_blocks < 1 ||
      row_blocks * rows < TG || (row_blocks - 1) * rows >= TG ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hd == 256)
    return launch_f32<256, 32>(q, k, v, cpos, pos, out, part, B, sh, warps,
                               row_blocks, stream);
  if (hd == 128)
    return launch_f32<128, 64>(q, k, v, cpos, pos, out, part, B, sh, warps,
                               row_blocks, stream);
  if (hd == 64)
    return launch_f32<64, 64>(q, k, v, cpos, pos, out, part, B, sh, warps,
                              row_blocks, stream);
  if (hd == 32)
    return launch_f32<32, 64>(q, k, v, cpos, pos, out, part, B, sh, warps,
                              row_blocks, stream);
  return (int)cudaErrorInvalidValue;
}

// tile, n_split and tiles_per_split are the plan of
// kernels/spec_verify/ops.py:split_plan; part holds n_split > 1 partials:
// B*Hkv*n_split*T*G rows of hd floats, then their (m, l) pairs.
extern "C" int spec_verify_attention_bf16(
    const void* q, const void* k, const void* v, const void* cpos,
    const void* pos, void* out, void* part, int B, int Tq, int Hq, int Hkv,
    int S1, int hd, int window, float softcap, float scale, int tile,
    int n_split, int tiles_per_split, void* stream) {
  const TcShape sh{Tq, Hq, Hkv, S1, hd, window, softcap, scale, n_split};
  const int kt = hd > 128 ? 32 : 64;
  const int n_tiles = (S1 + kt - 1) / kt;
  if (tile != kt || n_split < 1 || n_split > n_tiles ||
      tiles_per_split != (n_tiles + n_split - 1) / n_split ||
      tiles_per_split * kt > CPCAP || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hd == 256)
    return launch_tc<256, 32, 1>(q, k, v, cpos, pos, out, part, B, sh,
                                 stream);
  if (hd == 128)
    return launch_tc<128, 64, 2>(q, k, v, cpos, pos, out, part, B, sh,
                                 stream);
  if (hd == 64 || hd == 32)
    return launch_tc<64, 64, 2>(q, k, v, cpos, pos, out, part, B, sh,
                                stream);
  return (int)cudaErrorInvalidValue;
}
