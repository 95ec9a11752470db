// Memory-bounded causal flash attention for long full-sequence forwards
// (training and long prefills): forward and backward kernels for sm_90a,
// plain C entries loaded with ctypes (kernels/flash/ops.py).
//
// Replaces: no pallas_call. The JAX package writes it as a jax.custom_vjp
// over nested jax.lax.scans (src/repro/models/layers.py:201 _flash, its
// forward at :215 and backward at :270), reached from _flash_attn_train
// for every causal full-sequence forward of T >= 2048 tokens. The port
// ran it as Python loops of einsums over 512 x 1024 float32 tiles. Plain
// versions: kernels/flash/ref.py (flash_fwd_ref, flash_bwd_ref).
//
// What is computed, per (b, kv head h, query head g of h's G): q rows
// (Sq) against k/v rows (Sk); a (q, k) pair is visible when kpos <= qpos,
// kval > 0 and, for window > 0, kpos > qpos - window (positions are
// arbitrary floats: left pads at -1, chunk pads at -1e30). Scores are
// float32 q.k times 1/sqrt(hd), masked ones -1e30; an online softmax with
// the reference's guards (m_safe = 0 where the running max is -1e30,
// alpha 0 from an empty running max); P rounded to v's dtype before P.V;
// out = acc / max(l, 1e-20), lse = m + log(max(l, 1e-20)). The backward
// recomputes P = exp(s - lse) (0 where masked): dV = P^T dO, dP = dO V^T,
// dS = P (dP - D) scale with D = rowsum(dO o O), dQ = dS K, dK = dS^T Q.
//
// Bound: operations. A visible pair costs 4 hd operations forward (q.k
// and p.v) and 10 hd backward (q.k, dO.v, p dO, dS K, dS^T Q) while the
// bytes are O(S hd): at S 2,304 and hd 128 a (b, head) does ~1,000
// operations a byte it must move, far past the 295 where the tensor cores
// and not the memory bound a bf16 kernel.
//
// Design. Every product runs on the tensor cores through mma.sync: bf16
// as m16n8k16 with ldmatrix fragments; float32 as a split 3xTF32 product
// (m16n8k8: x = big + small, each TF32, and big*big + big*small +
// small*big accumulated in float32), which keeps ~float32 accuracy (the
// plain TF32 product's three digits would not hold the float32
// tolerance); the tensor cores' float32 accumulate rounds toward zero, so
// in float32 dK and dV (sums over G x Sq queries) take each step's
// product in a zeroed fragment and add it to the sum by round-to-nearest
// adds (accumulate). A warp owns 16 rows of a tile; S and P stay in its
// registers (the C fragment of S.P is the A fragment of P.V, so P never
// leaves the registers; float32 reorders the product's k index to match,
// see mm_rn). K/V tiles (64 rows, 32 at hd 256) come by 16-byte cp.async
// into a two-stage ring (one stage where float32 at hd 256 would pass
// the 227 KB of shared memory); rows are padded by 16 bytes so that
// ldmatrix and the float32 fragment loads meet no bank conflict.
//
// Tile skipping, exact: a pre-pass (flash_prep_kernel) writes the (min,
// max) of qpos over each 32 query rows and of kpos over each 32 keys with
// kval > 0. A (q tile, k tile) pair is live when kmin <= qmax and, with a
// window, kmax > qmin - window (tile_live; flash_tile_live in ops.py is
// the same predicate): a visible pair implies both, so a dead tile holds
// none and contributes nothing (alpha = 1, p = 0). A warp tests 32 tiles
// at once (a lane each, one ballot), so the loops visit live tiles only:
// for a causal sequence without pads, the triangle, half the square.
//
// Forward (flash_fwd_kernel): a CTA of 4 warps owns 64 query rows of one
// (b, h, g); the grid runs the latest query tiles (the most keys) first,
// and a kv head's G query heads side by side, so their CTAs read the
// same K/V tiles from L2 (the reuse across G).
//
// Backward, deterministic (no atomics; bit-identical run to run): the
// pre-pass also forms D a warp a row. flash_bwd_dkdv_kernel: a CTA owns
// 64 keys of one (b, h) and a group of its G query heads, 16 keys a warp
// (at hd 256, and at float32 hd 128, two warps a row group, each half of
// dK/dV's columns, recomputing S^T and dP^T alike), and walks the group's
// heads and their live 32-row query tiles in a fixed order, computing
// S^T = K Q^T and dP^T = V dO^T with keys as rows, so dK and dV
// accumulate in registers and are written once. With one group (G 1, or
// enough CTAs without a split: kernels/flash/ops.py dkdv_parts) they are
// dK and dV; with several, float32 partials that flash_sum_kernel adds in
// group order. Without the split the earliest key tile walked all G
// heads' queries alone: at 8a's shape 432 steps against ~240 a CTA slot
// of balanced work, at phase 9's (G 16, one CTA an SM) 1,024.
// flash_bwd_dq_kernel: the forward's layout, walking the live key tiles
// of its 64 query rows to accumulate dQ = dS K; it recomputes S and dP (7
// products a pair where an atomic dQ would take 5): the price of a fixed
// summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e30f;
constexpr int kRange = 32;  // query rows / keys a tile-range entry covers
constexpr int kWarp = 32;

struct Args {
  const void* q;  // (B, Sq, Hkv, G, hd)
  const void* k;  // (B, Sk, Hkv, hd)
  const void* v;
  const float* qpos;  // (B, Sq)
  const float* kpos;  // (B, Sk)
  const float* kval;  // (B, Sk)
  float2* qr;         // (B, nqr): (min, max) of qpos over each 32 rows
  float2* kr;         // (B, nkr): (min, max) of kpos over each 32 valid keys
  void* out;          // like q
  float* lse;         // (B, Hkv, G, Sq)
  const void* dout;   // like q (backward)
  float* D;           // (B, Hkv, G, Sq) (backward)
  void* dq;
  void* dk;
  void* dv;
  float* part;  // (2, parts, B, Sk, Hkv, hd) dK, dV partials (parts > 1)
  int B, Sq, Sk, Hkv, G, nqr, nkr, window, parts;
  float scale;
};

// ---- element types -------------------------------------------------------

template <typename T>
struct Elt;
template <>
struct Elt<bf16> {
  static constexpr int kPad = 8;  // 16 bytes a row
  static __device__ __forceinline__ float f(bf16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Elt<float> {
  static constexpr int kPad = 4;
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// ---- copies --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, zero-filled where !ok (src must still be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x HD elements from global rows (stride ld_g elements) into shared
// rows of LD elements; rows at or past n_valid are zero-filled
template <typename T, int HD, int LD, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows,
                                          long ld_g, int row0, int n_valid,
                                          int tid) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int PER = HD / CH;
  for (int i = tid; i < rows * PER; i += NT) {
    const int r = i / PER, c = (i % PER) * CH;
    const bool ok = row0 + r < n_valid;
    cp16(dst + r * LD + c, src + (ok ? (long)(row0 + r) * ld_g : 0) + c, ok);
  }
}

// n floats from src[row0 ..] (zero past n_valid)
template <int NT>
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n, int row0, int n_valid,
                                            int tid) {
  for (int i = tid; i < n; i += NT) {
    const bool ok = row0 + i < n_valid;
    cp4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// ---- warp products -------------------------------------------------------
//
// C fragment (16 x 8, float32), lane = 4 gr + tq: c[0], c[1] at row gr,
// columns 2 tq, 2 tq + 1; c[2], c[3] at row gr + 8.
//
// mm_nt: C[16 x 8 NT] += A[16 x K] B[8 NT x K]^T, A's and B's rows in
// shared memory (LD elements apart), K contiguous.
// mm_rn: C[16 x 8 NT] += P[16 x 8 KT] B[8 KT x 8 NT], P in registers as
// KT C fragments, B's rows (k) in shared memory.

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT, int K>
__device__ __forceinline__ void mm_nt(float (&c)[NT][4], const bf16* sA,
                                      const bf16* sB, int ld, int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "bf16 tile shape");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, sA + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t b[4];
      ldsm4(b, sB + (n * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                   kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(c[2 * n], a, b[0], b[1]);
      mma16816(c[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// P is rounded to bf16 here (the reference's p.to(v.dtype))
template <int KT, int NT>
__device__ __forceinline__ void mm_rn(float (&c)[NT][4], const float (&p)[KT][4],
                                      const bf16* sB, int ld, int lane) {
  static_assert(KT % 2 == 0 && NT % 2 == 0, "bf16 tile shape");
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t b[4];
      ldsm4t(b, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                    n * 16 + (lane >> 4) * 8);
      mma16816(c[2 * n], a, b[0], b[1]);
      mma16816(c[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// float32: split 3xTF32 on m16n8k8 (A: a0 (gr, tq), a1 (gr + 8, tq), a2
// (gr, tq + 4), a3 (gr + 8, tq + 4); B: b0 (k tq, n gr), b1 (k tq + 4))

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  big = r & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x - __uint_as_float(big)));
  small = r & 0xffffe000u;
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with a = ab + as, b = bb + bs: the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma1688(c, as, bb0, bb1);
  mma1688(c, ab, bs0, bs1);
  mma1688(c, ab, bb0, bb1);
}

template <int NT, int K>
__device__ __forceinline__ void mm_nt(float (&c)[NT][4], const float* sA,
                                      const float* sB, int ld, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < K / 8; ++kk) {
    const float* a = sA + kk * 8 + tq;
    uint32_t ab[4], as[4];
    split_tf32(a[gr * ld], ab[0], as[0]);
    split_tf32(a[(gr + 8) * ld], ab[1], as[1]);
    split_tf32(a[gr * ld + 4], ab[2], as[2]);
    split_tf32(a[(gr + 8) * ld + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = sB + (n * 8 + gr) * ld + kk * 8 + tq;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b[0], bb0, bs0);
      split_tf32(b[4], bb1, bs1);
      mma3(c[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// The k index of each m16n8k8 step is permuted so that P's C fragment is
// its A fragment as it stands: logical k tq is key 2 tq of the 8, k tq + 4
// is key 2 tq + 1; B's rows are read in the same order.
template <int KT, int NT>
__device__ __forceinline__ void mm_rn(float (&c)[NT][4], const float (&p)[KT][4],
                                      const float* sB, int ld, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);
    split_tf32(p[kk][2], ab[1], as[1]);
    split_tf32(p[kk][1], ab[2], as[2]);
    split_tf32(p[kk][3], ab[3], as[3]);
    const float* b = sB + (kk * 8 + 2 * tq) * ld + gr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b[n * 8], bb0, bs0);
      split_tf32(b[ld + n * 8], bb1, bs1);
      mma3(c[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// c += P B over many steps. The tensor cores' float32 accumulate rounds
// toward zero, a bias that grows with the number of products summed into
// one fragment: dK and dV sum G x Sq queries, where it passed the float32
// tolerance at 8a's shape. In float32 a step's product goes into a zeroed
// fragment and is added to c with round-to-nearest adds.
template <int KT, int NT>
__device__ __forceinline__ void accumulate(float (&c)[NT][4],
                                           const float (&p)[KT][4],
                                           const bf16* sB, int ld, int lane) {
  mm_rn<KT, NT>(c, p, sB, ld, lane);
}

template <int KT, int NT>
__device__ __forceinline__ void accumulate(float (&c)[NT][4],
                                           const float (&p)[KT][4],
                                           const float* sB, int ld, int lane) {
  float t[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
  mm_rn<KT, NT>(t, p, sB, ld, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += t[n][e];
}

// ---- tile ranges and the skip test ---------------------------------------

// (min, max) over range entries [first, first + count) that exist
__device__ __forceinline__ float2 range_of(const float2* r, int n, int first,
                                           int count) {
  float lo = inf_f(), hi = -inf_f();
  for (int i = 0; i < count; ++i) {
    if (first + i < n) {
      const float2 e = r[first + i];
      lo = fminf(lo, e.x);
      hi = fmaxf(hi, e.y);
    }
  }
  return make_float2(lo, hi);
}

// a (q tile, k tile) pair holds a visible pair only if this holds
// (kernels/flash/ops.py flash_tile_live)
__device__ __forceinline__ bool tile_live(float2 q, float2 k, int window) {
  return k.x <= q.y && (window <= 0 || k.y > q.x - (float)window);
}

// The first tile after j (of n, each `per` range entries of r) live
// against `other`; n if none. Every lane of the warp gets the same answer.
__device__ __forceinline__ int next_live(const float2* r, int nr, int n,
                                         int per, float2 other, bool other_is_q,
                                         int window, int j, int lane) {
  for (int base = j + 1; base < n; base += kWarp) {
    const int jj = base + lane;
    bool live = false;
    if (jj < n) {
      const float2 t = range_of(r, nr, jj * per, per);
      live = other_is_q ? tile_live(other, t, window)
                        : tile_live(t, other, window);
    }
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (m) return base + __ffs(m) - 1;
  }
  return n;
}

__device__ __forceinline__ bool visible(float kp, float kv, float qp,
                                        int window) {
  return kp <= qp && kv > 0.f && (window <= 0 || kp > qp - (float)window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- launch plans (read out by the flash_plan export below) ------------

constexpr int kBM = 64;   // query rows a CTA (forward, dQ)
constexpr int kBNB = 64;  // keys a CTA (dK/dV)
constexpr int kBMQ = 32;  // query rows a step of the dK/dV walk

template <typename T, int HD>
struct Plan {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int LD = HD + Elt<T>::kPad;
  static constexpr int BN = HD == 256 ? 32 : 64;  // keys a step (fwd, dQ)
  static constexpr int FWD_ST = 2;
  static constexpr int DQ_ST = (kF32 && HD == 256) ? 1 : 2;
  // dK/dV column halves: at hd 256, and at float32 hd 128 for the
  // registers of a step's fragment (see flash_bwd_dkdv_kernel)
  static constexpr int NC = (HD == 256 || (kF32 && HD == 128)) ? 2 : 1;
  static constexpr int KV_ST = (kF32 && HD == 256) ? 1 : 2;
  static constexpr int FWD_SMEM =
      (kBM * LD + 2 * FWD_ST * BN * LD) * (int)sizeof(T) + 2 * FWD_ST * BN * 4;
  static constexpr int DQ_SMEM =
      (2 * kBM * LD + 2 * DQ_ST * BN * LD) * (int)sizeof(T) +
      2 * DQ_ST * BN * 4;
  static constexpr int KV_SMEM =
      (2 * kBNB * LD + 2 * KV_ST * kBMQ * LD) * (int)sizeof(T) +
      3 * KV_ST * kBMQ * 4;
  static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448 &&
                    KV_SMEM <= 232448,
                "shared memory past the 227 KB a CTA can have");
};

// ---- pre-pass: tile ranges, and D = rowsum(dO o O) -----------------------

template <typename T>
__global__ void flash_prep_kernel(const Args a, int hd, int range_warps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp < range_warps) {
    const int n = max(a.nqr, a.nkr);
    const int b = warp / n, i = warp % n, s = i * kRange + lane;
    if (i < a.nqr) {
      const bool ok = s < a.Sq;
      const float x = ok ? a.qpos[(long)b * a.Sq + s] : 0.f;
      float lo = ok ? x : inf_f(), hi = ok ? x : -inf_f();
      for (int o = 16; o; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) a.qr[(long)b * a.nqr + i] = make_float2(lo, hi);
    }
    if (i < a.nkr) {
      const bool in = s < a.Sk;
      const bool ok = in && a.kval[(long)b * a.Sk + s] > 0.f;
      const float x = in ? a.kpos[(long)b * a.Sk + s] : 0.f;
      float lo = ok ? x : inf_f(), hi = ok ? x : -inf_f();
      for (int o = 16; o; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) a.kr[(long)b * a.nkr + i] = make_float2(lo, hi);
    }
    return;
  }
  if (a.D == nullptr) return;
  // one row (b, s, h, g) of q's layout a warp, summed in a fixed order
  const long row = warp - range_warps;
  const long rows = (long)a.B * a.Sq * a.Hkv * a.G;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.out) + row * hd;
  const T* d = static_cast<const T*>(a.dout) + row * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += kWarp)
    acc += Elt<T>::f(o[c]) * Elt<T>::f(d[c]);
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int g = row % a.G, h = (row / a.G) % a.Hkv;
    const long bs = row / ((long)a.G * a.Hkv);
    const int s = bs % a.Sq, b = bs / a.Sq;
    a.D[(((long)b * a.Hkv + h) * a.G + g) * a.Sq + s] = acc;
  }
}

// the CTA's (b, h, g, query tile) in the forward's and dQ's grid: the
// latest query tiles first, a kv head's G query heads side by side
struct QTile {
  int b, h, g, qt;
};

__device__ __forceinline__ QTile q_tile(const Args& a) {
  const int nqt = (a.Sq + kBM - 1) / kBM;
  const int heads = a.B * a.Hkv * a.G;
  const int id = blockIdx.x;
  QTile t;
  t.qt = nqt - 1 - id / heads;
  const int hid = id % heads;
  t.g = hid % a.G;
  t.h = (hid / a.G) % a.Hkv;
  t.b = hid / (a.G * a.Hkv);
  return t;
}

// ---- forward -------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(128) flash_fwd_kernel(const Args a) {
  using P = Plan<T, HD>;
  constexpr int LD = P::LD, BN = P::BN, ST = P::FWD_ST, NT = BN / 8,
                OT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBM * LD;
  T* sV = sK + ST * BN * LD;
  float* sKp = reinterpret_cast<float*>(sV + ST * BN * LD);
  float* sKv = sKp + ST * BN;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int gr = lane >> 2, tq = lane & 3;
  const QTile c = q_tile(a);
  const int q0 = c.qt * kBM;
  const long qld = (long)a.Hkv * a.G * HD, kld = (long)a.Hkv * HD;
  const T* qb = static_cast<const T*>(a.q) +
                (long)c.b * a.Sq * qld + (long)(c.h * a.G + c.g) * HD;
  const T* kb = static_cast<const T*>(a.k) + (long)c.b * a.Sk * kld +
                (long)c.h * HD;
  const T* vb = static_cast<const T*>(a.v) + (long)c.b * a.Sk * kld +
                (long)c.h * HD;
  const float* kpb = a.kpos + (long)c.b * a.Sk;
  const float* kvb = a.kval + (long)c.b * a.Sk;
  const float2* krb = a.kr + (long)c.b * a.nkr;
  const int nkt = (a.Sk + BN - 1) / BN;
  const float2 qrng =
      range_of(a.qr + (long)c.b * a.nqr, a.nqr, q0 / kRange, kBM / kRange);

  copy_rows<T, HD, LD, 128>(sQ, qb, kBM, qld, q0, a.Sq, tid);
  cp_commit();
  auto load_kv = [&](int j, int st) {
    copy_rows<T, HD, LD, 128>(sK + st * BN * LD, kb, BN, kld, j * BN, a.Sk,
                              tid);
    copy_rows<T, HD, LD, 128>(sV + st * BN * LD, vb, BN, kld, j * BN, a.Sk,
                              tid);
    copy_floats<128>(sKp + st * BN, kpb, BN, j * BN, a.Sk, tid);
    copy_floats<128>(sKv + st * BN, kvb, BN, j * BN, a.Sk, tid);
  };

  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  const float qp0 = q0 + r0 < a.Sq ? a.qpos[(long)c.b * a.Sq + q0 + r0] : kNeg;
  const float qp1 = q0 + r1 < a.Sq ? a.qpos[(long)c.b * a.Sq + q0 + r1] : kNeg;
  const int per = BN / kRange;

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  int j = next_live(krb, a.nkr, nkt, per, qrng, true, a.window, -1, lane);
  if (j < nkt) load_kv(j, 0);
  cp_commit();
  for (int it = 0; j < nkt; ++it) {
    const int jn =
        next_live(krb, a.nkr, nkt, per, qrng, true, a.window, j, lane);
    const int st = it % ST;
    if (ST == 2) {
      if (jn < nkt) load_kv(jn, (it + 1) % 2);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mm_nt<NT, HD>(s, sQ + warp * 16 * LD, sK + st * BN * LD, LD, lane);

    const float* kp = sKp + st * BN;
    const float* kv = sKv + st * BN;
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tq + e;
        const float kpv = kp[col], kvv = kv[col];
        s[n][e] = visible(kpv, kvv, qp0, a.window) ? s[n][e] * a.scale : kNeg;
        s[n][2 + e] =
            visible(kpv, kvv, qp1, a.window) ? s[n][2 + e] * a.scale : kNeg;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 <= kNeg ? 0.f : mn0, ms1 = mn1 <= kNeg ? 0.f : mn1;
    const float al0 = m0 <= kNeg ? 0.f : __expf(m0 - ms0);
    const float al1 = m1 <= kNeg ? 0.f : __expf(m1 - ms1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = __expf(s[n][e] - ms0);
        s[n][2 + e] = __expf(s[n][2 + e] - ms1);
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    m0 = mn0;
    m1 = mn1;
    mm_rn<NT, OT>(o, s, sV + st * BN * LD, LD, lane);
    __syncthreads();
    if (ST == 1 && jn < nkt) {
      load_kv(jn, 0);
      cp_commit();
    }
    j = jn;
  }
  cp_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  T* ob = static_cast<T*>(a.out) + (long)c.b * a.Sq * qld +
          (long)(c.h * a.G + c.g) * HD;
  float* lb = a.lse + (((long)c.b * a.Hkv + c.h) * a.G + c.g) * a.Sq;
  if (q0 + r0 < a.Sq) {
    T* row = ob + (long)(q0 + r0) * qld + 2 * tq;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      Elt<T>::store2(row + n * 8, o[n][0] / d0, o[n][1] / d0);
    if (tq == 0) lb[q0 + r0] = m0 + logf(d0);
  }
  if (q0 + r1 < a.Sq) {
    T* row = ob + (long)(q0 + r1) * qld + 2 * tq;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      Elt<T>::store2(row + n * 8, o[n][2] / d1, o[n][3] / d1);
    if (tq == 0) lb[q0 + r1] = m1 + logf(d1);
  }
}

// ---- backward: dK and dV -------------------------------------------------

// a warp's rows r0 and r1 of a 16-row group (the C fragment's), DT column
// blocks of 8 (2 a lane), from row k0 of a global array of rows ld apart
template <typename T, int DT>
__device__ __forceinline__ void store_rows(T* base, const float (&c)[DT][4],
                                           long ld, int k0, int r0, int r1,
                                           bool in0, bool in1) {
  if (in0) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
      Elt<T>::store2(base + (long)(k0 + r0) * ld + n * 8, c[n][0], c[n][1]);
  }
  if (in1) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
      Elt<T>::store2(base + (long)(k0 + r1) * ld + n * 8, c[n][2], c[n][3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(128 * Plan<T, HD>::NC)
    flash_bwd_dkdv_kernel(const Args a) {
  using P = Plan<T, HD>;
  constexpr int LD = P::LD, ST = P::KV_ST, NC = P::NC, NTH = 128 * NC;
  constexpr int QT = kBMQ / 8, DC = HD / NC, DT = DC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBNB * LD;
  T* sQ = sV + kBNB * LD;            // [ST][kBMQ][LD]
  T* sO = sQ + ST * kBMQ * LD;       // dO, [ST][kBMQ][LD]
  float* sQp = reinterpret_cast<float*>(sO + ST * kBMQ * LD);
  float* sL = sQp + ST * kBMQ;
  float* sD = sL + ST * kBMQ;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int gr = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, cc = warp >> 2;
  // the earliest keys (the most queries) first, a key tile's head groups
  // side by side (their CTAs read the same K/V tile from L2)
  const int part = blockIdx.x % a.parts;
  const int bh = (blockIdx.x / a.parts) % (a.B * a.Hkv);
  const int kt = blockIdx.x / (a.parts * a.B * a.Hkv);
  const int b = bh / a.Hkv, h = bh % a.Hkv;
  const int g0 = part * a.G / a.parts, g1 = (part + 1) * a.G / a.parts;
  const int k0 = kt * kBNB;
  const long qld = (long)a.Hkv * a.G * HD, kld = (long)a.Hkv * HD;
  const T* kb = static_cast<const T*>(a.k) + (long)b * a.Sk * kld + (long)h * HD;
  const T* vb = static_cast<const T*>(a.v) + (long)b * a.Sk * kld + (long)h * HD;
  const float2* qrb = a.qr + (long)b * a.nqr;
  const float2 krng =
      range_of(a.kr + (long)b * a.nkr, a.nkr, k0 / kRange, kBNB / kRange);
  const int nqt = (a.Sq + kBMQ - 1) / kBMQ;

  copy_rows<T, HD, LD, NTH>(sK, kb, kBNB, kld, k0, a.Sk, tid);
  copy_rows<T, HD, LD, NTH>(sV, vb, kBNB, kld, k0, a.Sk, tid);
  cp_commit();
  auto load_q = [&](int g, int qt, int st) {
    const long head = (long)h * a.G + g;
    const T* qb = static_cast<const T*>(a.q) + (long)b * a.Sq * qld + head * HD;
    const T* ob = static_cast<const T*>(a.dout) + (long)b * a.Sq * qld +
                  head * HD;
    const long lrow = ((long)b * a.Hkv * a.G + head) * a.Sq;
    const int q0 = qt * kBMQ;
    copy_rows<T, HD, LD, NTH>(sQ + st * kBMQ * LD, qb, kBMQ, qld, q0, a.Sq,
                              tid);
    copy_rows<T, HD, LD, NTH>(sO + st * kBMQ * LD, ob, kBMQ, qld, q0, a.Sq,
                              tid);
    copy_floats<NTH>(sQp + st * kBMQ, a.qpos + (long)b * a.Sq, kBMQ, q0, a.Sq,
                     tid);
    copy_floats<NTH>(sL + st * kBMQ, a.lse + lrow, kBMQ, q0, a.Sq, tid);
    copy_floats<NTH>(sD + st * kBMQ, a.D + lrow, kBMQ, q0, a.Sq, tid);
  };

  const int r0 = rg * 16 + gr, r1 = r0 + 8;
  const bool in0 = k0 + r0 < a.Sk, in1 = k0 + r1 < a.Sk;
  const float* kpb = a.kpos + (long)b * a.Sk;
  const float* kvb = a.kval + (long)b * a.Sk;
  const float kp0 = in0 ? kpb[k0 + r0] : 0.f, kv0 = in0 ? kvb[k0 + r0] : 0.f;
  const float kp1 = in1 ? kpb[k0 + r1] : 0.f, kv1 = in1 ? kvb[k0 + r1] : 0.f;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the walk: the group's heads g0 .. g1-1, each over the live query tiles
  // in order (the same tiles for every head: positions are per batch row)
  const int first =
      next_live(qrb, a.nqr, nqt, 1, krng, false, a.window, -1, lane);
  int g = g0, qt = first;
  if (qt < nqt) load_q(g, qt, 0);
  cp_commit();
  for (int it = 0; qt < nqt; ++it) {
    int gn = g,
        qn = next_live(qrb, a.nqr, nqt, 1, krng, false, a.window, qt, lane);
    if (qn >= nqt && g + 1 < g1) {
      gn = g + 1;
      qn = first;
    }
    const int st = it % ST;
    if (ST == 2) {
      if (qn < nqt) load_q(gn, qn, (it + 1) % 2);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const T* q_s = sQ + st * kBMQ * LD;
    const T* o_s = sO + st * kBMQ * LD;
    const float* qp = sQp + st * kBMQ;
    const float* ls = sL + st * kBMQ;
    const float* Ds = sD + st * kBMQ;
    // P^T (keys x queries) = exp(K Q^T scale - lse), 0 where masked
    float p[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mm_nt<QT, HD>(p, sK + rg * 16 * LD, q_s, LD, lane);
#pragma unroll
    for (int n = 0; n < QT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tq + e;
        const float qpv = qp[col], lv = ls[col];
        p[n][e] = visible(kp0, kv0, qpv, a.window)
                      ? __expf(p[n][e] * a.scale - lv) : 0.f;
        p[n][2 + e] = visible(kp1, kv1, qpv, a.window)
                          ? __expf(p[n][2 + e] * a.scale - lv) : 0.f;
      }
    }
    accumulate<QT, DT>(dv, p, o_s + cc * DC, LD, lane);
    // dP^T = V dO^T; dS^T = P^T (dP^T - D) scale
    float ds[QT][4];
#pragma unroll
    for (int n = 0; n < QT; ++n)
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    mm_nt<QT, HD>(ds, sV + rg * 16 * LD, o_s, LD, lane);
#pragma unroll
    for (int n = 0; n < QT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dd = Ds[n * 8 + 2 * tq + (e & 1)];
        ds[n][e] = p[n][e] * (ds[n][e] - dd) * a.scale;
      }
    }
    accumulate<QT, DT>(dk, ds, q_s + cc * DC, LD, lane);
    __syncthreads();
    if (ST == 1 && qn < nqt) {
      load_q(gn, qn, 0);
      cp_commit();
    }
    g = gn;
    qt = qn;
  }
  cp_wait<0>();

  const long off = (long)b * a.Sk * kld + (long)h * HD + cc * DC + 2 * tq;
  if (a.parts == 1) {
    store_rows<T, DT>(static_cast<T*>(a.dk) + off, dk, kld, k0, r0, r1, in0,
                      in1);
    store_rows<T, DT>(static_cast<T*>(a.dv) + off, dv, kld, k0, r0, r1, in0,
                      in1);
  } else {  // the group's partial sums, summed in order by flash_sum_kernel
    const long n = (long)a.B * a.Sk * kld;
    float* pk = a.part + part * n + off;
    store_rows<float, DT>(pk, dk, kld, k0, r0, r1, in0, in1);
    store_rows<float, DT>(pk + a.parts * n, dv, kld, k0, r0, r1, in0, in1);
  }
}

// the dK/dV partials of the head groups summed in group order (dK's then
// dV's, 4 elements a thread) into dk and dv
template <typename T>
__global__ void flash_sum_kernel(const Args a, int hd) {
  const long n = (long)a.B * a.Sk * a.Hkv * hd;
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= 2 * n) return;
  const int which = i >= n;
  const long e = i - which * n;
  const float* src = a.part + which * a.parts * n + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int p = 1; p < a.parts; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* dst = static_cast<T*>(which ? a.dv : a.dk) + e;
  Elt<T>::store2(dst, acc.x, acc.y);
  Elt<T>::store2(dst + 2, acc.z, acc.w);
}

// ---- backward: dQ --------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(const Args a) {
  using P = Plan<T, HD>;
  constexpr int LD = P::LD, BN = P::BN, ST = P::DQ_ST, NT = BN / 8,
                OT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kBM * LD;  // dO
  T* sK = sO + kBM * LD;
  T* sV = sK + ST * BN * LD;
  float* sKp = reinterpret_cast<float*>(sV + ST * BN * LD);
  float* sKv = sKp + ST * BN;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int gr = lane >> 2, tq = lane & 3;
  const QTile c = q_tile(a);
  const int q0 = c.qt * kBM;
  const long qld = (long)a.Hkv * a.G * HD, kld = (long)a.Hkv * HD;
  const long qoff = (long)c.b * a.Sq * qld + (long)(c.h * a.G + c.g) * HD;
  const T* kb = static_cast<const T*>(a.k) + (long)c.b * a.Sk * kld +
                (long)c.h * HD;
  const T* vb = static_cast<const T*>(a.v) + (long)c.b * a.Sk * kld +
                (long)c.h * HD;
  const float* kpb = a.kpos + (long)c.b * a.Sk;
  const float* kvb = a.kval + (long)c.b * a.Sk;
  const float2* krb = a.kr + (long)c.b * a.nkr;
  const int nkt = (a.Sk + BN - 1) / BN;
  const float2 qrng =
      range_of(a.qr + (long)c.b * a.nqr, a.nqr, q0 / kRange, kBM / kRange);

  copy_rows<T, HD, LD, 128>(sQ, static_cast<const T*>(a.q) + qoff, kBM, qld,
                            q0, a.Sq, tid);
  copy_rows<T, HD, LD, 128>(sO, static_cast<const T*>(a.dout) + qoff, kBM,
                            qld, q0, a.Sq, tid);
  cp_commit();
  auto load_kv = [&](int j, int st) {
    copy_rows<T, HD, LD, 128>(sK + st * BN * LD, kb, BN, kld, j * BN, a.Sk,
                              tid);
    copy_rows<T, HD, LD, 128>(sV + st * BN * LD, vb, BN, kld, j * BN, a.Sk,
                              tid);
    copy_floats<128>(sKp + st * BN, kpb, BN, j * BN, a.Sk, tid);
    copy_floats<128>(sKv + st * BN, kvb, BN, j * BN, a.Sk, tid);
  };

  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  const bool in0 = q0 + r0 < a.Sq, in1 = q0 + r1 < a.Sq;
  const long lrow = (((long)c.b * a.Hkv + c.h) * a.G + c.g) * a.Sq;
  const float* qpb = a.qpos + (long)c.b * a.Sq;
  const float qp0 = in0 ? qpb[q0 + r0] : kNeg, qp1 = in1 ? qpb[q0 + r1] : kNeg;
  const float ls0 = in0 ? a.lse[lrow + q0 + r0] : 0.f;
  const float ls1 = in1 ? a.lse[lrow + q0 + r1] : 0.f;
  const float D0 = in0 ? a.D[lrow + q0 + r0] : 0.f;
  const float D1 = in1 ? a.D[lrow + q0 + r1] : 0.f;
  const int per = BN / kRange;

  float dq[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int j = next_live(krb, a.nkr, nkt, per, qrng, true, a.window, -1, lane);
  if (j < nkt) load_kv(j, 0);
  cp_commit();
  for (int it = 0; j < nkt; ++it) {
    const int jn =
        next_live(krb, a.nkr, nkt, per, qrng, true, a.window, j, lane);
    const int st = it % ST;
    if (ST == 2) {
      if (jn < nkt) load_kv(jn, (it + 1) % 2);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const T* k_s = sK + st * BN * LD;
    float p[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    mm_nt<NT, HD>(p, sQ + warp * 16 * LD, k_s, LD, lane);
    const float* kp = sKp + st * BN;
    const float* kv = sKv + st * BN;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tq + e;
        const float kpv = kp[col], kvv = kv[col];
        p[n][e] = visible(kpv, kvv, qp0, a.window)
                      ? __expf(p[n][e] * a.scale - ls0) : 0.f;
        p[n][2 + e] = visible(kpv, kvv, qp1, a.window)
                          ? __expf(p[n][2 + e] * a.scale - ls1) : 0.f;
      }
    }
    float ds[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    mm_nt<NT, HD>(ds, sO + warp * 16 * LD, sV + st * BN * LD, LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      ds[n][0] = p[n][0] * (ds[n][0] - D0) * a.scale;
      ds[n][1] = p[n][1] * (ds[n][1] - D0) * a.scale;
      ds[n][2] = p[n][2] * (ds[n][2] - D1) * a.scale;
      ds[n][3] = p[n][3] * (ds[n][3] - D1) * a.scale;
    }
    mm_rn<NT, OT>(dq, ds, k_s, LD, lane);
    __syncthreads();
    if (ST == 1 && jn < nkt) {
      load_kv(jn, 0);
      cp_commit();
    }
    j = jn;
  }
  cp_wait<0>();

  T* dqb = static_cast<T*>(a.dq) + qoff + 2 * tq;
  if (in0) {
#pragma unroll
    for (int n = 0; n < OT; ++n)
      Elt<T>::store2(dqb + (long)(q0 + r0) * qld + n * 8, dq[n][0], dq[n][1]);
  }
  if (in1) {
#pragma unroll
    for (int n = 0; n < OT; ++n)
      Elt<T>::store2(dqb + (long)(q0 + r1) * qld + n * 8, dq[n][2], dq[n][3]);
  }
}

// ---- host side -----------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
cudaError_t launch_prep(const Args& a, int hd, bool with_d, cudaStream_t st) {
  const int range_warps = a.B * max(a.nqr, a.nkr);
  const long rows = with_d ? (long)a.B * a.Sq * a.Hkv * a.G : 0;
  const long warps = range_warps + rows;
  const int per_block = 8;
  const long blocks = (warps + per_block - 1) / per_block;
  flash_prep_kernel<T><<<(unsigned)blocks, per_block * kWarp, 0, st>>>(
      a, hd, range_warps);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  using P = Plan<T, HD>;
  cudaError_t e = launch_prep<T>(a, HD, false, st);
  if (e != cudaSuccess) return e;
  e = set_smem(flash_fwd_kernel<T, HD>, P::FWD_SMEM);
  if (e != cudaSuccess) return e;
  const long ctas = (long)((a.Sq + kBM - 1) / kBM) * a.B * a.Hkv * a.G;
  flash_fwd_kernel<T, HD><<<(unsigned)ctas, 128, P::FWD_SMEM, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const Args& a, cudaStream_t st) {
  using P = Plan<T, HD>;
  cudaError_t e = launch_prep<T>(a, HD, true, st);
  if (e != cudaSuccess) return e;
  e = set_smem(flash_bwd_dkdv_kernel<T, HD>, P::KV_SMEM);
  if (e != cudaSuccess) return e;
  const long kv_ctas =
      (long)((a.Sk + kBNB - 1) / kBNB) * a.B * a.Hkv * a.parts;
  flash_bwd_dkdv_kernel<T, HD>
      <<<(unsigned)kv_ctas, 128 * P::NC, P::KV_SMEM, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.parts > 1) {
    const long quads = (2L * a.B * a.Sk * a.Hkv * HD) / 4;
    flash_sum_kernel<T><<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(a,
                                                                         HD);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = set_smem(flash_bwd_dq_kernel<T, HD>, P::DQ_SMEM);
  if (e != cudaSuccess) return e;
  const long q_ctas = (long)((a.Sq + kBM - 1) / kBM) * a.B * a.Hkv * a.G;
  flash_bwd_dq_kernel<T, HD><<<(unsigned)q_ctas, 128, P::DQ_SMEM, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int hd, bool bwd, cudaStream_t st) {
  switch (hd) {
    case 64:
      return bwd ? launch_bwd<T, 64>(a, st) : launch_fwd<T, 64>(a, st);
    case 128:
      return bwd ? launch_bwd<T, 128>(a, st) : launch_fwd<T, 128>(a, st);
    case 256:
      return bwd ? launch_bwd<T, 256>(a, st) : launch_fwd<T, 256>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, const void* kval, void* qr, void* kr,
               void* lse, int B, int Sq, int Sk, int Hkv, int G, float scale,
               int window) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qpos = static_cast<const float*>(qpos);
  a.kpos = static_cast<const float*>(kpos);
  a.kval = static_cast<const float*>(kval);
  a.qr = static_cast<float2*>(qr);
  a.kr = static_cast<float2*>(kr);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hkv = Hkv;
  a.G = G;
  a.nqr = (Sq + kRange - 1) / kRange;
  a.nkr = (Sk + kRange - 1) / kRange;
  a.window = window;
  a.scale = scale;
  a.parts = 1;
  return a;
}

template <typename T, int HD>
void plan_of(int* out) {
  using P = Plan<T, HD>;
  // forward: threads, smem, query rows, keys a step, stages; dK/dV: the
  // same with keys a CTA and query rows a step; dQ: as the forward
  const int v[15] = {128, P::FWD_SMEM, kBM, P::BN, P::FWD_ST,
                     128 * P::NC, P::KV_SMEM, kBNB, kBMQ, P::KV_ST,
                     128, P::DQ_SMEM, kBM, P::BN, P::DQ_ST};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
}

}  // namespace

// q (B, Sq, Hkv, G, hd), k/v (B, Sk, Hkv, hd) bf16 or float32 (`is_bf16`),
// hd 64, 128 or 256; positions float32; qr (B, ceil(Sq/32), 2) and kr
// (B, ceil(Sk/32), 2) float32 scratch; out like q, lse (B, Hkv, G, Sq).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kpos, const void* kval,
                         void* qr, void* kr, void* out, void* lse, int B,
                         int Sq, int Sk, int Hkv, int G, int hd, int is_bf16,
                         float scale, int window, void* stream) {
  Args a = make_args(q, k, v, qpos, kpos, kval, qr, kr, lse, B, Sq, Sk, Hkv,
                     G, scale, window);
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(a, hd, false, st)
                               : dispatch<float>(a, hd, false, st));
}

// The backward: out, dout like q, lse from the forward; D (B, Hkv, G, Sq)
// float32 scratch; dq like q, dk/dv like k. The dK/dV pass runs `parts`
// head groups a key tile (1 <= parts <= G); with parts > 1, part is
// float32 scratch of (2, parts, B, Sk, Hkv, hd) for their partial sums.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kpos, const void* kval,
                         const void* out, const void* dout, const void* lse,
                         void* qr, void* kr, void* D, void* dq, void* dk,
                         void* dv, void* part, int B, int Sq, int Sk, int Hkv,
                         int G, int hd, int parts, int is_bf16, float scale,
                         int window, void* stream) {
  if (parts < 1 || parts > G || (parts > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, qpos, kpos, kval, qr, kr,
                     const_cast<void*>(lse), B, Sq, Sk, Hkv, G, scale,
                     window);
  a.out = const_cast<void*>(out);
  a.dout = dout;
  a.D = static_cast<float*>(D);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.part = static_cast<float*>(part);
  a.parts = parts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(a, hd, true, st)
                               : dispatch<float>(a, hd, true, st));
}

// The launch plans of a built (hd, dtype) into out[15] (see plan_of);
// returns 0, or cudaErrorInvalidValue for an hd that is not built.
extern "C" int flash_plan(int hd, int is_bf16, int* out) {
  switch (hd) {
    case 64:
      is_bf16 ? plan_of<__nv_bfloat16, 64>(out) : plan_of<float, 64>(out);
      return 0;
    case 128:
      is_bf16 ? plan_of<__nv_bfloat16, 128>(out) : plan_of<float, 128>(out);
      return 0;
    case 256:
      is_bf16 ? plan_of<__nv_bfloat16, 256>(out) : plan_of<float, 256>(out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
