// Spec-verify flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spec_verify/kernel.py:
// spec_verify_attention_kernel (body _verify_attn_kernel): attention of
// the (K+1)-token draft block against the position-tagged ring KV cache.
// GQA rows r = t*G + g; slot s is visible to row r iff
// 0 <= cpos[s] <= qpos[r] and, with a window, cpos[s] > qpos[r] - window;
// optional tanh softcap; online softmax in float32 over KV tiles, with the
// reference's guards (rows that see nothing stay empty; the output is
// acc / max(l, 1e-20)).
//
// What bounds it on this card: bytes. Each valid K and V slot must be
// read once, 2*B*Hkv*S*hd*2 bytes in bf16, against 4*B*Hq*T*S*hd flops
// that tensor cores finish far sooner. The design: one block per
// (batch, kv head, 16 query rows); the 16 rows' queries stay in
// registers as mma A-fragments for the whole block; K/V stream through
// shared memory in 64-slot bf16 tiles; QK^T and P·V run on the tensor
// cores (mma.sync m16n8k16, bf16 in, float32 accumulate), four warps
// splitting the tile's slots for QK^T and the head dimension for P·V;
// the softmax state stays float32 (m, l in shared memory, the output
// accumulator in registers). Tiles whose slots are masked for every row
// of the block (empty ring slots, slots past the block's last position)
// are skipped without touching K/V: a masked tile leaves the state
// bit-for-bit unchanged. Rows of one (batch, head) are split over
// ceil(T*G/16) blocks (K/V re-read from L2) to put more than B*Hkv
// blocks on the card. Not done yet: wgmma, TMA, a software pipeline over
// K/V tiles, split-KV.
//
// float32 inputs (tests, small models) take a CUDA-core kernel with the
// same tiling and softmax (register-tiled 2x4 score micro-tiles).
//
// Unlike the TPU kernel there is no 8-row padding and no 512-key chunk:
// the kernel reads q in the model's (B, T, Hq, hd) layout and masks the
// ragged cache end itself. hd must be 32, 64, 128 or 256 (the wrapper
// checks). Each kernel is compiled twice, for hd <= 128 and for hd = 256
// (RecurrentGemma's MQA heads): the bf16 kernel's query fragments and
// accumulator tiles are register arrays sized by the larger hd (16
// k-steps of query fragments, 8 n8 output tiles a warp at 256), and the
// f32 kernel's threads own two output columns each at 256 (one below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;     // query rows per block
constexpr int TILE = 64;     // KV slots per tile
constexpr int THREADS = 128;
constexpr int PST = TILE + 8;  // float row stride of the score tile
constexpr float NEG = -1e30f;

struct Shape {
  int Tq, Hq, Hkv, S1, hd, window;
  float softcap, scale;
};

// ---- pieces shared by both kernels ----------------------------------------

// Query positions of the block's rows; m = NEG, l = 0. Returns the
// block's (min, max) query position for tile skipping.
__device__ void init_rows(const int* pos, int b, int r0, int TG, int G,
                          const Shape& sh, int* qp_s, float* m_s, float* l_s,
                          int& qmin, int& qmax) {
  const int tid = threadIdx.x;
  if (tid < ROWS) {
    const int row = r0 + tid;
    qp_s[tid] = row < TG ? pos[(size_t)b * sh.Tq + row / G] : INT_MIN;
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  qmax = INT_MIN;
  qmin = INT_MAX;
  for (int r = 0; r < ROWS && r0 + r < TG; ++r) {
    qmax = max(qmax, qp_s[r]);
    qmin = min(qmin, qp_s[r]);
  }
}

// Loads the tile's slot positions; true iff some slot is visible to some
// row of the block (block-uniform: it synchronises).
__device__ bool tile_live(const int* cpos, int b, int s0, const Shape& sh,
                          int qmin, int qmax, int* cp_s) {
  int live = 0;
  if (threadIdx.x < TILE) {
    const int s = s0 + threadIdx.x;
    const int cp = s < sh.S1 ? cpos[(size_t)b * sh.S1 + s] : -1;
    cp_s[threadIdx.x] = cp;
    live = cp >= 0 && cp <= qmax && (sh.window <= 0 || cp > qmin - sh.window);
  }
  return __syncthreads_or(live) != 0;
}

// Raw score -> scaled, soft-capped, masked score.
__device__ __forceinline__ float finish_score(float dot, int r, int j, int r0,
                                              int TG, const Shape& sh,
                                              const int* qp_s,
                                              const int* cp_s) {
  float s = dot * sh.scale;
  if (sh.softcap > 0.f) s = tanhf(s / sh.softcap) * sh.softcap;
  const int cp = cp_s[j], qp = qp_s[r];
  const bool ok = r0 + r < TG && cp >= 0 && cp <= qp &&
                  (sh.window <= 0 || cp > qp - sh.window);
  return ok ? s : NEG;
}

// Online-softmax update over one tile, one warp per row: scores in ps
// become probabilities; m, l advance; a_s gets the accumulator rescale.
__device__ void softmax_tile(float* ps, float* m_s, float* l_s, float* a_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const float sa = ps[r * PST + lane];
    const float sb = ps[r * PST + lane + 32];
    float mx = fmaxf(sa, sb);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float pa = 0.f, pb = 0.f, alpha = 0.f;
    if (m_new > NEG) {  // else: nothing visible yet, the state stays empty
      pa = sa <= NEG ? 0.f : expf(sa - m_new);
      pb = sb <= NEG ? 0.f : expf(sb - m_new);
      alpha = m_prev <= NEG ? 0.f : expf(m_prev - m_new);
    }
    float sum = pa + pb;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    ps[r * PST + lane] = pa;
    ps[r * PST + lane + 32] = pb;
    __syncwarp();
    if (lane == 0) {
      m_s[r] = m_new;
      l_s[r] = alpha * l_s[r] + sum;
      a_s[r] = alpha;
    }
  }
}

// ---- bfloat16: tensor cores (mma.sync m16n8k16) -----------------------------

constexpr int KPAD = 8;  // bf16 padding of q/k/v smem rows (bank spread)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// KMAX: the most k-steps (hd / 16) this instantiation takes.
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
spec_verify_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ cpos,
                        const int* __restrict__ pos,
                        __nv_bfloat16* __restrict__ out, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = sh.hd;
  const int G = sh.Hq / sh.Hkv;
  const int TG = sh.Tq * G;
  const int h = blockIdx.x, r0 = blockIdx.y * ROWS, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int ST = hd + KPAD;
  const int VPR = hd / 8;  // 16-byte vectors per row

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][ST]
  __nv_bfloat16* ks = qs + ROWS * ST;                               // [TILE][ST]
  __nv_bfloat16* vs = ks + TILE * ST;                               // [TILE][ST]
  float* ps = reinterpret_cast<float*>(vs + TILE * ST);             // [ROWS][PST]
  float* m_s = ps + ROWS * PST;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  int* qp_s = reinterpret_cast<int*>(a_s + ROWS);
  int* cp_s = qp_s + ROWS;

  // ---- stage the block's query rows, then keep them as A-fragments ----
  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < TG) {
      const int tq = row / G, gq = row % G;
      val = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * sh.Tq + tq) * sh.Hq + h * G + gq) * hd + c));
    }
    *reinterpret_cast<uint4*>(qs + r * ST + c) = val;
  }
  int qmin, qmax;
  init_rows(pos, b, r0, TG, G, sh, qp_s, m_s, l_s, qmin, qmax);
  const int KSTEPS = hd / 16;
  uint32_t qa[KMAX][4];
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < KSTEPS) {
      const __nv_bfloat16* base = qs + 16 * kk + 2 * t;
      qa[kk][0] = ld32(base + g * ST);
      qa[kk][1] = ld32(base + (g + 8) * ST);
      qa[kk][2] = ld32(base + g * ST + 8);
      qa[kk][3] = ld32(base + (g + 8) * ST + 8);
    }
  }

  // P·V: warp w owns output columns [w*hd/4, (w+1)*hd/4), NT n8-tiles.
  constexpr int NTMAX = KMAX / 2;
  const int NT = hd / 32;
  const int col0 = warp * (hd / 4);
  float acc[NTMAX][4];
#pragma unroll
  for (int i = 0; i < NTMAX; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int s0 = 0; s0 < sh.S1; s0 += TILE) {
    if (!tile_live(cpos, b, s0, sh, qmin, qmax, cp_s)) continue;

    // ---- stage K and V tiles (bf16) ----
    for (int i = tid; i < TILE * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * 8;
      const int s = s0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (s < sh.S1) {
        const size_t off = (((size_t)b * sh.S1 + s) * sh.Hkv + h) * hd + c;
        kv = __ldg(reinterpret_cast<const uint4*>(k + off));
        vv = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
      *reinterpret_cast<uint4*>(ks + j * ST + c) = kv;
      *reinterpret_cast<uint4*>(vs + j * ST + c) = vv;
    }
    __syncthreads();

    // ---- S = Q K^T: warp w takes slots [16w, 16w + 16) ----
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const __nv_bfloat16* kb = ks + (warp * 16 + nt * 8 + g) * ST + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk)
        if (kk < KSTEPS) mma_bf16(sc[nt], qa[kk], ld32(kb + 16 * kk),
                                  ld32(kb + 16 * kk + 8));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8;
        const int j = warp * 16 + nt * 8 + 2 * t + (e & 1);
        ps[r * PST + j] = finish_score(sc[nt][e], r, j, r0, TG, sh, qp_s, cp_s);
      }
    __syncthreads();
    softmax_tile(ps, m_s, l_s, a_s);
    __syncthreads();

    // ---- acc = alpha * acc + P V ----
    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int nt = 0; nt < NTMAX; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const float* p0 = ps + g * PST + 16 * kk + 2 * t;
      const float* p1 = p0 + 8 * PST;
      const uint32_t pa[4] = {pack_f32(p0[0], p0[1]), pack_f32(p1[0], p1[1]),
                              pack_f32(p0[8], p0[9]), pack_f32(p1[8], p1[9])};
#pragma unroll
      for (int nt = 0; nt < NTMAX; ++nt) {
        if (nt < NT) {
          const __nv_bfloat16* vb =
              vs + (16 * kk + 2 * t) * ST + col0 + nt * 8 + g;
          mma_bf16(acc[nt], pa, pack_bf16(vb[0], vb[ST]),
                   pack_bf16(vb[8 * ST], vb[9 * ST]));
        }
      }
    }
    __syncthreads();
  }

  // ---- out = acc / max(l, 1e-20) ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    const int row = r0 + r;
    if (row >= TG) continue;
    const int tq = row / G, gq = row % G;
    const float l = fmaxf(l_s[r], 1e-20f);
    __nv_bfloat16* orow =
        out + (((size_t)b * sh.Tq + tq) * sh.Hq + h * G + gq) * hd;
#pragma unroll
    for (int nt = 0; nt < NTMAX; ++nt) {
      if (nt < NT) {
        const int c = col0 + nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[nt][2 * half] / l, acc[nt][2 * half + 1] / l);
      }
    }
  }
}

// ---- float32: CUDA cores ---------------------------------------------------

// CPT: output columns a thread owns in P·V (hd / THREADS at hd = 256,
// else 1).
template <int CPT>
__global__ void __launch_bounds__(THREADS)
spec_verify_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ cpos,
                       const int* __restrict__ pos, float* __restrict__ out,
                       Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int hd = sh.hd;
  const int G = sh.Hq / sh.Hkv;
  const int TG = sh.Tq * G;
  const int h = blockIdx.x, r0 = blockIdx.y * ROWS, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ST = hd + 4;  // padded row stride: 16-byte aligned, bank-spread
  const int VPR = hd / 4;

  float* qs = smem;                  // [ROWS][ST]
  float* ks = qs + ROWS * ST;        // [TILE][ST]
  float* vs = ks + TILE * ST;        // [TILE][hd]
  float* ps = vs + TILE * hd;        // [ROWS][PST]
  float* m_s = ps + ROWS * PST;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  int* qp_s = reinterpret_cast<int*>(a_s + ROWS);
  int* cp_s = qp_s + ROWS;

  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const int row = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < TG) {
      const int tq = row / G, gq = row % G;
      val = __ldg(reinterpret_cast<const float4*>(
          q + (((size_t)b * sh.Tq + tq) * sh.Hq + h * G + gq) * hd + c));
    }
    *reinterpret_cast<float4*>(qs + r * ST + c) = val;
  }
  int qmin, qmax;
  init_rows(pos, b, r0, TG, G, sh, qp_s, m_s, l_s, qmin, qmax);

  // P·V ownership: columns d_own + c * THREADS (c < CPT) of rows rg0,
  // rg0 + RG, ...
  const int RG = hd >= THREADS ? 1 : THREADS / hd;
  const int nr = ROWS / RG;
  const int d_own = tid % hd;
  const int rg0 = tid / hd;
  float acc[CPT][ROWS];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[c][i] = 0.f;
  // score ownership: rows srow, srow+1 x slots skey + 16*jj
  const int srow = (tid / 16) * 2;
  const int skey = tid % 16;

  for (int s0 = 0; s0 < sh.S1; s0 += TILE) {
    if (!tile_live(cpos, b, s0, sh, qmin, qmax, cp_s)) continue;

    for (int i = tid; i < TILE * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * 4;
      const int s = s0 + j;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (s < sh.S1) {
        const size_t off = (((size_t)b * sh.S1 + s) * sh.Hkv + h) * hd + c;
        kv = __ldg(reinterpret_cast<const float4*>(k + off));
        vv = __ldg(reinterpret_cast<const float4*>(v + off));
      }
      *reinterpret_cast<float4*>(ks + j * ST + c) = kv;
      *reinterpret_cast<float4*>(vs + j * hd + c) = vv;
    }
    __syncthreads();

    {
      float sc[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[rr][jj] = 0.f;
      const float* q0 = qs + srow * ST;
      const float* q1 = q0 + ST;
      for (int c = 0; c < hd; c += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(q0 + c);
        const float4 a1 = *reinterpret_cast<const float4*>(q1 + c);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kk =
              *reinterpret_cast<const float4*>(ks + (skey + 16 * jj) * ST + c);
          sc[0][jj] = fmaf(a0.x, kk.x, sc[0][jj]);
          sc[0][jj] = fmaf(a0.y, kk.y, sc[0][jj]);
          sc[0][jj] = fmaf(a0.z, kk.z, sc[0][jj]);
          sc[0][jj] = fmaf(a0.w, kk.w, sc[0][jj]);
          sc[1][jj] = fmaf(a1.x, kk.x, sc[1][jj]);
          sc[1][jj] = fmaf(a1.y, kk.y, sc[1][jj]);
          sc[1][jj] = fmaf(a1.z, kk.z, sc[1][jj]);
          sc[1][jj] = fmaf(a1.w, kk.w, sc[1][jj]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = srow + rr, j = skey + 16 * jj;
          ps[r * PST + j] =
              finish_score(sc[rr][jj], r, j, r0, TG, sh, qp_s, cp_s);
        }
    }
    __syncthreads();
    softmax_tile(ps, m_s, l_s, a_s);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (i < nr) {
        const float al = a_s[rg0 + i * RG];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c][i] *= al;
      }
    for (int j = 0; j < TILE; j += 4) {
      float4 vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float* vc = vs + j * hd + d_own + c * THREADS;
        vv[c] = make_float4(vc[0], vc[hd], vc[2 * hd], vc[3 * hd]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i < nr) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(ps + (rg0 + i * RG) * PST + j);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            float a = acc[c][i];
            a = fmaf(p4.x, vv[c].x, a);
            a = fmaf(p4.y, vv[c].y, a);
            a = fmaf(p4.z, vv[c].z, a);
            a = fmaf(p4.w, vv[c].w, a);
            acc[c][i] = a;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= nr) continue;
    const int r = rg0 + i * RG;
    const int row = r0 + r;
    if (row >= TG) continue;
    const int tq = row / G, gq = row % G;
    const float l = fmaxf(l_s[r], 1e-20f);
    float* orow = out + (((size_t)b * sh.Tq + tq) * sh.Hq + h * G + gq) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[d_own + c * THREADS] = acc[c][i] / l;
  }
}

size_t tail_bytes() {  // ps, m/l/alpha, query and slot positions
  return 4 * ((size_t)ROWS * PST + 3 * ROWS) + 4 * (ROWS + TILE);
}

template <typename K, typename T>
int launch(K kernel, size_t smem, const void* q, const void* k, const void* v,
           const void* cpos, const void* pos, void* out, int B, const Shape& sh,
           void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int TG = sh.Tq * (sh.Hq / sh.Hkv);
  dim3 grid(sh.Hkv, (TG + ROWS - 1) / ROWS, B);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)cpos,
      (const int*)pos, (T*)out, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spec_verify_attention_f32(
    const void* q, const void* k, const void* v, const void* cpos,
    const void* pos, void* out, int B, int Tq, int Hq, int Hkv, int S1,
    int hd, int window, float softcap, float scale, void* stream) {
  const Shape sh{Tq, Hq, Hkv, S1, hd, window, softcap, scale};
  const size_t smem = 4 * ((size_t)ROWS * (hd + 4) + (size_t)TILE * (hd + 4) +
                           (size_t)TILE * hd) + tail_bytes();
  if (hd > THREADS)
    return launch<decltype(&spec_verify_f32_kernel<2>), float>(
        spec_verify_f32_kernel<2>, smem, q, k, v, cpos, pos, out, B, sh,
        stream);
  return launch<decltype(&spec_verify_f32_kernel<1>), float>(
      spec_verify_f32_kernel<1>, smem, q, k, v, cpos, pos, out, B, sh, stream);
}

extern "C" int spec_verify_attention_bf16(
    const void* q, const void* k, const void* v, const void* cpos,
    const void* pos, void* out, int B, int Tq, int Hq, int Hkv, int S1,
    int hd, int window, float softcap, float scale, void* stream) {
  const Shape sh{Tq, Hq, Hkv, S1, hd, window, softcap, scale};
  const size_t smem =
      2 * (size_t)(ROWS + 2 * TILE) * (hd + KPAD) + tail_bytes();
  if (hd > 128)
    return launch<decltype(&spec_verify_bf16_kernel<16>), __nv_bfloat16>(
        spec_verify_bf16_kernel<16>, smem, q, k, v, cpos, pos, out, B, sh,
        stream);
  return launch<decltype(&spec_verify_bf16_kernel<8>), __nv_bfloat16>(
      spec_verify_bf16_kernel<8>, smem, q, k, v, cpos, pos, out, B, sh,
      stream);
}
