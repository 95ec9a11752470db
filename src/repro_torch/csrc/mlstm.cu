// mLSTM recurrence of xLSTM (arXiv:2405.04517): forward and backward
// kernels for sm_90a, plain C entries loaded with ctypes
// (kernels/xlstm/ops.py).
//
// Replaces: no pallas_call. The JAX package steps the recurrence as one
// compiled jax.lax.scan (src/repro/models/layers.py:844, apply_mlstm) and
// differentiates that scan for training; the port stepped T in a Python
// loop of eager launches. Plain versions: kernels/xlstm/ref.py
// (mlstm_scan_ref, mlstm_scan_bwd_ref).
//
// The recurrence, per (b, h) and step t (P = [C|n] before the step, an
// hd x (hd+1) float32 matrix, m the stabilizer):
//   m_new = max(log sigmoid(f_t) + m, i_t)  (i_t where not finite)
//   fg = exp(log sigmoid(f_t) + m - m_new) (0 while m is -inf),
//   ig = exp(i_t - m_new)
//   new = fg P + ig (k_t (x) [v_t, 1])  (k_t v_t rounded to the model dtype)
//   h_t = (q_t new)[:hd] / max(|q_t . new[:, hd]|, exp(-m_new))
//   P, m advance only where the step updates (upd).
//
// Bound: operations. A step touches every element of [C|n] (6 float32
// operations: the product k v, fg P, ig kv, their sum, and the read's
// multiply-add) while it reads only q, k, v (3 hd values) and writes hd
// values of h, so at xLSTM-125M's hd 192 a step does ~2 operations per
// byte it must move: the 67 TFLOP/s of float32 bound it, not the 3.35 TB/s.
// The T steps are sequential, so the latency of one step bounds it in
// practice. The backward's bound counts each element's work once, 19
// operations a step: the step's recompute (k v, fg P + ig kv: 4), G_new =
// G + q dr (2), dq's and dk's terms and their row sums (new dr, dkv v: 4),
// dfg and dig (G_new P, G_new kv, each summed: 4), dkv = ig G_new and
// dv's multiply-add (3), the carry fg G_new added in (2). This kernel
// re-forms the states between two kept ones in its walk (4 a step each,
// 1.5 steps on average) and forms new again (4 more): see the design.
//
// Design of the forward (mlstm_fwd_kernel). Column j of [C|n] evolves
// from fg, ig, k_t and v_t[j] alone, so a CTA owns 32 columns (a lane
// each) of one (b, h) and 8 warps split the rows (at most 24 a thread, hd
// <= 192; lane l < rpt of warp w also carries row w rpt + l of n): the
// cell stays in registers for all T steps, and the update needs no
// barrier. Only the read h_t = (q_t new) / den crosses threads, and it is
// never fed back, so it is deferred: T is stepped in blocks of kFwdS = 8
// steps; a step leaves each warp's column partial (its rows, four
// accumulators) and each thread's q_i n_i in shared memory (two blocks'
// worth), and after the block's one __syncthreads warp w folds step w of
// it in a fixed order (the warps in turn for the columns; for q.n each
// lane the 8 warps in turn, then a butterfly), so h is the same from run
// to run. The block's inputs are copied a block ahead: warp w copies step
// w's q and k rows and v of the CTA's columns by cp.async into the other
// half of a two-block ring; each warp then converts its own rows to float
// (16-byte loads where its rows line up) for float4 broadcasts, 12 loads a
// step. The stabilizer's chain needs f, i and upd, not the state, so warp
// 0 forms the next block's gates (fg, ig, upd, the m before and after,
// exp(-m_new)) while the others step the current one (three gate blocks
// in shared memory). An element's update is cell_update (the backward
// re-forms the states with the same function); k v is rounded two rows to
// a conversion (kv4). A step that does not update has code of its own
// rather than a select an element. The state out is written once (after
// out_at[b]: the last step for the dynamic state, the last committed step
// for the committed carry, -1 for the state before the block), or after
// every step with collect into rows padded to whole 32-byte sectors
// (staged_row: sectors written in parts by two CTAs halved the stores'
// rate), the n column with its row's pad by 8 lanes a row; under
// autograd a checkpoint every K steps and each step's q.n. 384 CTAs of 256
// threads at 13b's shape, three a SM (80 registers, 72,448 bytes of
// shared memory): one wave.
//
// Design of the backward (mlstm_bwd_kernel). The forward's layout: a CTA
// a (b, h) and 32 columns, 24 rows a thread; three CTAs a SM keep 13b's
// 384 CTAs in one wave, which leaves a thread 80 registers and a CTA
// 75 KB of shared memory. The cell's adjoint G therefore lives in shared
// memory, each thread's rows as float4s only it touches (no barrier). T
// is walked in reverse a chunk of K steps at a time. A chunk's gates
// come first, all at once: log sigmoid(f) a lane a step, the
// stabilizer's chain of m by one thread (a few scalar operations a step),
// fg and ig a lane a step; the lead CTA also sums dh.h a warp a step.
// Level 1 then steps the chunk from its checkpoint and keeps only the
// state before every kGroup-th step in scratch (a thread's 24 rows and
// its row of n, written and read back by it alone): a quarter of the
// state stream that keeping every state would need. The walk takes the
// chunk's groups from the last: while group g is walked, group g-1's
// q, k (rows), v, dh (the CTA's columns) and q.n are copied into the
// other half of a two-buffer stage by cp.async (16-byte copies where the
// rows allow), and when g's state has been read for the last time, g-1's
// state follows into its one buffer. One __syncthreads a group: after
// it, the previous group's per-warp sums are folded. A step re-forms its
// state from the group's, 4 rows at a time, then forms new, G's update
// and the terms;
// dq's and dk's row sums over the CTA's 32 columns come from a warp
// transpose of shuffles (8 values of 4 rows, halved at three levels:
// each lane ends with one row's sum, every sum in one fixed tree), dv's
// column sums from the warps' sums folded in order (the CTA holds all of
// its columns' rows), dfg and dig from warp sums folded in order.
// Nothing is divided back out of the recurrence (fg can be ~0). G does
// not depend on the stabilizer's adjoint, so the main kernel writes
// per-CTA partial rows of dq and dk (a last block for the n column's
// terms), (dfg, dig, the denominator's share of dm_new from the lead CTA,
// the m before the step) per CTA, and a second pass
// (mlstm_bwd_reduce_kernel) sums the blocks in order and walks the
// stabilizer's chain back: the gates of a chunk's steps at once from the
// kept m, then the scalar adjoint chain by one thread (di, df, dm0). The
// maximum hands its adjoint to the larger side and half to each on a tie,
// as torch's and JAX's do. Every sum has a fixed order: the result is
// bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;          // columns of [C|n] a CTA owns
constexpr int kRpt = 24;           // most rows a thread owns
constexpr int kKmax = 64;          // most steps between checkpoints

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// two consecutive elements (4- or 8-byte aligned) as float
__device__ __forceinline__ float2 pair_f(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

template <typename T>
__device__ __forceinline__ float round_in(float x);
template <>
__device__ __forceinline__ float round_in<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// log sigmoid as torch forms it: min(0, x) - log1p(exp(-|x|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(0.f, x) - log1pf(expf(-fabsf(x)));
}

struct Gate {
  float a, mx, mn, fg, ig;
  bool fin;
};

// one step of the stabilizer from the m before it
__device__ __forceinline__ Gate gate(float f, float i, float mp) {
  Gate g;
  g.a = log_sigmoid(f) + mp;
  g.mx = fmaxf(g.a, i);
  g.mn = isfinite(g.mx) ? g.mx : i;
  g.fin = isfinite(mp);
  g.fg = g.fin ? expf(g.a - g.mn) : 0.f;
  g.ig = expf(i - g.mn);
  return g;
}

// fg p + ig x, each product and the sum rounded once (as the plain
// version's three tensor operations)
__device__ __forceinline__ float lerp_rn(float fg, float p, float ig,
                                         float x) {
  return __fadd_rn(__fmul_rn(fg, p), __fmul_rn(ig, x));
}

// One element of [C|n] through a step, given its product kv = round(k v)
// (k v rounded to the model dtype): fg p + ig kv, each product and the sum
// rounded once (the plain version's three tensor operations; kv = k for
// the n column, whose k v is k exactly). The forward and the backward's
// re-forms of the states call it, so both form the same states bit for
// bit.
__device__ __forceinline__ float cell_update(float fg, float p, float ig,
                                             float kv) {
  return lerp_rn(fg, p, ig, kv);
}

template <typename TIn>
__device__ __forceinline__ float cell_step(float fg, float p, float ig,
                                           float k, float v) {
  return cell_update(fg, p, ig, round_in<TIn>(k * v));
}

// k v of four rows at once, rounded as round_in rounds it, two products
// to a conversion (the forward's products)
template <typename TIn>
__device__ __forceinline__ void kv4(const float4& k4, float v,
                                    float (&kv)[4]);
template <>
__device__ __forceinline__ void kv4<float>(const float4& k4, float v,
                                           float (&kv)[4]) {
  kv[0] = k4.x * v;
  kv[1] = k4.y * v;
  kv[2] = k4.z * v;
  kv[3] = k4.w * v;
}
template <>
__device__ __forceinline__ void kv4<__nv_bfloat16>(const float4& k4, float v,
                                                   float (&kv)[4]) {
  const float2 a = __bfloat1622float2(__floats2bfloat162_rn(k4.x * v, k4.y * v));
  const float2 c = __bfloat1622float2(__floats2bfloat162_rn(k4.z * v, k4.w * v));
  kv[0] = a.x;
  kv[1] = a.y;
  kv[2] = c.x;
  kv[3] = c.y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ns runs of nbytes (a multiple of the element size) at src, src +
// sstride, ... into dst, dst + dstride, ... (bytes), copied by the CTA's
// kThreads threads: 16-byte cp.async where both sides allow, 4-byte ones
// where `words` (every run a multiple of 4 bytes, 4-byte aligned), else
// plain 2-byte loads and stores
__device__ __forceinline__ void stage_runs(void* dst, int dstride,
                                           const void* src, size_t sstride,
                                           int nbytes, int ns, bool words) {
  const int tid = threadIdx.x;
  char* d = static_cast<char*>(dst);
  const char* x = static_cast<const char*>(src);
  if (words && nbytes % 16 == 0 && dstride % 16 == 0 && sstride % 16 == 0 &&
      ((uintptr_t)x & 15) == 0) {
    const int W = nbytes / 16;
    for (int e = tid; e < ns * W; e += kThreads) {
      const int r = e / W, wi = e - r * W;
      cp_async16(d + r * dstride + wi * 16, x + r * sstride + wi * 16);
    }
  } else if (words) {
    const int W = nbytes / 4;
    for (int e = tid; e < ns * W; e += kThreads) {
      const int r = e / W, wi = e - r * W;
      cp_async4(d + r * dstride + wi * 4, x + r * sstride + wi * 4);
    }
  } else {
    const int W = nbytes / 2;
    for (int e = tid; e < ns * W; e += kThreads) {
      const int r = e / W, wi = e - r * W;
      reinterpret_cast<uint16_t*>(d + r * dstride)[wi] =
          reinterpret_cast<const uint16_t*>(x + r * sstride)[wi];
    }
  }
}

// one run of nbytes at src into dst, by the calling warp's lanes (the
// copies stage_runs makes)
__device__ __forceinline__ void stage_run_warp(void* dst, const void* src,
                                               int nbytes, bool words,
                                               int lane) {
  char* d = static_cast<char*>(dst);
  const char* x = static_cast<const char*>(src);
  if (words && nbytes % 16 == 0 && ((uintptr_t)x & 15) == 0 &&
      (smem_addr(d) & 15) == 0) {
    for (int wi = lane; wi < nbytes / 16; wi += 32)
      cp_async16(d + wi * 16, x + wi * 16);
  } else if (words) {
    for (int wi = lane; wi < nbytes / 4; wi += 32)
      cp_async4(d + wi * 4, x + wi * 4);
  } else {
    for (int wi = lane; wi < nbytes / 2; wi += 32)
      reinterpret_cast<uint16_t*>(d)[wi] =
          reinterpret_cast<const uint16_t*>(x)[wi];
  }
}

constexpr int kMaxHd = kWarps * kRpt;
constexpr int kR4 = kRpt / 4;  // float4s of a thread's rows

// The forward's plan (mlstm_fwd_plan in kernels/xlstm/ops.py): blocks of
// kFwdS steps, one a warp at the fold. Dynamic shared memory, in floats: a
// two-block ring of the raw inputs (q and k rows in the input type, room
// for float; v of the CTA's columns), each warp's q and k rows of the
// block as float (its kRpt rows a step, zero past its rows and hd), three
// blocks of gates (8 a step: fg, ig, upd, the m before and after the
// step, exp(-m_new)), and two blocks of the read's partials (a warp's
// column sums, a thread's q_i n_i).
constexpr int kFwdS = kWarps;
constexpr int kFrQ = 0;
constexpr int kFrK = kFrQ + kFwdS * kMaxHd;
constexpr int kFrV = kFrK + kFwdS * kMaxHd;
constexpr int kFwdRing = kFrV + kFwdS * kCols;
constexpr int kFsRows = 2 * kFwdRing;                          // [kWarps][S][2][kRpt]
constexpr int kFsGates = kFsRows + kWarps * kFwdS * 2 * kRpt;  // [3][S][8]
constexpr int kFsPart = kFsGates + 3 * kFwdS * 8;              // [2][S][kWarps][kCols]
constexpr int kFsN = kFsPart + 2 * kFwdS * kWarps * kCols;     // [2][S][kThreads]
constexpr int kFsFloats = kFsN + 2 * kFwdS * kThreads;

template <typename TIn>
struct FwdArgs {
  const TIn *q, *k, *v;
  const float *ipre, *fpre, *cn0, *m0;
  const bool* upd;
  const int* out_at;
  float *hout, *cn_out, *m_out, *ckpt, *mck, *s_hist;
  int T, B, H, hd, collect, K, words;
  int srs;  // the staged states' row stride (collect)
};

// The staged states' rows (collect) are padded to whole 32-byte sectors,
// so that every store of a row's columns by a warp fills the sectors it
// touches (with rows hd + 1 floats apart, sectors written in parts by
// two CTAs made the verify shape's stores take twice as long on the
// card); the wrapper allocates them so and returns the view of the first
// hd + 1 columns.
__host__ __device__ constexpr int staged_row(int hd) { return (hd + 1 + 7) / 8 * 8; }

template <typename TIn>
__global__ void __launch_bounds__(kThreads, 3)
    mlstm_fwd_kernel(const FwdArgs<TIn> a) {
  extern __shared__ __align__(16) float sm[];
  const int T = a.T, B = a.B, H = a.H, hd = a.hd, K = a.K;
  const int jb = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int j = jb * kCols + lane;
  const bool jv = j < hd;
  const int rpt = (hd + kWarps - 1) / kWarps, k0 = w * rpt;
  const int hd1 = hd + 1;
  const size_t st = (size_t)hd * hd1;
  const size_t BH = (size_t)B * H;
  const bool lead = jb == 0;  // the CTA that writes n, m and q.n
  const int nr = k0 + lane;   // the row of n this thread carries, if nv
  const bool nv = lane < rpt && nr < hd;
  float* wrows = sm + kFsRows + w * kFwdS * 2 * kRpt;
  float* part = sm + kFsPart;
  float* nsp = sm + kFsN;
  auto gates = [&](int blk) { return sm + kFsGates + (blk % 3) * kFwdS * 8; };
  auto srow = [&](int t) { return ((size_t)t * B + b) * H + hh; };

  // block blk's inputs into its ring half, warp w copying step w: the q
  // and k rows and v of the CTA's columns
  const int es = (int)sizeof(TIn);
  auto issue = [&](int blk) {
    const int t = blk * kFwdS + w;
    if (t < T) {
      float* d = sm + (blk & 1) * kFwdRing;
      const size_t o = srow(t) * hd;
      stage_run_warp(d + kFrQ + w * kMaxHd * es / 4, a.q + o, hd * es, a.words, lane);
      stage_run_warp(d + kFrK + w * kMaxHd * es / 4, a.k + o, hd * es, a.words, lane);
      stage_run_warp(d + kFrV + w * kCols * es / 4, a.v + o + jb * kCols,
                     min(kCols, hd - jb * kCols) * es, a.words, lane);
    }
  };
  // f, i and upd of block blk's steps, a lane of warp 0 a step, into
  // registers: warp 0 forms the block's gates a block ahead of its steps
  float nf = 0.f, ni = 0.f, nu = 0.f;
  auto gates_in = [&](int blk) {
    const int t = blk * kFwdS + lane;
    nf = ni = nu = 0.f;
    if (lane < kFwdS && t < T) {
      nf = a.fpre[srow(t)];
      ni = a.ipre[srow(t)];
      nu = (a.upd == nullptr || a.upd[(size_t)t * B + b]) ? 1.f : 0.f;
    }
  };
  issue(0);  // the first block's inputs in flight while the state loads
  cp_async_commit();
  if (w == 0) gates_in(0);

  float C[kRpt];
  const float* src = a.cn0 + bh * st;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int kk = k0 + r;
    C[r] = (r < rpt && kk < hd && jv) ? src[(size_t)kk * hd1 + j] : 0.f;
  }
  float n = nv ? src[(size_t)nr * hd1 + hd] : 0.f;
  float m = a.m0[bh];  // the stabilizer: warp 0 steps it a block ahead

  auto put = [&](float* dst, float* mdst, float mv, int rs) {  // rows rs apart
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const int kk = k0 + r;
      if (r < rpt && kk < hd && jv) dst[(size_t)kk * rs + j] = C[r];
    }
    if (lead && nv) dst[(size_t)nr * rs + hd] = n;
    if (lead && tid == 0) *mdst = mv;
  };
  // index t1 of the (B, T+1, H, ...) stage, rows a.srs apart: where hd is
  // a multiple of 8, the n column goes out with its row's pad as whole
  // sectors, 8 lanes a row
  auto staged = [&](int t1, float mv) {
    const size_t o = ((size_t)b * (T + 1) + t1) * H + hh;
    float* dst = a.cn_out + o * hd * a.srs;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const int kk = k0 + r;
      if (r < rpt && kk < hd && jv) dst[(size_t)kk * a.srs + j] = C[r];
    }
    if (lead && hd % 8 == 0) {
#pragma unroll
      for (int i = 0; i < kRpt / 4; ++i) {
        const int rr = 4 * i + lane / 8;
        const float x = __shfl_sync(0xffffffffu, n, rr);
        if (rr < rpt && k0 + rr < hd)
          dst[(size_t)(k0 + rr) * a.srs + hd + lane % 8] = lane % 8 ? 0.f : x;
      }
    } else if (lead && nv) {
      dst[(size_t)nr * a.srs + hd] = n;
    }
    if (lead && tid == 0) a.m_out[o] = mv;
  };
  const int oat = a.collect ? T : a.out_at[b];
  if (a.collect)
    staged(0, m);
  else if (oat < 0)
    put(a.cn_out + bh * st, a.m_out + bh, m, hd1);

  // block blk's gates by warp 0 (f, i, upd in its lanes' registers): log
  // sigmoid(f) a lane a step, the stabilizer's chain through the block's
  // steps, then fg, ig and exp(-m_new) a lane a step, as gate() forms them
  auto form_gates = [&](int blk) {
    const float ls = log_sigmoid(nf);
    float mc = m, a_l = 0.f, mn_l = 0.f, mp_l = 0.f, ma_l = 0.f;
#pragma unroll
    for (int s = 0; s < kFwdS; ++s) {
      const float ga = __shfl_sync(0xffffffffu, ls, s) + mc;
      const float gi = __shfl_sync(0xffffffffu, ni, s);
      const bool us = __shfl_sync(0xffffffffu, nu, s) != 0.f;
      const float mx = fmaxf(ga, gi);
      const float mn = isfinite(mx) ? mx : gi;
      if (lane == s) {
        a_l = ga;
        mn_l = mn;
        mp_l = mc;
      }
      if (us) mc = mn;
      if (lane == s) ma_l = mc;
    }
    m = mc;
    if (lane < kFwdS) {
      float* g = gates(blk) + lane * 8;
      g[0] = isfinite(mp_l) ? expf(a_l - mn_l) : 0.f;
      g[1] = expf(ni - mn_l);
      g[2] = nu;
      g[3] = mp_l;
      g[4] = ma_l;
      g[5] = expf(-mn_l);
    }
  };
  // the read of block pblk's steps, warp w folding step w: the column sums
  // over the warps in order, q.n over the threads (each lane the 8 warps'
  // in order, then a butterfly), then h and q.n written
  auto fold = [&](int pblk) {
    const int pb0 = pblk * kFwdS, pns = min(kFwdS, T - pb0), s = w;
    const int buf = pblk & 1;
    if (s >= pns) return;
    const float* pp = part + (buf * kFwdS + s) * kWarps * kCols + lane;
    float rd = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) rd += pp[i * kCols];
    const float* np_ = nsp + (buf * kFwdS + s) * kThreads + lane;
    float x = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) x += np_[32 * i];
    const float tot = warp_sum(x);
    const float den = fmaxf(fabsf(tot), gates(pblk)[s * 8 + 5]);
    const size_t row = srow(pb0 + s);
    if (jv) a.hout[row * hd + j] = rd / den;
    if (lead && lane == 0 && a.s_hist != nullptr) a.s_hist[row] = tot;
  };

  const int nblk = (T + kFwdS - 1) / kFwdS;
  if (w == 0) {
    form_gates(0);
    if (nblk > 1) gates_in(1);
  }
  int ck = 0;  // the next checkpoint's step
  cp_async_wait<0>();
  __syncthreads();
  for (int blk = 0; blk < nblk; ++blk) {
    const int b0 = blk * kFwdS, ns = min(kFwdS, T - b0), buf = blk & 1;
    if (blk > 0) fold(blk - 1);
    if (blk + 1 < nblk) issue(blk + 1);
    cp_async_commit();
    if (w == 0 && blk + 1 < nblk) {  // the next block's gates
      form_gates(blk + 1);
      if (blk + 2 < nblk) gates_in(blk + 2);
    }
    const float* ring = sm + buf * kFwdRing;
    const TIn* rq = reinterpret_cast<const TIn*>(ring + kFrQ);
    const TIn* rk = reinterpret_cast<const TIn*>(ring + kFrK);
    const TIn* rv = reinterpret_cast<const TIn*>(ring + kFrV);
    // the warp's rows of the block as float: eight at a time from 16-byte
    // loads where whole rows line up (every row of the warp in range, 16
    // bytes apart), else two at a time (zero past its rows and hd)
    constexpr int kV = 16 / sizeof(TIn);  // elements a 16-byte load
    if (rpt == kRpt && k0 + kRpt <= hd && (k0 * sizeof(TIn)) % 16 == 0) {
      for (int e = lane; e < kFwdS * 2 * kRpt / kV; e += 32) {
        const int s = e / (2 * kRpt / kV), rem = e - s * (2 * kRpt / kV);
        const int which = rem / (kRpt / kV), r = kV * (rem - which * (kRpt / kV));
        float y[kV];
        const TIn* x = (which ? rk : rq) + s * kMaxHd + k0 + r;
        const uint4 raw = *reinterpret_cast<const uint4*>(x);
        const TIn* xv = reinterpret_cast<const TIn*>(&raw);
#pragma unroll
        for (int q = 0; q < kV; ++q) y[q] = s < ns ? to_f(xv[q]) : 0.f;
        float4* d = reinterpret_cast<float4*>(wrows + s * 2 * kRpt + which * kRpt + r);
#pragma unroll
        for (int q = 0; q < kV / 4; ++q)
          d[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
      }
    } else {
#pragma unroll
    for (int i = 0; i < kFwdS * kRpt / 32; ++i) {
      const int e = lane + 32 * i;  // the pair (r, r + 1) of q or k at step s
      const int s = e / kRpt, rem = e - s * kRpt;
      const int which = rem / (kRpt / 2), r = 2 * (rem - which * (kRpt / 2));
      const int kk = k0 + r;
      const TIn* x = (which ? rk : rq) + s * kMaxHd + kk;
      const bool v0 = s < ns && r < rpt && kk < hd;
      const bool v1 = s < ns && r + 1 < rpt && kk + 1 < hd;
      float2 y = make_float2(0.f, 0.f);
      if (v1 && (kk & 1) == 0) {
        y = pair_f(x);
      } else {
        if (v0) y.x = to_f(x[0]);
        if (v1) y.y = to_f(x[1]);
      }
      reinterpret_cast<float2*>(wrows)[e] = y;
    }
    }
    __syncwarp();
    const float* g = gates(blk);
    for (int s = 0; s < ns; ++s) {
      const int t = b0 + s;
      const float4 g0 = *reinterpret_cast<const float4*>(g + s * 8);
      if (a.ckpt != nullptr && t == ck) {
        put(a.ckpt + ((size_t)(t / K) * BH + bh) * st,
            a.mck + (t / K) * BH + bh, g0.w, hd1);
        ck += K;
      }
      const float fg = g0.x, ig = g0.y;
      const float vj = jv ? to_f(rv[s * kCols + lane]) : 0.f;
      const float4* q4 = reinterpret_cast<const float4*>(wrows + s * 2 * kRpt);
      const float4* k4 = q4 + kR4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      // the state's rows through the step (kept only where it updates) and
      // their share of the read, in four accumulators; rows past the
      // thread's own are zero and stay zero
      // (a step that does not update forms the same products with the
      // sum's operands swapped: the same bits, and code of its own, not
      // the updating step's with a select an element)
      auto rows = [&](auto keep) {
#pragma unroll
        for (int r4 = 0; r4 < kR4; ++r4) {
          const float4 qq = q4[r4];
          const float qx[4] = {qq.x, qq.y, qq.z, qq.w};
          float kv[4];
          kv4<TIn>(k4[r4], vj, kv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (decltype(keep)::value) {
              const float nw = cell_update(fg, C[4 * r4 + e], ig, kv[e]);
              acc[e] = fmaf(qx[e], nw, acc[e]);
              C[4 * r4 + e] = nw;
            } else {
              const float nw =
                  __fadd_rn(__fmul_rn(ig, kv[e]), __fmul_rn(fg, C[4 * r4 + e]));
              acc[e] = fmaf(qx[e], nw, acc[e]);
            }
          }
        }
      };
      const bool u = g0.z != 0.f;
      if (u)
        rows(std::true_type{});
      else
        rows(std::false_type{});
      part[((buf * kFwdS + s) * kWarps + w) * kCols + lane] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
      {  // the n column (k v is k exactly), row nr from the warp's rows
        const float nn = cell_update(fg, n, ig, wrows[s * 2 * kRpt + kRpt + lane % kRpt]);
        const float qn = wrows[s * 2 * kRpt + lane % kRpt] * nn;
        nsp[(buf * kFwdS + s) * kThreads + tid] = nv ? qn : 0.f;
        if (u && nv) n = nn;
      }
      if (a.collect)
        staged(t + 1, g[s * 8 + 4]);
      else if (t == oat)
        put(a.cn_out + bh * st, a.m_out + bh, g[s * 8 + 4], hd1);
    }
    cp_async_wait<0>();
    __syncthreads();  // the block's partials and the next block's gates
                      // are in; the next block has landed
  }
  fold(nblk - 1);
}

// The backward's plan (mlstm_bwd_plan in kernels/xlstm/ops.py):
constexpr int kGroup = 4;  // the walk keeps the state before every kGroup-th step
constexpr int kSub = kGroup;  // steps staged at a time: one group
// scratch floats a CTA keeps a group: the rows ([kR4][kThreads] float4)
// and the n column ([kThreads])
constexpr int kGroupFloats = kR4 * 4 * kThreads + kThreads;
// a staged sub-chunk (floats): q and k rows in the input type (room for
// float), v and dh of the CTA's columns, q.n
constexpr int kStgQ = 0;
constexpr int kStgK = kStgQ + kSub * kMaxHd;
constexpr int kStgV = kStgK + kSub * kMaxHd;
constexpr int kStgDh = kStgV + kSub * kCols;
constexpr int kStgSh = kStgDh + kSub * kCols;
constexpr int kStgFloats = (kStgSh + kSub + 3) / 4 * 4;  // 16-byte aligned
// dynamic shared memory of the backward, in floats: the group's state,
// the cell's adjoint G (a thread's rows, private to it), two of each of
// the staged sub-chunk and the per-warp sums (one being filled while the
// other is read), and the chunk's per-step scalars
constexpr int kSmPa = 0;                                  // [kR4][kThreads] float4
constexpr int kSmPn = kSmPa + kR4 * 4 * kThreads;         // [kThreads]
constexpr int kSmG = kSmPn + kThreads;                    // [kRpt][kThreads]
constexpr int kSmStg = kSmG + kRpt * kThreads;            // [2][kStgFloats]
constexpr int kSmDv = kSmStg + 2 * kStgFloats;            // [2][kSub][kWarps][kCols]
constexpr int kSmRed = kSmDv + 2 * kSub * kWarps * kCols; // [2][kSub][kWarps][2]
constexpr int kSmDmd = kSmRed + 2 * kSub * kWarps * 2;    // [2][kSub]
constexpr int kSmChunk = kSmDmd + 2 * kSub;               // [7][kKmax]
constexpr int kSmFloats = kSmChunk + 7 * kKmax;

// 8 values summed over the warp's 32 lanes, halving the values kept at
// each of three shuffle levels, then two plain levels: lane l ends with
// the sum of value l >> 2, every value's sum in one fixed tree.
__device__ __forceinline__ float transpose_sum8(float (&x)[8], int lane) {
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int o = 16 >> lvl, half = 4 >> lvl;
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = hi ? x[half + i] : x[i];
      const float send = hi ? x[i] : x[half + i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float y = x[0] + __shfl_xor_sync(0xffffffffu, x[0], 2);
  return y + __shfl_xor_sync(0xffffffffu, y, 1);
}

template <typename TIn>
struct BwdArgs {
  const TIn *q, *k, *v;
  const float *ipre, *fpre;
  const bool* upd;
  const float *hs, *s_hist, *ckpt, *mck, *dh, *dcn;
  float *scratch, *dq_part, *dk_part, *dv, *sc_part, *dcn0;
  int T, B, H, hd, K, words;
};

template <typename TIn>
__global__ void __launch_bounds__(kThreads, 3)
    mlstm_bwd_kernel(const BwdArgs<TIn> a) {
  extern __shared__ __align__(16) float sm[];
  float4* pa = reinterpret_cast<float4*>(sm + kSmPa);
  float* pna = sm + kSmPn;
  float* Gs = sm + kSmG + threadIdx.x;  // row r at Gs[r * kThreads]
  float* dvp = sm + kSmDv;
  float* red = sm + kSmRed;
  float* s_dmd = sm + kSmDmd;
  float* s_fg = sm + kSmChunk;  // the chunk's gates
  float* s_ig = s_fg + kKmax;
  float* s_mn = s_ig + kKmax;
  float* s_u = s_mn + kKmax;
  float* s_dot = s_u + kKmax;   // sum_j dh_j h_j (the lead CTA)
  float* s_f = s_dot + kKmax;   // f, i
  float* s_i = s_f + kKmax;
  const int T = a.T, B = a.B, H = a.H, hd = a.hd, K = a.K;
  const int njb = gridDim.x, nq = njb + 1;
  const int jb = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int j = jb * kCols + lane;
  const bool jv = j < hd;
  const int rpt = (hd + kWarps - 1) / kWarps, k0 = w * rpt;
  const int hd1 = hd + 1;
  const size_t st = (size_t)hd * hd1;
  const size_t BH = (size_t)B * H;
  const bool lead = jb == 0;
  const bool nv = tid < hd;
  const int ng = (K + kGroup - 1) / kGroup;
  float* scr = a.scratch + ((size_t)bh * njb + jb) * ng * kGroupFloats;
  auto srow = [&](int t) { return ((size_t)t * B + b) * H + hh; };

  const size_t rstride = (size_t)H * hd;  // elements between one step's rows
  // rows of x (TIn, hd a row) for steps t1.., ns of them, into dst (a
  // kMaxHd stride)
  auto stage_rows = [&](float* dst, const TIn* x, int t1, int ns) {
    stage_runs(dst, kMaxHd * (int)sizeof(TIn), x + srow(t1) * hd,
               (size_t)B * rstride * sizeof(TIn), hd * (int)sizeof(TIn), ns,
               a.words);
  };
  // this CTA's columns of x (TIn or float) for steps t1..: n columns
  // rounded up to the copy's 4 bytes (the rest masked where read)
  auto stage_cols = [&](void* dst, const auto* x, int t1, int ns) {
    const int es = (int)sizeof(*x);
    const int n = min(kCols, hd - jb * kCols);
    stage_runs(dst, kCols * es, x + srow(t1) * hd + jb * kCols,
               (size_t)B * rstride * es, n * es, ns, a.words);
  };
  auto stg = [&](int buf) { return sm + kSmStg + buf * kStgFloats; };

  {
    const float* gsrc = a.dcn + bh * st;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const int kk = k0 + r;
      Gs[r * kThreads] = (r < rpt && kk < hd && jv) ? gsrc[(size_t)kk * hd1 + j] : 0.f;
    }
  }
  float Gn = (lead && nv) ? a.dcn[bh * st + (size_t)tid * hd1 + hd] : 0.f;

  const int nc = (T + K - 1) / K;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, T - t0);
    const int nsub = (len + kSub - 1) / kSub;
    __syncthreads();  // the previous chunk's walk is done with shared memory
    for (int x = tid; x < len; x += kThreads) {
      const size_t row = srow(t0 + x);
      s_f[x] = a.fpre[row];
      s_i[x] = a.ipre[row];
      s_u[x] = (a.upd == nullptr || a.upd[(size_t)(t0 + x) * B + b]) ? 1.f : 0.f;
    }
    if (lead) {  // the steps' sum_j dh_j h_j, a warp every kWarps-th step
      float acc[kKmax / kWarps];
#pragma unroll
      for (int m = 0; m < kKmax / kWarps; ++m) {
        const int x = w + kWarps * m;
        acc[m] = 0.f;
        if (x < len) {
          const size_t row = srow(t0 + x);
          for (int jj = lane; jj < hd; jj += kCols)
            acc[m] += a.dh[row * hd + jj] * a.hs[row * hd + jj];
        }
      }
#pragma unroll
      for (int m = 0; m < kKmax / kWarps; ++m) {
        const float x = warp_sum(acc[m]);
        if (lane == 0 && w + kWarps * m < len) s_dot[w + kWarps * m] = x;
      }
    }
    __syncthreads();
    // the chunk's gates, as gate() forms them: log sigmoid(f) a lane a
    // step, the stabilizer's chain by one thread, fg and ig a lane a step
    if (w == 0)
      for (int x = lane; x < len; x += kCols) s_fg[x] = log_sigmoid(s_f[x]);
    __syncwarp();
    if (tid == 0) {
      float mp = a.mck[(size_t)c * BH + bh];
      for (int x = 0; x < len; ++x) {
        const float ga = s_fg[x] + mp, gi = s_i[x];
        const float mx = fmaxf(ga, gi);
        const float mn = isfinite(mx) ? mx : gi;
        s_fg[x] = ga;
        s_mn[x] = mn;
        s_ig[x] = mp;  // the m before the step, for now
        if (s_u[x] != 0.f) mp = mn;
      }
    }
    __syncthreads();
    for (int x = tid; x < len; x += kThreads) {
      const float mp = s_ig[x], mn = s_mn[x];
      s_fg[x] = isfinite(mp) ? expf(s_fg[x] - mn) : 0.f;
      s_ig[x] = expf(s_i[x] - mn);
      if (lead) a.sc_part[srow(t0 + x) * njb * 4 + 3] = mp;
    }
    // level 1: the chunk from its checkpoint, the state before every
    // kGroup-th step to scratch
    {
      float P[kRpt];
      const float* ck = a.ckpt + ((size_t)c * BH + bh) * st;
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const int kk = k0 + r;
        P[r] = (r < rpt && kk < hd && jv) ? ck[(size_t)kk * hd1 + j] : 0.f;
      }
      float pn = (lead && nv) ? ck[(size_t)tid * hd1 + hd] : 0.f;
      stage_rows(stg(0) + kStgK, a.k, t0, min(kSub, len));
      stage_cols(stg(0) + kStgV, a.v, t0, min(kSub, len));
      cp_async_commit();
      for (int qi = 0; qi < nsub; ++qi) {
        const int q0 = qi * kSub, ns = min(kSub, len - q0);
        cp_async_wait<0>();
        __syncthreads();
        if (qi + 1 < nsub) {
          const int n1 = min(kSub, len - q0 - kSub);
          stage_rows(stg((qi + 1) & 1) + kStgK, a.k, t0 + q0 + kSub, n1);
          stage_cols(stg((qi + 1) & 1) + kStgV, a.v, t0 + q0 + kSub, n1);
        }
        cp_async_commit();
        const TIn* sk = reinterpret_cast<const TIn*>(stg(qi & 1) + kStgK);
        const TIn* sv = reinterpret_cast<const TIn*>(stg(qi & 1) + kStgV);
        {  // the group's first step: its state to scratch
          float4* dst = reinterpret_cast<float4*>(scr + (size_t)qi * kGroupFloats);
#pragma unroll
          for (int r4 = 0; r4 < kR4; ++r4)
            dst[r4 * kThreads + tid] = make_float4(P[4 * r4], P[4 * r4 + 1],
                                                   P[4 * r4 + 2], P[4 * r4 + 3]);
          scr[(size_t)qi * kGroupFloats + kR4 * 4 * kThreads + tid] = pn;
        }
        for (int x = 0; x < ns; ++x) {
          const int sl = q0 + x;
          if (s_u[sl] == 0.f) continue;
          const float fg = s_fg[sl], ig = s_ig[sl];
          const float vj = jv ? to_f(sv[x * kCols + lane]) : 0.f;
          const TIn* kr = sk + x * kMaxHd;
#pragma unroll
          for (int r = 0; r < kRpt; ++r) {
            const int kk = k0 + r;
            if (r < rpt && kk < hd)
              P[r] = cell_step<TIn>(fg, P[r], ig, to_f(kr[kk]), vj);
          }
          if (lead && nv) pn = cell_step<TIn>(fg, pn, ig, to_f(kr[tid]), 1.f);
        }
      }
    }
    // the walk back, a group of kGroup steps at a time: the next group's
    // inputs and state copied while this one is walked
    auto stage_walk = [&](int qi) {
      const int q0 = qi * kSub, ns = min(kSub, len - q0), buf = qi & 1;
      float* d = stg(buf);
      stage_rows(d + kStgQ, a.q, t0 + q0, ns);
      stage_rows(d + kStgK, a.k, t0 + q0, ns);
      stage_cols(d + kStgV, a.v, t0 + q0, ns);
      stage_cols(d + kStgDh, a.dh, t0 + q0, ns);
      if (tid < ns) cp_async4(d + kStgSh + tid, a.s_hist + srow(t0 + q0 + tid));
    };
    // the state before group qi (each thread its own, read by it alone)
    auto fetch_state = [&](int qi) {
      const float* src = scr + (size_t)qi * kGroupFloats;
#pragma unroll
      for (int r4 = 0; r4 < kR4; ++r4)
        cp_async16(pa + r4 * kThreads + tid, src + ((size_t)r4 * kThreads + tid) * 4);
      cp_async4(pna + tid, src + kR4 * 4 * kThreads + tid);
    };
    // dv (this CTA holds every row of its columns) and the gates' sums of
    // a walked group, from the per-warp sums, in a fixed order
    auto flush = [&](int qi) {
      const int q0 = qi * kSub, ns = min(kSub, len - q0), buf = qi & 1;
      if (tid < ns * kCols) {
        const int s = tid / kCols, l = tid % kCols;
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i)
          x += dvp[((buf * kSub + s) * kWarps + i) * kCols + l];
        if (jb * kCols + l < hd) a.dv[srow(t0 + q0 + s) * hd + jb * kCols + l] = x;
      }
      if (tid < ns) {
        float x = 0.f, y = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
          x += red[((buf * kSub + tid) * kWarps + i) * 2];
          y += red[((buf * kSub + tid) * kWarps + i) * 2 + 1];
        }
        float* sp = a.sc_part + (srow(t0 + q0 + tid) * njb + jb) * 4;
        sp[0] = x;
        sp[1] = y;
        sp[2] = lead ? s_dmd[buf * kSub + tid] : 0.f;
      }
    };
    cp_async_wait<0>();
    __syncthreads();  // level 1's scratch and staged rows are done with
    stage_walk(nsub - 1);
    fetch_state(nsub - 1);
    cp_async_commit();
    for (int qi = nsub - 1; qi >= 0; --qi) {
      const int q0 = qi * kSub, ns = min(kSub, len - q0), buf = qi & 1;
      cp_async_wait<0>();
      __syncthreads();
      if (qi + 1 < nsub) flush(qi + 1);
      if (qi > 0) stage_walk(qi - 1);
      cp_async_commit();
      const float* d = stg(buf);
      const TIn* sq = reinterpret_cast<const TIn*>(d + kStgQ);
      const TIn* sk = reinterpret_cast<const TIn*>(d + kStgK);
      const TIn* sv = reinterpret_cast<const TIn*>(d + kStgV);
      const float4* p4 = pa + tid;
      for (int ri = ns - 1; ri >= 0; --ri) {
        const int sl = q0 + ri;
        const size_t row = srow(t0 + sl);
        const float fg = s_fg[sl], ig = s_ig[sl], mn = s_mn[sl];
        const bool u = s_u[sl] != 0.f;
        const float svv = d[kStgSh + ri], e = expf(-mn), sa = fabsf(svv);
        const float den = fmaxf(sa, e);
        const float dr = jv ? d[kStgDh + ri * kCols + lane] / den : 0.f;
        const float vj = jv ? to_f(sv[ri * kCols + lane]) : 0.f;
        float ds = 0.f;
        if (lead) {
          const float dden = -s_dot[sl] / den;
          const float ws = sa > e ? 1.f : (sa < e ? 0.f : 0.5f);
          const float sg = svv > 0.f ? 1.f : (svv < 0.f ? -1.f : 0.f);
          ds = dden * ws * sg;
          if (tid == 0) s_dmd[buf * kSub + ri] = -(dden * (1.f - ws)) * e;
        }
        const TIn* qrow = sq + ri * kMaxHd;
        const TIn* krow = sk + ri * kMaxHd;
        float dfg = 0.f, dig = 0.f, dva = 0.f;
#pragma unroll
        for (int r4 = 0; r4 < kR4; ++r4) {
          if (4 * r4 >= rpt) break;
          const float4 pq = p4[r4 * kThreads];
          float pv[4] = {pq.x, pq.y, pq.z, pq.w};
          for (int ii = 0; ii < ri; ++ii) {  // re-form the steps before
            if (s_u[q0 + ii] == 0.f) continue;
            const float f2 = s_fg[q0 + ii], i2 = s_ig[q0 + ii];
            const float v2 = jv ? to_f(sv[ii * kCols + lane]) : 0.f;
            const TIn* k2 = sk + ii * kMaxHd + k0 + 4 * r4;
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4)
              pv[e4] = cell_step<TIn>(f2, pv[e4], i2, to_f(k2[e4]), v2);
          }
          float x[8];
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int r = 4 * r4 + e4, kk = k0 + r;
            x[e4] = x[4 + e4] = 0.f;
            if (r < rpt && kk < hd) {
              const float p = pv[e4];
              const float kf = to_f(krow[kk]);
              const float kv = round_in<TIn>(kf * vj);
              const float nw = cell_step<TIn>(fg, p, ig, kf, vj);
              const float g0 = Gs[r * kThreads];
              const float gnew = (u ? g0 : 0.f) + to_f(qrow[kk]) * dr;
              dfg += gnew * p;
              dig += gnew * kv;
              const float dkv = ig * gnew;
              dva += dkv * kf;
              x[e4] = nw * dr;
              x[4 + e4] = dkv * vj;
              Gs[r * kThreads] = (u ? 0.f : g0) + fg * gnew;
            }
          }
          const float sum = transpose_sum8(x, lane);
          const int r = 4 * r4 + ((lane >> 2) & 3), kk = k0 + r;
          if (!(lane & 3) && r < rpt && kk < hd)
            (lane < 16 ? a.dq_part : a.dk_part)[(row * nq + jb) * hd + kk] = sum;
        }
        if (lead && nv) {  // the n column, row tid
          float p = pna[tid];
          for (int ii = 0; ii < ri; ++ii)
            if (s_u[q0 + ii] != 0.f)
              p = cell_step<TIn>(s_fg[q0 + ii], p, s_ig[q0 + ii],
                                to_f(sk[ii * kMaxHd + tid]), 1.f);
          const float kf = to_f(krow[tid]);
          const float nn = cell_step<TIn>(fg, p, ig, kf, 1.f);
          const float gnn = (u ? Gn : 0.f) + to_f(qrow[tid]) * ds;
          dfg += gnn * p;
          dig += gnn * kf;
          Gn = (u ? 0.f : Gn) + fg * gnn;
          a.dq_part[(row * nq + njb) * hd + tid] = nn * ds;
          a.dk_part[(row * nq + njb) * hd + tid] = ig * gnn;
        }
        dfg = warp_sum(dfg);
        dig = warp_sum(dig);
        if (lane == 0) {
          red[((buf * kSub + ri) * kWarps + w) * 2] = dfg;
          red[((buf * kSub + ri) * kWarps + w) * 2 + 1] = dig;
        }
        dvp[((buf * kSub + ri) * kWarps + w) * kCols + lane] = dva;
      }
      if (qi > 0) {  // its state read for the last time: the next group's
        fetch_state(qi - 1);
        cp_async_commit();
      }
    }
    __syncthreads();
    flush(0);
  }
  float* gdst = a.dcn0 + bh * st;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int kk = k0 + r;
    if (r < rpt && kk < hd && jv) gdst[(size_t)kk * hd1 + j] = Gs[r * kThreads];
  }
  if (lead && nv) gdst[(size_t)tid * hd1 + hd] = Gn;
}

// The deterministic second pass: CTAs x < gridDim.x - 1 sum dq and dk over
// the nq partial blocks (in order) for tpb steps each; the last CTA of each
// (b, h) walks the stabilizer's chain back over T, a chunk of kKmax steps
// at a time: the gates of every step at once from the m before it (the
// main kernel's), then the scalar adjoint chain by one thread.
__global__ void __launch_bounds__(256) mlstm_bwd_reduce_kernel(
    const float* __restrict__ dq_part, const float* __restrict__ dk_part,
    const float* __restrict__ sc_part, const float* __restrict__ ipre,
    const float* __restrict__ fpre, const bool* __restrict__ upd,
    const float* __restrict__ dm, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ di, float* __restrict__ df,
    float* __restrict__ dm0, int T, int B, int H, int hd, int njb, int tpb) {
  const int bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int ntb = gridDim.x - 1, nq = njb + 1;
  if ((int)blockIdx.x < ntb) {
    const int t0 = blockIdx.x * tpb, t1 = min(T, t0 + tpb);
    for (int idx = threadIdx.x; idx < (t1 - t0) * hd; idx += blockDim.x) {
      const int t = t0 + idx / hd, kk = idx % hd;
      const size_t row = ((size_t)t * B + b) * H + hh;
      const float* x0 = dq_part + row * nq * hd + kk;
      const float* y0 = dk_part + row * nq * hd + kk;
      float x = 0.f, y = 0.f;
      for (int q = 0; q < nq; ++q) {
        x += x0[(size_t)q * hd];
        y += y0[(size_t)q * hd];
      }
      dq[row * hd + kk] = x;
      dk[row * hd + kk] = y;
    }
    return;
  }
  __shared__ float a_[kKmax], i_[kKmax], fg_[kKmax], ig_[kKmax], sgm_[kKmax],
      dfg_[kKmax], dig_[kKmax], dmd_[kKmax];
  __shared__ unsigned char u_[kKmax], fin_[kKmax], mxf_[kKmax];
  float gm = dm[bh];
  for (int c = (T + kKmax - 1) / kKmax - 1; c >= 0; --c) {
    const int t0 = c * kKmax, len = min(kKmax, T - t0);
    for (int s = threadIdx.x; s < len; s += blockDim.x) {
      const int t = t0 + s;
      const size_t row = ((size_t)t * B + b) * H + hh;
      const float* p = sc_part + row * njb * 4;
      const float f = fpre[row], i = ipre[row];
      const Gate g = gate(f, i, p[3]);
      a_[s] = g.a;
      i_[s] = i;
      fg_[s] = g.fg;
      ig_[s] = g.ig;
      sgm_[s] = 1.f / (1.f + expf(f));
      fin_[s] = g.fin;
      mxf_[s] = isfinite(g.mx);
      u_[s] = upd == nullptr || upd[(size_t)t * B + b];
      float x = 0.f, y = 0.f, z = 0.f;
      for (int jb = 0; jb < njb; ++jb) {
        x += p[jb * 4];
        y += p[jb * 4 + 1];
        z += p[jb * 4 + 2];
      }
      dfg_[s] = x;
      dig_[s] = y;
      dmd_[s] = z;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = len - 1; s >= 0; --s) {
        const bool u = u_[s];
        float dmn = (u ? gm : 0.f) + dmd_[s];
        float dii = dig_[s] * ig_[s];
        dmn -= dii;
        float da = fin_[s] ? dfg_[s] * fg_[s] : 0.f;
        dmn -= da;
        if (mxf_[s]) {
          if (a_[s] > i_[s]) {
            da += dmn;
          } else if (a_[s] < i_[s]) {
            dii += dmn;
          } else {
            da += 0.5f * dmn;
            dii += 0.5f * dmn;
          }
        } else {
          dii += dmn;
        }
        const size_t row = ((size_t)(t0 + s) * B + b) * H + hh;
        di[row] = dii;
        df[row] = da * sgm_[s];
        gm = (u ? 0.f : gm) + da;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) dm0[bh] = gm;
}

template <typename TIn>
int launch_fwd(const void* q, const void* k, const void* v, const void* ipre,
               const void* fpre, const void* cn0, const void* m0,
               const void* upd, const void* out_at, void* h, void* cn,
               void* m, void* ckpt, void* mck, void* s, int T, int B, int H,
               int hd, int collect, int K, cudaStream_t st) {
  const size_t smem = (size_t)kFsFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const FwdArgs<TIn> a{(const TIn*)q, (const TIn*)k, (const TIn*)v,
                       (const float*)ipre, (const float*)fpre,
                       (const float*)cn0, (const float*)m0, (const bool*)upd,
                       (const int*)out_at, (float*)h, (float*)cn, (float*)m,
                       (float*)ckpt, (float*)mck, (float*)s, T, B, H, hd,
                       collect, K > 0 ? K : 1,
                       (hd * (int)sizeof(TIn)) % 4 == 0 &&
                           (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) &
                            3) == 0,
                       collect ? staged_row(hd) : hd + 1};
  dim3 grid((hd + kCols - 1) / kCols, B * H);
  mlstm_fwd_kernel<TIn><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_bwd(const void* q, const void* k, const void* v, const void* ipre,
               const void* fpre, const void* upd, const void* hs,
               const void* s, const void* ckpt, const void* mck,
               const void* dh, const void* dcn, const void* dm,
               void* scratch, void* dq_part, void* dk_part, void* sc_part,
               void* dq, void* dk, void* dv, void* di, void* df, void* dcn0,
               void* dm0, int T, int B, int H, int hd, int K,
               cudaStream_t st) {
  const int njb = (hd + kCols - 1) / kCols;
  const size_t smem = (size_t)kSmFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const BwdArgs<TIn> a{(const TIn*)q, (const TIn*)k, (const TIn*)v,
                       (const float*)ipre, (const float*)fpre,
                       (const bool*)upd, (const float*)hs, (const float*)s,
                       (const float*)ckpt, (const float*)mck,
                       (const float*)dh, (const float*)dcn, (float*)scratch,
                       (float*)dq_part, (float*)dk_part, (float*)dv,
                       (float*)sc_part, (float*)dcn0, T, B, H, hd, K,
                       (hd * (int)sizeof(TIn)) % 4 == 0 &&
                           (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                             (uintptr_t)dh) & 3) == 0};
  mlstm_bwd_kernel<TIn><<<dim3(njb, B * H), kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tpb = 16;
  const int ntb = (T + tpb - 1) / tpb;
  mlstm_bwd_reduce_kernel<<<dim3(ntb + 1, B * H), 256, 0, st>>>(
      (const float*)dq_part, (const float*)dk_part, (const float*)sc_part,
      (const float*)ipre, (const float*)fpre, (const bool*)upd,
      (const float*)dm, (float*)dq, (float*)dk, (float*)di, (float*)df,
      (float*)dm0, T, B, H, hd, njb, tpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mlstm_fwd(const void* q, const void* k, const void* v,
                         const void* ipre, const void* fpre, const void* cn0,
                         const void* m0, const void* upd, const void* out_at,
                         void* h, void* cn, void* m, void* ckpt, void* mck,
                         void* s, int T, int B, int H, int hd, int bf16,
                         int collect, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd > kWarps * kRpt || K > kKmax) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, ipre, fpre, cn0, m0, upd,
                                          out_at, h, cn, m, ckpt, mck, s, T,
                                          B, H, hd, collect, K, st)
              : launch_fwd<float>(q, k, v, ipre, fpre, cn0, m0, upd, out_at,
                                  h, cn, m, ckpt, mck, s, T, B, H, hd,
                                  collect, K, st);
}

// the staged states' row stride (collect; the layout the wrapper allocates)
extern "C" int mlstm_staged_row(int hd) { return staged_row(hd); }

// the backward's group size (the scratch layout the wrapper allocates)
extern "C" int mlstm_bwd_layout() { return kGroup; }

extern "C" int mlstm_bwd(const void* q, const void* k, const void* v,
                         const void* ipre, const void* fpre, const void* upd,
                         const void* hs, const void* s, const void* ckpt,
                         const void* mck, const void* dh, const void* dcn,
                         const void* dm, void* scratch, void* dq_part,
                         void* dk_part, void* sc_part, void* dq, void* dk,
                         void* dv, void* di, void* df, void* dcn0, void* dm0,
                         int T, int B, int H, int hd, int bf16, int K,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd > kWarps * kRpt || K < 1 || K > kKmax)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch_bwd<__nv_bfloat16>(
                    q, k, v, ipre, fpre, upd, hs, s, ckpt, mck, dh, dcn, dm,
                    scratch, dq_part, dk_part, sc_part, dq, dk, dv, di, df,
                    dcn0, dm0, T, B, H, hd, K, st)
              : launch_bwd<float>(q, k, v, ipre, fpre, upd, hs, s, ckpt, mck,
                                  dh, dcn, dm, scratch, dq_part, dk_part,
                                  sc_part, dq, dk, dv, di, df, dcn0, dm0, T,
                                  B, H, hd, K, st);
}
