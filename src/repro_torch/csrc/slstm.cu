// sLSTM recurrence of xLSTM (arXiv:2405.04517): forward and backward
// kernels for sm_90a, plain C entries loaded with ctypes
// (kernels/xlstm/ops.py).
//
// Replaces: no pallas_call. The JAX package steps the recurrence as one
// compiled jax.lax.scan (src/repro/models/layers.py:930, apply_slstm) and
// differentiates that scan for training; the port stepped T in a Python
// loop of eager launches. Plain versions: kernels/xlstm/ref.py
// (slstm_scan_ref, slstm_scan_bwd_ref).
//
// The recurrence, per head h, batch row b and step t (every element of
// the hd-wide state has its own stabilizer m):
//   z = tanh(z_t + h_{t-1} R_h)        (R_h hd x hd, float32)
//   m_new = max(log sigmoid(f_t) + m, i_t)  (i_t where not finite)
//   fg = exp(log sigmoid(f_t) + m - m_new) (0 while m is -inf),
//   ig = exp(i_t - m_new)
//   c = fg c + ig z,  n = fg n + ig,  h = (o_t c) / max(n, 1e-6)
//   c, n, h, m advance only where the step updates; the output is h.
//
// Bound: operations. A step's product h R is hd multiply-adds an element
// against a handful of bytes it must move (z, i, f, o in, h out: 20 B an
// element), ~19 operations a byte at hd 192: the float32 rate bounds it,
// and in practice the latency of T sequential steps. Counted once each,
// an element's step is 2 hd + 18 operations: h R (2 hd), z_t + it and
// tanh (2), the stabilizer (log sigmoid, + m, the max, the guard, two
// differences and two exp: 8), c and n (5), h = o c / max(n, 1e-6) (3).
// The backward's is 6 hd + 45: the step recomputed (2 hd + 18), g = g_h
// + dhs (1), da = g / den and do (2), dc (2), dn (den², g o c, the
// quotient, the sum: 4), dfg (3), dig (2), dz_in = dc ig (1 - z²) (4),
// di = dig ig, the two subtractions from dm_new, da = dfg fg and the
// max's split (5), df = da sigmoid(-f) (2), the carries fg dc, fg dn
// (2), dh_{t-1} = dz R^T (2 hd) and dR's share (2 hd).
//
// Design of the forward (slstm_fwd_kernel). A step of one row is hd dot
// products of length hd that all read h_{t-1}, then the gates and the
// state: its latency is one dot product, the update and a barrier. A
// CTA steps a head for rb batch rows (the fewest that keep the grid in
// one wave: 1 at the verify and training shapes, up to 4). p threads
// (8 up to hd 192, split_of) share a group of c output columns (4; 2
// above hd 192), each over a contiguous slice of len k's (hd / p rounded
// up to a float4): its slices of the c columns of R_h stay in registers
// for the whole launch (96 floats at hd 192, read once, each warp's loads
// whole 32-byte sectors), so a step reads only h_{t-1}, as float4
// broadcasts from shared memory (slices padded by 4 floats: no bank
// conflicts), each load serving c columns. Four accumulators a column and float4 keep
// 16 chains of 6 fmaf in flight at hd 192; the slices meet in a
// butterfly of shuffles over the p lanes, whose fixed tree gives every
// lane every sum, the same bits on every run. Each (column, row) pair's
// state, gates and writes are one lane's. z, i, f and o arrive a block
// of 8 steps ahead (4 at rb 4), copied by the whole CTA with 16-byte
// cp.async into the other half of a two-block ring; the stabilizer's
// chain needs f, i and upd but not h, so at a block's first step each
// owner forms fg, ig and m for the block's steps at once (8 chains'
// worth of independent work) into the ring, and a step's own work after
// the product is tanh, c, n and one division. h_t is exchanged
// double-buffered: one __syncthreads a step. The state out is written
// once (after out_at[b]), or after every step with collect; under
// autograd [c, n, m] every K steps (h_{t-1} is the output). The product's
// order lives in slice_dot and butterfly, which the backward's recompute
// of z calls too.
//
// The backward runs three passes, each the same sums from run to run.
// slstm_bwd_rec_kernel recomputes the forward's z for every (t, b) at
// once: h_{t-1} is the forward's output, so no product waits on another;
// it is the forward's split (R's column slices in registers, slice_dot
// and butterfly, 4 rows at a time, the rows a block ahead by cp.async),
// so z is the forward's bit for bit, and it fills the card (a head's (t,
// b) rows in n_sm / H ranges). z goes into dz's buffer. slstm_bwd_kernel
// walks T in reverse a chunk of K steps at a time, a CTA a head and group
// of rb rows (the forward's rule), in the forward's thread layout: p
// threads a group of c outputs, each over a slice of R's rows held in
// registers (R^T's columns, float4 loads once a launch). A chunk first
// runs its chain forward from the [c, n, m] checkpoint, each owner its
// elements, z from dz's buffer, the loads kChainAhead steps ahead: c and
// n before each step, z, fg, ig, the max's case and sigmoid(-f) into
// scratch (kBwdFields floats an element a step). The walk back then forms
// no gate: a step's scratch, o and dhs come a step ahead in registers,
// the owners form the adjoint (the stabilizer's rules as
// slstm_scan_bwd_ref has them: a tie splits the max's adjoint half and
// half, m = -inf, the 1e-6 guard) and put dz_t in a double-buffered
// shared row, and after one __syncthreads every thread forms its slices
// of dh_{t-1} = dz_t R^T from float4 broadcasts, met by the butterfly.
// dR = sum over (t, b) of h_{t-1} (x) dz crosses CTAs: slstm_dr_kernel
// sums a 64 x 64 tile of a head over one of dr_splits fixed ranges of
// rows p = t B + b (4 x 4 outputs a thread, 32 rows staged at a time by
// cp.async, each output in row order), and slstm_dr_sum_kernel adds the
// ranges in order. Nothing is divided back out of the recurrence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;   // most batch rows a CTA steps
constexpr int kKmax = 64;  // most steps between checkpoints

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(0.f, x) - log1pf(expf(-fabsf(x)));
}

struct Gate {
  float a, mx, mn, fg, ig;
  bool fin;
};

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

__device__ __forceinline__ float lerp_rn(float fg, float p, float ig,
                                         float x) {
  return __fadd_rn(__fmul_rn(fg, p), __fmul_rn(ig, x));
}

// The forward's split of a dot product over k: p threads a group of c
// output columns, each over a slice of len k's (a multiple of 4; zero
// past hd): 8 threads a group of 4 columns up to hd 192, 4 threads a
// pair above.
struct Split {
  int p, c, len;
};

__host__ __device__ inline Split split_of(int hd) {
  const int p = hd <= 192 ? 8 : 4, c = hd <= 192 ? 4 : 2;
  return {p, c, ((hd + p - 1) / p + 3) / 4 * 4};
}

// One row's slice of a split product: this thread's slice of x (float4s
// in shared memory) times its c columns' slices of a matrix held in
// registers, by fmaf into four accumulators a column, combined (a0 + a1)
// + (a2 + a3). With butterfly() it is the order of every split product
// here: the forward's h_{t-1} R_h and the backward's recompute of it (so
// the backward's z is the forward's bit for bit), and dz_t R_h^T.
template <int NV, int C>
__device__ __forceinline__ void slice_dot(const float4* x4,
                                          const float4 (&M)[C][NV], int nv,
                                          float (&out)[C]) {
  float a0[C], a1[C], a2[C], a3[C];
#pragma unroll
  for (int cc = 0; cc < C; ++cc) a0[cc] = a1[cc] = a2[cc] = a3[cc] = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v < nv) {
      const float4 x = x4[v];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        a0[cc] = fmaf(x.x, M[cc][v].x, a0[cc]);
        a1[cc] = fmaf(x.y, M[cc][v].y, a1[cc]);
        a2[cc] = fmaf(x.z, M[cc][v].z, a2[cc]);
        a3[cc] = fmaf(x.w, M[cc][v].w, a3[cc]);
      }
    }
  }
#pragma unroll
  for (int cc = 0; cc < C; ++cc) out[cc] = (a0[cc] + a1[cc]) + (a2[cc] + a3[cc]);
}

// The slices' sums met over the P lanes of a group by shuffles, slice l
// plus slice l + o for o = P/2, ..., 1: a fixed tree that gives every lane
// every sum, the same bits on every run.
template <int P, int R, int N>
__device__ __forceinline__ void butterfly(float (&x)[R][N]) {
#pragma unroll
  for (int o = P / 2; o >= 1; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[r][i] = x[r][i] + __shfl_xor_sync(0xffffffffu, x[r][i], o);
  }
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

// steps of z, i, f, o a block of the forward's input ring (two blocks:
// one read while the next is copied), and the fields a step: z, i then
// ig, f then fg, o, the m after the step, upd
__host__ __device__ constexpr int ring_block(int RB) { return RB <= 2 ? 8 : 4; }
constexpr int kFields = 6;

struct FwdArgs {
  const float *zin, *iin, *fin, *osig, *R, *cnh0, *m0;
  const bool* upd;
  const int* out_at;
  float *hs, *cnh_out, *m_out, *ckpt;
  int T, B, H, hd, rb, collect, K, vec;
};

// dynamic shared memory of the forward: h_{t-1} double-buffered ([2][RB]
// [p][len + 4]) and the ring ([2][block][kFields][RB][hd])
__host__ __device__ inline size_t fwd_smem_floats(int hd, int RB) {
  const Split sp = split_of(hd);
  return (size_t)2 * RB * sp.p * (sp.len + 4) +
         (size_t)2 * ring_block(RB) * kFields * RB * hd;
}

// NV float4s of a slice at most, P threads a group of C columns, RB rows
// a CTA at most (the launch's rb <= RB)
template <int NV, int P, int C, int RB>
__global__ void __launch_bounds__(NV * 4 * P * P / C, 1)
    slstm_fwd_kernel(const FwdArgs a) {
  constexpr int NQ = C * RB;              // (column, row) pairs a group
  constexpr int RPL = (NQ + P - 1) / P;   // pairs a lane owns
  constexpr int BLK = ring_block(RB);
  extern __shared__ __align__(16) float sm[];
  const int hd = a.hd, T = a.T, B = a.B, H = a.H;
  const Split sp = split_of(hd);
  const int L = sp.len, nv = L / 4, SS = L + 4;
  float* hb = sm;                      // [2][RB][P][SS]
  float* ring = sm + 2 * RB * P * SS;  // [2][BLK][kFields][RB][hd]
  const int tid = threadIdx.x, s = tid % P, cp = tid / P;  // slice, column group
  const int hh = blockIdx.y, b0 = blockIdx.x * a.rb;
  const int nb = min(a.rb, B - b0);
  const size_t HBd = (size_t)H * B * hd;
  for (int x = tid; x < 2 * RB * P * SS; x += blockDim.x) hb[x] = 0.f;
  float4 Rr[C][NV];  // R_h[s L + 4v + e][C cp + c]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jc = C * cp + c;
    const float* Rg = a.R + (size_t)hh * hd * hd + jc;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = s * L + 4 * v + q;
        e[q] = (jc < hd && v < nv && k < hd) ? Rg[(size_t)k * hd] : 0.f;
      }
      Rr[c][v] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  // the inputs of steps t1.. (a block) into ring buffer buf, by the CTA
  auto issue = [&](int t1, int buf) {
    const int n = min(BLK, T - t1), row = nb * hd;
    const int per = a.vec ? 4 : 1, nw = row / per;
    for (int e = tid; e < n * 4 * nw; e += blockDim.x) {
      const int sf = e / nw, wi = e - sf * nw, st = sf >> 2, f = sf & 3;
      const float* base = f == 0 ? a.zin : f == 1 ? a.iin : f == 2 ? a.fin : a.osig;
      const float* src = base + ((size_t)(t1 + st) * H + hh) * B * hd + (size_t)b0 * hd + wi * per;
      float* dst = ring + ((size_t)(buf * BLK + st) * kFields + f) * RB * hd + wi * per;
      if (a.vec)
        cp_async16(dst, src);
      else
        cp_async4(dst, src);
    }
    cp_async_commit();
  };
  issue(0, 0);
  float c[RPL], n[RPL], h[RPL], m[RPL];
  int oat[RPL], jo[RPL], ro[RPL], hsl[RPL];
  bool own[RPL];
  auto put = [&](float* dst, size_t cs, float* mdst, size_t o, int i) {
    dst[o] = c[i];
    dst[cs + o] = n[i];
    dst[2 * cs + o] = h[i];
    mdst[o] = m[i];
  };
  auto staged = [&](int t1, int i) {
    const size_t o = (((size_t)t1 * H + hh) * B + b0 + ro[i]) * hd + jo[i];
    put(a.cnh_out, (size_t)(T + 1) * HBd, a.m_out, o, i);
  };
  __syncthreads();  // hb zeroed before the owners write h_0
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = s + P * i;
    ro[i] = q / C;
    jo[i] = C * cp + q % C;
    hsl[i] = ro[i] * P * SS + (jo[i] / L) * SS + jo[i] % L;  // h's place
    own[i] = q < NQ && jo[i] < hd && ro[i] < nb;
    c[i] = n[i] = h[i] = m[i] = 0.f;
    oat[i] = -1;
    if (!own[i]) continue;
    const int b = b0 + ro[i];
    const size_t o = ((size_t)hh * B + b) * hd + jo[i];
    c[i] = a.cnh0[o];
    n[i] = a.cnh0[HBd + o];
    h[i] = a.cnh0[2 * HBd + o];
    m[i] = a.m0[o];
    oat[i] = a.collect ? T : a.out_at[b];
    hb[hsl[i]] = h[i];
    if (a.collect)
      staged(0, i);
    else if (oat[i] < 0)
      put(a.cnh_out, HBd, a.m_out, o, i);
  }
  cp_async_wait<0>();
  __syncthreads();
  const int fs = RB * hd;  // between a step's fields in the ring
  for (int t = 0; t < T; ++t) {
    const int buf = (t / BLK) & 1, st = t % BLK;
    if (st == 0) {
      if (t + BLK < T) issue(t + BLK, buf ^ 1);
      // the block's gates: the stabilizer's chain needs f, i and upd, not
      // h, so each owner forms fg, ig and m for the block's steps at once
      const int nbk = min(BLK, T - t);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        if (!own[i]) continue;
        bool uu[BLK];
#pragma unroll
        for (int q = 0; q < BLK; ++q)
          uu[q] = q < nbk && (a.upd == nullptr || a.upd[(size_t)(t + q) * B + b0 + ro[i]]);
        float mm = m[i];
#pragma unroll
        for (int q = 0; q < BLK; ++q) {
          if (q >= nbk) break;
          float* rs = ring + ((size_t)(buf * BLK + q) * kFields) * fs + ro[i] * hd + jo[i];
          const Gate g = gate(rs[2 * fs], rs[fs], mm);
          if (uu[q]) mm = g.mn;
          rs[fs] = g.ig;
          rs[2 * fs] = g.fg;
          rs[4 * fs] = mm;
          rs[5 * fs] = uu[q] ? 1.f : 0.f;
        }
      }
    }
    const float* hp = hb + (t & 1) * RB * P * SS;
    float* hn = hb + ((t + 1) & 1) * RB * P * SS;
    float rec[RB][C];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      slice_dot<NV, C>(reinterpret_cast<const float4*>(hp + (r * P + s) * SS),
                       Rr, nv, rec[r]);
    butterfly<P>(rec);
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      if (!own[i]) continue;
      const int q = s + P * i, b = b0 + ro[i];
      float rr = rec[0][0];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          if (C * r + cc == q) rr = rec[r][cc];
      const size_t hbo = ((size_t)hh * B + b) * hd + jo[i];
      if (a.ckpt != nullptr && t % a.K == 0) {
        float* ck = a.ckpt + (size_t)(t / a.K) * 3 * HBd + hbo;
        ck[0] = c[i];
        ck[HBd] = n[i];
        ck[2 * HBd] = m[i];
      }
      const float* rs = ring + ((size_t)(buf * BLK + st) * kFields) * fs + ro[i] * hd + jo[i];
      const float z = tanhf(rs[0] + rr);
      if (rs[5 * fs] != 0.f) {
        const float fg = rs[2 * fs], ig = rs[fs];
        c[i] = lerp_rn(fg, c[i], ig, z);
        n[i] = __fadd_rn(__fmul_rn(fg, n[i]), ig);
        h[i] = __fmul_rn(rs[3 * fs], c[i]) / fmaxf(n[i], 1e-6f);
        m[i] = rs[4 * fs];
      }
      a.hs[(size_t)t * HBd + hbo] = h[i];
      hn[hsl[i]] = h[i];
      if (a.collect)
        staged(t + 1, i);
      else if (t == oat[i])
        put(a.cnh_out, HBd, a.m_out, hbo, i);
    }
    if (st == BLK - 1) cp_async_wait<0>();  // the next block has landed
    __syncthreads();
  }
}

template <int NV, int P, int C, int RB>
int launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t smem = fwd_smem_floats(a.hd, RB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_fwd_kernel<NV, P, C, RB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((a.hd + C - 1) / C * P + 31) / 32 * 32;
  dim3 grid((a.B + a.rb - 1) / a.rb, a.H);
  slstm_fwd_kernel<NV, P, C, RB><<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NV, int P, int C>
int fwd_rows(const FwdArgs& a, cudaStream_t st) {
  if (a.rb == 1) return launch_fwd<NV, P, C, 1>(a, st);
  if (a.rb == 2) return launch_fwd<NV, P, C, 2>(a, st);
  return launch_fwd<NV, P, C, 4>(a, st);
}

__host__ __device__ inline long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ inline long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// The backward's recompute of the forward's z: z_t = tanh(z_in + h_{t-1}
// R_h) for every (t, b) of a head at once (h_{t-1} is the forward's
// output, so no step waits on another), split as the forward splits it
// (R's column slices in registers, slice_dot and butterfly: the forward's
// z bit for bit) over kRecRows rows at a time, the rows copied a block
// ahead by cp.async into the other half of a two-block ring. z is written
// into dz's buffer, which the walk reads it from a chunk at a time before
// it writes dz there.
constexpr int kRecRows = 4;              // rows a product takes at once
constexpr int kRecBlock = 2 * kRecRows;  // rows a ring half

__host__ __device__ inline size_t rec_smem_floats(int hd) {
  const Split sp = split_of(hd);
  return (size_t)2 * kRecBlock * (sp.p * (sp.len + 4) + hd);
}

template <int NV, int P, int C>
__global__ void __launch_bounds__(NV * 4 * P * P / C, 1)
    slstm_bwd_rec_kernel(const float* __restrict__ zin,
                         const float* __restrict__ R,
                         const float* __restrict__ h0,
                         const float* __restrict__ hs, float* __restrict__ zout,
                         int T, int B, int H, int hd, int vec) {
  constexpr int NQ = C * kRecRows;
  constexpr int RPL = (NQ + P - 1) / P;
  extern __shared__ __align__(16) float sm[];
  const Split sp = split_of(hd);
  const int L = sp.len, nv = L / 4, SS = L + 4;
  float* hb = sm;                                // [2][kRecBlock][P][SS]
  float* zb = sm + 2 * kRecBlock * P * SS;       // [2][kRecBlock][hd]
  const int tid = threadIdx.x, s = tid % P, cp = tid / P;
  const int hh = blockIdx.y;
  const long long rows = (long long)T * B;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long p_begin = blockIdx.x * per, p_end = lmin(rows, p_begin + per);
  if (p_begin >= p_end) return;
  for (int x = tid; x < 2 * kRecBlock * P * SS; x += blockDim.x) hb[x] = 0.f;
  float4 Rr[C][NV];  // R_h[s L + 4v + e][C cp + c], as the forward holds it
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jc = C * cp + c;
    const float* Rg = R + (size_t)hh * hd * hd + jc;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = s * L + 4 * v + q;
        e[q] = (jc < hd && v < nv && k < hd) ? Rg[(size_t)k * hd] : 0.f;
      }
      Rr[c][v] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  int ro[RPL], jo[RPL];
  bool own[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = s + P * i;
    ro[i] = q / C;
    jo[i] = C * cp + q % C;
    own[i] = q < NQ && jo[i] < hd;
  }
  auto hrow = [&](long long p) {  // h_{t-1} of row p = t B + b
    const long long t = p / B, b = p - t * B;
    return t == 0 ? h0 + ((size_t)hh * B + b) * hd
                  : hs + (((size_t)(t - 1) * H + hh) * B + b) * hd;
  };
  auto zrow = [&](long long p) {
    const long long t = p / B, b = p - t * B;
    return (((size_t)t * H + hh) * B + b) * hd;
  };
  // rows pb.. into ring half buf: h_{t-1} into the padded slices, z_in
  auto issue = [&](long long pb, int buf) {
    const int n = (int)lmin(kRecBlock, p_end - pb);
    if (vec) {
      const int W = hd / 4;
      for (int e = tid; e < n * W; e += blockDim.x) {
        const int r = e / W, k = 4 * (e - r * W);
        cp_async16(hb + ((buf * kRecBlock + r) * P + k / L) * SS + k % L,
                   hrow(pb + r) + k);
        cp_async16(zb + (buf * kRecBlock + r) * hd + k, zin + zrow(pb + r) + k);
      }
    } else {
      for (int e = tid; e < n * hd; e += blockDim.x) {
        const int r = e / hd, k = e - r * hd;
        cp_async4(hb + ((buf * kRecBlock + r) * P + k / L) * SS + k % L,
                  hrow(pb + r) + k);
        cp_async4(zb + (buf * kRecBlock + r) * hd + k, zin + zrow(pb + r) + k);
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // hb zeroed before the copies land
  const int nblk = (int)((p_end - p_begin + kRecBlock - 1) / kRecBlock);
  issue(p_begin, 0);
  cp_async_wait<0>();
  __syncthreads();
  for (int blk = 0; blk < nblk; ++blk) {
    const long long pb = p_begin + (long long)blk * kRecBlock;
    const int buf = blk & 1;
    if (blk + 1 < nblk) issue(pb + kRecBlock, buf ^ 1);
#pragma unroll
    for (int it = 0; it < kRecBlock / kRecRows; ++it) {
      const int r0 = it * kRecRows;
      float rec[kRecRows][C];
#pragma unroll
      for (int r = 0; r < kRecRows; ++r)
        slice_dot<NV, C>(reinterpret_cast<const float4*>(
                             hb + ((buf * kRecBlock + r0 + r) * P + s) * SS),
                         Rr, nv, rec[r]);
      butterfly<P>(rec);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const long long p = pb + r0 + ro[i];
        if (!own[i] || p >= p_end) continue;
        const int q = s + P * i;
        float rr = rec[0][0];
#pragma unroll
        for (int r = 0; r < kRecRows; ++r)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
            if (C * r + cc == q) rr = rec[r][cc];
        zout[zrow(p) + jo[i]] =
            tanhf(zb[(buf * kRecBlock + r0 + ro[i]) * hd + jo[i]] + rr);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next block has landed; this one is read
  }
}

// The walk back (slstm_bwd_kernel). Scratch a chunk keeps for each element
// and step: c and n before the step, z, fg, ig, the max's code (0: log
// sigmoid(f) + m won, 1: i won, 2: a tie, 3: the max not finite; +4 where
// the m before the step is not finite) and sigmoid(-f).
constexpr int kBwdFields = 7;
constexpr int kChainAhead = 4;  // steps the chain's loads run ahead

struct BwdArgs {
  const float *iin, *fin, *osig, *R, *ckpt, *dhs, *dcnh, *dm;
  const bool* upd;
  float *scratch, *dz, *di, *df, *dout, *dcnh0, *dm0;
  int T, B, H, hd, rb, K, vec;
};

// dynamic shared memory of the walk: dz_t double-buffered, [2][RB][P][len + 4]
__host__ __device__ inline size_t bwd_smem_floats(int hd, int RB) {
  const Split sp = split_of(hd);
  return (size_t)2 * RB * sp.p * (sp.len + 4);
}

template <int NV, int P, int C, int RB>
__global__ void __launch_bounds__(NV * 4 * P * P / C, 1)
    slstm_bwd_kernel(const BwdArgs a) {
  constexpr int NQ = C * RB;
  constexpr int RPL = (NQ + P - 1) / P;
  extern __shared__ __align__(16) float sm[];
  const int hd = a.hd, T = a.T, B = a.B, H = a.H, K = a.K;
  const Split sp = split_of(hd);
  const int L = sp.len, nv = L / 4, SS = L + 4;
  float* db = sm;  // [2][RB][P][SS]
  const int tid = threadIdx.x, s = tid % P, cp = tid / P;
  const int hh = blockIdx.y, b0 = blockIdx.x * a.rb;
  const int nb = min(a.rb, B - b0);
  const size_t HBd = (size_t)H * B * hd;
  const size_t F = (size_t)a.rb * hd;  // between two fields of a step's scratch
  float* scr = a.scratch +
               ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * K * kBwdFields * F;
  for (int x = tid; x < 2 * RB * P * SS; x += blockDim.x) db[x] = 0.f;
  // R^T's column slices: this thread's slice of R_h's rows C cp + c, by
  // float4 loads where hd allows
  float4 RT[C][NV];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = C * cp + c;
    const float* Rg = a.R + ((size_t)hh * hd + k) * hd;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = s * L + 4 * v;
      if (a.vec && k < hd && v < nv && j < hd) {
        RT[c][v] = *reinterpret_cast<const float4*>(Rg + j);
      } else {
        float e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          e[q] = (k < hd && v < nv && j + q < hd) ? Rg[j + q] : 0.f;
        RT[c][v] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }
  int ro[RPL], jo[RPL], slot[RPL];
  bool own[RPL];
  float gc[RPL], gn[RPL], gh[RPL], gm[RPL];
  size_t hbo[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int q = s + P * i;
    ro[i] = q / C;
    jo[i] = C * cp + q % C;
    slot[i] = ro[i] * P * SS + (jo[i] / L) * SS + jo[i] % L;
    own[i] = q < NQ && jo[i] < hd && ro[i] < nb;
    gc[i] = gn[i] = gh[i] = gm[i] = 0.f;
    hbo[i] = ((size_t)hh * B + b0 + (own[i] ? ro[i] : 0)) * hd + (own[i] ? jo[i] : 0);
    if (!own[i]) continue;
    gc[i] = a.dcnh[hbo[i]];
    gn[i] = a.dcnh[HBd + hbo[i]];
    gh[i] = a.dcnh[2 * HBd + hbo[i]];
    gm[i] = a.dm[hbo[i]];
  }
  auto upd_of = [&](int t, int i) {
    return a.upd == nullptr || a.upd[(size_t)t * B + b0 + ro[i]];
  };
  __syncthreads();  // db zeroed
  int n_step = 0;   // steps walked: the parity of db
  const int nc = (T + K - 1) / K;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, T - t0);
    // the chunk forward from its checkpoint, each owner its elements: the
    // state before each step, z and the step's gates into scratch; a
    // step's z, f, i and upd loaded kChainAhead steps ahead
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      if (!own[i]) continue;
      const float* ck = a.ckpt + (size_t)c * 3 * HBd + hbo[i];
      float cc = ck[0], nn = ck[HBd], mp = ck[2 * HBd];
      float* w = scr + (size_t)ro[i] * hd + jo[i];
      float zq[kChainAhead], fq[kChainAhead], iq[kChainAhead];
      bool uq[kChainAhead];
      auto load = [&](int sl, int q) {
        if (sl < len) {
          const size_t o = (size_t)(t0 + sl) * HBd + hbo[i];
          zq[q] = a.dz[o];
          fq[q] = a.fin[o];
          iq[q] = a.iin[o];
          uq[q] = upd_of(t0 + sl, i);
        }
      };
#pragma unroll
      for (int q = 0; q < kChainAhead; ++q) load(q, q);
      for (int s0 = 0; s0 < len; s0 += kChainAhead) {
#pragma unroll
        for (int q = 0; q < kChainAhead; ++q) {
          const int sl = s0 + q;
          if (sl >= len) break;
          const float z = zq[q], f = fq[q], ig_in = iq[q];
          const bool u = uq[q];
          load(sl + kChainAhead, q);
          const Gate g = gate(f, ig_in, mp);
          const int code =
              (isfinite(g.mx) ? (g.a > ig_in ? 0 : g.a < ig_in ? 1 : 2) : 3) +
              (g.fin ? 0 : 4);
          float* ws = w + (size_t)sl * kBwdFields * F;
          ws[0] = cc;
          ws[F] = nn;
          ws[2 * F] = z;
          ws[3 * F] = g.fg;
          ws[4 * F] = g.ig;
          ws[5 * F] = (float)code;
          ws[6 * F] = 1.f / (1.f + expf(f));
          if (u) {
            cc = lerp_rn(g.fg, cc, g.ig, z);
            nn = __fadd_rn(__fmul_rn(g.fg, nn), g.ig);
            mp = g.mn;
          }
        }
      }
    }
    // the walk back: a step's inputs a step ahead in registers
    float X[RPL][kBwdFields + 2];  // the scratch fields, o, dhs
    bool XU[RPL];
    auto fetch = [&](int sl, float (&Y)[RPL][kBwdFields + 2], bool (&YU)[RPL]) {
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        YU[i] = false;
        if (!own[i]) continue;
        const float* ws = scr + (size_t)sl * kBwdFields * F + (size_t)ro[i] * hd + jo[i];
#pragma unroll
        for (int f = 0; f < kBwdFields; ++f) Y[i][f] = ws[f * F];
        const size_t o = (size_t)(t0 + sl) * HBd + hbo[i];
        Y[i][kBwdFields] = a.osig[o];
        Y[i][kBwdFields + 1] = a.dhs[o];
        YU[i] = upd_of(t0 + sl, i);
      }
    };
    fetch(len - 1, X, XU);
    for (int sl = len - 1; sl >= 0; --sl) {
      float Y[RPL][kBwdFields + 2];
      bool YU[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        YU[i] = XU[i];
#pragma unroll
        for (int f = 0; f < kBwdFields + 2; ++f) Y[i][f] = X[i][f];
      }
      if (sl > 0) fetch(sl - 1, X, XU);
      const int t = t0 + sl;
      float* dn_ = db + (n_step & 1) * RB * P * SS;
      float gpass[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        gpass[i] = 0.f;
        if (!own[i]) continue;
        const float cp_ = Y[i][0], np = Y[i][1], z = Y[i][2], fg = Y[i][3],
                    ig = Y[i][4], sig = Y[i][6], og = Y[i][7];
        const int code = (int)Y[i][5];
        const float g_h = gh[i] + Y[i][8];
        gpass[i] = g_h;
        float dzz = 0.f, dii = 0.f, dff = 0.f, dov = 0.f;
        if (YU[i]) {
          const float cn = lerp_rn(fg, cp_, ig, z);
          const float nw = __fadd_rn(__fmul_rn(fg, np), ig);
          const float den = fmaxf(nw, 1e-6f);
          const float oc = __fmul_rn(og, cn);
          const float da_ = g_h / den;
          dov = da_ * cn;
          const float dc = gc[i] + da_ * og;
          const float dn = gn[i] + (nw >= 1e-6f ? -g_h * oc / (den * den) : 0.f);
          const float dfg = dc * cp_ + dn * np;
          const float dig = dc * z + dn;
          dzz = dc * ig * (1.f - z * z);
          float dmn = gm[i];
          dii = dig * ig;
          dmn -= dii;
          float da = code < 4 ? dfg * fg : 0.f;
          dmn -= da;
          switch (code & 3) {
            case 0: da += dmn; break;
            case 1: dii += dmn; break;
            case 2:
              da += 0.5f * dmn;
              dii += 0.5f * dmn;
              break;
            default: dii += dmn;
          }
          dff = da * sig;
          gc[i] = fg * dc;
          gn[i] = fg * dn;
          gm[i] = da;
        }
        dn_[slot[i]] = dzz;
        const size_t o = (size_t)t * HBd + hbo[i];
        a.dz[o] = dzz;
        a.di[o] = dii;
        a.df[o] = dff;
        a.dout[o] = dov;
      }
      __syncthreads();
      // dh_{t-1} = dz_t R_h^T: the forward's split product on R's rows
      float rec[RB][C];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        slice_dot<NV, C>(reinterpret_cast<const float4*>(dn_ + (r * P + s) * SS),
                         RT, nv, rec[r]);
      butterfly<P>(rec);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        if (!own[i]) continue;
        const int q = s + P * i;
        float rr = rec[0][0];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
            if (C * r + cc == q) rr = rec[r][cc];
        gh[i] = YU[i] ? rr : gpass[i];
      }
      ++n_step;
    }
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    if (!own[i]) continue;
    a.dcnh0[hbo[i]] = gc[i];
    a.dcnh0[HBd + hbo[i]] = gn[i];
    a.dcnh0[2 * HBd + hbo[i]] = gh[i];
    a.dm0[hbo[i]] = gm[i];
  }
}

// dR_h = sum over (t, b) of h_{t-1}[b] (x) dz_t[b], deterministic in two
// passes: a 64 x 64 tile of one head over one of nsplit fixed ranges of
// rows p = t B + b a CTA (4 x 4 outputs a thread, each summed over its
// range in order, 32 rows staged at a time by cp.async into a two-stage
// ring), then the ranges summed in order.
constexpr int kDrTile = 64;
constexpr int kDrRows = 32;
constexpr int kDrMaxSplit = 16;
constexpr int kDrRowsPerSplit = 4096;

__host__ __device__ inline int dr_splits(int T, int B) {
  const long long rows = (long long)T * B;
  return (int)lmax(1, lmin(kDrMaxSplit,
                           (rows + kDrRowsPerSplit - 1) / kDrRowsPerSplit));
}

__global__ void __launch_bounds__(256) slstm_dr_kernel(
    const float* __restrict__ h0, const float* __restrict__ hs,
    const float* __restrict__ dz, float* __restrict__ part, int T, int B,
    int H, int hd, int nsplit, int vec) {
  __shared__ __align__(16) float hp_s[2][kDrRows][kDrTile];
  __shared__ __align__(16) float dz_s[2][kDrRows][kDrTile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int jb = blockIdx.x * kDrTile, kb = blockIdx.y * kDrTile;
  const int hh = blockIdx.z / nsplit, spl = blockIdx.z % nsplit;
  const long long rows = (long long)T * B, per = (rows + nsplit - 1) / nsplit;
  const long long p0 = spl * per, p1 = lmin(rows, p0 + per);
  auto hrow = [&](long long p) {
    const long long t = p / B, b = p - t * B;
    return t == 0 ? h0 + ((size_t)hh * B + b) * hd
                  : hs + (((size_t)(t - 1) * H + hh) * B + b) * hd;
  };
  auto zrow = [&](long long p) {
    const long long t = p / B, b = p - t * B;
    return dz + (((size_t)t * H + hh) * B + b) * hd;
  };
  auto stage = [&](long long pb, int buf) {
    for (int e = tid; e < kDrRows * kDrTile / 4; e += 256) {
      const int r = e / (kDrTile / 4), c4 = 4 * (e % (kDrTile / 4));
      const long long p = pb + r;
      const bool in = p < p1;
      const float* hsrc = in ? hrow(p) : nullptr;
      const float* zsrc = in ? zrow(p) : nullptr;
      float* hd_ = &hp_s[buf][r][c4];
      float* zd_ = &dz_s[buf][r][c4];
      if (in && vec && kb + c4 < hd)
        cp_async16(hd_, hsrc + kb + c4);
      else
        for (int q = 0; q < 4; ++q)
          hd_[q] = (in && kb + c4 + q < hd) ? hsrc[kb + c4 + q] : 0.f;
      if (in && vec && jb + c4 < hd)
        cp_async16(zd_, zsrc + jb + c4);
      else
        for (int q = 0; q < 4; ++q)
          zd_[q] = (in && jb + c4 + q < hd) ? zsrc[jb + c4 + q] : 0.f;
    }
    cp_async_commit();
  };
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  const int nblk = (int)((p1 - p0 + kDrRows - 1) / kDrRows);
  if (nblk > 0) stage(p0, 0);
  for (int blk = 0; blk < nblk; ++blk) {
    const int buf = blk & 1;
    if (blk + 1 < nblk) {
      stage(p0 + (long long)(blk + 1) * kDrRows, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kDrRows; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(&hp_s[buf][r][ty * 4]);
      const float4 dv = *reinterpret_cast<const float4*>(&dz_s[buf][r][tx * 4]);
      const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
      const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(h4[x], d4[y], acc[x][y]);
    }
    __syncthreads();  // this stage is read before it is refilled
  }
  float* dst = part + ((size_t)spl * H + hh) * hd * hd;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int k = kb + ty * 4 + x;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = jb + tx * 4 + y;
      if (k < hd && j < hd) dst[(size_t)k * hd + j] = acc[x][y];
    }
  }
}

__global__ void __launch_bounds__(256) slstm_dr_sum_kernel(
    const float* __restrict__ part, float* __restrict__ dR, int n,
    int nsplit) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float x = 0.f;
  for (int q = 0; q < nsplit; ++q) x += part[(size_t)q * n + idx];
  dR[idx] = x;
}

int launch_dr(const float* h0, const float* hs, const float* dz, float* part,
              float* dR, int T, int B, int H, int hd, int vec,
              cudaStream_t st) {
  const int nsplit = dr_splits(T, B);
  const int nt = (hd + kDrTile - 1) / kDrTile;
  slstm_dr_kernel<<<dim3(nt, nt, H * nsplit), 256, 0, st>>>(
      h0, hs, dz, part, T, B, H, hd, nsplit, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * hd * hd;
  slstm_dr_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, dR, n, nsplit);
  return (int)cudaGetLastError();
}

template <int NV, int P, int C>
int launch_rec(const float* zin, const float* R, const float* h0,
               const float* hs, float* zout, int T, int B, int H, int hd,
               int vec, cudaStream_t st) {
  const size_t smem = rec_smem_floats(hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_bwd_rec_kernel<NV, P, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long rows = (long long)T * B;
  const int parts = (int)lmax(1, lmin(lmax(1, n_sm / H),
                                      (rows + kRecBlock - 1) / kRecBlock));
  const int threads = ((hd + C - 1) / C * P + 31) / 32 * 32;
  slstm_bwd_rec_kernel<NV, P, C><<<dim3(parts, H), threads, smem, st>>>(
      zin, R, h0, hs, zout, T, B, H, hd, vec);
  return (int)cudaGetLastError();
}

template <int NV, int P, int C, int RB>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = bwd_smem_floats(a.hd, RB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_bwd_kernel<NV, P, C, RB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((a.hd + C - 1) / C * P + 31) / 32 * 32;
  slstm_bwd_kernel<NV, P, C, RB>
      <<<dim3((a.B + a.rb - 1) / a.rb, a.H), threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int NV, int P, int C>
int bwd_rows(const BwdArgs& a, cudaStream_t st) {
  if (a.rb == 1) return launch_bwd<NV, P, C, 1>(a, st);
  if (a.rb == 2) return launch_bwd<NV, P, C, 2>(a, st);
  return launch_bwd<NV, P, C, 4>(a, st);
}

}  // namespace

extern "C" int slstm_fwd(const void* zin, const void* iin, const void* fin,
                         const void* osig, const void* R, const void* cnh0,
                         const void* m0, const void* upd, const void* out_at,
                         void* hs, void* cnh, void* m, void* ckpt, int T,
                         int B, int H, int hd, int rb, int collect, int K,
                         void* stream) {
  if (rb < 1 || rb > kRows || hd < 1 || hd > 224 || K > kKmax)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{(const float*)zin, (const float*)iin, (const float*)fin,
                  (const float*)osig, (const float*)R, (const float*)cnh0,
                  (const float*)m0, (const bool*)upd, (const int*)out_at,
                  (float*)hs, (float*)cnh, (float*)m, (float*)ckpt,
                  T, B, H, hd, rb, collect, K > 0 ? K : 1,
                  hd % 4 == 0 && (((uintptr_t)zin | (uintptr_t)iin |
                                   (uintptr_t)fin | (uintptr_t)osig) & 15) == 0};
  cudaStream_t st = (cudaStream_t)stream;
  const Split sp = split_of(hd);
  if (sp.p == 4) return fwd_rows<14, 4, 2>(a, st);
  if (sp.len <= 8) return fwd_rows<2, 8, 4>(a, st);
  return fwd_rows<6, 8, 4>(a, st);
}

// the recompute of z alone (into zout): for timing it apart
extern "C" int slstm_rec(const void* zin, const void* R, const void* h0,
                         const void* hs, void* zout, int T, int B, int H,
                         int hd, void* stream) {
  if (hd < 1 || hd > 224) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Split sp = split_of(hd);
  const int vec = hd % 4 == 0 &&
                  (((uintptr_t)zin | (uintptr_t)h0 | (uintptr_t)hs |
                    (uintptr_t)zout) & 15) == 0;
  const float *z = (const float*)zin, *r = (const float*)R,
              *a = (const float*)h0, *h = (const float*)hs;
  if (sp.p == 4)
    return launch_rec<14, 4, 2>(z, r, a, h, (float*)zout, T, B, H, hd, vec, st);
  if (sp.len <= 8)
    return launch_rec<2, 8, 4>(z, r, a, h, (float*)zout, T, B, H, hd, vec, st);
  return launch_rec<6, 8, 4>(z, r, a, h, (float*)zout, T, B, H, hd, vec, st);
}

// the backward's scratch layout (floats an element a step of a chunk);
// the wrapper sizes scratch by it (slstm_bwd_plan in kernels/xlstm/ops.py)
extern "C" int slstm_bwd_layout() { return kBwdFields; }

// the dR pass alone (its split partials in part): for timing it apart
extern "C" int slstm_dr(const void* h0, const void* hs, const void* dz,
                        void* part, void* dR, int T, int B, int H, int hd,
                        void* stream) {
  if (hd < 1 || hd > 224) return (int)cudaErrorInvalidValue;
  const int vec = hd % 4 == 0 && (((uintptr_t)h0 | (uintptr_t)hs |
                                   (uintptr_t)dz) & 15) == 0;
  return launch_dr((const float*)h0, (const float*)hs, (const float*)dz,
                   (float*)part, (float*)dR, T, B, H, hd, vec,
                   (cudaStream_t)stream);
}

// scratch: the walk's (H ceil(B / rb) CTAs x K steps x kBwdFields x rb x
// hd floats), then dR's split partials (dr_splits(T, B) x H x hd x hd)
extern "C" int slstm_bwd(const void* zin, const void* iin, const void* fin,
                         const void* osig, const void* R, const void* h0,
                         const void* upd, const void* hs, const void* ckpt,
                         const void* dhs, const void* dcnh, const void* dm,
                         void* scratch, void* dz, void* di, void* df,
                         void* dout, void* dR, void* dcnh0, void* dm0, int T,
                         int B, int H, int hd, int rb, int K, void* stream) {
  if (rb < 1 || rb > kRows || hd < 1 || hd > 224 || K < 1 || K > kKmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Split sp = split_of(hd);
  const int vec = hd % 4 == 0 &&
                  (((uintptr_t)zin | (uintptr_t)h0 | (uintptr_t)hs |
                    (uintptr_t)R | (uintptr_t)dz) & 15) == 0;
  // z of every step, the forward's bit for bit, into dz's buffer
  int err = slstm_rec(zin, R, h0, hs, dz, T, B, H, hd, stream);
  if (err != 0) return err;
  const BwdArgs a{(const float*)iin, (const float*)fin, (const float*)osig,
                  (const float*)R, (const float*)ckpt, (const float*)dhs,
                  (const float*)dcnh, (const float*)dm, (const bool*)upd,
                  (float*)scratch, (float*)dz, (float*)di, (float*)df,
                  (float*)dout, (float*)dcnh0, (float*)dm0, T, B, H, hd, rb,
                  K, vec};
  err = sp.p == 4 ? bwd_rows<14, 4, 2>(a, st)
        : sp.len <= 8 ? bwd_rows<2, 8, 4>(a, st)
                      : bwd_rows<6, 8, 4>(a, st);
  if (err != 0) return err;
  const size_t walk = (size_t)H * ((B + rb - 1) / rb) * K * kBwdFields * rb * hd;
  return launch_dr((const float*)h0, (const float*)hs, (const float*)dz,
                   (float*)scratch + walk, (float*)dR, T, B, H, hd, vec, st);
}
