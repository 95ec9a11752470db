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
// autograd [c, n, m] every K steps (h_{t-1} is the output). rec_ordered
// is the product in the same order, a thread an element: the backward's
// recompute calls it and re-forms the forward's z bit for bit.
//
// The backward (slstm_bwd_kernel) keeps one thread an element of h and R
// (hd x hd+1, padded) in dynamic shared memory (148 KB at hd 192). It
// walks T in reverse a chunk of K steps at a time: it recomputes the
// chunk from its checkpoint (z needs h_{t-1} R, with h_{t-1} read from
// the forward's output), keeping c, n, m before each step and z in
// global scratch, and walks the chunk back carrying the adjoints of c,
// n, h and m in registers. The adjoint of h_{t-1} is dz R_h^T, a row of
// R a thread; nothing is divided back out of the recurrence. dR = sum
// over (t, b) of h_{t-1} (x) dz crosses CTAs, so a second, deterministic
// pass forms it from the backward's dz and the forward's h, each output
// summed over (t, b) in order.

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

// R_h into shared memory as [hd][hd+1]
__device__ __forceinline__ void load_r(float* Rs, const float* R, int hh,
                                       int hd) {
  const float* Rg = R + (size_t)hh * hd * hd;
  for (int idx = threadIdx.x; idx < hd * hd; idx += blockDim.x)
    Rs[(idx / hd) * (hd + 1) + idx % hd] = Rg[idx];
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

// h_{t-1} R_h's column j (R's rows rstride apart) in the forward's order:
// each slice by fmaf into four accumulators a float4 at a time, combined
// (a0 + a1) + (a2 + a3); the slices by the forward's butterfly, slice l
// plus slice l + o for o = p/2, ..., 1.
__device__ __forceinline__ float rec_ordered(const float* h, const float* Rc,
                                             int rstride, int hd, Split sp) {
  float part[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (s < sp.p) {
      for (int k = s * sp.len; k < (s + 1) * sp.len; k += 4) {
        float x[4], r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = k + e < hd ? h[k + e] : 0.f;
          r[e] = k + e < hd ? Rc[(size_t)(k + e) * rstride] : 0.f;
        }
        a0 = fmaf(x[0], r[0], a0);
        a1 = fmaf(x[1], r[1], a1);
        a2 = fmaf(x[2], r[2], a2);
        a3 = fmaf(x[3], r[3], a3);
      }
    }
    part[s] = (a0 + a1) + (a2 + a3);
  }
#pragma unroll
  for (int o = 4; o >= 1; o >>= 1) {
    if (o < sp.p) {
#pragma unroll
      for (int l = 0; l < o; ++l) part[l] = part[l] + part[l + o];
    }
  }
  return part[0];
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
    for (int r = 0; r < RB; ++r) {
      const float4* h4 = reinterpret_cast<const float4*>(hp + (r * P + s) * SS);
      float a0[C], a1[C], a2[C], a3[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) a0[cc] = a1[cc] = a2[cc] = a3[cc] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v < nv) {
          const float4 x = h4[v];
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            a0[cc] = fmaf(x.x, Rr[cc][v].x, a0[cc]);
            a1[cc] = fmaf(x.y, Rr[cc][v].y, a1[cc]);
            a2[cc] = fmaf(x.z, Rr[cc][v].z, a2[cc]);
            a3[cc] = fmaf(x.w, Rr[cc][v].w, a3[cc]);
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) rec[r][cc] = (a0[cc] + a1[cc]) + (a2[cc] + a3[cc]);
    }
#pragma unroll
    for (int o = P / 2; o >= 1; o >>= 1) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          rec[r][cc] = rec[r][cc] + __shfl_xor_sync(0xffffffffu, rec[r][cc], o);
    }
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

__global__ void __launch_bounds__(256) slstm_bwd_kernel(
    const float* __restrict__ zin, const float* __restrict__ iin,
    const float* __restrict__ fin, const float* __restrict__ osig,
    const float* __restrict__ R, const float* __restrict__ h0,
    const bool* __restrict__ upd, const float* __restrict__ hs,
    const float* __restrict__ ckpt, const float* __restrict__ dhs,
    const float* __restrict__ dcnh, const float* __restrict__ dm,
    float* __restrict__ scratch, float* __restrict__ dz,
    float* __restrict__ di, float* __restrict__ df, float* __restrict__ dout,
    float* __restrict__ dcnh0, float* __restrict__ dm0, int T, int B, int H,
    int hd, int rb, int K) {
  extern __shared__ float sm[];
  const int hd1 = hd + 1;
  float* Rs = sm;
  float* hb = sm + hd * hd1;  // [2][kRows][hd]: h_{t-1}, then dz
  const int hh = blockIdx.y, b0 = blockIdx.x * rb;
  const int nb = min(rb, B - b0);
  const int j = threadIdx.x;
  const bool jv = j < hd;
  const size_t HBd = (size_t)H * B * hd;
  const size_t cta = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* scr = scratch + cta * (size_t)K * rb * 4 * hd;
  load_r(Rs, R, hh, hd);
  float gc[kRows], gn[kRows], gh[kRows], gm[kRows];
#pragma unroll
  for (int ri = 0; ri < kRows; ++ri) {
    gc[ri] = gn[ri] = gh[ri] = gm[ri] = 0.f;
    if (ri < nb && jv) {
      const size_t o = ((size_t)hh * B + b0 + ri) * hd + j;
      gc[ri] = dcnh[o];
      gn[ri] = dcnh[HBd + o];
      gh[ri] = dcnh[2 * HBd + o];
      gm[ri] = dm[o];
    }
  }
  __syncthreads();
  const int nc = (T + K - 1) / K;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, T - t0);
    {  // recompute the chunk, keeping c, n, m before each step and z
      float cc[kRows], nn[kRows], mp[kRows];
#pragma unroll
      for (int ri = 0; ri < kRows; ++ri) {
        cc[ri] = nn[ri] = mp[ri] = 0.f;
        if (ri < nb && jv) {
          const float* ck =
              ckpt + (size_t)c * 3 * HBd + ((size_t)hh * B + b0 + ri) * hd + j;
          cc[ri] = ck[0];
          nn[ri] = ck[HBd];
          mp[ri] = ck[2 * HBd];
        }
      }
      for (int s = 0; s < len; ++s) {
        const int t = t0 + s;
        float* hp = hb + (s & 1) * kRows * hd;
        if (jv) {
#pragma unroll
          for (int ri = 0; ri < kRows; ++ri) {
            if (ri >= nb) continue;
            const size_t hbo = ((size_t)hh * B + b0 + ri) * hd + j;
            hp[ri * hd + j] = t == 0 ? h0[hbo] : hs[(size_t)(t - 1) * HBd + hbo];
          }
        }
        __syncthreads();
        float rec[kRows];
#pragma unroll
        for (int ri = 0; ri < kRows; ++ri)
          rec[ri] = (ri < nb && jv) ? rec_ordered(hp + ri * hd, Rs + j, hd1,
                                                  hd, split_of(hd))
                                    : 0.f;
#pragma unroll
        for (int ri = 0; ri < kRows; ++ri) {
          if (ri >= nb || !jv) continue;
          const int b = b0 + ri;
          const size_t o = (size_t)t * HBd + ((size_t)hh * B + b) * hd + j;
          const float z = tanhf(zin[o] + rec[ri]);
          float* sl = scr + (((size_t)s * rb + ri) * 4) * hd + j;
          sl[0] = cc[ri];
          sl[hd] = nn[ri];
          sl[2 * hd] = mp[ri];
          sl[3 * hd] = z;
          if (upd == nullptr || upd[(size_t)t * B + b]) {
            const Gate g = gate(fin[o], iin[o], mp[ri]);
            cc[ri] = lerp_rn(g.fg, cc[ri], g.ig, z);
            nn[ri] = __fadd_rn(__fmul_rn(g.fg, nn[ri]), g.ig);
            mp[ri] = g.mn;
          }
        }
      }
    }
    __syncthreads();
    for (int s = len - 1; s >= 0; --s) {  // walk the chunk back
      const int t = t0 + s;
      float* dzb = hb + (s & 1) * kRows * hd;
      float gpass[kRows];
      bool uu[kRows];
#pragma unroll
      for (int ri = 0; ri < kRows; ++ri) {
        gpass[ri] = 0.f;
        uu[ri] = false;
        if (ri >= nb || !jv) continue;
        const int b = b0 + ri;
        const size_t o = (size_t)t * HBd + ((size_t)hh * B + b) * hd + j;
        const float* sl = scr + (((size_t)s * rb + ri) * 4) * hd + j;
        const float cp = sl[0], np = sl[hd], mpv = sl[2 * hd], z = sl[3 * hd];
        const float g_h = gh[ri] + dhs[o];
        const bool u = upd == nullptr || upd[(size_t)t * B + b];
        uu[ri] = u;
        gpass[ri] = g_h;
        float dzz = 0.f, dii = 0.f, dff = 0.f, dov = 0.f;
        if (u) {
          const float f = fin[o], i = iin[o], og = osig[o];
          const Gate g = gate(f, i, mpv);
          const float cn = lerp_rn(g.fg, cp, g.ig, z);
          const float nw = __fadd_rn(__fmul_rn(g.fg, np), g.ig);
          const float den = fmaxf(nw, 1e-6f);
          const float oc = __fmul_rn(og, cn);
          const float da_ = g_h / den;
          dov = da_ * cn;
          const float dc = gc[ri] + da_ * og;
          const float dn = gn[ri] + (nw >= 1e-6f ? -g_h * oc / (den * den) : 0.f);
          const float dfg = dc * cp + dn * np;
          const float dig = dc * z + dn;
          dzz = dc * g.ig * (1.f - z * z);
          float dmn = gm[ri];
          dii = dig * g.ig;
          dmn -= dii;
          float da = g.fin ? dfg * g.fg : 0.f;
          dmn -= da;
          if (isfinite(g.mx)) {
            if (g.a > i) {
              da += dmn;
            } else if (g.a < i) {
              dii += dmn;
            } else {
              da += 0.5f * dmn;
              dii += 0.5f * dmn;
            }
          } else {
            dii += dmn;
          }
          dff = da * (1.f / (1.f + expf(f)));
          gc[ri] = g.fg * dc;
          gn[ri] = g.fg * dn;
          gm[ri] = da;
        }
        dz[o] = dzz;
        di[o] = dii;
        df[o] = dff;
        dout[o] = dov;
        dzb[ri * hd + j] = dzz;
      }
      __syncthreads();
#pragma unroll
      for (int ri = 0; ri < kRows; ++ri) {
        if (ri >= nb || !jv) continue;
        if (uu[ri]) {
          float x = 0.f;
          const float* rr = Rs + j * hd1;
#pragma unroll 4
          for (int jj = 0; jj < hd; ++jj) x += dzb[ri * hd + jj] * rr[jj];
          gh[ri] = x;
        } else {
          gh[ri] = gpass[ri];
        }
      }
    }
    __syncthreads();
  }
  if (jv) {
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) {
      if (ri >= nb) continue;
      const size_t o = ((size_t)hh * B + b0 + ri) * hd + j;
      dcnh0[o] = gc[ri];
      dcnh0[HBd + o] = gn[ri];
      dcnh0[2 * HBd + o] = gh[ri];
      dm0[o] = gm[ri];
    }
  }
}

// dR_h[k][j] = sum over (t, b) in order of h_{t-1}[b, k] dz_t[b, j]: a
// 32 x 32 tile of one head a CTA, 4 outputs a thread.
__global__ void __launch_bounds__(256) slstm_dr_kernel(
    const float* __restrict__ h0, const float* __restrict__ hs,
    const float* __restrict__ dz, float* __restrict__ dR, int T, int B,
    int H, int hd) {
  __shared__ float hp_s[32][33], dz_s[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int hh = blockIdx.z;
  const int jj = blockIdx.x * 32 + tx, kb = blockIdx.y * 32;
  const size_t HBd = (size_t)H * B * hd;
  const int P = T * B;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < P; p0 += 32) {
    for (int e = ty * 32 + tx; e < 1024; e += 256) {
      const int pi = e >> 5, col = e & 31, p = p0 + pi;
      const int t = p / B, b = p - (p / B) * B;
      const int kk = kb + col, j2 = blockIdx.x * 32 + col;
      const size_t hbo = ((size_t)hh * B + b) * hd;
      float hv = 0.f, dv = 0.f;
      if (p < P && kk < hd)
        hv = t == 0 ? h0[hbo + kk] : hs[(size_t)(t - 1) * HBd + hbo + kk];
      if (p < P && j2 < hd) dv = dz[(size_t)t * HBd + hbo + j2];
      hp_s[pi][col] = hv;
      dz_s[pi][col] = dv;
    }
    __syncthreads();
#pragma unroll 8
    for (int pi = 0; pi < 32; ++pi) {
      const float d = dz_s[pi][tx];
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) acc[qd] += hp_s[pi][ty * 4 + qd] * d;
    }
    __syncthreads();
  }
#pragma unroll
  for (int qd = 0; qd < 4; ++qd) {
    const int kk = kb + ty * 4 + qd;
    if (kk < hd && jj < hd) dR[((size_t)hh * hd + kk) * hd + jj] = acc[qd];
  }
}

size_t smem_bytes(int hd) {
  return ((size_t)hd * (hd + 1) + 2 * kRows * hd) * sizeof(float);
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

extern "C" int slstm_bwd(const void* zin, const void* iin, const void* fin,
                         const void* osig, const void* R, const void* h0,
                         const void* upd, const void* hs, const void* ckpt,
                         const void* dhs, const void* dcnh, const void* dm,
                         void* scratch, void* dz, void* di, void* df,
                         void* dout, void* dR, void* dcnh0, void* dm0, int T,
                         int B, int H, int hd, int rb, int K, void* stream) {
  if (rb < 1 || rb > kRows || hd > 224 || K < 1 || K > kKmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((hd + 31) / 32) * 32;
  slstm_bwd_kernel<<<dim3((B + rb - 1) / rb, H), threads, smem, st>>>(
      (const float*)zin, (const float*)iin, (const float*)fin,
      (const float*)osig, (const float*)R, (const float*)h0,
      (const bool*)upd, (const float*)hs, (const float*)ckpt,
      (const float*)dhs, (const float*)dcnh, (const float*)dm,
      (float*)scratch, (float*)dz, (float*)di, (float*)df, (float*)dout,
      (float*)dcnh0, (float*)dm0, T, B, H, hd, rb, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 tiles((hd + 31) / 32, (hd + 31) / 32, H);
  slstm_dr_kernel<<<tiles, dim3(32, 8), 0, st>>>(
      (const float*)h0, (const float*)hs, (const float*)dz, (float*)dR, T, B,
      H, hd);
  return (int)cudaGetLastError();
}
