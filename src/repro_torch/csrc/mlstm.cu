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
// forms new a second time in its walk back (4 more): the recompute keeps
// only the state before each step in scratch.
//
// Design. Column j of [C|n] evolves from fg, ig, k_t and v_t[j] alone, so
// a CTA owns 32 columns (a lane each) of one (b, h) and 8 warps split the
// rows (at most 24 a thread, hd <= 192): the cell stays in registers for
// all T steps and the state is read and written once. Every CTA also
// carries n (a row a thread), so that it forms q.n and the denominator
// itself; the stabilizer chain is a few scalar operations a step that
// every thread repeats. A step's column sums (the read) meet in shared
// memory, double-buffered by step parity: one __syncthreads a step. The
// state out is written once, after the step out_at[b] (the last step for
// the dynamic state, the last committed step for the committed carry,
// -1 for the state before the block), or after every step with collect;
// under autograd a checkpoint every K steps and each step's q.n.
//
// The backward walks T in reverse a chunk of K steps at a time: it
// recomputes the chunk from its checkpoint, keeping the state before
// each step in global scratch (each thread reads back what it wrote), and
// walks the chunk back with the cell's adjoint G in registers, in the
// forward's layout. Nothing is divided back out of the recurrence (fg
// can be ~0). G does not depend on the stabilizer's adjoint, so the main
// kernel writes per-CTA partial sums (dq and dk over its columns, dfg
// and dig over its elements, the denominator's share of dm_new from the
// first CTA) and a second, deterministic pass sums them in a fixed order
// and walks the scalar chain back (di, df, dm0). The maximum hands its
// adjoint to the larger side and half to each on a tie, as torch's and
// JAX's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;          // columns of [C|n] a CTA owns
constexpr int kRpt = 24;           // most rows a thread owns
constexpr int kKmax = 64;          // most steps between checkpoints
constexpr int kSlots = kRpt + 1;   // scratch floats a thread a step
constexpr int kPad = 33;           // the row-sum transposes' row stride

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename TIn>
__global__ void __launch_bounds__(kThreads, 3) mlstm_fwd_kernel(
    const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ ipre,
    const float* __restrict__ fpre, const float* __restrict__ cn0,
    const float* __restrict__ m0, const bool* __restrict__ upd,
    const int* __restrict__ out_at, float* __restrict__ hout,
    float* __restrict__ cn_out, float* __restrict__ m_out,
    float* __restrict__ ckpt, float* __restrict__ mck,
    float* __restrict__ s_hist, int T, int B, int H, int hd, int collect,
    int K) {
  __shared__ float part[2][kWarps][kCols];
  __shared__ float spart[2][kWarps];
  const int jb = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int j = jb * kCols + lane;
  const bool jv = j < hd;
  const int rpt = (hd + kWarps - 1) / kWarps, k0 = w * rpt;
  const int hd1 = hd + 1;
  const size_t st = (size_t)hd * hd1;
  const size_t BH = (size_t)B * H;
  const bool lead = jb == 0;  // the CTA that writes n, m and q.n
  const bool nv = tid < hd;   // this thread carries n[tid]

  float C[kRpt];
  const float* src = cn0 + bh * st;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int kk = k0 + r;
    C[r] = (r < rpt && kk < hd && jv) ? src[(size_t)kk * hd1 + j] : 0.f;
  }
  float n = nv ? src[(size_t)tid * hd1 + hd] : 0.f;
  float m = m0[bh];

  auto put = [&](float* dst, float* mdst) {
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const int kk = k0 + r;
      if (r < rpt && kk < hd && jv) dst[(size_t)kk * hd1 + j] = C[r];
    }
    if (lead && nv) dst[(size_t)tid * hd1 + hd] = n;
    if (lead && tid == 0) *mdst = m;
  };
  auto staged = [&](int t1) {  // index t1 of the (B, T+1, H, ...) stage
    const size_t o = ((size_t)b * (T + 1) + t1) * H + hh;
    put(cn_out + o * st, m_out + o);
  };
  const int oat = collect ? T : out_at[b];
  if (collect)
    staged(0);
  else if (oat < 0)
    put(cn_out + bh * st, m_out + bh);

  for (int t = 0; t < T; ++t) {
    if (ckpt != nullptr && t % K == 0)
      put(ckpt + ((size_t)(t / K) * BH + bh) * st, mck + (t / K) * BH + bh);
    const size_t row = ((size_t)t * B + b) * H + hh;
    const Gate g = gate(fpre[row], ipre[row], m);
    const bool u = upd == nullptr || upd[(size_t)t * B + b];
    const TIn* qr = q + row * hd;
    const TIn* kr = k + row * hd;
    const float vj = jv ? to_f(v[row * hd + j]) : 0.f;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const int kk = k0 + r;
      if (r < rpt && kk < hd) {
        const float kv = round_in<TIn>(to_f(kr[kk]) * vj);
        const float nw = lerp_rn(g.fg, C[r], g.ig, kv);
        const float p = to_f(qr[kk]) * nw;
        if (r & 1)
          acc1 += p;
        else
          acc0 += p;
        if (u) C[r] = nw;
      }
    }
    float sp = 0.f;
    if (nv) {
      const float nn = lerp_rn(g.fg, n, g.ig, to_f(kr[tid]));
      sp = to_f(qr[tid]) * nn;
      if (u) n = nn;
    }
    sp = warp_sum(sp);
    const int buf = t & 1;
    part[buf][w][lane] = acc0 + acc1;
    if (lane == 0) spart[buf][w] = sp;
    __syncthreads();
    if (w == 0) {
      float rd = 0.f, s = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        rd += part[buf][i][lane];
        s += spart[buf][i];
      }
      const float den = fmaxf(fabsf(s), expf(-g.mn));
      if (jv) hout[row * hd + j] = rd / den;
      if (lead && lane == 0 && s_hist != nullptr) s_hist[row] = s;
    }
    if (u) m = g.mn;
    if (collect)
      staged(t + 1);
    else if (t == oat)
      put(cn_out + bh * st, m_out + bh);
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads, 3) mlstm_bwd_kernel(
    const TIn* __restrict__ q, const TIn* __restrict__ k,
    const TIn* __restrict__ v, const float* __restrict__ ipre,
    const float* __restrict__ fpre, const bool* __restrict__ upd,
    const float* __restrict__ hs, const float* __restrict__ s_hist,
    const float* __restrict__ ckpt, const float* __restrict__ mck,
    const float* __restrict__ dh, const float* __restrict__ dcn,
    float* __restrict__ scratch, float* __restrict__ dq_part,
    float* __restrict__ dk_part, float* __restrict__ dv,
    float* __restrict__ sc_part, float* __restrict__ dcn0, int T, int B,
    int H, int hd, int K) {
  extern __shared__ float rowbuf[];  // [2][hd][kPad]: dq's, dk's terms
  __shared__ float s_mn[kKmax], s_fg[kKmax], s_ig[kKmax];
  __shared__ unsigned char s_u[kKmax];
  __shared__ float s_dot[kKmax][kWarps];
  __shared__ float dvp[kWarps][kCols];
  __shared__ float red[kWarps][2];
  const int njb = gridDim.x;
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
  const size_t cta = (size_t)blockIdx.y * njb + jb;
  float* scr = scratch + cta * (size_t)K * kSlots * kThreads;
  float* dqb = rowbuf;
  float* dkb = rowbuf + (size_t)hd * kPad;

  float G[kRpt];
  const float* gsrc = dcn + bh * st;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int kk = k0 + r;
    G[r] = (r < rpt && kk < hd && jv) ? gsrc[(size_t)kk * hd1 + j] : 0.f;
  }
  float Gn = (lead && nv) ? gsrc[(size_t)tid * hd1 + hd] : 0.f;

  const int nc = (T + K - 1) / K;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, T - t0);
    {  // recompute the chunk, keeping the state before each step
      float P[kRpt];
      const float* ck = ckpt + ((size_t)c * BH + bh) * st;
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const int kk = k0 + r;
        P[r] = (r < rpt && kk < hd && jv) ? ck[(size_t)kk * hd1 + j] : 0.f;
      }
      float pn = (lead && nv) ? ck[(size_t)tid * hd1 + hd] : 0.f;
      float mp = mck[(size_t)c * BH + bh];
      for (int s = 0; s < len; ++s) {
        const int t = t0 + s;
        float* sl = scr + (size_t)s * kSlots * kThreads;
#pragma unroll
        for (int r = 0; r < kRpt; ++r)
          if (r < rpt) sl[r * kThreads + tid] = P[r];
        sl[kRpt * kThreads + tid] = pn;
        const size_t row = ((size_t)t * B + b) * H + hh;
        const Gate g = gate(fpre[row], ipre[row], mp);
        const bool u = upd == nullptr || upd[(size_t)t * B + b];
        if (tid == 0) {
          s_mn[s] = g.mn;
          s_fg[s] = g.fg;
          s_ig[s] = g.ig;
          s_u[s] = u;
        }
        const TIn* kr = k + row * hd;
        const float vj = jv ? to_f(v[row * hd + j]) : 0.f;
        if (u) {
#pragma unroll
          for (int r = 0; r < kRpt; ++r) {
            const int kk = k0 + r;
            if (r < rpt && kk < hd)
              P[r] = lerp_rn(g.fg, P[r], g.ig,
                             round_in<TIn>(to_f(kr[kk]) * vj));
          }
          if (lead && nv) pn = lerp_rn(g.fg, pn, g.ig, to_f(kr[tid]));
          mp = g.mn;
        }
        if (lead) {  // sum_j dh_j h_j for the denominator's adjoint
          float x = nv ? dh[row * hd + tid] * hs[row * hd + tid] : 0.f;
          x = warp_sum(x);
          if (lane == 0) s_dot[s][w] = x;
        }
      }
    }
    __syncthreads();
    for (int s = len - 1; s >= 0; --s) {  // walk the chunk back
      const int t = t0 + s;
      const size_t row = ((size_t)t * B + b) * H + hh;
      const float fg = s_fg[s], ig = s_ig[s], mn = s_mn[s];
      const bool u = s_u[s];
      const float sv = s_hist[row], e = expf(-mn), sa = fabsf(sv);
      const float den = fmaxf(sa, e);
      const float dr = jv ? dh[row * hd + j] / den : 0.f;
      const float vj = jv ? to_f(v[row * hd + j]) : 0.f;
      float ds = 0.f, dmn_den = 0.f;
      if (lead) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) dot += s_dot[s][i];
        const float dden = -dot / den;
        const float ws = sa > e ? 1.f : (sa < e ? 0.f : 0.5f);
        const float sg = sv > 0.f ? 1.f : (sv < 0.f ? -1.f : 0.f);
        ds = dden * ws * sg;
        dmn_den = -(dden * (1.f - ws)) * e;
      }
      const TIn* qr = q + row * hd;
      const TIn* kr = k + row * hd;
      const float* sl = scr + (size_t)s * kSlots * kThreads;
      float dfg = 0.f, dig = 0.f, dva = 0.f;
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const int kk = k0 + r;
        if (r < rpt && kk < hd) {
          const float p = sl[r * kThreads + tid];
          const float kf = to_f(kr[kk]);
          const float kv = round_in<TIn>(kf * vj);
          const float nw = lerp_rn(fg, p, ig, kv);
          const float gnew = (u ? G[r] : 0.f) + to_f(qr[kk]) * dr;
          dfg += gnew * p;
          dig += gnew * kv;
          const float dkv = ig * gnew;
          dva += dkv * kf;
          dqb[kk * kPad + lane] = nw * dr;
          dkb[kk * kPad + lane] = dkv * vj;
          G[r] = (u ? 0.f : G[r]) + fg * gnew;
        }
      }
      float dqn = 0.f, dkn = 0.f;
      if (lead && nv) {  // the n column
        const float p = sl[kRpt * kThreads + tid];
        const float kf = to_f(kr[tid]);
        const float nn = lerp_rn(fg, p, ig, kf);
        const float gnn = (u ? Gn : 0.f) + to_f(qr[tid]) * ds;
        dqn = nn * ds;
        dfg += gnn * p;
        dig += gnn * kf;
        dkn = ig * gnn;
        Gn = (u ? 0.f : Gn) + fg * gnn;
      }
      dfg = warp_sum(dfg);
      dig = warp_sum(dig);
      if (lane == 0) {
        red[w][0] = dfg;
        red[w][1] = dig;
      }
      dvp[w][lane] = dva;
      __syncthreads();
      if (nv) {  // row tid's sums over this CTA's columns
        float a = 0.f, bsum = 0.f;
#pragma unroll 8
        for (int c2 = 0; c2 < kCols; ++c2) {
          a += dqb[tid * kPad + c2];
          bsum += dkb[tid * kPad + c2];
        }
        const size_t o = (row * njb + jb) * hd + tid;
        dq_part[o] = a + dqn;
        dk_part[o] = bsum + dkn;
      }
      if (w == 0) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) x += dvp[i][lane];
        if (jv) dv[row * hd + j] = x;
      }
      if (tid == 0) {
        float a = 0.f, bb = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
          a += red[i][0];
          bb += red[i][1];
        }
        float* sp = sc_part + (row * njb + jb) * 3;
        sp[0] = a;
        sp[1] = bb;
        sp[2] = dmn_den;
      }
      __syncthreads();
    }
  }
  float* gdst = dcn0 + bh * st;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int kk = k0 + r;
    if (r < rpt && kk < hd && jv) gdst[(size_t)kk * hd1 + j] = G[r];
  }
  if (lead && nv) gdst[(size_t)tid * hd1 + hd] = Gn;
}

// The deterministic second pass: CTAs x < gridDim.x - 1 sum dq and dk over
// the column blocks (in order) for tpb steps each; the last CTA of each
// (b, h) walks the stabilizer's chain back over T.
__global__ void __launch_bounds__(256) mlstm_bwd_reduce_kernel(
    const float* __restrict__ dq_part, const float* __restrict__ dk_part,
    const float* __restrict__ sc_part, const float* __restrict__ ipre,
    const float* __restrict__ fpre, const bool* __restrict__ upd,
    const float* __restrict__ mck, const float* __restrict__ dm,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ di,
    float* __restrict__ df, float* __restrict__ dm0, int T, int B, int H,
    int hd, int njb, int K, int tpb) {
  const int bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int ntb = gridDim.x - 1;
  if ((int)blockIdx.x < ntb) {
    const int t0 = blockIdx.x * tpb, t1 = min(T, t0 + tpb);
    for (int idx = threadIdx.x; idx < (t1 - t0) * hd; idx += blockDim.x) {
      const int t = t0 + idx / hd, kk = idx % hd;
      const size_t row = ((size_t)t * B + b) * H + hh;
      const float* a = dq_part + row * njb * hd + kk;
      const float* c = dk_part + row * njb * hd + kk;
      float x = 0.f, y = 0.f;
      for (int jb = 0; jb < njb; ++jb) {
        x += a[(size_t)jb * hd];
        y += c[(size_t)jb * hd];
      }
      dq[row * hd + kk] = x;
      dk[row * hd + kk] = y;
    }
    return;
  }
  __shared__ float f_[kKmax], i_[kKmax], dfg_[kKmax], dig_[kKmax],
      dmd_[kKmax];
  __shared__ unsigned char u_[kKmax];
  const size_t BH = (size_t)B * H;
  float gm = dm[bh];
  const int nc = (T + K - 1) / K;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, T - t0);
    for (int s = threadIdx.x; s < len; s += blockDim.x) {
      const int t = t0 + s;
      const size_t row = ((size_t)t * B + b) * H + hh;
      f_[s] = fpre[row];
      i_[s] = ipre[row];
      u_[s] = upd == nullptr || upd[(size_t)t * B + b];
      const float* p = sc_part + row * njb * 3;
      float a = 0.f, bb = 0.f, cc = 0.f;
      for (int jb = 0; jb < njb; ++jb) {
        a += p[jb * 3];
        bb += p[jb * 3 + 1];
        cc += p[jb * 3 + 2];
      }
      dfg_[s] = a;
      dig_[s] = bb;
      dmd_[s] = cc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float mps[kKmax];
      float mp = mck[(size_t)c * BH + bh];
      for (int s = 0; s < len; ++s) {
        mps[s] = mp;
        const Gate g = gate(f_[s], i_[s], mp);
        if (u_[s]) mp = g.mn;
      }
      for (int s = len - 1; s >= 0; --s) {
        const Gate g = gate(f_[s], i_[s], mps[s]);
        const bool u = u_[s];
        float dmn = (u ? gm : 0.f) + dmd_[s];
        float dii = dig_[s] * g.ig;
        dmn -= dii;
        float da = g.fin ? dfg_[s] * g.fg : 0.f;
        dmn -= da;
        if (isfinite(g.mx)) {
          if (g.a > i_[s]) {
            da += dmn;
          } else if (g.a < i_[s]) {
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
        df[row] = da * (1.f / (1.f + expf(f_[s])));
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
  dim3 grid((hd + kCols - 1) / kCols, B * H);
  mlstm_fwd_kernel<TIn><<<grid, kThreads, 0, st>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const float*)ipre,
      (const float*)fpre, (const float*)cn0, (const float*)m0,
      (const bool*)upd, (const int*)out_at, (float*)h, (float*)cn,
      (float*)m, (float*)ckpt, (float*)mck, (float*)s, T, B, H, hd, collect,
      K > 0 ? K : 1);
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
  const size_t smem = (size_t)2 * hd * kPad * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_kernel<TIn><<<dim3(njb, B * H), kThreads, smem, st>>>(
      (const TIn*)q, (const TIn*)k, (const TIn*)v, (const float*)ipre,
      (const float*)fpre, (const bool*)upd, (const float*)hs,
      (const float*)s, (const float*)ckpt, (const float*)mck,
      (const float*)dh, (const float*)dcn, (float*)scratch, (float*)dq_part,
      (float*)dk_part, (float*)dv, (float*)sc_part, (float*)dcn0, T, B, H,
      hd, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tpb = 16;
  const int ntb = (T + tpb - 1) / tpb;
  mlstm_bwd_reduce_kernel<<<dim3(ntb + 1, B * H), 256, 0, st>>>(
      (const float*)dq_part, (const float*)dk_part, (const float*)sc_part,
      (const float*)ipre, (const float*)fpre, (const bool*)upd,
      (const float*)mck, (const float*)dm, (float*)dq, (float*)dk,
      (float*)di, (float*)df, (float*)dm0, T, B, H, hd, njb, K, tpb);
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
