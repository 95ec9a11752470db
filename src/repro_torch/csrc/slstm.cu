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
// Design. The step mixes a whole head, so one CTA steps one head for a
// group of batch rows (rb, at most 4: the fewest that keep the grid in
// one wave), one thread an element of h. R_h lives in dynamic shared
// memory (hd x hd+1, padded so that both the forward's column reads and
// the backward's row reads are free of bank conflicts: 148 KB at hd 192,
// one copy for the rows of the group). h_{t-1} is exchanged through
// shared memory, double-buffered by step parity: one __syncthreads a
// step. The state out is written once (after out_at[b]), or after every
// step with collect; under autograd [c, n, m] every K steps (h_{t-1} is
// the output).
//
// The backward walks T in reverse a chunk of K steps at a time: it
// recomputes the chunk from its checkpoint (z needs h_{t-1} R, with
// h_{t-1} read from the forward's output), keeping c, n, m before each
// step and z in global scratch, and walks the chunk back carrying the
// adjoints of c, n, h and m in registers. The adjoint of h_{t-1} is
// dz R_h^T, a row of R a thread; nothing is divided back out of the
// recurrence. dR = sum over (t, b) of h_{t-1} (x) dz crosses CTAs, so a
// second, deterministic pass forms it from the backward's dz and the
// forward's h, each output summed over (t, b) in order.

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

__global__ void __launch_bounds__(256) slstm_fwd_kernel(
    const float* __restrict__ zin, const float* __restrict__ iin,
    const float* __restrict__ fin, const float* __restrict__ osig,
    const float* __restrict__ R, const float* __restrict__ cnh0,
    const float* __restrict__ m0, const bool* __restrict__ upd,
    const int* __restrict__ out_at, float* __restrict__ hs,
    float* __restrict__ cnh_out, float* __restrict__ m_out,
    float* __restrict__ ckpt, int T, int B, int H, int hd, int rb,
    int collect, int K) {
  extern __shared__ float sm[];
  const int hd1 = hd + 1;
  float* Rs = sm;                // [hd][hd+1]
  float* hb = sm + hd * hd1;     // [2][kRows][hd]
  const int hh = blockIdx.y, b0 = blockIdx.x * rb;
  const int nb = min(rb, B - b0);
  const int j = threadIdx.x;
  const bool jv = j < hd;
  const size_t HBd = (size_t)H * B * hd;
  load_r(Rs, R, hh, hd);
  float c[kRows], n[kRows], h[kRows], m[kRows];
#pragma unroll
  for (int ri = 0; ri < kRows; ++ri) {
    c[ri] = n[ri] = h[ri] = m[ri] = 0.f;
    if (ri < nb && jv) {
      const size_t o = ((size_t)hh * B + b0 + ri) * hd + j;
      c[ri] = cnh0[o];
      n[ri] = cnh0[HBd + o];
      h[ri] = cnh0[2 * HBd + o];
      m[ri] = m0[o];
      hb[ri * hd + j] = h[ri];
    }
  }
  // the state of row ri into a (3, ..., H, B, hd) / (..., H, B, hd) pair
  // whose component stride is cs, at the (h, b) offset o
  auto put = [&](float* dst, size_t cs, float* mdst, size_t o, int ri) {
    dst[o] = c[ri];
    dst[cs + o] = n[ri];
    dst[2 * cs + o] = h[ri];
    mdst[o] = m[ri];
  };
  auto staged = [&](int t1, int ri) {
    const size_t o = (((size_t)t1 * H + hh) * B + b0 + ri) * hd + j;
    put(cnh_out, (size_t)(T + 1) * HBd, m_out, o, ri);
  };
  if (jv) {
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) {
      if (ri >= nb) continue;
      if (collect)
        staged(0, ri);
      else if (out_at[b0 + ri] < 0)
        put(cnh_out, HBd, m_out, ((size_t)hh * B + b0 + ri) * hd + j, ri);
    }
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* hcur = hb + (t & 1) * kRows * hd;
    float* hnext = hb + ((t + 1) & 1) * kRows * hd;
    float rec[kRows];
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) rec[ri] = 0.f;
    if (jv) {
#pragma unroll 4
      for (int kk = 0; kk < hd; ++kk) {
        const float r = Rs[kk * hd1 + j];
#pragma unroll
        for (int ri = 0; ri < kRows; ++ri)
          if (ri < nb) rec[ri] += hcur[ri * hd + kk] * r;
      }
    }
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) {
      if (ri >= nb || !jv) continue;
      const int b = b0 + ri;
      const size_t hbo = ((size_t)hh * B + b) * hd + j;
      if (ckpt != nullptr && t % K == 0) {
        float* ck = ckpt + (size_t)(t / K) * 3 * HBd + hbo;
        ck[0] = c[ri];
        ck[HBd] = n[ri];
        ck[2 * HBd] = m[ri];
      }
      const size_t o = (size_t)t * HBd + hbo;
      const float z = tanhf(zin[o] + rec[ri]);
      const Gate g = gate(fin[o], iin[o], m[ri]);
      const bool u = upd == nullptr || upd[(size_t)t * B + b];
      if (u) {
        c[ri] = lerp_rn(g.fg, c[ri], g.ig, z);
        n[ri] = __fadd_rn(__fmul_rn(g.fg, n[ri]), g.ig);
        h[ri] = __fmul_rn(osig[o], c[ri]) / fmaxf(n[ri], 1e-6f);
        m[ri] = g.mn;
      }
      hs[o] = h[ri];
      hnext[ri * hd + j] = h[ri];
      if (collect)
        staged(t + 1, ri);
      else if (t == out_at[b])
        put(cnh_out, HBd, m_out, hbo, ri);
    }
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
        for (int ri = 0; ri < kRows; ++ri) rec[ri] = 0.f;
        if (jv) {
#pragma unroll 4
          for (int kk = 0; kk < hd; ++kk) {
            const float r = Rs[kk * hd1 + j];
#pragma unroll
            for (int ri = 0; ri < kRows; ++ri)
              if (ri < nb) rec[ri] += hp[ri * hd + kk] * r;
          }
        }
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

}  // namespace

extern "C" int slstm_fwd(const void* zin, const void* iin, const void* fin,
                         const void* osig, const void* R, const void* cnh0,
                         const void* m0, const void* upd, const void* out_at,
                         void* hs, void* cnh, void* m, void* ckpt, int T,
                         int B, int H, int hd, int rb, int collect, int K,
                         void* stream) {
  if (rb < 1 || rb > kRows || hd > 224 || K > kKmax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((hd + 31) / 32) * 32;
  dim3 grid((B + rb - 1) / rb, H);
  slstm_fwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)zin, (const float*)iin, (const float*)fin,
      (const float*)osig, (const float*)R, (const float*)cnh0,
      (const float*)m0, (const bool*)upd, (const int*)out_at, (float*)hs,
      (float*)cnh, (float*)m, (float*)ckpt, T, B, H, hd, rb, collect,
      K > 0 ? K : 1);
  return (int)cudaGetLastError();
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
