// Batched longest-suffix-match drafting over a packed suffix-tree forest,
// for Hopper (sm_90a). Two kernels share one row core:
//
// * suffix_match_kernel replaces the TPU kernel
//   src/repro/kernels/suffix_match/kernel.py: suffix_match_propose_kernel
//   (body _suffix_match_kernel, scalar core match_propose_row), flat
//   forest layout: every row walks the one concatenated forest.
// * suffix_match_chunked_kernel replaces
//   suffix_match_propose_kernel_chunked in the same file, per-tree
//   (chunked) layout: row t of each forest array holds tree t with
//   tree-local indices. The TPU kernel streams the row's tree into VMEM
//   through a scalar-prefetched index map; here each thread loads its own
//   tree ordinal, moves every forest pointer to that tree (64-bit
//   offsets t*Es, t*Ns, t*Cs) and runs the same row core from root 0 with
//   E = Es, C = Cs and the binary search sized for Es.
//
// Per row: Chang-Lawler matching statistics of the context tail against
// the row's tree (suffix-link descent, lower-bound binary search over the
// sorted (node, token) edge table), then the greedy best_child
// continuation walk up to min(budget, n_prop_max) tokens, falling back to
// shorter suffixes down to max(min_match, 1).
//
// What bounds it on this card: neither bytes nor flops (both are tiny)
// but the latency of dependent loads — about
// (m + link hops + budget) * (ceil(log2 E) + 3) serial loads per row.
// The design keeps that chain as short as it is: one thread per row runs
// the reference's two flat loops (the FEED/DESC micro-step state machine)
// over the forest in global memory, reading through the read-only path
// (__ldg), so the trees stay resident in the 50 MB L2 across rows and
// rounds where they fit. The chunked layout shortens each binary search
// to the row's own tree (log2 Es instead of log2 E steps). The state
// machine, every clamp and the inactive-row rule are the reference's,
// statement for statement, so the output is bit-identical to it and to
// the plain PyTorch version, and the two kernels agree over the same
// trees.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FEED = 0;
constexpr int DESC = 1;
constexpr int THREADS = 32;

struct Forest {
  const int* en;      // (E,) edge table: node
  const int* et;      // (E,) edge table: token
  const int* ec;      // (E,) edge table: child
  const int* sl;      // (N,) suffix link
  const int* es;      // (N,) edge start in the corpus
  const int* el;      // (N,) edge length
  const int* ft;      // (N,) first token of the incoming edge
  const int* bc;      // (N,) greedy best child
  const int* corpus;  // (C,)
  int E, C, n_steps;
};

__device__ __forceinline__ int ld(const int* p, int i) { return __ldg(p + i); }

// Child of `node` whose edge starts with `tok` (-1 if none): the
// reference's unrolled lower-bound binary search, n_steps iterations.
__device__ int find_child(const Forest& f, int node, int tok) {
  int lo = 0, hi = f.E;
  for (int s = 0; s < f.n_steps; ++s) {
    const int mid = (lo + hi) / 2;
    const int mid_c = min(mid, f.E - 1);
    const int en = ld(f.en, mid_c), et = ld(f.et, mid_c);
    const bool less = (en < node) || (en == node && et < tok);
    const bool upd = lo < hi;
    const int lo2 = (upd && less) ? mid + 1 : lo;
    const int hi2 = (upd && !less) ? mid : hi;
    lo = lo2;
    hi = hi2;
  }
  const int lo_c = min(lo, f.E - 1);
  const bool found =
      lo < f.E && ld(f.en, lo_c) == node && ld(f.et, lo_c) == tok;
  return found ? ld(f.ec, lo_c) : -1;
}

// The row core: one row's match and proposal over forest view `f`,
// writing props[0..n_prop_max) and the row's match_len / n_prop.
__device__ void match_propose_row(const Forest& f, const int* tail, int m,
                                  int root, int budget_in, int n_prop_max,
                                  int min_match, int* match_len_out,
                                  int* n_prop_out, int* prow) {
  const bool active = root >= 0;
  const int root_s = max(root, 0);
  const int budget = min(budget_in, n_prop_max);
  const int C = f.C;
  for (int k = 0; k < n_prop_max; ++k) prow[k] = -1;

  // ---- streaming longest-suffix match (matching statistics) ----------
  // One flat loop; a failed step starts a suffix-link hop whose skip/count
  // re-descent runs one segment per iteration (mode DESC), then the same
  // tail token is retried.
  int i = active ? 0 : m;
  int node = root_s, child = -1, epos = 0, mlen = 0, mode = FEED;
  int dnode = root_s, dpos = 0, drem = 0;
  while (i < m || mode == DESC) {
    const bool in_desc = mode == DESC;
    const int t = tail[min(i, m - 1)];
    const int q_node = in_desc ? dnode : node;
    const int q_tok = in_desc ? ld(f.corpus, min(dpos, C - 1)) : t;
    const int c_found = find_child(f, q_node, q_tok);
    const int c_s = max(c_found, 0);
    if (in_desc) {
      const bool d_end = drem == 0;
      const int ell = ld(f.el, c_s);
      const bool d_full = !d_end && drem >= ell;
      node = d_end ? dnode : (d_full ? node : dnode);
      child = (d_end || d_full) ? -1 : c_s;
      epos = (d_end || d_full) ? 0 : drem;
      mode = d_full ? DESC : FEED;
      dnode = d_full ? c_s : dnode;
      dpos = dpos + (d_full ? ell : 0);
      drem = drem - (d_full ? ell : 0);
    } else {
      const bool is_reset = t < 0;
      const bool on_edge = child >= 0;
      const int ch_s = max(child, 0);
      const int es_ch = ld(f.es, ch_s);
      const int tok_edge = ld(f.corpus, min(es_ch + epos, C - 1));
      const bool step_ok = on_edge ? (tok_edge == t) : (c_found >= 0);
      const int new_child = on_edge ? child : c_found;
      const int new_epos = on_edge ? epos + 1 : 1;
      const bool full = new_epos == ld(f.el, max(new_child, 0));
      const int s_node = full ? max(new_child, 0) : node;
      const int s_child = full ? -1 : new_child;
      const int s_epos = full ? 0 : new_epos;
      const bool dead = mlen == 0;
      const bool hop = !is_reset && !step_ok && !dead;
      const int shift = (on_edge && node == root_s) ? 1 : 0;
      const int f_node = is_reset ? root_s : (step_ok ? s_node : node);
      const int f_child = is_reset ? -1 : (step_ok ? s_child : child);
      const int f_epos = is_reset ? 0 : (step_ok ? s_epos : epos);
      const int f_mlen =
          is_reset ? 0 : (step_ok ? mlen + 1 : (dead ? mlen : mlen - 1));
      const int f_i = i + ((is_reset || step_ok || dead) ? 1 : 0);
      const int f_dnode = ld(f.sl, node);
      const int f_dpos = es_ch + shift;
      const int f_drem = on_edge ? epos - shift : 0;
      i = f_i;
      node = f_node;
      child = f_child;
      epos = f_epos;
      mlen = f_mlen;
      mode = hop ? DESC : FEED;
      dnode = f_dnode;
      dpos = f_dpos;
      drem = f_drem;
    }
  }

  // ---- greedy continuation walk with shorter-suffix fallback ---------
  // Walk micro-steps emit tokens; an empty walk hops one suffix link
  // (descent micro-steps) and retries, until a token lands or the match
  // falls below min_match.
  const int minm = max(min_match, 1);
  int wn = node, wc = child, we = epos, k = 0, pmlen = mlen;
  mode = FEED;
  dnode = root_s;
  dpos = 0;
  drem = 0;
  bool done = !active || budget <= 0 || mlen < minm;
  while (!done) {
    if (mode == DESC) {
      const int c_found =
          find_child(f, dnode, ld(f.corpus, min(dpos, C - 1)));
      const int c_s = max(c_found, 0);
      const bool d_end = drem == 0;
      const int ell = ld(f.el, c_s);
      const bool d_full = !d_end && drem >= ell;
      wn = d_end ? dnode : (d_full ? wn : dnode);
      wc = (d_end || d_full) ? -1 : c_s;
      we = (d_end || d_full) ? 0 : drem;
      mode = d_full ? DESC : FEED;
      dnode = d_full ? c_s : dnode;
      dpos = dpos + (d_full ? ell : 0);
      drem = drem - (d_full ? ell : 0);
    } else {
      const bool hit = k >= budget;
      const bool on_edge = wc >= 0;
      const int wc_s = max(wc, 0);
      const int el_wc = ld(f.el, wc_s);
      const bool at_end = on_edge && (we == el_wc);
      const int es_wc = ld(f.es, wc_s);
      const int tok_e = ld(f.corpus, min(es_wc + we, C - 1));
      const int bcx = ld(f.bc, wn);
      const int tok = on_edge ? tok_e : ld(f.ft, max(bcx, 0));
      const bool brk = (on_edge && !at_end && tok_e < 0) || (!on_edge && bcx < 0);
      const bool stop = hit || brk;
      const bool succeed = stop && k > 0;
      const int pml2 = pmlen - 1;
      const bool give_up = stop && k == 0 && pml2 < minm;
      const bool hop = stop && k == 0 && !give_up;
      const bool norm = !stop && at_end;
      const bool emit = !stop && !norm;
      const int shift = (on_edge && wn == root_s) ? 1 : 0;
      if (emit) prow[min(k, n_prop_max - 1)] = tok;
      const int n_wn = norm ? wc_s : wn;
      const int n_wc = norm ? -1 : ((emit && !on_edge) ? max(bcx, 0) : wc);
      const int n_we = norm ? 0 : (emit ? (on_edge ? we + 1 : 1) : we);
      const int n_dnode = hop ? ld(f.sl, wn) : dnode;
      const int n_dpos = hop ? es_wc + shift : dpos;
      const int n_drem = hop ? (on_edge ? we - shift : 0) : drem;
      wn = n_wn;
      wc = n_wc;
      we = n_we;
      k += emit ? 1 : 0;
      pmlen = (hop || give_up) ? pml2 : pmlen;
      mode = hop ? DESC : FEED;
      dnode = n_dnode;
      dpos = n_dpos;
      drem = n_drem;
      done = succeed || give_up;
    }
  }
  *match_len_out = active ? mlen : 0;
  *n_prop_out = active ? k : 0;
}

__global__ void __launch_bounds__(THREADS)
suffix_match_kernel(Forest f, const int* __restrict__ tails, int tail_stride,
                    const int* __restrict__ roots, int root_stride,
                    const int* __restrict__ budgets, int budget_stride,
                    int B, int m, int n_prop_max, int min_match,
                    int* __restrict__ match_len, int* __restrict__ n_prop,
                    int* __restrict__ props) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= B) return;
  match_propose_row(f, tails + (size_t)row * tail_stride, m,
                    roots[(size_t)row * root_stride],
                    budgets[(size_t)row * budget_stride], n_prop_max,
                    min_match, match_len + row, n_prop + row,
                    props + (size_t)row * n_prop_max);
}

// Per-tree arrays: row t of each starts at base + t * stride.
struct ChunkedForest {
  const int *en, *et, *ec;               // (T, Es)
  const int *sl, *es, *el, *ft, *bc;     // (T, Ns)
  const int* corpus;                     // (T, Cs)
  int T, Es, Ns, Cs, n_steps;
};

__global__ void __launch_bounds__(THREADS)
suffix_match_chunked_kernel(ChunkedForest cf,
                            const int* __restrict__ tails, int tail_stride,
                            const int* __restrict__ roots, int root_stride,
                            const int* __restrict__ budgets,
                            int budget_stride, int B, int m, int n_prop_max,
                            int min_match, int* __restrict__ match_len,
                            int* __restrict__ n_prop,
                            int* __restrict__ props) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= B) return;
  // The row's tree ordinal (inactive rows clamp to tree 0 with root -1,
  // as the reference does); offsets in 64 bits.
  const int r = roots[(size_t)row * root_stride];
  const size_t t = (size_t)min(max(r, 0), cf.T - 1);
  Forest f;
  f.en = cf.en + t * cf.Es;
  f.et = cf.et + t * cf.Es;
  f.ec = cf.ec + t * cf.Es;
  f.sl = cf.sl + t * cf.Ns;
  f.es = cf.es + t * cf.Ns;
  f.el = cf.el + t * cf.Ns;
  f.ft = cf.ft + t * cf.Ns;
  f.bc = cf.bc + t * cf.Ns;
  f.corpus = cf.corpus + t * cf.Cs;
  f.E = cf.Es;
  f.C = cf.Cs;
  f.n_steps = cf.n_steps;
  match_propose_row(f, tails + (size_t)row * tail_stride, m, r >= 0 ? 0 : -1,
                    budgets[(size_t)row * budget_stride], n_prop_max,
                    min_match, match_len + row, n_prop + row,
                    props + (size_t)row * n_prop_max);
}

}  // namespace

extern "C" int suffix_match_propose_flat(
    const void* tails, int tail_stride, const void* roots, int root_stride,
    const void* budgets, int budget_stride, const void* edge_node,
    const void* edge_tok, const void* edge_child, const void* suffix_link,
    const void* edge_start, const void* edge_len, const void* first_tok,
    const void* best_child, const void* corpus, int B, int m, int E, int C,
    int n_steps, int n_prop_max, int min_match, void* match_len,
    void* n_prop, void* props, void* stream) {
  Forest f;
  f.en = (const int*)edge_node;
  f.et = (const int*)edge_tok;
  f.ec = (const int*)edge_child;
  f.sl = (const int*)suffix_link;
  f.es = (const int*)edge_start;
  f.el = (const int*)edge_len;
  f.ft = (const int*)first_tok;
  f.bc = (const int*)best_child;
  f.corpus = (const int*)corpus;
  f.E = E;
  f.C = C;
  f.n_steps = n_steps;
  const int blocks = (B + THREADS - 1) / THREADS;
  suffix_match_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      f, (const int*)tails, tail_stride, (const int*)roots, root_stride,
      (const int*)budgets, budget_stride, B, m, n_prop_max, min_match,
      (int*)match_len, (int*)n_prop, (int*)props);
  return (int)cudaGetLastError();
}

extern "C" int suffix_match_propose_chunked(
    const void* tails, int tail_stride, const void* roots, int root_stride,
    const void* budgets, int budget_stride, const void* edge_node,
    const void* edge_tok, const void* edge_child, const void* suffix_link,
    const void* edge_start, const void* edge_len, const void* first_tok,
    const void* best_child, const void* corpus, int B, int m, int T, int Es,
    int Ns, int Cs, int n_steps, int n_prop_max, int min_match,
    void* match_len, void* n_prop, void* props, void* stream) {
  ChunkedForest cf;
  cf.en = (const int*)edge_node;
  cf.et = (const int*)edge_tok;
  cf.ec = (const int*)edge_child;
  cf.sl = (const int*)suffix_link;
  cf.es = (const int*)edge_start;
  cf.el = (const int*)edge_len;
  cf.ft = (const int*)first_tok;
  cf.bc = (const int*)best_child;
  cf.corpus = (const int*)corpus;
  cf.T = T;
  cf.Es = Es;
  cf.Ns = Ns;
  cf.Cs = Cs;
  cf.n_steps = n_steps;
  const int blocks = (B + THREADS - 1) / THREADS;
  suffix_match_chunked_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cf, (const int*)tails, tail_stride, (const int*)roots, root_stride,
      (const int*)budgets, budget_stride, B, m, n_prop_max, min_match,
      (int*)match_len, (int*)n_prop, (int*)props);
  return (int)cudaGetLastError();
}
