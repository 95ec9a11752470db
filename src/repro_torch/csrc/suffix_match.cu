// Batched longest-suffix-match drafting over a packed suffix-tree forest,
// for Hopper (sm_90a). Two kernels share one row core
// (match_propose_row):
//
// * suffix_match_kernel replaces the TPU kernel
//   src/repro/kernels/suffix_match/kernel.py: suffix_match_propose_kernel
//   (body _suffix_match_kernel, scalar core match_propose_row), flat
//   forest layout: every row walks the one concatenated forest.
// * suffix_match_chunked_kernel replaces
//   suffix_match_propose_kernel_chunked in the same file, per-tree
//   (chunked) layout: row t of each forest array holds tree t with
//   tree-local indices. The TPU kernel streams the row's tree into VMEM
//   through a scalar-prefetched index map; here the row's CTA loads its
//   tree ordinal, moves every forest pointer to that tree (64-bit offsets
//   t*Es, t*Ns, t*Cs) and runs the same row core from root 0 with E = Es
//   and C = Cs.
//
// Per row: Chang-Lawler matching statistics of the context tail against
// the row's tree (suffix-link descent, lower-bound search of the sorted
// (node, token) edge table), then the greedy best_child continuation walk
// up to min(budget, n_prop_max) tokens, falling back to shorter suffixes
// down to max(min_match, 1).
//
// What bounds it on this card: neither bytes nor flops (a row reads a few
// kilobytes) but the latency of one dependent chain a row: each
// micro-step's loads depend on the step before, and the launch lasts as
// long as its longest row. One thread a row with a binary search made that
// chain about (m + link hops + budget) * (log2 E + 3) loads long. This
// design shortens it and runs the chains side by side:
// * A warp owns a row. All 32 lanes keep the row's state warp-uniform and
//   run the FEED/DESC state machine and the continuation walk in lockstep
//   (a load at one address is a broadcast); the lanes part to search and
//   to step along an edge. The flat kernel puts four rows in a CTA, which
//   share its splitters (below); the chunked kernel gives each row a CTA,
//   so each row's staging (loads to scattered lines, bound by the misses
//   one SM keeps in flight) runs on an SM of its own.
// * find_child is a 33-way lower-bound search: in each round the lanes
//   probe 32 evenly spaced entries of the live range as 64-bit
//   (node, token) keys, and __ballot_sync/__popc of "key < query" picks
//   the sub-range; once at most 31 entries are left the lanes probe all of
//   them (and the child column) and the answer's lane holds the result:
//   ceil(log33 E) + 1 rounds at most, 3 at E = 2^15 where the binary
//   search took 16. Below 2^26 entries the probes' index products fit 32
//   bits; a larger table (any int32 size, as the plain version takes) is
//   searched by an instance of the kernels with 64-bit products, chosen
//   at launch, so the common case keeps its short search chain.
//   Edge tables are non-decreasing in (node, token) with
//   sentinels sorting last, so the lower bound is unique: it is the index
//   the reference's binary search returns, and the child is the same.
// * The first two rounds probe the same entries in every search over one
//   table (32, then 32 for each of the 33 outcomes: 1,088 keys). A CTA
//   stages them in shared memory before its rows start, round 1's also in
//   registers: the flat forest's once per CTA (not at all when none of
//   its rows is active), the row's own tree in the chunked kernel (the
//   counterpart of the TPU kernel's forest in VMEM). A search then leaves
//   the SM only for its last round or two.
// * Steps along an edge run up to 32 at a time: the edge's tokens sit in a
//   window spread over the lanes (one round trip per 32 tokens), and lane
//   l checks tail token i + l, or emits proposal k + l, with one ballot
//   for the run. The tail is staged in shared memory.
// * When a step lands on a child, the search for the next step from that
//   child (taken if its edge is one token long) is issued while the
//   child's edge start and length load; the walk reads a node's best
//   child with the node's other fields. A micro-step loads only what its
//   branch reads (no search while on an edge, no suffix link unless it
//   hops).
// Every clamp and the inactive-row rule are the reference's, so the output
// is bit-identical to it and to the plain PyTorch version, and the two
// kernels agree over the same trees.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int FEED = 0;
constexpr int DESC = 1;
// Rows (one warp each) per CTA of the flat kernel; the chunked kernel
// runs a row per CTA.
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NSPLIT = 32 + 33 * 32;  // keys probed by rounds 1 and 2
// Edge tables from this size on take the search with 64-bit products
// (WIDE); below it (lane + 1) * s stays under 2^31.
constexpr int WIDE_EDGES = 1 << 26;

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
  int E, C;
};

// The edge table entries that the first two search rounds probe: entry j
// of round 1, then entry 32 + 32 * c + j of round 2 after c probes of
// round 1 were less than the query.
struct Splitters {
  long long key[NSPLIT];
  int child[NSPLIT];
};

__device__ __forceinline__ int ld(const int* p, int i) { return __ldg(p + i); }

// (node, tok) as one signed 64-bit key in the table's lexicographic order.
__device__ __forceinline__ long long edge_key(int node, int tok) {
  return (long long)(((unsigned long long)(unsigned)node << 32) |
                     ((unsigned)tok ^ 0x80000000u));
}

// A probed index: int below WIDE_EDGES, 64 bits in the WIDE search
// (lo + 31 may pass INT_MAX in its last round; such a probe is past hi).
template <bool WIDE> struct Index { typedef int type; };
template <> struct Index<true> { typedef long long type; };

// The entry probed by `lane` in a round over the live range [lo, hi) (the
// lower bound lies in [lo, hi]): 32 evenly spaced entries, or, once the
// range holds at most 31 entries (the last round), every entry of
// [lo, hi]. A probe past hi or past the table reads nothing. Below
// WIDE_EDGES the products stay below 2^31; WIDE takes them (up to
// 32 * (2^31 - 1)) in 64 bits.
template <bool WIDE>
__device__ __forceinline__ typename Index<WIDE>::type probe(int lo, int hi,
                                                            int lane) {
  if (WIDE) {
    const unsigned long long s = (unsigned)(hi - lo);
    return s <= 31 ? (long long)lo + lane
                   : lo + (long long)((lane + 1) * s / 33u);
  }
  const unsigned s = hi - lo;
  return s <= 31 ? lo + lane : lo + (int)((lane + 1) * s / 33u);
}

// The live range after a round (not the last) in which c probes were less
// than the query: between the c-th probe and the next.
template <bool WIDE>
__device__ __forceinline__ void narrow(int& lo, int& hi, int c) {
  if (WIDE) {
    const unsigned long long s = (unsigned)(hi - lo);
    const int nlo = c > 0 ? lo + (int)(c * s / 33u) + 1 : lo;
    const int nhi = c < 32 ? lo + (int)((c + 1) * s / 33u) : hi;
    lo = nlo;
    hi = nhi;
    return;
  }
  const unsigned s = hi - lo;
  const int nlo = c > 0 ? lo + (int)(c * s / 33u) + 1 : lo;
  const int nhi = c < 32 ? lo + (int)((c + 1) * s / 33u) : hi;
  lo = nlo;
  hi = nhi;
}

// Stage the splitters with NT threads, in batches of up to 17 entries a
// thread: every load of a batch is issued before any loaded value is used
// (keys are formed at the stores), so a batch costs one round trip's
// latency, not one per entry; beyond that it costs the SM's rate of
// misses to scattered lines. Children are read only for entries of a last
// round (a table of at most 1,055 edges); a probe past the table reads
// nothing and keys past every edge.
template <int NT, bool WIDE>
__device__ void stage_splitters(const Forest& f, Splitters& sp, int tid) {
  constexpr int PER = (NSPLIT + NT - 1) / NT;
  constexpr int BATCH = PER < 17 ? PER : 17;
  for (int k0 = 0; k0 < PER; k0 += BATCH) {
    int en[BATCH], et[BATCH], ch[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = tid + (k0 + k) * NT;
      int lo = 0, hi = f.E, lane = e;
      if (e >= 32) {
        narrow<WIDE>(lo, hi, (e - 32) >> 5);
        lane = (e - 32) & 31;
      }
      const auto p = probe<WIDE>(lo, hi, lane);
      const bool valid = e < NSPLIT && p <= hi && p < f.E;
      en[k] = valid ? ld(f.en, (int)p) : INT_MAX;
      et[k] = valid ? ld(f.et, (int)p) : INT_MAX;
      ch[k] = valid && hi - lo <= 31 ? ld(f.ec, (int)p) : -1;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = tid + (k0 + k) * NT;
      if (e < NSPLIT) {
        sp.key[e] = edge_key(en[k], et[k]);
        sp.child[e] = ch[k];
      }
    }
  }
}

// A warp's view of the staged splitters: round 1's in registers (lane l
// holds entry l), round 2's in shared memory.
struct Table {
  const Splitters& sp;
  long long key0;
  int child0;
};

__device__ __forceinline__ Table table(const Splitters& sp, int lane) {
  return Table{sp, sp.key[lane], sp.child[lane]};
}

// Child of `node` whose edge starts with `tok` (-1 if none), by the warp:
// the 33-way lower-bound search, rounds 1 and 2 from the staged splitters,
// the rest from global memory. In the last round the answer's lane holds
// the result. Warp-uniform result.
template <bool WIDE>
__device__ int find_child(const Forest& f, const Table& tb, int node,
                          int tok, int lane) {
  const long long q = edge_key(node, tok);
  int lo = 0, hi = f.E;
  int c = __popc(__ballot_sync(FULL, tb.key0 < q));
  if (hi - lo <= 31)
    return __shfl_sync(FULL, tb.key0 == q ? tb.child0 : -1, c);
  narrow<WIDE>(lo, hi, c);
  const int e = 32 + 32 * c + lane;
  const long long key1 = tb.sp.key[e];
  c = __popc(__ballot_sync(FULL, key1 < q));
  if (hi - lo <= 31)
    return __shfl_sync(FULL, key1 == q ? tb.sp.child[e] : -1, c);
  narrow<WIDE>(lo, hi, c);
  for (;;) {
    const bool last = hi - lo <= 31;
    const auto p = probe<WIDE>(lo, hi, lane);
    const bool valid = p <= hi && p < f.E;
    const int en = valid ? ld(f.en, (int)p) : INT_MAX;
    const int et = valid ? ld(f.et, (int)p) : INT_MAX;
    const int ch = valid && last ? ld(f.ec, (int)p) : -1;
    const long long key = edge_key(en, et);
    c = __popc(__ballot_sync(FULL, key < q));
    if (last) return __shfl_sync(FULL, key == q ? ch : -1, c);
    narrow<WIDE>(lo, hi, c);
  }
}

// Child of (node, tok) through a one-entry memo of a search made ahead.
struct Memo {
  int node, tok, child;
};

template <bool WIDE>
__device__ __forceinline__ int lookup(const Forest& f, const Table& tb,
                                      const Memo& memo, int node, int tok,
                                      int lane) {
  return (node == memo.node && tok == memo.tok)
             ? memo.child
             : find_child<WIDE>(f, tb, node, tok, lane);
}

// The edge a walk is on: its corpus start and length, and a window of 64
// of its tokens spread over the lanes (lane l holds the tokens at offsets
// base + l and base + 32 + l, read with the reference's clamp to C - 1).
struct Edge {
  int start, len, base, w0, w1;
};

__device__ __forceinline__ void enter_edge(Edge& e, int start, int len) {
  e.start = start;
  e.len = len;
  e.base = -64;  // no window yet
}

// Make the window hold offsets pos .. pos + 31.
__device__ __forceinline__ void edge_window(const Forest& f, Edge& e, int pos,
                                            int lane) {
  if (pos < e.base || pos - e.base > 32) {
    e.base = pos;
    e.w0 = ld(f.corpus, min(e.start + pos + lane, f.C - 1));
    e.w1 = ld(f.corpus, min(e.start + pos + 32 + lane, f.C - 1));
  }
}

// The token at offset base + off (0 <= off < 64), for each lane's own off.
__device__ __forceinline__ int edge_tok(const Edge& e, int off) {
  const int v0 = __shfl_sync(FULL, e.w0, off & 31);
  const int v1 = __shfl_sync(FULL, e.w1, off & 31);
  return off < 32 ? v0 : v1;
}

// Length of the run of lanes, from lane 0, whose `good` holds.
__device__ __forceinline__ int run_length(bool good) {
  const unsigned bad = ~__ballot_sync(FULL, good);
  return bad ? __ffs(bad) - 1 : 32;
}

// The row core, run by one warp: one row's match and proposal over forest
// view `f` (splitters `tb`, tail `tail` in shared memory), writing
// props[0..n_prop_max) and the row's match_len / n_prop.
template <bool WIDE>
__device__ void match_propose_row(const Forest& f, const Table& tb,
                                  const int* tail, int m, int root,
                                  int budget_in, int n_prop_max,
                                  int min_match, int lane,
                                  int* match_len_out, int* n_prop_out,
                                  int* prow) {
  const bool active = root >= 0;
  const int root_s = max(root, 0);
  const int budget = min(budget_in, n_prop_max);
  const int C = f.C;
  for (int k = lane; k < n_prop_max; k += 32) prow[k] = -1;
  __syncwarp();  // before other lanes write proposals

  // ---- streaming longest-suffix match (matching statistics) ----------
  // A failed step starts a suffix-link hop whose skip/count re-descent
  // runs one segment per iteration (mode DESC), then the same tail token
  // is retried. Matching steps along one edge run up to 32 at a time.
  int i = active ? 0 : m;
  int node = root_s, child = -1, epos = 0, mlen = 0, mode = FEED;
  int dnode = root_s, dpos = 0, drem = 0;
  Edge edge = {0, 0, -64, 0, 0};
  Memo memo = {-1, 0, -1};
  while (i < m || mode == DESC) {
    if (mode == DESC) {
      if (drem == 0) {  // the descent ends on a node
        node = dnode;
        child = -1;
        epos = 0;
        mode = FEED;
        continue;
      }
      const int c_s = max(lookup<WIDE>(f, tb, memo, dnode,
                                 ld(f.corpus, min(dpos, C - 1)), lane), 0);
      const int ell = ld(f.el, c_s);
      if (drem >= ell) {  // skip the whole edge
        child = -1;
        epos = 0;
        dnode = c_s;
        dpos += ell;
        drem -= ell;
      } else {  // stop inside it
        node = dnode;
        child = c_s;
        epos = drem;
        mode = FEED;
        enter_edge(edge, ld(f.es, c_s), ell);
      }
      continue;
    }
    const int t = tail[i];
    if (t < 0) {  // a reset (separator or padding)
      node = root_s;
      child = -1;
      epos = 0;
      mlen = 0;
      ++i;
      continue;
    }
    bool ok = false;
    if (child >= 0) {
      // lane l checks step l of a run: tail[i + l] against the edge's
      // token at epos + l, within the edge and the tail
      edge_window(f, edge, epos, lane);
      const int te = edge_tok(edge, epos - edge.base + lane);
      const int tl = tail[min(i + lane, m - 1)];
      const int n = run_length(i + lane < m && epos + lane < edge.len &&
                               tl >= 0 && te == tl);
      if (n > 0) {
        i += n;
        mlen += n;
        epos += n;
        if (epos == edge.len) {
          node = child;
          child = -1;
          epos = 0;
        }
        continue;
      }
    } else {
      const int c = lookup<WIDE>(f, tb, memo, node, t, lane);
      ok = c >= 0;
      if (ok) {
        const int start = ld(f.es, c), len = ld(f.el, c);
        // While those load, search ahead for the next step, which starts
        // at c if c's edge is one token long.
        if (i + 1 < m && tail[i + 1] >= 0) {
          memo.child = find_child<WIDE>(f, tb, c, tail[i + 1], lane);
          memo.node = c;
          memo.tok = tail[i + 1];
        }
        enter_edge(edge, start, len);
        if (len == 1) {
          node = c;
        } else {
          child = c;
          epos = 1;
        }
      }
    }
    if (ok) {
      ++mlen;
      ++i;
    } else if (mlen == 0) {  // nothing matched: drop the token
      ++i;
    } else {  // suffix-link hop, then retry the same token
      const bool on_edge = child >= 0;
      const int shift = (on_edge && node == root_s) ? 1 : 0;
      dnode = ld(f.sl, node);
      dpos = on_edge ? edge.start + shift : 0;  // unread when drem == 0
      drem = on_edge ? epos - shift : 0;
      --mlen;
      mode = DESC;
    }
  }

  // ---- greedy continuation walk with shorter-suffix fallback ---------
  // Walk micro-steps emit tokens (up to 32 at a time along one edge); an
  // empty walk hops one suffix link (descent micro-steps) and retries,
  // until a token lands or the match falls below min_match.
  const int minm = max(min_match, 1);
  int wn = node, wc = child, we = epos, k = 0, pmlen = mlen;
  int bc_node = -1, bc_next = -1;  // bc[bc_node], read ahead
  mode = FEED;
  dnode = root_s;
  dpos = 0;
  drem = 0;
  bool done = !active || budget <= 0 || mlen < minm;
  while (!done) {
    if (mode == DESC) {
      if (drem == 0) {
        wn = dnode;
        wc = -1;
        we = 0;
        mode = FEED;
        continue;
      }
      const int c_s = max(lookup<WIDE>(f, tb, memo, dnode,
                                 ld(f.corpus, min(dpos, C - 1)), lane), 0);
      const int ell = ld(f.el, c_s);
      if (drem >= ell) {
        wc = -1;
        we = 0;
        dnode = c_s;
        dpos += ell;
        drem -= ell;
      } else {
        wn = dnode;
        wc = c_s;
        we = drem;
        mode = FEED;
        enter_edge(edge, ld(f.es, c_s), ell);
      }
      continue;
    }
    if (k < budget) {
      if (wc >= 0) {
        if (we == edge.len) {  // end of the edge: step onto its node
          wn = wc;
          wc = -1;
          we = 0;
          continue;
        }
        // lane l emits the edge's token at we + l, within the edge and
        // the budget, up to the first separator
        edge_window(f, edge, we, lane);
        const int te = edge_tok(edge, we - edge.base + lane);
        const int n = run_length(we + lane < edge.len && k + lane < budget &&
                                 te >= 0);
        if (lane < n) prow[k + lane] = te;
        k += n;
        we += n;
        if (n > 0) continue;
      } else {
        const int bcx = wn == bc_node ? bc_next : ld(f.bc, wn);
        if (bcx >= 0) {
          const int tok = ld(f.ft, bcx);
          enter_edge(edge, ld(f.es, bcx), ld(f.el, bcx));
          bc_node = bcx;  // the next node's best child, read with it
          bc_next = ld(f.bc, bcx);
          if (lane == 0) prow[k] = tok;
          ++k;
          wc = bcx;
          we = 1;
          continue;
        }
      }
    }
    // stop: the budget is spent, or a separator or a leaf ends the walk
    if (k > 0) break;  // proposed: done
    if (pmlen - 1 < minm) break;  // too short to retry: give up
    const bool on_edge = wc >= 0;
    const int shift = (on_edge && wn == root_s) ? 1 : 0;
    dnode = ld(f.sl, wn);
    dpos = on_edge ? edge.start + shift : 0;
    drem = on_edge ? we - shift : 0;
    --pmlen;
    mode = DESC;
  }
  if (lane == 0) {
    *match_len_out = active ? mlen : 0;
    *n_prop_out = active ? k : 0;
  }
}

__device__ __forceinline__ void stage_tail(int* dst, const int* src, int m,
                                           int lane) {
  for (int j = lane; j < m; j += 32) dst[j] = src[j];
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
suffix_match_kernel(Forest f, const int* __restrict__ tails, int tail_stride,
                    const int* __restrict__ roots, int root_stride,
                    const int* __restrict__ budgets, int budget_stride,
                    int B, int m, int n_prop_max, int min_match,
                    int* __restrict__ match_len, int* __restrict__ n_prop,
                    int* __restrict__ props) {
  extern __shared__ __align__(16) unsigned char smem[];
  Splitters& sp = *reinterpret_cast<Splitters*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tail = reinterpret_cast<int*>(smem + sizeof(Splitters)) + warp * m;
  const int row = blockIdx.x * WARPS + warp;
  const int root = row < B ? roots[(size_t)row * root_stride] : -1;
  if (row < B) stage_tail(tail, tails + (size_t)row * tail_stride, m, lane);
  if (__syncthreads_or(root >= 0)) {  // the CTA's rows share the splitters
    stage_splitters<THREADS, WIDE>(f, sp, threadIdx.x);
    __syncthreads();
  }
  if (row >= B) return;
  match_propose_row<WIDE>(f, table(sp, lane), tail, m, root,
                    budgets[(size_t)row * budget_stride], n_prop_max,
                    min_match, lane, match_len + row, n_prop + row,
                    props + (size_t)row * n_prop_max);
}

// Per-tree arrays: row t of each starts at base + t * stride.
struct ChunkedForest {
  const int *en, *et, *ec;               // (T, Es)
  const int *sl, *es, *el, *ft, *bc;     // (T, Ns)
  const int* corpus;                     // (T, Cs)
  int T, Es, Ns, Cs;
};

template <bool WIDE>
__global__ void __launch_bounds__(32)
suffix_match_chunked_kernel(ChunkedForest cf,
                            const int* __restrict__ tails, int tail_stride,
                            const int* __restrict__ roots, int root_stride,
                            const int* __restrict__ budgets,
                            int budget_stride, int m, int n_prop_max,
                            int min_match, int* __restrict__ match_len,
                            int* __restrict__ n_prop,
                            int* __restrict__ props) {
  extern __shared__ __align__(16) unsigned char smem[];
  Splitters& sp = *reinterpret_cast<Splitters*>(smem);
  int* tail = reinterpret_cast<int*>(smem + sizeof(Splitters));
  const int lane = threadIdx.x, row = blockIdx.x;
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
  if (r >= 0) stage_splitters<32, WIDE>(f, sp, lane);  // this row's tree
  stage_tail(tail, tails + (size_t)row * tail_stride, m, lane);
  __syncwarp();
  match_propose_row<WIDE>(f, table(sp, lane), tail, m, r >= 0 ? 0 : -1,
                    budgets[(size_t)row * budget_stride], n_prop_max,
                    min_match, lane, match_len + row, n_prop + row,
                    props + (size_t)row * n_prop_max);
}

// Dynamic shared memory of `bytes`, allowed above 48 KB on first need.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// by WIDE
size_t flat_allowed[2] = {0, 0}, chunked_allowed[2] = {0, 0};

template <bool WIDE>
cudaError_t launch_flat(const Forest& f, const int* tails, int tail_stride,
                        const int* roots, int root_stride,
                        const int* budgets, int budget_stride, int B, int m,
                        int n_prop_max, int min_match, int* match_len,
                        int* n_prop, int* props, cudaStream_t stream) {
  const size_t smem = sizeof(Splitters) + (size_t)WARPS * m * sizeof(int);
  const cudaError_t err =
      allow_smem(suffix_match_kernel<WIDE>, smem, flat_allowed[WIDE]);
  if (err != cudaSuccess) return err;
  const int blocks = (B + WARPS - 1) / WARPS;
  if (blocks > 0)
    suffix_match_kernel<WIDE><<<blocks, THREADS, smem, stream>>>(
        f, tails, tail_stride, roots, root_stride, budgets, budget_stride,
        B, m, n_prop_max, min_match, match_len, n_prop, props);
  return cudaGetLastError();
}

template <bool WIDE>
cudaError_t launch_chunked(const ChunkedForest& cf, const int* tails,
                           int tail_stride, const int* roots,
                           int root_stride, const int* budgets,
                           int budget_stride, int B, int m, int n_prop_max,
                           int min_match, int* match_len, int* n_prop,
                           int* props, cudaStream_t stream) {
  const size_t smem = sizeof(Splitters) + (size_t)m * sizeof(int);
  const cudaError_t err = allow_smem(suffix_match_chunked_kernel<WIDE>, smem,
                                     chunked_allowed[WIDE]);
  if (err != cudaSuccess) return err;
  if (B > 0)
    suffix_match_chunked_kernel<WIDE><<<B, 32, smem, stream>>>(
        cf, tails, tail_stride, roots, root_stride, budgets, budget_stride,
        m, n_prop_max, min_match, match_len, n_prop, props);
  return cudaGetLastError();
}

}  // namespace

extern "C" int suffix_match_propose_flat(
    const void* tails, int tail_stride, const void* roots, int root_stride,
    const void* budgets, int budget_stride, const void* edge_node,
    const void* edge_tok, const void* edge_child, const void* suffix_link,
    const void* edge_start, const void* edge_len, const void* first_tok,
    const void* best_child, const void* corpus, int B, int m, int E, int C,
    int n_prop_max, int min_match, void* match_len, void* n_prop,
    void* props, void* stream) {
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
  const auto launch = E >= WIDE_EDGES ? launch_flat<true> : launch_flat<false>;
  return (int)launch(f, (const int*)tails, tail_stride, (const int*)roots,
                     root_stride, (const int*)budgets, budget_stride, B, m,
                     n_prop_max, min_match, (int*)match_len, (int*)n_prop,
                     (int*)props, (cudaStream_t)stream);
}

extern "C" int suffix_match_propose_chunked(
    const void* tails, int tail_stride, const void* roots, int root_stride,
    const void* budgets, int budget_stride, const void* edge_node,
    const void* edge_tok, const void* edge_child, const void* suffix_link,
    const void* edge_start, const void* edge_len, const void* first_tok,
    const void* best_child, const void* corpus, int B, int m, int T, int Es,
    int Ns, int Cs, int n_prop_max, int min_match, void* match_len,
    void* n_prop, void* props, void* stream) {
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
  const auto launch =
      Es >= WIDE_EDGES ? launch_chunked<true> : launch_chunked<false>;
  return (int)launch(cf, (const int*)tails, tail_stride, (const int*)roots,
                     root_stride, (const int*)budgets, budget_stride, B, m,
                     n_prop_max, min_match, (int*)match_len, (int*)n_prop,
                     (int*)props, (cudaStream_t)stream);
}
