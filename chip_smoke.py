#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository's sources next to this file; it
imports only ``repro_torch``, torch and numpy. Phases (any failure exits
non-zero; no phase's error is caught):

1. device: the card's name and power limit (nvidia-smi), torch's view;
2. build: both CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a, in parallel, with the ptxas register/shared-memory report;
3. kernels against their plain PyTorch versions at main-path shapes
   (spec-verify attention within the bfloat16 tolerance, suffix-match
   bit-identical), with kernel / plain / library times (CUDA events,
   L2 flushed before every launch) and each kernel's bound;
4. main path: Qwen3-8B at full width (random weights from a seed, bf16),
   lock-step DAS ``generate`` of 8 requests over 4 problems, two epochs
   over the same prompts; epoch 2 must be token-identical to epoch 1 and
   accept drafts, and both kernels must have launched during the run;
   then a small float32 model's engine output against plain greedy
   decoding without cache or kernels;
5. the serving CLI as a subprocess.

The last lines are the card line, the per-kernel JSON line and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet), the bound's denominators.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SV_TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2),
          "float32": dict(atol=3e-5, rtol=1e-2)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each
    launch (the main path finds K/V and the forest cold: 36 layers of
    weights stream through L2 between two launches of a kernel)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(96 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


# ---------------------------------------------------------------------------
# phase 3a: spec-verify attention
# ---------------------------------------------------------------------------

def sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, dtype, seed, min_len):
    """Ragged ring caches: row b holds positions [0, len_b + T) (the
    block's own K/V already written, as the model writes them before the
    read); the block's queries sit at len_b .. len_b + T - 1."""
    rng = np.random.default_rng(seed)
    S = S1 - 1
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(B, T, Hq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S1, Hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S1, Hkv, hd)).astype(np.float32))
    lengths = rng.integers(min_len, S - T, size=B)
    cpos = np.full((B, S1), -1, np.int32)
    for b in range(B):
        for p in range(lengths[b] + T):
            cpos[b, p % S] = p
    positions = (lengths[:, None] + np.arange(T)[None]).astype(np.int32)
    return (q.to(dt).cuda(), k.to(dt).cuda(), v.to(dt).cuda(),
            torch.from_numpy(cpos).cuda(), torch.from_numpy(positions).cuda())


def sv_bound_ms(np, args, window, dtype):
    """Least time for the same work: each valid K/V slot, q, positions
    and cache_pos read once, the output written once; flops of QK and PV
    over the visible (row, slot) pairs only."""
    q, k, _, cpos, pos = args
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    esz = q.element_size()
    cp = cpos.cpu().numpy()
    qp = pos.cpu().numpy()
    valid_slots = int((cp >= 0).sum())
    nbytes = (2 * q.numel() * esz + cp.size * 4 + qp.size * 4
              + 2 * valid_slots * Hkv * hd * esz)
    vis = (cp[:, None, :] >= 0) & (cp[:, None, :] <= qp[:, :, None])
    if window > 0:
        vis &= cp[:, None, :] > qp[:, :, None] - window
    flops = 4.0 * int(vis.sum()) * Hq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_spec_verify(torch, np, timer, card):
    import torch.nn.functional as F

    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    # small float32 case with a window and a softcap
    small = sv_inputs(torch, np, 2, 5, 8, 2, 64, 130, "float32", 1, 20)
    got = sv_ops.spec_verify_attention_cuda(*small, window=48, softcap=30.0)
    want = spec_verify_attention_ref(*small, window=48, softcap=30.0)
    torch.cuda.synchronize()
    err_small = float((got - want).abs().max())
    check(torch.allclose(got, want, **SV_TOL["float32"]),
          f"spec_verify f32 window/softcap: max |err| {err_small}")
    log(f"spec_verify f32 (B=2 T=5 Hq=8 Hkv=2 hd=64 S+1=130 window=48 "
        f"softcap=30): max |err| {err_small:.3e}  ok")

    # main-path shape: B=8, T=17, Hq=32, Hkv=8, hd=128, S+1=577, bf16
    B, T, Hq, Hkv, hd, S1 = 8, 17, 32, 8, 128, 577
    copies = [sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, "bfloat16",
                        10 + i, 128) for i in range(4)]
    args = copies[0]
    got = sv_ops.spec_verify_attention_cuda(*args)
    want = spec_verify_attention_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "spec_verify bf16: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), **SV_TOL["bfloat16"]),
          f"spec_verify bf16: max |err| {err}")
    log(f"spec_verify bf16 (B={B} T={T} Hq={Hq} Hkv={Hkv} hd={hd} "
        f"S+1={S1}, ragged): max |err| {err:.3e}  ok")

    # timing: cycle 4 input sets (4 x 19 MB of K/V) so nothing stays warm
    it = {"i": 0}

    def nxt():
        it["i"] += 1
        return copies[it["i"] % len(copies)]

    ms = timer.ms(lambda: sv_ops.spec_verify_attention_cuda(*nxt()), 50)
    plain_ms = timer.ms(lambda: spec_verify_attention_ref(*nxt()), 10)
    # library yardstick: one SDPA call with the same boolean mask (never
    # called by the port)
    lib_in = []
    for q, k, v, cpos, pos in copies:
        mask = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= pos[:, :, None])
        lib_in.append((q.transpose(1, 2).contiguous(),
                       k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(), mask[:, None]))
    try:
        F.scaled_dot_product_attention(*lib_in[0][:3], attn_mask=lib_in[0][3],
                                       enable_gqa=True)
        sdpa_kw = {"enable_gqa": True}
    except TypeError:  # older torch: expand the kv heads outside the timing
        sdpa_kw = {}
        G = Hq // Hkv
        lib_in = [(q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), m)
                  for q, k, v, m in lib_in]
    li = {"i": 0}

    def lib_call():
        li["i"] += 1
        q, k, v, m = lib_in[li["i"] % len(lib_in)]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m, **sdpa_kw)

    library_ms = timer.ms(lib_call, 50)
    bound_ms, bound_by = sv_bound_ms(np, args, 0, "bfloat16")
    log(f"spec_verify bf16 timing: kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by})  [{card}]")
    return dict(name="spec_verify_attention", route="cuda",
                source="src/repro_torch/csrc/spec_verify.cu",
                replaces="src/repro/kernels/spec_verify/kernel.py:103",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# phase 3b: suffix-match drafting
# ---------------------------------------------------------------------------

def synthetic_rollouts(np, seed, n_problems=4, per_problem=8):
    """Seeded rollouts that repeat themselves the way RL rollouts of one
    problem do: each problem has a few motifs; a rollout stitches motifs
    with random edits."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in range(n_problems):
        motifs = [list(rng.integers(2, 5000, size=rng.integers(8, 40)))
                  for _ in range(6)]
        docs = []
        for _ in range(per_problem):
            doc = []
            while len(doc) < 300:
                m = list(motifs[rng.integers(0, len(motifs))])
                if rng.random() < 0.3:
                    m[rng.integers(0, len(m))] = int(rng.integers(2, 5000))
                doc += m
            docs.append([int(t) for t in doc])
        out[f"p{p}"] = docs
    return out


def phase_suffix_match(torch, np, timer, card):
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.kernels.suffix_match import ops as sm_ops
    from repro_torch.kernels.suffix_match.ref import suffix_match_propose_ref

    B, m, K = 8, 64, 16
    rollouts = synthetic_rollouts(np, 5)
    d = SuffixDrafter(DrafterConfig(scope="problem"))
    for ep, (pid, docs) in enumerate(rollouts.items()):
        for doc in docs:
            d.observe_rollout(pid, doc, epoch=ep)
    keys = list(rollouts)
    forest, roots = sm_ops.pack_forest([d.pack_for(k) for k in keys],
                                       device="cuda")
    rng = np.random.default_rng(6)
    tails = np.full((B, m), -1, np.int32)
    rts = np.zeros(B, np.int32)
    for b in range(B):
        p = b % len(keys)
        doc = rollouts[keys[p]][int(rng.integers(0, 8))]
        cut = int(rng.integers(m // 2, len(doc)))
        tail = doc[max(0, cut - m):cut]
        tails[b, m - len(tail):] = tail
        rts[b] = roots[p]
    rts[5] = -1  # an inactive row
    budgets = np.array([16, 16, 8, 4, 16, 16, 0, 12], np.int32)
    args = [torch.from_numpy(a).cuda() for a in (tails, rts, budgets)]
    got = sm_ops.suffix_match_propose_cuda(forest, *args, n_prop_max=K,
                                           min_match=1)
    want = suffix_match_propose_ref(*args, *forest, n_prop_max=K, min_match=1)
    torch.cuda.synchronize()
    for name, g, w in zip(("match_len", "n_prop", "props"), got, want):
        check(torch.equal(g, w), f"suffix_match {name} differs from plain")
    n_prop = got[1].cpu().numpy()
    check(int(n_prop.sum()) > 0, "suffix_match proposed nothing")
    log(f"suffix_match (B={B} m={m} K={K}, E={forest.edge_node.shape[0]} "
        f"N={forest.suffix_link.shape[0]} C={forest.corpus.shape[0]}): "
        f"bit-identical, n_prop={n_prop.tolist()}")
    ms = timer.ms(lambda: sm_ops.suffix_match_propose_cuda(
        forest, *args, n_prop_max=K, min_match=1), 50)
    plain_ms = timer.ms(lambda: suffix_match_propose_ref(
        *args, *forest, n_prop_max=K, min_match=1), 5, warmup=1)
    # bytes that must move: the query in, the proposals out. The forest
    # entries a row visits depend on the data and are a few KB; the bound
    # leaves them out, so it stays a lower bound.
    nbytes = 4 * (B * m + 2 * B) + 4 * (2 * B + B * K)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"suffix_match timing: kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.4f} us (bytes)  "
        f"[{card}]")
    return dict(name="suffix_match_propose", route="cuda",
                source="src/repro_torch/csrc/suffix_match.cu",
                replaces="src/repro/kernels/suffix_match/kernel.py:331",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def phase_main_path(torch, np, card):
    from repro_torch.configs import get_config
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.suffix_match import ops as sm_ops
    from repro_torch.models import model as M

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"qwen3-8b: {M.param_count(params) / 1e9:.3f} B params ({cfg.dtype}, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.padded_vocab}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    # One K bucket (16): every verify round runs the same (8, 17) block
    # shape, so the GEMMs of both epochs use the same kernels and T=0
    # identity across epochs does not rest on cuBLAS picking the same
    # kernel for two shapes.
    eng = SpecEngine(
        params, cfg,
        EngineConfig(max_draft=16, block_buckets=(16,), max_new_tokens=256,
                     eos_token=1, fuse_rounds="auto"),
        drafter=SuffixDrafter(DrafterConfig(scope="problem")),
        device="cuda",
    )
    rng = np.random.default_rng(1)
    problems = [[int(t) for t in rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(128, 257)))]
                for _ in range(4)]
    prompts = [problems[i // 2] for i in range(8)]
    pids = [f"p{i // 2}" for i in range(8)]
    max_new = [(32, 64, 128, 256)[i // 2] for i in range(8)]

    # the prefill's logits at full width are finite and of the right shape
    Tp = 256
    toks = torch.zeros((8, Tp), dtype=torch.int32, device="cuda")
    mask = torch.zeros((8, Tp), dtype=torch.bool, device="cuda")
    for b, p in enumerate(prompts):
        toks[b, Tp - len(p):] = torch.tensor(p, dtype=torch.int32)
        mask[b, Tp - len(p):] = True
    with torch.inference_mode():
        last, _ = M.prefill(params, cfg, toks, mask, max_len=576)
    check(tuple(last.shape) == (8, cfg.padded_vocab), "prefill logits shape")
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")

    sv_ops.LAUNCHES = 0
    sm_ops.LAUNCHES = 0
    epochs = []
    for ep in range(2):
        eng.begin_iteration(ep)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs, st = eng.generate(prompts, pids, max_new_tokens=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs.append((outs, st))
        toks_n = st.n_toks_emitted
        log(f"epoch {ep + 1}: wall {wall * 1e3:.1f} ms, rounds {st.n_rounds}, "
            f"tokens {toks_n}, {toks_n / wall:.1f} tok/s, drafted "
            f"{st.n_drafted}, accepted {st.n_accepted} "
            f"({st.acceptance_per_round:.2f}/round), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    launches = {"spec_verify_attention": sv_ops.LAUNCHES,
                "suffix_match_propose": sm_ops.LAUNCHES}
    log(f"main-path launches: {launches}")
    (o1, s1), (o2, s2) = epochs
    for b, o in enumerate(o1):
        check(len(o) <= max_new[b], f"row {b} emitted {len(o)} > {max_new[b]}")
        check(all(0 <= t < cfg.vocab_size for t in o), f"row {b}: bad token")
    check(o2 == o1, "epoch 2 outputs differ from epoch 1 (T=0 is lossless)")
    check(s2.n_accepted > 0, "epoch 2 accepted no drafts")
    check(s2.n_rounds < s1.n_rounds, "epoch 2 did not cut verify rounds")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    del eng, params
    torch.cuda.empty_cache()
    return launches, [dict(rounds=s.n_rounds, tokens=s.n_toks_emitted,
                           accepted=s.n_accepted) for _, s in epochs]


def phase_small_reference(torch, np):
    """The engine (kernels, ring cache, drafts) against plain greedy
    decoding (full-sequence forward, no cache, no kernels) on a small
    float32 model, compared up to the first near-tie (top-2 gap < 1e-3)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config("qwen3-8b"))
    params = M.init_params(cfg, seed=3, device="cuda")
    eng = SpecEngine(params, cfg, EngineConfig(max_new_tokens=24, max_draft=8,
                                               eos_token=1),
                     drafter=SuffixDrafter(DrafterConfig(scope="problem")),
                     device="cuda")
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
               for n in (9, 14, 20, 5)]
    pids = ["a", "b", "a", "c"]
    for ep in range(2):
        eng.begin_iteration(ep)
        outs, st = eng.generate(prompts, pids)
    compared = 0
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            seq = list(p)
            for tok in o:
                x = torch.tensor([seq], dtype=torch.int32, device="cuda")
                logits, _ = M.forward(params, cfg, x)
                lg = logits[0, -1, : cfg.vocab_size]
                top2 = torch.topk(lg, 2).values
                if float(top2[0] - top2[1]) < 1e-3:
                    break
                check(int(lg.argmax()) == tok,
                      "engine output differs from plain greedy decoding")
                compared += 1
                seq.append(tok)
    check(compared >= 40, f"only {compared} tokens compared")
    log(f"small float32 reference: {compared} tokens equal to plain greedy "
        f"decoding (epoch 2 accepted {st.n_accepted})")


def phase_cli(card):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-8b", "--smoke", "--scope", "problem", "--rounds", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=600)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
    check(proc.returncode == 0,
          f"serve CLI exited {proc.returncode}: {' | '.join(tail)}")
    log(f"serve CLI ok in {time.perf_counter() - t0:.1f} s [{card}]: "
        f"{' | '.join(tail)}")


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs a CUDA card")
    # float32 products in full float32 (the plain references compare at 3e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x{count}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(["spec_verify", "suffix_match"])
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, parallel)  "
        f"[{card}]")
    for name in ("spec_verify", "suffix_match"):
        for ln in _build.ptxas_lines(name):
            log(f"  [{name}] {ln}")

    timer = Timer(torch)
    kernels = [phase_spec_verify(torch, np, timer, card),
               phase_suffix_match(torch, np, timer, card)]
    del timer
    launches, _ = phase_main_path(torch, np, card)
    phase_small_reference(torch, np)
    phase_cli(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s  [{card}]")
    log(card)
    log(json.dumps({"kernels": [{key: k[key] for key in order}
                                for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()
