"""The §Perf hill-climb pairs of the reference, counted by the port's dry
run (counterpart of ``repro.launch.hillclimb``): each pair states the
reference's hypothesis, changes one thing and reads the counted terms
before and after.

  Pair A: seamless-m4t-medium × decode_32k   (a precomputed cross cache)
  Pair B: xlstm-125m × decode_32k            (three sharding rule sets)
  Pair C: qwen3-8b × verify_8 vs decode_32k  (the paper's own workload)

Everything is counted on meta tensors against NVIDIA H100 constants
(``launch.mesh``; data-sheet figures); nothing touches a device. The port
counts no collectives, so a hypothesis about collective traffic (pair B,
and pair C's replicated parameters) is reported as untestable here; what
a rule set does change is ``bytes_per_device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair A|B|C|all \\
      [--out hillclimb_report.json]
"""

from __future__ import annotations

import argparse
import json
import logging

from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as sh

log = logging.getLogger("repro_torch.launch.hillclimb")

UNTESTABLE = ("not testable here: the port counts no collectives (no "
              "multi-GPU execution path); only bytes_per_device and the "
              "memory term are read")


def _fmt(rec):
    return (
        f"t_comp={rec['t_compute_s']:.3e}s t_mem={rec['t_memory_s']:.3e}s "
        f"dom={rec['dominant']} useful={rec['useful_flops_ratio']:.3f} "
        f"bytes/device={rec['bytes_per_device'] / 1e9:.3f}GB"
    )


def _delta(base, new, term):
    b, n = base[term], new[term]
    return f"{term}: {b:.3e} → {n:.3e} ({(n - b) / max(b, 1e-30):+.1%})"


def step_time(rec) -> float:
    """The counted step's roofline time: the larger of its terms."""
    return max(rec["t_compute_s"], rec["t_memory_s"])


# -- Pair A: cross-KV caching for the enc-dec decoder ----------------------

def pair_a():
    log.info("=== Pair A: seamless-m4t-medium × decode_32k ===")
    log.info(
        "H-A1: the baseline recomputes every decoder layer's cross-"
        "attention K/V from enc_out (B, 1024, 1024) each step — "
        "2·L·S_enc·d² flops that dwarf the single-token decode. Expect "
        "flops and bytes to drop several-fold with a precomputed cross "
        "cache (an input of the step)."
    )
    base = D.dry_run_one("seamless-m4t-medium", "decode_32k", verbose=False)
    log.info("  baseline: %s", _fmt(base))
    new = D.dry_run_one("seamless-m4t-medium", "decode_32k", verbose=False,
                        use_cross_cache=True)
    log.info("  +cross_cache: %s", _fmt(new))
    for t in ("hlo_flops", "hlo_bytes", "t_memory_s", "t_compute_s"):
        log.info("    %s", _delta(base, new, t))
    return {"pair": "A", "baseline": base, "optimized": new,
            "change": "precomputed cross-attention KV cache"}


# -- Pair B: xlstm decode under three rule sets ----------------------------

def pair_b():
    log.info("=== Pair B: xlstm-125m × decode_32k ===")
    log.info(
        "H-B1 (the reference's): with FSDP rules a 125M model all-gathers "
        "its parameters every step; replicating them across 'data' "
        "removes the gathers and raises each device's resident bytes. "
        "The gather half is %s.", UNTESTABLE)
    out = {"pair": "B", "variants": [], "collective_hypothesis": UNTESTABLE}
    base = D.dry_run_one("xlstm-125m", "decode_32k", verbose=False)
    log.info("  baseline (embed→FSDP): %s", _fmt(base))
    out["baseline"] = base
    v1_rules = dict(sh.DEFAULT_RULES)
    v1_rules["embed"] = None
    v2_rules = dict(v1_rules)
    v2_rules["vocab"] = None
    for label, rules in (("embed=None", v1_rules),
                         ("embed=None,vocab=None", v2_rules)):
        v = D.dry_run_one("xlstm-125m", "decode_32k", rules=rules,
                          verbose=False)
        log.info("  %s: %s", label, _fmt(v))
        for t in ("bytes_per_device", "t_memory_s"):
            log.info("    %s", _delta(base, v, t))
        out["variants"].append({"rules": label, **v})
    return out


# -- Pair C: the paper's verify step ----------------------------------------

def pair_c():
    log.info("=== Pair C: qwen3-8b × verify_8 (the DAS verify step) ===")
    log.info(
        "The paper's economics: one verify pass scores K+1=9 tokens. If "
        "the per-pass cost grows by far less than 9×, speculation wins "
        "by (tokens/pass)/(cost ratio). decode_32k is memory-bound "
        "(cache + weights traffic is independent of T), so expect "
        "cost_ratio ≈ 1 and a ~9× per-token win at acceptance 1."
    )
    dec = D.dry_run_one("qwen3-8b", "decode_32k", verbose=False)
    ver = D.dry_run_one("qwen3-8b", "verify_8", verbose=False)
    t_dec, t_ver = step_time(dec), step_time(ver)
    log.info("  decode_32k : %s", _fmt(dec))
    log.info("  verify_8   : %s", _fmt(ver))
    log.info(
        "  cost ratio verify/decode = %.3f; tokens/pass 9 "
        "→ per-token speedup at full acceptance ≈ %.1fx",
        t_ver / t_dec, 9 * t_dec / t_ver,
    )
    out = {"pair": "C", "decode": dec, "verify": ver,
           "cost_ratio": t_ver / t_dec}
    log.info("H-C1 (the reference's): replicating parameters across 'data' "
             "for serving cuts the parameter gathers: %s.", UNTESTABLE)
    rules = dict(sh.DEFAULT_RULES)
    rules["embed"] = None
    ver2 = D.dry_run_one("qwen3-8b", "verify_8", rules=rules, verbose=False)
    log.info("  verify_8 +replicated-params: %s", _fmt(ver2))
    for t in ("bytes_per_device", "t_memory_s"):
        log.info("    %s", _delta(ver, ver2, t))
    out["verify_replicated"] = ver2
    return out


def main() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--out", default="hillclimb_report.json")
    args = ap.parse_args()
    results = []
    if args.pair in ("A", "all"):
        results.append(pair_a())
    if args.pair in ("B", "all"):
        results.append(pair_b())
    if args.pair in ("C", "all"):
        results.append(pair_c())
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(json.dumps({"pairs": [r["pair"] for r in results],
                      "cost_ratio_C": next((r["cost_ratio"] for r in results
                                            if r["pair"] == "C"), None)}))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
