#!/usr/bin/env python3
"""Markdown table of the port's dry-run records (``python -m
repro_torch.launch.dryrun ... --out FILE``), one row an (arch, shape),
the two production meshes side by side.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --shapes train_4k,prefill_32k,decode_32k,long_500k,verify_8 \\
        --out build/dryrun_all.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --both-meshes --shapes train_4k,prefill_32k,decode_32k,long_500k,verify_8 \\
        --out build/dryrun_qwen3.json
    python3 scripts/dryrun_table.py build/dryrun_all.json build/dryrun_qwen3.json

Every figure is counted on meta tensors against NVIDIA's data-sheet
peaks for the NVIDIA H100 80GB HBM3 at 700 W, not measured. Totals do
not depend on the mesh; the per-device terms are total ÷ devices (an
ideal split), so the 2×16×16 mesh's are half the 16×16 mesh's.
"""

import json
import sys
from collections import defaultdict

HBM_GB = 80.0


def main() -> None:
    recs = [r for path in sys.argv[1:] for r in json.load(open(path))]
    rows = defaultdict(dict)
    skips = defaultdict(list)
    order = []
    for r in recs:
        key = (r["arch"], r["shape"])
        if key not in rows and key not in skips:
            order.append(key)
        if r["status"] == "skipped":
            skips[key].append(r["mesh"])
        elif r["status"] == "ok":
            rows[key][r["mesh"]] = r
        else:
            rows[key][r["mesh"]] = None
    print("| arch | shape | bytes/device 16x16 / 2x16x16 (GB of 80) | "
          "total TFLOP | total GB accessed | t_compute / t_memory a device "
          "on 16x16 (ms) | dominant | useful FLOPs ratio |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    skipped = []
    for key in order:
        if key in skips and key not in rows:
            skipped.append(f"{key[0]} {key[1]}")
            continue
        by = rows[key]
        if any(v is None for v in by.values()):
            print(f"| {key[0]} | {key[1]} | FAILED | | | | | |")
            continue
        a, b = by.get("16x16"), by.get("2x16x16")
        bpd = " / ".join(f"{m['bytes_per_device'] / 1e9:.2f}"
                         + (" (over)" if m["bytes_per_device"] / 1e9 > HBM_GB
                            else "") for m in (a, b) if m)
        print(f"| {key[0]} | {key[1]} | {bpd} | "
              f"{a['total_flops'] / 1e12:,.1f} | "
              f"{a['total_bytes'] / 1e9:,.1f} | "
              f"{a['t_compute_s'] * 1e3:.3f} / {a['t_memory_s'] * 1e3:.3f} | "
              f"{a['dominant']} | {a['useful_flops_ratio']:.3f} |")
    if skipped:
        print(f"\nSkipped (the reference's `skip_reason`, full attention at "
              f"long_500k): {', '.join(skipped)}.")


if __name__ == "__main__":
    main()
