"""Dry run of the port: count every (arch × shape × mesh) at its full
config, allocating nothing (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each step on 512 placeholder TPU
devices and reads XLA's cost and memory analyses. Here each step runs on
meta tensors (shapes and dtypes, no storage, nothing launched) under
``analysis.count_cost``, and the mesh is abstract (``launch.mesh``), so
the dry run runs on any machine, with or without a card, and touches no
device.

  * ``bytes_per_device`` is exact: each parameter, optimizer-state and
    cache leaf's share under ``sharding.spec_for`` over the mesh, as the
    reference's arithmetic takes it;
  * FLOPs and bytes accessed are the step's totals; the per-device
    figures (``hlo_flops``, ``hlo_bytes``) are total ÷ devices, an ideal
    split: the port does not model XLA's replication;
  * ``peak_memory`` is ``bytes_per_device + temp_bytes / devices``;
  * the roofline terms use the NVIDIA H100's published peaks
    (``launch.mesh``); the port counts no collectives (``analysis``).

With ``extrapolate`` (the default) a step is counted at u and 2u layers
(u = the block pattern's length) and extended linearly to the full
depth, as the reference does (an encoder-decoder adds a 2 → 4 encoder
layer pair); the counts are exact for homogeneous stacks, the xLSTM
blocks' included (their recurrences are kernels that report their
``work``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--all] [--out report.json] [--direct]
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import math
import time
import traceback
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs import ASSIGNED, active_params, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch import workloads as W
from repro_torch.launch.analysis import Roofline, count_cost, model_flops_for
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw

log = logging.getLogger("repro_torch.launch.dryrun")

def bytes_per_device(struct_tree, axes_tree, mesh, rules=None) -> float:
    """Bytes one device holds of a (meta tensors, logical axes) tree:
    each leaf's element count divided by the mesh axes its spec shards
    it over, dimension by dimension, as the reference's
    ``_bytes_per_device`` divides."""
    total = 0.0

    def one(t, axes):
        nonlocal total
        n = math.prod(t.shape)
        for ax in sh.spec_for(tuple(t.shape), axes, mesh, rules):
            if ax is None:
                continue
            for a in (ax,) if isinstance(ax, str) else ax:
                n //= mesh.shape[a]
        total += n * t.element_size()

    sh.map_tree(one, struct_tree, axes_tree)
    return total


def state_bytes(cfg, shape: W.InputShape, mesh, rules=None) -> float:
    """The step's resident state a device: parameters, and the AdamW
    moments for train or the cache for decode/verify."""
    total = bytes_per_device(*W.param_specs(cfg), mesh, rules)
    if shape.kind == "train":
        total += bytes_per_device(*W.opt_specs(cfg), mesh, rules)
    elif shape.kind in ("decode", "verify"):
        total += bytes_per_device(*W.cache_specs(cfg, shape, mesh), mesh,
                                  rules)
    return total


def workload(cfg, shape: W.InputShape, use_cross_cache: bool = False):
    """(step function, its meta arguments) of one workload. With
    ``use_cross_cache`` a decode step reads the encoder's projected K/V
    (``build_cross_cache``, an input here as in the reference's pair A)
    in place of ``enc_out``."""
    params = M.init_params(cfg, device="meta")
    inputs, _ = W.input_specs(cfg, shape)
    if shape.kind == "train":
        M.set_trainable(params)
        return W.make_train_fn(cfg), (params, adamw.init_state(params),
                                      inputs)
    if shape.kind == "prefill":
        return W.make_prefill_fn(cfg, shape), (params, inputs)
    cache, _ = W.cache_specs(cfg, shape, make_local_mesh())
    if use_cross_cache:
        inputs["cross_cache"] = M.build_cross_cache(params, cfg,
                                                    inputs.pop("enc_out"))
    return (W.make_decode_fn(cfg, shape, use_cross_cache),
            (params, cache, inputs))


@functools.lru_cache(maxsize=None)
def count_direct(cfg, shape: W.InputShape, use_cross_cache: bool = False
                 ) -> Tuple[np.ndarray, dict]:
    """([flops, bytes, temp bytes], kernel launches) of one step counted
    op by op at ``cfg``'s depth. Counts do not depend on the mesh nor the
    rules, so each is kept for the process (``--both-meshes``, the
    hill-climb's rule sets and the extrapolations' short counts reuse
    them)."""
    fn, args = workload(cfg, shape, use_cross_cache)
    _, cost = count_cost(fn, *args)
    return np.array(cost.vector()), dict(cost.launches)


def counted_cost(cfg, shape: W.InputShape, *, extrapolate: bool = True,
                 use_cross_cache: bool = False
                 ) -> Tuple[np.ndarray, dict]:
    """([flops, bytes, temp bytes], kernel launches) of one step at the
    full config: counted directly, or (``extrapolate``) at u and 2u
    layers and extended linearly to the full depth (see the module
    docstring); the kernels' launches as the rest (exact for a stack of
    whole block-pattern units)."""
    if not extrapolate:
        return count_direct(cfg, shape, use_cross_cache)
    u = max(1, len(cfg.block_pattern))
    L = cfg.num_layers
    enc = {"num_encoder_layers": 2} if cfg.is_encoder_decoder else {}
    c1, l1 = count_direct(cfg.replace(num_layers=u, **enc), shape,
                          use_cross_cache)
    c2, l2 = count_direct(cfg.replace(num_layers=2 * u, **enc), shape,
                          use_cross_cache)
    w = (L - u) / u  # the units beyond the first, in steps of u layers
    total = c1 + w * (c2 - c1)
    launches = {k: round(l1.get(k, 0) + w * (l2.get(k, 0) - l1.get(k, 0)))
                for k in {**l1, **l2}}
    if cfg.is_encoder_decoder:
        m3, _ = count_direct(cfg.replace(num_layers=u, num_encoder_layers=4),
                             shape, use_cross_cache)
        total = total + (cfg.num_encoder_layers - 2) / 2.0 * (m3 - c1)
    return np.maximum(total, 0.0), launches


def dry_run_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    rules=None,
    verbose: bool = True,
    extrapolate: bool = True,
    cfg_override=None,
    mesh=None,
    shape: Optional[W.InputShape] = None,
    use_cross_cache: bool = False,
):
    """Count one (arch, shape, mesh); returns the reference's record.
    ``mesh`` replaces the production mesh (``make_local_mesh()``: the one
    card) and ``shape`` the named shape (another batch: a device's
    share)."""
    cfg = cfg_override or get_config(arch)
    shape = shape or W.SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name}
    reason = W.skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    rules = rules or sh.DEFAULT_RULES
    n_chips = mesh.size
    t0 = time.perf_counter()
    static = state_bytes(cfg, shape, mesh, rules)
    (flops, nbytes, temp), launches = counted_cost(
        cfg, shape, extrapolate=extrapolate, use_cross_cache=use_cross_cache)
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=rec["mesh"], n_chips=n_chips,
        hlo_flops=float(flops) / n_chips, hlo_bytes=float(nbytes) / n_chips,
        model_flops=model_flops_for(cfg, shape, active_params(cfg))
        / n_chips,
        bytes_per_device=static,
        peak_memory=static + float(temp) / n_chips,
        temp_bytes=float(temp),
    )
    rec.update(rl.as_dict())
    rec["status"] = "ok"
    rec["kernel_launches"] = launches
    rec["count_s"] = time.perf_counter() - t0
    if verbose:
        log.info(
            "%-24s %-12s %-8s OK %6.1fs  flops=%.3e bytes=%.3e (totals) "
            "static=%.2fGB peak=%.2fGB dominant=%s useful=%.2f",
            arch, shape_name, rec["mesh"], rec["count_s"], flops, nbytes,
            static / 1e9, rl.peak_memory / 1e9, rl.dominant,
            rl.useful_flops_ratio,
        )
    return rec


def main() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all arch × shape")
    ap.add_argument("--out", default="")
    ap.add_argument("--shapes",
                    default="train_4k,prefill_32k,decode_32k,long_500k")
    ap.add_argument("--direct", action="store_true",
                    help="count op by op at full depth and length, no "
                         "extrapolation (what the extrapolations are "
                         "held to)")
    args = ap.parse_args()

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = (
        args.shapes.split(",") if (args.all or not args.shape)
        else [args.shape]
    )
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    t0 = time.perf_counter()
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = dry_run_one(arch, shape, multi_pod=mp,
                                      extrapolate=not args.direct)
                except Exception as e:  # dascheck: disable=DAS303 -- one arch failing must not stop the sweep; recorded as FAILED in the report
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "FAILED", "error": str(e)[:2000]}
                results.append(rec)
                print(json.dumps(rec, default=str), flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"[dryrun] ok={n_ok} skipped={n_skip} FAILED={n_fail} in "
          f"{time.perf_counter() - t0:.1f} s (counted on meta tensors)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"[dryrun] wrote {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
